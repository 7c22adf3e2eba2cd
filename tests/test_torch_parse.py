"""The ushort feed's native token parse (``csrc/stager.cpp``
``parse_tokens``, bound as ``runtime.stager_native.parse_tokens``) against
the NumPy ``parse_token_stream`` (``TPM_NO_NATIVE_STAGER=1``), the
reference's ``parse_token_stream`` and a plain oracle:
``min(int(run) & 0xFFFF, clamp)`` over ``re.findall(rb"[0-9]+", text)``.

Each case is a text cut into reads. Every parser streams the reads with
its held digit run carried from one read to the next (``final`` False),
then flushes with an empty final read; the tokens of each read and the
held run after it must be equal across the parsers, and all the tokens
equal to the oracle's over the whole text. Every output is an integer or
a byte string, so every comparison is exact."""

import re

import numpy as np
import pytest

from tpu_pattern_matching.runtime import buffers as ref_buffers
from tpu_pattern_matching_torch.runtime import buffers, stager_native

CLAMP = 2047
SEPARATORS = b",; \t\r\nxA-"


def oracle(text: bytes, clamp: int) -> list:
    return [min(int(run) & 0xFFFF, clamp)
            for run in re.findall(rb"[0-9]+", text)]


def random_text(seed: int, n: int, alphabet: bytes) -> bytes:
    rng = np.random.RandomState(seed)
    return bytes(np.frombuffer(alphabet, np.uint8)[
        rng.randint(0, len(alphabet), size=n)])


def runs_of_lengths(seed: int, lengths) -> bytes:
    """Digit runs of the given lengths, leading zeros and wrapping values
    among them, each followed by a random separator."""
    rng = np.random.RandomState(seed)
    out = []
    for n in lengths:
        out.append(bytes(48 + rng.randint(0, 10, size=n).astype(np.uint8)))
        out.append(SEPARATORS[rng.randint(len(SEPARATORS)):][:1])
    return b"".join(out)


def cut(text: bytes, size: int) -> list:
    return [text[i : i + size] for i in range(0, len(text), size)]


# name -> (text, the lengths of its reads (None: one read), clamp)
CASES = {
    **{f"random-seed{s}": (random_text(s, 3000, b"0123456789" * 3
                                       + SEPARATORS), 977, CLAMP)
       for s in range(3)},
    "flow-format": (", ".join(map(str, np.random.RandomState(4).choice(
        [0, 1460, 7, 2047, 2048, 65535, 65536], size=2000))).encode(),
        4096, CLAMP),
    "runs-1-to-40-digits": (runs_of_lengths(5, list(range(1, 41)) * 4),
                            61, CLAMP),
    "wrap-mod-2-16": (b"65535,65536,65537,131071,131072,"
                      b"99999999999999999999,18446744073709551616,"
                      b"340282366920938463463374607431768211457", None,
                      65535),
    "clamp-edges": (b"2046 2047 2048 2049 0 00002047 00002048 65535 65536",
                    None, CLAMP),
    "clamp-zero": (b"0,1,9,10,65536", None, 0),
    "clamp-large": (b"0,1,65535,65536,70000", None, 1 << 20),
    "empty": (b"", None, CLAMP),
    "digits-only": (b"1234567", None, CLAMP),
    "no-digits": (b",;; \r\n\tabc-xyz", None, CLAMP),
    "held-run-longer-than-a-read": (b"7," + b"1" * 50 + b",8," + b"9" * 33,
                                    16, CLAMP),
    "one-byte-reads": (b"12,34;;5 6\r\n789x0", 1, CLAMP),
}


@pytest.fixture
def native():
    if not stager_native.available():
        pytest.skip("the native stager did not build (g++)")
    return stager_native.parse_tokens


def numpy_parse(monkeypatch):
    monkeypatch.setenv("TPM_NO_NATIVE_STAGER", "1")
    return buffers.parse_token_stream


def stream(parse, reads, clamp, final_flush=True):
    """Each read's tokens and held run, then the flush's."""
    rem, steps = b"", []
    for raw in reads:
        toks, rem = parse(raw, rem, False, clamp)
        steps.append((np.asarray(toks, np.uint16).tolist(), rem))
    if final_flush:
        toks, rem = parse(b"", rem, True, clamp)
        steps.append((np.asarray(toks, np.uint16).tolist(), rem))
    return steps


def tokens(steps):
    return [t for toks, _ in steps for t in toks]


@pytest.mark.parametrize("case", list(CASES))
def test_parse_equals_numpy_reference_and_oracle(case, native, monkeypatch):
    text, size, clamp = CASES[case]
    reads = cut(text, size) if size else [text]
    got = stream(native, reads, clamp)
    assert got == stream(ref_buffers.parse_token_stream, reads, clamp)
    assert got == stream(numpy_parse(monkeypatch), reads, clamp)
    assert tokens(got) == oracle(text, clamp)
    assert got[-1][1] == b""  # the flush holds nothing back
    # one read, final: everything at once
    toks, rem = native(text, b"", True, clamp)
    assert toks.dtype == np.uint16 and toks.tolist() == oracle(text, clamp)
    assert rem == b""


@pytest.mark.parametrize("text", [b"12,345;6789 0,65536,7",
                                  b"1" * 23 + b"," + b"2" * 5,
                                  b",,,40 32 287\r\n106"],
                         ids=["mixed", "long-run", "leading-separators"])
def test_every_split_into_two_reads_carries(text, native, monkeypatch):
    want = oracle(text, CLAMP)
    for k in range(len(text) + 1):
        reads = [text[:k], text[k:]]
        got = stream(native, reads, CLAMP)
        assert tokens(got) == want, k
        assert got == stream(ref_buffers.parse_token_stream, reads, CLAMP)
    assert tokens(stream(numpy_parse(monkeypatch), [text[:3], text[3:]],
                         CLAMP)) == want


@pytest.mark.parametrize("rem,raw", [(b"12", b""), (b"12", b"3"),
                                     (b"9" * 40, b"9" * 40), (b"", b"77"),
                                     (b"5", b",6"), (b"", b"")],
                         ids=["rem-only", "rem-and-raw", "long-held",
                              "raw-only", "rem-ends-run", "nothing"])
def test_final_flushes_the_held_run(rem, raw, native, monkeypatch):
    want = ref_buffers.parse_token_stream(raw, rem, True, CLAMP)
    for parse in (native, numpy_parse(monkeypatch)):
        toks, held = parse(raw, rem, True, CLAMP)
        assert toks.tolist() == want[0].tolist() == oracle(rem + raw, CLAMP)
        assert held == want[1] == b""
    # not final: the trailing run stays held, unparsed
    toks, held = native(raw, rem, False, CLAMP)
    want = ref_buffers.parse_token_stream(raw, rem, False, CLAMP)
    assert (toks.tolist(), held) == (want[0].tolist(), want[1])
