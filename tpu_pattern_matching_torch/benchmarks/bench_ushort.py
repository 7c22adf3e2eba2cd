"""Ushort-alphabet (packet-metadata) device scan throughput (port of the
reference's ``benchmarks/bench_ushort.py``).

    python -m tpu_pattern_matching_torch.benchmarks.bench_ushort \
        [--device cpu] [SIG_FILE ...]

Signatures are per-flow packet-length trains (``seq; len; name`` lines),
truncated to 16 tokens, deduplicated, 1-token signatures dropped
(:func:`build_table`). Reports tokens/s and uint16-payload bytes/s of (a)
the probe-objective pick's probe and (b) the session-default refined
pick: its probe, and its probe with on-device exact-gram refinement at
11-bit keys. Batches: 4096 lanes x 2048 tokens (aligned to each pick's
row tiles), drawn from ``RandomState(11)``. Timing as in ``bench``
(``utils.measure.kloop_seconds``: CUDA-event spans of K eager calls,
``(t(9) - t(1)) / 8``); each timed call's device time goes to stderr.

Without SIG_FILE it reads the upstream C project's three signature
traces (``AC_ushorts/input/{tx,rx,txrx}.signatures``) under
``$TPM_UPSTREAM_DIR``, and raises when they are not there, as the
reference raises on its missing default files.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

from tpu_pattern_matching_torch.benchmarks.common import upstream_path
from tpu_pattern_matching_torch.utils.device import entry_device
from tpu_pattern_matching_torch.utils.measure import (card,
                                                      log_device_times, timed)

REF_SIGS = ("tx.signatures", "rx.signatures", "txrx.signatures")
LANES, TOKENS = 4096, 2048  # C, B0 (tokens per lane)
DATA_SEED = 11
REPEATS = 5


def default_sigs() -> list[str]:
    """The upstream project's signature traces; FileNotFoundError when
    ``$TPM_UPSTREAM_DIR`` does not hold them."""
    paths = [upstream_path("AC_ushorts", "input", name) for name in REF_SIGS]
    missing = [p for p in paths if p is None or not os.path.exists(p)]
    if missing:
        raise FileNotFoundError(
            f"no signature file given and the upstream traces are not at "
            f"hand (set $TPM_UPSTREAM_DIR to a checkout holding "
            f"AC_ushorts/input/{{tx,rx,txrx}}.signatures): {missing}")
    return paths


def build_table(paths):
    from tpu_pattern_matching_torch.core.dfa import ALPHABET_USHORT, AhoCorasick
    from tpu_pattern_matching_torch.core.patterns import load_signature_file

    ac = AhoCorasick(ALPHABET_USHORT)
    seen = set()
    n_in = 0
    for p in paths:
        for pp in load_signature_file(p, max_tokens=16):
            n_in += 1
            seq = tuple(min(v, ALPHABET_USHORT - 1) for v in pp.data)
            if len(seq) < 2 or seq in seen:  # 1-token signatures match
                continue  # every occurrence of one value: not a filter
                # workload (the upstream sets contain none)
            seen.add(seq)
            ac.add_pattern(seq, iid=len(seen) - 1, label=pp.label)
    return ac.compile(), n_in, len(seen)


def run(paths, device="cuda") -> dict:
    from tpu_pattern_matching_torch.bench import batch_rows, cfg_name
    from tpu_pattern_matching_torch.ops.bloom import (
        BloomFilterTable,
        hits,
        hits_refined,
    )
    from tpu_pattern_matching_torch.ops.exact_gram import (
        DeviceExact,
        table_from_keys,
    )
    from tpu_pattern_matching_torch.ops.verify_device import next_cap

    dev = torch.device(device)
    table, n_in, n_used = build_table(paths)
    out = {
        "metric": "ushort_scan",
        "signatures_in": n_in,
        "signatures_used": n_used,
        "states": table.num_states,
    }
    rng = np.random.RandomState(DATA_SEED)
    C, B0 = LANES, TOKENS
    traced = []

    for tag, bft in (
        ("probe", BloomFilterTable.from_table(table, objective="probe")),
        ("refined", BloomFilterTable.from_table(table)),
    ):
        cfg = bft.cfg
        halo, B = batch_rows(table, cfg, B0)
        size = C * B * 2  # uint16 payload bytes
        data = torch.from_numpy(
            rng.randint(0, 2048, size=(C, halo + B)).astype(np.uint16)
        ).to(dev)
        bounds = torch.from_numpy(np.stack(
            [np.full(C, halo, np.int32), np.full(C, halo + B, np.int32)])
        ).to(dev)
        words = bft.put(dev).words
        out[f"{tag}_config"] = cfg_name(cfg)

        bps = size / timed(f"{tag} pick's probe ({cfg_name(cfg)})",
                           lambda data=data, bounds=bounds, words=words,
                           cfg=cfg: hits(data, bounds, words, cfg)[0][0],
                           dev, REPEATS, traced)
        out[f"{tag}_probe_bytes_per_s"] = bps
        out[f"{tag}_tokens_per_s"] = bps / 2

        if tag == "refined" and bft.gram_keys is not None and len(
                bft.gram_keys):
            dx = DeviceExact.put(
                table_from_keys(bft.gram_keys, cfg.q, bits=bft.gram_bits),
                cfg.fold_case, dev)
            k_ref = next_cap(
                int(max(2048, 2.0 * bft.expected_cand_rate() * C * B)))
            out["refined_k_ref"] = k_ref
            m0, _b0 = hits_refined(data, bounds, words, dx, cfg, k_ref)
            out["refined_residue_per_token"] = int(m0[0]) / (C * B)
            bps = size / timed("refined pick's probe + refinement",
                               lambda: hits_refined(data, bounds, words, dx,
                                                    cfg, k_ref)[0][0],
                               dev, REPEATS, traced)
            out["refined_pipeline_bytes_per_s"] = bps
            out["refined_pipeline_tokens_per_s"] = bps / 2
    log_device_times("bench_ushort", traced, dev)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m tpu_pattern_matching_torch.benchmarks.bench_ushort")
    ap.add_argument("sigs", nargs="*",
                    help="signature files (default: the upstream traces)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; exits 2 without a card) or cpu")
    args = ap.parse_args(argv)
    dev = entry_device(args.device)
    if dev.type == "cuda":
        print(f"[bench_ushort] card: {card()}", file=sys.stderr, flush=True)
    print(json.dumps(run(args.sigs or default_sigs(), dev)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
