"""The CUDA probe kernels and the port's session on the card.

Marked ``cuda``: each test skips unless a CUDA device is present. Run on
the machine with the GPU (which has no jax; ``TPM_TEST_TPU=1`` keeps
tests/conftest.py from importing it):

    TPM_TEST_TPU=1 python -m pytest tests/test_torch_cuda.py -m cuda -q

The kernels' outputs are integers: they must equal the plain PyTorch
versions bit for bit (tolerance 0). This file imports no jax.
"""

import numpy as np
import pytest
import torch

from tpu_pattern_matching.core.dfa import compile_patterns
from tpu_pattern_matching.core.oracle_native import NativeOracle
from tpu_pattern_matching_torch.ops import bloom, kernels
from tpu_pattern_matching_torch.runtime.session import MatchSession

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def make_cfg(mode, q, sw, k, v, fold=False, seed=0):
    rng = np.random.RandomState(seed)
    sampled = mode == "sampled"
    return bloom.BloomConfig(
        q=q, stride=1 if sampled else sw, kbanks=k, v=v,
        mix1=tuple(int(x) | 1 for x in rng.randint(1, 2**31, size=q)),
        mix2=tuple(int(x) | 1 for x in rng.randint(1, 2**31, size=q)),
        fold_case=fold, gt=128 if sampled else bloom.GT,
        sampled=sampled, w=sw if sampled else 0,
    )


CONFIGS = [  # (mode, q, stride|w, k, v, fold)
    ("sampled", 4, 9, 6, 8, False),
    ("sampled", 4, 9, 12, 8, True),
    ("sampled", 5, 30, 6, 256, False),  # wide context, words in global memory
    ("sampled", 1, 1, 2, 1, False),
    ("strided", 4, 4, 6, 16, False),
    ("strided", 3, 7, 10, 2, True),
]


@pytest.mark.parametrize(
    "spec", CONFIGS, ids=["-".join(map(str, s)) for s in CONFIGS]
)
def test_kernel_equals_plain(cuda, spec):
    cfg = make_cfg(*spec, seed=1)
    rng = np.random.RandomState(2)
    C, T = 300, 1000
    data = rng.randint(0, 256, size=(C, T)).astype(np.uint8)
    start = rng.randint(0, 20, size=C).astype(np.int32)
    end = rng.randint(T - 50, T + 1, size=C).astype(np.int32)
    end[::17] = start[::17]  # empty lanes
    words = rng.randint(-(2**31), 2**31, size=(cfg.kbanks, cfg.v, 128))
    data_tm, Cp = bloom.prep_time_major(torch.from_numpy(data).to(cuda), cfg)
    bp = bloom.pad_bounds(torch.from_numpy(np.stack([start, end])).to(cuda),
                          Cp)
    w = torch.from_numpy(words.astype(np.int32)).to(cuda)
    before = kernels.probe_launches[spec[0]]
    k_bits, k_total = kernels.launch_probe(data_tm, bp, w, cfg)
    torch.cuda.synchronize()
    assert kernels.probe_launches[spec[0]] == before + 1
    p_bits, p_total = bloom.probe_bits_plain(data_tm, bp, w, cfg)
    assert torch.equal(k_bits, p_bits)
    assert int(k_total[0]) == int(p_total[0]) > 0


def test_rejected_arguments_raise(cuda):
    cfg = make_cfg("sampled", 4, 9, 6, 8)
    w = torch.zeros((6, 8, 128), dtype=torch.int32, device=cuda)
    b = torch.zeros((2, 128), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="tile height"):
        kernels.launch_probe(
            torch.zeros((100, 128), dtype=torch.uint8, device=cuda), b, w, cfg)
    with pytest.raises(ValueError, match="is on cpu"):
        kernels.launch_probe(
            torch.zeros((128, 128), dtype=torch.uint8, device=cuda),
            b.cpu(), w, cfg)


def test_session_on_cuda_equals_oracle(cuda):
    rng = np.random.RandomState(3)
    pats = [bytes(rng.randint(0, 256, size=int(rng.randint(8, 20)))
                  .astype(np.uint8)) for _ in range(500)]
    data = bytearray(rng.randint(0, 256, size=1 << 20).astype(np.uint8))
    for i, pos in enumerate(rng.randint(0, (1 << 20) - 20, size=300)):
        p = pats[i % len(pats)]
        data[pos : pos + len(p)] = p
    data = bytes(data)
    sess = MatchSession(compile_patterns(pats), max_chunks=256,
                        chunk_len=1024, device=cuda)
    off, pid, total = NativeOracle(pats).match(data, cap=1 << 16)
    assert total == len(off) >= 290
    assert sess.find(data) == sorted(zip(off.tolist(), pid.tolist()))
