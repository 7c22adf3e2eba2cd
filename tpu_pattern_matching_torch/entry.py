"""Entry point of the PyTorch port (counterpart of the reference's
``__graft_entry__.entry``).

``entry(device)`` returns the single-device forward step of the flagship
engine (the bloom probe: pad + transpose + probe + popcount,
``ops.bloom.hits``) and its example arguments on the reference's small
problem: 32 random patterns of 4-11 bytes (``RandomState(0)``) and 16
lanes of ``halo + 64`` random bytes. On a CUDA device the step launches
the probe kernel; on the CPU it runs the kernel's plain version.

    python -m tpu_pattern_matching_torch.entry [--device cpu]

The reference's ``dryrun_multichip`` (a step over a device mesh) waits for
the multi-GPU port (ROADMAP queue 1, item 11).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch


def small_problem(num_lanes: int = 16, chunk_len: int = 64):
    """(table, halo, data, start_t, end_t): the reference's
    ``_small_problem`` with the same draws, as numpy arrays."""
    from tpu_pattern_matching_torch.core.dfa import compile_patterns

    rng = np.random.RandomState(0)
    patterns = [
        bytes(rng.randint(0, 256, size=rng.randint(4, 12)).astype(np.uint8))
        for _ in range(32)
    ]
    table = compile_patterns(patterns)
    halo = table.max_pat_len - 1
    data = rng.randint(0, 256, size=(num_lanes, halo + chunk_len)).astype(
        np.uint8)
    start_t = np.full(num_lanes, halo, np.int32)
    end_t = np.full(num_lanes, halo + chunk_len, np.int32)
    return table, halo, data, start_t, end_t


def entry(device="cuda"):
    """``(forward, (words, data, start_t, end_t))``: the forward scan step
    and its arguments as tensors on ``device`` (``"cuda"`` raises without
    a GPU). ``forward`` returns ``(total [1], bits [W, Cp])`` int32, the
    reference's ``_hits_jit`` outputs."""
    from tpu_pattern_matching_torch.ops.bloom import BloomFilterTable, hits
    from tpu_pattern_matching_torch.utils.device import resolve_device

    dev = resolve_device(device)
    table, _halo, data, start_t, end_t = small_problem()
    bft = BloomFilterTable.from_table(table)
    cfg = bft.cfg

    def forward(words, data, start_t, end_t):
        return hits(data, torch.stack([start_t, end_t]), words, cfg)

    args = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                 for a in (bft.words, data, start_t, end_t))
    return forward, args


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    a = ap.parse_args(argv)
    fn, args = entry(a.device)
    out = fn(*args)
    if out[0].is_cuda:
        torch.cuda.synchronize()
    print("entry OK:", [tuple(o.shape) for o in out])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
