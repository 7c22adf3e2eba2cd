"""Match-dense end-to-end benchmark: probe + bitmap fetch + host verify
(port of the reference's ``benchmarks/match_dense_bench.py``).

    python -m tpu_pattern_matching_torch.benchmarks.match_dense_bench \
        [--patterns N] [--mib M] [--engine E] [--device cpu]

Plants a true gram at every 12-byte slot of a fraction of the input
(densities 0, 1e-3, 1e-2, 0.1 and 1.0; 0 is the random-data regime, 1.0
the adversarial worst case: the filter cannot reject true grams) and
times the whole pipeline through ``MatchSession``'s own steps, depth 2 so
that verify overlaps the next batch's device work, counting events with
``decode_counts``. Prints one JSON line per density with the reference's
keys. The wall time is the host clock of the second of two passes.

After the timed passes (not in the reference), each density's event
count is held to the native oracle's match ends on the same bytes; a
difference raises and the run exits non-zero.
"""

from __future__ import annotations

import argparse
import io
import json
import sys
import time

import numpy as np

from tpu_pattern_matching_torch.benchmarks.common import oracle_match_ends
from tpu_pattern_matching_torch.utils.device import entry_device
from tpu_pattern_matching_torch.utils.measure import card

DENSITIES = (0.0, 0.001, 0.01, 0.1, 1.0)


def run(patterns: int = 10_000, mib: int = 16, engine: str = "bloom",
        device="cuda") -> list[dict]:
    """The benchmark's lines, one per density (each also printed); raises
    when a density's events differ from the native oracle's."""
    from tpu_pattern_matching_torch.core.dfa import compile_patterns
    from tpu_pattern_matching_torch.runtime.buffers import StreamState
    from tpu_pattern_matching_torch.runtime.session import MatchSession

    rng = np.random.RandomState(42)
    pats = [bytes(rng.randint(0, 256, size=12).astype(np.uint8))
            for _ in range(patterns)]
    table = compile_patterns(pats)

    size = mib << 20
    base = rng.randint(0, 256, size=size).astype(np.uint8)
    lines = []
    for density in DENSITIES:
        data = base.copy()
        if density > 0:
            slots = size // 12
            n_seed = max(1, int(slots * density))
            idx = rng.choice(slots, size=n_seed, replace=False)
            chosen = rng.randint(0, len(pats), size=n_seed)
            pat_arr = np.stack([np.frombuffer(p, np.uint8) for p in pats])
            starts = idx * 12
            for k in range(12):
                data[starts + k] = pat_arr[chosen, k]
        payload = data.tobytes()

        sess = MatchSession(table, max_chunks=1024, chunk_len=4096,
                            engine=engine, device=device)

        def one_pass():
            # probe + fetch + verify with the vectorized count decode
            # (decode_counts); depth 2 so verify overlaps the next batch's
            # device work
            ev = 0
            buf = sess.new_buffer()
            stream = StreamState(file_id=0)
            fobj = io.BytesIO(payload)
            pending = []
            t0 = time.perf_counter()
            while True:
                code, rd = buf.add_stream(fobj, stream)
                eof = rd == 0
                if buf.chunks and (code == -1 or eof):
                    batch = buf.to_batch()
                    pending.append((batch, sess.scan(batch)))
                    if len(pending) > 1:
                        b, c = pending.pop(0)
                        n, _ = sess.decode_counts(b, c)
                        ev += n
                    buf = sess.new_buffer()
                if eof:
                    break
            for b, c in pending:
                n, _ = sess.decode_counts(b, c)
                ev += n
            return ev, time.perf_counter() - t0

        one_pass()  # warm-up pass: allocator, first launches
        events, dt = one_pass()
        line = {
            "metric": "match_dense_e2e_bytes_per_s",
            "density": density,
            "value": size / dt,
            "unit": "bytes/s",
            "events": events,
            "wall_s": round(dt, 3),
            "patterns": patterns,
            "engine": engine,
        }
        print(json.dumps(line), flush=True)
        want = oracle_match_ends(pats, payload)
        if events != want:
            raise RuntimeError(f"density {density}: {events} events, the "
                               f"native oracle {want} match ends")
        print(f"[match_dense_bench] density {density}: {events} events == "
              f"native oracle", file=sys.stderr, flush=True)
        lines.append(line)
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m tpu_pattern_matching_torch.benchmarks."
             "match_dense_bench")
    ap.add_argument("--patterns", type=int, default=10_000)
    ap.add_argument("--mib", type=int, default=16)
    ap.add_argument("--engine", default="bloom")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; exits 2 without a card) or cpu")
    args = ap.parse_args(argv)
    dev = entry_device(args.device)
    if dev.type == "cuda":
        print(f"[match_dense_bench] card: {card()}", file=sys.stderr,
              flush=True)
    run(args.patterns, args.mib, args.engine, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
