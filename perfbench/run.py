"""One run of one cell of the benchmark, from the root of a checkout:

    python3 -m perfbench.run --workload NAME --seed N --seconds S --trace 0|1

Prints the run's result as one JSON line, the last of standard output,
and the numbers of its correctness check beside their limits as the last
lines of standard error. Exits 2, printing no result, without as many
CUDA cards as the cell asks for, and 1 when the run fails."""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def bytecode_cache() -> None:
    """Compiled bytecode of every module the run imports (torch's
    thousands among them) goes to a fixed directory of the checkout, also
    where the environment asks for none, so that only a checkout's first
    run compiles it."""
    here = os.path.dirname(os.path.abspath(__file__))
    sys.pycache_prefix = os.path.join(here, "_pycache")
    sys.dont_write_bytecode = False


def main(argv=None) -> int:
    bytecode_cache()
    from perfbench.harness import process_start

    t_start = process_start()
    ap = argparse.ArgumentParser(prog="perfbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)

    # a calibration file in the user's cache would change the chooser's
    # picks: the benchmark runs the defaults (this path does not exist)
    here = os.path.dirname(os.path.abspath(__file__))
    os.environ["TPM_COST_CONSTANTS"] = os.path.join(here, "no-cost-constants")

    from perfbench import spec
    from perfbench.harness import run_cell

    cell = spec.load(a.workload)
    t_main = time.time()
    import torch

    t_torch = time.time()
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"perfbench: {a.workload} needs {cell.chips} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"device_count() {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    print(f"[perfbench] set-up: interpreter {t_main - t_start:.2f} s, "
          f"torch imported {t_torch - t_main:.2f} s, CUDA found "
          f"{time.time() - t_torch:.2f} s", file=sys.stderr)
    line, numbers = run_cell(cell, a.seed, a.seconds, bool(a.trace),
                             "cuda", t_start=t_start)
    print(json.dumps(line), flush=True)
    for name, (v, lim, op) in numbers.items():
        print(f"check {name} {v} {op} {lim}", file=sys.stderr)
    sys.stderr.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
