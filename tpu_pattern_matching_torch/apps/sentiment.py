"""Streaming sentiment analysis on the port's match counts (port of the
reference's ``apps/sentiment.py``).

    python -m tpu_pattern_matching_torch.apps.sentiment INPUT --patterns P
        [--device cuda|cpu] [--subprocess | --stdin] [--build-patterns N P S]

Negative words get ids < 0, positive words ids > 0; decayed counters per
time window track the positive/negative balance and per-word heavy
hitters. The two modes that run the matcher are ported:
``run_library_mode`` scans on the port's ``MatchSession`` and
``run_subprocess_mode`` spawns the port's CLI and parses its verbose
lines. The counters, the report printer, the pattern-file writer and the
stdin pipe mode are the reference's own (its module is jax-free at
import).
"""

from __future__ import annotations

import argparse
import sys
import time

from tpu_pattern_matching.apps.sentiment import (  # noqa: F401
    DEFAULT_WINDOWS,
    SentimentAnalyzer,
    SentimentReport,
    TimeWindowCounter,
    build_sentiment_patterns,
    print_reports,
    run_stdin_mode,
)


def run_library_mode(args, metadata: dict[int, float] | None = None) -> int:
    """Sentiment over the port's library API (one process) on
    ``args.device`` (default ``"cuda"``)."""
    from tpu_pattern_matching.core.dfa import AhoCorasick
    from tpu_pattern_matching.core.patterns import load_pattern_file
    from tpu_pattern_matching_torch.runtime.session import MatchSession

    parsed = load_pattern_file(args.patterns)
    ac = AhoCorasick()
    for p in parsed:
        ac.add_pattern(p.data, iid=p.iid, label=p.label)
    table = ac.compile()
    sess = MatchSession(
        table, max_chunks=args.global_ws, chunk_len=args.chunk_size,
        device=getattr(args, "device", "cuda"),
    )
    ana = SentimentAnalyzer(
        iids=[p.iid for p in table.patterns],
        labels=[p.label.strip(' "') for p in table.patterns],
        metadata=metadata,
    )
    last_print = time.time()
    with open(args.input, "rb") as f:
        for bm in sess.scan_stream(f, text_mode=True):
            now = time.time()
            for ev in bm.events:
                for pidx in ev.pattern_indices:
                    ana.add_match(pidx, now)
            if now - last_print >= args.interval:
                print_reports(ana)
                last_print = now
    print_reports(ana)
    return 0


def run_subprocess_mode(args) -> int:
    """Reference-style: spawn the port's CLI and parse its verbose stdout
    (the "Pattern <id> ..." lines are the CLI's API)."""
    import subprocess

    cmd = [
        sys.executable, "-m", "tpu_pattern_matching_torch.cli",
        "-p", args.patterns, "-f", args.input, "-B", str(args.chunk_size),
        "-G", str(args.global_ws), "-w", "1", "-t", "-v",
        "--device", getattr(args, "device", "cuda"),
    ]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE)
    ana = SentimentAnalyzer(iids=[], labels=[])
    # iid-keyed counters (the table is not in this process)
    seen: dict[int, str] = {}

    def add(iid: int, label: str):
        if iid not in seen:
            seen[iid] = label
            ana.iids.append(iid)
            ana.labels.append(label)
        pidx = list(seen).index(iid)
        ana.add_match(pidx)

    assert proc.stdout is not None
    for raw in proc.stdout:
        line = raw.decode("utf-8", "replace")
        if line.startswith("Pattern"):
            toks = line.split()
            iid = int(toks[1].replace("#", ""))
            label = line.split("('")[1].split("')")[0]
            add(iid, label)
    proc.wait()
    print_reports(ana)
    return proc.returncode or 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="torch-sentiment")
    ap.add_argument("input", nargs="?", default="-")
    ap.add_argument("--patterns")
    ap.add_argument(
        "--stdin",
        action="store_true",
        help="pipe mode: parse matcher -v output from stdin",
    )
    ap.add_argument("--chunk-size", dest="chunk_size", type=int, default=4096)
    ap.add_argument("--global-ws", dest="global_ws", type=int, default=8192)
    ap.add_argument("--interval", type=float, default=5.0)
    ap.add_argument(
        "--subprocess",
        action="store_true",
        help="reference-style stdout scraping of the CLI",
    )
    ap.add_argument("--build-patterns", nargs=3, metavar=("NEG", "POS", "SCORED"))
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)
    if args.stdin:
        return run_stdin_mode(args)
    if not args.patterns or args.input == "-":
        ap.error("--patterns and an input file are required outside --stdin")
    metadata = None
    if args.build_patterns:
        neg, pos, scored = args.build_patterns
        metadata = build_sentiment_patterns(
            neg or None, pos or None, scored or None, args.patterns
        )
    if args.subprocess:
        return run_subprocess_mode(args)
    return run_library_mode(args, metadata)


if __name__ == "__main__":
    sys.exit(main())
