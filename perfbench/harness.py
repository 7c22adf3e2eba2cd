"""One run of a cell: set-up (inputs from the seed, the system built as the
CLI builds it, warm-up), the measured window, then the check against the
reference and the metrics."""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import os
import shutil
import sys
import tempfile
import time

import numpy as np

from perfbench import spec
from perfbench.stream import FeedChain, Record, drive

FORBIDDEN = ("jax", "jaxlib", "flax", "tpu_pattern_matching")


def process_start() -> float:
    """``time.time()`` at this process's start (from ``/proc``)."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return time.time() - up + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.time()


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``,
    compared whole."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".", 1)[0] in FORBIDDEN})


@dataclasses.dataclass
class Inputs:
    sigs: list  # the configuration's signatures, as written
    ref_sigs: list  # as the configuration states them (its length limit)
    sig_path: str
    corpus: dict  # paths, tokens (end to end), starts, bits


def rng(seed: int, stream: int) -> np.random.Generator:
    """The generator of one input stream of a run (any whole seed,
    negative ones too)."""
    return np.random.default_rng([seed % 2**64, stream])


def make_inputs(cell: spec.Cell, seed: int, work: str) -> Inputs:
    """Signatures and corpus from ``seed``, written under ``work``."""
    cfg, traf = cell.config, cell.traffic
    sg = cfg["signatures"]
    gen = spec.generator(cell.root, sg["generator"])
    sigs = gen.make(sg, rng(seed, 1))
    sig_path = os.path.join(work, "signatures.txt")
    gen.write(sig_path, sigs)
    corpus_dir = os.path.join(work, "corpus")
    os.makedirs(corpus_dir)
    corpus = spec.generator(cell.root, traf["generator"]).make(
        traf, sigs, rng(seed, 2), corpus_dir)
    limit = cfg["pattern_limit"]
    return Inputs(sigs=sigs, ref_sigs=[s[:limit] for s in sigs],
                  sig_path=sig_path, corpus=corpus)


def sampler(seed: int, share: float):
    mask = rng(seed, 3).random(1 << 20) < share
    return lambda k: k < len(mask) and bool(mask[k])


def measure(cell: spec.Cell, seed: int, seconds: float, trace: bool,
            device: str, inputs: Inputs, t_start: float,
            stand_in=None) -> dict:
    """Build, warm up, (trace,) measure. Returns the run's record and
    readings. ``stand_in(session, inputs)`` gives ``(system, iid_of)`` to
    drive in the session's place (the control, and the tests' faults);
    the feed stays the session's."""
    import torch

    from perfbench import system
    from tpu_pattern_matching_torch import cli

    t_enter = time.time()
    cfg, traf = cell.config, cell.traffic
    args = system.cli_args(cfg, os.path.dirname(inputs.corpus["paths"][0]),
                           inputs.sig_path, device)
    dev = cli.select_device(args)
    sess, make_feeder, iid_of = system.build(cfg, args, dev)
    cuda = sess.device.type == "cuda"
    driven = sess
    if stand_in is not None:
        driven, iid_of = stand_in(sess, inputs)

    def sync():
        if cuda:
            torch.cuda.synchronize(sess.device)

    t_built = time.time()
    chain = FeedChain(make_feeder, inputs.corpus["paths"], traf["passes"])
    phases = Phases(traf, seconds, trace, chain, sess.device, sync)
    rec = Record()
    batches = cli.rank_batches(sess, chain)
    if trace:
        batches = phases.keep(batches)
    drive(driven, batches, rec, iid_of, sampler(seed, traf["check_share"]),
          phases.before, phases.mark)
    window_s = time.perf_counter() - phases.t0
    cpu_s = cpu_seconds() - phases.cpu0
    chain.close()
    sync()
    rec.window_from = phases.window_from
    print(f"[perfbench] set-up: start to build {t_enter - t_start:.2f} "
          f"s, build {t_built - t_enter:.2f} s, warm-up "
          f"{phases.setup_end - t_built:.2f} s; window "
          f"{window_s:.3f} s, batches {phases.window_from}.."
          f"{rec.batches}", file=sys.stderr)
    print(f"[perfbench] {fifths(rec.window(), phases.t0)}; the process "
          f"used {cpu_s / window_s:.3f} cores in the window",
          file=sys.stderr)
    peak = int(torch.cuda.max_memory_allocated(sess.device)) if cuda else 0
    traced = bound = None
    if trace:  # after the peak: the bound's arithmetic takes memory
        traced = phases.reduce(rec)
        bound = probe_bound_of(sess, phases.kept)
    out = dict(setup_s=phases.setup_end - t_start, window_s=window_s,
               rec=rec, peak=peak, trace=traced, probe_bound=bound,
               workers=args.thread_no,
               device_kind=torch.cuda.get_device_name(sess.device)
               if cuda else "cpu")
    del sess, make_feeder, driven
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return out


def cpu_seconds() -> float:
    """This process's CPU seconds (user and system, all threads)."""
    import resource

    ru = resource.getrusage(resource.RUSAGE_SELF)
    return ru.ru_utime + ru.ru_stime


def fifths(win: Record, t0: float) -> str:
    """The window's rate in each fifth of its batches (symbols a second),
    to see a drift."""
    n = win.batches
    if n < 5:
        return "rate by fifths: too few batches"
    cut = [n * j // 5 for j in range(6)]
    ends = [t0] + win.done
    rates = [sum(win.symbols[a:b]) / (ends[b] - ends[a])
             for a, b in zip(cut, cut[1:])]
    return "rate by fifths of the window: " + " ".join(
        f"{r:.4g}" for r in rates)


DRAIN_BATCHES = 8  # at most, after the warm-up, to empty the feed's queue


class Phases:
    """A run's phases on one stream of batches, switched on batch
    boundaries: ``warmup_batches`` batches; with ``trace``,
    ``profile_batches`` more under ``torch.profiler`` (the three calls
    marked); the batches the feed had queued by then (at most
    ``DRAIN_BATCHES``); then the measured window, from its first batch's
    feed wait
    until the last batch asked for before ``seconds`` have passed is
    decoded (whole batches)."""

    def __init__(self, traf, seconds, trace, chain, device, sync):
        self.warmup = traf["warmup_batches"]
        self.profiled = traf["profile_batches"] if trace else 0
        self.seconds, self.chain = seconds, chain
        self.device, self.sync = device, sync
        self.prof = None
        self.profiling = False
        self.kept = None  # a batch of the profiled phase, for the bound
        self.window_from = self.t0 = self.setup_end = self.cpu0 = None

    def before(self, i: int) -> None:
        if i == self.warmup and self.profiled:
            self.sync()
            self._start_profile()
        elif i >= self.warmup + self.profiled and self.t0 is None:
            if self.profiling:
                self.sync()
                self.prof.stop()
                self.profiling = False
            # batches the feed made ahead while set-up ran (a first run's
            # kernel builds, the trace's stop) would come at once in the
            # window: it opens once the feed's queue is empty
            if self.chain.queued() and i < self.warmup + self.profiled + \
                    DRAIN_BATCHES:
                return
            self.sync()
            self.window_from = i
            self.cpu0 = cpu_seconds()
            self.setup_end = time.time()
            self.t0 = time.perf_counter()
            self.chain.deadline = self.t0 + self.seconds

    def _start_profile(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.start()
        self.profiling = True

    def keep(self, items):
        """``items``, keeping the first batch of the profiled phase."""
        for item in items:
            if self.profiling and self.kept is None and item.batch.chunks:
                self.kept = item.batch
            yield item

    def mark(self, name: str):
        if self.profiling:
            from torch.profiler import record_function

            return record_function(name)
        return contextlib.nullcontext()

    def reduce(self, rec: Record):
        from perfbench import trace

        k0, k1 = self.warmup, self.warmup + self.profiled
        return trace.reduce(self.prof, k1 - k0, int(sum(rec.symbols[k0:k1])),
                            cuda=self.device.type == "cuda")


def probe_bound_of(sess, batch) -> dict | None:
    """The frozen bound of the probe's launch on ``batch`` with the
    session's filter (its words and config are the kernel's inputs)."""
    import torch

    from perfbench.roofline.probe import probe_bound, time_major

    if batch is None or sess.engine != "bloom" or sess._bloom is None:
        return None
    bl = sess._bloom
    data = torch.from_numpy(batch.data).to(sess.device)
    bounds = torch.from_numpy(np.stack([batch.start_t, batch.end_t])).to(
        sess.device)
    data_tm, bp = time_major(data, bounds, bl.cfg)
    return probe_bound(data_tm, bp, bl.words, bl.cfg)


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: float | None = None,
             stand_in=None) -> tuple[dict, dict]:
    """One run: ``(result line, numbers compared)``; ``stand_in`` as in
    :func:`measure`."""
    import torch

    from perfbench import check

    t_start = process_start() if t_start is None else t_start
    print(f"[perfbench] set-up: interpreter and imports "
          f"{time.time() - t_start:.2f} s", file=sys.stderr)
    work = tempfile.mkdtemp(prefix="perfbench-")  # under TMPDIR
    try:
        inputs = make_inputs(cell, seed, work)
        print(f"[perfbench] set-up: inputs made and written by "
              f"{time.time() - t_start:.2f} s", file=sys.stderr)
        part = measure(cell, seed, seconds, trace, device, inputs, t_start,
                       stand_in)
        found = forbidden_modules()
        if found:
            raise SystemExit(f"forbidden modules loaded: {found}")
        corpus = inputs.corpus
        dev = torch.device("cuda" if device == "cuda" else "cpu")
        t_ref = time.perf_counter()
        ref = check.reference_events(corpus["tokens"], corpus["starts"],
                                     inputs.ref_sigs, corpus["bits"], dev)
        rec = part["rec"]
        numbers, bad = check.compare(rec.lanes, rec.reported, rec.events,
                                     ref, corpus["starts"], part["workers"])
        print(f"[perfbench] reference: {len(ref[0])} events in the corpus "
              f"of {len(corpus['starts']) - 1} files, "
              f"{len(corpus['tokens'])} symbols, checked in "
              f"{time.perf_counter() - t_ref:.2f} s", file=sys.stderr)
        line = result_line(cell, part, numbers, bad, trace, device)
        return line, numbers
    finally:
        shutil.rmtree(work, ignore_errors=True)


def read_metrics(cell: spec.Cell, metrics: list[dict], run: dict) -> dict:
    out = {}
    for m in metrics:
        v = spec.metric_reader(cell.root, m["name"]).read(run)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def result_line(cell, part, numbers, bad, trace, device) -> dict:
    rec = part["rec"]
    win = rec.window()
    run = dict(unit=cell.config["unit"], symbols=int(sum(win.symbols)),
               batches=win.batches, window_s=part["window_s"],
               setup_s=part["setup_s"], rec=win, trace=part["trace"],
               probe_bound=part["probe_bound"])
    metrics = read_metrics(cell, cell.per_layer if trace else
                           cell.end_to_end, run)
    holds = all(v <= lim if op == "<=" else v >= lim
                for v, lim, op in numbers.values())
    dev = dict(platform="gpu" if device == "cuda" else "cpu",
               kind=part["device_kind"], count=1,
               memory_peak_bytes=part["peak"])
    line = dict(correct=holds, attempted=rec.batches, failed=bad,
                metrics=metrics, device=dev)
    if trace:
        from perfbench.trace import breakdown

        dev["busy_s"] = part["trace"].busy_s
        dev["window_s"] = part["trace"].window_s
        line["breakdown"] = breakdown(part["trace"])
    line["checks"] = {k: {"value": v, "limit": lim, "test": op}
                      for k, (v, lim, op) in numbers.items()}
    return line
