"""Cost-model constants for the bloom chooser (port of the reference's
``ops/costmodel.py``: ``CostConstants`` and ``get_cost_constants`` only).

Same env var (``TPM_COST_CONSTANTS``), same cache file and the same v5e
defaults as the reference, so the port's chooser makes the reference's
picks and the two packages build bit-identical filters. The constants
price a TPU, not a GPU: a calibrator for the H100 is still to be written
(ROADMAP queue 1, chooser pricing).
"""

from __future__ import annotations

import dataclasses
import json
import os

ENV_VAR = "TPM_COST_CONSTANTS"
DEFAULT_PATH = os.path.join(
    os.path.expanduser("~"), ".cache", "tpu_pattern_matching",
    "cost_constants.json",
)


@dataclasses.dataclass(frozen=True)
class CostConstants:
    """The chooser's priced-hardware constants, with the reference's
    defaults: the reference calibrator's run on a TPU v5e. They are
    TPU prices, kept so the port picks the reference's configs.

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
