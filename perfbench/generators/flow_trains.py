"""Flow files as the upstream's AC_ushorts reads them: one file per flow,
holding that flow's packet-length train as comma-separated numbers on one
line (the format of ``tools/length_trains.py``, the port's copy of the
upstream's extractor: ``0, 1460, 517\\n``), with the configuration's
signatures planted inside flows.

Every seed gives the same flows: ``flows`` lengths in packets, taken at
fixed quantiles of a Pareto law (``min_packets``, ``tail_index``) and put
in another order by the seed. The packets' payload lengths are drawn from
the seed out of a mix of pure ACKs (0), full segments (``mss_bytes``) and
lengths in between, uniform (``payload_mix``). ``plant_density`` planted
tokens per token gives a fixed number of plants, each wholly inside one
flow (a flow is chosen by the room it has for the signature).

Returns the files' paths, their tokens end to end (``tokens``) and each
flow's first token in them (``starts``, ``flows + 1`` entries)."""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

# decimal text of 0..2047 and ", ", as rows of a byte table
_TEXT = [f"{v}, ".encode() for v in range(2048)]
_WIDTH = max(len(t) for t in _TEXT)
_TABLE = np.zeros((2048, _WIDTH), np.uint8)
for _v, _t in enumerate(_TEXT):
    _TABLE[_v, :len(_t)] = np.frombuffer(_t, np.uint8)
_LEN = np.array([len(t) for t in _TEXT])
_KEEP = np.arange(_WIDTH)[None, :] < _LEN[:, None]


def to_text(tokens: np.ndarray) -> bytes:
    """``tokens`` as ``"a, b, c, "`` (each number and its separator)."""
    return _TABLE[tokens][_KEEP[tokens]].tobytes()


def flow_lengths(params: dict) -> np.ndarray:
    """Packets a flow, at the quantiles ``(i + 0.5) / flows``."""
    n = params["flows"]
    u = (np.arange(n) + 0.5) / n
    x = params["min_packets"] * (1 - u) ** (-1 / params["tail_index"])
    return np.floor(x).astype(np.int64)


def payloads(mix: dict, n: int, rng: np.random.Generator) -> np.ndarray:
    mss = mix["mss_bytes"]
    kind = rng.random(n)
    out = rng.integers(1, mss, size=n)
    out[kind < mix["ack"]] = 0
    out[(kind >= mix["ack"]) & (kind < mix["ack"] + mix["mss"])] = mss
    return out.astype(np.uint16)


def plant(tokens: np.ndarray, starts: np.ndarray, sigs: list[np.ndarray],
          count: int, rng: np.random.Generator) -> None:
    """Write ``count`` signatures, each drawn at random, into ``tokens`` in
    place, each at a uniform position among those where it fits wholly
    inside one flow (later plants may overwrite earlier ones; the
    reference reads the result)."""
    lens = np.array([len(s) for s in sigs])
    flow_len = np.diff(starts)
    chosen = rng.integers(0, len(sigs), size=count)
    at = rng.random(count)
    for L in np.unique(lens[chosen]):
        sel = np.flatnonzero(lens[chosen] == L)
        room = np.maximum(flow_len - L + 1, 0)
        edge = np.cumsum(room)
        pos = (at[sel] * edge[-1]).astype(np.int64)
        f = np.searchsorted(edge, pos, "right")
        start = starts[f] + pos - (edge[f] - room[f])
        table = np.stack([sigs[i] for i in chosen[sel]])  # [k, L]
        tokens[start[:, None] + np.arange(L)] = table


def make(params: dict, sigs: list[np.ndarray], rng: np.random.Generator,
         out_dir: str) -> dict:
    lens = rng.permutation(flow_lengths(params))
    starts = np.concatenate([[0], np.cumsum(lens)])
    tokens = payloads(params["payload_mix"], int(starts[-1]), rng)
    mean = float(np.mean([len(s) for s in sigs]))
    plant(tokens, starts, sigs,
          int(starts[-1] * params["plant_density"] / mean), rng)
    text = to_text(tokens)
    cut = np.concatenate([[0], np.cumsum(_LEN[tokens])])[starts]
    paths = [os.path.join(out_dir, f"flow_{i:05d}") for i in range(len(lens))]

    def write(i):
        with open(paths[i], "wb") as f:  # the last ", " becomes "\n"
            f.write(text[cut[i]:cut[i + 1] - 2] + b"\n")

    with ThreadPoolExecutor(4) as pool:
        list(pool.map(write, range(len(lens))))
    return {"paths": paths, "tokens": tokens, "starts": starts, "bits": 16}
