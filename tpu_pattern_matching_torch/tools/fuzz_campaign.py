"""Randomized differential campaign of the port: every exactness path
against the oracle (port of the reference's ``tools/fuzz_campaign.py``).

Hundreds of randomized trials over pattern sets, corpora and session
geometries, asserting EXACT (end_offset, pattern_index) agreement between
the independent Python oracle and every engine/verify/shard combination
of the port on one device:

- bloom, chooser-picked config, host verify   (the flagship path)
- bloom forced strided / forced sampled       (both kernel modes)
- bloom with device verify                    (ops/verify_device.py)
- bloom with pattern shards                   (parallel/pshard.py union)
- dense walk                                  (exact on the device)

plus a text-mode arm set every third trial and a ushort arm set every
third trial, as in the reference. A trial makes the reference's draws from
the same ``RandomState``, so its patterns, corpus, geometry and arm
choices equal the reference's trial of the same number and seed. Run
inside a ``torch.distributed`` group of 2 or more ranks (every rank the
same trials), the campaign adds the reference's mesh arms every fourth
trial (``mesh_bloom``, ``mesh_device_verify``, ``pshard_device_verify``
on the ("pat", "data") grid of 2 shards when the world is even,
``mesh_dense``, and the ushort ``u_mesh``) on the whole world: every rank
scans the trial's corpus, so each must find the oracle's events, except
a grid follower, which returns none. Any divergence raises with the full
reproduction tuple and the tool exits non-zero; the last line is the
reference's JSON summary.

Usage: python -m tpu_pattern_matching_torch.tools.fuzz_campaign
       [n_trials] [master_seed] [start] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

ALPHABETS = [2, 4, 16, 64, 256]
USHORT_ALPHABETS = [8, 64, 2048]  # token values (table width stays 2048)
USHORT_EVERY = 3  # trials also running the ushort arm set
TEXT_EVERY = 3  # trials (mod 3 == 1) also running the text-mode arm set
MESH_EVERY = 4  # trials (mod 4 == 2) also running the mesh arm set


def mesh_world() -> int:
    """The ranks of the ``torch.distributed`` group the campaign runs in
    (1 without one): the mesh arms need 2 or more."""
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_initialized() else 1


def _find(table, data, kw, chunks, clen, device, text_mode=False):
    """``find`` of one arm's session, and whether the session is a grid
    follower (whose ``find`` returns no events)."""
    from tpu_pattern_matching_torch.runtime.session import MatchSession

    sess = MatchSession(table, max_chunks=chunks, chunk_len=clen,
                        device=device, **kw)
    follower = sess._grid is not None and not sess._grid.is_leader
    return sess.find(data, text_mode=text_mode), follower


def _check(name, got, want, repro) -> None:
    if got != want:
        missing = sorted(set(want) - set(got))[:5]
        spurious = sorted(set(got) - set(want))[:5]
        raise AssertionError(
            f"{name} diverged [{repro}]: {len(got)} events vs "
            f"{len(want)} oracle; missing={missing} spurious={spurious}"
        )


def run_trial(trial: int, master_seed: int, device="cuda") -> dict:
    """One trial on ``device``: the reference's draws from the same
    ``RandomState``, then every arm's ``find`` against the oracle. Returns
    ``{"events": oracle events, "arms": arm names run}``."""
    from tpu_pattern_matching_torch.core.dfa import compile_patterns
    from tpu_pattern_matching_torch.core.oracle import match_python

    rng = np.random.RandomState(master_seed * 100_003 + trial)
    asize = ALPHABETS[rng.randint(len(ALPHABETS))]
    alphabet = np.arange(asize, dtype=np.uint8)
    n_pats = int(rng.randint(1, 41))
    lmin = int(rng.randint(1, 8))
    lmax = lmin + int(rng.randint(0, 18))
    pats: set[bytes] = set()
    tries = 0
    while len(pats) < n_pats and tries < 400:
        ln = rng.randint(lmin, lmax + 1)
        pats.add(bytes(rng.choice(alphabet, size=ln).astype(np.uint8)))
        tries += 1
    pat_list = sorted(pats)
    size = int(rng.choice([512, 1024, 3000, 8192, 16384]))
    plants = int(rng.randint(0, 60))
    data = bytearray(rng.choice(alphabet, size=size).astype(np.uint8))
    for _ in range(plants):
        p = pat_list[rng.randint(len(pat_list))]
        if len(p) <= size:
            pos = rng.randint(0, size - len(p) + 1)
            data[pos : pos + len(p)] = p
    data = bytes(data)
    chunks = int(rng.choice([2, 3, 4, 8, 16, 64]))
    clen = int(rng.choice([8, 16, 32, 64, 128, 256]))
    repro = (
        f"trial={trial} seed={master_seed} asize={asize} "
        f"n={len(pat_list)} l=[{lmin},{lmax}] size={size} "
        f"plants={plants} geom=({chunks},{clen})"
    )
    arms = {"bloom_auto": dict(engine="bloom")}
    # both kernel modes when the set admits them (sampled needs
    # Lmin-q+1 >= 2 windows to differ from strided; the filter build
    # guards it)
    if rng.rand() < 0.5:
        arms["bloom_strided"] = dict(
            engine="bloom", bloom_opts={"mode": "strided"}
        )
    if rng.rand() < 0.5:
        arms["bloom_sampled"] = dict(
            engine="bloom", bloom_opts={"mode": "sampled"}
        )
    if rng.rand() < 0.5:
        arms["device_verify"] = dict(engine="bloom", verify="device")
    if rng.rand() < 0.5 and len(pat_list) >= 2:
        arms["pat_shards"] = dict(
            engine="bloom",
            pat_shards=int(rng.randint(2, min(5, len(pat_list) + 1))),
        )
    world = mesh_world()
    if world >= 2 and trial % MESH_EVERY == 2:
        # the reference's mesh arms (they make no draws) on the whole
        # world: the data mesh, its device verify, the grid's device
        # verify and the dense engine's per-rank compaction
        arms["mesh_bloom"] = dict(engine="bloom", mesh="all")
        arms["mesh_device_verify"] = dict(engine="bloom", mesh="all",
                                          verify="device")
        if len(pat_list) >= 2 and world % 2 == 0:
            arms["pshard_device_verify"] = dict(
                engine="bloom", mesh="all", pat_shards=2, verify="device")
        arms["mesh_dense"] = dict(engine="dense", mesh="all",
                                  max_results=256)
    arms["dense"] = dict(engine="dense", max_results=256)
    want = sorted(match_python(pat_list, data))
    table = compile_patterns(pat_list)
    ran = []
    for name, kw in arms.items():
        got, follower = _find(table, data, kw, chunks, clen, device)
        _check(name, got, [] if follower else want, repro)
        ran.append(name)
    if trial % USHORT_EVERY == 0:
        ran += run_ushort_arms(rng, device)
    if trial % TEXT_EVERY == 1:
        ran += run_text_arms(rng, device)
    return {"events": len(want), "arms": ran}


def run_text_arms(rng, device="cuda") -> list[str]:
    """Text (line) mode arms: matches must not span lines, long lines
    split into halo-linked fragments, and offsets stay stream-absolute.
    Oracle = per-line match union at absolute offsets."""
    from tpu_pattern_matching_torch.core.dfa import compile_patterns
    from tpu_pattern_matching_torch.core.oracle import match_python

    # printable alphabet without newline so patterns cannot span lines
    alphabet = np.frombuffer(bytes(range(32, 127)) + b"\t", np.uint8)
    n_pats = int(rng.randint(1, 16))
    lmin = int(rng.randint(1, 5))
    lmax = lmin + int(rng.randint(0, 10))
    pats: set[bytes] = set()
    tries = 0
    while len(pats) < n_pats and tries < 200:
        ln = rng.randint(lmin, lmax + 1)
        pats.add(bytes(rng.choice(alphabet, size=ln).astype(np.uint8)))
        tries += 1
    pat_list = sorted(pats)
    n_lines = int(rng.randint(1, 30))
    lines = []
    for _ in range(n_lines):
        L = int(rng.choice([0, 3, 20, 80, 400]))
        row = bytearray(rng.choice(alphabet, size=L).astype(np.uint8))
        for _ in range(int(rng.randint(0, 4))):
            p = pat_list[rng.randint(len(pat_list))]
            if len(p) <= L:
                pos = rng.randint(0, L - len(p) + 1)
                row[pos : pos + len(p)] = p
        lines.append(bytes(row))
    text = b"\n".join(lines) + b"\n"
    want = []
    off = 0
    for row in lines:
        for e, pid in match_python(pat_list, row):
            want.append((off + e, pid))
        off += len(row) + 1
    want = sorted(want)
    table = compile_patterns(pat_list)
    chunks = int(rng.choice([2, 4, 16]))
    clen = int(rng.choice([16, 64, 256]))
    arms = {
        "t_dense": dict(engine="dense", max_results=256),
        "t_bloom": dict(engine="bloom"),
    }
    repro = (f"text n={len(pat_list)} l=[{lmin},{lmax}] lines={n_lines} "
             f"geom=({chunks},{clen})")
    ran = []
    for name, kw in arms.items():
        got, _follower = _find(table, text, kw, chunks, clen, device,
                               text_mode=True)
        _check(name, got, want, repro)
        ran.append(name)
    return ran


def run_ushort_arms(rng, device="cuda") -> list[str]:
    """Ushort-alphabet arms through the product path: a token sequence
    serialized as comma-separated text streams through UshortBuffer's
    incremental parser into uint16 lanes, then each engine's find() must
    equal the oracle in token offsets."""
    from tpu_pattern_matching_torch.core.dfa import AhoCorasick
    from tpu_pattern_matching_torch.core.oracle import match_python

    asize = USHORT_ALPHABETS[rng.randint(len(USHORT_ALPHABETS))]
    n_pats = int(rng.randint(1, 21))
    lmin = int(rng.randint(1, 5))
    lmax = lmin + int(rng.randint(0, 12))
    pats: set[tuple] = set()
    tries = 0
    while len(pats) < n_pats and tries < 200:
        ln = rng.randint(lmin, lmax + 1)
        pats.add(tuple(int(x) for x in rng.randint(0, asize, size=ln)))
        tries += 1
    pat_list = sorted(pats)
    n_tok = int(rng.choice([64, 300, 1200]))
    seq = rng.randint(0, asize, size=n_tok)
    for _ in range(int(rng.randint(0, 25))):
        p = pat_list[rng.randint(len(pat_list))]
        if len(p) <= n_tok:
            pos = rng.randint(0, n_tok - len(p) + 1)
            seq[pos : pos + len(p)] = p
    want = sorted(match_python(pat_list, seq.tolist()))
    ac = AhoCorasick(alphabet_size=2048)
    for p in pat_list:
        ac.add_pattern(p)
    table = ac.compile()
    text = (",".join(str(int(x)) for x in seq)).encode()
    chunks = int(rng.choice([2, 4, 16]))
    clen = int(rng.choice([8, 32, 128]))
    arms = {
        "u_dense": dict(engine="dense", max_results=256),
        "u_bloom": dict(engine="bloom"),
    }
    if rng.rand() < 0.5:
        arms["u_device_verify"] = dict(engine="bloom", verify="device")
    # the reference draws for its mesh arm on its (virtual) devices, so
    # the draw is made alone too, to keep the trials' draws in step
    if rng.rand() < 0.4 and mesh_world() >= 2:
        arms["u_mesh"] = dict(engine="bloom", mesh="all")
    repro = (f"ushort asize={asize} n={len(pat_list)} l=[{lmin},{lmax}] "
             f"n_tok={n_tok} geom=({chunks},{clen})")
    ran = []
    for name, kw in arms.items():
        got, _follower = _find(table, text, kw, chunks, clen, device)
        _check(name, got, want, repro)
        ran.append(name)
    return ran


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description="randomized differential "
                                 "campaign of the port against the oracle")
    ap.add_argument("n_trials", nargs="?", type=int, default=100)
    ap.add_argument("master_seed", nargs="?", type=int, default=0)
    ap.add_argument("start", nargs="?", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; the kernels) or cpu (their plain "
                    "versions)")
    a = ap.parse_args(argv)
    t0 = time.time()
    arm_counts: dict[str, int] = {}
    events = 0
    for trial in range(a.start, a.start + a.n_trials):
        res = run_trial(trial, a.master_seed, a.device)
        events += res["events"]
        for arm in res["arms"]:
            arm_counts[arm] = arm_counts.get(arm, 0) + 1
        print(".", end="", flush=True)
        if (trial + 1) % 50 == 0:
            print(f" {trial + 1}", flush=True)
    print()
    print(json.dumps({
        "metric": "fuzz_campaign",
        "trials": a.n_trials,
        "master_seed": a.master_seed,
        "mismatches": 0,
        "oracle_events_total": events,
        "arm_trials": arm_counts,
        "wall_s": round(time.time() - t0, 1),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
