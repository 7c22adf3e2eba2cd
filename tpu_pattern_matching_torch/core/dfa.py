"""Aho-Corasick DFA compiler.

Builds a dense deterministic automaton from a set of fixed patterns and emits
a device-friendly transition table. This is the TPU-native counterpart of the
reference's acsmx.c state-machine compiler (trie insert acsmx.c:319-349, BFS
failure links acsmx.c:355-438, NFA->DFA closure acsmx.c:444-486, serialization
acsmx.c:600-671) and of the ushort-alphabet variant AC_ushorts/iacsmx.c.

Design decisions vs the reference (SURVEY.md section 7):

- **Single signed table.** The reference serializes ``[S, 2*256]`` int32 —
  cell ``[s][c]`` = next state negated if final, cell ``[s][256+c]`` = pattern
  index (acsmx.c:640-658). We keep the sign-bit final encoding but drop the
  second 256-wide row: the device scan only needs the *state* at a match; the
  (tiny, per-state) match metadata is resolved after compaction. This halves
  table memory and gather bandwidth — the scan's bottleneck on TPU.
- **Match groups.** Each final state gets a dense "match group" id. A group
  carries the full set of pattern indices ending at that state (own patterns
  plus the failure-chain closure). The device reports the next-state on match;
  group expansion to ``(pattern, iid)`` happens host-side (or via one small
  device gather for per-pattern count reductions). This is strictly more
  capable than the reference, which reports only ``match_list->index`` — the
  head of the per-state list (acsmx.c:645-651) — and silently drops
  co-terminating patterns.
- **Generic alphabet.** ``alphabet_size=256`` for bytes, ``2048`` for the
  packet-metadata ushort mode (AC_ushorts/iacsmx.h:43 I_ALPHABET_SIZE).
- **npz serialization.** Restores the compiled-automaton dump the reference
  removed (acsmx.h:29-30 "removed dumping to file for current version").
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Sequence

import numpy as np

ALPHABET_BYTE = 256
ALPHABET_USHORT = 2048


@dataclasses.dataclass
class Pattern:
    """One compiled pattern.

    Mirrors the reference's acsm_pattern_t (acsmx.h:51-63): ``index`` is the
    dense insertion index used in device results, ``iid`` is the user-facing
    pattern id (the categorical id from the pattern file, or the line number).
    """

    symbols: tuple[int, ...]
    iid: int
    index: int
    label: str = ""

    @property
    def n(self) -> int:
        return len(self.symbols)

    def as_bytes(self) -> bytes:
        return bytes(self.symbols)


@dataclasses.dataclass
class DfaTable:
    """Dense compiled automaton, ready for device upload.

    ``goto_signed[s, c]`` is the next state after reading symbol ``c`` in
    state ``s``; it is negated iff the next state is final (a match ends
    there). State 0 is the root and is never final, so the sign is unambiguous.

    ``state_gid[s]`` is -1 for non-final states, else a dense group id.
    ``group_offsets``/``group_pids`` form a ragged list: group ``g`` matches
    pattern indices ``group_pids[group_offsets[g]:group_offsets[g+1]]``.
    ``group_rep[g]`` is the smallest pattern index in the group (the
    deterministic representative used for single-id reporting).
    """

    goto_signed: np.ndarray  # [S, A] int32 (or int16 when S < 2**15)
    state_gid: np.ndarray  # [S] int32
    group_state: np.ndarray  # [G] int32
    group_offsets: np.ndarray  # [G+1] int32
    group_pids: np.ndarray  # [sum group sizes] int32
    group_rep: np.ndarray  # [G] int32
    alphabet_size: int
    max_pat_len: int
    patterns: list[Pattern]
    nocase: bool = False  # patterns case-folded; engines must fold input

    @property
    def num_states(self) -> int:
        return self.goto_signed.shape[0]

    @property
    def num_groups(self) -> int:
        return self.group_state.shape[0]

    @property
    def num_patterns(self) -> int:
        return len(self.patterns)

    @property
    def nbytes(self) -> int:
        """Size of the device transition table (reference acsm_get_size)."""
        return self.goto_signed.nbytes

    def groups_as_lists(self) -> list[list[int]]:
        return [
            self.group_pids[self.group_offsets[g] : self.group_offsets[g + 1]].tolist()
            for g in range(self.num_groups)
        ]

    # -- serialization (restores the feature removed at acsmx.h:29-30) ------
    #
    # Pattern metadata is stored as concatenated flat arrays + offsets (the
    # same layout the native oracle_create ABI takes) — NO object arrays,
    # NO pickle. A precompiled automaton is a shipped, loadable artifact
    # (--load-dfa), and unpickling an untrusted file is arbitrary code
    # execution; flat arrays also load faster.

    def save(self, path: str) -> None:
        syms = [np.asarray(p.symbols, np.int32) for p in self.patterns]
        lens = np.asarray([len(s) for s in syms], np.int64)
        sym_offsets = np.zeros(len(syms) + 1, np.int64)
        np.cumsum(lens, out=sym_offsets[1:])
        labels = [p.label.encode("utf-8") for p in self.patterns]
        lab_offsets = np.zeros(len(labels) + 1, np.int64)
        np.cumsum([len(b) for b in labels], out=lab_offsets[1:])
        np.savez_compressed(
            path,
            goto_signed=self.goto_signed,
            state_gid=self.state_gid,
            group_state=self.group_state,
            group_offsets=self.group_offsets,
            group_pids=self.group_pids,
            group_rep=self.group_rep,
            alphabet_size=np.int64(self.alphabet_size),
            max_pat_len=np.int64(self.max_pat_len),
            nocase=np.bool_(self.nocase),
            pat_sym_flat=(
                np.concatenate(syms) if syms else np.zeros(0, np.int32)
            ),
            pat_sym_offsets=sym_offsets,
            pat_iids=np.asarray([p.iid for p in self.patterns], np.int64),
            pat_label_blob=np.frombuffer(b"".join(labels), np.uint8).copy(),
            pat_label_offsets=lab_offsets,
        )

    @staticmethod
    def load(path: str, legacy_pickle: bool = False) -> "DfaTable":
        """Load a saved table. Loading never unpickles: files from the
        flat format load directly; files from the pre-round-3 object-array
        format require ``legacy_pickle=True`` (only pass it for files YOU
        created — unpickling an untrusted file executes arbitrary code)."""
        z = np.load(path, allow_pickle=False)
        if "pat_sym_flat" in z.files:
            so = z["pat_sym_offsets"]
            sf = z["pat_sym_flat"]
            lo = z["pat_label_offsets"]
            lb = z["pat_label_blob"].tobytes()
            iids = z["pat_iids"]
            patterns = [
                Pattern(
                    tuple(int(x) for x in sf[so[i] : so[i + 1]]),
                    int(iids[i]),
                    i,
                    lb[lo[i] : lo[i + 1]].decode("utf-8"),
                )
                for i in range(len(iids))
            ]
        elif "pat_symbols" in z.files:
            if not legacy_pickle:
                raise ValueError(
                    f"'{path}' is a legacy pickled DfaTable dump; pass "
                    f"legacy_pickle=True ONLY if you trust its origin "
                    f"(unpickling executes arbitrary code), or re-save it "
                    f"with the current format"
                )
            z = np.load(path, allow_pickle=True)
            patterns = [
                Pattern(tuple(sym), int(iid), i, str(label))
                for i, (sym, iid, label) in enumerate(
                    zip(z["pat_symbols"], z["pat_iids"], z["pat_labels"])
                )
            ]
        else:
            raise ValueError(f"'{path}' is not a DfaTable dump")
        return DfaTable(
            goto_signed=z["goto_signed"],
            state_gid=z["state_gid"],
            group_state=z["group_state"],
            group_offsets=z["group_offsets"],
            group_pids=z["group_pids"],
            group_rep=z["group_rep"],
            alphabet_size=int(z["alphabet_size"]),
            max_pat_len=int(z["max_pat_len"]),
            patterns=patterns,
            nocase=bool(z["nocase"]) if "nocase" in z.files else False,
        )


class AhoCorasick:
    """Aho-Corasick automaton builder.

    Usage mirrors the reference API surface (acsmx.h:96-196):
    ``add_pattern`` then ``compile()`` -> :class:`DfaTable`.
    """

    def __init__(self, alphabet_size: int = ALPHABET_BYTE, nocase: bool = False):
        """``nocase=True`` (byte alphabet only) makes matching ASCII
        case-insensitive at ZERO runtime cost: patterns are case-folded at
        insert and the dense table's uppercase columns alias the lowercase
        ones. (The reference carries a nocase flag whose xlatcase table is
        disabled, acsmx.c:240-275 — this is that feature, working.)"""
        if alphabet_size < 2:
            raise ValueError("alphabet_size must be >= 2")
        if nocase and alphabet_size != ALPHABET_BYTE:
            raise ValueError("nocase requires the byte alphabet")
        self.alphabet_size = alphabet_size
        self.nocase = nocase
        self.patterns: list[Pattern] = []

    def add_pattern(
        self,
        pattern: bytes | Sequence[int],
        iid: int | None = None,
        label: str = "",
    ) -> Pattern:
        """Add one pattern (reference acsm_add_pattern, acsmx.c:514-546).

        ``pattern`` is raw bytes for the byte alphabet or a sequence of ints
        for wider alphabets. ``iid`` defaults to the insertion index.
        """
        symbols = tuple(int(x) for x in pattern)
        if self.nocase:
            symbols = tuple(
                c + 32 if 65 <= c <= 90 else c for c in symbols
            )
        if not symbols:
            raise ValueError("empty pattern")
        for s in symbols:
            if not (0 <= s < self.alphabet_size):
                raise ValueError(
                    f"symbol {s} out of range for alphabet {self.alphabet_size}"
                )
        index = len(self.patterns)
        if not label:
            if all(s < 256 for s in symbols):
                label = repr(bytes(symbols))[2:-1]
            else:
                label = ",".join(str(s) for s in symbols)
        p = Pattern(
            symbols=symbols,
            iid=index if iid is None else int(iid),
            index=index,
            label=label,
        )
        self.patterns.append(p)
        return p

    def add_patterns(self, patterns: Iterable[bytes | Sequence[int]]) -> None:
        for p in patterns:
            self.add_pattern(p)

    def compile(self) -> DfaTable:
        """Trie insert -> BFS failure links -> dense DFA closure.

        Equivalent construction to acsm_compile (acsmx.c:552-594) +
        acsm_gen_state_table (acsmx.c:600-658), but the dense closure is
        vectorized per BFS level with NumPy instead of a per-state scalar
        loop, and the output is the compact signed-table encoding described
        in the module docstring.
        """
        if not self.patterns:
            raise ValueError("no patterns added")
        import time as _time

        from ..utils.debug import dprint

        _t0 = _time.perf_counter()

        def _stage(name: str) -> None:
            nonlocal _t0
            t = _time.perf_counter()
            dprint(2, "dfa build: %-12s %.1fs", name, t - _t0)
            _t0 = t

        A = self.alphabet_size

        # --- trie, level-vectorized ----------------------------------------
        # Distinct prefixes of length d+1 are exactly the distinct
        # (node-at-depth-d, symbol) pairs of patterns longer than d, so one
        # np.unique per depth assigns the next level's node ids — no
        # per-symbol Python dict walk (38 of 46 build seconds at 100k
        # patterns were the dict trie + edge re-collection loops).
        N = len(self.patterns)
        lens = np.asarray([p.n for p in self.patterns], dtype=np.int64)
        L = int(lens.max())
        arr = np.zeros((N, L), dtype=np.int64)
        for i, p in enumerate(self.patterns):
            arr[i, : p.n] = p.symbols
        cur = np.zeros(N, dtype=np.int64)  # node of each pattern's prefix
        ends = np.zeros(N, dtype=np.int64)  # node where each pattern ends
        levels: list[tuple[np.ndarray, np.ndarray, np.ndarray]] = []
        next_id = 1
        for d in range(L):
            act = lens > d
            keys = cur[act] * A + arr[act, d]
            uniq, inv = np.unique(keys, return_inverse=True)
            cur[act] = next_id + inv
            levels.append(
                (uniq // A, uniq % A,
                 next_id + np.arange(len(uniq), dtype=np.int64))
            )
            next_id += len(uniq)
            done = act & (lens == d + 1)
            ends[done] = cur[done]
        S = next_id
        fail = np.zeros(S, dtype=np.int64)
        _stage("trie")

        # --- level-synchronous fail links + dense closure ------------------
        # Per BFS level: (a) fail links from one vectorized gather,
        # fail[t] = goto[fail[s], c] — the closured row of fail[s] (depth
        # <= d-1, final) already resolves the whole fail chain; for
        # depth-1 edges this reads the root row BEFORE its overlay in (b),
        # correctly yielding fail = 0. (b) overlay the parents' rows with
        # this level's trie edges. (c) base rows for this level from their
        # (now-final) fail rows — fail[dst] has depth <= d, never a
        # level-mate, so there is no intra-level dependency. Identical
        # result to the reference's convert_NFA_to_DFA (acsmx.c:444-486).
        goto = np.zeros((S, A), dtype=np.int32)
        _stage("alloc")
        for src, sym, dst in levels:
            fail[dst] = goto[fail[src], sym]
            goto[src, sym] = dst
            # np.take(mode="clip") hits NumPy's fast contiguous-row memcpy
            # path; the default bounds-checked row gather is ~100x slower
            # (121 us/row measured at 3M states). Indices are fail links,
            # always < this level's ids, so clip never actually clips.
            # dst is next_id + arange (contiguous), so goto[dst[0]:...] is
            # a writable view — no temp + second copy.
            np.take(
                goto, fail[dst], axis=0, mode="clip",
                out=goto[dst[0] : dst[0] + len(dst)],
            )
        _stage("closure")

        # --- match sets + groups (vectorized) -------------------------------
        # A state's match set is own(s) ∪ set(nearest fail-chain ancestor
        # with a match); the own sets are disjoint across states (a pattern
        # index ends at exactly one state), so set union is concatenation
        # and sizes add. Everything propagates down levels in one gather
        # per depth (fail[dst] is always shallower, hence already final) —
        # no per-state Python loop (that loop was 11 of 20 build seconds
        # at 300k patterns).
        has = np.zeros(S, dtype=bool)
        has[ends] = True
        for _src, _sym, dst in levels:
            has[dst] |= has[fail[dst]]
        # mnear[s]: s if it has a match set, else its nearest fail-chain
        # ancestor that does (-1 if none).
        mnear = np.full(S, -1, dtype=np.int64)
        for _src, _sym, dst in levels:
            mnear[dst] = np.where(has[dst], dst, mnear[fail[dst]])
        # own pid lists, grouped by end state, ascending pid within state
        own_cnt = np.bincount(ends, minlength=S).astype(np.int64)
        own_pid = np.argsort(ends, kind="stable").astype(np.int64)
        own_start = np.zeros(S, dtype=np.int64)
        np.cumsum(own_cnt[:-1], out=own_start[1:])
        # total set size per state: own + inherited (inherited source is
        # shallower, so its total is final when this level reads it)
        total = own_cnt.copy()
        for _src, _sym, dst in levels:
            m = mnear[fail[dst]]
            total[dst] += np.where(m >= 0, total[m], 0)
        _stage("matchsets")

        final = np.flatnonzero(has)
        G = len(final)
        state_gid = np.full(S, -1, dtype=np.int32)
        state_gid[final] = np.arange(G, dtype=np.int32)
        group_state = final.astype(np.int32)
        off = np.zeros(G + 1, dtype=np.int64)
        np.cumsum(total[final], out=off[1:])
        group_pids = np.empty(off[-1], dtype=np.int32)

        def _ragged_copy(dbase: np.ndarray, cnt: np.ndarray, sbase: np.ndarray,
                         src: np.ndarray) -> None:
            # group_pids[dbase[j] + r] = src[sbase[j] + r] for r < cnt[j]
            tot = int(cnt.sum())
            if not tot:
                return
            ra = np.arange(tot, dtype=np.int64) - np.repeat(
                np.cumsum(cnt) - cnt, cnt
            )
            group_pids[np.repeat(dbase, cnt) + ra] = src[
                np.repeat(sbase, cnt) + ra
            ]

        # fill per level: own pids, then a block copy of the inherited
        # state's (already materialized, shallower) full segment
        for _src, _sym, dst in levels:
            s = dst[has[dst]]
            if not len(s):
                continue
            base = off[state_gid[s].astype(np.int64)]
            oc = own_cnt[s]
            _ragged_copy(base, oc, own_start[s], own_pid)
            m = mnear[fail[s]]
            ic = np.where(m >= 0, total[m], 0)
            # where m is -1, ic is 0 and the placeholder index is unused
            sbase = off[state_gid[m].astype(np.int64)]
            _ragged_copy(base + oc, ic, sbase, group_pids)
        # sort each group's pid list ascending (one global segment sort);
        # group_rep is then the segment head (the smallest index — the
        # deterministic representative)
        seg = np.repeat(np.arange(G, dtype=np.int64), total[final])
        group_pids = group_pids[np.lexsort((group_pids, seg))]
        group_offsets = off.astype(np.int32)
        group_rep = group_pids[group_offsets[:-1]].astype(np.int32)
        _stage("groups")

        # --- case folding: uppercase columns alias lowercase ----------------
        if self.nocase:
            goto[:, 65:91] = goto[:, 97:123]

        # --- signed encoding (in place, row-blocked to bound temporaries) ---
        is_final = state_gid >= 0
        for i0 in range(0, S, 65536):
            blk = goto[i0 : i0 + 65536]
            np.negative(blk, where=is_final[blk], out=blk)
        goto_signed = goto if S >= 2**15 else goto.astype(np.int16)
        _stage("signed")

        return DfaTable(
            goto_signed=goto_signed,
            state_gid=state_gid,
            group_state=group_state,
            group_offsets=group_offsets,
            group_pids=group_pids,
            group_rep=group_rep,
            alphabet_size=A,
            max_pat_len=max(p.n for p in self.patterns),
            patterns=list(self.patterns),
            nocase=self.nocase,
        )


def compile_patterns(
    patterns: Iterable[bytes | Sequence[int]],
    alphabet_size: int = ALPHABET_BYTE,
) -> DfaTable:
    """Convenience: build and compile in one call."""
    ac = AhoCorasick(alphabet_size)
    ac.add_patterns(patterns)
    return ac.compile()
