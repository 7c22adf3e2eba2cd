"""Streaming buffer manager.

TPU-native counterpart of the reference's databuf layer (databuf.c): turns
byte streams into fixed-shape batches the jitted scan consumes — static
shapes are what keeps everything compiled once.

Shape contract (see ops.match_xla): a batch is ``[C, halo + B]`` uint8 with
per-lane ``start_t``/``end_t`` masks, file ids, and 64-bit base offsets.
Each lane's first ``halo`` bytes are stream history (the cross-chunk /
cross-batch match-continuity mechanism replacing ahomatch.cl:42-45 last_state
carry and ahomatch.cl:96-158 overlap continuation).

Ingest paths mirror databuf.c:
- ``add_stream``   <- databuf_add_fd (databuf.c:326-407): raw reads split into
  contiguous B-byte chunks; the tail chunk may be short (masked, not just
  zero-padded — the reference's zero padding can false-match patterns that
  contain 0x00 bytes; masking can't).
- ``add_lines``    <- databuf_add_fp (databuf.c:412-481): line-wise chunks,
  one line (or line fragment, for lines longer than B) per lane; fragments
  are halo-linked so matches spanning fragment boundaries are found (the
  reference loses some of those — "ATTENTION" caveat ahomatch.cl:151-155).
- ``add_chunk``    <- databuf_add_chunk (databuf.c:487-528).

Return codes follow databuf.h:91-94: positive = room left, -1 = chunk-full,
-2 = byte-full (here equivalent to chunk-full; kept for API parity).
"""

from __future__ import annotations

import dataclasses
import io
import os
import re
import time
from typing import BinaryIO

import numpy as np

from tpu_pattern_matching_torch.runtime.tracing import RECORDER

_clock = time.perf_counter_ns

_STAGER_OK: bool | None = None


def _native_stager_ok() -> bool:
    """Native preadv stager availability (cached; TPM_NO_NATIVE_STAGER=1
    forces the NumPy path, e.g. to exercise both in tests)."""
    global _STAGER_OK
    if os.environ.get("TPM_NO_NATIVE_STAGER"):
        return False
    if _STAGER_OK is None:
        try:
            from tpu_pattern_matching_torch.runtime import stager_native

            _STAGER_OK = stager_native.available()
        except Exception:
            _STAGER_OK = False
    return _STAGER_OK


@dataclasses.dataclass
class StreamState:
    """Continuity state for one input stream (file/FIFO/socket).

    ``tail`` holds the last ``halo`` bytes previously consumed so the next
    chunk can warm the DFA through its prefix; ``offset`` is the absolute
    stream offset of the next byte.
    """

    file_id: int
    offset: int = 0
    tail: bytes = b""
    line_no: int = 0
    in_fragment: bool = False  # previous text line piece had no newline
    # raw TEXT read position for token-parsing streams (UshortBuffer):
    # ``offset`` advances in TOKEN units there, so follow-mode revisits must
    # seek this field instead (-1 = byte stream; offset IS the position)
    text_off: int = -1


@dataclasses.dataclass
class HostBatch:
    """One assembled batch, ready for device upload."""

    data: np.ndarray  # [C, halo+B] uint8
    start_t: np.ndarray  # [C] int32
    end_t: np.ndarray  # [C] int32
    file_ids: np.ndarray  # [C] int32
    base_off: np.ndarray  # [C] int64
    chunks: int
    halo: int
    seq: int = -1  # batch id (tracing.Recorder.next_seq), set at hand-off

    @property
    def payload_bytes(self) -> int:
        return int(np.sum(self.end_t.astype(np.int64)) - self.chunks * self.halo)

    @property
    def symbols(self) -> int:
        """The live lanes' own symbols (bytes or tokens; halos left out).
        ``payload_bytes`` sums every lane's ``end_t``, so a batch with
        free lanes adds their halos too."""
        n = self.chunks
        return int(self.end_t[:n].sum(dtype=np.int64)) - n * self.halo


class DataBuffer:
    dtype = np.uint8  # symbol width (UshortBuffer overrides)
    follow = False  # set by the feeder in -F mode (token buffers hold a
    # partial trailing number across quiescence instead of flushing it)

    def __init__(self, max_chunks: int, chunk_len: int, halo: int):
        if halo < 0 or chunk_len <= 0 or max_chunks <= 0:
            raise ValueError("bad buffer geometry")
        self.max_chunks = max_chunks
        self.chunk_len = chunk_len
        self.halo = halo
        self._alloc()

    def _alloc(self) -> None:
        # the counter ``feed.allocs`` makes the databuf contract checkable:
        # a streaming scan allocates a fixed buffer set up front and reuses
        # it via reset() however long the stream (databuf.c:76-320)
        RECORDER.add("feed.allocs")
        C, B, H = self.max_chunks, self.chunk_len, self.halo
        self.data = np.zeros((C, H + B), self.dtype)
        self.start_t = np.full(C, H, np.int32)
        self.end_t = np.full(C, H, np.int32)
        self.file_ids = np.full(C, -1, np.int32)
        self.base_off = np.zeros(C, np.int64)
        self.chunks = 0
        self.bytes = 0

    # ------------------------------------------------------------------ API

    def reset(self) -> None:
        """Reuse the buffer for the next batch (databuf_reset).

        Data rows are NOT cleared: stale bytes beyond a lane's
        ``[start_t, end_t)`` window are masked by the scan, so zeroing
        them is pure memset cost (the reference zero-pads instead and
        pays for it with false-match potential, databuf.c:365-370).
        """
        H = self.halo
        if self.chunks:
            self.start_t[: self.chunks] = H
            self.end_t[: self.chunks] = H
            self.file_ids[: self.chunks] = -1
            self.base_off[: self.chunks] = 0
        self.chunks = 0
        self.bytes = 0

    @property
    def full(self) -> bool:
        return self.chunks >= self.max_chunks

    def _push(self, payload: bytes, stream: StreamState) -> None:
        """Insert one lane: history halo + payload, advance the stream."""
        H, B = self.halo, self.chunk_len
        i = self.chunks
        hist = stream.tail[-H:] if H else b""
        hl = len(hist)
        if hl:
            self.data[i, H - hl : H] = np.frombuffer(hist, np.uint8)
        n = len(payload)
        self.data[i, H : H + n] = np.frombuffer(payload, np.uint8)
        self.start_t[i] = H - hl
        self.end_t[i] = H + n
        self.file_ids[i] = stream.file_id
        self.base_off[i] = stream.offset
        self.chunks += 1
        self.bytes += n
        stream.offset += n
        if H:
            stream.tail = (stream.tail + payload)[-H:]

    def add_stream(self, fobj: BinaryIO, stream: StreamState) -> tuple[int, int]:
        """Binary ingest (databuf_add_fd): fill free lanes with B-byte chunks.

        Returns (code, bytes_read): code > 0 = room remains and stream hit
        EOF for now; -1 = buffer chunk-full; bytes_read = 0 signals EOF.

        Bulk-reads all free lanes at once and assembles them with vectorized
        NumPy slicing (one reshape for payloads, one strided view for the
        intra-read halos) — the per-chunk Python loop caps a feeder thread
        near 0.5 GB/s, an order of magnitude below the device scan rate.
        """
        H, B = self.halo, self.chunk_len
        # native fast path: preadv straight into the batch (no intermediate
        # bytes object) when reading a real file descriptor
        if H <= B and _native_stager_ok():
            try:
                fdno = fobj.fileno()
                pos = fobj.tell()  # FIFOs/pipes raise: not seekable
            except (OSError, ValueError, AttributeError, io.UnsupportedOperation):
                fdno = None
            if fdno is not None:
                from tpu_pattern_matching_torch.runtime import stager_native

                chunks0 = self.chunks
                t0 = _clock()
                got, new_chunks, new_tail = stager_native.stage_stream(
                    fdno,
                    pos,
                    stream.tail[-H:] if H else b"",
                    self.data,
                    self.start_t,
                    self.end_t,
                    self.file_ids,
                    self.base_off,
                    stream.file_id,
                    chunks0,
                    B,
                    H,
                )
                if got:
                    fobj.seek(pos + got)
                    # base_off is read-position-relative in C; rebase to
                    # stream-absolute (differs only if the stream didn't
                    # start at file offset 0)
                    self.base_off[chunks0:new_chunks] += stream.offset - pos
                    self.bytes += got
                    self.chunks = new_chunks
                    stream.offset += got
                    if H:
                        stream.tail = new_tail
                # the native read lands in the batch: no pack of its own
                RECORDER.charge(work=got, read=_clock() - t0)
                code = (
                    -1
                    if self.chunks >= self.max_chunks
                    else (self.max_chunks - self.chunks)
                )
                return code, got

        free = self.max_chunks - self.chunks
        t0 = _clock()
        payload = fobj.read(free * B)
        t1 = _clock()
        m = len(payload)
        if m == 0:
            RECORDER.charge(read=t1 - t0)
            return free, 0
        if H > B:
            # halos span multiple preceding chunks: per-chunk slow path
            for k in range(0, m, B):
                self._push(payload[k : k + B], stream)
            RECORDER.charge(work=m, read=t1 - t0, pack=_clock() - t1)
            code = (
                -1
                if self.chunks >= self.max_chunks
                else (self.max_chunks - self.chunks)
            )
            return code, m
        arr = np.frombuffer(payload, np.uint8)
        full = m // B
        i0 = self.chunks
        if full:
            self.data[i0 : i0 + full, H : H + B] = arr[: full * B].reshape(
                full, B
            )
            if H:
                # halo of lane i0: stream history; lanes i0+1..: the
                # preceding H bytes within this same read
                hist = stream.tail[-H:]
                hl = len(hist)
                if hl:
                    self.data[i0, H - hl : H] = np.frombuffer(hist, np.uint8)
                self.start_t[i0] = H - hl
                if full > 1:
                    halos = arr[B - H : full * B - H].reshape(full - 1, B)[:, :H]
                    self.data[i0 + 1 : i0 + full, 0:H] = halos
                    self.start_t[i0 + 1 : i0 + full] = 0
            else:
                self.start_t[i0 : i0 + full] = H
            self.end_t[i0 : i0 + full] = H + B
            self.file_ids[i0 : i0 + full] = stream.file_id
            self.base_off[i0 : i0 + full] = stream.offset + np.arange(
                full, dtype=np.int64
            ) * B
            self.chunks += full
            self.bytes += full * B
            stream.offset += full * B
            if H:  # B >= H here, so the tail lies inside this read
                stream.tail = payload[full * B - H : full * B]
        tail = payload[full * B :]
        if tail:  # short EOF tail chunk (masked, not zero-scanned)
            self._push(tail, stream)
        RECORDER.charge(work=m, read=t1 - t0, pack=_clock() - t1)
        code = (
            -1
            if self.chunks >= self.max_chunks
            else (self.max_chunks - self.chunks)
        )
        return code, m

    def add_lines(self, fobj: BinaryIO, stream: StreamState) -> tuple[int, int, int]:
        """Text ingest (databuf_add_fp): one line (piece) per lane.

        Lines are independent streams — no halo between different lines —
        but pieces of one long line stay halo-linked. Returns
        (code, bytes_read, lines_read).
        """
        rd = 0
        lines = 0
        while self.chunks < self.max_chunks:
            piece = fobj.readline(self.chunk_len)
            if not piece:
                break
            ended = piece.endswith(b"\n")
            if not stream.in_fragment:
                # a fresh line: independent — reset continuity
                stream.tail = b""
                stream.offset = stream.offset  # absolute offsets keep flowing
            self._push(piece, stream)
            rd += len(piece)
            if ended:
                lines += 1
                stream.line_no += 1
                stream.in_fragment = False
            else:
                stream.in_fragment = True
        # lines are read and packed one by one: the visit's bytes, no split
        RECORDER.charge(work=rd)
        code = -1 if self.chunks >= self.max_chunks else (self.max_chunks - self.chunks)
        return code, rd, lines

    def add_chunk(
        self, chunk: bytes, stream: StreamState
    ) -> int:
        """Single-chunk insert (databuf_add_chunk). Returns databuf codes."""
        if len(chunk) > self.chunk_len:
            return -3
        if self.chunks >= self.max_chunks:
            return -1
        self._push(chunk, stream)
        return -1 if self.chunks >= self.max_chunks else (self.max_chunks - self.chunks)

    def finalize_stream(self, stream: StreamState) -> None:
        """End-of-stream hook: byte buffers hold nothing back (no-op);
        token buffers flush a held partial trailing number (see
        UshortBuffer.finalize_stream)."""

    def to_batch(self) -> HostBatch:
        return HostBatch(
            data=self.data,
            start_t=self.start_t,
            end_t=self.end_t,
            file_ids=self.file_ids,
            base_off=self.base_off,
            chunks=self.chunks,
            halo=self.halo,
        )


# ------------------------------------------------------- ushort (AC_ushorts)


def _parse_digit_runs(buf: bytes, clamp: int) -> np.ndarray:
    """All decimal runs of ``buf`` as uint16 tokens — fully vectorized.

    The reference parses tokens with per-line strtol loops in C
    (AC_ushorts/databuf.c:154-190); the round-2 Python version did regex
    findall + per-token int(), capping the token ingest path at Python
    rate (VERDICT r2 item 7). Here run boundaries come from one mask
    diff, and values from a per-run-length Horner evaluation in uint64 —
    whose wraparound is EXACT for the ``value & 0xFFFF`` semantics
    (2**16 divides 2**64), so arbitrarily long digit runs parse
    identically to arbitrary-precision int() & 0xFFFF.
    """
    a = np.frombuffer(buf, np.uint8)
    isd = (a >= 48) & (a <= 57)
    n_dig = int(isd.sum())
    if n_dig == 0:
        return np.zeros(0, np.uint16)
    d = np.diff(isd.astype(np.int8))
    starts = np.flatnonzero(d == 1) + 1
    ends = np.flatnonzero(d == -1) + 1
    if isd[0]:
        starts = np.concatenate([np.zeros(1, np.int64), starts])
    if isd[-1]:
        ends = np.concatenate([ends, np.asarray([len(a)], np.int64)])
    lens = ends - starts
    vals = np.zeros(len(starts), np.uint64)
    for L in np.unique(lens):
        sel = lens == L
        st = starts[sel]
        digits = (
            a[st[:, None] + np.arange(L, dtype=np.int64)[None, :]]
            .astype(np.uint64)
            - 48
        )
        # 10^k mod 2^64 wraps consistently with int(...) & 0xFFFF
        powers = np.asarray(
            [pow(10, int(k), 1 << 64) for k in range(int(L) - 1, -1, -1)],
            np.uint64,
        )
        with np.errstate(over="ignore"):
            vals[sel] = digits @ powers
    return np.minimum(vals & np.uint64(0xFFFF),
                      np.uint64(clamp)).astype(np.uint16)


def parse_token_stream(
    raw: bytes, rem: bytes, final: bool, clamp: int
) -> tuple[np.ndarray, bytes]:
    """Incrementally parse comma/semicolon/whitespace-separated ints.

    The streaming form of the reference's per-line strtok parse
    (AC_ushorts/databuf.c:154-190): a trailing digit run may be a partial
    number cut by the read boundary, so it is held back in ``rem`` until
    the next read (or emitted when ``final``). Values clamp to
    ``clamp`` (the reference indexes its table out of bounds for
    >= alphabet values — UB we don't reproduce).
    """
    buf = rem + raw
    if not final:
        k = len(buf)
        while k and 48 <= buf[k - 1] <= 57:
            k -= 1
        buf, rem = buf[:k], buf[k:]
    else:
        rem = b""
    if not buf:
        return np.zeros(0, np.uint16), rem
    return _parse_digit_runs(buf, clamp), rem


class UshortBuffer(DataBuffer):
    """uint16 metadata-token lanes — the AC_ushorts databuf role.

    Same HostBatch contract as DataBuffer, but symbols are packet-metadata
    tokens (payload lengths etc.) parsed incrementally from text flow
    files; ``add_stream`` keeps per-stream parse state (partial trailing
    number, surplus tokens) on the StreamState so large corpora stream in
    rounds instead of one slurp, and follow mode works on growing
    files/FIFOs (the reference's ushort driver has neither,
    AC_ushorts/ocl_aho_grep.c).
    """

    dtype = np.uint16
    clamp = 2047  # ALPHABET_USHORT - 1 (iacsmx.h:43)

    def _push_tokens(self, toks: np.ndarray, stream: StreamState) -> None:
        H = self.halo
        i = self.chunks
        hist = stream.tail[-H:] if H else np.zeros(0, np.uint16)
        hl = len(hist)
        if hl:
            self.data[i, H - hl : H] = hist
        n = len(toks)
        self.data[i, H : H + n] = toks
        self.start_t[i] = H - hl
        self.end_t[i] = H + n
        self.file_ids[i] = stream.file_id
        self.base_off[i] = stream.offset
        self.chunks += 1
        self.bytes += 2 * n
        stream.offset += n
        if H:
            stream.tail = np.concatenate([hist, toks])[-H:]

    def add_lines(self, fobj, stream):
        """Line mode has no ushort analogue (flow files are one token
        sequence; the reference ushort driver predates text mode) — raise
        rather than silently reinterpret raw bytes as tokens."""
        raise NotImplementedError(
            "text mode is not defined for the ushort alphabet; "
            "flow files stream through add_stream"
        )

    def finalize_stream(self, stream: StreamState) -> None:
        """Flush the held partial trailing number (follow mode holds it
        across quiescence — a number split by a writer pause must not be
        emitted as two tokens; at true shutdown whatever digits exist ARE
        the final token)."""
        if not isinstance(stream.tail, np.ndarray):
            return  # stream never produced tokens
        t0 = _clock()
        n = 0
        if stream.text_rem:
            toks, stream.text_rem = parse_token_stream(
                b"", stream.text_rem, final=True, clamp=self.clamp
            )
            n = len(toks)
            if n:
                stream.pending = np.concatenate([stream.pending, toks])
        t1 = _clock()
        while len(stream.pending) and self.chunks < self.max_chunks:
            take = stream.pending[: self.chunk_len]
            stream.pending = stream.pending[self.chunk_len :]
            self._push_tokens(take, stream)
        RECORDER.charge(work=n, parse=t1 - t0, pack=_clock() - t1)

    def add_stream(self, fobj: BinaryIO, stream: StreamState) -> tuple[int, int]:
        """Text-to-token ingest. Returns (code, raw_text_bytes_read)."""
        if not isinstance(stream.tail, np.ndarray):  # first visit: token mode
            stream.tail = np.zeros(0, np.uint16)
            stream.pending = np.zeros(0, np.uint16)
            stream.text_rem = b""
            stream.text_off = 0  # raw read position (offset counts TOKENS)
        B = self.chunk_len
        rd = 0
        # self-times of the reads, parses and lane packing, and the tokens
        # parsed, charged once to the enclosing span (``feed.file``)
        t_read = t_parse = t_pack = n_tok = 0
        while self.chunks < self.max_chunks:
            quiescent = False
            while len(stream.pending) < B and not quiescent:
                t0 = _clock()
                raw = fobj.read(max(4096, B * 8))
                t1 = _clock()
                rd += len(raw)
                stream.text_off += len(raw)
                # b"" is a true end of stream only for a seekable source
                # outside follow mode; from a FIFO reader or a followed
                # file it means "nothing available NOW" and more text may
                # extend a trailing digit run — hold the partial number
                # (finalize_stream flushes it at shutdown).
                at_end = (
                    raw == b""
                    and not self.follow
                    and getattr(fobj, "seekable", lambda: True)()
                )
                toks, stream.text_rem = parse_token_stream(
                    raw, stream.text_rem, final=at_end, clamp=self.clamp
                )
                t2 = _clock()
                if len(toks):
                    stream.pending = np.concatenate([stream.pending, toks])
                t_read += t1 - t0
                t_parse += t2 - t1
                t_pack += _clock() - t2
                n_tok += len(toks)
                quiescent = raw == b""
            if len(stream.pending) == 0:
                break
            t0 = _clock()
            take = stream.pending[:B]
            stream.pending = stream.pending[B:]
            self._push_tokens(take, stream)
            t_pack += _clock() - t0
            if quiescent and len(stream.pending) == 0:
                break
        RECORDER.charge(work=n_tok, read=t_read, parse=t_parse, pack=t_pack)
        code = (
            -1
            if self.chunks >= self.max_chunks
            else (self.max_chunks - self.chunks)
        )
        return code, rd
