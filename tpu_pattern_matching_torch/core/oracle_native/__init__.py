"""ctypes wrapper for the C++ conformance oracle (copy of the reference's
``core/oracle_native``).

``csrc/oracle.cpp`` is built with g++ into the package's ``_build/`` on
first use, by the kernel loader (``ops/kernels.py``). Falls back cleanly:
callers should catch ``OracleUnavailable`` and use the pure-Python oracle
instead.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import numpy as np


class OracleUnavailable(RuntimeError):
    pass


def _bind(lib) -> None:
    lib.oracle_create.restype = ctypes.c_void_p
    lib.oracle_create.argtypes = [
        ctypes.c_void_p,
        ctypes.c_void_p,
        ctypes.c_void_p,
        ctypes.c_int32,
        ctypes.c_int32,
    ]
    lib.oracle_free.argtypes = [ctypes.c_void_p]
    lib.oracle_match.restype = ctypes.c_int64
    lib.oracle_match.argtypes = [
        ctypes.c_void_p,
        ctypes.c_void_p,
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.c_void_p,
        ctypes.c_void_p,
        ctypes.c_void_p,
        ctypes.c_int64,
    ]
    lib.oracle_match_bytes.restype = ctypes.c_int64
    lib.oracle_match_bytes.argtypes = list(lib.oracle_match.argtypes)
    lib.oracle_match_windows.restype = ctypes.c_int64
    lib.oracle_match_windows.argtypes = [
        ctypes.c_void_p,  # handle
        ctypes.c_void_p,  # data
        ctypes.c_int64,  # lane_stride
        ctypes.c_void_p,  # xlat (or None)
        ctypes.c_void_p,  # lanes
        ctypes.c_void_p,  # w0s
        ctypes.c_void_p,  # w1s
        ctypes.c_void_p,  # keep_los
        ctypes.c_void_p,  # keep_his
        ctypes.c_int64,  # n_windows
        ctypes.c_void_p,  # out_lane
        ctypes.c_void_p,  # out_end
        ctypes.c_void_p,  # out_pid
        ctypes.c_int64,  # cap
    ]
    lib.dense_match_windows.restype = ctypes.c_int64
    lib.dense_match_windows.argtypes = [
        ctypes.c_void_p,  # table
        ctypes.c_int32,  # alphabet
        ctypes.c_void_p,  # data
        ctypes.c_int64,  # lane_stride (elements)
        ctypes.c_int32,  # sym_bytes
    ] + lib.oracle_match_windows.argtypes[4:]
    lib.unpack_bitmap.restype = ctypes.c_int64
    lib.unpack_bitmap.argtypes = [
        ctypes.c_void_p,  # bits
        ctypes.c_int64,  # n_words_rows
        ctypes.c_int64,  # n_cols
        ctypes.c_int64,  # stride
        ctypes.c_void_p,  # out_rows
        ctypes.c_void_p,  # out_lanes
        ctypes.c_int64,  # cap
    ]


def _lib():
    from tpu_pattern_matching_torch.ops import kernels

    try:
        return kernels.native_library("liboracle.so", _bind)
    except (RuntimeError, OSError) as e:
        raise OracleUnavailable(f"cannot build native oracle: {e}") from e


def unpack_bitmap(
    bits: np.ndarray, stride: int, total_hint: int = 0
) -> tuple[np.ndarray, np.ndarray]:
    """(rows, lanes) of set bits in the survivor bitmap, (lane, row)
    ordered — the native decode-path expansion (one ctz per set bit)."""
    lib = _lib()
    bits = np.ascontiguousarray(bits)
    W, C = bits.shape
    cap = max(int(total_hint), 4096)
    while True:
        out_rows = np.empty(cap, np.int64)
        out_lanes = np.empty(cap, np.int64)
        n = lib.unpack_bitmap(
            bits.ctypes.data_as(ctypes.c_void_p),
            W,
            C,
            stride,
            out_rows.ctypes.data_as(ctypes.c_void_p),
            out_lanes.ctypes.data_as(ctypes.c_void_p),
            cap,
        )
        if n <= cap:
            return out_rows[:n], out_lanes[:n]
        cap = int(n)


def dense_match_windows(
    table: np.ndarray,  # [S * alphabet] int32 signed dense table
    alphabet: int,
    data: np.ndarray,  # [n_lanes, lane_stride] uint8/uint16/int32 symbols
    lanes: np.ndarray,
    w0s: np.ndarray,
    w1s: np.ndarray,
    keep_los: np.ndarray,
    keep_his: np.ndarray,
    cap: int | None = None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Batched dense-table window verification (bloom engine hot path).

    Returns (lanes int32[n], ends int64[n], states int32[n]) — states are
    the signed-table FINAL states; resolve pattern sets via state_gid."""
    lib = _lib()
    table = np.ascontiguousarray(table, np.int32)
    if data.dtype not in (np.uint8, np.uint16, np.int32):
        data = np.ascontiguousarray(data, np.int32)
    data = np.ascontiguousarray(data)
    n = len(lanes)
    lanes = np.ascontiguousarray(lanes, np.int32)
    w0s = np.ascontiguousarray(w0s, np.int64)
    w1s = np.ascontiguousarray(w1s, np.int64)
    keep_los = np.ascontiguousarray(keep_los, np.int64)
    keep_his = np.ascontiguousarray(keep_his, np.int64)
    if cap is None:
        cap = max(4096, 4 * n)
    while True:
        out_lane = np.zeros(cap, np.int32)
        out_end = np.zeros(cap, np.int64)
        out_state = np.zeros(cap, np.int32)
        total = lib.dense_match_windows(
            table.ctypes.data_as(ctypes.c_void_p),
            alphabet,
            data.ctypes.data_as(ctypes.c_void_p),
            data.shape[1],
            data.dtype.itemsize,
            lanes.ctypes.data_as(ctypes.c_void_p),
            w0s.ctypes.data_as(ctypes.c_void_p),
            w1s.ctypes.data_as(ctypes.c_void_p),
            keep_los.ctypes.data_as(ctypes.c_void_p),
            keep_his.ctypes.data_as(ctypes.c_void_p),
            n,
            out_lane.ctypes.data_as(ctypes.c_void_p),
            out_end.ctypes.data_as(ctypes.c_void_p),
            out_state.ctypes.data_as(ctypes.c_void_p),
            cap,
        )
        if total < 0:
            raise ValueError(f"unsupported symbol width {data.dtype}")
        if total <= cap:
            return out_lane[:total], out_end[:total], out_state[:total]
        cap = int(total)


class NativeOracle:
    """Streaming C++ Aho-Corasick oracle."""

    def __init__(
        self, patterns: Sequence[bytes | Sequence[int]], alphabet: int = 256
    ):
        lib = _lib()
        pats = [np.asarray(list(p), np.int32) for p in patterns]
        lens = np.asarray([len(p) for p in pats], np.int32)
        starts = np.zeros(len(pats), np.int64)
        if len(pats) > 1:
            starts[1:] = np.cumsum(lens[:-1])
        symbols = (
            np.concatenate(pats) if pats else np.zeros(0, np.int32)
        ).astype(np.int32)
        self._lib = lib
        self._h = lib.oracle_create(
            symbols.ctypes.data_as(ctypes.c_void_p),
            starts.ctypes.data_as(ctypes.c_void_p),
            lens.ctypes.data_as(ctypes.c_void_p),
            len(pats),
            alphabet,
        )
        self._state = ctypes.c_int32(0)

    def __del__(self):
        try:
            if getattr(self, "_h", None):
                self._lib.oracle_free(self._h)
        except Exception:
            pass

    def reset(self) -> None:
        self._state = ctypes.c_int32(0)

    def match(
        self,
        data: bytes | np.ndarray,
        offset_base: int = 0,
        cap: int | None = None,
    ) -> tuple[np.ndarray, np.ndarray, int]:
        """Scan ``data`` continuing from the current stream state.

        Returns (end_offsets int64[n], pattern_indices int32[n], total).
        ``total`` may exceed len(end_offsets) if ``cap`` was hit.
        """
        if isinstance(data, (bytes, bytearray, memoryview)):
            arr = np.frombuffer(bytes(data), np.uint8)
            fn = self._lib.oracle_match_bytes
        else:
            arr = np.ascontiguousarray(data, np.int32)
            fn = self._lib.oracle_match
        if cap is None:
            cap = max(1024, 4 * len(arr))
        out_off = np.zeros(cap, np.int64)
        out_pid = np.zeros(cap, np.int32)
        total = fn(
            self._h,
            arr.ctypes.data_as(ctypes.c_void_p),
            len(arr),
            offset_base,
            ctypes.byref(self._state),
            out_off.ctypes.data_as(ctypes.c_void_p),
            out_pid.ctypes.data_as(ctypes.c_void_p),
            cap,
        )
        n = min(total, cap)
        return out_off[:n], out_pid[:n], int(total)

    def match_events(self, data) -> list[tuple[int, int]]:
        off, pid, total = self.match(data)
        if total > len(off):
            raise RuntimeError("oracle capacity exceeded")
        return sorted(zip(off.tolist(), pid.tolist()))

    def match_windows(
        self,
        data: np.ndarray,  # [n_lanes, lane_stride] uint8, C-contiguous
        lanes: np.ndarray,  # [W] int32
        w0s: np.ndarray,  # [W] int64 window starts (row index)
        w1s: np.ndarray,  # [W] int64 window ends (exclusive)
        keep_los: np.ndarray,  # [W] int64: report ends >= this
        keep_his: np.ndarray,  # [W] int64: report ends < this
        xlat: np.ndarray | None = None,  # [256] uint8 symbol translation
        cap: int | None = None,
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Verify many windows in one native call (bloom engine hot path).

        Returns (lanes int32[n], ends int64[n], pids int32[n]); windows are
        scanned from the root state (no cross-window continuity)."""
        data = np.ascontiguousarray(data, np.uint8)
        n = len(lanes)
        lanes = np.ascontiguousarray(lanes, np.int32)
        w0s = np.ascontiguousarray(w0s, np.int64)
        w1s = np.ascontiguousarray(w1s, np.int64)
        keep_los = np.ascontiguousarray(keep_los, np.int64)
        keep_his = np.ascontiguousarray(keep_his, np.int64)
        if xlat is not None:
            xlat = np.ascontiguousarray(xlat, np.uint8)
        if cap is None:
            cap = max(4096, 4 * n)
        while True:
            out_lane = np.zeros(cap, np.int32)
            out_end = np.zeros(cap, np.int64)
            out_pid = np.zeros(cap, np.int32)
            total = self._lib.oracle_match_windows(
                self._h,
                data.ctypes.data_as(ctypes.c_void_p),
                data.shape[1],
                None if xlat is None else xlat.ctypes.data_as(
                    ctypes.c_void_p
                ),
                lanes.ctypes.data_as(ctypes.c_void_p),
                w0s.ctypes.data_as(ctypes.c_void_p),
                w1s.ctypes.data_as(ctypes.c_void_p),
                keep_los.ctypes.data_as(ctypes.c_void_p),
                keep_his.ctypes.data_as(ctypes.c_void_p),
                n,
                out_lane.ctypes.data_as(ctypes.c_void_p),
                out_end.ctypes.data_as(ctypes.c_void_p),
                out_pid.ctypes.data_as(ctypes.c_void_p),
                cap,
            )
            if total <= cap:
                return out_lane[:total], out_end[:total], out_pid[:total]
            cap = int(total)
