"""ctypes wrapper for the native batch stager (copy of the reference's
``runtime/stager_native``).

``csrc/stager.cpp`` is built with g++ into the package's ``_build/`` on
demand, by the kernel loader (``ops/kernels.py``). Callers fall back to
the NumPy path when the build or the preconditions (real fd, H <= B)
don't hold.
"""

from __future__ import annotations

import ctypes

import numpy as np


class StagerUnavailable(RuntimeError):
    pass


def _bind(lib) -> None:
    lib.stage_stream.restype = ctypes.c_int64
    lib.stage_stream.argtypes = [
        ctypes.c_int32,  # fd
        ctypes.c_int64,  # file_offset
        ctypes.c_void_p,  # tail
        ctypes.c_int32,  # tail_len
        ctypes.c_void_p,  # data
        ctypes.c_void_p,  # start_t
        ctypes.c_void_p,  # end_t
        ctypes.c_void_p,  # file_ids
        ctypes.c_void_p,  # base_off
        ctypes.c_int32,  # file_id
        ctypes.c_int32,  # chunks0
        ctypes.c_int32,  # max_chunks
        ctypes.c_int32,  # B
        ctypes.c_int32,  # H
        ctypes.c_void_p,  # tail_out
        ctypes.c_void_p,  # tail_out_len
        ctypes.c_void_p,  # chunks_out
    ]


def _lib():
    from tpu_pattern_matching_torch.ops import kernels

    try:
        return kernels.native_library("libstager.so", _bind)
    except (RuntimeError, OSError) as e:
        raise StagerUnavailable(f"cannot build native stager: {e}") from e


def available() -> bool:
    try:
        _lib()
        return True
    except StagerUnavailable:
        return False


def stage_stream(
    fd: int,
    file_offset: int,
    tail: bytes,
    data: np.ndarray,
    start_t: np.ndarray,
    end_t: np.ndarray,
    file_ids: np.ndarray,
    base_off: np.ndarray,
    file_id: int,
    chunks0: int,
    B: int,
    H: int,
) -> tuple[int, int, bytes]:
    """Fill lanes from fd. Returns (bytes_read, new_chunks, new_tail)."""
    lib = _lib()
    tail_buf = np.frombuffer(tail, np.uint8) if tail else np.zeros(0, np.uint8)
    tail_out = np.zeros(max(H, 1), np.uint8)
    tail_out_len = ctypes.c_int32(0)
    chunks_out = ctypes.c_int32(chunks0)
    got = lib.stage_stream(
        fd,
        file_offset,
        tail_buf.ctypes.data_as(ctypes.c_void_p) if len(tail_buf) else None,
        len(tail_buf),
        data.ctypes.data_as(ctypes.c_void_p),
        start_t.ctypes.data_as(ctypes.c_void_p),
        end_t.ctypes.data_as(ctypes.c_void_p),
        file_ids.ctypes.data_as(ctypes.c_void_p),
        base_off.ctypes.data_as(ctypes.c_void_p),
        file_id,
        chunks0,
        data.shape[0],
        B,
        H,
        tail_out.ctypes.data_as(ctypes.c_void_p),
        ctypes.byref(tail_out_len),
        ctypes.byref(chunks_out),
    )
    if got < 0:
        raise OSError("stage_stream read error")
    return int(got), int(chunks_out.value), bytes(tail_out[: tail_out_len.value])
