"""ctypes wrapper for the native batch stager (copy of the reference's
``runtime/stager_native``) and the ushort feed's native token parse.

``csrc/stager.cpp`` is built with g++ into the package's ``_build/`` on
demand, by the kernel loader (``ops/kernels.py``). Callers fall back to
the NumPy path when the build or the preconditions (real fd, H <= B)
don't hold. A ``CDLL`` call releases the interpreter lock for its whole
length, so two feeder threads parse and stage at once.
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
    lib.parse_tokens.restype = ctypes.c_int64
    lib.parse_tokens.argtypes = [
        ctypes.c_char_p,  # rem
        ctypes.c_int64,  # rem_len
        ctypes.c_char_p,  # raw
        ctypes.c_int64,  # raw_len
        ctypes.c_int32,  # final
        ctypes.c_uint32,  # clamp
        ctypes.c_void_p,  # out
        ctypes.c_void_p,  # held
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


def parse_tokens(
    raw: bytes, rem: bytes, final: bool, clamp: int
) -> tuple[np.ndarray, bytes]:
    """``runtime.buffers.parse_token_stream`` in native code: the tokens of
    ``rem + raw`` and the new held digit run (``rem`` and ``raw`` are
    passed as two spans, not joined)."""
    lib = _lib()
    out = np.empty((len(rem) + len(raw) + 1) // 2, np.uint16)
    held = ctypes.c_int64(0)
    n = lib.parse_tokens(rem, len(rem), raw, len(raw), final, clamp,
                         out.ctypes.data, ctypes.byref(held))
    h = held.value - len(rem)
    rem = raw[h:] if h >= 0 else rem[h:] + raw
    return out[:n], rem
