"""Build, load and launch the hand-written CUDA probe kernels (``csrc/``).

``bloom_probe.cu`` holds two ``__global__`` kernels for Hopper (sm_90a)
with a plain C entry point each; they replace the Pallas kernels of the
reference's ``ops/bloom.py`` (``_make_sampled_kernel`` and the byte path
of ``_make_probe_kernel``, both launched by ``_probe_bits_jit``). The
library is compiled with ``nvcc`` at first use into ``_build/`` (listed in
``.gitignore``), rebuilt when a source is newer, and bound with
``ctypes``. ``bloom_probe_host.cpp`` runs the same per-thread code on the
CPU (built with ``g++``) so the tests can check the kernels' arithmetic
without a GPU.

``launch_probe`` is the only launcher. It takes CUDA tensors only and
raises on anything else — there is no fallback: a CPU tensor never gets
here (ops/bloom.probe_bits routes it to the plain PyTorch version).
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time

import numpy as np
import torch

from .bloom import MAX_SAMPLED_CONTEXT

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
HEADERS = ("bloom_probe.cuh",)
CUDA_SOURCES = ("bloom_probe.cu",)
HOST_SOURCES = ("bloom_probe_host.cpp",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared and local memory per kernel
)
GXX_FLAGS = ("-std=c++17", "-O2", "-shared", "-fPIC")

# Kernel launches per mode; launch_probe adds one per launch and nothing
# else touches them (chip_smoke.py resets and reads them).
probe_launches = {"sampled": 0, "strided": 0}
# The last compile in this process: {"seconds", "command", "log"}.
last_build: dict = {}

_LOCK = threading.Lock()
_LIBS: dict = {}


def find_nvcc() -> str:
    home = os.environ.get("CUDA_HOME")
    for cand in (
        home and os.path.join(home, "bin", "nvcc"),
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME): the probe kernels are built from "
        "csrc/ with the CUDA toolkit at first use"
    )


def _stale(lib: str, sources) -> bool:
    if not os.path.exists(lib):
        return True
    built = os.path.getmtime(lib)
    return any(
        os.path.getmtime(os.path.join(CSRC_DIR, f)) > built
        for f in (*sources, *HEADERS)
    )


def _compile(compiler: list, lib: str, sources) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    cmd = [*compiler, "-o", tmp, *(os.path.join(CSRC_DIR, f) for f in sources)]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(
            f"kernel build failed: {' '.join(cmd)}\n{r.stdout}{r.stderr}"
        )
    os.replace(tmp, lib)  # atomic: a concurrent loader sees old or new
    last_build.clear()
    last_build.update(
        seconds=time.perf_counter() - t0, command=cmd,
        log=(r.stdout + r.stderr).strip(),
    )


def _load(name: str, sources, compiler, bind) -> ctypes.CDLL:
    with _LOCK:
        if name not in _LIBS:
            path = os.path.join(BUILD_DIR, name)
            if _stale(path, sources):
                _compile(compiler(), path, sources)
            lib = ctypes.CDLL(path)
            bind(lib)
            _LIBS[name] = lib
        return _LIBS[name]


def _bind_cuda(lib) -> None:
    P, I = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.tpm_probe_sampled, lib.tpm_probe_strided):
        fn.argtypes = [P] * 5 + [I] * 7 + [P] * 3
        fn.restype = I
    lib.tpm_error_string.argtypes = [I]
    lib.tpm_error_string.restype = ctypes.c_char_p


def _bind_host(lib) -> None:
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.tpm_probe_host.argtypes = [I] + [P] * 5 + [I] * 8 + [P] * 2
    lib.tpm_probe_host.restype = I


def cuda_library() -> ctypes.CDLL:
    """The CUDA kernel library, built on first use (needs ``nvcc``)."""
    return _load(
        "libtpm_probe_cuda.so", CUDA_SOURCES,
        lambda: [find_nvcc(), *NVCC_FLAGS], _bind_cuda,
    )


def host_library() -> ctypes.CDLL:
    """The kernels' per-thread bodies compiled for the CPU (needs g++)."""
    return _load(
        "libtpm_probe_host.so", HOST_SOURCES,
        lambda: ["g++", *GXX_FLAGS], _bind_host,
    )


def _check(data_tm, bounds, words, cfg) -> tuple[int, int]:
    if data_tm.dtype != torch.uint8 or data_tm.dim() != 2:
        raise ValueError(f"data_tm must be 2-D uint8, got {data_tm.dtype} "
                         f"{tuple(data_tm.shape)}")
    T, Cp = data_tm.shape
    if T % cfg.tile_rows or Cp % 128 or T == 0 or Cp == 0:
        raise ValueError(
            f"data_tm {T}x{Cp}: rows must be a multiple of the tile height "
            f"{cfg.tile_rows} and lanes a multiple of 128 (prep_time_major)"
        )
    if bounds.dtype != torch.int32 or tuple(bounds.shape) != (2, Cp):
        raise ValueError(f"bounds must be int32 [2, {Cp}], got "
                         f"{bounds.dtype} {tuple(bounds.shape)}")
    if words.dtype != torch.int32 or tuple(words.shape) != (
        cfg.kbanks, cfg.v, 128
    ):
        raise ValueError(f"words must be int32 [{cfg.kbanks}, {cfg.v}, 128]"
                         f", got {words.dtype} {tuple(words.shape)}")
    for name, t in (("data_tm", data_tm), ("bounds", bounds),
                    ("words", words)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != data_tm.device:
            raise ValueError(f"{name} is on {t.device}, data_tm on "
                             f"{data_tm.device}")
    if not 1 <= cfg.q <= 8 or cfg.v & (cfg.v - 1):
        raise ValueError(f"unsupported config q={cfg.q} v={cfg.v}")
    ctx = MAX_SAMPLED_CONTEXT
    if cfg.sampled and (cfg.stride != 1 or cfg.w < 1 or cfg.w - 1 > ctx
                        or cfg.w + cfg.q - 2 > ctx):
        raise ValueError(f"unsupported sampled config stride={cfg.stride} "
                         f"w={cfg.w} q={cfg.q} (context rows <= {ctx})")
    return T, Cp


def _mixes(cfg):
    return (np.asarray(cfg.mix1, np.int64), np.asarray(cfg.mix2, np.int64))


def launch_probe(data_tm, bounds, words, cfg):
    """Launch the probe kernel of ``cfg``'s mode on the current stream.

    Same contract as ``ops.bloom.probe_bits``; CUDA tensors only. Returns
    ``(bits [T/(32*stride), Cp] int32, total [1] int32)`` without
    synchronising."""
    if not data_tm.is_cuda:
        raise ValueError(f"launch_probe needs CUDA tensors, got "
                         f"{data_tm.device}")
    T, Cp = _check(data_tm, bounds, words, cfg)
    dev = data_tm.device
    lib = cuda_library()
    bits = torch.empty((T // (32 * cfg.stride), Cp), dtype=torch.int32,
                       device=dev)
    total = torch.zeros(1, dtype=torch.int32, device=dev)
    mix1, mix2 = _mixes(cfg)
    ptrs = (data_tm.data_ptr(), bounds.data_ptr(), words.data_ptr(),
            bits.data_ptr(), total.data_ptr())
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if cfg.sampled:
            rc = lib.tpm_probe_sampled(
                *ptrs, T, Cp, cfg.q, cfg.kbanks, cfg.v, cfg.w,
                int(cfg.fold_case), mix1.ctypes.data, mix2.ctypes.data,
                stream,
            )
        else:
            rc = lib.tpm_probe_strided(
                *ptrs, T, Cp, cfg.q, cfg.stride, cfg.kbanks, cfg.v,
                int(cfg.fold_case), mix1.ctypes.data, mix2.ctypes.data,
                stream,
            )
    mode = "sampled" if cfg.sampled else "strided"
    if rc:
        raise RuntimeError(
            f"{mode} probe kernel launch failed: "
            f"{lib.tpm_error_string(rc).decode()} (code {rc})"
        )
    probe_launches[mode] += 1
    return bits, total


def probe_on_host(data_tm, bounds, words, cfg):
    """The kernels' own per-thread code run on the CPU (a test harness,
    not a kernel): CPU tensors in, ``(bits, total)`` CPU tensors out."""
    T, Cp = _check(data_tm, bounds, words, cfg)
    bits = torch.empty((T // (32 * cfg.stride), Cp), dtype=torch.int32)
    total = torch.zeros(1, dtype=torch.int32)
    mix1, mix2 = _mixes(cfg)
    rc = host_library().tpm_probe_host(
        int(cfg.sampled), data_tm.data_ptr(), bounds.data_ptr(),
        words.data_ptr(), bits.data_ptr(), total.data_ptr(), T, Cp, cfg.q,
        cfg.stride, cfg.kbanks, cfg.v, cfg.w, int(cfg.fold_case),
        mix1.ctypes.data, mix2.ctypes.data,
    )
    if rc:
        raise RuntimeError(f"host probe rejected its arguments (code {rc})")
    return bits, total
