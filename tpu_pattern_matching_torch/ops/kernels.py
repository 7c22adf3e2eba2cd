"""Build, load and launch the hand-written CUDA kernels (``csrc/``).

Three libraries for Hopper (sm_90a), each with a plain C entry point per
kernel, bound with ``ctypes``:

- ``bloom_probe.cu`` — the bloom probes. They replace the Pallas kernels of
  the reference's ``ops/bloom.py``, all launched by ``_probe_bits_jit``:
  ``_make_sampled_kernel`` (sampled), the unpacked path of
  ``_make_probe_kernel`` (strided) and its uint32-packed path
  (strided_packed), all three on one tiled loop.
- ``dfa_walk.cu`` — the two DFA walks that the reference writes as XLA
  ``lax.scan`` loops: the windowed candidate walk of device verify, with
  the compaction of its reports to events and their group counts in the
  same launch (``ops/verify_device.py`` stages 3-5), and the dense
  engine's lane walk (``ops/match_xla.py``), which walks each lane in
  sub-spans (``dense_plan``).
- ``proto_probe.cu`` — the prototype probe of the reference's
  ``benchmarks/exp_bloom.py`` (its two Pallas bodies: ``kernel``, one
  tile, and ``big_kernel``, a grid of tiles), launched by
  ``benchmarks.exp_bloom.run_probe`` and ``run_grid``; no session path runs
  it.

Symbols are uint8 (bytes) or uint16 (the ushort alphabet of 2048, the
packet-metadata path): every kernel but the packed and prototype probes
has a build for each width, chosen by the symbol tensor's dtype.

Each library is compiled with its own ``nvcc`` at first use into
``_build/`` (listed in ``.gitignore``) and rebuilt when a source is newer;
``build_all`` runs the three compiles at once. ``*_host.cpp`` runs the
same tile and thread code on the CPU (built with ``g++``) so the tests can
check the kernels' arithmetic without a GPU. The same loader builds the
host's native oracle and stager (``oracle.cpp``, ``stager.cpp``) with
``g++``.

The ``launch_*`` functions take CUDA tensors only and raise on anything
else — there is no fallback: a CPU tensor never gets here (the ops modules
route it to the plain PyTorch versions).
"""

from __future__ import annotations

import ctypes
import functools
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
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared and local memory per kernel
)
GXX_FLAGS = ("-std=c++17", "-O2", "-shared", "-fPIC")
# the native oracle and stager (host code, not kernels): tuned for the
# host, as the reference builds them
GXX_NATIVE_FLAGS = ("-std=c++17", "-O3", "-march=native", "-funroll-loops",
                    "-shared", "-fPIC")
# library file -> (sources, headers it includes)
LIBRARIES = {
    "libtpm_probe_cuda.so": (("bloom_probe.cu",), ("bloom_probe.cuh",)),
    "libtpm_probe_host.so": (("bloom_probe_host.cpp",), ("bloom_probe.cuh",)),
    "libtpm_walk_cuda.so": (("dfa_walk.cu",), ("dfa_walk.cuh",)),
    "libtpm_walk_host.so": (("dfa_walk_host.cpp",), ("dfa_walk.cuh",)),
    "libtpm_proto_cuda.so": (("proto_probe.cu",),
                             ("proto_probe.cuh", "bloom_probe.cuh")),
    "libtpm_proto_host.so": (("proto_probe_host.cpp",),
                             ("proto_probe.cuh", "bloom_probe.cuh")),
    "liboracle.so": (("oracle.cpp",), ()),
    "libstager.so": (("stager.cpp",), ()),
}

# Kernel launches per kernel and symbol width (``_u16``: uint16 symbols;
# ``proto_tile`` and ``proto_grid``: the prototype probe as the one-tile
# and the grid prototype); each launch_* function adds one per launch and
# nothing else touches them (chip_smoke.py resets and reads them).
launches = {"sampled": 0, "strided": 0, "strided_packed": 0,
            "window_walk": 0, "dense_walk": 0, "sampled_u16": 0,
            "strided_u16": 0, "window_walk_u16": 0, "dense_walk_u16": 0,
            "proto_tile": 0, "proto_grid": 0}
# The compiles of this process: library file -> {"seconds", "command", "log"}.
builds: dict = {}

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
        "nvcc not found (set CUDA_HOME): the CUDA kernels are built from "
        "csrc/ with the CUDA toolkit at first use"
    )


def _stale(lib: str, files) -> bool:
    if not os.path.exists(lib):
        return True
    built = os.path.getmtime(lib)
    return any(os.path.getmtime(os.path.join(CSRC_DIR, f)) > built
               for f in files)


def _compile(jobs) -> None:
    """Compile ``[(compiler, library file, sources)]``, one process each,
    all at once; raises after all have ended if any failed."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    running = []
    for compiler, name, sources in jobs:
        lib = os.path.join(BUILD_DIR, name)
        tmp = f"{lib}.{os.getpid()}.tmp"
        cmd = [*compiler, "-o", tmp,
               *(os.path.join(CSRC_DIR, f) for f in sources)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running.append((name, lib, tmp, cmd, proc, time.perf_counter()))
    failed = []
    for name, lib, tmp, cmd, proc, t0 in running:
        log = proc.communicate()[0].strip()
        if proc.returncode:
            failed.append(f"{' '.join(cmd)}\n{log}")
            continue
        os.replace(tmp, lib)  # atomic: a concurrent loader sees old or new
        builds[name] = dict(seconds=time.perf_counter() - t0, command=cmd,
                            log=log)
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))


def _load(*specs) -> list:
    """Load ``(library file, compiler, bind)`` specs, compiling the stale
    ones first (all at once)."""
    with _LOCK:
        todo = [sp for sp in specs if sp[0] not in _LIBS]
        stale = [(compiler(), name, LIBRARIES[name][0])
                 for name, compiler, _bind in todo
                 if _stale(os.path.join(BUILD_DIR, name),
                           (*LIBRARIES[name][0], *LIBRARIES[name][1]))]
        if stale:
            _compile(stale)
        for name, _compiler, bind in todo:
            lib = ctypes.CDLL(os.path.join(BUILD_DIR, name))
            bind(lib)
            _LIBS[name] = lib
        return [_LIBS[name] for name, *_ in specs]


P, I = ctypes.c_void_p, ctypes.c_int


def _bind_probe_cuda(lib) -> None:
    for fn in (lib.tpm_probe_sampled, lib.tpm_probe_strided,
               lib.tpm_probe_strided_packed):
        fn.argtypes = [P] * 5 + [I] * 8 + [P] * 3
        fn.restype = I
    lib.tpm_probe_plan.argtypes = [I] * 9 + [P]
    lib.tpm_probe_plan.restype = I
    lib.tpm_error_string.argtypes = [I]
    lib.tpm_error_string.restype = ctypes.c_char_p


def _bind_probe_host(lib) -> None:
    lib.tpm_probe_host.argtypes = ([I] + [P] * 5 + [I] * 9 + [P] * 2
                                   + [ctypes.c_long])
    lib.tpm_probe_host.restype = I
    lib.tpm_probe_plan_host.argtypes = [I] * 9 + [ctypes.c_long, P]
    lib.tpm_probe_plan_host.restype = I


def _bind_walk(lib, stream: bool) -> None:
    suffix = "" if stream else "_host"
    tail = [P] if stream else []
    fn = getattr(lib, "tpm_walk_emit" + suffix)
    fn.argtypes = ([P, I, P, I] + [P] * 7 + [I] * 10 + [P, ctypes.c_longlong]
                   + tail)
    fn.restype = I
    fn = getattr(lib, "tpm_dense_walk" + suffix)
    fn.argtypes = [P, I, P, I] + [P] * 2 + [I] * 8 + [P] * 5 + tail
    fn.restype = I
    fn = getattr(lib, "tpm_dense_plan" + suffix)
    fn.argtypes = [I] * (4 if stream else 5) + [P]
    fn.restype = I
    lib.tpm_emit_layout = getattr(lib, "tpm_emit_layout" + suffix)
    lib.tpm_emit_layout.argtypes = [I] * 3 + [P]
    lib.tpm_emit_layout.restype = I
    if stream:
        lib.tpm_walk_error_string.argtypes = [I]
        lib.tpm_walk_error_string.restype = ctypes.c_char_p


def _bind_proto(lib, stream: bool) -> None:
    fn = lib.tpm_proto_probe if stream else lib.tpm_proto_probe_host
    fn.argtypes = [P] * 3 + [I] * 8 + [P] * 2 + ([P] if stream else [I])
    fn.restype = I
    if stream:
        lib.tpm_proto_error_string.argtypes = [I]
        lib.tpm_proto_error_string.restype = ctypes.c_char_p


def _nvcc():
    return [find_nvcc(), *NVCC_FLAGS]


def _gxx():
    return ["g++", *GXX_FLAGS]


def _bind_walk_cuda(lib) -> None:
    _bind_walk(lib, True)


def _bind_walk_host(lib) -> None:
    _bind_walk(lib, False)


PROBE_CUDA = ("libtpm_probe_cuda.so", _nvcc, _bind_probe_cuda)
WALK_CUDA = ("libtpm_walk_cuda.so", _nvcc, _bind_walk_cuda)
PROTO_CUDA = ("libtpm_proto_cuda.so", _nvcc,
              lambda lib: _bind_proto(lib, True))


def cuda_library() -> ctypes.CDLL:
    """The probe kernels' library, built on first use (needs ``nvcc``)."""
    return _load(PROBE_CUDA)[0]


def walk_library() -> ctypes.CDLL:
    """The walk kernels' library, built on first use (needs ``nvcc``)."""
    return _load(WALK_CUDA)[0]


def proto_library() -> ctypes.CDLL:
    """The prototype probe's library, built on first use (needs ``nvcc``)."""
    return _load(PROTO_CUDA)[0]


def build_all() -> None:
    """Build (or load) every CUDA library, one ``nvcc`` each, all at once."""
    _load(PROBE_CUDA, WALK_CUDA, PROTO_CUDA)


def host_library() -> ctypes.CDLL:
    """The probe kernels' tile code compiled for the CPU (g++)."""
    return _load(("libtpm_probe_host.so", _gxx, _bind_probe_host))[0]


def native_library(name: str, bind) -> ctypes.CDLL:
    """A host library of ``LIBRARIES`` (the native oracle or stager),
    built with ``g++`` on first use and bound by ``bind``."""
    return _load((name, lambda: ["g++", *GXX_NATIVE_FLAGS], bind))[0]


def walk_host_library() -> ctypes.CDLL:
    """The walk kernels' per-thread bodies compiled for the CPU (g++)."""
    return _load(("libtpm_walk_host.so", _gxx, _bind_walk_host))[0]


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _raise_on(rc: int, what: str, error_string) -> None:
    if rc:
        raise RuntimeError(f"{what} kernel launch failed: "
                           f"{error_string(rc).decode()} (code {rc})")


def _same_device(ref, **tensors) -> None:
    for name, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != ref.device:
            raise ValueError(f"{name} is on {t.device}, expected "
                             f"{ref.device}")


# ------------------------------------------------------------- the probes


def _sym16(t, name: str) -> int:
    """1 for uint16 symbols, 0 for uint8; raises for any other dtype."""
    if t.dtype not in (torch.uint8, torch.uint16):
        raise ValueError(f"{name} must be uint8 or uint16 symbols, got "
                         f"{t.dtype}")
    return int(t.dtype == torch.uint16)


def _check(data_tm, bounds, words, cfg) -> tuple[int, int, int]:
    """Validates a probe launch; returns (symbol rows T, lanes Cp, sym16).
    An int32 ``data_tm`` is the packed layout ``[T/4, Cp]`` of bytes."""
    packed = data_tm.dtype == torch.int32
    if data_tm.dim() != 2:
        raise ValueError(f"data_tm must be 2-D, got {tuple(data_tm.shape)}")
    sym16 = 0 if packed else _sym16(data_tm, "data_tm")
    if sym16 and cfg.fold_case:
        raise ValueError("fold_case needs byte symbols, got uint16")
    if packed and (cfg.sampled or cfg.stride % 4 or cfg.q > cfg.stride):
        raise ValueError(f"packed int32 data_tm needs a strided config with "
                         f"stride % 4 == 0, got sampled={cfg.sampled} "
                         f"stride={cfg.stride}")
    T = data_tm.shape[0] * (4 if packed else 1)
    Cp = data_tm.shape[1]
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
    _same_device(data_tm, data_tm=data_tm, bounds=bounds, words=words)
    if not 1 <= cfg.q <= 8 or cfg.v & (cfg.v - 1):
        raise ValueError(f"unsupported config q={cfg.q} v={cfg.v}")
    ctx = MAX_SAMPLED_CONTEXT
    if cfg.sampled and (cfg.stride != 1 or cfg.w < 1 or cfg.w - 1 > ctx
                        or cfg.w + cfg.q - 2 > ctx):
        raise ValueError(f"unsupported sampled config stride={cfg.stride} "
                         f"w={cfg.w} q={cfg.q} (context rows <= {ctx})")
    return T, Cp, sym16


def _mixes(cfg):
    return (np.asarray(cfg.mix1, np.int64), np.asarray(cfg.mix2, np.int64))


def probe_mode(data_tm, cfg) -> str:
    """The launch-count key of ``cfg``'s probe on ``data_tm``: sampled,
    strided or strided_packed, with ``_u16`` for uint16 symbols."""
    if data_tm.dtype == torch.int32:
        return "strided_packed"
    mode = "sampled" if cfg.sampled else "strided"
    return mode + "_u16" if data_tm.dtype == torch.uint16 else mode


def launch_probe(data_tm, bounds, words, cfg):
    """Launch the probe kernel of ``cfg``'s mode and ``data_tm``'s symbol
    width on the current stream (the packed strided kernel for an int32
    ``data_tm``).

    Same contract as ``ops.bloom.probe_bits``; CUDA tensors only. Returns
    ``(bits [T/(32*stride), Cp] int32, total [1] int32)`` without
    synchronising."""
    if not data_tm.is_cuda:
        raise ValueError(f"launch_probe needs CUDA tensors, got "
                         f"{data_tm.device}")
    T, Cp, sym16 = _check(data_tm, bounds, words, cfg)
    dev = data_tm.device
    lib = cuda_library()
    bits = torch.empty((T // (32 * cfg.stride), Cp), dtype=torch.int32,
                       device=dev)
    total = torch.zeros(1, dtype=torch.int32, device=dev)
    mix1, mix2 = _mixes(cfg)
    ptrs = (data_tm.data_ptr(), bounds.data_ptr(), words.data_ptr(),
            bits.data_ptr(), total.data_ptr())
    mode = probe_mode(data_tm, cfg)
    tail = (int(cfg.fold_case), sym16, mix1.ctypes.data, mix2.ctypes.data,
            _stream(dev))
    with torch.cuda.device(dev):
        if cfg.sampled:
            rc = lib.tpm_probe_sampled(*ptrs, T, Cp, cfg.q, cfg.kbanks, cfg.v,
                                       cfg.w, *tail)
        else:
            fn = (lib.tpm_probe_strided_packed if mode == "strided_packed"
                  else lib.tpm_probe_strided)
            rc = fn(*ptrs, T, Cp, cfg.q, cfg.stride, cfg.kbanks, cfg.v,
                    *tail)
    _raise_on(rc, f"{mode} probe", lib.tpm_error_string)
    launches[mode] += 1
    return bits, total


PLAN_KEYS = ("lanes", "words", "tiles", "words_in_smem", "smem_bytes",
             "threads", "blocks")


def probe_plan(data_tm, cfg) -> dict:
    """The tiling the probe kernel of ``cfg``'s mode takes for this launch
    on the current CUDA device (the packed kernel's for an int32
    ``data_tm``): lanes and output words per tile, tiles, bank words in
    shared memory or not, the dynamic shared memory it opts into, threads
    per block and blocks (``PLAN_KEYS``)."""
    T, Cp, sym16 = _check(data_tm, bounds=torch.zeros(
        (2, data_tm.shape[1]), dtype=torch.int32, device=data_tm.device),
        words=torch.zeros((cfg.kbanks, cfg.v, 128), dtype=torch.int32,
                          device=data_tm.device), cfg=cfg)
    lib = cuda_library()
    out = (ctypes.c_int * 7)()
    with torch.cuda.device(data_tm.device):
        rc = lib.tpm_probe_plan(  # layout 2: packed bytes
            int(cfg.sampled), T, Cp, cfg.q, cfg.stride, cfg.kbanks, cfg.v,
            cfg.w, 2 if data_tm.dtype == torch.int32 else sym16, out)
    _raise_on(rc, "probe plan", lib.tpm_error_string)
    return dict(zip(PLAN_KEYS, out))


def probe_plan_on_host(T, Cp, cfg, sym16=0, smem_budget=0,
                       packed=False) -> dict:
    """The tiling of ``probe_plan`` (no ``blocks``) under a shared-memory
    budget per block (0: Hopper's 227 KB), from the kernels' own planner
    compiled for the CPU; ``packed``: the packed kernel's (T symbol
    rows)."""
    out = (ctypes.c_int * 6)()
    rc = host_library().tpm_probe_plan_host(
        int(cfg.sampled), T, Cp, cfg.q, cfg.stride, cfg.kbanks, cfg.v,
        cfg.w, 2 if packed else sym16, smem_budget, out)
    if rc:
        raise ValueError(f"no tiling fits {smem_budget} B for {cfg}")
    return dict(zip(PLAN_KEYS, out))


def probe_on_host(data_tm, bounds, words, cfg, smem_budget: int = 0):
    """The kernels' own tile code run on the CPU, tile by tile (a test
    harness, not a kernel): CPU tensors in, ``(bits, total)`` CPU tensors
    out. ``smem_budget`` (bytes per block, 0: Hopper's 227 KB) sets the
    tiling the kernels would plan for."""
    T, Cp, sym16 = _check(data_tm, bounds, words, cfg)
    bits = torch.empty((T // (32 * cfg.stride), Cp), dtype=torch.int32)
    total = torch.zeros(1, dtype=torch.int32)
    mix1, mix2 = _mixes(cfg)
    mode = (2 if data_tm.dtype == torch.int32 else int(cfg.sampled))
    rc = host_library().tpm_probe_host(
        mode, data_tm.data_ptr(), bounds.data_ptr(),
        words.data_ptr(), bits.data_ptr(), total.data_ptr(), T, Cp, cfg.q,
        cfg.stride, cfg.kbanks, cfg.v, cfg.w, int(cfg.fold_case), sym16,
        mix1.ctypes.data, mix2.ctypes.data, smem_budget,
    )
    if rc:
        raise RuntimeError(f"host probe rejected its arguments (code {rc})")
    return bits, total


# -------------------------------------------------------------- the walks


def _check_table(table_flat, alphabet_size: int) -> int:
    if table_flat.dim() != 1 or table_flat.dtype not in (torch.int16,
                                                         torch.int32):
        raise ValueError(f"table_flat must be 1-D int16 or int32, got "
                         f"{table_flat.dtype} {tuple(table_flat.shape)}")
    if alphabet_size < 1 or table_flat.shape[0] % alphabet_size:
        raise ValueError(f"table_flat of {table_flat.shape[0]} entries is "
                         f"not [S, {alphabet_size}]")
    return int(table_flat.dtype == torch.int16)


def _check_i32(name, t, shape) -> None:
    if t.dtype != torch.int32 or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must be int32 {list(shape)}, got "
                         f"{t.dtype} {tuple(t.shape)}")


EMIT_LAYOUT_KEYS = ("gcounts", "meta", "total", "blocks", "block_slots")


@functools.lru_cache(maxsize=256)
def emit_layout(lib, kw: int, k_ev: int, num_groups: int) -> dict:
    """The one buffer of a walk-and-emit launch as ``lib`` (the walk
    library or its host harness) lays it out (``tpm::emit_layout`` in
    ``csrc/dfa_walk.cuh``): offsets in int32 words of gcounts and meta
    (packed ``[3, k_ev]`` first; the kernel's scratch after meta), the
    total, the kernel's blocks and slots per block
    (``EMIT_LAYOUT_KEYS``). Do not modify the returned dict."""
    out = (ctypes.c_longlong * len(EMIT_LAYOUT_KEYS))()
    if lib.tpm_emit_layout(kw, k_ev, num_groups, out):
        raise ValueError(f"no walk-and-emit layout for kw={kw}, "
                         f"k_ev={k_ev}, G={num_groups}")
    return dict(zip(EMIT_LAYOUT_KEYS, out))


def _emit_args(lib, table_flat, state_gid, data_flat, bounds, lane, row,
               n_exact, n_cand, base_flags, *, C, T, alphabet_size, q, lmax,
               halo, k_ev, num_groups, steps):
    """Validates a walk-and-emit launch; returns (its arguments, meta,
    packed, gcounts), the outputs views of one buffer on the inputs'
    device, laid out by ``lib``."""
    t16 = _check_table(table_flat, alphabet_size)
    sym16 = _sym16(data_flat, "data_flat")
    if tuple(data_flat.shape) != (C * T,):
        raise ValueError(f"data_flat must be [{C * T}], got "
                         f"{tuple(data_flat.shape)}")
    _check_i32("bounds", bounds, (2, C))
    kw = lane.shape[0] if lane.dim() == 1 else -1
    _check_i32("lane", lane, (kw,))
    _check_i32("row", row, (kw,))
    _check_i32("state_gid", state_gid, (state_gid.shape[0],))
    for name, t, dtype in (("n_exact", n_exact, torch.int64),
                           ("n_cand", n_cand, torch.int64),
                           ("base_flags", base_flags, torch.int32)):
        if t.dtype != dtype or t.numel() != 1:
            raise ValueError(f"{name} must be one {dtype}")
    _same_device(table_flat, table_flat=table_flat, data_flat=data_flat,
                 bounds=bounds, lane=lane, row=row, state_gid=state_gid,
                 n_exact=n_exact, n_cand=n_cand, base_flags=base_flags)
    lay = emit_layout(lib, kw, k_ev, num_groups)
    buf = torch.empty(lay["total"], dtype=torch.int32,
                      device=table_flat.device)
    args = (table_flat.data_ptr(), t16, data_flat.data_ptr(), sym16,
            bounds.data_ptr(), lane.data_ptr(), row.data_ptr(),
            state_gid.data_ptr(), n_exact.data_ptr(), n_cand.data_ptr(),
            base_flags.data_ptr(), C, T, alphabet_size, q, lmax, halo, kw,
            steps, k_ev, num_groups, buf.data_ptr(), lay["total"])
    g, m = lay["gcounts"], lay["meta"]
    return args, buf[m:m + 5], buf[:g].view(3, k_ev), buf[g:m]


def launch_walk_and_emit(table_flat, state_gid, data_flat, bounds, lane, row,
                         n_exact, n_cand, base_flags, **kw):
    """Launch stages 3-5 of device verify, the window walk and the
    compaction of its reports (``ops.verify_device.walk_and_emit`` has the
    contract), for ``data_flat``'s symbol width: two fills of one buffer
    and one kernel; CUDA tensors only. Returns ``(meta [5], packed [3,
    k_ev], gcounts [G])`` int32 without synchronising."""
    if not table_flat.is_cuda:
        raise ValueError(f"launch_walk_and_emit needs CUDA tensors, got "
                         f"{table_flat.device}")
    lib = walk_library()
    args, meta, packed, gcounts = _emit_args(
        lib, table_flat, state_gid, data_flat, bounds, lane, row, n_exact,
        n_cand, base_flags, **kw)
    dev = table_flat.device
    with torch.cuda.device(dev):
        rc = lib.tpm_walk_emit(*args, _stream(dev))
    _raise_on(rc, "walk and emit", lib.tpm_walk_error_string)
    launches["window_walk_u16" if data_flat.dtype == torch.uint16
             else "window_walk"] += 1
    return meta, packed, gcounts


def walk_and_emit_on_host(table_flat, state_gid, data_flat, bounds, lane,
                          row, n_exact, n_cand, base_flags, **kw):
    """The walk-and-emit kernel's per-slot code on the CPU (a test
    harness): every slot's count, a sequential exclusive scan, every
    slot's events and the meta."""
    lib = walk_host_library()
    args, meta, packed, gcounts = _emit_args(
        lib, table_flat, state_gid, data_flat, bounds, lane, row, n_exact,
        n_cand, base_flags, **kw)
    if lib.tpm_walk_emit_host(*args):
        raise RuntimeError("host walk and emit rejected its arguments")
    return meta, packed, gcounts


DENSE_PLAN_KEYS = ("subspans", "steps", "threads", "blocks")
H100_SMS = 132  # the plan of dense_walk_on_host and dense_plan_on_host


def dense_plan(data_tm, *, halo, max_pat_len) -> dict:
    """The launch plan of the dense walk on ``data_tm [T, C]`` on the
    current CUDA device (``DENSE_PLAN_KEYS``): sub-spans per lane, the most
    steps of a thread with its warm-up, threads per block, blocks."""
    T, C = data_tm.shape
    lib = walk_library()
    out = (ctypes.c_int * 4)()
    with torch.cuda.device(data_tm.device):
        rc = lib.tpm_dense_plan(T, C, halo, max_pat_len, out)
    _raise_on(rc, "dense plan", lib.tpm_walk_error_string)
    return dict(zip(DENSE_PLAN_KEYS, out))


def dense_plan_on_host(T, C, *, halo, max_pat_len, n_sm=H100_SMS) -> dict:
    """``dense_plan`` for a card of ``n_sm`` SMs, from the kernels' own
    planner compiled for the CPU."""
    out = (ctypes.c_int * 4)()
    if walk_host_library().tpm_dense_plan_host(T, C, halo, max_pat_len,
                                               n_sm, out):
        raise ValueError(f"no dense plan for T={T} C={C} halo={halo} "
                         f"max_pat_len={max_pat_len} n_sm={n_sm}")
    return dict(zip(DENSE_PLAN_KEYS, out))


def _dense_args(table_flat, data_tm, bounds, subspans, *, alphabet_size,
                halo, max_results, max_pat_len, state_gid=None,
                num_groups=0):
    """Validates a dense-walk launch of ``subspans`` sub-spans per lane;
    returns (its arguments, the outputs, the scratch of its sub-spans'
    first reports), allocated on the inputs' device. The caller holds the
    scratch until the launch is enqueued (the arguments hold only its
    address)."""
    t16 = _check_table(table_flat, alphabet_size)
    sym16 = _sym16(data_tm, "data_tm")
    if data_tm.dim() != 2:
        raise ValueError(f"data_tm must be 2-D, got {tuple(data_tm.shape)}")
    if max_pat_len < 1:
        raise ValueError(f"max_pat_len must be at least 1, got {max_pat_len}")
    T, C = data_tm.shape
    _check_i32("bounds", bounds, (2, C))
    tensors = dict(table_flat=table_flat, data_tm=data_tm, bounds=bounds)
    if state_gid is not None:
        _check_i32("state_gid", state_gid, (state_gid.shape[0],))
        tensors["state_gid"] = state_gid
    _same_device(table_flat, **tensors)
    dev = table_flat.device
    R = max_results
    counts = torch.empty(C, dtype=torch.int32, device=dev)
    slot_state = torch.zeros((C, R), dtype=torch.int32, device=dev)
    slot_pos = torch.zeros((C, R), dtype=torch.int32, device=dev)
    gcounts = (None if state_gid is None else
               torch.zeros(num_groups, dtype=torch.int32, device=dev))
    keep = torch.empty(max(1, 2 * subspans * R * C), dtype=torch.int32,
                       device=dev)
    args = (table_flat.data_ptr(), t16, data_tm.data_ptr(), sym16,
            bounds.data_ptr(),
            None if state_gid is None else state_gid.data_ptr(),
            T, C, alphabet_size, halo, R, num_groups, max_pat_len, subspans,
            counts.data_ptr(), slot_state.data_ptr(), slot_pos.data_ptr(),
            None if gcounts is None else gcounts.data_ptr(), keep.data_ptr())
    return args, (counts, slot_state, slot_pos, gcounts), keep


def launch_dense_walk(table_flat, data_tm, bounds, **kw):
    """Launch the dense lane walk (``ops.match_xla.dense_walk`` has the
    contract) for ``data_tm``'s symbol width, in the sub-spans of
    ``dense_plan``; CUDA tensors only. Returns ``(counts [C], slot_state
    [C, R], slot_pos [C, R], gcounts [G] or None)`` without
    synchronising."""
    if not table_flat.is_cuda:
        raise ValueError(f"launch_dense_walk needs CUDA tensors, got "
                         f"{table_flat.device}")
    plan = dense_plan(data_tm, halo=kw["halo"],
                      max_pat_len=kw["max_pat_len"])
    args, outs, _keep = _dense_args(table_flat, data_tm, bounds,
                                    plan["subspans"], **kw)
    lib = walk_library()
    dev = table_flat.device
    with torch.cuda.device(dev):
        rc = lib.tpm_dense_walk(*args, _stream(dev))
    _raise_on(rc, "dense walk", lib.tpm_walk_error_string)
    launches["dense_walk_u16" if data_tm.dtype == torch.uint16
             else "dense_walk"] += 1
    return outs


def dense_walk_on_host(table_flat, data_tm, bounds, subspans=None, **kw):
    """The dense walk's per-thread code and merge on the CPU (a test
    harness), in the sub-spans of ``dense_plan_on_host`` or ``subspans``
    per lane."""
    if subspans is None:
        subspans = dense_plan_on_host(
            *data_tm.shape, halo=kw["halo"],
            max_pat_len=kw["max_pat_len"])["subspans"]
    args, outs, _keep = _dense_args(table_flat, data_tm, bounds, subspans,
                                    **kw)
    if walk_host_library().tpm_dense_walk_host(*args):
        raise RuntimeError("host dense walk rejected its arguments")
    return outs


# ---------------------------------------------------- the prototype probe


def _proto_args(data, words, mix1, mix2, *, rows, stride, q, pitch, tiles):
    """A prototype-probe launch's arguments, for inputs that
    ``benchmarks.exp_bloom.check`` accepted (the kernel's entry point
    checks the geometry again); returns (its arguments, the output [tiles,
    rows, C] int8 on the inputs' device, the multiplier arrays the
    arguments point at, to be held until the launch is enqueued)."""
    _same_device(data, data=data, words=words)
    C = data.shape[1]
    out = torch.empty((tiles, rows, C), dtype=torch.int8, device=data.device)
    mixes = tuple(np.asarray([int(x) & 0xFFFFFFFF for x in m], np.int64)
                  for m in (mix1, mix2))
    args = (data.data_ptr(), words.data_ptr(), out.data_ptr(), tiles, rows,
            stride, q, pitch, C, words.shape[0], words.shape[1],
            mixes[0].ctypes.data, mixes[1].ctypes.data)
    return args, out, mixes


def launch_proto_probe(data, words, mix1, mix2, *, kind, **geom):
    """Launch the prototype probe on inputs that
    ``benchmarks.exp_bloom.check`` accepted (``geom``: rows, stride, q,
    pitch, tiles) on the current stream and count it under
    ``proto_<kind>`` (``tile``: the one-tile prototype, ``grid``: the
    grid); CUDA tensors only. Returns the output ``[tiles, rows, C]`` int8
    without synchronising."""
    if not data.is_cuda:
        raise ValueError(f"launch_proto_probe needs CUDA tensors, got "
                         f"{data.device}")
    key = f"proto_{kind}"
    if key not in launches:
        raise ValueError(f"kind must be 'tile' or 'grid', got {kind!r}")
    args, out, _mixes = _proto_args(data, words, mix1, mix2, **geom)
    lib = proto_library()
    dev = data.device
    with torch.cuda.device(dev):
        rc = lib.tpm_proto_probe(*args, _stream(dev))
    _raise_on(rc, "proto probe", lib.tpm_proto_error_string)
    launches[key] += 1
    return out


def proto_probe_on_host(data, words, mix1, mix2, words_per_item=4,
                        **geom):
    """The prototype probe's per-item code on the CPU (a test harness),
    with items of ``words_per_item`` words of 4 lanes (1 or 4; the kernel
    picks by the launch's size): CPU tensors that
    ``benchmarks.exp_bloom.check`` accepted in, the output ``[tiles, rows,
    C]`` int8 out."""
    args, out, _mixes = _proto_args(data, words, mix1, mix2, **geom)
    lib = _load(("libtpm_proto_host.so", _gxx,
                 lambda lib: _bind_proto(lib, False)))[0]
    if lib.tpm_proto_probe_host(*args, words_per_item):
        raise RuntimeError("host proto probe rejected its arguments")
    return out
