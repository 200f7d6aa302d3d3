"""Build and load the port's CUDA kernels.

Each source under ``csrc/`` is compiled by its own ``nvcc`` process, all
started together, and one more ``nvcc`` call links the objects into one
shared library with a plain C interface (no PyTorch headers, no ninja),
loaded with :mod:`ctypes`.  The build runs at first use, keyed by a hash of
the sources and flags, into ``_build/`` beside this file; nothing is
compiled when a module is imported.

``nvcc`` is found through ``$CUDA_HOME`` or PyTorch's ``CUDA_HOME``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path
from typing import NamedTuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
SOURCES = ("pdps.cu", "pd_tile.cu", "hypergrad.cu", "tgv.cu", "tgv_tile.cu",
           "tvl1.cu", "vtv.cu", "single_loop.cu", "single_loop_tgv.cu",
           "single_loop_tvl1.cu", "single_loop_vtv.cu")
HEADERS = ("common.cuh", "pd_cluster.cuh", "pd_tile.cuh", "pdps.cuh",
           "single_loop.cuh", "tgv.cuh", "tgv_cluster.cuh", "tvl1.cuh",
           "vtv.cuh", "vtv_cluster.cuh")
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
# -fmad=false: no fused multiply-adds, so each operation rounds like the
# plain PyTorch version's separate elementwise operations
NVCC_FLAGS = ("-O3", "-std=c++17", *ARCH, "-Xcompiler", "-fPIC",
              "-fmad=false", "-Xptxas", "-v")


class BuildInfo(NamedTuple):
    path: Path
    seconds: float      # 0.0 when the library was already built


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME")
    if not home:
        from torch.utils.cpp_extension import CUDA_HOME
        home = CUDA_HOME
    if not home:
        raise RuntimeError("no CUDA toolkit found: set CUDA_HOME")
    return os.path.join(home, "bin", "nvcc")


def _key() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build() -> BuildInfo:
    """Compile the kernels unless the library for these sources exists."""
    out = BUILD_DIR / f"libbpl_kernels_{_key()}.so"
    if out.exists():
        return BuildInfo(out, 0.0)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    nvcc = nvcc_path()
    t0 = time.perf_counter()
    objs, procs = [], []
    for src in SOURCES:
        obj = BUILD_DIR / f"{tag}.{Path(src).stem}.o"
        objs.append(obj)
        procs.append(subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(CSRC / src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs, failed = [], []
    for src, proc in zip(SOURCES, procs):
        text, _ = proc.communicate(timeout=900)
        logs.append(f"== {src}\n{text}")
        if proc.returncode != 0:
            failed.append(src)
    log = "\n".join(logs)
    if failed:
        # the failed sources' logs, their error lines last (a long
        # -Xptxas -v log must not push them out of a truncated output)
        bad = "\n".join(t for src, t in zip(SOURCES, logs) if src in failed)
        errors = [line for line in bad.splitlines() if "error" in line]
        raise RuntimeError(f"nvcc failed on {failed}:\n{bad[-8000:]}\n"
                           "errors:\n" + "\n".join(errors[-40:]))
    tmp = out.with_name(f"{tag}.tmp.so")
    link = subprocess.run([nvcc, *ARCH, "-shared", "-o", str(tmp),
                           *map(str, objs)],
                          capture_output=True, text=True, timeout=900)
    for obj in objs:
        obj.unlink()
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({link.returncode}):\n"
                           f"{link.stdout}{link.stderr}")
    seconds = time.perf_counter() - t0
    # the -Xptxas -v report: registers, shared memory and spills per kernel
    out.with_suffix(".log").write_text(log)
    os.replace(tmp, out)
    return BuildInfo(out, seconds)


_LIB = None
_LIB_LOCK = threading.Lock()
#: guards the kernel wrappers' module counters (launches, device
#: operations), which several device threads of a mesh update
COUNTS = threading.Lock()
_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong


def _declare(lib):
    for suffix, real in (("f32", ctypes.c_float), ("f64", ctypes.c_double)):
        # the K blocks: kinds, scalar weights, map addresses (host arrays)
        blocks = [_I, ctypes.POINTER(_I), ctypes.POINTER(real),
                  ctypes.POINTER(_LL)]
        fn = getattr(lib, f"bpl_pdps_solve_{suffix}")
        # ... the blocks, the plan (cluster, rows, resident), τ, σ, γ, ...
        fn.argtypes = [_P] * 7 + [_LL, _I, _I, *blocks, _I, _I, _I, real,
                                  real, ctypes.c_double, _I, _I, _I, real,
                                  _I, ctypes.POINTER(_I),
                                  ctypes.POINTER(_I), _P]
        fn.restype = _I
        fn = getattr(lib, f"bpl_pdps_tile_{suffix}")
        # f, u, y, uprev, u2, y2, ratio, tab; O, M, N, the blocks, the tile
        # plan (11 ints), τ, σ, γ, accel, maxiter, use_tol, tol, check_every,
        # iterations and device operations out, the stream
        fn.argtypes = [_P] * 8 + [_LL, _I, _I, *blocks, ctypes.POINTER(_I),
                                  real, real, ctypes.c_double, _I, _I, _I,
                                  real, _I, ctypes.POINTER(_I),
                                  ctypes.POINTER(_I), _P]
        fn.restype = _I
        fn = getattr(lib, f"bpl_hypergrad_{suffix}")
        # u, ū, p0, p, work, partials, scal, gmaps, the device stats; the
        # blocks; act_tol, γ, μ, cg_tol; al_iters, cg_maxiter, reg; the
        # host stats, ops (launches, reads), the grid, the stream
        fn.argtypes = [_P] * 9 + [_LL, _I, _I, *blocks, real, real, real,
                                  real, _I, _I, _I,
                                  ctypes.POINTER(ctypes.c_double),
                                  ctypes.POINTER(_I), ctypes.POINTER(_I), _P]
        fn.restype = _I
        fn = getattr(lib, f"bpl_tgv_solve_{suffix}")
        # ... α₁, α₀, O, M, N, the plan (cluster, rows, resident), τ, σ,
        # the budget, iterations and device operations out, the stream
        fn.argtypes = [_P] * 12 + [real, real, _LL, _I, _I, _I, _I, _I,
                                   real, real, _I, _I, real, _I,
                                   ctypes.POINTER(_I), ctypes.POINTER(_I),
                                   _P]
        fn.restype = _I
        fn = getattr(lib, f"bpl_tgv_tile_{suffix}")
        # f, u, w, p, q, uprev, u2, w2, p2, q2, partials, scal, the maps;
        # α₁, α₀, O, M, N, the tile plan (10 ints), τ, σ, the budget,
        # iterations and device operations out, the stream
        fn.argtypes = [_P] * 14 + [real, real, _LL, _I, _I,
                                   ctypes.POINTER(_I), real, real, _I, _I,
                                   real, _I, ctypes.POINTER(_I),
                                   ctypes.POINTER(_I), _P]
        fn.restype = _I
        fn = getattr(lib, f"bpl_tvl1_solve_{suffix}")
        # ... α, O, M, N, the plan (cluster, rows, resident), τ, σ, the
        # form and its Huber constants, the budget, iterations and device
        # operations out, the stream
        fn.argtypes = [_P] * 8 + [real, _LL, _I, _I, _I, _I, _I, real, real,
                                  _I, real, real, real, _I, _I, real, _I,
                                  ctypes.POINTER(_I), ctypes.POINTER(_I),
                                  _P]
        fn.restype = _I
        fn = getattr(lib, f"bpl_vtv_solve_{suffix}")
        # ... α, O, C, M, N, the plan (cluster, rows, resident), τ, σ, γ,
        # accel, the budget, iterations and device operations out, the
        # stream
        fn.argtypes = [_P] * 8 + [real, _LL, _I, _I, _I, _I, _I, _I, real,
                                  real, ctypes.c_double, _I, _I, _I, real,
                                  _I, ctypes.POINTER(_I), ctypes.POINTER(_I),
                                  _P]
        fn.restype = _I
        fn = getattr(lib, f"bpl_single_loop_{suffix}")
        # rows 9–10: ... pipelined, then the step and the piece of the
        # mesh form (piece < 0: the single form), ..., the mesh form's
        # sums (offset, count, offset, count), ...
        fn.argtypes = ([_P] * 11 + [_LL] + [_I] * 16 + [real] * 9
                       + [ctypes.POINTER(_LL), ctypes.POINTER(_I), _P])
        fn.restype = _I
        # rows 11–13: ... outer, then the steps o0 … o1 − 1 and the parts
        # (single_loop.cuh's SlxParts) of the call, ...
        fn = getattr(lib, f"bpl_sl_tgv_{suffix}")
        fn.argtypes = ([_P] * 13 + [_LL] + [_I] * 14 + [real] * 9
                       + [ctypes.POINTER(_I), _P])
        fn.restype = _I
        fn = getattr(lib, f"bpl_sl_tvl1_{suffix}")
        fn.argtypes = ([_P] * 11 + [_LL] + [_I] * 13 + [real] * 14
                       + [ctypes.POINTER(_I), _P])
        fn.restype = _I
        fn = getattr(lib, f"bpl_sl_vtv_{suffix}")
        fn.argtypes = ([_P] * 11 + [_LL] + [_I] * 15 + [real] * 9
                       + [ctypes.POINTER(_I), _P])
        fn.restype = _I
        fn = getattr(lib, f"bpl_sl_stencil_{suffix}")
        fn.argtypes = [_I, _I, _P, _P, _LL, _I, _I, _P]
        fn.restype = _I
    lib.bpl_sl_scratch.argtypes = [_LL] + [_I] * 9
    lib.bpl_sl_scratch.restype = _LL
    for name, n_int in (("tgv", 6), ("tvl1", 6), ("vtv", 7)):
        fn = getattr(lib, f"bpl_sl_{name}_scratch")
        fn.argtypes = [_LL] + [_I] * n_int
        fn.restype = _LL
        fn = getattr(lib, f"bpl_sl_{name}_mesh_parts")
        fn.argtypes = [_LL] + [_I] * n_int + [ctypes.POINTER(_LL)]
        fn.restype = None
    lib.bpl_error_string.argtypes = [_I]
    lib.bpl_error_string.restype = ctypes.c_char_p
    lib.bpl_hypergrad_planes.argtypes = [_I]
    lib.bpl_hypergrad_planes.restype = _I
    lib.bpl_hypergrad_regions.restype = _I
    lib.bpl_hypergrad_slots.restype = _I
    lib.bpl_hypergrad_stats.restype = _I
    lib.bpl_hypergrad_grad_slot.restype = _I


def library():
    """The loaded kernel library (built on first call)."""
    global _LIB
    with _LIB_LOCK:   # a mesh's device threads may ask at once
        if _LIB is None:
            lib = ctypes.CDLL(str(build().path))
            _declare(lib)
            _LIB = lib
    return _LIB


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        msg = library().bpl_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
