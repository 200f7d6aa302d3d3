"""Kernel A: the accelerated Chambolle–Pock inner solve as a CUDA kernel
(``csrc/pdps.cu``, ``csrc/pd_tile.cu``), replacing the TPU kernels
``bpldenoising_tpu/solvers/pdps_pallas.py::_make_kernel`` and
``::_make_tiled_kernel``.

:func:`denoise_pdps_cuda` takes the arguments of the plain
:func:`.pdps._denoise_pdps_impl`.  For tensors on the CPU it runs that plain
version; for CUDA tensors it launches the kernel, for any model of K ≤ 3
forward, backward or centred difference gradients without channels, each
weight a scalar or an (M, N) map (:func:`kernel_blocks`; it raises for
anything else).  τ and σ restart from τ₀/L and σ₀/L on every call; a warm
start reads ``state0 = (u, ys)`` with K duals.  The early stop is the plain
version's: every ``check_every`` iterations, stop once the max over images
of ‖Δu‖/‖u‖ is ≤ ``tol``.

The kernel runs in one of two forms, decided from the shapes before any
launch:

- the cluster form, one launch per early-stop chunk (all ``maxiter``
  iterations without ``tol``), one thread-block cluster an image, where
  :func:`.cluster_plan.pd_plan` finds that the image's bands fit in shared
  memory (the flagship's 10×128² and every 128² learn);
- the tile form elsewhere (float32 K = 1 from 320², K = 3 from 208²; float64
  from 224² and 144²): :func:`.cluster_plan.pd_tile_plan` cuts each image
  into 2-D tiles, one CTA a tile holding its state and a halo of reach·T
  pixels in shared memory, T iterations a launch.  On an H100 the two-launch
  form it replaces (two launches an iteration on state in global memory,
  which still lives in ``csrc/pdps.cu`` and runs for no shape) moves the
  whole state through device memory every iteration and is bound there; the
  tile form moves it once a launch, and is bound by the instructions its
  per-pixel passes issue and their latency at the 32 warps an SM its
  registers leave, and by the halo's recompute.

Every form gives the same iterates bit for bit.  A launch or plan that the
card refuses raises.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..models import DenoiseModel
from ..ops import BwdGradientOp, CenteredGradientOp, FwdGradientOp
from .cluster_plan import pd_plan, pd_tile_plan, stencil_reach
from .pdps import _denoise_pdps_impl, step_sizes

__all__ = ["denoise_pdps_cuda", "launches", "cluster_calls", "tiled_calls",
           "device_ops"]

#: calls that launched the CUDA kernel (one per solve)
launches = 0
#: those of them that ran the cluster form (one launch per chunk)
cluster_calls = 0
#: those of them that ran the tile form (T iterations a launch)
tiled_calls = 0
#: device operations those calls issued (launches and copies, as the C loop
#: counts them: the table copy, then per early-stop chunk 3 in the cluster
#: form, the launch, pd_change and the read of the ratios, and ⌈chunk / T⌉
#: launches, pd_change and the read in the tile form; 2 per iteration and 3
#: per chunk in the two-launch form; a last copy of u (and of the duals)
#: where it ends in another buffer)
device_ops = 0

#: the stencil kind (csrc/common.cuh: Stencil) of each gradient operator
STENCIL = {FwdGradientOp: 0, BwdGradientOp: 1, CenteredGradientOp: 2}
MAX_BLOCKS = 3


def kernel_blocks(model: DenoiseModel, alphas, like):
    """The blocks that kernels A and B take: ``(K, kinds, scalars,
    addresses, maps)``, the middle three as ctypes arrays of K; each map
    weight as a contiguous (M, N) tensor on ``like``'s device in its dtype
    (in ``maps``, which the caller keeps alive over the launch) with its
    address, each scalar weight as its value with the address 0.  Raises
    for a channel model, K > 3, other operators and weights that are
    neither scalars nor (M, N) maps."""
    kinds = [STENCIL.get(type(op)) for op in model.ops]
    if model.channels or not 1 <= model.K <= MAX_BLOCKS or None in kinds:
        raise NotImplementedError(
            "the CUDA kernels take K ≤ 3 forward, backward or centred "
            "difference gradients without channels, got "
            f"{model.name}: {[type(op).__name__ for op in model.ops]}"
            f"{' with channels' if model.channels else ''}")
    if len(alphas) != model.K:
        raise ValueError(f"expected {model.K} weights, got {len(alphas)}")
    shape = tuple(like.shape[-2:])
    scalars, addrs, maps = [], [], []
    for a in alphas:
        a = torch.as_tensor(a)
        if a.ndim == 0:
            scalars.append(float(a))
            addrs.append(0)
        elif tuple(a.shape) == shape:
            m = a.to(device=like.device, dtype=like.dtype).contiguous()
            maps.append(m)
            scalars.append(0.0)
            addrs.append(m.data_ptr())
        else:
            raise NotImplementedError(
                f"the CUDA kernels take a scalar or an {shape} weight map, "
                f"got {tuple(a.shape)}")
    real = ctypes.c_float if like.dtype == torch.float32 else ctypes.c_double
    K = model.K
    return (K, (ctypes.c_int * K)(*kinds), (real * K)(*scalars),
            (ctypes.c_longlong * K)(*addrs), maps)


def check_plane(t, shape, like, name):
    """``t`` must have ``shape`` and the dtype and device of ``like``."""
    if t.device != like.device or t.dtype != like.dtype \
            or tuple(t.shape) != tuple(shape):
        raise ValueError(
            f"{name}: expected {tuple(shape)} {like.dtype} on "
            f"{like.device}, got {tuple(t.shape)} {t.dtype} on {t.device}")


def check_cuda_input(f):
    if f.device.type != "cuda":
        raise ValueError(f"expected a CUDA tensor, got {f.device}")
    if f.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"the CUDA kernels take float32/float64, got {f.dtype}")
    if f.ndim < 2:
        raise ValueError(f"expected (..., M, N) images, got {tuple(f.shape)}")


def denoise_pdps_cuda(f, alphas, state0=None, *, model: DenoiseModel, tau0,
                      sigma0, gamma, maxiter: int, accel: bool, tol,
                      check_every: int, return_dual: bool):
    """Kernel A (CUDA tensors) or its plain version (CPU tensors).
    Returns ``u`` or, with ``return_dual``, ``(u, ys, iters)``."""
    kw = dict(model=model, tau0=tau0, sigma0=sigma0, gamma=gamma,
              maxiter=maxiter, accel=accel, tol=tol, check_every=check_every,
              return_dual=return_dual)
    if f.device.type == "cpu":
        return _denoise_pdps_impl(f, alphas, state0, **kw)
    check_cuda_input(f)
    K, kinds, scalars, addrs, _maps = kernel_blocks(model, alphas, f)
    dtype = f.dtype
    y_shape = f.shape[:-2] + (2,) + f.shape[-2:]
    f = f.contiguous()
    # the K duals packed as (K, ..., 2, M, N); ys are views of its planes
    y = torch.zeros((K,) + y_shape, dtype=dtype, device=f.device)
    if state0 is None:
        u = f.clone()
    else:
        u0, ys0 = state0
        if len(ys0) != K:
            raise ValueError(f"warm state needs {K} dual fields, got "
                             f"{len(ys0)}")
        check_plane(u0, f.shape, f, "state0 u")
        for k, yk in enumerate(ys0):
            check_plane(yk, y_shape, f, f"state0 y[{k}]")
            y[k].copy_(yk)
        u = u0.contiguous().clone()
    M, N = int(f.shape[-2]), int(f.shape[-1])
    O = f.numel() // (M * N)
    plan = pd_plan(M, N, K, f.element_size())
    # the tile form where the bands do not fit (None: the two-launch form,
    # which no shape plans)
    tile = None if plan.resident else pd_tile_plan(
        M, N, K, f.element_size(), sum(a != 0 for a in addrs),
        stencil_reach(kinds) == 2, images=O)
    # the two-launch form's ū plane, or the (τ, ω, σ) table of the others
    ubar = torch.empty_like(f) if not plan.resident and tile is None \
        else None
    tab = None if ubar is not None else torch.empty(
        (3 * max(int(maxiter), 1),), dtype=dtype, device=f.device)
    uprev = torch.empty_like(f)
    ratio = torch.empty((max(O, 1),), dtype=dtype, device=f.device)
    tau, sigma = step_sizes(model, tau0, sigma0, dtype, f.device)
    lib = _build.library()
    real = "f32" if dtype == torch.float32 else "f64"
    iters, ops = ctypes.c_int(0), ctypes.c_int(0)
    global launches, cluster_calls, tiled_calls, device_ops
    with torch.cuda.device(f.device):
        stream = torch.cuda.current_stream(f.device).cuda_stream
        with _build.COUNTS:
            launches += 1
            cluster_calls += int(plan.resident)
            tiled_calls += int(tile is not None)
        run = (float(tau), float(sigma), float(gamma), int(bool(accel)),
               int(maxiter), int(tol is not None),
               0.0 if tol is None else float(tol), int(check_every),
               ctypes.byref(iters), ctypes.byref(ops), stream)
        if tile is None:
            err = getattr(lib, f"bpl_pdps_solve_{real}")(
                f.data_ptr(), u.data_ptr(), y.data_ptr(),
                0 if ubar is None else ubar.data_ptr(), uprev.data_ptr(),
                ratio.data_ptr(), 0 if tab is None else tab.data_ptr(), O,
                M, N, K, kinds, scalars, addrs, plan.cluster, plan.rows,
                int(plan.resident), *run)
        else:
            # the second u and dual buffers of the ping-pong
            u2, y2 = torch.empty_like(u), torch.empty_like(y)
            geom = (ctypes.c_int * 10)(
                tile.rows, tile.cols, tile.T, tile.H, tile.height,
                tile.pitch, tile.tiles_m, tile.tiles_n, tile.grid,
                int(tile.tma))
            err = getattr(lib, f"bpl_pdps_tile_{real}")(
                f.data_ptr(), u.data_ptr(), y.data_ptr(), uprev.data_ptr(),
                u2.data_ptr(), y2.data_ptr(), ratio.data_ptr(),
                tab.data_ptr(), O, M, N, K, kinds, scalars, addrs, geom,
                *run)
    with _build.COUNTS:
        device_ops += ops.value
    _build.check(err, f"pdps kernel ({plan if tile is None else tile})")
    if return_dual:
        return u, tuple(y.unbind(0)), int(iters.value)
    return u
