"""The TGV² joint-primal Chambolle–Pock solve as a CUDA kernel
(``csrc/tgv.cu``, ``csrc/tgv_tile.cu``), replacing both TPU kernels of
``bpldenoising_tpu/solvers/tgv_pallas.py`` (``_make_kernel``, VMEM-resident,
and ``_make_tiled_kernel``, halo'd row tiles for large images).

:func:`tgv_denoise_pdps_cuda` takes the arguments of the JAX package's
``tgv_denoise_pdps_pallas``: scalar or (M, N) map weights, ``state0``,
``return_state``, ``tol``, ``check_every``, and a single image or a batch.
For tensors on the CPU it runs the plain :func:`.tgv._tgv_impl`; for CUDA
tensors it launches the kernel (a build or launch failure raises); any
other device raises.  The early stop is the plain version's: every
``check_every`` iterations, stop once the batch-global
‖u − u_prev‖ / max(‖u_prev‖, 1) is ≤ ``tol``.

The kernel runs in one of two forms, decided from the shapes before any
launch:

- the cluster form, one launch per early-stop chunk (all ``maxiter``
  iterations without ``tol``), one thread-block cluster an image on the
  bands of ``csrc/tgv_cluster.cuh``, where :func:`.cluster_plan.tgv_plan`
  finds that the image's bands fit in shared memory (float32 up to 224²,
  float64 up to 128²: every 128² learn);
- the tile form elsewhere (float32 from 240², float64 from 160²):
  :func:`.cluster_plan.tgv_tile_plan` cuts each image into 2-D tiles, one
  CTA a tile holding its state and a halo of T pixels in shared memory,
  T iterations a launch.  The two-launch form it replaces (two launches an
  iteration on state in global memory, which still lives in
  ``csrc/tgv.cu`` and runs for no shape) moves the whole state through
  device memory every iteration; the tile form moves it once a launch.

Every form gives the same iterates and iteration counts bit for bit.  A
launch or plan that the card refuses raises.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from .cluster_plan import tgv_plan, tgv_tile_plan
from .pdps_cuda import check_cuda_input, check_plane
from .tgv import _tgv_impl, cold_state, step_sizes

__all__ = ["tgv_denoise_pdps_cuda", "launches", "cluster_calls",
           "tiled_calls", "device_ops"]

#: calls that launched the CUDA kernel (one per solve, any form)
launches = 0
#: those of them that ran the cluster form (one launch per chunk)
cluster_calls = 0
#: those of them that ran the tile form (T iterations a launch)
tiled_calls = 0
#: device operations those calls issued (launches and copies, as the C loop
#: counts them: per early-stop chunk 4 in the cluster form, the launch, the
#: two passes of the sums and the read; ⌈chunk / T⌉ launches and 3 in the
#: tile form; 2 per iteration and 4 per chunk in the two-launch form, whose
#: chunk starts with a copy; a last copy of u, and in the tile form of w, p
#: and q, when they end in another buffer)
device_ops = 0
_THREADS = 256   # BPL_THREADS in csrc/common.cuh


def _weight(a, f, name):
    """A scalar or an (M, N) map in f's dtype (maps on f's device)."""
    a = torch.as_tensor(a, dtype=f.dtype)
    if a.ndim == 0:
        return a
    if a.ndim == 2 and tuple(a.shape) == tuple(f.shape[-2:]):
        return a.to(f.device).contiguous()
    raise ValueError(f"{name} must be a scalar or an (M, N) map of the "
                     f"image shape {tuple(f.shape[-2:])}, got "
                     f"{tuple(a.shape)}")


def _launch(f, a1, a0, state0, *, tau0, sigma0, maxiter, tol, check_every):
    check_cuda_input(f)
    dtype, dev = f.dtype, f.device
    f = f.contiguous()
    M, N = int(f.shape[-2]), int(f.shape[-1])
    O = f.numel() // (M * N)
    shapes = (f.shape, f.shape[:-2] + (2,) + f.shape[-2:],
              f.shape[:-2] + (2,) + f.shape[-2:],
              f.shape[:-2] + (3,) + f.shape[-2:])
    if state0 is None:
        state = tuple(s.clone() for s in cold_state(f))
    else:
        if len(state0) != 4:
            raise ValueError("a TGV state is (u, w, p, q)")
        for s, shape, name in zip(state0, shapes, "uwpq"):
            check_plane(s, shape, f, f"state0 {name}")
        state = tuple(s.contiguous().clone() for s in state0)
    u, w, p, q = state
    plan = tgv_plan(M, N, f.element_size())
    maps = [a.data_ptr() if a.ndim else None for a in (a1, a0)]
    # the tile form where the bands do not fit (None: the two-launch form,
    # which no shape plans)
    tile = None if plan.resident else tgv_tile_plan(
        M, N, f.element_size(), sum(m is not None for m in maps), O)
    # the two-launch form's ū and w̄ planes; u's second buffer for the
    # early stop (the tile form's second u buffer)
    two = not plan.resident and tile is None
    ubar = torch.empty_like(f) if two else None
    wbar = torch.empty_like(w) if two else None
    uprev = torch.empty_like(f) if tol is not None or tile is not None \
        else None
    nblocks = (f.numel() + _THREADS - 1) // _THREADS
    partials = torch.empty((2 * nblocks,), dtype=dtype, device=dev)
    scal = torch.empty((3,), dtype=dtype, device=dev)
    tau, sigma = step_sizes(tau0, sigma0, dtype)
    scalars = [float(a) if a.ndim == 0 else 0.0 for a in (a1, a0)]
    lib = _build.library()
    real = "f32" if dtype == torch.float32 else "f64"
    iters, ops = ctypes.c_int(0), ctypes.c_int(0)
    global launches, cluster_calls, tiled_calls, device_ops
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        with _build.COUNTS:
            launches += 1
            cluster_calls += int(plan.resident)
            tiled_calls += int(tile is not None)
        run = (float(tau), float(sigma), int(maxiter), int(tol is not None),
               0.0 if tol is None else float(tol), int(check_every),
               ctypes.byref(iters), ctypes.byref(ops), stream)
        if tile is None:
            err = getattr(lib, f"bpl_tgv_solve_{real}")(
                f.data_ptr(), u.data_ptr(), w.data_ptr(), p.data_ptr(),
                q.data_ptr(), None if ubar is None else ubar.data_ptr(),
                None if wbar is None else wbar.data_ptr(),
                None if uprev is None else uprev.data_ptr(),
                partials.data_ptr(), scal.data_ptr(), *maps, *scalars, O,
                M, N, plan.cluster, plan.rows, int(plan.resident), *run)
        else:
            # the second buffers of the ping-pong: u's third, w's, p's, q's
            second = [torch.empty_like(x) for x in (u, w, p, q)]
            geom = (ctypes.c_int * 10)(
                tile.rows, tile.cols, tile.T, tile.H, tile.height,
                tile.pitch, tile.tiles_m, tile.tiles_n, tile.grid,
                int(tile.tma))
            err = getattr(lib, f"bpl_tgv_tile_{real}")(
                f.data_ptr(), u.data_ptr(), w.data_ptr(), p.data_ptr(),
                q.data_ptr(), uprev.data_ptr(),
                *(x.data_ptr() for x in second), partials.data_ptr(),
                scal.data_ptr(), *maps, *scalars, O, M, N, geom, *run)
    with _build.COUNTS:
        device_ops += ops.value
    _build.check(err, f"tgv kernel ({plan if tile is None else tile})")
    return u, w, state, int(iters.value)


def tgv_denoise_pdps_cuda(f, alpha1, alpha0, *, tau0=0.99, sigma0=0.99,
                          maxiter: int = 5000, tol=None,
                          check_every: int = 500, state0=None,
                          return_state: bool = False):
    """The TGV² kernel (CUDA tensors) or its plain version (CPU tensors)
    on an (M, N) image or an (O, M, N) batch.

    Returns ``(u, w)``; with ``return_state``, ``(u, w, state, iters)``
    where ``state = (u, w, p, q)`` chains into a later call's ``state0``.
    """
    if f.device.type not in ("cpu", "cuda"):
        raise ValueError(f"expected a CPU or CUDA tensor, got {f.device}")
    squeeze = f.ndim == 2
    if squeeze:
        f = f[None]
        if state0 is not None:
            state0 = tuple(s[None] for s in state0)
    a1 = _weight(alpha1, f, "alpha1")
    a0 = _weight(alpha0, f, "alpha0")
    kw = dict(tau0=tau0, sigma0=sigma0, maxiter=int(maxiter), tol=tol,
              check_every=int(check_every))
    if f.device.type == "cpu":
        u, w, state, iters = _tgv_impl(f, a1, a0, state0, return_state=True,
                                       **kw)
    else:
        u, w, state, iters = _launch(f, a1, a0, state0, **kw)
    if squeeze:
        u, w = u[0], w[0]
        state = tuple(s[0] for s in state)
    if return_state:
        return u, w, state, iters
    return u, w
