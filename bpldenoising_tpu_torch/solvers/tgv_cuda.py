"""The TGV² joint-primal Chambolle–Pock solve as a CUDA kernel
(``csrc/tgv.cu``), replacing both TPU kernels of
``bpldenoising_tpu/solvers/tgv_pallas.py`` (``_make_kernel``, VMEM-resident,
and ``_make_tiled_kernel``, halo'd row tiles for large images).

:func:`tgv_denoise_pdps_cuda` takes the arguments of the JAX package's
``tgv_denoise_pdps_pallas``: scalar or (M, N) map weights, ``state0``,
``return_state``, ``tol``, ``check_every``, and a single image or a batch.
For tensors on the CPU it runs the plain :func:`.tgv._tgv_impl`; for CUDA
tensors it launches the kernel; any other device raises.  The early stop is
the plain version's: every ``check_every`` iterations, stop once the
batch-global ‖u − u_prev‖ / max(‖u_prev‖, 1) is ≤ ``tol``.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from .pdps_cuda import check_cuda_input, check_plane
from .tgv import _tgv_impl, cold_state, step_sizes

__all__ = ["tgv_denoise_pdps_cuda", "launches"]

#: calls that launched the CUDA kernel (one per solve)
launches = 0
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
    ubar = torch.empty_like(f)
    wbar = torch.empty_like(w)
    uprev = torch.empty_like(f)
    nblocks = (f.numel() + _THREADS - 1) // _THREADS
    partials = torch.empty((2 * nblocks,), dtype=dtype, device=dev)
    scal = torch.empty((3,), dtype=dtype, device=dev)
    tau, sigma = step_sizes(tau0, sigma0, dtype)
    maps = [a.data_ptr() if a.ndim else None for a in (a1, a0)]
    scalars = [float(a) if a.ndim == 0 else 0.0 for a in (a1, a0)]
    lib = _build.library()
    fn = lib.bpl_tgv_solve_f32 if dtype == torch.float32 \
        else lib.bpl_tgv_solve_f64
    iters = ctypes.c_int(0)
    global launches
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        launches += 1
        err = fn(f.data_ptr(), u.data_ptr(), w.data_ptr(), p.data_ptr(),
                 q.data_ptr(), ubar.data_ptr(), wbar.data_ptr(),
                 uprev.data_ptr(), partials.data_ptr(), scal.data_ptr(),
                 *maps, *scalars, O, M, N, float(tau), float(sigma),
                 int(maxiter), int(tol is not None),
                 0.0 if tol is None else float(tol), int(check_every),
                 ctypes.byref(iters), stream)
    _build.check(err, "tgv kernel")
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
