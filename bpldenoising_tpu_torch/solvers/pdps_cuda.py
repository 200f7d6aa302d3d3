"""Kernel A: the accelerated Chambolle–Pock inner solve as a CUDA kernel
(``csrc/pdps.cu``), replacing the TPU kernel
``bpldenoising_tpu/solvers/pdps_pallas.py::_make_kernel``.

:func:`denoise_pdps_cuda` takes the arguments of the plain
:func:`.pdps._denoise_pdps_impl`.  For tensors on the CPU it runs that plain
version; for CUDA tensors it launches the kernel (or raises for inputs the
kernel does not take: K > 1, α maps, other dtypes).  τ and σ restart from
τ₀/L and σ₀/L on every call; a warm start reads ``state0 = (u, ys)``.
The early stop is the plain version's: every ``check_every`` iterations,
stop once the max over images of ‖Δu‖/‖u‖ is ≤ ``tol``.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..models import DenoiseModel
from ..ops import FwdGradientOp
from .pdps import _denoise_pdps_impl, step_sizes

__all__ = ["denoise_pdps_cuda", "launches"]

#: calls that launched the CUDA kernel (one per solve)
launches = 0


def scalar_alpha(alphas, K_expected: int = 1) -> float:
    """The one scalar α the CUDA kernels take."""
    if len(alphas) != K_expected:
        raise NotImplementedError(
            f"the CUDA kernels take K={K_expected} regularizer, got "
            f"{len(alphas)}")
    a = torch.as_tensor(alphas[0])
    if a.ndim != 0:
        raise NotImplementedError(
            "the CUDA kernels take a scalar α, not an α map")
    return float(a)


def check_tv_model(model: DenoiseModel) -> None:
    if model.K != 1 or type(model.ops[0]) is not FwdGradientOp \
            or model.channels:
        raise NotImplementedError(
            "the CUDA kernels implement the scalar TV model (one "
            "forward-difference gradient, no channels)")


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
    check_tv_model(model)
    alpha = scalar_alpha(alphas)
    dtype = f.dtype
    y_shape = f.shape[:-2] + (2,) + f.shape[-2:]
    f = f.contiguous()
    if state0 is None:
        u = f.clone()
        y = torch.zeros(y_shape, dtype=dtype, device=f.device)
    else:
        u0, ys0 = state0
        if len(ys0) != 1:
            raise ValueError("warm state needs one dual field")
        check_plane(u0, f.shape, f, "state0 u")
        check_plane(ys0[0], y_shape, f, "state0 y")
        u = u0.contiguous().clone()
        y = ys0[0].contiguous().clone()
    M, N = int(f.shape[-2]), int(f.shape[-1])
    O = f.numel() // (M * N)
    ubar = torch.empty_like(f)
    uprev = torch.empty_like(f)
    ratio = torch.empty((max(O, 1),), dtype=dtype, device=f.device)
    tau, sigma = step_sizes(model, tau0, sigma0, dtype, f.device)
    lib = _build.library()
    fn = lib.bpl_pdps_solve_f32 if dtype == torch.float32 \
        else lib.bpl_pdps_solve_f64
    iters = ctypes.c_int(0)
    global launches
    with torch.cuda.device(f.device):
        stream = torch.cuda.current_stream(f.device).cuda_stream
        launches += 1
        err = fn(f.data_ptr(), u.data_ptr(), y.data_ptr(), ubar.data_ptr(),
                 uprev.data_ptr(), ratio.data_ptr(), O, M, N, alpha,
                 float(tau), float(sigma), float(gamma), int(bool(accel)),
                 int(maxiter), int(tol is not None),
                 0.0 if tol is None else float(tol), int(check_every),
                 ctypes.byref(iters), stream)
    _build.check(err, "pdps kernel")
    if return_dual:
        return u, (y,), int(iters.value)
    return u
