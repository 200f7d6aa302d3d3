"""Accelerated primal–dual (Chambolle–Pock / PDPS) denoising solver: the
plain PyTorch version (counterpart of ``bpldenoising_tpu.solvers.pdps``).

Solves, for K regularizer blocks,

    min_u  ½‖u − f‖² + Σₖ ‖αₖ Gₖ u‖_{2,1}

with the strongly-convex-accelerated iteration (γ = 1):

    u⁺   = (u − τ(Σₖ Gₖᵀ yₖ − f)) / (1 + τ)
    ω    = 1/√(1 + 2γτ);   τ ← τω;   σ ← σ/ω
    ū    = (1 + ω) u⁺ − ω u
    yₖ⁺  = Π_{|·|₂ ≤ αₖ}(yₖ + σ Gₖ ū)

This module is the plain version of the CUDA kernels in :mod:`.pdps_cuda`
(TV and the sum of regularizers: K ≤ 3 stencils, scalar or map weights)
and :mod:`.vtv_cuda` (vectorial TV on ``vtv_model()``, whose dual ball
couples the channels of a pixel), which dispatch here for tensors on the
CPU; :func:`denoise_pdps`, :func:`tv_denoise`, :func:`sumregs_denoise` and
:func:`vtv_denoise` go through that dispatch.  The
optional early stop runs chunks of ``check_every`` iterations and stops once
the MAX over images of the per-image relative change ‖Δu‖/‖u‖ is ≤ ``tol``:
one host read per chunk.
"""

from __future__ import annotations

import math

import torch

from ..models import DenoiseModel, sumregs_model, tv_model, vtv_model
from ..ops import FwdGradientOp, proj_norm21_ball

__all__ = ["denoise_pdps", "tv_denoise", "sumregs_denoise", "vtv_denoise",
           "PDPS_DEFAULTS"]

PDPS_DEFAULTS = dict(tau0=5.0, sigma0=0.99 / 5.0, accel=True, gamma=1.0,
                     maxiter=5000)


def step_sizes(model: DenoiseModel, tau0, sigma0, dtype, device):
    """Initial (τ, σ) = (τ₀/L, σ₀/L), L = √‖G‖², in the working dtype."""
    L = torch.sqrt(torch.tensor(model.opnorm_sq(), dtype=dtype, device=device))
    tau = torch.tensor(tau0, dtype=dtype, device=device) / L
    sigma = torch.tensor(sigma0, dtype=dtype, device=device) / L
    return tau, sigma


def _pdps_step(model: DenoiseModel, f, alphas, accel: bool, gamma: float,
               state):
    u, ys, tau, sigma = state
    div = None
    for op, y in zip(model.ops, ys):
        d = op.apply_adjoint(y)
        div = d if div is None else div + d
    u_new = (u - tau * (div - f)) / (1.0 + tau)
    if accel:
        omega = 1.0 / torch.sqrt(1.0 + 2.0 * gamma * tau)
        tau = tau * omega
        sigma = sigma / omega
    else:
        omega = torch.ones((), dtype=u.dtype, device=u.device)
    ubar = (1.0 + omega) * u_new - omega * u
    ys_new = tuple(
        proj_norm21_ball(y + sigma * op.apply(ubar), a, axes=model.norm_axes)
        for op, y, a in zip(model.ops, ys, alphas))
    return (u_new, ys_new, tau, sigma)


def relative_change(u, u_prev):
    """max over images of ‖u − u_prev‖ / max(‖u‖, 1e-12) (a 0-d tensor)."""
    lead = u_prev.shape[:-2] + (-1,)
    num = torch.linalg.norm((u - u_prev).reshape(lead), dim=-1)
    den = torch.clamp(torch.linalg.norm(u.reshape(lead), dim=-1), min=1e-12)
    return torch.max(num / den)


def _denoise_pdps_impl(f, alphas, state0=None, *, model: DenoiseModel, tau0,
                       sigma0, gamma, maxiter: int, accel: bool, tol,
                       check_every: int, return_dual: bool):
    """Returns ``u`` or, with ``return_dual``, ``(u, ys, iters)``."""
    dtype = f.dtype
    tau, sigma = step_sizes(model, tau0, sigma0, dtype, f.device)
    if state0 is not None:
        u0, ys0 = state0
    else:
        u0 = f
        ys0 = tuple(torch.zeros(f.shape[:-2] + (2,) + f.shape[-2:],
                                dtype=dtype, device=f.device)
                    for _ in range(model.K))
    state = (u0, tuple(ys0), tau, sigma)

    def step(s):
        return _pdps_step(model, f, alphas, accel, gamma, s)

    if tol is None:
        for _ in range(maxiter):
            state = step(state)
        iters = int(maxiter)
    else:
        tol_t = torch.tensor(tol, dtype=dtype)
        iters = 0
        delta = torch.tensor(math.inf, dtype=dtype)
        while iters < maxiter and bool(delta.cpu() > tol_t):
            u_prev = state[0]
            n_steps = min(int(check_every), maxiter - iters)
            for _ in range(n_steps):
                state = step(state)
            delta = relative_change(state[0], u_prev)
            iters += n_steps

    u, ys, _, _ = state
    if return_dual:
        return u, ys, iters
    return u


def denoise_pdps(f, alphas, model: DenoiseModel, *, tau0=5.0,
                 sigma0=0.99 / 5.0, gamma=1.0, maxiter=5000, accel=True,
                 tol=None, check_every=500, state0=None, return_dual=False):
    """Solve the K-block denoising problem for an image or batch ``f``
    where it lives: the plain PyTorch iteration for CPU tensors; for CUDA
    tensors the VTV kernel on the vectorial-TV model and kernel A on any
    other (each raises for what it does not take).  ``alphas`` as
    :meth:`DenoiseModel.canonical_alphas` reads them: per block a scalar
    or an (M, N) map."""
    from .pdps_cuda import denoise_pdps_cuda
    from .vtv_cuda import vtv_denoise_pdps_cuda
    f = torch.as_tensor(f)
    alphas = tuple(torch.as_tensor(a, dtype=f.dtype)
                   for a in model.canonical_alphas(alphas))
    if model.channels and model.K == 1 \
            and type(model.ops[0]) is FwdGradientOp:
        return vtv_denoise_pdps_cuda(
            f, alphas, state0, tau0=tau0, sigma0=sigma0, gamma=gamma,
            maxiter=int(maxiter), accel=bool(accel), tol=tol,
            check_every=int(check_every), return_dual=bool(return_dual))
    return denoise_pdps_cuda(
        f, alphas, state0, model=model, tau0=tau0, sigma0=sigma0, gamma=gamma,
        maxiter=int(maxiter), accel=bool(accel), tol=tol,
        check_every=int(check_every), return_dual=bool(return_dual))


_TV = tv_model()


def tv_denoise(f, alpha, **kwargs):
    """TV denoising; ``alpha`` is a scalar or a full-image ``(M, N)`` map."""
    return denoise_pdps(f, alpha, _TV, **kwargs)


_SUMREGS = sumregs_model()


def sumregs_denoise(f, alphas, **kwargs):
    """Denoising with the sum of the forward, backward and centred TV terms;
    ``alphas`` is a (3,) vector, three scalars or maps, or an (M, N, 3)
    stack."""
    return denoise_pdps(f, alphas, _SUMREGS, **kwargs)


_VTV = vtv_model()


def vtv_denoise(f, alpha, **kwargs):
    """Vectorial (color) TV denoising of an ``(..., C, M, N)`` stack, the
    channels coupled through the per-pixel Frobenius dual ball; ``alpha``
    is a scalar or an (M, N) map."""
    return denoise_pdps(f, alpha, _VTV, **kwargs)
