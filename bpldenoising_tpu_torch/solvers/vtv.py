"""Vectorial (color) TV: implicit differentiation of the smoothed model
(counterpart of ``bpldenoising_tpu.solvers.vtv``).

Images are ``(..., C, M, N)`` stacks and the regularizer couples channels
through a per-pixel Frobenius norm over (channel, component),

    min_u  ½‖u − f‖² + Σ_pix α·‖(∇u)_pix‖_F .

The forward solve is :func:`.pdps.vtv_denoise` (the CUDA kernel of
:mod:`.vtv_cuda` on the card).  The hypergradient differentiates the
γ-Huber smoothed optimality system

    F(u; α, f) = u − f + ∇ᵀ(α ψ(∇u)) = 0,   ψ(y) = y / max(‖y‖_F, γ),

with one Jacobi-preconditioned CG solve over the C stacked channel planes
and per-image inner products (``cg_batched(item_ndim=3)``), plain PyTorch
on either device.  The differentiable layer :func:`make_diff_vtv_denoise`
/ :func:`diff_vtv_denoise` (:class:`.implicit.ImplicitLayer`) runs that
solve as its backward and :func:`.pdps.denoise_pdps` on
:func:`..models.vtv_model` (the VTV kernel on the card) as its forward.
"""

from __future__ import annotations

import torch

from ..models import vtv_model
from ..ops import FwdGradientOp, scalarprod, xi
from .implicit import (ImplicitLayer, check_layer_backend, reduce_like,
                       weight_like)
from .krylov import cg_batched
from .pdps import denoise_pdps

__all__ = ["vtv_implicit_cotangents", "make_diff_vtv_denoise",
           "diff_vtv_denoise"]

_GRAD = FwdGradientOp()
_VTV = vtv_model()
_AXES = (-4, -3)   # (channel, component): the Frobenius coupling


def _dpsi_coupled(field, gamma):
    """γ-Huber gradient ψ and its Jacobian action at a coupled field.

    ``field`` is (..., C, 2, M, N); the norm couples (channel, component):
    ψ(y) = y / max(‖y‖_F, γ);  Dψ(d) = s·d − 1[‖y‖≥γ]·y (y·d)_F s³ with
    s = 1/max(‖y‖_F, γ).  The rank-one term ties all channels of a pixel
    together.
    """
    nrm = xi(field, axes=_AXES)
    s = 1.0 / torch.clamp(nrm, min=gamma)
    mask = (nrm >= gamma).to(field.dtype)
    psi = field * s[..., None, None, :, :]

    def jac(d):
        rad = mask * scalarprod(field, d, axes=_AXES) * s ** 3
        return (s[..., None, None, :, :] * d
                - field * rad[..., None, None, :, :])

    return psi, s, jac


def vtv_implicit_cotangents(u, alpha, v, *, gamma: float = 1e-4,
                            cg_tol: float = 1e-6, cg_maxiter: int = 1000,
                            lam0=None, return_lam: bool = False,
                            return_info: bool = False):
    """Implicit-function-theorem cotangents at a VTV solution ``u``.

    Given the loss cotangent ``v = ∂J/∂u`` (shaped like u, (..., C, M, N)),
    solves the SPD smoothed system H λ = v once and returns ``(df, dα)``
    with ``dα`` shaped like ``alpha`` (a scalar, or a batch-summed (M, N)
    map).  ``lam0`` warm-starts the adjoint CG (``return_lam=True``
    appends the multiplier); ``return_info=True`` appends the solve's
    :class:`.krylov.KrylovInfo`.
    """
    a = torch.as_tensor(alpha, dtype=u.dtype).to(u.device)
    g = _GRAD.apply(u)                       # (..., C, 2, M, N)
    psi, s, Dj = _dpsi_coupled(g, gamma)

    def H(x):
        # α (a scalar or an (M, N) map) multiplies inside the stencil
        # adjoint, which keeps H symmetric
        return x + _GRAD.apply_adjoint(a * Dj(_GRAD.apply(x)))

    # Jacobi preconditioner (the isotropic part of Dψ); s is per pixel and
    # shared by the channels, so one (..., M, N) diagonal serves them all
    a_s = a * s
    diag = 1.0 + _GRAD.gram_diag(torch.stack([a_s, a_s], dim=-3))
    diag = diag[..., None, :, :]

    lam, info = cg_batched(H, v, x0=lam0, tol=cg_tol, maxiter=cg_maxiter,
                           M=lambda r: r / diag, item_ndim=3)

    g_map = -scalarprod(psi, _GRAD.apply(lam), axes=_AXES)   # (..., M, N)
    out = lam, reduce_like(g_map, a)
    if return_lam:
        out = out + (lam,)
    if return_info:
        out = out + (info,)
    return out


def make_diff_vtv_denoise(maxiter: int = 5000, gamma: float = 1e-4,
                          cg_tol: float = 1e-6, cg_maxiter: int = 1000,
                          tau0: float = 5.0, sigma0: float = 0.99 / 5.0,
                          tol=None, check_every: int = 500,
                          backend: str = "auto", interpret: bool = False):
    """Differentiable VTV denoiser ``(f, α) → u`` (batched
    ``(..., C, M, N)``; gradients flow to f and α through one coupled CG
    solve).  The forward is :func:`.pdps.denoise_pdps` on
    :func:`..models.vtv_model` where ``f`` lives (the VTV kernel on the
    card); ``backend`` and ``interpret`` follow
    :func:`.implicit.check_layer_backend`."""
    check_layer_backend(backend, interpret)

    def solve(f, alphas):
        return denoise_pdps(f, alphas, _VTV, tau0=tau0, sigma0=sigma0,
                            maxiter=maxiter, tol=tol,
                            check_every=check_every), None

    def cotangents(u, f, alphas, extra, v):
        df, da = vtv_implicit_cotangents(u, alphas[0], v, gamma=gamma,
                                         cg_tol=cg_tol,
                                         cg_maxiter=cg_maxiter)
        return df, (da,)

    def layer(f, alpha):
        return ImplicitLayer.apply(solve, cotangents, f, alpha)

    return layer


def diff_vtv_denoise(f, alpha, maxiter: int = 5000):
    """Differentiable vectorial-TV denoising (companion to
    :func:`.implicit.diff_tv_denoise` / :func:`.tgv.diff_tgv_denoise`)."""
    f = torch.as_tensor(f)
    return make_diff_vtv_denoise(maxiter=maxiter)(f, weight_like(alpha, f))
