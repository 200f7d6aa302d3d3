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
on either device.  The differentiable layer (``make_diff_vtv_denoise``,
``diff_vtv_denoise``) is not ported yet.
"""

from __future__ import annotations

import torch

from ..ops import FwdGradientOp, scalarprod, xi
from .krylov import cg_batched

__all__ = ["vtv_implicit_cotangents"]

_GRAD = FwdGradientOp()
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
    if a.ndim >= 2:
        da = torch.sum(g_map.reshape((-1,) + tuple(g_map.shape[-2:])),
                       dim=0)
    else:
        da = torch.sum(g_map)
    out = lam, da
    if return_lam:
        out = out + (lam,)
    if return_info:
        out = out + (info,)
    return out
