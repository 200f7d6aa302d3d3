"""Hypergradients dJ/dα via adjoint (KKT) systems: the plain PyTorch
version (counterpart of ``bpldenoising_tpu.solvers.hypergrad``).

For the upper-level loss J(α) = ½‖u(α) − ū‖², block elimination of the
active-set KKT system leaves one SPD system per batch

    M p = u − ū,    M = I + Σₖ Gₖᵀ [ μ·actₖ + inactₖ·αₖ·Hₖ ] Gₖ

with Hₖ v = v/denₖ − Guₖ (Guₖ·v)/denₖ³ the per-pixel curvature block and
μ a penalty on the active (|∇u| < act_tol) constraint whose exactness comes
from an augmented-Lagrangian multiplier loop.  The γ-regularized (Huber)
form swaps the roles of the sets (act = |∇u| > 1/γ):

    M_reg p = ū − u,   M_reg = I + Σₖ αₖ ⊙ Gₖᵀ (γ·inactₖ + actₖ·Hₖ) Gₖ.

Both are solved by Jacobi-preconditioned CG whose inner products run over
the whole batch (one joint system).  This module is the plain version of
the CUDA kernel in :mod:`.hypergrad_cuda`, which dispatches here for
tensors on the CPU.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..models import DenoiseModel
from ..ops import scalarprod, xi
from .krylov import cg

__all__ = ["exact_hypergrad", "reg_hypergrad", "build_reg_system",
           "HypergradConfig"]


class HypergradConfig(NamedTuple):
    """Knobs for the hypergradient solves; ``None`` means "derive from the
    dtype" (see :func:`_defaults`)."""
    act_tol: float | None = None    # active-set threshold
    mu: float | None = None         # augmented-Lagrangian penalty
    al_iters: int = 4               # multiplier updates; 1 = pure penalty
    gamma: float = 1e8              # Huber smoothing
    cg_tol: float | None = None
    cg_maxiter: int = 2000


def _defaults(dtype, cfg: HypergradConfig):
    """(act_tol, μ, cg_tol) for the working dtype."""
    f64 = dtype == torch.float64
    act_tol = cfg.act_tol if cfg.act_tol is not None else (
        1e-9 if f64 else 1e-6)
    mu = cfg.mu if cfg.mu is not None else (1e3 if f64 else 1e2)
    cg_tol = cfg.cg_tol if cfg.cg_tol is not None else (1e-8 if f64 else 1e-5)
    return act_tol, mu, cg_tol


def _bcast(m):
    """(…, M, N) pixel map → broadcastable over the component axis."""
    return m[..., None, :, :]


def _curvature_apply(Gu, den, v):
    """Per-pixel symmetric PSD block Hv = v/den − Gu (Gu·v)/den³."""
    inv_den = 1.0 / den
    return v * _bcast(inv_den) - Gu * _bcast(scalarprod(Gu, v) * inv_den ** 3)


def _as_dual_alpha(alpha, dtype):
    """α (scalar or (M, N) map) → broadcastable in dual space."""
    a = torch.as_tensor(alpha, dtype=dtype)
    return _bcast(a) if a.ndim >= 2 else a


def exact_hypergrad(u, utrue, alphas, model: DenoiseModel,
                    cfg: HypergradConfig = HypergradConfig(),
                    want_maps: bool = False, p0=None):
    """Active-set adjoint hypergradient with the augmented-Lagrangian
    multiplier loop λₖ ← λₖ + μ·actₖ·(Gₖp) around the SPD CG solve.

    ``u``/``utrue`` are an image or a batch (one joint system);
    ``alphas`` a K-tuple of scalars or (M, N) maps; ``p0`` warm-starts CG.
    Returns ``(grads, p, info)``: K scalar gradients (or per-pixel maps
    with ``want_maps``), the adjoint ``p`` and the last solve's
    :class:`KrylovInfo`.
    """
    dtype = u.dtype
    act_tol, mu, cg_tol = _defaults(dtype, cfg)

    pieces = []
    for op, alpha in zip(model.ops, alphas):
        Gu = op.apply(u)
        nGu = xi(Gu)
        act = (nGu < act_tol).to(dtype)
        inact = 1.0 - act
        den = torch.where(act > 0, 1.0, nGu)
        a_dual = _as_dual_alpha(alpha, dtype)
        pieces.append((op, Gu, act, inact, den, a_dual))

    def M_apply(p):
        out = p
        for op, Gu, act, inact, den, a_dual in pieces:
            Gp = op.apply(p)
            w = (mu * _bcast(act)) * Gp \
                + _bcast(inact) * a_dual * _curvature_apply(Gu, den, Gp)
            out = out + op.apply_adjoint(w)
        return out

    # Jacobi preconditioner from exact stencil Gram diagonals
    diag = torch.ones_like(u)
    for op, Gu, act, inact, den, a_dual in pieces:
        h_diag = _bcast(1.0 / den) - Gu ** 2 * _bcast(1.0 / den ** 3)
        w_diag = mu * _bcast(act) + _bcast(inact) * a_dual * h_diag
        diag = diag + op.gram_diag(w_diag)
    inv_diag = 1.0 / diag

    rhs = u - utrue
    p = torch.zeros_like(u) if p0 is None else p0
    lams = tuple(torch.zeros_like(Gu) for _, Gu, *_ in pieces)
    info = None
    n_al = max(1, int(cfg.al_iters))
    for i in range(n_al):
        r = rhs
        for (op, _, act, *_), lam in zip(pieces, lams):
            r = r - op.apply_adjoint(_bcast(act) * lam)
        p, info = cg(M_apply, r, x0=p, tol=cg_tol, maxiter=cfg.cg_maxiter,
                     M=lambda r_: inv_diag * r_)
        if i < n_al - 1:   # the final update would be dead (grads use p)
            lams = tuple(lam + mu * _bcast(act) * op.apply(p)
                         for (op, _, act, *_), lam in zip(pieces, lams))

    grads = []
    for op, Gu, act, inact, den, a_dual in pieces:
        field = _bcast(inact / den) * Gu
        gmap = -scalarprod(op.apply(p), field)
        grads.append(gmap if want_maps else torch.sum(gmap))
    return tuple(grads), p, info


def build_reg_system(u, alphas, model: DenoiseModel, gamma):
    """The γ-smoothed adjoint system at ``u``: ``(M_apply, inv_diag,
    fields)`` with M = I + Σₖ Gₖᵀ αₖ Wₖ Gₖ, its Jacobi preconditioner and
    the per-k dual direction fields used for the α-derivative."""
    dtype = u.dtype
    gamma = torch.tensor(gamma, dtype=dtype)

    pieces = []
    for op, alpha in zip(model.ops, alphas):
        Gu = op.apply(u)
        nGu = xi(Gu)
        act = (nGu > 1.0 / gamma).to(dtype)   # roles swapped vs exact
        inact = 1.0 - act
        den = torch.where(act > 0, nGu, 1.0)
        a_dual = _as_dual_alpha(alpha, dtype)
        pieces.append((op, Gu, act, inact, den, a_dual))

    def M_apply(p):
        out = p
        for op, Gu, act, inact, den, a_dual in pieces:
            Gp = op.apply(p)
            w = a_dual * ((gamma * _bcast(inact)) * Gp
                          + _bcast(act) * _curvature_apply(Gu, den, Gp))
            out = out + op.apply_adjoint(w)
        return out

    diag = torch.ones_like(u)
    for op, Gu, act, inact, den, a_dual in pieces:
        h_diag = _bcast(1.0 / den) - Gu ** 2 * _bcast(1.0 / den ** 3)
        w_diag = a_dual * (gamma * _bcast(inact) + _bcast(act) * h_diag)
        diag = diag + op.gram_diag(w_diag)
    inv_diag = 1.0 / diag

    fields = tuple(
        _bcast(act / den) * Gu + gamma * _bcast(inact) * Gu
        for op, Gu, act, inact, den, a_dual in pieces)
    return M_apply, inv_diag, fields


def reg_hypergrad(u, utrue, alphas, model: DenoiseModel,
                  cfg: HypergradConfig = HypergradConfig(),
                  want_maps: bool = False, p0=None):
    """γ-smoothed hypergradient: one CG solve on ū − u, positive sign."""
    dtype = u.dtype
    _, _, cg_tol = _defaults(dtype, cfg)
    M_apply, inv_diag, fields = build_reg_system(u, alphas, model, cfg.gamma)

    rhs = utrue - u
    p, info = cg(M_apply, rhs, x0=p0, tol=cg_tol, maxiter=cfg.cg_maxiter,
                 M=lambda r: inv_diag * r)

    grads = []
    for op, field in zip(model.ops, fields):
        gmap = scalarprod(op.apply(p), field)
        grads.append(gmap if want_maps else torch.sum(gmap))
    return tuple(grads), p, info
