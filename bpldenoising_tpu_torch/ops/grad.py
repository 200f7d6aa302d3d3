"""Finite-difference gradient operators (counterpart of
``bpldenoising_tpu.ops.grad``).

Conventions (Neumann boundary):

* shape: image ``(..., M, N)`` → gradient field ``(..., 2, M, N)``;
  component 0 differentiates dim ``-2`` (rows), component 1 dim ``-1``.
* forward:  ``(D⁺u)[i] = u[i+1] - u[i]``, zero at the last index.
* backward: ``(D⁻u)[i] = u[i] - u[i-1]``, zero at the first index.
* centered: ``(D⁰u)[i] = (u[i+1] - u[i-1])/2`` in the interior, zero at both
  boundary indices.

Operator norms (2-D): ``‖∇⁺‖² = ‖∇⁻‖² ≤ 8``, ``‖∇⁰‖² ≤ 2``.
"""

from __future__ import annotations

import math

import torch

from .linop import LinOp, StatelessOpMixin

__all__ = ["FwdGradientOp", "BwdGradientOp", "CenteredGradientOp",
           "GradientOp"]


def _sl(u, dim, start, stop=None):
    n = u.shape[dim]
    stop = n if stop is None else (stop if stop >= 0 else n + stop)
    return u.narrow(dim, start, stop - start)


def _zeros_slice(u, dim):
    return torch.zeros_like(_sl(u, dim, 0, 1))


def dplus(u, dim):
    """Forward difference, zero at last index."""
    d = _sl(u, dim, 1) - _sl(u, dim, 0, -1)
    return torch.cat([d, _zeros_slice(u, dim)], dim=dim)


def dplus_T(p, dim):
    """Adjoint of :func:`dplus`: ``-p[0]; p[i-1]-p[i]; p[M-2]``."""
    pm = _sl(p, dim, 0, -1)
    z = _zeros_slice(p, dim)
    a = torch.cat([z, pm], dim=dim)
    b = torch.cat([pm, z], dim=dim)
    return a - b


def dminus(u, dim):
    """Backward difference, zero at first index."""
    d = _sl(u, dim, 1) - _sl(u, dim, 0, -1)
    return torch.cat([_zeros_slice(u, dim), d], dim=dim)


def dminus_T(p, dim):
    """Adjoint of :func:`dminus`: ``-p[1]; p[i]-p[i+1]; p[M-1]``."""
    pp = _sl(p, dim, 1)
    z = _zeros_slice(p, dim)
    a = torch.cat([z, pp], dim=dim)
    b = torch.cat([pp, z], dim=dim)
    return a - b


def dcent(u, dim):
    """Centered difference, zero at both boundary indices."""
    d = (_sl(u, dim, 2) - _sl(u, dim, 0, -2)) * 0.5
    z = _zeros_slice(u, dim)
    return torch.cat([z, d, z], dim=dim)


def dcent_T(p, dim):
    """Adjoint of :func:`dcent`."""
    z = _zeros_slice(p, dim)
    q = torch.cat([z, _sl(p, dim, 1, -1), z], dim=dim)
    down = torch.cat([z, _sl(q, dim, 0, -1)], dim=dim)
    up = torch.cat([_sl(q, dim, 1), z], dim=dim)
    return (down - up) * 0.5


def dplus_gram(w, dim):
    """diag(D⁺ᵀ diag(w) D⁺) for per-output weights ``w``."""
    pm = _sl(w, dim, 0, -1)
    z = _zeros_slice(w, dim)
    return torch.cat([z, pm], dim=dim) + torch.cat([pm, z], dim=dim)


def dminus_gram(w, dim):
    pp = _sl(w, dim, 1)
    z = _zeros_slice(w, dim)
    return torch.cat([z, pp], dim=dim) + torch.cat([pp, z], dim=dim)


def dcent_gram(w, dim):
    z = _zeros_slice(w, dim)
    q = torch.cat([z, _sl(w, dim, 1, -1), z], dim=dim)
    down = torch.cat([z, _sl(q, dim, 0, -1)], dim=dim)
    up = torch.cat([_sl(q, dim, 1), z], dim=dim)
    return (down + up) * 0.25


class GradientOp(StatelessOpMixin, LinOp):
    """Base: stacks one 1-D stencil applied along the last two dims."""

    _fwd = None
    _adj = None
    _gram = None
    _opnorm2 = None

    def apply(self, u):
        """(..., M, N) → (..., 2, M, N)"""
        fwd = type(self)._fwd
        return torch.stack([fwd(u, -2), fwd(u, -1)], dim=-3)

    def apply_adjoint(self, p):
        """(..., 2, M, N) → (..., M, N): −div for the matching scheme."""
        adj = type(self)._adj
        return adj(p[..., 0, :, :], -2) + adj(p[..., 1, :, :], -1)

    def opnorm_bound(self) -> float:
        return math.sqrt(type(self)._opnorm2)

    def gram_diag(self, w):
        """diag(Gᵀ diag(w) G): (..., 2, M, N) weights → (..., M, N)."""
        gram = type(self)._gram
        return gram(w[..., 0, :, :], -2) + gram(w[..., 1, :, :], -1)


class FwdGradientOp(GradientOp):
    """Forward-difference gradient (the TV operator)."""
    _fwd = staticmethod(dplus)
    _adj = staticmethod(dplus_T)
    _gram = staticmethod(dplus_gram)
    _opnorm2 = 8.0


class BwdGradientOp(GradientOp):
    """Backward-difference gradient."""
    _fwd = staticmethod(dminus)
    _adj = staticmethod(dminus_T)
    _gram = staticmethod(dminus_gram)
    _opnorm2 = 8.0


class CenteredGradientOp(GradientOp):
    """Centered-difference gradient."""
    _fwd = staticmethod(dcent)
    _adj = staticmethod(dcent_T)
    _gram = staticmethod(dcent_gram)
    _opnorm2 = 2.0
