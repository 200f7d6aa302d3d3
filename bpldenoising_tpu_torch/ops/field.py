"""Pointwise operations on dual (gradient) fields ``(..., 2, M, N)``
(counterpart of ``bpldenoising_tpu.ops.field``)."""

from __future__ import annotations

import torch

__all__ = ["xi", "scalarprod", "norm21", "proj_norm21_ball",
           "pixel_outer_apply"]


def xi(p, eps: float = 0.0, axes=(-3,)):
    """Per-pixel Euclidean norm of a field: (..., 2, M, N) → (..., M, N)."""
    return torch.sqrt(torch.sum(p * p, dim=axes) + eps)


def scalarprod(a, b, axes=(-3,)):
    """Per-pixel inner product of two fields: (..., 2, M, N) → (..., M, N)."""
    return torch.sum(a * b, dim=axes)


def norm21(p, axes=(-3,)):
    """Group (2,1)-norm: sum over pixels of per-pixel Euclidean norms."""
    return torch.sum(xi(p, axes=axes), dim=(-2, -1))


def proj_norm21_ball(p, radius, axes=(-3,)):
    """Project each pixel's vector onto the Euclidean ball of ``radius``
    (a scalar or an (..., M, N) map): the PDPS dual step."""
    n = xi(p, axes=axes)
    for ax in sorted(axes, reverse=True):
        n = n.unsqueeze(ax)
    r = torch.as_tensor(radius, dtype=p.dtype)
    if r.device != p.device and r.ndim > 0:
        r = r.to(p.device)
    if r.ndim >= 2:
        for ax in sorted(axes, reverse=True):
            r = r.unsqueeze(ax)
    # never form 0/0: the untaken division branch stays finite via the max
    tiny = torch.finfo(p.dtype).tiny
    scale = torch.where(n <= r, 1.0, r / torch.clamp(n, min=tiny))
    return p * scale


def pixel_outer_apply(g, v, inv_den3):
    """Apply the per-pixel rank-one block ``g gᵀ / den³`` to a field ``v``:
    ``out = g (g·v) / den³`` pointwise (``inv_den3`` an (..., M, N) map)."""
    return g * (scalarprod(g, v) * inv_den3).unsqueeze(-3)
