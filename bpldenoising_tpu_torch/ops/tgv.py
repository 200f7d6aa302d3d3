"""Symmetrized gradient for second-order TGV regularization (counterpart
of ``bpldenoising_tpu.ops.tgv``).

TGV² penalizes α₁‖∇u − w‖_{2,1} + α₀‖E w‖_{2,1} over an auxiliary vector
field w, where E(w) = ½(∇w + ∇wᵀ) is the symmetrized gradient.  It is
discretized with backward differences (complementing the forward ∇ of
:class:`.FwdGradientOp`, Neumann boundary):

    E(w) = (D⁻ᵣ w_r,  D⁻_c w_c,  (D⁻_c w_r + D⁻ᵣ w_c)/√2)

with the off-diagonal stored once and scaled by √2, so the per-pixel
Euclidean norm of the 3-field is the Frobenius norm of the symmetric 2×2
tensor.  Planes are ordered (rr, cc, rc).

Shapes: vector field ``(..., 2, M, N)`` (component 0 = rows) → tensor
field ``(..., 3, M, N)``.  ``‖E‖² ≤ 8``; the joint operator
K(u, w) = (∇u − w, E w) has ``‖K‖² ≤ 12``.
"""

from __future__ import annotations

import math

import torch

from .grad import dminus, dminus_T
from .linop import LinOp, StatelessOpMixin

__all__ = ["SymGradientOp", "sym_grad", "sym_div", "TGV_OPNORM_SQ"]

_SQRT2 = math.sqrt(2.0)

#: upper bound on ‖(u, w) ↦ (∇u − w, E w)‖² for the fwd-∇ / bwd-E scheme
TGV_OPNORM_SQ = 12.0


def sym_grad(w):
    """E(w): ``(..., 2, M, N)`` → ``(..., 3, M, N)`` (√2-weighted off-diag)."""
    wr = w[..., 0, :, :]
    wc = w[..., 1, :, :]
    err = dminus(wr, -2)
    ecc = dminus(wc, -1)
    erc = (dminus(wr, -1) + dminus(wc, -2)) / _SQRT2
    return torch.stack([err, ecc, erc], dim=-3)


def sym_div(z):
    """Exact adjoint Eᵀ of :func:`sym_grad` (the NEGATIVE divergence):
    ``(..., 3, M, N)`` → ``(..., 2, M, N)``."""
    zrr = z[..., 0, :, :]
    zcc = z[..., 1, :, :]
    zrc = z[..., 2, :, :]
    out_r = dminus_T(zrr, -2) + dminus_T(zrc, -1) / _SQRT2
    out_c = dminus_T(zcc, -1) + dminus_T(zrc, -2) / _SQRT2
    return torch.stack([out_r, out_c], dim=-3)


class SymGradientOp(StatelessOpMixin, LinOp):
    """LinOp wrapper over :func:`sym_grad` / :func:`sym_div`."""

    def apply(self, w):
        return sym_grad(w)

    def apply_adjoint(self, z):
        return sym_div(z)

    def opnorm_bound(self) -> float:
        return math.sqrt(8.0)
