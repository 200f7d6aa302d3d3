"""Variational denoising model definitions (counterpart of
``bpldenoising_tpu.models.base``).

A :class:`DenoiseModel` declares the lower-level problem

    min_u  ½‖u − f‖² + Σₖ ‖αₖ Gₖ u‖_{2,1}

as data: the tuple of regularizer operators Gₖ.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..ops import LinOp, norm21, xi


def _as_tensor(a):
    return a if isinstance(a, torch.Tensor) else torch.as_tensor(
        np.asarray(a))


@dataclass(frozen=True)
class DenoiseModel:
    """The lower-level variational problem, as data (``channels=True``
    declares a vectorial model with a channel axis at ``-3``)."""

    ops: tuple[LinOp, ...]
    name: str = "model"
    channels: bool = False

    @property
    def K(self) -> int:
        return len(self.ops)

    @property
    def norm_axes(self) -> tuple[int, ...]:
        return (-4, -3) if self.channels else (-3,)

    @property
    def image_axes(self) -> tuple[int, ...]:
        return (-3, -2, -1) if self.channels else (-2, -1)

    def opnorm_sq(self) -> float:
        """Upper bound on ‖[G₁; …; G_K]‖² = Σ ‖Gₖ‖²."""
        total = 0.0
        for op in self.ops:
            bound = getattr(op, "opnorm_bound", None)
            if bound is None:
                raise ValueError(f"op {op} has no opnorm_bound")
            total += bound() ** 2
        return total

    def canonical_alphas(self, alphas):
        """Normalize user-facing α into a K-tuple of tensors (scalars or
        (M, N) maps): a scalar or map for K == 1, a length-K sequence, a
        (K,) vector or an (..., K) stack.  Python numbers and lists keep
        their double precision (numpy's float64, not torch's float32
        default), as in the JAX package with x64 enabled."""
        if isinstance(alphas, (tuple, list)):
            if len(alphas) != self.K:
                raise ValueError(f"expected {self.K} alphas, got {len(alphas)}")
            return tuple(_as_tensor(a) for a in alphas)
        a = _as_tensor(alphas)
        if self.K == 1:
            return (a,)
        if a.ndim == 1 and a.shape[0] == self.K:
            return tuple(a[k] for k in range(self.K))
        if a.ndim == 3 and a.shape[-1] == self.K:
            return tuple(a[..., k] for k in range(self.K))
        raise ValueError(
            f"cannot interpret alpha of shape {tuple(a.shape)} for K={self.K}")

    def energy(self, u, f, alphas):
        """Primal energy ½‖u−f‖² + Σₖ Σ_pix αₖ·|Gₖu|₂ (per batch element)."""
        alphas = self.canonical_alphas(alphas)
        e = 0.5 * torch.sum((u - f) ** 2, dim=self.image_axes)
        for op, a in zip(self.ops, alphas):
            g = op.apply(u)
            if a.ndim >= 2:
                e = e + torch.sum(a * xi(g, axes=self.norm_axes),
                                  dim=(-2, -1))
            else:
                e = e + a * norm21(g, axes=self.norm_axes)
        return e
