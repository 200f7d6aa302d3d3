"""Piecewise-constant patch upsampling operator (counterpart of
``bpldenoising_tpu.ops.patch``).

Maps a small parameter grid ``(m, n)`` to the image grid ``(M, N)`` by
constant replication over blocks; the adjoint sums over blocks.  Requires
``M % m == 0`` and ``N % n == 0``.
"""

from __future__ import annotations

import math

import torch

from .linop import LinOp

__all__ = ["PatchOp"]


class PatchOp(LinOp):
    def __init__(self, size_in: tuple[int, int], size_out: tuple[int, int]):
        m, n = size_in
        M, N = size_out
        if M % m or N % n:
            raise ValueError(
                f"PatchOp requires image size {size_out} divisible by "
                f"parameter grid {size_in}")
        self.size_in = (m, n)
        self.size_out = (M, N)
        self.block = (M // m, N // n)

    @classmethod
    def for_image(cls, param, image) -> "PatchOp":
        """The operator that maps ``param``'s grid onto ``image``'s."""
        return cls(tuple(param.shape[-2:]), tuple(image.shape[-2:]))

    def apply(self, x):
        """(..., m, n) → (..., M, N) by block replication."""
        m, n = self.size_in
        bm, bn = self.block
        batch = tuple(x.shape[:-2])
        y = x[..., :, None, :, None].expand(batch + (m, bm, n, bn))
        return y.reshape(batch + (m * bm, n * bn))

    def apply_adjoint(self, g):
        """(..., M, N) → (..., m, n) by block sums."""
        m, n = self.size_in
        bm, bn = self.block
        batch = tuple(g.shape[:-2])
        return g.reshape(batch + (m, bm, n, bn)).sum(dim=(-3, -1))

    def __eq__(self, other):
        return (type(self) is type(other) and self.size_in == other.size_in
                and self.size_out == other.size_out)

    def __hash__(self):
        return hash((type(self), self.size_in, self.size_out))

    def opnorm_estimate(self, example_input=None, iters: int = 0,
                        seed: int = 0):
        # ‖P‖ = sqrt(block area): PᵀP = (bm·bn) I
        bm, bn = self.block
        return torch.tensor(math.sqrt(float(bm * bn)), dtype=torch.float64)
