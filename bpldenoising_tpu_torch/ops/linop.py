"""Minimal linear-operator protocol (counterpart of ``bpldenoising_tpu.ops.linop``).

A callable linear map with an explicit adjoint, a power-method operator-norm
estimate and a dense materialization used only by tests.
"""

from __future__ import annotations

import torch


class LinOp:
    """A linear map with explicit adjoint; subclasses implement
    :meth:`apply` and :meth:`apply_adjoint` on tensors."""

    def apply(self, x):
        raise NotImplementedError

    def apply_adjoint(self, y):
        raise NotImplementedError

    def __call__(self, x):
        return self.apply(x)

    @property
    def T(self) -> "AdjointOp":
        return AdjointOp(self)

    def opnorm_estimate(self, example_input, iters: int = 50, seed: int = 0):
        """Power-method estimate of ||A||_2 using AᵀA."""
        gen = torch.Generator(device=example_input.device).manual_seed(seed)
        x = torch.randn(example_input.shape, generator=gen,
                        dtype=example_input.dtype,
                        device=example_input.device)
        norm = torch.zeros((), dtype=x.dtype, device=x.device)
        for _ in range(iters):
            x = x / torch.linalg.norm(x.reshape(-1))
            x = self.apply_adjoint(self.apply(x))
            norm = torch.linalg.norm(x.reshape(-1))
        return torch.sqrt(norm)

    def as_matrix(self, in_shape, dtype=torch.float64):
        """Dense materialization, (out_dim, in_dim) (tests only)."""
        n = 1
        for s in in_shape:
            n *= int(s)
        eye = torch.eye(n, dtype=dtype)
        cols = [self.apply(eye[i].reshape(in_shape)).reshape(-1)
                for i in range(n)]
        return torch.stack(cols, dim=1)


class StatelessOpMixin:
    """Equality/hash by type, so parameterless ops compare equal."""

    def __eq__(self, other):
        return type(self) is type(other)

    def __hash__(self):
        return hash(type(self))


class AdjointOp(LinOp):
    def __init__(self, op: LinOp):
        self.op = op

    def apply(self, x):
        return self.op.apply_adjoint(x)

    def apply_adjoint(self, y):
        return self.op.apply(y)

    @property
    def T(self) -> LinOp:
        return self.op


class ZeroOp(LinOp):
    """Maps everything to zeros of the same shape."""

    def apply(self, x):
        return torch.zeros_like(x)

    def apply_adjoint(self, y):
        return torch.zeros_like(y)

    def opnorm_estimate(self, example_input, iters: int = 0, seed: int = 0):
        return torch.tensor(0.0, dtype=example_input.dtype)


class IdentityOp(LinOp):
    def apply(self, x):
        return x

    def apply_adjoint(self, y):
        return y

    def opnorm_estimate(self, example_input, iters: int = 0, seed: int = 0):
        return torch.tensor(1.0, dtype=example_input.dtype)
