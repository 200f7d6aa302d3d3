"""Matrix-free conjugate gradients and BiCGStab (counterpart of
``bpldenoising_tpu.solvers.krylov``).

Operators are callables ``A(x) -> y`` on tensors of any shape.  The loops
run on the host and read the residual norm once per iteration for the stop
test ‖r‖ ≤ tol·‖b‖.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

__all__ = ["cg", "cg_batched", "bicgstab", "KrylovInfo"]


class KrylovInfo(NamedTuple):
    iters: int
    resnorm: torch.Tensor      # final residual norm
    converged: torch.Tensor    # bool


def _vdot(a, b):
    return torch.sum(a * b)


def _nz(x):
    """x, with exact zeros replaced by one (guards a division)."""
    return torch.where(x == 0, torch.ones_like(x), x)


def cg(A: Callable, b, x0=None, *, tol=1e-8, maxiter=500, M=None):
    """Conjugate gradients for SPD ``A``; ``M`` is an optional SPD
    preconditioner callable (applied as M(r) ≈ A⁻¹r).  Inner products run
    over the whole tensor (one joint system)."""
    x = torch.zeros_like(b) if x0 is None else x0
    r = b - A(x)
    z = M(r) if M is not None else r
    p = z
    rz = _vdot(r, z)
    bnorm = torch.clamp(torch.linalg.norm(b.reshape(-1)),
                        min=torch.finfo(b.dtype).tiny)
    thresh = tol * bnorm
    k = 0
    while k < maxiter and bool(torch.linalg.norm(r.reshape(-1)) > thresh):
        Ap = A(p)
        alpha = rz / _nz(_vdot(p, Ap))
        x = x + alpha * p
        r = r - alpha * Ap
        z = M(r) if M is not None else r
        rz_new = _vdot(r, z)
        beta = rz_new / _nz(rz)
        p = z + beta * p
        rz = rz_new
        k += 1
    resnorm = torch.linalg.norm(r.reshape(-1))
    return x, KrylovInfo(k, resnorm, resnorm <= thresh)


def cg_batched(A: Callable, b, x0=None, *, tol=1e-8, maxiter=500, M=None,
               item_ndim: int | None = None):
    """CG with PER-ITEM inner products: the leading ``b.ndim - item_ndim``
    dims index independent SPD systems, each with its own step scalars and
    stop test; converged items keep iterating harmlessly until all items
    converge or ``maxiter`` is reached.  ``resnorm``/``converged`` are
    per-item."""
    if item_ndim is None:
        item_ndim = b.ndim
    dims = tuple(range(-item_ndim, 0))

    def vdot(p, q):
        return torch.sum(p * q, dim=dims)

    def bc(s):
        return s[(...,) + (None,) * item_ndim]

    x = torch.zeros_like(b) if x0 is None else x0
    r = b - A(x)
    z = M(r) if M is not None else r
    p = z
    rz = vdot(r, z)
    bnorm = torch.clamp(torch.sqrt(vdot(b, b)), min=torch.finfo(b.dtype).tiny)
    thresh = tol * bnorm
    k = 0
    while k < maxiter and bool(torch.any(torch.sqrt(vdot(r, r)) > thresh)):
        Ap = A(p)
        alpha = rz / _nz(vdot(p, Ap))
        x = x + bc(alpha) * p
        r = r - bc(alpha) * Ap
        z = M(r) if M is not None else r
        rz_new = vdot(r, z)
        beta = rz_new / _nz(rz)
        p = z + bc(beta) * p
        rz = rz_new
        k += 1
    resnorm = torch.sqrt(vdot(r, r))
    return x, KrylovInfo(k, resnorm, resnorm <= thresh)


def bicgstab(A: Callable, b, x0=None, *, tol=1e-8, maxiter=500):
    """BiCGStab for a general (nonsymmetric) ``A``; inner products run over
    the whole tensor.  A library utility: the hypergradient systems are all
    SPD and solved with :func:`cg`."""
    x = torch.zeros_like(b) if x0 is None else x0
    r = b - A(x)
    rhat = r
    rho = alpha = omega = torch.ones((), dtype=b.dtype, device=b.device)
    v = p = torch.zeros_like(b)
    bnorm = torch.clamp(torch.linalg.norm(b.reshape(-1)),
                        min=torch.finfo(b.dtype).tiny)
    thresh = tol * bnorm
    k = 0
    while k < maxiter and bool(torch.linalg.norm(r.reshape(-1)) > thresh):
        rho_new = _vdot(rhat, r)
        beta = (rho_new / _nz(rho)) * (alpha / _nz(omega))
        p = r + beta * (p - omega * v)
        v = A(p)
        alpha = rho_new / _nz(_vdot(rhat, v))
        s = r - alpha * v
        t = A(s)
        omega = _vdot(t, s) / _nz(_vdot(t, t))
        x = x + alpha * p + omega * s
        r = s - omega * t
        rho = rho_new
        k += 1
    resnorm = torch.linalg.norm(r.reshape(-1))
    return x, KrylovInfo(k, resnorm, resnorm <= thresh)
