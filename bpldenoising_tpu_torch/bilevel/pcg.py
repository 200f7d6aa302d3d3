"""Fixed-step preconditioned CG bodies for the single-loop learners
(counterpart of ``bpldenoising_tpu.bilevel.pcg``).

Two forms of Jacobi-preconditioned CG on the γ-smoothed adjoint system
(``solvers/hypergrad.py::build_reg_system``), equal in exact arithmetic:

``classic``
    Textbook PCG: ``(d, Md)`` gates the solution and residual updates,
    then ``(r, z)`` gates the direction update.  The default, and the form
    of the single-loop learner's plain version.

``pipelined``
    Chronopoulos–Gear PCG: both inner products, γ = (r, u) and δ = (w, u)
    with u = P⁻¹r and w = A u, depend only on the fresh residual, so they
    are taken together; α and β come from scalar recurrences
    (β = γ/γ₋₁, α = γ/(δ − βγ/α₋₁)).  Opt-in (``cg_variant="pipelined"``).

Both run a FIXED ``n_adj`` iterations (no convergence test) and guard
every denominator as the JAX package does: a zero denominator becomes 1,
and the pipelined form starts with β = 0 and γ₋₁ = α₋₁ = 1.  Plain
PyTorch; nothing leaves the device.  ``vdot`` is injectable: the plain
per-tile learner passes one whose sums are taken per group of images.
"""

from __future__ import annotations

import torch

__all__ = ["pcg_classic", "pcg_pipelined", "CG_VARIANTS"]


def _default_vdot(a, b):
    return torch.sum(a * b)


def _nz(x):
    """x with its zero entries replaced by 1 (the division guards)."""
    return torch.where(x == 0, 1.0, x)


def pcg_classic(M_apply, inv_diag, b, p, n_adj, vdot=_default_vdot):
    """Textbook Jacobi-PCG: ``n_adj`` iterations from warm start ``p``."""
    r = b - M_apply(p)
    zv = inv_diag * r
    d = zv
    rz = vdot(r, zv)
    for _ in range(int(n_adj)):
        Md = M_apply(d)
        denom = vdot(d, Md)
        a = rz / _nz(denom)
        p = p + a * d
        r = r - a * Md
        zv = inv_diag * r
        rz_new = vdot(r, zv)
        beta = rz_new / _nz(rz)
        d = zv + beta * d
        rz = rz_new
    return p


def pcg_pipelined(M_apply, inv_diag, b, p, n_adj, vdot=_default_vdot):
    """Chronopoulos–Gear PCG: one synchronization point per iteration."""
    r = b - M_apply(p)
    x = p
    pdir = torch.zeros_like(r)
    s = torch.zeros_like(r)
    g_prev = torch.ones((), dtype=r.dtype, device=r.device)
    a_prev = g_prev
    for i in range(int(n_adj)):
        u = inv_diag * r
        w = M_apply(u)
        g = vdot(r, u)          # both dots are taken together:
        d = vdot(w, u)          # the single sync point of the iteration
        beta = torch.zeros_like(g) if i == 0 else g / _nz(g_prev)
        denom = d - beta * g / _nz(a_prev)
        a = g / _nz(denom)
        pdir = u + beta * pdir
        s = w + beta * s
        x = x + a * pdir
        r = r - a * s
        g_prev, a_prev = g, a
    return x


CG_VARIANTS = {"classic": pcg_classic, "pipelined": pcg_pipelined}
