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

Each form is written once, as a generator (:func:`pcg_classic_steps`,
:func:`pcg_pipelined_steps`) that stops at every inner product: it yields
a tuple of local dots (one classic, the pair (γ, δ) pipelined), receives
the tuple of dots to use and returns the solution.  A mesh answers with
the sums over its shards (the JAX package's ``psum``);
:func:`pcg_classic` and :func:`pcg_pipelined` answer with the local dots
themselves (:func:`local_sums`), the unsharded iteration.
"""

from __future__ import annotations

import torch

__all__ = ["pcg_classic", "pcg_pipelined", "pcg_classic_steps",
           "pcg_pipelined_steps", "local_sums", "CG_VARIANTS", "CG_STEPS"]


def _default_vdot(a, b):
    return torch.sum(a * b)


def _nz(x):
    """x with its zero entries replaced by 1 (the division guards)."""
    return torch.where(x == 0, 1.0, x)


def local_sums(gen):
    """Run a generator of this module (or a stepper's step) to its end,
    answering every yield with the values it yielded: the unsharded
    iteration.  → the generator's return value."""
    try:
        sums = next(gen)
        while True:
            sums = gen.send(sums)
    except StopIteration as stop:
        return stop.value


def pcg_classic_steps(M_apply, inv_diag, b, p, n_adj, vdot=_default_vdot):
    """Textbook Jacobi-PCG: ``n_adj`` iterations from warm start ``p``,
    yielding ``(vdot(·, ·),)`` at each of its 2·n_adj + 1 inner products
    and going on with the value sent back."""
    r = b - M_apply(p)
    zv = inv_diag * r
    d = zv
    rz, = yield (vdot(r, zv),)
    for _ in range(int(n_adj)):
        Md = M_apply(d)
        denom, = yield (vdot(d, Md),)
        a = rz / _nz(denom)
        p = p + a * d
        r = r - a * Md
        zv = inv_diag * r
        rz_new, = yield (vdot(r, zv),)
        beta = rz_new / _nz(rz)
        d = zv + beta * d
        rz = rz_new
    return p


def pcg_pipelined_steps(M_apply, inv_diag, b, p, n_adj,
                        vdot=_default_vdot):
    """Chronopoulos–Gear PCG: one synchronization point per iteration,
    where it yields ``(γ, δ)`` and goes on with the pair sent back."""
    r = b - M_apply(p)
    x = p
    pdir = torch.zeros_like(r)
    s = torch.zeros_like(r)
    g_prev = torch.ones((), dtype=r.dtype, device=r.device)
    a_prev = g_prev
    for i in range(int(n_adj)):
        u = inv_diag * r
        w = M_apply(u)
        # both dots are taken together: the single sync point of the
        # iteration
        g, d = yield (vdot(r, u), vdot(w, u))
        beta = torch.zeros_like(g) if i == 0 else g / _nz(g_prev)
        denom = d - beta * g / _nz(a_prev)
        a = g / _nz(denom)
        pdir = u + beta * pdir
        s = w + beta * s
        x = x + a * pdir
        r = r - a * s
        g_prev, a_prev = g, a
    return x


def pcg_classic(M_apply, inv_diag, b, p, n_adj, vdot=_default_vdot):
    """:func:`pcg_classic_steps` with its local dots."""
    return local_sums(pcg_classic_steps(M_apply, inv_diag, b, p, n_adj,
                                        vdot))


def pcg_pipelined(M_apply, inv_diag, b, p, n_adj, vdot=_default_vdot):
    """:func:`pcg_pipelined_steps` with its local dots."""
    return local_sums(pcg_pipelined_steps(M_apply, inv_diag, b, p, n_adj,
                                          vdot))


CG_VARIANTS = {"classic": pcg_classic, "pipelined": pcg_pipelined}
CG_STEPS = {"classic": pcg_classic_steps, "pipelined": pcg_pipelined_steps}
