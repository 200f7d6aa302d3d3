"""Trust-region core (counterpart of ``bpldenoising_tpu.bilevel.tr_core``).

The dogleg-in-box step, the dense BFGS / L-BFGS quadratic model, the η/β
radius schedule and the acceptance test (accept iff ρ > 0) are independent
of which bilevel problem is learned.  A family supplies its evaluation

    ``eval_lf(x_flat, delta, state) -> (u, cost, g_flat, new_state, (cg_iters, cg_converged))``

where ``state`` is chained across evaluations (solver and adjoint warm
starts) and ``state=None`` asks for a cold start.

The JAX package runs this as one ``lax.while_loop`` on the device.  Here it
is a host loop: the TR state (x, B, Δ, f, g: a few numbers) lives on the
CPU in the working dtype, and ``eval_lf`` returns its scalars there, so the
loop reads the device once per outer iteration.  The arithmetic mirrors the
JAX body step for step.

:func:`run_segmented` drives the same loop in segments of ``log_every``
outer iterations with a host hop between them (per-segment wall times, a
callback for checkpoints and snapshots); :func:`splice_dense_B` restores a
checkpointed dense BFGS matrix into a fresh carry.
"""

from __future__ import annotations

import math
import time
from typing import Callable

import numpy as np
import torch

from ..solvers.lbfgs import (lbfgs_apply, lbfgs_init, lbfgs_solve,
                             lbfgs_update)

__all__ = ["make_tr_machinery", "run_segmented", "splice_dense_B"]

# carry layout: (it, x_flat, Bst, delta, fx, gx, u, state, log)
IT, X, BST, DELTA, FX, GX, U, STATE, LOG = range(9)


def _nz(x):
    return torch.where(x == 0, torch.ones_like(x), x)


def make_tr_machinery(eval_lf: Callable, *, n: int, dtype, maxiter: int,
                      tol, eta1, eta2, beta1, beta2, lbfgs_threshold: int,
                      lbfgs_memory: int):
    """Build ``(init_carry, cond, body)`` for the trust-region loop."""
    use_lbfgs = n > int(lbfgs_threshold)
    finfo = torch.finfo(dtype)

    def t(v):
        return torch.tensor(v, dtype=dtype)

    eps_pos = t(finfo.eps)
    tiny = t(finfo.tiny)
    tol = t(tol)
    eta1, eta2, beta1, beta2 = t(eta1), t(eta2), t(beta1), t(beta2)

    if use_lbfgs:
        def model_init():
            return lbfgs_init(n, int(lbfgs_memory), dtype, init_scale=0.1)

        def model_newton(ms, g):
            return -lbfgs_solve(ms, g)

        model_apply = lbfgs_apply
        model_update = lbfgs_update
    else:
        def model_init():
            return torch.eye(n, dtype=dtype) * 0.1

        def model_newton(B, g):
            sol, info = torch.linalg.solve_ex(B, -g[:, None])
            if int(info) != 0:
                return torch.full_like(g, math.nan)
            return sol[:, 0]

        def model_apply(B, v):
            return B @ v

        def model_update(B, y, s):
            sy = s @ y
            ok = sy > 1e-12 * torch.linalg.norm(s) * torch.linalg.norm(y)
            Bs = B @ s
            sBs = s @ Bs
            Bp = B + torch.outer(y, y) / _nz(sy)
            Bp = torch.where(sBs > 0, Bp - torch.outer(Bs, Bs) / _nz(sBs), Bp)
            return torch.where(ok, Bp, B)

    def bounds(x, delta):
        return torch.maximum(-delta, eps_pos - x), torch.full_like(x, delta)

    def in_bounds(p, lb, ub):
        return torch.all((p >= lb) & (p <= ub))

    def ray_to_bound(d, lb, ub):
        """Largest s ≥ 0 with s·d in [lb, ub] (0 for d = 0)."""
        d_safe = _nz(d)
        inf = torch.full_like(d, math.inf)
        ratios = torch.where(d > 0, ub / d_safe,
                             torch.where(d < 0, lb / d_safe, inf))
        s = torch.min(ratios)
        return torch.where(torch.isfinite(s), torch.clamp(s, min=0.0),
                           torch.zeros_like(s))

    def seg_to_bound(p0, d, lb, ub):
        d_safe = _nz(d)
        inf = torch.full_like(d, math.inf)
        hi = torch.where(d > 0, (ub - p0) / d_safe,
                         torch.where(d < 0, (lb - p0) / d_safe, inf))
        return torch.clamp(torch.min(hi), 0.0, 1.0)

    def dogleg(x, g, Bst, delta):
        lb, ub = bounds(x, delta)
        pn = model_newton(Bst, g)
        pn_ok = torch.all(torch.isfinite(pn))
        pn_in = pn_ok & in_bounds(pn, lb, ub)
        gBg = g @ model_apply(Bst, g)
        gg = g @ g
        pc = torch.where(gBg <= finfo.eps * gg, -g * 1e12,
                         -(gg / _nz(gBg)) * g)
        pc_in = in_bounds(pc, lb, ub)
        dvec = pc / torch.maximum(torch.linalg.norm(pc), tiny)
        pc_clip = dvec * ray_to_bound(dvec, lb, ub)
        pn_safe = torch.where(torch.isfinite(pn), pn, torch.zeros_like(pn))
        s = seg_to_bound(pc, pn_safe - pc, lb, ub)
        p_seg = pc + s * (pn_safe - pc)
        return torch.where(pn_in, pn_safe,
                           torch.where(~pc_in, pc_clip,
                                       torch.where(pn_ok, p_seg, pc)))

    def init_carry(x0, delta0):
        x = torch.as_tensor(x0, dtype=dtype).reshape(-1).cpu()
        delta = t(delta0)
        u, fx, gx, state, _ = eval_lf(x, delta, None)
        # columns: cost, ‖g‖, Δ, ‖accepted step‖, cg_iters, cg_converged
        log0 = torch.zeros((maxiter, 6), dtype=dtype)
        return (0, x, model_init(), delta, fx, gx, u, state, log0)

    def cond(carry):
        return carry[IT] < maxiter and bool(carry[DELTA] >= tol)

    def body(carry):
        it, x, Bst, delta, fx, gx, u, state, log = carry
        p = dogleg(x, gx, Bst, delta)
        x_new = x + p
        u_new, fx_new, gx_new, state_new, (cg_it, cg_ok) = eval_lf(
            x_new, delta, state)

        predf = -(p @ gx) - 0.5 * (p @ model_apply(Bst, p))
        rho = torch.where(predf == 0, torch.full_like(predf, -math.inf),
                          (fx - fx_new) / predf)

        Bst = model_update(Bst, gx_new - gx, p)

        pnorm = torch.linalg.norm(p)
        delta_new = torch.where(
            rho < eta1, beta1 * delta,
            torch.where((rho > eta2) & (pnorm > 0.8 * delta),
                        beta2 * delta, delta))
        delta_new = torch.where(predf < 0, beta1 * delta_new, delta_new)

        accepted = bool(rho > 0)
        if accepted:
            x, fx, gx, u = x_new, fx_new, gx_new, u_new
        resid = pnorm if accepted else torch.zeros_like(pnorm)

        log[it] = torch.stack([fx, torch.linalg.norm(gx), delta_new, resid,
                               torch.as_tensor(cg_it, dtype=dtype),
                               torch.as_tensor(cg_ok, dtype=dtype)])
        # warm states always advance to the latest evaluation (a rejected
        # step's state is still a near-solution warm start)
        return (it + 1, x, Bst, delta_new, fx, gx, u, state_new, log)

    return init_carry, cond, body


def splice_dense_B(carry, init_B, dtype):
    """Restore a checkpointed dense BFGS matrix into a fresh carry
    (checkpoint resume; shared by every family's learner).  No-op when the
    run uses the L-BFGS model (the checkpoint's dense B does not apply) or
    the shapes disagree."""
    if init_B is None:
        return carry
    B = torch.as_tensor(np.asarray(init_B), dtype=dtype)
    cur = carry[BST]
    if isinstance(cur, torch.Tensor) and B.shape == cur.shape:
        return carry[:BST] + (B,) + carry[BST + 1:]
    return carry


def run_segmented(init_carry_fn: Callable, segment_fn: Callable, *,
                  maxiter: int, tol: float, segment_callback=None):
    """Host driver of segmented dispatch: ``segment_fn(carry)`` advances the
    carry by at most a segment's outer iterations, and the wall clock is
    read at every hop.

    ``init_carry_fn()`` gives the initial carry (the first evaluation);
    ``segment_callback(it, carry, elapsed_s)`` runs after every segment.
    The carry's iteration count and radius live on the host (the loop
    reads cost and gradient once per evaluation, so the device has
    finished the segment's work when it ends), and a hop reads nothing
    more.  Returns ``(carry, times)``: ``times[i]`` is the cumulative wall
    time at the end of the segment that holds iteration ``i``, no finer.
    """
    carry = init_carry_fn()
    times = np.zeros((maxiter,), np.float64)
    prev_it = 0
    t0 = time.perf_counter()
    while True:
        carry = segment_fn(carry)
        it, delta = int(carry[IT]), carry[DELTA]
        elapsed = time.perf_counter() - t0
        times[prev_it:it] = elapsed
        if segment_callback is not None:
            segment_callback(it, carry, elapsed)
        # the radius test in the carry's dtype, as the loop's own cond
        if it >= maxiter or it == prev_it or bool(
                delta < torch.as_tensor(tol, dtype=delta.dtype)):
            break
        prev_it = it
    return carry, times
