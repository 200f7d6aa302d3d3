"""The host-driven trust-region bilevel learn, ``method="tr"`` (counterpart
of ``bpldenoising_tpu.bilevel.trust_region``).

A dogleg step in the ℓ∞ ball of radius Δ intersected with the positive
orthant (the box ``[max(−Δ, ε−x), Δ]``), a BFGS quadratic model (dense, or
:class:`..solvers.lbfgs.LBFGSModel` above ``lbfgs_threshold`` parameters),
the ared/pred acceptance (accept iff ρ > 0) and the η₁/η₂/β₁/β₂ radius
schedule.  The parameter is small (1 for a scalar α, 3 for the sum of
regularizers, m·n(·K) for patch grids) and the loop is sequential, so its
state lives on the host in NumPy float64; only the learning function
touches the device.  As in the JAX package:

* the Newton step is −B⁻¹g;
* ``step_to_bound`` is the scalar distance to the box along a direction;
* the BFGS update is skipped unless sᵀy > 1e-12‖s‖‖y‖.

The learning function ``f(x, ds, Δ) → (u, cost, grad)`` (the factories of
:mod:`..learning`) leaves u on the device; the cost and the gradient come
to the host in one read per evaluation, counted in :data:`host_reads`.
"""

from __future__ import annotations

import sys
from typing import Callable, Optional

import numpy as np
import torch

from ..solvers.lbfgs import LBFGSModel
from .harness import BilevelResult, BilevelState, bilevel_iterate

__all__ = ["bilevel_learn", "dogleg_box", "TRModel", "get_bounds",
           "in_bounds", "step_to_bound", "host_reads"]

_EPS = np.finfo(np.float64).eps

#: device→host reads of (cost, gradient) by :func:`bilevel_learn`, one per
#: evaluation of a learning function that returns tensors
host_reads = 0


class TRModel:
    """Dense BFGS quadratic model B (the Hessian approximation)."""

    def __init__(self, n: int, init_scale: float = 0.1):
        self.B = np.eye(n) * init_scale

    def apply(self, v: np.ndarray) -> np.ndarray:
        return self.B @ v

    def newton_step(self, g: np.ndarray) -> Optional[np.ndarray]:
        try:
            pn = np.linalg.solve(self.B, -g)
        except np.linalg.LinAlgError:
            return None
        if not np.all(np.isfinite(pn)):
            return None
        return pn

    def cauchy_step(self, g: np.ndarray) -> np.ndarray:
        gBg = float(g @ self.apply(g))
        gg = float(g @ g)
        if gBg <= _EPS * gg:
            # no positive curvature along −g: a long steepest-descent step,
            # which the caller clips to the box
            return -g * 1e12
        return -(gg / gBg) * g

    def pred(self, p: np.ndarray, g: np.ndarray) -> float:
        """Predicted decrease −pᵀg − ½pᵀBp."""
        return float(-p @ g - 0.5 * p @ self.apply(p))

    def update(self, y: np.ndarray, s: np.ndarray) -> None:
        sy = float(s @ y)
        if sy <= 1e-12 * np.linalg.norm(s) * np.linalg.norm(y):
            return  # no curvature: skip
        Bs = self.apply(s)
        sBs = float(s @ Bs)
        self.B += np.outer(y, y) / sy
        if sBs > 0:
            self.B -= np.outer(Bs, Bs) / sBs


def get_bounds(x: np.ndarray, delta: float):
    """The step's box [max(−Δ, ε−x), Δ], which keeps x + p ≥ ε > 0."""
    lb = np.maximum(-delta, _EPS - x)
    ub = np.full_like(x, delta)
    return lb, ub


def in_bounds(p: np.ndarray, lb: np.ndarray, ub: np.ndarray) -> bool:
    return bool(np.all(p >= lb) and np.all(p <= ub))


def step_to_bound(d: np.ndarray, lb: np.ndarray, ub: np.ndarray) -> float:
    """Largest t ≥ 0 with t·d inside [lb, ub]; 0 for d = 0."""
    with np.errstate(divide="ignore", invalid="ignore"):
        ratios = np.where(d > 0, ub / d, np.where(d < 0, lb / d, np.inf))
    t = float(np.min(ratios))
    if not np.isfinite(t):
        return 0.0
    return max(t, 0.0)


def _segment_to_bound(p0: np.ndarray, d: np.ndarray, lb, ub) -> float:
    """Largest t ∈ [0, 1] with p0 + t·d inside [lb, ub] (p0 feasible)."""
    with np.errstate(divide="ignore", invalid="ignore"):
        hi = np.where(d > 0, (ub - p0) / d, np.where(d < 0, (lb - p0) / d,
                                                     np.inf))
    return float(min(1.0, max(0.0, np.min(hi))))


def dogleg_box(x: np.ndarray, g: np.ndarray, model, delta: float
               ) -> np.ndarray:
    """The dogleg step restricted to the positivity-aware ℓ∞ box."""
    lb, ub = get_bounds(x, delta)
    pn = model.newton_step(g)
    if pn is not None and in_bounds(pn, lb, ub):
        return pn
    pc = model.cauchy_step(g)
    if not in_bounds(pc, lb, ub):
        d = pc / max(np.linalg.norm(pc), _EPS)
        return d * step_to_bound(d, lb, ub)
    if pn is None:
        return pc
    t = _segment_to_bound(pc, pn - pc, lb, ub)
    return pc + t * (pn - pc)


def _fetch(cost, grad):
    """(cost, grad) → (float, flat float64 array); tensors come to the host
    together in one read."""
    global host_reads
    if isinstance(cost, torch.Tensor) or isinstance(grad, torch.Tensor):
        c = torch.as_tensor(cost)
        g = torch.as_tensor(grad, device=c.device)
        host = torch.cat([c.reshape(1).to(g.dtype), g.reshape(-1)]).cpu()
        host_reads += 1
        host = host.numpy().astype(np.float64)
        return float(host[0]), host[1:]
    return float(cost), np.asarray(grad, dtype=np.float64).reshape(-1)


def bilevel_learn(ds, learning_function: Callable, *, xinit, params,
                  visualise: bool = False, save_iteration_fn=None,
                  checkpoint: Optional[Callable] = None,
                  init_B=None, init_log=None) -> BilevelResult:
    """Trust-region bilevel learning driven from the host.

    Args:
      ds: ``(true_images, noisy_images)``, stacks the learning function
        takes (tensors on the device for the factories of
        :mod:`..learning`).
      learning_function: ``f(x, ds, Δ) -> (u, cost, grad)``, ``u`` the
        reconstruction, ``cost`` the upper-level loss and ``grad`` shaped
        like ``x``.
      xinit: initial parameter (scalar, (3,), (m, n) or (m, n, 3)).
      params: eta1, eta2, beta1, beta2, delta0, maxiter, tol,
        verbose_iter, and optionally lbfgs_threshold / lbfgs_memory.
      save_iteration_fn: ``fn(iteration, image)`` for each logged
        iteration's first reconstructed image (a host array).
      checkpoint: ``checkpoint(iter, x, delta, log, B=...)`` after every
        accepted iteration.
      init_B: a dense BFGS matrix to start from (not for L-BFGS).
      init_log: BilevelLogEntry items that seed the log; the numbering and
        the budget continue after their last iteration.

    Returns a :class:`.harness.BilevelResult` whose ``u`` is the
    reconstruction as the learning function returned it (on the device).
    """
    eta1, eta2 = float(params.eta1), float(params.eta2)
    beta1, beta2 = float(params.beta1), float(params.beta2)
    delta = float(params.delta0)

    x0 = np.asarray(xinit, dtype=np.float64)
    shape = x0.shape
    x = x0.reshape(-1).copy()
    n = x.size

    def call_lf(x_flat, d):
        u, cost, grad = learning_function(x_flat.reshape(shape), ds, d)
        cost, grad = _fetch(cost, grad)
        return u, cost, grad

    u, fx, gx = call_lf(x, delta)
    if n > int(params.get("lbfgs_threshold", 64)):
        model = LBFGSModel(n, memory=int(params.get("lbfgs_memory", 10)),
                           init_scale=0.1)
    else:
        model = TRModel(n, init_scale=0.1)
        if init_B is not None and np.asarray(init_B).shape == (n, n):
            model.B = np.asarray(init_B, dtype=np.float64).copy()
    residual = np.zeros_like(x)
    it_count = max((e.iter for e in init_log), default=0) if init_log else 0
    st = BilevelState()
    if init_log:
        st.log.extend(init_log)

    def step(verbose):
        nonlocal x, u, fx, gx, delta, residual, it_count
        it_count += 1
        p = dogleg_box(x, gx, model, delta)
        x_new = x + p
        u_new, fx_new, gx_new = call_lf(x_new, delta)

        predf = model.pred(p, gx)
        if predf == 0:
            print("warning: degenerate trust-region step (pred == 0)",
                  file=sys.stderr)
            rho = -np.inf
        else:
            rho = (fx - fx_new) / predf

        model.update(gx_new - gx, p)

        if rho < eta1:
            delta = beta1 * delta
        elif rho > eta2 and np.linalg.norm(p) > 0.8 * delta:
            delta = beta2 * delta
        if predf < 0:
            delta = beta1 * delta

        accepted = rho > 0
        if accepted:
            residual = x - x_new
            x, u, fx, gx = x_new, u_new, fx_new, gx_new

        verbose(lambda: (x.reshape(shape), u[0], fx,
                         np.linalg.norm(gx), delta,
                         np.linalg.norm(residual),
                         getattr(learning_function, "last_adjoint_cg",
                                 None)))
        if accepted and checkpoint is not None:
            # after verbose, so the snapshot holds this iteration's entry
            checkpoint(it_count, x.reshape(shape), delta, st.log,
                       B=getattr(model, "B", None))
        return delta < float(params.get("tol", 0.0))

    bilevel_iterate(step, params, visualise=visualise,
                    save_iteration_fn=save_iteration_fn, state=st,
                    start_iteration=it_count)
    return BilevelResult(x=x.reshape(shape), u=u, state=st, cost=fx,
                         g_norm=float(np.linalg.norm(gx)),
                         iterations=it_count)
