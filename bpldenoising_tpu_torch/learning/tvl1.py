"""TV-L1 learning function on the Huber-smoothed surrogate: inner solve,
upper-level cost and hypergradient (counterpart of
``bpldenoising_tpu.learning.tvl1``).

The L4 contract ``f(x, ds, Δ) → (u, cost, grad)`` for a scalar weight α
or an (m, n) patch grid.  One evaluation: the Huber-smoothed TV-L1
primal–dual solve through the TV-L1 kernel's Huber form
(:func:`..solvers.tvl1_cuda.tvl1_huber_denoise_cuda`, row 8, steps τ₀/L
and σ₀/L), the cost ½Σ‖u − ū‖², and the implicit hypergradient of the
smoothed problem (:func:`..solvers.tvl1_huber.tvl1_huber_hypergrad`: one
joint CG solve over the batch, plain PyTorch on either device).  There is
no exact branch, so Δ is taken and ignored.  :func:`tvl1_step` is also
the evaluation of the fused loop (:mod:`..bilevel.fused_tvl1`).  The
factory chains the adjoint p always and the solver state (u, y) only when
``tol`` enables the early stop.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..models import tv_model
from ..ops import PatchOp
from ..solvers.hypergrad import HypergradConfig
from ..solvers.tvl1_cuda import tvl1_huber_denoise_cuda
from ..solvers.tvl1_huber import tvl1_huber_hypergrad
from ..utils.config import check_backend
from .cache import dataset_tensors, make_smoothed_factory

__all__ = ["tvl1_learning_function", "make_tvl1_learning_function",
           "tvl1_step", "tvl1_param_layout"]

_TV = tv_model()


def tvl1_param_layout(x0, image_shape) -> Optional[PatchOp]:
    """Scalar weight → None; any (m, n) grid → its PatchOp (a full-
    resolution map gets one too, as in the JAX package)."""
    if x0.ndim == 0:
        return None
    if x0.ndim == 2:
        return PatchOp(tuple(x0.shape), tuple(image_shape))
    raise ValueError(f"TV-L1 parameter must be a scalar or an (m, n) patch "
                     f"grid, got shape {tuple(x0.shape)}")


def tvl1_step(x, utrue, f, p0, s0, *, pop: Optional[PatchOp], gamma_d: float,
              cfg: HypergradConfig, maxiter: int, tau0: float, sigma0: float,
              tol, check_every: int):
    """One evaluation at ``x`` (a CPU tensor of the working dtype) →
    ``(u, cost, grad, p, state, info)``, ``grad`` shaped like ``x``."""
    a = x if pop is None else pop.apply(x).to(f.device)
    u, state = tvl1_huber_denoise_cuda(
        f, a, gamma_d=gamma_d, gamma_r=cfg.gamma, tau0=tau0, sigma0=sigma0,
        maxiter=maxiter, tol=tol, check_every=check_every, state0=s0,
        return_dual=True)
    cost = 0.5 * torch.sum((u - utrue) ** 2)
    grads, p, info = tvl1_huber_hypergrad(
        u, f, utrue, (a,), _TV, cfg, pop is not None, p0=p0, gamma_d=gamma_d)
    g = grads[0]
    if pop is not None:   # per-image maps: batch sum, then the patch adjoint
        g = pop.apply_adjoint(torch.sum(g, dim=0))
    return u, cost, g, p, state, info


def tvl1_learning_function(x, ds, delta, *, gamma_d: float = 100.0,
                           gamma: float = 1000.0, maxiter: int = 5000,
                           cg_tol=None, cg_maxiter: int = 2000,
                           tau0: float = 0.99, sigma0: float = 0.99,
                           tol=None, check_every: int = 500,
                           p0=None, s0=None, return_aux: bool = False,
                           backend: str = "auto", device="cuda"):
    """L4 learning function for Huber-smoothed TV-L1 denoising.

    Args:
      x: a scalar α or an (m, n) patch grid.
      ds: ``(true_images, noisy_images)``, (O, M, N) stacks or one (M, N)
        image, moved to ``device``.
      delta: the trust-region radius (ignored: no exact branch).
      gamma_d / gamma: the data / regularizer Huber slopes.
      cg_tol / cg_maxiter: the adjoint CG (``cg_tol=None``: the dtype's
        default).
      p0 / s0: the adjoint / solver state of a previous evaluation.
      backend: ``"auto"`` only; ``device``: ``"cuda"`` launches the
        kernel, ``"cpu"`` runs its plain version.

    Returns ``(u, cost, grad)``; with ``return_aux``, ``(u, cost, grad, p,
    state, info)``.
    """
    del delta
    check_backend(backend)
    utrue, f, squeeze = dataset_tensors(ds, device)
    x = torch.as_tensor(np.asarray(x), dtype=utrue.dtype)
    pop = tvl1_param_layout(x, tuple(f.shape[-2:]))
    cfg = HypergradConfig(gamma=float(gamma), cg_tol=cg_tol,
                          cg_maxiter=int(cg_maxiter))
    u, cost, g, p, state, info = tvl1_step(
        x, utrue, f, p0, s0, pop=pop, gamma_d=float(gamma_d), cfg=cfg,
        maxiter=int(maxiter), tau0=float(tau0), sigma0=float(sigma0),
        tol=None if tol is None else float(tol),
        check_every=int(check_every))
    if squeeze:
        u = u[0]
    if return_aux:
        return u, cost, g, p, state, info
    return u, cost, g


def make_tvl1_learning_function(**defaults):
    """TV-L1 factory for the L4 contract: the adjoint chained always, the
    solver state when ``tol`` is set (:func:`.cache.make_smoothed_factory`);
    ``device`` defaults to ``"cuda"``."""
    return make_smoothed_factory(tvl1_learning_function, carry_adjoint=True,
                                 **defaults)
