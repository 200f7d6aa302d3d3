"""Vectorial (color) TV learning function: inner solve, upper-level cost
and hypergradient (counterpart of ``bpldenoising_tpu.learning.vtv``).

The L4 contract ``f(x, ds, Δ) → (u, cost, grad)`` on (O, C, M, N) color
stacks, for a scalar α, an (M, N) weight map or an (m, n) patch grid.  One
evaluation: the channel-coupled PDPS solve through the VTV kernel
(:func:`..solvers.vtv_cuda.vtv_denoise_pdps_cuda`, row 6), the cost
½Σ‖u − ū‖², and the implicit hypergradient of the γ-Huber smoothed system
(:func:`..solvers.vtv.vtv_implicit_cotangents`: one CG solve over the C
channel planes, plain PyTorch on either device).  There is no exact
branch, so Δ is taken and ignored.  :func:`vtv_step` is also the
evaluation of the fused loop (:mod:`..bilevel.fused_vtv`).  The factory
chains the solver state (u, ys) only when ``tol`` enables the early stop;
the adjoint CG starts cold every time, as in the JAX package.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..ops import PatchOp
from ..solvers.vtv import vtv_implicit_cotangents
from ..solvers.vtv_cuda import vtv_denoise_pdps_cuda
from ..utils.config import check_backend
from .cache import dataset_tensors, make_smoothed_factory

__all__ = ["vtv_learning_function", "make_vtv_learning_function",
           "vtv_step", "vtv_param_layout"]


def vtv_param_layout(x0, image_shape) -> Optional[PatchOp]:
    """Scalar weight → None; full-resolution (M, N) map → None; any other
    (m, n) patch grid → its PatchOp."""
    if x0.ndim == 0:
        return None
    if x0.ndim == 2 and tuple(x0.shape) == tuple(image_shape):
        return None
    if x0.ndim == 2:
        return PatchOp(tuple(x0.shape), tuple(image_shape))
    raise ValueError(f"VTV parameter must be a scalar, an (M, N) map or an "
                     f"(m, n) patch grid, got shape {tuple(x0.shape)}")


def vtv_step(x, utrue, f, s0, lam0, *, pop: Optional[PatchOp], maxiter: int,
             gamma: float, cg_tol: float, cg_maxiter: int, tau0: float,
             sigma0: float, tol, check_every: int):
    """One evaluation at ``x`` (a CPU tensor of the working dtype) →
    ``(u, cost, grad, state, lam, info)``, ``grad`` shaped like ``x``,
    ``state`` the solver's (u, ys), ``lam`` the adjoint multiplier."""
    a = (x if pop is None else pop.apply(x)).to(f.device)
    u, ys, _ = vtv_denoise_pdps_cuda(
        f, (a,), s0, tau0=tau0, sigma0=sigma0, maxiter=maxiter, tol=tol,
        check_every=check_every, return_dual=True)
    cost = 0.5 * torch.sum((u - utrue) ** 2)
    _, da, lam, info = vtv_implicit_cotangents(
        u, a, u - utrue, gamma=gamma, cg_tol=cg_tol, cg_maxiter=cg_maxiter,
        lam0=lam0, return_lam=True, return_info=True)
    # a map's cotangent is batch-summed already; a grid takes the adjoint
    grad = da if pop is None else pop.apply_adjoint(da)
    return u, cost, grad, (u, ys), lam, info


def vtv_learning_function(x, ds, delta, *, maxiter: int = 5000,
                          gamma: float = 1e-4, cg_tol: float = 1e-6,
                          cg_maxiter: int = 1000, tau0: float = 5.0,
                          sigma0: float = 0.99 / 5.0, tol=None,
                          check_every: int = 500, backend: str = "auto",
                          s0=None, return_aux: bool = False, device="cuda"):
    """L4 learning function for vectorial-TV denoising.

    Args:
      x: a scalar α, an (M, N) weight map or an (m, n) patch grid.
      ds: ``(true_images, noisy_images)`` color stacks, (O, C, M, N) or one
        (C, M, N) image, moved to ``device``.
      delta: the trust-region radius (ignored: no exact branch).
      s0: the solver state of a previous evaluation.
      backend: ``"auto"`` only; ``device``: ``"cuda"`` launches the
        kernel, ``"cpu"`` runs its plain version.

    Returns ``(u, cost, grad)``; with ``return_aux``, ``(u, cost, grad,
    state, info)``.
    """
    del delta
    check_backend(backend)
    if len(np.shape(ds[1])) not in (3, 4):
        raise ValueError(f"VTV expects (C, M, N) or (O, C, M, N) color "
                         f"stacks, got shape {tuple(np.shape(ds[1]))}")
    utrue, f, squeeze = dataset_tensors(ds, device, image_ndim=3)
    x = torch.as_tensor(np.asarray(x), dtype=utrue.dtype)
    pop = vtv_param_layout(x, tuple(f.shape[-2:]))
    u, cost, grad, state, _, info = vtv_step(
        x, utrue, f, s0, None, pop=pop, maxiter=int(maxiter),
        gamma=float(gamma), cg_tol=float(cg_tol), cg_maxiter=int(cg_maxiter),
        tau0=float(tau0), sigma0=float(sigma0),
        tol=None if tol is None else float(tol),
        check_every=int(check_every))
    if squeeze:
        u = u[0]
    if return_aux:
        return u, cost, grad, state, info
    return u, cost, grad


def make_vtv_learning_function(**defaults):
    """VTV factory for the L4 contract: the solver state chained when
    ``tol`` is set (:func:`.cache.make_smoothed_factory`); ``device``
    defaults to ``"cuda"``."""
    return make_smoothed_factory(vtv_learning_function, carry_adjoint=False,
                                 **defaults)
