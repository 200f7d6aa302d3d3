"""TGV² learning function: inner solve, upper-level cost and hypergradient
(counterpart of ``bpldenoising_tpu.learning.tgv``).

The L4 contract ``f(x, ds, Δ) → (u, cost, grad)`` for the weights
x = (α₁, α₀) or an (m, n, 2) stack of patch grids.  One evaluation: the
joint-primal Chambolle–Pock solve through the TGV² kernel
(:func:`..solvers.tgv_cuda.tgv_denoise_pdps_cuda`, rows 4 and 5), the cost
½Σ‖u − ū‖², and the implicit-function-theorem hypergradient of the
γ-Huber smoothed system (:func:`..solvers.tgv.tgv_implicit_cotangents`:
one CG solve over the stacked (u, w) planes, plain PyTorch on either
device, as the JAX package runs it in jnp).  There is no exact branch, so
Δ is taken and ignored.  :func:`tgv_step` is also the evaluation of the
fused loop (:mod:`..bilevel.fused_tgv`).  The factory chains the solver
state (u, w, p, q) only when ``tol`` enables the early stop; the adjoint
CG starts cold every time, as in the JAX package.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..ops import PatchOp
from ..solvers.tgv import tgv_implicit_cotangents
from ..solvers.tgv_cuda import tgv_denoise_pdps_cuda
from ..utils.config import check_backend
from .cache import dataset_tensors, make_smoothed_factory

__all__ = ["tgv_learning_function", "make_tgv_learning_function",
           "tgv_step", "tgv_local", "tgv_pullback", "tgv_param_layout"]


def tgv_param_layout(x0, image_shape) -> Optional[PatchOp]:
    """(2,) weight vector → None; (m, n, 2) patch stack → its PatchOp."""
    if tuple(x0.shape) == (2,):
        return None
    if x0.ndim == 3 and x0.shape[-1] == 2:
        return PatchOp(tuple(x0.shape[:2]), tuple(image_shape))
    raise ValueError(f"TGV parameter must be a length-2 vector "
                     f"[alpha1, alpha0] or an (m, n, 2) patch stack, "
                     f"got shape {tuple(x0.shape)}")


def tgv_local(x, utrue, f, s0, lam0, *, pop: Optional[PatchOp],
              maxiter: int, gamma: float, cg_tol: float, cg_maxiter: int,
              tau0: float, sigma0: float, tol, check_every: int):
    """The evaluation up to the pullback: ``(u, cost, (g1, g0), state, lam,
    info)``, the two cotangents scalars or batch-summed (M, N) maps."""
    if pop is None:
        a1, a0 = x[0], x[1]
    else:
        a1, a0 = pop.apply(x[..., 0]), pop.apply(x[..., 1])
    u, w, state, _ = tgv_denoise_pdps_cuda(
        f, a1, a0, tau0=tau0, sigma0=sigma0, maxiter=maxiter, tol=tol,
        check_every=check_every, state0=s0, return_state=True)
    cost = 0.5 * torch.sum((u - utrue) ** 2)
    _, grads, lam, info = tgv_implicit_cotangents(
        u, w, (a1, a0), u - utrue, gamma=gamma, cg_tol=cg_tol,
        cg_maxiter=cg_maxiter, lam0=lam0, return_lam=True, return_info=True)
    return u, cost, tuple(grads), state, lam, info


def tgv_pullback(grads, pop: Optional[PatchOp]):
    """(g1, g0) → the gradient shaped like the parameter."""
    g1, g0 = grads
    if pop is None:
        return torch.stack([g1, g0])
    # the batch-summed maps pulled back to the patch grids
    return torch.stack([pop.apply_adjoint(g1), pop.apply_adjoint(g0)],
                       dim=-1)


def tgv_step(x, utrue, f, s0, lam0, *, pop: Optional[PatchOp], maxiter: int,
             gamma: float, cg_tol: float, cg_maxiter: int, tau0: float,
             sigma0: float, tol, check_every: int):
    """One evaluation at ``x`` (a CPU tensor of the working dtype) →
    ``(u, cost, grad, state, lam, info)``, ``grad`` shaped like ``x``,
    ``state`` the solver's (u, w, p, q), ``lam`` the adjoint multiplier."""
    u, cost, grads, state, lam, info = tgv_local(
        x, utrue, f, s0, lam0, pop=pop, maxiter=maxiter, gamma=gamma,
        cg_tol=cg_tol, cg_maxiter=cg_maxiter, tau0=tau0, sigma0=sigma0,
        tol=tol, check_every=check_every)
    return u, cost, tgv_pullback(grads, pop), state, lam, info


def tgv_learning_function(x, ds, delta, *, maxiter: int = 5000,
                          gamma: float = 1e-4, cg_tol: float = 1e-6,
                          cg_maxiter: int = 1000, tau0: float = 0.99,
                          sigma0: float = 0.99, tol=None,
                          check_every: int = 500, backend: str = "auto",
                          s0=None, return_aux: bool = False, device="cuda"):
    """L4 learning function for TGV² denoising.

    Args:
      x: ``[α₁, α₀]`` or an (m, n, 2) stack of patch grids.
      ds: ``(true_images, noisy_images)``, (O, M, N) stacks or one (M, N)
        image, moved to ``device``.
      delta: the trust-region radius (ignored: no exact branch).
      s0: the solver state of a previous evaluation.
      backend: ``"auto"`` only; ``device``: ``"cuda"`` launches the
        kernel, ``"cpu"`` runs its plain version.

    Returns ``(u, cost, grad)``; with ``return_aux``, ``(u, cost, grad,
    state, info)``.
    """
    del delta
    check_backend(backend)
    utrue, f, squeeze = dataset_tensors(ds, device)
    x = torch.as_tensor(np.asarray(x), dtype=utrue.dtype)
    pop = tgv_param_layout(x, tuple(f.shape[-2:]))
    u, cost, grad, state, _, info = tgv_step(
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


def make_tgv_learning_function(**defaults):
    """TGV² factory for the L4 contract: the solver state chained when
    ``tol`` is set (:func:`.cache.make_smoothed_factory`); ``device``
    defaults to ``"cuda"``."""
    return make_smoothed_factory(tgv_learning_function, carry_adjoint=False,
                                 **defaults)
