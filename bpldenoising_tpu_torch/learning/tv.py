"""TV learning function: inner solve, upper-level cost and hypergradient
(counterpart of ``bpldenoising_tpu.learning.tv``).

The L4 contract ``f(x, ds, Δ) → (u, cost, grad)`` of the host trust region
(:mod:`..bilevel.trust_region`), for a scalar α or an (m, n) patch grid;
:mod:`.sumregs` runs the same step with K = 3.  One evaluation:

* the inner solve of the whole (O, M, N) stack through kernel A
  (:func:`..solvers.pdps_cuda.denoise_pdps_cuda`), from ``state0`` when
  the factory chains it;
* the cost ½Σ‖u − ū‖²;
* the hypergradient, one joint system over the batch, through kernel B
  (:func:`..solvers.hypergrad_cuda.exact_hypergrad_cuda` where Δ > Δt,
  else its γ-regularized form), from the previous adjoint ``p`` of the
  same branch;
* for a patch grid, the batch-summed gradient maps pulled back through
  the patch operator's adjoint.

On CUDA tensors the wrappers launch the kernels (or raise); on CPU tensors
they run the plain versions.  :func:`tv_step` is also the evaluation of
the fused loop (:mod:`..bilevel.fused`).  The factory carries each branch's
adjoint across evaluations always, and the PDPS state ``(u, ys)`` only
when ``solver_kwargs`` sets an early-stop ``tol``: without one every inner
solve runs the fixed budget from a cold start, as in the JAX package.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..models import DenoiseModel, tv_model
from ..ops import PatchOp
from ..solvers.hypergrad import HypergradConfig
from ..solvers.hypergrad_cuda import (exact_hypergrad_cuda,
                                      reg_hypergrad_cuda)
from ..solvers.pdps_cuda import denoise_pdps_cuda
from ..utils.config import check_backend
from ..utils.telemetry import record_adjoint_cg
from .cache import WarmCache, dataset_tensors

__all__ = ["tv_learning_function", "make_learning_function",
           "make_tv_learning_function", "tv_step"]

_MODEL = tv_model()
_SOLVER_DEFAULTS = dict(tau0=5.0, sigma0=0.99 / 5.0, gamma=1.0, accel=True,
                        tol=None, check_every=500)


def _solve(f, alphas, model, maxiter, solver_kwargs, state0=None):
    """The batched inner solve → (u, (u, ys) state)."""
    unknown = set(solver_kwargs or {}) - set(_SOLVER_DEFAULTS)
    if unknown:
        raise TypeError(f"unknown solver_kwargs {sorted(unknown)}")
    kw = dict(_SOLVER_DEFAULTS, **(solver_kwargs or {}))
    u, ys, _ = denoise_pdps_cuda(f, alphas, state0, model=model,
                                 maxiter=maxiter, return_dual=True, **kw)
    return u, (u, ys)


def tv_step(x, utrue, f, p0, s0, *, model: DenoiseModel, method: str,
            maxiter: int, cfg: HypergradConfig, pop: Optional[PatchOp],
            solver_kwargs: Optional[dict] = None):
    """One evaluation at ``x`` (a tensor of the working dtype on the CPU:
    a scalar or (K,) weights, or an (m, n) / (m, n, K) patch grid whose
    ``pop`` upsamples it) → ``(u, cost, g, p, state, info)``, ``g`` shaped
    like ``x``, ``p`` the adjoint and ``info`` its
    :class:`..solvers.krylov.KrylovInfo`."""
    K = model.K
    if pop is None:
        alphas = (x,) if K == 1 else tuple(x[k] for k in range(K))
    else:
        xd = x.to(f.device)
        alphas = ((pop.apply(xd),) if K == 1
                  else tuple(pop.apply(xd[..., k]) for k in range(K)))
    u, state = _solve(f, alphas, model, maxiter, solver_kwargs, state0=s0)
    cost = 0.5 * torch.sum((u - utrue) ** 2)
    fn = exact_hypergrad_cuda if method == "exact" else reg_hypergrad_cuda
    # one joint system over the batch: K scalar gradients, or K per-image
    # gradient maps for a patch grid
    grads, p, info = fn(u, utrue, alphas, model, cfg, pop is not None, p0=p0)
    if pop is None:
        g = torch.stack([torch.as_tensor(gk, dtype=f.dtype,
                                         device=f.device).reshape(())
                         for gk in grads])
    else:
        maps = [pop.apply_adjoint(torch.sum(gk, dim=0)) for gk in grads]
        g = maps[0] if K == 1 else torch.stack(maps, dim=-1)
    return u, cost, g.reshape(x.shape), p, state, info


def tv_learning_function(x, ds, delta, *, delta_t: float = 1e-6,
                         maxiter: int = 5000,
                         cfg: HypergradConfig = HypergradConfig(),
                         backend: str = "auto",
                         solver_kwargs: Optional[dict] = None,
                         p0=None, s0=None, return_aux: bool = False,
                         device="cuda"):
    """L4 learning function for TV denoising.

    Args:
      x: the parameter, a scalar or an (m, n) patch grid.
      ds: ``(true_images, noisy_images)``, (O, M, N) stacks or one (M, N)
        image, moved to ``device`` (the true images' dtype is the working
        dtype).
      delta: the trust-region radius Δ; Δ > ``delta_t`` takes the exact
        gradient, else the regularized one.
      solver_kwargs: the inner solve's ``tau0``, ``sigma0``, ``gamma``,
        ``accel``, ``tol``, ``check_every``.
      p0 / s0: the adjoint / PDPS warm starts of a previous evaluation.
      backend: ``"auto"`` only (:func:`..utils.config.check_backend`).
      device: ``"cuda"`` launches the kernels, ``"cpu"`` runs their plain
        versions.

    Returns ``(u, cost, grad)`` as tensors on ``device``, ``grad`` shaped
    like ``x``; with ``return_aux``, ``(u, cost, grad, p, state, info)``.
    """
    check_backend(backend)
    utrue, f, squeeze = dataset_tensors(ds, device)
    x = torch.as_tensor(np.asarray(x), dtype=utrue.dtype)
    method = "exact" if float(delta) > delta_t else "reg"
    if x.ndim == 0:
        pop = None
    elif x.ndim == 2:
        pop = PatchOp.for_image(x, f[0])
    else:
        raise ValueError(f"TV parameter must be scalar or 2-D, got "
                         f"{tuple(x.shape)}")
    u, cost, g, p, state, info = tv_step(
        x, utrue, f, p0, s0, model=_MODEL, method=method,
        maxiter=int(maxiter), cfg=cfg, pop=pop, solver_kwargs=solver_kwargs)
    if squeeze:
        u = u[0]
    if return_aux:
        return u, cost, g, p, state, info
    return u, cost, g


def make_learning_function(fn, default_delta_t: float, **defaults):
    """Bind ``defaults``, returning the bare contract ``f(x, ds, Δ)``.

    The closure warm-starts each hypergradient solve from the adjoint of
    the previous call in the same branch (exact or regularized), and, when
    ``solver_kwargs`` sets a ``tol``, the inner solve from the previous
    PDPS state; states are kept per dataset (:class:`.cache.WarmCache`, 16
    entries).  ``lf.adjoint_cg`` and ``lf.last_adjoint_cg`` report the
    adjoint solves (:func:`..utils.telemetry.record_adjoint_cg`)."""
    cache = WarmCache(16)

    def lf(x, ds, delta, **overrides):
        kw = dict(defaults)
        kw.update(overrides)
        method = ("exact"
                  if float(delta) > kw.get("delta_t", default_delta_t)
                  else "reg")
        anchor = ds[0]
        key_p = cache.key(method, x, ds)
        key_s = cache.key("pdps", x, ds)
        warm_inner = (kw.get("solver_kwargs") or {}).get("tol") is not None
        u, cost, g, p, s, info = fn(
            x, ds, delta, p0=cache.get(key_p, anchor),
            s0=cache.get(key_s, anchor) if warm_inner else None,
            return_aux=True, **kw)
        cache.put(key_p, p, anchor)
        if warm_inner:
            cache.put(key_s, s, anchor)
        record_adjoint_cg(lf, info)
        return u, cost, g

    lf.cache = cache
    return lf


def make_tv_learning_function(**defaults):
    """TV factory for the L4 contract (see :func:`make_learning_function`);
    ``device`` defaults to ``"cuda"``."""
    return make_learning_function(tv_learning_function, 1e-6, **defaults)
