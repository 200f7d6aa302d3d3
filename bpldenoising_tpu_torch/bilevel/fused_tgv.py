"""Trust-region TGV² bilevel learning with warm-chained solver state
(counterpart of ``bpldenoising_tpu.bilevel.fused_tgv``).

The TGV analogue of :mod:`.fused` on the same host trust-region loop
(:mod:`.tr_core`).  Each evaluation runs the joint-primal Chambolle–Pock
inner solve and the implicit-function-theorem hypergradient of the
γ-Huber-smoothed joint system (:mod:`..solvers.tgv`):

* with ``inner_tol`` set, the solver state (u, w, p, q) and the adjoint CG
  multiplier λ are carried across evaluations (early-stopped warm solves,
  warm-started CG); with ``inner_tol=None`` (parity mode) every evaluation
  runs the fixed budget from a cold start, solver and CG alike;
* there is no exact/regularized switch: the smoothed implicit gradient is
  the only branch, so the radius is ignored by the evaluation.

The solve goes through :func:`..solvers.tgv_cuda.tgv_denoise_pdps_cuda`:
on the card it launches the CUDA kernel, on the CPU it runs the plain
version.  The adjoint CG is plain PyTorch on either device, as the JAX
package runs it in jnp outside its Pallas kernel.  Segmented dispatch
(``log_every``, ``segment_callback``, ``init_B``) is :func:`.fused.drive`'s;
``mesh=`` runs every evaluation per shard and sums the cost and the two
cotangents over the shards before the pullback (:func:`.fused.evaluate`).
"""

from __future__ import annotations

import numpy as np
import torch

from ..learning.tgv import tgv_local, tgv_param_layout, tgv_pullback
from .fused import (FusedResult, _check_positive_x0, drive, evaluate,
                    learn_data, shapes)
from .tr_core import make_tr_machinery

__all__ = ["bilevel_learn_tgv_fused", "tgv_param_layout"]


def _machinery(data, mesh, *, pop, param_shape: tuple, maxiter: int, tol,
               eta1, eta2, beta1, beta2, inner_maxiter: int, inner_tol,
               check_every: int, gamma: float, cg_tol: float,
               cg_maxiter: int, tau0: float, sigma0: float,
               lbfgs_threshold: int, lbfgs_memory: int):
    dtype, _ = shapes(data, mesh)
    n = int(np.prod(param_shape, dtype=int))

    def eval_lf(xflat, delta, st):
        del delta   # smoothed implicit gradient: no exact/reg switch
        x = xflat.reshape(param_shape)

        def local(utrue, f, st):
            s0, lam0 = (None, None) if st is None else st
            # parity mode (inner_tol None: a fixed budget) cold-starts every
            # solve and every adjoint CG
            warm = inner_tol is not None
            u, cost, grads, state, lam, info = tgv_local(
                x, utrue, f, s0 if warm else None, lam0 if warm else None,
                pop=pop, maxiter=inner_maxiter, gamma=gamma, cg_tol=cg_tol,
                cg_maxiter=cg_maxiter, tau0=tau0, sigma0=sigma0,
                tol=inner_tol, check_every=check_every)
            return u, cost, grads, (state, lam), info

        u, cost, grads, st, info = evaluate(local, data, st, mesh)
        grad = tgv_pullback(grads, pop)
        cg_ok = torch.all(info.converged)
        # one device → host read per evaluation: cost, gradient, CG flag
        host = torch.cat([cost.reshape(1), grad.reshape(-1),
                          cg_ok.to(dtype).reshape(1)]).cpu()
        cg_it = torch.tensor(float(info.iters), dtype=dtype)
        return u, host[0], host[1:1 + n], st, (cg_it, host[-1])

    return make_tr_machinery(
        eval_lf, n=n, dtype=dtype, maxiter=maxiter, tol=tol, eta1=eta1,
        eta2=eta2, beta1=beta1, beta2=beta2,
        lbfgs_threshold=lbfgs_threshold, lbfgs_memory=lbfgs_memory)


def bilevel_learn_tgv_fused(ds, *, xinit, params,
                            inner_maxiter: int = 5000,
                            inner_tol: float | None = None,
                            check_every: int = 500, gamma: float = 1e-4,
                            cg_tol: float = 1e-6, cg_maxiter: int = 1000,
                            tau0: float = 0.99, sigma0: float = 0.99,
                            mesh=None, log_every: int | None = None,
                            segment_callback=None, init_B=None,
                            device="cuda") -> FusedResult:
    """Run the TGV² trust-region bilevel learning on ``device``.

    Args:
      ds: ``(true_images, noisy_images)`` stacks, (O, M, N) or (M, N),
        as arrays or tensors (their dtype is the working dtype).
      xinit: length-2 ``[α₁, α₀]`` weight vector or an (m, n, 2) stack of
        patch grids (spatially-varying weights).
      params: eta1/eta2/beta1/beta2, delta0, maxiter, tol, and optionally
        lbfgs_threshold/lbfgs_memory.
      inner_tol: joint-CP early-stop tolerance; ``None`` runs the fixed
        budget every evaluation and disables the warm-start chaining.
      gamma / cg_tol / cg_maxiter: implicit-gradient knobs
        (:func:`..solvers.tgv.tgv_implicit_cotangents`).
      mesh: data parallelism over a :class:`..parallel.mesh.Mesh`, as in
        :func:`.fused.bilevel_learn_fused`.
      log_every / segment_callback / init_B: segmented dispatch and
        checkpoint resume, as in :func:`.fused.bilevel_learn_fused`.
      device: where the images and solver state live; ``"cuda"`` launches
        the CUDA kernel, ``"cpu"`` runs its plain version (with a mesh,
        its devices).

    Returns a :class:`.fused.FusedResult`.
    """
    data = learn_data(ds, device, mesh, log_every)
    dtype, like = shapes(data, mesh)
    x0 = torch.as_tensor(xinit, dtype=dtype).cpu()
    pop = tgv_param_layout(x0, tuple(like.shape[-2:]))
    _check_positive_x0(x0)
    param_shape = tuple(x0.shape)
    maxiter, tol = int(params.maxiter), float(params.get("tol", 0.0))
    machinery = _machinery(
        data, mesh, pop=pop, param_shape=param_shape,
        maxiter=maxiter, tol=tol,
        eta1=float(params.eta1), eta2=float(params.eta2),
        beta1=float(params.beta1), beta2=float(params.beta2),
        inner_maxiter=int(inner_maxiter),
        inner_tol=None if inner_tol is None else float(inner_tol),
        check_every=int(check_every), gamma=float(gamma),
        cg_tol=float(cg_tol), cg_maxiter=int(cg_maxiter), tau0=float(tau0),
        sigma0=float(sigma0),
        lbfgs_threshold=int(params.get("lbfgs_threshold", 64)),
        lbfgs_memory=int(params.get("lbfgs_memory", 10)))
    return drive(machinery, x0=x0, delta0=float(params.delta0),
                 param_shape=param_shape, maxiter=maxiter, tol=tol,
                 log_every=log_every, segment_callback=segment_callback,
                 init_B=init_B)
