"""Trust-region TV-L1 bilevel learning on the Huber-smoothed surrogate, with
warm-chained solver state (counterpart of
``bpldenoising_tpu.bilevel.fused_tvl1``).

The TV-L1 analogue of :mod:`.fused` on the same host trust-region loop
(:mod:`.tr_core`).  Each evaluation runs the Huber-smoothed TV-L1
primal–dual solve and the implicit hypergradient of the smoothed problem
(:mod:`..solvers.tvl1_huber`), with the JAX package's warm-start rules:

* the adjoint CG state p is chained across evaluations ALWAYS;
* the (u, y) solver state is chained only when ``inner_tol`` enables the
  early stop (``inner_tol=None``, parity mode, cold-starts every solve);
* there is no exact/regularized switch: the smoothed implicit gradient is
  the only branch, so the radius is ignored by the evaluation.

The parameter is a scalar α or an (m, n) patch grid upsampled by a
:class:`..ops.PatchOp`; the grid's gradient sums the per-image maps, then
applies the patch adjoint.  The solve goes through
:func:`..solvers.tvl1_cuda.tvl1_huber_denoise_cuda`: on the card it
launches the CUDA kernel, on the CPU it runs the plain version.  The
adjoint CG is plain PyTorch on either device, as the JAX package runs it
in jnp.  Segmented dispatch (``log_every``, ``segment_callback``,
``init_B``) is :func:`.fused.drive`'s; ``mesh=`` runs every evaluation per
shard, each shard chaining its own adjoint, and sums the cost and the
gradient (scalar, or the batch-summed map) over the shards before the
patch adjoint (:func:`.fused.evaluate`).
"""

from __future__ import annotations

import numpy as np
import torch

from ..learning.tvl1 import tvl1_local, tvl1_param_layout, tvl1_pullback
from ..solvers.hypergrad import HypergradConfig
from .fused import (FusedResult, _check_positive_x0, drive, evaluate,
                    learn_data, shapes)
from .tr_core import make_tr_machinery

__all__ = ["bilevel_learn_tvl1_fused", "tvl1_param_layout"]


def _machinery(data, mesh, *, pop, param_shape: tuple, maxiter: int, tol,
               eta1, eta2, beta1, beta2, inner_maxiter: int, inner_tol,
               check_every: int, gamma_d: float, cfg: HypergradConfig,
               tau0: float, sigma0: float, lbfgs_threshold: int,
               lbfgs_memory: int):
    dtype, _ = shapes(data, mesh)
    n = int(np.prod(param_shape, dtype=int))

    def eval_lf(xflat, delta, st):
        del delta   # smoothed implicit gradient: no exact/reg switch
        x = xflat.reshape(param_shape)

        def local(utrue, f, st):
            s0, p0 = (None, torch.zeros_like(f)) if st is None else st
            # inner state warm only with early stop; adjoint p chained
            # always
            warm = inner_tol is not None
            u, cost, grads, p, state, info = tvl1_local(
                x, utrue, f, p0, s0 if warm else None, pop=pop,
                gamma_d=gamma_d, cfg=cfg, maxiter=inner_maxiter, tau0=tau0,
                sigma0=sigma0, tol=inner_tol, check_every=check_every)
            return u, cost, grads, (state, p), info

        u, cost, grads, st, info = evaluate(local, data, st, mesh)
        g = tvl1_pullback(grads, pop)
        # one device → host read per evaluation: cost, gradient, CG flag
        host = torch.cat([cost.reshape(1), g.reshape(-1),
                          info.converged.to(dtype).reshape(1)]).cpu()
        cg_it = torch.tensor(float(info.iters), dtype=dtype)
        return u, host[0], host[1:1 + n], st, (cg_it, host[-1])

    return make_tr_machinery(
        eval_lf, n=n, dtype=dtype, maxiter=maxiter, tol=tol, eta1=eta1,
        eta2=eta2, beta1=beta1, beta2=beta2,
        lbfgs_threshold=lbfgs_threshold, lbfgs_memory=lbfgs_memory)


def bilevel_learn_tvl1_fused(ds, *, xinit, params,
                             inner_maxiter: int = 5000,
                             inner_tol: float | None = None,
                             check_every: int = 500,
                             gamma_d: float = 100.0,
                             gamma: float = 1000.0,
                             cg_tol=None, cg_maxiter: int = 2000,
                             tau0: float = 0.99, sigma0: float = 0.99,
                             mesh=None, log_every: int | None = None,
                             segment_callback=None, init_B=None,
                             device="cuda") -> FusedResult:
    """Run the TV-L1 trust-region bilevel learning (Huber-smoothed
    surrogate) on ``device``.

    Args:
      ds: ``(true_images, noisy_images)`` stacks, (O, M, N) or (M, N),
        as arrays or tensors (their dtype is the working dtype).
      xinit: scalar weight α or an (m, n) patch grid.
      params: eta1/eta2/beta1/beta2, delta0, maxiter, tol, and optionally
        lbfgs_threshold/lbfgs_memory.
      inner_tol: primal–dual early-stop tolerance; ``None`` runs the fixed
        budget every evaluation from a cold start.
      gamma_d / gamma: data / regularizer Huber slopes.
      cg_tol / cg_maxiter: adjoint-CG knobs (``cg_tol=None`` picks the
        dtype default).
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
    pop = tvl1_param_layout(x0, tuple(like.shape[-2:]))
    _check_positive_x0(x0)
    param_shape = tuple(x0.shape)
    cfg = HypergradConfig(gamma=float(gamma), cg_tol=cg_tol,
                          cg_maxiter=int(cg_maxiter))
    maxiter, tol = int(params.maxiter), float(params.get("tol", 0.0))
    machinery = _machinery(
        data, mesh, pop=pop, param_shape=param_shape,
        maxiter=maxiter, tol=tol,
        eta1=float(params.eta1), eta2=float(params.eta2),
        beta1=float(params.beta1), beta2=float(params.beta2),
        inner_maxiter=int(inner_maxiter),
        inner_tol=None if inner_tol is None else float(inner_tol),
        check_every=int(check_every), gamma_d=float(gamma_d), cfg=cfg,
        tau0=float(tau0), sigma0=float(sigma0),
        lbfgs_threshold=int(params.get("lbfgs_threshold", 64)),
        lbfgs_memory=int(params.get("lbfgs_memory", 10)))
    return drive(machinery, x0=x0, delta0=float(params.delta0),
                 param_shape=param_shape, maxiter=maxiter, tol=tol,
                 log_every=log_every, segment_callback=segment_callback,
                 init_B=init_B)
