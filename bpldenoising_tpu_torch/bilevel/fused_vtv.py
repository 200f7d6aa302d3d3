"""Trust-region vectorial-TV (color) bilevel learning with warm-chained
solver state (counterpart of ``bpldenoising_tpu.bilevel.fused_vtv``).

The VTV analogue of :mod:`.fused` on the same host trust-region loop
(:mod:`.tr_core`).  Each evaluation runs the channel-coupled PDPS solve on
planar (O, C, M, N) color stacks and the γ-Huber implicit hypergradient
(:func:`..solvers.vtv.vtv_implicit_cotangents`), with the JAX package's
warm-start rules:

* the (u, y) solver state and the adjoint multiplier λ are chained across
  evaluations only when ``inner_tol`` enables the early stop
  (``inner_tol=None``, parity mode, cold-starts every solve and every CG);
* there is no exact/regularized switch: the smoothed implicit gradient is
  the only branch, so the radius is ignored by the evaluation.

The parameter is a scalar α, a full-resolution (M, N) map, or an (m, n)
patch grid upsampled by a :class:`..ops.PatchOp`; a map's gradient sums
the per-image maps (the cotangent does), then a grid applies the patch
adjoint.  The solve goes through
:func:`..solvers.vtv_cuda.vtv_denoise_pdps_cuda`: on the card it launches
the CUDA kernel, on the CPU it runs the plain version.  The adjoint CG is
plain PyTorch on either device, as the JAX package runs it in jnp.
Segmented dispatch (``log_every``, ``segment_callback``, ``init_B``) is
:func:`.fused.drive`'s; ``mesh=`` shards the image axis (the channel
coupling is per pixel, so it stays on a shard), runs every evaluation per
shard and sums the cost and the cotangent over the shards before the patch
adjoint (:func:`.fused.evaluate`).
"""

from __future__ import annotations

import numpy as np
import torch

from ..learning.vtv import vtv_local, vtv_param_layout, vtv_pullback
from .fused import (FusedResult, _check_positive_x0, drive, evaluate,
                    learn_data, shapes)
from .tr_core import make_tr_machinery

__all__ = ["bilevel_learn_vtv_fused", "vtv_param_layout"]


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
            # parity discipline: inner_tol None = fixed budget, cold starts
            warm = inner_tol is not None
            u, cost, grads, state, lam, info = vtv_local(
                x, utrue, f, s0 if warm else None, lam0 if warm else None,
                pop=pop, maxiter=inner_maxiter, gamma=gamma, cg_tol=cg_tol,
                cg_maxiter=cg_maxiter, tau0=tau0, sigma0=sigma0,
                tol=inner_tol, check_every=check_every)
            return u, cost, grads, (state, lam), info

        u, cost, grads, st, info = evaluate(local, data, st, mesh)
        grad = vtv_pullback(grads, pop)
        # one device → host read per evaluation: cost, gradient, CG flag
        host = torch.cat([cost.reshape(1), grad.reshape(-1),
                          torch.all(info.converged).to(dtype).reshape(1)]
                         ).cpu()
        cg_it = torch.tensor(float(info.iters), dtype=dtype)
        return u, host[0], host[1:1 + n], st, (cg_it, host[-1])

    return make_tr_machinery(
        eval_lf, n=n, dtype=dtype, maxiter=maxiter, tol=tol, eta1=eta1,
        eta2=eta2, beta1=beta1, beta2=beta2,
        lbfgs_threshold=lbfgs_threshold, lbfgs_memory=lbfgs_memory)


def bilevel_learn_vtv_fused(ds, *, xinit, params,
                            inner_maxiter: int = 5000,
                            inner_tol: float | None = None,
                            check_every: int = 500, gamma: float = 1e-4,
                            cg_tol: float = 1e-6, cg_maxiter: int = 1000,
                            tau0: float = 5.0, sigma0: float = 0.99 / 5.0,
                            mesh=None, log_every: int | None = None,
                            segment_callback=None, init_B=None,
                            device="cuda") -> FusedResult:
    """Run the VTV trust-region bilevel learning on ``device``.

    Args:
      ds: ``(true_images, noisy_images)`` planar color stacks,
        (O, C, M, N) or (C, M, N), as arrays or tensors (their dtype is the
        working dtype).
      xinit: scalar coupling weight α, an (M, N) map or an (m, n) patch
        grid.
      params: eta1/eta2/beta1/beta2, delta0, maxiter, tol, and optionally
        lbfgs_threshold/lbfgs_memory.
      inner_tol: primal–dual early-stop tolerance; ``None`` runs the fixed
        budget every evaluation from a cold start.
      gamma / cg_tol / cg_maxiter: the Huber smoothing and the adjoint-CG
        knobs.
      mesh: data parallelism over a :class:`..parallel.mesh.Mesh` (the
        image axis), as in :func:`.fused.bilevel_learn_fused`.
      log_every / segment_callback / init_B: segmented dispatch and
        checkpoint resume, as in :func:`.fused.bilevel_learn_fused`.
      device: where the images and solver state live; ``"cuda"`` launches
        the CUDA kernel, ``"cpu"`` runs its plain version (with a mesh,
        its devices).

    Returns a :class:`.fused.FusedResult`.
    """
    shape = tuple(np.shape(ds[1]))
    if len(shape) not in (3, 4):
        raise ValueError(f"VTV expects (C, M, N) or (O, C, M, N) color "
                         f"stacks, got shape {shape}")
    data = learn_data(ds, device, mesh, log_every, image_ndim=3)
    dtype, like = shapes(data, mesh)
    x0 = torch.as_tensor(xinit, dtype=dtype).cpu()
    pop = vtv_param_layout(x0, tuple(like.shape[-2:]))
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
