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
plain PyTorch on either device, as the JAX package runs it in jnp.  Data
parallelism (``mesh=``) and segmented dispatch (``log_every``,
checkpoints) are not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from ..learning.vtv import vtv_param_layout, vtv_step
from .fused import FusedResult, _check_positive_x0, refuse_unported
from .tr_core import make_tr_machinery

__all__ = ["bilevel_learn_vtv_fused", "vtv_param_layout"]


def _machinery(utrue, f, *, pop, param_shape: tuple, maxiter: int, tol,
               eta1, eta2, beta1, beta2, inner_maxiter: int, inner_tol,
               check_every: int, gamma: float, cg_tol: float,
               cg_maxiter: int, tau0: float, sigma0: float,
               lbfgs_threshold: int, lbfgs_memory: int):
    dtype = f.dtype
    n = int(np.prod(param_shape, dtype=int))

    def eval_lf(xflat, delta, st):
        del delta   # smoothed implicit gradient: no exact/reg switch
        s0, lam0 = (None, None) if st is None else st
        # parity discipline: inner_tol None = fixed budget, cold starts
        warm = inner_tol is not None
        u, cost, grad, state, lam, info = vtv_step(
            xflat.reshape(param_shape), utrue, f, s0 if warm else None,
            lam0 if warm else None, pop=pop, maxiter=inner_maxiter,
            gamma=gamma, cg_tol=cg_tol, cg_maxiter=cg_maxiter, tau0=tau0,
            sigma0=sigma0, tol=inner_tol, check_every=check_every)
        # one device → host read per evaluation: cost, gradient, CG flag
        host = torch.cat([cost.reshape(1), grad.reshape(-1),
                          torch.all(info.converged).to(dtype).reshape(1)]
                         ).cpu()
        cg_it = torch.tensor(float(info.iters), dtype=dtype)
        return u, host[0], host[1:1 + n], (state, lam), (cg_it, host[-1])

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
      device: where the images and solver state live; ``"cuda"`` launches
        the CUDA kernel, ``"cpu"`` runs its plain version.

    Returns a :class:`.fused.FusedResult`.
    """
    refuse_unported(mesh=mesh, log_every=log_every,
                    segment_callback=segment_callback, init_B=init_B)
    utrue = torch.as_tensor(ds[0]).to(device)
    f = torch.as_tensor(ds[1]).to(device=device, dtype=utrue.dtype)
    if f.ndim == 3:
        utrue, f = utrue[None], f[None]
    if f.ndim != 4:
        raise ValueError(f"VTV expects (C, M, N) or (O, C, M, N) color "
                         f"stacks, got shape {tuple(f.shape)}")
    utrue, f = utrue.contiguous(), f.contiguous()
    x0 = torch.as_tensor(xinit, dtype=f.dtype).cpu()
    pop = vtv_param_layout(x0, tuple(f.shape[-2:]))
    _check_positive_x0(x0)
    param_shape = tuple(x0.shape)
    init_carry, cond, body = _machinery(
        utrue, f, pop=pop, param_shape=param_shape,
        maxiter=int(params.maxiter), tol=float(params.get("tol", 0.0)),
        eta1=float(params.eta1), eta2=float(params.eta2),
        beta1=float(params.beta1), beta2=float(params.beta2),
        inner_maxiter=int(inner_maxiter),
        inner_tol=None if inner_tol is None else float(inner_tol),
        check_every=int(check_every), gamma=float(gamma),
        cg_tol=float(cg_tol), cg_maxiter=int(cg_maxiter), tau0=float(tau0),
        sigma0=float(sigma0),
        lbfgs_threshold=int(params.get("lbfgs_threshold", 64)),
        lbfgs_memory=int(params.get("lbfgs_memory", 10)))
    carry = init_carry(x0, float(params.delta0))
    while cond(carry):
        carry = body(carry)
    it, x, _, _, fx, gx, u, _, log = carry
    return FusedResult(x=x.reshape(param_shape), u=u, cost=fx,
                       g_norm=torch.linalg.norm(gx), iterations=int(it),
                       log=log)
