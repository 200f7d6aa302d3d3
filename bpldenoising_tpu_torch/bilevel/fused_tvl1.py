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
in jnp.  Data parallelism (``mesh=``) and segmented dispatch
(``log_every``, checkpoints) are not ported yet.
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
from .fused import FusedResult, _check_positive_x0
from .tr_core import make_tr_machinery

__all__ = ["bilevel_learn_tvl1_fused", "tvl1_param_layout"]

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


def _machinery(utrue, f, *, pop, param_shape: tuple, maxiter: int, tol,
               eta1, eta2, beta1, beta2, inner_maxiter: int, inner_tol,
               check_every: int, gamma_d: float, cfg: HypergradConfig,
               tau0: float, sigma0: float, lbfgs_threshold: int,
               lbfgs_memory: int):
    dtype = f.dtype
    n = int(np.prod(param_shape, dtype=int))
    want_maps = pop is not None

    def alpha_of(xflat):
        x = xflat.reshape(param_shape)
        return x if pop is None else pop.apply(x).to(f.device)

    def pullback(g):
        """Hypergradient (scalar, or per-image (O, M, N) maps) → flat
        parameter gradient."""
        if want_maps:
            g = pop.apply_adjoint(torch.sum(g, dim=0))
        return g.reshape(-1)

    def eval_lf(xflat, delta, st):
        del delta   # smoothed implicit gradient: no exact/reg switch
        s0, p0 = (None, torch.zeros_like(f)) if st is None else st
        a = alpha_of(xflat)
        # inner state warm only with early stop; adjoint p chained always
        warm = inner_tol is not None
        u, state = tvl1_huber_denoise_cuda(
            f, a, gamma_d=gamma_d, gamma_r=cfg.gamma, tau0=tau0,
            sigma0=sigma0, maxiter=inner_maxiter, tol=inner_tol,
            check_every=check_every, state0=s0 if warm else None,
            return_dual=True)
        cost = 0.5 * torch.sum((u - utrue) ** 2)
        grads, p, info = tvl1_huber_hypergrad(
            u, f, utrue, (a,), _TV, cfg, want_maps, p0=p0, gamma_d=gamma_d)
        # one device → host read per evaluation: cost, gradient, CG flag
        host = torch.cat([cost.reshape(1), pullback(grads[0]),
                          info.converged.to(dtype).reshape(1)]).cpu()
        cg_it = torch.tensor(float(info.iters), dtype=dtype)
        return u, host[0], host[1:1 + n], (state, p), (cg_it, host[-1])

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
      device: where the images and solver state live; ``"cuda"`` launches
        the CUDA kernel, ``"cpu"`` runs its plain version.

    Returns a :class:`.fused.FusedResult`.
    """
    for name, value in (("mesh", mesh), ("log_every", log_every),
                        ("segment_callback", segment_callback),
                        ("init_B", init_B)):
        if value is not None:
            raise NotImplementedError(f"{name} is not ported yet")
    utrue = torch.as_tensor(ds[0]).to(device)
    f = torch.as_tensor(ds[1]).to(device=device, dtype=utrue.dtype)
    if f.ndim == 2:
        utrue, f = utrue[None], f[None]
    utrue, f = utrue.contiguous(), f.contiguous()
    x0 = torch.as_tensor(xinit, dtype=f.dtype).cpu()
    pop = tvl1_param_layout(x0, tuple(f.shape[-2:]))
    _check_positive_x0(x0)
    param_shape = tuple(x0.shape)
    cfg = HypergradConfig(gamma=float(gamma), cg_tol=cg_tol,
                          cg_maxiter=int(cg_maxiter))
    init_carry, cond, body = _machinery(
        utrue, f, pop=pop, param_shape=param_shape,
        maxiter=int(params.maxiter), tol=float(params.get("tol", 0.0)),
        eta1=float(params.eta1), eta2=float(params.eta2),
        beta1=float(params.beta1), beta2=float(params.beta2),
        inner_maxiter=int(inner_maxiter),
        inner_tol=None if inner_tol is None else float(inner_tol),
        check_every=int(check_every), gamma_d=float(gamma_d), cfg=cfg,
        tau0=float(tau0), sigma0=float(sigma0),
        lbfgs_threshold=int(params.get("lbfgs_threshold", 64)),
        lbfgs_memory=int(params.get("lbfgs_memory", 10)))
    carry = init_carry(x0, float(params.delta0))
    while cond(carry):
        carry = body(carry)
    it, x, _, _, fx, gx, u, _, log = carry
    return FusedResult(x=x.reshape(param_shape), u=u, cost=fx,
                       g_norm=torch.linalg.norm(gx), iterations=int(it),
                       log=log)
