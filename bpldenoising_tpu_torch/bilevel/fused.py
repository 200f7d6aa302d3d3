"""Trust-region bilevel learning with warm-chained solver state
(counterpart of ``bpldenoising_tpu.bilevel.fused``).

Each evaluation runs the PDPS inner solve (warm-started from the previous
evaluation's ``(u, ys)`` and early-stopped when ``inner_tol`` is set) and
the augmented-Lagrangian hypergradient, one joint system over the image
batch: the step of the host trust region's learning function
(:func:`..learning.tv.tv_step`).  Below the switch radius Δ ≤ Δt the
γ-regularized gradient branch replaces the exact one; each branch
warm-starts from ITS OWN previous adjoint, ``(p_exact, p_reg)``, because
the two systems have right-hand sides of opposite sign.

The parameter is a scalar α (TV), a (K,) vector (the sum of regularizers)
or a patch grid, (m, n) or (m, n, K), which a :class:`..ops.PatchOp`
upsamples to (M, N) weight maps; for patch parameters the hypergradient
returns per-image gradient maps, which are summed over the batch and pulled
back through the patch operator's adjoint.  The solver and hypergradient
calls go through the wrappers in :mod:`..solvers.pdps_cuda` and
:mod:`..solvers.hypergrad_cuda`: on the card they launch the CUDA kernels,
on the CPU they run the plain versions.  Data parallelism is not ported
yet.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..learning.tv import tv_step
from ..models import DenoiseModel, tv_model
from ..ops import PatchOp
from ..solvers.hypergrad import HypergradConfig
from .first_order import _check_positive_x0, _param_layout
from .tr_core import make_tr_machinery

__all__ = ["bilevel_learn_fused", "FusedResult"]

#: the ROADMAP.md §1 item of each keyword of the fused learners that is not
#: ported yet
UNPORTED_KEYWORDS = {"mesh": 10, "log_every": 7, "segment_callback": 7,
                     "init_B": 7}


def refuse_unported(**knobs) -> None:
    """Raise ``NotImplementedError`` for each knob that is not None, naming
    its ROADMAP.md item."""
    for name, value in knobs.items():
        if value is not None:
            raise NotImplementedError(
                f"{name} is not ported yet (ROADMAP.md §1 item "
                f"{UNPORTED_KEYWORDS[name]})")


class FusedResult(NamedTuple):
    x: torch.Tensor          # learned parameter (original shape, CPU)
    u: torch.Tensor          # reconstruction stack at x (on the device)
    cost: torch.Tensor
    g_norm: torch.Tensor
    iterations: int          # outer iterations actually run
    log: torch.Tensor        # (maxiter, 6): cost, ‖g‖, Δ, ‖accepted step‖,
                             #               adjoint-CG iters, converged
    times: Optional[np.ndarray] = None


def _machinery(utrue, f, *, model: DenoiseModel, pop: Optional[PatchOp],
               param_shape: tuple, maxiter: int, tol, eta1, eta2, beta1,
               beta2, inner_maxiter: int, inner_tol, check_every: int,
               delta_t: float, cfg: HypergradConfig, lbfgs_threshold: int,
               lbfgs_memory: int):
    """The trust-region loop pieces ``(init_carry, cond, body)``."""
    dtype = f.dtype
    n = int(np.prod(param_shape, dtype=int)) if param_shape else 1
    solver_kwargs = dict(tol=inner_tol, check_every=check_every)

    def eval_lf(xflat, delta, st):
        if st is None:
            state0 = None
            padjs = (torch.zeros_like(f), torch.zeros_like(f))
        else:
            state0, padjs = st
        is_exact = bool(delta > delta_t)
        p_exact, p_reg = padjs
        # parity mode (inner_tol None: a fixed budget) cold-starts every solve
        u, cost, g, p, state, info = tv_step(
            xflat.reshape(param_shape), utrue, f,
            p_exact if is_exact else p_reg,
            state0 if inner_tol is not None else None, model=model,
            method="exact" if is_exact else "reg", maxiter=inner_maxiter,
            cfg=cfg, pop=pop, solver_kwargs=solver_kwargs)
        padjs = (p, p_reg) if is_exact else (p_exact, p)
        cg_ok = torch.all(torch.as_tensor(info.converged, device=f.device))
        # one device → host read per evaluation: cost, the n-vector
        # gradient, CG flag
        host = torch.cat([cost.reshape(1), g.reshape(-1),
                          cg_ok.to(dtype).reshape(1)]).cpu()
        cg_it = torch.tensor(float(np.max(info.iters)), dtype=dtype)
        return u, host[0], host[1:1 + n], (state, padjs), (cg_it, host[-1])

    return make_tr_machinery(
        eval_lf, n=n, dtype=dtype, maxiter=maxiter, tol=tol, eta1=eta1,
        eta2=eta2, beta1=beta1, beta2=beta2,
        lbfgs_threshold=lbfgs_threshold, lbfgs_memory=lbfgs_memory)


def bilevel_learn_fused(ds, *, xinit, params, model: DenoiseModel = None,
                        inner_maxiter: int = 5000,
                        inner_tol: float | None = 1e-6,
                        check_every: int = 250, delta_t: float = 1e-6,
                        cfg: HypergradConfig = HypergradConfig(),
                        mesh=None, log_every: int | None = None,
                        segment_callback=None, init_B=None,
                        device="cuda") -> FusedResult:
    """Run the trust-region bilevel learning on ``device``.

    ``mesh``, ``log_every``, ``segment_callback`` and ``init_B`` are the
    JAX function's keywords: ``None`` runs, any other value raises
    ``NotImplementedError`` (not ported yet), as in the other families'
    learners.  The JAX function's ``backend=`` and ``interpret=`` are not
    taken, as in those learners: by the entry points' ``check_backend``
    rule the port has no backends, and ``device=`` chooses what runs.

    Args:
      ds: ``(true_images, noisy_images)`` stacks, (O, M, N) or (M, N),
        as arrays or tensors (their dtype is the working dtype).
      xinit: parameter initialization: a scalar or (m, n) patch grid
        (K == 1), a (K,) vector or an (m, n, K) patch stack.
      params: eta1/eta2/beta1/beta2, delta0, maxiter, tol, and optionally
        lbfgs_threshold/lbfgs_memory.
      inner_tol: PDPS early-stop tolerance; ``None`` runs the fixed budget
        from a cold start every evaluation (parity mode).
      device: where the images and solver state live; ``"cuda"`` launches
        the CUDA kernels, ``"cpu"`` runs their plain versions.
    """
    refuse_unported(mesh=mesh, log_every=log_every,
                    segment_callback=segment_callback, init_B=init_B)
    utrue = torch.as_tensor(ds[0]).to(device)
    f = torch.as_tensor(ds[1]).to(device=device, dtype=utrue.dtype)
    if f.ndim == 2:
        utrue, f = utrue[None], f[None]
    utrue, f = utrue.contiguous(), f.contiguous()
    model = model if model is not None else tv_model()
    x0 = torch.as_tensor(xinit, dtype=f.dtype).cpu()
    _check_positive_x0(x0)
    pop, param_shape = _param_layout(model, x0, tuple(f.shape[-2:]))
    init_carry, cond, body = _machinery(
        utrue, f, model=model, pop=pop, param_shape=param_shape,
        maxiter=int(params.maxiter), tol=float(params.get("tol", 0.0)),
        eta1=float(params.eta1), eta2=float(params.eta2),
        beta1=float(params.beta1), beta2=float(params.beta2),
        inner_maxiter=int(inner_maxiter),
        inner_tol=None if inner_tol is None else float(inner_tol),
        check_every=int(check_every), delta_t=float(delta_t), cfg=cfg,
        lbfgs_threshold=int(params.get("lbfgs_threshold", 64)),
        lbfgs_memory=int(params.get("lbfgs_memory", 10)))
    carry = init_carry(x0, float(params.delta0))
    while cond(carry):
        carry = body(carry)
    it, x, _, _, fx, gx, u, _, log = carry
    return FusedResult(x=x.reshape(param_shape), u=u, cost=fx,
                       g_norm=torch.linalg.norm(gx), iterations=int(it),
                       log=log)
