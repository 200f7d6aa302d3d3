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
on the CPU they run the plain versions.

With ``log_every=j`` the loop runs in segments of j outer iterations with
a host hop between them (:func:`.tr_core.run_segmented`): the result
gains per-iteration wall times (segment-end, cumulative) and
``segment_callback`` runs at every hop (checkpoints, per-iterate
snapshots).  The segments run the same body on the same carry, so a
segmented run gives the single run's numbers bit for bit; :func:`drive`
runs both forms for the four families' learners.

With ``mesh=`` (:mod:`..parallel.mesh`) the batch is zero-padded to a
multiple of the mesh's shards and every evaluation runs the step's local
part on each shard's sub-batch on its device (:func:`evaluate`), each
shard with its own warm state and its own early stop, as the JAX
package's ``shard_map`` decides them; the cost and the per-k gradients
are summed over the shards before the patch pullback.  The host loop is
the same.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..learning.tv import tv_local, tv_pullback
from ..models import DenoiseModel, tv_model
from ..ops import PatchOp
from ..parallel.mesh import (batch_devices, gather_u, psum, run_shards,
                             shard_dataset)
from ..solvers.hypergrad import HypergradConfig
from .first_order import _check_positive_x0, _param_layout
from .tr_core import IT, make_tr_machinery, run_segmented, splice_dense_B

__all__ = ["bilevel_learn_fused", "FusedResult", "drive", "evaluate",
           "learn_data"]


def learn_data(ds, device, mesh, log_every, image_ndim: int = 2):
    """A fused learner's data: ``(utrue, f)`` on ``device`` (a batch axis
    added to a single image, contiguous), or, with a mesh, this process's
    padded shards on the mesh's devices (:class:`..parallel.mesh.Sharded`;
    ``device`` is not read).  Segmented dispatch does not compose with a
    mesh, as in the JAX package."""
    if mesh is not None:
        if log_every is not None:
            raise ValueError("log_every (chunked dispatch) does not "
                             "compose with mesh= data parallelism; drive "
                             "segments from the host or drop log_every")
        return shard_dataset(ds, mesh, image_ndim)
    utrue = torch.as_tensor(ds[0]).to(device)
    f = torch.as_tensor(ds[1]).to(device=device, dtype=utrue.dtype)
    if f.ndim == image_ndim:
        utrue, f = utrue[None], f[None]
    return utrue.contiguous(), f.contiguous()


def evaluate(local, data, st, mesh):
    """One evaluation: ``local(utrue, f, st) -> (u, cost, grads, st,
    info)`` on the whole batch, or on a mesh on every shard (``st`` then
    one state per shard, None for a cold start), the cost and each of
    ``grads`` summed over the shards in shard order, ``u`` gathered and
    ``info`` the first shard's (the JAX mesh run's log reads its first
    device)."""
    if mesh is None:
        return local(data[0], data[1], st)
    sts = [None] * len(data.f) if st is None else st
    out = run_shards(batch_devices(mesh),
                     lambda i, ut, ff, s: local(ut, ff, s),
                     data.utrue, data.f, sts)
    us, costs, grads, new_sts, infos = zip(*out)
    return (gather_u(us, data.n_real), psum(costs),
            tuple(psum([g[k] for g in grads]) for k in range(len(grads[0]))),
            list(new_sts), infos[0])


def shapes(data, mesh):
    """``(dtype, like)`` of a learner's data: the working dtype and a
    tensor on the first device (where the pullback runs)."""
    f = data[1] if mesh is None else data.f[0]
    return f.dtype, f


class FusedResult(NamedTuple):
    x: torch.Tensor          # learned parameter (original shape, CPU)
    u: torch.Tensor          # reconstruction stack at x (on the device)
    cost: torch.Tensor
    g_norm: torch.Tensor
    iterations: int          # outer iterations actually run
    log: torch.Tensor        # (maxiter, 6): cost, ‖g‖, Δ, ‖accepted step‖,
                             #               adjoint-CG iters, converged
    times: Optional[np.ndarray] = None  # per-iteration cumulative wall
    # seconds, segmented runs only (segment-end: no sub-segment times)


def drive(machinery, *, x0, delta0, param_shape: tuple, maxiter: int,
          tol: float, log_every: int | None = None, segment_callback=None,
          init_B=None) -> FusedResult:
    """Run a family's trust-region loop ``machinery = (init_carry, cond,
    body)`` from ``x0`` (a CPU tensor in the working dtype) and radius
    ``delta0``: in one host loop, or with ``log_every`` in segments of that
    many outer iterations (:func:`.tr_core.run_segmented`), calling
    ``segment_callback(it, carry, elapsed_s)`` after each.  ``init_B``, a
    dense BFGS matrix, replaces the segmented run's initial model (ignored
    for L-BFGS).  As in the JAX function, a single run (no ``log_every``)
    ignores ``segment_callback`` and ``init_B``."""
    init_carry, cond, body = machinery

    def start():
        return splice_dense_B(init_carry(x0, delta0), init_B, x0.dtype)

    times = None
    if log_every is None:
        carry = init_carry(x0, delta0)
        while cond(carry):
            carry = body(carry)
    else:
        seg = int(log_every)

        def segment(c):
            it_end = c[IT] + seg
            while c[IT] < it_end and cond(c):
                c = body(c)
            return c

        carry, times = run_segmented(
            start, segment, maxiter=maxiter, tol=tol,
            segment_callback=segment_callback)
    it, x, _, _, fx, gx, u, _, log = carry
    return FusedResult(x=x.reshape(param_shape), u=u, cost=fx,
                       g_norm=torch.linalg.norm(gx), iterations=int(it),
                       log=log,
                       times=None if times is None else times[:int(it)])


def _machinery(data, mesh, *, model: DenoiseModel, pop: Optional[PatchOp],
               param_shape: tuple, maxiter: int, tol, eta1, eta2, beta1,
               beta2, inner_maxiter: int, inner_tol, check_every: int,
               delta_t: float, cfg: HypergradConfig, lbfgs_threshold: int,
               lbfgs_memory: int):
    """The trust-region loop pieces ``(init_carry, cond, body)``."""
    dtype, like = shapes(data, mesh)
    n = int(np.prod(param_shape, dtype=int)) if param_shape else 1
    solver_kwargs = dict(tol=inner_tol, check_every=check_every)

    def eval_lf(xflat, delta, st):
        is_exact = bool(delta > delta_t)
        x = xflat.reshape(param_shape)

        def local(utrue, f, st):
            if st is None:
                state0 = None
                padjs = (torch.zeros_like(f), torch.zeros_like(f))
            else:
                state0, padjs = st
            p_exact, p_reg = padjs
            # parity mode (inner_tol None: a fixed budget) cold-starts every
            # solve
            u, cost, grads, p, state, info = tv_local(
                x, utrue, f, p_exact if is_exact else p_reg,
                state0 if inner_tol is not None else None, model=model,
                method="exact" if is_exact else "reg", maxiter=inner_maxiter,
                cfg=cfg, pop=pop, solver_kwargs=solver_kwargs)
            padjs = (p, p_reg) if is_exact else (p_exact, p)
            return u, cost, grads, (state, padjs), info

        u, cost, grads, st, info = evaluate(local, data, st, mesh)
        g = tv_pullback(grads, x, pop, like)
        cg_ok = torch.all(torch.as_tensor(info.converged,
                                          device=cost.device))
        # one device → host read per evaluation: cost, the n-vector
        # gradient, CG flag
        host = torch.cat([cost.reshape(1), g.reshape(-1),
                          cg_ok.to(dtype).reshape(1)]).cpu()
        cg_it = torch.tensor(float(np.max(info.iters)), dtype=dtype)
        return u, host[0], host[1:1 + n], st, (cg_it, host[-1])

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

    ``mesh`` (a :class:`..parallel.mesh.Mesh`) shards the batch over its
    devices (see the module's docstring); it does not compose with
    ``log_every``.  The JAX function's ``backend=`` and ``interpret=`` are
    not taken, as in the other families' learners: by the entry points'
    ``check_backend`` rule the port has no backends, and ``device=``
    chooses what runs.

    Args:
      ds: ``(true_images, noisy_images)`` stacks, (O, M, N) or (M, N),
        as arrays or tensors (their dtype is the working dtype).
      xinit: parameter initialization: a scalar or (m, n) patch grid
        (K == 1), a (K,) vector or an (m, n, K) patch stack.
      params: eta1/eta2/beta1/beta2, delta0, maxiter, tol, and optionally
        lbfgs_threshold/lbfgs_memory.
      inner_tol: PDPS early-stop tolerance; ``None`` runs the fixed budget
        from a cold start every evaluation (parity mode).
      log_every: segmented dispatch: a host hop every this many outer
        iterations; the result gains per-iteration (segment-end) wall
        ``times`` and ``segment_callback(it, carry, elapsed_s)`` runs at
        every hop (carry layout: ``(it, x_flat, Bst, delta, fx, gx, u,
        state, log)`` with ``state = (pdps_state, (p_exact, p_reg))``).
      init_B: a dense BFGS matrix to start from (checkpoint resume;
        ignored for the L-BFGS model).  Segmented mode only: a single run
        ignores it and ``segment_callback``, as the JAX function does.
      device: where the images and solver state live; ``"cuda"`` launches
        the CUDA kernels, ``"cpu"`` runs their plain versions (with a mesh,
        its devices).
    """
    data = learn_data(ds, device, mesh, log_every)
    dtype, like = shapes(data, mesh)
    model = model if model is not None else tv_model()
    x0 = torch.as_tensor(xinit, dtype=dtype).cpu()
    _check_positive_x0(x0)
    pop, param_shape = _param_layout(model, x0, tuple(like.shape[-2:]))
    maxiter, tol = int(params.maxiter), float(params.get("tol", 0.0))
    machinery = _machinery(
        data, mesh, model=model, pop=pop, param_shape=param_shape,
        maxiter=maxiter, tol=tol,
        eta1=float(params.eta1), eta2=float(params.eta2),
        beta1=float(params.beta1), beta2=float(params.beta2),
        inner_maxiter=int(inner_maxiter),
        inner_tol=None if inner_tol is None else float(inner_tol),
        check_every=int(check_every), delta_t=float(delta_t), cfg=cfg,
        lbfgs_threshold=int(params.get("lbfgs_threshold", 64)),
        lbfgs_memory=int(params.get("lbfgs_memory", 10)))
    return drive(machinery, x0=x0, delta0=float(params.delta0),
                 param_shape=param_shape, maxiter=maxiter, tol=tol,
                 log_every=log_every, segment_callback=segment_callback,
                 init_B=init_B)
