"""Data-parallel learning functions over a device mesh (counterpart of
``bpldenoising_tpu.parallel.sharded``).

The image batch is padded to a multiple of the mesh's shards and split
over them (:mod:`.mesh`); every shard runs the unsharded evaluation on its
sub-batch on its device, and the cost and the gradient are summed over the
shards (:func:`.mesh.psum`, in shard order on the first device) before the
patch pullback.  The trust region that calls the function is oblivious to
the sharding.

* TV and the sum of regularizers: per shard, the unsharded evaluation up
  to the pullback (:func:`..learning.tv.tv_local`: kernel A at the fixed
  budget from a cold start, then kernel B, exact or γ-regularized, one
  joint system over the local sub-batch, warm-started from that shard's
  previous adjoint ``p`` of the same branch).  The adjoints stay on
  their devices in a bounded cache keyed by the branch, the parameter and
  padded shapes and the dataset anchor's identity (the entry holds the
  anchor, so a recycled ``id`` cannot alias other data).  Adjoint-CG
  telemetry is the mesh-worst: max iterations, max residual, all
  converged.
* TGV², VTV and TV-L1: per shard, the differentiable layer of the family
  (:func:`..solvers.tgv.make_diff_tgv_denoise`, …: the forward on rows 4,
  6 and 8, the backward one plain CG with per-image dots), and
  ``torch.autograd.grad`` of the weighted cost.  TV-L1 upsamples a patch
  grid before the shards and pulls the summed gradient back after them.

Padded images have f = 0, so they solve to u = 0 = ū exactly and their
adjoint right-hand side, CG iterates, cost and gradient terms are exactly
zero; the smoothed families' costs carry the explicit weights as the JAX
functions do.
"""

from __future__ import annotations

from collections import OrderedDict
import numpy as np
import torch

from ..learning.tv import tv_local, tv_pullback
from ..models import sumregs_model, tv_model
from ..ops import PatchOp
from ..solvers.hypergrad import HypergradConfig
from ..solvers.krylov import KrylovInfo
from ..utils.telemetry import _worst as worst_of
from ..utils.telemetry import record_adjoint_cg
from .mesh import (Mesh, batch_devices, gather_u, host_reduce, psum,
                   run_shards, shard_dataset)

__all__ = ["make_sharded_tv_learning_function",
           "make_sharded_sumregs_learning_function",
           "make_sharded_tgv_learning_function",
           "make_sharded_vtv_learning_function",
           "make_sharded_tvl1_learning_function"]


def _tv_family(mesh: Mesh, model, grid_ndim: int, maxiter: int,
               cfg: HypergradConfig, delta_t: float):
    """A TV-family sharded learning function: per shard
    :func:`..learning.tv.tv_local` (kernel A at the fixed budget from a cold
    start, then kernel B warm-started from that shard's previous adjoint),
    the K gradients summed over the shards, then
    :func:`..learning.tv.tv_pullback`.  A parameter with ``grid_ndim`` axes
    or more is a patch grid.  The function is its own telemetry holder
    (``lf.adjoint_cg``, ``lf.last_adjoint_cg``)."""
    devices = batch_devices(mesh)
    p_state: OrderedDict = OrderedDict()
    MAX_ENTRIES = 8

    def learning_function(x, ds, delta):
        sh = shard_dataset(ds, mesh)
        x = torch.as_tensor(np.asarray(x), dtype=sh.utrue[0].dtype)
        pop = (PatchOp(tuple(x.shape[:2]), tuple(sh.f[0].shape[-2:]))
               if x.ndim >= grid_ndim else None)
        method = "exact" if float(delta) > delta_t else "reg"
        anchor = ds[0]
        # one entry per parameter shape too, as the JAX package builds one
        # function (and one cache) per shape
        key = (method, tuple(x.shape), len(devices),
               tuple(sh.utrue[0].shape), id(anchor))
        entry = p_state.get(key)
        p0 = (entry[0] if entry is not None and entry[1] is anchor
              else [None] * len(devices))

        def local(i, ut, ff, p):
            u, cost, grads, p, _, info = tv_local(
                x, ut, ff, p, None, model=model, method=method,
                maxiter=maxiter, cfg=cfg, pop=pop)
            return u, cost, grads, p, info

        out = run_shards(devices, local, sh.utrue, sh.f, p0)
        u, costs, grads, ps, infos = zip(*out)
        gsum = tuple(psum([g[k] for g in grads]) for k in range(model.K))
        p_state[key] = (list(ps), anchor)
        p_state.move_to_end(key)
        while len(p_state) > MAX_ENTRIES:
            p_state.popitem(last=False)
        iters, res, conv = zip(*(worst_of(info) for info in infos))
        record_adjoint_cg(learning_function, KrylovInfo(
            int(host_reduce(iters, "max")),
            torch.tensor(host_reduce(res, "max")),
            torch.tensor(bool(host_reduce(conv, "min")))))
        return (gather_u(u, sh.n_real), psum(costs),
                tv_pullback(gsum, x, pop, sh.f[0]))

    return learning_function


def make_sharded_tv_learning_function(
        mesh: Mesh, *, maxiter: int = 5000, delta_t: float = 1e-6,
        cfg: HypergradConfig = HypergradConfig(), backend: str = "auto",
        interpret: bool = False):
    """Sharded equivalent of
    :func:`..learning.tv.tv_learning_function` (the same L4 contract,
    scalar or patch parameter).  ``backend`` and ``interpret`` are the JAX
    function's keywords: ``"auto"`` and False only (the shard's device
    chooses what runs)."""
    from ..solvers.implicit import check_layer_backend
    check_layer_backend(backend, interpret)
    return _tv_family(mesh, tv_model(), 2, int(maxiter), cfg, delta_t)


def make_sharded_sumregs_learning_function(
        mesh: Mesh, *, maxiter: int = 5000, delta_t: float = 1e-3,
        cfg: HypergradConfig = HypergradConfig(), backend: str = "auto",
        interpret: bool = False):
    """Sharded equivalent of
    :func:`..learning.sumregs.sumregs_learning_function` ((3,) weights or
    an (m, n, 3) patch stack)."""
    from ..solvers.implicit import check_layer_backend
    check_layer_backend(backend, interpret)
    return _tv_family(mesh, sumregs_model(), 3, int(maxiter), cfg, delta_t)


def _smoothed(mesh: Mesh, layer, weights_of, image_ndim: int,
              pullback=None):
    """A smoothed family's sharded learning function: per shard,
    ``layer(f, weights_of(a))`` and ``torch.autograd.grad`` of the weighted
    cost with respect to ``a`` (the parameter, or the upsampled map that
    ``pullback`` carries back), then the sums over the shards."""
    devices = batch_devices(mesh)

    def local(i, ut, ff, ww, a):
        a = a.detach().to(ff.device if a.ndim >= 2 else "cpu")
        a.requires_grad_(True)
        with torch.enable_grad():
            u = layer(ff, weights_of(a))
            wb = ww.reshape((-1,) + (1,) * (u.ndim - 1))
            cost = 0.5 * torch.sum(wb * (u - ut) ** 2)
            (grad,) = torch.autograd.grad(cost, a)
        return u.detach(), cost.detach(), grad

    def learning_function(x, ds, delta):
        del delta
        sh = shard_dataset(ds, mesh, image_ndim)
        x = torch.as_tensor(np.asarray(x), dtype=sh.utrue[0].dtype)
        a, back = (x, None) if pullback is None else pullback(x, sh.f[0])
        out = run_shards(devices, lambda i, *s: local(i, *s, a),
                         sh.utrue, sh.f, sh.w)
        u, costs, grads = zip(*out)
        grad = psum(grads)
        if back is not None:
            grad = back(grad)
        return gather_u(u, sh.n_real), psum(costs), grad

    return learning_function


def make_sharded_tgv_learning_function(
        mesh: Mesh, *, maxiter: int = 5000, gamma: float = 1e-4,
        cg_tol: float = 1e-6, cg_maxiter: int = 1000, backend: str = "auto",
        interpret: bool = False):
    """Sharded equivalent of
    :func:`..learning.tgv.tgv_learning_function` for x = (α₁, α₀): per
    shard the TGV² layer (the forward on row 4, the backward one plain CG
    with per-image dots, so the sharded gradient equals the unsharded one
    but for the order of the sums)."""
    from ..solvers.tgv import make_diff_tgv_denoise
    layer = make_diff_tgv_denoise(maxiter=maxiter, gamma=gamma,
                                  cg_tol=cg_tol, cg_maxiter=cg_maxiter,
                                  backend=backend, interpret=interpret)
    return _smoothed(mesh, layer, lambda x: (x[0], x[1]), 2)


def make_sharded_vtv_learning_function(
        mesh: Mesh, *, maxiter: int = 5000, gamma: float = 1e-4,
        cg_tol: float = 1e-6, cg_maxiter: int = 1000, backend: str = "auto",
        interpret: bool = False):
    """Sharded equivalent of
    :func:`..learning.vtv.vtv_learning_function`: the (O, C, M, N) batch
    shards on the image axis (the channel coupling is per pixel, so it
    never crosses shards); per shard the VTV layer (row 6, one plain CG
    with per-image dots)."""
    from ..solvers.vtv import make_diff_vtv_denoise
    layer = make_diff_vtv_denoise(maxiter=maxiter, gamma=gamma,
                                  cg_tol=cg_tol, cg_maxiter=cg_maxiter,
                                  backend=backend, interpret=interpret)
    return _smoothed(mesh, layer, lambda x: x, 3)


def make_sharded_tvl1_learning_function(
        mesh: Mesh, *, maxiter: int = 5000, gamma_d: float = 100.0,
        gamma: float = 1000.0, cg_tol: float | None = None,
        cg_maxiter: int = 2000):
    """Sharded equivalent of
    :func:`..learning.tvl1.tvl1_learning_function`: per shard the
    Huber-smoothed TV-L1 layer (row 8, one plain CG with per-image dots).
    A patch grid is upsampled before the shards (the (M, N) map goes to
    every shard) and the summed gradient is pulled back through the patch
    operator's adjoint after them."""
    from ..solvers.tvl1_huber import make_diff_tvl1_denoise
    layer = make_diff_tvl1_denoise(maxiter=maxiter, gamma_d=gamma_d,
                                   gamma=gamma, cg_tol=cg_tol,
                                   cg_maxiter=cg_maxiter)

    def pullback(x, like):
        if x.ndim == 2 and tuple(x.shape) != tuple(like.shape[-2:]):
            pop = PatchOp(tuple(x.shape), tuple(like.shape[-2:]))
            return pop.apply(x), pop.apply_adjoint
        return x, None

    return _smoothed(mesh, layer, lambda x: x, 2, pullback=pullback)
