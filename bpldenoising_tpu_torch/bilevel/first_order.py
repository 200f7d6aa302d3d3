"""Single-loop first-order bilevel learning (counterpart of
``bpldenoising_tpu.bilevel.first_order``).

Instead of solving the lower-level problem to convergence for every outer
evaluation, the inner primal–dual state, the adjoint state and the
parameter advance together.  Per outer step:

1. ``n_inner`` fixed-step (unaccelerated) Chambolle–Pock iterations at the
   current α, warm-started;
2. ``n_adj`` preconditioned-CG iterations on the γ-smoothed adjoint system
   at the current iterate, warm-started (:mod:`.pcg`);
3. an Adam step on log α (positive by construction) with the approximate
   hypergradient.

Every parameterization of the experiment suite: scalar α and (m, n) patch
α for the TV model, a (3,) vector and an (m, n, 3) patch stack for the
sum-of-regularizers model (any K with forward, backward or centred
gradients).

:func:`single_loop_learn` runs where ``f`` lives: the plain PyTorch loop
below (:func:`_single_loop_plain`, :func:`_tv_plain_stepper`'s steps) for
tensors on the CPU, the CUDA learner of :mod:`.first_order_cuda`
(``csrc/single_loop.cu``) for CUDA tensors, which raises for what it does
not take.  Neither reads anything back to the host until the segment
ends.  Not ported: ``optimizer=`` (an optax transformation has no PyTorch
counterpart to take), which raises ``NotImplementedError``.

:func:`drive_single_loop` runs every family's learner on a mesh
(:mod:`..parallel.mesh`): the batch is zero-padded to a multiple of the
shards, and each shard's stepper runs its outer steps in lockstep with the
others.  A step stops at every point where the JAX package's scan takes a
``psum``: it yields its local values, :func:`_lockstep` sums each over the
shards on the first device in shard order (:func:`..parallel.mesh.psum`)
and sends the sums back.  The TGV², TV-L1 and VTV learners take per-image CG
dots, so their steps have one such point (the gradient maps and the
cost); this module's TV and sum-of-regularizers learner takes its CG dots
over the whole batch, so its steps also stop at every inner product of
the CG (2·n_adj + 1 classic, n_adj pipelined).  Every shard's update (the
pullback and Adam) runs on the sums, so z, Adam's moments and t stay
replicated.  An all-padding shard adds exactly +0.
"""

from __future__ import annotations

import inspect
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..models import DenoiseModel, sumregs_model, tv_model
from ..ops import PatchOp, scalarprod, xi
from ..parallel.mesh import (batch_devices, gather_u, psum, run_shards,
                             shard_dataset)
from ..solvers.hypergrad import build_reg_system
from .pcg import CG_STEPS, CG_VARIANTS, _default_vdot, local_sums

__all__ = ["single_loop_learn", "single_loop_tv_learn",
           "single_loop_sumregs_learn", "drive_single_loop",
           "SingleLoopResult", "PlainStepper"]


class SingleLoopResult(NamedTuple):
    alpha: torch.Tensor             # learned parameter (original shape)
    u: torch.Tensor                 # final reconstruction stack (O, M, N)
    cost: torch.Tensor              # final ½Σ‖u−ū‖²
    alpha_trajectory: torch.Tensor  # (outer, *param_shape)
    cost_trajectory: torch.Tensor   # (outer,)
    # (outer,) ‖dJ/dα‖₂ per outer step
    gnorm_trajectory: Optional[torch.Tensor] = None
    # host-side cumulative wall seconds per iteration, filled only by the
    # segment runner (log_every); segment-end granularity
    times: Optional[np.ndarray] = None


def _check_positive_x0(x0):
    """The parameter lives in log space (x = exp(z)): zero freezes it and
    negatives produce NaN, so reject them up front."""
    if bool(torch.any(torch.as_tensor(x0) <= 0)):
        raise ValueError(
            "x0 must be strictly positive: the parameter is optimized in "
            "log space, so 0 freezes it and negatives produce NaN")


def _param_layout(model: DenoiseModel, x0, image_shape):
    """→ (pop, param_shape): the PatchOp of a patch parameter (or None)
    and the parameter's shape."""
    x0 = torch.as_tensor(x0)
    K = model.K
    shape = tuple(x0.shape)
    if K == 1:
        if x0.ndim == 0:
            return None, shape
        if x0.ndim == 2:
            return PatchOp(shape, tuple(image_shape)), shape
    else:
        if x0.ndim == 1 and shape[0] == K:
            return None, shape
        if x0.ndim == 3 and shape[-1] == K:
            return PatchOp(shape[:2], tuple(image_shape)), shape
    raise ValueError(f"unsupported parameter shape {shape} for K={K}")


def opt_init(f, x0, param_shape: tuple):
    """The parameter part of every learner's initial carry: z = log x₀,
    zero Adam moments, step 0, in f's dtype on its device."""
    dtype, dev = f.dtype, f.device
    zeros = torch.zeros(param_shape, dtype=dtype, device=dev)
    return (torch.log(torch.as_tensor(x0, dtype=dtype).to(dev)),
            (zeros, zeros.clone()), torch.zeros((), dtype=dtype, device=dev))


def dual_zeros(f, planes: int = 2):
    """A zero field of ``planes`` components per image of ``f``:
    (..., planes, M, N)."""
    return torch.zeros(f.shape[:-2] + (planes,) + f.shape[-2:],
                       dtype=f.dtype, device=f.device)


def step_sizes(opnorm_sq, tau0, sigma0, dtype, device=None):
    """(τ, σ) = (τ₀, σ₀)/√opnorm_sq in the working dtype."""
    L = torch.sqrt(torch.tensor(opnorm_sq, dtype=dtype, device=device))
    return (torch.tensor(tau0, dtype=dtype, device=device) / L,
            torch.tensor(sigma0, dtype=dtype, device=device) / L)


def expand(pop, x):
    """A scalar or patch parameter → the per-pixel weight (a scalar or an
    (M, N) map)."""
    return pop.apply(x) if pop is not None else x


def pullback(pop, g_map):
    """A per-pixel gradient map (O, M, N) → the parameter's shape: summed
    over everything for a scalar, over the batch and each patch for a
    grid."""
    if pop is None:
        return torch.sum(g_map)
    return pop.apply_adjoint(torch.sum(g_map, dim=0))


def _init_carry(f, x0, *, K: int, param_shape: tuple):
    """Initial carry ``(u, ys, p, z, (m, v), t)``: u = f, K zero dual
    fields, zero adjoint, z = log x₀, zero Adam moments, step 0."""
    ys0 = tuple(dual_zeros(f) for _ in range(K))
    return (f, ys0, torch.zeros_like(f)) + opt_init(f, x0, param_shape)


def _tile_vdot(tile_b: int):
    """Inner products per group of ``tile_b`` images, broadcast back to
    each image as a (B, 1, 1) tensor (the per-tile dots of TPU kernel 10,
    ``first_order_pallas.py::_tiled_kernel``)."""
    def vdot(a, b):
        prod = (a * b).reshape(a.shape[0], -1)
        B = prod.shape[0]
        n_tiles = -(-B // tile_b)
        pad = n_tiles * tile_b - B
        if pad:
            prod = torch.cat([prod, prod.new_zeros((pad, prod.shape[1]))])
        sums = prod.reshape(n_tiles, -1).sum(dim=1)
        return sums.repeat_interleave(tile_b)[:B].reshape(B, 1, 1)
    return vdot


def _tv_plain_stepper(utrue, f, carry, *, model: DenoiseModel, outer: int,
                      n_inner: int, n_adj: int, pop: Optional[PatchOp],
                      param_shape: tuple, lr, gamma, tau0, sigma0, beta1,
                      beta2, eps, cg_variant: str = "classic",
                      tile_b: Optional[int] = None) -> "PlainStepper":
    """The plain learner's steps from ``carry`` ``(u, ys, p, z, (m, v),
    t)``, in the order of the JAX package's scan (``first_order.py:
    175-211``): PD steps, the adjoint system, CG, the gradient maps, the
    pullback, Adam with ``beta1 ** t``, the cost.  ``utrue``/``f`` are (O,
    M, N).  The local part yields at every CG inner product
    (:data:`.pcg.CG_STEPS`).  ``tile_b`` takes the CG's inner products per
    group of ``tile_b`` images (TPU kernel 10); ``None`` takes them over
    the whole batch."""
    dtype = f.dtype
    K = model.K
    tau, sigma = step_sizes(model.opnorm_sq(), tau0, sigma0, dtype, f.device)
    tiny = torch.finfo(dtype).tiny
    vdot = _default_vdot if tile_b is None else _tile_vdot(int(tile_b))
    cg_steps = CG_STEPS[cg_variant]

    def alphas_of(x):
        """Parameter → K-tuple of per-image α (scalar or (M, N) map)."""
        if K == 1:
            return (expand(pop, x),)
        if pop is None:
            return tuple(x[k] for k in range(K))
        return tuple(pop.apply(x[..., k]) for k in range(K))

    def pull(gmaps):
        """K per-pixel gradient maps (summed over batch) → parameter."""
        if K == 1:
            g = gmaps[0]
            return pop.apply_adjoint(g) if pop is not None else torch.sum(g)
        if pop is None:
            return torch.stack([torch.sum(g) for g in gmaps])
        return torch.stack([pop.apply_adjoint(g) for g in gmaps], dim=-1)

    def pd_step(alphas, u, ys):
        div = None
        for op, y in zip(model.ops, ys):
            d = op.apply_adjoint(y)
            div = d if div is None else div + d
        u_new = (u - tau * (div - f)) / (1.0 + tau)
        ubar = 2.0 * u_new - u            # fixed-step (unaccelerated) CP
        ys_new = []
        for op, y, a in zip(model.ops, ys, alphas):
            q = y + sigma * op.apply(ubar)
            n = xi(q)
            r = a[None] if a.ndim >= 2 else a   # an α map over the batch
            scale = torch.where(n <= r, 1.0, r / torch.clamp(n, min=tiny))
            ys_new.append(q * scale[..., None, :, :])
        return u_new, tuple(ys_new)

    def local(state, x):
        u, ys, p = state
        alphas = alphas_of(x)
        for _ in range(int(n_inner)):
            u, ys = pd_step(alphas, u, ys)
        M_apply, inv_diag, fields = build_reg_system(u, alphas, model, gamma)
        p = yield from cg_steps(M_apply, inv_diag, utrue - u, p, n_adj,
                                vdot=vdot)
        gmaps = tuple(torch.sum(scalarprod(op.apply(p), field), dim=0)
                      for op, field in zip(model.ops, fields))
        return (u, ys, p), gmaps, 0.5 * torch.sum((u - utrue) ** 2)

    return PlainStepper(local, pull, lambda g_x, x: g_x * x, carry,
                        param_shape=param_shape, lr=lr, beta1=beta1,
                        beta2=beta2, eps=eps)


def _tv_u_and_z(carry):
    return carry[0], carry[3]


def _single_loop_plain(utrue, f, x0, *, model: DenoiseModel, outer: int,
                       param_shape: tuple, carry0=None,
                       return_carry: bool = False, **kw):
    """The single-loop learner as a Python loop over ``outer`` steps
    (:func:`_tv_plain_stepper`, every inner product its local value)."""
    if carry0 is None:
        carry0 = _init_carry(f, x0, K=model.K, param_shape=param_shape)
    stepper = _tv_plain_stepper(utrue, f, carry0, model=model, outer=outer,
                                param_shape=param_shape, **kw)
    return run_steps(stepper, utrue, outer, _tv_u_and_z, return_carry)


def adam_step(z, opt_state, t, g_z, *, lr, beta1, beta2, eps):
    """One Adam step on z with gradient ``g_z``, in the order of the JAX
    package's scans (``beta1 ** t`` after ``t ← t + 1``).  → (z, (m, v),
    t)."""
    m, v = opt_state
    t = t + 1
    m = beta1 * m + (1 - beta1) * g_z
    v = beta2 * v + (1 - beta2) * g_z ** 2
    mhat = m / (1 - beta1 ** t)
    vhat = v / (1 - beta2 ** t)
    return z - lr * mhat / (torch.sqrt(vhat) + eps), (m, v), t


def kernel_result(utrue, u, z, outer, trajs):
    """A CUDA learner's segment → :class:`SingleLoopResult`: ``trajs`` is
    (α trajectory, cost trajectory, ‖g‖ trajectory) on the card; the final
    cost is the last step's (the state does not move after it)."""
    xs, costs, gnorms = trajs
    cost = costs[-1] if outer > 0 else 0.5 * torch.sum((u - utrue) ** 2)
    return SingleLoopResult(alpha=torch.exp(z), u=u, cost=cost,
                            alpha_trajectory=xs, cost_trajectory=costs,
                            gnorm_trajectory=gnorms)


def _stack(items, shape, dtype, device):
    if items:
        return torch.stack(items)
    return torch.empty((0,) + tuple(shape), dtype=dtype, device=device)


def prepare_learn(utrue, f, x0, image_ndim: int, layout):
    """The inputs of one family's learn → (utrue, f, x0, pop, param_shape,
    squeeze): the images as in :func:`prepare_images`, x0 checked and
    beside them, and ``layout(x0, image_shape)``, its PatchOp or None."""
    utrue, f, squeeze = prepare_images(utrue, f, image_ndim)
    x0 = torch.as_tensor(x0, dtype=utrue.dtype)
    _check_positive_x0(x0)
    pop = layout(x0, tuple(f.shape[-2:]))
    return utrue, f, x0.to(f.device), pop, tuple(x0.shape), squeeze


def prepare_images(utrue, f, image_ndim: int):
    """The images of a learn as a stack on f's device in utrue's dtype: a
    single image (``image_ndim`` dimensions) gains a batch axis (the
    gradient maps are reduced over axis 0).  → (utrue, f, squeeze)."""
    utrue = torch.as_tensor(utrue)
    f = torch.as_tensor(f).to(utrue.dtype)
    utrue = utrue.to(f.device)
    squeeze = f.ndim == image_ndim
    if squeeze:
        utrue, f = utrue[None], f[None]
    return utrue, f, squeeze


def check_unported(optimizer) -> None:
    """``optimizer=`` of the JAX learners raises here."""
    if optimizer is not None:
        raise NotImplementedError(
            "optimizer= takes an optax transformation, which has no "
            "PyTorch counterpart here; the built-in Adam runs")


def _prepare(utrue, f, x0, model: DenoiseModel):
    """Inputs of a learn → (utrue, f, x0, pop, param_shape, squeeze): the
    images as an (O, M, N) stack, x0 checked and beside them, and the
    parameter layout."""
    utrue, f, squeeze = prepare_images(utrue, f, 2)
    x0 = torch.as_tensor(x0, dtype=utrue.dtype)
    _check_positive_x0(x0)
    x0 = x0.to(f.device)
    pop, param_shape = _param_layout(model, x0, f.shape[-2:])
    return utrue, f, x0, pop, param_shape, squeeze


def run_segment(plain, launch, init_carry, u_and_z, utrue, f, x0, *,
                outer: int, param_shape: tuple, carry0=None,
                return_carry: bool = False, **kw):
    """One segment of a learner where ``f`` lives: ``plain`` for CPU
    tensors; for any other, ``launch()`` (the CUDA learner, imported at
    call time), which raises unless the tensors are on the card and for
    what it does not take.  ``init_carry(f)`` is the cold carry and
    ``u_and_z(carry)`` its (u, z).  → :class:`SingleLoopResult` (and the
    carry)."""
    if f.device.type == "cpu":
        return plain(utrue, f, x0, outer=outer, param_shape=param_shape,
                     carry0=carry0, return_carry=return_carry, **kw)
    if carry0 is None:
        carry0 = init_carry(f)
    carry, trajs = launch()(utrue, f, carry0, outer=int(outer),
                            param_shape=param_shape, **kw)
    res = kernel_result(utrue, *u_and_z(carry), outer, trajs)
    return (res, carry) if return_carry else res


class PlainStepper:
    """A plain learner's outer steps on one (sub-)batch, split where the
    JAX package's scan sums over the shards.  ``local(state, x) → (state,
    gmaps, cost)`` is a step's local part at x = exp(z) (``gmaps`` a tuple
    of per-pixel gradient maps, ``cost`` ½Σ(u − ū)² of the sub-batch); a
    generator function there yields its own sum points first (the TV
    learner's CG dots).  :meth:`update` takes the maps and cost summed
    over the shards: ``pull(gmaps)`` → g_x, then Adam on z with
    ``grad_z(g_x, x)``.  The carry is the family's, its last three entries
    z, (m, v) and t."""

    def __init__(self, local, pull, grad_z, carry, *, param_shape: tuple,
                 lr, beta1, beta2, eps):
        self.local_fn, self.pull, self.grad_z = local, pull, grad_z
        self.state = carry[:-3]
        self.z, self.opt, self.t = carry[-3:]
        self.adam = dict(lr=lr, beta1=beta1, beta2=beta2, eps=eps)
        self.param_shape = param_shape
        self.xs, self.costs, self.gnorms = [], [], []

    def step(self, o: int):
        """Step ``o`` as a generator of the stepper protocol: each yield is
        a tuple of this shard's values to sum over the shards, and the
        tuple of sums comes back; the last is the gradient maps and the
        cost, and the update runs on their sums."""
        self.x = torch.exp(self.z)
        out = self.local_fn(self.state, self.x)
        if inspect.isgenerator(out):
            out = yield from out
        self.state, gmaps, cost = out
        total = yield tuple(gmaps) + (cost,)
        self.update(o, total[:-1], total[-1])

    def update(self, o: int, gmaps, cost) -> None:
        g_x = self.pull(gmaps)
        self.z, self.opt, self.t = adam_step(
            self.z, self.opt, self.t, self.grad_z(g_x, self.x), **self.adam)
        # each cost is paired with the α that PRODUCED it; gnorm is taken
        # on g_x, before the chain rule
        self.xs.append(self.x)
        self.costs.append(cost)
        self.gnorms.append(torch.sqrt(torch.sum(g_x ** 2)))

    def finish(self):
        """→ (carry, (α, cost, ‖g‖ trajectories))."""
        dtype, dev = self.z.dtype, self.z.device
        return (self.state + (self.z, self.opt, self.t),
                (_stack(self.xs, self.param_shape, dtype, dev),
                 _stack(self.costs, (), dtype, dev),
                 _stack(self.gnorms, (), dtype, dev)))


def run_steps(stepper, utrue, outer: int, u_and_z, return_carry: bool):
    """``outer`` steps of one stepper on the whole batch, every sum its
    local value → :class:`SingleLoopResult` (and the carry)."""
    for o in range(int(outer)):
        local_sums(stepper.step(o))
    carry, trajs = stepper.finish()
    res = kernel_result(utrue, *u_and_z(carry), outer, trajs)
    return (res, carry) if return_carry else res


def _cuda_launch():
    from .first_order_cuda import _launch
    return _launch


def _tv_stepper(utrue, f, carry, **kw):
    """One shard's steps of a mesh segment where ``f`` lives: the plain
    stepper on the CPU, the CUDA learner's session in its mesh form
    otherwise (which raises for tensors off the card)."""
    if f.device.type == "cpu":
        return _tv_plain_stepper(utrue, f, carry, **kw)
    from .first_order_cuda import Session
    return Session(utrue, f, carry, mesh=True, **kw)


def _single_loop_impl(utrue, f, x0, *, model: DenoiseModel, outer: int,
                      param_shape: tuple, carry0=None,
                      return_carry: bool = False, **kw):
    """One segment of the learner where ``f`` lives (:func:`run_segment`).
    ``utrue`` and ``f`` are (O, M, N)."""
    return run_segment(
        _single_loop_plain, _cuda_launch,
        lambda ff: _init_carry(ff, x0, K=model.K, param_shape=param_shape),
        _tv_u_and_z, utrue, f, x0, model=model, outer=outer,
        param_shape=param_shape, carry0=carry0, return_carry=return_carry,
        **kw)


def single_loop_learn(utrue, f, x0, model: DenoiseModel, *,
                      outer: int = 300, n_inner: int = 40, n_adj: int = 10,
                      lr: float = 0.05, gamma: float = 1e4,
                      tau0: float = 5.0, sigma0: float = 0.99 / 5.0,
                      beta1: float = 0.9, beta2: float = 0.999,
                      eps: float = 1e-8, mesh=None, optimizer=None,
                      log_every: Optional[int] = None,
                      segment_callback=None,
                      cg_variant: str = "classic") -> SingleLoopResult:
    """Single-loop bilevel learning for any model and parameterization,
    on the device ``f`` lives on.  ``x0`` must be strictly positive (the
    parameter lives in log space).  ``log_every=j`` runs ``j``-step
    segments with a host hop between them and fills ``times``.  ``mesh``
    (a batch mesh of :mod:`..parallel.mesh`) shards the batch, with the
    CG's inner products, the gradient maps and the cost summed over the
    shards."""
    check_unported(optimizer)
    if cg_variant not in CG_VARIANTS:
        raise ValueError(f"cg_variant must be one of {sorted(CG_VARIANTS)}, "
                         f"got {cg_variant!r}")
    utrue, f, x0, pop, param_shape, squeeze = _prepare(utrue, f, x0, model)
    kw = dict(model=model, outer=int(outer), n_inner=int(n_inner),
              n_adj=int(n_adj), pop=pop, param_shape=param_shape, lr=lr,
              gamma=gamma, tau0=tau0, sigma0=sigma0, beta1=beta1,
              beta2=beta2, eps=eps, cg_variant=str(cg_variant))
    res = drive_single_loop(
        _single_loop_impl, utrue, f, x0, kw,
        make_carry0=lambda ff: _init_carry(ff, x0, K=model.K,
                                           param_shape=param_shape),
        log_every=log_every, segment_callback=segment_callback, mesh=mesh,
        stepper=_tv_stepper, u_and_z=_tv_u_and_z)
    if squeeze:
        res = res._replace(u=res.u[0])
    return res


def drive_single_loop(impl, utrue, f, x0, kw, *, make_carry0,
                      log_every=None, segment_callback=None, mesh=None,
                      stepper=None, u_and_z=None) -> SingleLoopResult:
    """Host loop over the segments of a single-loop learner.

    ``impl(utrue, f, x0, *, carry0, return_carry, **kw)`` runs ``kw
    ["outer"]`` steps and returns a :class:`SingleLoopResult` (and the
    carry).  ``log_every=None`` runs the whole loop as one call;
    ``log_every=j`` runs ``j``-step segments that hand the carry on (u,
    the duals, p, log α, Adam's moments and step counter), waits for each
    to finish and records ``times[i]``, the cumulative wall seconds at the
    end of the segment that ran step ``i``; ``segment_callback(done,
    elapsed)`` runs after each segment.  The CUDA library is built before
    the clock starts.  With ``mesh``, :func:`_drive_mesh` runs the
    segments with ``stepper(utrue, f, carry, **kw)`` on every shard (a
    :class:`PlainStepper` or a CUDA learner's session, each with a
    ``step(o)`` generator and ``finish()``) and ``u_and_z(carry)`` reads a
    carry's u and z."""
    if mesh is not None:
        return _drive_mesh(stepper, u_and_z, utrue, f, kw,
                           make_carry0=make_carry0, mesh=mesh,
                           log_every=log_every,
                           segment_callback=segment_callback)
    if log_every is None:
        return impl(utrue, f, x0, **kw)
    if f.device.type == "cuda":
        from .. import _build
        _build.library()
    log_every = int(log_every)
    outer = kw["outer"]
    carry = make_carry0(f)
    times = np.zeros((outer,), np.float64)
    pieces = []
    done = 0
    t0 = time.perf_counter()
    while done < outer:
        seg = min(log_every, outer - done)
        res_seg, carry = impl(utrue, f, x0, carry0=carry, return_carry=True,
                              **dict(kw, outer=seg))
        if f.device.type == "cuda":
            torch.cuda.synchronize(f.device)
        elapsed = time.perf_counter() - t0
        times[done:done + seg] = elapsed
        pieces.append(res_seg)
        done += seg
        if segment_callback is not None:
            segment_callback(done, elapsed)
    return pieces[-1]._replace(
        alpha_trajectory=torch.cat([p.alpha_trajectory for p in pieces]),
        cost_trajectory=torch.cat([p.cost_trajectory for p in pieces]),
        gnorm_trajectory=torch.cat([p.gnorm_trajectory for p in pieces]),
        times=times)


def _sync(devices) -> None:
    for d in set(devices):
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def _advance(gen, sums):
    """Send ``sums`` to a step's generator: → its next yield, or None when
    the step has ended."""
    try:
        return gen.send(sums)
    except StopIteration:
        return None


def _lockstep(devices, steps, o: int) -> None:
    """Step ``o`` of every shard's stepper in lockstep: at each sum point
    the shards' yields are summed position by position on the first device
    in shard order (:func:`..parallel.mesh.psum`) and each shard gets the
    sums on its device."""
    gens = [st.step(o) for st in steps]
    outs = run_shards(devices, lambda i, g: _advance(g, None), gens)
    while outs[0] is not None:
        if any(v is None or len(v) != len(outs[0]) for v in outs):
            raise RuntimeError(f"the shards' steppers left lockstep at step "
                               f"{o}")
        sums = tuple(psum([v[j] for v in outs]) for j in range(len(outs[0])))
        outs = run_shards(devices, lambda i, g: _advance(
            g, tuple(s.to(devices[i]) for s in sums)), gens)
    if any(v is not None for v in outs):
        raise RuntimeError(f"the shards' steppers left lockstep at step {o}")


def _drive_mesh(stepper, u_and_z, utrue, f, kw, *, make_carry0, mesh,
                log_every, segment_callback) -> SingleLoopResult:
    """The segments of a learner on a mesh.  The batch is zero-padded to a
    multiple of the shards and each shard starts from ``make_carry0`` of
    its sub-batch; each segment makes one stepper a shard (on its device,
    from the shard's carry) and runs the outer steps in lockstep
    (:func:`_lockstep`).  The α, cost and ‖g‖ trajectories are the first
    shard's (every shard's are the same), u is gathered without the
    padding and the final cost is the last step's, the shards' sum."""
    devices = batch_devices(mesh)
    data = shard_dataset((utrue, f), mesh, image_ndim=f.ndim - 1)
    uts, fs = data.utrue, data.f
    carries = [make_carry0(ff) for ff in fs]
    if any(d.type == "cuda" for d in devices):
        from .. import _build
        _build.library()
    outer = kw["outer"]
    seg_len = outer if log_every is None else max(int(log_every), 1)
    times = np.zeros((outer,), np.float64)
    pieces = []
    done = 0
    t0 = time.perf_counter()
    while True:
        k = min(seg_len, outer - done)
        steps = run_shards(
            devices, lambda i, ut, ff, c: stepper(ut, ff, c,
                                                  **dict(kw, outer=k)),
            uts, fs, carries)
        for o in range(k):
            _lockstep(devices, steps, o)
        fin = run_shards(devices, lambda i, st: st.finish(), steps)
        carries = [c for c, _ in fin]
        pieces.append(fin[0][1])
        done += k
        if log_every is not None:
            _sync(devices)
            elapsed = time.perf_counter() - t0
            times[done - k:done] = elapsed
            if segment_callback is not None:
                segment_callback(done, elapsed)
        if done >= outer:
            break
    us = [u_and_z(c)[0] for c in carries]
    xs, costs, gnorms = (torch.cat([p[j] for p in pieces])
                         for j in range(3))
    # the last step's cost, as the unsharded learners give it (the state
    # does not move after it)
    cost = costs[-1] if outer > 0 else psum(
        [0.5 * torch.sum((u - ut) ** 2) for u, ut in zip(us, uts)])
    return SingleLoopResult(
        alpha=torch.exp(u_and_z(carries[0])[1]),
        u=gather_u(us, data.n_real), cost=cost, alpha_trajectory=xs,
        cost_trajectory=costs, gnorm_trajectory=gnorms,
        times=None if log_every is None else times)


_TV = tv_model()


def single_loop_tv_learn(utrue, f, alpha0=0.1, **kwargs) -> SingleLoopResult:
    """Scalar/patch TV convenience wrapper."""
    return single_loop_learn(utrue, f, alpha0, _TV, **kwargs)


def single_loop_sumregs_learn(utrue, f, alpha0,
                              **kwargs) -> SingleLoopResult:
    """Sum-of-regularizers convenience wrapper ((3,) or (m, n, 3) α)."""
    return single_loop_learn(utrue, f, alpha0, sumregs_model(), **kwargs)
