"""The single-loop learner as a CUDA kernel (``csrc/single_loop.cu``),
replacing the TPU kernels ``bpldenoising_tpu/bilevel/first_order_pallas.py::
_kernel`` (the resident one-launch learner) and ``::_tiled_kernel`` (the
same learner over batch tiles, with per-tile CG inner products).

:func:`single_loop_cuda`, :func:`single_loop_cuda_tiled` and
:func:`single_loop_tv_cuda` take the arguments of the JAX package's
``single_loop_pallas``, ``single_loop_pallas_tiled`` and
``single_loop_tv_pallas`` and return the same ``(x, u, traj)``: ``traj``
is the α trajectory for scalar TV and the cost trajectory otherwise.  They
go through :func:`.first_order._single_loop_impl`, which decides the
device: the plain version for tensors on the CPU, the kernel (launched by
:func:`_launch` here) for CUDA tensors, or an error for what it does not
take.

The card has no VMEM budget, so nothing is rerouted:
:func:`single_loop_cuda` always takes its inner products over the whole
batch (the jnp scan's semantics), and :func:`single_loop_cuda_tiled` does
too unless ``tile_b`` is given, in which case the CG's inner products (so
its α and β) are taken per group of ``tile_b`` images as TPU kernel 10
takes them; the gradient and the cost are summed over the whole batch
either way.  ``persist`` and ``interpret`` are accepted for signature
parity and change nothing here (the JAX package documents ``persist`` as
bit-identical either way).

:func:`_launch` runs one segment on the card through a :class:`Session`
in its single form: it takes and returns the carry ``(u, ys, p, z, (m,
v), t)`` and always returns all three trajectories.  On a mesh
(``single_loop_learn(..., mesh=)``) each shard's :class:`Session` runs in
its mesh form: one CG group a shard, each step piece by piece up to each
sum point (every CG inner product, then the gradient maps and the cost),
the sums over the shards written back on the card between the pieces.  :func:`pd_plan` (from :mod:`..solvers.cluster_plan`,
shared with kernel A) chooses the PD phase's thread-block cluster: one
cluster per image, each CTA a band of rows held in shared memory for the
whole phase.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..models import DenoiseModel, tv_model
from ..ops import BwdGradientOp, CenteredGradientOp, FwdGradientOp
from ..solvers.cluster_plan import (MAX_CLUSTER, SMEM_PER_BLOCK, PdPlan,
                                    pd_plan)
from ..solvers.pdps_cuda import check_cuda_input, check_plane
from .first_order import _prepare, _single_loop_impl, step_sizes
from .pcg import CG_VARIANTS

__all__ = ["single_loop_cuda", "single_loop_cuda_tiled",
           "single_loop_tv_cuda", "stencil_cuda", "pd_plan", "PdPlan",
           "MAX_CLUSTER", "SMEM_PER_BLOCK", "launches", "kernel_launches",
           "launches_per_step", "Session"]

#: sessions of the CUDA learner (one per segment, and per shard on a mesh)
launches = 0
#: kernel launches they issued on the card (as the C loop counts them:
#: 4 + 2·n_adj per outer step with the classic CG, 5 + n_adj with the
#: pipelined one, and one per segment, in the single and the mesh form)
kernel_launches = 0

# stencil kinds of csrc/single_loop.cu, in the order of ops/grad.py
_KINDS = {FwdGradientOp: 0, BwdGradientOp: 1, CenteredGradientOp: 2}
_MAX_K = 8   # SL_MAXK in csrc/single_loop.cu

_TV = tv_model()


#: the parts of a step that one call of rows 11–13's C loop runs
#: (``single_loop.cuh``'s SlxParts)
SLX_BEGIN, SLX_LOCAL, SLX_UPDATE, SLX_ALL = 1, 2, 4, 7


def run_session(session, outer: int):
    """The single form: ``outer`` steps in one call → (carry,
    trajectories)."""
    session.call(0, int(outer), SLX_ALL)
    return session.finish()


class KernelSession:
    """One segment of a single-loop learner of rows 11–13 on the card: a
    family's subclass checks the carry and sets the buffers and arguments
    (``f``, ``utrue``, ``state`` — the state tensors in the C entry's order
    —, ``opt`` from :func:`pack_opt`, ``scratch``, ``fn``, ``args`` up to
    ``outer``, ``consts`` after the parts, ``what`` for errors,
    ``parts_of`` for the mesh parts and ``counters``, its module, whose
    ``launches`` counts sessions and ``kernel_launches`` the kernels they
    issue) and :meth:`finish` (→ carry, trajectories).

    :meth:`call` launches some parts of a range of steps: the single form
    is one call with ``SLX_ALL``.  The mesh form runs :meth:`step` a step:
    the CP phase, CG and gradient maps, one sum point, then the pullback
    and Adam on the sums."""

    def count_session(self, **latest) -> None:
        with _build.COUNTS:
            self.counters.launches += 1
            for name, value in latest.items():
                setattr(self.counters, name, value)

    def call(self, o0: int, o1: int, parts: int) -> None:
        """Launch ``parts`` of steps ``o0`` … ``o1`` − 1 on the card."""
        issued = ctypes.c_int(0)
        with torch.cuda.device(self.f.device):
            stream = torch.cuda.current_stream(self.f.device).cuda_stream
            err = self.fn(
                *(a.data_ptr() for a in (self.f, self.utrue) + self.state),
                *(a.data_ptr() for a in self.opt), self.scratch.data_ptr(),
                *self.args, o0, o1, parts, *self.consts,
                ctypes.byref(issued), stream)
        with _build.COUNTS:
            self.counters.kernel_launches += issued.value
        _build.check(err, self.what)

    def step(self, o: int):
        """Step ``o`` of the stepper protocol
        (:func:`.first_order._lockstep`): step o's local part (after the
        segment's ``slx_begin`` at o = 0); its one sum point, views of the
        scratch buffer holding the K·M·N gradient maps summed over the
        local batch and the cost partials; the sums over the shards
        written into them; step o's pullback and Adam."""
        if o == 0:
            offs = (ctypes.c_longlong * 4)()
            self.parts_of(offs)
            self.gmap = self.scratch[offs[0]:offs[0] + offs[1]]
            self.cost_part = self.scratch[offs[2]:offs[2] + offs[3]]
            self.call(0, 0, SLX_BEGIN)
        self.call(o, o + 1, SLX_LOCAL)
        mine = (self.gmap, self.cost_part)
        total = yield mine
        for a, b in zip(mine, total):
            write_sum(a, b)
        self.call(o, o + 1, SLX_UPDATE)


def write_sum(mine, total) -> None:
    """Write a sum over the shards into this shard's buffer ``mine`` (a
    one-shard mesh hands back the buffer itself)."""
    if mine.data_ptr() != total.data_ptr():
        mine.copy_(total)


def launches_per_step(n_adj: int, cg_variant: str = "classic") -> int:
    """The kernel launches of one outer step with ``n_inner`` > 0, in the
    single and in the mesh form (which cuts the same launches into pieces
    at its sum points)."""
    if cg_variant == "classic":
        return 4 + 2 * n_adj
    return 4 + n_adj + (1 if n_adj > 0 else 0)


def _kinds_code(model: DenoiseModel) -> int:
    """The model's stencils packed two bits per regularizer."""
    if model.channels or not 1 <= model.K <= _MAX_K:
        raise NotImplementedError(
            f"the CUDA single-loop learner takes 1 to {_MAX_K} gradient "
            "regularizers without channels")
    code = 0
    for k, op in enumerate(model.ops):
        kind = _KINDS.get(type(op))
        if kind is None:
            raise NotImplementedError(
                f"the CUDA single-loop learner has no stencil for {op!r}")
        code |= kind << (2 * k)
    return code


def _to_kp(x, K: int, P: int):
    """Parameter layout → the kernel's (K, P): an (m, n, K) stack puts K
    first; every other shape is already K-major."""
    if x.ndim == 3:
        x = x.permute(2, 0, 1)
    return x.reshape(K, P)


def _from_kp(x, param_shape: tuple):
    """The kernel's (..., K, P) → (..., *param_shape)."""
    lead = tuple(x.shape[:-2])
    if len(param_shape) == 3:
        m, n, K = param_shape
        x = x.reshape(lead + (K, m, n))
        return x.permute(*range(len(lead)), len(lead) + 1, len(lead) + 2,
                         len(lead))
    return x.reshape(lead + tuple(param_shape))


def pack_opt(z, m, v, t, param_shape: tuple, K: int, P: int, outer: int,
             like):
    """The parameter part of a carry → the kernels' device buffers: zmv
    (3, K, P) (z = log α and Adam's moments, K-major), the step counter
    (1,) and the (outer, K, P), (outer,), (outer,) trajectories, all
    checked against ``param_shape`` and copied (the kernels write them)."""
    for name, a in (("z", z), ("m", m), ("v", v)):
        check_plane(a, param_shape, like, f"carry {name}")
    check_plane(t, (), like, "carry t")
    dtype, dev = like.dtype, like.device
    zmv = torch.stack([_to_kp(a, K, P) for a in (z, m, v)]).contiguous()
    return (zmv, t.reshape(1).clone(),
            torch.empty((outer, K, P), dtype=dtype, device=dev),
            torch.empty((outer,), dtype=dtype, device=dev),
            torch.empty((outer,), dtype=dtype, device=dev))


def unpack_opt(zmv, t, traj_x, traj_cost, traj_gnorm, param_shape: tuple):
    """The buffers of :func:`pack_opt` after a launch → (z, (m, v), t) and
    the (α, cost, ‖g‖) trajectories in the parameter's layout."""
    return ((_from_kp(zmv[0], param_shape),
             (_from_kp(zmv[1], param_shape), _from_kp(zmv[2], param_shape)),
             t.reshape(())),
            (_from_kp(traj_x, param_shape), traj_cost, traj_gnorm))


def adam_args(lr, beta1, beta2, eps):
    """Adam's constants as the kernels take them: 1 − β formed in double,
    as PyTorch casts a Python scalar."""
    return (float(lr), float(beta1), float(beta2), 1.0 - float(beta1),
            1.0 - float(beta2), float(eps))


class Session:
    """One segment of rows 9–10's learner on the card from ``carry`` ``(u,
    ys, p, z, (m, v), t)``; the shapes and dtypes of every argument are
    checked before the device.

    The single form (:meth:`run`) launches the whole segment in one call of
    the C loop.  The mesh form (``mesh=True``, a shard of a batch mesh,
    whose batch is one CG group) runs each step as a generator
    (:meth:`step`, the protocol of :func:`.first_order._lockstep`): each
    call of the C loop launches the kernels up to the step's next sum
    point and says where this shard's values to sum lie in the scratch
    buffer (ρ, d·Md or the pair (γ, δ) of the CG, then the gradient maps
    and the cost partials); the step yields views of them, writes the sums
    into them on the card and goes on, and the next kernels form a and β
    from the sums.  Nothing is read back to the host."""

    def __init__(self, utrue, f, carry, *, model, outer, n_inner, n_adj,
                 pop, param_shape, lr, gamma, tau0, sigma0, beta1, beta2,
                 eps, cg_variant="classic", tile_b=None, mesh=False):
        check_cuda_input(f)
        if f.ndim != 3:
            raise ValueError(f"expected an (O, M, N) stack, got "
                             f"{tuple(f.shape)}")
        check_plane(utrue, f.shape, f, "utrue")
        code = _kinds_code(model)
        if cg_variant not in CG_VARIANTS:
            raise ValueError(f"unknown cg_variant {cg_variant!r}")
        dtype, dev = f.dtype, f.device
        B, M, N = (int(s) for s in f.shape)
        K = model.K
        pm, pn = (1, 1) if pop is None else pop.size_in
        P = pm * pn
        tile_b = B if tile_b is None or mesh else int(tile_b)
        if tile_b < 1:
            raise ValueError(f"tile_b must be positive, got {tile_b}")
        tile_b = min(tile_b, B)
        u, ys, p, z, (m, v), t = carry
        check_plane(u, f.shape, f, "carry u")
        check_plane(p, f.shape, f, "carry p")
        if len(ys) != K:
            raise ValueError(f"carry needs {K} dual fields, got {len(ys)}")
        for y in ys:
            check_plane(y, (B, 2, M, N), f, "carry y")
        self.opt = pack_opt(z, m, v, t, param_shape, K, P, outer, f)
        self.f, self.utrue = f.contiguous(), utrue.contiguous()
        self.state = (u.contiguous().clone(),
                      torch.stack(tuple(ys)).contiguous(),  # (K, B, 2, M, N)
                      p.contiguous().clone())
        plan = pd_plan(M, N, K, f.element_size())
        lib = _build.library()
        self.scratch = torch.empty((lib.bpl_sl_scratch(
            B, M, N, K, pm, pn, tile_b, plan.cluster, plan.rows,
            int(plan.resident)),), dtype=dtype, device=dev)
        # τ and σ in the working dtype, as the plain version forms them
        tau, sigma = (float(s) for s in step_sizes(model.opnorm_sq(), tau0,
                                                   sigma0, dtype))
        self.fn = lib.bpl_single_loop_f32 if dtype == torch.float32 \
            else lib.bpl_single_loop_f64
        self.args = (B, M, N, K, code, pm, pn, tile_b, plan.cluster,
                     plan.rows, int(plan.resident), int(outer), int(n_inner),
                     int(n_adj), int(cg_variant == "pipelined"))
        self.consts = (tau, sigma, float(gamma),
                       *adam_args(lr, beta1, beta2, eps))
        self.what = f"single-loop kernel (PD cluster {plan})"
        self.K, self.param_shape = K, param_shape
        global launches
        with _build.COUNTS:
            launches += 1

    def call(self, o: int, piece: int):
        """Launch piece ``piece`` of step ``o`` (the single form's whole
        segment for ``piece`` < 0) → the views of this shard's values to
        sum before the next piece (none after the last)."""
        global kernel_launches
        sums = (ctypes.c_longlong * 4)()
        issued = ctypes.c_int(0)
        with torch.cuda.device(self.f.device):
            stream = torch.cuda.current_stream(self.f.device).cuda_stream
            err = self.fn(
                *(a.data_ptr() for a in (self.f, self.utrue) + self.state),
                *(a.data_ptr() for a in self.opt), self.scratch.data_ptr(),
                *self.args, int(o), int(piece), *self.consts, sums,
                ctypes.byref(issued), stream)
        with _build.COUNTS:
            kernel_launches += issued.value
        _build.check(err, self.what)
        return tuple(self.scratch[sums[i]:sums[i] + sums[i + 1]]
                     for i in (0, 2) if sums[i + 1] > 0)

    def run(self):
        """The single form: every step of the segment → (carry,
        trajectories)."""
        self.call(0, -1)
        return self.finish()

    def step(self, o: int):
        """Step ``o`` of the mesh form, piece by piece."""
        piece = 0
        while True:
            mine = self.call(o, piece)
            if not mine:
                return
            total = yield mine
            for a, b in zip(mine, total):
                write_sum(a, b)
            piece += 1

    def finish(self):
        u, ysk, p = self.state
        (z, mv, t), trajs = unpack_opt(*self.opt, self.param_shape)
        return (u, tuple(ysk[k] for k in range(self.K)), p, z, mv, t), trajs


def _launch(utrue, f, carry, **kw):
    """Run ``outer`` steps from ``carry`` on the card in one call; →
    (carry, (α trajectory, cost trajectory, gnorm trajectory))."""
    return Session(utrue, f, carry, **kw).run()


def _run(utrue, f, x0, model, kw, tile_b=None):
    """The library entry points' common path → (x, u, traj)."""
    model = model if model is not None else _TV
    utrue, f, x0, pop, param_shape, squeeze = _prepare(utrue, f, x0, model)
    res = _single_loop_impl(utrue, f, x0, model=model, pop=pop,
                            param_shape=param_shape, tile_b=tile_b, **kw)
    traj = (res.alpha_trajectory if model.K == 1 and x0.ndim == 0
            else res.cost_trajectory)
    return res.alpha, (res.u[0] if squeeze else res.u), traj


def single_loop_cuda(utrue, f, x0, model: DenoiseModel = None, *,
                     outer: int = 300, n_inner: int = 40, n_adj: int = 10,
                     lr: float = 0.05, gamma: float = 1e4,
                     tau0: float = 5.0, sigma0: float = 0.99 / 5.0,
                     beta1: float = 0.9, beta2: float = 0.999,
                     eps: float = 1e-8, interpret: bool = False,
                     persist: bool | None = None,
                     cg_variant: str = "classic"):
    """Single-loop learning for any parameterization (scalar / (m, n)
    patch / (K,) vector / (m, n, K) patch stack ``x0``), inner products
    over the whole batch.  ``interpret`` and ``persist`` change nothing.
    → ``(x, u, traj)``."""
    return _run(utrue, f, x0, model, dict(
        outer=outer, n_inner=n_inner, n_adj=n_adj, lr=lr, gamma=gamma,
        tau0=tau0, sigma0=sigma0, beta1=beta1, beta2=beta2, eps=eps,
        cg_variant=cg_variant))


def single_loop_cuda_tiled(utrue, f, x0, model: DenoiseModel = None, *,
                           outer: int = 300, n_inner: int = 40,
                           n_adj: int = 10, lr: float = 0.05,
                           gamma: float = 1e4, tau0: float = 5.0,
                           sigma0: float = 0.99 / 5.0, beta1: float = 0.9,
                           beta2: float = 0.999, eps: float = 1e-8,
                           tile_b: int | None = None,
                           interpret: bool = False):
    """The same learner with the classic CG's inner products taken per
    group of ``tile_b`` images (TPU kernel 10); ``tile_b=None`` is one
    tile, the scan's semantics.  → ``(x, u, traj)``."""
    return _run(utrue, f, x0, model, dict(
        outer=outer, n_inner=n_inner, n_adj=n_adj, lr=lr, gamma=gamma,
        tau0=tau0, sigma0=sigma0, beta1=beta1, beta2=beta2, eps=eps,
        cg_variant="classic"), tile_b=tile_b)


def single_loop_tv_cuda(utrue, f, alpha0=0.1, **kwargs):
    """Scalar/patch-TV convenience wrapper (returns ``(alpha, u, traj)``)."""
    return single_loop_cuda(utrue, f, alpha0, _TV, **kwargs)


def stencil_cuda(kind: int, what: str, x):
    """One stencil of ``csrc/single_loop.cu`` on the card, for checking it
    against ``ops/grad.py``: ``kind`` 0/1/2 (forward, backward, centred),
    ``what`` ``"grad"`` ((B, M, N) → (B, 2, M, N)), ``"adjoint"`` or
    ``"gram"`` ((B, 2, M, N) → (B, M, N)).  Counts no launch."""
    check_cuda_input(x)
    whats = ("grad", "adjoint", "gram")
    if kind not in (0, 1, 2) or what not in whats:
        raise ValueError(f"kind {kind!r}, what {what!r}")
    x = x.contiguous()
    if what == "grad":
        B, M, N = x.shape
        out = torch.empty((B, 2, M, N), dtype=x.dtype, device=x.device)
    else:
        B, two, M, N = x.shape
        if two != 2:
            raise ValueError(f"expected (B, 2, M, N), got {tuple(x.shape)}")
        out = torch.empty((B, M, N), dtype=x.dtype, device=x.device)
    lib = _build.library()
    fn = lib.bpl_sl_stencil_f32 if x.dtype == torch.float32 \
        else lib.bpl_sl_stencil_f64
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(int(kind), whats.index(what), x.data_ptr(), out.data_ptr(),
                 int(B), int(M), int(N), stream)
    _build.check(err, "single-loop stencil")
    return out
