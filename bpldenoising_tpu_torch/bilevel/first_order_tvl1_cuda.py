"""The single-loop TV-L1 learner as a CUDA kernel
(``csrc/single_loop_tvl1.cu``), replacing the TPU kernel
``bpldenoising_tpu/bilevel/first_order_tvl1_pallas.py::_kernel``.

:func:`single_loop_tvl1_cuda` takes the arguments of the JAX package's
``single_loop_tvl1_pallas`` and returns the same ``(alpha, u,
cost_trajectory)``, without its single-image limit (which VMEM sets): any
batch, a scalar weight or an (m, n) patch grid, the CG's inner products
per image (the jnp scan's semantics; at one image with a scalar weight,
the Pallas kernel's function).  It goes through
:func:`.first_order_tvl1._single_loop_tvl1_impl`: the plain version for
tensors on the CPU, the kernel (launched by :func:`_launch` here) for
CUDA tensors, an error for anything else.  ``interpret`` changes nothing.

The kernel runs rows 11's and 13's design (``csrc/single_loop_tgv.cu``,
``csrc/single_loop_vtv.cu``): per outer step one thread-block cluster
launch for the CP phase, a cluster per image on the bands of
``csrc/pd_cluster.cuh`` as :func:`tvl1_plan` decides from the shapes (the
TV-L1 CP kernel's rule; the same kernel on a global scratch where the
bands do not fit in shared memory), then two launches per CG step:
:func:`launches_per_step` a step and one per segment, counted in
:data:`kernel_launches`.  A CG block takes one 256-pixel partial block
(:func:`..solvers.cluster_plan.cg_block_slots` of one plane).  A plan the
card refuses raises.
"""

from __future__ import annotations

import functools
import sys

import torch

from .. import _build
from ..solvers.cluster_plan import cg_block_slots
from ..solvers.pdps_cuda import check_cuda_input, check_plane
from ..solvers.tvl1_cuda import tvl1_plan
from .first_order_cuda import (KernelSession, adam_args, launches_per_step,
                               pack_opt, run_session, unpack_opt)
from .first_order_tvl1 import (_prepare, _single_loop_tvl1_impl,
                               step_constants)

__all__ = ["single_loop_tvl1_cuda", "tvl1_plan", "launches_per_step",
           "launches", "kernel_launches", "last_plan", "last_cg_slots",
           "Session"]

#: sessions of the CUDA learner (one per segment, and per shard on a mesh)
launches = 0
#: kernel launches they issued on the card, as the C loop counts them
#: (launches_per_step(n_adj) per outer step, one per segment; on a mesh,
#: per shard)
kernel_launches = 0
#: the band plan and the CG slots of the latest launch
last_plan = None
last_cg_slots = None


class Session(KernelSession):
    """``outer`` steps on the card from ``carry`` ``(u, y, p, z, (m, v),
    t)`` (:class:`.first_order_cuda.KernelSession`).  The shapes and dtypes
    of every argument are checked before the device."""

    def __init__(self, utrue, f, carry, *, outer, n_inner, n_adj, pop,
                 param_shape, lr, gamma_d, gamma_r, tau0, sigma0, beta1,
                 beta2, eps, clip):
        if f.ndim != 3:
            raise ValueError(f"expected an (O, M, N) stack, got "
                             f"{tuple(f.shape)}")
        if f.dtype not in (torch.float32, torch.float64):
            raise TypeError(f"the CUDA kernels take float32/float64, got "
                            f"{f.dtype}")
        check_plane(utrue, f.shape, f, "utrue")
        B, M, N = (int(s) for s in f.shape)
        pm, pn = (1, 1) if pop is None else pop.size_in
        u, y, p, z, (m, v), t = carry
        check_plane(u, f.shape, f, "carry u")
        check_plane(y, (B, 2, M, N), f, "carry y")
        check_plane(p, f.shape, f, "carry p")
        self.opt = pack_opt(z, m, v, t, param_shape, 1, pm * pn, outer, f)
        check_cuda_input(f)
        self.f, self.utrue = f.contiguous(), utrue.contiguous()
        self.state = tuple(a.contiguous().clone() for a in (u, y, p))
        plan = tvl1_plan(B, M, N, f.element_size())
        slots = cg_block_slots(B, M, N, 1)
        lib = _build.library()
        geometry = (B, M, N, pm * pn, plan.cluster, plan.rows,
                    int(plan.resident))
        self.scratch = torch.empty((lib.bpl_sl_tvl1_scratch(*geometry),),
                                   dtype=f.dtype, device=f.device)
        self.parts_of = functools.partial(lib.bpl_sl_tvl1_mesh_parts,
                                          *geometry)
        tau, sigma, lo, den, inv_gd = (
            float(c) for c in step_constants(tau0, sigma0, gamma_d, f.dtype))
        self.fn = lib.bpl_sl_tvl1_f32 if f.dtype == torch.float32 \
            else lib.bpl_sl_tvl1_f64
        self.args = (B, M, N, pm, pn, plan.cluster, plan.rows,
                     int(plan.resident), int(outer))
        self.consts = (int(n_inner), int(n_adj), tau, sigma, float(gamma_r),
                       lo, den, float(gamma_d), inv_gd,
                       *adam_args(lr, beta1, beta2, eps), float(clip))
        self.what = f"single-loop TV-L1 kernel (CP cluster {plan})"
        self.param_shape = param_shape
        self.counters = sys.modules[__name__]
        self.count_session(last_plan=plan, last_cg_slots=slots)

    def finish(self):
        u, y, p = self.state
        (z, mv, t), trajs = unpack_opt(*self.opt, self.param_shape)
        return (u, y, p, z, mv, t), trajs


def _launch(utrue, f, carry, *, outer, **kw):
    """Run ``outer`` steps from ``carry`` on the card in one call; →
    (carry, (α, cost, ‖g‖ trajectories))."""
    return run_session(Session(utrue, f, carry, outer=outer, **kw), outer)


def single_loop_tvl1_cuda(utrue, f, x0, *, outer: int = 300,
                          n_inner: int = 40, n_adj: int = 10,
                          lr: float = 0.05, gamma_d: float = 100.0,
                          gamma: float = 1000.0, tau0: float = 0.99,
                          sigma0: float = 0.99, beta1: float = 0.9,
                          beta2: float = 0.999, eps: float = 1e-8,
                          clip: float = 1.0, interpret: bool = False):
    """Single-loop TV-L1 learning of ``x0`` (a scalar or an (m, n) grid)
    on an (M, N) image or an (O, M, N) stack.  → ``(alpha, u,
    cost_trajectory)``."""
    utrue, f, x0, pop, param_shape, squeeze = _prepare(utrue, f, x0)
    res = _single_loop_tvl1_impl(
        utrue, f, x0, outer=int(outer), n_inner=int(n_inner),
        n_adj=int(n_adj), pop=pop, param_shape=param_shape, lr=lr,
        gamma_d=gamma_d, gamma_r=gamma, tau0=tau0, sigma0=sigma0,
        beta1=beta1, beta2=beta2, eps=eps, clip=float(clip))
    return res.alpha, (res.u[0] if squeeze else res.u), res.cost_trajectory
