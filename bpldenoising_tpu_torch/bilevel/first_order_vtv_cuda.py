"""The single-loop vectorial-TV learner as a CUDA kernel
(``csrc/single_loop_vtv.cu``), replacing the TPU kernel
``bpldenoising_tpu/bilevel/first_order_vtv_pallas.py::_kernel``.

:func:`single_loop_vtv_cuda` takes the arguments of the JAX package's
``single_loop_vtv_pallas`` and returns the same ``(alpha, u,
cost_trajectory)``, without its single-image limit (which VMEM sets): any
batch of (C, M, N) images, a scalar weight or an (m, n) patch grid, the
CG's inner products per image (the jnp scan's semantics; at one image with
a scalar weight, the Pallas kernel's function).  It goes through
:func:`.first_order_vtv._single_loop_vtv_impl`: the plain version for
tensors on the CPU, the kernel (launched by :func:`_launch` here) for
CUDA tensors, an error for anything else.  ``interpret`` changes nothing.

The kernel runs row 11's design (``csrc/single_loop_tgv.cu``), not
``single_loop.cuh::sl_run``: per outer step one thread-block cluster launch
for the CP phase, a cluster per image on the bands of
``csrc/vtv_cluster.cuh`` as :func:`vtv_plan` decides from the shapes (the
same kernel on a global scratch where the bands do not fit in shared
memory), then two launches per CG step: :func:`launches_per_step` a step
and one per segment, counted in :data:`kernel_launches`.  The CG's blocks
take one 256-element partial block each, or the same 256 pixels of the C
planes where :func:`cg_slots` says so.  A plan the card refuses raises.
"""

from __future__ import annotations

import functools
import sys

import torch

from .. import _build
from ..solvers.cluster_plan import cg_block_slots, vtv_plan
from ..solvers.pdps_cuda import check_cuda_input, check_plane
from .first_order_cuda import (KernelSession, adam_args, launches_per_step,
                               pack_opt, run_session, unpack_opt)
from .first_order import step_sizes
from .first_order_vtv import _VTV, _prepare, _single_loop_vtv_impl

__all__ = ["single_loop_vtv_cuda", "vtv_plan", "cg_slots",
           "launches_per_step", "launches", "kernel_launches", "last_plan",
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


def cg_slots(B: int, M: int, N: int, C: int) -> int:
    """The partial blocks a CG block of ``csrc/single_loop_vtv.cu`` takes:
    :func:`..solvers.cluster_plan.cg_block_slots` of the C channel planes:
    C where M·N is a multiple of 256 and B·M·N/256 ≥ 132 (6×128²: 384
    blocks), else 1 (1×3×128²: 192).  Both give the same bits."""
    return cg_block_slots(B, M, N, C)


class Session(KernelSession):
    """``outer`` steps on the card from ``carry`` ``(u, y, λ, z, (m, v),
    t)`` (:class:`.first_order_cuda.KernelSession`).  The shapes and dtypes
    of every argument are checked before the device."""

    def __init__(self, utrue, f, carry, *, outer, n_inner, n_adj, pop,
                 param_shape, lr, gamma, tau0, sigma0, beta1, beta2, eps):
        if f.ndim != 4:
            raise ValueError(f"expected an (O, C, M, N) stack, got "
                             f"{tuple(f.shape)}")
        if f.dtype not in (torch.float32, torch.float64):
            raise TypeError(f"the CUDA kernels take float32/float64, got "
                            f"{f.dtype}")
        check_plane(utrue, f.shape, f, "utrue")
        B, C, M, N = (int(s) for s in f.shape)
        pm, pn = (1, 1) if pop is None else pop.size_in
        u, y, lam, z, (m, v), t = carry
        check_plane(u, f.shape, f, "carry u")
        check_plane(y, (B, C, 2, M, N), f, "carry y")
        check_plane(lam, f.shape, f, "carry lambda")
        self.opt = pack_opt(z, m, v, t, param_shape, 1, pm * pn, outer, f)
        check_cuda_input(f)
        self.f, self.utrue = f.contiguous(), utrue.contiguous()
        self.state = tuple(a.contiguous().clone() for a in (u, y, lam))
        plan = vtv_plan(M, N, C, f.element_size())
        slots = cg_slots(B, M, N, C)
        lib = _build.library()
        geometry = (B, C, M, N, pm * pn, plan.cluster, plan.rows,
                    int(plan.resident))
        self.scratch = torch.empty((lib.bpl_sl_vtv_scratch(*geometry),),
                                   dtype=f.dtype, device=f.device)
        self.parts_of = functools.partial(lib.bpl_sl_vtv_mesh_parts,
                                          *geometry)
        tau, sigma = (float(s) for s in step_sizes(_VTV.opnorm_sq(), tau0,
                                                   sigma0, f.dtype))
        self.fn = lib.bpl_sl_vtv_f32 if f.dtype == torch.float32 \
            else lib.bpl_sl_vtv_f64
        self.args = (B, C, M, N, pm, pn, plan.cluster, plan.rows,
                     int(plan.resident), slots, int(outer))
        self.consts = (int(n_inner), int(n_adj), tau, sigma, float(gamma),
                       *adam_args(lr, beta1, beta2, eps))
        self.what = (f"single-loop VTV kernel (CP cluster {plan}, CG slots "
                     f"{slots})")
        self.param_shape = param_shape
        self.counters = sys.modules[__name__]
        self.count_session(last_plan=plan, last_cg_slots=slots)

    def finish(self):
        u, y, lam = self.state
        (z, mv, t), trajs = unpack_opt(*self.opt, self.param_shape)
        return (u, y, lam, z, mv, t), trajs


def _launch(utrue, f, carry, *, outer, **kw):
    """Run ``outer`` steps from ``carry`` on the card in one call; →
    (carry, (α, cost, ‖g‖ trajectories))."""
    return run_session(Session(utrue, f, carry, outer=outer, **kw), outer)


def single_loop_vtv_cuda(utrue, f, x0, *, outer: int = 300,
                         n_inner: int = 40, n_adj: int = 10,
                         lr: float = 0.05, gamma: float = 1e-4,
                         tau0: float = 5.0, sigma0: float = 0.99 / 5.0,
                         beta1: float = 0.9, beta2: float = 0.999,
                         eps: float = 1e-8, interpret: bool = False):
    """Single-loop VTV learning of ``x0`` (a scalar or an (m, n) grid) on
    a (C, M, N) image or an (O, C, M, N) stack.  → ``(alpha, u,
    cost_trajectory)``."""
    utrue, f, x0, pop, param_shape, squeeze = _prepare(utrue, f, x0)
    res = _single_loop_vtv_impl(
        utrue, f, x0, outer=int(outer), n_inner=int(n_inner),
        n_adj=int(n_adj), pop=pop, param_shape=param_shape, lr=lr,
        gamma=gamma, tau0=tau0, sigma0=sigma0, beta1=beta1, beta2=beta2,
        eps=eps)
    return res.alpha, (res.u[0] if squeeze else res.u), res.cost_trajectory
