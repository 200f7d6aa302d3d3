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
"""

from __future__ import annotations

import torch

from .. import _build
from ..solvers.pdps_cuda import check_cuda_input, check_plane
from .first_order_cuda import adam_args, pack_opt, unpack_opt
from .first_order_tvl1 import (_prepare, _single_loop_tvl1_impl,
                               step_constants)

__all__ = ["single_loop_tvl1_cuda", "launches"]

#: calls that launched the CUDA learner (one per segment)
launches = 0


def _launch(utrue, f, carry, *, outer, n_inner, n_adj, pop, param_shape,
            lr, gamma_d, gamma_r, tau0, sigma0, beta1, beta2, eps, clip):
    """Run ``outer`` steps from ``carry`` ``(u, y, p, z, (m, v), t)`` on
    the card; → (carry, (α, cost, ‖g‖ trajectories))."""
    check_cuda_input(f)
    if f.ndim != 3:
        raise ValueError(f"expected an (O, M, N) stack, got {tuple(f.shape)}")
    check_plane(utrue, f.shape, f, "utrue")
    B, M, N = (int(s) for s in f.shape)
    pm, pn = (1, 1) if pop is None else pop.size_in
    u, y, p, z, (m, v), t = carry
    check_plane(u, f.shape, f, "carry u")
    check_plane(y, (B, 2, M, N), f, "carry y")
    check_plane(p, f.shape, f, "carry p")
    opt = pack_opt(z, m, v, t, param_shape, 1, pm * pn, outer, f)
    f = f.contiguous()
    utrue = utrue.contiguous()
    u, y, p = (a.contiguous().clone() for a in (u, y, p))
    lib = _build.library()
    scratch = torch.empty((lib.bpl_sl_tvl1_scratch(B, M, N, pm * pn),),
                          dtype=f.dtype, device=f.device)
    consts = (float(c) for c in step_constants(tau0, sigma0, gamma_d,
                                               f.dtype))
    tau, sigma, lo, den, inv_gd = consts
    fn = lib.bpl_sl_tvl1_f32 if f.dtype == torch.float32 \
        else lib.bpl_sl_tvl1_f64
    global launches
    with torch.cuda.device(f.device):
        stream = torch.cuda.current_stream(f.device).cuda_stream
        launches += 1
        err = fn(*(a.data_ptr() for a in (f, utrue, u, y, p)),
                 *(a.data_ptr() for a in opt), scratch.data_ptr(), B, M, N,
                 pm, pn, int(outer), int(n_inner), int(n_adj), tau, sigma,
                 float(gamma_r), lo, den, float(gamma_d), inv_gd,
                 *adam_args(lr, beta1, beta2, eps), float(clip), stream)
    _build.check(err, "single-loop TV-L1 kernel")
    (z, mv, t), trajs = unpack_opt(*opt, param_shape)
    return (u, y, p, z, mv, t), trajs


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
