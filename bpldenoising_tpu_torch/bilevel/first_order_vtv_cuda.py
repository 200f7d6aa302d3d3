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
"""

from __future__ import annotations

import torch

from .. import _build
from ..solvers.pdps_cuda import check_cuda_input, check_plane
from .first_order_cuda import adam_args, pack_opt, unpack_opt
from .first_order import step_sizes
from .first_order_vtv import _VTV, _prepare, _single_loop_vtv_impl

__all__ = ["single_loop_vtv_cuda", "launches"]

#: calls that launched the CUDA learner (one per segment)
launches = 0


def _launch(utrue, f, carry, *, outer, n_inner, n_adj, pop, param_shape,
            lr, gamma, tau0, sigma0, beta1, beta2, eps):
    """Run ``outer`` steps from ``carry`` ``(u, y, λ, z, (m, v), t)`` on
    the card; → (carry, (α, cost, ‖g‖ trajectories))."""
    check_cuda_input(f)
    if f.ndim != 4:
        raise ValueError(f"expected an (O, C, M, N) stack, got "
                         f"{tuple(f.shape)}")
    check_plane(utrue, f.shape, f, "utrue")
    B, C, M, N = (int(s) for s in f.shape)
    pm, pn = (1, 1) if pop is None else pop.size_in
    u, y, lam, z, (m, v), t = carry
    check_plane(u, f.shape, f, "carry u")
    check_plane(y, (B, C, 2, M, N), f, "carry y")
    check_plane(lam, f.shape, f, "carry lambda")
    opt = pack_opt(z, m, v, t, param_shape, 1, pm * pn, outer, f)
    f = f.contiguous()
    utrue = utrue.contiguous()
    u, y, lam = (a.contiguous().clone() for a in (u, y, lam))
    lib = _build.library()
    scratch = torch.empty((lib.bpl_sl_vtv_scratch(B, C, M, N, pm * pn),),
                          dtype=f.dtype, device=f.device)
    tau, sigma = (float(s) for s in step_sizes(_VTV.opnorm_sq(), tau0,
                                               sigma0, f.dtype))
    fn = lib.bpl_sl_vtv_f32 if f.dtype == torch.float32 \
        else lib.bpl_sl_vtv_f64
    global launches
    with torch.cuda.device(f.device):
        stream = torch.cuda.current_stream(f.device).cuda_stream
        launches += 1
        err = fn(*(a.data_ptr() for a in (f, utrue, u, y, lam)),
                 *(a.data_ptr() for a in opt), scratch.data_ptr(), B, C, M,
                 N, pm, pn, int(outer), int(n_inner), int(n_adj), tau, sigma,
                 float(gamma), *adam_args(lr, beta1, beta2, eps), stream)
    _build.check(err, "single-loop VTV kernel")
    (z, mv, t), trajs = unpack_opt(*opt, param_shape)
    return (u, y, lam, z, mv, t), trajs


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
