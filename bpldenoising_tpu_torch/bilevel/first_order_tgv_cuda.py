"""The single-loop TGV² learner as a CUDA kernel
(``csrc/single_loop_tgv.cu``), replacing the TPU kernel
``bpldenoising_tpu/bilevel/first_order_tgv_pallas.py::_kernel``.

:func:`single_loop_tgv_cuda` takes the arguments of the JAX package's
``single_loop_tgv_pallas`` and returns the same ``(alpha, u,
cost_trajectory)``, without its single-image limit (which VMEM sets): any
batch, a (2,) weight or an (m, n, 2) patch stack, the CG's inner products
per image (the jnp scan's semantics; at one image with a (2,) weight, the
Pallas kernel's function).  It goes through
:func:`.first_order_tgv._single_loop_tgv_impl`: the plain version for
tensors on the CPU, the kernel (launched by :func:`_launch` here) for
CUDA tensors, an error for anything else.  ``interpret`` changes nothing.
"""

from __future__ import annotations

import torch

from .. import _build
from ..solvers.pdps_cuda import check_cuda_input, check_plane
from ..solvers.tgv import step_sizes
from .first_order_cuda import adam_args, pack_opt, unpack_opt
from .first_order_tgv import _prepare, _single_loop_tgv_impl

__all__ = ["single_loop_tgv_cuda", "launches"]

#: calls that launched the CUDA learner (one per segment)
launches = 0


def _launch(utrue, f, carry, *, outer, n_inner, n_adj, pop, param_shape,
            lr, gamma, tau0, sigma0, beta1, beta2, eps):
    """Run ``outer`` steps from ``carry`` ``((u, w, p, q), λ, z, (m, v),
    t)`` on the card; → (carry, (α, cost, ‖g‖ trajectories))."""
    check_cuda_input(f)
    if f.ndim != 3:
        raise ValueError(f"expected an (O, M, N) stack, got {tuple(f.shape)}")
    check_plane(utrue, f.shape, f, "utrue")
    B, M, N = (int(s) for s in f.shape)
    pm, pn = (1, 1) if pop is None else pop.size_in
    (u, w, p, q), lam, z, (m, v), t = carry
    for name, a, c in (("u", u, None), ("w", w, 2), ("p", p, 2),
                       ("q", q, 3), ("lambda", lam, 3)):
        shape = (B, M, N) if c is None else (B, c, M, N)
        check_plane(a, shape, f, f"carry {name}")
    opt = pack_opt(z, m, v, t, param_shape, 2, pm * pn, outer, f)
    f = f.contiguous()
    utrue = utrue.contiguous()
    u, w, p, q, lam = (a.contiguous().clone() for a in (u, w, p, q, lam))
    lib = _build.library()
    scratch = torch.empty((lib.bpl_sl_tgv_scratch(B, M, N, pm * pn),),
                          dtype=f.dtype, device=f.device)
    tau, sigma = (float(s) for s in step_sizes(tau0, sigma0, f.dtype))
    fn = lib.bpl_sl_tgv_f32 if f.dtype == torch.float32 \
        else lib.bpl_sl_tgv_f64
    global launches
    with torch.cuda.device(f.device):
        stream = torch.cuda.current_stream(f.device).cuda_stream
        launches += 1
        err = fn(*(a.data_ptr() for a in (f, utrue, u, w, p, q, lam)),
                 *(a.data_ptr() for a in opt), scratch.data_ptr(), B, M, N,
                 pm, pn, int(outer), int(n_inner), int(n_adj), tau, sigma,
                 float(gamma), *adam_args(lr, beta1, beta2, eps), stream)
    _build.check(err, "single-loop TGV kernel")
    (z, mv, t), trajs = unpack_opt(*opt, param_shape)
    return ((u, w, p, q), lam, z, mv, t), trajs


def single_loop_tgv_cuda(utrue, f, x0, *, outer: int = 300,
                         n_inner: int = 40, n_adj: int = 10,
                         lr: float = 0.02, gamma: float = 1e-4,
                         tau0: float = 0.99, sigma0: float = 0.99,
                         beta1: float = 0.9, beta2: float = 0.999,
                         eps: float = 1e-8, interpret: bool = False):
    """Single-loop TGV² learning of ``x0`` (``[α₁, α₀]`` or an (m, n, 2)
    stack) on an (M, N) image or an (O, M, N) stack.  → ``(alpha, u,
    cost_trajectory)``."""
    utrue, f, x0, pop, param_shape, squeeze = _prepare(utrue, f, x0)
    res = _single_loop_tgv_impl(
        utrue, f, x0, outer=int(outer), n_inner=int(n_inner),
        n_adj=int(n_adj), pop=pop, param_shape=param_shape, lr=lr,
        gamma=gamma, tau0=tau0, sigma0=sigma0, beta1=beta1, beta2=beta2,
        eps=eps)
    return res.alpha, (res.u[0] if squeeze else res.u), res.cost_trajectory
