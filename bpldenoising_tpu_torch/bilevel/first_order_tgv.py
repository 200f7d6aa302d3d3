"""Single-loop first-order TGV² bilevel learning (counterpart of
``bpldenoising_tpu.bilevel.first_order_tgv``).

The TGV analogue of :mod:`.first_order`: the joint-CP state (u, w, p, q),
the adjoint multiplier λ and the weights (α₁, α₀) advance together.  Per
outer step:

1. ``n_inner`` joint-CP steps at the current weights from the warm state
   (:func:`..solvers.tgv._step`);
2. ``n_adj`` Jacobi-CG steps on the γ-Huber smoothed joint system at the
   current iterate (:func:`..solvers.tgv._build_joint_system`), from the
   warm λ, with per-image inner products (``cg_batched(item_ndim=3)``);
3. an Adam step on log(α₁, α₀) with g₁ = ⟨ψ_γ(∇u − w), ∇λᵤ − λ_w⟩ and
   g₀ = ⟨ψ_γ(Ew), Eλ_w⟩ (λ solves H λ = ū − u, so the signs are +).

The parameter is the (2,) vector or an (m, n, 2) patch stack, on any
batch.  :func:`single_loop_tgv_learn` runs where ``f`` lives: the plain
loop below for CPU tensors, the CUDA learner of
:mod:`.first_order_tgv_cuda` (``csrc/single_loop_tgv.cu``) for CUDA
tensors, which raises for what it does not take.  ``mesh=`` shards the
batch (:func:`.first_order.drive_single_loop`; the CG's per-image dots
need no cross-shard sum); ``optimizer=`` raises ``NotImplementedError``,
as in :mod:`.first_order`.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops import FwdGradientOp, PatchOp, scalarprod, sym_grad
from ..solvers.krylov import cg_batched
from ..solvers.tgv import _build_joint_system, _step, step_sizes
from .first_order import (PlainStepper, SingleLoopResult, check_unported,
                          drive_single_loop, dual_zeros, expand, opt_init,
                          prepare_learn, pullback, run_segment, run_steps)
from .fused_tgv import tgv_param_layout

__all__ = ["single_loop_tgv_learn", "tgv_param_layout"]

_GRAD = FwdGradientOp()


def _tgv_init_carry(f, x0, *, param_shape: tuple):
    """Initial carry ``((u, w, p, q), λ, z, (m, v), t)``: the cold CP state
    (f, 0, 0, 0), λ = 0 with 3 planes, z = log x₀, zero Adam moments,
    step 0 (the JAX package's scan carry)."""
    state = (f, dual_zeros(f), dual_zeros(f), dual_zeros(f, 3))
    return (state, dual_zeros(f, 3)) + opt_init(f, x0, param_shape)


def _tgv_plain_stepper(utrue, f, carry, *, outer: int, n_inner: int,
                       n_adj: int, pop: Optional[PatchOp],
                       param_shape: tuple, lr, gamma, tau0, sigma0, beta1,
                       beta2, eps) -> PlainStepper:
    """The plain learner's steps from ``carry``, in the order of the JAX
    package's scan (``first_order_tgv.py:102-137``).  ``utrue``/``f`` are
    (O, M, N)."""
    tau, sigma = step_sizes(tau0, sigma0, f.dtype, f.device)

    def local(st, x):
        state, lam = st
        if pop is None:
            a1, a0 = x[0], x[1]
        else:
            a1, a0 = expand(pop, x[..., 0]), expand(pop, x[..., 1])
        for _ in range(int(n_inner)):
            state = _step(f, a1, a0, tau, sigma, state)
        u, w = state[0], state[1]
        H, diag, psi_y, psi_z = _build_joint_system(u, w, a1, a0, gamma)
        rhs = torch.cat([(utrue - u)[..., None, :, :], torch.zeros_like(w)],
                        dim=-3)
        lam, _ = cg_batched(H, rhs, x0=lam, tol=0.0, maxiter=int(n_adj),
                            M=lambda r: r / diag, item_ndim=3)
        lu = lam[..., 0, :, :]
        lw = lam[..., 1:3, :, :]
        g1 = scalarprod(psi_y, _GRAD.apply(lu) - lw)
        g0 = scalarprod(psi_z, sym_grad(lw))
        return (state, lam), (g1, g0), 0.5 * torch.sum((u - utrue) ** 2)

    def pull(g):
        return torch.stack([pullback(pop, g[0]), pullback(pop, g[1])],
                           dim=-1)

    return PlainStepper(local, pull, lambda g_x, x: g_x * x, carry,
                        param_shape=param_shape, lr=lr, beta1=beta1,
                        beta2=beta2, eps=eps)


def _tgv_u_and_z(carry):
    return carry[0][0], carry[2]


def _single_loop_tgv_plain(utrue, f, x0, *, outer: int, param_shape: tuple,
                           carry0=None, return_carry: bool = False, **kw):
    """The learner as a Python loop (:func:`_tgv_plain_stepper`)."""
    if carry0 is None:
        carry0 = _tgv_init_carry(f, x0, param_shape=param_shape)
    stepper = _tgv_plain_stepper(utrue, f, carry0, outer=outer,
                                 param_shape=param_shape, **kw)
    return run_steps(stepper, utrue, outer, _tgv_u_and_z, return_carry)


def _tgv_stepper(utrue, f, carry, **kw):
    """One shard's steps of a mesh segment where ``f`` lives: the plain
    stepper on the CPU, the CUDA learner's session otherwise."""
    if f.device.type == "cpu":
        return _tgv_plain_stepper(utrue, f, carry, **kw)
    from .first_order_tgv_cuda import Session
    return Session(utrue, f, carry, **kw)


def _cuda_launch():
    from .first_order_tgv_cuda import _launch
    return _launch


def _single_loop_tgv_impl(utrue, f, x0, *, param_shape: tuple, **kw):
    """One segment where ``f`` lives (:func:`.first_order.run_segment`)."""
    return run_segment(
        _single_loop_tgv_plain, _cuda_launch,
        lambda ff: _tgv_init_carry(ff, x0, param_shape=param_shape),
        _tgv_u_and_z, utrue, f, x0, param_shape=param_shape, **kw)


def _prepare(utrue, f, x0):
    """→ (utrue, f, x0, pop, param_shape, squeeze) for a TGV learn."""
    return prepare_learn(utrue, f, x0, 2, tgv_param_layout)


def single_loop_tgv_learn(utrue, f, x0, *, outer: int = 300,
                          n_inner: int = 40, n_adj: int = 10,
                          lr: float = 0.02, gamma: float = 1e-4,
                          tau0: float = 0.99, sigma0: float = 0.99,
                          beta1: float = 0.9, beta2: float = 0.999,
                          eps: float = 1e-8, mesh=None, optimizer=None,
                          log_every: Optional[int] = None,
                          segment_callback=None) -> SingleLoopResult:
    """Single-loop TGV² bilevel learning on (O, M, N) / (M, N) stacks, on
    the device ``f`` lives on.  ``x0``: strictly positive ``[α₁, α₀]`` or
    an (m, n, 2) patch stack.  ``lr`` defaults to 0.02, below the TV
    families' 0.05, as in the JAX package (the TGV cost is nearly flat in
    α₀ far from the optimum)."""
    check_unported(optimizer)
    utrue, f, x0, pop, param_shape, squeeze = _prepare(utrue, f, x0)
    kw = dict(outer=int(outer), n_inner=int(n_inner), n_adj=int(n_adj),
              pop=pop, param_shape=param_shape, lr=lr, gamma=gamma,
              tau0=tau0, sigma0=sigma0, beta1=beta1, beta2=beta2, eps=eps)
    res = drive_single_loop(
        _single_loop_tgv_impl, utrue, f, x0, kw,
        make_carry0=lambda ff: _tgv_init_carry(ff, x0,
                                               param_shape=param_shape),
        log_every=log_every, segment_callback=segment_callback, mesh=mesh,
        stepper=_tgv_stepper, u_and_z=_tgv_u_and_z)
    if squeeze:
        res = res._replace(u=res.u[0])
    return res
