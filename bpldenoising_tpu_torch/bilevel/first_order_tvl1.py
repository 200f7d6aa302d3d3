"""Single-loop first-order TV-L1 bilevel learning (counterpart of
``bpldenoising_tpu.bilevel.first_order_tvl1``).

The impulse-noise companion of :mod:`.first_order` for the Huber-smoothed
TV-L1 model (:mod:`..solvers.tvl1_huber`): the CP state (u, y), the
adjoint p and the weight advance together.  Per outer step:

1. ``n_inner`` Huber-smoothed CP steps at the current α (the Huber data
   prox and the dual scaled by 1/(1 + σ/(max(α, 1e-12)·γ_r))), warm;
2. ``n_adj`` Jacobi-CG steps on H = D + ∇ᵀ(αW)∇ at the current iterate,
   D = γ_d·1{|u − f| ≤ 1/γ_d} (the TV system of
   :func:`..solvers.hypergrad.build_reg_system` with D in place of I), from
   the warm p, with per-image inner products (``cg_batched(item_ndim=2)``);
3. an Adam step on log α with g = ⟨∇p, ψ'_{γr}(∇u)⟩, the log-α gradient
   clipped to ±``clip`` before the moments.

While the state is far from its fixed point D vanishes on the outlier
pixels, the adjoint system is near-singular and |g| reaches ~1e6 on the
first steps; unclipped, one such step fills Adam's second moment for
~1/(1 − β₂) steps and the weight stalls.

The parameter is a scalar or an (m, n) patch grid, on any batch.
:func:`single_loop_tvl1_learn` runs where ``f`` lives: the plain loop
below for CPU tensors, the CUDA learner of :mod:`.first_order_tvl1_cuda`
(``csrc/single_loop_tvl1.cu``) for CUDA tensors, which raises for what it
does not take.  ``mesh=`` shards the batch
(:func:`.first_order.drive_single_loop`); ``optimizer=`` raises
``NotImplementedError``.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..models import tv_model
from ..ops import PatchOp, proj_norm21_ball, scalarprod
from ..solvers.hypergrad import build_reg_system
from ..solvers.krylov import cg_batched
from ..solvers.tvl1_huber import _huber_prox, huber_prox_consts
from .first_order import (PlainStepper, SingleLoopResult, check_unported,
                          drive_single_loop, dual_zeros, expand, opt_init,
                          prepare_learn, pullback, run_segment, run_steps,
                          step_sizes)
from .fused_tvl1 import tvl1_param_layout

__all__ = ["single_loop_tvl1_learn", "tvl1_param_layout"]

_TV = tv_model()
_GRAD = _TV.ops[0]


def step_constants(tau0, sigma0, gamma_d, dtype, device=None):
    """(τ, σ, lo, den, 1/γ_d) in the working dtype: τ = τ₀/‖∇‖,
    σ = σ₀/‖∇‖ and the Huber prox's constants (1/γ_d + τ, 1 + τγ_d), as
    the plain loop forms them."""
    tau, sigma = step_sizes(_TV.opnorm_sq(), tau0, sigma0, dtype, device)
    gd = torch.tensor(gamma_d, dtype=dtype, device=device)
    lo, den = huber_prox_consts(tau, gd)
    return tau, sigma, lo, den, 1.0 / gd


def _tvl1_init_carry(f, x0, *, param_shape: tuple):
    """Initial carry ``(u, y, p, z, (m, v), t)``: u = f, y = 0, p = 0,
    z = log x₀, zero Adam moments, step 0 (the JAX package's scan
    carry)."""
    return ((f, dual_zeros(f), torch.zeros_like(f))
            + opt_init(f, x0, param_shape))


def _tvl1_plain_stepper(utrue, f, carry, *, outer: int, n_inner: int,
                        n_adj: int, pop: Optional[PatchOp],
                        param_shape: tuple, lr, gamma_d, gamma_r, tau0,
                        sigma0, beta1, beta2, eps, clip) -> PlainStepper:
    """The plain learner's steps from ``carry``, in the order of the JAX
    package's scan (``first_order_tvl1.py:100-159``).  ``utrue``/``f`` are
    (O, M, N)."""
    dtype, dev = f.dtype, f.device
    tau, sigma, lo, den, inv_gd = step_constants(tau0, sigma0, gamma_d,
                                                 dtype, dev)
    gd = torch.tensor(gamma_d, dtype=dtype, device=dev)
    gr = torch.tensor(gamma_r, dtype=dtype, device=dev)

    def pd_step(a, scale, u, y):
        v = u - tau * _GRAD.apply_adjoint(y)
        u_new = f + _huber_prox(v - f, tau, lo, den)
        ubar = 2.0 * u_new - u
        y_new = proj_norm21_ball(scale * (y + sigma * _GRAD.apply(ubar)), a)
        return u_new, y_new

    def local(st, x):
        u, y, p = st
        a = expand(pop, x)
        a_safe = torch.clamp(a, min=1e-12)
        scale = 1.0 / (1.0 + sigma / (a_safe * gr))
        if a.ndim >= 2:
            scale = scale[..., None, :, :]
        for _ in range(int(n_inner)):
            u, y = pd_step(a, scale, u, y)
        M0, inv_diag0, fields = build_reg_system(u, (a,), _TV,
                                                 float(gamma_r))
        d = torch.where(torch.abs(u - f) <= inv_gd, gd,
                        torch.zeros((), dtype=dtype, device=dev))

        def H(v):
            return M0(v) + (d - 1.0) * v

        diag = torch.clamp(1.0 / inv_diag0 + (d - 1.0), min=1e-12)
        p, _ = cg_batched(H, utrue - u, x0=p, tol=0.0, maxiter=int(n_adj),
                          M=lambda r: r / diag, item_ndim=2)
        g = scalarprod(_GRAD.apply(p), fields[0])
        return (u, y, p), (g,), 0.5 * torch.sum((u - utrue) ** 2)

    return PlainStepper(
        local, lambda g: pullback(pop, g[0]),
        lambda g_x, x: torch.clamp(g_x * x, -clip, clip), carry,
        param_shape=param_shape, lr=lr, beta1=beta1, beta2=beta2, eps=eps)


def _tvl1_u_and_z(carry):
    return carry[0], carry[3]


def _single_loop_tvl1_plain(utrue, f, x0, *, outer: int, param_shape: tuple,
                            carry0=None, return_carry: bool = False, **kw):
    """The learner as a Python loop (:func:`_tvl1_plain_stepper`)."""
    if carry0 is None:
        carry0 = _tvl1_init_carry(f, x0, param_shape=param_shape)
    stepper = _tvl1_plain_stepper(utrue, f, carry0, outer=outer,
                                  param_shape=param_shape, **kw)
    return run_steps(stepper, utrue, outer, _tvl1_u_and_z, return_carry)


def _tvl1_stepper(utrue, f, carry, **kw):
    """One shard's steps of a mesh segment where ``f`` lives: the plain
    stepper on the CPU, the CUDA learner's session otherwise."""
    if f.device.type == "cpu":
        return _tvl1_plain_stepper(utrue, f, carry, **kw)
    from .first_order_tvl1_cuda import Session
    return Session(utrue, f, carry, **kw)


def _cuda_launch():
    from .first_order_tvl1_cuda import _launch
    return _launch


def _single_loop_tvl1_impl(utrue, f, x0, *, param_shape: tuple, **kw):
    """One segment where ``f`` lives (:func:`.first_order.run_segment`)."""
    return run_segment(
        _single_loop_tvl1_plain, _cuda_launch,
        lambda ff: _tvl1_init_carry(ff, x0, param_shape=param_shape),
        _tvl1_u_and_z, utrue, f, x0, param_shape=param_shape, **kw)


def _prepare(utrue, f, x0):
    """→ (utrue, f, x0, pop, param_shape, squeeze) for a TV-L1 learn."""
    return prepare_learn(utrue, f, x0, 2, tvl1_param_layout)


def single_loop_tvl1_learn(utrue, f, x0, *, outer: int = 300,
                           n_inner: int = 40, n_adj: int = 10,
                           lr: float = 0.05, gamma_d: float = 100.0,
                           gamma: float = 1000.0, tau0: float = 0.99,
                           sigma0: float = 0.99, beta1: float = 0.9,
                           beta2: float = 0.999, eps: float = 1e-8,
                           clip: float = 1.0, mesh=None, optimizer=None,
                           log_every: Optional[int] = None,
                           segment_callback=None) -> SingleLoopResult:
    """Single-loop Huber-smoothed TV-L1 bilevel learning on (O, M, N) /
    (M, N) stacks, on the device ``f`` lives on.  ``x0``: strictly
    positive scalar α or (m, n) patch grid.  ``gamma_d`` / ``gamma``: the
    data / regularizer Huber slopes; ``clip``: the bound on the log-α
    gradient fed to Adam."""
    check_unported(optimizer)
    utrue, f, x0, pop, param_shape, squeeze = _prepare(utrue, f, x0)
    kw = dict(outer=int(outer), n_inner=int(n_inner), n_adj=int(n_adj),
              pop=pop, param_shape=param_shape, lr=lr, gamma_d=gamma_d,
              gamma_r=gamma, tau0=tau0, sigma0=sigma0, beta1=beta1,
              beta2=beta2, eps=eps, clip=float(clip))
    res = drive_single_loop(
        _single_loop_tvl1_impl, utrue, f, x0, kw,
        make_carry0=lambda ff: _tvl1_init_carry(ff, x0,
                                                param_shape=param_shape),
        log_every=log_every, segment_callback=segment_callback, mesh=mesh,
        stepper=_tvl1_stepper, u_and_z=_tvl1_u_and_z)
    if squeeze:
        res = res._replace(u=res.u[0])
    return res
