"""Single-loop first-order vectorial-TV (color) bilevel learning
(counterpart of ``bpldenoising_tpu.bilevel.first_order_vtv``).

The color companion of :mod:`.first_order`: the CP state (u, y), the
adjoint λ and the coupling weight advance together.  Per outer step:

1. ``n_inner`` unaccelerated CP steps at the current α with the
   channel-coupled Frobenius projection, warm;
2. ``n_adj`` Jacobi-CG steps on the γ-Huber smoothed coupled system
   H = I + ∇ᵀ(α Dψ)∇ at the current iterate
   (:func:`..solvers.vtv._dpsi_coupled`), from the warm λ, with per-image
   inner products over the C channel planes (``cg_batched(item_ndim=3)``);
3. an Adam step on log α with g = ⟨ψ_γ(∇u), ∇λ⟩_F per pixel (λ solves
   H λ = ū − u, so the sign is +).

Images are (O, C, M, N) stacks; the parameter is a scalar or an (m, n)
patch grid (a full-resolution grid too, as in the JAX learner).
:func:`single_loop_vtv_learn` runs where ``f`` lives: the plain loop below
for CPU tensors, the CUDA learner of :mod:`.first_order_vtv_cuda`
(``csrc/single_loop_vtv.cu``) for CUDA tensors, which raises for what it
does not take.  ``mesh=`` shards the batch
(:func:`.first_order.drive_single_loop`); ``optimizer=`` raises
``NotImplementedError``.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..models import vtv_model
from ..ops import FwdGradientOp, PatchOp, proj_norm21_ball, scalarprod
from ..solvers.krylov import cg_batched
from ..solvers.vtv import _dpsi_coupled
from .first_order import (PlainStepper, SingleLoopResult, check_unported,
                          drive_single_loop, dual_zeros, expand, opt_init,
                          prepare_learn, pullback, run_segment, run_steps,
                          step_sizes)

__all__ = ["single_loop_vtv_learn", "vtv_param_layout"]

_GRAD = FwdGradientOp()
_VTV = vtv_model()
_AXES = (-4, -3)   # (channel, component): the Frobenius coupling


def vtv_param_layout(x0, image_shape) -> Optional[PatchOp]:
    """Scalar α → None; any (m, n) grid → its PatchOp (the JAX single-loop
    learner's rule, a full-resolution grid included)."""
    if x0.ndim == 0:
        return None
    if x0.ndim == 2:
        return PatchOp(tuple(x0.shape), tuple(image_shape))
    raise ValueError(f"VTV parameter must be a scalar or an (m, n) patch "
                     f"grid, got shape {tuple(x0.shape)}")


def _vtv_init_carry(f, x0, *, param_shape: tuple):
    """Initial carry ``(u, y, λ, z, (m, v), t)``: u = f, y = 0 of shape
    (O, C, 2, M, N), λ = 0, z = log x₀, zero Adam moments, step 0 (the JAX
    package's scan carry)."""
    return ((f, dual_zeros(f), torch.zeros_like(f))
            + opt_init(f, x0, param_shape))


def _vtv_plain_stepper(utrue, f, carry, *, outer: int, n_inner: int,
                       n_adj: int, pop: Optional[PatchOp],
                       param_shape: tuple, lr, gamma, tau0, sigma0, beta1,
                       beta2, eps) -> PlainStepper:
    """The plain learner's steps from ``carry``, in the order of the JAX
    package's scan (``first_order_vtv.py:98-147``).  ``utrue``/``f`` are
    (O, C, M, N)."""
    tau, sigma = step_sizes(_VTV.opnorm_sq(), tau0, sigma0, f.dtype,
                            f.device)

    def pd_step(a, u, y):
        u_new = (u - tau * (_GRAD.apply_adjoint(y) - f)) / (1.0 + tau)
        ubar = 2.0 * u_new - u
        y_new = proj_norm21_ball(y + sigma * _GRAD.apply(ubar), a,
                                 axes=_AXES)
        return u_new, y_new

    def local(st, x):
        u, y, lam = st
        a = expand(pop, x)
        for _ in range(int(n_inner)):
            u, y = pd_step(a, u, y)
        psi, s, Dj = _dpsi_coupled(_GRAD.apply(u), gamma)

        def H(v):
            return v + _GRAD.apply_adjoint(a * Dj(_GRAD.apply(v)))

        a_s = a * s
        diag = (1.0 + _GRAD.gram_diag(torch.stack([a_s, a_s], dim=-3))
                )[..., None, :, :]
        lam, _ = cg_batched(H, utrue - u, x0=lam, tol=0.0,
                            maxiter=int(n_adj), M=lambda r: r / diag,
                            item_ndim=3)
        g = scalarprod(psi, _GRAD.apply(lam), axes=_AXES)
        return (u, y, lam), (g,), 0.5 * torch.sum((u - utrue) ** 2)

    return PlainStepper(local, lambda g: pullback(pop, g[0]),
                        lambda g_x, x: g_x * x, carry,
                        param_shape=param_shape, lr=lr, beta1=beta1,
                        beta2=beta2, eps=eps)


def _vtv_u_and_z(carry):
    return carry[0], carry[3]


def _single_loop_vtv_plain(utrue, f, x0, *, outer: int, param_shape: tuple,
                           carry0=None, return_carry: bool = False, **kw):
    """The learner as a Python loop (:func:`_vtv_plain_stepper`)."""
    if carry0 is None:
        carry0 = _vtv_init_carry(f, x0, param_shape=param_shape)
    stepper = _vtv_plain_stepper(utrue, f, carry0, outer=outer,
                                 param_shape=param_shape, **kw)
    return run_steps(stepper, utrue, outer, _vtv_u_and_z, return_carry)


def _vtv_stepper(utrue, f, carry, **kw):
    """One shard's steps of a mesh segment where ``f`` lives: the plain
    stepper on the CPU, the CUDA learner's session otherwise."""
    if f.device.type == "cpu":
        return _vtv_plain_stepper(utrue, f, carry, **kw)
    from .first_order_vtv_cuda import Session
    return Session(utrue, f, carry, **kw)


def _cuda_launch():
    from .first_order_vtv_cuda import _launch
    return _launch


def _single_loop_vtv_impl(utrue, f, x0, *, param_shape: tuple, **kw):
    """One segment where ``f`` lives (:func:`.first_order.run_segment`)."""
    return run_segment(
        _single_loop_vtv_plain, _cuda_launch,
        lambda ff: _vtv_init_carry(ff, x0, param_shape=param_shape),
        _vtv_u_and_z, utrue, f, x0, param_shape=param_shape, **kw)


def _prepare(utrue, f, x0):
    """→ (utrue, f, x0, pop, param_shape, squeeze) for a VTV learn."""
    out = prepare_learn(utrue, f, x0, 3, vtv_param_layout)
    if out[1].ndim != 4:
        raise ValueError(f"expected (O, C, M, N) or (C, M, N) color "
                         f"stacks, got shape {tuple(out[1].shape)}")
    return out


def single_loop_vtv_learn(utrue, f, x0, *, outer: int = 300,
                          n_inner: int = 40, n_adj: int = 10,
                          lr: float = 0.05, gamma: float = 1e-4,
                          tau0: float = 5.0, sigma0: float = 0.99 / 5.0,
                          beta1: float = 0.9, beta2: float = 0.999,
                          eps: float = 1e-8, mesh=None, optimizer=None,
                          log_every: Optional[int] = None,
                          segment_callback=None) -> SingleLoopResult:
    """Single-loop vectorial-TV bilevel learning on (O, C, M, N) /
    (C, M, N) color stacks, on the device ``f`` lives on.  ``x0``:
    strictly positive scalar α or (m, n) patch grid.  ``gamma`` is the
    Huber width of the smoothed coupled system."""
    check_unported(optimizer)
    utrue, f, x0, pop, param_shape, squeeze = _prepare(utrue, f, x0)
    kw = dict(outer=int(outer), n_inner=int(n_inner), n_adj=int(n_adj),
              pop=pop, param_shape=param_shape, lr=lr, gamma=gamma,
              tau0=tau0, sigma0=sigma0, beta1=beta1, beta2=beta2, eps=eps)
    res = drive_single_loop(
        _single_loop_vtv_impl, utrue, f, x0, kw,
        make_carry0=lambda ff: _vtv_init_carry(ff, x0,
                                               param_shape=param_shape),
        log_every=log_every, segment_callback=segment_callback, mesh=mesh,
        stepper=_vtv_stepper, u_and_z=_vtv_u_and_z)
    if squeeze:
        res = res._replace(u=res.u[0])
    return res
