"""Huber-smoothed TV-L1: the solver and hypergradient the TV-L1 bilevel
learn differentiates (counterpart of ``bpldenoising_tpu.solvers.tvl1_huber``).

Both nonsmooth terms of TV-L1 are smoothed by Huber functions in the slope
convention (quadratic with slope γ on |r| ≤ 1/γ, linear outside):

    min_u  Σ_pix h_{γ_d}(u − f)  +  Σ_pix α · ψ_{γ_r}(|(∇u)_pix|₂)

The solver is the unaccelerated iteration of :mod:`.tvl1` with two
closed-form resolvents:

    u⁺ = f + P(u − τ∇ᵀy − f),  P(z) = z/(1+τγ_d)     if |z| ≤ 1/γ_d + τ,
                                      z − τ·sign(z)   otherwise;
    y⁺ = Π_{|·|₂ ≤ α}( s · (y + σ∇ū) ),  s = 1/(1 + σ/(max(α, 1e-12)·γ_r)).

:func:`_tvl1_huber_impl` is the plain version of the CUDA kernel's Huber
form (:mod:`.tvl1_cuda`, ``csrc/tvl1.cu``), with the early stop of
:func:`.tvl1.cp_loop`.

:func:`tvl1_huber_hypergrad` differentiates the smoothed problem
implicitly: the adjoint system is the γ-regularized TV system of
:func:`.hypergrad.build_reg_system` with its identity data block replaced
by the Huber data Hessian D = diag(γ_d·1{|u−f| ≤ 1/γ_d}), solved by
Jacobi-preconditioned CG (the diagonal floored at 1e-12) over the whole
batch.  It is plain PyTorch on either device, as the JAX package computes
it in jnp.  :func:`tvl1_huber_implicit_cotangents` solves the same system
for any loss cotangent, with per-image CG dots, and is the backward of the
differentiable layer :func:`make_diff_tvl1_denoise` /
:func:`diff_tvl1_denoise` (:class:`.implicit.ImplicitLayer`), whose
forward is :func:`tvl1_huber_denoise` (the CUDA kernel on the card).
"""

from __future__ import annotations

import torch

from ..models import DenoiseModel, tv_model
from ..ops import proj_norm21_ball, scalarprod, xi
from .hypergrad import HypergradConfig, _defaults, build_reg_system
from .implicit import ImplicitLayer, reduce_like, weight_like
from .krylov import cg, cg_batched
from .tvl1 import cold_state, cp_loop

__all__ = ["tvl1_huber_denoise", "tvl1_huber_energy",
           "tvl1_huber_hypergrad", "tvl1_huber_implicit_cotangents",
           "make_diff_tvl1_denoise", "diff_tvl1_denoise"]

_TV = tv_model()
_GRAD = _TV.ops[0]


def _huber(r, gamma):
    """Huber penalty, slope convention: γr²/2 on |r| ≤ 1/γ, |r| − 1/(2γ)."""
    a = torch.abs(r)
    return torch.where(a <= 1.0 / gamma, 0.5 * gamma * r * r,
                       a - 0.5 / gamma)


def tvl1_huber_energy(u, f, alpha, *, gamma_d, gamma_r):
    """Smoothed primal energy Σ h_{γd}(u−f) + Σ α·ψ_{γr}(|∇u|₂)
    (per batch element)."""
    dtype, dev = u.dtype, u.device
    gamma_d = torch.tensor(gamma_d, dtype=dtype, device=dev)
    gamma_r = torch.tensor(gamma_r, dtype=dtype, device=dev)
    e = torch.sum(_huber(u - f, gamma_d), dim=(-2, -1))
    n = _huber(xi(_GRAD.apply(u)), gamma_r)
    a = torch.as_tensor(alpha, dtype=dtype).to(dev)
    return e + torch.sum(a * n, dim=(-2, -1))


def huber_prox_consts(tau, gamma_d):
    """(1/γ_d + τ, 1 + τγ_d): the Huber prox's interior half-width and
    interior divisor, in τ's dtype and on its device."""
    return 1.0 / gamma_d + tau, 1.0 + tau * gamma_d


def _huber_prox(z, tau, lo, den):
    """prox of τ·h_γ (slope convention): interior scaling, exterior shrink;
    ``lo, den`` from :func:`huber_prox_consts`."""
    return torch.where(torch.abs(z) <= lo, z / den, z - tau * torch.sign(z))


def _tvl1_huber_loop(f, alpha, state0, *, gamma_d, gamma_r, tau, sigma,
                     maxiter: int, tol, check_every: int):
    """``(u, y, iters)`` of the Huber-smoothed TV-L1 iteration."""
    dtype, dev = f.dtype, f.device

    def t(v):
        return torch.as_tensor(v, dtype=dtype).to(dev)

    tau, sigma, alpha = t(tau), t(sigma), t(alpha)
    lo, den = huber_prox_consts(tau, t(gamma_d))
    # dual Huber scaling; the floor only guards the division (α = 0 pixels
    # project to y = 0 anyway)
    scale = 1.0 / (1.0 + sigma / (torch.clamp(alpha, min=1e-12)
                                  * t(gamma_r)))
    if scale.ndim >= 2:
        scale = scale[..., None, :, :]   # broadcast over the components

    def step(u, y):
        v = u - tau * _GRAD.apply_adjoint(y)
        u_new = f + _huber_prox(v - f, tau, lo, den)
        ubar = 2.0 * u_new - u
        y_new = proj_norm21_ball(scale * (y + sigma * _GRAD.apply(ubar)),
                                 alpha)
        return u_new, y_new

    state = cold_state(f) if state0 is None else tuple(state0)
    return cp_loop(step, state, maxiter=maxiter, tol=tol,
                   check_every=check_every)


def _tvl1_huber_impl(f, alpha, state0, *, gamma_d, gamma_r, tau, sigma,
                     maxiter: int, tol, check_every: int,
                     return_dual: bool):
    """Returns ``u`` or, with ``return_dual``, ``(u, (u, y))`` (the JAX
    package's shapes: no iteration count)."""
    u, y, _ = _tvl1_huber_loop(f, alpha, state0, gamma_d=gamma_d,
                               gamma_r=gamma_r, tau=tau, sigma=sigma,
                               maxiter=maxiter, tol=tol,
                               check_every=check_every)
    if return_dual:
        return u, (u, y)
    return u


def tvl1_huber_denoise(f, alpha, *, gamma_d: float = 100.0,
                       gamma_r: float = 1000.0, tau0: float = 0.99,
                       sigma0: float = 0.99, maxiter: int = 5000,
                       tol=None, check_every: int = 500, state0=None,
                       return_dual: bool = False):
    """Huber-smoothed TV-L1 denoising of an image or (O, M, N) batch at
    weight ``alpha`` (scalar or (M, N) map), where ``f`` lives: the plain
    version for CPU tensors, the CUDA kernel for CUDA tensors
    (:func:`.tvl1_cuda.tvl1_huber_denoise_cuda`).

    ``state0`` is ``(u, y)`` or the Pallas kernel's ``(u, px, py)``;
    ``return_dual`` returns ``(u, (u, y))``.
    """
    from .tvl1_cuda import tvl1_huber_denoise_cuda
    return tvl1_huber_denoise_cuda(
        torch.as_tensor(f), alpha, gamma_d=gamma_d, gamma_r=gamma_r,
        tau0=tau0, sigma0=sigma0, maxiter=maxiter, tol=tol,
        check_every=check_every, state0=state0, return_dual=return_dual)


def tvl1_huber_hypergrad(u, f, utrue, alphas, model: DenoiseModel = _TV,
                         cfg: HypergradConfig = HypergradConfig(),
                         want_maps: bool = False, p0=None, *, gamma_d):
    """Implicit-differentiation hypergradient of the Huber-smoothed TV-L1
    problem: dJ/dα for J(α) = ½‖u(α) − ū‖².

    Solves H p = ū − u with H = D + Σₖ Gₖᵀ αₖ Wₖ Gₖ (one joint system over
    the batch), then dJ/dαₖ = ⟨Gₖp, ψ'_{γr}(Gₖu)⟩ with γ_r = ``cfg.gamma``;
    ``u`` must solve the same smoothed problem.  ``alphas`` are scalars or
    (M, N) maps on u's device.  Returns ``(grads, p, info)``: per-k scalars
    (summed over every axis) or, with ``want_maps``, (…, M, N) maps.
    """
    dtype = u.dtype
    _, _, cg_tol = _defaults(dtype, cfg)
    gamma_d = torch.tensor(gamma_d, dtype=dtype, device=u.device)

    M0, inv_diag0, fields = build_reg_system(u, alphas, model, cfg.gamma)
    d = torch.where(torch.abs(u - f) <= 1.0 / gamma_d, gamma_d,
                    torch.zeros((), dtype=dtype, device=u.device))

    def M_apply(p):
        # build_reg_system's operator is I + Σ GᵀαWG; swap I for D
        return M0(p) + (d - 1.0) * p

    diag = 1.0 / inv_diag0 + (d - 1.0)
    inv_diag = 1.0 / torch.clamp(diag, min=1e-12)

    rhs = utrue - u
    p, info = cg(M_apply, rhs, x0=p0, tol=cg_tol, maxiter=cfg.cg_maxiter,
                 M=lambda r: inv_diag * r)

    grads = []
    for op, field in zip(model.ops, fields):
        gmap = scalarprod(op.apply(p), field)
        grads.append(gmap if want_maps else torch.sum(gmap))
    return tuple(grads), p, info


# ---------------------------------------------------------------------------
# Implicit-differentiation layer: gradients flow to f and α
# ---------------------------------------------------------------------------

def tvl1_huber_implicit_cotangents(u, f, alpha, v, *, gamma_d,
                                   gamma: float = 1000.0,
                                   cg_tol: float | None = 1e-6,
                                   cg_maxiter: int = 1000,
                                   lam0=None, return_lam: bool = False):
    """Implicit-function-theorem cotangents at a smoothed TV-L1 solution.

    Given the loss cotangent ``v = ∂J/∂u`` (shaped like u), solves the
    smoothed adjoint system H λ = v once (per-image CG dots,
    ``cg_batched(item_ndim=2)``) and returns ``(df, dα)``: df = D λ with D
    the Huber data Hessian (du/df = H⁻¹D), and dα = −⟨∇λ, ψ'(∇u)⟩ reduced
    to the shape of ``alpha`` (scalar or (M, N) map).  ``cg_tol=None``
    takes the dtype's default (1e-8 float64, 1e-5 float32); ``lam0``
    warm-starts the CG and ``return_lam`` appends λ.
    """
    dtype = u.dtype
    if cg_tol is None:   # the dtype's default, as _defaults derives it
        cg_tol = 1e-8 if dtype == torch.float64 else 1e-5
    a = torch.as_tensor(alpha, dtype=dtype)
    a = a.to(u.device) if a.ndim >= 2 else a
    gamma_d = torch.tensor(gamma_d, dtype=dtype, device=u.device)

    M0, inv_diag0, fields = build_reg_system(u, (a,), _TV, gamma)
    d = torch.where(torch.abs(u - f) <= 1.0 / gamma_d, gamma_d,
                    torch.zeros((), dtype=dtype, device=u.device))

    def H(x):
        return M0(x) + (d - 1.0) * x

    diag = torch.clamp(1.0 / inv_diag0 + (d - 1.0), min=1e-12)
    lam, _ = cg_batched(H, v, x0=lam0, tol=cg_tol, maxiter=cg_maxiter,
                        M=lambda r: r / diag, item_ndim=2)

    da = reduce_like(-scalarprod(_GRAD.apply(lam), fields[0]), a)
    out = d * lam, da
    return out + (lam,) if return_lam else out


def make_diff_tvl1_denoise(maxiter: int = 5000, gamma_d: float = 100.0,
                           gamma: float = 1000.0,
                           cg_tol: float | None = None,
                           cg_maxiter: int = 2000, tau0: float = 0.99,
                           sigma0: float = 0.99, tol=None,
                           check_every: int = 500):
    """Differentiable Huber-smoothed TV-L1 denoiser ``(f, α) → u``
    (batched; gradients flow to f and α through one CG solve).  The
    forward is :func:`tvl1_huber_denoise` at ``gamma_r = gamma`` where
    ``f`` lives (the CUDA kernel on the card); ``cg_tol=None`` derives the
    adjoint tolerance from the dtype, and ``cg_maxiter`` defaults to 2000,
    the settings of :func:`..learning.tvl1.tvl1_learning_function`."""

    def solve(f, alphas):
        return tvl1_huber_denoise(
            f, alphas[0], gamma_d=gamma_d, gamma_r=gamma, tau0=tau0,
            sigma0=sigma0, maxiter=maxiter, tol=tol,
            check_every=check_every), None

    def cotangents(u, f, alphas, extra, v):
        df, da = tvl1_huber_implicit_cotangents(
            u, f, alphas[0], v, gamma_d=gamma_d, gamma=gamma, cg_tol=cg_tol,
            cg_maxiter=cg_maxiter)
        return df, (da,)

    def layer(f, alpha):
        return ImplicitLayer.apply(solve, cotangents, f, alpha)

    return layer


def diff_tvl1_denoise(f, alpha, maxiter: int = 5000):
    """Differentiable TV-L1 denoising at the default smoothing (companion
    to ``diff_tv_denoise`` / ``diff_tgv_denoise`` / ``diff_vtv_denoise``)."""
    f = torch.as_tensor(f)
    return make_diff_tvl1_denoise(maxiter=maxiter)(f, weight_like(alpha, f))
