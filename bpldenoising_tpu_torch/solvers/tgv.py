"""TGV² denoising: the joint-primal Chambolle–Pock solver and the implicit
hypergradient of its smoothed optimality system (counterpart of
``bpldenoising_tpu.solvers.tgv``).

Second-order total generalized variation solves

    min_{u,w}  ½‖u − f‖² + α₁‖∇u − w‖_{2,1} + α₀‖E w‖_{2,1}

(E = symmetrized gradient, :mod:`..ops.tgv`) by Chambolle–Pock on the
saddle form with joint primal (u, w) and duals (p, q) for
K(u, w) = (∇u − w, E w):

    u⁺ = (u − τ ∇ᵀp + τ f) / (1 + τ)          (data prox)
    w⁺ = w + τ (p − Eᵀ q)                       (no prox)
    (ū, w̄) = 2(u⁺, w⁺) − (u, w)
    p⁺ = Π_{|·|≤α₁}(p + σ(∇ū − w̄))
    q⁺ = Π_{|·|≤α₀}(q + σ E w̄)

with τ = τ₀/√12, σ = σ₀/√12 (‖K‖² ≤ 12) and no acceleration.

:func:`_tgv_impl` is the plain PyTorch version of the CUDA kernel
(:mod:`.tgv_cuda`, ``csrc/tgv.cu``); :func:`tgv_denoise_pdps` runs that
plain version for tensors on the CPU and the kernel for CUDA tensors.  The
optional early stop runs chunks of ``check_every`` iterations and stops
once the BATCH-GLOBAL relative change ‖u − u_prev‖ / max(‖u_prev‖, 1) is
≤ ``tol``: one host read per chunk.

:func:`tgv_implicit_cotangents` applies the implicit function theorem to
the γ-Huber-smoothed joint optimality system

    F_u = u − f + α₁ ∇ᵀψ_γ(∇u − w)               = 0
    F_w = −α₁ ψ_γ(∇u − w) + α₀ Eᵀψ_γ(E w)        = 0

with one Jacobi-preconditioned CG solve on the SPD joint Hessian (three
stacked planes: u and the two w components), per image.
:func:`make_diff_tgv_denoise` and :func:`diff_tgv_denoise` are the
differentiable layer built on it (:class:`.implicit.ImplicitLayer`): the
forward is :func:`tgv_denoise_pdps` (the CUDA kernel on the card), the
backward :func:`tgv_implicit_cotangents`.
"""

from __future__ import annotations

import math

import torch

from ..ops import (FwdGradientOp, proj_norm21_ball, scalarprod, sym_div,
                   sym_grad, xi)
from ..ops.grad import dminus_gram
from ..ops.tgv import TGV_OPNORM_SQ
from .implicit import (ImplicitLayer, check_layer_backend, reduce_like,
                       weight_like)
from .krylov import cg_batched

__all__ = ["tgv_denoise_pdps", "tgv_energy", "tgv_implicit_cotangents",
           "make_diff_tgv_denoise", "diff_tgv_denoise", "TGV_PDPS_DEFAULTS"]

_GRAD = FwdGradientOp()

TGV_PDPS_DEFAULTS = dict(tau0=0.99, sigma0=0.99, maxiter=5000)


def step_sizes(tau0, sigma0, dtype, device=None):
    """(τ, σ) = (τ₀/√12, σ₀/√12) in the working dtype."""
    L = torch.sqrt(torch.tensor(TGV_OPNORM_SQ, dtype=dtype, device=device))
    return (torch.tensor(tau0, dtype=dtype, device=device) / L,
            torch.tensor(sigma0, dtype=dtype, device=device) / L)


def _step(f, a1, a0, tau, sigma, state):
    u, w, p, q = state
    u_new = (u - tau * _GRAD.apply_adjoint(p) + tau * f) / (1.0 + tau)
    w_new = w + tau * (p - sym_div(q))
    ubar = 2.0 * u_new - u
    wbar = 2.0 * w_new - w
    p_new = proj_norm21_ball(p + sigma * (_GRAD.apply(ubar) - wbar), a1)
    q_new = proj_norm21_ball(q + sigma * sym_grad(wbar), a0)
    return (u_new, w_new, p_new, q_new)


def cold_state(f):
    """The cold start ``(f, 0, 0, 0)``: w, p are (..., 2, M, N), q is
    (..., 3, M, N)."""
    lead, plane = f.shape[:-2], f.shape[-2:]
    vec = torch.zeros(lead + (2,) + plane, dtype=f.dtype, device=f.device)
    ten = torch.zeros(lead + (3,) + plane, dtype=f.dtype, device=f.device)
    return (f, vec, vec, ten)


def relative_change(u, u_prev):
    """‖u − u_prev‖ / max(‖u_prev‖, 1) over the whole batch (0-d)."""
    du = torch.sqrt(torch.sum((u - u_prev) ** 2))
    ref = torch.clamp(torch.sqrt(torch.sum(u_prev ** 2)), min=1.0)
    return du / ref


def _tgv_impl(f, a1, a0, state0=None, *, tau0, sigma0, maxiter: int,
              tol, check_every: int, return_state: bool):
    """Returns ``(u, w, iters)`` or, with ``return_state``,
    ``(u, w, (u, w, p, q), iters)``."""
    dtype = f.dtype
    tau, sigma = step_sizes(tau0, sigma0, dtype, f.device)
    a1 = torch.as_tensor(a1, dtype=dtype).to(f.device)
    a0 = torch.as_tensor(a0, dtype=dtype).to(f.device)
    state = tuple(state0) if state0 is not None else cold_state(f)

    if tol is None:
        for _ in range(maxiter):
            state = _step(f, a1, a0, tau, sigma, state)
        iters = int(maxiter)
    else:
        tol_t = torch.tensor(tol, dtype=dtype)
        iters = 0
        rel = torch.tensor(math.inf, dtype=dtype)
        while iters < maxiter and bool(rel > tol_t):
            u_prev = state[0]
            n = min(int(check_every), maxiter - iters)
            for _ in range(n):
                state = _step(f, a1, a0, tau, sigma, state)
            rel = relative_change(state[0], u_prev).cpu()
            iters += n

    u, w = state[0], state[1]
    if return_state:
        return u, w, state, iters
    return u, w, iters


def tgv_denoise_pdps(f, alpha1, alpha0, *, tau0=0.99, sigma0=0.99,
                     maxiter: int = 5000, tol=None, check_every: int = 500,
                     state0=None, return_state: bool = False):
    """Batched TGV² denoising of an ``(..., M, N)`` stack where ``f``
    lives: the plain version for CPU tensors, the CUDA kernel for CUDA
    tensors (see :func:`.tgv_cuda.tgv_denoise_pdps_cuda`).

    Args:
      alpha1: weight on ‖∇u − w‖₂,₁ (scalar or (M, N) map).
      alpha0: weight on ‖E w‖₂,₁ (scalar or (M, N) map).
      tol / check_every: optional chunked early stop on the relative
        u-increment.
      state0 / return_state: warm-start state ``(u, w, p, q)``.

    Returns ``(u, w)``; with ``return_state``, ``(u, w, state, iters)``.
    """
    from .tgv_cuda import tgv_denoise_pdps_cuda
    return tgv_denoise_pdps_cuda(
        torch.as_tensor(f), alpha1, alpha0, tau0=tau0, sigma0=sigma0,
        maxiter=maxiter, tol=tol, check_every=check_every, state0=state0,
        return_state=return_state)


def tgv_energy(f, u, w, alpha1, alpha0):
    """Primal TGV² energy per image: (..., M, N) → (...).  ``alpha1`` /
    ``alpha0`` are scalars or (M, N) maps."""
    fid = 0.5 * torch.sum((u - f) ** 2, dim=(-2, -1))
    t1 = torch.sum(alpha1 * xi(_GRAD.apply(u) - w), dim=(-2, -1))
    t0 = torch.sum(alpha0 * xi(sym_grad(w)), dim=(-2, -1))
    return fid + t1 + t0


# ---------------------------------------------------------------------------
# implicit differentiation (smoothed joint system)
# ---------------------------------------------------------------------------

def _dpsi(field, gamma):
    """γ-Huber gradient ψ and its Jacobian action at ``field``.

    ψ(y) = y / max(|y|, γ);  Dψ(d) = s·d − 1[|y|≥γ]·y (y·d) s³ with
    s = 1/max(|y|, γ).
    """
    nrm = xi(field)
    s = 1.0 / torch.clamp(nrm, min=gamma)
    mask = (nrm >= gamma).to(field.dtype)
    psi = field * s[..., None, :, :]

    def jac(d):
        rad = mask * scalarprod(field, d) * s ** 3
        return s[..., None, :, :] * d - field * rad[..., None, :, :]

    return psi, s, jac


def _amul(a, field):
    """Multiply a (..., C, M, N) field by a scalar or (M, N)-map weight."""
    return field * (a[..., None, :, :] if a.ndim >= 2 else a)


def _build_joint_system(u, w, a1, a0, gamma):
    """SPD joint Hessian H of the smoothed energy at (u, w), its Jacobi
    diagonal, and the ψ fields for the α-cotangents.  Stacked layout:
    plane 0 = u, planes 1:3 = w.  Map weights sit inside the stencil
    adjoints (∇ᵀ(a₁ψ), Eᵀ(a₀ψ)), which keeps H symmetric."""
    y = _GRAD.apply(u) - w
    z = sym_grad(w)
    psi_y, s_y, Dy = _dpsi(y, gamma)
    psi_z, s_z, Dz = _dpsi(z, gamma)

    def H(x):
        du = x[..., 0, :, :]
        dw = x[..., 1:3, :, :]
        a1hy = _amul(a1, Dy(_GRAD.apply(du) - dw))
        a0hz = _amul(a0, Dz(sym_grad(dw)))
        Hu = du + _GRAD.apply_adjoint(a1hy)
        Hw = -a1hy + sym_div(a0hz)
        return torch.cat([Hu[..., None, :, :], Hw], dim=-3)

    # Jacobi preconditioner (isotropic approximation: the rank-one part of
    # Dψ is dropped, exact where |y| < γ)
    a1sy = a1 * s_y
    a0sz = a0 * s_z
    sy2 = torch.stack([a1sy, a1sy], dim=-3)
    diag_u = 1.0 + _GRAD.gram_diag(sy2)
    e_r = dminus_gram(a0sz, -2) + 0.5 * dminus_gram(a0sz, -1)
    e_c = dminus_gram(a0sz, -1) + 0.5 * dminus_gram(a0sz, -2)
    diag = torch.cat(
        [diag_u[..., None, :, :],
         torch.stack([a1sy + e_r, a1sy + e_c], dim=-3)], dim=-3)
    return H, diag, psi_y, psi_z


def tgv_implicit_cotangents(u, w, alphas, v, *, gamma: float = 1e-4,
                            cg_tol: float = 1e-6, cg_maxiter: int = 1000,
                            lam0=None, return_lam: bool = False,
                            return_info: bool = False):
    """Implicit-function-theorem cotangents at a TGV solution (u, w).

    Given the loss cotangent ``v = ∂J/∂u``, solves the SPD smoothed joint
    system once (per-image CG, ``item_ndim=3``) and returns
    ``(df, (dα₁, dα₀))``; each dα is a scalar for a scalar weight and a
    batch-summed (M, N) map for a map weight.  ``lam0`` warm-starts the CG
    (``return_lam`` appends the multiplier λ), ``return_info`` appends the
    :class:`.krylov.KrylovInfo`."""
    a1 = torch.as_tensor(alphas[0], dtype=u.dtype).to(u.device)
    a0 = torch.as_tensor(alphas[1], dtype=u.dtype).to(u.device)
    H, diag, psi_y, psi_z = _build_joint_system(u, w, a1, a0, gamma)
    rhs = torch.cat([v[..., None, :, :], torch.zeros_like(w)], dim=-3)
    lam, info = cg_batched(H, rhs, x0=lam0, tol=cg_tol, maxiter=cg_maxiter,
                           M=lambda r: r / diag, item_ndim=3)
    lu = lam[..., 0, :, :]
    lw = lam[..., 1:3, :, :]
    g1 = -scalarprod(psi_y, _GRAD.apply(lu) - lw)
    g0 = -scalarprod(psi_z, sym_grad(lw))
    out = lu, (reduce_like(g1, a1), reduce_like(g0, a0))
    if return_lam:
        out = out + (lam,)
    if return_info:
        out = out + (info,)
    return out


def make_diff_tgv_denoise(maxiter: int = 5000, gamma: float = 1e-4,
                          cg_tol: float = 1e-6, cg_maxiter: int = 1000,
                          tau0: float = 0.99, sigma0: float = 0.99,
                          tol=None, check_every: int = 500,
                          backend: str = "auto", interpret: bool = False):
    """Differentiable TGV² denoiser ``(f, (α₁, α₀)) → u`` (batched;
    gradients flow to f and both weights through one joint CG solve).
    The forward is :func:`tgv_denoise_pdps` where ``f`` lives (the CUDA
    kernel on the card), which also gives the w of the backward's
    :func:`tgv_implicit_cotangents`.  ``backend`` and ``interpret``
    follow :func:`.implicit.check_layer_backend`."""
    check_layer_backend(backend, interpret)

    def solve(f, alphas):
        u, w = tgv_denoise_pdps(f, alphas[0], alphas[1], tau0=tau0,
                                sigma0=sigma0, maxiter=maxiter, tol=tol,
                                check_every=check_every)
        return u, w

    def cotangents(u, f, alphas, w, v):
        return tgv_implicit_cotangents(u, w, alphas, v, gamma=gamma,
                                       cg_tol=cg_tol, cg_maxiter=cg_maxiter)

    def layer(f, alphas):
        return ImplicitLayer.apply(solve, cotangents, f, *alphas)

    return layer


def diff_tgv_denoise(f, alpha1, alpha0, maxiter: int = 5000):
    """Differentiable TGV² denoising (companion to
    :func:`.implicit.diff_tv_denoise`): ``torch.autograd`` flows through
    f, α₁ and α₀ at the cost of one CG solve."""
    f = torch.as_tensor(f)
    return make_diff_tgv_denoise(maxiter=maxiter)(
        f, (weight_like(alpha1, f), weight_like(alpha0, f)))
