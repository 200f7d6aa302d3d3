"""TV-L1 denoising by unaccelerated Chambolle–Pock: the plain PyTorch
version (counterpart of ``bpldenoising_tpu.solvers.tvl1``).

Solves, for impulse (salt-and-pepper) noise,

    min_u  ‖u − f‖₁ + Σ_pix α·|(∇u)_pix|₂

with fixed steps τ = τ₀/L, σ = σ₀/L (L = ‖∇‖ = √8, τσL² < 1) and no
acceleration (the L1 term is not strongly convex):

    u⁺ = f + shrink(u − τ∇ᵀy − f, τ)
    ū  = 2u⁺ − u
    y⁺ = Π_{|·|₂ ≤ α}(y + σ∇ū)

:func:`_tvl1_impl` is the plain version of the CUDA kernel
(:mod:`.tvl1_cuda`, ``csrc/tvl1.cu``); :func:`tvl1_denoise` runs that plain
version for tensors on the CPU and the kernel for CUDA tensors.  The
optional early stop runs chunks of ``check_every`` iterations and stops
once the BATCH-GLOBAL √(Σ(u − u_prev)² / max(Σu², 1e-24)), u the new
iterate, is ≤ ``tol``: one host read per chunk.  The Huber-smoothed
problem (:mod:`.tvl1_huber`) runs the same loop with another prox and a
dual scaling.
"""

from __future__ import annotations

import math

import torch

from ..models import tv_model
from ..ops import norm21, proj_norm21_ball, xi

__all__ = ["tvl1_denoise", "tvl1_energy"]

_TV = tv_model()
_GRAD = _TV.ops[0]


def step_sizes(tau0, sigma0, dtype, device=None):
    """(τ, σ) = (τ₀/L, σ₀/L), L = √‖∇‖², formed in double precision and
    rounded once to the working dtype (as the JAX package does)."""
    L = float(_TV.opnorm_sq()) ** 0.5
    return (torch.tensor(float(tau0) / L, dtype=dtype, device=device),
            torch.tensor(float(sigma0) / L, dtype=dtype, device=device))


def cold_state(f):
    """The cold start ``(f, 0)`` with the dual y shaped (..., 2, M, N)."""
    return f, torch.zeros(f.shape[:-2] + (2,) + f.shape[-2:], dtype=f.dtype,
                          device=f.device)


def as_jnp_state(state0, dtype=None):
    """A warm state in either JAX format, ``(u, y)`` with y stacked
    (..., 2, M, N) or the Pallas kernels' ``(u, px, py)``, as ``(u, y)``."""
    if state0 is None:
        return None
    state0 = tuple(torch.as_tensor(s, dtype=dtype) for s in state0)
    if len(state0) == 3:
        u0, px, py = state0
        return u0, torch.stack([px, py], dim=-3)
    if len(state0) == 2:
        return state0
    raise ValueError("a TV-L1 state is (u, y) or (u, px, py), got "
                     f"{len(state0)} arrays")


def tvl1_energy(u, f, alpha):
    """Primal TV-L1 energy ‖u−f‖₁ + Σ_pix α·|∇u|₂ (per batch element)."""
    e = torch.sum(torch.abs(u - f), dim=(-2, -1))
    g = _GRAD.apply(u)
    a = torch.as_tensor(alpha, dtype=u.dtype).to(u.device)
    if a.ndim >= 2:
        return e + torch.sum(a * xi(g), dim=(-2, -1))
    return e + a * norm21(g)


def _shrink(z, t):
    return torch.sign(z) * torch.clamp(torch.abs(z) - t, min=0.0)


def relative_change(u, u_prev):
    """√(Σ(u − u_prev)² / max(Σu², 1e-24)) over the whole batch (0-d)."""
    num = torch.sum((u - u_prev) ** 2)
    den = torch.clamp(torch.sum(u ** 2), min=1e-24)
    return torch.sqrt(num / den)


def cp_loop(step, state0, *, maxiter: int, tol, check_every: int):
    """Run ``step(u, y) -> (u, y)`` from ``state0`` for ``maxiter``
    iterations, or in chunks of ``check_every`` until the relative change
    is ≤ ``tol``.  Returns ``(u, y, iters)``."""
    u, y = state0
    if tol is None:
        for _ in range(maxiter):
            u, y = step(u, y)
        return u, y, int(maxiter)
    tol_t = torch.tensor(tol, dtype=u.dtype)
    iters = 0
    rel = torch.tensor(math.inf, dtype=u.dtype)
    while iters < maxiter and bool(rel > tol_t):   # NaN stops
        u_prev = u
        n = min(int(check_every), maxiter - iters)
        for _ in range(n):
            u, y = step(u, y)
        rel = relative_change(u, u_prev).cpu()
        iters += n
    return u, y, iters


def _tvl1_loop(f, alpha, state0, *, tau, sigma, maxiter: int, tol,
               check_every: int):
    """``(u, y, iters)`` of the plain TV-L1 iteration."""
    dtype, dev = f.dtype, f.device
    tau = torch.as_tensor(tau, dtype=dtype).to(dev)
    sigma = torch.as_tensor(sigma, dtype=dtype).to(dev)
    alpha = torch.as_tensor(alpha, dtype=dtype).to(dev)

    def step(u, y):
        v = u - tau * _GRAD.apply_adjoint(y)
        u_new = f + _shrink(v - f, tau)
        ubar = 2.0 * u_new - u
        y_new = proj_norm21_ball(y + sigma * _GRAD.apply(ubar), alpha)
        return u_new, y_new

    state = cold_state(f) if state0 is None else tuple(state0)
    return cp_loop(step, state, maxiter=maxiter, tol=tol,
                   check_every=check_every)


def _tvl1_impl(f, alpha, state0=None, *, tau, sigma, maxiter: int, tol,
               check_every: int, return_dual: bool):
    """Returns ``u`` or, with ``return_dual``, ``(u, (u, y), iters)`` (the
    JAX package's shapes)."""
    u, y, iters = _tvl1_loop(f, alpha, state0, tau=tau, sigma=sigma,
                             maxiter=maxiter, tol=tol,
                             check_every=check_every)
    if return_dual:
        return u, (u, y), iters
    return u


def tvl1_denoise(f, alpha, *, tau0: float = 0.99, sigma0: float = 0.99,
                 maxiter: int = 5000, tol=None, check_every: int = 500,
                 state0=None, return_dual: bool = False):
    """TV-L1 denoising of an image or (O, M, N) batch at weight ``alpha``
    (scalar or (M, N) map), where ``f`` lives: the plain version for CPU
    tensors, the CUDA kernel for CUDA tensors
    (:func:`.tvl1_cuda.tvl1_denoise_cuda`).

    ``state0`` is ``(u, y)`` or the Pallas kernels' ``(u, px, py)``;
    ``return_dual`` returns ``(u, (u, y), iters)``.
    """
    from .tvl1_cuda import tvl1_denoise_cuda
    return tvl1_denoise_cuda(
        torch.as_tensor(f), alpha, tau0=tau0, sigma0=sigma0,
        maxiter=maxiter, tol=tol, check_every=check_every, state0=state0,
        return_dual=return_dual)
