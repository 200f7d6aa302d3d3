"""Limited-memory BFGS model with a fixed-size history (counterpart of the
``lbfgs_*`` functions of ``bpldenoising_tpu.solvers.lbfgs``).

The trust-region dogleg needs both directions of the quadratic model:
``B @ v`` through the compact representation
B = γI − [γS  Y] W⁻¹ [γS  Y]ᵀ, and ``B⁻¹ @ g`` through the two-loop
recursion.  Slots along dim 0 are ordered oldest → newest; the last
``count`` slots are valid and earlier ones are zero placeholders.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["LBFGSState", "lbfgs_init", "lbfgs_update", "lbfgs_solve",
           "lbfgs_apply"]


class LBFGSState(NamedTuple):
    S: torch.Tensor       # (memory, n) steps
    Y: torch.Tensor       # (memory, n) gradient differences
    count: int            # number of valid pairs
    gamma: torch.Tensor   # scalar, B₀ = γ I


def lbfgs_init(n: int, memory: int, dtype, init_scale: float = 0.1,
               device="cpu") -> LBFGSState:
    return LBFGSState(S=torch.zeros((memory, n), dtype=dtype, device=device),
                      Y=torch.zeros((memory, n), dtype=dtype, device=device),
                      count=0,
                      gamma=torch.tensor(init_scale, dtype=dtype,
                                         device=device))


def _valid_mask(st: LBFGSState):
    m = st.S.shape[0]
    idx = torch.arange(m, device=st.S.device)
    return (idx >= m - st.count).to(st.S.dtype)


def lbfgs_update(st: LBFGSState, y, s) -> LBFGSState:
    """Curvature-gated push: skipped unless sᵀy > 1e-12‖s‖‖y‖."""
    sy = s @ y
    ok = bool(sy > 1e-12 * torch.linalg.norm(s) * torch.linalg.norm(y))
    if not ok:
        return st
    S2 = torch.roll(st.S, -1, dims=0)
    Y2 = torch.roll(st.Y, -1, dims=0)
    S2[-1] = s
    Y2[-1] = y
    gamma2 = (y @ y) / torch.where(sy == 0, torch.ones_like(sy), sy)
    return LBFGSState(S=S2, Y=Y2, count=min(st.count + 1, st.S.shape[0]),
                      gamma=gamma2)


def lbfgs_solve(st: LBFGSState, g):
    """H g = B⁻¹ g via the two-loop recursion (masked history)."""
    m = st.S.shape[0]
    valid = _valid_mask(st)
    sy = torch.sum(st.S * st.Y, dim=1)
    safe = torch.where(sy == 0, torch.ones_like(sy), sy)
    rho = torch.where((sy != 0) & (valid > 0), 1.0 / safe,
                      torch.zeros_like(sy))
    q = g.clone()
    alphas = torch.zeros((m,), dtype=g.dtype, device=g.device)
    for idx in range(m - 1, -1, -1):     # newest → oldest
        a = rho[idx] * (st.S[idx] @ q)
        q = q - a * st.Y[idx]
        alphas[idx] = a
    q = q / st.gamma
    for i in range(m):
        b = rho[i] * (st.Y[i] @ q)
        q = q + (alphas[i] - b) * st.S[i]
    return q


def lbfgs_apply(st: LBFGSState, v):
    """B v via the compact representation (masked history); falls back to
    B₀ v when the W system is singular."""
    m = st.S.shape[0]
    valid = _valid_mask(st)
    g = st.gamma
    S = st.S * valid[:, None]
    Y = st.Y * valid[:, None]
    StS = S @ S.T
    SY = S @ Y.T
    L = torch.tril(SY, diagonal=-1)
    D = torch.diag(torch.diag(SY))
    W = torch.cat([torch.cat([g * StS, L], dim=1),
                   torch.cat([L.T, -D], dim=1)], dim=0)
    valid2 = torch.cat([valid, valid])
    W = W * torch.outer(valid2, valid2) + torch.diag(1.0 - valid2)
    rhs = torch.cat([g * (S @ v), Y @ v]) * valid2
    sol, info = torch.linalg.solve_ex(W, rhs)
    out = g * v - (g * (S.T @ sol[:m]) + Y.T @ sol[m:])
    if int(info) != 0 or not bool(torch.all(torch.isfinite(out))):
        return g * v
    return out
