"""Limited-memory BFGS models (counterpart of
``bpldenoising_tpu.solvers.lbfgs``).

The trust-region dogleg needs both directions of the quadratic model:
``B @ v`` through the compact representation
B = γI − [γS  Y] W⁻¹ [γS  Y]ᵀ, and ``B⁻¹ @ g`` through the two-loop
recursion.  Two implementations of the same model:

* :class:`LBFGSModel`: host NumPy in float64 (a deque history), for the
  host-driven trust region (:mod:`..bilevel.trust_region`) above its
  dense-B threshold;
* the ``lbfgs_*`` functions on :class:`LBFGSState`: a fixed-size history
  in the working dtype, for the fused loop (:mod:`..bilevel.tr_core`).
  Slots along dim 0 are ordered oldest → newest; the last ``count`` slots
  are valid and earlier ones are zero placeholders.
"""

from __future__ import annotations

from collections import deque
from typing import NamedTuple

import numpy as np
import torch

__all__ = ["LBFGSModel", "LBFGSState", "lbfgs_init", "lbfgs_update",
           "lbfgs_solve", "lbfgs_apply"]


class LBFGSModel:
    """Host L-BFGS model with the dense :class:`..bilevel.trust_region.
    TRModel`'s interface (``update``, ``newton_step``, ``apply``,
    ``cauchy_step``, ``pred``)."""

    def __init__(self, n: int, memory: int = 10, init_scale: float = 0.1):
        self.n = n
        self.memory = memory
        self.gamma = float(init_scale)   # B₀ = γ I
        self.S: deque[np.ndarray] = deque(maxlen=memory)
        self.Y: deque[np.ndarray] = deque(maxlen=memory)

    def update(self, y: np.ndarray, s: np.ndarray) -> None:
        """Push a curvature pair (y = Δgrad, s = step); skipped unless
        sᵀy > 1e-12‖s‖‖y‖, as the dense model skips."""
        sy = float(s @ y)
        if sy <= 1e-12 * np.linalg.norm(s) * np.linalg.norm(y):
            return
        self.S.append(np.asarray(s, dtype=np.float64).copy())
        self.Y.append(np.asarray(y, dtype=np.float64).copy())
        self.gamma = float(y @ y) / sy   # standard B₀ scaling

    def solve(self, g: np.ndarray) -> np.ndarray:
        """B⁻¹ g by the two-loop recursion."""
        q = np.asarray(g, dtype=np.float64).copy()
        m = len(self.S)
        alphas = np.zeros(m)
        rhos = np.array([1.0 / (s @ y) for s, y in zip(self.S, self.Y)])
        for i in range(m - 1, -1, -1):
            alphas[i] = rhos[i] * (self.S[i] @ q)
            q -= alphas[i] * self.Y[i]
        q /= self.gamma                     # H₀ = γ⁻¹ I
        for i in range(m):
            beta = rhos[i] * (self.Y[i] @ q)
            q += (alphas[i] - beta) * self.S[i]
        return q

    def newton_step(self, g: np.ndarray):
        return -self.solve(g)

    def apply(self, v: np.ndarray) -> np.ndarray:
        """B v with B = γI − [γS Y] [[γSᵀS, L], [Lᵀ, −D]]⁻¹ [γS Y]ᵀ v."""
        m = len(self.S)
        if m == 0:
            return self.gamma * v
        S = np.stack(self.S, axis=1)   # (n, m)
        Y = np.stack(self.Y, axis=1)
        g = self.gamma
        StS = S.T @ S
        SY = S.T @ Y
        L = np.tril(SY, k=-1)
        D = np.diag(np.diag(SY))
        W = np.block([[g * StS, L], [L.T, -D]])
        rhs = np.concatenate([g * (S.T @ v), Y.T @ v])
        try:
            sol = np.linalg.solve(W, rhs)
        except np.linalg.LinAlgError:
            return g * v
        return g * v - (g * (S @ sol[:m]) + Y @ sol[m:])

    def cauchy_step(self, g: np.ndarray) -> np.ndarray:
        gBg = float(g @ self.apply(g))
        gg = float(g @ g)
        if gBg <= np.finfo(np.float64).eps * gg:
            return -g * 1e12
        return -(gg / gBg) * g

    def pred(self, p: np.ndarray, g: np.ndarray) -> float:
        return float(-p @ g - 0.5 * p @ self.apply(p))


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
