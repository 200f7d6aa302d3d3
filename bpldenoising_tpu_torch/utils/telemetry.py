"""Adjoint-CG convergence telemetry (counterpart of the ``AdjointCGStats``
and ``record_adjoint_cg`` of ``bpldenoising_tpu.utils.telemetry``).

The hypergradients solve their adjoint systems by matrix-free CG, whose
:class:`..solvers.krylov.KrylovInfo` carries ``(iters, resnorm,
converged)``.  :func:`record_adjoint_cg` reads it on the host, keeps
running statistics on the learning function (``lf.adjoint_cg``), stores
the latest solve as ``lf.last_adjoint_cg`` (which the trust region copies
into its log) and warns with a ``RuntimeWarning`` when a solve stopped at
its iteration cap.  The warning is not fatal: a bad gradient gives a
rejected step and a smaller radius, which the trust region recovers from.

Kernel B reads its stats to the host inside its one read, so its info
costs no device read here; the plain CG of the TGV², TV-L1 and VTV
adjoints leaves ``resnorm`` and ``converged`` on the device, and they come
over together in one read.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

__all__ = ["AdjointCGStats", "record_adjoint_cg"]


class AdjointCGStats:
    """Running statistics over the adjoint-CG solves of one learning
    function (``lf.adjoint_cg`` of every factory)."""

    def __init__(self):
        self.n_solves = 0
        self.n_unconverged = 0
        self.iters_total = 0
        self.max_iters = 0
        self.last_iters = 0
        self.last_resnorm = float("nan")
        self.last_converged = True

    def update(self, iters: int, resnorm: float, converged: bool):
        self.n_solves += 1
        self.iters_total += iters
        self.max_iters = max(self.max_iters, iters)
        self.last_iters = iters
        self.last_resnorm = resnorm
        self.last_converged = converged
        if not converged:
            self.n_unconverged += 1

    def as_dict(self) -> dict:
        return {
            "n_solves": self.n_solves,
            "n_unconverged": self.n_unconverged,
            "iters_total": self.iters_total,
            "max_iters": self.max_iters,
            "last_iters": self.last_iters,
            "last_resnorm": self.last_resnorm,
            "last_converged": self.last_converged,
        }

    def __repr__(self):
        return f"AdjointCGStats({self.as_dict()!r})"


def _worst(info):
    """(max iters, max resnorm, all converged) of a KrylovInfo whose fields
    are numbers, arrays or tensors; device tensors come over in one read."""
    iters = int(np.max(np.asarray(torch.as_tensor(info.iters).cpu())))
    res = torch.as_tensor(info.resnorm)
    conv = torch.as_tensor(info.converged, device=res.device)
    host = torch.stack([torch.max(res).to(torch.float64),
                        torch.all(conv).to(torch.float64)]).cpu()
    return iters, float(host[0]), bool(host[1])


def record_adjoint_cg(holder, info, *, context: str = "adjoint") -> dict:
    """Read a :class:`..solvers.krylov.KrylovInfo` on the host, update the
    running stats on ``holder`` (created on first use as
    ``holder.adjoint_cg``) and warn if the solve did not converge.

    Per-item fields reduce to the worst case (max iters and residual, all
    converged).  Returns the entry also stored as
    ``holder.last_adjoint_cg``: ``{"iters": int, "resnorm": float,
    "converged": bool}``."""
    iters, resnorm, converged = _worst(info)
    entry = {"iters": iters, "resnorm": resnorm, "converged": converged}
    stats = getattr(holder, "adjoint_cg", None)
    if stats is None:
        stats = AdjointCGStats()
        try:
            holder.adjoint_cg = stats
        except AttributeError:
            pass  # unwritable holder: still warn, skip accumulation
    stats.update(entry["iters"], entry["resnorm"], entry["converged"])
    try:
        holder.last_adjoint_cg = entry
    except AttributeError:
        pass
    if not entry["converged"]:
        warnings.warn(
            f"{context} CG did not converge: {entry['iters']} iterations, "
            f"final residual norm {entry['resnorm']:.3e} — the "
            "hypergradient may be inaccurate (raise cg_maxiter or loosen "
            "cg_tol)", RuntimeWarning, stacklevel=3)
    return entry
