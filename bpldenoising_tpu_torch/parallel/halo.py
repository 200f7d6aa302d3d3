"""Spatial-domain decomposition: row-sharded stencils with halo exchange
(counterpart of ``bpldenoising_tpu.parallel.halo``).

An (M, N) image is split into row blocks over a mesh's rows axis.  Each
finite-difference application along the rows takes exactly one boundary
row from each neighbouring block (the JAX package's ``ppermute``, here a
copy from the neighbour's tensor onto this block's device); column
stencils and everything else are local.  The solvers run every block's
iteration in lockstep from one host thread: a block is a tensor on its
device, the operations are queued on each device's stream, so several
cards work at once.  On a 2-D (batch × rows) mesh each batch shard runs
the row-sharded iteration on its sub-stack, and one exchange carries every
local image's boundary row at once.

The solvers are plain PyTorch, as the JAX package computes them outside
any kernel; their arithmetic mirrors it operation for operation:

* :func:`denoise_pdps_row_sharded`, :func:`denoise_pdps_batch_row_sharded`
  (accelerated PDPS, K blocks, scalar or map weights),
* :func:`tgv_denoise_pdps_row_sharded`,
  :func:`tgv_denoise_pdps_batch_row_sharded` (joint-primal TGV² CP),
* :func:`vtv_denoise_pdps_row_sharded`,
  :func:`vtv_denoise_pdps_batch_row_sharded` (channel-coupled VTV),
* :func:`tvl1_denoise_row_sharded`, :func:`tvl1_denoise_batch_row_sharded`
  (unaccelerated TV-L1 CP).

Rows (and a batch) that do not divide by the mesh axis raise.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..models import DenoiseModel
from ..ops.grad import (BwdGradientOp, CenteredGradientOp, FwdGradientOp,
                        dcent, dcent_T, dminus, dminus_T, dplus, dplus_T)
from .mesh import BATCH_AXIS, ROWS_AXIS, Mesh

__all__ = ["denoise_pdps_row_sharded", "denoise_pdps_batch_row_sharded",
           "tgv_denoise_pdps_row_sharded",
           "tgv_denoise_pdps_batch_row_sharded",
           "vtv_denoise_pdps_row_sharded",
           "vtv_denoise_pdps_batch_row_sharded",
           "tvl1_denoise_row_sharded",
           "tvl1_denoise_batch_row_sharded", "ROWS_AXIS"]


# ---------------------------------------------------------------------------
# blocks and the halo exchange (rows are axis -2 of every block)
# ---------------------------------------------------------------------------

class Blocks(list):
    """One tensor per block of an (n_batch × n_rows) grid, in row-major
    order, with elementwise arithmetic: an operand is another
    :class:`Blocks` (block by block) or a number / 0-d tensor (to every
    block)."""

    def __init__(self, items, n_rows: int):
        super().__init__(items)
        self.n_rows = n_rows

    def map(self, fn, *others):
        return Blocks([fn(x, *(o[i] if isinstance(o, Blocks) else o
                                for o in others))
                       for i, x in enumerate(self)], self.n_rows)

    def first(self, i):
        return i % self.n_rows == 0

    def last(self, i):
        return i % self.n_rows == self.n_rows - 1

    def _from(self, rows, step):
        """``rows[i]`` of the neighbour ``step`` blocks along this block's
        row group (cyclic, as ``ppermute``; the wrapped row is masked by
        the caller), moved to block i's device."""
        n = self.n_rows
        return [rows[i - i % n + (i % n + step) % n].to(rows[i].device)
                for i in range(len(rows))]

    def from_next(self, rows):
        return self._from(rows, 1)

    def from_prev(self, rows):
        return self._from(rows, -1)

    __add__ = lambda a, b: a.map(torch.add, b)           # noqa: E731
    __radd__ = lambda a, b: a.map(lambda x, y: y + x, b)  # noqa: E731
    __sub__ = lambda a, b: a.map(torch.sub, b)           # noqa: E731
    __rsub__ = lambda a, b: a.map(lambda x, y: y - x, b)  # noqa: E731
    __mul__ = lambda a, b: a.map(torch.mul, b)           # noqa: E731
    __rmul__ = lambda a, b: a.map(lambda x, y: y * x, b)  # noqa: E731
    __truediv__ = lambda a, b: a.map(torch.div, b)       # noqa: E731


def _row(x, i):
    """Row i of a block (axis -2), keeping it as a 1-row slab."""
    return x.narrow(-2, i % x.shape[-2], 1)


def _zero_row(x):
    return torch.zeros_like(_row(x, 0))


def _cat(*parts):
    return torch.cat(parts, dim=-2)


def _dplus_rows(u: Blocks) -> Blocks:
    """Forward difference along the global rows."""
    nxt = u.from_next([_row(x, 0) for x in u])
    out = []
    for i, x in enumerate(u):
        inner = x[..., 1:, :] - x[..., :-1, :]
        last = _zero_row(x) if u.last(i) else nxt[i] - _row(x, -1)
        out.append(_cat(inner, last))
    return Blocks(out, u.n_rows)


def _dplus_T_rows(p: Blocks) -> Blocks:
    """Adjoint of :func:`_dplus_rows` (global ``dplus_T``)."""
    prev = p.from_prev([_row(x, -1) for x in p])
    out = []
    for i, x in enumerate(p):
        pr = _zero_row(x) if p.first(i) else prev[i]
        shifted = _cat(pr, x[..., :-1, :])
        keep = _cat(x[..., :-1, :], _zero_row(x)) if p.last(i) else x
        out.append(shifted - keep)
    return Blocks(out, p.n_rows)


def _dminus_rows(u: Blocks) -> Blocks:
    prev = u.from_prev([_row(x, -1) for x in u])
    out = []
    for i, x in enumerate(u):
        pr = _row(x, 0) if u.first(i) else prev[i]
        out.append(x - _cat(pr, x[..., :-1, :]))
    return Blocks(out, u.n_rows)


def _dminus_T_rows(p: Blocks) -> Blocks:
    nxt = p.from_next([_row(x, 0) for x in p])
    out = []
    for i, x in enumerate(p):
        a = _cat(_zero_row(x), x[..., 1:, :]) if p.first(i) else x
        nx = _zero_row(x) if p.last(i) else nxt[i]
        out.append(a - _cat(x[..., 1:, :], nx))
    return Blocks(out, p.n_rows)


def _edge_mask(x, first: bool, last: bool):
    """Zero the block's first row if it holds the global first row, its
    last if it holds the global last."""
    m = x.shape[-2]
    if first:
        x = _cat(_zero_row(x), x[..., 1:, :])
    if last:
        x = _cat(x[..., :m - 1, :], _zero_row(x))
    return x


def _dcent_rows(u: Blocks) -> Blocks:
    prev = u.from_prev([_row(x, -1) for x in u])
    nxt = u.from_next([_row(x, 0) for x in u])
    out = []
    for i, x in enumerate(u):
        up = _cat(prev[i], x[..., :-1, :])
        down = _cat(x[..., 1:, :], nxt[i])
        out.append(_edge_mask(0.5 * (down - up), u.first(i), u.last(i)))
    return Blocks(out, u.n_rows)


def _dcent_T_rows(p: Blocks) -> Blocks:
    q = Blocks([_edge_mask(x, p.first(i), p.last(i))
                for i, x in enumerate(p)], p.n_rows)
    prev = q.from_prev([_row(x, -1) for x in q])
    nxt = q.from_next([_row(x, 0) for x in q])
    out = []
    for i, x in enumerate(q):
        pr = _zero_row(x) if q.first(i) else prev[i]
        nx = _zero_row(x) if q.last(i) else nxt[i]
        up = _cat(pr, x[..., :-1, :])
        down = _cat(x[..., 1:, :], nx)
        out.append(0.5 * (up - down))
    return Blocks(out, q.n_rows)


_ROW_STENCILS = {
    FwdGradientOp: (_dplus_rows, _dplus_T_rows),
    BwdGradientOp: (_dminus_rows, _dminus_T_rows),
    CenteredGradientOp: (_dcent_rows, _dcent_T_rows),
}
_COL_STENCILS = {
    FwdGradientOp: (dplus, dplus_T),
    BwdGradientOp: (dminus, dminus_T),
    CenteredGradientOp: (dcent, dcent_T),
}


def _col(fn, x: Blocks) -> Blocks:
    return x.map(lambda b: fn(b, -1))


def _grad(op, u: Blocks) -> Blocks:
    """(…, m, N) blocks → (…, 2, m, N) gradient blocks."""
    row_fwd, _ = _ROW_STENCILS[type(op)]
    col_fwd, _ = _COL_STENCILS[type(op)]
    return row_fwd(u).map(lambda r, c: torch.stack([r, c], dim=-3),
                          _col(col_fwd, u))


def _div_adj(op, y: Blocks) -> Blocks:
    _, row_adj = _ROW_STENCILS[type(op)]
    _, col_adj = _COL_STENCILS[type(op)]
    y0 = y.map(lambda b: b[..., 0, :, :])
    y1 = y.map(lambda b: b[..., 1, :, :])
    return row_adj(y0) + _col(col_adj, y1)


# ---------------------------------------------------------------------------
# splitting onto the mesh and gathering back
# ---------------------------------------------------------------------------

def _grid(mesh: Mesh, batch: bool):
    """The mesh's devices as (n_batch, n_rows) rows of a list."""
    d = mesh.devices
    n_rows = mesh.shape[ROWS_AXIS]
    if d.ndim == 1:
        return [list(d)], n_rows
    if batch:
        return [list(r) for r in d], n_rows
    return [list(d[0])], n_rows      # replicated over the batch axis


def _split(x, grid, n_rows: int, row_axis: int, batch: bool) -> Blocks:
    """Cut ``x`` into the grid's blocks (batch axis 0 when ``batch``, rows
    on ``row_axis``), each on its device."""
    parts = x.chunk(len(grid), dim=0) if batch else [x] * len(grid)
    out = []
    for part, row in zip(parts, grid):
        for blk, dev in zip(part.chunk(n_rows, dim=row_axis), row):
            out.append(blk.to(dev))
    return Blocks(out, n_rows)


def _weights(a, grid, n_rows: int):
    """A scalar weight stays a 0-d tensor; an (M, N) map is cut by rows
    (and replicated over the batch shards)."""
    if a.ndim < 2:
        return a
    out = []
    for row in grid:
        for blk, dev in zip(a.chunk(n_rows, dim=-2), row):
            out.append(blk.to(dev))
    return Blocks(out, n_rows)


def _gather(blocks: Blocks, n_batch: int, row_axis: int, batch: bool):
    """Blocks back to one tensor on the first block's device."""
    dev = blocks[0].device
    n = blocks.n_rows
    groups = [torch.cat([b.to(dev) for b in blocks[g * n:(g + 1) * n]],
                        dim=row_axis) for g in range(n_batch)]
    return torch.cat(groups, dim=0) if batch else groups[0]


def _check_mesh_axes(f, mesh: Mesh, row_axis: int, batch: bool):
    """Rows (and, with ``batch``, the batch) must divide by the mesh axes."""
    if batch and f.shape[0] % mesh.shape[BATCH_AXIS]:
        raise ValueError(f"batch {f.shape[0]} not divisible by mesh axis "
                         f"{mesh.shape[BATCH_AXIS]}")
    if f.shape[row_axis] % mesh.shape[ROWS_AXIS]:
        raise ValueError(f"rows {f.shape[row_axis]} not divisible by mesh "
                         f"size {mesh.shape[ROWS_AXIS]}")


def _as_weight(a, f):
    # numbers keep their double precision (numpy's float64)
    a = a if isinstance(a, torch.Tensor) else torch.as_tensor(np.asarray(a))
    return a.to(dtype=f.dtype) if a.ndim < 2 else a.to(dtype=f.dtype,
                                                      device=f.device)


def _tiny(dtype):
    return torch.tensor(torch.finfo(dtype).tiny, dtype=dtype)


# ---------------------------------------------------------------------------
# Row-sharded PDPS (TV, sums of regularizers, α maps)
# ---------------------------------------------------------------------------

def _pdps(f: Blocks, alphas, model: DenoiseModel, accel: bool, gamma,
          maxiter: int, tau0_v, sigma0_v) -> Blocks:
    """The accelerated PDPS iteration on row blocks: every row stencil
    exchanges one boundary row with each neighbour."""
    u = f
    ys = [f.map(lambda b: torch.zeros((2,) + tuple(b.shape), dtype=b.dtype,
                                      device=b.device).movedim(0, -3))
          for _ in range(model.K)]
    tiny = _tiny(f[0].dtype)
    tau, sigma = tau0_v, sigma0_v
    for _ in range(int(maxiter)):
        div = None
        for op, y in zip(model.ops, ys):
            d = _div_adj(op, y)
            div = d if div is None else div + d
        u_new = (u - tau * (div - f)) / (1.0 + tau)
        if accel:
            omega = torch.rsqrt(1.0 + 2.0 * gamma * tau)
            tau, sigma = tau * omega, sigma / omega
        else:
            omega = torch.ones((), dtype=tau.dtype)
        ubar = (1.0 + omega) * u_new - omega * u
        ys_new = []
        for op, y, a in zip(model.ops, ys, alphas):
            q = y + sigma * _grad(op, ubar)

            def project(q, a):
                n = torch.sqrt(q[..., 0, :, :] ** 2 + q[..., 1, :, :] ** 2)
                scale = torch.where(n <= a, 1.0, a / torch.maximum(n, tiny))
                return q * scale.unsqueeze(-3)

            ys_new.append(q.map(project, a))
        u, ys = u_new, ys_new
    return u


def _pdps_steps(f, model, tau0, sigma0):
    L = torch.sqrt(torch.tensor(model.opnorm_sq(), dtype=f.dtype))
    return (torch.tensor(tau0, dtype=f.dtype) / L,
            torch.tensor(sigma0, dtype=f.dtype) / L)


def _run_pdps(f, alphas, model, mesh, batch, tau0, sigma0, gamma, maxiter,
              accel):
    alphas = tuple(_as_weight(a, f) for a in model.canonical_alphas(alphas))
    _check_mesh_axes(f, mesh, -2, batch)
    grid, n_rows = _grid(mesh, batch)
    tau0_v, sigma0_v = _pdps_steps(f, model, tau0, sigma0)
    blocks = _split(f, grid, n_rows, -2, batch)
    u = _pdps(blocks, tuple(_weights(a, grid, n_rows) for a in alphas),
              model, accel, gamma, maxiter, tau0_v, sigma0_v)
    return _gather(u, len(grid), -2, batch)


def denoise_pdps_row_sharded(f, alphas, model: DenoiseModel, mesh: Mesh, *,
                             tau0=5.0, sigma0=0.99 / 5.0, gamma=1.0,
                             maxiter=5000, accel=True):
    """Accelerated PDPS on a single (M, N) image row-sharded over ``mesh``.

    Same fixed point as :func:`..solvers.pdps.denoise_pdps`; each iteration
    exchanges one boundary row with each neighbour per row-stencil
    application.  M must be divisible by the mesh's rows axis."""
    f = torch.as_tensor(f)
    if f.ndim != 2:
        raise ValueError("row-sharded solver expects a single (M, N) image")
    return _run_pdps(f, alphas, model, mesh, False, tau0, sigma0, gamma,
                     maxiter, accel)


def denoise_pdps_batch_row_sharded(f, alphas, model: DenoiseModel,
                                   mesh: Mesh, *, tau0=5.0,
                                   sigma0=0.99 / 5.0, gamma=1.0,
                                   maxiter=5000, accel=True):
    """PDPS on an (O, M, N) stack over a 2-D (batch × rows) mesh: each
    batch shard runs the row-sharded iteration on its sub-stack.  O must
    divide by the batch axis and M by the rows axis."""
    f = torch.as_tensor(f)
    if f.ndim != 3:
        raise ValueError("expected an (O, M, N) stack")
    return _run_pdps(f, alphas, model, mesh, True, tau0, sigma0, gamma,
                     maxiter, accel)


# ---------------------------------------------------------------------------
# Row-sharded TGV²
# ---------------------------------------------------------------------------

_SQRT2 = math.sqrt(2.0)


def _tgv(f: Blocks, a1, a0, maxiter: int, tau_v, sigma_v):
    """Joint-primal TGV² CP on row blocks (planes u, w_r, w_c, p_r, p_c,
    q_rr, q_cc, q_rc, as the fused kernel lays them out); stencils along
    the rows exchange one boundary row, column stencils are local."""
    tiny = _tiny(f[0].dtype)
    a1_sq = a1 * a1
    a0_sq = a0 * a0
    z = 0.0 * f
    u, wr, wc, pr, pc, qrr, qcc, qrc = f, z, z, z, z, z, z, z

    def proj(n2, a, a_sq):
        return n2.map(lambda n, a, a_sq: torch.where(
            n <= a_sq, 1.0, a * torch.rsqrt(n + tiny)), a, a_sq)

    for _ in range(int(maxiter)):
        div_p = _dplus_T_rows(pr) + _col(dplus_T, pc)
        u_new = (u - tau_v * div_p + tau_v * f) / (1.0 + tau_v)
        er = _dminus_T_rows(qrr) + _col(dminus_T, qrc) / _SQRT2
        ec = _col(dminus_T, qcc) + _dminus_T_rows(qrc) / _SQRT2
        wr_new = wr + tau_v * (pr - er)
        wc_new = wc + tau_v * (pc - ec)
        ubar = 2.0 * u_new - u
        wbr = 2.0 * wr_new - wr
        wbc = 2.0 * wc_new - wc
        pr_t = pr + sigma_v * (_dplus_rows(ubar) - wbr)
        pc_t = pc + sigma_v * (_col(dplus, ubar) - wbc)
        s = proj(pr_t * pr_t + pc_t * pc_t, a1, a1_sq)
        err = _dminus_rows(wbr)
        ecc = _col(dminus, wbc)
        erc = (_col(dminus, wbr) + _dminus_rows(wbc)) / _SQRT2
        qrr_t = qrr + sigma_v * err
        qcc_t = qcc + sigma_v * ecc
        qrc_t = qrc + sigma_v * erc
        sq = proj(qrr_t * qrr_t + qcc_t * qcc_t + qrc_t * qrc_t, a0, a0_sq)
        u, wr, wc = u_new, wr_new, wc_new
        pr, pc = pr_t * s, pc_t * s
        qrr, qcc, qrc = qrr_t * sq, qcc_t * sq, qrc_t * sq
    return u, wr, wc


def _run_tgv(f, alpha1, alpha0, mesh, batch, tau0, sigma0, maxiter):
    from ..ops.tgv import TGV_OPNORM_SQ
    a1, a0 = _as_weight(alpha1, f), _as_weight(alpha0, f)
    _check_mesh_axes(f, mesh, -2, batch)
    grid, n_rows = _grid(mesh, batch)
    L = torch.sqrt(torch.tensor(TGV_OPNORM_SQ, dtype=f.dtype))
    tau_v = torch.tensor(tau0, dtype=f.dtype) / L
    sigma_v = torch.tensor(sigma0, dtype=f.dtype) / L
    u, wr, wc = _tgv(_split(f, grid, n_rows, -2, batch),
                     _weights(a1, grid, n_rows), _weights(a0, grid, n_rows),
                     maxiter, tau_v, sigma_v)
    w = wr.map(lambda r, c: torch.stack([r, c], dim=-3), wc)
    return (_gather(u, len(grid), -2, batch),
            _gather(w, len(grid), -2, batch))


def tgv_denoise_pdps_row_sharded(f, alpha1, alpha0, mesh: Mesh, *,
                                 tau0=0.99, sigma0=0.99, maxiter=5000):
    """Joint-primal TGV² Chambolle–Pock on a single (M, N) image
    row-sharded over ``mesh`` (the spatial-decomposition analogue of
    :func:`..solvers.tgv.tgv_denoise_pdps`; each iteration six exchanges:
    ∇ᵀp, Eᵀq ×2, ∇ū, E w̄ ×2).  ``alpha1``/``alpha0`` are scalars or
    (M, N) maps.  Returns ``(u, w)`` like the single-device solver."""
    f = torch.as_tensor(f)
    if f.ndim != 2:
        raise ValueError("row-sharded solver expects a single (M, N) image")
    return _run_tgv(f, alpha1, alpha0, mesh, False, tau0, sigma0, maxiter)


def tgv_denoise_pdps_batch_row_sharded(f, alpha1, alpha0, mesh: Mesh, *,
                                       tau0=0.99, sigma0=0.99,
                                       maxiter=5000):
    """TGV² on an (O, M, N) stack over a 2-D (batch × rows) mesh; returns
    ``(u, w)`` with w (O, 2, M, N)."""
    f = torch.as_tensor(f)
    if f.ndim != 3:
        raise ValueError("expected an (O, M, N) stack")
    return _run_tgv(f, alpha1, alpha0, mesh, True, tau0, sigma0, maxiter)


# ---------------------------------------------------------------------------
# Row-sharded vectorial (color) TV
# ---------------------------------------------------------------------------

def _vtv(f: Blocks, a, maxiter: int, tau_v, sigma_v) -> Blocks:
    """Channel-coupled CP on (…, C, m, N) blocks: the channel axis is
    local (the Frobenius coupling is per pixel), one exchange carries all
    C boundary rows.  Accelerated, γ = 1 data term."""
    tiny = _tiny(f[0].dtype)
    u = f
    px = 0.0 * f
    py = 0.0 * f
    tau, sigma = tau_v, sigma_v
    for _ in range(int(maxiter)):
        div = _dplus_T_rows(px) + _col(dplus_T, py)
        u_new = (u - tau * (div - f)) / (1.0 + tau)
        omega = torch.rsqrt(1.0 + 2.0 * tau)
        tau, sigma = tau * omega, sigma / omega
        ubar = (1.0 + omega) * u_new - omega * u
        qx = px + sigma * _dplus_rows(ubar)
        qy = py + sigma * _col(dplus, ubar)

        def scale_of(qx, qy, a):
            n = torch.sqrt(torch.sum(qx * qx + qy * qy, dim=-3,
                                     keepdim=True))
            return torch.where(n <= a, 1.0, a / torch.maximum(n, tiny))

        scale = qx.map(scale_of, qy, a)
        u, px, py = u_new, qx * scale, qy * scale
    return u


def _run_vtv(f, alpha, mesh, batch, tau0, sigma0, maxiter):
    from ..models import vtv_model
    a = _as_weight(alpha, f)
    _check_mesh_axes(f, mesh, -2, batch)
    grid, n_rows = _grid(mesh, batch)
    L = torch.sqrt(torch.tensor(vtv_model().opnorm_sq(), dtype=f.dtype))
    tau_v = torch.tensor(tau0, dtype=f.dtype) / L
    sigma_v = torch.tensor(sigma0, dtype=f.dtype) / L
    u = _vtv(_split(f, grid, n_rows, -2, batch), _weights(a, grid, n_rows),
             maxiter, tau_v, sigma_v)
    return _gather(u, len(grid), -2, batch)


def vtv_denoise_pdps_row_sharded(f, alpha, mesh: Mesh, *, tau0=5.0,
                                 sigma0=0.99 / 5.0, maxiter=5000):
    """Channel-coupled vectorial-TV PDPS on a single (C, M, N) color image
    row-sharded over ``mesh`` (the analogue of
    :func:`..solvers.pdps.vtv_denoise`).  ``alpha`` is a scalar or an
    (M, N) map shared by the channels.  M must divide by the mesh size."""
    f = torch.as_tensor(f)
    if f.ndim != 3:
        raise ValueError(
            "row-sharded VTV expects a single (C, M, N) color image")
    return _run_vtv(f, alpha, mesh, False, tau0, sigma0, maxiter)


def vtv_denoise_pdps_batch_row_sharded(f, alpha, mesh: Mesh, *, tau0=5.0,
                                       sigma0=0.99 / 5.0, maxiter=5000):
    """Vectorial TV on an (O, C, M, N) color stack over a 2-D
    (batch × rows) mesh (channels local)."""
    f = torch.as_tensor(f)
    if f.ndim != 4:
        raise ValueError("expected an (O, C, M, N) color stack")
    return _run_vtv(f, alpha, mesh, True, tau0, sigma0, maxiter)


# ---------------------------------------------------------------------------
# Row-sharded TV-L1
# ---------------------------------------------------------------------------

def _tvl1(f: Blocks, a, maxiter: int, tau_v, sigma_v) -> Blocks:
    """Unaccelerated TV-L1 CP with the shift-centred soft-shrinkage primal
    prox (:func:`..solvers.tvl1.tvl1_denoise`'s numerics) on row blocks."""
    tiny = _tiny(f[0].dtype)
    u = f
    yx = 0.0 * f
    yy = 0.0 * f
    for _ in range(int(maxiter)):
        div = _dplus_T_rows(yx) + _col(dplus_T, yy)
        v = u - tau_v * div - f
        u_new = f + v.map(lambda v: torch.sign(v) * torch.clamp(
            torch.abs(v) - tau_v, min=0.0))
        ubar = 2.0 * u_new - u
        qx = yx + sigma_v * _dplus_rows(ubar)
        qy = yy + sigma_v * _col(dplus, ubar)

        def scale_of(qx, qy, a):
            n = torch.sqrt(qx * qx + qy * qy)
            return torch.where(n <= a, 1.0, a / torch.maximum(n, tiny))

        scale = qx.map(scale_of, qy, a)
        u, yx, yy = u_new, qx * scale, qy * scale
    return u


def _run_tvl1(f, alpha, mesh, batch, tau0, sigma0, maxiter):
    from ..models import tv_model
    a = _as_weight(alpha, f)
    _check_mesh_axes(f, mesh, -2, batch)
    grid, n_rows = _grid(mesh, batch)
    L = torch.sqrt(torch.tensor(tv_model().opnorm_sq(), dtype=f.dtype))
    tau_v = torch.tensor(tau0, dtype=f.dtype) / L
    sigma_v = torch.tensor(sigma0, dtype=f.dtype) / L
    u = _tvl1(_split(f, grid, n_rows, -2, batch), _weights(a, grid, n_rows),
              maxiter, tau_v, sigma_v)
    return _gather(u, len(grid), -2, batch)


def tvl1_denoise_row_sharded(f, alpha, mesh: Mesh, *, tau0=0.99,
                             sigma0=0.99, maxiter=5000):
    """TV-L1 denoising of a single (M, N) image row-sharded over ``mesh``
    (the analogue of :func:`..solvers.tvl1.tvl1_denoise`; two exchanges an
    iteration, ∇ᵀy and ∇ū).  ``alpha`` is a scalar or an (M, N) map."""
    f = torch.as_tensor(f)
    if f.ndim != 2:
        raise ValueError("row-sharded solver expects a single (M, N) image")
    return _run_tvl1(f, alpha, mesh, False, tau0, sigma0, maxiter)


def tvl1_denoise_batch_row_sharded(f, alpha, mesh: Mesh, *, tau0=0.99,
                                   sigma0=0.99, maxiter=5000):
    """TV-L1 on an (O, M, N) stack over a 2-D (batch × rows) mesh."""
    f = torch.as_tensor(f)
    if f.ndim != 3:
        raise ValueError("expected an (O, M, N) stack")
    return _run_tvl1(f, alpha, mesh, True, tau0, sigma0, maxiter)
