"""The TGV² CP solve's tile form (``csrc/tgv_tile.cu``) on the CPU: its plan
and its schedule.

- ``solvers/cluster_plan.py::tgv_tile_plan``: the tiles cover each image
  once, the halo is H = TGV_TILE_REACH·T = T, the eleven padded planes fit
  the shared memory of TGV_TILE_CTAS CTAs an SM, TMA's 16-byte rules hold
  where it is asked for, the grid is at most one wave; it raises where
  nothing fits.  ``tgv_plan`` (which the single-loop TGV² learner also
  reads) is unchanged.
- A plain-PyTorch model of the tile schedule (:func:`tile_schedule`): per
  launch, each tile's window (owned pixels and an H-pixel halo, cut at the
  image edge) is run for T plain iterations (``solvers/tgv.py::_step``) on
  the whole image with every pixel of u, w, p and q outside it set to NaN,
  so the image-edge masks are the global ones and anything that reaches an
  owned pixel from outside the tile shows; the owned pixels are stitched.
  In float64 it equals the plain solver ``_tgv_impl`` bit for bit (u, w,
  p, q, early-stop iteration counts), cold and warm, scalar and map
  weights, and with the halo one pixel short it does not: H = T is the
  iteration's own reach.
- Against the JAX package: the row-tiled Pallas kernel
  ``tgv_pallas._tiled_impl`` in interpret mode on the same numpy inputs,
  at 1e-12 relative, with a fixed budget (JAX's early stop is a masked norm
  over its tiles, the port's the plain batch-global norm).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bpldenoising_tpu.solvers.tgv_pallas import _tiled_impl
from bpldenoising_tpu_torch.solvers import cluster_plan
from bpldenoising_tpu_torch.solvers.cluster_plan import (
    SMEM_PER_BLOCK, TGV_TILE_CTAS, tgv_plan, tgv_tile_geometry,
    tgv_tile_plan)
from bpldenoising_tpu_torch.solvers.tgv import (_step, _tgv_impl,
                                                cold_state, relative_change,
                                                step_sizes)

KW = dict(tau0=0.99, sigma0=0.99)


# ---- the plan

PLAN_SHAPES = [
    # M, N, itemsize, n_maps, images
    (1024, 1024, 4, 0, 1),      # row 5
    (1024, 1024, 4, 2, 1),
    (240, 240, 4, 0, 1),        # where the tile form takes over, float32
    (256, 256, 4, 0, 10),       # the TGV² learn's shapes at 256²
    (256, 256, 4, 0, 2),
    (512, 512, 4, 2, 4),
    (512, 512, 8, 0, 1),
    (160, 160, 8, 0, 1),        # where it takes over, float64
    (256, 256, 8, 1, 3),
    (37, 53, 8, 0, 1),          # rows not of 16 bytes: no TMA
    (40, 48, 4, 0, 2),
    (1001, 777, 4, 1, 3),
    (16, 2500, 4, 0, 1),
    (300, 4096, 8, 2, 1),
    (4096, 300, 4, 0, 1),
    (2048, 2048, 4, 2, 1),
]


@pytest.mark.parametrize("M,N,itemsize,n_maps,images", PLAN_SHAPES)
def test_tile_plan_rules(M, N, itemsize, n_maps, images):
    """The tiles cover the image once; H = T; the padded tile is the owned
    one with its halo, its rows a multiple of 16 bytes; its eleven planes
    fit the shared memory of TGV_TILE_CTAS CTAs an SM; TMA's box rules
    hold where TMA is planned; the grid is every tile of the batch, at
    most one wave of CTAs that walk them."""
    p = tgv_tile_plan(M, N, itemsize, n_maps, images)
    assert cluster_plan.TGV_TILE_REACH == 1
    assert p.H == p.T and 1 <= p.T <= cluster_plan.TILE_T_MAX
    assert p.tiles_m * p.rows >= M > (p.tiles_m - 1) * p.rows
    assert p.tiles_n * p.cols >= N > (p.tiles_n - 1) * p.cols
    assert p.height == p.rows + 2 * p.H
    a = 16 // itemsize
    assert p.pitch >= p.cols + 2 * p.H + a - 1 and p.pitch % a == 0
    assert p.cols % a == 0
    assert p.planes == cluster_plan.TGV_PLANES == 11
    plane = -(-p.height * p.pitch * itemsize // 128) * 128
    assert p.smem == 128 + 11 * plane
    ctas = TGV_TILE_CTAS[itemsize]
    assert p.smem <= SMEM_PER_BLOCK // ctas <= 232448
    assert p.grid == min(images * p.tiles_m * p.tiles_n,
                         ctas * cluster_plan.SMS)
    assert p.tma == ((N * itemsize) % 16 == 0 and p.pitch <= N
                     and p.height <= M)
    if p.tma:
        assert (p.pitch * itemsize) % 16 == 0 and (p.cols * itemsize) % 16 \
            == 0 and (N * itemsize) % 16 == 0
    assert max(p.height, p.pitch, p.rows, p.cols) <= 256


def test_tile_plan_given_T_and_refusals(monkeypatch):
    """tgv_tile_geometry keeps a given T (H follows it, twice it for the
    uniform shrink); bad shapes, dtypes and map counts are refused, and so
    is a shape where no tile fits the shared memory."""
    p = tgv_tile_geometry(1024, 1024, 4, 6, 40, 36)
    assert (p.T, p.H, p.height, p.planes) == (6, 6, p.rows + 12, 11)
    p = tgv_tile_geometry(1024, 1024, 4, 3, 40, 36, reach=2)
    assert (p.T, p.H, p.height) == (3, 6, p.rows + 12)
    for bad in ((0, 16, 4, 0), (16, 16, 2, 0), (16, 16, 4, 3),
                (16, 16, 4, -1)):
        with pytest.raises(ValueError):
            tgv_tile_plan(*bad)
    with pytest.raises(ValueError):
        tgv_tile_plan(16, 16, 4, 0, 0)
    monkeypatch.setattr(cluster_plan, "SMEM_PER_BLOCK", 2048)
    tgv_tile_plan.cache_clear()
    try:
        with pytest.raises(ValueError, match="no TGV² tile fits"):
            tgv_tile_plan(512, 512, 4, 0, 1)
    finally:
        monkeypatch.undo()
        tgv_tile_plan.cache_clear()


# tgv_plan's outputs, as the parent tree computes them: the shapes of
# test_torch_tgv_cluster.py, the learner's and where the tile form takes
# over
TGV_PLAN_BEFORE = [
    ((128, 128, 4), (16, 8, 11, 88064, True)),
    ((128, 128, 8), (16, 8, 11, 176128, True)),
    ((1024, 1024, 4), (16, 64, 11, 0, False)),
    ((32, 32, 8), (16, 2, 11, 27136, True)),
    ((50, 37, 4), (16, 4, 11, 18944, True)),
    ((40, 36, 8), (16, 3, 11, 33696, True)),
    ((8, 8, 8), (4, 2, 11, 6784, True)),
    ((5, 7, 8), (2, 3, 11, 6552, True)),
    ((3, 9, 4), (1, 3, 11, 4212, True)),
    ((256, 256, 4), (16, 16, 11, 0, False)),
    ((256, 256, 8), (16, 16, 11, 0, False)),
    ((224, 224, 4), (16, 14, 11, 213248, True)),
    ((240, 240, 4), (16, 15, 11, 0, False)),
    ((160, 160, 8), (16, 10, 11, 0, False)),
    ((512, 512, 4), (16, 32, 11, 0, False)),
]


@pytest.mark.parametrize("args,want", TGV_PLAN_BEFORE,
                         ids=lambda v: "x".join(map(str, v))
                         if isinstance(v, tuple) and len(v) == 3 else None)
def test_tgv_plan_unchanged(args, want):
    """The band plan, which the cluster form and the single-loop TGV²
    learner read, is the parent's; it decides where the tile form runs."""
    assert tuple(tgv_plan(*args)) == want


@pytest.mark.parametrize("itemsize,limit", [(4, 240), (8, 160)])
def test_tile_form_takes_over_where_bands_do_not_fit(itemsize, limit):
    """The tile form runs from these square sizes up (tgv_plan's bands no
    longer fit), and the cluster form below them."""
    assert tgv_plan(limit - 16, limit - 16, itemsize).resident
    assert not tgv_plan(limit, limit, itemsize).resident


# ---- the plain model of the tile schedule

def _tile_launch(f, a1, a0, tau, sigma, state, plan, n, halo):
    """n plain iterations of every tile from ``state``: each on the whole
    image with NaN in u, w, p, q outside the tile's window (``halo``
    pixels beyond its owned ones, cut at the image edge); the owned pixels
    stitched."""
    M, N = f.shape[-2:]
    out = [torch.full_like(x, math.nan) for x in state]
    for tr in range(plan.tiles_m):
        for tc in range(plan.tiles_n):
            r0, c0 = tr * plan.rows, tc * plan.cols
            rs = slice(max(r0 - halo, 0), min(r0 + plan.rows + halo, M))
            cs = slice(max(c0 - halo, 0), min(c0 + plan.cols + halo, N))
            st = []
            for x in state:
                t = torch.full_like(x, math.nan)
                t[..., rs, cs] = x[..., rs, cs]
                st.append(t)
            st = tuple(st)
            for _ in range(n):
                st = _step(f, a1, a0, tau, sigma, st)
            own = (Ellipsis, slice(r0, r0 + plan.rows),
                   slice(c0, c0 + plan.cols))
            for o, x in zip(out, st):
                o[own] = x[own]
    return tuple(out)


def tile_schedule(f, a1, a0, state0, *, plan, maxiter, tol, check_every,
                  halo=None):
    """The tile form as a plain schedule: per early-stop chunk of
    ``check_every`` iterations (all ``maxiter`` without ``tol``) launches
    of ``plan.T`` iterations (the last shorter), then the batch-global
    change against the chunk's first iterate, as ``_tgv_impl`` takes it.
    Returns ``(state, iters)``."""
    halo = plan.H if halo is None else halo
    dtype = f.dtype
    tau, sigma = step_sizes(KW["tau0"], KW["sigma0"], dtype)
    a1 = torch.as_tensor(a1, dtype=dtype)
    a0 = torch.as_tensor(a0, dtype=dtype)
    state = tuple(state0) if state0 is not None else cold_state(f)

    def chunk(state, n):
        while n > 0:
            m = min(plan.T, n)
            state = _tile_launch(f, a1, a0, tau, sigma, state, plan, m, halo)
            n -= m
        return state

    if tol is None:
        return chunk(state, maxiter), maxiter
    tol_t = torch.tensor(tol, dtype=dtype)
    iters, rel = 0, torch.tensor(math.inf, dtype=dtype)
    while iters < maxiter and bool(rel > tol_t):
        u_prev = state[0]
        n = min(check_every, maxiter - iters)
        state = chunk(state, n)
        rel = relative_change(state[0], u_prev)
        iters += n
    return state, iters


def _case(O, M, N, seed=0):
    """f (O, M, N): a ramp with a step and a disc under Gaussian noise, and
    (M, N) maps for α₁ and α₀, made with numpy from a seed."""
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.arange(M), np.arange(N), indexing="ij")
    clean = np.stack([0.02 * xx + (yy > M // 2 + b)
                      + ((xx - N / 2) ** 2 + (yy - M / 3) ** 2
                         < (min(M, N) / 4) ** 2)
                      for b in range(O)]).astype(np.float64)
    f = clean + 0.1 * rng.standard_normal(clean.shape)
    return (torch.from_numpy(f),
            torch.from_numpy(0.05 + 0.1 * rng.random((M, N))),
            torch.from_numpy(0.1 + 0.1 * rng.random((M, N))))


def _same(a, b):
    (sa, ia), (sb, ib) = a, b
    return ia == ib and all(torch.equal(x, y) for x, y in zip(sa, sb))


SCHEDULES = [
    # (O, M, N), weights, T, owned tile, maxiter, tol, check_every, warm
    ((2, 26, 22), "scalar", 3, (9, 8), 17, None, 10, False),
    ((1, 24, 28), "map", 4, (10, 12), 13, None, 10, False),
    ((1, 22, 20), "mixed", 2, (8, 8), 9, None, 10, False),
    ((2, 24, 22), "scalar", 3, (10, 8), 60, 1e-3, 7, False),   # tol
    ((1, 20, 22), "map", 4, (8, 10), 40, 1e-3, 10, True),      # warm
    ((1, 23, 29), "scalar", 5, (10, 12), 16, None, 10, False),  # ragged
    ((1, 18, 20), "map", 1, (6, 7), 6, None, 10, False),        # T = 1
]


def _weights(kind, a1map, a0map):
    if kind == "scalar":
        return 0.1, 0.15
    if kind == "map":
        return a1map, a0map
    return a1map, 0.15


@pytest.mark.parametrize(
    "shape,weight,T,owned,maxiter,tol,check,warm", SCHEDULES,
    ids=[f"{'x'.join(map(str, s[0]))}-{s[1]}-T{s[2]}"
         f"{'-tol' if s[5] else ''}{'-warm' if s[7] else ''}"
         for s in SCHEDULES])
def test_tile_schedule_is_the_plain_solver(shape, weight, T, owned, maxiter,
                                           tol, check, warm):
    """The tile schedule with H = T gives the plain solver's u, w, p, q and
    iteration counts bit for bit in float64; with the halo one pixel short
    an owned pixel is reached from outside its tile and it differs."""
    O, M, N = shape
    f, a1map, a0map = _case(O, M, N)
    a = _weights(weight, a1map, a0map)
    plan = tgv_tile_geometry(M, N, 8, T, *owned, images=O)
    assert plan.tiles_m > 1 and plan.tiles_n > 1 and plan.H == T
    state = None
    if warm:
        _, _, state, _ = _tgv_impl(f, *a, None, maxiter=15, tol=None,
                                   check_every=10, return_state=True, **KW)
        a = tuple(1.05 * x for x in a)
    kw = dict(maxiter=maxiter, tol=tol, check_every=check)
    _, _, want, it = _tgv_impl(f, *a, state, return_state=True, **KW, **kw)
    got = tile_schedule(f, *a, state, plan=plan, **kw)
    assert _same(got, (want, it))
    short = tile_schedule(f, *a, state, plan=plan, halo=plan.H - 1, **kw)
    assert not _same(short, (want, it))


def test_tile_schedule_at_the_plans_own_tiles():
    """The plan's own tiles for a ragged 1×37×53 float64 image (no TMA:
    its rows are not of 16 bytes) and for 2×48×64 with maps."""
    for shape, weight in (((1, 37, 53), "scalar"), ((2, 48, 64), "map")):
        O, M, N = shape
        f, a1map, a0map = _case(O, M, N, seed=3)
        a = _weights(weight, a1map, a0map)
        plan = tgv_tile_plan(M, N, 8, 2 if weight == "map" else 0, O)
        assert plan.tiles_m * plan.tiles_n > 1
        kw = dict(maxiter=2 * plan.T + 3, tol=None, check_every=10)
        _, _, want, it = _tgv_impl(f, *a, None, return_state=True, **KW,
                                   **kw)
        assert _same(tile_schedule(f, *a, None, plan=plan, **kw), (want, it))


# ---- against the JAX package's row-tiled Pallas kernel

@pytest.mark.parametrize("weight", ["scalar", "map"])
def test_port_against_jax_tiled_kernel(weight):
    """1×48×40, tile_rows 16, T = 3, a fixed budget of 12 iterations: the
    port's plain solver and its tile schedule (2-D tiles of the port's own
    kind, T the same) against ``_tiled_impl`` in interpret mode at 1e-12
    relative, u, w, p and q."""
    f, a1map, a0map = _case(1, 48, 40, seed=7)
    a = _weights(weight, a1map, a0map)
    ju, jw, jstate = _tiled_impl(
        jnp.asarray(f.numpy()), *(jnp.asarray(np.asarray(x)) for x in a),
        maxiter=12, tol=None, check_every=10, tile_rows=16, chunk_iters=3,
        return_state=True, interpret=True, **KW)
    kw = dict(maxiter=12, tol=None, check_every=10)
    _, _, plain, it = _tgv_impl(f, *a, None, return_state=True, **KW, **kw)
    plan = tgv_tile_geometry(48, 40, 8, 3, 16, 16)
    tiled, tit = tile_schedule(f, *a, None, plan=plan, **kw)
    assert it == tit == 12
    for state in (plain, tiled):
        for x, j in zip(state, jstate):
            j = np.asarray(j)
            assert np.abs(x.numpy() - j).max() <= 1e-12 * np.abs(j).max()
