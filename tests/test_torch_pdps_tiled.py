"""Kernel A's tile form (``csrc/pd_tile.cuh``) on the CPU: its plan and its
schedule.

- ``solvers/cluster_plan.py::pd_tile_plan``: the tiles cover each image
  once, the halo is H = reach·T, the padded planes fit the 227 KB a CTA may
  have, TMA's rules hold where it is asked for; ``pd_plan`` (which the
  single-loop learner and the TV-L1 kernels also read) is unchanged.
- A plain-PyTorch model of the tile schedule (:func:`tile_schedule`): per
  launch, each tile's padded region (owned pixels and an H-pixel halo, cut
  at the image edge) is run for T plain iterations on the whole image with
  every pixel outside it set to NaN, so the image-edge masks are the global
  ones and anything that reaches an owned pixel from outside the tile shows;
  the owned pixels are stitched.  In float64 it equals the plain solver
  ``_denoise_pdps_impl`` bit for bit (iterates, duals, early-stop counts),
  and with a halo one pixel short it does not.
- Against the JAX package: the row-tiled Pallas kernel
  ``pdps_pallas._tiled_impl`` in interpret mode on the same numpy inputs,
  at 1e-12 relative, with a fixed budget (JAX's early stop is one norm over
  the chunk, the port's per image).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bpldenoising_tpu.models import sumregs_model as j_sumregs
from bpldenoising_tpu.models import tv_model as j_tv
from bpldenoising_tpu.solvers.pdps_pallas import _tiled_impl
from bpldenoising_tpu_torch.models import DenoiseModel, sumregs_model, \
    tv_model
from bpldenoising_tpu_torch.ops import BwdGradientOp, CenteredGradientOp
from bpldenoising_tpu_torch.solvers import cluster_plan
from bpldenoising_tpu_torch.solvers.cluster_plan import (
    SMEM_PER_BLOCK, pd_plan, pd_tile_plan, stencil_reach, tile_geometry)
from bpldenoising_tpu_torch.solvers.pdps import (_denoise_pdps_impl,
                                                 _pdps_step, relative_change,
                                                 step_sizes)
from bpldenoising_tpu_torch.solvers.pdps_cuda import STENCIL

PD = dict(tau0=5.0, sigma0=0.99 / 5.0, gamma=1.0, accel=True)


# ---- the plan

PLAN_SHAPES = [
    # M, N, K, itemsize, n_maps, centred, images
    (2048, 2048, 1, 4, 0, False, 1),    # row 3
    (2048, 2048, 3, 4, 0, True, 1),
    (2048, 2048, 3, 4, 3, True, 1),
    (1024, 1024, 1, 4, 0, False, 1),    # the JAX bench's resident point
    (512, 512, 1, 4, 1, False, 4),
    (256, 256, 3, 4, 0, True, 1),
    (1024, 1024, 3, 8, 0, True, 1),
    (320, 320, 1, 4, 0, False, 10),
    (224, 224, 1, 8, 0, False, 1),
    (37, 53, 1, 8, 0, False, 1),        # rows not of 16 bytes: no TMA
    (40, 48, 3, 4, 0, True, 2),         # the window wider than the image
    (1001, 777, 2, 4, 1, True, 3),
    (16, 2500, 1, 4, 0, False, 1),
    (2048, 2048, 3, 8, 3, True, 1),
    (768, 1280, 1, 4, 1, False, 2),
    (300, 4096, 3, 4, 0, True, 1),
    (4096, 300, 1, 8, 0, False, 1),
]


@pytest.mark.parametrize("M,N,K,itemsize,n_maps,centred,images",
                         PLAN_SHAPES)
def test_tile_plan_rules(M, N, K, itemsize, n_maps, centred, images):
    """The tiles cover the image once; H = reach·T; the padded tile is the
    owned one with its halo, its rows a multiple of 16 bytes; its planes
    (u, ū and the 2K duals) fit the shared memory of TILE_CTAS_PER_SM CTAs
    an SM; TMA's box rules hold where TMA is planned; the grid is every
    tile of the batch."""
    p = pd_tile_plan(M, N, K, itemsize, n_maps, centred, images=images)
    reach = 2 if centred else 1
    assert p.H == reach * p.T and 1 <= p.T <= cluster_plan.TILE_T_MAX
    assert p.tiles_m * p.rows >= M > (p.tiles_m - 1) * p.rows
    assert p.tiles_n * p.cols >= N > (p.tiles_n - 1) * p.cols
    assert p.height == p.rows + 2 * p.H
    a = 16 // itemsize
    assert p.pitch >= p.cols + 2 * p.H + a - 1 and p.pitch % a == 0
    assert p.cols % a == 0
    assert p.planes == 2 + 2 * K
    plane = -(-p.height * p.pitch * itemsize // 128) * 128
    assert p.smem == 128 + p.planes * plane
    assert p.smem <= SMEM_PER_BLOCK // cluster_plan.TILE_CTAS_PER_SM \
        <= 232448
    assert p.grid == images * p.tiles_m * p.tiles_n
    assert p.tma == ((N * itemsize) % 16 == 0 and p.pitch <= N
                     and p.height <= M)
    assert max(p.height, p.pitch, p.rows, p.cols) <= 256


def test_tile_plan_given_T_and_refusal():
    """tile_geometry keeps a given T (H follows it) and the plan's rules;
    a bad shape is refused before any launch."""
    p = tile_geometry(2048, 2048, 1, 4, 1, 12, 60, 64)
    assert (p.T, p.H, p.height) == (12, 12, p.rows + 24)
    p = tile_geometry(2048, 2048, 3, 4, 2, 5, 40, 48)
    assert (p.T, p.H, p.height) == (5, 10, p.rows + 20)
    for bad in ((0, 16, 1, 4, 0, False), (16, 16, 0, 4, 0, False),
                (16, 16, 1, 4, 2, False)):
        with pytest.raises(ValueError):
            pd_tile_plan(*bad)


@pytest.mark.parametrize("kinds,reach", [
    ((0,), 1), ((1,), 1), ((0, 0), 1), ((2,), 2), ((0, 1), 2),
    ((0, 1, 2), 2), ((2, 1), 2)])
def test_stencil_reach(kinds, reach):
    """Forward-only or backward-only blocks reach one pixel an iteration
    (primal i − 1 and dual i + 1, or the mirror); a centred block, or
    forward and backward together, two."""
    assert stencil_reach(kinds) == reach


# pd_plan's outputs for test_torch_pdps_cluster.py::test_kernel_a_plan's and
# test_torch_first_order.py::test_pd_plan's shapes, as the parent tree
# computes them
PD_PLAN_BEFORE = [
    ((128, 128, 1, 4), (8, 16, 4, 49152, True)),
    ((128, 128, 3, 4), (8, 16, 8, 106496, True)),
    ((128, 128, 3, 8), (8, 16, 8, 212992, True)),
    ((20, 24, 3, 8), (8, 3, 8, 19968, True)),
    ((16, 20, 3, 4), (8, 2, 8, 7680, True)),
    ((16, 20, 3, 8), (8, 2, 8, 15360, True)),
    ((8, 8, 1, 8), (4, 2, 4, 2560, True)),
    ((5, 7, 3, 8), (2, 3, 8, 5824, True)),
    ((3, 9, 1, 4), (1, 3, 4, 1584, True)),
    ((2048, 2048, 1, 4), (8, 256, 4, 0, False)),
    ((2048, 2048, 3, 4), (8, 256, 8, 0, False)),
    ((20, 16, 1, 4), (8, 3, 4, 2816, True)),
    ((22, 24, 3, 8), (8, 3, 8, 19968, True)),
    ((13, 24, 1, 4), (4, 4, 4, 4608, True)),
    ((5, 7, 1, 8), (2, 3, 4, 2464, True)),
    ((1, 9, 1, 4), (1, 1, 4, 1296, True)),
    ((512, 512, 1, 4), (8, 64, 4, 0, False)),
    ((128, 128, 8, 8), (8, 16, 18, 0, False)),
    ((256, 256, 1, 4), (8, 32, 4, 163840, True)),
    ((256, 256, 3, 8), (8, 32, 8, 0, False)),
]


@pytest.mark.parametrize("args,want", PD_PLAN_BEFORE,
                         ids=lambda v: "x".join(map(str, v))
                         if isinstance(v, tuple) and len(v) == 4 else None)
def test_pd_plan_unchanged(args, want):
    """The band plan, which kernel A's cluster form, the single-loop
    learner and the TV-L1 kernels read, is the parent's."""
    p = pd_plan(*args)
    assert (p.cluster, p.rows, p.planes, p.smem, p.resident) == want


@pytest.mark.parametrize("K,itemsize,limit", [
    (1, 4, 320), (3, 4, 208), (1, 8, 224), (3, 8, 144)])
def test_tile_form_takes_over_where_bands_do_not_fit(K, itemsize, limit):
    """The tile form runs from these square sizes up (pd_plan's bands no
    longer fit), and the cluster form below them."""
    assert pd_plan(limit - 16, limit - 16, K, itemsize).resident
    assert not pd_plan(limit, limit, K, itemsize).resident


# ---- the plain model of the tile schedule

def _tile_launch(model, f, alphas, state, plan, n, halo):
    """n plain iterations of every tile from ``state``: each on the whole
    image with NaN outside the tile's padded region (``halo`` pixels beyond
    its owned ones, cut at the image edge); the owned pixels stitched."""
    u, ys, tau, sigma = state
    M, N = u.shape[-2:]
    out_u = torch.full_like(u, math.nan)
    out_ys = [torch.full_like(y, math.nan) for y in ys]
    end = None
    for tr in range(plan.tiles_m):
        for tc in range(plan.tiles_n):
            r0, c0 = tr * plan.rows, tc * plan.cols
            rs = slice(max(r0 - halo, 0), min(r0 + plan.rows + halo, M))
            cs = slice(max(c0 - halo, 0), min(c0 + plan.cols + halo, N))
            tu = torch.full_like(u, math.nan)
            tu[..., rs, cs] = u[..., rs, cs]
            tys = []
            for y in ys:
                t = torch.full_like(y, math.nan)
                t[..., rs, cs] = y[..., rs, cs]
                tys.append(t)
            st = (tu, tuple(tys), tau, sigma)
            for _ in range(n):
                st = _pdps_step(model, f, alphas, True, 1.0, st)
            own = (Ellipsis, slice(r0, r0 + plan.rows),
                   slice(c0, c0 + plan.cols))
            out_u[own] = st[0][own]
            for o, y in zip(out_ys, st[1]):
                o[own] = y[own]
            end = st
    return out_u, tuple(out_ys), end[2], end[3]


def tile_schedule(f, alphas, state0, *, model, plan, maxiter, tol,
                  check_every, halo=None):
    """Kernel A's tile form as a plain schedule: per early-stop chunk of
    ``check_every`` iterations (all ``maxiter`` without ``tol``) launches
    of ``plan.T`` iterations (the last shorter), then the per-image change
    against the chunk's first iterate.  Returns ``(u, ys, iters)``."""
    halo = plan.H if halo is None else halo
    tau, sigma = step_sizes(model, PD["tau0"], PD["sigma0"], f.dtype,
                            f.device)
    if state0 is None:
        state0 = (f, tuple(torch.zeros(f.shape[:-2] + (2,) + f.shape[-2:],
                                       dtype=f.dtype)
                           for _ in range(model.K)))
    state = (state0[0], tuple(state0[1]), tau, sigma)

    def chunk(state, n):
        while n > 0:
            m = min(plan.T, n)
            state = _tile_launch(model, f, alphas, state, plan, m, halo)
            n -= m
        return state

    if tol is None:
        state = chunk(state, maxiter)
        iters = maxiter
    else:
        iters, delta = 0, math.inf
        while iters < maxiter and delta > tol:
            u_prev = state[0]
            n = min(check_every, maxiter - iters)
            state = chunk(state, n)
            delta = float(relative_change(state[0], u_prev))
            iters += n
    return state[0], state[1], iters


def _image(O, M, N, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.arange(M), np.arange(N), indexing="ij")
    clean = np.stack([((xx - N / 2 - b) ** 2 + (yy - M / 2) ** 2
                       < (min(M, N) / 3) ** 2).astype(np.float64)
                      for b in range(O)])
    return clean + 0.1 * rng.standard_normal(clean.shape), rng


def _case(form, O, M, N, seed=0):
    f, rng = _image(O, M, N, seed)
    amap = 0.05 + 0.05 * rng.random((M, N))
    if form == "tv":
        model, a = tv_model(), (0.1,)
    elif form == "tv_map":
        model, a = tv_model(), (amap,)
    elif form == "sumregs":
        model, a = sumregs_model(), (0.035, 0.032, 0.005)
    elif form == "sumregs_maps":
        model, a = sumregs_model(), (amap, 0.5 * amap, 0.1 * amap)
    else:
        model = DenoiseModel(ops=(CenteredGradientOp(), BwdGradientOp()))
        a = (0.04, amap)
    return (torch.from_numpy(f), model,
            tuple(torch.as_tensor(np.asarray(x)) for x in a))


def _plan(model, M, N, T, rows, cols):
    kinds = [STENCIL[type(op)] for op in model.ops]
    return tile_geometry(M, N, model.K, 8, stencil_reach(kinds), T, rows,
                         cols)


def _same(a, b):
    (ua, ya, ia), (ub, yb, ib) = a, b
    return ia == ib and torch.equal(ua, ub) and all(
        torch.equal(x, y) for x, y in zip(ya, yb))


SCHEDULES = [
    # form, (O, M, N), T, owned tile, maxiter, tol, check_every, warm
    ("tv", (2, 30, 26), 4, (12, 10), 23, None, 10, False),       # K = 1
    ("sumregs", (1, 28, 30), 3, (11, 12), 14, None, 10, False),  # H = 2T
    ("tv_map", (2, 24, 22), 5, (10, 8), 17, None, 10, False),
    ("sumregs_maps", (1, 22, 20), 2, (9, 8), 11, None, 10, False),
    ("generic", (1, 20, 24), 3, (8, 10), 10, None, 10, False),
    ("tv", (2, 26, 24), 4, (10, 10), 80, 1e-3, 7, False),        # tol
    ("sumregs", (1, 22, 20), 3, (9, 8), 60, 1e-3, 10, False),
    ("tv", (1, 24, 20), 3, (10, 8), 40, 1e-4, 9, True),          # warm
    ("sumregs", (1, 20, 22), 2, (8, 10), 24, None, 10, True),
    ("tv", (1, 37, 53), 4, (10, 14), 30, 1e-3, 11, False),       # ragged
    ("tv_map", (1, 37, 53), 6, (16, 20), 20, None, 10, False),
]


@pytest.mark.parametrize(
    "form,shape,T,owned,maxiter,tol,check,warm", SCHEDULES,
    ids=[f"{s[0]}-{'x'.join(map(str, s[1]))}-T{s[2]}"
         f"{'-tol' if s[5] else ''}{'-warm' if s[7] else ''}"
         for s in SCHEDULES])
def test_tile_schedule_is_the_plain_solver(form, shape, T, owned, maxiter,
                                           tol, check, warm):
    """The tile schedule with the plan's halo gives the plain solver's
    iterates, duals and iteration counts bit for bit in float64; with the
    halo one pixel short an owned pixel is reached from outside its tile
    and it differs."""
    O, M, N = shape
    f, model, alphas = _case(form, O, M, N)
    plan = _plan(model, M, N, T, *owned)
    assert plan.tiles_m > 1 and plan.tiles_n > 1
    state = None
    if warm:
        u0, ys0, _ = _denoise_pdps_impl(f, alphas, None, model=model,
                                        maxiter=25, tol=None,
                                        check_every=10, return_dual=True,
                                        **PD)
        state = (u0, ys0)
        alphas = tuple(0.9 * a for a in alphas)
    kw = dict(model=model, maxiter=maxiter, tol=tol, check_every=check)
    want = _denoise_pdps_impl(f, alphas, state, return_dual=True, **PD,
                              **kw)
    got = tile_schedule(f, alphas, state, plan=plan, **kw)
    assert _same(got, want)
    short = tile_schedule(f, alphas, state, plan=plan, halo=plan.H - 1,
                          **kw)
    assert not _same(short, want)


def test_tile_schedule_at_the_plans_own_tiles():
    """The plan's own tiles for a ragged 1×37×53 float64 image (no TMA:
    its rows are not of 16 bytes) and for 2×64×48 with a map."""
    for form, shape, n_maps in (("tv", (1, 37, 53), 0),
                                ("tv_map", (2, 64, 48), 1)):
        O, M, N = shape
        f, model, alphas = _case(form, O, M, N, seed=3)
        plan = pd_tile_plan(M, N, 1, 8, n_maps, False, images=O)
        assert plan.tiles_m * plan.tiles_n > 1
        kw = dict(model=model, maxiter=2 * plan.T + 3, tol=None,
                  check_every=10)
        want = _denoise_pdps_impl(f, alphas, None, return_dual=True, **PD,
                                  **kw)
        assert _same(tile_schedule(f, alphas, None, plan=plan, **kw), want)


# ---- against the JAX package's row-tiled Pallas kernel

JAX_CASES = [("tv", 3), ("tv", 4), ("tv", 5), ("tv_map", 4),
             ("sumregs", 3), ("sumregs", 5)]


@pytest.mark.parametrize("form,T", JAX_CASES,
                         ids=[f"{c[0]}-T{c[1]}" for c in JAX_CASES])
def test_port_against_jax_tiled_kernel(form, T):
    """1×64×48, tile_rows 16, a fixed budget of 23 iterations (whole
    chunks and JAX's remainder chunk): the port's plain solver and its tile
    schedule (2-D tiles of the port's own kind, T the same) against
    ``_tiled_impl`` in interpret mode at 1e-12 relative."""
    f, model, alphas = _case(form, 1, 64, 48, seed=7)
    jmodel = j_sumregs() if form == "sumregs" else j_tv()
    maxiter = 23
    ju = _tiled_impl(jnp.asarray(f.numpy()),
                     tuple(jnp.asarray(a.numpy()) for a in alphas),
                     model=jmodel, maxiter=maxiter, interpret=True,
                     tile_rows=16, chunk_iters=T, **PD)
    ju = np.asarray(ju)
    kw = dict(model=model, maxiter=maxiter, tol=None, check_every=10)
    pu, _, pit = _denoise_pdps_impl(f, alphas, None, return_dual=True, **PD,
                                    **kw)
    plan = _plan(model, 64, 48, T, 16, 16)
    tu, _, tit = tile_schedule(f, alphas, None, plan=plan, **kw)
    assert pit == tit == maxiter
    scale = np.abs(ju).max()
    for u in (pu, tu):
        assert np.abs(u.numpy() - ju).max() <= 1e-12 * scale
