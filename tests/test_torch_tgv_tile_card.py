"""The TGV² CP solve's tile form on the card (``csrc/tgv_tile.cu``: 2-D
tiles, one CTA a tile, T iterations a launch on shared-memory state with a
halo of T pixels).

- On the card (marked ``cuda``; they skip without one): the tile form
  against the two-launch form (which a patched plan forces) bit for bit,
  u, w, p, q and iteration counts, and against the plain version, with
  scalar, map and mixed weights, in float64 and float32, cold with a fixed
  budget (not a multiple of T), cold with the early stop (``check_every``
  not a multiple of T) and warm; on tiles the patched plan makes small
  (ragged edge tiles, rows of 16 bytes or not: TMA or plain copies; more
  tiles than one wave; T = 1), and on the plan's own tiles where the tile
  form takes over (float32 from 240², float64 from 160²), also on a grid
  that walks the tiles.  Against the plain version: float64 at 1e-9
  relative with equal iteration counts; float32 at ``chip_smoke.py``'s TGV
  tolerances (u 1e-4, w/p/q 1e-3 absolute) with counts within one check.
  Each call counts one launch, one tile-form call and exactly its device
  operations; a tile plan the card cannot run raises, and is not retried
  in another form.
- On the CPU: CPU tensors count nothing.

This file imports no JAX, so the card's tests also run where JAX is not
installed: ``python -m pytest --noconftest tests/test_torch_tgv_tile_card.py
-m cuda``.
"""

import numpy as np
import pytest
import torch

from bpldenoising_tpu_torch.solvers import cluster_plan, tgv_cuda
from bpldenoising_tpu_torch.solvers.tgv import _tgv_impl

# chip_smoke.py's TOL_TGV_U_F32 / TOL_TGV_DUAL_F32
TOL_U_F32, TOL_DUAL_F32 = 1e-4, 1e-3
CHECK = 25
MODES = (("cold fixed", False, dict(maxiter=37, tol=None)),
         ("cold early stop", False, dict(maxiter=400, tol=1e-4)),
         ("warm early stop", True, dict(maxiter=400, tol=1e-5)))


def _counts():
    return (tgv_cuda.launches, tgv_cuda.cluster_calls, tgv_cuda.tiled_calls,
            tgv_cuda.device_ops)


def _case(shape, dtype, seed=0):
    """f (O, M, N): a ramp with a step and a disc under Gaussian noise, and
    (M, N) maps for α₁ and α₀, all made with numpy from a seed."""
    rng = np.random.default_rng(seed)
    O, M, N = shape
    yy, xx = np.meshgrid(np.arange(M), np.arange(N), indexing="ij")
    clean = np.stack([0.02 * xx + (yy > M // 2 + b % 3)
                      + ((xx - N / 2) ** 2 + (yy - M / 3) ** 2
                         < (min(M, N) / 4) ** 2)
                      for b in range(O)])
    f = clean + 0.1 * rng.standard_normal(clean.shape)
    a1 = 0.05 + 0.1 * rng.random((M, N))
    a0 = 0.1 + 0.1 * rng.random((M, N))
    return (torch.as_tensor(f, dtype=dtype),
            torch.as_tensor(a1, dtype=dtype),
            torch.as_tensor(a0, dtype=dtype))


def _weights(kind, a1map, a0map):
    """(α₁, α₀) and the nudged pair of a warm start: scalars, maps, or a
    map α₁ beside a scalar α₀."""
    dt = a1map.dtype
    if kind == "scalar":
        a = (torch.tensor(0.1, dtype=dt), torch.tensor(0.15, dtype=dt))
    elif kind == "map":
        a = (a1map, a0map)
    else:
        a = (a1map, torch.tensor(0.15, dtype=dt))
    return a, (1.05 * a[0], 0.95 * a[1])


def test_cpu_tensors_count_nothing():
    """On CPU tensors the wrapper runs the plain version: no launch, no
    tile-form call, no device operation, even where the tile form would
    run on the card."""
    f, a1map, a0map = _case((1, 256, 256), torch.float32)
    assert not cluster_plan.tgv_plan(256, 256, 4).resident
    before = _counts()
    for a in ((0.1, 0.15), (a1map, a0map)):
        u, w, state, it = tgv_cuda.tgv_denoise_pdps_cuda(
            f, *a, maxiter=3, tol=1e-9, check_every=2, return_state=True)
        assert u.shape == f.shape and w.shape == (1, 2, 256, 256)
        assert it == 3
    assert _counts() == before


def tile_ops(T, iters, maxiter, tol, check):
    """The device operations of a tile-form call (csrc/tgv_tile.cu's
    tt_run): ⌈chunk / T⌉ launches a chunk, u among three buffers and w, p,
    q between two; per check the two passes of the sums and the read; a
    last copy of u and three of w, p, q where they end in another
    buffer."""
    cu = cy = ops = 0

    def advance(n, snap):
        nonlocal cu, cy, ops
        for _ in range(-(-n // T)):
            to = (cu + 1) % 3
            if to == snap or (snap < 0 and to == 2):
                to = (to + 1) % 3
            if to == cu:
                to = (cu + 2) % 3
            cu, cy, ops = to, 1 - cy, ops + 1

    if tol is None:
        advance(maxiter, -1)
    else:
        it = 0
        while it < iters:
            chunk = min(check, maxiter - it)
            advance(chunk, cu)
            ops += 3
            it += chunk
    return ops + (cu != 0) + 3 * (cy != 0)


def test_tile_ops_rule():
    """The rule above on the cases it has to tell apart: a fixed budget
    ending in either buffer, chunks that end where they started."""
    assert tile_ops(4, 8, 8, None, 25) == 2
    assert tile_ops(4, 9, 9, None, 25) == 3 + 4
    assert tile_ops(5, 25, 400, 1e-4, 25) == 5 + 3 + 1 + 3
    assert tile_ops(5, 50, 400, 1e-4, 25) == 10 + 6 + 1
    assert tile_ops(2, 75, 400, 1e-4, 25) == 39 + 9 + 3


# ---- on the card

@pytest.fixture
def cuda_device():
    """The card, for tests marked ``cuda``; they skip without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (python -m pytest --noconftest "
                    "tests/test_torch_tgv_tile_card.py -m cuda)")
    return torch.device("cuda")


def _on(a, device):
    return a.to(device) if a.ndim else a


def _run(f, a, state, device, **kw):
    """The kernel on the card → ((u, w, p, q), iters, device operations,
    cluster calls, tile-form calls)."""
    launches, calls, tiled, ops = _counts()
    st = None if state is None else tuple(s.to(device) for s in state)
    _, _, out, it = tgv_cuda.tgv_denoise_pdps_cuda(
        f.to(device), *(_on(x, device) for x in a), state0=st,
        return_state=True, check_every=CHECK, **kw)
    torch.cuda.synchronize()
    assert tgv_cuda.launches == launches + 1
    return (tuple(s.cpu() for s in out), it, tgv_cuda.device_ops - ops,
            tgv_cuda.cluster_calls - calls, tgv_cuda.tiled_calls - tiled)


def _plain(f, a, state, device, **kw):
    """The plain version on the card → ((u, w, p, q) on the CPU, iters)."""
    st = None if state is None else tuple(s.to(device) for s in state)
    _, _, out, it = _tgv_impl(f.to(device), *(_on(x, device) for x in a),
                              st, tau0=0.99, sigma0=0.99, return_state=True,
                              check_every=CHECK, **kw)
    return tuple(s.cpu() for s in out), it


def _same(k, g, name):
    assert k[1] == g[1], name
    for x, y in zip(k[0], g[0]):
        assert torch.equal(x, y), name


def _no_bands(monkeypatch):
    """The CP wrapper finds the bands do not fit, whatever the shapes."""
    real = cluster_plan.tgv_plan
    monkeypatch.setattr(tgv_cuda, "tgv_plan", lambda *a: real(*a)._replace(
        resident=False, smem=0))


def _compare(f, a, a_warm, device, monkeypatch, plans):
    """The three modes in the tile form (the plan ``tgv_cuda`` holds, the
    last one made in ``plans``), then the same in the two-launch form
    (no tile plan): bits, iteration counts, device operations, and the
    plain version."""
    runs, state = {}, None
    for name, warm, extra in MODES:
        w = a_warm if warm else a
        st = state if warm else None
        k = _run(f, w, st, device, **extra)
        T = plans[-1].T
        assert (k[3], k[4]) == (0, 1), name
        assert k[2] == tile_ops(T, k[1], extra["maxiter"], extra["tol"],
                                CHECK), (name, k[2], T, k[1])
        runs[name] = (k, w, st, extra)
        p, p_it = _plain(f, w, st, device, **extra)
        if f.dtype == torch.float64:
            assert k[1] == p_it, name
            for x, y in zip(k[0], p):
                s = max(float(y.abs().max()), 1e-300)
                assert float((x - y).abs().max()) <= 1e-9 * s, name
        else:
            assert abs(k[1] - p_it) <= CHECK, name
            errs = [float((x - y).abs().max()) for x, y in zip(k[0], p)]
            assert errs[0] <= TOL_U_F32, (name, errs)
            assert max(errs[1:]) <= TOL_DUAL_F32, (name, errs)
        state = p
    monkeypatch.setattr(tgv_cuda, "tgv_tile_plan", lambda *x, **kw: None)
    for name, (k, w, st, extra) in runs.items():
        g = _run(f, w, st, device, **extra)
        assert (g[3], g[4]) == (0, 0), name
        _same(k, g, name)


# (shape, dtype, owned rows, cols, T): ragged edge tiles; rows of 16 bytes
# (TMA) or not (plain copies); a window wider than the image; more tiles
# than one wave; T = 1
SMALL = [((2, 37, 53), torch.float64, 10, 14, 3),
         ((3, 40, 48), torch.float32, 12, 16, 4),
         ((1, 64, 64), torch.float32, 16, 16, 5),
         ((1, 64, 64), torch.float64, 16, 16, 5),
         ((2, 33, 40), torch.float32, 9, 8, 2),
         ((1, 20, 24), torch.float32, 8, 8, 6),
         ((40, 32, 32), torch.float32, 8, 8, 2),
         ((2, 30, 36), torch.float64, 7, 9, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype,rows,cols,T", SMALL, ids=[
    f"{'x'.join(map(str, s))}-{str(d)[-7:]}-{r}x{c}-T{t}"
    for s, d, r, c, t in SMALL])
@pytest.mark.parametrize("weight", ["scalar", "map", "mixed"])
def test_small_tiles_match_two_launch_form_and_plain(
        cuda_device, monkeypatch, weight, shape, dtype, rows, cols, T):
    f, a1map, a0map = _case(shape, dtype)
    a, a_warm = _weights(weight, a1map, a0map)
    _no_bands(monkeypatch)
    plans = []

    def plan(M, N, itemsize, n_maps, images=1):
        plans.append(cluster_plan.tgv_tile_geometry(
            M, N, itemsize, T, rows, cols, images=images))
        return plans[-1]

    monkeypatch.setattr(tgv_cuda, "tgv_tile_plan", plan)
    _compare(f, a, a_warm, cuda_device, monkeypatch, plans)
    p = plans[-1]
    assert p.tiles_m * p.tiles_n > 1
    assert p.tma == (shape[2] * f.element_size() % 16 == 0
                     and p.pitch <= shape[2] and p.height <= shape[1])


# where the tile form takes over on the plan's own tiles
OWN = [((1, 240, 240), torch.float32, "scalar"),
       ((2, 256, 256), torch.float32, "map"),
       ((1, 248, 260), torch.float32, "mixed"),
       ((1, 160, 160), torch.float64, "scalar"),
       ((1, 168, 176), torch.float64, "map")]


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["plan", "walk"])
@pytest.mark.parametrize("shape,dtype,weight", OWN, ids=[
    f"{'x'.join(map(str, s))}-{str(d)[-7:]}-{w}" for s, d, w in OWN])
def test_plans_own_tiles(cuda_device, monkeypatch, shape, dtype, weight,
                         variant):
    """Where the bands do not fit, on the plan's own tiles and on a grid of
    fewer CTAs that walks them: the same bits as the two-launch form."""
    assert not cluster_plan.tgv_plan(shape[1], shape[2],
                                     8 if dtype == torch.float64
                                     else 4).resident
    f, a1map, a0map = _case(shape, dtype, seed=1)
    a, a_warm = _weights(weight, a1map, a0map)
    real, plans = cluster_plan.tgv_tile_plan, []

    def plan(M, N, itemsize, n_maps, images=1):
        p = real(M, N, itemsize, n_maps, images)
        plans.append(p if variant == "plan" else
                     p._replace(grid=max(1, p.grid // 3)))
        return plans[-1]

    monkeypatch.setattr(tgv_cuda, "tgv_tile_plan", plan)
    _compare(f, a, a_warm, cuda_device, monkeypatch, plans)


@pytest.mark.cuda
@pytest.mark.parametrize("change", ["halo", "smem", "box"])
def test_refused_tile_plan_raises(cuda_device, monkeypatch, change):
    """A tile plan the card cannot run raises; it is not retried in another
    form: a halo one pixel short of T, a tile whose planes exceed the
    shared memory of a CTA, a TMA box wider than 256."""
    real = cluster_plan.tgv_tile_plan

    def bad(M, N, itemsize, n_maps, images=1):
        p = real(M, N, itemsize, n_maps, images)
        if change == "halo":
            return p._replace(H=p.H - 1, height=p.height - 2)
        if change == "smem":
            return p._replace(rows=120, height=120 + 2 * p.H,
                              tiles_m=-(-M // 120), cols=120,
                              pitch=120 + 2 * p.H + 4,
                              tiles_n=-(-N // 120))
        return p._replace(cols=256, pitch=256 + 2 * p.H + 4,
                          tiles_n=-(-N // 256))

    monkeypatch.setattr(tgv_cuda, "tgv_tile_plan", bad)
    f, _, _ = _case((1, 512, 512), torch.float32)
    before = _counts()
    with pytest.raises(RuntimeError, match="tgv kernel"):
        _run(f, (torch.tensor(0.1), torch.tensor(0.2)), None, cuda_device,
             maxiter=10, tol=None)
    after = _counts()
    assert (after[2] - before[2], after[3]) == (1, before[3])
