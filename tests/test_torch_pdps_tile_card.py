"""Kernel A's tile form on the card (``csrc/pd_tile.cuh``: 2-D tiles, one
CTA a tile, T iterations a launch on shared-memory state with a halo of
reach·T pixels).

- On the card (marked ``cuda``; they skip without one): the tile form
  against the two-launch form (which a patched plan forces) bit for bit,
  u, duals and iteration counts, and against the plain version, for the
  four forms the kernel is instantiated for and a generic one, in float64
  and float32, cold with a fixed budget, cold with the early stop
  (``check_every`` not a multiple of T) and warm; on tiles the patched plan
  makes small (ragged edge tiles, rows of 16 bytes or not: TMA or plain
  copies; more tiles than one wave), on the plan's own tiles where the tile
  form takes over, on one CTA an SM and on a grid that walks the tiles.  Against the plain version: float64 at
  1e-9 relative with equal iteration counts; float32 at ``chip_smoke.py``'s
  kernel-A tolerances (u 1e-4, y 1e-3 absolute) with counts within one
  check.  Each call counts one launch, one tile-form call and exactly its
  device operations; a plan the card cannot run raises.
- On the CPU: CPU tensors count nothing.

This file imports no JAX, so the card's tests also run where JAX is not
installed: ``python -m pytest --noconftest tests/test_torch_pdps_tile_card.py
-m cuda``.
"""

import numpy as np
import pytest
import torch

from bpldenoising_tpu_torch.models import DenoiseModel, sumregs_model, \
    tv_model
from bpldenoising_tpu_torch.ops import BwdGradientOp, CenteredGradientOp
from bpldenoising_tpu_torch.solvers import cluster_plan, pdps_cuda
from bpldenoising_tpu_torch.solvers.pdps import _denoise_pdps_impl

PD = dict(tau0=5.0, sigma0=0.99 / 5.0, gamma=1.0, accel=True)


def test_cpu_tensors_count_nothing():
    """On CPU tensors the wrapper runs the plain version: no launch, no
    tile-form call, no device operation, even where the tile form would
    run on the card."""
    f = torch.from_numpy(np.random.default_rng(0).random((1, 336, 336)))
    assert not cluster_plan.pd_plan(336, 336, 1, 8).resident
    before = (pdps_cuda.launches, pdps_cuda.tiled_calls,
              pdps_cuda.device_ops)
    u = pdps_cuda.denoise_pdps_cuda(
        f, (torch.tensor(0.1, dtype=f.dtype),), None, model=tv_model(),
        maxiter=3, tol=None, check_every=2, return_dual=False, **PD)
    assert u.shape == f.shape
    assert (pdps_cuda.launches, pdps_cuda.tiled_calls,
            pdps_cuda.device_ops) == before


# ---- on the card

@pytest.fixture
def cuda_device():
    """The card, for tests marked ``cuda``; they skip without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (python -m pytest --noconftest "
                    "tests/test_torch_pdps_tile_card.py -m cuda)")
    return torch.device("cuda")


FORMS = ("tv", "tv_map", "sumregs", "sumregs_maps", "generic")


def _case(form, shape, dtype, seed=0):
    """f (O, M, N), the model and the weights of ``form``: scalar TV, TV
    with an (M, N) map, the sum of regularizers with three scalars or three
    maps, and (generic) a centred and a backward block, one a map."""
    rng = np.random.default_rng(seed)
    O, M, N = shape
    yy, xx = np.meshgrid(np.arange(M), np.arange(N), indexing="ij")
    clean = np.stack([((xx - N / 2 - b % 3) ** 2 + (yy - M / 2) ** 2
                       < (min(M, N) / 3) ** 2).astype(np.float64)
                      for b in range(O)])
    f = clean + 0.1 * rng.standard_normal(clean.shape)
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
    alphas = tuple(torch.as_tensor(np.asarray(x), dtype=dtype) for x in a)
    return torch.as_tensor(f, dtype=dtype), model, alphas


def _run(f, alphas, state, device, **kw):
    """Kernel A on the card → (u, ys, iters, device operations, tile-form
    calls)."""
    ops, tiled = pdps_cuda.device_ops, pdps_cuda.tiled_calls
    launches = pdps_cuda.launches
    on = tuple(a.to(device) for a in alphas)
    st = None if state is None else (state[0].to(device),
                                     tuple(y.to(device) for y in state[1]))
    u, ys, it = pdps_cuda.denoise_pdps_cuda(f.to(device), on, st, **kw)
    torch.cuda.synchronize()
    assert pdps_cuda.launches == launches + 1
    return u.cpu(), tuple(y.cpu() for y in ys), it, \
        pdps_cuda.device_ops - ops, pdps_cuda.tiled_calls - tiled


def _tile_form(monkeypatch, rows, cols, T):
    """Make kernel A plan its tile form whatever the shapes, on tiles of
    ``rows`` × ``cols`` owned pixels and T iterations a launch; the last
    plan made is kept in ``plans``."""
    real = cluster_plan.pd_plan
    plans = []
    monkeypatch.setattr(pdps_cuda, "pd_plan", lambda *a: real(*a)._replace(
        resident=False, smem=0))

    def plan(M, N, K, itemsize, n_maps, centred, images=1):
        plans.append(cluster_plan.tile_geometry(
            M, N, K, itemsize, 2 if centred else 1, T, rows, cols,
            images=images))
        return plans[-1]

    monkeypatch.setattr(pdps_cuda, "pd_tile_plan", plan)
    return plans


def _variant(p, name, M, N, K, itemsize, centred, images):
    """The plan ``p`` (``plan``); the same T on the largest square tile
    whose planes fill one CTA an SM (``one_cta``); or a grid of one CTA an
    SM that walks the tiles (``walk``)."""
    if name == "walk":
        return p._replace(grid=min(p.grid, cluster_plan.SMS))
    if name == "one_cta":
        for side in range(256, 0, -4):
            q = cluster_plan.tile_geometry(M, N, K, itemsize,
                                           2 if centred else 1, p.T, side,
                                           side, images=images)
            if q.smem <= cluster_plan.SMEM_PER_BLOCK \
                    and max(q.height, q.pitch) <= 256:
                return q
    return p


def _two_launch(monkeypatch):
    """Make kernel A plan its two-launch form whatever the shapes."""
    real = cluster_plan.pd_plan
    monkeypatch.setattr(pdps_cuda, "pd_plan", lambda *a: real(*a)._replace(
        resident=False, smem=0))
    monkeypatch.setattr(pdps_cuda, "pd_tile_plan", lambda *a, **k: None)


def tile_ops(maxiter, iters, tol, check, T):
    """The tile form's device operations: the table copy, ⌈chunk / T⌉
    launches a chunk (all maxiter one chunk without tol), pd_change and the
    read a chunk with tol, and a last copy of u and of the duals where
    their buffers' rotation (csrc/pdps.cu: pdt_run) leaves them elsewhere."""
    ops = 1 if maxiter > 0 else 0
    cu = cy = 0
    chunks = [maxiter] if tol is None else \
        [min(check, iters - c) for c in range(0, iters, check)]
    for n in chunks:
        snap = -1 if tol is None else cu
        for _ in range(-(-n // T)):
            to = (cu + 1) % 3
            if to == snap or (snap < 0 and to == 2):
                to = (to + 1) % 3
            cu, cy = to, 1 - cy
            ops += 1
        ops += 0 if tol is None else 2
    return ops + (cu != 0) + (cy != 0)


def _compare(f, model, alphas, device, monkeypatch, plans, check=7):
    """The tile form (as patched) cold fixed, cold early-stopped and warm;
    then the two-launch form on the same calls, bit for bit; and the plain
    version at the file's tolerances."""
    modes = (("cold fixed", None, dict(maxiter=40, tol=None)),
             ("cold early stop", None, dict(maxiter=300, tol=1e-4)),
             ("warm early stop", "state", dict(maxiter=300, tol=1e-5)))
    runs, state = {}, None
    for name, warm, extra in modes:
        kw = dict(model=model, check_every=check, return_dual=True, **PD,
                  **extra)
        st = state if warm else None
        a = alphas if not warm else tuple(0.9 * x for x in alphas)
        k = _run(f, a, st, device, **kw)
        p = _denoise_pdps_impl(f, a, st, **kw)
        runs[name] = (k, p, kw, a, st)
        state = (p[0], p[1])
        T = plans[-1].T
        assert k[4] == 1, name
        assert k[3] == tile_ops(kw["maxiter"], k[2], kw["tol"], check, T), \
            (name, k[3])
    monkeypatch.undo()
    _two_launch(monkeypatch)
    dtype = f.dtype
    for name, (k, p, kw, a, st) in runs.items():
        g = _run(f, a, st, device, **kw)
        assert g[4] == 0
        assert g[2] == k[2], name
        assert torch.equal(g[0], k[0]), name
        assert all(torch.equal(x, y) for x, y in zip(g[1], k[1])), name
        if dtype == torch.float64:
            assert k[2] == p[2], name
            scale = max(float(p[0].abs().max()), 1e-300)
            assert float((k[0] - p[0]).abs().max()) <= 1e-9 * scale, name
            for x, y in zip(k[1], p[1]):
                s = max(float(y.abs().max()), 1e-300)
                assert float((x - y).abs().max()) <= 1e-9 * s, name
        else:
            assert abs(k[2] - p[2]) <= check, name
            assert float((k[0] - p[0]).abs().max()) <= 1e-4, name
            for x, y in zip(k[1], p[1]):
                assert float((x - y).abs().max()) <= 1e-3, name


# (O, M, N), owned tile, T: ragged edge tiles; rows of 16 bytes in both
# dtypes (TMA) or in neither (37 × 53: plain copies); more tiles than one
# wave of 132 SMs (40 images of 4 × 4 tiles)
SMALL = (((2, 20, 24), (7, 8), 3), ((1, 37, 53), (10, 12), 4),
         ((3, 16, 20), (6, 8), 2), ((40, 32, 32), (8, 8), 2),
         ((1, 5, 7), (2, 4), 1))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("shape,owned,T", SMALL,
                         ids=lambda v: "x".join(map(str, v))
                         if isinstance(v, tuple) else str(v))
@pytest.mark.parametrize("form", FORMS)
def test_tile_form_matches_two_launch_form_and_plain(
        cuda_device, monkeypatch, form, shape, owned, T, dtype):
    f, model, alphas = _case(form, shape, dtype)
    plans = _tile_form(monkeypatch, rows=owned[0], cols=owned[1], T=T)
    _compare(f, model, alphas, cuda_device, monkeypatch, plans)
    assert plans[-1].tiles_m * plans[-1].tiles_n > 1


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["plan", "one_cta", "walk"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("form,shape", [
    ("tv", (1, 336, 336)), ("tv_map", (2, 320, 328)),
    ("sumregs", (1, 216, 224)), ("sumregs_maps", (1, 208, 212)),
    ("generic", (1, 152, 160))])
def test_plans_own_tiles(cuda_device, monkeypatch, form, shape, dtype,
                         variant):
    """Where the tile form takes over (the bands do not fit; the generic
    form's float32 bands fit, so there the plan is patched to tiles), on
    the plan's own tiles, on one CTA an SM and on a grid that walks the
    tiles (scripts/tile_sizes.py's variants): the same bits as the
    two-launch form."""
    f, model, alphas = _case(form, shape, dtype)
    real, tile = cluster_plan.pd_plan, cluster_plan.pd_tile_plan
    plans = []
    monkeypatch.setattr(pdps_cuda, "pd_plan", lambda *a: real(*a)._replace(
        resident=False, smem=0))

    def plan(M, N, K, itemsize, n_maps, centred, images=1):
        plans.append(_variant(tile(M, N, K, itemsize, n_maps, centred,
                                   images=images), variant, M, N, K,
                              itemsize, centred, images))
        return plans[-1]

    monkeypatch.setattr(pdps_cuda, "pd_tile_plan", plan)
    _compare(f, model, alphas, cuda_device, monkeypatch, plans, check=9)


@pytest.mark.cuda
@pytest.mark.parametrize("change", ["halo", "smem", "box"])
def test_refused_tile_plan_raises(cuda_device, monkeypatch, change):
    """A tile plan the card cannot run raises; it is not retried in another
    form: a halo one pixel short of reach·T, a tile whose planes exceed the
    shared memory of a CTA, a TMA box wider than 256."""
    real = cluster_plan.pd_tile_plan

    def bad(M, N, K, itemsize, n_maps, centred, images=1):
        p = real(M, N, K, itemsize, n_maps, centred, images=images)
        if change == "halo":
            return p._replace(H=p.H - 1, height=p.height - 2,
                              pitch=p.pitch)
        if change == "smem":
            return p._replace(rows=200, height=200 + 2 * p.H, tiles_m=-(
                -M // 200), cols=200, pitch=200 + 2 * p.H + 4, tiles_n=-(
                -N // 200))
        return p._replace(cols=256, pitch=256 + 2 * p.H + 4,
                          tiles_n=-(-N // 256))

    monkeypatch.setattr(pdps_cuda, "pd_tile_plan", bad)
    f, model, alphas = _case("sumregs", (1, 512, 512), torch.float32)
    with pytest.raises(RuntimeError, match="pdps kernel"):
        _run(f, alphas, None, cuda_device, model=model, maxiter=10,
             tol=None, check_every=10, return_dual=True, **PD)
