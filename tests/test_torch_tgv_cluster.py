"""The TGV² CP kernel's cluster form (``csrc/tgv.cu``: one launch per
early-stop chunk, a thread-block cluster an image, the bands of
``csrc/tgv_cluster.cuh``) and its plan.

- On the CPU: the plan (``solvers/cluster_plan.py::tgv_plan``, which the
  single-loop TGV² learner also takes) for the TGV² shapes: the learns'
  10×128² in float32 and float64, 1×1024² (the bands do not fit in shared
  memory: the tile form runs there), 2×32², uneven bands; the CP
  wrapper and the learner plan by the one rule; CPU calls count no
  launch, no cluster call and no device operation; bad weights, devices
  and CPU tensors handed to the launch raise.
- On the card (marked ``cuda``; they skip without one): the cluster form
  against the two-launch form and against the plain version, with scalar,
  map and mixed weights, float64 and float32, on uneven bands, the
  smallest images and more images than one wave of clusters holds; cold
  with a fixed budget, cold with the early stop, warm.  The two kernel
  forms run the same operations in the same order (``-fmad=false``), so
  they must agree bit for bit with equal iteration counts; so must every
  cluster size (a halo row is recomputed with the owner's operations), and
  a constant map must give the scalar run's bits.  Against the plain
  version: float64 at 1e-9 relative with equal iteration counts; float32
  at ``chip_smoke.py``'s TGV tolerances (u 1e-4, w/p/q 1e-3 absolute) with
  counts within one check.  Each call counts one launch and the device
  operations of its form; bad inputs and a plan the card refuses raise.

This file imports no JAX, so the card's tests also run where JAX is not
installed: ``python -m pytest --noconftest tests/test_torch_tgv_cluster.py
-m cuda``.
"""

import numpy as np
import pytest
import torch

from bpldenoising_tpu_torch.bilevel import first_order_tgv_cuda
from bpldenoising_tpu_torch.solvers import cluster_plan, tgv_cuda
from bpldenoising_tpu_torch.solvers.tgv import _tgv_impl

# chip_smoke.py's TOL_TGV_U_F32 / TOL_TGV_DUAL_F32
TOL_U_F32, TOL_DUAL_F32 = 1e-4, 1e-3


@pytest.mark.parametrize("M,N,itemsize,cluster,rows,resident", [
    (128, 128, 4, 16, 8, True),      # the TGV² learns: 88 KB a CTA
    (128, 128, 8, 16, 8, True),      # float64: 176 KB
    (1024, 1024, 4, 16, 64, False),  # row 5's shape: 3.2 MB a band
    (32, 32, 8, 16, 2, True),
    (50, 37, 4, 16, 4, True),        # CTA 12 owns 2 rows, 13–15 none
    (40, 36, 8, 16, 3, True),        # CTA 13 owns 1 row, 14–15 none
    (8, 8, 8, 4, 2, True),
    (5, 7, 8, 2, 3, True),           # the second CTA owns two rows
    (3, 9, 4, 1, 3, True),           # one CTA: no neighbour
    (256, 256, 4, 16, 16, False),    # 260 KB
])
def test_tgv_plan(M, N, itemsize, cluster, rows, resident):
    """The TGV² CP kernel's plan from the shapes: the largest power of two
    up to 16 CTAs that leaves every CTA but the last two rows, and the
    band of the eleven planes on rows + 4 rows and 40 halo-slot rows in
    shared memory where it fits in 227 KB (else the tile form)."""
    plan = cluster_plan.tgv_plan(M, N, itemsize)
    assert (plan.cluster, plan.rows, plan.resident) == (cluster, rows,
                                                        resident)
    band = (11 * (rows + 4) + 40) * N * itemsize
    assert plan.planes == 11
    assert plan.smem == (band if resident else 0)
    assert (band <= cluster_plan.SMEM_PER_BLOCK) == resident


def test_cp_solve_and_learner_plan_by_one_rule():
    """The CP wrapper and the single-loop TGV² learner (row 11) take the
    same ``tgv_plan``, whose plans at the learner's shapes stay those its
    tests hold: 16 CTAs of 8 rows at 128², global bands at 256²."""
    assert tgv_cuda.tgv_plan is cluster_plan.tgv_plan
    assert first_order_tgv_cuda.tgv_plan is cluster_plan.tgv_plan
    assert cluster_plan.tgv_plan(128, 128, 4) == cluster_plan.PdPlan(
        16, 8, 11, 88064, True)
    assert cluster_plan.tgv_plan(128, 128, 8) == cluster_plan.PdPlan(
        16, 8, 11, 176128, True)
    assert cluster_plan.tgv_plan(256, 256, 8) == cluster_plan.PdPlan(
        16, 16, 11, 0, False)


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


def _counts():
    return tgv_cuda.launches, tgv_cuda.cluster_calls, tgv_cuda.device_ops


@pytest.mark.parametrize("kind", ["scalar", "map", "mixed"])
def test_cpu_calls_count_nothing(kind):
    """On CPU tensors the wrapper runs the plain version and counts no
    launch, no cluster call and no device operation: cold with a fixed
    budget and the early stop, warm."""
    f, a1map, a0map = _case((2, 10, 12), torch.float64)
    a, a_warm = _weights(kind, a1map, a0map)
    before = _counts()
    u, w = tgv_cuda.tgv_denoise_pdps_cuda(f, *a, maxiter=40)
    _, _, state, it = tgv_cuda.tgv_denoise_pdps_cuda(
        f, *a, maxiter=60, tol=1e-6, check_every=20, return_state=True)
    u2, w2, _, it2 = tgv_cuda.tgv_denoise_pdps_cuda(
        f, *a_warm, maxiter=30, tol=1e-6, check_every=10, state0=state,
        return_state=True)
    assert u.shape == u2.shape == f.shape
    assert w.shape == w2.shape == (2, 2, 10, 12)
    assert 0 < it <= 60 and 0 < it2 <= 30
    assert _counts() == before


def test_bad_weights_and_devices_raise():
    """Other devices, maps of another shape and CPU tensors handed to the
    launch raise before any launch."""
    meta = torch.zeros((2, 8, 8), dtype=torch.float64, device="meta")
    f, a1map, _ = _case((2, 8, 8), torch.float64)
    before = _counts()
    with pytest.raises(ValueError, match="CPU or CUDA"):
        tgv_cuda.tgv_denoise_pdps_cuda(meta, 0.1, 0.2, maxiter=5)
    with pytest.raises(ValueError, match="alpha0 must be"):
        tgv_cuda.tgv_denoise_pdps_cuda(f, 0.1, a1map[:, :7], maxiter=5)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tgv_cuda._launch(f, torch.tensor(0.1), torch.tensor(0.2), None,
                         tau0=0.99, sigma0=0.99, maxiter=5, tol=1e-6,
                         check_every=5)
    assert _counts() == before


# ---- on the card

@pytest.fixture
def cuda_device():
    """The card, for tests marked ``cuda``; they skip without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (python -m pytest --noconftest "
                    "tests/test_torch_tgv_cluster.py -m cuda)")
    return torch.device("cuda")


SHAPES = ((2, 20, 24), (3, 16, 20), (3, 50, 37), (1, 8, 8), (2, 5, 7),
          (1, 3, 9), (40, 32, 32))
CHECK = 25
MODES = (("cold fixed", False, dict(maxiter=120, tol=None)),
         ("cold early stop", False, dict(maxiter=400, tol=1e-4)),
         ("warm early stop", True, dict(maxiter=400, tol=1e-5)))


def _on(a, device):
    return a.to(device) if a.ndim else a


def _run(f, a, state, device, **kw):
    """The kernel on the card → ((u, w, p, q), iters, device operations,
    cluster calls)."""
    launches, calls, ops = _counts()
    st = None if state is None else tuple(s.to(device) for s in state)
    _, _, out, it = tgv_cuda.tgv_denoise_pdps_cuda(
        f.to(device), *(_on(x, device) for x in a), state0=st,
        return_state=True, check_every=CHECK, **kw)
    torch.cuda.synchronize()
    assert tgv_cuda.launches == launches + 1
    return (tuple(s.cpu() for s in out), it, tgv_cuda.device_ops - ops,
            tgv_cuda.cluster_calls - calls)


def _plain(f, a, state, device, **kw):
    """The plain version on the card → ((u, w, p, q) on the CPU, iters)."""
    st = None if state is None else tuple(s.to(device) for s in state)
    _, _, out, it = _tgv_impl(f.to(device), *(_on(x, device) for x in a),
                              st, tau0=0.99, sigma0=0.99, return_state=True,
                              check_every=CHECK, **kw)
    return tuple(s.cpu() for s in out), it


def _plan_with(monkeypatch, **change):
    """Make the CP wrapper plan ``change`` (resident=False: the two-launch
    form, no tile plan; cluster=n: n CTAs an image) whatever the shapes."""
    real = cluster_plan.tgv_plan
    if change.get("resident", True) is False:
        monkeypatch.setattr(tgv_cuda, "tgv_tile_plan", lambda *a, **k: None)

    def plan(M, N, itemsize):
        p = real(M, N, itemsize)
        if change.get("resident", True) is False:
            return p._replace(resident=False, smem=0)
        n = change["cluster"]
        rows = -(-M // n)
        return p._replace(cluster=n, rows=rows,
                          smem=(11 * (rows + 4) + 40) * N * itemsize)

    monkeypatch.setattr(tgv_cuda, "tgv_plan", plan)


def _cluster_runs(f, a, a_warm, device):
    """The three modes on the card; the warm one starts from the plain
    version's early-stopped state."""
    runs, state = {}, None
    for name, warm, extra in MODES:
        w = a_warm if warm else a
        st = state if warm else None
        runs[name] = (_run(f, w, st, device, **extra), w, st, extra)
        state = _plain(f, w, st, device, **extra)[0]
    return runs


def _same(k, g, name):
    assert k[1] == g[1], name
    for x, y in zip(k[0], g[0]):
        assert torch.equal(x, y), name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("weight", ["scalar", "map", "mixed"])
def test_cluster_form_matches_two_launch_form_and_plain(
        cuda_device, monkeypatch, weight, shape, dtype):
    f, a1map, a0map = _case(shape, dtype)
    assert cluster_plan.tgv_plan(*shape[1:], f.element_size()).resident
    a, a_warm = _weights(weight, a1map, a0map)
    runs = _cluster_runs(f, a, a_warm, cuda_device)
    for name, (k, w, st, extra) in runs.items():
        # one launch (fixed budget) or per chunk the launch, the two passes
        # of the sums and the read, and a last copy when u ends in the
        # second buffer
        chunks = -(-k[1] // CHECK)
        want = 1 if extra["tol"] is None else 4 * chunks + chunks % 2
        assert (k[2], k[3]) == (want, 1), (name, k[2], want)
        p, p_it = _plain(f, w, st, cuda_device, **extra)
        if dtype == torch.float64:
            assert k[1] == p_it, name
            for x, y in zip(k[0], p):
                s = max(float(y.abs().max()), 1e-300)
                assert float((x - y).abs().max()) <= 1e-9 * s, name
        else:
            assert abs(k[1] - p_it) <= CHECK, name
            errs = [float((x - y).abs().max()) for x, y in zip(k[0], p)]
            assert errs[0] <= TOL_U_F32, (name, errs)
            assert max(errs[1:]) <= TOL_DUAL_F32, (name, errs)
    _plan_with(monkeypatch, resident=False)
    for name, (k, w, st, extra) in runs.items():
        g = _run(f, w, st, cuda_device, **extra)
        _same(k, g, name)
        # 2 launches an iteration; per chunk the copy into the other
        # buffer, the two passes and the read; the last copy back
        chunks = -(-g[1] // CHECK)
        want = 2 * g[1] + (0 if extra["tol"] is None
                           else 4 * chunks + chunks % 2)
        assert (g[2], g[3]) == (want, 0), (name, g[2], want)


# (shape, dtype, CTAs an image): the sizes scripts/cluster_sizes.py tgv
# times, where their bands fit in shared memory (at 128² float64 8 CTAs
# need 260 KB a band)
SIZES = [((10, 128, 128), torch.float32, 8),
         ((10, 128, 128), torch.float32, 12),
         ((10, 128, 128), torch.float64, 12),
         ((3, 40, 36), torch.float32, 8),
         ((3, 40, 36), torch.float64, 8),
         ((3, 40, 36), torch.float64, 12)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype,cluster", SIZES, ids=[
    f"{'x'.join(map(str, s))}-{str(d)[-7:]}-{c}" for s, d, c in SIZES])
@pytest.mark.parametrize("weight", ["scalar", "map"])
def test_cluster_sizes_give_the_same_bits(cuda_device, monkeypatch, weight,
                                          shape, dtype, cluster):
    """The plan's split of 16 CTAs an image gives the bits and iteration
    counts of 8 and of 12 CTAs (the sizes scripts/cluster_sizes.py tgv
    times)."""
    f, a1map, a0map = _case(shape, dtype, seed=1)
    assert cluster_plan.tgv_plan(*shape[1:], f.element_size()).cluster == 16
    a, a_warm = _weights(weight, a1map, a0map)
    sixteen = _cluster_runs(f, a, a_warm, cuda_device)
    _plan_with(monkeypatch, cluster=cluster)
    for name, (k, w, st, extra) in sixteen.items():
        g = _run(f, w, st, cuda_device, **extra)
        assert g[3] == 1, name
        _same(k, g, name)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_constant_map_gives_the_scalar_bits(cuda_device, dtype):
    """Constant (M, N) maps of α₁ and α₀ give the scalar weights' bits,
    cold and early-stopped."""
    f, _, _ = _case((3, 50, 37), dtype, seed=2)
    scalar = (torch.tensor(0.1, dtype=dtype), torch.tensor(0.15, dtype=dtype))
    const = tuple(torch.full((50, 37), float(v), dtype=dtype)
                  for v in scalar)
    for extra in (dict(maxiter=120, tol=None), dict(maxiter=400, tol=1e-4)):
        _same(_run(f, scalar, None, cuda_device, **extra),
              _run(f, const, None, cuda_device, **extra), str(extra))


@pytest.mark.cuda
def test_bands_that_do_not_fit_run_the_two_launch_form(cuda_device,
                                                        monkeypatch):
    """At 1×1024² float32 (row 5's shape) the bands do not fit: the plan
    runs the tile form (csrc/tgv_tile.cu, no cluster call), and the
    two-launch form it replaced, which no shape plans (forced here: no
    tile plan), runs 2 launches an iteration and gives its bits; both the
    plain version's numbers (the plain version on the card)."""
    f, _, _ = _case((1, 1024, 1024), torch.float32)
    assert not cluster_plan.tgv_plan(1024, 1024, 4).resident
    a = (torch.tensor(0.1), torch.tensor(0.2))
    tiled = tgv_cuda.tiled_calls
    k = _run(f, a, None, cuda_device, maxiter=30, tol=None)
    assert (k[1], k[3], tgv_cuda.tiled_calls - tiled) == (30, 0, 1)
    monkeypatch.setattr(tgv_cuda, "tgv_tile_plan", lambda *x, **kw: None)
    g = _run(f, a, None, cuda_device, maxiter=30, tol=None)
    assert (g[1], g[2], g[3]) == (30, 60, 0)
    _same(k, g, "1024")
    p, _ = _plain(f, a, None, cuda_device, maxiter=30, tol=None)
    errs = [float((x - y).abs().max()) for x, y in zip(k[0], p)]
    assert errs[0] <= TOL_U_F32 and max(errs[1:]) <= TOL_DUAL_F32, errs


@pytest.mark.cuda
def test_bad_inputs_raise_before_the_device(cuda_device):
    """Other dtypes, states of the wrong arity, shape, dtype or device
    raise before any launch or device operation."""
    f, _, _ = _case((2, 8, 8), torch.float32)
    f = f.to(cuda_device)
    _, _, state, _ = tgv_cuda.tgv_denoise_pdps_cuda(f, 0.1, 0.2, maxiter=5,
                                                    return_state=True)
    before = _counts()
    with pytest.raises(TypeError, match="float32/float64"):
        tgv_cuda.tgv_denoise_pdps_cuda(f.half(), 0.1, 0.2, maxiter=5)
    bad_states = (state[:3], state + (state[0],),
                  (state[0], state[1][:, :1], state[2], state[3]),
                  (state[0].double(),) + state[1:],
                  (state[0].cpu(),) + state[1:])
    for bad in bad_states:
        with pytest.raises(ValueError, match="TGV state|state0"):
            tgv_cuda.tgv_denoise_pdps_cuda(f, 0.1, 0.2, maxiter=5,
                                           state0=bad)
    assert _counts() == before


@pytest.mark.cuda
def test_refused_plan_raises(cuda_device, monkeypatch):
    """A plan the card cannot run (one CTA holding a 1024² image's bands,
    ~46 MB of shared memory) raises; it is not retried in another form."""
    real = cluster_plan.tgv_plan

    def one_cta(M, N, itemsize):
        return real(M, N, itemsize)._replace(
            cluster=1, rows=M, resident=True,
            smem=(11 * (M + 4) + 40) * N * itemsize)

    monkeypatch.setattr(tgv_cuda, "tgv_plan", one_cta)
    f, _, _ = _case((1, 1024, 1024), torch.float32)
    before = _counts()
    with pytest.raises(RuntimeError, match="tgv kernel"):
        _run(f, (torch.tensor(0.1), torch.tensor(0.2)), None, cuda_device,
             maxiter=10, tol=None)
    assert tgv_cuda.device_ops == before[2]
