"""The TV-L1 kernel's cluster form (``csrc/tvl1.cu``: one launch per
early-stop chunk, a thread-block cluster an image, the bands of
``csrc/pd_cluster.cuh``) and its plan.

- On the CPU: the plan (``solvers/tvl1_cuda.py::tvl1_plan``:
  ``solvers/cluster_plan.py::pd_plan`` with one forward-difference dual
  block, up to 16 CTAs an image for batches of up to 8 images) for the
  TV-L1 shapes: the learns' and ``TVL1Denoise``'s 1×128² in float32 and
  float64, the 64×128² batch, 2×32², uneven bands, and shapes whose bands
  do not fit in shared memory (the two-launch form runs there); the plan's
  argument leaves kernel A's and the single-loop learner's plans as they
  were; CPU calls count no launch and no device operation; bad states and
  other devices raise.
- On the card (marked ``cuda``; they skip without one): the cluster form
  against the two-launch form and against the plain version, in both forms
  (plain and Huber), with a scalar and a map α, float64 and float32, on
  uneven bands, the smallest images and more images than one wave of
  clusters holds; cold with a fixed budget, cold with the early stop,
  warm.  The two kernel forms run the same operations in the same order
  (``-fmad=false``), so they must agree bit for bit with equal iteration
  counts; so must 8 and 16 CTAs an image (a halo row is recomputed with
  the owner's operations).  Against the plain version: float64 at 1e-9
  relative with equal iteration counts; float32 at ``chip_smoke.py``'s
  TV-L1 tolerances (u 1e-4, y 1e-3 absolute) with counts within one
  check.  Each call counts one launch and the device operations of its
  form; a plan the card refuses raises.

This file imports no JAX, so the card's tests also run where JAX is not
installed: ``python -m pytest --noconftest tests/test_torch_tvl1_cluster.py
-m cuda``.
"""

import numpy as np
import pytest
import torch

from bpldenoising_tpu_torch.solvers import cluster_plan, tvl1_cuda
from bpldenoising_tpu_torch.solvers.tvl1 import _tvl1_loop, step_sizes
from bpldenoising_tpu_torch.solvers.tvl1_huber import _tvl1_huber_loop

HUBER = dict(gamma_d=100.0, gamma_r=1000.0)
# chip_smoke.py's TOL_TVL1_U_F32 / TOL_TVL1_Y_F32
TOL_U_F32, TOL_Y_F32 = 1e-4, 1e-3


@pytest.mark.parametrize("O,M,N,itemsize,cluster,rows,resident", [
    (1, 128, 128, 4, 16, 8, True),    # the learns, TVL1Denoise: 32 KB a CTA
    (1, 128, 128, 8, 16, 8, True),    # float64: 64 KB
    (8, 128, 128, 4, 16, 8, True),    # 8 clusters of 16: 128 of 132 SMs
    (9, 128, 128, 4, 8, 16, True),    # 48 KB
    (64, 128, 128, 4, 8, 16, True),   # the batch: 64 clusters of 8
    (2, 32, 32, 8, 16, 2, True),
    (2, 20, 24, 8, 8, 3, True),       # the 8th CTA owns 21 − 20 rows: none
    (1, 5, 7, 8, 2, 3, True),         # the second CTA owns two rows
    (1, 3, 9, 4, 1, 3, True),         # one CTA: no neighbour
    (1, 256, 256, 8, 16, 16, True),   # 192 KB
    (64, 256, 256, 8, 8, 32, False),  # 320 KB: the two-launch form
    (1, 512, 512, 4, 16, 32, False),  # 320 KB
])
def test_tvl1_plan(O, M, N, itemsize, cluster, rows, resident):
    """The TV-L1 kernel's plan from the shapes: kernel A's rule at K = 1
    (u, ū and the two dual planes on rows + 4 rows, 16 halo-slot rows; the
    cluster form when that fits in 227 KB), up to 16 CTAs an image while
    O·16 ≤ 132, else up to 8."""
    plan = tvl1_cuda.tvl1_plan(O, M, N, itemsize)
    assert (plan.cluster, plan.rows, plan.resident) == (cluster, rows,
                                                        resident)
    band = (4 * (rows + 4) + 16) * N * itemsize
    assert plan.planes == 4
    assert plan.smem == (band if resident else 0)
    assert (band <= cluster_plan.SMEM_PER_BLOCK) == resident


def test_plan_argument_leaves_the_other_band_kernels_alone():
    """The TV-L1 wrapper plans with ``solvers/cluster_plan.py``; its
    cluster argument defaults to the portable 8, which kernel A and the
    single-loop learner keep at every batch; it takes 1 to 16."""
    assert tvl1_cuda.pd_plan is cluster_plan.pd_plan
    for K, itemsize in ((1, 4), (3, 4), (3, 8)):
        assert cluster_plan.pd_plan(128, 128, K, itemsize).cluster == 8
    assert cluster_plan.pd_plan(128, 128, 1, 4) == cluster_plan.PdPlan(
        8, 16, 4, 49152, True)
    assert cluster_plan.pd_plan(128, 128, 1, 4, max_cluster=16) \
        == cluster_plan.PdPlan(16, 8, 4, 32768, True)
    assert cluster_plan.pd_plan(128, 128, 1, 4, max_cluster=2).cluster == 2
    for bad in (0, 17, 32):
        with pytest.raises(ValueError, match="max_cluster"):
            cluster_plan.pd_plan(128, 128, 1, 4, max_cluster=bad)


def _case(shape, dtype, seed=0):
    """f (O, M, N): discs under 20% salt-and-pepper noise, and an (M, N)
    α map, both made with numpy from a seed."""
    rng = np.random.default_rng(seed)
    O, M, N = shape
    yy, xx = np.meshgrid(np.arange(M), np.arange(N), indexing="ij")
    clean = np.stack([0.2 + 0.6 * ((xx - N / 2 - b % 3) ** 2
                                   + (yy - M / 2) ** 2
                                   < (min(M, N) / 3) ** 2)
                      for b in range(O)])
    f = clean.copy()
    hit = rng.random(clean.shape) < 0.2
    f[hit] = rng.integers(0, 2, int(hit.sum()))
    amap = 0.5 + 0.6 * rng.random((M, N))
    return torch.as_tensor(f, dtype=dtype), torch.as_tensor(amap,
                                                            dtype=dtype)


def _solve(form, f, a, state, **kw):
    """The wrapper of ``form`` → (u, y, iters)."""
    if form == "plain":
        u, (_, y), it = tvl1_cuda.tvl1_denoise_cuda(
            f, a, state0=state, return_dual=True, **kw)
        return u, y, it
    u, (_, y) = tvl1_cuda.tvl1_huber_denoise_cuda(
        f, a, state0=state, return_dual=True, **HUBER, **kw)
    return u, y, tvl1_cuda.last_iters


@pytest.mark.parametrize("form", ["plain", "huber"])
def test_cpu_calls_issue_no_device_operations(form):
    """On CPU tensors the wrappers run the plain versions and count no
    launch, no cluster call and no device operation: cold with a fixed
    budget and the early stop, scalar and map α, warm."""
    f, amap = _case((2, 10, 12), torch.float64)
    before = (tvl1_cuda.launches, tvl1_cuda.cluster_calls,
              tvl1_cuda.device_ops)
    u, y, _ = _solve(form, f, 0.8, None, maxiter=40, tol=None)
    _solve(form, f, amap, None, maxiter=60, tol=1e-6, check_every=20)
    u2, y2, _ = _solve(form, f, 0.9, (u, y), maxiter=30, tol=1e-6,
                       check_every=10)
    assert u2.shape == f.shape and y2.shape == (2, 2, 10, 12)
    assert (tvl1_cuda.launches, tvl1_cuda.cluster_calls,
            tvl1_cuda.device_ops) == before


def test_bad_states_and_devices_raise():
    """Other devices, states of the wrong arity and CPU tensors handed to
    the launch raise before any launch."""
    meta = torch.zeros((2, 8, 8), dtype=torch.float64, device="meta")
    f, _ = _case((2, 8, 8), torch.float64)
    before = tvl1_cuda.launches, tvl1_cuda.device_ops
    for form in ("plain", "huber"):
        with pytest.raises(ValueError, match="CPU or CUDA"):
            _solve(form, meta, 0.8, None, maxiter=5)
        for bad in ((f,), (f, f, f, f)):
            with pytest.raises(ValueError, match="TV-L1 state"):
                _solve(form, f, 0.8, bad, maxiter=5)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tvl1_cuda._launch(f, torch.tensor(0.8), None, tau=0.1, sigma=0.1,
                          huber=True, maxiter=5, tol=1e-6, check_every=5)
    assert (tvl1_cuda.launches, tvl1_cuda.device_ops) == before


# ---- on the card

@pytest.fixture
def cuda_device():
    """The card, for tests marked ``cuda``; they skip without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (python -m pytest --noconftest "
                    "tests/test_torch_tvl1_cluster.py -m cuda)")
    return torch.device("cuda")


SHAPES = ((2, 20, 24), (3, 16, 20), (1, 8, 8), (2, 5, 7), (1, 3, 9),
          (40, 32, 32))
CHECK = 25
MODES = (("cold fixed", False, dict(maxiter=120, tol=None)),
         ("cold early stop", False, dict(maxiter=400, tol=1e-4)),
         ("warm early stop", True, dict(maxiter=400, tol=1e-5)))


def _run(form, f, a, state, device, **kw):
    """The kernel on the card → (u, y, iters, device operations, cluster
    calls)."""
    ops, launches = tvl1_cuda.device_ops, tvl1_cuda.launches
    calls = tvl1_cuda.cluster_calls
    st = None if state is None else tuple(s.to(device) for s in state)
    u, y, it = _solve(form, f.to(device), a.to(device) if a.ndim else a,
                      st, check_every=CHECK, **kw)
    torch.cuda.synchronize()
    assert tvl1_cuda.launches == launches + 1
    return (u.cpu(), y.cpu(), it, tvl1_cuda.device_ops - ops,
            tvl1_cuda.cluster_calls - calls)


def _plain(form, f, a, state, **kw):
    """The plain version on the CPU → (u, y, iters)."""
    tau, sigma = step_sizes(0.99, 0.99, f.dtype)
    loop = _tvl1_loop if form == "plain" else _tvl1_huber_loop
    extra = {} if form == "plain" else HUBER
    return loop(f, torch.as_tensor(a, dtype=f.dtype), state, tau=tau,
                sigma=sigma, check_every=CHECK, **extra, **kw)


def _plan_with(monkeypatch, **change):
    """Make the wrapper plan ``change`` (resident=False: the two-launch
    form; cluster=n: n CTAs an image) whatever the shapes."""
    real = cluster_plan.pd_plan

    def plan(M, N, K, itemsize, **kw):
        p = real(M, N, K, itemsize, **kw)
        if change.get("resident", True) is False:
            return p._replace(resident=False, smem=0)
        n = change["cluster"]
        rows = -(-M // n)
        return p._replace(cluster=n, rows=rows, smem=(4 * (rows + 4) + 16)
                          * N * itemsize)

    monkeypatch.setattr(tvl1_cuda, "pd_plan", plan)


def _weights(kind, amap):
    a = torch.tensor(0.8, dtype=amap.dtype) if kind == "scalar" else amap
    return a, 0.9 * a


def _cluster_runs(form, f, a, a_warm, device):
    """The three modes on the card; the warm one starts from the plain
    version's early-stopped state."""
    runs, state = {}, None
    for name, warm, extra in MODES:
        w = a_warm if warm else a
        st = state if warm else None
        runs[name] = (_run(form, f, w, st, device, **extra), w, st, extra)
        state = _plain(form, f, w, st, **extra)[:2]
    return runs


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("weight", ["scalar", "map"])
@pytest.mark.parametrize("form", ["plain", "huber"])
def test_cluster_form_matches_two_launch_form_and_plain(
        cuda_device, monkeypatch, form, weight, shape, dtype):
    f, amap = _case(shape, dtype)
    assert tvl1_cuda.tvl1_plan(*shape, f.element_size()).resident
    a, a_warm = _weights(weight, amap)
    runs = _cluster_runs(form, f, a, a_warm, cuda_device)
    for name, (k, w, st, extra) in runs.items():
        # one launch (fixed budget) or per chunk the launch, the two passes
        # of the sums and the read, and a last copy when u ends in the
        # second buffer
        chunks = -(-k[2] // CHECK)
        want = 1 if extra["tol"] is None else 4 * chunks + chunks % 2
        assert (k[3], k[4]) == (want, 1), (name, k[3], want)
        p = _plain(form, f, w, st, **extra)
        if dtype == torch.float64:
            assert k[2] == p[2], name
            for x, y in ((k[0], p[0]), (k[1], p[1])):
                s = max(float(y.abs().max()), 1e-300)
                assert float((x - y).abs().max()) <= 1e-9 * s, name
        else:
            assert abs(k[2] - p[2]) <= CHECK, name
            assert float((k[0] - p[0]).abs().max()) <= TOL_U_F32, name
            assert float((k[1] - p[1]).abs().max()) <= TOL_Y_F32, name
    _plan_with(monkeypatch, resident=False)
    for name, (k, w, st, extra) in runs.items():
        g = _run(form, f, w, st, cuda_device, **extra)
        assert g[2] == k[2], name
        assert torch.equal(g[0], k[0]) and torch.equal(g[1], k[1]), name
        # 2 launches an iteration; per chunk the copy into the other
        # buffer, the two passes and the read; the last copy back
        chunks = -(-g[2] // CHECK)
        want = 2 * g[2] + (0 if extra["tol"] is None
                           else 4 * chunks + chunks % 2)
        assert (g[3], g[4]) == (want, 0), (name, g[3], want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("shape", [(1, 128, 128), (3, 40, 36)],
                         ids=["1x128x128", "3x40x36"])
@pytest.mark.parametrize("weight", ["scalar", "map"])
@pytest.mark.parametrize("form", ["plain", "huber"])
def test_sixteen_ctas_give_the_bits_of_eight(cuda_device, monkeypatch, form,
                                             weight, shape, dtype):
    """The plan's band split of 16 CTAs an image (a non-portable cluster)
    gives the bits and iteration counts of 8 CTAs."""
    f, amap = _case(shape, dtype, seed=1)
    assert tvl1_cuda.tvl1_plan(*shape, f.element_size()).cluster == 16
    a, a_warm = _weights(weight, amap)
    sixteen = _cluster_runs(form, f, a, a_warm, cuda_device)
    _plan_with(monkeypatch, cluster=8)
    for name, (k, w, st, extra) in sixteen.items():
        g = _run(form, f, w, st, cuda_device, **extra)
        assert g[2] == k[2] and g[4] == 1, name
        assert torch.equal(g[0], k[0]) and torch.equal(g[1], k[1]), name


@pytest.mark.cuda
def test_bands_that_do_not_fit_run_the_two_launch_form(cuda_device):
    """At 1×512² float32 the plan runs the two-launch form: 2 launches an
    iteration, no cluster call, the plain version's numbers."""
    f, _ = _case((1, 512, 512), torch.float32)
    assert not tvl1_cuda.tvl1_plan(1, 512, 512, 4).resident
    for form in ("plain", "huber"):
        k = _run(form, f, torch.tensor(0.8), None, cuda_device, maxiter=30,
                 tol=None)
        assert (k[2], k[3], k[4]) == (30, 60, 0), form
        p = _plain(form, f, 0.8, None, maxiter=30, tol=None)
        assert float((k[0] - p[0]).abs().max()) <= TOL_U_F32, form
        assert float((k[1] - p[1]).abs().max()) <= TOL_Y_F32, form


@pytest.mark.cuda
def test_refused_plan_raises(cuda_device, monkeypatch):
    """A plan the card cannot run (one CTA holding a 1024² image's bands,
    ~16.9 MB of shared memory) raises; it is not retried in another form."""
    real = cluster_plan.pd_plan

    def one_cta(M, N, K, itemsize, **kw):
        return real(M, N, K, itemsize, **kw)._replace(
            cluster=1, rows=M, resident=True,
            smem=(4 * (M + 4) + 16) * N * itemsize)

    monkeypatch.setattr(tvl1_cuda, "pd_plan", one_cta)
    f, _ = _case((1, 1024, 1024), torch.float32)
    before = tvl1_cuda.device_ops
    with pytest.raises(RuntimeError, match="tvl1 kernel"):
        _run("huber", f, torch.tensor(0.8), None, cuda_device, maxiter=10,
             tol=None)
    assert tvl1_cuda.device_ops == before
