"""The VTV CP kernel's cluster form (``csrc/vtv.cu``: one launch per
early-stop chunk, a thread-block cluster an image, the bands of
``csrc/vtv_cluster.cuh``) and its plan.

- On the CPU: the plan (``solvers/cluster_plan.py::vtv_plan``, which the
  single-loop VTV learner also takes) for the VTV shapes: the learns'
  6×3×128² in float32 and float64, 2×3×32², 1×3×256² (the bands do not
  fit in shared memory: the two-launch form runs there), uneven bands, two
  channels; the CP wrapper and the learner plan by the one rule; CPU calls
  count no launch, no cluster call and no device operation and match the
  JAX package's jnp path in float64; bad carries, weights, devices and CPU
  tensors handed to the launch raise.
- On the card (marked ``cuda``; they skip without one): the cluster form
  against the two-launch form and against the plain version, with a
  scalar and a map α, float64 and float32, on 1 to 6 images of 3×32² to
  3×128², uneven bands, two channels and the smallest images; cold with a
  fixed budget, cold with the early stop, warm.  The two kernel forms run
  the same operations in the same order (``-fmad=false``), so they must
  agree bit for bit with equal iteration counts; so must 8 and 16 CTAs an
  image (a halo row is recomputed with the owner's operations), and a
  constant map must give the scalar run's bits.  Against the plain
  version: float64 at 1e-9 relative with equal iteration counts; float32
  at ``chip_smoke.py``'s VTV tolerances (u 1e-4, y 1e-3 absolute) with
  counts within one check.  Each call counts one launch and the device
  operations of its form; bad inputs and a plan the card refuses raise.

The card's tests import no JAX, so they also run where JAX is not
installed: ``python -m pytest --noconftest tests/test_torch_vtv_cluster.py
-m cuda``.
"""

import numpy as np
import pytest
import torch

from bpldenoising_tpu_torch.bilevel import first_order_vtv_cuda
from bpldenoising_tpu_torch.models import vtv_model
from bpldenoising_tpu_torch.solvers import cluster_plan, vtv_cuda
from bpldenoising_tpu_torch.solvers.pdps import _denoise_pdps_impl

# chip_smoke.py's TOL_VTV_U_F32 / TOL_VTV_Y_F32
TOL_U_F32, TOL_Y_F32 = 1e-4, 1e-3


@pytest.mark.parametrize("M,N,C,itemsize,cluster,rows,resident", [
    (128, 128, 3, 4, 16, 8, True),     # the VTV learns: 96 KB a CTA
    (128, 128, 3, 8, 16, 8, True),     # float64: 192 KB
    (32, 32, 3, 8, 16, 2, True),       # the float64 phase's 2×3×32²
    (256, 256, 3, 4, 16, 16, False),   # 288 KB: the two-launch form
    (256, 256, 3, 8, 16, 16, False),
    (50, 37, 3, 4, 16, 4, True),       # CTA 12 owns 2 rows, 13–15 none
    (20, 24, 2, 8, 8, 3, True),        # two channels; the last CTA 1 row
    (3, 9, 3, 4, 1, 3, True),          # one CTA: no neighbour
])
def test_vtv_plan(M, N, C, itemsize, cluster, rows, resident):
    """The VTV CP kernel's plan from the shapes: the largest power of two
    up to 16 CTAs that leaves every CTA but the last two rows, and the
    band of the 4C planes on rows + 4 rows and 16C halo-slot rows in
    shared memory where it fits in 227 KB (else the two-launch form)."""
    plan = cluster_plan.vtv_plan(M, N, C, itemsize)
    assert (plan.cluster, plan.rows, plan.resident) == (cluster, rows,
                                                        resident)
    band = (4 * C * (rows + 4) + 16 * C) * N * itemsize
    assert plan.planes == 4 * C
    assert plan.smem == (band if resident else 0)
    assert (band <= cluster_plan.SMEM_PER_BLOCK) == resident


def test_cp_solve_and_learner_plan_by_one_rule():
    """The CP wrapper (row 6) and the single-loop VTV learner (row 13) take
    the same ``vtv_plan``: 16 CTAs of 8 rows at 3×128² in both dtypes."""
    assert vtv_cuda.vtv_plan is cluster_plan.vtv_plan
    assert first_order_vtv_cuda.vtv_plan is cluster_plan.vtv_plan
    assert cluster_plan.vtv_plan(128, 128, 3, 4) == cluster_plan.PdPlan(
        16, 8, 12, 98304, True)
    assert cluster_plan.vtv_plan(128, 128, 3, 8) == cluster_plan.PdPlan(
        16, 8, 12, 196608, True)


def _case(shape, dtype, seed=0):
    """f (O, C, M, N) (or (C, M, N)): per channel a ramp, a step and a disc
    of its own brightness under Gaussian noise, and an (M, N) α map, all
    made with numpy from a seed."""
    rng = np.random.default_rng(seed)
    *lead, C, M, N = shape
    O = int(np.prod(lead)) if lead else 1
    yy, xx = np.meshgrid(np.arange(M), np.arange(N), indexing="ij")
    disc = (xx - N / 2) ** 2 + (yy - M / 3) ** 2 < (min(M, N) / 4) ** 2
    clean = np.stack([np.stack([0.2 + 0.3 * rng.random() * (yy > M // 2)
                                + 0.5 * rng.random() * disc
                                + 0.01 * c * xx / N
                                for c in range(C)]) for _ in range(O)])
    f = (clean + 0.1 * rng.standard_normal(clean.shape)).reshape(shape)
    amap = 0.08 + 0.1 * rng.random((M, N))
    return torch.as_tensor(f, dtype=dtype), torch.as_tensor(amap,
                                                            dtype=dtype)


def _weights(kind, amap):
    """α and the nudged α of a warm start: a scalar or a map."""
    a = torch.tensor(0.12, dtype=amap.dtype) if kind == "scalar" else amap
    return a, 1.05 * a


def _counts():
    return vtv_cuda.launches, vtv_cuda.cluster_calls, vtv_cuda.device_ops


@pytest.mark.parametrize("shape", [(2, 3, 12, 10), (3, 11, 9)],
                         ids=["stack", "single"])
@pytest.mark.parametrize("kind", ["scalar", "map"])
def test_cpu_calls_count_nothing_and_match_jax(kind, shape):
    """On CPU tensors the wrapper runs the plain version: it counts no
    launch, no cluster call and no device operation, and matches the JAX
    package's VTV solve (solvers/pdps.py::vtv_denoise, its jnp path) at
    1e-9 in float64, cold with a fixed budget, cold with the early stop and
    warm from that state, with equal iteration counts."""
    import jax.numpy as jnp
    from bpldenoising_tpu.solvers.pdps import vtv_denoise as j_vtv_denoise

    f, amap = _case(shape, torch.float64)
    a, a_warm = _weights(kind, amap)
    before = _counts()
    fj = jnp.asarray(f.numpy())
    state = jstate = None
    for alpha, warm, kw in (
            (a, False, dict(maxiter=40, tol=None, check_every=10)),
            (a, False, dict(maxiter=200, tol=1e-5, check_every=20)),
            (a_warm, True, dict(maxiter=200, tol=1e-6, check_every=25))):
        u, (y,), it = vtv_cuda.vtv_denoise_pdps_cuda(
            f, (alpha,), state if warm else None, return_dual=True, **kw)
        ju, (jy,), jit = j_vtv_denoise(
            fj, jnp.asarray(alpha.numpy()), state0=jstate if warm else None,
            return_dual=True, **kw)
        assert it == int(jit) == vtv_cuda.last_iters, kw
        assert u.shape == f.shape and y.shape == tuple(jy.shape)
        for x, j in ((u, ju), (y, jy)):
            j = np.asarray(j)
            scale = max(float(np.abs(j).max()), 1e-300)
            assert float(np.abs(x.numpy() - j).max()) <= 1e-9 * scale, kw
        state, jstate = (u, (y,)), (ju, (jy,))
    assert _counts() == before


def test_bad_inputs_raise_before_the_device():
    """Other devices, more than one weight, states of another arity and
    CPU tensors handed to the launch raise before any launch."""
    f, amap = _case((2, 3, 8, 8), torch.float64)
    meta = torch.zeros((2, 3, 8, 8), dtype=torch.float64, device="meta")
    before = _counts()
    with pytest.raises(ValueError, match="CPU or CUDA"):
        vtv_cuda.vtv_denoise_pdps_cuda(meta, (0.1,), maxiter=5)
    with pytest.raises(ValueError, match="one weight"):
        vtv_cuda.vtv_denoise_pdps_cuda(f, (0.1, amap), maxiter=5)
    with pytest.raises(ValueError, match="VTV state"):
        vtv_cuda.vtv_denoise_pdps_cuda(f, (0.1,), (f,) * 4, maxiter=5)
    with pytest.raises(ValueError, match="CUDA tensor"):
        vtv_cuda._launch(f, amap, None, tau=0.1, sigma=0.1, gamma=1.0,
                         accel=True, maxiter=5, tol=1e-6, check_every=5)
    assert _counts() == before


# ---- on the card

@pytest.fixture
def cuda_device():
    """The card, for tests marked ``cuda``; they skip without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (python -m pytest --noconftest "
                    "tests/test_torch_vtv_cluster.py -m cuda)")
    return torch.device("cuda")


# 1–6 images of 3×32² to 3×128², uneven bands, two channels, a single
# image without a batch axis, the smallest images
SHAPES = ((6, 3, 128, 128), (2, 3, 32, 32), (3, 3, 50, 37), (1, 3, 20, 24),
          (2, 2, 20, 24), (3, 24, 16), (1, 3, 8, 8), (2, 3, 5, 7),
          (1, 3, 3, 9))
CHECK = 25
MODES = (("cold fixed", False, dict(maxiter=120, tol=None)),
         ("cold early stop", False, dict(maxiter=400, tol=1e-4)),
         ("warm early stop", True, dict(maxiter=400, tol=1e-5)))


def _on(a, device):
    return a.to(device) if a.ndim else a


def _state_on(state, device):
    return None if state is None else (state[0].to(device),
                                       (state[1][0].to(device),))


def _run(f, a, state, device, **kw):
    """The kernel on the card → ((u, y), iters, device operations, cluster
    calls)."""
    launches, calls, ops = _counts()
    u, (y,), it = vtv_cuda.vtv_denoise_pdps_cuda(
        f.to(device), (_on(a, device),), _state_on(state, device),
        return_dual=True, check_every=CHECK, **kw)
    torch.cuda.synchronize()
    assert vtv_cuda.launches == launches + 1
    assert it == vtv_cuda.last_iters
    return ((u.cpu(), y.cpu()), it, vtv_cuda.device_ops - ops,
            vtv_cuda.cluster_calls - calls)


def _plain(f, a, state, device, **kw):
    """The plain version on the card → ((u, y) on the CPU, iters)."""
    fd = f.to(device)
    u, (y,), it = _denoise_pdps_impl(
        fd, (torch.as_tensor(_on(a, device), dtype=fd.dtype),),
        _state_on(state, device), model=vtv_model(), tau0=5.0,
        sigma0=0.99 / 5.0, gamma=1.0, accel=True, return_dual=True,
        check_every=CHECK, **kw)
    return (u.cpu(), y.cpu()), it


def _plan_with(monkeypatch, **change):
    """Make the CP wrapper plan ``change`` (resident=False: the two-launch
    form; cluster=n: n CTAs an image) whatever the shapes."""
    real = cluster_plan.vtv_plan

    def plan(M, N, C, itemsize):
        p = real(M, N, C, itemsize)
        if change.get("resident", True) is False:
            return p._replace(resident=False, smem=0)
        n = change["cluster"]
        rows = -(-M // n)
        return p._replace(cluster=n, rows=rows,
                          smem=(4 * C * (rows + 4) + 16 * C) * N * itemsize)

    monkeypatch.setattr(vtv_cuda, "vtv_plan", plan)


def _cluster_runs(f, a, a_warm, device):
    """The three modes on the card; the warm one starts from the plain
    version's early-stopped state."""
    runs, state = {}, None
    for name, warm, extra in MODES:
        w = a_warm if warm else a
        st = state if warm else None
        runs[name] = (_run(f, w, st, device, **extra), w, st, extra)
        out = _plain(f, w, st, device, **extra)[0]
        state = (out[0], (out[1],))
    return runs


def _same(k, g, name):
    assert k[1] == g[1], name
    for x, y in zip(k[0], g[0]):
        assert torch.equal(x, y), name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("weight", ["scalar", "map"])
def test_cluster_form_matches_two_launch_form_and_plain(
        cuda_device, monkeypatch, weight, shape, dtype):
    f, amap = _case(shape, dtype)
    assert cluster_plan.vtv_plan(*shape[-2:], shape[-3],
                                 f.element_size()).resident
    a, a_warm = _weights(weight, amap)
    runs = _cluster_runs(f, a, a_warm, cuda_device)
    for name, (k, w, st, extra) in runs.items():
        # the table copy, then one launch (fixed budget) or per chunk the
        # launch, pd_change and the read, and a last copy when u ends in
        # the second buffer
        chunks = -(-k[1] // CHECK)
        want = 2 if extra["tol"] is None else 1 + 3 * chunks + chunks % 2
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
            assert errs[0] <= TOL_U_F32 and errs[1] <= TOL_Y_F32, (name,
                                                                   errs)
    _plan_with(monkeypatch, resident=False)
    for name, (k, w, st, extra) in runs.items():
        g = _run(f, w, st, cuda_device, **extra)
        _same(k, g, name)
        # 2 launches an iteration; per chunk the copy of u, pd_change and
        # the read
        chunks = -(-g[1] // CHECK)
        want = 2 * g[1] + (0 if extra["tol"] is None else 3 * chunks)
        assert (g[2], g[3]) == (want, 0), (name, g[2], want)


# (shape, dtype): 8 CTAs an image against the plan's 16, where the 8-CTA
# bands fit in shared memory (at 3×128² float64 they need 288 KB)
SIZES = [((6, 3, 128, 128), torch.float32),
         ((1, 3, 128, 128), torch.float32),
         ((3, 3, 40, 36), torch.float32),
         ((3, 3, 40, 36), torch.float64)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype", SIZES, ids=[
    f"{'x'.join(map(str, s))}-{str(d)[-7:]}" for s, d in SIZES])
@pytest.mark.parametrize("weight", ["scalar", "map"])
def test_cluster_sizes_give_the_same_bits(cuda_device, monkeypatch, weight,
                                          shape, dtype):
    """The plan's 16 CTAs an image give the bits and iteration counts of 8
    CTAs (the sizes scripts/cluster_sizes.py vtv times)."""
    f, amap = _case(shape, dtype, seed=1)
    assert cluster_plan.vtv_plan(*shape[-2:], shape[-3],
                                 f.element_size()).cluster == 16
    a, a_warm = _weights(weight, amap)
    sixteen = _cluster_runs(f, a, a_warm, cuda_device)
    _plan_with(monkeypatch, cluster=8)
    for name, (k, w, st, extra) in sixteen.items():
        g = _run(f, w, st, cuda_device, **extra)
        assert g[3] == 1, name
        _same(k, g, name)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_constant_map_gives_the_scalar_bits(cuda_device, dtype):
    """A constant (M, N) map gives the scalar weight's bits, cold and
    early-stopped."""
    f, _ = _case((3, 3, 50, 37), dtype, seed=2)
    scalar = torch.tensor(0.12, dtype=dtype)
    const = torch.full((50, 37), 0.12, dtype=dtype)
    for extra in (dict(maxiter=120, tol=None), dict(maxiter=400, tol=1e-4)):
        _same(_run(f, scalar, None, cuda_device, **extra),
              _run(f, const, None, cuda_device, **extra), str(extra))


@pytest.mark.cuda
def test_bands_that_do_not_fit_run_the_two_launch_form(cuda_device):
    """At 1×3×256² float32 the plan runs the two-launch form: 2 launches an
    iteration, no cluster call, the plain version's numbers (the plain
    version on the card)."""
    f, amap = _case((1, 3, 256, 256), torch.float32)
    assert not cluster_plan.vtv_plan(256, 256, 3, 4).resident
    for a in (torch.tensor(0.12), amap):
        k = _run(f, a, None, cuda_device, maxiter=30, tol=None)
        assert (k[1], k[2], k[3]) == (30, 60, 0)
        p, _ = _plain(f, a, None, cuda_device, maxiter=30, tol=None)
        errs = [float((x - y).abs().max()) for x, y in zip(k[0], p)]
        assert errs[0] <= TOL_U_F32 and errs[1] <= TOL_Y_F32, errs


@pytest.mark.cuda
def test_bad_inputs_raise_before_the_device(cuda_device):
    """Other dtypes, maps of another shape and states of the wrong shape,
    dtype or device raise before any launch or device operation."""
    f, amap = _case((2, 3, 8, 8), torch.float32)
    f = f.to(cuda_device)
    u, (y,), _ = vtv_cuda.vtv_denoise_pdps_cuda(f, (0.1,), maxiter=5,
                                                return_dual=True)
    before = _counts()
    with pytest.raises(TypeError, match="float32/float64"):
        vtv_cuda.vtv_denoise_pdps_cuda(f.half(), (0.1,), maxiter=5)
    with pytest.raises(NotImplementedError, match="scalar α or one"):
        vtv_cuda.vtv_denoise_pdps_cuda(f, (amap[:, :7],), maxiter=5)
    bad_states = ((u[:1], (y,)), (u, (y[..., :7],)), (u, (y.cpu(),)),
                  (u.cpu(), (y,)))
    for bad in bad_states:
        with pytest.raises(ValueError, match="state0"):
            vtv_cuda.vtv_denoise_pdps_cuda(f, (0.1,), bad, maxiter=5)
    assert _counts() == before


@pytest.mark.cuda
def test_refused_plan_raises(cuda_device, monkeypatch):
    """A plan the card cannot run (one CTA holding a 3×256² image's bands,
    ~3 MB of shared memory) raises; it is not retried in another form."""
    real = cluster_plan.vtv_plan

    def one_cta(M, N, C, itemsize):
        return real(M, N, C, itemsize)._replace(
            cluster=1, rows=M, resident=True,
            smem=(4 * C * (M + 4) + 16 * C) * N * itemsize)

    monkeypatch.setattr(vtv_cuda, "vtv_plan", one_cta)
    f, _ = _case((1, 3, 256, 256), torch.float32)
    before = _counts()
    with pytest.raises(RuntimeError, match="vtv kernel"):
        _run(f, torch.tensor(0.1), None, cuda_device, maxiter=10, tol=None)
    assert vtv_cuda.device_ops == before[2]
