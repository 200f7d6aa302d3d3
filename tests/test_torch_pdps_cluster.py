"""Kernel A's cluster form (``csrc/pdps.cu``: one launch per early-stop
chunk, a thread-block cluster an image, the bands of
``csrc/pd_cluster.cuh``) and its plan.

- On the CPU: the plan (``solvers/cluster_plan.py::pd_plan``), which both
  kernel A and the single-loop learner read, for kernel A's shapes: the
  flagship's 10×128² in both forms and dtypes, uneven bands, the smallest
  images, and row 3's 1×2048², whose bands do not fit in shared memory
  (the tile form runs there: ``tests/test_torch_pdps_tile_card.py``).
- On the card (marked ``cuda``; they skip without one): the cluster form
  against the two-launch form and against the plain version, for the four
  forms the kernel is instantiated for and a generic one, in float64 and
  float32, on uneven bands, the smallest images and more images than one
  wave of clusters holds; cold with a fixed budget, cold with the early
  stop, warm.  The two kernel forms run the same operations in the same
  order (``-fmad=false``), so they must agree bit for bit with equal
  iteration counts.  Against the plain version: float64 at 1e-9 relative
  with equal iteration counts; float32 at ``chip_smoke.py``'s kernel-A
  tolerances (u 1e-4, y 1e-3 absolute: the kernel projects with rsqrt
  where the plain version divides by a square root) with counts within one
  check.  Each call counts one launch and the device operations of its
  form; a plan the card refuses raises.

This file imports no JAX, so the card's tests also run where JAX is not
installed: ``python -m pytest --noconftest tests/test_torch_pdps_cluster.py
-m cuda``.
"""

import numpy as np
import pytest
import torch

from bpldenoising_tpu_torch.bilevel import first_order_cuda
from bpldenoising_tpu_torch.models import DenoiseModel, sumregs_model, \
    tv_model
from bpldenoising_tpu_torch.ops import BwdGradientOp, CenteredGradientOp
from bpldenoising_tpu_torch.solvers import cluster_plan, pdps_cuda
from bpldenoising_tpu_torch.solvers.pdps import _denoise_pdps_impl

PD = dict(tau0=5.0, sigma0=0.99 / 5.0, gamma=1.0, accel=True)


@pytest.mark.parametrize("O,M,N,K,itemsize,cluster,rows,resident", [
    (10, 128, 128, 1, 4, 8, 16, True),      # the flagship: 48 KB a CTA
    (10, 128, 128, 3, 4, 8, 16, True),      # the sum of regs.: 104 KB
    (10, 128, 128, 3, 8, 8, 16, True),      # float64: 208 KB
    (2, 20, 24, 3, 8, 8, 3, True),          # the 8th CTA owns 20 − 21 rows
    (3, 16, 20, 3, 4, 8, 2, True),
    (1, 8, 8, 1, 8, 4, 2, True),
    (2, 5, 7, 3, 8, 2, 3, True),
    (1, 3, 9, 1, 4, 1, 3, True),            # one CTA: no neighbour
    (1, 2048, 2048, 1, 4, 8, 256, False),   # row 3: the tile form
    (1, 2048, 2048, 3, 4, 8, 256, False),
])
def test_kernel_a_plan(O, M, N, K, itemsize, cluster, rows, resident):
    """Kernel A's plan from the shapes: a power of two up to 8 CTAs an
    image leaving every CTA but the last two rows or more, ⌈M / cluster⌉
    rows each, and the cluster form when the 2 + 2K band planes of rows + 4
    rows and the 16K halo-slot rows fit in 227 KB; the batch does not
    enter (images are independent clusters)."""
    plan = cluster_plan.pd_plan(M, N, K, itemsize)
    assert (plan.cluster, plan.rows, plan.resident) == (cluster, rows,
                                                        resident)
    band = ((2 + 2 * K) * (rows + 4) + 16 * K) * N * itemsize
    assert plan.smem == (band if resident else 0)
    assert (band <= cluster_plan.SMEM_PER_BLOCK) == resident
    assert plan.cluster <= cluster_plan.MAX_CLUSTER and O >= 1


def test_plan_is_shared_with_the_single_loop_learner():
    """One rule for both band kernels: the single-loop learner's module
    re-exports the plan it reads from ``solvers/cluster_plan.py``."""
    assert first_order_cuda.pd_plan is cluster_plan.pd_plan
    assert first_order_cuda.PdPlan is cluster_plan.PdPlan
    assert first_order_cuda.SMEM_PER_BLOCK == cluster_plan.SMEM_PER_BLOCK
    assert first_order_cuda.MAX_CLUSTER == cluster_plan.MAX_CLUSTER


def test_cpu_tensors_issue_no_device_operations():
    """On CPU tensors the wrapper runs the plain version and counts no
    launch and no device operation."""
    f = torch.from_numpy(np.random.default_rng(0).random((2, 8, 10)))
    before = pdps_cuda.launches, pdps_cuda.device_ops
    u = pdps_cuda.denoise_pdps_cuda(
        f, (torch.tensor(0.1, dtype=f.dtype),), None, model=tv_model(),
        maxiter=60, tol=1e-6, check_every=20, return_dual=False, **PD)
    assert u.shape == f.shape
    assert (pdps_cuda.launches, pdps_cuda.device_ops) == before


# ---- on the card

@pytest.fixture
def cuda_device():
    """The card, for tests marked ``cuda``; they skip without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (python -m pytest --noconftest "
                    "tests/test_torch_pdps_cluster.py -m cuda)")
    return torch.device("cuda")


FORMS = ("tv", "tv_map", "sumregs", "sumregs_maps", "generic")
SHAPES = ((2, 20, 24), (3, 16, 20), (1, 8, 8), (2, 5, 7), (1, 3, 9),
          (40, 32, 32))


def _case(form, shape, dtype, seed=0):
    """f (O, M, N) and the model and weights of ``form``: scalar TV, TV
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
    """Kernel A on the card → (u, ys, iters, device operations)."""
    ops = pdps_cuda.device_ops
    launches = pdps_cuda.launches
    on = tuple(a.to(device) for a in alphas)
    st = None if state is None else (state[0].to(device),
                                     tuple(y.to(device) for y in state[1]))
    u, ys, it = pdps_cuda.denoise_pdps_cuda(f.to(device), on, st, **kw)
    torch.cuda.synchronize()
    assert pdps_cuda.launches == launches + 1
    return u.cpu(), tuple(y.cpu() for y in ys), it, \
        pdps_cuda.device_ops - ops


def _two_launch(monkeypatch):
    """Make kernel A plan its two-launch form whatever the shapes (no
    cluster and no tile plan)."""
    real = cluster_plan.pd_plan
    monkeypatch.setattr(pdps_cuda, "pd_plan", lambda *a: real(*a)._replace(
        resident=False, smem=0))
    monkeypatch.setattr(pdps_cuda, "pd_tile_plan", lambda *a, **k: None)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("form", FORMS)
def test_cluster_form_matches_two_launch_form_and_plain(
        cuda_device, monkeypatch, form, shape, dtype):
    f, model, alphas = _case(form, shape, dtype)
    plan = cluster_plan.pd_plan(shape[1], shape[2], model.K,
                                f.element_size())
    assert plan.resident
    check = 25
    modes = (("cold fixed", None, dict(maxiter=120, tol=None)),
             ("cold early stop", None, dict(maxiter=400, tol=1e-4)),
             ("warm early stop", "state", dict(maxiter=400, tol=1e-5)))
    runs = {}
    state = None
    for name, warm, extra in modes:
        kw = dict(model=model, check_every=check, return_dual=True, **PD,
                  **extra)
        st = state if warm else None
        a = alphas if not warm else tuple(0.9 * x for x in alphas)
        k = _run(f, a, st, cuda_device, **kw)
        p = _denoise_pdps_impl(f, a, st, **kw)
        runs[name] = (k, p, kw, a, st)
        state = (p[0], p[1])
        # the cluster form's device operations: the table copy, then one
        # launch (fixed budget) or per chunk the launch, pd_change and the
        # read of the ratios, and a last copy when u ends in the other
        # buffer
        chunks = -(-k[2] // check)
        want = 2 if extra["tol"] is None else \
            1 + 3 * chunks + chunks % 2
        assert k[3] == want, (name, k[3], want)
    _two_launch(monkeypatch)
    for name, (k, p, kw, a, st) in runs.items():
        g = _run(f, a, st, cuda_device, **kw)
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


@pytest.mark.cuda
def test_refused_plan_raises(cuda_device, monkeypatch):
    """A plan the card cannot run (one CTA holding a 512² image's K = 3
    bands, ~3.4 MB of shared memory) raises; it is not retried in another
    form."""
    real = cluster_plan.pd_plan

    def one_cta(M, N, K, itemsize):
        p = real(M, N, K, itemsize)
        return p._replace(cluster=1, rows=M, resident=True,
                          smem=((2 + 2 * K) * (M + 4) + 16 * K) * N
                          * itemsize)

    monkeypatch.setattr(pdps_cuda, "pd_plan", one_cta)
    f, model, alphas = _case("sumregs", (1, 512, 512), torch.float32)
    with pytest.raises(RuntimeError, match="pdps kernel"):
        _run(f, alphas, None, cuda_device, model=model, maxiter=10,
             tol=None, check_every=10, return_dual=True, **PD)
