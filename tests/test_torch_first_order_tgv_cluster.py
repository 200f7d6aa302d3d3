"""The single-loop TGV² learner's cluster design (``csrc/single_loop_tgv.cu``:
one thread-block cluster launch per outer step for the CP phase on the
bands of ``csrc/tgv_cluster.cuh``, two launches per CG step) and its plan.

- On the CPU: the plan (``solvers/cluster_plan.py::tgv_plan``, a rule of
  M, N and the dtype) for the learner's shapes: 128² in float32 and
  float64, uneven bands (16×20, 20×16, 22×24, 120×128, 13×24, 5×7, 1×9)
  and 256² and 512², whose bands do not fit in shared memory; the plan
  leaves kernel A's, the TV-L1
  kernel's and the single-loop TV learner's plans as they were; the CG's
  block form (``cg_slots``); the launches per outer step (24 at 10 CG
  steps); CPU tensors count no launch; bad carries and dtypes raise before
  the device.
- On the card (marked ``cuda``; they skip without one): the kernel against
  its plain version (``_single_loop_tgv_plain`` on the card) on uneven
  bands (16×20, 20×16, 22×24 at one, two and three images, the (2,)
  weight and a 2×2 patch stack; and 20×64): float64 at 1e-9 relative,
  float32 at
  ``chip_smoke.py``'s TGV² tolerances (α and the α and cost trajectories
  1e-4 relative, u 1e-4 absolute, ‖g‖ 1e-3 relative; 3×120×128 takes
  the CG blocks of three planes); the launches per outer step; both CG
  block forms give the same bits; the global-band path (a plan forced out of shared memory
  gives the bits of the resident one; 1×256² float64, whose bands do not
  fit, against the plain version); 8 and 16 CTAs an image give the same
  bits (a halo row is recomputed with the owner's operations); a plan the
  card refuses raises.

This file imports no JAX, so the card's tests also run where JAX is not
installed: ``python -m pytest --noconftest
tests/test_torch_first_order_tgv_cluster.py -m cuda``.
"""

import numpy as np
import pytest
import torch

from bpldenoising_tpu_torch import _build
from bpldenoising_tpu_torch.bilevel import first_order_cuda as fc
from bpldenoising_tpu_torch.bilevel import first_order_tgv as tfo
from bpldenoising_tpu_torch.bilevel import first_order_tgv_cuda as tfc
from bpldenoising_tpu_torch.solvers import cluster_plan, tvl1_cuda

KW = dict(lr=0.02, gamma=1e-4, tau0=0.99, sigma0=0.99, beta1=0.9,
          beta2=0.999, eps=1e-8)
VECTOR = np.array([0.05, 0.08])
PATCH = np.stack([np.full((2, 2), 0.05), np.full((2, 2), 0.08)], axis=-1)
# chip_smoke.py's TOL_SLX_REL_F32["tgv"], TOL_SL_U_F32, TOL_SL_GNORM_F32
TOL_REL_F32, TOL_U_F32, TOL_GNORM_F32 = 1e-4, 1e-4, 1e-3
TOL_F64 = 1e-9


@pytest.mark.parametrize("M,N,itemsize,cluster,rows,resident", [
    (128, 128, 4, 16, 8, True),    # the learns: 88 KB a CTA, two an SM
    (128, 128, 8, 16, 8, True),    # 176 KB (8 CTAs would take 266 KB)
    (16, 20, 8, 8, 2, True),
    (20, 16, 8, 8, 3, True),       # the 7th CTA owns two rows, the 8th none
    (22, 24, 8, 8, 3, True),       # the 8th owns 22 − 21 rows
    (120, 128, 8, 16, 8, True),    # the 16th owns none
    (13, 24, 8, 4, 4, True),       # the 4th owns one row
    (5, 7, 8, 2, 3, True),
    (1, 9, 4, 1, 1, True),         # one CTA: no neighbour
    (256, 256, 4, 16, 16, False),  # 266 KB: global bands
    (512, 512, 4, 16, 32, False),  # 892 KB: global bands
    (256, 256, 8, 16, 16, False),  # 532 KB
])
def test_tgv_plan(M, N, itemsize, cluster, rows, resident):
    """The plan from the shapes: up to 16 CTAs an image, every CTA but the
    last with two rows or more, the 11 band planes on rows + 4 rows and
    40 halo-slot rows in shared memory when they fit in 227 KB."""
    plan = tfc.tgv_plan(M, N, itemsize)
    assert (plan.cluster, plan.rows, plan.resident) == (cluster, rows,
                                                        resident)
    band = (11 * (rows + 4) + 40) * N * itemsize
    assert plan.planes == 11
    assert plan.smem == (band if resident else 0)
    assert (band <= cluster_plan.SMEM_PER_BLOCK) == resident
    assert rows * cluster >= M and (cluster == 1 or rows >= 2)


def test_plan_leaves_the_other_band_kernels_alone():
    """tgv_plan is a rule of its own (up to 16 CTAs an image at any batch):
    kernel A's, the single-loop TV learner's and the TV-L1 kernel's plans
    are what they were."""
    assert tfc.tgv_plan is cluster_plan.tgv_plan
    assert cluster_plan.pd_plan(128, 128, 1, 4) == cluster_plan.PdPlan(
        8, 16, 4, 49152, True)
    assert cluster_plan.pd_plan(128, 128, 3, 8) == cluster_plan.PdPlan(
        8, 16, 8, 212992, True)
    assert cluster_plan.pd_plan(20, 24, 1, 8, max_cluster=16) \
        == cluster_plan.PdPlan(8, 3, 4, 8448, True)
    assert tvl1_cuda.tvl1_plan(1, 128, 128, 4) == cluster_plan.PdPlan(
        16, 8, 4, 32768, True)
    assert tvl1_cuda.tvl1_plan(64, 128, 128, 4).cluster == 8
    with pytest.raises(ValueError, match="bad shape"):
        cluster_plan.tgv_plan(0, 128, 4)


@pytest.mark.parametrize("B,M,N,want", [
    (1, 128, 128, 1),     # 192 partial blocks; 64 of three planes
    (2, 128, 128, 1),     # 128 blocks of three planes: < 132 SMs
    (3, 128, 128, 3),
    (10, 128, 128, 3),    # the entry point: 640 blocks, not 1920
    (64, 128, 128, 3),
    (3, 120, 128, 3),
    (1, 256, 256, 3),
    (2, 20, 64, 1),
    (27, 20, 64, 3),
    (64, 16, 20, 1),      # M·N = 320: a partial block spans planes
])
def test_cg_slots(B, M, N, want):
    """A CG block takes the same 256 pixels of the three planes where M·N
    is a multiple of 256 and that grid gives each of 132 SMs a block."""
    assert tfc.cg_slots(B, M, N) == want


@pytest.mark.parametrize("n_adj,want", [(10, 24), (4, 12), (0, 4)])
def test_launches_per_step(n_adj, want):
    """One CP launch, the set-up launch, two a CG step and the two of the
    tail: rows 9–10's count (4 + 2·n_adj)."""
    assert tfc.launches_per_step is fc.launches_per_step
    assert tfc.launches_per_step(n_adj) == want


def images(B, M, N, seed=0):
    """(utrue, f): a ramp with a step and a disc under Gaussian noise of σ
    0.1, B images of M × N in float64, made with numpy from a seed."""
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.arange(M), np.arange(N), indexing="ij")
    ramp = 0.04 * xx + (yy > M // 2)
    disc = ((xx - N / 2) ** 2 + (yy - M / 2) ** 2 < (min(M, N) / 3) ** 2) \
        + 0.02 * yy
    clean = np.stack([ramp, disc, 0.5 * ramp + 0.5 * disc])[
        np.arange(B) % 3].astype(np.float64)
    return (torch.as_tensor(clean),
            torch.as_tensor(clean + 0.1 * rng.standard_normal(clean.shape)))


def _counts():
    return tfc.launches, tfc.kernel_launches, tfc.last_plan, \
        tfc.last_cg_slots


@pytest.mark.parametrize("x0", [VECTOR, PATCH], ids=["vector", "patch"])
def test_cpu_tensors_count_no_kernel_launch(x0):
    """On CPU tensors the learner runs its plain loop: no wrapper launch,
    no kernel launch, no plan, no CG form."""
    ut, f = images(2, 10, 12)
    before = _counts()
    res = tfo.single_loop_tgv_learn(ut, f, x0, outer=3, n_inner=4, n_adj=2,
                                    **KW)
    assert res.u.shape == (2, 10, 12)
    assert np.all(np.isfinite(res.cost_trajectory.numpy()))
    assert _counts() == before


def _carry(B, M, N):
    ut, f = images(B, M, N)
    _, _, x0t, pop, shape, _ = tfo._prepare(ut, f, VECTOR)
    return ut, f, tfo._tgv_init_carry(f, x0t, param_shape=shape), pop, \
        shape


def _bad_cases():
    """(label, change of the launch's arguments, error, match)."""
    def carry_with(part, value):
        def change(args):
            (u, w, p, q), lam, z, mv, t = args["carry"]
            state = dict(u=u, w=w, p=p, q=q)
            parts = dict(lam=lam, z=z, t=t)
            if part in state:
                state[part] = value(state[part])
            else:
                parts[part] = value(parts[part])
            args["carry"] = ((state["u"], state["w"], state["p"],
                              state["q"]), parts["lam"], parts["z"], mv,
                             parts["t"])
        return change

    def set_arg(name, value):
        def change(args):
            args[name] = value(args[name])
        return change

    return [
        ("u shape", carry_with("u", lambda a: a[:, :4]), ValueError,
         "carry u"),
        ("w planes", carry_with("w", lambda a: a[:, :1]), ValueError,
         "carry w"),
        ("p dtype", carry_with("p", lambda a: a.float()), ValueError,
         "carry p"),
        ("q planes", carry_with("q", lambda a: a[:, :2]), ValueError,
         "carry q"),
        ("lambda shape", carry_with("lam", lambda a: a[:1]), ValueError,
         "carry lambda"),
        ("z shape", carry_with("z", lambda a: a[:1]), ValueError,
         "carry z"),
        ("t shape", carry_with("t", lambda a: a.reshape(1)), ValueError,
         "carry t"),
        ("utrue shape", set_arg("utrue", lambda a: a[:1]), ValueError,
         "utrue"),
        ("f float16", set_arg("f", lambda a: a.half()), TypeError,
         "float32/float64"),
        ("f one image", set_arg("f", lambda a: a[0]), ValueError,
         "stack"),
        ("cpu tensors", set_arg("f", lambda a: a), ValueError,
         "expected a CUDA tensor"),
    ]


@pytest.mark.parametrize("case", _bad_cases(), ids=lambda c: c[0])
def test_bad_carries_and_dtypes_raise_before_the_device(case, monkeypatch):
    """The launch checks every argument's shape and dtype before it builds
    or touches the device; valid CPU tensors are refused; nothing is
    counted."""
    _, change, err, match = case

    def no_build():
        raise AssertionError("the kernels were built")

    monkeypatch.setattr(_build, "library", no_build)
    ut, f, carry, pop, shape = _carry(2, 8, 10)
    args = dict(utrue=ut, f=f, carry=carry)
    change(args)
    before = _counts()
    with pytest.raises(err, match=match):
        tfc._launch(args["utrue"], args["f"], args["carry"], outer=2,
                    n_inner=3, n_adj=2, pop=pop, param_shape=shape, **KW)
    assert _counts() == before


# ---- on the card

@pytest.fixture
def cuda_device():
    """The card, for tests marked ``cuda``; they skip without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (python -m pytest --noconftest "
                    "tests/test_torch_first_order_tgv_cluster.py -m cuda)")
    return torch.device("cuda")


def _rel(a, b):
    a, b = torch.as_tensor(a).double().cpu(), torch.as_tensor(b).double().cpu()
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-300)


def _errors(k, p):
    """Kernel against plain: α, the trajectories and u (relative), u and
    ‖g‖ as chip_smoke.py's sl_errors reads them."""
    return dict(alpha=_rel(k.alpha, p.alpha),
                alpha_traj=_rel(k.alpha_trajectory, p.alpha_trajectory),
                cost_traj=_rel(k.cost_trajectory, p.cost_trajectory),
                gnorm_traj=_rel(k.gnorm_trajectory, p.gnorm_trajectory),
                u_rel=_rel(k.u, p.u),
                u=float((k.u.double().cpu() - p.u.double().cpu())
                        .abs().max()))


def _run(ut, f, x0, device, outer, **kw):
    """(kernel result, plain result, kernel launches per outer step) on
    the card."""
    ut, f = ut.to(device), f.to(device)
    _, _, x0t, pop, shape, _ = tfo._prepare(ut, f, x0)
    args = dict(outer=outer, pop=pop, param_shape=shape, **KW, **kw)
    launched, calls = tfc.kernel_launches, tfc.launches
    k = tfo._single_loop_tgv_impl(ut, f, x0t, **args)
    torch.cuda.synchronize()
    assert tfc.launches == calls + 1
    per_step = (tfc.kernel_launches - launched - 1) / outer
    p = tfo._single_loop_tgv_plain(ut, f, x0t, **args)
    return k, p, per_step


def _same(a, b):
    for name in ("alpha", "u", "alpha_trajectory", "cost_trajectory",
                 "gnorm_trajectory"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name


def _plan_with(monkeypatch, **change):
    """Make the wrapper plan ``change`` (resident=False: the global bands;
    cluster=n: n CTAs an image, in shared memory where the band fits)
    whatever the shapes."""
    real = cluster_plan.tgv_plan

    def plan(M, N, itemsize):
        p = real(M, N, itemsize)
        if change.get("resident", True) is False:
            return p._replace(resident=False, smem=0)
        n = change["cluster"]
        rows = -(-M // n)
        smem = (11 * (rows + 4) + 40) * N * itemsize
        fits = smem <= cluster_plan.SMEM_PER_BLOCK
        return p._replace(cluster=n, rows=rows, smem=smem if fits else 0,
                          resident=fits)

    monkeypatch.setattr(tfc, "tgv_plan", plan)


@pytest.mark.cuda
@pytest.mark.parametrize("x0", [VECTOR, PATCH], ids=["vector", "patch"])
@pytest.mark.parametrize("B", [1, 2, 3])
@pytest.mark.parametrize("M,N", [(16, 20), (20, 16), (22, 24), (20, 64)],
                         ids=["16x20", "20x16", "22x24", "20x64"])
def test_kernel_matches_plain_float64(cuda_device, M, N, B, x0):
    ut, f = images(B, M, N, seed=B)
    k, p, per_step = _run(ut, f, x0, cuda_device, outer=12, n_inner=8,
                          n_adj=4)
    assert tfc.last_plan == tfc.tgv_plan(M, N, 8)
    assert per_step == tfc.launches_per_step(4)
    errs = _errors(k, p)
    errs.pop("u")
    assert max(errs.values()) <= TOL_F64, errs


@pytest.mark.cuda
@pytest.mark.parametrize("x0", [VECTOR, PATCH], ids=["vector", "patch"])
@pytest.mark.parametrize("B,M,N", [(1, 16, 20), (3, 22, 24),
                                   (3, 120, 128)],
                         ids=["1x16x20", "3x22x24", "3x120x128"])
def test_kernel_matches_plain_float32(cuda_device, B, M, N, x0):
    ut, f = images(B, M, N, seed=4)
    k, p, per_step = _run(ut.float(), f.float(), x0, cuda_device, outer=20,
                          n_inner=10, n_adj=10)
    assert per_step == tfc.launches_per_step(10) == 24
    assert tfc.last_cg_slots == tfc.cg_slots(B, M, N)
    errs = _errors(k, p)
    assert max(errs["alpha"], errs["alpha_traj"], errs["cost_traj"]) \
        <= TOL_REL_F32, errs
    assert errs["u"] <= TOL_U_F32 and errs["gnorm_traj"] <= TOL_GNORM_F32, \
        errs


def _kernel(ut, f, x0, device, outer=10, **kw):
    ut, f = ut.to(device), f.to(device)
    _, _, x0t, pop, shape, _ = tfo._prepare(ut, f, x0)
    res = tfo._single_loop_tgv_impl(ut, f, x0t, outer=outer, pop=pop,
                                    param_shape=shape, **KW,
                                    **dict(dict(n_inner=8, n_adj=4), **kw))
    torch.cuda.synchronize()
    return res, tfc.last_plan


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("B,M,N", [(3, 22, 24), (1, 128, 128)],
                         ids=["3x22x24", "1x128x128"])
def test_global_bands_give_the_resident_bits(cuda_device, monkeypatch, B,
                                             M, N, dtype):
    ut, f = images(B, M, N, seed=5)
    ut, f = ut.to(dtype), f.to(dtype)
    res, plan = _kernel(ut, f, PATCH, cuda_device)
    assert plan.resident
    _plan_with(monkeypatch, resident=False)
    glob, plan = _kernel(ut, f, PATCH, cuda_device)
    assert not plan.resident
    _same(glob, res)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("B,M,N", [(2, 20, 64), (1, 128, 128)],
                         ids=["2x20x64", "1x128x128"])
def test_cg_block_forms_give_the_same_bits(cuda_device, monkeypatch, B, M,
                                           N, dtype):
    """CG blocks of one partial block and of the same 256 pixels of the
    three planes run the same operations and the same partial sums: the
    same bits (float64 also against the plain version)."""
    ut, f = images(B, M, N, seed=8)
    ut, f = ut.to(dtype), f.to(dtype)
    assert tfc.cg_slots(B, M, N) == 1
    one, _ = _kernel(ut, f, PATCH, cuda_device)
    monkeypatch.setattr(tfc, "cg_slots", lambda *a: 3)
    three, _ = _kernel(ut, f, PATCH, cuda_device)
    assert tfc.last_cg_slots == 3
    _same(three, one)
    if dtype == torch.float64:
        _, _, x0t, pop, shape, _ = tfo._prepare(ut, f, PATCH)
        p = tfo._single_loop_tgv_plain(ut, f, x0t, outer=10, pop=pop,
                                       param_shape=shape, n_inner=8,
                                       n_adj=4, **KW)
        errs = _errors(three, p)
        errs.pop("u")
        assert max(errs.values()) <= TOL_F64, errs


@pytest.mark.cuda
def test_bands_that_do_not_fit_run_in_global_memory(cuda_device):
    """1×256² float64: the plan's bands (532 KB) live in global memory;
    the plain version's numbers at 1e-9."""
    ut, f = images(1, 256, 256, seed=6)
    assert not tfc.tgv_plan(256, 256, 8).resident
    k, p, per_step = _run(ut, f, VECTOR, cuda_device, outer=3, n_inner=8,
                          n_adj=4)
    assert not tfc.last_plan.resident and per_step == 12
    errs = _errors(k, p)
    errs.pop("u")
    assert max(errs.values()) <= TOL_F64, errs


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("B,M,N", [(1, 128, 128), (2, 40, 36)],
                         ids=["1x128x128", "2x40x36"])
def test_sixteen_ctas_give_the_bits_of_eight(cuda_device, monkeypatch, B, M,
                                             N, dtype):
    ut, f = images(B, M, N, seed=7)
    ut, f = ut.to(dtype), f.to(dtype)
    """The plan's 16 CTAs an image (a non-portable cluster) give the bits
    of 8 (at 128² float64 their 266 KB bands run in global memory)."""
    res, plan = _kernel(ut, f, VECTOR, cuda_device)
    assert plan.cluster == 16 and plan.resident
    _plan_with(monkeypatch, cluster=8)
    eight, plan = _kernel(ut, f, VECTOR, cuda_device)
    assert plan.cluster == 8
    assert plan.resident == (dtype == torch.float32 or M < 128)
    _same(eight, res)


@pytest.mark.cuda
def test_refused_plan_raises(cuda_device, monkeypatch):
    """A plan the card cannot run (one CTA holding a 512² image's bands,
    ~9 MB of shared memory) raises; it is not retried in another form."""
    real = cluster_plan.tgv_plan

    def one_cta(M, N, itemsize):
        return real(M, N, itemsize)._replace(
            cluster=1, rows=M, resident=True,
            smem=(11 * (M + 4) + 40) * N * itemsize)

    monkeypatch.setattr(tfc, "tgv_plan", one_cta)
    ut, f = images(1, 512, 512)
    before = tfc.kernel_launches
    with pytest.raises(RuntimeError, match="single-loop TGV kernel"):
        _kernel(ut.float(), f.float(), VECTOR, cuda_device, outer=2)
    assert tfc.kernel_launches == before
