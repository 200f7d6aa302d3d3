"""The single-loop VTV learner's cluster design (``csrc/single_loop_vtv.cu``:
one thread-block cluster launch per outer step for the CP phase on the
bands of ``csrc/vtv_cluster.cuh``, two launches per CG step) and its plan.

- On the CPU: the plan (``solvers/cluster_plan.py::vtv_plan``, a rule of
  M, N, C and the dtype) for the learner's shapes: 128² in float32 and
  float64, uneven bands (24², 20×16, 22×24, 120×128, 1×9), C = 2, and
  256², whose bands do not fit in shared memory; the plan leaves kernel
  A's, the TV-L1 kernel's, the single-loop TV learner's and the TGV²
  learner's plans as they were; the CG's block form (``cg_slots``, and
  row 11's unchanged); the launches per outer step (24 at 10 CG steps);
  CPU tensors count no launch; bad carries and dtypes raise before the
  device.
- On the card (marked ``cuda``; they skip without one): the kernel against
  its plain version (``_single_loop_vtv_plain`` on the card) on uneven
  bands (3×20×16, 3×22×24 and 2×16×20 channels-by-rows-by-columns at one,
  two and three images, the scalar weight and a 2×2 patch grid): float64
  at 1e-9 relative; float32 with the plain version's bits at the shapes
  of ``chip_smoke.py`` (1×3×128², 6×3×128²) and at its tolerances on
  uneven bands; the launches per outer step; both CG block forms give the
  same bits; the global-band path (a plan forced out of shared memory
  gives the bits of the resident one; 1×3×256² float64, whose bands do not
  fit, against the plain version); 8 and 16 CTAs an image give the same
  bits; a plan the card refuses raises.

This file imports no JAX, so the card's tests also run where JAX is not
installed: ``python -m pytest --noconftest
tests/test_torch_first_order_vtv_cluster.py -m cuda``.
"""

import numpy as np
import pytest
import torch

from bpldenoising_tpu_torch import _build
from bpldenoising_tpu_torch.bilevel import first_order_cuda as fc
from bpldenoising_tpu_torch.bilevel import first_order_tgv_cuda as tgc
from bpldenoising_tpu_torch.bilevel import first_order_vtv as vfo
from bpldenoising_tpu_torch.bilevel import first_order_vtv_cuda as vfc
from bpldenoising_tpu_torch.solvers import cluster_plan, tvl1_cuda

KW = dict(lr=0.05, gamma=1e-4, tau0=5.0, sigma0=0.99 / 5.0, beta1=0.9,
          beta2=0.999, eps=1e-8)
SCALAR = np.array(0.05)
PATCH = np.array([[0.05, 0.07], [0.04, 0.06]])
# chip_smoke.py's TOL_SLX_REL_F32["vtv"], TOL_SL_U_F32, TOL_SL_GNORM_F32
TOL_REL_F32, TOL_U_F32, TOL_GNORM_F32 = 1e-5, 1e-4, 1e-3
TOL_F64 = 1e-9


@pytest.mark.parametrize("M,N,C,itemsize,cluster,rows,resident", [
    (128, 128, 3, 4, 16, 8, True),    # the learns: 96 KB a CTA, two an SM
    (128, 128, 3, 8, 16, 8, True),    # 192 KB (8 CTAs would take 288 KB)
    (128, 128, 2, 4, 16, 8, True),    # two channels: 64 KB
    (128, 128, 2, 8, 16, 8, True),
    (24, 24, 3, 8, 8, 3, True),
    (20, 16, 3, 8, 8, 3, True),       # the 7th CTA owns two rows, the 8th none
    (22, 24, 3, 8, 8, 3, True),       # the 8th owns 22 − 21 rows
    (16, 20, 2, 8, 8, 2, True),
    (120, 128, 3, 8, 16, 8, True),    # the 16th owns none
    (1, 9, 3, 4, 1, 1, True),         # one CTA: no neighbour
    (256, 256, 3, 4, 16, 16, False),  # 288 KB: global bands
    (256, 256, 3, 8, 16, 16, False),  # 576 KB
])
def test_vtv_plan(M, N, C, itemsize, cluster, rows, resident):
    """The plan from the shapes: up to 16 CTAs an image, every CTA but the
    last with two rows or more, the 4C band planes on rows + 4 rows and
    16C halo-slot rows in shared memory when they fit in 227 KB."""
    plan = vfc.vtv_plan(M, N, C, itemsize)
    assert (plan.cluster, plan.rows, plan.resident) == (cluster, rows,
                                                        resident)
    band = (4 * C * (rows + 4) + 16 * C) * N * itemsize
    assert plan.planes == 4 * C
    assert plan.smem == (band if resident else 0)
    assert (band <= cluster_plan.SMEM_PER_BLOCK) == resident
    assert rows * cluster >= M and (cluster == 1 or rows >= 2)


def test_plan_leaves_the_other_band_kernels_alone():
    """vtv_plan is a rule of its own: kernel A's, the single-loop TV
    learner's, the TV-L1 kernel's and the TGV² learner's plans are what
    they were."""
    assert vfc.vtv_plan is cluster_plan.vtv_plan
    assert cluster_plan.pd_plan(128, 128, 1, 4) == cluster_plan.PdPlan(
        8, 16, 4, 49152, True)
    assert cluster_plan.pd_plan(128, 128, 3, 8) == cluster_plan.PdPlan(
        8, 16, 8, 212992, True)
    assert tvl1_cuda.tvl1_plan(1, 128, 128, 4) == cluster_plan.PdPlan(
        16, 8, 4, 32768, True)
    assert cluster_plan.tgv_plan(128, 128, 4) == cluster_plan.PdPlan(
        16, 8, 11, 88064, True)
    assert cluster_plan.tgv_plan(256, 256, 4) == cluster_plan.PdPlan(
        16, 16, 11, 0, False)
    with pytest.raises(ValueError, match="bad shape"):
        cluster_plan.vtv_plan(128, 128, 0, 4)


@pytest.mark.parametrize("B,M,N,C,want", [
    (1, 128, 128, 3, 1),     # 192 partial blocks; 64 of three planes
    (2, 128, 128, 3, 1),     # 128 blocks of three planes: < 132 SMs
    (3, 128, 128, 3, 3),
    (6, 128, 128, 3, 3),     # the entry point: 384 blocks, not 1152
    (6, 128, 128, 2, 2),
    (64, 128, 128, 3, 3),
    (1, 256, 256, 3, 3),
    (2, 20, 64, 3, 1),
    (27, 20, 64, 3, 3),
    (64, 16, 20, 3, 1),      # M·N = 320: a partial block spans planes
])
def test_cg_slots(B, M, N, C, want):
    """A CG block takes the same 256 pixels of the C planes where M·N is a
    multiple of 256 and that grid gives each of 132 SMs a block."""
    assert vfc.cg_slots(B, M, N, C) == want


@pytest.mark.parametrize("B,M,N,want", [
    (1, 128, 128, 1), (2, 128, 128, 1), (3, 128, 128, 3),
    (10, 128, 128, 3), (64, 16, 20, 1), (27, 20, 64, 3)])
def test_tgv_cg_slots_unchanged(B, M, N, want):
    """Row 11's CG block form is the shared rule at three planes, with its
    own decisions."""
    assert tgc.cg_slots(B, M, N) == want \
        == cluster_plan.cg_block_slots(B, M, N, 3)


@pytest.mark.parametrize("n_adj,want", [(10, 24), (4, 12), (0, 4)])
def test_launches_per_step(n_adj, want):
    """One CP launch, the set-up launch, two a CG step and the two of the
    tail: rows 9–11's count (4 + 2·n_adj)."""
    assert vfc.launches_per_step is fc.launches_per_step
    assert vfc.launches_per_step(n_adj) == want


def images(B, C, M, N, seed=0):
    """(utrue, f): B images of C channels, M × N, in float64 (channels a
    ramp with a step, a disc and their mean, rolled per image) under
    Gaussian noise of σ 0.1, made with numpy from a seed."""
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.arange(M), np.arange(N), indexing="ij")
    ramp = 0.04 * xx + (yy > M // 2)
    disc = ((xx - N / 2) ** 2 + (yy - M / 2) ** 2 < (min(M, N) / 3) ** 2) \
        + 0.02 * yy
    planes = np.stack([ramp, disc, 0.5 * ramp + 0.5 * disc])
    clean = np.stack([planes[(np.arange(C) + b) % 3] for b in range(B)])
    return (torch.as_tensor(clean),
            torch.as_tensor(clean + 0.1 * rng.standard_normal(clean.shape)))


def _counts():
    return vfc.launches, vfc.kernel_launches, vfc.last_plan, \
        vfc.last_cg_slots


@pytest.mark.parametrize("x0", [SCALAR, PATCH], ids=["scalar", "patch"])
def test_cpu_tensors_count_no_kernel_launch(x0):
    """On CPU tensors the learner runs its plain loop: no wrapper launch,
    no kernel launch, no plan, no CG form."""
    ut, f = images(2, 3, 10, 12)
    before = _counts()
    res = vfo.single_loop_vtv_learn(ut, f, x0, outer=3, n_inner=4, n_adj=2,
                                    **KW)
    assert res.u.shape == (2, 3, 10, 12)
    assert np.all(np.isfinite(res.cost_trajectory.numpy()))
    assert _counts() == before


def _carry(B, C, M, N):
    ut, f = images(B, C, M, N)
    _, _, x0t, pop, shape, _ = vfo._prepare(ut, f, SCALAR)
    return ut, f, vfo._vtv_init_carry(f, x0t, param_shape=shape), pop, \
        shape


def _bad_cases():
    """(label, change of the launch's arguments, error, match)."""
    names = ("u", "y", "lam", "z", "mv", "t")

    def carry_with(part, value):
        def change(args):
            parts = dict(zip(names, args["carry"]))
            parts[part] = value(parts[part])
            args["carry"] = tuple(parts[n] for n in names)
        return change

    def set_arg(name, value):
        def change(args):
            args[name] = value(args[name])
        return change

    return [
        ("u shape", carry_with("u", lambda a: a[:, :, :4]), ValueError,
         "carry u"),
        ("u channels", carry_with("u", lambda a: a[:, :2]), ValueError,
         "carry u"),
        ("y components", carry_with("y", lambda a: a[:, :, :1]),
         ValueError, "carry y"),
        ("y dtype", carry_with("y", lambda a: a.float()), ValueError,
         "carry y"),
        ("lambda shape", carry_with("lam", lambda a: a[:1]), ValueError,
         "carry lambda"),
        ("z shape", carry_with("z", lambda a: a.reshape(1)), ValueError,
         "carry z"),
        ("m dtype", carry_with("mv", lambda mv: (mv[0].float(), mv[1])),
         ValueError, "carry m"),
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
    ut, f, carry, pop, shape = _carry(2, 3, 8, 10)
    args = dict(utrue=ut, f=f, carry=carry)
    change(args)
    before = _counts()
    with pytest.raises(err, match=match):
        vfc._launch(args["utrue"], args["f"], args["carry"], outer=2,
                    n_inner=3, n_adj=2, pop=pop, param_shape=shape, **KW)
    assert _counts() == before


# ---- on the card

@pytest.fixture
def cuda_device():
    """The card, for tests marked ``cuda``; they skip without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (python -m pytest --noconftest "
                    "tests/test_torch_first_order_vtv_cluster.py -m cuda)")
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
    _, _, x0t, pop, shape, _ = vfo._prepare(ut, f, x0)
    args = dict(outer=outer, pop=pop, param_shape=shape, **KW, **kw)
    launched, calls = vfc.kernel_launches, vfc.launches
    k = vfo._single_loop_vtv_impl(ut, f, x0t, **args)
    torch.cuda.synchronize()
    assert vfc.launches == calls + 1
    per_step = (vfc.kernel_launches - launched - 1) / outer
    p = vfo._single_loop_vtv_plain(ut, f, x0t, **args)
    return k, p, per_step


def _same(a, b):
    for name in ("alpha", "u", "alpha_trajectory", "cost_trajectory",
                 "gnorm_trajectory"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name


def _plan_with(monkeypatch, **change):
    """Make the wrapper plan ``change`` (resident=False: the global bands;
    cluster=n: n CTAs an image, in shared memory where the band fits)
    whatever the shapes."""
    real = cluster_plan.vtv_plan

    def plan(M, N, C, itemsize):
        p = real(M, N, C, itemsize)
        if change.get("resident", True) is False:
            return p._replace(resident=False, smem=0)
        n = change["cluster"]
        rows = -(-M // n)
        smem = (4 * C * (rows + 4) + 16 * C) * N * itemsize
        fits = smem <= cluster_plan.SMEM_PER_BLOCK
        return p._replace(cluster=n, rows=rows, smem=smem if fits else 0,
                          resident=fits)

    monkeypatch.setattr(vfc, "vtv_plan", plan)


@pytest.mark.cuda
@pytest.mark.parametrize("x0", [SCALAR, PATCH], ids=["scalar", "patch"])
@pytest.mark.parametrize("B", [1, 2, 3])
@pytest.mark.parametrize("C,M,N", [(3, 20, 16), (3, 22, 24), (2, 16, 20)],
                         ids=["3x20x16", "3x22x24", "2x16x20"])
def test_kernel_matches_plain_float64(cuda_device, C, M, N, B, x0):
    ut, f = images(B, C, M, N, seed=B)
    k, p, per_step = _run(ut, f, x0, cuda_device, outer=12, n_inner=8,
                          n_adj=4)
    assert vfc.last_plan == vfc.vtv_plan(M, N, C, 8)
    assert per_step == vfc.launches_per_step(4)
    errs = _errors(k, p)
    errs.pop("u")
    assert max(errs.values()) <= TOL_F64, errs


@pytest.mark.cuda
@pytest.mark.parametrize("x0", [SCALAR, PATCH], ids=["scalar", "patch"])
@pytest.mark.parametrize("B,C,M,N", [(1, 3, 20, 16), (3, 3, 22, 24),
                                     (2, 2, 16, 20), (3, 3, 120, 128)],
                         ids=["1x3x20x16", "3x3x22x24", "2x2x16x20",
                              "3x3x120x128"])
def test_kernel_matches_plain_float32(cuda_device, B, C, M, N, x0):
    ut, f = images(B, C, M, N, seed=4)
    k, p, per_step = _run(ut.float(), f.float(), x0, cuda_device, outer=20,
                          n_inner=10, n_adj=10)
    assert per_step == vfc.launches_per_step(10) == 24
    assert vfc.last_cg_slots == vfc.cg_slots(B, M, N, C)
    errs = _errors(k, p)
    assert max(errs["alpha"], errs["alpha_traj"], errs["cost_traj"]) \
        <= TOL_REL_F32, errs
    assert errs["u"] <= TOL_U_F32 and errs["gnorm_traj"] <= TOL_GNORM_F32, \
        errs


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 6])
def test_float32_bits_of_the_plain_version(cuda_device, B):
    """At chip_smoke.py's shapes (one and six 3×128² images, 40 CP and 10
    CG steps) the kernel gives the plain version's float32 bits in α, u
    and the α trajectory, as the parent design did (the same elementwise
    order and the same partial trees); the cost and ‖g‖ trajectories at
    the float32 tolerances."""
    ut, f = images(B, 3, 128, 128, seed=9)
    k, p, per_step = _run(ut.float(), f.float(), SCALAR, cuda_device,
                          outer=8, n_inner=40, n_adj=10)
    assert per_step == 24
    assert vfc.last_cg_slots == (1 if B == 1 else 3)
    for name in ("alpha", "u", "alpha_trajectory"):
        assert torch.equal(getattr(k, name), getattr(p, name)), name
    errs = _errors(k, p)
    assert errs["cost_traj"] <= TOL_REL_F32, errs
    assert errs["gnorm_traj"] <= TOL_GNORM_F32, errs


def _kernel(ut, f, x0, device, outer=10, **kw):
    ut, f = ut.to(device), f.to(device)
    _, _, x0t, pop, shape, _ = vfo._prepare(ut, f, x0)
    res = vfo._single_loop_vtv_impl(ut, f, x0t, outer=outer, pop=pop,
                                    param_shape=shape, **KW,
                                    **dict(dict(n_inner=8, n_adj=4), **kw))
    torch.cuda.synchronize()
    return res, vfc.last_plan


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("B,C,M,N", [(3, 3, 22, 24), (1, 3, 128, 128)],
                         ids=["3x3x22x24", "1x3x128x128"])
def test_global_bands_give_the_resident_bits(cuda_device, monkeypatch, B,
                                             C, M, N, dtype):
    ut, f = images(B, C, M, N, seed=5)
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
@pytest.mark.parametrize("B,C,M,N", [(2, 3, 20, 64), (1, 3, 128, 128),
                                     (2, 2, 16, 32)],
                         ids=["2x3x20x64", "1x3x128x128", "2x2x16x32"])
def test_cg_block_forms_give_the_same_bits(cuda_device, monkeypatch, B, C,
                                           M, N, dtype):
    """CG blocks of one partial block and of the same 256 pixels of the C
    planes run the same operations and the same partial sums: the same
    bits (float64 also against the plain version)."""
    ut, f = images(B, C, M, N, seed=8)
    ut, f = ut.to(dtype), f.to(dtype)
    assert vfc.cg_slots(B, M, N, C) == 1
    one, _ = _kernel(ut, f, PATCH, cuda_device)
    monkeypatch.setattr(vfc, "cg_slots", lambda B, M, N, C: C)
    many, _ = _kernel(ut, f, PATCH, cuda_device)
    assert vfc.last_cg_slots == C
    _same(many, one)
    if dtype == torch.float64:
        _, _, x0t, pop, shape, _ = vfo._prepare(ut, f, PATCH)
        p = vfo._single_loop_vtv_plain(ut, f, x0t, outer=10, pop=pop,
                                       param_shape=shape, n_inner=8,
                                       n_adj=4, **KW)
        errs = _errors(many, p)
        errs.pop("u")
        assert max(errs.values()) <= TOL_F64, errs


@pytest.mark.cuda
def test_bands_that_do_not_fit_run_in_global_memory(cuda_device):
    """1×3×256² float64: the plan's bands (576 KB) live in global memory;
    the plain version's numbers at 1e-9."""
    ut, f = images(1, 3, 256, 256, seed=6)
    assert not vfc.vtv_plan(256, 256, 3, 8).resident
    k, p, per_step = _run(ut, f, SCALAR, cuda_device, outer=3, n_inner=8,
                          n_adj=4)
    assert not vfc.last_plan.resident and per_step == 12
    errs = _errors(k, p)
    errs.pop("u")
    assert max(errs.values()) <= TOL_F64, errs


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("B,C,M,N", [(1, 3, 128, 128), (2, 2, 40, 36)],
                         ids=["1x3x128x128", "2x2x40x36"])
def test_sixteen_ctas_give_the_bits_of_eight(cuda_device, monkeypatch, B, C,
                                             M, N, dtype):
    """The plan's 16 CTAs an image (a non-portable cluster) give the bits
    of 8 (at 3×128² float64 their 288 KB bands run in global memory)."""
    ut, f = images(B, C, M, N, seed=7)
    ut, f = ut.to(dtype), f.to(dtype)
    res, plan = _kernel(ut, f, SCALAR, cuda_device)
    assert plan.cluster == 16 and plan.resident
    _plan_with(monkeypatch, cluster=8)
    eight, plan = _kernel(ut, f, SCALAR, cuda_device)
    assert plan.cluster == 8
    assert plan.resident == (dtype == torch.float32 or M < 128)
    _same(eight, res)


@pytest.mark.cuda
def test_refused_plan_raises(cuda_device, monkeypatch):
    """A plan the card cannot run (one CTA holding a 3×512² image's bands,
    ~12 MB of shared memory) raises; it is not retried in another form."""
    real = cluster_plan.vtv_plan

    def one_cta(M, N, C, itemsize):
        return real(M, N, C, itemsize)._replace(
            cluster=1, rows=M, resident=True,
            smem=(4 * C * (M + 4) + 16 * C) * N * itemsize)

    monkeypatch.setattr(vfc, "vtv_plan", one_cta)
    ut, f = images(1, 3, 512, 512)
    before = vfc.kernel_launches
    with pytest.raises(RuntimeError, match="single-loop VTV kernel"):
        _kernel(ut.float(), f.float(), SCALAR, cuda_device, outer=2)
    assert vfc.kernel_launches == before
