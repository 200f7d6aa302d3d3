"""The single-loop TV-L1 learner's cluster design (``csrc/single_loop_tvl1.cu``:
one thread-block cluster launch per outer step for the CP phase on the
bands of ``csrc/pd_cluster.cuh``, two launches per CG step) and its plan.

- On the CPU: the plan (``solvers/tvl1_cuda.py::tvl1_plan``, the TV-L1 CP
  kernel's rule of B, M, N and the dtype) for the learner's shapes: 128²
  in float32 and float64 at 1, 8, 16 and 64 images, uneven bands (24²,
  20×16, 22×24), 256² float64 (the largest square whose float64 bands fit
  in shared memory) and 512², whose bands do not fit; the plan leaves
  kernel A's, the single-loop TV learner's, the TGV² and VTV learners'
  plans and the CG block rule as they were; the CG block form (one
  partial block); the launches per outer step (24 at 10 CG steps); CPU
  tensors count no launch; bad carries and dtypes raise before the device.
- On the card (marked ``cuda``; they skip without one): the kernel against
  its plain version (``_single_loop_tvl1_plain`` on the card) on uneven
  bands (20×16, 22×24 and 16×20 at one, two and three images, the scalar
  weight and a 2×2 patch grid) in float64, and at 3×22×24 and one 128²
  image in float32: the plain version with its CG inner products and its
  pullback summed in the kernel's order (``chip_smoke.kernel_order``)
  gives the kernel's α, u and α trajectory to the bit, the cost and ‖g‖
  trajectories (read only, summed by torch.sum) at 1e-9 (float64) and
  chip_smoke.py's float32 tolerance; the bench image (``circle_sp_128_20``,
  float32) against the plain version as it is at ``chip_smoke.py``'s
  tolerances, two runs giving the same bits; the launches per outer step;
  the global-band path (a plan forced out of shared memory gives the bits
  of the resident one; 1×512² float64, whose bands do not fit, against
  the plain version in the kernel's order); 8 and 16 CTAs an image give
  the same bits; a plan the card refuses raises.

Why the kernel's order: on these noisy stacks the TV-L1 learner's
discrete switches (|u − f| = 1/γ_d, |∇u| = 1/γ_r) and its near-singular
first adjoint systems (|g| ~ 1e6, clipped before Adam) turn a reordered
sum into a difference of any size: the plain version as it is differs
from the kernel by up to 1.0 relative in ‖g‖ and 0.34 in α (float64,
measured on an H100), and so did the design before the cluster one,
whose bits the kernel gives.

Inputs: a disc, a bar and a ramp with a step under 20% salt-and-pepper
noise, made with numpy from a seed.  This file imports no JAX, so the
card's tests also run where JAX is not installed: ``python -m pytest
--noconftest tests/test_torch_first_order_tvl1_cluster.py -m cuda``.
"""

import numpy as np
import pytest
import torch

from bpldenoising_tpu_torch import _build, data
from bpldenoising_tpu_torch.bilevel import first_order_cuda as fc
from bpldenoising_tpu_torch.bilevel import first_order_tgv_cuda as tgc
from bpldenoising_tpu_torch.bilevel import first_order_tvl1 as lfo
from bpldenoising_tpu_torch.bilevel import first_order_tvl1_cuda as lfc
from bpldenoising_tpu_torch.bilevel import first_order_vtv_cuda as vfc
from bpldenoising_tpu_torch.solvers import cluster_plan, tvl1_cuda
from chip_smoke import kernel_order, kernel_order_strided, kernel_order_sum

KW = dict(lr=0.05, gamma_d=100.0, gamma_r=1000.0, tau0=0.99, sigma0=0.99,
          beta1=0.9, beta2=0.999, eps=1e-8, clip=1.0)
SCALAR = np.array(0.4)
PATCH = np.array([[0.4, 0.6], [0.3, 0.5]])
# chip_smoke.py's TOL_SLX_REL_F32["tvl1"], TOL_SL_U_F32, TOL_SL_GNORM_F32
TOL_REL_F32, TOL_U_F32, TOL_GNORM_F32 = 1e-5, 1e-4, 1e-3
TOL_F64 = 1e-9


def _band_bytes(rows, N, itemsize):
    """pd_plan's band at K = 1: u, ū and the two dual planes on rows + 4
    rows, and 16 halo-slot rows."""
    return (4 * (rows + 4) + 16) * N * itemsize


@pytest.mark.parametrize("B,M,N,itemsize,cluster,rows,resident", [
    (1, 128, 128, 4, 16, 8, True),     # the bench shape: 32 KB a CTA
    (1, 128, 128, 8, 16, 8, True),     # 64 KB
    (8, 128, 128, 4, 16, 8, True),     # 8·16 = 128 CTAs ≤ 132 SMs
    (16, 128, 128, 4, 8, 16, True),    # 16·16 > 132: 8 CTAs, 48 KB
    (64, 128, 128, 8, 8, 16, True),
    (1, 24, 24, 8, 8, 3, True),
    (2, 20, 16, 8, 8, 3, True),        # the 7th CTA owns two rows, the 8th none
    (3, 22, 24, 8, 8, 3, True),        # the 8th owns 22 − 21 rows
    (1, 1, 9, 4, 1, 1, True),          # one CTA: no neighbour
    (1, 256, 256, 8, 16, 16, True),    # 192 KB: the largest that fits
    (1, 512, 512, 8, 16, 32, False),   # 640 KB: global bands
    (1, 512, 512, 4, 16, 32, False),   # 320 KB
])
def test_tvl1_learner_plan(B, M, N, itemsize, cluster, rows, resident):
    """The plan from the shapes: the TV-L1 CP kernel's rule (up to 16 CTAs
    an image while B·16 ≤ 132, else up to 8), every CTA but the last with
    two rows or more, the band in shared memory when it fits in 227 KB."""
    assert lfc.tvl1_plan is tvl1_cuda.tvl1_plan
    plan = lfc.tvl1_plan(B, M, N, itemsize)
    assert (plan.cluster, plan.rows, plan.resident) == (cluster, rows,
                                                        resident)
    band = _band_bytes(rows, N, itemsize)
    assert plan.planes == 4
    assert plan.smem == (band if resident else 0)
    assert (band <= cluster_plan.SMEM_PER_BLOCK) == resident
    assert rows * cluster >= M and (cluster == 1 or rows >= 2)


def test_plan_leaves_the_other_band_kernels_alone():
    """Row 12 takes the TV-L1 CP kernel's rule as it is: kernel A's, the
    single-loop TV learner's, the TV-L1 kernel's, the TGV² and VTV
    learners' plans and the CG block rule are what they were."""
    assert cluster_plan.pd_plan(128, 128, 1, 4) == cluster_plan.PdPlan(
        8, 16, 4, 49152, True)
    assert cluster_plan.pd_plan(128, 128, 3, 8) == cluster_plan.PdPlan(
        8, 16, 8, 212992, True)
    assert tvl1_cuda.tvl1_plan(1, 128, 128, 4) == cluster_plan.PdPlan(
        16, 8, 4, 32768, True)
    assert tvl1_cuda.tvl1_plan(64, 128, 128, 4) == cluster_plan.PdPlan(
        8, 16, 4, 49152, True)
    assert cluster_plan.tgv_plan(128, 128, 4) == cluster_plan.PdPlan(
        16, 8, 11, 88064, True)
    assert cluster_plan.tgv_plan(256, 256, 4) == cluster_plan.PdPlan(
        16, 16, 11, 0, False)
    assert cluster_plan.vtv_plan(128, 128, 3, 4) == cluster_plan.PdPlan(
        16, 8, 12, 98304, True)
    assert cluster_plan.vtv_plan(256, 256, 3, 8) == cluster_plan.PdPlan(
        16, 16, 12, 0, False)
    assert cluster_plan.cg_block_slots(1, 128, 128, 3) == 1
    assert cluster_plan.cg_block_slots(6, 128, 128, 3) == 3
    assert cluster_plan.cg_block_slots(10, 128, 128, 3) == 3
    assert cluster_plan.cg_block_slots(64, 16, 20, 3) == 1
    assert tgc.cg_slots(3, 128, 128) == 3 and vfc.cg_slots(6, 128, 128, 3) \
        == 3


@pytest.mark.parametrize("B,M,N", [(1, 128, 128), (64, 128, 128),
                                   (3, 20, 16), (1, 512, 512)])
def test_cg_block_is_one_partial_block(B, M, N):
    """One plane: a CG block takes one 256-pixel partial block, whatever
    the batch (the shared rule at one plane)."""
    assert cluster_plan.cg_block_slots(B, M, N, 1) == 1


@pytest.mark.parametrize("n_adj,want", [(10, 24), (4, 12), (0, 4)])
def test_launches_per_step(n_adj, want):
    """One CP launch, the set-up launch, two a CG step and the two of the
    tail: rows 9–11's and 13's count (4 + 2·n_adj)."""
    assert lfc.launches_per_step is fc.launches_per_step
    assert lfc.launches_per_step(n_adj) == want


def images(B, M, N, seed=0):
    """(utrue, f): B images of M × N in float64 (a disc, a bar and a ramp
    with a step, rolled per image) under 20% salt-and-pepper noise, made
    with numpy from a seed."""
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.arange(M), np.arange(N), indexing="ij")
    disc = (yy - M / 2) ** 2 + (xx - N / 2) ** 2 < (min(M, N) / 3) ** 2
    bar = (xx > N // 4) & (xx < N // 2)
    ramp = 0.02 * xx + 0.5 * (yy > M // 2)
    planes = np.stack([disc, bar, ramp]).astype(np.float64)
    clean = np.stack([np.roll(planes[b % 3], b, axis=0) for b in range(B)])
    noisy = clean.copy()
    hits = rng.uniform(size=clean.shape)
    noisy[hits < 0.1] = 1.0              # salt
    noisy[hits > 0.9] = 0.0              # pepper
    return torch.as_tensor(clean), torch.as_tensor(noisy)


def _counts():
    return lfc.launches, lfc.kernel_launches, lfc.last_plan, \
        lfc.last_cg_slots


@pytest.mark.parametrize("x0", [SCALAR, PATCH], ids=["scalar", "patch"])
def test_cpu_tensors_count_no_kernel_launch(x0):
    """On CPU tensors the learner runs its plain loop: no wrapper launch,
    no kernel launch, no plan, no CG form."""
    ut, f = images(2, 10, 12)
    before = _counts()
    res = lfo.single_loop_tvl1_learn(ut, f, x0, outer=3, n_inner=4,
                                     n_adj=2, lr=0.05)
    assert res.u.shape == (2, 10, 12)
    assert np.all(np.isfinite(res.cost_trajectory.numpy()))
    assert _counts() == before


def _carry(B, M, N):
    ut, f = images(B, M, N)
    _, _, x0t, pop, shape, _ = lfo._prepare(ut, f, SCALAR)
    return ut, f, lfo._tvl1_init_carry(f, x0t, param_shape=shape), pop, \
        shape


def _bad_cases():
    """(label, change of the launch's arguments, error, match)."""
    names = ("u", "y", "p", "z", "mv", "t")

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
        ("u shape", carry_with("u", lambda a: a[:, :4]), ValueError,
         "carry u"),
        ("u images", carry_with("u", lambda a: a[:1]), ValueError,
         "carry u"),
        ("y components", carry_with("y", lambda a: a[:, :1]), ValueError,
         "carry y"),
        ("y dtype", carry_with("y", lambda a: a.float()), ValueError,
         "carry y"),
        ("p shape", carry_with("p", lambda a: a[:1]), ValueError,
         "carry p"),
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
    ut, f, carry, pop, shape = _carry(2, 8, 10)
    args = dict(utrue=ut, f=f, carry=carry)
    change(args)
    before = _counts()
    with pytest.raises(err, match=match):
        lfc._launch(args["utrue"], args["f"], args["carry"], outer=2,
                    n_inner=3, n_adj=2, pop=pop, param_shape=shape, **KW)
    assert _counts() == before


# ---- on the card

@pytest.fixture
def cuda_device():
    """The card, for tests marked ``cuda``; they skip without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (python -m pytest --noconftest "
                    "tests/test_torch_first_order_tvl1_cluster.py -m cuda)")
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


def _args(ut, f, x0, device, outer, **kw):
    ut, f = ut.to(device), f.to(device)
    _, _, x0t, pop, shape, _ = lfo._prepare(ut, f, x0)
    return ut, f, x0t, dict(outer=outer, pop=pop, param_shape=shape,
                            **dict(KW, **kw))


def _run(ut, f, x0, device, outer, as_is=False, **kw):
    """(kernel result, plain result, kernel launches per outer step) on
    the card; the plain version with its sums in the kernel's order, or as
    it is."""
    ut, f, x0t, args = _args(ut, f, x0, device, outer, **kw)
    launched, calls = lfc.kernel_launches, lfc.launches
    k = lfo._single_loop_tvl1_impl(ut, f, x0t, **args)
    torch.cuda.synchronize()
    assert lfc.launches == calls + 1
    per_step = (lfc.kernel_launches - launched - 1) / outer
    if as_is:
        p = lfo._single_loop_tvl1_plain(ut, f, x0t, **args)
    else:
        with kernel_order(lfo):
            p = lfo._single_loop_tvl1_plain(ut, f, x0t, **args)
    return k, p, per_step


def _same(a, b, names=("alpha", "u", "alpha_trajectory", "cost_trajectory",
                       "gnorm_trajectory")):
    for name in names:
        assert torch.equal(getattr(a, name), getattr(b, name)), name


def _bits_of_the_kernel_order(k, p, tol):
    """α, u and the α trajectory to the bit; the cost and ‖g‖ trajectories
    within ``tol`` relative."""
    _same(k, p, ("alpha", "u", "alpha_trajectory"))
    errs = _errors(k, p)
    assert max(errs["cost_traj"], errs["gnorm_traj"]) <= tol, errs


def _tree(values):
    """common.cuh's block_sum over 256 threads, spelt out."""
    v = list(values) + [0.0] * (256 - len(values))
    s = 128
    while s:
        v = [v[t] + v[t + s] if t < s else v[t] for t in range(256)]
        s //= 2
    return v[0]


def _strided(values):
    """Thread t adds values t, t + 256, … in turn from 0, then a
    block_sum."""
    acc = []
    for t in range(256):
        c = 0.0
        for v in values[t::256]:
            c = c + v
        acc.append(c)
    return _tree(acc)


@pytest.mark.parametrize("n", [1, 255, 256, 700, 70000])
def test_kernel_order_sums(n):
    """chip_smoke.py's sums in the kernels' order, spelt out: an image's
    inner product (a block_sum per 256 elements, then the partials summed
    by thread t from t in steps of 256, then a block_sum) and the
    pullback's strided sum."""
    x = torch.as_tensor(np.random.default_rng(n).standard_normal(n))
    xs = x.tolist()
    parts = [_tree(xs[i:i + 256]) for i in range(0, n, 256)]
    assert float(kernel_order_sum(x)) == _strided(parts)
    assert float(kernel_order_strided(x)) == _strided(xs)
    assert abs(float(kernel_order_sum(x)) - float(x.sum())) < 1e-10


def test_kernel_order_plain_version_on_the_cpu():
    """The plain version with its sums in the kernel's order runs on the
    CPU, lands near the plain version as it is on a few steps, and gives
    the module its own functions back after the block."""
    ut, f = images(2, 16, 20, seed=2)
    real = lfo.cg_batched, lfo.pullback
    _, _, x0t, pop, shape, _ = lfo._prepare(ut, f, PATCH)
    args = dict(outer=3, n_inner=4, n_adj=2, pop=pop, param_shape=shape,
                **KW)
    with kernel_order(lfo):
        p = lfo._single_loop_tvl1_plain(ut, f, x0t, **args)
    assert (lfo.cg_batched, lfo.pullback) == real
    q = lfo._single_loop_tvl1_plain(ut, f, x0t, **args)
    assert np.all(np.isfinite(p.cost_trajectory.numpy()))
    assert _rel(p.alpha_trajectory, q.alpha_trajectory) < 1e-6


def _plan_with(monkeypatch, **change):
    """Make the wrapper plan ``change`` (resident=False: the global bands;
    cluster=n: n CTAs an image, in shared memory where the band fits)
    whatever the shapes."""
    real = tvl1_cuda.tvl1_plan

    def plan(B, M, N, itemsize):
        p = real(B, M, N, itemsize)
        if change.get("resident", True) is False:
            return p._replace(resident=False, smem=0)
        n = change["cluster"]
        rows = -(-M // n)
        smem = _band_bytes(rows, N, itemsize)
        fits = smem <= cluster_plan.SMEM_PER_BLOCK
        return p._replace(cluster=n, rows=rows, smem=smem if fits else 0,
                          resident=fits)

    monkeypatch.setattr(lfc, "tvl1_plan", plan)


@pytest.mark.cuda
@pytest.mark.parametrize("x0", [SCALAR, PATCH], ids=["scalar", "patch"])
@pytest.mark.parametrize("B", [1, 2, 3])
@pytest.mark.parametrize("M,N", [(20, 16), (22, 24), (16, 20)],
                         ids=["20x16", "22x24", "16x20"])
def test_kernel_matches_plain_float64(cuda_device, M, N, B, x0):
    ut, f = images(B, M, N, seed=B)
    k, p, per_step = _run(ut, f, x0, cuda_device, outer=12, n_inner=8,
                          n_adj=4)
    assert lfc.last_plan == lfc.tvl1_plan(B, M, N, 8)
    assert lfc.last_cg_slots == 1
    assert per_step == lfc.launches_per_step(4)
    _bits_of_the_kernel_order(k, p, TOL_F64)


@pytest.mark.cuda
@pytest.mark.parametrize("B,M,N,x0", [(1, 128, 128, PATCH),
                                      (3, 22, 24, PATCH),
                                      (3, 22, 24, SCALAR)],
                         ids=["1x128x128-patch", "3x22x24-patch",
                              "3x22x24-scalar"])
def test_kernel_matches_plain_float32(cuda_device, B, M, N, x0):
    """float32, 40 CP and 10 CG steps: the bits of the plain version in
    the kernel's order."""
    ut, f = images(B, M, N, seed=4)
    k, p, per_step = _run(ut.float(), f.float(), x0, cuda_device, outer=20,
                          n_inner=40, n_adj=10)
    assert per_step == lfc.launches_per_step(10) == 24
    _bits_of_the_kernel_order(k, p, TOL_REL_F32)


@pytest.mark.cuda
def test_bench_image_float32(cuda_device):
    """The bench shape (the first ``circle_sp_128_20`` image, float32, from
    0.4, 30 outer steps of 40 CP and 10 CG steps: chip_smoke.py's phase
    (b)) against the plain version as it is at chip_smoke.py's
    tolerances; a second run of the kernel gives the same bits."""
    true_np, noisy_np = data.testdataset("circle_sp_128_20")
    ut = torch.as_tensor(true_np[:1], dtype=torch.float32)
    f = torch.as_tensor(noisy_np[:1], dtype=torch.float32)
    k, p, per_step = _run(ut, f, SCALAR, cuda_device, outer=30, as_is=True,
                          n_inner=40, n_adj=10)
    assert per_step == 24 and lfc.last_plan.cluster == 16
    errs = _errors(k, p)
    assert max(errs["alpha"], errs["alpha_traj"], errs["cost_traj"]) \
        <= TOL_REL_F32, errs
    assert errs["u"] <= TOL_U_F32 and errs["gnorm_traj"] <= TOL_GNORM_F32, \
        errs
    ut, f, x0t, args = _args(ut, f, SCALAR, cuda_device, 30, n_inner=40,
                             n_adj=10)
    again = lfo._single_loop_tvl1_impl(ut, f, x0t, **args)
    _same(again, k)


def _kernel(ut, f, x0, device, outer=10, **kw):
    ut, f, x0t, args = _args(ut, f, x0, device, outer,
                             **dict(dict(n_inner=8, n_adj=4), **kw))
    res = lfo._single_loop_tvl1_impl(ut, f, x0t, **args)
    torch.cuda.synchronize()
    return res, lfc.last_plan


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
def test_bands_that_do_not_fit_run_in_global_memory(cuda_device):
    """1×512² float64: the plan's bands (640 KB) live in global memory;
    the bits of the plain version in the kernel's order."""
    ut, f = images(1, 512, 512, seed=6)
    assert not lfc.tvl1_plan(1, 512, 512, 8).resident
    k, p, per_step = _run(ut, f, SCALAR, cuda_device, outer=3, n_inner=8,
                          n_adj=4)
    assert not lfc.last_plan.resident and per_step == 12
    _bits_of_the_kernel_order(k, p, TOL_F64)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("B,M,N", [(1, 128, 128), (2, 40, 36)],
                         ids=["1x128x128", "2x40x36"])
def test_sixteen_ctas_give_the_bits_of_eight(cuda_device, monkeypatch, B, M,
                                             N, dtype):
    """The plan's 16 CTAs an image (a non-portable cluster) give the bits
    of 8."""
    ut, f = images(B, M, N, seed=7)
    ut, f = ut.to(dtype), f.to(dtype)
    res, plan = _kernel(ut, f, SCALAR, cuda_device)
    assert plan.cluster == 16 and plan.resident
    _plan_with(monkeypatch, cluster=8)
    eight, plan = _kernel(ut, f, SCALAR, cuda_device)
    assert plan.cluster == 8 and plan.resident
    _same(eight, res)


@pytest.mark.cuda
def test_refused_plan_raises(cuda_device, monkeypatch):
    """A plan the card cannot run (one CTA holding a 512² image's bands,
    ~2.6 MB of shared memory) raises; it is not retried in another form."""
    real = tvl1_cuda.tvl1_plan

    def one_cta(B, M, N, itemsize):
        return real(B, M, N, itemsize)._replace(
            cluster=1, rows=M, resident=True,
            smem=_band_bytes(M, N, itemsize))

    monkeypatch.setattr(lfc, "tvl1_plan", one_cta)
    ut, f = images(1, 512, 512)
    before = lfc.kernel_launches
    with pytest.raises(RuntimeError, match="single-loop TV-L1 kernel"):
        _kernel(ut.float(), f.float(), SCALAR, cuda_device, outer=2)
    assert lfc.kernel_launches == before
