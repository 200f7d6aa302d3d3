"""The port's single-loop learner (bilevel/first_order.py, its plain
version on the CPU) and its entry points against the JAX package on the
same float64 data: the jnp scan (``single_loop_learn``) for the four
parameterizations and both CG forms, the Pallas kernels in interpret mode
(``single_loop_pallas``, TPU kernel 9, and ``single_loop_pallas_tiled``
with two images per tile, TPU kernel 10), segmented runs, a JAX carry
resumed in the port, the four ``method="single_loop"`` entry points with
their ``state.log``, and the refusals.

Inputs: a 16×16 disc under Gaussian noise, three images, made with numpy
from a seed; the bundled ``circle`` dataset for the entry points.

Tolerance: 1e-9 relative on α, u and the three trajectories, the
tolerance the JAX package holds its Pallas kernel to
(``tests/test_first_order_pallas.py:84-103``); measured ≤ 4e-15.  Tests
marked ``cuda`` hold the CUDA learner against its plain version on the
card and skip without one.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bpldenoising_tpu.bilevel import first_order as jfo
from bpldenoising_tpu.bilevel.first_order_pallas import (
    single_loop_pallas, single_loop_pallas_tiled)
from bpldenoising_tpu.experiments import api as japi
from bpldenoising_tpu.models import sumregs_model as j_sumregs
from bpldenoising_tpu.models import tv_model as j_tv
from bpldenoising_tpu_torch import experiments as tx
from bpldenoising_tpu_torch.bilevel import first_order as tfo
from bpldenoising_tpu_torch.bilevel import first_order_cuda as tfc
from bpldenoising_tpu_torch.models import sumregs_model, tv_model
from bpldenoising_tpu_torch.weights import from_jax_state
from test_torch_fused import one_torch_thread  # noqa: F401 (autouse)

RTOL = 1e-9
KW = dict(outer=20, n_inner=8, n_adj=4, lr=0.05)

PARAMS = {
    # name: (JAX model, port model, x0)
    "tv-scalar": (j_tv, tv_model, np.array(0.02)),
    "tv-patch": (j_tv, tv_model, np.full((2, 2), 0.02)),
    "sumregs-vector": (j_sumregs, sumregs_model,
                       np.array([0.02, 0.015, 0.01])),
    "sumregs-patch": (j_sumregs, sumregs_model, np.full((2, 2, 3), 0.02)),
}


def disc_stack(O=3, n=16, seed=0):
    rng = np.random.default_rng(seed)
    x, y = np.meshgrid(np.arange(n), np.arange(n))
    clean = ((x - n / 2) ** 2 + (y - n / 2) ** 2
             < (n / 3) ** 2).astype(np.float64)
    true_ = np.stack([clean] * O)
    return true_, true_ + 0.1 * rng.standard_normal((O, n, n))


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _close(got, want, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=1e-13)


def _compare(tres, jres):
    _close(tres.alpha, jres.alpha)
    _close(tres.u, jres.u)
    _close(tres.alpha_trajectory, jres.alpha_trajectory)
    _close(tres.cost_trajectory, jres.cost_trajectory)
    _close(tres.gnorm_trajectory, jres.gnorm_trajectory)
    _close(tres.cost, jres.cost)


@pytest.mark.parametrize("variant", ["classic", "pipelined"])
@pytest.mark.parametrize("name", list(PARAMS))
def test_plain_learner_matches_jax_scan(name, variant):
    jm, tm, x0 = PARAMS[name]
    ut, f = disc_stack()
    jres = jfo.single_loop_learn(jnp.asarray(ut), jnp.asarray(f),
                                 jnp.asarray(x0), jm(), cg_variant=variant,
                                 **KW)
    tres = tfo.single_loop_learn(_t(ut), _t(f), x0, tm(), cg_variant=variant,
                                 **KW)
    assert tuple(tres.alpha.shape) == x0.shape
    assert tuple(tres.alpha_trajectory.shape) == (KW["outer"],) + x0.shape
    _compare(tres, jres)


@pytest.mark.parametrize("name", list(PARAMS))
def test_plain_learner_matches_pallas_kernel(name):
    """TPU kernel 9 in interpret mode, through the port's counterpart of
    its entry point (the plain version on CPU tensors)."""
    jm, tm, x0 = PARAMS[name]
    ut, f = disc_stack()
    jx, ju, jtraj = single_loop_pallas(jnp.asarray(ut), jnp.asarray(f),
                                       jnp.asarray(x0), jm(), interpret=True,
                                       **KW)
    x, u, traj = tfc.single_loop_cuda(_t(ut), _t(f), x0, tm(), **KW)
    _close(x, jx)
    _close(u, ju)
    _close(traj, jtraj)


@pytest.mark.parametrize("name", list(PARAMS))
def test_per_tile_learner_matches_tiled_pallas_kernel(name):
    """TPU kernel 10 in interpret mode with two images per tile (three
    images: the last tile is short, padded by the JAX kernel), against
    the port's plain per-tile version."""
    jm, tm, x0 = PARAMS[name]
    ut, f = disc_stack()
    jx, ju, jtraj = single_loop_pallas_tiled(
        jnp.asarray(ut), jnp.asarray(f), jnp.asarray(x0), jm(),
        interpret=True, tile_b=2, **KW)
    x, u, traj = tfc.single_loop_cuda_tiled(_t(ut), _t(f), x0, tm(),
                                            tile_b=2, **KW)
    _close(x, jx)
    _close(u, ju)
    _close(traj, jtraj)


def test_one_tile_is_the_scan_and_tiles_differ():
    """tile_b=None (one tile) is the whole-batch learner bit for bit; two
    images per tile follow another (per-tile) CG."""
    ut, f = disc_stack()
    one = tfc.single_loop_cuda_tiled(_t(ut), _t(f), 0.02, **KW)
    whole = tfc.single_loop_tv_cuda(_t(ut), _t(f), 0.02, **KW)
    tiled = tfc.single_loop_cuda_tiled(_t(ut), _t(f), 0.02, tile_b=2, **KW)
    for a, b in zip(one, whole):
        assert torch.equal(a, b)
    assert not torch.equal(tiled[1], whole[1])


def test_single_image_and_library_wrappers():
    """A 2-D image comes back 2-D, as from the JAX functions; the learn
    wrappers name their models."""
    ut, f = disc_stack(O=1)
    x, u, traj = tfc.single_loop_tv_cuda(_t(ut[0]), _t(f[0]), 0.02,
                                         outer=5, n_inner=4, n_adj=2)
    jx, ju, jtraj = single_loop_pallas(jnp.asarray(ut[0]),
                                       jnp.asarray(f[0]), 0.02, j_tv(),
                                       interpret=True, outer=5, n_inner=4,
                                       n_adj=2)
    assert u.shape == (16, 16) and traj.shape == (5,)
    _close(x, jx)
    _close(u, ju)
    res = tfo.single_loop_sumregs_learn(_t(ut[0]), _t(f[0]),
                                        np.array([0.02, 0.015, 0.01]),
                                        outer=3, n_inner=4, n_adj=2)
    jres = jfo.single_loop_sumregs_learn(jnp.asarray(ut[0]),
                                         jnp.asarray(f[0]),
                                         jnp.asarray([0.02, 0.015, 0.01]),
                                         outer=3, n_inner=4, n_adj=2)
    assert res.u.shape == (16, 16)
    _compare(res, jres)


def test_segments_match_one_run():
    """log_every segments hand the whole carry on (the step counter and
    Adam's moments too): the same numbers as one run, and real,
    cumulative segment-end times."""
    ut, f = disc_stack(O=1)
    kw = dict(outer=30, n_inner=6, n_adj=3, lr=0.05)
    one = tfo.single_loop_tv_learn(_t(ut), _t(f), 0.05, **kw)
    seg = tfo.single_loop_tv_learn(_t(ut), _t(f), 0.05, log_every=7, **kw)
    jseg = jfo.single_loop_tv_learn(jnp.asarray(ut), jnp.asarray(f),
                                    alpha0=0.05, log_every=7, **kw)
    for name in ("alpha", "u", "alpha_trajectory", "cost_trajectory",
                 "gnorm_trajectory"):
        assert torch.equal(getattr(seg, name), getattr(one, name)), name
    _compare(seg, jseg)
    assert one.times is None
    assert seg.times.shape == (30,)
    assert np.all(seg.times > 0) and np.all(np.diff(seg.times) >= 0)
    assert len(set(seg.times.tolist())) == 5   # one time per segment


def test_segment_callback():
    ut, f = disc_stack(O=1)
    hops = []
    tfo.single_loop_tv_learn(_t(ut), _t(f), 0.05, outer=10, n_inner=3,
                             n_adj=2, log_every=4,
                             segment_callback=lambda it, t: hops.append(
                                 (it, t)))
    assert [h[0] for h in hops] == [4, 8, 10]
    assert all(t > 0 for _, t in hops)


@pytest.mark.parametrize("name", ["tv-patch", "sumregs-vector"])
def test_jax_carry_resumes_in_the_port(name):
    """A JAX segment's carry (u, ys, p, z, (m, v), t), handed over by
    from_jax_state, continues in the port as the JAX package continues."""
    jm, tm, x0 = PARAMS[name]
    ut, f = disc_stack()
    utj, fj, x0j = jnp.asarray(ut), jnp.asarray(f), jnp.asarray(x0)
    jpop, shape = jfo._param_layout(jm(), x0j, f.shape[-2:])
    jkw = dict(model=jm(), n_inner=6, n_adj=3, pop=jpop, param_shape=shape,
               lr=0.05, gamma=1e4, tau0=5.0, sigma0=0.99 / 5.0, beta1=0.9,
               beta2=0.999, eps=1e-8)
    _, carry = jfo._single_loop_impl(utj, fj, x0j, outer=8,
                                     return_carry=True, **jkw)
    jres = jfo._single_loop_impl(utj, fj, x0j, outer=7, carry0=carry,
                                 **jkw)
    tpop, _ = tfo._param_layout(tm(), _t(x0), f.shape[-2:])
    tres = tfo._single_loop_impl(
        _t(ut), _t(f), _t(x0), **dict(jkw, model=tm(), pop=tpop), outer=7,
        carry0=from_jax_state(carry, device="cpu"))
    _compare(tres, jres)


ENTRY = ["scalar_bilevel_tv_learn", "patch_bilevel_tv_learn",
         "scalar_bilevel_sumregs_learn", "patch_bilevel_sumregs_learn"]
SL = dict(dataset_name="circle", num_samples=2, method="single_loop",
          sl_outer=6, sl_inner=5, sl_adj=3)


@pytest.mark.parametrize("entry", ENTRY)
def test_entry_points_match_jax(entry, tmp_path, monkeypatch):
    """The four method="single_loop" entry points on the CPU against the
    JAX package's: x, u, cost, ‖g‖ and the state.log entries (step, cost,
    ‖g‖, parameter step; the radius NaN).  Times are real, not compared."""
    monkeypatch.chdir(tmp_path)   # the JAX entry points may write output/
    jres = getattr(japi, entry)(save_results=False, **SL)
    tres = getattr(tx, entry)(device="cpu", **SL)
    assert isinstance(tres.x, np.ndarray) and isinstance(tres.u, np.ndarray)
    assert tres.iterations == jres.iterations == SL["sl_outer"]
    _close(tres.x, jres.x)
    _close(tres.u, jres.u)
    _close(tres.cost, jres.cost)
    _close(tres.g_norm, jres.g_norm)
    assert len(tres.state.log) == len(jres.state.log) == SL["sl_outer"]
    for a, b in zip(tres.state.log, jres.state.log):
        assert a.iter == b.iter and np.isnan(a.delta)
        _close([a.function_value, a.g_norm], [b.function_value, b.g_norm])
        np.testing.assert_allclose(a.step_norm, b.step_norm, rtol=RTOL,
                                   atol=1e-15)
    times = [e.time for e in tres.state.log]
    assert all(t > 0 for t in times) and times == sorted(times)


@pytest.mark.parametrize("method", ["tr", "tr_fused"])
@pytest.mark.parametrize("entry", ENTRY[1:])
def test_new_entry_points_refuse_the_trust_region(entry, method, tmp_path,
                                                  monkeypatch):
    """Both trust regions run: the host-driven one (method="tr") against
    the JAX entry point at 1e-8 (its whole comparison is in
    tests/test_torch_tr_learn.py), the fused one (against the JAX package:
    tests/test_torch_fused_sumregs.py)."""
    kw = dict(SL, method=method, maxiter=1, inner_maxiter=20)
    res = getattr(tx, entry)(device="cpu", **kw)
    assert res.iterations == 1 and len(res.state.log) == 1
    assert np.all(np.isfinite(res.x)) and np.isfinite(res.cost)
    if method == "tr":
        monkeypatch.chdir(tmp_path)   # the JAX entry points write output/
        jres = getattr(japi, entry)(save_results=False, backend="jnp", **kw)
        _close(res.x, jres.x)
        _close(res.cost, jres.cost)
        _close(res.u, jres.u)


def test_refusals():
    """What is not ported raises: data_parallel, mesh= and optimizer=; x₀ ≤
    0 at every entry of the learner.  The image_pair form runs the host
    trust region whatever ``method`` says (against the JAX package:
    tests/test_torch_tr_learn.py)."""
    with pytest.raises(NotImplementedError, match="data_parallel"):
        tx.scalar_bilevel_tv_learn(device="cpu", **dict(SL,
                                                        data_parallel=True))
    clean, noisy = disc_stack(O=1)
    res = tx.patch_bilevel_sumregs_learn(
        image_pair=(clean[0], noisy[0]), device="cpu",
        **dict(SL, maxiter=1, inner_maxiter=20))
    assert res.x.shape == (2, 2, 3) and res.u.shape == (1,) + clean.shape[1:]
    assert res.iterations == 1 and np.isfinite(res.cost)
    ut, f = disc_stack(O=1)
    with pytest.raises(NotImplementedError, match="mesh"):
        tfo.single_loop_tv_learn(_t(ut), _t(f), 0.05, mesh=object())
    with pytest.raises(NotImplementedError, match="optax"):
        tfo.single_loop_tv_learn(_t(ut), _t(f), 0.05, optimizer=object())
    for bad in (0.0, -0.1, np.array([0.1, 0.0, 0.1])):
        model = tv_model() if np.ndim(bad) == 0 else sumregs_model()
        for learn in (lambda: tfo.single_loop_learn(_t(ut), _t(f), bad,
                                                    model, outer=1),
                      lambda: tfc.single_loop_cuda(_t(ut), _t(f), bad,
                                                   model, outer=1),
                      lambda: tfc.single_loop_cuda_tiled(_t(ut), _t(f), bad,
                                                         model, outer=1)):
            with pytest.raises(ValueError, match="strictly positive"):
                learn()
    with pytest.raises(ValueError, match="unsupported parameter shape"):
        tfo.single_loop_learn(_t(ut), _t(f), np.full((3,), 0.1), tv_model())


@pytest.mark.parametrize("flag", ["checkpoint", "resume", "save_iterations",
                                  "inner_tol"])
def test_single_loop_rejects_the_jax_flags(flag):
    """The JAX package's _reject_flags set, with its ValueError."""
    with pytest.raises(ValueError, match=flag):
        tx.scalar_bilevel_tv_learn(device="cpu", **dict(SL, **{flag: 1e-3}))


def test_no_plain_loop_off_the_cpu(monkeypatch):
    """A tensor that is not on the CPU never reaches the plain loop: the
    wrapper launches the kernel or raises (here: a meta tensor, and the
    card that this machine lacks)."""
    def forbidden(*a, **k):
        raise AssertionError("the plain loop ran")
    monkeypatch.setattr(tfo, "_single_loop_plain", forbidden)
    f = torch.zeros((2, 8, 8), dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        tfo.single_loop_tv_learn(f, f, 0.05, outer=2)
    with pytest.raises(ValueError, match="CUDA"):     # CG form defaulted
        tfo._single_loop_impl(f, f, torch.tensor(0.05, device="meta"),
                              model=tv_model(), outer=1, n_inner=1, n_adj=1,
                              pop=None, param_shape=(), lr=0.05, gamma=1e4,
                              tau0=5.0, sigma0=0.2, beta1=0.9, beta2=0.999,
                              eps=1e-8)
    with pytest.raises(ValueError, match="CUDA"):
        tfc._launch(torch.zeros((2, 8, 8), dtype=torch.float64),
                    torch.zeros((2, 8, 8), dtype=torch.float64), None,
                    model=tv_model(), outer=1, n_inner=1, n_adj=1, pop=None,
                    param_shape=(), lr=0.05, gamma=1e4, tau0=5.0,
                    sigma0=0.2, beta1=0.9, beta2=0.999, eps=1e-8,
                    cg_variant="classic", tile_b=None)
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            tx.scalar_bilevel_tv_learn(**SL)     # device="cuda" by default


def test_kinds_and_layouts():
    """The kernel's stencil codes and its (K, P) parameter layout."""
    assert tfc._kinds_code(sumregs_model()) == 0 | 1 << 2 | 2 << 4
    assert tfc._kinds_code(tv_model()) == 0
    from bpldenoising_tpu_torch.models import vtv_model
    with pytest.raises(NotImplementedError):
        tfc._kinds_code(vtv_model())
    x = torch.arange(12.0).reshape(2, 2, 3)
    kp = tfc._to_kp(x, 3, 4)
    assert torch.equal(kp[1], x[..., 1].reshape(-1))
    assert torch.equal(tfc._from_kp(kp, (2, 2, 3)), x)
    traj = torch.stack([kp, 2 * kp])
    assert torch.equal(tfc._from_kp(traj, (2, 2, 3))[1], 2 * x)


@pytest.fixture
def cuda_device():
    """The card, for tests marked ``cuda``; they skip without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (python -m pytest "
                    "tests/test_torch_first_order.py -m cuda)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["classic", "pipelined"])
@pytest.mark.parametrize("name", list(PARAMS))
def test_kernel_matches_plain_version_on_the_card(cuda_device, name,
                                                  variant):
    _, tm, x0 = PARAMS[name]
    ut, f = disc_stack()
    before = tfc.launches
    k = tfo.single_loop_learn(_t(ut).to(cuda_device), _t(f).to(cuda_device),
                              x0, tm(), cg_variant=variant, **KW)
    assert tfc.launches == before + 1
    p = tfo.single_loop_learn(_t(ut), _t(f), x0, tm(), cg_variant=variant,
                              **KW)
    for a, b in zip(k[:5], p[:5]):
        _close(a.cpu(), b)


@pytest.mark.parametrize("M,N,K,itemsize,cluster,rows,resident", [
    (128, 128, 1, 4, 8, 16, True),     # row 9: 48 KB a CTA
    (128, 128, 3, 4, 8, 16, True),     # row 10: 104 KB, two CTAs an SM
    (128, 128, 3, 8, 8, 16, True),     # float64, 208 KB
    (16, 20, 3, 8, 8, 2, True),
    (20, 16, 1, 4, 8, 3, True),        # 7 CTAs own rows, the 8th none
    (22, 24, 3, 8, 8, 3, True),        # the 8th CTA owns one row
    (13, 24, 1, 4, 4, 4, True),        # 4, 4, 4 and 1 rows
    (5, 7, 1, 8, 2, 3, True),
    (3, 9, 1, 4, 1, 3, True),          # one CTA: no halo from a neighbour
    (1, 9, 1, 4, 1, 1, True),
    (512, 512, 1, 4, 8, 64, False),    # 272 KB a CTA: global bands
    (128, 128, 8, 8, 8, 16, False),    # K = 8 in float64
])
def test_pd_plan(M, N, K, itemsize, cluster, rows, resident):
    """The PD phase's cluster rule: a power of two up to 8 CTAs leaving
    every CTA but the last two rows or more; ⌈M / cluster⌉ rows each; the
    2 + 2K band planes of rows + 4 rows and 16K halo-slot rows in shared
    memory when they fit in 227 KB."""
    plan = tfc.pd_plan(M, N, K, itemsize)
    assert (plan.cluster, plan.rows, plan.resident) == (cluster, rows,
                                                        resident)
    assert plan.planes == 2 + 2 * K
    assert plan.rows * plan.cluster >= M > (plan.rows - 1) * plan.cluster
    assert plan.cluster == 1 or plan.rows >= 2
    band = (plan.planes * (plan.rows + 4) + 16 * K) * N * itemsize
    assert plan.smem == (band if resident else 0)
    assert (band <= tfc.SMEM_PER_BLOCK) == resident
    with pytest.raises(ValueError):
        tfc.pd_plan(0, N, K, itemsize)


def test_launches_per_step():
    """The C loop's launches per outer step: the PD cluster launch, the CG
    start, two launches per classic CG step (one per pipelined step, plus
    the last update), the gradient maps and the pullback with Adam."""
    assert tfc.launches_per_step(10) == 24
    assert tfc.launches_per_step(10, "pipelined") == 15
    assert tfc.launches_per_step(0, "pipelined") == 4


ODD_SHAPES = [(3, 16, 20), (3, 20, 16), (2, 22, 24)]


def _odd_stack(B, M, N, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.arange(M), np.arange(N), indexing="ij")
    clean = np.stack([((xx - N / 2 - b) ** 2 + (yy - M / 2) ** 2
                       < (min(M, N) / 3) ** 2).astype(np.float64)
                      for b in range(B)])
    return clean, clean + 0.1 * rng.standard_normal(clean.shape)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("variant,tile_b", [("classic", None),
                                            ("pipelined", None),
                                            ("classic", 2)])
@pytest.mark.parametrize("name", list(PARAMS))
@pytest.mark.parametrize("shape", ODD_SHAPES)
def test_cluster_kernel_matches_plain_on_odd_shapes(cuda_device, shape,
                                                    name, variant, tile_b,
                                                    dtype):
    """The PD cluster bands and the CG tiles' halos on shapes whose rows
    do not divide evenly over the cluster (20 and 22 rows over 8 CTAs, the
    last CTAs owning two rows, one or none) and whose columns do not fill a tile:
    the four parameterizations (K = 3 includes the centred stencil; a 2×2
    patch grid), both CG forms, two images per tile over an odd batch (a
    short last tile).  float64 at 1e-9 relative; float32 at chip_smoke.py's
    tolerances (1e-5 relative on α and the trajectories, 1e-4 on u)."""
    _, tm, x0 = PARAMS[name]
    ut, f = _odd_stack(*shape)
    ut = torch.as_tensor(ut, dtype=dtype)
    f = torch.as_tensor(f, dtype=dtype)
    x0 = torch.as_tensor(np.asarray(x0), dtype=dtype)
    model = tm()
    pop, pshape = tfo._param_layout(model, x0, f.shape[-2:])
    kw = dict(model=model, outer=20, n_inner=8, n_adj=4, pop=pop,
              param_shape=pshape, lr=0.05, gamma=1e4, tau0=5.0,
              sigma0=0.99 / 5.0, beta1=0.9, beta2=0.999, eps=1e-8,
              cg_variant=variant, tile_b=tile_b)
    before = tfc.kernel_launches
    k = tfo._single_loop_impl(ut.to(cuda_device), f.to(cuda_device),
                              x0.to(cuda_device), **kw)
    assert tfc.kernel_launches - before == \
        1 + 20 * tfc.launches_per_step(4, variant)
    p = tfo._single_loop_impl(ut, f, x0, **kw)
    rtol, utol = (RTOL, 1e-13) if dtype == torch.float64 else (1e-5, 1e-4)
    for a, b in ((k.alpha, p.alpha), (k.alpha_trajectory,
                                      p.alpha_trajectory),
                 (k.cost_trajectory, p.cost_trajectory)):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=rtol,
                                   atol=1e-13)
    np.testing.assert_allclose(k.u.cpu().numpy(), p.u.numpy(), rtol=0,
                               atol=utol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,shape,name", [
    (torch.float32, (1, 512, 512), "tv-scalar"),
    (torch.float64, (1, 256, 256), "sumregs-vector")])
def test_cluster_kernel_with_global_bands(cuda_device, dtype, shape, name):
    """Bands too large for shared memory stay in global memory under the
    same cluster kernel (pd_plan's resident False)."""
    _, tm, x0 = PARAMS[name]
    ut, f = _odd_stack(*shape)
    model = tm()
    assert not tfc.pd_plan(shape[1], shape[2], model.K,
                           torch.tensor([], dtype=dtype).element_size()
                           ).resident
    ut = torch.as_tensor(ut, dtype=dtype)
    f = torch.as_tensor(f, dtype=dtype)
    kw = dict(outer=3, n_inner=8, n_adj=4)
    k = tfo.single_loop_learn(ut.to(cuda_device), f.to(cuda_device), x0,
                              model, **kw)
    p = tfo.single_loop_learn(ut, f, x0, model, **kw)
    rtol = RTOL if dtype == torch.float64 else 1e-5
    np.testing.assert_allclose(k.alpha.cpu().numpy(), p.alpha.numpy(),
                               rtol=rtol)
    np.testing.assert_allclose(k.u.cpu().numpy(), p.u.numpy(),
                               atol=1e-13 if dtype == torch.float64 else 1e-4)
