"""The port's trust-region learn (bilevel/fused.py on bilevel/tr_core.py)
against the JAX package's ``bilevel_learn_fused(backend="jnp")``, on the
same small float64 datasets: the per-iteration (cost, ‖g‖, Δ, step, CG)
log and the learned parameter.

Tolerance: 1e-8 relative on every logged number but the CG iteration
count, which may differ by one or two where a stop test lands within
rounding of its threshold.  The two run the same float64 arithmetic.
The configurations keep the adjoint systems well conditioned (a converging
CG, or an active-set threshold of 1e-4): an ill-conditioned system, such
as the exact form at the f64 default act_tol on a partly converged inner
solve, makes the JAX package itself move its gradient by percent under a
1e-13 perturbation of the data, and no port can be held closer than that.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bpldenoising_tpu.bilevel.fused import \
    bilevel_learn_fused as j_learn_fused
from bpldenoising_tpu.experiments.api import \
    scalar_bilevel_tv_learn as j_scalar_tv_learn
from bpldenoising_tpu.models import sumregs_model as j_sumregs
from bpldenoising_tpu.solvers import lbfgs as jlb
from bpldenoising_tpu.solvers.hypergrad import HypergradConfig as JCfg
from bpldenoising_tpu.utils.config import Params as JParams
from bpldenoising_tpu_torch.bilevel.fused import bilevel_learn_fused
from bpldenoising_tpu_torch.experiments.api import scalar_bilevel_tv_learn
from bpldenoising_tpu_torch.models import sumregs_model
from bpldenoising_tpu_torch.solvers import lbfgs as tlb
from bpldenoising_tpu_torch.solvers.hypergrad import HypergradConfig
from bpldenoising_tpu_torch.utils.config import Params, merge


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One PyTorch intra-op thread while this module runs.  The entry-point
    tests learn on 128² images, whose operators PyTorch splits over every
    core; under pytest-xdist's workers those threads oversubscribe the CPU
    and wait on one another at every operator (on an 8-core host a 2 s
    entry-point learn took 258 s under six workers).  The other test_torch_fused*.py files import
    this fixture."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


RTOL = 1e-8
TR = dict(eta1=0.25, eta2=0.75, beta1=0.25, beta2=1.9, delta0=0.1, tol=1e-5)


def _dataset(n_img, size, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.arange(size), np.arange(size), indexing="ij")
    clean = []
    for k in range(n_img):
        c = size / 2 + k
        clean.append(((xx - c) ** 2 + (yy - size / 2) ** 2
                      < (size / 3) ** 2).astype(np.float64))
        clean[-1][2:6, 2:6] = 0.5
    clean = np.stack(clean)
    noisy = clean + 0.1 * rng.standard_normal(clean.shape)
    return clean, noisy


def _compare(jres, tres, gnorm_rtol=RTOL, cg_slack=0.0):
    """``cg_slack``: a CG-count slack per logged iteration (or one for
    all), used where it is wider than ±(2 + 1%)."""
    k = int(jres.iterations)
    assert tres.iterations == k
    jlog = np.asarray(jres.log)[:k]
    tlog = tres.log[:k].numpy()
    cols = [0, 2, 3, 5]
    np.testing.assert_allclose(tlog[:, cols], jlog[:, cols], rtol=RTOL,
                               atol=1e-12)
    np.testing.assert_allclose(tlog[:, 1], jlog[:, 1], rtol=gnorm_rtol,
                               atol=1e-12)
    # CG iteration counts: a stop test that lands within rounding of its
    # threshold may take one more or one fewer iteration
    assert np.all(np.abs(tlog[:, 4] - jlog[:, 4])
                  <= np.maximum(2 + 0.01 * jlog[:, 4], cg_slack))
    np.testing.assert_allclose(tres.x.numpy(), np.asarray(jres.x),
                               rtol=RTOL)
    np.testing.assert_allclose(float(tres.cost), float(jres.cost), rtol=RTOL)
    np.testing.assert_allclose(tres.u.numpy(), np.asarray(jres.u),
                               atol=1e-10)


CASES = {
    # name: (images, size, outer its, inner_tol, check_every, cfg, extra)
    "warm_2x24": (2, 24, 4, 1e-6, 50,
                  HypergradConfig(al_iters=2, cg_maxiter=1000, act_tol=1e-4), {}),
    "warm_3x32": (3, 32, 3, 5e-6, 50,
                  HypergradConfig(al_iters=2, cg_maxiter=1000, act_tol=1e-4), {}),
    "parity_2x24": (2, 24, 3, None, 50, HypergradConfig(act_tol=1e-4), {}),
    "lbfgs_2x24": (2, 24, 4, 1e-6, 50,
                   HypergradConfig(al_iters=2, cg_maxiter=1000, act_tol=1e-4),
                   {"lbfgs_threshold": 0}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_trajectory_matches_jax(case):
    n_img, size, outer, inner_tol, check_every, cfg, extra = CASES[case]
    ds = _dataset(n_img, size, seed=n_img * size)
    kw = dict(inner_maxiter=400, inner_tol=inner_tol,
              check_every=check_every)
    jres = j_learn_fused((jnp.asarray(ds[0]), jnp.asarray(ds[1])),
                         xinit=0.1, params=JParams(TR, maxiter=outer, **extra),
                         backend="jnp", cfg=JCfg(**cfg._asdict()), **kw)
    tres = bilevel_learn_fused(ds, xinit=0.1,
                               params=Params(TR, maxiter=outer, **extra),
                               cfg=cfg, device="cpu", **kw)
    _compare(jres, tres)


def test_regularized_branch_matches_jax():
    """Δt above Δ₀: every evaluation takes the γ-regularized gradient."""
    ds = _dataset(2, 24, seed=7)
    kw = dict(inner_maxiter=400, inner_tol=1e-6, check_every=50,
              delta_t=1.0)
    cfg = HypergradConfig(al_iters=2, cg_maxiter=100, gamma=1e2)
    jres = j_learn_fused((jnp.asarray(ds[0]), jnp.asarray(ds[1])),
                         xinit=0.1, params=JParams(TR, maxiter=3),
                         backend="jnp", cfg=JCfg(**cfg._asdict()), **kw)
    tres = bilevel_learn_fused(ds, xinit=0.1, params=Params(TR, maxiter=3),
                               cfg=cfg, device="cpu", **kw)
    _compare(jres, tres)


def test_vector_alpha_sumregs_matches_jax():
    ds = _dataset(2, 24, seed=5)
    kw = dict(inner_maxiter=300, inner_tol=1e-6, check_every=50,
              delta_t=1e-3)
    cfg = HypergradConfig(al_iters=2, cg_maxiter=1000, act_tol=1e-4)
    x0 = np.array([0.03, 0.02, 0.01])
    params = dict(TR, delta0=0.01, maxiter=3)
    jres = j_learn_fused((jnp.asarray(ds[0]), jnp.asarray(ds[1])),
                         xinit=jnp.asarray(x0), params=JParams(params),
                         model=j_sumregs(), backend="jnp",
                         cfg=JCfg(**cfg._asdict()), **kw)
    tres = bilevel_learn_fused(ds, xinit=torch.from_numpy(x0),
                               params=Params(params), model=sumregs_model(),
                               cfg=cfg, device="cpu", **kw)
    # ‖g‖ (log column 1) and the CG count (column 4) of this configuration
    # move in the JAX package itself when the noisy images move by 1e-13
    # (‖g‖ by ~4e-8 relative, the first iteration's CG count by ~14): the
    # port is held to twice the spread that the reference shows, the CG
    # count row by row, so rows where the reference does not move keep
    # their ±(2 + 1%)
    k = int(jres.iterations)
    jlog = np.asarray(jres.log)[:k]
    noise = 1e-13 * np.random.default_rng(1).standard_normal(ds[1].shape)
    g_spread, cg_spread = 0.0, np.zeros(k)
    for sign in (1.0, -1.0):
        pres = j_learn_fused((jnp.asarray(ds[0]),
                              jnp.asarray(ds[1] + sign * noise)),
                             xinit=jnp.asarray(x0), params=JParams(params),
                             model=j_sumregs(), backend="jnp",
                             cfg=JCfg(**cfg._asdict()), **kw)
        assert int(pres.iterations) == k
        plog = np.asarray(pres.log)[:k]
        g_spread = max(g_spread, float(np.max(
            np.abs(plog[:, 1] - jlog[:, 1]) / np.abs(jlog[:, 1]))))
        cg_spread = np.maximum(cg_spread, np.abs(plog[:, 4] - jlog[:, 4]))
    _compare(jres, tres, gnorm_rtol=max(RTOL, 2.0 * g_spread),
             cg_slack=2.0 * cg_spread)


def test_patch_and_nonpositive_parameters_raise():
    """A patch grid runs (the patch operator's pullback; its trajectory
    against the JAX package is in test_torch_fused_sumregs.py); x₀ ≤ 0
    raises."""
    ds = _dataset(1, 16, seed=1)
    res = bilevel_learn_fused(ds, xinit=0.1 * np.ones((2, 2)),
                              params=Params(TR, maxiter=1), device="cpu",
                              inner_maxiter=50)
    assert tuple(res.x.shape) == (2, 2) and res.iterations == 1
    assert bool(torch.all(torch.isfinite(res.log[0])))
    with pytest.raises(ValueError):
        bilevel_learn_fused(ds, xinit=0.0, params=Params(TR, maxiter=1),
                            device="cpu")


@pytest.mark.parametrize("knob", ["log_every", "mesh", "segment_callback",
                                  "init_B"])
def test_library_learner_takes_the_jax_keywords(knob):
    """bilevel_learn_fused takes the JAX function's mesh, log_every,
    segment_callback and init_B: None runs (one 8×8 image), any other
    value raises NotImplementedError, as in the other families'
    learners."""
    ds = _dataset(1, 8, seed=2)
    kw = dict(xinit=0.1, params=Params(TR, maxiter=1), inner_maxiter=5,
              device="cpu")
    res = bilevel_learn_fused(ds, **kw, **{knob: None})
    assert res.iterations == 1
    value = {"log_every": 5, "mesh": object(), "init_B": np.eye(1),
             "segment_callback": lambda *a: None}[knob]
    with pytest.raises(NotImplementedError, match=knob):
        bilevel_learn_fused(ds, **kw, **{knob: value})


def test_lbfgs_functions_match_jax(rng):
    n, m = 5, 3
    jst = jlb.lbfgs_init(n, m, jnp.float64, init_scale=0.1)
    tst = tlb.lbfgs_init(n, m, torch.float64, init_scale=0.1)
    for _ in range(4):
        s = rng.standard_normal(n)
        y = s + 0.3 * rng.standard_normal(n)
        jst = jlb.lbfgs_update(jst, jnp.asarray(y), jnp.asarray(s))
        tst = tlb.lbfgs_update(tst, torch.from_numpy(y), torch.from_numpy(s))
        v = rng.standard_normal(n)
        np.testing.assert_allclose(
            tlb.lbfgs_apply(tst, torch.from_numpy(v)).numpy(),
            np.asarray(jlb.lbfgs_apply(jst, jnp.asarray(v))), rtol=1e-10)
        np.testing.assert_allclose(
            tlb.lbfgs_solve(tst, torch.from_numpy(v)).numpy(),
            np.asarray(jlb.lbfgs_solve(jst, jnp.asarray(v))), rtol=1e-10)
    assert tst.count == int(jst.count)
    # a pair that fails the curvature test is skipped by both
    s = rng.standard_normal(n)
    jst2 = jlb.lbfgs_update(jst, jnp.asarray(-s), jnp.asarray(s))
    tst2 = tlb.lbfgs_update(tst, torch.from_numpy(-s), torch.from_numpy(s))
    assert tst2.count == int(jst2.count) == tst.count


def test_scalar_learn_entry_point_on_cpu(tmp_path, monkeypatch):
    """The user entry point on a bundled dataset (one image, small
    budgets), and its refusal of what is not ported.  The host trust
    region (method="tr", the default) runs too and matches the JAX entry
    point at its own defaults (the default HypergradConfig; a 30-iteration
    inner budget) to 1e-8."""
    kw = dict(dataset_name="circle", num_samples=1, method="tr_fused",
              maxiter=2, inner_maxiter=150, inner_tol=1e-4, check_every=50,
              hypergrad_cfg=HypergradConfig(al_iters=2, cg_maxiter=30))
    res = scalar_bilevel_tv_learn(device="cpu", **kw)
    assert res.u.shape == (1, 128, 128) and res.u.dtype == np.float64
    assert np.isfinite(res.cost) and res.x.shape == ()
    assert res.iterations == 2 and len(res.state.log) == 2
    tr = dict(dataset_name="circle", num_samples=1, maxiter=2,
              inner_maxiter=30)
    res = scalar_bilevel_tv_learn(device="cpu", **tr)
    monkeypatch.chdir(tmp_path)   # the JAX entry point writes output/
    jres = j_scalar_tv_learn(save_results=False, backend="jnp", **tr)
    assert res.iterations == jres.iterations == 2
    np.testing.assert_allclose(res.x, np.asarray(jres.x), rtol=RTOL)
    np.testing.assert_allclose(res.cost, jres.cost, rtol=RTOL)
    np.testing.assert_allclose(res.u, np.asarray(jres.u), atol=1e-10)
    with pytest.raises(NotImplementedError):
        scalar_bilevel_tv_learn(device="cpu", **dict(kw, save_results=True))


def test_entry_point_defaults_to_the_card():
    """Without device="cpu" the entry point asks for the card; on a machine
    without one it raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises((RuntimeError, AssertionError)):
        scalar_bilevel_tv_learn(dataset_name="circle", num_samples=1,
                                method="tr_fused", maxiter=1,
                                inner_maxiter=10)


@pytest.mark.parametrize("knob", [dict(log_every=1), dict(backend="pallas"),
                                  dict(backend="jnp")],
                         ids=["log_every", "backend=pallas", "backend=jnp"])
def test_entry_points_refuse_log_every_and_other_backends(knob):
    """Segmented dispatch (log_every) is not ported, and the port has no
    backends: every family's entry point raises for them instead of
    running without a word (the JAX package runs segmented dispatch and
    the Pallas kernels for the same call).  backend="auto", the JAX
    default, is accepted; device= chooses what runs."""
    from bpldenoising_tpu_torch import experiments as tx
    kw = dict(dataset_name="circle", num_samples=1, method="tr_fused",
              maxiter=2, inner_maxiter=20, device="cpu", **knob)
    for learn in (scalar_bilevel_tv_learn, tx.scalar_bilevel_tgv_learn,
                  tx.patch_bilevel_tgv_learn, tx.scalar_bilevel_tvl1_learn,
                  tx.patch_bilevel_tvl1_learn):
        with pytest.raises(NotImplementedError,
                           match="device=" if "backend" in knob else
                           "log_every"):
            learn(**kw)
    if "backend" in knob:
        for denoise, a in ((tx.TGVDenoise, (0.1, 0.2)),
                           (tx.TVL1Denoise, 0.9)):
            with pytest.raises(NotImplementedError, match="device="):
                denoise(np.zeros((8, 8)), a, maxiter=5, device="cpu", **knob)
    res = scalar_bilevel_tv_learn(**dict(kw, log_every=None,
                                         backend="auto"))
    assert res.iterations == 2


def test_params_merge_is_right_biased():
    p = merge(Params(a=1, b=2), dict(b=3), c=4)
    assert (p.a, p.b, p.c) == (1, 3, 4)
    with pytest.raises(AttributeError):
        p.a = 5
    assert (Params(a=1) | None).a == 1

