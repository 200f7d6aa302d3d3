"""The port's host trust region end to end: ``bilevel_learn`` over each
factory of learning/*.py against the JAX package's on the same seeded
float64 data, every entry point with ``method="tr"`` (and the
``image_pair=`` form) against the JAX entry point, and the port's ``tr``
against its own ``tr_fused`` at ``inner_tol=None``, on the CPU (the
kernels' plain versions).

Tolerances: 1e-8 relative on every logged number (cost, ‖g‖, Δ, step, CG
converged) and on the learned parameter and cost, u to 1e-10 absolute; a
column that the JAX package's own run moves by more under a 1e-13 or
1e-11 relative move of the data, to twice that spread; the adjoint-CG count to
± (2 + 10%), the JAX package's own spread of a CG whose residual creeps
along its threshold; as in tests/test_torch_fused.py.  ``tr`` against
``tr_fused``: the two launch the same kernels on the same inputs and only
the trust-region arithmetic differs (NumPy float64 against torch float64):
bit for bit while the parameters are, 1e-8 relative after (the test's
docstring says why).
"""

import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bpldenoising_tpu.bilevel import bilevel_learn as j_bilevel_learn
from bpldenoising_tpu.experiments import api as japi
from bpldenoising_tpu.experiments import tgv as jtgv_x
from bpldenoising_tpu.experiments import tvl1 as jtvl1_x
from bpldenoising_tpu.experiments import vtv as jvtv_x
from bpldenoising_tpu.learning import (make_sumregs_learning_function as
                                       j_sumregs_lf)
from bpldenoising_tpu.learning import make_tgv_learning_function as j_tgv_lf
from bpldenoising_tpu.learning import make_tv_learning_function as j_tv_lf
from bpldenoising_tpu.learning import make_tvl1_learning_function as j_l1_lf
from bpldenoising_tpu.learning import make_vtv_learning_function as j_vtv_lf
from bpldenoising_tpu.solvers.hypergrad import HypergradConfig as JCfg
from bpldenoising_tpu.utils.config import Params as JParams
from bpldenoising_tpu_torch import learning as tl
from bpldenoising_tpu_torch.bilevel import (bilevel_learn,
                                            bilevel_learn_fused,
                                            bilevel_learn_tgv_fused,
                                            bilevel_learn_tvl1_fused,
                                            bilevel_learn_vtv_fused,
                                            trust_region)
from bpldenoising_tpu_torch.experiments import api as tx
from bpldenoising_tpu_torch.experiments import tgv as ttgv_x
from bpldenoising_tpu_torch.experiments import tvl1 as ttvl1_x
from bpldenoising_tpu_torch.experiments import vtv as tvtv_x
from bpldenoising_tpu_torch.models import sumregs_model
from bpldenoising_tpu_torch.solvers.hypergrad import HypergradConfig
from bpldenoising_tpu_torch.utils.config import Params
from test_torch_fused import (one_torch_thread,  # noqa: F401 (autouse)
                             results_in_tmp)
from test_torch_learning import _color, _gray

RTOL = 1e-8
CFG = HypergradConfig(al_iters=2, cg_maxiter=1000, act_tol=1e-4)
TR = dict(eta1=0.25, eta2=0.75, beta1=0.25, beta2=1.9, tol=1e-8,
          verbose_iter=1)


def _rows(res):
    return np.array([[e.iter, e.function_value, e.g_norm, e.delta,
                      e.step_norm, e.adjoint_cg_converged]
                     for e in res.state.log])


def _cg(res):
    return np.array([e.adjoint_cg_iters for e in res.state.log])


def _compare(tres, jres, u_atol=1e-10, rerun=None):
    """``rerun(ε)``: the JAX run on the noisy images times (1 + ε), whose
    spread from ``jres`` bounds a logged column where 1e-8 does not."""
    assert tres.iterations == jres.iterations
    rows, jrows = _rows(tres), _rows(jres)
    err = np.abs(rows - jrows) / np.maximum(np.abs(jrows), 1e-300)
    err[np.abs(rows - jrows) <= 1e-12] = 0.0
    rtol = np.full(rows.shape[1], RTOL)
    if rerun is not None and np.any(err > RTOL):
        # a trajectory whose evaluations or BFGS model amplify rounding
        # moves in the JAX package itself when the data move by 1e-13, or
        # by 1e-11 (what separates the two packages' first gradients): the
        # port is held to twice that spread, column by column, as in
        # tests/test_torch_fused.py
        for eps in (1e-13, -1e-13, 1e-11, -1e-11):
            prows = _rows(rerun(eps))
            rtol = np.maximum(rtol, 2.0 * np.max(
                np.abs(prows - jrows) / np.maximum(np.abs(jrows), 1e-300),
                axis=0))
    assert np.all(err <= rtol), (err, rtol)
    # a converged CG whose residual creeps along its threshold moves its
    # count in the JAX package itself by up to ~9% when the data move by
    # 1e-13 (25 of 287 in the patch TV case here)
    jcg = _cg(jres)
    assert np.all(np.abs(_cg(tres) - jcg) <= 2 + 0.1 * jcg), (_cg(tres),
                                                              jcg)
    x_rtol = max(RTOL, float(np.max(rtol)))
    np.testing.assert_allclose(np.asarray(tres.x), np.asarray(jres.x),
                               rtol=x_rtol)
    np.testing.assert_allclose(tres.cost, jres.cost, rtol=rtol[1])
    np.testing.assert_allclose(tres.g_norm, jres.g_norm, rtol=rtol[2])
    u = tres.u.numpy() if isinstance(tres.u, torch.Tensor) else tres.u
    np.testing.assert_allclose(u, np.asarray(jres.u), atol=u_atol)


# case: (the port's factory and its keywords, the JAX factory and its
# keywords, data, x0, trust-region overrides)
LEARN_CASES = {
    "tv": (tl.make_tv_learning_function, dict(maxiter=300, cfg=CFG),
           j_tv_lf, dict(maxiter=300, cfg=JCfg(**CFG._asdict()),
                         backend="jnp"),
           lambda: _gray(0), 0.05, dict(delta0=0.1)),
    "tv_patch": (tl.make_tv_learning_function,
                 dict(maxiter=300, cfg=CFG,
                      solver_kwargs=dict(tol=1e-6, check_every=50)),
                 j_tv_lf, dict(maxiter=300, cfg=JCfg(**CFG._asdict()),
                               backend="jnp",
                               solver_kwargs=dict(tol=1e-6, check_every=50)),
                 lambda: _gray(0), np.full((2, 2), 0.05),
                 dict(delta0=0.01)),
    "sumregs": (tl.make_sumregs_learning_function,
                dict(maxiter=300, cfg=CFG), j_sumregs_lf,
                dict(maxiter=300, cfg=JCfg(**CFG._asdict()), backend="jnp"),
                lambda: _gray(1), np.array([0.03, 0.02, 0.01]),
                dict(delta0=0.01)),
    "tgv": (tl.make_tgv_learning_function, dict(maxiter=300, gamma=1e-2),
            j_tgv_lf, dict(maxiter=300, gamma=1e-2, backend="jnp"),
            lambda: _gray(2), np.array([0.05, 0.05]), dict(delta0=0.02)),
    "tvl1": (tl.make_tvl1_learning_function,
             dict(maxiter=300, tol=1e-6, check_every=50), j_l1_lf,
             dict(maxiter=300, tol=1e-6, check_every=50),
             lambda: _gray(3, impulse=True), 0.6, dict(delta0=0.1)),
    "vtv": (tl.make_vtv_learning_function, dict(maxiter=300, gamma=1e-2),
            j_vtv_lf, dict(maxiter=300, gamma=1e-2, backend="jnp"),
            lambda: _color(4), 0.05, dict(delta0=0.02)),
}


@pytest.mark.parametrize("case", list(LEARN_CASES))
def test_bilevel_learn_with_each_factory_matches_jax(case):
    """Four outer iterations of bilevel_learn over each factory against
    the JAX package's, log entry by log entry; one read of cost and
    gradient per evaluation."""
    tfac, tkw, jfac, jkw, data, x0, tr = LEARN_CASES[case]
    ds = data()
    params = dict(TR, maxiter=4, **tr)

    def jax_run(eps=0.0):
        return j_bilevel_learn((jnp.asarray(ds[0]),
                                jnp.asarray(ds[1] * (1 + eps))),
                               jfac(**jkw), xinit=x0, params=JParams(params))

    jres = jax_run()
    reads = trust_region.host_reads
    tres = bilevel_learn(ds, tfac(device="cpu", **tkw), xinit=x0,
                         params=Params(params))
    assert trust_region.host_reads - reads == tres.iterations + 1
    assert isinstance(tres.u, torch.Tensor)
    _compare(tres, jres, rerun=jax_run)


def test_lbfgs_branch_on_a_9x9_grid_matches_jax():
    """81 parameters, above lbfgs_threshold 64: the L-BFGS model of both
    packages on a 9×9 TV grid over 2×18×18 images."""
    rng = np.random.default_rng(9)
    yy, xx = np.meshgrid(np.arange(18), np.arange(18), indexing="ij")
    clean = np.stack([((xx - 9) ** 2 + (yy - 8) ** 2 < 30).astype(float),
                      0.02 * xx + 0.5 * (yy > 8)])
    ds = (clean, clean + 0.1 * rng.standard_normal(clean.shape))
    x0 = np.full((9, 9), 0.05)
    params = dict(TR, maxiter=4, delta0=0.01, lbfgs_memory=3)
    sk = dict(tol=1e-6, check_every=50)

    def jax_run(eps=0.0):
        return j_bilevel_learn(
            (jnp.asarray(ds[0]), jnp.asarray(ds[1] * (1 + eps))),
            j_tv_lf(maxiter=300, cfg=JCfg(**CFG._asdict()), backend="jnp",
                    solver_kwargs=sk), xinit=x0, params=JParams(params))

    jres = jax_run()
    tres = bilevel_learn(ds, tl.make_tv_learning_function(
        maxiter=300, cfg=CFG, solver_kwargs=sk, device="cpu"), xinit=x0,
        params=Params(params))
    assert tres.x.shape == (9, 9)
    _compare(tres, jres, rerun=jax_run)


@pytest.fixture
def in_tmp(tmp_path, monkeypatch):
    """The JAX entry points create output/<dataset>/ under the working
    directory: keep it out of the repo."""
    monkeypatch.chdir(tmp_path)
    return tmp_path


TV_ENTRY = dict(dataset_name="circle", num_samples=1, method="tr",
                maxiter=2, inner_maxiter=30)
# entry point: (JAX module, port module, keywords)
ENTRIES = {
    "scalar_bilevel_tv_learn": (japi, tx, TV_ENTRY),
    "patch_bilevel_tv_learn": (japi, tx, TV_ENTRY),
    "scalar_bilevel_sumregs_learn": (japi, tx, TV_ENTRY),
    "patch_bilevel_sumregs_learn": (japi, tx, TV_ENTRY),
    "scalar_bilevel_tgv_learn": (jtgv_x, ttgv_x, dict(
        TV_ENTRY, inner_maxiter=150, tgv_gamma=1e-2)),
    "patch_bilevel_tgv_learn": (jtgv_x, ttgv_x, dict(
        TV_ENTRY, inner_maxiter=150, tgv_gamma=1e-2, inner_tol=1e-3)),
    "scalar_bilevel_tvl1_learn": (jtvl1_x, ttvl1_x, dict(
        TV_ENTRY, dataset_name="circle_sp", inner_maxiter=400)),
    "patch_bilevel_tvl1_learn": (jtvl1_x, ttvl1_x, dict(
        TV_ENTRY, dataset_name="circle_sp", inner_maxiter=400,
        inner_tol=1e-5, check_every=500)),
    "scalar_bilevel_vtv_learn": (jvtv_x, tvtv_x, dict(
        TV_ENTRY, dataset_name="color_disks", inner_maxiter=200,
        vtv_gamma=1e-2)),
    "patch_bilevel_vtv_learn": (jvtv_x, tvtv_x, dict(
        TV_ENTRY, dataset_name="color_disks", inner_maxiter=200,
        vtv_gamma=1e-2, inner_tol=1e-4, check_every=500)),
}


@pytest.mark.parametrize("entry", list(ENTRIES))
def test_entry_points_with_tr_match_jax(in_tmp, entry):
    """Each entry point with method="tr" on one bundled 128² image at a
    small budget (the entry point's own defaults otherwise: the JAX
    parameter sets, the default HypergradConfig, check_every 500 where
    inner_tol is set, as the JAX learning functions run it) against the
    JAX entry point with save_results=False, state.log included."""
    jmod, tmod, kw = ENTRIES[entry]
    jkw = {} if jmod is jtvl1_x else dict(backend="jnp")
    jres = getattr(jmod, entry)(save_results=False, **jkw, **kw)
    tres = getattr(tmod, entry)(device="cpu", **kw)
    assert isinstance(tres.x, np.ndarray) and isinstance(tres.u, np.ndarray)
    assert tres.x.shape == np.asarray(jres.x).shape
    assert tres.u.dtype == np.float64
    assert tres.iterations == jres.iterations == kw["maxiter"]
    assert len(tres.state.log) == kw["maxiter"]
    _compare(tres, jres)


def test_image_pair_form_matches_jax(in_tmp):
    """patch_bilevel_sumregs_learn(image_pair=...): the one pair as a
    1×M×N stack through the host trust region, whatever method says, as in
    the JAX package."""
    true_, noisy = tx.testdataset("circle_128_10")
    pair = (true_[0], noisy[0])
    kw = dict(maxiter=2, inner_maxiter=30)
    jres = japi.patch_bilevel_sumregs_learn(image_pair=pair,
                                            save_results=False,
                                            backend="jnp", **kw)
    tres = tx.patch_bilevel_sumregs_learn(image_pair=pair, device="cpu",
                                          **kw)
    assert tres.x.shape == (2, 2, 3) and tres.u.shape == (1, 128, 128)
    _compare(tres, jres)
    again = tx.patch_bilevel_sumregs_learn(image_pair=pair, device="cpu",
                                           method="tr_fused", **kw)
    np.testing.assert_array_equal(again.x, tres.x)


def _fused_rows(res):
    """The fused log's (cost, ‖g‖, Δ, accepted step) rows."""
    return res.log[:res.iterations, :4].numpy()


# case: (the port's factory and its keywords, the fused learner and its
# keywords, data, x0, trust-region overrides)
PARITY = {
    "tv": (tl.make_tv_learning_function, dict(maxiter=300, cfg=CFG),
           bilevel_learn_fused, dict(inner_maxiter=300, cfg=CFG),
           lambda: _gray(0), 0.05, dict(delta0=0.1)),
    "tv_patch": (tl.make_tv_learning_function, dict(maxiter=300, cfg=CFG),
                 bilevel_learn_fused, dict(inner_maxiter=300, cfg=CFG),
                 lambda: _gray(0), np.full((2, 2), 0.05),
                 dict(delta0=0.01)),
    "sumregs": (tl.make_sumregs_learning_function,
                dict(maxiter=300, cfg=CFG), bilevel_learn_fused,
                dict(inner_maxiter=300, cfg=CFG, model=sumregs_model(),
                     delta_t=1e-3),
                lambda: _gray(1), np.array([0.03, 0.02, 0.01]),
                dict(delta0=0.01)),
    "tgv": (tl.make_tgv_learning_function, dict(maxiter=300, gamma=1e-2),
            bilevel_learn_tgv_fused, dict(inner_maxiter=300, gamma=1e-2),
            lambda: _gray(2), np.array([0.05, 0.05]), dict(delta0=0.02)),
    "tvl1": (tl.make_tvl1_learning_function, dict(maxiter=300),
             bilevel_learn_tvl1_fused, dict(inner_maxiter=300),
             lambda: _gray(3, impulse=True), 0.6, dict(delta0=0.1)),
    "vtv": (tl.make_vtv_learning_function, dict(maxiter=300, gamma=1e-2),
            bilevel_learn_vtv_fused, dict(inner_maxiter=300, gamma=1e-2),
            lambda: _color(4), 0.05, dict(delta0=0.02)),
}


@pytest.mark.parametrize("case", list(PARITY))
def test_tr_matches_tr_fused_at_fixed_budget(case, monkeypatch):
    """At inner_tol=None the host and the fused trust region evaluate the
    same kernels on the same inputs.  While their parameters agree bit for
    bit, so do the logged cost, ‖g‖, Δ and the accept pattern (the fused
    log's step is 0 on a rejection, the host log keeps the last accepted
    step).  NumPy and torch round a multi-parameter model's dot products
    and solves differently in the last bit; from the first evaluation whose
    x differs, the rows are held to 1e-8 relative (the JAX parity
    tolerance), since the exact-branch gradient at act_tol 1e-4 amplifies a
    last-bit move of x by up to ~1e5 (2.3e-10 in the patch TV case)."""
    tfac, tkw, fused, fkw, data, x0, tr = PARITY[case]
    ds = data()
    params = Params(TR, maxiter=4, **tr)
    host_x, fused_x = [], []
    lf = tfac(device="cpu", **tkw)

    def spy_lf(x, ds_, delta):
        host_x.append(np.array(x, dtype=np.float64).ravel())
        return lf(x, ds_, delta)

    host = bilevel_learn(ds, spy_lf, xinit=x0, params=params)
    module = __import__(fused.__module__, fromlist=["_machinery"])
    step_name = next(n for n in ("tv_local", "tgv_local", "tvl1_local",
                                 "vtv_local") if hasattr(module, n))
    step = getattr(module, step_name)

    def spy_step(x, *a, **k):
        fused_x.append(x.numpy().astype(np.float64).ravel())
        return step(x, *a, **k)

    monkeypatch.setattr(module, step_name, spy_step)
    fres = fused(ds, xinit=x0, params=params, inner_tol=None, device="cpu",
                 **fkw)
    assert host.iterations == fres.iterations
    assert len(host_x) == len(fused_x) == host.iterations + 1
    same = [np.array_equal(a, b) for a, b in zip(host_x, fused_x)]
    first = same.index(False) if False in same else len(same)
    rows, frows = _rows(host), _fused_rows(fres)
    # log row i holds the evaluation at iteration i's trial point
    exact = slice(0, max(first - 1, 0))
    np.testing.assert_array_equal(rows[exact, 1], frows[exact, 0])
    np.testing.assert_array_equal(rows[exact, 3], frows[exact, 2])
    # ‖g‖ of equal gradients: NumPy's and torch's norms round apart
    np.testing.assert_allclose(rows[exact, 2], frows[exact, 1], rtol=1e-15)
    np.testing.assert_allclose(rows[:, 1:4], frows[:, :3], rtol=RTOL,
                               atol=1e-14)
    accepted = frows[:, 3] > 0
    assert accepted.any()
    np.testing.assert_allclose(rows[accepted, 4], frows[accepted, 3],
                               rtol=RTOL)
    np.testing.assert_allclose(host.x, fres.x.numpy(), rtol=RTOL)
    np.testing.assert_allclose(host.cost, float(fres.cost), rtol=RTOL)
    if np.asarray(x0).size == 1:   # one parameter: the same bits throughout
        assert first == len(same)
        np.testing.assert_array_equal(rows[:, 1:4], frows[:, :3])
    else:
        assert first >= 2    # the first trial point is the same


def test_entry_points_refuse_the_unported_knobs():
    """Another backend still raises with method="tr", naming what the
    port takes; checkpoint and resume with method="tr" and save_iterations
    with the fused loop (item 7) run: the TV entry point lands at the JAX
    package's x (1e-8) and writes its checkpoint or snapshot, the TGV² one
    runs; data_parallel (item 10) runs: with device="cpu" the TV learn's
    sharded learning function on one CPU shard gives the unsharded
    learn's x bit for bit, and the TGV² learn does not read the flag, as
    in the JAX package (meshes of several shards against the JAX
    package's: tests/test_torch_parallel*.py); an unknown method raises
    ValueError.  (save_results, save_iterations with method="tr" and
    visualise run: tests/test_torch_reporting.py.)"""
    for knob, item in ((dict(checkpoint=True), 7), (dict(resume=True), 7),
                       (dict(save_iterations=True, method="tr_fused"), 7),
                       (dict(data_parallel=True), 10),
                       (dict(backend="jnp"), None)):
        kw = dict(TV_ENTRY, **knob)
        if item == 7:
            shutil.rmtree("output", ignore_errors=True)
            res = tx.scalar_bilevel_tv_learn(device="cpu", **kw)
            files = os.listdir(os.path.join("output", "circle_128_10"))
            assert any(f.endswith("_ckpt.npz" if "save_iterations" not in
                                  knob else "_iter_2.png") for f in files)
            jres = japi.scalar_bilevel_tv_learn(save_results=False,
                                                backend="jnp", **kw)
            assert res.iterations == jres.iterations == 2
            np.testing.assert_allclose(res.x, np.asarray(jres.x), rtol=RTOL)
            res = ttgv_x.scalar_bilevel_tgv_learn(device="cpu", **kw)
            assert res.iterations == 2
            continue
        if item == 10:
            for learn in (tx.scalar_bilevel_tv_learn,
                          ttgv_x.scalar_bilevel_tgv_learn):
                res = learn(device="cpu", **kw)
                one = learn(device="cpu", **TV_ENTRY)
                np.testing.assert_array_equal(res.x, one.x)
                assert res.cost == one.cost
            continue
        # each refusal names the ROADMAP.md item that ports the knob
        match = "backend" if item is None else f"§1 item {item}"
        with pytest.raises(NotImplementedError, match=match):
            tx.scalar_bilevel_tv_learn(device="cpu", **kw)
        with pytest.raises(NotImplementedError, match=match):
            ttgv_x.scalar_bilevel_tgv_learn(device="cpu", **kw)
    for learn in (tx.scalar_bilevel_tv_learn,
                  ttgv_x.scalar_bilevel_tgv_learn):
        with pytest.raises(ValueError, match="method"):
            learn(device="cpu", **dict(TV_ENTRY, method="newton"))
