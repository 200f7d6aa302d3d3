"""The port's TV-L1 trust-region learn (bilevel/fused_tvl1.py) and its entry
points against the JAX package's ``bilevel_learn_tvl1_fused(backend="jnp")``
and ``experiments.tvl1`` on the same float64 data: the per-iteration
(cost, ‖g‖, Δ, step, CG) log, the learned weight and the cost, for a scalar
α and a 2×2 patch grid, in parity mode (cold fixed budget, adjoint chained)
and warm mode (early stop, chained solver state and adjoint); then
``TVL1Denoise`` and the refusals.

Inputs: a 24×24 disc under 20% salt-and-pepper noise, made with numpy
from a seed (tests/test_torch_tvl1.py), and the bundled ``circle_sp``
dataset for the entry points.

Tolerance: 1e-8 relative on every logged number but the CG iteration
count, which may differ by one or two where a stop test lands within
rounding of its threshold (measured gap ~1e-10: the adjoint CG converges
in under 130 iterations on these inputs).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bpldenoising_tpu.bilevel.fused_tvl1 import \
    bilevel_learn_tvl1_fused as j_learn
from bpldenoising_tpu.experiments import tvl1 as jx
from bpldenoising_tpu.utils.config import Params as JParams
from bpldenoising_tpu_torch import experiments as tx
from bpldenoising_tpu_torch.bilevel.fused_tvl1 import (
    bilevel_learn_tvl1_fused, tvl1_param_layout)
from bpldenoising_tpu_torch.solvers import tvl1_cuda
from bpldenoising_tpu_torch.utils.config import Params
from bpldenoising_tpu_torch.parallel import make_batch_mesh
from test_torch_tvl1 import impulse_phantoms
from test_torch_fused import (one_torch_thread,  # noqa: F401 (autouse)
                             results_in_tmp)

RTOL = 1e-8
TR = dict(eta1=0.25, eta2=0.75, beta1=0.25, beta2=1.9, delta0=0.1,
          tol=1e-7)


def _compare(jres, tres):
    k = int(jres.iterations)
    assert tres.iterations == k
    jlog = np.asarray(jres.log)[:k]
    tlog = tres.log[:k].numpy()
    cols = [0, 1, 2, 3, 5]
    np.testing.assert_allclose(tlog[:, cols], jlog[:, cols], rtol=RTOL,
                               atol=1e-12)
    assert np.all(np.abs(tlog[:, 4] - jlog[:, 4]) <= 2)
    np.testing.assert_allclose(tres.x.numpy(), np.asarray(jres.x),
                               rtol=RTOL)
    np.testing.assert_allclose(float(tres.cost), float(jres.cost), rtol=RTOL)


CASES = {
    # name: (x0, inner_tol)
    "scalar_parity": (np.array(0.4), None),
    "scalar_warm": (np.array(0.4), 1e-6),
    "patch_parity": (0.4 * np.ones((2, 2)), None),
    "patch_warm": (0.4 * np.ones((2, 2)), 1e-6),
}


@pytest.mark.parametrize("case", list(CASES))
def test_trajectory_matches_jax(case):
    x0, inner_tol = CASES[case]
    ds = impulse_phantoms(batch=1)
    params = dict(TR, maxiter=3)
    kw = dict(inner_maxiter=1000, inner_tol=inner_tol, check_every=50)
    jres = j_learn((jnp.asarray(ds[0]), jnp.asarray(ds[1])),
                   xinit=jnp.asarray(x0), params=JParams(params),
                   backend="jnp", **kw)
    tres = bilevel_learn_tvl1_fused(ds, xinit=x0, params=Params(params),
                                    device="cpu", **kw)
    assert tuple(tres.x.shape) == x0.shape
    assert tres.u.shape == (1, 24, 24)
    _compare(jres, tres)


def test_param_layout_and_refusals():
    ds = impulse_phantoms(batch=1)
    assert tvl1_param_layout(torch.tensor(0.4), (24, 24)) is None
    assert tvl1_param_layout(torch.ones((2, 3)), (24, 24)).block == (12, 8)
    with pytest.raises(ValueError, match="scalar or an"):
        tvl1_param_layout(torch.ones(3), (24, 24))
    p = Params(TR, maxiter=1)
    with pytest.raises(ValueError):
        bilevel_learn_tvl1_fused(ds, xinit=np.array(-0.4), params=p,
                                 device="cpu")
    kw = dict(xinit=np.array(0.4), params=p, device="cpu")
    # a mesh does not compose with segmented dispatch, as in the JAX package
    mesh = make_batch_mesh(devices=["cpu"])
    with pytest.raises(ValueError, match="log_every"):
        bilevel_learn_tvl1_fused(ds, mesh=mesh, log_every=1, **kw)
    # segmented dispatch runs the single run's bits; an init_B of another
    # shape than the model's is ignored, as in the JAX package
    one = bilevel_learn_tvl1_fused(ds, **kw)
    # a one-shard mesh on the CPU runs the unsharded learn bit for bit
    # (meshes against the JAX package's: tests/test_torch_parallel.py)
    dp = bilevel_learn_tvl1_fused(ds, mesh=mesh, **kw)
    assert torch.equal(dp.x, one.x) and torch.equal(dp.log, one.log)
    seg = bilevel_learn_tvl1_fused(ds, log_every=1, init_B=1, **kw)
    assert torch.equal(seg.x, one.x) and torch.equal(seg.log, one.log)
    assert one.times is None and seg.times.shape == (one.iterations,)
    # a lone segment_callback is ignored, as the JAX single run ignores it
    lone = bilevel_learn_tvl1_fused(ds, segment_callback=1, **kw)
    assert torch.equal(lone.x, one.x) and torch.equal(lone.log, one.log)


@pytest.fixture
def in_tmp(tmp_path, monkeypatch):
    """The JAX entry points create output/<dataset>/ under the working
    directory: keep it out of the repo."""
    monkeypatch.chdir(tmp_path)
    return tmp_path


ENTRY = dict(dataset_name="circle_sp", num_samples=1, method="tr_fused",
             maxiter=2, inner_maxiter=400)


@pytest.mark.parametrize("family,inner_tol", [("scalar", None),
                                              ("patch", 1e-5)])
def test_entry_points_match_jax(in_tmp, family, inner_tol):
    kw = dict(ENTRY, inner_tol=inner_tol)
    if family == "scalar":
        jres = jx.scalar_bilevel_tvl1_learn(save_results=False,
                                            backend="jnp", **kw)
        tres = tx.scalar_bilevel_tvl1_learn(device="cpu", **kw)
        assert tres.x.shape == ()
    else:
        jres = jx.patch_bilevel_tvl1_learn(save_results=False,
                                           backend="jnp", **kw)
        tres = tx.patch_bilevel_tvl1_learn(device="cpu", **kw)
        assert tres.x.shape == (2, 2)
    assert tres.iterations == jres.iterations == 2
    assert tres.u.shape == (1, 128, 128) and tres.u.dtype == np.float64
    assert len(tres.state.log) == 2
    np.testing.assert_allclose(tres.x, np.asarray(jres.x), rtol=RTOL)
    np.testing.assert_allclose(tres.cost, jres.cost, rtol=RTOL)
    np.testing.assert_allclose(tres.u, np.asarray(jres.u),
                               atol=1e-10)


def test_entry_point_state_log_matches_jax(in_tmp):
    """The learns return the JAX package's result type: a BilevelResult
    with u on the host and state.log, one BilevelLogEntry per outer
    iteration, entry for entry the JAX entry point's (iteration, cost,
    ‖g‖, Δ, step, adjoint-CG iterations and flag; times are 0.0, since
    segmented dispatch is not ported)."""
    from bpldenoising_tpu_torch.bilevel import BilevelResult
    from bpldenoising_tpu_torch.viz import BilevelLogEntry
    kw = dict(ENTRY, maxiter=3, inner_tol=1e-5)
    jres = jx.scalar_bilevel_tvl1_learn(save_results=False, backend="jnp",
                                        **kw)
    tres = tx.scalar_bilevel_tvl1_learn(device="cpu", **kw)
    assert isinstance(tres, BilevelResult) and isinstance(tres.u, np.ndarray)
    assert tres.g_norm == pytest.approx(jres.g_norm, rel=RTOL)
    assert len(tres.state.log) == len(jres.state.log) == 3
    for t, j in zip(tres.state.log, jres.state.log):
        assert isinstance(t, BilevelLogEntry)
        assert t.iter == j.iter and t.time == 0.0
        np.testing.assert_allclose(
            [t.function_value, t.g_norm, t.delta, t.step_norm,
             t.adjoint_cg_converged],
            [j.function_value, j.g_norm, j.delta, j.step_norm,
             j.adjoint_cg_converged], rtol=RTOL, atol=1e-12)
        assert abs(t.adjoint_cg_iters - j.adjoint_cg_iters) <= 2


@pytest.mark.parametrize("parameter", [
    0.9, "map", [[0.6, 1.1], [0.9, 1.3]]], ids=["scalar", "map", "patch"])
def test_tvl1_denoise_matches_jax(parameter):
    _, noisy = impulse_phantoms()
    if parameter == "map":
        parameter = 0.5 + np.random.default_rng(3).random((24, 24))
    got = tx.TVL1Denoise(noisy, parameter, maxiter=200, device="cpu")
    want = jx.TVL1Denoise(jnp.asarray(noisy), parameter, maxiter=200,
                          backend="jnp")
    assert got.shape == (2, 24, 24)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-12)
    with pytest.raises(ValueError):
        tx.TVL1Denoise(noisy, np.ones(3), maxiter=5, device="cpu")


@pytest.mark.parametrize("knob", [
    dict(method="tr"), dict(method="single_loop", data_parallel=True),
    dict(save_results=True),
    dict(checkpoint=True), dict(data_parallel=True), dict(log_every=1),
    dict(backend="pallas"), dict(visualise=True)],
    ids=lambda k: next(iter(k)) + "=" + str(next(iter(k.values()))))
def test_entry_points_refuse_what_is_not_ported(knob, in_tmp):
    """Each knob that is not ported raises; checkpoint and log_every (item 7)
    and data_parallel (item 10; with method="single_loop" item 10b) run as
    in the JAX package; method="tr" (the
    host trust region) runs and matches the JAX entry point to 1e-8 (its whole
    comparison is in tests/test_torch_tr_learn.py); save_results=True writes
    the log, the quality table and the PNGs under the JAX prefix (the file
    sets against the JAX package's are in tests/test_torch_reporting.py), and
    visualise=True with the fused loop runs, as in the JAX package."""
    for name in ("scalar_bilevel_tvl1_learn", "patch_bilevel_tvl1_learn"):
        learn = getattr(tx, name)
        if knob == dict(method="tr"):
            kw = dict(ENTRY, **knob)
            res = learn(device="cpu", **kw)
            jkw = {} if "tvl1" == "tvl1" else dict(backend="jnp")
            jres = getattr(jx, name)(save_results=False, **jkw, **kw)
            assert res.iterations == jres.iterations == kw["maxiter"]
            np.testing.assert_allclose(res.x, np.asarray(jres.x), rtol=1e-8)
            np.testing.assert_allclose(res.cost, jres.cost, rtol=1e-8)
            continue
        if knob in (dict(save_results=True), dict(visualise=True)):
            res = learn(device="cpu", **dict(ENTRY, **knob))
            assert res.iterations == ENTRY["maxiter"]
            shape = "scalar" if name.startswith("scalar") else "(2, 2)"
            prefix = os.path.join(
                "output", "circle_sp_128_20",
                f"tvl1_optimal_parameter_{shape}_circle_sp_128_20")
            for suffix in (".txt", "_quality.txt", "_true_1.png",
                           "_data_1.png", "_reco_1.png"):
                assert os.path.isfile(prefix + suffix), prefix + suffix
            continue
        if knob in (dict(checkpoint=True), dict(log_every=1)):
            # item 7, ported: the JAX package's numbers, a checkpoint at
            # each segment end, real segment-end times
            kw = dict(ENTRY, **knob)
            res = learn(device="cpu", **kw)
            jres = getattr(jx, name)(save_results=False, **kw)
            assert res.iterations == jres.iterations == kw["maxiter"]
            np.testing.assert_allclose(res.x, np.asarray(jres.x), rtol=1e-8)
            assert all(e.time > 0 for e in res.state.log)
            if "checkpoint" in knob:
                out = os.path.join("output", "circle_sp_128_20")
                assert any(f.endswith("_ckpt.npz") for f in os.listdir(out))
            continue
        if knob.get("data_parallel"):
            # ported (item 10): with device="cpu" the mesh is one shard on
            # the CPU, which runs the unsharded learn bit for bit (meshes
            # of several shards against the JAX package's:
            # tests/test_torch_parallel.py)
            # (with method="single_loop": item 10b, rows 11–13, a few steps)
            kw = dict(ENTRY, **knob)
            if knob.get("method") == "single_loop":
                kw.update(sl_outer=2, sl_inner=5, sl_adj=2)
            res = learn(device="cpu", **kw)
            one = learn(device="cpu", **dict(kw, data_parallel=False))
            np.testing.assert_array_equal(res.x, one.x)
            np.testing.assert_array_equal(res.u, one.u)
            continue
        with pytest.raises(NotImplementedError):
            learn(device="cpu", **dict(ENTRY, **knob))
    with pytest.raises(ValueError, match="method="):
        tx.scalar_bilevel_tvl1_learn(device="cpu",
                                     **dict(ENTRY, method="newton"))
    with pytest.raises(NotImplementedError, match="device="):
        tx.TVL1Denoise(np.zeros((8, 8)), 0.9, maxiter=5, backend="jnp",
                       device="cpu")


def test_entry_points_default_to_the_card():
    """Without device="cpu" every new entry point asks for the card; on a
    machine without one it raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    ds = impulse_phantoms(batch=1)
    calls = [
        lambda: tx.scalar_bilevel_tvl1_learn(**ENTRY),
        lambda: tx.patch_bilevel_tvl1_learn(**ENTRY),
        lambda: tx.TVL1Denoise(ds[1], 0.9, maxiter=5),
        lambda: bilevel_learn_tvl1_fused(ds, xinit=np.array(0.4),
                                         params=Params(TR, maxiter=1)),
    ]
    for call in calls:
        with pytest.raises((RuntimeError, AssertionError)):
            call()
    assert tvl1_cuda.launches == 0
