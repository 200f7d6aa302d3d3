"""The port's TGV² trust-region learn (bilevel/fused_tgv.py) and its entry
points against the JAX package's ``bilevel_learn_tgv_fused(backend="jnp")``
and ``experiments.tgv`` on the same small float64 data: the per-iteration
(cost, ‖g‖, Δ, step, CG) log, the learned weights and the cost, for
scalar weights and a (2, 2, 2) patch stack, in parity mode (cold fixed
budget) and warm mode (early stop, chained solver state and multiplier).

Tolerance: 1e-8 relative on every logged number but the CG iteration
count, which may differ by one or two where a stop test lands within
rounding of its threshold.  The implicit gradient runs at γ = 1e-2, where
the smoothed joint system is well conditioned (at γ = 1e-4 the JAX package
moves its own gradient by ~2e-8 relative under a 1e-13 perturbation of u,
see tests/test_torch_tgv.py); γ enters both packages as a parameter.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bpldenoising_tpu.bilevel.fused_tgv import \
    bilevel_learn_tgv_fused as j_learn
from bpldenoising_tpu.experiments import tgv as jx
from bpldenoising_tpu.utils.config import Params as JParams
from bpldenoising_tpu_torch import experiments as tx
from bpldenoising_tpu_torch.bilevel.fused_tgv import (bilevel_learn_tgv_fused,
                                                      tgv_param_layout)
from bpldenoising_tpu_torch.solvers import tgv_cuda
from bpldenoising_tpu_torch.utils.config import Params
from bpldenoising_tpu_torch.parallel import make_batch_mesh
from test_torch_fused import (one_torch_thread,  # noqa: F401 (autouse)
                             results_in_tmp)

RTOL = 1e-8
TR = dict(eta1=0.25, eta2=0.75, beta1=0.25, beta2=1.9, delta0=0.02,
          tol=1e-7)
GAMMA = 1e-2


def _dataset(seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.arange(20), np.arange(24), indexing="ij")
    clean = np.stack([0.02 * xx + (yy > 10),
                      0.03 * yy + ((xx - 12) ** 2 + (yy - 10) ** 2 < 30)]
                     ).astype(np.float64)
    return clean, clean + 0.1 * rng.standard_normal(clean.shape)


def _compare(jres, tres):
    k = int(jres.iterations)
    assert tres.iterations == k
    jlog = np.asarray(jres.log)[:k]
    tlog = tres.log[:k].numpy()
    cols = [0, 1, 2, 3, 5]
    np.testing.assert_allclose(tlog[:, cols], jlog[:, cols], rtol=RTOL,
                               atol=1e-12)
    assert np.all(np.abs(tlog[:, 4] - jlog[:, 4]) <= 2 + 0.01 * jlog[:, 4])
    np.testing.assert_allclose(tres.x.numpy(), np.asarray(jres.x),
                               rtol=RTOL)
    np.testing.assert_allclose(float(tres.cost), float(jres.cost), rtol=RTOL)


CASES = {
    # name: (x0, inner_tol, outer its, beta2)
    "scalar_parity": (np.array([0.05, 0.05]), None, 3, 1.9),
    "scalar_warm": (np.array([0.05, 0.05]), 1e-4, 3, 1.9),
    "patch_parity": (0.05 * np.ones((2, 2, 2)), None, 3, 1.5),
    "patch_warm": (0.05 * np.ones((2, 2, 2)), 1e-4, 3, 1.5),
}


@pytest.mark.parametrize("case", list(CASES))
def test_trajectory_matches_jax(case):
    x0, inner_tol, outer, beta2 = CASES[case]
    ds = _dataset(seed=len(case))
    params = dict(TR, beta2=beta2, maxiter=outer)
    kw = dict(inner_maxiter=300, inner_tol=inner_tol, check_every=50,
              gamma=GAMMA)
    jres = j_learn((jnp.asarray(ds[0]), jnp.asarray(ds[1])),
                   xinit=jnp.asarray(x0), params=JParams(params),
                   backend="jnp", **kw)
    tres = bilevel_learn_tgv_fused(ds, xinit=x0, params=Params(params),
                                   device="cpu", **kw)
    assert tuple(tres.x.shape) == x0.shape
    assert tres.u.shape == (2, 20, 24)
    _compare(jres, tres)


def test_param_layout_and_refusals():
    ds = _dataset(seed=1)
    assert tgv_param_layout(torch.ones(2), (20, 24)) is None
    assert tgv_param_layout(torch.ones((2, 3, 2)), (20, 24)).block == \
        (10, 8)
    with pytest.raises(ValueError):
        tgv_param_layout(torch.ones(3), (20, 24))
    p = Params(TR, maxiter=1)
    with pytest.raises(ValueError):
        bilevel_learn_tgv_fused(ds, xinit=np.array([0.05, 0.0]), params=p,
                                device="cpu")
    kw = dict(xinit=np.array([0.05, 0.05]), params=p, device="cpu")
    # a mesh does not compose with segmented dispatch, as in the JAX package
    mesh = make_batch_mesh(devices=["cpu"])
    with pytest.raises(ValueError, match="log_every"):
        bilevel_learn_tgv_fused(ds, mesh=mesh, log_every=1, **kw)
    # segmented dispatch runs the single run's bits; an init_B of another
    # shape than the model's is ignored, as in the JAX package
    one = bilevel_learn_tgv_fused(ds, **kw)
    # a one-shard mesh on the CPU runs the unsharded learn bit for bit
    # (meshes against the JAX package's: tests/test_torch_parallel.py)
    dp = bilevel_learn_tgv_fused(ds, mesh=mesh, **kw)
    assert torch.equal(dp.x, one.x) and torch.equal(dp.log, one.log)
    seg = bilevel_learn_tgv_fused(ds, log_every=1, init_B=1, **kw)
    assert torch.equal(seg.x, one.x) and torch.equal(seg.log, one.log)
    assert one.times is None and seg.times.shape == (one.iterations,)
    # a lone segment_callback is ignored, as the JAX single run ignores it
    lone = bilevel_learn_tgv_fused(ds, segment_callback=1, **kw)
    assert torch.equal(lone.x, one.x) and torch.equal(lone.log, one.log)


@pytest.fixture
def in_tmp(tmp_path, monkeypatch):
    """The JAX entry points create output/<dataset>/ under the working
    directory: keep it out of the repo."""
    monkeypatch.chdir(tmp_path)
    return tmp_path


ENTRY = dict(dataset_name="circle", num_samples=1, method="tr_fused",
             maxiter=2, inner_maxiter=150, tgv_gamma=GAMMA)


@pytest.mark.parametrize("family,inner_tol", [("scalar", None),
                                              ("patch", 1e-3)])
def test_entry_points_match_jax(in_tmp, family, inner_tol):
    kw = dict(ENTRY, inner_tol=inner_tol)
    if family == "scalar":
        jres = jx.scalar_bilevel_tgv_learn(save_results=False,
                                           backend="jnp", **kw)
        tres = tx.scalar_bilevel_tgv_learn(device="cpu", **kw)
        assert tres.x.shape == (2,)
    else:
        jres = jx.patch_bilevel_tgv_learn(save_results=False,
                                          backend="jnp", **kw)
        tres = tx.patch_bilevel_tgv_learn(device="cpu", **kw)
        assert tres.x.shape == (2, 2, 2)
    assert tres.iterations == jres.iterations == 2
    assert tres.u.shape == (1, 128, 128) and tres.u.dtype == np.float64
    assert len(tres.state.log) == 2
    np.testing.assert_allclose(tres.x, np.asarray(jres.x), rtol=RTOL)
    np.testing.assert_allclose(tres.cost, jres.cost, rtol=RTOL)
    np.testing.assert_allclose(tres.u, np.asarray(jres.u),
                               atol=1e-10)


@pytest.mark.parametrize("parameter", [(0.1, 0.2),
                                       [[[0.05, 0.1], [0.1, 0.2]],
                                        [[0.08, 0.3], [0.02, 0.1]]]])
def test_tgv_denoise_matches_jax(parameter):
    _, noisy = _dataset(seed=3)
    got = tx.TGVDenoise(noisy, parameter, maxiter=200, device="cpu")
    want = jx.TGVDenoise(jnp.asarray(noisy), parameter, maxiter=200,
                         backend="jnp")
    assert got.shape == (2, 20, 24)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-12)
    with pytest.raises(ValueError):
        tx.TGVDenoise(noisy, (0.1, 0.2, 0.3), maxiter=5, device="cpu")


def test_entry_points_refuse_what_is_not_ported(in_tmp):
    """data_parallel=True with method="single_loop" runs (one CPU shard,
    the unsharded bits); save_iterations with
    the fused loop writes the JAX package's snapshots; the host trust
    region (method="tr") runs and
    matches the JAX entry point to 1e-8 (its whole comparison is in
    tests/test_torch_tr_learn.py), and visualise=True with the fused loop
    runs, as in the JAX package."""
    kw = dict(ENTRY, method="tr")
    res = tx.scalar_bilevel_tgv_learn(device="cpu", **kw)
    jres = jx.scalar_bilevel_tgv_learn(save_results=False, backend="jnp",
                                       **kw)
    assert res.iterations == jres.iterations == 2
    np.testing.assert_allclose(res.x, np.asarray(jres.x), rtol=RTOL)
    np.testing.assert_allclose(res.cost, jres.cost, rtol=RTOL)
    # data_parallel with method="single_loop" runs (item 10b, rows 11–13):
    # with device="cpu" one shard, the run without it bit for bit
    sl = dict(ENTRY, method="single_loop", sl_outer=2, sl_inner=5, sl_adj=2)
    dp = tx.patch_bilevel_tgv_learn(device="cpu", data_parallel=True, **sl)
    one = tx.patch_bilevel_tgv_learn(device="cpu", **sl)
    np.testing.assert_array_equal(dp.x, one.x)
    np.testing.assert_array_equal(dp.u, one.u)
    # save_iterations with the fused loop writes the JAX package's
    # snapshots (segments of 5: one at the end of the 2 iterations)
    tx.scalar_bilevel_tgv_learn(device="cpu",
                                **dict(ENTRY, save_iterations=True))
    snaps = {f for f in os.listdir("output/circle_128_10") if "_iter_" in f}
    for f in snaps:
        os.remove(os.path.join("output/circle_128_10", f))
    jx.scalar_bilevel_tgv_learn(save_results=False, backend="jnp",
                                **dict(ENTRY, save_iterations=True))
    assert snaps == {f for f in os.listdir("output/circle_128_10")
                     if "_iter_" in f} == {
        "tgv_optimal_parameter_circle_128_10_iter_2.png"}
    # the fused loop shows no live view: visualise is ignored, as in JAX
    res = tx.scalar_bilevel_tgv_learn(device="cpu", visualise=True, **ENTRY)
    assert res.iterations == ENTRY["maxiter"]


def test_entry_points_default_to_the_card():
    """Without device="cpu" every new entry point asks for the card; on a
    machine without one it raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    ds = _dataset(seed=2)
    calls = [
        lambda: tx.scalar_bilevel_tgv_learn(**ENTRY),
        lambda: tx.patch_bilevel_tgv_learn(**ENTRY),
        lambda: tx.TGVDenoise(ds[1], (0.1, 0.2), maxiter=5),
        lambda: bilevel_learn_tgv_fused(ds, xinit=np.array([0.05, 0.05]),
                                        params=Params(TR, maxiter=1)),
    ]
    for call in calls:
        with pytest.raises((RuntimeError, AssertionError)):
            call()
    assert tgv_cuda.launches == 0
