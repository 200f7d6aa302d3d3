"""The port's VTV trust-region learn (bilevel/fused_vtv.py) and its entry
points against the JAX package's ``bilevel_learn_vtv_fused(backend="jnp")``
and ``experiments.vtv`` on the same float64 data: the per-iteration
(cost, ‖g‖, Δ, step, CG) log, the learned weight and the cost, for a scalar
α, a 2×2 patch grid and a full-resolution map, in parity mode (cold fixed
budget, cold adjoint) and warm mode (early stop, chained solver state and
adjoint); then the entry points' ``BilevelResult`` and ``state.log``,
``VTVDenoise`` and the refusals.

Inputs: two 16×16 RGB phantoms under Gaussian noise, made with numpy from
a seed (tests/test_torch_vtv.py), and the bundled ``color_disks`` dataset
for the entry points.

Tolerances: at γ = 1e-2 (a well-conditioned adjoint system) 1e-8
relative on every logged number and the weight, 1e-10 absolute on u, with
equal CG counts (measured gap ~1e-13).  At the learns' default γ = 1e-4
the adjoint system is ill-conditioned (tests/test_torch_vtv.py: the JAX package moves its own
dα by 2.5e-8 and its CG count by three under a 1e-13 perturbation of u),
so there the log and the weight are held to 1e-6 relative, u (which
follows the weight) to 1e-8 absolute and the CG counts to 2% + 1.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bpldenoising_tpu.bilevel.fused_vtv import \
    bilevel_learn_vtv_fused as j_learn
from bpldenoising_tpu.experiments import vtv as jx
from bpldenoising_tpu.utils.config import Params as JParams
from bpldenoising_tpu_torch import experiments as tx
from bpldenoising_tpu_torch.bilevel import BilevelResult
from bpldenoising_tpu_torch.bilevel.fused_vtv import (
    bilevel_learn_vtv_fused, vtv_param_layout)
from bpldenoising_tpu_torch.solvers import vtv_cuda
from bpldenoising_tpu_torch.utils.config import Params
from test_torch_vtv import color_phantoms
from test_torch_fused import one_torch_thread  # noqa: F401 (autouse)

TR = dict(eta1=0.25, eta2=0.75, beta1=0.25, beta2=1.9, delta0=0.02,
          tol=1e-7)


def _compare(jres, tres, rtol, cg_slack):
    k = int(jres.iterations)
    assert tres.iterations == k
    jlog = np.asarray(jres.log)[:k]
    tlog = tres.log[:k].numpy()
    cols = [0, 1, 2, 3, 5]
    np.testing.assert_allclose(tlog[:, cols], jlog[:, cols], rtol=rtol,
                               atol=1e-12)
    assert np.all(np.abs(tlog[:, 4] - jlog[:, 4])
                  <= cg_slack * (1 + 0.02 * jlog[:, 4]))
    # a map weight may sit at the positivity bound (~1e-16): atol there
    np.testing.assert_allclose(tres.x.numpy(), np.asarray(jres.x),
                               rtol=rtol, atol=1e-12)
    np.testing.assert_allclose(float(tres.cost), float(jres.cost), rtol=rtol)
    np.testing.assert_allclose(tres.u.numpy(), np.asarray(jres.u),
                               atol=rtol / 100)


CASES = {
    # name: (x0, inner_tol, γ)
    "scalar_parity": (np.array(0.05), None, 1e-2),
    "scalar_warm": (np.array(0.05), 1e-5, 1e-2),
    "patch_parity": (0.05 * np.ones((2, 2)), None, 1e-2),
    "patch_warm": (0.05 * np.ones((2, 2)), 1e-5, 1e-2),
    "map_parity": (0.05 * np.ones((16, 16)), None, 1e-2),
    "map_warm": (0.05 * np.ones((16, 16)), 1e-5, 1e-2),
    "scalar_parity_default_gamma": (np.array(0.05), None, 1e-4),
    "patch_warm_default_gamma": (0.05 * np.ones((2, 2)), 1e-5, 1e-4),
}


@pytest.mark.parametrize("case", list(CASES))
def test_trajectory_matches_jax(case):
    x0, inner_tol, gamma = CASES[case]
    ds = color_phantoms()
    params = dict(TR, maxiter=3)
    kw = dict(inner_maxiter=600, inner_tol=inner_tol, check_every=50,
              gamma=gamma)
    jres = j_learn((jnp.asarray(ds[0]), jnp.asarray(ds[1])),
                   xinit=jnp.asarray(x0), params=JParams(params),
                   backend="jnp", **kw)
    tres = bilevel_learn_vtv_fused(ds, xinit=x0, params=Params(params),
                                   device="cpu", **kw)
    assert tuple(tres.x.shape) == x0.shape
    assert tres.u.shape == (2, 3, 16, 16)
    if gamma == 1e-2:
        _compare(jres, tres, rtol=1e-8, cg_slack=0)
    else:
        _compare(jres, tres, rtol=1e-6, cg_slack=1)


def test_param_layout_and_refusals():
    ds = color_phantoms()
    assert vtv_param_layout(torch.tensor(0.05), (16, 16)) is None
    assert vtv_param_layout(torch.ones((16, 16)), (16, 16)) is None
    assert vtv_param_layout(torch.ones((2, 4)), (16, 16)).block == (8, 4)
    with pytest.raises(ValueError, match="scalar, an"):
        vtv_param_layout(torch.ones(3), (16, 16))
    p = Params(TR, maxiter=1)
    with pytest.raises(ValueError):
        bilevel_learn_vtv_fused(ds, xinit=np.array(-0.05), params=p,
                                device="cpu")
    with pytest.raises(ValueError, match="color"):
        bilevel_learn_vtv_fused((ds[0][0, 0], ds[1][0, 0]),
                                xinit=np.array(0.05), params=p, device="cpu")
    for knob in ("mesh", "log_every", "segment_callback", "init_B"):
        with pytest.raises(NotImplementedError):
            bilevel_learn_vtv_fused(ds, xinit=np.array(0.05), params=p,
                                    device="cpu", **{knob: 1})


@pytest.fixture
def in_tmp(tmp_path, monkeypatch):
    """The JAX entry points create output/<dataset>/ under the working
    directory: keep it out of the repo."""
    monkeypatch.chdir(tmp_path)
    return tmp_path


ENTRY = dict(dataset_name="color_disks", num_samples=1, method="tr_fused",
             maxiter=2, inner_maxiter=200, vtv_gamma=1e-2)


@pytest.mark.parametrize("family,inner_tol", [("scalar", None),
                                              ("patch", 1e-4)])
def test_entry_points_match_jax(in_tmp, family, inner_tol):
    """The learns through their entry points: a BilevelResult like the JAX
    package's, whose state.log matches entry for entry."""
    kw = dict(ENTRY, inner_tol=inner_tol)
    if family == "scalar":
        jres = jx.scalar_bilevel_vtv_learn(save_results=False,
                                           backend="jnp", **kw)
        tres = tx.scalar_bilevel_vtv_learn(device="cpu", **kw)
        assert tres.x.shape == ()
    else:
        jres = jx.patch_bilevel_vtv_learn(save_results=False,
                                          backend="jnp", **kw)
        tres = tx.patch_bilevel_vtv_learn(device="cpu", **kw)
        assert tres.x.shape == (2, 2)
    assert isinstance(tres, BilevelResult)
    assert tres.iterations == jres.iterations == 2
    assert tres.u.shape == (1, 3, 128, 128) and tres.u.dtype == np.float64
    np.testing.assert_allclose(tres.x, np.asarray(jres.x), rtol=1e-8)
    np.testing.assert_allclose(tres.cost, jres.cost, rtol=1e-8)
    np.testing.assert_allclose(tres.g_norm, jres.g_norm, rtol=1e-8)
    np.testing.assert_allclose(tres.u, np.asarray(jres.u), atol=1e-10)
    assert len(tres.state.log) == len(jres.state.log) == 2
    for t, j in zip(tres.state.log, jres.state.log):
        assert t.iter == j.iter and t.time == 0.0
        np.testing.assert_allclose(
            [t.function_value, t.g_norm, t.delta, t.step_norm,
             t.adjoint_cg_converged],
            [j.function_value, j.g_norm, j.delta, j.step_norm,
             j.adjoint_cg_converged], rtol=1e-8, atol=1e-12)
        assert t.adjoint_cg_iters == j.adjoint_cg_iters


@pytest.mark.parametrize("parameter", [
    0.1, "map", [[0.06, 0.12], [0.09, 0.15]]], ids=["scalar", "map",
                                                   "patch"])
def test_vtv_denoise_matches_jax(parameter):
    _, noisy = color_phantoms()
    if parameter == "map":
        parameter = 0.05 + 0.1 * np.random.default_rng(3).random((16, 16))
    got = tx.VTVDenoise(noisy, parameter, maxiter=200, device="cpu")
    want = jx.VTVDenoise(jnp.asarray(noisy), parameter, maxiter=200,
                         backend="jnp")
    assert got.shape == (2, 3, 16, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-12)
    with pytest.raises(ValueError):
        tx.VTVDenoise(noisy, np.ones(3), maxiter=5, device="cpu")


@pytest.mark.parametrize("knob", [
    dict(method="tr"), dict(method="single_loop", data_parallel=True),
    dict(save_results=True),
    dict(checkpoint=True), dict(data_parallel=True), dict(log_every=1),
    dict(backend="pallas"), dict(visualise=True)],
    ids=lambda k: next(iter(k)) + "=" + str(next(iter(k.values()))))
def test_entry_points_refuse_what_is_not_ported(knob, in_tmp):
    """Each knob that is not ported raises; method="tr" (the host trust
    region) runs and matches the JAX entry point to 1e-8 (its whole
    comparison is in tests/test_torch_tr_learn.py)."""
    for name in ("scalar_bilevel_vtv_learn", "patch_bilevel_vtv_learn"):
        learn = getattr(tx, name)
        if knob == dict(method="tr"):
            kw = dict(ENTRY, **knob)
            res = learn(device="cpu", **kw)
            jkw = {} if "vtv" == "tvl1" else dict(backend="jnp")
            jres = getattr(jx, name)(save_results=False, **jkw, **kw)
            assert res.iterations == jres.iterations == kw["maxiter"]
            np.testing.assert_allclose(res.x, np.asarray(jres.x), rtol=1e-8)
            np.testing.assert_allclose(res.cost, jres.cost, rtol=1e-8)
            continue
        with pytest.raises(NotImplementedError):
            learn(device="cpu", **dict(ENTRY, **knob))
    with pytest.raises(ValueError, match="method="):
        tx.scalar_bilevel_vtv_learn(device="cpu",
                                    **dict(ENTRY, method="newton"))
    with pytest.raises(NotImplementedError, match="device="):
        tx.VTVDenoise(np.zeros((3, 8, 8)), 0.1, maxiter=5, backend="jnp",
                      device="cpu")


def test_entry_points_default_to_the_card():
    """Without device="cpu" every new entry point asks for the card; on a
    machine without one it raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    ds = color_phantoms()
    calls = [
        lambda: tx.scalar_bilevel_vtv_learn(**ENTRY),
        lambda: tx.patch_bilevel_vtv_learn(**ENTRY),
        lambda: tx.VTVDenoise(ds[1], 0.1, maxiter=5),
        lambda: bilevel_learn_vtv_fused(ds, xinit=np.array(0.05),
                                        params=Params(TR, maxiter=1)),
    ]
    for call in calls:
        with pytest.raises((RuntimeError, AssertionError)):
            call()
    assert vtv_cuda.launches == 0
