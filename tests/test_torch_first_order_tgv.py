"""The port's single-loop TGV² learner (bilevel/first_order_tgv.py, its
plain version on the CPU) and its entry points against the JAX package on
the same float64 data: the jnp scan (``single_loop_tgv_learn``) for the
(2,) weight and a (2, 2, 2) patch stack at one and two images, the Pallas
kernel in interpret mode (``single_loop_tgv_pallas``, TPU kernel 11) at
one image, segmented runs, a JAX carry resumed in the port, the two
``method="single_loop"`` entry points with their ``state.log``, and the
refusals.

Inputs: a ramp with a step and a disc under Gaussian noise, made with
numpy from a seed; the bundled ``circle`` dataset for the entry points.

Tolerance: 1e-9 relative on α, u and the trajectories over 12 outer
steps (measured ≤ 2.4e-14; ≤ 1.1e-13 at 30 steps of 20 CP and 6 CG
steps).  At γ = 1e-4 the smoothed joint system is ill-conditioned: the
JAX package itself moves its TGV gradient by ~2e-8 relative under a
1e-13 perturbation (tests/test_torch_tgv.py, ROADMAP.md §3), so a longer
horizon, where Adam compounds such a difference, could not be held to
rounding.  Tests marked ``cuda`` hold the CUDA learner against its plain
version on the card and skip without one.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bpldenoising_tpu.bilevel import first_order_tgv as jfo
from bpldenoising_tpu.bilevel.first_order_tgv_pallas import \
    single_loop_tgv_pallas
from bpldenoising_tpu.experiments import tgv as jx
from bpldenoising_tpu_torch import experiments as tx
from bpldenoising_tpu_torch.bilevel import first_order_tgv as tfo
from bpldenoising_tpu_torch.bilevel import first_order_tgv_cuda as tfc
from bpldenoising_tpu_torch.weights import from_jax_state
from test_torch_fused import (one_torch_thread,  # noqa: F401 (autouse)
                             results_in_tmp)

RTOL = 1e-9
KW = dict(outer=12, n_inner=10, n_adj=4, lr=0.02)
PARAMS = {"vector": np.array([0.05, 0.08]),
          "patch": np.stack([np.full((2, 2), 0.05), np.full((2, 2), 0.08)],
                            axis=-1)}


def images(O=2, seed=3):
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.arange(16), np.arange(16), indexing="ij")
    clean = np.stack([0.04 * xx + (yy > 8),
                      ((xx - 8) ** 2 + (yy - 7) ** 2 < 25) + 0.02 * yy]
                     )[:O].astype(np.float64)
    return clean, clean + 0.1 * rng.standard_normal(clean.shape)


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _close(got, want, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=1e-12)


def _compare(tres, jres):
    for name in ("alpha", "u", "alpha_trajectory", "cost_trajectory",
                 "gnorm_trajectory", "cost"):
        _close(getattr(tres, name), getattr(jres, name))


@pytest.mark.parametrize("O", [1, 2])
@pytest.mark.parametrize("name", list(PARAMS))
def test_plain_learner_matches_jax_scan(name, O):
    x0 = PARAMS[name]
    ut, f = images(O)
    jres = jfo.single_loop_tgv_learn(jnp.asarray(ut), jnp.asarray(f),
                                     jnp.asarray(x0), **KW)
    tres = tfo.single_loop_tgv_learn(_t(ut), _t(f), x0, **KW)
    assert tuple(tres.alpha.shape) == x0.shape
    assert tuple(tres.alpha_trajectory.shape) == (KW["outer"],) + x0.shape
    _compare(tres, jres)


def test_plain_learner_matches_pallas_kernel():
    """TPU kernel 11 in interpret mode, through the port's counterpart of
    its entry point (the plain version on CPU tensors), on one image."""
    ut, f = images(1)
    x0 = PARAMS["vector"]
    ja, ju, jtraj = single_loop_tgv_pallas(jnp.asarray(ut[0]),
                                           jnp.asarray(f[0]),
                                           jnp.asarray(x0), interpret=True,
                                           **KW)
    a, u, traj = tfc.single_loop_tgv_cuda(_t(ut[0]), _t(f[0]), x0, **KW)
    assert u.shape == (16, 16) and traj.shape == (KW["outer"],)
    _close(a, ja)
    _close(u, ju)
    _close(traj, jtraj)


def test_segments_match_one_run():
    """log_every segments hand the whole carry on: the same numbers as one
    run, and real, cumulative segment-end times."""
    ut, f = images(2)
    x0 = PARAMS["vector"]
    one = tfo.single_loop_tgv_learn(_t(ut), _t(f), x0, **KW)
    seg = tfo.single_loop_tgv_learn(_t(ut), _t(f), x0, log_every=5, **KW)
    for name in ("alpha", "u", "alpha_trajectory", "cost_trajectory",
                 "gnorm_trajectory"):
        assert torch.equal(getattr(seg, name), getattr(one, name)), name
    assert one.times is None and seg.times.shape == (KW["outer"],)
    assert np.all(seg.times > 0) and np.all(np.diff(seg.times) >= 0)
    assert len(set(seg.times.tolist())) == -(-KW["outer"] // 5)


def test_jax_carry_resumes_in_the_port():
    """A JAX segment's carry ((u, w, p, q), λ, z, (m, v), t), handed over
    by from_jax_state, continues in the port as in the JAX package."""
    ut, f = images(2)
    x0 = PARAMS["patch"]
    utj, fj, x0j = jnp.asarray(ut), jnp.asarray(f), jnp.asarray(x0)
    kw = dict(n_inner=6, n_adj=3, lr=0.02, gamma=1e-4, tau0=0.99,
              sigma0=0.99, beta1=0.9, beta2=0.999, eps=1e-8)
    jpop = jfo.tgv_param_layout(x0j, f.shape[-2:])
    _, carry = jfo._single_loop_tgv_impl(
        utj, fj, x0j, outer=6, pop=jpop, param_shape=x0.shape,
        return_carry=True, **kw)
    jres = jfo._single_loop_tgv_impl(utj, fj, x0j, outer=5, pop=jpop,
                                     param_shape=x0.shape, carry0=carry,
                                     **kw)
    tpop = tfo.tgv_param_layout(_t(x0), f.shape[-2:])
    tres = tfo._single_loop_tgv_impl(
        _t(ut), _t(f), _t(x0), outer=5, pop=tpop, param_shape=x0.shape,
        carry0=from_jax_state(carry, device="cpu"), **kw)
    _compare(tres, jres)


SL = dict(dataset_name="circle", num_samples=2, method="single_loop",
          sl_outer=4, sl_inner=5, sl_adj=3)


@pytest.mark.parametrize("entry", ["scalar_bilevel_tgv_learn",
                                   "patch_bilevel_tgv_learn"])
def test_entry_points_match_jax(entry, tmp_path, monkeypatch):
    """method="single_loop" on the CPU against the JAX entry point: x, u,
    cost, ‖g‖ and the state.log entries (the radius NaN); times are real,
    not compared."""
    monkeypatch.chdir(tmp_path)   # the JAX entry points may write output/
    jres = getattr(jx, entry)(save_results=False, **SL)
    tres = getattr(tx, entry)(device="cpu", **SL)
    assert isinstance(tres.x, np.ndarray) and isinstance(tres.u, np.ndarray)
    assert tres.iterations == jres.iterations == SL["sl_outer"]
    for a, b in ((tres.x, jres.x), (tres.u, jres.u), (tres.cost, jres.cost),
                 (tres.g_norm, jres.g_norm)):
        _close(a, b)
    assert len(tres.state.log) == len(jres.state.log) == SL["sl_outer"]
    for a, b in zip(tres.state.log, jres.state.log):
        assert a.iter == b.iter and np.isnan(a.delta)
        _close([a.function_value, a.g_norm, a.step_norm],
               [b.function_value, b.g_norm, b.step_norm])
    times = [e.time for e in tres.state.log]
    assert all(t > 0 for t in times) and times == sorted(times)


@pytest.mark.parametrize("flag", ["checkpoint", "resume", "save_iterations",
                                  "inner_tol"])
def test_entry_point_rejects_the_jax_flags(flag):
    with pytest.raises(ValueError, match=flag):
        tx.scalar_bilevel_tgv_learn(device="cpu", **dict(SL, **{flag: 1e-3}))


def test_refusals(monkeypatch):
    """optimizer= raises (mesh= runs: tests/test_torch_first_order_mesh.py);
    x₀ ≤ 0 and a bad shape raise; a tensor on neither the CPU nor the card
    never reaches the plain loop."""
    ut, f = images(1)
    x0 = PARAMS["vector"]
    with pytest.raises(NotImplementedError, match="optax"):
        tfo.single_loop_tgv_learn(_t(ut), _t(f), x0, optimizer=object())
    with pytest.raises(ValueError, match="strictly positive"):
        tfo.single_loop_tgv_learn(_t(ut), _t(f), np.array([0.05, 0.0]))
    with pytest.raises(ValueError, match="length-2"):
        tfc.single_loop_tgv_cuda(_t(ut), _t(f), np.array([0.05]))

    def forbidden(*a, **k):
        raise AssertionError("the plain loop ran")
    monkeypatch.setattr(tfo, "_single_loop_tgv_plain", forbidden)
    meta = torch.zeros((1, 8, 8), dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        tfo.single_loop_tgv_learn(meta, meta, x0, outer=1)
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            tx.scalar_bilevel_tgv_learn(**SL)     # device="cuda" by default


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (python -m pytest "
                    "tests/test_torch_first_order_tgv.py -m cuda)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(PARAMS))
def test_kernel_matches_plain_version_on_the_card(cuda_device, name):
    x0 = PARAMS[name]
    ut, f = images(2)
    before = tfc.launches
    k = tfo.single_loop_tgv_learn(_t(ut).to(cuda_device),
                                  _t(f).to(cuda_device), x0, **KW)
    assert tfc.launches == before + 1
    p = tfo.single_loop_tgv_learn(_t(ut), _t(f), x0, **KW)
    for a, b in zip(k[:5], p[:5]):
        _close(a.cpu(), b)
