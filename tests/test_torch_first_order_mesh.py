"""The TGV², TV-L1 and VTV single-loop learners with ``mesh=`` (their
plain versions on a mesh of four CPU shards) against the JAX package's
learners on its four virtual CPU devices (tests/conftest.py), on the
inputs of the JAX package's own mesh tests
(test_first_order_tgv.py::test_mesh_matches_single_device, the same in
test_first_order_vtv.py, and test_tvl1_methods.py's
TestSingleLoopTVL1::test_mesh_matches_single_device), in float64: four
images and the uneven batch of three (one shard all padding), one run and
``log_every`` segments (test_first_order.py::test_segmented_mesh's form).

Tolerance: 1e-8 relative on α, the JAX tests' own; each shard's CG takes
per-image dots, so only the order of the cross-shard sums of the gradient
maps and the cost separates the runs (measured ≤ 8e-15).  A shard of
padding adds exactly +0: one image over two shards is the unsharded run
bit for bit.  The three families' entry points run ``data_parallel=True``
with ``method="single_loop"`` over one CPU shard, bit for bit the run
without it.  The TV and sum-of-regularizers single loop's mesh:
tests/test_torch_first_order_tv_mesh.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from bpldenoising_tpu.bilevel import first_order_tgv as jtgv
from bpldenoising_tpu.bilevel import first_order_tvl1 as jtvl1
from bpldenoising_tpu.bilevel import first_order_vtv as jvtv
from bpldenoising_tpu.data.generate import add_impulse_noise, circle_phantom
from bpldenoising_tpu_torch import experiments as tx
from bpldenoising_tpu_torch.bilevel import first_order_tgv as ttgv
from bpldenoising_tpu_torch.bilevel import first_order_tvl1 as ttvl1
from bpldenoising_tpu_torch.bilevel import first_order_vtv as tvtv
from bpldenoising_tpu_torch.parallel import make_batch_mesh
from test_torch_fused import (one_torch_thread,  # noqa: F401 (autouse)
                              results_in_tmp)

RTOL = 1e-8


def _tgv_data():
    rng = np.random.default_rng(11)
    n = 16
    clean = np.stack([np.broadcast_to(np.linspace(0, 1, n), (n, n))] * 4)
    return clean, clean + 0.1 * rng.standard_normal((4, n, n))


def _tvl1_data():
    clean = circle_phantom(24)
    return (np.stack([clean] * 4),
            np.stack([add_impulse_noise(clean, 0.2, i) for i in range(4)]))


def _vtv_data():
    """test_first_order_vtv.py::color_stack(rng(11), n=16, O=4), drawn in
    float32 as there and taken to float64."""
    rng = np.random.default_rng(11)
    n, O = 16, 4
    yy, xx = np.mgrid[0:n, 0:n]
    clean = np.zeros((O, 3, n, n), np.float32)
    for o in range(O):
        cx, cy = rng.uniform(4, n - 4, 2)
        r = rng.uniform(n / 5, n / 3)
        mask = (yy - cy) ** 2 + (xx - cx) ** 2 < r * r
        col = rng.uniform(0.2, 0.9, 3)
        for c in range(3):
            clean[o, c][mask] = col[c]
    noisy = clean + 0.15 * rng.standard_normal(clean.shape).astype(
        np.float32)
    return clean.astype(np.float64), noisy.astype(np.float64)


# family → (port learner, JAX learner, data, x0, the JAX test's knobs)
FAMILIES = {
    "tgv": (ttgv.single_loop_tgv_learn, jtgv.single_loop_tgv_learn,
            _tgv_data, np.array([0.05, 0.05]),
            dict(outer=25, n_inner=20, n_adj=6, lr=0.05)),
    "tvl1": (ttvl1.single_loop_tvl1_learn, jtvl1.single_loop_tvl1_learn,
             _tvl1_data, 0.3,
             dict(outer=40, n_inner=15, n_adj=5, gamma_d=100.0,
                  gamma=1000.0)),
    "vtv": (tvtv.single_loop_vtv_learn, jvtv.single_loop_vtv_learn,
            _vtv_data, 0.05, dict(outer=25, n_inner=20, n_adj=6, lr=0.05)),
}


def _runs(family, O, segment_callback=None, **extra):
    port, jax_learn, data, x0, kw = FAMILIES[family]
    ut, f = (a[:O] for a in data())
    mesh = make_batch_mesh(devices=["cpu"] * 4)
    jmesh = JMesh(np.array(jax.devices()[:4]), ("batch",))
    res = port(torch.from_numpy(ut), torch.from_numpy(f), x0, mesh=mesh,
               segment_callback=segment_callback, **kw, **extra)
    jres = jax_learn(jnp.asarray(ut), jnp.asarray(f), x0, mesh=jmesh, **kw,
                     **extra)
    return res, jres


def _compare(res, jres):
    np.testing.assert_allclose(res.alpha.numpy(), np.asarray(jres.alpha),
                               rtol=RTOL)
    np.testing.assert_allclose(res.alpha_trajectory.numpy(),
                               np.asarray(jres.alpha_trajectory), rtol=RTOL)
    np.testing.assert_allclose(res.cost_trajectory.numpy(),
                               np.asarray(jres.cost_trajectory), rtol=RTOL)
    np.testing.assert_allclose(float(res.cost), float(jres.cost), rtol=RTOL)
    assert res.u.shape == jres.u.shape
    np.testing.assert_allclose(res.u.numpy(), np.asarray(jres.u), rtol=RTOL,
                               atol=1e-12)


@pytest.mark.parametrize("O", [4, 3], ids=["even", "uneven"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_mesh_matches_jax_mesh(family, O):
    res, jres = _runs(family, O)
    _compare(res, jres)
    assert res.times is None


@pytest.mark.parametrize("family", list(FAMILIES))
def test_segmented_mesh_matches_jax(family):
    """log_every with mesh= hands each shard's carry on between segments
    (the uneven batch; segment_callback at every hop)."""
    hops = []
    res, jres = _runs(family, 3, log_every=6,
                      segment_callback=lambda done, t: hops.append(done))
    _compare(res, jres)
    outer = FAMILIES[family][4]["outer"]
    assert hops == list(range(6, outer, 6)) + [outer]
    assert res.times.shape == (outer,) and np.all(np.diff(res.times) >= 0)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_padding_shard_adds_exactly_zero(family):
    """One image over two shards: the second shard is all padding and adds
    +0 to every gradient map and cost, so the run is the unsharded one bit
    for bit."""
    port, _, data, x0, kw = FAMILIES[family]
    ut, f = (torch.from_numpy(a[:1]) for a in data())
    kw = dict(kw, outer=8)
    one = port(ut, f, x0, **kw)
    two = port(ut, f, x0, mesh=make_batch_mesh(devices=["cpu"] * 2), **kw)
    for a, b in zip(one[:5], two[:5]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("entry", ["scalar_bilevel_tgv_learn",
                                   "scalar_bilevel_tvl1_learn",
                                   "scalar_bilevel_vtv_learn"])
def test_entry_point_data_parallel_single_loop(entry):
    """data_parallel=True with method="single_loop" runs over one CPU
    shard (device="cpu"): the run without it, bit for bit."""
    kw = dict(method="single_loop", sl_outer=3, sl_inner=5, sl_adj=2,
              num_samples=2, save_results=False, device="cpu")
    if entry == "scalar_bilevel_tvl1_learn":
        kw["dataset_name"] = "circle_sp"
    elif entry == "scalar_bilevel_tgv_learn":
        kw["dataset_name"] = "circle"
    one = getattr(tx, entry)(**kw)
    dp = getattr(tx, entry)(data_parallel=True, **kw)
    assert np.array_equal(one.x, dp.x) and np.array_equal(one.u, dp.u)
    assert one.cost == dp.cost


def test_cli_data_parallel_single_loop(capsys):
    """--data-parallel with --method single_loop runs in the TGV², TV-L1
    and VTV subcommands (one CPU shard) and prints the run without it; so
    does the TV subcommand (rows 9–10's mesh)."""
    from bpldenoising_tpu_torch.__main__ import main
    run = ["scalar-tvl1", "--dataset", "circle_sp", "--method",
           "single_loop", "--sl-outer", "2", "--sl-inner", "3", "--sl-adj",
           "2", "--device", "cpu"]
    main(run)
    plain = capsys.readouterr().out
    main(run + ["--data-parallel"])
    assert capsys.readouterr().out == plain and "iterations = 2" in plain
    tv = ["scalar-tv", "--dataset", "circle", "--method", "single_loop",
          "--sl-outer", "2", "--sl-inner", "3", "--sl-adj", "2", "--device",
          "cpu"]
    main(tv)
    plain = capsys.readouterr().out
    main(tv + ["--data-parallel"])
    assert capsys.readouterr().out == plain and "iterations = 2" in plain


@pytest.mark.parametrize("family", list(FAMILIES))
def test_mesh_off_the_cpu_never_runs_the_plain_stepper(family, monkeypatch):
    """A mesh whose shards are not on the CPU (here: meta tensors) goes to
    the CUDA learner's session, which raises; the plain stepper and loop
    never run."""
    port, _, data, x0, kw = FAMILIES[family]
    mod = {"tgv": ttgv, "tvl1": ttvl1, "vtv": tvtv}[family]

    def forbidden(*a, **k):
        raise AssertionError("the plain learner ran")
    monkeypatch.setattr(mod, f"_{family}_plain_stepper", forbidden)
    monkeypatch.setattr(mod, f"_single_loop_{family}_plain", forbidden)
    ut, f = (torch.from_numpy(a[:2]).to("meta") for a in data())
    with pytest.raises(ValueError, match="CUDA"):
        port(ut, f, x0, mesh=make_batch_mesh(devices=["meta"] * 2),
             **dict(kw, outer=1))
