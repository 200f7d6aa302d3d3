"""The TV and sum-of-regularizers single loop with ``mesh=`` (its plain
version on meshes of CPU shards) against the JAX package's
``single_loop_learn(..., mesh=)`` on its virtual CPU devices
(tests/conftest.py), in float64.

Inputs: ``tests/test_parallel.py::small_ds`` (a disc under noise, 16²)
with 8, 5 (padded to 8) and 3 images (one shard all padding) over four
shards; ``test_first_order.py::test_segmented_mesh``'s form (3 images, 2
shards, ``log_every=6``).  Parameterizations: scalar TV, a 2×2 patch, the
(3,) sum and a (2, 2, 3) stack, each with the classic and the pipelined
CG.

Tolerances: 1e-9 relative on α, the cost trajectory and u against the
JAX mesh (the port-against-JAX tolerance of
``tests/test_torch_first_order.py``); 1e-10 against the port's own
unsharded run (the JAX package's mesh gate,
``tests/test_parallel.py:178-197``): the CG's inner products are summed
over the shards, so only the order of the sums separates the runs.  An
all-padding shard adds exactly +0 and segments hand the carry on, so
those runs equal the unsharded run and one segment bit for bit.  The
entry points with ``data_parallel=True`` and ``method="single_loop"`` (one
CPU shard) and the CLI's ``--data-parallel`` give the runs without it bit
for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from bpldenoising_tpu.bilevel import first_order as jfo
from bpldenoising_tpu.models import sumregs_model as j_sumregs
from bpldenoising_tpu.models import tv_model as j_tv
from bpldenoising_tpu_torch import experiments as tx
from bpldenoising_tpu_torch.bilevel import first_order as tfo
from bpldenoising_tpu_torch.bilevel import pcg
from bpldenoising_tpu_torch.models import sumregs_model, tv_model
from bpldenoising_tpu_torch.parallel import make_batch_mesh
from test_parallel import small_ds
from test_torch_fused import (one_torch_thread,  # noqa: F401 (autouse)
                              results_in_tmp)

RTOL_JAX = 1e-9
RTOL_SELF = 1e-10
KW = dict(outer=12, n_inner=8, n_adj=4, lr=0.05)

PARAMS = {
    # name: (JAX model, port model, x0)
    "tv-scalar": (j_tv, tv_model, np.array(0.05)),
    "tv-patch": (j_tv, tv_model, np.full((2, 2), 0.05)),
    "sumregs-vector": (j_sumregs, sumregs_model,
                       np.array([0.02, 0.015, 0.01])),
    "sumregs-patch": (j_sumregs, sumregs_model, np.full((2, 2, 3), 0.02)),
}
VARIANTS = ["classic", "pipelined"]


def _data(O, seed=0):
    ut, f = small_ds(np.random.default_rng(seed), O=O)
    return np.asarray(ut), np.asarray(f)


def _t(a):
    return torch.from_numpy(np.array(a))


def _cpu_mesh(n):
    return make_batch_mesh(devices=["cpu"] * n)


def _close(a, b, rtol, atol=0.0):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                               atol=atol)


def _compare(res, ref, rtol):
    _close(res.alpha, ref.alpha, rtol)
    _close(res.alpha_trajectory, ref.alpha_trajectory, rtol)
    _close(res.cost_trajectory, ref.cost_trajectory, rtol)
    _close(float(res.cost), float(ref.cost), rtol)
    assert tuple(res.u.shape) == tuple(np.shape(ref.u))
    _close(res.u, ref.u, rtol, atol=1e-12)


def _same(a, b):
    return all(torch.equal(x, y) for x, y in zip(a[:6], b[:6]))


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("name", list(PARAMS))
@pytest.mark.parametrize("O", [8, 5, 3], ids=["even", "padded",
                                              "padding-shard"])
def test_mesh_matches_jax_mesh(O, name, variant):
    jm, tm, x0 = PARAMS[name]
    ut, f = _data(O)
    jmesh = JMesh(np.array(jax.devices()[:4]), ("batch",))
    jres = jfo.single_loop_learn(jnp.asarray(ut), jnp.asarray(f), x0, jm(),
                                 mesh=jmesh, cg_variant=variant, **KW)
    res = tfo.single_loop_learn(_t(ut), _t(f), x0, tm(), mesh=_cpu_mesh(4),
                                cg_variant=variant, **KW)
    _compare(res, jres, RTOL_JAX)
    assert res.times is None


@pytest.mark.parametrize("variant", VARIANTS)
def test_segmented_mesh_matches_jax(variant):
    """``test_segmented_mesh``'s form: three images over two shards,
    ``log_every=6``, segment_callback at every hop."""
    ut, f = _data(3)
    kw = dict(outer=20, n_inner=8, n_adj=3, lr=0.05, cg_variant=variant)
    jmesh = JMesh(np.array(jax.devices()[:2]), ("batch",))
    jres = jfo.single_loop_learn(jnp.asarray(ut), jnp.asarray(f), 0.05,
                                 j_tv(), mesh=jmesh, log_every=6, **kw)
    hops = []
    res = tfo.single_loop_tv_learn(
        _t(ut), _t(f), 0.05, mesh=_cpu_mesh(2), log_every=6,
        segment_callback=lambda done, t: hops.append(done), **kw)
    _compare(res, jres, RTOL_JAX)
    assert hops == [6, 12, 18, 20]
    assert res.times.shape == (20,) and np.all(np.diff(res.times) >= 0)


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("name", list(PARAMS))
def test_mesh_matches_the_unsharded_run(name, variant):
    """Five images over four shards (three of padding in the last) and
    over two against the unsharded plain run."""
    _, tm, x0 = PARAMS[name]
    ut, f = (_t(a) for a in _data(5))
    ref = tfo.single_loop_learn(ut, f, x0, tm(), cg_variant=variant, **KW)
    for shards in (2, 4):
        res = tfo.single_loop_learn(ut, f, x0, tm(), cg_variant=variant,
                                    mesh=_cpu_mesh(shards), **KW)
        _compare(res, ref, RTOL_SELF)


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("name", list(PARAMS))
def test_padding_shard_adds_exactly_zero(name, variant):
    """One image over two shards: the second shard's dots, maps and cost
    are +0, so the run is the unsharded one bit for bit."""
    _, tm, x0 = PARAMS[name]
    ut, f = (_t(a[:1]) for a in _data(3))
    one = tfo.single_loop_learn(ut, f, x0, tm(), cg_variant=variant, **KW)
    two = tfo.single_loop_learn(ut, f, x0, tm(), cg_variant=variant,
                                mesh=_cpu_mesh(2), **KW)
    assert _same(one, two)


@pytest.mark.parametrize("variant", VARIANTS)
def test_segments_equal_one_segment(variant):
    """Segments of 4 over two shards hand each shard's carry on: the run
    of one segment bit for bit (the times aside)."""
    ut, f = (_t(a) for a in _data(5))
    kw = dict(KW, outer=9, cg_variant=variant)
    whole = tfo.single_loop_sumregs_learn(ut, f, [0.02, 0.015, 0.01],
                                          mesh=_cpu_mesh(2), **kw)
    seg = tfo.single_loop_sumregs_learn(ut, f, [0.02, 0.015, 0.01],
                                        mesh=_cpu_mesh(2), log_every=4, **kw)
    assert _same(whole, seg) and seg.times.shape == (9,)


@pytest.mark.parametrize("variant", VARIANTS)
def test_sum_points_of_a_step(variant):
    """A plain step stops at every inner product of its CG (2·n_adj + 1
    classic, n_adj pipelined, one or two dots each) and then at the K maps
    and the cost, as the JAX scan takes its psums."""
    ut, f = (_t(a) for a in _data(2))
    model = sumregs_model()
    x0 = torch.tensor([0.02, 0.015, 0.01], dtype=torch.float64)
    carry = tfo._init_carry(f, x0, K=3, param_shape=(3,))
    st = tfo._tv_plain_stepper(
        ut, f, carry, model=model, outer=1, n_inner=2, n_adj=4, pop=None,
        param_shape=(3,), lr=0.05, gamma=1e4, tau0=5.0, sigma0=0.2,
        beta1=0.9, beta2=0.999, eps=1e-8, cg_variant=variant)
    gen = st.step(0)
    sizes = []
    out = next(gen)
    try:
        while True:
            sizes.append(len(out))
            out = gen.send(out)
    except StopIteration:
        pass
    cg = [1] * 9 if variant == "classic" else [2] * 4
    assert sizes == cg + [4]
    assert len(st.xs) == 1 and len(st.costs) == 1


@pytest.mark.parametrize("variant", VARIANTS)
def test_cg_generator_is_the_cg(variant):
    """The generator form answered with its own dots is the CG bit for bit
    (one copy of the arithmetic)."""
    rng = np.random.default_rng(3)
    A = rng.standard_normal((12, 12))
    A = torch.from_numpy(A @ A.T + 12 * np.eye(12))
    inv = 1.0 / torch.diagonal(A)
    b = torch.from_numpy(rng.standard_normal(12))
    p0 = torch.zeros(12, dtype=torch.float64)
    ref = pcg.CG_VARIANTS[variant](lambda v: A @ v, inv, b, p0, 5)
    got = pcg.local_sums(pcg.CG_STEPS[variant](lambda v: A @ v, inv, b, p0,
                                               5))
    assert torch.equal(ref, got)


ENTRIES = ["scalar_bilevel_tv_learn", "patch_bilevel_tv_learn",
           "scalar_bilevel_sumregs_learn", "patch_bilevel_sumregs_learn"]


@pytest.mark.parametrize("entry", ENTRIES)
def test_entry_point_data_parallel_single_loop(entry):
    """data_parallel=True with method="single_loop" runs over one CPU
    shard (device="cpu"): the run without it, bit for bit."""
    kw = dict(dataset_name="circle", num_samples=2, method="single_loop",
              sl_outer=3, sl_inner=5, sl_adj=2, save_results=False,
              device="cpu")
    one = getattr(tx, entry)(**kw)
    dp = getattr(tx, entry)(data_parallel=True, **kw)
    assert np.array_equal(one.x, dp.x) and np.array_equal(one.u, dp.u)
    assert one.cost == dp.cost
    assert ([(e.function_value, e.g_norm) for e in one.state.log]
            == [(e.function_value, e.g_norm) for e in dp.state.log])


@pytest.mark.parametrize("entry", ["scalar_bilevel_tv_learn",
                                   "scalar_bilevel_sumregs_learn"])
def test_entry_point_on_a_mesh_of_cpu_shards(entry, monkeypatch):
    """The entry point on api.data_parallel_mesh swapped for two CPU
    shards: the unsharded entry point within 1e-10."""
    kw = dict(dataset_name="circle", num_samples=3, method="single_loop",
              sl_outer=4, sl_inner=5, sl_adj=3, save_results=False,
              device="cpu")
    one = getattr(tx, entry)(**kw)
    monkeypatch.setattr(tx.api, "data_parallel_mesh",
                        lambda device: _cpu_mesh(2))
    dp = getattr(tx, entry)(data_parallel=True, **kw)
    _close(dp.x, one.x, RTOL_SELF)
    _close(dp.u, one.u, RTOL_SELF, atol=1e-12)
    assert dp.u.shape == one.u.shape


@pytest.mark.parametrize("sub", ["scalar-tv", "scalar-sumregs"])
def test_cli_data_parallel_single_loop(sub, capsys):
    """--data-parallel with --method single_loop in the TV and
    sum-of-regularizers subcommands (one CPU shard) prints the lines of
    the run without it."""
    from bpldenoising_tpu_torch.__main__ import main
    run = [sub, "--dataset", "circle", "--method", "single_loop",
           "--sl-outer", "2", "--sl-inner", "3", "--sl-adj", "2",
           "--device", "cpu"]
    main(run)
    plain = capsys.readouterr().out
    main(run + ["--data-parallel"])
    assert capsys.readouterr().out == plain and "iterations = 2" in plain


@pytest.mark.parametrize("variant", VARIANTS)
def test_mesh_off_the_cpu_never_runs_the_plain_stepper(variant,
                                                       monkeypatch):
    """A mesh whose shards are not on the CPU (here: meta tensors) goes to
    the CUDA learner's session in its mesh form, which raises; the plain
    stepper and loop never run."""
    def forbidden(*a, **k):
        raise AssertionError("the plain learner ran")
    monkeypatch.setattr(tfo, "_tv_plain_stepper", forbidden)
    monkeypatch.setattr(tfo, "_single_loop_plain", forbidden)
    ut, f = (_t(a).to("meta") for a in _data(2))
    with pytest.raises(ValueError, match="CUDA"):
        tfo.single_loop_tv_learn(ut, f, 0.05, cg_variant=variant,
                                 mesh=make_batch_mesh(devices=["meta"] * 2),
                                 **dict(KW, outer=1))


def test_optimizer_still_raises():
    ut, f = (_t(a) for a in _data(2))
    with pytest.raises(NotImplementedError, match="optax"):
        tfo.single_loop_tv_learn(ut, f, 0.05, mesh=_cpu_mesh(2),
                                 optimizer=object())
