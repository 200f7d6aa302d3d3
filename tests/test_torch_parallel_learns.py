"""The port's fused learners with ``mesh=`` and ``data_parallel=True``
through the entry points and the CLI, against the JAX package's on the
CPU in float64 (the learning functions and the mesh itself:
tests/test_torch_parallel.py, whose data, settings and tolerances this
file shares).

The JAX side runs on the eight virtual CPU devices of tests/conftest.py,
the port's on ``make_batch_mesh(devices=["cpu"] * 8)``.  The learns (a
few trust-region steps): the weights 1e-8 relative, the cost 1e-10, u
1e-8 absolute; each shard decides its own early stop, as the JAX
``shard_map`` does.  Port mesh against port unsharded: the JAX test's
``GRAD_RTOL = 2e-4``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bpldenoising_tpu import parallel as jpar
from bpldenoising_tpu.bilevel.fused import bilevel_learn_fused as j_fused
from bpldenoising_tpu.bilevel.fused_tgv import \
    bilevel_learn_tgv_fused as j_fused_tgv
from bpldenoising_tpu.bilevel.fused_tvl1 import \
    bilevel_learn_tvl1_fused as j_fused_tvl1
from bpldenoising_tpu.bilevel.fused_vtv import \
    bilevel_learn_vtv_fused as j_fused_vtv
from bpldenoising_tpu.experiments import api as japi
from bpldenoising_tpu.solvers.hypergrad import HypergradConfig as JCfg
from bpldenoising_tpu.utils.config import Params as JParams
from bpldenoising_tpu_torch import parallel as par
from bpldenoising_tpu_torch.__main__ import main
from bpldenoising_tpu_torch.bilevel.first_order import single_loop_learn
from bpldenoising_tpu_torch.bilevel.fused import bilevel_learn_fused
from bpldenoising_tpu_torch.bilevel.fused_tgv import bilevel_learn_tgv_fused
from bpldenoising_tpu_torch.bilevel.fused_tvl1 import \
    bilevel_learn_tvl1_fused
from bpldenoising_tpu_torch.bilevel.fused_vtv import bilevel_learn_vtv_fused
from bpldenoising_tpu_torch.experiments import api as tapi
from bpldenoising_tpu_torch.models import sumregs_model, tv_model
from bpldenoising_tpu_torch.solvers.hypergrad import HypergradConfig
from bpldenoising_tpu_torch.utils.config import Params
from test_torch_fused import (one_torch_thread,  # noqa: F401 (autouse)
                              results_in_tmp)
from test_torch_parallel import (CFG, GRAD_RTOL, INNER, TR, color_ds,
                                 impulse_ds, jds, meshes,  # noqa: F401
                                 small_ds)


# ---------------------------------------------------------------------------
# the four fused learners with mesh=
# ---------------------------------------------------------------------------

def check_learn(res, jres):
    assert res.iterations == int(jres.iterations)
    assert tuple(res.u.shape) == tuple(jres.u.shape)
    np.testing.assert_allclose(res.x.numpy(), np.asarray(jres.x), rtol=1e-8)
    np.testing.assert_allclose(float(res.cost), float(jres.cost),
                               rtol=1e-10)
    np.testing.assert_allclose(res.u.cpu().numpy(), np.asarray(jres.u),
                               atol=1e-8)


@pytest.mark.parametrize("O, inner_tol", [(8, None), (5, 1e-8)],
                         ids=["even", "uneven_early_stop"])
def test_fused_tv_mesh_matches_jax(meshes, O, inner_tol):
    mesh, jmesh = meshes
    ds = small_ds(O=O)
    kw = dict(xinit=0.1, inner_maxiter=INNER, inner_tol=inner_tol,
              check_every=40)
    res = bilevel_learn_fused(ds, params=Params(TR, maxiter=3), mesh=mesh,
                              cfg=HypergradConfig(**CFG), device="cpu", **kw)
    jres = j_fused(jds(ds), params=JParams(TR, maxiter=3), mesh=jmesh,
                   cfg=JCfg(**CFG), backend="jnp", **kw)
    check_learn(res, jres)


def test_fused_sumregs_patch_mesh_matches_jax(meshes):
    mesh, jmesh = meshes
    ds = small_ds(O=5)
    x0 = np.full((2, 2, 3), 0.03)
    kw = dict(inner_maxiter=INNER, inner_tol=None, delta_t=1e-3)
    res = bilevel_learn_fused(ds, xinit=x0, params=Params(TR, maxiter=1),
                              model=sumregs_model(), mesh=mesh,
                              cfg=HypergradConfig(**CFG), device="cpu", **kw)
    from bpldenoising_tpu.models import sumregs_model as j_sumregs
    jres = j_fused(jds(ds), xinit=jnp.asarray(x0),
                   params=JParams(TR, maxiter=1), model=j_sumregs(),
                   mesh=jmesh, cfg=JCfg(**CFG), backend="jnp", **kw)
    check_learn(res, jres)


@pytest.mark.parametrize("family, O", [("tgv", 5), ("tvl1", 8),
                                       ("tvl1", 5), ("vtv", 8), ("vtv", 5)])
def test_fused_smoothed_mesh_matches_jax(meshes, family, O):
    mesh, jmesh = meshes
    learn, jlearn, x0, ds = {
        "tgv": (bilevel_learn_tgv_fused, j_fused_tgv, np.array([0.1, 0.2]),
                small_ds(O=O)),
        "tvl1": (bilevel_learn_tvl1_fused, j_fused_tvl1, np.asarray(0.4),
                 impulse_ds(O=O)),
        "vtv": (bilevel_learn_vtv_fused, j_fused_vtv, np.asarray(0.1),
                color_ds(O=O)),
    }[family]
    kw = dict(inner_maxiter=60 if family == "tgv" else INNER, inner_tol=None,
              cg_tol=1e-10, cg_maxiter=3000)
    res = learn(ds, xinit=x0, params=Params(TR, maxiter=2), mesh=mesh,
                device="cpu", **kw)
    jres = jlearn(jds(ds), xinit=jnp.asarray(x0),
                  params=JParams(TR, maxiter=2), mesh=jmesh, backend="jnp",
                  **kw)
    check_learn(res, jres)


def test_fused_mesh_against_unsharded(meshes):
    """Port mesh against port single device: the psum'd cost and gradient
    make the replicated trust region the same, the per-shard CGs differ
    within the stall floor."""
    mesh, _ = meshes
    ds = small_ds(O=8)
    cfg = HypergradConfig(**dict(CFG, cg_tol=1e-12))
    kw = dict(xinit=0.1, params=Params(TR, maxiter=2), inner_maxiter=INNER,
              inner_tol=None, cfg=cfg, device="cpu")
    ref = bilevel_learn_fused(ds, **kw)
    dp = bilevel_learn_fused(ds, mesh=mesh, **kw)
    np.testing.assert_allclose(float(dp.x), float(ref.x), rtol=GRAD_RTOL)
    np.testing.assert_allclose(float(dp.cost), float(ref.cost), rtol=1e-6)
    assert dp.iterations == ref.iterations


# ---------------------------------------------------------------------------
# data_parallel=True through the entry points and the CLI; the refusals
# ---------------------------------------------------------------------------

@pytest.fixture
def small_dataset(monkeypatch):
    """Both packages' entry points load five 16×16 discs in place of the
    named dataset and solve the adjoint at CFG (the port through its
    ``hypergrad_cfg``, the JAX package's sharded factory and fused learner
    with that ``cfg`` bound): the default adjoint settings would take
    minutes on the CPU.  The port's data-parallel mesh is eight CPU
    shards, the JAX package's its eight virtual devices."""
    import functools

    import bpldenoising_tpu.bilevel.fused as jfused_mod
    data = small_ds(O=5)

    def load(name, color=False):
        return data

    monkeypatch.setattr(tapi, "testdataset", load)
    monkeypatch.setattr(japi, "testdataset", load)
    monkeypatch.setattr(tapi, "data_parallel_mesh",
                        lambda device: par.make_batch_mesh(
                            devices=["cpu"] * 8))
    monkeypatch.setattr(jpar, "make_sharded_tv_learning_function",
                        functools.partial(
                            jpar.make_sharded_tv_learning_function,
                            cfg=JCfg(**CFG)))
    monkeypatch.setattr(jfused_mod, "bilevel_learn_fused",
                        functools.partial(jfused_mod.bilevel_learn_fused,
                                          cfg=JCfg(**CFG)))


@pytest.mark.parametrize("method", ["tr", "tr_fused"])
def test_entry_point_data_parallel_matches_jax(small_dataset, method):
    kw = dict(dataset_name="circle", num_samples=5, inner_maxiter=INNER,
              maxiter=2, method=method, data_parallel=True)
    res = tapi.scalar_bilevel_tv_learn(
        device="cpu", hypergrad_cfg=HypergradConfig(**CFG), **kw)
    jres = japi.scalar_bilevel_tv_learn(save_results=False, backend="jnp",
                                        **kw)
    assert res.iterations == jres.iterations
    np.testing.assert_allclose(res.x, np.asarray(jres.x), rtol=1e-8)
    np.testing.assert_allclose(res.cost, jres.cost, rtol=1e-10)
    np.testing.assert_allclose(res.u, np.asarray(jres.u), atol=1e-8)
    with pytest.raises(ValueError, match="inner_tol"):
        tapi.scalar_bilevel_tv_learn(device="cpu",
                                     **dict(kw, method="tr", inner_tol=1e-6))


def test_cli_data_parallel_runs_and_single_loop_refuses(capsys):
    """--data-parallel runs (one CPU shard: the unsharded learn's numbers,
    as the plain run prints them), with --method single_loop too (rows
    9–10's mesh; it refused before ROADMAP.md item 10b was done)."""
    run = ["scalar-tv", "--dataset", "circle", "--maxiter", "1",
           "--inner-maxiter", "10", "--device", "cpu"]
    main(run + ["--data-parallel"])
    dp = capsys.readouterr().out
    main(run)
    assert capsys.readouterr().out == dp and "iterations = 1" in dp
    sl = run + ["--method", "single_loop", "--sl-outer", "2", "--sl-inner",
                "3", "--sl-adj", "2"]
    main(sl + ["--data-parallel"])
    dp = capsys.readouterr().out
    main(sl)
    assert capsys.readouterr().out == dp and "iterations = 2" in dp


def test_single_loop_mesh_and_log_every_refuse(meshes):
    """The TV single loop runs on the eight-shard mesh (two images, six
    shards of padding: the unsharded run within 1e-10) and through the
    entry point with data_parallel=True (one CPU shard: bit for bit);
    log_every with mesh= still raises in the fused learner."""
    mesh, _ = meshes
    ut, f = (torch.as_tensor(d) for d in small_ds(O=2))
    one = single_loop_learn(ut, f, 0.05, tv_model(), outer=3)
    dp = single_loop_learn(ut, f, 0.05, tv_model(), outer=3, mesh=mesh)
    np.testing.assert_allclose(dp.alpha_trajectory.numpy(),
                               one.alpha_trajectory.numpy(), rtol=1e-10)
    np.testing.assert_allclose(dp.u.numpy(), one.u.numpy(), rtol=1e-10,
                               atol=1e-12)
    kw = dict(device="cpu", dataset_name="circle", num_samples=1,
              method="single_loop", sl_outer=2, save_results=False)
    a = tapi.scalar_bilevel_tv_learn(**kw)
    b = tapi.scalar_bilevel_tv_learn(data_parallel=True, **kw)
    assert np.array_equal(a.x, b.x) and np.array_equal(a.u, b.u)
    with pytest.raises(ValueError, match="log_every"):
        bilevel_learn_fused((ut, f), xinit=0.1, params=Params(TR, maxiter=1),
                            mesh=mesh, log_every=1, device="cpu")
