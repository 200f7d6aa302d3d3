"""The port's parallel tier (``bpldenoising_tpu_torch/parallel/``) against
the JAX package's own mesh functions on the CPU in float64.

The JAX side runs on the eight virtual CPU devices of tests/conftest.py,
the port's on ``make_batch_mesh(devices=["cpu"] * 8)``: the same number of
shards, so both split the batch alike and each shard solves the same
sub-problem.  Inputs are made with numpy from seeds: the 16×16 discs of
tests/test_parallel.py (eight images, or five, which pad to eight with
three all-padding shards), the same discs under salt-and-pepper noise
(TV-L1) and 16×16 color stacks (VTV).

Tolerances, port against JAX on the same shard count: u 1e-10 absolute,
the cost 1e-12 relative, the gradient 1e-8 relative (the shards run the
same arithmetic; only the order of the shard sums differs from XLA's
psum, and every adjoint CG converges to 1e-10 on a well-conditioned
system: a CG stopped at its cap turns rounding into 1e-6 even unsharded).
Port-sharded against port-unsharded: the JAX test's ``GRAD_RTOL = 2e-4``,
for its reason (per-shard against joint Krylov spaces,
tests/test_parallel.py:21-28).  The fused learners and the entry points:
tests/test_torch_parallel_learns.py.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bpldenoising_tpu import parallel as jpar
from bpldenoising_tpu.solvers.hypergrad import HypergradConfig as JCfg
from bpldenoising_tpu_torch import parallel as par
from bpldenoising_tpu_torch.experiments import api as tapi
from bpldenoising_tpu_torch.learning import tv_learning_function
from bpldenoising_tpu_torch.solvers.hypergrad import HypergradConfig
from test_torch_fused import (one_torch_thread,  # noqa: F401 (autouse)
                              results_in_tmp)

# a well-conditioned adjoint (act_tol 1e-3, γ = 1e3 for the regularized
# branch), so every CG converges to 1e-10 in a few hundred iterations
CFG = dict(act_tol=1e-3, gamma=1e3, al_iters=2, cg_tol=1e-10,
           cg_maxiter=1000)
INNER = 100
TR = dict(eta1=0.25, eta2=0.75, beta1=0.25, beta2=1.9, delta0=0.1,
          tol=1e-5)
GRAD_RTOL = 2e-4


def small_ds(O=8, n=16, seed=0, sigma=0.1):
    rng = np.random.default_rng(seed)
    x, y = np.meshgrid(np.arange(n), np.arange(n))
    clean = ((x - n / 2) ** 2 + (y - n / 2) ** 2 < (n / 3) ** 2).astype(float)
    true_ = np.stack([clean] * O) + 0.01 * rng.standard_normal((O, n, n))
    return true_, true_ + sigma * rng.standard_normal((O, n, n))


def impulse_ds(O=8, n=16, seed=2, density=0.2):
    """Discs under salt-and-pepper noise (the TV-L1 family's data)."""
    clean, _ = small_ds(O=O, n=n, seed=seed)
    rng = np.random.default_rng(seed)
    hit = rng.random(clean.shape) < density
    salt = rng.random(clean.shape) < 0.5
    return clean, np.where(hit, salt.astype(float), clean)


def color_ds(O=8, n=16, seed=1, sigma=0.1):
    rng = np.random.default_rng(seed)
    clean = np.clip(rng.random((O, 3, n, n)), 0.0, 1.0)
    return clean, clean + sigma * rng.standard_normal((O, 3, n, n))


@pytest.fixture(scope="module")
def meshes():
    assert len(jax.devices()) >= 8, "conftest must fake 8 CPU devices"
    return par.make_batch_mesh(devices=["cpu"] * 8), jpar.make_batch_mesh(8)


def jds(ds):
    return tuple(jnp.asarray(d) for d in ds)


def rel(a, b):
    a, b = np.asarray(a, float), np.asarray(b, float)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def check_eval(port, ref, *, u_atol=1e-10, cost_rtol=1e-12, grad_rtol=1e-8):
    (u, c, g), (ju, jc, jg) = port, ref
    assert tuple(u.shape) == tuple(np.shape(ju))
    np.testing.assert_allclose(u.numpy(), np.asarray(ju), atol=u_atol,
                               rtol=0)
    np.testing.assert_allclose(float(c), float(jc), rtol=cost_rtol)
    assert rel(torch.as_tensor(g).cpu().numpy(), jg) <= grad_rtol


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("O", [8, 10])
def test_pad_batch_matches_jax(O):
    a = np.random.default_rng(O).standard_normal((O, 4, 4))
    p, w = par.pad_batch(torch.as_tensor(a), 8)
    jp, jw = jpar.pad_batch(jnp.asarray(a), 8)
    np.testing.assert_array_equal(p.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(w.numpy(), np.asarray(jw))
    assert p.shape[0] == -(-O // 8) * 8 and float(w.sum()) == O


def test_mesh_layout_and_refusals():
    """Meshes name JAX's axes; the default mesh takes the cards and raises
    without one (no silent CPU mesh); shards land on their devices."""
    mesh = par.make_batch_mesh(devices=["cpu"] * 4)
    assert mesh.shape == {par.BATCH_AXIS: 4} and mesh.size == 4
    two = par.make_batch_rows_mesh(2, 2, ["cpu"] * 4)
    assert two.shape == {"batch": 2, "rows": 2}
    with pytest.raises(ValueError, match="need 6"):
        par.make_batch_rows_mesh(2, 3, ["cpu"] * 4)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            par.make_batch_mesh()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tapi.data_parallel_mesh("cuda")
    parts = par.shard_batch(torch.arange(8.0), mesh)
    assert [p.tolist() for p in parts] == [[0, 1], [2, 3], [4, 5], [6, 7]]
    with pytest.raises(ValueError, match="not divisible"):
        par.shard_batch(torch.arange(6.0), mesh)
    assert sorted(par.__all__) == sorted(jpar.__all__)


# ---------------------------------------------------------------------------
# the five sharded learning functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["scalar", "uneven", "patch", "reg"])
def test_sharded_tv_matches_jax(meshes, case):
    mesh, jmesh = meshes
    ds = small_ds(O=5 if case == "uneven" else 8)
    x = 0.1 * np.ones((2, 2)) if case == "patch" else 0.1
    delta = 1e-9 if case == "reg" else 0.1
    lf = par.make_sharded_tv_learning_function(
        mesh, maxiter=INNER, cfg=HypergradConfig(**CFG))
    jlf = jpar.make_sharded_tv_learning_function(jmesh, maxiter=INNER,
                                                 cfg=JCfg(**CFG))
    check_eval(lf(x, ds, delta), jlf(jnp.asarray(x), jds(ds), delta))
    assert lf.last_adjoint_cg["iters"] > 0


@pytest.mark.parametrize("case", ["vector", "patch"])
def test_sharded_sumregs_matches_jax(meshes, case):
    mesh, jmesh = meshes
    ds = small_ds(O=5)
    x = (np.array([0.05, 0.03, 0.02]) if case == "vector"
         else np.full((2, 2, 3), 0.03))
    lf = par.make_sharded_sumregs_learning_function(
        mesh, maxiter=INNER, cfg=HypergradConfig(**CFG))
    jlf = jpar.make_sharded_sumregs_learning_function(jmesh, maxiter=INNER,
                                                      cfg=JCfg(**CFG))
    check_eval(lf(x, ds, 0.1), jlf(jnp.asarray(x), jds(ds), 0.1))


def test_sharded_tv_warm_start_threads_across_calls(meshes):
    """Each shard's adjoint warm-starts the next call of its branch, as in
    the JAX factory: the repeated call takes fewer CG iterations, and four
    calls (repeat, nearby α, the regularized branch) track the JAX
    factory's four."""
    mesh, jmesh = meshes
    ds = small_ds(O=5)
    lf = par.make_sharded_tv_learning_function(
        mesh, maxiter=INNER, cfg=HypergradConfig(**CFG))
    jlf = jpar.make_sharded_tv_learning_function(jmesh, maxiter=INNER,
                                                 cfg=JCfg(**CFG))
    jd = jds(ds)
    for x, delta in ((0.1, 0.1), (0.1, 0.1), (0.11, 0.1), (0.11, 1e-9)):
        check_eval(lf(x, ds, delta), jlf(jnp.asarray(x), jd, delta))
    assert lf.adjoint_cg.n_solves == 4
    # with the CG capped short, a warm repeat moves off the cold call
    capped = HypergradConfig(**dict(CFG, cg_maxiter=20))
    warm = par.make_sharded_tv_learning_function(mesh, maxiter=INNER,
                                                 cfg=capped)
    cold = warm(0.1, ds, 0.1)[2]
    assert not torch.equal(warm(0.1, ds, 0.1)[2], cold)
    assert torch.equal(par.make_sharded_tv_learning_function(
        mesh, maxiter=INNER, cfg=capped)(0.1, ds, 0.1)[2], cold)


def test_sharded_tv_against_unsharded(meshes):
    """Port sharded against port unsharded: u and the cost to rounding,
    the gradient to GRAD_RTOL (per-shard against joint CG)."""
    mesh, _ = meshes
    ds = small_ds(O=5)
    cfg = HypergradConfig(**dict(CFG, cg_tol=1e-12))
    u, c, g = par.make_sharded_tv_learning_function(
        mesh, maxiter=INNER, cfg=cfg)(0.1, ds, 0.1)
    ur, cr, gr = tv_learning_function(0.1, ds, 0.1, maxiter=INNER, cfg=cfg,
                                      device="cpu")
    np.testing.assert_allclose(u.numpy(), ur.numpy(), atol=1e-12)
    np.testing.assert_allclose(float(c), float(cr), rtol=1e-12)
    np.testing.assert_allclose(float(g), float(gr), rtol=GRAD_RTOL)


def test_all_padding_shard_adds_exactly_zero():
    """Three images over four shards (one all padding) give the bits of
    three images over three shards: the padding shard solves to u = 0 and
    adds +0 to the cost and the gradient."""
    ds = small_ds(O=3)
    out = {}
    for n in (3, 4):
        mesh = par.make_batch_mesh(devices=["cpu"] * n)
        out[n] = par.make_sharded_tv_learning_function(
            mesh, maxiter=INNER, cfg=HypergradConfig(**CFG))(0.1, ds, 0.1)
    for a, b in zip(out[3], out[4]):
        assert torch.equal(a, b)


def test_run_shards_threads_per_distinct_device(meshes):
    """``cpu`` and ``cpu:0`` are distinct devices, so this mesh runs two
    host threads, each taking its shards in order with the caller's grad
    mode; a sharded evaluation gives the single-group bits, and the first
    failing shard's exception (in shard order) is the one raised."""
    mesh, _ = meshes
    two = par.make_batch_mesh(devices=["cpu", "cpu:0"] * 4)
    devs = par.mesh.batch_devices(two)
    assert len(set(devs)) == 2
    seen = []

    def probe(i, a):
        seen.append((i, threading.current_thread()))
        return a, torch.is_grad_enabled()

    for grad in (True, False):
        with torch.set_grad_enabled(grad):
            out = par.mesh.run_shards(devs, probe, list(range(8)))
        assert out == [(i, grad) for i in range(8)]
    threads = {}
    for i, thread in seen[:8]:
        threads.setdefault(thread, []).append(i)
    assert threading.main_thread() not in threads
    assert sorted(threads.values()) == [[0, 2, 4, 6], [1, 3, 5, 7]]

    def fail(i, a):
        if i in (1, 2):
            raise ValueError(f"shard {i}")
        return a

    with pytest.raises(ValueError, match="shard 1"):
        par.mesh.run_shards(devs, fail, list(range(8)))

    ds = small_ds(O=5)
    kw = dict(maxiter=INNER, cfg=HypergradConfig(**CFG))
    x = 0.1 * np.ones((2, 2))
    a = par.make_sharded_tv_learning_function(two, **kw)(x, ds, 0.1)
    b = par.make_sharded_tv_learning_function(mesh, **kw)(x, ds, 0.1)
    for s, t in zip(a, b):
        assert torch.equal(s.cpu(), t)


def test_sharded_tgv_matches_jax(meshes):
    mesh, jmesh = meshes
    ds = small_ds(O=5)
    x = np.array([0.1, 0.2])
    kw = dict(maxiter=60, cg_tol=1e-10, cg_maxiter=3000)
    check_eval(par.make_sharded_tgv_learning_function(mesh, **kw)(x, ds, 0.01),
               jpar.make_sharded_tgv_learning_function(jmesh, **kw)(
                   jnp.asarray(x), jds(ds), 0.01))


@pytest.mark.parametrize("O", [8, 5])
def test_sharded_vtv_matches_jax(meshes, O):
    mesh, jmesh = meshes
    ds = color_ds(O=O)
    kw = dict(maxiter=INNER, cg_tol=1e-10, cg_maxiter=3000)
    check_eval(par.make_sharded_vtv_learning_function(mesh, **kw)(
        np.asarray(0.1), ds, 0.01),
        jpar.make_sharded_vtv_learning_function(jmesh, **kw)(
            jnp.asarray(0.1), jds(ds), 0.01))


@pytest.mark.parametrize("x", [0.4, np.full((2, 2), 0.4)],
                         ids=["scalar", "patch"])
def test_sharded_tvl1_matches_jax(meshes, x):
    mesh, jmesh = meshes
    ds = impulse_ds(O=5)
    kw = dict(maxiter=INNER, cg_tol=1e-10, cg_maxiter=3000)
    check_eval(par.make_sharded_tvl1_learning_function(mesh, **kw)(
        np.asarray(x), ds, 0.1),
        jpar.make_sharded_tvl1_learning_function(jmesh, **kw)(
            jnp.asarray(x), jds(ds), 0.1))
