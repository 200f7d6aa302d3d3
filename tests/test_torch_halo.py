"""The port's row-sharded (halo-exchange) stencils and solvers
(``bpldenoising_tpu_torch/parallel/halo.py``) on the CPU in float64.

The stencils are held against the global ones of ``ops/grad.py`` (2 and 4
row blocks, 1e-12 absolute, and the adjoint identity); every row-sharded
and batch × rows solver against the JAX package's ``parallel/halo.py``
function on a mesh of the same shape (the JAX side on the virtual CPU
devices of tests/conftest.py, the port's on ``["cpu"] * n``), inputs made
with numpy from seeds, 1e-12 absolute: both run the same iteration in the
same order, so only rounding parts them.  Rows or a batch that do not
divide by the mesh raise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from bpldenoising_tpu.models import sumregs_model as j_sumregs
from bpldenoising_tpu.models import tv_model as j_tv
from bpldenoising_tpu.parallel import halo as jh
from bpldenoising_tpu.parallel import make_batch_rows_mesh as j_brmesh
from bpldenoising_tpu_torch.models import sumregs_model, tv_model
from bpldenoising_tpu_torch.ops import (BwdGradientOp, CenteredGradientOp,
                                        FwdGradientOp)
from bpldenoising_tpu_torch.parallel import halo
from bpldenoising_tpu_torch.parallel.mesh import (Mesh, ROWS_AXIS,
                                                  make_batch_rows_mesh)

ATOL = 1e-12
ITERS = 60


def rows_mesh(n):
    return Mesh(["cpu"] * n, (ROWS_AXIS,))


def j_rows_mesh(n):
    return JMesh(np.asarray(jax.devices()[:n]), (jh.ROWS_AXIS,))


def data(shape, seed=0, lo=None, hi=None):
    rng = np.random.default_rng(seed)
    if lo is None:
        return rng.standard_normal(shape)
    return rng.uniform(lo, hi, shape)


def close(port, ref):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=0)


OPS = [FwdGradientOp(), BwdGradientOp(), CenteredGradientOp()]


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("op", OPS, ids=lambda o: type(o).__name__)
def test_halo_stencils_match_global(op, n):
    """Row-sharded stencil and adjoint ≡ the global stencil on the whole
    image, batched blocks included."""
    u = torch.as_tensor(data((3, 32, 16), 1))
    p = torch.as_tensor(data((3, 32, 16), 2))
    fwd, adj = halo._ROW_STENCILS[type(op)]
    blocks = halo.Blocks(list(u.chunk(n, dim=-2)), n)
    got = torch.cat(list(fwd(blocks)), dim=-2)
    close(got, op.apply(u)[..., 0, :, :].numpy())
    pb = halo.Blocks(list(p.chunk(n, dim=-2)), n)
    got_adj = torch.cat(list(adj(pb)), dim=-2)
    lhs = float(torch.sum(got * p))
    rhs = float(torch.sum(u * got_adj))
    np.testing.assert_allclose(lhs, rhs, rtol=1e-12)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("kind", ["tv", "tv_map", "sumregs"])
def test_pdps_row_sharded_matches_jax(kind, n):
    f = data((32, 16), 3)
    if kind == "tv_map":
        alphas = (data((32, 16), 4, 0.01, 0.2),)
    else:
        alphas = (0.1,) if kind == "tv" else (0.05, 0.03, 0.02)
    pm, jm = ((sumregs_model(), j_sumregs()) if kind == "sumregs"
              else (tv_model(), j_tv()))
    ref = jh.denoise_pdps_row_sharded(jnp.asarray(f), tuple(
        jnp.asarray(a) for a in alphas), jm, j_rows_mesh(n), maxiter=ITERS)
    got = halo.denoise_pdps_row_sharded(
        torch.as_tensor(f),
        tuple(torch.as_tensor(np.asarray(a)) for a in alphas), pm,
        rows_mesh(n), maxiter=ITERS)
    close(got, ref)


def test_pdps_batch_row_sharded_matches_jax():
    f = data((4, 32, 16), 5)
    amap = 0.05 + 0.02 * data((32, 16), 6, 0.0, 1.0)
    alphas = (amap, 0.03, 0.01)
    ref = jh.denoise_pdps_batch_row_sharded(
        jnp.asarray(f), tuple(jnp.asarray(a) for a in alphas), j_sumregs(),
        j_brmesh(2, 2), maxiter=ITERS)
    got = halo.denoise_pdps_batch_row_sharded(
        torch.as_tensor(f),
        tuple(torch.as_tensor(np.asarray(a)) for a in alphas),
        sumregs_model(), make_batch_rows_mesh(2, 2, ["cpu"] * 4),
        maxiter=ITERS)
    close(got, ref)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("maps", [False, True], ids=["scalar", "map"])
def test_tgv_row_sharded_matches_jax(maps, n):
    f = data((32, 16), 7)
    a1, a0 = ((data((32, 16), 8, 0.05, 0.2), data((32, 16), 9, 0.05, 0.3))
              if maps else (0.1, 0.2))
    u_ref, w_ref = jh.tgv_denoise_pdps_row_sharded(
        jnp.asarray(f), jnp.asarray(a1), jnp.asarray(a0), j_rows_mesh(n),
        maxiter=ITERS)
    u, w = halo.tgv_denoise_pdps_row_sharded(
        torch.as_tensor(f), torch.as_tensor(np.asarray(a1)),
        torch.as_tensor(np.asarray(a0)),
        rows_mesh(n), maxiter=ITERS)
    close(u, u_ref)
    close(w, w_ref)


def test_tgv_batch_row_sharded_matches_jax():
    f = data((4, 32, 16), 10)
    u_ref, w_ref = jh.tgv_denoise_pdps_batch_row_sharded(
        jnp.asarray(f), 0.1, 0.2, j_brmesh(2, 2), maxiter=ITERS)
    u, w = halo.tgv_denoise_pdps_batch_row_sharded(
        torch.as_tensor(f), 0.1, 0.2,
        make_batch_rows_mesh(2, 2, ["cpu"] * 4), maxiter=ITERS)
    assert tuple(w.shape) == (4, 2, 32, 16)
    close(u, u_ref)
    close(w, w_ref)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("maps", [False, True], ids=["scalar", "map"])
def test_vtv_row_sharded_matches_jax(maps, n):
    f = data((3, 32, 16), 11)
    a = 0.05 + 0.1 * data((32, 16), 12, 0.0, 1.0) if maps else 0.1
    ref = jh.vtv_denoise_pdps_row_sharded(jnp.asarray(f), jnp.asarray(a),
                                          j_rows_mesh(n), maxiter=ITERS)
    got = halo.vtv_denoise_pdps_row_sharded(
        torch.as_tensor(f), torch.as_tensor(np.asarray(a)), rows_mesh(n),
        maxiter=ITERS)
    close(got, ref)


def test_vtv_batch_row_sharded_matches_jax():
    f = data((4, 3, 32, 16), 13)
    ref = jh.vtv_denoise_pdps_batch_row_sharded(
        jnp.asarray(f), 0.1, j_brmesh(2, 2), maxiter=ITERS)
    got = halo.vtv_denoise_pdps_batch_row_sharded(
        torch.as_tensor(f), 0.1, make_batch_rows_mesh(2, 2, ["cpu"] * 4),
        maxiter=ITERS)
    close(got, ref)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("maps", [False, True], ids=["scalar", "map"])
def test_tvl1_row_sharded_matches_jax(maps, n):
    f = data((32, 16), 14)
    a = 0.2 + 0.4 * data((32, 16), 15, 0.0, 1.0) if maps else 0.4
    ref = jh.tvl1_denoise_row_sharded(jnp.asarray(f), jnp.asarray(a),
                                      j_rows_mesh(n), maxiter=ITERS)
    got = halo.tvl1_denoise_row_sharded(
        torch.as_tensor(f), torch.as_tensor(np.asarray(a)), rows_mesh(n),
        maxiter=ITERS)
    close(got, ref)


def test_tvl1_batch_row_sharded_matches_jax():
    f = data((4, 32, 16), 16)
    ref = jh.tvl1_denoise_batch_row_sharded(
        jnp.asarray(f), 0.4, j_brmesh(2, 2), maxiter=ITERS)
    got = halo.tvl1_denoise_batch_row_sharded(
        torch.as_tensor(f), 0.4, make_batch_rows_mesh(2, 2, ["cpu"] * 4),
        maxiter=ITERS)
    close(got, ref)


@pytest.mark.parametrize("solver, shape", [
    (lambda f, m: halo.denoise_pdps_row_sharded(f, (0.1,), tv_model(), m),
     (30, 16)),
    (lambda f, m: halo.tgv_denoise_pdps_row_sharded(f, 0.1, 0.2, m),
     (30, 16)),
    (lambda f, m: halo.vtv_denoise_pdps_row_sharded(f, 0.1, m),
     (3, 30, 16)),
    (lambda f, m: halo.tvl1_denoise_row_sharded(f, 0.4, m), (30, 16)),
], ids=["tv", "tgv", "vtv", "tvl1"])
def test_indivisible_rows_raise(solver, shape):
    with pytest.raises(ValueError, match="rows 30"):
        solver(torch.zeros(shape, dtype=torch.float64), rows_mesh(4))


@pytest.mark.parametrize("solver, shape", [
    (lambda f, m: halo.denoise_pdps_batch_row_sharded(f, (0.1,), tv_model(),
                                                      m), (3, 32, 16)),
    (lambda f, m: halo.denoise_pdps_batch_row_sharded(f, (0.1,), tv_model(),
                                                      m), (2, 30, 16)),
    (lambda f, m: halo.tgv_denoise_pdps_batch_row_sharded(f, 0.1, 0.2, m),
     (3, 32, 16)),
    (lambda f, m: halo.vtv_denoise_pdps_batch_row_sharded(f, 0.1, m),
     (2, 3, 30, 16)),
    (lambda f, m: halo.tvl1_denoise_batch_row_sharded(f, 0.4, m),
     (2, 30, 16)),
], ids=["tv_batch", "tv_rows", "tgv_batch", "vtv_rows", "tvl1_rows"])
def test_indivisible_batch_rows_raise(solver, shape):
    with pytest.raises(ValueError, match="not divisible"):
        solver(torch.zeros(shape, dtype=torch.float64),
               make_batch_rows_mesh(2, 4, ["cpu"] * 8))
