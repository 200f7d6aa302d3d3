"""The port's fixed-step PCG bodies (bilevel/pcg.py) against the JAX
package's ``bilevel/pcg.py`` on the same float64 inputs: a random SPD
system, a warm start at the solution and an all-zero system (the
zero-denominator guards), per-group inner products, and the γ-smoothed
adjoint system of the single-loop learner.

Inputs are made with numpy from a seed.  Tolerance: 1e-12 relative (the
same operations in the same order; only the summation order of a dot
product may differ).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bpldenoising_tpu.bilevel import pcg as jpcg
from bpldenoising_tpu.models import sumregs_model as j_sumregs
from bpldenoising_tpu.solvers.hypergrad import \
    build_reg_system as j_build_reg_system
from bpldenoising_tpu_torch.bilevel import pcg as tpcg
from bpldenoising_tpu_torch.bilevel.first_order import _tile_vdot
from bpldenoising_tpu_torch.models import sumregs_model
from bpldenoising_tpu_torch.solvers.hypergrad import build_reg_system

RTOL = 1e-12
VARIANTS = ("classic", "pipelined")


def spd_system(seed, n=24):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n, n))
    A = A @ A.T + n * np.eye(n)
    b = rng.standard_normal(n)
    inv_diag = 1.0 / np.diag(A)
    return A, b, inv_diag


def both(variant, A, b, inv_diag, p0, n_adj):
    """The same solve in both packages → (port, jax) as numpy."""
    Aj, At = jnp.asarray(A), torch.as_tensor(A)
    pj = jpcg.CG_VARIANTS[variant](lambda v: Aj @ v, jnp.asarray(inv_diag),
                                   jnp.asarray(b), jnp.asarray(p0), n_adj)
    pt = tpcg.CG_VARIANTS[variant](lambda v: At @ v,
                                   torch.as_tensor(inv_diag),
                                   torch.as_tensor(b), torch.as_tensor(p0),
                                   n_adj)
    return pt.numpy(), np.asarray(pj)


@pytest.mark.parametrize("n_adj", [1, 3, 10])
@pytest.mark.parametrize("variant", VARIANTS)
def test_matches_jax_on_spd_system(variant, n_adj):
    A, b, inv_diag = spd_system(0)
    p0 = np.random.default_rng(1).standard_normal(b.shape)
    pt, pj = both(variant, A, b, inv_diag, p0, n_adj)
    np.testing.assert_allclose(pt, pj, rtol=RTOL, atol=1e-14)


@pytest.mark.parametrize("variant", VARIANTS)
def test_warm_start_at_the_solution_stays_finite(variant):
    """Residual ~0 from the first step: the guards keep every division
    finite, as in the JAX package."""
    A, b, inv_diag = spd_system(2)
    x_star = np.linalg.solve(A, b)
    pt, pj = both(variant, A, b, inv_diag, x_star, 5)
    assert np.isfinite(pt).all()
    np.testing.assert_allclose(pt, pj, rtol=RTOL, atol=1e-14)
    np.testing.assert_allclose(pt, x_star, rtol=1e-8)


@pytest.mark.parametrize("variant", VARIANTS)
def test_zero_system_takes_the_guards(variant):
    """b = 0 from p = 0 (a zero image): every inner product is 0, each
    denominator is replaced by 1, and the iterate stays exactly 0."""
    A, _, inv_diag = spd_system(3)
    zero = np.zeros(A.shape[0])
    pt, pj = both(variant, A, zero, inv_diag, zero, 4)
    assert np.array_equal(pt, pj) and not pt.any()


def _block_apply(blocks, v):
    """Image i of the stack v times its own matrix."""
    return torch.stack([a @ v[i].reshape(-1) for i, a in
                        enumerate(blocks)]).reshape(v.shape)


@pytest.mark.parametrize("variant", VARIANTS)
def test_per_group_inner_products_solve_each_group(variant):
    """With a block-diagonal operator over a (B, M, N) stack, inner
    products taken per group of images (TPU kernel 10's per-tile dots)
    give each group the iterate of its own CG; the last group is short."""
    rng = np.random.default_rng(4)
    B, n, tile = 5, 3, 2
    blocks = [torch.as_tensor(spd_system(10 + i, n * n)[0])
              for i in range(B)]
    b = torch.as_tensor(rng.standard_normal((B, n, n)))
    inv_diag = torch.stack([1.0 / torch.diag(a) for a in blocks]).reshape(
        B, n, n)
    cg = tpcg.CG_VARIANTS[variant]
    got = cg(lambda v: _block_apply(blocks, v), inv_diag, b,
             torch.zeros_like(b), 6, vdot=_tile_vdot(tile))
    for g0 in range(0, B, tile):
        sl = slice(g0, min(g0 + tile, B))
        want = cg(lambda v: _block_apply(blocks[sl], v), inv_diag[sl],
                  b[sl], torch.zeros_like(b[sl]), 6)
        np.testing.assert_allclose(got[sl].numpy(), want.numpy(),
                                   rtol=1e-10, atol=1e-13)


@pytest.mark.parametrize("variant", VARIANTS)
def test_adjoint_system_solve_matches_jax(variant):
    """Both forms on the single-loop learner's γ-smoothed adjoint system
    (sum of regularizers, an (M, N) α map for one term), warm-started."""
    rng = np.random.default_rng(5)
    u = rng.standard_normal((2, 12, 12)) * 0.3
    ut = u + 0.05 * rng.standard_normal(u.shape)
    p0 = 0.1 * rng.standard_normal(u.shape)
    amap = 0.02 + 0.01 * rng.random((12, 12))
    alphas = (0.03, amap, 0.01)
    Mj, dj, _ = j_build_reg_system(jnp.asarray(u), tuple(
        jnp.asarray(a) for a in alphas), j_sumregs(), 1e4)
    Mt, dt, _ = build_reg_system(torch.as_tensor(u), tuple(
        torch.as_tensor(a, dtype=torch.float64) for a in alphas),
        sumregs_model(), 1e4)
    pj = jpcg.CG_VARIANTS[variant](Mj, dj, jnp.asarray(ut - u),
                                   jnp.asarray(p0), 4)
    pt = tpcg.CG_VARIANTS[variant](Mt, dt, torch.as_tensor(ut - u),
                                   torch.as_tensor(p0), 4)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=RTOL,
                               atol=1e-14)
