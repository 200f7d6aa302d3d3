"""The port's operators and model (bpldenoising_tpu_torch.ops/models)
against the JAX package on the same float64 inputs.

Tolerance: 1e-12 absolute on values of order 1; both packages do the same
float64 arithmetic, so they agree to rounding.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bpldenoising_tpu import models as jmodels
from bpldenoising_tpu import ops as jops
from bpldenoising_tpu_torch import models as tmodels
from bpldenoising_tpu_torch import ops as tops
from bpldenoising_tpu_torch.ops import grad as tgrad
from bpldenoising_tpu.ops import grad as jgrad

ATOL = 1e-12
OPS = ["FwdGradientOp", "BwdGradientOp", "CenteredGradientOp"]


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.fixture
def img(rng):
    return rng.standard_normal((3, 7, 9))


@pytest.mark.parametrize("name", OPS)
def test_gradient_matches_jax(name, img, rng):
    jop, top = getattr(jops, name)(), getattr(tops, name)()
    np.testing.assert_allclose(top.apply(_t(img)).numpy(),
                               np.asarray(jop.apply(jnp.asarray(img))),
                               atol=ATOL)
    p = rng.standard_normal((3, 2, 7, 9))
    np.testing.assert_allclose(top.apply_adjoint(_t(p)).numpy(),
                               np.asarray(jop.apply_adjoint(jnp.asarray(p))),
                               atol=ATOL)
    w = rng.random((3, 2, 7, 9))
    np.testing.assert_allclose(top.gram_diag(_t(w)).numpy(),
                               np.asarray(jop.gram_diag(jnp.asarray(w))),
                               atol=ATOL)
    assert top.opnorm_bound() == jop.opnorm_bound()


@pytest.mark.parametrize("name", OPS)
def test_adjoint_identity(name, img, rng):
    """<Gu, p> = <u, Gᵀp>."""
    op = getattr(tops, name)()
    u = _t(img)
    p = _t(rng.standard_normal((3, 2, 7, 9)))
    lhs = torch.sum(op.apply(u) * p)
    rhs = torch.sum(u * op.apply_adjoint(p))
    assert abs(float(lhs - rhs)) < 1e-10
    assert torch.equal(op.T.apply(p), op.apply_adjoint(p))
    assert op.T.T is op


@pytest.mark.parametrize("name", OPS)
def test_gram_diag_matches_dense(name, rng):
    """gram_diag(w) is the diagonal of Gᵀ diag(w) G."""
    op = getattr(tops, name)()
    shape = (5, 6)
    G = op.as_matrix(shape)
    w = _t(rng.random((2,) + shape))
    dense = torch.diag(G.T @ torch.diag(w.reshape(-1)) @ G)
    np.testing.assert_allclose(op.gram_diag(w).reshape(-1).numpy(),
                               dense.numpy(), atol=ATOL)


@pytest.mark.parametrize("name", OPS)
def test_opnorm_estimate_below_bound(name):
    op = getattr(tops, name)()
    est = float(op.opnorm_estimate(torch.zeros((12, 12), dtype=torch.float64),
                                   iters=100))
    assert 0.5 * op.opnorm_bound() < est <= op.opnorm_bound() + 1e-9


@pytest.mark.parametrize("fn", ["dplus", "dplus_T", "dminus", "dminus_T",
                                "dcent", "dcent_T", "dplus_gram",
                                "dminus_gram", "dcent_gram"])
@pytest.mark.parametrize("axis", [-2, -1])
def test_stencils_match_jax(fn, axis, img):
    np.testing.assert_allclose(
        getattr(tgrad, fn)(_t(img), axis).numpy(),
        np.asarray(getattr(jgrad, fn)(jnp.asarray(img), axis)), atol=ATOL)


def test_field_ops_match_jax(rng):
    p = rng.standard_normal((2, 2, 5, 6))
    q = rng.standard_normal((2, 2, 5, 6))
    for fn in ("xi", "norm21"):
        np.testing.assert_allclose(getattr(tops, fn)(_t(p)).numpy(),
                                   np.asarray(getattr(jops, fn)(
                                       jnp.asarray(p))), atol=ATOL)
    np.testing.assert_allclose(
        tops.scalarprod(_t(p), _t(q)).numpy(),
        np.asarray(jops.scalarprod(jnp.asarray(p), jnp.asarray(q))),
        atol=ATOL)


@pytest.mark.parametrize("radius", ["scalar", "map", "zero"])
def test_proj_norm21_ball_matches_jax(radius, rng):
    p = rng.standard_normal((2, 2, 5, 6))
    r = {"scalar": 0.7, "map": rng.random((5, 6)), "zero": 0.0}[radius]
    got = tops.proj_norm21_ball(_t(p), _t(r) if radius == "map" else r)
    want = jops.proj_norm21_ball(jnp.asarray(p), jnp.asarray(r))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    assert torch.all(torch.isfinite(got))


def test_proj_coupled_axes_matches_jax(rng):
    p = rng.standard_normal((2, 3, 2, 5, 6))
    got = tops.proj_norm21_ball(_t(p), 0.5, axes=(-4, -3))
    want = jops.proj_norm21_ball(jnp.asarray(p), 0.5, axes=(-4, -3))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("family", ["tv_model", "sumregs_model"])
def test_model_energy_and_norm_match_jax(family, rng):
    jm, tm = getattr(jmodels, family)(), getattr(tmodels, family)()
    assert tm.K == jm.K and tm.opnorm_sq() == jm.opnorm_sq()
    u = rng.standard_normal((2, 6, 7))
    f = rng.standard_normal((2, 6, 7))
    alphas = 0.3 if tm.K == 1 else np.array([0.1, 0.2, 0.3])
    np.testing.assert_allclose(
        tm.energy(_t(u), _t(f), _t(np.asarray(alphas))).numpy(),
        np.asarray(jm.energy(jnp.asarray(u), jnp.asarray(f),
                             jnp.asarray(alphas))), atol=1e-10)


def test_energy_alpha_map_matches_jax(rng):
    u = rng.standard_normal((2, 6, 7))
    f = rng.standard_normal((2, 6, 7))
    amap = rng.random((6, 7))
    got = tmodels.tv_model().energy(_t(u), _t(f), _t(amap))
    want = jmodels.tv_model().energy(jnp.asarray(u), jnp.asarray(f),
                                     jnp.asarray(amap))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-10)


def test_canonical_alphas_forms():
    m = tmodels.sumregs_model()
    assert len(m.canonical_alphas(torch.tensor([1.0, 2.0, 3.0]))) == 3
    assert len(m.canonical_alphas((1.0, 2.0, 3.0))) == 3
    assert m.canonical_alphas(torch.ones(4, 4, 3))[0].shape == (4, 4)
    with pytest.raises(ValueError):
        m.canonical_alphas((1.0, 2.0))
    with pytest.raises(ValueError):
        m.canonical_alphas(torch.ones(5))


@pytest.mark.parametrize("name,norm", [("ZeroOp", 0.0), ("IdentityOp", 1.0)])
def test_zero_and_identity_ops_match_jax(name, norm, img, rng):
    """ZeroOp and IdentityOp: apply, adjoint and the operator-norm estimate
    (0 and 1) as the JAX package's."""
    jop, top = getattr(jops, name)(), getattr(tops, name)()
    p = rng.standard_normal((3, 2, 7, 9))
    for x in (img, p):
        np.testing.assert_allclose(top.apply(_t(x)).numpy(),
                                   np.asarray(jop.apply(jnp.asarray(x))),
                                   atol=ATOL)
        np.testing.assert_allclose(
            top.apply_adjoint(_t(x)).numpy(),
            np.asarray(jop.apply_adjoint(jnp.asarray(x))), atol=ATOL)
    est = top.opnorm_estimate(_t(img))
    assert float(est) == float(jop.opnorm_estimate(jnp.asarray(img))) == norm
    assert est.dtype == torch.float64


def test_pixel_outer_apply_matches_jax(rng):
    from bpldenoising_tpu.ops.field import pixel_outer_apply as jpoa
    from bpldenoising_tpu_torch.ops.field import pixel_outer_apply as tpoa
    g = rng.standard_normal((3, 2, 7, 9))
    v = rng.standard_normal((3, 2, 7, 9))
    inv = rng.random((3, 7, 9))
    np.testing.assert_allclose(
        tpoa(_t(g), _t(v), _t(inv)).numpy(),
        np.asarray(jpoa(jnp.asarray(g), jnp.asarray(v), jnp.asarray(inv))),
        atol=ATOL)
