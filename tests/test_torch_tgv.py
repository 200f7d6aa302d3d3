"""The port's TGV² pieces against the JAX package on the same float64
inputs: the symmetrized gradient and its adjoint, the patch operator, the
joint-primal Chambolle–Pock solver (plain version of ``csrc/tgv.cu``)
cold, warm and early-stopped with scalar and map weights, the Pallas
kernel's own numbers in interpret mode, and the implicit cotangents.

Tolerances: operators 1e-12 absolute; solver 1e-10 relative (the same
float64 iteration; rounding differences of ~1e-15 per step do not grow,
the measured gap is ~2e-15).  The implicit cotangents are held to 1e-10
relative at γ = 1e-2, where the smoothed joint system is well conditioned
and CG converges in under 100 iterations.  At the default γ = 1e-4 the
system is ill conditioned: the JAX package itself moves its cotangents by
~2e-8 relative under a 1e-13 relative perturbation of u, so that case is
held to 1e-6 relative, with CG counts within 2%.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bpldenoising_tpu.ops import PatchOp as JPatchOp
from bpldenoising_tpu.ops.tgv import sym_div as j_sym_div
from bpldenoising_tpu.ops.tgv import sym_grad as j_sym_grad
from bpldenoising_tpu.solvers import tgv as jt
from bpldenoising_tpu.solvers.tgv_pallas import tgv_denoise_pdps_pallas
from bpldenoising_tpu_torch.ops import (PatchOp, SymGradientOp,
                                        TGV_OPNORM_SQ, sym_div, sym_grad)
from bpldenoising_tpu_torch.ops.grad import FwdGradientOp
from bpldenoising_tpu_torch.solvers import tgv as tt
from bpldenoising_tpu_torch.solvers import tgv_cuda
from bpldenoising_tpu_torch.weights import from_jax_state

SOLVER_RTOL = 1e-10
KW = dict(tau0=0.99, sigma0=0.99)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float64))


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))


@pytest.fixture
def data(rng):
    """Two 20×24 images: a ramp with a step, and a ramp with a disc."""
    yy, xx = np.meshgrid(np.arange(20), np.arange(24), indexing="ij")
    clean = np.stack([0.02 * xx + (yy > 10),
                      0.03 * yy + ((xx - 12) ** 2 + (yy - 10) ** 2 < 30)]
                     ).astype(np.float64)
    return clean, clean + 0.1 * rng.standard_normal(clean.shape)


def _alpha_map(rng):
    return 0.05 + 0.1 * rng.random((20, 24))


# --- operators --------------------------------------------------------------

@pytest.mark.parametrize("lead", [(), (2,), (2, 3)])
def test_sym_grad_and_div_match_jax(rng, lead):
    w = rng.standard_normal(lead + (2, 20, 24))
    z = rng.standard_normal(lead + (3, 20, 24))
    np.testing.assert_allclose(sym_grad(_t(w)).numpy(),
                               np.asarray(j_sym_grad(jnp.asarray(w))),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(sym_div(_t(z)).numpy(),
                               np.asarray(j_sym_div(jnp.asarray(z))),
                               rtol=0, atol=1e-12)


def test_sym_grad_adjoint_identity(rng):
    w = _t(rng.standard_normal((2, 2, 9, 11)))
    z = _t(rng.standard_normal((2, 3, 9, 11)))
    op = SymGradientOp()
    lhs = torch.sum(op.apply(w) * z)
    rhs = torch.sum(w * op.apply_adjoint(z))
    assert abs(float(lhs - rhs)) <= 1e-12 * float(torch.abs(lhs))
    dense = op.as_matrix((2, 4, 5))
    dense_T = op.T.as_matrix((3, 4, 5))
    np.testing.assert_allclose(dense.T.numpy(), dense_T.numpy(), atol=1e-15)


def test_sym_grad_frobenius_weighting():
    """|E w|² = E_rr² + E_cc² + 2 E_rc² for w = (x_c, 0) (E_rc = ½)."""
    yy, xx = np.meshgrid(np.arange(6), np.arange(7), indexing="ij")
    w = _t(np.stack([xx, np.zeros_like(xx)]).astype(np.float64))
    e = sym_grad(w)
    np.testing.assert_allclose(e[2, 1:, 1:].numpy(), 1 / np.sqrt(2))
    assert float(e[0].abs().max()) == 0.0


def test_joint_operator_norm_bound(rng):
    """‖(u, w) ↦ (∇u − w, E w)‖² ≤ TGV_OPNORM_SQ by the power method."""
    grad = FwdGradientOp()
    x = _t(rng.standard_normal((3, 12, 12)))
    for _ in range(200):
        x = x / torch.linalg.norm(x)
        u, w = x[0], x[1:]
        y = grad.apply(u) - w
        z = sym_grad(w)
        x = torch.cat([grad.apply_adjoint(y)[None], -y + sym_div(z)])
    est = float(torch.linalg.norm(x))
    assert 10.0 < est <= TGV_OPNORM_SQ


@pytest.mark.parametrize("grid,lead", [((2, 2), ()), ((4, 3), (2,)),
                                       ((1, 6), (2, 2))])
def test_patch_op_matches_jax(rng, grid, lead):
    M, N = 20, 24
    x = rng.standard_normal(lead + grid)
    g = rng.standard_normal(lead + (M, N))
    top, jop = PatchOp(grid, (M, N)), JPatchOp(grid, (M, N))
    np.testing.assert_allclose(top.apply(_t(x)).numpy(),
                               np.asarray(jop.apply(jnp.asarray(x))),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(top.apply_adjoint(_t(g)).numpy(),
                               np.asarray(jop.apply_adjoint(jnp.asarray(g))),
                               rtol=0, atol=1e-12)
    lhs = torch.sum(top.apply(_t(x)) * _t(g))
    rhs = torch.sum(_t(x) * top.apply_adjoint(_t(g)))
    assert abs(float(lhs - rhs)) <= 1e-12 * max(1.0, abs(float(lhs)))
    assert PatchOp.for_image(_t(x), _t(g)) == top
    assert float(top.opnorm_estimate()) == pytest.approx(
        float(jop.opnorm_estimate()))


def test_patch_op_rejects_indivisible_grid():
    with pytest.raises(ValueError):
        PatchOp((3, 5), (20, 24))


# --- solver -----------------------------------------------------------------

def _solve_both(f, a1, a0, state0=None, **kw):
    jout = jt._tgv_impl(jnp.asarray(f),
                        jnp.asarray(a1), jnp.asarray(a0),
                        None if state0 is None else tuple(
                            jnp.asarray(s) for s in state0),
                        return_state=True, **KW, **kw)
    tout = tt._tgv_impl(_t(f), _t(a1), _t(a0),
                        from_jax_state(state0, device="cpu"),
                        return_state=True, **KW, **kw)
    return jout, tout


def _check_state(jout, tout):
    ju, jw, jst, jit = jout
    tu, tw, tst, tit = tout
    assert tit == int(jit)
    assert _rel(tu.numpy(), ju) <= SOLVER_RTOL
    assert _rel(tw.numpy(), jw) <= SOLVER_RTOL
    for name, j, t in zip("uwpq", jst, tst):
        assert tuple(t.shape) == tuple(j.shape), name
        assert _rel(t.numpy(), j) <= SOLVER_RTOL, name


@pytest.mark.parametrize("weights", ["scalar", "map"])
def test_cold_fixed_budget_matches_jax(data, rng, weights):
    _, f = data
    a1 = 0.1 if weights == "scalar" else _alpha_map(rng)
    jout, tout = _solve_both(f, a1, 0.2, maxiter=300, tol=None,
                             check_every=50)
    _check_state(jout, tout)


@pytest.mark.parametrize("weights", ["scalar", "map"])
def test_early_stop_matches_jax(data, rng, weights):
    _, f = data
    a0 = 0.2 if weights == "scalar" else 2.0 * _alpha_map(rng)
    jout, tout = _solve_both(f, 0.1, a0, maxiter=2000, tol=1e-4,
                             check_every=50)
    assert 50 < tout[3] < 2000, tout[3]
    _check_state(jout, tout)


def test_warm_start_from_jax_state_matches_jax(data):
    """A JAX state carried over by from_jax_state continues identically,
    at nudged weights, with the early stop."""
    _, f = data
    _, _, jst, _ = jt._tgv_impl(jnp.asarray(f), 0.1, 0.2, maxiter=200,
                                tol=None, check_every=50,
                                return_state=True, **KW)
    jout, tout = _solve_both(f, 0.11, 0.19, state0=jst, maxiter=1000,
                             tol=1e-4, check_every=50)
    assert 50 < tout[3] < 1000
    _check_state(jout, tout)


def test_matches_pallas_kernel_in_interpret_mode(data, rng):
    """The TPU kernel's own numbers (interpret mode, fixed budget) for
    scalar and map weights."""
    _, f = data
    for a1 in (0.1, _alpha_map(rng)):
        ju, jw, jst = tgv_denoise_pdps_pallas(
            jnp.asarray(f), jnp.asarray(a1), 0.2, maxiter=150,
            return_state=True, interpret=True)
        tu, tw, tst, _ = tt.tgv_denoise_pdps(_t(f), _t(a1), 0.2,
                                             maxiter=150, return_state=True)
        assert _rel(tu.numpy(), ju) <= SOLVER_RTOL
        assert _rel(tw.numpy(), jw) <= SOLVER_RTOL
        for j, t in zip(jst, tst):
            assert _rel(t.numpy(), j) <= SOLVER_RTOL


def test_public_solver_dispatch_and_squeeze(data):
    """tgv_denoise_pdps runs where f lives: a single CPU image comes back
    unbatched; a device that is neither CPU nor CUDA raises."""
    _, f = data
    u2, w2, st2, it2 = tt.tgv_denoise_pdps(_t(f[0]), 0.1, 0.2, maxiter=60,
                                           return_state=True)
    u3, w3 = tt.tgv_denoise_pdps(_t(f[:1]), 0.1, 0.2, maxiter=60)
    assert u2.shape == (20, 24) and w2.shape == (2, 20, 24)
    assert [tuple(s.shape) for s in st2] == [(20, 24), (2, 20, 24),
                                             (2, 20, 24), (3, 20, 24)]
    assert it2 == 60
    assert torch.equal(u2, u3[0]) and torch.equal(w2, w3[0])
    with pytest.raises(ValueError):
        tt.tgv_denoise_pdps(torch.zeros((4, 4), device="meta"), 0.1, 0.2)
    with pytest.raises(ValueError):
        tt.tgv_denoise_pdps(_t(f), np.ones((3, 3)), 0.2, maxiter=5)
    assert tgv_cuda.launches == 0


def test_energy_matches_jax(data, rng):
    _, f = data
    u, w = tt.tgv_denoise_pdps(_t(f), 0.1, 0.2, maxiter=100)
    for a1 in (0.1, _alpha_map(rng)):
        got = tt.tgv_energy(_t(f), u, w, _t(a1), 0.2)
        want = jt.tgv_energy(jnp.asarray(f), jnp.asarray(u.numpy()),
                             jnp.asarray(w.numpy()), jnp.asarray(a1), 0.2)
        assert _rel(got.numpy(), want) <= 1e-12


# --- implicit cotangents ----------------------------------------------------

def _cotangents_both(data, a1, lam0=None, gamma=1e-2):
    clean, f = data
    ju, jw, _ = jt._tgv_impl(jnp.asarray(f), jnp.asarray(a1), 0.2,
                             maxiter=400, tol=None, check_every=50,
                             return_state=False, **KW)
    v = np.asarray(ju) - clean
    kw = dict(gamma=gamma, return_lam=True, return_info=True)
    jr = jt.tgv_implicit_cotangents(
        ju, jw, (jnp.asarray(a1), 0.2), jnp.asarray(v),
        lam0=None if lam0 is None else jnp.asarray(lam0), **kw)
    tr = tt.tgv_implicit_cotangents(
        _t(ju), _t(jw), (_t(a1), 0.2), _t(v),
        lam0=None if lam0 is None else _t(lam0), **kw)
    return jr, tr


@pytest.mark.parametrize("weights", ["scalar", "map"])
@pytest.mark.parametrize("start", ["cold", "lam0"])
def test_implicit_cotangents_match_jax(data, rng, weights, start):
    a1 = 0.1 if weights == "scalar" else _alpha_map(rng)
    lam0 = None
    if start == "lam0":
        # a nearby multiplier: the cold solution at 1.1·α₁
        jr0, _ = _cotangents_both(data, 1.1 * np.asarray(a1))
        lam0 = np.asarray(jr0[2])
    jr, tr = _cotangents_both(data, a1, lam0)
    (jdf, (jg1, jg0), jlam, jinfo) = jr
    (tdf, (tg1, tg0), tlam, tinfo) = tr
    assert bool(np.all(jinfo.converged)) and bool(torch.all(tinfo.converged))
    assert abs(tinfo.iters - int(jinfo.iters)) <= 1
    assert tuple(tg1.shape) == tuple(np.shape(jg1)) == np.shape(a1)
    for got, want in ((tdf, jdf), (tg1, jg1), (tg0, jg0), (tlam, jlam)):
        assert _rel(got.numpy(), want) <= 1e-10


def test_implicit_cotangents_default_gamma(data):
    """γ = 1e-4, the learn's setting: an ill-conditioned system (see the
    module docstring for the tolerance)."""
    jr, tr = _cotangents_both(data, 0.1, gamma=1e-4)
    jit, tit = int(jr[3].iters), tr[3].iters
    assert abs(tit - jit) <= 2 + 0.02 * jit
    for got, want in ((tr[1][0], jr[1][0]), (tr[1][1], jr[1][1]),
                      (tr[2], jr[2])):
        assert _rel(got.numpy(), want) <= 1e-6


def test_from_jax_state_carries_tgv_state_and_multiplier(data):
    _, f = data
    _, _, jst, _ = jt._tgv_impl(jnp.asarray(f), 0.1, 0.2, maxiter=20,
                                tol=None, check_every=50,
                                return_state=True, **KW)
    lam = jnp.asarray(np.random.default_rng(1).standard_normal(
        (2, 3, 20, 24)))
    (tst, tlam) = from_jax_state((jst, lam), device="cpu")
    assert isinstance(tst, tuple) and len(tst) == 4
    for j, t in zip(jst, tst):
        assert np.array_equal(t.numpy(), np.asarray(j))
    assert np.array_equal(tlam.numpy(), np.asarray(lam))
    # the carried state warm-starts the port's solver
    u, _ = tt.tgv_denoise_pdps(_t(f), 0.1, 0.2, maxiter=1, state0=tst)
    assert u.shape == (2, 20, 24)
