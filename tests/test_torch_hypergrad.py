"""The port's Krylov solvers and hypergradients (plain version of kernel B)
against the JAX package on the same float64 inputs.

Tolerances: gradients and adjoints to 1e-9 relative; residual norms to
1e-6 relative where CG stopped at its cap (a converged residual is
rounding-level and only its convergence flag is compared).  Both packages run the same float64 CG; the test image is piecewise
constant with a ramp, so every pixel gradient is either exactly zero or
well above the active-set threshold and the systems are well conditioned:
rounding stays at rounding and the iteration counts are equal.  The
regularized form's default γ = 1e8 makes its system ill-conditioned: CG
then amplifies rounding over its iterations, and that case has its own
looser tolerance (1e-6 relative, CG iterations within 2%).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bpldenoising_tpu.models import sumregs_model as j_sumregs
from bpldenoising_tpu.models import tv_model as j_tv
from bpldenoising_tpu.solvers import hypergrad as jhg
from bpldenoising_tpu.solvers import krylov as jkr
from bpldenoising_tpu_torch.models import sumregs_model, tv_model
from bpldenoising_tpu_torch.solvers import hypergrad as thg
from bpldenoising_tpu_torch.solvers import hypergrad_cuda
from bpldenoising_tpu_torch.solvers import krylov as tkr
from bpldenoising_tpu_torch.solvers.pdps import denoise_pdps

RTOL = 1e-9


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float64))


def _close(got, want, rtol=RTOL):
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    scale = max(np.abs(want).max(), 1e-300)
    assert np.abs(got - want).max() <= rtol * scale, (
        np.abs(got - want).max() / scale)


@pytest.fixture(scope="module")
def problem():
    """(ū, u): u is piecewise constant on 4×3 blocks plus a ramp."""
    rng = np.random.default_rng(3)
    u = np.kron(rng.random((2, 4, 6)), np.ones((4, 3)))
    u[:, 12:, :] += 0.3 * np.linspace(0.0, 1.0, 18)
    clean = u + 0.05 * rng.standard_normal(u.shape)
    return clean, None, u


def _same_residual(tinfo, jinfo):
    assert bool(tinfo.converged) == bool(jinfo.converged)
    if not bool(jinfo.converged):
        _close(tinfo.resnorm, jinfo.resnorm, rtol=1e-6)


def _spd(rng, n):
    A = rng.standard_normal((n, n))
    return A @ A.T + n * np.eye(n)


@pytest.mark.parametrize("precond", [False, True])
def test_cg_matches_jax(precond, rng):
    A = _spd(rng, 12)
    b = rng.standard_normal(12)
    d = 1.0 / np.diag(A)
    jM = (lambda r: jnp.asarray(d) * r) if precond else None
    tM = (lambda r: _t(d) * r) if precond else None
    jx, jinfo = jkr.cg(lambda x: jnp.asarray(A) @ x, jnp.asarray(b),
                       tol=1e-10, maxiter=50, M=jM)
    tx, tinfo = tkr.cg(lambda x: _t(A) @ x, _t(b), tol=1e-10, maxiter=50,
                       M=tM)
    _close(tx, jx)
    assert tinfo.iters == int(jinfo.iters)
    _same_residual(tinfo, jinfo)


def test_cg_capped_and_warm_start(rng):
    A = _spd(rng, 20)
    b = rng.standard_normal(20)
    x0 = rng.standard_normal(20)
    jx, jinfo = jkr.cg(lambda x: jnp.asarray(A) @ x, jnp.asarray(b),
                       x0=jnp.asarray(x0), tol=1e-14, maxiter=3)
    tx, tinfo = tkr.cg(lambda x: _t(A) @ x, _t(b), x0=_t(x0), tol=1e-14,
                       maxiter=3)
    _close(tx, jx)
    assert tinfo.iters == 3 == int(jinfo.iters)
    assert not bool(tinfo.converged) and not bool(jinfo.converged)


@pytest.mark.parametrize("maxiter", [400, 3], ids=["converged", "capped"])
def test_bicgstab_matches_jax(maxiter, rng):
    """tests/test_utils.py::test_bicgstab_nonsymmetric's system (a 40×40
    nonsymmetric matrix + 40·I), converged and capped at 3 iterations."""
    n = 40
    A = rng.standard_normal((n, n)) + n * np.eye(n)
    b = rng.standard_normal(n)
    jx, jinfo = jkr.bicgstab(lambda v: jnp.asarray(A) @ v, jnp.asarray(b),
                             tol=1e-10, maxiter=maxiter)
    tx, tinfo = tkr.bicgstab(lambda v: _t(A) @ v, _t(b), tol=1e-10,
                             maxiter=maxiter)
    _close(tx, jx, rtol=1e-12)
    assert tinfo.iters == int(jinfo.iters)
    assert bool(tinfo.converged) == bool(jinfo.converged) == (maxiter > 3)
    _close(tinfo.resnorm, jinfo.resnorm, rtol=1e-6)
    if maxiter > 3:
        assert float(np.linalg.norm(A @ tx.numpy() - b)) <= 1e-8 * float(
            np.linalg.norm(b))


def test_cg_batched_matches_jax(rng):
    A = np.stack([_spd(rng, 8), 3.0 * _spd(rng, 8)])
    b = rng.standard_normal((2, 8))

    def jA(x):
        return jnp.einsum("bij,bj->bi", jnp.asarray(A), x)

    def tA(x):
        return torch.einsum("bij,bj->bi", _t(A), x)

    jx, jinfo = jkr.cg_batched(jA, jnp.asarray(b), tol=1e-10, maxiter=40,
                               item_ndim=1)
    tx, tinfo = tkr.cg_batched(tA, _t(b), tol=1e-10, maxiter=40,
                               item_ndim=1)
    _close(tx, jx)
    assert tinfo.iters == int(jinfo.iters)
    assert torch.equal(tinfo.converged,
                       torch.from_numpy(np.array(jinfo.converged)))


CFGS = {
    "default": jhg.HypergradConfig(),
    "flagship": jhg.HypergradConfig(al_iters=2, cg_maxiter=100),
    "capped": jhg.HypergradConfig(al_iters=3, cg_maxiter=7),
}


def _tcfg(cfg):
    return thg.HypergradConfig(**cfg._asdict())


def _for_form(cfg, form):
    """The regularized form at a well-conditioned γ (see the docstring)."""
    return cfg._replace(gamma=1e4) if form == "reg" else cfg


@pytest.mark.parametrize("form", ["exact", "reg"])
@pytest.mark.parametrize("cfg", list(CFGS))
@pytest.mark.parametrize("warm", [False, True])
def test_hypergrad_matches_jax(problem, form, cfg, warm):
    clean, _, u = problem
    jcfg = _for_form(CFGS[cfg], form)
    rng = np.random.default_rng(11)
    p0 = 0.01 * rng.standard_normal(u.shape) if warm else None
    jfn = getattr(jhg, f"{form}_hypergrad")
    tfn = getattr(thg, f"{form}_hypergrad")
    jg, jp, jinfo = jfn(jnp.asarray(u), jnp.asarray(clean),
                        (jnp.asarray(0.08),), j_tv(), jcfg,
                        p0=None if p0 is None else jnp.asarray(p0))
    tg, tp, tinfo = tfn(_t(u), _t(clean), (_t(0.08),), tv_model(),
                        _tcfg(jcfg), p0=None if p0 is None else _t(p0))
    _close(tg[0], jg[0])
    _close(tp, jp)
    assert tinfo.iters == int(jinfo.iters)
    _same_residual(tinfo, jinfo)


@pytest.mark.parametrize("form", ["exact", "reg"])
def test_hypergrad_maps_and_sumregs_match_jax(problem, form):
    """Per-pixel gradient maps, α maps and the K=3 model."""
    clean, _, u = problem
    rng = np.random.default_rng(5)
    amap = 0.05 + 0.05 * rng.random(u.shape[-2:])
    jfn = getattr(jhg, f"{form}_hypergrad")
    tfn = getattr(thg, f"{form}_hypergrad")
    cfg = _for_form(CFGS["flagship"], form)
    jg, jp, _ = jfn(jnp.asarray(u), jnp.asarray(clean),
                    (jnp.asarray(amap),), j_tv(), cfg, want_maps=True)
    tg, tp, _ = tfn(_t(u), _t(clean), (_t(amap),), tv_model(), _tcfg(cfg),
                    want_maps=True)
    _close(tg[0], jg[0])
    _close(tp, jp)
    a3 = (0.03, 0.02, 0.01)
    jg, jp, _ = jfn(jnp.asarray(u), jnp.asarray(clean),
                    tuple(jnp.asarray(a) for a in a3), j_sumregs(), cfg)
    tg, tp, _ = tfn(_t(u), _t(clean), tuple(_t(a) for a in a3),
                    sumregs_model(), _tcfg(cfg))
    for a, b in zip(tg, jg):
        _close(a, b)
    _close(tp, jp)


def test_reg_default_gamma_matches_jax(problem):
    clean, _, u = problem
    cfg = jhg.HypergradConfig()
    jg, jp, jinfo = jhg.reg_hypergrad(jnp.asarray(u), jnp.asarray(clean),
                                      (jnp.asarray(0.08),), j_tv(), cfg)
    tg, tp, tinfo = thg.reg_hypergrad(_t(u), _t(clean), (_t(0.08),),
                                      tv_model(), _tcfg(cfg))
    _close(tg[0], jg[0], rtol=1e-6)
    _close(tp, jp, rtol=1e-6)
    assert abs(tinfo.iters - int(jinfo.iters)) <= 0.02 * int(jinfo.iters)
    assert bool(tinfo.converged) and bool(jinfo.converged)


def test_build_reg_system_matches_jax(problem, rng):
    _, _, u = problem
    jM, jdiag, jfields = jhg.build_reg_system(
        jnp.asarray(u), (jnp.asarray(0.08),), j_tv(), 1e4)
    tM, tdiag, tfields = thg.build_reg_system(
        _t(u), (_t(0.08),), tv_model(), 1e4)
    v = rng.standard_normal(u.shape)
    _close(tM(_t(v)), jM(jnp.asarray(v)))
    _close(tdiag, jdiag)
    _close(tfields[0], jfields[0])


def test_defaults_follow_dtype():
    cfg = thg.HypergradConfig()
    assert thg._defaults(torch.float64, cfg) == jhg._defaults(jnp.float64,
                                                              jhg.HypergradConfig())
    assert thg._defaults(torch.float32, cfg) == jhg._defaults(jnp.float32,
                                                              jhg.HypergradConfig())
    assert thg._defaults(torch.float32, cfg._replace(mu=7.0))[1] == 7.0


def test_exact_hypergrad_matches_finite_difference():
    """dJ/dα of J(α) = ½‖u(α) − ū‖² against a central difference of
    converged solves."""
    rng = np.random.default_rng(1)
    clean = np.zeros((1, 12, 12))
    clean[0, 3:9, 3:9] = 1.0
    f = _t(clean + 0.1 * rng.standard_normal(clean.shape))
    ut = _t(clean)
    model = tv_model()

    def solve(a):
        return denoise_pdps(f, a, model, maxiter=5000)

    a, h = 0.1, 1e-5
    u = solve(a)
    (g,), _, info = thg.exact_hypergrad(u, ut, (_t(a),), model)
    J = [0.5 * float(torch.sum((solve(a + s * h) - ut) ** 2))
         for s in (1, -1)]
    fd = (J[0] - J[1]) / (2 * h)
    assert bool(info.converged)
    # the JAX package's own finite-difference tolerance (test_hypergrad.py)
    np.testing.assert_allclose(float(g), fd, rtol=2e-3)


def test_cuda_wrappers_run_plain_version_on_cpu(problem):
    clean, _, u = problem
    before = hypergrad_cuda.launches
    cfg = thg.HypergradConfig(al_iters=2, cg_maxiter=50)
    for kern, plain in ((hypergrad_cuda.exact_hypergrad_cuda,
                         thg.exact_hypergrad),
                        (hypergrad_cuda.reg_hypergrad_cuda,
                         thg.reg_hypergrad)):
        kg, kp, ki = kern(_t(u), _t(clean), (_t(0.08),), tv_model(), cfg)
        pg, pp, pi = plain(_t(u), _t(clean), (_t(0.08),), tv_model(), cfg)
        assert torch.equal(kg[0], pg[0]) and torch.equal(kp, pp)
        assert ki.iters == pi.iters
    assert hypergrad_cuda.launches == before
