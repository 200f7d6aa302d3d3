"""The port's host trust region (bilevel/trust_region.py, bilevel/harness.py,
solvers/lbfgs.py::LBFGSModel, utils/telemetry.py) against the JAX
package's, on the same float64 inputs.

Both are NumPy in float64 running the same operations in the same order,
so the pieces (bounds, step to the box, dogleg, the dense and L-BFGS
models, the logging cadence) agree to 1e-13 relative, and ``bilevel_learn``
on a quadratic and a boxed Rosenbrock closure logs the same iterations,
costs, gradient norms, radii and steps to 1e-12 relative.
"""

import warnings

import numpy as np
import pytest
import torch

from bpldenoising_tpu.bilevel import harness as jh
from bpldenoising_tpu.bilevel import trust_region as jtr
from bpldenoising_tpu.solvers.lbfgs import LBFGSModel as JLBFGSModel
from bpldenoising_tpu.utils import telemetry as jtel
from bpldenoising_tpu.utils.config import Params as JParams
from bpldenoising_tpu_torch.bilevel import harness as th
from bpldenoising_tpu_torch.bilevel import trust_region as ttr
from bpldenoising_tpu_torch.solvers.lbfgs import LBFGSModel
from bpldenoising_tpu_torch.solvers.krylov import KrylovInfo
from bpldenoising_tpu_torch.utils import telemetry as ttel
from bpldenoising_tpu_torch.utils.config import Params

RTOL = 1e-13


def _params(P, **kw):
    base = dict(eta1=0.25, eta2=0.75, beta1=0.25, beta2=1.9, delta0=0.1,
                maxiter=60, tol=1e-8, verbose_iter=1)
    base.update(kw)
    return P(**base)


@pytest.mark.parametrize("seed", range(4))
def test_bounds_and_step_to_bound_match_jax(seed):
    rng = np.random.default_rng(seed)
    x = rng.uniform(1e-3, 0.3, 5)
    delta = float(rng.uniform(0.01, 0.5))
    for a, b in zip(ttr.get_bounds(x, delta), jtr.get_bounds(x, delta)):
        np.testing.assert_array_equal(a, b)
    lb, ub = ttr.get_bounds(x, delta)
    for d in (rng.standard_normal(5), np.zeros(5),
              np.array([1.0, 0.0, -2.0, 0.0, 0.5])):
        assert ttr.step_to_bound(d, lb, ub) == jtr.step_to_bound(d, lb, ub)
        p = d * ttr.step_to_bound(d, lb, ub)
        assert ttr.in_bounds(p, lb - 1e-15, ub + 1e-15) \
            == jtr.in_bounds(p, lb - 1e-15, ub + 1e-15)
        p0 = 0.1 * (lb + ub)
        assert ttr._segment_to_bound(p0, d, lb, ub) \
            == jtr._segment_to_bound(p0, d, lb, ub)


def _curvature_pairs(rng, n, count):
    for _ in range(count):
        s = rng.standard_normal(n)
        yield s + 0.3 * rng.standard_normal(n), s


@pytest.mark.parametrize("n", [1, 3, 6])
def test_dense_model_and_dogleg_match_jax(n):
    """TRModel's updates, products, steps and predictions, and the dogleg
    in every one of its branches (Newton inside, Cauchy clipped, the
    segment), as the JAX package computes them."""
    rng = np.random.default_rng(n)
    tm, jm = ttr.TRModel(n, 0.1), jtr.TRModel(n, 0.1)
    for y, s in _curvature_pairs(rng, n, 5):
        tm.update(y, s)
        jm.update(y, s)
        np.testing.assert_allclose(tm.B, jm.B, rtol=RTOL, atol=0)
        g = rng.standard_normal(n)
        np.testing.assert_allclose(tm.newton_step(g), jm.newton_step(g),
                                   rtol=1e-12)
        np.testing.assert_allclose(tm.cauchy_step(g), jm.cauchy_step(g),
                                   rtol=RTOL)
        p = rng.standard_normal(n)
        assert tm.pred(p, g) == pytest.approx(jm.pred(p, g), rel=RTOL)
        x = rng.uniform(1e-3, 0.5, n)
        for delta in (1e-3, 0.05, 10.0):
            np.testing.assert_allclose(
                ttr.dogleg_box(x, g, tm, delta),
                jtr.dogleg_box(x, g, jm, delta), rtol=1e-12, atol=1e-16)
    # a pair without curvature is skipped by both
    s = rng.standard_normal(n)
    B = tm.B.copy()
    tm.update(-s, s)
    np.testing.assert_array_equal(tm.B, B)


def test_lbfgs_model_matches_jax():
    """LBFGSModel (the host L-BFGS above 64 parameters) against the JAX
    package's: the two-loop solve, the compact product, the Cauchy step and
    the prediction, through more pairs than its memory holds."""
    n, m = 12, 4
    rng = np.random.default_rng(7)
    tm, jm = LBFGSModel(n, memory=m), JLBFGSModel(n, memory=m)
    g = rng.standard_normal(n)
    np.testing.assert_allclose(tm.apply(g), jm.apply(g), rtol=RTOL)
    for y, s in _curvature_pairs(rng, n, 7):
        tm.update(y, s)
        jm.update(y, s)
        assert tm.gamma == jm.gamma and len(tm.S) == len(jm.S)
        g = rng.standard_normal(n)
        np.testing.assert_allclose(tm.solve(g), jm.solve(g), rtol=1e-12)
        np.testing.assert_allclose(tm.newton_step(g), jm.newton_step(g),
                                   rtol=1e-12)
        np.testing.assert_allclose(tm.apply(g), jm.apply(g), rtol=1e-12)
        np.testing.assert_allclose(tm.cauchy_step(g), jm.cauchy_step(g),
                                   rtol=1e-12)
        assert tm.pred(g, g) == pytest.approx(jm.pred(g, g), rel=1e-12)
    assert len(tm.S) == m
    x = rng.uniform(1e-3, 0.5, n)
    np.testing.assert_allclose(ttr.dogleg_box(x, g, tm, 0.05),
                               jtr.dogleg_box(x, g, jm, 0.05), rtol=1e-12)


@pytest.mark.parametrize("verbose_iter", [-1, 0, 1, 7, 50])
def test_should_log_matches_jax(verbose_iter):
    for it in range(1, 400):
        assert th._should_log(it, verbose_iter) == jh._should_log(
            it, verbose_iter)


def _quadratic(center, scale):
    def f_grad(x):
        d = x - center
        return 0.5 * float(np.sum(scale * d * d)), scale * d
    return f_grad


def _rosenbrock(x):
    a, b = x
    f = (1 - a) ** 2 + 100 * (b - a * a) ** 2
    g = np.array([-2 * (1 - a) - 400 * a * (b - a * a), 200 * (b - a * a)])
    return float(f), g


def _closure(f_grad, u):
    """An L4 closure whose cost and gradient are NumPy (the JAX loop's
    device read takes them as they are) and whose u is ``u``."""
    def lf(x, ds, delta):
        fx, gx = f_grad(np.asarray(x, dtype=np.float64))
        return u, fx, gx
    return lf


def _log_rows(res):
    return np.array([[e.iter, e.function_value, e.g_norm, e.delta,
                      e.step_norm] for e in res.state.log])


@pytest.mark.parametrize("case", ["quadratic", "rosenbrock", "lbfgs"])
def test_bilevel_learn_matches_jax_log(case):
    """bilevel_learn on closures gives the JAX package's log, result and
    iteration count; the torch closure returns tensors, whose cost and
    gradient come over in one read each evaluation."""
    if case == "quadratic":
        f_grad = _quadratic(np.array([0.3, 0.05, 0.8]),
                            np.array([1.0, 10.0, 0.5]))
        x0, kw = np.full(3, 0.1), dict(maxiter=40)
    elif case == "rosenbrock":   # boxed by positivity, from (0.2, 0.2)
        f_grad, x0, kw = _rosenbrock, np.array([0.2, 0.2]), dict(
            maxiter=80, delta0=0.5)
    else:   # 72 parameters: above lbfgs_threshold 64, the L-BFGS model
        rng = np.random.default_rng(3)
        f_grad = _quadratic(rng.uniform(0.05, 0.5, (8, 9)),
                            rng.uniform(0.5, 3.0, (8, 9)))
        x0, kw = np.full((8, 9), 0.1), dict(maxiter=30, lbfgs_memory=5)
    u = np.zeros((1, 2, 2))
    jres = jtr.bilevel_learn(None, _closure(f_grad, u), xinit=x0,
                             params=_params(JParams, **kw))

    def torch_lf(x, ds, delta):
        fx, gx = f_grad(np.asarray(x))
        return (torch.zeros((1, 2, 2)), torch.tensor(fx, dtype=torch.float64),
                torch.from_numpy(np.asarray(gx, dtype=np.float64)))

    reads = ttr.host_reads
    tres = ttr.bilevel_learn(None, torch_lf, xinit=x0,
                             params=_params(Params, **kw))
    assert tres.iterations == jres.iterations
    assert ttr.host_reads - reads == tres.iterations + 1
    np.testing.assert_allclose(_log_rows(tres), _log_rows(jres),
                               rtol=1e-12, atol=1e-300)
    np.testing.assert_allclose(tres.x, jres.x, rtol=1e-12)
    assert tres.cost == pytest.approx(jres.cost, rel=1e-12)
    assert tres.g_norm == pytest.approx(jres.g_norm, rel=1e-12, abs=1e-300)
    assert tres.x.shape == np.shape(x0) and np.all(tres.x > 0)
    assert isinstance(tres.u, torch.Tensor)


def test_bilevel_learn_resume_checkpoint_and_stop():
    """init_log continues the numbering and the budget, init_B seeds the
    dense model, checkpoint runs after each accepted iteration, the Δ < tol
    stop and save_iteration_fn: as in the JAX package."""
    f_grad = _quadratic(np.array([0.3, 0.05]), np.array([1.0, 10.0]))
    seeds = dict(init_B=np.eye(2) * 2.0)
    out = {}
    for name, tr, P, Entry in (("jax", jtr, JParams, jh.BilevelLogEntry),
                               ("torch", ttr, Params, th.BilevelLogEntry)):
        calls, images = [], []
        res = tr.bilevel_learn(
            None, _closure(f_grad, np.ones((1, 2, 2))),
            xinit=np.array([0.2, 0.2]),
            params=_params(P, maxiter=12, tol=1e-3),
            init_log=[Entry(3, 0.0, 1.0, 1.0, 0.1, 0.0)],
            checkpoint=lambda it, x, d, log, B=None, c=calls: c.append(
                (it, x.copy(), d, len(log))),
            save_iteration_fn=lambda it, img, im=images: im.append(it),
            **seeds)
        out[name] = (res, calls, images)
    (jres, jcalls, jimgs), (tres, tcalls, timgs) = out["jax"], out["torch"]
    assert [e.iter for e in tres.state.log] == [e.iter
                                                for e in jres.state.log]
    assert tres.state.log[0].iter == 3 and tres.state.log[1].iter == 4
    assert tres.iterations == jres.iterations <= 12
    np.testing.assert_allclose(_log_rows(tres), _log_rows(jres), rtol=1e-12)
    assert timgs == jimgs
    assert len(tcalls) == len(jcalls) > 0
    for a, b in zip(tcalls, jcalls):
        assert a[0] == b[0] and a[3] == b[3]
        np.testing.assert_allclose(a[1], b[1], rtol=1e-12)
        assert a[2] == pytest.approx(b[2], rel=1e-12)


def test_bilevel_iterate_interrupt_and_visualise():
    """Ctrl-C in a step returns the state with ``interrupted`` set; the
    live view is not ported and raises."""
    def step(verbose):
        raise KeyboardInterrupt
    st = th.bilevel_iterate(step, Params(maxiter=3))
    assert st.interrupted and len(st.log) == 0
    with pytest.raises(NotImplementedError, match="visualise"):
        th.bilevel_iterate(step, Params(maxiter=3), visualise=True)


def test_record_adjoint_cg_matches_jax():
    """The running stats, the last entry and the RuntimeWarning on a capped
    solve; per-item fields reduce to the worst case."""
    class Holder:
        pass
    jholder, tholder = Holder(), Holder()
    infos = [(12, 1e-9, True), (np.array([30, 40]), np.array([1e-3, 2e-3]),
                                np.array([True, False])), (5, 1e-10, True)]
    for it, res, conv in infos:
        with warnings.catch_warnings(record=True) as jw:
            warnings.simplefilter("always")
            je = jtel.record_adjoint_cg(
                jholder, KrylovInfo(it, np.asarray(res), np.asarray(conv)))
        with warnings.catch_warnings(record=True) as tw:
            warnings.simplefilter("always")
            te = ttel.record_adjoint_cg(tholder, KrylovInfo(
                torch.as_tensor(it), torch.as_tensor(res, dtype=torch.float64),
                torch.as_tensor(conv)))
        assert te == je
        assert len(tw) == len(jw)
        assert all(issubclass(w.category, RuntimeWarning) for w in tw)
    assert tholder.adjoint_cg.as_dict() == jholder.adjoint_cg.as_dict()
    assert tholder.last_adjoint_cg == jholder.last_adjoint_cg
