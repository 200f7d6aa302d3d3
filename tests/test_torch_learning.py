"""The port's learning functions (learning/*.py: the L4 contract
``f(x, ds, Δ) → (u, cost, grad)`` of the host trust region) against the JAX
package's ``*_learning_function(backend="jnp")`` on the same seeded float64
inputs (2×16×16 stacks; VTV 2×3×16×16), on the CPU, where the wrappers run
the kernels' plain versions.

Tolerance: 1e-8 relative on u, the cost and the gradient (u also 1e-10
absolute), in both gradient branches where the family has two.  The
hypergradient configurations keep the adjoint systems well conditioned (an
active-set threshold of 1e-4, or the smoothed families' Huber γ), as in
tests/test_torch_fused.py: an ill-conditioned adjoint moves the JAX
package's own gradient by more than that under a rounding of the data.
The factories are held over three calls (exact, exact, regularized for
TV), with and without an inner ``tol``, against the JAX factories, which
checks their warm-start caches.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bpldenoising_tpu.learning import sumregs as jsr
from bpldenoising_tpu.learning import tgv as jtgv
from bpldenoising_tpu.learning import tv as jtv
from bpldenoising_tpu.learning import tvl1 as jtvl1
from bpldenoising_tpu.learning import vtv as jvtv
from bpldenoising_tpu.solvers.hypergrad import HypergradConfig as JCfg
from bpldenoising_tpu_torch import learning as tl
from bpldenoising_tpu_torch.solvers.hypergrad import HypergradConfig
from test_torch_fused import one_torch_thread  # noqa: F401

RTOL = 1e-8
CFG = HypergradConfig(al_iters=2, cg_maxiter=1000, act_tol=1e-4)


def _gray(seed, impulse=False):
    """(clean, noisy): 2×16×16, a disc and a ramp with a step, under
    Gaussian noise of σ 0.1 or 20% salt-and-pepper noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.arange(16), np.arange(16), indexing="ij")
    clean = np.stack([0.2 + 0.6 * ((xx - 8) ** 2 + (yy - 7) ** 2 < 25),
                      0.03 * xx + 0.5 * (yy > 6)]).astype(np.float64)
    if not impulse:
        return clean, clean + 0.1 * rng.standard_normal(clean.shape)
    noisy = clean.copy()
    hit = rng.random(clean.shape) < 0.2
    noisy[hit] = rng.integers(0, 2, int(hit.sum()))
    return clean, noisy


def _color(seed):
    """(clean, noisy): 2×3×16×16 planar colour discs under σ 0.1 noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.arange(16), np.arange(16), indexing="ij")
    clean = np.empty((2, 3, 16, 16))
    for o in range(2):
        clean[o] = rng.random(3)[:, None, None]
        for _ in range(2):
            cy, cx = rng.random(2) * 16
            disc = (yy - cy) ** 2 + (xx - cx) ** 2 < 16 * (1 + rng.random())
            clean[o][:, disc] = rng.random(3)[:, None]
    return clean, clean + 0.1 * rng.standard_normal(clean.shape)


# family: (jax module, its learning function's name, the port's, data,
# keywords of both, keywords of the JAX call only)
FAMILIES = {
    "tv": (jtv, "tv_learning_function", tl.tv_learning_function,
           lambda: _gray(0), dict(maxiter=300),
           dict(backend="jnp")),
    "sumregs": (jsr, "sumregs_learning_function",
                tl.sumregs_learning_function, lambda: _gray(1),
                dict(maxiter=300), dict(backend="jnp")),
    "tgv": (jtgv, "tgv_learning_function", tl.tgv_learning_function,
            lambda: _gray(2), dict(maxiter=300, gamma=1e-2),
            dict(backend="jnp")),
    "tvl1": (jtvl1, "tvl1_learning_function", tl.tvl1_learning_function,
             lambda: _gray(3, impulse=True), dict(maxiter=300), {}),
    "vtv": (jvtv, "vtv_learning_function", tl.vtv_learning_function,
            lambda: _color(4), dict(maxiter=300, gamma=1e-2),
            dict(backend="jnp")),
}

# (family, parameter label): x
PARAMS = {
    ("tv", "scalar"): 0.05,
    ("tv", "patch"): np.array([[0.04, 0.06], [0.05, 0.03]]),
    ("sumregs", "vector"): np.array([0.03, 0.02, 0.01]),
    ("sumregs", "patch"): np.array([[[0.03, 0.02, 0.01], [0.02, 0.02, 0.02]],
                                    [[0.01, 0.03, 0.02], [0.02, 0.01,
                                                          0.03]]]),
    ("tgv", "vector"): np.array([0.05, 0.08]),
    ("tgv", "patch"): np.stack([np.full((2, 2), 0.05),
                                np.array([[0.08, 0.06], [0.1, 0.07]])],
                               axis=-1),
    ("tvl1", "scalar"): 0.8,
    ("tvl1", "patch"): np.array([[0.7, 0.9], [0.8, 1.0]]),
    ("vtv", "scalar"): 0.05,
    ("vtv", "patch"): np.array([[0.04, 0.06], [0.05, 0.03]]),
    ("vtv", "map"): 0.03 + 0.04 * np.random.default_rng(5).random((16, 16)),
}


def _cfg_kw(family, cfg=CFG):
    """The TV-family hypergradient configuration of both packages."""
    if family in ("tv", "sumregs"):
        return dict(cfg=cfg), dict(cfg=JCfg(**cfg._asdict()))
    return {}, {}


def _close(t, j, atol=0.0):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), rtol=RTOL,
                               atol=atol)


def _check(tout, jout):
    tu, tc, tg = tout
    ju, jc, jg = jout
    assert tuple(tu.shape) == tuple(np.shape(ju))
    assert tuple(tg.shape) == tuple(np.shape(jg))
    _close(tu.numpy(), ju, atol=1e-10)
    _close(float(tc), float(jc))
    _close(tg.numpy(), jg, atol=1e-12)


@pytest.mark.parametrize("branch", ["exact", "reg"])
@pytest.mark.parametrize("family,label", list(PARAMS))
def test_learning_function_matches_jax(family, label, branch):
    """One evaluation: Δ = 0.1 (the exact gradient for TV and the sum of
    regularizers) or Δ = 1e-8 (their regularized gradient, at γ = 1e2); the
    smoothed families have one branch and ignore Δ."""
    jmod, jname, tfn, data, kw, jkw = FAMILIES[family]
    ds = data()
    x = PARAMS[(family, label)]
    delta = 0.1 if branch == "exact" else 1e-8
    cfg = CFG if branch == "exact" else CFG._replace(gamma=1e2)
    tkw, jckw = _cfg_kw(family, cfg)
    jout = getattr(jmod, jname)(x, (jnp.asarray(ds[0]), jnp.asarray(ds[1])),
                                delta, **kw, **jkw, **jckw)
    tout = tfn(x, ds, delta, device="cpu", **kw, **tkw)
    _check(tout, jout)


FACTORIES = {
    "tv": (jtv.make_tv_learning_function, tl.make_tv_learning_function,
           "solver_kwargs"),
    "sumregs": (jsr.make_sumregs_learning_function,
                tl.make_sumregs_learning_function, "solver_kwargs"),
    "tgv": (jtgv.make_tgv_learning_function, tl.make_tgv_learning_function,
            None),
    "tvl1": (jtvl1.make_tvl1_learning_function,
             tl.make_tvl1_learning_function, None),
    "vtv": (jvtv.make_vtv_learning_function, tl.make_vtv_learning_function,
            None),
}


@pytest.mark.parametrize("tol", [None, 1e-6], ids=["cold", "warm"])
@pytest.mark.parametrize("family", list(FACTORIES))
def test_factory_matches_jax_over_three_calls(family, tol):
    """Three calls of each factory at moving x (Δ: exact, exact, then the
    regularized branch where there is one) against the JAX factory: the
    adjoint warm starts per branch, and with ``tol`` (early stop every 50
    iterations) the inner solver's state chained from call to call;
    ``lf.last_adjoint_cg`` and ``lf.adjoint_cg`` as the JAX factory's
    (CG counts ± 2, as in tests/test_torch_fused.py)."""
    jfac, tfac, solver_key = FACTORIES[family]
    _, _, _, data, kw, jkw = FAMILIES[family]
    ds = data()
    label = next(lab for fam, lab in PARAMS if fam == family)
    x0 = np.asarray(PARAMS[(family, label)], dtype=np.float64)
    # γ = 1e2: the regularized third call's adjoint converges
    tkw, jckw = _cfg_kw(family, CFG._replace(gamma=1e2))
    if tol is not None:
        inner = dict(tol=tol, check_every=50)
        extra = {solver_key: inner} if solver_key else inner
    else:
        extra = {}
    calls = ((1.0, 0.1), (1.1, 0.05), (1.05, 1e-8))

    def jax_counts(noisy):
        """The JAX factory's CG counts over the calls on ``noisy``."""
        jlf = jfac(**kw, **jkw, **jckw, **extra)
        jds = (jnp.asarray(ds[0]), jnp.asarray(noisy))
        out = []
        for scale, delta in calls:
            out.append((jlf(x0 * scale, jds, delta), dict(
                jlf.last_adjoint_cg)))
        return jlf, out

    jlf, jouts = jax_counts(ds[1])
    tlf = tfac(**kw, **tkw, **extra, device="cpu")
    t_counts = []
    for (scale, delta), (jout, j_cg) in zip(calls, jouts):
        _check(tlf(x0 * scale, ds, delta), jout)
        t_counts.append(tlf.last_adjoint_cg["iters"])
        assert tlf.last_adjoint_cg["converged"] == j_cg["converged"]
    j_counts = np.array([c["iters"] for _, c in jouts])
    slack = np.full(3, 2.0)
    if np.any(np.abs(np.array(t_counts) - j_counts) > slack):
        # a CG whose residual creeps along its threshold moves its count in
        # the JAX package itself when the noisy images move by 1e-13 (the
        # sum of regularizers here: by ~10): the port is held to twice that
        # spread, as in tests/test_torch_fused.py
        noise = 1e-13 * np.random.default_rng(1).standard_normal(
            np.shape(ds[1]))
        for sign in (1.0, -1.0):
            _, pouts = jax_counts(ds[1] + sign * noise)
            spread = np.abs(np.array([c["iters"] for _, c in pouts])
                            - j_counts)
            slack = np.maximum(slack, 2.0 * spread)
    assert np.all(np.abs(np.array(t_counts) - j_counts) <= slack), (
        t_counts, j_counts, slack)
    assert tlf.adjoint_cg.n_solves == jlf.adjoint_cg.n_solves == 3
    # one adjoint per branch, and the solver state only with tol
    branches = 2 if family in ("tv", "sumregs") else (
        1 if family == "tvl1" else 0)
    assert len(tlf.cache) == branches + (tol is not None)


def test_factory_cache_keys_by_the_dataset_object():
    """A state is given back only for the very tensor it was made with: an
    equal copy of the dataset starts cold, as the JAX factory's id-keyed
    cache does; the cache holds at most 16 entries."""
    ds = tuple(torch.from_numpy(a) for a in _gray(0))
    lf = tl.make_tv_learning_function(maxiter=50, cfg=CFG, device="cpu")
    lf(0.05, ds, 0.1)
    key = lf.cache.key("exact", np.asarray(0.05), ds)
    assert lf.cache.get(key, ds[0]) is not None
    copy = (ds[0].clone(), ds[1].clone())
    assert lf.cache.get(lf.cache.key("exact", np.asarray(0.05), copy),
                        copy[0]) is None
    for i in range(20):
        lf.cache.put(("extra", i), None, ds[0])
    assert len(lf.cache) == 16


def test_learning_functions_refuse_bad_input():
    """Other backends, parameter shapes and unknown solver keywords raise;
    without device="cpu" a learning function asks for the card."""
    ds = _gray(0)
    with pytest.raises(NotImplementedError, match="backend"):
        tl.tv_learning_function(0.05, ds, 0.1, backend="jnp", device="cpu")
    with pytest.raises(ValueError):
        tl.tv_learning_function(np.ones(3), ds, 0.1, device="cpu")
    with pytest.raises(ValueError):
        tl.sumregs_learning_function(np.ones(2), ds, 0.1, device="cpu")
    with pytest.raises(ValueError):
        tl.tgv_learning_function(np.ones(3), ds, 0.1, device="cpu")
    with pytest.raises(ValueError, match="color"):
        tl.vtv_learning_function(0.05, (ds[0][0], ds[1][0]), 0.1,
                                 device="cpu")
    with pytest.raises(TypeError, match="solver_kwargs"):
        tl.tv_learning_function(0.05, ds, 0.1, maxiter=5, device="cpu",
                                solver_kwargs=dict(interpret=True))
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            tl.tv_learning_function(0.05, ds, 0.1, maxiter=5)
