"""The port's patch and sum-of-regularizers trust region against the JAX
package, on the same float64 data:

- ``bilevel_learn_fused`` with a 2×2 patch grid (TV), a (2, 2, 3) patch
  stack (sum of regularizers) and a 12×12 grid (144 parameters, above
  ``lbfgs_threshold``: the L-BFGS model), against the JAX package's
  ``bilevel_learn_fused(backend="jnp")``: the per-iteration log, the
  learned parameter, the cost and u;
- the entry points ``patch_bilevel_tv_learn``,
  ``scalar_bilevel_sumregs_learn`` and ``patch_bilevel_sumregs_learn``
  with ``method="tr_fused"`` against the JAX entry points on a bundled
  dataset, ``state.log`` included;
- the plain versions of kernels A and B in their K = 3 and map forms
  against the JAX package's Pallas kernels in interpret mode;
- a JAX warm state ``(u, (y₀, y₁, y₂))`` handed over by
  ``weights.from_jax_state``;
- on the card (marked ``cuda``; they skip without one): kernels A and B
  at K = 3, with maps and gradient maps, against their plain versions.

Tolerances: 1e-8 relative on the trust-region logs (``_compare`` of
tests/test_torch_fused.py: the two run the same float64 arithmetic; the
adjoint systems are kept well conditioned by a converging CG and an
active-set threshold of 1e-4); 1e-10 absolute on the solver against the
Pallas kernel (a contracting iteration; the JAX package's own test of
that kernel holds it to the same); 1e-9 relative on the hypergradient
against the Pallas kernel (a converged CG); 1e-9 relative for a kernel
against its plain version in float64.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bpldenoising_tpu.bilevel.fused import \
    bilevel_learn_fused as j_learn_fused
from bpldenoising_tpu.experiments import api as japi
from bpldenoising_tpu.models import sumregs_model as j_sumregs
from bpldenoising_tpu.models import tv_model as j_tv
from bpldenoising_tpu.solvers import hypergrad_pallas as jhp
from bpldenoising_tpu.solvers.hypergrad import HypergradConfig as JCfg
from bpldenoising_tpu.solvers.pdps import _denoise_pdps_impl as j_pdps
from bpldenoising_tpu.solvers.pdps_pallas import _pallas_impl
from bpldenoising_tpu.utils.config import Params as JParams
from bpldenoising_tpu_torch import experiments as tx
from bpldenoising_tpu_torch.bilevel.fused import bilevel_learn_fused
from bpldenoising_tpu_torch.models import sumregs_model, tv_model
from bpldenoising_tpu_torch.solvers import (hypergrad_cuda, pdps_cuda,
                                            sumregs_denoise, tv_denoise)
from bpldenoising_tpu_torch.solvers.hypergrad import (HypergradConfig,
                                                      exact_hypergrad,
                                                      reg_hypergrad)
from bpldenoising_tpu_torch.solvers.pdps import _denoise_pdps_impl
from bpldenoising_tpu_torch.utils.config import Params
from bpldenoising_tpu_torch.weights import from_jax_state
from test_torch_fused import TR, _compare, _dataset
from test_torch_fused import (one_torch_thread,  # noqa: F401 (autouse)
                             results_in_tmp)

PD = dict(tau0=5.0, sigma0=0.99 / 5.0, gamma=1.0, accel=True)
WELL = dict(al_iters=2, cg_maxiter=1000, act_tol=1e-4)

CASES = {
    # name: (model, x0, images, size, extra TR params, learn keywords);
    # the regularized branch (Δt above Δ₀) at γ = 1e2, where its system is
    # well conditioned (at the default 1e8 CG amplifies rounding)
    "patch_tv_2x2": ("tv", 0.1 * np.ones((2, 2)), 2, 24, {}, {}),
    "patch_tv_2x2_regularized": ("tv", 0.1 * np.ones((2, 2)), 2, 24, {},
                                 dict(delta_t=1.0, gamma=1e2)),
    "patch_sumregs_2x2x3": (
        "sumregs", np.tile(np.array([0.03, 0.02, 0.01]), (2, 2, 1)), 2, 24,
        dict(delta0=0.01, beta2=1.5), dict(delta_t=1e-3)),
    "lbfgs_grid_12x12": ("tv", 0.1 * np.ones((12, 12)), 2, 24, {}, {}),
}


def _reference_spread(learn, ds, jres):
    """How far the JAX package's own log moves when the noisy images move
    by 1e-13: (‖g‖ relative, CG count per row), the larger of two signs."""
    k = int(jres.iterations)
    jlog = np.asarray(jres.log)[:k]
    noise = 1e-13 * np.random.default_rng(1).standard_normal(ds[1].shape)
    g_spread, cg_spread = 0.0, np.zeros(k)
    for sign in (1.0, -1.0):
        plog = np.asarray(learn(ds[1] + sign * noise).log)[:k]
        g_spread = max(g_spread, float(np.max(
            np.abs(plog[:, 1] - jlog[:, 1]) / np.abs(jlog[:, 1]))))
        cg_spread = np.maximum(cg_spread, np.abs(plog[:, 4] - jlog[:, 4]))
    return g_spread, cg_spread


@pytest.mark.parametrize("case", list(CASES))
def test_patch_trajectory_matches_jax(case):
    kind, x0, n_img, size, extra, kw = CASES[case]
    kw = dict(kw)
    ds = _dataset(n_img, size, seed=3 * size + n_img)
    params = dict(TR, maxiter=3, **extra)
    cfg = dict(WELL, **({"gamma": kw.pop("gamma")} if "gamma" in kw else {}))
    kw = dict(inner_maxiter=400, inner_tol=1e-6, check_every=50, **kw)
    jmodel, tmodel = (j_tv(), tv_model()) if kind == "tv" \
        else (j_sumregs(), sumregs_model())

    def j_learn(noisy):
        return j_learn_fused((jnp.asarray(ds[0]), jnp.asarray(noisy)),
                             xinit=jnp.asarray(x0), params=JParams(params),
                             model=jmodel, backend="jnp", cfg=JCfg(**cfg),
                             **kw)

    jres = j_learn(ds[1])
    tres = bilevel_learn_fused(ds, xinit=torch.from_numpy(x0),
                               params=Params(params), model=tmodel,
                               cfg=HypergradConfig(**cfg), device="cpu",
                               **kw)
    assert tuple(tres.x.shape) == x0.shape
    if kind == "tv":
        _compare(jres, tres)
        return
    # the sum of regularizers' K = 3 adjoint system: its CG count (and ‖g‖
    # in the last digits) moves in the JAX package itself under a 1e-13
    # perturbation of the data, as in test_torch_fused.py's vector case
    # (here by up to 23 iterations of ~450); the port is held to twice
    # the largest spread of any row (two perturbations are too few to
    # call a row that did not move stable)
    g_spread, cg_spread = _reference_spread(j_learn, ds, jres)
    _compare(jres, tres, gnorm_rtol=max(1e-8, 2.0 * g_spread),
             cg_slack=2.0 * float(cg_spread.max()))


def test_nonpositive_patch_parameters_raise():
    ds = _dataset(1, 16, seed=1)
    for x0, model in ((np.array([[0.1, 0.0], [0.1, 0.1]]), None),
                      (-0.1 * np.ones((2, 2, 3)), sumregs_model())):
        with pytest.raises(ValueError, match="strictly positive"):
            bilevel_learn_fused(ds, xinit=x0, params=Params(TR, maxiter=1),
                                model=model, device="cpu")
    with pytest.raises(ValueError, match="unsupported parameter shape"):
        bilevel_learn_fused(ds, xinit=0.1 * np.ones((2, 2, 2)),
                            params=Params(TR, maxiter=1), model=sumregs_model(),
                            device="cpu")


@pytest.fixture
def in_tmp(tmp_path, monkeypatch):
    """The JAX entry points create output/<dataset>/ under the working
    directory: keep it out of the repo."""
    monkeypatch.chdir(tmp_path)
    return tmp_path


# 30 cold inner iterations keep the entry points' default float64 exact
# adjoint system (act_tol 1e-9) well conditioned: the JAX entry points move
# their weights by ~1e-11 (relative) when the noisy image moves by 1e-13.
# On a partly converged solve (150 iterations, inner_tol 1e-5) the same
# perturbation moves them by ~1e-7 and the CG counts by hundreds, and no
# port can be held closer than that.
ENTRY = dict(dataset_name="circle", num_samples=1, method="tr_fused",
             maxiter=2, inner_maxiter=30, inner_tol=None)


@pytest.mark.parametrize("entry", ["patch_bilevel_tv_learn",
                                   "scalar_bilevel_sumregs_learn",
                                   "patch_bilevel_sumregs_learn"])
def test_entry_points_match_jax(in_tmp, entry):
    """The entry points with their own defaults (the JAX package's
    parameter sets, the family's Δt, the default HypergradConfig and
    check_every) on one bundled image at small budgets, ``state.log``
    included."""
    jres = getattr(japi, entry)(save_results=False, backend="jnp", **ENTRY)
    tres = getattr(tx, entry)(device="cpu", **ENTRY)
    assert isinstance(tres.x, np.ndarray) and isinstance(tres.u, np.ndarray)
    assert tres.x.shape == np.asarray(jres.x).shape
    assert tres.u.shape == (1, 128, 128) and tres.u.dtype == np.float64
    assert tres.iterations == jres.iterations == ENTRY["maxiter"]
    np.testing.assert_allclose(tres.x, np.asarray(jres.x), rtol=1e-8)
    np.testing.assert_allclose(tres.cost, jres.cost, rtol=1e-8)
    np.testing.assert_allclose(tres.g_norm, jres.g_norm, rtol=1e-8)
    np.testing.assert_allclose(tres.u, np.asarray(jres.u), atol=1e-10)
    assert len(tres.state.log) == len(jres.state.log) == ENTRY["maxiter"]
    for t, j in zip(tres.state.log, jres.state.log):
        assert t.iter == j.iter and t.time == 0.0
        np.testing.assert_allclose(
            [t.function_value, t.g_norm, t.delta, t.step_norm,
             t.adjoint_cg_converged],
            [j.function_value, j.g_norm, j.delta, j.step_norm,
             j.adjoint_cg_converged], rtol=1e-8, atol=1e-12)
        assert abs(t.adjoint_cg_iters - j.adjoint_cg_iters) \
            <= 2 + 0.01 * j.adjoint_cg_iters


# ---- the kernels' K = 3 and map forms (plain versions) against the JAX
# package's Pallas kernels in interpret mode

def _images(rng, O=2, M=16, N=20):
    yy, xx = np.meshgrid(np.arange(M), np.arange(N), indexing="ij")
    clean = ((xx - N / 2) ** 2 + (yy - M / 2) ** 2
             < (M / 3) ** 2).astype(np.float64)
    clean = np.stack([clean] * O)
    return clean, clean + 0.1 * rng.standard_normal(clean.shape)


def _alphas(rng, form, shape):
    amap = rng.uniform(0.01, 0.1, shape)
    return {"sumregs": (0.05, 0.03, 0.02),
            "sumregs_maps": (amap, 0.03, rng.uniform(0.005, 0.03, shape)),
            "tv_map": (amap,)}[form]


def _t64(alphas):
    return tuple(torch.as_tensor(a, dtype=torch.float64) for a in alphas)


def _models(form):
    return (j_tv(), tv_model()) if form == "tv_map" \
        else (j_sumregs(), sumregs_model())


@pytest.mark.parametrize("form", ["sumregs", "sumregs_maps", "tv_map"])
def test_pdps_forms_match_pallas_interpret(rng, form):
    _, f = _images(rng)
    alphas = _alphas(rng, form, f.shape[-2:])
    jmodel, tmodel = _models(form)
    u_j, (_, ys_j) = _pallas_impl(
        jnp.asarray(f), tuple(jnp.asarray(a) for a in alphas), None,
        model=jmodel, maxiter=150, interpret=True, tol=None,
        return_state=True, **PD)
    u_t, ys_t, iters = _denoise_pdps_impl(
        torch.from_numpy(f), _t64(alphas),
        model=tmodel, maxiter=150, tol=None, check_every=50,
        return_dual=True, **PD)
    assert iters == 150 and len(ys_t) == len(ys_j) == len(alphas)
    np.testing.assert_allclose(u_t.numpy(), np.asarray(u_j), atol=1e-10)
    for a, b in zip(ys_t, ys_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-10)


@pytest.mark.parametrize("reg", [False, True], ids=["exact", "regularized"])
@pytest.mark.parametrize("form", ["sumregs", "sumregs_maps", "tv_map"])
def test_hypergrad_forms_match_pallas_interpret(rng, form, reg):
    """The plain hypergradient forms against the Pallas kernels in
    interpret mode.  The CG cap is 6000: the ``sumregs_maps`` exact case
    needs about 2,800-3,000 iterations per augmented-Lagrangian solve to
    reach ``cg_tol`` 1e-12, and the count moves with rounding.  With u
    moved by 0 and ±1e-13, JAX's ``exact_hypergrad_pallas`` (interpret)
    took 2973 / 2975 / 2988 iterations in its last solve, JAX's own jnp
    ``exact_hypergrad`` 2987 / 2857 / 2820 and the port's plain version
    2956 / 2980 / 2987, every run converged, and the port's gradient maps
    agreed with the Pallas kernel's to 2.4e-13 - 5.4e-13 relative.  A cap
    of 3000 sat inside that spread."""
    true_, f = _images(rng)
    alphas = _alphas(rng, form, f.shape[-2:])
    jmodel, tmodel = _models(form)
    u = np.array(j_pdps(jnp.asarray(f), tuple(map(jnp.asarray, alphas)),
                          None, model=jmodel, maxiter=1500, tol=None,
                          check_every=100, return_dual=False, **PD))
    cfg = dict(al_iters=2, cg_maxiter=6000, cg_tol=1e-12)
    if reg:
        cfg = dict(cfg, gamma=1e4)
    jfn = jhp.reg_hypergrad_pallas if reg else jhp.exact_hypergrad_pallas
    tfn = reg_hypergrad if reg else exact_hypergrad
    want_maps = form != "sumregs"
    g_j, p_j, info_j = jfn(jnp.asarray(u), jnp.asarray(true_),
                           tuple(map(jnp.asarray, alphas)), jmodel,
                           JCfg(**cfg), want_maps=want_maps, interpret=True)
    g_t, p_t, info_t = tfn(torch.from_numpy(u), torch.from_numpy(true_),
                           _t64(alphas), tmodel,
                           HypergradConfig(**cfg), want_maps=want_maps)
    assert bool(info_j.converged) and bool(info_t.converged)
    assert len(g_t) == len(alphas)
    for a, b in zip(g_t, g_j):
        b = np.asarray(b)
        assert a.shape == b.shape == (u.shape if want_maps else ())
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-9,
                                   atol=1e-9 * np.abs(b).max())
    np.testing.assert_allclose(p_t.numpy(), np.asarray(p_j), rtol=1e-9,
                               atol=1e-9 * np.abs(np.asarray(p_j)).max())


def test_jax_warm_state_is_handed_over(rng):
    """A JAX warm state (u, (y₀, y₁, y₂)) through weights.from_jax_state
    warm-starts the port's solve to the JAX package's u."""
    _, f = _images(rng)
    alphas = (0.05, 0.03, 0.02)
    kw = dict(model=j_sumregs(), tol=None, check_every=50, **PD)
    u0, ys0, _ = j_pdps(jnp.asarray(f), alphas, None, maxiter=100,
                        return_dual=True, **kw)
    u_j = j_pdps(jnp.asarray(f), (0.06, 0.02, 0.01), (u0, ys0), maxiter=80,
                 return_dual=False, **kw)
    state = from_jax_state((u0, ys0), device="cpu")
    assert len(state[1]) == 3
    u_t = sumregs_denoise(torch.from_numpy(f), (0.06, 0.02, 0.01),
                          maxiter=80, state0=state)
    np.testing.assert_allclose(u_t.numpy(), np.asarray(u_j), atol=1e-10)


def test_public_solvers_take_maps_and_three_weights(rng):
    """tv_denoise with an (M, N) map and sumregs_denoise with a (3,)
    vector or an (M, N, 3) stack, as the JAX package reads them."""
    _, f = _images(rng, O=1)
    amap = rng.uniform(0.02, 0.1, f.shape[-2:])
    ft = torch.from_numpy(f)
    got = tv_denoise(ft, torch.from_numpy(amap), maxiter=60)
    want = j_pdps(jnp.asarray(f), (jnp.asarray(amap),), None, model=j_tv(),
                  maxiter=60, tol=None, check_every=50, return_dual=False,
                  **PD)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-12)
    stack = np.stack([amap, 0.5 * amap, 0.25 * amap], axis=-1)
    got = sumregs_denoise(ft, torch.from_numpy(stack), maxiter=60)
    want = j_pdps(jnp.asarray(f), tuple(jnp.asarray(stack[..., k])
                                        for k in range(3)), None,
                  model=j_sumregs(), maxiter=60, tol=None, check_every=50,
                  return_dual=False, **PD)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-12)
    got = sumregs_denoise(ft, np.array([0.05, 0.03, 0.02]), maxiter=60)
    assert got.shape == f.shape and bool(torch.all(torch.isfinite(got)))


def test_python_weights_keep_double_precision(rng):
    """Weights given as Python numbers or lists reach a float64 solve at
    double precision, as in the JAX package with x64 (not rounded through
    torch's float32 default)."""
    _, f = _images(rng, O=1)
    ft = torch.from_numpy(f)
    for alphas in ((0.06, 0.02, 0.01), [0.06, 0.02, 0.01]):
        canon = sumregs_model().canonical_alphas(alphas)
        assert all(a.dtype == torch.float64 for a in canon)
        got = sumregs_denoise(ft, alphas, maxiter=40)
        want = j_pdps(jnp.asarray(f), (0.06, 0.02, 0.01), None,
                      model=j_sumregs(), maxiter=40, tol=None,
                      check_every=50, return_dual=False, **PD)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-13)
    assert tv_model().canonical_alphas(0.1)[0].dtype == torch.float64


# ---- on the card: kernels A and B in their K = 3 and map forms against
# their plain versions, float64

@pytest.fixture
def cuda_device():
    """The card, for tests marked ``cuda``; they skip without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (python -m pytest "
                    "tests/test_torch_fused_sumregs.py -m cuda)")
    return torch.device("cuda")


def _rel(a, b):
    a, b = a.detach().cpu().double(), b.detach().cpu().double()
    return float((a - b).abs().max() / max(float(b.abs().max()), 1e-300))


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["sumregs", "sumregs_maps", "tv_map"])
def test_kernel_a_forms_match_plain_on_the_card(cuda_device, form):
    rng = np.random.default_rng(11)
    _, f = _images(rng)
    alphas = _t64(_alphas(rng, form, f.shape[-2:]))
    model = _models(form)[1]
    kw = dict(model=model, maxiter=400, tol=1e-8, check_every=50,
              return_dual=True, **PD)
    before = pdps_cuda.launches
    ku, kys, kit = pdps_cuda.denoise_pdps_cuda(
        torch.from_numpy(f).to(cuda_device), alphas, None, **kw)
    assert pdps_cuda.launches == before + 1
    pu, pys, pit = _denoise_pdps_impl(torch.from_numpy(f), alphas, None,
                                      **kw)
    assert kit == pit and len(kys) == len(pys)
    assert _rel(ku, pu) <= 1e-9
    for a, b in zip(kys, pys):
        assert _rel(a, b) <= 1e-9
    # a warm start from the plain state, at other weights
    state = (pu.to(cuda_device), tuple(y.to(cuda_device) for y in pys))
    alphas2 = tuple(0.9 * a for a in alphas)
    ku, _, _ = pdps_cuda.denoise_pdps_cuda(
        torch.from_numpy(f).to(cuda_device), alphas2, state, **kw)
    pu, _, _ = _denoise_pdps_impl(torch.from_numpy(f), alphas2, (pu, pys),
                                  **kw)
    assert _rel(ku, pu) <= 1e-9
    with pytest.raises(TypeError):
        pdps_cuda.denoise_pdps_cuda(
            torch.from_numpy(f).to(cuda_device, torch.float16), alphas,
            None, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("reg", [False, True], ids=["exact", "regularized"])
@pytest.mark.parametrize("form", ["sumregs", "sumregs_maps", "tv_map"])
def test_kernel_b_forms_match_plain_on_the_card(cuda_device, form, reg):
    rng = np.random.default_rng(12)
    true_, f = _images(rng)
    alphas = _t64(_alphas(rng, form, f.shape[-2:]))
    model = _models(form)[1]
    u = _denoise_pdps_impl(torch.from_numpy(f), alphas, None, model=model,
                           maxiter=1500, tol=None, check_every=100,
                           return_dual=False, **PD)
    cfg = HypergradConfig(al_iters=2, cg_maxiter=3000, cg_tol=1e-12,
                          **(dict(gamma=1e4) if reg else {}))
    want_maps = form != "sumregs"
    kern = hypergrad_cuda.reg_hypergrad_cuda if reg \
        else hypergrad_cuda.exact_hypergrad_cuda
    plain = reg_hypergrad if reg else exact_hypergrad
    ut = torch.from_numpy(true_)
    before = hypergrad_cuda.launches
    kg, kp, ki = kern(u.to(cuda_device), ut.to(cuda_device), alphas, model,
                      cfg, want_maps)
    assert hypergrad_cuda.launches == before + 1
    pg, pp, pi = plain(u, ut, alphas, model, cfg, want_maps)
    assert bool(ki.converged) and bool(pi.converged)
    assert abs(ki.iters - pi.iters) <= 1
    for a, b in zip(kg, pg):
        assert a.shape == b.shape
        assert _rel(a, b) <= 1e-9
    assert _rel(kp, pp) <= 1e-9
