"""The port's differentiable denoising layers (``solvers/implicit.py``,
``solvers/tgv.py``, ``solvers/tvl1_huber.py``, ``solvers/vtv.py``) against
the JAX package's ``custom_vjp`` layers on the CPU in float64.

Inputs, made with numpy from seeds: a 12×12 disc under Gaussian noise (TV
and the sum of regularizers, as tests/test_implicit.py), a 10×10 ramp with
a step (TGV², as tests/test_tgv.py), two 16×16 discs under 20%
salt-and-pepper noise (TV-L1) and a 3-channel 12×12 disc (VTV).

Tolerances.  Forward: 1e-12 absolute against the JAX layer, and the
public denoiser's output bit for bit (the layer's forward is that call).
Gradients (``torch.autograd.grad`` of ½‖u − ū‖² against ``jax.grad`` /
``jax.vmap``): 1e-8 relative to the largest entry in the TV family, whose
adjoint CG stops at 1e-8 in float64, and 1e-6 in TGV², TV-L1 and VTV,
whose CGs stop at 1e-6 (TV-L1: 1e-8; measured gaps 2e-12 – 8e-9).  The
f-gradient against central differences (h = 1e-5, one random direction):
the JAX test's rtol = 2e-3 (tests/test_implicit.py), the forward run to
convergence.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bpldenoising_tpu.models import sumregs_model as j_sumregs_model
from bpldenoising_tpu.solvers import implicit as ji
from bpldenoising_tpu.solvers import tgv as jtgv
from bpldenoising_tpu.solvers import tvl1_huber as jl1
from bpldenoising_tpu.solvers import vtv as jvtv
from bpldenoising_tpu_torch.models import sumregs_model
from bpldenoising_tpu_torch.solvers import (denoise_pdps, implicit, tgv,
                                            tgv_denoise_pdps,
                                            tvl1_huber, tvl1_huber_denoise,
                                            vtv, vtv_denoise)

MAXITER = 3000


def disc(n=12, seed=0, sigma=0.1):
    x, y = np.meshgrid(np.arange(n), np.arange(n))
    clean = ((x - n / 2) ** 2 + (y - n / 2) ** 2 < (n / 3) ** 2).astype(float)
    rng = np.random.default_rng(seed)
    return clean, clean + sigma * rng.standard_normal((n, n))


def ramp(n=10, seed=1):
    x, y = np.meshgrid(np.linspace(0, 1, n), np.linspace(0, 1, n))
    clean = 0.5 * x + 0.3 * (y > 0.5)
    rng = np.random.default_rng(seed)
    return clean, clean + 0.05 * rng.standard_normal((n, n))


def impulse(n=16, seed=2):
    clean, _ = disc(n)
    clean = np.stack([clean, clean[::-1]])
    rng = np.random.default_rng(seed)
    noisy = clean.copy()
    hit = rng.random(clean.shape) < 0.2
    noisy[hit] = rng.random(int(hit.sum()))
    return clean, noisy


def color(n=12, seed=3):
    clean, _ = disc(n)
    clean = np.stack([clean, 0.5 * clean, clean[::-1]])
    rng = np.random.default_rng(seed)
    return clean, clean + 0.1 * rng.standard_normal(clean.shape)


# name: (data, JAX layer (f, *weights) -> u, port layer, public denoiser,
#        weights, gradient tolerance)
def _tv_family(name):
    clean, f = disc()
    if name == "tv":
        return (clean, f, lambda f_, a: ji.diff_tv_denoise(f_, a, MAXITER),
                lambda f_, a: implicit.diff_tv_denoise(f_, a, MAXITER),
                lambda f_, a: denoise_pdps(f_, (a,), implicit._TV,
                                           maxiter=MAXITER), (0.08,), 1e-8)
    if name == "tv_map":
        amap = 0.06 + 0.04 * np.random.default_rng(4).random(f.shape)
        return (clean, f, lambda f_, a: ji.diff_tv_denoise(f_, a, MAXITER),
                lambda f_, a: implicit.diff_tv_denoise(f_, a, MAXITER),
                lambda f_, a: denoise_pdps(f_, (a,), implicit._TV,
                                           maxiter=MAXITER), (amap,), 1e-8)
    return (clean, f,
            lambda f_, *a: ji.diff_denoise(f_, a, j_sumregs_model(),
                                           MAXITER),
            lambda f_, *a: implicit.diff_denoise(f_, a, sumregs_model(),
                                                 MAXITER),
            lambda f_, *a: denoise_pdps(f_, a, sumregs_model(),
                                        maxiter=MAXITER),
            (0.05, 0.03, 0.02), 1e-8)


def case(name):
    if name in ("tv", "tv_map", "sumregs"):
        return _tv_family(name)
    if name in ("tgv", "tgv_map"):
        clean, f = ramp()
        a0 = (0.2 if name == "tgv"
              else 0.15 + 0.1 * np.random.default_rng(5).random(f.shape))
        return (clean, f,
                lambda f_, a1, a0_: jtgv.diff_tgv_denoise(f_, a1, a0_, 2000),
                lambda f_, a1, a0_: tgv.diff_tgv_denoise(f_, a1, a0_, 2000),
                lambda f_, a1, a0_: tgv_denoise_pdps(f_, a1, a0_,
                                                     maxiter=2000)[0],
                (0.1, a0), 1e-6)
    if name in ("tvl1", "tvl1_map"):
        clean, f = impulse()
        a = (0.6 if name == "tvl1"
             else 0.5 + 0.2 * np.random.default_rng(6).random(f.shape[-2:]))
        return (clean, f, lambda f_, a_: jl1.diff_tvl1_denoise(f_, a_, 2000),
                lambda f_, a_: tvl1_huber.diff_tvl1_denoise(f_, a_, 2000),
                lambda f_, a_: tvl1_huber_denoise(f_, a_, maxiter=2000),
                (a,), 1e-6)
    clean, f = color()
    a = (0.1 if name == "vtv"
         else 0.08 + 0.04 * np.random.default_rng(7).random(f.shape[-2:]))
    return (clean, f, lambda f_, a_: jvtv.diff_vtv_denoise(f_, a_, 2000),
            lambda f_, a_: vtv.diff_vtv_denoise(f_, a_, 2000),
            lambda f_, a_: vtv_denoise(f_, a_, maxiter=2000), (a,), 1e-6)


NAMES = ["tv", "tv_map", "sumregs", "tgv", "tgv_map", "tvl1", "tvl1_map",
         "vtv", "vtv_map"]


def _t(a, grad=False):
    return torch.tensor(np.asarray(a, dtype=np.float64), requires_grad=grad)


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


@pytest.mark.parametrize("name", ["tv", "sumregs", "tgv", "tvl1", "vtv"])
def test_forward_matches_jax_and_the_public_denoiser(name):
    """The layer's output is the public denoiser's bit for bit (the same
    call) and the JAX layer's to 1e-12."""
    clean, f, jlayer, tlayer, denoiser, weights, _ = case(name)
    u = tlayer(_t(f), *[_t(a) for a in weights])
    assert u.dtype == torch.float64 and u.shape == f.shape
    assert torch.equal(u, denoiser(_t(f), *[_t(a) for a in weights]))
    ju = jlayer(jnp.asarray(f), *[jnp.asarray(a) for a in weights])
    np.testing.assert_allclose(u.numpy(), np.asarray(ju), rtol=0,
                               atol=1e-12)


@pytest.mark.parametrize("name", NAMES)
def test_gradients_match_jax_grad(name):
    """torch.autograd.grad of ½‖u − ū‖² with respect to f and every weight
    (scalar and map) against jax.grad of the JAX layer."""
    clean, f, jlayer, tlayer, _, weights, tol = case(name)

    def jloss(f_, *a):
        return 0.5 * jnp.sum((jlayer(f_, *a) - clean) ** 2)

    jgrads = jax.grad(jloss, argnums=tuple(range(1 + len(weights))))(
        jnp.asarray(f), *[jnp.asarray(a) for a in weights])
    inputs = [_t(f, True)] + [_t(a, True) for a in weights]
    u = tlayer(*inputs)
    grads = torch.autograd.grad(0.5 * torch.sum((u - _t(clean)) ** 2),
                                inputs)
    for k, (g, jg, x) in enumerate(zip(grads, jgrads, inputs)):
        assert g.shape == x.shape and g.dtype == torch.float64
        assert _rel(g.numpy(), jg) <= tol, (k, _rel(g.numpy(), jg))


@pytest.mark.parametrize("weight", ["scalar", "map"])
def test_stack_matches_jax_vmap(weight):
    """An (O, M, N) stack through diff_tv_denoise gives what jax.vmap of
    the JAX layer gives over its images (per-image CG), the weight's
    cotangent summed over the images."""
    clean, f = disc()
    cb = np.stack([clean, clean[::-1], clean.T])
    fb = np.stack([f, f[::-1] + 0.01, f.T - 0.02])
    a = 0.08 if weight == "scalar" else 0.06 + 0.04 * np.ones(f.shape)

    def jloss(f_, a_):
        u = jax.vmap(lambda x: ji.diff_tv_denoise(x, a_, MAXITER))(f_)
        return 0.5 * jnp.sum((u - cb) ** 2)

    jgf, jga = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(fb),
                                               jnp.asarray(a))
    F, A = _t(fb, True), _t(a, True)
    u = implicit.diff_tv_denoise(F, A, MAXITER)
    gf, ga = torch.autograd.grad(0.5 * torch.sum((u - _t(cb)) ** 2), (F, A))
    assert _rel(gf.numpy(), jgf) <= 1e-8
    assert _rel(ga.numpy(), jga) <= 1e-8


@pytest.mark.parametrize("name", ["tv", "tgv", "tvl1", "vtv"])
def test_f_gradient_matches_central_differences(name):
    """⟨∇_f J, d⟩ against (J(f + hd) − J(f − hd)) / 2h, h = 1e-5, for one
    random direction d, at the JAX test's rtol = 2e-3.  The TV-L1 layer
    runs 8000 iterations here: its unaccelerated iteration is 1.2% from
    the differences' slope at 2000 (the JAX layer's too)."""
    clean, f, _, tlayer, _, weights, _ = case(name)
    if name == "tvl1":
        def tlayer(f_, a):
            return tvl1_huber.diff_tvl1_denoise(f_, a, 8000)

    def loss(f_):
        return 0.5 * torch.sum((tlayer(f_, *[_t(a) for a in weights])
                                - _t(clean)) ** 2)

    F = _t(f, True)
    (g,) = torch.autograd.grad(loss(F), (F,))
    d = np.random.default_rng(8).standard_normal(f.shape)
    h = 1e-5
    fd = (float(loss(_t(f + h * d))) - float(loss(_t(f - h * d)))) / (2 * h)
    np.testing.assert_allclose(float(torch.sum(g * _t(d))), fd, rtol=2e-3)


def test_backward_honours_needs_input_grad():
    """Only what needs a gradient gets one; without any, no graph."""
    clean, f = disc()
    F, A = _t(f, True), _t(0.08)
    u = implicit.diff_tv_denoise(F, A, 500)
    (gf,) = torch.autograd.grad(torch.sum(u), (F,))
    assert gf.shape == F.shape
    F, A = _t(f), _t(0.08, True)
    u = implicit.diff_tv_denoise(F, A, 500)
    (ga,) = torch.autograd.grad(torch.sum(u), (A,))
    assert ga.shape == ()
    u = implicit.diff_tv_denoise(_t(f), 0.08, 500)
    assert u.grad_fn is None and not u.requires_grad


def test_tvl1_cotangents_match_jax():
    """tvl1_huber_implicit_cotangents (df = Dλ, the map cotangent, the
    warm start from λ) against the JAX function."""
    clean, f = impulse()
    u = tvl1_huber_denoise(_t(f), 0.6, maxiter=1500)
    ju = jnp.asarray(u.numpy())
    v = u - _t(clean)
    amap = 0.6 * np.ones(f.shape[-2:])
    for a in (0.6, amap):
        df, da, lam = tvl1_huber.tvl1_huber_implicit_cotangents(
            u, _t(f), _t(a), v, gamma_d=100.0, cg_tol=1e-10,
            cg_maxiter=3000, return_lam=True)
        jdf, jda = jl1.tvl1_huber_implicit_cotangents(
            ju, jnp.asarray(f), jnp.asarray(a), jnp.asarray(v.numpy()),
            gamma_d=100.0, cg_tol=1e-10, cg_maxiter=3000)
        assert da.shape == np.shape(a)
        assert _rel(df.numpy(), jdf) <= 1e-8
        assert _rel(da.numpy(), jda) <= 1e-8
        df2, da2 = tvl1_huber.tvl1_huber_implicit_cotangents(
            u, _t(f), _t(a), v, gamma_d=100.0, cg_tol=1e-10,
            cg_maxiter=3000, lam0=lam)
        assert _rel(da2.numpy(), da.numpy()) <= 1e-8


def test_backend_keywords_follow_check_backend():
    """The JAX builders' backend= and interpret=: "auto" and False run,
    anything else raises, as check_backend does elsewhere."""
    clean, f = ramp()
    layer = tgv.make_diff_tgv_denoise(maxiter=50, backend="auto")
    assert layer(_t(f), (_t(0.1), _t(0.2))).shape == f.shape
    for kw in (dict(backend="pallas"), dict(backend="jnp"),
               dict(interpret=True)):
        with pytest.raises(NotImplementedError, match="device="):
            tgv.make_diff_tgv_denoise(**kw)
        with pytest.raises(NotImplementedError, match="device="):
            vtv.make_diff_vtv_denoise(**kw)
