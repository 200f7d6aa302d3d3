"""The port's TV-L1 solvers against the JAX package on the same float64
inputs: the plain TV-L1 and the Huber-smoothed Chambolle–Pock iterations
(the plain versions of ``csrc/tvl1.cu``) cold, warm from both JAX state
formats and early-stopped, with scalar and map weights; the Pallas kernels'
own numbers in interpret mode; the energies; the γ → ∞ limit; the smoothed
hypergradient; the wrapper's device dispatch.

Inputs: two 24×24 phantoms (a disc, a step) under 20% salt-and-pepper
noise, made with numpy from a seed.

Tolerances: solvers 1e-10 relative (the same float64 iteration; the
measured gap is ~1e-15, rounding that does not grow), with equal
early-stop iteration counts; the Pallas kernels, which project with
α·rsqrt(n² + tiny) instead of a division, 1e-10 relative as well; energies
1e-12 relative; the hypergradient 1e-10 relative with CG counts within
one (its Jacobi-CG converges in ~100 iterations on these inputs, measured
gap ~1e-13).  Tests marked ``cuda`` hold the CUDA kernel against the
plain version on the card and skip without one.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bpldenoising_tpu.solvers import tvl1 as jt
from bpldenoising_tpu.solvers import tvl1_huber as jh
from bpldenoising_tpu.solvers.hypergrad import HypergradConfig as JConfig
from bpldenoising_tpu.solvers.tvl1_huber_pallas import \
    tvl1_huber_denoise_pallas
from bpldenoising_tpu.solvers.tvl1_pallas import tvl1_denoise_pallas
from bpldenoising_tpu_torch.solvers import tvl1 as tt
from bpldenoising_tpu_torch.solvers import tvl1_cuda
from bpldenoising_tpu_torch.solvers import tvl1_huber as th
from bpldenoising_tpu_torch.solvers.hypergrad import HypergradConfig
from bpldenoising_tpu_torch.weights import from_jax_state

RTOL = 1e-10
GD, GR = 100.0, 1000.0


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float64))


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))


def impulse_phantoms(n=24, seed=0, batch=2):
    """(clean, noisy): a disc and a step under 20% salt-and-pepper noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    c = n / 2
    clean = np.stack([0.2 + 0.6 * ((xx - c) ** 2 + (yy - c) ** 2
                                   < (n / 3) ** 2),
                      0.3 + 0.4 * (xx > n / 3)])[:batch].astype(np.float64)
    noisy = clean.copy()
    hit = rng.random(clean.shape) < 0.2
    noisy[hit] = rng.integers(0, 2, int(hit.sum()))
    return clean, noisy


@pytest.fixture
def data():
    return impulse_phantoms()


@pytest.fixture
def cuda_device():
    """The card, for tests marked ``cuda``; they skip without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the card: python -m pytest "
                    "tests/test_torch_tvl1.py -m cuda)")
    return torch.device("cuda")


def _alpha_map(seed=1):
    return 0.5 + 0.6 * np.random.default_rng(seed).random((24, 24))


# --- solvers ----------------------------------------------------------------

def _both(form, f, alpha, **kw):
    """The JAX and the port's public solver on the same inputs, returning
    (u, y[, iters]) of each."""
    if form == "plain":
        ju, (_, jy), jit = jt.tvl1_denoise(jnp.asarray(f), jnp.asarray(alpha),
                                           return_dual=True, **kw)
        tu, (_, ty), tit = tt.tvl1_denoise(_t(f), _t(alpha),
                                           return_dual=True, **kw)
        return (ju, jy, int(jit)), (tu, ty, tit)
    kw = dict(kw, gamma_d=GD, gamma_r=GR)
    ju, (_, jy) = jh.tvl1_huber_denoise(jnp.asarray(f), jnp.asarray(alpha),
                                        return_dual=True, **kw)
    tu, (_, ty) = th.tvl1_huber_denoise(_t(f), _t(alpha), return_dual=True,
                                        **kw)
    return (ju, jy, None), (tu, ty, None)


def _check(jout, tout):
    (ju, jy, jit), (tu, ty, tit) = jout, tout
    assert tuple(ty.shape) == tuple(np.shape(jy))
    assert _rel(tu.numpy(), ju) <= RTOL
    assert _rel(ty.numpy(), jy) <= RTOL
    assert tit == jit


@pytest.mark.parametrize("form", ["plain", "huber"])
@pytest.mark.parametrize("weights", ["scalar", "map"])
def test_cold_fixed_budget_matches_jax(data, form, weights):
    _, f = data
    alpha = 0.8 if weights == "scalar" else _alpha_map()
    _check(*_both(form, f, alpha, maxiter=300))


@pytest.mark.parametrize("form", ["plain", "huber"])
@pytest.mark.parametrize("weights", ["scalar", "map"])
def test_early_stop_matches_jax(data, form, weights):
    """Equal iteration counts (the plain form returns them; the Huber form
    returns none, as in the JAX package, and the wrapper records them)."""
    _, f = data
    alpha = 0.8 if weights == "scalar" else _alpha_map()
    jout, tout = _both(form, f, alpha, maxiter=3000, tol=1e-5,
                       check_every=40)
    _check(jout, tout)
    if form == "plain":
        assert 40 < tout[2] < 3000
    else:
        assert 40 < tvl1_cuda.last_iters < 3000


@pytest.mark.parametrize("form", ["plain", "huber"])
@pytest.mark.parametrize("fmt", ["jnp", "pallas"])
def test_warm_start_from_jax_state_matches_jax(data, form, fmt):
    """A JAX state, in the jnp (u, y) or the Pallas (u, px, py) format,
    carried over by from_jax_state continues like the JAX solver does from
    the same state at a nudged weight, with the early stop; the port
    returns (u, y)."""
    _, f = data
    fj = jnp.asarray(f)
    if form == "plain":
        solve_j, solve_t, extra = jt.tvl1_denoise, tt.tvl1_denoise, {}
    else:
        solve_j, solve_t = jh.tvl1_huber_denoise, th.tvl1_huber_denoise
        extra = dict(gamma_d=GD, gamma_r=GR)
    st = st_jnp = solve_j(fj, 0.8, maxiter=150, return_dual=True,
                          **extra)[1]
    if fmt == "pallas":
        u0, y0 = st
        st = (u0, y0[..., 0, :, :], y0[..., 1, :, :])
    kw = dict(maxiter=2000, tol=1e-5, check_every=50, return_dual=True,
              **extra)
    jout = solve_j(fj, 0.85, state0=st_jnp, **kw)
    tout = solve_t(_t(f), 0.85, state0=from_jax_state(st, device="cpu"),
                   **kw)
    (ju, (_, jy)), (tu, (tu2, ty)) = jout[:2], tout[:2]
    assert tu2 is tu and ty.shape == (2, 2, 24, 24)
    assert _rel(tu.numpy(), ju) <= RTOL and _rel(ty.numpy(), jy) <= RTOL
    if form == "plain":
        assert tout[2] == int(jout[2]) < 2000


@pytest.mark.parametrize("form", ["plain", "huber"])
def test_matches_pallas_kernel_in_interpret_mode(data, form):
    """The TPU kernels' own numbers (interpret mode, fixed budget), scalar
    and map weights."""
    _, f = data
    for alpha in (0.8, _alpha_map()):
        if form == "plain":
            ju = tvl1_denoise_pallas(jnp.asarray(f), jnp.asarray(alpha),
                                     maxiter=120, interpret=True)
            tu = tt.tvl1_denoise(_t(f), _t(alpha), maxiter=120)
        else:
            ju = tvl1_huber_denoise_pallas(
                jnp.asarray(f), jnp.asarray(alpha), gamma_d=GD, gamma_r=GR,
                maxiter=120, interpret=True)
            tu = th.tvl1_huber_denoise(_t(f), _t(alpha), gamma_d=GD,
                                       gamma_r=GR, maxiter=120)
        assert _rel(tu.numpy(), ju) <= RTOL


def test_energies_match_jax(data):
    _, f = data
    u = tt.tvl1_denoise(_t(f), 0.8, maxiter=100)
    uj, fj = jnp.asarray(u.numpy()), jnp.asarray(f)
    for alpha in (0.8, _alpha_map()):
        got = tt.tvl1_energy(u, _t(f), _t(alpha))
        want = jt.tvl1_energy(uj, fj, jnp.asarray(alpha))
        assert got.shape == (2,) and _rel(got.numpy(), want) <= 1e-12
        got = th.tvl1_huber_energy(u, _t(f), _t(alpha), gamma_d=GD,
                                   gamma_r=GR)
        want = jh.tvl1_huber_energy(uj, fj, jnp.asarray(alpha), gamma_d=GD,
                                    gamma_r=GR)
        assert got.shape == (2,) and _rel(got.numpy(), want) <= 1e-12


def test_large_gamma_limit_matches_tvl1(data):
    """γ_d, γ_r → ∞ degenerates both resolvents to the TV-L1 ones (the
    limit the JAX package pins in tests/test_tvl1_learn.py), and the port's
    limit is the JAX package's."""
    _, f = data
    kw = dict(gamma_d=1e7, gamma_r=1e9, maxiter=3000)
    u_lim = th.tvl1_huber_denoise(_t(f), 0.8, **kw)
    u_ref = tt.tvl1_denoise(_t(f), 0.8, maxiter=3000)
    np.testing.assert_allclose(u_lim.numpy(), u_ref.numpy(), atol=1e-6)
    want = jh.tvl1_huber_denoise(jnp.asarray(f), 0.8, **kw)
    assert _rel(u_lim.numpy(), want) <= RTOL


# --- hypergradient ----------------------------------------------------------

@pytest.mark.parametrize("want_maps", [False, True])
@pytest.mark.parametrize("start", ["cold", "p0"])
def test_hypergrad_matches_jax(data, want_maps, start):
    clean, f = data
    alpha = _alpha_map() if want_maps else 0.8
    u = jh.tvl1_huber_denoise(jnp.asarray(f), jnp.asarray(alpha),
                              gamma_d=GD, gamma_r=GR, maxiter=1500)
    p0 = None
    if start == "p0":
        # a nearby adjoint: the cold one at a nudged upper-level target
        p0 = np.asarray(jh.tvl1_huber_hypergrad(
            u, jnp.asarray(f), jnp.asarray(0.9 * clean),
            (jnp.asarray(alpha),), cfg=JConfig(gamma=GR),
            gamma_d=GD)[1])
    jg, jp, ji = jh.tvl1_huber_hypergrad(
        u, jnp.asarray(f), jnp.asarray(clean), (jnp.asarray(alpha),),
        cfg=JConfig(gamma=GR), want_maps=want_maps,
        p0=None if p0 is None else jnp.asarray(p0), gamma_d=GD)
    tg, tp, ti = th.tvl1_huber_hypergrad(
        _t(u), _t(f), _t(clean), (_t(alpha),), cfg=HypergradConfig(gamma=GR),
        want_maps=want_maps, p0=None if p0 is None else _t(p0), gamma_d=GD)
    assert bool(ji.converged) and bool(ti.converged)
    assert abs(ti.iters - int(ji.iters)) <= 1
    assert tuple(tg[0].shape) == tuple(np.shape(jg[0]))
    assert _rel(tg[0].numpy(), jg[0]) <= 1e-10
    assert _rel(tp.numpy(), jp) <= 1e-10


# --- the wrapper ------------------------------------------------------------

def test_wrapper_runs_plain_version_on_cpu(data):
    """On CPU tensors both wrappers are the plain versions, bit for bit,
    and launch nothing; a single image comes back unbatched."""
    _, f = data
    before = tvl1_cuda.launches
    ft = _t(f)
    tau, sigma = tt.step_sizes(0.99, 0.99, torch.float64)
    got = tvl1_cuda.tvl1_denoise_cuda(ft, 0.8, maxiter=200, tol=1e-6,
                                      check_every=50, return_dual=True)
    want = tt._tvl1_impl(ft, 0.8, None, tau=tau, sigma=sigma, maxiter=200,
                         tol=1e-6, check_every=50, return_dual=True)
    assert got[2] == want[2]
    assert torch.equal(got[0], want[0]) and torch.equal(got[1][1],
                                                        want[1][1])
    got = tvl1_cuda.tvl1_huber_denoise_cuda(ft, 0.8, maxiter=200,
                                            return_dual=True)
    want = th._tvl1_huber_impl(ft, 0.8, None, gamma_d=GD, gamma_r=GR,
                               tau=tau, sigma=sigma, maxiter=200, tol=None,
                               check_every=500, return_dual=True)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1][1],
                                                        want[1][1])
    u1, (_, y1), _ = tt.tvl1_denoise(ft[0], 0.8, maxiter=50,
                                     return_dual=True)
    assert u1.shape == (24, 24) and y1.shape == (2, 24, 24)
    assert tvl1_cuda.launches == before


def test_wrapper_refuses_other_devices_and_bad_states(data):
    f = torch.zeros((2, 8, 8), dtype=torch.float64, device="meta")
    for solve in (tt.tvl1_denoise, th.tvl1_huber_denoise,
                  tvl1_cuda.tvl1_denoise_cuda,
                  tvl1_cuda.tvl1_huber_denoise_cuda):
        with pytest.raises(ValueError):
            solve(f, 0.8, maxiter=5)
    _, fn = data
    with pytest.raises(ValueError):
        tt.tvl1_denoise(_t(fn), 0.8, maxiter=5,
                        state0=(_t(fn), _t(fn), _t(fn), _t(fn)))
    with pytest.raises(ValueError):   # a CPU tensor is not the card's
        tvl1_cuda._launch(_t(fn), torch.tensor(0.8), None, tau=0.1,
                          sigma=0.1, huber=False, maxiter=5, tol=None,
                          check_every=5)


def test_from_jax_state_carries_tvl1_state_and_adjoint(data):
    """The TV-L1 solver state in both JAX formats and the adjoint p come
    over leaf for leaf, and either state warm-starts the port's solver to
    the same iterate."""
    _, f = data
    fj = jnp.asarray(f)
    u0, (_, y0) = jh.tvl1_huber_denoise(fj, 0.8, maxiter=30,
                                        return_dual=True)
    pallas = (u0, y0[..., 0, :, :], y0[..., 1, :, :])
    p = jnp.asarray(np.random.default_rng(2).standard_normal((2, 24, 24)))
    (jnp_st, pal_st, tp) = from_jax_state(((u0, y0), pallas, p),
                                          device="cpu")
    assert len(jnp_st) == 2 and len(pal_st) == 3
    for j, t in zip((u0, y0) + pallas[1:], jnp_st + pal_st[1:]):
        assert np.array_equal(t.numpy(), np.asarray(j))
    assert np.array_equal(tp.numpy(), np.asarray(p))
    ua = th.tvl1_huber_denoise(_t(f), 0.8, maxiter=20, state0=jnp_st)
    ub = th.tvl1_huber_denoise(_t(f), 0.8, maxiter=20, state0=pal_st)
    assert torch.equal(ua, ub)


# --- on the card ------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("form", ["plain", "huber"])
def test_kernel_matches_plain_version_on_the_card(cuda_device, data, form):
    """float64 on the card: the kernel against its plain version, cold with
    early stop (scalar α) and fixed budget (map α), to 1e-9 relative with
    equal iteration counts; a constant map reproduces the scalar run."""
    _, f = data
    fd = _t(f).to(cuda_device)
    solve = (tvl1_cuda.tvl1_denoise_cuda if form == "plain"
             else tvl1_cuda.tvl1_huber_denoise_cuda)
    loop = tt._tvl1_loop if form == "plain" else th._tvl1_huber_loop
    extra = {} if form == "plain" else dict(gamma_d=GD, gamma_r=GR)
    tau, sigma = tt.step_sizes(0.99, 0.99, torch.float64)
    for alpha, kw in ((0.8, dict(maxiter=3000, tol=1e-5, check_every=50)),
                      (_t(_alpha_map()).to(cuda_device),
                       dict(maxiter=300, tol=None, check_every=50))):
        before = tvl1_cuda.launches
        ku, (_, ky) = solve(fd, alpha, return_dual=True, **kw)[:2]
        kit = tvl1_cuda.last_iters
        assert tvl1_cuda.launches == before + 1
        pu, py, pit = loop(fd, torch.as_tensor(alpha, dtype=fd.dtype),
                           None, tau=tau, sigma=sigma, **extra, **kw)
        assert kit == pit
        assert _rel(ku.cpu().numpy(), pu.cpu().numpy()) <= 1e-9
        assert _rel(ky.cpu().numpy(), py.cpu().numpy()) <= 1e-9
    const = torch.full((24, 24), 0.8, dtype=torch.float64,
                       device=cuda_device)
    a = solve(fd, 0.8, maxiter=200)
    b = solve(fd, const, maxiter=200)
    assert torch.equal(a, b)
