"""The port's vectorial-TV (color) pieces against the JAX package on the
same float64 inputs: the color PNG reader and dataset; the plain VTV
Chambolle–Pock solve (the plain version of ``csrc/vtv.cu``) cold, early-
stopped and warm from both JAX state formats, with scalar and map weights;
the Pallas kernel's own numbers in interpret mode; the implicit
cotangents; the wrapper's device dispatch and the state hand-over.

Inputs: two 16×16 RGB phantoms (coloured discs on a coloured ground) under
Gaussian noise of σ 0.1, made with numpy from a seed, and the bundled
``color_disks_128_10`` files.

Tolerances: the reader is bit-exact; solvers 1e-10 relative (the same
float64 iteration; the measured gap is ~1e-15 on u and ~1e-12 on y, which
is not unique on flat regions), with equal early-stop iteration counts;
the Pallas kernel, which projects with α·rsqrt(n² + tiny) instead of a
division, 1e-10 relative as well.  The cotangents at γ = 1e-2 agree to
1e-10 with equal CG counts (measured ~1e-15).  At the default γ = 1e-4
the smoothed system is ill-conditioned: the JAX package itself moves its
dα by 2.5e-8 relative and its CG count from 318 to 321 when u is perturbed
by 1e-13 (α 0.1, these phantoms), so there the port is held to 1e-6
relative and CG counts within 2% + 1.  Tests marked ``cuda`` hold the
CUDA kernel against the plain version on the card and skip without one.
"""

import glob
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bpldenoising_tpu.data import png_io as jpng
from bpldenoising_tpu.data import testdataset as j_testdataset
from bpldenoising_tpu.solvers.pdps import vtv_denoise as j_vtv_denoise
from bpldenoising_tpu.solvers.vtv import vtv_implicit_cotangents as j_cot
from bpldenoising_tpu.solvers.vtv_pallas import vtv_denoise_pdps_pallas
from bpldenoising_tpu_torch import data as tdata
from bpldenoising_tpu_torch.data import dataset_dir, png_io
from bpldenoising_tpu_torch.models import vtv_model
from bpldenoising_tpu_torch.solvers import pdps as tpdps
from bpldenoising_tpu_torch.solvers import vtv_cuda
from bpldenoising_tpu_torch.solvers.pdps import vtv_denoise
from bpldenoising_tpu_torch.solvers.vtv import vtv_implicit_cotangents
from bpldenoising_tpu_torch.weights import from_jax_state

RTOL = 1e-10


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float64))


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))


def color_phantoms(n=16, batch=2, seed=0):
    """(clean, noisy) planar (batch, 3, n, n): three coloured discs on a
    coloured ground per image, under Gaussian noise of σ 0.1."""
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    clean = np.empty((batch, 3, n, n))
    for o in range(batch):
        clean[o] = rng.random(3)[:, None, None]
        for _ in range(3):
            cy, cx = rng.random(2) * n
            r = n * (0.15 + 0.2 * rng.random())
            disc = (yy - cy) ** 2 + (xx - cx) ** 2 < r * r
            clean[o][:, disc] = rng.random(3)[:, None]
    return clean, clean + 0.1 * rng.standard_normal(clean.shape)


@pytest.fixture
def data():
    return color_phantoms()


@pytest.fixture
def cuda_device():
    """The card, for tests marked ``cuda``; they skip without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the card: python -m pytest "
                    "tests/test_torch_vtv.py -m cuda)")
    return torch.device("cuda")


def _alpha_map(n=16, seed=1):
    return 0.1 + 0.05 * np.random.default_rng(seed).random((n, n))


# --- color data -------------------------------------------------------------

COLOR_FILES = sorted(glob.glob(os.path.join(dataset_dir,
                                            "color_disks_128_10", "*.png")))


@pytest.mark.parametrize("path", COLOR_FILES + sorted(glob.glob(
    os.path.join(dataset_dir, "circle_128_10", "*_1.png"))),
    ids=os.path.basename)
def test_color_reader_bit_exact(path):
    """Every RGB file of color_disks_128_10, and a grayscale source whose
    channel is replicated, read bit for bit as the JAX package reads
    them."""
    got = png_io.read_png_color(path)
    want = jpng.read_png_color(path)
    assert got.dtype == np.float64 and got.shape == want.shape
    assert got.shape[0] == 3 and np.array_equal(got, want)


def test_color_dataset_matches_jax():
    assert len(COLOR_FILES) == 12
    got = tdata.testdataset("color_disks", color=True)
    want = j_testdataset("color_disks", color=True)
    for g, w in zip(got, want):
        assert g.shape == (6, 3, 128, 128) and np.array_equal(g, w)
    gray = tdata.testdataset("circle", color=True)[1]
    assert gray.shape[1:] == (3, 128, 128)
    assert np.array_equal(gray[:, 1], tdata.testdataset("circle")[1])


# --- the solver -------------------------------------------------------------

def _both(f, alpha, **kw):
    """The JAX and the port's public solver on the same inputs:
    ((u, y, iters), (u, y, iters))."""
    ju, (jy,), jit = j_vtv_denoise(jnp.asarray(f), jnp.asarray(alpha),
                                   return_dual=True, **kw)
    tu, (ty,), tit = vtv_denoise(_t(f), _t(alpha), return_dual=True, **kw)
    return (ju, jy, int(jit)), (tu, ty, tit)


def _check(jout, tout):
    (ju, jy, jit), (tu, ty, tit) = jout, tout
    assert tuple(ty.shape) == tuple(np.shape(jy))
    assert _rel(tu.numpy(), ju) <= RTOL
    assert _rel(ty.numpy(), jy) <= RTOL
    assert tit == jit


@pytest.mark.parametrize("weights", ["scalar", "map"])
def test_cold_fixed_budget_matches_jax(data, weights):
    _, f = data
    alpha = 0.1 if weights == "scalar" else _alpha_map()
    _check(*_both(f, alpha, maxiter=300))


@pytest.mark.parametrize("weights", ["scalar", "map"])
def test_early_stop_matches_jax(data, weights):
    """The per-(image, channel)-plane early stop: equal iteration
    counts."""
    _, f = data
    alpha = 0.1 if weights == "scalar" else _alpha_map()
    jout, tout = _both(f, alpha, maxiter=3000, tol=1e-5, check_every=50)
    _check(jout, tout)
    assert 50 < tout[2] < 3000


@pytest.mark.parametrize("fmt", ["jnp", "pallas"])
@pytest.mark.parametrize("weights", ["scalar", "map"])
def test_warm_start_from_jax_state_matches_jax(data, fmt, weights):
    """A JAX state, in the jnp (u, (y,)) or the Pallas (u, px, py) format,
    carried over by from_jax_state continues like the JAX solver does from
    the same state at a nudged weight, with the early stop; the port
    returns (u, (y,))."""
    _, f = data
    fj = jnp.asarray(f)
    alpha = 0.1 if weights == "scalar" else _alpha_map()
    ju0, jys, _ = j_vtv_denoise(fj, jnp.asarray(alpha), maxiter=150,
                                return_dual=True)
    st_jnp = (ju0, jys)
    st = st_jnp if fmt == "jnp" else (ju0, jys[0][..., 0, :, :],
                                      jys[0][..., 1, :, :])
    kw = dict(maxiter=2000, tol=1e-6, check_every=50, return_dual=True)
    ju, (jy,), jit = j_vtv_denoise(fj, 1.05 * jnp.asarray(alpha),
                                   state0=st_jnp, **kw)
    tu, ys, tit = vtv_denoise(_t(f), 1.05 * _t(alpha),
                              state0=from_jax_state(st, device="cpu"), **kw)
    assert len(ys) == 1 and ys[0].shape == (2, 3, 2, 16, 16)
    assert _rel(tu.numpy(), ju) <= RTOL and _rel(ys[0].numpy(), jy) <= RTOL
    assert tit == int(jit) < 2000


def test_matches_pallas_kernel_in_interpret_mode(data):
    """The TPU kernel's own numbers (interpret mode, fixed budget), scalar
    and map weights."""
    _, f = data
    for alpha in (0.1, _alpha_map()):
        ju = vtv_denoise_pdps_pallas(jnp.asarray(f), jnp.asarray(alpha),
                                     maxiter=150, interpret=True)
        tu = vtv_denoise(_t(f), _t(alpha), maxiter=150)
        assert _rel(tu.numpy(), ju) <= RTOL


def test_single_image_and_public_dispatch(data):
    """A (C, M, N) image solves like the first image of its stack, and
    denoise_pdps on vtv_model() is vtv_denoise."""
    _, f = data
    u1, (y1,), _ = vtv_denoise(_t(f[0]), 0.1, maxiter=80, return_dual=True)
    assert u1.shape == (3, 16, 16) and y1.shape == (3, 2, 16, 16)
    ub = vtv_denoise(_t(f), 0.1, maxiter=80)
    assert _rel(u1.numpy(), ub[0].numpy()) <= 1e-14
    assert torch.equal(tpdps.denoise_pdps(_t(f), 0.1, vtv_model(),
                                          maxiter=80), ub)


# --- the implicit cotangents ------------------------------------------------

@pytest.mark.parametrize("weights", ["scalar", "map"])
@pytest.mark.parametrize("start", ["cold", "lam0"])
def test_cotangents_match_jax(data, weights, start):
    """γ = 1e-2: a well-conditioned smoothed system, held to rounding."""
    clean, f = data
    alpha = 0.1 if weights == "scalar" else _alpha_map()
    u = np.asarray(j_vtv_denoise(jnp.asarray(f), jnp.asarray(alpha),
                                 maxiter=600))
    v = u - clean
    kw = dict(gamma=1e-2, cg_tol=1e-10, return_lam=True, return_info=True)
    lam0 = None
    if start == "lam0":   # the adjoint at a nudged upper-level target
        lam0 = np.asarray(j_cot(jnp.asarray(u), jnp.asarray(alpha),
                                jnp.asarray(0.9 * v), **kw)[2])
    jdf, jda, jlam, ji = j_cot(jnp.asarray(u), jnp.asarray(alpha),
                               jnp.asarray(v),
                               lam0=None if lam0 is None else jnp.asarray(
                                   lam0), **kw)
    tdf, tda, tlam, ti = vtv_implicit_cotangents(
        _t(u), _t(alpha), _t(v), lam0=None if lam0 is None else _t(lam0),
        **kw)
    assert bool(jnp.all(ji.converged)) and bool(torch.all(ti.converged))
    assert ti.iters == int(jnp.max(ji.iters))
    assert tuple(tda.shape) == tuple(np.shape(jda))
    assert _rel(tda.numpy(), jda) <= RTOL
    assert _rel(tdf.numpy(), jdf) <= RTOL and tlam is tdf


@pytest.mark.parametrize("weights", ["scalar", "map"])
def test_cotangents_at_default_gamma(data, weights):
    """γ = 1e-4 (the learns' default), where the system is ill-conditioned:
    1e-6 relative and CG counts within 2% + 1 (see the module docstring)."""
    clean, f = data
    alpha = 0.1 if weights == "scalar" else _alpha_map()
    u = np.asarray(j_vtv_denoise(jnp.asarray(f), jnp.asarray(alpha),
                                 maxiter=600))
    jdf, jda, ji = j_cot(jnp.asarray(u), jnp.asarray(alpha),
                         jnp.asarray(u - clean), return_info=True)
    tdf, tda, ti = vtv_implicit_cotangents(_t(u), _t(alpha), _t(u - clean),
                                           return_info=True)
    jit = int(jnp.max(ji.iters))
    assert abs(ti.iters - jit) <= 1 + 0.02 * jit
    assert _rel(tda.numpy(), jda) <= 1e-6 and _rel(tdf.numpy(), jdf) <= 1e-6


# --- the wrapper ------------------------------------------------------------

def test_wrapper_runs_plain_version_on_cpu(data):
    """On CPU tensors the wrapper is the plain version, bit for bit, takes
    both state formats and launches nothing."""
    _, f = data
    before = vtv_cuda.launches
    ft = _t(f)
    got = vtv_cuda.vtv_denoise_pdps_cuda(ft, (0.1,), None, maxiter=200,
                                         tol=1e-6, check_every=50,
                                         return_dual=True)
    want = tpdps._denoise_pdps_impl(
        ft, (torch.tensor(0.1, dtype=torch.float64),), None,
        model=vtv_model(), tau0=5.0, sigma0=0.99 / 5.0, gamma=1.0,
        maxiter=200, accel=True, tol=1e-6, check_every=50, return_dual=True)
    assert got[2] == want[2] == vtv_cuda.last_iters
    assert torch.equal(got[0], want[0]) and torch.equal(got[1][0],
                                                        want[1][0])
    u, (y,), _ = got
    pallas = (u, y[..., 0, :, :], y[..., 1, :, :])
    a = vtv_cuda.vtv_denoise_pdps_cuda(ft, (0.1,), (u, (y,)), maxiter=20)
    b = vtv_cuda.vtv_denoise_pdps_cuda(ft, (0.1,), pallas, maxiter=20)
    assert torch.equal(a, b)
    assert vtv_cuda.launches == before


def test_wrapper_refuses_other_devices_and_bad_states(data):
    _, f = data
    meta = torch.zeros((2, 3, 8, 8), dtype=torch.float64, device="meta")
    for solve in (lambda x: vtv_denoise(x, 0.1, maxiter=5),
                  lambda x: vtv_cuda.vtv_denoise_pdps_cuda(x, (0.1,),
                                                           maxiter=5)):
        with pytest.raises(ValueError):
            solve(meta)
    with pytest.raises(ValueError):
        vtv_cuda.as_jnp_state((_t(f),) * 4)
    with pytest.raises(ValueError):
        vtv_cuda.vtv_denoise_pdps_cuda(_t(f), (0.1, 0.2), maxiter=5)
    with pytest.raises(ValueError):   # a CPU tensor is not the card's
        vtv_cuda._launch(_t(f), torch.tensor(0.1), None, tau=0.1,
                         sigma=0.1, gamma=1.0, accel=True, maxiter=5,
                         tol=None, check_every=5)


def test_from_jax_state_carries_vtv_state_and_multiplier(data):
    """The VTV solver state in both JAX formats and the adjoint λ come over
    leaf for leaf, and either state warm-starts the port's solver to the
    same iterate."""
    clean, f = data
    fj = jnp.asarray(f)
    u0, ys, _ = j_vtv_denoise(fj, 0.1, maxiter=30, return_dual=True)
    pallas = (u0, ys[0][..., 0, :, :], ys[0][..., 1, :, :])
    _, _, lam = j_cot(u0, 0.1, u0 - jnp.asarray(clean), gamma=1e-2,
                      return_lam=True)
    jnp_st, pal_st, tlam = from_jax_state(((u0, ys), pallas, lam),
                                          device="cpu")
    assert isinstance(jnp_st[1], tuple) and len(pal_st) == 3
    for j, t in zip((u0, ys[0]) + pallas[1:],
                    (jnp_st[0], jnp_st[1][0]) + pal_st[1:]):
        assert np.array_equal(t.numpy(), np.asarray(j))
    assert tlam.shape == (2, 3, 16, 16)
    assert np.array_equal(tlam.numpy(), np.asarray(lam))
    ua = vtv_denoise(_t(f), 0.1, maxiter=20, state0=jnp_st)
    ub = vtv_denoise(_t(f), 0.1, maxiter=20, state0=pal_st)
    assert torch.equal(ua, ub)


# --- on the card ------------------------------------------------------------

@pytest.mark.cuda
def test_kernel_matches_plain_version_on_the_card(cuda_device, data):
    """float64 on the card: the kernel against its plain version, cold with
    early stop (scalar α), fixed budget (map α) and warm from the first
    state, to 1e-9 relative with equal iteration counts; a constant map
    reproduces the scalar run."""
    _, f = data
    fd = _t(f).to(cuda_device)
    first = None
    for alpha, warm, kw in (
            (0.1, False, dict(maxiter=3000, tol=1e-5, check_every=50)),
            (_t(_alpha_map()).to(cuda_device), False,
             dict(maxiter=300, tol=None, check_every=50)),
            (0.105, True, dict(maxiter=3000, tol=1e-5, check_every=50))):
        state0 = first if warm else None
        before = vtv_cuda.launches
        ku, kys, kit = vtv_cuda.vtv_denoise_pdps_cuda(
            fd, (alpha,), state0, return_dual=True, **kw)
        assert vtv_cuda.launches == before + 1
        pu, pys, pit = tpdps._denoise_pdps_impl(
            fd, (torch.as_tensor(alpha, dtype=fd.dtype),), state0,
            model=vtv_model(), tau0=5.0, sigma0=0.99 / 5.0, gamma=1.0,
            accel=True, return_dual=True, **kw)
        first = first or (pu, pys)
        assert kit == pit
        assert _rel(ku.cpu().numpy(), pu.cpu().numpy()) <= 1e-9
        assert _rel(kys[0].cpu().numpy(), pys[0].cpu().numpy()) <= 1e-9
    const = torch.full((16, 16), 0.1, dtype=torch.float64,
                       device=cuda_device)
    a = vtv_cuda.vtv_denoise_pdps_cuda(fd, (0.1,), maxiter=200)
    b = vtv_cuda.vtv_denoise_pdps_cuda(fd, (const,), maxiter=200)
    assert torch.equal(a, b)
