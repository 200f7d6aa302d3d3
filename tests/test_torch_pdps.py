"""The port's PDPS solver (plain version of kernel A) against the JAX
package's ``_denoise_pdps_impl`` on the same float64 inputs, cold and warm,
with and without the per-image early stop.

Tolerance: 1e-10 absolute.  Both run the same float64 iteration; rounding
differences of the two libraries' kernels stay at ~1e-15 per step and the
iteration contracts.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bpldenoising_tpu.models import sumregs_model as j_sumregs
from bpldenoising_tpu.models import tv_model as j_tv
from bpldenoising_tpu.solvers.pdps import _denoise_pdps_impl as j_impl
from bpldenoising_tpu_torch.models import sumregs_model, tv_model
from bpldenoising_tpu_torch.solvers import pdps_cuda
from bpldenoising_tpu_torch.solvers.pdps import (_denoise_pdps_impl,
                                                 denoise_pdps, tv_denoise)
from bpldenoising_tpu_torch.weights import from_jax_state

ATOL = 1e-10
KW = dict(tau0=5.0, sigma0=0.99 / 5.0, gamma=1.0, accel=True)


@pytest.fixture
def data(rng):
    clean = np.zeros((3, 20, 24))
    clean[:, 5:15, 6:18] = 1.0
    return clean, clean + 0.1 * rng.standard_normal(clean.shape)


def _run_both(f, alpha, state0_np=None, *, jmodel=None, tmodel=None,
              **kw):
    jmodel = jmodel or j_tv()
    tmodel = tmodel or tv_model()
    alphas = tuple(np.atleast_1d(alpha)) if jmodel.K > 1 else (alpha,)
    jstate = None
    tstate = None
    if state0_np is not None:
        jstate = (jnp.asarray(state0_np[0]),
                  tuple(jnp.asarray(y) for y in state0_np[1]))
        tstate = from_jax_state(state0_np, device="cpu")
    ju, jys, jit = j_impl(jnp.asarray(f),
                          tuple(jnp.asarray(a) for a in alphas), jstate,
                          model=jmodel, return_dual=True, **KW, **kw)
    tu, tys, tit = _denoise_pdps_impl(
        torch.from_numpy(f), tuple(torch.tensor(a, dtype=torch.float64) for a in alphas), tstate,
        model=tmodel, return_dual=True, **KW, **kw)
    return (ju, jys, int(jit)), (tu, tys, tit)


def _assert_same(j, t):
    (ju, jys, jit), (tu, tys, tit) = j, t
    assert jit == tit
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), atol=ATOL)
    for jy, ty in zip(jys, tys):
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=ATOL)


@pytest.mark.parametrize("alpha", [0.05, 0.3])
def test_cold_fixed_budget_matches_jax(data, alpha):
    _, f = data
    _assert_same(*_run_both(f, alpha, maxiter=200, tol=None,
                            check_every=50))


@pytest.mark.parametrize("tol,check_every", [(1e-4, 25), (1e-5, 40)])
def test_cold_early_stop_matches_jax(data, tol, check_every):
    _, f = data
    j, t = _run_both(f, 0.1, maxiter=2000, tol=tol, check_every=check_every)
    _assert_same(j, t)
    assert t[2] < 2000 and t[2] % check_every == 0


def test_warm_start_early_stop_matches_jax(data):
    """Warm start from a JAX state handed over through from_jax_state."""
    _, f = data
    (ju, jys, _), _ = _run_both(f, 0.1, maxiter=300, tol=None,
                                check_every=50)
    state = (np.asarray(ju), tuple(np.asarray(y) for y in jys))
    j, t = _run_both(f, 0.12, state, maxiter=2000, tol=1e-6, check_every=50)
    _assert_same(j, t)


def test_early_stop_clamps_to_maxiter(data):
    _, f = data
    j, t = _run_both(f, 0.1, maxiter=130, tol=1e-14, check_every=50)
    _assert_same(j, t)
    assert t[2] == 130


def test_unaccelerated_matches_jax(data):
    _, f = data
    kw = dict(KW, accel=False)
    ju = j_impl(jnp.asarray(f), (jnp.asarray(0.1),), None, model=j_tv(),
                maxiter=150, tol=None, check_every=50, return_dual=False,
                **{k: v for k, v in kw.items()})
    tu = _denoise_pdps_impl(torch.from_numpy(f), (torch.tensor(0.1, dtype=torch.float64),), None,
                            model=tv_model(), maxiter=150, tol=None,
                            check_every=50, return_dual=False, **kw)
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), atol=ATOL)


def test_sumregs_matches_jax(data):
    _, f = data
    _assert_same(*_run_both(f, np.array([0.05, 0.03, 0.02]),
                            jmodel=j_sumregs(), tmodel=sumregs_model(),
                            maxiter=150, tol=None, check_every=50))


def test_alpha_map_matches_jax(data, rng):
    _, f = data
    amap = 0.05 + 0.1 * rng.random(f.shape[-2:])
    _assert_same(*_run_both(f, amap, maxiter=150, tol=None, check_every=50))


def test_public_wrappers_and_single_image(data):
    _, f = data
    u1 = tv_denoise(torch.from_numpy(f[0]), 0.1, maxiter=100)
    u2 = denoise_pdps(torch.from_numpy(f), 0.1, tv_model(), maxiter=100)
    assert u1.shape == f.shape[1:]
    np.testing.assert_allclose(u1.numpy(), u2[0].numpy(), atol=1e-12)


def test_cuda_wrapper_runs_plain_version_on_cpu(data):
    """On CPU tensors the kernel's wrapper is the plain version, and it
    launches nothing."""
    _, f = data
    before = pdps_cuda.launches
    kw = dict(model=tv_model(), maxiter=300, tol=1e-6, check_every=50,
              return_dual=True, **KW)
    ft = torch.from_numpy(f)
    a = (torch.tensor(0.1, dtype=torch.float64),)
    got = pdps_cuda.denoise_pdps_cuda(ft, a, None, **kw)
    want = _denoise_pdps_impl(ft, a, None, **kw)
    assert got[2] == want[2]
    assert torch.equal(got[0], want[0]) and torch.equal(got[1][0], want[1][0])
    assert pdps_cuda.launches == before


def test_kernel_input_checks():
    """What the CUDA kernels refuse, checked before any launch: the channel
    model, more than three blocks or another operator, weights that are
    neither scalars nor (M, N) maps, and tensors off the card (other
    dtypes: the cuda-marked tests).  The three stencils, scalar and map
    weights pass."""
    from bpldenoising_tpu_torch.models import DenoiseModel, vtv_model
    from bpldenoising_tpu_torch.ops import (BwdGradientOp,
                                            CenteredGradientOp, PatchOp)
    f = torch.zeros((2, 4, 6), dtype=torch.float64)
    K, kinds, scalars, addrs, maps = pdps_cuda.kernel_blocks(
        sumregs_model(), (0.25, torch.full((4, 6), 0.5), 0.125), f)
    assert (K, list(kinds), list(scalars)) == (3, [0, 1, 2],
                                               [0.25, 0.0, 0.125])
    assert addrs[0] == addrs[2] == 0 and addrs[1] == maps[0].data_ptr()
    assert maps[0].dtype == f.dtype and maps[0].is_contiguous()
    K, kinds, _, _, _ = pdps_cuda.kernel_blocks(
        DenoiseModel(ops=(CenteredGradientOp(), BwdGradientOp())), (1, 2), f)
    assert (K, list(kinds)) == (2, [2, 1])
    for model in (vtv_model(),
                  DenoiseModel(ops=(CenteredGradientOp(),) * 4),
                  DenoiseModel(ops=(PatchOp((2, 2), (4, 6)),))):
        with pytest.raises(NotImplementedError):
            pdps_cuda.kernel_blocks(model, (0.1,) * model.K, f)
    for bad in (torch.ones(2, 4, 6), torch.ones(4, 4), torch.ones(3)):
        with pytest.raises(NotImplementedError):
            pdps_cuda.kernel_blocks(tv_model(), (bad,), f)
    with pytest.raises(ValueError):
        pdps_cuda.kernel_blocks(sumregs_model(), (0.1, 0.2), f)
    with pytest.raises(ValueError):
        pdps_cuda.check_cuda_input(torch.zeros(2, 4, 4))


def test_public_solver_runs_where_f_lives():
    """denoise_pdps and tv_denoise dispatch on f's device: CPU tensors run
    the plain version, CUDA tensors launch kernel A, and any other device
    raises instead of running the plain iteration there."""
    f = torch.zeros((2, 8, 8), dtype=torch.float64, device="meta")
    with pytest.raises(ValueError):
        denoise_pdps(f, 0.1, tv_model(), maxiter=5)
    with pytest.raises(ValueError):
        tv_denoise(f, 0.1, maxiter=5)
    before = pdps_cuda.launches
    u = tv_denoise(torch.zeros((2, 8, 8), dtype=torch.float64), 0.1,
                   maxiter=5)
    assert u.device.type == "cpu" and pdps_cuda.launches == before
