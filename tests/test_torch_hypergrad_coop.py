"""Kernel B (``csrc/hypergrad.cu``) as one cooperative launch per call.

- On the CPU: the wrappers run the plain versions and count no launch, no
  device operation and no host read; the inputs are checked before the
  device, so a bad shape, dtype, model or weight raises its error from the
  wrapper's launch path whatever the tensors' device, and CPU tensors never
  reach the kernel.
- On the card (marked ``cuda``; they skip without one): the kernel against
  its plain version, exact and regularized, K = 1 and K = 3, scalar and
  map weights, scalar and gradient-map outputs, cold and from a warm p0,
  with a CG that stops by its tolerance and one that stops at its cap: in
  float32 at the flagship's 10 × 128² to TOL_B_F32_REL, and in float64 at
  2 × 32² to 1e-9 relative, plus a generic form (a centred and a backward
  block) and an odd size (3 × 17 × 23, not a multiple of 256).  The images
  are piecewise constant on 4 × 4 blocks whose neighbours differ by 0.3 or
  more, with a ramp of slope 0.05 on the last quarter of the rows: every
  pixel gradient is exactly zero or at least 0.05, so the systems are well
  conditioned and CG agrees to rounding.  (On faces images, or on random
  levels whose neighbours may differ by 1e-3, a pixel near the active-set
  threshold makes the system stiff, and CG amplifies the kernel's other
  summation order far beyond rounding; ``chip_smoke.py`` phases 4 and 35
  hold the faces cases at the learns' settings.)  Each call counts exactly
  one kernel launch and one device→host read; two calls agree bit for
  bit.

This file imports no JAX, so the card's tests also run where JAX is not
installed: ``python -m pytest --noconftest tests/test_torch_hypergrad_coop.py
-m cuda``.
"""

import numpy as np
import pytest
import torch

from bpldenoising_tpu_torch.models import DenoiseModel, sumregs_model, \
    tv_model
from bpldenoising_tpu_torch.ops import BwdGradientOp, CenteredGradientOp, \
    FwdGradientOp
from bpldenoising_tpu_torch.solvers import hypergrad_cuda
from bpldenoising_tpu_torch.solvers.hypergrad import (HypergradConfig,
                                                      exact_hypergrad,
                                                      reg_hypergrad)

# float32, kernel against plain (chip_smoke.py's TOL_B_F32_REL): the
# batch-wide dot products are summed in another order than torch.sum and
# CG amplifies rounding across its iterations, so p and the gradients agree
# to a relative 1e-3 of their scale, not to rounding.
TOL_B_F32_REL = 1e-3
# float64 on a well-conditioned system: the same arithmetic at double
# precision agrees to rounding
TOL_F64_REL = 1e-9
# float64, the generic form (a centred and a backward block, one a map) in
# the regularized form at γ = 1e4: at 2 × 32² the plain version itself
# lands 8.7e-9 apart on the card and on the CPU (156 and 157 CG
# iterations; the kernel 8.6e-9 from the card's plain version and 1.2e-8
# from the CPU's; measured on an H100), so this case is held to twice the
# plain version's own spread
TOL_F64_GENERIC_REG = 2e-8
# CG iterations, kernel against plain: equal at the cap; stopped by the
# tolerance, a flat residual curve can cross it a few iterations apart
# under the other summation order (2 of 215 in a rehearsal of the odd
# size on the CPU), so within 1% (at least one iteration)
ITERS_REL = 0.01

FORMS = ("tv", "tv_map", "sumregs", "sumregs_maps", "generic")


def _weights(form, M, N, dtype, seed=1):
    """The model and weights of ``form``: scalar TV, TV with an (M, N) map,
    the sum of regularizers with three scalars or with maps and a scalar,
    and (generic) a centred and a backward block, one a map."""
    rng = np.random.default_rng(seed)
    amap = torch.as_tensor(0.05 + 0.05 * rng.random((M, N)), dtype=dtype)
    s = lambda x: torch.tensor(x, dtype=dtype)   # noqa: E731
    if form == "tv":
        return tv_model(), (s(0.1),)
    if form == "tv_map":
        return tv_model(), (amap,)
    if form == "sumregs":
        return sumregs_model(), (s(0.035), s(0.032), s(0.005))
    if form == "sumregs_maps":
        return sumregs_model(), (amap, s(0.03), 0.2 * amap)
    return DenoiseModel(ops=(CenteredGradientOp(), BwdGradientOp())), \
        (s(0.04), amap)


def _blocks_case(shape, dtype=torch.float64, seed=0):
    """(u, ū): u piecewise constant on 4×4 blocks, level 0.1·((3I + 7J +
    b) mod 10) for block (I, J) of image b, so neighbouring blocks differ
    by 0.3 or more, plus a ramp of slope 0.05 along the columns on the
    last quarter of the rows: every pixel gradient is exactly zero or at
    least 0.05."""
    O, M, N = shape
    i = torch.arange(M).div(4, rounding_mode="floor")
    j = torch.arange(N).div(4, rounding_mode="floor")
    b = torch.arange(O)
    u = 0.1 * ((3 * i[None, :, None] + 7 * j[None, None, :]
                + b[:, None, None]) % 10).to(torch.float64)
    u[:, M * 3 // 4:, :] += 0.05 * torch.arange(N, dtype=torch.float64)
    gen = torch.Generator().manual_seed(seed)
    ut = u + 0.05 * torch.randn(u.shape, generator=gen, dtype=torch.float64)
    return u.to(dtype), ut.to(dtype)


def _plain(reg):
    return reg_hypergrad if reg else exact_hypergrad


def _kernel(reg):
    return hypergrad_cuda.reg_hypergrad_cuda if reg \
        else hypergrad_cuda.exact_hypergrad_cuda


def _counts():
    return (hypergrad_cuda.launches, hypergrad_cuda.device_ops,
            hypergrad_cuda.host_reads)


# ---- on the CPU

@pytest.mark.parametrize("reg", [False, True], ids=["exact", "reg"])
@pytest.mark.parametrize("form,want_maps", [
    ("tv", False), ("sumregs", False), ("tv_map", True),
    ("sumregs_maps", True)])
def test_cpu_calls_count_nothing(form, want_maps, reg):
    """On CPU tensors the wrappers return the plain version's result and
    count no launch, no device operation and no host read."""
    u, ut = _blocks_case((2, 12, 16))
    model, a = _weights(form, 12, 16, torch.float64)
    cfg = HypergradConfig(al_iters=2, cg_maxiter=60, gamma=1e4)
    p0 = 0.01 * torch.ones_like(u)
    before = _counts()
    kg, kp, ki = _kernel(reg)(u, ut, a, model, cfg, want_maps, p0)
    pg, pp, pi = _plain(reg)(u, ut, a, model, cfg, want_maps, p0)
    assert _counts() == before
    assert all(torch.equal(torch.as_tensor(k), torch.as_tensor(p))
               for k, p in zip(kg, pg))
    assert torch.equal(kp, pp) and ki.iters == pi.iters


def _bad_inputs():
    """(label, arguments of ``_run`` on CPU tensors, error, match)."""
    u, ut = _blocks_case((2, 8, 10))
    a = (torch.tensor(0.1, dtype=u.dtype),)
    tv = tv_model()
    four = DenoiseModel(ops=(FwdGradientOp(),) * 4)
    return [
        ("utrue shape", (u, ut[:1], a, tv, None), ValueError, "utrue"),
        ("utrue dtype", (u, ut.float(), a, tv, None), ValueError, "utrue"),
        ("p0 shape", (u, ut, a, tv, u[:, :4]), ValueError, "p0"),
        ("p0 dtype", (u, ut, a, tv, u.float()), ValueError, "p0"),
        ("K = 4", (u, ut, a * 4, four, None), NotImplementedError,
         "K ≤ 3"),
        ("weights", (u, ut, a * 2, tv, None), ValueError, "weights"),
        ("map shape", (u, ut, (torch.ones(4, 4, dtype=u.dtype),), tv, None),
         NotImplementedError, "weight map"),
        ("cpu tensors", (u, ut, a, tv, None), ValueError,
         "expected a CUDA tensor"),
    ]


@pytest.mark.parametrize("reg", [False, True], ids=["exact", "reg"])
@pytest.mark.parametrize("case", _bad_inputs(), ids=lambda c: c[0])
def test_bad_inputs_raise_before_the_device(case, reg):
    """The launch path checks shapes, dtypes, the model and the weights
    before the device; valid CPU tensors are refused (they never reach the
    kernel), and nothing is counted."""
    _, (u, ut, a, model, p0), err, match = case
    before = _counts()
    with pytest.raises(err, match=match):
        hypergrad_cuda._run(u, ut, a, model, HypergradConfig(), False, p0,
                            reg=reg)
    assert _counts() == before


# ---- on the card

@pytest.fixture
def cuda_device():
    """The card, for tests marked ``cuda``; they skip without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (python -m pytest --noconftest "
                    "tests/test_torch_hypergrad_coop.py -m cuda)")
    return torch.device("cuda")


_FACES = {}


def _faces_case(device):
    """(u, ū) at the flagship's 10 × 128² float32: u from kernel A's cold
    early-stopped solve of the noisy faces at α 0.1, as in chip_smoke.py
    phase 3."""
    if "case" not in _FACES:
        from bpldenoising_tpu_torch.data import testdataset
        from bpldenoising_tpu_torch.solvers import pdps_cuda
        clean, noisy = testdataset("faces_train_128_10")
        ut = torch.as_tensor(clean, dtype=torch.float32).to(device)
        f = torch.as_tensor(noisy, dtype=torch.float32).to(device)
        u = pdps_cuda.denoise_pdps_cuda(
            f, (torch.tensor(0.1),), None, model=tv_model(), tau0=5.0,
            sigma0=0.99 / 5.0, gamma=1.0, maxiter=5000, accel=True,
            tol=5e-6, check_every=50, return_dual=False)
        _FACES["case"] = (u, ut)
    return _FACES["case"]


def _one_call(fn):
    """One kernel-B call, which must count one call, one kernel launch and
    one device→host read."""
    calls, ops, reads = _counts()
    out = fn()
    torch.cuda.synchronize()
    assert hypergrad_cuda.launches == calls + 1
    assert hypergrad_cuda.host_reads == reads + 1
    assert hypergrad_cuda.device_ops == ops + 2    # the launch and the read
    assert hypergrad_cuda.last_grid >= 1
    return out


def _rel(k, p):
    k = torch.as_tensor(k).double().cpu()
    p = torch.as_tensor(p).double().cpu()
    return float((k - p).abs().max()) / max(float(p.abs().max()), 1e-300)


def _against_plain(u, ut, model, a, reg, want_maps, rtol, stops):
    """Kernel against plain, cold and from a warm p0, for each CG budget of
    ``stops`` (label → (config, how it must stop))."""
    on = tuple(x.to(u.device) if x.ndim else x for x in a)
    for label, (cfg, stop) in stops.items():
        p0 = None
        for warm in (False, True):
            kg, kp, ki = _one_call(lambda: _kernel(reg)(
                u, ut, on, model, cfg, want_maps, p0))
            pg, pp, pi = _plain(reg)(u, ut, on, model, cfg, want_maps, p0)
            tag = (label, "warm" if warm else "cold")
            assert len(kg) == model.K, tag
            if want_maps:
                assert all(g.shape == u.shape for g in kg), tag
            errs = [_rel(k, p) for k, p in zip(kg, pg)] + [_rel(kp, pp)]
            assert max(errs) <= rtol, (tag, errs)
            if stop == "cap":
                assert ki.iters == pi.iters == cfg.cg_maxiter, \
                    (tag, ki.iters, pi.iters)
            else:
                assert ki.iters < cfg.cg_maxiter and bool(ki.converged), \
                    (tag, ki.iters)
                assert abs(ki.iters - pi.iters) <= max(
                    1, ITERS_REL * pi.iters), (tag, ki.iters, pi.iters)
            p0 = pp


@pytest.mark.cuda
@pytest.mark.parametrize("want_maps", [False, True], ids=["grads", "maps"])
@pytest.mark.parametrize("reg", [False, True], ids=["exact", "reg"])
@pytest.mark.parametrize("form", FORMS[:4])
def test_float32_flagship_shape_matches_plain(cuda_device, form, reg,
                                              want_maps):
    u, ut = (x.to(cuda_device)
             for x in _blocks_case((10, 128, 128), torch.float32))
    model, a = _weights(form, 128, 128, torch.float32)
    gamma = dict(gamma=1e4) if reg else {}
    stops = {"cap": (HypergradConfig(al_iters=2, cg_maxiter=10, **gamma),
                     "cap"),
             "tol": (HypergradConfig(al_iters=2, cg_maxiter=1000,
                                     cg_tol=1e-4, **gamma), "tol")}
    _against_plain(u, ut, model, a, reg, want_maps, TOL_B_F32_REL, stops)


@pytest.mark.cuda
@pytest.mark.parametrize("want_maps", [False, True], ids=["grads", "maps"])
@pytest.mark.parametrize("reg", [False, True], ids=["exact", "reg"])
@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("shape", [(2, 32, 32), (3, 17, 23)],
                         ids=["2x32x32", "3x17x23"])
def test_float64_matches_plain(cuda_device, shape, form, reg, want_maps):
    u, ut = (x.to(cuda_device) for x in _blocks_case(shape))
    model, a = _weights(form, shape[1], shape[2], torch.float64)
    gamma = dict(gamma=1e4) if reg else {}
    stops = {"cap": (HypergradConfig(al_iters=2, cg_maxiter=5, **gamma),
                     "cap"),
             "tol": (HypergradConfig(al_iters=2, cg_maxiter=1000, **gamma),
                     "tol")}
    rtol = TOL_F64_GENERIC_REG if form == "generic" and reg else TOL_F64_REL
    _against_plain(u, ut, model, a, reg, want_maps, rtol, stops)


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["tv", "sumregs_maps"])
@pytest.mark.parametrize("reg", [False, True], ids=["exact", "reg"])
def test_two_calls_are_bit_identical(cuda_device, form, reg):
    """Fixed-order sums and no atomics: two calls agree bit for bit."""
    u, ut = _faces_case(cuda_device)
    model, a = _weights(form, 128, 128, torch.float32)
    on = tuple(x.to(cuda_device) if x.ndim else x for x in a)
    cfg = HypergradConfig(al_iters=2, cg_maxiter=100)
    runs = [_one_call(lambda: _kernel(reg)(u, ut, on, model, cfg, True))
            for _ in range(2)]
    (g1, p1, i1), (g2, p2, i2) = runs
    assert i1.iters == i2.iters
    assert torch.equal(p1, p2)
    assert all(torch.equal(x, y) for x, y in zip(g1, g2))


@pytest.mark.cuda
def test_grid_is_bounded_by_the_virtual_blocks(cuda_device):
    """The grid is min(virtual blocks, co-resident CTAs): at 2 × 32² (8
    virtual blocks) all 8 CTAs, at the flagship (640) fewer than 640 or
    all, and never more."""
    u, ut = (x.to(cuda_device) for x in _blocks_case((2, 32, 32)))
    a = (torch.tensor(0.07, dtype=u.dtype),)
    _one_call(lambda: hypergrad_cuda.exact_hypergrad_cuda(
        u, ut, a, tv_model(), HypergradConfig(al_iters=2, cg_maxiter=30)))
    assert hypergrad_cuda.last_grid == 8
    u, ut = _faces_case(cuda_device)
    _one_call(lambda: hypergrad_cuda.exact_hypergrad_cuda(
        u, ut, (torch.tensor(0.1),), tv_model(),
        HypergradConfig(al_iters=2, cg_maxiter=5)))
    assert 1 <= hypergrad_cuda.last_grid <= 640


@pytest.mark.cuda
def test_card_input_checks(cuda_device):
    """On the card the wrappers refuse mixed devices and other dtypes."""
    u, ut = (x.to(cuda_device) for x in _blocks_case((2, 8, 10)))
    a = (torch.tensor(0.1, dtype=u.dtype),)
    before = _counts()
    with pytest.raises(ValueError, match="utrue"):
        hypergrad_cuda.exact_hypergrad_cuda(u, ut.cpu(), a, tv_model())
    with pytest.raises(TypeError, match="float32/float64"):
        hypergrad_cuda.reg_hypergrad_cuda(u.half(), ut.half(), a,
                                          tv_model())
    assert _counts() == before
