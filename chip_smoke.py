#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (one short line each):

1. device: require CUDA; print the card's name and power limit as
   ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
   them.
2. build: compile ``bpldenoising_tpu_torch/csrc/*.cu`` with one ``nvcc``
   call and load the library.
3. kernel A (PDPS inner solve) against its plain PyTorch version on the
   flagship data (10 × 128² float32): a cold 5000-iteration call, a cold
   call with early stop that returns its state, a warm call from that
   state; then once more in float64 at a small shape.
4. kernel B (AL hypergradient, exact and regularized forms) against its
   plain version at the flagship shapes, u from phase 3; then in float64.
5. the flagship: ``scalar_bilevel_tv_learn(dataset_name="faces_train",
   num_samples=10, method="tr_fused", device="cuda")`` with the benchmark's
   settings, once to warm up and once timed with CUDA events, launch
   counters reset just before the timed run.  It must land within the
   parity gates below.
6. the TGV² kernel (``csrc/tgv.cu``) against its plain PyTorch version on
   the flagship data (10 × 128² float32): a cold 5000-iteration call, a
   cold call with early stop that returns its state, a warm call from that
   state at nudged weights; each with scalar weights and with (M, N) map
   weights; a constant map must reproduce the scalar run bit for bit.
   Then in float64 at 2 × 32².
7. large images: the TGV² kernel at 1 × 1024² (1000 iterations, the shape
   the TPU sends to its row-tiled TGV kernel) and kernel A at 1 × 2048²
   (1000 iterations, the shape the TPU sends to its row-tiled TV kernel),
   each against its plain version, timed.
8. the TGV learn: ``scalar_bilevel_tgv_learn(dataset_name="faces_train",
   num_samples=10, method="tr_fused", device="cuda")`` with the benchmark's
   TGV settings, once to warm up and once timed, all launch counters reset
   just before the timed run and read just after.  Gates below.
9. the patch TGV learn: ``patch_bilevel_tgv_learn`` on the same data with
   a (2, 2, 2) stack and the entry point's own β₂ = 1.5, counters reset
   just before and read just after.  Gates below.

It prints one JSON line of per-kernel numbers, then, as its last line,
``{"ok": true, "device": {...}}``.  Any failure raises (no phase is
caught) and the script exits non-zero; a deadline turns a hang into a
traceback and a non-zero exit.
"""

from __future__ import annotations

import faulthandler
import json
import subprocess
import sys
import time

DEADLINE_S = 900

# flagship reference result (TPU v5e, float32): learned α, mean PSNR, cost
FLAGSHIP_ALPHA = 0.069788
ALPHA_GATE = 1e-4          # fail beyond this
ALPHA_BAND = 2e-5          # the float32 parity band, reported separately
FLAGSHIP_PSNR = 27.386
PSNR_GATE = 0.005          # dB
FLAGSHIP_COST = 152.3354
COST_GATE_REL = 1e-3

# Kernel-vs-plain tolerances.
# float32, kernel A: the kernel projects with rsqrt (the TPU kernel's form,
# ~2 ulp) where the plain version divides by a sqrt, so the two iterations
# differ by rounding each step.  The primal iterate contracts (strongly
# convex), so u agrees to a few 1e-6 on values of order 1.  The dual
# iteration is only non-expansive and its solution is not unique on flat
# regions, so rounding differences in y persist: y (|y| ≤ α = 0.1) is held
# to 1% of α.  A fault in either step moves u by 1e-2 or more.
TOL_A_U_F32 = 1e-4
TOL_A_Y_F32 = 1e-3
# float32, kernel B: 100-iteration CG that is stopped by its cap; the
# batch-wide dot products are summed in another order than torch.sum, and
# CG amplifies rounding across iterations, so p and the gradient agree to
# a relative 1e-3 of their scale, not to rounding.
TOL_B_F32_REL = 1e-3
# float64: the same arithmetic at double precision, small shape
TOL_F64_REL = 1e-9

# TGV learn reference (the JAX package on the CPU, float32, jnp, the same
# settings): α = (α₁, α₀), mean PSNR, cost.  The faces TGV cost is a flat
# valley: another sound trust-region point 9% away in α₁ has a cost only
# 2e-4 (relative) lower, so α is gated at 10% relative and the cost and
# PSNR carry the parity; the 1e-3 band (float32 and float64 JAX runs agree
# to 3e-5) is reported separately.
TGV_ALPHA = (0.085226, 0.044170)
TGV_ALPHA_GATE_REL = 0.10
TGV_ALPHA_BAND_REL = 1e-3
TGV_PSNR = 28.1009
TGV_PSNR_GATE = 0.01       # dB
TGV_COST = 130.1344
TGV_COST_GATE_REL = 1e-3
# patch TGV learn reference ((2, 2, 2) stack, β₂ = 1.5), same source
TGV_PATCH_PSNR = 28.1077
TGV_PATCH_COST = 129.8615
TGV_PATCH_A1 = ((0.09146, 0.09851), (0.07646, 0.08766))
TGV_PATCH_A0 = ((0.04659, 0.04462), (0.04396, 0.04232))

# float32, TGV kernel: the kernel divides by √2 where the plain version's
# CUDA division by a host scalar multiplies by its reciprocal, and sums the
# early-stop norms in another order, so the iterations differ by rounding
# each step.  u contracts (strongly convex data term) and is held like
# kernel A's u; w, p and q follow a non-expansive iteration whose solution
# is not unique on flat regions, so rounding differences persist: held to
# 1e-3 absolute (p, q are bounded by α₁ ≈ 0.09, α₀ ≈ 0.04).  A fault in a
# stencil or a projection moves them by 1e-2 or more.
TOL_TGV_U_F32 = 1e-4
TOL_TGV_DUAL_F32 = 1e-3

# peak rates of an H100 SXM (NVIDIA data sheet) for the bounds
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# operations per pixel, counted from the kernels' arithmetic
A_OPS_PER_PIXEL_ITER = 24
B_OPS_PER_PIXEL_CG_ITER = 40
B_OPS_PER_PIXEL_SOLVE = 36      # CG start: W·Gp, Mp, r, z, d, three sums
B_OPS_PER_PIXEL_FIXED = 47      # set-up, diagonal, right-hand side, gradient
TGV_OPS_PER_PIXEL_ITER = 70     # 29 primal + 41 dual (csrc/tgv.cu)


def say(msg):
    print(msg, flush=True)


def max_abs(a, b):
    return float((a.double() - b.double()).abs().max())


def rel_err(a, b):
    scale = float(b.double().abs().max())
    return max_abs(a, b) / (scale if scale > 0 else 1.0)


def require(ok, msg):
    if not ok:
        raise AssertionError(msg)


def cuda_timer(torch):
    def timed(fn):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        return out, start.elapsed_time(end)
    return timed


def bound_ms(nbytes, ops, ops_per_s=F32_OPS_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_kernel_a(f, timed, *, maxiter=5000, tol=5e-6, check_every=50,
                   alpha=0.1, alpha_warm=0.0698, tol_u=TOL_A_U_F32,
                   tol_y=TOL_A_Y_F32):
    """Kernel A against plain A: cold fixed budget, cold with early stop
    and state, warm from that state.  All three are compared and printed
    before the phase fails on any of them.  Returns (state u, stats)."""
    import torch
    from bpldenoising_tpu_torch.models import tv_model
    from bpldenoising_tpu_torch.solvers import pdps_cuda
    from bpldenoising_tpu_torch.solvers.pdps import _denoise_pdps_impl

    model = tv_model()
    kw = dict(model=model, tau0=5.0, sigma0=0.99 / 5.0, gamma=1.0,
              accel=True)
    a = (torch.tensor(alpha, dtype=f.dtype),)
    a_warm = (torch.tensor(alpha_warm, dtype=f.dtype),)
    worst = 0.0
    faults = []

    def both(alphas, state0, **extra):
        k_out, k_ms = timed(lambda: pdps_cuda.denoise_pdps_cuda(
            f, alphas, state0, **kw, **extra))
        p_out, p_ms = timed(lambda: _denoise_pdps_impl(
            f, alphas, state0, **kw, **extra))
        return k_out, k_ms, p_out, p_ms

    def check(label, ku, pu, kys=None, pys=None, kit=None, pit=None):
        nonlocal worst
        err_u = max_abs(ku, pu)
        err_y = max_abs(kys[0], pys[0]) if kys is not None else 0.0
        worst = max(worst, err_u, err_y)
        if err_u > tol_u or err_y > tol_y:
            faults.append(f"{label}: max|du| {err_u}, max|dy| {err_y}")
        if kit is not None and abs(kit - pit) > check_every:
            faults.append(f"{label}: iterations {kit} vs {pit}")
        return f"max|du| {err_u:.2e}, max|dy| {err_y:.2e}"

    # 1: cold, fixed budget; a warm-up call first so the timing excludes
    # the library load
    pdps_cuda.denoise_pdps_cuda(f, a, None, **kw, maxiter=10, tol=None,
                                check_every=check_every, return_dual=True)
    (ku, kys, _), k_ms, (pu, pys, _), p_ms = both(
        a, None, maxiter=maxiter, tol=None, check_every=check_every,
        return_dual=True)
    say(f"  A cold {maxiter} it: {check('cold', ku, pu, kys, pys)}; "
        f"kernel {k_ms:.2f} ms, plain {p_ms:.2f} ms")
    cold = dict(ms=k_ms, plain_ms=p_ms, iters=maxiter)

    # 2: cold with early stop, returning the state
    (ku, kys, kit), k_ms, (pu, pys, pit), p_ms = both(
        a, None, maxiter=maxiter, tol=tol, check_every=check_every,
        return_dual=True)
    msg = check("cold early stop", ku, pu, kys, pys, kit, pit)
    say(f"  A cold tol {tol:g}: iters {kit}/{pit}, {msg}; "
        f"kernel {k_ms:.2f} ms, plain {p_ms:.2f} ms")

    # 3: warm from the plain version's state, early stop
    state = (pu, pys)
    (wu, wys, wit), k_ms, (qu, qys, qit), p_ms = both(
        a_warm, state, maxiter=maxiter, tol=tol, check_every=check_every,
        return_dual=True)
    msg = check("warm early stop", wu, qu, wys, qys, wit, qit)
    say(f"  A warm tol {tol:g}: iters {wit}/{qit}, {msg}; "
        f"kernel {k_ms:.2f} ms, plain {p_ms:.2f} ms")
    say(f"  A tolerances: u {tol_u:g}, y {tol_y:g} (absolute)")
    require(not faults, "kernel A disagrees with plain: " + "; ".join(faults))
    return pu, dict(cold, max_abs_err=worst)


def phase_kernel_b(u, utrue, timed, *, alpha=0.1, rtol=TOL_B_F32_REL):
    """Kernel B (exact and regularized) against plain B."""
    import torch
    from bpldenoising_tpu_torch.models import tv_model
    from bpldenoising_tpu_torch.solvers import hypergrad_cuda
    from bpldenoising_tpu_torch.solvers.hypergrad import (
        HypergradConfig, exact_hypergrad, reg_hypergrad)

    model = tv_model()
    cfg = HypergradConfig(al_iters=2, cg_maxiter=100)
    a = (torch.tensor(alpha, dtype=u.dtype),)
    out = {}
    worst = 0.0
    faults = []
    for name, kern, plain in (
            ("exact", hypergrad_cuda.exact_hypergrad_cuda, exact_hypergrad),
            ("reg", hypergrad_cuda.reg_hypergrad_cuda, reg_hypergrad)):
        kern(u, utrue, a, model, cfg)   # warm-up
        (kg, kp, ki), k_ms = timed(lambda: kern(u, utrue, a, model, cfg))
        total = hypergrad_cuda.last_total_cg_iters
        (pg, pp, pi), p_ms = timed(lambda: plain(u, utrue, a, model, cfg))
        g_err = abs(float(kg[0]) - float(pg[0])) / max(abs(float(pg[0])),
                                                        1e-30)
        p_err = rel_err(kp, pp)
        worst = max(worst, max_abs(kp, pp))
        say(f"  B {name}: grad {float(kg[0]):.6e}/{float(pg[0]):.6e} "
            f"rel {g_err:.2e}, p rel {p_err:.2e} (tol {rtol:g}), CG "
            f"{ki.iters}/{pi.iters}; kernel {k_ms:.2f} ms, plain "
            f"{p_ms:.2f} ms")
        if g_err > rtol or p_err > rtol:
            faults.append(f"{name}: grad rel {g_err}, p rel {p_err}")
        if abs(ki.iters - pi.iters) > 1:
            faults.append(f"{name}: CG iterations {ki.iters} vs {pi.iters}")
        out[name] = dict(ms=k_ms, plain_ms=p_ms, total_cg=total)
    require(not faults, "kernel B disagrees with plain: " + "; ".join(faults))
    out["max_abs_err"] = worst
    return out


def phase_f64(torch, device):
    """Both kernels in float64 at a small shape.  Kernel B gets a
    piecewise-constant image with a ramp, whose pixel gradients are zero or
    well above the active-set threshold, so its systems are well
    conditioned and CG agrees to rounding (on an ill-conditioned system CG
    amplifies rounding, as the CPU tests document)."""
    from bpldenoising_tpu_torch.models import tv_model
    from bpldenoising_tpu_torch.solvers import hypergrad_cuda, pdps_cuda
    from bpldenoising_tpu_torch.solvers.hypergrad import (
        HypergradConfig, exact_hypergrad, reg_hypergrad)
    from bpldenoising_tpu_torch.solvers.pdps import _denoise_pdps_impl

    f64 = torch.float64
    gen = torch.Generator().manual_seed(0)
    clean = torch.zeros((2, 32, 32), dtype=f64)
    clean[:, 8:24, 8:24] = 1.0
    f = (clean + 0.1 * torch.randn(clean.shape, generator=gen,
                                   dtype=f64)).to(device)
    model = tv_model()
    a = (torch.tensor(0.07, dtype=f64),)
    kw = dict(model=model, tau0=5.0, sigma0=0.99 / 5.0, gamma=1.0,
              accel=True, maxiter=2000, tol=1e-7, check_every=50,
              return_dual=True)
    ku, kys, kit = pdps_cuda.denoise_pdps_cuda(f, a, None, **kw)
    pu, pys, pit = _denoise_pdps_impl(f, a, None, **kw)
    err_u, err_y = rel_err(ku, pu), rel_err(kys[0], pys[0])

    levels = torch.rand((2, 8, 8), generator=gen, dtype=f64)
    u = torch.kron(levels, torch.ones((4, 4), dtype=f64))
    u[:, 24:, :] += 0.3 * torch.linspace(0.0, 1.0, 32, dtype=f64)
    utrue = u + 0.05 * torch.randn(u.shape, generator=gen, dtype=f64)
    u, utrue = u.to(device), utrue.to(device)
    errs_b = []
    its = []
    for kern, plain, cfg in (
            (hypergrad_cuda.exact_hypergrad_cuda, exact_hypergrad,
             HypergradConfig(al_iters=2, cg_maxiter=300)),
            (hypergrad_cuda.reg_hypergrad_cuda, reg_hypergrad,
             HypergradConfig(cg_maxiter=300, gamma=1e4))):
        kg, kp, ki = kern(u, utrue, a, model, cfg)
        pg, pp, pi = plain(u, utrue, a, model, cfg)
        errs_b.append(abs(float(kg[0]) - float(pg[0]))
                      / max(abs(float(pg[0])), 1e-30))
        errs_b.append(rel_err(kp, pp))
        its.append((ki.iters, pi.iters))
    say(f"  float64 2x32x32: A iters {kit}/{pit} rel u {err_u:.2e} y "
        f"{err_y:.2e}; B rel {max(errs_b):.2e}, CG {its} "
        f"(tol {TOL_F64_REL:g})")
    require(kit == pit, f"float64 kernel A: iterations {kit} vs {pit}")
    require(max(err_u, err_y, *errs_b) <= TOL_F64_REL,
            f"float64 rel err u {err_u}, y {err_y}, B {errs_b}")
    require(all(abs(k - p) <= 1 for k, p in its),
            f"float64 kernel B: CG iterations {its}")


def tgv_errors(k_out, p_out):
    """Max abs error of each of u, w, p, q (kernel vs plain)."""
    (_, _, kst, _), (_, _, pst, _) = k_out, p_out
    return [max_abs(k, p) for k, p in zip(kst, pst)]


def phase_tgv(f, timed, *, maxiter=5000, tol=3e-6, check_every=100):
    """The TGV² kernel against plain TGV², scalar and map weights: cold
    fixed budget, cold with early stop and state, warm from that state at
    nudged weights.  Everything is compared and printed before the phase
    fails.  Returns the stats of the scalar cold call."""
    import torch
    from bpldenoising_tpu_torch.ops import PatchOp
    from bpldenoising_tpu_torch.solvers import tgv_cuda
    from bpldenoising_tpu_torch.solvers.tgv import _tgv_impl

    dt = f.dtype
    pop = PatchOp((2, 2), tuple(f.shape[-2:]))
    grid1 = torch.tensor(TGV_PATCH_A1, dtype=dt)
    grid0 = torch.tensor(TGV_PATCH_A0, dtype=dt)
    weights = {
        "scalar": ((TGV_ALPHA[0], TGV_ALPHA[1]),
                   (1.05 * TGV_ALPHA[0], 0.95 * TGV_ALPHA[1])),
        "map": ((pop.apply(grid1).to(f.device), pop.apply(grid0).to(f.device)),
                (pop.apply(1.05 * grid1).to(f.device),
                 pop.apply(0.95 * grid0).to(f.device))),
    }
    worst = 0.0
    faults = []
    out = {}

    def both(a, state0, **kw):
        k_out, k_ms = timed(lambda: tgv_cuda.tgv_denoise_pdps_cuda(
            f, *a, state0=state0, return_state=True, **kw))
        p_out, p_ms = timed(lambda: _tgv_impl(
            f, *a, state0, tau0=0.99, sigma0=0.99, return_state=True, **kw))
        return k_out, k_ms, p_out, p_ms

    def check(label, k_out, p_out, iters=False):
        nonlocal worst
        errs = tgv_errors(k_out, p_out)
        worst = max(worst, *errs)
        if errs[0] > TOL_TGV_U_F32 or max(errs[1:]) > TOL_TGV_DUAL_F32:
            faults.append(f"{label}: max|d(u,w,p,q)| {errs}")
        if iters and k_out[3] != p_out[3]:
            faults.append(f"{label}: iterations {k_out[3]} vs {p_out[3]}")
        return ("max|du| {:.2e}, |dw| {:.2e}, |dp| {:.2e}, |dq| {:.2e}"
                .format(*errs))

    tgv_cuda.tgv_denoise_pdps_cuda(f, *weights["scalar"][0], maxiter=10)
    for kind, (a, a_warm) in weights.items():
        k_out, k_ms, p_out, p_ms = both(a, None, maxiter=maxiter, tol=None,
                                        check_every=check_every)
        say(f"  TGV {kind} cold {maxiter} it: {check(kind, k_out, p_out)}; "
            f"kernel {k_ms:.2f} ms, plain {p_ms:.2f} ms")
        out[kind] = dict(ms=k_ms, plain_ms=p_ms, iters=maxiter,
                         u=k_out[0])
        k_out, k_ms, p_out, p_ms = both(a, None, maxiter=maxiter, tol=tol,
                                        check_every=check_every)
        msg = check(f"{kind} early stop", k_out, p_out, iters=True)
        say(f"  TGV {kind} cold tol {tol:g}: iters {k_out[3]}/{p_out[3]}, "
            f"{msg}; kernel {k_ms:.2f} ms, plain {p_ms:.2f} ms")
        state = p_out[2]
        k_out, k_ms, p_out, p_ms = both(a_warm, state, maxiter=maxiter,
                                        tol=tol, check_every=check_every)
        msg = check(f"{kind} warm", k_out, p_out, iters=True)
        say(f"  TGV {kind} warm tol {tol:g}: iters {k_out[3]}/{p_out[3]}, "
            f"{msg}; kernel {k_ms:.2f} ms, plain {p_ms:.2f} ms")
    # a constant map is the scalar weight, bit for bit
    const = tuple(torch.full(tuple(f.shape[-2:]), v, dtype=dt,
                             device=f.device) for v in TGV_ALPHA)
    cu, _ = tgv_cuda.tgv_denoise_pdps_cuda(f, *const, maxiter=maxiter)
    same = bool(torch.equal(cu, out["scalar"]["u"]))
    say(f"  TGV constant map == scalar weights: {same}; tolerances u "
        f"{TOL_TGV_U_F32:g}, w/p/q {TOL_TGV_DUAL_F32:g} (absolute)")
    if not same:
        faults.append("a constant map differs from the scalar weights")
    require(not faults, "TGV kernel disagrees with plain: "
            + "; ".join(faults))
    return dict(out["scalar"], max_abs_err=worst)


def phase_tgv_f64(torch, device):
    """The TGV² kernel in float64 at 2 × 32²: cold with early stop (scalar
    weights), cold fixed budget (map weights), warm from the first state."""
    from bpldenoising_tpu_torch.solvers import tgv_cuda
    from bpldenoising_tpu_torch.solvers.tgv import _tgv_impl

    f64 = torch.float64
    gen = torch.Generator().manual_seed(1)
    yy, xx = torch.meshgrid(torch.arange(32, dtype=f64),
                            torch.arange(32, dtype=f64), indexing="ij")
    clean = torch.stack([0.02 * xx + (yy > 16).to(f64),
                         0.03 * yy + (((xx - 16) ** 2 + (yy - 12) ** 2)
                                      < 60).to(f64)])
    f = (clean + 0.1 * torch.randn(clean.shape, generator=gen,
                                   dtype=f64)).to(device)
    amap = (0.05 + 0.1 * torch.rand((32, 32), generator=gen,
                                    dtype=f64)).to(device)
    runs = (("scalar tol", (0.1, 0.05), None,
             dict(maxiter=3000, tol=1e-5, check_every=50)),
            ("map fixed", (amap, 0.05), None,
             dict(maxiter=1000, tol=None, check_every=50)),
            ("scalar warm", (0.11, 0.045), "first",
             dict(maxiter=3000, tol=1e-5, check_every=50)))
    errs, its = [], []
    first = None
    for label, a, warm, kw in runs:
        state0 = first if warm else None
        k = tgv_cuda.tgv_denoise_pdps_cuda(f, *a, state0=state0,
                                           return_state=True, **kw)
        p = _tgv_impl(f, *a, state0, tau0=0.99, sigma0=0.99,
                      return_state=True, **kw)
        first = first or p[2]
        errs.append(max(rel_err(ks, ps) for ks, ps in zip(k[2], p[2])))
        its.append((k[3], p[3]))
    say(f"  TGV float64 2x32x32: rel err {['%.2e' % e for e in errs]}, "
        f"iters {its} (tol {TOL_F64_REL:g})")
    require(all(kit == pit for kit, pit in its),
            f"float64 TGV: iterations {its}")
    require(max(errs) <= TOL_F64_REL, f"float64 TGV rel err {errs}")


def phase_large(f, timed):
    """The shapes the TPU sends to its row-tiled kernels: TGV² at 1 × 1024²
    and kernel A at 1 × 2048², 1000 iterations each (bench.py's tiling of
    the first faces image)."""
    import torch
    from bpldenoising_tpu_torch.models import tv_model
    from bpldenoising_tpu_torch.solvers import pdps_cuda, tgv_cuda
    from bpldenoising_tpu_torch.solvers.pdps import _denoise_pdps_impl
    from bpldenoising_tpu_torch.solvers.tgv import _tgv_impl

    out = {}
    img = f[:1].repeat(1, 8, 8).contiguous()
    kw = dict(maxiter=1000, tol=None, check_every=100)
    tgv_cuda.tgv_denoise_pdps_cuda(img, 0.1, 0.2, maxiter=5)
    k_out, k_ms = timed(lambda: tgv_cuda.tgv_denoise_pdps_cuda(
        img, 0.1, 0.2, return_state=True, **kw))
    p_out, p_ms = timed(lambda: _tgv_impl(img, 0.1, 0.2, None, tau0=0.99,
                                          sigma0=0.99, return_state=True,
                                          **kw))
    errs = tgv_errors(k_out, p_out)
    say("  TGV 1x1024x1024, 1000 it: max|du| {:.2e}, |dw| {:.2e}, |dp| "
        "{:.2e}, |dq| {:.2e}; ".format(*errs)
        + f"kernel {k_ms:.2f} ms, plain {p_ms:.2f} ms")
    require(errs[0] <= TOL_TGV_U_F32 and max(errs[1:]) <= TOL_TGV_DUAL_F32,
            f"TGV 1024^2 kernel disagrees with plain: {errs}")
    nbytes = 9 * img.numel() * img.element_size()   # f in; 8 planes out
    bound, by = bound_ms(nbytes, TGV_OPS_PER_PIXEL_ITER * img.numel() * 1000)
    out["tgv_1024"] = dict(ms=k_ms, plain_ms=p_ms, max_abs_err=max(errs),
                           bound_ms=bound, bound_by=by)

    img = f[:1].repeat(1, 16, 16).contiguous()
    kw = dict(model=tv_model(), tau0=5.0, sigma0=0.99 / 5.0, gamma=1.0,
              accel=True, maxiter=1000, tol=None, check_every=50,
              return_dual=True)
    a = (torch.tensor(0.1, dtype=img.dtype),)
    pdps_cuda.denoise_pdps_cuda(img, a, None, **dict(kw, maxiter=5))
    (ku, kys, _), k_ms = timed(lambda: pdps_cuda.denoise_pdps_cuda(
        img, a, None, **kw))
    (pu, pys, _), p_ms = timed(lambda: _denoise_pdps_impl(img, a, None,
                                                         **kw))
    err_u, err_y = max_abs(ku, pu), max_abs(kys[0], pys[0])
    say(f"  A 1x2048x2048, 1000 it: max|du| {err_u:.2e}, max|dy| "
        f"{err_y:.2e}; kernel {k_ms:.2f} ms, plain {p_ms:.2f} ms")
    require(err_u <= TOL_A_U_F32 and err_y <= TOL_A_Y_F32,
            f"kernel A at 2048^2 disagrees with plain: {err_u}, {err_y}")
    nbytes = 4 * img.numel() * img.element_size()   # f in; u, y out
    bound, by = bound_ms(nbytes, A_OPS_PER_PIXEL_ITER * img.numel() * 1000)
    out["pdps_2048"] = dict(ms=k_ms, plain_ms=p_ms,
                            max_abs_err=max(err_u, err_y), bound_ms=bound,
                            bound_by=by)
    return out


def reset_launches():
    from bpldenoising_tpu_torch.solvers import (hypergrad_cuda, pdps_cuda,
                                                tgv_cuda)
    for mod in (pdps_cuda, hypergrad_cuda, tgv_cuda):
        mod.launches = 0


def read_launches():
    from bpldenoising_tpu_torch.solvers import (hypergrad_cuda, pdps_cuda,
                                                tgv_cuda)
    return dict(pdps=pdps_cuda.launches, hypergrad=hypergrad_cuda.launches,
                tgv=tgv_cuda.launches)


def tgv_learn_kwargs():
    return dict(dataset_name="faces_train", num_samples=10,
                method="tr_fused", dtype="float32", maxiter=20, tol=1e-5,
                inner_maxiter=5000, inner_tol=3e-6, check_every=100)


def phase_tgv_learn(utrue, timed):
    import torch
    from bpldenoising_tpu_torch.experiments.tgv import \
        scalar_bilevel_tgv_learn
    from bpldenoising_tpu_torch.metrics import psnr

    kw = tgv_learn_kwargs()
    scalar_bilevel_tgv_learn(device="cuda", **kw)          # warm-up
    reset_launches()
    res, wall_ms = timed(lambda: scalar_bilevel_tgv_learn(device="cuda",
                                                          **kw))
    launches = read_launches()
    alpha = [float(v) for v in res.x]
    rel = [abs(a - r) / r for a, r in zip(alpha, TGV_ALPHA)]
    mean_psnr = float(torch.mean(psnr(utrue, res.u)))
    cost = float(res.cost)
    cg = res.log[:, 4]
    say(f"  alpha {alpha[0]:.6f}, {alpha[1]:.6f} |d| "
        f"{abs(alpha[0] - TGV_ALPHA[0]):.2e}, "
        f"{abs(alpha[1] - TGV_ALPHA[1]):.2e} rel {rel[0]:.2e}, {rel[1]:.2e} "
        f"(gate {TGV_ALPHA_GATE_REL:g}, band {TGV_ALPHA_BAND_REL:g}: "
        f"{'in' if max(rel) <= TGV_ALPHA_BAND_REL else 'out'}); PSNR "
        f"{mean_psnr:.4f} dB; cost {cost:.4f}; {res.iterations} outer its; "
        f"adjoint CG {int(cg.sum())} its over the logged evaluations, "
        f"unconverged (capped) in {int((res.log[:, 5] < 0.5).sum())} of "
        f"{res.iterations}")
    say(f"  wall {wall_ms:.1f} ms (CUDA events, after one warm-up run); "
        f"launches {launches}")
    require(launches["tgv"] > 0, f"TGV learn launched {launches}")
    require(max(rel) <= TGV_ALPHA_GATE_REL, f"TGV alpha {alpha}")
    require(abs(mean_psnr - TGV_PSNR) <= TGV_PSNR_GATE,
            f"TGV mean PSNR {mean_psnr}")
    require(abs(cost - TGV_COST) <= TGV_COST_GATE_REL * TGV_COST,
            f"TGV final cost {cost}")
    return dict(alpha=alpha, alpha_rel_err=rel, mean_psnr_db=mean_psnr,
                final_cost=cost, outer_iterations=res.iterations,
                adjoint_cg_iters=int(cg.sum()), wall_ms=wall_ms,
                launches=launches)


def phase_tgv_patch_learn(utrue, timed):
    import numpy as np
    import torch
    from bpldenoising_tpu_torch.experiments.tgv import \
        patch_bilevel_tgv_learn
    from bpldenoising_tpu_torch.metrics import psnr

    kw = tgv_learn_kwargs()
    reset_launches()
    res, wall_ms = timed(lambda: patch_bilevel_tgv_learn(device="cuda",
                                                         **kw))
    launches = read_launches()
    mean_psnr = float(torch.mean(psnr(utrue, res.u)))
    cost = float(res.cost)
    np.set_printoptions(precision=5)
    say(f"  alpha1 grid {res.x[..., 0].tolist()} (reference "
        f"{[list(r) for r in TGV_PATCH_A1]})")
    say(f"  alpha0 grid {res.x[..., 1].tolist()} (reference "
        f"{[list(r) for r in TGV_PATCH_A0]})")
    say(f"  PSNR {mean_psnr:.4f} dB; cost {cost:.4f}; {res.iterations} "
        f"outer its; adjoint CG {int(res.log[:, 4].sum())} its; wall "
        f"{wall_ms:.1f} ms; launches {launches}")
    require(launches["tgv"] > 0, f"patch TGV learn launched {launches}")
    require(abs(mean_psnr - TGV_PATCH_PSNR) <= TGV_PSNR_GATE,
            f"patch TGV mean PSNR {mean_psnr}")
    require(abs(cost - TGV_PATCH_COST) <= TGV_COST_GATE_REL * TGV_PATCH_COST,
            f"patch TGV final cost {cost}")
    return dict(alpha=res.x.tolist(), mean_psnr_db=mean_psnr,
                final_cost=cost, outer_iterations=res.iterations,
                wall_ms=wall_ms, launches=launches)


def flagship_kwargs():
    from bpldenoising_tpu_torch.solvers.hypergrad import HypergradConfig
    return dict(dataset_name="faces_train", num_samples=10,
                method="tr_fused", dtype="float32", maxiter=20, tol=1e-5,
                alpha0=0.1, inner_maxiter=5000, inner_tol=5e-6,
                check_every=50,
                hypergrad_cfg=HypergradConfig(al_iters=2, cg_maxiter=100))


def main():
    faulthandler.dump_traceback_later(DEADLINE_S, exit=True)
    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    from bpldenoising_tpu_torch import _build
    from bpldenoising_tpu_torch.data import testdataset
    from bpldenoising_tpu_torch.experiments.api import scalar_bilevel_tv_learn
    from bpldenoising_tpu_torch.metrics import psnr

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    say(f"phase 1 device: {kind}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.device_count()} card(s)")
    say(smi)

    info = _build.build()
    _build.library()
    say(f"phase 2 build: {info.seconds:.1f} s ({info.path.name})")

    timed = cuda_timer(torch)
    true_np, noisy_np = testdataset("faces_train_128_10")
    utrue = torch.as_tensor(true_np, dtype=torch.float32).to(dev)
    f = torch.as_tensor(noisy_np, dtype=torch.float32).to(dev)
    n = f.numel()

    say("phase 3 kernel A vs plain, 10x128x128 float32")
    u_state, a_stats = phase_kernel_a(f, timed)

    say("phase 4 kernel B vs plain, 10x128x128 float32")
    b_stats = phase_kernel_b(u_state, utrue, timed)
    phase_f64(torch, dev)

    say("phase 5 flagship scalar_bilevel_tv_learn(method='tr_fused')")
    kw = flagship_kwargs()
    scalar_bilevel_tv_learn(device="cuda", **kw)          # warm-up
    t0 = time.perf_counter()
    testdataset("faces_train_128_10")
    load_ms = (time.perf_counter() - t0) * 1e3
    reset_launches()
    res, wall_ms = timed(lambda: scalar_bilevel_tv_learn(device="cuda",
                                                         **kw))
    counts = read_launches()
    launches_a, launches_b = counts["pdps"], counts["hypergrad"]
    alpha = float(res.x)
    d_alpha = abs(alpha - FLAGSHIP_ALPHA)
    mean_psnr = float(torch.mean(psnr(utrue, res.u)))
    cost = float(res.cost)
    cg_cap = bool(res.log[:, 5].min() < 0.5) if res.iterations else False
    say(f"  alpha {alpha:.6f} |d| {d_alpha:.2e} (gate {ALPHA_GATE:g}, "
        f"band {ALPHA_BAND:g}: {'in' if d_alpha <= ALPHA_BAND else 'out'}); "
        f"PSNR {mean_psnr:.4f} dB; cost {cost:.4f}; "
        f"{res.iterations} outer its; CG capped: {cg_cap}")
    say(f"  wall {wall_ms:.1f} ms (CUDA events, after one warm-up run; "
        f"the PNG load in it takes ~{load_ms:.1f} ms on the host); "
        f"launches {counts}")
    require(launches_a > 0 and launches_b > 0,
            f"main path launched A {launches_a}, B {launches_b} times")
    require(d_alpha <= ALPHA_GATE, f"alpha {alpha} off by {d_alpha}")
    require(abs(mean_psnr - FLAGSHIP_PSNR) <= PSNR_GATE,
            f"mean PSNR {mean_psnr}")
    require(abs(cost - FLAGSHIP_COST) <= COST_GATE_REL * FLAGSHIP_COST,
            f"final cost {cost}")

    say("phase 6 TGV kernel vs plain, 10x128x128 float32")
    tgv_stats = phase_tgv(f, timed)
    phase_tgv_f64(torch, dev)

    say("phase 7 large images vs plain, float32")
    large = phase_large(f, timed)

    say("phase 8 TGV learn scalar_bilevel_tgv_learn(method='tr_fused')")
    tgv_learn = phase_tgv_learn(utrue, timed)

    say("phase 9 patch TGV learn patch_bilevel_tgv_learn(method='tr_fused')")
    tgv_patch = phase_tgv_patch_learn(utrue, timed)

    itemsize = 4
    a_bytes = 4 * n * itemsize                  # f in; u, y out
    a_ops = A_OPS_PER_PIXEL_ITER * n * a_stats["iters"]
    a_bound, a_by = bound_ms(a_bytes, a_ops)
    ex = b_stats["exact"]
    b_bytes = 4 * n * itemsize                  # u, ū, p0 in; p out
    b_ops = n * (B_OPS_PER_PIXEL_CG_ITER * ex["total_cg"]
                 + B_OPS_PER_PIXEL_SOLVE * 2 + B_OPS_PER_PIXEL_FIXED)
    b_bound, b_by = bound_ms(b_bytes, b_ops)
    # TGV cold call: f in; the state (u, w, p, q: 8 planes) out
    t_bytes = 9 * n * itemsize
    t_ops = TGV_OPS_PER_PIXEL_ITER * n * tgv_stats["iters"]
    t_bound, t_by = bound_ms(t_bytes, t_ops)
    kernels = [
        dict(name="pdps_cp_tv", route="cuda",
             source="bpldenoising_tpu_torch/csrc/pdps.cu",
             replaces="bpldenoising_tpu/solvers/pdps_pallas.py:234",
             launches=launches_a, max_abs_err=a_stats["max_abs_err"],
             ms=a_stats["ms"], plain_ms=a_stats["plain_ms"],
             bound_ms=a_bound, bound_by=a_by, library_ms=None),
        dict(name="hypergrad_al_pcg", route="cuda",
             source="bpldenoising_tpu_torch/csrc/hypergrad.cu",
             replaces="bpldenoising_tpu/solvers/hypergrad_pallas.py:47",
             launches=launches_b, max_abs_err=b_stats["max_abs_err"],
             ms=ex["ms"], plain_ms=ex["plain_ms"], bound_ms=b_bound,
             bound_by=b_by, library_ms=None),
        dict(name="tgv_cp", route="cuda",
             source="bpldenoising_tpu_torch/csrc/tgv.cu",
             replaces="bpldenoising_tpu/solvers/tgv_pallas.py:103 and :217",
             launches=tgv_learn["launches"]["tgv"],
             max_abs_err=tgv_stats["max_abs_err"], ms=tgv_stats["ms"],
             plain_ms=tgv_stats["plain_ms"], bound_ms=t_bound, bound_by=t_by,
             library_ms=None),
    ]
    say(f"  total {time.perf_counter() - t_start:.1f} s")
    say(json.dumps({"kernels": kernels, "flagship": dict(
        alpha=alpha, alpha_abs_err=d_alpha, mean_psnr_db=mean_psnr,
        final_cost=cost, outer_iterations=res.iterations,
        wall_ms=wall_ms, load_ms=load_ms), "tgv_learn": tgv_learn,
        "tgv_patch_learn": tgv_patch, "large_images": large, "device": smi}))
    faulthandler.cancel_dump_traceback_later()
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
