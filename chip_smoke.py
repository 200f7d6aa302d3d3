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

# peak rates of an H100 SXM (NVIDIA data sheet) for the bounds
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# operations per pixel, counted from the kernels' arithmetic
A_OPS_PER_PIXEL_ITER = 24
B_OPS_PER_PIXEL_CG_ITER = 40
B_OPS_PER_PIXEL_SOLVE = 36      # CG start: W·Gp, Mp, r, z, d, three sums
B_OPS_PER_PIXEL_FIXED = 47      # set-up, diagonal, right-hand side, gradient


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

    # 1: cold, fixed budget; a warm-up call first so the timing excludes
    # the library load
    pdps_cuda.denoise_pdps_cuda(f, a, None, **kw, maxiter=10, tol=None,
                                check_every=check_every, return_dual=False)
    ku, k_ms, pu, p_ms = both(a, None, maxiter=maxiter, tol=None,
                              check_every=check_every, return_dual=False)
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
    from bpldenoising_tpu_torch.solvers import hypergrad_cuda, pdps_cuda

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
    pdps_cuda.launches = 0
    hypergrad_cuda.launches = 0
    res, wall_ms = timed(lambda: scalar_bilevel_tv_learn(device="cuda",
                                                         **kw))
    launches_a = pdps_cuda.launches
    launches_b = hypergrad_cuda.launches
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
        f"launches A {launches_a}, B {launches_b}")
    require(launches_a > 0 and launches_b > 0,
            f"main path launched A {launches_a}, B {launches_b} times")
    require(d_alpha <= ALPHA_GATE, f"alpha {alpha} off by {d_alpha}")
    require(abs(mean_psnr - FLAGSHIP_PSNR) <= PSNR_GATE,
            f"mean PSNR {mean_psnr}")
    require(abs(cost - FLAGSHIP_COST) <= COST_GATE_REL * FLAGSHIP_COST,
            f"final cost {cost}")

    itemsize = 4
    a_bytes = 4 * n * itemsize                  # f in; u, y out
    a_ops = A_OPS_PER_PIXEL_ITER * n * a_stats["iters"]
    a_bound, a_by = bound_ms(a_bytes, a_ops)
    ex = b_stats["exact"]
    b_bytes = 4 * n * itemsize                  # u, ū, p0 in; p out
    b_ops = n * (B_OPS_PER_PIXEL_CG_ITER * ex["total_cg"]
                 + B_OPS_PER_PIXEL_SOLVE * 2 + B_OPS_PER_PIXEL_FIXED)
    b_bound, b_by = bound_ms(b_bytes, b_ops)
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
    ]
    say(f"  total {time.perf_counter() - t_start:.1f} s")
    say(json.dumps({"kernels": kernels, "flagship": dict(
        alpha=alpha, alpha_abs_err=d_alpha, mean_psnr_db=mean_psnr,
        final_cost=cost, outer_iterations=res.iterations,
        wall_ms=wall_ms, load_ms=load_ms, device=smi)}))
    faulthandler.cancel_dump_traceback_later()
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
