#!/usr/bin/env python3
"""The cluster size of a kernel family's band kernel, measured on one
NVIDIA GPU.

    python3 scripts/cluster_sizes.py FAMILY

The band kernels (``csrc/pd_cluster.cuh``, ``tgv_cluster.cuh``,
``vtv_cluster.cuh``) run one thread-block cluster an image; each family's
plan (``solvers/cluster_plan.py``) picks the CTAs an image.  This script
forces other sizes and times them.  FAMILY is one of:

CP solves (one launch per early-stop chunk; each call timed with CUDA
events three times after one 20-iteration warm-up call under the same
plan, the median and the spread printed with the iteration count, the
device operations (launches and copies) and whether the state has the
bits of the first cluster plan's; a plan the card refuses is printed as
refused):

- ``kernel_a``: kernel A (``csrc/pdps.cu``, TPU rows 1 and 3) on
  ``faces_train_128_10`` (10 × 128² float32) in its three forms of the
  main paths (K = 1 scalar, an (M, N) α map, K = 3 forward / backward /
  centred), a cold 5000-iteration call and a cold call with the early stop
  (tol 5e-6, every 50 iterations), under the two-launch form and 4, 8
  (``pd_plan``'s rule) and 16 CTAs an image, in the order two-launch, 8,
  16, 4, 8, two-launch.
- ``tvl1``: the TV-L1 kernel (``csrc/tvl1.cu``, rows 7–8) on
  ``circle_sp_128_20`` (one 128² float32 image): the Huber form at α 1.9
  (γ_d 100, γ_r 1000) cold 2000 iterations and with the learns' early stop
  (tol 1e-6, every 100), the plain form at α 0.9 for ``TVL1Denoise``'s
  10,000 iterations and for 2000 on the image repeated 64 times, under the
  two-launch form and 4, 8 and 16 CTAs (two-launch, 8, 16, 4, 8, 16,
  two-launch); then the Huber cold call on 2, 4, 8, 16 and 32 images under
  8 and 16 CTAs (8, 16, 8, 16), where ``tvl1_cuda.tvl1_plan``'s rule
  changes over.
- ``tgv``: the TGV² CP kernel (``csrc/tgv.cu``, rows 4–5) on the first 1,
  all 10 and (repeated) 64 images of ``faces_train_128_10`` at the learns'
  weights (0.085226, 0.044170), cold 5000 iterations and with the learns'
  early stop (tol 3e-6, every 100), under the two-launch form and 8, 12
  and 16 CTAs (two-launch, 8, 16, 12, 8, 16, 12, two-launch; 12 CTAs of 11
  rows put ten images on 120 SMs).
- ``vtv``: the VTV CP kernel (``csrc/vtv.cu``, row 6) on the first 1, all
  6 and (repeated) 64 color images of ``color_disks_128_10`` (3 × 128²
  float32) at α 0.165, cold 5000 iterations and with the learns' early
  stop (tol 1e-5, every 100), under the two-launch form and 8 and 16 CTAs
  (two-launch, 8, 16, 8, 16, two-launch).

Single-loop learners (``single_loop_{tgv,tvl1,vtv}_cuda`` at bench.py's
300 outer steps of 40 CP and 10 CG steps, the CP phase planned at 8 and at
16 CTAs an image, in the order 8, 16, 16, 8; under each plan three calls,
the whole step (300/40/10), without the CG (300/40/0) and without the CP
phase (300/0/10), so that one CP iteration costs ((300/40/10) −
(300/0/10)) / 12,000 and one CG step ((300/40/10) − (300/40/0)) / 3,000;
each timed three times after a 3-step warm-up, the median and the spread
printed and whether α and u have the bits of the first plan's):

- ``tgv_sl``: row 11 on the first 1, 2, 4 and 10 images of
  ``faces_train_128_10`` and the ten repeated to 16, 32 and 64, from
  (0.05, 0.05) at lr 0.02; then, under the rule's plan, its CG blocks
  forced to one partial block and to the same 256 pixels of the three
  planes (``cg_slots`` 1, 3, 3, 1), where the rule changes over.
- ``vtv_sl``: row 13 on the first 1, 2 and 6 images of
  ``color_disks_128_10`` and the six repeated to 16 and 64, from 0.05 at
  lr 0.05; then its CG blocks as row 11's.
- ``tvl1_sl``: row 12 on the first 1, 2, 8 and 16 images of
  ``circle_sp_128_20`` and the twenty repeated to 64, from 0.4 at lr 0.05.

Prints the card's name and power limit first and one JSON line last.
Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

CP_FAMILIES = ("kernel_a", "tvl1", "tgv", "vtv")
SL_FAMILIES = ("tgv_sl", "vtv_sl", "tvl1_sl")
REPEATS = 3
OUTER = 300


def forced(real, shape, slot_rows, n, *, fit=False):
    """``real``'s plan with ``n`` CTAs an image and the rows and band bytes
    that follow (``shape(*args)`` → (M, N, itemsize), ``slot_rows(plan)``
    → the halo-slot rows); ``fit``: the bands in global memory where they
    do not fit in shared memory (the single-loop learners)."""
    from bpldenoising_tpu_torch.solvers import cluster_plan

    def plan(*args, **kw):
        p = real(*args, **kw)
        M, N, itemsize = shape(*args)
        rows = -(-M // n)
        smem = (p.planes * (rows + 4) + slot_rows(p)) * N * itemsize
        if not fit:
            return p._replace(cluster=n, rows=rows, smem=smem)
        fits = smem <= cluster_plan.SMEM_PER_BLOCK
        return p._replace(cluster=n, rows=rows, smem=smem if fits else 0,
                          resident=fits)
    return plan


def pd_shape(M, N, K, itemsize, **_):
    return M, N, itemsize


def pd_slots(p):
    return 8 * (p.planes - 2)          # 16K: p.planes = 2 + 2K


def cp_spec(family, torch, cs):
    """(module, plan attribute, real plan, shape, slot rows, order, calls):
    each call (label, solve() → (state tuple, iterations))."""
    from bpldenoising_tpu_torch.data import testdataset
    from bpldenoising_tpu_torch.solvers import cluster_plan

    if family == "kernel_a":
        from bpldenoising_tpu_torch.models import sumregs_model, tv_model
        from bpldenoising_tpu_torch.solvers import pdps_cuda as mod

        f = torch.as_tensor(testdataset("faces_train_128_10")[1],
                            dtype=torch.float32).cuda()
        amap = cs.random_map(f, 0, 0.05, 0.1)
        kw = dict(tau0=5.0, sigma0=0.99 / 5.0, gamma=1.0, accel=True,
                  return_dual=True)
        calls = []
        for label, model, alphas in (
                ("K=1", tv_model(), (0.1,)), ("map", tv_model(), (amap,)),
                ("K=3", sumregs_model(), cs.sumregs_weights()[0])):
            a = cs.weights(alphas, f)
            for mode, extra in (("cold 5000", dict(maxiter=5000, tol=None,
                                                  check_every=50)),
                                ("early stop", dict(maxiter=5000, tol=5e-6,
                                                    check_every=50))):
                def solve(a=a, model=model, extra=extra, **over):
                    u, ys, it = mod.denoise_pdps_cuda(
                        f, a, None, model=model, **kw, **dict(extra, **over))
                    return (u,) + tuple(ys), it
                calls.append((f"{label} {mode}", solve))
        return (mod, "pd_plan", cluster_plan.pd_plan, pd_shape, pd_slots,
                ("two-launch", "cl8", "cl16", "cl4", "cl8", "two-launch"),
                calls)
    if family == "tvl1":
        from bpldenoising_tpu_torch.solvers import tvl1_cuda as mod

        f = torch.as_tensor(testdataset("circle_sp_128_20")[1],
                            dtype=torch.float32).cuda()
        huber = dict(gamma_d=100.0, gamma_r=1000.0)
        hub, plain = mod.tvl1_huber_denoise_cuda, mod.tvl1_denoise_cuda
        cold = dict(huber, maxiter=2000, tol=None)

        def call(fn, img, alpha, kw):
            def solve(**over):
                u = fn(img, alpha, **dict(kw, **over))
                return (u,), mod.last_iters
            return solve

        calls = [("Huber 1x128x128 cold 2000", call(hub, f, 1.9, cold)),
                 ("Huber 1x128x128 early stop",
                  call(hub, f, 1.9, dict(huber, maxiter=2000, tol=1e-6,
                                         check_every=100))),
                 ("plain 1x128x128 10000",
                  call(plain, f, 0.9, dict(maxiter=10000, tol=None))),
                 ("plain 64x128x128 2000",
                  call(plain, f.repeat(64, 1, 1).contiguous(), 0.9,
                       dict(maxiter=2000, tol=None)))]
        sweep = [(f"Huber {n}x128x128 cold 2000",
                  call(hub, f.repeat(n, 1, 1).contiguous(), 1.9, cold),
                  ("cl8", "cl16", "cl8", "cl16")) for n in (2, 4, 8, 16, 32)]
        return (mod, "pd_plan", cluster_plan.pd_plan, pd_shape, pd_slots,
                ("two-launch", "cl8", "cl16", "cl4", "cl8", "cl16",
                 "two-launch"), calls + sweep)
    if family == "tgv":
        from bpldenoising_tpu_torch.solvers import tgv_cuda as mod

        f = torch.as_tensor(testdataset("faces_train_128_10")[1],
                            dtype=torch.float32).cuda()
        stacks = {1: f[:1].contiguous(), 10: f,
                  64: f.repeat(7, 1, 1)[:64].contiguous()}
        kinds = (("cold 5000", dict(maxiter=5000, tol=None)),
                 ("early stop", dict(maxiter=5000, tol=3e-6,
                                     check_every=100)))
        calls = []
        for n, img in stacks.items():
            for kind, kw in kinds:
                def solve(img=img, kw=kw, **over):
                    _, _, state, it = mod.tgv_denoise_pdps_cuda(
                        img, *cs.TGV_ALPHA, return_state=True,
                        **dict(kw, **over))
                    return state, it
                calls.append((f"{n}x128x128 {kind}", solve))
        return (mod, "tgv_plan", cluster_plan.tgv_plan,
                lambda M, N, itemsize: (M, N, itemsize),
                lambda p: cluster_plan.TGV_SLOT_ROWS,
                ("two-launch", "cl8", "cl16", "cl12", "cl8", "cl16", "cl12",
                 "two-launch"), calls)
    from bpldenoising_tpu_torch.solvers import vtv_cuda as mod

    f = torch.as_tensor(testdataset("color_disks_128_10", color=True)[1],
                        dtype=torch.float32).cuda()
    stacks = {1: f[:1].contiguous(), len(f): f,
              64: f.repeat(-(-64 // len(f)), 1, 1, 1)[:64].contiguous()}
    kinds = (("cold 5000", dict(maxiter=5000, tol=None)),
             ("early stop", dict(maxiter=5000, tol=1e-5, check_every=100)))
    calls = []
    for n, img in stacks.items():
        for kind, kw in kinds:
            def solve(img=img, kw=kw, **over):
                u, ys, it = mod.vtv_denoise_pdps_cuda(
                    img, (0.165,), return_dual=True, **dict(kw, **over))
                return (u,) + tuple(ys), it
            calls.append((f"{n}x3x128x128 {kind}", solve))
    return (mod, "vtv_plan", cluster_plan.vtv_plan,
            lambda M, N, C, itemsize: (M, N, itemsize),
            lambda p: 4 * p.planes,                 # 16C: p.planes = 4C
            ("two-launch", "cl8", "cl16", "cl8", "cl16", "two-launch"),
            calls)


def cp_sizes(family, torch, cs, timed):
    mod, attr, real, shape, slots, order, calls = cp_spec(family, torch, cs)
    plans = {"two-launch": lambda *a, **k: real(*a, **k)._replace(
        resident=False, smem=0)}
    for n in (4, 8, 12, 16):
        plans[f"cl{n}"] = forced(real, shape, slots, n)
    out = dict(order=order, repeats=REPEATS)
    # kernel A's and TGV²'s forms: resident False is the two-launch form
    # here, not the tile form that runs where the bands do not fit
    tile_attr = next((n for n in ("pd_tile_plan", "tgv_tile_plan")
                      if hasattr(mod, n)), None)
    tile_plan = getattr(mod, tile_attr) if tile_attr else None
    if tile_plan is not None:
        setattr(mod, tile_attr, lambda *a, **k: None)
    try:
        for call in calls:
            label, solve = call[:2]
            row, first = [], None
            for name in (call[2] if len(call) > 2 else order):
                setattr(mod, attr, plans[name])
                try:
                    solve(maxiter=20)
                except RuntimeError as e:
                    row.append(dict(plan=name, refused=str(e)[-120:]))
                    continue
                ms = []
                for _ in range(REPEATS):
                    ops = mod.device_ops
                    (state, its), t = timed(solve)
                    ms.append(t)
                if first is None and name != "two-launch":
                    first = state
                row.append(dict(
                    plan=name, ms=statistics.median(ms), ms_all=ms,
                    iters=its, device_ops=mod.device_ops - ops,
                    same_bits=None if first is None else all(
                        bool(torch.equal(x, y))
                        for x, y in zip(state, first))))
            print(f"{label}: " + "; ".join(
                f"{r['plan']} refused" if "refused" in r else
                f"{r['plan']} {r['ms']:.3f} ms [{min(r['ms_all']):.3f}-"
                f"{max(r['ms_all']):.3f}] ({r['iters']} its, "
                f"{r['device_ops']} ops, bits {r['same_bits']})"
                for r in row), flush=True)
            out[label] = row
    finally:
        setattr(mod, attr, real)
        if tile_plan is not None:
            setattr(mod, tile_attr, tile_plan)
    return out


def sl_spec(family):
    """(module, call, plan attribute, real plan, shape, slot rows, plan
    arguments at B images, dataset, x0, lr, batches, CG slot forms)."""
    import numpy as np
    from bpldenoising_tpu_torch.solvers import cluster_plan

    if family == "tgv_sl":
        from bpldenoising_tpu_torch.bilevel import first_order_tgv_cuda as m
        return (m, m.single_loop_tgv_cuda, "tgv_plan", cluster_plan.tgv_plan,
                lambda M, N, itemsize: (M, N, itemsize),
                lambda p: cluster_plan.TGV_SLOT_ROWS,
                lambda B: (128, 128, 4), ("faces_train_128_10", {}, ""),
                np.array([0.05, 0.05]), 0.02, (1, 2, 4, 10, 16, 32, 64),
                ((1, 3, 3, 1), lambda B: (B, 128, 128)))
    if family == "vtv_sl":
        from bpldenoising_tpu_torch.bilevel import first_order_vtv_cuda as m
        return (m, m.single_loop_vtv_cuda, "vtv_plan", cluster_plan.vtv_plan,
                lambda M, N, C, itemsize: (M, N, itemsize),
                lambda p: 4 * p.planes, lambda B: (128, 128, 3, 4),
                ("color_disks_128_10", dict(color=True), "3x"),
                np.array(0.05), 0.05, (1, 2, 6, 16, 64),
                ((1, 3, 3, 1), lambda B: (B, 128, 128, 3)))
    from bpldenoising_tpu_torch.bilevel import first_order_tvl1_cuda as m
    return (m, m.single_loop_tvl1_cuda, "tvl1_plan", m.tvl1_plan,
            lambda B, M, N, itemsize: (M, N, itemsize), pd_slots,
            lambda B: (B, 128, 128, 4), ("circle_sp_128_20", {}, ""),
            np.array(0.4), 0.05, (1, 2, 8, 16, 64), None)


def sl_sizes(family, torch, timed):
    import numpy as np
    from bpldenoising_tpu_torch.data import testdataset

    (mod, call, attr, real, shape, slots, plan_args, (data, opts, tag), x0,
     lr, batches, cg_forms) = sl_spec(family)
    true_np, noisy_np = testdataset(data, **opts)
    real_slots = getattr(mod, "cg_slots", None)
    forms = {"full": (40, 10), "no_cg": (40, 0), "no_cp": (0, 10)}

    def timed_call(ut, f, **kw):
        """(median ms, all ms, (α, u, ...)) of REPEATS calls after a
        3-step warm-up."""
        call(ut, f, x0, **dict(kw, outer=3))
        ms, res = [], None
        for _ in range(REPEATS):
            res, t = timed(lambda: call(ut, f, x0, **kw))
            ms.append(t)
        return statistics.median(ms), ms, res

    def same(res, first):
        return bool(torch.equal(res[0], first[0])
                    and torch.equal(res[1], first[1]))

    out = dict(order=(8, 16, 16, 8), repeats=REPEATS, outer=OUTER)
    try:
        for n_img in batches:
            pick = np.arange(n_img) % len(true_np)
            ut = torch.as_tensor(true_np[pick], dtype=torch.float32).cuda()
            f = torch.as_tensor(noisy_np[pick], dtype=torch.float32).cuda()
            label = f"{n_img}x{tag}128x128"
            row, first = [], None
            for n in out["order"]:
                setattr(mod, attr, forced(real, shape, slots, n, fit=True))
                entry = dict(cluster=n, rule=real(*plan_args(n_img)).cluster)
                for form, (n_inner, n_adj) in forms.items():
                    med, ms, res = timed_call(ut, f, outer=OUTER,
                                              n_inner=n_inner, n_adj=n_adj,
                                              lr=lr)
                    entry[form] = dict(ms=med, ms_all=ms)
                    if form == "full":
                        first = first or res
                        entry["same_bits"] = same(res, first)
                entry["plan"] = str(mod.last_plan)
                entry["us_per_cp_iteration"] = (
                    (entry["full"]["ms"] - entry["no_cp"]["ms"]) * 1e3
                    / (OUTER * 40))
                entry["us_per_cg_step"] = (
                    (entry["full"]["ms"] - entry["no_cg"]["ms"]) * 1e3
                    / (OUTER * 10))
                row.append(entry)
            print(f"{label} (rule: {row[0]['rule']} CTAs): " + "; ".join(
                f"{e['cluster']} CTAs {e['full']['ms']:.2f} ms "
                f"[{min(e['full']['ms_all']):.2f}-"
                f"{max(e['full']['ms_all']):.2f}], no CG "
                f"{e['no_cg']['ms']:.2f}, no CP {e['no_cp']['ms']:.2f}"
                f" ({e['us_per_cp_iteration']:.2f} µs a CP iteration, "
                f"{e['us_per_cg_step']:.2f} µs a CG step; bits "
                f"{e['same_bits']})" for e in row), flush=True)
            out[label] = row
            setattr(mod, attr, real)
            if cg_forms is None:
                continue
            cg = []
            for n_slots in cg_forms[0]:
                mod.cg_slots = lambda *a, n=n_slots: n
                med, ms, res = timed_call(ut, f, outer=OUTER, n_inner=40,
                                          n_adj=10, lr=lr)
                cg.append(dict(slots=n_slots, ms=med, ms_all=ms,
                               same_bits=same(res, first)))
            mod.cg_slots = real_slots
            print(f"  CG blocks (rule: {real_slots(*cg_forms[1](n_img))} "
                  "slots): " + "; ".join(
                      f"{e['slots']} slots {e['ms']:.2f} ms "
                      f"[{min(e['ms_all']):.2f}-{max(e['ms_all']):.2f}] "
                      f"(bits {e['same_bits']})" for e in cg), flush=True)
            out[f"{label} CG slots"] = cg
    finally:
        setattr(mod, attr, real)
        if real_slots is not None:
            mod.cg_slots = real_slots
    return out


def main(argv):
    families = CP_FAMILIES + SL_FAMILIES
    if len(argv) != 1 or argv[0] not in families:
        print(f"usage: cluster_sizes.py {{{','.join(families)}}}",
              file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from bpldenoising_tpu_torch import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    _build.library()
    timed = cs.cuda_timer(torch)
    family = argv[0]
    if family in CP_FAMILIES:
        out = cp_sizes(family, torch, cs, timed)
    else:
        out = sl_sizes(family, torch, timed)
    print(json.dumps(dict(out, family=family, device=smi)))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
