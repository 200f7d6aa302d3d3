#!/usr/bin/env python3
"""Where the time of one of the port's learns goes, on one NVIDIA GPU.

    python3 scripts/torch_profile.py {tv,patch_tv,sumregs,grid16,tgv,tvl1,
                                      vtv,single_loop,single_loop_tgv,
                                      single_loop_tvl1,single_loop_vtv}

Runs the family's fused learn on its preloaded float32 dataset with the
settings of ``chip_smoke.py``: TV (the flagship) and TGV² on
``faces_train_128_10`` (10 × 128²), TV-L1 on ``circle_sp_128_20``
(1 × 128²), VTV on ``color_disks_128_10`` (6 × 3 × 128²); TV-L1 and VTV
for the scalar weight and the 2×2 patch grid, TV and TGV for the scalar:

``patch_tv``, ``sumregs`` and ``grid16`` run the fused TV-family learns
of ``chip_smoke.py`` phases 36-39 on the faces images: the 2×2 patch TV
grid; the sum of regularizers' (3,) weights and its (2, 2, 3) patch
stack; the 16×16 TV grid (L-BFGS), each with its entry point's
parameters.  For each:

1. the learn's wall time over two runs after a warm-up (CUDA events);
2. the split of one run between the inner solve (the family's kernel
   wrapper), the adjoint (kernel B's hypergradient for TV, the plain
   PyTorch adjoint CG for the others) and the rest (trust-region host
   code, cost, the one read per evaluation), each call timed on the host
   between synchronisations, with the inner and CG iteration counts (for
   TV-L1, TGV² and VTV also the CP kernel's device operations and its
   calls in the cluster form, where the tree's wrapper counts them; for the TV
   family kernel A's device operations: launches and copies;
   kernel B's kernel launches and device→host reads, its time per CG
   iteration (the adjoint's time over all CG iterations of its calls)
   and the bound of those CG iterations by chip_smoke.py's operation
   count);
3. the first learn, cut to the family's profiled outer iterations (the
   whole learn for TV, TV-L1, the patch TV and the sum of regularizers,
   2 for TGV and the 16×16 grid and 3 for VTV, whose adjoint CGs launch
   more small kernels than the profiler handles in one call),
   under ``torch.profiler``: device busy time (kernels and copies only),
   idle share (1 − busy/wall) and device time by kernel name.

``single_loop`` runs the single-loop learner (``single_loop_learn``,
300 outer steps of 40 PD and 10 CG steps, Adam at lr 0.05) on
``faces_train_128_10`` for the scalar TV weight from 0.1 and the
sum-of-regularizers weights from 1e-3: the split is the CUDA learner's
launch call (the whole learn runs in it) against the rest, and the
profiled run is cut to 30 outer steps, with the kernel launches per outer
step its C loop issued (so for ``single_loop_tgv``, ``single_loop_tvl1``
and ``single_loop_vtv``, whose wrappers count them too).  These three do
the same for the other families' single-loop learners with the settings
of their entry points (300 outer steps of 40 CP and 10 CG steps): TGV² on
the faces images from (0.05, 0.05) at lr 0.02, TV-L1 on one
``circle_sp_128_20`` image from 0.4, VTV on the six
``color_disks_128_10`` images from 0.05.

Prints one line per item and a JSON line last.  Exits non-zero without a
CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

# family: (fused module under bpldenoising_tpu_torch.bilevel, the names in
# it timed as the inner solve, those timed as the adjoint, outer
# iterations profiled)
FAMILIES = {
    "tv": ("fused", ("denoise_pdps_cuda",),
           ("exact_hypergrad_cuda", "reg_hypergrad_cuda"), 20),
    "patch_tv": ("fused", ("denoise_pdps_cuda",),
                 ("exact_hypergrad_cuda", "reg_hypergrad_cuda"), 20),
    "sumregs": ("fused", ("denoise_pdps_cuda",),
                ("exact_hypergrad_cuda", "reg_hypergrad_cuda"), 20),
    "grid16": ("fused", ("denoise_pdps_cuda",),
               ("exact_hypergrad_cuda", "reg_hypergrad_cuda"), 2),
    "tgv": ("fused_tgv", ("tgv_denoise_pdps_cuda",),
            ("tgv_implicit_cotangents",), 2),
    "tvl1": ("fused_tvl1", ("tvl1_huber_denoise_cuda",),
             ("tvl1_huber_hypergrad",), 15),
    "vtv": ("fused_vtv", ("vtv_denoise_pdps_cuda",),
            ("vtv_implicit_cotangents",), 3),
    "single_loop": ("first_order_cuda", ("_launch",), (), 30),
    "single_loop_tgv": ("first_order_tgv_cuda", ("_launch",), (), 30),
    "single_loop_tvl1": ("first_order_tvl1_cuda", ("_launch",), (), 30),
    "single_loop_vtv": ("first_order_vtv_cuda", ("_launch",), (), 30),
}


# kernel B's stencil kinds (csrc/common.cuh: Stencil) where not K = 1
# forward, and the pixels of every TV-family learn (the 10 faces images)
B_KINDS = {"sumregs": (0, 1, 2)}
B_PIXELS = 10 * 128 * 128


def setup_single_loop(torch, family):
    """A single-loop learner on its data: ``learn(x0, params)`` runs
    ``params.maxiter`` outer steps of ``params.model``."""
    import types

    import numpy as np

    from bpldenoising_tpu_torch.bilevel import (first_order_tgv,
                                                first_order_tvl1,
                                                first_order_vtv)
    from bpldenoising_tpu_torch.bilevel.first_order import single_loop_learn
    from bpldenoising_tpu_torch.data import testdataset
    from bpldenoising_tpu_torch.models import sumregs_model, tv_model
    from bpldenoising_tpu_torch.utils.config import Params

    name, count, color = {
        "single_loop": ("faces_train_128_10", 10, False),
        "single_loop_tgv": ("faces_train_128_10", 10, False),
        "single_loop_tvl1": ("circle_sp_128_20", 1, False),
        "single_loop_vtv": ("color_disks_128_10", 6, True)}[family]
    true_np, noisy_np = testdataset(name, color=color)
    ut = torch.as_tensor(true_np[:count], dtype=torch.float32).cuda()
    f = torch.as_tensor(noisy_np[:count], dtype=torch.float32).cuda()
    learns = {
        "tv": lambda x0, n: single_loop_learn(ut, f, x0, tv_model(),
                                              outer=n),
        "sumregs": lambda x0, n: single_loop_learn(ut, f, x0,
                                                   sumregs_model(), outer=n),
        "tgv": lambda x0, n: first_order_tgv.single_loop_tgv_learn(
            ut, f, x0, outer=n),
        "tvl1": lambda x0, n: first_order_tvl1.single_loop_tvl1_learn(
            ut, f, x0, outer=n),
        "vtv": lambda x0, n: first_order_vtv.single_loop_vtv_learn(
            ut, f, x0, outer=n)}

    def learn(x0, p):
        res = learns[p.model](x0, int(p.maxiter))
        return types.SimpleNamespace(x=res.alpha, iterations=int(p.maxiter))

    if family == "single_loop":
        runs = {"scalar": (0.1, Params(model="tv", maxiter=300)),
                "sumregs": (np.full((3,), 1e-3), Params(model="sumregs",
                                                        maxiter=300))}
    else:
        model = family.split("_")[-1]
        x0 = {"tgv": np.array([0.05, 0.05]), "tvl1": 0.4,
              "vtv": 0.05}[model]
        runs = {"scalar": (x0, Params(model=model, maxiter=300))}
    # the launch call returns (carry, trajectories): count outer steps
    return learn, runs, (lambda out: int(out[1][1].shape[0])), None


def setup_tv_family(family, torch):
    """``setup`` for the patch TV, sum-of-regularizers and 16×16 learns:
    each run carries its own keywords (chip_smoke.tvf_learn_kwargs)."""
    import numpy as np

    import chip_smoke as cs
    from bpldenoising_tpu_torch.bilevel import fused
    from bpldenoising_tpu_torch.data import testdataset
    from bpldenoising_tpu_torch.experiments import api
    from bpldenoising_tpu_torch.models import sumregs_model, tv_model
    from bpldenoising_tpu_torch.solvers import hypergrad_cuda

    runs = {}
    for label in {"patch_tv": ("patch_tv",),
                  "sumregs": ("sumregs", "patch_sumregs"),
                  "grid16": ("grid16",)}[family]:
        _, kw = cs.tvf_learn_kwargs(label)
        base = {"patch_tv": api.patch_bilevel_params,
                "grid16": api.patch_bilevel_params,
                "sumregs": api.sumregs_bilevel_params,
                "patch_sumregs": api.patch_sumregs_bilevel_params}[label]
        kw = dict(kw, delta0=kw.get("delta0", base.delta0),
                  alpha0=kw.get("alpha0", base.alpha0))
        runs[label] = (np.asarray(kw["alpha0"]), base | kw)
    true_np, noisy_np = testdataset("faces_train_128_10")
    ds = (torch.as_tensor(true_np, dtype=torch.float32).cuda(),
          torch.as_tensor(noisy_np, dtype=torch.float32).cuda())

    def learn(x0, p):
        sumregs = family == "sumregs"
        return fused.bilevel_learn_fused(
            ds, xinit=x0, params=p,
            model=sumregs_model() if sumregs else tv_model(),
            inner_maxiter=p.inner_maxiter, inner_tol=p.inner_tol,
            check_every=p.check_every, delta_t=1e-3 if sumregs else 1e-6,
            cfg=p.hypergrad_cfg, device="cuda")

    return (learn, runs, lambda out: out[-1],
            lambda out: hypergrad_cuda.last_total_cg_iters)


def setup(family, torch):
    """The family's data on the card, its learn ``learn(x0, params)``, its
    runs ``{label: (x0, params)}`` and the counters read after a timed
    call: ``inner_iters(result)`` and ``cg_iters(result)``."""
    import chip_smoke as cs
    from bpldenoising_tpu_torch.bilevel import (fused, fused_tgv, fused_tvl1,
                                                fused_vtv)
    from bpldenoising_tpu_torch.data import testdataset
    from bpldenoising_tpu_torch.solvers import hypergrad_cuda, tvl1_cuda
    from bpldenoising_tpu_torch.utils.config import Params

    def last(out):
        return out[-1]

    def info_iters(out):
        return out[-1].iters

    extra = {}
    if family.startswith("single_loop"):
        return setup_single_loop(torch, family)
    if family in ("patch_tv", "sumregs", "grid16"):
        return setup_tv_family(family, torch)
    if family == "tv":
        kw = cs.flagship_kwargs()
        name, color, fn = ("faces_train_128_10", False,
                           fused.bilevel_learn_fused)
        base = Params(eta1=0.25, eta2=0.75, beta1=0.25, beta2=1.9,
                      delta0=0.1, maxiter=kw["maxiter"], tol=kw["tol"])
        runs = {"scalar": (kw["alpha0"], base)}
        extra = dict(cfg=kw["hypergrad_cfg"])
        inner, cg = last, lambda out: hypergrad_cuda.last_total_cg_iters
    elif family == "tgv":
        from bpldenoising_tpu_torch.experiments.tgv import tgv_bilevel_params
        kw = cs.tgv_learn_kwargs()
        name, color, fn = ("faces_train_128_10", False,
                           fused_tgv.bilevel_learn_tgv_fused)
        base = tgv_bilevel_params | dict(maxiter=kw["maxiter"],
                                         tol=kw["tol"])
        runs = {"scalar": (base.alpha0, base)}
        inner, cg = last, info_iters
    elif family == "tvl1":
        from bpldenoising_tpu_torch.experiments.tvl1 import \
            tvl1_bilevel_params
        kw = cs.tvl1_learn_kwargs()
        name, color, fn = ("circle_sp_128_20", False,
                           fused_tvl1.bilevel_learn_tvl1_fused)
        base = tvl1_bilevel_params | dict(
            maxiter=kw["maxiter"], tol=kw["tol"], delta0=kw["delta0"])
        runs = {"scalar": (cs.TVL1_X0, base),
                "patch": (cs.TVL1_X0_PATCH, base)}
        inner, cg = lambda out: tvl1_cuda.last_iters, info_iters
    else:
        import numpy as np

        from bpldenoising_tpu_torch.experiments.vtv import (
            patch_vtv_bilevel_params, vtv_bilevel_params)
        kw = cs.vtv_learn_kwargs()
        name, color, fn = ("color_disks_128_10", True,
                           fused_vtv.bilevel_learn_vtv_fused)
        # the entry points' maxiter 20 and tol 1e-5 (the shared defaults),
        # with the family's Δ₀, x₀ and β₂
        runs = {label: (np.asarray(p.alpha0), p | dict(maxiter=20, tol=1e-5))
                for label, p in (("scalar", vtv_bilevel_params),
                                 ("patch", patch_vtv_bilevel_params))}
        inner, cg = last, info_iters
    true_np, noisy_np = testdataset(name, color=color)
    ds = (torch.as_tensor(true_np, dtype=torch.float32).cuda(),
          torch.as_tensor(noisy_np, dtype=torch.float32).cuda())

    def learn(x0, p):
        return fn(ds, xinit=x0, params=p, inner_maxiter=kw["inner_maxiter"],
                  inner_tol=kw["inner_tol"], check_every=kw["check_every"],
                  device="cuda", **extra)

    return learn, runs, inner, cg


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("family", choices=sorted(FAMILIES))
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    import importlib

    import chip_smoke
    from bpldenoising_tpu_torch import _build
    from bpldenoising_tpu_torch.solvers import (hypergrad_cuda, pdps_cuda,
                                                tgv_cuda, tvl1_cuda,
                                                vtv_cuda)

    mod_name, solve_names, adjoint_names, prof_its = FAMILIES[args.family]
    module = importlib.import_module(
        "bpldenoising_tpu_torch.bilevel." + mod_name)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    _build.library()
    learn, runs, inner_iters, cg_iters = setup(args.family, torch)

    out = dict(device=smi, family=args.family)
    for label, (x0, params) in runs.items():
        learn(x0, params)   # warm-up
        walls = []
        for _ in range(2):
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            res = learn(x0, params)
            end.record()
            end.synchronize()
            walls.append(start.elapsed_time(end))
        print(f"{label} learn wall (ms, 2 runs): {walls}; x "
              f"{res.x.tolist()}, {res.iterations} outer its", flush=True)

        spent = {"solve": 0.0, "adjoint": 0.0}
        calls = {"solve": 0, "adjoint": 0}
        counts = {"inner_iters": 0, "cg_iters": 0}

        def timed(key, fn):
            def wrapper(*a, **k):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                r = fn(*a, **k)
                torch.cuda.synchronize()
                spent[key] += (time.perf_counter() - t0) * 1e3
                calls[key] += 1
                if key == "solve":
                    counts["inner_iters"] += inner_iters(r)
                else:
                    counts["cg_iters"] += cg_iters(r)
                return r
            return wrapper

        keyed = [("solve", n) for n in solve_names] + [
            ("adjoint", n) for n in adjoint_names]
        saved = {n: getattr(module, n) for _, n in keyed}
        for key, n in keyed:
            setattr(module, n, timed(key, saved[n]))
        ops0 = pdps_cuda.device_ops
        l_ops0, l_cl0 = tvl1_cuda.device_ops, tvl1_cuda.cluster_calls
        t_ops0 = getattr(tgv_cuda, "device_ops", 0)
        t_cl0 = getattr(tgv_cuda, "cluster_calls", 0)
        v_ops0 = getattr(vtv_cuda, "device_ops", 0)
        v_cl0 = getattr(vtv_cuda, "cluster_calls", 0)
        b_ops0, b_reads0 = hypergrad_cuda.device_ops, hypergrad_cuda.host_reads
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            learn(x0, params)
            torch.cuda.synchronize()
            split_wall = (time.perf_counter() - t0) * 1e3
        finally:
            for n, fn in saved.items():
                setattr(module, n, fn)
        rest = split_wall - spent["solve"] - spent["adjoint"]
        # kernel A's device operations (launches and copies) in this run
        a_ops = pdps_cuda.device_ops - ops0
        # the TV-L1 kernel's device operations and cluster-form calls
        l_ops = tvl1_cuda.device_ops - l_ops0
        l_cl = tvl1_cuda.cluster_calls - l_cl0
        # the TGV² kernel's, where its wrapper counts them
        t_ops = getattr(tgv_cuda, "device_ops", 0) - t_ops0
        t_cl = getattr(tgv_cuda, "cluster_calls", 0) - t_cl0
        # the VTV kernel's, where its wrapper counts them
        v_ops = getattr(vtv_cuda, "device_ops", 0) - v_ops0
        v_cl = getattr(vtv_cuda, "cluster_calls", 0) - v_cl0
        # kernel B's launches and device→host reads in this run
        b_reads = hypergrad_cuda.host_reads - b_reads0
        b_launches = hypergrad_cuda.device_ops - b_ops0 - b_reads
        b_us = (spent["adjoint"] * 1e3 / counts["cg_iters"]
                if b_reads and counts["cg_iters"] else None)
        # its bound: the operations of the CG iterations and of one call's
        # set-up and gradient by chip_smoke.py's rule, on the batch (the
        # other calls' set-ups and the solve starts not counted)
        b_bound = (chip_smoke.bound_ms(0, chip_smoke.b_ops_per_pixel(
            B_KINDS.get(args.family, (0,)), counts["cg_iters"], 0)
            * B_PIXELS)[0] if b_us else None)
        print(f"{label} split (host clock, ms): total {split_wall:.1f}, "
              f"inner solve {spent['solve']:.1f} in {calls['solve']} calls "
              f"({counts['inner_iters']} iterations), adjoint "
              f"{spent['adjoint']:.1f} in {calls['adjoint']} calls "
              f"({counts['cg_iters']} CG iterations), rest {rest:.1f}"
              + (f"; kernel A device operations {a_ops}" if a_ops else "")
              + (f"; TV-L1 kernel device operations {l_ops}, {l_cl} calls "
                 "in the cluster form" if l_ops else "")
              + (f"; TGV² kernel device operations {t_ops}, {t_cl} calls "
                 "in the cluster form" if t_ops else "")
              + (f"; VTV kernel device operations {v_ops}, {v_cl} calls "
                 "in the cluster form" if v_ops else "")
              + (f"; kernel B {b_launches} launches, {b_reads} host reads, "
                 f"{b_us:.2f} us a CG iteration, bound {b_bound:.3f} ms "
                 "(operations)" if b_us else ""),
              flush=True)
        out[label] = dict(learn_wall_ms=walls, split_ms=dict(
            total=split_wall, inner_solve=spent["solve"],
            adjoint=spent["adjoint"], rest=rest, calls=calls, **counts),
            kernel_a_device_ops=a_ops,
            tvl1_kernel=dict(device_ops=l_ops, cluster_calls=l_cl),
            tgv_kernel=dict(device_ops=t_ops, cluster_calls=t_cl),
            vtv_kernel=dict(device_ops=v_ops, cluster_calls=v_cl),
            kernel_b=dict(launches=b_launches, host_reads=b_reads,
                          us_per_cg_iter=b_us, bound_ms=b_bound))

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    x0, params = next(iter(runs.values()))
    short = params | dict(maxiter=prof_its)
    learn(x0, short)
    # the TV learner's wrapper counts the kernels its C loop launches
    launched0 = getattr(module, "kernel_launches", None)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        learn(x0, short)
        torch.cuda.synchronize()
        prof_wall = (time.perf_counter() - t0) * 1e3
    # device activity (kernels, copies) only: a CPU operator's self device
    # time repeats the time of the kernels it launched
    by_name, all_ops_ms = {}, 0.0
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0.0))
        all_ops_ms += dev_us / 1e3
        if dev_us > 0 and ev.device_type != DeviceType.CPU:
            by_name[ev.key] = (dev_us / 1e3, ev.count)
    busy = sum(ms for ms, _ in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    for name, (ms, count) in top:
        print(f"  device {ms:8.2f} ms  {count:7d}x  {name[:70]}", flush=True)
    idle = 1.0 - busy / prof_wall if busy > 0 else None
    per_step = None
    if launched0 is not None:
        launched = module.kernel_launches - launched0
        per_step = (launched - 1) / prof_its    # one slc_begin a segment
        print(f"kernel launches in the profiled learn: {launched} "
              f"({per_step:g} per outer step)", flush=True)
    print(f"profiled {next(iter(runs))} learn ({prof_its} outer its max): "
          f"wall "
          f"{prof_wall:.1f} ms (host clock, profiler on), device busy "
          f"{busy:.2f} ms, idle share "
          f"{'not measured' if idle is None else f'{idle:.3f}'} (self "
          f"device time summed over every event, operators included: "
          f"{all_ops_ms:.2f} ms)", flush=True)
    print(json.dumps(dict(
        out, profiled_maxiter=prof_its, profiled_wall_ms=prof_wall,
        device_busy_ms=busy, idle_share=idle,
        launches_per_outer_step=per_step,
        self_device_ms_all_events=all_ops_ms,
        top_kernels=[[n, ms, c] for n, (ms, c) in top])))
    return 0


if __name__ == "__main__":
    sys.exit(main())
