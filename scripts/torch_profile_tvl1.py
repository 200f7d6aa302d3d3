#!/usr/bin/env python3
"""Where the time of the port's TV-L1 learn goes, on one NVIDIA GPU.

    python3 scripts/torch_profile_tvl1.py [--profile-maxiter N]

Runs ``bilevel_learn_tvl1_fused`` on the preloaded ``circle_sp_128_20``
image (1 × 128², float32) with the TV-L1 settings of ``chip_smoke.py``,
for the scalar weight and the 2×2 patch grid:

1. the learn's wall time over two runs after a warm-up (CUDA events);
2. the split of one run between the inner solve (the TV-L1 kernel's
   wrapper, Huber form), the adjoint CG (``tvl1_huber_hypergrad``, plain
   PyTorch) and the rest (trust-region host code, cost, the one read per
   evaluation), each call timed on the host between synchronisations,
   with the inner and CG iteration counts;
3. the scalar learn, cut to ``--profile-maxiter`` outer iterations
   (default 15, the whole learn), under ``torch.profiler``: device busy
   time, idle share (1 − busy/wall) and device time by kernel name.

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


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--profile-maxiter", type=int, default=15)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    from chip_smoke import TVL1_X0, TVL1_X0_PATCH, tvl1_learn_kwargs
    from bpldenoising_tpu_torch import _build
    from bpldenoising_tpu_torch.bilevel import fused_tvl1
    from bpldenoising_tpu_torch.data import testdataset
    from bpldenoising_tpu_torch.experiments.tvl1 import tvl1_bilevel_params
    from bpldenoising_tpu_torch.solvers import tvl1_cuda

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    _build.library()
    kw = tvl1_learn_kwargs()
    true_np, noisy_np = testdataset("circle_sp_128_20")
    ds = (torch.as_tensor(true_np, dtype=torch.float32).cuda(),
          torch.as_tensor(noisy_np, dtype=torch.float32).cuda())
    params = tvl1_bilevel_params | dict(maxiter=kw["maxiter"], tol=kw["tol"],
                                        delta0=kw["delta0"])

    def learn(x0, p=params):
        return fused_tvl1.bilevel_learn_tvl1_fused(
            ds, xinit=x0, params=p, inner_maxiter=kw["inner_maxiter"],
            inner_tol=kw["inner_tol"], check_every=kw["check_every"],
            device="cuda")

    names = {"solve": "tvl1_huber_denoise_cuda",
             "adjoint": "tvl1_huber_hypergrad"}
    out = dict(device=smi)
    for label, x0 in (("scalar", TVL1_X0), ("patch", TVL1_X0_PATCH)):
        learn(x0)   # warm-up
        walls = []
        for _ in range(2):
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            res = learn(x0)
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
                    counts["inner_iters"] += tvl1_cuda.last_iters
                else:
                    counts["cg_iters"] += r[2].iters
                return r
            return wrapper

        saved = {key: getattr(fused_tvl1, n) for key, n in names.items()}
        for key, n in names.items():
            setattr(fused_tvl1, n, timed(key, saved[key]))
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            learn(x0)
            torch.cuda.synchronize()
            split_wall = (time.perf_counter() - t0) * 1e3
        finally:
            for key, n in names.items():
                setattr(fused_tvl1, n, saved[key])
        rest = split_wall - spent["solve"] - spent["adjoint"]
        print(f"{label} split (host clock, ms): total {split_wall:.1f}, "
              f"inner solve {spent['solve']:.1f} in {calls['solve']} calls "
              f"({counts['inner_iters']} iterations), adjoint CG "
              f"{spent['adjoint']:.1f} in {calls['adjoint']} calls "
              f"({counts['cg_iters']} iterations), rest {rest:.1f}",
              flush=True)
        out[label] = dict(learn_wall_ms=walls, split_ms=dict(
            total=split_wall, inner_solve=spent["solve"],
            adjoint_cg=spent["adjoint"], rest=rest, calls=calls, **counts))

    from torch.profiler import ProfilerActivity, profile
    short = params | dict(maxiter=args.profile_maxiter)
    learn(TVL1_X0, short)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        learn(TVL1_X0, short)
        torch.cuda.synchronize()
        prof_wall = (time.perf_counter() - t0) * 1e3
    # device activity (kernels, copies) only: a CPU operator's self device
    # time repeats the time of the kernels it launched
    from torch.autograd import DeviceType
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
    print(f"profiled scalar learn ({args.profile_maxiter} outer its max): "
          f"wall {prof_wall:.1f} ms (host clock, profiler on), device busy "
          f"{busy:.2f} ms, idle share "
          f"{'not measured' if idle is None else f'{idle:.3f}'} (self "
          f"device time summed over every event, operators included: "
          f"{all_ops_ms:.2f} ms)", flush=True)
    print(json.dumps(dict(
        out, profiled_maxiter=args.profile_maxiter,
        profiled_wall_ms=prof_wall, device_busy_ms=busy, idle_share=idle,
        self_device_ms_all_events=all_ops_ms,
        top_kernels=[[n, ms, c] for n, (ms, c) in top])))
    return 0


if __name__ == "__main__":
    sys.exit(main())
