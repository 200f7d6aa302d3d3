#!/usr/bin/env python3
"""Where the time of the port's TGV² learn goes, on one NVIDIA GPU.

    python3 scripts/torch_profile_tgv.py

Runs ``bilevel_learn_tgv_fused`` on the preloaded ``faces_train_128_10``
stack (10 × 128², float32) with the TGV settings of ``chip_smoke.py``:

1. the learn's wall time over two runs after a warm-up (CUDA events);
2. the split of one run between the inner solve (the TGV kernel's
   wrapper), the adjoint CG (``tgv_implicit_cotangents``, plain PyTorch)
   and the rest (trust-region host code), each call timed on the host
   between synchronisations, with the inner and CG iteration counts;
3. one SHORT learn (2 outer iterations, 3 evaluations) under
   ``torch.profiler``: device busy time, idle share (1 − busy/wall) and
   device time by kernel name.  The whole learn issues millions of small
   kernels, more than the profiler's event processing handles in the time
   of one call.

Prints one line per item and a JSON line last.  Exits non-zero without a
CUDA device.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main():
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    from chip_smoke import tgv_learn_kwargs
    from bpldenoising_tpu_torch import _build
    from bpldenoising_tpu_torch.bilevel import fused_tgv
    from bpldenoising_tpu_torch.data import testdataset
    from bpldenoising_tpu_torch.experiments.tgv import tgv_bilevel_params

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    _build.library()
    kw = tgv_learn_kwargs()
    true_np, noisy_np = testdataset("faces_train_128_10")
    ds = (torch.as_tensor(true_np, dtype=torch.float32).cuda(),
          torch.as_tensor(noisy_np, dtype=torch.float32).cuda())
    params = tgv_bilevel_params | dict(maxiter=kw["maxiter"], tol=kw["tol"])

    def learn(p=params):
        return fused_tgv.bilevel_learn_tgv_fused(
            ds, xinit=p.alpha0, params=p, inner_maxiter=kw["inner_maxiter"],
            inner_tol=kw["inner_tol"], check_every=kw["check_every"],
            device="cuda")

    learn()   # warm-up
    walls = []
    for _ in range(2):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        res = learn()
        end.record()
        end.synchronize()
        walls.append(start.elapsed_time(end))
    print(f"learn wall (ms, 2 runs): {walls}; alpha {res.x.tolist()}, "
          f"{res.iterations} outer its", flush=True)

    # split by call: time each between synchronisations
    spent = {"solve": 0.0, "adjoint": 0.0}
    calls = {"solve": 0, "adjoint": 0}
    counts = {"inner_iters": 0, "cg_iters": 0}
    names = {"solve": "tgv_denoise_pdps_cuda",
             "adjoint": "tgv_implicit_cotangents"}

    def timed(key, fn):
        def wrapper(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            spent[key] += (time.perf_counter() - t0) * 1e3
            calls[key] += 1
            if key == "solve":
                counts["inner_iters"] += out[3]
            else:
                counts["cg_iters"] += out[-1].iters
            return out
        return wrapper

    saved = {key: getattr(fused_tgv, name) for key, name in names.items()}
    for key, name in names.items():
        setattr(fused_tgv, name, timed(key, saved[key]))
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        learn()
        torch.cuda.synchronize()
        split_wall = (time.perf_counter() - t0) * 1e3
    finally:
        for key, name in names.items():
            setattr(fused_tgv, name, saved[key])
    rest = split_wall - spent["solve"] - spent["adjoint"]
    print(f"split (host clock, ms): total {split_wall:.1f}, inner solve "
          f"{spent['solve']:.1f} in {calls['solve']} calls "
          f"({counts['inner_iters']} iterations), adjoint CG "
          f"{spent['adjoint']:.1f} in {calls['adjoint']} calls "
          f"({counts['cg_iters']} iterations), rest {rest:.1f}", flush=True)

    from torch.profiler import ProfilerActivity, profile
    short = params | dict(maxiter=2)
    learn(short)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        learn(short)
        torch.cuda.synchronize()
        prof_wall = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0.0))
        if dev_us > 0:
            by_name[ev.key] = (dev_us / 1e3, ev.count)
    busy = sum(ms for ms, _ in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    for name, (ms, count) in top:
        print(f"  device {ms:8.2f} ms  {count:7d}x  {name[:70]}", flush=True)
    idle = 1.0 - busy / prof_wall if busy > 0 else None
    print(f"profiled short learn (2 outer its): wall {prof_wall:.1f} ms "
          f"(host clock, profiler on), device busy {busy:.2f} ms, idle "
          f"share {'not measured' if idle is None else f'{idle:.3f}'}",
          flush=True)
    print(json.dumps(dict(
        device=smi, learn_wall_ms=walls, split_ms=dict(
            total=split_wall, inner_solve=spent["solve"],
            adjoint_cg=spent["adjoint"], rest=rest, calls=calls,
            **counts),
        short_profiled_wall_ms=prof_wall, device_busy_ms=busy,
        idle_share=idle, top_kernels=[[n, ms, c] for n, (ms, c) in top])))
    return 0


if __name__ == "__main__":
    sys.exit(main())
