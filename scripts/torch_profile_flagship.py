#!/usr/bin/env python3
"""Where the time of the port's flagship learn goes, on one NVIDIA GPU.

    python3 scripts/torch_profile_flagship.py

Runs ``bilevel_learn_fused`` on the preloaded ``faces_train_128_10`` stack
(10 × 128², float32) with the flagship settings of ``chip_smoke.py``:

1. the learn's wall time over three runs after a warm-up (CUDA events);
2. the split of one run between the inner solve (kernel A's wrapper), the
   hypergradient (kernel B's wrapper) and the rest (trust-region host
   code), each wrapper call timed on the host between synchronisations;
3. one run under ``torch.profiler``: device busy time, idle share
   (1 − busy/wall) and device time by kernel name.

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
    from chip_smoke import flagship_kwargs
    from bpldenoising_tpu_torch import _build
    from bpldenoising_tpu_torch.bilevel import fused
    from bpldenoising_tpu_torch.data import testdataset
    from bpldenoising_tpu_torch.utils.config import Params

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    _build.library()
    kw = flagship_kwargs()
    true_np, noisy_np = testdataset("faces_train_128_10")
    ds = (torch.as_tensor(true_np, dtype=torch.float32).cuda(),
          torch.as_tensor(noisy_np, dtype=torch.float32).cuda())
    params = Params(eta1=0.25, eta2=0.75, beta1=0.25, beta2=1.9, delta0=0.1,
                    maxiter=kw["maxiter"], tol=kw["tol"])

    def learn():
        return fused.bilevel_learn_fused(
            ds, xinit=kw["alpha0"], params=params,
            inner_maxiter=kw["inner_maxiter"], inner_tol=kw["inner_tol"],
            check_every=kw["check_every"], cfg=kw["hypergrad_cfg"],
            device="cuda")

    learn()   # warm-up
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        res = learn()
        end.record()
        end.synchronize()
        walls.append(start.elapsed_time(end))
    print(f"learn wall (ms, 3 runs): {walls}; alpha {float(res.x):.6f}, "
          f"{res.iterations} outer its", flush=True)

    # split by wrapper: time each call between synchronisations
    spent = {"A": 0.0, "B": 0.0}
    calls = {"A": 0, "B": 0}
    originals = {"A": ("denoise_pdps_cuda",),
                 "B": ("exact_hypergrad_cuda", "reg_hypergrad_cuda")}

    def timed(key, fn):
        def wrapper(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            spent[key] += (time.perf_counter() - t0) * 1e3
            calls[key] += 1
            return out
        return wrapper

    saved = {}
    for key, names in originals.items():
        for name in names:
            saved[name] = getattr(fused, name)
            setattr(fused, name, timed(key, saved[name]))
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        learn()
        torch.cuda.synchronize()
        split_wall = (time.perf_counter() - t0) * 1e3
    finally:
        for name, fn in saved.items():
            setattr(fused, name, fn)
    rest = split_wall - spent["A"] - spent["B"]
    print(f"split (host clock, ms): total {split_wall:.1f}, inner solve "
          f"{spent['A']:.1f} in {calls['A']} calls, hypergradient "
          f"{spent['B']:.1f} in {calls['B']} calls, rest {rest:.1f}",
          flush=True)

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        learn()
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
    print(f"profiled run: wall {prof_wall:.1f} ms (host clock, profiler on), "
          f"device busy {busy:.2f} ms, idle share "
          f"{'not measured' if idle is None else f'{idle:.3f}'}", flush=True)
    print(json.dumps(dict(
        device=smi, learn_wall_ms=walls, split_ms=dict(
            total=split_wall, inner_solve=spent["A"],
            hypergradient=spent["B"], rest=rest, calls=calls),
        profiled_wall_ms=prof_wall, device_busy_ms=busy, idle_share=idle,
        top_kernels=[[n, ms, c] for n, (ms, c) in top])))
    return 0


if __name__ == "__main__":
    sys.exit(main())
