#!/usr/bin/env python3
"""The TV-L1 kernel's cluster size, measured on one NVIDIA GPU.

    python3 scripts/tvl1_cluster_sizes.py

On ``circle_sp_128_20`` (one 128² float32 image, the TV-L1 learns' data)
times the TV-L1 kernel (``csrc/tvl1.cu``) in the calls of its main paths:
the Huber form at α 1.9 (γ_d 100, γ_r 1000) for a cold 2000-iteration call
and a cold call with the learns' early stop (tol 1e-6, every 100
iterations, at most 2000), and the plain form at α 0.9 for
``TVL1Denoise``'s 10,000 iterations and for 2000 iterations on the image
repeated 64 times; each under four plans: the two-launch form, and the
cluster form with 4, 8 and 16 CTAs an image (16 is a non-portable cluster
size), in the order two-launch, 8, 16, 4, 8, 16, two-launch.  Then the
Huber cold call on the image repeated 2, 4, 8, 16 and 32 times under 8
and 16 CTAs (8, 16, 8, 16): where ``solvers/tvl1_cuda.py::tvl1_plan``'s
rule (16 while the batch's clusters of 16 have an SM a CTA, up to 8
images) should change over.  Each call is timed with CUDA
events three times after one warm-up call under the same plan; the median
and the spread, the iteration count and the device operations (launches
and copies) are printed beside it, and whether its u has the bits of the
first cluster plan's.  Prints the card's name and power limit first and
one JSON line last.  Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

ORDER = ("two-launch", "cl8", "cl16", "cl4", "cl8", "cl16", "two-launch")
SWEEP = ("cl8", "cl16", "cl8", "cl16")
REPEATS = 3


def main():
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from bpldenoising_tpu_torch import _build
    from bpldenoising_tpu_torch.data import testdataset
    from bpldenoising_tpu_torch.solvers import cluster_plan, tvl1_cuda

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    _build.library()
    _, noisy = testdataset("circle_sp_128_20")
    f = torch.as_tensor(noisy, dtype=torch.float32).cuda()
    timed = cs.cuda_timer(torch)
    real = cluster_plan.pd_plan

    def cluster(n):
        def plan(M, N, K, itemsize, **kw):
            rows = -(-M // n)
            return real(M, N, K, itemsize)._replace(
                cluster=n, rows=rows,
                smem=((2 + 2 * K) * (rows + 4) + 16 * K) * N * itemsize)
        return plan

    plans = {"two-launch": lambda *a, **k: real(*a, **k)._replace(
        resident=False, smem=0),
             "cl4": cluster(4), "cl8": cluster(8), "cl16": cluster(16)}
    huber = dict(gamma_d=100.0, gamma_r=1000.0)
    hub = tvl1_cuda.tvl1_huber_denoise_cuda
    cold = dict(huber, maxiter=2000, tol=None)
    calls = (
        ("Huber 1x128x128 cold 2000", f, hub, 1.9, cold, ORDER),
        ("Huber 1x128x128 early stop", f, hub, 1.9,
         dict(huber, maxiter=2000, tol=1e-6, check_every=100), ORDER),
        ("plain 1x128x128 10000", f, tvl1_cuda.tvl1_denoise_cuda, 0.9,
         dict(maxiter=10000, tol=None), ORDER),
        ("plain 64x128x128 2000", f.repeat(64, 1, 1).contiguous(),
         tvl1_cuda.tvl1_denoise_cuda, 0.9, dict(maxiter=2000, tol=None),
         ORDER),
    ) + tuple((f"Huber {n}x128x128 cold 2000",
               f.repeat(n, 1, 1).contiguous(), hub, 1.9, cold, SWEEP)
              for n in (2, 4, 8, 16, 32))
    out = dict(device=smi, order=ORDER, sweep=SWEEP, repeats=REPEATS)
    try:
        for label, img, solve, alpha, kw, order in calls:
            row, first = [], None
            for name in order:
                tvl1_cuda.pd_plan = plans[name]
                solve(img, alpha, **dict(kw, maxiter=20))
                ms = []
                for _ in range(REPEATS):
                    ops = tvl1_cuda.device_ops
                    u, t = timed(lambda: solve(img, alpha, **kw))
                    ms.append(t)
                if first is None and name != "two-launch":
                    first = u
                row.append(dict(
                    plan=name, ms=statistics.median(ms), ms_all=ms,
                    iters=tvl1_cuda.last_iters,
                    device_ops=tvl1_cuda.device_ops - ops,
                    same_bits=None if first is None
                    else bool(torch.equal(u, first))))
            print(f"{label}: " + "; ".join(
                f"{r['plan']} {r['ms']:.3f} ms [{min(r['ms_all']):.3f}-"
                f"{max(r['ms_all']):.3f}] ({r['iters']} its, "
                f"{r['device_ops']} ops, bits {r['same_bits']})"
                for r in row), flush=True)
            out[label] = row
    finally:
        tvl1_cuda.pd_plan = real
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
