#!/usr/bin/env python3
"""The TGV² CP kernel's cluster size, measured on one NVIDIA GPU.

    python3 scripts/tgv_cluster_sizes.py

On the first 1, all 10 and (repeated) 64 images of ``faces_train_128_10``
(128² float32, the TGV² learns' data) times the TGV² CP kernel
(``csrc/tgv.cu``, TPU rows 4–5) at the learns' reference weights
(α₁, α₀) = (0.085226, 0.044170) in the calls of its main path: a cold
5000-iteration call and a cold call with the learns' early stop (tol 3e-6,
every 100 iterations, at most 5000); each under four plans: the
two-launch form, and the cluster form with 8, 12 and 16 CTAs an image (12
and 16 are non-portable cluster sizes; 12 CTAs of 11 rows put ten images
on 120 SMs), in the order two-launch, 8, 16, 12, 8, 16, 12, two-launch.
A plan the card refuses (``cudaOccupancyMaxActiveClusters``) is printed as
refused.  Each call is timed with CUDA events three times after one
warm-up call under the same plan; the median and the spread, the
iteration count and the device operations (launches and copies) are
printed beside it, and whether its state (u, w, p, q) has the bits of the
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

ORDER = ("two-launch", "cl8", "cl16", "cl12", "cl8", "cl16", "cl12",
         "two-launch")
REPEATS = 3


def main():
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from bpldenoising_tpu_torch import _build
    from bpldenoising_tpu_torch.data import testdataset
    from bpldenoising_tpu_torch.solvers import cluster_plan, tgv_cuda

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    _build.library()
    _, noisy = testdataset("faces_train_128_10")
    f = torch.as_tensor(noisy, dtype=torch.float32).cuda()
    timed = cs.cuda_timer(torch)
    real = cluster_plan.tgv_plan

    def cluster(n):
        def plan(M, N, itemsize):
            rows = -(-M // n)
            return real(M, N, itemsize)._replace(
                cluster=n, rows=rows,
                smem=(cluster_plan.TGV_PLANES * (rows + 4)
                      + cluster_plan.TGV_SLOT_ROWS) * N * itemsize)
        return plan

    plans = {"two-launch": lambda *a: real(*a)._replace(resident=False,
                                                         smem=0),
             "cl8": cluster(8), "cl12": cluster(12), "cl16": cluster(16)}
    a = cs.TGV_ALPHA
    stacks = {1: f[:1].contiguous(), 10: f,
              64: f.repeat(7, 1, 1)[:64].contiguous()}
    kinds = (("cold 5000", dict(maxiter=5000, tol=None)),
             ("early stop", dict(maxiter=5000, tol=3e-6, check_every=100)))

    def solve(img, kw):
        return tgv_cuda.tgv_denoise_pdps_cuda(img, *a, return_state=True,
                                              **kw)

    out = dict(device=smi, order=ORDER, repeats=REPEATS, alpha=a)
    try:
        for n, img in stacks.items():
            for kind, kw in kinds:
                label = f"{n}x128x128 {kind}"
                row, first = [], None
                for name in ORDER:
                    tgv_cuda.tgv_plan = plans[name]
                    try:
                        solve(img, dict(kw, maxiter=20))
                    except RuntimeError as e:
                        row.append(dict(plan=name, refused=str(e)[-120:]))
                        continue
                    ms = []
                    for _ in range(REPEATS):
                        ops = tgv_cuda.device_ops
                        res, t = timed(lambda: solve(img, kw))
                        ms.append(t)
                    state = res[2]
                    if first is None and name != "two-launch":
                        first = state
                    row.append(dict(
                        plan=name, ms=statistics.median(ms), ms_all=ms,
                        iters=res[3], device_ops=tgv_cuda.device_ops - ops,
                        same_bits=None if first is None else all(
                            torch.equal(x, y)
                            for x, y in zip(state, first))))
                print(f"{label}: " + "; ".join(
                    f"{r['plan']} refused" if "refused" in r else
                    f"{r['plan']} {r['ms']:.3f} ms [{min(r['ms_all']):.3f}-"
                    f"{max(r['ms_all']):.3f}] ({r['iters']} its, "
                    f"{r['device_ops']} ops, bits {r['same_bits']})"
                    for r in row), flush=True)
                out[label] = row
    finally:
        tgv_cuda.tgv_plan = real
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
