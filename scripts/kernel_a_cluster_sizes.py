#!/usr/bin/env python3
"""Kernel A's cluster size, measured on one NVIDIA GPU.

    python3 scripts/kernel_a_cluster_sizes.py

On the flagship data (``faces_train_128_10``, 10 × 128² float32) times
kernel A (``csrc/pdps.cu``) in its three forms of the main paths (K = 1
scalar, an (M, N) α map, K = 3 forward/backward/centred) for a cold
5000-iteration call and a cold call with the early stop (tol 5e-6, every
50 iterations), under four plans: the two-launch form, and the cluster
form with 4, 8 (``solvers/cluster_plan.py::pd_plan``'s rule) and 16 CTAs
an image (16 is a non-portable cluster size), in the order two-launch, 8,
16, 4, 8, two-launch.  Each call is timed with CUDA events after one
20-iteration warm-up call under the same plan; the iteration count and the
device operations (launches and copies) are printed beside it.  Prints the
card's name and power limit first and one JSON line last.  Exits non-zero
without a CUDA device.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

ORDER = ("two-launch", "cl8", "cl16", "cl4", "cl8", "two-launch")


def main():
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from bpldenoising_tpu_torch import _build
    from bpldenoising_tpu_torch.data import testdataset
    from bpldenoising_tpu_torch.models import sumregs_model, tv_model
    from bpldenoising_tpu_torch.solvers import cluster_plan, pdps_cuda

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    _build.library()
    _, noisy = testdataset("faces_train_128_10")
    f = torch.as_tensor(noisy, dtype=torch.float32).cuda()
    timed = cs.cuda_timer(torch)
    real = cluster_plan.pd_plan

    def cluster(n):
        def plan(M, N, K, itemsize):
            p = real(M, N, K, itemsize)
            rows = -(-M // n)
            smem = ((2 + 2 * K) * (rows + 4) + 16 * K) * N * itemsize
            return p._replace(cluster=n, rows=rows, smem=smem)
        return plan

    plans = {"two-launch": lambda *a: real(*a)._replace(resident=False,
                                                        smem=0),
             "cl4": cluster(4), "cl8": real, "cl16": cluster(16)}
    amap = cs.random_map(f, 0, 0.05, 0.1)
    forms = (("K=1", tv_model(), (0.1,)), ("map", tv_model(), (amap,)),
             ("K=3", sumregs_model(), cs.sumregs_weights()[0]))
    kw = dict(tau0=5.0, sigma0=0.99 / 5.0, gamma=1.0, accel=True,
              return_dual=True)
    out = dict(device=smi, shape=list(f.shape), order=ORDER)
    try:
        for label, model, alphas in forms:
            a = cs.weights(alphas, f)
            for mode, extra in (("cold 5000", dict(maxiter=5000, tol=None,
                                                  check_every=50)),
                                ("early stop", dict(maxiter=5000, tol=5e-6,
                                                    check_every=50))):
                row = []
                for name in ORDER:
                    pdps_cuda.pd_plan = plans[name]
                    pdps_cuda.denoise_pdps_cuda(f, a, None, model=model,
                                                **kw, **dict(extra,
                                                             maxiter=20))
                    ops = pdps_cuda.device_ops
                    (_, _, its), ms = timed(
                        lambda: pdps_cuda.denoise_pdps_cuda(
                            f, a, None, model=model, **kw, **extra))
                    row.append(dict(plan=name, ms=ms, iters=its,
                                    device_ops=pdps_cuda.device_ops - ops))
                print(f"{label} {mode}: " + "; ".join(
                    f"{r['plan']} {r['ms']:.2f} ms ({r['iters']} its, "
                    f"{r['device_ops']} ops)" for r in row), flush=True)
                out[f"{label} {mode}"] = row
    finally:
        pdps_cuda.pd_plan = real
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
