#!/usr/bin/env python3
"""What one CG iteration of kernel B costs on the card, against the number
of virtual blocks each CTA walks.

    python3 scripts/kernel_b_iteration_cost.py

Kernel B (``csrc/hypergrad.cu``) is one cooperative launch whose grid is
min(virtual blocks, co-resident CTAs); a CTA walks its virtual blocks (256
pixels each) one after the other in every pass of a CG iteration.  This
script runs the regularized form on the first O ∈ {1, 2, 4, 6, 8, 10} faces
images (float32, 128²) for K = 1 (scalar TV) and K = 3 (the sum of
regularizers) with ``cg_tol`` 0, so CG always runs to its cap, and times
calls with a cap of 200 and of 0 iterations (CUDA events, median of 5
after a warm-up): (t(200) − t(0)) / 200 is the device time of one CG
iteration, t(0) the set-up, the gradient, the launch and the read.  With
the grid size and the virtual blocks per CTA beside it, the rise from one
virtual block a CTA to two or three says what the serial walk costs, and
the one-block cost what the three grid barriers and the redundant sums
cost.  Prints the card's name and power limit, one line per case and a
JSON line last.  It calls only the wrapper, so it also times an older
tree of the port.  Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main():
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    from bpldenoising_tpu_torch.data import testdataset
    from bpldenoising_tpu_torch.models import sumregs_model, tv_model
    from bpldenoising_tpu_torch.solvers import hypergrad_cuda
    from bpldenoising_tpu_torch.solvers.hypergrad import HypergradConfig

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    clean, noisy = testdataset("faces_train_128_10")
    dev = torch.device("cuda")
    ut_all = torch.as_tensor(clean, dtype=torch.float32).to(dev)
    u_all = torch.as_tensor(noisy, dtype=torch.float32).to(dev)
    s = lambda x: torch.tensor(x, dtype=torch.float32)   # noqa: E731
    forms = (("K=1", tv_model(), (s(0.1),)),
             ("K=3", sumregs_model(), (s(0.035), s(0.032), s(0.005))))

    def ms(u, ut, model, a, its):
        cfg = HypergradConfig(cg_tol=0.0, cg_maxiter=its)
        hypergrad_cuda.reg_hypergrad_cuda(u, ut, a, model, cfg)
        times = []
        for _ in range(5):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            _, _, info = hypergrad_cuda.reg_hypergrad_cuda(u, ut, a, model,
                                                           cfg)
            end.record()
            end.synchronize()
            assert info.iters == its, (info.iters, its)
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    rows = []
    for label, model, a in forms:
        for O in (1, 2, 4, 6, 8, 10):
            u, ut = u_all[:O].contiguous(), ut_all[:O].contiguous()
            t0 = ms(u, ut, model, a, 0)
            t200 = ms(u, ut, model, a, 200)
            # an older tree of the port (one launch a kernel step, no
            # grid) has no last_grid
            grid = getattr(hypergrad_cuda, "last_grid", 0)
            vbs = u.numel() // 256
            per_cta = -(-vbs // grid) if grid else None
            us = (t200 - t0) / 200 * 1e3
            rows.append(dict(form=label, images=O, virtual_blocks=vbs,
                             grid=grid, blocks_per_cta=per_cta,
                             us_per_cg_iter=us, fixed_ms=t0))
            print(f"{label} {O:2d} images: {vbs} virtual blocks on {grid} "
                  f"CTAs ({per_cta} a CTA): {us:.2f} us a CG iteration, "
                  f"{t0:.3f} ms with no iteration", flush=True)
    print(json.dumps(dict(device=smi, rows=rows)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
