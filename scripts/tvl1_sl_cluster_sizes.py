#!/usr/bin/env python3
"""The single-loop TV-L1 learner's cluster size, measured on one NVIDIA GPU.

    python3 scripts/tvl1_sl_cluster_sizes.py

On the first 1, 2, 8 and 16 images of ``circle_sp_128_20`` (128²,
float32; one is the entry point's batch), and on the twenty repeated to
64, times the library call ``single_loop_tvl1_cuda``
(``csrc/single_loop_tvl1.cu``, TPU row 12) at bench.py's 300 outer steps
of 40 CP and 10 CG steps from 0.4 at lr 0.05, with its CP phase planned
at 8 and at 16 CTAs an image, in the order 8, 16, 16, 8.  Under each
plan, three calls: the whole step (300/40/10), the CP phase and the rest
without the CG (300/40/0), and the CG and the rest without the CP phase
(300/0/10); from them the µs of one CP iteration, ((300/40/10) −
(300/0/10)) / 12,000, and of one CG step, ((300/40/10) − (300/40/0)) /
3,000.  Each call is timed with CUDA events three times after one warm-up
call under the same plan; the median and the spread are printed, and
whether α and u have the bits of the first plan's.  The rule
(``solvers/tvl1_cuda.py::tvl1_plan``) takes 16 while B·16 ≤ 132.  Prints
the card's name and power limit first and one JSON line last.  Exits
non-zero without a CUDA device.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

ORDER = (8, 16, 16, 8)
BATCHES = (1, 2, 8, 16, 64)
FORMS = {"full": (40, 10), "no_cg": (40, 0), "no_cp": (0, 10)}
REPEATS = 3
OUTER = 300


def main():
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from bpldenoising_tpu_torch import _build
    from bpldenoising_tpu_torch.bilevel import first_order_tvl1_cuda as lfc
    from bpldenoising_tpu_torch.data import testdataset
    from bpldenoising_tpu_torch.solvers import cluster_plan

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    _build.library()
    true_np, noisy_np = testdataset("circle_sp_128_20")
    timed = cs.cuda_timer(torch)
    real = lfc.tvl1_plan
    x0 = np.array(0.4)

    def timed_call(ut, f, **kw):
        """(median ms, all ms, (α, u, cost trajectory)) of REPEATS calls
        after a 3-step warm-up."""
        lfc.single_loop_tvl1_cuda(ut, f, x0, **dict(kw, outer=3))
        ms, res = [], None
        for _ in range(REPEATS):
            res, t = timed(lambda: lfc.single_loop_tvl1_cuda(ut, f, x0,
                                                             **kw))
            ms.append(t)
        return statistics.median(ms), ms, res

    def cluster(n):
        def plan(B, M, N, itemsize):
            rows = -(-M // n)
            smem = (4 * (rows + 4) + 16) * N * itemsize
            fits = smem <= cluster_plan.SMEM_PER_BLOCK
            return real(B, M, N, itemsize)._replace(
                cluster=n, rows=rows, smem=smem if fits else 0,
                resident=fits)
        return plan

    out = dict(device=smi, order=ORDER, repeats=REPEATS, outer=OUTER)
    try:
        for n_img in BATCHES:
            pick = np.arange(n_img) % len(true_np)
            ut = torch.as_tensor(true_np[pick], dtype=torch.float32).cuda()
            f = torch.as_tensor(noisy_np[pick], dtype=torch.float32).cuda()
            row, first = [], None
            for n in ORDER:
                lfc.tvl1_plan = cluster(n)
                entry = dict(cluster=n, rule=real(n_img, 128, 128, 4).cluster)
                for form, (n_inner, n_adj) in FORMS.items():
                    med, ms, res = timed_call(ut, f, outer=OUTER,
                                              n_inner=n_inner, n_adj=n_adj,
                                              lr=0.05)
                    entry[form] = dict(ms=med, ms_all=ms)
                    if form == "full":
                        if first is None:
                            first = res
                        entry["same_bits"] = bool(
                            torch.equal(res[0], first[0])
                            and torch.equal(res[1], first[1]))
                entry["plan"] = str(lfc.last_plan)
                entry["us_per_cp_iteration"] = (
                    (entry["full"]["ms"] - entry["no_cp"]["ms"]) * 1e3
                    / (OUTER * 40))
                entry["us_per_cg_step"] = (
                    (entry["full"]["ms"] - entry["no_cg"]["ms"]) * 1e3
                    / (OUTER * 10))
                row.append(entry)
            print(f"{n_img}x128x128 (rule: {row[0]['rule']} CTAs): "
                  + "; ".join(
                      f"{e['cluster']} CTAs {e['full']['ms']:.2f} ms "
                      f"[{min(e['full']['ms_all']):.2f}-"
                      f"{max(e['full']['ms_all']):.2f}], no CG "
                      f"{e['no_cg']['ms']:.2f}, no CP {e['no_cp']['ms']:.2f}"
                      f" ({e['us_per_cp_iteration']:.2f} µs a CP "
                      f"iteration, {e['us_per_cg_step']:.2f} µs a CG step;"
                      f" bits {e['same_bits']})" for e in row), flush=True)
            out[f"{n_img}x128x128"] = row
    finally:
        lfc.tvl1_plan = real
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
