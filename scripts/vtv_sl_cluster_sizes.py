#!/usr/bin/env python3
"""The single-loop VTV learner's cluster size, measured on one NVIDIA GPU.

    python3 scripts/vtv_sl_cluster_sizes.py

On the first 1, 2 and 6 color images of ``color_disks_128_10`` (3 × 128²,
float32; 6 is the entry point's batch), and on the six repeated to 16 and
64 images, times the library call ``single_loop_vtv_cuda``
(``csrc/single_loop_vtv.cu``, TPU row 13) at bench.py's 300 outer steps of
40 CP and 10 CG steps from 0.05 at lr 0.05, with its CP phase planned at
8 and at 16 CTAs an image, in the order 8, 16, 16, 8.  Under each plan, three calls: the whole step
(300/40/10), the CP phase and the rest without the CG (300/40/0), and the
CG and the rest without the CP phase (300/0/10); from them the µs of one
CP iteration, ((300/40/10) − (300/0/10)) / 12,000, and of one CG step,
((300/40/10) − (300/40/0)) / 3,000.  Each call is timed with CUDA events
three times after one warm-up call under the same plan; the median and
the spread are printed, and whether α and u have the bits of the first
plan's.  Then, under the rule's plan, the whole step with the CG's blocks
taking one partial block and the same 256 pixels of the three planes
(``first_order_vtv_cuda.cg_slots`` forced to 1 and 3, in the order 1, 3,
3, 1), where the rule changes over (B·64 ≥ 132 at 128²).  Prints the
card's name and power limit first and one JSON line last.  Exits non-zero
without a CUDA device.
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
SLOTS = (1, 3, 3, 1)
BATCHES = (1, 2, 6, 16, 64)
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
    from bpldenoising_tpu_torch.bilevel import first_order_vtv_cuda as vfc
    from bpldenoising_tpu_torch.data import testdataset
    from bpldenoising_tpu_torch.solvers import cluster_plan

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    _build.library()
    true_np, noisy_np = testdataset("color_disks_128_10", color=True)
    timed = cs.cuda_timer(torch)
    real = cluster_plan.vtv_plan
    real_slots = vfc.cg_slots
    x0 = np.array(0.05)

    def timed_call(ut, f, **kw):
        """(median ms, all ms, (α, u, cost trajectory)) of REPEATS calls
        after a 3-step warm-up."""
        vfc.single_loop_vtv_cuda(ut, f, x0, **dict(kw, outer=3))
        ms, res = [], None
        for _ in range(REPEATS):
            res, t = timed(lambda: vfc.single_loop_vtv_cuda(ut, f, x0,
                                                            **kw))
            ms.append(t)
        return statistics.median(ms), ms, res

    def cluster(n):
        def plan(M, N, C, itemsize):
            rows = -(-M // n)
            smem = (4 * C * (rows + 4) + 16 * C) * N * itemsize
            fits = smem <= cluster_plan.SMEM_PER_BLOCK
            return real(M, N, C, itemsize)._replace(
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
                vfc.vtv_plan = cluster(n)
                entry = dict(cluster=n, rule=real(128, 128, 3, 4).cluster)
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
                entry["plan"] = str(vfc.last_plan)
                entry["us_per_cp_iteration"] = (
                    (entry["full"]["ms"] - entry["no_cp"]["ms"]) * 1e3
                    / (OUTER * 40))
                entry["us_per_cg_step"] = (
                    (entry["full"]["ms"] - entry["no_cg"]["ms"]) * 1e3
                    / (OUTER * 10))
                row.append(entry)
            print(f"{n_img}x3x128x128 (rule: {row[0]['rule']} CTAs): "
                  + "; ".join(
                      f"{e['cluster']} CTAs {e['full']['ms']:.2f} ms "
                      f"[{min(e['full']['ms_all']):.2f}-"
                      f"{max(e['full']['ms_all']):.2f}], no CG "
                      f"{e['no_cg']['ms']:.2f}, no CP {e['no_cp']['ms']:.2f}"
                      f" ({e['us_per_cp_iteration']:.2f} µs a CP "
                      f"iteration, {e['us_per_cg_step']:.2f} µs a CG step;"
                      f" bits {e['same_bits']})" for e in row), flush=True)
            out[f"{n_img}x3x128x128"] = row
            vfc.vtv_plan = real
            cg = []
            for slots in SLOTS:
                vfc.cg_slots = lambda *a, n=slots: n
                med, ms, res = timed_call(ut, f, outer=OUTER, n_inner=40,
                                          n_adj=10, lr=0.05)
                cg.append(dict(slots=slots, ms=med, ms_all=ms,
                               same_bits=bool(torch.equal(res[0], first[0])
                                              and torch.equal(res[1],
                                                              first[1]))))
            vfc.cg_slots = real_slots
            print(f"  CG blocks (rule: {real_slots(n_img, 128, 128, 3)} "
                  "slots): " + "; ".join(
                      f"{e['slots']} slots {e['ms']:.2f} ms "
                      f"[{min(e['ms_all']):.2f}-{max(e['ms_all']):.2f}] "
                      f"(bits {e['same_bits']})" for e in cg), flush=True)
            out[f"{n_img}x3x128x128 CG slots"] = cg
    finally:
        vfc.vtv_plan = real
        vfc.cg_slots = real_slots
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
