#!/usr/bin/env python3
"""Times of the single-loop VTV library call in one tree, measured on one
NVIDIA GPU, for comparing trees run by turns.

    python3 scripts/vtv_sl_call_times.py [TREE]

Imports ``chip_smoke`` and ``bpldenoising_tpu_torch`` from TREE (default:
this script's repository; copy the script anywhere and pass another
checkout's root to time that tree), then times ``single_loop_vtv_cuda``
(``csrc/single_loop_vtv.cu``, TPU row 13) on the first 1 and 6 color
images of ``color_disks_128_10`` (3 × 128², float32) from 0.05 at 300
outer steps of 40 CP and 10 CG steps, of 40 CP and no CG steps, and of no
CP and 10 CG steps: three runs each with CUDA events after a 3-step
warm-up.  Prints one line: TREE and a JSON object {"B1 40/10": [ms, ms,
ms], ...}.  Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import json
import os
import sys

TREE = sys.argv[1] if len(sys.argv) > 1 else os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, TREE)

FORMS = ((40, 10), (40, 0), (0, 10))


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

    _build.library()
    true_np, noisy_np = testdataset("color_disks_128_10", color=True)
    timed = cs.cuda_timer(torch)
    x0 = np.array(0.05)
    out = {}
    for B in (1, 6):
        ut = torch.as_tensor(true_np[:B], dtype=torch.float32).cuda()
        f = torch.as_tensor(noisy_np[:B], dtype=torch.float32).cuda()
        for n_inner, n_adj in FORMS:
            kw = dict(outer=300, n_inner=n_inner, n_adj=n_adj)
            vfc.single_loop_vtv_cuda(ut, f, x0, **dict(kw, outer=3))
            out[f"B{B} {n_inner}/{n_adj}"] = [
                round(timed(lambda: vfc.single_loop_vtv_cuda(ut, f, x0,
                                                             **kw))[1], 3)
                for _ in range(3)]
    print(TREE, json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
