#!/usr/bin/env python3
"""Times of one kernel family's library calls, measured on one NVIDIA GPU,
for comparing two checkouts run by turns.

    python3 scripts/call_times.py FAMILY

FAMILY is one of:

- ``tgv``: ``tgv_denoise_pdps_cuda`` (``csrc/tgv.cu``, TPU rows 4–5) as
  ``chip_smoke.py`` phases 6 and 7 call it: on ``faces_train_128_10``
  (10 × 128² float32) a cold 5000-iteration call with the scalar weights
  (0.085226, 0.044170) and with the 2×2 patch maps of phase 6, and a cold
  call with the learns' early stop (tol 3e-6, every 100 iterations, at
  most 5000); on the first image tiled to 1024² 1000 iterations at
  (0.1, 0.2).  After a 20-iteration warm-up each;
- ``vtv``: ``vtv_denoise_pdps_cuda`` (``csrc/vtv.cu``, TPU row 6) as
  ``chip_smoke.py`` phase 13 calls it: on ``color_disks_128_10`` (6 × 3 ×
  128² float32) a cold 5000-iteration call with α 0.165 and with the 2×2
  patch map of phase 13, and a cold call with the learns' early stop (tol
  1e-5, every 100 iterations, at most 5000); on the first image tiled to
  3 × 256² 1000 iterations at 0.165 (the two-launch form), before the
  cluster-form calls and again after them.  After a 20-iteration warm-up
  each;
- ``single_loop_vtv``: ``single_loop_vtv_cuda`` (``csrc/single_loop_vtv.cu``,
  TPU row 13) on the first 1 and 6 color images of ``color_disks_128_10``
  (3 × 128², float32) from 0.05 at 300 outer steps of 40 CP and 10 CG
  steps, of 40 CP and no CG steps, and of no CP and 10 CG steps.  After a
  3-step warm-up each.

Three runs of each call, timed with CUDA events.  Imports ``chip_smoke``
and ``bpldenoising_tpu_torch`` from the checkout the script lies in: to
time another checkout, copy the script into its ``scripts/``.  Prints one
line: the checkout's root and a JSON object {"label": [ms, ms, ms], ...},
for ``tgv`` and ``vtv`` with "device_ops" (the device operations of one
call of each, where the checkout's wrapper counts them).  Exits non-zero
without a CUDA device.
"""

from __future__ import annotations

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

FAMILIES = ("tgv", "vtv", "single_loop_vtv")


def timed_calls(torch, timed, mod, calls):
    """{label: [ms, ms, ms], "device_ops": {label: n}} of ``calls``, each
    (label, solve(**over)), after a 20-iteration warm-up each; device
    operations where ``mod`` counts them."""
    out, ops = {}, {}
    for label, solve in calls:
        solve(maxiter=20)
        before = getattr(mod, "device_ops", None)
        out[label] = [round(timed(solve)[1], 3) for _ in range(3)]
        if before is not None:
            ops[label] = (mod.device_ops - before) // 3
    out["device_ops"] = ops
    return out


def tgv_calls(torch, cs, timed):
    from bpldenoising_tpu_torch.data import testdataset
    from bpldenoising_tpu_torch.ops import PatchOp
    from bpldenoising_tpu_torch.solvers import tgv_cuda

    _, noisy_np = testdataset("faces_train_128_10")
    f = torch.as_tensor(noisy_np, dtype=torch.float32).cuda()
    pop = PatchOp((2, 2), tuple(f.shape[-2:]))
    maps = tuple(pop.apply(torch.tensor(g, dtype=f.dtype)).cuda()
                 for g in (cs.TGV_PATCH_A1, cs.TGV_PATCH_A0))
    big = f[:1].repeat(1, 8, 8).contiguous()
    calls = {
        "cold scalar": (f, cs.TGV_ALPHA, dict(maxiter=5000, tol=None)),
        "cold map": (f, maps, dict(maxiter=5000, tol=None)),
        "early stop": (f, cs.TGV_ALPHA, dict(maxiter=5000, tol=3e-6,
                                             check_every=100)),
        "1x1024x1024 1000": (big, (0.1, 0.2), dict(maxiter=1000, tol=None)),
    }
    return timed_calls(torch, timed, tgv_cuda, [
        (label, lambda img=img, a=a, kw=kw, **over:
         tgv_cuda.tgv_denoise_pdps_cuda(img, *a, **dict(kw, **over)))
        for label, (img, a, kw) in calls.items()])


def vtv_calls(torch, cs, timed):
    from bpldenoising_tpu_torch.data import testdataset
    from bpldenoising_tpu_torch.ops import PatchOp
    from bpldenoising_tpu_torch.solvers import vtv_cuda

    _, noisy_np = testdataset("color_disks_128_10", color=True)
    f = torch.as_tensor(noisy_np, dtype=torch.float32).cuda()
    pop = PatchOp((2, 2), tuple(f.shape[-2:]))
    amap = pop.apply(torch.tensor(cs.VTV_PATCH_GRID, dtype=f.dtype)).cuda()
    big = f[:1].repeat(1, 1, 2, 2).contiguous()
    big_call = (big, 0.165, dict(maxiter=1000, tol=None))
    calls = {
        "1x3x256x256 1000 first": big_call,
        "cold scalar": (f, 0.165, dict(maxiter=5000, tol=None)),
        "cold map": (f, amap, dict(maxiter=5000, tol=None)),
        "early stop": (f, 0.165, dict(maxiter=5000, tol=1e-5,
                                      check_every=100)),
        "1x3x256x256 1000 last": big_call,
    }
    return timed_calls(torch, timed, vtv_cuda, [
        (label, lambda img=img, a=a, kw=kw, **over:
         vtv_cuda.vtv_denoise_pdps_cuda(img, (a,), **dict(kw, **over)))
        for label, (img, a, kw) in calls.items()])


def single_loop_vtv_calls(torch, cs, timed):
    import numpy as np
    from bpldenoising_tpu_torch.bilevel import first_order_vtv_cuda as vfc
    from bpldenoising_tpu_torch.data import testdataset

    true_np, noisy_np = testdataset("color_disks_128_10", color=True)
    x0 = np.array(0.05)
    out = {}
    for B in (1, 6):
        ut = torch.as_tensor(true_np[:B], dtype=torch.float32).cuda()
        f = torch.as_tensor(noisy_np[:B], dtype=torch.float32).cuda()
        for n_inner, n_adj in ((40, 10), (40, 0), (0, 10)):
            kw = dict(outer=300, n_inner=n_inner, n_adj=n_adj)
            vfc.single_loop_vtv_cuda(ut, f, x0, **dict(kw, outer=3))
            out[f"B{B} {n_inner}/{n_adj}"] = [
                round(timed(lambda: vfc.single_loop_vtv_cuda(ut, f, x0,
                                                             **kw))[1], 3)
                for _ in range(3)]
    return out


def main(argv):
    if len(argv) != 1 or argv[0] not in FAMILIES:
        print(f"usage: call_times.py {{{','.join(FAMILIES)}}}",
              file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from bpldenoising_tpu_torch import _build

    _build.library()
    run = dict(tgv=tgv_calls, vtv=vtv_calls,
               single_loop_vtv=single_loop_vtv_calls)[argv[0]]
    print(ROOT, json.dumps(run(torch, cs, cs.cuda_timer(torch))))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
