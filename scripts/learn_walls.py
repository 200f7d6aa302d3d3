#!/usr/bin/env python3
"""Wall times of one family's learns on one NVIDIA GPU, for comparing two
trees run by turns.

    python3 scripts/learn_walls.py {tv,patch_tv,sumregs,grid16,tgv,tvl1,vtv,
                                    single_loop_tgv,single_loop_tvl1,
                                    single_loop_vtv} [--runs N]

Runs the learns of ``scripts/torch_profile.py FAMILY`` (the same data,
preloaded on the card, and the same settings) once each to warm up, then
N times each (default 1), every run timed with CUDA events.  Prints the
card's name and power limit first and, last, one JSON line
``{"device": ..., "family": ..., LABEL: [ms, ...], ...}``.  It uses only
``torch_profile.setup``, so a copy placed in another tree's ``scripts/``
times that tree's learns (copy ``torch_profile.py`` beside it where that
tree's ``setup`` lacks the family).  Exits non-zero without a CUDA
device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("family", choices=("tv", "patch_tv", "sumregs",
                                       "grid16", "tgv", "tvl1", "vtv",
                                       "single_loop_tgv",
                                       "single_loop_tvl1",
                                       "single_loop_vtv"))
    ap.add_argument("--runs", type=int, default=1)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    import torch_profile
    from bpldenoising_tpu_torch import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    _build.library()
    learn, runs, _, _ = torch_profile.setup(args.family, torch)
    timed = chip_smoke.cuda_timer(torch)
    out = dict(device=smi, family=args.family)
    for label, (x0, params) in runs.items():
        learn(x0, params)   # warm-up
        out[label] = [timed(lambda: learn(x0, params))[1]
                      for _ in range(args.runs)]
        print(f"{label}: {out[label]} ms", flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
