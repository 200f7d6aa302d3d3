#!/usr/bin/env python3
"""Reference numbers of the JAX package for the validations and the cost
sweeps of ``chip_smoke.py`` (phases 46–47), on the CPU in float64.

    python3 scripts/jax_reference_reporting.py [LABEL ...]

Validations (the JAX budgets: 10,000 iterations, 5000 for the sum of
regularizers; the whole dataset) at the learned weights of ``PERF.md``
§2: TV α 0.069788 on ``faces_val``, the sum of regularizers (0.03239759,
0.03223814, 0.00623653) on ``faces_val``, TGV² (0.085226, 0.044170) on
``faces_val``, TV-L1 α 1.9234402 on ``circle_sp``, VTV α 0.16529731 on
``color_disks``.  Sweeps (the JAX budgets: TV 10,000 iterations, the
others 5000; one image): TV over 8 α, 2-D TV over a 4×4 grid, TGV² over a
3×3 grid on ``faces_train``, TV-L1 over 5 α on ``circle_sp``, VTV over 5 α
on ``color_disks``.  Prints one JSON line per label: the cost, mean PSNR
and mean SSIM of a validation, the costs of a sweep, every digit, and the
seconds it took.  The functions write their files into a temporary
directory, which is removed.  The whole run takes a few minutes on a few
CPU cores.  This script runs the JAX package; the port and
``chip_smoke.py`` import none of it.
"""

from __future__ import annotations

import json
import os
import shutil
import sys
import tempfile
import time

os.environ["JAX_PLATFORMS"] = "cpu"
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

# label: (module, function, parameter, keywords); the same table as
# chip_smoke.py's REPORTING_VALIDATIONS
VALIDATIONS = {
    "val_tv": ("api", "validate_tv_parameter", 0.069788,
               dict(dataset_name="faces_val")),
    "val_sumregs": ("api", "validate_sumregs_parameter",
                    (0.03239759, 0.03223814, 0.00623653),
                    dict(dataset_name="faces_val")),
    "val_tgv": ("tgv", "validate_tgv_parameter", (0.085226, 0.044170),
                dict(dataset_name="faces_val")),
    "val_tvl1": ("tvl1", "validate_tvl1_parameter", 1.9234402,
                 dict(dataset_name="circle_sp")),
    "val_vtv": ("vtv", "validate_vtv_parameter", 0.16529731,
                dict(dataset_name="color_disks")),
}

# label: (module, function, dataset, ranges); chip_smoke.py's
# REPORTING_SWEEPS
SWEEPS = {
    "sweep_tv": ("api", "generate_scalar_tv_cost", "faces_train",
                 ([0.02, 0.03, 0.045, 0.06, 0.07, 0.085, 0.12, 0.2],)),
    "sweep_tv_2d": ("api", "generate_2d_tv_cost", "faces_train",
                    ([0.04, 0.06, 0.08, 0.1], [0.04, 0.06, 0.08, 0.1])),
    "sweep_tgv": ("tgv", "generate_tgv_cost", "faces_train",
                  ([0.06, 0.085226, 0.11], [0.03, 0.04417, 0.06])),
    "sweep_tvl1": ("tvl1", "generate_tvl1_cost", "circle_sp",
                   ([0.5, 1.0, 1.5, 1.9234402, 3.0],)),
    "sweep_vtv": ("vtv", "generate_vtv_cost", "color_disks",
                  ([0.08, 0.12, 0.16529731, 0.2, 0.3],)),
}


def main(argv):
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import importlib

    import numpy as np

    labels = argv or list(VALIDATIONS) + list(SWEEPS)
    here = os.getcwd()
    work = tempfile.mkdtemp(prefix="jax_reference_reporting_")
    os.chdir(work)
    try:
        for label in labels:
            t0 = time.perf_counter()
            if label in VALIDATIONS:
                mod, fn, p, kw = VALIDATIONS[label]
                m = importlib.import_module(
                    f"bpldenoising_tpu.experiments.{mod}")
                out = getattr(m, fn)(np.asarray(p), **kw)
                row = dict(cost=float(out["cost"]),
                           mean_psnr=float(out["mean_psnr"]),
                           mean_ssim=float(out["mean_ssim"]),
                           images=int(np.asarray(out["u"]).shape[0]))
            else:
                mod, fn, ds, ranges = SWEEPS[label]
                m = importlib.import_module(
                    f"bpldenoising_tpu.experiments.{mod}")
                costs = getattr(m, fn)(ds, *ranges)
                row = dict(costs=np.asarray(costs, np.float64).tolist())
            print(json.dumps(dict(label=label, **row,
                                  seconds=time.perf_counter() - t0)),
                  flush=True)
    finally:
        os.chdir(here)
        shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
