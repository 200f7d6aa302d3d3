#!/usr/bin/env python3
"""Reference numbers of the JAX package for the host trust region
(``method="tr"``, the default) of ``chip_smoke.py``, on the CPU.

    python3 scripts/jax_reference_tr.py

The flagship default call, ``scalar_bilevel_tv_learn(
dataset_name="faces_train", num_samples=10)`` (``save_results=False``, so
nothing is written), in float64 as its defaults ask: ``method="tr"``,
``inner_maxiter=5000`` with no early stop (every inner solve cold),
``HypergradConfig()``, 20 outer iterations at most, α₀ = 0.1, Δ₀ = 0.1,
tol 1e-5.  Prints one JSON line: the learned α, the final cost
½Σ‖u − ū‖², the mean PSNR over the ten images, the outer iterations and
the log (iteration, cost, ‖g‖, Δ, step, adjoint-CG iterations, CG
converged per logged iteration) with every digit, and the seconds the
learn took.  The learn takes a few minutes on a few CPU cores.  This
script runs the JAX package; the port and ``chip_smoke.py`` import none
of it.
"""

from __future__ import annotations

import json
import os
import sys
import time

os.environ["JAX_PLATFORMS"] = "cpu"
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main():
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from bpldenoising_tpu.data import testdataset
    from bpldenoising_tpu.experiments.api import scalar_bilevel_tv_learn
    from bpldenoising_tpu.metrics.quality import psnr

    true_, _ = testdataset("faces_train_128_10")
    ut = jnp.asarray(true_, jnp.float64)
    t0 = time.perf_counter()
    res = scalar_bilevel_tv_learn(dataset_name="faces_train", num_samples=10,
                                  save_results=False)
    seconds = time.perf_counter() - t0
    log = [[e.iter, e.function_value, e.g_norm, e.delta, e.step_norm,
            e.adjoint_cg_iters, e.adjoint_cg_converged]
           for e in res.state.log]
    print(json.dumps(dict(
        label="flagship_default", dtype=str(jnp.asarray(res.u).dtype),
        x=float(res.x), cost=float(res.cost),
        psnr_db=float(jnp.mean(psnr(ut, jnp.asarray(res.u)))),
        iterations=int(res.iterations), log=log, seconds=seconds)),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
