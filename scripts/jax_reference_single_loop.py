#!/usr/bin/env python3
"""Reference numbers of the JAX package for the single-loop checks of
``chip_smoke.py``, on the CPU in float32.

    python3 scripts/jax_reference_single_loop.py

On ``faces_train_128_10`` (10 × 128² pairs, float32), the JAX entry
points with ``method="single_loop"`` and their defaults (300 outer steps,
40 PD steps and 10 CG steps each, Adam at lr 0.05; ``bench.py:358-405``):

1. ``scalar_bilevel_tv_learn`` from α₀ = 0.1;
2. ``scalar_bilevel_sumregs_learn`` from α₀ = (1e-3, 1e-3, 1e-3);

each: the learned weight, the final cost ½Σ‖u − ū‖², the mean PSNR and
the final ‖dJ/dα‖.  Prints one line per learn.  This script runs the JAX
package (its jnp scan); the port and ``chip_smoke.py`` import none of it.
"""

from __future__ import annotations

import os
import sys
import tempfile

os.environ["JAX_PLATFORMS"] = "cpu"
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main():
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np

    from bpldenoising_tpu.data import testdataset
    from bpldenoising_tpu.experiments import api
    from bpldenoising_tpu.metrics.quality import psnr

    true_, _ = testdataset("faces_train_128_10")
    ut = jnp.asarray(true_, jnp.float32)
    kw = dict(dataset_name="faces_train", num_samples=10, dtype="float32",
              method="single_loop", save_results=False)
    os.chdir(tempfile.mkdtemp())    # the entry points may write output/
    for label, learn in (("tv", api.scalar_bilevel_tv_learn),
                         ("sumregs", api.scalar_bilevel_sumregs_learn)):
        res = learn(**kw)
        print(f"{label}: x {np.asarray(res.x).tolist()}, cost "
              f"{float(res.cost)!r}, PSNR "
              f"{float(jnp.mean(psnr(ut, jnp.asarray(res.u))))!r} dB, "
              f"g_norm {res.g_norm!r}, {res.iterations} outer steps",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
