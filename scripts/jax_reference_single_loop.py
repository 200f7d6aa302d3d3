#!/usr/bin/env python3
"""Reference numbers of the JAX package for the single-loop checks of
``chip_smoke.py``, on the CPU in float32.

    python3 scripts/jax_reference_single_loop.py [--float64] [LABEL ...]

The JAX entry points with ``method="single_loop"`` and their defaults
(300 outer steps, 40 PD steps and 10 CG steps each):

- ``tv``: ``scalar_bilevel_tv_learn`` on ``faces_train_128_10`` (10 ×
  128²) from α₀ = 0.1, Adam at lr 0.05 (``bench.py:358-405``);
- ``sumregs``: ``scalar_bilevel_sumregs_learn`` on the same images from
  α₀ = (1e-3, 1e-3, 1e-3);
- ``tgv``: ``scalar_bilevel_tgv_learn`` on the same images from
  (0.05, 0.05), lr 0.02;
- ``tvl1``: ``scalar_bilevel_tvl1_learn`` on one ``circle_sp_128_20``
  image from 0.4, γ_d 100, γ 1000;
- ``vtv``: ``scalar_bilevel_vtv_learn`` on six ``color_disks_128_10``
  color images from 0.05;

and the library calls at ``bench.py``'s settings for the one-launch
learners (``bench.py:665-683``, ``:878-893``, ``:1011-1020``), through the
jnp scan (the Pallas kernels' oracle on one image, which the CPU runs):

- ``tgv_call``: ``single_loop_tgv_learn`` on the first faces image from
  (0.05, 0.05), lr 0.02;
- ``tvl1_call``: ``single_loop_tvl1_learn`` on the circle_sp image from
  0.4;
- ``vtv_call``: ``single_loop_vtv_learn`` on the first color_disks image
  from 0.05.

Each: the learned weight, the final cost ½Σ‖u − ū‖², the mean PSNR and
the final ‖dJ/dα‖.  Prints one line per label (all by default).
``--float64`` runs the same in float64: the gap between the two is the
reference's own float32 band, which sets a gate where it is wider than
the default.  This
script runs the JAX package (its jnp scan); the port and
``chip_smoke.py`` import none of it.
"""

from __future__ import annotations

import os
import sys
import tempfile

os.environ["JAX_PLATFORMS"] = "cpu"
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main():
    args = sys.argv[1:]
    f64 = "--float64" in args
    labels = [a for a in args if a != "--float64"]
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", f64)
    import jax.numpy as jnp
    import numpy as np

    from bpldenoising_tpu.bilevel import (single_loop_tgv_learn,
                                          single_loop_tvl1_learn,
                                          single_loop_vtv_learn)
    from bpldenoising_tpu.data import testdataset
    from bpldenoising_tpu.experiments import api, tgv, tvl1, vtv
    from bpldenoising_tpu.metrics.quality import psnr

    dtype = "float64" if f64 else "float32"

    def data(name, n, color=False):
        true_, noisy = testdataset(name, color=color)
        return (jnp.asarray(true_[:n], dtype),
                jnp.asarray(noisy[:n], dtype))

    faces = dict(dataset_name="faces_train", num_samples=10)
    entries = {
        "tv": (api.scalar_bilevel_tv_learn, faces, ("faces_train_128_10", 10)),
        "sumregs": (api.scalar_bilevel_sumregs_learn, faces,
                    ("faces_train_128_10", 10)),
        "tgv": (tgv.scalar_bilevel_tgv_learn, faces,
                ("faces_train_128_10", 10)),
        "tvl1": (tvl1.scalar_bilevel_tvl1_learn,
                 dict(dataset_name="circle_sp"), ("circle_sp_128_20", 1)),
        "vtv": (vtv.scalar_bilevel_vtv_learn,
                dict(dataset_name="color_disks", num_samples=6),
                ("color_disks_128_10", 6, True)),
    }
    calls = {
        "tgv_call": (single_loop_tgv_learn, ("faces_train_128_10", 1),
                     np.array([0.05, 0.05]), dict(lr=0.02)),
        "tvl1_call": (single_loop_tvl1_learn, ("circle_sp_128_20", 1), 0.4,
                      {}),
        "vtv_call": (single_loop_vtv_learn, ("color_disks_128_10", 1, True),
                     0.05, {}),
    }
    labels = labels or list(entries) + list(calls)
    os.chdir(tempfile.mkdtemp())    # the entry points may write output/
    for label in labels:
        if label in entries:
            learn, kw, ds = entries[label]
            ut, _ = data(*ds)
            res = learn(dtype=dtype, method="single_loop",
                        save_results=False, **kw)
            x, u, cost, g = res.x, res.u, res.cost, res.g_norm
            steps = res.iterations
        else:
            learn, ds, x0, kw = calls[label]
            ut, f = data(*ds)
            res = learn(ut, f, jnp.asarray(x0, dtype), outer=300,
                        n_inner=40, n_adj=10, **kw)
            x, u, cost = res.alpha, res.u, res.cost
            g, steps = float(res.gnorm_trajectory[-1]), 300
        print(f"{label}: x {np.asarray(x).tolist()}, cost "
              f"{float(cost)!r}, PSNR "
              f"{float(jnp.mean(psnr(ut, jnp.asarray(u))))!r} dB, "
              f"g_norm {g!r}, {steps} outer steps", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
