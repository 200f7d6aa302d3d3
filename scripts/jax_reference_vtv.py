#!/usr/bin/env python3
"""Reference numbers of the JAX package for the VTV checks of
``chip_smoke.py`` (phases 15 and 16), on the CPU in float32.

    python3 scripts/jax_reference_vtv.py

On ``color_disks_128_10`` (six 3 × 128² RGB pairs, planar, float32):

1. ``bilevel_learn_vtv_fused(backend="jnp")`` with bench.py's VTV
   trust-region settings (x₀ = 0.05, Δ₀ = 0.02, η = 0.25/0.75,
   β = 0.25/1.9, maxiter 20, tol 1e-5, ``inner_maxiter=5000``,
   ``inner_tol=1e-5``, ``check_every=100``, γ = 1e-4, ``cg_tol=1e-6``,
   ``cg_maxiter=1000``), for the scalar weight and, with the patch entry
   point's β₂ = 1.5, for x₀ = 0.05·ones((2, 2)): learned weight, cost,
   mean PSNR, outer iterations and adjoint-CG iterations;
2. ``vtv_denoise(noisy, 0.165434, maxiter=10000)``, ``VTVDenoise``'s
   default budget at the weight of ``FIDELITY.md:12``: mean PSNR.

Prints one line per item.  This script runs the JAX package; the port and
``chip_smoke.py`` import none of it.
"""

from __future__ import annotations

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main():
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np

    from bpldenoising_tpu.bilevel.fused_vtv import bilevel_learn_vtv_fused
    from bpldenoising_tpu.data import testdataset
    from bpldenoising_tpu.metrics.quality import psnr
    from bpldenoising_tpu.solvers.pdps import vtv_denoise
    from bpldenoising_tpu.utils.config import Params

    true_, noisy = testdataset("color_disks_128_10", color=True)
    ut = jnp.asarray(true_, jnp.float32)
    f = jnp.asarray(noisy, jnp.float32)
    tr = dict(eta1=0.25, eta2=0.75, beta1=0.25, delta0=0.02, maxiter=20,
              tol=1e-5)
    for label, x0, beta2 in (("scalar", 0.05, 1.9),
                             ("patch", 0.05 * np.ones((2, 2)), 1.5)):
        res = bilevel_learn_vtv_fused(
            (ut, f), xinit=jnp.asarray(x0, jnp.float32),
            params=Params(tr, beta2=beta2), inner_maxiter=5000,
            inner_tol=1e-5, check_every=100, gamma=1e-4, cg_tol=1e-6,
            cg_maxiter=1000, backend="jnp")
        k = int(res.iterations)
        cg = np.asarray(res.log)[:k, 4]
        print(f"{label}: x {np.asarray(res.x).tolist()}, cost "
              f"{float(res.cost)!r}, PSNR "
              f"{float(jnp.mean(psnr(ut, res.u)))!r} dB, {k} outer its, "
              f"adjoint CG {int(cg.sum())} its over the logged evaluations "
              f"({cg.astype(int).tolist()})", flush=True)
    u = vtv_denoise(f, 0.165434, maxiter=10000)
    print(f"vtv_denoise(alpha 0.165434, 10000 its): PSNR "
          f"{float(jnp.mean(psnr(ut, u)))!r} dB", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
