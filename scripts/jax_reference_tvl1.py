#!/usr/bin/env python3
"""Reference numbers of the JAX package for the TV-L1 checks of
``chip_smoke.py`` (phases 11 and 12), on the CPU in float32.

    python3 scripts/jax_reference_tvl1.py

On ``circle_sp_128_20`` (one 128² image, 20% salt-and-pepper noise):

1. ``bilevel_learn_tvl1_fused(backend="jnp")`` with bench.py's TV-L1
   trust-region settings (x₀ = 0.4, Δ₀ = 0.1, maxiter 15, tol 1e-5,
   ``inner_maxiter=2000``, ``inner_tol=1e-6``, ``check_every=100``,
   γ_d = 100, γ = 1000, the dtype's default adjoint CG), for the scalar
   weight and for x₀ = 0.4·ones((2, 2)): learned weight, cost, PSNR, outer
   iterations and adjoint-CG iterations;
2. ``tvl1_denoise(noisy, 0.9, maxiter=10000)``, ``TVL1Denoise``'s default
   budget at bench.py's weight: PSNR.

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

    from bpldenoising_tpu.bilevel.fused_tvl1 import bilevel_learn_tvl1_fused
    from bpldenoising_tpu.data import testdataset
    from bpldenoising_tpu.metrics.quality import psnr
    from bpldenoising_tpu.solvers.tvl1 import tvl1_denoise
    from bpldenoising_tpu.utils.config import Params

    true_, noisy = testdataset("circle_sp_128_20")
    ut = jnp.asarray(true_, jnp.float32)
    f = jnp.asarray(noisy, jnp.float32)
    params = Params(eta1=0.25, eta2=0.75, beta1=0.25, beta2=1.9,
                    delta0=0.1, maxiter=15, tol=1e-5)
    for label, x0 in (("scalar", 0.4), ("patch", 0.4 * np.ones((2, 2)))):
        res = bilevel_learn_tvl1_fused(
            (ut, f), xinit=jnp.asarray(x0, jnp.float32), params=params,
            inner_maxiter=2000, inner_tol=1e-6, check_every=100,
            gamma_d=100.0, gamma=1000.0, backend="jnp")
        k = int(res.iterations)
        cg = np.asarray(res.log)[:k, 4]
        print(f"{label}: x {np.asarray(res.x).tolist()}, cost "
              f"{float(res.cost)!r}, PSNR "
              f"{float(jnp.mean(psnr(ut, res.u)))!r} dB, {k} outer its, "
              f"adjoint CG {int(cg.sum())} its over the logged evaluations "
              f"({cg.astype(int).tolist()})", flush=True)
    u = tvl1_denoise(f, 0.9, maxiter=10000)
    print(f"tvl1_denoise(alpha 0.9, 10000 its): PSNR "
          f"{float(jnp.mean(psnr(ut, u)))!r} dB", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
