#!/usr/bin/env python3
"""Reference numbers of the JAX package for the patch TV and
sum-of-regularizers trust-region checks of ``chip_smoke.py``, on the CPU.

    python3 scripts/jax_reference_tv_family.py [--float64] [--perturb=S]
        [LABEL ...]

``bilevel_learn_fused(backend="jnp")`` on ``faces_train_128_10`` (10 ×
128²), the trust region's η/β of ``bench.py:54-57`` (tol 1e-5), the inner
solve at ``inner_maxiter=5000``, ``inner_tol=1e-6``, ``check_every=100``
and ``HypergradConfig(al_iters=2, cg_maxiter=100)`` unless stated:

- ``patch_tv``: x₀ = 1e-4·ones((2, 2)), Δ₀ 1e-4, maxiter 20, Δt 1e-6
  (``bench.py:309-316``);
- ``sumregs``: ``sumregs_model()``, x₀ = (1e-3, 1e-3, 1e-3), Δ₀ 0.01,
  maxiter 20, Δt 1e-3 (``bench.py:318-325``);
- ``patch_sumregs``: ``sumregs_model()``, the entry point's defaults
  (x₀ = 1e-3·ones((2, 2, 3)), Δ₀ 0.1, β₂ 1.5), maxiter 20, Δt 1e-3;
- ``grid16``: a 16×16 grid from the flagship's α 0.069788 (256
  parameters, above ``lbfgs_threshold`` 64: L-BFGS), Δ₀ α/4, maxiter 16,
  ``inner_maxiter=2000`` and the default ``HypergradConfig()``
  (``bench.py:1034-1050``);
- ``sumregs_witness`` and ``patch_tv_witness``: as ``sumregs`` with
  maxiter 4 and ``patch_tv`` with maxiter 8, with
  ``HypergradConfig(al_iters=2, cg_maxiter=1000, act_tol=1e-4)``, whose
  adjoint systems are well conditioned (an active set that float64
  rounding does not move), run with ``--float64``.

Each: the learned parameter, the final cost ½Σ‖u − ū‖², the mean PSNR,
the outer iterations and the log (cost, ‖g‖, Δ, step, CG iterations, CG
converged per outer iteration).  Prints one line per label (by default
all but the witnesses) in the working dtype, float32 unless
``--float64``.  ``--perturb=S`` multiplies the noisy images by
1 + ε·ξ (ε the dtype's machine epsilon, ξ standard normal from seed S):
the same learn on data one rounding away, whose spread from the
unperturbed run is the reference's own float32 band.  The learns on these
settings are what the port's entry points run (``patch_bilevel_tv_learn``, ``scalar_bilevel_sumregs_learn``,
``patch_bilevel_sumregs_learn`` with ``method="tr_fused"``, the same
parameters and ``check_every=100``).  This script runs the JAX package;
the port and ``chip_smoke.py`` import none of it.
"""

from __future__ import annotations

import json
import os
import sys
import time

os.environ["JAX_PLATFORMS"] = "cpu"
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

FLAGSHIP_ALPHA = 0.069788
TR = dict(eta1=0.25, eta2=0.75, beta1=0.25, beta2=1.9, tol=1e-5)
INNER = dict(inner_maxiter=5000, inner_tol=1e-6, check_every=100)


def cases(np, HypergradConfig):
    fast = HypergradConfig(al_iters=2, cg_maxiter=100)
    well = HypergradConfig(al_iters=2, cg_maxiter=1000, act_tol=1e-4)
    return {
        "patch_tv": dict(x0=1e-4 * np.ones((2, 2)), sumregs=False,
                         tr=dict(delta0=1e-4, maxiter=20), delta_t=1e-6,
                         inner=INNER, cfg=fast),
        "sumregs": dict(x0=np.array([1e-3, 1e-3, 1e-3]), sumregs=True,
                        tr=dict(delta0=0.01, maxiter=20), delta_t=1e-3,
                        inner=INNER, cfg=fast),
        "patch_sumregs": dict(x0=1e-3 * np.ones((2, 2, 3)), sumregs=True,
                              tr=dict(delta0=0.1, beta2=1.5, maxiter=20),
                              delta_t=1e-3, inner=INNER, cfg=fast),
        "grid16": dict(x0=FLAGSHIP_ALPHA * np.ones((16, 16)), sumregs=False,
                       tr=dict(delta0=FLAGSHIP_ALPHA / 4, maxiter=16),
                       delta_t=1e-6, inner=dict(INNER, inner_maxiter=2000),
                       cfg=HypergradConfig()),
        "sumregs_witness": dict(
            x0=np.array([1e-3, 1e-3, 1e-3]), sumregs=True,
            tr=dict(delta0=0.01, maxiter=4), delta_t=1e-3, inner=INNER,
            cfg=well),
        "patch_tv_witness": dict(
            x0=1e-4 * np.ones((2, 2)), sumregs=False,
            tr=dict(delta0=1e-4, maxiter=8), delta_t=1e-6, inner=INNER,
            cfg=well),
    }


def main():
    args = sys.argv[1:]
    f64 = "--float64" in args
    perturb = [int(a.split("=")[1]) for a in args
               if a.startswith("--perturb=")]
    labels = [a for a in args if not a.startswith("--")]
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", f64)
    import jax.numpy as jnp
    import numpy as np

    from bpldenoising_tpu.bilevel.fused import bilevel_learn_fused
    from bpldenoising_tpu.data import testdataset
    from bpldenoising_tpu.metrics.quality import psnr
    from bpldenoising_tpu.models import sumregs_model, tv_model
    from bpldenoising_tpu.solvers.hypergrad import HypergradConfig
    from bpldenoising_tpu.utils.config import Params

    dt = jnp.float64 if f64 else jnp.float32
    true_, noisy = testdataset("faces_train_128_10")
    ut = jnp.asarray(true_, dt)
    f = jnp.asarray(noisy, dt)
    if perturb:
        xi = np.random.default_rng(perturb[0]).standard_normal(noisy.shape)
        f = f * (1 + jnp.finfo(dt).eps * jnp.asarray(xi, dt))
    table = cases(np, HypergradConfig)
    labels = labels or [k for k in table if not k.endswith("_witness")]
    for label in labels:
        c = table[label]
        t0 = time.perf_counter()
        res = bilevel_learn_fused(
            (ut, f), xinit=jnp.asarray(c["x0"], dt),
            params=Params(TR, **c["tr"]),
            model=sumregs_model() if c["sumregs"] else tv_model(),
            delta_t=c["delta_t"], cfg=c["cfg"], backend="jnp", **c["inner"])
        k = int(res.iterations)
        out = dict(label=label, dtype="float64" if f64 else "float32",
                   perturb=perturb[0] if perturb else None,
                   x=np.asarray(res.x).tolist(), cost=float(res.cost),
                   psnr_db=float(jnp.mean(psnr(ut, res.u))),
                   iterations=k, log=np.asarray(res.log)[:k].tolist(),
                   seconds=time.perf_counter() - t0)
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
