#!/usr/bin/env python3
"""Kernel B's results with every digit, and no times, for a diff of two
trees on one card.

    python3 scripts/kernel_b_digits.py > digits.txt

Kernel B (``exact_hypergrad_cuda``, ``reg_hypergrad_cuda``) at the shapes
of ``chip_smoke.py`` phases 4 and 35 (float32, 10 × 128² faces; u from
kernel A's cold early-stopped solve; scalar TV, the sum of regularizers'
three scalars, a random (M, N) map with gradient maps; exact and
regularized; cold and from the cold call's p) and in float64 at 2 × 32²,
then the five TV-family trust-region learns through their entry points
(the flagship, patch TV 2×2, the sum of regularizers, the patch sum
2×2×3, the 16×16 grid; ``chip_smoke.py``'s settings).  Prints the
gradients (or the gradient maps' sums) and ‖p‖ as Python reprs, SHA-256
digests of p and the maps, the CG counts, and per learn the weights, cost,
mean PSNR, outer iterations, adjoint CG counts, the digest of u and of the
whole state.log.  It calls only the wrappers and entry points, so the same
file runs on an older tree of the port; two trees whose kernel B computes
the same bits print the same text.  Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import hashlib
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def digest(t):
    return hashlib.sha256(t.detach().contiguous().cpu().numpy().tobytes()
                          ).hexdigest()[:16]


def main():
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    from bpldenoising_tpu_torch.data import testdataset
    from bpldenoising_tpu_torch.experiments import api
    from bpldenoising_tpu_torch.metrics import psnr
    from bpldenoising_tpu_torch.models import sumregs_model, tv_model
    from bpldenoising_tpu_torch.solvers import hypergrad_cuda, pdps_cuda
    from bpldenoising_tpu_torch.solvers.hypergrad import HypergradConfig

    dev = torch.device("cuda")
    clean, noisy = testdataset("faces_train_128_10")
    ut = torch.as_tensor(clean, dtype=torch.float32).to(dev)
    f = torch.as_tensor(noisy, dtype=torch.float32).to(dev)
    gen = torch.Generator().manual_seed(0)
    amap = (0.05 + 0.05 * torch.rand((128, 128), generator=gen)).to(dev)
    s = lambda x, dt=torch.float32: torch.tensor(x, dtype=dt)  # noqa: E731
    forms = (("tv", tv_model(), (s(0.1),), False),
             ("sumregs", sumregs_model(), (s(0.035), s(0.032), s(0.005)),
              False),
             ("map", tv_model(), (amap,), True))

    def kernel_b(label, u, utrue, model, a, cfg, maps):
        for name, kern in (("exact", hypergrad_cuda.exact_hypergrad_cuda),
                           ("reg", hypergrad_cuda.reg_hypergrad_cuda)):
            p0 = None
            for start in ("cold", "warm"):
                g, p, info = kern(u, utrue, a, model, cfg, maps, p0)
                vals = [repr(float(x if x.ndim == 0 else x.double().sum()))
                        for x in g]
                maps_digest = (" maps " + ",".join(digest(x) for x in g)
                               if maps else "")
                print(f"B {label} {name} {start}: grad {vals} |p| "
                      f"{float(p.double().norm())!r} p {digest(p)}"
                      f"{maps_digest} CG {info.iters} (all "
                      f"{hypergrad_cuda.last_total_cg_iters}) converged "
                      f"{bool(info.converged)}", flush=True)
                p0 = p

    cfg = HypergradConfig(al_iters=2, cg_maxiter=100)
    for label, model, a, maps in forms:
        u = pdps_cuda.denoise_pdps_cuda(
            f, a, None, model=model, tau0=5.0, sigma0=0.99 / 5.0, gamma=1.0,
            maxiter=5000, accel=True, tol=5e-6, check_every=50,
            return_dual=False)
        print(f"A {label}: u {digest(u)}", flush=True)
        kernel_b(f"f32 {label}", u, ut, model, a, cfg, maps)

    f64 = torch.float64
    levels = torch.rand((2, 8, 8), generator=gen, dtype=f64)
    u = torch.kron(levels, torch.ones((4, 4), dtype=f64))
    u[:, 24:, :] += 0.3 * torch.linspace(0.0, 1.0, 32, dtype=f64)
    utrue = u + 0.05 * torch.randn(u.shape, generator=gen, dtype=f64)
    u, utrue = u.to(dev), utrue.to(dev)
    map64 = amap[:32, :32].to(f64)
    for label, model, a, maps in (
            ("tv", tv_model(), (s(0.07, f64),), False),
            ("sumregs maps", sumregs_model(),
             (map64, s(0.03, f64), 0.2 * map64), True)):
        kernel_b(f"f64 {label}", u, utrue, model, a,
                 HypergradConfig(al_iters=2, cg_maxiter=300, gamma=1e4), maps)

    base = dict(dataset_name="faces_train", num_samples=10, dtype="float32",
                save_results=False,
                method="tr_fused", maxiter=20, tol=1e-5, inner_maxiter=5000,
                inner_tol=1e-6, check_every=100,
                hypergrad_cfg=HypergradConfig(al_iters=2, cg_maxiter=100))
    learns = (
        ("flagship", api.scalar_bilevel_tv_learn,
         dict(base, alpha0=0.1, inner_tol=5e-6, check_every=50)),
        ("patch_tv", api.patch_bilevel_tv_learn, base),
        ("sumregs", api.scalar_bilevel_sumregs_learn, base),
        ("patch_sumregs", api.patch_bilevel_sumregs_learn, base),
        ("grid16", api.patch_bilevel_tv_learn,
         dict(base, alpha0=0.069788 * np.ones((16, 16)),
              delta0=0.069788 / 4, maxiter=16, inner_maxiter=2000,
              hypergrad_cfg=HypergradConfig())))
    for name, learn, kw in learns:
        res = learn(device="cuda", **kw)
        x = np.asarray(res.x, dtype=np.float64).ravel()
        u = torch.as_tensor(res.u).to(dev)
        log = res.state.log
        log_text = "\n".join(
            f"{e.iter} {e.function_value!r} {e.g_norm!r} {e.delta!r} "
            f"{e.step_norm!r} {e.adjoint_cg_iters!r} "
            f"{e.adjoint_cg_converged!r}" for e in log)
        shown = x.tolist() if x.size <= 12 else \
            f"{x.size} weights, sum {float(x.sum())!r}, " \
            f"digest {hashlib.sha256(x.tobytes()).hexdigest()[:16]}"
        print(f"learn {name}: x {shown} cost {float(res.cost)!r} PSNR "
              f"{float(torch.mean(psnr(ut, u)))!r} outer {res.iterations} "
              f"adjoint CG {int(sum(e.adjoint_cg_iters for e in log))} u "
              f"{digest(u)} log "
              f"{hashlib.sha256(log_text.encode()).hexdigest()[:16]}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
