#!/usr/bin/env python3
"""The trust region's trial costs on chip_smoke.py's 4 × 512² learn:
warm-chained, early-stopped inner solves against cold ones.

    python3 scripts/trial_costs.py [--noise S] [--device cuda|cpu]

Phase 63 runs ``bilevel_learn_fused`` at the flagship's settings on four
512² phantoms (``chip_smoke.tile_learn_data``).  The trust region accepts
a trial when its cost is lower than the current one, and every evaluation
warm-starts its inner solve from the previous evaluation's (u, y) and stops
it when u changes by less than ``inner_tol`` over ``check_every``
iterations (``bilevel/fused.py``).  This script replays the first
evaluation (a cold solve at α₀) and the trials of a trust region that
rejects them all with its step at the radius: α₀ + Δ with Δ = Δ₀·β₁ᵏ, k =
0 … 6 (``experiments/api.py::bilevel_params``: Δ₀ = 0.1, β₁ = 0.25; the
learn stops when Δ falls below its tol, after seven), each solve
warm-started from the one before, as in the learn; beside each, a cold
solve at the same α.  It prints the costs, their difference from α₀'s
cost and the iterations each solve ran.  float32, as the learn; the solves
only (no hypergradient).
The default noise is the learn's (``chip_smoke.TILE_LEARN_NOISE``);
``--device cpu`` runs the plain solver.
"""

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

TRIALS = 7


def main(argv=None):
    import torch
    import chip_smoke as cs
    from bpldenoising_tpu_torch.experiments.api import bilevel_params
    from bpldenoising_tpu_torch.learning.tv import _SOLVER_DEFAULTS
    from bpldenoising_tpu_torch.models import tv_model
    from bpldenoising_tpu_torch.solvers.pdps_cuda import denoise_pdps_cuda

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--noise", type=float, default=cs.TILE_LEARN_NOISE)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        print("trial_costs: no CUDA device", file=sys.stderr)
        return 1
    cs.TILE_LEARN_NOISE = args.noise
    true, noisy = cs.tile_learn_data()
    ut = torch.as_tensor(true, dtype=torch.float32, device=args.device)
    f = torch.as_tensor(noisy, dtype=torch.float32, device=args.device)
    kw = cs.flagship_kwargs()
    skw = dict(_SOLVER_DEFAULTS, tol=kw["inner_tol"],
               check_every=kw["check_every"])
    model = tv_model()

    def solve(alpha, state0):
        a = torch.tensor(alpha, dtype=torch.float32, device=args.device)
        u, ys, iters = denoise_pdps_cuda(
            f, (a,), state0, model=model, maxiter=kw["inner_maxiter"],
            return_dual=True, **skw)
        return float(0.5 * torch.sum((u - ut) ** 2)), (u, ys), iters

    a0 = kw["alpha0"]
    c0, state, it0 = solve(a0, None)
    print(f"{cs.TILE_LEARN_IMAGES}x{cs.TILE_LEARN_SIZE}x{cs.TILE_LEARN_SIZE}"
          f" float32 on {args.device}, noise {args.noise!r}: alpha0 "
          f"{a0!r} cold cost {c0!r} ({it0} its)", flush=True)
    delta = bilevel_params.delta0
    for _ in range(TRIALS):
        alpha = a0 + delta
        cw, state, itw = solve(alpha, state)
        cc, _, itc = solve(alpha, None)
        print(f"alpha {alpha!r}: warm-chained {cw!r} ({cw - c0:+.6g}, "
              f"{itw} its), cold {cc!r} ({cc - c0:+.6g}, {itc} its)",
              flush=True)
        delta *= bilevel_params.beta1
    return 0


if __name__ == "__main__":
    sys.exit(main())
