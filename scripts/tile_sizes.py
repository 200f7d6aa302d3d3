#!/usr/bin/env python3
"""Kernel A's tile form against its two-launch form, and the tile form's
variants, timed on one NVIDIA GPU.

    python3 scripts/tile_sizes.py [--quick]

Kernel A (``csrc/pdps.cu``) runs its tile form (``csrc/pd_tile.cuh``,
planned by ``solvers/cluster_plan.py::pd_tile_plan``) where the bands of
its cluster form do not fit.  For each shape below (float32 unless
marked; images made by tiling ``faces_train_128_10``, as chip_smoke.py's
phase 7 does; a cold call of a fixed budget) the script times, with CUDA
events, three calls after one 20-iteration warm-up call under each plan:

- ``two-launch``: the form the tile form replaced (two launches an
  iteration on state in global memory), forced by a patched plan;
- ``plan``: ``pd_tile_plan``'s own tile (two CTAs an SM, one CTA a
  tile);
- ``one-cta``: the plan's T on the largest square tile whose planes fill
  the shared memory of one CTA an SM;
- ``walk``: the plan's tiles on a grid of two CTAs an SM that walks them
  (a persistent grid);
- ``T/2``, ``2T``: half and twice the plan's T on the largest square tile
  whose planes fit two CTAs an SM;

in the order two-launch, plan, the variants, plan, two-launch, and prints
the median and the spread, the device operations and whether u and the
duals have the bits of the two-launch form's.  ``--quick`` takes the two
2048² shapes only.  The lines also go to ``output/tile_sizes.json`` (under the repository).
"""

import json
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

REPEATS = 3


def shapes(torch, cs, quick):
    """(label, f, model, alphas, maxiter) of the timed calls."""
    from bpldenoising_tpu_torch.data import testdataset
    from bpldenoising_tpu_torch.models import sumregs_model, tv_model

    f = torch.as_tensor(testdataset("faces_train_128_10")[1],
                        dtype=torch.float32).cuda()
    a3 = cs.sumregs_weights()[0]
    big = f[:1].repeat(1, 16, 16).contiguous()
    out = [("1x2048x2048 K=1 1000", big, tv_model(), (0.1,), 1000),
           ("1x2048x2048 K=3 1000", big, sumregs_model(), a3, 1000)]
    if quick:
        return out
    amap = cs.random_map(big, 0, 0.05, 0.1)
    m512 = f[:4].repeat(1, 4, 4).contiguous()
    out += [
        ("1x1024x1024 K=1 5000", f[:1].repeat(1, 8, 8).contiguous(),
         tv_model(), (0.1,), 5000),
        ("4x512x512 K=1 map 1000", m512, tv_model(),
         (cs.random_map(m512, 1, 0.05, 0.1),), 1000),
        ("1x256x256 K=3 5000", f[:1].repeat(1, 2, 2).contiguous(),
         sumregs_model(), a3, 5000),
        ("1x2048x2048 K=3 maps 1000", big, sumregs_model(),
         (amap, 0.5 * amap, 0.1 * amap), 1000),
        ("1x1024x1024 K=3 float64 1000",
         f[:1].repeat(1, 8, 8).double().contiguous(), sumregs_model(), a3,
         1000)]
    return out


def main():
    import torch
    if not torch.cuda.is_available():
        print("tile_sizes: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from bpldenoising_tpu_torch.solvers import cluster_plan, pdps_cuda

    timed = cs.cuda_timer(torch)
    smi = cs.subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(smi, flush=True)
    real = cluster_plan.pd_tile_plan
    order = ("two-launch", "plan", "one-cta", "walk", "T/2", "2T", "plan",
             "two-launch")

    def fit(M, N, K, itemsize, centred, images, T, budget):
        """T iterations on the largest square tile within ``budget``."""
        for side in range(256, 0, -4):
            q = cluster_plan.tile_geometry(M, N, K, itemsize,
                                           2 if centred else 1, T, side,
                                           side, images=images)
            if q.smem <= budget and max(q.height, q.pitch) <= 256:
                return q
        raise ValueError(f"no tile of T = {T} fits {budget} bytes")

    def variant(name):
        if name == "two-launch":
            return lambda *a, **k: None

        def plan(M, N, K, itemsize, n_maps, centred, images=1):
            p = real(M, N, K, itemsize, n_maps, centred, images=images)
            shape = (M, N, K, itemsize, centred, images)
            half = cluster_plan.SMEM_PER_BLOCK // 2
            if name == "one-cta":
                return fit(*shape, p.T, cluster_plan.SMEM_PER_BLOCK)
            if name == "walk":
                return p._replace(grid=min(p.grid, 2 * cluster_plan.SMS))
            if name == "T/2":
                return fit(*shape, max(1, p.T // 2), half)
            if name == "2T":
                return fit(*shape, 2 * p.T, half)
            return p
        return plan

    plans = {name: variant(name) for name in order}
    out = dict(device=smi, repeats=REPEATS, order=order, rows={})
    try:
        for label, f, model, alphas, maxiter in shapes(
                torch, cs, "--quick" in sys.argv):
            a = cs.weights(alphas, f)
            kw = dict(model=model, tau0=5.0, sigma0=0.99 / 5.0, gamma=1.0,
                      accel=True, tol=None, check_every=50, return_dual=True)
            row, ref = [], None
            for name in order:
                pdps_cuda.pd_tile_plan = plans[name]
                try:
                    pdps_cuda.denoise_pdps_cuda(f, a, None,
                                                **dict(kw, maxiter=20))
                except RuntimeError as e:
                    row.append(dict(plan=name, refused=str(e)[-160:]))
                    continue
                ms = []
                for _ in range(REPEATS):
                    ops = pdps_cuda.device_ops
                    (u, ys, _), t = timed(lambda: pdps_cuda.denoise_pdps_cuda(
                        f, a, None, **dict(kw, maxiter=maxiter)))
                    ms.append(t)
                state = (u,) + tuple(ys)
                if ref is None:
                    ref = state
                p = plans[name](f.shape[-2], f.shape[-1], model.K,
                                f.element_size(),
                                sum(x.ndim > 0 for x in a),
                                model.K > 1, images=f.shape[0])
                row.append(dict(
                    plan=name, ms=statistics.median(ms), ms_all=ms,
                    device_ops=pdps_cuda.device_ops - ops,
                    tile=None if p is None else p._asdict(),
                    same_bits=all(bool(torch.equal(x, y))
                                  for x, y in zip(state, ref))))
            print(f"{label}: " + "; ".join(
                f"{r['plan']} refused ({r['refused']})" if "refused" in r
                else f"{r['plan']} {r['ms']:.3f} ms [{min(r['ms_all']):.3f}-"
                f"{max(r['ms_all']):.3f}] ({r['device_ops']} ops, bits "
                f"{r['same_bits']}"
                + ("" if r["tile"] is None else
                   ", tile {rows}x{cols} T {T} H {H}, {tiles_m}x{tiles_n} "
                   "tiles, grid {grid}, smem {smem}".format(**r["tile"]))
                + ")" for r in row), flush=True)
            out["rows"][label] = row
    finally:
        pdps_cuda.pd_tile_plan = real
    dest = ROOT / "output"
    dest.mkdir(exist_ok=True)
    (dest / "tile_sizes.json").write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
