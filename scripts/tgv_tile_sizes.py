#!/usr/bin/env python3
"""The TGV² CP solve's tile form against its two-launch form, its
variants, and what bounds it, on one NVIDIA GPU.

    python3 scripts/tgv_tile_sizes.py [--quick]

The TGV² CP kernel runs its tile form (``csrc/tgv_tile.cu``, planned by
``solvers/cluster_plan.py::tgv_tile_plan``) where the bands of its cluster
form do not fit.  For each shape below (images made by tiling
``faces_train_128_10``, as chip_smoke.py's phases 7 and 64 do) the script
times, with CUDA events, three calls after one 20-iteration warm-up call
under each plan:

- ``two-launch``: the form the tile form replaced (two launches an
  iteration on state in global memory), forced by a patched plan;
- ``plan``: ``tgv_tile_plan``'s own tile (halo H = T: each variable on
  its own region; one wave of CTAs that walk the tiles);
- ``H=2T``: the uniform shrink per half-step of kernel A's scheme and of
  the TPU kernel, which needs H = 2T: a second build of the library from a
  copy of the sources with ``TT_REACH`` 2 (under ``output/``), on the plan
  ``tgv_tile_plan`` makes for that halo;
- ``T/2``, ``2T``: half and twice the plan's T on the largest square tile
  within the plan's shared-memory budget;
- ``one-cta`` (float32): the plan's T on the largest square tile whose
  planes fill the shared memory of one CTA an SM (16 warps an SM, not 32);
- ``per-tile``: the plan's tiles on a grid of one CTA a tile;

in the order two-launch, plan, the variants, plan, two-launch, and prints
the median and the spread, the device operations, the iterations and
whether u, w, p and q have the bits of the first plan run.  Then, for
1×1024² float32 (1000 its): ``torch.profiler`` over one call in the tile
and in the two-launch form (device time by kernel, idle share), and the
share of the SMs' issue slots that the tile form's per-pixel passes fill:
``cuobjdump -sass`` of ``tt_cp``'s pass bodies (tile_trace.py's
``pass_bodies``: the primal pass divides, the dual projects) times the
warp passes of the plan's regions (the primal step on the halo region less
``it`` pixels a side, the dual on that less one more), over the profiled
device time at the card's largest SM clock (four schedulers an SM).
``--quick`` takes 1×1024² only.  The lines also go to
``output/tgv_tile_sizes.json`` (under the repository).
"""

import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

REPEATS = 3
# csrc/tgv_tile.cu's TT_CPT
TT_CPT = 2


def shapes(torch, cs, quick):
    """(label, f, (α₁, α₀), solver arguments) of the timed calls."""
    from bpldenoising_tpu_torch.data import testdataset

    f = torch.as_tensor(testdataset("faces_train_128_10")[1],
                        dtype=torch.float32).cuda()
    out = [("1x1024x1024 1000", f[:1].repeat(1, 8, 8).contiguous(),
            (0.1, 0.2), dict(maxiter=1000, tol=None, check_every=100))]
    if quick:
        return out
    stop = dict(maxiter=5000, tol=3e-6, check_every=100)
    m512 = f[:4].repeat(1, 4, 4).contiguous()
    return out + [
        ("10x256x256 early stop", f.repeat(1, 2, 2).contiguous(),
         cs.TGV_ALPHA, stop),
        ("4x512x512 maps 1000", m512,
         (cs.random_map(m512, 1, 0.05, 0.12),
          cs.random_map(m512, 2, 0.03, 0.06)),
         dict(maxiter=1000, tol=None, check_every=100)),
        ("1x512x512 float64 early stop",
         f[:1].repeat(1, 4, 4).double().contiguous(), cs.TGV_ALPHA, stop)]


def reach2_library():
    """The kernel library built from a copy of the sources whose
    csrc/tgv_tile.cu has TT_REACH 2 (the uniform shrink, H = 2T), under
    output/, beside the loaded one."""
    import shutil

    from bpldenoising_tpu_torch import _build

    main = _build.library()
    where = ROOT / "output" / "tgv_tile_reach2"
    csrc = where / "csrc"
    shutil.rmtree(csrc, ignore_errors=True)
    shutil.copytree(_build.CSRC, csrc)
    src = csrc / "tgv_tile.cu"
    text = src.read_text()
    assert text.count("#define TT_REACH 1\n") == 1
    src.write_text(text.replace("#define TT_REACH 1\n",
                                "#define TT_REACH 2\n"))
    old = _build.CSRC, _build.BUILD_DIR
    _build.CSRC, _build.BUILD_DIR = csrc, where / "build"
    _build._LIB = None
    try:
        return _build.library()
    finally:
        _build.CSRC, _build.BUILD_DIR = old
        _build._LIB = main


def main():
    import torch
    if not torch.cuda.is_available():
        print("tgv_tile_sizes: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from bpldenoising_tpu_torch import _build
    from bpldenoising_tpu_torch.solvers import cluster_plan, tgv_cuda

    timed = cs.cuda_timer(torch)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(smi, flush=True)
    main_lib = _build.library()
    reach2 = reach2_library()
    real = cluster_plan.tgv_tile_plan
    order = ("two-launch", "plan", "H=2T", "T/2", "2T", "one-cta",
             "per-tile", "plan", "two-launch")

    def fit(M, N, itemsize, images, T, ctas):
        """T iterations on the largest square tile within the shared memory
        of ``ctas`` CTAs an SM, one wave of them walking the tiles."""
        budget = cluster_plan.SMEM_PER_BLOCK // ctas
        for side in range(256, 0, -4):
            q = cluster_plan.tgv_tile_geometry(M, N, itemsize, T, side, side,
                                               images=images)
            if q.smem <= budget and max(q.height, q.pitch) <= 256:
                return q._replace(grid=min(q.grid, ctas * cluster_plan.SMS))
        raise ValueError(f"no tile of T = {T} fits {budget} bytes")

    def halo_2t(M, N, itemsize, n_maps, images=1):
        cluster_plan.TGV_TILE_REACH = 2
        cluster_plan.tgv_tile_plan.cache_clear()
        try:
            return real(M, N, itemsize, n_maps, images)
        finally:
            cluster_plan.TGV_TILE_REACH = 1
            cluster_plan.tgv_tile_plan.cache_clear()

    def variant(name):
        if name == "two-launch":
            return lambda *a, **k: None
        if name == "H=2T":
            return halo_2t

        def plan(M, N, itemsize, n_maps, images=1):
            p = real(M, N, itemsize, n_maps, images)
            ctas = cluster_plan.TGV_TILE_CTAS[itemsize]
            if name == "one-cta":
                return fit(M, N, itemsize, images, p.T, 1)
            if name == "per-tile":
                return p._replace(grid=images * p.tiles_m * p.tiles_n)
            if name == "T/2":
                return fit(M, N, itemsize, images, max(1, p.T // 2), ctas)
            if name == "2T":
                return fit(M, N, itemsize, images, 2 * p.T, ctas)
            return p
        return plan

    out = dict(device=smi, repeats=REPEATS, order=order, rows={})
    try:
        for label, f, alphas, kw in shapes(torch, cs, "--quick" in sys.argv):
            a = cs.weights(alphas, f)
            n_maps = sum(x.ndim > 0 for x in a)
            row, ref = [], None
            for name in order:
                if name == "one-cta" and f.element_size() == 8:
                    continue                  # float64's plan: one CTA
                plan = variant(name)
                tgv_cuda.tgv_tile_plan = plan
                _build._LIB = reach2 if name == "H=2T" else main_lib
                try:
                    tgv_cuda.tgv_denoise_pdps_cuda(f, *a,
                                                   **dict(kw, maxiter=20))
                except RuntimeError as e:
                    row.append(dict(plan=name, refused=str(e)[-160:]))
                    continue
                ms = []
                for _ in range(REPEATS):
                    ops = tgv_cuda.device_ops
                    (_, _, state, its), t = timed(
                        lambda: tgv_cuda.tgv_denoise_pdps_cuda(
                            f, *a, return_state=True, **kw))
                    ms.append(t)
                if ref is None and name == "plan":
                    ref = state
                p = plan(f.shape[-2], f.shape[-1], f.element_size(), n_maps,
                         f.shape[0])
                row.append(dict(
                    plan=name, ms=statistics.median(ms), ms_all=ms,
                    iters=its, device_ops=tgv_cuda.device_ops - ops,
                    tile=None if p is None else p._asdict(),
                    same_bits=None if ref is None else all(
                        bool(torch.equal(x, y))
                        for x, y in zip(state, ref))))
            print(f"{label}: " + "; ".join(
                f"{r['plan']} refused ({r['refused']})" if "refused" in r
                else f"{r['plan']} {r['ms']:.3f} ms [{min(r['ms_all']):.3f}-"
                f"{max(r['ms_all']):.3f}] ({r['iters']} its, "
                f"{r['device_ops']} ops, bits {r['same_bits']}"
                + ("" if r["tile"] is None else
                   ", tile {rows}x{cols} T {T} H {H}, {tiles_m}x{tiles_n} "
                   "tiles, grid {grid}, smem {smem}".format(**r["tile"]))
                + ")" for r in row), flush=True)
            out["rows"][label] = row
    finally:
        tgv_cuda.tgv_tile_plan = real
        _build._LIB = main_lib
    out["trace"] = trace(torch, cs)
    dest = ROOT / "output"
    dest.mkdir(exist_ok=True)
    (dest / "tgv_tile_sizes.json").write_text(json.dumps(out, indent=1))
    return 0


def profile(torch, f, two_launch):
    """torch.profiler over one cold 1000-iteration call: wall, device
    busy, idle share, device ms and launches by kernel."""
    import time

    from bpldenoising_tpu_torch.solvers import tgv_cuda
    from torch.profiler import ProfilerActivity, profile as prof_

    real = tgv_cuda.tgv_tile_plan
    if two_launch:
        tgv_cuda.tgv_tile_plan = lambda *x, **k: None
    try:
        tgv_cuda.tgv_denoise_pdps_cuda(f, 0.1, 0.2, maxiter=20)
        torch.cuda.synchronize()
        with prof_(activities=[ProfilerActivity.CPU,
                               ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            tgv_cuda.tgv_denoise_pdps_cuda(f, 0.1, 0.2, maxiter=1000)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
    finally:
        tgv_cuda.tgv_tile_plan = real
    kernels, spans = {}, []
    for ev in prof.events():
        if ev.device_type.name != "CUDA" or ev.device_time_total <= 0:
            continue
        name = ev.name.split("(")[0].split("<")[0]
        k = kernels.setdefault(name, [0.0, 0])
        k[0] += ev.device_time_total / 1e3
        k[1] += 1
        spans.append((ev.time_range.start, ev.time_range.end))
    spans.sort()
    busy, end = 0.0, None
    for s, e in spans:
        if end is None or s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    window = (spans[-1][1] - spans[0][0]) if spans else 0.0
    return dict(form="two-launch" if two_launch else "tile", wall_ms=wall,
                device_busy_ms=busy / 1e3,
                idle_share=1.0 - busy / window if window else None,
                kernels={k: dict(ms=v[0], launches=v[1])
                         for k, v in sorted(kernels.items())})


def dynamic_count(plan, M, N, maxiter, bodies):
    """The warp instructions of tt_cp's per-pixel passes in one cold call
    of ``maxiter`` iterations on ``plan`` (one image), and the computed
    pixel-iterations (primal and dual regions averaged), following
    csrc/tgv_tile.cu's tt_iterate."""
    from tile_trace import region_passes

    launches = [plan.T] * (maxiter // plan.T) + (
        [maxiter % plan.T] if maxiter % plan.T else [])
    per_launch = {}
    for n_it in sorted(set(launches)):
        w = px = 0
        for tr in range(plan.tiles_m):
            for tc in range(plan.tiles_n):
                r0, c0 = tr * plan.rows, tc * plan.cols
                R0, C0 = r0 - plan.H, c0 - plan.H
                R1, C1 = r0 + plan.rows + plan.H, c0 + plan.cols + plan.H
                edge = not (R0 >= 1 and R1 <= M - 1 and C0 >= 1
                            and C1 <= N - 1)
                bp = bodies["primal"][-1 if edge else 0]
                bd = bodies["dual"][-1 if edge else 0]
                for it in range(n_it):
                    for e, body in ((it, bp), (it + 1, bd)):
                        rows = min(R1 - e, M) - max(R0 + e, 0)
                        cols = min(C1 - e, N) - max(C0 + e, 0)
                        n = max(rows, 0) * max(cols, 0)
                        w += region_passes(n, TT_CPT) * body
                        px += n
        per_launch[n_it] = (w, px)
    warp = sum(per_launch[n][0] for n in launches)
    pixels = sum(per_launch[n][1] for n in launches)
    return warp, pixels // 2


def trace(torch, cs):
    """The profiles of 1×1024² float32 in both forms, tt_cp's SASS pass
    bodies and the issue share of its passes."""
    from bpldenoising_tpu_torch import _build
    from bpldenoising_tpu_torch.data import testdataset
    from bpldenoising_tpu_torch.solvers import cluster_plan
    from tile_trace import _cuda_home, pass_bodies

    f = torch.as_tensor(testdataset("faces_train_128_10")[1],
                        dtype=torch.float32).cuda()
    img = f[:1].repeat(1, 8, 8).contiguous()
    out = dict(profiles=[profile(torch, img, two) for two in (False, True)])
    for row in out["profiles"]:
        print(f"1x1024x1024 {row['form']}: wall {row['wall_ms']:.2f} ms, "
              f"device busy {row['device_busy_ms']:.2f} ms, idle share "
              f"{row['idle_share']:.4f}; " + "; ".join(
                  f"{k} {v['ms']:.2f} ms / {v['launches']}"
                  for k, v in row["kernels"].items()), flush=True)
    sass = subprocess.run([str(Path(_cuda_home()) / "bin" / "cuobjdump"),
                           "-sass", str(_build.build().path)],
                          capture_output=True, text=True, timeout=600).stdout
    bodies = pass_bodies(sass, kernel="tt_cp", cpt=TT_CPT)
    inst = [n for n in bodies if n.startswith("_ZN3bpl5tt_cpIfLb0E")]
    out["pass_bodies"] = bodies
    if not inst or not all(bodies[inst[0]].values()):
        print(f"tt_cp: no pass bodies found in {sorted(bodies)}", flush=True)
        return out
    clock = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = cluster_plan.tgv_tile_plan(1024, 1024, 4, 0, 1)
    warp, pixels = dynamic_count(plan, 1024, 1024, 1000, bodies[inst[0]])
    ms = next(v["ms"] for k, v in out["profiles"][0]["kernels"].items()
              if "tt_cp" in k)
    share = warp / (sms * 4 * clock * 1e6 * ms * 1e-3)
    out["dynamic"] = dict(
        bodies=bodies[inst[0]], warp_instructions=warp,
        pixel_iterations=pixels, per_pixel_iteration=32 * warp / pixels,
        tt_cp_ms=ms, max_sm_clock_mhz=clock, issue_share=share)
    print(f"tt_cp (float32, scalar weights): pass bodies {bodies[inst[0]]}; "
          f"{warp} warp instructions in the passes over {pixels} computed "
          f"pixel-iterations ({32 * warp / pixels:.1f} thread instructions "
          f"each, {1024 * 1024 * 1000} owned); in {ms:.2f} ms of tt_cp at "
          f"{clock:.0f} MHz on {sms} SMs: {100 * share:.1f}% of the issue "
          "slots", flush=True)
    return out


if __name__ == "__main__":
    sys.exit(main())
