#!/usr/bin/env python3
"""What bounds kernel A's tile form on one NVIDIA GPU: a profiled call and
the compiled instruction mix.

    python3 scripts/tile_trace.py

1. ``torch.profiler`` (CUDA activity) over one cold 1000-iteration call of
   kernel A at 1 × 2048² float32, K = 1 and K = 3, in the tile form and in
   the two-launch form (forced by a patched plan): the device time by
   kernel name, the kernel launches, the call's wall (host clock, after a
   synchronize) and the share of it in which the device ran no kernel.
2. ``cuobjdump -sass`` of the built library: for each instance of the tile
   kernel ``pdt_cp``, its instruction count and the counts of shared-memory
   loads and stores (LDS, STS), global loads (LDG), barriers (BAR),
   floating-point instructions (FADD, FMUL, DADD, DMUL, MUFU, ...) and the
   rest (integer, predicates, moves, branches); and its innermost loops
   (the body from a backward branch's target to the branch), of which the
   per-pixel passes are told apart by their special functions: a primal
   pass divides (MUFU.RCP, one a slot), a dual pass projects (MUFU.RSQ).
3. The dynamic count of the float32 tile calls of item 1, without a
   hardware counter (the card's profilers are not available): the warp
   instructions of the per-pixel passes, each region's passes a warp runs
   (``pt_region``: PT_CPT slots of PT_THREADS threads a pass) times its
   pass body's instructions (the masked body on tiles near the edge, the
   other elsewhere), summed over the plan's launches, tiles, iterations
   and regions; and the share of the SMs' issue slots (four schedulers an
   SM, one warp instruction a cycle each, at the card's largest SM clock)
   that they fill in the kernel's profiled device time.

Prints one line per item; the whole report also goes to
``output/tile_trace.json`` (under the repository).
"""

import collections
import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def profile_call(torch, cs, label, f, model, alphas, two_launch):
    from bpldenoising_tpu_torch.solvers import pdps_cuda
    from torch.profiler import ProfilerActivity, profile

    kw = dict(model=model, tau0=5.0, sigma0=0.99 / 5.0, gamma=1.0,
              accel=True, tol=None, check_every=50, return_dual=True)
    a = cs.weights(alphas, f)
    real = pdps_cuda.pd_tile_plan
    if two_launch:
        pdps_cuda.pd_tile_plan = lambda *x, **k: None
    try:
        pdps_cuda.denoise_pdps_cuda(f, a, None, **dict(kw, maxiter=20))
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            pdps_cuda.denoise_pdps_cuda(f, a, None, **dict(kw, maxiter=1000))
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        pdps_cuda.pd_tile_plan = real
    kernels = collections.defaultdict(lambda: [0.0, 0])
    spans = []
    for ev in prof.events():
        if ev.device_type.name != "CUDA" or ev.device_time_total <= 0:
            continue
        name = ev.name.split("(")[0].split("<")[0]
        kernels[name][0] += ev.device_time_total / 1e3
        kernels[name][1] += 1
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
    row = dict(form="two-launch" if two_launch else "tile", wall_ms=wall_ms,
               device_busy_ms=busy / 1e3,
               idle_share=1.0 - busy / window if window else None,
               kernels={k: dict(ms=v[0], launches=v[1])
                        for k, v in sorted(kernels.items())})
    print(f"{label} {row['form']}: wall {wall_ms:.2f} ms, device busy "
          f"{row['device_busy_ms']:.2f} ms, idle share "
          f"{row['idle_share']:.4f}; " + "; ".join(
              f"{k} {v['ms']:.2f} ms / {v['launches']}"
              for k, v in row["kernels"].items()), flush=True)
    return row


FP = re.compile(r"^(FADD|FMUL|FFMA|FSET|FSETP|FMNMX|FSEL|DADD|DMUL|DFMA|"
                r"DSETP|DMNMX|MUFU|FCHK|F2F|I2F|F2I|FRND)")


def sass_mix(text):
    """{kernel instance: instruction counts by class} of pdt_cp in
    ``cuobjdump -sass``'s ``text``."""
    out, name = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1) if "pdt_cp" in m.group(1) else None
            if name:
                out[name] = collections.Counter()
            continue
        if name is None:
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_.]+)",
                     line)
        if not m:
            continue
        op = m.group(1).split(".")[0]
        cls = ("LDS" if op == "LDS" else "STS" if op == "STS" else
               "LDG" if op in ("LDG", "LD") else
               "BAR" if op == "BAR" else "SHFL" if op == "SHFL" else
               "FP" if FP.match(op) else "other")
        out[name][cls] += 1
        out[name]["total"] += 1
    return {k: dict(v) for k, v in out.items()}


INS = re.compile(r"\s*/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?"
                 r"([A-Z0-9_.]+)([^;]*);")
# pd_tile.cuh's PT_THREADS, PT_CPT
PT_THREADS, PT_CPT = 512, 4


def pass_bodies(text, kernel="pdt_cp", cpt=PT_CPT):
    """{``kernel`` instance: {"primal": [body lengths], "dual": [...]}}:
    the innermost loops of each instance (a backward branch and its
    target) that divide (one MUFU.RCP a slot of ``cpt``, or more: primal)
    or project (MUFU.RSQ: dual), shortest first (the unmasked body, then
    the masked)."""
    ins, name = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1) if kernel in m.group(1) else None
            if name:
                ins[name] = []
            continue
        m = INS.match(line) if name else None
        if m:
            ins[name].append((int(m.group(1), 16), m.group(2), m.group(3)))
    out = {}
    for name, code in ins.items():
        backs = []
        for a, op, rest in code:
            t = re.search(r"0x([0-9a-f]+)", rest)
            if op.startswith("BRA") and t and int(t.group(1), 16) <= a:
                backs.append((int(t.group(1), 16), a))
        kinds = {"primal": [], "dual": []}
        for s, e in backs:
            if any(s <= s2 and e2 <= e and (s2, e2) != (s, e)
                   for s2, e2 in backs):
                continue
            body = [op for a, op, _ in code if s <= a <= e]
            rcp = sum(op.startswith("MUFU.RCP") for op in body)
            rsq = sum(op.startswith("MUFU.RSQ") for op in body)
            lds = sum(op.startswith("LDS") for op in body)
            if rsq >= cpt:
                kinds["dual"].append(len(body))
            elif rcp >= cpt and lds:
                kinds["primal"].append(len(body))
        out[name] = {k: sorted(v) for k, v in kinds.items()}
    return out


def region_passes(n, cpt=PT_CPT):
    """Warp passes of pt_region over n pixels: warp w runs
    ⌈(n − 32w) / (cpt·PT_THREADS)⌉ passes where n > 32w."""
    step = cpt * PT_THREADS
    return sum(-(-(n - 32 * w) // step) for w in range(PT_THREADS // 32)
               if n > 32 * w)


def dynamic_count(plan, M, N, kinds, maxiter, bodies):
    """The warp instructions of the per-pixel passes of one cold call of
    ``maxiter`` iterations on ``plan`` (one image), and the computed
    pixel-iterations, following pd_tile.cuh's pt_iterate."""
    pl = int(any(k != 1 for k in kinds))      # not backward
    ph = int(any(k != 0 for k in kinds))      # not forward
    lo = hi = pl + ph
    warp, pixels = 0, 0
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
                edge = not (R0 >= 2 and R1 <= M - 2 and C0 >= 2
                            and C1 <= N - 2)
                bp = bodies["primal"][-1 if edge else 0]
                bd = bodies["dual"][-1 if edge else 0]
                for it in range(n_it):
                    for (a, b), body in (((pl, ph), bp), ((lo, hi), bd)):
                        rows = min(R1 - it * hi - b, M) - max(
                            R0 + it * lo + a, 0)
                        cols = min(C1 - it * hi - b, N) - max(
                            C0 + it * lo + a, 0)
                        n = max(rows, 0) * max(cols, 0)
                        w += region_passes(n) * body
                        px += n
        per_launch[n_it] = (w, px)
    for n_it in launches:
        warp += per_launch[n_it][0]
        pixels += per_launch[n_it][1]
    return warp, pixels // 2


def _cuda_home():
    from bpldenoising_tpu_torch import _build
    return str(Path(_build.nvcc_path()).parents[1])


def main():
    import torch
    if not torch.cuda.is_available():
        print("tile_trace: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from bpldenoising_tpu_torch import _build
    from bpldenoising_tpu_torch.data import testdataset
    from bpldenoising_tpu_torch.models import sumregs_model, tv_model
    from bpldenoising_tpu_torch.solvers import cluster_plan

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    info = _build.build()
    f = torch.as_tensor(testdataset("faces_train_128_10")[1],
                        dtype=torch.float32).cuda()
    big = f[:1].repeat(1, 16, 16).contiguous()
    out = dict(device=smi, profiles={}, sass={})
    for label, model, alphas in (
            ("1x2048x2048 K=1", tv_model(), (0.1,)),
            ("1x2048x2048 K=3", sumregs_model(), cs.sumregs_weights()[0])):
        out["profiles"][label] = [
            profile_call(torch, cs, label, big, model, alphas, two)
            for two in (False, True)]
    sass = subprocess.run([str(Path(_cuda_home()) / "bin" / "cuobjdump"),
                           "-sass", str(info.path)], capture_output=True,
                          text=True, timeout=600).stdout
    out["sass"] = sass_mix(sass)
    for name, mix in sorted(out["sass"].items()):
        print(f"{name}: " + ", ".join(f"{k} {v}"
                                      for k, v in sorted(mix.items())))
    bodies = pass_bodies(sass)
    out["pass_bodies"] = bodies
    clock = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out["dynamic"] = {}
    for label, model, form in (("1x2048x2048 K=1", tv_model(), 256 + 0),
                               ("1x2048x2048 K=3", sumregs_model(),
                                (3 << 8) | 0 | (1 << 2) | (2 << 4))):
        inst = [n for n in bodies if n.startswith("_ZN3bpl6pdt_cpIfLi"
                                                   f"{form}E")]
        if not inst or not all(bodies[inst[0]].values()):
            print(f"{label}: no pass bodies found in {inst}", flush=True)
            continue
        kinds = [cs.pdps_kind(op) for op in model.ops]
        plan = cluster_plan.pd_tile_plan(2048, 2048, model.K, 4, 0,
                                         model.K > 1)
        warp, pixels = dynamic_count(plan, 2048, 2048, kinds, 1000,
                                     bodies[inst[0]])
        ms = out["profiles"][label][0]["kernels"]["void bpl::pdt_cp"]["ms"]
        share = warp / (sms * 4 * clock * 1e6 * ms * 1e-3)
        out["dynamic"][label] = dict(
            bodies=bodies[inst[0]], warp_instructions=warp,
            pixel_iterations=pixels, per_pixel_iteration=32 * warp / pixels,
            pdt_cp_ms=ms, max_sm_clock_mhz=clock, issue_share=share)
        print(f"{label}: pass bodies {bodies[inst[0]]}; {warp} warp "
              f"instructions in the passes over {pixels} computed "
              f"pixel-iterations ({32 * warp / pixels:.1f} thread "
              f"instructions each); in {ms:.2f} ms of pdt_cp at "
              f"{clock:.0f} MHz on {sms} SMs: {100 * share:.1f}% of the "
              "issue slots", flush=True)
    dest = ROOT / "output"
    dest.mkdir(exist_ok=True)
    (dest / "tile_trace.json").write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
