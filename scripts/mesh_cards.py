#!/usr/bin/env python3
"""A data-parallel learn over the NVIDIA GPUs of one host against the same
shards on one card.

    python3 scripts/mesh_cards.py [--runs N]

With n visible cards (n ≥ 2), the flagship learn of ``chip_smoke.py``
(``bilevel_learn_fused`` at the bench settings on faces_train_128_10,
float32) runs over a mesh of the n cards, one shard a card (the mesh's
host threads drive the cards at once), and over n shards of ``cuda:0``
(in turn), then unsharded.  The same for one evaluation of the sharded TV
learning function (``method="tr"``, float64, the adjoint of
``chip_smoke.SHARDED_TV_CFG``).  Each form runs once to warm up and then N
times (default 3), timed on the host clock after synchronizing every
card.  Checks, each fatal: the cards' run gives the bits of the one-card
run (x, cost and u; the sharded function's u, cost and gradient); kernels
A and B are launched shards × evaluations times, every kernel A call in
the cluster form; ``scalar_bilevel_tv_learn(method="tr_fused",
data_parallel=True)`` on the default mesh (every card) gives the cards'
bits.  Then the TGV², TV-L1 and VTV single-loop learners with ``mesh=``
(``chip_smoke.slx_mesh_run``: 30 outer steps of 40 CP and 10 CG steps
on the stacks of chip_smoke.py's phases 59–61, float32) over the n cards,
over n shards of ``cuda:0`` and unsharded: the cards' bits equal the one
card's, each shard's session issues 30 × 24 + 1 kernel launches, and the
host ms an outer step of each form are printed; the same for the TV and
sum-of-regularizers single loop (rows 9–10, ``chip_smoke.sl_mesh_run``,
classic and pipelined CG, on the flagship's stack), whose CG sums its
inner products over the cards.  Prints every card's name
and power limit first and, last, one JSON line with the walls.  Exits
non-zero with fewer than two cards.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=3)
    args = ap.parse_args()
    import numpy as np
    import torch
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < 2:
        print(f"needs two CUDA devices or more, has {n}", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from bpldenoising_tpu_torch import _build
    from bpldenoising_tpu_torch import parallel as par
    from bpldenoising_tpu_torch.bilevel import first_order_cuda
    from bpldenoising_tpu_torch.bilevel.fused import bilevel_learn_fused
    from bpldenoising_tpu_torch.data import testdataset
    from bpldenoising_tpu_torch.experiments import api
    from bpldenoising_tpu_torch.solvers.hypergrad import HypergradConfig

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    for line in smi:
        print(line, flush=True)
    _build.library()
    faults = []

    def check(ok, msg):
        print(f"  {'ok' if ok else 'FAULT'}: {msg}", flush=True)
        if not ok:
            faults.append(msg)

    def sync():
        for i in range(n):
            torch.cuda.synchronize(i)

    def walls(fn):
        fn()                                    # warm-up
        out, ms = None, []
        for _ in range(args.runs):
            sync()
            t0 = time.perf_counter()
            out = fn()
            sync()
            ms.append((time.perf_counter() - t0) * 1e3)
        return out, ms

    cards = par.make_batch_mesh()
    one = par.make_batch_mesh(devices=["cuda:0"] * n)
    t, d = testdataset("faces_train_128_10")
    ds = tuple(torch.as_tensor(a, dtype=torch.float32).cuda()
               for a in (t, d))
    kw = cs.flagship_kwargs()
    lkw = dict(xinit=kw["alpha0"],
               params=api.bilevel_params | dict(maxiter=kw["maxiter"],
                                                tol=kw["tol"]),
               inner_maxiter=kw["inner_maxiter"], inner_tol=kw["inner_tol"],
               check_every=kw["check_every"], cfg=kw["hypergrad_cfg"],
               delta_t=1e-6, device="cuda")
    out = dict(device=smi, cards=n, runs=args.runs)
    print(f"flagship bilevel_learn_fused over {n} cards, over {n} shards of "
          "cuda:0, unsharded", flush=True)
    res = {}
    for label, mesh in (("cards", cards), ("one_card", one),
                        ("unsharded", None)):
        cs.reset_launches()
        r, ms = walls(lambda: bilevel_learn_fused(ds, mesh=mesh, **lkw))
        a, b = cs.kernel_a_forms(), cs.kernel_b_forms()
        evals = (args.runs + 1) * (r.iterations + 1)
        shards = 1 if mesh is None else n
        print(f"  {label}: alpha {float(r.x)!r}, cost {float(r.cost)!r}, "
              f"{r.iterations} outer its; walls {[round(m, 1) for m in ms]} "
              f"ms; kernel A {a['calls']} calls ({a['cluster']} cluster), "
              f"kernel B {b['calls']}", flush=True)
        check(a["calls"] == b["calls"] == shards * evals == a["cluster"],
              f"{label}: kernel calls A {a['calls']}, B {b['calls']}, want "
              f"{shards} x {evals}")
        res[label] = r
        out[f"flagship_{label}_ms"] = ms
    same = (torch.equal(res["cards"].x, res["one_card"].x)
            and torch.equal(res["cards"].cost.cpu(),
                            res["one_card"].cost.cpu())
            and torch.equal(res["cards"].u.cpu(), res["one_card"].u.cpu()))
    check(same, "the cards' flagship gives the one-card bits")
    out["flagship_alpha"] = float(res["cards"].x)
    with cs.results_not_saved():
        entry = api.scalar_bilevel_tv_learn(device="cuda",
                                            data_parallel=True, **kw)
    check(np.array_equal(entry.x, res["cards"].x.numpy())
          and np.array_equal(entry.u, res["cards"].u.cpu().numpy()),
          f"scalar_bilevel_tv_learn(data_parallel=True) on the default mesh "
          f"of {n} cards gives the cards' bits")

    print(f"sharded TV learning function (float64, 10 images) over {n} "
          f"cards and over {n} shards of cuda:0", flush=True)
    ds64 = tuple(a.double() for a in ds)
    cfg = HypergradConfig(**cs.SHARDED_TV_CFG)
    evals = {}
    for label, mesh in (("cards", cards), ("one_card", one)):
        lf = par.make_sharded_tv_learning_function(mesh, maxiter=1000,
                                                   cfg=cfg)
        cs.reset_launches()
        evals[label], ms = walls(lambda: lf(0.07, ds64, 0.1))
        a, b = cs.kernel_a_forms(), cs.kernel_b_forms()
        print(f"  {label}: cost {float(evals[label][1])!r}, gradient "
              f"{float(evals[label][2])!r}; walls "
              f"{[round(m, 1) for m in ms]} ms; kernel A {a['calls']}, "
              f"kernel B {b['calls']}", flush=True)
        check(a["calls"] == b["calls"] == n * (args.runs + 1),
              f"{label}: kernel calls A {a['calls']}, B {b['calls']}")
        out[f"sharded_tv_{label}_ms"] = ms
    check(all(torch.equal(p.cpu(), q.cpu())
              for p, q in zip(evals["cards"], evals["one_card"])),
          "the cards' sharded TV evaluation gives the one-card bits")

    print(f"single-loop learners with mesh= over {n} cards, over {n} shards "
          "of cuda:0, unsharded (float32, 30 steps of 40/10; host ms an "
          "outer step)", flush=True)
    outer = 30
    for name in ("tgv", "tvl1", "vtv"):
        utrue, f = cs.slx_mesh_stack(torch, name, torch.float32)
        per = cs.slx_family(name)["cuda"].launches_per_step(10)
        runs = {}
        for label, shards in (("cards", cards), ("one_card", one),
                              ("unsharded", None)):
            cs.slx_mesh_run(name, utrue, f, shards, outer)      # warm-up
            steps = []
            for _ in range(args.runs):
                sync()
                r, ms, sess, kl, plain = cs.slx_mesh_run(name, utrue, f,
                                                         shards, outer)
                steps.append(ms)
            runs[label] = r
            k = 1 if shards is None else n
            print(f"  {name} {label}: alpha "
                  f"{r.alpha.double().cpu().numpy().ravel().tolist()}; host "
                  f"{[round(m, 3) for m in steps]} ms an outer step; "
                  f"sessions {sess}, kernel launches {kl}", flush=True)
            check(sess == k and kl == k * (outer * per + 1) and not plain,
                  f"{name} {label}: sessions {sess}, launches {kl}, plain "
                  f"{plain}")
            out[f"single_loop_{name}_{label}_ms_per_step"] = steps
        check(all(torch.equal(p.cpu(), q.cpu()) for p, q in zip(
            runs["cards"][:5], runs["one_card"][:5])),
            f"{name}: the cards' learn gives the one-card bits")
    print(f"single-loop TV and sum of regularizers (rows 9-10) with mesh= "
          f"over {n} cards, over {n} shards of cuda:0, unsharded (float32, "
          "faces_train 10 x 128^2, 30 steps of 40/10; host ms an outer "
          "step)", flush=True)
    utrue, f = ds
    for name, model, x0 in cs.sl_mesh_models():
        for variant in ("classic", "pipelined"):
            per = first_order_cuda.launches_per_step(10, variant)
            runs = {}
            for label, shards in (("cards", cards), ("one_card", one),
                                  ("unsharded", None)):
                cs.sl_mesh_run(model, x0, utrue, f, shards, outer,
                               variant)                          # warm-up
                steps = []
                for _ in range(args.runs):
                    sync()
                    r, ms, sess, kl, plain = cs.sl_mesh_run(
                        model, x0, utrue, f, shards, outer, variant)
                    steps.append(ms)
                runs[label] = r
                k = 1 if shards is None else n
                print(f"  {name} {variant} {label}: alpha "
                      f"{r.alpha.double().cpu().numpy().ravel().tolist()}; "
                      f"host {[round(m, 3) for m in steps]} ms an outer "
                      f"step; sessions {sess}, kernel launches {kl}",
                      flush=True)
                check(sess == k and kl == k * (outer * per + 1)
                      and not plain,
                      f"{name} {variant} {label}: sessions {sess}, launches"
                      f" {kl}, plain {plain}")
                out[f"single_loop_{name}_{variant}_{label}_ms_per_step"] = (
                    steps)
            check(all(torch.equal(p.cpu(), q.cpu()) for p, q in zip(
                runs["cards"][:6], runs["one_card"][:6])),
                f"{name} {variant}: the cards' learn gives the one-card bits")
    out["faults"] = faults
    print(json.dumps(out), flush=True)
    return 1 if faults else 0


if __name__ == "__main__":
    sys.exit(main())
