#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (one short line each):

1. device: require CUDA; print the card's name and power limit as
   ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
   them.
2. build: compile ``bpldenoising_tpu_torch/csrc/*.cu`` with one ``nvcc``
   call and load the library; print the registers and spills per instance
   of kernel B (``hg_coop``), of the band kernels (kernel A's ``pdc_cp``,
   rows 9–10's ``slc_pd``, the TV-L1 kernel's ``tvl1_cp``, row 11's
   ``slt_pd``, row 12's ``sl1_pd``, row 13's ``slv_pd``), of rows 11's,
   12's and 13's CG launches (``slt_init``, ``slt_apply``, ``sl1_init``,
   ``sl1_apply``, ``slv_init``, ``slv_apply``), of the TGV² CP kernels
   (the cluster form ``tgv_cp``, the two-launch form's ``tgv_primal``,
   ``tgv_dual``), of the VTV CP kernel's cluster form (``vtv_cp``), of
   kernel A's tile form (``pdt_cp``) and of the TGV² CP kernel's tile form
   (``tt_cp``) from the ``-Xptxas -v`` log.
3. kernel A (PDPS inner solve) against its plain PyTorch version on the
   flagship data (10 × 128² float32): a cold 5000-iteration call, a cold
   call with early stop that returns its state, a warm call from that
   state, with the plan (``solvers/cluster_plan.py::pd_plan``: cluster,
   rows a CTA, resident; at this shape the cluster form, one launch per
   early-stop chunk) and the device operations of each call; then once
   more in float64 at a small shape.
4. kernel B (AL hypergradient, exact and regularized forms) against its
   plain version at the flagship shapes, u from phase 3; then in float64.
   Each kernel-B call must be one cooperative launch and one device→host
   read (``hypergrad_cuda.device_ops``, ``host_reads``); the gradients,
   ‖p‖ and the CG counts are printed with every digit.
5. the flagship: ``scalar_bilevel_tv_learn(dataset_name="faces_train",
   num_samples=10, method="tr_fused", device="cuda")`` with the benchmark's
   settings, once to warm up and once timed with CUDA events, launch
   counters reset just before the timed run.  It must land within the
   parity gates below, and every kernel-A call must run the cluster form
   (its calls, cluster-form calls and device operations are printed) and
   every kernel-B call one cooperative launch and one read (its calls,
   kernel launches and host reads are printed).
6. the TGV² kernel (``csrc/tgv.cu``) against its plain PyTorch version on
   the flagship data (10 × 128² float32): a cold 5000-iteration call, a
   cold call with early stop that returns its state, a warm call from that
   state at nudged weights; each with scalar weights and with (M, N) map
   weights; a constant map must reproduce the scalar run bit for bit.
   Then in float64 at 2 × 32².  Every call must take the cluster form
   (one ``tgv_cp`` launch per early-stop chunk: ``tgv_cuda.cluster_calls``)
   and issue at most 4 device operations a chunk and one copy a call
   (``tgv_cuda.device_ops``), printed beside what the two-launch form
   would issue (2 an iteration, 4 a chunk).
7. large images: the TGV² kernel at 1 × 1024² (1000 iterations, the shape
   the TPU sends to its row-tiled TGV kernel; its bands do not fit in
   shared memory, so the plan runs the tile form, ``csrc/tgv_tile.cu``,
   which the phase requires, and times the two-launch form it replaced,
   forced, beside it: the same bits) and kernel A at 1 × 2048² (1000
   iterations, the shape the TPU
   sends to its row-tiled TV kernel; kernel A's tile form, whose plan and
   device operations are printed), each against its plain version, timed.
8. the TGV learn: ``scalar_bilevel_tgv_learn(dataset_name="faces_train",
   num_samples=10, method="tr_fused", device="cuda")`` with the benchmark's
   TGV settings, once to warm up and once timed, all launch counters reset
   just before the timed run and read just after; every TGV² kernel call
   in the cluster form, its device operations as in phase 6.  Gates below.
9. the patch TGV learn: ``patch_bilevel_tgv_learn`` on the same data with
   a (2, 2, 2) stack and the entry point's own β₂ = 1.5, counters reset
   just before and read just after, the TGV² kernel's calls as in phase 8.
   Gates below.
10. the TV-L1 kernel (``csrc/tvl1.cu``) in both forms against their plain
    PyTorch versions on ``circle_sp_128_20`` (1 × 128² float32): the Huber
    form at α 1.9, γ_d = 100, γ_r = 1000, a cold 2000-iteration call, a
    cold call with early stop that returns its state and a warm call from
    that state at a nudged weight, each with a scalar α and with the (M, N)
    map of a 2×2 grid (a constant map must reproduce the scalar run bit for
    bit); the plain form at α 0.9 for 10,000 iterations (``TVL1Denoise``'s
    default) and at 64 × 128² for 2000 iterations; both forms in float64
    at 2 × 32².  Every call must take the cluster form (one launch per
    early-stop chunk: ``tvl1_cuda.cluster_calls``) and issue at most 4
    device operations a chunk and one copy a call
    (``tvl1_cuda.device_ops``); the calls' iterations and device
    operations are printed beside what the two-launch form would issue
    (2 an iteration, 4 a chunk).
11. the TV-L1 learn: ``scalar_bilevel_tvl1_learn(dataset_name="circle_sp",
    method="tr_fused", device="cuda")`` with bench.py's TV-L1 settings,
    once to warm up and once timed, counters reset just before and read
    just after; then ``TVL1Denoise`` at α 0.9 with its default budget,
    counters reset just before and read just after.  Every TV-L1 kernel
    call in the cluster form, its device operations as in phase 10.
    Gates below.
12. the patch TV-L1 learn: ``patch_bilevel_tvl1_learn`` on the same data
    from x₀ = 0.4·ones((2, 2)), counters reset just before and read just
    after, the TV-L1 kernel's calls as in phase 11.  Gates below.
13. the VTV kernel (``csrc/vtv.cu``) against its plain PyTorch version on
    ``color_disks_128_10`` (6 × 3 × 128² float32): a cold 5000-iteration
    call, a cold call with early stop (tol 1e-5, every 100 iterations) that
    returns its state and a warm call from that state at a nudged weight,
    each with the scalar α 0.165 and with an (M, N) map (a 2×2 grid, then
    nudged); a constant map must reproduce the scalar run bit for bit.
    Then the VTV kernel at 1 × 3 × 256² (1000 iterations; its bands do not
    fit in shared memory, so the plan runs the two-launch form, which the
    phase requires) against its plain version, timed.
14. the VTV kernel in float64 at 2 × 3 × 32²: cold with early stop (scalar
    α), cold fixed budget (map α), warm from the first state.  Every call
    of phases 13–14 but the 256² one must take the cluster form (one
    ``vtv_cp`` launch per early-stop chunk: ``vtv_cuda.cluster_calls``)
    and issue the table copy, at most 3 device operations a chunk and one
    copy a call (``vtv_cuda.device_ops``), printed beside what the
    two-launch form would issue (2 an iteration, 3 a chunk).
15. the VTV learn: ``scalar_bilevel_vtv_learn(dataset_name="color_disks",
    num_samples=6, method="tr_fused", device="cuda")`` with bench.py's VTV
    settings, once to warm up and once timed, counters reset just before
    and read just after; every VTV kernel call in the cluster form, its
    device operations as in phase 14.  Gates below.
16. the patch VTV learn: ``patch_bilevel_vtv_learn`` on the same data
    (2×2 grid, the entry point's β₂ = 1.5), then ``VTVDenoise`` at
    α 0.165434 with its default 10,000 iterations, each with the counters
    reset just before and read just after, the VTV kernel's calls as in
    phase 15.  Gates below.

17. the single-loop stencils (``csrc/common.cuh``: forward, backward and
    centred gradients, their adjoints and Gram diagonals) against
    ``ops/grad.py`` in float64, before any learner runs.
18. the single-loop learner (``csrc/single_loop.cu``) against its plain
    PyTorch version on the flagship data (10 × 128² float32): scalar TV,
    300 outer steps of 40 PD and 10 CG steps, classic CG, both timed; 30
    outer steps with the classic and the pipelined CG; then in float64 at
    3 × 16² for the four parameterizations, both CG forms and two images
    per tile.
19. the single-loop learn: ``scalar_bilevel_tv_learn(dataset_name=
    "faces_train", num_samples=10, dtype="float32", method="single_loop",
    device="cuda")``, once to warm up and once timed, counters reset just
    before and read just after; the plain loop must not run.  Gates below.
20. the same for ``scalar_bilevel_sumregs_learn`` (α₀ = 1e-3 each).
21. batch 64 with K = 3 (the faces stack tiled and cut to 64): one tile
    and ``tile_b=8`` against the plain version at 30 outer steps, then
    ``single_loop_cuda_tiled`` timed at 300 outer steps with one tile and
    with ``tile_b=8`` (counters reset just before and read just after).

22–33. the single-loop TGV², TV-L1 and VTV learners
    (``csrc/single_loop_{tgv,tvl1,vtv}.cu``), four phases each:
    (a) against the plain version in float64 (one and two 24² images,
    the scalar or (2,) weight and a 2×2 patch grid, 20 outer steps; for
    TGV² also where its CP bands split unevenly, 3×20×16, 2×22×24 and
    3×120×128, and at 1×256², whose float64 bands run in global memory;
    for TV-L1 likewise at 3×20×16, 2×22×24, 3×120×128 and 1×512² in
    global memory, there bit for bit against the plain version with its
    sums in the kernel's order (``kernel_order``); for VTV at 3×3×20×16,
    2×3×22×24, 3×3×120×128, two channels at 2×2×16×20 and 1×3×256² in
    global memory);
    (b) against the plain version in float32 at the bench shape (one
    image), 30 outer steps, both timed, and again on the entry point's
    own stack where it holds more (TGV² 10 images, VTV 6); (c) the library call
    ``single_loop_{tgv,tvl1,vtv}_cuda`` at bench.py's settings (300 outer
    steps of 40 CP and 10 CG steps), CUDA events after one warm-up,
    counters reset just before and read just after; (d) the scalar learn
    through its entry point with ``method="single_loop"`` on the dataset
    and sample count of the family's trust-region phase, once to warm up
    and once timed, counters reset just before and read just after, the
    plain loop watched; gated against the JAX float32 reference.  After
    (d), TGV² runs (e): the same entry point in float64, gated tightly
    against the JAX float64 reference, the witness for (d)'s wide gate.
    The TGV², TV-L1 and VTV kernels (rows 11, 12 and 13) must issue
    4 + 2·n_adj kernel launches per outer step in each (24 at bench.py's
    10 CG steps; one more per segment), and each phase prints its CP plan
    (``solvers/cluster_plan.py::tgv_plan``, ``solvers/tvl1_cuda.py::
    tvl1_plan``, ``cluster_plan.vtv_plan``) and its CG block form
    (``cg_slots``).

34. kernel A's K = 3 and map forms (``csrc/pdps.cu``) against its plain
    version on the flagship data (10 × 128² float32): the sum of
    regularizers (forward, backward, centred; weights (0.035, 0.032,
    0.005)) and TV with a random (128, 128) α map, each a cold
    5000-iteration call, a cold call with early stop and a warm call,
    each form's plan and device operations printed as in phase 3; then
    K = 3 at 1 × 2048², 1000 iterations (row 3's shape, the tile form).
35. kernel B's K = 3 form (scalar gradients) and map form (per-pixel
    gradient maps) against its plain version, exact and regularized, u
    from phase 34; then kernels A and B in these forms in float64 at
    2 × 32²; every kernel-B call one launch and one read, as in phase 4.
36–39. the learns with ``method="tr_fused"`` through their entry points
    at bench.py's settings on the 10 faces images, float32:
    ``patch_bilevel_tv_learn`` (2×2 from 1e-4),
    ``scalar_bilevel_sumregs_learn`` (from 1e-3 each, Δt 1e-3),
    ``patch_bilevel_sumregs_learn`` (2×2×3, its entry defaults) and the
    16×16 grid through ``patch_bilevel_tv_learn`` (L-BFGS), each once to
    warm up (but the grid) and once timed, counters reset just before
    and read just after, the plain versions watched (no call), every
    kernel-A call in the cluster form, every kernel-B call one cooperative
    launch and one read; gated against
    ``scripts/jax_reference_tv_family.py`` (below).
40. the float64 witnesses: ``scalar_bilevel_sumregs_learn`` and
    ``patch_bilevel_tv_learn`` in float64 on the card against the JAX
    package's float64 runs, at 1e-6, every kernel-A call in the cluster
    form.

41. the flagship default call with the host trust region
    (``method="tr"``, the default): ``scalar_bilevel_tv_learn(
    dataset_name="faces_train", num_samples=10)`` (float64, 5000 cold
    inner iterations an evaluation, ``HypergradConfig()``) against the JAX
    package's float64 run (``scripts/jax_reference_tr.py``): α within 1e-6
    relative, the mean PSNR within 0.01 dB, the cost within 0.1%; kernel A
    (cluster form) and kernel B (one launch and one read) once per
    evaluation, one host read of (cost, gradient) per evaluation, no
    plain-version call.
42. the same learn with ``method="tr"`` at the bench settings of phase 5
    in float32, against the flagship's band (α within 2e-5 of 0.069788).
43–44. ``method="tr"`` against ``method="tr_fused"`` at
    ``inner_tol=None`` in float64 on full-size images, the outer
    iterations cut to 3 (the rest the entry points' defaults), gated: the
    logged cost, ‖g‖ and Δ agree to 1e-10 relative and the accept pattern
    is the same.  Phase 43: the sum of regularizers' (3,) weights, the 2×2
    patch TV, the ``image_pair`` patch sum (the tr_fused side through
    ``bilevel_learn_fused``) and the 16×16 grid (L-BFGS) on the faces
    images, with phase 40's well-conditioned adjoint
    (``HypergradConfig(al_iters=2, cg_maxiter=1000, act_tol=1e-4)``);
    then with the default ``HypergradConfig()``, printed and not gated,
    beside how far the default gradient moves under a one-ulp move of the
    parameter (its adjoint CG stops at its cap, and NumPy and torch round
    a multi-parameter trust region apart in the last bit).  Phase 44:
    TGV² on the ten faces images, TV-L1 on ``circle_sp``, VTV on six
    ``color_disks`` images, every call of rows 4, 8 and 6 in its cluster
    form.  Each phase prints its seconds.

Phases 1-44 run every entry point with ``save_results=False``, as before
results were ported (they write nothing; their digits and walls are the
parent's).

45. the flagship learn of phase 5 with ``save_results=True`` in a
    temporary directory: the files (the log, the quality table, the ten
    true/data/reco PNG triplets under the JAX prefix), one log row per
    outer iteration, the table's per-image SSIM/PSNR equal to
    ``ssim_np``/``psnr_np`` of the stretched arrays, the PNGs decoding to
    ``uint8(clip(x)·255 + 0.5)``; the learn's wall and the host time of
    its ``save_results`` printed apart.
46. the five validations (``validate_tv_parameter``, ``_sumregs_``,
    ``_tgv_``, ``_tvl1_``, ``_vtv_``) in float64 at the learned weights of
    ``PERF.md`` §2, against the JAX package's float64 runs
    (``scripts/jax_reference_reporting.py``): the cost within 1e-8
    relative, the mean PSNR within 1e-6 dB; one call of the family's CP
    kernel (A, rows 4, 7, 6) each, in the cluster form, no plain call.
47. the five cost sweeps in float64 (TV 8 α, 2-D TV 4×4, TGV² 3×3, TV-L1
    5, VTV 5), one cold call per point, each point within 1e-8 of the JAX
    sweep; every call in the cluster form, no plain call; the walls.
48. ``python -m bpldenoising_tpu_torch validate-tv`` and ``cost-sweep`` in
    a subprocess: exit 0, the printed cost and PSNR those of phase 46, the
    saved costs those the API gives in this process.

Phases 49-52 run with ``save_results=False`` too:

49. segmented dispatch: the flagship of phase 5 with ``log_every=5``
    against phase 5's single run (x and every logged number bit for bit,
    the same kernel-A calls in the cluster form, device operations and
    kernel-B launches and reads), then TGV² (10 × 128²), TV-L1 (1 × 128²)
    and VTV (6 × 3 × 128²) at their learns' settings cut to 3 outer
    iterations, ``log_every=2`` against a single run, the CP kernel's
    calls (iterations, device operations, cluster form) the same on both
    sides; the segment-end times positive and non-decreasing.
50. checkpoint and resume: the flagship ``tr_fused`` learn stopped at 4
    outer iterations with ``checkpoint=True``, then ``resume=True`` with
    the whole budget, its α within 5e-2 relative of phase 5's (the JAX
    test's band: the resumed solves start cold); the float64 default call
    (``method="tr"``, phase 41's) stopped at 3 and resumed, against phase
    41's α; the log numbered 1, 2, … without a gap; every kernel call in
    its cluster or cooperative form, no plain call.
51. ``python -m bpldenoising_tpu_torch scalar-tv ... --trace DIR`` in this
    process around a flagship learn: the Chrome trace names kernel A's
    ``pdc_cp`` once per early-stop chunk of its calls and kernel B's
    ``hg_coop`` once per call, as the wrappers counted them.
52. the differentiable layers (``diff_tv_denoise``'s TV and the sum of
    regularizers on the 10 faces images, TGV² on them, TV-L1 on one
    ``circle_sp`` image, VTV on six ``color_disks`` images), float32 and
    float64: the forward bit for bit against the public denoiser, one
    kernel call in its cluster form and no plain call; the gradients of
    ½‖u − ū‖² (f and every weight) against the same backward on the plain
    forward, 300 iterations (float32 1e-1, float64 1e-6 of the largest
    entry; the TV family's backward at γ = 1e4, well conditioned); in
    float64 on the first image the f-gradient against central differences
    (h = 1e-5, one random direction, 2e-3 relative; the sum of
    regularizers 1e-2, the JAX package's tolerance for it) with the
    forward run to convergence (``DIFF_LAYERS`` gives each layer's
    settings and their reasons); each layer's forward and backward walls
    and adjoint-CG iterations.

Phases 53-62 run the parallel tier (each phase's function says what it
holds): the fused learns and ``method="tr"`` on meshes of the card, the
halo solvers, the PNG codec and ``make-dataset``, and every single loop
with ``mesh=`` (59-61 TGV², TV-L1, VTV; 62 TV and the sum of
regularizers, ``phase_sl_mesh``, whose CG sums its inner products over
the shards).

63. kernel A's tile form (``csrc/pd_tile.cuh``), where the bands do not
    fit a cluster: 1 × 1024² K = 1 (5000 iterations), 4 × 512² K = 1 with
    a map, 1 × 256² K = 3, 1 × 2048² K = 3 with maps and 1 × 1024² K = 3
    in float64, each cold, early-stopped (every 50 iterations) and warm,
    against the two-launch form (a patched plan) bit for bit (u, duals,
    iteration counts) and against the plain version at kernel A's
    tolerances, timed beside the two-launch form and the bound; then
    ``bilevel_learn_fused`` at the flagship's settings on four 512²
    phantoms of ``data/generate.py`` with noise 0.05 from a fixed seed:
    every kernel-A call in the tile form, no plain call, α, PSNR and cost
    the two-launch form's bit for bit, the wall and kernel A's share of
    it, each outer step's cost, gradient and radius; its first evaluation
    (cost and hypergradient at α₀) against both kernels' plain versions,
    beside the cost's central difference.
64. the TGV² CP kernel's tile form (``csrc/tgv_tile.cu``), where the bands
    do not fit a cluster: 1 × 1024² (1000 iterations), 10 × 256² with
    bench.py's TGV² early stop (3e-6 every 100) cold and then warm from
    its state at nudged weights, 4 × 512² with (M, N) maps of both weights
    (1000 iterations) and 1 × 512² in float64 with the early stop, against
    the two-launch form (a patched plan) bit for bit (u, w, p, q,
    iteration counts) and against the plain version at phase 6's
    tolerances, each call one tile-form call of the device operations its
    plan gives, timed beside the two-launch form, the plain version and
    the bound; then ``bilevel_learn_tgv_fused`` at bench.py's TGV²
    settings, its outer iterations cut to 5, on two 256² pyramids of
    ``data/generate.py`` with noise 0.1 from a fixed seed: every TGV²
    solve in the tile form, (α₁, α₀), PSNR and cost the two-launch form's
    bit for bit, both walls.

It prints one JSON line of per-kernel numbers (twenty entries: the
eleven kernels, rows 1–3's K = 3 and map forms, row 5's 1024² call (its
tile form, the two-launch form's time beside it), row 6's 256² call, row
3's tile form at 1 × 1024², row 5's tile form at 10 × 256²),
then, as its last line,
``{"ok": true, "device": {...}}``.  Any failure raises (no phase is
caught) and the script exits non-zero; a deadline turns a hang into a
traceback and a non-zero exit.
"""

from __future__ import annotations

import contextlib
import faulthandler
import json
import math
import os
import subprocess
import sys
import time

DEADLINE_S = 900

# flagship reference result (TPU v5e, float32): learned α, mean PSNR, cost
FLAGSHIP_ALPHA = 0.069788
ALPHA_GATE = 1e-4          # fail beyond this
ALPHA_BAND = 2e-5          # the float32 parity band, reported separately
FLAGSHIP_PSNR = 27.386
PSNR_GATE = 0.005          # dB
FLAGSHIP_COST = 152.3354
COST_GATE_REL = 1e-3

# Kernel-vs-plain tolerances.
# float32, kernel A: the kernel projects with rsqrt (the TPU kernel's form,
# ~2 ulp) where the plain version divides by a sqrt, so the two iterations
# differ by rounding each step.  The primal iterate contracts (strongly
# convex), so u agrees to a few 1e-6 on values of order 1.  The dual
# iteration is only non-expansive and its solution is not unique on flat
# regions, so rounding differences in y persist: y (|y| ≤ α = 0.1) is held
# to 1% of α.  A fault in either step moves u by 1e-2 or more.
TOL_A_U_F32 = 1e-4
TOL_A_Y_F32 = 1e-3
# float32, kernel B: 100-iteration CG that is stopped by its cap; the
# batch-wide dot products are summed in another order than torch.sum, and
# CG amplifies rounding across iterations, so p and the gradient agree to
# a relative 1e-3 of their scale, not to rounding.
TOL_B_F32_REL = 1e-3
# float64: the same arithmetic at double precision, small shape
TOL_F64_REL = 1e-9

# TGV learn reference (the JAX package on the CPU, float32, jnp, the same
# settings): α = (α₁, α₀), mean PSNR, cost.  The faces TGV cost is a flat
# valley: another sound trust-region point 9% away in α₁ has a cost only
# 2e-4 (relative) lower, so α is gated at 10% relative and the cost and
# PSNR carry the parity; the 1e-3 band (float32 and float64 JAX runs agree
# to 3e-5) is reported separately.
TGV_ALPHA = (0.085226, 0.044170)
TGV_ALPHA_GATE_REL = 0.10
TGV_ALPHA_BAND_REL = 1e-3
TGV_PSNR = 28.1009
TGV_PSNR_GATE = 0.01       # dB
TGV_COST = 130.1344
TGV_COST_GATE_REL = 1e-3
# patch TGV learn reference ((2, 2, 2) stack, β₂ = 1.5), same source
TGV_PATCH_PSNR = 28.1077
TGV_PATCH_COST = 129.8615
TGV_PATCH_A1 = ((0.09146, 0.09851), (0.07646, 0.08766))
TGV_PATCH_A0 = ((0.04659, 0.04462), (0.04396, 0.04232))

# TV-L1 references (scripts/jax_reference_tvl1.py: the JAX package on the
# CPU, float32, jnp, the same settings).  The scalar learn: α, cost, mean
# PSNR; it stops at maxiter 15, as does the patch learn, whose grid is
# therefore reported against the reference and not gated.
TVL1_ALPHA = 1.9234402
TVL1_ALPHA_GATE_REL = 1e-3
TVL1_ALPHA_BAND_REL = 1e-4  # reported separately
TVL1_COST = 9.999229
TVL1_COST_GATE_REL = 1e-3
TVL1_PSNR = 29.13424
TVL1_PSNR_GATE = 0.01       # dB
TVL1_X0 = 0.4
TVL1_X0_PATCH = ((0.4, 0.4), (0.4, 0.4))
TVL1_PATCH_GRID = ((1.3173035, 1.0057976), (1.1466179, 0.7365557))
TVL1_PATCH_COST = 12.546009
TVL1_PATCH_COST_GATE_REL = 1e-2
TVL1_PATCH_PSNR = 28.14884
TVL1_PATCH_PSNR_GATE = 0.05  # dB
# TVL1Denoise at bench.py's weight 0.9 and its default 10,000 iterations
TVL1_DENOISE_ALPHA = 0.9
TVL1_DENOISE_PSNR = 27.532341
TVL1_DENOISE_PSNR_GATE = 0.05  # dB

# VTV references (scripts/jax_reference_vtv.py: the JAX package on the CPU,
# float32, jnp, bench.py's VTV settings on color_disks_128_10).  Both
# learns stop at maxiter 20, so the patch grid is reported against the
# reference and not gated.
VTV_ALPHA = 0.16529731
VTV_ALPHA_GATE_REL = 1e-3
VTV_ALPHA_BAND_REL = 1e-4   # reported separately
VTV_COST = 34.076878
VTV_COST_GATE_REL = 1e-3
VTV_PSNR = 36.603813
VTV_PSNR_GATE = 0.01        # dB
VTV_CG_ITERS = 7432         # adjoint-CG iterations over the logged evaluations
VTV_PATCH_GRID = ((0.16049956, 0.16783488), (0.17485711, 0.16132285))
VTV_PATCH_COST = 34.004280
VTV_PATCH_COST_GATE_REL = 5e-3
VTV_PATCH_PSNR = 36.613407
VTV_PATCH_PSNR_GATE = 0.02  # dB
VTV_PATCH_CG_ITERS = 10964
# VTVDenoise at the host trust region's weight (FIDELITY.md:12), 10,000 its
VTV_DENOISE_ALPHA = 0.165434
VTV_DENOISE_PSNR = 36.602905
VTV_DENOISE_PSNR_GATE = 0.05  # dB

# float32, VTV kernel: the kernel runs the plain version's operations in
# its order and rounding (-fmad=false, the same projection form, n² summed
# in the order of PyTorch's reduction on the card: four accumulators,
# element k into k mod 4), but the early-stop norms are summed in another
# order, so a stop may land one check apart, and the dual of a flat region
# is not unique, so a rounding difference there need not decay.  The
# primal contracts (strongly convex data term): u (values in [0, 1]) is
# held to 1e-4 absolute, the dual y (|y| ≤ α ≈ 0.17) to 1e-3 absolute; a
# fault in a stencil or the coupled projection moves them by 1e-2 or more.
# Measured on an H100: 0.0, bit for bit, with equal iteration counts.
TOL_VTV_U_F32 = 1e-4
TOL_VTV_Y_F32 = 1e-3

# float32, TV-L1 kernel (both forms): the kernel runs the plain version's
# operations in its order and rounding (-fmad=false, the same projection
# and prox constants), but neither problem has a strongly convex primal:
# the L1 data term is not, and the Huber data term is so only on
# |u − f| ≤ 1/γ_d.  So a rounding difference in u (the early-stop sums are
# taken in another order, and a stop may land one check apart) need not
# contract as in kernel A; the iteration is non-expansive, so it does not
# grow either.  u (values in [0, 1]) is held to 1e-4 absolute and the dual y
# (|y| ≤ α ≈ 1–2) to 1e-3 absolute; a fault in a stencil, the prox or the
# projection moves them by 1e-2 or more.  Measured on an H100: 0.0, the
# kernel and the plain version agree bit for bit.
TOL_TVL1_U_F32 = 1e-4
TOL_TVL1_Y_F32 = 1e-3

# float32, TGV kernel: the kernel divides by √2 where the plain version's
# CUDA division by a host scalar multiplies by its reciprocal, and sums the
# early-stop norms in another order, so the iterations differ by rounding
# each step.  u contracts (strongly convex data term) and is held like
# kernel A's u; w, p and q follow a non-expansive iteration whose solution
# is not unique on flat regions, so rounding differences persist: held to
# 1e-3 absolute (p, q are bounded by α₁ ≈ 0.09, α₀ ≈ 0.04).  A fault in a
# stencil or a projection moves them by 1e-2 or more.
TOL_TGV_U_F32 = 1e-4
TOL_TGV_DUAL_F32 = 1e-3

# Single-loop references (scripts/jax_reference_single_loop.py: the JAX
# package's jnp scan on the CPU, float32, through its entry points with
# method="single_loop" and their defaults, 300 outer steps of 40 PD and 10
# CG steps, Adam at lr 0.05, on faces_train_128_10): α, cost, mean PSNR.
SL_TV_ALPHA = 0.0697830393910408
SL_TV_COST = 152.33694458007812
SL_TV_PSNR = 27.38584327697754
SL_SUMREGS_ALPHA = (0.03239758685231209, 0.03223814442753792,
                    0.006236528977751732)
SL_SUMREGS_COST = 151.33538818359375
SL_SUMREGS_PSNR = 27.415176391601562
SL_ALPHA_GATE_REL = 1e-3
SL_ALPHA_BAND_REL = 1e-4    # reported separately
SL_COST_GATE_REL = 1e-3
SL_PSNR_GATE = 0.01         # dB

# float64, the single-loop stencils (csrc/common.cuh: diff1, adj1, gram1)
# against ops/grad.py: the same differences, halvings and quarterings in
# the same order, so they agree to the last bit (measured 0.0); 1e-15 on
# unit-scale inputs leaves room for nothing but a reordered sum.
TOL_SL_STENCIL_F64 = 1e-15
# float32, the single-loop learner against its plain version (300 outer
# steps at 10×128²; 30 at 64×128², K = 3): the kernel takes its inner
# products and gradient sums in another order than PyTorch's multi-block
# reductions, so p and the hypergradient differ by rounding.  The PD steps
# have no sums (u follows α exactly), and Adam's step m̂/(√v̂ + ε) is nearly
# scale-free, which damps a relative rounding difference in g.  Gates: α
# and the α and cost trajectories 1e-5 relative, u 1e-4 absolute (values
# of order 1), ‖g‖ 1e-3 relative to its largest value (it falls by orders
# of magnitude and is a difference of large sums).  A fault in a stencil,
# the projection, the CG or Adam moves them by 1e-2 or more.  Measured on
# an H100 (phases 18 and 21): 300 classic steps α, u and the α trajectory
# 0.0, cost 1.8e-7, ‖g‖ 3.8e-7; 30 pipelined steps α 2.0e-7, u 5.4e-7, α
# trajectory 5.5e-6, ‖g‖ 1.1e-4; batch 64, one tile, α 1.4e-6; tile_b 8
# α and u 0.0.
TOL_SL_REL_F32 = 1e-5
TOL_SL_U_F32 = 1e-4
TOL_SL_GNORM_F32 = 1e-3

# The single-loop TGV², TV-L1 and VTV learners (csrc/single_loop_{tgv,tvl1,
# vtv}.cu).  References (scripts/jax_reference_single_loop.py, the JAX
# package's jnp scan on the CPU, float32): the entry points with
# method="single_loop" and their defaults (300 outer steps of 40 CP and
# 10 CG steps; TGV on the 10 faces images from (0.05, 0.05) at lr 0.02,
# TV-L1 on one circle_sp image from 0.4, VTV on the six color_disks images
# from 0.05) and the library calls at bench.py's settings on one image
# (bench.py:665-683, :878-893, :1011-1020): α, cost, mean PSNR.
SLX_REF = {
    "tgv": dict(alpha=(0.08425260335206985, 0.030044613406062126),
                cost=148.15432739257812, psnr=27.47287368774414),
    "tvl1": dict(alpha=(1.9599701166152954,), cost=9.997591018676758,
                 psnr=29.134944915771484),
    "vtv": dict(alpha=(0.16543056070804596,), cost=34.09968566894531,
                psnr=36.600860595703125),
}
SLX_CALL_REF = {
    "tgv": dict(alpha=(0.0822146013379097, 0.030765213072299957),
                cost=17.452348709106445),
    "tvl1": dict(alpha=(1.9599701166152954,), cost=9.997591018676758),
    "vtv": dict(alpha=(0.15798762440681458,), cost=6.589247703552246),
}
# Gates of the entry points against the references: α within 1e-3
# relative, PSNR ±0.01 dB, cost ±0.1% (the TV row's).  TGV² is gated at
# twice the reference's own float32 band instead: the JAX package's
# float32 and float64 runs of the same learn differ by 1.0e-2 in α₀
# (relative), 5.6e-3 in the cost and 0.025 dB in PSNR
# (scripts/jax_reference_single_loop.py tgv and --float64 tgv): at γ = 1e-4
# its joint system is ill-conditioned and a float32 run with sums in
# another order is another point of that band.  (TV-L1: 1.2e-5 in α; VTV:
# 8e-7.)  The library calls (c) are reported against their references,
# not gated; (a) and (b) hold the kernel to its plain version.
# TGV²'s wide float32 gate rests on a float64 witness: the same entry
# point in float64 on the card against the JAX package's float64 run
# (scripts/jax_reference_single_loop.py --float64 tgv), gated at 1e-6
# relative on α and the cost and 1e-5 dB on PSNR.  The learner turns
# float32 rounding (6e-8) into 1e-2 in α₀, a gain of ~2e5, so float64
# rounding (1.1e-16) should move it by ~1e-11; a fault in the batch path
# (the per-image CG scalars, the batch-ordered gradient sums) moves it by
# 1e-3 or more.
SLX_REF_F64 = {
    "tgv": dict(alpha=(0.08427089069494462, 0.029748970332763858),
                cost=148.98541562203252, psnr=27.4474969870284),
}
SLX_GATES_F64 = dict(alpha=1e-6, psnr=1e-5, cost=1e-6)
SLX_GATES = {"tgv": dict(alpha=2e-2, psnr=0.05, cost=1.1e-2),
             "tvl1": dict(alpha=1e-3, psnr=0.01, cost=1e-3),
             "vtv": dict(alpha=1e-3, psnr=0.01, cost=1e-3)}
# float32, kernel against plain at the bench shape (30 outer steps): as
# the TV learner's (TOL_SL_*), but TGV² holds α and the α and cost
# trajectories to 1e-4 relative: its adjoint system at γ = 1e-4 is
# ill-conditioned (the JAX package moves its own TGV gradient by ~2e-8
# relative under a 1e-13 perturbation of the data in float64), so the
# kernel's sums, taken in another order, move α by more than rounding
# (measured on an H100: 2.2e-6 for α, 7.1e-6 for its trajectory).
TOL_SLX_REL_F32 = {"tgv": 1e-4, "tvl1": TOL_SL_REL_F32,
                   "vtv": TOL_SL_REL_F32}
# float64, kernel against plain (phases (a)): 1e-9 relative (TOL_F64_REL),
# but TV-L1's two-image patch case 1e-5: the TV-L1 learner switches
# discretely at |u − f| = 1/γ_d (the data Hessian D) and |∇u| = 1/γ_r (the
# active set), so a rounding difference in the CG's inner products can move
# a pixel across and the trajectory by far more than rounding.  On that
# case the plain version itself, with its CG inner products summed in
# another order, moves by 1.8e-6 (3e-10 on the other three); measured on an
# H100 the kernel: 2.5e-6 on it and 1.2e-10 on the others.  A fault in a
# stencil, D, the clip or Adam moves the learner by 1e-2 or more.
TOL_SLX_F64_CASE = {("tvl1", "B2 patch"): 1e-5}

# The patch TV and sum-of-regularizers trust regions (phases 36-40).
# References: scripts/jax_reference_tv_family.py, the JAX package's
# bilevel_learn_fused(backend="jnp") on the CPU in float32 at bench.py's
# settings on faces_train_128_10 (inner 5000, inner_tol 1e-6, check_every
# 100, HypergradConfig(al_iters=2, cg_maxiter=100), 20 outer iterations;
# the 16×16 grid: inner 2000, the default HypergradConfig, 16 outer
# iterations): the learned weights, the cost, the mean PSNR, the outer
# iterations.  Nominal gates: each weight within 1e-3 × the largest weight
# (absolute: the sum of regularizers drives its centred weight to the
# box's floor, 1.2e-7, where a relative gate means nothing), PSNR ±
# 0.01 dB, cost ± 0.1%.  But these learns branch on float32 rounding: the
# trust region's steps follow a gradient from an adjoint CG stopped at its
# cap (100 iterations), and the reference itself, run on noisy images
# moved by one rounding (--perturb=1, 2, 3: × (1 + ε·ξ)), lands up to
# TVF_BAND away ("band": the largest distance of three such runs from the
# reference; the sum of regularizers' α by 15% of its largest weight,
# its cost by 0.86%).  So each learn is gated at the larger of the
# nominal gate and twice its band, and the nominal gate is reported
# beside it ("in"/"out").  The float64 witnesses (phase 40) hold the same
# code to 1e-6 where rounding does not branch.
TVF_REF = {
    "patch_tv": dict(
        x=((0.07137605547904968, 0.06979940086603165),
           (0.06946340203285217, 0.06794488430023193)),
        cost=152.27993774414062, psnr=27.38690185546875, iterations=20),
    "sumregs": dict(
        x=(0.03432219848036766, 0.0410776361823082, 1.1920928955078125e-07),
        cost=151.658203125, psnr=27.415273666381836, iterations=13),
    "patch_sumregs": dict(
        x=(((0.10467645525932312, 0.10325437039136887, 0.02128157764673233),
            (0.10939531773328781, 0.11008890718221664,
             0.028342705219984055)),
           ((0.07794177532196045, 0.0781114399433136,
             1.1920928955078125e-07),
            (0.08366977423429489, 0.0843314453959465,
             0.002453843131661415))),
        cost=296.0284423828125, psnr=24.52670669555664, iterations=10),
    "grid16": dict(x=(
    (0.081760481, 0.071846604, 0.071787573, 0.073542207, 0.078414582, 0.073566839, 0.079595551, 0.073252901, 0.076778315, 0.077697329, 0.072745465, 0.097090654, 0.097095937, 0.08175528, 0.093458772, 0.11063103),
    (0.075655341, 0.078668572, 0.067495972, 0.070484005, 0.063546784, 0.070603915, 0.07117708, 0.075209312, 0.074708164, 0.067171291, 0.064921506, 0.066216454, 0.06871599, 0.069412924, 0.073574007, 0.080821887),
    (0.075345308, 0.064296834, 0.077420868, 0.073062718, 0.07698597, 0.069576621, 0.074802876, 0.069764055, 0.063399717, 0.069498755, 0.06396877, 0.067118943, 0.062898636, 0.06783881, 0.078801654, 0.071234621),
    (0.077253386, 0.071712613, 0.0657655, 0.082375951, 0.069459163, 0.076605074, 0.07152731, 0.077745736, 0.082420871, 0.067713641, 0.072037287, 0.06862814, 0.062667042, 0.066225119, 0.083926484, 0.097286329),
    (0.088308156, 0.075980611, 0.069531456, 0.081411734, 0.069495, 0.074984461, 0.060570154, 0.069327228, 0.081855312, 0.097469404, 0.076811053, 0.073330589, 0.07048548, 0.070703365, 0.065133095, 0.071242332),
    (0.081137493, 0.072955459, 0.078415334, 0.06599389, 0.093385525, 0.079148971, 0.066518143, 0.076918706, 0.066884525, 0.079695508, 0.084003963, 0.070752539, 0.076588333, 0.062104166, 0.066939756, 0.070538439),
    (0.08891663, 0.070427127, 0.071125202, 0.077124923, 0.058726132, 0.057233255, 0.075674623, 0.082012214, 0.073639013, 0.061283607, 0.058658004, 0.062730476, 0.080764748, 0.062416241, 0.070455976, 0.080496028),
    (0.089454643, 0.068882823, 0.072273992, 0.082283325, 0.067619525, 0.048983522, 0.050792091, 0.067798898, 0.0695711, 0.053144261, 0.049396388, 0.075840339, 0.077572785, 0.068022899, 0.059273977, 0.075969607),
    (0.070051529, 0.067770787, 0.083923399, 0.066627681, 0.084858403, 0.073566005, 0.078086548, 0.076088957, 0.078036316, 0.067751743, 0.071352325, 0.081705704, 0.069176055, 0.059546463, 0.063290142, 0.07156454),
    (0.08384373, 0.07895425, 0.06516362, 0.066210501, 0.067558989, 0.075572051, 0.064393118, 0.071919039, 0.064119771, 0.077934548, 0.08589077, 0.080646135, 0.078689106, 0.06059086, 0.067384861, 0.077811748),
    (0.072864823, 0.060902465, 0.06421151, 0.06503287, 0.075446144, 0.074039996, 0.069877766, 0.0538668, 0.056069396, 0.06806203, 0.069510385, 0.067209162, 0.064427383, 0.063341692, 0.071978845, 0.064158663),
    (0.076380335, 0.058995973, 0.06163083, 0.063661315, 0.062630981, 0.072031111, 0.060909774, 0.060332686, 0.055874545, 0.056263987, 0.079268463, 0.075256638, 0.059172191, 0.065767549, 0.087312609, 0.075560175),
    (0.063768566, 0.077493325, 0.069128878, 0.063273653, 0.055762328, 0.082881421, 0.072749563, 0.06091563, 0.061615322, 0.074936584, 0.073249184, 0.070744805, 0.051101416, 0.069833584, 0.071905531, 0.083716758),
    (0.064442851, 0.066588238, 0.074485995, 0.065652244, 0.066610023, 0.069181755, 0.077081814, 0.071661443, 0.072457962, 0.067300647, 0.063980579, 0.057566106, 0.062422868, 0.069794655, 0.067486197, 0.067052521),
    (0.080345206, 0.071989104, 0.071965009, 0.075101472, 0.05595779, 0.078033909, 0.078205615, 0.077455752, 0.07666263, 0.066526629, 0.065174274, 0.069749199, 0.061563928, 0.058983326, 0.072237484, 0.06764105),
    (0.067808829, 0.080176853, 0.082508564, 0.079045914, 0.068837568, 0.074533768, 0.066472203, 0.070931546, 0.070862375, 0.08069092, 0.073726855, 0.078965202, 0.06581638, 0.066025935, 0.075133875, 0.068145558),
    ), cost=149.90011596679688, psnr=27.456958770751953, iterations=16),
}
TVF_BAND = {
    "patch_tv": dict(alpha=0.0012720823287963867, psnr=0.000392913818359375,
                     cost=3.627320658553092e-05),
    "sumregs": dict(alpha=0.006126571446657181, psnr=0.025308609008789062,
                    cost=0.00858208895156409),
    "patch_sumregs": dict(alpha=0.00033867359161376953,
                          psnr=0.00099945068359375,
                          cost=0.0002488593089257401),
    "grid16": dict(alpha=0.00046162307262420654, psnr=1.1444091796875e-05,
                   cost=8.143443499872861e-07),
}
TVF_ALPHA_GATE = 1e-3       # × max|α|, absolute
TVF_PSNR_GATE = 0.01        # dB
TVF_COST_GATE_REL = 1e-3
# The float64 witnesses (phase 40): scalar_bilevel_sumregs_learn (4 outer
# iterations) and patch_bilevel_tv_learn (8) in float64 on the card with
# HypergradConfig(al_iters=2, cg_maxiter=1000, act_tol=1e-4), whose
# adjoint systems are well conditioned (at the float64 default act_tol
# 1e-9 the exact system moves the JAX package's own gradient by percent
# under a 1e-13 perturbation of the data), against the JAX package's
# float64 runs (jax_reference_tv_family.py --float64 sumregs_witness
# patch_tv_witness), gated at 1e-6 relative on the weights (× the
# largest) and the cost.  The plain versions on the CPU agree with them
# to 3e-12.
TVF_WITNESS = {
    "sumregs": dict(maxiter=4, cost=159.12329031649494,
                    x=(0.023767526640829872, 0.024200251414195153,
                       0.03610000000000022)),
    "patch_tv": dict(maxiter=8, cost=399.2939413698404,
                     x=((0.018859514489999993, 0.018589706702252302),
                        (0.01844376012853778, 0.018603169260599125))),
}
TVF_WITNESS_GATE_REL = 1e-6

# The host trust region (method="tr", phases 41-44).  Phase 41 is the
# flagship default call, scalar_bilevel_tv_learn(dataset_name="faces_train",
# num_samples=10) with every other argument the entry point's default
# (float64, 5000 cold inner iterations an evaluation, HypergradConfig(),
# 20 outer iterations at most), against the JAX package's float64 run of
# the same call on the CPU (scripts/jax_reference_tr.py): α within 1e-6
# relative, the mean PSNR within 0.01 dB, the cost within 0.1%.
TR_ALPHA = 0.06978684257366222
TR_COST = 152.3294307322539
TR_PSNR = 27.386048193674885
TR_ITERATIONS = 13
TR_ALPHA_GATE_REL = 1e-6
TR_PSNR_GATE = 0.01          # dB
TR_COST_GATE_REL = 1e-3
# phases 43-44: tr against tr_fused at inner_tol=None (the same kernels on
# the same inputs; only the trust-region arithmetic differs, NumPy float64
# against torch float64): the logged cost, ‖g‖ and Δ and the accept
# pattern
TR_PARITY_GATE_REL = 1e-10


# Results and reporting (phases 45-48).  Phase 45: the flagship learn of
# phase 5 with save_results=True in a temporary directory.  Phases 46-47:
# the validations and the cost sweeps in float64 on the card against the
# JAX package's float64 runs of the same calls on the CPU
# (scripts/jax_reference_reporting.py, whose tables these are): the cost
# within 1e-8 relative (a sweep: each point) and the mean PSNR within
# 1e-6 dB.  Both sides run the same fixed-budget cold iteration in float64,
# so they differ by the kernels' rounding (kernel A's projection, sums in
# another order), ~1e-13 relative on u; a fault in a kernel, a weight
# map or the quality table moves them by 1e-4 or more.
REPORTING_VALIDATIONS = {
    "val_tv": ("api", "validate_tv_parameter", 0.069788,
               dict(dataset_name="faces_val"), "pdps"),
    "val_sumregs": ("api", "validate_sumregs_parameter",
                    (0.03239759, 0.03223814, 0.00623653),
                    dict(dataset_name="faces_val"), "pdps"),
    "val_tgv": ("tgv", "validate_tgv_parameter", (0.085226, 0.044170),
                dict(dataset_name="faces_val"), "tgv"),
    "val_tvl1": ("tvl1", "validate_tvl1_parameter", 1.9234402,
                 dict(dataset_name="circle_sp"), "tvl1"),
    "val_vtv": ("vtv", "validate_vtv_parameter", 0.16529731,
                dict(dataset_name="color_disks"), "vtv"),
}
REPORTING_SWEEPS = {
    "sweep_tv": ("api", "generate_scalar_tv_cost", "faces_train",
                 ([0.02, 0.03, 0.045, 0.06, 0.07, 0.085, 0.12, 0.2],),
                 "pdps"),
    "sweep_tv_2d": ("api", "generate_2d_tv_cost", "faces_train",
                    ([0.04, 0.06, 0.08, 0.1], [0.04, 0.06, 0.08, 0.1]),
                    "pdps"),
    "sweep_tgv": ("tgv", "generate_tgv_cost", "faces_train",
                  ([0.06, 0.085226, 0.11], [0.03, 0.04417, 0.06]), "tgv"),
    "sweep_tvl1": ("tvl1", "generate_tvl1_cost", "circle_sp",
                   ([0.5, 1.0, 1.5, 1.9234402, 3.0],), "tvl1"),
    "sweep_vtv": ("vtv", "generate_vtv_cost", "color_disks",
                  ([0.08, 0.12, 0.16529731, 0.2, 0.3],), "vtv"),
}
# the JAX package on the CPU, float64 (scripts/jax_reference_reporting.py)
REPORTING_REF = {
    "val_tv": dict(cost=209.40552979543645, mean_psnr=26.02170474079609,
        mean_ssim=0.7425912603961833, images=10),
    "val_sumregs": dict(cost=207.40792568207306, mean_psnr=26.061705994669914,
        mean_ssim=0.7439562053189491, images=10),
    "val_tgv": dict(cost=213.98290249369862, mean_psnr=25.96831627265925,
        mean_ssim=0.7505489679070806, images=10),
    "val_tvl1": dict(cost=9.942191746851632, mean_psnr=29.1590780886855,
        mean_ssim=0.9865746315562819, images=1),
    "val_vtv": dict(cost=34.08593717652368, mean_psnr=36.435134647363334,
        mean_ssim=0.9828808949264234, images=6),
    "sweep_tv": dict(costs=(
        37.93603116918058, 28.99298174475031, 22.18536274953173,
        20.40939417260516, 20.745335566456305, 22.44597968450359,
        28.398534501173557, 44.09024130629548)),
    "sweep_tv_2d": dict(costs=(
        (23.751067484741924, 22.163118828161885, 23.036321464853323, 24.768176461286956),
        (21.99350551405694, 20.40939417260516, 21.27352854781411, 22.99461886204771),
        (22.49684843076095, 20.911409712744764, 21.771253912810174, 23.48590732532142),
        (23.84279410990898, 22.253947653441124, 23.110751967483075, 24.810289629879115))),
    "sweep_tgv": dict(costs=(
        (17.74133644557031, 17.36938193372552, 18.10395376456339),
        (17.42390412969341, 17.244747759500832, 18.61837379007548),
        (17.42179653853052, 17.406941255815088, 19.629767682144884))),
    "sweep_tvl1": dict(costs=(
        24.599279975107333, 13.279322730721987, 10.657286168370918,
        9.942800228018342, 10.328247861162257)),
    "sweep_vtv": dict(costs=(
        21.836924493322968, 7.967918012826207, 6.609736137121934,
        7.031253051584571, 9.341629326892892)),
}
REPORTING_COST_GATE_REL = 1e-8
REPORTING_PSNR_GATE = 1e-6   # dB
# phase 48: the command line in a subprocess against the API in this
# process (the same kernels on the same card: the same bits)
REPORTING_CLI_GATE_REL = 1e-12

# peak rates of an H100 SXM (NVIDIA data sheet) for the bounds
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
F64_OPS_PER_S = 34e12      # float64 outside the tensor cores
# operations per pixel, counted from the kernels' arithmetic
# kernel A: 10 primal (3 divergence, 4 update, 3 extrapolation; 1+τ and 1+ω
# are scalars of the iteration) + 15 dual (2 differences, 2 σ-products,
# 2 sums, 2 squares, 1 add, compare, √, max, divide, 2 scalings)
A_OPS_PER_PIXEL_ITER = 25
B_OPS_PER_PIXEL_CG_ITER = 40
B_OPS_PER_PIXEL_SOLVE = 36      # CG start: W·Gp, Mp, r, z, d, three sums
B_OPS_PER_PIXEL_FIXED = 47      # set-up, diagonal, right-hand side, gradient
TGV_OPS_PER_PIXEL_ITER = 70     # 29 primal + 41 dual (csrc/tgv.cu)
TVL1_OPS_PER_PIXEL_ITER = 29    # plain form: 14 primal + 15 dual (csrc/tvl1.cu)
TVL1_HUBER_OPS_PER_PIXEL_ITER = 36   # Huber form: 14 primal + 22 dual
# VTV, per plane-pixel: kernel A's 10 primal + 13 dual (per plane 2
# differences, 2 σ-products, 2 sums, 2 squares, 2 scalings; per pixel 5 adds
# of the 2C = 6 squares, √, compare, max, divide, shared by C = 3 planes)
VTV_OPS_PER_PLANE_PIXEL_ITER = 23


# The single-loop learner (csrc/single_loop.cu), operations per pixel by
# the same rule (scalars of an iteration not counted per pixel).  Per
# stencil kind (forward, backward, centred): a gradient 2 / 2 / 4 (the
# centred one halves), an adjoint 3 / 3 / 5, a Gram diagonal 3 / 3 / 5.
SL_GRAD_OPS = (2, 2, 4)
SL_ADJ_OPS = (3, 3, 5)
SL_GRAM_OPS = (3, 3, 5)


# The other families' learners, per pixel (TGV², TV-L1) or per plane-pixel
# (VTV, C = 3) and outer step, by the same rule, from their kernels'
# arithmetic.  TGV²: the CP step 70; the system set-up 28 (∇u − w 4, Ew 6,
# two Huber norms 10 and scales 6, α·s 2) and diagonal 12; H·v 62 (the
# weights 46, the three output planes 16); a CG step H·d + 11 per plane (dot
# 2, update 7, direction 2); the start H·λ + 5 per plane; the gradient maps
# 25 and the cost 3.  TV-L1: the Huber CP step 36; the TV system of
# sl_ops_per_pixel with D (+2 in H·v, +7 in the diagonal).  VTV: the CP step
# 23; per plane-pixel H·v 21, the set-up 7, the diagonal 2, the gradient
# map 8 and the cost 3.
# the planes a learn writes out per pixel (per plane-pixel for VTV): the
# CP state and the adjoint (TGV² 1 + 2 + 2 + 3 + 3, TV-L1 1 + 2 + 1, VTV
# 1 + 2 + 1); f and ū are read in
SLX_OUT_PLANES = {"tgv": 11, "tvl1": 4, "vtv": 4}
# the device kernels of rows 11, 12 and 13 (the CP cluster kernel first;
# the tail shared, csrc/single_loop.cuh)
SLX_DEVICE_KERNELS = {
    name: dict(device_kernels=[f"{p}_{k}" for k in (
        "pd", "init", "apply", "update", "gmap")]
        + ["slx_pull_adam", "slx_begin"])
    for name, p in (("tgv", "slt"), ("tvl1", "sl1"), ("vtv", "slv"))}


def slx_bound(name, pixels, outer, itemsize=4):
    """(ms, "bytes" or "operations"): the least time of ``outer`` steps of
    40 CP and 10 CG steps of the family's learner on ``pixels``."""
    return bound_ms((2 + SLX_OUT_PLANES[name]) * pixels * itemsize,
                    slx_ops_per_pixel(name, 40, 10) * pixels * outer)


def slx_ops_per_pixel(family, n_inner, n_adj):
    if family == "tgv":
        return (n_inner * TGV_OPS_PER_PIXEL_ITER + 28 + 12 + (62 + 15)
                + n_adj * (62 + 33) + 25 + 3)
    if family == "tvl1":
        mv = 2 + 20 + 3 + 1 + 2
        return (n_inner * TVL1_HUBER_OPS_PER_PIXEL_ITER + n_adj * (mv + 11)
                + (2 + 25) + (3 + 1 + 1 + 7) + mv + 5 + (2 + 13) + 3)
    return (n_inner * VTV_OPS_PER_PLANE_PIXEL_ITER + n_adj * (21 + 11)
            + 7 + 2 + (21 + 5) + 8 + 3)


def sl_ops_per_pixel(kinds, n_inner, n_adj, pipelined=False):
    """Operations per pixel of one outer step of the single-loop learner.
    PD step: primal Σ adjoints + (K−1) adds + 6 (div − f, τ·, u −, /(1+τ),
    2u⁺, − u); dual per k the gradient + 13 (2 σ-products, 2 sums, 2
    squares, add, √, compare, max, divide, 2 scalings).  M·v per k: the
    gradient + 20 (Gu·Gv, ·(1/den)³, two curvature components of 3, γ·inact,
    two weighted sums of 4) + the adjoint + 1 add.  Classic CG step: M·d, the
    dot (2), the update (p, r, z, r·z and its add: 7), the direction (2);
    pipelined: M·u, two dots (4), the update (9).  Per outer step: the
    system set-up (gradient + 25 per k: |Gu|, act, γ·inact, 1/den, 1/den³,
    two Jacobi weights of 6, (1/den)³), the diagonal (Σ Gram + K adds + 1
    divide), M·p and the CG start (5), the gradient maps (gradient + 12
    per k, + 1 per k for the patch sums) and the cost (3)."""
    K = len(kinds)
    grad = sum(SL_GRAD_OPS[k] for k in kinds)
    adj = sum(SL_ADJ_OPS[k] for k in kinds)
    gram = sum(SL_GRAM_OPS[k] for k in kinds)
    pd = (adj + (K - 1) + 6) + (grad + 13 * K)
    mv = grad + 20 * K + adj + K
    cg = mv + (4 + 9 if pipelined else 2 + 7 + 2)
    fixed = ((grad + 25 * K) + (gram + K + 1) + mv + 5 + (grad + 13 * K)
             + 3)
    return n_inner * pd + n_adj * cg + fixed


def a_ops_per_pixel_iter(kinds, maps=0):
    """Kernel A's operations per pixel and iteration, by
    A_OPS_PER_PIXEL_ITER's rule, for blocks of the given stencil kinds:
    the primal step Σ adjoints + (K − 1) adds + 7, the dual step per block
    its gradient + 13, and 1 per map weight (its square)."""
    return (sum(SL_ADJ_OPS[k] for k in kinds) + len(kinds) - 1 + 7
            + sum(SL_GRAD_OPS[k] + 13 for k in kinds) + maps)


def b_ops_per_pixel(kinds, cg_iters, solves):
    """Kernel B's operations per pixel, by the B_OPS_PER_PIXEL_* rule: M·v
    per block its gradient + 20 + its adjoint + 1; a CG step M·v + 14, a
    CG start M·v + 10; the fixed work per block two gradients, a Gram
    diagonal, an adjoint and 26, and 11 shared (47 for one forward
    block)."""
    mv = sum(SL_GRAD_OPS[k] + 20 + SL_ADJ_OPS[k] + 1 for k in kinds)
    fixed = sum(2 * SL_GRAD_OPS[k] + SL_GRAM_OPS[k] + SL_ADJ_OPS[k] + 26
                for k in kinds) + 11
    return cg_iters * (mv + 14) + solves * (mv + 10) + fixed


# the band and cooperative kernels' instances by their mangled template
# arguments: kernel B's and kernel A's forms (csrc/hypergrad.cu: HgForm,
# csrc/pdps.cu: CpForm; rows 9-10's SlcForm shares the K codes), then the
# TV-L1 kernel's (Huber, map) flags; rows 11's and 13's kernels and the
# TGV² and VTV CP kernels by their argument types
KERNEL_FORMS = {"Li256E": "K=1 forward", "Li804E": "K=3 fwd/bwd/cen",
                "Li4352E": "K=1 forward, map",
                "Li29476E": "K=3 fwd/bwd/cen, maps", "Lin1E": "generic",
                "Lb0ELb0E": "plain, scalar", "Lb0ELb1E": "plain, map",
                "Lb1ELb0E": "Huber, scalar", "Lb1ELb1E": "Huber, map",
                "Li1EEEvNS_3SLTI": "TGV² learner, a CG block a partial block",
                "Li3EEEvNS_3SLTI": "TGV² learner, a CG block three planes",
                "NS_3SLTI": "TGV² learner", "NS_3TGVI": "TGV² CP",
                "Lb0EEEvNS_4TGVCI": "TGV² CP cluster, scalar weights",
                "Lb1EEEvNS_4TGVCI": "TGV² CP cluster, map weights",
                "Li3ELb0EEEvNS_4VTVCI": "VTV CP cluster, C = 3, scalar α",
                "Li3ELb1EEEvNS_4VTVCI": "VTV CP cluster, C = 3, map α",
                "Li0ELb0EEEvNS_4VTVCI": "VTV CP cluster, any C, scalar α",
                "Li0ELb1EEEvNS_4VTVCI": "VTV CP cluster, any C, map α",
                "Li3EEEvNS_3SLVI": "VTV learner, C = 3",
                "Li0EEEvNS_3SLVI": "VTV learner, any C",
                "NS_3SLVI": "VTV learner", "NS_3SL1I": "TV-L1 learner"}


def ptxas_report(log, source, needle):
    """The -Xptxas -v lines (registers, spills) of ``source``'s kernels
    whose names hold ``needle``, from the build log beside the library."""
    try:
        text = log.read_text()
    except OSError:
        return [f"no build log at {log}"]
    part = text.split(f"== {source}\n", 1)[-1].split("\n== ", 1)[0]
    lines = part.splitlines()
    out = []
    for i, line in enumerate(lines):
        if "Compiling entry function" not in line or needle not in line:
            continue
        name = line.split("'")[1]
        dtype = "float64" if "Id" in name.split(needle)[1][:3] else "float32"
        form = next((v for k, v in KERNEL_FORMS.items() if k in name),
                    name)
        if needle in ("slc_pd", "slt_pd", "sl1_pd", "slv_pd"):
            # RES after the dtype
            form += (", bands in shared memory"
                     if name.split(needle)[1][2:6] == "Lb1E"
                     else ", bands in global memory")
        regs = spills = "?"
        for nxt in lines[i + 1:i + 5]:
            if "registers" in nxt:
                regs = nxt.split("Used")[1].split(",")[0].strip()
            if "spill stores" in nxt:
                spills = nxt.strip()
        out.append(f"{needle} {dtype} {form}: {regs}; {spills}")
    return out


def say(msg):
    print(msg, flush=True)


def max_abs(a, b):
    return float((a.double() - b.double()).abs().max())


def rel_err(a, b):
    scale = float(b.double().abs().max())
    return max_abs(a, b) / (scale if scale > 0 else 1.0)


def require(ok, msg):
    if not ok:
        raise AssertionError(msg)


def cuda_timer(torch):
    def timed(fn):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        return out, start.elapsed_time(end)
    return timed


def bound_ms(nbytes, ops, ops_per_s=F32_OPS_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def weights(alphas, like):
    """Kernel weights in ``like``'s dtype: a number becomes a 0-d CPU
    tensor, an (M, N) map a tensor on ``like``'s device."""
    import torch
    return tuple(torch.tensor(a, dtype=like.dtype) if isinstance(a, float)
                 else a.to(device=like.device, dtype=like.dtype)
                 for a in alphas)


def phase_kernel_a(f, timed, *, maxiter=5000, tol=5e-6, check_every=50,
                   alphas=(0.1,), alphas_warm=(0.0698,), tol_u=TOL_A_U_F32,
                   tol_y=TOL_A_Y_F32, model=None, label="A"):
    """Kernel A against plain A: cold fixed budget, cold with early stop
    and state, warm from that state; by default the scalar TV form, else
    ``model`` (K blocks) with ``alphas`` (numbers or maps).  All three are
    compared (u and every dual) and printed before the phase fails on any
    of them.  Returns (state u, stats)."""
    from bpldenoising_tpu_torch.models import tv_model
    from bpldenoising_tpu_torch.solvers import pdps_cuda
    from bpldenoising_tpu_torch.solvers.cluster_plan import pd_plan
    from bpldenoising_tpu_torch.solvers.pdps import _denoise_pdps_impl

    model = model or tv_model()
    kw = dict(model=model, tau0=5.0, sigma0=0.99 / 5.0, gamma=1.0,
              accel=True)
    a = weights(alphas, f)
    a_warm = weights(alphas_warm, f)
    worst = 0.0
    faults = []
    ops = []     # kernel A's device operations, call by call

    def both(alphas, state0, **extra):
        before = pdps_cuda.device_ops
        k_out, k_ms = timed(lambda: pdps_cuda.denoise_pdps_cuda(
            f, alphas, state0, **kw, **extra))
        ops.append(pdps_cuda.device_ops - before)
        p_out, p_ms = timed(lambda: _denoise_pdps_impl(
            f, alphas, state0, **kw, **extra))
        return k_out, k_ms, p_out, p_ms

    def check(label, ku, pu, kys=None, pys=None, kit=None, pit=None):
        nonlocal worst
        err_u = max_abs(ku, pu)
        err_y = max(max_abs(ky, py) for ky, py in zip(kys, pys)) \
            if kys is not None else 0.0
        worst = max(worst, err_u, err_y)
        if err_u > tol_u or err_y > tol_y:
            faults.append(f"{label}: max|du| {err_u}, max|dy| {err_y}")
        if kit is not None and abs(kit - pit) > check_every:
            faults.append(f"{label}: iterations {kit} vs {pit}")
        return f"max|du| {err_u:.2e}, max|dy| {err_y:.2e}"

    # 1: cold, fixed budget; a warm-up call first so the timing excludes
    # the library load
    pdps_cuda.denoise_pdps_cuda(f, a, None, **kw, maxiter=10, tol=None,
                                check_every=check_every, return_dual=True)
    (ku, kys, _), k_ms, (pu, pys, _), p_ms = both(
        a, None, maxiter=maxiter, tol=None, check_every=check_every,
        return_dual=True)
    say(f"  {label} cold {maxiter} it: {check('cold', ku, pu, kys, pys)}; "
        f"kernel {k_ms:.2f} ms, plain {p_ms:.2f} ms")
    cold = dict(ms=k_ms, plain_ms=p_ms, iters=maxiter)

    # 2: cold with early stop, returning the state
    (ku, kys, kit), k_ms, (pu, pys, pit), p_ms = both(
        a, None, maxiter=maxiter, tol=tol, check_every=check_every,
        return_dual=True)
    msg = check("cold early stop", ku, pu, kys, pys, kit, pit)
    say(f"  {label} cold tol {tol:g}: iters {kit}/{pit}, {msg}; "
        f"kernel {k_ms:.2f} ms, plain {p_ms:.2f} ms")

    # 3: warm from the plain version's state, early stop
    state = (pu, pys)
    (wu, wys, wit), k_ms, (qu, qys, qit), p_ms = both(
        a_warm, state, maxiter=maxiter, tol=tol, check_every=check_every,
        return_dual=True)
    msg = check("warm early stop", wu, qu, wys, qys, wit, qit)
    say(f"  {label} warm tol {tol:g}: iters {wit}/{qit}, {msg}; "
        f"kernel {k_ms:.2f} ms, plain {p_ms:.2f} ms")
    say(f"  {label} tolerances: u {tol_u:g}, y {tol_y:g} (absolute)")
    plan = pd_plan(f.shape[-2], f.shape[-1], model.K, f.element_size())
    say(f"  {label} plan: cluster {plan.cluster}, {plan.rows} rows a CTA, "
        f"resident {plan.resident} ({plan.smem} B a CTA); device "
        f"operations a call: cold {ops[0]}, cold tol {ops[1]} ({kit} its), "
        f"warm tol {ops[2]} ({wit} its)")
    require(not faults, f"kernel {label} disagrees with plain: "
            + "; ".join(faults))
    require(plan.resident, f"kernel {label}: {plan} is not the cluster form")
    return pu, dict(cold, max_abs_err=worst, plan=plan._asdict(),
                    device_ops=ops)


def phase_kernel_b(u, utrue, timed, *, alphas=(0.1,), rtol=TOL_B_F32_REL,
                   model=None, want_maps=False, label="B"):
    """Kernel B (exact and regularized) against plain B: by default the
    scalar TV form, else ``model`` with ``alphas`` (numbers or maps) and,
    with ``want_maps``, per-pixel gradient maps (held to ``rtol`` of their
    largest entry)."""
    from bpldenoising_tpu_torch.models import tv_model
    from bpldenoising_tpu_torch.solvers import hypergrad_cuda
    from bpldenoising_tpu_torch.solvers.hypergrad import (
        HypergradConfig, exact_hypergrad, reg_hypergrad)

    model = model or tv_model()
    cfg = HypergradConfig(al_iters=2, cg_maxiter=100)
    a = weights(alphas, u)
    out = {}
    worst = 0.0
    faults = []
    for name, kern, plain in (
            ("exact", hypergrad_cuda.exact_hypergrad_cuda, exact_hypergrad),
            ("reg", hypergrad_cuda.reg_hypergrad_cuda, reg_hypergrad)):
        kern(u, utrue, a, model, cfg, want_maps)   # warm-up
        ((kg, kp, ki), ops), k_ms = timed(lambda: kernel_b_call(
            lambda: kern(u, utrue, a, model, cfg, want_maps)))
        total = hypergrad_cuda.last_total_cg_iters
        (pg, pp, pi), p_ms = timed(lambda: plain(u, utrue, a, model, cfg,
                                                 want_maps))
        if want_maps:
            g_err = max(rel_err(k, p) for k, p in zip(kg, pg))
            grads = f"{len(kg)} grad maps"
        else:
            g_err = max(abs(float(k) - float(p)) / max(abs(float(p)), 1e-30)
                        for k, p in zip(kg, pg))
            grads = "grad " + ", ".join(f"{float(k):.6e}/{float(p):.6e}"
                                        for k, p in zip(kg, pg))
        p_err = rel_err(kp, pp)
        worst = max(worst, max_abs(kp, pp))
        say(f"  {label} {name}: {grads} rel {g_err:.2e}, p rel {p_err:.2e} "
            f"(tol {rtol:g}), CG {ki.iters}/{pi.iters}; kernel {k_ms:.2f} "
            f"ms, plain {p_ms:.2f} ms")
        say(f"  {label} {name} digits: {b_digits(kg, kp)}, CG {ki.iters} "
            f"(all solves {total}); {ops[0]} kernel launch, {ops[1]} host "
            f"read, {hypergrad_cuda.last_grid} CTAs")
        if g_err > rtol or p_err > rtol:
            faults.append(f"{name}: grad rel {g_err}, p rel {p_err}")
        if abs(ki.iters - pi.iters) > 1:
            faults.append(f"{name}: CG iterations {ki.iters} vs {pi.iters}")
        out[name] = dict(ms=k_ms, plain_ms=p_ms, total_cg=total)
    require(not faults, f"kernel {label} disagrees with plain: "
            + "; ".join(faults))
    out["max_abs_err"] = worst
    return out


def phase_f64(torch, device):
    """Both kernels in float64 at a small shape.  Kernel B gets a
    piecewise-constant image with a ramp, whose pixel gradients are zero or
    well above the active-set threshold, so its systems are well
    conditioned and CG agrees to rounding (on an ill-conditioned system CG
    amplifies rounding, as the CPU tests document)."""
    from bpldenoising_tpu_torch.models import tv_model
    from bpldenoising_tpu_torch.solvers import hypergrad_cuda, pdps_cuda
    from bpldenoising_tpu_torch.solvers.hypergrad import (
        HypergradConfig, exact_hypergrad, reg_hypergrad)
    from bpldenoising_tpu_torch.solvers.pdps import _denoise_pdps_impl

    f64 = torch.float64
    gen = torch.Generator().manual_seed(0)
    clean = torch.zeros((2, 32, 32), dtype=f64)
    clean[:, 8:24, 8:24] = 1.0
    f = (clean + 0.1 * torch.randn(clean.shape, generator=gen,
                                   dtype=f64)).to(device)
    model = tv_model()
    a = (torch.tensor(0.07, dtype=f64),)
    kw = dict(model=model, tau0=5.0, sigma0=0.99 / 5.0, gamma=1.0,
              accel=True, maxiter=2000, tol=1e-7, check_every=50,
              return_dual=True)
    ku, kys, kit = pdps_cuda.denoise_pdps_cuda(f, a, None, **kw)
    pu, pys, pit = _denoise_pdps_impl(f, a, None, **kw)
    err_u, err_y = rel_err(ku, pu), rel_err(kys[0], pys[0])

    levels = torch.rand((2, 8, 8), generator=gen, dtype=f64)
    u = torch.kron(levels, torch.ones((4, 4), dtype=f64))
    u[:, 24:, :] += 0.3 * torch.linspace(0.0, 1.0, 32, dtype=f64)
    utrue = u + 0.05 * torch.randn(u.shape, generator=gen, dtype=f64)
    u, utrue = u.to(device), utrue.to(device)
    errs_b = []
    its = []
    for kern, plain, cfg in (
            (hypergrad_cuda.exact_hypergrad_cuda, exact_hypergrad,
             HypergradConfig(al_iters=2, cg_maxiter=300)),
            (hypergrad_cuda.reg_hypergrad_cuda, reg_hypergrad,
             HypergradConfig(cg_maxiter=300, gamma=1e4))):
        (kg, kp, ki), _ = kernel_b_call(
            lambda: kern(u, utrue, a, model, cfg))
        pg, pp, pi = plain(u, utrue, a, model, cfg)
        errs_b.append(abs(float(kg[0]) - float(pg[0]))
                      / max(abs(float(pg[0])), 1e-30))
        errs_b.append(rel_err(kp, pp))
        its.append((ki.iters, pi.iters))
    say(f"  float64 2x32x32: A iters {kit}/{pit} rel u {err_u:.2e} y "
        f"{err_y:.2e}; B rel {max(errs_b):.2e}, CG {its} "
        f"(tol {TOL_F64_REL:g})")
    require(kit == pit, f"float64 kernel A: iterations {kit} vs {pit}")
    require(max(err_u, err_y, *errs_b) <= TOL_F64_REL,
            f"float64 rel err u {err_u}, y {err_y}, B {errs_b}")
    require(all(abs(k - p) <= 1 for k, p in its),
            f"float64 kernel B: CG iterations {its}")


def tgv_errors(k_out, p_out):
    """Max abs error of each of u, w, p, q (kernel vs plain)."""
    (_, _, kst, _), (_, _, pst, _) = k_out, p_out
    return [max_abs(k, p) for k, p in zip(kst, pst)]


def phase_tgv(f, timed, *, maxiter=5000, tol=3e-6, check_every=100):
    """The TGV² kernel against plain TGV², scalar and map weights: cold
    fixed budget, cold with early stop and state, warm from that state at
    nudged weights.  Everything is compared and printed before the phase
    fails.  Returns the stats of the scalar cold call."""
    import torch
    from bpldenoising_tpu_torch.ops import PatchOp
    from bpldenoising_tpu_torch.solvers import tgv_cuda
    from bpldenoising_tpu_torch.solvers.tgv import _tgv_impl

    dt = f.dtype
    pop = PatchOp((2, 2), tuple(f.shape[-2:]))
    grid1 = torch.tensor(TGV_PATCH_A1, dtype=dt)
    grid0 = torch.tensor(TGV_PATCH_A0, dtype=dt)
    weights = {
        "scalar": ((TGV_ALPHA[0], TGV_ALPHA[1]),
                   (1.05 * TGV_ALPHA[0], 0.95 * TGV_ALPHA[1])),
        "map": ((pop.apply(grid1).to(f.device), pop.apply(grid0).to(f.device)),
                (pop.apply(1.05 * grid1).to(f.device),
                 pop.apply(0.95 * grid0).to(f.device))),
    }
    worst = 0.0
    faults = []
    out = {}

    def both(a, state0, **kw):
        k_out, k_ms = timed(lambda: tgv_cuda.tgv_denoise_pdps_cuda(
            f, *a, state0=state0, return_state=True, **kw))
        p_out, p_ms = timed(lambda: _tgv_impl(
            f, *a, state0, tau0=0.99, sigma0=0.99, return_state=True, **kw))
        return k_out, k_ms, p_out, p_ms

    def check(label, k_out, p_out, iters=False):
        nonlocal worst
        errs = tgv_errors(k_out, p_out)
        worst = max(worst, *errs)
        if errs[0] > TOL_TGV_U_F32 or max(errs[1:]) > TOL_TGV_DUAL_F32:
            faults.append(f"{label}: max|d(u,w,p,q)| {errs}")
        if iters and k_out[3] != p_out[3]:
            faults.append(f"{label}: iterations {k_out[3]} vs {p_out[3]}")
        return ("max|du| {:.2e}, |dw| {:.2e}, |dp| {:.2e}, |dq| {:.2e}"
                .format(*errs))

    tgv_cuda.tgv_denoise_pdps_cuda(f, *weights["scalar"][0], maxiter=10)
    for kind, (a, a_warm) in weights.items():
        k_out, k_ms, p_out, p_ms = both(a, None, maxiter=maxiter, tol=None,
                                        check_every=check_every)
        say(f"  TGV {kind} cold {maxiter} it: {check(kind, k_out, p_out)}; "
            f"kernel {k_ms:.2f} ms, plain {p_ms:.2f} ms")
        out[kind] = dict(ms=k_ms, plain_ms=p_ms, iters=maxiter,
                         u=k_out[0])
        k_out, k_ms, p_out, p_ms = both(a, None, maxiter=maxiter, tol=tol,
                                        check_every=check_every)
        msg = check(f"{kind} early stop", k_out, p_out, iters=True)
        say(f"  TGV {kind} cold tol {tol:g}: iters {k_out[3]}/{p_out[3]}, "
            f"{msg}; kernel {k_ms:.2f} ms, plain {p_ms:.2f} ms")
        state = p_out[2]
        k_out, k_ms, p_out, p_ms = both(a_warm, state, maxiter=maxiter,
                                        tol=tol, check_every=check_every)
        msg = check(f"{kind} warm", k_out, p_out, iters=True)
        say(f"  TGV {kind} warm tol {tol:g}: iters {k_out[3]}/{p_out[3]}, "
            f"{msg}; kernel {k_ms:.2f} ms, plain {p_ms:.2f} ms")
    # a constant map is the scalar weight, bit for bit
    const = tuple(torch.full(tuple(f.shape[-2:]), v, dtype=dt,
                             device=f.device) for v in TGV_ALPHA)
    cu, _ = tgv_cuda.tgv_denoise_pdps_cuda(f, *const, maxiter=maxiter)
    same = bool(torch.equal(cu, out["scalar"]["u"]))
    say(f"  TGV constant map == scalar weights: {same}; tolerances u "
        f"{TOL_TGV_U_F32:g}, w/p/q {TOL_TGV_DUAL_F32:g} (absolute)")
    if not same:
        faults.append("a constant map differs from the scalar weights")
    require(not faults, "TGV kernel disagrees with plain: "
            + "; ".join(faults))
    return dict(out["scalar"], max_abs_err=worst)


def phase_tgv_f64(torch, device):
    """The TGV² kernel in float64 at 2 × 32²: cold with early stop (scalar
    weights), cold fixed budget (map weights), warm from the first state."""
    from bpldenoising_tpu_torch.solvers import tgv_cuda
    from bpldenoising_tpu_torch.solvers.tgv import _tgv_impl

    f64 = torch.float64
    gen = torch.Generator().manual_seed(1)
    yy, xx = torch.meshgrid(torch.arange(32, dtype=f64),
                            torch.arange(32, dtype=f64), indexing="ij")
    clean = torch.stack([0.02 * xx + (yy > 16).to(f64),
                         0.03 * yy + (((xx - 16) ** 2 + (yy - 12) ** 2)
                                      < 60).to(f64)])
    f = (clean + 0.1 * torch.randn(clean.shape, generator=gen,
                                   dtype=f64)).to(device)
    amap = (0.05 + 0.1 * torch.rand((32, 32), generator=gen,
                                    dtype=f64)).to(device)
    runs = (("scalar tol", (0.1, 0.05), None,
             dict(maxiter=3000, tol=1e-5, check_every=50)),
            ("map fixed", (amap, 0.05), None,
             dict(maxiter=1000, tol=None, check_every=50)),
            ("scalar warm", (0.11, 0.045), "first",
             dict(maxiter=3000, tol=1e-5, check_every=50)))
    errs, its = [], []
    first = None
    for label, a, warm, kw in runs:
        state0 = first if warm else None
        k = tgv_cuda.tgv_denoise_pdps_cuda(f, *a, state0=state0,
                                           return_state=True, **kw)
        p = _tgv_impl(f, *a, state0, tau0=0.99, sigma0=0.99,
                      return_state=True, **kw)
        first = first or p[2]
        errs.append(max(rel_err(ks, ps) for ks, ps in zip(k[2], p[2])))
        its.append((k[3], p[3]))
    say(f"  TGV float64 2x32x32: rel err {['%.2e' % e for e in errs]}, "
        f"iters {its} (tol {TOL_F64_REL:g})")
    require(all(kit == pit for kit, pit in its),
            f"float64 TGV: iterations {its}")
    require(max(errs) <= TOL_F64_REL, f"float64 TGV rel err {errs}")


def phase_large(f, timed):
    """The shapes the TPU sends to its row-tiled kernels: TGV² at 1 × 1024²
    and kernel A at 1 × 2048², 1000 iterations each (bench.py's tiling of
    the first faces image).  TGV² runs its tile form (required: one
    tile-form call, the launches and copies its plan gives), and the
    two-launch form it replaced, forced, is timed beside it in the same
    call and must give its bits."""
    import torch
    from bpldenoising_tpu_torch.models import tv_model
    from bpldenoising_tpu_torch.solvers import tgv_cuda
    from bpldenoising_tpu_torch.solvers.cluster_plan import tgv_tile_plan
    from bpldenoising_tpu_torch.solvers.tgv import _tgv_impl

    out = {}
    img = f[:1].repeat(1, 8, 8).contiguous()
    kw = dict(maxiter=1000, tol=None, check_every=100)
    plan = tgv_tile_plan(1024, 1024, img.element_size(), 0, 1)
    first = tgv_counts()
    tgv_cuda.tgv_denoise_pdps_cuda(img, 0.1, 0.2, maxiter=5)
    c0 = tgv_counts()
    k_out, k_ms = timed(lambda: tgv_cuda.tgv_denoise_pdps_cuda(
        img, 0.1, 0.2, return_state=True, **kw))
    c1 = tgv_counts()
    restore = tgv_forced_two_launch()
    try:
        tgv_cuda.tgv_denoise_pdps_cuda(img, 0.1, 0.2, maxiter=5)
        g0 = tgv_counts()
        g_out, g_ms = timed(lambda: tgv_cuda.tgv_denoise_pdps_cuda(
            img, 0.1, 0.2, return_state=True, **kw))
        g1 = tgv_counts()
    finally:
        restore()
    p_out, p_ms = timed(lambda: _tgv_impl(img, 0.1, 0.2, None, tau0=0.99,
                                          sigma0=0.99, return_state=True,
                                          **kw))
    errs = tgv_errors(k_out, p_out)
    same = tgv_same(k_out, g_out)
    ops = c1[3] - c0[3]
    want = tgv_tile_ops(plan.T, 1000, 1000, None, 100)
    say("  TGV 1x1024x1024, 1000 it: max|du| {:.2e}, |dw| {:.2e}, |dp| "
        "{:.2e}, |dq| {:.2e}; ".format(*errs)
        + f"tile form {k_ms:.2f} ms (tile {plan.rows}x{plan.cols}, T "
        f"{plan.T}, grid {plan.grid}; {ops} device operations), two-launch "
        f"{g_ms:.2f} ms ({g1[3] - g0[3]} device operations; bits of the "
        f"tile form: {same}), plain {p_ms:.2f} ms")
    require(errs[0] <= TOL_TGV_U_F32 and max(errs[1:]) <= TOL_TGV_DUAL_F32,
            f"TGV 1024^2 kernel disagrees with plain: {errs}")
    require(c1[0] - c0[0] == 1 and c1[2] - c0[2] == 1 and ops == want,
            f"TGV 1024^2: not one tile-form call of {want} device "
            f"operations: {c0} -> {c1}")
    require(g1[2] == g0[2] and g1[3] - g0[3] == 2000,
            f"TGV 1024^2: the forced two-launch form counted {g0} -> {g1}")
    require(same, "TGV 1024^2: the tile form differs from the two-launch "
            "form")
    nbytes = 9 * img.numel() * img.element_size()   # f in; 8 planes out
    bound, by = bound_ms(nbytes, TGV_OPS_PER_PIXEL_ITER * img.numel() * 1000)
    out["tgv_1024"] = dict(ms=k_ms, plain_ms=p_ms, max_abs_err=max(errs),
                           bound_ms=bound, bound_by=by,
                           launches=c1[0] - first[0], device_ops=ops,
                           two_launch_ms=g_ms,
                           two_launch_device_ops=g1[3] - g0[3],
                           plan=plan._asdict())

    img = f[:1].repeat(1, 16, 16).contiguous()
    out["pdps_2048"] = large_a(img, timed, tv_model(),
                               (torch.tensor(0.1, dtype=img.dtype),),
                               "A 1x2048x2048")
    return out


def tgv_counts():
    """The TGV² kernel's calls, cluster-form calls, tile-form calls and
    device operations so far."""
    from bpldenoising_tpu_torch.solvers import tgv_cuda
    return (tgv_cuda.launches, tgv_cuda.cluster_calls, tgv_cuda.tiled_calls,
            tgv_cuda.device_ops)


def tgv_forced_two_launch():
    """Make the TGV² kernel plan its two-launch form where the bands do
    not fit (no tile plan) → restore."""
    from bpldenoising_tpu_torch.solvers import tgv_cuda
    real = tgv_cuda.tgv_tile_plan
    tgv_cuda.tgv_tile_plan = lambda *a, **k: None

    def restore():
        tgv_cuda.tgv_tile_plan = real
    return restore


def tgv_same(k_out, g_out):
    """Two TGV² results ``(u, w, state, iters)`` the same bit for bit."""
    import torch
    return k_out[3] == g_out[3] and all(
        torch.equal(x, y) for x, y in zip(k_out[2], g_out[2]))


def tgv_tile_ops(T, iters, maxiter, tol, check):
    """The device operations of a TGV² tile-form call (csrc/tgv_tile.cu's
    tt_run): ⌈chunk / T⌉ launches a chunk, u among three buffers and w, p,
    q between two; per check the two passes of the sums and the read; a
    last copy of u and three of w, p, q where they end in another
    buffer."""
    cu = cy = ops = 0

    def advance(n, snap):
        nonlocal cu, cy, ops
        for _ in range(-(-n // T)):
            to = (cu + 1) % 3
            if to == snap or (snap < 0 and to == 2):
                to = (to + 1) % 3
            if to == cu:
                to = (cu + 2) % 3
            cu, cy, ops = to, 1 - cy, ops + 1

    if tol is None:
        advance(maxiter, -1)
    else:
        it = 0
        while it < iters:
            chunk = min(check, maxiter - it)
            advance(chunk, cu)
            ops += 3
            it += chunk
    return ops + (cu != 0) + 3 * (cy != 0)


def large_a(img, timed, model, a, label, iters=1000):
    """Kernel A against its plain version on one large image, timed, with
    its bound (f in; u and the K duals out)."""
    from bpldenoising_tpu_torch.solvers import pdps_cuda
    from bpldenoising_tpu_torch.solvers.pdps import _denoise_pdps_impl

    kw = dict(model=model, tau0=5.0, sigma0=0.99 / 5.0, gamma=1.0,
              accel=True, maxiter=iters, tol=None, check_every=50,
              return_dual=True)
    from bpldenoising_tpu_torch.solvers.cluster_plan import (pd_plan,
                                                             pd_tile_plan)

    launches0 = pdps_cuda.launches
    pdps_cuda.denoise_pdps_cuda(img, a, None, **dict(kw, maxiter=5))
    before, tiled = pdps_cuda.device_ops, pdps_cuda.tiled_calls
    (ku, kys, _), k_ms = timed(lambda: pdps_cuda.denoise_pdps_cuda(
        img, a, None, **kw))
    ops = pdps_cuda.device_ops - before
    tiled = pdps_cuda.tiled_calls - tiled
    launches = pdps_cuda.launches - launches0
    (pu, pys, _), p_ms = timed(lambda: _denoise_pdps_impl(img, a, None,
                                                         **kw))
    err_u = max_abs(ku, pu)
    err_y = max(max_abs(k, p) for k, p in zip(kys, pys))
    M, N = img.shape[-2:]
    plan = pd_plan(M, N, model.K, img.element_size())
    kinds = [pdps_kind(op) for op in model.ops]
    tile = None if plan.resident else pd_tile_plan(
        M, N, model.K, img.element_size(),
        sum(int(x.ndim > 0) for x in a), len(set(kinds)) > 1 or 2 in kinds,
        images=img.shape[0])
    form = (f"cluster {plan.cluster}, {plan.rows} rows a CTA" if tile is None
            else f"tile form: {tile.rows}x{tile.cols} tiles, T {tile.T}, "
            f"H {tile.H}, grid {tile.grid}, {tiled} tile-form call")
    say(f"  {label}, {iters} it: max|du| {err_u:.2e}, max|dy| "
        f"{err_y:.2e}; kernel {k_ms:.2f} ms, plain {p_ms:.2f} ms; plan: "
        f"{form}; {ops} device operations")
    require(err_u <= TOL_A_U_F32 and err_y <= TOL_A_Y_F32,
            f"kernel {label} disagrees with plain: {err_u}, {err_y}")
    require(launches > 0, f"{label}: kernel A was not launched")
    kinds = [pdps_kind(op) for op in model.ops]
    nbytes = (2 + 2 * len(kinds)) * img.numel() * img.element_size()
    bound, by = bound_ms(nbytes, a_ops_per_pixel_iter(kinds) * img.numel()
                         * iters)
    return dict(ms=k_ms, plain_ms=p_ms, max_abs_err=max(err_u, err_y),
                bound_ms=bound, bound_by=by, plan=plan._asdict(),
                tile=None if tile is None else tile._asdict(),
                launches=launches, tiled_calls=tiled, device_ops=ops)


def pdps_kind(op):
    """The stencil kind (0 forward, 1 backward, 2 centred) of an op."""
    from bpldenoising_tpu_torch.solvers.pdps_cuda import STENCIL
    return STENCIL[type(op)]


def launch_counters():
    """Every kernel wrapper module by the name of its count."""
    from bpldenoising_tpu_torch.bilevel import (first_order_cuda,
                                                first_order_tgv_cuda,
                                                first_order_tvl1_cuda,
                                                first_order_vtv_cuda)
    from bpldenoising_tpu_torch.solvers import (hypergrad_cuda, pdps_cuda,
                                                tgv_cuda, tvl1_cuda,
                                                vtv_cuda)
    return dict(pdps=pdps_cuda, hypergrad=hypergrad_cuda, tgv=tgv_cuda,
                tvl1=tvl1_cuda, vtv=vtv_cuda, single_loop=first_order_cuda,
                single_loop_tgv=first_order_tgv_cuda,
                single_loop_tvl1=first_order_tvl1_cuda,
                single_loop_vtv=first_order_vtv_cuda)


def reset_launches():
    from bpldenoising_tpu_torch.solvers import (hypergrad_cuda, pdps_cuda,
                                                tgv_cuda, tvl1_cuda,
                                                vtv_cuda)
    for mod in launch_counters().values():
        mod.launches = 0
    for mod in (pdps_cuda, tvl1_cuda, tgv_cuda, vtv_cuda):
        mod.cluster_calls = 0
        mod.device_ops = 0
    pdps_cuda.tiled_calls = 0
    hypergrad_cuda.device_ops = 0
    hypergrad_cuda.host_reads = 0


def kernel_a_forms():
    """Since the last reset: kernel A's calls, those that ran its cluster
    form, and the device operations (launches and copies) they issued."""
    from bpldenoising_tpu_torch.solvers import pdps_cuda
    return dict(calls=pdps_cuda.launches, cluster=pdps_cuda.cluster_calls,
                device_ops=pdps_cuda.device_ops)


def say_kernel_a_forms(forms):
    calls = max(forms["calls"], 1)
    say(f"  kernel A: {forms['calls']} calls, {forms['cluster']} in the "
        f"cluster form (one launch per early-stop chunk), "
        f"{forms['device_ops']} device operations "
        f"({forms['device_ops'] / calls:.1f} a call)")


def kernel_b_forms():
    """Since the last reset: kernel B's calls, the kernel launches and the
    device→host reads they issued (one cooperative launch and one read of
    the stats a call)."""
    from bpldenoising_tpu_torch.solvers import hypergrad_cuda
    reads = hypergrad_cuda.host_reads
    return dict(calls=hypergrad_cuda.launches,
                kernel_launches=hypergrad_cuda.device_ops - reads,
                host_reads=reads, device_ops=hypergrad_cuda.device_ops)


def say_kernel_b_forms(forms):
    calls = max(forms["calls"], 1)
    say(f"  kernel B: {forms['calls']} calls, {forms['kernel_launches']} "
        f"kernel launches, {forms['host_reads']} host reads "
        f"({forms['device_ops']} device operations, "
        f"{forms['device_ops'] / calls:.1f} a call)")


def kernel_b_cooperative(forms):
    """Every kernel-B call ran one cooperative launch and one read."""
    return forms["calls"] == forms["kernel_launches"] == forms["host_reads"]


def kernel_b_call(fn):
    """One kernel-B call: → (its result, (kernel launches, host reads)),
    required to be (1, 1)."""
    from bpldenoising_tpu_torch.solvers import hypergrad_cuda as hc
    calls, ops, reads = hc.launches, hc.device_ops, hc.host_reads
    out = fn()
    reads = hc.host_reads - reads
    launched = hc.device_ops - ops - reads
    require(hc.launches - calls == 1 and launched == 1 and reads == 1,
            f"kernel B call: {launched} kernel launches, {reads} host "
            "reads (want 1 and 1)")
    return out, (launched, reads)


def b_digits(grads, p):
    """Kernel B's gradients (or the gradient maps' sums) and ‖p‖ with
    every digit."""
    g = [repr(float(x if x.ndim == 0 else x.double().sum())) for x in grads]
    return (f"grad{'' if grads[0].ndim == 0 else ' map sums'} "
            f"[{', '.join(g)}], |p| {float(p.double().norm())!r}")


def read_launches():
    return {name: mod.launches for name, mod in launch_counters().items()}


def on_device(res, like):
    """A learn's reconstruction (a host array) as a tensor beside ``like``."""
    import torch
    return torch.as_tensor(res.u).to(like.device)


def cg_log(res):
    """(adjoint-CG iterations summed over the logged evaluations, the
    evaluations whose CG stopped at its cap) from ``res.state.log``."""
    log = res.state.log
    return (int(sum(e.adjoint_cg_iters for e in log)),
            sum(1 for e in log if e.adjoint_cg_converged < 0.5))


def tgv_learn_kwargs():
    return dict(dataset_name="faces_train", num_samples=10,
                method="tr_fused", dtype="float32", maxiter=20, tol=1e-5,
                inner_maxiter=5000, inner_tol=3e-6, check_every=100)


def phase_tgv_learn(utrue, timed):
    import torch
    from bpldenoising_tpu_torch.experiments.tgv import \
        scalar_bilevel_tgv_learn
    from bpldenoising_tpu_torch.metrics import psnr

    kw = tgv_learn_kwargs()
    scalar_bilevel_tgv_learn(device="cuda", **kw)          # warm-up
    reset_launches()
    with watch_tgv() as calls:
        res, wall_ms = timed(lambda: scalar_bilevel_tgv_learn(device="cuda",
                                                              **kw))
    launches = read_launches()
    alpha = [float(v) for v in res.x]
    rel = [abs(a - r) / r for a, r in zip(alpha, TGV_ALPHA)]
    mean_psnr = float(torch.mean(psnr(utrue, on_device(res, utrue))))
    cost = float(res.cost)
    cg, capped = cg_log(res)
    say(f"  alpha {alpha[0]:.6f}, {alpha[1]:.6f} |d| "
        f"{abs(alpha[0] - TGV_ALPHA[0]):.2e}, "
        f"{abs(alpha[1] - TGV_ALPHA[1]):.2e} rel {rel[0]:.2e}, {rel[1]:.2e} "
        f"(gate {TGV_ALPHA_GATE_REL:g}, band {TGV_ALPHA_BAND_REL:g}: "
        f"{'in' if max(rel) <= TGV_ALPHA_BAND_REL else 'out'}); PSNR "
        f"{mean_psnr:.4f} dB; cost {cost:.4f}; {res.iterations} outer its; "
        f"adjoint CG {cg} its over the logged evaluations, unconverged "
        f"(capped) in {capped} of {res.iterations}")
    say(f"  wall {wall_ms:.1f} ms (CUDA events, after one warm-up run); "
        f"launches {launches}")
    forms = cp_forms(calls, "TGV learn", "TGV²")
    require(launches["tgv"] > 0, f"TGV learn launched {launches}")
    require(max(rel) <= TGV_ALPHA_GATE_REL, f"TGV alpha {alpha}")
    require(abs(mean_psnr - TGV_PSNR) <= TGV_PSNR_GATE,
            f"TGV mean PSNR {mean_psnr}")
    require(abs(cost - TGV_COST) <= TGV_COST_GATE_REL * TGV_COST,
            f"TGV final cost {cost}")
    return dict(alpha=alpha, alpha_rel_err=rel, mean_psnr_db=mean_psnr,
                final_cost=cost, outer_iterations=res.iterations,
                adjoint_cg_iters=cg, wall_ms=wall_ms, launches=launches,
                kernel_calls=forms)


def phase_tgv_patch_learn(utrue, timed):
    import numpy as np
    import torch
    from bpldenoising_tpu_torch.experiments.tgv import \
        patch_bilevel_tgv_learn
    from bpldenoising_tpu_torch.metrics import psnr

    kw = tgv_learn_kwargs()
    reset_launches()
    with watch_tgv() as calls:
        res, wall_ms = timed(lambda: patch_bilevel_tgv_learn(device="cuda",
                                                             **kw))
    launches = read_launches()
    mean_psnr = float(torch.mean(psnr(utrue, on_device(res, utrue))))
    cost = float(res.cost)
    np.set_printoptions(precision=5)
    say(f"  alpha1 grid {res.x[..., 0].tolist()} (reference "
        f"{[list(r) for r in TGV_PATCH_A1]})")
    say(f"  alpha0 grid {res.x[..., 1].tolist()} (reference "
        f"{[list(r) for r in TGV_PATCH_A0]})")
    say(f"  PSNR {mean_psnr:.4f} dB; cost {cost:.4f}; {res.iterations} "
        f"outer its; adjoint CG {cg_log(res)[0]} its; wall "
        f"{wall_ms:.1f} ms; launches {launches}")
    forms = cp_forms(calls, "patch TGV learn", "TGV²")
    require(launches["tgv"] > 0, f"patch TGV learn launched {launches}")
    require(abs(mean_psnr - TGV_PATCH_PSNR) <= TGV_PSNR_GATE,
            f"patch TGV mean PSNR {mean_psnr}")
    require(abs(cost - TGV_PATCH_COST) <= TGV_COST_GATE_REL * TGV_PATCH_COST,
            f"patch TGV final cost {cost}")
    return dict(alpha=res.x.tolist(), mean_psnr_db=mean_psnr,
                final_cost=cost, outer_iterations=res.iterations,
                wall_ms=wall_ms, launches=launches, kernel_calls=forms)


@contextlib.contextmanager
def watch_calls(mod, iters_at):
    """Record every call of the CP kernel wrapper ``mod`` (``tvl1_cuda``,
    ``tgv_cuda``, ``vtv_cuda``) inside the ``with`` block: → the list of
    calls, each its iterations (item ``iters_at`` of ``mod._launch``'s
    result), device operations, whether it ran the cluster form or the
    tile form, its tol and check_every."""
    calls = []
    real = mod._launch

    def watched(*args, **kw):
        ops, cl = mod.device_ops, mod.cluster_calls
        tiled = getattr(mod, "tiled_calls", 0)
        out = real(*args, **kw)
        calls.append(dict(iters=out[iters_at], ops=mod.device_ops - ops,
                          cluster=mod.cluster_calls - cl,
                          tiled=getattr(mod, "tiled_calls", 0) - tiled,
                          tol=kw["tol"], check_every=kw["check_every"]))
        return out

    mod._launch = watched
    try:
        yield calls
    finally:
        mod._launch = real


def watch_tvl1():
    from bpldenoising_tpu_torch.solvers import tvl1_cuda
    return watch_calls(tvl1_cuda, 2)


def watch_tgv():
    from bpldenoising_tpu_torch.solvers import tgv_cuda
    return watch_calls(tgv_cuda, 3)


def watch_vtv():
    from bpldenoising_tpu_torch.solvers import vtv_cuda
    return watch_calls(vtv_cuda, 2)


def cp_forms(calls, label, kernel="TV-L1", cluster=True, chunk_ops=4,
             table=0, tiled=False):
    """Print and require the CP kernel calls of ``watch_calls``: each in
    the cluster form, with ``table`` device operations (the VTV kernel's
    copy of its step table: 1) and 1 more without tol, at most
    ``chunk_ops`` a chunk and one copy with it (``cluster`` False: each in
    the two-launch form, 2 an iteration, ``chunk_ops`` a chunk and one
    copy; with ``tiled`` each in the TGV² tile form, at most one launch an
    iteration, 3 a chunk and four copies); beside them what the
    two-launch form would issue (2 an iteration, ``chunk_ops`` a chunk).
    → the totals."""
    chunks = [-(-c["iters"] // c["check_every"]) if c["tol"] is not None
              else 0 for c in calls]
    out = dict(calls=len(calls), cluster=sum(c["cluster"] for c in calls),
               tiled=sum(c["tiled"] for c in calls),
               iterations=sum(c["iters"] for c in calls), chunks=sum(chunks),
               device_ops=sum(c["ops"] for c in calls),
               two_launch_rule=sum(2 * c["iters"] + chunk_ops * n
                                   for c, n in zip(calls, chunks)))
    say(f"  {label}: {kernel} kernel {out['calls']} calls, {out['cluster']} "
        f"in the cluster form, "
        + (f"{out['tiled']} in the tile form, " if out["tiled"] else "")
        + f"{out['iterations']} iterations in "
        f"{out['chunks']} early-stop chunks, {out['device_ops']} device "
        f"operations (two-launch form, 2 an iteration and {chunk_ops} a "
        f"chunk: {out['two_launch_rule']})")
    if cluster:
        bad = [c for c, n in zip(calls, chunks) if not c["cluster"]
               or c["ops"] > table + (chunk_ops * n + 1
                                      if c["tol"] is not None else 1)]
    elif tiled:
        bad = [c for c, n in zip(calls, chunks) if c["cluster"]
               or not c["tiled"] or c["ops"] > c["iters"] + 4 * n + 4]
    else:
        bad = [c for c, n in zip(calls, chunks) if c["cluster"] or c["tiled"]
               or c["ops"] > 2 * c["iters"] + chunk_ops * n + 1]
    form = "cluster" if cluster else "tile" if tiled else "two-launch"
    require(calls and not bad, f"{label}: {kernel} kernel calls off the "
            f"{form} form's count: {bad or 'no call'}")
    return out


def tvl1_solve_pair(huber, f, a, state0, timed, **kw):
    """The TV-L1 kernel and its plain version on the same inputs: each
    ((u, y, iters), ms)."""
    import torch
    from bpldenoising_tpu_torch.solvers import tvl1_cuda
    from bpldenoising_tpu_torch.solvers.tvl1 import _tvl1_loop, step_sizes
    from bpldenoising_tpu_torch.solvers.tvl1_huber import _tvl1_huber_loop

    tau, sigma = step_sizes(0.99, 0.99, f.dtype)
    hub = dict(gamma_d=100.0, gamma_r=1000.0) if huber else {}

    def kernel():
        if huber:
            u, (_, y) = tvl1_cuda.tvl1_huber_denoise_cuda(
                f, a, state0=state0, return_dual=True, **hub, **kw)
            return u, y, tvl1_cuda.last_iters
        u, (_, y), it = tvl1_cuda.tvl1_denoise_cuda(
            f, a, state0=state0, return_dual=True, **kw)
        return u, y, it

    loop = _tvl1_huber_loop if huber else _tvl1_loop
    k_out, k_ms = timed(kernel)
    p_out, p_ms = timed(lambda: loop(
        f, torch.as_tensor(a, dtype=f.dtype), state0, tau=tau, sigma=sigma,
        **hub, **kw))
    return k_out, k_ms, p_out, p_ms


def phase_tvl1(f, timed, *, maxiter=2000, tol=1e-6, check_every=100):
    """The TV-L1 kernel against its plain versions (float32): the Huber
    form at 1 × 128² (scalar and map α: cold fixed budget, cold with early
    stop and state, warm from that state at a nudged weight; a constant map
    against the scalar run), the plain form at 1 × 128² (10,000 its) and
    64 × 128² (2000 its).  Everything is compared and printed before the
    phase fails.  Returns the stats of both forms."""
    import torch
    from bpldenoising_tpu_torch.ops import PatchOp
    from bpldenoising_tpu_torch.solvers import tvl1_cuda

    dt, dev = f.dtype, f.device
    pop = PatchOp((2, 2), tuple(f.shape[-2:]))
    grid = torch.tensor(TVL1_PATCH_GRID, dtype=dt)
    weights = {"scalar": (1.9, 1.05 * 1.9),
               "map": (pop.apply(grid).to(dev),
                       pop.apply(1.05 * grid).to(dev))}
    faults = []
    worst = {"huber": 0.0, "plain": 0.0}

    def check(form, label, k_out, p_out, ce):
        errs = (max_abs(k_out[0], p_out[0]), max_abs(k_out[1], p_out[1]))
        worst[form] = max(worst[form], *errs)
        if errs[0] > TOL_TVL1_U_F32 or errs[1] > TOL_TVL1_Y_F32:
            faults.append(f"{label}: max|du| {errs[0]}, max|dy| {errs[1]}")
        if abs(k_out[2] - p_out[2]) > ce:
            faults.append(f"{label}: iterations {k_out[2]} vs {p_out[2]}")
        return (f"iters {k_out[2]}/{p_out[2]}, max|du| {errs[0]:.2e}, "
                f"max|dy| {errs[1]:.2e}")

    tvl1_cuda.tvl1_huber_denoise_cuda(f, 1.9, maxiter=10)   # warm-up
    out = {}
    for kind, (a, a_warm) in weights.items():
        k, k_ms, p, p_ms = tvl1_solve_pair(True, f, a, None, timed,
                                           maxiter=maxiter, tol=None,
                                           check_every=check_every)
        msg = check("huber", f"huber {kind} cold", k, p, 0)
        say(f"  Huber {kind} cold {maxiter} it: {msg}; kernel {k_ms:.2f} "
            f"ms, plain {p_ms:.2f} ms")
        out[kind] = dict(ms=k_ms, plain_ms=p_ms, iters=maxiter, u=k[0])
        k, k_ms, p, p_ms = tvl1_solve_pair(True, f, a, None, timed,
                                           maxiter=maxiter, tol=tol,
                                           check_every=check_every)
        msg = check("huber", f"huber {kind} early stop", k, p, check_every)
        say(f"  Huber {kind} cold tol {tol:g}: {msg}; kernel {k_ms:.2f} ms, "
            f"plain {p_ms:.2f} ms")
        k, k_ms, p, p_ms = tvl1_solve_pair(True, f, a_warm, p[:2], timed,
                                           maxiter=maxiter, tol=tol,
                                           check_every=check_every)
        msg = check("huber", f"huber {kind} warm", k, p, check_every)
        say(f"  Huber {kind} warm tol {tol:g} at 1.05 alpha: {msg}; kernel "
            f"{k_ms:.2f} ms, plain {p_ms:.2f} ms")
    const = torch.full(tuple(f.shape[-2:]), 1.9, dtype=dt, device=dev)
    cu = tvl1_cuda.tvl1_huber_denoise_cuda(f, const, maxiter=maxiter)
    same = bool(torch.equal(cu, out["scalar"]["u"]))
    say(f"  Huber constant map == scalar alpha: {same}")
    if not same:
        faults.append("a constant map differs from the scalar weight")
    huber = dict(ms=out["scalar"]["ms"], plain_ms=out["scalar"]["plain_ms"],
                 iters=maxiter)

    plain = {}
    for key, img, iters in (("single", f, 10000),
                            ("batch64", f.repeat(64, 1, 1).contiguous(),
                             2000)):
        label = "x".join(str(d) for d in img.shape)
        tvl1_cuda.tvl1_denoise_cuda(img, TVL1_DENOISE_ALPHA, maxiter=5)
        k, k_ms, p, p_ms = tvl1_solve_pair(False, img, TVL1_DENOISE_ALPHA,
                                           None, timed, maxiter=iters,
                                           tol=None, check_every=500)
        msg = check("plain", f"plain {label}", k, p, 0)
        say(f"  plain TV-L1 {label}, alpha {TVL1_DENOISE_ALPHA}, {iters} it: "
            f"{msg}; kernel {k_ms:.2f} ms, plain {p_ms:.2f} ms")
        plain[key] = dict(ms=k_ms, plain_ms=p_ms, iters=iters,
                          pixels=img.numel())
    say(f"  TV-L1 tolerances: u {TOL_TVL1_U_F32:g}, y {TOL_TVL1_Y_F32:g} "
        f"(absolute)")
    require(not faults, "TV-L1 kernel disagrees with plain: "
            + "; ".join(faults))
    return (dict(huber, max_abs_err=worst["huber"]),
            dict(plain, max_abs_err=worst["plain"]))


def phase_tvl1_f64(torch, device):
    """Both forms of the TV-L1 kernel in float64 at 2 × 32²: cold with early
    stop (scalar α), cold fixed budget (map α), warm from the first
    state."""
    f64 = torch.float64
    gen = torch.Generator().manual_seed(2)
    yy, xx = torch.meshgrid(torch.arange(32, dtype=f64),
                            torch.arange(32, dtype=f64), indexing="ij")
    clean = torch.stack([0.2 + 0.6 * (((xx - 16) ** 2 + (yy - 16) ** 2)
                                      < 110).to(f64),
                         0.3 + 0.4 * (xx > 10).to(f64)])
    hit = torch.rand(clean.shape, generator=gen, dtype=f64) < 0.2
    salt = (torch.rand(clean.shape, generator=gen, dtype=f64) < 0.5).to(f64)
    f = torch.where(hit, salt, clean).to(device)
    amap = (0.5 + torch.rand((32, 32), generator=gen, dtype=f64)).to(device)
    errs, its = [], []
    for huber in (True, False):
        first = None
        for a, warm, kw in ((0.8, False, dict(maxiter=3000, tol=1e-5,
                                               check_every=50)),
                            (amap, False, dict(maxiter=1000, tol=None,
                                               check_every=50)),
                            (0.85, True, dict(maxiter=3000, tol=1e-5,
                                              check_every=50))):
            k, _, p, _ = tvl1_solve_pair(huber, f, a, first if warm else None,
                                         lambda fn: (fn(), 0.0), **kw)
            first = first or p[:2]
            errs.append(max(rel_err(k[0], p[0]), rel_err(k[1], p[1])))
            its.append((k[2], p[2]))
    say(f"  TV-L1 float64 2x32x32 (Huber, then plain): rel err "
        f"{['%.2e' % e for e in errs]}, iters {its} (tol {TOL_F64_REL:g})")
    require(all(kit == pit for kit, pit in its),
            f"float64 TV-L1: iterations {its}")
    require(max(errs) <= TOL_F64_REL, f"float64 TV-L1 rel err {errs}")


def tvl1_learn_kwargs():
    return dict(dataset_name="circle_sp", method="tr_fused",
                dtype="float32", maxiter=15, tol=1e-5, delta0=0.1,
                inner_maxiter=2000, inner_tol=1e-6, check_every=100)


def phase_tvl1_learn(utrue, noisy, timed):
    """The scalar TV-L1 learn through its entry point, then TVL1Denoise,
    each with the launch counters reset just before and read just after."""
    import torch
    from bpldenoising_tpu_torch.experiments.tvl1 import (
        TVL1Denoise, scalar_bilevel_tvl1_learn)
    from bpldenoising_tpu_torch.metrics import psnr

    kw = dict(tvl1_learn_kwargs(), alpha0=TVL1_X0)
    scalar_bilevel_tvl1_learn(device="cuda", **kw)          # warm-up
    reset_launches()
    with watch_tvl1() as calls:
        res, wall_ms = timed(lambda: scalar_bilevel_tvl1_learn(
            device="cuda", **kw))
    launches = read_launches()
    alpha = float(res.x)
    rel = abs(alpha - TVL1_ALPHA) / TVL1_ALPHA
    mean_psnr = float(torch.mean(psnr(utrue, on_device(res, utrue))))
    cost = float(res.cost)
    cg, capped = cg_log(res)
    say(f"  alpha {alpha:.7f} rel {rel:.2e} (gate {TVL1_ALPHA_GATE_REL:g}, "
        f"band {TVL1_ALPHA_BAND_REL:g}: "
        f"{'in' if rel <= TVL1_ALPHA_BAND_REL else 'out'}); PSNR "
        f"{mean_psnr:.5f} dB; cost {cost:.6f}; {res.iterations} outer its; "
        f"adjoint CG {cg} its over the logged evaluations, unconverged "
        f"(capped) in {capped} of {res.iterations}")
    say(f"  wall {wall_ms:.1f} ms (CUDA events, after one warm-up run); "
        f"launches {launches}")
    forms = cp_forms(calls, "TV-L1 learn")

    TVL1Denoise(noisy, TVL1_DENOISE_ALPHA, maxiter=5, device="cuda")
    reset_launches()
    with watch_tvl1() as calls:
        u, denoise_ms = timed(lambda: TVL1Denoise(noisy, TVL1_DENOISE_ALPHA,
                                                  device="cuda"))
    denoise_launches = read_launches()
    denoise_psnr = float(torch.mean(psnr(utrue, u)))
    say(f"  TVL1Denoise(alpha {TVL1_DENOISE_ALPHA}, 10000 it): PSNR "
        f"{denoise_psnr:.5f} dB (reference {TVL1_DENOISE_PSNR}); "
        f"{denoise_ms:.1f} ms; launches {denoise_launches}")
    denoise_forms = cp_forms(calls, "TVL1Denoise")
    require(launches["tvl1"] > 0, f"TV-L1 learn launched {launches}")
    require(denoise_launches["tvl1"] > 0,
            f"TVL1Denoise launched {denoise_launches}")
    require(rel <= TVL1_ALPHA_GATE_REL, f"TV-L1 alpha {alpha}")
    require(abs(cost - TVL1_COST) <= TVL1_COST_GATE_REL * TVL1_COST,
            f"TV-L1 final cost {cost}")
    require(abs(mean_psnr - TVL1_PSNR) <= TVL1_PSNR_GATE,
            f"TV-L1 mean PSNR {mean_psnr}")
    require(tuple(u.shape) == tuple(noisy.shape)
            and bool(torch.isfinite(u).all()), "TVL1Denoise output")
    require(abs(denoise_psnr - TVL1_DENOISE_PSNR) <= TVL1_DENOISE_PSNR_GATE,
            f"TVL1Denoise PSNR {denoise_psnr}")
    return dict(alpha=alpha, alpha_rel_err=rel, mean_psnr_db=mean_psnr,
                final_cost=cost, outer_iterations=res.iterations,
                adjoint_cg_iters=cg, wall_ms=wall_ms,
                launches=launches, kernel_calls=forms, denoise=dict(
                    alpha=TVL1_DENOISE_ALPHA, psnr_db=denoise_psnr,
                    ms=denoise_ms, launches=denoise_launches,
                    kernel_calls=denoise_forms))


def phase_tvl1_patch_learn(utrue, timed):
    import torch
    from bpldenoising_tpu_torch.experiments.tvl1 import \
        patch_bilevel_tvl1_learn
    from bpldenoising_tpu_torch.metrics import psnr

    kw = tvl1_learn_kwargs()
    reset_launches()
    with watch_tvl1() as calls:
        res, wall_ms = timed(lambda: patch_bilevel_tvl1_learn(device="cuda",
                                                              **kw))
    launches = read_launches()
    mean_psnr = float(torch.mean(psnr(utrue, on_device(res, utrue))))
    cost = float(res.cost)
    cg = cg_log(res)[0]
    grid_rel = max(abs(float(v) - r) / r for v, r in zip(
        res.x.reshape(-1), (x for row in TVL1_PATCH_GRID for x in row)))
    say(f"  alpha grid {res.x.tolist()} (reference "
        f"{[list(r) for r in TVL1_PATCH_GRID]}, max rel {grid_rel:.2e}, "
        f"not gated)")
    say(f"  PSNR {mean_psnr:.5f} dB; cost {cost:.6f}; {res.iterations} "
        f"outer its; adjoint CG {cg} its; wall "
        f"{wall_ms:.1f} ms; launches {launches}")
    forms = cp_forms(calls, "patch TV-L1 learn")
    require(launches["tvl1"] > 0, f"patch TV-L1 learn launched {launches}")
    require(abs(cost - TVL1_PATCH_COST)
            <= TVL1_PATCH_COST_GATE_REL * TVL1_PATCH_COST,
            f"patch TV-L1 final cost {cost}")
    require(abs(mean_psnr - TVL1_PATCH_PSNR) <= TVL1_PATCH_PSNR_GATE,
            f"patch TV-L1 mean PSNR {mean_psnr}")
    return dict(alpha=res.x.tolist(), alpha_max_rel_err=grid_rel,
                mean_psnr_db=mean_psnr, final_cost=cost,
                outer_iterations=res.iterations, adjoint_cg_iters=cg,
                wall_ms=wall_ms, launches=launches, kernel_calls=forms)


def vtv_solve_pair(f, a, state0, timed, **kw):
    """The VTV kernel and its plain version on the same inputs: each
    ((u, y, iters), ms)."""
    import torch
    from bpldenoising_tpu_torch.models import vtv_model
    from bpldenoising_tpu_torch.solvers import vtv_cuda
    from bpldenoising_tpu_torch.solvers.pdps import _denoise_pdps_impl

    def kernel():
        u, (y,), it = vtv_cuda.vtv_denoise_pdps_cuda(
            f, (a,), state0, return_dual=True, **kw)
        return u, y, it

    def plain():
        u, (y,), it = _denoise_pdps_impl(
            f, (torch.as_tensor(a, dtype=f.dtype),), state0,
            model=vtv_model(), tau0=5.0, sigma0=0.99 / 5.0, gamma=1.0,
            accel=True, return_dual=True, **kw)
        return u, y, it

    k_out, k_ms = timed(kernel)
    p_out, p_ms = timed(plain)
    return k_out, k_ms, p_out, p_ms


def phase_vtv(f, timed, *, maxiter=5000, tol=1e-5, check_every=100):
    """The VTV kernel against its plain version (float32), scalar and map
    α: cold fixed budget, cold with early stop and state, warm from that
    state at a nudged weight; a constant map against the scalar run.
    Everything is compared and printed before the phase fails.  Returns
    the stats of the scalar cold call."""
    import torch
    from bpldenoising_tpu_torch.ops import PatchOp
    from bpldenoising_tpu_torch.solvers import vtv_cuda

    dt, dev = f.dtype, f.device
    pop = PatchOp((2, 2), tuple(f.shape[-2:]))
    grid = torch.tensor(VTV_PATCH_GRID, dtype=dt)
    weights = {"scalar": (0.165, 1.05 * 0.165),
               "map": (pop.apply(grid).to(dev),
                       pop.apply(1.05 * grid).to(dev))}
    faults = []
    worst = 0.0
    out = {}

    def check(label, k_out, p_out, ce):
        nonlocal worst
        errs = (max_abs(k_out[0], p_out[0]), max_abs(k_out[1], p_out[1]))
        worst = max(worst, *errs)
        if errs[0] > TOL_VTV_U_F32 or errs[1] > TOL_VTV_Y_F32:
            faults.append(f"{label}: max|du| {errs[0]}, max|dy| {errs[1]}")
        if abs(k_out[2] - p_out[2]) > ce:
            faults.append(f"{label}: iterations {k_out[2]} vs {p_out[2]}")
        return (f"iters {k_out[2]}/{p_out[2]}, max|du| {errs[0]:.2e}, "
                f"max|dy| {errs[1]:.2e}")

    vtv_cuda.vtv_denoise_pdps_cuda(f, (0.165,), maxiter=10)   # warm-up
    for kind, (a, a_warm) in weights.items():
        k, k_ms, p, p_ms = vtv_solve_pair(f, a, None, timed, maxiter=maxiter,
                                          tol=None, check_every=check_every)
        say(f"  VTV {kind} cold {maxiter} it: "
            f"{check(f'{kind} cold', k, p, 0)}; kernel {k_ms:.2f} ms, "
            f"plain {p_ms:.2f} ms")
        out[kind] = dict(ms=k_ms, plain_ms=p_ms, iters=maxiter, u=k[0])
        k, k_ms, p, p_ms = vtv_solve_pair(f, a, None, timed, maxiter=maxiter,
                                          tol=tol, check_every=check_every)
        msg = check(f"{kind} early stop", k, p, check_every)
        say(f"  VTV {kind} cold tol {tol:g}: {msg}; kernel {k_ms:.2f} ms, "
            f"plain {p_ms:.2f} ms")
        state = (p[0], (p[1],))
        k, k_ms, p, p_ms = vtv_solve_pair(f, a_warm, state, timed,
                                          maxiter=maxiter, tol=tol,
                                          check_every=check_every)
        msg = check(f"{kind} warm", k, p, check_every)
        say(f"  VTV {kind} warm tol {tol:g} at 1.05 alpha: {msg}; kernel "
            f"{k_ms:.2f} ms, plain {p_ms:.2f} ms")
    const = torch.full(tuple(f.shape[-2:]), 0.165, dtype=dt, device=dev)
    cu = vtv_cuda.vtv_denoise_pdps_cuda(f, (const,), maxiter=maxiter)
    same = bool(torch.equal(cu, out["scalar"]["u"]))
    say(f"  VTV constant map == scalar alpha: {same}; tolerances u "
        f"{TOL_VTV_U_F32:g}, y {TOL_VTV_Y_F32:g} (absolute); early-stop "
        f"counts equal or one check apart")
    if not same:
        faults.append("a constant map differs from the scalar weight")
    require(not faults, "VTV kernel disagrees with plain: "
            + "; ".join(faults))
    sc = out["scalar"]
    return dict(ms=sc["ms"], plain_ms=sc["plain_ms"], iters=maxiter,
                max_abs_err=worst)


def phase_vtv_f64(torch, device):
    """The VTV kernel in float64 at 2 × 3 × 32²: cold with early stop
    (scalar α), cold fixed budget (map α), warm from the first state."""
    f64 = torch.float64
    gen = torch.Generator().manual_seed(3)
    yy, xx = torch.meshgrid(torch.arange(32, dtype=f64),
                            torch.arange(32, dtype=f64), indexing="ij")
    disc = (((xx - 14) ** 2 + (yy - 17) ** 2) < 90).to(f64)
    clean = torch.stack([torch.stack([0.2 + 0.6 * disc, 0.7 - 0.4 * disc,
                                      0.3 + 0.3 * (xx > 20).to(f64)]),
                         torch.stack([0.5 * (yy > 10).to(f64), 0.4 + 0.0 * xx,
                                      0.9 - 0.5 * disc])])
    f = (clean + 0.1 * torch.randn(clean.shape, generator=gen,
                                   dtype=f64)).to(device)
    amap = (0.08 + 0.1 * torch.rand((32, 32), generator=gen,
                                    dtype=f64)).to(device)
    errs, its = [], []
    first = None
    for a, warm, kw in ((0.12, False, dict(maxiter=3000, tol=1e-6,
                                            check_every=50)),
                        (amap, False, dict(maxiter=1000, tol=None,
                                           check_every=50)),
                        (0.126, True, dict(maxiter=3000, tol=1e-6,
                                           check_every=50))):
        state0 = (first[0], (first[1],)) if warm else None
        k, _, p, _ = vtv_solve_pair(f, a, state0, lambda fn: (fn(), 0.0),
                                    **kw)
        first = first or p[:2]
        errs.append(max(rel_err(k[0], p[0]), rel_err(k[1], p[1])))
        its.append((k[2], p[2]))
    say(f"  VTV float64 2x3x32x32: rel err {['%.2e' % e for e in errs]}, "
        f"iters {its} (tol {TOL_F64_REL:g})")
    require(all(kit == pit for kit, pit in its),
            f"float64 VTV: iterations {its}")
    require(max(errs) <= TOL_F64_REL, f"float64 VTV rel err {errs}")


def phase_vtv_large(f, timed):
    """The VTV kernel at 1 × 3 × 256² (the first color image tiled 2 × 2),
    1000 iterations: its bands do not fit in shared memory
    (``vtv_plan``), so the two-launch form runs; against its plain
    version, timed, with its bound (f in; u and y out)."""
    from bpldenoising_tpu_torch.solvers import vtv_cuda
    from bpldenoising_tpu_torch.solvers.cluster_plan import vtv_plan

    img = f[:1].repeat(1, 1, 2, 2).contiguous()
    kw = dict(maxiter=1000, tol=None, check_every=100)
    launches0 = vtv_cuda.launches
    vtv_cuda.vtv_denoise_pdps_cuda(img, (0.165,), maxiter=5)
    ops0 = vtv_cuda.device_ops
    k, k_ms, p, p_ms = vtv_solve_pair(img, 0.165, None, timed, **kw)
    ops = vtv_cuda.device_ops - ops0
    launches = vtv_cuda.launches - launches0
    errs = (max_abs(k[0], p[0]), max_abs(k[1], p[1]))
    plan = vtv_plan(*img.shape[-2:], img.shape[-3], img.element_size())
    say(f"  VTV 1x3x256x256, 1000 it: max|du| {errs[0]:.2e}, max|dy| "
        f"{errs[1]:.2e}; kernel {k_ms:.2f} ms, plain {p_ms:.2f} ms; plan: "
        f"cluster {plan.cluster}, {plan.rows} rows a CTA, resident "
        f"{plan.resident} (the two-launch form when not); {ops} device "
        f"operations")
    require(errs[0] <= TOL_VTV_U_F32 and errs[1] <= TOL_VTV_Y_F32,
            f"VTV 256^2 kernel disagrees with plain: {errs}")
    require(launches > 0 and not plan.resident,
            f"VTV 256^2: {launches} launches, plan {plan}")
    bound, by = bound_ms(4 * img.numel() * img.element_size(),
                         VTV_OPS_PER_PLANE_PIXEL_ITER * img.numel() * 1000)
    return dict(ms=k_ms, plain_ms=p_ms, max_abs_err=max(errs),
                bound_ms=bound, bound_by=by, launches=launches,
                device_ops=ops)


def vtv_learn_kwargs():
    return dict(dataset_name="color_disks", num_samples=6,
                method="tr_fused", dtype="float32", inner_maxiter=5000,
                inner_tol=1e-5, check_every=100)


def phase_vtv_learn(utrue, timed):
    """The scalar VTV learn through its entry point, once to warm up and
    once timed, with the launch counters reset just before and read just
    after the timed run."""
    import torch
    from bpldenoising_tpu_torch.experiments.vtv import \
        scalar_bilevel_vtv_learn
    from bpldenoising_tpu_torch.metrics import psnr

    kw = vtv_learn_kwargs()
    scalar_bilevel_vtv_learn(device="cuda", **kw)          # warm-up
    reset_launches()
    with watch_vtv() as calls:
        res, wall_ms = timed(lambda: scalar_bilevel_vtv_learn(
            device="cuda", **kw))
    launches = read_launches()
    alpha = float(res.x)
    rel = abs(alpha - VTV_ALPHA) / VTV_ALPHA
    mean_psnr = float(torch.mean(psnr(utrue, on_device(res, utrue))))
    cost = float(res.cost)
    cg, capped = cg_log(res)
    say(f"  alpha {alpha:.8f} rel {rel:.2e} (gate {VTV_ALPHA_GATE_REL:g}, "
        f"band {VTV_ALPHA_BAND_REL:g}: "
        f"{'in' if rel <= VTV_ALPHA_BAND_REL else 'out'}); PSNR "
        f"{mean_psnr:.6f} dB; cost {cost:.6f}; {res.iterations} outer its; "
        f"adjoint CG {cg} its over the logged evaluations (reference "
        f"{VTV_CG_ITERS}), unconverged (capped) in {capped} of "
        f"{res.iterations}")
    say(f"  wall {wall_ms:.1f} ms (CUDA events, after one warm-up run); "
        f"launches {launches}")
    forms = cp_forms(calls, "VTV learn", "VTV", chunk_ops=3, table=1)
    require(launches["vtv"] > 0, f"VTV learn launched {launches}")
    require(rel <= VTV_ALPHA_GATE_REL, f"VTV alpha {alpha}")
    require(abs(cost - VTV_COST) <= VTV_COST_GATE_REL * VTV_COST,
            f"VTV final cost {cost}")
    require(abs(mean_psnr - VTV_PSNR) <= VTV_PSNR_GATE,
            f"VTV mean PSNR {mean_psnr}")
    return dict(alpha=alpha, alpha_rel_err=rel, mean_psnr_db=mean_psnr,
                final_cost=cost, outer_iterations=res.iterations,
                adjoint_cg_iters=cg, wall_ms=wall_ms, launches=launches,
                kernel_calls=forms)


def phase_vtv_patch_learn(utrue, noisy, timed):
    """The patch VTV learn, then VTVDenoise, each with the launch counters
    reset just before and read just after."""
    import torch
    from bpldenoising_tpu_torch.experiments.vtv import (
        VTVDenoise, patch_bilevel_vtv_learn)
    from bpldenoising_tpu_torch.metrics import psnr

    kw = vtv_learn_kwargs()
    reset_launches()
    with watch_vtv() as calls:
        res, wall_ms = timed(lambda: patch_bilevel_vtv_learn(device="cuda",
                                                             **kw))
    launches = read_launches()
    mean_psnr = float(torch.mean(psnr(utrue, on_device(res, utrue))))
    cost = float(res.cost)
    cg = cg_log(res)[0]
    grid_rel = max(abs(float(v) - r) / r for v, r in zip(
        res.x.reshape(-1), (x for row in VTV_PATCH_GRID for x in row)))
    say(f"  alpha grid {res.x.tolist()} (reference "
        f"{[list(r) for r in VTV_PATCH_GRID]}, max rel {grid_rel:.2e}, "
        f"not gated)")
    say(f"  PSNR {mean_psnr:.6f} dB; cost {cost:.6f}; {res.iterations} "
        f"outer its; adjoint CG {cg} its (reference {VTV_PATCH_CG_ITERS}); "
        f"wall {wall_ms:.1f} ms; launches {launches}")
    forms = cp_forms(calls, "patch VTV learn", "VTV", chunk_ops=3, table=1)

    VTVDenoise(noisy, VTV_DENOISE_ALPHA, maxiter=5, device="cuda")
    reset_launches()
    with watch_vtv() as calls:
        u, denoise_ms = timed(lambda: VTVDenoise(noisy, VTV_DENOISE_ALPHA,
                                                 device="cuda"))
    denoise_launches = read_launches()
    denoise_psnr = float(torch.mean(psnr(utrue, u)))
    say(f"  VTVDenoise(alpha {VTV_DENOISE_ALPHA}, 10000 it): PSNR "
        f"{denoise_psnr:.6f} dB (reference {VTV_DENOISE_PSNR}); "
        f"{denoise_ms:.1f} ms; launches {denoise_launches}")
    denoise_forms = cp_forms(calls, "VTVDenoise", "VTV", chunk_ops=3,
                             table=1)
    require(launches["vtv"] > 0, f"patch VTV learn launched {launches}")
    require(abs(cost - VTV_PATCH_COST)
            <= VTV_PATCH_COST_GATE_REL * VTV_PATCH_COST,
            f"patch VTV final cost {cost}")
    require(abs(mean_psnr - VTV_PATCH_PSNR) <= VTV_PATCH_PSNR_GATE,
            f"patch VTV mean PSNR {mean_psnr}")
    require(denoise_launches["vtv"] > 0,
            f"VTVDenoise launched {denoise_launches}")
    require(tuple(u.shape) == tuple(noisy.shape)
            and bool(torch.isfinite(u).all()), "VTVDenoise output")
    require(abs(denoise_psnr - VTV_DENOISE_PSNR) <= VTV_DENOISE_PSNR_GATE,
            f"VTVDenoise PSNR {denoise_psnr}")
    return dict(alpha=res.x.tolist(), alpha_max_rel_err=grid_rel,
                mean_psnr_db=mean_psnr, final_cost=cost,
                outer_iterations=res.iterations, adjoint_cg_iters=cg,
                wall_ms=wall_ms, launches=launches, kernel_calls=forms,
                denoise=dict(alpha=VTV_DENOISE_ALPHA, psnr_db=denoise_psnr,
                             ms=denoise_ms, launches=denoise_launches,
                             kernel_calls=denoise_forms))


def sl_setup(model, x0, like, **extra):
    """The arguments of the single-loop segment entry for ``model`` and
    the parameter ``x0`` at the images ``like``: (x0 tensor, kwargs) with
    bench.py's settings (40 PD and 10 CG steps per outer step, lr 0.05)."""
    import torch
    from bpldenoising_tpu_torch.bilevel.first_order import _param_layout
    x0 = torch.as_tensor(x0, dtype=like.dtype).to(like.device)
    pop, shape = _param_layout(model, x0, like.shape[-2:])
    kw = dict(model=model, n_inner=40, n_adj=10, pop=pop, param_shape=shape,
              lr=0.05, gamma=1e4, tau0=5.0, sigma0=0.99 / 5.0, beta1=0.9,
              beta2=0.999, eps=1e-8)
    kw.update(extra)
    return x0, kw


def sl_errors(k, p):
    """Kernel result k against plain result p (SingleLoopResults): α
    relative, u absolute, the α and cost trajectories relative, ‖g‖
    relative to its largest value, and the largest absolute error of the
    outputs (α, u, α trajectory)."""
    errs = dict(alpha=rel_err(k.alpha, p.alpha), u=max_abs(k.u, p.u),
                alpha_traj=rel_err(k.alpha_trajectory, p.alpha_trajectory),
                cost_traj=rel_err(k.cost_trajectory, p.cost_trajectory),
                gnorm_traj=rel_err(k.gnorm_trajectory, p.gnorm_trajectory))
    worst = max(max_abs(k.alpha, p.alpha), errs["u"],
                max_abs(k.alpha_trajectory, p.alpha_trajectory))
    return errs, worst


def sl_faults(label, errs):
    bad = (max(errs["alpha"], errs["alpha_traj"], errs["cost_traj"])
           > TOL_SL_REL_F32 or errs["u"] > TOL_SL_U_F32
           or errs["gnorm_traj"] > TOL_SL_GNORM_F32)
    return [f"{label}: {errs}"] if bad else []


def sl_fmt(errs):
    return ", ".join(f"{k} {v:.2e}" for k, v in errs.items())


def phase_sl_stencils(torch, device):
    """The backward and centred stencils (and the forward one) of
    csrc/common.cuh against ops/grad.py in float64, before any learner
    runs: gradient, adjoint and Gram diagonal, on shapes with edges of 2
    and 3 pixels and at 3 × 128²."""
    from bpldenoising_tpu_torch.bilevel import first_order_cuda as fc
    from bpldenoising_tpu_torch.ops import (BwdGradientOp, CenteredGradientOp,
                                            FwdGradientOp)
    gen = torch.Generator().manual_seed(0)
    worst = {}
    for shape in ((2, 17, 23), (1, 3, 2), (1, 2, 5), (3, 128, 128)):
        x = torch.randn(shape, generator=gen, dtype=torch.float64).to(device)
        q = torch.randn((shape[0], 2) + shape[1:], generator=gen,
                        dtype=torch.float64).to(device)
        for kind, op in enumerate((FwdGradientOp(), BwdGradientOp(),
                                   CenteredGradientOp())):
            for what, got, want in (
                    ("grad", fc.stencil_cuda(kind, "grad", x), op.apply(x)),
                    ("adjoint", fc.stencil_cuda(kind, "adjoint", q),
                     op.apply_adjoint(q)),
                    ("gram", fc.stencil_cuda(kind, "gram", q),
                     op.gram_diag(q))):
                key = f"{type(op).__name__[:-10]} {what}"
                worst[key] = max(worst.get(key, 0.0), max_abs(got, want))
    say("  float64 stencils vs ops/grad.py, max abs: " + ", ".join(
        f"{k} {v:.1e}" for k, v in worst.items())
        + f" (tol {TOL_SL_STENCIL_F64:g})")
    require(max(worst.values()) <= TOL_SL_STENCIL_F64,
            f"single-loop stencils disagree with ops/grad.py: {worst}")


def phase_sl_kernel(utrue, f, timed):
    """The learner against its plain version at the flagship width:
    scalar TV, 300 outer steps, classic CG, both timed; then 30 outer
    steps with the classic and the pipelined CG."""
    from bpldenoising_tpu_torch.bilevel import first_order as fo
    from bpldenoising_tpu_torch.bilevel.first_order import _single_loop_plain
    from bpldenoising_tpu_torch.models import tv_model

    from bpldenoising_tpu_torch.bilevel import first_order_cuda as fc

    x0, kw = sl_setup(tv_model(), 0.1, f)
    fo._single_loop_impl(utrue, f, x0, outer=2, **kw)     # warm-up
    fc.kernel_launches = 0
    k, k_ms = timed(lambda: fo._single_loop_impl(utrue, f, x0,
                                                 outer=300, **kw))
    per_step = (fc.kernel_launches - 1) / 300     # one slc_begin a segment
    p, p_ms = timed(lambda: _single_loop_plain(utrue, f, x0, outer=300,
                                               **kw))
    errs, worst = sl_errors(k, p)
    faults = sl_faults("classic 300", errs)
    say(f"  scalar TV 300/40/10 classic: alpha {float(k.alpha):.8f} / "
        f"{float(p.alpha):.8f}; {sl_fmt(errs)}; kernel {k_ms:.2f} ms "
        f"({fc.kernel_launches} kernel launches, {per_step:g} per outer "
        f"step), plain {p_ms:.2f} ms")
    require(per_step == fc.launches_per_step(10),
            f"single-loop launches per outer step {per_step}")
    kc, kc_ms = timed(lambda: fo._single_loop_impl(utrue, f, x0,
                                                   outer=30, **kw))
    kw_p = dict(kw, cg_variant="pipelined")
    kp, kp_ms = timed(lambda: fo._single_loop_impl(utrue, f, x0,
                                                   outer=30, **kw_p))
    pp, pp_ms = timed(lambda: _single_loop_plain(utrue, f, x0, outer=30,
                                                 **kw_p))
    errs_p, worst_p = sl_errors(kp, pp)
    faults += sl_faults("pipelined 30", errs_p)
    say(f"  scalar TV 30 outer: classic kernel {kc_ms:.2f} ms, pipelined "
        f"kernel {kp_ms:.2f} ms (plain {pp_ms:.2f} ms); pipelined vs "
        f"plain: {sl_fmt(errs_p)}")
    say(f"  float32 tolerances: alpha and trajectories {TOL_SL_REL_F32:g} "
        f"relative, u {TOL_SL_U_F32:g} absolute, gnorm {TOL_SL_GNORM_F32:g}")
    require(not faults, "single-loop kernel disagrees with plain: "
            + "; ".join(faults))
    return dict(ms=k_ms, plain_ms=p_ms, max_abs_err=max(worst, worst_p),
                pixels=f.numel(), outer=300, errors=errs,
                launches_per_step=per_step,
                classic_30_ms=kc_ms, pipelined_30_ms=kp_ms,
                pipelined_30_plain_ms=pp_ms, pipelined_errors=errs_p)


def sl_disc_stack(torch, device, B, M, N, dtype, seed=0):
    """(utrue, f): B copies of a disc on M × N under noise of σ 0.1, from
    a seed (at 3 × 16² the stack phase 18 has always used)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.arange(M), np.arange(N), indexing="ij")
    disc = ((xx - N / 2) ** 2 + (yy - M / 2) ** 2
            < (min(M, N) / 3) ** 2).astype(float)
    clean = np.stack([disc] * B)
    noisy = clean + 0.1 * rng.standard_normal(clean.shape)
    return (torch.as_tensor(clean, dtype=dtype).to(device),
            torch.as_tensor(noisy, dtype=dtype).to(device))


def phase_sl_f64(torch, device):
    """The learner against its plain version in float64 on disc stacks
    whose rows do not divide evenly over the PD cluster's 8 CTAs (16, 20
    and 22 rows: the last CTAs own two rows, one or none) and whose
    columns do not fill a CG tile: the four parameterizations, both CG
    forms, and two images per tile (a short last tile at three images),
    at 1e-9 relative; then the same kernel with its bands in global
    memory (1×512² float32 scalar TV, 1×256² float64 K = 3), at the
    float32 and float64 tolerances."""
    import numpy as np
    from bpldenoising_tpu_torch.bilevel import first_order as fo
    from bpldenoising_tpu_torch.bilevel import first_order_cuda as fc
    from bpldenoising_tpu_torch.bilevel.first_order import _single_loop_plain
    from bpldenoising_tpu_torch.models import sumregs_model, tv_model

    errs = {}
    for shape in ((3, 16, 16), (3, 20, 16), (2, 22, 24)):
        ut, f = sl_disc_stack(torch, device, *shape, torch.float64)
        for name, model, x0 in (
                ("tv scalar", tv_model(), 0.02),
                ("tv patch", tv_model(), np.full((2, 2), 0.02)),
                ("sumregs vector", sumregs_model(), [0.02, 0.015, 0.01]),
                ("sumregs patch", sumregs_model(),
                 np.full((2, 2, 3), 0.02))):
            for variant, tile_b in (("classic", None), ("pipelined", None),
                                    ("classic", 2)):
                x0t, kw = sl_setup(model, x0, f, n_inner=8, n_adj=4,
                                   cg_variant=variant, tile_b=tile_b)
                k = fo._single_loop_impl(ut, f, x0t, outer=20, **kw)
                p = _single_loop_plain(ut, f, x0t, outer=20, **kw)
                e, _ = sl_errors(k, p)
                e["u"] = rel_err(k.u, p.u)
                label = (f"{'x'.join(map(str, shape))} {name} {variant}"
                         + (" tile 2" if tile_b else ""))
                errs[label] = max(e.values())
    say("  float64, 20 outer: max rel err " + ", ".join(
        f"{k} {v:.1e}" for k, v in errs.items())
        + f" (tol {TOL_F64_REL:g})")
    require(max(errs.values()) <= TOL_F64_REL,
            f"float64 single-loop rel err {errs}")
    faults = []
    for dtype, shape, model, x0 in (
            (torch.float32, (1, 512, 512), tv_model(), 0.02),
            (torch.float64, (1, 256, 256), sumregs_model(),
             [0.02, 0.015, 0.01])):
        ut, f = sl_disc_stack(torch, device, *shape, dtype)
        plan = fc.pd_plan(shape[1], shape[2], model.K, f.element_size())
        x0t, kw = sl_setup(model, x0, f, n_inner=8, n_adj=4)
        k = fo._single_loop_impl(ut, f, x0t, outer=3, **kw)
        p = _single_loop_plain(ut, f, x0t, outer=3, **kw)
        e, _ = sl_errors(k, p)
        label = f"{'x'.join(map(str, shape))} {str(dtype)[6:]}"
        say(f"  global bands {label} ({plan}), 3 outer: {sl_fmt(e)}")
        if dtype == torch.float64:
            e["u"] = rel_err(k.u, p.u)
            if max(e.values()) > TOL_F64_REL or plan.resident:
                faults.append(f"{label}: {e}")
        else:
            faults += sl_faults(label, e) + (
                [f"{label} is resident"] if plan.resident else [])
    require(not faults, "global-band single-loop kernel: "
            + "; ".join(faults))


def phase_sl_learn(utrue, timed, sumregs):
    """The single-loop learn through its entry point, once to warm up and
    once timed, counters reset just before and read just after; the
    plain loop must not run."""
    import numpy as np
    import torch
    from bpldenoising_tpu_torch.bilevel import first_order as fo
    from bpldenoising_tpu_torch.experiments import api
    from bpldenoising_tpu_torch.metrics import psnr

    if sumregs:
        learn, ref_alpha = api.scalar_bilevel_sumregs_learn, SL_SUMREGS_ALPHA
        ref_cost, ref_psnr = SL_SUMREGS_COST, SL_SUMREGS_PSNR
    else:
        learn, ref_alpha = api.scalar_bilevel_tv_learn, (SL_TV_ALPHA,)
        ref_cost, ref_psnr = SL_TV_COST, SL_TV_PSNR
    kw = dict(dataset_name="faces_train", num_samples=10, dtype="float32",
              method="single_loop")
    learn(device="cuda", **kw)                             # warm-up
    plain_calls = []
    saved = fo._single_loop_plain

    def watched(*a, **k):
        plain_calls.append(1)
        return saved(*a, **k)

    fo._single_loop_plain = watched
    try:
        reset_launches()
        res, wall_ms = timed(lambda: learn(device="cuda", **kw))
        launches = read_launches()
    finally:
        fo._single_loop_plain = saved
    alpha = np.atleast_1d(np.asarray(res.x, dtype=np.float64))
    rel = max(abs(a - r) / r for a, r in zip(alpha, ref_alpha))
    mean_psnr = float(torch.mean(psnr(utrue, on_device(res, utrue))))
    cost = float(res.cost)
    times = [e.time for e in res.state.log]
    say(f"  alpha {alpha.tolist()} (reference {list(ref_alpha)}) max rel "
        f"{rel:.2e} (gate {SL_ALPHA_GATE_REL:g}, band {SL_ALPHA_BAND_REL:g}"
        f": {'in' if rel <= SL_ALPHA_BAND_REL else 'out'}); PSNR "
        f"{mean_psnr:.6f} dB (reference {ref_psnr:.6f}); cost {cost:.6f} "
        f"(reference {ref_cost:.6f}); g_norm {res.g_norm:.6g}; "
        f"{res.iterations} outer steps, {len(times)} log entries, last "
        f"segment end {times[-1]:.4f} s")
    say(f"  wall {wall_ms:.1f} ms through the entry point (CUDA events, "
        f"after one warm-up run; PNG load included); launches {launches}; "
        f"plain-loop calls {len(plain_calls)}")
    require(launches["single_loop"] > 0 and not plain_calls,
            f"single-loop learn: launches {launches}, plain calls "
            f"{len(plain_calls)}")
    require(len(times) == 20 and all(t > 0 for t in times)
            and times == sorted(times), f"state.log times {times}")
    require(rel <= SL_ALPHA_GATE_REL, f"single-loop alpha {alpha.tolist()}")
    require(abs(mean_psnr - ref_psnr) <= SL_PSNR_GATE,
            f"single-loop mean PSNR {mean_psnr}")
    require(abs(cost - ref_cost) <= SL_COST_GATE_REL * ref_cost,
            f"single-loop final cost {cost}")
    return dict(alpha=alpha.tolist(), alpha_rel_err=rel,
                mean_psnr_db=mean_psnr, final_cost=cost,
                g_norm=res.g_norm, outer_iterations=res.iterations,
                wall_ms=wall_ms, launches=launches)


def phase_sl_tiled(utrue, f, timed):
    """Batch 64 with K = 3 (the faces stack tiled and cut to 64, as
    bench.py:407-418): one tile and tile_b = 8 against the plain version
    at 30 outer steps, then single_loop_cuda_tiled timed at 300 outer
    steps with one tile and with tile_b = 8, counters reset just before
    and read just after the tile_b = 8 run."""
    from bpldenoising_tpu_torch.bilevel import first_order as fo
    from bpldenoising_tpu_torch.bilevel import first_order_cuda as fc
    from bpldenoising_tpu_torch.bilevel.first_order import _single_loop_plain
    from bpldenoising_tpu_torch.models import sumregs_model

    model = sumregs_model()
    big_u = utrue.repeat(7, 1, 1)[:64].contiguous()
    big_f = f.repeat(7, 1, 1)[:64].contiguous()
    out = dict(pixels=big_f.numel())
    faults = []
    worst = 0.0
    for label, tile_b in (("one tile", None), ("tile_b 8", 8)):
        x0, kw = sl_setup(model, [1e-3, 1e-3, 1e-3], big_f, tile_b=tile_b)
        k, k_ms = timed(lambda: fo._single_loop_impl(
            big_u, big_f, x0, outer=30, **kw))
        p, p_ms = timed(lambda: _single_loop_plain(big_u, big_f, x0,
                                                   outer=30, **kw))
        errs, w = sl_errors(k, p)
        faults += sl_faults(label, errs)
        say(f"  {'x'.join(map(str, big_f.shape))} K=3 {label}, 30 outer: "
            f"{sl_fmt(errs)}; kernel "
            f"{k_ms:.2f} ms, plain {p_ms:.2f} ms")
        if tile_b:
            worst = w
            out.update(ms=k_ms, plain_ms=p_ms, outer=30, errors=errs)
    require(not faults, "single-loop kernel disagrees with plain at batch "
            "64: " + "; ".join(faults))
    args = (big_u, big_f, [1e-3, 1e-3, 1e-3], model)
    _, one_ms = timed(lambda: fc.single_loop_cuda_tiled(*args, outer=300))
    reset_launches()
    fc.kernel_launches = 0
    (x, _, traj), t8_ms = timed(lambda: fc.single_loop_cuda_tiled(
        *args, outer=300, tile_b=8))
    launches = read_launches()
    per_step = (fc.kernel_launches - 1) / 300
    say(f"  single_loop_cuda_tiled 300 outer: one tile {one_ms:.1f} ms, "
        f"tile_b 8 {t8_ms:.1f} ms (alpha {x.tolist()}, final cost "
        f"{float(traj[-1]):.4f}); launches {launches}, "
        f"{fc.kernel_launches} kernel launches ({per_step:g} per outer "
        f"step)")
    require(launches["single_loop"] > 0, f"tiled learner launched "
            f"{launches}")
    require(per_step == fc.launches_per_step(10),
            f"tiled learner launches per outer step {per_step}")
    out.update(max_abs_err=worst, launches=launches["single_loop"],
               one_tile_300_ms=one_ms, tile8_300_ms=t8_ms,
               launches_per_step=per_step)
    return out


def slx_family(name):
    """The family's modules and settings: the learn module, its plain
    loop's name, the CUDA module, the library call, the entry point, the
    bench shape's dataset and parameter, the library call's arguments and
    the entry point's settings."""
    import numpy as np
    from bpldenoising_tpu_torch.bilevel import (
        first_order_tgv, first_order_tgv_cuda, first_order_tvl1,
        first_order_tvl1_cuda, first_order_vtv, first_order_vtv_cuda)
    from bpldenoising_tpu_torch.experiments import tgv, tvl1, vtv
    if name == "tgv":
        return dict(mod=first_order_tgv, cuda=first_order_tgv_cuda,
                    call=first_order_tgv_cuda.single_loop_tgv_cuda,
                    entry=tgv.scalar_bilevel_tgv_learn,
                    data=("faces_train_128_10", False),
                    x0=np.array([0.05, 0.05]),
                    patch=np.stack([np.full((2, 2), 0.05),
                                    np.full((2, 2), 0.08)], axis=-1),
                    small=np.array([0.05, 0.08]),
                    kw=dict(lr=0.02, gamma=1e-4, tau0=0.99, sigma0=0.99),
                    call_kw=dict(lr=0.02),
                    entry_kw=dict(dataset_name="faces_train",
                                  num_samples=10))
    if name == "tvl1":
        return dict(mod=first_order_tvl1, cuda=first_order_tvl1_cuda,
                    call=first_order_tvl1_cuda.single_loop_tvl1_cuda,
                    entry=tvl1.scalar_bilevel_tvl1_learn,
                    data=("circle_sp_128_20", False), x0=np.array(0.4),
                    patch=np.full((2, 2), 0.4), small=np.array(0.4),
                    kw=dict(lr=0.05, gamma_d=100.0, gamma_r=1000.0,
                            tau0=0.99, sigma0=0.99, clip=1.0),
                    call_kw={}, entry_kw=dict(dataset_name="circle_sp"))
    return dict(mod=first_order_vtv, cuda=first_order_vtv_cuda,
                call=first_order_vtv_cuda.single_loop_vtv_cuda,
                entry=vtv.scalar_bilevel_vtv_learn,
                data=("color_disks_128_10", True), x0=np.array(0.05),
                patch=np.full((2, 2), 0.05), small=np.array(0.05),
                kw=dict(lr=0.05, gamma=1e-4, tau0=5.0, sigma0=0.99 / 5.0),
                call_kw={}, entry_kw=dict(dataset_name="color_disks",
                                          num_samples=6))


def slx_args(fam, name, utrue, f, x0, **extra):
    """(utrue, f, x0, kwargs) of the family's segment entry and plain loop
    at 40 CP and 10 CG steps per outer step and the family's defaults."""
    mod = fam["mod"]
    utrue, f, x0, pop, shape, _ = mod._prepare(utrue, f, x0)
    kw = dict(n_inner=40, n_adj=10, pop=pop, param_shape=shape, beta1=0.9,
              beta2=0.999, eps=1e-8, **fam["kw"])
    kw.update(extra)
    return utrue, f, x0, kw


def slx_small_data(name, B, n=24, seed=0):
    """B float64 test pairs of n² (C = 3 for VTV), made with numpy from a
    seed: a ramp with a step and a disc, under Gaussian noise (TGV², VTV)
    or 20% salt and pepper (TV-L1)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    ramp = 0.04 * xx + (yy > n // 2)
    disc = ((xx - n / 2) ** 2 + (yy - n / 2) ** 2 < (n / 3) ** 2) + 0.02 * yy
    clean = np.stack([ramp, disc]).astype(np.float64)[:B]
    if name == "vtv":
        clean = np.stack([clean, clean[:, ::-1], 0.5 * clean], axis=1)
    if name != "tvl1":
        return clean, clean + 0.1 * rng.standard_normal(clean.shape)
    noisy = clean.copy()
    hits = rng.uniform(size=clean.shape)
    noisy[hits < 0.1] = 1.0
    noisy[hits > 0.9] = 0.0
    return clean, noisy


def slx_kernel_launches(fam):
    """The kernel launches the family's wrapper has counted (rows 11, 12
    and 13 each count theirs: ``kernel_launches``)."""
    return fam["cuda"].kernel_launches


def slx_steps(fam, name, before, segments, outer, label, n_adj=10):
    """The learner's kernel launches per outer step since ``before`` (one
    more a segment), its CP plan and CG block form, printed and required to
    be launches_per_step(n_adj)."""
    cuda = fam["cuda"]
    per_step = (cuda.kernel_launches - before - segments) / outer
    want = cuda.launches_per_step(n_adj)
    say(f"{label} kernel launches per outer step {per_step:g} (want "
        f"{want}); CP plan {cuda.last_plan}; CG slots {cuda.last_cg_slots}")
    require(per_step == want,
            f"single-loop {name}: {per_step} kernel launches per outer step")
    plan = cuda.last_plan
    return dict(launches_per_step=per_step,
                plan=dict(cluster=plan.cluster, rows=plan.rows,
                          smem=plan.smem, resident=plan.resident,
                          cg_slots=cuda.last_cg_slots))


def phase_slx_tgv_bands(torch, device):
    """(a) continued for TGV²: float64 against the plain version where the
    CP bands split unevenly over the cluster (3×20×16 at 8 CTAs of 3 rows:
    the 7th owns two, the 8th none; 2×22×24: the 8th owns one row;
    3×120×128 at 16 CTAs of 8 rows, the 16th none, whose CG blocks take
    the same 256 pixels of the three planes), the (2,) weight and the 2×2
    patch, 20 outer steps of 10 CP and 4 CG steps;
    then 1×256², whose float64 bands do not fit in shared memory (the
    global-band path), 3 outer steps; at TOL_F64_REL, with 4 + 2·4 kernel
    launches per outer step."""
    fam = slx_family("tgv")
    mod, cuda = fam["mod"], fam["cuda"]
    errs, faults = {}, []
    for shape, outer, params in (
            ((3, 20, 16), 20, ("small", "patch")),
            ((2, 22, 24), 20, ("small", "patch")),
            ((3, 120, 128), 20, ("small", "patch")),
            ((1, 256, 256), 3, ("small",))):
        ut, f = sl_disc_stack(torch, device, *shape, torch.float64)
        for which in params:
            u0, f0, x0, kw = slx_args(fam, "tgv", ut, f, fam[which],
                                      n_inner=10, n_adj=4)
            before = cuda.kernel_launches
            k = mod._single_loop_tgv_impl(u0, f0, x0, outer=outer, **kw)
            per_step = (cuda.kernel_launches - before - 1) / outer
            plan = cuda.last_plan
            p = mod._single_loop_tgv_plain(u0, f0, x0, outer=outer, **kw)
            e, _ = sl_errors(k, p)
            e["u"] = rel_err(k.u, p.u)
            label = (f"{'x'.join(map(str, shape))} "
                     f"{'vector' if which == 'small' else which}")
            errs[label] = max(e.values())
            say(f"  {label}: plan {plan}, CG slots {cuda.last_cg_slots}, "
                f"{per_step:g} kernel launches per outer step, max rel err "
                f"{errs[label]:.1e}")
            if (errs[label] > TOL_F64_REL
                    or per_step != cuda.launches_per_step(4)
                    or plan.resident != (shape[1] < 256)):
                faults.append(f"{label}: {e}, {plan}, {per_step}")
    require(not faults, "float64 single-loop TGV bands: " + "; ".join(faults))


def kernel_order_tree(v):
    """(..., 256) → (...): common.cuh's block_sum tree (sh[t] += sh[t + s]
    for s = 128, 64, …, 1)."""
    s = v.shape[-1] // 2
    while s >= 1:
        v = v[..., :s] + v[..., s:2 * s]
        s //= 2
    return v[..., 0]


def _by_256(x):
    """(..., n) → (..., ⌈n/256⌉, 256), zero-padded."""
    import torch
    k = -(-x.shape[-1] // 256)
    x = torch.nn.functional.pad(x, (0, 256 * k - x.shape[-1]))
    return x.reshape(x.shape[:-1] + (k, 256))


def kernel_order_sum(x):
    """(..., n) → (...): an image's inner product in the single-loop
    learners' order: one block_sum per 256 consecutive elements
    (slx_partial), then the partials summed by kernel_order_strided
    (slx_image_sum)."""
    parts = kernel_order_tree(_by_256(x))
    return kernel_order_strided(parts)


def kernel_order_strided(x):
    """(..., n) → (...): thread t adds x[t], x[t + 256], … in turn from 0,
    then one block_sum (slx_image_sum's partials, slx_pull_adam's
    pixels)."""
    import torch
    v = _by_256(x)
    c = torch.zeros_like(v[..., 0, :])
    for k in range(v.shape[-2]):
        c = c + v[..., k, :]
    return kernel_order_tree(c)


def _cg_kernel_order(A, b, x0=None, *, tol, maxiter, M, item_ndim):
    """solvers/krylov.py::cg_batched's classic Jacobi CG for tol = 0 (no
    stop test), its per-image inner products in the kernels' order."""
    import torch

    def vdot(p, q):
        return kernel_order_sum((p * q).flatten(-item_ndim))

    def bc(a):
        return a[(...,) + (None,) * item_ndim]

    def nz(a):
        return torch.where(a == 0, torch.ones_like(a), a)

    x = x0
    r = b - A(x)
    z = M(r)
    d = z
    rz = vdot(r, z)
    for _ in range(int(maxiter)):
        hd = A(d)
        a = rz / nz(vdot(d, hd))
        x = x + bc(a) * d
        r = r - bc(a) * hd
        z = M(r)
        rz_new = vdot(r, z)
        beta = rz_new / nz(rz)
        d = z + bc(beta) * d
        rz = rz_new
    return x, None


def _pullback_kernel_order(pop, g_map):
    """bilevel/first_order.py::pullback in the kernels' order: the (B, M,
    N) map summed over the batch in order, then each parameter entry's
    pixels in row-major order (slx_pull_adam; divisible patch grids)."""
    acc = g_map[0]
    for b in range(1, g_map.shape[0]):
        acc = acc + g_map[b]
    if pop is None:
        return kernel_order_strided(acc.reshape(-1))
    (m, n), (M, N) = pop.size_in, acc.shape
    blocks = acc.reshape(m, M // m, n, N // n).transpose(1, 2)
    return kernel_order_strided(blocks.reshape(m, n, -1))


@contextlib.contextmanager
def kernel_order(mod):
    """Within the block, the single-loop plain loop of ``mod`` (the TV-L1
    family's) takes its CG inner products and its pullback in the
    kernel's order, every other operation as it is: the kernel's function
    to the bit, where the learner's discrete switches (|u − f| = 1/γ_d,
    |∇u| = 1/γ_r) and its near-singular first adjoint systems turn a
    reordered sum into any difference at all (the cost and ‖g‖, read only,
    keep torch.sum's order)."""
    real = mod.cg_batched, mod.pullback
    mod.cg_batched, mod.pullback = _cg_kernel_order, _pullback_kernel_order
    try:
        yield
    finally:
        mod.cg_batched, mod.pullback = real


def slx_sp_stack(torch, device, B, M, N, seed=0):
    """(utrue, f) in float64: a disc on M × N rolled by b rows in image b,
    under 20% salt-and-pepper noise, made with numpy from a seed."""
    import numpy as np
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.arange(M), np.arange(N), indexing="ij")
    disc = ((xx - N / 2) ** 2 + (yy - M / 2) ** 2
            < (min(M, N) / 3) ** 2).astype(float) + 0.02 * yy
    clean = np.stack([np.roll(disc, b, axis=0) for b in range(B)])
    noisy = clean.copy()
    hits = rng.uniform(size=clean.shape)
    noisy[hits < 0.1] = 1.0
    noisy[hits > 0.9] = 0.0
    return (torch.as_tensor(clean).to(device),
            torch.as_tensor(noisy).to(device))


def phase_slx_tvl1_bands(torch, device):
    """(a) continued for TV-L1: float64 against the plain version where the
    CP bands split unevenly over the cluster (3×20×16 at 8 CTAs of 3 rows:
    the 7th owns two, the 8th none; 2×22×24: the 8th owns one row;
    3×120×128 at 16 CTAs of 8 rows, the 16th none), the scalar weight and
    the 2×2 patch grid, 20 outer steps of 10 CP and 4 CG steps; then
    1×512², whose float64 bands do not fit in shared memory (the
    global-band path), 3 outer steps; with 4 + 2·4 kernel launches per
    outer step and the CP plan printed.  Against the plain version with
    its sums in the kernel's order (``kernel_order``): α, u and the α
    trajectory bit-identical, the cost and ‖g‖ trajectories at
    TOL_F64_REL.  On these noisy stacks the plain version as it is lands
    elsewhere (printed): the learner's discrete switches and its
    near-singular first adjoint systems amplify a reordered sum (measured
    on an H100: ‖g‖ up to 1.0 relative, α up to 0.34)."""
    fam = slx_family("tvl1")
    mod, cuda = fam["mod"], fam["cuda"]
    errs, faults = {}, []
    for shape, outer, params in (
            ((3, 20, 16), 20, ("small", "patch")),
            ((2, 22, 24), 20, ("small", "patch")),
            ((3, 120, 128), 20, ("small", "patch")),
            ((1, 512, 512), 3, ("small",))):
        ut, f = slx_sp_stack(torch, device, *shape)
        for which in params:
            u0, f0, x0, kw = slx_args(fam, "tvl1", ut, f, fam[which],
                                      n_inner=10, n_adj=4)
            before = cuda.kernel_launches
            k = mod._single_loop_tvl1_impl(u0, f0, x0, outer=outer, **kw)
            per_step = (cuda.kernel_launches - before - 1) / outer
            plan = cuda.last_plan
            with kernel_order(mod):
                p = mod._single_loop_tvl1_plain(u0, f0, x0, outer=outer,
                                                **kw)
            as_is = mod._single_loop_tvl1_plain(u0, f0, x0, outer=outer,
                                                **kw)
            e, _ = sl_errors(k, p)
            bits = all(torch.equal(getattr(k, n), getattr(p, n)) for n in (
                "alpha", "u", "alpha_trajectory"))
            label = (f"{'x'.join(map(str, shape))} "
                     f"{'scalar' if which == 'small' else which}")
            errs[label] = max(e["cost_traj"], e["gnorm_traj"])
            e_is, _ = sl_errors(k, as_is)
            e_is["u"] = rel_err(k.u, as_is.u)
            say(f"  {label}: plan {plan}, CG slots {cuda.last_cg_slots}, "
                f"{per_step:g} kernel launches per outer step; against the "
                f"plain version in the kernel's order: alpha, u, alpha_traj "
                f"{'bit-identical' if bits else 'DIFFER'}, cost and gnorm "
                f"{errs[label]:.1e}; against it as it is: max rel err "
                f"{max(e_is.values()):.1e}")
            if (not bits or errs[label] > TOL_F64_REL
                    or per_step != cuda.launches_per_step(4)
                    or plan.resident != (shape[1] < 512)):
                faults.append(f"{label}: {e}, {plan}, {per_step}")
    require(not faults, "float64 single-loop TV-L1 bands: "
            + "; ".join(faults))


def phase_slx_vtv_bands(torch, device):
    """(a) continued for VTV: float64 against the plain version where the
    CP bands split unevenly over the cluster (3×3×20×16 at 8 CTAs of 3
    rows: the 7th owns two, the 8th none; 2×3×22×24: the 8th owns one row;
    3×3×120×128 at 16 CTAs of 8 rows, the 16th none, whose CG blocks take
    the same 256 pixels of the three planes) and with two channels
    (2×2×16×20), the scalar weight and the 2×2 patch grid, 20 outer steps
    of 10 CP and 4 CG steps; then 1×3×256², whose float64 bands do not fit
    in shared memory (the global-band path), 3 outer steps; at
    TOL_F64_REL, with 4 + 2·4 kernel launches per outer step."""
    import numpy as np
    fam = slx_family("vtv")
    mod, cuda = fam["mod"], fam["cuda"]
    errs, faults = {}, []
    for (B, C, M, N), outer, params in (
            ((3, 3, 20, 16), 20, ("small", "patch")),
            ((2, 3, 22, 24), 20, ("small", "patch")),
            ((3, 3, 120, 128), 20, ("small", "patch")),
            ((2, 2, 16, 20), 20, ("small", "patch")),
            ((1, 3, 256, 256), 3, ("small",))):
        ut1, f1 = sl_disc_stack(torch, device, B * C, M, N, torch.float64,
                                seed=C)
        # channel c of image b: the disc scaled by 1 − c/4, rolled b rows
        scale = torch.as_tensor(1.0 - np.arange(C) / 4.0, dtype=torch.float64,
                                device=device).view(1, C, 1, 1)
        ut = torch.stack([torch.roll(t, b, dims=-2) for b, t in
                          enumerate(ut1.view(B, C, M, N))]) * scale
        f = ut + (f1 - ut1).view(B, C, M, N)
        for which in params:
            u0, f0, x0, kw = slx_args(fam, "vtv", ut, f, fam[which],
                                      n_inner=10, n_adj=4)
            before = cuda.kernel_launches
            k = mod._single_loop_vtv_impl(u0, f0, x0, outer=outer, **kw)
            per_step = (cuda.kernel_launches - before - 1) / outer
            plan = cuda.last_plan
            p = mod._single_loop_vtv_plain(u0, f0, x0, outer=outer, **kw)
            e, _ = sl_errors(k, p)
            e["u"] = rel_err(k.u, p.u)
            label = (f"{B}x{C}x{M}x{N} "
                     f"{'scalar' if which == 'small' else which}")
            errs[label] = max(e.values())
            say(f"  {label}: plan {plan}, CG slots {cuda.last_cg_slots}, "
                f"{per_step:g} kernel launches per outer step, max rel err "
                f"{errs[label]:.1e}")
            if (errs[label] > TOL_F64_REL
                    or per_step != cuda.launches_per_step(4)
                    or plan.resident != (M < 256)):
                faults.append(f"{label}: {e}, {plan}, {per_step}")
    require(not faults, "float64 single-loop VTV bands: " + "; ".join(faults))


def phase_slx_f64(torch, device, name):
    """(a) The learner against its plain version in float64: one and two
    images of 24², the scalar (or (2,)) weight and a 2×2 patch grid, 20
    outer steps of 10 CP and 4 CG steps, at TOL_F64_REL relative (or the
    case's TOL_SLX_F64_CASE)."""
    fam = slx_family(name)
    mod = fam["mod"]
    plain = getattr(mod, f"_single_loop_{name}_plain")
    errs = {}
    for B in (1, 2):
        ut_np, f_np = slx_small_data(name, B)
        ut = torch.as_tensor(ut_np).to(device)
        f = torch.as_tensor(f_np).to(device)
        for label, x0 in (("scalar", fam["small"]), ("patch", fam["patch"])):
            u0, f0, x0t, kw = slx_args(fam, name, ut, f, x0, n_inner=10,
                                       n_adj=4)
            impl = getattr(mod, f"_single_loop_{name}_impl")
            before = slx_kernel_launches(fam)
            k = impl(u0, f0, x0t, outer=20, **kw)
            slx_steps(fam, name, before, 1, 20, f"  (a) B{B} {label}",
                      n_adj=4)
            p = plain(u0, f0, x0t, outer=20, **kw)
            e, _ = sl_errors(k, p)
            e["u"] = rel_err(k.u, p.u)
            errs[f"B{B} {label}"] = max(e.values())
    tols = {case: TOL_SLX_F64_CASE.get((name, case), TOL_F64_REL)
            for case in errs}
    say(f"  (a) float64 24x24, 20 outer of 10/4: max rel err " + ", ".join(
        f"{k} {v:.1e} (tol {tols[k]:g})" for k, v in errs.items()))
    require(all(v <= tols[k] for k, v in errs.items()),
            f"float64 single-loop {name} rel err {errs}")


def slx_images(torch, device, name, count=1):
    """The first ``count`` images of the family's bench dataset, float32."""
    from bpldenoising_tpu_torch.data import testdataset
    ds, color = slx_family(name)["data"]
    true_np, noisy_np = testdataset(ds, color=color)
    return (torch.as_tensor(true_np[:count], dtype=torch.float32).to(device),
            torch.as_tensor(noisy_np[:count], dtype=torch.float32).to(device))


def slx_f32_pair(utrue, f, timed, name, label):
    """The learner against its plain version in float32 on (utrue, f), 30
    outer steps of 40 CP and 10 CG steps, at TOL_SLX_REL_F32 / TOL_SL_*."""
    fam = slx_family(name)
    mod = fam["mod"]
    plain = getattr(mod, f"_single_loop_{name}_plain")
    impl = getattr(mod, f"_single_loop_{name}_impl")
    u0, f0, x0, kw = slx_args(fam, name, utrue, f, fam["x0"])
    impl(u0, f0, x0, outer=2, **kw)                        # warm-up
    before = slx_kernel_launches(fam)
    k, k_ms = timed(lambda: impl(u0, f0, x0, outer=30, **kw))
    steps = slx_steps(fam, name, before, 1, 30, f"  {label}")
    p, p_ms = timed(lambda: plain(u0, f0, x0, outer=30, **kw))
    errs, worst = sl_errors(k, p)
    tol = TOL_SLX_REL_F32[name]
    bad = (max(errs["alpha"], errs["alpha_traj"], errs["cost_traj"]) > tol
           or errs["u"] > TOL_SL_U_F32 or errs["gnorm_traj"]
           > TOL_SL_GNORM_F32)
    say(f"  {label} float32 {'x'.join(map(str, f.shape))}, 30 outer: "
        f"{sl_fmt(errs)} (tol: alpha and trajectories {tol:g} relative, "
        f"u {TOL_SL_U_F32:g}, gnorm {TOL_SL_GNORM_F32:g}); kernel "
        f"{k_ms:.2f} ms, plain {p_ms:.2f} ms")
    require(not bad, f"single-loop {name} kernel disagrees with plain at "
            f"{tuple(f.shape)}: {errs}")
    return dict(max_abs_err=worst, errors=errs, ms_30=k_ms, plain_ms=p_ms,
                pixels=f.numel(), **steps)


def phase_slx_f32(torch, device, timed, name):
    """(b) The learner against its plain version in float32 at the bench
    shape (one image), then on the entry point's own stack where it holds
    more (TGV² 10 images, VTV 6): the per-image CG scalars and the
    batch-ordered gradient sums at that batch.  The bench shape's numbers
    are the ``plain_ms`` of its ``kernels`` entry; ``max_abs_err`` is the
    worst of both."""
    utrue, f = slx_images(torch, device, name)
    out = slx_f32_pair(utrue, f, timed, name, "(b)")
    n = int(slx_family(name)["entry_kw"].get("num_samples", 1))
    if n > 1:
        ut_n, f_n = slx_images(torch, device, name, n)
        out["entry_stack"] = slx_f32_pair(ut_n, f_n, timed, name,
                                          "(b) entry point's stack,")
        out["max_abs_err"] = max(out["max_abs_err"],
                                 out["entry_stack"]["max_abs_err"])
    return utrue, f, out


def slx_check(label, alpha, cost, ref, psnr_db=None):
    """Relative errors of α and the cost against a reference (and the
    PSNR's difference); → (dict, line)."""
    rel = max(abs(a - r) / r for a, r in zip(alpha, ref["alpha"]))
    dc = abs(cost - ref["cost"]) / ref["cost"]
    out = dict(alpha=alpha, alpha_rel_err=rel, final_cost=cost,
               cost_rel_err=dc)
    line = (f"{label}: alpha {alpha} (reference {list(ref['alpha'])}) max "
            f"rel {rel:.2e}; cost {cost:.6f} (reference {ref['cost']:.6f}) "
            f"rel {dc:.2e}")
    if psnr_db is not None:
        out.update(mean_psnr_db=psnr_db, psnr_diff_db=psnr_db - ref["psnr"])
        line += (f"; PSNR {psnr_db:.6f} dB (reference {ref['psnr']:.6f})")
    return out, line


def phase_slx_call(utrue, f, timed, name):
    """(c) The library call at bench.py's settings on one image, 300 outer
    steps of 40 CP and 10 CG steps, once to warm up and once timed with
    CUDA events, counters reset just before and read just after."""
    import numpy as np
    fam = slx_family(name)
    kw = dict(outer=300, n_inner=40, n_adj=10, **fam["call_kw"])
    fam["call"](utrue, f, fam["x0"], **kw)                  # warm-up
    reset_launches()
    before = slx_kernel_launches(fam)
    (x, u, traj), ms = timed(lambda: fam["call"](utrue, f, fam["x0"], **kw))
    launches = read_launches()
    steps = slx_steps(fam, name, before, 1, 300, "  (c)")
    alpha = np.atleast_1d(x.double().cpu().numpy()).tolist()
    out, line = slx_check("  (c) library call", alpha, float(traj[-1]),
                          SLX_CALL_REF[name])
    key = f"single_loop_{name}"
    bound, by = slx_bound(name, f.numel(), 300)
    say(f"{line}; {ms:.2f} ms (CUDA events, after one warm-up); launches "
        f"{launches[key]}; bound {bound:.4f} ms ({by})")
    require(launches[key] == 1, f"library call launched {launches}")
    out.update(ms=ms, launches=launches[key], outer=300, bound_ms=bound,
               bound_by=by, **steps)
    return out


def phase_slx_entry(timed, name):
    """(d) The scalar learn through its entry point with
    method="single_loop" on the family's trust-region dataset, once to warm
    up and once timed, counters reset just before and read just after; the
    plain loop must not run.  Gated against the JAX float32 reference."""
    import numpy as np
    import torch
    from bpldenoising_tpu_torch.data import testdataset
    from bpldenoising_tpu_torch.metrics import psnr

    fam = slx_family(name)
    mod = fam["mod"]
    kw = dict(fam["entry_kw"], dtype="float32", method="single_loop")
    fam["entry"](device="cuda", **kw)                      # warm-up
    plain_name = f"_single_loop_{name}_plain"
    saved = getattr(mod, plain_name)
    plain_calls = []

    def watched(*a, **k):
        plain_calls.append(1)
        return saved(*a, **k)

    setattr(mod, plain_name, watched)
    try:
        reset_launches()
        before = slx_kernel_launches(fam)
        res, wall_ms = timed(lambda: fam["entry"](device="cuda", **kw))
        launches = read_launches()
    finally:
        setattr(mod, plain_name, saved)
    key = f"single_loop_{name}"
    steps = slx_steps(fam, name, before, launches[key], res.iterations,
                      "  (d)")
    ds, color = fam["data"]
    true_np, _ = testdataset(ds, color=color)
    n = int(kw.get("num_samples", 1))
    utrue = torch.as_tensor(true_np[:n], dtype=torch.float32)
    mean_psnr = float(torch.mean(psnr(utrue, torch.as_tensor(res.u))))
    alpha = np.atleast_1d(np.asarray(res.x, dtype=np.float64)).tolist()
    out, line = slx_check("  (d) entry point", alpha, float(res.cost),
                          SLX_REF[name], mean_psnr)
    times = [e.time for e in res.state.log]
    say(f"{line}; g_norm {res.g_norm:.6g}; {res.iterations} outer steps, "
        f"{len(times)} log entries (gates: alpha {SLX_GATES[name]['alpha']:g}"
        f" relative, PSNR {SLX_GATES[name]['psnr']:g} dB, cost "
        f"{SLX_GATES[name]['cost']:g} relative)")
    say(f"  wall {wall_ms:.1f} ms (CUDA events, after one warm-up run; PNG "
        f"load included); launches {launches}; plain-loop calls "
        f"{len(plain_calls)}")
    gates = SLX_GATES[name]
    require(launches[key] > 0 and not plain_calls,
            f"single-loop {name} learn: launches {launches}, plain calls "
            f"{len(plain_calls)}")
    require(len(times) == 20 and all(t > 0 for t in times)
            and times == sorted(times), f"state.log times {times}")
    require(out["alpha_rel_err"] <= gates["alpha"],
            f"single-loop {name} alpha {alpha}")
    require(abs(out["psnr_diff_db"]) <= gates["psnr"],
            f"single-loop {name} mean PSNR {mean_psnr}")
    require(out["cost_rel_err"] <= gates["cost"],
            f"single-loop {name} final cost {res.cost}")
    out.update(g_norm=res.g_norm, outer_iterations=res.iterations,
               wall_ms=wall_ms, launches=launches, **steps)
    return out


def phase_slx_entry_f64(name):
    """(e) The scalar learn through its entry point in float64 on the card,
    gated against the JAX package's float64 run at SLX_GATES_F64."""
    import numpy as np
    import torch
    from bpldenoising_tpu_torch.data import testdataset
    from bpldenoising_tpu_torch.metrics import psnr

    fam = slx_family(name)
    kw = dict(fam["entry_kw"], dtype="float64", method="single_loop")
    reset_launches()
    before = slx_kernel_launches(fam)
    res = fam["entry"](device="cuda", **kw)
    launches = read_launches()[f"single_loop_{name}"]
    steps = slx_steps(fam, name, before, launches, res.iterations, "  (e)")
    ds, color = fam["data"]
    true_np, _ = testdataset(ds, color=color)
    n = int(kw.get("num_samples", 1))
    utrue = torch.as_tensor(true_np[:n], dtype=torch.float64)
    mean_psnr = float(torch.mean(psnr(utrue, torch.as_tensor(res.u))))
    alpha = np.atleast_1d(np.asarray(res.x, dtype=np.float64)).tolist()
    out, line = slx_check("  (e) entry point, float64", alpha,
                          float(res.cost), SLX_REF_F64[name], mean_psnr)
    say(f"{line}; launches {launches} (gates: alpha "
        f"{SLX_GATES_F64['alpha']:g} relative, PSNR "
        f"{SLX_GATES_F64['psnr']:g} dB, cost {SLX_GATES_F64['cost']:g} "
        f"relative)")
    require(launches > 0 and np.asarray(res.u).dtype == np.float64,
            f"float64 single-loop {name} learn: launches {launches}")
    require(out["alpha_rel_err"] <= SLX_GATES_F64["alpha"]
            and abs(out["psnr_diff_db"]) <= SLX_GATES_F64["psnr"]
            and out["cost_rel_err"] <= SLX_GATES_F64["cost"],
            f"float64 single-loop {name} learn off its reference: {out}")
    out.update(steps)
    return out


def phases_slx(torch, device, timed, name, first):
    """Phases (a)–(d) of one family, numbered from ``first``."""
    label = {"tgv": "TGV", "tvl1": "TV-L1", "vtv": "VTV"}[name]
    say(f"phase {first} single-loop {label} kernel vs plain, float64")
    phase_slx_f64(torch, device, name)
    if name == "tgv":
        phase_slx_tgv_bands(torch, device)
    if name == "tvl1":
        phase_slx_tvl1_bands(torch, device)
    if name == "vtv":
        phase_slx_vtv_bands(torch, device)
    say(f"phase {first + 1} single-loop {label} kernel vs plain at the "
        f"bench shape and the entry point's, float32")
    utrue, f, stats = phase_slx_f32(torch, device, timed, name)
    say(f"phase {first + 2} single-loop {label} library call, 300/40/10")
    stats["call"] = phase_slx_call(utrue, f, timed, name)
    say(f"phase {first + 3} single-loop {label} learn through its entry "
        f"point (method='single_loop')")
    stats["learn"] = phase_slx_entry(timed, name)
    if name in SLX_REF_F64:
        stats["learn_f64"] = phase_slx_entry_f64(name)
    return stats


def sumregs_weights():
    """Weights of the sum of regularizers near its learned point."""
    return (0.035, 0.032, 0.005), (0.034, 0.041, 0.002)


def random_map(like, seed, lo, hi):
    """A (M, N) weight map, uniform in [lo, hi), made from ``seed``."""
    import torch
    gen = torch.Generator().manual_seed(seed)
    m = lo + (hi - lo) * torch.rand(tuple(like.shape[-2:]), generator=gen,
                                    dtype=torch.float64)
    return m.to(device=like.device, dtype=like.dtype)


def phase_forms_a(f, timed):
    """Kernel A's K = 3 and map forms against plain A at 10 × 128²
    float32: the sum of regularizers and TV with a random (M, N) map, each
    cold 5000 iterations, cold with early stop, warm; then K = 3 at
    1 × 2048², 1000 iterations (row 3's shape)."""
    from bpldenoising_tpu_torch.models import sumregs_model

    a3, a3_warm = sumregs_weights()
    u3, k3 = phase_kernel_a(f, timed, alphas=a3, alphas_warm=a3_warm,
                            model=sumregs_model(), label="A K=3")
    amap = random_map(f, 0, 0.05, 0.1)
    umap, kmap = phase_kernel_a(f, timed, alphas=(amap,),
                                alphas_warm=(0.9 * amap,), label="A map")
    img = f[:1].repeat(1, 16, 16).contiguous()
    big = large_a(img, timed, sumregs_model(), weights(a3, img),
                  "A K=3 1x2048x2048")
    return u3, umap, amap, dict(k3=k3, map=kmap, k3_2048=big)


def phase_forms_b(u3, umap, amap, utrue, timed):
    """Kernel B's K = 3 (scalar weights) and map forms (gradient maps)
    against plain B at 10 × 128² float32, u from phase 34."""
    from bpldenoising_tpu_torch.models import sumregs_model

    k3 = phase_kernel_b(u3, utrue, timed, alphas=sumregs_weights()[0],
                        model=sumregs_model(), label="B K=3")
    maps = phase_kernel_b(umap, utrue, timed, alphas=(amap,),
                          want_maps=True, label="B map")
    return dict(k3=k3, map=maps)


def phase_forms_f64(torch, device):
    """Kernels A and B in their K = 3 and map forms in float64 at 2 × 32²
    against their plain versions, at TOL_F64_REL (phase_f64's images: B
    gets a piecewise-constant image with a ramp, whose systems are well
    conditioned)."""
    from bpldenoising_tpu_torch.models import sumregs_model, tv_model
    from bpldenoising_tpu_torch.solvers import hypergrad_cuda, pdps_cuda
    from bpldenoising_tpu_torch.solvers.hypergrad import (
        HypergradConfig, exact_hypergrad, reg_hypergrad)
    from bpldenoising_tpu_torch.solvers.pdps import _denoise_pdps_impl

    f64 = torch.float64
    gen = torch.Generator().manual_seed(0)
    clean = torch.zeros((2, 32, 32), dtype=f64)
    clean[:, 8:24, 8:24] = 1.0
    f = (clean + 0.1 * torch.randn(clean.shape, generator=gen,
                                   dtype=f64)).to(device)
    amap = random_map(f, 1, 0.04, 0.1)
    forms = (("K=3", sumregs_model(), weights(sumregs_weights()[0], f)),
             ("K=3 maps", sumregs_model(),
              (amap, torch.tensor(0.03, dtype=f64), 0.2 * amap)),
             ("map", tv_model(), (amap,)))
    kw = dict(tau0=5.0, sigma0=0.99 / 5.0, gamma=1.0, accel=True,
              maxiter=2000, tol=1e-7, check_every=50, return_dual=True)
    errs, its = {}, {}
    for label, model, a in forms:
        ku, kys, kit = pdps_cuda.denoise_pdps_cuda(f, a, None, model=model,
                                                   **kw)
        pu, pys, pit = _denoise_pdps_impl(f, a, None, model=model, **kw)
        errs[f"A {label}"] = max([rel_err(ku, pu)]
                                 + [rel_err(k, p) for k, p in zip(kys, pys)])
        its[f"A {label}"] = (kit, pit)

    levels = torch.rand((2, 8, 8), generator=gen, dtype=f64)
    u = torch.kron(levels, torch.ones((4, 4), dtype=f64))
    u[:, 24:, :] += 0.3 * torch.linspace(0.0, 1.0, 32, dtype=f64)
    utrue = u + 0.05 * torch.randn(u.shape, generator=gen, dtype=f64)
    u, utrue = u.to(device), utrue.to(device)
    for label, model, a in forms:
        want_maps = "map" in label
        for name, kern, plain, cfg in (
                ("exact", hypergrad_cuda.exact_hypergrad_cuda,
                 exact_hypergrad,
                 HypergradConfig(al_iters=2, cg_maxiter=300)),
                ("reg", hypergrad_cuda.reg_hypergrad_cuda, reg_hypergrad,
                 HypergradConfig(cg_maxiter=300, gamma=1e4))):
            (kg, kp, ki), _ = kernel_b_call(
                lambda: kern(u, utrue, a, model, cfg, want_maps))
            pg, pp, pi = plain(u, utrue, a, model, cfg, want_maps)
            errs[f"B {label} {name}"] = max(
                [rel_err(kp, pp)] + [rel_err(torch.as_tensor(k),
                                             torch.as_tensor(p))
                                     for k, p in zip(kg, pg)])
            its[f"B {label} {name}"] = (ki.iters, pi.iters)
    say("  float64 2x32x32: " + "; ".join(
        f"{k} rel {v:.2e} its {its[k][0]}/{its[k][1]}"
        for k, v in errs.items()) + f" (tol {TOL_F64_REL:g})")
    require(all(its[k][0] == its[k][1] for k in its if k.startswith("A")),
            f"float64 kernel A forms: iterations {its}")
    require(all(abs(its[k][0] - its[k][1]) <= 1 for k in its
                if k.startswith("B")), f"float64 kernel B forms: CG {its}")
    require(max(errs.values()) <= TOL_F64_REL, f"float64 forms: {errs}")
    return max(errs.values())


def watch_plain(cp=False):
    """Count calls of the plain versions of kernels A and B (with ``cp``,
    also of the TGV², TV-L1 (both forms) and VTV kernels) that their
    wrappers would make: → (calls, restore)."""
    from bpldenoising_tpu_torch.solvers import (hypergrad_cuda, pdps_cuda,
                                                tgv_cuda, tvl1_cuda,
                                                vtv_cuda)
    calls = []
    saved = [(pdps_cuda, "_denoise_pdps_impl"),
             (hypergrad_cuda, "exact_hypergrad"),
             (hypergrad_cuda, "reg_hypergrad")]
    if cp:
        saved += [(tgv_cuda, "_tgv_impl"), (tvl1_cuda, "_tvl1_huber_loop"),
                  (tvl1_cuda, "_tvl1_loop"),
                  (vtv_cuda, "_denoise_pdps_impl")]
    originals = [getattr(m, n) for m, n in saved]

    def wrap(fn):
        def watched(*a, **k):
            calls.append(fn.__name__)
            return fn(*a, **k)
        return watched

    for (m, n), fn in zip(saved, originals):
        setattr(m, n, wrap(fn))

    def restore():
        for (m, n), fn in zip(saved, originals):
            setattr(m, n, fn)
    return calls, restore


def tvf_learn_kwargs(name):
    """The entry point and its keywords for a learn of phases 36-39."""
    import numpy as np
    from bpldenoising_tpu_torch.experiments import api
    from bpldenoising_tpu_torch.solvers.hypergrad import HypergradConfig
    kw = dict(dataset_name="faces_train", num_samples=10, dtype="float32",
              method="tr_fused", maxiter=20, tol=1e-5, inner_maxiter=5000,
              inner_tol=1e-6, check_every=100,
              hypergrad_cfg=HypergradConfig(al_iters=2, cg_maxiter=100))
    if name == "patch_tv":
        return api.patch_bilevel_tv_learn, kw
    if name == "sumregs":
        return api.scalar_bilevel_sumregs_learn, kw
    if name == "patch_sumregs":
        return api.patch_bilevel_sumregs_learn, kw
    return api.patch_bilevel_tv_learn, dict(
        kw, alpha0=FLAGSHIP_ALPHA * np.ones((16, 16)),
        delta0=FLAGSHIP_ALPHA / 4, maxiter=16, inner_maxiter=2000,
        hypergrad_cfg=HypergradConfig())


def log_lines(res):
    """The whole state.log, one entry per outer iteration."""
    return [f"    {e.iter:2d}: cost {e.function_value:.6f} |g| "
            f"{e.g_norm:.6g} delta {e.delta:.4g} step {e.step_norm:.4g} "
            f"CG {int(e.adjoint_cg_iters)} conv {int(e.adjoint_cg_converged)}"
            for e in res.state.log]


def phase_tvf_learn(utrue, timed, name, warm_up=True):
    """A patch TV / sum-of-regularizers learn through its entry point with
    method="tr_fused" at bench.py's settings (warm-up run, then timed,
    counters reset just before and read just after, the plain versions
    watched), against TVF_REF[name]: the gates that fail are returned
    under "faults", so that every learn reports before the script
    fails."""
    import numpy as np
    import torch
    from bpldenoising_tpu_torch.metrics import psnr

    learn, kw = tvf_learn_kwargs(name)
    if warm_up:
        learn(device="cuda", **kw)
    calls, restore = watch_plain()
    try:
        reset_launches()
        res, wall_ms = timed(lambda: learn(device="cuda", **kw))
        launches = read_launches()
        a_forms = kernel_a_forms()
        b_forms = kernel_b_forms()
    finally:
        restore()
    ref = TVF_REF[name]
    x = np.asarray(res.x, dtype=np.float64)
    x_ref = np.asarray(ref["x"], dtype=np.float64)
    scale = float(np.abs(x_ref).max())
    d_alpha = float(np.abs(x - x_ref).max())
    mean_psnr = float(torch.mean(psnr(utrue, on_device(res, utrue))))
    cost = float(res.cost)
    cost_rel = abs(cost - ref["cost"]) / ref["cost"]
    cg = cg_log(res)
    if x.size <= 12:
        say(f"  alpha {np.round(x, 8).tolist()}")
        say(f"  reference {np.round(x_ref, 8).tolist()}")
    band = TVF_BAND[name]
    d_psnr = abs(mean_psnr - ref["psnr"])
    # (value, nominal gate, the gate: the larger of it and twice the band)
    checks = dict(alpha=(d_alpha, TVF_ALPHA_GATE * scale),
                  psnr=(d_psnr, TVF_PSNR_GATE),
                  cost=(cost_rel, TVF_COST_GATE_REL))
    gates = {k: max(nominal, 2.0 * band[k])
             for k, (_, nominal) in checks.items()}
    nominal_in = {k: "in" if v <= nominal else "out"
                  for k, (v, nominal) in checks.items()}
    say(f"  max|d alpha| {d_alpha:.3e} = {d_alpha / scale:.2e} x max|alpha| "
        f"(gate {gates['alpha']:.3e}; nominal {TVF_ALPHA_GATE:g} x max: "
        f"{nominal_in['alpha']}); PSNR {mean_psnr:.6f} dB (reference "
        f"{ref['psnr']:.6f}, |d| {d_psnr:.2e}, gate {gates['psnr']:.3g}; "
        f"nominal {TVF_PSNR_GATE:g}: {nominal_in['psnr']}); cost "
        f"{cost:.6f} (reference {ref['cost']:.6f}, rel {cost_rel:.2e}, "
        f"gate {gates['cost']:.3g}; nominal {TVF_COST_GATE_REL:g}: "
        f"{nominal_in['cost']}); {res.iterations} outer its (reference "
        f"{ref['iterations']}); adjoint CG {cg[0]} its, capped in {cg[1]}")
    for line in log_lines(res):
        say(line)
    after = ", after one warm-up run" if warm_up else ""
    say(f"  wall {wall_ms:.1f} ms (CUDA events{after}; PNG load included); "
        f"launches {launches}; plain-version calls {len(calls)}")
    say_kernel_a_forms(a_forms)
    say_kernel_b_forms(b_forms)
    faults = [msg for ok, msg in (
        (launches["pdps"] > 0 and launches["hypergrad"] > 0 and not calls,
         f"{name} learn: launches {launches}, plain calls {calls[:3]}"),
        (a_forms["cluster"] == launches["pdps"],
         f"{name} learn: kernel A's cluster form ran {a_forms['cluster']} "
         f"of {launches['pdps']} calls"),
        (kernel_b_cooperative(b_forms),
         f"{name} learn: kernel B {b_forms}: not one launch and one read a "
         "call"),
        (d_alpha <= gates["alpha"], f"{name} alpha off by {d_alpha}"),
        (d_psnr <= gates["psnr"], f"{name} mean PSNR {mean_psnr}"),
        (cost_rel <= gates["cost"], f"{name} final cost {cost}"))
        if not ok]
    return dict(alpha_abs_err=d_alpha, alpha_scale=scale,
                mean_psnr_db=mean_psnr, final_cost=cost,
                outer_iterations=res.iterations, adjoint_cg=cg[0],
                nominal_gates=nominal_in, wall_ms=wall_ms,
                launches=launches, kernel_a=a_forms, kernel_b=b_forms,
                faults=faults)


def phase_tvf_witness(name):
    """A float64 witness: the learn through its entry point in float64 on
    the card against the JAX package's float64 run (TVF_WITNESS[name])."""
    import numpy as np
    from bpldenoising_tpu_torch.solvers.hypergrad import HypergradConfig

    ref = TVF_WITNESS[name]
    learn, kw = tvf_learn_kwargs(name)
    reset_launches()
    res = learn(device="cuda", **dict(
        kw, dtype="float64", maxiter=ref["maxiter"],
        hypergrad_cfg=HypergradConfig(al_iters=2, cg_maxiter=1000,
                                      act_tol=1e-4)))
    a_forms = kernel_a_forms()
    b_forms = kernel_b_forms()
    x = np.asarray(res.x, dtype=np.float64)
    x_ref = np.asarray(ref["x"])
    d_rel = float(np.abs(x - x_ref).max() / np.abs(x_ref).max())
    cost_rel = abs(float(res.cost) - ref["cost"]) / ref["cost"]
    say(f"  {name}: alpha {x.ravel().tolist()} (reference "
        f"{x_ref.ravel().tolist()}): max|d| {d_rel:.2e} x max|alpha|; cost "
        f"{float(res.cost)!r} (reference {ref['cost']!r}) rel "
        f"{cost_rel:.2e} (gate {TVF_WITNESS_GATE_REL:g}); "
        f"{res.iterations} outer its")
    for line in log_lines(res):
        say(line)
    say_kernel_a_forms(a_forms)
    say_kernel_b_forms(b_forms)
    ok = (d_rel <= TVF_WITNESS_GATE_REL and cost_rel <= TVF_WITNESS_GATE_REL
          and a_forms["cluster"] == a_forms["calls"] > 0
          and b_forms["calls"] > 0 and kernel_b_cooperative(b_forms))
    return dict(alpha_rel_err=d_rel, cost_rel_err=cost_rel,
                kernel_a=a_forms, kernel_b=b_forms, faults=[] if ok
                else [f"float64 {name} witness: alpha {d_rel}, cost "
                      f"{cost_rel}, kernel A {a_forms}, kernel B "
                      f"{b_forms}"])


def tr_counts(reads0, plain):
    """Since the last reset: kernels A and B, the host trust region's reads
    of (cost, gradient) since ``reads0`` and the plain versions' calls."""
    from bpldenoising_tpu_torch.bilevel import trust_region
    return dict(kernel_a=kernel_a_forms(), kernel_b=kernel_b_forms(),
                host_reads=trust_region.host_reads - reads0,
                plain_calls=len(plain))


def tr_run(learn):
    """``learn()`` with every count reset just before and read just after,
    the plain versions of kernels A and B watched: → (result, wall ms on
    the host clock around a synchronisation, counts)."""
    import torch
    from bpldenoising_tpu_torch.bilevel import trust_region
    plain, restore = watch_plain(cp=True)
    try:
        reset_launches()
        reads0 = trust_region.host_reads
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = learn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        counts = tr_counts(reads0, plain)
        counts["launches"] = read_launches()
    finally:
        restore()
    return res, wall_ms, counts


def tr_kernel_faults(label, res, counts):
    """Kernels A and B once per evaluation (the iterations + 1), A in the
    cluster form, B one launch and one read, one host read of (cost,
    gradient) per evaluation, no plain-version call."""
    evals = res.iterations + 1
    a, b = counts["kernel_a"], counts["kernel_b"]
    say(f"  {label}: {res.iterations} outer its, {evals} evaluations; "
        f"host reads of (cost, gradient) {counts['host_reads']}; "
        f"plain-version calls {counts['plain_calls']}")
    say_kernel_a_forms(a)
    say_kernel_b_forms(b)
    return [msg for ok, msg in (
        (a["calls"] == b["calls"] == evals == counts["host_reads"],
         f"{label}: kernel A {a['calls']}, kernel B {b['calls']} calls, "
         f"{counts['host_reads']} host reads for {evals} evaluations"),
        (a["cluster"] == a["calls"],
         f"{label}: kernel A's cluster form ran {a['cluster']} of "
         f"{a['calls']} calls"),
        (kernel_b_cooperative(b),
         f"{label}: kernel B {b}: not one launch and one read a call"),
        (counts["plain_calls"] == 0,
         f"{label}: {counts['plain_calls']} plain-version calls"))
        if not ok]


def phase_tr_flagship(utrue64):
    """Phase 41: the flagship default call (method="tr", float64) through
    the entry point, against the JAX package's float64 run."""
    import torch
    from bpldenoising_tpu_torch.experiments.api import \
        scalar_bilevel_tv_learn
    from bpldenoising_tpu_torch.metrics import psnr
    res, wall_ms, counts = tr_run(lambda: scalar_bilevel_tv_learn(
        dataset_name="faces_train", num_samples=10, device="cuda"))
    alpha = float(res.x)
    a_rel = abs(alpha - TR_ALPHA) / TR_ALPHA
    mean_psnr = float(torch.mean(psnr(utrue64, on_device(res, utrue64))))
    cost = float(res.cost)
    c_rel = abs(cost - TR_COST) / TR_COST
    say(f"  alpha {alpha!r} (reference {TR_ALPHA!r}, rel {a_rel:.2e}, gate "
        f"{TR_ALPHA_GATE_REL:g}); PSNR {mean_psnr!r} dB (reference "
        f"{TR_PSNR!r}, |d| {abs(mean_psnr - TR_PSNR):.2e}, gate "
        f"{TR_PSNR_GATE:g}); cost {cost!r} (reference {TR_COST!r}, rel "
        f"{c_rel:.2e}, gate {TR_COST_GATE_REL:g}); {res.iterations} outer "
        f"its (reference {TR_ITERATIONS}); u {res.u.dtype}")
    for line in log_lines(res):
        say(line)
    say(f"  wall {wall_ms:.1f} ms (host clock, first run, PNG load "
        f"included); launches {counts['launches']}")
    faults = tr_kernel_faults("flagship tr", res, counts) + [
        msg for ok, msg in (
            (a_rel <= TR_ALPHA_GATE_REL, f"flagship tr alpha {alpha}"),
            (abs(mean_psnr - TR_PSNR) <= TR_PSNR_GATE,
             f"flagship tr mean PSNR {mean_psnr}"),
            (c_rel <= TR_COST_GATE_REL, f"flagship tr cost {cost}"),
            (res.u.dtype == "float64", f"flagship tr u {res.u.dtype}"))
        if not ok]
    return dict(alpha=alpha, alpha_rel_err=a_rel, mean_psnr_db=mean_psnr,
                final_cost=cost, cost_rel_err=c_rel,
                outer_iterations=res.iterations, wall_ms=wall_ms,
                counts=counts, faults=faults)


def phase_tr_bench(utrue):
    """Phase 42: the flagship with method="tr" at the bench settings in
    float32 (flagship_kwargs), against the flagship's band."""
    import torch
    from bpldenoising_tpu_torch.experiments.api import \
        scalar_bilevel_tv_learn
    from bpldenoising_tpu_torch.metrics import psnr
    kw = dict(flagship_kwargs(), method="tr")
    res, wall_ms, counts = tr_run(lambda: scalar_bilevel_tv_learn(
        device="cuda", **kw))
    alpha = float(res.x)
    d_alpha = abs(alpha - FLAGSHIP_ALPHA)
    mean_psnr = float(torch.mean(psnr(utrue, on_device(res, utrue))))
    cost = float(res.cost)
    say(f"  alpha {alpha:.7f} |d| {d_alpha:.2e} (band {ALPHA_BAND:g}); "
        f"PSNR {mean_psnr:.4f} dB; cost {cost:.4f}; {res.iterations} outer "
        f"its")
    say(f"  wall {wall_ms:.1f} ms (host clock, PNG load included); "
        f"launches {counts['launches']}")
    faults = tr_kernel_faults("bench tr", res, counts) + [
        msg for ok, msg in (
            (d_alpha <= ALPHA_BAND, f"bench tr alpha {alpha}"),
            (abs(mean_psnr - FLAGSHIP_PSNR) <= PSNR_GATE,
             f"bench tr mean PSNR {mean_psnr}"),
            (abs(cost - FLAGSHIP_COST) <= COST_GATE_REL * FLAGSHIP_COST,
             f"bench tr cost {cost}"))
        if not ok]
    return dict(alpha=alpha, alpha_abs_err=d_alpha, mean_psnr_db=mean_psnr,
                final_cost=cost, outer_iterations=res.iterations,
                wall_ms=wall_ms, counts=counts, faults=faults)


def tr_rows(res):
    """(cost, ‖g‖, Δ) and whether the step was accepted, per logged
    iteration.  The fused log's step is 0 on a rejection; the host log
    keeps the last accepted step, so there an iteration is accepted when
    its cost differs from the one before (the first: a step above 0)."""
    rows = [(e.function_value, e.g_norm, e.delta) for e in res.state.log]
    acc = [e.step_norm > 0 if i == 0
           else e.function_value != res.state.log[i - 1].function_value
           for i, e in enumerate(res.state.log)]
    return rows, acc


def tr_parity(label, run_tr, run_fused, cp=None, gate=True):
    """tr against tr_fused (each with its counts): the logged cost, ‖g‖
    and Δ to TR_PARITY_GATE_REL relative and the accept pattern equal
    (``gate`` False: printed, not gated); ``cp``: the CP kernel's wrapper
    module (tgv_cuda, tvl1_cuda, vtv_cuda), whose every call must take its
    cluster form."""
    import numpy as np
    out, faults = {}, []
    results = {}
    for method, run in (("tr", run_tr), ("tr_fused", run_fused)):
        t0 = time.perf_counter()
        res, wall_ms, counts = tr_run(run)
        evals = res.iterations + 1
        if cp is not None:
            counts["cp"] = dict(calls=cp.launches, cluster=cp.cluster_calls,
                                device_ops=cp.device_ops)
            say(f"  {label} {method}: CP kernel {cp.launches} calls, "
                f"{cp.cluster_calls} in the cluster form, {cp.device_ops} "
                f"device operations; host reads of (cost, gradient) "
                f"{counts['host_reads']}; plain-version calls "
                f"{counts['plain_calls']}")
            if cp.cluster_calls != cp.launches or cp.launches != evals:
                faults.append(f"{label} {method}: the CP kernel's cluster "
                              f"form ran {cp.cluster_calls} of "
                              f"{cp.launches} calls, {evals} evaluations")
            if method == "tr" and counts["host_reads"] != evals:
                faults.append(f"{label} tr: {counts['host_reads']} host "
                              f"reads for {evals} evaluations")
        elif method == "tr":
            faults += tr_kernel_faults(f"{label} tr", res, counts)
        if counts["plain_calls"] and (cp is not None or method != "tr"):
            faults.append(f"{label} {method}: {counts['plain_calls']} "
                          "plain-version calls")
        results[method] = res
        out[method] = dict(x=np.asarray(res.x).ravel().tolist(),
                           cost=float(res.cost),
                           outer_iterations=res.iterations, wall_ms=wall_ms,
                           seconds=time.perf_counter() - t0, counts=counts)
    (rows, acc), (frows, facc) = (tr_rows(results["tr"]),
                                  tr_rows(results["tr_fused"]))
    rows, frows = np.asarray(rows), np.asarray(frows)
    same_shape = rows.shape == frows.shape
    rel = (float(np.max(np.abs(rows - frows)
                        / np.maximum(np.abs(frows), 1e-300)))
           if same_shape and rows.size else float("inf"))
    bits = same_shape and bool(np.array_equal(rows, frows))
    first = (next((i + 1 for i in range(len(rows))
                   if not np.array_equal(rows[i], frows[i])), None)
             if same_shape else 1)
    say(f"  {label}: tr {results['tr'].iterations} outer its, tr_fused "
        f"{results['tr_fused'].iterations}; max rel diff of cost, |g|, "
        f"delta {rel:.3e} ("
        f"{f'gate {TR_PARITY_GATE_REL:g}' if gate else 'not gated'}); "
        f"{'bit for bit' if bits else f'first differing row {first}'}; "
        f"accept pattern {'equal' if acc == facc else 'DIFFERS'} "
        f"{['A' if a else 'r' for a in acc]}")
    for method in ("tr", "tr_fused"):
        for line in log_lines(results[method]):
            say(f"    {method} {line.strip()}")
    if gate and not (same_shape and rel <= TR_PARITY_GATE_REL
                     and acc == facc):
        faults.append(f"{label}: tr against tr_fused: rel {rel}, accept "
                      f"{acc} against {facc}")
    out.update(max_rel_diff=rel, bit_for_bit=bits, first_differing_row=first,
               accept_equal=acc == facc, faults=faults)
    out["last"] = (results["tr"].x, results["tr"].state.log[-1].delta)
    return out


def tr_ulp_control(name, x, delta):
    """How far the TV-family gradient moves under a one-ulp move of the
    parameter: the default learning function (HypergradConfig(), cold
    start) at ``x`` and at x moved by one ulp towards +∞, on phase 43's
    data for ``name``.  → (max |Δg| / max |g|, CG iterations and converged
    of the first evaluation)."""
    import numpy as np
    from bpldenoising_tpu_torch import learning
    lf = (learning.tv_learning_function if name in ("patch_tv", "grid16")
          else learning.sumregs_learning_function)
    ds = tr_phase43_data(name)
    outs = [lf(xx, ds, delta, return_aux=True)
            for xx in (x, np.nextafter(x, np.inf))]
    g0, g1 = (o[2].double().cpu().numpy() for o in outs)
    info = outs[0][5]
    return (float(np.max(np.abs(g1 - g0)) / np.max(np.abs(g0))),
            int(info.iters), bool(info.converged))


def tr_phase43_data(name):
    """Phase 43's float64 data on the card: the ten faces images, or the
    first image pair for ``image_pair``."""
    import torch
    from bpldenoising_tpu_torch.data import testdataset
    true_, noisy = testdataset("faces_train_128_10")
    if name == "image_pair":
        true_, noisy = true_[:1], noisy[:1]
    return tuple(torch.as_tensor(a, dtype=torch.float64).cuda()
                 for a in (true_, noisy))


def phase_tr_tv_parity(name):
    """Phase 43 for ``name``: tr against tr_fused with the well-conditioned
    adjoint of phase 40's witnesses (gated), then with the entry point's
    default HypergradConfig() (printed, with the one-ulp control at tr's
    last x: where its adjoint CG stops at the cap, the gradient itself moves
    far more than 1e-10 under a last-bit move of x, and the two trust
    regions' last-bit differences carry that far)."""
    from bpldenoising_tpu_torch.solvers.hypergrad import HypergradConfig
    well = HypergradConfig(al_iters=2, cg_maxiter=1000, act_tol=1e-4)
    say(f"  {name}, HypergradConfig(al_iters=2, cg_maxiter=1000, "
        "act_tol=1e-4) (phase 40's well-conditioned adjoint):")
    out = dict(well_conditioned=tr_parity(name, *tr_pair_runs(name, well)))
    say(f"  {name}, the entry point's default HypergradConfig() (not "
        "gated):")
    default = tr_parity(name, *tr_pair_runs(name), gate=False)
    ulp, its, conv = tr_ulp_control(name, *default.pop("last"))
    say(f"  {name}: at tr's last x the default gradient moves by {ulp:.3e} "
        f"relative under a one-ulp move of x (adjoint CG {its} its, "
        f"converged {conv})")
    out["well_conditioned"].pop("last")
    out.update(default_config=default, ulp_control=dict(
        grad_rel_move=ulp, cg_iters=its, cg_converged=conv),
        faults=out["well_conditioned"].pop("faults") + default.pop("faults"))
    return out


def tr_pair_runs(name, cfg=None):
    """Phase 43-44's pair for ``name``: (run_tr, run_fused, CP wrapper or
    None).  Float64 (the entry points' default dtype), inner_tol None (the
    default: every inner solve cold at its fixed budget), the outer
    iterations cut to 3; the rest is each entry point's default on the
    datasets of phases 36-39 and 8, 11, 15 (the faces images, circle_sp,
    the six color_disks images); ``cfg``: the TV family's
    HypergradConfig, if not the default."""
    import numpy as np
    import torch
    from bpldenoising_tpu_torch.bilevel.fused import bilevel_learn_fused
    from bpldenoising_tpu_torch.data import testdataset
    from bpldenoising_tpu_torch.experiments import api, tgv, tvl1, vtv
    from bpldenoising_tpu_torch.models import sumregs_model
    from bpldenoising_tpu_torch.solvers import tgv_cuda, tvl1_cuda, vtv_cuda
    from bpldenoising_tpu_torch.utils.config import merge

    common = dict(maxiter=3, inner_tol=None, device="cuda")
    if cfg is not None:
        common["hypergrad_cfg"] = cfg
    faces = dict(common, dataset_name="faces_train", num_samples=10)
    if name == "image_pair":
        true_, noisy = testdataset("faces_train_128_10")
        pair = (true_[0], noisy[0])
        params = merge(api.default_params, api.patch_sumregs_bilevel_params,
                       dict(common, device=None))

        def fused():
            ds = tuple(torch.as_tensor(im, dtype=torch.float64)[None].cuda()
                       for im in pair)
            res = bilevel_learn_fused(
                ds, xinit=params.alpha0, params=params,
                model=sumregs_model(), inner_maxiter=params.inner_maxiter,
                inner_tol=None, check_every=params.check_every,
                delta_t=1e-3, cfg=params.hypergrad_cfg, device="cuda")
            return api._fused_to_result(res)
        return (lambda: api.patch_bilevel_sumregs_learn(
            image_pair=pair, **common), fused, None)
    learn, kw, cp = {
        "sumregs": (api.scalar_bilevel_sumregs_learn, faces, None),
        "patch_tv": (api.patch_bilevel_tv_learn, faces, None),
        "grid16": (api.patch_bilevel_tv_learn,
                   dict(faces, alpha0=FLAGSHIP_ALPHA * np.ones((16, 16)),
                        delta0=FLAGSHIP_ALPHA / 4), None),
        "tgv": (tgv.scalar_bilevel_tgv_learn, faces, tgv_cuda),
        "tvl1": (tvl1.scalar_bilevel_tvl1_learn, common, tvl1_cuda),
        "vtv": (vtv.scalar_bilevel_vtv_learn,
                dict(common, dataset_name="color_disks", num_samples=6),
                vtv_cuda),
    }[name]
    return (lambda: learn(**dict(kw, method="tr")),
            lambda: learn(**dict(kw, method="tr_fused")), cp)


@contextlib.contextmanager
def results_not_saved():
    """Phases 1-44 as the parent ran them: every entry point's default
    save_results=False, so they write nothing and time only what they
    timed before results were ported."""
    from bpldenoising_tpu_torch.experiments import api
    saved = api.default_params
    api.default_params = saved | dict(save_results=False)
    try:
        yield
    finally:
        api.default_params = saved


@contextlib.contextmanager
def in_scratch_dir():
    """Run the block in a new temporary directory (the entry points write
    output/ under the working directory), removed after."""
    import os
    import shutil
    import tempfile
    here = os.getcwd()
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    os.chdir(work)
    try:
        yield work
    finally:
        os.chdir(here)
        shutil.rmtree(work, ignore_errors=True)


def reporting_counts(plain):
    """Since the last reset: the CP kernels' (``pdps``, ``tgv``, ``tvl1``,
    ``vtv``) calls and cluster-form calls, kernel B's calls and the plain
    versions' calls."""
    mods = launch_counters()
    out = {name: dict(calls=mods[name].launches,
                      cluster=mods[name].cluster_calls)
           for name in ("pdps", "tgv", "tvl1", "vtv")}
    out["hypergrad"] = mods["hypergrad"].launches
    out["plain_calls"] = len(plain)
    return out


def reporting_kernel_faults(label, counts, kernel, calls):
    """``calls`` calls of ``kernel``, all in the cluster form, no other
    kernel, no plain-version call."""
    others = sum(c["calls"] for n, c in counts.items()
                 if n not in (kernel, "plain_calls", "hypergrad"))
    k = counts[kernel]
    ok = (k["calls"] == k["cluster"] == calls and others == 0
          and counts["hypergrad"] == 0 and counts["plain_calls"] == 0)
    return [] if ok else [f"{label}: want {calls} {kernel} calls in the "
                          f"cluster form and nothing else, got {counts}"]


def quality_rows(path):
    """A quality table's numbers: one row per image, then the means."""
    import numpy as np
    with open(path) as fh:
        lines = fh.read().splitlines()[1:]
    return [np.array([float(v) for v in line.split()]) for line in lines]


def phase_reporting_learn(utrue, flagship_wall_ms):
    """Phase 45: the flagship tr_fused learn at the bench settings with
    save_results=True in a temporary directory: the file set, one log row
    per outer iteration, the quality table against psnr_np/ssim_np of the
    stretched arrays, the PNGs against uint8(clip(x)·255 + 0.5); the
    learn's wall and the host time of its save_results apart."""
    import os
    import numpy as np
    import torch
    from bpldenoising_tpu_torch.data import read_png_gray, testdataset
    from bpldenoising_tpu_torch.experiments import api
    from bpldenoising_tpu_torch.metrics import psnr_np, ssim_np
    kw = dict(flagship_kwargs(), save_results=True)
    saved_ms = []
    real_report = api.report

    def timed_report(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real_report(*a, **k)
        saved_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    # the quality table's SSIM imports scipy.signal (seconds, once a
    # process): timed apart, before the learn
    t0 = time.perf_counter()
    import scipy.signal  # noqa: F401
    import_ms = (time.perf_counter() - t0) * 1e3
    plain, restore = watch_plain(cp=True)
    faults = []
    try:
        with in_scratch_dir() as work:
            api.report = timed_report
            reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = api.scalar_bilevel_tv_learn(device="cuda", **kw)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
            counts = reporting_counts(plain)
            a_forms, b_forms = kernel_a_forms(), kernel_b_forms()
            ds = "faces_train_128_10"
            prefix = f"tv_optimal_parameter_scalar_{ds}"
            out = os.path.join(work, "output", ds)
            files = sorted(os.listdir(out))
            n = int(kw["num_samples"])
            want = sorted([f"{prefix}.txt", f"{prefix}_quality.txt"]
                          + [f"{prefix}_{k}_{i + 1}.png" for i in range(n)
                             for k in ("true", "data", "reco")])
            if files != want:
                faults.append(f"files {files}, want {want}")
            with open(os.path.join(out, prefix + ".txt")) as fh:
                lines = fh.read().splitlines()
            at = next(i for i, line in enumerate(lines)
                      if line.startswith("# iter"))
            rows = len(lines) - at - 1
            if rows != res.iterations or rows != len(res.state.log):
                faults.append(f"{rows} log rows for {res.iterations} outer "
                              "iterations")
            # the arrays save_results was given: the float32 stacks on the
            # card and the reconstruction, each stretched over its stack
            true_np, noisy_np = testdataset(ds)
            b, bd = (api.linear_stretch(torch.as_tensor(a[:n],
                                                        dtype=torch.float32))
                     for a in (true_np, noisy_np))
            opt = api.linear_stretch(res.u)
            table = quality_rows(os.path.join(out, prefix + "_quality.txt"))
            want_rows = [np.array([i + 1, ssim_np(b[i], bd[i]),
                                   psnr_np(b[i], bd[i]),
                                   ssim_np(b[i], opt[i]),
                                   psnr_np(b[i], opt[i])])
                         for i in range(n)]
            want_rows.append(np.array([np.mean([r[3] for r in want_rows]),
                                       np.mean([r[4] for r in want_rows])]))
            table_err = max(float(np.max(np.abs(t - w) / np.abs(w)))
                            for t, w in zip(table, want_rows))
            if len(table) != n + 1 or table_err > 1e-12:
                faults.append(f"quality table off by {table_err}")
            png_err = 0
            for i in range(n):
                for k, img in (("true", b[i]), ("data", bd[i]),
                               ("reco", opt[i])):
                    got = np.rint(read_png_gray(os.path.join(
                        out, f"{prefix}_{k}_{i + 1}.png")) * 255.0)
                    q = (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(
                        np.uint8)
                    png_err = max(png_err, int(np.max(np.abs(got - q))))
            if png_err:
                faults.append(f"PNGs off by {png_err} grey levels")
    finally:
        api.report = real_report
        restore()
    report_ms = saved_ms[0] if saved_ms else float("nan")
    mean_psnr = float(table[-1][1])
    say(f"  alpha {float(res.x):.6f}; {res.iterations} outer its, "
        f"{rows} log rows; {len(files)} files; quality table against "
        f"psnr_np/ssim_np max rel {table_err:.1e}, mean PSNR of the "
        f"stretched reconstruction {mean_psnr:.6f} dB; PNGs against "
        f"uint8(clip(x)*255+0.5): {png_err} grey levels")
    say(f"  learn wall {wall_ms:.1f} ms (host clock, first run with "
        f"saving, PNG load included; phase 5's timed run without saving "
        f"{flagship_wall_ms:.1f} ms, CUDA events); save_results "
        f"{report_ms:.1f} ms on the host (the host copies, stretching, the "
        f"SSIM/PSNR table, {len(files)} files; scipy.signal's import "
        f"before it {import_ms:.1f} ms)")
    say_kernel_a_forms(a_forms)
    say_kernel_b_forms(b_forms)
    faults += [msg for ok, msg in (
        (a_forms["calls"] == a_forms["cluster"] > 0,
         f"kernel A's cluster form ran {a_forms['cluster']} of "
         f"{a_forms['calls']} calls"),
        (kernel_b_cooperative(b_forms) and b_forms["calls"] > 0,
         f"kernel B: {b_forms}"),
        (counts["plain_calls"] == 0,
         f"{counts['plain_calls']} plain-version calls"),
        (abs(float(res.x) - FLAGSHIP_ALPHA) <= ALPHA_GATE,
         f"alpha {float(res.x)}")) if not ok]
    return dict(alpha=float(res.x), outer_iterations=res.iterations,
                log_rows=rows, files=len(files), table_max_rel=table_err,
                png_max_levels=png_err, wall_ms=wall_ms,
                save_results_ms=report_ms, scipy_import_ms=import_ms,
                counts=counts,
                faults=[f"phase 45: {m}" for m in faults])


def reporting_call(label, run, kernel, calls):
    """``run()`` in a temporary directory with every count reset just
    before and read just after and the plain versions watched: → (its
    result, wall ms on the host clock around a synchronisation, counts,
    faults)."""
    import torch
    plain, restore = watch_plain(cp=True)
    try:
        with in_scratch_dir():
            reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = run()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
            counts = reporting_counts(plain)
    finally:
        restore()
    return out, wall_ms, counts, reporting_kernel_faults(label, counts,
                                                         kernel, calls)


def reporting_module(name):
    import importlib
    return importlib.import_module(
        f"bpldenoising_tpu_torch.experiments.{name}")


def phase_validations():
    """Phase 46: the five validations in float64 on the card at the
    learned weights, against the JAX package's float64 runs; one call of
    the family's CP kernel each, in the cluster form, no plain call."""
    import numpy as np
    results, faults = {}, []
    for label, (mod, fn, p, kw, kernel) in REPORTING_VALIDATIONS.items():
        ref = REPORTING_REF[label]
        out, wall_ms, counts, bad = reporting_call(
            label, lambda: getattr(reporting_module(mod), fn)(
                np.asarray(p), device="cuda", **kw), kernel, 1)
        c_rel = abs(out["cost"] - ref["cost"]) / ref["cost"]
        d_psnr = abs(out["mean_psnr"] - ref["mean_psnr"])
        d_ssim = abs(out["mean_ssim"] - ref["mean_ssim"])
        say(f"  {label} {p} on {kw['dataset_name']} ({out['u'].shape[0]} "
            f"images, {out['u'].dtype}): cost {out['cost']!r} (JAX "
            f"{ref['cost']!r}, rel {c_rel:.2e}, gate "
            f"{REPORTING_COST_GATE_REL:g}); mean PSNR {out['mean_psnr']!r} "
            f"dB (|d| {d_psnr:.2e}, gate {REPORTING_PSNR_GATE:g}); mean "
            f"SSIM {out['mean_ssim']!r} (|d| {d_ssim:.2e}); wall "
            f"{wall_ms:.1f} ms (host clock, files written); {kernel} "
            f"{counts[kernel]['calls']} calls, {counts[kernel]['cluster']} "
            f"in the cluster form; plain calls {counts['plain_calls']}")
        faults += bad + [msg for ok, msg in (
            (c_rel <= REPORTING_COST_GATE_REL, f"{label} cost {out['cost']}"),
            (d_psnr <= REPORTING_PSNR_GATE,
             f"{label} mean PSNR {out['mean_psnr']}"),
            (out["u"].dtype == np.float64, f"{label} u {out['u'].dtype}"),
            (out["u"].shape[0] == ref["images"],
             f"{label}: {out['u'].shape[0]} images")) if not ok]
        results[label] = dict(cost=out["cost"], mean_psnr=out["mean_psnr"],
                              mean_ssim=out["mean_ssim"], cost_rel_err=c_rel,
                              psnr_abs_err=d_psnr, ssim_abs_err=d_ssim,
                              wall_ms=wall_ms, counts=counts)
    results["faults"] = faults
    return results


def phase_sweeps():
    """Phase 47: the five cost sweeps in float64 on the card (one cold
    fixed-budget solve per weight or pair), against the JAX package's
    float64 sweeps point by point; every call in the cluster form, no
    plain call; each sweep's wall."""
    import numpy as np
    results, faults = {}, []
    for label, (mod, fn, ds, ranges, kernel) in REPORTING_SWEEPS.items():
        ref = np.asarray(REPORTING_REF[label]["costs"])
        points = int(np.prod([len(r) for r in ranges]))
        costs, wall_ms, counts, bad = reporting_call(
            label, lambda: getattr(reporting_module(mod), fn)(
                ds, *ranges, device="cuda"), kernel, points)
        costs = np.asarray(costs)
        rel = float(np.max(np.abs(costs.ravel() - ref.ravel())
                           / np.abs(ref.ravel())))
        say(f"  {label} on {ds}, {points} points: max rel diff from JAX "
            f"{rel:.2e} (gate {REPORTING_COST_GATE_REL:g}); costs "
            f"{[float(c) for c in costs.ravel()]}; wall {wall_ms:.1f} ms "
            f"(host clock, npz written; {wall_ms / points:.2f} ms a point); "
            f"{kernel} {counts[kernel]['calls']} calls, "
            f"{counts[kernel]['cluster']} in the cluster form; plain calls "
            f"{counts['plain_calls']}")
        faults += bad + ([] if costs.shape == ref.shape
                         and rel <= REPORTING_COST_GATE_REL
                         else [f"{label}: costs {costs.tolist()} against "
                               f"{ref.tolist()}"])
        results[label] = dict(points=points, max_rel_err=rel,
                              wall_ms=wall_ms, counts=counts)
    results["faults"] = faults
    return results


def phase_cli(validations):
    """Phase 48: ``python -m bpldenoising_tpu_torch validate-tv`` and
    ``cost-sweep`` in a subprocess on the card: they exit 0; validate-tv
    prints phase 46's cost and mean PSNR, and cost-sweep saves the costs
    the API gives in this process."""
    import os
    import numpy as np
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [root] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    faults, out = [], {}

    def cli(*args):
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "bpldenoising_tpu_torch", *args],
            capture_output=True, text=True, timeout=300, env=env)
        seconds = time.perf_counter() - t0
        if proc.returncode:
            faults.append(f"{args[0]} exited {proc.returncode}: "
                          f"{proc.stderr[-2000:]}")
        return proc, seconds

    with in_scratch_dir():
        proc, seconds = cli("validate-tv", "0.069788", "--dataset",
                            "faces_val")
        printed = [float(v) for v in proc.stdout.split()] or [float("nan")]
        ref = validations["val_tv"]
        want = [ref["cost"], ref["mean_psnr"]]
        rel = (max(abs(a - b) / abs(b) for a, b in zip(printed, want))
               if len(printed) == 2 else float("inf"))
        say(f"  validate-tv: exit {proc.returncode}, printed {printed} "
            f"(phase 46's API: {want}, max rel {rel:.1e}); {seconds:.1f} s "
            f"with the start-up")
        if rel > REPORTING_CLI_GATE_REL:
            faults.append(f"validate-tv printed {printed}, want {want}")
        out["validate_tv"] = dict(printed=printed, max_rel_err=rel,
                                  seconds=seconds)
    alphas = np.logspace(np.log10(0.02), np.log10(0.2), 4)
    with in_scratch_dir() as work:
        proc, seconds = cli("cost-sweep", "--dataset", "faces_train",
                            "--lo", "0.02", "--hi", "0.2", "--points", "4")
        path = os.path.join(work, "output", "faces_train_128_10",
                            "faces_train_128_10_cost.npz")
        saved = (np.load(path)["costs"] if os.path.exists(path)
                 else np.full(4, np.nan))
    api = reporting_module("api")
    with in_scratch_dir():
        want = api.generate_scalar_tv_cost("faces_train", alphas,
                                           device="cuda")
    rel = float(np.max(np.abs(saved - want) / np.abs(want)))
    say(f"  cost-sweep: exit {proc.returncode}, saved costs "
        f"{saved.tolist()} (the API here: {want.tolist()}, max rel "
        f"{rel:.1e}); {seconds:.1f} s with the start-up")
    if not rel <= REPORTING_CLI_GATE_REL:
        faults.append(f"cost-sweep saved {saved.tolist()}, want "
                      f"{want.tolist()}")
    out["cost_sweep"] = dict(saved=saved.tolist(), max_rel_err=rel,
                             seconds=seconds)
    out["faults"] = faults
    return out


# ---------------------------------------------------------------------------
# Phases 49-52: segmented dispatch, checkpoint and resume, the profiler
# trace and the differentiable layers
# ---------------------------------------------------------------------------

# α of a resumed learn against the whole one.  tr_fused: the JAX test's
# band (tests/test_experiments.py); its solves restart cold at the resume,
# and it read 2.23e-3 on the card (PR 24's chip calls 23 and 25).  tr: its
# adjoint CG restarts from zero, and the capped default CG's gradient
# depends on its start: it read 3.3e-5 in both calls; the gate is six
# times that.  A resume that ignored its checkpoint would land inside
# either band, so phase 50 also holds the resumed log's first rows to the
# checkpoint's and counts the resumed run's evaluations.
RESUME_GATE_REL = {"tr_fused": 5e-2, "tr": 2e-4}
# Layer gradients against the same backward on the plain forward, relative
# to max|plain grad|.  Float64: the forwards agree to 1e-15 and each CG
# stops at 1e-8 (readings ≤ 6.2e-9, PR 24's chip call 25).  Float32, per
# layer (chip calls 23 and 25 read the same digits): TV from its
# conditioning, since a float32 CG stops at a relative residual of 1e-5,
# which bounds its solution only to κ·1e-5, and κ reaches 1 + 8αγ = 5.6e3
# at γ = 1e4: 5.6e-2, rounded up to 6e-2 (read 3.81e-2).  The others at
# about twice their reading: the sum of regularizers read 9.63e-4; TGV²,
# whose 300-iteration CG stops at its cap, 1.02e-2.  TV-L1's and VTV's
# forwards are the plain version's bits (phases 10 and 13), so their
# backwards read 0.0; 1e-3 leaves room for a reordered sum only.  Call 23
# held every float32 layer to one 1e-2 and stopped on TV's 3.81e-2 and
# TGV²'s 1.02e-2.
DIFF_GRAD_GATE = {
    "float64": dict.fromkeys(("tv", "sumregs", "tgv", "tvl1", "vtv"), 1e-6),
    "float32": {"tv": 6e-2, "sumregs": 2e-3, "tgv": 2e-2, "tvl1": 1e-3,
                "vtv": 1e-3},
}


def log_numbers(res):
    """Every logged number of a learn but its wall times."""
    return [(e.iter, e.function_value, e.g_norm, e.delta, e.step_norm,
             e.adjoint_cg_iters, e.adjoint_cg_converged)
            for e in res.state.log]


def same_run(a, b):
    """Two learns with the same x, iterations and log numbers, bit for
    bit."""
    import numpy as np
    return (a.iterations == b.iterations
            and np.array_equal(np.asarray(a.x), np.asarray(b.x))
            and log_numbers(a) == log_numbers(b))


def times_ok(res):
    """One positive, non-decreasing segment-end time per iteration."""
    t = [e.time for e in res.state.log]
    return len(t) == res.iterations and all(v > 0 for v in t) \
        and t == sorted(t)


def phase_segmented(flagship, a_flag, b_flag):
    """Phase 49: the flagship with log_every=5 against phase 5's single
    run (x and log bit for bit, the same kernel-A and kernel-B calls,
    launches and reads), then TGV², TV-L1 and VTV at their learns' shapes,
    3 outer iterations, log_every=2 against a single run, the CP kernel's
    calls recorded on both sides."""
    import numpy as np
    from bpldenoising_tpu_torch.experiments import api, tgv, tvl1, vtv
    faults, out = [], {}
    plain, restore = watch_plain(cp=True)
    try:
        reset_launches()
        t0 = time.perf_counter()
        seg = api.scalar_bilevel_tv_learn(device="cuda", log_every=5,
                                          **flagship_kwargs())
        wall = (time.perf_counter() - t0) * 1e3
        a, b = kernel_a_forms(), kernel_b_forms()
        same = same_run(seg, flagship)
        say(f"  flagship log_every=5: alpha {float(seg.x)!r} (single run "
            f"{float(flagship.x)!r}), {seg.iterations} outer its, x and "
            f"log bit for bit: {same}; times "
            f"{[round(e.time, 4) for e in seg.state.log]} s; wall "
            f"{wall:.1f} ms (host clock, PNG load included)")
        say_kernel_a_forms(a)
        say_kernel_b_forms(b)
        faults += [m for ok, m in (
            (same, "segmented flagship differs from the single run"),
            (a == a_flag, f"segmented flagship kernel A {a}, single {a_flag}"),
            (b == b_flag, f"segmented flagship kernel B {b}, single {b_flag}"),
            (a["cluster"] == a["calls"] > 0 and kernel_b_cooperative(b),
             f"segmented flagship: kernel A {a}, kernel B {b}"),
            (times_ok(seg), "segmented flagship times")) if not ok]
        out["flagship"] = dict(same=same, wall_ms=wall, kernel_a=a,
                               kernel_b=b)
        for name, learn, kw, watch in (
                ("tgv", tgv.scalar_bilevel_tgv_learn, tgv_learn_kwargs(),
                 watch_tgv),
                ("tvl1", tvl1.scalar_bilevel_tvl1_learn,
                 tvl1_learn_kwargs(), watch_tvl1),
                ("vtv", vtv.scalar_bilevel_vtv_learn, vtv_learn_kwargs(),
                 watch_vtv)):
            kw = dict(kw, maxiter=3)
            runs = []
            for log_every in (None, 2):
                with watch() as calls:
                    t0 = time.perf_counter()
                    res = learn(device="cuda", log_every=log_every, **kw)
                    wall = (time.perf_counter() - t0) * 1e3
                runs.append((res, calls, wall))
            (one, c1, w1), (seg, c2, w2) = runs
            same = same_run(seg, one)
            say(f"  {name} log_every=2: x {np.asarray(seg.x).tolist()}, "
                f"{seg.iterations} outer its, bit for bit: {same}; CP "
                f"kernel calls {len(c2)} (single run {len(c1)}), the same "
                f"iterations and device operations: {c1 == c2}, all in the "
                f"cluster form: {all(c['cluster'] for c in c1 + c2)}; wall "
                f"{w2:.1f} ms (single run {w1:.1f})")
            faults += [m for ok, m in (
                (same, f"segmented {name} differs from the single run"),
                (c1 == c2 and c1 and all(c["cluster"] for c in c1 + c2),
                 f"segmented {name} CP calls {c2}, single {c1}"),
                (times_ok(seg), f"segmented {name} times")) if not ok]
            out[name] = dict(same=same, calls=len(c2), wall_ms=w2,
                             single_wall_ms=w1)
    finally:
        restore()
    say(f"  plain-version calls {len(plain)}")
    if plain:
        faults.append(f"phase 49: {len(plain)} plain-version calls")
    out["faults"] = faults
    return out


def phase_resume(flagship, a_flag, tr_whole):
    """Phase 50: the flagship tr_fused learn stopped after 4 iterations with
    a checkpoint, then resumed to the whole budget; the float64 default
    call (method="tr") stopped at 3 and resumed.  Each resumed α against
    the uninterrupted learn's (phase 5, phase 41); the resumed log's first
    rows equal to the checkpoint's; the resumed run alone evaluating from
    the checkpoint's iteration on (kernels A and B once an evaluation,
    fewer calls than the uninterrupted learn's)."""
    import numpy as np
    from bpldenoising_tpu_torch.experiments import api
    from bpldenoising_tpu_torch.utils import load_checkpoint
    faults, out = [], {}
    path = os.path.join("output", "faces_train_128_10",
                        "tv_optimal_parameter_scalar_faces_train_128_10"
                        "_ckpt.npz")
    for label, kw, stop, whole, whole_calls in (
            ("tr_fused", flagship_kwargs(), 4, float(flagship.x),
             a_flag["calls"]),
            ("tr", dict(dataset_name="faces_train", num_samples=10), 3,
             tr_whole["alpha"], tr_whole["counts"]["kernel_a"]["calls"])):
        with in_scratch_dir():
            plain, restore = watch_plain(cp=True)
            try:
                t0 = time.perf_counter()
                api.scalar_bilevel_tv_learn(device="cuda", checkpoint=True,
                                            **dict(kw, maxiter=stop))
                ckpt = load_checkpoint(path)
                reset_launches()
                t1 = time.perf_counter()
                res = api.scalar_bilevel_tv_learn(device="cuda", resume=True,
                                                  **kw)
                t2 = time.perf_counter()
                a, b = kernel_a_forms(), kernel_b_forms()
            finally:
                restore()
        iters = [e.iter for e in res.state.log]
        rows = np.asarray([[e.iter, e.time, e.function_value, e.g_norm,
                            e.delta, e.step_norm]
                           for e in res.state.log[:stop]])
        kept = bool(np.array_equal(rows, ckpt["log"]))
        evals = res.iterations - stop + 1
        gate = RESUME_GATE_REL[label]
        d_rel = abs(float(res.x) - whole) / abs(whole)
        say(f"  {label}: checkpoint at iteration {int(ckpt['iteration'])} "
            f"(log {ckpt['log'].shape[0]} rows, B {ckpt['B'].shape}); "
            f"resumed alpha {float(res.x)!r}, uninterrupted {whole!r}, rel "
            f"{d_rel:.3e} (gate {gate:g}); {res.iterations} outer its, log "
            f"iterations {iters}, its first {stop} rows the checkpoint's: "
            f"{kept}; the resumed run {evals} evaluations (uninterrupted "
            f"{whole_calls}); stopped run {(t1 - t0) * 1e3:.1f} ms, resumed "
            f"{(t2 - t1) * 1e3:.1f} ms (host clock); plain-version calls "
            f"{len(plain)}")
        say_kernel_a_forms(a)
        say_kernel_b_forms(b)
        faults += [m for ok, m in (
            (d_rel <= gate, f"resumed {label} alpha {res.x}"),
            (iters == list(range(1, len(iters) + 1)),
             f"resumed {label} log iterations {iters}"),
            (int(ckpt["iteration"]) == stop and kept,
             f"resumed {label}: checkpoint iteration {ckpt['iteration']}, "
             f"its rows kept {kept}"),
            (a["calls"] == b["calls"] == evals < whole_calls,
             f"resumed {label}: kernel A {a['calls']}, B {b['calls']} calls "
             f"for {evals} evaluations (uninterrupted {whole_calls})"),
            (a["cluster"] == a["calls"] > 0 and kernel_b_cooperative(b)
             and not plain,
             f"resumed {label}: kernel A {a}, kernel B {b}, plain "
             f"{len(plain)}")) if not ok]
        out[label] = dict(alpha=float(res.x), alpha_rel_err=d_rel,
                          checkpoint_iteration=int(ckpt["iteration"]),
                          outer_iterations=res.iterations,
                          resumed_evaluations=evals,
                          stopped_ms=(t1 - t0) * 1e3,
                          resumed_ms=(t2 - t1) * 1e3)
    out["faults"] = faults
    return out


def phase_trace():
    """Phase 51: the flagship learn through the CLI with --trace DIR (and
    the same call untraced before it): the Chrome trace names kernel A's
    cluster kernel (pdc_cp, one launch an early-stop chunk) and kernel B's
    (hg_coop, one launch a call) as often as the wrappers launched
    them."""
    import io
    import json
    from bpldenoising_tpu_torch.__main__ import main as cli
    from bpldenoising_tpu_torch.learning import tv as learning_tv
    chunks = []
    real = learning_tv.denoise_pdps_cuda

    def watched(*args, **kw):
        out = real(*args, **kw)
        iters, every = int(out[2]), int(kw["check_every"])
        chunks.append(-(-iters // every) if kw.get("tol") is not None
                      else int(iters > 0))
        return out

    argv = ["scalar-tv", "--dataset", "faces_train", "--num-samples", "10",
            "--method", "tr_fused", "--dtype", "float32", "--inner-tol",
            "5e-6", "--trace", "trace"]
    with in_scratch_dir():
        # the same call untraced first: what the profiler adds
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            cli(argv[:-2])
        untraced = (time.perf_counter() - t0) * 1e3
        learning_tv.denoise_pdps_cuda = watched
        try:
            reset_launches()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()) as printed:
                cli(argv)
            wall = (time.perf_counter() - t0) * 1e3
            a, b = kernel_a_forms(), kernel_b_forms()
        finally:
            learning_tv.denoise_pdps_cuda = real
        size = os.path.getsize("trace/trace.json")
        with open("trace/trace.json") as fh:
            events = json.load(fh)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    names = sorted({e.get("name", "") for e in kernels})
    n_a = sum("pdc_cp" in e.get("name", "") for e in kernels)
    n_b = sum("hg_coop" in e.get("name", "") for e in kernels)
    busy = sum(float(e.get("dur", 0.0)) for e in kernels) / 1e3
    say(f"  python -m bpldenoising_tpu_torch {' '.join(argv)}: "
        f"{printed.getvalue().strip().splitlines()[-1:]} in {wall:.1f} ms "
        f"(host clock, traced; the process's first profiler start "
        f"included), {untraced:.1f} ms untraced; trace.json {size} bytes, "
        f"{len(events)} events, {len(kernels)} kernel events ({busy:.1f} "
        f"ms on the device)")
    say(f"  pdc_cp launches in the trace {n_a}, early-stop chunks of "
        f"kernel A's {a['calls']} calls {sum(chunks)}; hg_coop launches "
        f"in the trace {n_b}, kernel B calls {b['calls']}, launches "
        f"{b['kernel_launches']}")
    say(f"  kernels named: {[n[:60] for n in names][:12]}")
    faults = [m for ok, m in (
        (n_a == sum(chunks) > 0 and len(chunks) == a["calls"]
         == a["cluster"],
         f"trace: pdc_cp {n_a}, chunks {sum(chunks)}, kernel A {a}"),
        (n_b == b["calls"] == b["kernel_launches"] > 0,
         f"trace: hg_coop {n_b}, kernel B {b}")) if not ok]
    return dict(pdc_cp=n_a, chunks=sum(chunks), hg_coop=n_b,
                kernel_a=a, kernel_b=b, kernel_events=len(kernels),
                device_ms=busy, wall_ms=wall, untraced_ms=untraced,
                faults=faults)


# name: (dataset, images, color, weights, (maxiter, CG cap, smoothing γ or
# None: the layer's default) of the gradient comparison, (maxiter, CG cap,
# γ) of the float64 difference check).
# The comparison's TV-family backward runs at γ = 1e4: at the default 1e8
# and a 2000-capped CG its f-gradient moved by 56% under a 1.9e-15 move of
# u in float64 (PR 24's chip call 22), a system no forward can be held to.
# The difference check runs on the DIFF_FD_CROP² centre of the first image,
# each forward to convergence and each CG converged below its cap (on the
# CPU in float64: TV 2,747 CG iterations, the sum 2,760, TGV² 3,126, VTV
# 1,533, TV-L1 105); at 128² the TV and sum CGs ran to their 12,000 and
# 10,000 caps, 44 s of the card's time (chip call 25).  TGV² and VTV run at
# a smoothing threshold below their default 1e-4, which leaves the flat
# regions of the Hessian soft (3.6e-3 for TGV², 4.9e-4 for VTV at 32² in
# float64 on the CPU; 3.5e-3 and 6.3e-2 at 128², the JAX layers' gradients
# the same).
DIFF_LAYERS = {
    "tv": ("faces_train_128_10", 10, False, (0.07,), (300, 2000, 1e4),
           (20000, 6000, None)),
    "sumregs": ("faces_train_128_10", 10, False, (0.035, 0.032, 0.005),
                (300, 2000, 1e4), (20000, 6000, None)),
    "tgv": ("faces_train_128_10", 10, False, (0.085, 0.044),
            (300, 300, None), (20000, 6000, 3e-6)),
    "tvl1": ("circle_sp_128_20", 1, False, (1.92,), (300, 2000, None),
             (100000, 5000, None)),
    "vtv": ("color_disks_128_10", 6, True, (0.165,), (300, 300, None),
            (20000, 5000, 1e-5)),
}
DIFF_FD_CROP = 32
DIFF_FD_GATE_REL = 2e-3       # the JAX test's rtol (tests/test_implicit.py)


def diff_layer(name, maxiter, cg_maxiter, gamma=None):
    """The family's differentiable layer ``(f, *weights) -> u`` (``gamma``:
    the backward's smoothing, None for the layer's default) and the module
    whose kernel runs its forward on the card."""
    from bpldenoising_tpu_torch.models import sumregs_model, tv_model
    from bpldenoising_tpu_torch.solvers import (implicit, pdps_cuda, tgv,
                                                tgv_cuda, tvl1_cuda,
                                                tvl1_huber, vtv, vtv_cuda)
    from bpldenoising_tpu_torch.solvers.hypergrad import HypergradConfig
    kw = {} if gamma is None else dict(gamma=gamma)
    if name in ("tv", "sumregs"):
        layer = implicit.make_diff_denoise(
            tv_model() if name == "tv" else sumregs_model(), maxiter=maxiter,
            cfg=HypergradConfig(cg_maxiter=cg_maxiter, **kw))
        return (lambda f, *a: layer(f, a)), pdps_cuda
    if name == "tgv":
        layer = tgv.make_diff_tgv_denoise(maxiter=maxiter,
                                          cg_maxiter=cg_maxiter, **kw)
        return (lambda f, *a: layer(f, a)), tgv_cuda
    if name == "tvl1":
        return (tvl1_huber.make_diff_tvl1_denoise(
            maxiter=maxiter, cg_maxiter=cg_maxiter, **kw), tvl1_cuda)
    return (vtv.make_diff_vtv_denoise(maxiter=maxiter,
                                      cg_maxiter=cg_maxiter, **kw), vtv_cuda)


@contextlib.contextmanager
def plain_forward(name):
    """The layer's forward solve replaced by its kernel's plain version on
    the card's tensors (the wrappers run it only for CPU tensors); the
    backward is untouched."""
    import torch
    from bpldenoising_tpu_torch.solvers import (implicit, pdps, tgv,
                                                tgv_cuda, tvl1_cuda,
                                                tvl1_huber, vtv)
    if name in ("tv", "sumregs", "vtv"):
        mod, attr = (vtv, "denoise_pdps") if name == "vtv" \
            else (implicit, "denoise_pdps")

        def solve(f, alphas, model, *, tau0=5.0, sigma0=0.99 / 5.0,
                  maxiter, tol=None, check_every=500):
            a = tuple(torch.as_tensor(x, dtype=f.dtype)
                      for x in model.canonical_alphas(alphas))
            return pdps._denoise_pdps_impl(
                f, a, None, model=model, tau0=tau0, sigma0=sigma0, gamma=1.0,
                maxiter=maxiter, accel=True, tol=tol,
                check_every=check_every, return_dual=False)
    elif name == "tgv":
        mod, attr = tgv, "tgv_denoise_pdps"

        def solve(f, a1, a0, *, tau0, sigma0, maxiter, tol, check_every):
            u, w, _ = tgv._tgv_impl(
                f, tgv_cuda._weight(a1, f, "alpha1"),
                tgv_cuda._weight(a0, f, "alpha0"), None, tau0=tau0,
                sigma0=sigma0, maxiter=maxiter, tol=tol,
                check_every=check_every, return_state=False)
            return u, w
    else:
        mod, attr = tvl1_huber, "tvl1_huber_denoise"

        def solve(f, alpha, *, gamma_d, gamma_r, tau0, sigma0, maxiter, tol,
                  check_every):
            tau, sigma = tvl1_cuda.step_sizes(tau0, sigma0, f.dtype)
            u, _, _ = tvl1_huber._tvl1_huber_loop(
                f, tvl1_cuda._weight(alpha, f), None, gamma_d=gamma_d,
                gamma_r=gamma_r, tau=tau, sigma=sigma, maxiter=maxiter,
                tol=tol, check_every=check_every)
            return u
    real = getattr(mod, attr)
    setattr(mod, attr, solve)
    try:
        yield
    finally:
        setattr(mod, attr, real)


@contextlib.contextmanager
def cg_counts():
    """Record the iterations of every adjoint CG the layers' backwards
    run."""
    from bpldenoising_tpu_torch.solvers import implicit, tgv, tvl1_huber, vtv
    iters, saved = [], []
    for mod in (implicit, tgv, tvl1_huber, vtv):
        for attr in ("cg", "cg_batched"):
            if hasattr(mod, attr):
                real = getattr(mod, attr)

                def watched(*args, _real=real, **kw):
                    x, info = _real(*args, **kw)
                    iters.append(int(info.iters))
                    return x, info
                saved.append((mod, attr, real))
                setattr(mod, attr, watched)
    try:
        yield iters
    finally:
        for mod, attr, real in saved:
            setattr(mod, attr, real)


def diff_inputs(name, dtype):
    """(f, ū, weights) on the card for the layer ``name``."""
    import torch
    from bpldenoising_tpu_torch.data import testdataset
    ds, count, color, weights = DIFF_LAYERS[name][:4]
    true_, noisy = testdataset(ds, color=color)
    dt = getattr(torch, dtype)
    return (torch.as_tensor(noisy[:count], dtype=dt).cuda(),
            torch.as_tensor(true_[:count], dtype=dt).cuda(),
            [torch.tensor(a, dtype=dt) for a in weights])


def phase_diff_layers():
    """Phase 52: the five differentiable layers at full width, float32 and
    float64: the forward bit for bit against the public denoiser, every
    forward in its kernel's cluster form and no plain call; the gradients
    of ½‖u − ū‖² (f and every weight) against the same backward on the
    plain forward; the float64 f-gradient against central differences on
    the DIFF_FD_CROP² centre of the first image; each layer's forward and
    backward walls and CG iterations."""
    import numpy as np
    import torch
    from bpldenoising_tpu_torch.solvers import (denoise_pdps,
                                                tgv_denoise_pdps,
                                                tvl1_huber_denoise)
    from bpldenoising_tpu_torch.models import sumregs_model, tv_model
    from bpldenoising_tpu_torch.models import vtv_model
    public = {
        "tv": lambda f, m, a: denoise_pdps(f, (a,), tv_model(), maxiter=m),
        "sumregs": lambda f, m, *a: denoise_pdps(f, a, sumregs_model(),
                                                 maxiter=m),
        "tgv": lambda f, m, a1, a0: tgv_denoise_pdps(f, a1, a0,
                                                     maxiter=m)[0],
        "tvl1": lambda f, m, a: tvl1_huber_denoise(f, a, gamma_r=1000.0,
                                                   maxiter=m),
        "vtv": lambda f, m, a: denoise_pdps(f, (a,), vtv_model(), maxiter=m),
    }
    faults, out = [], {}

    def run(layer, f, ut, w):
        """→ (u, grads, forward ms, backward ms, CG iterations)."""
        inputs = [f.clone().requires_grad_(True)] + [
            a.clone().requires_grad_(True) for a in w]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        u = layer(*inputs)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        with cg_counts() as cgs:
            grads = torch.autograd.grad(0.5 * torch.sum((u - ut) ** 2),
                                        inputs)
            torch.cuda.synchronize()
        t2 = time.perf_counter()
        return (u.detach(), grads, (t1 - t0) * 1e3, (t2 - t1) * 1e3,
                sum(cgs))

    for name, spec in DIFF_LAYERS.items():
        (m, cgm, gamma), (m_fd, cgm_fd, gamma_fd) = spec[4:]
        for dtype in ("float32", "float64"):
            f, ut, w = diff_inputs(name, dtype)
            layer, kmod = diff_layer(name, m, cgm, gamma)
            plain, restore = watch_plain(cp=True)
            try:
                reset_launches()
                u, grads, fwd_ms, bwd_ms, cg_its = run(layer, f, ut, w)
                calls, cluster = kmod.launches, kmod.cluster_calls
                reset_launches()
                ref = public[name](f, m, *w)
            finally:
                restore()
            same = torch.equal(u, ref)
            with plain_forward(name):
                up, pgrads, pfwd_ms, pbwd_ms, pcg = run(layer, f, ut, w)
            errs = [float((g - p).abs().max() / p.abs().max())
                    for g, p in zip(grads, pgrads)]
            gate = DIFF_GRAD_GATE[dtype][name]
            say(f"  {name} {dtype} {tuple(f.shape)} maxiter {m}, CG cap "
                f"{cgm}, gamma {gamma or 'default'}: forward "
                f"{fwd_ms:.1f} ms ({calls} kernel calls, {cluster} cluster, "
                f"plain calls {len(plain)}), = public denoiser bit for bit: "
                f"{same}; backward {bwd_ms:.1f} ms, {cg_its} CG its; plain "
                f"forward {pfwd_ms:.1f} ms, |u - u_plain| "
                f"{float((u - up).abs().max()):.2e}, its backward {pcg} CG "
                f"its; grad rel errs (f, weights) "
                f"{[f'{e:.2e}' for e in errs]} (gate {gate:g})")
            faults += [msg for ok, msg in (
                (same, f"{name} {dtype}: layer forward != public denoiser"),
                (calls == cluster == 1 and not plain,
                 f"{name} {dtype}: {calls} calls, {cluster} cluster, plain "
                 f"{len(plain)}"),
                (max(errs) <= gate, f"{name} {dtype} grads {errs}"))
                if not ok]
            out[f"{name}_{dtype}"] = dict(
                forward_ms=fwd_ms, backward_ms=bwd_ms, cg_iters=cg_its,
                plain_forward_ms=pfwd_ms, grad_rel_err=errs, same=same)
        # float64: the f-gradient against central differences on the
        # centre of the first image, the forward run to convergence
        f, ut, w = diff_inputs(name, "float64")
        o = (f.shape[-1] - DIFF_FD_CROP) // 2
        f, ut = (x[:1, ..., o:o + DIFF_FD_CROP, o:o + DIFF_FD_CROP]
                 .contiguous() for x in (f, ut))
        layer, _ = diff_layer(name, m_fd, cgm_fd, gamma_fd)
        _, (g, *_), fwd_ms, bwd_ms, cg_its = run(layer, f, ut, w)
        d = torch.as_tensor(np.random.default_rng(8).standard_normal(
            tuple(f.shape)), dtype=f.dtype, device=f.device)
        h = 1e-5

        def loss(x):
            with torch.no_grad():
                return float(0.5 * torch.sum((layer(x, *w) - ut) ** 2))

        fd = (loss(f + h * d) - loss(f - h * d)) / (2 * h)
        ad = float(torch.sum(g * d))
        rel = abs(ad - fd) / abs(fd)
        say(f"  {name} float64 {tuple(f.shape)} maxiter {m_fd}, CG cap "
            f"{cgm_fd}, gamma {gamma_fd or 'default'}: <grad_f, d> "
            f"{ad!r}, central difference {fd!r}, rel {rel:.2e} (gate "
            f"{DIFF_FD_GATE_REL:g}); forward {fwd_ms:.1f} ms, backward "
            f"{bwd_ms:.1f} ms, {cg_its} CG its")
        if not rel <= DIFF_FD_GATE_REL:
            faults.append(f"{name} f-gradient off central differences by "
                          f"{rel}")
        if not cg_its < cgm_fd:
            faults.append(f"{name} difference check: the CG ran to its cap "
                          f"{cgm_fd}")
        out[f"{name}_fd"] = dict(rel_err=rel, forward_ms=fwd_ms,
                                 backward_ms=bwd_ms, cg_iters=cg_its)
    out["faults"] = faults
    return out


# ---------------------------------------------------------------------------
# Phases 53-56: the parallel tier (meshes of shards on the one card)
# ---------------------------------------------------------------------------

# phases 59-61: a single-loop learner over shards of the card against its
# unsharded run in float64, relative in α (the JAX mesh tests' rtol; only
# the order of the cross-shard sums of the gradient maps and the cost
# differs)
SLX_MESH_F64 = 1e-8
MESH_SHARDS = 4          # phase 53: the flagship's ten images over 4 shards
SMOOTH_MESH_SHARDS = 2   # phase 55: the fused TGV², TV-L1, VTV learns
HALO_ITERS = 300         # phase 56: each halo solve's fixed budget
HALO_TOL_REL = 1e-4      # phase 56: float32, halo solver against the kernel
# phase 54: a sharded evaluation of 3 images over 4 shards (one all
# padding) against the same 3 images over 3 shards: the shards hold the
# same images, so the padding shard's u = 0 and its +0 to the cost and the
# gradient leave every bit as it was.  The 3-over-3 result is then held
# against the unsharded learning function: u and the cost to
# SHARDED_U_GATE / SHARDED_COST_GATE_REL (the same forward kernels per
# image), the gradient to SHARDED_GRAD_RTOL, the JAX test's GRAD_RTOL
# (per-shard against joint Krylov spaces, tests/test_parallel.py:21-28).
# The TV-family adjoint is the CPU tests' well-conditioned one (act_tol
# 1e-3, gamma 1e3, CG to 1e-10): a CG stopped at its cap leaves the two
# Krylov spaces 1e-2 apart (the CPU float64 plain versions at cg_maxiter
# 200 read 1.7e-2 for TV, 1.6e-2 for the sum; converged, 8e-11 / 1e-8).
SHARDED_TV_CFG = dict(act_tol=1e-3, gamma=1e3, al_iters=2, cg_tol=1e-10,
                      cg_maxiter=1000)
SHARDED_CALLS = dict(
    tv=dict(maxiter=1000, cfg=SHARDED_TV_CFG),
    sumregs=dict(maxiter=1000, cfg=SHARDED_TV_CFG),
    tgv=dict(maxiter=500, cg_maxiter=200),
    vtv=dict(maxiter=500, cg_maxiter=200),
    tvl1=dict(maxiter=1000, cg_maxiter=200))
SHARDED_U_GATE = 1e-10
SHARDED_COST_GATE_REL = 1e-10
SHARDED_GRAD_RTOL = 2e-4
# phase 55: the mesh learn against the same learn unsharded, (x, cost)
# relative: 4-85 times the gaps read on an H100 80GB HBM3 at 700 W (TGV²
# 7.1e-7 / 1.2e-7, VTV 9.8e-6 / 2.5e-5, TV-L1 on three images 7.5e-5 /
# 1.8e-5; a run repeats its digits).  The gaps come from the adjoint CGs:
# a shard's CG stops when its own images reach the CG's tolerance, the
# whole batch's iterates on until all do.
MESH_SMOOTH_GATES = dict(tgv=(1e-5, 1e-5), vtv=(1e-4, 1e-4),
                         tvl1=(5e-4, 1e-4))


def card_devices(n):
    """``n`` shards on the one card (the counterpart of XLA's virtual
    devices)."""
    return ["cuda:0"] * n


def card_mesh(n):
    from bpldenoising_tpu_torch.parallel import make_batch_mesh
    return make_batch_mesh(devices=card_devices(n))


def phase_mesh_flagship(utrue, f, flagship, timed):
    """Phase 53: bilevel_learn_fused at the bench settings over
    MESH_SHARDS shards on the card (10 images pad to 12: the last shard
    holds one image and two zero images), gated as phase 5; kernels A and
    B launched shards × evaluations times, all in the cluster /
    cooperative form, no plain call; then the entry point with
    data_parallel=True on the default mesh (one card, one shard) against
    phase 5 bit for bit."""
    import numpy as np
    import torch
    from bpldenoising_tpu_torch.bilevel.fused import bilevel_learn_fused
    from bpldenoising_tpu_torch.experiments import api
    from bpldenoising_tpu_torch.metrics import psnr

    kw = flagship_kwargs()
    lkw = dict(xinit=kw["alpha0"],
               params=api.bilevel_params | dict(maxiter=kw["maxiter"],
                                                tol=kw["tol"]),
               inner_maxiter=kw["inner_maxiter"],
               inner_tol=kw["inner_tol"], check_every=kw["check_every"],
               cfg=kw["hypergrad_cfg"], delta_t=1e-6, device="cuda",
               mesh=card_mesh(MESH_SHARDS))
    bilevel_learn_fused((utrue, f), **lkw)              # warm-up
    unsharded = dict(lkw, mesh=None)
    bilevel_learn_fused((utrue, f), **unsharded)
    _, one_ms = timed(lambda: bilevel_learn_fused((utrue, f), **unsharded))
    plain, restore = watch_plain()
    try:
        reset_launches()
        res, wall_ms = timed(lambda: bilevel_learn_fused((utrue, f), **lkw))
        a, b = kernel_a_forms(), kernel_b_forms()
    finally:
        restore()
    evals = res.iterations + 1
    alpha = float(res.x)
    d_alpha = abs(alpha - FLAGSHIP_ALPHA)
    mean_psnr = float(torch.mean(psnr(utrue, res.u)))
    cost = float(res.cost)
    say(f"  {MESH_SHARDS} shards: alpha {alpha:.6f} |d| {d_alpha:.2e} "
        f"(gate {ALPHA_GATE:g}); PSNR {mean_psnr:.4f} dB; cost {cost:.4f}; "
        f"{res.iterations} outer its ({evals} evaluations); wall "
        f"{wall_ms:.1f} ms against {one_ms:.1f} ms unsharded (the same "
        "library call on the same tensors; CUDA events, after one warm-up "
        "run each)")
    say_kernel_a_forms(a)
    say_kernel_b_forms(b)
    require(a["calls"] == MESH_SHARDS * evals == a["cluster"],
            f"kernel A: {a['calls']} calls ({a['cluster']} cluster), want "
            f"{MESH_SHARDS} x {evals}")
    require(b["calls"] == MESH_SHARDS * evals and kernel_b_cooperative(b),
            f"kernel B: {b}, want {MESH_SHARDS} x {evals} cooperative")
    require(not plain, f"plain versions called: {sorted(set(plain))}")
    require(tuple(res.u.shape) == tuple(utrue.shape)
            and bool(torch.isfinite(res.u).all()), "mesh u")
    require(d_alpha <= ALPHA_GATE, f"mesh alpha {alpha} off by {d_alpha}")
    require(abs(mean_psnr - FLAGSHIP_PSNR) <= PSNR_GATE,
            f"mesh mean PSNR {mean_psnr}")
    require(abs(cost - FLAGSHIP_COST) <= COST_GATE_REL * FLAGSHIP_COST,
            f"mesh cost {cost}")
    reset_launches()
    one = api.scalar_bilevel_tv_learn(device="cuda", data_parallel=True,
                                      **kw)
    a1 = kernel_a_forms()
    same = (np.array_equal(one.x, flagship.x) and one.cost == flagship.cost
            and np.array_equal(one.u, flagship.u)
            and one.iterations == flagship.iterations)
    cards = torch.cuda.device_count()
    say(f"  data_parallel=True on the default mesh ({cards} card, one "
        f"shard): alpha {float(one.x)!r} against phase 5's "
        f"{float(flagship.x)!r}, bit for bit: {same}; kernel A "
        f"{a1['calls']} calls")
    require(same, "the one-shard mesh learn is not phase 5's, bit for bit")
    return dict(shards=MESH_SHARDS, alpha=alpha, alpha_abs_err=d_alpha,
                mean_psnr_db=mean_psnr, final_cost=cost,
                outer_iterations=res.iterations, wall_ms=wall_ms,
                unsharded_wall_ms=one_ms, kernel_a=a, kernel_b=b,
                one_shard_bit_for_bit=same)


def sharded_inputs(name, n):
    """The first ``n`` images of a family's dataset, float64 on the card
    (TV-L1: circle_sp's one image and its mirror images)."""
    import numpy as np
    import torch
    from bpldenoising_tpu_torch.data import testdataset
    if name == "vtv":
        t, d = testdataset("color_disks_128_10", color=True)
    elif name == "tvl1":
        t, d = (mirrored(torch.as_tensor(a))
                for a in testdataset("circle_sp_128_20"))
    else:
        t, d = testdataset("faces_train_128_10")
    return tuple(torch.as_tensor(np.ascontiguousarray(a[:n]),
                                 dtype=torch.float64).cuda() for a in (t, d))


def mirrored(a):
    """circle_sp's one image and its two mirror images, (3, M, N)."""
    import torch
    return torch.cat([a, a.flip(-2), a.flip(-1)])


def sharded_function(name, n):
    from bpldenoising_tpu_torch import parallel as par
    from bpldenoising_tpu_torch.solvers.hypergrad import HypergradConfig
    kw = dict(SHARDED_CALLS[name])
    if "cfg" in kw:
        kw["cfg"] = HypergradConfig(**kw["cfg"])
    make = getattr(par, f"make_sharded_{name}_learning_function")
    return make(card_mesh(n), **kw)


def phase_mesh_tr():
    """Phase 54: (a) scalar_bilevel_tv_learn and scalar_bilevel_sumregs_learn
    with method='tr' and data_parallel=True (the sharded learning
    functions on the default mesh), float64, 3 outer its, against the same
    learns unsharded; (b) each of the five sharded learning functions on 3
    images over 4 shards against 3 over 3, and 3 over 3 against the
    unsharded learning function of its family."""
    import numpy as np
    import torch
    from bpldenoising_tpu_torch import learning
    from bpldenoising_tpu_torch.bilevel import trust_region
    from bpldenoising_tpu_torch.experiments import api
    from bpldenoising_tpu_torch.solvers.hypergrad import HypergradConfig

    out = {}
    for name, learn in (("tv", api.scalar_bilevel_tv_learn),
                        ("sumregs", api.scalar_bilevel_sumregs_learn)):
        kw = dict(dataset_name="faces_train", num_samples=10, maxiter=3,
                  device="cuda")
        reset_launches()
        reads = trust_region.host_reads
        dp = learn(data_parallel=True, **kw)
        a, b = kernel_a_forms(), kernel_b_forms()
        evals = trust_region.host_reads - reads
        one = learn(**kw)
        d_x = float(np.max(np.abs(np.asarray(dp.x) - np.asarray(one.x)))
                    / np.max(np.abs(np.asarray(one.x))))
        d_c = abs(dp.cost - one.cost) / abs(one.cost)
        say(f"  {name} tr data_parallel: x {np.ravel(dp.x).tolist()} "
            f"against unsharded {np.ravel(one.x).tolist()}: rel {d_x:.2e}, "
            f"cost rel {d_c:.2e}; {evals} evaluations, kernel A "
            f"{a['calls']} calls ({a['cluster']} cluster), kernel B "
            f"{b['calls']}")
        require(d_x <= 1e-10 and d_c <= 1e-10,
                f"{name}: sharded tr off the unsharded run")
        require(a["calls"] == b["calls"] == evals > 0
                and a["cluster"] == a["calls"] and kernel_b_cooperative(b),
                f"{name}: kernel counts {a}, {b} for {evals} evaluations")
        out[name] = dict(x_rel=d_x, cost_rel=d_c, evaluations=evals)
    x_of = dict(tv=0.07, sumregs=np.array([0.03, 0.03, 0.01]),
                tgv=np.array([0.085, 0.044]), vtv=np.asarray(0.165),
                tvl1=np.asarray(1.9))
    rows = dict(tgv="tgv", vtv="vtv", tvl1="tvl1")
    for name in ("tv", "sumregs", "tgv", "vtv", "tvl1"):
        ds = sharded_inputs(name, 3)
        res = {}
        for n in (3, 4):
            reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res[n] = sharded_function(name, n)(x_of[name], ds, 0.1)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            counts = read_launches()
        u, c, g = res[4]
        finite = all(bool(torch.isfinite(torch.as_tensor(t)).all())
                     for t in res[4])
        same = all(torch.equal(torch.as_tensor(p).cpu(),
                               torch.as_tensor(q).cpu())
                   for p, q in zip(res[4], res[3]))
        kern = (counts["pdps"], counts["hypergrad"]) if name in (
            "tv", "sumregs") else (counts[rows[name]],)
        say(f"  {name} sharded, 3 images over 4 shards (one all padding): "
            f"cost {float(c)!r}, finite {finite}, the bits of 3 over 3: "
            f"{same}; kernel calls {kern} (want 4 each); {ms:.1f} ms")
        require(finite and same, f"{name}: the padding shard is not "
                "exactly zero (or a value is not finite)")
        require(all(k == 4 for k in kern), f"{name}: kernel calls {kern}")
        kw = dict(SHARDED_CALLS[name])
        if "cfg" in kw:
            kw["cfg"] = HypergradConfig(**kw["cfg"])
        ur, cr, gr = getattr(learning, f"{name}_learning_function")(
            x_of[name], ds, 0.1, device="cuda", **kw)
        u3, c3, g3 = res[3]
        d_u = float(torch.max(torch.abs(u3 - ur)))
        d_c = abs(float(c3) - float(cr)) / abs(float(cr))
        g3, gr = (np.ravel(torch.as_tensor(g).cpu().numpy()) for g in (g3, gr))
        d_g = float(np.max(np.abs(g3 - gr)) / np.max(np.abs(gr)))
        say(f"  {name} 3 over 3 against the unsharded learning function: "
            f"u {d_u:.2e} (gate {SHARDED_U_GATE:g}), cost rel {d_c:.2e} "
            f"(gate {SHARDED_COST_GATE_REL:g}), gradient {g3.tolist()} "
            f"against {gr.tolist()}: rel {d_g:.2e} "
            f"(gate {SHARDED_GRAD_RTOL:g})")
        require(d_u <= SHARDED_U_GATE and d_c <= SHARDED_COST_GATE_REL
                and d_g <= SHARDED_GRAD_RTOL,
                f"{name}: sharded evaluation off the unsharded one")
        out[f"{name}_padding"] = dict(cost=float(c), bit_for_bit=same,
                                      kernel_calls=list(kern), ms=ms,
                                      unsharded_u_abs=d_u,
                                      unsharded_cost_rel=d_c,
                                      unsharded_grad_rel=d_g)
    return out


def phase_mesh_smoothed():
    """Phase 55: the fused TGV², TV-L1 and VTV learns (phases 8, 11, 15's
    float32 settings, cut to 3 outer its; TV-L1 on circle_sp and its two
    mirror images, so both shards hold real images and one a padding
    image) with data_parallel=True on SMOOTH_MESH_SHARDS shards of the
    card, against the same learns unsharded within MESH_SMOOTH_GATES;
    rows 4, 8 and 6 launched shards × evaluations times in the cluster
    form, no plain CP call."""
    import numpy as np
    from bpldenoising_tpu_torch.experiments import api, tgv, tvl1, vtv

    runs = dict(tgv=(tgv.scalar_bilevel_tgv_learn, tgv_learn_kwargs()),
                tvl1=(tvl1.scalar_bilevel_tvl1_learn, tvl1_learn_kwargs()),
                vtv=(vtv.scalar_bilevel_vtv_learn, vtv_learn_kwargs()))
    real_mesh, real_load = api.data_parallel_mesh, api._load

    def tvl1_load(params, device):
        return tuple(mirrored(a) for a in real_load(params, device))

    out = {}
    for name, (learn, kw) in runs.items():
        kw = dict(kw, maxiter=3, device="cuda")
        if name == "tvl1":
            api._load = tvl1_load
        try:
            api.data_parallel_mesh = (
                lambda device: card_mesh(SMOOTH_MESH_SHARDS))
            plain, restore = watch_plain(cp=True)
            try:
                reset_launches()
                t0 = time.perf_counter()
                dp = learn(data_parallel=True, **kw)
                ms = (time.perf_counter() - t0) * 1e3
                counts = read_launches()
            finally:
                restore()
                api.data_parallel_mesh = real_mesh
            one = learn(**kw)
        finally:
            api._load = real_load
        x_rel = float(np.max(np.abs(np.asarray(dp.x) - np.asarray(one.x))
                             / np.abs(np.asarray(one.x))))
        c_rel = abs(dp.cost - one.cost) / abs(one.cost)
        evals = dp.iterations + 1
        a_gate, c_gate = MESH_SMOOTH_GATES[name]
        say(f"  {name} on {SMOOTH_MESH_SHARDS} shards, {len(dp.u)} images: "
            f"x {np.ravel(dp.x).tolist()} against unsharded "
            f"{np.ravel(one.x).tolist()} (rel {x_rel:.2e}, gate "
            f"{a_gate:g}); cost rel {c_rel:.2e} (gate {c_gate:g}); "
            f"{dp.iterations} "
            f"outer its; {name} kernel {counts[name]} calls (want "
            f"{SMOOTH_MESH_SHARDS} x {evals}); plain CP calls {len(plain)}; "
            f"{ms:.1f} ms")
        require(x_rel <= a_gate and c_rel <= c_gate,
                f"{name}: mesh learn off its unsharded run")
        require(counts[name] == SMOOTH_MESH_SHARDS * evals,
                f"{name}: {counts[name]} kernel calls")
        require(not plain, f"{name}: plain calls {sorted(set(plain))}")
        require(np.all(np.isfinite(dp.u)), f"{name}: u not finite")
        out[name] = dict(x_rel=x_rel, cost_rel=c_rel, ms=ms,
                         kernel_calls=counts[name], evaluations=evals)
    return out


def halo_image(torch, shape, seed):
    """A disc under Gaussian noise, (…, M, N) float32 on the card."""
    g = torch.Generator().manual_seed(seed)
    M, N = shape[-2:]
    yy, xx = torch.meshgrid(torch.arange(M), torch.arange(N), indexing="ij")
    disc = (((yy - M / 2) ** 2 + (xx - N / 2) ** 2)
            < (min(M, N) / 3) ** 2).float()
    f = disc.expand(shape) + 0.1 * torch.randn(shape, generator=g)
    return f.contiguous().cuda()


def phase_halo():
    """Phase 56: the halo solvers (plain PyTorch on row blocks) row-sharded
    4 ways at 1×1024² (VTV 1×3×512²) and batch × rows 2 × 2 at 2×1024²
    (VTV 2×3×512²), HALO_ITERS iterations each, against the unsharded
    public denoisers (kernel A, the TGV² kernel, the VTV kernel, the TV-L1
    kernel) at the same budget without early stop; float32, within
    HALO_TOL_REL of the kernel's largest value."""
    import torch
    from bpldenoising_tpu_torch.models import sumregs_model, tv_model
    from bpldenoising_tpu_torch.parallel import halo
    from bpldenoising_tpu_torch.parallel.mesh import (ROWS_AXIS, Mesh,
                                                      make_batch_rows_mesh)
    from bpldenoising_tpu_torch.solvers import (denoise_pdps,
                                                tgv_denoise_pdps,
                                                tvl1_denoise, vtv_denoise)

    rows = Mesh(card_devices(4), (ROWS_AXIS,))
    grid = make_batch_rows_mesh(2, 2, card_devices(4))
    it = HALO_ITERS
    amap = 0.05 + 0.05 * torch.rand((1024, 1024),
                                    generator=torch.Generator().manual_seed(3))
    amap = amap.cuda()
    cases = dict(
        tv=(lambda f, m, b: (halo.denoise_pdps_batch_row_sharded if b else
                             halo.denoise_pdps_row_sharded)(
                                 f, (0.1,), tv_model(), m, maxiter=it),
            lambda f: denoise_pdps(f, (0.1,), tv_model(), maxiter=it), 2),
        sum3_map=(lambda f, m, b: (halo.denoise_pdps_batch_row_sharded if b
                                   else halo.denoise_pdps_row_sharded)(
                                       f, (amap, 0.03, 0.01), sumregs_model(),
                                       m, maxiter=it),
                  lambda f: denoise_pdps(f, (amap, 0.03, 0.01),
                                         sumregs_model(), maxiter=it), 2),
        tgv=(lambda f, m, b: (halo.tgv_denoise_pdps_batch_row_sharded if b
                              else halo.tgv_denoise_pdps_row_sharded)(
                                  f, 0.1, 0.2, m, maxiter=it)[0],
             lambda f: tgv_denoise_pdps(f, 0.1, 0.2, maxiter=it)[0], 2),
        vtv=(lambda f, m, b: (halo.vtv_denoise_pdps_batch_row_sharded if b
                              else halo.vtv_denoise_pdps_row_sharded)(
                                  f, 0.1, m, maxiter=it),
             lambda f: vtv_denoise(f, 0.1, maxiter=it), 3),
        tvl1=(lambda f, m, b: (halo.tvl1_denoise_batch_row_sharded if b
                               else halo.tvl1_denoise_row_sharded)(
                                   f, 0.4, m, maxiter=it),
              lambda f: tvl1_denoise(f, 0.4, maxiter=it), 2))
    out = {}
    for name, (sharded, kernel, ndim) in cases.items():
        side = 512 if name == "vtv" else 1024
        one_shape = (3, side, side) if ndim == 3 else (side, side)
        for label, mesh, batch in (("rows 4", rows, False),
                                   ("batch x rows 2x2", grid, True)):
            shape = ((2,) + one_shape) if batch else one_shape
            f = halo_image(torch, shape, seed=len(out))
            want = kernel(f)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = sharded(f, mesh, batch)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            err = rel_err(got, want)
            say(f"  {name} {label} {tuple(shape)}: max error {err:.2e} "
                f"relative (gate {HALO_TOL_REL:g}); {ms:.1f} ms, "
                f"{ms / it * 1e3:.1f} us an iteration")
            require(err <= HALO_TOL_REL and bool(torch.isfinite(got).all()),
                    f"halo {name} {label}: {err:.2e} from the kernel")
            out[f"{name} {label}"] = dict(max_rel_err=err, ms=ms,
                                          us_per_iter=ms / it * 1e3)
    return out


def phase_png_codec():
    """Phase 57: the PNG codec (data/native, built with g++ and zlib at
    first use): which codec runs (and a cold build's seconds into a
    temporary directory); every bundled PNG under datasets/ and images/
    decoded by it equal to the pure-Python reader bit for bit (gray ones
    as gray and as planar color, color ones as color); the decode ms of
    each for the flagship's 10 images (20 files, best of 3)."""
    import glob
    import os
    import tempfile

    import numpy as np
    from bpldenoising_tpu_torch.data import dataset_dir, native, png_io

    lib = native.library()
    cold_s = None
    if lib is not None:
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            native.build(os.path.join(tmp, "_build"))
            cold_s = time.perf_counter() - t0
        say(f"  codec: {native.backend} (a cold build takes {cold_s:.2f} s)")
    else:
        say(f"  codec: {native.backend}; the build failed: "
            f"{str(native.build_error)[-400:]}")
    root = os.path.dirname(os.path.abspath(__file__))
    files = sorted(glob.glob(os.path.join(root, "datasets", "*", "*.png"))
                   + glob.glob(os.path.join(root, "images", "*.png")))
    differ = []
    for path in files if lib is not None else []:
        with open(path, "rb") as fh:
            color = fh.read(26)[25] == 2
        pairs = [(png_io.read_png_color, png_io.read_png_color_python)]
        if not color:
            pairs.append((png_io.read_png_gray, png_io.read_png_gray_python))
        for built, python in pairs:
            a, b = built(path), python(path)
            if a.shape != b.shape or not np.array_equal(a, b):
                differ.append(os.path.relpath(path, root))
    flagship = os.path.join(dataset_dir, "faces_train_128_10")
    with open(os.path.join(flagship, "filelist.txt")) as fh:
        names = [n for line in fh for n in line.strip().split(",") if n]
    paths = [os.path.join(flagship, n) for n in names]

    def best_ms(read):
        best = None
        for _ in range(3):
            t0 = time.perf_counter()
            for path in paths:
                read(path)
            ms = (time.perf_counter() - t0) * 1e3
            best = ms if best is None else min(best, ms)
        return best

    built_ms = best_ms(png_io.read_png_gray)
    python_ms = best_ms(png_io.read_png_gray_python)
    say(f"  {len(files)} bundled PNGs, {len(differ)} differ from the "
        f"pure-Python reader; the flagship's {len(paths)} files: "
        f"{built_ms:.2f} ms with the {native.backend} codec, "
        f"{python_ms:.2f} ms in pure Python (best of 3, warm file cache)")
    require(not differ, f"the built codec differs on {differ}")
    require(len(files) >= 60, f"{len(files)} bundled PNGs")
    return dict(backend=native.backend, files=len(files),
                cold_build_s=cold_s, flagship_files=len(paths),
                decode_ms=built_ms, python_decode_ms=python_ms)


def phase_make_dataset(timed):
    """Phase 58: ``python -m bpldenoising_tpu_torch make-dataset`` (the
    128² circle phantom, σ 0.1, seed 0) into a temporary directory in a
    subprocess, read back through ``testdataset`` (the data equal the
    generator's arrays after 8-bit quantisation), then one scalar TV
    ``tr_fused`` learn on it on the card at the bench settings (5 outer
    its): kernels A and B launched, no plain call, α positive, PSNR above
    the noisy image's."""
    import os
    import tempfile

    import numpy as np
    import torch
    from bpldenoising_tpu_torch.data import (add_noise, circle_phantom,
                                             datasets, testdataset)
    from bpldenoising_tpu_torch.data.png_io import _quantise
    from bpldenoising_tpu_torch.experiments.api import \
        scalar_bilevel_tv_learn
    from bpldenoising_tpu_torch.metrics import psnr_np

    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [root] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    name = "smokecircle_128_10"
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "bpldenoising_tpu_torch", "make-dataset",
             name, "--out-root", tmp], capture_output=True, text=True,
            timeout=300, env=env)
        cli_s = time.perf_counter() - t0
        require(proc.returncode == 0,
                f"make-dataset exited {proc.returncode}: "
                f"{proc.stderr[-2000:]}")
        saved_dir = datasets.dataset_dir
        datasets.dataset_dir = tmp
        datasets.remotedatasets.append(name)
        try:
            true_, noisy = testdataset("smokecircle")
            clean = circle_phantom(128)
            want = _quantise(add_noise(clean, 0.1, np.random.default_rng(0))
                             ) * (1.0 / 255.0)
            require(true_.shape == (1, 128, 128)
                    and np.array_equal(true_[0], clean)
                    and np.array_equal(noisy[0], want),
                    "make-dataset's images differ from the generator's")
            plain, restore = watch_plain()
            try:
                reset_launches()
                res, ms = timed(lambda: scalar_bilevel_tv_learn(
                    device="cuda", **dict(flagship_kwargs(),
                                          dataset_name="smokecircle",
                                          num_samples=1, maxiter=5),
                    save_results=False))
                counts = read_launches()
            finally:
                restore()
        finally:
            datasets.dataset_dir = saved_dir
            datasets.remotedatasets.remove(name)
    out_psnr = psnr_np(true_, np.asarray(res.u))
    in_psnr = psnr_np(true_, noisy)
    say(f"  make-dataset {cli_s:.1f} s (subprocess); data = the generator's "
        f"quantised arrays; learn: alpha {float(res.x):.6f}, cost "
        f"{res.cost:.6f}, PSNR {out_psnr:.4f} dB (noisy {in_psnr:.4f}), "
        f"{res.iterations} outer its, {ms:.1f} ms; launches A "
        f"{counts['pdps']}, B {counts['hypergrad']}; plain calls "
        f"{len(plain)}")
    require(counts["pdps"] > 0 and counts["hypergrad"] > 0 and not plain,
            f"make-dataset learn: launches {counts}, plain {len(plain)}")
    require(float(res.x) > 0 and out_psnr > in_psnr + 3.0,
            f"make-dataset learn: alpha {res.x}, PSNR {out_psnr}")
    return dict(cli_s=cli_s, alpha=float(res.x), cost=float(res.cost),
                psnr_db=out_psnr, noisy_psnr_db=in_psnr, wall_ms=ms,
                launches=dict(pdps=counts["pdps"],
                              hypergrad=counts["hypergrad"]))


def slx_mesh_stack(torch, name, dtype):
    """The family's entry-point stack on the card: TGV² faces_train 10,
    VTV color_disks 6, TV-L1 circle_sp's image and three more of its clean
    image under add_impulse_noise (seeds 1–3), so that every shard of four
    holds a real image."""
    import numpy as np
    from bpldenoising_tpu_torch.data import add_impulse_noise, testdataset
    fam = slx_family(name)
    ds, color = fam["data"]
    true_np, noisy_np = testdataset(ds, color=color)
    n = int(fam["entry_kw"].get("num_samples", 1))
    true_np, noisy_np = true_np[:n], noisy_np[:n]
    if name == "tvl1":
        true_np = np.repeat(true_np, 4, axis=0)
        noisy_np = np.concatenate(
            [noisy_np] + [add_impulse_noise(true_np[0], 0.2, s)[None]
                          for s in (1, 2, 3)])
    return (torch.as_tensor(true_np, dtype=dtype).cuda(),
            torch.as_tensor(noisy_np, dtype=dtype).cuda())


def slx_mesh_run(name, utrue, f, shards, outer, log_every=None):
    """The family's library learner at 40 CP and 10 CG steps a step on
    ``shards`` shards of the card (or a mesh; None: unsharded), with the
    plain loop and stepper watched and the counters read: → (result, host
    ms a step, sessions, kernel launches, plain calls)."""
    import torch
    fam = slx_family(name)
    mod, cuda = fam["mod"], fam["cuda"]
    learn = getattr(mod, f"single_loop_{name}_learn")
    kw = dict(fam["kw"])
    if name == "tvl1":
        kw["gamma"] = kw.pop("gamma_r")
    with watch_slx_plain(name) as plain:
        s0, k0 = cuda.launches, cuda.kernel_launches
        mesh = card_mesh(shards) if isinstance(shards, int) else shards
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = learn(utrue, f, fam["x0"], outer=outer, n_inner=40, n_adj=10,
                    mesh=mesh, log_every=log_every, **kw)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
    return (res, ms / outer, cuda.launches - s0, cuda.kernel_launches - k0,
            len(plain))


def watch_slx_plain(name):
    """Count the calls of the family's plain single-loop learner and of
    its plain stepper (the mesh form's) within the block."""
    return watch_plain_calls(slx_family(name)["mod"],
                             (f"_single_loop_{name}_plain",
                              f"_{name}_plain_stepper"))


@contextlib.contextmanager
def watch_plain_calls(mod, attrs):
    """Count the calls of the functions ``attrs`` of ``mod`` within the
    block."""
    calls = []
    saved = {}
    for attr in attrs:
        saved[attr] = real = getattr(mod, attr)

        def watched(*a, real=real, **k):
            calls.append(1)
            return real(*a, **k)
        setattr(mod, attr, watched)
    try:
        yield calls
    finally:
        for attr, real in saved.items():
            setattr(mod, attr, real)


def phase_slx_mesh(name):
    """Phases 59-61: a family's single-loop learner with mesh=.  The
    entry point with data_parallel=True (the default mesh: one shard on
    one card) against the same call unsharded (float32, the entry point's
    300 steps); then the library learner on the entry point's stack over
    ["cuda:0"] * 2 and * 4 (30 steps of 40 CP and 10 CG steps): float64
    within SLX_MESH_F64 relative in α of the unsharded run, float32 within
    the family's kernel-against-plain band (TOL_SLX_REL_F32); sessions =
    shards (and per segment with log_every), kernel launches = shards ×
    (steps × launches_per_step + segments), no plain call; an all-padding
    shard adds exactly +0 (TV-L1: one image over two shards, VTV: six over
    four shards against over three, bit for bit); the host ms per outer
    step beside the unsharded form's."""
    import numpy as np
    import torch
    from bpldenoising_tpu_torch.experiments import api

    fam = slx_family(name)
    cuda = fam["cuda"]
    out = {}
    kw = dict(fam["entry_kw"], dtype="float32", method="single_loop",
              save_results=False)
    with watch_slx_plain(name) as plain:
        reset_launches()
        dp = fam["entry"](device="cuda", data_parallel=True, **kw)
        counts = read_launches()
    one = fam["entry"](device="cuda", **kw)
    key = f"single_loop_{name}"
    same = bool(np.array_equal(dp.x, one.x) and np.array_equal(dp.u, one.u))
    x_rel = float(np.max(np.abs(np.asarray(dp.x) - np.asarray(one.x))
                         / np.abs(np.asarray(one.x))))
    say(f"  entry point data_parallel=True on {api.data_parallel_mesh('cuda')}"
        f": x {np.ravel(dp.x).tolist()} against unsharded "
        f"{np.ravel(one.x).tolist()} (rel {x_rel:.2e}; bit for bit: {same});"
        f" sessions {counts[key]}; plain calls {len(plain)}")
    require(counts[key] > 0 and not plain and x_rel <= TOL_SLX_REL_F32[name],
            f"{name}: data_parallel entry point {counts}, {x_rel}")
    out["entry_data_parallel"] = dict(x_rel=x_rel, bit_for_bit=same,
                                      sessions=counts[key])
    per_step = cuda.launches_per_step(10)
    outer = 30
    for dtype, gate in ((torch.float64, SLX_MESH_F64),
                        (torch.float32, TOL_SLX_REL_F32[name])):
        utrue, f = slx_mesh_stack(torch, name, dtype)
        ref, ref_ms, _, _, _ = slx_mesh_run(name, utrue, f, None, outer)
        label = str(dtype).split(".")[-1]
        for shards in (2, 4):
            res, ms, sess, kl, n_plain = slx_mesh_run(name, utrue, f,
                                                      shards, outer)
            rel = rel_err(res.alpha, ref.alpha)
            say(f"  {label} {tuple(f.shape)} over {shards} shards: alpha "
                f"{res.alpha.double().cpu().numpy().ravel().tolist()} rel "
                f"{rel:.2e} (gate {gate:g}); sessions {sess}, kernel "
                f"launches {kl} (want {shards} x ({outer} x {per_step} + "
                f"1)); plain calls {n_plain}; host {ms:.3f} ms an outer step"
                f" (unsharded {ref_ms:.3f})")
            require(rel <= gate and bool(torch.isfinite(res.u).all()),
                    f"{name} {label} over {shards} shards: {rel:.2e}")
            require(sess == shards and kl == shards * (outer * per_step + 1)
                    and n_plain == 0,
                    f"{name} {label} over {shards} shards: sessions {sess}, "
                    f"kernel launches {kl}, plain calls {n_plain}")
            out[f"{label}_{shards}_shards"] = dict(
                alpha_rel_err=rel, host_ms_per_step=ms,
                unsharded_host_ms_per_step=ref_ms, kernel_launches=kl)
    utrue, f = slx_mesh_stack(torch, name, torch.float64)
    if name in ("tvl1", "vtv"):
        if name == "tvl1":
            utrue, f = utrue[:1], f[:1]
            a = slx_mesh_run(name, utrue, f, None, 10)[0]
            b = slx_mesh_run(name, utrue, f, 2, 10)[0]
            what = "one image over 2 shards against unsharded"
        else:
            a = slx_mesh_run(name, utrue, f, 3, 10)[0]
            b = slx_mesh_run(name, utrue, f, 4, 10)[0]
            what = "six images over 4 shards against over 3"
        zero = all(torch.equal(x, y) for x, y in zip(a[:5], b[:5]))
        say(f"  float64 {what} (an all-padding shard): bit for bit {zero}")
        require(zero, f"{name}: an all-padding shard moved the run")
        out["padding_shard_bit_for_bit"] = zero
    res, ms, sess, kl, n_plain = slx_mesh_run(name, utrue, f, 2, 9,
                                              log_every=4)
    ref = slx_mesh_run(name, utrue, f, 2, 9)[0]
    seg_same = all(torch.equal(x, y) for x, y in zip(res[:5], ref[:5]))
    say(f"  float64 segments of 4 over 2 shards (9 steps): equal to one "
        f"segment bit for bit {seg_same}; sessions {sess} (want 6); times "
        f"{np.round(res.times, 4).tolist()}")
    require(seg_same and sess == 6 and kl == 2 * (9 * per_step + 3)
            and n_plain == 0, f"{name}: segmented mesh {sess}, {kl}")
    out["segmented"] = dict(bit_for_bit=seg_same, sessions=sess)
    return out


# phase 62: the TV and sum-of-regularizers single loop over shards of the
# card against its unsharded run, float64 (the JAX package's own gate,
# tests/test_parallel.py:178-197: its CG dots are summed over the shards,
# so only the order of those sums separates the runs)
SL_MESH_F64 = 1e-10


def watch_sl_plain():
    """Count the calls of the TV single loop's plain loop and of its plain
    stepper (the mesh form's) within the block."""
    from bpldenoising_tpu_torch.bilevel import first_order as fo
    return watch_plain_calls(fo, ("_single_loop_plain",
                                  "_tv_plain_stepper"))


def sl_mesh_models():
    """(label, model, x0) of phase 62's library runs: scalar TV and the
    (3,) sum at the entry points' starting weights."""
    from bpldenoising_tpu_torch.models import sumregs_model, tv_model
    return (("tv", tv_model(), 0.1),
            ("sumregs", sumregs_model(), [1e-3, 1e-3, 1e-3]))


def sl_mesh_run(model, x0, utrue, f, shards, outer, cg_variant="classic",
                log_every=None, n_inner=40, n_adj=10):
    """single_loop_learn on ``shards`` shards of the card (or a mesh;
    None: unsharded), the plain loop and stepper watched and the counters
    read: → (result, host ms a step, sessions, kernel launches, plain
    calls)."""
    import torch
    from bpldenoising_tpu_torch.bilevel import first_order as fo
    from bpldenoising_tpu_torch.bilevel import first_order_cuda as fc
    with watch_sl_plain() as plain:
        s0, k0 = fc.launches, fc.kernel_launches
        mesh = card_mesh(shards) if isinstance(shards, int) else shards
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fo.single_loop_learn(utrue, f, x0, model, outer=outer,
                                   n_inner=n_inner, n_adj=n_adj, mesh=mesh,
                                   log_every=log_every,
                                   cg_variant=cg_variant)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
    return (res, ms / outer, fc.launches - s0, fc.kernel_launches - k0,
            len(plain))


def phase_sl_mesh(utrue, f):
    """Phase 62: the TV and sum-of-regularizers single loop with mesh=.
    The TV entry point with data_parallel=True (the default mesh, every
    card) against the same call unsharded (float32, the flagship's 10 ×
    128², 300/40/10); the library learner at 10 × 128² for scalar TV and
    the (3,) sum over ["cuda:0"] * 2 and * 4, 30 steps of 40/10, classic
    and pipelined, float64 within SL_MESH_F64 and float32 within
    TOL_SL_REL_F32 relative of the unsharded run in α and the cost
    trajectory; sessions = shards, kernel launches = shards × (steps ×
    launches_per_step + 1), no plain call; one image over two shards (a
    shard of padding) and segments of 4 give the bits of the unsharded
    run and of one segment; the kernel's mesh form against the plain
    mesh form on two CPU shards in float64 (uneven bands, the four
    parameterizations, both CGs) within TOL_F64_REL; the host ms an outer
    step beside the unsharded form's."""
    import numpy as np
    import torch
    from bpldenoising_tpu_torch.bilevel import first_order as fo
    from bpldenoising_tpu_torch.bilevel import first_order_cuda as fc
    from bpldenoising_tpu_torch.experiments import api
    from bpldenoising_tpu_torch.models import sumregs_model, tv_model
    from bpldenoising_tpu_torch.parallel import make_batch_mesh

    out = {}
    kw = dict(dataset_name="faces_train", num_samples=10, dtype="float32",
              method="single_loop", save_results=False)
    mesh = api.data_parallel_mesh("cuda")
    n_dev = mesh.size
    with watch_sl_plain() as plain:
        reset_launches()
        k0 = fc.kernel_launches
        t0 = time.perf_counter()
        dp = api.scalar_bilevel_tv_learn(device="cuda", data_parallel=True,
                                         **kw)
        dp_ms = (time.perf_counter() - t0) * 1e3
        sessions, kl = read_launches()["single_loop"], fc.kernel_launches - k0
    t0 = time.perf_counter()
    one = api.scalar_bilevel_tv_learn(device="cuda", **kw)
    one_ms = (time.perf_counter() - t0) * 1e3
    segs = 300 // api.single_loop_log_every(300)
    same = bool(np.array_equal(dp.x, one.x) and np.array_equal(dp.u, one.u))
    x_rel = abs(float(dp.x) - float(one.x)) / abs(float(one.x))
    say(f"  entry point data_parallel=True on {mesh}: alpha {float(dp.x)!r} "
        f"against unsharded {float(one.x)!r} (rel {x_rel:.2e}; bit for bit: "
        f"{same}); sessions {sessions} (want {n_dev * segs}), kernel "
        f"launches {kl} (want {n_dev} x (300 x {fc.launches_per_step(10)} + "
        f"{segs})); plain calls {len(plain)}; wall {dp_ms:.1f} ms (unsharded "
        f"{one_ms:.1f})")
    require(sessions == n_dev * segs and not plain
            and kl == n_dev * (300 * fc.launches_per_step(10) + segs)
            and x_rel <= TOL_SL_REL_F32 and (same or n_dev > 1),
            f"TV single loop data_parallel entry point: {sessions}, {kl}, "
            f"{len(plain)}, {x_rel}, {same}")
    out["entry_data_parallel"] = dict(x_rel=x_rel, bit_for_bit=same,
                                      sessions=sessions, kernel_launches=kl,
                                      wall_ms=dp_ms, unsharded_wall_ms=one_ms)
    outer = 30
    for dtype, gate in ((torch.float64, SL_MESH_F64),
                        (torch.float32, TOL_SL_REL_F32)):
        ut, ff = utrue.to(dtype), f.to(dtype)
        label = str(dtype).split(".")[-1]
        for name, model, x0 in sl_mesh_models():
            for variant in ("classic", "pipelined"):
                per = fc.launches_per_step(10, variant)
                ref, ref_ms, _, _, _ = sl_mesh_run(model, x0, ut, ff, None,
                                                   outer, variant)
                for shards in (2, 4):
                    res, ms, sess, kl, n_plain = sl_mesh_run(
                        model, x0, ut, ff, shards, outer, variant)
                    rel = max(rel_err(res.alpha, ref.alpha),
                              rel_err(res.cost_trajectory,
                                      ref.cost_trajectory))
                    say(f"  {label} {name} {variant} over {shards} shards: "
                        f"alpha "
                        f"{res.alpha.double().cpu().numpy().ravel().tolist()}"
                        f" rel {rel:.2e} (gate {gate:g}); sessions {sess}, "
                        f"kernel launches {kl} (want {shards} x ({outer} x "
                        f"{per} + 1)); plain calls {n_plain}; host "
                        f"{ms:.3f} ms an outer step (unsharded "
                        f"{ref_ms:.3f})")
                    require(rel <= gate and bool(torch.isfinite(res.u).all())
                            and res.u.shape == ut.shape,
                            f"{label} {name} {variant} over {shards} "
                            f"shards: {rel:.2e}")
                    require(sess == shards
                            and kl == shards * (outer * per + 1)
                            and n_plain == 0,
                            f"{label} {name} {variant} over {shards} "
                            f"shards: sessions {sess}, kernel launches {kl},"
                            f" plain calls {n_plain}")
                    out[f"{label}_{name}_{variant}_{shards}_shards"] = dict(
                        rel_err=rel, host_ms_per_step=ms,
                        unsharded_host_ms_per_step=ref_ms,
                        kernel_launches=kl)
    ut, ff = utrue.double(), f.double()
    pad = {}
    for (name, model, x0), variant in zip(sl_mesh_models(),
                                          ("classic", "pipelined")):
        a = sl_mesh_run(model, x0, ut[:1], ff[:1], None, 10, variant)[0]
        b = sl_mesh_run(model, x0, ut[:1], ff[:1], 2, 10, variant)[0]
        pad[f"{name} {variant}"] = [
            field for field, x, y in zip(a._fields, a[:6], b[:6])
            if not torch.equal(x, y)]
    say(f"  float64 one image over 2 shards (an all-padding shard) against "
        f"unsharded, the fields that differ: {pad}")
    require(not any(pad.values()),
            f"an all-padding shard moved the run: {pad}")
    out["padding_shard_bit_for_bit"] = not any(pad.values())
    name, model, x0 = sl_mesh_models()[0]
    res, ms, sess, kl, n_plain = sl_mesh_run(model, x0, ut, ff, 2, 9,
                                             log_every=4)
    ref = sl_mesh_run(model, x0, ut, ff, 2, 9)[0]
    seg_same = all(torch.equal(x, y) for x, y in zip(res[:6], ref[:6]))
    per = fc.launches_per_step(10)
    say(f"  float64 segments of 4 over 2 shards (9 steps): equal to one "
        f"segment bit for bit {seg_same}; sessions {sess} (want 6), kernel "
        f"launches {kl} (want 2 x (9 x {per} + 3)); times "
        f"{np.round(res.times, 4).tolist()}")
    require(seg_same and sess == 6 and kl == 2 * (9 * per + 3)
            and n_plain == 0, f"TV single loop segmented mesh: {sess}, {kl}")
    out["segmented"] = dict(bit_for_bit=seg_same, sessions=sess)
    errs = {}
    cpu2 = make_batch_mesh(devices=["cpu"] * 2)
    for shape in ((3, 20, 16), (2, 22, 24)):
        ut_c, f_c = sl_disc_stack(torch, "cpu", *shape, torch.float64)
        for name, model, x0 in (
                ("tv scalar", tv_model(), 0.02),
                ("tv patch", tv_model(), np.full((2, 2), 0.02)),
                ("sumregs vector", sumregs_model(), [0.02, 0.015, 0.01]),
                ("sumregs patch", sumregs_model(),
                 np.full((2, 2, 3), 0.02))):
            for variant in ("classic", "pipelined"):
                k = sl_mesh_run(model, x0, ut_c.cuda(), f_c.cuda(), 2, 12,
                                variant, n_inner=8, n_adj=4)[0]
                p = fo.single_loop_learn(ut_c, f_c, x0, model, outer=12,
                                         n_inner=8, n_adj=4, mesh=cpu2,
                                         cg_variant=variant)
                k = k._replace(**{field: getattr(k, field).cpu()
                                  for field in k._fields[:6]})
                e, _ = sl_errors(k, p)
                e["u"] = rel_err(k.u, p.u)
                errs[f"{'x'.join(map(str, shape))} {name} {variant}"] = max(
                    e.values())
    say("  float64 kernel mesh form against the plain mesh form, 2 shards, "
        "12 outer: max rel err " + ", ".join(f"{k} {v:.1e}"
                                              for k, v in errs.items())
        + f" (tol {TOL_F64_REL:g})")
    require(max(errs.values()) <= TOL_F64_REL,
            f"the kernel's mesh form disagrees with the plain one: {errs}")
    out["kernel_vs_plain_mesh_f64_max_rel"] = max(errs.values())
    return out


# phase 63: kernel A's tile form (csrc/pd_tile.cuh: 2-D tiles, one CTA a
# tile, T iterations a launch) where the bands do not fit a cluster: phase
# 63's shapes against the two-launch form it replaced (the plan patched)
# and the plain version, then a flagship-settings learn on 4 x 512^2 images

TILE_SHAPES = (
    # label, first images of faces_train, tiled r x r, model, maps,
    # fixed budget, early-stop tolerance, dtype
    ("1x1024x1024 K=1", 1, 8, "tv", 0, 5000, 5e-6, "float32"),
    ("4x512x512 K=1 map", 4, 4, "tv", 1, 1000, 5e-6, "float32"),
    ("1x256x256 K=3", 1, 2, "sumregs", 0, 2000, 5e-6, "float32"),
    ("1x2048x2048 K=3 maps", 1, 16, "sumregs", 3, 1000, 5e-6, "float32"),
    ("1x1024x1024 K=3", 1, 8, "sumregs", 0, 1000, 1e-7, "float64"),
)
TILE_CHECK_EVERY = 50
TILE_LEARN_IMAGES = 4
TILE_LEARN_SIZE = 512
TILE_LEARN_SEED = 63
# the noise of the learn's phantoms: at 0.1 the learn's optimum on these
# four 512² phantoms lies within 0.003 of alpha0 = 0.1, where the cost
# falls by less than the inner solve's early stop moves it, so the trust
# region rejects every step (scripts/trial_costs.py); at 0.05 it lies well
# below alpha0
TILE_LEARN_NOISE = 0.05
# the learn's first evaluation, kernels against plain versions on the same
# card tensors: u within TOL_A_U_F32 moves the cost by at most
# 2·TOL_A_U_F32·Σ|u − u_true| / Σ(u − u_true)² (~7e-3 relative at these
# phantoms' ~0.03 residual) and kernel B's capped CG carries that into the
# hypergradient; a fault in the tile form (a halo short, a wrong tile)
# moves u by 1e-2 and the cost and gradient by far more
TOL_EVAL_F32_REL = 1e-2
# the step of the cost's central difference at alpha0, and the factor on
# the CG cap of the reference hypergradient beside it
TILE_FD_STEP = 1e-3
TILE_CG_FACTOR = 20


def tile_forced_two_launch():
    """Make kernel A plan its two-launch form (no tile plan) → restore."""
    from bpldenoising_tpu_torch.solvers import pdps_cuda
    real = pdps_cuda.pd_tile_plan
    pdps_cuda.pd_tile_plan = lambda *a, **k: None

    def restore():
        pdps_cuda.pd_tile_plan = real
    return restore


def tile_counts():
    """Kernel A's calls, tile-form calls and device operations so far."""
    from bpldenoising_tpu_torch.solvers import pdps_cuda
    return (pdps_cuda.launches, pdps_cuda.tiled_calls,
            pdps_cuda.device_ops)


def tile_case(f, n_img, rep, name, n_maps, dtype):
    """The stack, model and weights of one of TILE_SHAPES."""
    import torch
    from bpldenoising_tpu_torch.models import sumregs_model, tv_model

    img = f[:n_img].repeat(1, rep, rep).to(getattr(torch, dtype))
    img = img.contiguous()
    if name == "tv":
        model = tv_model()
        a = (random_map(img, 1, 0.05, 0.1),) if n_maps else (0.1,)
    else:
        model = sumregs_model()
        amap = random_map(img, 0, 0.05, 0.1)
        a = (amap, 0.5 * amap, 0.1 * amap) if n_maps \
            else sumregs_weights()[0]
    return img, model, weights(a, img)


def phase_tile_shapes(f, timed):
    """Each TILE_SHAPES case cold (its fixed budget), early-stopped (every
    TILE_CHECK_EVERY iterations) and warm (from the early-stopped state at
    0.9 alpha): the tile form against the two-launch form bit for bit (u,
    duals, iteration counts) and against the plain version (float32 at
    kernel A's tolerances with counts within one check, float64 at
    TOL_F64_REL with equal counts); each call timed, the cold calls beside
    their bound (f and the maps in; u and the K duals out)."""
    import torch
    from bpldenoising_tpu_torch.solvers import pdps_cuda
    from bpldenoising_tpu_torch.solvers.cluster_plan import (pd_plan,
                                                             pd_tile_plan)
    from bpldenoising_tpu_torch.solvers.pdps import _denoise_pdps_impl

    out = {}
    for label, n_img, rep, name, n_maps, budget, tol, dtype in TILE_SHAPES:
        img, model, a = tile_case(f, n_img, rep, name, n_maps, dtype)
        M, N = img.shape[-2:]
        kinds = [pdps_kind(op) for op in model.ops]
        require(not pd_plan(M, N, model.K, img.element_size()).resident,
                f"{label}: the bands fit a cluster")
        plan = pd_tile_plan(M, N, model.K, img.element_size(), n_maps,
                            model.K > 1, images=img.shape[0])
        base = dict(model=model, tau0=5.0, sigma0=0.99 / 5.0, gamma=1.0,
                    accel=True, check_every=TILE_CHECK_EVERY,
                    return_dual=True)
        modes = (("cold", None, a, dict(maxiter=budget, tol=None)),
                 ("early stop", None, a, dict(maxiter=budget, tol=tol)),
                 ("warm", "state", tuple(0.9 * x for x in a),
                  dict(maxiter=budget, tol=tol)))
        row, state = {}, None
        for mode, warm, w, extra in modes:
            kw = dict(base, **extra)
            st = state if warm else None
            pdps_cuda.denoise_pdps_cuda(img, w, st, **dict(kw, maxiter=20))
            c0 = tile_counts()
            k, k_ms = timed(lambda: pdps_cuda.denoise_pdps_cuda(img, w, st,
                                                                **kw))
            c1 = tile_counts()
            restore = tile_forced_two_launch()
            try:
                pdps_cuda.denoise_pdps_cuda(img, w, st,
                                            **dict(kw, maxiter=20))
                g0 = tile_counts()
                g, g_ms = timed(lambda: pdps_cuda.denoise_pdps_cuda(
                    img, w, st, **kw))
                g1 = tile_counts()
            finally:
                restore()
            p, p_ms = timed(lambda: _denoise_pdps_impl(img, w, st, **kw))
            same = k[2] == g[2] and torch.equal(k[0], g[0]) and all(
                torch.equal(x, y) for x, y in zip(k[1], g[1]))
            if dtype == "float64":
                err = max([rel_err(k[0], p[0])]
                          + [rel_err(x, y) for x, y in zip(k[1], p[1])])
                ok = err <= TOL_F64_REL and k[2] == p[2]
            else:
                err_u = max_abs(k[0], p[0])
                err_y = max(max_abs(x, y) for x, y in zip(k[1], p[1]))
                err = max(err_u, err_y)
                ok = err_u <= TOL_A_U_F32 and err_y <= TOL_A_Y_F32 \
                    and abs(k[2] - p[2]) <= TILE_CHECK_EVERY
            ops = c1[2] - c0[2]
            say(f"  {label} {dtype} {mode}: {k[2]} its (two-launch "
                f"{g[2]}, plain {p[2]}); tile form {k_ms:.2f} ms, "
                f"two-launch {g_ms:.2f} ms ({g_ms / k_ms:.2f}x), plain "
                f"{p_ms:.1f} ms; bits of the two-launch form: {same}; "
                f"max err vs plain {err:.2e}; device operations {ops} "
                f"(two-launch {g1[2] - g0[2]})")
            require(same, f"{label} {mode}: the tile form differs from the "
                    "two-launch form")
            require(ok, f"{label} {mode}: the tile form disagrees with "
                    f"plain: {err}, iterations {k[2]} vs {p[2]}")
            require(c1[0] - c0[0] == 1 and c1[1] - c0[1] == 1
                    and g1[1] == g0[1], f"{label} {mode}: kernel A's forms "
                    f"counted {c0} -> {c1}, two-launch {g0} -> {g1}")
            row[mode] = dict(iters=k[2], ms=k_ms, two_launch_ms=g_ms,
                             plain_ms=p_ms, max_err=err, device_ops=ops,
                             two_launch_device_ops=g1[2] - g0[2])
            if mode == "early stop":
                state = (k[0], k[1])
        n = img.numel()
        itemsize = img.element_size()
        bound, by = bound_ms(
            ((2 + 2 * model.K) * n + n_maps * M * N) * itemsize,
            a_ops_per_pixel_iter(kinds, n_maps) * n * budget,
            F32_OPS_PER_S if dtype == "float32" else F64_OPS_PER_S)
        row["cold"].update(bound_ms=bound, bound_by=by)
        say(f"  {label} {dtype}: tile {plan.rows}x{plan.cols}, T {plan.T}, "
            f"H {plan.H}, {plan.tiles_m}x{plan.tiles_n} tiles an image, "
            f"grid {plan.grid}, {plan.smem} B a CTA, TMA {plan.tma}; cold "
            f"{row['cold']['ms']:.2f} ms against a bound of {bound:.3f} ms "
            f"({by}), two-launch {row['cold']['two_launch_ms']:.2f} ms")
        out[label] = dict(row, plan=plan._asdict(), dtype=dtype)
    return out


def tile_learn_data():
    """TILE_LEARN_IMAGES phantoms of TILE_LEARN_SIZE^2 from
    data/generate.py with noise sigma TILE_LEARN_NOISE from TILE_LEARN_SEED
    (float64, numpy): two disks, a pyramid and random facets."""
    import numpy as np
    from bpldenoising_tpu_torch.data.generate import (add_noise,
                                                      affine_phantom,
                                                      circle_phantom)

    n = TILE_LEARN_SIZE
    true = np.stack([circle_phantom(n, 0.3),
                     circle_phantom(n, 0.2, center=(0.4, 0.6)),
                     affine_phantom(n, "pyramid"),
                     affine_phantom(n, "facets", seed=TILE_LEARN_SEED)])
    rng = np.random.default_rng(TILE_LEARN_SEED)
    return true, np.stack([add_noise(t, TILE_LEARN_NOISE, rng)
                           for t in true])


def tile_learn_first_evaluation(utrue, f, kw):
    """The learn's first evaluation at alpha0 (learning/tv.py's tv_local,
    the exact hypergradient, as the trust region's first step takes it;
    kernel A in the tile form, kernel B) against the plain versions of both
    kernels on the same card tensors, gated at TOL_EVAL_F32_REL; then what
    the trust region's steps are measured by: the cost's central difference
    at alpha0 ± TILE_FD_STEP, and the hypergradient with TILE_CG_FACTOR
    times the adjoint CG's cap, printed beside it."""
    import torch
    from bpldenoising_tpu_torch import learning
    from bpldenoising_tpu_torch.models import tv_model
    from bpldenoising_tpu_torch.solvers.hypergrad import exact_hypergrad
    from bpldenoising_tpu_torch.solvers.pdps import _denoise_pdps_impl

    tv = learning.tv
    cfg = kw["hypergrad_cfg"]

    def evaluate(alpha, cfg=cfg):
        x = torch.tensor(alpha, dtype=torch.float32)
        _, cost, grads, _, _, info = tv.tv_local(
            x, utrue, f, None, None, model=tv_model(), method="exact",
            maxiter=kw["inner_maxiter"], cfg=cfg, pop=None,
            solver_kwargs=dict(tol=kw["inner_tol"],
                               check_every=kw["check_every"]))
        return float(cost), float(grads[0]), info

    a0 = kw["alpha0"]
    cost, grad, info = evaluate(a0)
    real = tv.denoise_pdps_cuda, tv.exact_hypergrad_cuda
    tv.denoise_pdps_cuda, tv.exact_hypergrad_cuda = (_denoise_pdps_impl,
                                                     exact_hypergrad)
    try:
        p_cost, p_grad, p_info = evaluate(a0)
    finally:
        tv.denoise_pdps_cuda, tv.exact_hypergrad_cuda = real
    err_c = abs(cost - p_cost) / abs(p_cost)
    err_g = abs(grad - p_grad) / abs(p_grad)
    h = TILE_FD_STEP
    c_hi, c_lo = evaluate(a0 + h)[0], evaluate(a0 - h)[0]
    fd = (c_hi - c_lo) / (2 * h)
    _, g_ref, ref_info = evaluate(a0, cfg._replace(
        cg_maxiter=TILE_CG_FACTOR * cfg.cg_maxiter))
    say(f"  first evaluation at alpha {a0}: cost {cost!r} (plain "
        f"{p_cost!r}, rel {err_c:.2e}), hypergradient {grad!r} (plain "
        f"{p_grad!r}, rel {err_g:.2e}; tol {TOL_EVAL_F32_REL:g}); adjoint "
        f"CG {info.iters} its, converged {bool(info.converged)} (plain "
        f"{p_info.iters}, {bool(p_info.converged)})")
    say(f"  cost at alpha {a0} -+ {h:g}: {c_lo!r}, {c_hi!r}: central "
        f"difference {fd!r} against the hypergradient {grad!r}; with "
        f"{TILE_CG_FACTOR * cfg.cg_maxiter} CG its {g_ref!r} ({ref_info.iters}"
        f" its, converged {bool(ref_info.converged)})")
    require(all(math.isfinite(v) for v in (cost, grad, fd, g_ref)),
            "the first evaluation is not finite")
    require(err_c <= TOL_EVAL_F32_REL and err_g <= TOL_EVAL_F32_REL,
            f"the learn's first evaluation disagrees with plain: cost "
            f"{err_c:.2e}, hypergradient {err_g:.2e}")
    return dict(cost=cost, plain_cost=p_cost, hypergradient=grad,
                plain_hypergradient=p_grad, cost_rel_err=err_c,
                hypergradient_rel_err=err_g, cg_iters=info.iters,
                cg_converged=bool(info.converged), central_difference=fd,
                fd_step=h, hypergradient_long_cg=g_ref,
                long_cg_iters=ref_info.iters,
                long_cg_converged=bool(ref_info.converged))


def phase_tile_learn(timed):
    """bilevel_learn_fused at the flagship's settings on tile_learn_data()
    in float32: kernel A in the tile form (every call, no plain call),
    kernel B as before; then the same learn with the two-launch form
    forced, which must give alpha, the mean PSNR and the cost bit for bit.
    The wall (CUDA events, after a warm-up) and kernel A's share of it."""
    import torch
    from bpldenoising_tpu_torch import learning
    from bpldenoising_tpu_torch.bilevel.fused import bilevel_learn_fused
    from bpldenoising_tpu_torch.experiments import api
    from bpldenoising_tpu_torch.metrics import psnr

    true_np, noisy_np = tile_learn_data()
    utrue = torch.as_tensor(true_np, dtype=torch.float32).cuda()
    f = torch.as_tensor(noisy_np, dtype=torch.float32).cuda()
    kw = flagship_kwargs()
    lkw = dict(xinit=kw["alpha0"],
               params=api.bilevel_params | dict(maxiter=kw["maxiter"],
                                                tol=kw["tol"]),
               inner_maxiter=kw["inner_maxiter"],
               inner_tol=kw["inner_tol"], check_every=kw["check_every"],
               cfg=kw["hypergrad_cfg"], delta_t=1e-6, device="cuda")
    tv = learning.tv
    real_a = tv.denoise_pdps_cuda
    a_ms = []

    def timed_a(*a, **k):
        out, ms = timed(lambda: real_a(*a, **k))
        a_ms.append(ms)
        return out

    def run():
        res, wall = timed(lambda: bilevel_learn_fused((utrue, f), **lkw))
        return (res, wall, float(res.x),
                float(torch.mean(psnr(utrue, res.u))), float(res.cost))

    bilevel_learn_fused((utrue, f), **lkw)                   # warm-up
    plain, restore = watch_plain()
    try:
        reset_launches()
        res, wall, alpha, mean_psnr, cost = run()
        a = kernel_a_forms()
        b = kernel_b_forms()
        counts = tile_counts()
    finally:
        restore()
    tv.denoise_pdps_cuda = timed_a
    try:
        _, timed_wall, *_ = run()
    finally:
        tv.denoise_pdps_cuda = real_a
    two = tile_forced_two_launch()
    try:
        bilevel_learn_fused((utrue, f), **lkw)               # warm-up
        reset_launches()
        _, g_wall, g_alpha, g_psnr, g_cost = run()
        g_counts = tile_counts()
    finally:
        two()
    evals = res.iterations + 1
    share = sum(a_ms) / timed_wall
    steps = res.log[:res.iterations].tolist()
    for k, (c, gn, radius, step, cg, conv) in enumerate(steps):
        say(f"    outer {k}: cost {c!r}, |g| {gn!r}, radius {radius!r}, "
            f"accepted step {step!r}, adjoint CG {int(cg)} its"
            f"{'' if conv else ' (at its cap)'}")
    say(f"  {TILE_LEARN_IMAGES}x{TILE_LEARN_SIZE}x{TILE_LEARN_SIZE} float32: "
        f"alpha {alpha!r}, PSNR {mean_psnr!r} dB, cost {cost!r}, "
        f"{res.iterations} outer its; wall {wall:.1f} ms; kernel A "
        f"{sum(a_ms):.1f} ms of a {timed_wall:.1f} ms timed run "
        f"({100 * share:.1f}%); kernel A {counts[0]} calls, {counts[1]} in "
        f"the tile form, {counts[2]} device operations")
    say(f"  the same learn in the two-launch form: alpha {g_alpha!r}, PSNR "
        f"{g_psnr!r} dB, cost {g_cost!r}; wall {g_wall:.1f} ms; kernel A "
        f"{g_counts[0]} calls, {g_counts[2]} device operations")
    say_kernel_b_forms(b)
    require(counts[1] == counts[0] == a["calls"] == evals,
            f"kernel A: {counts} (tile calls), want {evals} in the tile "
            "form")
    require(kernel_b_cooperative(b) and b["calls"] == evals,
            f"kernel B: {b}, want {evals} cooperative calls")
    require(not plain, f"plain versions called: {sorted(set(plain))}")
    require(tuple(res.u.shape) == tuple(utrue.shape)
            and bool(torch.isfinite(res.u).all()), "tile learn u")
    require((alpha, mean_psnr, cost) == (g_alpha, g_psnr, g_cost),
            "the tile-form learn differs from the two-launch form's: "
            f"{(alpha, mean_psnr, cost)} vs {(g_alpha, g_psnr, g_cost)}")
    first = tile_learn_first_evaluation(utrue, f, kw)
    say(f"  the learn's first logged cost {steps[0][0]!r} and |g| "
        f"{steps[0][1]!r}; the evaluation's {first['cost']!r}, "
        f"{abs(first['hypergradient'])!r}")
    return dict(alpha=alpha, mean_psnr_db=mean_psnr, cost=cost,
                first_evaluation=first, steps=steps,
                outer_iterations=res.iterations, wall_ms=wall,
                kernel_a_ms=sum(a_ms), timed_wall_ms=timed_wall,
                kernel_a_share=share, launches=counts[0],
                tiled_calls=counts[1], device_ops=counts[2],
                two_launch=dict(alpha=g_alpha, mean_psnr_db=g_psnr,
                                cost=g_cost, wall_ms=g_wall,
                                device_ops=g_counts[2]))


# phase 64: the TGV² CP solve's tile form (csrc/tgv_tile.cu: 2-D tiles,
# one CTA a tile, T iterations a launch, a halo of T) where the bands do
# not fit a cluster: TGV_TILE_SHAPES against the two-launch form it
# replaced (the plan patched) and the plain version, then a TGV² learn on
# two 256² pyramids in it

TGV_TILE_SHAPES = (
    # label, first images of faces_train, tiled r x r, weights (scalar:
    # TGV_ALPHA, maps: random maps of both), budget, early-stop tolerance
    # (bench.py's TGV² 3e-6 every 100), dtype, then warm from the state
    ("1x1024x1024", 1, 8, "scalar", 1000, None, "float32", False),
    ("10x256x256", 10, 2, "scalar", 5000, 3e-6, "float32", True),
    ("4x512x512 maps", 4, 4, "maps", 1000, None, "float32", False),
    ("1x512x512", 1, 4, "scalar", 5000, 3e-6, "float64", False),
)
TGV_TILE_CHECK_EVERY = 100
TGV_TILE_LEARN_SIZE = 256
TGV_TILE_LEARN_NOISE = 0.1
TGV_TILE_LEARN_SEED = 64
# the learn's outer iterations: bench.py's TGV² learn runs 20 (a ~1 s
# evaluation at two 256² images, nearly all of it the plain adjoint CG);
# cut to 5 so that the phase, which runs the learn twice, stays under a
# minute
TGV_TILE_LEARN_MAXITER = 5


def tgv_tile_case(f, n_img, rep, weights, dtype):
    """The stack and the weights (α₁, α₀) of one of TGV_TILE_SHAPES."""
    import torch

    img = f[:n_img].repeat(1, rep, rep).to(getattr(torch, dtype))
    img = img.contiguous()
    if weights == "maps":
        a = (random_map(img, 1, 0.05, 0.12), random_map(img, 2, 0.03, 0.06))
    else:
        a = tuple(torch.tensor(v, dtype=img.dtype) for v in TGV_ALPHA)
    return img, a


def phase_tgv_tile_shapes(f, timed):
    """Each TGV_TILE_SHAPES case (and 10×256² warm from its early-stopped
    state at the nudged weights 1.05 α₁, 0.95 α₀): the tile form against
    the two-launch form bit for bit (u, w, p, q, iteration counts) and
    against the plain version (float32 at phase 6's TGV tolerances with
    counts within one check, float64 at TOL_F64_REL with equal counts);
    each call one tile-form call of the device operations its plan gives,
    timed beside the two-launch form, the plain version and the bound (f
    and the maps in, the state out, and in when warm)."""
    import torch
    from bpldenoising_tpu_torch.solvers import tgv_cuda
    from bpldenoising_tpu_torch.solvers.cluster_plan import (tgv_plan,
                                                             tgv_tile_plan)
    from bpldenoising_tpu_torch.solvers.tgv import _tgv_impl

    out = {}
    for label, n_img, rep, weights, budget, tol, dtype, warm in \
            TGV_TILE_SHAPES:
        img, a = tgv_tile_case(f, n_img, rep, weights, dtype)
        O, M, N = img.shape
        itemsize = img.element_size()
        n_maps = sum(x.ndim > 0 for x in a)
        require(not tgv_plan(M, N, itemsize).resident,
                f"{label}: the bands fit a cluster")
        plan = tgv_tile_plan(M, N, itemsize, n_maps, O)
        kw = dict(maxiter=budget, tol=tol, check_every=TGV_TILE_CHECK_EVERY,
                  return_state=True)
        modes = [("cold", a, None)]
        if warm:
            modes.append(("warm", (1.05 * a[0], 0.95 * a[1]), "state"))
        rows, state = {}, None
        for mode, w, st0 in modes:
            st = state if st0 else None

            def call(w=w, st=st, **over):
                return tgv_cuda.tgv_denoise_pdps_cuda(
                    img, *w, state0=st, **dict(kw, **over))

            call(maxiter=20)
            c0 = tgv_counts()
            k, k_ms = timed(call)
            c1 = tgv_counts()
            restore = tgv_forced_two_launch()
            try:
                call(maxiter=20)
                g0 = tgv_counts()
                g, g_ms = timed(call)
                g1 = tgv_counts()
            finally:
                restore()
            p, p_ms = timed(lambda: _tgv_impl(
                img, *w, st, tau0=0.99, sigma0=0.99, **kw))
            same = tgv_same(k, g)
            if dtype == "float64":
                err = max(rel_err(x, y) for x, y in zip(k[2], p[2]))
                ok = err <= TOL_F64_REL and k[3] == p[3]
            else:
                errs = tgv_errors(k, p)
                err = max(errs)
                ok = errs[0] <= TOL_TGV_U_F32 \
                    and max(errs[1:]) <= TOL_TGV_DUAL_F32 \
                    and abs(k[3] - p[3]) <= TGV_TILE_CHECK_EVERY
            ops = c1[3] - c0[3]
            want = tgv_tile_ops(plan.T, k[3], budget, tol,
                                TGV_TILE_CHECK_EVERY)
            say(f"  {label} {dtype} {mode}: {k[3]} its (two-launch {g[3]}, "
                f"plain {p[3]}); tile form {k_ms:.2f} ms, two-launch "
                f"{g_ms:.2f} ms ({g_ms / k_ms:.2f}x), plain {p_ms:.1f} ms; "
                f"bits of the two-launch form: {same}; max err vs plain "
                f"{err:.2e}; device operations {ops} (two-launch "
                f"{g1[3] - g0[3]})")
            require(same, f"{label} {mode}: the tile form differs from the "
                    "two-launch form")
            require(ok, f"{label} {mode}: the tile form disagrees with "
                    f"plain: {err}, iterations {k[3]} vs {p[3]}")
            require(c1[0] - c0[0] == 1 and c1[2] - c0[2] == 1 and ops == want
                    and g1[2] == g0[2] and g1[1] == g0[1],
                    f"{label} {mode}: the TGV² forms counted {c0} -> {c1} "
                    f"(want {want} device operations), two-launch {g0} -> "
                    f"{g1}")
            n = img.numel()
            planes = 1 + 8 + (8 if st is not None else 0)
            bound, by = bound_ms(
                (planes * n + n_maps * M * N) * itemsize,
                TGV_OPS_PER_PIXEL_ITER * n * k[3],
                F32_OPS_PER_S if dtype == "float32" else F64_OPS_PER_S)
            rows[mode] = dict(iters=k[3], ms=k_ms, two_launch_ms=g_ms,
                              plain_ms=p_ms, max_err=err, device_ops=ops,
                              two_launch_device_ops=g1[3] - g0[3],
                              bound_ms=bound, bound_by=by)
            say(f"  {label} {dtype} {mode}: bound {bound:.3f} ms ({by})")
            state = k[2]
        say(f"  {label} {dtype}: tile {plan.rows}x{plan.cols}, T {plan.T}, "
            f"H {plan.H}, {plan.tiles_m}x{plan.tiles_n} tiles an image, "
            f"grid {plan.grid}, {plan.smem} B a CTA, TMA {plan.tma}")
        out[label] = dict(rows, plan=plan._asdict(), dtype=dtype)
    return out


def tgv_tile_learn_data():
    """Two TGV_TILE_LEARN_SIZE² pyramids (data/generate.py's
    affine_phantom), each under its own Gaussian noise of sigma
    TGV_TILE_LEARN_NOISE from TGV_TILE_LEARN_SEED (float64, numpy)."""
    import numpy as np
    from bpldenoising_tpu_torch.data.generate import (add_noise,
                                                      affine_phantom)

    true = np.stack([affine_phantom(TGV_TILE_LEARN_SIZE, "pyramid")] * 2)
    rng = np.random.default_rng(TGV_TILE_LEARN_SEED)
    return true, np.stack([add_noise(t, TGV_TILE_LEARN_NOISE, rng)
                           for t in true])


def phase_tgv_tile_learn(timed):
    """bilevel_learn_tgv_fused at bench.py's TGV² settings (x0 (0.05,
    0.05), δ₀ 0.02, inner 5000 its with the early stop 3e-6 every 100)
    and TGV_TILE_LEARN_MAXITER outer iterations on tgv_tile_learn_data()
    in float32: every TGV² solve in the tile form (the watched calls, the
    counters); then the same learn with the two-launch form forced, which
    must give (α₁, α₀), the mean PSNR and the cost bit for bit.  Both
    walls (CUDA events)."""
    import numpy as np
    import torch
    from bpldenoising_tpu_torch.bilevel.fused_tgv import \
        bilevel_learn_tgv_fused
    from bpldenoising_tpu_torch.experiments import api
    from bpldenoising_tpu_torch.metrics import psnr

    true_np, noisy_np = tgv_tile_learn_data()
    utrue = torch.as_tensor(true_np, dtype=torch.float32).cuda()
    f = torch.as_tensor(noisy_np, dtype=torch.float32).cuda()
    params = api.bilevel_params | dict(maxiter=TGV_TILE_LEARN_MAXITER,
                                       tol=1e-5, delta0=0.02)
    kw = dict(xinit=np.array([0.05, 0.05]), params=params,
              inner_maxiter=5000, inner_tol=3e-6, check_every=100,
              device="cuda")

    def run():
        res, wall = timed(lambda: bilevel_learn_tgv_fused((utrue, f), **kw))
        return (res, wall, [float(v) for v in res.x],
                float(torch.mean(psnr(utrue, res.u))), float(res.cost))

    c0 = tgv_counts()
    with watch_tgv() as calls:
        res, wall, alpha, mean_psnr, cost = run()
    c1 = tgv_counts()
    forms = cp_forms(calls, "phase 64 learn", "TGV²", cluster=False,
                     tiled=True)
    restore = tgv_forced_two_launch()
    try:
        g0 = tgv_counts()
        _, g_wall, g_alpha, g_psnr, g_cost = run()
        g1 = tgv_counts()
    finally:
        restore()
    say(f"  2x{TGV_TILE_LEARN_SIZE}x{TGV_TILE_LEARN_SIZE} float32: alpha "
        f"{alpha[0]!r}, {alpha[1]!r}, PSNR {mean_psnr!r} dB, cost {cost!r}, "
        f"{res.iterations} outer its; wall {wall:.1f} ms; TGV² {c1[0] - c0[0]}"
        f" calls, {c1[2] - c0[2]} in the tile form, {c1[3] - c0[3]} device "
        "operations")
    say(f"  the same learn in the two-launch form: alpha {g_alpha[0]!r}, "
        f"{g_alpha[1]!r}, PSNR {g_psnr!r} dB, cost {g_cost!r}; wall "
        f"{g_wall:.1f} ms; TGV² {g1[0] - g0[0]} calls, {g1[3] - g0[3]} "
        "device operations")
    require(c1[0] - c0[0] == c1[2] - c0[2] == len(calls) > 0
            and c1[1] == c0[1], f"the TGV² learn's solves: {c0} -> {c1}, "
            f"want every one in the tile form")
    require(g1[2] == g0[2] and g1[0] - g0[0] == c1[0] - c0[0],
            f"the two-launch learn's solves: {g0} -> {g1}")
    require(tuple(res.u.shape) == tuple(utrue.shape)
            and bool(torch.isfinite(res.u).all()), "tile learn u")
    require((alpha, mean_psnr, cost) == (g_alpha, g_psnr, g_cost),
            "the tile-form learn differs from the two-launch form's: "
            f"{(alpha, mean_psnr, cost)} vs {(g_alpha, g_psnr, g_cost)}")
    return dict(alpha=alpha, mean_psnr_db=mean_psnr, cost=cost,
                outer_iterations=res.iterations, wall_ms=wall,
                launches=c1[0] - c0[0], tiled_calls=c1[2] - c0[2],
                device_ops=c1[3] - c0[3], kernel_calls=forms,
                two_launch=dict(alpha=g_alpha, mean_psnr_db=g_psnr,
                                cost=g_cost, wall_ms=g_wall,
                                device_ops=g1[3] - g0[3]))


def flagship_kwargs():
    from bpldenoising_tpu_torch.solvers.hypergrad import HypergradConfig
    return dict(dataset_name="faces_train", num_samples=10,
                method="tr_fused", dtype="float32", maxiter=20, tol=1e-5,
                alpha0=0.1, inner_maxiter=5000, inner_tol=5e-6,
                check_every=50,
                hypergrad_cfg=HypergradConfig(al_iters=2, cg_maxiter=100))


def main():
    faulthandler.dump_traceback_later(DEADLINE_S, exit=True)
    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    from bpldenoising_tpu_torch import _build
    from bpldenoising_tpu_torch.data import testdataset
    from bpldenoising_tpu_torch.experiments.api import scalar_bilevel_tv_learn
    from bpldenoising_tpu_torch.metrics import psnr

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    say(f"phase 1 device: {kind}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.device_count()} card(s)")
    say(smi)

    info = _build.build()
    _build.library()
    say(f"phase 2 build: {info.seconds:.1f} s ({info.path.name})")
    for source, needle in (("hypergrad.cu", "hg_coop"), ("pdps.cu", "pdc_cp"),
                           ("single_loop.cu", "slc_pd"),
                           ("tvl1.cu", "tvl1_cp"),
                           ("single_loop_tgv.cu", "slt_pd"),
                           ("single_loop_tgv.cu", "slt_init"),
                           ("single_loop_tgv.cu", "slt_apply"),
                           ("single_loop_tvl1.cu", "sl1_pd"),
                           ("single_loop_tvl1.cu", "sl1_init"),
                           ("single_loop_tvl1.cu", "sl1_apply"),
                           ("single_loop_vtv.cu", "slv_pd"),
                           ("single_loop_vtv.cu", "slv_init"),
                           ("single_loop_vtv.cu", "slv_apply"),
                           ("tgv.cu", "tgv_cp"), ("tgv.cu", "tgv_primal"),
                           ("tgv.cu", "tgv_dual"), ("vtv.cu", "vtv_cp"),
                           ("pd_tile.cu", "pdt_cp"),
                           ("tgv_tile.cu", "tt_cp")):
        for line in ptxas_report(info.path.with_suffix(".log"), source,
                                 needle):
            say(f"  {line}")

    timed = cuda_timer(torch)
    parent_calls = contextlib.ExitStack()
    parent_calls.enter_context(results_not_saved())
    true_np, noisy_np = testdataset("faces_train_128_10")
    utrue = torch.as_tensor(true_np, dtype=torch.float32).to(dev)
    f = torch.as_tensor(noisy_np, dtype=torch.float32).to(dev)
    n = f.numel()

    say("phase 3 kernel A vs plain, 10x128x128 float32")
    u_state, a_stats = phase_kernel_a(f, timed)

    say("phase 4 kernel B vs plain, 10x128x128 float32")
    b_stats = phase_kernel_b(u_state, utrue, timed)
    phase_f64(torch, dev)

    say("phase 5 flagship scalar_bilevel_tv_learn(method='tr_fused')")
    kw = flagship_kwargs()
    scalar_bilevel_tv_learn(device="cuda", **kw)          # warm-up
    t0 = time.perf_counter()
    testdataset("faces_train_128_10")
    load_ms = (time.perf_counter() - t0) * 1e3
    reset_launches()
    res, wall_ms = timed(lambda: scalar_bilevel_tv_learn(device="cuda",
                                                         **kw))
    counts = read_launches()
    a_forms = kernel_a_forms()
    b_forms = kernel_b_forms()
    flagship, flagship_a, flagship_b = res, a_forms, b_forms
    launches_a, launches_b = counts["pdps"], counts["hypergrad"]
    alpha = float(res.x)
    d_alpha = abs(alpha - FLAGSHIP_ALPHA)
    mean_psnr = float(torch.mean(psnr(utrue, on_device(res, utrue))))
    cost = float(res.cost)
    cg_cap = cg_log(res)[1] > 0
    say(f"  alpha {alpha:.6f} |d| {d_alpha:.2e} (gate {ALPHA_GATE:g}, "
        f"band {ALPHA_BAND:g}: {'in' if d_alpha <= ALPHA_BAND else 'out'}); "
        f"PSNR {mean_psnr:.4f} dB; cost {cost:.4f}; "
        f"{res.iterations} outer its; CG capped: {cg_cap}")
    say(f"  wall {wall_ms:.1f} ms (CUDA events, after one warm-up run; "
        f"the PNG load in it takes ~{load_ms:.1f} ms on the host); "
        f"launches {counts}")
    say_kernel_a_forms(a_forms)
    say_kernel_b_forms(b_forms)
    require(launches_a > 0 and launches_b > 0,
            f"main path launched A {launches_a}, B {launches_b} times")
    require(a_forms["cluster"] == launches_a,
            f"kernel A's cluster form ran {a_forms['cluster']} of "
            f"{launches_a} calls")
    require(kernel_b_cooperative(b_forms),
            f"kernel B: {b_forms}: not one launch and one read a call")
    require(d_alpha <= ALPHA_GATE, f"alpha {alpha} off by {d_alpha}")
    require(abs(mean_psnr - FLAGSHIP_PSNR) <= PSNR_GATE,
            f"mean PSNR {mean_psnr}")
    require(abs(cost - FLAGSHIP_COST) <= COST_GATE_REL * FLAGSHIP_COST,
            f"final cost {cost}")

    say("phase 6 TGV kernel vs plain, 10x128x128 float32")
    with watch_tgv() as calls:
        tgv_stats = phase_tgv(f, timed)
        phase_tgv_f64(torch, dev)
    cp_forms(calls, "phase 6", "TGV²")

    say("phase 7 large images vs plain, float32")
    with watch_tgv() as calls:
        large = phase_large(f, timed)
    large["tgv_1024"]["kernel_calls"] = cp_forms(
        [c for c in calls if c["tiled"]], "phase 7", "TGV²", cluster=False,
        tiled=True)

    say("phase 8 TGV learn scalar_bilevel_tgv_learn(method='tr_fused')")
    tgv_learn = phase_tgv_learn(utrue, timed)

    say("phase 9 patch TGV learn patch_bilevel_tgv_learn(method='tr_fused')")
    tgv_patch = phase_tgv_patch_learn(utrue, timed)

    sp_true, sp_noisy = testdataset("circle_sp_128_20")
    sp_utrue = torch.as_tensor(sp_true, dtype=torch.float32).to(dev)
    sp_f = torch.as_tensor(sp_noisy, dtype=torch.float32).to(dev)
    say("phase 10 TV-L1 kernel vs plain, circle_sp 1x128x128 float32")
    with watch_tvl1() as calls:
        tvl1h_stats, tvl1_stats = phase_tvl1(sp_f, timed)
        phase_tvl1_f64(torch, dev)
    cp_forms(calls, "phase 10")

    say("phase 11 TV-L1 learn scalar_bilevel_tvl1_learn(method='tr_fused'), "
        "then TVL1Denoise")
    tvl1_learn = phase_tvl1_learn(sp_utrue, sp_f, timed)

    say("phase 12 patch TV-L1 learn patch_bilevel_tvl1_learn("
        "method='tr_fused')")
    tvl1_patch = phase_tvl1_patch_learn(sp_utrue, timed)

    vt_true, vt_noisy = testdataset("color_disks_128_10", color=True)
    vt_utrue = torch.as_tensor(vt_true, dtype=torch.float32).to(dev)
    vt_f = torch.as_tensor(vt_noisy, dtype=torch.float32).to(dev)
    say("phase 13 VTV kernel vs plain, color_disks 6x3x128x128 float32")
    with watch_vtv() as calls:
        vtv_stats = phase_vtv(vt_f, timed)
    with watch_vtv() as big_calls:
        large["vtv_256"] = phase_vtv_large(vt_f, timed)
    large["vtv_256"]["kernel_calls"] = cp_forms(
        big_calls, "phase 13, 256^2", "VTV", cluster=False, chunk_ops=3)
    say("phase 14 VTV kernel vs plain, float64")
    with watch_vtv() as f64_calls:
        phase_vtv_f64(torch, dev)
    cp_forms(calls + f64_calls, "phases 13-14", "VTV", chunk_ops=3, table=1)

    say("phase 15 VTV learn scalar_bilevel_vtv_learn(method='tr_fused')")
    vtv_learn = phase_vtv_learn(vt_utrue, timed)

    say("phase 16 patch VTV learn patch_bilevel_vtv_learn("
        "method='tr_fused'), then VTVDenoise")
    vtv_patch = phase_vtv_patch_learn(vt_utrue, vt_f, timed)

    say("phase 17 single-loop stencils vs ops/grad.py, float64")
    phase_sl_stencils(torch, dev)
    say("phase 18 single-loop kernel vs plain, 10x128x128 float32, then "
        "float64")
    sl_stats = phase_sl_kernel(utrue, f, timed)
    phase_sl_f64(torch, dev)
    say("phase 19 single-loop learn scalar_bilevel_tv_learn("
        "method='single_loop')")
    sl_learn = phase_sl_learn(utrue, timed, sumregs=False)
    say("phase 20 single-loop learn scalar_bilevel_sumregs_learn("
        "method='single_loop')")
    sl_sumregs = phase_sl_learn(utrue, timed, sumregs=True)
    say("phase 21 single-loop learner at batch 64, K=3, one tile and "
        "tile_b 8")
    sl_tiled = phase_sl_tiled(utrue, f, timed)
    slx = {name: phases_slx(torch, dev, timed, name, 22 + 4 * i)
           for i, name in enumerate(("tgv", "tvl1", "vtv"))}

    say("phase 34 kernel A K=3 and map forms vs plain, 10x128x128 and "
        "1x2048x2048 float32")
    u3, umap, amap, forms_a = phase_forms_a(f, timed)
    say("phase 35 kernel B K=3 and map forms vs plain, 10x128x128 float32, "
        "then A and B forms in float64")
    forms_b = phase_forms_b(u3, umap, amap, utrue, timed)
    forms_f64 = phase_forms_f64(torch, dev)
    tvf = {}
    for i, (name, title) in enumerate((
            ("patch_tv", "patch_bilevel_tv_learn 2x2"),
            ("sumregs", "scalar_bilevel_sumregs_learn"),
            ("patch_sumregs", "patch_bilevel_sumregs_learn 2x2x3"),
            ("grid16", "patch_bilevel_tv_learn 16x16 (L-BFGS)"))):
        say(f"phase {36 + i} {title}(method='tr_fused')")
        tvf[name] = phase_tvf_learn(utrue, timed, name,
                                    warm_up=name != "grid16")
    say("phase 40 float64 witnesses: scalar_bilevel_sumregs_learn and "
        "patch_bilevel_tv_learn(method='tr_fused')")
    for name in ("sumregs", "patch_tv"):
        tvf[f"{name}_witness_f64"] = phase_tvf_witness(name)
    faults = [m for st in tvf.values() for m in st.pop("faults")]
    require(not faults, "; ".join(faults))

    tr = {}
    t_phase = time.perf_counter()
    say("phase 41 flagship default call scalar_bilevel_tv_learn("
        "dataset_name='faces_train', num_samples=10): method='tr', float64, "
        "5000 cold inner its, HypergradConfig()")
    tr["flagship_f64"] = phase_tr_flagship(
        torch.as_tensor(true_np, dtype=torch.float64).to(dev))
    say(f"  phase 41: {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    say("phase 42 flagship scalar_bilevel_tv_learn(method='tr') at the "
        "bench settings, float32")
    tr["flagship_f32"] = phase_tr_bench(utrue)
    say(f"  phase 42: {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    say("phase 43 method='tr' against 'tr_fused' at inner_tol=None, "
        "float64, full images; cut: 3 outer its")
    for name in ("sumregs", "patch_tv", "image_pair", "grid16"):
        tr[name] = phase_tr_tv_parity(name)
    say(f"  phase 43: {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    say("phase 44 method='tr' against 'tr_fused' at inner_tol=None, "
        "float64, full images, rows 4, 8, 6 in the cluster form; cut: 3 "
        "outer its")
    for name in ("tgv", "tvl1", "vtv"):
        tr[name] = tr_parity(name, *tr_pair_runs(name))
        tr[name].pop("last")
    say(f"  phase 44: {time.perf_counter() - t_phase:.1f} s")
    faults = [m for st in tr.values() for m in st.pop("faults")]
    require(not faults, "; ".join(faults))
    parent_calls.close()

    reporting = {}
    t_phase = time.perf_counter()
    say("phase 45 flagship scalar_bilevel_tv_learn(method='tr_fused') at "
        "the bench settings with save_results=True")
    reporting["learn"] = phase_reporting_learn(utrue, wall_ms)
    say(f"  phase 45: {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    say("phase 46 validate_tv/sumregs/tgv/tvl1/vtv_parameter, float64, "
        "at the learned weights")
    reporting["validations"] = phase_validations()
    say(f"  phase 46: {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    say("phase 47 the cost sweeps, float64: TV 8, 2-D TV 4x4, TGV 3x3, "
        "TV-L1 5, VTV 5 points")
    reporting["sweeps"] = phase_sweeps()
    say(f"  phase 47: {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    say("phase 48 python -m bpldenoising_tpu_torch validate-tv and "
        "cost-sweep in a subprocess")
    reporting["cli"] = phase_cli(reporting["validations"])
    say(f"  phase 48: {time.perf_counter() - t_phase:.1f} s")
    faults = [m for st in reporting.values() for m in st.pop("faults")]
    require(not faults, "; ".join(faults))

    later = {}
    with results_not_saved():
        t_phase = time.perf_counter()
        say("phase 49 segmented dispatch: the flagship with log_every=5 "
            "against phase 5; TGV, TV-L1, VTV at 3 outer its, log_every=2")
        later["segmented"] = phase_segmented(flagship, flagship_a,
                                             flagship_b)
        say(f"  phase 49: {time.perf_counter() - t_phase:.1f} s")
        t_phase = time.perf_counter()
        say("phase 50 checkpoint and resume: tr_fused stopped at 4, tr "
            "(float64 default call) at 3, each resumed")
        later["resume"] = phase_resume(flagship, flagship_a,
                                       tr["flagship_f64"])
        say(f"  phase 50: {time.perf_counter() - t_phase:.1f} s")
        t_phase = time.perf_counter()
        say("phase 51 the flagship through the CLI with --trace DIR")
        later["trace"] = phase_trace()
        say(f"  phase 51: {time.perf_counter() - t_phase:.1f} s")
        t_phase = time.perf_counter()
        say("phase 52 the differentiable layers at full width, float32 and "
            "float64")
        later["diff_layers"] = phase_diff_layers()
        say(f"  phase 52: {time.perf_counter() - t_phase:.1f} s")
    faults = [m for st in later.values() for m in st.pop("faults")]
    require(not faults, "; ".join(faults))

    parallel = {}
    walls = {}
    with results_not_saved():
        t_phase = time.perf_counter()
        say(f"phase 53 the flagship on a mesh: bilevel_learn_fused over "
            f"['cuda:0'] * {MESH_SHARDS} at the bench settings, then "
            "scalar_bilevel_tv_learn(data_parallel=True) on the default mesh")
        parallel["flagship_mesh"] = phase_mesh_flagship(utrue, f, flagship,
                                                        timed)
        walls[53] = time.perf_counter() - t_phase
        say(f"  phase 53: {walls[53]:.1f} s")
        t_phase = time.perf_counter()
        say("phase 54 method='tr' with data_parallel=True (TV, sum of "
            "regularizers; float64, 3 outer its), then the five sharded "
            "learning functions on 3 images over 4 shards, and over 3 "
            "against the unsharded functions")
        parallel["tr_sharded"] = phase_mesh_tr()
        walls[54] = time.perf_counter() - t_phase
        say(f"  phase 54: {walls[54]:.1f} s")
        t_phase = time.perf_counter()
        say(f"phase 55 the fused TGV², TV-L1 and VTV learns with "
            f"data_parallel=True on {SMOOTH_MESH_SHARDS} shards (float32, "
            "3 outer its) against their unsharded runs")
        parallel["smoothed_mesh"] = phase_mesh_smoothed()
        walls[55] = time.perf_counter() - t_phase
        say(f"  phase 55: {walls[55]:.1f} s")
        t_phase = time.perf_counter()
        say(f"phase 56 the halo solvers (rows 4, batch x rows 2x2; "
            f"{HALO_ITERS} its, float32) against the kernels")
        parallel["halo"] = phase_halo()
        walls[56] = time.perf_counter() - t_phase
        say(f"  phase 56: {walls[56]:.1f} s")
    say("  phases 53-56 walls (s): " + ", ".join(
        f"{k} {v:.1f}" for k, v in walls.items()) + f"; {smi}")
    parallel["walls_s"] = walls

    remainders = {}
    with results_not_saved():
        t_phase = time.perf_counter()
        say("phase 57 the PNG codec: the built codec against the "
            "pure-Python reader on every bundled PNG, decode ms")
        remainders["png_codec"] = phase_png_codec()
        say(f"  phase 57: {time.perf_counter() - t_phase:.1f} s")
        t_phase = time.perf_counter()
        say("phase 58 python -m bpldenoising_tpu_torch make-dataset, read "
            "back through testdataset, one scalar TV tr_fused learn on it")
        remainders["make_dataset"] = phase_make_dataset(timed)
        say(f"  phase 58: {time.perf_counter() - t_phase:.1f} s")
        for i, name in enumerate(("tgv", "tvl1", "vtv")):
            t_phase = time.perf_counter()
            label = {"tgv": "TGV²", "tvl1": "TV-L1", "vtv": "VTV"}[name]
            say(f"phase {59 + i} single-loop {label} with mesh=: "
                "data_parallel=True, then 2 and 4 shards of the card in "
                "float64 and float32")
            parallel[f"single_loop_{name}_mesh"] = phase_slx_mesh(name)
            say(f"  phase {59 + i}: {time.perf_counter() - t_phase:.1f} s; "
                f"{smi}")
        t_phase = time.perf_counter()
        say("phase 62 single-loop TV and sum of regularizers with mesh=: "
            "data_parallel=True, then 2 and 4 shards of the card in float64 "
            "and float32")
        parallel["single_loop_tv_mesh"] = phase_sl_mesh(utrue, f)
        say(f"  phase 62: {time.perf_counter() - t_phase:.1f} s; {smi}")
        t_phase = time.perf_counter()
        say("phase 63 kernel A's tile form where the bands do not fit: "
            "against the two-launch form and plain, cold, early-stopped "
            "and warm; then bilevel_learn_fused on 4x512x512 phantoms")
        tile = dict(shapes=phase_tile_shapes(f, timed))
        tile["learn"] = phase_tile_learn(timed)
        say(f"  phase 63: {time.perf_counter() - t_phase:.1f} s; {smi}")
        t_phase = time.perf_counter()
        say("phase 64 the TGV² tile form where the bands do not fit: "
            "against the two-launch form and plain at 1x1024^2, 10x256^2 "
            "cold and warm, 4x512^2 with maps and 1x512^2 float64; then "
            "bilevel_learn_tgv_fused on 2x256x256 pyramids")
        tgv_tile = dict(shapes=phase_tgv_tile_shapes(f, timed))
        tgv_tile["learn"] = phase_tgv_tile_learn(timed)
        say(f"  phase 64: {time.perf_counter() - t_phase:.1f} s; {smi}")

    itemsize = 4
    a_bytes = 4 * n * itemsize                  # f in; u, y out
    a_ops = A_OPS_PER_PIXEL_ITER * n * a_stats["iters"]
    a_bound, a_by = bound_ms(a_bytes, a_ops)
    ex = b_stats["exact"]
    b_bytes = 4 * n * itemsize                  # u, ū, p0 in; p out
    b_ops = n * (B_OPS_PER_PIXEL_CG_ITER * ex["total_cg"]
                 + B_OPS_PER_PIXEL_SOLVE * 2 + B_OPS_PER_PIXEL_FIXED)
    b_bound, b_by = bound_ms(b_bytes, b_ops)
    # TGV cold call: f in; the state (u, w, p, q: 8 planes) out
    t_bytes = 9 * n * itemsize
    t_ops = TGV_OPS_PER_PIXEL_ITER * n * tgv_stats["iters"]
    t_bound, t_by = bound_ms(t_bytes, t_ops)
    # TV-L1 cold calls: f in; the state (u, y: 3 planes) out
    sp_n = sp_f.numel()
    h_bound, h_by = bound_ms(
        4 * sp_n * itemsize,
        TVL1_HUBER_OPS_PER_PIXEL_ITER * sp_n * tvl1h_stats["iters"])
    one = tvl1_stats["single"]
    l_bound, l_by = bound_ms(4 * one["pixels"] * itemsize,
                             TVL1_OPS_PER_PIXEL_ITER * one["pixels"]
                             * one["iters"])
    big = tvl1_stats["batch64"]
    big_bound, big_by = bound_ms(4 * big["pixels"] * itemsize,
                                 TVL1_OPS_PER_PIXEL_ITER * big["pixels"]
                                 * big["iters"])
    large["tvl1_64x128"] = dict(ms=big["ms"], plain_ms=big["plain_ms"],
                                bound_ms=big_bound, bound_by=big_by)
    # VTV cold call: f in; the state (u, y: 3 planes per channel) out
    vt_n = vt_f.numel()
    v_bound, v_by = bound_ms(4 * vt_n * itemsize,
                             VTV_OPS_PER_PLANE_PIXEL_ITER * vt_n
                             * vtv_stats["iters"])
    # single-loop learner: f and ū in; u, p and the 2K duals out
    sl_n = sl_stats["pixels"]
    s_bound, s_by = bound_ms(6 * sl_n * itemsize,
                             sl_ops_per_pixel((0,), 40, 10) * sl_n
                             * sl_stats["outer"])
    sl_big = sl_tiled["pixels"]
    st_bound, st_by = bound_ms(10 * sl_big * itemsize,
                               sl_ops_per_pixel((0, 1, 2), 40, 10) * sl_big
                               * sl_tiled["outer"])
    kernels = [
        dict(name="pdps_cp_tv", route="cuda",
             source="bpldenoising_tpu_torch/csrc/pdps.cu",
             replaces="bpldenoising_tpu/solvers/pdps_pallas.py:234",
             launches=launches_a, max_abs_err=a_stats["max_abs_err"],
             ms=a_stats["ms"], plain_ms=a_stats["plain_ms"],
             bound_ms=a_bound, bound_by=a_by, library_ms=None),
        dict(name="hypergrad_al_pcg", route="cuda",
             source="bpldenoising_tpu_torch/csrc/hypergrad.cu",
             replaces="bpldenoising_tpu/solvers/hypergrad_pallas.py:47",
             launches=launches_b, max_abs_err=b_stats["max_abs_err"],
             ms=ex["ms"], plain_ms=ex["plain_ms"], bound_ms=b_bound,
             bound_by=b_by, library_ms=None),
        dict(name="tgv_cp", route="cuda",
             source="bpldenoising_tpu_torch/csrc/tgv.cu",
             replaces="bpldenoising_tpu/solvers/tgv_pallas.py:103",
             launches=tgv_learn["launches"]["tgv"],
             max_abs_err=tgv_stats["max_abs_err"], ms=tgv_stats["ms"],
             plain_ms=tgv_stats["plain_ms"], bound_ms=t_bound, bound_by=t_by,
             library_ms=None, form="cluster",
             device_ops=tgv_learn["kernel_calls"]["device_ops"]),
        dict(name="tgv_cp_1024", route="cuda",
             source="bpldenoising_tpu_torch/csrc/tgv_tile.cu",
             replaces="bpldenoising_tpu/solvers/tgv_pallas.py:217",
             launches=large["tgv_1024"]["launches"],
             max_abs_err=large["tgv_1024"]["max_abs_err"],
             ms=large["tgv_1024"]["ms"],
             plain_ms=large["tgv_1024"]["plain_ms"],
             bound_ms=large["tgv_1024"]["bound_ms"],
             bound_by=large["tgv_1024"]["bound_by"], library_ms=None,
             form="tile", two_launch_ms=large["tgv_1024"]["two_launch_ms"],
             device_ops=large["tgv_1024"]["device_ops"]),
        dict(name="tvl1_huber_cp", route="cuda",
             source="bpldenoising_tpu_torch/csrc/tvl1.cu",
             replaces="bpldenoising_tpu/solvers/tvl1_huber_pallas.py:72",
             launches=tvl1_learn["launches"]["tvl1"],
             max_abs_err=tvl1h_stats["max_abs_err"], ms=tvl1h_stats["ms"],
             plain_ms=tvl1h_stats["plain_ms"], bound_ms=h_bound,
             bound_by=h_by, library_ms=None),
        dict(name="tvl1_cp", route="cuda",
             source="bpldenoising_tpu_torch/csrc/tvl1.cu",
             replaces="bpldenoising_tpu/solvers/tvl1_pallas.py:62",
             launches=tvl1_learn["denoise"]["launches"]["tvl1"],
             max_abs_err=tvl1_stats["max_abs_err"], ms=one["ms"],
             plain_ms=one["plain_ms"], bound_ms=l_bound, bound_by=l_by,
             library_ms=None),
        dict(name="vtv_cp", route="cuda",
             source="bpldenoising_tpu_torch/csrc/vtv.cu",
             replaces="bpldenoising_tpu/solvers/vtv_pallas.py:70",
             launches=vtv_learn["launches"]["vtv"],
             max_abs_err=vtv_stats["max_abs_err"], ms=vtv_stats["ms"],
             plain_ms=vtv_stats["plain_ms"], bound_ms=v_bound, bound_by=v_by,
             library_ms=None, form="cluster",
             device_ops=vtv_learn["kernel_calls"]["device_ops"]),
        dict(name="vtv_cp_256", route="cuda",
             source="bpldenoising_tpu_torch/csrc/vtv.cu",
             replaces="bpldenoising_tpu/solvers/vtv_pallas.py:70",
             launches=large["vtv_256"]["launches"],
             max_abs_err=large["vtv_256"]["max_abs_err"],
             ms=large["vtv_256"]["ms"],
             plain_ms=large["vtv_256"]["plain_ms"],
             bound_ms=large["vtv_256"]["bound_ms"],
             bound_by=large["vtv_256"]["bound_by"], library_ms=None,
             form="two-launch", device_ops=large["vtv_256"]["device_ops"]),
        dict(name="single_loop", route="cuda",
             source="bpldenoising_tpu_torch/csrc/single_loop.cu",
             replaces="bpldenoising_tpu/bilevel/first_order_pallas.py:185",
             launches=sl_learn["launches"]["single_loop"],
             max_abs_err=sl_stats["max_abs_err"], ms=sl_stats["ms"],
             plain_ms=sl_stats["plain_ms"], bound_ms=s_bound, bound_by=s_by,
             library_ms=None),
        dict(name="single_loop_tiled", route="cuda",
             source="bpldenoising_tpu_torch/csrc/single_loop.cu",
             replaces="bpldenoising_tpu/bilevel/first_order_pallas.py:420",
             launches=sl_tiled["launches"],
             max_abs_err=sl_tiled["max_abs_err"], ms=sl_tiled["ms"],
             plain_ms=sl_tiled["plain_ms"], bound_ms=st_bound,
             bound_by=st_by, library_ms=None),
    ]
    # rows 1-3 in their K = 3 and map forms (phases 34, 35): A's cold
    # 5000-iteration calls (f and a map weight in; u and the K duals out),
    # B's exact form (u, ū, p0 and a map weight in; p and its gradient map
    # out)
    sr_kinds, n_it = (0, 1, 2), forms_a["k3"]["iters"]
    plane = f.shape[-2] * f.shape[-1]
    for name, kinds, maps, st, learn in (
            ("pdps_cp_sumregs", sr_kinds, 0, forms_a["k3"], "sumregs"),
            ("pdps_cp_tv_map", (0,), 1, forms_a["map"], "patch_tv")):
        bound, by = bound_ms(((2 + 2 * len(kinds)) * n + maps * plane)
                             * itemsize,
                             a_ops_per_pixel_iter(kinds, maps) * n * n_it)
        kernels.append(dict(
            name=name, route="cuda",
            source="bpldenoising_tpu_torch/csrc/pdps.cu",
            replaces="bpldenoising_tpu/solvers/pdps_pallas.py:234",
            launches=tvf[learn]["launches"]["pdps"],
            max_abs_err=st["max_abs_err"], ms=st["ms"],
            plain_ms=st["plain_ms"], bound_ms=bound, bound_by=by,
            library_ms=None))
    big = forms_a["k3_2048"]
    kernels.append(dict(
        name="pdps_cp_sumregs_2048", route="cuda",
        source="bpldenoising_tpu_torch/csrc/pdps.cu",
        replaces="bpldenoising_tpu/solvers/pdps_pallas.py:339",
        launches=big["launches"], max_abs_err=big["max_abs_err"], ms=big["ms"],
        plain_ms=big["plain_ms"], bound_ms=big["bound_ms"],
        bound_by=big["bound_by"], library_ms=None))
    for name, kinds, maps, st, learn in (
            ("hypergrad_al_pcg_sumregs", sr_kinds, 0, forms_b["k3"],
             "sumregs"),
            ("hypergrad_al_pcg_maps", (0,), 1, forms_b["map"], "patch_tv")):
        ex = st["exact"]
        bound, by = bound_ms((4 * n + maps * (plane + n)) * itemsize,
                             n * b_ops_per_pixel(kinds, ex["total_cg"], 2))
        kernels.append(dict(
            name=name, route="cuda",
            source="bpldenoising_tpu_torch/csrc/hypergrad.cu",
            replaces="bpldenoising_tpu/solvers/hypergrad_pallas.py:47",
            launches=tvf[learn]["launches"]["hypergrad"],
            max_abs_err=st["max_abs_err"], ms=ex["ms"],
            plain_ms=ex["plain_ms"], bound_ms=bound, bound_by=by,
            library_ms=None))
    # the other families' learners: the library call's 300 outer steps at
    # the bench shape (phase (c)); rows 11 and 13 name their device
    # kernels (the CP cluster kernel first), whose agreement is the row's
    for name, line in (("tgv", 55), ("tvl1", 63), ("vtv", 54)):
        st = slx[name]
        bound, by = st["call"]["bound_ms"], st["call"]["bound_by"]
        kernels.append(dict(
            name=f"single_loop_{name}", route="cuda",
            source=f"bpldenoising_tpu_torch/csrc/single_loop_{name}.cu",
            replaces=(f"bpldenoising_tpu/bilevel/first_order_{name}"
                      f"_pallas.py:{line}"),
            launches=st["learn"]["launches"][f"single_loop_{name}"],
            max_abs_err=st["max_abs_err"], ms=st["call"]["ms"],
            plain_ms=st["plain_ms"], bound_ms=bound, bound_by=by,
            library_ms=None, **SLX_DEVICE_KERNELS.get(name, {})))
    t1024 = tile["shapes"]["1x1024x1024 K=1"]["cold"]
    kernels.append(dict(
        name="pdps_tile_tv_1024", route="cuda",
        source="bpldenoising_tpu_torch/csrc/pd_tile.cuh",
        replaces="bpldenoising_tpu/solvers/pdps_pallas.py:339",
        launches=tile["learn"]["tiled_calls"],
        max_abs_err=max(r[m]["max_err"] for r in tile["shapes"].values()
                        if r["dtype"] == "float32"
                        for m in ("cold", "early stop", "warm")),
        ms=t1024["ms"], plain_ms=t1024["plain_ms"],
        bound_ms=t1024["bound_ms"], bound_by=t1024["bound_by"],
        library_ms=None, form="tile",
        two_launch_ms=t1024["two_launch_ms"],
        device_ops=tile["learn"]["device_ops"]))
    t256 = tgv_tile["shapes"]["10x256x256"]["cold"]
    kernels.append(dict(
        name="tgv_tile_256", route="cuda",
        source="bpldenoising_tpu_torch/csrc/tgv_tile.cu",
        replaces="bpldenoising_tpu/solvers/tgv_pallas.py:217",
        launches=tgv_tile["learn"]["tiled_calls"],
        max_abs_err=max(r[m]["max_err"] for r in tgv_tile["shapes"].values()
                        if r["dtype"] == "float32"
                        for m in ("cold", "warm") if m in r),
        ms=t256["ms"], plain_ms=t256["plain_ms"], bound_ms=t256["bound_ms"],
        bound_by=t256["bound_by"], library_ms=None, form="tile",
        two_launch_ms=t256["two_launch_ms"],
        device_ops=tgv_tile["learn"]["device_ops"]))
    say(f"  total {time.perf_counter() - t_start:.1f} s")
    say(json.dumps({"kernels": kernels, "flagship": dict(
        alpha=alpha, alpha_abs_err=d_alpha, mean_psnr_db=mean_psnr,
        final_cost=cost, outer_iterations=res.iterations,
        wall_ms=wall_ms, load_ms=load_ms), "tgv_learn": tgv_learn,
        "tgv_patch_learn": tgv_patch, "tvl1_learn": tvl1_learn,
        "tvl1_patch_learn": tvl1_patch, "vtv_learn": vtv_learn,
        "vtv_patch_learn": vtv_patch, "large_images": large,
        "single_loop_kernel": sl_stats, "single_loop_learn": sl_learn,
        "single_loop_sumregs_learn": sl_sumregs,
        "single_loop_batch64": sl_tiled,
        "single_loop_tgv": slx["tgv"], "single_loop_tvl1": slx["tvl1"],
        "single_loop_vtv": slx["vtv"], "forms_a": forms_a,
        "forms_b": forms_b, "forms_f64_max_rel_err": forms_f64,
        "tv_family_learns": tvf, "tr_learns": tr, "reporting": reporting,
        "segmented_resume_trace_layers": later, "parallel": parallel,
        "remainders": remainders, "tile_form": tile,
        "tgv_tile_form": tgv_tile, "device": smi}))
    faulthandler.cancel_dump_traceback_later()
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
