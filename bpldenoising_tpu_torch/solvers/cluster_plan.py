"""The thread-block cluster plan of the CP iterations that keep each image
on-chip (``csrc/pd_cluster.cuh``): kernel A's chunks (:mod:`.pdps_cuda`),
the TV-L1 kernel's chunks and the single-loop TV-L1 learner's CP phase
(:mod:`.tvl1_cuda`'s ``tvl1_plan``, :mod:`..bilevel.first_order_tvl1_cuda`)
and the single-loop learner's PD phase (:mod:`..bilevel.first_order_cuda`);
of the TGV² CP solve's chunks and the single-loop TGV² learner's CP phase
(``csrc/tgv_cluster.cuh``: :mod:`.tgv_cuda`,
:mod:`..bilevel.first_order_tgv_cuda`) and of the VTV CP solve's chunks
and the single-loop VTV learner's CP phase (``csrc/vtv_cluster.cuh``:
:mod:`.vtv_cuda`, :mod:`..bilevel.first_order_vtv_cuda`).

One cluster runs one image; each CTA holds a band of rows with two halo
rows above and below in shared memory.  :func:`pd_plan`, :func:`tgv_plan`
and :func:`vtv_plan` decide from the shapes alone, before any launch, how
many CTAs an image takes, how many rows each owns and whether the bands
fit in shared memory.  :func:`cg_block_slots` decides, likewise, how many
256-element partial blocks a block of the TGV², TV-L1 and VTV learners' CG
launches takes.
"""

from __future__ import annotations

from typing import NamedTuple

__all__ = ["PdPlan", "pd_plan", "tgv_plan", "vtv_plan", "cg_block_slots",
           "MAX_CLUSTER", "MAX_CLUSTER_NP", "SMS", "SMEM_PER_BLOCK",
           "TGV_PLANES", "TGV_SLOT_ROWS", "CG_BLOCK"]

#: the largest portable thread-block cluster (csrc/pd_cluster.cuh's
#: PD_MAX_CLUSTER)
MAX_CLUSTER = 8
#: the largest cluster the band kernels launch, a non-portable size
#: (PD_MAX_CLUSTER_NP)
MAX_CLUSTER_NP = 16
#: the streaming multiprocessors of an H100 SXM
SMS = 132
#: the dynamic shared memory a block may opt in to on an H100 (227 KB)
SMEM_PER_BLOCK = 232448
#: a TGV² band's planes (csrc/tgv_cluster.cuh: u, ū, w_r, w_c, w̄_r, w̄_c
#: and the five duals) and its halo-slot rows (two parities, two sides, two
#: rows, five duals)
TGV_PLANES = 11
TGV_SLOT_ROWS = 40
#: a CG partial block of the single-loop learners (BPL_THREADS elements)
CG_BLOCK = 256


class PdPlan(NamedTuple):
    """The band launch for one image: ``cluster`` CTAs, each owning
    ``rows`` image rows (the last CTAs may own fewer, or none), with
    ``planes`` band planes (u, ū and the K duals' two components) of
    rows + 4 rows (two halo rows above and below) and 16·K halo-slot rows
    (two parities, two sides, two rows, 2K planes), each of N elements;
    ``smem`` bytes of dynamic shared memory per CTA, ``resident`` when the
    bands live there (else ``smem`` 0: the single-loop learner keeps them
    in a global scratch laid out alike, kernel A runs its two-launch
    form)."""
    cluster: int
    rows: int
    planes: int
    smem: int
    resident: bool


def _cluster_rows(M: int, max_cluster: int) -> tuple:
    """The largest power of two up to ``max_cluster`` that leaves every CTA
    but the last at least two rows, and ⌈M / cluster⌉ rows each."""
    cluster = 1
    while cluster * 2 <= min(M // 2, max_cluster):
        cluster *= 2
    return cluster, -(-M // cluster)


def pd_plan(M: int, N: int, K: int, itemsize: int,
            max_cluster: int = MAX_CLUSTER) -> PdPlan:
    """The rule for the cluster: the largest power of two up to
    ``max_cluster`` that leaves every CTA but the last at least two rows
    (the halo rows each side then come from the adjacent CTAs; more CTAs
    per image fill more of the card at small batches, and each adds four
    halo rows of work), ⌈M / cluster⌉ rows each, and the bands in shared
    memory when ((2 + 2K)(rows + 4) + 16K)·N·itemsize bytes fit in
    ``SMEM_PER_BLOCK``.  The CUDA side checks the plan against the card
    (its opt-in shared memory and ``cudaOccupancyMaxActiveClusters``) and
    the wrappers raise when it cannot run."""
    if min(M, N, K, itemsize) < 1 \
            or not 1 <= max_cluster <= MAX_CLUSTER_NP:
        raise ValueError(f"bad shape M={M}, N={N}, K={K}, itemsize="
                         f"{itemsize}, max_cluster={max_cluster}")
    cluster, rows = _cluster_rows(M, max_cluster)
    planes = 2 + 2 * K
    smem = (planes * (rows + 4) + 16 * K) * N * itemsize
    resident = smem <= SMEM_PER_BLOCK
    return PdPlan(cluster, rows, planes, smem if resident else 0, resident)


def tgv_plan(M: int, N: int, itemsize: int) -> PdPlan:
    """The band plan of the TGV² CP iterations on M × N images (the CP
    solve's chunks, ``csrc/tgv.cu``; the single-loop TGV² learner's CP
    phase): :func:`pd_plan`'s split of an image's rows over up to 16 CTAs,
    with the TGV² band of (11·(rows + 4) + 40)·N·itemsize bytes in shared
    memory where it fits in ``SMEM_PER_BLOCK``, else ``smem`` 0 and
    ``resident`` False (the learner keeps the bands in a global scratch,
    the CP solve runs its two-launch form).  At 128² float32 the 16-CTA band
    (88 KB) lets two CTAs share an SM and the 8-CTA band (133 KB) does
    not: on an H100 16 CTAs beat 8 at 1 to 64 images by 21% to 5%
    (scripts/cluster_sizes.py tgv_sl); in float64 only the 16-CTA band
    (176 KB) fits.  The CUDA side checks the plan against the card and the
    wrapper raises when it cannot run."""
    if min(M, N, itemsize) < 1:
        raise ValueError(f"bad shape M={M}, N={N}, itemsize={itemsize}")
    cluster, rows = _cluster_rows(M, MAX_CLUSTER_NP)
    smem = (TGV_PLANES * (rows + 4) + TGV_SLOT_ROWS) * N * itemsize
    resident = smem <= SMEM_PER_BLOCK
    return PdPlan(cluster, rows, TGV_PLANES, smem if resident else 0,
                  resident)


def vtv_plan(M: int, N: int, C: int, itemsize: int) -> PdPlan:
    """The band plan of the VTV CP iterations on C-channel M × N images
    (the CP solve's chunks, ``csrc/vtv.cu``; the single-loop VTV learner's
    CP phase): :func:`pd_plan`'s split of an image's rows over up to 16
    CTAs, with the VTV band of (4C·(rows + 4) + 16C)·N·itemsize bytes (u,
    ū and the two dual components of each channel; two parities, two
    sides, two rows of the 2C dual planes as halo slots) in shared memory
    where it fits in ``SMEM_PER_BLOCK``, else ``smem`` 0 and ``resident``
    False (the learner keeps the bands in a global scratch, the CP solve
    runs its two-launch form).  At 128², C = 3, float32 the 16-CTA
    band (96 KB) lets two CTAs share an SM and the 8-CTA band (144 KB) does
    not; in float64 only the 16-CTA band (192 KB) fits.  The CUDA side
    checks the plan against the card and the wrapper raises when it cannot
    run."""
    if min(M, N, C, itemsize) < 1:
        raise ValueError(f"bad shape M={M}, N={N}, C={C}, itemsize="
                         f"{itemsize}")
    cluster, rows = _cluster_rows(M, MAX_CLUSTER_NP)
    planes = 4 * C
    smem = (planes * (rows + 4) + 16 * C) * N * itemsize
    resident = smem <= SMEM_PER_BLOCK
    return PdPlan(cluster, rows, planes, smem if resident else 0, resident)


def cg_block_slots(B: int, M: int, N: int, planes: int) -> int:
    """The partial blocks a CG block of the TGV², TV-L1 and VTV learners
    takes: ``planes`` (the same 256 pixels of every plane, each pixel's
    operand and weights formed once) where M·N is a multiple of 256 and
    that grid of B·M·N/256 blocks still gives each of the card's SMs one,
    else 1 (every partial block a CG block: at one 128² image of three
    planes 192 blocks, against 64 that leave half the SMs idle).  Both give
    the same bits; at one plane (TV-L1) the rule is always 1."""
    mn = M * N
    return planes if mn % CG_BLOCK == 0 and B * (mn // CG_BLOCK) >= SMS \
        else 1
