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

Where kernel A's bands do not fit, its tile form (``csrc/pd_tile.cuh``)
runs: :func:`pd_tile_plan` cuts each image into 2-D tiles, one CTA a tile,
each holding its owned pixels and a halo of H = reach·T pixels on every side
in shared memory over the T iterations of a launch.  Where the TGV² CP
solve's bands do not fit, its tile form (``csrc/tgv_tile.cu``) runs the
same scheme on the eleven TGV² planes with a halo of T:
:func:`tgv_tile_plan`.
"""

from __future__ import annotations

from typing import NamedTuple

__all__ = ["PdPlan", "pd_plan", "tgv_plan", "vtv_plan", "cg_block_slots",
           "TilePlan", "pd_tile_plan", "stencil_reach", "tgv_tile_plan",
           "tgv_tile_geometry", "MAX_CLUSTER",
           "MAX_CLUSTER_NP", "SMS", "SMEM_PER_BLOCK", "TGV_PLANES",
           "TGV_SLOT_ROWS", "CG_BLOCK"]

import functools
import math

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


# ---------------------------------------------------------------- tile form

#: a tile CTA's shared memory: the planes, each starting on 128 bytes (the
#: TMA's alignment), after one 128-byte slot for the load barrier
TILE_ALIGN = 128
#: the largest box side of a TMA copy (and so of a padded tile)
TILE_BOX_MAX = 256
#: the longest launch the plan considers, in iterations
TILE_T_MAX = 32
#: tile CTAs an SM (a tile's shared memory is SMEM_PER_BLOCK over this):
#: two, whose loads and stores overlap each other's iterations, measured
#: faster than one larger tile an SM (scripts/tile_sizes.py, H100)
TILE_CTAS_PER_SM = 2
#: the cost model's weights: shared-memory bytes a pixel and iteration
#: (primal and dual reads and writes of u, ū and the duals) for the first
#: block and each further one, and the shared-memory bytes that weigh as
#: much as one device byte.  The bandwidths' ratio (~29.6 TB/s over 3.35
#: TB/s) would be ~9; the iterations cost more than their shared-memory
#: bytes (bound by the instructions of a pixel's passes), and 4 puts the
#: plan's T between the best measured ones (scripts/tile_sizes.py, H100)
TILE_SMEM_BYTES = (14, 9)
TILE_BW_RATIO = 4.0


class TilePlan(NamedTuple):
    """Kernel A's tile launch: tiles of ``rows`` × ``cols`` owned pixels
    (the last in a row or column of tiles may own fewer), ``tiles_m`` ×
    ``tiles_n`` an image, each run by one CTA that holds u, ū and the 2K
    dual planes (``planes``) on a ``height`` × ``pitch`` window: the owned
    tile with a halo of ``H`` = reach·``T`` pixels on every side, its
    columns from a column of 16 bytes (``pitch`` = cols + 2H + 16 bytes − 1
    element, rounded up to 16 bytes), for ``T`` iterations a launch;
    ``smem`` bytes of dynamic shared memory a CTA, ``grid`` CTAs a launch
    (one a tile), ``tma`` when TMA copies apply (rows of 16 bytes, and the
    window no larger than the image, so that a load box starts inside it at
    a column of 16 bytes: the card refuses a box at another column), else
    plain loads and stores."""
    rows: int
    cols: int
    T: int
    H: int
    height: int
    pitch: int
    planes: int
    smem: int
    tiles_m: int
    tiles_n: int
    grid: int
    tma: bool


def stencil_reach(kinds) -> int:
    """Pixels an iteration's dependence moves on each side (rows or
    columns) for blocks of these stencil kinds (0 forward, 1 backward, 2
    centred): the primal step reads yₖ at i − 1 (forward, centred) and
    i + 1 (backward, centred), the dual step reads ū at i − 1 (backward,
    centred) and i + 1 (forward, centred).  1 when every block is forward
    or every block is backward, else 2 (a centred block, or forward and
    backward blocks together)."""
    kinds = set(kinds)
    if not kinds or not kinds <= {0, 1, 2}:
        raise ValueError(f"bad stencil kinds {sorted(kinds)}")
    return 1 if kinds in ({0}, {1}) else 2


def _round_up(x: int, a: int) -> int:
    return -(-x // a) * a


def _geometry(M, N, planes, itemsize, H, T, rows, cols, images):
    """The tile plan of T iterations a launch, a halo of H pixels and tiles
    of at most ``rows`` × ``cols`` owned pixels, balanced over the image
    (every tile of a column of tiles but the last takes ⌈M / tiles_m⌉
    rows; the widths likewise, rounded up to 16 bytes), with ``planes``
    planes in shared memory."""
    a = max(1, 16 // itemsize)            # elements of 16 bytes
    tiles_m = -(-M // max(1, min(rows, M)))
    th = -(-M // tiles_m)
    # owned widths of 16 bytes (the TMA store's box)
    tw = _round_up(-(-N // -(-N // max(1, min(cols, N)))), a)
    tiles_m, tiles_n = -(-M // th), -(-N // tw)
    height = th + 2 * H
    # the halo region's columns from a column of 16 bytes (a TMA box's)
    pitch = _round_up(tw + 2 * H + a - 1, a)
    smem = TILE_ALIGN + planes * _round_up(height * pitch * itemsize,
                                           TILE_ALIGN)
    tma = (N * itemsize) % 16 == 0 and pitch <= N and height <= M
    return TilePlan(th, tw, T, H, height, pitch, planes, smem, tiles_m,
                    tiles_n, images * tiles_m * tiles_n, tma)


def tile_geometry(M, N, K, itemsize, reach, T, rows, cols, *,
                  images=1) -> TilePlan:
    """Kernel A's tile plan of T iterations a launch and tiles of at most
    ``rows`` × ``cols`` owned pixels (:func:`_geometry`), the halo
    H = reach·T and the planes u, ū and the 2K duals."""
    return _geometry(M, N, 2 + 2 * K, itemsize, reach * T, T, rows, cols,
                     images)


def _tile_work(p: TilePlan, reach):
    """Pixels one tile's T iterations compute: each iteration on the halo
    region less what the iterations before it spent, ``reach`` pixels a
    side an iteration, and half a reach more for its own steps."""
    work = 0
    for t in range(p.T):
        edge = reach * (2 * t + 1)
        work += max(p.height - edge, 0) * max(p.cols + 2 * p.H - edge, 0)
    return work


def _tile_time(p: TilePlan, work, per_px, state, itemsize, n_maps, images,
               ctas):
    """Modelled card time of one iteration (arbitrary units): waves of
    ``ctas`` CTAs an SM, each T iterations of shared-memory work (``work``
    pixels of ``per_px`` accesses) plus its loads (``state`` planes of the
    window) and stores (the same planes of its owned pixels) over device
    memory and its reads of f and the maps through L2."""
    waves = -(-images * p.tiles_m * p.tiles_n // (SMS * ctas))
    ld = state * p.height * p.pitch
    st = state * p.rows * p.cols
    # f and the maps through L2: one read a pixel and iteration
    l2 = (1 + n_maps) * work / 2
    comp = work * per_px * itemsize / TILE_BW_RATIO
    mem = (ld + st) * itemsize + l2 * itemsize / 4
    return waves * ctas * (comp + mem) / p.T


def _tile_cost(p: TilePlan, K, itemsize, reach, n_maps, images):
    """Kernel A's :func:`_tile_time`: TILE_CTAS_PER_SM CTAs an SM, u and
    the 2K duals loaded and stored, TILE_SMEM_BYTES accesses a pixel."""
    per_px = TILE_SMEM_BYTES[0] + TILE_SMEM_BYTES[1] * (K - 1)
    return _tile_time(p, _tile_work(p, reach), per_px, 1 + 2 * K, itemsize,
                      n_maps, images, TILE_CTAS_PER_SM)


def _best_tile(M, N, planes, itemsize, reach, budget, geometry, cost):
    """The plan of least ``cost`` among ``geometry(T, rows, cols)`` for T
    up to ``TILE_T_MAX`` (halo reach·T) and the tiles whose padded
    planes fit in ``budget`` bytes with sides of at most ``TILE_BOX_MAX``;
    None where none fits."""
    best, best_cost = None, math.inf
    for t in range(1, TILE_T_MAX + 1):
        H = reach * t
        # the widest padded row the budget leaves for a square tile, and
        # every owned width up to it in steps that change the tile count
        side = min(TILE_BOX_MAX, math.isqrt(
            (budget - TILE_ALIGN) // (planes * itemsize)))
        if side - 2 * H < 1:
            continue
        widths = sorted({-(-N // n) for n in range(
            -(-N // (side - 2 * H)), -(-N // (side - 2 * H)) + 8)
            if n <= N})
        for cols in widths:
            pitch = _round_up(cols + 2 * H + 15 // itemsize,
                              max(1, 16 // itemsize))
            if pitch > TILE_BOX_MAX:
                continue
            plane_max = ((budget - TILE_ALIGN) // planes) // TILE_ALIGN \
                * TILE_ALIGN
            height = min(TILE_BOX_MAX, plane_max // (pitch * itemsize))
            if height - 2 * H < 1:
                continue
            n0 = -(-M // (height - 2 * H))
            for n in range(n0, n0 + 8):
                if n > M:
                    break
                p = geometry(t, -(-M // n), cols)
                if p.smem > budget or p.height > TILE_BOX_MAX:
                    continue
                c = cost(p)
                if c < best_cost:
                    best, best_cost = p, c
    return best


@functools.lru_cache(maxsize=256)
def pd_tile_plan(M: int, N: int, K: int, itemsize: int, n_maps: int,
                 centred: bool, *, images: int = 1) -> TilePlan:
    """Kernel A's tile plan for ``images`` M × N images of K blocks (``n_maps``
    of them with (M, N) weight maps; ``centred``: the blocks reach two
    pixels an iteration, :func:`stencil_reach`), from the shapes alone: the
    halo H = reach·T, and the T (up to ``TILE_T_MAX``) and tile sides that
    minimise :func:`_tile_cost` among the tiles whose padded planes fit in
    ``SMEM_PER_BLOCK / TILE_CTAS_PER_SM`` bytes with sides of at most
    ``TILE_BOX_MAX``.  The CUDA side checks the plan (the halo against the
    blocks' reach, the tile against the card's shared memory and
    occupancy) and the wrapper raises when it cannot run."""
    if min(M, N, K, itemsize, images) < 1 or n_maps < 0 or n_maps > K:
        raise ValueError(f"bad shape M={M}, N={N}, K={K}, itemsize="
                         f"{itemsize}, n_maps={n_maps}, images={images}")
    reach = 2 if centred else 1
    budget = SMEM_PER_BLOCK // TILE_CTAS_PER_SM
    best = _best_tile(
        M, N, 2 + 2 * K, itemsize, reach, budget,
        lambda t, rows, cols: tile_geometry(M, N, K, itemsize, reach, t,
                                            rows, cols, images=images),
        lambda p: _tile_cost(p, K, itemsize, reach, n_maps, images))
    if best is None:
        raise ValueError(f"no tile fits {budget} bytes at M={M}, N={N}, "
                         f"K={K}, itemsize={itemsize}")
    return best


# ------------------------------------------------------- the TGV² tile form

#: the state planes a TGV² tile launch loads and stores: u, w_r, w_c and
#: the five duals (ū, w̄_r, w̄_c are the shared-memory scratch of the
#: TGV_PLANES)
TGV_TILE_STATE = 8
#: pixels the TGV² iteration's dependence moves on each side: the halo is
#: TGV_TILE_REACH·T.  Each variable is computed on its own region (u and ū
#: one pixel further in at the top and left, w and w̄ at the bottom and
#: right, p and q one pixel in on both), the cone the iteration has, so
#: H = T is exact; the uniform shrink per half-step, as kernel A's and the
#: TPU kernel's, needs H = 2T and ran slower on an H100
#: (scripts/tgv_tile_sizes.py)
TGV_TILE_REACH = 1
#: tile CTAs an SM by itemsize: two in float32 (64 registers a thread);
#: one in float64, whose step takes ~120 registers a thread
TGV_TILE_CTAS = {4: 2, 8: 1}
#: shared-memory accesses of a pixel's iteration: the primal step's 15
#: reads (p twice and q three times across the stencils, u and w) and 6
#: writes (u, ū, w, w̄), the dual step's 14 reads (ū, w̄ across the
#: stencils, p, q) and 5 writes; kernel A's TILE_SMEM_BYTES count alike
#: (14 at K = 1)
TGV_TILE_SMEM_ACCESSES = 40


def tgv_tile_geometry(M, N, itemsize, T, rows, cols, *, images=1,
                      reach=TGV_TILE_REACH) -> TilePlan:
    """The TGV² tile plan of T iterations a launch and tiles of at most
    ``rows`` × ``cols`` owned pixels (:func:`_geometry`): the halo
    H = reach·T and the TGV_PLANES planes."""
    return _geometry(M, N, TGV_PLANES, itemsize, reach * T, T, rows, cols,
                     images)


@functools.lru_cache(maxsize=256)
def tgv_tile_plan(M: int, N: int, itemsize: int, n_maps: int,
                  images: int = 1) -> TilePlan:
    """The TGV² CP solve's tile plan (``csrc/tgv_tile.cu``) for ``images``
    M × N images with ``n_maps`` (M, N) weight maps (0–2), from the shapes
    alone: the halo H = TGV_TILE_REACH·T, and the T (up to ``TILE_T_MAX``)
    and tile sides that minimise the modelled time (:func:`_tile_time`:
    TGV_TILE_CTAS CTAs an SM, the eight state planes loaded and stored,
    TGV_TILE_SMEM_ACCESSES a pixel) among the tiles whose eleven padded
    planes fit in ``SMEM_PER_BLOCK / TGV_TILE_CTAS`` bytes with sides of at
    most ``TILE_BOX_MAX``, on a grid of at most one wave of CTAs that
    walk the tiles.  :func:`tgv_plan` (the band plan, which the
    single-loop TGV² learner also reads) decides where it runs.  Raises
    ``ValueError`` where no tile fits; the CUDA side checks the plan (the
    halo, the tile against the card's shared memory and occupancy) and the
    wrapper raises when it cannot run."""
    if min(M, N, itemsize, images) < 1 or not 0 <= n_maps <= 2 \
            or itemsize not in TGV_TILE_CTAS:
        raise ValueError(f"bad shape M={M}, N={N}, itemsize={itemsize}, "
                         f"n_maps={n_maps}, images={images}")
    ctas = TGV_TILE_CTAS[itemsize]
    budget = SMEM_PER_BLOCK // ctas
    reach = TGV_TILE_REACH

    def cost(p):
        return _tile_time(p, _tile_work(p, reach), TGV_TILE_SMEM_ACCESSES,
                          TGV_TILE_STATE, itemsize, n_maps, images, ctas)

    best = _best_tile(
        M, N, TGV_PLANES, itemsize, reach, budget,
        lambda t, rows, cols: tgv_tile_geometry(M, N, itemsize, t, rows,
                                                cols, images=images,
                                                reach=reach),
        cost)
    if best is None:
        raise ValueError(f"no TGV² tile fits {budget} bytes at M={M}, "
                         f"N={N}, itemsize={itemsize}")
    # one wave of CTAs that walk the tiles: 0.4–4.6% faster than one CTA a
    # tile at 1×1024², 10×256², 4×512² and 1×512² float64 on an H100 over
    # two runs of scripts/tgv_tile_sizes.py
    return best._replace(grid=min(best.grid, ctas * SMS))
