// Kernel B: augmented-Lagrangian exact hypergradient with Jacobi-PCG, and
// its γ-regularized form, for K ≤ 3 regularizer blocks, each with its own
// stencil (forward, backward, centred) and a scalar or (M, N) map weight.
//
// Replaces the TPU kernel bpldenoising_tpu/solvers/hypergrad_pallas.py::_hg_kernel
// (dispatched by _run), which keeps the whole AL iteration resident in VMEM.
// It solves, as ONE joint system over the image batch,
//   M p = b,  M = I + Σₖ Gₖᵀ[μ·actₖ + inactₖ·αₖ·Hₖ]Gₖ      (exact form)
//             M = I + Σₖ αₖ·Gₖᵀ[γ·inactₖ + actₖ·Hₖ]Gₖ     (regularized form)
// with Hₖ v = v/denₖ − Guₖ (Guₖ·v)/denₖ³, the Jacobi preconditioner from the
// stencils' Gram diagonals, CG stopped at ‖r‖ ≤ cg_tol·‖b‖ or cg_maxiter,
// `al_iters` multiplier updates λₖ ← λₖ + μ·actₖ·Gₖp (exact form only) and
// the warm start p0; then dJ/dαₖ = ∓Σ Gₖp·Guₖ·fieldₖ, as K scalars or, for
// map weights, as K per-pixel maps (O, M, N) that the caller pulls back.
// The sums over k are taken k = 0, 1, 2 in order, as in the plain version.
//
// What bounds it on an H100: each CG iteration applies the stencil operator
// and needs two batch-wide dot products, i.e. global synchronisations, on
// ~10–25 MB of planes that sit in the 50 MB L2 (6 + 10K planes of n = O·M·N
// elements: K = 1 at 10×128² f32 10.5 MB, K = 3 23.6 MB): ~2–3 µs of device
// work an iteration.  With kernel boundaries as the synchronisation (the
// first design: six launches and a host read of ‖r‖² an iteration) the
// iteration cost ~38 µs of launch issue and host round trip.  This design:
//
//  * ONE cooperative launch per call (hg_coop) runs the whole AL solve:
//    set-up, diagonal, `al_iters` × (right-hand side, PCG, λ update) and
//    the gradient.  The grid is min(virtual blocks, co-resident CTAs): a
//    virtual block is the first design's block, 256 consecutive flat
//    indices, and each CTA walks the virtual blocks grid-stride.  The
//    co-resident count (occupancy × SMs) is taken before the launch, and a
//    cooperative launch guarantees co-residency, so a grid-wide barrier
//    (cooperative_groups' grid.sync()) cannot deadlock.  A refused
//    occupancy query or launch returns its error, which the wrapper raises.
//  * Three grid barriers per CG iteration: (a) after d is updated, (b)
//    after the d·Md partials, (c) after the r·z and r·r partials.  The
//    dual-space weights W·Gd are not stored: the apply recomputes them at
//    the pixel and at its stencil neighbours from d and the set-up planes
//    (a pointwise function, so the same bits as a stored plane).
//  * The parent's digits: every virtual block reduces its partial with
//    common.cuh's block_sum into partials[vb]; after the barrier every CTA
//    sums the partials redundantly in sum_partials' order, so each CTA
//    holds the same scalars with no broadcast barrier.  Per-pixel
//    arithmetic keeps its order (-fmad=false).  The stop test runs on the
//    device with the host's expressions in T (‖b‖ clamped at tiny, thresh
//    = tol·‖b‖, k < maxiter && √rr > thresh), so every CTA takes the same
//    decision and the CG counts are the first design's.
//  * Partials of the scalars that are in flight together live in separate
//    regions (d·Md; r·z; r·r; b·b; the K gradients), so a CTA that has
//    passed a barrier never overwrites a partial that a slower CTA is still
//    summing.
//  * stats (‖r‖², ‖b‖² and the iterations of the last solve, the
//    iterations of all solves) are written to device memory and read once
//    per call: one launch and one device→host read a call.
//  * The kernel is instantiated for the forms of the main paths (HgForm:
//    K = 1 forward; K = 3 forward, backward, centred) and a generic one, so
//    the stencil branches and the loops over k fold away.
#include <cooperative_groups.h>

#include "common.cuh"

namespace bpl {

namespace cgr = cooperative_groups;

// Work planes (each n = O·M·N elements): five shared by the blocks, then
// ten per block k (PER_K of them, from plane SHARED + PER_K·k).  WX and WY
// hold the diagonal's weights of the set-up.
enum Plane { INV_DIAG, RES, ZZ, DIR, MDIR, SHARED };
enum KPlane {
  GUX, GUY, ACT, DEN, INV_DEN, INV_DEN3, WX, WY, LAMX, LAMY, PER_K
};
// regions of nblocks partial sums each; R_GRAD0 + k holds block k's
// gradient
enum Region { R_DMD, R_RZ, R_RR, R_BB, R_GRAD0, N_REGIONS = R_GRAD0 + 3 };
// device scalar slots: GRAD0 + k holds block k's gradient
enum Slot { GRAD0, N_SLOTS = GRAD0 + 3 };
// device stats: ‖r‖², ‖b‖², the last solve's iterations, all iterations
enum Stat { ST_RR, ST_BB, ST_IT, ST_TOTAL, N_STATS };

template <typename T>
struct HG {
  const T* u;
  const T* ut;
  const T* p0;   // the warm start, or nullptr: p starts at 0
  T* p;
  T* w;          // SHARED + PER_K·K planes
  T* partials;   // N_REGIONS × nblocks
  T* scal;       // N_SLOTS
  T* gmaps;      // K gradient maps of n elements, or nullptr: K scalars
  double* stats; // N_STATS
  long long n;
  int M, N, nblocks, K;
  int kind[3];
  T alpha[3];
  const T* amap[3];   // (M, N) weight maps, nullptr: the scalar alpha[k]
  T act_tol, gamma, mu, cg_tol;
  int reg, n_al, cg_maxiter;
  __host__ __device__ T* plane(int s) const { return w + (long long)s * n; }
  __host__ __device__ T* kplane(int k, int s) const {
    return w + (long long)(SHARED + PER_K * k + s) * n;
  }
  __device__ T* region(int r) const {
    return partials + (long long)r * nblocks;
  }
  // block k's weight at pixel p (a map is broadcast over the batch)
  __device__ T alpha_at(int k, Pix p) const {
    return amap[k] != nullptr ? amap[k][(long long)p.i * N + p.j] : alpha[k];
  }
};

// The blocks of a kernel instance.  F ≥ 0 fixes them at compile time as
// (K << 8) | kinds (two bits a block), so the stencils' branches and the
// loops over k fold away: scalar or map TV (the flagship, patch TV, the
// grids) and the forward, backward and centred blocks of the sum of
// regularizers.  F < 0 reads them from h.
enum HgForm {
  HG_ANY = -1,
  HG_TV = (1 << 8) | STENCIL_FWD,
  HG_SUMREGS = (3 << 8) | STENCIL_FWD | (STENCIL_BWD << 2)
               | (STENCIL_CEN << 4)
};

template <int F, typename T>
__device__ __forceinline__ int n_blocks(const HG<T>& h) {
  return F >= 0 ? (F >> 8) & 15 : h.K;
}

template <int F, typename T>
__device__ __forceinline__ int kind_of(const HG<T>& h, int k) {
  return F >= 0 ? (F >> (2 * k)) & 3 : h.kind[k];
}

__device__ __forceinline__ Pix shifted(Pix p, int di, int dj) {
  p.i += di;
  p.j += dj;
  return p;
}

// Gᵀ(act·λ) along one axis: common.cuh's adj1 on the product, whose
// factors are read at the same neighbours.
template <typename T>
__device__ __forceinline__ T adj1_prod(const T* a, const T* q, long long idx,
                                       int i, int n, long long s, int kind) {
  if (kind == STENCIL_FWD) {
    T lo = i >= 1 ? a[idx - s] * q[idx - s] : T(0);
    T hi = i < n - 1 ? a[idx] * q[idx] : T(0);
    return lo - hi;
  }
  if (kind == STENCIL_BWD) {
    T lo = i >= 1 ? a[idx] * q[idx] : T(0);
    T hi = i < n - 1 ? a[idx + s] * q[idx + s] : T(0);
    return lo - hi;
  }
  T down = i >= 2 ? a[idx - s] * q[idx - s] : T(0);
  T up = i <= n - 3 ? a[idx + s] * q[idx + s] : T(0);
  return (down - up) * T(0.5);
}

// Per block: Gu, the active set, den, 1/den, 1/den³ and the diagonal
// weights (into WX, WY), in the arithmetic order of solvers/hypergrad.py;
// λ = 0 (exact form) and p = p0 or 0.
template <int F, typename T>
__device__ __forceinline__ void setup_px(const HG<T>& h, long long idx,
                                         Pix p) {
  for (int k = 0; k < n_blocks<F>(h); ++k) {
    T gx, gy;
    grad_k(h.u, idx, p, h.M, h.N, kind_of<F>(h, k), gx, gy);
    T nG = sqrt(gx * gx + gy * gy);
    T act, den;
    if (h.reg) {
      act = (nG > T(1) / h.gamma) ? T(1) : T(0);
      den = act > T(0) ? nG : T(1);
    } else {
      act = (nG < h.act_tol) ? T(1) : T(0);
      den = act > T(0) ? T(1) : nG;
    }
    const T alpha = h.alpha_at(k, p);
    T inact = T(1) - act;
    T inv_den = T(1) / den;
    T inv_den3 = inv_den * inv_den * inv_den;
    T rden = T(1) / den;
    T rden3 = T(1) / (den * den * den);
    T hx = rden - (gx * gx) * rden3;
    T hy = rden - (gy * gy) * rden3;
    T wdx, wdy;
    if (h.reg) {
      wdx = alpha * (h.gamma * inact + act * hx);
      wdy = alpha * (h.gamma * inact + act * hy);
    } else {
      wdx = h.mu * act + (inact * alpha) * hx;
      wdy = h.mu * act + (inact * alpha) * hy;
      h.kplane(k, LAMX)[idx] = T(0);
      h.kplane(k, LAMY)[idx] = T(0);
    }
    h.kplane(k, GUX)[idx] = gx;
    h.kplane(k, GUY)[idx] = gy;
    h.kplane(k, ACT)[idx] = act;
    h.kplane(k, DEN)[idx] = den;
    h.kplane(k, INV_DEN)[idx] = inv_den;
    h.kplane(k, INV_DEN3)[idx] = inv_den3;
    h.kplane(k, WX)[idx] = wdx;
    h.kplane(k, WY)[idx] = wdy;
  }
  h.p[idx] = h.p0 != nullptr ? h.p0[idx] : T(0);
}

// 1/diag with diag = 1 + Σₖ gramₖ(WXₖ, WYₖ), k in order.
template <int F, typename T>
__device__ __forceinline__ T inv_diag_px(const HG<T>& h, long long idx,
                                         Pix p) {
  T diag = T(1);
  for (int k = 0; k < n_blocks<F>(h); ++k)
    diag = diag + gram_k(h.kplane(k, WX), h.kplane(k, WY), idx, p, h.M, h.N,
                         kind_of<F>(h, k));
  return T(1) / diag;
}

// (wx, wy) = Wₖ·Gₖv at pixel p: the per-pixel dual-space block applied to
// Gₖv, evaluated where the apply reads it instead of stored.
template <typename T>
__device__ __forceinline__ void w_at(const HG<T>& h, int k, int kind,
                                     const T* v, long long idx, Pix p, T& wx,
                                     T& wy) {
  T gx, gy;
  grad_k(v, idx, p, h.M, h.N, kind, gx, gy);
  const T alpha = h.alpha_at(k, p);
  T ux = h.kplane(k, GUX)[idx], uy = h.kplane(k, GUY)[idx];
  T act = h.kplane(k, ACT)[idx];
  T inact = T(1) - act;
  T inv_den = h.kplane(k, INV_DEN)[idx];
  T dot3 = (ux * gx + uy * gy) * h.kplane(k, INV_DEN3)[idx];
  T cx = gx * inv_den - ux * dot3;
  T cy = gy * inv_den - uy * dot3;
  if (h.reg) {
    wx = alpha * ((h.gamma * inact) * gx + act * cx);
    wy = alpha * ((h.gamma * inact) * gy + act * cy);
  } else {
    wx = (h.mu * act) * gx + (inact * alpha) * cx;
    wy = (h.mu * act) * gy + (inact * alpha) * cy;
  }
}

// M v at one pixel: v + Σₖ Gₖᵀ(Wₖ·Gₖv), k in order; Gₖᵀ is common.cuh's
// div_k (adj1 along the rows on the x weights plus adj1 along the columns
// on the y weights), with the weights computed at the pixels adj1 reads.
template <int F, typename T>
__device__ __forceinline__ T apply_px(const HG<T>& h, const T* v,
                                      long long idx, Pix p) {
  const long long s = h.N;
  T mv = v[idx];
  for (int k = 0; k < n_blocks<F>(h); ++k) {
    const int kd = kind_of<F>(h, k);
    T wx, wy, ax, ay;
    if (kd == STENCIL_CEN) {
      T down = T(0), up = T(0);
      if (p.i >= 2) {
        w_at(h, k, kd, v, idx - s, shifted(p, -1, 0), wx, wy);
        down = wx;
      }
      if (p.i <= h.M - 3) {
        w_at(h, k, kd, v, idx + s, shifted(p, 1, 0), wx, wy);
        up = wx;
      }
      ax = (down - up) * T(0.5);
      down = T(0);
      up = T(0);
      if (p.j >= 2) {
        w_at(h, k, kd, v, idx - 1, shifted(p, 0, -1), wx, wy);
        down = wy;
      }
      if (p.j <= h.N - 3) {
        w_at(h, k, kd, v, idx + 1, shifted(p, 0, 1), wx, wy);
        up = wy;
      }
      ay = (down - up) * T(0.5);
    } else {
      T cx, cy;   // the weights at the pixel itself
      w_at(h, k, kd, v, idx, p, cx, cy);
      T lo = T(0), hi = T(0);
      if (kd == STENCIL_FWD) {
        if (p.i >= 1) {
          w_at(h, k, kd, v, idx - s, shifted(p, -1, 0), wx, wy);
          lo = wx;
        }
        if (p.i < h.M - 1) hi = cx;
        ax = lo - hi;
        lo = T(0);
        hi = T(0);
        if (p.j >= 1) {
          w_at(h, k, kd, v, idx - 1, shifted(p, 0, -1), wx, wy);
          lo = wy;
        }
        if (p.j < h.N - 1) hi = cy;
        ay = lo - hi;
      } else {
        if (p.i >= 1) lo = cx;
        if (p.i < h.M - 1) {
          w_at(h, k, kd, v, idx + s, shifted(p, 1, 0), wx, wy);
          hi = wx;
        }
        ax = lo - hi;
        lo = T(0);
        hi = T(0);
        if (p.j >= 1) lo = cy;
        if (p.j < h.N - 1) {
          w_at(h, k, kd, v, idx + 1, shifted(p, 0, 1), wx, wy);
          hi = wy;
        }
        ay = lo - hi;
      }
    }
    mv = mv + (ax + ay);
  }
  return mv;
}

// Right-hand side: exact b = (u − ū) − Σₖ Gₖᵀ(actₖ·λₖ), k in order;
// regularized b = ū − u.
template <int F, typename T>
__device__ __forceinline__ T rhs_px(const HG<T>& h, long long idx, Pix p) {
  if (h.reg) return h.ut[idx] - h.u[idx];
  T b = h.u[idx] - h.ut[idx];
  for (int k = 0; k < n_blocks<F>(h); ++k) {
    const int kd = kind_of<F>(h, k);
    const T* act = h.kplane(k, ACT);
    T dx = adj1_prod(act, (const T*)h.kplane(k, LAMX), idx, p.i, h.M,
                     (long long)h.N, kd);
    T dy = adj1_prod(act, (const T*)h.kplane(k, LAMY), idx, p.j, h.N, 1LL,
                     kd);
    b = b - (dx + dy);
  }
  return b;
}

// λₖ ← λₖ + (μ·actₖ)·Gₖp.
template <int F, typename T>
__device__ __forceinline__ void lambda_px(const HG<T>& h, long long idx,
                                          Pix p) {
  for (int k = 0; k < n_blocks<F>(h); ++k) {
    T gx, gy;
    grad_k((const T*)h.p, idx, p, h.M, h.N, kind_of<F>(h, k), gx, gy);
    T m = h.mu * h.kplane(k, ACT)[idx];
    h.kplane(k, LAMX)[idx] = h.kplane(k, LAMX)[idx] + m * gx;
    h.kplane(k, LAMY)[idx] = h.kplane(k, LAMY)[idx] + m * gy;
  }
}

// Block k's Gₖp·fieldₖ at one pixel, with field = (inact/den)·Gu (exact)
// or (act/den)·Gu + (γ·inact)·Gu (regularized).
template <typename T>
__device__ __forceinline__ T grad_px(const HG<T>& h, int k, int kind,
                                     long long idx, Pix p) {
  T gx, gy;
  grad_k((const T*)h.p, idx, p, h.M, h.N, kind, gx, gy);
  T ux = h.kplane(k, GUX)[idx], uy = h.kplane(k, GUY)[idx];
  T act = h.kplane(k, ACT)[idx];
  T inact = T(1) - act;
  T den = h.kplane(k, DEN)[idx];
  T fx, fy;
  if (h.reg) {
    T s = act / den;
    T gi = h.gamma * inact;
    fx = s * ux + gi * ux;
    fy = s * uy + gi * uy;
  } else {
    T s = inact / den;
    fx = s * ux;
    fy = s * uy;
  }
  return gx * fx + gy * fy;
}

// The sum of one region's nblocks partials in sum_partials' order (thread
// t adds t, t + 256, … serially, then block_sum's tree); every thread of
// the CTA gets it.
template <typename T>
__device__ __forceinline__ T sum_region(const T* src, int nblocks, T* sh) {
  T acc = T(0);
  for (int k = threadIdx.x; k < nblocks; k += BPL_THREADS) acc += src[k];
  return block_sum(acc, sh);
}

// The whole call: set-up, then n_al × (λ update but on the first solve,
// CG start, PCG), then the gradient.  Each CTA walks the virtual blocks vb
// = blockIdx.x, blockIdx.x + gridDim.x, …; a virtual block's threads and
// its partial sums are the first design's block.
template <typename T, int F>
__global__ void __launch_bounds__(BPL_THREADS)
hg_coop(HG<T> h) {
  __shared__ T sh[BPL_THREADS];
  cgr::grid_group grid = cgr::this_grid();
  const int nb = h.nblocks;
#define HG_FOR_VB                                                       \
  for (int vb = blockIdx.x; vb < nb; vb += gridDim.x)
#define HG_IDX (long long)vb * BPL_THREADS + threadIdx.x

  HG_FOR_VB {
    const long long idx = HG_IDX;
    if (idx < h.n) setup_px<F>(h, idx, pix_of(idx, h.M, h.N));
  }
  grid.sync();

  T rr = T(0), bb = T(0);
  int it = 0, total = 0;
  for (int solve = 0; solve < h.n_al; ++solve) {
    if (solve > 0) {
      HG_FOR_VB {
        const long long idx = HG_IDX;
        if (idx < h.n) lambda_px<F>(h, idx, pix_of(idx, h.M, h.N));
      }
      grid.sync();
    }
    // CG start (with the diagonal on the first solve): r = b − Mp,
    // z = r/diag, d = z; partials of r·z, r·r, b·b
    HG_FOR_VB {
      const long long idx = HG_IDX;
      T rz_ = T(0), rr_ = T(0), bb_ = T(0);
      if (idx < h.n) {
        const Pix p = pix_of(idx, h.M, h.N);
        T inv;
        if (solve == 0) {
          inv = inv_diag_px<F>(h, idx, p);
          h.plane(INV_DIAG)[idx] = inv;
        } else {
          inv = h.plane(INV_DIAG)[idx];
        }
        const T b = rhs_px<F>(h, idx, p);
        const T r = b - apply_px<F>(h, (const T*)h.p, idx, p);
        const T z = inv * r;
        h.plane(RES)[idx] = r;
        h.plane(ZZ)[idx] = z;
        h.plane(DIR)[idx] = z;
        rz_ = r * z;
        rr_ = r * r;
        bb_ = b * b;
      }
      T s0 = block_sum(rz_, sh);
      T s1 = block_sum(rr_, sh);
      T s2 = block_sum(bb_, sh);
      if (threadIdx.x == 0) {
        h.region(R_RZ)[vb] = s0;
        h.region(R_RR)[vb] = s1;
        h.region(R_BB)[vb] = s2;
      }
    }
    grid.sync();
    T rz = sum_region(h.region(R_RZ), nb, sh);
    rr = sum_region(h.region(R_RR), nb, sh);
    bb = sum_region(h.region(R_BB), nb, sh);
    // the host's stop test of the first design, in T
    T bnorm = sqrt(bb);
    if (bnorm < tiny<T>()) bnorm = tiny<T>();
    const T thresh = h.cg_tol * bnorm;
    int k = 0;
    bool more = k < h.cg_maxiter && sqrt(rr) > thresh;
    while (more) {
      // Md = M d; partials of d·Md
      HG_FOR_VB {
        const long long idx = HG_IDX;
        T dm = T(0);
        if (idx < h.n) {
          const T* d = h.plane(DIR);
          const T md = apply_px<F>(h, d, idx, pix_of(idx, h.M, h.N));
          h.plane(MDIR)[idx] = md;
          dm = d[idx] * md;
        }
        T s = block_sum(dm, sh);
        if (threadIdx.x == 0) h.region(R_DMD)[vb] = s;
      }
      grid.sync();   // (b)
      const T a = rz / nz(sum_region(h.region(R_DMD), nb, sh));
      // p += a d; r −= a Md; z = r/diag; partials of r·z, r·r
      HG_FOR_VB {
        const long long idx = HG_IDX;
        T rz_ = T(0), rr_ = T(0);
        if (idx < h.n) {
          T d = h.plane(DIR)[idx];
          h.p[idx] = h.p[idx] + a * d;
          T r = h.plane(RES)[idx] - a * h.plane(MDIR)[idx];
          T z = h.plane(INV_DIAG)[idx] * r;
          h.plane(RES)[idx] = r;
          h.plane(ZZ)[idx] = z;
          rz_ = r * z;
          rr_ = r * r;
        }
        T s0 = block_sum(rz_, sh);
        T s1 = block_sum(rr_, sh);
        if (threadIdx.x == 0) {
          h.region(R_RZ)[vb] = s0;
          h.region(R_RR)[vb] = s1;
        }
      }
      grid.sync();   // (c)
      const T rz_new = sum_region(h.region(R_RZ), nb, sh);
      rr = sum_region(h.region(R_RR), nb, sh);
      ++k;
      more = k < h.cg_maxiter && sqrt(rr) > thresh;
      if (more) {
        // β = rz_new/rz; d = z + β d (the last iteration's d is not read)
        const T beta = rz_new / nz(rz);
        HG_FOR_VB {
          const long long idx = HG_IDX;
          if (idx < h.n)
            h.plane(DIR)[idx] = h.plane(ZZ)[idx] + beta * h.plane(DIR)[idx];
        }
        grid.sync();   // (a)
      }
      rz = rz_new;
    }
    it = k;
    total += k;
  }

  // dJ/dαₖ: per-pixel maps (negated for the exact form), or partial sums
  // per block k, summed below with the sign applied to the sum
  HG_FOR_VB {
    const long long idx = HG_IDX;
    const bool live = idx < h.n;
    const Pix p = pix_of(live ? idx : 0, h.M, h.N);
    for (int k = 0; k < n_blocks<F>(h); ++k) {
      const T g = live ? grad_px(h, k, kind_of<F>(h, k), idx, p) : T(0);
      if (h.gmaps != nullptr) {
        if (live) h.gmaps[(long long)k * h.n + idx] = h.reg ? g : -g;
      } else {
        T s = block_sum(g, sh);
        if (threadIdx.x == 0) h.region(R_GRAD0 + k)[vb] = s;
      }
    }
  }
#undef HG_FOR_VB
#undef HG_IDX
  if (h.gmaps == nullptr) {
    grid.sync();
    if (blockIdx.x == 0) {
      for (int k = 0; k < n_blocks<F>(h); ++k) {
        const T tot = sum_region(h.region(R_GRAD0 + k), nb, sh);
        if (threadIdx.x == 0) h.scal[GRAD0 + k] = h.reg ? tot : -tot;
      }
    }
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    h.stats[ST_RR] = (double)rr;
    h.stats[ST_BB] = (double)bb;
    h.stats[ST_IT] = (double)it;
    h.stats[ST_TOTAL] = (double)total;
  }
}

// The launch of one instance: the grid from the co-resident count, then
// the cooperative launch.
template <typename T, int F>
static cudaError_t hg_launch(HG<T>& h, cudaStream_t s, int* grid_out) {
  void (*kern)(HG<T>) = hg_coop<T, F>;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                    BPL_THREADS, 0);
  if (e != cudaSuccess) return e;
  const long long resident = (long long)per_sm * sms;
  if (resident < 1) return cudaErrorCooperativeLaunchTooLarge;
  const int grid = (int)(h.nblocks < resident ? h.nblocks : resident);
  *grid_out = grid;
  void* args[] = {&h};
  return cudaLaunchCooperativeKernel(kern, dim3(grid), dim3(BPL_THREADS),
                                     args, 0, s);
}

// One cooperative launch, then one read of the stats into host_stats.
// ops[0]: kernel launches, ops[1]: device→host reads; *grid_out: the CTAs
// launched.
template <typename T>
int hypergrad(const T* u, const T* ut, const T* p0, T* p, T* work,
              T* partials, T* scal, T* gmaps, double* dstats, long long O,
              int M, int N, int K, const int* kinds, const T* alphas,
              const long long* amaps, T act_tol, T gamma, T mu, T cg_tol,
              int al_iters, int cg_maxiter, int reg, double* host_stats,
              int* ops, int* grid_out, cudaStream_t s) {
  ops[0] = 0;
  ops[1] = 0;
  *grid_out = 0;
  if (K < 1 || K > 3 || O < 1 || M < 1 || N < 1 || cg_maxiter < 0)
    return (int)cudaErrorInvalidValue;
  HG<T> h;
  h.u = u;
  h.ut = ut;
  h.p0 = p0;
  h.p = p;
  h.w = work;
  h.partials = partials;
  h.scal = scal;
  h.gmaps = gmaps;
  h.stats = dstats;
  h.n = O * M * N;
  h.M = M;
  h.N = N;
  const long long nblocks = (h.n + BPL_THREADS - 1) / BPL_THREADS;
  if (nblocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  h.nblocks = (int)nblocks;
  h.K = K;
  int form = K << 8;
  for (int k = 0; k < 3; ++k) {
    const bool live = k < K;
    h.kind[k] = live ? kinds[k] : STENCIL_FWD;
    h.alpha[k] = live ? alphas[k] : T(0);
    h.amap[k] = live ? (const T*)amaps[k] : nullptr;
    if (live) form |= h.kind[k] << (2 * k);
  }
  h.act_tol = act_tol;
  h.gamma = gamma;
  h.mu = mu;
  h.cg_tol = cg_tol;
  h.reg = reg;
  h.n_al = reg ? 1 : (al_iters > 1 ? al_iters : 1);
  h.cg_maxiter = cg_maxiter;

  cudaError_t e;
  switch (form) {
    case HG_TV: e = hg_launch<T, HG_TV>(h, s, grid_out); break;
    case HG_SUMREGS: e = hg_launch<T, HG_SUMREGS>(h, s, grid_out); break;
    default: e = hg_launch<T, HG_ANY>(h, s, grid_out); break;
  }
  if (e != cudaSuccess) return (int)e;
  ops[0] = 1;
  e = cudaMemcpyAsync(host_stats, dstats, N_STATS * sizeof(double),
                      cudaMemcpyDeviceToHost, s);
  if (e != cudaSuccess) return (int)e;
  ops[1] = 1;
  e = cudaStreamSynchronize(s);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace bpl

extern "C" {

// kinds: K stencil kinds (0 forward, 1 backward, 2 centred); alphas: K
// scalar weights; amaps: K device addresses of (M, N) weight maps, 0 where
// the block's weight is the scalar.  p0: the warm start, or null (p starts
// at 0); p: the solution out.  gmaps: K per-pixel gradient maps (K, O, M,
// N), or null for K scalar gradients in scal[GRAD0 + k].  dstats: N_STATS
// doubles on the device, read once into host_stats.  ops: kernel launches
// and device→host reads issued; grid: the CTAs launched.
int bpl_hypergrad_f32(const float* u, const float* ut, const float* p0,
                      float* p, float* work, float* partials, float* scal,
                      float* gmaps, double* dstats, long long O, int M, int N,
                      int K, const int* kinds, const float* alphas,
                      const long long* amaps, float act_tol, float gamma,
                      float mu, float cg_tol, int al_iters, int cg_maxiter,
                      int reg, double* host_stats, int* ops, int* grid,
                      void* stream) {
  return bpl::hypergrad<float>(u, ut, p0, p, work, partials, scal, gmaps,
                               dstats, O, M, N, K, kinds, alphas, amaps,
                               act_tol, gamma, mu, cg_tol, al_iters,
                               cg_maxiter, reg, host_stats, ops, grid,
                               (cudaStream_t)stream);
}

int bpl_hypergrad_f64(const double* u, const double* ut, const double* p0,
                      double* p, double* work, double* partials,
                      double* scal, double* gmaps, double* dstats,
                      long long O, int M, int N, int K, const int* kinds,
                      const double* alphas, const long long* amaps,
                      double act_tol, double gamma, double mu, double cg_tol,
                      int al_iters, int cg_maxiter, int reg,
                      double* host_stats, int* ops, int* grid,
                      void* stream) {
  return bpl::hypergrad<double>(u, ut, p0, p, work, partials, scal, gmaps,
                                dstats, O, M, N, K, kinds, alphas, amaps,
                                act_tol, gamma, mu, cg_tol, al_iters,
                                cg_maxiter, reg, host_stats, ops, grid,
                                (cudaStream_t)stream);
}

// work planes for K blocks; partial-sum regions; scalar slots; the slot of
// block 0's gradient; device stats
int bpl_hypergrad_planes(int K) { return bpl::SHARED + bpl::PER_K * K; }
int bpl_hypergrad_regions() { return bpl::N_REGIONS; }
int bpl_hypergrad_slots() { return bpl::N_SLOTS; }
int bpl_hypergrad_grad_slot() { return bpl::GRAD0; }
int bpl_hypergrad_stats() { return bpl::N_STATS; }

}  // extern "C"
