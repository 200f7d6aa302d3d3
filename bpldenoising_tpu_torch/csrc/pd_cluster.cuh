// The band scheme of the CP phases that keep each image on-chip: one
// thread-block cluster per image, each CTA a band of rows in shared memory
// (csrc/single_loop.cu's slc_pd, rows 9–10; csrc/pdps.cu's pdc_cp, kernel
// A, rows 1 and 3; csrc/tvl1.cu's tvl1_cp, rows 7 and 8;
// csrc/single_loop_tvl1.cu's sl1_pd, row 12; the TGV² and VTV single-loop
// learners' loops, csrc/tgv_cluster.cuh and csrc/vtv_cluster.cuh, share its
// launch, thread block, slots and row walker).
//
// CTA c of an image's cluster owns rows [r0, r1) = [c·rows, (c+1)·rows) ∩
// [0, M) and holds u, ū and the 2K dual planes on rows r0 − 2 … r1 + 1
// (band row l = i − r0 + 2), then its halo slots [parity][top, bottom][2
// rows][2K planes][N].  Per CP iteration: the primal step on rows
// r0 − 1 … r1 (its own and one halo row each side: the halo rows' u and ū
// come out equal to the owner's, same inputs and operations), the dual step
// on its own rows, whose top two and bottom two rows it also stores into
// the neighbours' halo slots of the next parity (distributed shared
// memory), then one cluster barrier; the next iteration copies its slots
// into the band's halo rows.  Double-buffered slots let a neighbour store
// iteration t + 1's rows while this CTA may still read iteration t's.  The
// stencils reach one row (common.cuh's diff1 / adj1, the centred adjoint
// included), so two halo rows each side are enough.  f is read through L2.
// Every non-empty CTA but the last owns ≥ 2 rows (the host's plan), so the
// two halo rows each side come from the adjacent CTAs.  RES: the band lives
// in shared memory (else in a global scratch laid out alike).  The state is
// read from global memory once per launch and written back once.  Images
// are independent, so a batch runs as waves of clusters with no grid-wide
// barrier.
#pragma once

#include <cooperative_groups.h>

#include "common.cuh"

namespace bpl {

namespace cgrp = cooperative_groups;

// a PD CTA: PD_TY rows of PD_TX threads; thread (ty, tx) takes rows ty,
// ty + PD_TY, … and in each the columns tx + PD_TX·c, c < PD_CPT, of each
// group of PD_TX·PD_CPT columns, loading the group's operands before it
// computes and stores (independent chains).  Two CTAs an SM (64 registers:
// row 10's bands, 104 KB, fit twice).
#define PD_TX 32
#define PD_TY 16
#define PD_CPT 4
#define PD_MINB 2
#define PD_THREADS (PD_TX * PD_TY)
// the largest portable cluster; up to PD_MAX_CLUSTER_NP CTAs with
// cudaFuncAttributeNonPortableClusterSizeAllowed
#define PD_MAX_CLUSTER 8
#define PD_MAX_CLUSTER_NP 16

// Elements of one PD CTA's band: u, ū and the 2K dual planes on rows + 4
// rows, then its halo slots (2 parities × 2 sides × 2 rows × 2K planes).
inline long long pd_region(int K, int rows, int N) {
  return ((2LL + 2 * K) * (rows + 4) + 16LL * K) * N;
}

// The 2-D stencils of common.cuh on a region whose rows are `rs` elements
// apart, with int offsets (the image's masks come from p's coordinates).
template <typename T>
__device__ __forceinline__ void grad_s(const T* v, int l, Pix p, int M,
                                       int N, int rs, int kind, T& gx,
                                       T& gy) {
  gx = diff1(v, l, p.i, M, rs, kind);
  gy = diff1(v, l, p.j, N, 1, kind);
}

template <typename T>
__device__ __forceinline__ T div_s(const T* qx, const T* qy, int l, Pix p,
                                   int M, int N, int rs, int kind) {
  return adj1(qx, l, p.i, M, rs, kind) + adj1(qy, l, p.j, N, 1, kind);
}

template <typename T>
__device__ __forceinline__ T gram_s(const T* wx, const T* wy, int l, Pix p,
                                    int M, int N, int rs, int kind) {
  return gram1(wx, l, p.i, M, rs, kind) + gram1(wy, l, p.j, N, 1, kind);
}

__device__ __forceinline__ Pix pix(long long b, int i, int j) {
  Pix p;
  p.b = b;
  p.i = i;
  p.j = j;
  return p;
}

// fn(i, j) for every pixel of rows [ra, rb), this thread's share: flat
// positions threadIdx.x, + PD_THREADS, … in row-major order (one division
// a thread, then a carry).
template <class F>
__device__ __forceinline__ void band_rows(int ra, int rb, int N, F fn) {
  const int n = (rb - ra) * N;
  int q = (int)threadIdx.x;
  if (q >= n) return;
  int i = ra + q / N, j = q % N;
  const int di = PD_THREADS / N, dj = PD_THREADS % N;
  for (; q < n; q += PD_THREADS) {
    fn(i, j);
    i += di;
    j += dj;
    if (j >= N) {
      j -= N;
      ++i;
    }
  }
}

// The hook on block k's dual p = y + σGₖū at pixel (i, j), before its
// squared norm is taken: nothing, unless a step overloads it
// (csrc/tvl1.cu's Huber form scales p there).
template <class S, typename T>
__device__ __forceinline__ void pd_pre(const S&, int, int, int, T&, T&) {}

// n_it CP iterations of one image (blockIdx.x / cl) under the band scheme.
// S is the iteration's step, which the caller's kernel builds:
//   members M, N, cl, rows (the plan), region (elements of a band) and pd
//   (the global bands, read when !RES);
//   K(), kind(k): the dual blocks and their stencil kinds;
//   u_in(b), u_out(b), y(k, b), f(b): image b's planes in global memory
//   (y (b, 2, M, N) per block, read and written in place), mn() = M·N
//   (read where it is used, not held over the iterations);
//   at(it): the scalars of iteration it; sigma: the dual step's σ;
//   primal(div, u, f, ū&) → u⁺ and ū;  scale(k, i, j, n2): the factor
//   that projects block k's dual at pixel (i, j) of squared norm n2;
//   optionally an overload of pd_pre (below) for S.
// The caller's kernel runs cluster-wide; `smem` is its dynamic shared
// memory.  Shared memory written before the call is visible to every thread
// after it starts (its first step is a cluster barrier).
template <typename T, bool RES, class S>
__device__ __forceinline__ void pd_cluster_run(S& s, unsigned char* smem,
                                               int n_it) {
  cgrp::cluster_group cluster = cgrp::this_cluster();
  const int c = (int)cluster.block_rank();
  const long long b = blockIdx.x / s.cl;
  const int M = s.M, N = s.N, K = s.K(), ny = 2 * K;
  const int ty = (int)threadIdx.x / PD_TX, tx = (int)threadIdx.x % PD_TX;
  const int r0 = c * s.rows;
  const int r1 = r0 + s.rows < M ? r0 + s.rows : M;
  const bool has = r1 > r0;
  const int band = (s.rows + 4) * N;
  const int slot_rows = ny * N;                   // one slot row, 2K planes
  T* base = RES ? reinterpret_cast<T*>(smem)
                : s.pd + (long long)blockIdx.x * s.region;
  T* U = base;
  T* UB = base + band;
  T* Y = base + 2 * band;                         // plane q at Y + q·band
  T* slots = Y + ny * band;
  T* up = nullptr;      // the slots of the CTA above (its bottom rows)
  T* down = nullptr;    // the slots of the CTA below (its top rows)
  if (has && c > 0)
    up = RES ? cluster.map_shared_rank(slots, c - 1) : slots - s.region;
  if (has && r1 < M)
    down = RES ? cluster.map_shared_rank(slots, c + 1) : slots + s.region;
  const T* fb = s.f(b);
  // every CTA of the cluster runs before any stores into another's slots
  cluster.sync();

  // u and the duals on rows r0 − 2 … r1 + 1 that exist
  const int lo = r0 - 2 > 0 ? r0 - 2 : 0;
  const int hi = r1 + 2 < M ? r1 + 2 : M;
  if (has) {
    const T* ui = s.u_in(b);
    for (int q = threadIdx.x; q < (hi - lo) * N; q += PD_THREADS) {
      const int i = lo + q / N, j = q % N;
      const long long g = (long long)i * N + j;
      const int l = (i - r0 + 2) * N + j;
      U[l] = ui[g];
      for (int k = 0; k < K; ++k) {
        const T* yk = s.y(k, b);
        Y[2 * k * band + l] = yk[g];
        Y[(2 * k + 1) * band + l] = yk[s.mn() + g];
      }
    }
  }

  // the primal step's rows: own and one halo row each side
  const int pa = r0 - 1 > 0 ? r0 - 1 : 0;
  const int pb = has ? (r1 + 1 < M ? r1 + 1 : M) : pa;
  for (int it = 0; it < n_it; ++it) {
    s.at(it);
    const int par = it & 1;
    if (it > 0 && has) {
      // slots[par] → the band's halo rows r0 − 2, r0 − 1 (from above) and
      // r1, r1 + 1 (from below); slot row (side·2 + row)·2K + plane
      const T* src = slots + par * 4 * slot_rows;
      for (int cr = ty; cr < 4 * ny; cr += PD_TY) {
        const int side = cr / (2 * ny), row = (cr / ny) % 2;
        const int i = side == 0 ? r0 - 2 + row : r1 + row;
        if (!(side == 0 ? c > 0 : r1 < M) || i < 0 || i >= M) continue;
        T* dst = Y + (cr % ny) * band + (i - r0 + 2) * N;
        for (int j = tx; j < N; j += PD_TX) dst[j] = src[cr * N + j];
      }
    }
    __syncthreads();
    // the primal step: u⁺ and ū from Σₖ Gₖᵀyₖ (k in order), u and f
    for (int ib = pa; ib < pb; ib += PD_TY) {
      for (int j0 = tx; j0 < N; j0 += PD_TX * PD_CPT) {
        T dv[PD_CPT], uo[PD_CPT], fv[PD_CPT];
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const T* qx = Y + 2 * k * band;
#pragma unroll
          for (int e = 0; e < PD_CPT; ++e) {
            const Pix p = pix(b, ib + ty, j0 + e * PD_TX);
            if (p.i >= pb || p.j >= N) continue;
            const int l = (p.i - r0 + 2) * N + p.j;
            const T d = div_s(qx, qx + band, l, p, M, N, N, s.kind(k));
            dv[e] = k == 0 ? d : dv[e] + d;
          }
        }
#pragma unroll
        for (int e = 0; e < PD_CPT; ++e) {
          const int i = ib + ty;
          const int j = j0 + e * PD_TX;
          if (i >= pb || j >= N) continue;
          uo[e] = U[(i - r0 + 2) * N + j];
          fv[e] = fb[(long long)i * N + j];
        }
#pragma unroll
        for (int e = 0; e < PD_CPT; ++e) {
          const int i = ib + ty;
          const int j = j0 + e * PD_TX;
          if (i >= pb || j >= N) continue;
          const int l = (i - r0 + 2) * N + j;
          T ub;
          U[l] = s.primal(dv[e], uo[e], fv[e], ub);
          UB[l] = ub;
        }
      }
    }
    __syncthreads();
    // yₖ = Π(yₖ + σGₖū); the top and bottom two rows also into the
    // neighbours' slots of the next parity
    const bool send = it + 1 < n_it;
    T* to_up = up && send ? up + (1 - par) * 4 * slot_rows + 2 * slot_rows
                          : nullptr;              // its bottom rows
    T* to_down = down && send ? down + (1 - par) * 4 * slot_rows : nullptr;
    for (int ib = r0; ib < r1; ib += PD_TY) {
      for (int j0 = tx; j0 < N; j0 += PD_TX * PD_CPT) {
#pragma unroll
        for (int k = 0; k < K; ++k) {
          T px[PD_CPT], py[PD_CPT];
#pragma unroll
          for (int e = 0; e < PD_CPT; ++e) {
            const Pix p = pix(b, ib + ty, j0 + e * PD_TX);
            if (p.i >= r1 || p.j >= N) continue;
            const int l = (p.i - r0 + 2) * N + p.j;
            T gx, gy;
            grad_s((const T*)UB, l, p, M, N, N, s.kind(k), gx, gy);
            px[e] = Y[2 * k * band + l] + s.sigma * gx;
            py[e] = Y[(2 * k + 1) * band + l] + s.sigma * gy;
          }
#pragma unroll
          for (int e = 0; e < PD_CPT; ++e) {
            const int i = ib + ty;
            const int j = j0 + e * PD_TX;
            if (i >= r1 || j >= N) continue;
            const int l = (i - r0 + 2) * N + j;
            pd_pre(s, k, i, j, px[e], py[e]);
            const T sc = s.scale(k, i, j, px[e] * px[e] + py[e] * py[e]);
            const T qx = px[e] * sc;
            const T qy = py[e] * sc;
            Y[2 * k * band + l] = qx;
            Y[(2 * k + 1) * band + l] = qy;
            if (to_up && i < r0 + 2) {
              T* d = to_up + (i - r0) * slot_rows + 2 * k * N + j;
              d[0] = qx;
              d[N] = qy;
            }
            if (to_down && i >= r1 - 2) {
              T* d = to_down + (i - r1 + 2) * slot_rows + 2 * k * N + j;
              d[0] = qx;
              d[N] = qy;
            }
          }
        }
      }
    }
    cluster.sync();
  }

  // own rows back to global memory (no neighbour touches this CTA's
  // shared memory after the last cluster barrier)
  T* uo = s.u_out(b);
  for (int q = threadIdx.x; q < (r1 - r0) * N; q += PD_THREADS) {
    const long long g = (long long)r0 * N + q;
    const int l = 2 * N + q;
    uo[g] = U[l];
    for (int k = 0; k < K; ++k) {
      T* yk = s.y(k, b);
      yk[g] = Y[2 * k * band + l];
      yk[s.mn() + g] = Y[(2 * k + 1) * band + l];
    }
  }
}

// Whether the host's plan (solvers/cluster_plan.py) of cl CTAs an image,
// rows each, can run an M × N image's K-block bands: the CTAs cover the
// rows, every CTA but the last owns two rows or more, and the band's
// offsets fit an int.
inline bool pd_plan_ok(int M, int N, int K, int cl, int rows) {
  return cl >= 1 && cl <= PD_MAX_CLUSTER_NP && rows >= 1
         && (long long)rows * cl >= M && (cl == 1 || rows >= 2)
         && (long long)M * N <= 0x7fffffffLL
         && pd_region(K, rows, N) <= 0x7fffffffLL;
}

// The launch of a band kernel: one cluster of `cl` CTAs per image over
// `images` images, `smem` bytes of dynamic shared memory a CTA.  Checks the
// card's opt-in shared memory and that one cluster can be resident
// (cudaOccupancyMaxActiveClusters); a refused plan returns an error, it is
// never retried in another form.  Returns a cudaError_t.
template <typename Kern>
struct PdClusterLaunch {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  Kern kern;
};

template <typename Kern>
int pd_cluster_prepare(PdClusterLaunch<Kern>& L, Kern kern, long long images,
                       int cl, size_t smem, cudaStream_t s) {
  int dev = 0, optin = 0;
  cudaError_t err;
  if (cl < 1 || cl > PD_MAX_CLUSTER_NP || images < 1
      || images * cl > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  if (smem > (size_t)optin) return (int)cudaErrorInvalidValue;
  L.kern = kern;
  err = cudaFuncSetAttribute(kern,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (cl > PD_MAX_CLUSTER) {
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return (int)err;
  }
  L.cfg = cudaLaunchConfig_t{};
  L.cfg.gridDim = dim3((unsigned)(images * cl));
  L.cfg.blockDim = dim3(PD_THREADS);
  L.cfg.dynamicSmemBytes = smem;
  L.cfg.stream = s;
  L.attr[0].id = cudaLaunchAttributeClusterDimension;
  L.attr[0].val.clusterDim.x = (unsigned)cl;
  L.attr[0].val.clusterDim.y = 1;
  L.attr[0].val.clusterDim.z = 1;
  L.cfg.attrs = L.attr;
  L.cfg.numAttrs = 1;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, kern, &L.cfg);
  if (err != cudaSuccess) return (int)err;
  if (clusters < 1) return (int)cudaErrorInvalidConfiguration;
  return (int)cudaSuccess;
}

// The host loop of an accelerated CP cluster kernel (kernel A's pdc_cp,
// the VTV kernel's vtv_cp), launched by L on the state h as
// kern(h, from, to, it0, n): the copy of the (τ, ω, σ) table of maxiter
// iterations into tab (cp_table; a pageable source, so the call returns
// once the table is staged), then common.cuh's cp_iterate with one launch
// per early-stop chunk and the per-plane stop rule over `planes` planes of
// mn elements (n = planes·mn in u).  *ops: the device operations issued
// (the copy, per chunk the launch, pd_change and the read, a last copy).
template <typename T, class H>
int cp_cluster_accel(const PdClusterLaunch<void (*)(H, const T*, T*, int,
                                                    int)>& L,
                     const H& h, T* u, T* uprev, T* ratio, T* tab,
                     long long planes, long long mn, T tau, T sigma,
                     double gamma, int accel, int maxiter, int use_tol,
                     T tol, int check_every, int* iters_out, int* ops,
                     cudaStream_t s) {
  if (maxiter > 0) {
    const std::vector<T> t = cp_table(tau, sigma, gamma, accel, maxiter);
    cudaError_t e = cudaMemcpyAsync(tab, t.data(), t.size() * sizeof(T),
                                    cudaMemcpyHostToDevice, s);
    if (e != cudaSuccess) return (int)e;
    ++*ops;
  }
  auto advance = [&](T* from, T* to, int it0, int n) -> cudaError_t {
    ++*ops;
    return cudaLaunchKernelEx(&L.cfg, L.kern, h, (const T*)from, to, it0,
                              n);
  };
  CpPlaneStop<T> stop(ratio, planes, mn);
  return cp_iterate<T>(advance, stop, u, uprev, planes * mn, maxiter,
                       use_tol, tol, check_every, iters_out, ops, s);
}

}  // namespace bpl
