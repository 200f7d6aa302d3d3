// The TGV² CP solve's tile form: the joint-primal iteration of csrc/tgv.cu
// on images whose bands do not fit a cluster (solvers/cluster_plan.py::
// tgv_plan; float32 from 240², float64 from 160²), T iterations a launch on
// shared-memory 2-D tiles with a recomputed halo.  It replaces, for those
// images, the two-launch form (tgv.cu's tgv_primal / tgv_dual: one thread a
// pixel, two launches an iteration on state in global memory), which moves
// ~28 planes through device memory every iteration (~117 MB at 1×1024²
// float32): the eleven-plane state does not stay in the 50 MB L2 beside
// everything else, so device memory sets its pace.  It replaces the TPU
// kernel bpldenoising_tpu/solvers/tgv_pallas.py::_make_tiled_kernel (row 5
// of PERF.md's table) for those images; the host (cluster_plan.py::
// tgv_tile_plan) plans it from the shapes.
//
// Each image is cut into 2-D tiles of th × tw owned pixels, one CTA a tile
// (the scheme of kernel A's csrc/pd_tile.cuh, whose geometry, TMA and
// mbarrier helpers, pixel walk pt_region and stencils pt_diff / pt_adj it
// takes).  A CTA loads u, w, p and q of its window (the owned pixels and a
// halo of H on every side) into shared memory, runs T iterations there with
// ū and w̄ as shared-memory planes (eleven planes), and writes back its
// owned pixels only; f and the (M, N) weight maps it reads through L2.
//
// The halo.  The primal step reads p at i − 1 and i (∇ᵀp) and q at i and
// i + 1 ((D⁻)ᵀq), in rows and in columns; the dual step reads ū at i and
// i + 1 (∇ū) and w̄ at i − 1 and i (E w̄).  So after an iteration u and ū
// are exact one pixel further in at the top and left than p was, w and w̄
// one pixel further in at the bottom and right than q was, and p and q one
// pixel further in on both sides than u and w: after T iterations u is
// exact on −T…T − 1 pixels beyond where everything was, w on −(T − 1)…T,
// p and q on ±T.  Each iteration therefore runs its primal step on the
// halo region less `it` pixels a side (the union of u's and w's regions,
// a one-pixel ring of which computes a value that nothing exact reads)
// and its dual step on that less one more, and a halo of H = T makes every
// owned pixel exact.  The uniform shrink of kernel A's scheme (and of the
// TPU kernel) needs H = 2T: TT_REACH = 2 builds it, which
// scripts/tgv_tile_sizes.py times against this one from an edited copy of
// the sources (H = T ran 1.32× faster on an H100 at 1×1024²).  The first
// primal step reads p and q one pixel outside the halo
// region, where the window may end: the planes are laid out so that such a
// read falls in a neighbouring plane of the allocation (u, the only plane
// before which nothing lies, and w, the last, are read at their own pixel
// only), and what it computes is outside the exact regions.
//
// The values in the exact regions are tgv.cu's, bit for bit: the same
// operations in the same order (tgv.cuh's div_k forward, dminus_T_rows /
// _cols with their /√2 terms, grad_k forward, sym_grad_bwd, ball_scale)
// under -fmad=false, the image-edge masks taken at global coordinates, so
// the edge is exact wherever it falls in a tile; tiles whose halo region
// keeps a pixel from the image's edge run the stencils without the masks.
// Between launches u ping-pongs among three buffers (the early stop keeps
// the chunk's first iterate), and w, p and q each between two, so no tile
// overwrites a halo that a neighbour still reads; a last copy brings each
// home.  The early stop is TGV²'s batch-global ‖u − u_prev‖ /
// max(‖u_prev‖, 1) every `check_every` iterations (common.cuh's
// CpSumStop<T, true>), so the iteration counts are the two-launch form's.
//
// What bounds it on an H100: device traffic is 8 plane loads of the window
// and 8 stores of the owned tile a launch (at 1×1024² float32, T = 5:
// ~97 MB a launch with the windows' overlap, ~6 µs an iteration at 3.35
// TB/s, against ~35 µs for the two-launch form).  The rest is the
// iterations inside the SM: the per-pixel passes (40 shared-memory
// accesses a pixel and iteration, their address arithmetic, the IEEE
// divisions and square roots) issue ~387 thread instructions a computed
// pixel-iteration, 64–65% of the SMs' issue slots, over the halo's
// recompute (~1.3 times the owned area at the plan's tiles), at the 32
// warps an SM that 64 registers a thread leave in float32 (16 in float64,
// one CTA an SM) (scripts/tgv_tile_sizes.py).
#include <cstring>

#include "pd_tile.cuh"
#include "tgv.cuh"

namespace bpl {

// pixels a side an iteration's primal and dual steps shrink the regions by
// (the halo is TT_REACH·T; the plan's cluster_plan.TGV_TILE_REACH)
#define TT_REACH 1

// pixels a pass takes at once a thread (PtSlotsN): the TGV² step holds
// more values a pixel than kernel A's
#define TT_CPT 2
// the shared-memory planes: u, ū, w̄ (2), p (2), q (3), w (2), in this
// order (see the halo note above); the 8 state planes a launch loads and
// stores, in their order of the tensor maps: u, w_r, w_c, p_r, p_c, q_rr,
// q_cc, q_rc
#define TT_PLANES 11
#define TT_STATE 8
#define TT_U 0
#define TT_UB 1
#define TT_WB 2
#define TT_P 4
#define TT_Q 6
#define TT_W 9

// the constant inputs of a launch: f, the weights (an (M, N) map each, or
// null: then the scalar), τ, σ
template <typename T>
struct TtArgs {
  const T* f;
  const T* a1map;
  const T* a0map;
  T a1, a0, tau, sigma;
  int M, N;
};

// the state buffers a launch reads (u, w, p, q as (O, M, N), (O, 2, M, N),
// (O, 2, M, N), (O, 3, M, N)) and writes
template <typename T>
struct TtBufs {
  const T* u;
  const T* w;
  const T* p;
  const T* q;
  T* uo;
  T* wo;
  T* po;
  T* qo;
};

// the tensor maps of one launch (TMA): the window's boxes read, the owned
// tile's written
struct TtMaps {
  CUtensorMap uin, win, pin, qin, uout, wout, pout, qout;
};

// state plane s (0–7) of image b: its shared-memory plane, its tensor map's
// plane index and its offset in units of mn in its buffer
__device__ __forceinline__ int tt_smem_plane(int s) {
  return s == 0 ? TT_U : s < 3 ? TT_W + s - 1 : s < 5 ? TT_P + s - 3
                                                      : TT_Q + s - 5;
}
__device__ __forceinline__ long long tt_z(int s, long long b) {
  return s == 0 ? b : s < 3 ? 2 * b + s - 1 : s < 5 ? 2 * b + s - 3
                                                    : 3 * b + s - 5;
}

// n_it iterations of a tile on its window S (planes P elements apart, rows
// `pitch` apart, from (Rs, Xs)); [R0, R1) × [C0, C1) its halo region.
template <bool EDGE, bool MAP, typename T>
__device__ __forceinline__ void tt_iterate(const TtArgs<T>& a, T* S, int P,
                                           int pitch, const T* fb, int R0,
                                           int R1, int C0, int C1, int Rs,
                                           int Xs, int n_it) {
  const int M = a.M, N = a.N;
  T* U = S + TT_U * P;
  T* UB = S + TT_UB * P;
  T* WBR = S + TT_WB * P;
  T* WBC = WBR + P;
  T* PR = S + TT_P * P;
  T* PC = PR + P;
  T* QRR = S + TT_Q * P;
  T* QCC = QRR + P;
  T* QRC = QCC + P;
  T* WR = S + TT_W * P;
  T* WC = WR + P;
  const T tau = a.tau, sigma = a.sigma;
  constexpr int R = TT_REACH;
  for (int it = 0; it < n_it; ++it) {
    {
      // the primal step (tgv_primal): u⁺, ū, w⁺, w̄
      const int e = R * it + R - 1;
      const int i0 = R0 + e, i1 = R1 - e, j0 = C0 + e, j1 = C1 - e;
      pt_region<TT_CPT>(i0 > 0 ? i0 : 0, i1 < M ? i1 : M, j0 > 0 ? j0 : 0,
                        j1 < N ? j1 : N, Rs, Xs, pitch, N,
                        [&](const PtSlotsN<TT_CPT>& p) {
        T dv[TT_CPT], er[TT_CPT], ec[TT_CPT];
#pragma unroll
        for (int k = 0; k < TT_CPT; ++k) {
          if (!p.ok[k]) continue;
          const int l = p.l[k], i = p.i[k], j = p.j[k];
          dv[k] = pt_adj<EDGE>((const T*)PR, l, i, M, pitch, STENCIL_FWD)
                  + pt_adj<EDGE>((const T*)PC, l, j, N, 1, STENCIL_FWD);
          er[k] = pt_adj<EDGE>((const T*)QRR, l, i, M, pitch, STENCIL_BWD)
                  + pt_adj<EDGE>((const T*)QRC, l, j, N, 1, STENCIL_BWD)
                        / sqrt2<T>();
          ec[k] = pt_adj<EDGE>((const T*)QCC, l, j, N, 1, STENCIL_BWD)
                  + pt_adj<EDGE>((const T*)QRC, l, i, M, pitch, STENCIL_BWD)
                        / sqrt2<T>();
        }
#pragma unroll
        for (int k = 0; k < TT_CPT; ++k) {
          if (!p.ok[k]) continue;
          const int l = p.l[k];
          const T uo = U[l];
          const T un = (uo - tau * dv[k] + tau * fb[p.g[k]]) / (T(1) + tau);
          const T wro = WR[l], wco = WC[l];
          const T wrn = wro + tau * (PR[l] - er[k]);
          const T wcn = wco + tau * (PC[l] - ec[k]);
          U[l] = un;
          UB[l] = T(2) * un - uo;
          WR[l] = wrn;
          WC[l] = wcn;
          WBR[l] = T(2) * wrn - wro;
          WBC[l] = T(2) * wcn - wco;
        }
      });
    }
    __syncthreads();
    {
      // the dual step (tgv_dual): p = Π_α₁(p + σ(∇ū − w̄)),
      // q = Π_α₀(q + σE w̄)
      const int e = R * (it + 1);
      const int i0 = R0 + e, i1 = R1 - e, j0 = C0 + e, j1 = C1 - e;
      pt_region<TT_CPT>(i0 > 0 ? i0 : 0, i1 < M ? i1 : M, j0 > 0 ? j0 : 0,
                        j1 < N ? j1 : N, Rs, Xs, pitch, N,
                        [&](const PtSlotsN<TT_CPT>& p) {
        T pr[TT_CPT], pc[TT_CPT];
#pragma unroll
        for (int k = 0; k < TT_CPT; ++k) {
          if (!p.ok[k]) continue;
          const int l = p.l[k], i = p.i[k], j = p.j[k];
          const T gx = pt_diff<EDGE>((const T*)UB, l, i, M, pitch,
                                     STENCIL_FWD);
          const T gy = pt_diff<EDGE>((const T*)UB, l, j, N, 1, STENCIL_FWD);
          pr[k] = PR[l] + sigma * (gx - WBR[l]);
          pc[k] = PC[l] + sigma * (gy - WBC[l]);
        }
#pragma unroll
        for (int k = 0; k < TT_CPT; ++k) {
          if (!p.ok[k]) continue;
          const int l = p.l[k];
          const T a1 = MAP && a.a1map ? a.a1map[p.g[k]] : a.a1;
          const T sp = ball_scale(pr[k] * pr[k] + pc[k] * pc[k], a1);
          PR[l] = pr[k] * sp;
          PC[l] = pc[k] * sp;
        }
#pragma unroll
        for (int k = 0; k < TT_CPT; ++k) {
          if (!p.ok[k]) continue;
          const int l = p.l[k], i = p.i[k], j = p.j[k];
          const T err = pt_diff<EDGE>((const T*)WBR, l, i, M, pitch,
                                      STENCIL_BWD);
          const T ecc = pt_diff<EDGE>((const T*)WBC, l, j, N, 1,
                                      STENCIL_BWD);
          const T drc = pt_diff<EDGE>((const T*)WBR, l, j, N, 1,
                                      STENCIL_BWD);
          const T dcr = pt_diff<EDGE>((const T*)WBC, l, i, M, pitch,
                                      STENCIL_BWD);
          const T erc = (drc + dcr) / sqrt2<T>();
          const T t0 = QRR[l] + sigma * err;
          const T t1 = QCC[l] + sigma * ecc;
          const T t2 = QRC[l] + sigma * erc;
          const T a0 = MAP && a.a0map ? a.a0map[p.g[k]] : a.a0;
          const T sq = ball_scale(t0 * t0 + t1 * t1 + t2 * t2, a0);
          QRR[l] = t0 * sq;
          QCC[l] = t1 * sq;
          QRC[l] = t2 * sq;
        }
      });
    }
    __syncthreads();
  }
}

// n_it CP iterations of every tile this CTA walks (blockIdx.x, then
// gridDim.x apart), from the state in io's inputs to its outputs.  Two
// CTAs an SM in float32 (64 registers); one in float64.
template <typename T, bool MAP>
__global__ void __launch_bounds__(PT_THREADS, sizeof(T) == 4 ? PT_MINB : 1)
tt_cp(TtArgs<T> a, PtGeom g, TtBufs<T> io, int n_it,
      const __grid_constant__ TtMaps maps) {
  extern __shared__ __align__(128) unsigned char tt_smem[];
  const int M = a.M, N = a.N;
  const long long mn = (long long)M * N;
  const int P = g.plane, pitch = g.pitch;
  uint64_t* bar = reinterpret_cast<uint64_t*>(tt_smem);
  T* S = reinterpret_cast<T*>(tt_smem + PT_ALIGN);
  const int tiles = g.tiles_m * g.tiles_n;
  if (g.tma && threadIdx.x == 0) mbar_init(bar);
  __syncthreads();
  unsigned parity = 0;

  for (long long tile = blockIdx.x; tile < g.total; tile += gridDim.x) {
    const long long b = tile / tiles;
    const int tr = (int)(tile % tiles) / g.tiles_n;
    const int tc = (int)(tile % tiles) % g.tiles_n;
    const int r0 = tr * g.th, c0 = tc * g.tw;
    const int R0 = r0 - g.H, C0 = c0 - g.H;          // the padded tile's
    const int R1 = r0 + g.th + g.H, C1 = c0 + g.tw + g.H;   // halo region
    // the window: height × pitch from (Rs, Xs), as pd_tile_run's
    int Rs = R0 < M - g.height ? R0 : M - g.height;
    Rs = Rs > 0 ? Rs : 0;
    int Xs = C0 >= 0 ? C0 - C0 % g.align : -((-C0 + g.align - 1) / g.align)
                                              * g.align;
    Xs = Xs < N - g.pitch ? Xs : N - g.pitch;
    Xs = Xs > 0 ? Xs : 0;
    const T* fb = a.f + b * mn;

    // u, w, p and q of the padded tile
    if (g.tma) {
      if (threadIdx.x == 0) {
        fence_async_smem();
        mbar_expect(bar, (unsigned)(TT_STATE * g.height * pitch
                                    * sizeof(T)));
        tma_load(S + TT_U * P, &maps.uin, bar, Xs, Rs, (int)b);
        for (int c = 0; c < 2; ++c) {
          tma_load(S + (TT_W + c) * P, &maps.win, bar, Xs, Rs,
                   (int)(2 * b + c));
          tma_load(S + (TT_P + c) * P, &maps.pin, bar, Xs, Rs,
                   (int)(2 * b + c));
        }
        for (int c = 0; c < 3; ++c)
          tma_load(S + (TT_Q + c) * P, &maps.qin, bar, Xs, Rs,
                   (int)(3 * b + c));
      }
      mbar_wait(bar, parity);
      parity ^= 1;
    } else {
      const int ra = R0 > 0 ? R0 : 0, rz = R1 < M ? R1 : M;
      const int ca = C0 > 0 ? C0 : 0, cz = C1 < N ? C1 : N;
      const int w = cz - ca;
      for (int e = threadIdx.x; e < (rz - ra) * w; e += PT_THREADS) {
        const int i = ra + e / w, j = ca + e % w;
        const long long gi = (long long)i * N + j;
        const int l = (i - Rs) * pitch + (j - Xs);
        S[TT_U * P + l] = io.u[b * mn + gi];
        for (int c = 0; c < 2; ++c) {
          S[(TT_W + c) * P + l] = io.w[(2 * b + c) * mn + gi];
          S[(TT_P + c) * P + l] = io.p[(2 * b + c) * mn + gi];
        }
        for (int c = 0; c < 3; ++c)
          S[(TT_Q + c) * P + l] = io.q[(3 * b + c) * mn + gi];
      }
      __syncthreads();
    }

    // tiles whose halo region keeps a pixel from the image's edge (where
    // every mask of the step holds) run the stencils without their masks
    if (R0 >= 1 && R1 <= M - 1 && C0 >= 1 && C1 <= N - 1)
      tt_iterate<false, MAP>(a, S, P, pitch, fb, R0, R1, C0, C1, Rs, Xs,
                             n_it);
    else
      tt_iterate<true, MAP>(a, S, P, pitch, fb, R0, R1, C0, C1, Rs, Xs,
                            n_it);

    // the owned pixels back to global memory
    if (g.tma) {
      // three planes at a time: staged densely (th × tw) in ū's and w̄'s
      // planes, stored by TMA, whose box drops what lies outside the image
#pragma unroll
      for (int s0 = 0; s0 < TT_STATE; s0 += 3) {
        const int ns = TT_STATE - s0 < 3
                           ? TT_STATE - s0 : 3;
        for (int e = threadIdx.x; e < g.th * g.tw; e += PT_THREADS) {
          const int i = r0 + e / g.tw, j = c0 + e % g.tw;
          if (i >= M || j >= N) continue;
          const int l = (i - Rs) * pitch + (j - Xs);
#pragma unroll
          for (int k = 0; k < 3; ++k)
            if (k < ns)
              S[(TT_UB + k) * P + e] = S[tt_smem_plane(s0 + k) * P + l];
        }
        fence_async_smem();
        __syncthreads();
        if (threadIdx.x == 0) {
          for (int k = 0; k < ns; ++k) {
            const int s = s0 + k;
            const CUtensorMap* m = s == 0 ? &maps.uout : s < 3 ? &maps.wout
                                   : s < 5 ? &maps.pout : &maps.qout;
            tma_store(m, S + (TT_UB + k) * P, c0, r0, (int)tt_z(s, b));
          }
          tma_store_read();
        }
        __syncthreads();
      }
    } else {
      const int rz = r0 + g.th < M ? r0 + g.th : M;
      const int cz = c0 + g.tw < N ? c0 + g.tw : N;
      const int w = cz - c0;
      for (int e = threadIdx.x; e < (rz - r0) * w; e += PT_THREADS) {
        const int i = r0 + e / w, j = c0 + e % w;
        const long long gi = (long long)i * N + j;
        const int l = (i - Rs) * pitch + (j - Xs);
        io.uo[b * mn + gi] = S[TT_U * P + l];
        for (int c = 0; c < 2; ++c) {
          io.wo[(2 * b + c) * mn + gi] = S[(TT_W + c) * P + l];
          io.po[(2 * b + c) * mn + gi] = S[(TT_P + c) * P + l];
        }
        for (int c = 0; c < 3; ++c)
          io.qo[(3 * b + c) * mn + gi] = S[(TT_Q + c) * P + l];
      }
      __syncthreads();
    }
  }
  if (g.tma && threadIdx.x == 0) tma_store_done();
}

// The host loop of the tile form: per early-stop chunk ⌈chunk / T⌉
// launches (the last shorter where T does not divide the chunk), then
// CpSumStop's two passes and one read (all maxiter iterations one chunk
// without tol).  u ping-pongs among u, uprev and u2 (a launch never writes
// the buffer it reads, nor the chunk's first iterate, which the stop
// compares), w, p and q each between its two buffers; a last copy brings
// each home.  *ops: the device operations issued.
template <typename T, bool MAP>
int tt_run(const TtArgs<T>& a, PtGeom g, int grid, T* u, T* uprev, T* u2,
           T* w, T* w2, T* p, T* p2, T* q, T* q2, T* partials, T* scal,
           int maxiter, int use_tol, T tol, int check_every, int* iters_out,
           int* ops, cudaStream_t s) {
  auto kern = tt_cp<T, MAP>;
  g.plane = (int)((((long long)g.height * g.pitch * sizeof(T) + PT_ALIGN - 1)
                   / PT_ALIGN) * PT_ALIGN / sizeof(T));
  const size_t smem = PT_ALIGN + (size_t)TT_PLANES * g.plane * sizeof(T);
  int dev = 0, optin = 0, per_sm = 0;
  cudaError_t e;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev);
  if (e != cudaSuccess) return (int)e;
  if (smem > (size_t)optin || grid < 1) return (int)cudaErrorInvalidValue;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                    PT_THREADS, smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;

  const long long mn = (long long)a.M * a.N;
  T* ub[3] = {u, uprev, u2};
  T* wb[2] = {w, w2};
  T* pb[2] = {p, p2};
  T* qb[2] = {q, q2};
  TtMaps maps;
  memset(&maps, 0, sizeof(maps));
  CUtensorMap ld_u[3], st_u[3], ld_w[2], st_w[2], ld_p[2], st_p[2],
      ld_q[2], st_q[2];
  if (g.tma) {
    int err;
    for (int k = 0; k < 3; ++k) {
      if ((err = pt_tensor_map<T>(&ld_u[k], ub[k], a.M, a.N, g.O, g.height,
                                  g.pitch)) != 0
          || (err = pt_tensor_map<T>(&st_u[k], ub[k], a.M, a.N, g.O, g.th,
                                     g.tw)) != 0)
        return err;
    }
    for (int k = 0; k < 2; ++k) {
      if ((err = pt_tensor_map<T>(&ld_w[k], wb[k], a.M, a.N, 2 * g.O,
                                  g.height, g.pitch)) != 0
          || (err = pt_tensor_map<T>(&st_w[k], wb[k], a.M, a.N, 2 * g.O,
                                     g.th, g.tw)) != 0
          || (err = pt_tensor_map<T>(&ld_p[k], pb[k], a.M, a.N, 2 * g.O,
                                     g.height, g.pitch)) != 0
          || (err = pt_tensor_map<T>(&st_p[k], pb[k], a.M, a.N, 2 * g.O,
                                     g.th, g.tw)) != 0
          || (err = pt_tensor_map<T>(&ld_q[k], qb[k], a.M, a.N, 3 * g.O,
                                     g.height, g.pitch)) != 0
          || (err = pt_tensor_map<T>(&st_q[k], qb[k], a.M, a.N, 3 * g.O,
                                     g.th, g.tw)) != 0)
        return err;
    }
  }
  int cu = 0, cy = 0;   // the buffers that hold the iterate
  // n iterations in launches of T; snap: a u buffer not to write
  auto advance = [&](int n, int snap) -> cudaError_t {
    for (int done = 0; done < n; done += g.T) {
      const int m = n - done < g.T ? n - done : g.T;
      int to = (cu + 1) % 3;
      if (to == snap || (snap < 0 && to == 2)) to = (to + 1) % 3;
      if (to == cu) to = (cu + 2) % 3;
      if (g.tma) {
        maps.uin = ld_u[cu];
        maps.uout = st_u[to];
        maps.win = ld_w[cy];
        maps.wout = st_w[1 - cy];
        maps.pin = ld_p[cy];
        maps.pout = st_p[1 - cy];
        maps.qin = ld_q[cy];
        maps.qout = st_q[1 - cy];
      }
      const TtBufs<T> io{ub[cu], wb[cy], pb[cy], qb[cy],
                         ub[to], wb[1 - cy], pb[1 - cy], qb[1 - cy]};
      kern<<<grid, PT_THREADS, smem, s>>>(a, g, io, m, maps);
      ++*ops;
      cudaError_t le = cudaGetLastError();
      if (le != cudaSuccess) return le;
      cu = to;
      cy = 1 - cy;
    }
    return cudaSuccess;
  };
  int it = 0;
  if (!use_tol) {
    if ((e = advance(maxiter, -1)) != cudaSuccess) return (int)e;
    it = maxiter;
  } else {
    CpSumStop<T, true> stop{partials, scal, g.O * mn, {}};
    T rel = (T)INFINITY;
    while (it < maxiter && rel > tol) {
      const int chunk = check_every < maxiter - it ? check_every
                                                   : maxiter - it;
      const int snap = cu;
      if ((e = advance(chunk, snap)) != cudaSuccess) return (int)e;
      if ((e = stop.check(ub[cu], ub[snap], ops, s)) != cudaSuccess)
        return (int)e;
      if ((e = cudaStreamSynchronize(s)) != cudaSuccess) return (int)e;
      rel = stop.rel();
      it += chunk;
    }
  }
  const size_t bytes = (size_t)(g.O * mn) * sizeof(T);
  if (cu != 0) {
    e = cudaMemcpyAsync(u, ub[cu], bytes, cudaMemcpyDeviceToDevice, s);
    if (e != cudaSuccess) return (int)e;
    ++*ops;
  }
  if (cy != 0) {
    const size_t n[3] = {2 * bytes, 2 * bytes, 3 * bytes};
    T* home[3] = {w, p, q};
    T* from[3] = {w2, p2, q2};
    for (int k = 0; k < 3; ++k) {
      e = cudaMemcpyAsync(home[k], from[k], n[k], cudaMemcpyDeviceToDevice,
                          s);
      if (e != cudaSuccess) return (int)e;
      ++*ops;
    }
  }
  *iters_out = it;
  return (int)cudaGetLastError();
}

template <typename T>
int tgv_tile(const T* f, T* u, T* w, T* p, T* q, T* uprev, T* u2, T* w2,
             T* p2, T* q2, T* partials, T* scal, const T* a1map,
             const T* a0map, T a1, T a0, long long O, int M, int N,
             const int* plan, T tau, T sigma, int maxiter, int use_tol, T tol,
             int check_every, int* iters_out, int* ops, cudaStream_t s) {
  *ops = 0;
  *iters_out = 0;
  if (maxiter < 0 || (use_tol && check_every < 1))
    return (int)cudaErrorInvalidValue;
  PtGeom g;
  // plan: th, tw, T, H, height, pitch, tiles_m, tiles_n, grid, tma
  g.O = O;
  g.th = plan[0];
  g.tw = plan[1];
  g.T = plan[2];
  g.H = plan[3];
  g.height = plan[4];
  g.pitch = plan[5];
  g.tiles_m = plan[6];
  g.tiles_n = plan[7];
  g.tma = plan[9];
  g.total = O * g.tiles_m * g.tiles_n;
  g.plane = 0;
  g.align = 16 / (int)sizeof(T);
  if (!pt_geom_ok(O, M, N, TT_PLANES, 3, TT_REACH, g.th, g.tw,
                  g.T, g.H, g.height, g.pitch, g.tiles_m, g.tiles_n, g.tma,
                  (int)sizeof(T)))
    return (int)cudaErrorInvalidValue;
  if (g.tma) {
    // TMA copies the state (f and the maps are plain loads)
    const uintptr_t mask = 15;
    if ((((uintptr_t)u | (uintptr_t)uprev | (uintptr_t)u2 | (uintptr_t)w
          | (uintptr_t)w2 | (uintptr_t)p | (uintptr_t)p2 | (uintptr_t)q
          | (uintptr_t)q2) & mask) != 0)
      return (int)cudaErrorInvalidValue;
  }
  const TtArgs<T> a{f, a1map, a0map, a1, a0, tau, sigma, M, N};
  if (a1map || a0map)
    return tt_run<T, true>(a, g, plan[8], u, uprev, u2, w, w2, p, p2, q, q2,
                           partials, scal, maxiter, use_tol, tol,
                           check_every, iters_out, ops, s);
  return tt_run<T, false>(a, g, plan[8], u, uprev, u2, w, w2, p, p2, q, q2,
                          partials, scal, maxiter, use_tol, tol, check_every,
                          iters_out, ops, s);
}

}  // namespace bpl

extern "C" {

// The TGV² CP solve's tile form: f, the state (u, w, p, q) updated in
// place, the second buffers (uprev and u2 of u, w2, p2, q2 of w, p, q),
// the early stop's partials (2·⌈O·M·N / 256⌉ elements) and scal (3); the
// weights as bpl_tgv_solve_* takes them; plan the tile plan
// (solvers/cluster_plan.py::tgv_tile_plan): th, tw, T, H, height, pitch,
// tiles_m, tiles_n, grid, tma.  *iters_out: the iterations run; *ops_out:
// the device operations issued.
int bpl_tgv_tile_f32(const float* f, float* u, float* w, float* p, float* q,
                     float* uprev, float* u2, float* w2, float* p2,
                     float* q2, float* partials, float* scal,
                     const float* a1map, const float* a0map, float a1,
                     float a0, long long O, int M, int N, const int* plan,
                     float tau, float sigma, int maxiter, int use_tol,
                     float tol, int check_every, int* iters_out,
                     int* ops_out, void* stream) {
  return bpl::tgv_tile<float>(f, u, w, p, q, uprev, u2, w2, p2, q2, partials,
                              scal, a1map, a0map, a1, a0, O, M, N, plan, tau,
                              sigma, maxiter, use_tol, tol, check_every,
                              iters_out, ops_out, (cudaStream_t)stream);
}

int bpl_tgv_tile_f64(const double* f, double* u, double* w, double* p,
                     double* q, double* uprev, double* u2, double* w2,
                     double* p2, double* q2, double* partials, double* scal,
                     const double* a1map, const double* a0map, double a1,
                     double a0, long long O, int M, int N, const int* plan,
                     double tau, double sigma, int maxiter, int use_tol,
                     double tol, int check_every, int* iters_out,
                     int* ops_out, void* stream) {
  return bpl::tgv_tile<double>(f, u, w, p, q, uprev, u2, w2, p2, q2,
                               partials, scal, a1map, a0map, a1, a0, O, M, N,
                               plan, tau, sigma, maxiter, use_tol, tol,
                               check_every, iters_out, ops_out,
                               (cudaStream_t)stream);
}

}  // extern "C"
