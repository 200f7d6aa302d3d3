// The tile scheme of kernel A's CP iterations on images whose bands do not
// fit a cluster (csrc/pd_tile.cu's pdt_cp; the plan is solvers/cluster_plan.py
// ::pd_tile_plan).  It replaces, for those images, the two-launch form (one
// thread a pixel, the state in global memory, two launches an iteration),
// which moves u, ū, f and the duals through device memory every iteration:
// at 1×2048² that is ~11 plane passes an iteration for K = 1 and ~23 for
// K = 3, and the state (84–151 MB) does not stay in the 50 MB L2.  The
// TGV² CP solve's tile form (csrc/tgv_tile.cu) runs the same scheme on its
// own step with PtGeom, the TMA and mbarrier helpers, pt_region and the
// stencils below.
//
// Each image is cut into 2-D tiles of th × tw owned pixels, one CTA a tile.
// A CTA holds u, ū and the 2K dual planes of its tile and a halo of H
// pixels on every side in shared memory (f and the (M, N) maps it reads
// through L2 at 32-bit image offsets), runs T iterations there with
// __syncthreads between the half-steps, and writes back its owned pixels
// only.  An iteration's
// dependence moves `reach` pixels on each side (common.cuh's diff1 / adj1:
// the primal step reads yₖ at i − 1 for a forward or centred block and at
// i + 1 for a backward or centred one, the dual step reads ū at i + 1 and
// i − 1 likewise), so with H = reach·T every owned pixel's T-iteration cone
// lies in the tile: the primal and dual steps of iteration t run on the
// halo region shrunk by the reach already spent (a trapezoid), and their
// values there are the global iteration's, bit for bit (the same operations
// in the same order, -fmad=false; τ, ω, σ from the host's table).  The
// masks are taken at global coordinates, so the image edge is exact
// wherever it falls in a tile and no value from outside the image is read.
// u and the duals ping-pong between two global buffers (u among three when
// the early stop keeps the chunk's first iterate), so no tile overwrites a
// halo that a neighbour still reads.  With a 16-byte row (N·itemsize) the
// tile's planes are loaded by TMA, one 3-D tensor map (N, M, planes) a
// buffer, boxes of height × pitch on one mbarrier, and the owned pixels are
// staged densely in ū's plane and stored back by TMA; otherwise plain loads
// and stores.  Tiles whose halo region keeps two pixels from the image's
// edge (most of them) run the stencils without the masks.
//
// What bounds it on an H100: device traffic is 1 + 2K plane loads of the
// window and as many stores of the owned tile a launch, so T iterations
// cost about one pass of the state (at 1×2048², K = 1, T = 6: 127 MB a
// launch, ~6 ms of device time of the ~33 that 1000 iterations take).  The
// rest is the iterations inside the SM: the per-pixel passes issue ~142
// thread instructions a computed pixel and iteration at K = 1 (the sum,
// the IEEE division or the projection's rsqrt, shared-memory addressing,
// the slots' guards, part-full last passes), ~65% of the SMs' issue slots,
// and wait the rest on their dependent chains and two barriers an
// iteration at the 32 warps an SM that 64 registers a thread leave; the
// halo's recompute adds ~1.2 times the owned area (T = 6, 63 × 64).  So
// the plan keeps two CTAs an SM (one CTA on larger tiles, with less
// recompute and 16 warps, runs ~30% slower), one CTA a tile (a grid that
// walks the tiles runs a few percent slower) and f and the maps in L2
// (read first in a pass they are no faster); scripts/tile_sizes.py and
// scripts/tile_trace.py measure these and the passes' issue share.
#pragma once

#include <cuda.h>

#include <cstdint>

#include "pd_cluster.cuh"

namespace bpl {

// a tile CTA: PT_THREADS threads (pt_region deals them a region's pixels),
// each PT_CPT pixels at once; two CTAs an SM (64 registers)
#define PT_THREADS 512
#define PT_CPT 4
#define PT_MINB 2
// the planes' alignment in shared memory (TMA), the barrier's slot first
#define PT_ALIGN 128
// the largest side of a TMA box
#define PT_BOX_MAX 256

// The geometry of a tile launch (the host's plan): O images of tiles_m ×
// tiles_n tiles of th × tw owned pixels, T iterations a launch, halo H; a
// shared-memory window of height × pitch elements (th + 2H rows; the halo
// region's tw + 2H columns from a column of 16 bytes), its planes `plane`
// elements apart; TMA copies (tma).
struct PtGeom {
  long long O, total;
  int th, tw, T, H, height, pitch, plane, tiles_m, tiles_n, tma;
  int align;   // elements of 16 bytes
};

// The tensor maps of one launch: u and the duals read (boxes of the padded
// tile) and written (boxes of the owned tile).
struct PtMaps {
  CUtensorMap uin, uout, yin, yout;
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                   smem_addr(bar))
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

// generic-proxy writes (or reads) of shared memory ordered before the
// async proxy's (TMA) accesses
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int x, int y,
                                         int z) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"((uint64_t)map), "r"(smem_addr(bar)), "r"(x), "r"(y), "r"(z)
      : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          const void* src, int x, int y,
                                          int z) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4}], [%1];\n" ::"l"((uint64_t)map),
      "r"(smem_addr(src)), "r"(x), "r"(y), "r"(z)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// the stores issued so far have read their shared memory (.read) or are
// done
__device__ __forceinline__ void tma_store_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
__device__ __forceinline__ void tma_store_done() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Stencil shrink of each half-step on the low (top, left) and high
// (bottom, right) side: the primal step reads yₖ at i − 1 (forward,
// centred) and i + 1 (backward, centred), the dual step ū at i − 1
// (backward, centred) and i + 1 (forward, centred).
struct PtShrink {
  int pl, ph, dl, dh;
};

template <class S>
__device__ __forceinline__ PtShrink pt_shrink(const S& s) {
  PtShrink r{0, 0, 0, 0};
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    if (k >= s.K()) break;
    const int kd = s.kind(k);
    if (kd != STENCIL_BWD) r.pl = r.dh = 1;
    if (kd != STENCIL_FWD) r.ph = r.dl = 1;
  }
  return r;
}

// The 2-D stencils of common.cuh on the window (rows `rs` elements apart,
// (i, j) the pixel's image coordinates): with EDGE the image-edge masks of
// diff1 / adj1, without them the same operations for a pixel whose stencil
// lies inside the image (2 ≤ i ≤ M − 3, 2 ≤ j ≤ N − 3), bit for bit.
template <bool EDGE, typename T>
__device__ __forceinline__ T pt_diff(const T* v, int l, int i, int n, int s,
                                     int kind) {
  if (EDGE) return diff1(v, l, i, n, s, kind);
  if (kind == STENCIL_FWD) return v[l + s] - v[l];
  if (kind == STENCIL_BWD) return v[l] - v[l - s];
  return (v[l + s] - v[l - s]) * T(0.5);
}

template <bool EDGE, typename T>
__device__ __forceinline__ T pt_adj(const T* q, int l, int i, int n, int s,
                                    int kind) {
  if (EDGE) return adj1(q, l, i, n, s, kind);
  if (kind == STENCIL_FWD) return q[l - s] - q[l];
  if (kind == STENCIL_BWD) return q[l] - q[l + s];
  return (q[l - s] - q[l + s]) * T(0.5);
}

// The slots of one pass of pt_region: CPT pixels a thread, slot e the
// pixel (i[e], j[e]) where ok[e], l[e] its offset in the window and g[e] in
// its image (an int: the plan keeps M·N below 2³¹).
template <int CPT>
struct PtSlotsN {
  int i[CPT], j[CPT], l[CPT], g[CPT];
  bool ok[CPT];
};
using PtSlots = PtSlotsN<PT_CPT>;

// fn(slots) for every pixel of the region [ia, iz) × [ja, jz) of a window
// of rows `pitch` elements apart from (Rs, Xs) on an image of rows N
// elements apart: thread t takes the region's row-major positions t,
// t + PT_THREADS, …, CPT at a time (one division a thread, then a carry
// that moves the pixel and both offsets by additions), so every thread gets
// the same number of pixels whatever the region's sides and a warp's lanes
// take consecutive columns; fn makes each part of the step a pass over the
// slots, so that the loads of one slot are issued before the arithmetic of
// the next.
template <int CPT = PT_CPT, class F>
__device__ __forceinline__ void pt_region(int ia, int iz, int ja, int jz,
                                          int Rs, int Xs, int pitch, int N,
                                          F fn) {
  const int w = jz - ja;
  if (w <= 0 || iz <= ia) return;
  const int n = (iz - ia) * w;
  int q = (int)threadIdx.x;
  int i = ia + q / w, j = ja + q % w;
  int l = (i - Rs) * pitch + (j - Xs), g = i * N + j;
  const int di = PT_THREADS / w, dj = PT_THREADS % w;
  const int dl = di * pitch + dj, dg = di * N + dj;
  for (; q < n; q += CPT * PT_THREADS) {
    PtSlotsN<CPT> p;
#pragma unroll
    for (int e = 0; e < CPT; ++e) {
      p.i[e] = i;
      p.j[e] = j;
      p.l[e] = l;
      p.g[e] = g;
      p.ok[e] = q + e * PT_THREADS < n;
      i += di;
      j += dj;
      l += dl;
      g += dg;
      if (j >= jz) {
        j -= w;
        ++i;
        l += pitch - w;
        g += N - w;
      }
    }
    fn(p);
  }
}

// n_it iterations of a tile on its window (pd_tile_run below): the primal
// step on the halo region less the reach spent so far and its own, then
// the dual step on that less its own, __syncthreads between.  f and the
// maps are read from global memory (L2) at the pixel's image offset.
template <bool EDGE, typename T, class S>
__device__ __forceinline__ void pt_iterate(S& s, const PtShrink sh, T* U,
                                           T* UB, T* Y, const T* fb,
                                           const PtGeom& g, int R0, int R1,
                                           int C0, int C1, int Rs, int Xs,
                                           int n_it) {
  const int M = s.M, N = s.N, K = s.K(), P = g.plane, pitch = g.pitch;
  const int lo = sh.pl + sh.dl, hi = sh.ph + sh.dh;   // an iteration's
  for (int it = 0; it < n_it; ++it) {
    s.at(it);
    {
      // u⁺ and ū from Σₖ Gₖᵀyₖ (k in order), u and f
      const int a0 = R0 + it * lo + sh.pl, a1 = R1 - it * hi - sh.ph;
      const int b0 = C0 + it * lo + sh.pl, b1 = C1 - it * hi - sh.ph;
      pt_region(a0 > 0 ? a0 : 0, a1 < M ? a1 : M, b0 > 0 ? b0 : 0,
                b1 < N ? b1 : N, Rs, Xs, pitch, N, [&](const PtSlots& p) {
        T dv[PT_CPT], uo[PT_CPT], fv[PT_CPT];
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          if (k >= K) break;
          const T* qx = Y + 2 * k * P;
          const T* qy = qx + P;
#pragma unroll
          for (int e = 0; e < PT_CPT; ++e) {
            if (!p.ok[e]) continue;
            const T d = pt_adj<EDGE>(qx, p.l[e], p.i[e], M, pitch, s.kind(k))
                        + pt_adj<EDGE>(qy, p.l[e], p.j[e], N, 1, s.kind(k));
            dv[e] = k == 0 ? d : dv[e] + d;
          }
        }
#pragma unroll
        for (int e = 0; e < PT_CPT; ++e) {
          if (!p.ok[e]) continue;
          uo[e] = U[p.l[e]];
          fv[e] = fb[p.g[e]];
        }
#pragma unroll
        for (int e = 0; e < PT_CPT; ++e) {
          if (!p.ok[e]) continue;
          T ub;
          U[p.l[e]] = s.primal(dv[e], uo[e], fv[e], ub);
          UB[p.l[e]] = ub;
        }
      });
    }
    __syncthreads();
    {
      // yₖ = Π(yₖ + σGₖū), k in order
      const int a0 = R0 + it * lo + lo, a1 = R1 - it * hi - hi;
      const int b0 = C0 + it * lo + lo, b1 = C1 - it * hi - hi;
      pt_region(a0 > 0 ? a0 : 0, a1 < M ? a1 : M, b0 > 0 ? b0 : 0,
                b1 < N ? b1 : N, Rs, Xs, pitch, N, [&](const PtSlots& p) {
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          if (k >= K) break;
          T* qx = Y + 2 * k * P;
          T* qy = qx + P;
          T px[PT_CPT], py[PT_CPT];
#pragma unroll
          for (int e = 0; e < PT_CPT; ++e) {
            if (!p.ok[e]) continue;
            const T gx = pt_diff<EDGE>((const T*)UB, p.l[e], p.i[e], M,
                                       pitch, s.kind(k));
            const T gy = pt_diff<EDGE>((const T*)UB, p.l[e], p.j[e], N, 1,
                                       s.kind(k));
            px[e] = qx[p.l[e]] + s.sigma * gx;
            py[e] = qy[p.l[e]] + s.sigma * gy;
          }
#pragma unroll
          for (int e = 0; e < PT_CPT; ++e) {
            if (!p.ok[e]) continue;
            const T a = s.map(k) ? s.amap(k)[p.g[e]] : T(0);
            const T sc = s.scale_at(k, a, px[e] * px[e] + py[e] * py[e]);
            qx[p.l[e]] = px[e] * sc;
            qy[p.l[e]] = py[e] * sc;
          }
        }
      });
    }
    __syncthreads();
  }
}

// n_it CP iterations of every tile this CTA walks (blockIdx.x, then
// gridDim.x apart), from u and the duals in (uin, yin) to (uout, yout).
// S is kernel A's step (csrc/pdps.cuh: CpStep): M, N, K(), kind(k), map(k),
// at(it), sigma, primal(div, u, f, ū&), scale_at(k, α, n2), f(b) and the
// scalar weights and maps.  yin and yout hold the K duals as (K, O, 2, M, N)
// planes.  `smem` is the kernel's dynamic shared memory.
template <typename T, class S>
__device__ __forceinline__ void pd_tile_run(S& s, const PtGeom& g,
                                            const T* uin, T* uout,
                                            const T* yin, T* yout,
                                            const PtMaps& maps,
                                            unsigned char* smem, int n_it) {
  const int M = s.M, N = s.N, ny = 2 * s.K();
  const long long mn = (long long)M * N;
  const int P = g.plane, pitch = g.pitch;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  T* U = reinterpret_cast<T*>(smem + PT_ALIGN);
  T* UB = U + P;
  T* Y = UB + P;                                  // plane q at Y + q·P
  const PtShrink sh = pt_shrink(s);
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
    // the shared-memory window: height × pitch from (Rs, Xs), which holds
    // the halo region's part in the image; its column a multiple of 16
    // bytes, and inside the image where the image is as large as the box
    // (TMA's boxes start there)
    int Rs = R0 < M - g.height ? R0 : M - g.height;
    Rs = Rs > 0 ? Rs : 0;
    int Xs = C0 >= 0 ? C0 - C0 % g.align : -((-C0 + g.align - 1) / g.align)
                                              * g.align;
    Xs = Xs < N - g.pitch ? Xs : N - g.pitch;
    Xs = Xs > 0 ? Xs : 0;
    const T* fb = s.f(b);

    // u and the duals of the padded tile
    if (g.tma) {
      if (threadIdx.x == 0) {
        fence_async_smem();
        mbar_expect(bar, (unsigned)((1 + ny) * g.height * pitch * sizeof(T)));
        tma_load(U, &maps.uin, bar, Xs, Rs, (int)b);
        for (int q = 0; q < ny; ++q)
          tma_load(Y + q * P, &maps.yin, bar, Xs, Rs,
                   (int)(((q >> 1) * g.O + b) * 2 + (q & 1)));
      }
      mbar_wait(bar, parity);
      parity ^= 1;
    } else {
      const int ra = R0 > 0 ? R0 : 0, rz = R1 < M ? R1 : M;
      const int ca = C0 > 0 ? C0 : 0, cz = C1 < N ? C1 : N;
      const int w = cz - ca;
      for (int q = threadIdx.x; q < (rz - ra) * w; q += PT_THREADS) {
        const int i = ra + q / w, j = ca + q % w;
        const long long gi = (long long)i * N + j;
        const int l = (i - Rs) * pitch + (j - Xs);
        U[l] = uin[b * mn + gi];
        for (int p = 0; p < ny; ++p)
          Y[p * P + l] = yin[(((p >> 1) * g.O + b) * 2 + (p & 1)) * mn + gi];
      }
      __syncthreads();
    }

    // interior tiles (the halo region two pixels or more from the image's
    // edge, where no mask applies) run the stencils without their masks
    if (R0 >= 2 && R1 <= M - 2 && C0 >= 2 && C1 <= N - 2)
      pt_iterate<false, T>(s, sh, U, UB, Y, fb, g, R0, R1, C0, C1, Rs, Xs,
                           n_it);
    else
      pt_iterate<true, T>(s, sh, U, UB, Y, fb, g, R0, R1, C0, C1, Rs, Xs,
                          n_it);

    // the owned pixels back to global memory
    if (g.tma) {
      // plane by plane: staged densely (th × tw) in ū's plane, stored by
      // TMA, whose box drops what lies outside the image
      for (int q = 0; q <= ny; ++q) {
        const T* src = q == 0 ? U : Y + (q - 1) * P;
        for (int e = threadIdx.x; e < g.th * g.tw; e += PT_THREADS) {
          const int i = r0 + e / g.tw, j = c0 + e % g.tw;
          if (i < M && j < N) UB[e] = src[(i - Rs) * pitch + (j - Xs)];
        }
        fence_async_smem();
        __syncthreads();
        if (threadIdx.x == 0) {
          if (q == 0)
            tma_store(&maps.uout, UB, c0, r0, (int)b);
          else
            tma_store(&maps.yout, UB, c0, r0,
                      (int)((((q - 1) >> 1) * g.O + b) * 2 + ((q - 1) & 1)));
          tma_store_read();
        }
        __syncthreads();
      }
    } else {
      const int rz = r0 + g.th < M ? r0 + g.th : M;
      const int cz = c0 + g.tw < N ? c0 + g.tw : N;
      const int w = cz - c0;
      for (int q = threadIdx.x; q < (rz - r0) * w; q += PT_THREADS) {
        const int i = r0 + q / w, j = c0 + q % w;
        const long long gi = (long long)i * N + j;
        const int l = (i - Rs) * pitch + (j - Xs);
        uout[b * mn + gi] = U[l];
        for (int p = 0; p < ny; ++p)
          yout[(((p >> 1) * g.O + b) * 2 + (p & 1)) * mn + gi] =
              Y[p * P + l];
      }
      __syncthreads();
    }
  }
  if (g.tma && threadIdx.x == 0) tma_store_done();
}

// ------------------------------------------------------------------ host

// cuTensorMapEncodeTiled through the runtime's driver entry point (the
// library links no libcuda).
typedef CUresult (*PtEncode)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                             void*, const cuuint64_t*, const cuuint64_t*,
                             const cuuint32_t*, const cuuint32_t*,
                             CUtensorMapInterleave, CUtensorMapSwizzle,
                             CUtensorMapL2promotion,
                             CUtensorMapFloatOOBfill);

inline PtEncode pt_encoder() {
  static PtEncode fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = (PtEncode)p;
  }
  return fn;
}

// A 3-D tensor map over `planes` (M, N) planes of T at ptr, boxes of
// bh × bw × 1 elements; elements outside the tensor read as zero and are
// not written.  Returns a cudaError_t.
template <typename T>
int pt_tensor_map(CUtensorMap* map, const void* ptr, int M, int N,
                  long long planes, int bh, int bw) {
  PtEncode enc = pt_encoder();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)N, (cuuint64_t)M,
                              (cuuint64_t)planes};
  const cuuint64_t strides[2] = {(cuuint64_t)N * sizeof(T),
                                 (cuuint64_t)M * N * sizeof(T)};
  const cuuint32_t box[3] = {(cuuint32_t)bw, (cuuint32_t)bh, 1};
  const cuuint32_t one[3] = {1, 1, 1};
  CUresult r = enc(map,
                   sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                  : CU_TENSOR_MAP_DATA_TYPE_FLOAT64,
                   3, const_cast<void*>(ptr), dims, strides, box, one,
                   CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? (int)cudaSuccess : (int)cudaErrorInvalidValue;
}

// Whether the host's tile plan can run an O × M × N stack whose stencils
// reach `reach` pixels an iteration, on `planes` shared-memory planes,
// the largest tensor map holding zmax·O planes: the halo covers T
// iterations, the window holds the owned tile and its halo from a column
// of 16 bytes, the tiles cover the image, TMA's rules (16-byte rows and
// boxes and box columns, sides ≤ 256, load boxes inside the image) where
// it is asked for, and the tile's offsets fit an int.
inline bool pt_geom_ok(long long O, int M, int N, int planes, int zmax,
                       int reach, int th, int tw, int T, int H, int height,
                       int pitch, int tiles_m, int tiles_n, int tma,
                       int itemsize) {
  const int align = 16 / itemsize;
  if (O < 1 || M < 1 || N < 1 || th < 1 || tw < 1
      || T < 1 || H < reach * T || height != th + 2 * H
      || pitch < tw + 2 * H + align - 1 || (long long)tiles_m * th < M
      || (long long)tiles_n * tw < N || (long long)(tiles_m - 1) * th >= M
      || (long long)(tiles_n - 1) * tw >= N
      || (long long)height * pitch * planes > 0x7fffffffLL
      || (long long)(M + PT_THREADS * PT_CPT + 1) * N > 0x7fffffffLL)
    return false;
  if (tma)
    return height <= PT_BOX_MAX && pitch <= PT_BOX_MAX && th <= PT_BOX_MAX
           && tw <= PT_BOX_MAX && height <= M && pitch <= N
           && (pitch * itemsize) % 16 == 0
           && (tw * itemsize) % 16 == 0 && ((long long)N * itemsize) % 16 == 0
           && (long long)zmax * O <= 0x7fffffffLL;
  return true;
}

// pt_geom_ok for kernel A's K blocks (u, ū and the 2K duals).
inline bool pd_tile_ok(long long O, int M, int N, int K, int reach, int th,
                       int tw, int T, int H, int height, int pitch,
                       int tiles_m, int tiles_n, int tma, int itemsize) {
  return K >= 1 && K <= 3
         && pt_geom_ok(O, M, N, 2 + 2 * K, 2 * K, reach, th, tw, T, H,
                       height, pitch, tiles_m, tiles_n, tma, itemsize);
}

}  // namespace bpl
