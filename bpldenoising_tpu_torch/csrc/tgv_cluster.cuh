// The band scheme of the TGV² joint-primal CP iterations (solvers/tgv.py::
// _step) that keep each image on-chip: csrc/single_loop_tgv.cu's slt_pd
// (TPU row 11) and csrc/tgv.cu's tgv_cp (TPU rows 4–5) run it, one
// thread-block cluster per image, on csrc/pd_cluster.cuh's launch
// (pd_cluster_prepare), thread block and slot scheme.
//
// CTA c of an image's cluster owns rows [r0, r1) = [c·rows, (c+1)·rows) ∩
// [0, M) and holds on rows r0 − 2 … r1 + 1 (band row l = i − r0 + 2) the
// six primal planes u, ū, w_r, w_c, w̄_r, w̄_c and the five dual planes
// p_r, p_c, q_rr, q_cc, q_rc, then its halo slots [parity][top,
// bottom][2 rows][5 dual planes][N].  The primal step at row i reads p on
// rows i − 1, i and q on rows i, i + 1 (tgv.cuh's tgv_primal: div p and
// (D⁻)ᵀq); the dual step reads ū on rows i, i + 1 and w̄ on rows i − 1, i
// (tgv_dual: ∇ū and E w̄).  So, per CP iteration: the primal step on rows
// r0 − 1 … r1 (own rows and one halo row each side; the halo rows' u, w,
// ū and w̄ come out equal to the owner's, same inputs and operations), the
// dual step on the own rows, whose top two and bottom two rows also go
// into the neighbours' halo slots of the next parity (distributed shared
// memory), then one cluster barrier; the next iteration copies its slots
// into the band's halo rows.  f and α are read through the caches.  RES:
// the band lives in shared memory (else in a global scratch laid out
// alike).  The state is read from global memory once per launch and
// written back once.
//
// Each pixel runs tgv.cuh's arithmetic in its order (common.cuh's diff1 /
// adj1 with the backward kind are tgv.cuh's D⁻ and (D⁻)ᵀ, sym_grad_bwd's
// four differences), so under -fmad=false the iterates are tgv_primal's
// and tgv_dual's bits.  A half-step walks its rows' pixels in row-major
// order, PD_THREADS apart, so a warp reads 32 neighbouring columns.
#pragma once

#include "pd_cluster.cuh"
#include "tgv.cuh"

namespace bpl {

#define TG_DUAL 5                  // p_r, p_c, q_rr, q_cc, q_rc
#define TG_PLANES (6 + TG_DUAL)    // u, ū, w_r, w_c, w̄_r, w̄_c and the duals

// Elements of one TGV² CTA's band: the 11 planes on rows + 4 rows, then
// its halo slots (2 parities × 2 sides × 2 rows × 5 dual planes).
inline long long tgv_region(int rows, int N) {
  return ((long long)TG_PLANES * (rows + 4) + 8LL * TG_DUAL) * N;
}

// Whether a plan of cl CTAs an image, rows each, can run an M × N image:
// pd_plan_ok's rule for the TGV² band.
inline bool tgv_plan_ok(int M, int N, int cl, int rows) {
  return cl >= 1 && cl <= PD_MAX_CLUSTER_NP && rows >= 1
         && (long long)rows * cl >= M && (cl == 1 || rows >= 2)
         && (long long)M * N <= 0x7fffffffLL
         && tgv_region(rows, N) <= 0x7fffffffLL;
}

// n_it TGV² CP iterations of one image (blockIdx.x / cl) under the band
// scheme.  S is the iteration's step, which the caller's kernel builds:
//   members M, N, cl, rows (the plan), region (elements of a band), pd
//   (the global bands, read when !RES), tau, sigma;
//   u(b), w(b), p(b), q(b): image b's state in global memory ((M, N),
//   (2, M, N), (2, M, N), (3, M, N)), read at the start; w, p and q
//   written back in place, u into u_out(b) (u(b) itself, or a second
//   buffer: the early stop's old iterate stays in u(b)); f(b);
//   mn() = M·N;  a1(i, j), a0(i, j): the weights at pixel (i, j).
// The caller's kernel runs cluster-wide; `smem` is its dynamic shared
// memory.
template <typename T, bool RES, class S>
__device__ __forceinline__ void tgv_cluster_run(const S& s,
                                                unsigned char* smem,
                                                int n_it) {
  cgrp::cluster_group cluster = cgrp::this_cluster();
  const int c = (int)cluster.block_rank();
  const long long b = blockIdx.x / s.cl;
  const int M = s.M, N = s.N;
  const int ty = (int)threadIdx.x / PD_TX, tx = (int)threadIdx.x % PD_TX;
  const int r0 = c * s.rows;
  const int r1 = r0 + s.rows < M ? r0 + s.rows : M;
  const bool has = r1 > r0;
  const int band = (s.rows + 4) * N;
  const int slot_rows = TG_DUAL * N;              // one slot row
  T* base = RES ? reinterpret_cast<T*>(smem)
                : s.pd + (long long)blockIdx.x * s.region;
  T* U = base;
  T* UB = base + band;
  T* WR = base + 2 * band;
  T* WC = base + 3 * band;
  T* WBR = base + 4 * band;
  T* WBC = base + 5 * band;
  T* Y = base + 6 * band;          // dual plane d at Y + d·band
  T* slots = Y + TG_DUAL * band;
  T* up = nullptr;      // the slots of the CTA above (its bottom rows)
  T* down = nullptr;    // the slots of the CTA below (its top rows)
  if (has && c > 0)
    up = RES ? cluster.map_shared_rank(slots, c - 1) : slots - s.region;
  if (has && r1 < M)
    down = RES ? cluster.map_shared_rank(slots, c + 1) : slots + s.region;
  const T* fb = s.f(b);
  // every CTA of the cluster runs before any stores into another's slots
  cluster.sync();

  // u, w and the duals on rows r0 − 2 … r1 + 1 that exist
  const int lo = r0 - 2 > 0 ? r0 - 2 : 0;
  const int hi = r1 + 2 < M ? r1 + 2 : M;
  if (has) {
    const long long mn = s.mn();
    const T* ui = s.u(b);
    const T* wi = s.w(b);
    const T* pi = s.p(b);
    const T* qi = s.q(b);
    for (int q = threadIdx.x; q < (hi - lo) * N; q += PD_THREADS) {
      const long long g = (long long)lo * N + q;
      const int l = (lo - r0 + 2) * N + q;
      U[l] = ui[g];
      WR[l] = wi[g];
      WC[l] = wi[mn + g];
      Y[l] = pi[g];
      Y[band + l] = pi[mn + g];
      Y[2 * band + l] = qi[g];
      Y[3 * band + l] = qi[mn + g];
      Y[4 * band + l] = qi[2 * mn + g];
    }
  }

  // the primal step's rows: own and one halo row each side
  const int pa = r0 - 1 > 0 ? r0 - 1 : 0;
  const int pb = has ? (r1 + 1 < M ? r1 + 1 : M) : pa;
  const T tau = s.tau, sigma = s.sigma;
  for (int it = 0; it < n_it; ++it) {
    const int par = it & 1;
    if (it > 0 && has) {
      // slots[par] → the band's halo rows r0 − 2, r0 − 1 (from above) and
      // r1, r1 + 1 (from below); slot row (side·2 + row)·5 + plane
      const T* src = slots + par * 4 * slot_rows;
      for (int cr = ty; cr < 4 * TG_DUAL; cr += PD_TY) {
        const int side = cr / (2 * TG_DUAL), row = (cr / TG_DUAL) % 2;
        const int i = side == 0 ? r0 - 2 + row : r1 + row;
        if (!(side == 0 ? c > 0 : r1 < M) || i < 0 || i >= M) continue;
        T* dst = Y + (cr % TG_DUAL) * band + (i - r0 + 2) * N;
        for (int j = tx; j < N; j += PD_TX) dst[j] = src[cr * N + j];
      }
    }
    __syncthreads();
    // the primal step (tgv_primal): u⁺, ū, w⁺, w̄
    band_rows(pa, pb, N, [&](int i, int j) {
      const Pix p = pix(b, i, j);
      const int l = (i - r0 + 2) * N + j;
      const T* qrr = Y + 2 * band;
      const T* qcc = Y + 3 * band;
      const T* qrc = Y + 4 * band;
      const T divp = div_s((const T*)Y, (const T*)Y + band, l, p, M, N, N,
                           STENCIL_FWD);
      const T uo = U[l];
      const T un = (uo - tau * divp + tau * fb[(long long)i * N + j])
                   / (T(1) + tau);
      const T er = adj1(qrr, l, i, M, N, STENCIL_BWD)
                   + adj1(qrc, l, j, N, 1, STENCIL_BWD) / sqrt2<T>();
      const T ec = adj1(qcc, l, j, N, 1, STENCIL_BWD)
                   + adj1(qrc, l, i, M, N, STENCIL_BWD) / sqrt2<T>();
      const T wro = WR[l], wco = WC[l];
      const T wrn = wro + tau * (Y[l] - er);
      const T wcn = wco + tau * (Y[band + l] - ec);
      U[l] = un;
      UB[l] = T(2) * un - uo;
      WR[l] = wrn;
      WC[l] = wcn;
      WBR[l] = T(2) * wrn - wro;
      WBC[l] = T(2) * wcn - wco;
    });
    __syncthreads();
    // the dual step (tgv_dual): p = Π_α₁(p + σ(∇ū − w̄)), q = Π_α₀(q + σEw̄);
    // the top and bottom two rows also into the neighbours' slots of the
    // next parity
    const bool send = it + 1 < n_it;
    T* to_up = up && send ? up + (1 - par) * 4 * slot_rows + 2 * slot_rows
                          : nullptr;              // its bottom rows
    T* to_down = down && send ? down + (1 - par) * 4 * slot_rows : nullptr;
    band_rows(r0, r1, N, [&](int i, int j) {
      const Pix p = pix(b, i, j);
      const int l = (i - r0 + 2) * N + j;
      const T a1 = s.a1(i, j);
      const T a0 = s.a0(i, j);
      T gx, gy;
      grad_s((const T*)UB, l, p, M, N, N, STENCIL_FWD, gx, gy);
      const T br = WBR[l], bc = WBC[l];
      const T ptr = Y[l] + sigma * (gx - br);
      const T ptc = Y[band + l] + sigma * (gy - bc);
      const T sp = ball_scale(ptr * ptr + ptc * ptc, a1);
      T v[TG_DUAL];
      v[0] = ptr * sp;
      v[1] = ptc * sp;
      const T err = diff1((const T*)WBR, l, i, M, N, STENCIL_BWD);
      const T ecc = diff1((const T*)WBC, l, j, N, 1, STENCIL_BWD);
      const T drc = diff1((const T*)WBR, l, j, N, 1, STENCIL_BWD);
      const T dcr = diff1((const T*)WBC, l, i, M, N, STENCIL_BWD);
      const T erc = (drc + dcr) / sqrt2<T>();
      const T t0 = Y[2 * band + l] + sigma * err;
      const T t1 = Y[3 * band + l] + sigma * ecc;
      const T t2 = Y[4 * band + l] + sigma * erc;
      const T sq = ball_scale(t0 * t0 + t1 * t1 + t2 * t2, a0);
      v[2] = t0 * sq;
      v[3] = t1 * sq;
      v[4] = t2 * sq;
#pragma unroll
      for (int d = 0; d < TG_DUAL; ++d) Y[d * band + l] = v[d];
      if (to_up && i < r0 + 2) {
        T* dst = to_up + (i - r0) * slot_rows + j;
#pragma unroll
        for (int d = 0; d < TG_DUAL; ++d) dst[d * N] = v[d];
      }
      if (to_down && i >= r1 - 2) {
        T* dst = to_down + (i - r1 + 2) * slot_rows + j;
#pragma unroll
        for (int d = 0; d < TG_DUAL; ++d) dst[d * N] = v[d];
      }
    });
    cluster.sync();
  }

  // own rows back to global memory (no neighbour touches this CTA's
  // shared memory after the last cluster barrier)
  const long long mn = s.mn();
  T* uo = s.u_out(b);
  T* wo = s.w(b);
  T* po = s.p(b);
  T* qo = s.q(b);
  for (int q = threadIdx.x; q < (r1 - r0) * N; q += PD_THREADS) {
    const long long g = (long long)r0 * N + q;
    const int l = 2 * N + q;
    uo[g] = U[l];
    wo[g] = WR[l];
    wo[mn + g] = WC[l];
    po[g] = Y[l];
    po[mn + g] = Y[band + l];
    qo[g] = Y[2 * band + l];
    qo[mn + g] = Y[3 * band + l];
    qo[2 * mn + g] = Y[4 * band + l];
  }
}

}  // namespace bpl
