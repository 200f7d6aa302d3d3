// The band scheme of the VTV CP iterations (the channel-coupled Frobenius
// projection): the single-loop VTV learner's unaccelerated CP step
// (bilevel/first_order_vtv.py, ω = 1; csrc/single_loop_vtv.cu's slv_pd,
// TPU row 13) and the accelerated CP solve (solvers/pdps.py on
// models.vtv_model(); csrc/vtv.cu's vtv_cp, TPU row 6) run it, one
// thread-block cluster per image, on csrc/pd_cluster.cuh's launch
// (pd_cluster_prepare), thread block and slot scheme.
//
// CTA r of an image's cluster owns rows [r0, r1) = [r·rows, (r+1)·rows) ∩
// [0, M) and holds on rows r0 − 2 … r1 + 1 (band row l = i − r0 + 2) the
// C planes of u, the C planes of ū and the 2C dual planes (channel k's two
// components at 2k, 2k + 1, y's own layout), then its halo slots
// [parity][top, bottom][2 rows][2C dual planes][N].  The primal step at
// row i reads y on rows i − 1, i (common.cuh's pd_primal: div y); the dual
// step reads ū on rows i, i + 1 (vtv.cuh's vtv_dual: ∇ū) and couples the C
// channels of a pixel, which lie in the same band.  So, per CP iteration:
// the primal step on rows r0 − 1 … r1 (own rows and one halo row each
// side; the halo rows' u and ū come out equal to the owner's, same inputs
// and operations), the dual step on the own rows, whose top two and bottom
// two rows also go into the neighbours' halo slots of the next parity
// (distributed shared memory), then one cluster barrier; the next
// iteration copies its slots into the band's halo rows.  f and α are read
// through the caches.  RES: the band lives in shared memory (else in a
// global scratch laid out alike).  The state is read from global memory
// once per launch and written back once.
//
// Each pixel runs pd_primal's and vtv_dual's arithmetic in their order
// (u⁺ = (u − τ(div y − f))/(1 + τ), ū = (1 + ω)u⁺ − ωu, or 2u⁺ − u
// unaccelerated, the Frobenius sum of the 2C squares into four
// accumulators, term e into e mod 4, ball_scale), so under -fmad=false the
// iterates are the two kernels' bits.  CC: the
// channel count where it is fixed at compile time (3, color), so the
// channel loops unroll and the dual's 2C values q = y + σ∇ū stay in
// registers between the norm and the store; CC = 0 takes any C and forms
// q twice, as vtv_dual does (the same bits either way).
#pragma once

#include "pd_cluster.cuh"

namespace bpl {

// Elements of one VTV CTA's band: the 4C planes (u, ū, the two dual
// components per channel) on rows + 4 rows, then its halo slots
// (2 parities × 2 sides × 2 rows × 2C dual planes).
inline long long vtv_region(int C, int rows, int N) {
  return (4LL * C * (rows + 4) + 16LL * C) * N;
}

// Whether a plan of cl CTAs an image, rows each, can run C-channel M × N
// images: pd_plan_ok's rule for the VTV band.
inline bool vtv_plan_ok(int M, int N, int C, int cl, int rows) {
  return C >= 1 && cl >= 1 && cl <= PD_MAX_CLUSTER_NP && rows >= 1
         && (long long)rows * cl >= M && (cl == 1 || rows >= 2)
         && (long long)C * M * N <= 0x7fffffffLL
         && vtv_region(C, rows, N) <= 0x7fffffffLL;
}

// A pixel's Frobenius sum over its C channels, Σₖ (x_k + y_k) with term
// (k, x, y) giving channel k's two terms, in frob_acc's order (term e =
// 2k or 2k + 1 into accumulator e mod 4, then ((a0 + a1) + a2) + a3), with
// the accumulators in registers for any C; CC > 0 fixes C at compile time
// (the loop unrolls).
template <typename T, int CC = 0, class F>
__device__ __forceinline__ T frob_sum(int C, F term) {
  const int n = CC > 0 ? CC : C;
  T a0 = T(0), a1 = T(0), a2 = T(0), a3 = T(0);
#pragma unroll
  for (int k = 0; k < n; k += 2) {
    T x, y;
    term(k, x, y);
    a0 += x;
    a1 += y;
    if (k + 1 < n) {
      term(k + 1, x, y);
      a2 += x;
      a3 += y;
    }
  }
  return ((a0 + a1) + a2) + a3;
}

// n_it VTV CP iterations of one image (blockIdx.x / cl) under the band
// scheme, C = CC channels (or s.C where CC is 0).  S is the iteration's
// step, which the caller's kernel builds:
//   members M, N, C, cl, rows (the plan), region (elements of a band), pd
//   (the global bands, read when !RES), tau, sigma;
//   S::ACCEL, a compile-time constant: false, the unaccelerated step at
//   the constant τ and σ (ū = 2u⁺ − u); true, the accelerated step at
//   at(it, τ, ω, σ)'s scalars of iteration it (ū = (1 + ω)u⁺ − ωu, the dual
//   step at that σ);
//   u(b), y(b): image b's state in global memory ((C, M, N), (C, 2, M, N)),
//   read at the start; y written back in place, u into u_out(b) (u(b)
//   itself, or a second buffer: the early stop's old iterate stays in
//   u(b)); f(b) (C, M, N); mn() = M·N;
//   alpha(i, j): the weight at pixel (i, j).
// The caller's kernel runs cluster-wide; `smem` is its dynamic shared
// memory.
template <typename T, bool RES, int CC, class S>
__device__ __forceinline__ void vtv_cluster_run(const S& s,
                                                unsigned char* smem,
                                                int n_it) {
  cgrp::cluster_group cluster = cgrp::this_cluster();
  const int rank = (int)cluster.block_rank();
  const long long b = blockIdx.x / s.cl;
  const int M = s.M, N = s.N, C = CC > 0 ? CC : s.C, ny = 2 * C;
  const int ty = (int)threadIdx.x / PD_TX, tx = (int)threadIdx.x % PD_TX;
  const int r0 = rank * s.rows;
  const int r1 = r0 + s.rows < M ? r0 + s.rows : M;
  const bool has = r1 > r0;
  const int band = (s.rows + 4) * N;
  const int slot_rows = ny * N;                   // one slot row, 2C planes
  T* base = RES ? reinterpret_cast<T*>(smem)
                : s.pd + (long long)blockIdx.x * s.region;
  T* U = base;                     // channel k at U + k·band
  T* UB = base + C * band;         // channel k at UB + k·band
  T* Y = base + 2 * C * band;      // dual plane d at Y + d·band
  T* slots = Y + ny * band;
  T* up = nullptr;      // the slots of the CTA above (its bottom rows)
  T* down = nullptr;    // the slots of the CTA below (its top rows)
  if (has && rank > 0)
    up = RES ? cluster.map_shared_rank(slots, rank - 1) : slots - s.region;
  if (has && r1 < M)
    down = RES ? cluster.map_shared_rank(slots, rank + 1) : slots + s.region;
  const T* fb = s.f(b);
  // every CTA of the cluster runs before any stores into another's slots
  cluster.sync();

  // u and the duals on rows r0 − 2 … r1 + 1 that exist
  const int lo = r0 - 2 > 0 ? r0 - 2 : 0;
  const int hi = r1 + 2 < M ? r1 + 2 : M;
  if (has) {
    const long long mn = s.mn();
    const T* ui = s.u(b);
    const T* yi = s.y(b);
    for (int q = threadIdx.x; q < (hi - lo) * N; q += PD_THREADS) {
      const long long g = (long long)lo * N + q;
      const int l = (lo - r0 + 2) * N + q;
      for (int k = 0; k < C; ++k) {
        U[k * band + l] = ui[k * mn + g];
        Y[2 * k * band + l] = yi[2 * k * mn + g];
        Y[(2 * k + 1) * band + l] = yi[(2 * k + 1) * mn + g];
      }
    }
  }

  // the primal step's rows: own and one halo row each side
  const int pa = r0 - 1 > 0 ? r0 - 1 : 0;
  const int pb = has ? (r1 + 1 < M ? r1 + 1 : M) : pa;
  T tau = s.tau, sigma = s.sigma, omega = T(1);
  for (int it = 0; it < n_it; ++it) {
    if constexpr (S::ACCEL) s.at(it, tau, omega, sigma);
    const int par = it & 1;
    if (it > 0 && has) {
      // slots[par] → the band's halo rows r0 − 2, r0 − 1 (from above) and
      // r1, r1 + 1 (from below); slot row (side·2 + row)·2C + plane
      const T* src = slots + par * 4 * slot_rows;
      for (int cr = ty; cr < 4 * ny; cr += PD_TY) {
        const int side = cr / (2 * ny), row = (cr / ny) % 2;
        const int i = side == 0 ? r0 - 2 + row : r1 + row;
        if (!(side == 0 ? rank > 0 : r1 < M) || i < 0 || i >= M) continue;
        T* dst = Y + (cr % ny) * band + (i - r0 + 2) * N;
        for (int j = tx; j < N; j += PD_TX) dst[j] = src[cr * N + j];
      }
    }
    __syncthreads();
    // the primal step (pd_primal): u⁺ and ū per channel
    band_rows(pa, pb, N, [&](int i, int j) {
      const Pix p = pix(b, i, j);
      const int l = (i - r0 + 2) * N + j;
      const T* fp = fb + (long long)i * N + j;
      const long long mn = s.mn();
#pragma unroll
      for (int k = 0; k < C; ++k) {
        const T* qx = Y + 2 * k * band;
        const T dv = div_s(qx, qx + band, l, p, M, N, N, STENCIL_FWD);
        const T uo = U[k * band + l];
        const T un = (uo - tau * (dv - fp[k * mn])) / (T(1) + tau);
        U[k * band + l] = un;
        if constexpr (S::ACCEL)
          UB[k * band + l] = (T(1) + omega) * un - omega * uo;
        else
          UB[k * band + l] = T(2) * un - uo;
      }
    });
    __syncthreads();
    // the dual step (vtv_dual): y = Π_α(y + σ∇ū) over the 2C components of
    // a pixel; the top and bottom two rows also into the neighbours' slots
    // of the next parity
    const bool send = it + 1 < n_it;
    T* to_up = up && send ? up + (1 - par) * 4 * slot_rows + 2 * slot_rows
                          : nullptr;              // its bottom rows
    T* to_down = down && send ? down + (1 - par) * 4 * slot_rows : nullptr;
    band_rows(r0, r1, N, [&](int i, int j) {
      const Pix p = pix(b, i, j);
      const int l = (i - r0 + 2) * N + j;
      auto q_of = [&](int k, T& qx, T& qy) {
        T gx, gy;
        grad_s((const T*)UB + k * band, l, p, M, N, N, STENCIL_FWD, gx, gy);
        qx = Y[2 * k * band + l] + sigma * gx;
        qy = Y[(2 * k + 1) * band + l] + sigma * gy;
      };
      T* dst_up = to_up && i < r0 + 2 ? to_up + (i - r0) * slot_rows + j
                                      : nullptr;
      T* dst_dn = to_down && i >= r1 - 2
                      ? to_down + (i - r1 + 2) * slot_rows + j
                      : nullptr;
      auto store = [&](int k, T vx, T vy) {
        Y[2 * k * band + l] = vx;
        Y[(2 * k + 1) * band + l] = vy;
        if (dst_up) {
          dst_up[2 * k * N] = vx;
          dst_up[(2 * k + 1) * N] = vy;
        }
        if (dst_dn) {
          dst_dn[2 * k * N] = vx;
          dst_dn[(2 * k + 1) * N] = vy;
        }
      };
      if constexpr (CC > 0) {
        T qx[CC], qy[CC];
#pragma unroll
        for (int k = 0; k < CC; ++k) q_of(k, qx[k], qy[k]);
        const T n2 = frob_sum<T, CC>(CC, [&](int k, T& x, T& y) {
          x = qx[k] * qx[k];
          y = qy[k] * qy[k];
        });
        const T sc = ball_scale(n2, s.alpha(i, j));
#pragma unroll
        for (int k = 0; k < CC; ++k) store(k, qx[k] * sc, qy[k] * sc);
      } else {
        const T n2 = frob_sum<T>(C, [&](int k, T& x, T& y) {
          T qx, qy;
          q_of(k, qx, qy);
          x = qx * qx;
          y = qy * qy;
        });
        const T sc = ball_scale(n2, s.alpha(i, j));
        for (int k = 0; k < C; ++k) {
          T qx, qy;
          q_of(k, qx, qy);
          store(k, qx * sc, qy * sc);
        }
      }
    });
    cluster.sync();
  }

  // own rows back to global memory (no neighbour touches this CTA's
  // shared memory after the last cluster barrier)
  const long long mn = s.mn();
  T* uo = s.u_out(b);
  T* yo = s.y(b);
  for (int q = threadIdx.x; q < (r1 - r0) * N; q += PD_THREADS) {
    const long long g = (long long)r0 * N + q;
    const int l = 2 * N + q;
    for (int k = 0; k < C; ++k) {
      uo[k * mn + g] = U[k * band + l];
      yo[2 * k * mn + g] = Y[2 * k * band + l];
      yo[(2 * k + 1) * mn + g] = Y[(2 * k + 1) * band + l];
    }
  }
}

}  // namespace bpl
