// The TV-L1 Chambolle–Pock step, plain or Huber-smoothed (solvers/tvl1.py,
// solvers/tvl1_huber.py): the state struct, the step's arithmetic and the
// primal and dual kernels, one thread per pixel.  The CP solve's two-launch
// form (tvl1.cu, TPU kernels 7 and 8) launches these kernels; the CP
// solve's cluster form (tvl1.cu's tvl1_cp) and the single-loop TV-L1
// learner's CP phase (single_loop_tvl1.cu's sl1_pd, TPU kernel 12, Huber
// form) run the same arithmetic.
#pragma once

#include "common.cuh"

namespace bpl {

template <typename T>
struct TVL1 {
  const T* f;
  T* u;          // (O, M, N)
  T* y;          // (O, 2, M, N)
  T* ubar;       // (O, M, N) scratch
  const T* amap; // (M, N) or null: then a is used
  T a, tau, sigma;
  T lo, den, gr; // Huber form: 1/γ_d + τ, 1 + τγ_d, γ_r
  long long n;
  int M, N;
};

template <typename T>
__device__ __forceinline__ T sign_(T z) {
  return z > T(0) ? T(1) : (z < T(0) ? T(-1) : T(0));
}

// u⁺ from the divergence d of the dual, u and f: z = (u − τd) − f, then
// u⁺ = f + shrink(z, τ) (plain) or f + the Huber prox of z (lo = 1/γ_d + τ,
// den = 1 + τγ_d), in the plain versions' order.
template <typename T, bool HUBER>
__device__ __forceinline__ T tvl1_prox(T d, T uo, T fv, T tau, T lo,
                                       T den) {
  T z = (uo - tau * d) - fv;
  T az = fabs(z);
  T p;
  if (HUBER) {
    p = (az <= lo) ? z / den : z - tau * sign_(z);
  } else {
    T m = az - tau;
    p = sign_(z) * (m < T(0) ? T(0) : m);
  }
  return fv + p;
}

// The Huber form's dual factor s = 1/(1 + σ/(max(α, 1e-12)·γ_r)).
template <typename T>
__device__ __forceinline__ T huber_dual_factor(T a, T sigma, T gr) {
  T a_safe = a > T(1e-12) ? a : T(1e-12);
  return T(1) / (T(1) + sigma / (a_safe * gr));
}

template <typename T, bool HUBER>
__global__ void tvl1_primal(TVL1<T> s) {
  long long idx = (long long)blockIdx.x * BPL_THREADS + threadIdx.x;
  if (idx >= s.n) return;
  Pix px = pix_of(idx, s.M, s.N);
  const long long MN = (long long)s.M * s.N;
  const long long k = idx - px.b * MN;
  const T* yx = s.y + px.b * 2 * MN;
  const T* yy = yx + MN;
  const T tau = s.tau;

  T d = div_k(yx, yy, k, px, s.M, s.N, STENCIL_FWD);
  T uo = s.u[idx];
  T un = tvl1_prox<T, HUBER>(d, uo, s.f[idx], tau, s.lo, s.den);
  s.u[idx] = un;
  s.ubar[idx] = T(2) * un - uo;
}

template <typename T, bool HUBER>
__global__ void tvl1_dual(TVL1<T> s) {
  long long idx = (long long)blockIdx.x * BPL_THREADS + threadIdx.x;
  if (idx >= s.n) return;
  Pix px = pix_of(idx, s.M, s.N);
  const long long MN = (long long)s.M * s.N;
  const long long k = idx - px.b * MN;
  T* yx = s.y + px.b * 2 * MN;
  T* yy = yx + MN;
  const T sigma = s.sigma;
  const T a = s.amap ? s.amap[k] : s.a;

  T gx, gy;
  grad_k(s.ubar, idx, px, s.M, s.N, STENCIL_FWD, gx, gy);
  T tx = yx[k] + sigma * gx;
  T ty = yy[k] + sigma * gy;
  if (HUBER) {
    T sc = huber_dual_factor(a, sigma, s.gr);
    tx = sc * tx;
    ty = sc * ty;
  }
  T b = ball_scale(tx * tx + ty * ty, a);
  yx[k] = tx * b;
  yy[k] = ty * b;
}

}  // namespace bpl
