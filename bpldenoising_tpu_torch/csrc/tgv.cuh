// The TGV² joint-primal Chambolle–Pock step (solvers/tgv.py::_step): the
// state struct and the primal and dual kernels, one thread per pixel.  The
// CP solve (tgv.cu, TPU kernels 4 and 5) launches these kernels in its
// two-launch form; its cluster form and the single-loop TGV² learner
// (single_loop_tgv.cu, TPU kernel 11) run their arithmetic, in their
// order, on the bands of tgv_cluster.cuh.
#pragma once

#include "common.cuh"

namespace bpl {

template <typename T>
struct TGV {
  const T* f;
  T* u;         // (O, M, N)
  T* w;         // (O, 2, M, N)
  T* p;         // (O, 2, M, N)
  T* q;         // (O, 3, M, N)
  T* ubar;      // (O, M, N) scratch
  T* wbar;      // (O, 2, M, N) scratch
  const T* a1map;   // (M, N) or null: then a1 is used
  const T* a0map;
  T a1, a0, tau, sigma;
  long long n;
  int M, N;
};

template <typename T>
__device__ __forceinline__ T sqrt2() {
  return T(1.4142135623730951);
}

// Adjoint of the backward difference along rows / columns at (i, j) of a
// plane: (D⁻)ᵀz = z[i] − z[i+1], masked at both ends as ops/grad.py.
template <typename T>
__device__ __forceinline__ T dminus_T_rows(const T* z, long long k, int i,
                                           int M, int N) {
  T a = (i >= 1) ? z[k] : T(0);
  T b = (i < M - 1) ? z[k + N] : T(0);
  return a - b;
}

template <typename T>
__device__ __forceinline__ T dminus_T_cols(const T* z, long long k, int j,
                                           int N) {
  T a = (j >= 1) ? z[k] : T(0);
  T b = (j < N - 1) ? z[k + 1] : T(0);
  return a - b;
}

// The symmetrised gradient E of the vector field (vr, vc) at in-image
// index k, by backward differences: (D⁻ᵣvr, D⁻_c vc, (D⁻_c vr + D⁻ᵣvc)/√2),
// as ops/tgv.py::sym_grad.  The CP dual step and the learner's joint
// system both take it here.
template <typename T>
__device__ __forceinline__ void sym_grad_bwd(const T* vr, const T* vc,
                                             long long k, Pix p, int N,
                                             T& e0, T& e1, T& e2) {
  e0 = p.i >= 1 ? vr[k] - vr[k - N] : T(0);
  e1 = p.j >= 1 ? vc[k] - vc[k - 1] : T(0);
  T drc = p.j >= 1 ? vr[k] - vr[k - 1] : T(0);
  T dcr = p.i >= 1 ? vc[k] - vc[k - N] : T(0);
  e2 = (drc + dcr) / sqrt2<T>();
}

template <typename T>
__global__ void tgv_primal(TGV<T> s) {
  long long idx = (long long)blockIdx.x * BPL_THREADS + threadIdx.x;
  if (idx >= s.n) return;
  Pix px = pix_of(idx, s.M, s.N);
  const long long MN = (long long)s.M * s.N;
  const long long k = idx - px.b * MN;
  const T* pr = s.p + px.b * 2 * MN;
  const T* pc = pr + MN;
  const T* qrr = s.q + px.b * 3 * MN;
  const T* qcc = qrr + MN;
  const T* qrc = qcc + MN;
  T* wr = s.w + px.b * 2 * MN;
  T* wc = wr + MN;
  T* wbr = s.wbar + px.b * 2 * MN;
  T* wbc = wbr + MN;
  const T tau = s.tau;

  T divp = div_k(pr, pc, k, px, s.M, s.N, STENCIL_FWD);
  T uo = s.u[idx];
  T un = (uo - tau * divp + tau * s.f[idx]) / (T(1) + tau);
  T er = dminus_T_rows(qrr, k, px.i, s.M, s.N)
         + dminus_T_cols(qrc, k, px.j, s.N) / sqrt2<T>();
  T ec = dminus_T_cols(qcc, k, px.j, s.N)
         + dminus_T_rows(qrc, k, px.i, s.M, s.N) / sqrt2<T>();
  T wro = wr[k], wco = wc[k];
  T wrn = wro + tau * (pr[k] - er);
  T wcn = wco + tau * (pc[k] - ec);
  s.u[idx] = un;
  s.ubar[idx] = T(2) * un - uo;
  wr[k] = wrn;
  wc[k] = wcn;
  wbr[k] = T(2) * wrn - wro;
  wbc[k] = T(2) * wcn - wco;
}

template <typename T>
__global__ void tgv_dual(TGV<T> s) {
  long long idx = (long long)blockIdx.x * BPL_THREADS + threadIdx.x;
  if (idx >= s.n) return;
  Pix px = pix_of(idx, s.M, s.N);
  const int M = s.M, N = s.N;
  const long long MN = (long long)M * N;
  const long long k = idx - px.b * MN;
  T* pr = s.p + px.b * 2 * MN;
  T* pc = pr + MN;
  T* qrr = s.q + px.b * 3 * MN;
  T* qcc = qrr + MN;
  T* qrc = qcc + MN;
  const T* wbr = s.wbar + px.b * 2 * MN;
  const T* wbc = wbr + MN;
  const T sigma = s.sigma;
  const T a1 = s.a1map ? s.a1map[k] : s.a1;
  const T a0 = s.a0map ? s.a0map[k] : s.a0;

  // p: dual of ∇u − w
  T gx, gy;
  grad_k(s.ubar, idx, px, M, N, STENCIL_FWD, gx, gy);
  T br = wbr[k], bc = wbc[k];
  T ptr = pr[k] + sigma * (gx - br);
  T ptc = pc[k] + sigma * (gy - bc);
  T sp = ball_scale(ptr * ptr + ptc * ptc, a1);
  pr[k] = ptr * sp;
  pc[k] = ptc * sp;

  // q: dual of E w̄
  T err, ecc, erc;
  sym_grad_bwd(wbr, wbc, k, px, N, err, ecc, erc);
  T t0 = qrr[k] + sigma * err;
  T t1 = qcc[k] + sigma * ecc;
  T t2 = qrc[k] + sigma * erc;
  T sq = ball_scale(t0 * t0 + t1 * t1 + t2 * t2, a0);
  qrr[k] = t0 * sq;
  qcc[k] = t1 * sq;
  qrc[k] = t2 * sq;
}

}  // namespace bpl
