// The channel-coupled VTV dual step (solvers/pdps.py on models.vtv_model):
// the struct and the dual kernel, one thread per pixel over the C
// channels; the primal step is common.cuh's pd_primal over the O·C planes.
// The accelerated CP solve (vtv.cu, TPU kernel 6) launches these kernels;
// the single-loop VTV learner (single_loop_vtv.cu, TPU kernel 13) runs the
// same arithmetic on its bands (vtv_cluster.cuh).
#pragma once

#include "common.cuh"

namespace bpl {

template <typename T>
struct VTV {
  const T* ubar;  // (O, C, M, N)
  T* y;           // (O, C, 2, M, N)
  const T* amap;  // (M, N) or null: then a is used
  T a;
  long long n;    // O·M·N pixels
  int C, M, N;
};

// A pixel's sum over the 2C terms of a Frobenius product, in the order of
// PyTorch's reduction on the card: four accumulators, term e into e mod 4.
template <typename T>
__device__ __forceinline__ void frob_acc(T* acc, int e, T x) {
  acc[e & 3] += x;
}

template <typename T>
__device__ __forceinline__ T frob_total(const T* acc) {
  return ((acc[0] + acc[1]) + acc[2]) + acc[3];
}

template <typename T>
__device__ __forceinline__ void vtv_q(const VTV<T>& s, long long plane,
                                      long long k, Pix p, T sigma, T& qx,
                                      T& qy) {
  const long long MN = (long long)s.M * s.N;
  T gx, gy;
  grad_k(s.ubar + plane * MN, k, p, s.M, s.N, STENCIL_FWD, gx, gy);
  const T* yx = s.y + plane * 2 * MN;
  qx = yx[k] + sigma * gx;
  qy = yx[MN + k] + sigma * gy;
}

template <typename T>
__global__ void vtv_dual(VTV<T> s, T sigma) {
  long long idx = (long long)blockIdx.x * BPL_THREADS + threadIdx.x;
  if (idx >= s.n) return;
  Pix p = pix_of(idx, s.M, s.N);
  const long long MN = (long long)s.M * s.N;
  const long long k = idx - p.b * MN;
  const long long plane0 = p.b * s.C;
  const T alpha = s.amap ? s.amap[k] : s.a;

  T acc[4] = {T(0), T(0), T(0), T(0)};
  for (int c = 0; c < s.C; ++c) {
    T qx, qy;
    vtv_q(s, plane0 + c, k, p, sigma, qx, qy);
    frob_acc(acc, 2 * c, qx * qx);
    frob_acc(acc, 2 * c + 1, qy * qy);
  }
  const T scale = ball_scale(frob_total(acc), alpha);
  for (int c = 0; c < s.C; ++c) {
    T qx, qy;
    vtv_q(s, plane0 + c, k, p, sigma, qx, qy);
    T* yx = s.y + (plane0 + c) * 2 * MN;
    yx[k] = qx * scale;
    yx[MN + k] = qy * scale;
  }
}

}  // namespace bpl
