// Kernel A: accelerated Chambolle–Pock (PDPS) TV denoising, scalar α, K=1.
//
// Replaces the TPU kernel bpldenoising_tpu/solvers/pdps_pallas.py::_make_kernel
// (body _pd_body, dispatched by _pallas_impl).  Per iteration, per pixel:
//   u⁺ = (u − τ(Gᵀy − f))/(1+τ);  ω = 1/√(1+2γτ), τ ← τω, σ ← σ/ω;
//   ū = (1+ω)u⁺ − ωu;  y = Π_{|·|≤α}(y + σGū)  (rsqrt form with `tiny`).
// G is the forward-difference gradient masked at the image boundary.
//
// What bounds it on an H100: the TPU kernel keeps whole images resident in
// VMEM for all iterations; a Hopper block has at most 227 KB of shared
// memory, less than one image's state (10×128² f32 is 2.6 MB for u, f, y).
// This first design is one thread per pixel over (batch, rows, cols) in
// global memory, two launches per iteration (the dual step reads ū at
// neighbouring pixels, so ū must be complete first).  The whole state stays
// in the 50 MB L2, so each launch moves L2 bytes, not HBM bytes; at the
// flagship's 163,840 pixels a launch is short and the iteration is bound
// by launch latency, not by bytes or operations.  The host loop that issues
// the launches lives here in C, so Python adds nothing per iteration.  The
// early stop runs every `check_every` iterations: a per-image reduction of
// ‖Δu‖² and ‖u‖² (one block per image) and one host read of the O ratios,
// whose max is compared with tol — the per-image semantics of
// solvers/pdps.py, not the Pallas kernel's one norm per VMEM chunk.
// τ, σ, ω are computed on the host in the working dtype, in the order of
// the plain version.
#include "common.cuh"

#include <vector>

namespace bpl {

template <typename T>
__global__ void pd_primal(const T* __restrict__ f, T* __restrict__ u,
                          T* __restrict__ ubar, const T* __restrict__ y,
                          long long n, int M, int N, T tau, T omega) {
  long long idx = (long long)blockIdx.x * BPL_THREADS + threadIdx.x;
  if (idx >= n) return;
  Pix p = pix_of(idx, M, N);
  const long long MN = (long long)M * N;
  const long long in_img = idx - p.b * MN;
  const T* qx = y + p.b * 2 * MN;
  const T* qy = qx + MN;
  T div = div_fwd_T(qx, qy, in_img, p, M, N);
  T uo = u[idx];
  T un = (uo - tau * (div - f[idx])) / (T(1) + tau);
  u[idx] = un;
  ubar[idx] = (T(1) + omega) * un - omega * uo;
}

template <typename T>
__global__ void pd_dual(const T* __restrict__ ubar, T* __restrict__ y,
                        long long n, int M, int N, T sigma, T alpha,
                        T alpha2) {
  long long idx = (long long)blockIdx.x * BPL_THREADS + threadIdx.x;
  if (idx >= n) return;
  Pix p = pix_of(idx, M, N);
  const long long MN = (long long)M * N;
  T gx, gy;
  grad_fwd(ubar, idx, p, M, N, gx, gy);
  T* qx = y + p.b * 2 * MN + (idx - p.b * MN);
  T* qy = qx + MN;
  T px = *qx + sigma * gx;
  T py = *qy + sigma * gy;
  T n2 = px * px + py * py;
  T scale = (n2 <= alpha2) ? T(1) : alpha * rsqrt_(n2 + tiny<T>());
  *qx = px * scale;
  *qy = py * scale;
}

// ratio[b] = ‖u_b − uprev_b‖ / max(‖u_b‖, 1e-12); one block per image.
template <typename T>
__global__ void pd_change(const T* __restrict__ u, const T* __restrict__ uprev,
                          T* __restrict__ ratio, long long MN) {
  __shared__ T sh[BPL_THREADS];
  const long long base = (long long)blockIdx.x * MN;
  T num = T(0), den = T(0);
  for (long long k = threadIdx.x; k < MN; k += BPL_THREADS) {
    T a = u[base + k];
    T d = a - uprev[base + k];
    num += d * d;
    den += a * a;
  }
  T snum = block_sum(num, sh);
  T sden = block_sum(den, sh);
  if (threadIdx.x == 0) {
    T nd = sqrt(sden);
    ratio[blockIdx.x] = sqrt(snum) / (nd < T(1e-12) ? T(1e-12) : nd);
  }
}

template <typename T>
int pdps_solve(const T* f, T* u, T* y, T* ubar, T* uprev, T* ratio,
               long long O, int M, int N, T alpha, T tau, T sigma,
               double gamma, int accel, int maxiter, int use_tol, T tol,
               int check_every, int* iters_out, cudaStream_t s) {
  const long long n = O * M * N;
  const int grid = blocks_for(n);
  const T alpha2 = alpha * alpha;
  const T two_gamma = T(2.0 * gamma);
  cudaError_t err;

  auto step = [&]() -> cudaError_t {
    T omega = T(1);
    if (accel) omega = T(1) / std::sqrt(T(1) + two_gamma * tau);
    BPL_LAUNCH(pd_primal<T>, grid, BPL_THREADS, s)(f, u, ubar, y, n, M, N,
                                                   tau, omega);
    if (accel) {
      tau = tau * omega;
      sigma = sigma / omega;
    }
    BPL_LAUNCH(pd_dual<T>, grid, BPL_THREADS, s)(ubar, y, n, M, N, sigma,
                                                 alpha, alpha2);
    return cudaGetLastError();
  };

  int it = 0;
  if (!use_tol) {
    for (; it < maxiter; ++it)
      if ((err = step()) != cudaSuccess) return (int)err;
  } else {
    std::vector<T> h((size_t)O);
    T delta = (T)INFINITY;
    const size_t bytes = (size_t)n * sizeof(T);
    while (it < maxiter && delta > tol) {
      err = cudaMemcpyAsync(uprev, u, bytes, cudaMemcpyDeviceToDevice, s);
      if (err != cudaSuccess) return (int)err;
      const int chunk = check_every < maxiter - it ? check_every : maxiter - it;
      for (int k = 0; k < chunk; ++k)
        if ((err = step()) != cudaSuccess) return (int)err;
      BPL_LAUNCH(pd_change<T>, (int)O, BPL_THREADS, s)(u, uprev, ratio,
                                                       (long long)M * N);
      if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
      err = cudaMemcpyAsync(h.data(), ratio, (size_t)O * sizeof(T),
                            cudaMemcpyDeviceToHost, s);
      if (err != cudaSuccess) return (int)err;
      if ((err = cudaStreamSynchronize(s)) != cudaSuccess) return (int)err;
      delta = h[0];   // max over images; NaN propagates (and stops)
      for (long long b = 1; b < O; ++b)
        if (std::isnan(h[b]) || h[b] > delta) delta = h[b];
      it += chunk;
    }
  }
  *iters_out = it;
  return (int)cudaGetLastError();
}

}  // namespace bpl

extern "C" {

int bpl_pdps_solve_f32(const float* f, float* u, float* y, float* ubar,
                       float* uprev, float* ratio, long long O, int M, int N,
                       float alpha, float tau, float sigma, double gamma,
                       int accel, int maxiter, int use_tol, float tol,
                       int check_every, int* iters_out, void* stream) {
  return bpl::pdps_solve<float>(f, u, y, ubar, uprev, ratio, O, M, N, alpha,
                                tau, sigma, gamma, accel, maxiter, use_tol,
                                tol, check_every, iters_out,
                                (cudaStream_t)stream);
}

int bpl_pdps_solve_f64(const double* f, double* u, double* y, double* ubar,
                       double* uprev, double* ratio, long long O, int M,
                       int N, double alpha, double tau, double sigma,
                       double gamma, int accel, int maxiter, int use_tol,
                       double tol, int check_every, int* iters_out,
                       void* stream) {
  return bpl::pdps_solve<double>(f, u, y, ubar, uprev, ratio, O, M, N, alpha,
                                 tau, sigma, gamma, accel, maxiter, use_tol,
                                 tol, check_every, iters_out,
                                 (cudaStream_t)stream);
}

const char* bpl_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
