// Kernel: TV-L1 Chambolle–Pock denoising, plain or Huber-smoothed, scalar
// or (M, N) map weight α, warm start, batch-global early stop.
//
// Replaces two TPU kernels:
//   bpldenoising_tpu/solvers/tvl1_pallas.py::_make_tvl1_kernel (:62), the
//     plain TV-L1 CP (TVL1Denoise), and
//   bpldenoising_tpu/solvers/tvl1_huber_pallas.py::_make_huber_kernel
//     (:72), the Huber-smoothed CP (every evaluation of the TV-L1 learn).
// The two differ only in the primal prox and one dual scaling, so one
// source, templated on the form, serves both.  Per iteration, per pixel
// (solvers/tvl1.py, solvers/tvl1_huber.py):
//   z  = (u − τ∇ᵀy) − f
//   u⁺ = f + shrink(z, τ)                  shrink(z, τ) = sign(z)·max(|z| − τ, 0)
//   u⁺ = f + (|z| ≤ lo ? z/den : z − τ·sign(z))     (Huber: lo = 1/γ_d + τ,
//                                                     den = 1 + τγ_d)
//   ū  = 2u⁺ − u
//   y⁺ = Π_{|·|≤α}(y + σ∇ū)                (plain)
//   y⁺ = Π_{|·|≤α}(s·(y + σ∇ū)),  s = 1/(1 + σ/(max(α, 1e-12)·γ_r))  (Huber)
// with τ = σ = 0.99/√8 and no acceleration.  The plain form computes the
// shrink itself, not the Huber form's γ → ∞ limit, so each form rounds
// like its plain version.  ∇ takes forward differences (zero at the last
// row / column).  The projection is the plain version's form
// (ball_scale), not the TPU kernels' α·rsqrt(n² + tiny).
//
// Layout: u and f are (O, M, N); y is (O, 2, M, N), the plain version's
// stacked dual, so a warm start needs no re-layout.  A map weight is one
// (M, N) plane shared by the batch; s is formed per pixel from it, so a
// constant map reproduces the scalar run bit for bit.
//
// Design: as csrc/tgv.cu.  The state (u, y, f and the ū scratch: 5 planes,
// 320 KB for a 128² f32 image) exceeds a block's 227 KB of shared memory,
// so it stays in global memory, where it is L2-resident at these sizes
// (64×128² f32: ~21 MB).  One thread per pixel, two launches per
// iteration: the primal launch writes u and ū; the dual launch reads ū at
// neighbouring pixels.  The iteration loop runs here in C.
//
// Early stop (the jnp semantics of solvers/tvl1.py and
// solvers/tvl1_huber.py:134-154): every `check_every` iterations the
// batch-global rel = √(Σ(u − u_prev)² / max(Σu², 1e-24)), u the NEW
// iterate; stop once rel ≤ tol.  The two sums are fixed-order per-block
// partials and a one-block second pass (no atomics, repeated runs agree
// bit for bit); the host reads them once per check.
//
// Bound: the arithmetic below is 29 operations per pixel-iteration in the
// plain form (14 primal + 15 dual) and 36 in the Huber form (14 + 22); the
// JAX cost estimates count 40 and 44 (tvl1_pallas.py:205,
// tvl1_huber_pallas.py:205).  A solve must move f and the state in and the
// state out once (1 + 3 + 3 planes).  At 1×128² and 2000 iterations that
// is ~0.02 ms of f32 operations: the kernel is bound by its 4000
// launches, not by the card.
#include "tvl1.cuh"

namespace bpl {

// Per-block partial sums of (u − u_prev)² and u² (u the new iterate).
template <typename T>
__global__ void tvl1_change(const T* __restrict__ u,
                            const T* __restrict__ uprev,
                            T* __restrict__ partials, long long n,
                            int nblocks) {
  __shared__ T sh[BPL_THREADS];
  long long idx = (long long)blockIdx.x * BPL_THREADS + threadIdx.x;
  T d2 = T(0), u2 = T(0);
  if (idx < n) {
    T a = u[idx];
    T d = a - uprev[idx];
    d2 = d * d;
    u2 = a * a;
  }
  T sd = block_sum(d2, sh);
  T su = block_sum(u2, sh);
  if (threadIdx.x == 0) {
    partials[blockIdx.x] = sd;
    partials[nblocks + blockIdx.x] = su;
  }
}

template <typename T, bool HUBER>
int tvl1_solve(TVL1<T> s, T* uprev, T* partials, T* scal, int maxiter,
               int use_tol, T tol, int check_every, int* iters_out,
               cudaStream_t st) {
  const int grid = blocks_for(s.n);
  cudaError_t err;
  auto step = [&]() -> cudaError_t {
    tvl1_primal<T, HUBER><<<grid, BPL_THREADS, 0, st>>>(s);
    tvl1_dual<T, HUBER><<<grid, BPL_THREADS, 0, st>>>(s);
    return cudaGetLastError();
  };

  int it = 0;
  if (!use_tol) {
    for (; it < maxiter; ++it)
      if ((err = step()) != cudaSuccess) return (int)err;
  } else {
    T h[2];
    T rel = (T)INFINITY;
    const size_t bytes = (size_t)s.n * sizeof(T);
    while (it < maxiter && rel > tol) {   // NaN stops, as in the plain loop
      err = cudaMemcpyAsync(uprev, s.u, bytes, cudaMemcpyDeviceToDevice, st);
      if (err != cudaSuccess) return (int)err;
      const int chunk = check_every < maxiter - it ? check_every : maxiter - it;
      for (int k = 0; k < chunk; ++k)
        if ((err = step()) != cudaSuccess) return (int)err;
      BPL_LAUNCH(tvl1_change<T>, grid, BPL_THREADS, st)(s.u, uprev, partials,
                                                       s.n, grid);
      BPL_LAUNCH(sum_partials<T>, 2, BPL_THREADS, st)(partials, grid, scal,
                                                      0, 1, 2);
      if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
      err = cudaMemcpyAsync(h, scal, 2 * sizeof(T), cudaMemcpyDeviceToHost,
                            st);
      if (err != cudaSuccess) return (int)err;
      if ((err = cudaStreamSynchronize(st)) != cudaSuccess) return (int)err;
      T den = h[1] > T(1e-24) ? h[1] : T(1e-24);
      rel = std::sqrt(h[0] / den);
      it += chunk;
    }
  }
  *iters_out = it;
  return (int)cudaGetLastError();
}

template <typename T>
int tvl1_entry(const T* f, T* u, T* y, T* ubar, T* uprev, T* partials,
               T* scal, const T* amap, T a, long long O, int M, int N, T tau,
               T sigma, int huber, T lo, T den, T gr, int maxiter,
               int use_tol, T tol, int check_every, int* iters_out,
               void* stream) {
  TVL1<T> s;
  s.f = f;
  s.u = u;
  s.y = y;
  s.ubar = ubar;
  s.amap = amap;
  s.a = a;
  s.tau = tau;
  s.sigma = sigma;
  s.lo = lo;
  s.den = den;
  s.gr = gr;
  s.n = O * M * N;
  s.M = M;
  s.N = N;
  cudaStream_t st = (cudaStream_t)stream;
  if (huber)
    return tvl1_solve<T, true>(s, uprev, partials, scal, maxiter, use_tol,
                               tol, check_every, iters_out, st);
  return tvl1_solve<T, false>(s, uprev, partials, scal, maxiter, use_tol,
                              tol, check_every, iters_out, st);
}

}  // namespace bpl

extern "C" {

int bpl_tvl1_solve_f32(const float* f, float* u, float* y, float* ubar,
                       float* uprev, float* partials, float* scal,
                       const float* amap, float a, long long O, int M, int N,
                       float tau, float sigma, int huber, float lo,
                       float den, float gr, int maxiter, int use_tol,
                       float tol, int check_every, int* iters_out,
                       void* stream) {
  return bpl::tvl1_entry<float>(f, u, y, ubar, uprev, partials, scal, amap,
                                a, O, M, N, tau, sigma, huber, lo, den, gr,
                                maxiter, use_tol, tol, check_every,
                                iters_out, stream);
}

int bpl_tvl1_solve_f64(const double* f, double* u, double* y, double* ubar,
                       double* uprev, double* partials, double* scal,
                       const double* amap, double a, long long O, int M,
                       int N, double tau, double sigma, int huber, double lo,
                       double den, double gr, int maxiter, int use_tol,
                       double tol, int check_every, int* iters_out,
                       void* stream) {
  return bpl::tvl1_entry<double>(f, u, y, ubar, uprev, partials, scal, amap,
                                 a, O, M, N, tau, sigma, huber, lo, den, gr,
                                 maxiter, use_tol, tol, check_every,
                                 iters_out, stream);
}

}  // extern "C"
