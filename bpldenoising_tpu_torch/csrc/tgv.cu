// Kernel: TGV² joint-primal Chambolle–Pock denoising, scalar or (M, N) map
// weights (α₁, α₀), warm start, batch-global early stop.
//
// Replaces both TPU kernels of bpldenoising_tpu/solvers/tgv_pallas.py:
// _make_kernel (:103, whole images resident in VMEM) and _make_tiled_kernel
// (:217, halo'd row tiles for images whose 9 planes exceed VMEM).  The TPU
// needs the second kernel only because VMEM runs out; here the state lives
// in device memory at any size, so one kernel computes the function of
// both.  Per iteration, per pixel (solvers/tgv.py::_step):
//   u⁺ = (u − τ∇ᵀp + τf)/(1+τ);   w⁺ = w + τ(p − Eᵀq)
//   ū = 2u⁺ − u;  w̄ = 2w⁺ − w
//   p = Π_{|·|≤α₁}(p + σ(∇ū − w̄));   q = Π_{|·|≤α₀}(q + σEw̄)
// with τ = σ = 0.99/√12 and no acceleration.  ∇ takes forward differences
// (zero at the last row / column), E backward differences (zero at the
// first), E's off-diagonal weighted by 1/√2 and stored once; q's planes
// are (rr, cc, rc).  The projection is the plain version's form
// (n = √Σ, scale = n ≤ α ? 1 : α/max(n, tiny)), not the TPU kernel's rsqrt.
//
// Layout: u is (O, M, N); w and p are (O, 2, M, N); q is (O, 3, M, N), as
// the plain version stacks them, so a warm start needs no re-layout.  Map
// weights are one (M, N) plane each, shared by the batch.
//
// Design: the 8 state planes plus f of a 128² f32 image take 576 KB, more
// than a block's 227 KB of shared memory, so the state stays in global
// memory (10×128² f32: ~6 MB, inside the 50 MB L2).  One thread per pixel,
// two launches per iteration: the primal launch writes u, w and the ū, w̄
// scratch planes; the dual launch reads ū, w̄ at neighbouring pixels.  The
// iteration loop runs here in C, so Python costs nothing per iteration.
// The early stop follows solvers/tgv.py: every `check_every` iterations the
// batch-global rel = ‖u − u_prev‖ / max(‖u_prev‖, 1) is formed from two sums
// taken as fixed-order per-block partials and a one-block second pass (no
// atomics, so repeated runs agree bit for bit), and the host reads the two
// sums once per check.
//
// Bound: the arithmetic below is 70 operations per pixel-iteration (29 in
// the primal launch, 41 in the dual; the JAX cost estimate at
// tgv_pallas.py:487 counts ~110 for the roll+mask form), so 5000
// iterations at 10×128² are ~5.7e10 operations, ~0.86 ms at 67 TFLOP/s
// f32; the bytes a solve must move are f and the state in and the state
// out once (1 + 8 + 8 planes).
#include "tgv.cuh"

namespace bpl {

// Per-block partial sums of (u − u_prev)² and u_prev².
template <typename T>
__global__ void tgv_change(const T* __restrict__ u,
                           const T* __restrict__ uprev,
                           T* __restrict__ partials, long long n,
                           int nblocks) {
  __shared__ T sh[BPL_THREADS];
  long long idx = (long long)blockIdx.x * BPL_THREADS + threadIdx.x;
  T d2 = T(0), p2 = T(0);
  if (idx < n) {
    T a = uprev[idx];
    T d = u[idx] - a;
    d2 = d * d;
    p2 = a * a;
  }
  T sd = block_sum(d2, sh);
  T sp = block_sum(p2, sh);
  if (threadIdx.x == 0) {
    partials[blockIdx.x] = sd;
    partials[nblocks + blockIdx.x] = sp;
  }
}

template <typename T>
int tgv_solve(TGV<T> s, T* uprev, T* partials, T* scal, int maxiter,
              int use_tol, T tol, int check_every, int* iters_out,
              cudaStream_t st) {
  const int grid = blocks_for(s.n);
  cudaError_t err;
  auto step = [&]() -> cudaError_t {
    BPL_LAUNCH(tgv_primal<T>, grid, BPL_THREADS, st)(s);
    BPL_LAUNCH(tgv_dual<T>, grid, BPL_THREADS, st)(s);
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
      BPL_LAUNCH(tgv_change<T>, grid, BPL_THREADS, st)(s.u, uprev, partials,
                                                      s.n, grid);
      BPL_LAUNCH(sum_partials<T>, 2, BPL_THREADS, st)(partials, grid, scal,
                                                      0, 1, 2);
      if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
      err = cudaMemcpyAsync(h, scal, 2 * sizeof(T), cudaMemcpyDeviceToHost,
                            st);
      if (err != cudaSuccess) return (int)err;
      if ((err = cudaStreamSynchronize(st)) != cudaSuccess) return (int)err;
      T ref = std::sqrt(h[1]);
      rel = std::sqrt(h[0]) / (ref > T(1) ? ref : T(1));
      it += chunk;
    }
  }
  *iters_out = it;
  return (int)cudaGetLastError();
}

template <typename T>
int tgv_entry(const T* f, T* u, T* w, T* p, T* q, T* ubar, T* wbar,
              T* uprev, T* partials, T* scal, const T* a1map,
              const T* a0map, T a1, T a0, long long O, int M, int N, T tau,
              T sigma, int maxiter, int use_tol, T tol, int check_every,
              int* iters_out, void* stream) {
  TGV<T> s;
  s.f = f;
  s.u = u;
  s.w = w;
  s.p = p;
  s.q = q;
  s.ubar = ubar;
  s.wbar = wbar;
  s.a1map = a1map;
  s.a0map = a0map;
  s.a1 = a1;
  s.a0 = a0;
  s.tau = tau;
  s.sigma = sigma;
  s.n = O * M * N;
  s.M = M;
  s.N = N;
  return tgv_solve<T>(s, uprev, partials, scal, maxiter, use_tol, tol,
                      check_every, iters_out, (cudaStream_t)stream);
}

}  // namespace bpl

extern "C" {

int bpl_tgv_solve_f32(const float* f, float* u, float* w, float* p,
                      float* q, float* ubar, float* wbar, float* uprev,
                      float* partials, float* scal, const float* a1map,
                      const float* a0map, float a1, float a0, long long O,
                      int M, int N, float tau, float sigma, int maxiter,
                      int use_tol, float tol, int check_every,
                      int* iters_out, void* stream) {
  return bpl::tgv_entry<float>(f, u, w, p, q, ubar, wbar, uprev, partials,
                               scal, a1map, a0map, a1, a0, O, M, N, tau,
                               sigma, maxiter, use_tol, tol, check_every,
                               iters_out, stream);
}

int bpl_tgv_solve_f64(const double* f, double* u, double* w, double* p,
                      double* q, double* ubar, double* wbar, double* uprev,
                      double* partials, double* scal, const double* a1map,
                      const double* a0map, double a1, double a0,
                      long long O, int M, int N, double tau, double sigma,
                      int maxiter, int use_tol, double tol, int check_every,
                      int* iters_out, void* stream) {
  return bpl::tgv_entry<double>(f, u, w, p, q, ubar, wbar, uprev, partials,
                                scal, a1map, a0map, a1, a0, O, M, N, tau,
                                sigma, maxiter, use_tol, tol, check_every,
                                iters_out, stream);
}

}  // extern "C"
