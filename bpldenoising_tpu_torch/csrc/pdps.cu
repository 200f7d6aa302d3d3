// Kernel A: accelerated Chambolle–Pock (PDPS) denoising with K ≤ 3 dual
// blocks, each with its own stencil and a scalar or (M, N) map weight.
//
// Replaces the TPU kernels bpldenoising_tpu/solvers/pdps_pallas.py::
// _make_kernel (body _pd_body, dispatched by _pallas_impl) and
// ::_make_tiled_kernel.  Per iteration, per pixel:
//   u⁺ = (u − τ(Σₖ Gₖᵀyₖ − f))/(1+τ);  ω = 1/√(1+2γτ), τ ← τω, σ ← σ/ω;
//   ū = (1+ω)u⁺ − ωu;  yₖ = Π_{|·|≤αₖ}(yₖ + σGₖū)  (rsqrt form with `tiny`).
// Each Gₖ is the forward, backward or centred difference gradient masked at
// the image boundary (common.cuh: diff1, adj1); an (M, N) map αₖ is read per
// pixel and broadcast over the batch.  The scalar TV form (K = 1, forward
// differences, scalar α) runs pd_primal and pd_dual; every other form runs
// pd_primal_k and pd_dual_k, whose Σₖ is taken k = 0, 1, 2 in order, as in
// the plain version (solvers/pdps.py::_pdps_step).
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
// the launches (pd_iterate, common.cuh) runs in C, so Python adds nothing
// per iteration.  The early stop runs every `check_every` iterations: a
// per-image reduction of ‖Δu‖² and ‖u‖² (one block per image) and one host
// read of the O ratios, whose max is compared with tol — the per-image
// semantics of solvers/pdps.py, not the Pallas kernel's one norm per VMEM
// chunk.  τ, σ, ω are computed on the host in the working dtype, in the
// order of the plain version.
#include "common.cuh"

namespace bpl {

// The primal step (pd_primal), the per-image change (pd_change) and the
// iteration loop (pd_iterate) are in common.cuh, shared with csrc/vtv.cu.

template <typename T>
__global__ void pd_dual(const T* __restrict__ ubar, T* __restrict__ y,
                        long long n, int M, int N, T sigma, T alpha,
                        T alpha2) {
  long long idx = (long long)blockIdx.x * BPL_THREADS + threadIdx.x;
  if (idx >= n) return;
  Pix p = pix_of(idx, M, N);
  const long long MN = (long long)M * N;
  T gx, gy;
  grad_k(ubar, idx, p, M, N, STENCIL_FWD, gx, gy);
  T* qx = y + p.b * 2 * MN + (idx - p.b * MN);
  T* qy = qx + MN;
  T px = *qx + sigma * gx;
  T py = *qy + sigma * gy;
  T n2 = px * px + py * py;
  T scale = (n2 <= alpha2) ? T(1) : alpha * rsqrt_(n2 + tiny<T>());
  *qx = px * scale;
  *qy = py * scale;
}

// The K dual blocks: stencil kind, scalar weight (and its square) or an
// (M, N) map per block; the duals are packed as K planes of (O, 2, M, N).
template <typename T>
struct Blocks {
  int K;
  int kind[3];
  T alpha[3];
  T alpha2[3];
  const T* amap[3];   // nullptr: the scalar alpha[k]
};

// Σₖ Gₖᵀyₖ in the K-block primal step, k in order.
template <typename T>
__global__ void pd_primal_k(const T* __restrict__ f, T* __restrict__ u,
                            T* __restrict__ ubar, const T* __restrict__ y,
                            long long n, int M, int N, T tau, T omega,
                            Blocks<T> bl) {
  long long idx = (long long)blockIdx.x * BPL_THREADS + threadIdx.x;
  if (idx >= n) return;
  Pix p = pix_of(idx, M, N);
  const long long MN = (long long)M * N;
  const long long in_img = idx - p.b * MN;
  T div = T(0);
  for (int k = 0; k < bl.K; ++k) {
    const T* qx = y + 2 * n * k + p.b * 2 * MN;
    T d = div_k(qx, qx + MN, in_img, p, M, N, bl.kind[k]);
    div = k == 0 ? d : div + d;
  }
  T uo = u[idx];
  T un = (uo - tau * (div - f[idx])) / (T(1) + tau);
  u[idx] = un;
  ubar[idx] = (T(1) + omega) * un - omega * uo;
}

template <typename T>
__global__ void pd_dual_k(const T* __restrict__ ubar, T* __restrict__ y,
                          long long n, int M, int N, T sigma, Blocks<T> bl) {
  long long idx = (long long)blockIdx.x * BPL_THREADS + threadIdx.x;
  if (idx >= n) return;
  Pix p = pix_of(idx, M, N);
  const long long MN = (long long)M * N;
  const long long in_img = idx - p.b * MN;
  for (int k = 0; k < bl.K; ++k) {
    T gx, gy;
    grad_k(ubar, idx, p, M, N, bl.kind[k], gx, gy);
    T* qx = y + 2 * n * k + p.b * 2 * MN + in_img;
    T* qy = qx + MN;
    T alpha = bl.alpha[k], alpha2 = bl.alpha2[k];
    if (bl.amap[k] != nullptr) {
      alpha = bl.amap[k][in_img];
      alpha2 = alpha * alpha;
    }
    T px = *qx + sigma * gx;
    T py = *qy + sigma * gy;
    T n2 = px * px + py * py;
    T scale = (n2 <= alpha2) ? T(1) : alpha * rsqrt_(n2 + tiny<T>());
    *qx = px * scale;
    *qy = py * scale;
  }
}

template <typename T>
int pdps_solve(const T* f, T* u, T* y, T* ubar, T* uprev, T* ratio,
               long long O, int M, int N, int K, const int* kinds,
               const T* alphas, const long long* amaps, T tau, T sigma,
               double gamma, int accel, int maxiter, int use_tol, T tol,
               int check_every, int* iters_out, cudaStream_t s) {
  const long long n = O * M * N;
  const int grid = blocks_for(n);
  if (K < 1 || K > 3) return (int)cudaErrorInvalidValue;
  if (K == 1 && kinds[0] == STENCIL_FWD && amaps[0] == 0) {
    const T alpha = alphas[0];
    const T alpha2 = alpha * alpha;
    auto dual = [&](T sig) {
      BPL_LAUNCH(pd_dual<T>, grid, BPL_THREADS, s)(ubar, y, n, M, N, sig,
                                                   alpha, alpha2);
    };
    return pd_iterate<T>(f, u, y, ubar, uprev, ratio, O, M, N, tau, sigma,
                         gamma, accel, maxiter, use_tol, tol, check_every,
                         iters_out, s, dual);
  }
  Blocks<T> bl;
  bl.K = K;
  for (int k = 0; k < 3; ++k) {
    const bool live = k < K;
    bl.kind[k] = live ? kinds[k] : STENCIL_FWD;
    bl.alpha[k] = live ? alphas[k] : T(0);
    bl.alpha2[k] = bl.alpha[k] * bl.alpha[k];
    bl.amap[k] = live ? (const T*)amaps[k] : nullptr;
  }
  auto primal = [&](T tau_, T omega) {
    BPL_LAUNCH(pd_primal_k<T>, grid, BPL_THREADS, s)(f, u, ubar, y, n, M, N,
                                                     tau_, omega, bl);
  };
  auto dual = [&](T sig) {
    BPL_LAUNCH(pd_dual_k<T>, grid, BPL_THREADS, s)(ubar, y, n, M, N, sig, bl);
  };
  return pd_iterate_with<T>(u, uprev, ratio, O, M, N, tau, sigma, gamma,
                            accel, maxiter, use_tol, tol, check_every,
                            iters_out, s, primal, dual);
}

}  // namespace bpl

extern "C" {

// kinds: K stencil kinds (0 forward, 1 backward, 2 centred); alphas: K
// scalar weights; amaps: K device addresses of (M, N) weight maps, 0 where
// the block's weight is the scalar.  y holds the K duals, (K, O, 2, M, N).
int bpl_pdps_solve_f32(const float* f, float* u, float* y, float* ubar,
                       float* uprev, float* ratio, long long O, int M, int N,
                       int K, const int* kinds, const float* alphas,
                       const long long* amaps, float tau, float sigma,
                       double gamma, int accel, int maxiter, int use_tol,
                       float tol, int check_every, int* iters_out,
                       void* stream) {
  return bpl::pdps_solve<float>(f, u, y, ubar, uprev, ratio, O, M, N, K,
                                kinds, alphas, amaps, tau, sigma, gamma,
                                accel, maxiter, use_tol, tol, check_every,
                                iters_out, (cudaStream_t)stream);
}

int bpl_pdps_solve_f64(const double* f, double* u, double* y, double* ubar,
                       double* uprev, double* ratio, long long O, int M,
                       int N, int K, const int* kinds, const double* alphas,
                       const long long* amaps, double tau, double sigma,
                       double gamma, int accel, int maxiter, int use_tol,
                       double tol, int check_every, int* iters_out,
                       void* stream) {
  return bpl::pdps_solve<double>(f, u, y, ubar, uprev, ratio, O, M, N, K,
                                 kinds, alphas, amaps, tau, sigma, gamma,
                                 accel, maxiter, use_tol, tol, check_every,
                                 iters_out, (cudaStream_t)stream);
}

const char* bpl_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
