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

template <typename T>
int pdps_solve(const T* f, T* u, T* y, T* ubar, T* uprev, T* ratio,
               long long O, int M, int N, T alpha, T tau, T sigma,
               double gamma, int accel, int maxiter, int use_tol, T tol,
               int check_every, int* iters_out, cudaStream_t s) {
  const long long n = O * M * N;
  const int grid = blocks_for(n);
  const T alpha2 = alpha * alpha;
  auto dual = [&](T sig) {
    BPL_LAUNCH(pd_dual<T>, grid, BPL_THREADS, s)(ubar, y, n, M, N, sig,
                                                 alpha, alpha2);
  };
  return pd_iterate<T>(f, u, y, ubar, uprev, ratio, O, M, N, tau, sigma,
                       gamma, accel, maxiter, use_tol, tol, check_every,
                       iters_out, s, dual);
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
