// Kernel: accelerated Chambolle–Pock (PDPS) vectorial-TV (color) denoising,
// scalar or (M, N) map weight α, warm start, per-plane early stop.
//
// Replaces the TPU kernel bpldenoising_tpu/solvers/vtv_pallas.py::
// _make_vtv_kernel (:70, body _vtv_body :40), which every evaluation of the
// VTV learn (bilevel/fused_vtv.py) and VTVDenoise run.  Per iteration, on
// (O, C, M, N) stacks (solvers/pdps.py on models.vtv_model()):
//   u⁺ = (u − τ(∇ᵀy − f))/(1+τ);  ω = 1/√(1+2γτ), τ ← τω, σ ← σ/ω;
//   ū = (1+ω)u⁺ − ωu;  q = y + σ∇ū;
//   y⁺ = q · Π-scale,  n² = Σ_c (q_x,c² + q_y,c²)  (one scale per pixel,
//                                                   shared by all 2C parts)
// ∇ takes forward differences per channel plane, zero at the last row /
// column.  The projection is the plain version's form (ball_scale:
// 1 if n ≤ α, else α/max(n, tiny) with n = √n²), not the TPU kernel's
// α·rsqrt(n² + tiny).
//
// Layout: u, f, ū are (O, C, M, N) and y is (O, C, 2, M, N), the plain
// version's stacked dual; seen as O·C planes with a (2, M, N) dual each,
// the primal step is kernel A's pd_primal over O·C "images".  A map weight
// is one (M, N) plane shared by every image and channel; the scale is
// formed per pixel from it, so a constant map reproduces the scalar run
// bit for bit.
//
// The coupling: one thread per (o, i, j) pixel loops over the C channels,
// so no reduction crosses threads.  It sums n² in the order of the plain
// version's torch.sum(q*q, dim=(-4, -3)) on the card: the 2C squares
// (channel-major, x before y) are reduced by one thread of PyTorch's
// reduction kernel into four accumulators, element k into k mod 4, which
// are then combined as ((a0 + a1) + a2) + a3.  A first pass over the
// channels forms n²; a second forms q again (the same operations, the same
// values) and stores the scaled dual, so any C works without a per-thread
// array.
//
// Design: as csrc/pdps.cu.  The state (u, f, ū, y: 5 planes per channel,
// 5.9 MB at 6×3×128² f32) exceeds a block's 227 KB of shared memory, so it
// stays in global memory, L2-resident at these sizes.  Two launches per
// iteration (the dual step reads ū at neighbouring pixels); the iteration
// loop is kernel A's pd_iterate (common.cuh), in C, with vtv_dual as its
// dual step.
//
// Early stop (the jnp semantics of solvers/pdps.py, JAX
// solvers/pdps.py:118-131): every `check_every` iterations, the max over
// the O·C planes of ‖Δu‖/max(‖u‖, 1e-12), u the new iterate (kernel A's
// pd_change with O·C blocks); one host read of the O·C ratios per check.
// The Pallas kernel takes one √(ΣΔu²/max(Σu², 1e-24)) over each VMEM chunk
// of images instead: a difference inside the reference, decided for the
// jnp semantics.
//
// Bound (chip_smoke.py counts the same): per plane-pixel and iteration the
// function needs 10 operations in the primal step (3 divergence, 4 update,
// 3 extrapolation; 1+τ and 1+ω are scalars of the iteration) and 13 in the
// dual (per plane 2 differences, 2 σ-products, 2 sums, 2 squares and
// 2 scalings; per pixel 5 adds of the 2C = 6 squares, √, compare, max and
// divide, shared by C = 3 planes): 23.  The kernel's extra work (the
// second pass over the channels, four accumulators) is not counted.
#include "vtv.cuh"

namespace bpl {

template <typename T>
int vtv_solve(const T* f, T* u, T* y, T* ubar, T* uprev, T* ratio,
              const T* amap, T a, long long O, int C, int M, int N, T tau,
              T sigma, double gamma, int accel, int maxiter, int use_tol,
              T tol, int check_every, int* iters_out, cudaStream_t st) {
  VTV<T> s;
  s.ubar = ubar;
  s.y = y;
  s.amap = amap;
  s.a = a;
  s.n = O * M * N;
  s.C = C;
  s.M = M;
  s.N = N;
  const int grid = blocks_for(s.n);
  auto dual = [&](T sig) {
    BPL_LAUNCH(vtv_dual<T>, grid, BPL_THREADS, st)(s, sig);
  };
  return pd_iterate<T>(f, u, y, ubar, uprev, ratio, O * C, M, N, tau, sigma,
                       gamma, accel, maxiter, use_tol, tol, check_every,
                       iters_out, st, dual);
}

}  // namespace bpl

extern "C" {

int bpl_vtv_solve_f32(const float* f, float* u, float* y, float* ubar,
                      float* uprev, float* ratio, const float* amap, float a,
                      long long O, int C, int M, int N, float tau,
                      float sigma, double gamma, int accel, int maxiter,
                      int use_tol, float tol, int check_every,
                      int* iters_out, void* stream) {
  return bpl::vtv_solve<float>(f, u, y, ubar, uprev, ratio, amap, a, O, C, M,
                               N, tau, sigma, gamma, accel, maxiter, use_tol,
                               tol, check_every, iters_out,
                               (cudaStream_t)stream);
}

int bpl_vtv_solve_f64(const double* f, double* u, double* y, double* ubar,
                      double* uprev, double* ratio, const double* amap,
                      double a, long long O, int C, int M, int N, double tau,
                      double sigma, double gamma, int accel, int maxiter,
                      int use_tol, double tol, int check_every,
                      int* iters_out, void* stream) {
  return bpl::vtv_solve<double>(f, u, y, ubar, uprev, ratio, amap, a, O, C,
                                M, N, tau, sigma, gamma, accel, maxiter,
                                use_tol, tol, check_every, iters_out,
                                (cudaStream_t)stream);
}

}  // extern "C"
