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
// the two-launch form's primal step is kernel A's pd_primal over O·C
// "images".  A map weight
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
// array (the cluster kernel built for C = 3 keeps the 2C values in
// registers instead: the same bits).
//
// What bounds it on an H100: the state (u, f, ū, y: 5 planes per channel,
// 5.9 MB at 6×3×128² f32) exceeds a block's 227 KB of shared memory, and
// an iteration is a few microseconds of device work at 128², so the first
// design (state in global memory, one thread a pixel, two launches an
// iteration from a C loop, the dual step reading ū at neighbouring pixels)
// was paced by launch issue and sent the state through L2 every
// half-step.  This design:
//
//  * The cluster form (vtv_cp): the band scheme of csrc/vtv_cluster.cuh,
//    which row 13's slv_pd also runs: one thread-block cluster an image,
//    each CTA a band of rows of the 4C planes (u, ū and the two dual
//    components per channel) in shared memory (96 KB a CTA at 3×128² f32
//    with 16 CTAs, two CTAs an SM; 192 KB in f64), one cluster barrier an
//    iteration, the C channels of a pixel in one thread; one launch per
//    early-stop chunk (all of maxiter without tol), the state read from
//    global memory once a launch and written back once, no ū plane in
//    global memory.  τ, ω, σ are formed on the host in the plain version's
//    order (common.cuh's cp_table, as pd_iterate_with forms them) and read
//    per iteration from a device table (one copy a call), as kernel A's
//    cluster form reads them.  The kernel is built for C = 3 (the color
//    case: the channel loops unroll, a pixel's 2C dual values stay in
//    registers) and for any C, each with a scalar or a map α.  The host
//    (solvers/cluster_plan.py::vtv_plan, row 13's rule) picks the CTAs an
//    image and the rows a CTA.  Where the bands do not fit in shared
//    memory (1×3×256²: 288 KB a band), the global-scratch form of
//    vtv_cluster_run would run a large image on 16 CTAs of a 132-SM card,
//    so that shape takes
//  * the two-launch form (vtv_solve): the state in global memory, one
//    thread a pixel, pd_primal over the O·C planes then vtv_dual (vtv.cuh)
//    per iteration, from common.cuh's pd_iterate.
// Both run the same operations in the same order under -fmad=false, so
// they agree bit for bit.  The form is a rule of the shapes decided before
// any launch; a cluster launch or an occupancy check that the card
// refuses returns its error, and nothing is retried in the other form.
//
// Early stop (the jnp semantics of solvers/pdps.py, JAX
// solvers/pdps.py:118-131): every `check_every` iterations, the max over
// the O·C planes of ‖Δu‖/max(‖u‖, 1e-12), u the new iterate (kernel A's
// pd_change with O·C blocks); one host read of the O·C ratios per check.
// The Pallas kernel takes one √(ΣΔu²/max(Σu², 1e-24)) over each VMEM chunk
// of images instead: a difference inside the reference, decided for the
// jnp semantics.  The cluster form's host loop is common.cuh's cp_iterate
// with that rule (CpPlaneStop), through pd_cluster.cuh's
// cp_cluster_accel, as kernel A's: u ping-pongs between two buffers, so a
// chunk is 3 device operations (the launch, pd_change, the read), plus the
// table copy and a last copy when u ends in the second buffer.  The
// two-launch form issues 2 an iteration and 3 a chunk (a copy of u,
// pd_change, the read).
//
// Bound (chip_smoke.py counts the same): per plane-pixel and iteration the
// function needs 10 operations in the primal step (3 divergence, 4 update,
// 3 extrapolation; 1+τ and 1+ω are scalars of the iteration) and 13 in the
// dual (per plane 2 differences, 2 σ-products, 2 sums, 2 squares and
// 2 scalings; per pixel 5 adds of the 2C = 6 squares, √, compare, max and
// divide, shared by C = 3 planes): 23.  The kernel's extra work (the
// halo rows, the second pass over the channels at any C) is not counted.
#include "vtv.cuh"
#include "vtv_cluster.cuh"

namespace bpl {

// ------------------------------------------------ the two-launch form

template <typename T>
int vtv_solve(const T* f, T* u, T* y, T* ubar, T* uprev, T* ratio,
              const T* amap, T a, long long O, int C, int M, int N, T tau,
              T sigma, double gamma, int accel, int maxiter, int use_tol,
              T tol, int check_every, int* iters_out, int* ops,
              cudaStream_t st) {
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
                       iters_out, ops, st, dual);
}

// ---------------------------------------------------- the cluster form

// The state of a cluster launch: f, y, α, the per-iteration table and the
// plan (cl CTAs an image, rows each).
template <typename T>
struct VTVC {
  const T* f;     // (O, C, M, N)
  T* y;           // (O, C, 2, M, N)
  const T* amap;  // (M, N) or null: then a
  const T* tab;   // per iteration t: τ, ω, σ (cp_table)
  T a;
  long long mn, ncg;   // M·N, an image's C·M·N
  int M, N, C, cl, rows;
};

// The CP solve's step for vtv_cluster_run: accelerated, τ, ω, σ of
// iteration it0 + it from the table; u read from uin and written to uout.
// MAP: α is the map read at the pixel through the caches, as vtv_dual
// reads it, else the scalar.
template <typename T, bool MAP>
struct VtvStep {
  static constexpr bool ACCEL = true;
  const VTVC<T>& h;
  const T* uin;
  T* uout;
  int it0;
  int M, N, C, cl, rows;
  long long region;   // the bands live in shared memory: unused
  T* pd;
  T tau, sigma;       // unused: at() gives each iteration's
  __device__ VtvStep(const VTVC<T>& h_, const T* uin_, T* uout_, int it0_)
      : h(h_), uin(uin_), uout(uout_), it0(it0_), M(h_.M), N(h_.N),
        C(h_.C), cl(h_.cl), rows(h_.rows), region(0), pd(nullptr),
        tau(T(0)), sigma(T(0)) {}
  __device__ const T* u(long long b) const { return uin + b * h.ncg; }
  __device__ T* u_out(long long b) const { return uout + b * h.ncg; }
  __device__ T* y(long long b) const { return h.y + b * 2 * h.ncg; }
  __device__ const T* f(long long b) const { return h.f + b * h.ncg; }
  __device__ long long mn() const { return h.mn; }
  __device__ void at(int it, T& tau_, T& omega_, T& sigma_) const {
    const T* t = h.tab + 3LL * (it0 + it);
    tau_ = t[0];
    omega_ = t[1];
    sigma_ = t[2];
  }
  __device__ T alpha(int i, int j) const {
    return MAP ? h.amap[i * N + j] : h.a;
  }
};

// n_it iterations from iteration it0 for the whole batch, one cluster an
// image; u from uin to uout (they may be one buffer), y in place.  CC: the
// channels, 3 or any (0), as row 13's slv_pd.  Two CTAs an SM in float32
// (96 KB bands at 16 CTAs an image, C = 3); in float64 one (192 KB), so
// the register bound is 128.
template <typename T, int CC, bool MAP>
__global__ void __launch_bounds__(PD_THREADS, sizeof(T) == 4 ? PD_MINB : 1)
vtv_cp(VTVC<T> h, const T* uin, T* uout, int it0, int n_it) {
  extern __shared__ __align__(16) unsigned char vtv_smem[];
  VtvStep<T, MAP> step(h, uin, uout, it0);
  vtv_cluster_run<T, true, CC>(step, vtv_smem, n_it);
}

// One vtv_cp launch per chunk, after the plan's check against the card.
template <typename T, int CC, bool MAP>
int vtv_cluster(const VTVC<T>& h, T* u, T* uprev, T* ratio, T* tab,
                long long O, T tau, T sigma, double gamma, int accel,
                int maxiter, int use_tol, T tol, int check_every,
                int* iters_out, int* ops, cudaStream_t st) {
  PdClusterLaunch<void (*)(VTVC<T>, const T*, T*, int, int)> L;
  const size_t smem = (size_t)vtv_region(h.C, h.rows, h.N) * sizeof(T);
  int err = pd_cluster_prepare(L, vtv_cp<T, CC, MAP>, O, h.cl, smem, st);
  if (err != (int)cudaSuccess) return err;
  return cp_cluster_accel(L, h, u, uprev, ratio, tab, O * h.C, h.mn, tau,
                          sigma, gamma, accel, maxiter, use_tol, tol,
                          check_every, iters_out, ops, st);
}

template <typename T>
int vtv_entry(const T* f, T* u, T* y, T* ubar, T* uprev, T* ratio, T* tab,
              const T* amap, T a, long long O, int C, int M, int N, int cl,
              int rows, int resident, T tau, T sigma, double gamma,
              int accel, int maxiter, int use_tol, T tol, int check_every,
              int* iters_out, int* ops, void* stream) {
  *iters_out = 0;
  *ops = 0;
  if (O < 1 || C < 1 || M < 1 || N < 1 || maxiter < 0
      || (use_tol && check_every < 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (!resident)
    return vtv_solve<T>(f, u, y, ubar, uprev, ratio, amap, a, O, C, M, N,
                        tau, sigma, gamma, accel, maxiter, use_tol, tol,
                        check_every, iters_out, ops, st);
  if (!vtv_plan_ok(M, N, C, cl, rows)) return (int)cudaErrorInvalidValue;
  VTVC<T> h;
  h.f = f;
  h.y = y;
  h.amap = amap;
  h.tab = tab;
  h.a = a;
  h.mn = (long long)M * N;
  h.ncg = C * h.mn;
  h.M = M;
  h.N = N;
  h.C = C;
  h.cl = cl;
  h.rows = rows;
#define VTV_RUN(CC, MAP)                                                   \
  vtv_cluster<T, CC, MAP>(h, u, uprev, ratio, tab, O, tau, sigma, gamma,   \
                          accel, maxiter, use_tol, tol, check_every,       \
                          iters_out, ops, st)
  if (C == 3) return amap ? VTV_RUN(3, true) : VTV_RUN(3, false);
  return amap ? VTV_RUN(0, true) : VTV_RUN(0, false);
#undef VTV_RUN
}

}  // namespace bpl

extern "C" {

// The plan (solvers/cluster_plan.py::vtv_plan): cl CTAs an image, rows
// each; resident 0 runs the two-launch form (ubar a plane of f's size, tab
// unused), else the cluster form (ubar unused, tab 3·maxiter elements).
// uprev is u's second buffer (used with tol); ratio holds O·C elements.
// *iters_out: the iterations run; *ops_out: the device operations issued.
int bpl_vtv_solve_f32(const float* f, float* u, float* y, float* ubar,
                      float* uprev, float* ratio, float* tab,
                      const float* amap, float a, long long O, int C, int M,
                      int N, int cl, int rows, int resident, float tau,
                      float sigma, double gamma, int accel, int maxiter,
                      int use_tol, float tol, int check_every,
                      int* iters_out, int* ops_out, void* stream) {
  return bpl::vtv_entry<float>(f, u, y, ubar, uprev, ratio, tab, amap, a, O,
                               C, M, N, cl, rows, resident, tau, sigma,
                               gamma, accel, maxiter, use_tol, tol,
                               check_every, iters_out, ops_out, stream);
}

int bpl_vtv_solve_f64(const double* f, double* u, double* y, double* ubar,
                      double* uprev, double* ratio, double* tab,
                      const double* amap, double a, long long O, int C,
                      int M, int N, int cl, int rows, int resident,
                      double tau, double sigma, double gamma, int accel,
                      int maxiter, int use_tol, double tol, int check_every,
                      int* iters_out, int* ops_out, void* stream) {
  return bpl::vtv_entry<double>(f, u, y, ubar, uprev, ratio, tab, amap, a,
                                O, C, M, N, cl, rows, resident, tau, sigma,
                                gamma, accel, maxiter, use_tol, tol,
                                check_every, iters_out, ops_out, stream);
}

}  // extern "C"
