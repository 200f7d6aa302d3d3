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
// Two forms, chosen by the host's plan (solvers/tvl1_cuda.py::tvl1_plan,
// solvers/cluster_plan.py::pd_plan with K = 1) from the shapes before any
// launch:
// - the cluster form (tvl1_cp): the band scheme of csrc/pd_cluster.cuh,
//   one thread-block cluster an image, each CTA a band of rows of u, ū and
//   y in shared memory (32 KB a CTA for 128² f32 at 16 CTAs), one launch
//   per early-stop chunk (all of maxiter without tol), no ū plane in
//   global memory;
// - the two-launch form, where the bands do not fit in shared memory: the
//   state in global memory, one thread a pixel, tvl1_primal and tvl1_dual
//   (tvl1.cuh) per iteration from a C loop.
// Both run tvl1.cuh's arithmetic (tvl1_prox, huber_dual_factor, ball_scale,
// common.cuh's diff1 / adj1) in the same order under -fmad=false, so they
// agree bit for bit.
//
// Early stop (the jnp semantics of solvers/tvl1.py and
// solvers/tvl1_huber.py:134-154): every `check_every` iterations the
// batch-global rel = √(Σ(u − u_prev)² / max(Σu², 1e-24)), u the NEW
// iterate; stop once rel ≤ tol.  The host loop is common.cuh's cp_iterate,
// which the TGV² kernel also runs: the two sums are fixed-order per-block
// partials (cp_change) and a one-block second pass (no atomics, repeated
// runs agree bit for bit); the host reads them once per check.  Both forms
// ping-pong u between two buffers: a chunk is 4 device operations in the
// cluster form (the launch, the two passes, the read), 2·chunk + 4 in the
// two-launch form (the chunk starts with a copy into the other buffer),
// and a call ending in the second buffer copies back once.
//
// Bound: the arithmetic below is 29 operations per pixel-iteration in the
// plain form (14 primal + 15 dual) and 36 in the Huber form (14 + 22); the
// JAX cost estimates count 40 and 44 (tvl1_pallas.py:205,
// tvl1_huber_pallas.py:205).  A solve must move f and the state in and the
// state out once (1 + 3 + 3 planes).  At 1×128² and 2000 iterations that
// is ~0.02 ms of f32 operations.
#include "pd_cluster.cuh"
#include "tvl1.cuh"

namespace bpl {

// ---------------------------------------------------- the cluster form

// The state of a cluster launch: f, the dual (O, 2, M, N), the weight, the
// step's scalars and the plan (cl CTAs an image, rows each).
template <typename T>
struct TVL1C {
  const T* f;
  T* y;
  const T* amap;   // (M, N) or null: then a
  T a, tau, sigma, lo, den, gr;
  long long mn;
  int M, N, cl, rows;
};

// The TV-L1 step for pd_cluster_run (csrc/pd_cluster.cuh), K = 1 forward:
// constant τ and σ; u⁺ = tvl1_prox(Gᵀy, u, f), ū = 2u⁺ − u, as
// tvl1_primal; the Huber form's factor s on p = y + σGū (pd_pre below),
// then y⁺ = p·ball_scale(|p|², α), as tvl1_dual.  MAP: α is the map's pixel
// (s formed per pixel, as tvl1_dual does), else the scalar a (s formed
// once a launch, the same operations on the same scalars).  u is read from
// uin and written to uout.
template <typename T, bool HUBER, bool MAP>
struct Tvl1Step {
  const TVL1C<T>& h;
  const T* uin;
  T* uout;
  int M, N, cl, rows;
  long long region;   // the bands live in shared memory: unused
  T* pd;
  T sigma;
  T sh;               // the scalar weight's Huber factor
  __device__ Tvl1Step(const TVL1C<T>& h_, const T* uin_, T* uout_)
      : h(h_), uin(uin_), uout(uout_), M(h_.M), N(h_.N), cl(h_.cl),
        rows(h_.rows), region(0), pd(nullptr), sigma(h_.sigma) {
    sh = HUBER && !MAP ? huber_dual_factor(h_.a, h_.sigma, h_.gr) : T(1);
  }
  __device__ int K() const { return 1; }
  __device__ int kind(int) const { return STENCIL_FWD; }
  __device__ const T* u_in(long long b) const { return uin + b * h.mn; }
  __device__ T* u_out(long long b) const { return uout + b * h.mn; }
  __device__ T* y(int, long long b) const { return h.y + b * 2 * h.mn; }
  __device__ const T* f(long long b) const { return h.f + b * h.mn; }
  __device__ long long mn() const { return h.mn; }
  __device__ void at(int) const {}
  __device__ T alpha(int i, int j) const {
    return MAP ? h.amap[i * N + j] : h.a;
  }
  __device__ T primal(T dv, T uo, T fv, T& ub) const {
    const T un = tvl1_prox<T, HUBER>(dv, uo, fv, h.tau, h.lo, h.den);
    ub = T(2) * un - uo;
    return un;
  }
  __device__ T scale(int, int i, int j, T n2) const {
    return ball_scale(n2, alpha(i, j));
  }
};

template <typename T, bool MAP>
__device__ __forceinline__ void pd_pre(const Tvl1Step<T, true, MAP>& s, int,
                                       int i, int j, T& px, T& py) {
  const T sc = MAP ? huber_dual_factor(s.alpha(i, j), s.sigma, s.h.gr)
                   : s.sh;
  px = sc * px;
  py = sc * py;
}

// n_it iterations for the whole batch, one cluster an image; u from uin to
// uout (they may be one buffer), y in place.
template <typename T, bool HUBER, bool MAP>
__global__ void __launch_bounds__(PD_THREADS, PD_MINB)
tvl1_cp(TVL1C<T> h, const T* uin, T* uout, int n_it) {
  extern __shared__ __align__(16) unsigned char tvl1_smem[];
  Tvl1Step<T, HUBER, MAP> step(h, uin, uout);
  pd_cluster_run<T, true>(step, tvl1_smem, n_it);
}

// One tvl1_cp launch per chunk, after the plan's check against the card.
template <typename T, bool HUBER, bool MAP>
int tvl1_cluster(const TVL1C<T>& h, T* u, T* uprev, T* partials, T* scal,
                 long long O, int maxiter, int use_tol, T tol,
                 int check_every, int* iters_out, int* ops,
                 cudaStream_t st) {
  PdClusterLaunch<void (*)(TVL1C<T>, const T*, T*, int)> L;
  const size_t smem = (size_t)pd_region(1, h.rows, h.N) * sizeof(T);
  int err = pd_cluster_prepare(L, tvl1_cp<T, HUBER, MAP>, O, h.cl, smem, st);
  if (err != (int)cudaSuccess) return err;
  auto advance = [&](T* from, T* to, int, int n) -> cudaError_t {
    ++*ops;
    return cudaLaunchKernelEx(&L.cfg, L.kern, h, (const T*)from, to, n);
  };
  CpSumStop<T, false> stop{partials, scal, O * h.mn, {}};
  return cp_iterate<T>(advance, stop, u, uprev, O * h.mn, maxiter, use_tol,
                       tol, check_every, iters_out, ops, st);
}

template <typename T>
int tvl1_entry(const T* f, T* u, T* y, T* ubar, T* uprev, T* partials,
               T* scal, const T* amap, T a, long long O, int M, int N, int cl,
               int rows, int resident, T tau, T sigma, int huber, T lo,
               T den, T gr, int maxiter, int use_tol, T tol, int check_every,
               int* iters_out, int* ops, void* stream) {
  *iters_out = 0;
  *ops = 0;
  if (O < 1 || M < 1 || N < 1 || maxiter < 0
      || (use_tol && check_every < 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (!resident) {
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
    return cp_two_launch<T, false>(
        huber ? tvl1_primal<T, true> : tvl1_primal<T, false>,
        huber ? tvl1_dual<T, true> : tvl1_dual<T, false>, s, uprev, partials,
        scal, maxiter, use_tol, tol, check_every, iters_out, ops, st);
  }
  if (!pd_plan_ok(M, N, 1, cl, rows)) return (int)cudaErrorInvalidValue;
  TVL1C<T> h;
  h.f = f;
  h.y = y;
  h.amap = amap;
  h.a = a;
  h.tau = tau;
  h.sigma = sigma;
  h.lo = lo;
  h.den = den;
  h.gr = gr;
  h.mn = (long long)M * N;
  h.M = M;
  h.N = N;
  h.cl = cl;
  h.rows = rows;
#define TVL1_RUN(H, MAP)                                                   \
  tvl1_cluster<T, H, MAP>(h, u, uprev, partials, scal, O, maxiter,         \
                          use_tol, tol, check_every, iters_out, ops, st)
  if (huber)
    return amap ? TVL1_RUN(true, true) : TVL1_RUN(true, false);
  return amap ? TVL1_RUN(false, true) : TVL1_RUN(false, false);
#undef TVL1_RUN
}

}  // namespace bpl

extern "C" {

// The plan (solvers/tvl1_cuda.py::tvl1_plan): cl CTAs an image, rows
// each; resident 0 runs the two-launch form (ubar a plane of f's size),
// else the cluster form (ubar unused).  uprev is u's second buffer (used
// with tol); partials holds 2·⌈O·M·N / 256⌉ elements, scal 3.
// *iters_out: the iterations run; *ops_out: the device operations issued.
int bpl_tvl1_solve_f32(const float* f, float* u, float* y, float* ubar,
                       float* uprev, float* partials, float* scal,
                       const float* amap, float a, long long O, int M, int N,
                       int cl, int rows, int resident, float tau,
                       float sigma, int huber, float lo, float den, float gr,
                       int maxiter, int use_tol, float tol, int check_every,
                       int* iters_out, int* ops_out, void* stream) {
  return bpl::tvl1_entry<float>(f, u, y, ubar, uprev, partials, scal, amap,
                                a, O, M, N, cl, rows, resident, tau, sigma,
                                huber, lo, den, gr, maxiter, use_tol, tol,
                                check_every, iters_out, ops_out, stream);
}

int bpl_tvl1_solve_f64(const double* f, double* u, double* y, double* ubar,
                       double* uprev, double* partials, double* scal,
                       const double* amap, double a, long long O, int M,
                       int N, int cl, int rows, int resident, double tau,
                       double sigma, int huber, double lo, double den,
                       double gr, int maxiter, int use_tol, double tol,
                       int check_every, int* iters_out, int* ops_out,
                       void* stream) {
  return bpl::tvl1_entry<double>(f, u, y, ubar, uprev, partials, scal, amap,
                                 a, O, M, N, cl, rows, resident, tau, sigma,
                                 huber, lo, den, gr, maxiter, use_tol, tol,
                                 check_every, iters_out, ops_out, stream);
}

}  // extern "C"
