// Kernel: TGV² joint-primal Chambolle–Pock denoising, scalar or (M, N) map
// weights (α₁, α₀), warm start, batch-global early stop.
//
// Replaces both TPU kernels of bpldenoising_tpu/solvers/tgv_pallas.py:
// _make_kernel (:103, whole images resident in VMEM; row 4 of PERF.md's
// table) and _make_tiled_kernel (:217, halo'd row tiles for images whose 9
// planes exceed VMEM; row 5).  Per iteration, per pixel (solvers/tgv.py::
// _step):
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
// Bound: the arithmetic is 70 operations per pixel-iteration (29 primal,
// 41 dual; the JAX cost estimate at tgv_pallas.py:487 counts ~110 for the
// roll+mask form), so 5000 iterations at 10×128² are ~5.7e10 operations,
// ~0.86 ms at 67 TFLOP/s f32; the bytes a solve must move are f and the
// state in and the state out once (1 + 8 + 8 planes).  What costs time on
// the card is not that work but its cadence: a 128² iteration is a few µs
// of device work, so one launch per half-step is paced by launch issue,
// and every iteration sends the nine planes and the ū, w̄ scratch through
// L2.
//
// Two forms, chosen by the host's plan (solvers/cluster_plan.py::
// tgv_plan) from the shapes before any launch:
// - the cluster form (tgv_cp): the band scheme of csrc/tgv_cluster.cuh,
//   which row 11's slt_pd also runs: one thread-block cluster an image,
//   each CTA a band of rows of the eleven planes (u, ū, w, w̄, p, q) in
//   shared memory (88 KB a CTA at 128² f32 with 16 CTAs, two CTAs an SM;
//   176 KB in f64), one cluster barrier an iteration, the state read from
//   global memory once a launch and written back once; one launch per
//   early-stop chunk (all of maxiter without tol), no ū or w̄ plane in
//   global memory.  The bands always live in shared memory here: where
//   they do not fit, the global-scratch form of tgv_cluster_run would run
//   a 1024² image on 16 CTAs of a 132-SM card, so that shape takes
// - the two-launch form: the state in global memory, one thread a pixel,
//   tgv_primal and tgv_dual (tgv.cuh) per iteration from a C loop, with
//   ū and w̄ in scratch planes (1×1024², row 5's shape).
// Both run tgv.cuh's arithmetic in the same order under -fmad=false, so
// they agree bit for bit.  A cluster launch or an occupancy check that
// the card refuses returns its error; nothing is retried in the other
// form.
//
// Early stop (solvers/tgv.py): every `check_every` iterations the
// batch-global rel = ‖u − u_prev‖ / max(‖u_prev‖, 1), u_prev the chunk's
// OLD iterate; stop once rel ≤ tol.  The host loop is common.cuh's
// cp_iterate, which the TV-L1 kernel also runs: the two sums are
// fixed-order per-block partials (cp_change) and a one-block second pass
// (no atomics, repeated runs agree bit for bit); the host reads them once
// per check.  Both forms ping-pong u between two buffers: a chunk is 4 device
// operations in the cluster form (the launch, the two passes, the read),
// 2·chunk + 4 in the two-launch form (the chunk starts with a copy into the
// other buffer), and a call ending in the second buffer copies back once.
#include "tgv_cluster.cuh"

namespace bpl {

// ---------------------------------------------------- the cluster form

// The state of a cluster launch: f, w, p, q, the weights, the step sizes
// and the plan (cl CTAs an image, rows each).
template <typename T>
struct TGVC {
  const T* f;
  T* w;
  T* p;
  T* q;
  const T* a1map;   // (M, N) or null: then a1
  const T* a0map;
  T a1, a0, tau, sigma;
  long long mn;
  int M, N, cl, rows;
};

// The CP solve's step for tgv_cluster_run: constant τ and σ, u read from
// uin and written to uout.  MAP: a weight with a map is read at the pixel
// through the caches, as tgv_dual reads it, else the scalar.
template <typename T, bool MAP>
struct TgvStep {
  const TGVC<T>& h;
  const T* uin;
  T* uout;
  int M, N, cl, rows;
  long long region;   // the bands live in shared memory: unused
  T* pd;
  T tau, sigma;
  __device__ TgvStep(const TGVC<T>& h_, const T* uin_, T* uout_)
      : h(h_), uin(uin_), uout(uout_), M(h_.M), N(h_.N), cl(h_.cl),
        rows(h_.rows), region(0), pd(nullptr), tau(h_.tau),
        sigma(h_.sigma) {}
  __device__ const T* u(long long b) const { return uin + b * h.mn; }
  __device__ T* u_out(long long b) const { return uout + b * h.mn; }
  __device__ T* w(long long b) const { return h.w + b * 2 * h.mn; }
  __device__ T* p(long long b) const { return h.p + b * 2 * h.mn; }
  __device__ T* q(long long b) const { return h.q + b * 3 * h.mn; }
  __device__ const T* f(long long b) const { return h.f + b * h.mn; }
  __device__ long long mn() const { return h.mn; }
  __device__ T a1(int i, int j) const {
    return MAP && h.a1map ? h.a1map[i * N + j] : h.a1;
  }
  __device__ T a0(int i, int j) const {
    return MAP && h.a0map ? h.a0map[i * N + j] : h.a0;
  }
};

// n_it iterations for the whole batch, one cluster an image; u from uin to
// uout (they may be one buffer), w, p and q in place.  Two CTAs an SM in
// float32 (88 KB bands at 16 CTAs an image); in float64 one (176 KB), so
// the register bound is 128.
template <typename T, bool MAP>
__global__ void __launch_bounds__(PD_THREADS, sizeof(T) == 4 ? PD_MINB : 1)
tgv_cp(TGVC<T> h, const T* uin, T* uout, int n_it) {
  extern __shared__ __align__(16) unsigned char tgv_smem[];
  TgvStep<T, MAP> step(h, uin, uout);
  tgv_cluster_run<T, true>(step, tgv_smem, n_it);
}

// One tgv_cp launch per chunk, after the plan's check against the card.
template <typename T, bool MAP>
int tgv_cluster(const TGVC<T>& h, T* u, T* uprev, T* partials, T* scal,
                long long O, int maxiter, int use_tol, T tol,
                int check_every, int* iters_out, int* ops,
                cudaStream_t st) {
  PdClusterLaunch<void (*)(TGVC<T>, const T*, T*, int)> L;
  const size_t smem = (size_t)tgv_region(h.rows, h.N) * sizeof(T);
  int err = pd_cluster_prepare(L, tgv_cp<T, MAP>, O, h.cl, smem, st);
  if (err != (int)cudaSuccess) return err;
  auto advance = [&](T* from, T* to, int, int n) -> cudaError_t {
    ++*ops;
    return cudaLaunchKernelEx(&L.cfg, L.kern, h, (const T*)from, to, n);
  };
  CpSumStop<T, true> stop{partials, scal, O * h.mn, {}};
  return cp_iterate<T>(advance, stop, u, uprev, O * h.mn, maxiter, use_tol,
                       tol, check_every, iters_out, ops, st);
}

template <typename T>
int tgv_entry(const T* f, T* u, T* w, T* p, T* q, T* ubar, T* wbar,
              T* uprev, T* partials, T* scal, const T* a1map,
              const T* a0map, T a1, T a0, long long O, int M, int N, int cl,
              int rows, int resident, T tau, T sigma, int maxiter,
              int use_tol, T tol, int check_every, int* iters_out, int* ops,
              void* stream) {
  *iters_out = 0;
  *ops = 0;
  if (O < 1 || M < 1 || N < 1 || maxiter < 0
      || (use_tol && check_every < 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (!resident) {
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
    return cp_two_launch<T, true>(tgv_primal<T>, tgv_dual<T>, s, uprev,
                                  partials, scal, maxiter, use_tol, tol,
                                  check_every, iters_out, ops, st);
  }
  if (!tgv_plan_ok(M, N, cl, rows)) return (int)cudaErrorInvalidValue;
  TGVC<T> h;
  h.f = f;
  h.w = w;
  h.p = p;
  h.q = q;
  h.a1map = a1map;
  h.a0map = a0map;
  h.a1 = a1;
  h.a0 = a0;
  h.tau = tau;
  h.sigma = sigma;
  h.mn = (long long)M * N;
  h.M = M;
  h.N = N;
  h.cl = cl;
  h.rows = rows;
  if (a1map || a0map)
    return tgv_cluster<T, true>(h, u, uprev, partials, scal, O, maxiter,
                                use_tol, tol, check_every, iters_out, ops,
                                st);
  return tgv_cluster<T, false>(h, u, uprev, partials, scal, O, maxiter,
                               use_tol, tol, check_every, iters_out, ops, st);
}

}  // namespace bpl

extern "C" {

// The plan (solvers/cluster_plan.py::tgv_plan): cl CTAs an image, rows
// each; resident 0 runs the two-launch form (ubar and wbar planes of u's
// and w's size), else the cluster form (ubar, wbar unused).  uprev is u's
// second buffer (used with tol); partials holds 2·⌈O·M·N / 256⌉
// elements, scal 3.  *iters_out: the iterations run; *ops_out: the device
// operations issued.
int bpl_tgv_solve_f32(const float* f, float* u, float* w, float* p,
                      float* q, float* ubar, float* wbar, float* uprev,
                      float* partials, float* scal, const float* a1map,
                      const float* a0map, float a1, float a0, long long O,
                      int M, int N, int cl, int rows, int resident,
                      float tau, float sigma, int maxiter, int use_tol,
                      float tol, int check_every, int* iters_out,
                      int* ops_out, void* stream) {
  return bpl::tgv_entry<float>(f, u, w, p, q, ubar, wbar, uprev, partials,
                               scal, a1map, a0map, a1, a0, O, M, N, cl, rows,
                               resident, tau, sigma, maxiter, use_tol, tol,
                               check_every, iters_out, ops_out, stream);
}

int bpl_tgv_solve_f64(const double* f, double* u, double* w, double* p,
                      double* q, double* ubar, double* wbar, double* uprev,
                      double* partials, double* scal, const double* a1map,
                      const double* a0map, double a1, double a0,
                      long long O, int M, int N, int cl, int rows,
                      int resident, double tau, double sigma, int maxiter,
                      int use_tol, double tol, int check_every,
                      int* iters_out, int* ops_out, void* stream) {
  return bpl::tgv_entry<double>(f, u, w, p, q, ubar, wbar, uprev, partials,
                                scal, a1map, a0map, a1, a0, O, M, N, cl,
                                rows, resident, tau, sigma, maxiter, use_tol,
                                tol, check_every, iters_out, ops_out, stream);
}

}  // extern "C"
