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
// pixel and broadcast over the batch.  Σₖ is taken k = 0, 1, 2 in order,
// as in the plain version (solvers/pdps.py::_pdps_step); built with
// -fmad=false, each pixel's operations in that order.
//
// What bounds it on an H100: the TPU kernel keeps whole images resident in
// VMEM for all iterations; a Hopper block has at most 227 KB of shared
// memory, less than one image's state (a 128² f32 image's u, ū and two dual
// planes are 256 KB).  Per pixel an iteration is ~25 + 13K operations, so
// at the flagship's 10×128² an iteration is a few microseconds of device
// work: one launch per half-step (the first design, 2 launches per
// iteration and ~103 device operations per 50-iteration chunk) is paced by
// launch issue, not by bytes or operations.  This design:
//
//  * One launch per early-stop chunk (pdc_cp): `chunk` iterations, where
//    chunk is check_every (all maxiter without tol), for the whole batch.
//    Each image is one thread-block cluster under the band scheme of
//    csrc/pd_cluster.cuh (shared with the single-loop learner's CP phase,
//    csrc/single_loop.cu): CTA c owns a band of rows and keeps u, ū and the
//    2K dual planes of its band, with two halo rows each side, in shared
//    memory over the chunk; one cluster barrier per iteration; f and any
//    (M, N) α maps are read through L2.  The state is read from global
//    memory once per chunk and written back once.  u ping-pongs between
//    two buffers (the chunk reads one and writes the other), so the early
//    stop needs no copy of u: per chunk the launch, pd_change (common.cuh,
//    unchanged) and one host read of the O ratios — 3 device operations.
//  * τ, σ, ω are formed on the host in the working dtype, in the plain
//    version's order (cp_table, as common.cuh's pd_iterate_with forms
//    them), and reach the kernel as a per-iteration table in device memory:
//    one copy per call.  So the iterates, the ratios, the stop decisions
//    and the iteration counts are those of the two-launch design, bit for
//    bit.
//  * The kernel is instantiated for the forms of the main paths (CpForm:
//    K = 1 forward with a scalar or a map; K = 3 forward, backward and
//    centred with scalars or maps) and a generic one, so the stencil
//    branches, the loops over k and the map tests fold away.
//  * The host (solvers/cluster_plan.py::pd_plan) picks the cluster size and
//    rows per CTA from the shapes before any launch.  Where the bands do
//    not fit in shared memory (`resident` 0: float32 K = 1 from 320², K = 3
//    from 208²; float64 from 224² and 144²) the tile form runs instead
//    (csrc/pd_tile.cu, csrc/pd_tile.cuh; planned by pd_tile_plan): one CTA
//    a 2-D tile with a halo of reach·T pixels in shared memory, T
//    iterations a launch.  The two-launch form there before, pd_primal /
//    pd_dual for the scalar TV form and pd_primal_k / pd_dual_k otherwise
//    (one thread per pixel on state in global memory, from common.cuh's C
//    loop), is bound by device memory (the whole state every iteration,
//    ~78% of the bandwidth at 1×2048², K = 1); it stays below for no
//    shape of the plans: the tests force it to hold the other forms' bits.
//    A refused cluster launch or occupancy check returns its error, which
//    the wrapper raises.
//
// The early stop runs every `check_every` iterations: a per-image reduction
// of ‖Δu‖² and ‖u‖² (one block per image) and one host read of the O
// ratios, whose max is compared with tol — the per-image semantics of
// solvers/pdps.py, not the Pallas kernel's one norm per VMEM chunk.  Each
// call reports its device operations (launches and copies).
#include "pdps.cuh"

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

// ---------------------------------------- the two-launch form (not resident)

// The bands do not fit in shared memory: two launches per iteration from
// common.cuh's C loop (the u → uprev copy, pd_change and the host read per
// chunk).  *ops: the device operations it issued.
template <typename T>
int pdps_global(const T* f, T* u, T* y, T* ubar, T* uprev, T* ratio,
                long long O, int M, int N, const Blocks<T>& bl, T tau,
                T sigma, double gamma, int accel, int maxiter, int use_tol,
                T tol, int check_every, int* iters_out, int* ops,
                cudaStream_t s) {
  const long long n = O * M * N;
  const int grid = blocks_for(n);
  if (bl.K == 1 && bl.kind[0] == STENCIL_FWD && bl.amap[0] == nullptr) {
    const T alpha = bl.alpha[0];
    const T alpha2 = bl.alpha2[0];
    auto dual = [&](T sig) {
      BPL_LAUNCH(pd_dual<T>, grid, BPL_THREADS, s)(ubar, y, n, M, N, sig,
                                                   alpha, alpha2);
    };
    return pd_iterate<T>(f, u, y, ubar, uprev, ratio, O, M, N, tau, sigma,
                         gamma, accel, maxiter, use_tol, tol, check_every,
                         iters_out, ops, s, dual);
  }
  auto primal = [&](T tau_, T omega) {
    BPL_LAUNCH(pd_primal_k<T>, grid, BPL_THREADS, s)(f, u, ubar, y, n, M, N,
                                                     tau_, omega, bl);
  };
  auto dual = [&](T sig) {
    BPL_LAUNCH(pd_dual_k<T>, grid, BPL_THREADS, s)(ubar, y, n, M, N, sig,
                                                   bl);
  };
  return pd_iterate_with<T>(u, uprev, ratio, O, M, N, tau, sigma, gamma,
                            accel, maxiter, use_tol, tol, check_every,
                            iters_out, ops, s, primal, dual);
}

// ------------------------------------------------ the cluster form (resident)

// n_it iterations from iteration it0 for the whole batch, one cluster an
// image; u from uin to uout (they may be one buffer), the duals in place.
template <typename T, int F>
__global__ void __launch_bounds__(PD_THREADS, PD_MINB)
pdc_cp(CPC<T> h, const T* uin, T* uout, int it0, int n_it) {
  extern __shared__ __align__(16) unsigned char pdc_smem[];
  CpStep<T, F> step(h, uin, uout, it0);
  pd_cluster_run<T, true>(step, pdc_smem, n_it);
}

// The host loop of the cluster form: pd_cluster.cuh's cp_cluster_accel
// (the table copy, then one launch per chunk with the per-image stop
// rule).  *ops: the device operations it issued.
template <typename T, int F>
int pdc_run(const CPC<T>& h, T* u, T* uprev, T* ratio, T* tab, long long O,
            T tau, T sigma, double gamma, int accel, int maxiter,
            int use_tol, T tol, int check_every, int* iters_out, int* ops,
            cudaStream_t s) {
  PdClusterLaunch<void (*)(CPC<T>, const T*, T*, int, int)> L;
  const size_t smem = (size_t)pd_region(h.K, h.rows, h.N) * sizeof(T);
  int err = pd_cluster_prepare(L, pdc_cp<T, F>, O, h.cl, smem, s);
  if (err != (int)cudaSuccess) return err;
  return cp_cluster_accel(L, h, u, uprev, ratio, tab, O, h.mn, tau, sigma,
                          gamma, accel, maxiter, use_tol, tol, check_every,
                          iters_out, ops, s);
}

template <typename T>
int pdps_solve(const T* f, T* u, T* y, T* ubar, T* uprev, T* ratio, T* tab,
               long long O, int M, int N, int K, const int* kinds,
               const T* alphas, const long long* amaps, int cl, int rows,
               int resident, T tau, T sigma, double gamma, int accel,
               int maxiter, int use_tol, T tol, int check_every,
               int* iters_out, int* ops, cudaStream_t s) {
  *ops = 0;
  *iters_out = 0;
  if (K < 1 || K > 3 || O < 1 || M < 1 || N < 1 || maxiter < 0
      || (use_tol && check_every < 1))
    return (int)cudaErrorInvalidValue;
  Blocks<T> bl;
  bl.K = K;
  for (int k = 0; k < 3; ++k) {
    const bool live = k < K;
    bl.kind[k] = live ? kinds[k] : STENCIL_FWD;
    bl.alpha[k] = live ? alphas[k] : T(0);
    bl.alpha2[k] = bl.alpha[k] * bl.alpha[k];
    bl.amap[k] = live ? (const T*)amaps[k] : nullptr;
  }
  if (!resident)
    return pdps_global<T>(f, u, y, ubar, uprev, ratio, O, M, N, bl, tau,
                          sigma, gamma, accel, maxiter, use_tol, tol,
                          check_every, iters_out, ops, s);
  if (!pd_plan_ok(M, N, K, cl, rows)) return (int)cudaErrorInvalidValue;
  CPC<T> h;
  const int form = cp_state(h, f, y, tab, O, M, N, K, kinds, alphas, amaps);
  h.cl = cl;
  h.rows = rows;
#define PDC_RUN(F)                                                         \
  pdc_run<T, F>(h, u, uprev, ratio, tab, O, tau, sigma, gamma, accel,      \
                maxiter, use_tol, tol, check_every, iters_out, ops, s)
  switch (form) {
    case CP_TV: return PDC_RUN(CP_TV);
    case CP_TV_MAP: return PDC_RUN(CP_TV_MAP);
    case CP_SUMREGS: return PDC_RUN(CP_SUMREGS);
    case CP_SUMREGS_MAPS: return PDC_RUN(CP_SUMREGS_MAPS);
    default: return PDC_RUN(CP_ANY);
  }
#undef PDC_RUN
}

}  // namespace bpl

extern "C" {

// kinds: K stencil kinds (0 forward, 1 backward, 2 centred); alphas: K
// scalar weights; amaps: K device addresses of (M, N) weight maps, 0 where
// the block's weight is the scalar.  y holds the K duals, (K, O, 2, M, N).
// The plan (solvers/cluster_plan.py::pd_plan): cl CTAs an image, rows
// each; resident 0 runs the two-launch form (ubar then a B·M·N plane, tab
// unused), else the cluster form (ubar unused, tab 3·maxiter elements).
// *iters_out: the iterations run; *ops_out: the device operations issued.
int bpl_pdps_solve_f32(const float* f, float* u, float* y, float* ubar,
                       float* uprev, float* ratio, float* tab, long long O,
                       int M, int N, int K, const int* kinds,
                       const float* alphas, const long long* amaps, int cl,
                       int rows, int resident, float tau, float sigma,
                       double gamma, int accel, int maxiter, int use_tol,
                       float tol, int check_every, int* iters_out,
                       int* ops_out, void* stream) {
  return bpl::pdps_solve<float>(f, u, y, ubar, uprev, ratio, tab, O, M, N,
                                K, kinds, alphas, amaps, cl, rows, resident,
                                tau, sigma, gamma, accel, maxiter, use_tol,
                                tol, check_every, iters_out, ops_out,
                                (cudaStream_t)stream);
}

int bpl_pdps_solve_f64(const double* f, double* u, double* y, double* ubar,
                       double* uprev, double* ratio, double* tab,
                       long long O, int M, int N, int K, const int* kinds,
                       const double* alphas, const long long* amaps, int cl,
                       int rows, int resident, double tau, double sigma,
                       double gamma, int accel, int maxiter, int use_tol,
                       double tol, int check_every, int* iters_out,
                       int* ops_out, void* stream) {
  return bpl::pdps_solve<double>(f, u, y, ubar, uprev, ratio, tab, O, M, N,
                                 K, kinds, alphas, amaps, cl, rows, resident,
                                 tau, sigma, gamma, accel, maxiter, use_tol,
                                 tol, check_every, iters_out, ops_out,
                                 (cudaStream_t)stream);
}

const char* bpl_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
