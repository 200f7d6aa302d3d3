// The single-loop TV-L1 learner: TPU kernel 12.
//
// Replaces bpldenoising_tpu/bilevel/first_order_tvl1_pallas.py::_kernel
// (the one-launch learner on one image with a scalar weight, all state in
// VMEM).  Per outer step, on a batch of B images with a scalar weight or
// an (m, n) patch grid (bilevel/first_order_tvl1.py, the jnp scan's order):
//   x = exp(z) (the α trajectory); α as an (M, N) map (sl_amap);
//   n_inner Huber-smoothed CP steps: tvl1.cuh's Huber-form tvl1_primal and
//     tvl1_dual, the kernels of the CP solve (the dual scaled by
//     1/(1 + σ/(max(α, 1e-12)·γ_r)));
//   the smoothed adjoint system H = D + ∇ᵀ(αW)∇ at u, D = γ_d·1{|u − f| ≤
//     1/γ_d} in place of the TV system's identity (single_loop.cuh's
//     build_reg_system kernels with dfac), the Jacobi diagonal
//     max(1/(1/diag) + (d − 1), 1e-12);
//   n_adj Jacobi-CG steps on H p = ū − u from the warm p, inner products
//     per image (cg_batched(item_ndim=2, tol=0));
//   the gradient map Σ_b ∇p·ψ'(∇u), pulled back per patch; Adam on log α
//     with g_z clipped to ±clip before the moments (single_loop.cuh).
// Early on D vanishes on the outlier pixels and the adjoint system is
// near-singular: |g| reaches ~1e6, and the clip keeps Adam's second moment
// from freezing the step (first_order_tvl1.py's module note).
//
// What bounds it on an H100: as single_loop.cu: the state stays in global
// memory (≈ 24 planes of B × 128² f32, L2-resident), one thread per pixel,
// launch boundaries as barriers: 2 launches per CP step, 6 per CG step, 11
// more per outer step (151 at 40/10).  Launch issue bounds it;
// chip_smoke.py prints its operation bound.
#include "single_loop.cuh"
#include "tvl1.cuh"

namespace bpl {

// Scratch: the learner's planes for K = 1 with tiles of one image, then
// the D plane and the α map.
static long long sl1_scratch(long long B, int M, int N, int P) {
  const long long mn = (long long)M * N;
  return sl_sizes(B, M, N, 1, P, 1).total + B * mn + mn;
}

template <typename T>
int sl_tvl1_entry(const T* f, const T* ut, T* u, T* y, T* p, T* zmv, T* t,
                  T* traj_x, T* traj_cost, T* traj_gnorm, T* scratch,
                  long long B, int M, int N, int pm, int pn, int outer,
                  int n_inner, int n_adj, T tau, T sigma, T gamma_r, T lo,
                  T den, T gamma_d, T inv_gd, T lr, T beta1, T beta2, T omb1,
                  T omb2, T eps, T clip, cudaStream_t s) {
  if (sl_bad_args(B, M, N, pm, pn, outer, n_inner, n_adj))
    return (int)cudaErrorInvalidValue;
  const long long mn = (long long)M * N, npix = B * mn;
  const SlSizes z = sl_sizes(B, M, N, 1, pm * pn, 1);
  SL<T> h;
  sl_bind(h, scratch, z, npix, M, N);
  sl_bind_opt(h, zmv, t, traj_x, traj_cost, traj_gnorm, (int)B, 1, pm, pn,
              lr, beta1, beta2, omb1, omb2, eps);
  h.f = f;
  h.ut = ut;
  h.u = u;
  h.ys = y;
  h.p = p;
  for (int k = 0; k < SL_MAXK; ++k) h.kind[k] = STENCIL_FWD;
  h.tau = tau;
  h.sigma = sigma;
  h.gamma = gamma_r;
  h.dfac = scratch + z.total;
  h.gamma_d = gamma_d;
  h.inv_gd = inv_gd;
  h.use_clip = 1;
  h.clip = clip;
  T* amap = h.dfac + npix;

  TVL1<T> cp;
  cp.f = f;
  cp.u = u;
  cp.y = y;
  cp.ubar = h.w + (long long)UBAR * npix;
  cp.amap = amap;
  cp.a = T(0);
  cp.tau = tau;
  cp.sigma = sigma;
  cp.lo = lo;
  cp.den = den;
  cp.gr = gamma_r;
  cp.n = npix;
  cp.M = M;
  cp.N = N;

  const dim3 grid(h.bpt, h.n_tiles);
  const int gpix = blocks_for(npix);
  return sl_run(
      h, amap, outer, n_inner, n_adj, s,
      [&]() {
        tvl1_primal<T, true><<<gpix, BPL_THREADS, 0, s>>>(cp);
        tvl1_dual<T, true><<<gpix, BPL_THREADS, 0, s>>>(cp);
      },
      [&]() {
        BPL_LAUNCH(sl_setup<T>, grid, BPL_THREADS, s)(h);
        BPL_LAUNCH(sl_diag<T>, grid, BPL_THREADS, s)(h);
      },
      [&](const T* v, T* out, int mode) {
        BPL_LAUNCH(sl_weights<T>, grid, BPL_THREADS, s)(h, v);
        BPL_LAUNCH(sl_apply<T>, grid, BPL_THREADS, s)(h, v, out, mode);
      },
      [&]() { BPL_LAUNCH(sl_gmap<T>, h.nb_mn, BPL_THREADS, s)(h); });
}

}  // namespace bpl

extern "C" {

long long bpl_sl_tvl1_scratch(long long B, int M, int N, int P) {
  return bpl::sl1_scratch(B, M, N, P);
}

#define BPL_SL_TVL1(SUFFIX, T)                                               \
  int bpl_sl_tvl1_##SUFFIX(const T* f, const T* ut, T* u, T* y, T* p,        \
                           T* zmv, T* t, T* traj_x, T* traj_cost,            \
                           T* traj_gnorm, T* scratch, long long B, int M,    \
                           int N, int pm, int pn, int outer, int n_inner,    \
                           int n_adj, T tau, T sigma, T gamma_r, T lo,       \
                           T den, T gamma_d, T inv_gd, T lr, T beta1,        \
                           T beta2, T omb1, T omb2, T eps, T clip,           \
                           void* stream) {                                   \
    return bpl::sl_tvl1_entry<T>(f, ut, u, y, p, zmv, t, traj_x, traj_cost,  \
                                 traj_gnorm, scratch, B, M, N, pm, pn,       \
                                 outer, n_inner, n_adj, tau, sigma, gamma_r, \
                                 lo, den, gamma_d, inv_gd, lr, beta1, beta2, \
                                 omb1, omb2, eps, clip,                      \
                                 (cudaStream_t)stream);                      \
  }

BPL_SL_TVL1(f32, float)
BPL_SL_TVL1(f64, double)

}  // extern "C"
