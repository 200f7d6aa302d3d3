// The single-loop bilevel learner: TPU kernels 9 and 10.
//
// Replaces bpldenoising_tpu/bilevel/first_order_pallas.py::_kernel (the
// resident one-launch learner, dispatched by _impl) and ::_tiled_kernel
// (the same learner over batch tiles with per-tile CG inner products,
// dispatched by _tiled_learn_impl).  Per outer step, for K gradient
// regularizers (forward, backward or centred differences) and a scalar or
// (m, n) patch α per regularizer:
//   x = exp(z) (recorded in the α trajectory);
//   n_inner fixed-step CP iterations:
//     u⁺ = (u − τ(Σₖ Gₖᵀyₖ − f))/(1+τ);  ū = 2u⁺ − u;
//     yₖ = Π_{|·|≤αₖ}(yₖ + σGₖū)   (α per pixel for a patch grid);
//   the γ-smoothed adjoint system at u (solvers/hypergrad.py::
//   build_reg_system): M = I + Σₖ Gₖᵀ αₖ[γ·inact + act·H]Gₖ with its Jacobi
//   diagonal;  n_adj CG steps on M p = ū − u from the warm p (classic, or
//   the pipelined Chronopoulos–Gear form, bilevel/pcg.py);
//   the gradient maps Σ_b Gₖp·fieldₖ, summed per parameter entry (the
//   whole plane for a scalar α, the patch for a grid);  Adam on log α with
//   βᵗ = pow(β, t);  the cost ½Σ(u − ū)² and ‖g‖.
//
// The arithmetic follows the port's plain version (bilevel/first_order.py,
// which follows the JAX package's jnp scan, not the Pallas kernel): Adam's
// β**t (not exp(t·log β)), build_reg_system's 1/den³ and 1/(den·den·den)
// forms, the field (act/den)·Gu + (γ·inact)·Gu; built with -fmad=false.
//
// What bounds it on an H100: the Pallas kernel keeps the whole problem in
// VMEM for one launch; a Hopper block has at most 227 KB of shared memory,
// less than one 128² plane set, and a grid-wide barrier would be needed
// after every PD half-step and every CG inner product.  So this first
// design keeps the state in global memory (≈ 17 planes of 10×128² f32 for
// the flagship, 11 MB, inside the 50 MB L2; 28 + 2K planes at batch 64 with
// K = 3, ≈ 150 MB, in HBM), runs one thread per pixel, and uses launch
// boundaries as the barriers: a C loop issues ~150 launches per outer step
// (2 per PD step, 6 per classic CG step, 4 per pipelined one).  Nothing is
// read back to the host between the first launch and the last: the CG's α
// and β, ρ = (r, z), Adam's z, m, v, the step counter and the trajectories
// live in device memory and are read there.  Per pixel a PD step is ~25 + 13K
// operations and a CG step ~30K, so at the flagship's 163,840 pixels every
// launch is a few microseconds of device work: launch issue, not bytes or
// operations, bounds it (chip_smoke.py prints the bound).  Inner products,
// gradient sums and the cost are block partials and a fixed-order second
// pass, no atomics: repeated runs agree bit for bit.  With tile_b < B the
// CG's inner products are taken per group of tile_b images (TPU kernel
// 10); the gradient and the cost are still summed over the whole batch.
#include "single_loop.cuh"

namespace bpl {

// u⁺ = (u − τ(Σₖ Gₖᵀyₖ − f))/(1+τ);  ū = 2u⁺ − u.
template <typename T>
__global__ void sl_primal(SL<T> h) {
  long long idx;
  if (!sl_pixel(h, idx)) return;
  Pix p = pix_of(idx, h.M, h.N);
  const long long in_img = idx - p.b * h.mn;
  T div = T(0);
  for (int k = 0; k < h.K; ++k) {
    const T* qx = h.y(k, p.b);
    T d = div_k(qx, qx + h.mn, in_img, p, h.M, h.N, h.kind[k]);
    div = k == 0 ? d : div + d;
  }
  T uo = h.u[idx];
  T un = (uo - h.tau * (div - h.f[idx])) / (T(1) + h.tau);
  h.u[idx] = un;
  h.plane(UBAR)[idx] = T(2) * un - uo;
}

// yₖ = Π_{|·|≤αₖ}(yₖ + σGₖū).
template <typename T>
__global__ void sl_dual(SL<T> h) {
  long long idx;
  if (!sl_pixel(h, idx)) return;
  Pix p = pix_of(idx, h.M, h.N);
  const long long in_img = idx - p.b * h.mn;
  const T* ubar = h.plane(UBAR);
  for (int k = 0; k < h.K; ++k) {
    T gx, gy;
    grad_k(ubar, idx, p, h.M, h.N, h.kind[k], gx, gy);
    T* qx = h.y(k, p.b) + in_img;
    T* qy = qx + h.mn;
    T px = *qx + h.sigma * gx;
    T py = *qy + h.sigma * gy;
    T s = ball_scale(px * px + py * py, sl_alpha(h, k, p));
    *qx = px * s;
    *qy = py * s;
  }
}

template <typename T>
int single_loop(SL<T> h, int outer, int n_inner, int n_adj, int pipelined,
                cudaStream_t s) {
  const dim3 grid(h.bpt, h.n_tiles);
  const T* pv = h.p;
  // the planes are device pointers: formed on the host from the base
  T* const md = h.w + (long long)MD * h.n;
  const T* const d = h.w + (long long)D * h.n;
  const T* const z = h.w + (long long)Z * h.n;
  cudaError_t err;
  for (int o = 0; o < outer; ++o) {
    BPL_LAUNCH(sl_exp<T>, 1, BPL_THREADS, s)(h, o);
    for (int it = 0; it < n_inner; ++it) {
      BPL_LAUNCH(sl_primal<T>, grid, BPL_THREADS, s)(h);
      BPL_LAUNCH(sl_dual<T>, grid, BPL_THREADS, s)(h);
    }
    BPL_LAUNCH(sl_setup<T>, grid, BPL_THREADS, s)(h);
    BPL_LAUNCH(sl_diag<T>, grid, BPL_THREADS, s)(h);
    BPL_LAUNCH(sl_weights<T>, grid, BPL_THREADS, s)(h, pv);
    BPL_LAUNCH(sl_apply<T>, grid, BPL_THREADS, s)(h, pv, md, APPLY_PLAIN);
    if (!pipelined) {
      sl_cg_classic(h, n_adj, s, [&]() {
        BPL_LAUNCH(sl_weights<T>, grid, BPL_THREADS, s)(h, d);
        BPL_LAUNCH(sl_apply<T>, grid, BPL_THREADS, s)(h, d, md, APPLY_DMD);
      });
    } else {
      BPL_LAUNCH(sl_pipe_init<T>, grid, BPL_THREADS, s)(h);
      for (int k = 0; k < n_adj; ++k) {
        BPL_LAUNCH(sl_weights<T>, grid, BPL_THREADS, s)(h, z);
        BPL_LAUNCH(sl_apply<T>, grid, BPL_THREADS, s)(h, z, md, APPLY_PIPE);
        BPL_LAUNCH(sl_finish<T>, h.n_tiles, BPL_THREADS, s)(h, FIN_PIPE,
                                                            k == 0);
        BPL_LAUNCH(sl_pipe_update<T>, grid, BPL_THREADS, s)(h);
      }
    }
    BPL_LAUNCH(sl_gmap<T>, h.nb_mn, BPL_THREADS, s)(h);
    sl_step_tail(h, o, s);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

template <typename T>
int single_loop_entry(const T* f, const T* ut, T* u, T* ys, T* p, T* zmv,
                      T* t, T* traj_x, T* traj_cost, T* traj_gnorm,
                      T* scratch, long long B, int M, int N, int K,
                      int kinds, int pm, int pn, int tile_b, int outer,
                      int n_inner, int n_adj, int pipelined, T tau, T sigma,
                      T gamma, T lr, T beta1, T beta2, T omb1, T omb2, T eps,
                      cudaStream_t s) {
  if (sl_bad_args(B, M, N, pm, pn, outer, n_inner, n_adj) || K < 1
      || K > SL_MAXK || tile_b < 1)
    return (int)cudaErrorInvalidValue;
  const SlSizes z = sl_sizes(B, M, N, K, pm * pn, tile_b);
  SL<T> h;
  sl_bind(h, scratch, z, B * (long long)M * N, M, N);
  sl_bind_opt(h, zmv, t, traj_x, traj_cost, traj_gnorm, (int)B, K, pm, pn,
              lr, beta1, beta2, omb1, omb2, eps);
  h.f = f;
  h.ut = ut;
  h.u = u;
  h.ys = ys;
  h.p = p;
  for (int k = 0; k < SL_MAXK; ++k) h.kind[k] = (kinds >> (2 * k)) & 3;
  h.tau = tau;
  h.sigma = sigma;
  h.gamma = gamma;
  return single_loop(h, outer, n_inner, n_adj, pipelined, s);
}

// One stencil on a stack, for checking it against ops/grad.py:
// what 0: gradient (B, M, N) → (B, 2, M, N); 1: adjoint and 2: Gram
// diagonal, (B, 2, M, N) → (B, M, N).
template <typename T>
__global__ void sl_stencil(int kind, int what, const T* __restrict__ a,
                           T* __restrict__ out, long long n, int M, int N) {
  long long idx = (long long)blockIdx.x * BPL_THREADS + threadIdx.x;
  if (idx >= n) return;
  Pix p = pix_of(idx, M, N);
  const long long mn = (long long)M * N;
  const long long in_img = idx - p.b * mn;
  if (what == 0) {
    T gx, gy;
    grad_k(a, idx, p, M, N, kind, gx, gy);
    out[p.b * 2 * mn + in_img] = gx;
    out[p.b * 2 * mn + mn + in_img] = gy;
    return;
  }
  const T* ax = a + p.b * 2 * mn;
  out[idx] = what == 1 ? div_k(ax, ax + mn, in_img, p, M, N, kind)
                       : gram_k(ax, ax + mn, in_img, p, M, N, kind);
}

template <typename T>
int stencil_entry(int kind, int what, const T* a, T* out, long long B, int M,
                  int N, cudaStream_t s) {
  const long long n = B * M * N;
  if (n < 1 || kind < 0 || kind > 2 || what < 0 || what > 2)
    return (int)cudaErrorInvalidValue;
  BPL_LAUNCH(sl_stencil<T>, blocks_for(n), BPL_THREADS, s)(kind, what, a,
                                                           out, n, M, N);
  return (int)cudaGetLastError();
}

}  // namespace bpl

extern "C" {

long long bpl_sl_scratch(long long B, int M, int N, int K, int P,
                         int tile_b) {
  return bpl::sl_sizes(B, M, N, K, P, tile_b).total;
}

int bpl_single_loop_f32(const float* f, const float* ut, float* u, float* ys,
                        float* p, float* zmv, float* t, float* traj_x,
                        float* traj_cost, float* traj_gnorm, float* scratch,
                        long long B, int M, int N, int K, int kinds, int pm,
                        int pn, int tile_b, int outer, int n_inner, int n_adj,
                        int pipelined, float tau, float sigma, float gamma,
                        float lr, float beta1, float beta2, float omb1,
                        float omb2, float eps, void* stream) {
  return bpl::single_loop_entry<float>(
      f, ut, u, ys, p, zmv, t, traj_x, traj_cost, traj_gnorm, scratch, B, M,
      N, K, kinds, pm, pn, tile_b, outer, n_inner, n_adj, pipelined, tau,
      sigma, gamma, lr, beta1, beta2, omb1, omb2, eps, (cudaStream_t)stream);
}

int bpl_single_loop_f64(const double* f, const double* ut, double* u,
                        double* ys, double* p, double* zmv, double* t,
                        double* traj_x, double* traj_cost,
                        double* traj_gnorm, double* scratch, long long B,
                        int M, int N, int K, int kinds, int pm, int pn,
                        int tile_b, int outer, int n_inner, int n_adj,
                        int pipelined, double tau, double sigma, double gamma,
                        double lr, double beta1, double beta2, double omb1,
                        double omb2, double eps, void* stream) {
  return bpl::single_loop_entry<double>(
      f, ut, u, ys, p, zmv, t, traj_x, traj_cost, traj_gnorm, scratch, B, M,
      N, K, kinds, pm, pn, tile_b, outer, n_inner, n_adj, pipelined, tau,
      sigma, gamma, lr, beta1, beta2, omb1, omb2, eps, (cudaStream_t)stream);
}

int bpl_sl_stencil_f32(int kind, int what, const float* a, float* out,
                       long long B, int M, int N, void* stream) {
  return bpl::stencil_entry<float>(kind, what, a, out, B, M, N,
                                   (cudaStream_t)stream);
}

int bpl_sl_stencil_f64(int kind, int what, const double* a, double* out,
                       long long B, int M, int N, void* stream) {
  return bpl::stencil_entry<double>(kind, what, a, out, B, M, N,
                                    (cudaStream_t)stream);
}

}  // extern "C"
