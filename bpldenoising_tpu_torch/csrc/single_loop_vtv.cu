// The single-loop vectorial-TV (color) learner: TPU kernel 13.
//
// Replaces bpldenoising_tpu/bilevel/first_order_vtv_pallas.py::_kernel (the
// one-launch learner on one color image with a scalar weight, all state
// in VMEM).  Per outer step, on a batch of B images of C channels with a
// scalar weight or an (m, n) patch grid (bilevel/first_order_vtv.py, the
// jnp scan's order):
//   x = exp(z) (the α trajectory); α as an (M, N) map (sl_amap);
//   n_inner unaccelerated CP steps: common.cuh's pd_primal over the B·C
//     planes with ω = 1 (u⁺ = (u − τ(∇ᵀy − f))/(1 + τ), ū = 2u⁺ − u) and
//     vtv.cuh's vtv_dual (the channel-coupled Frobenius projection), the
//     kernels of the CP solve;
//   the γ-Huber smoothed coupled system at u (solvers/vtv.py::
//     _dpsi_coupled): g = ∇u, s = 1/max(‖g‖_F, γ), the mask ‖g‖_F ≥ γ;
//     H v = v + ∇ᵀ(α Dψ(∇v)), Dψ(d) = s·d − g·(mask·(g·d)_F·s³), the
//     Jacobi diagonal 1 + gram(αs, αs) shared by the channels;
//   n_adj Jacobi-CG steps on H λ = ū − u from the warm λ, inner products
//     per image over its C planes (cg_batched(item_ndim=3, tol=0));
//   the gradient map Σ_b (ψ·∇λ)_F, pulled back per patch; Adam on log α
//     (single_loop.cuh).
// The Frobenius sums over (channel, component) are taken in the order of
// PyTorch's reduction on the card, as vtv_dual takes them (four
// accumulators, element k into k mod 4); built with -fmad=false.
//
// What bounds it on an H100: as single_loop.cu.  The state stays in global
// memory (≈ 20 planes per channel of B × 3 × 128² f32, L2-resident), one
// thread per pixel (per CG element in the CG launches), launch boundaries
// as barriers: 2 launches per CP step, 6 per CG step, 11 more per outer
// step (151 at 40/10).  Launch issue bounds it; chip_smoke.py prints its
// operation bound.
#include "single_loop.cuh"
#include "vtv.cuh"

namespace bpl {

template <typename T>
struct SLVtv {
  SL<T> h;       // u, ū, λ are (B, C, M, N); the CG runs over λ's elements
  T* G;          // (B, C, 2, M, N)  ∇u
  T* S;          // (B, M, N)        s = 1/max(‖∇u‖_F, γ)
  T* MK;         //                  1{‖∇u‖_F ≥ γ}
  T* AS;         //                  α s
  T* W;          // (B, C, 2, M, N)  α Dψ(∇v)
  long long npix;
  int C;
};

// g = ∇u per channel, s, the mask and αs, per pixel.
template <typename T>
__global__ void slv_setup(SLVtv<T> g) {
  const long long idx = (long long)blockIdx.x * BPL_THREADS + threadIdx.x;
  if (idx >= g.npix) return;
  const SL<T>& h = g.h;
  Pix p = pix_of(idx, h.M, h.N);
  const long long mn = h.mn, k = idx - p.b * mn;
  T acc[4] = {T(0), T(0), T(0), T(0)};
  for (int c = 0; c < g.C; ++c) {
    const long long plane = p.b * g.C + c;
    T gx, gy;
    grad_k((const T*)h.u + plane * mn, k, p, h.M, h.N, STENCIL_FWD, gx, gy);
    g.G[plane * 2 * mn + k] = gx;
    g.G[plane * 2 * mn + mn + k] = gy;
    frob_acc(acc, 2 * c, gx * gx);
    frob_acc(acc, 2 * c + 1, gy * gy);
  }
  const T nrm = sqrt(frob_total(acc));
  const T s = T(1) / (nrm < h.gamma ? h.gamma : nrm);
  g.S[idx] = s;
  g.MK[idx] = nrm >= h.gamma ? T(1) : T(0);
  g.AS[idx] = sl_alpha(h, 0, p) * s;
}

// The Jacobi diagonal 1 + gram(αs, αs), shared by the C planes of a pixel,
// into INV_DIAG.
template <typename T>
__global__ void slv_diag(SLVtv<T> g) {
  const long long idx = (long long)blockIdx.x * BPL_THREADS + threadIdx.x;
  if (idx >= g.npix) return;
  const SL<T>& h = g.h;
  Pix p = pix_of(idx, h.M, h.N);
  const long long mn = h.mn, k = idx - p.b * mn;
  const T dg = T(1) + gram_k((const T*)g.AS, (const T*)g.AS, idx, p, h.M,
                             h.N, STENCIL_FWD);
  T* pre = h.w + (long long)INV_DIAG * h.n + p.b * g.C * mn + k;
  for (int c = 0; c < g.C; ++c) pre[c * mn] = dg;
}

// W = α Dψ(∇v) per channel: a first pass forms (g·∇v)_F, a second the
// weights (the same gradients, the same values).
template <typename T>
__global__ void slv_weights(SLVtv<T> g, const T* __restrict__ v) {
  const long long idx = (long long)blockIdx.x * BPL_THREADS + threadIdx.x;
  if (idx >= g.npix) return;
  const SL<T>& h = g.h;
  Pix p = pix_of(idx, h.M, h.N);
  const long long mn = h.mn, k = idx - p.b * mn;
  T acc[4] = {T(0), T(0), T(0), T(0)};
  for (int c = 0; c < g.C; ++c) {
    const long long plane = p.b * g.C + c;
    T dx, dy;
    grad_k(v + plane * mn, k, p, h.M, h.N, STENCIL_FWD, dx, dy);
    const T* G = g.G + plane * 2 * mn + k;
    frob_acc(acc, 2 * c, G[0] * dx);
    frob_acc(acc, 2 * c + 1, G[mn] * dy);
  }
  const T s = g.S[idx];
  const T rad = (g.MK[idx] * frob_total(acc)) * ((s * s) * s);
  const T a = sl_alpha(h, 0, p);
  for (int c = 0; c < g.C; ++c) {
    const long long plane = p.b * g.C + c;
    T dx, dy;
    grad_k(v + plane * mn, k, p, h.M, h.N, STENCIL_FWD, dx, dy);
    const T* G = g.G + plane * 2 * mn + k;
    T* W = g.W + plane * 2 * mn + k;
    W[0] = a * (s * dx - G[0] * rad);
    W[mn] = a * (s * dy - G[mn] * rad);
  }
}

// out = v + ∇ᵀW, one thread per CG element (image plane, pixel), with the
// block partials of v·Hv for APPLY_DMD.
template <typename T>
__global__ void slv_apply(SLVtv<T> g, const T* __restrict__ v,
                          T* __restrict__ out, int mode) {
  __shared__ T sh[BPL_THREADS];
  const SL<T>& h = g.h;
  long long idx;
  T s0 = T(0);
  if (sl_pixel(h, idx)) {
    Pix p = pix_of(idx, h.M, h.N);      // p.b: the plane b·C + c
    const long long mn = h.mn, k = idx - p.b * mn;
    const T* wx = g.W + p.b * 2 * mn;
    const T vv = v[idx];
    const T mv = vv + div_k(wx, wx + mn, k, p, h.M, h.N, STENCIL_FWD);
    out[idx] = mv;
    if (mode == APPLY_DMD) s0 = vv * mv;
  }
  sl_apply_partials(h, mode, s0, sh);
}

// One thread per pixel (i, j) of the plane: Σ_b (ψ·∇λ)_F with ψ = g·s,
// summed over the batch in order; block partials of Σ (u − ū)².
template <typename T>
__global__ void slv_gmap(SLVtv<T> g) {
  __shared__ T sh[BPL_THREADS];
  const SL<T>& h = g.h;
  const long long ij = (long long)blockIdx.x * BPL_THREADS + threadIdx.x;
  T c2 = T(0);
  if (ij < h.mn) {
    const long long mn = h.mn;
    Pix p;
    p.i = (int)(ij / h.N);
    p.j = (int)(ij % h.N);
    T accb = T(0);
    for (int b = 0; b < h.B; ++b) {
      p.b = b;
      const T s = g.S[(long long)b * mn + ij];
      T acc[4] = {T(0), T(0), T(0), T(0)};
      for (int c = 0; c < g.C; ++c) {
        const long long plane = (long long)b * g.C + c;
        T lx, ly;
        grad_k((const T*)h.p + plane * mn, ij, p, h.M, h.N, STENCIL_FWD, lx,
               ly);
        const T* G = g.G + plane * 2 * mn + ij;
        frob_acc(acc, 2 * c, (G[0] * s) * lx);
        frob_acc(acc, 2 * c + 1, (G[mn] * s) * ly);
        const T d = h.u[plane * mn + ij] - h.ut[plane * mn + ij];
        c2 += d * d;
      }
      const T gb = frob_total(acc);
      accb = b == 0 ? gb : accb + gb;
    }
    h.gmap[ij] = accb;
  }
  T s = block_sum(c2, sh);
  if (threadIdx.x == 0) h.cost_part[blockIdx.x] = s;
}

// Scratch: the CG planes over λ's B·C planes, then ū, ∇u, W (5 per
// channel), S, MK, αs (3 pixel planes) and the α map.
static SlSizes slv_sizes(long long B, int C, int M, int N, int P) {
  const long long mn = (long long)M * N, ncg = B * C * mn;
  return sl_layout(ncg, C * mn, M, N, 1, P, (long long)SL_BASE * ncg);
}

static long long slv_scratch(long long B, int C, int M, int N, int P) {
  const long long mn = (long long)M * N;
  return slv_sizes(B, C, M, N, P).total + 5 * B * C * mn + 3 * B * mn + mn;
}

template <typename T>
int sl_vtv_entry(const T* f, const T* ut, T* u, T* y, T* lam, T* zmv, T* t,
                 T* traj_x, T* traj_cost, T* traj_gnorm, T* scratch,
                 long long B, int C, int M, int N, int pm, int pn, int outer,
                 int n_inner, int n_adj, T tau, T sigma, T gamma, T lr,
                 T beta1, T beta2, T omb1, T omb2, T eps, cudaStream_t s) {
  if (sl_bad_args(B, M, N, pm, pn, outer, n_inner, n_adj) || C < 1)
    return (int)cudaErrorInvalidValue;
  const long long mn = (long long)M * N, npix = B * mn, ncg = B * C * mn;
  const SlSizes z = slv_sizes(B, C, M, N, pm * pn);
  SLVtv<T> g;
  SL<T>& h = g.h;
  sl_bind(h, scratch, z, ncg, M, N);
  sl_bind_opt(h, zmv, t, traj_x, traj_cost, traj_gnorm, (int)B, 1, pm, pn,
              lr, beta1, beta2, omb1, omb2, eps);
  h.f = f;
  h.ut = ut;
  h.u = u;
  h.ys = y;
  h.p = lam;
  for (int k = 0; k < SL_MAXK; ++k) h.kind[k] = STENCIL_FWD;
  h.tau = tau;
  h.sigma = sigma;
  h.gamma = gamma;
  h.divide = 1;
  T* ubar = scratch + z.total;
  g.G = ubar + ncg;
  g.W = g.G + 2 * ncg;
  g.S = g.W + 2 * ncg;
  g.MK = g.S + npix;
  g.AS = g.MK + npix;
  T* amap = g.AS + npix;
  g.npix = npix;
  g.C = C;

  VTV<T> cp;
  cp.ubar = ubar;
  cp.y = y;
  cp.amap = amap;
  cp.a = T(0);
  cp.n = npix;
  cp.C = C;
  cp.M = M;
  cp.N = N;

  const dim3 grid(h.bpt, h.n_tiles);
  const int gpix = blocks_for(npix);
  const int gplanes = blocks_for(ncg);
  return sl_run(
      h, amap, outer, n_inner, n_adj, s,
      [&]() {
        BPL_LAUNCH(pd_primal<T>, gplanes, BPL_THREADS, s)(f, u, ubar, y, ncg,
                                                          M, N, tau, T(1));
        BPL_LAUNCH(vtv_dual<T>, gpix, BPL_THREADS, s)(cp, sigma);
      },
      [&]() {
        BPL_LAUNCH(slv_setup<T>, gpix, BPL_THREADS, s)(g);
        BPL_LAUNCH(slv_diag<T>, gpix, BPL_THREADS, s)(g);
      },
      [&](const T* v, T* out, int mode) {
        BPL_LAUNCH(slv_weights<T>, gpix, BPL_THREADS, s)(g, v);
        BPL_LAUNCH(slv_apply<T>, grid, BPL_THREADS, s)(g, v, out, mode);
      },
      [&]() { BPL_LAUNCH(slv_gmap<T>, h.nb_mn, BPL_THREADS, s)(g); });
}

}  // namespace bpl

extern "C" {

long long bpl_sl_vtv_scratch(long long B, int C, int M, int N, int P) {
  return bpl::slv_scratch(B, C, M, N, P);
}

#define BPL_SL_VTV(SUFFIX, T)                                                \
  int bpl_sl_vtv_##SUFFIX(const T* f, const T* ut, T* u, T* y, T* lam,       \
                          T* zmv, T* t, T* traj_x, T* traj_cost,             \
                          T* traj_gnorm, T* scratch, long long B, int C,     \
                          int M, int N, int pm, int pn, int outer,           \
                          int n_inner, int n_adj, T tau, T sigma, T gamma,   \
                          T lr, T beta1, T beta2, T omb1, T omb2, T eps,     \
                          void* stream) {                                    \
    return bpl::sl_vtv_entry<T>(f, ut, u, y, lam, zmv, t, traj_x, traj_cost, \
                                traj_gnorm, scratch, B, C, M, N, pm, pn,     \
                                outer, n_inner, n_adj, tau, sigma, gamma,    \
                                lr, beta1, beta2, omb1, omb2, eps,           \
                                (cudaStream_t)stream);                       \
  }

BPL_SL_VTV(f32, float)
BPL_SL_VTV(f64, double)

}  // extern "C"
