// The single-loop TGV² learner: TPU kernel 11.
//
// Replaces bpldenoising_tpu/bilevel/first_order_tgv_pallas.py::_kernel (the
// one-launch learner on one image with a (2,) weight, all state in VMEM).
// Per outer step, on a batch of B images with a (2,) weight or an
// (m, n, 2) patch stack (bilevel/first_order_tgv.py, the jnp scan's order):
//   x = exp(z) (the α trajectory); (α₁, α₀) as (M, N) maps (sl_amap);
//   n_inner joint-CP steps: tgv.cuh's tgv_primal and tgv_dual, the kernels
//     of the CP solve (solvers/tgv.py::_step);
//   the γ-Huber smoothed joint system at (u, w) (solvers/tgv.py::
//     _build_joint_system): y = ∇u − w, z = Ew, s = 1/max(|·|, γ), the
//     mask |·| ≥ γ, the Jacobi diagonal [1 + gram(α₁s_y), α₁s_y + e_r,
//     α₁s_y + e_c];  H(du, dw) = (du + ∇ᵀ(α₁Dψ_y(∇du − dw)),
//     −α₁Dψ_y(∇du − dw) + Eᵀ(α₀Dψ_z(E dw)));
//   n_adj Jacobi-CG steps on H λ = (ū − u, 0, 0) from the warm λ, inner
//     products per image over its 3 planes (single_loop.cuh with tiles of
//     one image: cg_batched(item_ndim=3, tol=0));
//   g₁ = Σ_b ψ_y·(∇λᵤ − λ_w), g₀ = Σ_b ψ_z·Eλ_w per pixel, pulled back per
//     patch; Adam on log(α₁, α₀) (single_loop.cuh).
// The arithmetic is the plain version's (the product order of
// _build_joint_system and _dpsi, s³ as s·s·s), not the Pallas kernel's
// plane-form rewrite; built with -fmad=false.
//
// What bounds it on an H100: as single_loop.cu.  The Pallas kernel keeps
// one image's ~30 planes in VMEM; here any batch keeps its state in global
// memory (≈ 40 planes of B × 128² f32: 2.6 MB per image, L2-resident up to
// a batch of ~15), one thread per pixel (per CG element in the CG
// launches), launch boundaries as barriers: 2 launches per CP step, 6 per
// CG step, 11 more per outer step, 151 at 40/10.  At 128² every launch is a
// few microseconds of device work, so launch issue bounds the learner;
// chip_smoke.py prints its operation bound.
#include "single_loop.cuh"
#include "tgv.cuh"

namespace bpl {

template <typename T>
struct SLTgv {
  SL<T> h;       // λ is h.p: (B, 3, M, N); the CG runs over its elements
  const T* w;    // (B, 2, M, N), the CP state's w
  T* Y;          // (B, 2, M, N)  y = ∇u − w
  T* Zt;         // (B, 3, M, N)  z = E w
  T* SY;         // (B, M, N)     s_y = 1/max(|y|, γ)
  T* MY;         //               1{|y| ≥ γ}
  T* SZ;
  T* MZ;
  T* A1SY;       //               α₁ s_y
  T* A0SZ;       //               α₀ s_z
  T* HY;         // (B, 2, M, N)  α₁ Dψ_y(∇du − dw)
  T* HZ;         // (B, 3, M, N)  α₀ Dψ_z(E dw)
  long long npix;
};

// 1/max(n, γ) and the mask n ≥ γ.
template <typename T>
__device__ __forceinline__ void slt_huber(T n, T gamma, T& s, T& m) {
  s = T(1) / (n < gamma ? gamma : n);
  m = n >= gamma ? T(1) : T(0);
}

// The fields of the joint system at the CP iterate (u, w), per pixel.
template <typename T>
__global__ void slt_setup(SLTgv<T> g) {
  const long long idx = (long long)blockIdx.x * BPL_THREADS + threadIdx.x;
  if (idx >= g.npix) return;
  const SL<T>& h = g.h;
  Pix p = pix_of(idx, h.M, h.N);
  const long long mn = h.mn, k = idx - p.b * mn;
  const T* wr = g.w + p.b * 2 * mn;
  const T* wc = wr + mn;
  T gx, gy;
  grad_k((const T*)h.u, idx, p, h.M, h.N, STENCIL_FWD, gx, gy);
  const T yr = gx - wr[k], yc = gy - wc[k];
  T e0, e1, e2;
  sym_grad_bwd(wr, wc, k, p, h.N, e0, e1, e2);
  T sy, my, sz, mz;
  slt_huber(sqrt(yr * yr + yc * yc), h.gamma, sy, my);
  slt_huber(sqrt((e0 * e0 + e1 * e1) + e2 * e2), h.gamma, sz, mz);
  T* Y = g.Y + p.b * 2 * mn + k;
  Y[0] = yr;
  Y[mn] = yc;
  T* Z = g.Zt + p.b * 3 * mn + k;
  Z[0] = e0;
  Z[mn] = e1;
  Z[2 * mn] = e2;
  g.SY[idx] = sy;
  g.MY[idx] = my;
  g.SZ[idx] = sz;
  g.MZ[idx] = mz;
  g.A1SY[idx] = sl_alpha(h, 0, p) * sy;
  g.A0SZ[idx] = sl_alpha(h, 1, p) * sz;
}

// The Jacobi diagonal of the three planes (u, w_r, w_c) into INV_DIAG.
template <typename T>
__global__ void slt_diag(SLTgv<T> g) {
  const long long idx = (long long)blockIdx.x * BPL_THREADS + threadIdx.x;
  if (idx >= g.npix) return;
  const SL<T>& h = g.h;
  Pix p = pix_of(idx, h.M, h.N);
  const long long mn = h.mn, k = idx - p.b * mn;
  const T du = T(1) + gram_k((const T*)g.A1SY, (const T*)g.A1SY, idx, p,
                             h.M, h.N, STENCIL_FWD);
  const T gr = gram1((const T*)g.A0SZ, idx, p.i, h.M, (long long)h.N,
                     STENCIL_BWD);
  const T gc = gram1((const T*)g.A0SZ, idx, p.j, h.N, 1LL, STENCIL_BWD);
  const T e_r = gr + T(0.5) * gc;
  const T e_c = gc + T(0.5) * gr;
  const T a1sy = g.A1SY[idx];
  T* pre = h.w + (long long)INV_DIAG * h.n + p.b * 3 * mn + k;
  pre[0] = du;
  pre[mn] = a1sy + e_r;
  pre[2 * mn] = a1sy + e_c;
}

// HY = α₁ Dψ_y(∇du − dw), HZ = α₀ Dψ_z(E dw) for v = (du, dw_r, dw_c):
// Dψ(d) = s·d − y·(mask·(y·d)·s³).
template <typename T>
__global__ void slt_weights(SLTgv<T> g, const T* __restrict__ v) {
  const long long idx = (long long)blockIdx.x * BPL_THREADS + threadIdx.x;
  if (idx >= g.npix) return;
  const SL<T>& h = g.h;
  Pix p = pix_of(idx, h.M, h.N);
  const long long mn = h.mn, k = idx - p.b * mn;
  const T* du = v + p.b * 3 * mn;
  const T* dwr = du + mn;
  const T* dwc = dwr + mn;
  T gx, gy;
  grad_k(du, k, p, h.M, h.N, STENCIL_FWD, gx, gy);
  const T tr = gx - dwr[k], tc = gy - dwc[k];
  const T* Y = g.Y + p.b * 2 * mn + k;
  const T yr = Y[0], yc = Y[mn];
  const T sy = g.SY[idx];
  const T rad = (g.MY[idx] * (yr * tr + yc * tc)) * ((sy * sy) * sy);
  const T a1 = sl_alpha(h, 0, p);
  T* HY = g.HY + p.b * 2 * mn + k;
  HY[0] = (sy * tr - yr * rad) * a1;
  HY[mn] = (sy * tc - yc * rad) * a1;
  T e0, e1, e2;
  sym_grad_bwd(dwr, dwc, k, p, h.N, e0, e1, e2);
  const T* Z = g.Zt + p.b * 3 * mn + k;
  const T z0 = Z[0], z1 = Z[mn], z2 = Z[2 * mn];
  const T sz = g.SZ[idx];
  const T radz = (g.MZ[idx] * ((z0 * e0 + z1 * e1) + z2 * e2))
                 * ((sz * sz) * sz);
  const T a0 = sl_alpha(h, 1, p);
  T* HZ = g.HZ + p.b * 3 * mn + k;
  HZ[0] = (sz * e0 - z0 * radz) * a0;
  HZ[mn] = (sz * e1 - z1 * radz) * a0;
  HZ[2 * mn] = (sz * e2 - z2 * radz) * a0;
}

// out = H v from HY, HZ, one thread per CG element (image b, plane c of
// u, w_r, w_c): du + ∇ᵀHY, −HY_r + (Eᵀ HZ)_r, −HY_c + (Eᵀ HZ)_c; with the
// block partials of v·Hv for APPLY_DMD.
template <typename T>
__global__ void slt_apply(SLTgv<T> g, const T* __restrict__ v,
                          T* __restrict__ out, int mode) {
  __shared__ T sh[BPL_THREADS];
  const SL<T>& h = g.h;
  long long idx;
  T s0 = T(0);
  if (sl_pixel(h, idx)) {
    const long long mn = h.mn, per = 3 * mn;
    const long long b = idx / per, rem = idx - b * per;
    const int c = (int)(rem / mn);
    const long long k = rem - c * mn;
    Pix p;
    p.b = b;
    p.i = (int)(k / h.N);
    p.j = (int)(k % h.N);
    const T* hyr = g.HY + b * 2 * mn;
    const T* hyc = hyr + mn;
    const T* hzrr = g.HZ + b * 3 * mn;
    const T* hzcc = hzrr + mn;
    const T* hzrc = hzcc + mn;
    const T vv = v[idx];
    T mv;
    if (c == 0) {
      mv = vv + div_k(hyr, hyc, k, p, h.M, h.N, STENCIL_FWD);
    } else if (c == 1) {
      mv = -hyr[k] + (dminus_T_rows(hzrr, k, p.i, h.M, h.N)
                      + dminus_T_cols(hzrc, k, p.j, h.N) / sqrt2<T>());
    } else {
      mv = -hyc[k] + (dminus_T_cols(hzcc, k, p.j, h.N)
                      + dminus_T_rows(hzrc, k, p.i, h.M, h.N) / sqrt2<T>());
    }
    out[idx] = mv;
    if (mode == APPLY_DMD) s0 = vv * mv;
  }
  sl_apply_partials(h, mode, s0, sh);
}

// One thread per pixel (i, j) of the plane: g₁ = Σ_b ψ_y·(∇λᵤ − λ_w) and
// g₀ = Σ_b ψ_z·Eλ_w (ψ = field·s), summed over the batch in order; block
// partials of Σ_b (u − ū)².
template <typename T>
__global__ void slt_gmap(SLTgv<T> g) {
  __shared__ T sh[BPL_THREADS];
  const SL<T>& h = g.h;
  const long long ij = (long long)blockIdx.x * BPL_THREADS + threadIdx.x;
  T c = T(0);
  if (ij < h.mn) {
    const long long mn = h.mn;
    Pix p;
    p.i = (int)(ij / h.N);
    p.j = (int)(ij % h.N);
    T acc1 = T(0), acc0 = T(0);
    for (int b = 0; b < h.B; ++b) {
      const long long idx = (long long)b * mn + ij;
      p.b = b;
      const T* lu = h.p + (long long)b * 3 * mn;
      const T* lwr = lu + mn;
      const T* lwc = lwr + mn;
      T gx, gy;
      grad_k(lu, ij, p, h.M, h.N, STENCIL_FWD, gx, gy);
      const T* Y = g.Y + (long long)b * 2 * mn + ij;
      const T sy = g.SY[idx];
      const T g1 = (Y[0] * sy) * (gx - lwr[ij])
                   + (Y[mn] * sy) * (gy - lwc[ij]);
      T e0, e1, e2;
      sym_grad_bwd(lwr, lwc, ij, p, h.N, e0, e1, e2);
      const T* Z = g.Zt + (long long)b * 3 * mn + ij;
      const T sz = g.SZ[idx];
      const T g0 = ((Z[0] * sz) * e0 + (Z[mn] * sz) * e1)
                   + (Z[2 * mn] * sz) * e2;
      acc1 = b == 0 ? g1 : acc1 + g1;
      acc0 = b == 0 ? g0 : acc0 + g0;
      const T d = h.u[idx] - h.ut[idx];
      c += d * d;
    }
    h.gmap[ij] = acc1;
    h.gmap[mn + ij] = acc0;
  }
  T s = block_sum(c, sh);
  if (threadIdx.x == 0) h.cost_part[blockIdx.x] = s;
}

// Scratch: the CG planes over the 3 planes of λ, then 19 pixel planes and
// the two α maps.
static SlSizes slt_sizes(long long B, int M, int N, int P) {
  const long long mn = (long long)M * N, ncg = 3 * B * mn;
  return sl_layout(ncg, 3 * mn, M, N, 2, P, (long long)SL_BASE * ncg);
}

static long long slt_scratch(long long B, int M, int N, int P) {
  const long long mn = (long long)M * N;
  return slt_sizes(B, M, N, P).total + 19 * B * mn + 2 * mn;
}

template <typename T>
int sl_tgv_entry(const T* f, const T* ut, T* u, T* w, T* p, T* q, T* lam,
                 T* zmv, T* t, T* traj_x, T* traj_cost, T* traj_gnorm,
                 T* scratch, long long B, int M, int N, int pm, int pn,
                 int outer, int n_inner, int n_adj, T tau, T sigma, T gamma,
                 T lr, T beta1, T beta2, T omb1, T omb2, T eps,
                 cudaStream_t s) {
  if (sl_bad_args(B, M, N, pm, pn, outer, n_inner, n_adj))
    return (int)cudaErrorInvalidValue;
  const long long mn = (long long)M * N, npix = B * mn;
  const SlSizes z = slt_sizes(B, M, N, pm * pn);
  SLTgv<T> g;
  SL<T>& h = g.h;
  sl_bind(h, scratch, z, 3 * npix, M, N);
  sl_bind_opt(h, zmv, t, traj_x, traj_cost, traj_gnorm, (int)B, 2, pm, pn,
              lr, beta1, beta2, omb1, omb2, eps);
  h.f = f;
  h.ut = ut;
  h.u = u;
  h.ys = nullptr;
  h.p = lam;
  for (int k = 0; k < SL_MAXK; ++k) h.kind[k] = STENCIL_FWD;
  h.tau = tau;
  h.sigma = sigma;
  h.gamma = gamma;
  h.c_lam = 3;
  h.c_u = 1;
  h.divide = 1;
  T* e = scratch + z.total;
  T* ubar = e;
  T* wbar = ubar + npix;
  g.w = w;
  g.Y = wbar + 2 * npix;
  g.Zt = g.Y + 2 * npix;
  g.SY = g.Zt + 3 * npix;
  g.MY = g.SY + npix;
  g.SZ = g.MY + npix;
  g.MZ = g.SZ + npix;
  g.A1SY = g.MZ + npix;
  g.A0SZ = g.A1SY + npix;
  g.HY = g.A0SZ + npix;
  g.HZ = g.HY + 2 * npix;
  T* amap = g.HZ + 3 * npix;
  g.npix = npix;

  TGV<T> cp;
  cp.f = f;
  cp.u = u;
  cp.w = w;
  cp.p = p;
  cp.q = q;
  cp.ubar = ubar;
  cp.wbar = wbar;
  cp.a1map = amap;
  cp.a0map = amap + mn;
  cp.a1 = T(0);
  cp.a0 = T(0);
  cp.tau = tau;
  cp.sigma = sigma;
  cp.n = npix;
  cp.M = M;
  cp.N = N;

  const dim3 grid(h.bpt, h.n_tiles);
  const int gpix = blocks_for(npix);
  return sl_run(
      h, amap, outer, n_inner, n_adj, s,
      [&]() {
        BPL_LAUNCH(tgv_primal<T>, gpix, BPL_THREADS, s)(cp);
        BPL_LAUNCH(tgv_dual<T>, gpix, BPL_THREADS, s)(cp);
      },
      [&]() {
        BPL_LAUNCH(slt_setup<T>, gpix, BPL_THREADS, s)(g);
        BPL_LAUNCH(slt_diag<T>, gpix, BPL_THREADS, s)(g);
      },
      [&](const T* v, T* out, int mode) {
        BPL_LAUNCH(slt_weights<T>, gpix, BPL_THREADS, s)(g, v);
        BPL_LAUNCH(slt_apply<T>, grid, BPL_THREADS, s)(g, v, out, mode);
      },
      [&]() { BPL_LAUNCH(slt_gmap<T>, h.nb_mn, BPL_THREADS, s)(g); });
}

}  // namespace bpl

extern "C" {

long long bpl_sl_tgv_scratch(long long B, int M, int N, int P) {
  return bpl::slt_scratch(B, M, N, P);
}

#define BPL_SL_TGV(SUFFIX, T)                                                \
  int bpl_sl_tgv_##SUFFIX(const T* f, const T* ut, T* u, T* w, T* p, T* q,   \
                          T* lam, T* zmv, T* t, T* traj_x, T* traj_cost,     \
                          T* traj_gnorm, T* scratch, long long B, int M,     \
                          int N, int pm, int pn, int outer, int n_inner,     \
                          int n_adj, T tau, T sigma, T gamma, T lr, T beta1, \
                          T beta2, T omb1, T omb2, T eps, void* stream) {    \
    return bpl::sl_tgv_entry<T>(f, ut, u, w, p, q, lam, zmv, t, traj_x,      \
                                traj_cost, traj_gnorm, scratch, B, M, N, pm, \
                                pn, outer, n_inner, n_adj, tau, sigma,       \
                                gamma, lr, beta1, beta2, omb1, omb2, eps,    \
                                (cudaStream_t)stream);                       \
  }

BPL_SL_TGV(f32, float)
BPL_SL_TGV(f64, double)

}  // extern "C"
