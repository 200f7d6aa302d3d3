// The single-loop TV-L1 learner: TPU kernel 12.
//
// Replaces bpldenoising_tpu/bilevel/first_order_tvl1_pallas.py::_kernel
// (the one-launch learner on one image with a scalar weight, all state in
// VMEM).  Per outer step, on a batch of B images with a scalar weight or
// an (m, n) patch grid (bilevel/first_order_tvl1.py, the jnp scan's order):
//   x = exp(z) (the α trajectory), α per pixel from the patch grid;
//   n_inner Huber-smoothed CP steps (tvl1.cuh's arithmetic: tvl1_prox's
//     Huber form, the dual scaled by 1/(1 + σ/(max(α, 1e-12)·γ_r)),
//     ball_scale);
//   the smoothed adjoint system H = D + ∇ᵀ(αW)∇ at u (solvers/hypergrad.py::
//     build_reg_system's TV system with D = γ_d·1{|u − f| ≤ 1/γ_d} in place
//     of I): Gu, act = |Gu| > 1/γ_r, 1/den and 1/den³; H v = v + ∇ᵀW +
//     (D − 1)v, W = α(γ_r·inact·∇v + act·(∇v/den − Gu(Gu·∇v)/den³)); the
//     Jacobi diagonal max(1/(1/diag) + (D − 1), 1e-12), diag = 1 + the Gram
//     of α(γ_r·inact + act(1/den − Gu²/den³));
//   n_adj Jacobi-CG steps on H p = ū − u from the warm p, inner products
//     per image (cg_batched(item_ndim=2, tol=0));
//   the gradient map Σ_b ∇p·((act/den + γ_r·inact)·Gu), pulled back per
//     patch; Adam on log α with g_z clipped to ±clip before the moments.
// Early on D vanishes on the outlier pixels and the adjoint system is
// near-singular: |g| reaches ~1e6, and the clip keeps Adam's second moment
// from freezing the step (first_order_tvl1.py's module note).  The
// arithmetic is the plain version's, in its order; built with -fmad=false.
//
// What bounds it on an H100.  At 1×128² every step of the loop is a few
// microseconds of device work or less (a CP iteration 36 operations a
// pixel, an H·v 28), so a design with one launch per half-step (151 a
// step) is paced by launch issue.  This design (rows 11's and 13's,
// csrc/single_loop_tgv.cu, csrc/single_loop_vtv.cu):
//
//  * CP phase, one launch per outer step (sl1_pd): a thread-block cluster
//    per image on the band scheme of csrc/pd_cluster.cuh (u, ū and the two
//    dual planes of each CTA's rows in shared memory for all n_inner
//    iterations, one cluster barrier per iteration), the step of the TV-L1
//    CP kernel (csrc/tvl1.cu, rows 7–8) with α read from the device.  The
//    host (solvers/tvl1_cuda.py::tvl1_plan) picks the CTAs per image and
//    rows per CTA; where the bands do not fit in shared memory the same
//    kernel keeps them in a global scratch laid out alike (`resident` 0).
//  * Adjoint CG, two launches per step (sl1_apply, sl1_update).  The inner
//    products keep the parent design's partial trees: one block_sum per
//    256 consecutive pixels of an image, the image's partials summed by its
//    last block (an integer counter, no float atomics) in a fixed order
//    (thread t adds partials t, t + 256, …, then one block_sum), the CG
//    scalars left on the device.  A CG block takes one partial block.  The
//    operator launch forms the direction d = z + βd (double-buffered
//    planes) on three bands of pixels (the block's, one row up, one row
//    down) in shared memory, then W on the block plus one pixel, then
//    ∇ᵀW + (D − 1)d.  The system set-up, the Jacobi diagonal, H·p and the
//    CG start are one launch (sl1_init; its fields are formed from u on the
//    bands and stored per pixel for the later launches).
//  * The tail: the gradient map and cost partials (sl1_gmap), then the
//    per-patch pullback whose last block runs Adam with the clip and forms
//    the next step's exp(z) (single_loop.cuh's slx_pull_adam).
//
// Launches per outer step: 4 + 2·n_adj (24 at n_adj = 10), and one per
// segment (slx_begin).
#include "pd_cluster.cuh"
#include "single_loop.cuh"
#include "tvl1.cuh"

namespace bpl {

// B·M·N CG planes, in p's (B, M, N) layout: r, z = r/diag, d (even and odd
// steps), H·d.
enum Sl1EPlane { E_R, E_Z, E_D0, E_D1, E_MD, N_EPLANES };
// B·M·N planes of the system at u: Gu (2), act, 1/den, (1/den)³, D, the
// Jacobi diagonal.
enum Sl1XPlane { X_GUX, X_GUY, X_ACT, X_IDEN, X_IDEN3, X_DFAC, X_DIAG,
                 N_XPLANES };
// per-image device scalars
enum Sl1Slot { T_RZ, T_A, T_BETA, N_TSLOTS };

// Element counts of the scratch buffer's parts (of T, but `counters`).
struct Sl1Sizes {
  long long eplanes, xplanes, gmap, kp, part, cost_part, scal, pd, counters,
      total;
  int bpt, nb_mn;
};

static Sl1Sizes sl1_sizes(long long B, int M, int N, int P, int cl,
                          int rows, int resident) {
  Sl1Sizes z;
  const long long mn = (long long)M * N;
  z.bpt = blocks_for(mn);
  z.nb_mn = z.bpt;
  z.eplanes = (long long)N_EPLANES * B * mn;
  z.xplanes = (long long)N_XPLANES * B * mn;
  z.gmap = mn;
  z.kp = P;
  z.part = B * z.bpt;
  z.cost_part = z.nb_mn;
  z.scal = (long long)N_TSLOTS * B;
  z.pd = resident ? 0 : B * cl * pd_region(1, rows, N);
  // B + 1 unsigned counters, in whole elements of T
  z.counters = B + 1;
  z.total = z.eplanes + z.xplanes + z.gmap + 2 * z.kp + z.part
            + z.cost_part + z.scal + z.pd + z.counters;
  return z;
}

template <typename T>
struct SL1 {
  const T* f;
  const T* ut;
  T* u;          // the CP state: (B, M, N)
  T* y;          // (B, 2, M, N)
  T* p;          // the adjoint: (B, M, N)
  T* zmv;        // z, Adam m, Adam v: 3 × P
  T* t;          // step counter
  T* traj_x;     // (outer, P)
  T* traj_cost;
  T* traj_gnorm;
  T* e;          // Sl1EPlane planes
  T* x;          // Sl1XPlane planes
  T* gmap;       // M·N
  T* xk;         // exp(z): P
  T* gx;         // the pulled-back gradient: P
  T* part;       // B × bpt block partials
  T* cost_part;  // nb_mn
  T* scal;       // N_TSLOTS × B
  T* pd;         // the CP bands in global memory (resident 0)
  unsigned* count;  // per image, then the pullback's
  long long mn, npix, region;
  int B, M, N, pm, pn, P, bpt, nb_mn, outer, cl, rows;
  // CP: τ, σ, γ_r, the Huber prox's 1/γ_d + τ and 1 + τγ_d; the system's
  // γ_d and 1/γ_d; Adam's constants and the clip
  T tau, sigma, gamma, lo, den, gamma_d, inv_gd, lr, beta1, beta2, omb1,
      omb2, eps, clip;
  __device__ T* eplane(int k) const { return e + (long long)k * npix; }
  __device__ T* xplane(int k) const { return x + (long long)k * npix; }
  __device__ T& slot(int s, long long b) const {
    return scal[(long long)s * B + b];
  }
};

// ---------------------------------------------------------------- CP phase

// The learner's CP step for pd_cluster_run: tvl1_cp's Huber step
// (csrc/tvl1.cu's Tvl1Step) on the learner's state, with α from x: for a
// scalar weight α and its Huber factor from shared memory (formed once a
// launch, the same operations on the same scalars as per pixel), for a
// patch grid the pixel's entry and its factor formed per pixel.
template <typename T>
struct Sl1Step {
  const SL1<T>& h;
  const T* s_alpha;   // α, its Huber factor
  int M, N, cl, rows;
  long long region;
  T* pd;
  T sigma;
  __device__ Sl1Step(const SL1<T>& h_, const T* sa)
      : h(h_), s_alpha(sa), M(h_.M), N(h_.N), cl(h_.cl), rows(h_.rows),
        region(h_.region), pd(h_.pd), sigma(h_.sigma) {}
  __device__ int K() const { return 1; }
  __device__ int kind(int) const { return STENCIL_FWD; }
  __device__ const T* u_in(long long b) const { return h.u + b * h.mn; }
  __device__ T* u_out(long long b) const { return h.u + b * h.mn; }
  __device__ T* y(int, long long b) const { return h.y + b * 2 * h.mn; }
  __device__ const T* f(long long b) const { return h.f + b * h.mn; }
  __device__ long long mn() const { return h.mn; }
  __device__ void at(int) const {}
  __device__ T alpha(int i, int j) const {
    return h.P == 1 ? s_alpha[0] : slx_alpha<T>(h, 0, i, j);
  }
  __device__ T primal(T dv, T uo, T fv, T& ub) const {
    const T un = tvl1_prox<T, true>(dv, uo, fv, h.tau, h.lo, h.den);
    ub = T(2) * un - uo;
    return un;
  }
  __device__ T scale(int, int i, int j, T n2) const {
    return ball_scale(n2, alpha(i, j));
  }
};

template <typename T>
__device__ __forceinline__ void pd_pre(const Sl1Step<T>& s, int, int i,
                                       int j, T& px, T& py) {
  const T sc = s.h.P == 1
                   ? s.s_alpha[1]
                   : huber_dual_factor(s.alpha(i, j), s.sigma, s.h.gamma);
  px = sc * px;
  py = sc * py;
}

// All n_inner CP iterations of an outer step, one image per cluster.
// RES: the bands live in shared memory (else in h.pd, laid out alike).
// Two CTAs an SM (32 KB bands at 16 CTAs an image, 128² float32).
template <typename T, bool RES>
__global__ void __launch_bounds__(PD_THREADS, PD_MINB)
sl1_pd(SL1<T> h, int n_inner) {
  extern __shared__ __align__(16) unsigned char sl1_smem[];
  __shared__ T s_alpha[2];
  if (threadIdx.x == 0) {
    s_alpha[0] = h.xk[0];
    s_alpha[1] = huber_dual_factor(h.xk[0], h.sigma, h.gamma);
  }
  Sl1Step<T> step(h, s_alpha);
  pd_cluster_run<T, RES>(step, sl1_smem, n_inner);
}

// ------------------------------------------------------------ the CG blocks

// A CG block (blockIdx.x, image blockIdx.y) works on the 256 pixels
// [p0, p0 + 256), p0 = 256·blockIdx.x, of its image: one partial block of
// the parent design.  Thread t takes pixel p0 + t.  H at pixel k reads
// pixels k − N … k + N.  Band position q ∈ [0, SB) stands for pixel
// kk(q) = (p0 + q − 1) mod M·N (thread t's at q = t + 1); band A holds
// pixel kk(q) − N, band C kk(q), band B kk(q) + N.  Where a stencil reads
// k ± 1 it reads the adjacent position, whose pixel is k ± 1 wherever the
// mask lets the read happen (not at a row's end).  Pixels outside the
// image hold 0 and are never read.
#define SB (BPL_THREADS + 2)
enum Sl1Band { BAND_A, BAND_C, BAND_B };

template <typename T>
struct Sl1Tile {
  T d[3][SB];      // the operand [band][q]
  T wx[2][SB];     // W's row component on bands C (0) and A (1)
  T wy[SB];        // W's column component on band C
  int pi[SB], pj[SB];   // (i, j) of kk(q)
  T sh[BPL_THREADS];
};

// Fills the tile's (i, j) table and the operand on the three bands: v(g)
// is the operand at flat element g = b·MN + pixel.
template <typename T, typename V>
__device__ __forceinline__ void sl1_bands(const SL1<T>& h, Sl1Tile<T>& s,
                                          V v) {
  const long long b = blockIdx.y;
  const int mn = (int)h.mn;             // M·N < 2³¹ (pd_plan_ok)
  const int p0 = (int)blockIdx.x * BPL_THREADS;
  for (int q = threadIdx.x; q < SB; q += BPL_THREADS) {
    const int e = p0 + q - 1;
    const int kk = e < 0 ? e + mn : e % mn;
    s.pi[q] = kk / h.N;
    s.pj[q] = kk % h.N;
  }
  __syncthreads();
  for (int x = threadIdx.x; x < 3 * SB; x += BPL_THREADS) {
    const int band = x / SB, q = x % SB;
    const int i = s.pi[q] + band - 1;
    T val = T(0);
    if (i >= 0 && i < h.M) val = v(b * h.mn + (long long)i * h.N + s.pj[q]);
    s.d[band][q] = val;
  }
  __syncthreads();
}

// The fields of the system at a pixel: Gu, act, 1/den and (1/den)³, as
// build_reg_system forms them.
template <typename T>
struct Sl1Field {
  T ux, uy, act, iden, iden3;
};

// W = α(γ·inact·∇d + act·(∇d/den − Gu(Gu·∇d)/den³)) at the band position
// (which, q) (which 0: band C, 1: band A) of pixel (i, j), ∇d from the
// tile, in the plain version's order.
template <typename T>
__device__ __forceinline__ void sl1_w(const SL1<T>& h, Sl1Tile<T>& s,
                                      int which, int q, int i, int j,
                                      const Sl1Field<T>& fd) {
  const int band = which == 0 ? BAND_C : BAND_A;
  const T* dc = s.d[band];
  const T gx = i < h.M - 1 ? s.d[band + 1][q] - dc[q] : T(0);
  const T gy = j < h.N - 1 ? dc[q + 1] - dc[q] : T(0);
  const T d3 = (fd.ux * gx + fd.uy * gy) * fd.iden3;
  const T cx = gx * fd.iden - fd.ux * d3;
  const T cy = gy * fd.iden - fd.uy * d3;
  const T gi = h.gamma * (T(1) - fd.act);
  const T a = slx_alpha<T>(h, 0, i, j);
  s.wx[which][q] = a * (gi * gx + fd.act * cx);
  if (which == 0) s.wy[q] = a * (gi * gy + fd.act * cy);
}

// The band positions whose W the block's pixels read: band C at
// 0 … SB − 2 (both components), band A at 1 … SB − 2 (the row component);
// fn(which, q, i, j) for each that lies in the image.
template <typename T, typename F>
__device__ __forceinline__ void sl1_wpos(const SL1<T>& h,
                                         const Sl1Tile<T>& s, F fn) {
  for (int x = threadIdx.x; x < 2 * SB; x += BPL_THREADS) {
    const int which = x / SB, q = x % SB;
    if (q > SB - 2 || (which == 1 && q < 1)) continue;
    const int i = s.pi[q] - which, j = s.pj[q];
    if (i < 0) continue;
    fn(which, q, i, j);
  }
}

// H v at the thread's position q from the tile (v on band C, W), and D:
// v + ∇ᵀW (adj1 along rows + adj1 along columns), then + (D − 1)·v, in
// the plain version's order.
template <typename T>
__device__ __forceinline__ T sl1_hv(const SL1<T>& h, const Sl1Tile<T>& s,
                                    int q, T dfac) {
  const int i = s.pi[q], j = s.pj[q];
  const T rows = (i >= 1 ? s.wx[1][q] : T(0))
                 - (i < h.M - 1 ? s.wx[0][q] : T(0));
  const T cols = (j >= 1 ? s.wy[q - 1] : T(0))
                 - (j < h.N - 1 ? s.wy[q] : T(0));
  const T vv = s.d[BAND_C][q];
  T mv = vv + (rows + cols);
  mv = mv + (dfac - T(1)) * vv;
  return mv;
}

// The system at u, its Jacobi diagonal, H·p and the CG start: r = (ū − u)
// − Hp, z = r/diag, ρ = (r, z) per image.  The fields are formed from u on
// the bands and stored at the block's own pixels, with D and the
// diagonal.
template <typename T>
__global__ void __launch_bounds__(BPL_THREADS) sl1_init(SL1<T> h) {
  __shared__ Sl1Tile<T> s;
  __shared__ T jx[2][SB], jy[SB];   // the Jacobi weights, as wx and wy
  const long long b = blockIdx.y;
  const int q = threadIdx.x + 1;
  const long long p0 = (long long)blockIdx.x * BPL_THREADS;
  sl1_bands(h, s, [&](long long g) { return h.p[g]; });
  sl1_wpos(h, s, [&](int which, int qq, int i, int j) {
    const long long k = (long long)i * h.N + j;
    T gx, gy;
    grad_k((const T*)h.u + b * h.mn, k, pix(b, i, j), h.M, h.N, STENCIL_FWD,
           gx, gy);
    const T nG = sqrt(gx * gx + gy * gy);
    Sl1Field<T> fd;
    fd.ux = gx;
    fd.uy = gy;
    fd.act = nG > T(1) / h.gamma ? T(1) : T(0);
    const T gi = h.gamma * (T(1) - fd.act);
    const T den = fd.act > T(0) ? nG : T(1);
    fd.iden = T(1) / den;
    const T rden3 = T(1) / (den * den * den);
    fd.iden3 = fd.iden * fd.iden * fd.iden;
    const T a = slx_alpha<T>(h, 0, i, j);
    jx[which][qq] = a * (gi + fd.act * (fd.iden - (gx * gx) * rden3));
    if (which == 0) jy[qq] = a * (gi + fd.act * (fd.iden - (gy * gy) * rden3));
    sl1_w(h, s, which, qq, i, j, fd);
    // the block's own pixels' fields, for the later launches
    if (which == 0 && qq >= 1 && qq <= BPL_THREADS && p0 + qq - 1 < h.mn) {
      const long long at = b * h.mn + k;
      h.xplane(X_GUX)[at] = fd.ux;
      h.xplane(X_GUY)[at] = fd.uy;
      h.xplane(X_ACT)[at] = fd.act;
      h.xplane(X_IDEN)[at] = fd.iden;
      h.xplane(X_IDEN3)[at] = fd.iden3;
    }
  });
  __syncthreads();
  T rz = T(0);
  const long long e = p0 + threadIdx.x;
  if (e < h.mn) {
    const int i = s.pi[q], j = s.pj[q];
    // 1 + the Gram diagonal (rows, then columns), then
    // max(1/(1/diag) + (D − 1), 1e-12), as solvers/tvl1_huber.py forms it
    const T gr = (i >= 1 ? jx[1][q] : T(0)) + (i < h.M - 1 ? jx[0][q] : T(0));
    const T gc = (j >= 1 ? jy[q - 1] : T(0)) + (j < h.N - 1 ? jy[q] : T(0));
    const T diag0 = T(1) + (gr + gc);
    const T inv = T(1) / diag0;
    const long long g = b * h.mn + e;
    const T dfac = fabs(h.u[g] - h.f[g]) <= h.inv_gd ? h.gamma_d : T(0);
    const T dg = T(1) / inv + (dfac - T(1));
    const T diag = dg > T(1e-12) ? dg : T(1e-12);
    const T mv = sl1_hv(h, s, q, dfac);
    const T res = (h.ut[g] - h.u[g]) - mv;
    const T z = res / diag;
    h.xplane(X_DFAC)[g] = dfac;
    h.xplane(X_DIAG)[g] = diag;
    h.eplane(E_R)[g] = res;
    h.eplane(E_Z)[g] = z;
    rz = res * z;
  }
  slx_partial<T>(h, blockIdx.x, rz, s.sh);
  T sum;
  if (slx_image_sum<T>(h, &sum, s.sh) && threadIdx.x == 0)
    h.slot(T_RZ, b) = sum;
}

// CG step k, the operator: d = z (k = 0) or z + βd on the bands (the own
// pixels' stored for the update), H·d and the image sums of d·Hd; the
// image's last block forms a = ρ/(d·Hd).
template <typename T>
__global__ void __launch_bounds__(BPL_THREADS) sl1_apply(SL1<T> h, int k) {
  __shared__ Sl1Tile<T> s;
  const long long b = blockIdx.y;
  const int q = threadIdx.x + 1;
  const T beta = k > 0 ? h.slot(T_BETA, b) : T(0);
  const T* z = h.eplane(E_Z);
  const T* d_old = h.eplane(k % 2 ? E_D0 : E_D1);
  T* d_new = h.eplane(k % 2 ? E_D1 : E_D0);
  sl1_bands(h, s, [&](long long g) {
    return k == 0 ? z[g] : z[g] + beta * d_old[g];
  });
  sl1_wpos(h, s, [&](int which, int qq, int i, int j) {
    const long long at = b * h.mn + (long long)i * h.N + j;
    Sl1Field<T> fd;
    fd.ux = h.xplane(X_GUX)[at];
    fd.uy = h.xplane(X_GUY)[at];
    fd.act = h.xplane(X_ACT)[at];
    fd.iden = h.xplane(X_IDEN)[at];
    fd.iden3 = h.xplane(X_IDEN3)[at];
    sl1_w(h, s, which, qq, i, j, fd);
  });
  __syncthreads();
  T dmd = T(0);
  const long long e = (long long)blockIdx.x * BPL_THREADS + threadIdx.x;
  if (e < h.mn) {
    const long long g = b * h.mn + e;
    const T mv = sl1_hv(h, s, q, h.xplane(X_DFAC)[g]);
    const T dv = s.d[BAND_C][q];
    d_new[g] = dv;
    h.eplane(E_MD)[g] = mv;
    dmd = dv * mv;
  }
  slx_partial<T>(h, blockIdx.x, dmd, s.sh);
  T sum;
  if (slx_image_sum<T>(h, &sum, s.sh) && threadIdx.x == 0)
    h.slot(T_A, b) = h.slot(T_RZ, b) / nz(sum);
}

// CG step k, the update: p += a d; r −= a Hd; z = r/diag; the image's last
// block forms β = ρ_new/ρ and ρ ← ρ_new.
template <typename T>
__global__ void __launch_bounds__(BPL_THREADS) sl1_update(SL1<T> h, int k) {
  __shared__ T sh[BPL_THREADS];
  const long long b = blockIdx.y;
  const T a = h.slot(T_A, b);
  const T* d = h.eplane(k % 2 ? E_D1 : E_D0);
  T rz = T(0);
  const long long e = (long long)blockIdx.x * BPL_THREADS + threadIdx.x;
  if (e < h.mn) {
    const long long g = b * h.mn + e;
    h.p[g] = h.p[g] + a * d[g];
    const T res = h.eplane(E_R)[g] - a * h.eplane(E_MD)[g];
    const T z = res / h.xplane(X_DIAG)[g];
    h.eplane(E_R)[g] = res;
    h.eplane(E_Z)[g] = z;
    rz = res * z;
  }
  slx_partial<T>(h, blockIdx.x, rz, sh);
  T sum;
  if (slx_image_sum<T>(h, &sum, sh) && threadIdx.x == 0) {
    h.slot(T_BETA, b) = sum / nz(h.slot(T_RZ, b));
    h.slot(T_RZ, b) = sum;
  }
}

// ------------------------------------------------------------------ the tail

// One thread per pixel (i, j) of the plane: Σ_b ∇p·((act/den)·Gu +
// (γ·inact)·Gu), summed over the batch in order; block
// partials of Σ_b (u − ū)².
template <typename T>
__global__ void __launch_bounds__(BPL_THREADS) sl1_gmap(SL1<T> h) {
  __shared__ T sh[BPL_THREADS];
  const long long ij = (long long)blockIdx.x * BPL_THREADS + threadIdx.x;
  T c = T(0);
  if (ij < h.mn) {
    Pix p;
    p.i = (int)(ij / h.N);
    p.j = (int)(ij % h.N);
    T acc = T(0);
    for (int b = 0; b < h.B; ++b) {
      const long long idx = (long long)b * h.mn + ij;
      p.b = b;
      T gx, gy;
      grad_k((const T*)h.p, idx, p, h.M, h.N, STENCIL_FWD, gx, gy);
      const T ux = h.xplane(X_GUX)[idx], uy = h.xplane(X_GUY)[idx];
      const T act = h.xplane(X_ACT)[idx];
      const T sv = act > T(0) ? h.xplane(X_IDEN)[idx] : T(0);   // act/den
      const T gi = h.gamma * (T(1) - act);
      const T g = gx * (sv * ux + gi * ux) + gy * (sv * uy + gi * uy);
      acc = b == 0 ? g : acc + g;
      const T d = h.u[idx] - h.ut[idx];
      c += d * d;
    }
    h.gmap[ij] = acc;
  }
  T s = block_sum(c, sh);
  if (threadIdx.x == 0) h.cost_part[blockIdx.x] = s;
}

// ------------------------------------------------------------------ the host

// The CP launch (checked against the card first, where the call runs the
// local part) and the launches of `parts` (SlxParts) of steps o0 … o1 − 1.
template <typename T>
int sl1_loop(const SL1<T>& h, int resident, int o0, int o1, int parts,
             int n_inner, int n_adj, int* n_launched, cudaStream_t s) {
  PdClusterLaunch<void (*)(SL1<T>, int)> L;
  void (*kern)(SL1<T>, int) = resident ? sl1_pd<T, true> : sl1_pd<T, false>;
  int err;
  if (parts & SLX_LOCAL) {
    err = pd_cluster_prepare(
        L, kern, h.B, h.cl, resident ? (size_t)h.region * sizeof(T) : 0, s);
    if (err != (int)cudaSuccess) return err;
  }
  const dim3 tiles((unsigned)h.bpt, (unsigned)h.B);
  int nl = 0;
  if ((parts & SLX_BEGIN) && h.outer > 0) {
    slx_begin<T, 1><<<1, BPL_THREADS, 0, s>>>(h);
    ++nl;
  }
  for (int o = o0; o < o1; ++o) {
    if (parts & SLX_LOCAL) {
      if (n_inner > 0) {
        cudaError_t e = cudaLaunchKernelEx(&L.cfg, L.kern, h, n_inner);
        if (e != cudaSuccess) return (int)e;
        ++nl;
      }
      sl1_init<T><<<tiles, BPL_THREADS, 0, s>>>(h);
      ++nl;
      for (int k = 0; k < n_adj; ++k) {
        sl1_apply<T><<<tiles, BPL_THREADS, 0, s>>>(h, k);
        sl1_update<T><<<tiles, BPL_THREADS, 0, s>>>(h, k);
        nl += 2;
      }
      BPL_LAUNCH(sl1_gmap<T>, h.nb_mn, BPL_THREADS, s)(h);
      ++nl;
    }
    if (parts & SLX_UPDATE) {
      slx_pull_adam<T, 1, SL1<T>, true><<<h.P, BPL_THREADS, 0, s>>>(h, o);
      ++nl;
    }
    if ((err = (int)cudaGetLastError()) != (int)cudaSuccess) return err;
  }
  *n_launched = nl;
  return (int)cudaGetLastError();
}

template <typename T>
int sl_tvl1_entry(const T* f, const T* ut, T* u, T* y, T* p, T* zmv, T* t,
                  T* traj_x, T* traj_cost, T* traj_gnorm, T* scratch,
                  long long B, int M, int N, int pm, int pn, int cl,
                  int rows, int resident, int outer, int o0, int o1,
                  int parts, int n_inner, int n_adj, T tau, T sigma,
                  T gamma_r, T lo, T den, T gamma_d, T inv_gd, T lr, T beta1,
                  T beta2, T omb1, T omb2, T eps, T clip, int* n_launched,
                  cudaStream_t s) {
  *n_launched = 0;
  if (sl_bad_args(B, M, N, pm, pn, outer, n_inner, n_adj)
      || slx_bad_steps(o0, o1, parts, outer) || B > 65535
      || !pd_plan_ok(M, N, 1, cl, rows) || B * cl > 0x7fffffffLL
      || (long long)M * pm > 0x7fffffffLL
      || (long long)N * pn > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const Sl1Sizes z = sl1_sizes(B, M, N, pm * pn, cl, rows, resident);
  SL1<T> h;
  h.f = f;
  h.ut = ut;
  h.u = u;
  h.y = y;
  h.p = p;
  h.zmv = zmv;
  h.t = t;
  h.traj_x = traj_x;
  h.traj_cost = traj_cost;
  h.traj_gnorm = traj_gnorm;
  h.e = scratch;
  h.x = h.e + z.eplanes;
  h.gmap = h.x + z.xplanes;
  h.xk = h.gmap + z.gmap;
  h.gx = h.xk + z.kp;
  h.part = h.gx + z.kp;
  h.cost_part = h.part + z.part;
  h.scal = h.cost_part + z.cost_part;
  h.pd = h.scal + z.scal;
  h.count = reinterpret_cast<unsigned*>(h.pd + z.pd);
  h.mn = (long long)M * N;
  h.npix = B * h.mn;
  h.region = pd_region(1, rows, N);
  h.B = (int)B;
  h.M = M;
  h.N = N;
  h.pm = pm;
  h.pn = pn;
  h.P = pm * pn;
  h.bpt = z.bpt;
  h.nb_mn = z.nb_mn;
  h.outer = outer;
  h.cl = cl;
  h.rows = rows;
  h.tau = tau;
  h.sigma = sigma;
  h.gamma = gamma_r;
  h.lo = lo;
  h.den = den;
  h.gamma_d = gamma_d;
  h.inv_gd = inv_gd;
  h.lr = lr;
  h.beta1 = beta1;
  h.beta2 = beta2;
  h.omb1 = omb1;
  h.omb2 = omb2;
  h.eps = eps;
  h.clip = clip;
  return sl1_loop<T>(h, resident, o0, o1, parts, n_inner, n_adj, n_launched,
                     s);
}

}  // namespace bpl

extern "C" {

long long bpl_sl_tvl1_scratch(long long B, int M, int N, int P, int cl,
                              int rows, int resident) {
  return bpl::sl1_sizes(B, M, N, P, cl, rows, resident).total;
}

void bpl_sl_tvl1_mesh_parts(long long B, int M, int N, int P, int cl,
                            int rows, int resident, long long* out) {
  bpl::slx_mesh_parts(bpl::sl1_sizes(B, M, N, P, cl, rows, resident), out);
}

#define BPL_SL_TVL1(SUFFIX, T)                                               \
  int bpl_sl_tvl1_##SUFFIX(const T* f, const T* ut, T* u, T* y, T* p,        \
                           T* zmv, T* t, T* traj_x, T* traj_cost,            \
                           T* traj_gnorm, T* scratch, long long B, int M,    \
                           int N, int pm, int pn, int cl, int rows,          \
                           int resident, int outer, int o0, int o1,          \
                           int parts, int n_inner, int n_adj, T tau,         \
                           T sigma, T gamma_r, T lo, T den, T gamma_d,       \
                           T inv_gd, T lr, T beta1, T beta2, T omb1, T omb2, \
                           T eps, T clip, int* n_launched, void* stream) {   \
    return bpl::sl_tvl1_entry<T>(f, ut, u, y, p, zmv, t, traj_x, traj_cost,  \
                                 traj_gnorm, scratch, B, M, N, pm, pn, cl,   \
                                 rows, resident, outer, o0, o1, parts,       \
                                 n_inner, n_adj, tau, sigma, gamma_r, lo,    \
                                 den, gamma_d, inv_gd, lr, beta1, beta2,     \
                                 omb1, omb2, eps, clip, n_launched,          \
                                 (cudaStream_t)stream);                      \
  }

BPL_SL_TVL1(f32, float)
BPL_SL_TVL1(f64, double)

}  // extern "C"
