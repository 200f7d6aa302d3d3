// The single-loop TGV² learner: TPU kernel 11.
//
// Replaces bpldenoising_tpu/bilevel/first_order_tgv_pallas.py::_kernel (the
// one-launch learner on one image with a (2,) weight, all state in VMEM).
// Per outer step, on a batch of B images with a (2,) weight or an
// (m, n, 2) patch stack (bilevel/first_order_tgv.py, the jnp scan's order):
//   x = exp(z) (the α trajectory), (α₁, α₀) per pixel from the patch grid;
//   n_inner joint-CP steps (solvers/tgv.py::_step; tgv.cuh's arithmetic);
//   the γ-Huber smoothed joint system at (u, w) (solvers/tgv.py::
//     _build_joint_system): y = ∇u − w, z = Ew, s = 1/max(|·|, γ), the
//     mask |·| ≥ γ, the Jacobi diagonal [1 + gram(α₁s_y), α₁s_y + e_r,
//     α₁s_y + e_c];  H(du, dw) = (du + ∇ᵀ(α₁Dψ_y(∇du − dw)),
//     −α₁Dψ_y(∇du − dw) + Eᵀ(α₀Dψ_z(E dw))),  Dψ(d) = s·d − y·(mask·(y·d)·s³);
//   n_adj Jacobi-CG steps on H λ = (ū − u, 0, 0) from the warm λ, inner
//     products per image over its 3 planes (cg_batched(item_ndim=3, tol=0));
//   g₁ = Σ_b ψ_y·(∇λᵤ − λ_w), g₀ = Σ_b ψ_z·Eλ_w per pixel, pulled back per
//     patch; Adam on log(α₁, α₀).
// The arithmetic is the plain version's (the product order of
// _build_joint_system and _dpsi, s³ as s·s·s), not the Pallas kernel's
// plane-form rewrite; built with -fmad=false.
//
// What bounds it on an H100.  At 128² every step of the loop is a few
// microseconds of device work or less (a CP iteration ~70 operations a
// pixel, an H·v ~62), so a design with one launch per half-step (151 a
// step) is paced by launch issue.  This design:
//
//  * CP phase, one launch per outer step (slt_pd): a thread-block cluster
//    per image, each CTA a band of rows of the 11 TGV² planes in shared
//    memory for all n_inner iterations, one cluster barrier per iteration
//    (csrc/tgv_cluster.cuh).  The host (solvers/cluster_plan.py::tgv_plan)
//    picks the CTAs per image and rows per CTA; where the bands do not fit
//    in shared memory the same kernel keeps them in a global scratch laid
//    out alike (`resident` 0).
//  * Adjoint CG, two launches per step (slt_apply, slt_update).  The inner
//    products keep the parent design's partial trees: one block_sum per
//    256 consecutive elements of an image's 3·M·N vector, the image's
//    partials summed by its last block (an integer counter, no float
//    atomics) in a fixed order (thread t adds partials t, t + 256, …,
//    then one block_sum), the CG scalars left on the device.  A
//    CG block takes one such partial block (any shape) or, where M·N is a
//    multiple of 256, the three that hold the same 256 pixels of the three
//    planes (M·N/256 blocks an image, so every pixel's operand and weights
//    are formed once for its three elements, not three times); the host
//    (bilevel/first_order_tgv_cuda.py::cg_slots) takes the second where its
//    grid still gives every SM a block.  The operator launch
//    forms the direction d = z + βd (double-buffered planes) on three bands
//    of pixels (the block's, one row up, one row down) in shared memory,
//    α₁Dψ_y(∇du − dw) and α₀Dψ_z(E dw) on them, then ∇ᵀ and Eᵀ.  The system
//    set-up, the Jacobi diagonal, H·λ and the CG start are one launch
//    (slt_init; its fields are formed from u and w on the bands and stored
//    per pixel for the later launches).
//  * The tail: the gradient maps and cost partials (slt_gmap), then the
//    per-patch pullback whose last block runs Adam and forms the next
//    step's exp(z) (single_loop.cuh's slx_pull_adam).
//
// Launches per outer step: 4 + 2·n_adj (24 at n_adj = 10), and one per
// segment (slx_begin).
#include "single_loop.cuh"
#include "tgv_cluster.cuh"

namespace bpl {

// B·3·M·N CG element planes, in λ's (B, 3, M, N) layout: the Jacobi
// diagonal, r, z = r/diag, d (even and odd steps), H·d.
enum SltEPlane { E_DIAG, E_R, E_Z, E_D0, E_D1, E_MD, N_EPLANES };
// B·M·N pixel planes of the system at (u, w): y (2), z = Ew (3), s_y, the
// mask of y, s_z, the mask of z.
enum SltXPlane { X_Y = 0, X_Z = 2, X_SY = 5, X_MY, X_SZ, X_MZ, N_XPLANES };
// per-image device scalars
enum SltSlot { T_RZ, T_A, T_BETA, N_TSLOTS };

// Element counts of the scratch buffer's parts (of T, but `counters`).
struct SltSizes {
  long long eplanes, xplanes, gmap, kp, part, cost_part, scal, pd, counters,
      total;
  int bpt, nb_mn;
};

static SltSizes slt_sizes(long long B, int M, int N, int P, int cl,
                          int rows, int resident) {
  SltSizes z;
  const long long mn = (long long)M * N;
  z.bpt = blocks_for(3 * mn);
  z.nb_mn = blocks_for(mn);
  z.eplanes = (long long)N_EPLANES * 3 * B * mn;
  z.xplanes = (long long)N_XPLANES * B * mn;
  z.gmap = 2 * mn;
  z.kp = 2LL * P;
  z.part = B * z.bpt;
  z.cost_part = z.nb_mn;
  z.scal = (long long)N_TSLOTS * B;
  z.pd = resident ? 0 : B * cl * tgv_region(rows, N);
  // B + 1 unsigned counters, in whole elements of T
  z.counters = B + 1;
  z.total = z.eplanes + z.xplanes + z.gmap + 2 * z.kp + z.part
            + z.cost_part + z.scal + z.pd + z.counters;
  return z;
}

template <typename T>
struct SLT {
  const T* f;
  const T* ut;
  T* u;          // the CP state: (B, M, N)
  T* w;          // (B, 2, M, N)
  T* p;          // (B, 2, M, N)
  T* q;          // (B, 3, M, N)
  T* lam;        // λ: (B, 3, M, N)
  T* zmv;        // z, Adam m, Adam v: 3 × 2 × P
  T* t;          // step counter
  T* traj_x;     // (outer, 2, P)
  T* traj_cost;
  T* traj_gnorm;
  T* e;          // SltEPlane planes
  T* x;          // SltXPlane planes
  T* gmap;       // 2 × M·N
  T* xk;         // exp(z): 2 × P
  T* gx;         // the pulled-back gradient: 2 × P
  T* part;       // B × bpt block partials
  T* cost_part;  // nb_mn
  T* scal;       // N_TSLOTS × B
  T* pd;         // the CP bands in global memory (resident 0)
  unsigned* count;  // per image, then the pullback's
  long long mn, npix, ncg, region;   // ncg = 3·M·N, an image's CG vector
  int B, M, N, pm, pn, P, bpt, nb_mn, outer, cl, rows;
  T tau, sigma, gamma, lr, beta1, beta2, omb1, omb2, eps;
  __device__ T* eplane(int k) const { return e + (long long)k * B * ncg; }
  __device__ T* xplane(int k) const { return x + (long long)k * npix; }
  __device__ T& slot(int s, long long b) const {
    return scal[(long long)s * B + b];
  }
};

// ---------------------------------------------------------------- CP phase

// The learner's CP step for tgv_cluster_run: its state, f, and (α₁, α₀)
// from x (in shared memory for a (2,) weight).
template <typename T>
struct SltStep {
  const SLT<T>& h;
  const T* s_alpha;
  int M, N, cl, rows;
  long long region;
  T* pd;
  T tau, sigma;
  __device__ SltStep(const SLT<T>& h_, const T* sa)
      : h(h_), s_alpha(sa), M(h_.M), N(h_.N), cl(h_.cl), rows(h_.rows),
        region(h_.region), pd(h_.pd), tau(h_.tau), sigma(h_.sigma) {}
  __device__ T* u(long long b) const { return h.u + b * h.mn; }
  __device__ T* u_out(long long b) const { return u(b); }
  __device__ T* w(long long b) const { return h.w + b * 2 * h.mn; }
  __device__ T* p(long long b) const { return h.p + b * 2 * h.mn; }
  __device__ T* q(long long b) const { return h.q + b * 3 * h.mn; }
  __device__ const T* f(long long b) const { return h.f + b * h.mn; }
  __device__ long long mn() const { return h.mn; }
  __device__ T a1(int i, int j) const {
    return h.P == 1 ? s_alpha[0] : slx_alpha<T>(h, 0, i, j);
  }
  __device__ T a0(int i, int j) const {
    return h.P == 1 ? s_alpha[1] : slx_alpha<T>(h, 1, i, j);
  }
};

// All n_inner CP iterations of an outer step, one image per cluster.
// RES: the bands live in shared memory (else in h.pd, laid out alike).
// Two CTAs an SM in float32 (88 KB bands at 16 CTAs an image); in float64
// one (176 KB), so the register bound is 128.
template <typename T, bool RES>
__global__ void __launch_bounds__(PD_THREADS, sizeof(T) == 4 ? PD_MINB : 1)
slt_pd(SLT<T> h, int n_inner) {
  extern __shared__ __align__(16) unsigned char slt_smem[];
  __shared__ T s_alpha[2];
  if (threadIdx.x < 2) s_alpha[threadIdx.x] = h.xk[threadIdx.x];
  SltStep<T> step(h, s_alpha);
  tgv_cluster_run<T, RES>(step, slt_smem, n_inner);
}

// ------------------------------------------------------------ the CG blocks

// A CG block (blockIdx.x, image blockIdx.y) works on NS slots of 256
// elements of the image's 3·M·N vector (λ's layout), each slot one of the
// parent design's partial blocks, 256 consecutive elements:
//   NS = 1, any shape: the slot [e0, e0 + 256), e0 = 256·blockIdx.x,
//     whatever planes its elements lie in;
//   NS = 3, M·N a multiple of 256 (the host's cg_slots): pixels
//     [p0, p0 + 256), p0 = 256·blockIdx.x, in each plane, the partial
//     blocks p0/256 + c·M·N/256, so the three planes share their bands.
// Thread t takes element t of each slot.  H at (plane c, pixel k) reads
// pixels k − N … k + N.  Band position q ∈ [0, SB) stands for pixel
// kk(q) = (256·blockIdx.x + q − 1) mod M·N (thread t's at q = t + 1); band
// A holds pixel kk(q) − N, band C kk(q), band B kk(q) + N, of each plane.
// Where a stencil reads k ± 1 it reads the adjacent position, whose pixel
// is k ± 1 wherever the mask lets the read happen (not at a row's end, so
// not where an NS = 1 slot's elements pass into another plane).  Pixels
// outside the image hold 0 and are never read.
#define SB (BPL_THREADS + 2)
enum SltBand { BAND_A, BAND_C, BAND_B };

template <typename T>
struct SltTile {
  T d[3][3][SB];     // the operand [band][plane u, w_r, w_c][q]
  T hy[2][2][SB];    // α₁Dψ_y(∇d_u − d_w) on bands C (0) and A (1)
  T hz[2][3][SB];    // α₀Dψ_z(E d_w) on bands C (0) and B (1)
  int pi[SB], pj[SB];   // (i, j) of kk(q)
  T sh[BPL_THREADS];
};

// The first element of slot r of this block in the image's CG vector (a
// multiple of 256: its partial block is this / 256).
template <int NS, typename T>
__device__ __forceinline__ long long slt_slot(const SLT<T>& h, int r) {
  const long long p0 = (long long)blockIdx.x * BPL_THREADS;
  return NS == 1 ? p0 : r * h.mn + p0;
}

// The fields of the joint system at pixel k of image b: y = ∇u − w with
// s_y and its mask, z = Ew with s_z and its mask.  SETUP forms them from u
// and w (slt_init), else reads the planes slt_init stored.
template <typename T>
__device__ __forceinline__ void slt_huber(T n, T gamma, T& s, T& m) {
  s = T(1) / (n < gamma ? gamma : n);
  m = n >= gamma ? T(1) : T(0);
}

template <typename T, bool SETUP>
__device__ __forceinline__ void slt_yfield(const SLT<T>& h, long long b,
                                           long long k, Pix p, T& yr, T& yc,
                                           T& sy, T& my) {
  const long long at = b * h.mn + k;
  if (!SETUP) {
    yr = h.xplane(X_Y)[at];
    yc = h.xplane(X_Y + 1)[at];
    sy = h.xplane(X_SY)[at];
    my = h.xplane(X_MY)[at];
    return;
  }
  const T* wr = h.w + b * 2 * h.mn;
  const T* wc = wr + h.mn;
  T gx, gy;
  grad_k((const T*)h.u + b * h.mn, k, p, h.M, h.N, STENCIL_FWD, gx, gy);
  yr = gx - wr[k];
  yc = gy - wc[k];
  slt_huber(sqrt(yr * yr + yc * yc), h.gamma, sy, my);
}

template <typename T, bool SETUP>
__device__ __forceinline__ void slt_zfield(const SLT<T>& h, long long b,
                                           long long k, Pix p, T& z0, T& z1,
                                           T& z2, T& sz, T& mz) {
  const long long at = b * h.mn + k;
  if (!SETUP) {
    z0 = h.xplane(X_Z)[at];
    z1 = h.xplane(X_Z + 1)[at];
    z2 = h.xplane(X_Z + 2)[at];
    sz = h.xplane(X_SZ)[at];
    mz = h.xplane(X_MZ)[at];
    return;
  }
  const T* wr = h.w + b * 2 * h.mn;
  sym_grad_bwd(wr, wr + h.mn, k, p, h.N, z0, z1, z2);
  slt_huber(sqrt((z0 * z0 + z1 * z1) + z2 * z2), h.gamma, sz, mz);
}

// Fills the tile's (i, j) table and the operand on the three bands:
// v(g) is the operand at flat element g = b·3MN + c·MN + pixel.
template <typename T, typename V>
__device__ __forceinline__ void slt_bands(const SLT<T>& h, SltTile<T>& s,
                                          V v) {
  const long long b = blockIdx.y;
  const long long p0 = (long long)blockIdx.x * BPL_THREADS;
  for (int q = threadIdx.x; q < SB; q += BPL_THREADS) {
    long long kk = (p0 + q - 1) % h.mn;
    kk = kk < 0 ? kk + h.mn : kk;
    s.pi[q] = (int)(kk / h.N);
    s.pj[q] = (int)(kk % h.N);
  }
  __syncthreads();
  for (int x = threadIdx.x; x < 9 * SB; x += BPL_THREADS) {
    const int bc = x / SB, q = x % SB;
    const int band = bc / 3, c = bc % 3;
    const int i = s.pi[q] + band - 1;
    T val = T(0);
    if (i >= 0 && i < h.M)
      val = v(b * h.ncg + (long long)c * h.mn + (long long)i * h.N
              + s.pj[q]);
    s.d[band][c][q] = val;
  }
  __syncthreads();
}

// Whether the block holds elements of plane 0 (need_a: the weights one row
// up) and of planes 1 and 2 (need_z: Ew's weights).
template <int NS, typename T>
__device__ __forceinline__ void slt_need(const SLT<T>& h, bool& need_a,
                                         bool& need_z) {
  if (NS == 3) {
    need_a = need_z = true;
    return;
  }
  const long long e0 = slt_slot<NS>(h, 0);
  const long long e1 = e0 + BPL_THREADS < h.ncg ? e0 + BPL_THREADS : h.ncg;
  need_a = e0 < h.mn;
  need_z = e1 > h.mn;
}

// The weights on the bands: α₁Dψ_y(∇d_u − d_w) on band C (positions
// 0 … SB − 2) and, with need_a, band A (1 … SB − 2); with need_z,
// α₀Dψ_z(E d_w) on band C (1 … SB − 1) and band B (1 … SB − 2).  The
// products in the parent design's order.
template <typename T, bool SETUP>
__device__ __forceinline__ void slt_weights(const SLT<T>& h, SltTile<T>& s,
                                            bool need_a, bool need_z) {
  const long long b = blockIdx.y;
  for (int x = threadIdx.x; x < 4 * SB; x += BPL_THREADS) {
    const int which = x / SB, q = x % SB;
    if (which == 0 && q > SB - 2) continue;
    if (which == 1 && (!need_a || q < 1 || q > SB - 2)) continue;
    if (which == 2 && (!need_z || q < 1)) continue;
    if (which == 3 && (!need_z || q < 1 || q > SB - 2)) continue;
    const int band = which == 0 || which == 2 ? BAND_C
                     : which == 1 ? BAND_A : BAND_B;
    const int i = s.pi[q] + band - 1, j = s.pj[q];
    if (i < 0 || i >= h.M) continue;
    const long long k = (long long)i * h.N + j;
    const Pix p = pix(b, i, j);
    if (which < 2) {
      // y: ∇d_u (forward) − d_w at the pixel; the row below is band + 1
      const T* du = s.d[band][0];
      const T gx = i < h.M - 1 ? s.d[band + 1][0][q] - du[q] : T(0);
      const T gy = j < h.N - 1 ? du[q + 1] - du[q] : T(0);
      const T tr = gx - s.d[band][1][q], tc = gy - s.d[band][2][q];
      T yr, yc, sy, my;
      slt_yfield<T, SETUP>(h, b, k, p, yr, yc, sy, my);
      const T rad = (my * (yr * tr + yc * tc)) * ((sy * sy) * sy);
      const T a1 = slx_alpha<T>(h, 0, i, j);
      T* out = s.hy[which][0];
      out[q] = (sy * tr - yr * rad) * a1;
      s.hy[which][1][q] = (sy * tc - yc * rad) * a1;
    } else {
      // Ew (backward differences); the row above is band − 1
      const T* wr = s.d[band][1];
      const T* wc = s.d[band][2];
      const T e0 = i >= 1 ? wr[q] - s.d[band - 1][1][q] : T(0);
      const T e1 = j >= 1 ? wc[q] - wc[q - 1] : T(0);
      const T drc = j >= 1 ? wr[q] - wr[q - 1] : T(0);
      const T dcr = i >= 1 ? wc[q] - s.d[band - 1][2][q] : T(0);
      const T e2 = (drc + dcr) / sqrt2<T>();
      T z0, z1, z2, sz, mz;
      slt_zfield<T, SETUP>(h, b, k, p, z0, z1, z2, sz, mz);
      const T radz = (mz * ((z0 * e0 + z1 * e1) + z2 * e2))
                     * ((sz * sz) * sz);
      const T a0 = slx_alpha<T>(h, 1, i, j);
      T* out = s.hz[which - 2][0];
      out[q] = (sz * e0 - z0 * radz) * a0;
      s.hz[which - 2][1][q] = (sz * e1 - z1 * radz) * a0;
      s.hz[which - 2][2][q] = (sz * e2 - z2 * radz) * a0;
    }
  }
  __syncthreads();
}

// (H v) at plane c and position q (pixel (i, j)) from the tile's weights,
// in the parent design's order: du + ∇ᵀHY, −HY_r + (Eᵀ HZ)_r,
// −HY_c + (Eᵀ HZ)_c.
template <typename T>
__device__ __forceinline__ T slt_hv(const SLT<T>& h, const SltTile<T>& s,
                                    int c, int q) {
  const int i = s.pi[q], j = s.pj[q];
  const bool up = i >= 1, dn = i < h.M - 1, lf = j >= 1, rt = j < h.N - 1;
  if (c == 0) {
    // adj1 (forward) along rows, then along columns
    const T rows = (up ? s.hy[1][0][q] : T(0)) - (dn ? s.hy[0][0][q] : T(0));
    const T cols = (lf ? s.hy[0][1][q - 1] : T(0))
                   - (rt ? s.hy[0][1][q] : T(0));
    return s.d[BAND_C][0][q] + (rows + cols);
  }
  // (D⁻)ᵀ along rows (hz[1] is the row below) and along columns
  const int along = c == 1 ? 0 : 1;    // q_rr for w_r, q_cc for w_c
  const T rows_a = (up ? s.hz[0][along][q] : T(0))
                   - (dn ? s.hz[1][along][q] : T(0));
  const T cols_a = (lf ? s.hz[0][along][q] : T(0))
                   - (rt ? s.hz[0][along][q + 1] : T(0));
  const T rows_x = (up ? s.hz[0][2][q] : T(0)) - (dn ? s.hz[1][2][q] : T(0));
  const T cols_x = (lf ? s.hz[0][2][q] : T(0))
                   - (rt ? s.hz[0][2][q + 1] : T(0));
  if (c == 1) return -s.hy[0][0][q] + (rows_a + cols_x / sqrt2<T>());
  return -s.hy[0][1][q] + (cols_a + rows_x / sqrt2<T>());
}

// The Jacobi diagonal at plane c and position q, from α₁s_y (hy[.][0]) and
// α₀s_z (hz[.][0]) on the bands: 1 + the forward Gram of α₁s_y (rows, then
// columns) for u; α₁s_y + the backward Grams of α₀s_z for w_r, w_c.
template <typename T>
__device__ __forceinline__ T slt_diag(const SLT<T>& h, const SltTile<T>& s,
                                      int c, int q) {
  const int i = s.pi[q], j = s.pj[q];
  const bool up = i >= 1, dn = i < h.M - 1, lf = j >= 1, rt = j < h.N - 1;
  if (c == 0) {
    const T gr = (up ? s.hy[1][0][q] : T(0)) + (dn ? s.hy[0][0][q] : T(0));
    const T gc = (lf ? s.hy[0][0][q - 1] : T(0)) + (rt ? s.hy[0][0][q] : T(0));
    return T(1) + (gr + gc);
  }
  const T gr = (up ? s.hz[0][0][q] : T(0)) + (dn ? s.hz[1][0][q] : T(0));
  const T gc = (lf ? s.hz[0][0][q] : T(0)) + (rt ? s.hz[0][0][q + 1] : T(0));
  const T e_r = gr + T(0.5) * gc;
  const T e_c = gc + T(0.5) * gr;
  return s.hy[0][0][q] + (c == 1 ? e_r : e_c);
}

// Writes the block's partials of an image inner product (slot r's at its
// partial block); the image's last block to arrive sums the image's
// partials in a fixed order into *out and returns true (in every
// thread), else false (single_loop.cuh's slx_image_sum).
template <typename T, int NS>
__device__ __forceinline__ bool slt_image_sum(const SLT<T>& h,
                                              const T (&v)[NS], T* out,
                                              T* sh) {
#pragma unroll
  for (int r = 0; r < NS; ++r)
    slx_partial<T>(h, slt_slot<NS>(h, r) / BPL_THREADS, v[r], sh);
  return slx_image_sum<T>(h, out, sh);
}

// The system at (u, w), its Jacobi diagonal, H·λ and the CG start:
// r = (ū − u, 0, 0) − Hλ, z = r/diag, ρ = (r, z) per image.  The fields at
// the element's pixel go to the pixel planes (written by plane 0's
// elements), the diagonal to E_DIAG.
template <typename T, int NS>
__global__ void __launch_bounds__(BPL_THREADS) slt_init(SLT<T> h) {
  __shared__ SltTile<T> s;
  const long long b = blockIdx.y;
  const int q = threadIdx.x + 1;
  bool need_a, need_z;
  slt_need<NS>(h, need_a, need_z);
  slt_bands(h, s, [&](long long g) { return h.lam[g]; });
  // α₁s_y on bands C and A, α₀s_z on bands C and B (in hy[.][0], hz[.][0])
  for (int x = threadIdx.x; x < 4 * SB; x += BPL_THREADS) {
    const int which = x / SB, qq = x % SB;
    if ((which == 1 && !need_a) || (which >= 2 && !need_z)) continue;
    const int band = which == 0 || which == 2 ? BAND_C
                     : which == 1 ? BAND_A : BAND_B;
    const int i = s.pi[qq] + band - 1, j = s.pj[qq];
    if (i < 0 || i >= h.M) continue;
    const long long k = (long long)i * h.N + j;
    const Pix p = pix(b, i, j);
    if (which < 2) {
      T yr, yc, sy, my;
      slt_yfield<T, true>(h, b, k, p, yr, yc, sy, my);
      s.hy[which][0][qq] = slx_alpha<T>(h, 0, i, j) * sy;
    } else {
      T z0, z1, z2, sz, mz;
      slt_zfield<T, true>(h, b, k, p, z0, z1, z2, sz, mz);
      s.hz[which - 2][0][qq] = slx_alpha<T>(h, 1, i, j) * sz;
    }
  }
  __syncthreads();
  T diag[NS];
#pragma unroll
  for (int r = 0; r < NS; ++r) {
    const long long e = slt_slot<NS>(h, r) + threadIdx.x;
    diag[r] = e < h.ncg ? slt_diag(h, s, (int)(e / h.mn), q) : T(1);
  }
  __syncthreads();
  slt_weights<T, true>(h, s, need_a, need_z);
  T rz[NS];
  const long long pxk = (long long)s.pi[q] * h.N + s.pj[q];
#pragma unroll
  for (int r = 0; r < NS; ++r) {
    const long long e = slt_slot<NS>(h, r) + threadIdx.x;
    rz[r] = T(0);
    if (e >= h.ncg) continue;
    const int c = (int)(e / h.mn);
    const T mv = slt_hv(h, s, c, q);
    const long long g = b * h.ncg + e;
    const T rhs = c == 0 ? h.ut[b * h.mn + pxk] - h.u[b * h.mn + pxk]
                         : T(0);
    const T res = rhs - mv;
    const T z = res / diag[r];
    h.eplane(E_DIAG)[g] = diag[r];
    h.eplane(E_R)[g] = res;
    h.eplane(E_Z)[g] = z;
    rz[r] = res * z;
    if (c == 0) {
      const Pix p = pix(b, s.pi[q], s.pj[q]);
      const long long at = b * h.mn + pxk;
      T yr, yc, sy, my, z0, z1, z2, sz, mz;
      slt_yfield<T, true>(h, b, pxk, p, yr, yc, sy, my);
      slt_zfield<T, true>(h, b, pxk, p, z0, z1, z2, sz, mz);
      h.xplane(X_Y)[at] = yr;
      h.xplane(X_Y + 1)[at] = yc;
      h.xplane(X_Z)[at] = z0;
      h.xplane(X_Z + 1)[at] = z1;
      h.xplane(X_Z + 2)[at] = z2;
      h.xplane(X_SY)[at] = sy;
      h.xplane(X_MY)[at] = my;
      h.xplane(X_SZ)[at] = sz;
      h.xplane(X_MZ)[at] = mz;
    }
  }
  T sum;
  if (slt_image_sum<T, NS>(h, rz, &sum, s.sh) && threadIdx.x == 0)
    h.slot(T_RZ, b) = sum;
}

// CG step k, the operator: d = z (k = 0) or z + βd on the bands (the own
// elements' stored for the update), H·d and the image sums of d·Hd; the
// image's last block forms a = ρ/(d·Hd).
template <typename T, int NS>
__global__ void __launch_bounds__(BPL_THREADS) slt_apply(SLT<T> h, int k) {
  __shared__ SltTile<T> s;
  const long long b = blockIdx.y;
  const int q = threadIdx.x + 1;
  const T beta = k > 0 ? h.slot(T_BETA, b) : T(0);
  const T* z = h.eplane(E_Z);
  const T* d_old = h.eplane(k % 2 ? E_D0 : E_D1);
  T* d_new = h.eplane(k % 2 ? E_D1 : E_D0);
  bool need_a, need_z;
  slt_need<NS>(h, need_a, need_z);
  slt_bands(h, s, [&](long long g) {
    return k == 0 ? z[g] : z[g] + beta * d_old[g];
  });
  slt_weights<T, false>(h, s, need_a, need_z);
  T dmd[NS];
#pragma unroll
  for (int r = 0; r < NS; ++r) {
    const long long e = slt_slot<NS>(h, r) + threadIdx.x;
    dmd[r] = T(0);
    if (e >= h.ncg) continue;
    const int c = (int)(e / h.mn);
    const T mv = slt_hv(h, s, c, q);
    const T dv = s.d[BAND_C][c][q];
    const long long g = b * h.ncg + e;
    d_new[g] = dv;
    h.eplane(E_MD)[g] = mv;
    dmd[r] = dv * mv;
  }
  T sum;
  if (slt_image_sum<T, NS>(h, dmd, &sum, s.sh) && threadIdx.x == 0)
    h.slot(T_A, b) = h.slot(T_RZ, b) / nz(sum);
}

// CG step k, the update: λ += a d; r −= a Hd; z = r/diag; the image's last
// block forms β = ρ_new/ρ and ρ ← ρ_new.
template <typename T, int NS>
__global__ void __launch_bounds__(BPL_THREADS) slt_update(SLT<T> h, int k) {
  __shared__ T sh[BPL_THREADS];
  const long long b = blockIdx.y;
  const T a = h.slot(T_A, b);
  const T* d = h.eplane(k % 2 ? E_D1 : E_D0);
  T rz[NS];
#pragma unroll
  for (int r = 0; r < NS; ++r) {
    const long long e = slt_slot<NS>(h, r) + threadIdx.x;
    rz[r] = T(0);
    if (e >= h.ncg) continue;
    const long long g = b * h.ncg + e;
    h.lam[g] = h.lam[g] + a * d[g];
    const T res = h.eplane(E_R)[g] - a * h.eplane(E_MD)[g];
    const T z = res / h.eplane(E_DIAG)[g];
    h.eplane(E_R)[g] = res;
    h.eplane(E_Z)[g] = z;
    rz[r] = res * z;
  }
  T sum;
  if (slt_image_sum<T, NS>(h, rz, &sum, sh) && threadIdx.x == 0) {
    h.slot(T_BETA, b) = sum / nz(h.slot(T_RZ, b));
    h.slot(T_RZ, b) = sum;
  }
}

// ------------------------------------------------------------------ the tail

// One thread per pixel (i, j) of the plane: g₁ = Σ_b ψ_y·(∇λᵤ − λ_w) and
// g₀ = Σ_b ψ_z·Eλ_w (ψ = field·s), summed over the batch in order; block
// partials of Σ_b (u − ū)².
template <typename T>
__global__ void __launch_bounds__(BPL_THREADS) slt_gmap(SLT<T> h) {
  __shared__ T sh[BPL_THREADS];
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
      const T* lu = h.lam + (long long)b * 3 * mn;
      const T* lwr = lu + mn;
      const T* lwc = lwr + mn;
      T gx, gy;
      grad_k(lu, ij, p, h.M, h.N, STENCIL_FWD, gx, gy);
      const T sy = h.xplane(X_SY)[idx];
      const T g1 = (h.xplane(X_Y)[idx] * sy) * (gx - lwr[ij])
                   + (h.xplane(X_Y + 1)[idx] * sy) * (gy - lwc[ij]);
      T e0, e1, e2;
      sym_grad_bwd(lwr, lwc, ij, p, h.N, e0, e1, e2);
      const T sz = h.xplane(X_SZ)[idx];
      const T g0 = ((h.xplane(X_Z)[idx] * sz) * e0
                    + (h.xplane(X_Z + 1)[idx] * sz) * e1)
                   + (h.xplane(X_Z + 2)[idx] * sz) * e2;
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

// ------------------------------------------------------------------ the host

// The launches of `parts` (SlxParts) of steps o0 … o1 − 1 with CG blocks
// of NS slots (a grid of 3·M·N / (256·NS) blocks an image).
template <typename T, int NS>
int slt_loop(const SLT<T>& h, const PdClusterLaunch<void (*)(SLT<T>, int)>& L,
             int o0, int o1, int parts, int n_inner, int n_adj,
             int* n_launched, cudaStream_t s) {
  const dim3 tiles(NS == 1 ? h.bpt : (unsigned)(h.mn / BPL_THREADS),
                   (unsigned)h.B);
  int nl = 0, err;
  if ((parts & SLX_BEGIN) && h.outer > 0) {
    slx_begin<T, 2><<<1, BPL_THREADS, 0, s>>>(h);
    ++nl;
  }
  for (int o = o0; o < o1; ++o) {
    if (parts & SLX_LOCAL) {
      if (n_inner > 0) {
        cudaError_t e = cudaLaunchKernelEx(&L.cfg, L.kern, h, n_inner);
        if (e != cudaSuccess) return (int)e;
        ++nl;
      }
      slt_init<T, NS><<<tiles, BPL_THREADS, 0, s>>>(h);
      ++nl;
      for (int k = 0; k < n_adj; ++k) {
        slt_apply<T, NS><<<tiles, BPL_THREADS, 0, s>>>(h, k);
        slt_update<T, NS><<<tiles, BPL_THREADS, 0, s>>>(h, k);
        nl += 2;
      }
      BPL_LAUNCH(slt_gmap<T>, h.nb_mn, BPL_THREADS, s)(h);
      ++nl;
    }
    if (parts & SLX_UPDATE) {
      slx_pull_adam<T, 2><<<2 * h.P, BPL_THREADS, 0, s>>>(h, o);
      ++nl;
    }
    if ((err = (int)cudaGetLastError()) != (int)cudaSuccess) return err;
  }
  *n_launched = nl;
  return (int)cudaGetLastError();
}

template <typename T>
int sl_tgv_entry(const T* f, const T* ut, T* u, T* w, T* p, T* q, T* lam,
                 T* zmv, T* t, T* traj_x, T* traj_cost, T* traj_gnorm,
                 T* scratch, long long B, int M, int N, int pm, int pn,
                 int cl, int rows, int resident, int cg_slots, int outer,
                 int o0, int o1, int parts, int n_inner, int n_adj, T tau,
                 T sigma, T gamma, T lr, T beta1, T beta2, T omb1, T omb2,
                 T eps, int* n_launched, cudaStream_t s) {
  *n_launched = 0;
  if (sl_bad_args(B, M, N, pm, pn, outer, n_inner, n_adj)
      || slx_bad_steps(o0, o1, parts, outer) || B > 65535
      || !(cg_slots == 1
           || (cg_slots == 3 && (long long)M * N % BPL_THREADS == 0))
      || !tgv_plan_ok(M, N, cl, rows) || B * cl > 0x7fffffffLL
      || 3LL * M * N > 0x7fffffffLL || (long long)M * pm > 0x7fffffffLL
      || (long long)N * pn > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const SltSizes z = slt_sizes(B, M, N, pm * pn, cl, rows, resident);
  SLT<T> h;
  h.f = f;
  h.ut = ut;
  h.u = u;
  h.w = w;
  h.p = p;
  h.q = q;
  h.lam = lam;
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
  h.ncg = 3 * h.mn;
  h.region = tgv_region(rows, N);
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
  h.gamma = gamma;
  h.lr = lr;
  h.beta1 = beta1;
  h.beta2 = beta2;
  h.omb1 = omb1;
  h.omb2 = omb2;
  h.eps = eps;
  PdClusterLaunch<void (*)(SLT<T>, int)> L;
  void (*kern)(SLT<T>, int) = resident ? slt_pd<T, true> : slt_pd<T, false>;
  if (parts & SLX_LOCAL) {
    int err = pd_cluster_prepare(
        L, kern, B, cl, resident ? (size_t)h.region * sizeof(T) : 0, s);
    if (err != (int)cudaSuccess) return err;
  }
  return cg_slots == 3 ? slt_loop<T, 3>(h, L, o0, o1, parts, n_inner, n_adj,
                                        n_launched, s)
                       : slt_loop<T, 1>(h, L, o0, o1, parts, n_inner, n_adj,
                                        n_launched, s);
}

}  // namespace bpl

extern "C" {

long long bpl_sl_tgv_scratch(long long B, int M, int N, int P, int cl,
                             int rows, int resident) {
  return bpl::slt_sizes(B, M, N, P, cl, rows, resident).total;
}

void bpl_sl_tgv_mesh_parts(long long B, int M, int N, int P, int cl,
                           int rows, int resident, long long* out) {
  bpl::slx_mesh_parts(bpl::slt_sizes(B, M, N, P, cl, rows, resident), out);
}

#define BPL_SL_TGV(SUFFIX, T)                                                \
  int bpl_sl_tgv_##SUFFIX(const T* f, const T* ut, T* u, T* w, T* p, T* q,   \
                          T* lam, T* zmv, T* t, T* traj_x, T* traj_cost,     \
                          T* traj_gnorm, T* scratch, long long B, int M,     \
                          int N, int pm, int pn, int cl, int rows,           \
                          int resident, int cg_slots, int outer, int o0,     \
                          int o1, int parts, int n_inner, int n_adj, T tau,  \
                          T sigma, T gamma, T lr, T beta1, T beta2, T omb1,  \
                          T omb2, T eps, int* n_launched, void* stream) {    \
    return bpl::sl_tgv_entry<T>(f, ut, u, w, p, q, lam, zmv, t, traj_x,      \
                                traj_cost, traj_gnorm, scratch, B, M, N, pm, \
                                pn, cl, rows, resident, cg_slots, outer, o0, \
                                o1, parts, n_inner, n_adj, tau, sigma,       \
                                gamma, lr, beta1, beta2, omb1, omb2, eps,    \
                                n_launched, (cudaStream_t)stream);           \
  }

BPL_SL_TGV(f32, float)
BPL_SL_TGV(f64, double)

}  // extern "C"
