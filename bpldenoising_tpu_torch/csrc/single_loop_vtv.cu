// The single-loop vectorial-TV (color) learner: TPU kernel 13.
//
// Replaces bpldenoising_tpu/bilevel/first_order_vtv_pallas.py::_kernel (the
// one-launch learner on one color image with a scalar weight, all state
// in VMEM).  Per outer step, on a batch of B images of C channels with a
// scalar weight or an (m, n) patch grid (bilevel/first_order_vtv.py, the
// jnp scan's order):
//   x = exp(z) (the α trajectory), α per pixel from the patch grid;
//   n_inner unaccelerated CP steps: common.cuh's pd_primal over the C
//     planes with ω = 1 (u⁺ = (u − τ(∇ᵀy − f))/(1 + τ), ū = 2u⁺ − u) and
//     vtv.cuh's vtv_dual (the channel-coupled Frobenius projection);
//   the γ-Huber smoothed coupled system at u (solvers/vtv.py::
//     _dpsi_coupled): g = ∇u, s = 1/max(‖g‖_F, γ), the mask ‖g‖_F ≥ γ;
//     H v = v + ∇ᵀ(α Dψ(∇v)), Dψ(d) = s·d − g·(mask·(g·d)_F·s³), the
//     Jacobi diagonal 1 + gram(αs, αs) shared by the channels;
//   n_adj Jacobi-CG steps on H λ = ū − u from the warm λ, inner products
//     per image over its C planes (cg_batched(item_ndim=3, tol=0));
//   the gradient map Σ_b (ψ·∇λ)_F, pulled back per patch; Adam on log α.
// The Frobenius sums over (channel, component) are taken in the order of
// PyTorch's reduction on the card, as vtv_dual takes them (four
// accumulators, element e into e mod 4); built with -fmad=false.
//
// What bounds it on an H100.  At 1×3×128² every step of the loop is a few
// microseconds of device work or less (a CP iteration 23 operations a
// plane-pixel, an H·v 21), so a design with one launch per half-step (151
// a step) is paced by launch issue.  This design (row 11's, csrc/
// single_loop_tgv.cu):
//
//  * CP phase, one launch per outer step (slv_pd): a thread-block cluster
//    per image, each CTA a band of rows of the 4C VTV planes in shared
//    memory for all n_inner iterations, one cluster barrier per iteration
//    (csrc/vtv_cluster.cuh).  The host (solvers/cluster_plan.py::vtv_plan)
//    picks the CTAs per image and rows per CTA; where the bands do not fit
//    in shared memory the same kernel keeps them in a global scratch laid
//    out alike (`resident` 0).
//  * Adjoint CG, two launches per step (slv_apply, slv_update).  The inner
//    products keep the parent design's partial trees: one block_sum per
//    256 consecutive elements of an image's C·M·N vector, the image's
//    partials summed by its last block (an integer counter, no float
//    atomics) in a fixed order (thread t adds partials t, t + 256, …,
//    then one block_sum), the CG scalars left on the device.  A
//    CG block takes one such partial block (any shape) or, where M·N is a
//    multiple of 256, the C that hold the same 256 pixels of the C planes
//    (M·N/256 blocks an image, so every pixel's operand and coupled weights
//    are formed once for its C elements, not C times); the host
//    (bilevel/first_order_vtv_cuda.py::cg_slots) takes the second where its
//    grid still gives every SM a block.  The operator launch forms the
//    direction d = z + βd (double-buffered planes) on three bands of pixels
//    (the block's, one row up, one row down) in shared memory, then
//    W = αDψ(∇d) with the coupled rank-one term, then ∇ᵀW.  The system
//    set-up, the Jacobi diagonal, H·λ and the CG start are one launch
//    (slv_init; its fields are formed from u on the bands and stored per
//    pixel for the later launches).
//  * The tail: the gradient map and cost partials (slv_gmap), then the
//    per-patch pullback whose last block runs Adam and forms the next
//    step's exp(z) (single_loop.cuh's slx_pull_adam, as row 11's).
//
// Launches per outer step: 4 + 2·n_adj (24 at n_adj = 10), and one per
// segment (slx_begin).  The CP and CG kernels are built for C = 3 (color:
// the channel loops unrolled, a pixel's values in registers) and for any C;
// the host takes the first where it can.  Both run the same operations.
#include "single_loop.cuh"
#include "vtv_cluster.cuh"

namespace bpl {

// B·C·M·N CG element planes, in λ's (B, C, M, N) layout: r, z = r/diag,
// d (even and odd steps), H·d; then g = ∇u as (B, C, 2, M, N).
enum SlvEPlane { E_R, E_Z, E_D0, E_D1, E_MD, E_G, N_EPLANES = E_G + 2 };
// B·M·N pixel planes of the system at u: s, the mask, the Jacobi diagonal.
enum SlvXPlane { X_S, X_MK, X_DIAG, N_XPLANES };
// per-image device scalars
enum SlvSlot { T_RZ, T_A, T_BETA, N_TSLOTS };

// Element counts of the scratch buffer's parts (of T, but `counters`).
struct SlvSizes {
  long long eplanes, xplanes, gmap, kp, part, cost_part, scal, pd, counters,
      total;
  int bpt, nb_mn;
};

static SlvSizes slv_sizes(long long B, int C, int M, int N, int P, int cl,
                          int rows, int resident) {
  SlvSizes z;
  const long long mn = (long long)M * N;
  z.bpt = blocks_for(C * mn);
  z.nb_mn = blocks_for(mn);
  z.eplanes = (long long)N_EPLANES * C * B * mn;
  z.xplanes = (long long)N_XPLANES * B * mn;
  z.gmap = mn;
  z.kp = P;
  z.part = B * z.bpt;
  z.cost_part = z.nb_mn;
  z.scal = (long long)N_TSLOTS * B;
  z.pd = resident ? 0 : B * cl * vtv_region(C, rows, N);
  // B + 1 unsigned counters, in whole elements of T
  z.counters = B + 1;
  z.total = z.eplanes + z.xplanes + z.gmap + 2 * z.kp + z.part
            + z.cost_part + z.scal + z.pd + z.counters;
  return z;
}

template <typename T>
struct SLV {
  const T* f;    // (B, C, M, N)
  const T* ut;
  T* u;          // the CP state: (B, C, M, N)
  T* y;          // (B, C, 2, M, N)
  T* lam;        // λ: (B, C, M, N)
  T* zmv;        // z, Adam m, Adam v: 3 × P
  T* t;          // step counter
  T* traj_x;     // (outer, P)
  T* traj_cost;
  T* traj_gnorm;
  T* e;          // SlvEPlane planes
  T* x;          // SlvXPlane planes
  T* gmap;       // M·N
  T* xk;         // exp(z): P
  T* gx;         // the pulled-back gradient: P
  T* part;       // B × bpt block partials
  T* cost_part;  // nb_mn
  T* scal;       // N_TSLOTS × B
  T* pd;         // the CP bands in global memory (resident 0)
  unsigned* count;  // per image, then the pullback's
  long long mn, npix, ncg, region;   // ncg = C·M·N, an image's CG vector
  int B, C, M, N, pm, pn, P, bpt, nb_mn, outer, cl, rows, ns;
  T tau, sigma, gamma, lr, beta1, beta2, omb1, omb2, eps;
  __device__ T* eplane(int k) const { return e + (long long)k * B * ncg; }
  __device__ T* xplane(int k) const { return x + (long long)k * npix; }
  // g = ∇u, component d of channel c of image b
  __device__ T* gplane(long long b, int c, int d) const {
    return eplane(E_G) + ((b * C + c) * 2 + d) * mn;
  }
  __device__ T& slot(int s, long long b) const {
    return scal[(long long)s * B + b];
  }
};

// ---------------------------------------------------------------- CP phase

// The learner's CP step for vtv_cluster_run: unaccelerated, its state
// (u updated in place), f, and α from x (in shared memory for a scalar
// weight).
template <typename T>
struct SlvStep {
  static constexpr bool ACCEL = false;
  const SLV<T>& h;
  const T* s_alpha;
  int M, N, C, cl, rows;
  long long region;
  T* pd;
  T tau, sigma;
  __device__ SlvStep(const SLV<T>& h_, const T* sa)
      : h(h_), s_alpha(sa), M(h_.M), N(h_.N), C(h_.C), cl(h_.cl),
        rows(h_.rows), region(h_.region), pd(h_.pd), tau(h_.tau),
        sigma(h_.sigma) {}
  __device__ T* u(long long b) const { return h.u + b * h.ncg; }
  __device__ T* u_out(long long b) const { return u(b); }
  __device__ T* y(long long b) const { return h.y + b * 2 * h.ncg; }
  __device__ const T* f(long long b) const { return h.f + b * h.ncg; }
  __device__ long long mn() const { return h.mn; }
  __device__ T alpha(int i, int j) const {
    return h.P == 1 ? s_alpha[0] : slx_alpha<T>(h, 0, i, j);
  }
};

// All n_inner CP iterations of an outer step, one image per cluster.
// RES: the bands live in shared memory (else in h.pd, laid out alike); CC:
// the channels, 3 or any (0).  Two CTAs an SM in float32 (96 KB bands at 16
// CTAs an image, C = 3); in float64 one (192 KB), so the register bound is
// 128.
template <typename T, bool RES, int CC>
__global__ void __launch_bounds__(PD_THREADS, sizeof(T) == 4 ? PD_MINB : 1)
slv_pd(SLV<T> h, int n_inner) {
  extern __shared__ __align__(16) unsigned char slv_smem[];
  __shared__ T s_alpha[1];
  if (threadIdx.x == 0) s_alpha[0] = h.xk[0];
  SlvStep<T> step(h, s_alpha);
  vtv_cluster_run<T, RES, CC>(step, slv_smem, n_inner);
}

// ------------------------------------------------------------ the CG blocks

// A CG block (blockIdx.x, image blockIdx.y) works on h.ns slots of 256
// elements of the image's C·M·N vector (λ's layout), each slot one of the
// parent design's partial blocks, 256 consecutive elements:
//   ns = 1, any shape: the slot [e0, e0 + 256), e0 = 256·blockIdx.x,
//     whatever planes its elements lie in;
//   ns = C, M·N a multiple of 256 (the host's cg_slots): pixels
//     [p0, p0 + 256), p0 = 256·blockIdx.x, in each plane, the partial
//     blocks p0/256 + c·M·N/256, so the C planes share their bands.
// Thread t takes element t of each slot.  H at (plane c, pixel k) reads
// pixels k − N … k + N of every plane (W couples the channels).  Band
// position q ∈ [0, SB) stands for pixel kk(q) = (256·blockIdx.x + q − 1)
// mod M·N (thread t's at q = t + 1); band A holds pixel kk(q) − N, band C
// kk(q), band B kk(q) + N, of each plane.  Where a stencil reads k ± 1 it
// reads the adjacent position, whose pixel is k ± 1 wherever the mask lets
// the read happen (not at a row's end, so not where an ns = 1 slot's
// elements pass into another plane).  Pixels outside the image hold 0 and
// are never read.  CC: the channels, 3 or any (0), as in slv_pd: with C
// fixed the channel loops unroll and a pixel's gradients and fields stay
// in registers.
#define SB (BPL_THREADS + 2)
enum SlvBand { BAND_A, BAND_C, BAND_B };

// The tile in dynamic shared memory: T arrays, then the (i, j) table.
template <typename T>
struct SlvTile {
  T* d;      // the operand [band][plane][q]
  T* w0;     // W's row component on bands C (0) and A (1): [2][plane][q]
  T* w1;     // W's column component on band C: [plane][q]
  T* as;     // αs on bands C (0) and A (1): [2][q] (slv_init)
  T* hs;     // s and the mask on bands C and A: [2][q] (slv_init)
  T* hm;
  T* sh;     // block_sum's scratch
  int* pi;   // (i, j) of kk(q)
  int* pj;
  int C;
  __device__ SlvTile(unsigned char* smem, int C_) : C(C_) {
    d = reinterpret_cast<T*>(smem);
    w0 = d + 3 * C * SB;
    w1 = w0 + 2 * C * SB;
    as = w1 + C * SB;
    hs = as + 2 * SB;
    hm = hs + 2 * SB;
    sh = hm + 2 * SB;
    pi = reinterpret_cast<int*>(sh + BPL_THREADS);
    pj = pi + SB;
  }
  __device__ T* dv(int band, int c) const { return d + (band * C + c) * SB; }
  __device__ T* w0v(int which, int c) const {
    return w0 + (which * C + c) * SB;
  }
  __device__ T* w1v(int c) const { return w1 + c * SB; }
};

inline size_t slv_tile_bytes(int C, size_t itemsize) {
  return ((6LL * C + 6) * SB + BPL_THREADS) * itemsize
         + 2 * SB * sizeof(int);
}

// The first element of slot r of this block in the image's CG vector (a
// multiple of 256: its partial block is this / 256).
template <typename T>
__device__ __forceinline__ long long slv_slot(const SLV<T>& h, int r) {
  const long long p0 = (long long)blockIdx.x * BPL_THREADS;
  return h.ns == 1 ? p0 : r * h.mn + p0;
}

// The Huber fields of the coupled system at pixel k of image b: s and the
// mask from ‖∇u‖_F (slv_init forms them from u).
template <typename T, int CC>
__device__ __forceinline__ void slv_huber(const SLV<T>& h, long long b,
                                          long long k, Pix p, T& s, T& m) {
  const T* ub = h.u + b * h.ncg;
  const T n2 = frob_sum<T, CC>(h.C, [&](int c, T& x, T& y) {
    T gx, gy;
    grad_k(ub + c * h.mn, k, p, h.M, h.N, STENCIL_FWD, gx, gy);
    x = gx * gx;
    y = gy * gy;
  });
  const T nrm = sqrt(n2);
  s = T(1) / (nrm < h.gamma ? h.gamma : nrm);
  m = nrm >= h.gamma ? T(1) : T(0);
}

// g = ∇u of channel c at pixel k: SETUP forms it from u, else reads the
// planes slv_init stored.
template <typename T, bool SETUP>
__device__ __forceinline__ void slv_g(const SLV<T>& h, long long b, int c,
                                      long long k, Pix p, T& g0, T& g1) {
  if (SETUP) {
    grad_k((const T*)h.u + b * h.ncg + c * h.mn, k, p, h.M, h.N,
           STENCIL_FWD, g0, g1);
    return;
  }
  g0 = h.gplane(b, c, 0)[k];
  g1 = h.gplane(b, c, 1)[k];
}

// Fills the tile's (i, j) table and the operand on the three bands of
// every plane: v(g) is the operand at flat element g = b·CMN + c·MN + pixel.
template <typename T, typename V>
__device__ __forceinline__ void slv_bands(const SLV<T>& h,
                                          const SlvTile<T>& s, V v) {
  const long long b = blockIdx.y;
  const int mn = (int)h.mn;             // C·M·N < 2³¹ (vtv_plan_ok)
  const int p0 = (int)blockIdx.x * BPL_THREADS;
  for (int q = threadIdx.x; q < SB; q += BPL_THREADS) {
    const int e = p0 + q - 1;
    const int kk = e < 0 ? e + mn : e % mn;
    s.pi[q] = kk / h.N;
    s.pj[q] = kk % h.N;
  }
  __syncthreads();
  const int per_band = h.C * SB;
  for (int x = threadIdx.x; x < 3 * per_band; x += BPL_THREADS) {
    const int band = x / per_band, c = (x / SB) % h.C, q = x % SB;
    const int i = s.pi[q] + band - 1;
    T val = T(0);
    if (i >= 0 && i < h.M)
      val = v(b * h.ncg + c * h.mn + (long long)i * h.N + s.pj[q]);
    s.d[x] = val;
  }
  __syncthreads();
}

// W = αDψ(∇d) on the bands, every plane: on band C (positions 0 … SB − 2)
// both components, on band A (1 … SB − 2) the row component.  The products
// in the parent design's order (slv_weights: (g·∇d)_F, rad = (mask·
// (g·∇d)_F)·((s·s)·s), W = α(s·∇d − g·rad)); g from u (SETUP) or the
// stored planes, s and the mask from the tile (SETUP) or the stored planes.
template <typename T, int CC, bool SETUP>
__device__ __forceinline__ void slv_weights(const SLV<T>& h,
                                            const SlvTile<T>& s) {
  const int C = CC > 0 ? CC : h.C;
  const long long b = blockIdx.y;
  for (int x = threadIdx.x; x < 2 * SB; x += BPL_THREADS) {
    const int which = x / SB, q = x % SB;
    if (q > SB - 2 || (which == 1 && q < 1)) continue;
    const int band = which == 0 ? BAND_C : BAND_A;
    const int i = s.pi[q] + band - 1, j = s.pj[q];
    if (i < 0 || i >= h.M) continue;
    const long long k = (long long)i * h.N + j;
    const Pix p = pix(b, i, j);
    auto grad_d = [&](int c, T& dx, T& dy) {
      const T* dc = s.dv(band, c);
      dx = i < h.M - 1 ? s.dv(band + 1, c)[q] - dc[q] : T(0);
      dy = j < h.N - 1 ? dc[q + 1] - dc[q] : T(0);
    };
    T sv, mk;
    if (SETUP) {
      sv = s.hs[which * SB + q];
      mk = s.hm[which * SB + q];
    } else {
      sv = h.xplane(X_S)[b * h.mn + k];
      mk = h.xplane(X_MK)[b * h.mn + k];
    }
    const T a = slx_alpha<T>(h, 0, i, j);
    if constexpr (CC > 0) {
      T dx[CC], dy[CC], g0[CC], g1[CC];
#pragma unroll
      for (int c = 0; c < CC; ++c) {
        grad_d(c, dx[c], dy[c]);
        slv_g<T, SETUP>(h, b, c, k, p, g0[c], g1[c]);
      }
      const T gd = frob_sum<T, CC>(CC, [&](int c, T& x0, T& x1) {
        x0 = g0[c] * dx[c];
        x1 = g1[c] * dy[c];
      });
      const T rad = (mk * gd) * ((sv * sv) * sv);
#pragma unroll
      for (int c = 0; c < CC; ++c) {
        s.w0v(which, c)[q] = a * (sv * dx[c] - g0[c] * rad);
        if (which == 0) s.w1v(c)[q] = a * (sv * dy[c] - g1[c] * rad);
      }
    } else {
      const T gd = frob_sum<T>(C, [&](int c, T& x0, T& x1) {
        T dx, dy, g0, g1;
        grad_d(c, dx, dy);
        slv_g<T, SETUP>(h, b, c, k, p, g0, g1);
        x0 = g0 * dx;
        x1 = g1 * dy;
      });
      const T rad = (mk * gd) * ((sv * sv) * sv);
      for (int c = 0; c < C; ++c) {
        T dx, dy, g0, g1;
        grad_d(c, dx, dy);
        slv_g<T, SETUP>(h, b, c, k, p, g0, g1);
        s.w0v(which, c)[q] = a * (sv * dx - g0 * rad);
        if (which == 0) s.w1v(c)[q] = a * (sv * dy - g1 * rad);
      }
    }
  }
  __syncthreads();
}

// (H v) at plane c and position q (pixel (i, j)) from the tile's weights,
// in the parent design's order: v + (adj1 along rows + adj1 along columns).
template <typename T>
__device__ __forceinline__ T slv_hv(const SLV<T>& h, const SlvTile<T>& s,
                                    int c, int q) {
  const int i = s.pi[q], j = s.pj[q];
  const T* wa = s.w0v(1, c);
  const T* wc = s.w0v(0, c);
  const T* wy = s.w1v(c);
  const T rows = (i >= 1 ? wa[q] : T(0)) - (i < h.M - 1 ? wc[q] : T(0));
  const T cols = (j >= 1 ? wy[q - 1] : T(0)) - (j < h.N - 1 ? wy[q] : T(0));
  return s.dv(BAND_C, c)[q] + (rows + cols);
}

// The element of slot r that thread t takes: its plane and pixel; false
// past the image's vector.
template <typename T>
__device__ __forceinline__ bool slv_elem(const SLV<T>& h, int r, int& c,
                                         long long& e) {
  e = slv_slot(h, r) + threadIdx.x;
  if (e >= h.ncg) return false;
  c = h.ns == 1 ? (int)e / (int)h.mn : r;
  return true;
}

// The system at u, its Jacobi diagonal, H·λ and the CG start: r = (ū − u)
// − Hλ, z = r/diag, ρ = (r, z) per image.  The fields at the element's
// pixel (∇u, s, the mask, the diagonal) go to their planes, written by
// plane 0's elements.
template <typename T, int CC>
__global__ void __launch_bounds__(BPL_THREADS) slv_init(SLV<T> h) {
  extern __shared__ __align__(16) unsigned char slv_tile[];
  const SlvTile<T> s(slv_tile, h.C);
  const long long b = blockIdx.y;
  const int q = threadIdx.x + 1;
  slv_bands(h, s, [&](long long g) { return h.lam[g]; });
  // s, the mask and αs on bands C (0 … SB − 2) and A (1 … SB − 2)
  for (int x = threadIdx.x; x < 2 * SB; x += BPL_THREADS) {
    const int which = x / SB, qq = x % SB;
    if (qq > SB - 2 || (which == 1 && qq < 1)) continue;
    const int i = s.pi[qq] + (which == 0 ? 0 : -1), j = s.pj[qq];
    if (i < 0 || i >= h.M) continue;
    T sv, mk;
    slv_huber<T, CC>(h, b, (long long)i * h.N + j, pix(b, i, j), sv, mk);
    s.hs[x] = sv;
    s.hm[x] = mk;
    s.as[x] = slx_alpha<T>(h, 0, i, j) * sv;
  }
  __syncthreads();
  // the diagonal at the thread's pixel: 1 + gram(αs, αs) (rows, then
  // columns)
  T diag;
  {
    const int i = s.pi[q], j = s.pj[q];
    const T* ac = s.as;
    const T* aa = s.as + SB;
    const T gr = (i >= 1 ? aa[q] : T(0)) + (i < h.M - 1 ? ac[q] : T(0));
    const T gc = (j >= 1 ? ac[q - 1] : T(0)) + (j < h.N - 1 ? ac[q] : T(0));
    diag = T(1) + (gr + gc);
  }
  slv_weights<T, CC, true>(h, s);
  const long long pxk = (long long)s.pi[q] * h.N + s.pj[q];
  for (int r = 0; r < h.ns; ++r) {
    int c;
    long long e;
    T rz = T(0);
    if (slv_elem(h, r, c, e)) {
      const T mv = slv_hv(h, s, c, q);
      const long long g = b * h.ncg + e;
      const T res = (h.ut[g] - h.u[g]) - mv;
      const T z = res / diag;
      h.eplane(E_R)[g] = res;
      h.eplane(E_Z)[g] = z;
      rz = res * z;
      if (c == 0) {
        const Pix p = pix(b, s.pi[q], s.pj[q]);
        const long long at = b * h.mn + pxk;
        h.xplane(X_S)[at] = s.hs[q];
        h.xplane(X_MK)[at] = s.hm[q];
        h.xplane(X_DIAG)[at] = diag;
        for (int cc = 0; cc < (CC > 0 ? CC : h.C); ++cc) {
          T g0, g1;
          slv_g<T, true>(h, b, cc, pxk, p, g0, g1);
          h.gplane(b, cc, 0)[pxk] = g0;
          h.gplane(b, cc, 1)[pxk] = g1;
        }
      }
    }
    slx_partial<T>(h, slv_slot(h, r) / BPL_THREADS, rz, s.sh);
  }
  T sum;
  if (slx_image_sum<T>(h, &sum, s.sh) && threadIdx.x == 0)
    h.slot(T_RZ, b) = sum;
}

// CG step k, the operator: d = z (k = 0) or z + βd on the bands (the own
// elements' stored for the update), H·d and the image sums of d·Hd; the
// image's last block forms a = ρ/(d·Hd).
template <typename T, int CC>
__global__ void __launch_bounds__(BPL_THREADS) slv_apply(SLV<T> h, int k) {
  extern __shared__ __align__(16) unsigned char slv_tile[];
  const SlvTile<T> s(slv_tile, h.C);
  const long long b = blockIdx.y;
  const int q = threadIdx.x + 1;
  const T beta = k > 0 ? h.slot(T_BETA, b) : T(0);
  const T* z = h.eplane(E_Z);
  const T* d_old = h.eplane(k % 2 ? E_D0 : E_D1);
  T* d_new = h.eplane(k % 2 ? E_D1 : E_D0);
  slv_bands(h, s, [&](long long g) {
    return k == 0 ? z[g] : z[g] + beta * d_old[g];
  });
  slv_weights<T, CC, false>(h, s);
  for (int r = 0; r < h.ns; ++r) {
    int c;
    long long e;
    T dmd = T(0);
    if (slv_elem(h, r, c, e)) {
      const T mv = slv_hv(h, s, c, q);
      const T dv = s.dv(BAND_C, c)[q];
      const long long g = b * h.ncg + e;
      d_new[g] = dv;
      h.eplane(E_MD)[g] = mv;
      dmd = dv * mv;
    }
    slx_partial<T>(h, slv_slot(h, r) / BPL_THREADS, dmd, s.sh);
  }
  T sum;
  if (slx_image_sum<T>(h, &sum, s.sh) && threadIdx.x == 0)
    h.slot(T_A, b) = h.slot(T_RZ, b) / nz(sum);
}

// CG step k, the update: λ += a d; r −= a Hd; z = r/diag; the image's last
// block forms β = ρ_new/ρ and ρ ← ρ_new.
template <typename T>
__global__ void __launch_bounds__(BPL_THREADS) slv_update(SLV<T> h, int k) {
  __shared__ T sh[BPL_THREADS];
  const long long b = blockIdx.y;
  const T a = h.slot(T_A, b);
  const T* d = h.eplane(k % 2 ? E_D1 : E_D0);
  for (int r = 0; r < h.ns; ++r) {
    int c;
    long long e;
    T rz = T(0);
    if (slv_elem(h, r, c, e)) {
      const long long g = b * h.ncg + e;
      h.lam[g] = h.lam[g] + a * d[g];
      const T res = h.eplane(E_R)[g] - a * h.eplane(E_MD)[g];
      const T z = res / h.xplane(X_DIAG)[b * h.mn + (e - c * h.mn)];
      h.eplane(E_R)[g] = res;
      h.eplane(E_Z)[g] = z;
      rz = res * z;
    }
    slx_partial<T>(h, slv_slot(h, r) / BPL_THREADS, rz, sh);
  }
  T sum;
  if (slx_image_sum<T>(h, &sum, sh) && threadIdx.x == 0) {
    h.slot(T_BETA, b) = sum / nz(h.slot(T_RZ, b));
    h.slot(T_RZ, b) = sum;
  }
}

// ------------------------------------------------------------------ the tail

// One thread per pixel (i, j) of the plane: Σ_b (ψ·∇λ)_F with ψ = g·s,
// summed over the batch in order; block partials of Σ_b Σ_c (u − ū)²
// (the parent's order: images, then channels).
template <typename T>
__global__ void __launch_bounds__(BPL_THREADS) slv_gmap(SLV<T> h) {
  __shared__ T sh[BPL_THREADS];
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
      const T s = h.xplane(X_S)[(long long)b * mn + ij];
      const T* lb = h.lam + (long long)b * h.ncg;
      const T gb = frob_sum<T>(h.C, [&](int c, T& x, T& y) {
        T lx, ly;
        grad_k(lb + c * mn, ij, p, h.M, h.N, STENCIL_FWD, lx, ly);
        x = (h.gplane(b, c, 0)[ij] * s) * lx;
        y = (h.gplane(b, c, 1)[ij] * s) * ly;
      });
      for (int c = 0; c < h.C; ++c) {
        const long long at = (long long)b * h.ncg + c * mn + ij;
        const T d = h.u[at] - h.ut[at];
        c2 += d * d;
      }
      accb = b == 0 ? gb : accb + gb;
    }
    h.gmap[ij] = accb;
  }
  T s = block_sum(c2, sh);
  if (threadIdx.x == 0) h.cost_part[blockIdx.x] = s;
}

// ------------------------------------------------------------------ the host

// The dynamic shared memory of the CG kernels (a tile of C planes): set
// where it passes the default 48 KB; an error where the card has less.
template <typename T, int CC>
int slv_tile_prepare(int C, size_t* bytes) {
  *bytes = slv_tile_bytes(C, sizeof(T));
  if (*bytes <= 48 * 1024) return (int)cudaSuccess;
  int dev = 0, optin = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  if (*bytes > (size_t)optin) return (int)cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(slv_init<T, CC>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)*bytes);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaFuncSetAttribute(slv_apply<T, CC>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)*bytes);
}

// The CP launch (prepared where the call runs the local part) and the
// launches of `parts` (SlxParts) of steps o0 … o1 − 1 (CG blocks of h.ns
// slots: a grid of C·M·N / (256·ns) blocks an image) for CC channels (0:
// any).
template <typename T, int CC>
int slv_loop(const SLV<T>& h, int resident, int o0, int o1, int parts,
             int n_inner, int n_adj, int* n_launched, cudaStream_t s) {
  PdClusterLaunch<void (*)(SLV<T>, int)> L;
  void (*kern)(SLV<T>, int) =
      resident ? slv_pd<T, true, CC> : slv_pd<T, false, CC>;
  int err;
  size_t tile = 0;
  if (parts & SLX_LOCAL) {
    err = pd_cluster_prepare(
        L, kern, h.B, h.cl, resident ? (size_t)h.region * sizeof(T) : 0, s);
    if (err != (int)cudaSuccess) return err;
    if ((err = slv_tile_prepare<T, CC>(h.C, &tile)) != (int)cudaSuccess)
      return err;
  }
  const dim3 tiles(h.ns == 1 ? h.bpt : (unsigned)(h.mn / BPL_THREADS),
                   (unsigned)h.B);
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
      slv_init<T, CC><<<tiles, BPL_THREADS, tile, s>>>(h);
      ++nl;
      for (int k = 0; k < n_adj; ++k) {
        slv_apply<T, CC><<<tiles, BPL_THREADS, tile, s>>>(h, k);
        slv_update<T><<<tiles, BPL_THREADS, 0, s>>>(h, k);
        nl += 2;
      }
      BPL_LAUNCH(slv_gmap<T>, h.nb_mn, BPL_THREADS, s)(h);
      ++nl;
    }
    if (parts & SLX_UPDATE) {
      slx_pull_adam<T, 1><<<h.P, BPL_THREADS, 0, s>>>(h, o);
      ++nl;
    }
    if ((err = (int)cudaGetLastError()) != (int)cudaSuccess) return err;
  }
  *n_launched = nl;
  return (int)cudaGetLastError();
}

template <typename T>
int sl_vtv_entry(const T* f, const T* ut, T* u, T* y, T* lam, T* zmv, T* t,
                 T* traj_x, T* traj_cost, T* traj_gnorm, T* scratch,
                 long long B, int C, int M, int N, int pm, int pn, int cl,
                 int rows, int resident, int cg_slots, int outer, int o0,
                 int o1, int parts, int n_inner, int n_adj, T tau, T sigma,
                 T gamma, T lr, T beta1, T beta2, T omb1, T omb2, T eps,
                 int* n_launched, cudaStream_t s) {
  *n_launched = 0;
  if (sl_bad_args(B, M, N, pm, pn, outer, n_inner, n_adj)
      || slx_bad_steps(o0, o1, parts, outer) || B > 65535
      || C < 1
      || !(cg_slots == 1
           || (cg_slots == C && (long long)M * N % BPL_THREADS == 0))
      || !vtv_plan_ok(M, N, C, cl, rows) || B * cl > 0x7fffffffLL
      || (long long)M * pm > 0x7fffffffLL
      || (long long)N * pn > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const SlvSizes z = slv_sizes(B, C, M, N, pm * pn, cl, rows, resident);
  SLV<T> h;
  h.f = f;
  h.ut = ut;
  h.u = u;
  h.y = y;
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
  h.ncg = C * h.mn;
  h.region = vtv_region(C, rows, N);
  h.B = (int)B;
  h.C = C;
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
  h.ns = cg_slots;
  h.tau = tau;
  h.sigma = sigma;
  h.gamma = gamma;
  h.lr = lr;
  h.beta1 = beta1;
  h.beta2 = beta2;
  h.omb1 = omb1;
  h.omb2 = omb2;
  h.eps = eps;
  return C == 3 ? slv_loop<T, 3>(h, resident, o0, o1, parts, n_inner, n_adj,
                                 n_launched, s)
                : slv_loop<T, 0>(h, resident, o0, o1, parts, n_inner, n_adj,
                                 n_launched, s);
}

}  // namespace bpl

extern "C" {

long long bpl_sl_vtv_scratch(long long B, int C, int M, int N, int P,
                             int cl, int rows, int resident) {
  return bpl::slv_sizes(B, C, M, N, P, cl, rows, resident).total;
}

void bpl_sl_vtv_mesh_parts(long long B, int C, int M, int N, int P, int cl,
                           int rows, int resident, long long* out) {
  bpl::slx_mesh_parts(bpl::slv_sizes(B, C, M, N, P, cl, rows, resident),
                      out);
}

#define BPL_SL_VTV(SUFFIX, T)                                                \
  int bpl_sl_vtv_##SUFFIX(const T* f, const T* ut, T* u, T* y, T* lam,       \
                          T* zmv, T* t, T* traj_x, T* traj_cost,             \
                          T* traj_gnorm, T* scratch, long long B, int C,     \
                          int M, int N, int pm, int pn, int cl, int rows,    \
                          int resident, int cg_slots, int outer, int o0,     \
                          int o1, int parts, int n_inner, int n_adj, T tau,  \
                          T sigma, T gamma, T lr, T beta1, T beta2, T omb1,  \
                          T omb2, T eps, int* n_launched, void* stream) {    \
    return bpl::sl_vtv_entry<T>(f, ut, u, y, lam, zmv, t, traj_x, traj_cost, \
                                traj_gnorm, scratch, B, C, M, N, pm, pn, cl, \
                                rows, resident, cg_slots, outer, o0, o1,     \
                                parts, n_inner, n_adj, tau, sigma, gamma,    \
                                lr, beta1, beta2, omb1, omb2, eps,           \
                                n_launched, (cudaStream_t)stream);           \
  }

BPL_SL_VTV(f32, float)
BPL_SL_VTV(f64, double)

}  // extern "C"
