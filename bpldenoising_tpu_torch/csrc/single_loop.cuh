// The single-loop learners' shared state and kernels: TPU kernel 12 (TV-L1,
// single_loop_tvl1.cu) builds on this header; TPU kernels 9 and 10
// (single_loop.cu, TV and the sum of gradient regularizers), 11
// (single_loop_tgv.cu, TGV²) and 13 (single_loop_vtv.cu, VTV) have their
// own design (a thread-block cluster per image for the CP phase, two
// launches per CG step) and take only SL_MAXK and sl_bad_args from here,
// and rows 11 and 13 the parts they share (slx_*, at the end); they no
// longer run sl_run.  The learner here keeps its state
// in global memory, runs one thread per pixel and uses launch boundaries
// as its barriers; a C loop issues the launches and nothing is read back
// to the host between the first and the last.  Shared here:
//   SL<T>, the learner's device view (the CG planes, the parameter z =
//     log α, Adam's moments, the trajectories, the partials);
//   sl_exp (x = exp(z) and its trajectory), sl_amap (α as (M, N) maps for
//     the TV-L1 CP kernel), sl_alpha (the patch index
//     min(i·m // M, m − 1));
//   the γ-smoothed gradient-regularizer system (sl_setup, sl_diag,
//     sl_weights, sl_apply: solvers/hypergrad.py::build_reg_system, with
//     the TV-L1 data Hessian D in place of I where dfac is set);
//   the classic CG (sl_cg_init, sl_finish, sl_cg_update, sl_cg_dir):
//     per-tile inner products from
//     fixed-order block partials and a one-block finishing kernel per
//     tile, whose scalars stay on the device.  A tile of one image gives
//     the per-image inner products of solvers/krylov.py::cg_batched;
//   the gradient maps of the gradient regularizers (sl_gmap), the
//     per-patch pullback (sl_pullback) and Adam on log α with pow(β, t),
//     1 − β formed in double on the host and an optional clip (sl_adam).
// The arithmetic follows the port's plain versions (bilevel/first_order*.py),
// built with -fmad=false.
#pragma once

#include "common.cuh"

namespace bpl {

#define SL_MAXK 8

// B·M·N work planes of the classic CG: R = r, Z = z, D = d, MD = Md
// (UBAR is TV-L1's ū).  Then, per regularizer k, K_PLANES planes from
// SL_BASE.
enum SlPlane { UBAR, R, Z, D, MD, INV_DIAG, SL_BASE };
enum SlKPlane { GUX, GUY, ACT, INV_DEN, INV_DEN3, WX, WY, K_PLANES };
// per-tile device scalars
enum SlSlot { S_RZ, S_A, S_BETA, N_SL_SLOTS };
// what sl_apply sums; what sl_finish forms from the sums
enum SlApply { APPLY_PLAIN, APPLY_DMD };
enum SlFinish { FIN_RZ0, FIN_ALPHA, FIN_BETA };

// Element counts of the scratch buffer's parts: `planes` work elements,
// then the gradient maps, exp(z), the pulled-back gradient, the CG
// partials, the cost partials and the per-tile CG scalars.  The CG runs
// over n elements in tiles of tile_n (one group of images each).
struct SlSizes {
  long long planes, gmap, kp, partials, cost_part, scal, total;
  long long tile_n;
  int bpt, n_tiles, nb_mn;
};

static SlSizes sl_layout(long long n, long long tile_n, int M, int N, int K,
                         int P, long long planes) {
  SlSizes z;
  const long long mn = (long long)M * N;
  z.tile_n = tile_n;
  z.bpt = blocks_for(z.tile_n);
  z.n_tiles = (int)((n + tile_n - 1) / tile_n);
  z.nb_mn = blocks_for(mn);
  z.planes = planes;
  z.gmap = (long long)K * mn;
  z.kp = (long long)K * P;
  z.partials = (long long)z.n_tiles * z.bpt;
  z.cost_part = z.nb_mn;
  z.scal = (long long)N_SL_SLOTS * z.n_tiles;
  z.total = z.planes + z.gmap + 2 * z.kp + z.partials + z.cost_part + z.scal;
  return z;
}

// The TV-L1 learner over K gradient regularizers: the work planes of
// SlPlane and K × SlKPlane, tiles of tile_b images.
static SlSizes sl_sizes(long long B, int M, int N, int K, int P,
                        int tile_b) {
  const long long n = B * (long long)M * N;
  return sl_layout(n, (long long)tile_b * M * N, M, N, K, P,
                   (long long)(SL_BASE + K * K_PLANES) * n);
}

template <typename T>
struct SL {
  const T* f;
  const T* ut;
  T* u;
  T* ys;        // K × (B, 2, M, N)
  T* p;
  T* zmv;       // z, Adam m, Adam v: 3 × K × P
  T* t;         // step counter
  T* traj_x;    // (outer, K, P)
  T* traj_cost;
  T* traj_gnorm;
  T* w;         // work planes
  T* gmap;      // K × M·N
  T* xk;        // exp(z): K × P
  T* gx;        // the pulled-back gradient: K × P
  T* partials;  // n_tiles × bpt
  T* cost_part; // nb_mn
  T* scal;      // N_SL_SLOTS × n_tiles
  long long n, mn, tile_n;
  int B, M, N, K, pm, pn, P, n_tiles, bpt, nb_mn;
  int kind[SL_MAXK];
  T tau, sigma, gamma, lr, beta1, beta2, omb1, omb2, eps;
  // TV-L1 (dfac non-null): the Huber data Hessian d = γ_d·1{|u − f| ≤
  // 1/γ_d} replaces the identity block; inv_gd = 1/γ_d.
  T* dfac;
  T gamma_d, inv_gd;
  // Adam on the clipped log-α gradient (use_clip: g_z ∈ [−clip, clip]).
  int use_clip;
  T clip;
  __device__ T* plane(int k) const { return w + (long long)k * n; }
  __device__ T* kplane(int k, int which) const {
    return w + (long long)(SL_BASE + k * K_PLANES + which) * n;
  }
  __device__ T* y(int k, long long b) const {
    return ys + ((long long)k * B + b) * 2 * mn;
  }
  __device__ T& slot(int s, int tile) const {
    return scal[(long long)s * n_tiles + tile];
  }
  __device__ T* partial() const {
    return partials + (long long)blockIdx.y * bpt + blockIdx.x;
  }
};

// The flat index of this thread in the (bpt, n_tiles) grid: tile
// blockIdx.y covers tile_n elements (tile_b images).  False past the end.
template <typename T>
__device__ __forceinline__ bool sl_pixel(const SL<T>& h, long long& idx) {
  const long long in_tile = (long long)blockIdx.x * BPL_THREADS + threadIdx.x;
  idx = (long long)blockIdx.y * h.tile_n + in_tile;
  return in_tile < h.tile_n && idx < h.n;
}

// αₖ at pixel p: the patch entry min(i·m // M, m − 1), min(j·n // N, n − 1)
// (first_order_pallas.py:146-147, PatchOp.apply for divisible shapes).
template <typename T>
__device__ __forceinline__ T sl_alpha(const SL<T>& h, int k, Pix p) {
  int pi = (int)((long long)p.i * h.pm / h.M);
  int pj = (int)((long long)p.j * h.pn / h.N);
  pi = pi < h.pm - 1 ? pi : h.pm - 1;
  pj = pj < h.pn - 1 ? pj : h.pn - 1;
  return h.xk[k * h.P + pi * h.pn + pj];
}

// x = exp(z), recorded as the α that produces this step's state.
template <typename T>
__global__ void sl_exp(SL<T> h, int o) {
  const int kp = h.K * h.P;
  for (int e = threadIdx.x; e < kp; e += BPL_THREADS) {
    T x = exp(h.zmv[e]);
    h.xk[e] = x;
    h.traj_x[(long long)o * kp + e] = x;
  }
}

// Per regularizer: Gu, act = |Gu| > 1/γ, 1/den, (1/den)³, and the Jacobi
// weights α(γ·inact + act·(1/den − Gu²/den³)) into WX, WY.
template <typename T>
__global__ void sl_setup(SL<T> h) {
  long long idx;
  if (!sl_pixel(h, idx)) return;
  Pix p = pix_of(idx, h.M, h.N);
  for (int k = 0; k < h.K; ++k) {
    T gx, gy;
    grad_k((const T*)h.u, idx, p, h.M, h.N, h.kind[k], gx, gy);
    T nG = sqrt(gx * gx + gy * gy);
    T act = nG > T(1) / h.gamma ? T(1) : T(0);
    T gi = h.gamma * (T(1) - act);
    T den = act > T(0) ? nG : T(1);
    T inv_den = T(1) / den;
    T rden3 = T(1) / (den * den * den);
    T a = sl_alpha(h, k, p);
    h.kplane(k, GUX)[idx] = gx;
    h.kplane(k, GUY)[idx] = gy;
    h.kplane(k, ACT)[idx] = act;
    h.kplane(k, INV_DEN)[idx] = inv_den;
    h.kplane(k, INV_DEN3)[idx] = inv_den * inv_den * inv_den;
    h.kplane(k, WX)[idx] = a * (gi + act * (inv_den - (gx * gx) * rden3));
    h.kplane(k, WY)[idx] = a * (gi + act * (inv_den - (gy * gy) * rden3));
  }
}

// The TV-L1 Jacobi diagonal, from diag = 1 + Σₖ gramₖ(WX, WY):
// d = γ_d·1{|u − f| ≤ 1/γ_d} into dfac and the diagonal
// max(1/(1/diag) + (d − 1), 1e-12) of D + Σₖ GₖᵀαₖWₖGₖ into INV_DIAG (as
// solvers/tvl1_huber.py forms it; the CG divides by it).
template <typename T>
__global__ void sl_diag(SL<T> h) {
  long long idx;
  if (!sl_pixel(h, idx)) return;
  Pix p = pix_of(idx, h.M, h.N);
  T diag = T(1);
  for (int k = 0; k < h.K; ++k)
    diag = diag + gram_k((const T*)h.kplane(k, WX),
                         (const T*)h.kplane(k, WY), idx, p, h.M, h.N,
                         h.kind[k]);
  const T inv = T(1) / diag;
  const T d = fabs(h.u[idx] - h.f[idx]) <= h.inv_gd ? h.gamma_d : T(0);
  h.dfac[idx] = d;
  const T dg = T(1) / inv + (d - T(1));
  h.plane(INV_DIAG)[idx] = dg > T(1e-12) ? dg : T(1e-12);
}

// (WX, WY)ₖ = αₖ(γ·inact·Gₖv + act·H Gₖv), H g = g/den − Gu (Gu·g)/den³.
template <typename T>
__global__ void sl_weights(SL<T> h, const T* __restrict__ v) {
  long long idx;
  if (!sl_pixel(h, idx)) return;
  Pix p = pix_of(idx, h.M, h.N);
  for (int k = 0; k < h.K; ++k) {
    T gx, gy;
    grad_k(v, idx, p, h.M, h.N, h.kind[k], gx, gy);
    T ux = h.kplane(k, GUX)[idx], uy = h.kplane(k, GUY)[idx];
    T act = h.kplane(k, ACT)[idx];
    T inv_den = h.kplane(k, INV_DEN)[idx];
    T d3 = (ux * gx + uy * gy) * h.kplane(k, INV_DEN3)[idx];
    T cx = gx * inv_den - ux * d3;
    T cy = gy * inv_den - uy * d3;
    T gi = h.gamma * (T(1) - act);
    T a = sl_alpha(h, k, p);
    h.kplane(k, WX)[idx] = a * (gi * gx + act * cx);
    h.kplane(k, WY)[idx] = a * (gi * gy + act * cy);
  }
}

// out = v + Σₖ Gₖᵀ(WX, WY)ₖ (+ (d − 1)·v for TV-L1), with block partials
// of d·Md (APPLY_DMD).
// The block partials of an operator launch (one per block of its tile):
// s0 (d·Md).  Nothing for APPLY_PLAIN.
template <typename T>
__device__ __forceinline__ void sl_apply_partials(const SL<T>& h, int mode,
                                                  T s0, T* sh) {
  if (mode == APPLY_PLAIN) return;   // uniform over the launch
  T a = block_sum(s0, sh);
  if (threadIdx.x == 0) *h.partial() = a;
}

template <typename T>
__global__ void sl_apply(SL<T> h, const T* __restrict__ v,
                         T* __restrict__ out, int mode) {
  __shared__ T sh[BPL_THREADS];
  long long idx;
  const bool live = sl_pixel(h, idx);
  T s0 = T(0);
  if (live) {
    Pix p = pix_of(idx, h.M, h.N);
    T vv = v[idx];
    T mv = vv;
    for (int k = 0; k < h.K; ++k)
      mv = mv + div_k((const T*)h.kplane(k, WX), (const T*)h.kplane(k, WY),
                      idx, p, h.M, h.N, h.kind[k]);
    if (h.dfac) mv = mv + (h.dfac[idx] - T(1)) * vv;
    out[idx] = mv;
    if (mode == APPLY_DMD) s0 = vv * mv;
  }
  sl_apply_partials(h, mode, s0, sh);
}

// Classic CG start: r = (ū − u) − Mp (Mp in MD), z = r/diag, d = z;
// partials of r·z.
template <typename T>
__global__ void sl_cg_init(SL<T> h) {
  __shared__ T sh[BPL_THREADS];
  long long idx;
  T rz = T(0);
  if (sl_pixel(h, idx)) {
    T r = (h.ut[idx] - h.u[idx]) - h.plane(MD)[idx];
    T z = r / h.plane(INV_DIAG)[idx];
    h.plane(R)[idx] = r;
    h.plane(Z)[idx] = z;
    h.plane(D)[idx] = z;
    rz = r * z;
  }
  T s = block_sum(rz, sh);
  if (threadIdx.x == 0) *h.partial() = s;
}

// One block per tile: sum the tile's partials in a fixed order and form
// the CG scalars of bilevel/pcg.py (zero denominators guarded by nz).
template <typename T>
__global__ void sl_finish(SL<T> h, int mode) {
  __shared__ T sh[BPL_THREADS];
  const int tile = blockIdx.x;
  const T* p0 = h.partials + (long long)tile * h.bpt;
  T a0 = T(0);
  for (int k = threadIdx.x; k < h.bpt; k += BPL_THREADS) a0 += p0[k];
  const T s0 = block_sum(a0, sh);
  if (threadIdx.x != 0) return;
  if (mode == FIN_RZ0) {
    h.slot(S_RZ, tile) = s0;
  } else if (mode == FIN_ALPHA) {          // a = ρ/(d·Md)
    h.slot(S_A, tile) = h.slot(S_RZ, tile) / nz(s0);
  } else {                                 // β = ρ_new/ρ; ρ ← ρ_new
    h.slot(S_BETA, tile) = s0 / nz(h.slot(S_RZ, tile));
    h.slot(S_RZ, tile) = s0;
  }
}

// Classic: p += a d; r −= a Md; z = r/diag; partials of r·z.
template <typename T>
__global__ void sl_cg_update(SL<T> h) {
  __shared__ T sh[BPL_THREADS];
  long long idx;
  T rz = T(0);
  if (sl_pixel(h, idx)) {
    const T a = h.slot(S_A, blockIdx.y);
    h.p[idx] = h.p[idx] + a * h.plane(D)[idx];
    T r = h.plane(R)[idx] - a * h.plane(MD)[idx];
    T z = r / h.plane(INV_DIAG)[idx];
    h.plane(R)[idx] = r;
    h.plane(Z)[idx] = z;
    rz = r * z;
  }
  T s = block_sum(rz, sh);
  if (threadIdx.x == 0) *h.partial() = s;
}

// Classic: d = z + β d.
template <typename T>
__global__ void sl_cg_dir(SL<T> h) {
  long long idx;
  if (!sl_pixel(h, idx)) return;
  const T beta = h.slot(S_BETA, blockIdx.y);
  h.plane(D)[idx] = h.plane(Z)[idx] + beta * h.plane(D)[idx];
}

// One thread per pixel (i, j) of the image plane: gradient map k is
// Σ_b Gₖp·fieldₖ with fieldₖ = (act/den)·Gu + (γ·inact)·Gu, summed over the
// batch in order; and block partials of Σ_b (u − ū)².
template <typename T>
__global__ void sl_gmap(SL<T> h) {
  __shared__ T sh[BPL_THREADS];
  const long long ij = (long long)blockIdx.x * BPL_THREADS + threadIdx.x;
  T c = T(0);
  if (ij < h.mn) {
    Pix p;
    p.i = (int)(ij / h.N);
    p.j = (int)(ij % h.N);
    for (int k = 0; k < h.K; ++k) {
      T acc = T(0);
      for (int b = 0; b < h.B; ++b) {
        const long long idx = (long long)b * h.mn + ij;
        p.b = b;
        T gx, gy;
        grad_k((const T*)h.p, idx, p, h.M, h.N, h.kind[k], gx, gy);
        T ux = h.kplane(k, GUX)[idx], uy = h.kplane(k, GUY)[idx];
        T act = h.kplane(k, ACT)[idx];
        T s = act > T(0) ? h.kplane(k, INV_DEN)[idx] : T(0);   // act/den
        T gi = h.gamma * (T(1) - act);
        T g = gx * (s * ux + gi * ux) + gy * (s * uy + gi * uy);
        acc = b == 0 ? g : acc + g;
      }
      h.gmap[k * h.mn + ij] = acc;
    }
    for (int b = 0; b < h.B; ++b) {
      const long long idx = (long long)b * h.mn + ij;
      T d = h.u[idx] - h.ut[idx];
      c += d * d;
    }
  }
  T s = block_sum(c, sh);
  if (threadIdx.x == 0) h.cost_part[blockIdx.x] = s;
}

// Block (k, e): gradient map k summed over the pixels of parameter entry e
// (rows ⌈pi·M/m⌉ … ⌈(pi+1)·M/m⌉ − 1, likewise columns; the whole plane for
// a scalar α), the adjoint of sl_alpha's upsampling.
template <typename T>
__global__ void sl_pullback(SL<T> h) {
  __shared__ T sh[BPL_THREADS];
  const int k = blockIdx.x / h.P, e = blockIdx.x % h.P;
  const int pi = e / h.pn, pj = e % h.pn;
  const int r0 = (int)(((long long)pi * h.M + h.pm - 1) / h.pm);
  const int r1 = (int)(((long long)(pi + 1) * h.M + h.pm - 1) / h.pm);
  const int c0 = (int)(((long long)pj * h.N + h.pn - 1) / h.pn);
  const int c1 = (int)(((long long)(pj + 1) * h.N + h.pn - 1) / h.pn);
  const int bn = c1 - c0;
  const long long cnt = (long long)(r1 - r0) * bn;
  const T* g = h.gmap + (long long)k * h.mn;
  T acc = T(0);
  for (long long q = threadIdx.x; q < cnt; q += BPL_THREADS)
    acc += g[(long long)(r0 + q / bn) * h.N + c0 + q % bn];
  T s = block_sum(acc, sh);
  if (threadIdx.x == 0) h.gx[blockIdx.x] = s;
}

// One block: Adam on z = log α (g_z = g_x·x, clipped to ±clip where
// use_clip, t ← t + 1, bias corrections 1 − βᵗ), and this step's cost
// ½Σ(u − ū)² and ‖g_x‖.
template <typename T>
__global__ void sl_adam(SL<T> h, int o) {
  __shared__ T sh[BPL_THREADS];
  const int kp = h.K * h.P;
  const T tn = h.t[0] + T(1);
  const T b1t = pow(h.beta1, tn);
  const T b2t = pow(h.beta2, tn);
  T gsq = T(0);
  for (int e = threadIdx.x; e < kp; e += BPL_THREADS) {
    const T g = h.gx[e];
    T gz = g * h.xk[e];
    if (h.use_clip) {
      gz = gz < -h.clip ? -h.clip : gz;
      gz = gz > h.clip ? h.clip : gz;
    }
    const T m = h.beta1 * h.zmv[kp + e] + h.omb1 * gz;
    const T v = h.beta2 * h.zmv[2 * kp + e] + h.omb2 * (gz * gz);
    const T mhat = m / (T(1) - b1t);
    const T vhat = v / (T(1) - b2t);
    h.zmv[e] = h.zmv[e] - h.lr * mhat / (sqrt(vhat) + h.eps);
    h.zmv[kp + e] = m;
    h.zmv[2 * kp + e] = v;
    gsq += g * g;
  }
  T c = T(0);
  for (int b = threadIdx.x; b < h.nb_mn; b += BPL_THREADS) c += h.cost_part[b];
  const T G = block_sum(gsq, sh);
  const T C = block_sum(c, sh);
  if (threadIdx.x == 0) {
    h.traj_cost[o] = T(0.5) * C;
    h.traj_gnorm[o] = sqrt(G);
    h.t[0] = tn;
  }
}

// αₖ as an (M, N) map per regularizer (amap: K × M·N), for the TV-L1 CP
// kernel (tvl1.cuh), which reads a map weight per pixel: the same values
// as sl_alpha.
template <typename T>
__global__ void sl_amap(SL<T> h, T* __restrict__ amap) {
  const long long ij = (long long)blockIdx.x * BPL_THREADS + threadIdx.x;
  if (ij >= h.mn) return;
  Pix p;
  p.b = 0;
  p.i = (int)(ij / h.N);
  p.j = (int)(ij % h.N);
  for (int k = 0; k < h.K; ++k) amap[k * h.mn + ij] = sl_alpha(h, k, p);
}

// Points h's scratch parts into `scratch` by the layout z; the work planes
// come first.  Defaults: no clip; the caller sets D (dfac).
template <typename T>
void sl_bind(SL<T>& h, T* scratch, const SlSizes& z, long long n, int M,
             int N) {
  h.w = scratch;
  h.gmap = h.w + z.planes;
  h.xk = h.gmap + z.gmap;
  h.gx = h.xk + z.kp;
  h.partials = h.gx + z.kp;
  h.cost_part = h.partials + z.partials;
  h.scal = h.cost_part + z.cost_part;
  h.mn = (long long)M * N;
  h.n = n;
  h.tile_n = z.tile_n;
  h.M = M;
  h.N = N;
  h.n_tiles = z.n_tiles;
  h.bpt = z.bpt;
  h.nb_mn = z.nb_mn;
  h.dfac = nullptr;
  h.gamma_d = T(0);
  h.inv_gd = T(0);
  h.use_clip = 0;
  h.clip = T(0);
}

// The parameter, Adam and trajectory parts of h (shared by every learner):
// patch grid pm × pn per regularizer, K regularizers, the Adam constants.
template <typename T>
void sl_bind_opt(SL<T>& h, T* zmv, T* t, T* traj_x, T* traj_cost,
                 T* traj_gnorm, int B, int K, int pm, int pn, T lr, T beta1,
                 T beta2, T omb1, T omb2, T eps) {
  h.zmv = zmv;
  h.t = t;
  h.traj_x = traj_x;
  h.traj_cost = traj_cost;
  h.traj_gnorm = traj_gnorm;
  h.B = B;
  h.K = K;
  h.pm = pm;
  h.pn = pn;
  h.P = pm * pn;
  h.lr = lr;
  h.beta1 = beta1;
  h.beta2 = beta2;
  h.omb1 = omb1;
  h.omb2 = omb2;
  h.eps = eps;
}

// n_adj classic preconditioned-CG steps from the warm h.p, with inner
// products per tile (bilevel/pcg.py; solvers/krylov.py::cg_batched with
// tol 0 when a tile is one image).  The caller has put M·p into MD;
// apply_d() must write M·d into MD with the partials of d·Md
// (APPLY_DMD).
template <typename T, typename ApplyD>
void sl_cg_classic(const SL<T>& h, int n_adj, cudaStream_t s,
                   ApplyD apply_d) {
  const dim3 grid(h.bpt, h.n_tiles);
  BPL_LAUNCH(sl_cg_init<T>, grid, BPL_THREADS, s)(h);
  BPL_LAUNCH(sl_finish<T>, h.n_tiles, BPL_THREADS, s)(h, FIN_RZ0);
  for (int k = 0; k < n_adj; ++k) {
    apply_d();
    BPL_LAUNCH(sl_finish<T>, h.n_tiles, BPL_THREADS, s)(h, FIN_ALPHA);
    BPL_LAUNCH(sl_cg_update<T>, grid, BPL_THREADS, s)(h);
    BPL_LAUNCH(sl_finish<T>, h.n_tiles, BPL_THREADS, s)(h, FIN_BETA);
    BPL_LAUNCH(sl_cg_dir<T>, grid, BPL_THREADS, s)(h);
  }
}

// The end of outer step o, after the gradient maps and cost partials:
// the pullback onto the parameter and Adam.
template <typename T>
void sl_step_tail(const SL<T>& h, int o, cudaStream_t s) {
  BPL_LAUNCH(sl_pullback<T>, h.K * h.P, BPL_THREADS, s)(h);
  BPL_LAUNCH(sl_adam<T>, 1, BPL_THREADS, s)(h, o);
}

// The outer loop of the TV-L1 learner, each step:
// x = exp(z), α as (M, N) maps into amap, n_inner cp_step(), setup() (the
// system at u and its diagonal), apply(v, out, mode) (H·v into out, with
// the partials of mode) on the warm λ = h.p and in n_adj classic CG
// steps, gmap() (the gradient maps and cost partials), the pullback and
// Adam.  Returns a cudaError_t.
template <typename T, typename CpStep, typename Setup, typename Apply,
          typename GMap>
int sl_run(const SL<T>& h, T* amap, int outer, int n_inner, int n_adj,
           cudaStream_t s, CpStep cp_step, Setup setup, Apply apply,
           GMap gmap) {
  T* const md = h.w + (long long)MD * h.n;
  const T* const d = h.w + (long long)D * h.n;
  cudaError_t err;
  for (int o = 0; o < outer; ++o) {
    BPL_LAUNCH(sl_exp<T>, 1, BPL_THREADS, s)(h, o);
    BPL_LAUNCH(sl_amap<T>, h.nb_mn, BPL_THREADS, s)(h, amap);
    for (int it = 0; it < n_inner; ++it) cp_step();
    setup();
    apply((const T*)h.p, md, APPLY_PLAIN);
    sl_cg_classic(h, n_adj, s, [&]() { apply(d, md, APPLY_DMD); });
    gmap();
    sl_step_tail(h, o, s);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

// The argument checks every learner's entry shares.
inline bool sl_bad_args(long long B, int M, int N, int pm, int pn,
                        int outer, int n_inner, int n_adj) {
  return B < 1 || M < 1 || N < 1 || pm < 1 || pn < 1 || pm > M || pn > N
         || outer < 0 || n_inner < 0 || n_adj < 0;
}

// ---------------------------------------- rows 11 and 13's shared parts
//
// The cluster-design learners (single_loop_tgv.cu, single_loop_vtv.cu)
// keep their state in a struct H of their own; the parts below read its
// members zmv (3 × K × P: z, Adam m, Adam v), t, traj_x, traj_cost,
// traj_gnorm, gmap (K × M·N), xk and gx (K × P), part (B × bpt CG
// partials), cost_part (nb_mn), count (B + 1 counters), mn, B, M, N, pm,
// pn, P, bpt, nb_mn, outer and Adam's lr, beta1, beta2, omb1, omb2, eps.

// αₖ at pixel (i, j): the patch entry min(i·m // M, m − 1),
// min(j·n // N, n − 1) (sl_alpha), no division for a scalar weight.
template <typename T, class H>
__device__ __forceinline__ T slx_alpha(const H& h, int k, int i, int j) {
  if (h.P == 1) return h.xk[k];
  int pi = (int)((long long)i * h.pm / h.M);
  int pj = (int)((long long)j * h.pn / h.N);
  pi = pi < h.pm - 1 ? pi : h.pm - 1;
  pj = pj < h.pn - 1 ? pj : h.pn - 1;
  return h.xk[k * h.P + pi * h.pn + pj];
}

// The block sum of v into partial block `block` of image blockIdx.y.
template <typename T, class H>
__device__ __forceinline__ void slx_partial(const H& h, long long block, T v,
                                            T* sh) {
  const T a = block_sum(v, sh);
  if (threadIdx.x == 0) h.part[(long long)blockIdx.y * h.bpt + block] = a;
}

// After the block's partials: the image's last block to arrive sums the
// image's partials in sl_finish's order into *out and returns true (in
// every thread), else false.  An integer counter, no float atomics.
template <typename T, class H>
__device__ bool slx_image_sum(const H& h, T* out, T* sh) {
  __shared__ int last;
  const long long b = blockIdx.y;
  if (threadIdx.x == 0) {
    __threadfence();
    last = atomicAdd(&h.count[b], 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return false;
  __threadfence();
  T c = T(0);
  for (int k = threadIdx.x; k < h.bpt; k += BPL_THREADS)
    c += __ldcg(h.part + b * h.bpt + k);
  *out = block_sum(c, sh);
  if (threadIdx.x == 0) h.count[b] = 0;
  return true;
}

// x = exp(z) for the first step of a segment, recorded in its trajectory;
// the counters zeroed.
template <typename T, int K, class H>
__global__ void slx_begin(H h) {
  const int kp = K * h.P;
  for (int e = threadIdx.x; e < kp; e += BPL_THREADS) {
    const T x = exp(h.zmv[e]);
    h.xk[e] = x;
    h.traj_x[e] = x;
  }
  for (int g = threadIdx.x; g <= h.B; g += BPL_THREADS) h.count[g] = 0;
}

// Block (k, e): gradient map k summed over the pixels of parameter entry e
// (sl_pullback).  The last block to finish runs Adam on z = log α
// (sl_adam: g_z = g_x·x, t ← t + 1, bias corrections 1 − βᵗ), writes this
// step's cost ½Σ(u − ū)² from the cost partials and ‖g_x‖, and forms
// x = exp(z) for step o + 1.
template <typename T, int K, class H>
__global__ void __launch_bounds__(BPL_THREADS) slx_pull_adam(H h, int o) {
  __shared__ T sh[BPL_THREADS];
  __shared__ int last;
  const int k = blockIdx.x / h.P, e = blockIdx.x % h.P;
  const int pi = e / h.pn, pj = e % h.pn;
  const int r0 = (int)(((long long)pi * h.M + h.pm - 1) / h.pm);
  const int r1 = (int)(((long long)(pi + 1) * h.M + h.pm - 1) / h.pm);
  const int c0 = (int)(((long long)pj * h.N + h.pn - 1) / h.pn);
  const int c1 = (int)(((long long)(pj + 1) * h.N + h.pn - 1) / h.pn);
  const int bn = c1 - c0;
  const int cnt = (r1 - r0) * bn;      // ≤ M·N < 2³¹
  const T* g = h.gmap + (long long)k * h.mn;
  T acc = T(0);
  // the entry's pixels q = threadIdx.x, + 256, … in row-major order, at
  // (r0 + q / bn, c0 + q % bn): one division a thread, then a carry
  int q = threadIdx.x;
  int i = r0 + q / bn, j = c0 + q % bn;
  const int di = BPL_THREADS / bn, dj = BPL_THREADS % bn;
  for (; q < cnt; q += BPL_THREADS) {
    acc += g[(long long)i * h.N + j];
    i += di;
    j += dj;
    if (j >= c1) {
      j -= bn;
      ++i;
    }
  }
  const T sum = block_sum(acc, sh);
  unsigned* done = h.count + h.B;
  if (threadIdx.x == 0) {
    h.gx[blockIdx.x] = sum;
    __threadfence();
    last = atomicAdd(done, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int kp = K * h.P;
  const T tn = h.t[0] + T(1);
  const T b1t = pow(h.beta1, tn);
  const T b2t = pow(h.beta2, tn);
  T gsq = T(0);
  for (int q = threadIdx.x; q < kp; q += BPL_THREADS) {
    const T gq = __ldcg(h.gx + q);
    const T gz = gq * h.xk[q];
    const T m = h.beta1 * h.zmv[kp + q] + h.omb1 * gz;
    const T v = h.beta2 * h.zmv[2 * kp + q] + h.omb2 * (gz * gz);
    const T mhat = m / (T(1) - b1t);
    const T vhat = v / (T(1) - b2t);
    const T zn = h.zmv[q] - h.lr * mhat / (sqrt(vhat) + h.eps);
    h.zmv[q] = zn;
    h.zmv[kp + q] = m;
    h.zmv[2 * kp + q] = v;
    gsq += gq * gq;
    if (o + 1 < h.outer) {
      const T x = exp(zn);
      h.xk[q] = x;
      h.traj_x[(long long)(o + 1) * kp + q] = x;
    }
  }
  T c = T(0);
  for (int q = threadIdx.x; q < h.nb_mn; q += BPL_THREADS)
    c += h.cost_part[q];
  const T G = block_sum(gsq, sh);
  const T C = block_sum(c, sh);
  if (threadIdx.x == 0) {
    h.traj_cost[o] = T(0.5) * C;
    h.traj_gnorm[o] = sqrt(G);
    h.t[0] = tn;
    *done = 0;
  }
}

}  // namespace bpl
