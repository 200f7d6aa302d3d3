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
#include "common.cuh"

namespace bpl {

#define SL_MAXK 8

// B·M·N work planes.  Classic CG: R = r, Z = z, D = d, MD = Md.
// Pipelined CG: R = r, Z = u = P⁻¹r, MD = w = Au, D = the direction,
// S = s.  Then, per regularizer k, K_PLANES planes from SL_BASE.
enum SlPlane { UBAR, R, Z, D, MD, S, INV_DIAG, SL_BASE };
enum SlKPlane { GUX, GUY, ACT, INV_DEN, INV_DEN3, WX, WY, K_PLANES };
// per-tile device scalars
enum SlSlot { S_RZ, S_A, S_BETA, S_GPREV, S_APREV, N_SL_SLOTS };
// what sl_apply sums; what sl_finish forms from the sums
enum SlApply { APPLY_PLAIN, APPLY_DMD, APPLY_PIPE };
enum SlFinish { FIN_RZ0, FIN_ALPHA, FIN_BETA, FIN_PIPE };

// Element counts of the scratch buffer's parts.
struct SlSizes {
  long long planes, gmap, kp, partials, cost_part, scal, total;
  long long tile_n;
  int bpt, n_tiles, nb_mn;
};

static SlSizes sl_sizes(long long B, int M, int N, int K, int P,
                        int tile_b) {
  SlSizes z;
  const long long mn = (long long)M * N;
  const long long n = B * mn;
  z.tile_n = (long long)tile_b * mn;
  z.bpt = blocks_for(z.tile_n);
  z.n_tiles = (int)((B + tile_b - 1) / tile_b);
  z.nb_mn = blocks_for(mn);
  z.planes = (long long)(SL_BASE + K * K_PLANES) * n;
  z.gmap = (long long)K * mn;
  z.kp = (long long)K * P;
  z.partials = 2LL * z.n_tiles * z.bpt;
  z.cost_part = z.nb_mn;
  z.scal = (long long)N_SL_SLOTS * z.n_tiles;
  z.total = z.planes + z.gmap + 2 * z.kp + z.partials + z.cost_part + z.scal;
  return z;
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
  T* partials;  // 2 × n_tiles × bpt
  T* cost_part; // nb_mn
  T* scal;      // N_SL_SLOTS × n_tiles
  long long n, mn, tile_n;
  int B, M, N, K, pm, pn, P, n_tiles, bpt, nb_mn;
  int kind[SL_MAXK];
  T tau, sigma, gamma, lr, beta1, beta2, omb1, omb2, eps;
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
  __device__ T* partial(int which) const {
    return partials + ((long long)which * n_tiles + blockIdx.y) * bpt
           + blockIdx.x;
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

// 1/diag, diag = 1 + Σₖ gramₖ(WX, WY).
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
  h.plane(INV_DIAG)[idx] = T(1) / diag;
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

// out = v + Σₖ Gₖᵀ(WX, WY)ₖ, with block partials of d·Md (APPLY_DMD) or of
// r·u and w·u (APPLY_PIPE, v = u, out = w).
template <typename T>
__global__ void sl_apply(SL<T> h, const T* __restrict__ v,
                         T* __restrict__ out, int mode) {
  __shared__ T sh[BPL_THREADS];
  long long idx;
  const bool live = sl_pixel(h, idx);
  T s0 = T(0), s1 = T(0);
  if (live) {
    Pix p = pix_of(idx, h.M, h.N);
    T vv = v[idx];
    T mv = vv;
    for (int k = 0; k < h.K; ++k)
      mv = mv + div_k((const T*)h.kplane(k, WX), (const T*)h.kplane(k, WY),
                      idx, p, h.M, h.N, h.kind[k]);
    out[idx] = mv;
    if (mode == APPLY_DMD) {
      s0 = vv * mv;
    } else if (mode == APPLY_PIPE) {
      s0 = h.plane(R)[idx] * vv;
      s1 = mv * vv;
    }
  }
  if (mode == APPLY_PLAIN) return;   // uniform over the launch
  T a = block_sum(s0, sh);
  T b = block_sum(s1, sh);
  if (threadIdx.x == 0) {
    *h.partial(0) = a;
    if (mode == APPLY_PIPE) *h.partial(1) = b;
  }
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
    T z = h.plane(INV_DIAG)[idx] * r;
    h.plane(R)[idx] = r;
    h.plane(Z)[idx] = z;
    h.plane(D)[idx] = z;
    rz = r * z;
  }
  T s = block_sum(rz, sh);
  if (threadIdx.x == 0) *h.partial(0) = s;
}

// Pipelined CG start: r = (ū − u) − Mp, u = r/diag, direction = s = 0.
template <typename T>
__global__ void sl_pipe_init(SL<T> h) {
  long long idx;
  if (!sl_pixel(h, idx)) return;
  T r = (h.ut[idx] - h.u[idx]) - h.plane(MD)[idx];
  h.plane(R)[idx] = r;
  h.plane(Z)[idx] = h.plane(INV_DIAG)[idx] * r;
  h.plane(D)[idx] = T(0);
  h.plane(S)[idx] = T(0);
}

// One block per tile: sum the tile's partials in a fixed order and form
// the CG scalars of bilevel/pcg.py (zero denominators guarded by nz).
template <typename T>
__global__ void sl_finish(SL<T> h, int mode, int first) {
  __shared__ T sh[BPL_THREADS];
  const int tile = blockIdx.x;
  const T* p0 = h.partials + (long long)tile * h.bpt;
  const T* p1 = h.partials + ((long long)h.n_tiles + tile) * h.bpt;
  T a0 = T(0), a1 = T(0);
  for (int k = threadIdx.x; k < h.bpt; k += BPL_THREADS) {
    a0 += p0[k];
    if (mode == FIN_PIPE) a1 += p1[k];
  }
  const T s0 = block_sum(a0, sh);
  const T s1 = block_sum(a1, sh);
  if (threadIdx.x != 0) return;
  if (mode == FIN_RZ0) {
    h.slot(S_RZ, tile) = s0;
  } else if (mode == FIN_ALPHA) {          // a = ρ/(d·Md)
    h.slot(S_A, tile) = h.slot(S_RZ, tile) / nz(s0);
  } else if (mode == FIN_BETA) {           // β = ρ_new/ρ; ρ ← ρ_new
    h.slot(S_BETA, tile) = s0 / nz(h.slot(S_RZ, tile));
    h.slot(S_RZ, tile) = s0;
  } else {                                 // γ = (r, u), δ = (w, u)
    const T g = s0, d = s1;
    const T gp = first ? T(1) : h.slot(S_GPREV, tile);
    const T ap = first ? T(1) : h.slot(S_APREV, tile);
    const T beta = first ? T(0) : g / nz(gp);
    const T a = g / nz(d - beta * g / nz(ap));
    h.slot(S_BETA, tile) = beta;
    h.slot(S_A, tile) = a;
    h.slot(S_GPREV, tile) = g;
    h.slot(S_APREV, tile) = a;
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
    T z = h.plane(INV_DIAG)[idx] * r;
    h.plane(R)[idx] = r;
    h.plane(Z)[idx] = z;
    rz = r * z;
  }
  T s = block_sum(rz, sh);
  if (threadIdx.x == 0) *h.partial(0) = s;
}

// Classic: d = z + β d.
template <typename T>
__global__ void sl_cg_dir(SL<T> h) {
  long long idx;
  if (!sl_pixel(h, idx)) return;
  const T beta = h.slot(S_BETA, blockIdx.y);
  h.plane(D)[idx] = h.plane(Z)[idx] + beta * h.plane(D)[idx];
}

// Pipelined: direction = u + β·direction; s = w + β s; p += a·direction;
// r −= a s; and the next iteration's u = r/diag.
template <typename T>
__global__ void sl_pipe_update(SL<T> h) {
  long long idx;
  if (!sl_pixel(h, idx)) return;
  const T beta = h.slot(S_BETA, blockIdx.y);
  const T a = h.slot(S_A, blockIdx.y);
  T dir = h.plane(Z)[idx] + beta * h.plane(D)[idx];
  T s = h.plane(MD)[idx] + beta * h.plane(S)[idx];
  h.p[idx] = h.p[idx] + a * dir;
  T r = h.plane(R)[idx] - a * s;
  h.plane(D)[idx] = dir;
  h.plane(S)[idx] = s;
  h.plane(R)[idx] = r;
  h.plane(Z)[idx] = h.plane(INV_DIAG)[idx] * r;
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

// One block: Adam on z = log α (g_z = g_x·x, t ← t + 1, bias corrections
// 1 − βᵗ), and this step's cost ½Σ(u − ū)² and ‖g_x‖.
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
    const T gz = g * h.xk[e];
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

template <typename T>
int single_loop(SL<T> h, int outer, int n_inner, int n_adj, int pipelined,
                cudaStream_t s) {
  const dim3 grid(h.bpt, h.n_tiles);
  const int kp = h.K * h.P;
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
      BPL_LAUNCH(sl_cg_init<T>, grid, BPL_THREADS, s)(h);
      BPL_LAUNCH(sl_finish<T>, h.n_tiles, BPL_THREADS, s)(h, FIN_RZ0, 0);
      for (int k = 0; k < n_adj; ++k) {
        BPL_LAUNCH(sl_weights<T>, grid, BPL_THREADS, s)(h, d);
        BPL_LAUNCH(sl_apply<T>, grid, BPL_THREADS, s)(h, d, md, APPLY_DMD);
        BPL_LAUNCH(sl_finish<T>, h.n_tiles, BPL_THREADS, s)(h, FIN_ALPHA, 0);
        BPL_LAUNCH(sl_cg_update<T>, grid, BPL_THREADS, s)(h);
        BPL_LAUNCH(sl_finish<T>, h.n_tiles, BPL_THREADS, s)(h, FIN_BETA, 0);
        BPL_LAUNCH(sl_cg_dir<T>, grid, BPL_THREADS, s)(h);
      }
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
    BPL_LAUNCH(sl_pullback<T>, kp, BPL_THREADS, s)(h);
    BPL_LAUNCH(sl_adam<T>, 1, BPL_THREADS, s)(h, o);
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
  if (B < 1 || M < 1 || N < 1 || K < 1 || K > SL_MAXK || pm < 1 || pn < 1
      || pm > M || pn > N || tile_b < 1 || outer < 0 || n_inner < 0
      || n_adj < 0)
    return (int)cudaErrorInvalidValue;
  const int P = pm * pn;
  const SlSizes z = sl_sizes(B, M, N, K, P, tile_b);
  SL<T> h;
  h.f = f;
  h.ut = ut;
  h.u = u;
  h.ys = ys;
  h.p = p;
  h.zmv = zmv;
  h.t = t;
  h.traj_x = traj_x;
  h.traj_cost = traj_cost;
  h.traj_gnorm = traj_gnorm;
  h.w = scratch;
  h.gmap = h.w + z.planes;
  h.xk = h.gmap + z.gmap;
  h.gx = h.xk + z.kp;
  h.partials = h.gx + z.kp;
  h.cost_part = h.partials + z.partials;
  h.scal = h.cost_part + z.cost_part;
  h.mn = (long long)M * N;
  h.n = B * h.mn;
  h.tile_n = z.tile_n;
  h.B = (int)B;
  h.M = M;
  h.N = N;
  h.K = K;
  h.pm = pm;
  h.pn = pn;
  h.P = P;
  h.n_tiles = z.n_tiles;
  h.bpt = z.bpt;
  h.nb_mn = z.nb_mn;
  for (int k = 0; k < SL_MAXK; ++k) h.kind[k] = (kinds >> (2 * k)) & 3;
  h.tau = tau;
  h.sigma = sigma;
  h.gamma = gamma;
  h.lr = lr;
  h.beta1 = beta1;
  h.beta2 = beta2;
  h.omb1 = omb1;
  h.omb2 = omb2;
  h.eps = eps;
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
