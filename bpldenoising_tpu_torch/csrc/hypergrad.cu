// Kernel B: augmented-Lagrangian exact hypergradient with Jacobi-PCG, and
// its γ-regularized form, for K ≤ 3 regularizer blocks, each with its own
// stencil (forward, backward, centred) and a scalar or (M, N) map weight.
//
// Replaces the TPU kernel bpldenoising_tpu/solvers/hypergrad_pallas.py::_hg_kernel
// (dispatched by _run), which keeps the whole AL iteration resident in VMEM.
// It solves, as ONE joint system over the image batch,
//   M p = b,  M = I + Σₖ Gₖᵀ[μ·actₖ + inactₖ·αₖ·Hₖ]Gₖ      (exact form)
//             M = I + Σₖ αₖ·Gₖᵀ[γ·inactₖ + actₖ·Hₖ]Gₖ     (regularized form)
// with Hₖ v = v/denₖ − Guₖ (Guₖ·v)/denₖ³, the Jacobi preconditioner from the
// stencils' Gram diagonals, CG stopped at ‖r‖ ≤ cg_tol·‖b‖ or cg_maxiter,
// `al_iters` multiplier updates λₖ ← λₖ + μ·actₖ·Gₖp (exact form only) and
// the warm start p0; then dJ/dαₖ = ∓Σ Gₖp·Guₖ·fieldₖ, as K scalars or, for
// map weights, as K per-pixel maps (O, M, N) that the caller pulls back.
// The sums over k are taken k = 0, 1, 2 in order, as in the plain version.
//
// What bounds it on an H100: each CG iteration applies the stencil operator
// and needs two batch-wide dot products, i.e. two global synchronisations.
// A grid-wide barrier inside one launch deadlocks when more blocks are
// launched than fit on the card, so kernel boundaries are the
// synchronisation: per CG iteration, W·Gd → Md = d + GᵀW with per-block
// partial sums of d·Md → a one-block second pass → the update of p, r, z
// with partials of r·z and r·r → second pass → d = z + βd.  The step
// scalars never leave the device (α and β are formed from the sums by the
// threads that use them); the host reads one scalar, ‖r‖², per iteration
// for the stop test.  Partial sums are written per block and added in a
// fixed order (no float atomics), so repeated runs agree bit for bit and
// the trust region's accept/reject decisions cannot flip between runs.
// The 6 + 10K working planes (K = 1 at 10×128² f32: 10.5 MB; K = 3: 23.6
// MB) stay in the 50 MB L2; at the flagship size each launch is short, so the solve is bound by launch
// and host-read latency, not by bytes or operations.
#include "common.cuh"

namespace bpl {

// Work planes (each n = O·M·N elements): six shared by the blocks, then
// ten per block k (PER_K of them, from plane SHARED + PER_K·k).
enum Plane { INV_DIAG, RHS, RES, ZZ, DIR, MDIR, SHARED };
enum KPlane {
  GUX, GUY, ACT, DEN, INV_DEN, INV_DEN3, WX, WY, LAMX, LAMY, PER_K
};
// device scalar slots; GRAD0 + k holds block k's gradient
enum Slot { RZ0, RZ1, DEN_DM, RR, BB, JUNK, GRAD0, N_SLOTS = GRAD0 + 3 };

template <typename T>
struct HG {
  const T* u;
  const T* ut;
  T* p;
  T* w;          // SHARED + PER_K·K planes
  T* partials;   // 3 × nblocks
  T* scal;       // N_SLOTS
  T* gmaps;      // K gradient maps of n elements, or nullptr: K scalars
  long long n;
  int M, N, nblocks, K;
  int kind[3];
  T alpha[3];
  const T* amap[3];   // (M, N) weight maps, nullptr: the scalar alpha[k]
  T act_tol, gamma, mu;
  int reg;
  __host__ __device__ T* plane(int s) const { return w + (long long)s * n; }
  __host__ __device__ T* kplane(int k, int s) const {
    return w + (long long)(SHARED + PER_K * k + s) * n;
  }
  // block k's weight at flat index idx (a map is broadcast over the batch)
  __device__ T alpha_at(int k, long long idx) const {
    return amap[k] != nullptr ? amap[k][idx % ((long long)M * N)] : alpha[k];
  }
};

// Gᵀ(act·λ) along one axis: common.cuh's adj1 on the product, whose
// factors are read at the same neighbours.
template <typename T>
__device__ __forceinline__ T adj1_prod(const T* a, const T* q, long long idx,
                                       int i, int n, long long s, int kind) {
  if (kind == STENCIL_FWD) {
    T lo = i >= 1 ? a[idx - s] * q[idx - s] : T(0);
    T hi = i < n - 1 ? a[idx] * q[idx] : T(0);
    return lo - hi;
  }
  if (kind == STENCIL_BWD) {
    T lo = i >= 1 ? a[idx] * q[idx] : T(0);
    T hi = i < n - 1 ? a[idx + s] * q[idx + s] : T(0);
    return lo - hi;
  }
  T down = i >= 2 ? a[idx - s] * q[idx - s] : T(0);
  T up = i <= n - 3 ? a[idx + s] * q[idx + s] : T(0);
  return (down - up) * T(0.5);
}

// Per block: Gu, the active set, den, 1/den, 1/den³ and the diagonal
// weights (into WX, WY), in the arithmetic order of solvers/hypergrad.py.
template <typename T>
__global__ void hg_setup(HG<T> h) {
  long long idx = (long long)blockIdx.x * BPL_THREADS + threadIdx.x;
  if (idx >= h.n) return;
  Pix p = pix_of(idx, h.M, h.N);
  for (int k = 0; k < h.K; ++k) {
    T gx, gy;
    grad_k(h.u, idx, p, h.M, h.N, h.kind[k], gx, gy);
    T nG = sqrt(gx * gx + gy * gy);
    T act, den;
    if (h.reg) {
      act = (nG > T(1) / h.gamma) ? T(1) : T(0);
      den = act > T(0) ? nG : T(1);
    } else {
      act = (nG < h.act_tol) ? T(1) : T(0);
      den = act > T(0) ? T(1) : nG;
    }
    const T alpha = h.alpha_at(k, idx);
    T inact = T(1) - act;
    T inv_den = T(1) / den;
    T inv_den3 = inv_den * inv_den * inv_den;
    T rden = T(1) / den;
    T rden3 = T(1) / (den * den * den);
    T hx = rden - (gx * gx) * rden3;
    T hy = rden - (gy * gy) * rden3;
    T wdx, wdy;
    if (h.reg) {
      wdx = alpha * (h.gamma * inact + act * hx);
      wdy = alpha * (h.gamma * inact + act * hy);
    } else {
      wdx = h.mu * act + (inact * alpha) * hx;
      wdy = h.mu * act + (inact * alpha) * hy;
    }
    h.kplane(k, GUX)[idx] = gx;
    h.kplane(k, GUY)[idx] = gy;
    h.kplane(k, ACT)[idx] = act;
    h.kplane(k, DEN)[idx] = den;
    h.kplane(k, INV_DEN)[idx] = inv_den;
    h.kplane(k, INV_DEN3)[idx] = inv_den3;
    h.kplane(k, WX)[idx] = wdx;
    h.kplane(k, WY)[idx] = wdy;
  }
}

// 1/diag with diag = 1 + Σₖ gramₖ(WXₖ, WYₖ), k in order.
template <typename T>
__global__ void hg_diag(HG<T> h) {
  long long idx = (long long)blockIdx.x * BPL_THREADS + threadIdx.x;
  if (idx >= h.n) return;
  Pix p = pix_of(idx, h.M, h.N);
  T diag = T(1);
  for (int k = 0; k < h.K; ++k)
    diag = diag + gram_k(h.kplane(k, WX), h.kplane(k, WY), idx, p, h.M, h.N,
                         h.kind[k]);
  h.plane(INV_DIAG)[idx] = T(1) / diag;
}

// (WXₖ, WYₖ) = Wₖ·Gₖv: the per-pixel dual-space blocks applied to Gₖv.
template <typename T>
__global__ void hg_weights(HG<T> h, const T* __restrict__ v) {
  long long idx = (long long)blockIdx.x * BPL_THREADS + threadIdx.x;
  if (idx >= h.n) return;
  Pix p = pix_of(idx, h.M, h.N);
  for (int k = 0; k < h.K; ++k) {
    T gx, gy;
    grad_k(v, idx, p, h.M, h.N, h.kind[k], gx, gy);
    const T alpha = h.alpha_at(k, idx);
    T ux = h.kplane(k, GUX)[idx], uy = h.kplane(k, GUY)[idx];
    T act = h.kplane(k, ACT)[idx];
    T inact = T(1) - act;
    T inv_den = h.kplane(k, INV_DEN)[idx];
    T dot3 = (ux * gx + uy * gy) * h.kplane(k, INV_DEN3)[idx];
    T cx = gx * inv_den - ux * dot3;
    T cy = gy * inv_den - uy * dot3;
    T wx, wy;
    if (h.reg) {
      wx = alpha * ((h.gamma * inact) * gx + act * cx);
      wy = alpha * ((h.gamma * inact) * gy + act * cy);
    } else {
      wx = (h.mu * act) * gx + (inact * alpha) * cx;
      wy = (h.mu * act) * gy + (inact * alpha) * cy;
    }
    h.kplane(k, WX)[idx] = wx;
    h.kplane(k, WY)[idx] = wy;
  }
}

// out = v + Σₖ Gₖᵀ(WXₖ, WYₖ), k in order; partials of v·out (slot 0) when
// `dot`.
template <typename T>
__global__ void hg_apply(HG<T> h, const T* __restrict__ v, T* __restrict__ out,
                         int dot) {
  __shared__ T sh[BPL_THREADS];
  long long idx = (long long)blockIdx.x * BPL_THREADS + threadIdx.x;
  const bool live = idx < h.n;
  T vo = T(0);
  if (live) {
    Pix p = pix_of(idx, h.M, h.N);
    T mv = v[idx];
    for (int k = 0; k < h.K; ++k)
      mv = mv + div_k(h.kplane(k, WX), h.kplane(k, WY), idx, p, h.M, h.N,
                      h.kind[k]);
    out[idx] = mv;
    vo = v[idx] * mv;
  }
  if (dot) {
    T s = block_sum(vo, sh);
    if (threadIdx.x == 0) h.partials[blockIdx.x] = s;
  }
}

// CG start: r = b − Mp (Mp in MDIR), z = r/diag, d = z; partials of r·z,
// r·r, b·b.
template <typename T>
__global__ void hg_cg_init(HG<T> h) {
  __shared__ T sh[BPL_THREADS];
  long long idx = (long long)blockIdx.x * BPL_THREADS + threadIdx.x;
  const bool live = idx < h.n;
  T rz = T(0), rr = T(0), bb = T(0);
  if (live) {
    T b = h.plane(RHS)[idx];
    T r = b - h.plane(MDIR)[idx];
    T z = h.plane(INV_DIAG)[idx] * r;
    h.plane(RES)[idx] = r;
    h.plane(ZZ)[idx] = z;
    h.plane(DIR)[idx] = z;
    rz = r * z;
    rr = r * r;
    bb = b * b;
  }
  T s0 = block_sum(rz, sh);
  T s1 = block_sum(rr, sh);
  T s2 = block_sum(bb, sh);
  if (threadIdx.x == 0) {
    h.partials[blockIdx.x] = s0;
    h.partials[h.nblocks + blockIdx.x] = s1;
    h.partials[2 * h.nblocks + blockIdx.x] = s2;
  }
}

// a = rz/(d·Md); p += a d; r −= a Md; z = r/diag; partials of r·z, r·r.
template <typename T>
__global__ void hg_cg_update(HG<T> h, int cur) {
  __shared__ T sh[BPL_THREADS];
  long long idx = (long long)blockIdx.x * BPL_THREADS + threadIdx.x;
  const bool live = idx < h.n;
  const T a = h.scal[RZ0 + cur] / nz(h.scal[DEN_DM]);
  T rz = T(0), rr = T(0);
  if (live) {
    T d = h.plane(DIR)[idx];
    h.p[idx] = h.p[idx] + a * d;
    T r = h.plane(RES)[idx] - a * h.plane(MDIR)[idx];
    T z = h.plane(INV_DIAG)[idx] * r;
    h.plane(RES)[idx] = r;
    h.plane(ZZ)[idx] = z;
    rz = r * z;
    rr = r * r;
  }
  T s0 = block_sum(rz, sh);
  T s1 = block_sum(rr, sh);
  if (threadIdx.x == 0) {
    h.partials[blockIdx.x] = s0;
    h.partials[h.nblocks + blockIdx.x] = s1;
  }
}

// β = rz_new/rz; d = z + β d.
template <typename T>
__global__ void hg_cg_dir(HG<T> h, int cur) {
  long long idx = (long long)blockIdx.x * BPL_THREADS + threadIdx.x;
  if (idx >= h.n) return;
  const T beta = h.scal[RZ0 + (1 - cur)] / nz(h.scal[RZ0 + cur]);
  h.plane(DIR)[idx] = h.plane(ZZ)[idx] + beta * h.plane(DIR)[idx];
}

// Right-hand side: exact b = (u − ū) − Σₖ Gₖᵀ(actₖ·λₖ), k in order;
// regularized b = ū − u.
template <typename T>
__global__ void hg_rhs(HG<T> h) {
  long long idx = (long long)blockIdx.x * BPL_THREADS + threadIdx.x;
  if (idx >= h.n) return;
  if (h.reg) {
    h.plane(RHS)[idx] = h.ut[idx] - h.u[idx];
    return;
  }
  Pix p = pix_of(idx, h.M, h.N);
  T b = h.u[idx] - h.ut[idx];
  for (int k = 0; k < h.K; ++k) {
    const T* act = h.kplane(k, ACT);
    T dx = adj1_prod(act, (const T*)h.kplane(k, LAMX), idx, p.i, h.M,
                     (long long)h.N, h.kind[k]);
    T dy = adj1_prod(act, (const T*)h.kplane(k, LAMY), idx, p.j, h.N, 1LL,
                     h.kind[k]);
    b = b - (dx + dy);
  }
  h.plane(RHS)[idx] = b;
}

// λₖ ← λₖ + (μ·actₖ)·Gₖp.
template <typename T>
__global__ void hg_lambda(HG<T> h) {
  long long idx = (long long)blockIdx.x * BPL_THREADS + threadIdx.x;
  if (idx >= h.n) return;
  Pix p = pix_of(idx, h.M, h.N);
  for (int k = 0; k < h.K; ++k) {
    T gx, gy;
    grad_k((const T*)h.p, idx, p, h.M, h.N, h.kind[k], gx, gy);
    T m = h.mu * h.kplane(k, ACT)[idx];
    h.kplane(k, LAMX)[idx] = h.kplane(k, LAMX)[idx] + m * gx;
    h.kplane(k, LAMY)[idx] = h.kplane(k, LAMY)[idx] + m * gy;
  }
}

// Per block k: Gₖp·fieldₖ with field = (inact/den)·Gu (exact, negated) or
// (act/den)·Gu + (γ·inact)·Gu (regularized).  With gradient maps it is
// written per pixel (negated for the exact form); otherwise partial sums go
// to partials[k·nblocks + block] (the sign is applied to the sum).
template <typename T>
__global__ void hg_grad(HG<T> h) {
  __shared__ T sh[BPL_THREADS];
  long long idx = (long long)blockIdx.x * BPL_THREADS + threadIdx.x;
  const bool live = idx < h.n;
  Pix p = pix_of(live ? idx : 0, h.M, h.N);
  for (int k = 0; k < h.K; ++k) {
    T g = T(0);
    if (live) {
      T gx, gy;
      grad_k((const T*)h.p, idx, p, h.M, h.N, h.kind[k], gx, gy);
      T ux = h.kplane(k, GUX)[idx], uy = h.kplane(k, GUY)[idx];
      T act = h.kplane(k, ACT)[idx];
      T inact = T(1) - act;
      T den = h.kplane(k, DEN)[idx];
      T fx, fy;
      if (h.reg) {
        T s = act / den;
        T gi = h.gamma * inact;
        fx = s * ux + gi * ux;
        fy = s * uy + gi * uy;
      } else {
        T s = inact / den;
        fx = s * ux;
        fy = s * uy;
      }
      g = gx * fx + gy * fy;
    }
    if (h.gmaps != nullptr) {
      if (live) h.gmaps[(long long)k * h.n + idx] = h.reg ? g : -g;
    } else {
      T s = block_sum(g, sh);
      if (threadIdx.x == 0) h.partials[k * h.nblocks + blockIdx.x] = s;
    }
  }
}

template <typename T>
__global__ void hg_negate_grad(T* scal, int K) {
  for (int k = 0; k < K; ++k) scal[GRAD0 + k] = -scal[GRAD0 + k];
}

template <typename T>
static cudaError_t read_scalars(const T* dev, T* host, int count,
                                cudaStream_t s) {
  cudaError_t err = cudaMemcpyAsync(host, dev, count * sizeof(T),
                                    cudaMemcpyDeviceToHost, s);
  if (err != cudaSuccess) return err;
  return cudaStreamSynchronize(s);
}

#define BPL_CHECK(expr)                                  \
  do {                                                   \
    cudaError_t e_ = (expr);                             \
    if (e_ != cudaSuccess) return e_;                    \
  } while (0)

// Preconditioned CG on M p = RHS from the current p; returns ‖r‖², ‖b‖²
// and the iteration count.  stats of the whole call: ‖r‖², ‖b‖² and the
// iterations of the last solve, and the iterations of all solves.
template <typename T>
static cudaError_t cg_solve(HG<T>& h, int grid, T tol, int maxiter,
                            cudaStream_t s, T* rr_out, T* bb_out,
                            int* it_out) {
  BPL_LAUNCH(hg_weights<T>, grid, BPL_THREADS, s)(h, (const T*)h.p);
  BPL_LAUNCH(hg_apply<T>, grid, BPL_THREADS, s)(h, (const T*)h.p,
                                                h.plane(MDIR), 0);
  BPL_LAUNCH(hg_cg_init<T>, grid, BPL_THREADS, s)(h);
  BPL_LAUNCH(sum_partials<T>, 3, BPL_THREADS, s)(h.partials, h.nblocks,
                                                 h.scal, RZ0, RR, BB);
  BPL_CHECK(cudaGetLastError());
  T host[N_SLOTS];
  BPL_CHECK(read_scalars(h.scal, host, N_SLOTS, s));
  T rr = host[RR];
  const T bb = host[BB];
  T bnorm = std::sqrt(bb);
  if (bnorm < tiny<T>()) bnorm = tiny<T>();
  const T thresh = tol * bnorm;
  int k = 0, cur = 0;
  while (k < maxiter && std::sqrt(rr) > thresh) {
    BPL_LAUNCH(hg_weights<T>, grid, BPL_THREADS, s)(h,
                                                    (const T*)h.plane(DIR));
    BPL_LAUNCH(hg_apply<T>, grid, BPL_THREADS, s)(h, (const T*)h.plane(DIR),
                                                  h.plane(MDIR), 1);
    BPL_LAUNCH(sum_partials<T>, 1, BPL_THREADS, s)(h.partials, h.nblocks,
                                                   h.scal, DEN_DM, JUNK,
                                                   JUNK);
    BPL_LAUNCH(hg_cg_update<T>, grid, BPL_THREADS, s)(h, cur);
    BPL_LAUNCH(sum_partials<T>, 2, BPL_THREADS, s)(h.partials, h.nblocks,
                                                   h.scal, RZ0 + (1 - cur),
                                                   RR, JUNK);
    BPL_LAUNCH(hg_cg_dir<T>, grid, BPL_THREADS, s)(h, cur);
    BPL_CHECK(cudaGetLastError());
    BPL_CHECK(read_scalars(h.scal + RR, &rr, 1, s));
    ++k;
    cur = 1 - cur;
  }
  *rr_out = rr;
  *bb_out = bb;
  *it_out = k;
  return cudaSuccess;
}

template <typename T>
int hypergrad(const T* u, const T* ut, T* p, T* work, T* partials, T* scal,
              T* gmaps, long long O, int M, int N, int K, const int* kinds,
              const T* alphas, const long long* amaps, T act_tol, T gamma,
              T mu, T cg_tol, int al_iters, int cg_maxiter, int reg,
              double* stats, cudaStream_t s) {
  if (K < 1 || K > 3) return (int)cudaErrorInvalidValue;
  HG<T> h;
  h.u = u;
  h.ut = ut;
  h.p = p;
  h.w = work;
  h.partials = partials;
  h.scal = scal;
  h.gmaps = gmaps;
  h.n = O * M * N;
  h.M = M;
  h.N = N;
  h.nblocks = blocks_for(h.n);
  h.K = K;
  for (int k = 0; k < 3; ++k) {
    const bool live = k < K;
    h.kind[k] = live ? kinds[k] : STENCIL_FWD;
    h.alpha[k] = live ? alphas[k] : T(0);
    h.amap[k] = live ? (const T*)amaps[k] : nullptr;
  }
  h.act_tol = act_tol;
  h.gamma = gamma;
  h.mu = mu;
  h.reg = reg;
  const int grid = h.nblocks;

  BPL_LAUNCH(hg_setup<T>, grid, BPL_THREADS, s)(h);
  BPL_LAUNCH(hg_diag<T>, grid, BPL_THREADS, s)(h);
  BPL_CHECK(cudaGetLastError());
  T rr = T(0), bb = T(0);
  int it = 0, total = 0;
  if (reg) {
    BPL_LAUNCH(hg_rhs<T>, grid, BPL_THREADS, s)(h);
    BPL_CHECK(cg_solve(h, grid, cg_tol, cg_maxiter, s, &rr, &bb, &it));
    total = it;
  } else {
    for (int k = 0; k < K; ++k)
      BPL_CHECK(cudaMemsetAsync(h.kplane(k, LAMX), 0, 2 * h.n * sizeof(T),
                                s));
    const int n_al = al_iters > 1 ? al_iters : 1;
    for (int i = 0; i < n_al; ++i) {
      BPL_LAUNCH(hg_rhs<T>, grid, BPL_THREADS, s)(h);
      BPL_CHECK(cg_solve(h, grid, cg_tol, cg_maxiter, s, &rr, &bb, &it));
      total += it;
      if (i < n_al - 1) BPL_LAUNCH(hg_lambda<T>, grid, BPL_THREADS, s)(h);
    }
  }
  BPL_LAUNCH(hg_grad<T>, grid, BPL_THREADS, s)(h);
  if (gmaps == nullptr) {
    BPL_LAUNCH(sum_partials<T>, K, BPL_THREADS, s)(partials, h.nblocks, scal,
                                                   GRAD0, GRAD0 + 1,
                                                   GRAD0 + 2);
    if (!reg) BPL_LAUNCH(hg_negate_grad<T>, 1, 1, s)(scal, K);
  }
  BPL_CHECK(cudaGetLastError());
  stats[0] = (double)rr;
  stats[1] = (double)bb;
  stats[2] = (double)it;
  stats[3] = (double)total;
  return (int)cudaGetLastError();
}

}  // namespace bpl

extern "C" {

// kinds: K stencil kinds (0 forward, 1 backward, 2 centred); alphas: K
// scalar weights; amaps: K device addresses of (M, N) weight maps, 0 where
// the block's weight is the scalar.  gmaps: K per-pixel gradient maps
// (K, O, M, N), or null for K scalar gradients in scal[GRAD0 + k].
int bpl_hypergrad_f32(const float* u, const float* ut, float* p, float* work,
                      float* partials, float* scal, float* gmaps, long long O,
                      int M, int N, int K, const int* kinds,
                      const float* alphas, const long long* amaps,
                      float act_tol, float gamma, float mu, float cg_tol,
                      int al_iters, int cg_maxiter, int reg, double* stats,
                      void* stream) {
  return bpl::hypergrad<float>(u, ut, p, work, partials, scal, gmaps, O, M, N,
                               K, kinds, alphas, amaps, act_tol, gamma, mu,
                               cg_tol, al_iters, cg_maxiter, reg, stats,
                               (cudaStream_t)stream);
}

int bpl_hypergrad_f64(const double* u, const double* ut, double* p,
                      double* work, double* partials, double* scal,
                      double* gmaps, long long O, int M, int N, int K,
                      const int* kinds, const double* alphas,
                      const long long* amaps, double act_tol, double gamma,
                      double mu, double cg_tol, int al_iters, int cg_maxiter,
                      int reg, double* stats, void* stream) {
  return bpl::hypergrad<double>(u, ut, p, work, partials, scal, gmaps, O, M,
                                N, K, kinds, alphas, amaps, act_tol, gamma,
                                mu, cg_tol, al_iters, cg_maxiter, reg, stats,
                                (cudaStream_t)stream);
}

// work planes for K blocks; scalar slots; the slot of block 0's gradient
int bpl_hypergrad_planes(int K) { return bpl::SHARED + bpl::PER_K * K; }
int bpl_hypergrad_slots() { return bpl::N_SLOTS; }
int bpl_hypergrad_grad_slot() { return bpl::GRAD0; }

}  // extern "C"
