// Kernel B: augmented-Lagrangian exact hypergradient with Jacobi-PCG, and
// its γ-regularized form; scalar α, K=1 (forward differences).
//
// Replaces the TPU kernel bpldenoising_tpu/solvers/hypergrad_pallas.py::_hg_kernel
// (dispatched by _run), which keeps the whole AL iteration resident in VMEM.
// It solves, as ONE joint system over the image batch,
//   M p = b,  M = I + Gᵀ[μ·act + inact·α·H]G            (exact form)
//             M = I + α·Gᵀ[γ·inact + act·H]G           (regularized form)
// with H v = v/den − Gu (Gu·v)/den³, the Jacobi preconditioner from the
// stencil Gram diagonal, CG stopped at ‖r‖ ≤ cg_tol·‖b‖ or cg_maxiter,
// `al_iters` multiplier updates λ ← λ + μ·act·Gp (exact form only) and the
// warm start p0; then dJ/dα = ∓Σ Gp·Gu·field.
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
// The ~16 working planes (10×128² f32: 10.5 MB) stay in the 50 MB L2; at
// the flagship size each launch is short, so the solve is bound by launch
// and host-read latency, not by bytes or operations.
#include "common.cuh"

namespace bpl {

// work planes (each n = O·M·N elements)
enum Plane {
  GUX, GUY, ACT, DEN, INV_DEN, INV_DEN3, INV_DIAG, WX, WY, LAMX, LAMY,
  RHS, RES, ZZ, DIR, MDIR, N_PLANES
};
// device scalar slots
enum Slot { RZ0, RZ1, DEN_DM, RR, BB, GRAD, JUNK, N_SLOTS };

template <typename T>
struct HG {
  const T* u;
  const T* ut;
  T* p;
  T* w;          // N_PLANES planes
  T* partials;   // 3 × nblocks
  T* scal;       // N_SLOTS
  long long n;
  int M, N, nblocks;
  T alpha, act_tol, gamma, mu;
  int reg;
  __host__ __device__ T* plane(int k) const { return w + (long long)k * n; }
};

// Gu, the active set, den, 1/den, 1/den³ and the diagonal weights (into
// WX, WY), in the arithmetic order of solvers/hypergrad.py.
template <typename T>
__global__ void hg_setup(HG<T> h) {
  long long idx = (long long)blockIdx.x * BPL_THREADS + threadIdx.x;
  if (idx >= h.n) return;
  Pix p = pix_of(idx, h.M, h.N);
  T gx, gy;
  grad_k(h.u, idx, p, h.M, h.N, STENCIL_FWD, gx, gy);
  T nG = sqrt(gx * gx + gy * gy);
  T act, den;
  if (h.reg) {
    act = (nG > T(1) / h.gamma) ? T(1) : T(0);
    den = act > T(0) ? nG : T(1);
  } else {
    act = (nG < h.act_tol) ? T(1) : T(0);
    den = act > T(0) ? T(1) : nG;
  }
  T inact = T(1) - act;
  T inv_den = T(1) / den;
  T inv_den3 = inv_den * inv_den * inv_den;
  T rden = T(1) / den;
  T rden3 = T(1) / (den * den * den);
  T hx = rden - (gx * gx) * rden3;
  T hy = rden - (gy * gy) * rden3;
  T wdx, wdy;
  if (h.reg) {
    wdx = h.alpha * (h.gamma * inact + act * hx);
    wdy = h.alpha * (h.gamma * inact + act * hy);
  } else {
    wdx = h.mu * act + (inact * h.alpha) * hx;
    wdy = h.mu * act + (inact * h.alpha) * hy;
  }
  h.plane(GUX)[idx] = gx;
  h.plane(GUY)[idx] = gy;
  h.plane(ACT)[idx] = act;
  h.plane(DEN)[idx] = den;
  h.plane(INV_DEN)[idx] = inv_den;
  h.plane(INV_DEN3)[idx] = inv_den3;
  h.plane(WX)[idx] = wdx;
  h.plane(WY)[idx] = wdy;
}

// 1/diag with diag = 1 + (gram_x + gram_y), gram(j) = w[j−1] + w[j] masked.
template <typename T>
__global__ void hg_diag(HG<T> h) {
  long long idx = (long long)blockIdx.x * BPL_THREADS + threadIdx.x;
  if (idx >= h.n) return;
  Pix p = pix_of(idx, h.M, h.N);
  const T* wx = h.plane(WX);
  const T* wy = h.plane(WY);
  T gxa = (p.i >= 1) ? wx[idx - h.N] : T(0);
  T gxb = (p.i < h.M - 1) ? wx[idx] : T(0);
  T gya = (p.j >= 1) ? wy[idx - 1] : T(0);
  T gyb = (p.j < h.N - 1) ? wy[idx] : T(0);
  T diag = T(1) + ((gxa + gxb) + (gya + gyb));
  h.plane(INV_DIAG)[idx] = T(1) / diag;
}

// (WX, WY) = W·G v: the per-pixel dual-space block applied to Gv.
template <typename T>
__global__ void hg_weights(HG<T> h, const T* __restrict__ v) {
  long long idx = (long long)blockIdx.x * BPL_THREADS + threadIdx.x;
  if (idx >= h.n) return;
  Pix p = pix_of(idx, h.M, h.N);
  T gx, gy;
  grad_k(v, idx, p, h.M, h.N, STENCIL_FWD, gx, gy);
  T ux = h.plane(GUX)[idx], uy = h.plane(GUY)[idx];
  T act = h.plane(ACT)[idx];
  T inact = T(1) - act;
  T inv_den = h.plane(INV_DEN)[idx];
  T dot3 = (ux * gx + uy * gy) * h.plane(INV_DEN3)[idx];
  T cx = gx * inv_den - ux * dot3;
  T cy = gy * inv_den - uy * dot3;
  T wx, wy;
  if (h.reg) {
    wx = h.alpha * ((h.gamma * inact) * gx + act * cx);
    wy = h.alpha * ((h.gamma * inact) * gy + act * cy);
  } else {
    wx = (h.mu * act) * gx + (inact * h.alpha) * cx;
    wy = (h.mu * act) * gy + (inact * h.alpha) * cy;
  }
  h.plane(WX)[idx] = wx;
  h.plane(WY)[idx] = wy;
}

// out = v + Gᵀ(WX, WY); partial sums of v·out (slot 0) when `dot`.
template <typename T>
__global__ void hg_apply(HG<T> h, const T* __restrict__ v, T* __restrict__ out,
                         int dot) {
  __shared__ T sh[BPL_THREADS];
  long long idx = (long long)blockIdx.x * BPL_THREADS + threadIdx.x;
  const bool live = idx < h.n;
  T vo = T(0);
  if (live) {
    Pix p = pix_of(idx, h.M, h.N);
    T mv = v[idx] + div_k(h.plane(WX), h.plane(WY), idx, p, h.M, h.N,
                          STENCIL_FWD);
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

// Right-hand side: exact b = (u − ū) − Gᵀ(act·λ); regularized b = ū − u.
template <typename T>
__global__ void hg_rhs(HG<T> h) {
  long long idx = (long long)blockIdx.x * BPL_THREADS + threadIdx.x;
  if (idx >= h.n) return;
  if (h.reg) {
    h.plane(RHS)[idx] = h.ut[idx] - h.u[idx];
    return;
  }
  Pix p = pix_of(idx, h.M, h.N);
  const T* act = h.plane(ACT);
  const T* lx = h.plane(LAMX);
  const T* ly = h.plane(LAMY);
  T ax = (p.i >= 1) ? act[idx - h.N] * lx[idx - h.N] : T(0);
  T bx = (p.i < h.M - 1) ? act[idx] * lx[idx] : T(0);
  T ay = (p.j >= 1) ? act[idx - 1] * ly[idx - 1] : T(0);
  T by = (p.j < h.N - 1) ? act[idx] * ly[idx] : T(0);
  h.plane(RHS)[idx] = (h.u[idx] - h.ut[idx]) - ((ax - bx) + (ay - by));
}

// λ ← λ + (μ·act)·Gp.
template <typename T>
__global__ void hg_lambda(HG<T> h) {
  long long idx = (long long)blockIdx.x * BPL_THREADS + threadIdx.x;
  if (idx >= h.n) return;
  Pix p = pix_of(idx, h.M, h.N);
  T gx, gy;
  grad_k((const T*)h.p, idx, p, h.M, h.N, STENCIL_FWD, gx, gy);
  T m = h.mu * h.plane(ACT)[idx];
  h.plane(LAMX)[idx] = h.plane(LAMX)[idx] + m * gx;
  h.plane(LAMY)[idx] = h.plane(LAMY)[idx] + m * gy;
}

// Partials of Σ Gp·field with field = (inact/den)·Gu (exact, then negated)
// or (act/den)·Gu + (γ·inact)·Gu (regularized).
template <typename T>
__global__ void hg_grad(HG<T> h) {
  __shared__ T sh[BPL_THREADS];
  long long idx = (long long)blockIdx.x * BPL_THREADS + threadIdx.x;
  const bool live = idx < h.n;
  T g = T(0);
  if (live) {
    Pix p = pix_of(idx, h.M, h.N);
    T gx, gy;
    grad_k((const T*)h.p, idx, p, h.M, h.N, STENCIL_FWD, gx, gy);
    T ux = h.plane(GUX)[idx], uy = h.plane(GUY)[idx];
    T act = h.plane(ACT)[idx];
    T inact = T(1) - act;
    T den = h.plane(DEN)[idx];
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
  T s = block_sum(g, sh);
  if (threadIdx.x == 0) h.partials[blockIdx.x] = s;
}

template <typename T>
__global__ void hg_negate_grad(T* scal) {
  scal[GRAD] = -scal[GRAD];
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
              long long O, int M, int N, T alpha, T act_tol, T gamma, T mu,
              T cg_tol, int al_iters, int cg_maxiter, int reg, double* stats,
              cudaStream_t s) {
  HG<T> h;
  h.u = u;
  h.ut = ut;
  h.p = p;
  h.w = work;
  h.partials = partials;
  h.scal = scal;
  h.n = O * M * N;
  h.M = M;
  h.N = N;
  h.nblocks = blocks_for(h.n);
  h.alpha = alpha;
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
    BPL_CHECK(cudaMemsetAsync(h.plane(LAMX), 0, 2 * h.n * sizeof(T), s));
    const int n_al = al_iters > 1 ? al_iters : 1;
    for (int i = 0; i < n_al; ++i) {
      BPL_LAUNCH(hg_rhs<T>, grid, BPL_THREADS, s)(h);
      BPL_CHECK(cg_solve(h, grid, cg_tol, cg_maxiter, s, &rr, &bb, &it));
      total += it;
      if (i < n_al - 1) BPL_LAUNCH(hg_lambda<T>, grid, BPL_THREADS, s)(h);
    }
  }
  BPL_LAUNCH(hg_grad<T>, grid, BPL_THREADS, s)(h);
  BPL_LAUNCH(sum_partials<T>, 1, BPL_THREADS, s)(partials, h.nblocks, scal,
                                                 GRAD, JUNK, JUNK);
  if (!reg) BPL_LAUNCH(hg_negate_grad<T>, 1, 1, s)(scal);
  BPL_CHECK(cudaGetLastError());
  stats[0] = (double)rr;
  stats[1] = (double)bb;
  stats[2] = (double)it;
  stats[3] = (double)total;
  return (int)cudaGetLastError();
}

}  // namespace bpl

extern "C" {

int bpl_hypergrad_f32(const float* u, const float* ut, float* p, float* work,
                      float* partials, float* scal, long long O, int M, int N,
                      float alpha, float act_tol, float gamma, float mu,
                      float cg_tol, int al_iters, int cg_maxiter, int reg,
                      double* stats, void* stream) {
  return bpl::hypergrad<float>(u, ut, p, work, partials, scal, O, M, N, alpha,
                               act_tol, gamma, mu, cg_tol, al_iters,
                               cg_maxiter, reg, stats, (cudaStream_t)stream);
}

int bpl_hypergrad_f64(const double* u, const double* ut, double* p,
                      double* work, double* partials, double* scal,
                      long long O, int M, int N, double alpha, double act_tol,
                      double gamma, double mu, double cg_tol, int al_iters,
                      int cg_maxiter, int reg, double* stats, void* stream) {
  return bpl::hypergrad<double>(u, ut, p, work, partials, scal, O, M, N,
                                alpha, act_tol, gamma, mu, cg_tol, al_iters,
                                cg_maxiter, reg, stats, (cudaStream_t)stream);
}

int bpl_hypergrad_planes() { return bpl::N_PLANES; }
int bpl_hypergrad_slots() { return bpl::N_SLOTS; }

}  // extern "C"
