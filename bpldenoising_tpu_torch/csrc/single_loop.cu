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
// What bounds it on an H100.  Per pixel a PD step is ~25 + 13K operations
// and a CG step ~30K, so at the flagship's 10×128² every step is a few
// microseconds of device work: one launch per half-step (~150 launches per
// outer step) would be paced by launch issue, and at batch 64 with K = 3
// state in global memory leaves the 50 MB L2, so each such launch would
// stream its planes from HBM.  This design:
//
//  * PD phase, one launch per outer step (slc_pd).  Each image is one
//    thread-block cluster of `cl` CTAs; CTA c owns rows [c·rows, (c+1)·rows)
//    and keeps u, ū and the K dual fields of its band, plus two halo rows
//    above and below, in shared memory for all n_inner iterations (f is
//    read through L2).  The stencils reach one row (common.cuh's diff1 /
//    adj1, the centred adjoint included), so the CTA runs the primal step
//    on its rows and one halo row each side (the same values the owner
//    computes) and needs no neighbour's ū; after the dual step it stores
//    its top and bottom two dual rows into the neighbours' double-buffered
//    halo slots through distributed shared memory: one cluster barrier per
//    CP iteration.  The state is read from global memory once and written
//    back once per outer step.  The host (solvers/cluster_plan.py::
//    pd_plan) picks the cluster size and rows per CTA; when the band does
//    not fit in shared memory the same kernel keeps it in a global scratch
//    laid out alike (`resident` 0).  Images are independent, so the batch
//    runs as waves of clusters with no grid-wide barrier.  The band scheme
//    is csrc/pd_cluster.cuh, which kernel A (csrc/pdps.cu) shares.
//  * Adjoint CG, two launches per classic step (slc_apply, slc_update)
//    and one per pipelined step (slc_pipe_step) on 8×32 pixel tiles.  An
//    operator launch loads its tile with a two-pixel halo into shared
//    memory (the direction d = z + βd, or u = P⁻¹r, recomputed on the halo
//    from the previous step's planes, which are double-buffered where a
//    neighbour's halo reads them), forms W·G v on the tile plus one pixel
//    from u itself (|Gu|, act and 1/den are recomputed, not stored) and
//    takes the divergence.  The system set-up, the Jacobi diagonal, M·p and
//    the CG start are one launch (slc_init).
//  * Inner products per group of tile_b images: each block writes one
//    fixed-order partial; the group's last block to finish (an integer
//    counter, no float atomics) sums the group's partials in a fixed order
//    and forms the CG scalars of bilevel/pcg.py, which the next launch
//    reads.  Repeated runs agree bit for bit.  With tile_b < B this is TPU
//    kernel 10; the gradient and the cost are summed over the whole batch.
//  * The tail: the gradient maps and cost partials (slc_grad_maps), then
//    the per-patch pullback whose last block runs Adam and forms the next
//    step's exp(z) (slc_pull_adam).
//  * The kernels that take stencils are instantiated for the two forms of
//    the main paths (SlcForm: K = 1 forward; K = 3 forward, backward and
//    centred) and a generic one: the runtime stencil branches and loops
//    over k cost ~1.5× the PD phase's time.
//  * The mesh form (a shard of a batch mesh, one CG group a shard) runs a
//    step piece by piece, one host call for the launches up to each point
//    where the JAX package's scan takes a psum: after slc_init (ρ), each
//    slc_apply (d·Md) and slc_update (the new ρ), each slc_pipe_step (the
//    pair (γ, δ)), and slc_grad_maps (the maps and the cost partials).
//    There the group's last block writes its raw sum to a slot, the host
//    overwrites the slot with the sum over the shards, and the next
//    launch's blocks form a, β (and the pipelined a₋₁) from the summed
//    values alone, with the single form's expressions: a shard of padding
//    (local sums 0) never divides by its own sums, and the same launches
//    run in the same order.
//
// Launches per outer step: 4 + 2·n_adj classic (24 at n_adj = 10),
// 5 + n_adj pipelined, and one per segment (slc_begin), in either form.
// What bounds it now (PERF.md §6): the PD launch by the issue of its per-pixel IEEE
// divisions and square roots and by one cluster barrier (~0.7 µs) per CP
// iteration; the CG launches by their latency at 10 images and by their
// tile work at 64.
#include "pd_cluster.cuh"
#include "single_loop.cuh"

namespace bpl {

// a CG tile: TILE_H × TILE_W pixels, one per thread (BPL_THREADS)
#define TILE_H 8
#define TILE_W 32
// the tile with a two-pixel halo (the operand) and a one-pixel halo (W)
#define R2H (TILE_H + 4)
#define R2W (TILE_W + 4)
#define R1H (TILE_H + 2)
#define R1W (TILE_W + 2)

// B·M·N work planes.  Classic CG: R0 = r, Z = z, D0/D1 = d (even/odd
// steps), MD = Md.  Pipelined: R0/R1 = r, Z = u = P⁻¹r, D0 = the
// direction, S0/S1 = s, MD/D1 = w (even/odd steps).
enum SlcPlane { Q_INV, Q_R0, Q_R1, Q_Z, Q_D0, Q_D1, Q_MD, Q_S0, Q_S1,
               N_QPLANES };
// per-group device scalars
enum SlcSlot { G_RZ, G_A0, G_A1, G_BETA0, G_BETA1, G_GPREV, G_APREV,
              N_GSLOTS };
// The mesh form's slots (its one group's, in place of the single form's):
// classic ρ by parity of the CG step and d·Md; pipelined (γ, δ) by parity
// of the step, then a₋₁.  Each holds a raw sum until the host writes the
// sum over the shards into it.
enum SlcMeshSlot { M_RZ0 = 0, M_DMD = 2, M_GD0 = 0, M_APREV = 4,
                   N_MSLOTS = 5 };
static_assert(N_MSLOTS <= N_GSLOTS, "mesh slots exceed the group slots");
// Element counts of the scratch buffer's parts (of T, but `counters`).
struct SlcSizes {
  long long planes, gmap, kp, gx, part, cost_part, scal, pd, counters,
      total;
  int tx, tpi, n_groups, nb_g, slices;
};

static SlcSizes slc_sizes(long long B, int M, int N, int K, int pm,
                          int pn, int tile_b, int cl, int rows,
                          int resident) {
  SlcSizes z;
  const long long mn = (long long)M * N;
  z.tx = (N + TILE_W - 1) / TILE_W;
  z.tpi = ((M + TILE_H - 1) / TILE_H) * z.tx;
  z.n_groups = (int)((B + tile_b - 1) / tile_b);
  z.nb_g = blocks_for(K * mn);
  // each pullback block sums at most ~2048 pixels of a parameter entry
  const long long patch = (long long)((M + pm - 1) / pm) * ((N + pn - 1) / pn);
  z.slices = (int)((patch + 2047) / 2048 < 64 ? (patch + 2047) / 2048 : 64);
  z.planes = (long long)N_QPLANES * B * mn;
  z.gmap = (long long)K * mn;
  z.kp = (long long)K * pm * pn;
  z.gx = z.kp * z.slices;
  z.part = 2LL * B * z.tpi;
  z.cost_part = z.nb_g;
  z.scal = (long long)N_GSLOTS * z.n_groups;
  z.pd = resident ? 0 : B * cl * pd_region(K, rows, N);
  // n_groups + 1 unsigned counters, in whole elements of T
  z.counters = z.n_groups + 1;
  z.total = z.planes + z.gmap + z.kp + z.gx + z.part + z.cost_part
            + z.scal + z.pd + z.counters;
  return z;
}

template <typename T>
struct SLC {
  const T* f;
  const T* ut;
  T* u;
  T* ys;         // K × (B, 2, M, N)
  T* p;
  T* zmv;        // z, Adam m, Adam v: 3 × K × P
  T* t;          // step counter
  T* traj_x;     // (outer, K, P)
  T* traj_cost;
  T* traj_gnorm;
  T* w;          // work planes (SlcPlane)
  T* gmap;       // K × M·N
  T* xk;         // exp(z): K × P
  T* gx;         // the pullback's partials: K × P × slices
  T* part;       // 2 × B × tpi block partials
  T* cost_part;  // nb_g
  T* scal;       // N_GSLOTS × n_groups
  T* pd;         // the PD bands in global memory (resident 0)
  unsigned* count;  // per group, then the pullback's
  long long n, mn, pd_region;   // pd_region: elements of a CTA's band
  int B, M, N, K, pm, pn, P, tile_b, n_groups, tx, tpi, nb_g, slices,
      outer;
  int cl, rows;
  int mesh;      // the mesh form: raw sums to the slots (one group)
  int kind[SL_MAXK];
  T tau, sigma, gamma, lr, beta1, beta2, omb1, omb2, eps;
  __device__ T* plane(int k) const { return w + (long long)k * n; }
  __device__ T* y(int k, long long b) const {
    return ys + ((long long)k * B + b) * 2 * mn;
  }
  __device__ T& slot(int s, long long g) const {
    return scal[(long long)s * n_groups + g];
  }
};

// The regularizers of a kernel instance.  KC ≥ 0 fixes them at compile
// time as (K << 8) | kinds (two bits a regularizer, as h.kind), so the
// stencils' branches and the loops over k fold away: the forms of the main
// paths, scalar or patch TV and the sum of the forward, backward and
// centred regularizers.  KC < 0 reads K and the kinds from h.
enum SlcForm { FORM_ANY = -1, FORM_TV = (1 << 8) | STENCIL_FWD,
               FORM_SUMREGS = (3 << 8) | STENCIL_FWD | (STENCIL_BWD << 2)
                              | (STENCIL_CEN << 4) };

template <int KC, typename T>
__device__ __forceinline__ int slc_K(const SLC<T>& h) {
  return KC >= 0 ? KC >> 8 : h.K;
}

template <int KC, typename T>
__device__ __forceinline__ int slc_kind(const SLC<T>& h, int k) {
  return KC >= 0 ? (KC >> (2 * k)) & 3 : h.kind[k];
}

// αₖ at pixel (i, j): the patch entry min(i·m // M, m − 1),
// min(j·n // N, n − 1) (first_order_pallas.py:146-147); no division for
// a scalar α (the entry point checks that M·m and N·n fit in an int).
template <typename T>
__device__ __forceinline__ T slc_alpha(const SLC<T>& h, int k, int i, int j) {
  if (h.P == 1) return h.xk[k];
  int pi = i * h.pm / h.M;
  int pj = j * h.pn / h.N;
  pi = pi < h.pm - 1 ? pi : h.pm - 1;
  pj = pj < h.pn - 1 ? pj : h.pn - 1;
  return h.xk[k * h.P + pi * h.pn + pj];
}

// ---------------------------------------------------------------- PD phase

// The step of the single loop's fixed-step CP iteration for pd_cluster_run
// (csrc/pd_cluster.cuh): u⁺ = (u − τ(Σₖ Gₖᵀyₖ − f))/(1+τ), ū = 2u⁺ − u,
// yₖ = Π_{|·|≤αₖ}(yₖ + σGₖū) with the ball's sqrt form (ball_scale) and αₖ
// the scalar (s_alpha, in shared memory) or the pixel's patch entry.
template <typename T, int KC>
struct SlcStep {
  const SLC<T>& h;
  const T* s_alpha;
  int M, N, cl, rows;
  long long region;
  T* pd;
  T sigma;
  __device__ SlcStep(const SLC<T>& h_, const T* sa)
      : h(h_), s_alpha(sa), M(h_.M), N(h_.N), cl(h_.cl), rows(h_.rows),
        region(h_.pd_region), pd(h_.pd), sigma(h_.sigma) {}
  __device__ int K() const { return slc_K<KC>(h); }
  __device__ int kind(int k) const { return slc_kind<KC>(h, k); }
  __device__ const T* u_in(long long b) const { return h.u + b * h.mn; }
  __device__ T* u_out(long long b) const { return h.u + b * h.mn; }
  __device__ T* y(int k, long long b) const { return h.y(k, b); }
  __device__ const T* f(long long b) const { return h.f + b * h.mn; }
  __device__ long long mn() const { return h.mn; }
  __device__ void at(int) const {}
  __device__ T primal(T dv, T uo, T fv, T& ub) const {
    const T un = (uo - h.tau * (dv - fv)) / (T(1) + h.tau);
    ub = T(2) * un - uo;
    return un;
  }
  __device__ T scale(int k, int i, int j, T n2) const {
    const T a = h.P == 1 ? s_alpha[k] : slc_alpha(h, k, i, j);
    return ball_scale(n2, a);
  }
};

// All n_inner fixed-step CP iterations of an outer step, one image per
// cluster, under the band scheme of csrc/pd_cluster.cuh.  RES: the band
// lives in shared memory (else in h.pd, laid out alike).  KC: SlcForm.
template <typename T, bool RES, int KC>
__global__ void __launch_bounds__(PD_THREADS, PD_MINB)
slc_pd(SLC<T> h, int n_inner) {
  extern __shared__ __align__(16) unsigned char slc_smem[];
  __shared__ T s_alpha[SL_MAXK];
  if ((int)threadIdx.x < slc_K<KC>(h))
    s_alpha[threadIdx.x] = h.xk[threadIdx.x];
  SlcStep<T, KC> step(h, s_alpha);
  pd_cluster_run<T, RES>(step, slc_smem, n_inner);
}

// ------------------------------------------------------------- the CG tiles

// This thread's pixel of a CG tile: block (tile, b) of a (tpi, B) grid.
struct TileAt {
  long long b, idx;   // image, flat index of the pixel
  int i0, j0, i, j;
  bool in;            // the pixel lies in the image
};

template <typename T>
__device__ __forceinline__ TileAt tile_at(const SLC<T>& h) {
  TileAt t;
  t.b = blockIdx.y;
  t.i0 = (blockIdx.x / h.tx) * TILE_H;
  t.j0 = (blockIdx.x % h.tx) * TILE_W;
  t.i = t.i0 + threadIdx.x / TILE_W;
  t.j = t.j0 + threadIdx.x % TILE_W;
  t.in = t.i < h.M && t.j < h.N;
  t.idx = t.b * h.mn + (long long)t.i * h.N + t.j;
  return t;
}

// The system's weights of regularizer k on the tile plus one pixel: from u
// (su) and the operand v (sv), both on the tile plus two pixels, into
// (wx, wy) = αₖ(γ·inact·Gₖv + act·H Gₖv) with H g = g/den − Gu (Gu·g)/den³;
// with diag, also the Jacobi weights αₖ(γ·inact + act(1/den − Gu²/den³))
// into (dx, dy).  Positions outside the image are never read.
template <int KC, typename T>
__device__ __forceinline__ void tile_weights(const SLC<T>& h, const TileAt& t,
                                             int k, const T* su,
                                             const T* sv, T* wx, T* wy,
                                             T* dx, T* dy) {
  for (int q = threadIdx.x; q < R1H * R1W; q += BPL_THREADS) {
    const int ri = q / R1W, rj = q % R1W;
    Pix p;
    p.b = t.b;
    p.i = t.i0 - 1 + ri;
    p.j = t.j0 - 1 + rj;
    if (p.i < 0 || p.i >= h.M || p.j < 0 || p.j >= h.N) continue;
    const long long l = (long long)(ri + 1) * R2W + rj + 1;
    T ux, uy, gx, gy;
    grad_s(su, l, p, h.M, h.N, R2W, slc_kind<KC>(h, k), ux, uy);
    grad_s(sv, l, p, h.M, h.N, R2W, slc_kind<KC>(h, k), gx, gy);
    const T nG = sqrt(ux * ux + uy * uy);
    const T act = nG > T(1) / h.gamma ? T(1) : T(0);
    const T gi = h.gamma * (T(1) - act);
    const T den = act > T(0) ? nG : T(1);
    const T inv_den = T(1) / den;
    const T a = slc_alpha(h, k, p.i, p.j);
    if (dx) {
      const T rden3 = T(1) / (den * den * den);
      dx[q] = a * (gi + act * (inv_den - (ux * ux) * rden3));
      dy[q] = a * (gi + act * (inv_den - (uy * uy) * rden3));
    }
    const T d3 = (ux * gx + uy * gy) * (inv_den * inv_den * inv_den);
    const T cx = gx * inv_den - ux * d3;
    const T cy = gy * inv_den - uy * d3;
    wx[q] = a * (gi * gx + act * cx);
    wy[q] = a * (gi * gy + act * cy);
  }
}

// M·v at this thread's pixel, vv + Σₖ Gₖᵀ(Wₖ Gₖ v) in k order (and, with
// diag, 1 + Σₖ gramₖ into *diag): su and sv hold u and v on the tile plus
// two pixels.  Every thread of the block calls it.
template <int KC, typename T>
__device__ T tile_apply(const SLC<T>& h, const TileAt& t, const T* su,
                        const T* sv, T* diag) {
  __shared__ T wx[R1H * R1W], wy[R1H * R1W];
  __shared__ T dx[R1H * R1W], dy[R1H * R1W];
  const long long l2 = (long long)(threadIdx.x / TILE_W + 2) * R2W
                       + threadIdx.x % TILE_W + 2;
  const long long l1 = (long long)(threadIdx.x / TILE_W + 1) * R1W
                       + threadIdx.x % TILE_W + 1;
  Pix p;
  p.b = t.b;
  p.i = t.i;
  p.j = t.j;
  T mv = sv[l2];
  T dg = T(1);
#pragma unroll
  for (int k = 0; k < slc_K<KC>(h); ++k) {
    tile_weights<KC>(h, t, k, su, sv, wx, wy, diag ? dx : (T*)nullptr, dy);
    __syncthreads();
    if (t.in) {
      if (diag) dg = dg + gram_s((const T*)dx, (const T*)dy, l1, p, h.M,
                                 h.N, R1W, slc_kind<KC>(h, k));
      mv = mv + div_s((const T*)wx, (const T*)wy, l1, p, h.M, h.N, R1W,
                      slc_kind<KC>(h, k));
    }
    __syncthreads();
  }
  if (diag) *diag = dg;
  return mv;
}

// Loads u into su on the tile plus two pixels, and calls
// v(q, g, own) for each position (g its flat index, own when it is the
// tile's own pixel), storing the result in sv; 0 outside the image.
template <typename T, typename V>
__device__ __forceinline__ void tile_load(const SLC<T>& h, const TileAt& t,
                                          T* su, T* sv, V v) {
  const long long img = t.b * h.mn;
  for (int q = threadIdx.x; q < R2H * R2W; q += BPL_THREADS) {
    const int ri = q / R2W, rj = q % R2W;
    const int i = t.i0 - 2 + ri, j = t.j0 - 2 + rj;
    if (i < 0 || i >= h.M || j < 0 || j >= h.N) {
      su[q] = T(0);
      sv[q] = T(0);
      continue;
    }
    const long long g = img + (long long)i * h.N + j;
    const bool own = ri >= 2 && ri < TILE_H + 2 && rj >= 2 && rj < TILE_W + 2;
    su[q] = h.u[g];
    sv[q] = v(g, own);
  }
  __syncthreads();
}

// Writes the block's partials s0 (and s1) of a group inner product; the
// group's last block to arrive sums the group's partials in a fixed order
// into *t0 (and *t1) and returns true (in every thread), else false.
template <typename T>
__device__ bool group_sums(const SLC<T>& h, T s0, T s1, int two, T* t0,
                           T* t1) {
  __shared__ T sh[BPL_THREADS];
  __shared__ int last;
  const long long bt = (long long)h.B * h.tpi;
  const long long g = blockIdx.y / h.tile_b;
  const T a0 = block_sum(s0, sh);
  const T a1 = two ? block_sum(s1, sh) : T(0);
  if (threadIdx.x == 0) {
    const long long at = (long long)blockIdx.y * h.tpi + blockIdx.x;
    h.part[at] = a0;
    if (two) h.part[bt + at] = a1;
    __threadfence();
    const long long b_end = (g + 1) * h.tile_b < h.B ? (g + 1) * h.tile_b
                                                     : h.B;
    const unsigned n = (unsigned)((b_end - g * h.tile_b) * h.tpi);
    last = atomicAdd(&h.count[g], 1u) == n - 1;
  }
  __syncthreads();
  if (!last) return false;
  __threadfence();
  const long long lo = g * h.tile_b * h.tpi;
  const long long hi = ((g + 1) * h.tile_b < h.B ? (g + 1) * h.tile_b : h.B)
                       * h.tpi;
  T c0 = T(0), c1 = T(0);
  for (long long k = lo + threadIdx.x; k < hi; k += BPL_THREADS) {
    c0 += __ldcg(h.part + k);
    if (two) c1 += __ldcg(h.part + bt + k);
  }
  *t0 = block_sum(c0, sh);
  if (two) *t1 = block_sum(c1, sh);
  if (threadIdx.x == 0) h.count[g] = 0;
  return true;
}

// The system set-up at u, its Jacobi diagonal, M·p and the CG start:
// r = (ū − u) − Mp.  Classic: z = r/diag, ρ = (r, z) per group.
template <typename T, int KC>
__global__ void __launch_bounds__(BPL_THREADS) slc_init(SLC<T> h,
                                                          int pipelined) {
  __shared__ T su[R2H * R2W], sv[R2H * R2W];
  const TileAt t = tile_at(h);
  tile_load(h, t, su, sv, [&](long long g, bool) { return h.p[g]; });
  T diag;
  const T mv = tile_apply<KC>(h, t, su, sv, &diag);
  T rz = T(0);
  if (t.in) {
    const T inv = T(1) / diag;
    const T r = (h.ut[t.idx] - h.u[t.idx]) - mv;
    h.plane(Q_INV)[t.idx] = inv;
    h.plane(Q_R0)[t.idx] = r;
    if (!pipelined) {
      const T z = inv * r;
      h.plane(Q_Z)[t.idx] = z;
      rz = r * z;
    }
  }
  if (pipelined) return;
  T s, unused;
  if (group_sums(h, rz, T(0), 0, &s, &unused) && threadIdx.x == 0)
    h.slot(h.mesh ? M_RZ0 : G_RZ, blockIdx.y / h.tile_b) = s;
}

// The mesh form's classic CG scalars from the summed slots: a of step k,
// ρ_k/(d·Md), and β of step k > 0, ρ_k/ρ_{k−1} (ρ by parity of the step).
template <typename T>
__device__ __forceinline__ T slc_mesh_a(const SLC<T>& h, int k) {
  return h.slot(M_RZ0 + k % 2, 0) / nz(h.slot(M_DMD, 0));
}

template <typename T>
__device__ __forceinline__ T slc_mesh_beta(const SLC<T>& h, int k) {
  return h.slot(M_RZ0 + k % 2, 0) / nz(h.slot(M_RZ0 + (k + 1) % 2, 0));
}

// Classic step k, the operator: d = z (k = 0) or z + βd, Md and the group
// sums of d·Md; the group's last block forms a = ρ/(d·Md).
template <typename T, int KC>
__global__ void __launch_bounds__(BPL_THREADS) slc_apply(SLC<T> h, int k) {
  __shared__ T su[R2H * R2W], sv[R2H * R2W];
  const TileAt t = tile_at(h);
  const long long grp = blockIdx.y / h.tile_b;
  const T beta = k == 0 ? T(0)
                 : h.mesh ? slc_mesh_beta(h, k) : h.slot(G_BETA0, grp);
  const T* z = h.plane(Q_Z);
  const T* d_old = h.plane(k % 2 ? Q_D0 : Q_D1);
  T* d_new = h.plane(k % 2 ? Q_D1 : Q_D0);
  tile_load(h, t, su, sv, [&](long long g, bool own) {
    const T d = k == 0 ? z[g] : z[g] + beta * d_old[g];
    if (own) d_new[g] = d;
    return d;
  });
  const T mv = tile_apply<KC>(h, t, su, sv, (T*)nullptr);
  T dmd = T(0);
  if (t.in) {
    h.plane(Q_MD)[t.idx] = mv;
    dmd = sv[(threadIdx.x / TILE_W + 2) * R2W + threadIdx.x % TILE_W + 2]
          * mv;
  }
  T s, unused;
  if (group_sums(h, dmd, T(0), 0, &s, &unused) && threadIdx.x == 0) {
    if (h.mesh)
      h.slot(M_DMD, grp) = s;
    else
      h.slot(G_A0, grp) = h.slot(G_RZ, grp) / nz(s);
  }
}

// Classic step k, the update: p += a d; r −= a Md; z = r/diag; the group's
// last block forms β = ρ_new/ρ and ρ ← ρ_new.
template <typename T>
__global__ void __launch_bounds__(BPL_THREADS) slc_update(SLC<T> h, int k) {
  const TileAt t = tile_at(h);
  const long long grp = blockIdx.y / h.tile_b;
  const T a = h.mesh ? slc_mesh_a(h, k) : h.slot(G_A0, grp);
  T rz = T(0);
  if (t.in) {
    const T* d = h.plane(k % 2 ? Q_D1 : Q_D0);
    h.p[t.idx] = h.p[t.idx] + a * d[t.idx];
    const T r = h.plane(Q_R0)[t.idx] - a * h.plane(Q_MD)[t.idx];
    const T z = h.plane(Q_INV)[t.idx] * r;
    h.plane(Q_R0)[t.idx] = r;
    h.plane(Q_Z)[t.idx] = z;
    rz = r * z;
  }
  T s, unused;
  if (group_sums(h, rz, T(0), 0, &s, &unused) && threadIdx.x == 0) {
    if (h.mesh) {
      h.slot(M_RZ0 + (k + 1) % 2, grp) = s;
    } else {
      h.slot(G_BETA0, grp) = s / nz(h.slot(G_RZ, grp));
      h.slot(G_RZ, grp) = s;
    }
  }
}

// The pipelined CG's β and a of a step from its (γ, δ), γ₋₁ and a₋₁
// (β = 0 and γ₋₁ = a₋₁ = 1 at the first step), in either form.
template <typename T>
__device__ __forceinline__ void pipe_scalars(T g, T d, T gp, T ap, bool first,
                                             T& bn, T& an) {
  gp = first ? T(1) : gp;
  ap = first ? T(1) : ap;
  bn = first ? T(0) : g / nz(gp);
  an = g / nz(d - bn * g / nz(ap));
}

// The mesh form's β and a of pipelined step j from the summed slots.
template <typename T>
__device__ __forceinline__ void slc_mesh_pipe(const SLC<T>& h, int j, T& bn,
                                              T& an) {
  const int at = M_GD0 + 2 * (j % 2);
  pipe_scalars(h.slot(at, 0), h.slot(at + 1, 0),
               h.slot(M_GD0 + 2 * ((j + 1) % 2), 0), h.slot(M_APREV, 0),
               j == 0, bn, an);
}

// Pipelined step i: first the update of step i − 1 with its β and a
// (s = w + βs, r −= a s on the tile plus two pixels; the direction
// u + β·direction and p += a·direction on the tile), then u = P⁻¹r,
// w = M u and the group sums γ = (r, u), δ = (w, u); the group's last block
// forms step i's β and a (β = 0, γ₋₁ = a₋₁ = 1 at i = 0).
template <typename T, int KC>
__global__ void __launch_bounds__(BPL_THREADS) slc_pipe_step(SLC<T> h, int i) {
  __shared__ T su[R2H * R2W], sv[R2H * R2W];
  const TileAt t = tile_at(h);
  const long long grp = blockIdx.y / h.tile_b;
  const int par = (i + 1) % 2;          // step i − 1's parity
  T beta = T(0), a = T(0);
  if (i > 0 && h.mesh) {
    slc_mesh_pipe(h, i - 1, beta, a);
  } else if (i > 0) {
    beta = h.slot(par ? G_BETA1 : G_BETA0, grp);
    a = h.slot(par ? G_A1 : G_A0, grp);
  }
  const T* inv = h.plane(Q_INV);
  const T* w_old = h.plane(par ? Q_D1 : Q_MD);   // w of step i − 1
  const T* s_old = h.plane(i % 2 ? Q_S1 : Q_S0);  // s of step i − 2
  T* s_new = h.plane(par ? Q_S1 : Q_S0);
  const T* r_old = h.plane(par ? Q_R1 : Q_R0);
  T* r_new = h.plane(i % 2 ? Q_R1 : Q_R0);
  T* zu = h.plane(Q_Z);
  T* dir = h.plane(Q_D0);
  tile_load(h, t, su, sv, [&](long long g, bool own) {
    T r;
    if (i == 0) {
      r = r_new[g];
    } else {
      const T s = w_old[g] + beta * (i == 1 ? T(0) : s_old[g]);
      r = r_old[g] - a * s;
      if (own) {
        s_new[g] = s;
        r_new[g] = r;
      }
    }
    const T uu = inv[g] * r;
    if (own) {
      if (i > 0) {
        const T dn = zu[g] + beta * (i == 1 ? T(0) : dir[g]);
        h.p[g] = h.p[g] + a * dn;
        dir[g] = dn;
      }
      zu[g] = uu;
    }
    return uu;
  });
  const T mv = tile_apply<KC>(h, t, su, sv, (T*)nullptr);
  T ru = T(0), wu = T(0);
  if (t.in) {
    const T uu = sv[(threadIdx.x / TILE_W + 2) * R2W + threadIdx.x % TILE_W
                    + 2];
    h.plane(i % 2 ? Q_D1 : Q_MD)[t.idx] = mv;
    ru = r_new[t.idx] * uu;
    wu = mv * uu;
  }
  T g, d;
  if (group_sums(h, ru, wu, 1, &g, &d) && threadIdx.x == 0) {
    if (h.mesh) {
      // every block has read the slots it overwrites: (γ, δ) of step
      // i − 2 and a of step i − 2
      h.slot(M_GD0 + 2 * (i % 2), grp) = g;
      h.slot(M_GD0 + 2 * (i % 2) + 1, grp) = d;
      if (i > 0) h.slot(M_APREV, grp) = a;
      return;
    }
    T bn, an;
    pipe_scalars(g, d, h.slot(G_GPREV, grp), h.slot(G_APREV, grp), i == 0,
                 bn, an);
    h.slot(i % 2 ? G_BETA1 : G_BETA0, grp) = bn;
    h.slot(i % 2 ? G_A1 : G_A0, grp) = an;
    h.slot(G_GPREV, grp) = g;
    h.slot(G_APREV, grp) = an;
  }
}

// Pipelined, after the last step i: direction = u + β·direction,
// p += a·direction.
template <typename T>
__global__ void __launch_bounds__(BPL_THREADS) slc_pipe_last(SLC<T> h, int i) {
  const TileAt t = tile_at(h);
  if (!t.in) return;
  const long long grp = blockIdx.y / h.tile_b;
  T beta, a;
  if (h.mesh) {
    slc_mesh_pipe(h, i, beta, a);
  } else {
    beta = h.slot(i % 2 ? G_BETA1 : G_BETA0, grp);
    a = h.slot(i % 2 ? G_A1 : G_A0, grp);
  }
  const T dn = h.plane(Q_Z)[t.idx]
               + beta * (i == 0 ? T(0) : h.plane(Q_D0)[t.idx]);
  h.p[t.idx] = h.p[t.idx] + a * dn;
}

// ------------------------------------------------------------------ the tail

// x = exp(z) for the first step of a segment, recorded in its trajectory.
template <typename T>
__global__ void slc_begin(SLC<T> h) {
  const int kp = h.K * h.P;
  for (int e = threadIdx.x; e < kp; e += BPL_THREADS) {
    T x = exp(h.zmv[e]);
    h.xk[e] = x;
    h.traj_x[e] = x;
  }
  if (threadIdx.x == 0) h.count[h.n_groups] = 0;
  for (int g = threadIdx.x; g < h.n_groups; g += BPL_THREADS) h.count[g] = 0;
}

// One thread per regularizer k and pixel (i, j) of the image plane:
// gradient map k is Σ_b Gₖp·fieldₖ with fieldₖ = (act/den)·Gu + (γ·inact)·Gu
// (|Gu|, act and 1/den recomputed from u), summed over the batch in order;
// the threads of k = 0 also sum Σ_b (u − ū)² into the block partials.
template <typename T, int KC>
__global__ void __launch_bounds__(BPL_THREADS) slc_grad_maps(SLC<T> h) {
  __shared__ T sh[BPL_THREADS];
  const long long t = (long long)blockIdx.x * BPL_THREADS + threadIdx.x;
  T c = T(0);
  if (t < slc_K<KC>(h) * h.mn) {
    const int k = (int)(t / h.mn);
    const long long ij = t - k * h.mn;
    Pix p;
    p.i = (int)(ij / h.N);
    p.j = (int)(ij % h.N);
    T acc = T(0);
    for (int b = 0; b < h.B; ++b) {
      const long long idx = (long long)b * h.mn + ij;
      p.b = b;
      T gx, gy, ux, uy;
      grad_k((const T*)h.p, idx, p, h.M, h.N, slc_kind<KC>(h, k), gx, gy);
      grad_k((const T*)h.u, idx, p, h.M, h.N, slc_kind<KC>(h, k), ux, uy);
      const T nG = sqrt(ux * ux + uy * uy);
      const T act = nG > T(1) / h.gamma ? T(1) : T(0);
      const T s = act > T(0) ? T(1) / nG : T(0);   // act/den
      const T gi = h.gamma * (T(1) - act);
      const T g = gx * (s * ux + gi * ux) + gy * (s * uy + gi * uy);
      acc = b == 0 ? g : acc + g;
      if (k == 0) {
        const T d = h.u[idx] - h.ut[idx];
        c += d * d;
      }
    }
    h.gmap[t] = acc;
  }
  T s = block_sum(c, sh);
  if (threadIdx.x == 0) h.cost_part[blockIdx.x] = s;
}

// Block (k, e, s): slice s of the pixels of parameter entry e in gradient
// map k (rows ⌈pi·M/m⌉ … ⌈(pi+1)·M/m⌉ − 1, likewise columns; the whole
// plane for a scalar α), summed into a partial.  The last block to finish
// sums each entry's slices in order, runs Adam on z = log α (g_z = g_x·x,
// t ← t + 1, bias corrections 1 − βᵗ), writes this step's cost ½Σ(u − ū)²
// and ‖g_x‖, and forms x = exp(z) for step o + 1.
template <typename T>
__global__ void __launch_bounds__(BPL_THREADS) slc_pull_adam(SLC<T> h, int o) {
  __shared__ T sh[BPL_THREADS];
  __shared__ int last;
  const int S = h.slices;
  const int ke = blockIdx.x / S, sl = blockIdx.x % S;
  const int k = ke / h.P, e = ke % h.P;
  const int pi = e / h.pn, pj = e % h.pn;
  const int r0 = (int)(((long long)pi * h.M + h.pm - 1) / h.pm);
  const int r1 = (int)(((long long)(pi + 1) * h.M + h.pm - 1) / h.pm);
  const int c0 = (int)(((long long)pj * h.N + h.pn - 1) / h.pn);
  const int c1 = (int)(((long long)(pj + 1) * h.N + h.pn - 1) / h.pn);
  const int bn = c1 - c0;
  const long long cnt = (long long)(r1 - r0) * bn;
  const long long chunk = (cnt + S - 1) / S;
  const long long q1 = (sl + 1) * chunk < cnt ? (sl + 1) * chunk : cnt;
  const T* g = h.gmap + (long long)k * h.mn;
  T acc = T(0);
  for (long long q = sl * chunk + threadIdx.x; q < q1; q += BPL_THREADS)
    acc += g[(long long)(r0 + q / bn) * h.N + c0 + q % bn];
  const T sum = block_sum(acc, sh);
  unsigned* done = h.count + h.n_groups;
  if (threadIdx.x == 0) {
    h.gx[blockIdx.x] = sum;
    __threadfence();
    last = atomicAdd(done, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int kp = h.K * h.P;
  const T tn = h.t[0] + T(1);
  const T b1t = pow(h.beta1, tn);
  const T b2t = pow(h.beta2, tn);
  T gsq = T(0);
  for (int q = threadIdx.x; q < kp; q += BPL_THREADS) {
    T gq = __ldcg(h.gx + (long long)q * S);
    for (int r = 1; r < S; ++r) gq += __ldcg(h.gx + (long long)q * S + r);
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
  for (int q = threadIdx.x; q < h.nb_g; q += BPL_THREADS) c += h.cost_part[q];
  const T G = block_sum(gsq, sh);
  const T C = block_sum(c, sh);
  if (threadIdx.x == 0) {
    h.traj_cost[o] = T(0.5) * C;
    h.traj_gnorm[o] = sqrt(G);
    h.t[0] = tn;
    *done = 0;
  }
}

// ------------------------------------------------------------------ the host

// The launches of an outer step, in order: the PD phase (when n_inner > 0),
// slc_init, then slc_apply and slc_update per classic CG step (per
// pipelined step slc_pipe_step, then slc_pipe_last), slc_grad_maps and
// slc_pull_adam.
enum SlcLaunch { L_PD, L_INIT, L_APPLY, L_UPDATE, L_PIPE, L_PIPE_LAST,
                 L_MAPS, L_PULL };

struct SlcSteps {
  int n_inner, n_adj, pipelined;
  int cg() const {
    return pipelined ? (n_adj > 0 ? n_adj + 1 : 0) : 2 * n_adj;
  }
  int launches() const { return (n_inner > 0) + 1 + cg() + 2; }
  // launch j of a step → its kind, and in *k the CG step it belongs to
  int at(int j, int* k) const {
    *k = 0;
    if (n_inner > 0 && j-- == 0) return L_PD;
    if (j-- == 0) return L_INIT;
    if (j < cg()) {
      if (!pipelined) {
        *k = j / 2;
        return j % 2 ? L_UPDATE : L_APPLY;
      }
      *k = j < n_adj ? j : n_adj - 1;
      return j < n_adj ? L_PIPE : L_PIPE_LAST;
    }
    return j == cg() ? L_MAPS : L_PULL;
  }
  // the mesh form's sum point after a launch of `kind` (CG step k): the
  // first mesh slot and in *n the count of the scalars to sum there; −2
  // for the gradient maps and the cost partials; −1 for none
  int sum_after(int kind, int k, int* n) const {
    *n = kind == L_PIPE ? 2 : 1;
    switch (kind) {
      case L_INIT: return pipelined ? -1 : M_RZ0;
      case L_APPLY: return M_DMD;
      case L_UPDATE: return M_RZ0 + (k + 1) % 2;
      case L_PIPE: return M_GD0 + 2 * (k % 2);
      case L_MAPS: return -2;
      default: return -1;
    }
  }
};

// Issues one launch of step o.
template <typename T, int KC>
int slc_launch(SLC<T>& h, const PdClusterLaunch<void (*)(SLC<T>, int)>& L,
               int kind, int k, int o, int n_inner, int pipelined,
               cudaStream_t s) {
  const dim3 tiles(h.tpi, h.B);
  switch (kind) {
    case L_PD:
      return (int)cudaLaunchKernelEx(&L.cfg, L.kern, h, n_inner);
    case L_INIT:
      slc_init<T, KC><<<tiles, BPL_THREADS, 0, s>>>(h, pipelined);
      break;
    case L_APPLY:
      slc_apply<T, KC><<<tiles, BPL_THREADS, 0, s>>>(h, k);
      break;
    case L_UPDATE:
      BPL_LAUNCH(slc_update<T>, tiles, BPL_THREADS, s)(h, k);
      break;
    case L_PIPE:
      slc_pipe_step<T, KC><<<tiles, BPL_THREADS, 0, s>>>(h, k);
      break;
    case L_PIPE_LAST:
      BPL_LAUNCH(slc_pipe_last<T>, tiles, BPL_THREADS, s)(h, k);
      break;
    case L_MAPS:
      slc_grad_maps<T, KC><<<h.nb_g, BPL_THREADS, 0, s>>>(h);
      break;
    default:
      BPL_LAUNCH(slc_pull_adam<T>, h.K * h.P * h.slices, BPL_THREADS, s)(h,
                                                                      o);
  }
  return (int)cudaSuccess;
}

// The single form (piece < 0): every launch of `outer` steps after the
// segment's slc_begin.  The mesh form: piece `piece` of step o, its
// launches after the step's piece-th sum point up to the next (the first
// piece of step 0 after slc_begin); sums ← {offset, count, offset, count}
// of what the host sums over the shards before the next piece, in
// elements of the scratch buffer (counts 0 after the last piece).
template <typename T, int KC>
int single_loop(SLC<T>& h, const SlcSizes& z, int resident, int outer,
                int o, int piece, const SlcSteps& st, long long* sums,
                int* n_launched, cudaStream_t s) {
  PdClusterLaunch<void (*)(SLC<T>, int)> L;
  if (piece <= 0) {
    void (*kern)(SLC<T>, int) = resident ? slc_pd<T, true, KC>
                                         : slc_pd<T, false, KC>;
    int err = pd_cluster_prepare(
        L, kern, h.B, h.cl, resident ? (size_t)h.pd_region * sizeof(T) : 0,
        s);
    if (err != (int)cudaSuccess) return err;
  }
  int nl = 0, err, k;
  if (outer > 0 && piece <= 0 && o == 0) {
    BPL_LAUNCH(slc_begin<T>, 1, BPL_THREADS, s)(h);
    ++nl;
  }
  if (piece < 0) {
    for (int oo = 0; oo < outer; ++oo) {
      for (int j = 0; j < st.launches(); ++j) {
        const int kind = st.at(j, &k);
        if ((err = slc_launch<T, KC>(h, L, kind, k, oo, st.n_inner,
                                     st.pipelined, s)) != (int)cudaSuccess)
          return err;
        ++nl;
      }
      if ((err = (int)cudaGetLastError()) != (int)cudaSuccess) return err;
    }
    *n_launched = nl;
    return (int)cudaGetLastError();
  }
  for (int q = 0; q < 4; ++q) sums[q] = 0;
  int at = 0;
  for (int j = 0; j < st.launches() && at <= piece; ++j) {
    const int kind = st.at(j, &k);
    if (at == piece) {
      if ((err = slc_launch<T, KC>(h, L, kind, k, o, st.n_inner,
                                   st.pipelined, s)) != (int)cudaSuccess)
        return err;
      ++nl;
    }
    int n;
    const int slot = st.sum_after(kind, k, &n);
    if (slot == -1) continue;
    if (at == piece) {
      if (slot == -2) {
        sums[0] = z.planes;
        sums[1] = z.gmap;
        sums[2] = z.planes + z.gmap + z.kp + z.gx + z.part;
        sums[3] = z.cost_part;
      } else {
        sums[0] = z.planes + z.gmap + z.kp + z.gx + z.part + z.cost_part
                  + slot;
        sums[1] = n;
      }
    }
    ++at;
  }
  *n_launched = nl;
  if (at < piece) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

template <typename T>
int single_loop_entry(const T* f, const T* ut, T* u, T* ys, T* p, T* zmv,
                      T* t, T* traj_x, T* traj_cost, T* traj_gnorm,
                      T* scratch, long long B, int M, int N, int K,
                      int kinds, int pm, int pn, int tile_b, int cl,
                      int rows, int resident, int outer, int n_inner,
                      int n_adj, int pipelined, int o, int piece, T tau,
                      T sigma, T gamma, T lr, T beta1, T beta2, T omb1,
                      T omb2, T eps, long long* sums, int* n_launched,
                      cudaStream_t s) {
  *n_launched = 0;
  if (sl_bad_args(B, M, N, pm, pn, outer, n_inner, n_adj) || K < 1
      || K > SL_MAXK || tile_b < 1 || B > 65535 || cl < 1
      || cl > PD_MAX_CLUSTER || rows < 1 || (long long)rows * cl < M
      || B * cl > 0x7fffffffLL || (long long)M * pm > 0x7fffffffLL
      || (long long)N * pn > 0x7fffffffLL
      || pd_region(K, rows, N) > 0x7fffffffLL
      || (cl > 1 && rows < 2)
      || (piece >= 0 && (tile_b < B || o < 0 || o >= outer || !sums)))
    return (int)cudaErrorInvalidValue;
  const SlcSizes z = slc_sizes(B, M, N, K, pm, pn, tile_b, cl, rows,
                               resident);
  SLC<T> h;
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
  h.part = h.gx + z.gx;
  h.cost_part = h.part + z.part;
  h.scal = h.cost_part + z.cost_part;
  h.pd = h.scal + z.scal;
  h.count = reinterpret_cast<unsigned*>(h.pd + z.pd);
  h.mn = (long long)M * N;
  h.n = B * h.mn;
  h.B = (int)B;
  h.M = M;
  h.N = N;
  h.K = K;
  h.pm = pm;
  h.pn = pn;
  h.P = pm * pn;
  h.tile_b = tile_b;
  h.n_groups = z.n_groups;
  h.tx = z.tx;
  h.tpi = z.tpi;
  h.nb_g = z.nb_g;
  h.slices = z.slices;
  h.outer = outer;
  h.cl = cl;
  h.rows = rows;
  h.mesh = piece >= 0;
  h.pd_region = pd_region(K, rows, N);
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
  const SlcSteps st{n_inner, n_adj, pipelined};
  int form = K << 8;
  for (int k = 0; k < K; ++k) form |= h.kind[k] << (2 * k);
  if (form == FORM_TV)
    return single_loop<T, FORM_TV>(h, z, resident, outer, o, piece, st,
                                   sums, n_launched, s);
  if (form == FORM_SUMREGS)
    return single_loop<T, FORM_SUMREGS>(h, z, resident, outer, o, piece, st,
                                        sums, n_launched, s);
  return single_loop<T, FORM_ANY>(h, z, resident, outer, o, piece, st, sums,
                                  n_launched, s);
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

long long bpl_sl_scratch(long long B, int M, int N, int K, int pm, int pn,
                         int tile_b, int cl, int rows, int resident) {
  return bpl::slc_sizes(B, M, N, K, pm, pn, tile_b, cl, rows, resident)
      .total;
}

// piece < 0: the single form, `outer` steps from the segment's start;
// piece ≥ 0: the mesh form's piece of step o (single_loop above).
#define BPL_SINGLE_LOOP(SUFFIX, T)                                           \
  int bpl_single_loop_##SUFFIX(                                              \
      const T* f, const T* ut, T* u, T* ys, T* p, T* zmv, T* t, T* traj_x,   \
      T* traj_cost, T* traj_gnorm, T* scratch, long long B, int M, int N,    \
      int K, int kinds, int pm, int pn, int tile_b, int cl, int rows,        \
      int resident, int outer, int n_inner, int n_adj, int pipelined, int o, \
      int piece, T tau, T sigma, T gamma, T lr, T beta1, T beta2, T omb1,    \
      T omb2, T eps, long long* sums, int* n_launched, void* stream) {       \
    return bpl::single_loop_entry<T>(                                        \
        f, ut, u, ys, p, zmv, t, traj_x, traj_cost, traj_gnorm, scratch, B,  \
        M, N, K, kinds, pm, pn, tile_b, cl, rows, resident, outer, n_inner,  \
        n_adj, pipelined, o, piece, tau, sigma, gamma, lr, beta1, beta2,     \
        omb1, omb2, eps, sums, n_launched, (cudaStream_t)stream);            \
  }

BPL_SINGLE_LOOP(f32, float)
BPL_SINGLE_LOOP(f64, double)

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
