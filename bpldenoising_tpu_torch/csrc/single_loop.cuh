// The single-loop learners' shared parts.  Every single-loop learner has
// the design of rows 9–10 (single_loop.cu, TV and the sum of gradient
// regularizers): per outer step a thread-block cluster per image for the
// CP phase, two launches per CG step, the state of each in a struct of its
// own.  All take SL_MAXK and sl_bad_args from here; rows 11 (TGV²,
// single_loop_tgv.cu), 12 (TV-L1, single_loop_tvl1.cu) and 13 (VTV,
// single_loop_vtv.cu) also share the parts at the end (slx_*): the patch
// weight's lookup, the CG's per-image partial sums, the segment's start,
// and the per-patch pullback with Adam on log α (with TV-L1's clip as a
// compile-time option).  The arithmetic follows the port's plain versions
// (bilevel/first_order*.py), built with -fmad=false.
#pragma once

#include "common.cuh"

namespace bpl {

#define SL_MAXK 8

// The argument checks every learner's entry shares.
inline bool sl_bad_args(long long B, int M, int N, int pm, int pn,
                        int outer, int n_inner, int n_adj) {
  return B < 1 || M < 1 || N < 1 || pm < 1 || pn < 1 || pm > M || pn > N
         || outer < 0 || n_inner < 0 || n_adj < 0;
}

// ------------------------------------ rows 11, 12 and 13's shared parts
//
// The learners of single_loop_tgv.cu, single_loop_tvl1.cu and
// single_loop_vtv.cu keep their state in a struct H of their own; the
// parts below read its members zmv (3 × K × P: z, Adam m, Adam v), t,
// traj_x, traj_cost, traj_gnorm, gmap (K × M·N), xk and gx (K × P), part
// (B × bpt CG partials), cost_part (nb_mn), count (B + 1 counters), mn, B,
// M, N, pm, pn, P, bpt, nb_mn, outer and Adam's lr, beta1, beta2, omb1,
// omb2, eps (and clip, where slx_pull_adam clips).

// What one call of a learner's loop runs.  The single form runs SLX_ALL
// over the segment's steps: slx_begin, then per step the local part (the
// CP phase, the CG, the gradient maps and the cost partials) and the
// update (slx_pull_adam).  The mesh form calls each part on its own, one
// step at a time, on every shard's card, and sums the shards' gradient
// maps and cost partials on the host in between (slx_mesh_parts says
// where they lie in the scratch buffer), so each shard's update runs on
// the summed map and z stays replicated.
enum SlxParts { SLX_BEGIN = 1, SLX_LOCAL = 2, SLX_UPDATE = 4, SLX_ALL = 7 };

// A loop call's step range [o0, o1) and parts are valid for `outer` steps.
inline bool slx_bad_steps(int o0, int o1, int parts, int outer) {
  return o0 < 0 || o1 < o0 || o1 > outer || parts < 1 || parts > SLX_ALL;
}

// The offsets and lengths, in elements of T, of the gradient maps and the
// cost partials in a learner's scratch buffer (laid out as its sizes
// struct Z says): out = {gmap, K·M·N, cost_part, nb_mn}.
template <class Z>
void slx_mesh_parts(const Z& z, long long* out) {
  out[0] = z.eplanes + z.xplanes;
  out[1] = z.gmap;
  out[2] = out[0] + z.gmap + 2 * z.kp + z.part;
  out[3] = z.cost_part;
}

// αₖ at pixel (i, j): the patch entry min(i·m // M, m − 1),
// min(j·n // N, n − 1) (first_order_pallas.py:146-147, PatchOp.apply for
// divisible shapes), no division for a scalar weight.
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
// image's partials into *out and returns true (in every thread), else
// false: thread t adds partials t, t + 256, … in turn, then one block_sum
// (the fixed order of the parent design's one-block finishing pass).  An
// integer counter, no float atomics.
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
// (rows ⌈pi·M/m⌉ … ⌈(pi+1)·M/m⌉ − 1, likewise columns; the whole plane for
// a scalar α), the adjoint of slx_alpha's upsampling.  The last block to
// finish runs Adam on z = log α (g_z = g_x·x, clipped to ±clip where CLIP,
// t ← t + 1, bias corrections 1 − βᵗ with βᵗ = pow(β, t)), writes this
// step's cost ½Σ(u − ū)² from the cost partials and ‖g_x‖, and forms
// x = exp(z) for step o + 1.
template <typename T, int K, class H, bool CLIP = false>
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
    T gz = gq * h.xk[q];
    if constexpr (CLIP) {
      gz = gz < -h.clip ? -h.clip : gz;
      gz = gz > h.clip ? h.clip : gz;
    }
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
