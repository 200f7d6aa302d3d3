// Shared helpers of the port's CUDA kernels (pdps.cu, hypergrad.cu, tgv.cu,
// tvl1.cu, vtv.cu, single_loop.cu).
//
// Every kernel here runs one thread per pixel of a (batch, rows, cols)
// stack in global memory; the stencils are the forward, backward and
// centred differences of bpldenoising_tpu/ops/grad.py (and of the port's
// ops/grad.py), masked at the image boundary.  Reductions
// over the batch are deterministic: each block writes one partial sum
// (a fixed tree inside the block), and a second one-block pass sums the
// partials in a fixed order.  There are no atomics, so repeated runs agree
// bit for bit.  Launch boundaries are the synchronisation between blocks,
// but for the cluster barriers of pd_cluster.cuh and the grid barriers of
// hypergrad.cu's cooperative launch.
#pragma once

#include <cuda_runtime.h>

#include <cfloat>
#include <cmath>
#include <vector>

#define BPL_THREADS 256
#define BPL_LAUNCH(kernel, grid, block, stream) \
  kernel<<<(grid), (block), 0, (stream)>>>

namespace bpl {

// Smallest normal number of T (numpy's finfo(T).tiny).
template <typename T> __host__ __device__ __forceinline__ T tiny();
template <> __host__ __device__ __forceinline__ float tiny<float>() {
  return FLT_MIN;
}
template <> __host__ __device__ __forceinline__ double tiny<double>() {
  return DBL_MIN;
}

__device__ __forceinline__ float rsqrt_(float x) { return rsqrtf(x); }
__device__ __forceinline__ double rsqrt_(double x) { return rsqrt(x); }

// Pixel coordinates of flat index idx in a (batch, M, N) stack.
struct Pix {
  long long b;
  int i, j;
};

__device__ __forceinline__ Pix pix_of(long long idx, int M, int N) {
  Pix p;
  p.j = (int)(idx % N);
  long long t = idx / N;
  p.i = (int)(t % M);
  p.b = t / M;
  return p;
}

// The three difference stencils of ops/grad.py: forward D⁺ (zero at the
// last index; every TV-type kernel), backward D⁻ (zero at the first) and
// centred D⁰ ((v[i+1] − v[i−1])/2, zero at both ends), which the
// sum-of-regularizers learner also uses (csrc/single_loop.cu).  With a
// literal kind the switch folds away at compile time.  Each 1-D helper
// works along one axis at position i of n with stride s (N for rows, 1 for
// columns), in the order of the plain version's slices and concatenations;
// idx and s are of one index type I (long long on global stacks, int in
// shared memory).
enum Stencil { STENCIL_FWD = 0, STENCIL_BWD = 1, STENCIL_CEN = 2 };

template <typename T, typename I>
__device__ __forceinline__ T diff1(const T* v, I idx, int i, int n, I s,
                                   int kind) {
  if (kind == STENCIL_FWD) return i < n - 1 ? v[idx + s] - v[idx] : T(0);
  if (kind == STENCIL_BWD) return i >= 1 ? v[idx] - v[idx - s] : T(0);
  return (i >= 1 && i < n - 1) ? (v[idx + s] - v[idx - s]) * T(0.5) : T(0);
}

// The adjoint of diff1 (−div along the axis): dplus_T, dminus_T, dcent_T.
template <typename T, typename I>
__device__ __forceinline__ T adj1(const T* q, I idx, int i, int n, I s,
                                  int kind) {
  if (kind == STENCIL_FWD) {
    T a = i >= 1 ? q[idx - s] : T(0);
    T b = i < n - 1 ? q[idx] : T(0);
    return a - b;
  }
  if (kind == STENCIL_BWD) {
    T a = i >= 1 ? q[idx] : T(0);
    T b = i < n - 1 ? q[idx + s] : T(0);
    return a - b;
  }
  // q is read on its interior 1..n−2 only
  T down = i >= 2 ? q[idx - s] : T(0);
  T up = i <= n - 3 ? q[idx + s] : T(0);
  return (down - up) * T(0.5);
}

// diag(Dᵀ diag(w) D) along the axis: dplus_gram, dminus_gram, dcent_gram.
template <typename T, typename I>
__device__ __forceinline__ T gram1(const T* w, I idx, int i, int n, I s,
                                   int kind) {
  if (kind == STENCIL_FWD) {
    T a = i >= 1 ? w[idx - s] : T(0);
    T b = i < n - 1 ? w[idx] : T(0);
    return a + b;
  }
  if (kind == STENCIL_BWD) {
    T a = i >= 1 ? w[idx] : T(0);
    T b = i < n - 1 ? w[idx + s] : T(0);
    return a + b;
  }
  T down = i >= 2 ? w[idx - s] : T(0);
  T up = i <= n - 3 ? w[idx + s] : T(0);
  return (down + up) * T(0.25);
}

// The 2-D gradient (rows, columns) of plane v at flat index idx.
template <typename T>
__device__ __forceinline__ void grad_k(const T* v, long long idx, Pix p,
                                       int M, int N, int kind, T& gx, T& gy) {
  gx = diff1(v, idx, p.i, M, (long long)N, kind);
  gy = diff1(v, idx, p.j, N, 1LL, kind);
}

// Gᵀ of the field (qx, qy): adjoint along rows + adjoint along columns.
template <typename T>
__device__ __forceinline__ T div_k(const T* qx, const T* qy, long long idx,
                                   Pix p, int M, int N, int kind) {
  return adj1(qx, idx, p.i, M, (long long)N, kind)
         + adj1(qy, idx, p.j, N, 1LL, kind);
}

// diag(Gᵀ diag(w) G) for the weights (wx, wy): gram_diag of ops/grad.py.
template <typename T>
__device__ __forceinline__ T gram_k(const T* wx, const T* wy, long long idx,
                                    Pix p, int M, int N, int kind) {
  return gram1(wx, idx, p.i, M, (long long)N, kind)
         + gram1(wy, idx, p.j, N, 1LL, kind);
}

// Π onto the Euclidean ball of radius a, given the squared norm n2 of a
// pixel's vector: the scale factor, in the plain version's form
// (ops/field.py::proj_norm21_ball: n = √Σ, 1 if n ≤ a, else a/max(n, tiny)).
template <typename T>
__device__ __forceinline__ T ball_scale(T n2, T a) {
  T nrm = sqrt(n2);
  if (nrm <= a) return T(1);
  return a / (nrm > tiny<T>() ? nrm : tiny<T>());
}

// x, or 1 where x is 0: the guard of every CG division.
template <typename T>
__device__ __forceinline__ T nz(T x) {
  return x == T(0) ? T(1) : x;
}

// Sum of v over the block (BPL_THREADS threads); the result is valid in
// thread 0.  Fixed tree order.
template <typename T>
__device__ __forceinline__ T block_sum(T v, T* sh) {
  sh[threadIdx.x] = v;
  __syncthreads();
  for (int s = BPL_THREADS / 2; s > 0; s >>= 1) {
    if ((int)threadIdx.x < s) sh[threadIdx.x] += sh[threadIdx.x + s];
    __syncthreads();
  }
  T r = sh[0];
  __syncthreads();
  return r;
}

// Second pass of a batch-wide sum: block s sums partials[s*nblocks ...]
// in a fixed order and writes out[slot_s].
template <typename T>
__global__ void sum_partials(const T* __restrict__ partials, int nblocks,
                             T* __restrict__ out, int slot0, int slot1,
                             int slot2) {
  __shared__ T sh[BPL_THREADS];
  const int s = blockIdx.x;
  const T* src = partials + (long long)s * nblocks;
  T acc = T(0);
  for (int k = threadIdx.x; k < nblocks; k += BPL_THREADS) acc += src[k];
  T tot = block_sum(acc, sh);
  if (threadIdx.x == 0) {
    int slot = s == 0 ? slot0 : (s == 1 ? slot1 : slot2);
    out[slot] = tot;
  }
}

// The primal step of the accelerated CP iteration (kernels A and VTV), one
// thread per pixel of a (batch, M, N) stack whose dual y is (batch, 2, M, N):
//   u⁺ = (u − τ(Gᵀy − f))/(1+τ);  ū = (1+ω)u⁺ − ωu.
template <typename T>
__global__ void pd_primal(const T* __restrict__ f, T* __restrict__ u,
                          T* __restrict__ ubar, const T* __restrict__ y,
                          long long n, int M, int N, T tau, T omega) {
  long long idx = (long long)blockIdx.x * BPL_THREADS + threadIdx.x;
  if (idx >= n) return;
  Pix p = pix_of(idx, M, N);
  const long long MN = (long long)M * N;
  const long long in_img = idx - p.b * MN;
  const T* qx = y + p.b * 2 * MN;
  const T* qy = qx + MN;
  T div = div_k(qx, qy, in_img, p, M, N, STENCIL_FWD);
  T uo = u[idx];
  T un = (uo - tau * (div - f[idx])) / (T(1) + tau);
  u[idx] = un;
  ubar[idx] = (T(1) + omega) * un - omega * uo;
}

// ratio[b] = ‖u_b − uprev_b‖ / max(‖u_b‖, 1e-12); one block per image.
template <typename T>
__global__ void pd_change(const T* __restrict__ u, const T* __restrict__ uprev,
                          T* __restrict__ ratio, long long MN) {
  __shared__ T sh[BPL_THREADS];
  const long long base = (long long)blockIdx.x * MN;
  T num = T(0), den = T(0);
  for (long long k = threadIdx.x; k < MN; k += BPL_THREADS) {
    T a = u[base + k];
    T d = a - uprev[base + k];
    num += d * d;
    den += a * a;
  }
  T snum = block_sum(num, sh);
  T sden = block_sum(den, sh);
  if (threadIdx.x == 0) {
    T nd = sqrt(sden);
    ratio[blockIdx.x] = sqrt(snum) / (nd < T(1e-12) ? T(1e-12) : nd);
  }
}

inline int blocks_for(long long n) {
  return (int)((n + BPL_THREADS - 1) / BPL_THREADS);
}

// Per-block partial sums of (u − u_prev)² and r², r the chunk's old
// iterate u_prev (OLD: the TGV² rule) or its new one u (the TV-L1 rule).
template <typename T, bool OLD>
__global__ void cp_change(const T* __restrict__ u,
                          const T* __restrict__ uprev,
                          T* __restrict__ partials, long long n,
                          int nblocks) {
  __shared__ T sh[BPL_THREADS];
  long long idx = (long long)blockIdx.x * BPL_THREADS + threadIdx.x;
  T d2 = T(0), r2 = T(0);
  if (idx < n) {
    T a = u[idx];
    T b = uprev[idx];
    T d = a - b;
    T r = OLD ? b : a;
    d2 = d * d;
    r2 = r * r;
  }
  T sd = block_sum(d2, sh);
  T sr = block_sum(r2, sh);
  if (threadIdx.x == 0) {
    partials[blockIdx.x] = sd;
    partials[nblocks + blockIdx.x] = sr;
  }
}

// The stop rules of cp_iterate.  check(u, uprev, ops, st) issues one
// check's device work on the chunk's new iterate u and its old one uprev
// and the host read of its result, adding its device operations to *ops;
// once the stream is synchronised, rel() is the change that cp_iterate
// compares with tol (a NaN stops, as in the plain loops).
//
// CpSumStop, the batch-wide rule of TV-L1 and TGV²: the two passes of the
// sums (cp_change, sum_partials) over the n elements and one read of the
// two sums; OLD: rel = ‖u − u_prev‖ / max(‖u_prev‖, 1), else
// rel = √(Σ(u − u_prev)² / max(Σu², 1e-24)).  partials holds
// 2·⌈n / 256⌉ elements, scal 3.
template <typename T, bool OLD>
struct CpSumStop {
  T* partials;
  T* scal;
  long long n;
  T h[2];
  cudaError_t check(const T* u, const T* uprev, int* ops, cudaStream_t st) {
    const int grid = blocks_for(n);
    cp_change<T, OLD><<<grid, BPL_THREADS, 0, st>>>(u, uprev, partials, n,
                                                    grid);
    BPL_LAUNCH(sum_partials<T>, 2, BPL_THREADS, st)(partials, grid, scal, 0,
                                                    1, 2);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    e = cudaMemcpyAsync(h, scal, 2 * sizeof(T), cudaMemcpyDeviceToHost, st);
    *ops += 3;
    return e;
  }
  T rel() const {
    if (OLD) {
      T ref = std::sqrt(h[1]);
      return std::sqrt(h[0]) / (ref > T(1) ? ref : T(1));
    }
    T den = h[1] > T(1e-24) ? h[1] : T(1e-24);
    return std::sqrt(h[0] / den);
  }
};

// CpPlaneStop, the per-plane rule of the accelerated CP kernels (kernel A
// over its O images, VTV over its O·C channel planes): pd_change's
// ‖u_p − u_prev,p‖ / max(‖u_p‖, 1e-12) for each of `planes` planes of mn
// elements (u the new iterate) and one read of the ratios; rel = their
// max, a NaN ratio propagating.  ratio holds `planes` elements.
template <typename T>
struct CpPlaneStop {
  T* ratio;
  long long planes, mn;
  std::vector<T> h;
  CpPlaneStop(T* ratio_, long long planes_, long long mn_)
      : ratio(ratio_), planes(planes_), mn(mn_), h((size_t)planes_) {}
  cudaError_t check(const T* u, const T* uprev, int* ops, cudaStream_t st) {
    BPL_LAUNCH(pd_change<T>, (int)planes, BPL_THREADS, st)(u, uprev, ratio,
                                                           mn);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    e = cudaMemcpyAsync(h.data(), ratio, (size_t)planes * sizeof(T),
                        cudaMemcpyDeviceToHost, st);
    *ops += 2;
    return e;
  }
  T rel() const {
    T delta = h[0];
    for (long long b = 1; b < planes; ++b)
      if (std::isnan(h[b]) || h[b] > delta) delta = h[b];
    return delta;
  }
};

// The host loop of the CP kernels that run an early-stop chunk from a u
// buffer into another (TV-L1 and TGV² in both their forms, kernel A's and
// VTV's cluster forms).  advance(from, to, it0, n) runs iterations
// it0 … it0 + n − 1 from the u buffer `from` into `to` (one buffer without
// tol).  With use_tol, per chunk of check_every iterations the stop rule's
// check on the two u buffers; stop once its rel() ≤ tol.  u and uprev
// ping-pong, and the result is copied into u (n elements) when it ends in
// uprev.  *ops counts the device operations (advance and the rule add
// their own).
template <typename T, class Stop, class Advance>
int cp_iterate(Advance advance, Stop& stop, T* u, T* uprev, long long n,
               int maxiter, int use_tol, T tol, int check_every,
               int* iters_out, int* ops, cudaStream_t st) {
  cudaError_t e;
  int it = 0;
  if (!use_tol) {
    if (maxiter > 0 && (e = advance(u, u, 0, maxiter)) != cudaSuccess)
      return (int)e;
    it = maxiter;
  } else {
    T rel = (T)INFINITY;
    T* cur = u;
    T* nxt = uprev;
    while (it < maxiter && rel > tol) {
      const int chunk = check_every < maxiter - it ? check_every
                                                   : maxiter - it;
      if ((e = advance(cur, nxt, it, chunk)) != cudaSuccess) return (int)e;
      if ((e = stop.check(nxt, cur, ops, st)) != cudaSuccess) return (int)e;
      if ((e = cudaStreamSynchronize(st)) != cudaSuccess) return (int)e;
      rel = stop.rel();
      it += chunk;
      T* t = cur;
      cur = nxt;
      nxt = t;
    }
    if (cur != u) {
      e = cudaMemcpyAsync(u, cur, (size_t)n * sizeof(T),
                          cudaMemcpyDeviceToDevice, st);
      if (e != cudaSuccess) return (int)e;
      ++*ops;
    }
  }
  *iters_out = it;
  return (int)cudaGetLastError();
}

// cp_iterate in the two-launch form: the state s (s.u, s.n) in global
// memory, one thread a pixel, primal then dual per iteration, u in place
// in the buffer `to` (a copy of `from` first).
template <typename T, bool OLD, class S>
int cp_two_launch(void (*primal)(S), void (*dual)(S), S s, T* uprev,
                  T* partials, T* scal, int maxiter, int use_tol, T tol,
                  int check_every, int* iters_out, int* ops,
                  cudaStream_t st) {
  const int grid = blocks_for(s.n);
  auto advance = [&](T* from, T* to, int, int n) -> cudaError_t {
    cudaError_t e;
    if (from != to) {
      e = cudaMemcpyAsync(to, from, (size_t)s.n * sizeof(T),
                          cudaMemcpyDeviceToDevice, st);
      if (e != cudaSuccess) return e;
      ++*ops;
    }
    s.u = to;
    for (int k = 0; k < n; ++k) {
      primal<<<grid, BPL_THREADS, 0, st>>>(s);
      dual<<<grid, BPL_THREADS, 0, st>>>(s);
      *ops += 2;
      if ((e = cudaGetLastError()) != cudaSuccess) return e;
    }
    return cudaSuccess;
  };
  CpSumStop<T, OLD> stop{partials, scal, s.n, {}};
  return cp_iterate<T>(advance, stop, s.u, uprev, s.n, maxiter, use_tol, tol,
                       check_every, iters_out, ops, st);
}

// The host loop of the accelerated CP iteration (kernels A and VTV) on a
// stack of `planes` (M, N) planes.  Per iteration: ω = 1/√(1+2γτ),
// primal(τ, ω) launches the primal step, τ ← τω, σ ← σ/ω, then dual(σ)
// launches the model's dual step.  τ, σ, ω are formed here in the working
// dtype, in the order of the plain version.  With use_tol, every
// `check_every` iterations (a chunk, which starts with a copy of u into
// uprev) CpPlaneStop's max over the planes of ‖u − uprev‖/max(‖u‖, 1e-12)
// (one host read of the per-plane ratios) is compared with tol; a NaN
// ratio propagates and stops.  Returns a cudaError_t; *iters_out is the
// number of iterations run, *ops counts the device operations (2 an
// iteration, 3 a chunk: the copy, pd_change and the read).
template <typename T, typename Primal, typename Dual>
int pd_iterate_with(T* u, T* uprev, T* ratio, long long planes, int M, int N,
                    T tau, T sigma, double gamma, int accel, int maxiter,
                    int use_tol, T tol, int check_every, int* iters_out,
                    int* ops, cudaStream_t s, Primal primal, Dual dual) {
  const long long n = planes * M * N;
  const T two_gamma = T(2.0 * gamma);
  cudaError_t err;

  auto step = [&]() -> cudaError_t {
    T omega = T(1);
    if (accel) omega = T(1) / std::sqrt(T(1) + two_gamma * tau);
    primal(tau, omega);
    if (accel) {
      tau = tau * omega;
      sigma = sigma / omega;
    }
    dual(sigma);
    *ops += 2;
    return cudaGetLastError();
  };

  int it = 0;
  if (!use_tol) {
    for (; it < maxiter; ++it)
      if ((err = step()) != cudaSuccess) return (int)err;
  } else {
    CpPlaneStop<T> stop(ratio, planes, (long long)M * N);
    T delta = (T)INFINITY;
    const size_t bytes = (size_t)n * sizeof(T);
    while (it < maxiter && delta > tol) {
      err = cudaMemcpyAsync(uprev, u, bytes, cudaMemcpyDeviceToDevice, s);
      if (err != cudaSuccess) return (int)err;
      ++*ops;
      const int chunk = check_every < maxiter - it ? check_every : maxiter - it;
      for (int k = 0; k < chunk; ++k)
        if ((err = step()) != cudaSuccess) return (int)err;
      if ((err = stop.check(u, uprev, ops, s)) != cudaSuccess)
        return (int)err;
      if ((err = cudaStreamSynchronize(s)) != cudaSuccess) return (int)err;
      delta = stop.rel();
      it += chunk;
    }
  }
  *iters_out = it;
  return (int)cudaGetLastError();
}

// The per-iteration scalars (τ, ω, σ) of maxiter iterations, formed as
// pd_iterate_with forms them: ω = 1/√(1+2γτ), the primal step at τ, then
// τ ← τω, σ ← σ/ω, and the dual step at that σ.  The cluster forms of
// kernel A and the VTV kernel read them from a device copy, so their
// iterates are the two-launch form's bit for bit.
template <typename T>
std::vector<T> cp_table(T tau, T sigma, double gamma, int accel,
                        int maxiter) {
  std::vector<T> t(3 * (size_t)maxiter);
  const T two_gamma = T(2.0 * gamma);
  for (int it = 0; it < maxiter; ++it) {
    T omega = T(1);
    if (accel) omega = T(1) / std::sqrt(T(1) + two_gamma * tau);
    t[3 * (size_t)it] = tau;
    t[3 * (size_t)it + 1] = omega;
    if (accel) {
      tau = tau * omega;
      sigma = sigma / omega;
    }
    t[3 * (size_t)it + 2] = sigma;
  }
  return t;
}

// pd_iterate_with with the one-dual forward-difference primal step
// pd_primal, whose dual y is (planes, 2, M, N): kernel A's scalar TV form
// and the VTV kernel.
template <typename T, typename Dual>
int pd_iterate(const T* f, T* u, T* y, T* ubar, T* uprev, T* ratio,
               long long planes, int M, int N, T tau, T sigma, double gamma,
               int accel, int maxiter, int use_tol, T tol, int check_every,
               int* iters_out, int* ops, cudaStream_t s, Dual dual) {
  const long long n = planes * M * N;
  const int grid = blocks_for(n);
  auto primal = [&](T tau_, T omega) {
    BPL_LAUNCH(pd_primal<T>, grid, BPL_THREADS, s)(f, u, ubar, y, n, M, N,
                                                   tau_, omega);
  };
  return pd_iterate_with<T>(u, uprev, ratio, planes, M, N, tau, sigma, gamma,
                            accel, maxiter, use_tol, tol, check_every,
                            iters_out, ops, s, primal, dual);
}

}  // namespace bpl
