// Shared helpers of the port's CUDA kernels (pdps.cu, hypergrad.cu, tgv.cu,
// tvl1.cu).
//
// Every kernel here runs one thread per pixel of a (batch, rows, cols)
// stack in global memory; the stencils are the forward differences of
// bpldenoising_tpu/ops/grad.py, masked at the image boundary.  Reductions
// over the batch are deterministic: each block writes one partial sum
// (a fixed tree inside the block), and a second one-block pass sums the
// partials in a fixed order.  There are no atomics, so repeated runs agree
// bit for bit.  Launch boundaries are the only synchronisation between
// blocks.
#pragma once

#include <cuda_runtime.h>

#include <cfloat>
#include <cmath>

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

// Forward differences (D⁺) of plane v at flat index idx: zero at the last
// row / column.
template <typename T>
__device__ __forceinline__ void grad_fwd(const T* v, long long idx, Pix p,
                                         int M, int N, T& gx, T& gy) {
  T c = v[idx];
  gx = (p.i < M - 1) ? v[idx + N] - c : T(0);
  gy = (p.j < N - 1) ? v[idx + 1] - c : T(0);
}

// Adjoint of D⁺ (−div) of the field (qx, qy) at flat index idx, in the
// order of ops/grad.py: (a_x − b_x) + (a_y − b_y).
template <typename T>
__device__ __forceinline__ T div_fwd_T(const T* qx, const T* qy, long long idx,
                                       Pix p, int M, int N) {
  T ax = (p.i >= 1) ? qx[idx - N] : T(0);
  T bx = (p.i < M - 1) ? qx[idx] : T(0);
  T ay = (p.j >= 1) ? qy[idx - 1] : T(0);
  T by = (p.j < N - 1) ? qy[idx] : T(0);
  return (ax - bx) + (ay - by);
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

inline int blocks_for(long long n) {
  return (int)((n + BPL_THREADS - 1) / BPL_THREADS);
}

}  // namespace bpl
