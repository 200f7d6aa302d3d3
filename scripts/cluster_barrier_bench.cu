// What a thread-block cluster barrier costs on the card, beside a block
// barrier: 80 CTAs of 512 threads in clusters of 8 (the PD phase of
// bpldenoising_tpu_torch/csrc/single_loop.cu at 10×128²) run n = 0, 40 and
// 400 iterations of a multiply-add and one barrier each: cluster.sync(),
// __syncthreads(), or a store into the next CTA's shared memory followed
// by cluster.sync().  Then what a grid-wide barrier of a cooperative launch
// costs (kernel B, csrc/hypergrad.cu): 132 and 264 CTAs of 256 threads run
// the same loop with cooperative_groups' grid.sync() or a hand-written
// barrier (one atomicAdd a CTA on a word whose top bit flips when the last
// CTA arrives, the scheme grid.sync() uses).  Prints the time per launch
// (CUDA events, 20 launches after 3 warm-ups), the cost of one grid
// barrier ((t(400) − t(0))/400) and the card's name and power limit.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 \
//        -o /tmp/cluster_barrier_bench scripts/cluster_barrier_bench.cu
//   /tmp/cluster_barrier_bench
#include <cooperative_groups.h>

#include <cstdio>
#include <cstdlib>

namespace cg = cooperative_groups;

__global__ void with_cluster_sync(int n, float* out) {
  cg::cluster_group cl = cg::this_cluster();
  float a = threadIdx.x;
  for (int i = 0; i < n; ++i) {
    a = a * 1.0001f + 1.0f;
    cl.sync();
  }
  if (a == -1.f) out[0] = a;
}

__global__ void with_block_sync(int n, float* out) {
  float a = threadIdx.x;
  for (int i = 0; i < n; ++i) {
    a = a * 1.0001f + 1.0f;
    __syncthreads();
  }
  if (a == -1.f) out[0] = a;
}

__global__ void with_remote_store(int n, float* out) {
  extern __shared__ float sm[];
  cg::cluster_group cl = cg::this_cluster();
  float* next = cl.map_shared_rank(sm, (cl.block_rank() + 1) % 8);
  sm[threadIdx.x] = threadIdx.x;
  cl.sync();
  float a = 0;
  for (int i = 0; i < n; ++i) {
    next[threadIdx.x] = a;
    cl.sync();
    a += sm[threadIdx.x];
  }
  if (a == -1.f) out[0] = a;
}

template <typename K>
float us_per_launch(K kernel, int n, size_t smem, float* out) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(80);
  cfg.blockDim = dim3(512);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 8;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  for (int w = 0; w < 3; ++w) cudaLaunchKernelEx(&cfg, kernel, n, out);
  cudaEventRecord(a);
  for (int w = 0; w < 20; ++w) cudaLaunchKernelEx(&cfg, kernel, n, out);
  cudaEventRecord(b);
  cudaEventSynchronize(b);
  float ms = 0;
  cudaEventElapsedTime(&ms, a, b);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) {
    std::printf("CUDA error: %s\n", cudaGetErrorString(err));
    std::exit(1);
  }
  return ms / 20 * 1000;
}

__global__ void with_grid_sync(int n, float* out, unsigned int*) {
  cg::grid_group grid = cg::this_grid();
  float a = threadIdx.x;
  for (int i = 0; i < n; ++i) {
    a = a * 1.0001f + 1.0f;
    grid.sync();
  }
  if (a == -1.f) out[0] = a;
}

// CTA 0 adds 2³¹ − (CTAs − 1), every other CTA 1: the word's top bit
// flips once all have arrived, and its low bits return to where they were.
__device__ __forceinline__ void hand_grid_sync(unsigned int* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned int inc =
        blockIdx.x == 0 ? 0x80000000u - (gridDim.x - 1) : 1u;
    __threadfence();
    const unsigned int old = atomicAdd(bar, inc);
    while (((old ^ *(volatile unsigned int*)bar) & 0x80000000u) == 0) {
    }
    __threadfence();
  }
  __syncthreads();
}

__global__ void with_hand_sync(int n, float* out, unsigned int* bar) {
  float a = threadIdx.x;
  for (int i = 0; i < n; ++i) {
    a = a * 1.0001f + 1.0f;
    hand_grid_sync(bar);
  }
  if (a == -1.f) out[0] = a;
}

float us_per_coop_launch(void (*kernel)(int, float*, unsigned int*),
                         int ctas, int n, float* out, unsigned int* bar) {
  void* args[] = {&n, &out, &bar};
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  for (int w = 0; w < 3; ++w)
    cudaLaunchCooperativeKernel((const void*)kernel, dim3(ctas), dim3(256),
                                args, 0, 0);
  cudaEventRecord(a);
  for (int w = 0; w < 20; ++w)
    cudaLaunchCooperativeKernel((const void*)kernel, dim3(ctas), dim3(256),
                                args, 0, 0);
  cudaEventRecord(b);
  cudaEventSynchronize(b);
  float ms = 0;
  cudaEventElapsedTime(&ms, a, b);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) {
    std::printf("CUDA error: %s\n", cudaGetErrorString(err));
    std::exit(1);
  }
  return ms / 20 * 1000;
}

int main() {
  std::fflush(stdout);
  std::system("nvidia-smi --query-gpu=name,power.limit --format=csv,noheader");
  float* out;
  unsigned int* bar;
  if (cudaMalloc(&out, sizeof(float)) != cudaSuccess) return 1;
  if (cudaMalloc(&bar, sizeof(unsigned int)) != cudaSuccess) return 1;
  if (cudaMemset(bar, 0, sizeof(unsigned int)) != cudaSuccess) return 1;
  for (int n : {0, 40, 400})
    std::printf("n=%d: cluster.sync %.2f us, __syncthreads %.2f us, "
                "remote store + cluster.sync %.2f us per launch\n", n,
                us_per_launch(with_cluster_sync, n, 0, out),
                us_per_launch(with_block_sync, n, 0, out),
                us_per_launch(with_remote_store, n, 2048 * sizeof(float),
                              out));
  for (int ctas : {132, 264}) {
    float t[2][3];
    const int ns[3] = {0, 40, 400};
    for (int i = 0; i < 3; ++i) {
      t[0][i] = us_per_coop_launch(with_grid_sync, ctas, ns[i], out, bar);
      t[1][i] = us_per_coop_launch(with_hand_sync, ctas, ns[i], out, bar);
      std::printf("%d CTAs x 256, n=%d: grid.sync %.2f us, hand-written "
                  "%.2f us per launch\n", ctas, ns[i], t[0][i], t[1][i]);
    }
    std::printf("%d CTAs: one grid barrier %.3f us (grid.sync), %.3f us "
                "(hand-written)\n", ctas, (t[0][2] - t[0][0]) / 400,
                (t[1][2] - t[1][0]) / 400);
  }
  return 0;
}
