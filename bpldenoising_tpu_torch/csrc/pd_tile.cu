// Kernel A's tile form: the accelerated CP solve of csrc/pdps.cu on images
// whose bands do not fit a cluster, T iterations a launch on shared-memory
// 2-D tiles with a recomputed halo (the scheme, its bound on an H100 and
// what the design does about it: csrc/pd_tile.cuh).  It replaces the TPU
// kernel bpldenoising_tpu/solvers/pdps_pallas.py::_make_tiled_kernel for
// those images, where csrc/pdps.cu's two-launch form ran before; the host
// (solvers/cluster_plan.py::pd_tile_plan) plans it from the shapes.  The
// iterates, ratios, stop decisions and iteration counts are the two-launch
// form's, bit for bit.
#include <cstring>

#include "pd_tile.cuh"
#include "pdps.cuh"

namespace bpl {

// T iterations from iteration it0 for every tile of the batch (csrc/
// pd_tile.cuh), u from uin to uout and the duals from yin to yout (four
// distinct buffers), the tensor maps of those buffers in maps (TMA).
template <typename T, int F>
__global__ void __launch_bounds__(PT_THREADS, PT_MINB)
pdt_cp(CPC<T> h, PtGeom g, const T* uin, T* uout, const T* yin, T* yout,
       int it0, int n_it, const __grid_constant__ PtMaps maps) {
  extern __shared__ __align__(128) unsigned char pdt_smem[];
  CpStep<T, F> step(h, uin, uout, it0);
  pd_tile_run<T>(step, g, uin, uout, yin, yout, maps, pdt_smem, n_it);
}

// The host loop of the tile form: the (τ, ω, σ) table copy, then per
// early-stop chunk ⌈chunk / T⌉ launches (the last shorter where T does not
// divide the chunk), pd_change and one read of the ratios (common.cuh's
// CpPlaneStop; all maxiter iterations one chunk without tol).  u ping-pongs
// among u, uprev and u2 (a launch never writes the buffer it reads, nor the
// chunk's first iterate, which pd_change compares), the duals between y and
// y2; a last copy brings each home.  *ops: the device operations issued.
template <typename T, int F>
int pdt_run(const CPC<T>& h, PtGeom g, int grid, T* u, T* uprev, T* u2,
            T* y2, T* ratio, T* tab, T tau, T sigma, double gamma,
            int accel, int maxiter, int use_tol, T tol, int check_every,
            int* iters_out, int* ops, cudaStream_t s) {
  auto kern = pdt_cp<T, F>;
  const int nb = 2 + 2 * h.K;
  g.plane = (int)((((long long)g.height * g.pitch * sizeof(T) + PT_ALIGN - 1)
                   / PT_ALIGN) * PT_ALIGN / sizeof(T));
  const size_t smem = PT_ALIGN + (size_t)nb * g.plane * sizeof(T);
  int dev = 0, optin = 0, per_sm = 0;
  cudaError_t e;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev);
  if (e != cudaSuccess) return (int)e;
  if (smem > (size_t)optin || grid < 1) return (int)cudaErrorInvalidValue;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                    PT_THREADS, smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;

  T* ub[3] = {u, uprev, u2};
  T* yb[2] = {h.y, y2};
  PtMaps maps;
  memset(&maps, 0, sizeof(maps));
  CUtensorMap ld_u[3], st_u[3], ld_y[2], st_y[2];
  if (g.tma) {
    int err;
    const long long ny = 2LL * h.K * g.O;
    for (int q = 0; q < 3; ++q) {
      if ((err = pt_tensor_map<T>(&ld_u[q], ub[q], h.M, h.N, g.O, g.height,
                                  g.pitch)) != 0
          || (err = pt_tensor_map<T>(&st_u[q], ub[q], h.M, h.N, g.O, g.th,
                                     g.tw)) != 0)
        return err;
    }
    for (int q = 0; q < 2; ++q) {
      if ((err = pt_tensor_map<T>(&ld_y[q], yb[q], h.M, h.N, ny, g.height,
                                  g.pitch)) != 0
          || (err = pt_tensor_map<T>(&st_y[q], yb[q], h.M, h.N, ny, g.th,
                                     g.tw)) != 0)
        return err;
    }
  }
  if (maxiter > 0) {
    const std::vector<T> t = cp_table(tau, sigma, gamma, accel, maxiter);
    e = cudaMemcpyAsync(tab, t.data(), t.size() * sizeof(T),
                        cudaMemcpyHostToDevice, s);
    if (e != cudaSuccess) return (int)e;
    ++*ops;
  }
  int cu = 0, cy = 0;   // the buffers that hold the iterate
  // n iterations from it0 in launches of T; snap: a u buffer not to write
  auto advance = [&](int it0, int n, int snap) -> cudaError_t {
    for (int done = 0; done < n; done += g.T) {
      const int m = n - done < g.T ? n - done : g.T;
      int to = (cu + 1) % 3;
      if (to == snap || (snap < 0 && to == 2)) to = (to + 1) % 3;
      if (to == cu) to = (cu + 2) % 3;
      if (g.tma) {
        maps.uin = ld_u[cu];
        maps.uout = st_u[to];
        maps.yin = ld_y[cy];
        maps.yout = st_y[1 - cy];
      }
      kern<<<grid, PT_THREADS, smem, s>>>(h, g, ub[cu], ub[to], yb[cy],
                                          yb[1 - cy], it0 + done, m, maps);
      ++*ops;
      cudaError_t le = cudaGetLastError();
      if (le != cudaSuccess) return le;
      cu = to;
      cy = 1 - cy;
    }
    return cudaSuccess;
  };
  int it = 0;
  if (!use_tol) {
    if ((e = advance(0, maxiter, -1)) != cudaSuccess) return (int)e;
    it = maxiter;
  } else {
    CpPlaneStop<T> stop(ratio, g.O, h.mn);
    T rel = (T)INFINITY;
    while (it < maxiter && rel > tol) {
      const int chunk = check_every < maxiter - it ? check_every
                                                   : maxiter - it;
      const int snap = cu;
      if ((e = advance(it, chunk, snap)) != cudaSuccess) return (int)e;
      if ((e = stop.check(ub[cu], ub[snap], ops, s)) != cudaSuccess)
        return (int)e;
      if ((e = cudaStreamSynchronize(s)) != cudaSuccess) return (int)e;
      rel = stop.rel();
      it += chunk;
    }
  }
  if (cu != 0) {
    e = cudaMemcpyAsync(u, ub[cu], (size_t)h.n * sizeof(T),
                        cudaMemcpyDeviceToDevice, s);
    if (e != cudaSuccess) return (int)e;
    ++*ops;
  }
  if (cy != 0) {
    e = cudaMemcpyAsync(h.y, y2, (size_t)h.n * 2 * h.K * sizeof(T),
                        cudaMemcpyDeviceToDevice, s);
    if (e != cudaSuccess) return (int)e;
    ++*ops;
  }
  *iters_out = it;
  return (int)cudaGetLastError();
}

template <typename T>
int pdps_tile(const T* f, T* u, T* y, T* uprev, T* u2, T* y2, T* ratio,
              T* tab, long long O, int M, int N, int K, const int* kinds,
              const T* alphas, const long long* amaps, const int* plan,
              T tau, T sigma, double gamma, int accel, int maxiter,
              int use_tol, T tol, int check_every, int* iters_out, int* ops,
              cudaStream_t s) {
  *ops = 0;
  *iters_out = 0;
  if (K < 1 || K > 3 || O < 1 || M < 1 || N < 1 || maxiter < 0
      || (use_tol && check_every < 1))
    return (int)cudaErrorInvalidValue;
  CPC<T> h;
  const int form = cp_state(h, f, y, tab, O, M, N, K, kinds, alphas, amaps);
  int lo = 0, hi = 0;
  for (int k = 0; k < K; ++k) {
    if (kinds[k] != STENCIL_BWD) lo = 1;    // primal i − 1, dual i + 1
    if (kinds[k] != STENCIL_FWD) hi = 1;    // primal i + 1, dual i − 1
  }
  PtGeom g;
  // plan: th, tw, T, H, height, pitch, tiles_m, tiles_n, grid, tma
  g.O = O;
  g.th = plan[0];
  g.tw = plan[1];
  g.T = plan[2];
  g.H = plan[3];
  g.height = plan[4];
  g.pitch = plan[5];
  g.tiles_m = plan[6];
  g.tiles_n = plan[7];
  g.tma = plan[9];
  g.total = O * g.tiles_m * g.tiles_n;
  g.plane = 0;
  g.align = 16 / (int)sizeof(T);
  const int reach = lo + hi;
  if (!pd_tile_ok(O, M, N, K, reach, g.th, g.tw, g.T, g.H, g.height,
                  g.pitch, g.tiles_m, g.tiles_n, g.tma, (int)sizeof(T)))
    return (int)cudaErrorInvalidValue;
  if (g.tma) {
    // TMA copies u and the duals (f and the maps are plain loads)
    const uintptr_t mask = 15;
    if ((((uintptr_t)u | (uintptr_t)uprev | (uintptr_t)u2 | (uintptr_t)y
          | (uintptr_t)y2) & mask) != 0)
      return (int)cudaErrorInvalidValue;
  }
#define PDT_RUN(F)                                                          \
  pdt_run<T, F>(h, g, plan[8], u, uprev, u2, y2, ratio, tab, tau, sigma,    \
                gamma, accel, maxiter, use_tol, tol, check_every, iters_out, \
                ops, s)
  switch (form) {
    case CP_TV: return PDT_RUN(CP_TV);
    case CP_TV_MAP: return PDT_RUN(CP_TV_MAP);
    case CP_SUMREGS: return PDT_RUN(CP_SUMREGS);
    case CP_SUMREGS_MAPS: return PDT_RUN(CP_SUMREGS_MAPS);
    default: return PDT_RUN(CP_ANY);
  }
#undef PDT_RUN
}

}  // namespace bpl

extern "C" {

// kernel A's tile form: the blocks as bpl_pdps_solve_* takes them; u2, y2
// the second u and dual buffers (uprev the third u buffer), tab 3·maxiter
// elements; plan the tile plan (solvers/cluster_plan.py::pd_tile_plan):
// th, tw, T, H, height, pitch, tiles_m, tiles_n, grid, tma.
int bpl_pdps_tile_f32(const float* f, float* u, float* y, float* uprev,
                      float* u2, float* y2, float* ratio, float* tab,
                      long long O, int M, int N, int K, const int* kinds,
                      const float* alphas, const long long* amaps,
                      const int* plan, float tau, float sigma, double gamma,
                      int accel, int maxiter, int use_tol, float tol,
                      int check_every, int* iters_out, int* ops_out,
                      void* stream) {
  return bpl::pdps_tile<float>(f, u, y, uprev, u2, y2, ratio, tab, O, M, N,
                               K, kinds, alphas, amaps, plan, tau, sigma,
                               gamma, accel, maxiter, use_tol, tol,
                               check_every, iters_out, ops_out,
                               (cudaStream_t)stream);
}

int bpl_pdps_tile_f64(const double* f, double* u, double* y, double* uprev,
                      double* u2, double* y2, double* ratio, double* tab,
                      long long O, int M, int N, int K, const int* kinds,
                      const double* alphas, const long long* amaps,
                      const int* plan, double tau, double sigma,
                      double gamma, int accel, int maxiter, int use_tol,
                      double tol, int check_every, int* iters_out,
                      int* ops_out, void* stream) {
  return bpl::pdps_tile<double>(f, u, y, uprev, u2, y2, ratio, tab, O, M, N,
                                K, kinds, alphas, amaps, plan, tau, sigma,
                                gamma, accel, maxiter, use_tol, tol,
                                check_every, iters_out, ops_out,
                                (cudaStream_t)stream);
}

}  // extern "C"
