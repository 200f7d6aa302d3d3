// Kernel A's state and step, shared by its cluster form (csrc/pdps.cu's
// pdc_cp) and its tile form (csrc/pd_tile.cu's pdt_cp): the K blocks and
// planes of a launch (CPC), the forms the kernels are instantiated for
// (CpForm) and the accelerated CP step with τ, ω, σ from the host's
// per-iteration table (CpStep).
#pragma once

#include "pd_cluster.cuh"

namespace bpl {

// The state of a cluster or tile launch: the K blocks (stencil kind,
// scalar weight and its square, or an (M, N) map), the planes, the
// per-iteration table and the cluster form's plan (cl CTAs an image, rows
// each).  The
// blocks' fields are kept flat: with a nested Blocks<T> the K = 1 and map
// instances spilled 24 and 32 B (8 and 16 flat) and ran ~9% slower.
template <typename T>
struct CPC {
  const T* f;
  T* y;          // K × (O, 2, M, N)
  const T* tab;  // per iteration t: τ, ω, σ (cp_table)
  long long n, mn;
  int M, N, K, cl, rows;
  int kind[3];
  T alpha[3];
  T alpha2[3];
  const T* amap[3];   // nullptr: the scalar alpha[k]
};

// The blocks of a kernel instance.  F ≥ 0 fixes them at compile time as
// (K << 8) | kinds (two bits a block) | (map flags << 12), so the stencils'
// branches, the loops over k and the map tests fold away: the forms of the
// main paths, scalar or map TV (the flagship; patch TV and grids) and the
// sum of the forward, backward and centred blocks with scalars or maps (the
// sum of regularizers; the patch sum).  F < 0 reads them from h.
enum CpForm {
  CP_ANY = -1,
  CP_TV = (1 << 8) | STENCIL_FWD,
  CP_TV_MAP = CP_TV | (1 << 12),
  CP_SUMREGS = (3 << 8) | STENCIL_FWD | (STENCIL_BWD << 2)
               | (STENCIL_CEN << 4),
  CP_SUMREGS_MAPS = CP_SUMREGS | (7 << 12)
};

// The step of the accelerated CP iteration for pd_cluster_run
// (csrc/pd_cluster.cuh): τ, ω, σ of iteration it0 + it from the table;
// u⁺ = (u − τ(Σₖ Gₖᵀyₖ − f))/(1+τ), ū = (1+ω)u⁺ − ωu;
// yₖ = Π_{|·|≤αₖ}(yₖ + σGₖū) in pd_dual's rsqrt form, αₖ the scalar (its
// square from the host) or the map's pixel (squared here).  u is read from
// uin and written to uout.
template <typename T, int F>
struct CpStep {
  const CPC<T>& h;
  const T* uin;
  T* uout;
  int it0;
  int M, N, cl, rows;
  long long region;   // the bands live in shared memory: unused
  T* pd;
  T tau, omega, sigma;
  __device__ CpStep(const CPC<T>& h_, const T* uin_, T* uout_, int it0_)
      : h(h_), uin(uin_), uout(uout_), it0(it0_), M(h_.M), N(h_.N),
        cl(h_.cl), rows(h_.rows), region(0), pd(nullptr) {}
  __device__ int K() const { return F >= 0 ? (F >> 8) & 15 : h.K; }
  __device__ int kind(int k) const {
    return F >= 0 ? (F >> (2 * k)) & 3 : h.kind[k];
  }
  __device__ bool map(int k) const {
    return F >= 0 ? ((F >> (12 + k)) & 1) != 0 : h.amap[k] != nullptr;
  }
  __device__ const T* u_in(long long b) const { return uin + b * h.mn; }
  __device__ T* u_out(long long b) const { return uout + b * h.mn; }
  __device__ T* y(int k, long long b) const {
    return h.y + 2 * h.n * k + b * 2 * h.mn;
  }
  __device__ const T* f(long long b) const { return h.f + b * h.mn; }
  __device__ long long mn() const { return h.mn; }
  __device__ void at(int it) {
    const T* t = h.tab + 3LL * (it0 + it);
    tau = t[0];
    omega = t[1];
    sigma = t[2];
  }
  __device__ T primal(T dv, T uo, T fv, T& ub) const {
    const T un = (uo - tau * (dv - fv)) / (T(1) + tau);
    ub = (T(1) + omega) * un - omega * uo;
    return un;
  }
  __device__ T scale(int k, int i, int j, T n2) const {
    return scale_at(k, map(k) ? h.amap[k][i * N + j] : T(0), n2);
  }
  // the factor with block k's map value a at the pixel (read by the
  // caller)
  __device__ T scale_at(int k, T a, T n2) const {
    T alpha = h.alpha[k], alpha2 = h.alpha2[k];
    if (map(k)) {
      alpha = a;
      alpha2 = alpha * alpha;
    }
    return (n2 <= alpha2) ? T(1) : alpha * rsqrt_(n2 + tiny<T>());
  }
  __device__ const T* amap(int k) const { return h.amap[k]; }
};


// The K blocks' state of a launch (the cluster and tile forms) and its
// form (CpForm's code).
template <typename T>
int cp_state(CPC<T>& h, const T* f, T* y, T* tab, long long O, int M, int N,
             int K, const int* kinds, const T* alphas,
             const long long* amaps) {
  h.f = f;
  h.y = y;
  h.tab = tab;
  h.mn = (long long)M * N;
  h.n = O * h.mn;
  h.M = M;
  h.N = N;
  h.K = K;
  h.cl = 0;
  h.rows = 0;
  int form = K << 8;
  for (int k = 0; k < 3; ++k) {
    const bool live = k < K;
    h.kind[k] = live ? kinds[k] : STENCIL_FWD;
    h.alpha[k] = live ? alphas[k] : T(0);
    h.alpha2[k] = h.alpha[k] * h.alpha[k];
    h.amap[k] = live ? (const T*)amaps[k] : nullptr;
    if (live) form |= (h.kind[k] << (2 * k))
                      | ((h.amap[k] != nullptr) << (12 + k));
  }
  return form;
}

}  // namespace bpl
