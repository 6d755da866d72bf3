// Hand-written Hopper (sm_90a) kernel of the ensemble DG-in-time estimate,
// bound to Python with ctypes (plain C interface).
//
// D1  dg_estimate_ensemble   replaces adjoint_ode_adaptivity_tpu/ops/pallas/
//                            dg_slab.py:92 (_kernel, pallas_call :321)
//
// Per member, exactly what the TPU kernel computes (the weak form and sweep
// order of matlab/dg_march.m + adj_march.m, in-element quadrature):
//   forward element march k = 0..K−1 at order n (Np nodes): from u_prev, a
//   fixed number of Newton steps on the slab system R(U) = A·U + h/2·Σ_q
//   w_q φ_q f(φ_q·U, t_q) + e_L u_prev with A = Sᵀ, A[−1,−1] −= 1, and
//   dR/dU = A + h/2·Σ_q w_q f_u(φ_q·U) φ_q φ_qᵀ; then u_prev ← U[−1];
//   backward sweep k = K−1..0 at order n+1 (Na = Np+1 nodes): with the
//   primal interpolated into the element, (−Sᵀ − e_L e_Lᵀ + h/2·Σ_q w_q
//   f_u φ_q φ_qᵀ) v = −h/2·M·g_u − e_R v_inflow (g_u ≡ 1: J = ∫u dt), then
//   the primal residual at order n+1, res = Sᵀ u_h − e_R u_h[−1] + h/2·Σ_q
//   w_q φ_q f + e_L u_prev, and err_k = vᵀ res; v_inflow ← v[0].
// Both systems are solved per thread in registers: unrolled Cramer
// (cofactor expansion) for N ≤ 4, unrolled Gaussian elimination with
// partial pivoting (selects, no branches) for N = 5..8 — march/dg_batched.py
// solve_small's arithmetic (small_solve.cuh, shared with dg_slab_mixed.cu).
//
// Design for this card, not a copy of the TPU's (8, B/8) tiles: one thread
// per member (members are independent; the element loop is sequential by
// the inflow coupling), any B ≥ 1. Np is a template parameter (1..7, Na =
// Np+1 ≤ 8), so the nodal vectors and the Np×Np / Na×Na systems live in
// registers through unrolled loops. The quadrature loops run over a runtime
// count (n_gq is a caller's choice) and read the folded tables from
// __constant__ memory: Φ, w·Φ, w·Φ⊗Φ, (1+r_q)/2, Sᵀ, the mass row sums, and
// the primal→adjoint interpolation matrices, folded on the host in double and
// rounded to float32 (as the TPU kernel folds them into float32 immediates,
// dg_slab.py:96-117). Every thread of a warp reads the same entry, which is
// what the constant cache broadcasts. f and f_u of a quadrature point come
// from one functor pair call (odes.cuh; one sincosf for sin u), as the TPU
// kernel co-issues them (dg_slab.py:131-138).
//
// Times are float32; h = t[k+1] − t[k] is formed here, so a zero-width
// padding slab has h exactly 0. Shared times are read as (K+1,) (a
// broadcast), per-member times as (K+1, B) (neighbouring threads,
// neighbouring addresses); the outputs are written (K, Np, B), (K, Na, B)
// and (K, B), coalesced, and transposed to (B, K, ·) by the wrapper. The
// forward states the backward sweep needs stay in shared memory as
// [element][node][thread] when K·Np·128·4 bytes fit in 48 KB; otherwise the
// sweep re-reads them from the u output (this thread's own writes).
//
// What bounds it on the H100: operations, and in practice latency. A
// member-element costs newton_iters × Nq_p quadrature points, each Np
// interpolation FMAs, one (f, f_u) pair (a sincosf for sin u) and Np + Np²
// accumulation FMAs, plus one Np×Np solve per Newton step, and the order
// n+1 sweep (Nq_a points of Np + Na + Na² FMAs and one Na×Na solve). The
// bytes are a read of y0 and the times and a write of u, v and err. Each
// member's work is one serial chain (Newton steps and elements depend on
// the previous ones), so a thread waits on its own dependencies; one thread
// per member with everything in registers keeps that chain short. At B =
// 1024 the grid is 8 blocks of 128 threads on 132 SMs (under-filled, as F3's);
// at the 16,384-member benchmark shape 128 blocks. Splitting a member's
// work is later work.

#include <cuda_runtime.h>

#include <cmath>

#include "odes.cuh"
#include "small_solve.cuh"

namespace {

using namespace aoa;

constexpr int kDgThreads = 128;
constexpr int kMaxTables = 8192;      // floats of folded tables (32 KB of constant memory)
constexpr long kSmemCap = 48 * 1024;  // forward states in shared memory up to this size

__constant__ float c_tab[kMaxTables];

// Offsets into c_tab (floats); the layout is ops/cuda/dg_slab.py kernel_tables.
template <int NP>
struct Layout {
  static constexpr int NA = NP + 1;
  static constexpr int kQp = NP * NP;                    // forward quadrature rows
  static constexpr int kQpStride = NP + 1 + NP + NP * NP;  // φ, (1+r)/2, wφ, wφφ
  static constexpr int kQaStride = NP + 1 + NA + NA * NA;  // φ_p→q, (1+r)/2, wφ, wφφ
  int base_a, st_a, msum_a, to_nodes, qa;
  __device__ explicit Layout(int nqp) {
    base_a = kQp + nqp * kQpStride;
    st_a = base_a + NA * NA;
    msum_a = st_a + NA * NA;
    to_nodes = msum_a + NA;
    qa = to_nodes + NA * NP;
  }
};

template <int NP, class Ode>
__global__ void __launch_bounds__(kDgThreads)
dg_estimate_kernel(int nb, int k_el, int newton_iters, int nqp, int nqa, int t_stride,
                   int m_stride, int use_smem, const float* __restrict__ times,
                   const float* __restrict__ y0, float* __restrict__ u_out,
                   float* __restrict__ v_out, float* __restrict__ err_out, OdeConsts kc) {
  constexpr int NA = NP + 1;
  extern __shared__ float ustore[];  // [element][node][thread] when use_smem
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= nb) return;
  const int tx = threadIdx.x;
  const int bs = blockDim.x;
  const Layout<NP> lay(nqp);
  const float* tm = times + static_cast<long>(m) * m_stride;
  const float y0m = y0[m];

  // ---- forward element march (dg_march.m:26-78)
  float u_prev = y0m;
  for (int k = 0; k < k_el; ++k) {
    const float tl = tm[static_cast<long>(k) * t_stride];
    const float h = tm[static_cast<long>(k + 1) * t_stride] - tl;
    const float hh = h / 2.f;
    float u[NP];
#pragma unroll
    for (int i = 0; i < NP; ++i) u[i] = u_prev;
    for (int it = 0; it < newton_iters; ++it) {
      float res[NP];
      float jac[NP][NP];
#pragma unroll
      for (int i = 0; i < NP; ++i) {
        res[i] = 0.f;
#pragma unroll
        for (int j = 0; j < NP; ++j) jac[i][j] = 0.f;
      }
      for (int q = 0; q < nqp; ++q) {
        const float* row = c_tab + Layout<NP>::kQp + q * Layout<NP>::kQpStride;
        float uq = 0.f;
#pragma unroll
        for (int i = 0; i < NP; ++i) uq += row[i] * u[i];
        float fq, fuq;
        Ode::pair(uq, tl + row[NP] * h, kc, &fq, &fuq);
#pragma unroll
        for (int i = 0; i < NP; ++i) res[i] += row[NP + 1 + i] * fq;
#pragma unroll
        for (int i = 0; i < NP; ++i) {
#pragma unroll
          for (int j = 0; j < NP; ++j) jac[i][j] += row[2 * NP + 1 + i * NP + j] * fuq;
        }
      }
#pragma unroll
      for (int i = 0; i < NP; ++i) {
        float acc = 0.f;
#pragma unroll
        for (int j = 0; j < NP; ++j) acc += c_tab[i * NP + j] * u[j];
        acc = acc + hh * res[i];
        res[i] = (i == 0) ? acc + u_prev : acc;
#pragma unroll
        for (int j = 0; j < NP; ++j) jac[i][j] = c_tab[i * NP + j] + hh * jac[i][j];
      }
      float delta[NP];
      solve<NP>(jac, res, delta);
#pragma unroll
      for (int i = 0; i < NP; ++i) u[i] = u[i] - delta[i];
    }
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      u_out[static_cast<long>(k * NP + i) * nb + m] = u[i];
      if (use_smem) ustore[(k * NP + i) * bs + tx] = u[i];
    }
    u_prev = u[NP - 1];
  }

  // ---- backward adjoint sweep + per-element AWR (adj_march.m:65-120)
  float v_in = 0.f;
  for (int k = k_el - 1; k >= 0; --k) {
    const float tl = tm[static_cast<long>(k) * t_stride];
    const float h = tm[static_cast<long>(k + 1) * t_stride] - tl;
    const float hh = h / 2.f;
    float ue[NP];
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      ue[i] = use_smem ? ustore[(k * NP + i) * bs + tx]
                       : u_out[static_cast<long>(k * NP + i) * nb + m];
    }
    float up = y0m;
    if (k > 0) {
      const int idx = (k - 1) * NP + NP - 1;
      up = use_smem ? ustore[idx * bs + tx] : u_out[static_cast<long>(idx) * nb + m];
    }
    float uh[NA];
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < NP; ++j) acc += c_tab[lay.to_nodes + i * NP + j] * ue[j];
      uh[i] = acc;
    }
    float a[NA][NA];
    float r[NA];
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      r[i] = 0.f;
#pragma unroll
      for (int j = 0; j < NA; ++j) a[i][j] = 0.f;
    }
    for (int q = 0; q < nqa; ++q) {
      const float* row = c_tab + lay.qa + q * Layout<NP>::kQaStride;
      float uq = 0.f;
#pragma unroll
      for (int j = 0; j < NP; ++j) uq += row[j] * ue[j];
      float fq, fuq;
      Ode::pair(uq, tl + row[NP] * h, kc, &fq, &fuq);
#pragma unroll
      for (int i = 0; i < NA; ++i) r[i] += row[NP + 1 + i] * fq;
#pragma unroll
      for (int i = 0; i < NA; ++i) {
#pragma unroll
        for (int j = 0; j < NA; ++j) a[i][j] += row[NP + 1 + NA + i * NA + j] * fuq;
      }
    }
    float rhs[NA];
#pragma unroll
    for (int i = 0; i < NA; ++i) {
#pragma unroll
      for (int j = 0; j < NA; ++j) a[i][j] = c_tab[lay.base_a + i * NA + j] + hh * a[i][j];
      rhs[i] = -hh * c_tab[lay.msum_a + i];
    }
    rhs[NA - 1] = rhs[NA - 1] - v_in;
    float v[NA];
    solve<NA>(a, rhs, v);
    // the primal residual at the adjoint's order, weighted by v
    float err = 0.f;
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < NA; ++j) acc += c_tab[lay.st_a + i * NA + j] * uh[j];
      acc = acc + hh * r[i];
      if (i == NA - 1) acc = acc - uh[NA - 1];
      if (i == 0) acc = acc + up;
      err = (i == 0) ? v[i] * acc : err + v[i] * acc;
    }
#pragma unroll
    for (int i = 0; i < NA; ++i) v_out[static_cast<long>(k * NA + i) * nb + m] = v[i];
    err_out[static_cast<long>(k) * nb + m] = err;
    v_in = v[0];
  }
}

template <int NP>
constexpr int table_size(int nqp, int nqa) {
  return NP * NP + nqp * Layout<NP>::kQpStride + 2 * (NP + 1) * (NP + 1) + (NP + 1) +
         (NP + 1) * NP + nqa * Layout<NP>::kQaStride;
}

template <int NP, class Ode>
int launch_dg(int nb, int k_el, int newton_iters, int nqp, int nqa, int per_member,
              const float* times, const float* y0, float* u, float* v, float* err,
              const OdeConsts& kc, cudaStream_t stream) {
  const long smem = static_cast<long>(k_el) * NP * kDgThreads * sizeof(float);
  const int use_smem = smem <= kSmemCap ? 1 : 0;
  const int blocks = (nb + kDgThreads - 1) / kDgThreads;
  const int t_stride = per_member ? nb : 1;
  const int m_stride = per_member ? 1 : 0;
  dg_estimate_kernel<NP, Ode><<<blocks, kDgThreads, use_smem ? smem : 0, stream>>>(
      nb, k_el, newton_iters, nqp, nqa, t_stride, m_stride, use_smem, times, y0, u, v, err, kc);
  return static_cast<int>(cudaGetLastError());
}

template <class Ode>
int launch_np(int np_p, int nb, int k_el, int newton_iters, int nqp, int nqa, int per_member,
              const float* times, const float* y0, float* u, float* v, float* err,
              const OdeConsts& kc, cudaStream_t stream) {
#define AOA_DG_NP(N)                                                                      \
  case N:                                                                                 \
    return launch_dg<N, Ode>(nb, k_el, newton_iters, nqp, nqa, per_member, times, y0, u, \
                             v, err, kc, stream);
  switch (np_p) {
    AOA_DG_NP(1)
    AOA_DG_NP(2)
    AOA_DG_NP(3)
    AOA_DG_NP(4)
    AOA_DG_NP(5)
    AOA_DG_NP(6)
    AOA_DG_NP(7)
    default:
      return -4;
  }
#undef AOA_DG_NP
}

int expected_tables(int np_p, int nqp, int nqa) {
  switch (np_p) {
    case 1: return table_size<1>(nqp, nqa);
    case 2: return table_size<2>(nqp, nqa);
    case 3: return table_size<3>(nqp, nqa);
    case 4: return table_size<4>(nqp, nqa);
    case 5: return table_size<5>(nqp, nqa);
    case 6: return table_size<6>(nqp, nqa);
    case 7: return table_size<7>(nqp, nqa);
    default: return -1;
  }
}

}  // namespace

extern "C" {

// Return 0 on success, a cudaError_t code after a failed copy or launch,
// -2 for an ODE id the kernel does not take (or trig="fast" on another ODE
// than sin(u)), -4 for Np outside 1..7, -5 when the tables exceed the
// constant buffer, -6 when their length does not match (np_p, nqp, nqa).
// The tables are copied into constant memory on `stream` before the launch
// (ordered with earlier launches on that stream). per_member = 1: times is
// (K+1, B); 0: times is (K+1,).
int dg_estimate_ensemble(int ode_id, int fast_trig, int n_u, int n_t, const float* consts,
                         const float* tables, int n_tables, int np_p, int nqp, int nqa, int nb,
                         int k_el, int newton_iters, int per_member, const float* times,
                         const float* y0, float* u, float* v, float* err, void* stream) {
  if (fast_trig && ode_id != 1) return -2;
  if (np_p < 1 || np_p > 7) return -4;
  if (n_tables > kMaxTables) return -5;
  if (n_tables != expected_tables(np_p, nqp, nqa)) return -6;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e = cudaMemcpyToSymbolAsync(c_tab, tables, n_tables * sizeof(float), 0,
                                                cudaMemcpyHostToDevice, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  const OdeConsts kc = pack_consts(n_u, n_t, consts);
#define AOA_LAUNCH(ODE) \
  launch_np<ODE>(np_p, nb, k_el, newton_iters, nqp, nqa, per_member, times, y0, u, v, err, kc, s)
  AOA_ODE_SCALAR_SWITCH(ode_id, fast_trig, AOA_LAUNCH)
#undef AOA_LAUNCH
}

const char* dg_slab_error_string(int code) {
  if (code == -2) return "ODE kernel_id (or trig) not implemented by this kernel";
  if (code == -4) return "primal Np outside 1..7";
  if (code == -5) return "folded tables exceed the kernel's constant buffer (n_gq too large)";
  if (code == -6) return "folded table length does not match (Np, Nq_p, Nq_a)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
