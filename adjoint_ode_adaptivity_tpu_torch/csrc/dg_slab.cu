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
//   f_u φ_q φ_qᵀ) v = −h/2·M·g_u(u_h, t_n) − e_R v_inflow, then
//   the primal residual at order n+1, res = Sᵀ u_h − e_R u_h[−1] + h/2·Σ_q
//   w_q φ_q f + e_L u_prev, and err_k = vᵀ res; v_inflow ← v[0].
// The goal J = ∫g(u, t) dt enters through g_u at the adjoint nodes, a
// functor of odes.cuh chosen by the functional's kernel_id (a template
// parameter; in a user library the traced goal, ops/cuda/functor.py, and the
// ODE likewise): for J = ∫u (g_u ≡ 1) M·g_u is the folded row sums M·1; for
// any other goal the kernel evaluates g_u at the Na interpolated primal
// values u_h and node times t_n and forms −h/2·Σ_j M_ij·g_u(u_h[j], t_n[j])
// in ascending j, as the TPU kernel sums it (dg_slab.py:205-211), from the
// adjoint-order mass matrix and the node positions, appended to the tables.
// Both systems are solved per thread in registers: unrolled Cramer
// (cofactor expansion) for N ≤ 4, unrolled Gaussian elimination with
// partial pivoting (selects, no branches) for N = 5..8 — march/dg_batched.py
// solve_small's arithmetic (small_solve.cuh, shared with dg_slab_mixed.cu).
//
// Design for this card, not a copy of the TPU's (8, B/8) tiles: a group of
// G lanes of one warp per member (G ∈ {1, 2, 4, 8, 16, 32}; members are
// independent, the element loop is sequential by the inflow coupling), any
// B ≥ 1. Np is a template parameter (1..7, Na = Np+1 ≤ 8), so the nodal
// vectors and the Np×Np / Na×Na systems live in registers through unrolled
// loops. f and f_u of a quadrature point come from one functor pair call
// (odes.cuh; one sincosf for sin u), as the TPU kernel co-issues them
// (dg_slab.py:131-138).
//
// The split. Every Newton step's assembly and the backward sweep's loop over
// the quadrature points: lane ℓ of the group takes q ≡ ℓ (mod G) in
// ascending order and accumulates its partial residual and its partial
// quadrature matrix (every entry, as the G = 1 loop does); the partials are
// joined by a fixed-order xor butterfly of warp shuffles (rounds m = 1, 2,
// …, G/2, each x += shfl_xor(x, m)), which adds the same two values in
// either lane, so every lane of the group ends with the same sums. Every
// lane then runs the O(N²) assembly and the solve itself on identical
// inputs: unrolled Cramer (cofactor expansion) for N ≤ 4, unrolled Gaussian
// elimination with partial pivoting by selects (no branches) for N = 5..8 —
// march/dg_batched.py solve_small's arithmetic (small_solve.cuh, shared
// with dg_slab_mixed.cu). Every lane computes the same selects, so the
// lanes stay equal without a broadcast and nothing diverges; at G = 1 the
// kernel sums in the order one thread a member summed. vᵀres, Na rows, is
// not split. Control flow depends only on the trip counts, so the warp
// reconverges at every shuffle; members past B run the last member's inputs
// and store nothing. The wrapper's plan (ops/cuda/dg_slab.py d1_plan) picks
// G and the CTA size.
//
// Tables. The quadrature loops run over a runtime count (n_gq is a caller's
// choice) and read the folded tables: Φ, w·Φ, w·Φ⊗Φ, (1+r_q)/2, Sᵀ, the
// mass row sums, and the primal→adjoint interpolation matrices (and for a
// goal other than J = ∫u the mass matrix and (1+r_i)/2), folded on
// the host in double and rounded to float32 (as the TPU kernel folds them
// into float32 immediates, dg_slab.py:96-117). They live on the device
// (the wrapper's plan holds them), and each CTA copies them once into
// shared memory: the G lanes of a member read different quadrature rows, G
// addresses a warp, which the constant cache serialises and shared memory
// serves at once (the row strides are odd, so the G rows fall in distinct
// banks). Read from __constant__ memory (copied there before each launch)
// the same launches took 1.02-1.15× as long at G = 1, 1.10-1.51× at G = 2
// and 1.14-2.99× at G = 4-32, the most at B = 102,400, on an NVIDIA H100
// 80GB HBM3 at 700 W (tools/torch_d1_kt2_against_parent.py; PERF.md).
//
// Times are float32; h = t[k+1] − t[k] is formed here, so a zero-width
// padding slab has h exactly 0. Shared times are read as (K+1,) (a
// broadcast), per-member times as (B, K+1), each member's row; lane 0 of a
// group writes the
// outputs (K, Np, B), (K, Na, B) and (K, B), viewed as (B, K, ·) by the
// wrapper. The forward states the backward sweep needs stay in shared
// memory, one copy a member as [element][node][member of the CTA], where
// they fit beside the tables in 48 KB; otherwise the sweep re-reads them
// from the u output after a __syncwarp (lane 0's writes).
//
// What bounds it on the H100: operations, and in practice latency. A
// member-element costs newton_iters × Nq_p quadrature points, each Np
// interpolation FMAs, one (f, f_u) pair (a sincosf for sin u) and Np + Np²
// accumulation FMAs, plus one Np×Np solve per Newton step, and the order
// n+1 sweep (Nq_a points of Np + Na + Na² FMAs and one Na×Na solve; a goal
// other than J = ∫u adds Na functor calls and Na² FMAs). The
// bytes are a read of y0 and the times and a write of u, v and err. Each
// member's work is one serial chain (Newton steps and elements depend on
// the previous ones): the split shortens its quadrature part G-fold at the
// cost of log2 G shuffle rounds of Np² + Np (Na² + Na) values, and puts G×
// more warps on the card (at B = 1024 one thread a member filled 8 CTAs of
// 128 threads on 132 SMs); the assembly and the solves stay serial.

#include <cuda_runtime.h>

#include <cmath>

#include "odes.cuh"
#include "small_solve.cuh"

namespace {

using namespace aoa;

constexpr int kDgMaxThreads = 256;
constexpr unsigned kFullWarp = 0xffffffffu;
constexpr int kMaxTables = 8192;      // floats of folded tables (32 KB of shared memory)
constexpr long kSmemCap = 48 * 1024;  // tables and forward states in shared memory up to this

// Offsets into the tables (floats); the layout is ops/cuda/dg_slab.py kernel_tables.
template <int NP>
struct Layout {
  static constexpr int NA = NP + 1;
  static constexpr int kQp = NP * NP;                    // forward quadrature rows
  static constexpr int kQpStride = NP + 1 + NP + NP * NP;  // φ, (1+r)/2, wφ, wφφ
  static constexpr int kQaStride = NP + 1 + NA + NA * NA;  // φ_p→q, (1+r)/2, wφ, wφφ
  static constexpr int kGoal = NA * NA + NA;               // M_a, (1+r_i)/2
  int base_a, st_a, msum_a, to_nodes, qa, mass_a, c_nodes;
  __device__ Layout(int nqp, int nqa) {
    base_a = kQp + nqp * kQpStride;
    st_a = base_a + NA * NA;
    msum_a = st_a + NA * NA;
    to_nodes = msum_a + NA;
    qa = to_nodes + NA * NP;
    mass_a = qa + nqa * kQaStride;  // goals other than J = ∫u only
    c_nodes = mass_a + NA * NA;
  }
};

// The group's sums of a partial vector and matrix: rounds m = 1, 2, …, g/2
// of x += shfl_xor(x, m), the same in every lane of the group.
template <int N>
__device__ __forceinline__ void group_sums(float (&r)[N], float (&a)[N][N], int g) {
  for (int m = 1; m < g; m <<= 1) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      r[i] += __shfl_xor_sync(kFullWarp, r[i], m);
#pragma unroll
      for (int j = 0; j < N; ++j) a[i][j] += __shfl_xor_sync(kFullWarp, a[i][j], m);
    }
  }
}

// D1 on G = g lanes a member, the n_tab floats of tables copied into shared
// memory by the CTA; member m's times at times + m·m_stride (0: shared);
// the goal's adjoint source g_u by Goal.
template <int NP, class Ode, class Goal>
__global__ void __launch_bounds__(kDgMaxThreads)
dg_estimate_kernel(int nb, int k_el, int newton_iters, int nqp, int nqa, int m_stride, int g,
                   int n_tab, int use_smem, const float* __restrict__ tables,
                   const float* __restrict__ times, const float* __restrict__ y0,
                   float* __restrict__ u_out, float* __restrict__ v_out,
                   float* __restrict__ err_out, OdeConsts kc) {
  constexpr int NA = NP + 1;
  extern __shared__ float smem[];  // [tables][element][node][member of the CTA]
  for (int i = threadIdx.x; i < n_tab; i += blockDim.x) smem[i] = tables[i];
  __syncthreads();
  const float* tab = smem;
  float* ustore = smem + n_tab;
  const int per_block = blockDim.x / g;
  if (blockIdx.x * per_block + (threadIdx.x & ~31) / g >= nb) return;  // the warp lies past B
  const int lane = threadIdx.x & (g - 1);
  const int slot = threadIdx.x / g;
  const int m_own = blockIdx.x * per_block + slot;
  const bool store = m_own < nb;
  const bool writes = store && lane == 0;
  const int m = store ? m_own : nb - 1;  // past B: the last member's inputs
  const Layout<NP> lay(nqp, nqa);
  const float* tm = times + static_cast<long>(m) * m_stride;
  const float y0m = y0[m];

  // ---- forward element march (dg_march.m:26-78)
  float u_prev = y0m;
  for (int k = 0; k < k_el; ++k) {
    const float tl = tm[k];
    const float h = tm[k + 1] - tl;
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
      for (int q = lane; q < nqp; q += g) {
        const float* row = tab + Layout<NP>::kQp + q * Layout<NP>::kQpStride;
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
      group_sums<NP>(res, jac, g);
#pragma unroll
      for (int i = 0; i < NP; ++i) {
        float acc = 0.f;
#pragma unroll
        for (int j = 0; j < NP; ++j) acc += tab[i * NP + j] * u[j];
        acc = acc + hh * res[i];
        res[i] = (i == 0) ? acc + u_prev : acc;
#pragma unroll
        for (int j = 0; j < NP; ++j) jac[i][j] = tab[i * NP + j] + hh * jac[i][j];
      }
      float delta[NP];
      solve<NP>(jac, res, delta);
#pragma unroll
      for (int i = 0; i < NP; ++i) u[i] = u[i] - delta[i];
    }
    if (lane == 0) {
#pragma unroll
      for (int i = 0; i < NP; ++i) {
        if (store) u_out[static_cast<long>(k * NP + i) * nb + m] = u[i];
        if (use_smem) ustore[(k * NP + i) * per_block + slot] = u[i];
      }
    }
    u_prev = u[NP - 1];
  }
  __syncwarp();  // lane 0's stored states, read by every lane of its group

  // ---- backward adjoint sweep + per-element AWR (adj_march.m:65-120)
  float v_in = 0.f;
  for (int k = k_el - 1; k >= 0; --k) {
    const float tl = tm[k];
    const float h = tm[k + 1] - tl;
    const float hh = h / 2.f;
    float ue[NP];
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      ue[i] = use_smem ? ustore[(k * NP + i) * per_block + slot]
                       : u_out[static_cast<long>(k * NP + i) * nb + m];
    }
    float up = y0m;
    if (k > 0) {
      const int idx = (k - 1) * NP + NP - 1;
      up = use_smem ? ustore[idx * per_block + slot] : u_out[static_cast<long>(idx) * nb + m];
    }
    float uh[NA];
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < NP; ++j) acc += tab[lay.to_nodes + i * NP + j] * ue[j];
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
    for (int q = lane; q < nqa; q += g) {
      const float* row = tab + lay.qa + q * Layout<NP>::kQaStride;
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
    group_sums<NA>(r, a, g);
    float gu[NA];  // g_u at the adjoint nodes (a goal other than J = ∫u)
    if constexpr (!Goal::kUnit) {
#pragma unroll
      for (int j = 0; j < NA; ++j) gu[j] = Goal::g_u(uh[j], tl + tab[lay.c_nodes + j] * h);
    }
    float rhs[NA];
#pragma unroll
    for (int i = 0; i < NA; ++i) {
#pragma unroll
      for (int j = 0; j < NA; ++j) a[i][j] = tab[lay.base_a + i * NA + j] + hh * a[i][j];
      if constexpr (Goal::kUnit) {
        rhs[i] = -hh * tab[lay.msum_a + i];
      } else {
        float acc = 0.f;
#pragma unroll
        for (int j = 0; j < NA; ++j) acc += tab[lay.mass_a + i * NA + j] * gu[j];
        rhs[i] = -hh * acc;
      }
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
      for (int j = 0; j < NA; ++j) acc += tab[lay.st_a + i * NA + j] * uh[j];
      acc = acc + hh * r[i];
      if (i == NA - 1) acc = acc - uh[NA - 1];
      if (i == 0) acc = acc + up;
      err = (i == 0) ? v[i] * acc : err + v[i] * acc;
    }
    if (writes) {
#pragma unroll
      for (int i = 0; i < NA; ++i) v_out[static_cast<long>(k * NA + i) * nb + m] = v[i];
      err_out[static_cast<long>(k) * nb + m] = err;
    }
    v_in = v[0];
  }
}

template <int NP>
constexpr int table_size(int nqp, int nqa, bool goal) {
  return NP * NP + nqp * Layout<NP>::kQpStride + 2 * (NP + 1) * (NP + 1) + (NP + 1) +
         (NP + 1) * NP + nqa * Layout<NP>::kQaStride + (goal ? Layout<NP>::kGoal : 0);
}

// One launch of ``lanes`` lanes a member on CTAs of ``threads``.
template <int NP, class Ode, class Goal>
int launch_dg(int nb, int k_el, int newton_iters, int nqp, int nqa, int per_member, int lanes,
              int threads, int n_tab, const float* tables, const float* times, const float* y0,
              float* u, float* v, float* err, const OdeConsts& kc, cudaStream_t stream) {
  const int per_block = threads / lanes;
  const long tab_bytes = static_cast<long>(n_tab) * sizeof(float);
  const long store_bytes = static_cast<long>(k_el) * NP * per_block * sizeof(float);
  const int use_smem = tab_bytes + store_bytes <= kSmemCap ? 1 : 0;
  const int blocks = (nb + per_block - 1) / per_block;
  dg_estimate_kernel<NP, Ode, Goal>
      <<<blocks, threads, tab_bytes + (use_smem ? store_bytes : 0), stream>>>(
          nb, k_el, newton_iters, nqp, nqa, per_member ? k_el + 1 : 0, lanes, n_tab, use_smem,
          tables, times, y0, u, v, err, kc);
  return static_cast<int>(cudaGetLastError());
}

template <class Ode, class Goal>
int launch_np(int np_p, int nb, int k_el, int newton_iters, int nqp, int nqa, int per_member,
              int lanes, int threads, int n_tab, const float* tables, const float* times,
              const float* y0, float* u, float* v, float* err, const OdeConsts& kc,
              cudaStream_t stream) {
#define AOA_DG_NP(N)                                                                        \
  case N:                                                                                   \
    return launch_dg<N, Ode, Goal>(nb, k_el, newton_iters, nqp, nqa, per_member, lanes, threads, \
                             n_tab, tables, times, y0, u, v, err, kc, stream);
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

int expected_tables(int np_p, int nqp, int nqa, bool goal) {
  switch (np_p) {
    case 1: return table_size<1>(nqp, nqa, goal);
    case 2: return table_size<2>(nqp, nqa, goal);
    case 3: return table_size<3>(nqp, nqa, goal);
    case 4: return table_size<4>(nqp, nqa, goal);
    case 5: return table_size<5>(nqp, nqa, goal);
    case 6: return table_size<6>(nqp, nqa, goal);
    case 7: return table_size<7>(nqp, nqa, goal);
    default: return -1;
  }
}

// The goal's instance: gu_id is the functional's kernel_id (odes.cuh).
template <class Ode>
int launch_goal(int gu_id, int np_p, int nb, int k_el, int newton_iters, int nqp, int nqa,
                int per_member, int lanes, int threads, int n_tab, const float* tables,
                const float* times, const float* y0, float* u, float* v, float* err,
                const OdeConsts& kc, cudaStream_t stream) {
#define AOA_GOAL(GOAL)                                                                      \
  launch_np<Ode, GOAL>(np_p, nb, k_el, newton_iters, nqp, nqa, per_member, lanes, threads, \
                       n_tab, tables, times, y0, u, v, err, kc, stream)
  AOA_GOAL_SWITCH(gu_id, AOA_GOAL)
#undef AOA_GOAL
}

}  // namespace

extern "C" {

// Return 0 on success, a cudaError_t code after a failed launch, -2 for an
// ODE id the kernel does not take (or trig="fast" on another ODE than
// sin(u)), -4 for Np outside 1..7, -5 when the tables exceed the kernel's
// shared-memory buffer, -6 when their length does not match (np_p, nqp,
// nqa, the goal), -8 for a launch plan the kernel does not take (lanes a
// power of two ≤ 32, threads a multiple of 32 ≤ 256), -9 for a goal id
// (gu_id, the functional's kernel_id) the kernel does not take. `tables` is
// a device pointer; per_member = 1: times is (B, K+1); 0: times is (K+1,).
int dg_estimate_ensemble(int ode_id, int fast_trig, int gu_id, int n_u, int n_t,
                         const float* consts,
                         const float* tables, int n_tables, int np_p, int nqp, int nqa, int nb,
                         int k_el, int newton_iters, int per_member, int lanes, int threads,
                         const float* times, const float* y0, float* u, float* v, float* err,
                         void* stream) {
  if (fast_trig && ode_id != 1) return -2;
  if (np_p < 1 || np_p > 7) return -4;
  if (n_tables > kMaxTables) return -5;
  const int goal = goal_tables(gu_id);
  if (goal < 0) return -9;
  if (n_tables != expected_tables(np_p, nqp, nqa, goal != 0)) return -6;
  if (lanes < 1 || lanes > 32 || (lanes & (lanes - 1)) != 0 || threads < 32 ||
      threads > kDgMaxThreads || threads % 32 != 0)
    return -8;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const OdeConsts kc = pack_consts(n_u, n_t, consts);
#define AOA_LAUNCH(ODE)                                                                   \
  launch_goal<ODE>(gu_id, np_p, nb, k_el, newton_iters, nqp, nqa, per_member, lanes,      \
                   threads, n_tables, tables, times, y0, u, v, err, kc, s)
  AOA_ODE_SCALAR_SWITCH(ode_id, fast_trig, AOA_LAUNCH)
#undef AOA_LAUNCH
}

const char* dg_slab_error_string(int code) {
  if (code == -2) return "ODE kernel_id (or trig) not implemented by this kernel";
  if (code == -4) return "primal Np outside 1..7";
  if (code == -5) return "folded tables exceed the kernel's shared-memory buffer (n_gq too large)";
  if (code == -6) return "folded table length does not match (Np, Nq_p, Nq_a)";
  if (code == -8) return "launch plan out of range (lanes 1..32 a power of two, threads 32..256 in warps)";
  if (code == -9) return "goal functional kernel_id not implemented by this kernel";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
