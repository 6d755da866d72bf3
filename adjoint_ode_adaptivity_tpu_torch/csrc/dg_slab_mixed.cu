// Hand-written Hopper (sm_90a) kernel of the per-member mixed-order (hp)
// DG-in-time estimate, bound to Python with ctypes (plain C interface).
//
// H1  dg_estimate_hp_per_member   replaces adjoint_ode_adaptivity_tpu/ops/
//                                 pallas/dg_slab_mixed.py:99 (_mixed_kernel,
//                                 pallas_call :556)
//
// Per member m, with its own partition t (K+1) and primal orders ns (K),
// exactly what the TPU kernel computes (march/dg_mixed.py and
// adjoint/dg_mixed.py semantics at a fixed Newton count):
//   coarse march at orders ns and fine march at ns + fine_offset: per element
//   k, from u_prev, newton_iters Newton steps on R(U) = A·U + h/2·Σ_q w_q φ_q
//   f(φ_q·U, t_q) + e_0 u_prev with A = Sᵀ − e_n e_nᵀ + pad_eye (order n,
//   padded to NP nodes; the padding identity keeps the padded unknowns 0),
//   then u_prev ← U[n] (the dynamic right endpoint);
//   backward sweep at order ns+1 (adjoint_mode "solve": (−Sᵀ − e_0 e_0ᵀ +
//   pad_eye + h/2·Σ_q w_q f_u φ_q φ_qᵀ) v = −h/2·M·g_u − e_{n+1} v_in) or the
//   low solve at order ns with the inflow at node n, lifted to n+1 by the
//   Radau tables (adjoint_mode "reconstruct"); then the order-(n+1) primal
//   residual of the interpolated coarse solution, res = Sᵀ u_h − e_{n+1}
//   u_h[n+1] + h/2·Σ_q w_q φ_q f + e_0 u_prev, and err_k = vᵀ res; the inflow
//   of element k−1 is v[0] (solve) or the low solution's v[0] (reconstruct).
// The goal J = ∫g(u, t) dt enters through g_u, a functor of odes.cuh chosen
// by the functional's kernel_id (a template parameter; a user library's
// traced goal, ops/cuda/functor.py, with kUnit false), as in dg_slab.cu:
// for J = ∫u the kernel reads M·1 as the folded row sums; for any other goal
// it evaluates g_u at the system's live nodes (the interpolated u_h at order
// n+1, or the coarse states at order n in "reconstruct") and 0 at the
// padding, as the TPU kernel's live mask does (dg_slab_mixed.py:379), and
// sums −h/2·Σ_j M_ij·g_u[j] in ascending j from the order's padded mass
// matrix. The mask matters wherever g_u(0) ≠ 0 or g_u is singular at 0
// (g_u = 1/u at the padding's zero nodes).
//
// Design for this card, not a copy of the TPU's: the TPU blends every
// order's table into per-member tiles with masks, since it cannot gather per
// lane. Here a group of G lanes (G ∈ {1, 2, 4, 8, 16, 32}, the G lanes of one
// member in one warp) runs one member and reads its own order's tables; NP
// (the stack's padded node count, 3..8) is a template parameter, so the
// nodal vectors and NP×NP systems live in registers through unrolled loops,
// and the dynamic node selections (right endpoint, inflow row, live mask)
// are compares inside those loops. The folded tables (ops/cuda/
// dg_slab_mixed.py kernel_tables, float64 folded and rounded to float32; 9
// KB at NP = 6, 22 KB at NP = 8) are copied once per CTA into shared
// memory: the G lanes of a member read the same address (a broadcast), and
// a warp reads at most 32/G distinct orders.
//
// The split. Every Newton step of both marches and the backward sweep's
// assembly loop over the Nq quadrature points: lane ℓ of the group takes
// q ≡ ℓ (mod G) in ascending order and accumulates its partial residual (NP
// values) and its partial quadrature matrix Σ_q w f_u φ_q φ_qᵀ (symmetric:
// the NP(NP+1)/2 entries on and above the diagonal, mirrored after the
// join). The partials are joined by a fixed-order xor butterfly of warp
// shuffles (rounds m = 1, 2, …, G/2, each x += shfl_xor(x, m)); a round
// adds the same two values in either lane, so every lane of the group ends
// with the same sum, bit-identical from run to run. Every lane then runs the
// O(NP²) assembly and the NP×NP solve itself on identical inputs, so the
// group's lanes stay equal without a broadcast. The solve is elimination
// without pivoting, each pivot's reciprocal taken once
// (small_solve.cuh solve_nopivot: the plain version's gauss_solve
// arithmetic; the padding identity keeps padded pivots 1). It replaced
// Cramer / pivoted elimination by selects, the per-thread solve H1 had
// (0.93 → 0.53 ms at B = 512 on an NVIDIA H100 80GB HBM3 at 700 W), and
// measured faster than one row a lane with the pivot rows broadcast by
// shuffles (0.69 ms: each pivot adds dependent shuffle latencies to the
// chain; PERF.md). The order-(n+1) residual vᵀres is split by rows (lane
// ℓ the rows i ≡ ℓ mod G) and joined by the same butterfly. Every lane of
// a group stores the same values to the same addresses (one store
// instruction a group), so a lane later reads its own coarse states back
// from the u_c output. Control flow depends only on the order's compares
// and the q loop's trip count, so the warp reconverges at every shuffle;
// members past B run the last member's inputs and store nothing.
//
// Layouts: times (K+1, B) and ns (K, B) int32; outputs u_c, u_f, v
// (K, NP, B) and err (K, B), transposed to (B, K, ·) by the wrapper.
//
// What bounds it on the H100: operations, and in practice latency. Every
// member-element costs two marches of newton_iters × Nq quadrature points
// (NP interpolation FMAs, one (f, f_u) pair, NP + NP(NP+1)/2 accumulation
// FMAs) and one NP×NP solve per step, then the backward sweep; padding to
// NP makes a low-order member do the work of the highest order. Each
// member's elements and Newton steps form one serial chain: the split
// shortens the quadrature part of each step G-fold at the cost of log2 G
// shuffle rounds, and puts G× more warps on the card (at B = 512 and
// G = 32, 512 warps instead of 16); the solve and the assembly stay
// serial, and with 1-8 warps an SM every step waits on its dependencies.
// The wrapper's plan (ops/cuda/dg_slab_mixed.py hp_plan) picks G and the
// CTA size from times measured on the card.

#include <cuda_runtime.h>

#include <cmath>

#include "odes.cuh"
#include "small_solve.cuh"

namespace {

using namespace aoa;

constexpr int kHpMaxThreads = 256;
constexpr unsigned kFullWarp = 0xffffffffu;
constexpr int kMaxHpTables = 12 * 1024;  // floats: 48 KB of dynamic shared memory

// Offsets into the folded tables (floats); the layout is
// ops/cuda/dg_slab_mixed.py kernel_tables: w_q (Q), (1 + r_q)/2 (Q), then
// per stack order s (order s+1): A_fwd, A_adj, Sᵀ (NP² each), mass row sums
// (NP), Φ (Q×NP); then per primal order p (order p+1): to_nodes, eval_rad,
// to_hi (NP² each), to_quad (Q×NP); then, for a goal other than J = ∫u, per
// stack order s: the padded mass matrix (NP²) and (1 + r_i)/2 (NP).
template <int NP>
struct HpLayout {
  int nq, stack_stride, prim_stride, prim0, goal0;
  __device__ HpLayout(int nq_, int n_stack) : nq(nq_) {
    stack_stride = 3 * NP * NP + NP + nq * NP;
    prim_stride = 3 * NP * NP + nq * NP;
    prim0 = 2 * nq + n_stack * stack_stride;
    goal0 = prim0 + (n_stack - 1) * prim_stride;
  }
  __device__ int a_fwd(int s) const { return 2 * nq + s * stack_stride; }
  __device__ int a_adj(int s) const { return a_fwd(s) + NP * NP; }
  __device__ int s_t(int s) const { return a_fwd(s) + 2 * NP * NP; }
  __device__ int msum(int s) const { return a_fwd(s) + 3 * NP * NP; }
  __device__ int phi(int s) const { return msum(s) + NP; }
  __device__ int to_nodes(int p) const { return prim0 + p * prim_stride; }
  __device__ int eval_rad(int p) const { return to_nodes(p) + NP * NP; }
  __device__ int to_hi(int p) const { return to_nodes(p) + 2 * NP * NP; }
  __device__ int to_quad(int p) const { return to_nodes(p) + 3 * NP * NP; }
  __device__ int mass(int s) const { return goal0 + s * (NP * NP + NP); }
  __device__ int c_nodes(int s) const { return mass(s) + NP * NP; }
};

int table_size(int np_max, int nq, int n_stack, bool goal) {
  return 2 * nq + n_stack * (3 * np_max * np_max + np_max + nq * np_max) +
         (n_stack - 1) * (3 * np_max * np_max + nq * np_max) +
         (goal ? n_stack * (np_max * np_max + np_max) : 0);
}

// The group's sum of x: rounds m = 1, 2, …, g/2 of x += shfl_xor(x, m),
// the same in every lane of the group (each round adds the same two values).
__device__ __forceinline__ float group_sum(float x, int g) {
  for (int m = 1; m < g; m <<= 1) x += __shfl_xor_sync(kFullWarp, x, m);
  return x;
}

// The quadrature partials of one Newton step or adjoint assembly: lane
// `lane` of a group of g takes q ≡ lane (mod g); with phi_r the residual's
// rows and phi_m the matrix's, res[i] += phi_r[q][i]·(w_q f_q) and
// mat[i][j] += (w_q f_u,q·phi_m[q][i])·phi_m[q][j] for j ≥ i; then the
// butterfly over the group and the lower triangle mirrored.
template <int NP, class Ode>
__device__ __forceinline__ void quad_sums(const float* tab, int nq, int lane, int g,
                                          const float* interp, const float* ue,
                                          const float* phi_r, const float* phi_m,
                                          float tl, float h, const OdeConsts& kc,
                                          float (&res)[NP], float (&mat)[NP][NP]) {
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    res[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NP; ++j) mat[i][j] = 0.f;
  }
  for (int q = lane; q < nq; q += g) {
    const float* iq = interp + q * NP;
    float uq = 0.f;
#pragma unroll
    for (int j = 0; j < NP; ++j) uq += iq[j] * ue[j];
    float fq, fuq;
    Ode::pair(uq, tl + tab[nq + q] * h, kc, &fq, &fuq);
    const float wf = tab[q] * fq;
    const float wfu = tab[q] * fuq;
    const float* pr = phi_r + q * NP;
    const float* pm = phi_m + q * NP;
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      res[i] += pr[i] * wf;
      const float d = wfu * pm[i];
#pragma unroll
      for (int j = i; j < NP; ++j) mat[i][j] += d * pm[j];
    }
  }
  for (int m = 1; m < g; m <<= 1) {
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      res[i] += __shfl_xor_sync(kFullWarp, res[i], m);
#pragma unroll
      for (int j = i; j < NP; ++j) mat[i][j] += __shfl_xor_sync(kFullWarp, mat[i][j], m);
    }
  }
#pragma unroll
  for (int i = 1; i < NP; ++i) {
#pragma unroll
    for (int j = 0; j < i; ++j) mat[i][j] = mat[j][i];
  }
}

// One forward march of member m at orders ns + offset (coarse: 0, fine:
// fine_offset), writing (K, NP, B) nodal values to `out` (every lane of the
// group the same values; none when !store).
template <int NP, class Ode>
__device__ void march(const float* tab, const HpLayout<NP>& lay, int m, int nb, int k_el,
                      int newton_iters, int offset, const float* __restrict__ times,
                      const int* __restrict__ ns, float y0m, float* __restrict__ out,
                      bool store, int lane, int g, const OdeConsts& kc) {
  float u_prev = y0m;
  for (int k = 0; k < k_el; ++k) {
    const float tl = times[static_cast<long>(k) * nb + m];
    const float h = times[static_cast<long>(k + 1) * nb + m] - tl;
    const float hh = h / 2.f;
    const int top = ns[static_cast<long>(k) * nb + m] + offset;  // live nodes 0..top
    const float* a_tab = tab + lay.a_fwd(top - 1);
    const float* phi = tab + lay.phi(top - 1);
    float u[NP];
#pragma unroll
    for (int i = 0; i < NP; ++i) u[i] = (i <= top) ? u_prev : 0.f;
    for (int it = 0; it < newton_iters; ++it) {
      float res[NP];
      float jac[NP][NP];
      quad_sums<NP, Ode>(tab, lay.nq, lane, g, phi, u, phi, phi, tl, h, kc, res, jac);
#pragma unroll
      for (int i = 0; i < NP; ++i) {
        float acc = 0.f;
#pragma unroll
        for (int j = 0; j < NP; ++j) acc += a_tab[i * NP + j] * u[j];
        acc = acc + hh * res[i];
        res[i] = (i == 0) ? acc + u_prev : acc;
#pragma unroll
        for (int j = 0; j < NP; ++j) jac[i][j] = a_tab[i * NP + j] + hh * jac[i][j];
      }
      float delta[NP];
      solve_nopivot<NP>(jac, res, delta);
#pragma unroll
      for (int i = 0; i < NP; ++i) u[i] = u[i] - delta[i];
    }
    float u_end = u[0];
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      if (store) out[static_cast<long>(k * NP + i) * nb + m] = u[i];
      u_end = (i == top) ? u[i] : u_end;
    }
    u_prev = u_end;
  }
}

template <int NP, class Ode, class Goal>
__global__ void __launch_bounds__(kHpMaxThreads)
hp_kernel(int nb, int k_el, int newton_iters, int nq, int n_stack, int fine_offset,
          int reconstruct, int g, int n_tables, const float* __restrict__ tables,
          const float* __restrict__ times, const int* __restrict__ ns,
          const float* __restrict__ y0, float* __restrict__ uc, float* __restrict__ uf,
          float* __restrict__ v_out, float* __restrict__ err_out, OdeConsts kc) {
  extern __shared__ float tab[];
  for (int i = threadIdx.x; i < n_tables; i += blockDim.x) tab[i] = tables[i];
  __syncthreads();
  const int per_block = blockDim.x / g;
  const int first_of_warp = blockIdx.x * per_block + (threadIdx.x & ~31) / g;
  if (first_of_warp >= nb) return;  // the whole warp lies past B
  const int lane = threadIdx.x % g;
  const int m_own = blockIdx.x * per_block + threadIdx.x / g;
  const bool store = m_own < nb;
  const int m = store ? m_own : nb - 1;  // past B: the last member's inputs
  const HpLayout<NP> lay(nq, n_stack);
  const float y0m = y0[m];

  // every lane of a group reads back the coarse states it stored; a group
  // past B stores nothing, reads the last member's, and its results drop
  march<NP, Ode>(tab, lay, m, nb, k_el, newton_iters, 0, times, ns, y0m, uc, store, lane, g, kc);
  march<NP, Ode>(tab, lay, m, nb, k_el, newton_iters, fine_offset, times, ns, y0m, uf, store,
                 lane, g, kc);

  // ---- backward sweep at order ns+1 (solved or reconstructed) + AWR
  float v_in = 0.f;
  for (int k = k_el - 1; k >= 0; --k) {
    const float tl = times[static_cast<long>(k) * nb + m];
    const float h = times[static_cast<long>(k + 1) * nb + m] - tl;
    const float hh = h / 2.f;
    const int n = ns[static_cast<long>(k) * nb + m];  // primal order
    float ue[NP];
#pragma unroll
    for (int i = 0; i < NP; ++i) ue[i] = uc[static_cast<long>(k * NP + i) * nb + m];
    float up = y0m;
    if (k > 0) {
      const int n_prev = ns[static_cast<long>(k - 1) * nb + m];
      up = uc[static_cast<long>((k - 1) * NP + n_prev) * nb + m];
    }
    const float* to_n = tab + lay.to_nodes(n - 1);
    const float* to_q = tab + lay.to_quad(n - 1);
    const float* phi_a = tab + lay.phi(n);  // order n+1
    // the system's order: n+1 (solve) or n (the low solve of reconstruct)
    const int s_sys = reconstruct ? n - 1 : n;
    const int e_in = s_sys + 1;  // its right-endpoint node
    const float* phi_s = tab + lay.phi(s_sys);
    float uh[NP];
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < NP; ++j) acc += to_n[i * NP + j] * ue[j];
      uh[i] = acc;
    }
    float ra[NP];
    float a[NP][NP];
    quad_sums<NP, Ode>(tab, nq, lane, g, to_q, ue, phi_a, phi_s, tl, h, kc, ra, a);
    const float* a_tab = tab + lay.a_adj(s_sys);
    const float* msum = tab + lay.msum(s_sys);
    float gu[NP];  // g_u at the system's live nodes, 0 at the padding
    if constexpr (!Goal::kUnit) {
      const float* c_n = tab + lay.c_nodes(s_sys);
#pragma unroll
      for (int j = 0; j < NP; ++j) {
        const float x = reconstruct ? ue[j] : uh[j];
        gu[j] = (j <= e_in) ? Goal::g_u(x, tl + c_n[j] * h) : 0.f;
      }
    }
    float rhs[NP];
#pragma unroll
    for (int i = 0; i < NP; ++i) {
#pragma unroll
      for (int j = 0; j < NP; ++j) a[i][j] = a_tab[i * NP + j] + hh * a[i][j];
      float r;
      if constexpr (Goal::kUnit) {
        r = -hh * msum[i];
      } else {
        const float* m_row = tab + lay.mass(s_sys) + i * NP;
        float acc = 0.f;
#pragma unroll
        for (int j = 0; j < NP; ++j) acc += m_row[j] * gu[j];
        r = -hh * acc;
      }
      rhs[i] = (i == e_in) ? r - v_in : r;
    }
    float w[NP];
    solve_nopivot<NP>(a, rhs, w);
    const float carry = w[0];
    float v[NP];
    if (reconstruct) {
      // Radau lift to order n+1 (adj_rec.m:34-47): the low solution at the
      // n+1 Radau points, the known right-endpoint inflow at node n+1
      const float* er = tab + lay.eval_rad(n - 1);
      const float* th = tab + lay.to_hi(n - 1);
      float vals[NP];
#pragma unroll
      for (int j = 0; j < NP; ++j) {
        float acc = 0.f;
#pragma unroll
        for (int l = 0; l < NP; ++l) acc += er[j * NP + l] * w[l];
        vals[j] = (j == n + 1) ? acc + v_in : acc;
      }
#pragma unroll
      for (int i = 0; i < NP; ++i) {
        float acc = 0.f;
#pragma unroll
        for (int j = 0; j < NP; ++j) acc += th[i * NP + j] * vals[j];
        v[i] = acc;
      }
    } else {
#pragma unroll
      for (int i = 0; i < NP; ++i) v[i] = w[i];
    }
    // the primal residual at order n+1, weighted by v: lane ℓ takes the rows
    // i ≡ ℓ (mod g), then the butterfly
    const float* st = tab + lay.s_t(n);
    float uh_end = uh[0];
#pragma unroll
    for (int i = 0; i < NP; ++i) uh_end = (i == n + 1) ? uh[i] : uh_end;
    float err = 0.f;
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      if (i % g == lane) {
        float acc = 0.f;
#pragma unroll
        for (int j = 0; j < NP; ++j) acc += st[i * NP + j] * uh[j];
        acc = acc + hh * ra[i];
        if (i == 0) acc = acc + up;
        acc = (i == n + 1) ? acc - uh_end : acc;
        err += v[i] * acc;
      }
      if (store) v_out[static_cast<long>(k * NP + i) * nb + m] = v[i];
    }
    err = group_sum(err, g);
    if (store) err_out[static_cast<long>(k) * nb + m] = err;
    v_in = carry;
  }
}

template <int NP, class Ode, class Goal>
int launch_hp(int nb, int k_el, int newton_iters, int nq, int n_stack, int fine_offset,
              int reconstruct, int lanes, int threads, int n_tables, const float* tables,
              const float* times, const int* ns, const float* y0, float* uc, float* uf,
              float* v, float* err, const OdeConsts& kc, cudaStream_t stream) {
  const int per_block = threads / lanes;
  const int blocks = (nb + per_block - 1) / per_block;
  const size_t smem = static_cast<size_t>(n_tables) * sizeof(float);
  hp_kernel<NP, Ode, Goal><<<blocks, threads, smem, stream>>>(
      nb, k_el, newton_iters, nq, n_stack, fine_offset, reconstruct, lanes, n_tables, tables,
      times, ns, y0, uc, uf, v, err, kc);
  return static_cast<int>(cudaGetLastError());
}

template <class Ode, class Goal>
int launch_np(int np_max, int nb, int k_el, int newton_iters, int nq, int n_stack,
              int fine_offset, int reconstruct, int lanes, int threads, int n_tables,
              const float* tables, const float* times, const int* ns, const float* y0,
              float* uc, float* uf, float* v, float* err, const OdeConsts& kc,
              cudaStream_t stream) {
#define AOA_HP_NP(N)                                                                         \
  case N:                                                                                    \
    return launch_hp<N, Ode, Goal>(nb, k_el, newton_iters, nq, n_stack, fine_offset, reconstruct, \
                             lanes, threads, n_tables, tables, times, ns, y0, uc, uf, v, err, \
                             kc, stream);
  switch (np_max) {
    AOA_HP_NP(3)
    AOA_HP_NP(4)
    AOA_HP_NP(5)
    AOA_HP_NP(6)
    AOA_HP_NP(7)
    AOA_HP_NP(8)
    default:
      return -4;
  }
#undef AOA_HP_NP
}

// The goal's instance: gu_id is the functional's kernel_id (odes.cuh).
template <class Ode>
int launch_goal(int gu_id, int np_max, int nb, int k_el, int newton_iters, int nq, int n_stack,
                int fine_offset, int reconstruct, int lanes, int threads, int n_tables,
                const float* tables, const float* times, const int* ns, const float* y0,
                float* uc, float* uf, float* v, float* err, const OdeConsts& kc,
                cudaStream_t stream) {
#define AOA_HP_GOAL(GOAL)                                                                    \
  launch_np<Ode, GOAL>(np_max, nb, k_el, newton_iters, nq, n_stack, fine_offset, reconstruct, \
                       lanes, threads, n_tables, tables, times, ns, y0, uc, uf, v, err, kc,  \
                       stream)
  AOA_GOAL_SWITCH(gu_id, AOA_HP_GOAL)
#undef AOA_HP_GOAL
}

}  // namespace

extern "C" {

// Return 0 on success, a cudaError_t code after a failed launch, -2 for an
// ODE id the kernel does not take, -4 for np_max outside 3..8, -5 when the
// tables exceed the kernel's shared-memory buffer, -6 when their length does
// not match (np_max, nq, n_stack, the goal), -7 for a stack that is not
// np_max − 1 orders deep or an offset outside 1..n_stack − 1, -8 for a
// launch plan the kernel does not take (lanes a power of two ≤ 32, threads
// a multiple of 32 ≤ 256), -9 for a goal id (gu_id, the functional's
// kernel_id) the kernel does not take. `tables` is a device pointer; times
// is (K+1, B), ns (K, B) int32, the outputs (K, np_max, B) and err (K, B).
int dg_estimate_hp_per_member(int ode_id, int gu_id, int n_u, int n_t, const float* consts,
                              const float* tables, int n_tables, int np_max, int nq,
                              int n_stack, int fine_offset, int reconstruct, int lanes,
                              int threads, int nb, int k_el, int newton_iters,
                              const float* times, const int* ns, const float* y0, float* uc,
                              float* uf, float* v, float* err, void* stream) {
  if (np_max < 3 || np_max > 8) return -4;
  if (n_stack != np_max - 1 || fine_offset < 1 || fine_offset >= n_stack) return -7;
  const int goal = goal_tables(gu_id);
  if (goal < 0) return -9;
  if (n_tables != table_size(np_max, nq, n_stack, goal != 0)) return -6;
  if (n_tables > kMaxHpTables) return -5;
  if (lanes < 1 || lanes > 32 || (lanes & (lanes - 1)) != 0 || threads < 32 ||
      threads > kHpMaxThreads || threads % 32 != 0)
    return -8;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const OdeConsts kc = pack_consts(n_u, n_t, consts);
#define AOA_HP_LAUNCH(ODE)                                                                   \
  launch_goal<ODE>(gu_id, np_max, nb, k_el, newton_iters, nq, n_stack, fine_offset,         \
                   reconstruct, lanes, threads, n_tables, tables, times, ns, y0, uc, uf, v, \
                   err, kc, s)
  AOA_ODE_LIBM_SWITCH(ode_id, AOA_HP_LAUNCH)
#undef AOA_HP_LAUNCH
}

const char* dg_slab_mixed_error_string(int code) {
  if (code == -2) return "ODE kernel_id not implemented by this kernel";
  if (code == -4) return "np_max outside 3..8";
  if (code == -5) return "folded tables exceed the kernel's shared-memory buffer (n_gq too large)";
  if (code == -6) return "folded table length does not match (np_max, nq, n_stack)";
  if (code == -7) return "stack depth or fine_offset out of range";
  if (code == -8) return "launch plan out of range (lanes 1..32 a power of two, threads 32..256 in warps)";
  if (code == -9) return "goal functional kernel_id not implemented by this kernel";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
