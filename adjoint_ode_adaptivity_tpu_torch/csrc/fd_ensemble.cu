// Hand-written Hopper (sm_90a) kernels of the FD refinement signal, bound to
// Python with ctypes (plain C interface).
//
// F1  fd_ensemble            replaces adjoint_ode_adaptivity_tpu/ops/pallas/
//                            fd_ensemble.py:61 (_kernel, pallas_call :177)
// F2  fd_ensemble_vec        replaces fd_ensemble.py:201 (_vec_kernel, :338)
// F3  fd_estimate_per_member replaces fd_ensemble.py:357 (_pm_kernel, :502)
// The polynomial sin/cos of ops/pallas/fast_trig.py:62-77 is the FastTrig
// policy of odes.cuh (F1 with trig="fast").
//
// The pipeline of one IC or member is independent of every other:
//   coarse forward-Euler march u_{n+1} = u_n + f(u_n, t_n)·dt_n, the
//   n_steps+1 coarse states kept in shared memory;
//   a reverse sweep over the rf-refined grid j = n_fine .. 1 that
//   interpolates u_j, updates the adjoint of J = ∫u² dt,
//   v_j = k_j + (1 + f_u(u_j)·dt_f)·v_{j+1} with k_j = 2·u_j·dt_f, forms the
//   residual r_j = u_j − (u_{j−1} + f(u_{j−1})·dt_f), and accumulates r·v
//   per coarse step; a step's indicator is stored once its block is complete.
// Only v's chain and the per-step sums are serial: the interpolation, the
// (f, f_u) pair and the residual of every fine node depend on the coarse
// trajectory alone. So every kernel runs G lanes of a warp per IC or member
// (below): the lanes split the fine nodes' interpolation, pairs and
// residuals ahead of the chain (F1 and F2 a block of nodes in registers,
// read across the group by shuffles; F3, and F2 where a node's table passes
// the registers, a window in shared-memory tables), and the chain runs over
// them. f and f_u (F2: f and the Jacobian) of one
// fine node are evaluated once, as a pair (the TPU kernel's _pair_cache).
//
// The ODE is a compile-time functor of odes.cuh (one struct per registry
// entry, chosen by kernel_id in the dispatch at the bottom; in a user
// library, ops/cuda/functor.py's traced functor alone, F2's of any D); the
// gaussian mixture's constants and the fast-trig coefficients travel by
// value in OdeConsts.
//
// Time grids. F1/F2: the coarse and fine node times and widths are folded on
// the host in double (as the TPU kernel folds them at trace time) and read
// as float32 from `grid` = [tc (n_steps), dts (n_steps), tf (n_fine),
// dtf (n_fine), wq (rf)], tf[j] and dtf[j] the time and width of fine node
// j, wq[q] = q/rf the interpolation weight of a node q past a coarse one
// (read through L1: every IC reads the same table). F3: the per-member widths
// arrive as (B, n_steps), a member's row contiguous for its lanes; tc
// accumulates in float32 inside the kernel and dt_f = dts·(1/rf), as in the
// TPU kernel.
//
// What bounds them on the H100: neither bytes nor FP32 operations. An IC
// moves 4·(1 + n_steps) bytes of device memory and does ~16 operations per
// fine node plus two libm transcendentals (sincosf, ~30 instructions), so at
// 102,400 ICs, 16 steps and rf 4 the byte bound is ~2 µs; the kernels issue
// tens of instructions a fine node and wait on each IC's serial chains (the
// coarse march; v_j depends on v_{j+1}). With G lanes (ops/cuda/
// fd_ensemble.py fd_ens_plan for F1 and F2, fd_pm_plan for F3) the serial
// part left per IC is the coarse march (n_steps serial sinf, run alike by
// every lane of the group) and ~3 dependent operations a fine node in the
// chain (F2: ~3·D); the pairs of a block of nodes are all in flight before
// the chain reads them. Every lane past the first repeats the march and
// waits beside the chain, so the plans give G only where the card would
// otherwise hold few warps: F1 and F2 the fewest lanes that put 8 warps on
// every SM (one lane an IC at 102,400 ICs, 16 at 4,096), F3 one warp a
// member up to B = 4096; F2's window design G >= D lanes, lane a owning v[a]
// (the chain ~3 dependent operations and D shuffles a fine node). Shared
// memory: F1 and F2 4·ens_stride(n_steps, D) bytes an IC and the rf weights
// (8.7 KB a 128-thread CTA at 16 steps and d = 1, 17.9 KB at d = 2), F2's
// window design 4·(W + 1)·vec_row() more (9.2 KB an IC at d = 15 dense,
// W = 8); F3 4·(3·n_steps + 2 + 3·window) bytes a member (2.6 KB at 43
// steps, rf 4, one window).

#include <cuda_runtime.h>

#include <cmath>
#include <type_traits>
#include <utility>

#include "odes.cuh"

namespace {

using namespace aoa;

constexpr int kMaxSmem = 232448;  // bytes a block may use on sm_90

// u at fine node j from the coarse trajectory traj[(state)·bs + tx]
__device__ __forceinline__ float u_fine(const float* traj, int bs, int tx, int j, int rf) {
  const int i = j / rf;
  const int q = j - i * rf;
  const float lo = traj[i * bs + tx];
  if (q == 0) return lo;
  const float w = static_cast<float>(q) / static_cast<float>(rf);
  return lo + w * (traj[(i + 1) * bs + tx] - lo);
}

// F1's and F2's floats of shared memory an IC: the d components' coarse
// trajectories, rounded up to odd so that the ICs of a warp (one lane each
// at G = 1) sit on distinct banks.
__host__ __device__ inline long ens_stride(int n_steps, int d = 1) {
  return (static_cast<long>(d) * (n_steps + 1)) | 1;
}

// F1's nodes a lane computes ahead of the chain, in registers (U).
constexpr int kEnsAhead = 4;

// F2's register design holds U nodes' r, A and h·J a lane, U = 4 at d <= 4
// and 1 above; its instances are compiled where a node's table, 2D + nnz
// floats (nnz: the live Jacobian entries), is at most kVecRegRow, the
// largest that held with no spill on an H100 (tools/torch_f2_designs.py:
// Lorenz-96 to d = 8 and the dense system to d = 6 at U = 1, 107-167
// registers; the dense d = 8, 80 floats, spills). Larger tables run the
// window design (ops/cuda/fd_ensemble.py f2_plan).
constexpr int kVecRegRow = 48;
__host__ __device__ constexpr int vec_ahead(int d) { return d <= 4 ? kEnsAhead : 1; }

// A compile-time loop: f(std::integral_constant<int, I>{}) for I in [0, N),
// in order (a fold, not a recursion: N runs to 225).
template <class F, int... I>
__device__ __forceinline__ void static_for_each(F& f, std::integer_sequence<int, I...>) {
  (f(std::integral_constant<int, I>{}), ...);
}
template <int N, class F>
__device__ __forceinline__ void static_for(F&& f) {
  static_for_each(f, std::make_integer_sequence<int, N>{});
}

// The compact layout of a vector functor's h·J: its Ode::nonzero entries,
// row-major (m, then i), one slot each; structurally zero ones have none.
template <class Ode>
__host__ __device__ constexpr int jac_slot(int e) {  // live entries before e = m·D + i
  int c = 0;
  for (int k = 0; k < e; ++k) c += Ode::nonzero(k / Ode::D, k % Ode::D) ? 1 : 0;
  return c;
}
template <class Ode>
__host__ __device__ constexpr unsigned jac_row_mask(int m) {  // bit i: entry (m, i) live
  unsigned r = 0;
  for (int i = 0; i < Ode::D; ++i) r |= Ode::nonzero(m, i) ? 1u << i : 0u;
  return r;
}
// A node's table: r (D), A (D), h·J (its live entries); a window row holds
// it rounded up to odd, so that the lanes writing neighbouring rows hit
// distinct banks.
template <class Ode>
__host__ __device__ constexpr int vec_table() {
  return 2 * Ode::D + jac_slot<Ode>(Ode::D * Ode::D);
}
template <class Ode>
__host__ __device__ constexpr int vec_row() {
  return vec_table<Ode>() | 1;
}

// F1: the scalar ensemble signal, block convention; err is (n_steps, n).
// G lanes of one warp serve an IC (G | 32, so a group never straddles a
// warp); a CTA of T threads serves T/G ICs. Shared memory holds the CTA's
// copy of the interpolation weights q/rf (the host's fold, as the plain
// version's) and each IC's coarse trajectory (ens_stride floats).
//   1. Every lane runs the coarse march serially and alike, in the plain
//      version's order, with the host-folded times and widths; lane
//      (s mod G) stores state s.
//   2. The fine nodes are swept in blocks of U·G from the top, (top − U·G,
//      top]. Lane l computes the nodes n = top − 1 − (u·G + l), u < U, into
//      registers: u_n by interpolation, (f, f_u) at (u_n, tf_n) once, then
//      r_{n+1} = u_{n+1} − (u_n + f_n·dtf_n) and the chain's coefficients
//      A_n = 2·u_n·dtf_n and C_n = 1 + f_u(u_n)·dtf_n. The U·G pairs of a
//      block are all in flight before the chain reads them (U independent
//      pairs a lane at G = 1).
//   3. Every lane of the group runs the chain over the block, reading the
//      node it needs from the lane that computed it (__shfl_sync within the
//      group; the node at the block's top was computed as the block above's
//      last): v_j = A_j + C_j·v_{j+1} and the per-step sums of r_j·v_j for
//      j = top … top − U·G + 1, the plain version's order, lane 0 storing
//      each step's |sum| once its block is complete (a countdown over the
//      block's nodes): err (n_steps, n), the lane-0 of neighbouring groups on
//      neighbouring addresses.
// Every lane takes the same trips through every loop (the blocks and the
// chain run to the same bounds for every IC), so the shuffles see full warps.
template <class Ode>
__global__ void __launch_bounds__(256, 1)
fd_ensemble_kernel(int n, int n_steps, int rf, int lanes, const float* __restrict__ grid,
                   const float* __restrict__ u0, float* __restrict__ err, OdeConsts k) {
  constexpr unsigned kFull = 0xffffffffu;
  constexpr int U = kEnsAhead;
  extern __shared__ float smem[];
  const int slot = threadIdx.x / lanes;
  const int lane = threadIdx.x - slot * lanes;
  const long ic = static_cast<long>(blockIdx.x) * (blockDim.x / lanes) + slot;
  const bool live = ic < n;
  const int n_fine = n_steps * rf;
  const float* tc = grid;
  const float* dts = grid + n_steps;
  const float* tf = dts + n_steps;
  const float* dtf = tf + n_fine;
  float* wq = smem;  // wq[q] = q/rf
  for (int q = threadIdx.x; q < rf; q += blockDim.x) wq[q] = dtf[n_fine + q];
  __syncthreads();
  float* traj = smem + rf + static_cast<long>(slot) * ens_stride(n_steps);

  float u = live ? u0[ic] : 0.f;
  if (lane == 0) traj[0] = u;
  for (int s = 0; s < n_steps; ++s) {
    u = u + Ode::f(u, tc[s], k) * dts[s];
    if (lane == ((s + 1) & (lanes - 1))) traj[s + 1] = u;
  }
  __syncwarp();

  // the lane's node nn = i·rf + q, stepped down by G nodes (di steps + dq)
  const int di = lanes / rf;
  const int dq = lanes - di * rf;
  int nn = n_fine - 1 - lane;
  int i = nn >= 0 ? nn / rf : -1;
  int q = nn >= 0 ? nn - i * rf : 0;
  float v = 0.f;  // v_{n_fine} = k_{n_fine} = 0 (J sums u[:-1])
  float blk = 0.f;
  float a_top = 0.f, c_top = 1.f;  // A, C of the block's top node (none at n_fine)
  int step = n_steps - 1, left = rf - 1;  // chain node j − 1 = step·rf + left
  for (int top = n_fine; top > 0; top -= U * lanes) {
    float rr[U], aa[U], cc[U];
#pragma unroll
    for (int b = 0; b < U; ++b) {
      // below node 0 (the last block's spare slots) node 0 is computed and
      // dropped, so the U pairs run without a branch of their own
      const bool real = nn >= 0;
      const int n_b = real ? nn : 0, i_b = real ? i : 0, q_b = real ? q : 0;
      const float lo = traj[i_b];
      const float hi = traj[i_b + 1];
      const float u_n = q_b == 0 ? lo : lo + wq[q_b] * (hi - lo);  // u_fine's expression
      const float u_n1 = q_b + 1 == rf ? hi : lo + wq[q_b + 1] * (hi - lo);
      const float h = dtf[n_b];
      float f_n, fu_n;
      Ode::pair(u_n, tf[n_b], k, &f_n, &fu_n);
      rr[b] = real ? u_n1 - (u_n + f_n * h) : 0.f;
      aa[b] = real ? 2.f * u_n * h : 0.f;
      cc[b] = real ? 1.f + fu_n * h : 1.f;
      nn -= lanes;
      i -= di;
      q -= dq;
      if (q < 0) {
        q += rf;
        --i;
      }
    }
#pragma unroll
    for (int b = 0; b < U; ++b) {
      for (int l = 0; l < lanes; ++l) {
        const int j = top - (b * lanes + l);
        if (j <= 0) break;
        const float r_j = __shfl_sync(kFull, rr[b], l, lanes);  // node j − 1
        float a_j = a_top, c_j = c_top;                           // node j
        if (l > 0) {
          a_j = __shfl_sync(kFull, aa[b], l - 1, lanes);
          c_j = __shfl_sync(kFull, cc[b], l - 1, lanes);
        } else if (b > 0) {
          a_j = __shfl_sync(kFull, aa[b - 1], lanes - 1, lanes);
          c_j = __shfl_sync(kFull, cc[b - 1], lanes - 1, lanes);
        }
        if (j < n_fine) v = a_j + c_j * v;
        blk += r_j * v;
        if (left == 0) {  // block `step` covers fine nodes step·rf+1 .. (step+1)·rf
          if (live && lane == 0) err[static_cast<long>(step) * n + ic] = fabsf(blk);
          blk = 0.f;
          left = rf;
          --step;
        }
        --left;
      }
    }
    a_top = __shfl_sync(kFull, aa[U - 1], lanes - 1, lanes);  // node top − U·G
    c_top = __shfl_sync(kFull, cc[U - 1], lanes - 1, lanes);
  }
}

// F2: F1 for d-vector states; u0 is (n, D), IC-major, err (n_steps, n).
// G lanes of one warp serve an IC, a CTA of T threads T/G ICs, as in F1.
// Shared memory holds the rf weights q/rf and each IC's D coarse
// trajectories, component-major (component c's state s at c·(n_steps + 1)
// + s), in a slice of ens_stride(n_steps, D) floats (odd).
//   1. Every lane runs the coarse march serially and alike, in the plain
//      version's order; lane (s mod G) stores state s.
//   2. The fine nodes are swept in blocks of U·G from the top (U =
//      vec_ahead(D)). Lane l computes, in registers, the nodes
//      n = top − 1 − (u·G + l), u < U:
//      u_n per component by interpolation, the pair (f, J) at (u_n, tf_n)
//      once, the residual r_{n+1} = u_{n+1} − (u_n + f_n·h_n) per component
//      and the chain's coefficients A_n = 2·u_n·h_n per component and
//      h_n·J(u_n)[m][a] for the entries Ode::nonzero(m, a) (a compile-time
//      test: structurally zero entries are neither computed nor read, as
//      the TPU kernel skips literal zeros at trace time).
//   3. Every lane of the group runs the chain over the block, reading each
//      node's values from the lane that computed it (__shfl_sync within the
//      group): v_j[a] = A_j[a] + v_{j+1}[a], then + h_j·J_j[m][a]·v_{j+1}[m]
//      in m order (the plain version's and the TPU kernel's order), and the
//      per-step sums of e_j = Σ_a r_j[a]·v_j[a] (a in order), lane 0 storing
//      each step's |sum| once its block is complete.
// Every lane takes the same trips through every loop, so the shuffles see
// full warps. A lane holds U·(2D + nnz) floats of a block beside the chain's
// D + nnz of the block's top and v's D: the instances are compiled where
// 2D + nnz <= kVecRegRow alone (chip_smoke.py phase 44 reads their
// registers).
template <class Ode, int U>
__global__ void __launch_bounds__(256, 1)
fd_ensemble_vec_kernel(int n, int n_steps, int rf, int lanes, const float* __restrict__ grid,
                       const float* __restrict__ u0, float* __restrict__ err, OdeConsts k) {
  constexpr unsigned kFull = 0xffffffffu;
  constexpr int D = Ode::D;
  extern __shared__ float smem[];
  const int slot = threadIdx.x / lanes;
  const int lane = threadIdx.x - slot * lanes;
  const long ic = static_cast<long>(blockIdx.x) * (blockDim.x / lanes) + slot;
  const bool live = ic < n;
  const int n_fine = n_steps * rf;
  const int rows = n_steps + 1;
  const float* tc = grid;
  const float* dts = grid + n_steps;
  const float* tf = dts + n_steps;
  const float* dtf = tf + n_fine;
  float* wq = smem;  // wq[q] = q/rf
  for (int q = threadIdx.x; q < rf; q += blockDim.x) wq[q] = dtf[n_fine + q];
  __syncthreads();
  float* traj = smem + rf + static_cast<long>(slot) * ens_stride(n_steps, D);

  float u[D];
#pragma unroll
  for (int c = 0; c < D; ++c) u[c] = live ? u0[ic * D + c] : 0.f;
  if (lane == 0) {
#pragma unroll
    for (int c = 0; c < D; ++c) traj[c * rows] = u[c];
  }
  for (int s = 0; s < n_steps; ++s) {
    float fs[D];
    Ode::f(u, tc[s], k, fs);
#pragma unroll
    for (int c = 0; c < D; ++c) u[c] = u[c] + fs[c] * dts[s];
    if (lane == ((s + 1) & (lanes - 1))) {
#pragma unroll
      for (int c = 0; c < D; ++c) traj[c * rows + s + 1] = u[c];
    }
  }
  __syncwarp();

  // the lane's node nn = i·rf + q, stepped down by G nodes (di steps + dq)
  const int di = lanes / rf;
  const int dq = lanes - di * rf;
  int nn = n_fine - 1 - lane;
  int i = nn >= 0 ? nn / rf : -1;
  int q = nn >= 0 ? nn - i * rf : 0;
  float v[D];
#pragma unroll
  for (int c = 0; c < D; ++c) v[c] = 0.f;  // v_{n_fine} = k_{n_fine} = 0 (J sums u[:-1])
  float blk = 0.f;
  // A and h·J of the block's top node (none at n_fine)
  float a_top[D], hj_top[D * D];
#pragma unroll
  for (int c = 0; c < D; ++c) a_top[c] = 0.f;
#pragma unroll
  for (int e = 0; e < D * D; ++e) hj_top[e] = 0.f;
  int step = n_steps - 1, left = rf - 1;  // chain node j − 1 = step·rf + left
  for (int top = n_fine; top > 0; top -= U * lanes) {
    float rr[U][D], aa[U][D], hj[U][D * D];
#pragma unroll
    for (int b = 0; b < U; ++b) {
      // below node 0 (the last block's spare slots) node 0 is computed and
      // dropped, so the U pairs run without a branch of their own
      const bool real = nn >= 0;
      const int n_b = real ? nn : 0, i_b = real ? i : 0, q_b = real ? q : 0;
      float u_n[D], u_n1[D];
#pragma unroll
      for (int c = 0; c < D; ++c) {
        const float lo = traj[c * rows + i_b];
        const float hi = traj[c * rows + i_b + 1];
        u_n[c] = q_b == 0 ? lo : lo + wq[q_b] * (hi - lo);
        u_n1[c] = q_b + 1 == rf ? hi : lo + wq[q_b + 1] * (hi - lo);
      }
      const float h = dtf[n_b];
      float fs[D], jac[D * D];
      Ode::pair(u_n, tf[n_b], k, fs, jac);
#pragma unroll
      for (int c = 0; c < D; ++c) {
        rr[b][c] = real ? u_n1[c] - (u_n[c] + fs[c] * h) : 0.f;
        aa[b][c] = real ? 2.f * u_n[c] * h : 0.f;
      }
#pragma unroll
      for (int e = 0; e < D * D; ++e)
        hj[b][e] = real && Ode::nonzero(e / D, e % D) ? h * jac[e] : 0.f;
      nn -= lanes;
      i -= di;
      q -= dq;
      if (q < 0) {
        q += rf;
        --i;
      }
    }
#pragma unroll
    for (int b = 0; b < U; ++b) {
      for (int l = 0; l < lanes; ++l) {
        const int j = top - (b * lanes + l);
        if (j <= 0) break;
        float r_j[D], a_j[D], hj_j[D * D];  // r of node j − 1; A, h·J of node j
#pragma unroll
        for (int c = 0; c < D; ++c) {
          r_j[c] = __shfl_sync(kFull, rr[b][c], l, lanes);
          a_j[c] = a_top[c];
        }
#pragma unroll
        for (int e = 0; e < D * D; ++e) hj_j[e] = hj_top[e];
        if (l > 0) {
#pragma unroll
          for (int c = 0; c < D; ++c) a_j[c] = __shfl_sync(kFull, aa[b][c], l - 1, lanes);
#pragma unroll
          for (int e = 0; e < D * D; ++e)
            if (Ode::nonzero(e / D, e % D)) hj_j[e] = __shfl_sync(kFull, hj[b][e], l - 1, lanes);
        } else if (b > 0) {
#pragma unroll
          for (int c = 0; c < D; ++c)
            a_j[c] = __shfl_sync(kFull, aa[b - 1][c], lanes - 1, lanes);
#pragma unroll
          for (int e = 0; e < D * D; ++e)
            if (Ode::nonzero(e / D, e % D))
              hj_j[e] = __shfl_sync(kFull, hj[b - 1][e], lanes - 1, lanes);
        }
        if (j < n_fine) {  // v_j = k_j + (I + h_j·J(u_j))ᵀ v_{j+1}
          float vn[D];
#pragma unroll
          for (int a = 0; a < D; ++a) {
            float acc = a_j[a] + v[a];
#pragma unroll
            for (int m = 0; m < D; ++m) {
              if (Ode::nonzero(m, a)) acc = acc + hj_j[m * D + a] * v[m];
            }
            vn[a] = acc;
          }
#pragma unroll
          for (int a = 0; a < D; ++a) v[a] = vn[a];
        }
        float e = r_j[0] * v[0];
#pragma unroll
        for (int a = 1; a < D; ++a) e = e + r_j[a] * v[a];
        blk += e;
        if (left == 0) {  // block `step` covers fine nodes step·rf+1 .. (step+1)·rf
          if (live && lane == 0) err[static_cast<long>(step) * n + ic] = fabsf(blk);
          blk = 0.f;
          left = rf;
          --step;
        }
        --left;
      }
    }
#pragma unroll
    for (int c = 0; c < D; ++c)
      a_top[c] = __shfl_sync(kFull, aa[U - 1][c], lanes - 1, lanes);  // node top − U·G
#pragma unroll
    for (int e = 0; e < D * D; ++e)
      if (Ode::nonzero(e / D, e % D))
        hj_top[e] = __shfl_sync(kFull, hj[U - 1][e], lanes - 1, lanes);
  }
}

// F2's window design, for states whose node table the registers cannot
// hold (2D + nnz > kVecRegRow, up to d = 15): G >= D lanes of one warp serve
// an IC, lane a owning the adjoint's component v[a]; a CTA of T threads
// serves T/G ICs. Shared memory holds the rf weights and, per IC, the D
// coarse trajectories (ens_stride floats, as the register design) and a
// window of W + 1 rows of vec_row() floats: r_{n+1} (D), A_n = 2·u_n·h_n (D) and h_n·J(u_n) at its compact
// slots (jac_slot), row k for node bot + k, row W for the window's top node.
//   1. Every lane runs the coarse march, as the register design.
//   2. The fine nodes are swept in windows of W from the top, (bot, top].
//      The lanes split the nodes n = bot … top − 1 (n ≡ bot + lane mod G):
//      u_n by interpolation, Ode::pair once, then r_{n+1}, A_n and h_n·J's
//      live entries into node n's row; one __syncwarp.
//   3. Every lane takes each chain step j = top … bot + 1: lane a forms
//      v_j[a] = (A_j[a] + v_{j+1}[a]) + h_j·J_j[m][a]·v_{j+1}[m] over the
//      live m in order (the plain version's order), v_{j+1}[m] read by
//      __shfl_sync within the group into every lane (vm); then the group
//      shuffles v_j into vm, and every lane sums e_j = Σ_a r_j[a]·v_j[a] in
//      a order; lane 0 stores each step's |sum| once its block is complete.
//      The column's live m and slots are compile-time row masks (a lane's
//      slot is the row's base plus the live entries left of its a).
//   4. Node bot's A and h·J move to row W (the next window's top); a
//      __syncwarp before the next window overwrites the rows.
// Lanes a >= D compute nodes and hold v = 0 in the chain. Every lane takes
// the same trips through the chain (the windows and steps run to the same
// bounds for every IC), so the shuffles see full warps; the node loop, which
// has none, may end a trip early in the last lanes. The arithmetic of a node
// and a chain step is the register design's, expression for expression.
template <class Ode>
__global__ void __launch_bounds__(256)
fd_ensemble_vec_window_kernel(int n, int n_steps, int rf, int lanes, int window,
                              const float* __restrict__ grid, const float* __restrict__ u0,
                              float* __restrict__ err, OdeConsts k) {
  constexpr unsigned kFull = 0xffffffffu;
  constexpr int D = Ode::D;
  constexpr int kRow = vec_row<Ode>();
  extern __shared__ float smem[];
  const int slot = threadIdx.x / lanes;
  const int lane = threadIdx.x - slot * lanes;
  const long ic = static_cast<long>(blockIdx.x) * (blockDim.x / lanes) + slot;
  const bool live = ic < n;
  const int n_fine = n_steps * rf;
  const int rows = n_steps + 1;
  const float* tc = grid;
  const float* dts = grid + n_steps;
  const float* tf = dts + n_steps;
  const float* dtf = tf + n_fine;
  float* wq = smem;  // wq[q] = q/rf
  for (int q = threadIdx.x; q < rf; q += blockDim.x) wq[q] = dtf[n_fine + q];
  __syncthreads();
  float* traj = smem + rf +
                static_cast<long>(slot) * (ens_stride(n_steps, D) + (window + 1L) * kRow);
  float* tab = traj + ens_stride(n_steps, D);

  {
    float u[D];
#pragma unroll
    for (int c = 0; c < D; ++c) u[c] = live ? u0[ic * D + c] : 0.f;
    if (lane == 0) {
#pragma unroll
      for (int c = 0; c < D; ++c) traj[c * rows] = u[c];
    }
    for (int s = 0; s < n_steps; ++s) {
      float fs[D];
      Ode::f(u, tc[s], k, fs);
#pragma unroll
      for (int c = 0; c < D; ++c) u[c] = u[c] + fs[c] * dts[s];
      if (lane == ((s + 1) & (lanes - 1))) {
#pragma unroll
        for (int c = 0; c < D; ++c) traj[c * rows + s + 1] = u[c];
      }
    }
  }
  __syncwarp();

  const int a = lane;  // this lane's component (none at a >= D)
  float v = 0.f;       // v_{j+1}[a]; v_{n_fine} = 0 (J sums u[:-1])
  float vm[D];         // v_{j+1}[m] of every component
#pragma unroll
  for (int m = 0; m < D; ++m) vm[m] = 0.f;
  float blk = 0.f;
  int step = n_steps - 1, left = rf - 1;  // chain node j − 1 = step·rf + left
  for (int top = n_fine; top > 0; top -= window) {
    const int bot = top > window ? top - window : 0;
    for (int nn = bot + lane; nn < top; nn += lanes) {
      const int i = nn / rf;
      const int q = nn - i * rf;
      float u_n[D], u_n1[D];
#pragma unroll
      for (int c = 0; c < D; ++c) {
        const float lo = traj[c * rows + i];
        const float hi = traj[c * rows + i + 1];
        u_n[c] = q == 0 ? lo : lo + wq[q] * (hi - lo);
        u_n1[c] = q + 1 == rf ? hi : lo + wq[q + 1] * (hi - lo);
      }
      const float h = dtf[nn];
      float fs[D], jac[D * D];
      Ode::pair(u_n, tf[nn], k, fs, jac);
      float* row = tab + (nn - bot) * kRow;
#pragma unroll
      for (int c = 0; c < D; ++c) {
        row[c] = u_n1[c] - (u_n[c] + fs[c] * h);
        row[D + c] = 2.f * u_n[c] * h;
      }
      static_for<D * D>([&](auto ec) {
        constexpr int e = decltype(ec)::value;
        if constexpr (Ode::nonzero(e / D, e % D)) {
          constexpr int at = 2 * D + jac_slot<Ode>(e);
          row[at] = h * jac[e];
        }
      });
    }
    __syncwarp();
    for (int j = top; j > bot; --j) {
      const float* r_j = tab + (j - 1 - bot) * kRow;  // r of node j − 1
      if (j < n_fine) {  // v_j = k_j + (I + h_j·J(u_j))ᵀ v_{j+1}
        const float* c_j = tab + (j < top ? j - bot : window) * kRow;  // A, h·J of node j
        float acc = (a < D ? c_j[D + a] : 0.f) + v;
        static_for<D>([&](auto mc) {
          constexpr int m = decltype(mc)::value;
          constexpr unsigned mask = jac_row_mask<Ode>(m);
          constexpr int base = 2 * D + jac_slot<Ode>(m * D);
          if ((mask >> a) & 1u)
            acc = acc + c_j[base + __popc(mask & ((1u << a) - 1u))] * vm[m];
        });
        v = a < D ? acc : 0.f;
#pragma unroll
        for (int m = 0; m < D; ++m) vm[m] = __shfl_sync(kFull, v, m, lanes);
      }
      float e = r_j[0] * vm[0];
#pragma unroll
      for (int c = 1; c < D; ++c) e = e + r_j[c] * vm[c];
      blk += e;
      if (left == 0) {  // block `step` covers fine nodes step·rf+1 .. (step+1)·rf
        if (live && lane == 0) err[static_cast<long>(step) * n + ic] = fabsf(blk);
        blk = 0.f;
        left = rf;
        --step;
      }
      --left;
    }
    __syncwarp();
    for (int x = D + lane; x < kRow; x += lanes) tab[window * kRow + x] = tab[x];
    __syncwarp();
  }
}

// F3: G lanes of one warp serve a member (G | 32, so a group never straddles
// a warp); a CTA of T threads serves T/G members, each with its own slice of
// shared memory: its widths dt (n_steps), the coarse trajectory and node
// times (n_steps + 1 each), and a window of `window` fine nodes' tables
// (the chain's coefficients A_j = 2·u_j·h_j and C_j = 1 + f_u(u_j)·h_j, and
// the residual r_j). dt (B, n_steps) member-major, err (B, n_steps) in the
// strided (block = 0) or block (block = 1) convention, j (B,) = Σ u_n²·dt_n.
//   1. The group loads the member's widths (contiguous) into shared memory.
//   2. Every lane runs the coarse march, J and tc, serially and alike; lane
//      (s mod G) stores state s.
//   3. The fine nodes are swept in windows from the top, (bot, top]. For a
//      window the lanes split its nodes n = bot … top (n ≡ bot + lane mod G):
//      u_n by interpolation, (f, f_u) at (u_n, t_n) once, h_n = dt_i·(1/rf),
//      then r_{n+1} = u_{n+1} − (u_n + f_n·h_n), A_n and C_n; one __syncwarp;
//      lane 0 runs v_j = A_j + C_j·v_{j+1} (v carried across windows) and
//      the per-step sums of r_j·v_j for j = top … bot + 1, the plain
//      version's order, storing each step's indicator once its block is
//      complete; one __syncwarp before the next window overwrites the tables.
// Only the chain is serial; everything it reads is in shared memory, so its
// loads never wait on v. A zero-width step gives h = 0, u_{n+1} = u_n,
// r = 0 and A = 0, C = 1: exactly 0 to its indicator.
template <class Ode>
__global__ void __launch_bounds__(256)
fd_estimate_per_member_kernel(int nb, int n_steps, int rf, int block, float t0, int lanes,
                              int window, const float* __restrict__ dt,
                              const float* __restrict__ u0, float* __restrict__ err,
                              float* __restrict__ j_out, OdeConsts k) {
  extern __shared__ float smem[];
  const int slot = threadIdx.x / lanes;
  const int lane = threadIdx.x - slot * lanes;
  const long m = static_cast<long>(blockIdx.x) * (blockDim.x / lanes) + slot;
  const bool live = m < nb;
  const int n_fine = n_steps * rf;
  float* ds = smem + static_cast<long>(slot) * (3 * n_steps + 2 + 3 * window);
  float* traj = ds + n_steps;
  float* tc = traj + n_steps + 1;
  float* ca = tc + n_steps + 1;  // A_n at n − bot − 1
  float* cc = ca + window;       // C_n at n − bot − 1
  float* rr = cc + window;       // r_{n+1} at n − bot
  const float inv_rf = 1.f / static_cast<float>(rf);

  for (int s = lane; s < n_steps; s += lanes) ds[s] = live ? dt[m * n_steps + s] : 0.f;
  __syncwarp();
  float u = live ? u0[m] : 0.f;
  float t = t0;
  float j_val = 0.f;
  if (lane == 0) {
    traj[0] = u;
    tc[0] = t;
  }
  for (int s = 0; s < n_steps; ++s) {
    const float d = ds[s];
    j_val = j_val + u * u * d;  // J = Σ u_n² dt_n (left rule)
    u = u + Ode::f(u, t, k) * d;
    t = t + d;
    if (lane == (s + 1) % lanes) {
      traj[s + 1] = u;
      tc[s + 1] = t;
    }
  }
  if (lane == 0 && live) j_out[m] = j_val;
  __syncwarp();

  float v = 0.f;    // v_{n_fine} = 0 (J sums u[:-1])
  float blk = 0.f;
  for (int top = n_fine; top >= 1; top -= window) {
    const int bot = top > window ? top - window : 0;
    for (int n = bot + lane; n <= top; n += lanes) {
      if (n == n_fine) continue;  // node n_fine: no residual above it, no A, C
      const int i = n / rf;       // coarse step of fine interval [n, n + 1)
      const int q = n - i * rf;
      const float d_i = ds[i];
      const float w = static_cast<float>(q) / static_cast<float>(rf);
      const float u_n = u_fine(traj, 1, 0, n, rf);
      const float t_n = tc[i] + w * d_i;
      const float h = d_i * inv_rf;
      float f_n, fu_n;
      Ode::pair(u_n, t_n, k, &f_n, &fu_n);
      if (n < top) rr[n - bot] = u_fine(traj, 1, 0, n + 1, rf) - (u_n + f_n * h);
      if (n > bot) {
        ca[n - bot - 1] = 2.f * u_n * h;
        cc[n - bot - 1] = 1.f + fu_n * h;
      }
    }
    __syncwarp();
    if (lane == 0) {
      // node j's tables are read while node j + 1's update of v runs
      float a = 0.f, c = 1.f, r = rr[top - 1 - bot];
      if (top < n_fine) {
        a = ca[top - bot - 1];
        c = cc[top - bot - 1];
      }
      for (int j = top; j > bot; --j) {
        const float a_j = a, c_j = c, r_j = r;
        if (j - 1 > bot) {
          a = ca[j - bot - 2];
          c = cc[j - bot - 2];
          r = rr[j - bot - 2];
        }
        if (j < n_fine) v = a_j + c_j * v;
        const float e = r_j * v;
        const int i = (j - 1) / rf;
        const int q = (j - 1) - i * rf;
        if (block) {
          blk += e;
        } else if (q != 0) {  // strided: drop the first fine node of every step
          blk += fabsf(e);
        }
        if (q == 0) {
          if (live) err[m * n_steps + i] = block ? fabsf(blk) : blk;
          blk = 0.f;
        }
      }
    }
    __syncwarp();
  }
}

int set_smem(const void* kernel, long bytes) {
  if (bytes > kMaxSmem) return -3;
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return 0;
}

// F1's and F2's shared memory for T/G ICs of d components: the rf
// interpolation weights, then the ICs' coarse trajectories.
long ensemble_smem(int lanes, int threads, int n_steps, int rf, int d = 1) {
  return (rf + static_cast<long>(threads / lanes) * ens_stride(n_steps, d)) *
         static_cast<long>(sizeof(float));
}

template <class Ode>
int launch_ensemble(int n, int n_steps, int rf, int lanes, int threads, const float* grid,
                    const float* u0, float* err, const OdeConsts& k, cudaStream_t stream) {
  const long smem = ensemble_smem(lanes, threads, n_steps, rf);
  const int code = set_smem(reinterpret_cast<const void*>(&fd_ensemble_kernel<Ode>), smem);
  if (code != 0) return code;
  const int per = threads / lanes;
  const long blocks = (static_cast<long>(n) + per - 1) / per;
  fd_ensemble_kernel<Ode><<<blocks, threads, smem, stream>>>(n, n_steps, rf, lanes, grid, u0,
                                                            err, k);
  return static_cast<int>(cudaGetLastError());
}

// F2's window design's shared memory for T/G ICs: the rf weights, then each
// IC's trajectories and W + 1 rows of vec_row() floats.
template <class Ode>
long vec_window_smem(int lanes, int threads, int n_steps, int rf, int window) {
  return (rf + static_cast<long>(threads / lanes) *
                   (ens_stride(n_steps, Ode::D) + (window + 1L) * vec_row<Ode>())) *
         static_cast<long>(sizeof(float));
}

// F2's launch: the window design where window > 0 (G >= D lanes), else the
// register design (2D + nnz <= kVecRegRow); -3 where neither takes the
// launch or the CTA's shared memory exceeds a block's (set_smem).
template <class Ode>
int launch_ensemble_vec(int n, int n_steps, int rf, int lanes, int threads, int window,
                        const float* grid, const float* u0, float* err, const OdeConsts& k,
                        cudaStream_t stream) {
  const int per = threads / lanes;
  const long blocks = (static_cast<long>(n) + per - 1) / per;
  if (window > 0) {
    if (lanes < Ode::D) return -3;
    const long smem = vec_window_smem<Ode>(lanes, threads, n_steps, rf, window);
    const int code = set_smem(
        reinterpret_cast<const void*>(&fd_ensemble_vec_window_kernel<Ode>), smem);
    if (code != 0) return code;
    fd_ensemble_vec_window_kernel<Ode><<<blocks, threads, smem, stream>>>(
        n, n_steps, rf, lanes, window, grid, u0, err, k);
    return static_cast<int>(cudaGetLastError());
  }
  if constexpr (vec_table<Ode>() <= kVecRegRow) {
    constexpr int U = vec_ahead(Ode::D);
    const long smem = ensemble_smem(lanes, threads, n_steps, rf, Ode::D);
    const int code =
        set_smem(reinterpret_cast<const void*>(&fd_ensemble_vec_kernel<Ode, U>), smem);
    if (code != 0) return code;
    fd_ensemble_vec_kernel<Ode, U><<<blocks, threads, smem, stream>>>(n, n_steps, rf, lanes,
                                                                      grid, u0, err, k);
    return static_cast<int>(cudaGetLastError());
  } else {
    return -3;
  }
}

// The launches F1, F2 and F3 take: G lanes (a power of two up to 32) of a warp
// per IC or member, in CTAs of 32, 64, 128 or 256 threads.
bool launch_ok(int lanes, int threads) {
  const bool lanes_ok = lanes >= 1 && lanes <= 32 && (lanes & (lanes - 1)) == 0;
  return lanes_ok && (threads == 32 || threads == 64 || threads == 128 || threads == 256);
}

// F3's shared memory for T/G members with a window of `window` nodes.
long per_member_smem(int lanes, int threads, int n_steps, int window) {
  return static_cast<long>(threads / lanes) * (3L * n_steps + 2 + 3L * window) * sizeof(float);
}

template <class Ode>
int launch_per_member(int nb, int n_steps, int rf, int block, float t0, int lanes, int threads,
                      int window, const float* dt, const float* u0, float* err, float* j_out,
                      const OdeConsts& k, cudaStream_t stream) {
  const long smem = per_member_smem(lanes, threads, n_steps, window);
  const int code =
      set_smem(reinterpret_cast<const void*>(&fd_estimate_per_member_kernel<Ode>), smem);
  if (code != 0) return code;
  const int per = threads / lanes;
  const long blocks = (nb + per - 1) / per;
  fd_estimate_per_member_kernel<Ode><<<blocks, threads, smem, stream>>>(
      nb, n_steps, rf, block, t0, lanes, window, dt, u0, err, j_out, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Return 0 on success, a cudaError_t code after a failed launch, -2 for an
// ODE id the kernel does not take (or trig="fast" on another ODE than
// sin(u)), -3 for a launch the kernel does not take. F1 runs on `lanes`
// lanes an IC (1, 2, 4, 8, 16 or 32) in CTAs of `threads` (32, 64, 128 or
// 256), the CTA's shared memory within a block's; grid is the host fold
// [tc, dts, tf, dtf], err (n_steps, n).
int fd_ensemble(int ode_id, int fast_trig, int n_u, int n_t, const float* consts, int n,
                int n_steps, int rf, int lanes, int threads, const float* grid,
                const float* u0, float* err, void* stream) {
  if (fast_trig && ode_id != 1) return -2;
  if (!launch_ok(lanes, threads) || n_steps < 1 || rf < 1 ||
      ensemble_smem(lanes, threads, n_steps, rf) > kMaxSmem)
    return -3;
  const OdeConsts k = pack_consts(n_u, n_t, consts);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define AOA_LAUNCH(ODE) launch_ensemble<ODE>(n, n_steps, rf, lanes, threads, grid, u0, err, k, s)
  AOA_ODE_SCALAR_SWITCH(ode_id, fast_trig, AOA_LAUNCH)
#undef AOA_LAUNCH
}

// F2 on `lanes` lanes an IC in CTAs of `threads`, as F1; u0 is (n, D),
// IC-major, D the vector functor's (ode_id 6 the harmonic oscillator, or
// the user library's traced one). window = 0: the register design (2D + nnz
// <= kVecRegRow); window > 0: the window design on windows of that many
// fine nodes (lanes >= D).
int fd_ensemble_vec(int ode_id, int n, int n_steps, int rf, int lanes, int threads, int window,
                    const float* grid, const float* u0, float* err, void* stream) {
  if (!launch_ok(lanes, threads) || n_steps < 1 || rf < 1 || window < 0) return -3;
  const OdeConsts k{};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define AOA_LAUNCH(ODE) \
  launch_ensemble_vec<ODE>(n, n_steps, rf, lanes, threads, window, grid, u0, err, k, s)
  AOA_ODE_VECTOR_SWITCH(ode_id, AOA_LAUNCH)
#undef AOA_LAUNCH
}

// F3 on `lanes` lanes a member (1, 2, 4, 8, 16 or 32) in CTAs of `threads`
// (32, 64, 128 or 256) with a window of `window` fine nodes (1 <= window <=
// n_steps·rf), the CTA's shared memory within a block's: -3 otherwise. dt
// is (B, n_steps), member-major; block = 1 for the block convention, 0 for
// strided. tc starts at t0.
int fd_estimate_per_member(int ode_id, int n_u, int n_t, const float* consts, int nb,
                           int n_steps, int rf, int block, float t0, int lanes, int threads,
                           int window, const float* dt, const float* u0, float* err,
                           float* j_out, void* stream) {
  if (!launch_ok(lanes, threads) || n_steps < 1 || rf < 1 || window < 1 ||
      window > n_steps * rf || per_member_smem(lanes, threads, n_steps, window) > kMaxSmem)
    return -3;
  const OdeConsts k = pack_consts(n_u, n_t, consts);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define AOA_LAUNCH(ODE)                                                                      \
  launch_per_member<ODE>(nb, n_steps, rf, block, t0, lanes, threads, window, dt, u0, err,   \
                         j_out, k, s)
  AOA_ODE_SCALAR_SWITCH(ode_id, 0, AOA_LAUNCH)
#undef AOA_LAUNCH
}

const char* fd_error_string(int code) {
  if (code == -2) return "ODE kernel_id (or trig) not implemented by this kernel";
  if (code == -3)
    return "coarse trajectory exceeds a block's shared memory (too many steps), or a launch "
           "the kernel does not take (lanes 1-32, a power of two; 32-256 threads; "
           "1 <= window <= n_steps*rf; F2: lanes >= d on a window, 2d + nnz <= the "
           "register design's cap without one)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
