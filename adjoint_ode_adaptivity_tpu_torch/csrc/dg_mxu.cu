// Hand-written Hopper (sm_90a) kernels of the DG-advection pipeline in the
// MXU layout: the state is ONE (Np, N) array, N = B·K columns (the (B, K)
// states flattened), and the volume term is a product of the (Np, Np) table
// by the state's columns. Plain C interface, bound with ctypes.
//
// KM1 dg_mxu_fwd  replaces adjoint_ode_adaptivity_tpu/ops/pallas/dg_mxu.py:151
//                 (_fwd_traj_kernel_m): the LSRK4(5) march storing every
//                 entry state in a (n_steps, Np, N) trajectory. One launch
//                 per s_f steps (km_fwd_fused).
// KM2 dg_mxu_rev  replaces dg_mxu.py:179 (_adj_est_kernel_m): per step in
//                 reverse, two dt/2 residual steps from the stored u_n,
//                 η += Σ_rows λ·(u_{n+1} − half2), two dt/2 transposed steps.
//                 One launch per s_f steps (km_rev_fused).
//
// Arithmetic (dg_mxu.py:106-148). Tables folded as _MxuCfg.tables folds them
// (rx and dt inside: drc = −a·rx·dt·Dr, liftl/liftr the lift columns times
// ∓a/2·rx·dt), passed by value. A forward stage of column c:
//   du_l = u_0 − (first ? uin : u_{Np−1}[c − 1]),
//   du_r = last ? 0 : u_{Np−1} − u_0[c + 1],
//   rhs  = (drc·u + liftl·du_l) + liftr·du_r,  r = A_s·r + rhs,  u += B_s·r,
// first/last = (c % K == 0 / K − 1): the ±1 shifts cross state boundaries
// only where these masks overwrite them (dg_mxu.py:31-37). The transposed
// stage: w = B_s·λu + λr, λr = A_s·w, w0 = liftlᵀw, w1 = liftrᵀw,
//   λu = (λu + drcᵀw) + [w0 − p1 on row 0; s1 − p0 on row Np−1],
// s1 = last ? 0 : w1, p0 = last ? 0 : w0[c + 1], p1 = first ? 0 : w1[c − 1].
// Every product, sum and difference is an explicit IEEE float32 rounding
// (__fmul_rn, __fadd_rn, __fsub_rn; no FMA contraction, no TF32), each sum in
// a fixed order (the volume over the contracted index 0 … Np−1, the lift
// rows and the η row sum likewise): the plain version
// (ops/cuda/dg_mxu.py) writes the same operations in the same order. The
// stage times and their inflow values −sin(a·t_s) are formed in float32 on
// the host as the TPU kernel forms them (dg_mxu.py:161, :195-196) and passed
// in a table, one value per stage.
//
// KM1 and KM2 run on K1's and K2's windows (csrc/fused_window.cuh): one CTA
// per (tile, member), a tile of L local columns [lo, hi) of member b's K
// with a window of W ghost columns a side clipped to [0, K), one thread per
// window column. The window's ends are the first/last masks of c % K at a
// member's ends and wrong (outside the cone) at ghost edges: a coupling is
// cut wherever the untiled march cuts it.
//
// KM1: fused over s_f ≤ 32 steps a launch. Each thread keeps its column's
// u, r and the stage output in registers; per stage it posts u[0] and
// u[Np−1] into a double-buffered trace array in shared memory, passes one
// __syncthreads and reads its neighbours' (km_window_fwd). The local entry
// state of every step goes to the trajectory. The ghost rule: 5 stages a
// step, each coupling ±1 column, so after s_f steps a window edge's error
// has reached 5·s_f columns; W = 5·s_f keeps every local column exact, and
// where one tile holds a member's K there are no ghosts. u crosses launches
// through a global ping-pong buffer, from which the neighbouring tiles read
// their ghosts; r restarts at every step's stage 0. The inflow values ride
// each launch (FusedInflow), sliced by global step from the host's table.
// The plan (ops/cuda/dg_mxu.py km_fwd_plan) picks s_f, the CTA size and the
// tiles.
//
// KM2: fused over s_f ≤ 16 steps a launch. Tiles over the
// flattened B·K columns, a tile spanning members, measured the same at
// K = 10⁴ (PERF.md) and were dropped. Each thread keeps its column's λu, λr, the η it accumulates and the
// trajectory columns u_n, u_{n+1} and the prefetched u_{n−1} in registers for
// the whole launch. Per stage it posts two floats (the residual's u[0],
// u[Np−1]; the transposed stage's w0 = liftlᵀw, w1 = liftrᵀw) into a
// double-buffered trace array in shared memory, passes one __syncthreads and
// reads its neighbours'. The ghost rule: the 10 residual stages a step start
// from u_n, read exact from the trajectory, so their wrong edge reaches 10
// columns in; λ's 10 transposed stages a step couple ±1 column each and are
// carried through the launch, so after s_f steps the wrong edge has reached
// 10·s_f columns. W ≥ 10·s_f keeps every local column exact; the plans keep
// W = 10·s_f + 10 (ROADMAP "Ghost cones"). λ crosses launches through a
// global ping-pong buffer, from which the neighbouring tiles read their
// ghosts; η is loaded at a launch's start, accumulated in KM2's order
// n = N−1 … 0 and stored at its end. Every column computes exactly the
// per-stage sweep's operations in its order, so every plan gives the plain
// version's bits, and so does KM1.
//
// What bounds them. The least time for the work is set by its operations
// (2·Np² + 9·Np + 4 per column and stage): at N = 7, K = 10⁴, B = 8 and 256
// steps, 0.31 ms for KM1 and 1.25 ms for KM2. Fused, both are bound by
// issue: a stage is ~2·Np² un-contracted FP32 instructions a column (the
// bits forbid FMA, so at most half the card's FP32 rate counted in FMA
// operations), the ghosts add 2W/L of recomputed work, and each launch ~4 µs
// of start and tail; KM1 also stores its trajectory (n_steps states). The
// plans (ops/cuda/dg_mxu.py km_fwd_plan, km_rev_plan) pick s_f, the CTA size
// and the tiles. Registers: a KM2 thread holds ~9·Np + 20 values (92 at Np =
// 8), so Np 7-8 run 512-thread CTAs (128 registers a thread) and Np ≤ 6 one
// instance built for 1024 threads (64 a thread); a KM1 thread holds 3·Np +
// ~12, so one instance built for 1024 threads serves every Np. PERF.md holds
// the card's times.

#include <cuda_runtime.h>

#include "dg_stage.cuh"
#include "fused_window.cuh"

namespace {

using aoa_dg::Elem;
using aoa_dg::FusedInflow;
using aoa_dg::FusedPlan;
using aoa_dg::RkCoef;
using aoa_dg::StepTables;
using aoa_dg::Traces;
using aoa_dg::elem_of;
using aoa_dg::fused_block;
using aoa_dg::load_col;
using aoa_dg::pack_tables;
using aoa_dg::rk_coef;
using aoa_dg::store_col;

inline int launch_error() { return static_cast<int>(cudaGetLastError()); }

// ---------------------------------- KM1 and KM2: fused over s_f steps a launch

// The widest Np whose thread holds its registers at 64 (1024-thread CTAs).
constexpr int kKmMaxNp1024 = 6;

// Σ_i coef[i]·w[i] over i = 0 … Np−1 in order.
template <int NP>
__device__ __forceinline__ float row_dot(const float* coef, const float* w) {
  float s = __fmul_rn(coef[0], w[0]);
#pragma unroll
  for (int i = 1; i < NP; ++i) s = __fadd_rn(s, __fmul_rn(coef[i], w[i]));
  return s;
}

// One forward stage of the window: post u[0] and u[Np−1], one barrier,
// then r = A_s·r + rhs(u) and un = u + B_s·r on this column, the plain
// version's operations in its order (stage 0: r = rhs).
template <int NP, int T>
__device__ __forceinline__ void km_window_fwd(Traces<T>& tr, int buf, const Elem& el,
                                              const float* u, float* r, float* un,
                                              const StepTables& tab, bool have_r,
                                              float a_s, float b_s, float uin) {
  const int e = threadIdx.x;
  tr.lo[buf][e] = u[0];
  tr.hi[buf][e] = u[NP - 1];
  __syncthreads();
  if (!el.active) return;
  const float du_l = __fsub_rn(u[0], el.first ? uin : tr.hi[buf][e - 1]);
  const float du_r = el.last ? 0.f : __fsub_rn(u[NP - 1], tr.lo[buf][e + 1]);
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    float acc = __fmul_rn(tab.drc[i * NP], u[0]);
#pragma unroll
    for (int m = 1; m < NP; ++m) acc = __fadd_rn(acc, __fmul_rn(tab.drc[i * NP + m], u[m]));
    const float rhs = __fadd_rn(__fadd_rn(acc, __fmul_rn(tab.ll[i], du_l)),
                                __fmul_rn(tab.lr[i], du_r));
    r[i] = have_r ? __fadd_rn(__fmul_rn(a_s, r[i]), rhs) : rhs;
    un[i] = __fadd_rn(u[i], __fmul_rn(b_s, r[i]));
  }
}

// One transposed stage of the window: w = B_s·λu + λr (λr = 0 when
// !have_lr), post w0 and w1, one barrier, λu += drcᵀw + the edge rows,
// λr = A_s·w.
template <int NP, int T>
__device__ __forceinline__ void km_window_t(Traces<T>& tr, int buf, const Elem& el,
                                            float* lu, float* lr, const StepTables& tab,
                                            bool have_lr, float a_s, float b_s) {
  const int e = threadIdx.x;
  float w[NP];
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    const float bl = __fmul_rn(b_s, lu[i]);
    w[i] = have_lr ? __fadd_rn(bl, lr[i]) : bl;
  }
  const float w0 = row_dot<NP>(tab.ll, w);
  const float w1 = row_dot<NP>(tab.lr, w);
  tr.lo[buf][e] = w0;
  tr.hi[buf][e] = w1;
  __syncthreads();
  if (!el.active) return;
  const float s1 = el.last ? 0.f : w1;
  const float p0 = el.last ? 0.f : tr.lo[buf][e + 1];
  const float p1 = el.first ? 0.f : tr.hi[buf][e - 1];
#pragma unroll
  for (int j = 0; j < NP; ++j) {
    float acc = __fmul_rn(tab.drc[j], w[0]);
#pragma unroll
    for (int m = 1; m < NP; ++m) acc = __fadd_rn(acc, __fmul_rn(tab.drc[m * NP + j], w[m]));
    float v = __fadd_rn(lu[j], acc);
    if (j == 0) v = __fadd_rn(v, __fsub_rn(w0, p1));
    if (j == NP - 1) v = __fadd_rn(v, __fsub_rn(s1, p0));
    lu[j] = v;
    lr[j] = __fmul_rn(a_s, w[j]);
  }
}

// KM1's march over ``steps`` steps of the window from u_in, the global steps
// n0 .. n0 + steps − 1: the local entry state of step n goes to
// traj + n·size, the local exit state to u_out. inflow.v[5·s + j]: stage j
// of the launch's step s. The window's ends are a member's first and last
// columns (the masks of c % K) or ghost edges.
template <int NP, int T>
__global__ void __launch_bounds__(T)
km_fwd_fused(const float* __restrict__ u_in, float* __restrict__ traj,
             float* __restrict__ u_out, const __grid_constant__ StepTables full, RkCoef rk,
             const __grid_constant__ FusedInflow inflow, int nk, int tile_l, int ghost,
             int steps, int n0) {
  __shared__ Traces<T> tr;
  const Elem el = elem_of(nk, tile_l, ghost);
  const long n = static_cast<long>(gridDim.y) * nk;
  const long size = NP * n;
  float u[NP] = {}, r[NP] = {}, un[NP] = {};
  if (el.active) load_col<NP>(u_in, el.c, n, u);
  int buf = 0;
  for (int s = 0; s < steps; ++s) {
    if (el.local) store_col<NP>(traj + (n0 + s) * size, el.c, n, u);
#pragma unroll
    for (int j = 0; j < 5; ++j, buf ^= 1) {
      km_window_fwd<NP, T>(tr, buf, el, u, r, un, full, j > 0, rk.a[j], rk.b[j],
                           inflow.v[5 * s + j]);
#pragma unroll
      for (int i = 0; i < NP; ++i) u[i] = un[i];
    }
  }
  if (el.local) store_col<NP>(u_out, el.c, n, u);
}

// KM2's reverse over ``steps`` steps: traj[0 .. steps − 1] their entry
// states, u_top the state after the last. For s = steps − 1 … 0: two dt/2
// steps from traj[s] whose result adds Σ λ·(u_{s+1} − half2) to η on the
// local columns, then two dt/2 transposed steps of λ. λ from lam_in (whole
// window), local λ to lam_out; eta (N,) accumulated in place. inflow.v[10·s
// + j]: stage j of step s's two residual half steps. The window's ends are a
// member's first and last columns (the masks of c % K) or ghost edges.
template <int NP, int T>
__global__ void __launch_bounds__(T)
km_rev_fused(const float* __restrict__ traj, const float* __restrict__ u_top,
             const float* __restrict__ lam_in, float* __restrict__ lam_out,
             float* __restrict__ eta, const __grid_constant__ StepTables half,
             RkCoef rk, const __grid_constant__ FusedInflow inflow, int nk, int tile_l,
             int ghost, int steps) {
  __shared__ Traces<T> tr;
  const Elem el = elem_of(nk, tile_l, ghost);
  const long n = static_cast<long>(gridDim.y) * nk;
  const long size = NP * n;
  float lu[NP] = {}, lr[NP] = {}, cur[NP] = {}, nxt[NP] = {}, unp1[NP] = {};
  float acc = 0.f;
  if (el.active) {
    load_col<NP>(lam_in, el.c, n, lu);
    load_col<NP>(traj + (steps - 1) * size, el.c, n, cur);
    if (el.local) {
      load_col<NP>(u_top, el.c, n, unp1);
      acc = eta[el.c];
    }
  }
  // 20 stages a step: stage j of each ten posts into buffer j & 1
  for (int s = steps - 1; s >= 0; --s) {
    // the next entry state is loaded while this step's 20 stages run
    if (el.active && s > 0) load_col<NP>(traj + (s - 1) * size, el.c, n, nxt);
    float u[NP], r[NP] = {}, un[NP] = {};
#pragma unroll
    for (int i = 0; i < NP; ++i) u[i] = cur[i];
#pragma unroll
    for (int j = 0; j < 10; ++j) {
      const int st = j % 5;
      km_window_fwd<NP, T>(tr, j & 1, el, u, r, un, half, st > 0, rk.a[st], rk.b[st],
                           inflow.v[10 * s + j]);
#pragma unroll
      for (int i = 0; i < NP; ++i) u[i] = un[i];
    }
    if (el.local) {
      float e = 0.f;
#pragma unroll
      for (int i = 0; i < NP; ++i) {
        const float t = __fmul_rn(lu[i], __fsub_rn(unp1[i], un[i]));
        e = i == 0 ? t : __fadd_rn(e, t);
      }
      acc = __fadd_rn(acc, e);
    }
#pragma unroll
    for (int j = 0; j < 10; ++j) {
      const int st = 4 - j % 5;
      km_window_t<NP, T>(tr, j & 1, el, lu, lr, half, st < 4, rk.a[st], rk.b[st]);
    }
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      unp1[i] = cur[i];
      cur[i] = nxt[i];
    }
  }
  if (el.local) {
    store_col<NP>(lam_out, el.c, n, lu);
    eta[el.c] = acc;
  }
}

// -3 unless KM1 takes the plan: the forward's rules (aoa_dg::fwd_plan_ok),
// n a multiple of K, at most 65,535 members (grid.y).
int check_fwd_plan(int n, int nk, const FusedPlan& p) {
  if (!aoa_dg::fwd_plan_ok(nk, p)) return -3;
  return nk >= 1 && n % nk == 0 && n / nk <= 65535 ? 0 : -3;
}

// KM1: launches of s_f steps from the bottom (the last takes the remainder).
// u rides the ping-pong ubuf (2·Np·N floats), from which the neighbouring
// tiles read their ghosts; the last launch writes u_final. *launches counts
// the launches.
template <int NP, int T>
int fwd_impl(int n, int nk, int n_steps, const FusedPlan& p, const double* rk,
             const float* tables, const float* inflow, const float* u0, float* traj,
             float* u_final, float* ubuf, int* launches, cudaStream_t stream) {
  const StepTables full = pack_tables(NP, tables);
  const RkCoef coef = rk_coef(rk);
  const long size = static_cast<long>(NP) * n;
  const dim3 grid((nk + p.tile_l - 1) / p.tile_l, n / nk);
  const int block = fused_block(nk, p);
  const float* cur = u0;
  for (int lo = 0; lo < n_steps; lo += p.seg) {
    const int steps = n_steps - lo < p.seg ? n_steps - lo : p.seg;
    FusedInflow f{};
    for (int i = 0; i < 5 * steps; ++i) f.v[i] = inflow[5L * lo + i];
    float* out = lo + steps == n_steps ? u_final : ubuf + (*launches % 2) * size;
    km_fwd_fused<NP, T><<<grid, block, 0, stream>>>(cur, traj, out, full, coef, f, nk,
                                                    p.tile_l, p.ghost, steps, lo);
    const int err = launch_error();
    if (err != 0) return err;
    ++*launches;
    cur = out;
  }
  return 0;
}

// -3 unless KM2 takes the plan: the reverse's rules (aoa_dg::rev_plan_ok),
// 1024 threads only at Np ≤ kKmMaxNp1024, n a multiple of K, at most
// 65,535 members (grid.y).
int check_rev_plan(int np, int n, int nk, const FusedPlan& p) {
  if (!aoa_dg::rev_plan_ok(nk, p) || (p.threads == 1024 && np > kKmMaxNp1024)) return -3;
  return nk >= 1 && n % nk == 0 && n / nk <= 65535 ? 0 : -3;
}

// KM2: launches of s_f steps from the top (the last takes the remainder).
// λ rides the ping-pong lbuf (2·Np·N floats), the last launch writes lam0;
// *launches counts the launches.
template <int NP, int T>
int rev_impl(int n, int nk, int n_steps, const FusedPlan& p, const double* rk,
             const float* half_tables, const float* inflow, const float* traj,
             const float* u_final, const float* lam_end, float* lam0, float* eta,
             float* lbuf, int* launches, cudaStream_t stream) {
  const StepTables half = pack_tables(NP, half_tables);
  const RkCoef coef = rk_coef(rk);
  const long size = static_cast<long>(NP) * n;
  const dim3 grid((nk + p.tile_l - 1) / p.tile_l, n / nk);
  const int block = fused_block(nk, p);
  const int total = (n_steps + p.seg - 1) / p.seg;
  const float* lam = lam_end;
  for (int hi = n_steps; hi > 0; hi -= p.seg) {
    const int lo = hi > p.seg ? hi - p.seg : 0;
    FusedInflow f{};
    for (int i = 0; i < 10 * (hi - lo); ++i) f.v[i] = inflow[10L * lo + i];
    float* out = *launches == total - 1 ? lam0 : lbuf + (*launches % 2) * size;
    km_rev_fused<NP, T><<<grid, block, 0, stream>>>(
        traj + lo * size, hi == n_steps ? u_final : traj + hi * size, lam, out, eta, half,
        coef, f, nk, p.tile_l, p.ghost, hi - lo);
    const int err = launch_error();
    if (err != 0) return err;
    ++*launches;
    lam = out;
  }
  return 0;
}

// One instance per Np, built for the widest CTA a plan can pick there:
// __launch_bounds__(T) sets the register budget, 64 a thread at T = 1024
// (Np ≤ kKmMaxNp1024) and 128 at T = 512 (Np 7-8); a 512-thread plan at
// Np ≤ 6 runs on the 1024-thread instance. (A 512-thread instance at Np = 6
// was built too: ptxas gave it 64 registers and spilled.)
template <int NP>
constexpr int kKmThreads = NP <= kKmMaxNp1024 ? 1024 : 512;

// KM1's one instance per Np, built for 1024 threads (a 512-thread plan runs
// on it): a thread holds u, r and un, 3·Np + ~12 values.
template <int NP>
int fwd_np(int n, int nk, int n_steps, const FusedPlan& p, const double* rk,
           const float* tables, const float* inflow, const float* u0, float* traj,
           float* u_final, float* ubuf, int* launches, cudaStream_t stream) {
  return fwd_impl<NP, 1024>(n, nk, n_steps, p, rk, tables, inflow, u0, traj, u_final, ubuf,
                            launches, stream);
}

template <int NP>
int rev_np(int n, int nk, int n_steps, const FusedPlan& p, const double* rk,
           const float* half_tables, const float* inflow, const float* traj,
           const float* u_final, const float* lam_end, float* lam0, float* eta,
           float* lbuf, int* launches, cudaStream_t stream) {
  if (p.threads > kKmThreads<NP>) return -3;
  return rev_impl<NP, kKmThreads<NP>>(n, nk, n_steps, p, rk, half_tables, inflow, traj,
                                      u_final, lam_end, lam0, eta, lbuf, launches, stream);
}

}  // namespace

extern "C" {

// KM1 with the plan (seg = s_f, tile_l = L, ghost = W, threads). Returns 0
// on success, a cudaError_t code after a failed launch, -1 for an
// unsupported Np, -3 for a plan the kernel does not take. n = B·K columns,
// nk = K. tables: float32 [drc (Np, Np) row-major, liftl (Np), liftr (Np)]
// for the step dt; inflow: 5·n_steps values, stage s of step m at 5m + s.
// traj: (n_steps, Np, n); ubuf: 2·Np·n floats. *launches receives the CUDA
// launches issued.
int dg_mxu_fwd(int np, int n, int nk, int n_steps, int seg, int tile_l, int ghost,
               int threads, const double* rk, const float* tables, const float* inflow,
               const float* u0, float* traj, float* u_final, float* ubuf, int* launches,
               void* stream) {
  const FusedPlan p{seg, tile_l, ghost, threads};
  *launches = 0;
  if (n_steps < 1 || check_fwd_plan(n, nk, p) != 0) return -3;
  AOA_NP_SWITCH(np, fwd_np<NP>(n, nk, n_steps, p, rk, tables, inflow, u0, traj, u_final,
                               ubuf, launches, static_cast<cudaStream_t>(stream)))
}

// KM2 with the plan (seg = s_f, tile_l = L, ghost = W, threads).
// half_tables for the step dt/2; inflow: 10·n_steps values, stage j of the
// two residual half steps of step m at 10m + j. eta (n,) zeroed by the
// caller; lbuf: 2·Np·n floats. *launches receives the CUDA launches issued.
// -3: a plan the kernel does not take.
int dg_mxu_rev(int np, int n, int nk, int n_steps, int seg, int tile_l, int ghost,
               int threads, const double* rk, const float* half_tables,
               const float* inflow, const float* traj, const float* u_final,
               const float* lam_end, float* lam0, float* eta, float* lbuf,
               int* launches, void* stream) {
  const FusedPlan p{seg, tile_l, ghost, threads};
  *launches = 0;
  if (n_steps < 1 || check_rev_plan(np, n, nk, p) != 0) return -3;
  AOA_NP_SWITCH(np, rev_np<NP>(n, nk, n_steps, p, rk, half_tables, inflow, traj,
                               u_final, lam_end, lam0, eta, lbuf, launches,
                               static_cast<cudaStream_t>(stream)))
}

const char* dg_mxu_error_string(int code) {
  if (code == -1) return "unsupported Np (the kernels take 2 <= Np <= 8)";
  if (code == -3)
    return "plan out of range (KM1: 1 <= s_f <= 32, W >= 5*s_f unless one tile holds K; "
           "KM2: 1 <= s_f <= 16, W >= 10*s_f + 10, 1024 threads only at Np <= 6; both: "
           "512 or 1024 threads holding the window, n a multiple of K, B <= 65535, "
           "n_steps >= 1)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
