// Hand-written Hopper (sm_90a) kernels of the DG-advection fwd + adjoint +
// estimate pipeline, bound to Python with ctypes (plain C interface).
//
// K1  dg_fwd_march          replaces adjoint_ode_adaptivity_tpu/ops/pallas/
//                           dg_rhs.py:981 (_fwd_traj_grid_kernel_b); with no
//                           store it also serves :1017 (_fwd_grid_kernel_b) and
//                           :270 (_forward_kernel, B = 1); storing every
//                           segment-th entry state it is the checkpointing
//                           forward :880 (_fwd_ckpt_grid_kernel_b) and, at
//                           B = 1, :510 (_fwd_ckpt_grid_kernel). One kernel,
//                           fwd_fused, s_f steps a launch in every mode. At
//                           B = 1 from a global step offset, storing every
//                           step, it is the element-tiled forward KT1
//                           (ops/cuda/dg_tiled.py tiled_fwd_seg), which
//                           replaces dg_sharded.py:83 (_fwd_seg_kernel) and
//                           dg_tiled.py:282 (_fwd_seg_grid_kernel).
// K2  dg_adj_est_stored     replaces dg_rhs.py:1108 (_adj_est_grid_kernel_b_stored);
//                           at B = 1, from a global step offset and with η
//                           carried in, it is the element-tiled reverse KT2
//                           (ops/cuda/dg_tiled.py tiled_rev_seg), which
//                           replaces dg_sharded.py:107 (_rev_seg_kernel) and
//                           dg_tiled.py:314 (_rev_seg_grid_kernel).
// K2r dg_adj_est_recompute  replaces dg_rhs.py:908 (_adj_est_grid_kernel_b) and,
//                           at B = 1, :538 (_adj_est_grid_kernel) and :384
//                           (_adj_estimate_kernel): per checkpoint segment in
//                           reverse, the segment's segment + 1 states
//                           recomputed from its checkpoint by K1's kernel into
//                           a scratch of (segment + 1)·Np·B·K floats, then
//                           K2's sweep over the scratch, λ and η carried
//                           across segments.
// KA  dg_adj_march          replaces dg_rhs.py:335 (_adjoint_kernel): the pure
//                           coarse transpose march λ0 = (Lᵀ)ⁿ λN, full-dt tables;
//                           one kernel, adj_fused, s_f steps a launch.
//
// State layout (Np, B, K) float32, element axis K contiguous. Geometry is
// always per element (rx, fscale_left, fscale_right as (K,) vectors): the
// adaptive loop's meshes are graded, the uniform mesh is the special case.
// The per-element arithmetic is csrc/dg_stage.cuh's, every rounding
// explicit.
//
// K1, K2, K2r and KA: fused over s_f steps per launch. One CTA per (tile,
// member): blockIdx.x the tile of L local elements [lo, hi), blockIdx.y the
// member b; the CTA's window [lo − W, hi + W), clipped to [0, K), of member
// b's row, one thread per window element. Each thread keeps its element's u,
// r, rx, fsl, fsr (and in the reverse λu, λr, the η it accumulates and the
// trajectory entries u_n, u_{n+1} and the prefetched u_{n−1}; KA λu and
// λr) in registers for the whole launch. Only face values cross elements:
// per stage each thread posts two floats (forward: u[0], u[Np−1]; transposed: its own
// lifted contributions fsl·Σ ll·w and fsr·Σ lr·w) into a double-buffered
// trace array in shared memory, passes one __syncthreads, and reads its
// neighbours'. The transposed owner's contributions are the products a
// stage-per-launch transposed kernel recomputes from a neighbour's column,
// so a fused launch gives a stage-per-launch march's bits.
//
// Ghost rules (ops/pallas/dg_sharded.py:18-25): the flux couples ±1 element
// a stage (both faces: the error of a window's end spreads both ways) and
// the window's ends are wrong (the first element takes the inflow value, the
// last has no right face: exact at the domain's ends, harmless at a ghost
// edge). K1's s_f steps run 5·s_f stages, so W ≥ 5·s_f keeps every local
// element exact, and where one tile holds the whole mesh there are no
// ghosts. KA's transposed stages couple ±1 element the same way (each
// element reads both neighbours' lifted faces), 5 a step: W ≥ 5·s_f too. In
// the reverse the half steps run 10 stages a step from u_n, read
// exact from the trajectory, and λ's 10 transposed stages lose 10 elements a
// side, so W ≥ 10·s_f; K2's plan takes the repo's W = 10·s_f + 10. The
// state (K1's u, the reverse's λ) crosses launches through global ping-pong
// buffers, from which the neighbouring tiles read their ghosts: the launch
// boundary is the only grid sync, once per s_f steps. K1 stores the local
// entry state of every store_every-th global step (1: the trajectory;
// segment: the checkpoints; none: revolve's advance and the plain march),
// whatever s_f, and its last launch writes u_final. K2's η is loaded at a
// launch's start, accumulated η += Σ λ·(u_{n+1} − half2) in K2's order n =
// N−1 … 0 with __fadd_rn, and stored at its end; λ0 and η are written by
// local elements only. Stage times and inflow values are the host's double
// expression of the global step, passed per launch (FusedInflow), so a local
// element computes the per-stage kernels' bits, whatever the tiling. K2r
// recomputes each checkpoint segment with K1's kernel (the same windows)
// into the scratch, then runs K2's reverse over it.
//
// What bounds K1, K2, K2r and KA on the H100 now: issue. A stage is ~60
// instructions a warp (2·Np² + 9·Np + 4 FP32 operations an element, the
// rest the trace exchange, the barrier and indexing), so a launch lasts as
// long as its busiest SM takes to issue its warps' stages; the ghosts add
// 2W/L of recomputed work and each launch ~4 µs of start and tail. The
// wrappers pick s_f, the CTA size (512 or 1024 threads) and the tile count
// that balance the SMs under that model (ops/cuda/dg_rhs.py forward_plan,
// adjoint_plan, stored_plan, recompute_plan). Device memory sees K1's
// stores once (the trajectory at the headline: 1.97 GB, 0.59 ms at 3.35 TB/s, issued beside
// the stages), the trajectory once per window in the reverse (1 + 2W/L of
// its bytes) and the carried state once per launch. PERF.md holds the
// measured times.
//
// Np 2-16 (N = 1-15) take the same kernels: every array is sized by the
// template's NP and the folded tables ride the launch at kMaxNp = 16 (1.1 KB
// of parameters). At Np 9-16 the forward and adjoint kernels hold 40-64
// registers a thread at 1024 threads with no spill; the reverse takes 512
// threads there (113-128 registers; 8-148 bytes spilled at Np 13-16, 208-1588
// at 1024 threads), which stored_plan and recompute_plan keep to (nvcc
// -Xptxas -v, tools/torch_high_order_plans.py).
//
// Alternatives weighed. A cooperative kernel with grid.sync() per stage
// still syncs 5 (K1, KA) or 20 (K2) times a step across the whole card; a
// CUDA graph of a per-stage loop still runs a kernel a stage, each round-tripping
// the state through device memory. A thread-block-cluster halo through
// distributed shared memory would drop the ghost recompute inside a
// cluster; it is not measured.
//
// The inflow value −sin(a·t_s) reaches element 0 only (frozen to zero in the
// transpose).

#include <cuda_runtime.h>

#include "dg_stage.cuh"
#include "fused_window.cuh"

namespace {

using aoa_dg::Elem;
using aoa_dg::FusedInflow;
using aoa_dg::FusedPlan;
using aoa_dg::Geom;
using aoa_dg::RkCoef;
using aoa_dg::StepTables;
using aoa_dg::Traces;
using aoa_dg::dg_inflow;
using aoa_dg::elem_of;
using aoa_dg::fused_block;
using aoa_dg::load_col;
using aoa_dg::pack_tables;
using aoa_dg::rk_coef;
using aoa_dg::store_col;

// ----------------------------------- K1, K2, K2r, KA: fused over s_f steps

// The forward launch's table: stage s of its n-th step, global step
// n_first + n, at t0 + (n_first + n)·dt (the host's double expression).
FusedInflow fwd_inflow(double t0, double dt, double a, const double* rk,
                       long n_first, int steps) {
  FusedInflow f{};
  for (int n = 0; n < steps; ++n) {
    const double tn = t0 + static_cast<double>(n_first + n) * dt;
    for (int s = 0; s < 5; ++s) f.v[5 * n + s] = dg_inflow(a, tn, rk[10 + s], dt);
  }
  return f;
}

// One forward stage of the window: post the faces, one barrier, update.
template <int NP, int T>
__device__ __forceinline__ void window_fwd(Traces<T>& tr, int buf, const Elem& el,
                                           float* u, float* r, float* un, float rx,
                                           float fsl, float fsr,
                                           const StepTables& tab, int s,
                                           const RkCoef& rk, float uin) {
  const int e = threadIdx.x;
  tr.lo[buf][e] = u[0];
  tr.hi[buf][e] = u[NP - 1];
  __syncthreads();
  if (el.active) {
    const float left = el.first ? uin : tr.hi[buf][e - 1];
    const float right = el.last ? 0.f : tr.lo[buf][e + 1];
    aoa_dg::stage_fwd<NP>(u, left, right, el.last, rx, fsl, fsr, tab, s > 0,
                          rk.a[s], rk.b[s], r, un);
  }
}

// K1 and K2r's recompute: ``steps`` forward steps of the window from u_in,
// numbered n0 .. n0 + steps − 1 (K1: the global step; K2r: the step within
// its checkpoint segment). The local entry state of step n goes to
// store[n / store_every] where n % store_every == 0 and n >= store_from
// (store == nullptr: none), the local exit state to u_out. u_in may lie in
// store: K2r starts a launch from the scratch slot that the launch before
// wrote, and store_from skips it.
template <int NP, int T>
__global__ void __launch_bounds__(T)
fwd_fused(const float* u_in, float* store, float* u_out, Geom g,
          const __grid_constant__ StepTables full, RkCoef rk,
          const __grid_constant__ FusedInflow inflow, int nk, int tile_l,
          int ghost, int steps, int n0, int store_every, int store_from) {
  __shared__ Traces<T> tr;
  const Elem el = elem_of(nk, tile_l, ghost);
  const long bk = static_cast<long>(gridDim.y) * nk;
  const long size = NP * bk;
  const bool stores = store != nullptr && el.local;
  float u[NP] = {}, r[NP] = {}, un[NP] = {};
  float rx = 0.f, fsl = 0.f, fsr = 0.f;
  if (el.active) {
    rx = g.rx[el.k];
    fsl = g.fsl[el.k];
    fsr = g.fsr[el.k];
    load_col<NP>(u_in, el.c, bk, u);
  }
  int buf = 0;
  for (int n = n0; n < n0 + steps; ++n) {
    if (stores && n >= store_from && n % store_every == 0)
      store_col<NP>(store + (n / store_every) * size, el.c, bk, u);
#pragma unroll
    for (int s = 0; s < 5; ++s, buf ^= 1) {
      window_fwd<NP, T>(tr, buf, el, u, r, un, rx, fsl, fsr, full, s, rk,
                        inflow.v[5 * (n - n0) + s]);
#pragma unroll
      for (int i = 0; i < NP; ++i) u[i] = un[i];
    }
  }
  if (el.local) store_col<NP>(u_out, el.c, bk, u);
}

// K2's reverse over ``steps`` steps: traj[0 .. steps − 1] their entry states,
// u_top the state after the last. For n = steps − 1 … 0: two dt/2 steps from
// traj[n] whose last stage adds Σ λ·(u_{n+1} − half2) to η on the local
// elements, then two dt/2 transposed steps of λ. λ from lam_in (whole
// window), local λ to lam_out; eta (B, K) accumulated in place.
template <int NP, int T>
__global__ void __launch_bounds__(T)
rev_fused(const float* __restrict__ traj, const float* __restrict__ u_top,
          const float* __restrict__ lam_in, float* __restrict__ lam_out,
          float* __restrict__ eta, Geom g, const __grid_constant__ StepTables half,
          RkCoef rk, const __grid_constant__ FusedInflow inflow, int nk,
          int tile_l, int ghost, int steps) {
  __shared__ Traces<T> tr;
  const Elem el = elem_of(nk, tile_l, ghost);
  const int e = threadIdx.x;
  const long bk = static_cast<long>(gridDim.y) * nk;
  const long size = NP * bk;
  float lu[NP] = {}, lr[NP] = {}, cur[NP] = {}, nxt[NP] = {}, unp1[NP] = {};
  float rx = 0.f, fsl = 0.f, fsr = 0.f, acc = 0.f;
  if (el.active) {
    rx = g.rx[el.k];
    fsl = g.fsl[el.k];
    fsr = g.fsr[el.k];
    load_col<NP>(lam_in, el.c, bk, lu);
    load_col<NP>(traj + (steps - 1) * size, el.c, bk, cur);
    if (el.local) {
      load_col<NP>(u_top, el.c, bk, unp1);
      acc = eta[el.c];
    }
  }
  // 20 stages a step: stage j of each ten posts into buffer j & 1
  for (int n = steps - 1; n >= 0; --n) {
    // the next entry state is loaded while this step's 20 stages run
    if (el.active && n > 0) load_col<NP>(traj + (n - 1) * size, el.c, bk, nxt);
    float u[NP], r[NP] = {}, un[NP] = {};
#pragma unroll
    for (int i = 0; i < NP; ++i) u[i] = cur[i];
#pragma unroll
    for (int j = 0; j < 10; ++j) {
      window_fwd<NP, T>(tr, j & 1, el, u, r, un, rx, fsl, fsr, half, j % 5, rk,
                        inflow.v[10 * n + j]);
#pragma unroll
      for (int i = 0; i < NP; ++i) u[i] = un[i];
    }
    if (el.local) acc = __fadd_rn(acc, aoa_dg::residual_dot<NP>(lu, unp1, un));
#pragma unroll
    for (int j = 0; j < 10; ++j) {
      const int s = 4 - j % 5;
      const int buf = j & 1;
      float w[NP], s0, s1;
      aoa_dg::stage_w<NP>(lu, lr, s < 4, rk.b[s], w);
      aoa_dg::faces_t<NP>(w, el.last, fsl, fsr, half, &s0, &s1);
      tr.lo[buf][e] = s0;
      tr.hi[buf][e] = s1;
      __syncthreads();
      if (el.active) {
        const float p0 = el.last ? 0.f : tr.lo[buf][e + 1];
        const float p1 = el.first ? 0.f : tr.hi[buf][e - 1];
        float lu_new[NP];
        aoa_dg::stage_t<NP>(lu, w, s0, s1, p0, p1, rx, half, rk.a[s], lu_new, lr);
#pragma unroll
        for (int i = 0; i < NP; ++i) lu[i] = lu_new[i];
      }
    }
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      unp1[i] = cur[i];
      cur[i] = nxt[i];
    }
  }
  if (el.local) {
    store_col<NP>(lam_out, el.c, bk, lu);
    eta[el.c] = acc;
  }
}

// KA over ``steps`` steps of the window with the full-step tables: λ from
// lam_in (whole window), local λ to lam_out. Each step is 5 transposed
// stages (s = 4 … 0): w = b_s·λu + λr, post the own lifted faces, one
// barrier, λu += the transposed stage, λr = a_s·w.
template <int NP, int T>
__global__ void __launch_bounds__(T)
adj_fused(const float* __restrict__ lam_in, float* __restrict__ lam_out, Geom g,
          const __grid_constant__ StepTables full, RkCoef rk, int nk, int tile_l,
          int ghost, int steps) {
  __shared__ Traces<T> tr;
  const Elem el = elem_of(nk, tile_l, ghost);
  const int e = threadIdx.x;
  const long bk = static_cast<long>(gridDim.y) * nk;
  float lu[NP] = {}, lr[NP] = {};
  float rx = 0.f, fsl = 0.f, fsr = 0.f;
  if (el.active) {
    rx = g.rx[el.k];
    fsl = g.fsl[el.k];
    fsr = g.fsr[el.k];
    load_col<NP>(lam_in, el.c, bk, lu);
  }
  int buf = 0;
  for (int n = 0; n < steps; ++n) {
#pragma unroll
    for (int s = 4; s >= 0; --s, buf ^= 1) {
      float w[NP], s0, s1;
      aoa_dg::stage_w<NP>(lu, lr, s < 4, rk.b[s], w);
      aoa_dg::faces_t<NP>(w, el.last, fsl, fsr, full, &s0, &s1);
      tr.lo[buf][e] = s0;
      tr.hi[buf][e] = s1;
      __syncthreads();
      if (el.active) {
        const float p0 = el.last ? 0.f : tr.lo[buf][e + 1];
        const float p1 = el.first ? 0.f : tr.hi[buf][e - 1];
        float lu_new[NP];
        aoa_dg::stage_t<NP>(lu, w, s0, s1, p0, p1, rx, full, rk.a[s], lu_new, lr);
#pragma unroll
        for (int i = 0; i < NP; ++i) lu[i] = lu_new[i];
      }
    }
  }
  if (el.local) store_col<NP>(lam_out, el.c, bk, lu);
}

// The reverse over global steps n_first .. n_first + n_count − 1, whose entry
// states are traj[0 .. n_count − 1] and u_end the state after them, in
// launches of s_f steps from the top (the last launch takes the remainder).
// λ rides *lam through the ping-pong lbuf (2·Np·B·K floats); *j counts the
// reverse launches of the whole call, whose last (j == total − 1) writes
// lam0.
template <int NP, int T>
int rev_range(int nb, int nk, long n_first, int n_count, double t0, double dt,
              double a, const double* rk, const StepTables& half, Geom g,
              const FusedPlan& p, const float* traj, const float* u_end,
              const float** lam, int* j, int total, float* lam0, float* eta,
              float* lbuf, cudaStream_t stream) {
  const long size = static_cast<long>(NP) * nb * nk;
  const dim3 grid((nk + p.tile_l - 1) / p.tile_l, nb);
  const int block = fused_block(nk, p);
  const RkCoef coef = rk_coef(rk);
  const double h = dt / 2;
  for (int hi = n_count; hi > 0; hi -= p.seg) {
    const int lo = hi > p.seg ? hi - p.seg : 0;
    FusedInflow inflow{};
    for (int n = 0; n < hi - lo; ++n) {
      const double tn = t0 + static_cast<double>(n_first + lo + n) * dt;
      for (int hs = 0; hs < 2; ++hs) {
        const double th = tn + hs * h;
        for (int s = 0; s < 5; ++s) inflow.v[10 * n + 5 * hs + s] = dg_inflow(a, th, rk[10 + s], h);
      }
    }
    float* out = *j == total - 1 ? lam0 : lbuf + (*j % 2) * size;
    rev_fused<NP, T><<<grid, block, 0, stream>>>(
        traj + lo * size, hi == n_count ? u_end : traj + hi * size, *lam, out,
        eta, g, half, coef, inflow, nk, p.tile_l, p.ghost, hi - lo);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    *lam = out;
    ++*j;
  }
  return 0;
}

// K1: n_steps forward steps from u0, the global steps n_first .. n_first +
// n_steps − 1 (step n at t0 + n·dt), in launches of s_f steps (the last
// takes the remainder), the entry state of every store_every-th step of the
// call to store (nullptr: none; the index counts from the call's first
// step). The state crosses launches through the ping-pong ubuf (2·Np·B·K
// floats), from which the neighbouring tiles read their ghosts; the last
// launch writes u_final. *launches counts the launches.
template <int NP, int T>
int fwd_march_impl(int nb, int nk, int n_steps, int store_every, int n_first,
                   double t0, double dt, double a, const double* rk, const float* tables,
                   Geom g, const FusedPlan& p, const float* u0, float* store,
                   float* u_final, float* ubuf, int* launches,
                   cudaStream_t stream) {
  const StepTables full = pack_tables(NP, tables);
  const RkCoef coef = rk_coef(rk);
  const long size = static_cast<long>(NP) * nb * nk;
  const dim3 grid((nk + p.tile_l - 1) / p.tile_l, nb);
  const int block = fused_block(nk, p);
  const float* cur = u0;
  for (int lo = 0; lo < n_steps; lo += p.seg) {
    const int steps = n_steps - lo < p.seg ? n_steps - lo : p.seg;
    float* out = lo + steps == n_steps ? u_final : ubuf + (*launches % 2) * size;
    fwd_fused<NP, T><<<grid, block, 0, stream>>>(
        cur, store, out, g, full, coef,
        fwd_inflow(t0, dt, a, rk, static_cast<long>(n_first) + lo, steps), nk, p.tile_l,
        p.ghost, steps, lo, store_every, 0);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    ++*launches;
    cur = out;
  }
  return 0;
}

// KA: n_steps transposed steps from lam_end in launches of s_f steps (the
// last takes the remainder). λ crosses launches through the ping-pong lbuf
// (2·Np·B·K floats), from which the neighbouring tiles read their ghosts;
// the last launch writes lam0. *launches counts the launches.
template <int NP, int T>
int adj_march_impl(int nb, int nk, int n_steps, const double* rk,
                   const float* tables, Geom g, const FusedPlan& p,
                   const float* lam_end, float* lam0, float* lbuf, int* launches,
                   cudaStream_t stream) {
  const StepTables full = pack_tables(NP, tables);
  const RkCoef coef = rk_coef(rk);
  const long size = static_cast<long>(NP) * nb * nk;
  const dim3 grid((nk + p.tile_l - 1) / p.tile_l, nb);
  const int block = fused_block(nk, p);
  const float* cur = lam_end;
  for (int lo = 0; lo < n_steps; lo += p.seg) {
    const int steps = n_steps - lo < p.seg ? n_steps - lo : p.seg;
    float* out = lo + steps == n_steps ? lam0 : lbuf + (*launches % 2) * size;
    adj_fused<NP, T><<<grid, block, 0, stream>>>(cur, out, g, full, coef, nk,
                                                 p.tile_l, p.ghost, steps);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    ++*launches;
    cur = out;
  }
  return 0;
}

template <int NP, int T>
int adj_est_stored_impl(int nb, int nk, int n_steps, int n_first, double t0,
                        double dt, double a, const double* rk,
                        const float* half_tables, Geom g, const FusedPlan& p,
                        const float* traj, const float* u_final,
                        const float* lam_end, float* lam0, float* eta,
                        float* lbuf, int* launches, cudaStream_t stream) {
  const StepTables half = pack_tables(NP, half_tables);
  const float* lam = lam_end;
  const int total = (n_steps + p.seg - 1) / p.seg;
  const int err = rev_range<NP, T>(nb, nk, n_first, n_steps, t0, dt, a, rk, half, g, p,
                                   traj, u_final, &lam, launches, total, lam0, eta,
                                   lbuf, stream);
  return err != 0 ? err : static_cast<int>(cudaGetLastError());
}

template <int NP, int T>
int adj_est_recompute_impl(int nb, int nk, int n_steps, int segment, double t0,
                           double dt, double a, const double* rk,
                           const float* tables, const float* half_tables,
                           Geom g, const FusedPlan& p, const float* ckpt,
                           const float* lam_end, float* lam0, float* eta,
                           float* scratch, float* lbuf, int* launches,
                           cudaStream_t stream) {
  const StepTables full = pack_tables(NP, tables);
  const StepTables half = pack_tables(NP, half_tables);
  const RkCoef coef = rk_coef(rk);
  const long size = static_cast<long>(NP) * nb * nk;
  const dim3 grid((nk + p.tile_l - 1) / p.tile_l, nb);
  const int block = fused_block(nk, p);
  const int per_seg = (segment + p.seg - 1) / p.seg;
  const int total = n_steps / segment * per_seg;
  const float* lam = lam_end;
  int j = 0;
  for (int si = n_steps / segment - 1; si >= 0; --si) {
    const long n_first = static_cast<long>(si) * segment;
    for (int lo = 0; lo < segment; lo += p.seg) {
      const int steps = segment - lo < p.seg ? segment - lo : p.seg;
      const float* src = lo == 0 ? ckpt + si * size : scratch + lo * size;
      fwd_fused<NP, T><<<grid, block, 0, stream>>>(
          src, scratch, scratch + (lo + steps) * size, g, full, coef,
          fwd_inflow(t0, dt, a, rk, n_first + lo, steps), nk, p.tile_l, p.ghost,
          steps, lo, 1, lo == 0 ? 0 : lo + 1);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
      ++*launches;
    }
    const int err = rev_range<NP, T>(nb, nk, n_first, segment, t0, dt, a, rk, half,
                                     g, p, scratch, scratch + segment * size, &lam,
                                     &j, total, lam0, eta, lbuf, stream);
    if (err != 0) return err;
  }
  *launches += j;
  return static_cast<int>(cudaGetLastError());
}

// -3 unless the plan is one the reverse kernels take (aoa_dg::rev_plan_ok).
int check_plan(int nk, const FusedPlan& p) {
  return aoa_dg::rev_plan_ok(nk, p) ? 0 : -3;
}

// -4 unless K1 takes the plan (aoa_dg::fwd_plan_ok).
int check_fwd_plan(int nk, const FusedPlan& p) {
  return aoa_dg::fwd_plan_ok(nk, p) ? 0 : -4;
}

// -5 unless KA takes the plan: K1's rules (a transposed stage couples ±1
// element as a forward stage does), with s_f ≤ kMaxFwdFused.
int check_adj_plan(int nk, const FusedPlan& p) {
  return check_fwd_plan(nk, p) == 0 ? 0 : -5;
}

}  // namespace

// The CTA size picks the kernels' instance: __launch_bounds__(T) sets the
// register budget (128 a thread at 512, 64 at 1024).
#define AOA_FUSED_SWITCH(p, CALL)                 \
  switch ((p).threads) {                          \
    case 512: { constexpr int T = 512; return CALL; }   \
    case 1024: { constexpr int T = 1024; return CALL; } \
    default: return -3;                           \
  }

namespace {

template <int NP>
int fwd_march_np(int nb, int nk, int n_steps, int store_every, int n_first,
                 double t0, double dt, double a, const double* rk,
                 const float* tables, Geom g, const FusedPlan& p, const float* u0,
                 float* store, float* u_final, float* ubuf, int* launches,
                 cudaStream_t stream) {
  AOA_FUSED_SWITCH(p, (fwd_march_impl<NP, T>(nb, nk, n_steps, store_every,
                                             n_first, t0, dt, a, rk, tables, g, p,
                                             u0, store, u_final, ubuf, launches,
                                             stream)))
}

template <int NP>
int adj_est_stored_np(int nb, int nk, int n_steps, int n_first, double t0,
                      double dt, double a, const double* rk,
                      const float* half_tables, Geom g, const FusedPlan& p,
                      const float* traj, const float* u_final,
                      const float* lam_end, float* lam0, float* eta, float* lbuf,
                      int* launches, cudaStream_t stream) {
  AOA_FUSED_SWITCH(p, (adj_est_stored_impl<NP, T>(
                          nb, nk, n_steps, n_first, t0, dt, a, rk, half_tables, g,
                          p, traj, u_final, lam_end, lam0, eta, lbuf, launches,
                          stream)))
}

template <int NP>
int adj_est_recompute_np(int nb, int nk, int n_steps, int segment, double t0,
                         double dt, double a, const double* rk,
                         const float* tables, const float* half_tables, Geom g,
                         const FusedPlan& p, const float* ckpt,
                         const float* lam_end, float* lam0, float* eta,
                         float* scratch, float* lbuf, int* launches,
                         cudaStream_t stream) {
  AOA_FUSED_SWITCH(p, (adj_est_recompute_impl<NP, T>(
                          nb, nk, n_steps, segment, t0, dt, a, rk, tables,
                          half_tables, g, p, ckpt, lam_end, lam0, eta, scratch,
                          lbuf, launches, stream)))
}

template <int NP>
int adj_march_np(int nb, int nk, int n_steps, const double* rk,
                 const float* tables, Geom g, const FusedPlan& p,
                 const float* lam_end, float* lam0, float* lbuf, int* launches,
                 cudaStream_t stream) {
  AOA_FUSED_SWITCH(p, (adj_march_impl<NP, T>(nb, nk, n_steps, rk, tables, g, p,
                                             lam_end, lam0, lbuf, launches, stream)))
}

}  // namespace

extern "C" {

// K1 (and KT1 at B = 1) with the plan (seg = s_f, tile_l = L, ghost = W,
// threads) over the global steps n_first .. n_first + n_steps − 1: step n of
// the call starts at t0 + (n_first + n)·dt. Returns 0 on success, a
// cudaError_t code after a failed launch, -1 for an unsupported Np, -4 for a
// plan K1 does not take (or n_first < 0). ubuf holds 2·Np·B·K floats. store
// (optional) receives the entry state of every store_every-th step of the
// call: (⌈n_steps / store_every⌉, Np, B, K). *launches receives the CUDA
// launches issued.
int dg_fwd_march(int np, int nb, int nk, int n_steps, int store_every,
                 int n_first, int seg, int tile_l, int ghost, int threads,
                 double t0, double dt,
                 double a, const double* rk, const float* tables,
                 const float* rx, const float* fsl, const float* fsr,
                 const float* u0, float* store, float* u_final, float* ubuf,
                 int* launches, void* stream) {
  const Geom g{rx, fsl, fsr};
  const FusedPlan p{seg, tile_l, ghost, threads};
  *launches = 0;
  if (check_fwd_plan(nk, p) != 0 || n_steps < 1 || store_every < 1 || n_first < 0)
    return -4;
  AOA_NP16_SWITCH(np, fwd_march_np<NP>(nb, nk, n_steps, store_every, n_first, t0, dt,
                                       a, rk, tables, g, p, u0, store, u_final, ubuf,
                                       launches, static_cast<cudaStream_t>(stream)))
}

// K2 (and KT2 at B = 1) with the plan (seg = s_f, tile_l = L, ghost = W,
// threads) over the n_steps steps of traj, the global steps n_first ..
// n_first + n_steps − 1: step n of traj starts at t0 + (n_first + n)·dt.
// eta holds the η carried in (zeros for a whole sweep), accumulated in
// place in the order n = n_steps − 1 … 0; lbuf holds 2·Np·B·K floats;
// half_tables are folded for the step dt/2. *launches receives the CUDA
// launches issued. -3: a plan the kernels do not take, or n_steps < 1 or
// n_first < 0.
int dg_adj_est_stored(int np, int nb, int nk, int n_steps, int n_first, int seg,
                      int tile_l, int ghost, int threads, double t0, double dt,
                      double a, const double* rk, const float* half_tables,
                      const float* rx, const float* fsl, const float* fsr,
                      const float* traj, const float* u_final,
                      const float* lam_end, float* lam0, float* eta,
                      float* lbuf, int* launches, void* stream) {
  const Geom g{rx, fsl, fsr};
  const FusedPlan p{seg, tile_l, ghost, threads};
  *launches = 0;
  if (check_plan(nk, p) != 0 || n_steps < 1 || n_first < 0) return -3;
  AOA_NP16_SWITCH(np, adj_est_stored_np<NP>(
                          nb, nk, n_steps, n_first, t0, dt, a, rk, half_tables, g, p,
                          traj, u_final, lam_end, lam0, eta, lbuf, launches,
                          static_cast<cudaStream_t>(stream)))
}

// K2r: ckpt (n_steps / segment, Np, B, K), K1's checkpoints; scratch holds
// (segment + 1)·Np·B·K floats; eta zeroed by the caller; lbuf, the plan and
// *launches as for dg_adj_est_stored. tables: step dt (the recompute),
// half_tables: dt/2.
int dg_adj_est_recompute(int np, int nb, int nk, int n_steps, int segment,
                         int seg, int tile_l, int ghost, int threads, double t0,
                         double dt, double a, const double* rk,
                         const float* tables, const float* half_tables,
                         const float* rx, const float* fsl, const float* fsr,
                         const float* ckpt, const float* lam_end, float* lam0,
                         float* eta, float* scratch, float* lbuf,
                         int* launches, void* stream) {
  const Geom g{rx, fsl, fsr};
  const FusedPlan p{seg, tile_l, ghost, threads};
  *launches = 0;
  if (check_plan(nk, p) != 0 || segment < 1 || n_steps % segment != 0) return -3;
  AOA_NP16_SWITCH(np, adj_est_recompute_np<NP>(
                          nb, nk, n_steps, segment, t0, dt, a, rk, tables,
                          half_tables, g, p, ckpt, lam_end, lam0, eta, scratch,
                          lbuf, launches, static_cast<cudaStream_t>(stream)))
}

// KA with the plan (seg = s_f, tile_l = L, ghost = W, threads): λ0 =
// (Lᵀ)^n_steps λ_end with the step-dt tables; lbuf holds 2·Np·B·K floats.
// *launches receives the CUDA launches issued. -5: a plan KA does not take.
int dg_adj_march(int np, int nb, int nk, int n_steps, int seg, int tile_l,
                 int ghost, int threads, const double* rk, const float* tables,
                 const float* rx, const float* fsl, const float* fsr,
                 const float* lam_end, float* lam0, float* lbuf, int* launches,
                 void* stream) {
  const Geom g{rx, fsl, fsr};
  const FusedPlan p{seg, tile_l, ghost, threads};
  *launches = 0;
  if (check_adj_plan(nk, p) != 0 || n_steps < 1) return -5;
  AOA_NP16_SWITCH(np, adj_march_np<NP>(nb, nk, n_steps, rk, tables, g, p, lam_end,
                                       lam0, lbuf, launches,
                                       static_cast<cudaStream_t>(stream)))
}

const char* dg_error_string(int code) {
  if (code == -1) return "unsupported Np (the kernels take 2 <= Np <= 16)";
  if (code == -3)
    return "fused plan out of range (1 <= s_f <= 16, W >= 10*s_f + 10, 512 or "
           "1024 threads holding the window; n_steps >= 1, a multiple of segment; "
           "n_first >= 0)";
  if (code == -4)
    return "K1 plan out of range (1 <= s_f <= 32, W >= 5*s_f unless one tile "
           "holds the mesh, 512 or 1024 threads holding the window; n_steps and "
           "store_every >= 1, n_first >= 0)";
  if (code == -5)
    return "KA plan out of range (1 <= s_f <= 32, W >= 5*s_f unless one tile "
           "holds the mesh, 512 or 1024 threads holding the window; n_steps >= 1)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
