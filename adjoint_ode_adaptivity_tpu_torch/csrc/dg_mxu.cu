// Hand-written Hopper (sm_90a) kernels of the DG-advection pipeline in the
// MXU layout: the state is ONE (Np, N) array, N = B·K columns (the (B, K)
// states flattened), and the volume term is a tile product of the (Np, Np)
// table by an (Np, columns) tile of the state. Plain C interface, bound
// with ctypes.
//
// KM1 dg_mxu_fwd  replaces adjoint_ode_adaptivity_tpu/ops/pallas/dg_mxu.py:151
//                 (_fwd_traj_kernel_m): the LSRK4(5) march storing every
//                 entry state in a (n_steps, Np, N) trajectory.
// KM2 dg_mxu_rev  replaces dg_mxu.py:179 (_adj_est_kernel_m): per step in
//                 reverse, two dt/2 residual steps from the stored u_n,
//                 η += Σ_rows λ·(u_{n+1} − half2), two dt/2 transposed steps.
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
// Launches. The TPU kernel keeps the whole (Np, N) state in VMEM for
// `segment` steps per grid point; at the timed row (N = 7, K = 10⁴, B = 8)
// the state is 2.5 MB, past one CTA's shared memory, and every stage needs
// the neighbours' traces of the stage's input. So, as K1/K2 (csrc/dg_rhs.cu),
// each stage is one launch over read-only inputs into separate outputs
// (ping-pong): 5 launches a step forward, 20 in reverse. A CTA owns kTile
// columns: it stages drc and its column tile (all Np rows, one halo column
// each side) in shared memory, and each thread keeps a register tile of
// Np × kPerThread outputs (columns tid + p·kThreads, conflict-free).
//
// What bounds it. The least time for the work is set by its operations
// (2·Np² + 9·Np + 4 per column and stage, against 4·Np·N·4 bytes of state a
// stage that a fused kernel would not move): at N = 7, K = 10⁴, B = 8 and 256
// steps, 0.31 ms for KM1 and 1.25 ms for KM2. What bounds these kernels as
// written is the launch per stage (6,400 launches at that row, each a few µs,
// the same count as K1/K2) and the state's round trip through device memory
// every stage, not the tile product of the volume term. PERF.md
// holds the card's times beside K1/K2's (chip_smoke.py phase 27).

#include <cuda_runtime.h>

#include "dg_stage.cuh"

namespace {

using aoa_dg::RkCoef;
using aoa_dg::StepTables;
using aoa_dg::pack_tables;
using aoa_dg::rk_coef;

constexpr int kThreads = 128;
constexpr int kPerThread = 2;
constexpr int kTile = kThreads * kPerThread;
constexpr int kHalo = kTile + 2;  // column cc of the tile at index cc + 1

// Loads drc into sd and the tile's columns [c0 − 1, c0 + kTile] of every row
// of x into sx (zero outside [0, n)).
template <int NP>
__device__ __forceinline__ void stage_tile(const float* __restrict__ x,
                                           const StepTables& tab, float* sd,
                                           float (*sx)[kHalo], int c0, int n) {
  for (int i = threadIdx.x; i < NP * NP; i += kThreads) sd[i] = tab.drc[i];
  for (int e = threadIdx.x; e < NP * kHalo; e += kThreads) {
    const int i = e / kHalo;
    const int c = c0 + e % kHalo - 1;
    sx[i][e % kHalo] = (c >= 0 && c < n) ? x[static_cast<long>(i) * n + c] : 0.f;
  }
}

// acc[i][p] = Σ_m d[i][m]·x[m][col p] over m = 0 … Np−1 in order (d row-major,
// transposed when TRANS: d[m][i]).
template <int NP, bool TRANS>
__device__ __forceinline__ void tile_product(const float* sd,
                                             float (*sx)[kHalo],
                                             float (&acc)[NP][kPerThread]) {
#pragma unroll
  for (int m = 0; m < NP; ++m) {
    float x[kPerThread];
#pragma unroll
    for (int p = 0; p < kPerThread; ++p) x[p] = sx[m][threadIdx.x + p * kThreads + 1];
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      const float d = TRANS ? sd[m * NP + i] : sd[i * NP + m];
#pragma unroll
      for (int p = 0; p < kPerThread; ++p) {
        acc[i][p] = m == 0 ? __fmul_rn(d, x[p]) : __fadd_rn(acc[i][p], __fmul_rn(d, x[p]));
      }
    }
  }
}

// One forward LSRK stage: r = A_s·r_in + rhs(u_in), u_out = u_in + B_s·r.
// r_in == nullptr: stage 0 (r = rhs); r_out == nullptr drops r (stage 4).
// traj_out != nullptr stores the stage input (the step's entry state).
// eta != nullptr (the last residual stage) accumulates
// η[c] += Σ_i λ_i·(u_next_i − u_new_i) instead of writing u and r.
template <int NP>
__global__ void __launch_bounds__(kThreads)
km_stage(const float* __restrict__ u_in, const float* __restrict__ r_in,
         float* __restrict__ u_out, float* __restrict__ r_out,
         float* __restrict__ traj_out, const float* __restrict__ lam,
         const float* __restrict__ u_next, float* __restrict__ eta,
         StepTables tab, float a_s, float b_s, float uin, int n, int nk) {
  __shared__ float sd[NP * NP];
  __shared__ float su[NP][kHalo];
  const int c0 = blockIdx.x * kTile;
  stage_tile<NP>(u_in, tab, sd, su, c0, n);
  __syncthreads();
  float acc[NP][kPerThread];
  tile_product<NP, false>(sd, su, acc);
#pragma unroll
  for (int p = 0; p < kPerThread; ++p) {
    const int cc = threadIdx.x + p * kThreads;
    const int c = c0 + cc;
    if (c >= n) continue;
    const int k = c % nk;
    const bool last = k == nk - 1;
    const float du_l = __fsub_rn(su[0][cc + 1], k == 0 ? uin : su[NP - 1][cc]);
    const float du_r = last ? 0.f : __fsub_rn(su[NP - 1][cc + 1], su[0][cc + 2]);
    float un[NP];
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      const long at = static_cast<long>(i) * n + c;
      const float u = su[i][cc + 1];
      const float rhs = __fadd_rn(__fadd_rn(acc[i][p], __fmul_rn(tab.ll[i], du_l)),
                                  __fmul_rn(tab.lr[i], du_r));
      const float r = r_in != nullptr ? __fadd_rn(__fmul_rn(a_s, r_in[at]), rhs) : rhs;
      un[i] = __fadd_rn(u, __fmul_rn(b_s, r));
      if (traj_out != nullptr) traj_out[at] = u;
      if (eta == nullptr) {
        u_out[at] = un[i];
        if (r_out != nullptr) r_out[at] = r;
      }
    }
    if (eta != nullptr) {
      float e = 0.f;
#pragma unroll
      for (int i = 0; i < NP; ++i) {
        const long at = static_cast<long>(i) * n + c;
        const float t = __fmul_rn(lam[at], __fsub_rn(u_next[at], un[i]));
        e = i == 0 ? t : __fadd_rn(e, t);
      }
      eta[c] = __fadd_rn(eta[c], e);
    }
  }
}

// Σ_i coef[i]·w[i] over i = 0 … Np−1 in order.
template <int NP>
__device__ __forceinline__ float row_dot(const float* coef, float (*sw)[kHalo],
                                         int col) {
  float s = __fmul_rn(coef[0], sw[0][col]);
#pragma unroll
  for (int i = 1; i < NP; ++i) s = __fadd_rn(s, __fmul_rn(coef[i], sw[i][col]));
  return s;
}

// One transposed stage (stages run 4 … 0): w = B_s·λu + λr (λr == nullptr:
// stage 4, λr = 0); λr_out = A_s·w (nullptr: stage 0, dropped);
// λu_out = (λu + drcᵀw) + the edge rows.
template <int NP>
__global__ void __launch_bounds__(kThreads)
km_stage_t(const float* __restrict__ lu_in, const float* __restrict__ lr_in,
           float* __restrict__ lu_out, float* __restrict__ lr_out,
           StepTables tab, float a_s, float b_s, int n, int nk) {
  __shared__ float sd[NP * NP];
  __shared__ float sw[NP][kHalo];
  __shared__ float sw0[kHalo];
  __shared__ float sw1[kHalo];
  const int c0 = blockIdx.x * kTile;
  for (int i = threadIdx.x; i < NP * NP; i += kThreads) sd[i] = tab.drc[i];
  for (int e = threadIdx.x; e < NP * kHalo; e += kThreads) {
    const int i = e / kHalo;
    const int c = c0 + e % kHalo - 1;
    float w = 0.f;
    if (c >= 0 && c < n) {
      const long at = static_cast<long>(i) * n + c;
      w = __fmul_rn(b_s, lu_in[at]);
      if (lr_in != nullptr) w = __fadd_rn(w, lr_in[at]);
    }
    sw[i][e % kHalo] = w;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < kHalo; e += kThreads) {
    sw0[e] = row_dot<NP>(tab.ll, sw, e);
    sw1[e] = row_dot<NP>(tab.lr, sw, e);
  }
  __syncthreads();
  float acc[NP][kPerThread];
  tile_product<NP, true>(sd, sw, acc);
#pragma unroll
  for (int p = 0; p < kPerThread; ++p) {
    const int cc = threadIdx.x + p * kThreads;
    const int c = c0 + cc;
    if (c >= n) continue;
    const int k = c % nk;
    const bool first = k == 0;
    const bool last = k == nk - 1;
    const float s1 = last ? 0.f : sw1[cc + 1];
    const float p0 = last ? 0.f : sw0[cc + 2];
    const float p1 = first ? 0.f : sw1[cc];
#pragma unroll
    for (int j = 0; j < NP; ++j) {
      const long at = static_cast<long>(j) * n + c;
      float v = __fadd_rn(lu_in[at], acc[j][p]);
      if (j == 0) v = __fadd_rn(v, __fsub_rn(sw0[cc + 1], p1));
      if (j == NP - 1) v = __fadd_rn(v, __fsub_rn(s1, p0));
      lu_out[at] = v;
      if (lr_out != nullptr) lr_out[at] = __fmul_rn(a_s, sw[j][cc + 1]);
    }
  }
}

inline int launch_error() { return static_cast<int>(cudaGetLastError()); }

template <int NP>
int fwd_impl(int n, int nk, int n_steps, const double* rk, const float* tables,
             const float* inflow, const float* u0, float* traj, float* u_final,
             float* ubuf, float* rbuf, cudaStream_t stream) {
  const StepTables tab = pack_tables(NP, tables);
  const RkCoef c = rk_coef(rk);
  const long size = static_cast<long>(NP) * n;
  const int blocks = (n + kTile - 1) / kTile;
  const float* u_cur = u0;
  const float* r_cur = nullptr;
  const long total = 5L * n_steps;
  long j = 0;
  for (int step = 0; step < n_steps; ++step) {
    for (int s = 0; s < 5; ++s, ++j) {
      float* u_nxt = j == total - 1 ? u_final : ubuf + (j % 2) * size;
      float* r_nxt = s == 4 ? nullptr : rbuf + (j % 2) * size;
      km_stage<NP><<<blocks, kThreads, 0, stream>>>(
          u_cur, s == 0 ? nullptr : r_cur, u_nxt, r_nxt,
          s == 0 ? traj + step * size : nullptr, nullptr, nullptr, nullptr, tab,
          c.a[s], c.b[s], inflow[j], n, nk);
      const int err = launch_error();
      if (err != 0) return err;
      u_cur = u_nxt;
      r_cur = r_nxt;
    }
  }
  return 0;
}

template <int NP>
int rev_impl(int n, int nk, int n_steps, const double* rk,
             const float* half_tables, const float* inflow, const float* traj,
             const float* u_final, const float* lam_end, float* lam0,
             float* eta, float* ubuf, float* rbuf, float* lubuf, float* lrbuf,
             cudaStream_t stream) {
  const StepTables half = pack_tables(NP, half_tables);
  const RkCoef c = rk_coef(rk);
  const long size = static_cast<long>(NP) * n;
  const int blocks = (n + kTile - 1) / kTile;
  const float* lu = lam_end;
  const long total_t = 10L * n_steps;
  long jt = 0;
  for (int step = n_steps - 1; step >= 0; --step) {
    const float* u_np1 = step == n_steps - 1 ? u_final : traj + (step + 1) * size;
    const float* u_cur = traj + step * size;
    const float* r_cur = nullptr;
    for (int j = 0; j < 10; ++j) {  // two dt/2 steps; the last stage adds η
      const int s = j % 5;
      const bool last = j == 9;
      float* u_nxt = last ? nullptr : ubuf + (j % 2) * size;
      float* r_nxt = s == 4 ? nullptr : rbuf + (j % 2) * size;
      km_stage<NP><<<blocks, kThreads, 0, stream>>>(
          u_cur, s == 0 ? nullptr : r_cur, u_nxt, r_nxt, nullptr,
          last ? lu : nullptr, last ? u_np1 : nullptr, last ? eta : nullptr, half,
          c.a[s], c.b[s], inflow[10L * step + j], n, nk);
      const int err = launch_error();
      if (err != 0) return err;
      u_cur = u_nxt;
      r_cur = r_nxt;
    }
    const float* lr_cur = nullptr;
    for (int j = 0; j < 10; ++j, ++jt) {  // two dt/2 transposed steps
      const int s = 4 - j % 5;
      float* lu_nxt = jt == total_t - 1 ? lam0 : lubuf + (jt % 2) * size;
      float* lr_nxt = s == 0 ? nullptr : lrbuf + (jt % 2) * size;
      km_stage_t<NP><<<blocks, kThreads, 0, stream>>>(
          lu, s == 4 ? nullptr : lr_cur, lu_nxt, lr_nxt, half, c.a[s], c.b[s], n, nk);
      const int err = launch_error();
      if (err != 0) return err;
      lu = lu_nxt;
      lr_cur = lr_nxt;
    }
  }
  return 0;
}

}  // namespace

extern "C" {

// Returns 0 on success, a cudaError_t code after a failed launch, or -1 for
// an unsupported Np. n = B·K columns, nk = K. tables: float32 [drc (Np, Np)
// row-major, liftl (Np), liftr (Np)] for the step dt; inflow: 5·n_steps
// values, stage s of step m at 5m + s. traj: (n_steps, Np, n); ubuf, rbuf:
// 2·Np·n floats each.
int dg_mxu_fwd(int np, int n, int nk, int n_steps, const double* rk,
               const float* tables, const float* inflow, const float* u0,
               float* traj, float* u_final, float* ubuf, float* rbuf,
               void* stream) {
  AOA_NP_SWITCH(np, fwd_impl<NP>(n, nk, n_steps, rk, tables, inflow, u0, traj,
                                 u_final, ubuf, rbuf,
                                 static_cast<cudaStream_t>(stream)))
}

// half_tables for the step dt/2; inflow: 10·n_steps values, stage j of the
// two residual half steps of step m at 10m + j. eta (n,) zeroed by the
// caller; ubuf, rbuf, lubuf, lrbuf: 2·Np·n floats each.
int dg_mxu_rev(int np, int n, int nk, int n_steps, const double* rk,
               const float* half_tables, const float* inflow, const float* traj,
               const float* u_final, const float* lam_end, float* lam0,
               float* eta, float* ubuf, float* rbuf, float* lubuf, float* lrbuf,
               void* stream) {
  AOA_NP_SWITCH(np, rev_impl<NP>(n, nk, n_steps, rk, half_tables, inflow, traj,
                                 u_final, lam_end, lam0, eta, ubuf, rbuf, lubuf,
                                 lrbuf, static_cast<cudaStream_t>(stream)))
}

const char* dg_mxu_error_string(int code) {
  if (code == -1) return "unsupported Np (the kernels take 2 <= Np <= 8)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
