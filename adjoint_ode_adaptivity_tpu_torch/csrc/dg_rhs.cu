// Hand-written Hopper (sm_90a) kernels of the DG-advection fwd + adjoint +
// estimate pipeline, bound to Python with ctypes (plain C interface).
//
// K1  dg_fwd_march          replaces adjoint_ode_adaptivity_tpu/ops/pallas/
//                           dg_rhs.py:981 (_fwd_traj_grid_kernel_b); with no
//                           store it also serves :1017 (_fwd_grid_kernel_b) and
//                           :270 (_forward_kernel, B = 1); storing every
//                           segment-th entry state it is the checkpointing
//                           forward :880 (_fwd_ckpt_grid_kernel_b) and, at
//                           B = 1, :510 (_fwd_ckpt_grid_kernel).
// K2  dg_adj_est_stored     replaces dg_rhs.py:1108 (_adj_est_grid_kernel_b_stored).
// K2r dg_adj_est_recompute  replaces dg_rhs.py:908 (_adj_est_grid_kernel_b) and,
//                           at B = 1, :538 (_adj_est_grid_kernel) and :384
//                           (_adj_estimate_kernel): per segment in reverse, the
//                           segment's segment + 1 states recomputed from its
//                           checkpoint into a scratch of (segment + 1)·Np·B·K
//                           floats with K1's stage kernel, then K2's sweep
//                           over the scratch, λ and η carried across segments.
// KA  dg_adj_march          replaces dg_rhs.py:335 (_adjoint_kernel): the pure
//                           coarse transpose march λ0 = (Lᵀ)ⁿ λN, full-dt tables.
//
// State layout (Np, B, K) float32, element axis K contiguous: thread c owns
// column c = b·K + k and holds its Np nodes in registers, so neighbouring
// threads read neighbouring elements (coalesced). Geometry is always per
// element (rx, fscale_left, fscale_right as (K,) vectors): the adaptive loop's
// meshes are graded, the uniform mesh is the special case. The per-element
// arithmetic is csrc/dg_stage.cuh's, shared with the tiled kernels.
//
// Sync across elements: every LSRK stage needs the neighbours' face traces
// (u[Np-1] of element k-1, u[0] of element k+1) at the stage's INPUT state.
// Blocks run in no order on Hopper, so each stage is one launch that reads
// read-only input buffers and writes separate output buffers (ping-pong); the
// launch boundary is the grid-wide sync. The host loops below drive all
// launches of one phase from one C call. The transpose stage needs the
// neighbours' lifted cotangents; each thread recomputes them from the
// neighbours' (λu, λr) columns instead of a second launch.
//
// What bounds it on the H100: launches. One time step costs 5 launches in K1,
// 20 in K2 (two dt/2 steps + two dt/2 transpose steps), 25 in K2r (K2's 20
// plus the recompute's 5) and 5 in KA, so the headline pipeline (2048 steps)
// issues 51,200 launches (61,440 with recomputation), each moving only
// ~4·Np·B·K·4 bytes (1.9 MB at K=10^4, Np=3, B=8, computed from the shapes).
// Next come bytes; the arithmetic (≈2·Np² FLOP per node and stage) is far
// below either. PERF.md holds the measured split (host enqueue vs device).
// csrc/dg_tiled.cu fuses `seg` steps per launch with ghost halos.
//
// Stage time t + c_s·dt with t = t0 + n·dt (n the global step) is formed on
// the host in double; the inflow value −sin(a·t_s) reaches element 0 only
// (frozen to zero in the transpose). Because every loop forms the time from
// the global step, the recompute reproduces the stored trajectory bit for
// bit, and K2r's λ0 and η are K2's. The residual accumulation
// η += Σ_nodes λ·(u_{n+1} − half2) is fused into the last half-step stage,
// in float32 as the TPU kernel does.

#include <cuda_runtime.h>

#include "dg_stage.cuh"

namespace {

using aoa_dg::Geom;
using aoa_dg::StepTables;
using aoa_dg::dg_inflow;
using aoa_dg::pack_tables;

constexpr int kThreads = 256;

// One forward LSRK stage: r = a_s·r_in + dt·rhs(u_in), u_out = u_in + b_s·r.
// r_in == nullptr means a_s = 0 (stage 0); r_out == nullptr drops r (stage 4,
// where r never crosses the step boundary). traj_out != nullptr stores the
// stage input (the step's entry state). eta != nullptr fuses the residual
// accumulation η += Σ_i lam_i·(u_next_i − u_out_i) and skips the u/r writes.
template <int NP>
__global__ void __launch_bounds__(kThreads)
lsrk_stage(const float* __restrict__ u_in, const float* __restrict__ r_in,
           float* __restrict__ u_out, float* __restrict__ r_out,
           float* __restrict__ traj_out, const float* __restrict__ lam,
           const float* __restrict__ u_next, float* __restrict__ eta, Geom g,
           StepTables tab, float a_s, float b_s, float uin, int nb, int nk) {
  const int bk = nb * nk;
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= bk) return;
  const int k = c % nk;

  float u[NP], r[NP], un[NP];
#pragma unroll
  for (int i = 0; i < NP; ++i) u[i] = u_in[i * bk + c];
  if (traj_out != nullptr) {
#pragma unroll
    for (int i = 0; i < NP; ++i) traj_out[i * bk + c] = u[i];
  }
  if (r_in != nullptr) {
#pragma unroll
    for (int i = 0; i < NP; ++i) r[i] = r_in[i * bk + c];
  }
  const bool outflow = k == nk - 1;
  const float left = k > 0 ? u_in[(NP - 1) * bk + c - 1] : uin;
  const float right = outflow ? 0.f : u_in[c + 1];
  aoa_dg::stage_fwd<NP>(u, left, right, outflow, g.rx[k], g.fsl[k], g.fsr[k],
                        tab, r_in != nullptr, a_s, b_s, r, un);
  if (eta != nullptr) {
    float l[NP], nx[NP];
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      l[i] = lam[i * bk + c];
      nx[i] = u_next[i * bk + c];
    }
    eta[c] = __fadd_rn(eta[c], aoa_dg::residual_dot<NP>(l, nx, un));
  } else {
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      u_out[i * bk + c] = un[i];
      if (r_out != nullptr) r_out[i * bk + c] = r[i];
    }
  }
}

// w = b_s·λu + λr of column c (λr == nullptr: zero).
template <int NP>
__device__ __forceinline__ void column_w(const float* __restrict__ lu,
                                         const float* __restrict__ lr, int c,
                                         int bk, float b_s, float* w) {
  float l[NP], r[NP];
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    l[i] = lu[i * bk + c];
    r[i] = lr != nullptr ? lr[i * bk + c] : 0.f;
  }
  aoa_dg::stage_w<NP>(l, r, lr != nullptr, b_s, w);
}

// One transpose stage (stages run 4..0): w = b_s·λu + λr; λr_out = a_s·w;
// λu_out = λu + dt·Rᵀw, the neighbours' lifted faces recomputed from their
// columns (the transpose of the ±1 element shift is the ∓1 shift).
template <int NP>
__global__ void __launch_bounds__(kThreads)
lsrk_stage_t(const float* __restrict__ lu_in, const float* __restrict__ lr_in,
             float* __restrict__ lu_out, float* __restrict__ lr_out, Geom g,
             StepTables tab, float a_s, float b_s, int nb, int nk) {
  const int bk = nb * nk;
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= bk) return;
  const int k = c % nk;

  float w[NP], lu[NP], lu_new[NP], lr_new[NP];
  column_w<NP>(lu_in, lr_in, c, bk, b_s, w);
#pragma unroll
  for (int i = 0; i < NP; ++i) lu[i] = lu_in[i * bk + c];
  float s0, s1;
  aoa_dg::faces_t<NP>(w, k == nk - 1, g.fsl[k], g.fsr[k], tab, &s0, &s1);
  float p0 = 0.f;
  float p1 = 0.f;
  if (k < nk - 1) {
    float wn[NP];
    column_w<NP>(lu_in, lr_in, c + 1, bk, b_s, wn);
    p0 = __fmul_rn(g.fsl[k + 1], aoa_dg::lifted<NP>(tab.ll, wn));
  }
  if (k > 0) {  // element k−1 is never the outflow element
    float wp[NP];
    column_w<NP>(lu_in, lr_in, c - 1, bk, b_s, wp);
    p1 = __fmul_rn(g.fsr[k - 1], aoa_dg::lifted<NP>(tab.lr, wp));
  }
  aoa_dg::stage_t<NP>(lu, w, s0, s1, p0, p1, g.rx[k], tab, a_s, lu_new, lr_new);
#pragma unroll
  for (int j = 0; j < NP; ++j) {
    lu_out[j * bk + c] = lu_new[j];
    if (lr_out != nullptr) lr_out[j * bk + c] = lr_new[j];
  }
}

// Forward steps n_first .. n_first + n_count − 1 (global indices) from u0,
// the state at n_first. With ``store``, the entry state of every
// store_every-th step goes to store[n / store_every] (1: the trajectory;
// segment: the checkpoints). The last stage writes u_last. ubuf and rbuf
// hold 2·Np·B·K floats each. rk: RK4A[0..4], RK4B[0..4], RK4C[0..4].
template <int NP>
int fwd_steps(int nb, int nk, long n_first, int n_count, double t0, double dt,
              double a, const double* rk, const StepTables& tab, Geom g,
              const float* u0, float* store, int store_every, float* u_last,
              float* ubuf, float* rbuf, cudaStream_t stream) {
  const long size = static_cast<long>(NP) * nb * nk;
  const int blocks = (nb * nk + kThreads - 1) / kThreads;
  const float* u_cur = u0;
  const float* r_cur = nullptr;
  const long total = 5L * n_count;
  long j = 0;
  for (int n = 0; n < n_count; ++n) {
    const double tn = t0 + static_cast<double>(n_first + n) * dt;
    for (int s = 0; s < 5; ++s, ++j) {
      float* u_nxt = j == total - 1 ? u_last : ubuf + (j % 2) * size;
      float* r_nxt = s == 4 ? nullptr : rbuf + (j % 2) * size;
      float* tr = (s == 0 && store != nullptr && n % store_every == 0)
                      ? store + (n / store_every) * size
                      : nullptr;
      lsrk_stage<NP><<<blocks, kThreads, 0, stream>>>(
          u_cur, s == 0 ? nullptr : r_cur, u_nxt, r_nxt, tr, nullptr, nullptr,
          nullptr, g, tab, static_cast<float>(rk[s]),
          static_cast<float>(rk[5 + s]), dg_inflow(a, tn, rk[10 + s], dt), nb, nk);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
      u_cur = u_nxt;
      r_cur = r_nxt;
    }
  }
  return 0;
}

// ``steps`` transposed steps with the tables ``tab``: λ rides *lu (updated to
// the last output); jt counts transposed stages over the whole sweep, whose
// last (jt == total_t − 1) writes lam0. lubuf and lrbuf: 2·Np·B·K floats each.
template <int NP>
int transposed_steps(int nb, int nk, int steps, const double* rk,
                     const StepTables& tab, Geom g, const float** lu, long* jt,
                     long total_t, float* lam0, float* lubuf, float* lrbuf,
                     cudaStream_t stream) {
  const long size = static_cast<long>(NP) * nb * nk;
  const int blocks = (nb * nk + kThreads - 1) / kThreads;
  const float* lr_cur = nullptr;
  for (int hs = 0; hs < steps; ++hs) {
    for (int s = 4; s >= 0; --s, ++*jt) {
      float* lu_nxt = *jt == total_t - 1 ? lam0 : lubuf + (*jt % 2) * size;
      float* lr_nxt = s == 0 ? nullptr : lrbuf + (*jt % 2) * size;
      lsrk_stage_t<NP><<<blocks, kThreads, 0, stream>>>(
          *lu, s == 4 ? nullptr : lr_cur, lu_nxt, lr_nxt, g, tab,
          static_cast<float>(rk[s]), static_cast<float>(rk[5 + s]), nb, nk);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
      *lu = lu_nxt;
      lr_cur = lr_nxt;
    }
  }
  return 0;
}

// The reverse sweep over steps n_first + n_count − 1 … n_first: for each, two
// dt/2 steps from traj[n] (relative to n_first) whose last stage accumulates
// η += Σ λ·(u_{n+1} − half2) with the λ carried in (u_{n+1} = traj[n + 1], or
// u_end for the last step), then two dt/2 transposed steps.
template <int NP>
int rev_steps(int nb, int nk, long n_first, int n_count, double t0, double dt,
              double a, const double* rk, const StepTables& half, Geom g,
              const float* traj, const float* u_end, const float** lu, long* jt,
              long total_t, float* lam0, float* eta, float* ubuf, float* rbuf,
              float* lubuf, float* lrbuf, cudaStream_t stream) {
  const long size = static_cast<long>(NP) * nb * nk;
  const int blocks = (nb * nk + kThreads - 1) / kThreads;
  const double h = dt / 2;
  for (int n = n_count - 1; n >= 0; --n) {
    const double tn = t0 + static_cast<double>(n_first + n) * dt;
    const float* u_np1 = n == n_count - 1 ? u_end : traj + (n + 1) * size;
    const float* u_cur = traj + n * size;
    const float* r_cur = nullptr;
    for (int hs = 0; hs < 2; ++hs) {
      const double th = tn + hs * h;
      for (int s = 0; s < 5; ++s) {
        const int jj = 5 * hs + s;
        const bool last = jj == 9;
        float* u_nxt = last ? nullptr : ubuf + (jj % 2) * size;
        float* r_nxt = s == 4 ? nullptr : rbuf + (jj % 2) * size;
        lsrk_stage<NP><<<blocks, kThreads, 0, stream>>>(
            u_cur, s == 0 ? nullptr : r_cur, u_nxt, r_nxt, nullptr,
            last ? *lu : nullptr, last ? u_np1 : nullptr, last ? eta : nullptr,
            g, half, static_cast<float>(rk[s]), static_cast<float>(rk[5 + s]),
            dg_inflow(a, th, rk[10 + s], h), nb, nk);
        const cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return static_cast<int>(err);
        u_cur = u_nxt;
        r_cur = r_nxt;
      }
    }
    const int err = transposed_steps<NP>(nb, nk, 2, rk, half, g, lu, jt, total_t,
                                         lam0, lubuf, lrbuf, stream);
    if (err != 0) return err;
  }
  return 0;
}

template <int NP>
int fwd_march_impl(int nb, int nk, int n_steps, int store_every, double t0,
                   double dt, double a, const double* rk, const float* tables,
                   Geom g, const float* u0, float* store, float* u_final,
                   float* ubuf, float* rbuf, cudaStream_t stream) {
  const StepTables tab = pack_tables(NP, tables);
  const int err = fwd_steps<NP>(nb, nk, 0, n_steps, t0, dt, a, rk, tab, g, u0,
                                store, store_every, u_final, ubuf, rbuf, stream);
  return err != 0 ? err : static_cast<int>(cudaGetLastError());
}

template <int NP>
int adj_est_stored_impl(int nb, int nk, int n_steps, double t0, double dt,
                        double a, const double* rk, const float* half_tables,
                        Geom g, const float* traj, const float* u_final,
                        const float* lam_end, float* lam0, float* eta,
                        float* ubuf, float* rbuf, float* lubuf, float* lrbuf,
                        cudaStream_t stream) {
  const StepTables half = pack_tables(NP, half_tables);
  const float* lu = lam_end;
  long jt = 0;
  const int err = rev_steps<NP>(nb, nk, 0, n_steps, t0, dt, a, rk, half, g, traj,
                                u_final, &lu, &jt, 10L * n_steps, lam0, eta, ubuf,
                                rbuf, lubuf, lrbuf, stream);
  return err != 0 ? err : static_cast<int>(cudaGetLastError());
}

template <int NP>
int adj_est_recompute_impl(int nb, int nk, int n_steps, int segment, double t0,
                           double dt, double a, const double* rk,
                           const float* tables, const float* half_tables,
                           Geom g, const float* ckpt, const float* lam_end,
                           float* lam0, float* eta, float* scratch, float* ubuf,
                           float* rbuf, float* lubuf, float* lrbuf,
                           cudaStream_t stream) {
  const StepTables full = pack_tables(NP, tables);
  const StepTables half = pack_tables(NP, half_tables);
  const long size = static_cast<long>(NP) * nb * nk;
  const float* lu = lam_end;
  long jt = 0;
  for (int si = n_steps / segment - 1; si >= 0; --si) {
    const long n_first = static_cast<long>(si) * segment;
    float* u_end = scratch + segment * size;
    int err = fwd_steps<NP>(nb, nk, n_first, segment, t0, dt, a, rk, full, g,
                            ckpt + si * size, scratch, 1, u_end, ubuf, rbuf, stream);
    if (err != 0) return err;
    err = rev_steps<NP>(nb, nk, n_first, segment, t0, dt, a, rk, half, g, scratch,
                        u_end, &lu, &jt, 10L * n_steps, lam0, eta, ubuf, rbuf,
                        lubuf, lrbuf, stream);
    if (err != 0) return err;
  }
  return static_cast<int>(cudaGetLastError());
}

template <int NP>
int adj_march_impl(int nb, int nk, int n_steps, const double* rk,
                   const float* tables, Geom g, const float* lam_end,
                   float* lam0, float* lubuf, float* lrbuf,
                   cudaStream_t stream) {
  const StepTables full = pack_tables(NP, tables);
  const float* lu = lam_end;
  long jt = 0;
  const int err = transposed_steps<NP>(nb, nk, n_steps, rk, full, g, &lu, &jt,
                                       5L * n_steps, lam0, lubuf, lrbuf, stream);
  return err != 0 ? err : static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Returns 0 on success, a cudaError_t code after a failed launch, or -1 for
// an unsupported Np. Buffers: ubuf and rbuf hold 2·Np·B·K floats each.
// store (optional) receives the entry state of every store_every-th step:
// (n_steps / store_every, Np, B, K).
int dg_fwd_march(int np, int nb, int nk, int n_steps, int store_every,
                 double t0, double dt, double a, const double* rk,
                 const float* tables, const float* rx, const float* fsl,
                 const float* fsr, const float* u0, float* store,
                 float* u_final, float* ubuf, float* rbuf, void* stream) {
  const Geom g{rx, fsl, fsr};
  AOA_NP_SWITCH(np, fwd_march_impl<NP>(nb, nk, n_steps, store_every, t0, dt, a,
                                       rk, tables, g, u0, store, u_final, ubuf,
                                       rbuf, static_cast<cudaStream_t>(stream)))
}

// eta must be zeroed by the caller; ubuf, rbuf, lubuf, lrbuf hold 2·Np·B·K
// floats each. half_tables are folded for the step dt/2.
int dg_adj_est_stored(int np, int nb, int nk, int n_steps, double t0,
                      double dt, double a, const double* rk,
                      const float* half_tables, const float* rx,
                      const float* fsl, const float* fsr, const float* traj,
                      const float* u_final, const float* lam_end, float* lam0,
                      float* eta, float* ubuf, float* rbuf, float* lubuf,
                      float* lrbuf, void* stream) {
  const Geom g{rx, fsl, fsr};
  AOA_NP_SWITCH(np, adj_est_stored_impl<NP>(
                        nb, nk, n_steps, t0, dt, a, rk, half_tables, g, traj,
                        u_final, lam_end, lam0, eta, ubuf, rbuf, lubuf, lrbuf,
                        static_cast<cudaStream_t>(stream)))
}

// ckpt: (n_steps / segment, Np, B, K), K1's checkpoints; scratch holds
// (segment + 1)·Np·B·K floats; eta zeroed by the caller; the buffers as for
// dg_adj_est_stored. tables: step dt (the recompute), half_tables: dt/2.
int dg_adj_est_recompute(int np, int nb, int nk, int n_steps, int segment,
                         double t0, double dt, double a, const double* rk,
                         const float* tables, const float* half_tables,
                         const float* rx, const float* fsl, const float* fsr,
                         const float* ckpt, const float* lam_end, float* lam0,
                         float* eta, float* scratch, float* ubuf, float* rbuf,
                         float* lubuf, float* lrbuf, void* stream) {
  const Geom g{rx, fsl, fsr};
  AOA_NP_SWITCH(np, adj_est_recompute_impl<NP>(
                        nb, nk, n_steps, segment, t0, dt, a, rk, tables,
                        half_tables, g, ckpt, lam_end, lam0, eta, scratch, ubuf,
                        rbuf, lubuf, lrbuf, static_cast<cudaStream_t>(stream)))
}

// λ0 = (Lᵀ)^n_steps λ_end with the step-dt tables; lubuf and lrbuf hold
// 2·Np·B·K floats each.
int dg_adj_march(int np, int nb, int nk, int n_steps, const double* rk,
                 const float* tables, const float* rx, const float* fsl,
                 const float* fsr, const float* lam_end, float* lam0,
                 float* lubuf, float* lrbuf, void* stream) {
  const Geom g{rx, fsl, fsr};
  AOA_NP_SWITCH(np, adj_march_impl<NP>(nb, nk, n_steps, rk, tables, g, lam_end,
                                       lam0, lubuf, lrbuf,
                                       static_cast<cudaStream_t>(stream)))
}

const char* dg_error_string(int code) {
  if (code == -1) return "unsupported Np (the kernels take 2 <= Np <= 8)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
