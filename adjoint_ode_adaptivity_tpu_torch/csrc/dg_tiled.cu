// Hand-written Hopper (sm_90a) kernels of the element-tiled DG-advection
// pipeline: `seg` LSRK steps per launch, each CTA owning a tile of elements
// with a ghost ring in shared memory. Plain C interface, bound with ctypes.
//
// KT1 dg_tiled_fwd  replaces adjoint_ode_adaptivity_tpu/ops/pallas/
//                   dg_sharded.py:83 (_fwd_seg_kernel, launched per chunk by
//                   dg_tiled.py:108) and dg_tiled.py:282
//                   (_fwd_seg_grid_kernel).
// KT2 dg_tiled_rev  replaces dg_sharded.py:107 (_rev_seg_kernel, via
//                   dg_tiled.py:120) and dg_tiled.py:314 (_rev_seg_grid_kernel).
//
// Design. One CTA per tile of L local elements [lo, hi) of a single state
// (Np, K). It loads the window [lo − W, hi + W), clipped to [0, K), into
// shared memory and advances `seg` steps there: each stage writes the
// elements' face traces to shared memory, __syncthreads, updates every
// element of the window in place from its own nodes and its neighbours'
// traces, __syncthreads. No grid-wide sync: the flux couples ±1 element per
// stage, so after S stages only the S outermost elements of each side are
// wrong, and W ≥ 10·seg + 10 (dg_sharded.py:18-25) keeps every local element
// exact. The window's first element takes the inflow value and its last has
// no right face, which is right at the domain's ends and harmless at a ghost
// edge; the plain version (ops/cuda/dg_tiled.py) treats the window the same.
//
// Trajectory: KT1 writes only the exact local entry states, into a global
// (n_steps, Np, K) array — K2's layout, so the trajectory is K1's. KT2 then
// loads each step's u_n window from it exact everywhere: the half steps need
// ±10 exact elements, λ degrades 10 elements a step, hence W ≥ 10·seg + 10.
// λ and the state cross segments through global memory (ping-pong: other
// tiles read their ghosts from it); η is each element's own, in place.
//
// The per-element arithmetic is csrc/dg_stage.cuh's, shared with K1/K2, and
// the inflow values are the same host expression of the global step, so a
// local element gets K1's and K2's bits.
//
// What bounds it: per step, every window element is loaded once from shared
// memory per stage (25 stage-updates a step in all), with two barriers a
// stage; device memory sees the window once per segment plus the trajectory
// (KT1 writes and KT2 reads Np·K floats a step). Ghost recompute costs 2W/L.
// It issues 2 launches per segment against K1/K2's 25 per step.

#include <cuda_runtime.h>

#include "dg_stage.cuh"

namespace {

using aoa_dg::Geom;
using aoa_dg::RkCoef;
using aoa_dg::StepTables;
using aoa_dg::dg_inflow;
using aoa_dg::pack_tables;
using aoa_dg::rk_coef;

constexpr int kThreads = 256;
constexpr int kMaxSeg = 64;

// The inflow value of every stage of the segment, formed on the host: 5 per
// step forward, 10 per step (two dt/2 steps) in the reverse.
struct Inflow {
  float v[10 * kMaxSeg];
};

struct Tile {
  int lo, hi, w0, e, st;  // local [lo, hi), window [w0, w0 + e), row stride st
};

__device__ __forceinline__ Tile tile_of(int nk, int tile_l, int ghost) {
  Tile t;
  t.lo = blockIdx.x * tile_l;
  t.hi = min(t.lo + tile_l, nk);
  t.w0 = max(t.lo - ghost, 0);
  t.e = min(t.hi + ghost, nk) - t.w0;
  t.st = tile_l + 2 * ghost;
  return t;
}

// One forward stage over the window held in su/sr (shared, row stride st);
// fl/fr receive the face traces. The first window element takes ``uin``, the
// last has no right face.
template <int NP>
__device__ __forceinline__ void window_stage(const Tile& t, float* su, float* sr,
                                             float* fl, float* fr, Geom g,
                                             const StepTables& tab, int s,
                                             float a_s, float b_s, float uin,
                                             const float* lam_g,
                                             const float* u_next_g,
                                             float* seta, int nk) {
  for (int e = threadIdx.x; e < t.e; e += blockDim.x) {
    fl[e] = su[e];
    fr[e] = su[(NP - 1) * t.st + e];
  }
  __syncthreads();
  for (int e = threadIdx.x; e < t.e; e += blockDim.x) {
    const int k = t.w0 + e;
    float u[NP], r[NP], un[NP];
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      u[i] = su[i * t.st + e];
      r[i] = sr[i * t.st + e];
    }
    const bool outflow = e == t.e - 1;
    const float left = e == 0 ? uin : fr[e - 1];
    const float right = outflow ? 0.f : fl[e + 1];
    aoa_dg::stage_fwd<NP>(u, left, right, outflow, g.rx[k], g.fsl[k], g.fsr[k],
                          tab, s > 0, a_s, b_s, r, un);
    if (seta != nullptr) {  // the last half-step stage: η on local elements
      if (k >= t.lo && k < t.hi) {
        float l[NP], nx[NP];
#pragma unroll
        for (int i = 0; i < NP; ++i) {
          l[i] = lam_g[i * t.st + e];
          nx[i] = u_next_g[i * nk + k];
        }
        seta[e] = __fadd_rn(seta[e], aoa_dg::residual_dot<NP>(l, nx, un));
      }
    } else {
#pragma unroll
      for (int i = 0; i < NP; ++i) {
        su[i * t.st + e] = un[i];
        sr[i * t.st + e] = r[i];
      }
    }
  }
  __syncthreads();
}

// KT1: ``seg`` steps of one tile from u_in (Np, K) into u_out's local
// elements; traj (seg, Np, K) receives the local entry state of each step.
template <int NP>
__global__ void __launch_bounds__(kThreads)
tiled_fwd_seg(const float* __restrict__ u_in, float* __restrict__ u_out,
              float* __restrict__ traj, Geom g, StepTables tab, RkCoef rk,
              Inflow inflow, int nk, int tile_l, int ghost, int seg) {
  extern __shared__ float sm[];
  const Tile t = tile_of(nk, tile_l, ghost);
  float* su = sm;
  float* sr = su + NP * t.st;
  float* fl = sr + NP * t.st;
  float* fr = fl + t.st;
  for (int e = threadIdx.x; e < t.e; e += blockDim.x) {
#pragma unroll
    for (int i = 0; i < NP; ++i) su[i * t.st + e] = u_in[i * nk + t.w0 + e];
  }
  __syncthreads();
  for (int n = 0; n < seg; ++n) {
    float* tr = traj + static_cast<long>(n) * NP * nk;
    for (int k = t.lo + threadIdx.x; k < t.hi; k += blockDim.x) {
#pragma unroll
      for (int i = 0; i < NP; ++i) tr[i * nk + k] = su[i * t.st + k - t.w0];
    }
    for (int s = 0; s < 5; ++s) {
      window_stage<NP>(t, su, sr, fl, fr, g, tab, s, rk.a[s], rk.b[s],
                       inflow.v[5 * n + s], nullptr, nullptr, nullptr, nk);
    }
  }
  for (int k = t.lo + threadIdx.x; k < t.hi; k += blockDim.x) {
#pragma unroll
    for (int i = 0; i < NP; ++i) u_out[i * nk + k] = su[i * t.st + k - t.w0];
  }
}

// KT2: the reverse sweep of one segment for one tile: for n = seg−1 … 0, two
// dt/2 steps from traj[n] with η += Σ λ·(u_{n+1} − half2) on the local
// elements (u_{n+1} = traj[n + 1], or u_end for n = seg − 1), then two dt/2
// transposed steps of the λ window. λ from lam_in, local λ to lam_out; eta
// (K,) accumulated in place.
template <int NP>
__global__ void __launch_bounds__(kThreads)
tiled_rev_seg(const float* __restrict__ traj, const float* __restrict__ u_end,
              const float* __restrict__ lam_in, float* __restrict__ lam_out,
              float* __restrict__ eta, Geom g, StepTables half, RkCoef rk,
              Inflow inflow, int nk, int tile_l, int ghost, int seg) {
  extern __shared__ float sm[];
  const Tile t = tile_of(nk, tile_l, ghost);
  float* su = sm;
  float* sr = su + NP * t.st;
  float* slu = sr + NP * t.st;
  float* slr = slu + NP * t.st;
  float* f0 = slr + NP * t.st;
  float* f1 = f0 + t.st;
  float* seta = f1 + t.st;
  for (int e = threadIdx.x; e < t.e; e += blockDim.x) {
    const int k = t.w0 + e;
#pragma unroll
    for (int i = 0; i < NP; ++i) slu[i * t.st + e] = lam_in[i * nk + k];
    seta[e] = (k >= t.lo && k < t.hi) ? eta[k] : 0.f;
  }
  for (int n = seg - 1; n >= 0; --n) {
    const float* u_n = traj + static_cast<long>(n) * NP * nk;
    const float* u_np1 = n == seg - 1 ? u_end : u_n + NP * nk;
    __syncthreads();
    for (int e = threadIdx.x; e < t.e; e += blockDim.x) {
#pragma unroll
      for (int i = 0; i < NP; ++i) su[i * t.st + e] = u_n[i * nk + t.w0 + e];
    }
    __syncthreads();
    for (int j = 0; j < 10; ++j) {
      const int s = j % 5;
      window_stage<NP>(t, su, sr, f0, f1, g, half, s, rk.a[s], rk.b[s],
                       inflow.v[10 * n + j], slu, u_np1, j == 9 ? seta : nullptr,
                       nk);
    }
    // two dt/2 transposed steps of the λ window (stages 4..0 each)
    for (int j = 0; j < 10; ++j) {
      const int s = 4 - j % 5;
      const bool have_lr = s < 4;
      for (int e = threadIdx.x; e < t.e; e += blockDim.x) {
        const int k = t.w0 + e;
        float lu[NP], lr[NP], w[NP];
#pragma unroll
        for (int i = 0; i < NP; ++i) {
          lu[i] = slu[i * t.st + e];
          lr[i] = slr[i * t.st + e];
        }
        aoa_dg::stage_w<NP>(lu, lr, have_lr, rk.b[s], w);
        aoa_dg::faces_t<NP>(w, e == t.e - 1, g.fsl[k], g.fsr[k], half, &f0[e], &f1[e]);
      }
      __syncthreads();
      for (int e = threadIdx.x; e < t.e; e += blockDim.x) {
        const int k = t.w0 + e;
        float lu[NP], lr[NP], w[NP], lu_new[NP], lr_new[NP];
#pragma unroll
        for (int i = 0; i < NP; ++i) {
          lu[i] = slu[i * t.st + e];
          lr[i] = slr[i * t.st + e];
        }
        aoa_dg::stage_w<NP>(lu, lr, have_lr, rk.b[s], w);
        const float s0 = f0[e];
        const float s1 = f1[e];
        const float p0 = e == t.e - 1 ? 0.f : f0[e + 1];
        const float p1 = e == 0 ? 0.f : f1[e - 1];
        aoa_dg::stage_t<NP>(lu, w, s0, s1, p0, p1, g.rx[k], half, rk.a[s], lu_new,
                            lr_new);
#pragma unroll
        for (int i = 0; i < NP; ++i) {
          slu[i * t.st + e] = lu_new[i];
          slr[i * t.st + e] = lr_new[i];
        }
      }
      __syncthreads();
    }
  }
  for (int k = t.lo + threadIdx.x; k < t.hi; k += blockDim.x) {
#pragma unroll
    for (int i = 0; i < NP; ++i) lam_out[i * nk + k] = slu[i * t.st + k - t.w0];
    eta[k] = seta[k - t.w0];
  }
}

template <typename Kernel>
int set_smem(Kernel kernel, long bytes) {
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

template <int NP>
int tiled_fwd_impl(int nk, int n_segments, int seg, int tile_l, int ghost,
                   int seg_first, double t0, double dt, double a,
                   const double* rk, const float* tables, Geom g, const float* u0, float* traj,
                   float* u_final, float* ubuf, cudaStream_t stream) {
  const StepTables tab = pack_tables(NP, tables);
  const RkCoef coef = rk_coef(rk);
  const long size = static_cast<long>(NP) * nk;
  const int tiles = (nk + tile_l - 1) / tile_l;
  const long smem = (2L * NP + 2) * (tile_l + 2L * ghost) * sizeof(float);
  int err = set_smem(tiled_fwd_seg<NP>, smem);
  if (err != 0) return err;
  const float* u_cur = u0;
  for (int si = 0; si < n_segments; ++si) {
    Inflow inflow{};
    for (int n = 0; n < seg; ++n) {
      const double tn =
          t0 + static_cast<double>(static_cast<long>(seg_first + si) * seg + n) * dt;
      for (int s = 0; s < 5; ++s) inflow.v[5 * n + s] = dg_inflow(a, tn, rk[10 + s], dt);
    }
    float* u_nxt = si == n_segments - 1 ? u_final : ubuf + (si % 2) * size;
    tiled_fwd_seg<NP><<<tiles, kThreads, smem, stream>>>(
        u_cur, u_nxt, traj + static_cast<long>(si) * seg * size, g, tab, coef,
        inflow, nk, tile_l, ghost, seg);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    u_cur = u_nxt;
  }
  return 0;
}

template <int NP>
int tiled_rev_impl(int nk, int n_segments, int seg, int tile_l, int ghost,
                   int seg_first, double t0, double dt, double a,
                   const double* rk, const float* half_tables, Geom g, const float* traj,
                   const float* u_final, const float* lam_end, float* lam0,
                   float* eta, float* lbuf, cudaStream_t stream) {
  const StepTables half = pack_tables(NP, half_tables);
  const RkCoef coef = rk_coef(rk);
  const long size = static_cast<long>(NP) * nk;
  const int tiles = (nk + tile_l - 1) / tile_l;
  const long smem = (4L * NP + 3) * (tile_l + 2L * ghost) * sizeof(float);
  int err = set_smem(tiled_rev_seg<NP>, smem);
  if (err != 0) return err;
  const double h = dt / 2;
  const float* lam_cur = lam_end;
  for (int si = n_segments - 1, j = 0; si >= 0; --si, ++j) {
    Inflow inflow{};
    for (int n = 0; n < seg; ++n) {
      const double tn =
          t0 + static_cast<double>(static_cast<long>(seg_first + si) * seg + n) * dt;
      for (int hs = 0; hs < 2; ++hs) {
        const double th = tn + hs * h;
        for (int s = 0; s < 5; ++s) inflow.v[10 * n + 5 * hs + s] = dg_inflow(a, th, rk[10 + s], h);
      }
    }
    const float* seg_traj = traj + static_cast<long>(si) * seg * size;
    const float* u_end = si == n_segments - 1 ? u_final : seg_traj + seg * size;
    float* lam_nxt = si == 0 ? lam0 : lbuf + (j % 2) * size;
    tiled_rev_seg<NP><<<tiles, kThreads, smem, stream>>>(
        seg_traj, u_end, lam_cur, lam_nxt, eta, g, half, coef, inflow, nk,
        tile_l, ghost, seg);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    lam_cur = lam_nxt;
  }
  return 0;
}

}  // namespace

extern "C" {

// Returns 0 on success, a cudaError_t code after a failed launch or
// attribute call, -1 for an unsupported Np, -2 for a segment past kMaxSeg.
// traj: (n_segments·seg, Np, K); ubuf: 2·Np·K floats. Segment si of the call
// is the march's segment seg_first + si: its step n starts at
// t0 + ((seg_first + si)·seg + n)·dt (the global step, whoever calls).
int dg_tiled_fwd(int np, int nk, int n_segments, int seg, int tile_l,
                 int ghost, int seg_first, double t0, double dt, double a,
                 const double* rk, const float* tables, const float* rx, const float* fsl,
                 const float* fsr, const float* u0, float* traj,
                 float* u_final, float* ubuf, void* stream) {
  if (seg < 1 || seg > kMaxSeg) return -2;
  const Geom g{rx, fsl, fsr};
  AOA_NP_SWITCH(np, tiled_fwd_impl<NP>(nk, n_segments, seg, tile_l, ghost,
                                       seg_first, t0, dt, a, rk, tables, g, u0, traj, u_final,
                                       ubuf, static_cast<cudaStream_t>(stream)))
}

// eta (K,) holds the η carried in (zero for a whole sweep), accumulated in
// place; lbuf: 2·Np·K floats; half_tables for dt/2; seg_first as above.
int dg_tiled_rev(int np, int nk, int n_segments, int seg, int tile_l,
                 int ghost, int seg_first, double t0, double dt, double a,
                 const double* rk, const float* half_tables, const float* rx, const float* fsl,
                 const float* fsr, const float* traj, const float* u_final,
                 const float* lam_end, float* lam0, float* eta, float* lbuf,
                 void* stream) {
  if (seg < 1 || seg > kMaxSeg) return -2;
  const Geom g{rx, fsl, fsr};
  AOA_NP_SWITCH(np, tiled_rev_impl<NP>(nk, n_segments, seg, tile_l, ghost,
                                       seg_first, t0, dt, a, rk, half_tables, g, traj, u_final,
                                       lam_end, lam0, eta, lbuf,
                                       static_cast<cudaStream_t>(stream)))
}

const char* dg_tiled_error_string(int code) {
  if (code == -1) return "unsupported Np (the kernels take 2 <= Np <= 8)";
  if (code == -2) return "segment out of range (the tiled kernels take 1..64)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
