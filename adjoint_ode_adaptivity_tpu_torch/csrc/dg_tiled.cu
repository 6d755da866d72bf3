// Hand-written Hopper (sm_90a) kernel of the element-tiled DG-advection
// forward: `seg` LSRK steps per launch, each CTA owning a tile of elements
// with a ghost ring in shared memory. Plain C interface, bound with ctypes.
//
// KT1 dg_tiled_fwd  replaces adjoint_ode_adaptivity_tpu/ops/pallas/
//                   dg_sharded.py:83 (_fwd_seg_kernel, launched per chunk by
//                   dg_tiled.py:108) and dg_tiled.py:282
//                   (_fwd_seg_grid_kernel).
// The tiled reverse KT2 runs K2's fused kernel at B = 1 (csrc/dg_rhs.cu
// rev_fused, called from ops/cuda/dg_tiled.py).
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
// (n_steps, Np, K) array — K2's layout, so the trajectory is K1's, and the
// reverse reads each step's u_n from it exact everywhere. The state crosses
// segments through global memory (ping-pong: other tiles read their ghosts
// from it).
//
// The per-element arithmetic is csrc/dg_stage.cuh's, shared with K1/K2, and
// the inflow values are the same host expression of the global step, so a
// local element gets K1's bits.
//
// What bounds it: per step, every window element is loaded once from shared
// memory per stage, with two barriers a stage; device memory sees the window
// once per segment plus the trajectory (Np·K floats written a step). Ghost
// recompute costs 2W/L. It issues one launch per segment.

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
// step.
struct Inflow {
  float v[5 * kMaxSeg];
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
                                             float a_s, float b_s, float uin) {
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
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      su[i * t.st + e] = un[i];
      sr[i * t.st + e] = r[i];
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
                       inflow.v[5 * n + s]);
    }
  }
  for (int k = t.lo + threadIdx.x; k < t.hi; k += blockDim.x) {
#pragma unroll
    for (int i = 0; i < NP; ++i) u_out[i * nk + k] = su[i * t.st + k - t.w0];
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

const char* dg_tiled_error_string(int code) {
  if (code == -1) return "unsupported Np (the kernels take 2 <= Np <= 8)";
  if (code == -2) return "segment out of range (the tiled forward takes 1..64)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
