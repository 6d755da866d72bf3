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
// Each kernel runs one thread per initial condition (IC) or member: the
// whole pipeline of one IC is independent of every other, so there is no
// cross-thread data. Per thread:
//   coarse forward-Euler march u_{n+1} = u_n + f(u_n, t_n)·dt_n, the
//   n_steps+1 coarse states kept in shared memory laid out [state][thread]
//   (conflict-free, no __syncthreads: a thread reads only its own column);
//   a reverse sweep over the rf-refined grid j = n_fine .. 1 that
//   interpolates u_j on the fly, updates the adjoint of J = ∫u² dt,
//   v_j = k_j + (1 + f_u(u_j)·dt_f)·v_{j+1} with k_j = 2·u_j·dt_f, forms the
//   residual r_j = u_j − (u_{j−1} + f(u_{j−1})·dt_f), and accumulates r·v
//   per coarse step; a step's indicator is stored once its block is complete.
// f and f_u of one fine node are evaluated once, as a pair, and f_u is
// carried to the next iteration (the TPU kernel's _pair_cache).
//
// The ODE is a compile-time functor of odes.cuh (one struct per registry
// entry, chosen by kernel_id in the dispatch at the bottom); the gaussian
// mixture's constants and the fast-trig coefficients travel by value in
// OdeConsts.
//
// Time grids. F1/F2: the coarse and fine node times and widths are folded on
// the host in double (as the TPU kernel folds them at trace time) and read
// as float32 from `grid` = [tc (n_steps), dts (n_steps), tf (n_fine),
// dtf (n_fine)], tf[j] and dtf[j] the time and width of fine node j; every
// thread reads the same address (a broadcast). F3: the per-member widths arrive as (n_steps, B), so neighbouring threads read
// neighbouring addresses; tc accumulates in float32 inside the kernel and
// dt_f = dts·(1/rf), as in the TPU kernel.
//
// What bounds them on the H100: neither bytes nor FP32 operations. A thread
// moves 4·(1 + n_steps) bytes of device memory and does ~16 operations per
// fine node plus two libm transcendentals (sincosf, tens of instructions),
// so at 102,400 ICs, 16 steps and rf 4 the byte bound is ~2 µs; the kernel
// is latency-bound on each thread's serial dependency chain through the
// sweep (v_j depends on v_{j+1}). One thread per IC gives 800 blocks of 128
// threads at 102,400 ICs (6 per SM), but only 8 blocks at the per-member
// study's B = 1024: that grid fills 8 of 132 SMs, and a redesign (several
// threads per member, or several members' sweeps interleaved per thread)
// is later work. Shared memory per block is (n_steps+1)·D·128·4 bytes
// (8.7 KB at 16 steps; F3 also keeps tc, 22.5 KB at 43 steps).

#include <cuda_runtime.h>

#include <cmath>

#include "odes.cuh"

namespace {

using namespace aoa;

constexpr int kFdThreads = 128;
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

// F1: the scalar ensemble signal, block convention; err is (n_steps, n).
template <class Ode>
__global__ void __launch_bounds__(kFdThreads)
fd_ensemble_kernel(int n, int n_steps, int rf, const float* __restrict__ grid,
                   const float* __restrict__ u0, float* __restrict__ err, OdeConsts k) {
  extern __shared__ float traj[];  // [(n_steps + 1)][blockDim.x]
  const int ic = blockIdx.x * blockDim.x + threadIdx.x;
  if (ic >= n) return;
  const int tx = threadIdx.x;
  const int bs = blockDim.x;
  const int n_fine = n_steps * rf;
  const float* tc = grid;
  const float* dts = grid + n_steps;
  const float* tf = dts + n_steps;
  const float* dtf = tf + n_fine;

  float u = u0[ic];
  traj[tx] = u;
  for (int s = 0; s < n_steps; ++s) {
    u = u + Ode::f(u, tc[s], k) * dts[s];
    traj[(s + 1) * bs + tx] = u;
  }

  float u_j = u;
  float fu_j = 0.f;  // f_u at node j, from the previous iteration's pair
  float v = 0.f;     // v_{n_fine} = k_{n_fine} = 0 (J sums u[:-1])
  float blk = 0.f;
  for (int j = n_fine; j >= 1; --j) {
    const float u_jm1 = u_fine(traj, bs, tx, j - 1, rf);
    if (j < n_fine) {
      const float d = dtf[j];
      v = 2.f * u_j * d + (1.f + fu_j * d) * v;
    }
    float f_jm1, fu_jm1;
    Ode::pair(u_jm1, tf[j - 1], k, &f_jm1, &fu_jm1);
    const float r = u_j - (u_jm1 + f_jm1 * dtf[j - 1]);
    blk += r * v;
    if ((j - 1) % rf == 0) {  // block (j−1)/rf covers fine nodes i·rf+1 .. (i+1)·rf
      err[static_cast<long>((j - 1) / rf) * n + ic] = fabsf(blk);
      blk = 0.f;
    }
    u_j = u_jm1;
    fu_j = fu_jm1;
  }
}

// F2: the vector-state ensemble signal; u0 is (D, n), err (n_steps, n).
template <class Ode>
__global__ void __launch_bounds__(kFdThreads)
fd_ensemble_vec_kernel(int n, int n_steps, int rf, const float* __restrict__ grid,
                       const float* __restrict__ u0, float* __restrict__ err, OdeConsts k) {
  constexpr int D = Ode::D;
  extern __shared__ float traj[];  // [(n_steps + 1)·D][blockDim.x]
  const int ic = blockIdx.x * blockDim.x + threadIdx.x;
  if (ic >= n) return;
  const int tx = threadIdx.x;
  const int bs = blockDim.x;
  const int n_fine = n_steps * rf;
  const float* tc = grid;
  const float* dts = grid + n_steps;
  const float* tf = dts + n_steps;
  const float* dtf = tf + n_fine;

  float u[D];
#pragma unroll
  for (int c = 0; c < D; ++c) {
    u[c] = u0[static_cast<long>(c) * n + ic];
    traj[c * bs + tx] = u[c];
  }
  for (int s = 0; s < n_steps; ++s) {
    float fs[D];
    Ode::f(u, tc[s], k, fs);
#pragma unroll
    for (int c = 0; c < D; ++c) {
      u[c] = u[c] + fs[c] * dts[s];
      traj[((s + 1) * D + c) * bs + tx] = u[c];
    }
  }

  float u_j[D], v[D], jac_j[D * D];
#pragma unroll
  for (int c = 0; c < D; ++c) {
    u_j[c] = u[c];
    v[c] = 0.f;
  }
#pragma unroll
  for (int e = 0; e < D * D; ++e) jac_j[e] = 0.f;
  float blk = 0.f;
  for (int j = n_fine; j >= 1; --j) {
    // fine node j−1, component c: the (state, component) rows of traj
    const int i = (j - 1) / rf;
    const int q = (j - 1) - i * rf;
    const float w = static_cast<float>(q) / static_cast<float>(rf);
    float u_jm1[D];
#pragma unroll
    for (int c = 0; c < D; ++c) {
      const float lo = traj[(i * D + c) * bs + tx];
      u_jm1[c] = q == 0 ? lo : lo + w * (traj[((i + 1) * D + c) * bs + tx] - lo);
    }
    if (j < n_fine) {  // v_j = k_j + (I + dt_f·J(u_j))ᵀ v_{j+1}
      const float d = dtf[j];
      float vn[D];
#pragma unroll
      for (int a = 0; a < D; ++a) {
        float acc = 2.f * u_j[a] * d + v[a];
#pragma unroll
        for (int m = 0; m < D; ++m) {
          if (Ode::nonzero(m, a)) acc = acc + d * jac_j[m * D + a] * v[m];
        }
        vn[a] = acc;
      }
#pragma unroll
      for (int a = 0; a < D; ++a) v[a] = vn[a];
    }
    float fs[D], jac[D * D];
    Ode::pair(u_jm1, tf[j - 1], k, fs, jac);
    const float d_m = dtf[j - 1];
    float e = 0.f;
#pragma unroll
    for (int a = 0; a < D; ++a) {
      const float r = u_j[a] - (u_jm1[a] + fs[a] * d_m);
      e = a == 0 ? r * v[a] : e + r * v[a];
    }
    blk += e;
    if (q == 0) {
      err[static_cast<long>(i) * n + ic] = fabsf(blk);
      blk = 0.f;
    }
#pragma unroll
    for (int a = 0; a < D; ++a) u_j[a] = u_jm1[a];
#pragma unroll
    for (int a = 0; a < D * D; ++a) jac_j[a] = jac[a];
  }
}

// F3: per-member widths dt (n_steps, B); err (n_steps, B) in the strided
// (block = 0) or block (block = 1) convention; j (B,) = Σ u_n²·dt_n.
template <class Ode>
__global__ void __launch_bounds__(kFdThreads)
fd_estimate_per_member_kernel(int nb, int n_steps, int rf, int block, float t0,
                              const float* __restrict__ dt, const float* __restrict__ u0,
                              float* __restrict__ err, float* __restrict__ j_out,
                              OdeConsts k) {
  extern __shared__ float smem[];  // traj, then tc: 2·(n_steps + 1) rows of blockDim.x
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= nb) return;
  const int tx = threadIdx.x;
  const int bs = blockDim.x;
  float* traj = smem;
  float* tc = smem + (n_steps + 1) * bs;
  const int n_fine = n_steps * rf;
  const float inv_rf = 1.f / static_cast<float>(rf);

  float u = u0[m];
  float t = t0;
  float j_val = 0.f;
  traj[tx] = u;
  tc[tx] = t;
  for (int s = 0; s < n_steps; ++s) {
    const float d = dt[static_cast<long>(s) * nb + m];
    j_val = j_val + u * u * d;  // J = Σ u_n² dt_n (left rule)
    u = u + Ode::f(u, t, k) * d;
    t = t + d;
    traj[(s + 1) * bs + tx] = u;
    tc[(s + 1) * bs + tx] = t;
  }
  j_out[m] = j_val;

  float u_j = u;
  float fu_j = 0.f;
  float v = 0.f;
  float blk = 0.f;
  for (int j = n_fine; j >= 1; --j) {
    const int i = (j - 1) / rf;  // coarse step of fine interval [j−1, j)
    const int q = (j - 1) - i * rf;
    const float d_i = dt[static_cast<long>(i) * nb + m];
    const float u_jm1 = u_fine(traj, bs, tx, j - 1, rf);
    if (j < n_fine) {
      const float d = dt[static_cast<long>(j / rf) * nb + m] * inv_rf;
      v = 2.f * u_j * d + (1.f + fu_j * d) * v;
    }
    const float w = static_cast<float>(q) / static_cast<float>(rf);
    const float t_jm1 = tc[i * bs + tx] + w * d_i;
    float f_jm1, fu_jm1;
    Ode::pair(u_jm1, t_jm1, k, &f_jm1, &fu_jm1);
    const float r = u_j - (u_jm1 + f_jm1 * (d_i * inv_rf));
    const float e = r * v;
    if (block) {
      blk += e;
    } else if (q != 0) {  // strided: drop the first fine node of every step
      blk += fabsf(e);
    }
    if (q == 0) {
      err[static_cast<long>(i) * nb + m] = block ? fabsf(blk) : blk;
      blk = 0.f;
    }
    u_j = u_jm1;
    fu_j = fu_jm1;
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

template <class Ode>
int launch_ensemble(int n, int n_steps, int rf, const float* grid, const float* u0,
                    float* err, const OdeConsts& k, cudaStream_t stream) {
  const long smem = static_cast<long>(n_steps + 1) * kFdThreads * sizeof(float);
  const int code = set_smem(reinterpret_cast<const void*>(&fd_ensemble_kernel<Ode>), smem);
  if (code != 0) return code;
  const int blocks = (n + kFdThreads - 1) / kFdThreads;
  fd_ensemble_kernel<Ode><<<blocks, kFdThreads, smem, stream>>>(n, n_steps, rf, grid, u0, err, k);
  return static_cast<int>(cudaGetLastError());
}

template <class Ode>
int launch_ensemble_vec(int n, int n_steps, int rf, const float* grid, const float* u0,
                        float* err, const OdeConsts& k, cudaStream_t stream) {
  const long smem = static_cast<long>(n_steps + 1) * Ode::D * kFdThreads * sizeof(float);
  const int code =
      set_smem(reinterpret_cast<const void*>(&fd_ensemble_vec_kernel<Ode>), smem);
  if (code != 0) return code;
  const int blocks = (n + kFdThreads - 1) / kFdThreads;
  fd_ensemble_vec_kernel<Ode><<<blocks, kFdThreads, smem, stream>>>(n, n_steps, rf, grid, u0,
                                                                     err, k);
  return static_cast<int>(cudaGetLastError());
}

template <class Ode>
int launch_per_member(int nb, int n_steps, int rf, int block, float t0, const float* dt,
                      const float* u0, float* err, float* j_out, const OdeConsts& k,
                      cudaStream_t stream) {
  const long smem = 2L * (n_steps + 1) * kFdThreads * sizeof(float);
  const int code =
      set_smem(reinterpret_cast<const void*>(&fd_estimate_per_member_kernel<Ode>), smem);
  if (code != 0) return code;
  const int blocks = (nb + kFdThreads - 1) / kFdThreads;
  fd_estimate_per_member_kernel<Ode><<<blocks, kFdThreads, smem, stream>>>(
      nb, n_steps, rf, block, t0, dt, u0, err, j_out, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Return 0 on success, a cudaError_t code after a failed launch, -2 for an
// ODE id the kernel does not take (or trig="fast" on another ODE than
// sin(u)), -3 when the trajectory exceeds a block's shared memory.
int fd_ensemble(int ode_id, int fast_trig, int n_u, int n_t, const float* consts, int n,
                int n_steps, int rf, const float* grid, const float* u0, float* err,
                void* stream) {
  if (fast_trig && ode_id != 1) return -2;
  const OdeConsts k = pack_consts(n_u, n_t, consts);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define AOA_LAUNCH(ODE) launch_ensemble<ODE>(n, n_steps, rf, grid, u0, err, k, s)
  AOA_ODE_SCALAR_SWITCH(ode_id, fast_trig, AOA_LAUNCH)
#undef AOA_LAUNCH
}

// u0 is (D, n), component-major.
int fd_ensemble_vec(int ode_id, int n, int n_steps, int rf, const float* grid,
                    const float* u0, float* err, void* stream) {
  const OdeConsts k{};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ode_id == 6) return launch_ensemble_vec<OdeHarmonic>(n, n_steps, rf, grid, u0, err, k, s);
  return -2;
}

// dt is (n_steps, B), member-minor; block = 1 for the block convention,
// 0 for strided. tc starts at t0.
int fd_estimate_per_member(int ode_id, int n_u, int n_t, const float* consts, int nb,
                           int n_steps, int rf, int block, float t0, const float* dt,
                           const float* u0, float* err, float* j_out, void* stream) {
  const OdeConsts k = pack_consts(n_u, n_t, consts);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define AOA_LAUNCH(ODE) \
  launch_per_member<ODE>(nb, n_steps, rf, block, t0, dt, u0, err, j_out, k, s)
  AOA_ODE_SCALAR_SWITCH(ode_id, 0, AOA_LAUNCH)
#undef AOA_LAUNCH
}

const char* fd_error_string(int code) {
  if (code == -2) return "ODE kernel_id (or trig) not implemented by this kernel";
  if (code == -3) return "coarse trajectory exceeds a block's shared memory (too many steps)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
