// Hand-written Hopper (sm_90a) kernels of the fused training epoch of a
// per-step ResBlockSimple net, bound to Python with ctypes (plain C
// interface).
//
// T1  resblock_epoch_grad   replaces adjoint_ode_adaptivity_tpu/ops/pallas/
//                           train_fused.py:107 (_epoch_kernel, pallas_call
//                           :358)
//
// For B members with scalar state, per-step parameters bias b, w1, w2 (S, F):
//   forward  u_{n+1} = u_n + dt_n · Σ_i w2_i · relu(w1_i · (u_n − b_i))
//   loss     Σ_m w_m² (u_S − y)² · inv_b, or (mixed) the trapezoid
//            Σ_n c_n e_n² + the ramp weight on the terminal node
//   reverse  g = ∂L/∂u_{n+1}, s_i = w1_i (u_n − b_i), a_i = relu(s_i):
//            ∂w2_i += g·dt·a_i, ∂w1_i += g·dt·w2_i·1[s_i>0]·(u_n − b_i),
//            ∂b_i −= g·dt·w2_i·1[s_i>0]·w1_i,
//            g_n = g + Σ_i g·dt·w2_i·1[s_i>0]·w1_i (+ 2·c_n·e_n·inv_b, mixed)
// exactly what the TPU kernel computes (relu'(0) = 0; neurons i ≥
// n_active[n] are skipped and get gradients that are exactly 0; a zero-dt
// step is an exact identity with zero gradients).
//
// Design for this card, not a copy of the TPU's: the TPU kernel carries the
// gradient sums in one VMEM block across a sequential grid. Blocks here run
// in parallel and in no order, so the work splits in two launches, both
// deterministic:
//   1. resblock_march_kernel, one thread per member: the forward march
//      (trajectory to a (S+1, B) scratch), the member's loss term, and the
//      reverse sweep of the cotangent alone (the neuron sum for g_n), which
//      stores g for every step into a (S, B) scratch. The parameters are read
//      straight from global memory: every lane of a warp reads the same
//      address, one transaction, and no table has to fit in shared memory
//      (the three (S, F) tables reach 60 KB at S = 10, F = 500 and grow by a
//      step each outer iteration).
//   2. resblock_grad_kernel, one warp per (step, neuron): the three member
//      sums of that entry over the stored trajectory and cotangents (lanes
//      stride over members, then a 5-level shuffle tree), in a fixed order,
//      so two calls on the same inputs give bit-identical results; one more
//      warp sums the members' loss terms.
// What bounds it on the H100: FP32 operations (~16·S·F·B) in a serial chain
// per member in launch 1, where B = 8192 gives 128 blocks of 64 threads, one
// or two warps per SM; launch 2 fills the card (S·F warps) and reads the two
// scratches from L2.

#include <cuda_runtime.h>

namespace {

constexpr int kMarchThreads = 64;
constexpr int kGradThreads = 128;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(kFull, v, off);
  return v;
}

__global__ void __launch_bounds__(kMarchThreads)
resblock_march_kernel(int S, int F, int B, int mixed, const float* __restrict__ p,
                      const float* __restrict__ dt, const float* __restrict__ u0,
                      const float* __restrict__ tgt, const float* __restrict__ wts,
                      const int* __restrict__ n_active, float ramp, float inv_b,
                      float* __restrict__ traj, float* __restrict__ gcot,
                      float* __restrict__ loss_m) {
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= B) return;
  const float* bias = p;
  const float* w1 = p + S * F;
  const float* w2 = p + 2 * S * F;
  float u = u0[m];
  traj[m] = u;
  for (int n = 0; n < S; ++n) {
    const int na = n_active ? min(max(n_active[n], 0), F) : F;
    const float* bn = bias + n * F;
    const float* an = w1 + n * F;
    const float* cn = w2 + n * F;
    float acc = 0.f;
    for (int i = 0; i < na; ++i) acc = fmaf(cn[i], fmaxf(an[i] * (u - bn[i]), 0.f), acc);
    u = fmaf(dt[n], acc, u);
    traj[(n + 1) * B + m] = u;
  }
  const float w = wts ? wts[m] : 1.f;
  const float c_term = mixed ? dt[S - 1] * 0.5f + ramp : 1.f;
  const float e = (u - tgt[(mixed ? S * B : 0) + m]) * w;
  float loss = c_term * e * e * inv_b;
  float g = 2.f * c_term * e * inv_b;
  for (int n = S - 1; n >= 0; --n) {
    gcot[n * B + m] = g;
    const int na = n_active ? min(max(n_active[n], 0), F) : F;
    const float* bn = bias + n * F;
    const float* an = w1 + n * F;
    const float* cn = w2 + n * F;
    const float un = traj[n * B + m];
    const float gdt = g * dt[n];
    float du = 0.f;
    for (int i = 0; i < na; ++i) {
      if (an[i] * (un - bn[i]) > 0.f) du = fmaf(gdt * cn[i], an[i], du);
    }
    g = g + du;
    if (mixed) {
      const float c_n = 0.5f * ((n > 0 ? dt[n - 1] : 0.f) + dt[n]);
      const float e_n = (un - tgt[n * B + m]) * w;
      loss += c_n * e_n * e_n * inv_b;
      g += 2.f * c_n * e_n * inv_b;
    }
  }
  loss_m[m] = loss;
}

// grads (3, S, F): bias, w1, w2. Warp S·F sums the members' loss terms.
__global__ void __launch_bounds__(kGradThreads)
resblock_grad_kernel(int S, int F, int B, const float* __restrict__ p,
                     const float* __restrict__ dt, const int* __restrict__ n_active,
                     const float* __restrict__ traj, const float* __restrict__ gcot,
                     const float* __restrict__ loss_m, float* __restrict__ grads,
                     float* __restrict__ loss) {
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp > S * F) return;  // warp-uniform
  if (warp == S * F) {
    float s = 0.f;
    for (int m = lane; m < B; m += 32) s += loss_m[m];
    s = warp_sum(s);
    if (lane == 0) loss[0] = s;
    return;
  }
  const int n = warp / F, i = warp % F;
  const int idx = n * F + i;
  const bool active = !n_active || i < n_active[n];
  const float b = p[idx], a1 = p[S * F + idx], a2 = p[2 * S * F + idx];
  float gw2 = 0.f, gw1 = 0.f, sds = 0.f;
  if (active) {
    const float dtn = dt[n];
    for (int m = lane; m < B; m += 32) {
      const float gdt = gcot[n * B + m] * dtn;
      const float d = traj[n * B + m] - b;
      const float s = a1 * d;
      if (s > 0.f) {
        const float ds = gdt * a2;
        gw2 = fmaf(gdt, s, gw2);
        gw1 = fmaf(ds, d, gw1);
        sds += ds;
      }
    }
  }
  gw2 = warp_sum(gw2);
  gw1 = warp_sum(gw1);
  sds = warp_sum(sds);
  if (lane == 0) {
    grads[idx] = active ? -a1 * sds : 0.f;
    grads[S * F + idx] = gw1;
    grads[2 * S * F + idx] = gw2;
  }
}

}  // namespace

extern "C" {

// Return 0 on success, -2 for an empty shape, or the cudaError_t of a
// refused launch. traj (S+1, B), gcot (S, B) and loss_m (B) are scratch;
// weights and n_active may be null; targets are (B) or, mixed, (S+1, B).
int resblock_epoch_grad(int S, int F, int B, int mixed, const float* p, const float* dt,
                        const float* u0, const float* tgt, const float* wts,
                        const int* n_active, double ramp, double inv_b, float* traj,
                        float* gcot, float* loss_m, float* loss, float* grads, void* stream) {
  if (S < 1 || F < 1 || B < 1) return -2;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  resblock_march_kernel<<<(B + kMarchThreads - 1) / kMarchThreads, kMarchThreads, 0, s>>>(
      S, F, B, mixed, p, dt, u0, tgt, wts, n_active, static_cast<float>(ramp),
      static_cast<float>(inv_b), traj, gcot, loss_m);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const long warps = static_cast<long>(S) * F + 1;
  const int per_block = kGradThreads / 32;
  resblock_grad_kernel<<<static_cast<int>((warps + per_block - 1) / per_block), kGradThreads, 0,
                         s>>>(S, F, B, p, dt, n_active, traj, gcot, loss_m, grads, loss);
  e = cudaGetLastError();
  return e == cudaSuccess ? 0 : static_cast<int>(e);
}

const char* train_fused_error_string(int code) {
  if (code == -2) return "empty shape (S, F and B must be >= 1)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
