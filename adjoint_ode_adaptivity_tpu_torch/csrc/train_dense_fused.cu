// Hand-written Hopper (sm_90a) kernels of the fused training epoch of the
// shared-parameter Dense chain, bound to Python with ctypes (plain C
// interface).
//
// T2  dense_epoch_grad   replaces adjoint_ode_adaptivity_tpu/ops/pallas/
//                        train_dense_fused.py:136 (_epoch_kernel,
//                        pallas_call :318)
//
// For B members with scalar state and ONE parameter set of ResNetBlock(H_1..
// H_L): z_1 = u·w_1 + b_1, a_l = relu(a_{l−1} W_l + b_l), f = a_L·w_out +
// b_out, u_{n+1} = u_n + dt_n·f, loss = mean_m (u_S − y)²; the backward
// sweep recomputes the chain from the stored scalar trajectory at each step:
// df = dt·g, ∂W_out += a_Lᵀdf, ∂b_out += Σdf, dz_L = df·w_out·1[z_L>0],
// ∂W_l += a_{l−1}ᵀdz_l, ∂b_l += Σdz_l, dz_{l−1} = (dz_l W_lᵀ)·1[z_{l−1}>0],
// ∂w_1 += Σ u·dz_1, ∂b_1 += Σdz_1, g ← g + Σ_i dz_1,i·w_1,i. Hidden widths
// arrive padded to multiples of 4 with zero weights and biases, which relu
// keeps exactly inert in both passes.
//
// Design for this card: one block of 256 threads per tile of BM members
// (BM = 64, 32 or 16, the largest whose activation tiles fit: BM·Σ_l P_l
// floats of dynamic shared memory, 154 KB at (100, 500) and BM = 64, so
// B = 8192 gives 128 blocks). Every layer's activations of the current step
// stay in shared memory; the backward pass overwrites a_l with dz_l in place
// (a_l > 0 ⇔ z_l > 0). The hidden products are written by hand: IEEE FP32
// FMAs, no TF32, no tensor cores, no library call. A thread owns a
// (BM/16) × 4 output tile of a row product (W_l, or W_lᵀ, which the wrapper
// passes transposed, streamed from L2 as float4 rows, coalesced across the
// 16 column threads), or a 4 × 4 tile of a weight gradient aᵀdz summed over
// the block's members from shared memory. The TPU kernel carries the
// gradients across its sequential grid; blocks here run in parallel, so each
// block adds its sums into its own row of a partial-gradient buffer (one
// owner per entry, L2-resident: 128 × 205 KB at (100, 500)), and a second
// launch sums the rows in block order: deterministic, bit-identical on a
// repeat call.
// What bounds it on the H100: FP32 operations, 4·2·B·S·Σ H_{l−1}H_l for the
// hidden products (forward, recompute, ∂W, ∂a); the weight tiles are
// re-read from L2 by every block at every step.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxLayers = 8;
constexpr int kThreads = 256;
constexpr int kMaxSmem = 227 * 1024;
constexpr unsigned kFull = 0xffffffffu;

struct DenseLayout {
  int L;                       // hidden layers
  int P[kMaxLayers];           // padded widths
  int off_k[kMaxLayers + 1];   // theta: w_1, W_1..W_{L−1}, w_out
  int off_b[kMaxLayers + 1];   // theta: b_1, b_2..b_L, b_out
  int off_t[kMaxLayers];       // theta_t: W_l transposed (P_l × P_{l−1})
  int act_off[kMaxLayers];     // shared memory: a_l (BM × P_l)
  int total;                   // floats in theta (and in a gradient row)
  int smem_floats;
};

// C (BM × N) from A (BM × K, shared) times W (K × N, global, row-major):
// MODE 0 writes relu(AW + bias); MODE 1 writes AW where C > 0, else 0.
template <int BM, int MODE>
__device__ void row_product(const float* A, int K, const float* __restrict__ W, int N,
                            const float* __restrict__ bias, float* C) {
  constexpr int RM = BM / 16;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  for (int c0 = 0; c0 < N; c0 += 64) {
    const int j = c0 + tx * 4;
    if (j >= N) continue;
    float acc[RM][4];
#pragma unroll
    for (int r = 0; r < RM; ++r) acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0.f;
    for (int k = 0; k < K; ++k) {
      const float4 w = __ldg(reinterpret_cast<const float4*>(W + static_cast<size_t>(k) * N + j));
#pragma unroll
      for (int r = 0; r < RM; ++r) {
        const float a = A[(ty * RM + r) * K + k];
        acc[r][0] = fmaf(a, w.x, acc[r][0]);
        acc[r][1] = fmaf(a, w.y, acc[r][1]);
        acc[r][2] = fmaf(a, w.z, acc[r][2]);
        acc[r][3] = fmaf(a, w.w, acc[r][3]);
      }
    }
#pragma unroll
    for (int r = 0; r < RM; ++r) {
      float* o = C + (ty * RM + r) * N + j;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (MODE == 0) {
          o[q] = fmaxf(acc[r][q] + bias[j + q], 0.f);
        } else {
          o[q] = o[q] > 0.f ? acc[r][q] : 0.f;
        }
      }
    }
  }
}

// part[i·N + j] += Σ_m A[m][i]·D[m][j], A (BM × K) and D (BM × N) in shared.
template <int BM>
__device__ void weight_grad(const float* A, int K, const float* D, int N, float* part) {
  const int ntj = N / 4, nt = (K / 4) * ntj;
  for (int t = threadIdx.x; t < nt; t += blockDim.x) {
    const int i0 = (t / ntj) * 4, j0 = (t % ntj) * 4;
    float acc[4][4] = {};
    for (int m = 0; m < BM; ++m) {
      const float4 a = *reinterpret_cast<const float4*>(A + m * K + i0);
      const float4 d = *reinterpret_cast<const float4*>(D + m * N + j0);
      const float av[4] = {a.x, a.y, a.z, a.w}, dv[4] = {d.x, d.y, d.z, d.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[r][q] = fmaf(av[r], dv[q], acc[r][q]);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) part[(i0 + r) * N + j0 + q] += acc[r][q];
  }
}

// part[j] += Σ_m X[m][j]·(wm ? wm[m] : 1), X (BM × N) in shared.
template <int BM>
__device__ void column_sum(const float* X, int N, const float* wm, float* part) {
  for (int j = threadIdx.x; j < N; j += blockDim.x) {
    float s = 0.f;
    for (int m = 0; m < BM; ++m) s = wm ? fmaf(X[m * N + j], wm[m], s) : s + X[m * N + j];
    part[j] += s;
  }
}

// out[m] = Σ_j X[m][j]·v[j]: 256/BM consecutive lanes per member.
template <int BM>
__device__ void row_dot(const float* X, int N, const float* __restrict__ v, float* out) {
  constexpr int G = kThreads / BM;
  const int m = threadIdx.x / G, lg = threadIdx.x % G;
  float s = 0.f;
  for (int j = lg; j < N; j += G) s = fmaf(X[m * N + j], v[j], s);
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) s += __shfl_down_sync(kFull, s, off, G);
  if (lg == 0) out[m] = s;
}

// The chain at the states su (BM): a_1..a_L into shared memory.
template <int BM>
__device__ void chain(const DenseLayout& lay, const float* __restrict__ theta, const float* su,
                      float* const* act) {
  const int p0 = lay.P[0];
  const float* w1 = theta + lay.off_k[0];
  const float* b1 = theta + lay.off_b[0];
  for (int idx = threadIdx.x; idx < BM * p0; idx += blockDim.x) {
    const int m = idx / p0, j = idx % p0;
    act[0][idx] = fmaxf(fmaf(su[m], w1[j], b1[j]), 0.f);
  }
  __syncthreads();
  for (int l = 1; l < lay.L; ++l) {
    row_product<BM, 0>(act[l - 1], lay.P[l - 1], theta + lay.off_k[l], lay.P[l],
                       theta + lay.off_b[l], act[l]);
    __syncthreads();
  }
}

template <int BM>
__global__ void __launch_bounds__(kThreads)
dense_epoch_kernel(DenseLayout lay, int S, int B, const float* __restrict__ theta,
                   const float* __restrict__ theta_t, const float* __restrict__ dt,
                   const float* __restrict__ u0, const float* __restrict__ tgt, float inv_b,
                   float* __restrict__ traj, float* __restrict__ loss_m,
                   float* __restrict__ part_all) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  float* act[kMaxLayers];
  for (int l = 0; l < lay.L; ++l) act[l] = sm + lay.act_off[l];
  float* su = sm + lay.smem_floats - 3 * BM;  // states
  float* sg = su + BM;                        // cotangents g
  float* sf = sg + BM;                        // f, then df, then Σ dz_1·w_1
  const int L = lay.L, tid = threadIdx.x, m0 = blockIdx.x * BM;
  float* part = part_all + static_cast<size_t>(blockIdx.x) * lay.total;
  const float* wo = theta + lay.off_k[L];
  const float bo = theta[lay.off_b[L]];
  const int pl = lay.P[L - 1];

  for (int m = tid; m < BM; m += kThreads) {
    const bool ok = m0 + m < B;
    su[m] = ok ? u0[m0 + m] : 0.f;
    if (ok) traj[m0 + m] = su[m];
  }
  __syncthreads();
  for (int n = 0; n < S; ++n) {
    chain<BM>(lay, theta, su, act);
    row_dot<BM>(act[L - 1], pl, wo, sf);
    __syncthreads();
    for (int m = tid; m < BM; m += kThreads) {
      su[m] = fmaf(dt[n], sf[m] + bo, su[m]);
      if (m0 + m < B) traj[static_cast<size_t>(n + 1) * B + m0 + m] = su[m];
    }
    __syncthreads();
  }
  for (int m = tid; m < BM; m += kThreads) {
    const bool ok = m0 + m < B;
    const float e = ok ? su[m] - tgt[m0 + m] : 0.f;
    if (ok) loss_m[m0 + m] = e * e * inv_b;
    sg[m] = 2.f * e * inv_b;
  }
  __syncthreads();
  for (int n = S - 1; n >= 0; --n) {
    for (int m = tid; m < BM; m += kThreads)
      su[m] = m0 + m < B ? traj[static_cast<size_t>(n) * B + m0 + m] : 0.f;
    __syncthreads();
    chain<BM>(lay, theta, su, act);
    for (int m = tid; m < BM; m += kThreads) sf[m] = dt[n] * sg[m];
    __syncthreads();
    column_sum<BM>(act[L - 1], pl, sf, part + lay.off_k[L]);
    if (tid == 0) {
      float s = 0.f;
      for (int m = 0; m < BM; ++m) s += sf[m];
      part[lay.off_b[L]] += s;
    }
    __syncthreads();
    for (int idx = tid; idx < BM * pl; idx += kThreads) {
      const int m = idx / pl, j = idx % pl;
      act[L - 1][idx] = act[L - 1][idx] > 0.f ? sf[m] * wo[j] : 0.f;
    }
    __syncthreads();
    for (int l = L - 1; l >= 1; --l) {
      weight_grad<BM>(act[l - 1], lay.P[l - 1], act[l], lay.P[l], part + lay.off_k[l]);
      column_sum<BM>(act[l], lay.P[l], nullptr, part + lay.off_b[l]);
      __syncthreads();
      row_product<BM, 1>(act[l], lay.P[l], theta_t + lay.off_t[l], lay.P[l - 1], nullptr,
                         act[l - 1]);
      __syncthreads();
    }
    column_sum<BM>(act[0], lay.P[0], su, part + lay.off_k[0]);
    column_sum<BM>(act[0], lay.P[0], nullptr, part + lay.off_b[0]);
    row_dot<BM>(act[0], lay.P[0], theta + lay.off_k[0], sf);
    __syncthreads();
    for (int m = tid; m < BM; m += kThreads) sg[m] = sg[m] + sf[m];
    __syncthreads();
  }
}

// grads[p] = Σ_c part[c][p] in block order; one warp sums the loss terms.
__global__ void dense_reduce_kernel(int n_blocks, int total, const float* __restrict__ part,
                                    float* __restrict__ grads, int B,
                                    const float* __restrict__ loss_m, float* __restrict__ loss) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p < total) {
    float s = 0.f;
    for (int c = 0; c < n_blocks; ++c) s += part[static_cast<size_t>(c) * total + p];
    grads[p] = s;
  }
  if (blockIdx.x == 0 && threadIdx.x < 32) {
    float s = 0.f;
    for (int m = threadIdx.x; m < B; m += 32) s += loss_m[m];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(kFull, s, off);
    if (threadIdx.x == 0) loss[0] = s;
  }
}

template <int BM>
int launch(const DenseLayout& lay, int S, int B, const float* theta, const float* theta_t,
           const float* dt, const float* u0, const float* tgt, float inv_b, float* traj,
           float* loss_m, float* part, cudaStream_t s) {
  const int bytes = lay.smem_floats * static_cast<int>(sizeof(float));
  cudaError_t e = cudaFuncSetAttribute(dense_epoch_kernel<BM>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  dense_epoch_kernel<BM><<<(B + BM - 1) / BM, kThreads, bytes, s>>>(
      lay, S, B, theta, theta_t, dt, u0, tgt, inv_b, traj, loss_m, part);
  e = cudaGetLastError();
  return e == cudaSuccess ? 0 : static_cast<int>(e);
}

}  // namespace

extern "C" {

// Return 0 on success, -2 for a layer count outside 1..8 or an empty shape,
// -3 for a width that is not a positive multiple of 4, -4 for a member tile
// other than 16, 32, 64, -5 when the tiles exceed the block's shared memory,
// or the cudaError_t of a refused launch. part (n_blocks × total) must be
// zero; traj (S+1, B) and loss_m (B) are scratch.
int dense_epoch_grad(int L, const int* widths, int bm, int S, int B, const float* theta,
                     const float* theta_t, const float* dt, const float* u0, const float* tgt,
                     double inv_b, float* traj, float* loss_m, float* part, float* loss,
                     float* grads, void* stream) {
  if (L < 1 || L > kMaxLayers || S < 1 || B < 1) return -2;
  DenseLayout lay{};
  lay.L = L;
  for (int l = 0; l < L; ++l) {
    if (widths[l] < 4 || widths[l] % 4) return -3;
    lay.P[l] = widths[l];
  }
  if (bm != 16 && bm != 32 && bm != 64) return -4;
  int off = 0, t = 0, a = 0;
  lay.off_k[0] = 0;
  lay.off_b[0] = lay.P[0];
  off = 2 * lay.P[0];
  for (int l = 1; l < L; ++l) {
    lay.off_k[l] = off;
    off += lay.P[l - 1] * lay.P[l];
    lay.off_b[l] = off;
    off += lay.P[l];
    lay.off_t[l] = t;
    t += lay.P[l] * lay.P[l - 1];
  }
  lay.off_k[L] = off;
  off += lay.P[L - 1];
  lay.off_b[L] = off;
  lay.total = off + 1;
  for (int l = 0; l < L; ++l) {
    lay.act_off[l] = a;
    a += bm * lay.P[l];
  }
  lay.smem_floats = a + 3 * bm;
  if (lay.smem_floats * static_cast<int>(sizeof(float)) > kMaxSmem) return -5;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float ib = static_cast<float>(inv_b);
  int code = 0;
  switch (bm) {
    case 16: code = launch<16>(lay, S, B, theta, theta_t, dt, u0, tgt, ib, traj, loss_m, part, s); break;
    case 32: code = launch<32>(lay, S, B, theta, theta_t, dt, u0, tgt, ib, traj, loss_m, part, s); break;
    default: code = launch<64>(lay, S, B, theta, theta_t, dt, u0, tgt, ib, traj, loss_m, part, s); break;
  }
  if (code != 0) return code;
  const int n_blocks = (B + bm - 1) / bm;
  dense_reduce_kernel<<<(lay.total + 255) / 256, 256, 0, s>>>(n_blocks, lay.total, part, grads, B,
                                                              loss_m, loss);
  const cudaError_t e = cudaGetLastError();
  return e == cudaSuccess ? 0 : static_cast<int>(e);
}

const char* train_dense_error_string(int code) {
  if (code == -2) return "hidden layer count outside 1..8, or an empty shape";
  if (code == -3) return "a padded hidden width is not a positive multiple of 4";
  if (code == -4) return "member tile must be 16, 32 or 64";
  if (code == -5) return "activation tiles exceed the block's shared memory";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
