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
// gradient sums in one VMEM block across a sequential grid. Here:
//   1. resblock_tile_kernel, one CTA of 8 warps per tile of BM = 8·MW
//      members (the plan, ops/cuda/train_fused.resblock_plan, picks MW so
//      that the tiles fill the card). Each warp owns MW members for the
//      whole epoch and keeps their states, cotangents and loss terms in
//      registers; the lanes split the NEURON loop (lane l takes i ≡ l mod
//      32), so a member's forward sum and its reverse sum (the g_n update)
//      are lane-partial sums of ⌈F/32⌉ terms joined by a fixed xor-shuffle
//      tree, and the warp's MW members give independent chains to
//      interleave. The step's parameters sit in shared memory: all S steps
//      while they fit (resident), else one step at a time (streamed, a
//      barrier a step). The tile's trajectory (S+1, BM) and cotangents
//      times the step, g·dt (S, BM), stay in shared memory. Then every
//      thread takes (step, neuron) entries and sums their three gradient
//      contributions over the tile's members in member order, from shared
//      memory, into one (3, S, F) partial per tile, and thread 0 the
//      members' loss terms.
//   2. resblock_reduce_kernel, 32 entries and 8 rows of groups a block: the
//      tiles' partials in a fixed order (groups of kGroup consecutive tiles
//      in order, the groups' sums in order), the bias gradient −w1·Σ at the
//      end.
// Both orders are fixed, so two calls on the same inputs give bit-identical
// results. A gradient entry is a sum of BM, then kGroup, then ⌈tiles/kGroup⌉
// terms: resblock_kernel_tolerance's k_red (ops/cuda/train_fused.py
// reduce_terms_of).
// What bounds it on the H100: FP32 operations, ~16·S·F·B (t1_bound in
// chip_smoke.py): the forward and reverse neuron sums (~5 issue slots a
// neuron and member each) and the gradient sums (~8), spread over every
// SM's warps; the partials (n_tiles·3·S·F floats) cross L2 once.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 8;  // group rows of a reduction block of 32 entries
constexpr int kGroup = 16;
constexpr unsigned kFull = 0xffffffffu;
// shared memory a tile may hold with every step's parameters resident
constexpr int kResidentBytes = 96 * 1024;

// Σ over the warp's lanes by an xor butterfly: every lane ends with the
// same total (a + b == b + a exactly), in a fixed order.
__device__ __forceinline__ float lane_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

struct Args {
  int S, F, B, mixed, resident;
  const float* p;  // (3, S, F): bias, w1, w2
  const float* dt;
  const float* u0;
  const float* tgt;
  const float* wts;
  const int* n_active;
  float ramp, inv_b;
  float* part;       // (tiles, 3, S, F)
  float* part_loss;  // (tiles,)
};

__device__ __forceinline__ int active_of(const Args& a, int n) {
  return a.n_active ? min(max(a.n_active[n], 0), a.F) : a.F;
}

// The step's parameters in shared memory, [b (F), w1 (F), w2 (F)]: resident
// ones are read in place; streamed ones are copied in behind a barrier
// (every thread of the CTA calls this for the same n).
__device__ __forceinline__ const float* step_params(const Args& a, float* sp, int n) {
  if (a.resident) return sp + 3 * n * a.F;
  __syncthreads();
  for (int j = threadIdx.x; j < 3 * a.F; j += kThreads) {
    const int q = j / a.F;
    sp[j] = a.p[(q * a.S + n) * a.F + j - q * a.F];
  }
  __syncthreads();
  return sp;
}

template <int MW>
__global__ void __launch_bounds__(kThreads)
resblock_tile_kernel(const Args a) {
  constexpr int BM = kWarps * MW;
  extern __shared__ float sm[];
  const int S = a.S, F = a.F, B = a.B;
  float* sp = sm;  // parameters: 3·S·F resident, 3·F streamed
  float* traj = sp + (a.resident ? 3 * S * F : 3 * F);  // (S+1, BM)
  float* gcot = traj + (S + 1) * BM;                      // (S, BM) g·dt
  float* loss_s = gcot + S * BM;                          // (BM,)
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int m0 = blockIdx.x * BM;
  const int bm = min(BM, B - m0);
  if (a.resident) {
    for (int j = threadIdx.x; j < 3 * S * F; j += kThreads) {
      const int n = j / (3 * F), r = j - n * 3 * F, q = r / F;
      sp[j] = a.p[(q * S + n) * F + r - q * F];
    }
    __syncthreads();
  }

  // the forward march of the warp's members, the neuron sum split over lanes
  float u[MW];
#pragma unroll
  for (int j = 0; j < MW; ++j) {
    const int m = warp * MW + j;
    u[j] = m < bm ? a.u0[m0 + m] : 0.f;
    if (lane == 0) traj[m] = u[j];
  }
  for (int n = 0; n < S; ++n) {
    const float* pn = step_params(a, sp, n);
    const int na = active_of(a, n);
    float acc[MW];
#pragma unroll
    for (int j = 0; j < MW; ++j) acc[j] = 0.f;
    for (int i = lane; i < na; i += 32) {
      const float b = pn[i], w1 = pn[F + i], w2 = pn[2 * F + i];
#pragma unroll
      for (int j = 0; j < MW; ++j) acc[j] = fmaf(w2, fmaxf(w1 * (u[j] - b), 0.f), acc[j]);
    }
    const float dtn = a.dt[n];
#pragma unroll
    for (int j = 0; j < MW; ++j) {
      u[j] = fmaf(dtn, lane_sum(acc[j]), u[j]);
      if (lane == 0) traj[(n + 1) * BM + warp * MW + j] = u[j];
    }
  }
  __syncwarp();

  // the loss and the reverse sweep of the cotangent, split likewise
  float g[MW], loss[MW], w[MW];
  const float c_term = a.mixed ? a.dt[S - 1] * 0.5f + a.ramp : 1.f;
#pragma unroll
  for (int j = 0; j < MW; ++j) {
    const int m = warp * MW + j;
    const bool live = m < bm;
    w[j] = live && a.wts ? a.wts[m0 + m] : 1.f;
    const float e = live ? (u[j] - a.tgt[(a.mixed ? S * B : 0) + m0 + m]) * w[j] : 0.f;
    loss[j] = c_term * e * e * a.inv_b;
    g[j] = 2.f * c_term * e * a.inv_b;
  }
  for (int n = S - 1; n >= 0; --n) {
    const float* pn = step_params(a, sp, n);
    const int na = active_of(a, n);
    const float dtn = a.dt[n];
    float un[MW], gdt[MW], du[MW];
#pragma unroll
    for (int j = 0; j < MW; ++j) {
      un[j] = traj[n * BM + warp * MW + j];
      gdt[j] = g[j] * dtn;
      if (lane == 0) gcot[n * BM + warp * MW + j] = gdt[j];
      du[j] = 0.f;
    }
    for (int i = lane; i < na; i += 32) {
      const float b = pn[i], w1 = pn[F + i], w2 = pn[2 * F + i];
#pragma unroll
      for (int j = 0; j < MW; ++j) {
        if (w1 * (un[j] - b) > 0.f) du[j] = fmaf(gdt[j] * w2, w1, du[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < MW; ++j) {
      g[j] = g[j] + lane_sum(du[j]);
      if (a.mixed) {
        const int m = warp * MW + j;
        const float c_n = 0.5f * ((n > 0 ? a.dt[n - 1] : 0.f) + dtn);
        const float e_n = m < bm ? (un[j] - a.tgt[n * B + m0 + m]) * w[j] : 0.f;
        loss[j] += c_n * e_n * e_n * a.inv_b;
        g[j] += 2.f * c_n * e_n * a.inv_b;
      }
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < MW; ++j) loss_s[warp * MW + j] = loss[j];
  }
  __syncthreads();

  // each (step, neuron) entry summed over the tile's members in order
  float* part = a.part + static_cast<long>(blockIdx.x) * 3 * S * F;
  for (int idx = threadIdx.x; idx < S * F; idx += kThreads) {
    const int n = idx / F, i = idx - n * F;
    float gw2 = 0.f, gw1 = 0.f, sds = 0.f;
    if (i < active_of(a, n)) {
      const float b = a.p[idx], w1 = a.p[S * F + idx], w2 = a.p[2 * S * F + idx];
      const float* un = traj + n * BM;
      const float* gn = gcot + n * BM;
      for (int m = 0; m < bm; ++m) {
        const float gdt = gn[m];
        const float d = un[m] - b;
        const float s = w1 * d;
        if (s > 0.f) {
          const float ds = gdt * w2;
          gw2 = fmaf(gdt, s, gw2);
          gw1 = fmaf(ds, d, gw1);
          sds += ds;
        }
      }
    }
    part[idx] = sds;
    part[S * F + idx] = gw1;
    part[2 * S * F + idx] = gw2;
  }
  if (threadIdx.x == 0) {
    float s = 0.f;
    for (int m = 0; m < bm; ++m) s += loss_s[m];
    a.part_loss[blockIdx.x] = s;
  }
}

// grads (3, S, F): bias, w1, w2; entry 3·S·F is the loss. A block takes 32
// entries (threadIdx.x) and kRows rows (threadIdx.y): row y sums the groups
// y, y + kRows, … of its entry, each group's kGroup consecutive tiles in
// order (all kGroup loads in flight), into shared memory; then row 0 sums
// its entry's groups in order. The order is the two-level one of
// tiles_sum in ops/cuda/train_fused.py (_tiles_sum).
__global__ void __launch_bounds__(32 * kRows)
resblock_reduce_kernel(const Args a, int tiles, float* __restrict__ grads,
                       float* __restrict__ loss) {
  extern __shared__ float gs[];  // (groups, 32)
  const int SF = a.S * a.F;
  const int groups = (tiles + kGroup - 1) / kGroup;
  const int x = threadIdx.x, y = threadIdx.y;
  const int e = blockIdx.x * 32 + x;
  const bool live = e <= 3 * SF;
  const bool is_loss = e == 3 * SF;
  const float* src = is_loss ? a.part_loss : a.part + e;
  const long stride = is_loss ? 1 : 3L * SF;
  for (int g = y; g < groups; g += kRows) {
    float s = 0.f;
    if (live) {
      const int t0 = g * kGroup;
      float v[kGroup];
#pragma unroll
      for (int k = 0; k < kGroup; ++k) v[k] = t0 + k < tiles ? src[(t0 + k) * stride] : 0.f;
#pragma unroll
      for (int k = 0; k < kGroup; ++k) {
        if (t0 + k < tiles) s += v[k];
      }
    }
    gs[g * 32 + x] = s;
  }
  __syncthreads();
  if (y != 0 || !live) return;
  float total = 0.f;
  for (int g = 0; g < groups; ++g) total += gs[g * 32 + x];
  if (is_loss) {
    loss[0] = total;
  } else if (e >= SF) {
    grads[e] = total;
  } else {
    const int n = e / a.F;
    grads[e] = e - n * a.F < active_of(a, n) ? -a.p[SF + e] * total : 0.f;
  }
}

template <int MW>
int launch_tiles(const Args& a, int tiles, int smem, cudaStream_t s) {
  static int opted_in = 48 * 1024;  // the dynamic shared memory allowed so far
  if (smem > opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        resblock_tile_kernel<MW>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    opted_in = smem;
  }
  resblock_tile_kernel<MW><<<tiles, kThreads, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Shared memory of a tile of block_members members, in bytes; *resident
// says whether every step's parameters fit (else they stream a step at a
// time).
int resblock_tile_smem(int S, int F, int block_members, int* resident) {
  const long rest = (2L * S + 2) * block_members;
  const long all = 4 * (3L * S * F + rest);
  *resident = all <= kResidentBytes;
  return static_cast<int>(*resident ? all : 4 * (3L * F + rest));
}

// Return 0 on success, -2 for an empty shape, -4 for a member tile the
// kernel is not built for (8, 16, 32 or 64), -5 for a shape past the shared
// memory, or the cudaError_t of a refused launch. part ((B/block_members
// rounded up)·3·S·F floats) and part_loss (as many) are scratch; weights
// and n_active may be null; targets are (B) or, mixed, (S+1, B).
int resblock_epoch_grad(int S, int F, int B, int mixed, int block_members,
                        const float* p, const float* dt, const float* u0,
                        const float* tgt, const float* wts, const int* n_active,
                        double ramp, double inv_b, float* part, float* part_loss,
                        float* loss, float* grads, void* stream) {
  if (S < 1 || F < 1 || B < 1) return -2;
  int resident = 0;
  const int smem = resblock_tile_smem(S, F, block_members, &resident);
  if (smem > 227 * 1024) return -5;
  const Args a{S, F, B, mixed, resident, p, dt, u0, tgt, wts, n_active,
               static_cast<float>(ramp), static_cast<float>(inv_b), part, part_loss};
  const int tiles = (B + block_members - 1) / block_members;
  const int groups = (tiles + kGroup - 1) / kGroup;
  if (groups * 32 * 4 > 48 * 1024) return -5;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int code;
  switch (block_members) {
    case 8: code = launch_tiles<1>(a, tiles, smem, s); break;
    case 16: code = launch_tiles<2>(a, tiles, smem, s); break;
    case 32: code = launch_tiles<4>(a, tiles, smem, s); break;
    case 64: code = launch_tiles<8>(a, tiles, smem, s); break;
    default: return -4;
  }
  if (code != 0) return code;
  const long entries = 3L * S * F + 1;
  resblock_reduce_kernel<<<static_cast<int>((entries + 31) / 32), dim3(32, kRows),
                           groups * 32 * 4, s>>>(a, tiles, grads, loss);
  return static_cast<int>(cudaGetLastError());
}

const char* train_fused_error_string(int code) {
  if (code == -2) return "empty shape (S, F and B must be >= 1)";
  if (code == -4) return "member tile (the kernel takes 8, 16, 32 or 64 members a tile)";
  if (code == -5)
    return "past the shared memory (the member tile's trajectory and cotangents, or "
           "more than 6,144 tiles for the reduction's groups of 16)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
