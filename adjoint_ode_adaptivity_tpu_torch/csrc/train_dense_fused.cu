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
// Design for this card: a thread-block cluster of C CTAs (C = 1, 2, 4, 8) for
// each tile of BM members (BM = 16, 32, 64), 256 threads a CTA. Below,
// layer 0 is the first hidden layer (a_1 above) and layer l ≥ 1 has the
// matrix W_l (P_{l−1} × P_l) in front of it. CTA r of a cluster owns the
// column slice J_r = [r·jw_l, (r+1)·jw_l) ∩ [0, P_l) of every layer l ≥ 1
// (jw_l = P_l/C rounded up to 4):
//
// - at launch it copies W_l[:, J_r], b_l[J_r], w_out[J_r] (and w_1, b_1,
//   which every CTA needs) into its own shared memory with cp.async, once;
//   no weight is read from L2 or device memory again for the whole epoch;
// - forward and recompute: every CTA forms a_0 itself (BM·P_0 elementwise
//   operations), then a_l[:, J_r] = relu(a_{l−1} W_l[:, J_r] + b_l[J_r]);
//   for a layer below the last, a cluster barrier, then each CTA gathers the
//   other ranks' slices of a_l from their shared memory (DSMEM,
//   map_shared_rank), so every CTA holds the whole a_l. The last layer stays
//   split: f is C partial dots a_L[:, J_r]·w_out[J_r], summed in rank order
//   after a cluster barrier, so every CTA carries the same bits of u;
// - backward: dz_l[:, J_r] stays in its CTA; ∂W_l[:, J_r] += a_{l−1}ᵀ
//   dz_l[:, J_r] and ∂b_l[J_r] are this CTA's entries; da_{l−1} is formed as
//   one BM × P_{l−1} partial product dz_l[:, J_r] W_l[:, J_r]ᵀ per CTA, and
//   after a cluster barrier each CTA sums the C partials in rank order over
//   DSMEM for the columns it owns of layer l−1 (for layer 0: all of them, in
//   every CTA). The fixed order keeps two calls bit-identical;
// - every product is IEEE FP32 FMAs on shared-memory operands, a 4 × 4
//   register tile of outputs a thread, 16-byte loads; no tensor cores, no
//   TF32, no library call. The partial product reads rows of the W_l slice
//   4 apart in different lanes; its row stride sw ≡ 4 (mod 8) floats keeps
//   the 16-byte loads of a quarter warp on distinct banks;
// - the bf16 mode (the TPU kernel's opt-in mxu_dtype=bfloat16, _dot
//   train_dense_fused.py:124-134) runs the three hidden products (forward
//   and recompute, ∂W_l, dz_l·W_lᵀ) on the tensor cores: mma.sync.aligned.
//   m16n8k16.row.col.f32.bf16.bf16.f32, one warp a strip of 16 × 8·NB
//   outputs (NB = 4, 2 or 1 MMA tiles sharing their A fragment), the
//   operands rounded to bf16 with round-to-nearest-even as they are loaded
//   (JAX's astype), the products summed in f32 accumulators. Each CTA holds
//   its slice of W_l once, rounded to bf16 and transposed (a row a column
//   j, contraction index contiguous, row stride P_{l−1} + 8 halves ≡ 4
//   (mod 8) words so the fragment loads of a warp fall on distinct banks):
//   half the f32 slice, so larger tiles fit. Hidden widths arrive padded
//   to multiples of 16 (the MMA's depth), slices to multiples of 16, with
//   zeros that relu keeps inert. Everything else stays f32 as in JAX: the
//   first layer's outer product, the output layer, the scalar march, the
//   relu masks, the biases and the gradient buffers, and the cluster's
//   gathers and rank-order sums. The f32 mode is a separate instance of
//   the same template, unchanged;
// - gradients: each entry has exactly one owner in a tile (CTA r the entries
//   of its slices, rank 0 w_1, b_1 and b_out), which adds its per-step sums
//   into the tile's row of a partial-gradient buffer (L2-resident); a second
//   launch sums the rows in tile order: deterministic. Each CTA keeps its
//   own copy of the tile's scalar trajectory (C · (S+1) · B floats in all),
//   so no CTA reads device memory another wrote during the launch.
//
// What bounds it on the H100: FP32 operations, 4·2·B·S·Σ H_{l−1}H_l for the
// hidden products (forward, recompute, ∂W, ∂a); in the bf16 mode those run
// on the tensor cores (989 TFLOP/s dense bf16 against 67 TFLOP/s FP32), and
// the f32 elementwise work and the shared-memory traffic of the fragments
// (each operand element loaded and converted once a tile) remain. The cluster splits each
// tile's products over C SMs, so a small B still fills the card (B = 512:
// 16 tiles × 8 = 128 CTAs), and the weights live in shared memory, not L2.
// The wrapper picks (BM, C) (ops/cuda/train_dense_fused.py dense_plan).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxLayers = 8;
constexpr int kThreads = 256;
constexpr int kMaxSmem = 227 * 1024;
constexpr unsigned kFull = 0xffffffffu;

int pad4(int n) { return (n + 3) / 4 * 4; }
int pad16(int n) { return (n + 15) / 16 * 16; }

struct DenseLayout {
  int L, bm, C, bf16;
  int P[kMaxLayers];           // padded widths
  int jw[kMaxLayers];          // columns a rank owns of layer l (layer 0: all)
  int sw[kMaxLayers];          // row stride of the W_l slice (floats; bf16: halves of Wᵀ)
  int ld[kMaxLayers];          // row stride of layer l's activations in shared memory
  int off_k[kMaxLayers + 1];   // theta: w_1, W_1..W_{L−1}, w_out
  int off_b[kMaxLayers + 1];   // theta: b_1, b_2..b_L, b_out
  int s_w[kMaxLayers];         // shared memory (floats): W_l[:, J_r]
  int s_b[kMaxLayers];         // b_l[J_r]
  int s_act[kMaxLayers];       // a_l, then dz_l: whole for l < L−1, the slice for L−1
  int s_w1, s_b1, s_wo, s_dpart, s_vec;
  int total, row, smem_floats;
};

// The columns [j0, j0 + n) of layer l that rank r owns.
struct Slice {
  int j0, n;
};

__device__ __forceinline__ Slice slice_of(const DenseLayout& lay, int l, int r) {
  if (l == 0) return {0, lay.P[0]};
  const int j0 = r * lay.jw[l];
  const int left = lay.P[l] - j0;
  return {j0, left < 0 ? 0 : (left < lay.jw[l] ? left : lay.jw[l])};
}

// The column of layer l's activation buffer where rank r's slice starts:
// layers below the last hold every column, the last only the slice.
__device__ __forceinline__ int slice_col(const DenseLayout& lay, int l, int r) {
  return l < lay.L - 1 ? slice_of(lay, l, r).j0 : 0;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

// n floats (a multiple of 4, 16-byte aligned at both ends) to shared memory.
__device__ __forceinline__ void load_vec(float* dst, const float* src, int n) {
  for (int i = threadIdx.x; i < n / 4; i += kThreads) cp_async16(dst + 4 * i, src + 4 * i);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float comp(const float4& v, int i) {
  return i == 0 ? v.x : (i == 1 ? v.y : (i == 2 ? v.z : v.w));
}

// out (bm × n, row stride ldo) = relu(A W + bias): A (bm × K, row stride K),
// W (K × n, row stride ldw), bias (n). 4 × 4 outputs a thread, k ascending.
__device__ __forceinline__ void fwd_product(const float* A, int K, const float* W, int ldw,
                                            int n, const float* bias, float* out, int ldo,
                                            int bm) {
  const int nct = n / 4;
  const int ntile = (bm / 4) * nct;
  for (int t = threadIdx.x; t < ntile; t += kThreads) {
    const int m0 = (t / nct) * 4, j0 = (t % nct) * 4;
    float acc[4][4] = {};
#pragma unroll 2
    for (int k = 0; k < K; k += 4) {
      float4 a[4], w[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = ld4(A + (m0 + r) * K + k);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) w[kk] = ld4(W + (k + kk) * ldw + j0);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float av = comp(a[r], kk);
          acc[r][0] = fmaf(av, w[kk].x, acc[r][0]);
          acc[r][1] = fmaf(av, w[kk].y, acc[r][1]);
          acc[r][2] = fmaf(av, w[kk].z, acc[r][2]);
          acc[r][3] = fmaf(av, w[kk].w, acc[r][3]);
        }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float4 o;
      o.x = fmaxf(acc[r][0] + bias[j0], 0.f);
      o.y = fmaxf(acc[r][1] + bias[j0 + 1], 0.f);
      o.z = fmaxf(acc[r][2] + bias[j0 + 2], 0.f);
      o.w = fmaxf(acc[r][3] + bias[j0 + 3], 0.f);
      *reinterpret_cast<float4*>(out + (m0 + r) * ldo + j0) = o;
    }
  }
}

// part[i·ldp + j] += Σ_m A[m][i]·D[m][j] (m ascending): A (bm × K, row stride
// K), D (bm × n, row stride ldd), part in device memory. 4 × 4 a thread.
__device__ __forceinline__ void weight_grad(const float* A, int K, const float* D, int ldd,
                                            int n, float* part, int ldp, int bm) {
  const int nct = n / 4;
  const int ntile = (K / 4) * nct;
  for (int t = threadIdx.x; t < ntile; t += kThreads) {
    const int i0 = (t / nct) * 4, j0 = (t % nct) * 4;
    float acc[4][4] = {};
#pragma unroll 2
    for (int m = 0; m < bm; ++m) {
      const float4 a = ld4(A + m * K + i0);
      const float4 d = ld4(D + m * ldd + j0);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float av = comp(a, r);
        acc[r][0] = fmaf(av, d.x, acc[r][0]);
        acc[r][1] = fmaf(av, d.y, acc[r][1]);
        acc[r][2] = fmaf(av, d.z, acc[r][2]);
        acc[r][3] = fmaf(av, d.w, acc[r][3]);
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float4* p = reinterpret_cast<float4*>(part + (i0 + r) * ldp + j0);
      float4 v = *p;
      v.x += acc[r][0];
      v.y += acc[r][1];
      v.z += acc[r][2];
      v.w += acc[r][3];
      *p = v;
    }
  }
}

// E (bm × K, row stride K) = D Wᵀ over this rank's n columns: E[m][i] =
// Σ_j D[m][j]·W[i][j] (j ascending), D (bm × n, row stride ldd), W (K × n,
// row stride ldw). A thread takes members m0..m0+3 and rows i, i + K/4,
// i + K/2, i + 3K/4, so neighbouring lanes read neighbouring rows of W.
__device__ __forceinline__ void partial_product(const float* D, int ldd, int n,
                                                const float* W, int ldw, int K, float* E,
                                                int bm) {
  const int kq = K / 4;
  const int ntile = (bm / 4) * kq;
  for (int t = threadIdx.x; t < ntile; t += kThreads) {
    const int m0 = (t / kq) * 4, i = t % kq;
    float acc[4][4] = {};
#pragma unroll 2
    for (int j = 0; j < n; j += 4) {
      float4 d[4], w[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) d[r] = ld4(D + (m0 + r) * ldd + j);
#pragma unroll
      for (int q = 0; q < 4; ++q) w[q] = ld4(W + (i + q * kq) * ldw + j);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float dv = comp(d[r], jj);
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[r][q] = fmaf(dv, comp(w[q], jj), acc[r][q]);
        }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) E[(m0 + r) * K + i + q * kq] = acc[r][q];
  }
}

// ---- the bf16 mode's products on the tensor cores. Fragments of
// mma.m16n8k16 (PTX ISA, "Matrix Fragments for mma.m16n8k16"): with g =
// lane / 4 and t = lane % 4, A (16 × 16, row) a0 = (g, 2t..2t+1), a1 =
// (g+8, 2t..), a2 = (g, 2t+8..), a3 = (g+8, 2t+8..); B (16 × 8, col) b0 =
// (2t..2t+1, g), b1 = (2t+8..2t+9, g); C d0, d1 = (g, 2t..2t+1), d2, d3 =
// (g+8, 2t..2t+1). A pair's lower index sits in the lower 16 bits.

// Two floats rounded to bf16 (round to nearest even) as one packed pair.
__device__ __forceinline__ unsigned bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

__device__ __forceinline__ unsigned bf16x2(const float2& v) { return bf16x2(v.x, v.y); }

// Two bf16 halves 1 row apart as one packed pair.
__device__ __forceinline__ unsigned bf16_pair(const __nv_bfloat16* p, int stride) {
  const unsigned lo = *reinterpret_cast<const unsigned short*>(p);
  const unsigned hi = *reinterpret_cast<const unsigned short*>(p + stride);
  return lo | (hi << 16);
}

__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// d += A·B on one 16 × 8 × 16 tile: bf16 operands, f32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], unsigned a0, unsigned a1, unsigned a2,
                                         unsigned a3, unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// The bf16 products give each warp a 16 × 8·NB strip of outputs (NB n-tiles
// of the MMA side by side), so a strip's A fragment is loaded and converted
// once for its NB MMAs; every output element still sums its k-steps in
// ascending order, whatever NB. strip_nb picks the widest strip (4, 2, 1)
// that divides n and still gives the CTA's 8 warps two strips each.
__device__ __forceinline__ int strip_nb(int row_tiles, int n) {
  if (n % 32 == 0 && row_tiles * (n / 32) >= 2 * kThreads / 32) return 4;
  if (n % 16 == 0 && row_tiles * (n / 16) >= 2 * kThreads / 32) return 2;
  return 1;
}

// out (bm × n, row stride ldo) = relu(bf16(A) bf16(W) + bias): A (bm × K,
// row stride K) f32, the slice W held as Wt (n × K, row stride ldw halves,
// bf16), bias (n); K a multiple of 16, n of 8·NB.
template <int NB>
__device__ __forceinline__ void fwd_strips(const float* A, int K, const __nv_bfloat16* Wt,
                                           int ldw, int n, const float* bias, float* out,
                                           int ldo, int bm) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int nt = n / (8 * NB);
  for (int tile = threadIdx.x >> 5; tile < (bm / 16) * nt; tile += kThreads / 32) {
    const int m0 = (tile / nt) * 16, j0 = (tile % nt) * 8 * NB;
    const float* a_lo = A + (m0 + g) * K + 2 * t;
    const float* a_hi = a_lo + 8 * K;
    const __nv_bfloat16* w = Wt + (j0 + g) * ldw + 2 * t;
    float d[NB][4] = {};
    for (int k = 0; k < K; k += 16) {
      const unsigned a0 = bf16x2(ld2(a_lo + k)), a1 = bf16x2(ld2(a_hi + k));
      const unsigned a2 = bf16x2(ld2(a_lo + k + 8)), a3 = bf16x2(ld2(a_hi + k + 8));
#pragma unroll
      for (int q = 0; q < NB; ++q) {
        const __nv_bfloat16* wq = w + q * 8 * ldw + k;
        mma_bf16(d[q], a0, a1, a2, a3, *reinterpret_cast<const unsigned*>(wq),
                 *reinterpret_cast<const unsigned*>(wq + 8));
      }
    }
#pragma unroll
    for (int q = 0; q < NB; ++q) {
      const int j = j0 + 8 * q + 2 * t;
      float* o = out + (m0 + g) * ldo + j;
      o[0] = fmaxf(d[q][0] + bias[j], 0.f);
      o[1] = fmaxf(d[q][1] + bias[j + 1], 0.f);
      o[8 * ldo] = fmaxf(d[q][2] + bias[j], 0.f);
      o[8 * ldo + 1] = fmaxf(d[q][3] + bias[j + 1], 0.f);
    }
  }
}

__device__ __forceinline__ void fwd_product_bf16(const float* A, int K,
                                                 const __nv_bfloat16* Wt, int ldw, int n,
                                                 const float* bias, float* out, int ldo,
                                                 int bm) {
  switch (strip_nb(bm / 16, n)) {
    case 4: return fwd_strips<4>(A, K, Wt, ldw, n, bias, out, ldo, bm);
    case 2: return fwd_strips<2>(A, K, Wt, ldw, n, bias, out, ldo, bm);
    default: return fwd_strips<1>(A, K, Wt, ldw, n, bias, out, ldo, bm);
  }
}

// part[i·ldp + j] += Σ_m bf16(A[m][i])·bf16(D[m][j]): A (bm × K, row stride
// K), D (bm × n, row stride ldd), part in device memory; K a multiple of 16,
// n of 8·NB; the members are the MMA's depth.
template <int NB>
__device__ __forceinline__ void grad_strips(const float* A, int K, const float* D, int ldd,
                                            int n, float* part, int ldp, int bm) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int nt = n / (8 * NB);
  for (int tile = threadIdx.x >> 5; tile < (K / 16) * nt; tile += kThreads / 32) {
    const int i0 = (tile / nt) * 16, j0 = (tile % nt) * 8 * NB;
    float d[NB][4] = {};
    for (int m = 0; m < bm; m += 16) {
      const float* a = A + (m + 2 * t) * K + i0 + g;  // rows m + 2t, m + 2t + 1, …
      const unsigned a0 = bf16x2(a[0], a[K]), a1 = bf16x2(a[8], a[K + 8]);
      const unsigned a2 = bf16x2(a[8 * K], a[9 * K]), a3 = bf16x2(a[8 * K + 8], a[9 * K + 8]);
#pragma unroll
      for (int q = 0; q < NB; ++q) {
        const float* b = D + (m + 2 * t) * ldd + j0 + 8 * q + g;
        mma_bf16(d[q], a0, a1, a2, a3, bf16x2(b[0], b[ldd]), bf16x2(b[8 * ldd], b[9 * ldd]));
      }
    }
#pragma unroll
    for (int q = 0; q < NB; ++q) {
      float* p = part + (i0 + g) * ldp + j0 + 8 * q + 2 * t;
      p[0] += d[q][0];
      p[1] += d[q][1];
      p[8 * ldp] += d[q][2];
      p[8 * ldp + 1] += d[q][3];
    }
  }
}

__device__ __forceinline__ void weight_grad_bf16(const float* A, int K, const float* D, int ldd,
                                                 int n, float* part, int ldp, int bm) {
  switch (strip_nb(K / 16, n)) {
    case 4: return grad_strips<4>(A, K, D, ldd, n, part, ldp, bm);
    case 2: return grad_strips<2>(A, K, D, ldd, n, part, ldp, bm);
    default: return grad_strips<1>(A, K, D, ldd, n, part, ldp, bm);
  }
}

// E (bm × K, row stride K) = bf16(D) bf16(W)ᵀ over this rank's n columns:
// E[m][i] = Σ_j D[m][j]·Wt[j][i], D (bm × n, row stride ldd) f32, Wt (n × K,
// row stride ldw halves); n a multiple of 16, K of 8·NB.
template <int NB>
__device__ __forceinline__ void partial_strips(const float* D, int ldd, int n,
                                               const __nv_bfloat16* Wt, int ldw, int K,
                                               float* E, int bm) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int it = K / (8 * NB);
  for (int tile = threadIdx.x >> 5; tile < (bm / 16) * it; tile += kThreads / 32) {
    const int m0 = (tile / it) * 16, i0 = (tile % it) * 8 * NB;
    const float* a_lo = D + (m0 + g) * ldd + 2 * t;
    const float* a_hi = a_lo + 8 * ldd;
    const __nv_bfloat16* w = Wt + (2 * t) * ldw + i0 + g;
    float d[NB][4] = {};
    for (int j = 0; j < n; j += 16) {
      const unsigned a0 = bf16x2(ld2(a_lo + j)), a1 = bf16x2(ld2(a_hi + j));
      const unsigned a2 = bf16x2(ld2(a_lo + j + 8)), a3 = bf16x2(ld2(a_hi + j + 8));
#pragma unroll
      for (int q = 0; q < NB; ++q) {
        const __nv_bfloat16* wq = w + 8 * q;
        mma_bf16(d[q], a0, a1, a2, a3, bf16_pair(wq + j * ldw, ldw),
                 bf16_pair(wq + (j + 8) * ldw, ldw));
      }
    }
#pragma unroll
    for (int q = 0; q < NB; ++q) {
      float* e = E + (m0 + g) * K + i0 + 8 * q + 2 * t;
      e[0] = d[q][0];
      e[1] = d[q][1];
      e[8 * K] = d[q][2];
      e[8 * K + 1] = d[q][3];
    }
  }
}

__device__ __forceinline__ void partial_product_bf16(const float* D, int ldd, int n,
                                                     const __nv_bfloat16* Wt, int ldw, int K,
                                                     float* E, int bm) {
  switch (strip_nb(bm / 16, K)) {
    case 4: return partial_strips<4>(D, ldd, n, Wt, ldw, K, E, bm);
    case 2: return partial_strips<2>(D, ldd, n, Wt, ldw, K, E, bm);
    default: return partial_strips<1>(D, ldd, n, Wt, ldw, K, E, bm);
  }
}

// out[m] = Σ_j X[m][j]·v[j] over n columns: 256/bm consecutive lanes per
// member, a fixed shuffle tree.
__device__ __forceinline__ void row_dot(const float* X, int ldx, int n, const float* v,
                                        float* out, int bm) {
  const int g = kThreads / bm;
  const int m = threadIdx.x / g, lg = threadIdx.x % g;
  float s = 0.f;
  for (int j = lg; j < n; j += g) s = fmaf(X[m * ldx + j], v[j], s);
  for (int off = g / 2; off > 0; off >>= 1) s += __shfl_down_sync(kFull, s, off, g);
  if (lg == 0) out[m] = s;
}

// The chain at the states su (bm): a_0 .. a_{L−1} into shared memory, each
// layer below the last whole in every CTA, the last as this rank's slice.
template <bool kBf16>
__device__ __forceinline__ void chain(const DenseLayout& lay, int rank,
                                      cg::cluster_group& cluster, const float* sm,
                                      const float* su, float* const* act) {
  const int p0 = lay.P[0], bm = lay.bm;
  const float* w1 = sm + lay.s_w1;
  const float* b1 = sm + lay.s_b1;
  for (int idx = threadIdx.x; idx < bm * p0; idx += kThreads) {
    const int m = idx / p0, j = idx % p0;
    act[0][idx] = fmaxf(fmaf(su[m], w1[j], b1[j]), 0.f);
  }
  __syncthreads();
  for (int l = 1; l < lay.L; ++l) {
    const Slice s = slice_of(lay, l, rank);
    if constexpr (kBf16) {
      fwd_product_bf16(act[l - 1], lay.P[l - 1],
                       reinterpret_cast<const __nv_bfloat16*>(sm + lay.s_w[l]), lay.sw[l], s.n,
                       sm + lay.s_b[l], act[l] + slice_col(lay, l, rank), lay.ld[l], bm);
    } else {
      fwd_product(act[l - 1], lay.P[l - 1], sm + lay.s_w[l], lay.sw[l], s.n, sm + lay.s_b[l],
                  act[l] + slice_col(lay, l, rank), lay.ld[l], bm);
    }
    if (l < lay.L - 1) {
      cluster.sync();  // every rank's slice of a_l is written
      const int p = lay.P[l];
      for (int q = 0; q < lay.C; ++q) {
        if (q == rank) continue;
        const Slice sq = slice_of(lay, l, q);
        const float* src = cluster.map_shared_rank(act[l], q);
        const int nq = sq.n / 4;
        for (int idx = threadIdx.x; idx < bm * nq; idx += kThreads) {
          const int o = (idx / nq) * p + sq.j0 + 4 * (idx % nq);
          *reinterpret_cast<float4*>(act[l] + o) = ld4(src + o);
        }
      }
    }
    __syncthreads();
  }
}

template <bool kBf16>
__global__ void __launch_bounds__(kThreads)
dense_cluster_kernel(DenseLayout lay, int S, int B, const float* __restrict__ theta,
                     const float* __restrict__ dt, const float* __restrict__ u0,
                     const float* __restrict__ tgt, float inv_b, float* traj,
                     float* __restrict__ loss_m, float* __restrict__ part_all) {
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int L = lay.L, bm = lay.bm, C = lay.C, tid = threadIdx.x;
  const int rank = static_cast<int>(cluster.block_rank());
  const int tile = blockIdx.x / C;
  const int m0 = tile * bm;
  float* part = part_all + static_cast<size_t>(tile) * lay.row;
  float* my_traj = traj + static_cast<size_t>(rank) * (S + 1) * B;
  const Slice last = slice_of(lay, L - 1, rank);

  // the weights this CTA uses, into shared memory once
  load_vec(sm + lay.s_w1, theta + lay.off_k[0], lay.P[0]);
  load_vec(sm + lay.s_b1, theta + lay.off_b[0], lay.P[0]);
  load_vec(sm + lay.s_wo, theta + lay.off_k[L] + last.j0, last.n);
  for (int l = 1; l < L; ++l) {
    const Slice s = slice_of(lay, l, rank);
    if constexpr (kBf16) {  // rounded once, transposed: Wt[j][i] = bf16(W[i][j0 + j])
      __nv_bfloat16* wt = reinterpret_cast<__nv_bfloat16*>(sm + lay.s_w[l]);
      for (int idx = tid; idx < lay.P[l - 1] * s.n; idx += kThreads) {
        const int i = idx / s.n, j = idx % s.n;
        wt[j * lay.sw[l] + i] =
            __float2bfloat16_rn(theta[lay.off_k[l] + i * lay.P[l] + s.j0 + j]);
      }
    } else {
      const int nq = s.n / 4;
      for (int idx = tid; idx < lay.P[l - 1] * nq; idx += kThreads) {
        const int i = idx / nq, j = 4 * (idx % nq);
        cp_async16(sm + lay.s_w[l] + i * lay.sw[l] + j,
                   theta + lay.off_k[l] + i * lay.P[l] + s.j0 + j);
      }
    }
    load_vec(sm + lay.s_b[l], theta + lay.off_b[l] + s.j0, s.n);
  }
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
  const float bo = theta[lay.off_b[L]];
  float* act[kMaxLayers];
  for (int l = 0; l < L; ++l) act[l] = sm + lay.s_act[l];
  const float* wo = sm + lay.s_wo;
  const float* w1 = sm + lay.s_w1;
  float* dpart = sm + lay.s_dpart;
  float* su = sm + lay.s_vec;  // states
  float* sg = su + bm;         // cotangents g
  float* sf = sg + bm;         // df
  float* fpart = sf + bm;      // the partial dots of f, by step parity (2·bm)
  float* gpart = fpart + 2 * bm;
  for (int m = tid; m < bm; m += kThreads) {
    const bool ok = m0 + m < B;
    su[m] = ok ? u0[m0 + m] : 0.f;
    if (ok) my_traj[m0 + m] = su[m];
  }
  cluster.sync();  // the cluster runs and every CTA's weights have landed

  for (int n = 0; n < S; ++n) {
    chain<kBf16>(lay, rank, cluster, sm, su, act);
    float* fp = fpart + (n & 1) * bm;  // read by the other ranks until step n + 1's barrier
    row_dot(act[L - 1], lay.ld[L - 1], last.n, wo, fp, bm);
    cluster.sync();
    for (int m = tid; m < bm; m += kThreads) {
      float f = *cluster.map_shared_rank(fp + m, 0);
      for (int q = 1; q < C; ++q) f += *cluster.map_shared_rank(fp + m, q);
      su[m] = fmaf(dt[n], f + bo, su[m]);
      if (m0 + m < B) my_traj[static_cast<size_t>(n + 1) * B + m0 + m] = su[m];
    }
    __syncthreads();
  }
  for (int m = tid; m < bm; m += kThreads) {
    const bool ok = m0 + m < B;
    const float e = ok ? su[m] - tgt[m0 + m] : 0.f;
    if (ok && rank == 0) loss_m[m0 + m] = e * e * inv_b;
    sg[m] = 2.f * e * inv_b;
  }
  __syncthreads();

  bool dpart_read = false;  // the other ranks may still read dpart
  for (int n = S - 1; n >= 0; --n) {
    for (int m = tid; m < bm; m += kThreads)
      su[m] = m0 + m < B ? my_traj[static_cast<size_t>(n) * B + m0 + m] : 0.f;
    __syncthreads();
    chain<kBf16>(lay, rank, cluster, sm, su, act);
    for (int m = tid; m < bm; m += kThreads) sf[m] = dt[n] * sg[m];
    __syncthreads();
    {  // the output layer: ∂w_out[J], ∂b_out, then dz_{L−1} in place
      float* a = act[L - 1];
      const int ld = lay.ld[L - 1];
      for (int j = tid; j < last.n; j += kThreads) {
        float s = 0.f;
        for (int m = 0; m < bm; ++m) s = fmaf(a[m * ld + j], sf[m], s);
        part[lay.off_k[L] + last.j0 + j] += s;
        const float w = wo[j];
        for (int m = 0; m < bm; ++m) a[m * ld + j] = a[m * ld + j] > 0.f ? sf[m] * w : 0.f;
      }
      if (rank == 0 && tid == 0) {
        float s = 0.f;
        for (int m = 0; m < bm; ++m) s += sf[m];
        part[lay.off_b[L]] += s;
      }
    }
    __syncthreads();
    for (int l = L - 1; l >= 1; --l) {
      const Slice s = slice_of(lay, l, rank);
      const float* dz = act[l] + slice_col(lay, l, rank);
      const int ldz = lay.ld[l];
      if constexpr (kBf16) {
        weight_grad_bf16(act[l - 1], lay.P[l - 1], dz, ldz, s.n, part + lay.off_k[l] + s.j0,
                         lay.P[l], bm);
      } else {
        weight_grad(act[l - 1], lay.P[l - 1], dz, ldz, s.n, part + lay.off_k[l] + s.j0,
                    lay.P[l], bm);
      }
      for (int j = tid; j < s.n; j += kThreads) {
        float c = 0.f;
        for (int m = 0; m < bm; ++m) c += dz[m * ldz + j];
        part[lay.off_b[l] + s.j0 + j] += c;
      }
      if (dpart_read) cluster.sync();  // every rank has read the last partials
      if constexpr (kBf16) {
        partial_product_bf16(dz, ldz, s.n, reinterpret_cast<const __nv_bfloat16*>(sm + lay.s_w[l]),
                             lay.sw[l], lay.P[l - 1], dpart, bm);
      } else {
        partial_product(dz, ldz, s.n, sm + lay.s_w[l], lay.sw[l], lay.P[l - 1], dpart, bm);
      }
      dpart_read = true;
      cluster.sync();
      // da_{l−1} over the columns this rank owns, the C partials in rank
      // order, times the relu mask of a_{l−1}: dz_{l−1} in place
      const Slice t = slice_of(lay, l - 1, rank);
      const int k = lay.P[l - 1], nq = t.n / 4;
      for (int idx = tid; idx < bm * nq; idx += kThreads) {
        const int o = (idx / nq) * k + t.j0 + 4 * (idx % nq);
        float4 v = ld4(cluster.map_shared_rank(dpart, 0) + o);
        for (int q = 1; q < C; ++q) {
          const float4 x = ld4(cluster.map_shared_rank(dpart, q) + o);
          v.x += x.x;
          v.y += x.y;
          v.z += x.z;
          v.w += x.w;
        }
        float4* a = reinterpret_cast<float4*>(act[l - 1] + o);
        const float4 av = *a;
        *a = make_float4(av.x > 0.f ? v.x : 0.f, av.y > 0.f ? v.y : 0.f,
                         av.z > 0.f ? v.z : 0.f, av.w > 0.f ? v.w : 0.f);
      }
      __syncthreads();
    }
    const int p0 = lay.P[0];
    if (rank == 0) {
      for (int i = tid; i < p0; i += kThreads) {
        float sw = 0.f, sb = 0.f;
        for (int m = 0; m < bm; ++m) {
          const float d = act[0][m * p0 + i];
          sw = fmaf(d, su[m], sw);
          sb += d;
        }
        part[lay.off_k[0] + i] += sw;
        part[lay.off_b[0] + i] += sb;
      }
    }
    row_dot(act[0], p0, p0, w1, gpart, bm);
    __syncthreads();
    for (int m = tid; m < bm; m += kThreads) sg[m] = sg[m] + gpart[m];
    __syncthreads();
  }
  cluster.sync();  // no CTA leaves while another may read its shared memory
}

// grads[p] = Σ_t part[t·row + p] in tile order; one warp sums the loss terms.
__global__ void dense_reduce_kernel(int n_tiles, int total, int row,
                                    const float* __restrict__ part, float* __restrict__ grads,
                                    int B, const float* __restrict__ loss_m,
                                    float* __restrict__ loss) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p < total) {
    float s = 0.f;
    for (int t = 0; t < n_tiles; ++t) s += part[static_cast<size_t>(t) * row + p];
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

// The layout of theta and of a CTA's shared memory; 0, or the entry's error
// code. Shared-memory regions start on 16 bytes. bf16: widths and slices
// multiples of 16, each W_l slice as bf16 Wᵀ (jw_l rows of P_{l−1} + 8 halves).
int make_layout(int L, const int* widths, int bm, int C, int bf16, DenseLayout* lay) {
  if (L < 1 || L > kMaxLayers) return -2;
  if (bm != 16 && bm != 32 && bm != 64) return -4;
  if ((C != 1 && C != 2 && C != 4 && C != 8) || (L == 1 && C != 1)) return -6;
  *lay = DenseLayout{};
  lay->L = L;
  lay->bm = bm;
  lay->C = C;
  lay->bf16 = bf16;
  const int align = bf16 ? 16 : 4;
  for (int l = 0; l < L; ++l) {
    if (widths[l] < align || widths[l] % align) return -3;
    lay->P[l] = widths[l];
  }
  const int* P = lay->P;
  int off = 2 * P[0];
  lay->off_k[0] = 0;
  lay->off_b[0] = P[0];
  for (int l = 1; l < L; ++l) {
    lay->off_k[l] = off;
    off += P[l - 1] * P[l];
    lay->off_b[l] = off;
    off += P[l];
  }
  lay->off_k[L] = off;
  off += P[L - 1];
  lay->off_b[L] = off;
  lay->total = off + 1;
  lay->row = pad4(lay->total);
  int f = 0;
  auto take = [&f](int n) {
    const int o = f;
    f += pad4(n);
    return o;
  };
  lay->s_w1 = take(P[0]);
  lay->s_b1 = take(P[0]);
  lay->jw[0] = P[0];
  for (int l = 1; l < L; ++l) {
    if (bf16) {
      lay->jw[l] = pad16((P[l] + C - 1) / C);
      lay->sw[l] = P[l - 1] + 8;
      lay->s_w[l] = take(lay->jw[l] * lay->sw[l] / 2);
    } else {
      lay->jw[l] = pad4((P[l] + C - 1) / C);
      lay->sw[l] = lay->jw[l] % 8 == 0 ? lay->jw[l] + 4 : lay->jw[l];
      lay->s_w[l] = take(P[l - 1] * lay->sw[l]);
    }
    lay->s_b[l] = take(lay->jw[l]);
  }
  lay->s_wo = take(lay->jw[L - 1]);
  int low = 0;
  for (int l = 0; l < L; ++l) {
    lay->ld[l] = l < L - 1 ? P[l] : lay->jw[l];
    lay->s_act[l] = take(bm * lay->ld[l]);
    if (l < L - 1 && P[l] > low) low = P[l];
  }
  lay->s_dpart = take(bm * low);
  lay->s_vec = take(6 * bm);
  lay->smem_floats = f;
  return f * static_cast<int>(sizeof(float)) > kMaxSmem ? -5 : 0;
}

}  // namespace

extern "C" {

// Return 0 on success, -2 for a layer count outside 1..8 or an empty shape,
// -3 for a width that is not a positive multiple of 4 (16 with bf16 = 1, the
// tensor-core mode of the hidden products), -4 for a member tile
// other than 16, 32, 64, -5 when a CTA's share exceeds its shared memory,
// -6 for a cluster size other than 1, 2, 4, 8 (1 for a single hidden layer),
// or the cudaError_t of a refused launch. part (⌈B/bm⌉ × pad4(total)) must
// be zero; traj (cluster, S+1, B) and loss_m (B) are scratch.
int dense_epoch_grad(int L, const int* widths, int bm, int cluster, int bf16, int S, int B,
                     const float* theta, const float* dt, const float* u0, const float* tgt,
                     double inv_b, float* traj, float* loss_m, float* part, float* loss,
                     float* grads, void* stream) {
  if (S < 1 || B < 1) return -2;
  DenseLayout lay;
  const int code = make_layout(L, widths, bm, cluster, bf16 ? 1 : 0, &lay);
  if (code != 0) return code;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bytes = lay.smem_floats * static_cast<int>(sizeof(float));
  auto kernel = bf16 ? dense_cluster_kernel<true> : dense_cluster_kernel<false>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int n_tiles = (B + bm - 1) / bm;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_tiles * cluster, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, lay, S, B, theta, dt, u0, tgt,
                         static_cast<float>(inv_b), traj, loss_m, part);
  if (e != cudaSuccess) return static_cast<int>(e);
  dense_reduce_kernel<<<(lay.total + 255) / 256, 256, 0, s>>>(n_tiles, lay.total, lay.row, part,
                                                              grads, B, loss_m, loss);
  e = cudaGetLastError();
  return e == cudaSuccess ? 0 : static_cast<int>(e);
}

const char* train_dense_error_string(int code) {
  if (code == -2) return "hidden layer count outside 1..8, or an empty shape";
  if (code == -3) return "a padded hidden width is not a positive multiple of 4 (16 in bf16)";
  if (code == -4) return "member tile must be 16, 32 or 64";
  if (code == -5) return "a CTA's weights and activations exceed its shared memory";
  if (code == -6) return "cluster size must be 1, 2, 4 or 8 (1 for a single hidden layer)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
