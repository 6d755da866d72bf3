// The launch scaffolding of the DG-advection kernels fused over s_f steps a
// launch (csrc/dg_rhs.cu: K1, K2, K2r, KA; csrc/dg_mxu.cu: KM1, KM2): one CTA per
// (tile, member), blockIdx.x the tile of L local elements [lo, hi),
// blockIdx.y the member b; the CTA's window [lo − W, hi + W), clipped to
// [0, K), of member b's row, one thread per window element, the state in
// registers; per stage each thread posts two floats into a double-buffered
// trace array in shared memory, passes one __syncthreads, and reads its
// neighbours'. The window's ends count as the first and last element (the
// domain's ends, or ghost edges that never reach [lo, hi)).
#pragma once

#include <cuda_runtime.h>

namespace aoa_dg {

// Steps per launch: the inflow table rides the launch, 10 values a reverse
// step (two dt/2 steps) and 5 a forward step.
constexpr int kMaxFused = 16;
// A forward launch (K1, KM1; KA's transposed march): 5 values a step in the
// same table.
constexpr int kMaxFwdFused = 32;
static_assert(5 * kMaxFwdFused <= 10 * kMaxFused, "a forward launch outgrows its inflow table");

// The inflow value of every stage of a launch, formed on the host.
struct FusedInflow {
  float v[10 * kMaxFused];
};

// The launch plan the wrapper picks: s_f steps a launch, L local elements a
// tile, W ghosts a side, and the CTA size the kernels are built for.
struct FusedPlan {
  int seg, tile_l, ghost, threads;
};

// The double-buffered face traces: stage j posts into buffer j % 2. A thread
// overwrites a buffer two stages after posting into it, past the barrier of
// the stage between, which every reader of the old values had reached.
template <int T>
struct Traces {
  float lo[2][T];  // forward u[0]; transposed: the left face's contribution
  float hi[2][T];  // forward u[Np−1]; transposed: the right face's
};

// This thread's element in its CTA's window: k = w0 + threadIdx.x of member
// blockIdx.y; ``active`` inside the clipped window, ``local`` in [lo, hi).
struct Elem {
  int k;
  long c;
  bool active, local, first, last;
};

__device__ __forceinline__ Elem elem_of(int nk, int tile_l, int ghost) {
  const int lo = blockIdx.x * tile_l;
  const int hi = min(lo + tile_l, nk);
  const int w0 = max(lo - ghost, 0);
  const int e = min(hi + ghost, nk) - w0;
  Elem el;
  el.k = w0 + static_cast<int>(threadIdx.x);
  el.c = static_cast<long>(blockIdx.y) * nk + el.k;
  el.active = static_cast<int>(threadIdx.x) < e;
  el.local = el.k >= lo && el.k < hi;
  el.first = threadIdx.x == 0;
  el.last = static_cast<int>(threadIdx.x) == e - 1;
  return el;
}

template <int NP>
__device__ __forceinline__ void load_col(const float* __restrict__ x, long c,
                                         long bk, float* v) {
#pragma unroll
  for (int i = 0; i < NP; ++i) v[i] = x[i * bk + c];
}

template <int NP>
__device__ __forceinline__ void store_col(float* x, long c, long bk,
                                          const float* v) {
#pragma unroll
  for (int i = 0; i < NP; ++i) x[i * bk + c] = v[i];
}

// Threads a CTA runs: its widest window, in whole warps.
inline int fused_block(int nk, const FusedPlan& p) {
  const int e = nk < p.tile_l + 2 * p.ghost ? nk : p.tile_l + 2 * p.ghost;
  return (e + 31) / 32 * 32;
}

// Whether a reverse sweep takes the plan: 1 <= s_f <= kMaxFused, the ghost
// rule W >= 10·s_f + 10 (10 stages a step of the carried state, each
// coupling ±1 element, and a margin), a CTA size the kernels are built for
// (512 or 1024) and a window that fits it.
inline bool rev_plan_ok(int nk, const FusedPlan& p) {
  if (p.seg < 1 || p.seg > kMaxFused || p.tile_l < 1 || p.ghost < 10 * p.seg + 10) return false;
  if (p.threads != 512 && p.threads != 1024) return false;
  return fused_block(nk, p) <= p.threads;
}

// Whether a forward march (K1, KM1) or KA takes the plan: 1 <= s_f <=
// kMaxFwdFused, the ghost rule W >= 5·s_f (5 stages a step, each coupling
// ±1 element) unless one tile holds the whole mesh (no ghosts), a CTA size
// the kernels are built for (512 or 1024) and a window that fits it.
inline bool fwd_plan_ok(int nk, const FusedPlan& p) {
  if (p.seg < 1 || p.seg > kMaxFwdFused || p.tile_l < 1 || p.ghost < 0) return false;
  if (p.ghost < 5 * p.seg && p.tile_l < nk) return false;
  if (p.threads != 512 && p.threads != 1024) return false;
  return fused_block(nk, p) <= p.threads;
}

}  // namespace aoa_dg
