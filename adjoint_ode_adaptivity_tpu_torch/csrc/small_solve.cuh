// Per-thread solves of tiny dense systems held in registers, for the
// DG-in-time slab kernels: solve (dg_slab.cu, D1) is unrolled Cramer
// (cofactor expansion) for N ≤ 4 and unrolled Gaussian elimination with
// partial pivoting by selects (no branches, the warp stays converged) for
// N = 5..8 — march/dg_batched.py solve_small's arithmetic; solve_nopivot
// (dg_slab_mixed.cu, H1) is march/dg_mixed.py gauss_solve's.
#pragma once

#include <cuda_runtime.h>

#include <cmath>

namespace aoa {

// Determinant by first-row cofactor expansion (march/dg_batched.py _det).
template <int N>
__device__ __forceinline__ float det(const float (&m)[N][N]) {
  if constexpr (N == 1) {
    return m[0][0];
  } else if constexpr (N == 2) {
    return m[0][0] * m[1][1] - m[0][1] * m[1][0];
  } else {
    float d = 0.f;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      float minor[N - 1][N - 1];
#pragma unroll
      for (int r = 1; r < N; ++r) {
#pragma unroll
        for (int c = 0; c < N - 1; ++c) minor[r - 1][c] = m[r][c < j ? c : c + 1];
      }
      const float term = m[0][j] * det<N - 1>(minor);
      d = (j == 0) ? term : ((j & 1) ? d - term : d + term);
    }
    return d;
  }
}

// x = A⁻¹ b: Cramer for N ≤ 4; for N > 4 Gaussian elimination with partial
// pivoting by selects (march/dg_batched.py ge_solve_rows), A and b overwritten.
template <int N>
__device__ __forceinline__ void solve(float (&a)[N][N], float (&b)[N], float (&x)[N]) {
  if constexpr (N <= 4) {
    const float d = det<N>(a);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      float m[N][N];
#pragma unroll
      for (int r = 0; r < N; ++r) {
#pragma unroll
        for (int c = 0; c < N; ++c) m[r][c] = (c == i) ? b[r] : a[r][c];
      }
      x[i] = det<N>(m) / d;
    }
  } else {
#pragma unroll
    for (int k = 0; k < N; ++k) {
#pragma unroll
      for (int i = k + 1; i < N; ++i) {
        const bool take = fabsf(a[i][k]) > fabsf(a[k][k]);
#pragma unroll
        for (int c = k; c < N; ++c) {
          const float ak = a[k][c];
          const float ai = a[i][c];
          a[k][c] = take ? ai : ak;
          a[i][c] = take ? ak : ai;
        }
        const float bk = b[k];
        const float bi = b[i];
        b[k] = take ? bi : bk;
        b[i] = take ? bk : bi;
      }
#pragma unroll
      for (int i = k + 1; i < N; ++i) {
        const float m = a[i][k] / a[k][k];
#pragma unroll
        for (int c = k + 1; c < N; ++c) a[i][c] = a[i][c] - m * a[k][c];
        b[i] = b[i] - m * b[k];
      }
    }
#pragma unroll
    for (int i = N - 1; i >= 0; --i) {
      float acc = b[i];
#pragma unroll
      for (int j = i + 1; j < N; ++j) acc = acc - a[i][j] * x[j];
      x[i] = acc / a[i][i];
    }
  }
}

// x = A⁻¹ b by Gaussian elimination without pivoting, each pivot's
// reciprocal taken once (march/dg_mixed.py gauss_solve's arithmetic: the
// padding identity keeps padded pivots 1 and the live slab pivots stay away
// from zero); A and b overwritten.
template <int N>
__device__ __forceinline__ void solve_nopivot(float (&a)[N][N], float (&b)[N], float (&x)[N]) {
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const float inv = 1.f / a[k][k];
#pragma unroll
    for (int i = k + 1; i < N; ++i) {
      const float m = a[i][k] * inv;
#pragma unroll
      for (int c = k + 1; c < N; ++c) a[i][c] = a[i][c] - m * a[k][c];
      b[i] = b[i] - m * b[k];
    }
  }
#pragma unroll
  for (int i = N - 1; i >= 0; --i) {
    float acc = b[i];
#pragma unroll
    for (int j = i + 1; j < N; ++j) acc = acc - a[i][j] * x[j];
    x[i] = acc / a[i][i];
  }
}

}  // namespace aoa
