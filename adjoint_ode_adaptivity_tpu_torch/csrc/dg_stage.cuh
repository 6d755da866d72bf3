// The per-element arithmetic of one DG-advection LSRK stage, forward and
// transposed, of csrc/dg_rhs.cu's kernels (K1, K2, K2r, KA: s_f steps a
// launch, the state in registers; at B = 1 from a global step offset they
// are the element-tiled KT1 and KT2); the RK coefficients serve
// csrc/dg_mxu.cu too. Every rounding is explicit (fmaf, __fmul_rn,
// __fadd_rn, __fsub_rn), so the compiler contracts nothing differently in
// any kernel instance: an element whose inputs agree gets the same bits
// from every kernel and plan.
//
// Folded tables (per step size, folded on the host in float32, passed by
// value): drc = −a·dt·Dr, ll = −a/2·dt·LIFT[:,0], lr = +a/2·dt·LIFT[:,1].
// The inflow value −sin(a·t_s) of each stage is formed on the host in double
// by dg_inflow(), the one expression every host loop uses.
#pragma once

#include <cuda_runtime.h>

#include <cmath>

namespace aoa_dg {

constexpr int kMaxNp = 16;

struct StepTables {
  float drc[kMaxNp * kMaxNp];  // (Np, Np) row-major, row stride Np
  float ll[kMaxNp];
  float lr[kMaxNp];
};

struct Geom {
  const float* rx;
  const float* fsl;
  const float* fsr;
};

inline StepTables pack_tables(int np, const float* host) {
  StepTables t{};
  for (int i = 0; i < np * np; ++i) t.drc[i] = host[i];
  for (int i = 0; i < np; ++i) t.ll[i] = host[np * np + i];
  for (int i = 0; i < np; ++i) t.lr[i] = host[np * np + np + i];
  return t;
}

// The LSRK4(5) coefficients a_s, b_s in float32, from the host's double
// table rk = RK4A[0..4], RK4B[0..4], RK4C[0..4].
struct RkCoef {
  float a[5];
  float b[5];
};

inline RkCoef rk_coef(const double* rk) {
  RkCoef c{};
  for (int s = 0; s < 5; ++s) {
    c.a[s] = static_cast<float>(rk[s]);
    c.b[s] = static_cast<float>(rk[5 + s]);
  }
  return c;
}

// The inflow value of stage s of a step of size h that starts at t = t0 +
// n·dt (the caller forms t the same way everywhere: double, n an integer).
inline float dg_inflow(double a, double t, double c_s, double h) {
  return static_cast<float>(-std::sin(a * (t + c_s * h)));
}

// One forward stage of one element: rhs = rx·(drc·u) + ll·du_l + lr·du_r,
// r = a_s·r + rhs (r is read only when have_r), u_new = u + b_s·r.
// ``left`` is the left neighbour's u[Np−1] (the inflow value at the inflow
// element), ``right`` the right neighbour's u[0]; ``outflow`` drops the right
// face (du_r = 0).
template <int NP>
__device__ __forceinline__ void stage_fwd(const float* u, float left,
                                          float right, bool outflow, float rx,
                                          float fsl, float fsr,
                                          const StepTables& tab, bool have_r,
                                          float a_s, float b_s, float* r,
                                          float* u_new) {
  const float du_l = __fmul_rn(fsl, __fsub_rn(u[0], left));
  const float du_r = outflow ? 0.f : __fmul_rn(fsr, __fsub_rn(u[NP - 1], right));
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    float vol = 0.f;
#pragma unroll
    for (int j = 0; j < NP; ++j) vol = fmaf(tab.drc[i * NP + j], u[j], vol);
    const float rhs = fmaf(tab.lr[i], du_r, fmaf(tab.ll[i], du_l, __fmul_rn(rx, vol)));
    r[i] = have_r ? fmaf(a_s, r[i], rhs) : rhs;
    u_new[i] = fmaf(b_s, r[i], u[i]);
  }
}

// Σ_i λ_i·(u_next_i − u_new_i), the step-doubling residual weighted by λ.
template <int NP>
__device__ __forceinline__ float residual_dot(const float* lam,
                                              const float* u_next,
                                              const float* u_new) {
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < NP; ++i) acc = fmaf(lam[i], __fsub_rn(u_next[i], u_new[i]), acc);
  return acc;
}

// w = b_s·λu + λr (λr = 0 when !have_lr), the transposed stage's input.
template <int NP>
__device__ __forceinline__ void stage_w(const float* lu, const float* lr,
                                        bool have_lr, float b_s, float* w) {
#pragma unroll
  for (int i = 0; i < NP; ++i) w[i] = fmaf(b_s, lu[i], have_lr ? lr[i] : 0.f);
}

template <int NP>
__device__ __forceinline__ float lifted(const float* coef, const float* w) {
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < NP; ++i) s = fmaf(coef[i], w[i], s);
  return s;
}

// The element's own lifted face cotangents: s0 = fsl·Σ ll·w lands on its
// node 0, s1 = fsr·Σ lr·w (zero at the outflow element) on node Np−1. The
// neighbours take them back with a minus sign: element k receives p0 = s0 of
// element k+1 and p1 = s1 of element k−1.
template <int NP>
__device__ __forceinline__ void faces_t(const float* w, bool outflow, float fsl,
                                        float fsr, const StepTables& tab,
                                        float* s0, float* s1) {
  *s0 = __fmul_rn(fsl, lifted<NP>(tab.ll, w));
  *s1 = outflow ? 0.f : __fmul_rn(fsr, lifted<NP>(tab.lr, w));
}

// One transposed stage of one element: λu_new = λu + rx·(drcᵀ w) + the face
// terms (s0 − p1 on node 0, s1 − p0 on node Np−1); λr_new = a_s·w.
template <int NP>
__device__ __forceinline__ void stage_t(const float* lu, const float* w,
                                        float s0, float s1, float p0, float p1,
                                        float rx, const StepTables& tab,
                                        float a_s, float* lu_new,
                                        float* lr_new) {
#pragma unroll
  for (int j = 0; j < NP; ++j) {
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < NP; ++i) acc = fmaf(tab.drc[i * NP + j], w[i], acc);
    acc = __fmul_rn(acc, rx);
    if (j == 0) acc = __fsub_rn(__fadd_rn(acc, s0), p1);
    if (j == NP - 1) acc = __fsub_rn(__fadd_rn(acc, s1), p0);
    lu_new[j] = __fadd_rn(lu[j], acc);
    lr_new[j] = __fmul_rn(a_s, w[j]);
  }
}

}  // namespace aoa_dg

#define AOA_NP_CASE(N, CALL) \
  case N: { constexpr int NP = N; return CALL; }

// Np 2-8: every kernel of these stages.
#define AOA_NP_SWITCH(np, CALL)                                            \
  switch (np) {                                                            \
    AOA_NP_CASE(2, CALL) AOA_NP_CASE(3, CALL) AOA_NP_CASE(4, CALL)         \
    AOA_NP_CASE(5, CALL) AOA_NP_CASE(6, CALL) AOA_NP_CASE(7, CALL)         \
    AOA_NP_CASE(8, CALL)                                                   \
    default: return -1;                                                    \
  }

// Np 2-16: csrc/dg_rhs.cu's kernels (K1, K2, K2r, KA) also take N = 8-15.
#define AOA_NP16_SWITCH(np, CALL)                                          \
  switch (np) {                                                            \
    AOA_NP_CASE(2, CALL) AOA_NP_CASE(3, CALL) AOA_NP_CASE(4, CALL)         \
    AOA_NP_CASE(5, CALL) AOA_NP_CASE(6, CALL) AOA_NP_CASE(7, CALL)         \
    AOA_NP_CASE(8, CALL) AOA_NP_CASE(9, CALL) AOA_NP_CASE(10, CALL)        \
    AOA_NP_CASE(11, CALL) AOA_NP_CASE(12, CALL) AOA_NP_CASE(13, CALL)      \
    AOA_NP_CASE(14, CALL) AOA_NP_CASE(15, CALL) AOA_NP_CASE(16, CALL)      \
    default: return -1;                                                    \
  }
