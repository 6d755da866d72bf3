// The ODE right-hand sides of the registry (odes.py KERNEL_IDS) as device
// functors, shared by the FD kernels (fd_ensemble.cu) and the DG-in-time
// slab kernels (dg_slab.cu, dg_slab_mixed.cu), and the goal functionals'
// adjoint sources g_u (functionals.py kernel_id) of the DG-in-time kernels. Each functor gives f(u, t) and the pair
// (f, f_u) of one point, evaluated together (sin and cos from one sincosf);
// the trig policy of OdeSin is libm (sincosf) or the shared-x² polynomials
// of ops/fast_trig.py (FastTrig, |x| ≤ 4). The gaussian mixture's constants
// and the fast-trig coefficients travel by value in OdeConsts.
#pragma once

#include <cuda_runtime.h>

#include <cmath>

namespace aoa {

constexpr int kMaxModes = 8;
constexpr float kTwoPi = 6.283185307179586f;

// Host layout of `consts` (64 floats): um[8] us[8] tm[8] ts[8] c[16]
// sin_c[8] cos_c[8]; n_u and n_t arrive as ints.
struct OdeConsts {
  int n_u;
  int n_t;
  float um[kMaxModes];
  float us[kMaxModes];
  float tm[kMaxModes];
  float ts[kMaxModes];
  float c[2 * kMaxModes];
  float sin_c[8];  // sin(x) = x·S(x²), degree 6 in x²
  float cos_c[8];  // cos(x) = C(x²), degree 7 in x²
};

inline OdeConsts pack_consts(int n_u, int n_t, const float* host) {
  OdeConsts k{};
  k.n_u = n_u;
  k.n_t = n_t;
  for (int i = 0; i < kMaxModes; ++i) {
    k.um[i] = host[i];
    k.us[i] = host[8 + i];
    k.tm[i] = host[16 + i];
    k.ts[i] = host[24 + i];
  }
  for (int i = 0; i < 2 * kMaxModes; ++i) k.c[i] = host[32 + i];
  for (int i = 0; i < 8; ++i) {
    k.sin_c[i] = host[48 + i];
    k.cos_c[i] = host[56 + i];
  }
  return k;
}

// ---- trigonometry policies
struct Libm {
  __device__ static void sincos(float x, const OdeConsts&, float* s, float* c) {
    sincosf(x, s, c);
  }
};

// Shared-x² Horner chains (ops/fast_trig.py), valid for |x| ≤ 4.
struct FastTrig {
  __device__ static void sincos(float x, const OdeConsts& k, float* s, float* c) {
    const float z = x * x;
    float as = k.sin_c[6];
#pragma unroll
    for (int i = 5; i >= 0; --i) as = as * z + k.sin_c[i];
    float ac = k.cos_c[7];
#pragma unroll
    for (int i = 6; i >= 0; --i) ac = ac * z + k.cos_c[i];
    *s = x * as;
    *c = ac;
  }
};

// ---- scalar ODE functors: f(u, t) and the pair (f, f_u)
struct OdeLinear {  // du/dt = u
  __device__ static float f(float u, float, const OdeConsts&) { return u; }
  __device__ static void pair(float u, float, const OdeConsts&, float* f, float* fu) {
    *f = u;
    *fu = 1.f;
  }
};

template <class Trig>
struct OdeSin {  // du/dt = sin(u)
  __device__ static float f(float u, float, const OdeConsts& k) {
    float s, c;
    Trig::sincos(u, k, &s, &c);
    return s;
  }
  __device__ static void pair(float u, float, const OdeConsts& k, float* f, float* fu) {
    Trig::sincos(u, k, f, fu);
  }
};

struct OdeCos2Pi {  // du/dt = cos(2πu)
  __device__ static float f(float u, float, const OdeConsts&) { return cosf(kTwoPi * u); }
  __device__ static void pair(float u, float, const OdeConsts&, float* f, float* fu) {
    float s, c;
    sincosf(kTwoPi * u, &s, &c);
    *f = c;
    *fu = -s * kTwoPi;
  }
};

struct Ode10Cos {  // du/dt = 10 cos(u)
  __device__ static float f(float u, float, const OdeConsts&) { return 10.f * cosf(u); }
  __device__ static void pair(float u, float, const OdeConsts&, float* f, float* fu) {
    float s, c;
    sincosf(u, &s, &c);
    *f = 10.f * c;
    *fu = -10.f * s;
  }
};

struct OdeTSin {  // du/dt = t sin(u)
  __device__ static float f(float u, float t, const OdeConsts&) { return t * sinf(u); }
  __device__ static void pair(float u, float t, const OdeConsts&, float* f, float* fu) {
    float s, c;
    sincosf(u, &s, &c);
    *f = t * s;
    *fu = t * c;
  }
};

__device__ __forceinline__ float gaussian(float x, float m, float s) {
  const float d = x - m;
  return expf(-(d * d) / (2.f * (s * s))) / sqrtf(kTwoPi * (s * s));
}

struct OdeGaussMix {  // Σ c_k N(u; m_k, s_k) + Σ c_{n_u+k} N(t; tm_k, ts_k)
  __device__ static float f(float u, float t, const OdeConsts& k) {
    float in_u = 0.f;
    for (int i = 0; i < k.n_u; ++i) in_u += k.c[i] * gaussian(u, k.um[i], k.us[i]);
    float in_t = 0.f;
    for (int i = 0; i < k.n_t; ++i) in_t += k.c[k.n_u + i] * gaussian(t, k.tm[i], k.ts[i]);
    return in_u + in_t;
  }
  __device__ static void pair(float u, float t, const OdeConsts& k, float* f, float* fu) {
    float in_u = 0.f;
    float d_u = 0.f;
    for (int i = 0; i < k.n_u; ++i) {
      const float s = k.us[i];
      const float g = k.c[i] * gaussian(u, k.um[i], s);
      in_u += g;
      d_u += g * (-(u - k.um[i]) / (s * s));
    }
    float in_t = 0.f;
    for (int i = 0; i < k.n_t; ++i) in_t += k.c[k.n_u + i] * gaussian(t, k.tm[i], k.ts[i]);
    *f = in_u + in_t;
    *fu = d_u;
  }
};

// ---- vector ODE functors: f(u, t) -> D components, Jacobian jac[m·D + i]
// = ∂f_m/∂u_i; nonzero(m, i) marks the structurally nonzero entries (the
// others are skipped once the loops unroll, as the TPU kernel skips
// literal zeros).
struct OdeHarmonic {  // u'' = −ω²u, ω = 2, as (u, u')
  static constexpr int D = 2;
  __host__ __device__ static constexpr bool nonzero(int m, int i) {
    return (m == 0 && i == 1) || (m == 1 && i == 0);
  }
  __device__ static void f(const float* u, float, const OdeConsts&, float* out) {
    out[0] = u[1];
    out[1] = -4.f * u[0];
  }
  __device__ static void pair(const float* u, float t, const OdeConsts& k, float* out,
                              float* jac) {
    f(u, t, k, out);
    jac[0] = 0.f;
    jac[1] = 1.f;
    jac[2] = -4.f;
    jac[3] = 0.f;
  }
};

// kernel_id of the registry entry (odes.py KERNEL_IDS): 0 du/dt=u,
// 1 sin(u), 2 cos(2πu), 3 10cos(u), 4 t·sin(u), 5 gaussian_mixture,
// 6 harmonic_oscillator (vector).
#define AOA_ODE_SCALAR_SWITCH(id, fast, LAUNCH)                               \
  switch (id) {                                                              \
    case 0: return LAUNCH(OdeLinear);                                        \
    case 1: return (fast) ? LAUNCH(OdeSin<FastTrig>) : LAUNCH(OdeSin<Libm>); \
    case 2: return LAUNCH(OdeCos2Pi);                                        \
    case 3: return LAUNCH(Ode10Cos);                                         \
    case 4: return LAUNCH(OdeTSin);                                          \
    case 5: return LAUNCH(OdeGaussMix);                                      \
    default: return -2;                                                      \
  }

// ---- goal functionals J = ∫ g(u, t) dt: the adjoint's source g_u(u, t)
// at a node. kUnit marks g_u ≡ 1: the kernels then read M·g_u as the folded
// row sums M·1 and need neither the mass matrix nor a functor call.
struct GoalIntU {  // J = ∫u dt
  static constexpr bool kUnit = true;
  __device__ static float g_u(float, float) { return 1.f; }
};

struct GoalIntU2 {  // J = ∫u² dt
  static constexpr bool kUnit = false;
  __device__ static float g_u(float u, float) { return 2.f * u; }
};

// kernel_id of the registry functional (functionals.py): 0 J=int(u),
// 1 J=int(u^2); -9 for any other.
#define AOA_GOAL_SWITCH(id, LAUNCH)   \
  switch (id) {                       \
    case 0: return LAUNCH(GoalIntU);  \
    case 1: return LAUNCH(GoalIntU2); \
    default: return -9;               \
  }

}  // namespace aoa
