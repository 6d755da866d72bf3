// The ODE right-hand sides of the registry (odes.py KERNEL_IDS) as device
// functors, shared by the FD kernels (fd_ensemble.cu) and the DG-in-time
// slab kernels (dg_slab.cu, dg_slab_mixed.cu), and the goal functionals'
// adjoint sources g_u (functionals.py kernel_id) of the DG-in-time kernels;
// beside them the wrappers of a caller's traced callables (OdeTraced,
// OdeTracedVec, GoalTraced, at the end). Each functor gives f(u, t) and the pair
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

// ---- traced user functors (ops/cuda/functor.py)
// The tracer emits each elementwise callable as a struct whose member
// template eval(u, t) runs on the scalar type T: float for f and g_u, or
// Dual<float> to derive f_u by forward mode (JAX's jvp with a ones tangent
// on u, none on t) when the caller gave none. uf:: holds the op set on both
// types; the derivatives follow JAX's rules, its kinks included: d|x|/dx = +1
// at 0, maximum/minimum give half of each tangent at a tie, relu'(0) = 0,
// and `where` (a ?: in the emitted code) takes the chosen branch's tangent.
template <class T>
struct Dual {
  T v;  // value
  T d;  // tangent
  __host__ __device__ Dual(T value = T(0), T tangent = T(0)) : v(value), d(tangent) {}
};

template <class T>
__host__ __device__ inline Dual<T> operator+(const Dual<T>& a, const Dual<T>& b) {
  return {a.v + b.v, a.d + b.d};
}
template <class T>
__host__ __device__ inline Dual<T> operator-(const Dual<T>& a, const Dual<T>& b) {
  return {a.v - b.v, a.d - b.d};
}
template <class T>
__host__ __device__ inline Dual<T> operator-(const Dual<T>& a) {
  return {-a.v, -a.d};
}
template <class T>
__host__ __device__ inline Dual<T> operator*(const Dual<T>& a, const Dual<T>& b) {
  return {a.v * b.v, a.d * b.v + a.v * b.d};
}
template <class T>
__host__ __device__ inline Dual<T> operator/(const Dual<T>& a, const Dual<T>& b) {
  return {a.v / b.v, a.d / b.v + (-b.d * a.v) * (T(1) / (b.v * b.v))};
}

namespace uf {

__host__ __device__ inline float val(float x) { return x; }
template <class T>
__host__ __device__ inline T val(const Dual<T>& x) { return x.v; }

__host__ __device__ inline float sin(float x) { return sinf(x); }
__host__ __device__ inline float cos(float x) { return cosf(x); }
__host__ __device__ inline float tan(float x) { return tanf(x); }
__host__ __device__ inline float exp(float x) { return expf(x); }
__host__ __device__ inline float log(float x) { return logf(x); }
__host__ __device__ inline float sqrt(float x) { return sqrtf(x); }
__host__ __device__ inline float rsqrt(float x) {
#ifdef __CUDA_ARCH__
  return rsqrtf(x);
#else
  return 1.f / sqrtf(x);
#endif
}
__host__ __device__ inline float tanh(float x) { return tanhf(x); }
__host__ __device__ inline float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }
__host__ __device__ inline float abs(float x) { return fabsf(x); }
__host__ __device__ inline float relu(float x) { return x > 0.f ? x : 0.f; }
__host__ __device__ inline float min(float a, float b) { return b < a ? b : a; }
__host__ __device__ inline float max(float a, float b) { return b > a ? b : a; }
// x^n and x^c with the special cases torch's pow takes
__host__ __device__ inline float ipow(float x, int n) {
  switch (n) {
    case 0: return 1.f;
    case 1: return x;
    case 2: return x * x;
    case 3: return x * x * x;
    case -1: return 1.f / x;
    case -2: return 1.f / (x * x);
    default: return powf(x, static_cast<float>(n));
  }
}
__host__ __device__ inline float pow(float x, float c) {
  if (c == 0.5f) return sqrtf(x);
  if (c == -0.5f) return rsqrt(x);
  return powf(x, c);
}

template <class T>
__host__ __device__ inline Dual<T> sin(const Dual<T>& x) {
  return {sin(x.v), x.d * cos(x.v)};
}
template <class T>
__host__ __device__ inline Dual<T> cos(const Dual<T>& x) {
  return {cos(x.v), -(x.d * sin(x.v))};
}
template <class T>
__host__ __device__ inline Dual<T> tan(const Dual<T>& x) {
  const T y = tan(x.v);
  return {y, x.d * (T(1) + y * y)};
}
template <class T>
__host__ __device__ inline Dual<T> exp(const Dual<T>& x) {
  const T y = exp(x.v);
  return {y, x.d * y};
}
template <class T>
__host__ __device__ inline Dual<T> log(const Dual<T>& x) {
  return {log(x.v), x.d / x.v};
}
template <class T>
__host__ __device__ inline Dual<T> sqrt(const Dual<T>& x) {
  const T y = sqrt(x.v);
  return {y, x.d * (T(0.5) / y)};
}
template <class T>
__host__ __device__ inline Dual<T> rsqrt(const Dual<T>& x) {
  const T y = rsqrt(x.v);
  return {y, x.d * (T(-0.5) * (y / x.v))};
}
template <class T>
__host__ __device__ inline Dual<T> tanh(const Dual<T>& x) {
  const T y = tanh(x.v);
  return {y, (x.d + x.d * y) * (T(1) - y)};
}
template <class T>
__host__ __device__ inline Dual<T> sigmoid(const Dual<T>& x) {
  const T y = sigmoid(x.v);
  return {y, x.d * (y * (T(1) - y))};
}
template <class T>
__host__ __device__ inline Dual<T> abs(const Dual<T>& x) {
  return {abs(x.v), x.v >= T(0) ? x.d : -x.d};
}
template <class T>
__host__ __device__ inline Dual<T> relu(const Dual<T>& x) {
  return {relu(x.v), x.v > T(0) ? x.d : T(0)};
}
// JAX's _balanced_eq: each tangent weighted 1 where its operand is the
// result, 1/2 where both are (a tie), else 0
template <class T>
__host__ __device__ inline Dual<T> chosen(T m, const Dual<T>& a, const Dual<T>& b) {
  const T wa = (a.v == m ? T(1) : T(0)) / (b.v == m ? T(2) : T(1));
  const T wb = (b.v == m ? T(1) : T(0)) / (a.v == m ? T(2) : T(1));
  return {m, a.d * wa + b.d * wb};
}
template <class T>
__host__ __device__ inline Dual<T> min(const Dual<T>& a, const Dual<T>& b) {
  return chosen(min(a.v, b.v), a, b);
}
template <class T>
__host__ __device__ inline Dual<T> max(const Dual<T>& a, const Dual<T>& b) {
  return chosen(max(a.v, b.v), a, b);
}
template <class T>
__host__ __device__ inline Dual<T> ipow(const Dual<T>& x, int n) {
  return {ipow(x.v, n), n == 0 ? T(0) : x.d * (T(n) * ipow(x.v, n - 1))};
}
template <class T>
__host__ __device__ inline Dual<T> pow(const Dual<T>& x, T c) {
  return {pow(x.v, c), c == T(0) ? T(0) : x.d * (c * pow(x.v, c - T(1)))};
}

}  // namespace uf

// A traced scalar ODE: f from F; f_u from FU, or (FU = void) derived by
// evaluating F on Dual<float>.
template <class F, class FU = void>
struct OdeTraced {
  __host__ __device__ static float f(float u, float t, const OdeConsts&) {
    return F::eval(u, t);
  }
  __host__ __device__ static void pair(float u, float t, const OdeConsts&, float* f, float* fu) {
    *f = F::eval(u, t);
    *fu = FU::eval(u, t);
  }
};

template <class F>
struct OdeTraced<F, void> {
  __host__ __device__ static float f(float u, float t, const OdeConsts&) {
    return F::eval(u, t);
  }
  __host__ __device__ static void pair(float u, float t, const OdeConsts&, float* f, float* fu) {
    const Dual<float> r = F::eval(Dual<float>(u, 1.f), Dual<float>(t, 0.f));
    *f = r.v;
    *fu = r.d;
  }
};

// A traced vector ODE of D components: f_comps from F, the Jacobian from J,
// whose literal zeros are J::nonzero(m, i) == false (skipped by F2).
template <int kD, class F, class J>
struct OdeTracedVec {
  static constexpr int D = kD;
  __host__ __device__ static constexpr bool nonzero(int m, int i) { return J::nonzero(m, i); }
  __host__ __device__ static void f(const float* u, float t, const OdeConsts&, float* out) {
    F::eval(u, t, out);
  }
  __host__ __device__ static void pair(const float* u, float t, const OdeConsts&, float* out,
                                       float* jac) {
    F::eval(u, t, out);
    J::eval(u, t, jac);
  }
};

// A traced goal's adjoint source g_u (never g_u ≡ 1: it reads the goal tables).
template <class G>
struct GoalTraced {
  static constexpr bool kUnit = false;
  __host__ __device__ static float g_u(float u, float t) { return G::eval(u, t); }
};

// The id of the user case: a user library (ops/cuda/__init__.py
// load_user_library, built with -DAOA_USER_FUNCTORS) includes the generated
// aoa_user_functors.cuh here, which defines AOA_USER_ODE (a scalar ODE),
// AOA_USER_ODE_VEC (a vector one) and AOA_USER_GOAL as it has them; its
// switches take kUserKernelId and instantiate the user functor alone. The
// registry library's switches take the registry ids.
constexpr int kUserKernelId = 1000;

#ifdef AOA_USER_FUNCTORS
#include "aoa_user_functors.cuh"

#ifdef AOA_USER_ODE
#define AOA_USER_SCALAR_CASE(LAUNCH) \
  case kUserKernelId:                \
    return LAUNCH(AOA_USER_ODE);
#else
#define AOA_USER_SCALAR_CASE(LAUNCH)
#endif
#ifdef AOA_USER_ODE_VEC
#define AOA_USER_VECTOR_CASE(LAUNCH) \
  case kUserKernelId:                \
    return LAUNCH(AOA_USER_ODE_VEC);
#else
#define AOA_USER_VECTOR_CASE(LAUNCH)
#endif
#ifdef AOA_USER_GOAL
#define AOA_USER_GOAL_CASE(LAUNCH) \
  case kUserKernelId:              \
    return LAUNCH(AOA_USER_GOAL);
#else
#define AOA_USER_GOAL_CASE(LAUNCH)
#endif

#define AOA_ODE_SCALAR_SWITCH(id, fast, LAUNCH) \
  switch (id) {                                 \
    AOA_USER_SCALAR_CASE(LAUNCH)                \
    default:                                    \
      (void)(fast);                             \
      return -2;                                \
  }
#define AOA_ODE_VECTOR_SWITCH(id, LAUNCH) \
  switch (id) {                           \
    AOA_USER_VECTOR_CASE(LAUNCH)          \
    default:                              \
      return -2;                          \
  }
#define AOA_ODE_LIBM_SWITCH(id, LAUNCH) AOA_ODE_SCALAR_SWITCH(id, 0, LAUNCH)
#define AOA_GOAL_SWITCH(id, LAUNCH) \
  switch (id) {                     \
    AOA_USER_GOAL_CASE(LAUNCH)      \
    default:                        \
      return -9;                    \
  }

#else  // the registry library

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

// kernel_id of the registry functional (functionals.py): 0 J=int(u),
// 1 J=int(u^2); -9 for any other.
#define AOA_GOAL_SWITCH(id, LAUNCH)   \
  switch (id) {                       \
    case 0: return LAUNCH(GoalIntU);  \
    case 1: return LAUNCH(GoalIntU2); \
    default: return -9;               \
  }

// the scalar ODEs with libm trigonometry alone (the hp kernel's)
#define AOA_ODE_LIBM_SWITCH(id, LAUNCH)       \
  switch (id) {                               \
    case 0: return LAUNCH(OdeLinear);         \
    case 1: return LAUNCH(OdeSin<Libm>);      \
    case 2: return LAUNCH(OdeCos2Pi);         \
    case 3: return LAUNCH(Ode10Cos);          \
    case 4: return LAUNCH(OdeTSin);           \
    case 5: return LAUNCH(OdeGaussMix);       \
    default: return -2;                       \
  }

// kernel_id 6 of the registry: the vector functor
#define AOA_ODE_VECTOR_SWITCH(id, LAUNCH)   \
  switch (id) {                             \
    case 6: return LAUNCH(OdeHarmonic);     \
    default: return -2;                     \
  }

#endif  // AOA_USER_FUNCTORS

// 0 for a goal of g_u ≡ 1 (the folded row sums, no goal tables), 1 for one
// that reads the goal tables (the mass matrix and the node positions), -9
// for an id this library does not take.
#define AOA_GOAL_TABLES(GOAL) ((GOAL::kUnit) ? 0 : 1)
inline int goal_tables(int id) { AOA_GOAL_SWITCH(id, AOA_GOAL_TABLES) }
#undef AOA_GOAL_TABLES

}  // namespace aoa

