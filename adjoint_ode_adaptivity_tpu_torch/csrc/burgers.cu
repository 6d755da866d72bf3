// Hand-written Hopper (sm_90a) kernel of the limited Burgers march, bound to
// Python with ctypes (plain C interface).
//
// B1  burgers_march_f32 / burgers_march_f64  replaces
//     adjoint_ode_adaptivity_tpu/ops/pallas/burgers.py:57 (_kernel, reached
//     through make_pallas_burgers_march and
//     make_pallas_burgers_march_single_blocked). One kernel on (Np, B, K)
//     serves both entry points; the TPU's blocked-sublane layout has no
//     counterpart here.
//
// What it computes: n_steps LSRK4(5) steps of u_t + (u²/2)_x = 0 with the
// local Lax–Friedrichs flux (periodic), and the ΠN (limiter 0), Π¹ (1) or no
// (2) minmod limiter applied after every stage, with copied-endpoint
// neighbour cell averages at the global ends (utils/SlopeLimitN.m). Templated
// on float and double: the Pallas kernel is dtype-generic, and the double
// instance lets the card hold B1 to its plain version at roundoff.
//
// Folded tables (per step size, folded on the host in double, rounded to T):
// drc = −dt·Dr, ll = dt·LIFT[:,0], lr = dt·LIFT[:,1], cavg = V[0,0]·invV[0,:]
// (cell average), drux = (Dr·Π¹)[0,:] (slope of the linear part). Geometry is
// always per element: rx, fscale at the two faces, 1/h, and the node offsets
// ξ_i = x_i − x_centre; a uniform mesh is the special case.
//
// Layout and sync: one block per batch member, threads striding over the
// member's K elements; a thread holds one element's Np nodes in registers
// while it works on it. Every stage needs the neighbours' face traces at the
// stage's input, and the limiter needs the neighbours' cell averages after
// the update, so each stage is two phases separated by __syncthreads():
//   A  rhs + low-storage update: read cur (and the neighbours' traces), write
//      the updated nodes to nxt, the residual to rbuf and the cell average
//      to avg;
//   B  limit: read nxt and avg (k−1, k, k+1), write the limited nodes to cur.
// With no limiter, A's output becomes the next input (pointer swap). The
// member's state (3·Np·K values) stays in L2 between phases; the whole march
// is ONE launch, so nothing crosses the host between steps.
//
// What bounds it on the H100: the card's operations bound is 2·Np² + 18·Np
// + 77 operations per element and stage with ΠN (volume product, lift,
// updates, LLF, limiter; chip_smoke.py's burgers_stage_ops), and a march
// reads u0 and writes u once. The kernel is far from it: one block per
// member serialises 2·5·n_steps block-wide barriers and L2 round trips,
// each thread walks K/512 elements with dependent loads, and at B = 8 only
// 8 of 132 SMs work. PERF.md holds the measured time. Splitting a member
// over several blocks (ghost halos of W ≥ 10·seg + 10 elements,
// dg_sharded.py:18-25) is later work.

#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kMaxNp = 8;
constexpr int kMaxThreads = 512;

template <typename T>
struct Tables {
  T drc[kMaxNp * kMaxNp];  // (Np, Np) row-major, row stride Np
  T ll[kMaxNp];
  T lr[kMaxNp];
  T cavg[kMaxNp];
  T drux[kMaxNp];
  T rka[5];
  T rkb[5];
};

template <typename T>
struct Geom {
  const T* rx;   // (K,)
  const T* fsl;  // (K,)
  const T* fsr;  // (K,)
  const T* ih;   // (K,) 1/h
  const T* xi;   // (Np, K) node offsets from the element centre
};

__device__ __forceinline__ float aabs(float x) { return fabsf(x); }
__device__ __forceinline__ double aabs(double x) { return fabs(x); }
__device__ __forceinline__ float amin(float a, float b) { return fminf(a, b); }
__device__ __forceinline__ double amin(double a, double b) { return fmin(a, b); }
__device__ __forceinline__ float amax(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double amax(double a, double b) { return fmax(a, b); }

template <typename T>
__device__ __forceinline__ int sgn(T x) {
  return (x > T(0)) - (x < T(0));
}

// sign-unanimous minimum magnitude, else 0 (utils/minmod.m with m = 3)
template <typename T>
__device__ __forceinline__ T minmod3(T a, T b, T c) {
  const int s = sgn(a);
  if (s == 0 || sgn(b) != s || sgn(c) != s) return T(0);
  return T(s) * amin(aabs(a), amin(aabs(b), aabs(c)));
}

template <typename T, int NP>
__global__ void __launch_bounds__(kMaxThreads)
burgers_march_kernel(const T* __restrict__ u0, T* __restrict__ ua,
                     T* __restrict__ ub, T* __restrict__ rbuf,
                     T* __restrict__ avg, Geom<T> g, Tables<T> tab,
                     int limiter, int nk, int n_steps) {
  const long bk = static_cast<long>(gridDim.x) * nk;  // node stride
  const long base = static_cast<long>(blockIdx.x) * nk;
  T* avg_b = avg + base;

  for (int k = threadIdx.x; k < nk; k += blockDim.x) {
#pragma unroll
    for (int i = 0; i < NP; ++i) ua[i * bk + base + k] = u0[i * bk + base + k];
  }
  __syncthreads();

  T* cur = ua;
  T* nxt = ub;
  for (int n = 0; n < n_steps; ++n) {
    for (int s = 0; s < 5; ++s) {
      const T a_s = tab.rka[s];
      const T b_s = tab.rkb[s];
      // phase A: dt·rhs, r = a_s·r + dt·rhs, u ← u + b_s·r
      for (int k = threadIdx.x; k < nk; k += blockDim.x) {
        const long c = base + k;
        T u[NP];
#pragma unroll
        for (int i = 0; i < NP; ++i) u[i] = cur[i * bk + c];
        const int km1 = k == 0 ? nk - 1 : k - 1;  // periodic flux
        const int kp1 = k == nk - 1 ? 0 : k + 1;
        const T ul = u[0];
        const T ur = u[NP - 1];
        const T ul_ext = cur[(NP - 1) * bk + base + km1];
        const T ur_ext = cur[base + kp1];
        const T cl = amax(aabs(ul), aabs(ul_ext));
        const T cr = amax(aabs(ur), aabs(ur_ext));
        const T half = T(0.5);
        const T fstar_l = half * (half * ul * ul + half * ul_ext * ul_ext) +
                          half * cl * (ul_ext - ul);
        const T fstar_r = half * (half * ur * ur + half * ur_ext * ur_ext) -
                          half * cr * (ur_ext - ur);
        const T dfl = (-(half * ul * ul) + fstar_l) * g.fsl[k];
        const T dfr = (half * ur * ur - fstar_r) * g.fsr[k];
        const T rx = g.rx[k];
        T f[NP];
#pragma unroll
        for (int j = 0; j < NP; ++j) f[j] = half * u[j] * u[j];
        T vk = T(0);
#pragma unroll
        for (int i = 0; i < NP; ++i) {
          T vol = T(0);
#pragma unroll
          for (int j = 0; j < NP; ++j) vol += tab.drc[i * NP + j] * f[j];
          const T rhs = rx * vol + tab.ll[i] * dfl + tab.lr[i] * dfr;
          const T r = s == 0 ? rhs : a_s * rbuf[i * bk + c] + rhs;
          if (s < 4) rbuf[i * bk + c] = r;  // stage 4's r never crosses the step
          const T un = u[i] + b_s * r;
          nxt[i * bk + c] = un;
          vk += tab.cavg[i] * un;
        }
        avg_b[k] = vk;
      }
      __syncthreads();
      if (limiter == 2) {
        T* tmp = cur;
        cur = nxt;
        nxt = tmp;
        continue;
      }
      // phase B: the minmod limiter on the updated state
      for (int k = threadIdx.x; k < nk; k += blockDim.x) {
        const long c = base + k;
        T u[NP];
#pragma unroll
        for (int i = 0; i < NP; ++i) u[i] = nxt[i * bk + c];
        const T vk = avg_b[k];
        const T vkm1 = k == 0 ? vk : avg_b[k - 1];  // copied endpoints
        const T vkp1 = k == nk - 1 ? vk : avg_b[k + 1];
        const T dm = vk - vkm1;
        const T dp = vkp1 - vk;
        const T ih = g.ih[k];
        T ux = T(0);
#pragma unroll
        for (int j = 0; j < NP; ++j) ux += tab.drux[j] * u[j];
        ux = T(2) * ux * ih;
        const T slope = minmod3(ux, dp * ih, dm * ih);
        bool troubled = true;
        if (limiter == 0) {
          const T ve1 = vk - minmod3(vk - u[0], dm, dp);
          const T ve2 = vk + minmod3(u[NP - 1] - vk, dm, dp);
          troubled = aabs(ve1 - u[0]) > T(1e-8) || aabs(ve2 - u[NP - 1]) > T(1e-8);
        }
#pragma unroll
        for (int i = 0; i < NP; ++i) {
          cur[i * bk + c] = troubled ? vk + g.xi[i * nk + k] * slope : u[i];
        }
      }
      __syncthreads();
    }
  }
  if (cur != ua) {  // no limiter and an odd number of stages: result in ub
    for (int k = threadIdx.x; k < nk; k += blockDim.x) {
#pragma unroll
      for (int i = 0; i < NP; ++i) ua[i * bk + base + k] = cur[i * bk + base + k];
    }
  }
}

// host: tables = [drc (Np·Np), ll, lr, cavg, drux (Np each), rka (5), rkb (5)]
template <typename T>
Tables<T> pack_tables(int np, const T* host) {
  Tables<T> t{};
  const T* p = host;
  for (int i = 0; i < np * np; ++i) t.drc[i] = *p++;
  for (int i = 0; i < np; ++i) t.ll[i] = *p++;
  for (int i = 0; i < np; ++i) t.lr[i] = *p++;
  for (int i = 0; i < np; ++i) t.cavg[i] = *p++;
  for (int i = 0; i < np; ++i) t.drux[i] = *p++;
  for (int i = 0; i < 5; ++i) t.rka[i] = *p++;
  for (int i = 0; i < 5; ++i) t.rkb[i] = *p++;
  return t;
}

template <typename T, int NP>
int launch(int nb, int nk, int n_steps, int limiter, const T* tables,
           const T* geom, const T* u0, T* u_out, T* ubuf, T* rbuf, T* avg,
           cudaStream_t stream) {
  const Tables<T> tab = pack_tables<T>(NP, tables);
  const Geom<T> g{geom, geom + nk, geom + 2 * nk, geom + 3 * nk, geom + 4 * nk};
  int threads = ((nk + 31) / 32) * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  burgers_march_kernel<T, NP><<<nb, threads, 0, stream>>>(
      u0, u_out, ubuf, rbuf, avg, g, tab, limiter, nk, n_steps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int np, int nb, int nk, int n_steps, int limiter, const T* tables,
             const T* geom, const T* u0, T* u_out, T* ubuf, T* rbuf, T* avg,
             void* stream) {
  if (limiter < 0 || limiter > 2) return -2;
  if (nb < 1 || nk < 2 || n_steps < 0) return -3;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (np) {
#define AOA_CASE(N) \
  case N: return launch<T, N>(nb, nk, n_steps, limiter, tables, geom, u0, u_out, ubuf, rbuf, avg, st);
    AOA_CASE(2) AOA_CASE(3) AOA_CASE(4) AOA_CASE(5) AOA_CASE(6) AOA_CASE(7) AOA_CASE(8)
#undef AOA_CASE
    default: return -1;
  }
}

}  // namespace

extern "C" {

// u0, u_out, ubuf, rbuf: (Np, B, K) device arrays; avg: (B, K); geom: (4 + Np,
// K) device rows [rx, fsl, fsr, 1/h, ξ_0 .. ξ_{Np−1}]; tables: host array (see
// pack_tables). limiter: 0 = ΠN, 1 = Π¹, 2 = none. Returns 0, a cudaError_t
// code after a refused launch, or a negative code for a bad argument.
int burgers_march_f32(int np, int nb, int nk, int n_steps, int limiter,
                      const float* tables, const float* geom, const float* u0,
                      float* u_out, float* ubuf, float* rbuf, float* avg,
                      void* stream) {
  return dispatch<float>(np, nb, nk, n_steps, limiter, tables, geom, u0, u_out,
                         ubuf, rbuf, avg, stream);
}

int burgers_march_f64(int np, int nb, int nk, int n_steps, int limiter,
                      const double* tables, const double* geom,
                      const double* u0, double* u_out, double* ubuf,
                      double* rbuf, double* avg, void* stream) {
  return dispatch<double>(np, nb, nk, n_steps, limiter, tables, geom, u0,
                          u_out, ubuf, rbuf, avg, stream);
}

const char* burgers_error_string(int code) {
  if (code == -1) return "unsupported Np (the kernel takes 2 <= Np <= 8)";
  if (code == -2) return "unknown limiter (0 = N, 1 = 1, 2 = none)";
  if (code == -3) return "bad shape (B >= 1, K >= 2, n_steps >= 0)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
