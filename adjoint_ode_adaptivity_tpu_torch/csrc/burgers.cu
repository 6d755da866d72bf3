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
// Layout: fused over s_f steps a launch (burgers_fused). One CTA per (tile,
// member): blockIdx.x the tile of L local elements [lo, hi), blockIdx.y the
// member b; the CTA's window is [lo − W, hi + W) taken around the periodic
// ring (a tile at either end reads the other end's elements as its ghosts),
// one thread per window element. A thread keeps its element's Np nodes, its
// low-storage residual and its geometry in registers for the whole launch;
// only face values and cell averages cross elements, through shared memory:
//   A  post the two face values (u[0], u[Np−1]) into a double-buffered
//      trace array; one barrier; read the neighbours', rhs + low-storage
//      update, the cell average of the updated nodes posted to avg;
//   B  (limited runs) one barrier; read the neighbours' averages, limit.
// Two barriers a stage with a limiter, one without. The state crosses
// launches through a global ping-pong buffer, from which the neighbouring
// tiles read their ghosts; where one tile holds the whole mesh (W = 0) the
// window is the ring itself and the whole march is one launch.
//
// Boundaries. The flux is periodic: a window element's flux neighbours are
// the window's neighbouring slots (the ring wraps within the window when one
// tile holds the mesh). The limiter's neighbour averages are copied at the
// GLOBAL ends: the element of global index 0 takes its own average as its
// left neighbour's, and K − 1 its right, whatever slot they sit in, so a
// ghost that wraps around the seam never stands in as a limiter neighbour.
// A window's end slots (W > 0) have no outer neighbour and take their own
// face value and average for it: wrong, but outside the cone below.
//
// Ghost rule (derived; tests/test_torch_burgers_fused.py holds its teeth): a
// stage's update reads the neighbours' traces (±1 element) and the limiter
// then reads the neighbours' UPDATED averages (±1 more), so a stage couples
// ±2 elements and an end slot's error reaches 2 slots further a stage: s_f
// steps of 5 stages need W ≥ 10·s_f. Unlimited, a stage couples ±1: W ≥
// 5·s_f.
//
// Bits: every element's arithmetic is the per-member kernel's (the one-CTA-
// a-member B1 it replaces), expression for expression and in the same order
// (stage_update, stage_limit below), and the troubled-cell test at ε₀ = 1e-8
// is ΠN's own, so a local element computes that kernel's bits whatever the
// tiling. The residual never leaves registers (stage 4's is dropped, as the
// per-member kernel never stored it).
//
// What bounds it on the H100: the card's operations bound is 2·Np² + 18·Np
// + 77 operations per element and stage with ΠN (chip_smoke.py's
// burgers_stage_ops), and a march reads u0 and writes u once. The kernel is
// issue- and latency-bound: a stage is a dependent chain of ~100-200
// instructions and two barriers a warp; with one CTA for the whole mesh
// (burgers_dg's K = 48: two warps) the chain sets the pace, and on many
// tiles the busiest SM's warps do. The ghosts add 2W/L of recomputed work
// and each launch a few µs. The wrapper's plan (ops/cuda/burgers.py
// burgers_plan) picks s_f, the CTA size and the tile count under a cost
// model fitted on the card. PERF.md holds the measured times.

#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kMaxNp = 16;

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

// The launch plan the wrapper picks: s_f steps a launch, L local elements a
// tile, W ghosts a side, and the CTA size the kernel is built for.
struct Plan {
  int seg, tile_l, ghost, threads;
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

// sign-unanimous minimum magnitude, else 0 (utils/minmod.m with m = 3).
// Branch-free: the product and the select are the per-member kernel's
// arithmetic, so the value is its bits; the limiter's three minmods carry no
// branch between them and can overlap.
template <typename T>
__device__ __forceinline__ T minmod3(T a, T b, T c) {
  const int s = sgn(a);
  const bool same = (s != 0) & (sgn(b) == s) & (sgn(c) == s);
  const T m = T(s) * amin(aabs(a), amin(aabs(b), aabs(c)));
  return same ? m : T(0);
}

// Phase A of stage s for one element: dt·rhs from its nodes u and the
// neighbours' traces, r = a_s·r + dt·rhs, un = u + b_s·r, and the cell
// average of un (returned). The per-member kernel's expressions verbatim.
template <typename T, int NP>
__device__ __forceinline__ T stage_update(const T* u, T ul_ext, T ur_ext, T rx,
                                          T fsl, T fsr, const Tables<T>& tab,
                                          int s, T* r, T* un) {
  const T a_s = tab.rka[s];
  const T b_s = tab.rkb[s];
  const T ul = u[0];
  const T ur = u[NP - 1];
  const T cl = amax(aabs(ul), aabs(ul_ext));
  const T cr = amax(aabs(ur), aabs(ur_ext));
  const T half = T(0.5);
  const T fstar_l = half * (half * ul * ul + half * ul_ext * ul_ext) +
                    half * cl * (ul_ext - ul);
  const T fstar_r = half * (half * ur * ur + half * ur_ext * ur_ext) -
                    half * cr * (ur_ext - ur);
  const T dfl = (-(half * ul * ul) + fstar_l) * fsl;
  const T dfr = (half * ur * ur - fstar_r) * fsr;
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
    r[i] = s == 0 ? rhs : a_s * r[i] + rhs;
    un[i] = u[i] + b_s * r[i];
    vk += tab.cavg[i] * un[i];
  }
  return vk;
}

// Phase B for one element: the minmod limiter on the updated nodes u (in
// place) from its average vk and the neighbours' vkm1, vkp1. limiter 0 = ΠN
// (only troubled cells), 1 = Π¹ (every cell).
template <typename T, int NP>
__device__ __forceinline__ void stage_limit(T* u, T vk, T vkm1, T vkp1, T ih,
                                            const T* xi, const Tables<T>& tab,
                                            int limiter) {
  const T dm = vk - vkm1;
  const T dp = vkp1 - vk;
  T ux = T(0);
#pragma unroll
  for (int j = 0; j < NP; ++j) ux += tab.drux[j] * u[j];
  ux = T(2) * ux * ih;
  const T slope = minmod3(ux, dp * ih, dm * ih);
  bool troubled = true;
  if (limiter == 0) {
    const T ve1 = vk - minmod3(vk - u[0], dm, dp);
    const T ve2 = vk + minmod3(u[NP - 1] - vk, dm, dp);
    troubled = (aabs(ve1 - u[0]) > T(1e-8)) | (aabs(ve2 - u[NP - 1]) > T(1e-8));
  }
#pragma unroll
  for (int i = 0; i < NP; ++i) u[i] = troubled ? vk + xi[i] * slope : u[i];
}

template <typename T, int TH>
struct Shared {
  T lo[2][TH];  // u[0] of each window slot, double-buffered by stage
  T hi[2][TH];  // u[Np−1]
  T avg[TH];    // the updated cell averages
};

// ``steps`` limited LSRK4(5) steps of the CTA's window from u_in; the local
// elements' result to u_out.
template <typename T, int NP, int TH>
__global__ void __launch_bounds__(TH, 1)
burgers_fused(const T* __restrict__ u_in, T* __restrict__ u_out, Geom<T> g,
              const __grid_constant__ Tables<T> tab, int limiter, int nk,
              int tile_l, int ghost, int steps) {
  __shared__ Shared<T, TH> sh;
  const int lo = blockIdx.x * tile_l;
  const int hi = min(lo + tile_l, nk);
  // one tile, no ghosts: the window is the ring [0, K) and wraps in itself
  const bool ring = ghost == 0 && tile_l >= nk;
  const int n_win = ring ? nk : hi - lo + 2 * ghost;
  const int e = threadIdx.x;
  const bool active = e < n_win;
  int k = (lo - ghost + e) % nk;
  if (k < 0) k += nk;
  const bool local = e >= ghost && e < ghost + hi - lo;
  const long bk = static_cast<long>(gridDim.y) * nk;
  const long c = static_cast<long>(blockIdx.y) * nk + k;
  // slots without a neighbour on a side: the window's ends (unless it is the
  // ring) for the flux; those and the global ends for the limiter
  const bool edge_l = !ring && e == 0;
  const bool edge_r = !ring && e == n_win - 1;
  const bool lim_l = edge_l || k == 0;
  const bool lim_r = edge_r || k == nk - 1;
  const int left = e == 0 ? n_win - 1 : e - 1;
  const int right = e == n_win - 1 ? 0 : e + 1;

  T u[NP] = {}, r[NP] = {}, un[NP] = {}, xi[NP] = {};
  T rx = T(0), fsl = T(0), fsr = T(0), ih = T(0);
  if (active) {
    rx = g.rx[k];
    fsl = g.fsl[k];
    fsr = g.fsr[k];
    ih = g.ih[k];
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      xi[i] = g.xi[i * nk + k];
      u[i] = u_in[i * bk + c];
    }
  }
  int buf = 0;
  for (int n = 0; n < steps; ++n) {
    for (int s = 0; s < 5; ++s, buf ^= 1) {
      sh.lo[buf][e] = u[0];
      sh.hi[buf][e] = u[NP - 1];
      __syncthreads();
      T vk = T(0);
      if (active) {
        const T ul_ext = edge_l ? u[0] : sh.hi[buf][left];
        const T ur_ext = edge_r ? u[NP - 1] : sh.lo[buf][right];
        vk = stage_update<T, NP>(u, ul_ext, ur_ext, rx, fsl, fsr, tab, s, r, un);
        sh.avg[e] = vk;
      }
#pragma unroll
      for (int i = 0; i < NP; ++i) u[i] = un[i];
      if (limiter == 2) continue;
      __syncthreads();
      if (active) {
        const T vkm1 = lim_l ? vk : sh.avg[left];  // copied endpoints
        const T vkp1 = lim_r ? vk : sh.avg[right];
        stage_limit<T, NP>(u, vk, vkm1, vkp1, ih, xi, tab, limiter);
      }
    }
  }
  if (active && local) {
#pragma unroll
    for (int i = 0; i < NP; ++i) u_out[i * bk + c] = u[i];
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

bool is_ring(int nk, const Plan& p) { return p.ghost == 0 && p.tile_l >= nk; }

// The CTA's threads: the window (the ring, or L + 2W) rounded up to warps.
int block_of(int nk, const Plan& p) {
  const int win = is_ring(nk, p) ? nk : (p.tile_l < nk ? p.tile_l : nk) + 2 * p.ghost;
  return (win + 31) / 32 * 32;
}

// n_steps steps from u0 in launches of s_f steps (the last takes the
// remainder). The state crosses launches through the ping-pong ubuf
// (2·Np·B·K values; unused with one launch); the last launch writes u_out.
template <typename T, int NP, int TH>
int march(int nb, int nk, int n_steps, int limiter, const T* tables,
          const T* geom, const Plan& p, const T* u0, T* u_out, T* ubuf,
          int* launches, cudaStream_t stream) {
  const Tables<T> tab = pack_tables<T>(NP, tables);
  const Geom<T> g{geom, geom + nk, geom + 2 * nk, geom + 3 * nk, geom + 4 * nk};
  const long size = static_cast<long>(NP) * nb * nk;
  const dim3 grid((nk + p.tile_l - 1) / p.tile_l, nb);
  const int block = block_of(nk, p);
  const T* cur = u0;
  for (int lo = 0; lo < n_steps; lo += p.seg) {
    const int steps = n_steps - lo < p.seg ? n_steps - lo : p.seg;
    T* out = lo + steps == n_steps ? u_out : ubuf + (*launches % 2) * size;
    burgers_fused<T, NP, TH><<<grid, block, 0, stream>>>(
        cur, out, g, tab, limiter, nk, p.tile_l, p.ghost, steps);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    ++*launches;
    cur = out;
  }
  return 0;
}

// -4 unless the kernel takes the plan: s_f >= 1, L >= 1, W >= 10·s_f (5·s_f
// unlimited) unless one tile holds the mesh with no ghosts, a CTA size the
// kernel is built for (float32: 512 or 1024 threads; float64: 512) and a
// window that fits it.
template <typename T>
int check_plan(int nk, int limiter, const Plan& p) {
  if (p.seg < 1 || p.tile_l < 1 || p.ghost < 0) return -4;
  if (!is_ring(nk, p) && p.ghost < (limiter == 2 ? 5 : 10) * p.seg) return -4;
  if (p.threads != 512 && (sizeof(T) == 8 || p.threads != 1024)) return -4;
  return block_of(nk, p) <= p.threads ? 0 : -4;
}

template <typename T, int NP>
int by_threads(int nb, int nk, int n_steps, int limiter, const T* tables,
               const T* geom, const Plan& p, const T* u0, T* u_out, T* ubuf,
               int* launches, cudaStream_t st) {
  if constexpr (sizeof(T) == 4) {
    if (p.threads == 1024)
      return march<T, NP, 1024>(nb, nk, n_steps, limiter, tables, geom, p, u0,
                                u_out, ubuf, launches, st);
  }
  return march<T, NP, 512>(nb, nk, n_steps, limiter, tables, geom, p, u0,
                           u_out, ubuf, launches, st);
}

template <typename T>
int dispatch(int np, int nb, int nk, int n_steps, int limiter, const Plan& p,
             const T* tables, const T* geom, const T* u0, T* u_out, T* ubuf,
             int* launches, void* stream) {
  if (limiter < 0 || limiter > 2) return -2;
  if (nb < 1 || nb > 65535 || nk < 2 || n_steps < 1) return -3;
  const int bad = check_plan<T>(nk, limiter, p);
  if (bad != 0) return bad;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (np) {
#define AOA_CASE(N)                                                             \
  case N:                                                                       \
    return by_threads<T, N>(nb, nk, n_steps, limiter, tables, geom, p, u0,     \
                            u_out, ubuf, launches, st);
    AOA_CASE(2) AOA_CASE(3) AOA_CASE(4) AOA_CASE(5) AOA_CASE(6) AOA_CASE(7) AOA_CASE(8)
    AOA_CASE(9) AOA_CASE(10) AOA_CASE(11) AOA_CASE(12) AOA_CASE(13) AOA_CASE(14)
    AOA_CASE(15) AOA_CASE(16)
#undef AOA_CASE
    default: return -1;
  }
}

}  // namespace

extern "C" {

// u0, u_out: (Np, B, K) device arrays; ubuf: 2·Np·B·K device scratch (null
// when the plan takes one launch); geom: (4 + Np, K) device rows [rx, fsl,
// fsr, 1/h, ξ_0 .. ξ_{Np−1}]; tables: host array (see pack_tables). limiter:
// 0 = ΠN, 1 = Π¹, 2 = none. The plan: s_f steps a launch (segment), L local
// elements a tile, W ghosts a side, the CTA size. *launches counts the CUDA
// launches. Returns 0, a cudaError_t code after a refused launch, or a
// negative code for a bad argument.
int burgers_march_f32(int np, int nb, int nk, int n_steps, int limiter,
                      int segment, int tile_l, int ghost, int threads,
                      const float* tables, const float* geom, const float* u0,
                      float* u_out, float* ubuf, int* launches, void* stream) {
  return dispatch<float>(np, nb, nk, n_steps, limiter,
                         Plan{segment, tile_l, ghost, threads}, tables, geom,
                         u0, u_out, ubuf, launches, stream);
}

int burgers_march_f64(int np, int nb, int nk, int n_steps, int limiter,
                      int segment, int tile_l, int ghost, int threads,
                      const double* tables, const double* geom,
                      const double* u0, double* u_out, double* ubuf,
                      int* launches, void* stream) {
  return dispatch<double>(np, nb, nk, n_steps, limiter,
                          Plan{segment, tile_l, ghost, threads}, tables, geom,
                          u0, u_out, ubuf, launches, stream);
}

const char* burgers_error_string(int code) {
  if (code == -1) return "unsupported Np (the kernel takes 2 <= Np <= 16)";
  if (code == -2) return "unknown limiter (0 = N, 1 = 1, 2 = none)";
  if (code == -3) return "bad shape (1 <= B <= 65535, K >= 2, n_steps >= 1)";
  if (code == -4)
    return "plan refused (s_f >= 1, W >= 10·s_f limited or 5·s_f unlimited "
           "unless one tile holds the mesh, 512 threads (float32 also 1024), "
           "a window that fits the CTA)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
