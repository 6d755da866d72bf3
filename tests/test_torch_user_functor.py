"""The tracer of elementwise callables (ops/cuda/functor.py) and its two
emitters, on the CPU.

- every op of the closed set, traced from a torch callable: the plain
  versions' f (the callable itself, t given as a Python float and the
  result broadcast to u's shape) gives the callable's value bit for bit in
  float64, and the derived f_u (``torch_jvp`` on the IR) ``jax.jvp`` of the
  jnp twin with a ones tangent to 1e-14 relative (the same float64
  operations, some in another order);
- the kinks, where torch's forward mode and JAX's differ: d|x|/dx at 0 and
  -0, ``maximum``/``minimum`` at a tie, ``where`` at its boundary, relu at
  0, clamp at its bounds: ``torch_jvp`` equals ``jax.jvp`` bit for bit;
- emitter (a): every functor's struct, with csrc/odes.cuh (its ``Dual``
  forward mode, ``OdeTraced``, ``OdeTracedVec``, ``GoalTraced``), built by
  g++ into one shared library for the module against a stub
  ``cuda_runtime.h`` and called through ctypes in float32: f within 4 ulp
  of the torch callable's float32 value (libm's sinf, expf, … may differ
  from torch's by an ulp, a few roundings by one each), f_u (derived on
  ``Dual<float>``) within 16·ε₃₂ of the largest |f_u| on the points of
  ``jax.jvp``'s float64 value at the same float32 inputs, and the kinks
  exactly JAX's; the Van der Pol functor's values, Jacobian and
  ``nonzero`` pattern (its literal 0.0 skipped);
- untraceable callables raise a ValueError naming the op and the callable:
  a Python ``if`` on u, ``torch.sum``, a captured 3-vector.

The kernels that take these functors run only on a GPU (chip_smoke.py
phase 42); tests/test_torch_user_kernels.py holds their plain versions
against the JAX kernels."""
import ctypes
import shutil
import subprocess
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adjoint_ode_adaptivity_tpu_torch.ops.cuda import functor

torch.set_num_threads(1)  # one intra-op thread a process: the suite runs in xdist workers

CSRC = Path(functor.__file__).resolve().parents[2] / "csrc"
C0 = torch.tensor(1.5, dtype=torch.float64)  # a captured 0-d constant
U_POS = (0.15, 0.85)  # the fixed functions keep u here (y0 in [0.2, 0.8])

# name -> (torch callable, jnp twin, u range); t runs over [0, 1]
OPS = {
    "add": (lambda u, t: u + t, lambda u, t: u + t, U_POS),
    "radd": (lambda u, t: 2.5 + u, lambda u, t: 2.5 + u, U_POS),
    "sub": (lambda u, t: u - t, lambda u, t: u - t, U_POS),
    "rsub": (lambda u, t: 1.0 - u, lambda u, t: 1.0 - u, U_POS),
    "mul": (lambda u, t: u * t, lambda u, t: u * t, U_POS),
    "rmul": (lambda u, t: 3.0 * u, lambda u, t: 3.0 * u, U_POS),
    "div": (lambda u, t: u / (t + 2.0), lambda u, t: u / (t + 2.0), U_POS),
    "rdiv": (lambda u, t: 1.0 / u, lambda u, t: 1.0 / u, U_POS),
    "neg": (lambda u, t: -u, lambda u, t: -u, U_POS),
    "pow2": (lambda u, t: u ** 2, lambda u, t: u ** 2, U_POS),
    "pow3": (lambda u, t: torch.pow(u, 3), lambda u, t: u ** 3, U_POS),
    "pow_half": (lambda u, t: u ** 0.5, lambda u, t: u ** 0.5, U_POS),
    "pow_m1": (lambda u, t: u ** -1, lambda u, t: u ** -1, U_POS),
    "pow_frac": (lambda u, t: u ** 1.7, lambda u, t: u ** 1.7, U_POS),
    "sin": (lambda u, t: torch.sin(u), lambda u, t: jnp.sin(u), U_POS),
    "cos": (lambda u, t: torch.cos(u), lambda u, t: jnp.cos(u), U_POS),
    "tan": (lambda u, t: torch.tan(u), lambda u, t: jnp.tan(u), U_POS),
    "exp": (lambda u, t: torch.exp(u), lambda u, t: jnp.exp(u), U_POS),
    "log": (lambda u, t: torch.log(u), lambda u, t: jnp.log(u), U_POS),
    "sqrt": (lambda u, t: torch.sqrt(u), lambda u, t: jnp.sqrt(u), U_POS),
    "rsqrt": (lambda u, t: torch.rsqrt(u), lambda u, t: jax.lax.rsqrt(u), U_POS),
    "tanh": (lambda u, t: torch.tanh(u), lambda u, t: jnp.tanh(u), U_POS),
    "sigmoid": (lambda u, t: torch.sigmoid(u), lambda u, t: jax.nn.sigmoid(u), U_POS),
    "abs": (lambda u, t: torch.abs(u), lambda u, t: jnp.abs(u), (-0.85, -0.15)),
    "relu": (lambda u, t: torch.relu(u - 0.5), lambda u, t: jax.nn.relu(u - 0.5), U_POS),
    "minimum": (lambda u, t: torch.minimum(u, t), lambda u, t: jnp.minimum(u, t), U_POS),
    "maximum": (lambda u, t: torch.maximum(u, t), lambda u, t: jnp.maximum(u, t), U_POS),
    "clamp": (lambda u, t: torch.clamp(u, 0.3, 0.6), lambda u, t: jnp.clip(u, 0.3, 0.6),
              U_POS),
    "where": (lambda u, t: torch.where(u > 0.5, u, 0.1 * u),
              lambda u, t: jnp.where(u > 0.5, u, 0.1 * u), U_POS),
    "where_and": (lambda u, t: torch.where((u > 0.3) & (u <= 0.6), u * u, -u),
                  lambda u, t: jnp.where((u > 0.3) & (u <= 0.6), u * u, -u), U_POS),
    "ones_like": (lambda u, t: torch.ones_like(u), lambda u, t: jnp.ones_like(u), U_POS),
    "zeros_like": (lambda u, t: torch.zeros_like(u) + u, lambda u, t: jnp.zeros_like(u) + u,
                   U_POS),
    "full_like": (lambda u, t: torch.full_like(u, 2.5) * u, lambda u, t: 2.5 * u, U_POS),
    "tensor_const": (lambda u, t: C0 * u, lambda u, t: 1.5 * u, U_POS),
    "method": (lambda u, t: u.sin().abs() + u.clamp(min=0.2),
               lambda u, t: jnp.abs(jnp.sin(u)) + jnp.maximum(u, 0.2), U_POS),
    "t_sin_u": (lambda u, t: t * torch.sin(u), lambda u, t: t * jnp.sin(u), U_POS),
    # the fixed scalar function of the kernels' tests and its goal
    "fixed_f": (lambda u, t: u * (1 - u) + 0.1 * torch.cos(2 * t),
                lambda u, t: u * (1 - u) + 0.1 * jnp.cos(2 * t), U_POS),
    "goal_inv": (lambda u, t: 1.0 / u, lambda u, t: 1.0 / u, U_POS),
}

# name -> (torch callable, jnp twin, kink points)
KINKS = {
    "abs_at_0": (lambda u, t: torch.abs(u), lambda u, t: jnp.abs(u), (0.0, -0.0, 1.0, -1.0)),
    "max_tie": (lambda u, t: torch.maximum(u, torch.zeros_like(u)),
                lambda u, t: jnp.maximum(u, 0.0), (0.0, -0.5, 0.5)),
    "min_tie": (lambda u, t: torch.minimum(u, t), lambda u, t: jnp.minimum(u, t), (0.25,)),
    "max_self": (lambda u, t: torch.maximum(u, u), lambda u, t: jnp.maximum(u, u), (0.3,)),
    "where_edge": (lambda u, t: torch.where(u > 0.5, u, 0.1 * u),
                   lambda u, t: jnp.where(u > 0.5, u, 0.1 * u), (0.5,)),
    "relu_at_0": (lambda u, t: torch.relu(u), lambda u, t: jax.nn.relu(u), (0.0, 2.0, -2.0)),
    "clamp_bounds": (lambda u, t: torch.clamp(u, 0.25, 0.75),
                     lambda u, t: jnp.clip(u, 0.25, 0.75), (0.25, 0.75, 0.5)),
}
KINK_T = 0.25  # min_tie's tie: u = t = 0.25 (every kink exact in float32 too)


def _points(lo, hi, n=13, dtype=torch.float64):
    u = torch.linspace(lo, hi, n, dtype=dtype)
    t = torch.linspace(0.0, 1.0, n, dtype=dtype)
    return u, t


def _jvp(fn, u, t):
    """jax.jvp of ``fn`` in u with a ones tangent, float64."""
    u, t = jnp.asarray(np.asarray(u, np.float64)), jnp.asarray(np.asarray(t, np.float64))
    return np.asarray(jax.jvp(lambda x: fn(x, t), (u,), (jnp.ones_like(u),))[1])


@pytest.mark.parametrize("name", list(OPS))
def test_torch_emitter_and_derivative_match_the_callable_and_jax(name):
    fn, twin, dom = OPS[name]
    u, t = _points(*dom)
    kf = functor.scalar_functors(f=fn, source="dg_slab.cu", goal=False)
    assert torch.equal(kf.ode.f(u, t), torch.broadcast_to(fn(u, t), u.shape))
    at = kf.ode.f(u, 0.75)  # t as the FD plain versions pass it: a Python float
    assert at.shape == u.shape and torch.equal(at, torch.broadcast_to(fn(u, t.new_tensor(0.75)),
                                                                      u.shape))
    got = kf.ode.f_u(u, t).numpy()
    want = _jvp(twin, u, t)
    np.testing.assert_allclose(got, want, rtol=1e-14, atol=1e-14 * np.abs(want).max())


@pytest.mark.parametrize("name", list(KINKS))
def test_derivative_at_kinks_is_jaxs_bit_for_bit(name):
    fn, twin, pts = KINKS[name]
    u = torch.tensor(pts, dtype=torch.float64)
    t = torch.full_like(u, KINK_T)
    got = functor.torch_jvp(functor.trace(fn))(u, t).numpy()
    want = _jvp(twin, u, t)
    np.testing.assert_array_equal(got, want)
    if name == "abs_at_0":  # torch's own forward mode gives 0 at 0: the rule is JAX's
        assert got[0] == got[1] == 1.0


# ------------------------------------------------------- emitter (a) by g++

STUB = """#pragma once
#include <cmath>
#define __host__
#define __device__
#define __forceinline__ inline
"""
VDP_F = lambda us, t: (us[1], (1.0 - us[0] * us[0]) * us[1] - us[0])  # noqa: E731
VDP_J = lambda us, t: ((0.0, 1.0), (-2.0 * us[0] * us[1] - 1.0, 1.0 - us[0] * us[0]))  # noqa: E731


@pytest.fixture(scope="module")
def gxx_lib(tmp_path_factory):
    """One g++ build of every functor of the module: extern "C"
    ``pair_i(u, t, f, fu, n)`` (OdeTraced<F>, f_u derived on Dual<float>)
    per case of OPS then KINKS, ``given`` (OdeTraced<F, FU>, f_u as given)
    and ``goal`` (GoalTraced), and ``vdp`` / ``vdp_nonzero`` (OdeTracedVec)."""
    gxx = shutil.which("g++")
    assert gxx, "g++ is needed to build the generated functors on the CPU"
    root = tmp_path_factory.mktemp("functors")
    (root / "stub").mkdir()
    (root / "stub" / "cuda_runtime.h").write_text(STUB)
    scalar = [functor.trace(fn) for fn, _, _ in (*OPS.values(), *KINKS.values())]
    fixed_u = functor.trace(lambda u, t: 1.0 - 2.0 * u)
    vdp_f, vdp_j = functor.trace(VDP_F, 2), functor.trace(VDP_J, 2, jacobian=True)
    structs = {functor.struct_name(tr): functor.cuda_struct(tr)
               for tr in (*scalar, fixed_u, vdp_f, vdp_j)}  # one struct a distinct body
    (root / "aoa_user_functors.cuh").write_text("\n".join(structs.values()))
    name = functor.struct_name
    body = ['#include "odes.cuh"', "using namespace aoa;", 'extern "C" {']
    loop = "for (int i = 0; i < n; ++i) "
    for i, tr in enumerate(scalar):
        body.append(f"void pair_{i}(const float* u, const float* t, float* f, float* fu, int n) "
                    f"{{ OdeConsts k{{}}; {loop}OdeTraced<{name(tr)}>::pair(u[i], t[i], k, f + i, "
                    f"fu + i); }}")
    body.append(f"void given(const float* u, const float* t, float* f, float* fu, int n) "
                f"{{ OdeConsts k{{}}; {loop}OdeTraced<{name(scalar[list(OPS).index('fixed_f')])}, "
                f"{name(fixed_u)}>::pair(u[i], t[i], k, f + i, fu + i); }}")
    body.append(f"void goal(const float* u, const float* t, float* g, int n) "
                f"{{ {loop}g[i] = GoalTraced<{name(scalar[list(OPS).index('goal_inv')])}>"
                f"::g_u(u[i], t[i]); }}")
    vdp = f"OdeTracedVec<2, {name(vdp_f)}, {name(vdp_j)}>"
    body.append(f"void vdp(const float* u, float t, float* f, float* jac, int n) "
                f"{{ OdeConsts k{{}}; {loop}{vdp}::pair(u + 2 * i, t, k, f + 2 * i, "
                f"jac + 4 * i); }}")
    body.append(f"int vdp_nonzero(int m, int i) {{ return {vdp}::nonzero(m, i); }}")
    body.append("}")
    (root / "functors.cpp").write_text("\n".join(body) + "\n")
    out = root / "libfunctors.so"
    proc = subprocess.run(
        [gxx, "-std=c++17", "-O2", "-ffp-contract=off", "-shared", "-fPIC",
         "-DAOA_USER_FUNCTORS", "-I", str(root / "stub"), "-I", str(root), "-I", str(CSRC),
         str(root / "functors.cpp"), "-o", str(out)],
        capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr
    return ctypes.CDLL(str(out))


def _ptr(a):
    return a.ctypes.data_as(ctypes.c_void_p)


def _call_pair(fn, u32, t32):
    f, fu = np.zeros_like(u32), np.zeros_like(u32)
    fn(_ptr(u32), _ptr(t32), _ptr(f), _ptr(fu), ctypes.c_int(u32.size))
    return f, fu


def _ulps(got, want):
    """|got − want| in float32 ulps of want."""
    want = np.asarray(want, np.float32)
    return np.abs(got.astype(np.float64) - want.astype(np.float64)) / np.spacing(np.abs(want))


@pytest.mark.parametrize("index,name", list(enumerate(OPS)))
def test_gxx_functor_matches_torch_and_jax_in_float32(gxx_lib, index, name):
    fn, twin, dom = OPS[name]
    u, t = _points(*dom, dtype=torch.float32)
    u32, t32 = u.numpy().copy(), t.numpy().copy()
    f, fu = _call_pair(getattr(gxx_lib, f"pair_{index}"), u32, t32)
    want = torch.broadcast_to(fn(u, t), u.shape).numpy()
    assert _ulps(f, want).max() <= 4.0, (f, want)
    want_fu = _jvp(twin, u32, t32)
    bound = 16 * np.finfo(np.float32).eps * max(np.abs(want_fu).max(), np.finfo(np.float32).tiny)
    np.testing.assert_allclose(fu, want_fu, rtol=0, atol=bound)


@pytest.mark.parametrize("index,name", list(enumerate(KINKS)))
def test_gxx_dual_at_kinks_is_jaxs(gxx_lib, index, name):
    fn, twin, pts = KINKS[name]
    u32 = np.asarray(pts, np.float32)
    t32 = np.full_like(u32, KINK_T)
    _, fu = _call_pair(getattr(gxx_lib, f"pair_{len(OPS) + index}"), u32, t32)
    np.testing.assert_array_equal(fu, _jvp(twin, u32, t32).astype(np.float32))


def test_gxx_given_f_u_goal_and_vector_functor(gxx_lib):
    fixed, _, dom = OPS["fixed_f"]
    u, t = _points(*dom, dtype=torch.float32)
    u32, t32 = u.numpy().copy(), t.numpy().copy()
    f, fu = _call_pair(gxx_lib.given, u32, t32)
    assert _ulps(f, fixed(u, t).numpy()).max() <= 4.0
    np.testing.assert_array_equal(fu, (1.0 - 2.0 * u).numpy())  # f_u as given: 1 − 2u
    g = np.zeros_like(u32)
    gxx_lib.goal(_ptr(u32), _ptr(t32), _ptr(g), ctypes.c_int(u32.size))
    np.testing.assert_array_equal(g, (1.0 / u).numpy())
    us = np.random.default_rng(3).uniform(-1.5, 1.5, (9, 2)).astype(np.float32)
    fv, jac = np.zeros_like(us), np.zeros((9, 4), np.float32)
    gxx_lib.vdp(_ptr(us), ctypes.c_float(0.0), _ptr(fv), _ptr(jac), ctypes.c_int(9))
    ut = torch.from_numpy(us)
    want_f = torch.stack(VDP_F((ut[:, 0], ut[:, 1]), 0.0), dim=-1).numpy()
    np.testing.assert_array_equal(fv, want_f)
    x, y = ut[:, 0], ut[:, 1]
    want_j = torch.stack([torch.zeros_like(x), torch.ones_like(x), -2.0 * x * y - 1.0,
                          1.0 - x * x], dim=-1).numpy()
    np.testing.assert_array_equal(jac, want_j)
    assert [gxx_lib.vdp_nonzero(m, i) for m in range(2) for i in range(2)] == [0, 1, 1, 1]


# ------------------------------------------------------------- refusals

CAPTURED = torch.tensor([1.0, 2.0, 3.0])


def _python_if(u, t):
    if u > 0:
        return u
    return -u


@pytest.mark.parametrize("fn,op", [
    (_python_if, "control flow"),
    (lambda u, t: torch.sum(u), "torch.sum"),
    (lambda u, t: u * CAPTURED, "captured tensor of shape (3,)"),
    (lambda u, t: torch.special.erf(u), "erf"),
])
def test_untraceable_callables_raise_naming_the_op(fn, op):
    with pytest.raises(ValueError, match="cannot trace") as info:
        functor.trace(fn)
    msg = str(info.value)
    assert op in msg, msg
    assert (fn.__qualname__ in msg), msg


def test_vector_traces_and_their_refusals():
    vf = functor.vector_functors(f_comps=VDP_F, jac_comps=VDP_J, d=2, source="fd_ensemble.cu")
    assert vf.d == 2 and "OdeTracedVec<2," in vf.header
    u = torch.tensor(np.random.default_rng(1).uniform(-1, 1, (5, 2)))
    np.testing.assert_array_equal(vf.ode.f(u, 0.0)[:, 0].numpy(), u[:, 1].numpy())
    jac = vf.ode.f_u(u, 0.0)
    assert jac.shape == (5, 2, 2) and torch.all(jac[:, 0, 0] == 0) and torch.all(jac[:, 0, 1] == 1)
    with pytest.raises(ValueError, match="at most d=15"):
        functor.vector_functors(f_comps=lambda us, t: us, jac_comps=VDP_J, d=16, source="x")
    with pytest.raises(ValueError, match="2-tuple"):
        functor.vector_functors(f_comps=lambda us, t: us[0], jac_comps=VDP_J, d=2, source="x")
    with pytest.raises(ValueError, match="us\\[i\\]"):
        functor.trace(lambda us, t: (us[2], us[0]), 2)
