"""Elementwise callables traced into device functors.

Counterpart of what Pallas does with the jnp callables that
``make_pallas_fd_ensemble``, ``make_pallas_fd_ensemble_vec``,
``make_pallas_fd_estimate_per_member``, ``make_pallas_dg_estimate_ensemble``
and ``make_pallas_dg_estimate_hp_per_member`` take: it traces them into
the kernel body. Here :func:`trace` runs ``torch.fx.symbolic_trace`` on a
torch callable once and turns the graph into a small IR with a closed op
set:

- ``+ − × ÷`` in either operand order, ``neg``, ``pow`` by a constant;
- ``sin cos tan exp log sqrt rsqrt tanh sigmoid abs relu``;
- ``minimum maximum clamp`` (clamp as maximum, then minimum);
- ``where`` on comparisons (``> >= < <= == !=``, joined by ``& | ~``);
- ``ones_like zeros_like full_like``, Python numbers and 0-d tensors.

Anything else raises a ValueError naming the op and the callable: an op
outside the set (a reduction such as ``torch.sum``), data-dependent Python
control flow, a captured tensor of more than one element. Nothing falls
back to the plain version.

:func:`cuda_struct` emits the IR as a struct with a ``__host__
__device__`` member template ``eval`` on the scalar type, its constants
exact float32 literals (hex floats). ``csrc/odes.cuh`` wraps it into the
functors the kernels take (``OdeTraced``, ``OdeTracedVec``,
``GoalTraced``). The kernels' plain versions call the caller's callables
themselves (:func:`trace` has shown them elementwise).

A missing ``f_u`` is derived by forward mode, as the JAX package's
``jax.jvp`` with a ones tangent: on the device ``OdeTraced<F>`` evaluates
the functor on ``Dual<float>`` (odes.cuh), on the host :func:`torch_jvp`
runs the same rules on the IR. Both take JAX's derivatives at kinks, not torch's:
d|x|/dx = +1 at 0, ``maximum``/``minimum`` give half of each tangent at a
tie, ``where`` the chosen branch's tangent, relu'(0) = 0.

:class:`KernelFunctors` resolves what one scalar kernel (F1, F3, D1, H1)
runs: a registry ODE and goal on the registry library, or anything traced
on a user library that :func:`~adjoint_ode_adaptivity_tpu_torch.ops.cuda.
load_user_library` builds from the kernel's source and the generated
header (``aoa_user_functors.cuh``) alone, its switches instantiating the
one user functor.
"""
from __future__ import annotations

import hashlib
import math
import operator
from typing import Callable, NamedTuple

import numpy as np
import torch

from adjoint_ode_adaptivity_tpu_torch import functionals, odes

__all__ = [
    "USER_KERNEL_ID",
    "VECTOR_KERNEL_IDS",
    "MAX_VECTOR_D",
    "Trace",
    "trace",
    "torch_jvp",
    "cuda_struct",
    "struct_name",
    "KernelFunctors",
    "scalar_functors",
    "vector_functors",
]

USER_KERNEL_ID = 1000  # csrc/odes.cuh kUserKernelId: the user case of every switch
# registry id -> (d, live Jacobian entries): csrc/odes.cuh OdeHarmonic
VECTOR_KERNEL_IDS = {odes.KERNEL_IDS["harmonic_oscillator"]: (2, 2)}
# F2's cap on the state size, JAX's own: make_pallas_fd_ensemble_vec's
# scoped-VMEM check admits d = 15 at one step and no d >= 16. F2 holds a
# node's table in registers where fd_ensemble.f2_registers, else in a
# shared-memory window.
MAX_VECTOR_D = 15

_UNARY = ("neg", "sin", "cos", "tan", "exp", "log", "sqrt", "rsqrt", "tanh", "sigmoid", "abs",
          "relu")
_BINARY = ("add", "sub", "mul", "div", "min", "max")
_COMPARE = {"gt": ">", "ge": ">=", "lt": "<", "le": "<=", "eq": "==", "ne": "!="}
_LOGIC = ("and", "or", "not")

# fx targets -> IR ops (call_function by object, call_method by name)
_FUNCTIONS = {
    operator.add: "add", operator.sub: "sub", operator.mul: "mul", operator.truediv: "div",
    operator.neg: "neg", operator.pos: "pos", operator.pow: "pow", operator.abs: "abs",
    operator.gt: "gt", operator.ge: "ge", operator.lt: "lt", operator.le: "le",
    operator.eq: "eq", operator.ne: "ne", operator.and_: "and", operator.or_: "or",
    operator.invert: "not",
    torch.add: "add", torch.sub: "sub", torch.subtract: "sub", torch.mul: "mul",
    torch.multiply: "mul", torch.div: "div", torch.divide: "div", torch.true_divide: "div",
    torch.neg: "neg", torch.negative: "neg", torch.pow: "pow", torch.sin: "sin",
    torch.cos: "cos", torch.tan: "tan", torch.exp: "exp", torch.log: "log",
    torch.sqrt: "sqrt", torch.rsqrt: "rsqrt", torch.tanh: "tanh", torch.sigmoid: "sigmoid",
    torch.abs: "abs", torch.relu: "relu", torch.nn.functional.relu: "relu",
    torch.minimum: "min", torch.maximum: "max", torch.clamp: "clamp", torch.clip: "clamp",
    torch.where: "where", torch.ones_like: "ones_like", torch.zeros_like: "zeros_like",
    torch.full_like: "full_like", torch.gt: "gt", torch.ge: "ge", torch.lt: "lt",
    torch.le: "le", torch.eq: "eq", torch.ne: "ne", torch.logical_and: "and",
    torch.logical_or: "or", torch.logical_not: "not",
}
_METHODS = {
    "add": "add", "sub": "sub", "mul": "mul", "div": "div", "neg": "neg", "pow": "pow",
    "sin": "sin", "cos": "cos", "tan": "tan", "exp": "exp", "log": "log", "sqrt": "sqrt",
    "rsqrt": "rsqrt", "tanh": "tanh", "sigmoid": "sigmoid", "abs": "abs", "relu": "relu",
    "clamp": "clamp", "clip": "clamp", "minimum": "min", "maximum": "max", "gt": "gt",
    "ge": "ge", "lt": "lt", "le": "le", "eq": "eq", "ne": "ne",
}
# keyword arguments an op may carry (dtype and device of the *_like ops
# follow u's, as the kernels' float32 does)
_KWARGS = {"clamp": ("min", "max"), "full_like": ("fill_value", "dtype", "device"),
           "ones_like": ("dtype", "device"), "zeros_like": ("dtype", "device")}


class Trace(NamedTuple):
    """One traced callable. ``nodes[i] = (op, args)``, each arg a node index
    (an ``int``) or a constant (a ``float``, a pow's exponent too);
    ``("u", (c,))`` reads component c of the state (0 for a scalar),
    ``("t", ())`` the time. ``outputs`` holds one entry a scalar result
    (``d = 0``), d for a vector ``f_comps`` and d·d (row-major, [m][i] =
    ∂f_m/∂u_i) for ``jac_comps``: a node index, a constant, or ``None`` for
    a literal zero (structurally zero; the kernels skip it)."""

    name: str
    nodes: tuple
    outputs: tuple
    d: int

    @property
    def key(self) -> str:
        """Hash of the emitted source (the cache key)."""
        return hashlib.sha256(_body(self).encode()).hexdigest()[:16]


class _Ref(int):
    """A node index inside :func:`trace`, told apart from the constants."""


def _describe(fn) -> str:
    name = getattr(fn, "__qualname__", None) or repr(fn)
    code = getattr(fn, "__code__", None)
    where = f" ({code.co_filename}:{code.co_firstlineno})" if code is not None else ""
    return f"{name}{where}"


def trace(fn: Callable, d: int = 0, jacobian: bool = False) -> Trace:
    """Trace ``fn(u, t)`` (``d = 0``) or ``fn(us, t)`` with a d-tuple ``us``
    (a vector ``f_comps``; ``jacobian`` for ``jac_comps``, a d×d nested
    tuple) into the IR. Raises a ValueError naming the op and ``fn`` for
    anything outside the op set."""
    import torch.fx as fx

    name = _describe(fn)
    if not callable(fn):
        raise ValueError(f"{name} is not callable")
    try:
        gm = fx.symbolic_trace(fn)
    except Exception as exc:  # fx raises TraceError, TypeError, ... for an untraceable body
        raise ValueError(f"cannot trace {name} into a device functor: {type(exc).__name__}: "
                         f"{exc} (data-dependent control flow or a non-torch op)") from exc
    nodes: list = []
    memo: dict = {}
    env: dict = {}

    def fail(what: str):
        raise ValueError(f"cannot trace {name} into a device functor: {what}")

    def emit(op, args):
        key = (op, tuple((isinstance(a, _Ref), a) for a in args))
        if key not in memo:
            memo[key] = _Ref(len(nodes))
            nodes.append((op, tuple(args)))
        return memo[key]

    def const(x):
        if isinstance(x, (bool, int, float, np.integer, np.floating)):
            return float(x)
        if isinstance(x, torch.Tensor):
            if x.numel() != 1 or x.dim() != 0:
                fail(f"a captured tensor of shape {tuple(x.shape)} (only 0-d constants)")
            return float(x.item())
        fail(f"the constant {x!r} of type {type(x).__name__}")

    def arg(a):
        if isinstance(a, fx.Node):
            return env[a]
        return const(a)

    def is_bool(a):
        return isinstance(a, _Ref) and nodes[a][0] in (*_COMPARE, *_LOGIC)

    def num(a, what):
        if is_bool(a):
            fail(f"{what} takes a number, not a comparison")
        return a

    placeholders = [n for n in gm.graph.nodes if n.op == "placeholder"]
    if len(placeholders) != 2:
        fail(f"{len(placeholders)} arguments; a functor takes (u, t)")
    for node in gm.graph.nodes:
        if node.op == "placeholder":
            if node is placeholders[0]:
                env[node] = "us" if d else emit("u", (0,))
            else:
                env[node] = emit("t", ())
            continue
        if node.op == "get_attr":
            env[node] = const(getattr(gm, node.target))
            continue
        if node.op == "output":
            out = node.args[0]
            break
        if node.op == "call_function" and node.target is operator.getitem:
            base, idx = node.args
            if not (d and env.get(base) == "us" and isinstance(idx, int) and 0 <= idx < d):
                fail(f"indexing {node.args!r} (only us[i], i < d={d}, of a vector state)")
            env[node] = emit("u", (idx,))
            continue
        if node.op == "call_function":
            op = _FUNCTIONS.get(node.target)
            module = (getattr(node.target, "__module__", None) or "").lstrip("_")
            what = f"{module}.{getattr(node.target, '__name__', node.target)}".lstrip(".")
        elif node.op == "call_method":
            op, what = _METHODS.get(node.target), f"Tensor.{node.target}"
        else:
            op, what = None, f"{node.op} {node.target}"
        if op is None:
            fail(f"the op {what} is not in the functor op set")
        bad = set(node.kwargs) - set(_KWARGS.get(op, ()))
        if bad:
            fail(f"{what} with keyword arguments {sorted(bad)}")
        args = [arg(a) for a in node.args]
        if any(a == "us" for a in args if isinstance(a, str)):
            fail(f"{what} on the whole state tuple (index its components)")
        env[node] = _lower(op, what, args, {k: arg(v) for k, v in node.kwargs.items()},
                           emit, num, is_bool, fail)
    else:  # pragma: no cover - fx graphs always end in an output node
        fail("no output")

    def result(x):
        if isinstance(x, fx.Node):
            x = env[x]
        else:
            x = const(x)
        if isinstance(x, str) or is_bool(x):
            fail("the result is not a number")
        return x

    if d == 0:
        outputs = (result(out),)
    elif not jacobian:
        if not isinstance(out, (tuple, list)) or len(out) != d:
            fail(f"f_comps must return a {d}-tuple")
        outputs = tuple(result(x) for x in out)
    else:
        if not (isinstance(out, (tuple, list)) and len(out) == d
                and all(isinstance(r, (tuple, list)) and len(r) == d for r in out)):
            fail(f"jac_comps must return a {d}x{d} nested tuple")
        # a literal zero (a Python number, not a traced value) is structurally zero
        outputs = tuple(None if not isinstance(x, fx.Node) and isinstance(x, (int, float))
                        and x == 0 else result(x) for row in out for x in row)

    def plain(a):
        return int(a) if isinstance(a, _Ref) else a

    return Trace(name, tuple((op, tuple(map(plain, args))) for op, args in nodes),
                 tuple(map(plain, outputs)), d)


def _lower(op, what, args, kwargs, emit, num, is_bool, fail):
    """The IR of one op: emitted nodes, constants folded in float64."""

    def fold(op, args):
        if all(not isinstance(a, _Ref) for a in args):
            like = torch.zeros((), dtype=torch.float64)
            return float(_torch_ops(op, [torch.tensor(float(a), dtype=like.dtype) for a in args],
                                    like))
        return emit(op, args)

    if op == "pos":
        return num(args[0], what)
    if op in ("ones_like", "zeros_like", "full_like"):
        if op == "full_like":
            fill = args[1] if len(args) > 1 else kwargs.get("fill_value")
            if fill is None or isinstance(fill, _Ref):
                fail(f"{what} with a fill value that is not a constant")
            return float(fill)
        return 1.0 if op == "ones_like" else 0.0
    if op in _UNARY:
        if len(args) != 1:
            fail(f"{what} with {len(args)} arguments")
        return fold(op, [num(args[0], what)])
    if op == "pow":
        base, expo = args
        if isinstance(expo, _Ref):
            fail(f"{what} with a traced exponent (only pow by a constant)")
        if not isinstance(base, _Ref):
            return fold("pow", [base, expo])
        return emit("pow", (num(base, what), expo))
    if op in _BINARY:
        if len(args) != 2:
            fail(f"{what} with {len(args)} arguments")
        return fold(op, [num(a, what) for a in args])
    if op == "clamp":
        x = num(args[0], what)
        lo = args[1] if len(args) > 1 else kwargs.get("min")
        hi = args[2] if len(args) > 2 else kwargs.get("max")
        if lo is not None:
            x = fold("max", [x, num(lo, what)])
        if hi is not None:
            x = fold("min", [x, num(hi, what)])
        return x
    if op in _COMPARE:
        a, b = (num(x, what) for x in args)
        if not isinstance(a, _Ref) and not isinstance(b, _Ref):
            fail(f"{what} of two constants")
        return emit(op, (a, b))
    if op in _LOGIC:
        if not all(is_bool(a) for a in args):
            fail(f"{what} takes comparisons")
        return emit(op, tuple(args))
    if op == "where":
        cond, a, b = args
        if not is_bool(cond):
            fail(f"{what} whose condition is not a comparison")
        return emit("where", (cond, num(a, what), num(b, what)))
    fail(f"the op {what}")  # pragma: no cover - every op of the tables is handled


# ------------------------------------- torch ops: folding, the plain calls, f_u


def _torch_ops(op, a, like):
    """One IR op on torch operands (tensors or Python numbers; a constant
    that an op takes as a tensor in ``like``'s dtype and device)."""

    def tensor(v):
        return v if isinstance(v, torch.Tensor) else torch.tensor(v, dtype=like.dtype,
                                                                   device=like.device)

    if op in ("add", "sub", "mul", "div"):
        return {"add": operator.add, "sub": operator.sub, "mul": operator.mul,
                "div": operator.truediv}[op](a[0], a[1])
    if op == "pow":
        return torch.pow(a[0], a[1])
    if op in ("min", "max"):
        return (torch.minimum if op == "min" else torch.maximum)(tensor(a[0]), tensor(a[1]))
    if op in _COMPARE:
        return {"gt": operator.gt, "ge": operator.ge, "lt": operator.lt, "le": operator.le,
                "eq": operator.eq, "ne": operator.ne}[op](a[0], a[1])
    if op == "and":
        return a[0] & a[1]
    if op == "or":
        return a[0] | a[1]
    if op == "not":
        return ~a[0]
    if op == "where":
        return torch.where(a[0], tensor(a[1]), tensor(a[2]))
    return getattr(torch, op)(a[0])


def _as_input(t, like):
    """t as a tensor of u's dtype and device (the kernels' t is a float32
    like u; the plain versions pass a Python float or a tensor)."""
    return torch.as_tensor(t, dtype=like.dtype, device=like.device)


def _as_output(x, like):
    """A result as a tensor of u's shape (a constant, a literal zero or a
    term in t alone broadcast)."""
    return torch.broadcast_to(torch.as_tensor(x, dtype=like.dtype, device=like.device),
                              like.shape)


def _elementwise(fn: Callable) -> Callable:
    """A traced scalar callable as the plain versions call it: t as a
    tensor of u's dtype, the result of u's shape."""

    def call(u, t):
        return _as_output(fn(u, _as_input(t, u)), u)

    return call


def torch_jvp(tr: Trace) -> Callable:
    """∂fn/∂u of a scalar trace in torch ops: forward mode with a ones
    tangent on u and none on t, JAX's rules (its kinks included)."""
    if tr.d:
        raise ValueError("torch_jvp derives scalar functors only")

    def jvp(u, t):
        like, t = u, _as_input(t, u)
        vals, tans = [], []
        for op, args in tr.nodes:
            if op == "u":
                vals.append(u)
                tans.append(torch.ones_like(like))
                continue
            if op == "t":
                vals.append(t)
                tans.append(None)
                continue
            a = [vals[x] if isinstance(x, int) else x for x in args]
            g = [tans[x] if isinstance(x, int) else None for x in args]
            ans = _torch_ops(op, a, like)
            vals.append(ans)
            tans.append(None if op in _COMPARE or op in _LOGIC else _tangent(op, a, g, ans))
        x = tr.outputs[0]
        if not isinstance(x, int) or tans[x] is None:
            return torch.zeros_like(like)
        return tans[x]

    jvp.trace = tr
    return jvp


def _tangent(op, a, g, ans):
    """JAX's jvp rule of one op (``None`` for a zero tangent)."""
    x = a[0]
    gx = g[0]
    if op in ("add", "sub"):
        gy = g[1]
        if gx is None and gy is None:
            return None
        if gy is None:
            return gx
        if gx is None:
            return gy if op == "add" else -gy
        return gx + gy if op == "add" else gx - gy
    if op == "mul":
        y, gy = a[1], g[1]
        terms = [t for t in (None if gx is None else gx * y, None if gy is None else x * gy)
                 if t is not None]
        return None if not terms else terms[0] if len(terms) == 1 else terms[0] + terms[1]
    if op == "div":
        y, gy = a[1], g[1]
        terms = [t for t in (None if gx is None else gx / y,
                             None if gy is None else (-gy * x) * (1.0 / (y * y)))
                 if t is not None]
        return None if not terms else terms[0] if len(terms) == 1 else terms[0] + terms[1]
    if op in ("min", "max"):
        y, gy = a[1], g[1]
        if gx is None and gy is None:
            return None

        def w(p, q):  # _balanced_eq(p, ans, q): 1 where p is the result, ½ at a tie
            one = torch.ones_like(ans)
            return (torch.where(p == ans, one, 0.0 * one)
                    / torch.where(q == ans, 2.0 * one, one))

        terms = [t for t in (None if gx is None else gx * w(x, y),
                             None if gy is None else gy * w(y, x)) if t is not None]
        return terms[0] if len(terms) == 1 else terms[0] + terms[1]
    if op == "where":
        ga, gb = g[1], g[2]
        if ga is None and gb is None:
            return None
        zero = torch.zeros_like(ans)
        return torch.where(a[0], zero if ga is None else ga, zero if gb is None else gb)
    if gx is None:
        return None
    if op == "pow":  # by a constant c: c·x^(c−1), 0 for c = 0 (integer_pow's rule)
        c = a[1]
        return None if c == 0 else gx * (c * torch.pow(x, c - 1))
    if op == "neg":
        return -gx
    if op == "sin":
        return gx * torch.cos(x)
    if op == "cos":
        return -(gx * torch.sin(x))
    if op == "tan":
        return gx * (1.0 + ans * ans)
    if op == "exp":
        return gx * ans
    if op == "log":
        return gx / x
    if op == "sqrt":
        return gx * (0.5 / ans)
    if op == "rsqrt":
        return gx * (-0.5 * (ans / x))
    if op == "tanh":
        return (gx + gx * ans) * (1.0 - ans)
    if op == "sigmoid":
        return gx * (ans * (1.0 - ans))
    if op == "abs":
        return torch.where(x >= 0, gx, -gx)
    if op == "relu":
        return torch.where(x > 0, gx, torch.zeros_like(gx))
    raise AssertionError(op)  # pragma: no cover - every differentiable op is listed


# -------------------------------------------------------------- CUDA emitter


def _literal(c) -> str:
    """An exact float32 literal of ``c`` (hex float)."""
    f = float(np.float32(c))
    if not math.isfinite(f):
        raise ValueError(f"the constant {c!r} is not finite in float32")
    return f"{f.hex()}f"


def _body(tr: Trace) -> str:
    """The statements of ``eval``: one ``const`` per node, then the outputs."""
    lines = []

    def ref(a):
        return f"v{a}" if isinstance(a, int) else f"T({_literal(a)})"

    def val(a):  # the value a comparison reads
        return f"uf::val(v{a})" if isinstance(a, int) else _literal(a)

    for i, (op, args) in enumerate(tr.nodes):
        if op == "u":
            rhs = f"u[{args[0]}]" if tr.d else "u"
        elif op == "t":
            rhs = "t"
        elif op in ("add", "sub", "mul", "div"):
            sym = {"add": "+", "sub": "-", "mul": "*", "div": "/"}[op]
            rhs = f"{ref(args[0])} {sym} {ref(args[1])}"
        elif op == "pow":
            expo = args[1]
            rhs = (f"uf::ipow(v{args[0]}, {int(expo)})"
                   if expo.is_integer() and abs(expo) <= 64
                   else f"uf::pow(v{args[0]}, {_literal(expo)})")
        elif op in ("min", "max"):
            rhs = f"uf::{op}({ref(args[0])}, {ref(args[1])})"
        elif op in _COMPARE:
            lines.append(f"const bool v{i} = {val(args[0])} {_COMPARE[op]} {val(args[1])};")
            continue
        elif op in ("and", "or"):
            lines.append(f"const bool v{i} = v{args[0]} {'&&' if op == 'and' else '||'} "
                         f"v{args[1]};")
            continue
        elif op == "not":
            lines.append(f"const bool v{i} = !v{args[0]};")
            continue
        elif op == "where":
            rhs = f"v{args[0]} ? {ref(args[1])} : {ref(args[2])}"
        elif op == "neg":
            rhs = f"-{ref(args[0])}"
        else:
            rhs = f"uf::{op}({ref(args[0])})"
        lines.append(f"const T v{i} = {rhs};")
    if tr.d == 0:
        lines.append(f"return {_out(tr.outputs[0])};")
    else:
        for k, x in enumerate(tr.outputs):
            lines.append(f"out[{k}] = {_out(x)};")
    return "\n".join(lines)


def _out(x) -> str:
    if x is None:
        return "T(0.0f)"
    return f"v{x}" if isinstance(x, int) else f"T({_literal(x)})"


def struct_name(tr: Trace) -> str:
    return f"UserFn_{tr.key}"


def cuda_struct(tr: Trace) -> str:
    """Emitter (a): ``struct UserFn_<key>`` whose ``eval`` is templated on
    the scalar type (``float`` or ``Dual<float>``); vector traces write
    their d (or d·d) results to ``out``, and a Jacobian's struct gives
    ``nonzero(m, i)``, false at its literal zeros."""
    body = "\n    ".join(_body(tr).splitlines())
    name = struct_name(tr)
    if tr.d == 0:
        sig = "static T eval(const T& u, const T& t)"
    else:
        sig = "static void eval(const T* u, const T& t, T* out)"
    extra = ""
    if tr.d and len(tr.outputs) == tr.d * tr.d:
        live = [k for k, x in enumerate(tr.outputs) if x is not None]
        test = " || ".join(f"k == {k}" for k in live) or "false"
        extra = (f"  __host__ __device__ static constexpr bool nonzero(int m, int i) {{\n"
                 f"    return nonzero_at(m * {tr.d} + i);\n  }}\n"
                 f"  __host__ __device__ static constexpr bool nonzero_at(int k) {{\n"
                 f"    return {test};\n  }}\n")
    return (f"// {tr.name}\nstruct {name} {{\n{extra}  template <class T>\n"
            f"  __host__ __device__ {sig} {{\n    {body}\n  }}\n}};\n")


# ------------------------------------------------- what one kernel runs

# the registry functors of csrc/odes.cuh by kernel_id (scalar ODEs; goals)
_ODE_STRUCTS = {0: "OdeLinear", 1: "OdeSin<{trig}>", 2: "OdeCos2Pi", 3: "Ode10Cos",
                4: "OdeTSin", 5: "OdeGaussMix"}
_GOAL_STRUCTS = {0: "GoalIntU", 1: "GoalIntU2"}


class KernelFunctors(NamedTuple):
    """What one kernel runs: ``ode`` the callables its plain version calls
    (``f``, ``f_u``; for a vector ODE ``f`` on (…, d) states and ``f_u`` its
    (…, d, d) Jacobian), ``g_u`` the goal's (``None``: J = ∫u), the ids its
    C entry point takes, and ``header`` the generated header of its user
    library (``None``: the registry library). ``library()`` loads (and at
    first use builds) that library."""

    ode: odes.ODEProblem
    g_u: Callable | None
    ode_id: int
    gu_id: int
    header: str | None
    sources: tuple
    d: int = 0
    nnz: int = 0  # a vector ODE's live Jacobian entries (nonzero(m, i))

    def library(self):
        from adjoint_ode_adaptivity_tpu_torch.ops.cuda import load_library, load_user_library

        if self.header is None:
            return load_library()
        return load_user_library(self.sources, self.header)


def _resolve_ode(ode, f, f_u):
    """(registry ODEProblem or None, f, f_u, bare) from the two spellings;
    ``bare``: f is a caller's callable (not an ODEProblem's)."""
    if ode is not None and f is not None:
        raise ValueError("pass the ODE as ode= or as f= (with f_u=), not both")
    if ode is None:
        if f is None:
            raise ValueError("no ODE: pass ode= (a registry entry, its name or an ODEProblem) "
                             "or an elementwise callable f=")
        ode = f
    if isinstance(ode, str):
        ode = odes.get_ode(ode)
    if not isinstance(ode, odes.ODEProblem):
        if not callable(ode):
            raise ValueError(f"ode={ode!r} is neither an ODEProblem, a registry name nor a "
                             "callable")
        return None, ode, f_u, True
    if f_u is not None:
        raise ValueError("f_u= goes with a callable f, not with an ODEProblem (its own f_u)")
    if ode.kernel_id is not None:
        return ode, ode.f, ode.f_u, False
    return None, ode.f, ode.f_u, False


_ALIASES = {"AOA_USER_ODE": "UserOde", "AOA_USER_ODE_VEC": "UserOdeVec",
            "AOA_USER_GOAL": "UserGoal"}


def _header(defines: dict, traces) -> str:
    """``aoa_user_functors.cuh``: the traced structs, then an alias and its
    macro for each functor the library's switches take (csrc/odes.cuh
    includes it inside namespace aoa)."""
    structs = "\n".join({struct_name(tr): cuda_struct(tr) for tr in traces}.values())
    aliases = "".join(f"using {_ALIASES[k]} = {v};\n#define {k} {_ALIASES[k]}\n"
                      for k, v in defines.items())
    return (f"// Generated by ops/cuda/functor.py: the traced functors of one user library.\n"
            f"{structs}\n{aliases}")


def scalar_functors(ode=None, f=None, f_u=None, g_u=None, *, source: str, trig: str = "libm",
                    goal: bool = True, need_f_u: bool = False) -> KernelFunctors:
    """Resolve a scalar kernel's ODE and goal: ``ode`` a registry entry,
    its name, an ``ODEProblem`` (traced where it has no ``kernel_id``) or a
    callable, or ``f`` (with ``f_u``; ``need_f_u`` refuses a missing one,
    as JAX's FD kernels do, else it is derived); ``g_u`` as
    :func:`functionals.kernel_goal` takes it (``goal`` False: a kernel
    without one). A registry ODE and goal run on the registry library; any
    traced callable puts both on a user library built from ``source``
    (csrc file name) and the generated header."""
    reg, f, f_u, bare = _resolve_ode(ode, f, f_u)
    if reg is not None and reg.kernel_id not in _ODE_STRUCTS:
        raise ValueError(f"ODE {reg.name!r}: this kernel takes a scalar ODE")
    fn = functionals.kernel_goal(g_u) if goal else functionals.kernel_goal(None)
    if reg is not None and fn.kernel_id is not None:
        return KernelFunctors(reg, None if fn.kernel_id == 0 else fn.g_u, reg.kernel_id,
                              fn.kernel_id, None, (source,))
    traces, defines = [], {}
    if reg is not None:
        plain = reg
        defines["AOA_USER_ODE"] = _ODE_STRUCTS[reg.kernel_id].format(
            trig="FastTrig" if trig == "fast" else "Libm")
    else:
        if trig != "libm":
            raise ValueError("trig='fast' is implemented for du/dt=sin(u) only")
        if need_f_u and bare and f_u is None:
            raise ValueError("f_u is required with a callable f (as JAX's FD kernels take it)")
        t_f = trace(f)
        t_fu = None if f_u is None else trace(f_u)
        traces += [t_f] + ([t_fu] if t_fu else [])
        plain = odes.ODEProblem(name=f"traced {t_f.name}", f=_elementwise(f),
                                f_u=_elementwise(f_u) if t_fu else torch_jvp(t_f),
                                kernel_id=None)
        defines["AOA_USER_ODE"] = (f"OdeTraced<{struct_name(t_f)}"
                                   + (f", {struct_name(t_fu)}>" if t_fu else ">"))
    plain_gu = None
    if goal:
        if fn.kernel_id is not None:
            defines["AOA_USER_GOAL"] = _GOAL_STRUCTS[fn.kernel_id]
            plain_gu = None if fn.kernel_id == 0 else fn.g_u
        else:
            t_g = trace(fn.g_u)
            traces.append(t_g)
            defines["AOA_USER_GOAL"] = f"GoalTraced<{struct_name(t_g)}>"
            plain_gu = _elementwise(fn.g_u)
    return KernelFunctors(plain, plain_gu, USER_KERNEL_ID, USER_KERNEL_ID,
                          _header(defines, traces), (source,))


def vector_functors(ode=None, f_comps=None, jac_comps=None, d=None, *,
                    source: str) -> KernelFunctors:
    """Resolve F2's vector ODE: a registry entry (its name) with a vector
    ``kernel_id``, or ``f_comps(us, t) -> d-tuple`` and ``jac_comps(us, t)
    -> d×d nested tuple`` (literal zeros skipped) traced for 2 ≤ d ≤
    :data:`MAX_VECTOR_D` components (a larger d raises a ValueError naming
    the limit)."""
    if ode is not None:
        if f_comps is not None or jac_comps is not None:
            raise ValueError("pass the ODE as ode= or as (f_comps, jac_comps, d), not both")
        reg = odes.get_ode(ode) if isinstance(ode, str) else ode
        if getattr(reg, "kernel_id", None) not in VECTOR_KERNEL_IDS:
            raise ValueError(f"ODE {getattr(reg, 'name', reg)!r}: this entry point takes a "
                             "vector registry ODE, or (f_comps, jac_comps, d)")
        return KernelFunctors(reg, None, reg.kernel_id, 0, None, (source,),
                              *VECTOR_KERNEL_IDS[reg.kernel_id])
    if f_comps is None or jac_comps is None or d is None:
        raise ValueError("a vector ODE needs f_comps, jac_comps and d")
    d = int(d)
    if d < 2:
        raise ValueError(f"d={d}: the vector kernel takes d >= 2 (scalar states go to F1)")
    if d > MAX_VECTOR_D:
        raise ValueError(f"d={d}: the vector kernel takes at most d={MAX_VECTOR_D} components "
                         f"(MAX_VECTOR_D, JAX's own cap)")
    t_f, t_j = trace(f_comps, d), trace(jac_comps, d, jacobian=True)

    def f(u, t):  # (…, d) states: the d results stacked
        like = u[..., 0]
        out = f_comps(tuple(u[..., c] for c in range(d)), _as_input(t, like))
        return torch.stack([_as_output(x, like) for x in out], dim=-1)

    def jac(u, t):  # (…, d, d): [m][i] = ∂f_m/∂u_i, literal zeros as zeros
        like = u[..., 0]
        rows = jac_comps(tuple(u[..., c] for c in range(d)), _as_input(t, like))
        return torch.stack([torch.stack([_as_output(x, like) for x in r], dim=-1)
                            for r in rows], dim=-2)

    plain = odes.ODEProblem(name=f"traced {t_f.name}", f=f, f_u=jac, kernel_id=None)
    defines = {"AOA_USER_ODE_VEC": f"OdeTracedVec<{d}, {struct_name(t_f)}, {struct_name(t_j)}>"}
    return KernelFunctors(plain, None, USER_KERNEL_ID, 0, _header(defines, [t_f, t_j]),
                          (source,), d, sum(x is not None for x in t_j.outputs))
