"""The port's implicit-function-theorem DG-in-time marches
(march/dg_time.py ``dg_march_differentiable``, march/dg_batched.py
``dg_march_batched_differentiable``, march/dg_mixed.py
``dg_march_mixed_differentiable``) against the JAX package's ``custom_vjp``
marches, float64 on the CPU, on the JAX tests' own shapes
(tests/test_dg_time.py ``TestDifferentiableDGMarch``, tests/test_dg_batched.py
``TestBatchedIFT``, tests/test_dg_mixed.py ``TestMixedDifferentiable`` and
``TestTrainThroughHPSolver``, tests/test_neural_dg.py
``TestTrainThroughImplicitSolver``).

Tolerances: the same float64 operations in another order (torch's matmuls
and solves against XLA's), so values agree to a few ulp of their O(1)
scale: 1e-13 (batched, a fixed Newton count) and 1e-12 (single and mixed,
Newton to tolerance). Every gradient: 1e-12 relative to its scale
(``close``). The teeth checks patch the port's backward (J in place of Jᵀ;
the parameters' term dropped) and require that the same comparisons fail.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from adjoint_ode_adaptivity_tpu.march import dg_batched as jb
from adjoint_ode_adaptivity_tpu.march import dg_mixed as jm
from adjoint_ode_adaptivity_tpu.march import dg_time as jt
from adjoint_ode_adaptivity_tpu_torch import train
from adjoint_ode_adaptivity_tpu_torch.march import dg_batched as tb
from adjoint_ode_adaptivity_tpu_torch.march import dg_mixed as tm
from adjoint_ode_adaptivity_tpu_torch.march import dg_time as tt
from adjoint_ode_adaptivity_tpu_torch.tree import tree_map

torch.set_num_threads(1)  # one intra-op thread a process: the suite runs in xdist workers

F64 = torch.float64
GRAD_TOL = 1e-12

# TestDifferentiableDGMarch's shapes
SINGLE_TIMES = np.array([0.0, 0.4, 0.9, 1.3, 2.0])
# TestBatchedIFT's
BATCH_TIMES = np.linspace(0.0, 2.0, 9)
BATCH_Y0S = np.array([1.0, 0.5, 2.0])
THETA = 1.3
# TestMixedDifferentiable's
MIXED_TIMES = np.linspace(0.0, 2.0, 7)
MIXED_NS = np.array([1, 3, 2, 4, 1, 2], np.int32)
N_MAX = 4


def t64(x):
    return torch.tensor(np.asarray(x), dtype=F64)


def close(got, want, tol=GRAD_TOL):
    """|got − want| ≤ tol·max(1, |want|) entrywise (raises AssertionError)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(1.0, float(np.max(np.abs(want))))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


def grads_of(fn, *args):
    """Autograd gradients of the scalar ``fn(*args)`` with respect to every
    argument (tensors, or dicts of tensors), as numpy."""
    leaves = [tree_map(lambda x: t64(x).requires_grad_(True), a) for a in args]
    flat = [x for a in leaves for x in (a.values() if isinstance(a, dict) else [a])]
    gs = iter(torch.autograd.grad(fn(*leaves), flat))
    return [{k: next(gs).numpy() for k in a} if isinstance(a, dict) else next(gs).numpy()
            for a in leaves]


# ------------------------------------------------------------------ single
F_SIN_P = (lambda u, t, p: jnp.sin(u), lambda u, t, p: torch.sin(u))
F_AB = (lambda u, t, p: p["a"] * jnp.sin(u) + p["b"] * jnp.cos(t),
        lambda u, t, p: p["a"] * torch.sin(u) + p["b"] * torch.cos(t))
F_TIME = (lambda u, t, p: jnp.sin(u) * (1 + 0.2 * t), lambda u, t, p: torch.sin(u) * (1 + 0.2 * t))
AB = {"a": 1.0, "b": 0.3}


def single_j(mod, f, ops, times, y0, params):
    u = mod.dg_march_differentiable(ops, f, times, y0, params)
    return (u[-1] ** 2).sum()


@pytest.fixture(scope="module")
def single_ref():
    """The JAX march's values and its gradients in each of TestDifferentiableDGMarch's
    three cases."""
    ops = jt.dg_time_operators(2)
    times = jnp.asarray(SINGLE_TIMES)
    values = np.asarray(jt.dg_march_differentiable(ops, F_SIN_P[0], times, 1.0))
    g_y0 = float(jax.grad(lambda y: jt.dg_march_differentiable(ops, F_SIN_P[0], times, y)[-1, -1])(
        1.0))
    g_ab, g_t = jax.grad(lambda p, ts: single_j(jt, F_AB[0], ops, ts, 1.0, p), argnums=(0, 1))(
        {k: jnp.asarray(v) for k, v in AB.items()}, times)
    g_time = jax.grad(lambda ts: jt.dg_march_differentiable(ops, F_TIME[0], ts, 1.0)[-1, -1])(times)
    return dict(values=values, y0=g_y0, ab={k: float(v) for k, v in g_ab.items()},
                ab_times=np.asarray(g_t), times=np.asarray(g_time))


def single_port():
    ops = tt.dg_time_operators(2)
    times = t64(SINGLE_TIMES)
    (g_y0,) = grads_of(lambda y: tt.dg_march_differentiable(ops, F_SIN_P[1], times, y)[-1, -1],
                       1.0)
    g_ab, g_t = grads_of(lambda p, ts: single_j(tt, F_AB[1], ops, ts, 1.0, p), AB, SINGLE_TIMES)
    (g_time,) = grads_of(
        lambda ts: tt.dg_march_differentiable(ops, F_TIME[1], ts, 1.0)[-1, -1], SINGLE_TIMES)
    return dict(y0=g_y0, ab=g_ab, ab_times=g_t, times=g_time)


def check_single(ref):
    got = single_port()
    close(got["y0"], ref["y0"])
    for k in AB:
        close(got["ab"][k], ref["ab"][k])
    close(got["ab_times"], ref["ab_times"])
    close(got["times"], ref["times"])


def test_single_values_match_jax_and_dg_march(single_ref):
    ops = tt.dg_time_operators(2)
    times = t64(SINGLE_TIMES)
    u = tt.dg_march_differentiable(ops, F_SIN_P[1], times, 1.0)
    np.testing.assert_allclose(u.numpy(), single_ref["values"], rtol=0, atol=1e-12)
    plain = tt.dg_march(ops, lambda uu, t: torch.sin(uu), times, 1.0).u
    np.testing.assert_allclose(u.numpy(), plain.numpy(), rtol=0, atol=1e-12)


def test_single_gradients_match_jax(single_ref):
    check_single(single_ref)


def test_single_gradient_matches_central_difference():
    """TestDifferentiableDGMarch's own check: ∂u_T/∂y0 against a central
    difference (rtol 1e-6, the difference's truncation)."""
    ops = tt.dg_time_operators(2)
    times = t64(SINGLE_TIMES)

    def j(y0):
        return tt.dg_march_differentiable(ops, F_SIN_P[1], times, y0)[-1, -1]

    (g,) = grads_of(j, 1.0)
    eps = 1e-6
    fd = (float(j(1.0 + eps)) - float(j(1.0 - eps))) / (2 * eps)
    np.testing.assert_allclose(g, fd, rtol=1e-6)


def test_python_float_params_and_none():
    """A Python float becomes a 0-d tensor of the march's dtype; None passes
    through to ``f``."""
    ops = tt.dg_time_operators(1)
    times = t64(SINGLE_TIMES)
    seen = []

    def f(u, t, p):
        seen.append(p)
        return torch.sin(u) * (1.0 if p is None else p)

    a = tt.dg_march_differentiable(ops, f, times, 1.0, 1.0)
    b = tt.dg_march_differentiable(ops, f, times, 1.0)
    assert isinstance(seen[0], torch.Tensor) and seen[0].dtype == F64 and seen[0].dim() == 0
    assert seen[-1] is None
    assert torch.equal(a, b)


# ----------------------------------------------------------------- batched
F_PU = (lambda u, t, p: jnp.sin(p * u), lambda u, t, p: torch.sin(p * u))


@pytest.fixture(scope="module")
def batch_ref():
    ops = jt.dg_time_operators(1)
    times, y0s = jnp.asarray(BATCH_TIMES), jnp.asarray(BATCH_Y0S)
    per_times = jnp.asarray(np.stack([BATCH_TIMES * s for s in (1.0, 0.9, 1.1)]))

    def j(p, y, ts):
        return jnp.sum(jb.dg_march_batched_differentiable(ops, F_PU[0], ts, y, p)[:, -1, -1])

    g_p, g_y, g_t = jax.grad(j, argnums=(0, 1, 2))(THETA, y0s, per_times)
    return dict(values=np.asarray(jb.dg_march_batched_differentiable(ops, F_PU[0], times, y0s,
                                                                     THETA)),
                p=float(g_p), y0=np.asarray(g_y), times=np.asarray(g_t), per_times=per_times)


def batch_port(per_times):
    ops = tt.dg_time_operators(1)

    def j(p, y, ts):
        return tb.dg_march_batched_differentiable(ops, F_PU[1], ts, y, p)[:, -1, -1].sum()

    g_p, g_y, g_t = grads_of(j, THETA, BATCH_Y0S, np.asarray(per_times))
    return dict(p=g_p, y0=g_y, times=g_t)


def check_batch(ref):
    got = batch_port(ref["per_times"])
    for k in ("p", "y0", "times"):
        close(got[k], ref[k])


def test_batched_values_match_jax_and_single_runs(batch_ref):
    ops = tt.dg_time_operators(1)
    u = tb.dg_march_batched_differentiable(ops, F_PU[1], t64(BATCH_TIMES), t64(BATCH_Y0S), THETA)
    assert u.shape == (3, 8, 2) and u.dtype == F64
    np.testing.assert_allclose(u.numpy(), batch_ref["values"], rtol=0, atol=1e-13)
    for i, y0 in enumerate(BATCH_Y0S):
        u1 = tt.dg_march_differentiable(ops, F_PU[1], t64(BATCH_TIMES), y0, THETA)
        np.testing.assert_allclose(u[i].numpy(), u1.numpy(), rtol=0, atol=1e-13)


def test_batched_gradients_match_jax(batch_ref):
    check_batch(batch_ref)


def test_batched_param_gradient_is_sum_of_single_runs():
    ops = tt.dg_time_operators(1)
    times = t64(BATCH_TIMES)
    (g_b,) = grads_of(
        lambda p: tb.dg_march_batched_differentiable(ops, F_PU[1], times, t64(BATCH_Y0S), p)[
            :, -1, -1].sum(), THETA)
    g_1 = sum(grads_of(lambda p: tt.dg_march_differentiable(ops, F_PU[1], times, y0, p)[-1, -1],
                       THETA)[0] for y0 in BATCH_Y0S)
    assert abs(float(g_b) - float(g_1)) < 1e-12, (g_b, g_1)


def mlp(u, t, p, xp):
    """Elementwise tanh MLP u -> tanh(u·w1 + b1)·w2 (TestBatchedIFT's)."""
    h = xp.tanh(u[..., None] * p["w1"][0] + p["b1"])
    return (h @ p["w2"])[..., 0]


def test_batched_mlp_training_matches_jax_step_for_step():
    """TestBatchedIFT's neural right-hand side trained through the batched
    solver (B = 16, width 8, SGD lr 0.5), four steps: each step's loss and
    the parameters after it within 1e-12 (its loss first rises at this
    rate; JAX's test takes 25 steps to bring it down)."""
    rng = np.random.default_rng(0)
    init = {"w1": rng.normal(size=(1, 8)) * 0.5, "b1": np.zeros(8),
            "w2": rng.normal(size=(8, 1)) * 0.5}
    y0s = rng.uniform(0.5, 1.5, 16)
    jops, tops = jt.dg_time_operators(1), tt.dg_time_operators(1)
    times = np.linspace(0.0, 1.0, 5)
    target = jb.dg_march_batched_differentiable(jops, lambda u, t, p: jnp.sin(u), times, y0s)[
        :, -1, -1]

    @jax.jit
    def j_step(p):
        def loss(q):
            u = jb.dg_march_batched_differentiable(
                jops, lambda uu, tt_, qq: mlp(uu, tt_, qq, jnp), times, y0s, q)
            return jnp.mean((u[:, -1, -1] - target) ** 2)

        val, g = jax.value_and_grad(loss)(p)
        return val, jax.tree_util.tree_map(lambda a, b: a - 0.5 * b, p, g)

    t_target = t64(target)

    def t_loss(q):
        u = tb.dg_march_batched_differentiable(tops, lambda uu, tt_, qq: mlp(uu, tt_, qq, torch),
                                               t64(times), t64(y0s), q)
        return torch.mean((u[:, -1, -1] - t_target) ** 2)

    jp = {k: jnp.asarray(v) for k, v in init.items()}
    tp = {k: t64(v) for k, v in init.items()}
    losses = []
    for _ in range(4):
        j_val, jp = j_step(jp)
        t_val, g = train.value_and_grad(t_loss, tp)
        tp = {k: tp[k] - 0.5 * g[k] for k in tp}
        close(float(t_val), float(j_val))
        for k in tp:
            close(tp[k].numpy(), np.asarray(jp[k]))
        losses.append(float(t_val))
    assert np.all(np.isfinite(losses))


# ------------------------------------------------------------------- mixed
F3 = (lambda u, t, p: jnp.sin(u) * p, lambda u, t, p: torch.sin(u) * p)


@pytest.fixture(scope="module")
def mixed_ref():
    mops = jm.dg_time_operators_mixed(N_MAX)
    times, ns = jnp.asarray(MIXED_TIMES), jnp.asarray(MIXED_NS)
    values = np.asarray(jm.dg_march_mixed_differentiable(mops, F3[0], times, ns, 1.0, THETA))

    def j(y0, p, ts):
        u = jm.dg_march_mixed_differentiable(mops, F3[0], ts, ns, y0, p, newton_tol=1e-13)
        return jnp.sum(u[:, 0]) + jnp.sum(u[-1])

    g = jax.grad(j, argnums=(0, 1, 2))(1.0, THETA, times)
    return dict(values=values, grads=[np.asarray(x) for x in g])


def check_mixed(ref):
    mops = tm.dg_time_operators_mixed(N_MAX)

    def j(y0, p, ts):
        u = tm.dg_march_mixed_differentiable(mops, F3[1], ts, MIXED_NS, y0, p, newton_tol=1e-13)
        return u[:, 0].sum() + u[-1].sum()

    got = grads_of(j, 1.0, THETA, MIXED_TIMES)
    for a, b in zip(got, ref["grads"]):
        close(a, b)


def test_mixed_values_match_jax_and_dg_march_mixed(mixed_ref):
    mops = tm.dg_time_operators_mixed(N_MAX)
    times = t64(MIXED_TIMES)
    u = tm.dg_march_mixed_differentiable(mops, F3[1], times, MIXED_NS, 1.0, THETA)
    assert u.shape == (6, N_MAX + 1)
    np.testing.assert_allclose(u.numpy(), mixed_ref["values"], rtol=0, atol=1e-12)
    plain = tm.dg_march_mixed(mops, lambda uu, t: torch.sin(uu) * THETA, times[None],
                              torch.as_tensor(MIXED_NS)[None], t64([1.0])).u[0]
    np.testing.assert_allclose(u.numpy(), plain.numpy(), rtol=0, atol=1e-12)


def test_mixed_gradients_match_jax(mixed_ref):
    check_mixed(mixed_ref)


def test_mixed_uniform_orders_match_single_ift():
    """TestMixedDifferentiable's check: at uniform order 2 on the stack's
    Gauss rule the mixed march's gradients are the single march's."""
    mops = tm.dg_time_operators_mixed(N_MAX)
    ops2 = tt.dg_time_operators(2, n_gq=3 * N_MAX + 6)
    ns = np.full(6, 2)

    def j_uni(y0, p, ts):
        return tt.dg_march_differentiable(ops2, F3[1], ts, y0, p, newton_tol=1e-13)[-1].sum()

    def j_mix(y0, p, ts):
        return tm.dg_march_mixed_differentiable(mops, F3[1], ts, ns, y0, p,
                                                newton_tol=1e-13)[-1, :3].sum()

    for a, b in zip(grads_of(j_uni, 1.0, THETA, MIXED_TIMES),
                    grads_of(j_mix, 1.0, THETA, MIXED_TIMES)):
        close(a, b)


def test_mixed_order_out_of_range_raises():
    mops = tm.dg_time_operators_mixed(2)
    with pytest.raises(ValueError):
        tm.dg_march_mixed_differentiable(mops, F3[1], t64(MIXED_TIMES), [1, 3, 1, 1, 1, 1], 1.0,
                                         THETA)


def adam_steps(j_loss, t_loss, init, lr, steps):
    """``steps`` Adam steps of the JAX loss (optax) and the port's loss
    (train.Adam) from the same numpy draws: each step's loss and the
    parameters after it within 1e-12. Returns the port's losses."""
    tx = optax.adam(lr)
    jp = {k: jnp.asarray(v) for k, v in init.items()}
    opt = tx.init(jp)

    @jax.jit
    def j_step(p, o):
        val, g = jax.value_and_grad(j_loss)(p)
        upd, o = tx.update(g, o)
        return val, optax.apply_updates(p, upd), o

    ttx = train.Adam(lr)
    tp = {k: t64(v) for k, v in init.items()}
    state = ttx.init(tp)
    losses = []
    for _ in range(steps):
        j_val, jp, opt = j_step(jp, opt)
        t_val, g = train.value_and_grad(t_loss, tp)
        tp, state = ttx.update(g, state, tp)
        close(float(t_val), float(j_val))
        for k in tp:
            close(tp[k].numpy(), np.asarray(jp[k]))
        losses.append(float(t_val))
    return losses


def test_mixed_neural_rhs_trains_like_jax():
    """TestTrainThroughHPSolver's tanh network (width 8) through the
    mixed-order solver on its hp partition, three Adam steps (lr 5e-2)."""
    rng = np.random.default_rng(3)
    init = {"w1": 0.5 * rng.normal(size=8), "b1": np.zeros(8), "w2": 0.1 * rng.normal(size=8)}
    times = np.array([0.0, 0.25, 0.5, 1.0, 2.0])
    ns = np.array([3, 3, 2, 1], np.int32)
    target = 2.0

    def net(xp):
        def f(u, t, p):
            h = xp.tanh(u[..., None] * p["w1"] + p["b1"])
            return h @ p["w2"]
        return f

    jmops, tmops = jm.dg_time_operators_mixed(5), tm.dg_time_operators_mixed(5)

    def j_loss(p):
        u = jm.dg_march_mixed_differentiable(jmops, net(jnp), jnp.asarray(times), ns, 1.0, p,
                                             newton_tol=1e-11)
        return (u[-1, 1] - target) ** 2

    def t_loss(p):
        u = tm.dg_march_mixed_differentiable(tmops, net(torch), t64(times), ns, 1.0, p,
                                             newton_tol=1e-11)
        return (u[-1, 1] - target) ** 2

    losses = adam_steps(j_loss, t_loss, init, 5e-2, 3)
    assert losses[-1] < losses[0]


def test_single_neural_rhs_trains_like_jax():
    """TestTrainThroughImplicitSolver's scalar network through the single
    march (order 2, 4 slabs of [0, 1]), three Adam steps (lr 5e-2)."""
    init = {"w1": 0.5, "b1": 0.1, "w2": 0.5, "b2": 0.0}
    times = np.linspace(0.0, 1.0, 5)
    truth = 1.7

    def net(xp):
        return lambda u, t, p: p["w2"] * xp.tanh(p["w1"] * u + p["b1"]) + p["b2"]

    jops, tops = jt.dg_time_operators(2), tt.dg_time_operators(2)

    def j_loss(p):
        return (jt.dg_march_differentiable(jops, net(jnp), jnp.asarray(times), 1.0, p)[-1, -1]
                - truth) ** 2

    def t_loss(p):
        return (tt.dg_march_differentiable(tops, net(torch), t64(times), 1.0, p)[-1, -1]
                - truth) ** 2

    losses = adam_steps(j_loss, t_loss, init, 5e-2, 3)
    assert losses[-1] < losses[0]


# ------------------------------------------------------------------- teeth
def _solve_with_j(mod):
    """The backward's solve with J in place of Jᵀ."""
    if mod is tb:
        return lambda jac, g: tb.solve_small(jac, g)
    if mod is tm:
        return lambda jac, g: tm.gauss_solve(jac, g)
    return lambda jac, g: torch.linalg.solve(jac, g)


def _drop_params(vjp):
    """The residual VJP with the parameters' cotangents set to zero."""
    def bad(residual, primals, cot):
        bars = vjp(residual, primals, cot)
        return bars[:3] + tuple(None if b is None else torch.zeros_like(b) for b in bars[3:])
    return bad


@pytest.mark.parametrize("mutation", ["transpose", "params"])
@pytest.mark.parametrize("case", ["single", "batched", "mixed"])
def test_wrong_backward_fails_the_comparisons(case, mutation, monkeypatch, single_ref, batch_ref,
                                              mixed_ref):
    mod, check, ref = {"single": (tt, check_single, single_ref),
                       "batched": (tb, check_batch, batch_ref),
                       "mixed": (tm, check_mixed, mixed_ref)}[case]
    check(ref)  # the real backward passes
    if mutation == "transpose":
        monkeypatch.setattr(mod, "_ift_solve", _solve_with_j(mod))
    else:
        monkeypatch.setattr(mod, "_residual_vjp", _drop_params(mod._residual_vjp))
    with pytest.raises(AssertionError):
        check(ref)
