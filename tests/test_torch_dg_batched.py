"""The port's batched DG-in-time pipeline (march/dg_batched.py) against the
JAX package, float64 on the CPU: the closed-form small solves, both Newton
modes on shared and per-member partitions, the Newton counts, and the
zero-width padding contract.

Tolerance: the same float64 operations in another order, so values agree
to a few ulp of their O(1) scale — 1e-12; the Newton counts are equal."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adjoint_ode_adaptivity_tpu.march import dg_batched as jb
from adjoint_ode_adaptivity_tpu.march.dg_time import dg_time_operators as jops
from adjoint_ode_adaptivity_tpu_torch import odes
from adjoint_ode_adaptivity_tpu_torch.march import dg_batched as tb
from adjoint_ode_adaptivity_tpu_torch.march.dg_time import dg_time_operators

torch.set_num_threads(1)  # one intra-op thread a process: the suite runs in xdist workers

F64 = torch.float64
ATOL = 1e-12
SIN = odes.get_ode("du/dt=sin(u)")
B = 16
Y0S = np.random.default_rng(3).uniform(0.5, 2.0, B)


def t64(x):
    return torch.tensor(np.asarray(x), dtype=F64)


def per_member_times(k, seed):
    """(B, k+1) partitions of [0, 2] with random interior nodes and a
    zero-width tail slab."""
    rng = np.random.default_rng(seed)
    core = np.sort(rng.uniform(0.1, 1.9, (B, k - 2)), axis=1)
    return np.concatenate([np.zeros((B, 1)), core, np.full((B, 2), 2.0)], axis=1)


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 6, 7, 8, 9])
def test_solve_small_matches_jax(n):
    rng = np.random.default_rng(n)
    a = rng.normal(size=(n, n, 7)) + 3 * np.eye(n)[:, :, None]
    b = rng.normal(size=(n, 7))
    if n == 6:  # tests/test_dg_batched.py:41-53: the per-member pivot swaps
        a[0, 0] = 0.0
        a[1, 1, :2] = 1e-300
    want = np.asarray(jb.solve_small(jnp.asarray(a), jnp.asarray(b)))
    got = tb.solve_small(t64(a), t64(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    ref = np.stack([np.linalg.solve(a[:, :, i], b[:, i]) for i in range(7)], axis=-1)
    np.testing.assert_allclose(got, ref, atol=1e-9)
    with pytest.raises(ValueError, match="shape mismatch"):
        tb.solve_small(torch.zeros((n, n + 1, 2)), torch.zeros((n, 2)))


@pytest.mark.parametrize("newton_iters", [None, 6])
@pytest.mark.parametrize("per_member", [False, True])
def test_pipeline_and_newton_counts_match_jax(newton_iters, per_member):
    k = 6
    times = per_member_times(k, seed=11) if per_member else np.linspace(0.0, 2.0, k + 1)
    for n in (1, 4):
        ops_p, ops_a = dg_time_operators(n), dg_time_operators(n + 1)
        jp, ja = jops(n), jops(n + 1)
        f_j = lambda u, t: jnp.sin(u)  # noqa: E731
        ref = jb.dg_march_batched(jp, f_j, jnp.asarray(times), jnp.asarray(Y0S),
                                  newton_iters=newton_iters)
        fwd = tb.dg_march_batched(ops_p, SIN.f, t64(times), t64(Y0S), f_u=SIN.f_u,
                                  newton_iters=newton_iters)
        np.testing.assert_allclose(fwd.u.numpy(), np.asarray(ref.u), rtol=0, atol=ATOL)
        np.testing.assert_array_equal(fwd.newton_iters.numpy(), np.asarray(ref.newton_iters))
        np.testing.assert_allclose(fwd.newton_resnorm.numpy(), np.asarray(ref.newton_resnorm),
                                   rtol=0, atol=ATOL)
        u_j, v_j, e_j = jb.dg_estimate_batched(jp, ja, f_j, jnp.asarray(times),
                                               jnp.asarray(Y0S), newton_iters=newton_iters)
        u, v, e = tb.dg_estimate_batched(ops_p, ops_a, SIN.f, t64(times), t64(Y0S),
                                         newton_iters=newton_iters)  # f_u derived
        for got, want in ((u, u_j), (v, v_j), (e, e_j)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)
        np.testing.assert_allclose(
            tb.dg_element_functional_batched(ops_p, u, t64(times)).numpy(),
            np.asarray(jb.dg_element_functional_batched(jp, u_j, jnp.asarray(times))),
            rtol=0, atol=ATOL)


def test_zero_width_padding_contract():
    """A zero-width slab is an exact identity: u stays constant across it and
    its contribution is 0 to float64 roundoff (the loops' padding)."""
    k = 10
    times = np.concatenate([np.linspace(0.0, 2.0, 8), np.full(k + 1 - 8, 2.0)])
    ops_p, ops_a = dg_time_operators(1), dg_time_operators(2)
    for newton_iters in (None, 8):
        u, _, err = tb.dg_estimate_batched(ops_p, ops_a, SIN.f, t64(times), t64(Y0S),
                                           f_u=SIN.f_u, newton_iters=newton_iters)
        end = u[:, 6, -1]
        for kp in range(7, k):
            assert float((u[:, kp] - end[:, None]).abs().max()) <= 1e-14
            assert float(err[:, kp].abs().max()) <= 1e-14
