"""The port's DG-in-time slab march, adjoint march, AWR, reconstruction and
functional (march/dg_time.py, adjoint/dg_time.py) against the JAX package,
float64 on the CPU.

Tolerance: both packages run the same float64 operations in another order
(batched element assembly here, vmapped closures there; LAPACK solves on
both sides), so values agree to a few ulp of their O(1) scale — held to
1e-12. The linear effectivity identity is the JAX package's own check
(tests/test_dg_time.py:76, 1e-10)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adjoint_ode_adaptivity_tpu.adjoint import dg_time as jadj
from adjoint_ode_adaptivity_tpu.march import dg_time as jmarch
from adjoint_ode_adaptivity_tpu_torch import odes
from adjoint_ode_adaptivity_tpu_torch.adjoint import dg_time as tadj
from adjoint_ode_adaptivity_tpu_torch.march import dg_time as tmarch

torch.set_num_threads(1)  # one intra-op thread a process: the suite runs in xdist workers

F64 = torch.float64
ATOL = 1e-12
# graded partition over [0, 2]
TIMES = np.array([0.0, 0.15, 0.4, 0.8, 1.3, 1.65, 2.0])
JAX_F = {"du/dt=sin(u)": lambda u, t: jnp.sin(u), "du/dt=t*sin(u)": lambda u, t: t * jnp.sin(u)}


def t64(x):
    return torch.tensor(np.asarray(x), dtype=F64)


def close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=atol)


@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_operators_are_bit_equal(n):
    ours, ref = tmarch.dg_time_operators(n), jmarch.dg_time_operators(n)
    assert ours._fields == ref._fields
    for name, a, b in zip(ref._fields, ours, ref):
        assert np.array_equal(np.asarray(a), np.asarray(b)), name


@pytest.mark.parametrize("name", sorted(JAX_F))
def test_march_adjoint_and_estimates_match_jax(name):
    ode, fj = odes.get_ode(name), JAX_F[name]
    tj = jnp.asarray(TIMES)
    for n in (1, 2):
        ops_p, ops_a = tmarch.dg_time_operators(n), tmarch.dg_time_operators(n + 1)
        jp, ja = jmarch.dg_time_operators(n), jmarch.dg_time_operators(n + 1)
        ref = jmarch.dg_march(jp, fj, tj, 1.0)
        fwd = tmarch.dg_march(ops_p, ode.f, t64(TIMES), 1.0, f_u=ode.f_u)
        close(fwd.u, ref.u)
        close(fwd.t, ref.t)
        np.testing.assert_array_equal(fwd.newton_iters.numpy(), np.asarray(ref.newton_iters))
        assert float(fwd.newton_resnorm.max()) < 1e-10

        adj_j = jadj.dg_adjoint_march(ja, fj, ref.u, tj, 1.0)
        adj = tadj.dg_adjoint_march(ops_a, ode.f, fwd.u, t64(TIMES), 1.0, f_u=ode.f_u)
        close(adj.v, adj_j.v)
        close(adj.t, adj_j.t)
        close(adj.err, adj_j.err)
        close(tadj.dg_element_functional(ops_p, fwd.u, t64(TIMES)),
              jadj.dg_element_functional(jp, ref.u, tj))

        # reconstruction path: order-n adjoint lifted through Radau points
        low_j = jadj.dg_adjoint_march(jp, fj, ref.u, tj, 1.0)
        low = tadj.dg_adjoint_march(ops_p, ode.f, fwd.u, t64(TIMES), 1.0, f_u=ode.f_u)
        rec_j = jadj.dg_adjoint_reconstruct(jp, low_j.v, tj)
        rec = tadj.dg_adjoint_reconstruct(ops_p, low.v, t64(TIMES))
        close(rec, rec_j)
        close(tadj.dg_awr_from_adjoint(ops_a, ode.f, fwd.u, t64(TIMES), 1.0, rec),
              jadj.dg_awr_from_adjoint(ja, fj, ref.u, tj, 1.0, rec_j))
        for jumps in ("all", "first"):
            close(tadj.continuous_err_contribution(ops_p, fwd.u, t64(TIMES),
                                                   lambda t: torch.exp(1.0 - t), ode.f, 1.0,
                                                   jumps),
                  jadj.continuous_err_contribution(jp, ref.u, tj, lambda t: jnp.exp(1.0 - t),
                                                   fj, 1.0, jumps))


def test_linear_effectivity_identity():
    """Σ err_k == J(u_h at order n+1) − J(u_H) to roundoff for a linear ODE
    and J = ∫u (the %.10e parity of MAIN.m:55-76)."""
    lin = odes.get_ode("du/dt=u")
    for n, k in [(1, 2), (1, 4), (2, 4), (2, 8)]:
        times = torch.linspace(0.0, 1.0, k + 1, dtype=F64)
        ops_p, ops_a = tmarch.dg_time_operators(n), tmarch.dg_time_operators(n + 1)
        res_p = tmarch.dg_march(ops_p, lin.f, times, 1.0, f_u=lin.f_u)
        res_a = tmarch.dg_march(ops_a, lin.f, times, 1.0, f_u=lin.f_u)
        adj = tadj.dg_adjoint_march(ops_a, lin.f, res_p.u, times, 1.0, f_u=lin.f_u)
        gap = float(tadj.dg_element_functional(ops_a, res_a.u, times)
                    - tadj.dg_element_functional(ops_p, res_p.u, times))
        est = float(torch.sum(adj.err))
        assert abs(est - gap) < 1e-10 * max(1.0, abs(gap)), (n, k, est, gap)


def test_jacobian_and_derived_f_u():
    """The assembled slab Jacobian equals forward-mode AD of the residual
    (matlab/test_jacobian.m's check), and f_u=None derives the registry's
    closed form."""
    sin = odes.get_ode("du/dt=sin(u)")
    ops = tmarch.dg_time_operators(2, 8)
    rng = np.random.default_rng(0)
    for _ in range(3):
        u = t64(rng.uniform(size=ops.np_))
        jac = tmarch._slab_jacobian(ops, sin.f_u, u, 0.3, 0.1, F64)
        jac_ad = torch.func.jacfwd(
            lambda uu: tmarch._slab_residual(ops, sin.f, uu, 1.0, 0.3, 0.1, F64))(u)
        close(jac, jac_ad, atol=1e-13)
    u = t64(rng.uniform(-3, 3, 17))
    close(tmarch.elementwise_f_u(sin.f)(u, 0.0), sin.f_u(u, 0.0), atol=0)
    a = tmarch.dg_march(ops, sin.f, t64(TIMES), 1.0)
    b = tmarch.dg_march(ops, sin.f, t64(TIMES), 1.0, f_u=sin.f_u)
    assert torch.equal(a.u, b.u)
