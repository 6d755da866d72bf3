"""The port's ``config`` facade (``Problem``, ``Funs``,
``get_problem_functions``) against the JAX package's, float64 on the CPU:
every ``Funs`` field evaluated on the same numpy draws (one seed) for two
problems, and tests/test_infra.py's consistency checks.

Tolerance: the same float64 operations in another order (torch's against
XLA's) over at most 4·8 fine steps, so every field agrees to a few ulp of
its scale: 1e-12·max(1, |JAX value|), absolute."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adjoint_ode_adaptivity_tpu import config as jcfg
from adjoint_ode_adaptivity_tpu_torch import config as tcfg

torch.set_num_threads(1)  # one intra-op thread a process: the suite runs in xdist workers

TOL = 1e-12
PROBLEMS = (
    dict(case="t", ode="du/dt=sin(u)", out_functional="J=int(u^2)", ref_factor=4,
         t_span=(0.0, 2.0), u0=1.0),
    dict(case="lin", ode="du/dt=u", out_functional="J=int(u)", ref_factor=3,
         t_span=(0.5, 1.5), u0=0.7),
)


def close(got, want):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(1.0, float(np.max(np.abs(want)))) if want.size else 1.0
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * scale)


def draws(problem, n=8, seed=0):
    """Nonuniform steps spanning the problem's interval, a perturbed
    trajectory on them, and adjoint-like fine values."""
    rng = np.random.default_rng(seed)
    t0, t1 = problem["t_span"]
    w = rng.uniform(0.5, 1.5, n)
    dt = w / w.sum() * (t1 - t0)
    u = problem["u0"] + np.cumsum(np.concatenate([[0.0], rng.normal(0.0, 0.1, n)]))
    v = rng.normal(size=n * problem["ref_factor"] + 1)
    return dt, u, v


@pytest.mark.parametrize("idx", range(len(PROBLEMS)))
def test_every_field_matches_jax(idx):
    problem = PROBLEMS[idx]
    jf = jcfg.get_problem_functions(jcfg.Problem(**problem))
    tf = tcfg.get_problem_functions(tcfg.Problem(**problem), device="cpu")
    assert tcfg.Funs._fields == jcfg.Funs._fields
    dt, u, v = draws(problem)
    t = np.concatenate([[problem["t_span"][0]], problem["t_span"][0] + np.cumsum(dt)])
    T = lambda x: torch.tensor(x, dtype=torch.float64)  # noqa: E731

    close(tf.fwd_update(T(u[:-1]), T(t[:-1]), T(dt)), jf.fwd_update(u[:-1], t[:-1], dt))
    close(tf.get_f(u, dt), jf.get_f(jnp.asarray(u), jnp.asarray(dt)))
    close(tf.get_jf_diag(u, dt), jf.get_jf_diag(jnp.asarray(u), jnp.asarray(dt)))
    close(tf.get_k(u, dt), jf.get_k(jnp.asarray(u), jnp.asarray(dt)))
    assert (tf.exact_fwd is None) == (jf.exact_fwd is None)
    close(tf.exact_fwd(T(t), problem["u0"]), jf.exact_fwd(jnp.asarray(t), problem["u0"]))
    assert (tf.exact_adj is None) == (jf.exact_adj is None)
    close(tf.exact_adj(t), jf.exact_adj(jnp.asarray(t)))
    close(tf.forward_solve(dt), jf.forward_solve(jnp.asarray(dt)))
    close(tf.forward_solve(dt, 0.3), jf.forward_solve(jnp.asarray(dt), 0.3))
    close(tf.adjoint_solve(dt, u), jf.adjoint_solve(jnp.asarray(dt), jnp.asarray(u)))
    close(tf.error_estimate(dt, u, v),
          jf.error_estimate(jnp.asarray(dt), jnp.asarray(u), jnp.asarray(v)))
    err = np.abs(v[: len(dt)])
    close(tf.adapt(t, err), jf.adapt(jnp.asarray(t), jnp.asarray(err)))


def test_problem_functions_consistent():
    """tests/test_infra.py's TestConfigFacade on the port."""
    problem = tcfg.Problem(case="t", ode="du/dt=sin(u)", out_functional="J=int(u^2)",
                           ref_factor=4, t_span=(0.0, 2.0), u0=1.0)
    funs = tcfg.get_problem_functions(problem, device="cpu")
    dt = torch.full((8,), 0.25, dtype=torch.float64)
    u = funs.forward_solve(dt)
    # getF at the solution equals the shifted trajectory (fixed point)
    np.testing.assert_allclose(funs.get_f(u, dt).numpy(), u.numpy(), rtol=1e-12)
    # Jacobian diagonal matches the closed form 1 + cos(u)·dt
    np.testing.assert_allclose(funs.get_jf_diag(u, dt).numpy(),
                               (1 + torch.cos(u[:-1]) * dt).numpy(), rtol=1e-12)
    v = funs.adjoint_solve(dt, u)
    err = funs.error_estimate(dt, u, v)
    assert err.shape == (8,) and float(err.max()) > 0
    times = torch.cat([torch.zeros(1, dtype=torch.float64), torch.cumsum(dt, 0)])
    assert funs.adapt(times, err).shape[0] == times.shape[0] + 1
    assert funs.exact_adj(torch.linspace(0.0, 2.0, 5, dtype=torch.float64)).shape == (5,)


def test_default_device_is_the_card():
    """``get_problem_functions`` defaults to the card and raises where there
    is none, as every entry point of the port does."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    problem = tcfg.Problem(case="t", ode="du/dt=sin(u)", out_functional="J=int(u^2)")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcfg.get_problem_functions(problem)
