"""The port's mixed-order DG-in-time operators, march, adjoint,
reconstruction and functional (march/dg_mixed.py, adjoint/dg_mixed.py)
against the JAX package, float64 on the CPU, on per-member partitions with
mixed orders and zero-width tails.

The JAX functions take one member; they are vmapped over the members, as
the JAX hp loops run them. Tolerance: the same float64 operations in
another order (batched einsums here, XLA dots there), so values agree to a
few ulp of their O(1) scale — held to 1e-12. Operators are host NumPy built
by the same formulas from bit-equal Jacobi nodes: equal (atol 0)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adjoint_ode_adaptivity_tpu.adjoint import dg_mixed as jadj
from adjoint_ode_adaptivity_tpu.march import dg_mixed as jmarch
from adjoint_ode_adaptivity_tpu_torch import odes
from adjoint_ode_adaptivity_tpu_torch.adjoint import dg_mixed as tadj
from adjoint_ode_adaptivity_tpu_torch.interop import mixed_operators_from_numpy
from adjoint_ode_adaptivity_tpu_torch.march import dg_mixed as tmarch

torch.set_num_threads(1)  # one intra-op thread a process: the suite runs in xdist workers

F64 = torch.float64
ATOL = 1e-12
N_USER, FO = 3, 2
SIN = odes.get_ode("du/dt=sin(u)")
F_J = lambda u, t: jnp.sin(u)  # noqa: E731


def _problem(b=6, k=7, seed=0):
    """Per-member partitions of [0, 2] (member m keeps k − m % 3 live slabs,
    the rest zero-width at t = 2), random orders 1..N_USER (1 on padding)."""
    rng = np.random.default_rng(seed)
    times = np.full((b, k + 1), 2.0)
    ns = np.ones((b, k), np.int32)
    for m in range(b):
        live = k - m % 3
        times[m, : live + 1] = np.concatenate([[0.0], np.sort(rng.uniform(0.1, 1.9, live - 1)),
                                               [2.0]])
        ns[m, :live] = rng.integers(1, N_USER + 1, live)
    return times, ns, rng.uniform(0.5, 2.0, b)


TIMES, NS, Y0 = _problem()


def t64(x):
    return torch.tensor(np.asarray(x), dtype=F64)


def tns(x):
    return torch.tensor(np.asarray(x), dtype=torch.int64)


def close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=atol)


@pytest.fixture(scope="module")
def mops():
    return tmarch.dg_time_operators_mixed(N_USER + FO)


@pytest.fixture(scope="module")
def jmops():
    return jmarch.dg_time_operators_mixed(N_USER + FO)


@pytest.mark.parametrize("n_max,n_gq", [(2, None), (5, None), (7, None), (4, 30)])
def test_operator_stacks_equal_jax(n_max, n_gq):
    ours, ref = tmarch.dg_time_operators_mixed(n_max, n_gq), jmarch.dg_time_operators_mixed(n_max,
                                                                                          n_gq)
    assert ours._fields == ref._fields
    for name, a, b in zip(ref._fields, ours, ref):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=name)
    crossed = mixed_operators_from_numpy(ref._asdict())
    assert crossed.n_max == n_max and isinstance(crossed.n_max, int)
    for name, a, b in zip(ref._fields, crossed, ref):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=name)
    for build, jbuild in ((tadj.dg_adjoint_interp_mixed, jadj.dg_adjoint_interp_mixed),
                          (tadj.dg_radau_interp_mixed, jadj.dg_radau_interp_mixed)):
        a, b = build(ours), jbuild(ref)
        assert a._fields == b._fields
        for name, x, y in zip(b._fields, a, b):
            np.testing.assert_array_equal(x, np.asarray(y), err_msg=name)


def test_gauss_solve_matches_jax_and_linalg():
    rng = np.random.default_rng(4)
    a = rng.normal(size=(5, 6, 6)) + 6 * np.eye(6)
    b = rng.normal(size=(5, 6))
    ours = tmarch.gauss_solve(t64(a), t64(b))
    close(ours, jmarch.gauss_solve(jnp.asarray(a), jnp.asarray(b)), atol=1e-15)
    close(ours, np.linalg.solve(a, b[..., None])[..., 0], atol=1e-13)


def _jax_march(jmops, times, ns, y0, **kw):
    return jax.vmap(lambda t, n, y: jmarch.dg_march_mixed(jmops, F_J, t, n, y, **kw))(
        jnp.asarray(times), jnp.asarray(ns), jnp.asarray(y0))


@pytest.mark.parametrize("kw", [{}, {"newton_iters": 4}, {"newton_tol": 1e-3}],
                         ids=["tolerance", "fixed_count", "loose_tolerance"])
def test_march_matches_jax(mops, jmops, kw):
    """``newton_tol=1e-3`` stops members after different Newton counts with
    updates of ~1e-4 still pending: a member that went on updating until the
    slowest converged would miss JAX's vmapped while_loop by far more than
    the tolerance."""
    ref = _jax_march(jmops, TIMES, NS, Y0, **kw)
    ours = tmarch.dg_march_mixed(mops, SIN.f, t64(TIMES), tns(NS), t64(Y0), f_u=SIN.f_u, **kw)
    for name in ("u", "t", "newton_resnorm"):
        close(getattr(ours, name), getattr(ref, name))
    np.testing.assert_array_equal(ours.newton_iters.numpy(), np.asarray(ref.newton_iters))
    if "newton_tol" in kw:  # the members did stop at different counts
        assert len(np.unique(np.asarray(ref.newton_iters))) > 1
    # padded nodes stay exactly zero; zero-width slabs keep the inflow value
    live = np.arange(mops.np_max)[None, None, :] <= NS[..., None]
    assert np.all(ours.u.numpy()[~live] == 0)
    pad = np.diff(TIMES, axis=1) == 0
    close(ours.u.numpy()[pad][:, 0], ours.u.numpy()[pad][:, 1], atol=1e-14)


def test_member_freezes_at_its_own_convergence(mops):
    """In the batch, a member's tolerance-Newton history is its own: each
    member equals its solo march."""
    kw = dict(f_u=SIN.f_u, newton_tol=1e-3)
    batch = tmarch.dg_march_mixed(mops, SIN.f, t64(TIMES), tns(NS), t64(Y0), **kw)
    for m in (0, 4):
        solo = tmarch.dg_march_mixed(mops, SIN.f, t64(TIMES[m:m + 1]), tns(NS[m:m + 1]),
                                     t64(Y0[m:m + 1]), **kw)
        close(batch.u[m], solo.u[0], atol=1e-15)
        assert torch.equal(batch.newton_iters[m], solo.newton_iters[0])


@pytest.fixture(scope="module")
def marched(mops):
    return tmarch.dg_march_mixed(mops, SIN.f, t64(TIMES), tns(NS), t64(Y0), f_u=SIN.f_u).u


def test_adjoint_march_and_functional_match_jax(mops, jmops, marched):
    jinterp = jadj.dg_adjoint_interp_mixed(jmops)
    u = jnp.asarray(marched.numpy())
    ref = jax.vmap(lambda uu, t, n, y: jadj.dg_adjoint_march_mixed(jmops, jinterp, F_J, uu, t, n, y))(
        u, jnp.asarray(TIMES), jnp.asarray(NS), jnp.asarray(Y0))
    ours = tadj.dg_adjoint_march_mixed(mops, tadj.dg_adjoint_interp_mixed(mops), SIN.f, marched,
                                       t64(TIMES), tns(NS), t64(Y0), f_u=SIN.f_u)
    for name in ("v", "t", "err"):
        close(getattr(ours, name), getattr(ref, name))
    assert np.all(ours.err.numpy()[:, -1][np.diff(TIMES, axis=1)[:, -1] == 0] == 0)
    for g, jg in ((None, lambda uu, t: uu), (lambda uu, t: uu * uu, lambda uu, t: uu * uu)):
        want = jax.vmap(lambda uu, t, n: jadj.dg_element_functional_mixed(jmops, uu, t, n, jg))(
            u, jnp.asarray(TIMES), jnp.asarray(NS))
        close(tadj.dg_element_functional_mixed(mops, marched, t64(TIMES), tns(NS), g), want)


def test_reconstruct_triple_matches_jax(mops, jmops, marched):
    u = jnp.asarray(marched.numpy())
    jt, jn, jy = jnp.asarray(TIMES), jnp.asarray(NS), jnp.asarray(Y0)
    jrad, jinterp = jadj.dg_radau_interp_mixed(jmops), jadj.dg_adjoint_interp_mixed(jmops)
    v_low_r = jax.vmap(lambda uu, t, n, y: jadj.dg_adjoint_solve_low_mixed(jmops, F_J, uu, t, n, y))(
        u, jt, jn, jy)
    v_hi_r = jax.vmap(lambda v, n: jadj.dg_adjoint_reconstruct_mixed(jmops, jrad, v, n))(v_low_r, jn)
    err_r = jax.vmap(lambda uu, t, n, y, v: jadj.dg_awr_from_adjoint_mixed(
        jmops, jinterp, F_J, uu, t, n, y, v))(u, jt, jn, jy, v_hi_r)
    v_low = tadj.dg_adjoint_solve_low_mixed(mops, SIN.f, marched, t64(TIMES), tns(NS), t64(Y0),
                                            f_u=SIN.f_u)
    v_hi = tadj.dg_adjoint_reconstruct_mixed(mops, tadj.dg_radau_interp_mixed(mops), v_low, tns(NS))
    err = tadj.dg_awr_from_adjoint_mixed(mops, tadj.dg_adjoint_interp_mixed(mops), SIN.f, marched,
                                         t64(TIMES), tns(NS), t64(Y0), v_hi)
    close(v_low, v_low_r)
    close(v_hi, v_hi_r)
    close(err, err_r)


def test_out_of_range_orders_raise(mops, marched):
    interp = tadj.dg_adjoint_interp_mixed(mops)
    bad = tns(NS).clone()
    bad[0, 0] = mops.n_max + 1
    with pytest.raises(ValueError, match="operator stack"):
        tmarch.dg_march_mixed(mops, SIN.f, t64(TIMES), bad, t64(Y0))
    bad[0, 0] = 0
    with pytest.raises(ValueError, match="operator stack"):
        tadj.dg_element_functional_mixed(mops, marched, t64(TIMES), bad)
    top = torch.full_like(tns(NS), mops.n_max)
    with pytest.raises(ValueError, match="ns\\+1"):
        tadj.dg_adjoint_march_mixed(mops, interp, SIN.f, marched, t64(TIMES), top, t64(Y0))
    with pytest.raises(ValueError, match="ns\\+1"):
        tadj.dg_adjoint_reconstruct_mixed(mops, tadj.dg_radau_interp_mixed(mops), marched, top)
    with pytest.raises(ValueError, match="shape"):
        tmarch.dg_march_mixed(mops, SIN.f, t64(TIMES), tns(NS)[:, :-1], t64(Y0))


def test_singular_g_u_stays_finite_on_the_padding(mops, marched):
    """g_u = 1/u is infinite at the padded (zero) nodes; it is evaluated on
    the live nodes only."""
    interp = tadj.dg_adjoint_interp_mixed(mops)
    adj = tadj.dg_adjoint_march_mixed(mops, interp, SIN.f, marched, t64(TIMES), tns(NS), t64(Y0),
                                      g_u=lambda u, t: 1.0 / u)
    v_low = tadj.dg_adjoint_solve_low_mixed(mops, SIN.f, marched, t64(TIMES), tns(NS), t64(Y0),
                                            g_u=lambda u, t: 1.0 / u)
    for x in (adj.v, adj.err, v_low):
        assert bool(torch.isfinite(x).all())
