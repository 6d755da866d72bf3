"""The five kernels that take a caller's elementwise callables — F1, F2, F3
(ops/cuda/fd_ensemble.py), D1 (ops/cuda/dg_slab.py) and H1
(ops/cuda/dg_slab_mixed.py) — through their entry points with traced
functors, on the CPU (their plain versions call the callables themselves,
f_u derived on the traced IR where it is not given), against the JAX
kernels in float64.

The fixed functions keep the solution positive (y0 in [0.2, 0.8] keeps u
above 0.113): f(u, t) = u(1 − u) + 0.1·cos(2t), in no registry, with its
hand-written f_u = 1 − 2u for F1 and F3 and f_u derived by forward mode for
D1 and H1; the goal g_u = 1/u (J = ∫log u); Van der Pol (μ = 1) as
tests/test_pallas.py:564-573 writes it, its Jacobian's literal 0.0 skipped;
F2 also at d = 3 and 4 (its cap) on a rigid body and two coupled
oscillators.

JAX side, as its own tests run it: F3, and F2 at d = 3 and 4, through
their Pallas kernels in interpret mode, F1 and F2 at d = 2 through the XLA
composition of tests/test_pallas.py's ``_xla_one`` (vmapped), D1 through
the XLA ``dg_estimate_batched`` and, to 1e-6, its Pallas kernel in
interpret mode (whose tables are float32 there), H1 through the vmapped
``dg_march_mixed`` and ``dg_adjoint_march_mixed``. Tolerance 1e-10: the same
float64 quantities in another operation order (closed-form adjoints
against jax.grad and VJPs, jnp.interp against the folded weights, the
derived f_u against jax.jvp). g_u = 1/u stays finite through H1's padding
nodes (the live mask, tests/test_dg_mixed.py:280-291). The DG ensemble
loop's and the FD per-member loop's cuda engines with ``ode=None`` on the
CPU give the torch engines' partitions.

The kernels themselves run on a GPU only (chip_smoke.py phase 42)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adjoint_ode_adaptivity_tpu.adjoint import (
    adjoint_march,
    coarse_indicator,
    interp_to_fine,
    refine_all,
    residual,
)
from adjoint_ode_adaptivity_tpu.adjoint import dg_mixed as jadj
from adjoint_ode_adaptivity_tpu.march import dg_mixed as jmarch
from adjoint_ode_adaptivity_tpu.march import euler_step, forward_march
from adjoint_ode_adaptivity_tpu.march.dg_batched import dg_estimate_batched
from adjoint_ode_adaptivity_tpu.march.dg_time import dg_time_operators as jops
from adjoint_ode_adaptivity_tpu.ops.pallas.dg_slab import make_pallas_dg_estimate_ensemble
from adjoint_ode_adaptivity_tpu.ops.pallas.fd_ensemble import (
    make_pallas_fd_ensemble_vec,
    make_pallas_fd_estimate_per_member,
)
from adjoint_ode_adaptivity_tpu_torch.adapt import dg_loop, fd_loop, hp_loop
from adjoint_ode_adaptivity_tpu_torch.adjoint.dg_mixed import (
    dg_adjoint_interp_mixed,
    dg_radau_interp_mixed,
)
from adjoint_ode_adaptivity_tpu_torch.march.dg_mixed import dg_time_operators_mixed
from adjoint_ode_adaptivity_tpu_torch.march.dg_time import dg_time_operators
from adjoint_ode_adaptivity_tpu_torch.march.fd import euler_step as t_euler_step
from adjoint_ode_adaptivity_tpu_torch.ops.cuda import dg_slab as ds
from adjoint_ode_adaptivity_tpu_torch.ops.cuda import dg_slab_mixed as hm
from adjoint_ode_adaptivity_tpu_torch.ops.cuda import fd_ensemble as fe
from adjoint_ode_adaptivity_tpu_torch.ops.cuda.functor import USER_KERNEL_ID

torch.set_num_threads(1)  # one intra-op thread a process: the suite runs in xdist workers

F64 = torch.float64
TOL = 1e-10
F_T = lambda u, t: u * (1 - u) + 0.1 * torch.cos(2 * t)  # noqa: E731
FU_T = lambda u, t: 1 - 2 * u  # noqa: E731
G_T = lambda u, t: 1.0 / u  # noqa: E731
F_J = lambda u, t: u * (1 - u) + 0.1 * jnp.cos(2 * t)  # noqa: E731
FU_J = lambda u, t: 1 - 2 * u  # noqa: E731
G_J = lambda u, t: 1.0 / u  # noqa: E731
# Van der Pol, μ = 1, as tests/test_pallas.py:564-573 (arithmetic only: torch or jnp alike)
VDP_COMPS = lambda us, t: (us[1], (1.0 - us[0] * us[0]) * us[1] - us[0])  # noqa: E731
VDP_JAC = lambda us, t: ((0.0, 1.0), (-2.0 * us[0] * us[1] - 1.0, 1.0 - us[0] * us[0]))  # noqa: E731
# d = 3: Euler's rigid body (Hairer's test problem), literal zeros on the
# Jacobian's diagonal; d = 4 (F2's cap): two coupled oscillators, one cubic,
# one forced in t. The jnp twins stack the same components.
RIGID_COMPS = lambda us, t: (us[1] * us[2], -us[0] * us[2], -0.51 * us[0] * us[1])  # noqa: E731
RIGID_JAC = lambda us, t: ((0.0, us[2], us[1]), (-us[2], 0.0, -us[0]),  # noqa: E731
                           (-0.51 * us[1], -0.51 * us[0], 0.0))


def _coupled(cos):
    def comps(us, t):
        return (us[1], -us[0] - 0.1 * us[0] * us[0] * us[0] + 0.2 * (us[2] - us[0]), us[3],
                -us[2] + 0.2 * (us[0] - us[2]) + 0.05 * cos(t))
    return comps


COUPLED_COMPS = _coupled(torch.cos)
COUPLED_JAC = lambda us, t: ((0.0, 1.0, 0.0, 0.0),  # noqa: E731
                             (-1.2 - 0.3 * us[0] * us[0], 0.0, 0.2, 0.0),
                             (0.0, 0.0, 0.0, 1.0), (0.2, 0.0, -1.2, 0.0))
VECTOR_CASES = {3: (RIGID_COMPS, RIGID_JAC, RIGID_COMPS, RIGID_JAC),
                4: (COUPLED_COMPS, COUPLED_JAC, _coupled(jnp.cos), COUPLED_JAC)}
DT = np.array([0.1, 0.3, 0.05, 0.2, 0.15, 0.25])  # nonuniform, 6 steps
RF = 4


def t64(x):
    return torch.tensor(np.asarray(x), dtype=F64)


def _xla_one(f, dt, rf):
    """tests/test_pallas.py's ``_xla_one``: one IC's block indicator from the
    JAX package's XLA primitives (J = ∫u² summed over components)."""
    step = euler_step(f)
    dt = jnp.asarray(dt)
    dt_fine = refine_all(dt, rf)

    def value(u_f):
        return jnp.sum((u_f[:-1] ** 2).reshape(u_f.shape[0] - 1, -1).sum(-1) * dt_fine)

    def one(u0):
        u = forward_march(step, u0, dt)
        u_f = interp_to_fine(u, dt, dt_fine)
        v = adjoint_march(step, u_f, dt_fine, jax.grad(value)(u_f))
        e = residual(step, u_f, dt_fine) * v
        return coarse_indicator(e.reshape(e.shape[0], -1).sum(-1), rf, "block")

    return one


def test_f1_with_callables_matches_the_xla_march():
    u0s = np.random.default_rng(1).uniform(0.2, 0.8, 48)
    want = np.asarray(jax.vmap(_xla_one(F_J, DT, RF))(jnp.asarray(u0s))).T
    run = fe.make_cuda_fd_ensemble(f=F_T, f_u=FU_T, n_steps=len(DT), ref_factor=RF, dt=DT,
                                   device="cpu")
    assert run.plan.functors.ode_id == USER_KERNEL_ID
    before = fe.fd_ensemble.launches
    got = run(t64(u0s))
    assert fe.fd_ensemble.launches == before  # a CPU tensor takes the plain version
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)
    # the positional spelling, the callable in ode's place
    again = fe.make_cuda_fd_ensemble(F_T, len(DT), RF, DT, f_u=FU_T, device="cpu")(t64(u0s))
    assert torch.equal(again, got)
    with pytest.raises(ValueError, match="f_u is required"):
        fe.make_cuda_fd_ensemble(f=F_T, n_steps=len(DT), ref_factor=RF, dt=DT, device="cpu")


def test_f2_with_van_der_pol_matches_the_xla_march():
    u0s = np.random.default_rng(7).uniform(-1.5, 1.5, (40, 2))

    def f_stacked(u, t):  # tests/test_pallas.py:553-557
        return jnp.stack([u[..., 1], (1.0 - u[..., 0] ** 2) * u[..., 1] - u[..., 0]], axis=-1)

    want = np.asarray(jax.vmap(_xla_one(f_stacked, DT, RF))(jnp.asarray(u0s))).T
    run = fe.make_cuda_fd_ensemble_vec(f_comps=VDP_COMPS, jac_comps=VDP_JAC, d=2,
                                       n_steps=len(DT), ref_factor=RF, dt=DT, device="cpu")
    assert run.plan.functors.d == 2 and "nonzero_at" in run.plan.functors.header
    got = run(t64(u0s))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)
    with pytest.raises(ValueError, match=r"\(n_ics, 2\)"):
        run(t64(np.zeros((4, 3))))


@pytest.mark.parametrize("d", [3, 4])
def test_f2_with_callables_at_d3_and_d4_matches_the_pallas_kernel(d):
    comps, jac, twin, twin_jac = VECTOR_CASES[d]
    u0s = np.random.default_rng(d).uniform(-1.5, 1.5, (20_480, d))  # the kernel's IC multiple
    want = np.asarray(make_pallas_fd_ensemble_vec(twin, twin_jac, d, len(DT), RF, dt=DT,
                                                  interpret=True)(jnp.asarray(u0s)))
    run = fe.make_cuda_fd_ensemble_vec(f_comps=comps, jac_comps=jac, d=d, n_steps=len(DT),
                                       ref_factor=RF, dt=DT, device="cpu")
    assert run.plan.functors.d == d and f"OdeTracedVec<{d}," in run.plan.functors.header
    got = run(t64(u0s))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)


def _pm_widths(b, n_steps, seed):
    """Per-member widths over [0, 2] with zero-width padding tails."""
    rng = np.random.default_rng(seed)
    dt = np.zeros((b, n_steps))
    for m in range(b):
        live = int(rng.integers(2, n_steps + 1))
        edges = np.sort(rng.uniform(0.0, 2.0, live - 1))
        dt[m, :live] = np.diff(np.concatenate([[0.0], edges, [2.0]]))
    return dt


def test_f3_with_callables_matches_the_pallas_kernel():
    """One interpret-mode call: the per-member kernel on the same callables."""
    b, n_steps = 8, 6
    dt_b = _pm_widths(b, n_steps, seed=2)
    u0s = np.random.default_rng(3).uniform(0.2, 0.8, b)
    want_e, want_j = make_pallas_fd_estimate_per_member(F_J, FU_J, n_steps, RF, "strided",
                                                        interpret=True)(
        jnp.asarray(dt_b), jnp.asarray(u0s))
    run = fe.make_cuda_fd_estimate_per_member(f=F_T, f_u=FU_T, n_steps=n_steps, ref_factor=RF,
                                              convention="strided", device="cpu")
    e, j = run(t64(dt_b), t64(u0s))
    np.testing.assert_allclose(e.numpy(), np.asarray(want_e), rtol=0, atol=TOL)
    np.testing.assert_allclose(j.numpy(), np.asarray(want_j), rtol=0, atol=TOL)
    assert bool((e[t64(dt_b) == 0] == 0).all())


def _d1_inputs(k, b, seed):
    rng = np.random.default_rng(seed)
    times = np.full((b, k + 1), 2.0)
    for m, n_act in enumerate(rng.integers(2, k + 1, b)):
        times[m, : n_act + 1] = np.concatenate([[0.0], np.sort(rng.uniform(0.1, 1.9, n_act - 1)),
                                                [2.0]])
    return times, rng.uniform(0.2, 0.8, b)


def test_d1_with_derived_f_u_and_g_u_inverse_matches_the_pallas_kernel():
    """The port's entry point with the JAX names (f, g_u = 1/u, f_u derived
    by the tracer's forward mode) on per-member partitions with zero-width
    tails: to 1e-10 of JAX's XLA ``dg_estimate_batched`` (f_u by jax.jvp),
    and to 1e-6 relative of ``make_pallas_dg_estimate_ensemble(ops_p, ops_a,
    f, None, K, g_u=1/u)`` in interpret mode (one call) within 1e-6: its
    folded tables are float32 there (ROADMAP §3), so each output carries a
    few float32 ulps of the O(1) terms it sums."""
    k, b, newton = 4, 8, 6
    times, y0s = _d1_inputs(k, b, seed=4)
    run = ds.make_cuda_dg_estimate_ensemble(ops_p=dg_time_operators(1),
                                            ops_a=dg_time_operators(2), f=F_T, n_elements=k,
                                            newton_iters=newton, g_u=G_T, device="cpu")
    assert run.plan.functors.gu_id == USER_KERNEL_ID
    got = run(t64(times), t64(y0s))
    want = dg_estimate_batched(jops(1), jops(2), F_J, jnp.asarray(times), jnp.asarray(y0s),
                               g_u=G_J, newton_iters=newton)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=TOL)
    assert all(bool(torch.isfinite(x).all()) for x in got)
    pallas = make_pallas_dg_estimate_ensemble(jops(1), jops(2), F_J, None, k, g_u=G_J,
                                              newton_iters=newton, interpret=True)(
        jnp.asarray(times), jnp.asarray(y0s))
    for g, w in zip(got, pallas):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-6)
    # the hand-written f_u agrees with the derived one to float64 roundoff
    given = ds.make_cuda_dg_estimate_ensemble(None, dg_time_operators(1), dg_time_operators(2), k,
                                              newton, f=F_T, f_u=FU_T, g_u=G_T, device="cpu")
    for g, w in zip(given(t64(times), t64(y0s)), got):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=1e-13)


N_USER, FO, K_HP, NEWTON = 3, 2, 5, 8


def _hp_inputs(b, seed):
    """Per-member partitions with zero-width tails (every second member) and
    orders 1..N_USER on the live slabs."""
    rng = np.random.default_rng(seed)
    times = np.full((b, K_HP + 1), 2.0)
    ns = np.ones((b, K_HP), np.int32)
    for m in range(b):
        live = K_HP if m % 2 == 0 else int(rng.integers(2, K_HP))
        times[m, : live + 1] = np.concatenate([[0.0], np.sort(rng.uniform(0.1, 1.9, live - 1)),
                                               [2.0]])
        ns[m, :live] = rng.integers(1, N_USER + 1, live)
    return times, ns, rng.uniform(0.2, 0.8, b)


@pytest.mark.parametrize("adjoint_mode", ["solve", "reconstruct"])
def test_h1_with_derived_f_u_and_g_u_inverse_matches_the_xla_pipeline(adjoint_mode):
    times, ns, y0 = _hp_inputs(8, seed=5)
    mops = dg_time_operators_mixed(N_USER + FO)
    run = hm.make_cuda_dg_estimate_hp_per_member(
        mops=mops, interp=dg_adjoint_interp_mixed(mops), f=F_T, n_elements=K_HP,
        n_max_user=N_USER, fine_offset=FO, newton_iters=NEWTON, adjoint_mode=adjoint_mode,
        rad=dg_radau_interp_mixed(mops), g_u=G_T, device="cpu")
    got = run(t64(times), torch.tensor(ns), t64(y0))
    jm = jmarch.dg_time_operators_mixed(N_USER + FO)
    interp, rad = jadj.dg_adjoint_interp_mixed(jm), jadj.dg_radau_interp_mixed(jm)

    def member(t_m, n_m, y_m):
        u_c = jmarch.dg_march_mixed(jm, F_J, t_m, n_m, y_m, newton_iters=NEWTON).u
        u_f = jmarch.dg_march_mixed(jm, F_J, t_m, n_m + FO, y_m, newton_iters=NEWTON).u
        if adjoint_mode == "solve":
            adj = jadj.dg_adjoint_march_mixed(jm, interp, F_J, u_c, t_m, n_m, y_m, g_u=G_J)
            return u_c, u_f, adj.v, adj.err
        v_low = jadj.dg_adjoint_solve_low_mixed(jm, F_J, u_c, t_m, n_m, y_m, g_u=G_J)
        v = jadj.dg_adjoint_reconstruct_mixed(jm, rad, v_low, n_m)
        return u_c, u_f, v, jadj.dg_awr_from_adjoint_mixed(jm, interp, F_J, u_c, t_m, n_m, y_m,
                                                          v)

    want = jax.vmap(member)(jnp.asarray(times), jnp.asarray(ns), jnp.asarray(y0))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=TOL)
    # g_u = 1/u is singular at the padding's zero nodes: the live mask keeps it finite
    assert all(bool(torch.isfinite(x).all()) for x in got)
    pad = torch.diff(t64(times), dim=1) == 0
    assert bool(pad.any()) and bool((got[3][pad] == 0).all())


def test_dg_ensemble_loop_cuda_engine_traces_f_and_g_u():
    """run_adaptive_dg_ensemble with engine="cuda", ode=None, f and g_u =
    1/u on the CPU (D1's plain version on the traced callables, float32)
    gives the torch engine's partitions (8 Newton steps, tol 0)."""
    y0s = np.random.default_rng(6).uniform(0.2, 0.8, 8).astype(np.float32)
    kw = dict(k0=2, maxit=3, tol=0.0, newton_iters=8, g=lambda u, t: torch.log(u), g_u=G_T,
              dtype=torch.float32, device="cpu")
    ref = dg_loop.run_adaptive_dg_ensemble(F_T, y0s, (0.0, 2.0), **kw)
    ours = dg_loop.run_adaptive_dg_ensemble(F_T, y0s, (0.0, 2.0), engine="cuda", ode=None, **kw)
    assert len(ours) == len(ref) == 4
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a.times, b.times)
        np.testing.assert_allclose(a.err_mean, b.err_mean, rtol=1e-3, atol=1e-7)


def test_fd_per_member_and_hp_loops_cuda_engines_trace_the_callables():
    """run_adaptive_fd_per_member(engine="cuda", ode_f=f) (F3's plain
    version, f_u derived) and run_adaptive_dg_hp_per_member(engine="cuda",
    ode=None, f, g_u = 1/u) (H1's) on the CPU give their torch engines'
    partitions."""
    u0s = np.random.default_rng(8).uniform(0.2, 0.8, 8).astype(np.float32)
    kw = dict(maxit=4, tol=0.0, dtype=torch.float32, device="cpu")
    ref = fd_loop.run_adaptive_fd_per_member(t_euler_step(F_T), u0s, (0.0, 2.0), **kw)
    ours = fd_loop.run_adaptive_fd_per_member(t_euler_step(F_T), u0s, (0.0, 2.0), engine="cuda",
                                              ode_f=F_T, **kw)
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a.times, b.times)
    hkw = dict(k0=2, n0=1, n_max=2, mode="hp", tol=0.0, maxit=3, newton_iters=NEWTON,
               g=lambda u, t: torch.log(u), g_u=G_T, dtype=torch.float32, device="cpu")
    ref = hp_loop.run_adaptive_dg_hp_per_member(F_T, u0s, (0.0, 2.0), **hkw)
    ours = hp_loop.run_adaptive_dg_hp_per_member(F_T, u0s, (0.0, 2.0), engine="cuda", **hkw)
    assert len(ours) == len(ref) == 4
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a.times, b.times)
        np.testing.assert_array_equal(a.ns, b.ns)
