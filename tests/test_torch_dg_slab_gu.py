"""D1 and H1 with a goal other than J = ∫u (ops/cuda/dg_slab.py,
ops/cuda/dg_slab_mixed.py) on the CPU: J = ∫u², whose adjoint source
g_u = 2u the kernels evaluate by a functor (csrc/odes.cuh, the registry
functional's ``kernel_id``) at the adjoint nodes.

- the plain versions with g_u = 2u against the JAX package's XLA functions
  with the same g_u, float64 to 1e-12: D1's whole pipeline
  (``dg_estimate_batched``, which calls ``dg_adjoint_march_batched`` as
  adapt/dg_loop.py does) on per-member partitions with zero-width tails, and
  H1's adjoint (``dg_adjoint_march_mixed``, vmapped) on the port's coarse
  states, members with zero-width tails and mixed orders;
- the kernels' sum order in plain PyTorch (the ``*_lanes_plain`` emulations,
  the goal's M·g_u as the kernel's chain, g_u 0 at the padding nodes) within
  the extended per-element bounds, which hold float32 against float64 and
  bite: the J = ∫u result lies outside the J = ∫u² bounds;
- the DG and hp per-member loops with ``engine="cuda"`` on the CPU (the
  kernels' plain versions, float32) against the JAX loops with g_u = 2u:
  the same partitions (and orders);
- the cuda engine and the factories refuse a bare g_u callable.

Padding nodes: the padded mass columns are exactly 0, so with a finite g_u
the live mask cannot change a value here; the emulation masks as the kernel
does. The kernels themselves run only on a GPU (tests/test_torch_cuda.py,
chip_smoke.py phase 38)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adjoint_ode_adaptivity_tpu.adapt import dg_loop as jloop
from adjoint_ode_adaptivity_tpu.adapt import hp_loop as jhp
from adjoint_ode_adaptivity_tpu.adjoint import dg_mixed as jadj
from adjoint_ode_adaptivity_tpu.march import dg_mixed as jmarch
from adjoint_ode_adaptivity_tpu.march.dg_batched import dg_estimate_batched
from adjoint_ode_adaptivity_tpu.march.dg_time import dg_time_operators as jops
from adjoint_ode_adaptivity_tpu_torch import functionals, odes
from adjoint_ode_adaptivity_tpu_torch.adapt import dg_loop, hp_loop
from adjoint_ode_adaptivity_tpu_torch.adjoint.dg_mixed import (
    dg_adjoint_interp_mixed,
    dg_radau_interp_mixed,
)
from adjoint_ode_adaptivity_tpu_torch.march.dg_mixed import dg_time_operators_mixed
from adjoint_ode_adaptivity_tpu_torch.march.dg_time import dg_time_operators
from adjoint_ode_adaptivity_tpu_torch.ops.cuda import dg_slab as ds
from adjoint_ode_adaptivity_tpu_torch.ops.cuda import dg_slab_mixed as hm

torch.set_num_threads(1)  # one intra-op thread a process: the suite runs in xdist workers

SIN = odes.get_ode("du/dt=sin(u)")
U2 = functionals.get_functional("J=int(u^2)")
F_J = lambda u, t: jnp.sin(u)  # noqa: E731
G_J = lambda u, t: u * u  # noqa: E731
GU_J = lambda u, t: 2.0 * u  # noqa: E731
ATOL64 = 1e-12  # the same float64 operations in another order
N_USER, FO, NEWTON = 3, 2, 8


def _d1_inputs(k, b, seed, dtype=torch.float64):
    """Per-member partitions of [0, 2] with at least one zero-width tail."""
    rng = np.random.default_rng(seed)
    y0s = rng.uniform(0.5, 2.0, b).astype(np.float32)
    times = np.full((b, k + 1), 2.0)
    for m, n_act in enumerate(rng.integers(2, k, b)):
        times[m, : n_act + 1] = np.concatenate([[0.0], np.sort(rng.uniform(0.1, 1.9, n_act - 1)),
                                                [2.0]])
    return torch.tensor(times, dtype=dtype), torch.tensor(y0s, dtype=dtype)


def _d1(n, k, g_u=U2.g_u, ode=SIN, newton_iters=6):
    return ds.make_cuda_dg_estimate_ensemble(ode, dg_time_operators(n), dg_time_operators(n + 1),
                                             k, newton_iters, g_u=g_u, device="cpu")


def _hp_inputs(b, k, seed, dtype=torch.float64):
    """Per-member partitions of [0, 2] with zero-width tails (every second
    member has at least one) and random orders 1..N_USER on the live slabs."""
    rng = np.random.default_rng(seed)
    times = np.full((b, k + 1), 2.0)
    ns = np.ones((b, k), np.int64)
    for m in range(b):
        live = k if m % 2 == 0 else int(rng.integers(2, k))
        times[m, : live + 1] = np.concatenate([[0.0], np.sort(rng.uniform(0.1, 1.9, live - 1)),
                                               [2.0]])
        ns[m, :live] = rng.integers(1, N_USER + 1, live)
    y0 = rng.uniform(0.5, 2.0, b).astype(np.float32)
    return torch.tensor(times, dtype=dtype), torch.tensor(ns), torch.tensor(y0, dtype=dtype)


def _hp(k, mode="solve", g_u=U2.g_u):
    mops = dg_time_operators_mixed(N_USER + FO)
    return hm.make_cuda_dg_estimate_hp_per_member(
        SIN, mops, dg_adjoint_interp_mixed(mops), k, n_max_user=N_USER, fine_offset=FO,
        newton_iters=NEWTON, adjoint_mode=mode, rad=dg_radau_interp_mixed(mops), g_u=g_u,
        device="cpu")


def _shares(got, want, tol, names):
    """Each output's worst |got − want| as a share of its per-element bound."""
    return {name: float(((g.double() - w.double()).abs() / tol[name])
                        .nan_to_num(0.0, posinf=float("inf")).max())
            for name, g, w in zip(names, got, want)}


def test_d1_plain_version_matches_the_jax_pipeline_with_g_u():
    """Order 1, K = 8, B = 24, float64: u, v and err to 1e-12 of JAX's
    ``dg_estimate_batched(..., g_u=2u)`` (one JAX call); the goal moves v."""
    k = 8
    times, y0s = _d1_inputs(k, 24, seed=4)
    run = _d1(1, k)
    assert run.plan.functors.gu_id == 1
    got = run(times, y0s)
    want = dg_estimate_batched(jops(1), jops(2), F_J, jnp.asarray(times.numpy()),
                               jnp.asarray(y0s.numpy()), g_u=GU_J, newton_iters=6)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=ATOL64)
    unit = _d1(1, k, g_u=None)(times, y0s)
    assert float((unit[1] - got[1]).abs().max()) > 1e-3


def test_h1_plain_version_matches_the_jax_adjoint_with_g_u():
    """Solve mode, K = 5, B = 12 with zero-width tails and orders 1..3,
    float64: v and err to 1e-12 of JAX's vmapped ``dg_adjoint_march_mixed``
    with g_u = 2u on the port's coarse states (one JAX call)."""
    times, ns, y0 = _hp_inputs(12, 5, seed=3)
    run = _hp(5)
    u_c, _, v, err = run(times, ns, y0)
    mops = jmarch.dg_time_operators_mixed(N_USER + FO)
    interp = jadj.dg_adjoint_interp_mixed(mops)

    def member(u_m, t_m, n_m, y_m):
        adj = jadj.dg_adjoint_march_mixed(mops, interp, F_J, u_m, t_m, n_m, y_m, g_u=GU_J)
        return adj.v, adj.err

    jv, jerr = jax.vmap(member)(jnp.asarray(u_c.numpy()), jnp.asarray(times.numpy()),
                                jnp.asarray(ns.numpy().astype(np.int32)), jnp.asarray(y0.numpy()))
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=0, atol=ATOL64)
    np.testing.assert_allclose(err.numpy(), np.asarray(jerr), rtol=0, atol=ATOL64)
    pad = torch.diff(times, dim=1) == 0
    assert bool(pad.any()) and bool((err[pad] == 0).all())


@pytest.mark.parametrize("lanes", [1, 8])
def test_d1_lanes_order_within_the_extended_bounds(lanes):
    """D1's sum order at G lanes (the goal's M·g_u chain included), float32,
    within the J = ∫u² bounds of the float32 plain version; the float32
    plain version within a tenth of them of float64; an err of 0 and the
    J = ∫u adjoint fail them."""
    k = 8
    times, y0s = _d1_inputs(k, 32, seed=6, dtype=torch.float32)
    run = _d1(1, k)
    p32 = run(times, y0s)
    p64 = ds.dg_estimate_ensemble_plain(times.double(), y0s.double(), run.plan)
    tol = ds.dg_kernel_tolerance(times, y0s, p32, run.plan)
    got = ds.dg_estimate_ensemble_lanes_plain(times, y0s, run.plan, lanes)
    names = ("u", "v", "err")
    assert max(_shares(got, p32, tol, names).values()) <= 0.25
    assert max(_shares(p32, p64, tol, names).values()) <= 0.1
    assert bool((p64[2].abs() > tol["err"]).any())
    unit = _d1(1, k, g_u=None)(times, y0s)
    assert _shares(unit, p32, tol, names)["v"] > 1.0 and _shares(unit, p32, tol, names)["err"] > 1.0
    pad = torch.diff(times, dim=1) == 0
    assert bool(pad.any()) and bool((got[2][pad] == 0).all())


def test_d1_tables_and_unit_goal():
    """The goal appends M_a and (1 + r_i)/2 to J = ∫u's tables, which stay as
    they were; J = ∫u's registry g_u runs the unit route (kernel_id 0)."""
    ops_p, ops_a = dg_time_operators(2), dg_time_operators(3)
    base, goal = ds.kernel_tables(ops_p, ops_a), ds.kernel_tables(ops_p, ops_a, goal=True)
    na = ops_a.np_
    assert goal.size == base.size + na * na + na
    np.testing.assert_array_equal(goal[: base.size], base)
    np.testing.assert_array_equal(goal[base.size: base.size + na * na], ops_a.mass.ravel())
    assert _d1(1, 4, g_u=functionals.get_functional("J=int(u)").g_u).plan.functors.gu_id == 0
    assert _d1(1, 4, g_u=U2).plan.functors.gu_id == 1
    assert _d1(2, 4).plan.tables32.size == goal.size


@pytest.mark.parametrize("mode", ["solve", "reconstruct"])
def test_h1_lanes_order_within_the_extended_bounds(mode):
    """H1's sum order at G = 4 lanes with g_u = 2u at the live nodes, float32,
    within the J = ∫u² bounds of the float32 plain version; float32 plain
    within a quarter of them of float64; the J = ∫u adjoint fails them."""
    times, ns, y0 = _hp_inputs(16, 6, seed=8, dtype=torch.float32)
    run = _hp(6, mode)
    p32 = run(times, ns, y0)
    p64 = hm.dg_estimate_hp_per_member_plain(times.double(), ns, y0.double(), run.plan)
    tol = hm.hp_kernel_tolerance(times, ns, y0, p32, run.plan)
    got = hm.dg_estimate_hp_lanes_plain(times, ns, y0, run.plan, 4)
    names = ("u_c", "u_f", "v", "err")
    assert max(_shares(got, p32, tol, names).values()) <= 0.25
    assert max(_shares(p32, p64, tol, names).values()) <= 0.25
    assert bool((p64[3].abs() > tol["err"]).any())
    unit = _hp(6, mode, g_u=None)(times, ns, y0)
    assert _shares(unit, p32, tol, names)["v"] > 1.0
    pad = torch.diff(times, dim=1) == 0
    assert bool(pad.any()) and bool((got[3][pad] == 0).all())
    mops = run.plan.mops
    tables = hm.kernel_tables(mops, run.plan.interp, run.plan.rad, goal=True)
    base = hm.kernel_tables(mops, run.plan.interp, run.plan.rad)
    assert tables.size == base.size + mops.n_max * (mops.np_max ** 2 + mops.np_max)
    assert run.plan.tables.numel() == tables.size


def test_dg_per_member_loop_with_g_u_matches_jax():
    """engine="cuda" on the CPU (D1's plain version, float32) with J = ∫u²
    against the JAX xla loop with g = u², g_u = 2u on float32 initial
    conditions: the same partitions, member by member."""
    y32 = np.random.default_rng(3).uniform(0.5, 2.0, 8).astype(np.float32)
    kw = dict(k0=2, maxit=3, tol=0.0, newton_iters=8)
    ref = jloop.run_adaptive_dg_per_member(F_J, y32, (0.0, 2.0), g=G_J, g_u=GU_J, **kw)
    ours = dg_loop.run_adaptive_dg_per_member(SIN.f, y32, (0.0, 2.0), g=lambda u, t: u * u,
                                              g_u=U2.g_u, engine="cuda", ode=SIN,
                                              dtype=torch.float32, device="cpu", **kw)
    assert len(ours) == len(ref) == 4
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a.times, np.asarray(b.times))
        np.testing.assert_array_equal(a.n_active, b.n_active)
    unit = dg_loop.run_adaptive_dg_per_member(SIN.f, y32, (0.0, 2.0), engine="cuda", ode=SIN,
                                              dtype=torch.float32, device="cpu", **kw)
    assert any(not np.array_equal(a.times, b.times) for a, b in zip(unit, ours))


def test_hp_per_member_loop_with_g_u_matches_jax():
    """engine="cuda" on the CPU (H1's plain version, float32) with J = ∫u²
    against the JAX hp per-member loop with g = u², g_u = 2u (xla engine,
    float64, 8 Newton steps): the same partitions and orders."""
    y0s = np.random.default_rng(5).uniform(0.5, 2.0, 8)
    kw = dict(k0=2, n_max=2, mode="hp", tol=0.0, maxit=3, newton_iters=NEWTON)
    ref = jhp.run_adaptive_dg_hp_per_member(F_J, y0s, (0.0, 2.0), g=G_J, g_u=GU_J, **kw)
    ours = hp_loop.run_adaptive_dg_hp_per_member(SIN.f, y0s, (0.0, 2.0), g=lambda u, t: u * u,
                                                 g_u=U2.g_u, engine="cuda", ode=SIN,
                                                 dtype=torch.float32, device="cpu", **kw)
    assert len(ours) == len(ref) == 4
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a.times.astype(np.float32), np.asarray(b.times, np.float32))
        np.testing.assert_array_equal(a.ns, b.ns)


def test_the_cuda_engine_refuses_a_bare_g_u():
    """A bare g_u is traced into a device functor (ops/cuda/functor.py): one
    outside the tracer's op set is refused on every path, as is a goal with
    a terminal condition (J = u_N); a traceable one runs on a user library
    (the user id), its plain g_u the traced callable's values."""
    from adjoint_ode_adaptivity_tpu_torch.ops.cuda.functor import USER_KERNEL_ID

    bare = lambda u, t: torch.sum(u) * u  # noqa: E731 - a reduction: no elementwise op
    with pytest.raises(ValueError, match="cannot trace.*torch.sum"):
        _d1(1, 4, g_u=bare)
    with pytest.raises(ValueError, match="cannot trace.*torch.sum"):
        _hp(4, g_u=bare)
    with pytest.raises(ValueError, match="terminal condition"):
        _d1(1, 4, g_u=functionals.get_functional("J=u_N"))
    kw = dict(engine="cuda", ode=SIN, maxit=1, dtype=torch.float32, device="cpu", g_u=bare)
    with pytest.raises(ValueError, match="cannot trace.*torch.sum"):
        dg_loop.run_adaptive_dg_per_member(SIN.f, np.ones(4), (0.0, 2.0), **kw)
    with pytest.raises(ValueError, match="cannot trace.*torch.sum"):
        hp_loop.run_adaptive_dg_hp_per_member(SIN.f, np.ones(4), (0.0, 2.0), **kw)
    traced = lambda u, t: 2.0 * u  # noqa: E731
    assert functionals.kernel_goal(traced).kernel_id is None
    for plan in (_d1(1, 4, g_u=traced).plan, _hp(4, g_u=traced).plan):
        assert plan.functors.gu_id == USER_KERNEL_ID and plan.functors.header is not None
        x = torch.linspace(0.5, 2.0, 7, dtype=torch.float64)
        assert torch.equal(plan.functors.g_u(x, x), traced(x, x))
    # the torch engine keeps taking any callable
    hist = dg_loop.run_adaptive_dg_per_member(SIN.f, np.ones(4), (0.0, 2.0), maxit=1, g_u=bare,
                                              dtype=torch.float64, device="cpu")
    assert len(hist) == 2
