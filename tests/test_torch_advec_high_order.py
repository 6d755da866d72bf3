"""High-order DG advection (N = 8-15, Np 9-16) on the CPU: K1, K2, K2r and
KA's plain versions (ops/cuda/dg_rhs.py) against the JAX package.

The card runs csrc/dg_rhs.cu's kernels at every order, one thread an
element (tests/test_torch_cuda.py, chip_smoke.py phase 43); their plain
versions and the launch schedules' emulations are the ones here:

- the port's ``startup_1d`` tables (Dr, LIFT, V, V⁻¹, the nodes and the
  geometry), from which the float32 tables are folded, are JAX's at N = 8,
  11 and 15, bit for bit;
- float64 at N = 8, 11 and 15: ``fwd_march_plain`` + ``adj_est_stored_plain``,
  ``adj_est_recompute_plain`` and ``adj_march_plain``, and their
  ``*_fused_plain`` emulations on plans cut into tiles,
  against the XLA ``advec_fwd_adj_estimate`` and ``advec_adjoint_march``:
  u and λ within 1e-12 of their largest entry, η within 1e-12 of
  max|λ|·max|u| a node (the scale of its terms: each is a difference of O(1)
  states, whose roundoff does not shrink with η);
- (tests/test_torch_advec_high_order_pallas.py: float32 at N = 8 against the
  Pallas pipeline in interpret mode);
- the effectivity identity Σ η = J(u_dt) − J(u_dt/2) at N = 8 in float64;
- the ghost cones at Np = 12: W one element short of 5·s_f (K1, KA) or of
  10·s_f (K2) moves a local element, W at the cone does not;
- chip_smoke.py's ``tolerances``, re-derived for Np, bites at Np = 12: the float32 plain
  run stays within it of the float64 one, entries of u, λ and η lie above
  it, and K1 on tiles with no ghost window fails it in float32;
- ``kernel_ops`` takes Np 9-16 and the plan functions return plans the
  kernels take (K2 and K2r on 512 threads); Np = 17 raises a ValueError
  naming MAX_NP.

Sizes stay small (K ≤ 16, B ≤ 2, ≤ 16 steps).
"""
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adjoint_ode_adaptivity_tpu.adjoint.advec import advec_adjoint_march, advec_fwd_adj_estimate
from adjoint_ode_adaptivity_tpu.adjoint.advec import terminal_integral_cotangent as jax_lam
from adjoint_ode_adaptivity_tpu.march.advec import advec_operators
from adjoint_ode_adaptivity_tpu.ops import startup_1d as jax_startup_1d
from adjoint_ode_adaptivity_tpu_torch import interop
from adjoint_ode_adaptivity_tpu_torch.adjoint.advec import terminal_integral_cotangent
from adjoint_ode_adaptivity_tpu_torch.ops import startup_1d
from adjoint_ode_adaptivity_tpu_torch.ops.cuda import dg_rhs

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import tolerances  # noqa: E402

torch.set_num_threads(1)  # one intra-op thread a process: the suite runs in xdist workers

A = 2 * np.pi
B = 2
F64 = torch.float64


def _problem(n_order, k, graded=True, cfl=0.5 * 0.75, noise=0.5, seed=0):
    """A graded mesh (vx ∝ s^1.6) at order N, B phase-shifted sines plus
    ``noise``·U(−1, 1) on every node (stiff modes: a step-doubling residual
    far above roundoff), a cotangent ∂(∫u)/∂u with ±50 % noise, and the step
    cfl·x_min/a."""
    vx = 2 * np.pi * np.linspace(0.0, 1.0, k + 1) ** 1.6 if graded else None
    disc_j = jax_startup_1d(n_order, 0.0, 2 * np.pi, k, vx=vx)
    disc = interop.discretization_from_numpy(disc_j._asdict())
    xmin = float(np.min(np.abs(disc.x[0, :] - disc.x[1, :])))
    dt = cfl / A * xmin
    rng = np.random.default_rng(seed)
    u0 = np.stack([np.sin(disc.x + p) + noise * rng.uniform(-1, 1, disc.x.shape)
                   for p in rng.uniform(0, 2 * np.pi, B)], axis=1)
    lam = terminal_integral_cotangent(disc, F64, "cpu").numpy()
    lam = np.stack([lam * (1 + 0.5 * rng.uniform(-1, 1, lam.shape)) for _ in range(B)], axis=1)
    return disc_j, disc, dt, u0, lam


def _plan(k, steps, ghost, tile):
    """A plan of ``steps`` steps a launch, W = ``ghost``, tiles of ``tile``
    elements (512-thread CTAs)."""
    return dg_rhs.FusedPlan(steps, ghost, tile, -(-k // tile), 512)


def _scaled(got, want, scale):
    return float((got - torch.tensor(np.array(want))).abs().max()) / scale


@pytest.mark.parametrize("n_order", [8, 11, 15])
def test_startup_tables_are_jax_bits(n_order):
    disc_j, disc = jax_startup_1d(n_order, 0.0, 2 * np.pi, 5), startup_1d(n_order, 0.0,
                                                                          2 * np.pi, 5)
    assert disc.np_ == n_order + 1
    for name in ("dr", "lift", "v", "inv_v", "x", "rx", "fscale", "jac"):
        assert np.array_equal(np.asarray(getattr(disc, name)), np.asarray(getattr(disc_j, name))), name


@pytest.mark.parametrize("n_order", [8, 11, 15])
def test_plain_versions_match_xla_f64(n_order):
    """Each member of the stored, recompute and fused pipelines, and KA,
    against the XLA functions, 12 steps (checkpoint segment 4, t0 = 0.05)."""
    k, n_steps, segment, t0 = 12, 12, 4, 0.05
    disc_j, disc, dt, u0, lam = _problem(n_order, k, seed=n_order)
    ops = dg_rhs.kernel_ops(disc, A, dt, "cpu")
    u0_t, lam_t = torch.tensor(u0), torch.tensor(lam)
    traj, uf = dg_rhs.fwd_march_plain(u0_t, t0, n_steps, ops, store_trajectory=True)
    lam0, eta = dg_rhs.adj_est_stored_plain(traj, uf, lam_t, t0, ops)
    ckpts, uf_c = dg_rhs.fwd_march_plain(u0_t, t0, n_steps, ops, checkpoint_every=segment)
    recomputed = dg_rhs.adj_est_recompute_plain(ckpts, lam_t, t0, segment, ops)
    lam_ka = dg_rhs.adj_march_plain(lam_t, n_steps, ops)
    # the schedules cut into three tiles with their ghost rules
    fwd_plan, rev_plan = _plan(k, 2, 10, 4), _plan(k, 1, 20, 5)
    traj_f, uf_f = dg_rhs.fwd_march_fused_plain(u0_t, t0, n_steps, ops, fwd_plan, 1)
    fused = dg_rhs.adj_est_stored_fused_plain(traj_f, uf_f, lam_t, t0, ops, rev_plan)
    fused_r = dg_rhs.adj_est_recompute_fused_plain(ckpts, lam_t, t0, segment, ops, rev_plan)
    lam_ka_f = dg_rhs.adj_march_fused_plain(lam_t, n_steps, ops, fwd_plan)
    assert torch.equal(uf_c, uf) and torch.equal(traj_f, traj) and torch.equal(uf_f, uf)
    jops = advec_operators(disc_j, a=A, dtype=jnp.float64)
    for j in range(B):
        ref = advec_fwd_adj_estimate(jops, disc_j, jnp.asarray(u0[:, j]), dt, n_steps,
                                     segment=segment, t0=t0, lam_end=jnp.asarray(lam[:, j]))
        ref_ka = advec_adjoint_march(jops, jnp.asarray(lam[:, j]), dt, n_steps)
        umax, lmax = float(np.abs(ref.u_final).max()), float(np.abs(ref.lam0).max())
        assert _scaled(uf[:, j], ref.u_final, umax) <= 1e-12
        for lam_got, eta_got in ((lam0, eta), recomputed, fused, fused_r):
            assert _scaled(lam_got[:, j], ref.lam0, lmax) <= 1e-12
            assert _scaled(eta_got[j], ref.eta, lmax * float(np.abs(u0).max())) <= 1e-12
        for got in (lam_ka, lam_ka_f):
            assert _scaled(got[:, j], ref_ka, float(np.abs(ref_ka).max())) <= 1e-12


def test_effectivity_identity_f64():
    """Σ η = J(u_dt) − J(u_dt/2) to 1e-10 relative at N = 8 (J = ∫λ_end·u
    with the noisy cotangent), through the batched entry point; at the step
    0.75·x_min/a with unit nodal noise the gap is ~1e-4, far above the
    float64 roundoff of the O(1) J values."""
    k, n_steps = 10, 16
    _, disc, dt, u0, lam = _problem(8, k, cfl=0.75, noise=1.0, seed=5)
    run = dg_rhs.make_cuda_fwd_adj_estimate_grid_batched(disc, A, dt, n_steps, B, "cpu",
                                                         store_trajectory=True)
    lam_t = torch.tensor(lam)
    uf, _, eta = run(torch.tensor(u0), 0.0, lam_t)
    _, uf_half = dg_rhs.fwd_march_plain(torch.tensor(u0), 0.0, 2 * n_steps,
                                        dg_rhs.kernel_ops(disc, A, dt / 2, "cpu"))
    for j in range(B):
        gap = float(torch.sum(lam_t[:, j] * uf[:, j]) - torch.sum(lam_t[:, j] * uf_half[:, j]))
        assert abs(gap) > 1e-5
        assert abs(float(eta[j].sum()) - gap) <= 1e-10 * abs(gap)


@pytest.mark.parametrize("kernel", ["K1", "K2", "KA"])
def test_ghost_cones_at_np12(kernel):
    """At N = 11 the cones are those of N ≤ 7, counted in elements:
    K1's and KA's 5 stages a step couple ±1 element each (W ≥ 5·s_f), K2's
    λ loses an element a stage over 10 transposed stages a step (the
    cone 10·s_f; the plans keep 10·s_f + 10). W one short moves a local
    element at both edges of the middle tile; W at the cone gives the
    untiled bits. A large step (3·x_min/a) keeps the edge's error above
    rounding."""
    k, s_f, n_steps = 36, 1, 2
    _, disc, dt, u0, lam = _problem(11, k, graded=False, cfl=3.0)
    ops = dg_rhs.kernel_ops(disc, A, dt, "cpu")
    u0, lam = torch.tensor(u0), torch.tensor(lam)
    traj, uf = dg_rhs.fwd_march_plain(u0, 0.0, n_steps, ops, store_trajectory=True)
    if kernel == "K1":
        cone, want = 5 * s_f, uf

        def run(plan):
            return dg_rhs.fwd_march_fused_plain(u0, 0.0, n_steps, ops, plan, 1)[1]
    elif kernel == "KA":
        cone, want = 5 * s_f, dg_rhs.adj_march_plain(lam, n_steps, ops)

        def run(plan):
            return dg_rhs.adj_march_fused_plain(lam, n_steps, ops, plan)
    else:
        cone, want = 10 * s_f, dg_rhs.adj_est_stored_plain(traj, uf, lam, 0.0, ops)[0]

        def run(plan):
            return dg_rhs.adj_est_stored_fused_plain(traj, uf, lam, 0.0, ops, plan)[0]
    assert bool(torch.isfinite(want).all())
    for ghost, exact in ((cone - 1, False), (cone, True)):
        got = run(_plan(k, s_f, ghost, 12))
        assert torch.equal(got, want) == exact, ghost
        if not exact:  # both edges of the middle tile move
            moved = (got != want).any(dim=(0, 1))
            assert bool(moved[12]) and bool(moved[23])


def test_kernel_tolerance_bites_at_np12():
    """chip_smoke.py's tolerances at N = 11 over 16 steps: the float32 plain
    run (another rounding of the same arithmetic, as the kernel is) stays
    within it of the float64 run; it grows as Np/8 over the bound of Np ≤ 8;
    it has teeth in every output; and K1 on tiles with no ghost window (a
    halo fault) lands outside it in float32."""
    k, n_steps = 16, 16
    _, disc, dt, u0, lam = _problem(11, k, graded=False, seed=7)
    ops = dg_rhs.kernel_ops(disc, A, dt, "cpu")
    lam_t = torch.tensor(lam)
    traj, uf = dg_rhs.fwd_march_plain(torch.tensor(u0), 0.0, n_steps, ops, True)
    lam0, eta = dg_rhs.adj_est_stored_plain(traj, uf, lam_t, 0.0, ops)
    u32 = torch.tensor(u0, dtype=torch.float32)
    traj32, uf32 = dg_rhs.fwd_march_plain(u32, 0.0, n_steps, ops, True)
    lam032, eta32 = dg_rhs.adj_est_stored_plain(traj32, uf32, lam_t.float(), 0.0, ops)
    tol = tolerances(n_steps, disc.np_, uf, lam_t)
    old = tolerances(n_steps, 8, uf, lam_t)
    assert tol["u"] == pytest.approx(1.5 * old["u"]) and tol["lam"] == pytest.approx(1.5 * old["lam"])
    for key, f32, f64 in (("u", uf32, uf), ("lam", lam032, lam0), ("eta", eta32, eta)):
        assert float((f32.double() - f64).abs().max()) <= tol[key], key
        assert bool((f64.abs() > tol[key]).any()), key
    no_halo = dg_rhs.fwd_march_fused_plain(u32, 0.0, n_steps, ops, _plan(k, 4, 0, 4), 1)[1]
    assert float((no_halo.double() - uf).abs().max()) > tol["u"]


def test_high_orders_take_node_parallel_plans():
    """kernel_ops takes Np 9-16 (N = 8-15); the plan functions return plans
    the kernels' checks take there (K1 and KA on 512 or 1024 threads, K2
    and K2r on 512, whose registers hold Np 9-16; the ghost rules), and
    Np ≤ 8 keeps the plans the Np ≤ 8 model picks; Np = 17 raises naming the
    cap."""
    for n_order in range(8, 16):
        disc = startup_1d(n_order, 0.0, 2 * np.pi, 4)
        assert dg_rhs.kernel_ops(disc, A, 1e-3, "cpu").np_ == n_order + 1
    for np_ in range(9, 17):
        for k, b, n in ((10_000, 8, 2048), (512, 1, 5462), (40, 2, 13), (100_000, 1, 128)):
            fwd = dg_rhs.forward_plan(k, b, np_, n, 1)
            adj = dg_rhs.adjoint_plan(k, b, np_, n)
            rev = dg_rhs.stored_plan(k, b, np_, n)
            rec = dg_rhs.recompute_plan(k, b, np_, 4, n - n % 4 or 4)
            for plan in (fwd, adj, rev, rec):
                assert plan.threads in dg_rhs.FUSED_THREADS
                assert min(plan.tile + 2 * plan.ghost, k) <= plan.threads
                assert plan.n_tiles == -(-k // plan.tile) and plan.segment >= 1
            for plan in (fwd, adj):
                assert plan.ghost >= 5 * plan.segment or plan.tile >= k
            for plan in (rev, rec):
                assert plan.ghost >= 10 * plan.segment + 10 and plan.threads == 512
    assert dg_rhs.forward_plan(10_000, 8, 9, 2048, 1) == dg_rhs.FusedPlan(16, 80, 625, 16, 1024)
    assert dg_rhs.stored_plan(10_000, 8, 9, 2048) == dg_rhs.FusedPlan(4, 50, 313, 32, 512)
    assert dg_rhs.stored_plan(10_000, 8, 3, 2048) == dg_rhs.FusedPlan(8, 90, 625, 16, 1024)
    with pytest.raises(ValueError, match="MAX_NP = 16"):
        dg_rhs.kernel_ops(startup_1d(16, 0.0, 2 * np.pi, 4), A, 1e-3, "cpu")
