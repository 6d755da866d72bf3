"""The port's Burgers strand against the JAX package, on the CPU:

- ``march/burgers.py`` (rhs, limited march) against the JAX XLA march in
  float64, for the ΠN, Π¹ and no limiter, uniform and graded meshes, at
  rtol 1e-12 / atol 1e-13 (tests/test_pallas.py:629's tolerance): both sum
  the same float64 products in different orders, and the limiter's sign and
  threshold tests see the same values up to roundoff;
- the B1 entry points (ops/cuda/burgers.py) on CPU tensors, i.e. the
  kernel's plain version, against the same XLA march, and once against the
  Pallas kernel itself in interpret mode (K = 64, B = 8, 32 steps, as
  test_pallas.py:596), at the same tolerance;
- the four properties of tests/test_burgers.py on the port: conservation,
  characteristics before the shock, a bounded shock, and the unlimited march
  blowing up where the limited one survives. The characteristics and the
  two shock properties run at dt = 2e-3 (CFL ≈ 0.13 on the smallest node
  spacing at K = 48, N = 4) instead of the JAX tests' 2e-4, so that they
  take 250-1,000 steps, not 2,500-10,000; they hold at either step;
- the drivers: ``burgers_dg`` and ``advec_dg --limiter n|1`` on the CPU
  against the JAX drivers, and the refusals.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from adjoint_ode_adaptivity_tpu.drivers import advec_dg as jax_advec_dg
from adjoint_ode_adaptivity_tpu.drivers import burgers_dg as jax_burgers_dg
from adjoint_ode_adaptivity_tpu.march import burgers as jb
from adjoint_ode_adaptivity_tpu.ops import startup_1d as jax_startup_1d
from adjoint_ode_adaptivity_tpu_torch import interop
from adjoint_ode_adaptivity_tpu_torch.drivers import advec_dg, burgers_dg
from adjoint_ode_adaptivity_tpu_torch.march import burgers as tb
from adjoint_ode_adaptivity_tpu_torch.ops.cuda import burgers as cb
from adjoint_ode_adaptivity_tpu_torch.ops.operators import mass_matrix

torch.set_num_threads(1)  # one intra-op thread a process: the suite runs in xdist workers

F64 = torch.float64
RTOL, ATOL = 1e-12, 1e-13


def _disc(n_order, k, graded=False):
    vx = 2 * np.pi * np.linspace(0.0, 1.0, k + 1) ** 1.6 if graded else None
    disc_j = jax_startup_1d(n_order, 0.0, 2 * np.pi, k, vx=vx)
    return disc_j, interop.discretization_from_numpy(disc_j._asdict())


def _batch(disc, b, seed):
    """test_pallas.py:612-619's batched ICs, (Np, B, K)."""
    rng = np.random.default_rng(seed)
    x = np.asarray(disc.x)
    return np.stack([(0.5 + 0.4 * ph) * np.sin(x) + 0.1 * ph for ph in rng.uniform(0, 1, b)], axis=1)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL, atol=ATOL)


# uniform: test_pallas.py:608-611; graded: test_pallas.py:736-738
CASES = {False: (64, 32, 2e-4), True: (24, 16, 5e-5)}


@pytest.fixture(scope="module", params=[False, True], ids=["uniform", "graded"])
def mesh(request):
    k, n_steps, dt = CASES[request.param]
    disc_j, disc = _disc(2, k, request.param)
    return disc_j, disc, n_steps, dt, _batch(disc, 8, seed=5)


def test_rhs_matches_jax(mesh):
    disc_j, disc, _, _, u0b = mesh
    got = tb.burgers_rhs(tb.burgers_operators(disc, F64, "cpu"), torch.tensor(u0b[:, 0]))
    want = jb.burgers_rhs(jb.burgers_operators(disc_j, jnp.float64), jnp.asarray(u0b[:, 0]))
    _close(got.numpy(), want)


@pytest.mark.parametrize("limiter", ["n", "1", "none"])
def test_march_and_b1_plain_version_match_the_xla_march(mesh, limiter):
    """Members 0, 3, 6: the eager march and B1's entry point on a CPU
    tensor (the plain version) against the JAX XLA march."""
    disc_j, disc, n_steps, dt, u0b = mesh
    ops_t = tb.burgers_operators(disc, F64, "cpu")
    ops_j = jb.burgers_operators(disc_j, jnp.float64)
    run = cb.make_cuda_burgers_march(disc, dt, n_steps, batch=8, limiter=limiter, device="cpu")
    launches = cb.burgers_march.launches
    got_b = run(torch.tensor(u0b))
    assert cb.burgers_march.launches == launches  # the plain version launches nothing
    for j in range(0, 8, 3):
        want = jb.burgers_march(ops_j, jnp.asarray(u0b[:, j]), dt, n_steps, limiter=limiter)
        _close(tb.burgers_march(ops_t, torch.tensor(u0b[:, j]), dt, n_steps, limiter=limiter), want)
        _close(got_b[:, j], want)
    single = cb.make_cuda_burgers_march_single(disc, dt, n_steps, limiter, "cpu")
    _close(single(torch.tensor(u0b[:, 0])), got_b[:, 0])


def test_b1_plain_version_matches_the_pallas_kernel():
    """The one interpret-mode call: test_pallas.py:596's configuration."""
    from adjoint_ode_adaptivity_tpu.ops.pallas.burgers import make_pallas_burgers_march

    disc_j, disc = _disc(2, 64)
    u0b = _batch(disc, 8, seed=5)
    want = make_pallas_burgers_march(disc_j, 2e-4, 32, batch=8, steps_per_chunk=8,
                                     limiter="n", interpret=True)(jnp.asarray(u0b))
    got = cb.make_cuda_burgers_march(disc, 2e-4, 32, batch=8, limiter="n", device="cpu")(
        torch.tensor(u0b))
    _close(got, want)


def test_b1_float32_plain_version_stays_near_float64():
    """The float32 plain version (the card's kernel type) before the shock:
    within a few hundred ulp of the float64 march over 32 steps."""
    _, disc = _disc(2, 64)
    u0b = _batch(disc, 8, seed=5)
    tab = cb.burgers_tables(disc, 2e-4, "n", "cpu")
    u64 = cb.burgers_march(torch.tensor(u0b), 32, tab)
    u32 = cb.burgers_march(torch.tensor(u0b, dtype=torch.float32), 32, tab)
    assert u32.dtype == torch.float32
    assert float((u32.double() - u64).abs().max()) < 256 * 2.0**-23


def test_b1_wrapper_refuses_what_the_kernel_does_not_take():
    _, disc = _disc(2, 16)
    tab = cb.burgers_tables(disc, 1e-3, "n", "cpu")
    u = torch.zeros((3, 2, 16), dtype=F64)
    with pytest.raises(ValueError, match="shape"):
        cb.burgers_march(u[:, :, :8], 4, tab)
    with pytest.raises(TypeError, match="dtype"):
        cb.burgers_march(u.half(), 4, tab)
    with pytest.raises(ValueError, match="limiter"):
        cb.burgers_tables(disc, 1e-3, "tvb", "cpu")
    with pytest.raises(ValueError, match="Np"):
        cb.burgers_tables(_disc(16, 4)[1], 1e-3, "n", "cpu")
    with pytest.raises(ValueError, match="expected"):
        cb.make_cuda_burgers_march(disc, 1e-3, 4, batch=3, device="cpu")(u)


# ------------------------------------------------ tests/test_burgers.py's properties


def test_conservation():
    """Periodic Burgers conserves the cell-average integral exactly."""
    _, disc = _disc(2, 32)
    ops = tb.burgers_operators(disc, F64, "cpu")
    u0 = torch.tensor(0.5 + np.sin(disc.x))
    w = torch.tensor(np.sum(mass_matrix(disc.v), axis=0)[:, None] * disc.jac)
    u = tb.burgers_march(ops, u0, 5e-4, 400, limiter="n")
    total0, total = float(torch.sum(w * u0)), float(torch.sum(w * u))
    assert abs(total - total0) < 1e-8 * abs(total0) + 1e-10


def test_smooth_solution_matches_characteristics():
    """Pre-shock, Burgers follows characteristics: u = u0(x − u t)."""
    _, disc = _disc(3, 48)
    ops = tb.burgers_operators(disc, F64, "cpu")
    u0 = torch.tensor(0.5 + 0.2 * np.sin(disc.x))
    t_end, dt = 0.5, 2e-3
    u = tb.burgers_march(ops, u0, dt, int(round(t_end / dt)), limiter="none").numpy()
    ue = np.full_like(disc.x, 0.5)
    for _ in range(500):
        ue = 0.5 + 0.2 * np.sin(disc.x - ue * t_end)
    assert np.max(np.abs(u - ue)) < 2e-4


@pytest.fixture(scope="module")
def shock():
    _, disc = _disc(4, 48)
    return tb.burgers_operators(disc, F64, "cpu"), torch.tensor(0.5 + np.sin(disc.x)), 2e-3


def test_shock_stays_bounded_with_limiter(shock):
    """Post-shock (t = 2, the shock forms at t = 1): the limited solution
    stays within the initial bounds up to 5e-2."""
    ops, u0, dt = shock
    u = tb.burgers_march(ops, u0, dt, int(round(2.0 / dt)), limiter="n")
    assert bool(torch.isfinite(u).all())
    assert float(u.max() - u0.max()) < 5e-2 and float(u0.min() - u.min()) < 5e-2


def test_unlimited_blows_up_limited_survives(shock):
    ops, u0, dt = shock
    n = int(round(1.5 / dt))
    assert bool(torch.isfinite(tb.burgers_march(ops, u0, dt, n, limiter="n")).all())
    assert not bool(torch.isfinite(tb.burgers_march(ops, u0, dt, n, limiter="none")).all())


# ------------------------------------------------------------------- drivers


@pytest.mark.parametrize("limiter", ["n", "none"])
def test_burgers_driver_matches_the_jax_driver(capsys, limiter):
    argv = ["--k", "16", "--order", "3", "--final-time", "0.02", "--limiter", limiter]
    want = jax_burgers_dg.main(argv)
    want_line = capsys.readouterr().out
    got = burgers_dg.main(argv + ["--device", "cpu"])
    got_line = capsys.readouterr().out
    assert got.dtype == F64
    _close(got.numpy(), want)
    assert got_line == want_line and "finite=True" in got_line


@pytest.mark.parametrize("limiter", ["n", "1"])
def test_advec_driver_limiter_matches_the_jax_driver(capsys, limiter):
    argv = ["--k", "10", "--order", "2", "--final-time", "0.5", "--x64"]
    want = jax_advec_dg.main(argv + ["--limiter", limiter])
    want_out = capsys.readouterr().out
    got = advec_dg.main(argv + ["--limiter", limiter, "--device", "cpu"])
    assert capsys.readouterr().out == want_out
    np.testing.assert_allclose(got, want, rtol=1e-10)
    assert got != advec_dg.main(argv + ["--device", "cpu"])  # the limiter acts


def test_driver_refusals():
    with pytest.raises(SystemExit):
        burgers_dg.main(["--kernel", "cuda", "--device", "cpu"])
    with pytest.raises(SystemExit):
        burgers_dg.main(["--kernel", "cuda", "--x64"])
    with pytest.raises(SystemExit):
        advec_dg.main(["--kernel", "cuda", "--limiter", "n"])


def test_entry_points_default_to_the_card():
    _, disc = _disc(2, 16)
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the no-GPU error path cannot run here")
    for build in (lambda: tb.burgers_operators(disc), lambda: cb.burgers_tables(disc, 1e-3),
                  lambda: cb.make_cuda_burgers_march(disc, 1e-3, 4),
                  lambda: cb.make_cuda_burgers_march_single(disc, 1e-3, 4),
                  lambda: burgers_dg.main(["--k", "8", "--final-time", "0.01"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build()
