"""The port's FD adaptive loops and driver against the JAX package, float64
on the CPU: the single run (J=∫u² and J=u_N), the backtrack schedules, the
per-member study on both engines (the cuda engine runs its kernel's plain
version on a CPU device), the device loop (bit-equal to the host loop),
checkpoint resume, and the ``fd_adaptive`` driver on ``--device cpu``.

Tolerance: both packages bisect the same steps, so grids are compared to
1e-12 (tests/test_device_loop.py:248's bound for its two engines) and the
estimates to float64 roundoff."""
import numpy as np
import pytest
import torch

from adjoint_ode_adaptivity_tpu import odes as jodes
from adjoint_ode_adaptivity_tpu.adapt import fd_loop as jloop
from adjoint_ode_adaptivity_tpu.march import euler_step as jeuler
from adjoint_ode_adaptivity_tpu_torch import odes
from adjoint_ode_adaptivity_tpu_torch.adapt import fd_loop
from adjoint_ode_adaptivity_tpu_torch.drivers import fd_adaptive
from adjoint_ode_adaptivity_tpu_torch.march.fd import euler_step

torch.set_num_threads(1)  # one intra-op thread a process: the suite runs in xdist workers

SIN_J = jodes.get_ode("du/dt=sin(u)")
SIN = odes.get_ode("du/dt=sin(u)")
CPU = dict(dtype=torch.float64, device="cpu")
ATOL = 1e-12


def _jstep():
    return jeuler(SIN_J.f)


def _step():
    return euler_step(SIN.f)


@pytest.mark.parametrize("functional", ["J=int(u^2)", "J=u_N"])
def test_run_adaptive_fd_matches_jax(functional):
    kw = dict(n_steps0=2, functional_name=functional, ref_factor=4, tol=1e-4, maxit=8)
    ref = jloop.run_adaptive_fd(_jstep(), 1.0, (0.0, 2.0), **kw)
    seen = []
    ours = fd_loop.run_adaptive_fd(_step(), 1.0, (0.0, 2.0), callback=seen.append, **kw, **CPU)
    assert len(ours) == len(ref) == len(seen) == 9
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(a.times_used.numpy(), np.asarray(b.times_used), rtol=0, atol=ATOL)
        np.testing.assert_allclose(a.state.times.numpy(), np.asarray(b.state.times), rtol=0, atol=ATOL)
        assert int(a.n_steps_used) == int(b.n_steps_used)
        assert int(a.state.n_active) == int(b.state.n_active) and int(a.state.it) == int(b.state.it)
        np.testing.assert_allclose(a.u.numpy(), np.asarray(b.u), rtol=1e-13)
        np.testing.assert_allclose(a.v.numpy(), np.asarray(b.v), rtol=0, atol=ATOL)
        np.testing.assert_allclose(a.err_steps.numpy(), np.asarray(b.err_steps), rtol=0, atol=ATOL)
        np.testing.assert_allclose(float(a.err_total), float(b.err_total), rtol=0, atol=ATOL)
        np.testing.assert_allclose(float(a.j_coarse), float(b.j_coarse), rtol=1e-13)
    assert float(ours[-1].err_total) < float(ours[0].err_total)


@pytest.mark.parametrize("schedule", ["padded", "dynamic"])
def test_backtrack_schedules_match_jax(schedule):
    """tests/test_fd_adjoint.py's merge-parity configuration (coarsening
    fires repeatedly): the same actions, totals and grids."""
    kw = dict(n_steps0=6, maxit=8, tol=1e-12, coarsen_tol=0.03)
    name = "run_adaptive_fd_backtrack" + ("_padded" if schedule == "padded" else "")
    ref = getattr(jloop, name)(_jstep(), 1.0, (0.0, 2.0), **kw)
    ours = getattr(fd_loop, name)(_step(), 1.0, (0.0, 2.0), **kw, **CPU)
    assert [r["action"] for r in ours] == [r["action"] for r in ref]
    np.testing.assert_allclose([r["total"] for r in ours], [r["total"] for r in ref], rtol=1e-10)
    for a, b in zip(ours, ref):
        if "times" in a:
            np.testing.assert_allclose(a["times"], b["times"], rtol=0, atol=ATOL)
    sizes = [len(r["times"]) for r in ours if "err_steps" in r]
    assert any(b <= a for a, b in zip(sizes, sizes[1:])), sizes  # a merge happened


PM_KW = dict(n_steps0=2, tol=0.15, maxit=4)
U0S = np.random.default_rng(7).uniform(0.5, 2.0, 8)


@pytest.fixture(scope="module")
def jax_per_member():
    """The JAX package's per-member study at B = 8: xla and (interpret-mode)
    pallas engines."""
    xla = jloop.run_adaptive_fd_per_member(_jstep(), U0S, (0.0, 2.0), **PM_KW)
    pallas = jloop.run_adaptive_fd_per_member(_jstep(), U0S, (0.0, 2.0), engine="pallas",
                                              ode_f=SIN_J.f, **PM_KW)
    return {"torch": xla, "cuda": pallas}


@pytest.mark.parametrize("engine", ["torch", "cuda"])
def test_per_member_study_matches_jax(engine, jax_per_member):
    """torch engine vs the xla engine; cuda engine (its kernel's plain
    version here) vs the pallas engine."""
    ref = jax_per_member[engine]
    ours = fd_loop.run_adaptive_fd_per_member(_step(), U0S, (0.0, 2.0), engine=engine, ode=SIN,
                                              **PM_KW, **CPU)
    assert len(ours) == len(ref) >= 2
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(a.times, b.times, rtol=0, atol=ATOL)
        np.testing.assert_array_equal(a.n_active, b.n_active)
        np.testing.assert_allclose(a.err_steps, b.err_steps, rtol=0, atol=ATOL)
        np.testing.assert_allclose(a.err_total, b.err_total, rtol=0, atol=ATOL)
        np.testing.assert_allclose(a.j_coarse, b.j_coarse, rtol=0, atol=ATOL)
        assert a.n_refining == b.n_refining


@pytest.mark.parametrize("engine", ["torch", "cuda"])
def test_per_member_study_from_a_later_start_matches_jax(engine):
    """A time-dependent RHS on t_span = (0.5, 2.5): both engines take the
    start time from t_span[0] (the cuda engine as the kernel's t0), held
    against the xla engine, whose march starts at the grid's first node."""
    name, span = "du/dt=t*sin(u)", (0.5, 2.5)
    ref = jloop.run_adaptive_fd_per_member(jeuler(jodes.get_ode(name).f), U0S, span, **PM_KW)
    ode = odes.get_ode(name)
    ours = fd_loop.run_adaptive_fd_per_member(euler_step(ode.f), U0S, span, engine=engine,
                                              ode=ode, **PM_KW, **CPU)
    assert len(ours) == len(ref) >= 2
    assert ours[0].times[0, 0] == 0.5
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(a.times, b.times, rtol=0, atol=ATOL)
        np.testing.assert_array_equal(a.n_active, b.n_active)
        np.testing.assert_allclose(a.err_steps, b.err_steps, rtol=0, atol=ATOL)
        np.testing.assert_allclose(a.j_coarse, b.j_coarse, rtol=0, atol=ATOL)
        assert a.n_refining == b.n_refining


def _assert_histories_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        for fx, fy in zip(x, y):
            if isinstance(fx, tuple):  # AdaptResult.state
                _assert_histories_equal([fx], [fy])
            elif isinstance(fx, torch.Tensor):
                assert torch.equal(fx, fy)
            else:
                np.testing.assert_array_equal(fx, fy)


def test_device_loop_is_bit_equal_to_the_host_loop():
    kw = dict(n_steps0=2, tol=0.2, maxit=12)  # stops before maxit: a trimmed trip
    host = fd_loop.run_adaptive_fd(_step(), 1.0, (0.0, 2.0), **kw, **CPU)
    dev = fd_loop.run_adaptive_fd(_step(), 1.0, (0.0, 2.0), device_loop=True, **kw, **CPU)
    assert len(host) < 13
    _assert_histories_equal(dev, host)
    for engine in ("torch", "cuda"):
        pm = dict(engine=engine, ode=SIN, tol=0.15, maxit=12)  # every member freezes
        host = fd_loop.run_adaptive_fd_per_member(_step(), U0S, (0.0, 2.0), **pm, **CPU)
        dev = fd_loop.run_adaptive_fd_per_member(_step(), U0S, (0.0, 2.0), device_loop=True,
                                                 **pm, **CPU)
        assert host[-1].n_refining == 0 and len(host) < 13
        _assert_histories_equal(dev, host)


@pytest.mark.parametrize("device_loop", [False, True])
def test_checkpoint_resume_reproduces_the_history(tmp_path, device_loop):
    kw = dict(n_steps0=2, tol=0.0, max_nodes=2 + 6 + 2, device_loop=device_loop, **CPU)
    full = fd_loop.run_adaptive_fd(_step(), 1.0, (0.0, 2.0), maxit=6, **kw)
    ck = str(tmp_path / "fd")
    first = fd_loop.run_adaptive_fd(_step(), 1.0, (0.0, 2.0), maxit=2, checkpoint_dir=ck, **kw)
    assert len(first) == 3
    resumed = fd_loop.run_adaptive_fd(_step(), 1.0, (0.0, 2.0), maxit=6, checkpoint_dir=ck, **kw)
    _assert_histories_equal(resumed, full)

    pm = dict(engine="cuda", ode=SIN, tol=0.15, device_loop=device_loop, **CPU)
    full = fd_loop.run_adaptive_fd_per_member(_step(), U0S, (0.0, 2.0), maxit=8, **pm)
    ck = str(tmp_path / "fd_pm")
    fd_loop.run_adaptive_fd_per_member(_step(), U0S, (0.0, 2.0), maxit=2, checkpoint_dir=ck, **pm)
    resumed = fd_loop.run_adaptive_fd_per_member(_step(), U0S, (0.0, 2.0), maxit=8,
                                                 checkpoint_dir=ck, **pm)
    _assert_histories_equal(resumed, full)
    again = fd_loop.run_adaptive_fd_per_member(_step(), U0S, (0.0, 2.0), maxit=8,
                                               checkpoint_dir=ck, **pm)
    _assert_histories_equal(again, full)  # already complete: returned as restored


def test_per_member_cuda_engine_refuses_what_its_kernel_cannot_run():
    kw = dict(engine="cuda", maxit=1, **CPU)
    with pytest.raises(ValueError, match="ode="):
        fd_loop.run_adaptive_fd_per_member(_step(), U0S, (0.0, 2.0), **kw)
    # an ODEProblem without a kernel_id (or ode_f) is traced: a reduction is not elementwise
    untraceable = odes.ODEProblem("du/dt=-sum(u)", lambda u, t: -torch.sum(u) * u)
    with pytest.raises(ValueError, match="cannot trace.*torch.sum"):
        fd_loop.run_adaptive_fd_per_member(_step(), U0S, (0.0, 2.0), ode=untraceable, **kw)
    with pytest.raises(ValueError, match="cannot trace.*torch.sum"):
        fd_loop.run_adaptive_fd_per_member(_step(), U0S, (0.0, 2.0), ode_f=untraceable.f, **kw)
    with pytest.raises(ValueError, match="J=int"):
        fd_loop.run_adaptive_fd_per_member(_step(), U0S, (0.0, 2.0), ode=SIN,
                                           functional_name="J=u_N", **kw)
    with pytest.raises(ValueError, match="engine"):
        fd_loop.run_adaptive_fd_per_member(_step(), U0S, (0.0, 2.0), engine="pallas",
                                           device="cpu")


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the no-GPU error path cannot run here")
    for run in (
        lambda: fd_loop.run_adaptive_fd(_step(), 1.0, (0.0, 2.0), maxit=1),
        lambda: fd_loop.run_adaptive_fd_per_member(_step(), U0S, (0.0, 2.0), maxit=1),
        lambda: fd_loop.run_adaptive_fd_backtrack_padded(_step(), 1.0, (0.0, 2.0), maxit=1),
        lambda: fd_adaptive.main(["--maxit", "1"]),
    ):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run()


def test_driver_on_the_cpu(capsys, tmp_path):
    hist = fd_adaptive.main(["--device", "cpu", "--maxit", "3", "--x64"])
    assert len(hist) == 4 and hist[0].u.dtype == torch.float64
    assert "finished after 4 iterations" in capsys.readouterr().out
    hist = fd_adaptive.main(["--device", "cpu", "--ensemble", "8", "--maxit", "3", "--tol", "0",
                             "--device-loop", "--checkpoint-dir", str(tmp_path / "ck")])
    out = capsys.readouterr().out
    assert len(hist) == 4 and "engine=torch" in out and "refining=8/8" in out
    hist = fd_adaptive.main(["--device", "cpu", "--schedule", "backtrack", "--maxit", "3",
                             "--functional", "J=u_N"])
    assert hist[0]["action"] == "accept" and "final Σerr" in capsys.readouterr().out


def test_driver_engine_choice(capsys):
    with pytest.raises(SystemExit):  # --device cpu takes --engine torch only
        fd_adaptive.main(["--device", "cpu", "--ensemble", "8", "--engine", "cuda"])
    with pytest.raises(SystemExit):
        fd_adaptive.main(["--device", "cpu", "--engine", "nope"])
    args = fd_adaptive.argparse.Namespace(functional="J=u_N", x64=False)
    cuda = torch.device("cuda")
    # on the card the default engine is cuda, and switches to torch (saying
    # why) only where the kernel cannot run the study
    assert fd_adaptive._default_engine(args, SIN, cuda) == "torch"
    assert "J=int(u^2) only" in capsys.readouterr().out
    args.functional = "J=int(u^2)"
    assert fd_adaptive._default_engine(args, SIN, cuda) == "cuda"
    assert fd_adaptive._default_engine(args, SIN, torch.device("cpu")) == "torch"
    args.x64 = True
    assert fd_adaptive._default_engine(args, SIN, cuda) == "torch"
