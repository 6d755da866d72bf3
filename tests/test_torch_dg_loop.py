"""The port's DG-in-time adaptive loops and ``dg_adaptive`` driver against
the JAX package on the CPU: the single run (dynamic, padded, device loop,
Radau reconstruction; float64, 1e-12), the ensemble and per-member loops
(torch engine in float64; the cuda engine's plain version in float32), the
device loop (bit-equal to the host loop), checkpoint resume, and the
driver's lines.

The JAX single run is taken in its padded mode, which compiles once; a
zero-width padding slab changes no value, so it is the reference of the
dynamic mode too. Tolerance: the same float64 operations in another order,
so partitions are equal and values agree to 1e-12."""
import io
import re
from contextlib import redirect_stdout

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adjoint_ode_adaptivity_tpu.adapt import dg_loop as jloop
from adjoint_ode_adaptivity_tpu.drivers import dg_adaptive as jdriver
from adjoint_ode_adaptivity_tpu_torch import odes
from adjoint_ode_adaptivity_tpu_torch.adapt import dg_loop
from adjoint_ode_adaptivity_tpu_torch.drivers import dg_adaptive

torch.set_num_threads(1)  # one intra-op thread a process: the suite runs in xdist workers

SIN = odes.get_ode("du/dt=sin(u)")
F_J = lambda u, t: jnp.sin(u)  # noqa: E731
CPU = dict(dtype=torch.float64, device="cpu")
ATOL = 1e-12
B = 16
Y0S = np.random.default_rng(3).uniform(0.5, 2.0, B)


def _assert_histories_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        for fx, fy in zip(x, y):
            np.testing.assert_array_equal(fx, fy)


@pytest.fixture(scope="module")
def jax_single():
    """The JAX package's default study (sin u, y0 = 1, t ∈ [0, 2], order 1,
    k0 = 2, tol 1e-5), padded, solve and reconstruct."""
    kw = dict(padded=True, maxit=30)
    return {mode: jloop.run_adaptive_dg(F_J, 1.0, (0.0, 2.0), adjoint_mode=mode, **kw)
            for mode in ("solve", "reconstruct")}


@pytest.mark.parametrize("mode", ["dynamic", "padded", "device_loop", "reconstruct"])
def test_single_run_matches_jax(mode, jax_single):
    kw = dict(padded=mode != "dynamic", device_loop=mode == "device_loop",
              adjoint_mode="reconstruct" if mode == "reconstruct" else "solve")
    ref = jax_single[kw["adjoint_mode"]]
    seen = []
    ours = dg_loop.run_adaptive_dg(SIN.f, 1.0, (0.0, 2.0), f_u=SIN.f_u, callback=seen.append,
                                   **kw, **CPU)
    assert len(ours) == len(ref) == len(seen)
    if mode != "reconstruct":  # the default run (dg_adaptive --maxit 30)
        assert len(ours) == 10 and len(ours[-1].times) - 1 == 11
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a.times, np.asarray(b.times))
        for f in ("u", "v", "err"):
            np.testing.assert_allclose(getattr(a, f), np.asarray(getattr(b, f)), rtol=0, atol=ATOL)
        for f in ("j_coarse", "j_fine", "effectivity_gap", "est_total"):
            assert abs(getattr(a, f) - getattr(b, f)) <= ATOL, f
    assert abs(ours[-1].est_total) < 1e-5 < abs(ours[0].est_total)


@pytest.fixture(scope="module")
def jax_ensembles():
    kw = dict(k0=2, maxit=5, tol=0.0)
    return {name: getattr(jloop, name)(F_J, Y0S, (0.0, 2.0), **kw)
            for name in ("run_adaptive_dg_ensemble", "run_adaptive_dg_per_member")}


@pytest.mark.parametrize("name", ["run_adaptive_dg_ensemble", "run_adaptive_dg_per_member"])
def test_ensemble_loops_match_jax(name, jax_ensembles):
    """torch engine, float64, Newton to tolerance, B = 16."""
    ref = jax_ensembles[name]
    ours = getattr(dg_loop, name)(SIN.f, Y0S, (0.0, 2.0), f_u=SIN.f_u, k0=2, maxit=5, tol=0.0,
                                  **CPU)
    assert len(ours) == len(ref) == 6
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a.times, np.asarray(b.times))
        if name.endswith("per_member"):
            np.testing.assert_array_equal(a.n_active, b.n_active)
            assert a.n_refining == b.n_refining
            np.testing.assert_allclose(a.err, b.err, rtol=0, atol=ATOL)
            np.testing.assert_allclose(a.est_total, b.est_total, rtol=0, atol=ATOL)
        else:
            np.testing.assert_allclose(a.err_mean, b.err_mean, rtol=0, atol=ATOL)
            assert abs(a.est_total_mean - b.est_total_mean) <= ATOL
            assert abs(a.j_mean - b.j_mean) <= ATOL


@pytest.mark.parametrize("name", ["run_adaptive_dg_ensemble", "run_adaptive_dg_per_member"])
def test_cuda_engine_plain_version_matches_jax_partitions(name):
    """engine="cuda" on a CPU device (the kernel's plain version, float32)
    against the JAX xla engine fed float32 initial conditions, newton_iters
    8, tol 0 and four iterations: the top-two margins clear the float32
    noise, so every bisection is the same."""
    y32 = Y0S.astype(np.float32)
    kw = dict(k0=2, maxit=4, tol=0.0, newton_iters=8)
    ref = getattr(jloop, name)(F_J, y32, (0.0, 2.0), **kw)
    ours = getattr(dg_loop, name)(SIN.f, y32, (0.0, 2.0), engine="cuda", ode=SIN,
                                  dtype=torch.float32, device="cpu", **kw)
    assert len(ours) == len(ref) == 5
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a.times, np.asarray(b.times))
        if name.endswith("per_member"):
            np.testing.assert_array_equal(a.n_active, b.n_active)


def test_device_loop_is_bit_equal_to_the_host_loop():
    kw = dict(f_u=SIN.f_u, padded=True, tol=1e-4, maxit=12)  # stops before maxit
    host = dg_loop.run_adaptive_dg(SIN.f, 1.0, (0.0, 2.0), **kw, **CPU)
    dev = dg_loop.run_adaptive_dg(SIN.f, 1.0, (0.0, 2.0), device_loop=True, **kw, **CPU)
    assert len(host) < 13
    _assert_histories_equal(dev, host)
    for engine, cfg in (("torch", CPU), ("cuda", dict(dtype=torch.float32, device="cpu"))):
        # the ensemble stops on |mean Σerr| < tol; every member freezes
        for name, tol in (("run_adaptive_dg_ensemble", 2e-4), ("run_adaptive_dg_per_member", 5e-4)):
            kw = dict(f_u=SIN.f_u, k0=2, maxit=10, tol=tol, newton_iters=8, engine=engine,
                      ode=SIN, **cfg)
            host = getattr(dg_loop, name)(SIN.f, Y0S[:8], (0.0, 2.0), **kw)
            dev = getattr(dg_loop, name)(SIN.f, Y0S[:8], (0.0, 2.0), device_loop=True, **kw)
            assert len(host) < 11, (name, engine)
            _assert_histories_equal(dev, host)


@pytest.mark.parametrize("device_loop", [False, True])
def test_checkpoint_resume_reproduces_the_history(tmp_path, device_loop):
    kw = dict(f_u=SIN.f_u, padded=True, tol=0.0, device_loop=device_loop, **CPU)
    full = dg_loop.run_adaptive_dg(SIN.f, 1.0, (0.0, 2.0), maxit=5, **kw)
    ck = str(tmp_path / "single")
    assert len(dg_loop.run_adaptive_dg(SIN.f, 1.0, (0.0, 2.0), maxit=2, checkpoint_dir=ck,
                                       **kw)) == 3
    _assert_histories_equal(
        dg_loop.run_adaptive_dg(SIN.f, 1.0, (0.0, 2.0), maxit=5, checkpoint_dir=ck, **kw), full)
    for name in ("run_adaptive_dg_ensemble", "run_adaptive_dg_per_member"):
        kw = dict(f_u=SIN.f_u, k0=2, tol=0.0, newton_iters=8, device_loop=device_loop, **CPU)
        full = getattr(dg_loop, name)(SIN.f, Y0S[:8], (0.0, 2.0), maxit=5, **kw)
        ck = str(tmp_path / name)
        getattr(dg_loop, name)(SIN.f, Y0S[:8], (0.0, 2.0), maxit=2, checkpoint_dir=ck, **kw)
        resumed = getattr(dg_loop, name)(SIN.f, Y0S[:8], (0.0, 2.0), maxit=5, checkpoint_dir=ck,
                                         **kw)
        _assert_histories_equal(resumed, full)


def test_engines_refuse_what_they_cannot_run():
    kw = dict(engine="cuda", maxit=1, device="cpu", dtype=torch.float32)
    for name in ("run_adaptive_dg_ensemble", "run_adaptive_dg_per_member"):
        loop = getattr(dg_loop, name)
        # with ode=None the engine traces f (and g_u): a reduction is no elementwise op
        with pytest.raises(ValueError, match="cannot trace.*torch.sum"):
            loop(lambda u, t: torch.sum(u) * u, Y0S, (0.0, 2.0), **kw)
        with pytest.raises(ValueError, match="float32"):
            loop(SIN.f, Y0S, (0.0, 2.0), ode=SIN, **{**kw, "dtype": torch.float64})
        with pytest.raises(ValueError, match="cannot trace.*torch.sum"):
            loop(SIN.f, Y0S, (0.0, 2.0), ode=SIN, g_u=lambda u, t: torch.sum(u) * u, **kw)
        with pytest.raises(ValueError, match="engine"):
            loop(SIN.f, Y0S, (0.0, 2.0), engine="pallas", device="cpu")
    with pytest.raises(ValueError, match="padded"):
        dg_loop.run_adaptive_dg(SIN.f, 1.0, (0.0, 2.0), device_loop=True, device="cpu")
    with pytest.raises(ValueError, match="adjoint_mode"):
        dg_loop.run_adaptive_dg(SIN.f, 1.0, (0.0, 2.0), adjoint_mode="nope", device="cpu")
    if not torch.cuda.is_available():  # the entry points default to the card
        for run in (lambda: dg_loop.run_adaptive_dg(SIN.f, 1.0, (0.0, 2.0), maxit=1),
                    lambda: dg_loop.run_adaptive_dg_per_member(SIN.f, Y0S, (0.0, 2.0), maxit=1),
                    lambda: dg_adaptive.main(["--maxit", "1"])):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                run()


NUM = re.compile(r"[-+]?\d\.\d+e[-+]\d+")


def _lines_match(ours: str, ref: str):
    """Equal text, and every %.10e number within 1e-12 (values of the two
    packages differ in the last ulps; a printed JuH−Juh of 1e-5 shows them
    in its tenth digit)."""
    a, b = ours.splitlines(), ref.splitlines()
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert NUM.sub("#", x) == NUM.sub("#", y), (x, y)
        for p, q in zip(NUM.findall(x), NUM.findall(y)):
            assert abs(float(p) - float(q)) <= ATOL, (x, y)


@pytest.mark.parametrize("argv", [[], ["--ensemble", "8", "--per-member", "--maxit", "4"]])
def test_driver_prints_the_jax_drivers_lines(argv):
    ref, ours = io.StringIO(), io.StringIO()
    with redirect_stdout(ref):
        jdriver.main(argv + ([] if argv else ["--padded"]))
    with redirect_stdout(ours):
        hist = dg_adaptive.main(argv + ["--device", "cpu"])
    _lines_match(ours.getvalue(), ref.getvalue().replace("engine=xla", "engine=torch"))
    assert len(hist) == (10 if not argv else 5)


def test_driver_refuses_what_is_not_ported(capsys):
    for argv in (["--dp", "--hp", "hp"],
                 ["--device", "cpu", "--ensemble", "8", "--engine", "cuda"],
                 ["--ensemble", "8", "--engine", "cuda", "--x64"]):
        with pytest.raises(SystemExit):
            dg_adaptive.main(argv)
    err = capsys.readouterr().err
    assert "--dp requires --ensemble with --hp" in err  # the JAX driver's refusal
    assert "not ported yet" not in err  # --plot is ported (tests/test_torch_host_tools.py)
    args = dg_adaptive.argparse.Namespace(x64=None)
    cuda = torch.device("cuda")
    assert dg_adaptive._default_engine(args, SIN, cuda) == "cuda"
    assert dg_adaptive._default_engine(args, SIN, torch.device("cpu")) == "torch"
    args.x64 = True
    assert dg_adaptive._default_engine(args, SIN, cuda) == "torch"
    assert "float32" in capsys.readouterr().out
