"""The port's host tools on the CPU: ``ops/io`` (the ``.npz`` bridge, read
and written across both packages), ``drivers/sweep`` (tests/test_drivers.py's
``TestSweep`` cases against the port's launcher), ``utils/plotting`` with the
drivers' ``--plot``/``--animate`` (the JAX drivers' frame names), and
``utils/profiling``.

Every ``Discretization1D`` field must round-trip exactly (integers equal,
arrays bit-equal): the file holds float64 and int64 as written."""
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from adjoint_ode_adaptivity_tpu.ops import io as jio
from adjoint_ode_adaptivity_tpu.ops import startup_1d as j_startup
from adjoint_ode_adaptivity_tpu_torch.drivers import sweep
from adjoint_ode_adaptivity_tpu_torch.ops import io as tio
from adjoint_ode_adaptivity_tpu_torch.ops import startup_1d as t_startup
from adjoint_ode_adaptivity_tpu_torch.utils import plotting, profiling

torch.set_num_threads(1)  # one intra-op thread a process: the suite runs in xdist workers


# ----------------------------------------------------------------------- io
def same_disc(a, b):
    assert a._fields == b._fields
    for name in a._fields:
        x, y = getattr(a, name), getattr(b, name)
        if isinstance(x, int):
            assert type(y) is int and x == y, name
        else:
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=name)
            assert np.asarray(x).dtype == np.asarray(y).dtype, name


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_npz_round_trips_across_packages(writer, tmp_path):
    vx = np.concatenate([[0.0], np.cumsum(np.random.default_rng(4).uniform(0.5, 1.5, 9))])
    disc_t, disc_j = t_startup(3, 0.0, 0.0, 0, vx=vx), j_startup(3, 0.0, 0.0, 0, vx=vx)
    save, disc = (tio.save_discretization, disc_t) if writer == "port" else \
        (jio.save_discretization, disc_j)
    path = save(disc, tmp_path / "disc.npz")
    for load, ref in ((tio.load_discretization, disc_t), (jio.load_discretization, disc_j)):
        same_disc(load(path), ref)
    with np.load(path) as data:
        for key in ("rk4a", "rk4b", "rk4c"):
            np.testing.assert_array_equal(data[key], getattr(tio, key.upper()))


def test_save_text_and_suffix(tmp_path):
    """``text=True`` writes one ``.txt`` a field beside the file; a path
    without ``.npz`` gets numpy's suffix, as the JAX package returns it."""
    disc = t_startup(2, 0.0, 1.0, 4)
    got = tio.save_discretization(disc, tmp_path / "d", text=True)
    want = jio.save_discretization(j_startup(2, 0.0, 1.0, 4), tmp_path / "e", text=True)
    assert got == tmp_path / "d.npz" and want == tmp_path / "e.npz" and got.exists()
    assert sorted(p.name for p in (tmp_path / "d").iterdir()) == sorted(
        p.name for p in (tmp_path / "e").iterdir())
    same_disc(tio.load_discretization(got), disc)


# -------------------------------------------------------------------- sweep
def test_generate_commands(tmp_path):
    cmds = sweep.main(["--seeds", "1", "2", "--extra=--quiet", "--out", str(tmp_path / "cmds.txt")])
    assert len(cmds) == 2
    assert "--seed 1" in cmds[0]
    assert "-m adjoint_ode_adaptivity_tpu_torch.drivers.train_resnet_ode " in cmds[0]
    assert (tmp_path / "cmds.txt").read_text().splitlines() == cmds


def test_run_commands_parallel(tmp_path):
    """The slot scheduler overlaps runs and pins SWEEP_SLOT per process (the
    reference farm runs 4 concurrent jobs a node)."""
    script = (
        "import os,time,sys; time.sleep(0.6); "
        f"open(r'{tmp_path}'+'/slot_'+os.environ['SWEEP_SLOT']+'_'"
        "+sys.argv[1],'w').close()"
    )
    cmds = [f'{sys.executable} -S -c "{script}" {i}' for i in range(4)]
    t0 = time.monotonic()
    codes = sweep.run_commands(cmds, parallel=4)
    elapsed = time.monotonic() - t0
    assert codes == [0, 0, 0, 0]
    # 4 × 0.6 s one after another would be ≥ 2.4 s
    assert elapsed < 2.3, elapsed
    made = sorted(p.name for p in tmp_path.glob("slot_*"))
    assert len(made) == 4
    assert {name.split("_")[1] for name in made} == {"0", "1", "2", "3"}


def test_run_commands_failure_raises():
    cmds = [f"{sys.executable} -S -c \"raise SystemExit(3)\""]
    with pytest.raises(subprocess.CalledProcessError):
        sweep.run_commands(cmds, parallel=2)
    assert sweep.run_commands(cmds, parallel=1, check=False) == [3]


def test_run_commands_retry_recovers(tmp_path):
    """A run that dies is requeued with SWEEP_ATTEMPT exported: the first
    attempt leaves a marker and exits 1, the retry sees it and succeeds."""
    marker = tmp_path / "attempted"
    script = (
        "import os,sys; p=r'%s'; "
        "sys.exit(0) if os.path.exists(p) and "
        "os.environ['SWEEP_ATTEMPT']=='1' else "
        "(open(p,'w').close(), sys.exit(1))" % marker
    )
    assert sweep.run_commands([f'{sys.executable} -S -c "{script}"'], parallel=1,
                              retries=2) == [0]
    assert marker.exists()


def test_run_commands_retry_exhausted():
    cmds = [f"{sys.executable} -S -c \"raise SystemExit(7)\""]
    with pytest.raises(subprocess.CalledProcessError):
        sweep.run_commands(cmds, parallel=1, retries=1)
    assert sweep.run_commands(cmds, parallel=1, retries=1, check=False) == [7]


def test_run_commands_launch_failure_recorded():
    """A missing binary records rc=127 through the same path as a nonzero
    exit, and healthy commands still complete."""
    cmds = ["definitely-not-a-binary-xyz --flag", f"{sys.executable} -S -c \"raise SystemExit(0)\""]
    assert sweep.run_commands(cmds, parallel=2, retries=1, check=False) == [127, 0]


def test_generate_commands_checkpoint_root(tmp_path):
    cmds = sweep.generate_commands("fd_adaptive", [5, 6], "--quiet",
                                   checkpoint_root=str(tmp_path / "ck"))
    assert len(cmds) == 2
    assert cmds[0].endswith(f"--checkpoint-dir {tmp_path / 'ck' / 'seed_5'}")


def test_sweep_runs_the_port_driver(tmp_path):
    """Two seeds of the port's fd_adaptive on the CPU, two at a time."""
    cmds = sweep.generate_commands("fd_adaptive", [1, 2], "--device cpu --maxit 0")
    env_path = str(Path(__file__).resolve().parents[1])
    cmds = [c.replace(f"{sys.executable} -m", f"env PYTHONPATH={env_path} {sys.executable} -m")
            for c in cmds]
    assert sweep.run_commands(cmds, parallel=2) == [0, 0]


# ----------------------------------------------------------------- plotting
def frames(d: Path) -> list:
    return sorted(p.relative_to(d).as_posix() for p in d.rglob("*") if p.is_file())


def run_in(path: Path, monkeypatch, main, argv):
    path.mkdir()
    monkeypatch.chdir(path)
    return main(argv)


def test_fd_plot_writes_jax_frames(tmp_path, monkeypatch):
    from adjoint_ode_adaptivity_tpu.drivers import fd_adaptive as jfd
    from adjoint_ode_adaptivity_tpu_torch.drivers import fd_adaptive as tfd

    argv = ["--plot", "--maxit", "2", "--x64"]
    run_in(tmp_path / "jax", monkeypatch, jfd.main, argv)
    run_in(tmp_path / "port", monkeypatch, tfd.main, argv + ["--device", "cpu"])
    got = frames(tmp_path / "port")
    assert got == frames(tmp_path / "jax")
    assert got == [f"FD_nonlinear_u_sq/FD_nonlinear_u_sq_{i}.png" for i in range(3)]


def test_fd_animate_keeps_first_last_and_writes_mp4(tmp_path, monkeypatch):
    from adjoint_ode_adaptivity_tpu_torch.drivers import fd_adaptive as tfd

    run_in(tmp_path / "port", monkeypatch, tfd.main,
           ["--plot", "--animate", "--maxit", "3", "--device", "cpu", "--case", "c"])
    assert frames(tmp_path / "port") == ["c/c.mp4", "c/c_0.png", "c/c_3.png"]


def test_fd_backtrack_refuses_plot(tmp_path, monkeypatch, capsys):
    from adjoint_ode_adaptivity_tpu_torch.drivers import fd_adaptive as tfd

    run_in(tmp_path / "port", monkeypatch, tfd.main,
           ["--plot", "--schedule", "backtrack", "--maxit", "2", "--device", "cpu"])
    assert "--plot/--animate are not supported with --schedule backtrack; ignoring" in \
        capsys.readouterr().out
    assert frames(tmp_path / "port") == []


@pytest.mark.parametrize("argv", [["--maxit", "3"], ["--hp", "p", "--k0", "3", "--maxit", "2"]],
                         ids=["single", "hp"])
def test_dg_plot_writes_jax_frames(argv, tmp_path, monkeypatch):
    from adjoint_ode_adaptivity_tpu.drivers import dg_adaptive as jdg
    from adjoint_ode_adaptivity_tpu_torch.drivers import dg_adaptive as tdg

    hist_j = run_in(tmp_path / "jax", monkeypatch, jdg.main, ["--plot"] + argv)
    hist_t = run_in(tmp_path / "port", monkeypatch, tdg.main, ["--plot", "--device", "cpu"] + argv)
    assert len(hist_t) == len(hist_j)
    got = frames(tmp_path / "port")
    assert got == frames(tmp_path / "jax")
    assert got == [f"dg_nonlinear/dg_nonlinear_{i}.png" for i in range(len(hist_t))]


@pytest.mark.parametrize("name", ["fd_adaptive", "dg_adaptive"])
def test_drivers_accept_every_jax_flag(name, capsys):
    """Every option of the JAX driver is an option of the port's (``--plot``
    and ``--animate`` among them)."""
    import importlib
    import re

    def flags(module):
        with pytest.raises(SystemExit):
            importlib.import_module(module).main(["--help"])
        return set(re.findall(r"(?<![\w-])--[a-z][a-z0-9-]*", capsys.readouterr().out))

    jax_flags = flags(f"adjoint_ode_adaptivity_tpu.drivers.{name}")
    assert {"--plot", "--seed"} <= jax_flags
    assert jax_flags <= flags(f"adjoint_ode_adaptivity_tpu_torch.drivers.{name}")


def test_plot_iteration_returns_bar_ylim(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    plotting.fresh_case_dir("c")
    times = np.linspace(0.0, 2.0, 5)
    fine = np.linspace(0.0, 2.0, 17)
    args = (times, np.sin(times), fine, np.cos(fine), np.array([1.0, 3.0, 2.0, 0.5]))
    ylim = plotting.plot_iteration("c", 0, *args)
    assert len(ylim) == 2 and ylim[0] <= 0.0 and ylim[1] >= 3.0
    assert plotting.plot_iteration("c", 1, *args[:4], 10 * args[4], bar_ylim=ylim) == ylim
    assert sorted(p.name for p in (tmp_path / "c").iterdir()) == ["c_0.png", "c_1.png"]


def test_animate_case_without_frames_raises(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    plotting.fresh_case_dir("empty")
    with pytest.raises(FileNotFoundError):
        plotting.animate_case("empty")


def test_no_module_imports_matplotlib():
    """matplotlib loads only when a frame is drawn: importing every module of
    the port (the drivers and ``utils.plotting`` among them) pulls in none of
    it."""
    code = ("import importlib, pkgutil, sys; import adjoint_ode_adaptivity_tpu_torch as pkg; "
            "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]; "
            "[importlib.import_module(n) for n in names]; "
            "assert 'adjoint_ode_adaptivity_tpu_torch.utils.plotting' in names; "
            "print(any(m.startswith('matplotlib') for m in sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True,
                         cwd=Path(__file__).resolve().parents[1])
    assert out.stdout.strip() == "False"


# ---------------------------------------------------------------- profiling
def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "tr")):
        torch.sin(torch.arange(64, dtype=torch.float64)).sum()
    (path,) = list((tmp_path / "tr").iterdir())
    events = json.loads(path.read_text())["traceEvents"]
    assert any("sin" in str(e.get("name", "")) for e in events)
    with profiling.trace(None):  # a no-op
        pass


def test_time_fn_returns_its_three_keys():
    calls = []
    out = profiling.time_fn(lambda x: calls.append(x) or torch.ones(3) * x, 2.0, warmup=2,
                            iters=4)
    assert set(out) == {"best_s", "mean_s", "times"}
    assert len(out["times"]) == 4 and len(calls) == 6
    assert out["best_s"] == min(out["times"]) and out["best_s"] <= out["mean_s"]
