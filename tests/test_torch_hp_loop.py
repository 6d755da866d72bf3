"""The port's hp-adaptive DG-in-time loops (adapt/hp_loop.py) and
``dg_adaptive --hp`` against the JAX package on the CPU, float64: the
single run (hp, smooth with Radau reconstruction), the ensemble signal
(p-mode) and the per-member study hold equal partitions and orders, and
estimates within 1e-10 relative; the p and h single runs take the JAX
package's own refinement decision at every iteration; the device loop is
bit-equal to the host loop; a resume with a larger maxit equals an
uninterrupted run; p-mode stops at saturation; the driver runs.

Four JAX hp-loop calls in all (each compiles a fresh jit), at k0 ≤ 3,
maxit 4, B = 8."""
import io
from contextlib import redirect_stdout

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adjoint_ode_adaptivity_tpu.adapt import hp_loop as jhp
from adjoint_ode_adaptivity_tpu_torch import odes
from adjoint_ode_adaptivity_tpu_torch.adapt import hp_loop
from adjoint_ode_adaptivity_tpu_torch.drivers import dg_adaptive

torch.set_num_threads(1)  # one intra-op thread a process: the suite runs in xdist workers

SIN = odes.get_ode("du/dt=sin(u)")
F_J = lambda u, t: jnp.sin(u)  # noqa: E731
CPU = dict(dtype=torch.float64, device="cpu")
Y0S = np.random.default_rng(3).uniform(0.5, 2.0, 8)
ATOL = 1e-12
SINGLE = {"hp": dict(k0=3, n_max=2, mode="hp"),  # three p-steps, then bisections
          "smooth": dict(k0=3, n_max=3, mode="smooth", adjoint_mode="reconstruct")}
ENSEMBLE = dict(k0=2, n_max=3, mode="p")
PER_MEMBER = dict(k0=2, n_max=2, mode="hp")
COMMON = dict(tol=0.0, maxit=4)


def close_rel(a, b, rel=1e-10, floor=1e-15):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    assert np.all(np.abs(a - b) <= rel * np.abs(b) + floor), (a, b)


@pytest.fixture(scope="module")
def jax_runs():
    runs = {name: jhp.run_adaptive_dg_hp(F_J, 1.0, (0.0, 2.0), **kw, **COMMON)
            for name, kw in SINGLE.items()}
    runs["ensemble"] = jhp.run_adaptive_dg_hp(F_J, Y0S, (0.0, 2.0), **ENSEMBLE, **COMMON)
    runs["per_member"] = jhp.run_adaptive_dg_hp_per_member(F_J, Y0S, (0.0, 2.0), **PER_MEMBER,
                                                           **COMMON)
    return runs


def _assert_histories_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        for fx, fy in zip(x, y):
            np.testing.assert_array_equal(fx, fy)


@pytest.mark.parametrize("name", list(SINGLE))
def test_single_run_matches_jax(name, jax_runs):
    ref = jax_runs[name]
    seen = []
    ours = hp_loop.run_adaptive_dg_hp(SIN.f, 1.0, (0.0, 2.0), f_u=SIN.f_u, callback=seen.append,
                                      **SINGLE[name], **COMMON, **CPU)
    assert len(ours) == len(ref) == len(seen) == 5
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a.times, b.times)
        np.testing.assert_array_equal(a.ns, b.ns)
        for f in ("u", "v", "err"):
            np.testing.assert_allclose(getattr(a, f), getattr(b, f), rtol=0, atol=ATOL)
        for f in ("j_coarse", "j_fine", "effectivity_gap"):
            assert abs(getattr(a, f) - getattr(b, f)) <= ATOL, f
        close_rel(a.est_total, b.est_total)
    if name == "hp":  # p until saturated, then h
        assert ours[3].ns.tolist() == [2, 2, 2] and len(ours[-1].ns) == 4


def test_ensemble_loop_matches_jax(jax_runs):
    ref = jax_runs["ensemble"]
    ours = hp_loop.run_adaptive_dg_hp(SIN.f, Y0S, (0.0, 2.0), f_u=SIN.f_u, **ENSEMBLE, **COMMON,
                                      **CPU)
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a.times, b.times)
        np.testing.assert_array_equal(a.ns, b.ns)
        assert a.u.shape == b.u.shape == (8, len(a.ns), 6)
        for f in ("u", "v", "err"):
            np.testing.assert_allclose(getattr(a, f), getattr(b, f), rtol=0, atol=ATOL)
        close_rel(a.est_total, b.est_total)
        assert abs(a.j_coarse - b.j_coarse) <= ATOL


def test_per_member_loop_matches_jax(jax_runs):
    ref = jax_runs["per_member"]
    ours = hp_loop.run_adaptive_dg_hp_per_member(SIN.f, Y0S, (0.0, 2.0), f_u=SIN.f_u,
                                                 **PER_MEMBER, **COMMON, **CPU)
    assert len(ours) == len(ref) == 5
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a.times, b.times)
        np.testing.assert_array_equal(a.ns, b.ns)
        np.testing.assert_array_equal(a.n_active, b.n_active)
        assert a.n_refining == b.n_refining
        np.testing.assert_allclose(a.err, b.err, rtol=0, atol=ATOL)
        close_rel(a.est_total, b.est_total)
        np.testing.assert_allclose(a.j_fine, b.j_fine, rtol=0, atol=ATOL)


def _padded(r, max_k):
    """A single-run history entry padded back to the loop's width."""
    k = len(r.ns)
    return (np.concatenate([r.times, np.full(max_k - k, r.times[-1])]),
            np.concatenate([r.ns, np.ones(max_k - k, np.int32)]),
            np.concatenate([np.abs(r.err), np.zeros(max_k - k)]))


@pytest.mark.parametrize("mode", ["p", "h"])
def test_single_run_takes_the_jax_refinement_decision(mode):
    """Each refinement of the p and h single runs is the one the JAX
    package's ``_refine_candidate`` picks from that iteration's signal."""
    hist = hp_loop.run_adaptive_dg_hp(SIN.f, 1.0, (0.0, 2.0), f_u=SIN.f_u, k0=3, n_max=3,
                                      mode=mode, **COMMON, **CPU)
    max_k = 3 + (5 if mode != "p" else 1)
    assert len(hist) == 5
    for r, nxt in zip(hist[:-1], hist[1:]):
        t, ns, abs_err = _padded(r, max_k)
        t_j, n_j = jhp._refine_candidate(jnp.asarray(t), jnp.asarray(ns), jnp.asarray(abs_err),
                                         mode, 3, mode != "h", mode != "p")
        t_n, n_n, _ = _padded(nxt, max_k)
        np.testing.assert_array_equal(t_n, np.asarray(t_j))
        np.testing.assert_array_equal(n_n, np.asarray(n_j))


def test_modal_smoothness_matches_jax():
    rng = np.random.default_rng(1)
    u = rng.normal(size=(6, 7, 6)) * np.exp(-2.0 * np.arange(6))
    ns = rng.integers(1, 4, size=(6, 7))
    u = u * (np.arange(6) <= ns[..., None])
    ours = hp_loop._make_modal_smoothness(3, 6, 0.3, "cpu")(torch.tensor(u), torch.tensor(ns))
    want = np.stack([np.asarray(jhp._make_modal_smoothness(3, 6, 0.3)(jnp.asarray(u[m]),
                                                                     jnp.asarray(ns[m])))
                     for m in range(6)])
    np.testing.assert_array_equal(ours.numpy(), want)
    assert 0 < want.sum() < want.size


def test_device_loop_is_bit_equal_to_the_host_loop():
    """The single run (torch engine, float64), the ensemble signal and the
    per-member study (the cuda engine's plain version, float32)."""
    kw = dict(f_u=SIN.f_u, k0=2, n_max=3, maxit=6, ode=SIN)
    y32 = Y0S[:4].astype(np.float32)
    f32 = dict(engine="cuda", newton_iters=8, dtype=torch.float32, device="cpu")
    # p-mode saturates, hp stops at its tolerance before maxit
    for y0, cfg in ((1.0, CPU), (y32, f32)):
        for mode, tol in (("p", 0.0), ("hp", 1e-5)):
            host = hp_loop.run_adaptive_dg_hp(SIN.f, y0, (0.0, 2.0), mode=mode, tol=tol, **kw,
                                              **cfg)
            dev = hp_loop.run_adaptive_dg_hp(SIN.f, y0, (0.0, 2.0), mode=mode, tol=tol,
                                             device_loop=True, **kw, **cfg)
            assert len(host) < 7, mode
            _assert_histories_equal(dev, host)
    host = hp_loop.run_adaptive_dg_hp_per_member(SIN.f, y32, (0.0, 2.0), mode="hp", tol=2e-5,
                                                 **kw, **f32)
    dev = hp_loop.run_adaptive_dg_hp_per_member(SIN.f, y32, (0.0, 2.0), mode="hp", tol=2e-5,
                                                device_loop=True, **kw, **f32)
    assert len(host) < 7 and host[-1].n_refining == 0
    _assert_histories_equal(dev, host)


@pytest.mark.parametrize("device_loop", [False, True])
def test_resume_with_a_larger_maxit_equals_an_uninterrupted_run(tmp_path, device_loop):
    kw = dict(f_u=SIN.f_u, k0=2, n_max=2, mode="hp", tol=0.0, device_loop=device_loop, **CPU)
    for name, y0 in (("run_adaptive_dg_hp", 1.0), ("run_adaptive_dg_hp_per_member", Y0S[:4])):
        loop = getattr(hp_loop, name)
        full = loop(SIN.f, y0, (0.0, 2.0), maxit=5, **kw)
        ck = str(tmp_path / name)
        assert len(loop(SIN.f, y0, (0.0, 2.0), maxit=2, checkpoint_dir=ck, **kw)) == 3
        resumed = loop(SIN.f, y0, (0.0, 2.0), maxit=5, checkpoint_dir=ck, **kw)
        if name == "run_adaptive_dg_hp":
            _assert_histories_equal(resumed, full)
        else:  # the restored rows are re-padded to the wider partitions
            assert len(resumed) == len(full)
            for a, b in zip(resumed, full):
                for f in ("times", "ns", "err", "est_total", "n_active"):
                    np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


def test_p_mode_stops_at_saturation(tmp_path):
    """Two elements, n_max 2: two order steps, then an iteration that finds
    nothing to refine ends the run; a resume does not run it again."""
    kw = dict(f_u=SIN.f_u, k0=2, n0=1, n_max=2, mode="p", tol=0.0, maxit=10, **CPU)
    hist = hp_loop.run_adaptive_dg_hp(SIN.f, 1.0, (0.0, 2.0), **kw)
    assert len(hist) == 3 and hist[-1].ns.tolist() == [2, 2]
    ck = str(tmp_path / "sat")
    for device_loop in (True, False):
        again = hp_loop.run_adaptive_dg_hp(SIN.f, 1.0, (0.0, 2.0), checkpoint_dir=ck,
                                           device_loop=device_loop, **kw)
        _assert_histories_equal(again, hist)
    pm = hp_loop.run_adaptive_dg_hp_per_member(SIN.f, Y0S[:4], (0.0, 2.0), **kw)
    assert len(pm) == 3 and pm[-1].n_refining == 0 and np.all(pm[-1].ns[:, :2] == 2)


@pytest.mark.parametrize("device_loop", [False, True])
def test_resume_after_saturation_on_the_last_iteration(tmp_path, device_loop):
    """p-mode that saturates exactly at maxit (two elements, orders 1 -> 3
    in four steps): the checkpoint says so, and a resume with a larger
    maxit runs nothing again, as the uninterrupted run stops there."""
    kw = dict(f_u=SIN.f_u, k0=2, n0=1, n_max=3, mode="p", tol=0.0, device_loop=device_loop, **CPU)
    full = hp_loop.run_adaptive_dg_hp(SIN.f, 1.0, (0.0, 2.0), maxit=6, **kw)
    assert len(full) == 5 and full[-1].ns.tolist() == [3, 3]
    ck = str(tmp_path / "sat")
    assert len(hp_loop.run_adaptive_dg_hp(SIN.f, 1.0, (0.0, 2.0), maxit=4, checkpoint_dir=ck,
                                          **kw)) == 5
    resumed = hp_loop.run_adaptive_dg_hp(SIN.f, 1.0, (0.0, 2.0), maxit=6, checkpoint_dir=ck, **kw)
    _assert_histories_equal(resumed, full)


def test_loops_refuse_what_they_cannot_run():
    kw = dict(maxit=1, device="cpu")
    for loop in (hp_loop.run_adaptive_dg_hp, hp_loop.run_adaptive_dg_hp_per_member):
        for bad, match in ((dict(engine="pallas"), "engine"), (dict(mode="q"), "mode"),
                           (dict(n0=5), "n0"), (dict(adjoint_mode="x"), "adjoint_mode"),
                           (dict(fine_offset=0), "fine_offset"),
                           (dict(engine="cuda", ode=SIN, dtype=torch.float64), "float32"),
                           # ode=None traces f; g_u is traced: neither may reduce
                           (dict(engine="cuda", dtype=torch.float32,
                                 f_u=lambda u, t: torch.sum(u) * u), "cannot trace"),
                           (dict(engine="cuda", ode=SIN, dtype=torch.float32,
                                 g_u=lambda u, t: torch.sum(u) * u), "cannot trace")):
            with pytest.raises(ValueError, match=match):
                loop(SIN.f, Y0S, (0.0, 2.0), **bad, **kw)
    with pytest.raises(ValueError, match="ensemble"):
        hp_loop.run_adaptive_dg_hp(SIN.f, 1.0, (0.0, 2.0), engine="cuda", ode=SIN,
                                   dtype=torch.float32, **kw)
    if not torch.cuda.is_available():  # the entry points default to the card
        for run in (lambda: hp_loop.run_adaptive_dg_hp(SIN.f, 1.0, (0.0, 2.0), maxit=1),
                    lambda: hp_loop.run_adaptive_dg_hp_per_member(SIN.f, Y0S, (0.0, 2.0),
                                                                  maxit=1),
                    lambda: dg_adaptive.main(["--hp", "p", "--maxit", "1"])):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                run()


def test_driver_hp_runs_on_the_cpu():
    """The single-run p recipe (est 5.5e-4 to below 1e-9, the four elements
    saturating at order 4 but one), and the ensemble and per-member
    branches."""
    out = io.StringIO()
    with redirect_stdout(out):
        hist = dg_adaptive.main(["--hp", "p", "--k0", "4", "--order", "1", "--n-max", "4",
                                 "--tol", "1e-9", "--device", "cpu"])
    lines = out.getvalue().splitlines()
    assert len(hist) == 12 and hist[-1].ns.tolist() == [4, 4, 4, 3]
    assert abs(hist[0].est_total - 5.5e-4) < 1e-6 and abs(hist[-1].est_total) < 1e-9
    assert all(abs(r.est_total) >= 1e-9 for r in hist[:-1])
    assert lines[0] == "-- it with K=4 ns=[1, 1, 1, 1]" and lines.count("JuH-Ju") == 12
    assert lines[-1] == "finished after 12 iterations (mode=p, K=4, orders 3..4)"
    for argv, last in (
            (["--ensemble", "8", "--per-member", "--device-loop"],
             "finished after 4 iterations (per-member hp, B=8, mode=hp)"),
            (["--ensemble", "8", "--adjoint", "reconstruct"],
             "finished after 4 iterations (mode=hp, K=2, orders 2..3)")):
        out = io.StringIO()
        with redirect_stdout(out):
            dg_adaptive.main(["--hp", "hp", "--k0", "2", "--n-max", "3", "--tol", "0",
                              "--maxit", "3", "--device", "cpu"] + argv)
        assert out.getvalue().splitlines()[-1] == last
    with pytest.raises(SystemExit):  # the kernel runs ensembles only
        dg_adaptive.main(["--hp", "p", "--engine", "cuda"])
