"""The hp kernel's plain version and wrapper (ops/cuda/dg_slab_mixed.py) on
the CPU: against the JAX package's vmapped XLA member pipeline in float32
at the JAX test's own tolerances (tests/test_pallas_hp.py:64-101: u 2e-5,
v 2e-4, err 2e-5 — float32 roundoff through 8 Newton steps), in both
adjoint modes, the folded tables' layout, and the validation. The kernel
itself runs only on a GPU (tests/test_torch_cuda.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adjoint_ode_adaptivity_tpu.adjoint import dg_mixed as jadj
from adjoint_ode_adaptivity_tpu.march import dg_mixed as jmarch
from adjoint_ode_adaptivity_tpu_torch import odes
from adjoint_ode_adaptivity_tpu_torch.adjoint.dg_mixed import (
    dg_adjoint_interp_mixed,
    dg_radau_interp_mixed,
)
from adjoint_ode_adaptivity_tpu_torch.march.dg_mixed import dg_time_operators_mixed
from adjoint_ode_adaptivity_tpu_torch.ops.cuda import dg_slab_mixed as hm

N_USER, FO, K_EL, B, NEWTON = 3, 2, 5, 16, 8
F_SIN = lambda u, t: jnp.sin(u)  # noqa: E731
ATOL = {"u_c": 2e-5, "u_f": 2e-5, "v": 2e-4, "err": 2e-5}
RTOL = {"u_c": 1e-4, "u_f": 1e-4, "v": 1e-3, "err": 0.0}


def _problem(seed=0):
    """tests/test_pallas_hp.py's per-member problem: the last slab of every
    second member is zero-width."""
    rng = np.random.default_rng(seed)
    times = np.zeros((B, K_EL + 1), np.float32)
    ns = np.ones((B, K_EL), np.int32)
    for m in range(B):
        k_live = K_EL if m % 2 == 0 else K_EL - 1
        t = np.concatenate([[0.0], np.sort(rng.uniform(0.1, 1.9, k_live - 1)), [2.0]])
        times[m] = np.concatenate([t, np.full(K_EL - k_live, 2.0)])
        ns[m, :k_live] = rng.integers(1, N_USER + 1, k_live)
    return times, ns, rng.uniform(0.5, 2.0, B).astype(np.float32)


def _jax_pipeline(times, ns, y0, adjoint_mode):
    mops = jmarch.dg_time_operators_mixed(N_USER + FO)
    interp, rad = jadj.dg_adjoint_interp_mixed(mops), jadj.dg_radau_interp_mixed(mops)

    def member(t_m, n_m, y_m):
        u_c = jmarch.dg_march_mixed(mops, F_SIN, t_m, n_m, y_m, newton_iters=NEWTON).u
        u_f = jmarch.dg_march_mixed(mops, F_SIN, t_m, n_m + FO, y_m, newton_iters=NEWTON).u
        if adjoint_mode == "solve":
            adj = jadj.dg_adjoint_march_mixed(mops, interp, F_SIN, u_c, t_m, n_m, y_m)
            return u_c, u_f, adj.v, adj.err
        v_low = jadj.dg_adjoint_solve_low_mixed(mops, F_SIN, u_c, t_m, n_m, y_m)
        v = jadj.dg_adjoint_reconstruct_mixed(mops, rad, v_low, n_m)
        return u_c, u_f, v, jadj.dg_awr_from_adjoint_mixed(mops, interp, F_SIN, u_c, t_m, n_m,
                                                          y_m, v)

    return jax.vmap(member)(jnp.asarray(times), jnp.asarray(ns), jnp.asarray(y0))


def _run(adjoint_mode="solve", n_user=N_USER, fo=FO, k=K_EL, **kw):
    mops = dg_time_operators_mixed(n_user + fo)
    return hm.make_cuda_dg_estimate_hp_per_member(
        "du/dt=sin(u)", mops, dg_adjoint_interp_mixed(mops), k, n_max_user=n_user,
        fine_offset=fo, newton_iters=NEWTON, adjoint_mode=adjoint_mode,
        rad=dg_radau_interp_mixed(mops), device="cpu", **kw)


@pytest.mark.parametrize("adjoint_mode", ["solve", "reconstruct"])
def test_plain_version_matches_the_jax_member_pipeline(adjoint_mode):
    times, ns, y0 = _problem()
    run = _run(adjoint_mode)
    before = hm.dg_estimate_hp_per_member.launches
    got = run(torch.tensor(times), torch.tensor(ns), torch.tensor(y0))
    assert hm.dg_estimate_hp_per_member.launches == before  # a CPU tensor takes the plain version
    want = _jax_pipeline(times, ns, y0, adjoint_mode)
    for name, g, w in zip(ATOL, got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL[name], atol=ATOL[name],
                                   err_msg=name)
    # the zero-width tails contribute exactly 0
    assert np.all(got[3].numpy()[1::2, -1] == 0)


@pytest.mark.parametrize("ode,mode,uniform", [("du/dt=sin(u)", "solve", None),
                                               ("gaussian_mixture", "reconstruct", None),
                                               ("du/dt=sin(u)", "reconstruct", 3),
                                               ("du/dt=sin(u)", "reconstruct", None)])
def test_kernel_tolerance_covers_float32_roundoff_and_decides(ode, mode, uniform):
    """hp_kernel_tolerance, the bound H1 is held to on the card, at bench.py's
    hp shape (K = 15, per-member partitions on a 2⁻¹⁰ grid with zero-width
    tails, random or uniform orders): the float32 plain version stays within
    an eighth of every per-element bound of float64 (so two float32
    evaluations in any order stay well inside it); an err of 0 would fail
    it; v and err are bounded by 0 on the tails."""
    rng = np.random.default_rng(5)
    b, k = 256, 15
    y0 = rng.uniform(0.5, 2.0, b)
    t = np.full((b, k + 1), 2.0)
    ns = np.full((b, k), uniform or 1, np.int64)
    for m, n_act in enumerate(rng.integers(2, k + 1, b)):
        t[m, : n_act + 1] = np.concatenate(
            [[0.0], np.sort(rng.choice(np.arange(1, 2048), n_act - 1, replace=False)) / 1024, [2.0]])
        if uniform is None:
            ns[m, :n_act] = rng.integers(1, N_USER + 1, n_act)
    times, ns, y0 = torch.tensor(t, dtype=torch.float32), torch.tensor(ns), torch.tensor(y0)
    mops = dg_time_operators_mixed(N_USER + FO)
    run = hm.make_cuda_dg_estimate_hp_per_member(
        ode, mops, dg_adjoint_interp_mixed(mops), k, n_max_user=N_USER, fine_offset=FO,
        newton_iters=NEWTON, adjoint_mode=mode, rad=dg_radau_interp_mixed(mops), device="cpu")
    p32 = run(times, ns, y0.float())
    p64 = run(times.double(), ns, y0.double())
    tol = hm.hp_kernel_tolerance(times, ns, y0.float(), p32, run.plan)
    for g, w, name in zip(p32, p64, ("u_c", "u_f", "v", "err")):
        assert bool(((g.double() - w).abs() <= tol[name] / 8).all()), name
    live = torch.diff(times, dim=1) > 0
    assert tol["err"].shape == (b, k) and bool((tol["err"][~live] == 0).all())
    assert all(tol[x].shape == (b, k, 1) for x in ("u_c", "u_f", "v"))
    assert bool((tol["v"][..., 0][~live] == 0).all()) and bool((tol["u_c"] > 0).all())
    assert bool((p32[3].abs() > tol["err"]).any())


@pytest.mark.parametrize("np_max,n_user,fo", [(3, 1, 1), (6, 3, 2), (8, 5, 2)])
def test_table_layout(np_max, n_user, fo):
    """The fold's length is what csrc/dg_slab_mixed.cu's table_size expects,
    and its blocks sit where HpLayout reads them."""
    mops = dg_time_operators_mixed(n_user + fo)
    assert mops.np_max == np_max
    interp, rad = dg_adjoint_interp_mixed(mops), dg_radau_interp_mixed(mops)
    q, n_s = mops.rq.shape[0], mops.n_max
    tab = hm.kernel_tables(mops, interp, rad)
    stack = 3 * np_max**2 + np_max + q * np_max
    prim = 3 * np_max**2 + q * np_max
    assert tab.shape == (2 * q + n_s * stack + (n_s - 1) * prim,)
    np.testing.assert_array_equal(tab[:q], mops.wq)
    s = n_s - 1  # the top order: A_fwd[end, end] = S[end, end] − 1
    a_fwd = tab[2 * q + s * stack:][: np_max**2].reshape(np_max, np_max)
    want = mops.stiff_pad[s].T.copy()
    want[-1, -1] -= 1.0
    np.testing.assert_array_equal(a_fwd, want)
    p = n_s - 2
    base = 2 * q + n_s * stack + p * prim
    np.testing.assert_array_equal(tab[base + np_max**2: base + 2 * np_max**2],
                                  rad.eval_rad[p].ravel())
    np.testing.assert_array_equal(tab[base + 3 * np_max**2: base + prim], interp.to_quad[p].ravel())
    run = _run(n_user=n_user, fo=fo, k=3)
    assert run.plan.tables.dtype == torch.float32 and run.plan.tables.numel() == tab.size


def test_entry_point_refuses_what_the_kernel_does_not_take():
    mops = dg_time_operators_mixed(N_USER + FO)
    interp = dg_adjoint_interp_mixed(mops)
    make = hm.make_cuda_dg_estimate_hp_per_member
    kw = dict(n_max_user=N_USER, device="cpu")
    no_functor = odes.ODEProblem("du/dt=-u", lambda u, t: -u, f_u=lambda u, t: -torch.ones_like(u))
    with pytest.raises(ValueError, match="kernel_id"):
        make(no_functor, mops, interp, 4, **kw)
    with pytest.raises(ValueError, match="scalar"):
        make("harmonic_oscillator", mops, interp, 4, **kw)
    with pytest.raises(ValueError, match="g_u"):
        make("du/dt=sin(u)", mops, interp, 4, g_u=lambda u, t: 2 * u, **kw)
    with pytest.raises(ValueError, match="n_max_user"):
        make("du/dt=sin(u)", mops, interp, 4, n_max_user=N_USER, fine_offset=1, device="cpu")
    with pytest.raises(ValueError, match="fine_offset"):
        make("du/dt=sin(u)", mops, interp, 4, n_max_user=N_USER + FO, fine_offset=0,
             device="cpu")
    big = dg_time_operators_mixed(8)
    with pytest.raises(ValueError, match="np_max <= 8"):
        make("du/dt=sin(u)", big, dg_adjoint_interp_mixed(big), 4, n_max_user=6, device="cpu")
    with pytest.raises(ValueError, match="requires rad"):
        make("du/dt=sin(u)", mops, interp, 4, adjoint_mode="reconstruct", **kw)
    with pytest.raises(ValueError, match="adjoint_mode"):
        make("du/dt=sin(u)", mops, interp, 4, adjoint_mode="nope", **kw)
    wide = dg_time_operators_mixed(N_USER + FO, 400)
    with pytest.raises(ValueError, match="n_gq"):
        make("du/dt=sin(u)", wide, dg_adjoint_interp_mixed(wide), 4, **kw)
    if not torch.cuda.is_available():  # the entry point defaults to the card
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make("du/dt=sin(u)", mops, interp, 4, n_max_user=N_USER)
    run = _run(k=4)
    t, n, y = torch.zeros((8, 5)), torch.ones((8, 4), dtype=torch.int32), torch.zeros(8)
    with pytest.raises(ValueError, match="expected"):
        run(t[:, :4], n, y)
    with pytest.raises(ValueError, match="ns"):
        run(t, n[:, :3], y)
    with pytest.raises(TypeError, match="integer"):
        run(t, n.float(), y)
    with pytest.raises(ValueError, match="must match"):
        run(t.double(), n, y)
    with pytest.raises(TypeError):
        run(t.int(), n, y.int())
    with pytest.raises(ValueError, match=r"\(B,\)"):
        run(t, n, y[:, None])
    with pytest.raises(ValueError, match="operator stack"):  # the plain version checks orders
        run(t, n + N_USER + FO, y)
