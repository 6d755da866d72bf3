"""H1's new order and bounds on the CPU (ops/cuda/dg_slab_mixed.py): the
per-element u and v bounds of ``hp_kernel_tolerance``, the G-lane sum order
of the kernel (``dg_estimate_hp_lanes_plain``) held to them against the
float64 plain version for every G the kernel takes, and ``hp_plan``'s
choices. The kernel itself runs only on a GPU (tests/test_torch_cuda.py)."""
import numpy as np
import pytest
import torch

from adjoint_ode_adaptivity_tpu_torch.adjoint.dg_mixed import (
    dg_adjoint_interp_mixed,
    dg_radau_interp_mixed,
)
from adjoint_ode_adaptivity_tpu_torch.march.dg_mixed import dg_time_operators_mixed
from adjoint_ode_adaptivity_tpu_torch.ops.cuda import dg_slab_mixed as hm

torch.set_num_threads(1)  # one intra-op thread a process: the suite runs in xdist workers
N_USER, FO, NEWTON = 3, 2, 8


def _bench_problem(b, k=15, seed=5, uniform=None):
    """bench.py's hp shape: y0 ~ U(0.5, 2), per-member partitions of [0, 2]
    with 2..K live slabs on a 2⁻¹⁰ grid, zero-width tails, random orders
    1..N_USER (or ``uniform``)."""
    rng = np.random.default_rng(seed)
    y0 = rng.uniform(0.5, 2.0, b)
    t = np.full((b, k + 1), 2.0)
    ns = np.full((b, k), uniform or 1, np.int64)
    for m, n_act in enumerate(rng.integers(2, k + 1, b)):
        t[m, : n_act + 1] = np.concatenate(
            [[0.0], np.sort(rng.choice(np.arange(1, 2048), n_act - 1, replace=False)) / 1024, [2.0]])
        if uniform is None:
            ns[m, :n_act] = rng.integers(1, N_USER + 1, n_act)
    return torch.tensor(t, dtype=torch.float32), torch.tensor(ns), torch.tensor(y0)


def _run(adjoint_mode, k):
    mops = dg_time_operators_mixed(N_USER + FO)
    return hm.make_cuda_dg_estimate_hp_per_member(
        "du/dt=sin(u)", mops, dg_adjoint_interp_mixed(mops), k, n_max_user=N_USER,
        fine_offset=FO, newton_iters=NEWTON, adjoint_mode=adjoint_mode,
        rad=dg_radau_interp_mixed(mops), device="cpu")


@pytest.mark.parametrize("ode,mode", [("du/dt=sin(u)", "solve"), ("du/dt=t*sin(u)", "solve"),
                                      ("gaussian_mixture", "reconstruct")])
def test_per_element_u_and_v_bounds(ode, mode):
    """The per-element bounds of u_c, u_f and v at bench.py's hp shape: the
    float32 plain version stays within a quarter of each of float64, every
    element's bound lies below its own values' magnitude (a zero or shifted
    element fails it), and the bounds differ from element to element: an
    element's bound is its own system's, carried by the inflow (u forward,
    the solved v backward), so it grows along the carry."""
    b, k = 128, 15
    times, ns, y0 = _bench_problem(b, k, seed=9)
    mops = dg_time_operators_mixed(N_USER + FO)
    run = hm.make_cuda_dg_estimate_hp_per_member(
        ode, mops, dg_adjoint_interp_mixed(mops), k, n_max_user=N_USER, fine_offset=FO,
        newton_iters=NEWTON, adjoint_mode=mode, rad=dg_radau_interp_mixed(mops), device="cpu")
    p32 = run(times, ns, y0.float())
    p64 = run(times.double(), ns, y0.double())
    tol = hm.hp_kernel_tolerance(times, ns, y0.float(), p32, run.plan)
    live = torch.diff(times, dim=1) > 0
    for g, w, name in zip(p32, p64, ("u_c", "u_f", "v")):
        bound = tol[name][..., 0]
        assert bool(((g.double() - w).abs() <= tol[name] / 4).all()), name
        assert bool((w.abs().amax(dim=-1)[live] > bound[live]).all()), name
        assert float(bound[live].max()) > 4 * float(bound[live].min()), name
    # u's bound carries forward; v's (solved) backward, the reconstructed
    # one through each element's own lift
    assert bool((tol["u_c"][:, 1:] >= tol["u_c"][:, :-1]).all())
    if mode == "solve":
        assert bool((tol["v"][:, :-1][live[:, :-1]] >= tol["v"][:, 1:][live[:, :-1]]).all())


@pytest.mark.parametrize("mode", ["solve", "reconstruct"])
@pytest.mark.parametrize("lanes", [1, 4, 8, 16, 32])
def test_lanes_sum_order_stays_within_the_tolerance(lanes, mode):
    """H1's sum order at G lanes a member (dg_estimate_hp_lanes_plain: lane
    ℓ's strided partial sums over the quadrature points and the residual's
    rows, then the xor butterfly), in float32, stays within a quarter of
    hp_kernel_tolerance of the float64 plain version at bench.py's hp shape,
    on every G the kernel takes."""
    b, k = 96, 15
    times, ns, y0 = _bench_problem(b, k, seed=lanes)
    run = _run(mode, k)
    got = hm.dg_estimate_hp_lanes_plain(times, ns, y0.float(), run.plan, lanes)
    p32 = run(times, ns, y0.float())
    p64 = run(times.double(), ns, y0.double())
    tol = hm.hp_kernel_tolerance(times, ns, y0.float(), p32, run.plan)
    for g, w, name in zip(got, p64, ("u_c", "u_f", "v", "err")):
        assert g.dtype == torch.float32 and g.shape == w.shape, name
        assert bool(((g.double() - w).abs() <= tol[name] / 4).all()), name
    assert bool((got[3][~(torch.diff(times, dim=1) > 0)] == 0).all())


def test_lane_sum_order():
    """_lane_sum adds lane ℓ's entries ≡ ℓ (mod G) in order, then the
    butterfly: at G = 4 over 6 entries, ((x0 + x4) + x2) + ... as written."""
    x = torch.tensor([[1.0, 2.0**-24, 3.0, 2.0**-24, 2.0**-23, 5.0]], dtype=torch.float32)
    p = [x[0, 0] + x[0, 4], x[0, 1] + x[0, 5], x[0, 2], x[0, 3]]
    p = [p[0] + p[1], p[1] + p[0], p[2] + p[3], p[3] + p[2]]
    want = p[0] + p[2]
    assert torch.equal(hm._lane_sum(x, 4)[0], want)
    assert torch.equal(hm._lane_sum(x, 1)[0], x[0].cumsum(0)[-1])


def test_hp_plan():
    """hp_plan's rule, fitted to the card's times: 16 lanes a member up to
    B = 2048 (bench.py's B = 512 among them), 8 at B = 4096, 4 beyond, never
    more lanes than quadrature points; 64-thread CTAs; cached."""
    assert hm.hp_plan(512, 6, 22) == hm.HpLaunch(16, 64)
    assert hm.hp_plan(2048, 8, 28) == hm.HpLaunch(16, 64)
    assert hm.hp_plan(4096, 6, 22) == hm.HpLaunch(8, 64)
    assert hm.hp_plan(100_000, 6, 22) == hm.HpLaunch(4, 64)
    assert hm.hp_plan(8, 3, 6) == hm.HpLaunch(4, 64)
    assert hm.hp_plan(512, 6, 22) is hm.hp_plan(512, 6, 22)
