"""The DG slab kernel's plain version and wrapper (ops/cuda/dg_slab.py) on
the CPU: against the JAX package's batched pipeline in float32 at the JAX
test's own tolerances (tests/test_pallas_dg_slab.py:30-32: u 3e-6, v 5e-6,
err 3e-6 — float32 roundoff through a few Newton steps), against the Pallas
kernel in interpret mode, the folded tables' layout, and the validation.
The kernel itself runs only on a GPU (tests/test_torch_cuda.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adjoint_ode_adaptivity_tpu.march.dg_batched import dg_estimate_batched
from adjoint_ode_adaptivity_tpu.march.dg_time import dg_time_operators as jops
from adjoint_ode_adaptivity_tpu.ops.pallas.dg_slab import make_pallas_dg_estimate_ensemble
from adjoint_ode_adaptivity_tpu_torch import odes
from adjoint_ode_adaptivity_tpu_torch.march.dg_time import dg_time_operators
from adjoint_ode_adaptivity_tpu_torch.ops.cuda import dg_slab as ds

torch.set_num_threads(1)  # one intra-op thread a process: the suite runs in xdist workers

F32 = torch.float32
TOL = {"u": 3e-6, "v": 5e-6, "err": 3e-6}
F_J = lambda u, t: jnp.sin(u)  # noqa: E731


def _inputs(k, b, per_member, seed):
    rng = np.random.default_rng(seed)
    y0s = rng.uniform(0.5, 2.0, b).astype(np.float32)
    if not per_member:
        return np.linspace(0.0, 2.0, k + 1).astype(np.float32), y0s
    times = np.full((b, k + 1), 2.0)
    for m, n_act in enumerate(rng.integers(2, k, b)):  # at least one zero-width tail slab
        times[m, : n_act + 1] = np.concatenate([[0.0], np.sort(rng.uniform(0.1, 1.9, n_act - 1)),
                                                [2.0]])
    return times.astype(np.float32), y0s


def _run(n, k, device="cpu", **kw):
    return ds.make_cuda_dg_estimate_ensemble("du/dt=sin(u)", dg_time_operators(n),
                                             dg_time_operators(n + 1), k, device=device, **kw)


@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("per_member", [False, True])
def test_plain_version_matches_jax_float32(n, per_member):
    k, b = 8, 32
    times, y0s = _inputs(k, b, per_member, seed=n)
    run = _run(n, k, newton_iters=6)
    before = ds.dg_estimate_ensemble.launches
    got = run(torch.tensor(times), torch.tensor(y0s))
    assert ds.dg_estimate_ensemble.launches == before  # a CPU tensor takes the plain version
    want = dg_estimate_batched(jops(n), jops(n + 1), F_J, jnp.asarray(times), jnp.asarray(y0s),
                               newton_iters=6)
    for name, g, w in zip(TOL, got, want):
        assert g.dtype == F32 and g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=TOL[name])
    if per_member:  # each member's zero-width tail contributes exactly 0
        err = got[2].numpy()
        assert np.all(err[np.diff(times, axis=1) == 0] == 0)


def test_plain_version_matches_the_interpret_mode_kernel():
    """_kernel (dg_slab.py:92) in interpret mode at B = 16, K = 8, with the
    closed-form f_u of the registry on both sides."""
    k, b = 8, 16
    times, y0s = _inputs(k, b, False, seed=7)
    pallas = make_pallas_dg_estimate_ensemble(jops(1), jops(2), F_J, lambda u, t: jnp.cos(u), k,
                                              newton_iters=6, interpret=True)
    want = pallas(jnp.asarray(times), jnp.asarray(y0s))
    got = _run(1, k, newton_iters=6)(torch.tensor(times), torch.tensor(y0s))
    for name, g, w in zip(TOL, got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=TOL[name])


@pytest.mark.parametrize("n", [0, 1, 3, 6])
def test_table_layout(n):
    """The fold's length is what csrc/dg_slab.cu's table_size<Np> expects,
    and its first block is A = Sᵀ with A[−1,−1] −= 1."""
    ops_p, ops_a = dg_time_operators(n), dg_time_operators(n + 1)
    npp, na, nqp, nqa = n + 1, n + 2, ops_p.phi.shape[0], ops_a.phi.shape[0]
    tab = ds.kernel_tables(ops_p, ops_a)
    size = npp * npp + nqp * (2 * npp + 1 + npp * npp) + 2 * na * na + na + na * npp \
        + nqa * (npp + 1 + na + na * na)
    assert tab.shape == (size,)
    a_p = ops_p.stiff.T.copy()
    a_p[-1, -1] -= 1.0
    np.testing.assert_array_equal(tab[: npp * npp], a_p.ravel())
    run = _run(n, 4)
    assert run.plan.tables32.dtype == np.float32 and run.plan.tables32.size == size


def test_fast_trig_plain_version_agrees_with_libm():
    k, b = 16, 64
    times, y0s = _inputs(k, b, False, seed=2)
    libm = _run(1, k)(torch.tensor(times), torch.tensor(y0s))
    fast = _run(1, k, trig="fast")(torch.tensor(times), torch.tensor(y0s))
    for name, a, c in zip(TOL, fast, libm):
        np.testing.assert_allclose(a.numpy(), c.numpy(), rtol=0, atol=4 * TOL[name])


def test_entry_point_refuses_what_the_kernel_does_not_take():
    ops1, ops2 = dg_time_operators(1), dg_time_operators(2)
    # an ODE without a kernel_id and a bare g_u are traced: a reduction is not elementwise
    untraceable = odes.ODEProblem("du/dt=-sum(u)", lambda u, t: -torch.sum(u) * u,
                                  f_u=lambda u, t: -torch.ones_like(u))
    with pytest.raises(ValueError, match="cannot trace.*torch.sum"):
        ds.make_cuda_dg_estimate_ensemble(untraceable, ops1, ops2, 4, device="cpu")
    with pytest.raises(ValueError, match="scalar"):
        ds.make_cuda_dg_estimate_ensemble("harmonic_oscillator", ops1, ops2, 4, device="cpu")
    with pytest.raises(ValueError, match="cannot trace.*torch.sum"):
        ds.make_cuda_dg_estimate_ensemble("du/dt=sin(u)", ops1, ops2, 4, device="cpu",
                                          g_u=lambda u, t: torch.sum(u) * u)
    with pytest.raises(ValueError, match="Np <= 8"):
        ds.make_cuda_dg_estimate_ensemble("du/dt=sin(u)", dg_time_operators(7),
                                          dg_time_operators(8), 4, device="cpu")
    with pytest.raises(ValueError, match="one order above"):
        ds.make_cuda_dg_estimate_ensemble("du/dt=sin(u)", ops1, ops1, 4, device="cpu")
    with pytest.raises(ValueError, match="sin"):
        ds.make_cuda_dg_estimate_ensemble("du/dt=10cos(u)", ops1, ops2, 4, trig="fast",
                                          device="cpu")
    with pytest.raises(ValueError, match="n_gq"):
        ds.make_cuda_dg_estimate_ensemble("du/dt=sin(u)", dg_time_operators(6, 200),
                                          dg_time_operators(7, 200), 4, device="cpu")
    if not torch.cuda.is_available():  # the entry point defaults to the card
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ds.make_cuda_dg_estimate_ensemble("du/dt=sin(u)", ops1, ops2, 4)
    run = _run(1, 4)
    with pytest.raises(ValueError, match="expected"):
        run(torch.zeros(6), torch.zeros(8))
    with pytest.raises(ValueError, match="must match"):
        run(torch.zeros(5, dtype=torch.float64), torch.zeros(8))
    with pytest.raises(TypeError):
        run(torch.zeros(5, dtype=torch.int32), torch.zeros(8, dtype=torch.int32))
    with pytest.raises(ValueError, match=r"\(B,\)"):
        run(torch.zeros(5), torch.zeros(8, 1))
