"""The port's slope limiters (ops/limiters.py) against the JAX package's
``ops/limiters.py``, float64, on the same inputs made with numpy.

The two are the same formulas over the same operators; only the order of
the small matrix products' sums may differ, so every value is held to
1e-14 (absolute, on O(1) data). The inputs include exact ties and zeros,
so minmod's unanimity branch sees unanimous, mixed and zero signs, and
mixtures of smooth and jumping elements, so ΠN's troubled-cell mask is
both true and false.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from adjoint_ode_adaptivity_tpu.ops import limiters as jl
from adjoint_ode_adaptivity_tpu.ops import startup_1d as jax_startup_1d
from adjoint_ode_adaptivity_tpu_torch import interop
from adjoint_ode_adaptivity_tpu_torch.ops import limiters as tl

torch.set_num_threads(1)  # one intra-op thread a process: the suite runs in xdist workers

TOL = 1e-14


def _disc(n_order, k, graded):
    vx = 2 * np.pi * np.linspace(0.0, 1.0, k + 1) ** 1.6 if graded else None
    disc_j = jax_startup_1d(n_order, 0.0, 2 * np.pi, k, vx=vx)
    return disc_j, interop.discretization_from_numpy(disc_j._asdict())


def _t(x):
    return torch.tensor(np.asarray(x), dtype=torch.float64)


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


def _minmod_rows():
    """(3, K) rows: unanimous positive/negative, mixed signs, exact zeros,
    exact ties of magnitude, and random values."""
    rng = np.random.default_rng(7)
    cases = np.array([
        [1.0, 2.0, 3.0], [-1.0, -0.5, -4.0], [1.0, -1.0, 2.0], [0.0, 1.0, 2.0],
        [0.0, 0.0, 0.0], [0.5, 0.5, 0.5], [-0.25, -0.25, -1.0], [2.0, 2.0, -2.0],
        [-0.0, -1.0, -1.0], [3.0, 1.0, 1.0],
    ]).T
    rand = rng.choice([-1.0, 1.0], size=(3, 30)) * rng.integers(0, 4, size=(3, 30)) / 2.0
    return np.concatenate([cases, rand, rng.normal(size=(3, 30))], axis=1)


def test_minmod_matches_jax_with_ties_and_sign_changes():
    v = _minmod_rows()
    got, want = tl.minmod(_t(v)), jl.minmod(jnp.asarray(v))
    _close(got, want)
    unanimous = np.all(np.sign(v) == np.sign(v[0]), axis=0) & (v[0] != 0)
    assert 0 < unanimous.sum() < v.shape[1]  # both branches taken
    assert np.all(got.numpy()[~unanimous] == 0.0)
    # a tie keeps its magnitude: [0.5, 0.5, 0.5] -> 0.5
    assert got[5] == 0.5 and got[6] == -0.25


def test_minmod_tvb_matches_jax():
    v = _minmod_rows()
    h = np.random.default_rng(8).uniform(0.05, 0.5, v.shape[1])
    for m_const in (0.0, 1.0, 20.0):
        _close(tl.minmod_tvb(_t(v), m_const, _t(h)), jl.minmod_tvb(jnp.asarray(v), m_const, jnp.asarray(h)))


def _fields(disc):
    """Smooth and jumping elements side by side: a sine, a step at π and a
    kink, plus a few constant elements (exact ties of the averages)."""
    x = np.asarray(disc.x)
    u = np.sin(x) + np.where(x > np.pi, 0.8, 0.0) + 0.3 * np.abs(x - 4.0)
    u[:, :3] = 0.25
    return u


@pytest.mark.parametrize("graded", [False, True])
@pytest.mark.parametrize("n_order", [1, 2, 4])
def test_slope_limiters_match_jax(n_order, graded):
    disc_j, disc = _disc(n_order, 24, graded)
    u = _fields(disc)
    ops_t = [_t(m) for m in (disc.x, disc.v, disc.inv_v, disc.dr)]
    ops_j = [jnp.asarray(m) for m in (disc_j.x, disc_j.v, disc_j.inv_v, disc_j.dr)]
    for name in ("slope_limit_1", "slope_limit_n"):
        got = getattr(tl, name)(_t(u), *ops_t)
        want = getattr(jl, name)(jnp.asarray(u), *ops_j)
        _close(got, want)
    # ΠN limits some elements and leaves others untouched
    got_n = tl.slope_limit_n(_t(u), *ops_t).numpy()
    changed = np.any(got_n != u, axis=0)
    assert 0 < changed.sum() < disc.k


def test_slope_limit_lin_and_neighbour_averages_match_jax():
    disc_j, disc = _disc(2, 16, graded=True)
    rng = np.random.default_rng(9)
    ul = np.asarray(disc.v) @ np.concatenate([rng.normal(size=(2, 16)), np.zeros((1, 16))])
    vk = rng.normal(size=16)
    vm1, vp1 = tl._neighbor_averages(_t(vk))
    wm1, wp1 = jl._neighbor_averages(jnp.asarray(vk))
    _close(vm1, wm1)
    _close(vp1, wp1)
    assert vm1[0] == vk[0] and vp1[-1] == vk[-1]  # copied endpoints
    got = tl.slope_limit_lin(_t(ul), _t(disc.x), vm1, _t(vk), vp1, _t(disc.dr))
    want = jl.slope_limit_lin(jnp.asarray(ul), jnp.asarray(disc_j.x), wm1, jnp.asarray(vk), wp1,
                              jnp.asarray(disc_j.dr))
    _close(got, want)
