"""The port's L0 host builders against the JAX package's: every
``Discretization1D`` field bit-equal (both are float64 NumPy), the LSRK
coefficients, the interop round trip, and ``pick_chunk``."""
import numpy as np
import pytest
import torch

from adjoint_ode_adaptivity_tpu.march.lsrk import RK4A, RK4B, RK4C
from adjoint_ode_adaptivity_tpu.ops import startup_1d as jax_startup_1d
from adjoint_ode_adaptivity_tpu.ops.operators import element_operators as jax_element_operators
from adjoint_ode_adaptivity_tpu_torch import interop
from adjoint_ode_adaptivity_tpu_torch.march import lsrk
from adjoint_ode_adaptivity_tpu_torch.ops import element_operators, radau_points, startup_1d
from adjoint_ode_adaptivity_tpu_torch.ops.cuda import pick_chunk

torch.set_num_threads(1)  # one intra-op thread a process: the suite runs in xdist workers


def _graded_vx(k):
    # the graded mesh of tests/test_pallas.py::TestPallasNonUniform
    return 2 * np.pi * np.linspace(0.0, 1.0, k + 1) ** 1.6


def _assert_fields_bit_equal(ours, ref):
    assert ours._fields == ref._fields
    for name in ref._fields:
        a, b = getattr(ours, name), getattr(ref, name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            assert a == b, name


@pytest.mark.parametrize(
    "n_order,k,graded", [(2, 16, False), (3, 16, False), (7, 16, False), (2, 24, True)]
)
def test_discretization_bit_equal(n_order, k, graded):
    vx = _graded_vx(k) if graded else None
    _assert_fields_bit_equal(
        startup_1d(n_order, 0.0, 2 * np.pi, k, vx=vx),
        jax_startup_1d(n_order, 0.0, 2 * np.pi, k, vx=vx),
    )


def test_element_operators_and_radau_bit_equal():
    from adjoint_ode_adaptivity_tpu.ops.jacobi import radau_points as jax_radau

    for n in (1, 2, 5):
        ours, ref = element_operators(n), jax_element_operators(n)
        for name in ref:
            np.testing.assert_array_equal(ours[name], ref[name], err_msg=name)
        np.testing.assert_array_equal(radau_points(n), jax_radau(n))


def test_lsrk_coefficients_equal():
    for ours, ref in ((lsrk.RK4A, RK4A), (lsrk.RK4B, RK4B), (lsrk.RK4C, RK4C)):
        np.testing.assert_array_equal(ours, ref)


def test_interop_discretization_round_trip():
    ref = jax_startup_1d(2, 0.0, 2 * np.pi, 0, vx=_graded_vx(24))
    ours = interop.discretization_from_numpy(ref._asdict())
    _assert_fields_bit_equal(ours, ref)
    # a copy, not a view of the caller's arrays
    assert not np.shares_memory(ours.x, ref.x)
    with pytest.raises(KeyError):
        interop.discretization_from_numpy({"n": 2})


def test_pick_chunk():
    assert pick_chunk(2048) == 64
    assert pick_chunk(24) == 8
    assert pick_chunk(7) == 1
    assert pick_chunk(48, (8, 4, 2, 1)) == 8
