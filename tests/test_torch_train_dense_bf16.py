"""T2's bf16 mode (ops/cuda/train_dense_fused.py ``mxu_dtype=torch.bfloat16``)
on the CPU: the plain version, which rounds the hidden products' operands to
bf16 (round to nearest even) and accumulates in its own dtype, against the
JAX package's Pallas kernel with ``mxu_dtype=jnp.bfloat16`` in interpret
mode; the bf16 bound of ``dense_kernel_tolerance`` (float32 roundoff of the
mode within it, the float32 mode outside it); the bf16 layout and plans; and
``make_shared_train_step_fused(..., mxu_dtype=torch.bfloat16)`` against the
JAX fused step in that mode.

Tolerance: each gradient entry within twice its bf16 bound, as
tests/test_torch_train_fused.py holds the float32 mode to its bound. The
kernel itself runs only on a GPU (tests/test_torch_cuda.py, chip_smoke.py
phase 38)."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from adjoint_ode_adaptivity_tpu.models.blocks import ResNetBlock
from adjoint_ode_adaptivity_tpu.ops.pallas.train_dense_fused import make_pallas_dense_epoch_grad
from adjoint_ode_adaptivity_tpu.train import loop as jl
from adjoint_ode_adaptivity_tpu_torch import interop
from adjoint_ode_adaptivity_tpu_torch.ops.cuda import train_dense_fused as td
from adjoint_ode_adaptivity_tpu_torch.train import loop

torch.set_num_threads(1)  # one intra-op thread a process: the suite runs in xdist workers

BF16 = torch.bfloat16


def _setup(sizes, s=4, b=16, seed=49):
    """tests/test_pallas_train.py's bf16 case: flax init plus noise, float32."""
    p = ResNetBlock(sizes).init(jax.random.PRNGKey(seed), jnp.ones(1), 0.0, 0.1)["params"]
    rng = np.random.default_rng(seed)
    p = jax.tree_util.tree_map(
        lambda x: (np.asarray(x) + 0.1 * rng.normal(size=x.shape)).astype(np.float32), p)
    dt = rng.uniform(0.05, 0.15, s).astype(np.float32)
    u0s = rng.uniform(-2, 2, b).astype(np.float32)
    return p, dt, u0s, (np.sin(u0s) + 0.3).astype(np.float32)


def _outside(got, want, bound):
    """Entries of the gradient pytree ``got`` farther than twice their bound
    from ``want``."""
    n = 0
    for k in want:
        for leaf in ("kernel", "bias"):
            d = np.abs(np.asarray(got[k][leaf], np.float64) - np.asarray(want[k][leaf], np.float64))
            n += int(np.sum(d > 2 * bound[k][leaf].numpy()))
    return n


def test_bf16_plain_version_matches_the_pallas_kernel():
    """At tests/test_pallas_train.py's (3, 6, 5): the bf16 plain version
    (float32) within twice its bound of the Pallas kernel's bf16 mode; the
    float32 mode's result lies outside that bound, the bf16 one inside."""
    sizes = (3, 6, 5)
    p, dt, u0s, trues = _setup(sizes)
    want_loss, want = make_pallas_dense_epoch_grad(4, sizes, interpret=True,
                                                   mxu_dtype=jnp.bfloat16)(
        p, jnp.asarray(dt), jnp.asarray(u0s), jnp.asarray(trues))
    pt = interop.dense_params_from_numpy(p)
    args = [torch.from_numpy(x) for x in (dt, u0s, trues)]
    loss, got = td.make_cuda_dense_epoch_grad(4, sizes, device="cpu", mxu_dtype=BF16)(pt, *args)
    tol = td.dense_kernel_tolerance(pt, sizes, *args, mxu_dtype=BF16)
    assert abs(float(loss) - float(want_loss)) <= 2 * tol["loss"]
    assert _outside(got, want, tol["grads"]) == 0
    _, got32 = td.make_cuda_dense_epoch_grad(4, sizes, device="cpu")(pt, *args)
    assert _outside(got32, want, tol["grads"]) > 10


def test_bf16_bound_covers_float32_roundoff_and_bites():
    """(16, 32), B = 96, S = 6, float64 reference of the bf16 mode: the
    float32 evaluation of the mode within its bound, the float32 mode
    (float64) outside it."""
    sizes = (16, 32)
    p, dt, u0s, trues = _setup(sizes, s=6, b=96, seed=5)
    pt = interop.dense_params_from_numpy(p)
    args = [torch.from_numpy(x) for x in (dt, u0s, trues)]
    a64 = [a.double() for a in args]
    _, want = td.dense_epoch_grad_plain(pt, sizes, *a64, mxu_dtype=BF16)
    _, got = td.dense_epoch_grad_plain(pt, sizes, *args, mxu_dtype=BF16)
    tol = td.dense_kernel_tolerance(pt, sizes, *args, mxu_dtype=BF16)
    assert _outside(got, want, tol["grads"]) == 0
    _, f32_mode = td.dense_epoch_grad_plain(pt, sizes, *a64)
    assert _outside(f32_mode, want, tol["grads"]) > 10


def test_bf16_layout_and_plans():
    """Widths pad to 16 with zeros that survive a round trip; the plans at
    (100, 500) (padded (112, 512)); half-size weight slices."""
    sizes = (100, 500)
    p, *_ = _setup((3, 6, 5))
    pt = interop.dense_params_from_numpy(p)
    theta = td.pack_dense(pt, (3, 6, 5), mxu_dtype=BF16)
    layout = td.dense_layout((3, 6, 5), BF16)
    assert [shape for _, _, shape in layout][:4] == [(16,), (16,), (16, 16), (16,)]
    back = td.unpack_dense(theta, (3, 6, 5), BF16)
    for k in pt:
        for leaf in ("kernel", "bias"):
            np.testing.assert_array_equal(back[k][leaf].numpy(), pt[k][leaf].numpy())
    assert int((theta != 0).sum()) == sum(int((x != 0).sum()) for k in pt for x in pt[k].values())
    for b, want in ((8192, (64, 2)), (512, (32, 8))):
        plan = td.dense_plan(sizes, b, mxu_dtype=BF16)
        assert (plan.block_members, plan.cluster) == want and plan.bf16
        assert plan.smem_bytes == td.dense_smem_bytes(sizes, *want, BF16) <= td.SMEM_BYTES
        assert plan.smem_bytes < td.dense_smem_bytes(sizes, *want)
    assert (32, 1) in set(td._feasible(sizes, BF16)) and (32, 1) not in set(td._feasible(sizes))
    assert not td.dense_plan(sizes, 512).bf16
    with pytest.raises(ValueError, match="mxu_dtype"):
        td.dense_layout(sizes, torch.float16)


def test_bf16_fused_train_step_matches_the_jax_fused_step():
    """make_shared_train_step_fused(..., mxu_dtype=bfloat16) on the CPU (the
    bf16 plain version) against the JAX fused step in that mode (Pallas,
    interpret): two Adam steps, the loss to 2e-6 relative and the
    parameters to 2e-6, as the float32 mode's test holds them."""
    sizes = (8, 16)
    p, dt, u0s, trues = _setup(sizes, s=3, b=32, seed=3)
    tx, ptx = optax.adam(1e-3), loop.Adam(1e-3)
    jstep = jl.make_shared_train_step_fused(tx, jnp.asarray(dt), sizes, interpret=True,
                                            block_members=32, mxu_dtype=jnp.bfloat16)
    pstep = loop.make_shared_train_step_fused(ptx, torch.from_numpy(dt), sizes, device="cpu",
                                              mxu_dtype=BF16)
    js = jl.create_train_state(jax.tree_util.tree_map(jnp.asarray, p), tx)
    ps = loop.create_train_state(interop.dense_params_from_numpy(p), ptx)
    for _ in range(2):
        js, jloss = jstep(js, jnp.asarray(u0s), jnp.asarray(trues))
        ps, ploss = pstep(ps, torch.from_numpy(u0s), torch.from_numpy(trues))
        np.testing.assert_allclose(float(ploss), float(jloss), rtol=2e-6)
    for a, b in zip(jax.tree_util.tree_leaves(interop.tree_to_numpy(ps.params)),
                    jax.tree_util.tree_leaves(js.params)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=2e-6)
