"""The plain versions of the two fused training-epoch kernels against the
JAX package: T1 (ops/cuda/train_fused.py) against
``make_pallas_resblock_epoch_grad(..., interpret=True)`` in its plain,
masked, mixed and weighted variants and against ``jax.value_and_grad`` of
the XLA loss; T2 (ops/cuda/train_dense_fused.py) against
``make_pallas_dense_epoch_grad(..., interpret=True)`` and the XLA loss. On
the CPU the wrappers run these plain versions.

Tolerances: against the interpret-mode kernels both sides are float32 with
their own summation orders, so each gradient entry is held to twice its
float32 bound (each side lies within one bound of the exact value), and
some entries must exceed their bound. T1's bound
(``resblock_kernel_tolerance``) is the first-order error of every member
contribution plus the reduction, per entry; T2's (``dense_kernel_tolerance``)
is calibrated by a float32 evaluation of the sweep: 16 times its largest
deviation relative to each entry's summed contribution magnitudes, plus the
reduction and a charge for relus within reach of a switch. Against
value_and_grad in float64 the same function is evaluated in another order:
1e-12 relative.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adjoint_ode_adaptivity_tpu.models.blocks import ResBlockSimple, ResBlockSimpleMasked, ResNetBlock
from adjoint_ode_adaptivity_tpu.march.fd import forward_march, forward_march_per_step
from adjoint_ode_adaptivity_tpu.ops.pallas.train_dense_fused import make_pallas_dense_epoch_grad
from adjoint_ode_adaptivity_tpu.ops.pallas.train_fused import make_pallas_resblock_epoch_grad
from adjoint_ode_adaptivity_tpu.train.losses import terminal_mse, trajectory_trapezoid
from adjoint_ode_adaptivity_tpu_torch import interop
from adjoint_ode_adaptivity_tpu_torch import models as torch_models
from adjoint_ode_adaptivity_tpu_torch.ops.cuda import train_dense_fused as td
from adjoint_ode_adaptivity_tpu_torch.ops.cuda import train_fused as tf

torch.set_num_threads(1)  # one intra-op thread a process: the suite runs in xdist workers

S, F, B = 3, 24, 128


def T(x):
    return jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a, copy=True)), x)


def _setup(seed=0, s=S, f=F, b=B):
    p1 = ResBlockSimple(f).init(jax.random.PRNGKey(seed), jnp.ones(1), 0.0, 0.1)["params"]
    rng = np.random.default_rng(seed)
    params = {k: (np.stack([np.asarray(v)] * s)
                  + 0.05 * rng.normal(size=(s,) + v.shape)).astype(np.float32)
              for k, v in p1.items()}
    dt = rng.uniform(0.05, 0.15, s).astype(np.float32)
    u0s = rng.uniform(-2, 2, b).astype(np.float32)
    trues = (np.sin(u0s) + 0.3).astype(np.float32)
    traj = np.stack([np.sin(u0s * (1 + 0.1 * n)) for n in range(s + 1)]).astype(np.float32)
    return params, dt, u0s, trues, traj


VARIANTS = {
    "plain": {},
    "masked": dict(masked=True),
    "mixed": dict(mixed=True),
    "weighted": {},
}


def _call_args(variant, dt, u0s, trues, traj):
    kw = {}
    if variant == "masked":
        kw["n_active"] = np.array([F, 7, 15], np.int32)
    if variant == "mixed":
        kw["ramp_weight"] = 0.7
    if variant == "weighted":
        kw["weights"] = (np.arange(B) % 3 != 0).astype(np.float32)
    return (dt, u0s, traj if variant == "mixed" else trues), kw


def _bounds(params, variant, args, kw, reduce_terms=None):
    dt, u0s, tg = (torch.from_numpy(np.asarray(a)) for a in args)
    w = kw.get("weights")
    w = None if w is None else torch.from_numpy(w)
    na = kw.get("n_active")
    tol = tf.resblock_kernel_tolerance(
        tf.pack_params(T(params), S, F), dt, u0s, tg, w,
        None if na is None else torch.from_numpy(na), kw.get("ramp_weight"),
        inv_b=1.0 if w is not None else 1.0 / B, mixed=variant == "mixed",
        reduce_terms=reduce_terms)
    live = 1.0 if w is None else float(w.sum())
    return tol["loss"] / live, tf.unpack_grads(tol["grads"] / live, S, F)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_t1_plain_version_matches_the_pallas_kernel(variant):
    params, dt, u0s, trues, traj = _setup(seed=1)
    args, kw = _call_args(variant, dt, u0s, trues, traj)
    jrun = make_pallas_resblock_epoch_grad(S, F, interpret=True, **VARIANTS[variant])
    jkw = {k: (jnp.asarray(v, jnp.float32) if k == "n_active" else jnp.asarray(v))
           for k, v in kw.items()}
    want_loss, want = jrun(params, *(jnp.asarray(a) for a in args), **jkw)
    prun = tf.make_cuda_resblock_epoch_grad(S, F, device="cpu", **VARIANTS[variant])
    pkw = {k: torch.from_numpy(np.asarray(v)) if k != "ramp_weight" else v for k, v in kw.items()}
    loss, got = prun(T(params), *(torch.from_numpy(np.asarray(a)) for a in args), **pkw)
    assert loss.dtype == torch.float32 and got["weights2"].shape == (S, 1, F)
    loss_b, bound = _bounds(params, variant, args, kw, reduce_terms=B)
    assert abs(float(loss) - float(want_loss)) <= 2 * loss_b
    teeth = 0
    for k in ("bias", "weights1", "weights2"):
        diff = np.abs(got[k].numpy().astype(np.float64) - np.asarray(want[k], np.float64))
        assert np.all(diff <= 2 * bound[k].numpy()), k
        teeth += int(np.sum(np.abs(np.asarray(want[k])) > bound[k].numpy()))
    assert teeth > S * F
    if variant == "masked":
        for n, na in enumerate(kw["n_active"]):
            for k in ("bias", "weights1", "weights2"):
                assert not got[k][n].reshape(-1)[na:].any()


def _xla_loss(params, dt, u0s, trues, variant, kw):
    """The XLA per-step loss of train/loop.py (vmapped members), float64."""
    masked = variant == "masked"
    net = ResBlockSimpleMasked(F) if masked else ResBlockSimple(F)

    def step(u, t, d, pm):
        if masked:
            return net.apply({"params": pm[0]}, u, t, d, pm[1])
        return net.apply({"params": pm}, u, t, d)

    def one(p, u0, tg):
        stacked = (p, jnp.asarray(kw["n_active"])) if masked else p
        u = forward_march_per_step(step, jnp.atleast_1d(u0), dt, stacked)
        if variant == "mixed":
            return trajectory_trapezoid(u, tg, dt), terminal_mse(u, tg[-1])
        return terminal_mse(u, tg), 0.0

    def loss(p):
        new, old = jax.vmap(lambda a, b: one(p, a, b))(u0s, trues)
        if variant == "mixed":
            return jnp.mean(new) + kw["ramp_weight"] * jnp.mean(old)
        if variant == "weighted":
            w = jnp.asarray(kw["weights"], jnp.float64)
            return jnp.sum(w * new) / jnp.sum(w)
        return jnp.mean(new)

    return jax.value_and_grad(loss)(params)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_t1_plain_version_matches_value_and_grad_of_the_xla_loss(variant):
    params, dt, u0s, trues, traj = _setup(seed=2)
    args, kw = _call_args(variant, dt, u0s, trues, traj)
    p64 = {k: v.astype(np.float64) for k, v in params.items()}
    a64 = [np.asarray(a, np.float64) for a in args]
    tg = a64[2].T if variant == "mixed" else a64[2]
    want_loss, want = _xla_loss(p64, jnp.asarray(a64[0]), jnp.asarray(a64[1]), jnp.asarray(tg),
                                variant, kw)
    w = kw.get("weights")
    w = None if w is None else torch.from_numpy(w.astype(np.float64))
    na = kw.get("n_active")
    loss, g = tf.resblock_epoch_grad_plain(
        tf.pack_params(T(p64), S, F).double(), *(torch.from_numpy(a) for a in a64), w,
        None if na is None else torch.from_numpy(na), kw.get("ramp_weight"),
        inv_b=1.0 if w is not None else 1.0 / B, mixed=variant == "mixed")
    live = 1.0 if w is None else float(w.sum())
    got = tf.unpack_grads(g / live, S, F)
    np.testing.assert_allclose(float(loss) / live, float(want_loss), rtol=1e-12)
    for k in ("bias", "weights1", "weights2"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-12, atol=1e-15)


def test_t1_bound_covers_float32_roundoff_and_padding_contracts():
    # the float32 plain version lies within its bound of the float64 one;
    # zero-dt padded steps and inactive neurons have bound 0 and are exactly 0
    params, dt, u0s, trues, _ = _setup(seed=3)
    pad = {k: np.concatenate([v, v[:2]]) for k, v in params.items()}
    dt_p = np.concatenate([dt, np.zeros(2, np.float32)])
    na = torch.tensor([F, 5, 24, 9, 1])
    packed = tf.pack_params(T(pad), S + 2, F)
    args = [torch.from_numpy(x) for x in (dt_p, u0s, trues)]
    l32, g32 = tf.resblock_epoch_grad_plain(packed, *args, n_active=na, inv_b=1.0 / B)
    l64, g64 = tf.resblock_epoch_grad_plain(packed.double(), *(a.double() for a in args),
                                            n_active=na, inv_b=1.0 / B)
    tol = tf.resblock_kernel_tolerance(packed, *args, n_active=na, inv_b=1.0 / B,
                                       reduce_terms=B)
    assert np.all((g32.double() - g64).abs().numpy() <= tol["grads"].numpy())
    assert abs(float(l32) - float(l64)) <= tol["loss"]
    assert not g32[:, S:].any() and not tol["grads"][:, S:].any()
    assert not g32[:, 1, 5:].any() and not tol["grads"][:, 1, 5:].any()
    assert int((g64.abs() > tol["grads"]).sum()) > S * F
    # the padded run equals the unpadded one on the live steps
    l_s, g_s = tf.resblock_epoch_grad_plain(tf.pack_params(T(params), S, F),
                                            *(torch.from_numpy(x) for x in (dt, u0s, trues)),
                                            n_active=na[:S], inv_b=1.0 / B)
    assert torch.equal(l_s, l32) and torch.equal(g_s, g32[:, :S])


def test_t1_wrapper_checks_its_inputs():
    params, dt, u0s, trues, traj = _setup()
    run = tf.make_cuda_resblock_epoch_grad(S, F, mixed=True, device="cpu")
    with pytest.raises(ValueError, match="full"):
        run(T(params), torch.from_numpy(dt), torch.from_numpy(u0s), torch.from_numpy(trues),
            ramp_weight=0.1)
    with pytest.raises(ValueError, match="ramp_weight"):
        run(T(params), torch.from_numpy(dt), torch.from_numpy(u0s), torch.from_numpy(traj))
    with pytest.raises(ValueError, match="n_active"):
        tf.make_cuda_resblock_epoch_grad(S, F, masked=True, device="cpu")(
            T(params), torch.from_numpy(dt), torch.from_numpy(u0s), torch.from_numpy(trues))


def _dense_setup(sizes, s=4, b=16, seed=41):
    p = ResNetBlock(sizes).init(jax.random.PRNGKey(seed), jnp.ones(1), 0.0, 0.1)["params"]
    rng = np.random.default_rng(seed)
    p = jax.tree_util.tree_map(
        lambda x: (np.asarray(x) + 0.1 * rng.normal(size=x.shape)).astype(np.float32), p)
    dt = rng.uniform(0.05, 0.15, s).astype(np.float32)
    dt[1] = 0.0
    u0s = rng.uniform(-2, 2, b).astype(np.float32)
    return p, dt, u0s, (np.sin(u0s) + 0.3).astype(np.float32)


@pytest.mark.parametrize("sizes", [(8, 16), (5,), (3, 6, 5)])
def test_t2_plain_version_matches_the_pallas_kernel_and_xla(sizes):
    p, dt, u0s, trues = _dense_setup(sizes)
    s = dt.shape[0]
    want_loss, want = make_pallas_dense_epoch_grad(s, sizes, interpret=True)(
        p, jnp.asarray(dt), jnp.asarray(u0s), jnp.asarray(trues))
    pt = interop.dense_params_from_numpy(p)
    args = [torch.from_numpy(x) for x in (dt, u0s, trues)]
    loss, got = td.make_cuda_dense_epoch_grad(s, sizes, device="cpu")(pt, *args)
    tol = td.dense_kernel_tolerance(pt, sizes, *args)
    assert abs(float(loss) - float(want_loss)) <= 2 * tol["loss"]
    teeth = 0
    for k in want:
        for leaf in ("kernel", "bias"):
            bnd = tol["grads"][k][leaf].numpy()
            w = np.asarray(want[k][leaf], np.float64)
            assert got[k][leaf].shape == w.shape
            assert np.all(np.abs(got[k][leaf].numpy() - w) <= 2 * bnd), (k, leaf)
            teeth += int(np.sum(np.abs(w) > bnd))
    assert teeth > 10
    # float64: the same function as jax.value_and_grad of the XLA loss
    net = ResNetBlock(sizes)
    p64 = jax.tree_util.tree_map(lambda x: np.asarray(x, np.float64), p)

    def xla(pp):
        def one(u0, tr):
            u = forward_march(lambda u_, t, d: net.apply({"params": pp}, u_, t, d),
                              jnp.atleast_1d(u0), jnp.asarray(dt, jnp.float64))
            return terminal_mse(u, tr)

        return jnp.mean(jax.vmap(one)(jnp.asarray(u0s, jnp.float64),
                                      jnp.asarray(trues, jnp.float64)))

    wl, wg = jax.value_and_grad(xla)(p64)
    l64, g64 = td.dense_epoch_grad_plain(interop.dense_params_from_numpy(p64), sizes,
                                         *(a.double() for a in args))
    np.testing.assert_allclose(float(l64), float(wl), rtol=1e-12)
    for k in wg:
        for leaf in ("kernel", "bias"):
            np.testing.assert_allclose(g64[k][leaf].numpy(), np.asarray(wg[k][leaf]),
                                       rtol=1e-11, atol=1e-15)


def test_t2_zero_dt_steps_are_inert_and_the_packing_round_trips():
    sizes = (8, 16)
    p, dt, u0s, trues = _dense_setup(sizes, s=3, seed=43)
    pt = interop.dense_params_from_numpy(p)
    args = [torch.from_numpy(x) for x in (u0s, trues)]
    dt_p = torch.from_numpy(np.concatenate([dt, np.zeros(3, np.float32)]))
    l0, g0 = td.dense_epoch_grad_plain(pt, sizes, torch.from_numpy(dt), *args)
    l1, g1 = td.dense_epoch_grad_plain(pt, sizes, dt_p, *args)
    assert torch.equal(l0, l1)
    for k in g0:
        for leaf in g0[k]:
            assert torch.equal(g0[k][leaf], g1[k][leaf])
    theta = td.pack_dense(pt, sizes)
    assert theta.numel() == 2 * 8 + 8 * 16 + 16 + 16 + 1
    back = td.unpack_dense(theta, sizes)
    for k in pt:
        for leaf in pt[k]:
            assert torch.equal(back[k][leaf], pt[k][leaf])
    np.testing.assert_array_equal(theta[16:16 + 128].view(8, 16).numpy(), p["Dense_1"]["kernel"])
    assert td.dense_block_members((100, 500)) == 64
    lf, flat = td.dense_epoch_grad(theta, sizes, torch.from_numpy(dt), *args)
    gf = td.unpack_dense(flat, sizes)
    assert torch.equal(lf, l0) and torch.equal(gf["Dense_1"]["kernel"], g0["Dense_1"]["kernel"])


def _permuted(params: dict, perm: torch.Tensor) -> dict:
    """The same network with the first hidden layer's neurons reordered."""
    q = {k: dict(v) for k, v in params.items()}
    q["Dense_0"] = {"kernel": params["Dense_0"]["kernel"][:, perm],
                    "bias": params["Dense_0"]["bias"][perm]}
    q["Dense_1"] = {"kernel": params["Dense_1"]["kernel"][perm], "bias": params["Dense_1"]["bias"]}
    return q


@pytest.mark.parametrize("sizes,b,s", [((8, 16), 64, 4), ((100, 500), 256, 3)])
def test_t2_bound_holds_for_another_float32_order_and_tells_a_wrong_gradient(sizes, b, s):
    """dense_kernel_tolerance against a float32 evaluation in another order
    (the first hidden layer's neurons and the members permuted): every entry
    within its bound, most entries of every leaf above it, dead and zero-dt
    entries exactly 0; a zeroed leaf or a member left out fails it."""
    gen = torch.Generator().manual_seed(5)
    params = torch_models.ResNetBlock(sizes).init_params(gen)
    params = {k: {q: v + 0.1 * torch.randn(v.shape, generator=gen) for q, v in d.items()}
              for k, d in params.items()}
    rng = np.random.default_rng(6)
    dt = torch.tensor(rng.uniform(0.05, 0.15, s), dtype=torch.float32)
    dt[1] = 0.0
    u0 = torch.tensor(rng.uniform(-2, 2, b), dtype=torch.float32)
    tr = torch.sin(u0) + 0.3
    tol = td.dense_kernel_tolerance(params, sizes, dt, u0, tr)
    p64 = {k: {q: v.double() for q, v in d.items()} for k, d in params.items()}
    l64, g64 = td.dense_epoch_grad_plain(p64, sizes, dt.double(), u0.double(), tr.double())
    perm = torch.randperm(sizes[0], generator=gen)
    mem = torch.randperm(b, generator=gen)
    l32, gp = td.dense_epoch_grad_plain(_permuted(params, perm), sizes, dt, u0[mem], tr[mem])
    g32 = _permuted(gp, torch.argsort(perm))
    assert abs(float(l32) - float(l64)) <= tol["loss"]
    for k in g64:
        for q in g64[k]:
            bnd = tol["grads"][k][q]
            assert bool(((g32[k][q].double() - g64[k][q]).abs() <= bnd).all()), (k, q)
            live = int((bnd > 0).sum())
            assert 2 * int((g64[k][q].abs() > bnd).sum()) > live > 0, (k, q)
            assert not g32[k][q][bnd == 0].any()
    # a zeroed leaf, and the gradient of the other b - 1 members: both fail
    for k, q in (("Dense_0", "kernel"), (f"Dense_{len(sizes)}", "bias")):
        assert bool((g64[k][q].abs() > tol["grads"][k][q]).any()), (k, q)
    _, g_rest = td.dense_epoch_grad_plain(p64, sizes, dt.double(), u0[1:].double(), tr[1:].double())
    assert any(bool(((g_rest[k][q] * (b - 1) / b - g64[k][q]).abs() > tol["grads"][k][q]).any())
               for k in g64 for q in g64[k])


@pytest.mark.parametrize("sizes,b,want", [
    ((100, 500), 512, (32, 8)), ((100, 500), 8192, (64, 2)), ((100, 500), 62, (16, 8)),
    ((4, 8, 4), 512, (16, 1)), ((4, 8, 4), 8192, (64, 1)),
    ((64,) * 8, 512, (32, 8)), ((64,) * 8, 8192, (64, 2)), ((12,), 1000, (16, 1))])
def test_t2_plan_picks_the_tile_and_the_cluster(sizes, b, want):
    """dense_plan on a 132-SM card: the first (BM, C), largest tile then
    fewest CTAs, that fills 128 CTAs, else the most CTAs; each CTA within
    its shared memory (csrc make_layout's sizes), every rank owning columns
    of every split layer, one CTA for a single hidden layer."""
    plan = td.dense_plan(sizes, b)
    assert (plan.block_members, plan.cluster) == want
    assert plan.n_tiles == -(-b // plan.block_members)
    assert plan.smem_bytes == td.dense_smem_bytes(sizes, *want) <= td.SMEM_BYTES
    for p in (td.pad4(x) for x in sizes[1:]):
        assert (plan.cluster - 1) * td._slice_width(p, plan.cluster) < p
    if plan.n_tiles * plan.cluster < 128:  # nothing fills the card: the most CTAs
        assert all(-(-b // bm) * c <= plan.n_tiles * plan.cluster
                   for bm in td.TILE_MEMBERS for c in td.CLUSTER_SIZES
                   if (bm, c) in set(td._feasible(tuple(sizes))))
    # (100, 500)'s W_1 (200 KB) fits no single CTA: the cluster is what holds it
    assert td.dense_smem_bytes((100, 500), 16, 1) > td.SMEM_BYTES
    with pytest.raises(ValueError):
        td.dense_plan((20000,), b)


@pytest.mark.parametrize("sizes,b,s,plan", [((100, 500), 96, 2, (32, 8)),
                                            ((8, 16), 70, 4, (16, 4)),
                                            ((3, 6, 5), 40, 3, (16, 2)),
                                            ((16,) * 8, 48, 2, (16, 4))])
def test_t2_cluster_split_order_stays_within_the_tolerance(sizes, b, s, plan):
    """A float32 emulation of the kernel's reduction structure (tiles of BM
    members, every split layer over C column slices, f's partial dots and
    da's partial products summed in rank order, the tiles in order) lies
    within dense_kernel_tolerance of the float64 plain version at that
    (BM, C), entry by entry, most entries of every leaf above their bound,
    zero-bound entries exactly 0; a zeroed leaf and a tile left out do
    not."""
    gen = torch.Generator().manual_seed(7)
    params = torch_models.ResNetBlock(sizes).init_params(gen)
    params = {k: {q: v + 0.1 * torch.randn(v.shape, generator=gen) for q, v in d.items()}
              for k, d in params.items()}
    rng = np.random.default_rng(8)
    dt = torch.tensor(rng.uniform(0.05, 0.15, s), dtype=torch.float32)
    dt[1] = 0.0
    u0 = torch.tensor(rng.uniform(-2, 2, b), dtype=torch.float32)
    tr = torch.sin(u0) + 0.3
    bm, c = plan
    tol = td.dense_kernel_tolerance(params, sizes, dt, u0, tr, block_members=bm, cluster=c)
    p64 = {k: {q: v.double() for q, v in d.items()} for k, d in params.items()}
    l64, g64 = td.dense_epoch_grad_plain(p64, sizes, dt.double(), u0.double(), tr.double())
    l32, g32 = td.dense_epoch_grad_split_plain(params, sizes, dt, u0, tr, bm, c)
    assert l32.dtype == torch.float32 and abs(float(l32) - float(l64)) <= tol["loss"]
    for k in g64:
        for q in g64[k]:
            bnd = tol["grads"][k][q]
            assert g32[k][q].shape == g64[k][q].shape
            assert bool(((g32[k][q].double() - g64[k][q]).abs() <= bnd).all()), (k, q)
            live = int((bnd > 0).sum())
            assert 2 * int((g64[k][q].abs() > bnd).sum()) > live > 0, (k, q)
            assert not g32[k][q][bnd == 0].any()
    # in float64 the split is the same function as the plain version
    l_s, g_s = td.dense_epoch_grad_split_plain(p64, sizes, dt.double(), u0.double(),
                                               tr.double(), bm, c)
    assert abs(float(l_s) - float(l64)) <= 1e-12 * abs(float(l64))
    for k in g64:
        for q in g64[k]:
            np.testing.assert_allclose(g_s[k][q].numpy(), g64[k][q].numpy(), rtol=1e-10,
                                       atol=1e-14)
    # teeth: the first hidden layer's kernel zeroed, and the first tile left out
    assert bool((g64["Dense_0"]["kernel"].abs() > tol["grads"]["Dense_0"]["kernel"]).any())
    _, g_rest = td.dense_epoch_grad_split_plain(params, sizes, dt, u0[bm:], tr[bm:], bm, c)
    assert any(bool(((g_rest[k][q].double() * (b - bm) / b - g64[k][q]).abs()
                     > tol["grads"][k][q]).any()) for k in g64 for q in g64[k])


def _t1_split_setup(variant, s_steps=4, f=70, b=300, seed=9):
    """A per-step net of F = 70 (three lanes' worth of neurons, the last
    partial), a zero-dt last step, and the variant's extras."""
    gen = torch.Generator().manual_seed(seed)
    ps = [torch_models.ResBlockSimple(f).init_params(gen) for _ in range(s_steps)]
    packed = tf.pack_params({k: torch.stack([q[k] for q in ps]) for k in ps[0]}, s_steps, f)
    rng = np.random.default_rng(seed)
    dt = torch.tensor(rng.uniform(0.05, 0.15, s_steps), dtype=torch.float32)
    dt[-1] = 0.0
    u0 = torch.tensor(rng.uniform(-2, 2, b), dtype=torch.float32)
    tg = (torch.stack([torch.sin(u0 * (1 + 0.1 * n)) for n in range(s_steps + 1)])
          if variant == "mixed" else torch.sin(u0) + 0.3)
    kw = {"mixed": variant == "mixed"}
    if variant == "masked":
        kw["n_active"] = torch.tensor([f, 3, 40, f - 1], dtype=torch.int32)
    if variant == "mixed":
        kw["ramp_weight"] = 0.7
    if variant == "weighted":
        kw["weights"] = torch.tensor(rng.uniform(size=b) < 0.6, dtype=torch.float32)
    return packed, dt, u0, tg, kw, 1.0 if variant == "weighted" else 1.0 / b


@pytest.mark.parametrize("bm", [16, 64])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_t1_split_order_stays_within_the_tolerance(variant, bm):
    """A float32 emulation of T1's summation order on the card (a member's
    neuron sums over 32 lanes joined by the xor butterfly, each tile's
    members in order, the tiles' partials in groups of 16) lies within
    resblock_kernel_tolerance of the float64 plain version at the plan's
    reduce_terms_of, entry by entry, with B = 300 a tile count that does not
    divide it (19 tiles of 16, the last 12; 5 of 64, the last 44); the
    zero-dt step and the inactive neurons exactly 0; the per-leaf teeth
    (most entries of every leaf above their bound) hold, and a wrong
    gradient (one leaf 1 % off, or a tile of members left out) fails."""
    packed, dt, u0, tg, kw, inv_b = _t1_split_setup(variant)
    b = u0.shape[0]
    plan = tf.ResblockPlan(bm, -(-b // bm))
    assert b % bm
    l32, g32 = tf.resblock_epoch_grad_split_plain(packed, dt, u0, tg, inv_b=inv_b, plan=plan,
                                                  **kw)
    d64 = {k: (v.double() if isinstance(v, torch.Tensor) and v.is_floating_point() else v)
           for k, v in kw.items()}
    l64, g64 = tf.resblock_epoch_grad_plain(packed.double(), dt.double(), u0.double(),
                                            tg.double(), inv_b=inv_b, **d64)
    tol = tf.resblock_kernel_tolerance(packed, dt, u0, tg, inv_b=inv_b,
                                       reduce_terms=tf.reduce_terms_of(plan), **kw)
    assert l32.dtype == torch.float32 and abs(float(l32) - float(l64)) <= tol["loss"]
    assert bool(((g32.double() - g64).abs() <= tol["grads"]).all())
    for i in range(3):
        live = int((tol["grads"][i] > 0).sum())
        assert 2 * int((g64[i].abs() > tol["grads"][i]).sum()) > live > 0, i
    assert not g32[:, -1].any() and not g32[tol["grads"] == 0].any()
    if variant == "masked":
        for n, na in enumerate(kw["n_active"].tolist()):
            assert not g32[:, n, na:].any()
    for i in range(3):
        wrong = g32.clone()
        wrong[i] *= 1.01
        assert not bool(((wrong.double() - g64).abs() <= tol["grads"]).all()), i
    rest = {k: (v[bm:] if k == "weights" else v) for k, v in kw.items()}
    tg_rest = tg[:, bm:] if variant == "mixed" else tg[bm:]
    _, g_rest = tf.resblock_epoch_grad_split_plain(packed, dt, u0[bm:], tg_rest, inv_b=inv_b,
                                                   plan=tf.ResblockPlan(bm, plan.n_tiles - 1),
                                                   **rest)
    assert not bool(((g_rest.double() - g64).abs() <= tol["grads"]).all())


def test_t1_plan_and_its_reduction():
    """resblock_plan on a 132-SM card: the largest member tile whose tiles
    give 3/4 of a CTA an SM (B = 8192: 64 members, 128 tiles; 3000: 16;
    1024 and below: 8); the reduction's length BM + min(tiles, 16) +
    ⌈tiles/16⌉, which at the path's B = 8192 (88) lies below the per-member
    kernel's ⌈B/32⌉ + 5 (261); the tolerance's default takes it."""
    P = tf.ResblockPlan
    assert tf.resblock_plan(8192) == P(64, 128)
    assert tf.resblock_plan(3000) == P(16, 188)
    assert tf.resblock_plan(1024) == P(8, 128)
    assert tf.resblock_plan(77) == P(8, 10)
    assert tf.reduce_terms_of(P(64, 128)) == 88 < -(-8192 // 32) + 5
    assert tf.reduce_terms_of(P(8, 10)) == 8 + 10 + 1
    packed, dt, u0, tg, kw, inv_b = _t1_split_setup("plain")
    default = tf.resblock_kernel_tolerance(packed, dt, u0, tg, inv_b=inv_b)
    explicit = tf.resblock_kernel_tolerance(packed, dt, u0, tg, inv_b=inv_b,
                                            reduce_terms=tf.reduce_terms_of(tf.resblock_plan(300)))
    assert torch.equal(default["grads"], explicit["grads"])
