"""Multi-rank scale-out over ``torch.distributed``: rank grids, the
element-sharded DG advection, the member-sharded ensembles and the
pipeline-parallel march (the JAX package's ``parallel/``: meshes,
``dg_shard``, ``ensemble``, ``pipeline``). The kernel pipelines over the
element-sharded grids are ``ops.cuda.dg_sharded``'s; the DG, hp and FD
loops take a grid as ``mesh=`` (``adapt.dg_loop``, ``adapt.hp_loop``,
``adapt.fd_loop``), and so do the fused train steps (``train.loop``);
``init_dp_grid`` gives the drivers' ``--dp`` its grid."""

from adjoint_ode_adaptivity_tpu_torch.parallel.dg_shard import (
    advec_fwd_adj_estimate_sharded,
    advec_march_sharded,
    advec_rhs_local,
    local_operators,
)
from adjoint_ode_adaptivity_tpu_torch.parallel.ensemble import (
    ensemble_batched,
    ensemble_mean,
    ensemble_refinement_signal,
    ensemble_vmap,
)
from adjoint_ode_adaptivity_tpu_torch.parallel.mesh import (
    RankGrid,
    RingShift,
    all_gather,
    all_reduce_sum,
    barrier,
    exchange,
    init_dp_grid,
    make_rank_grid,
    replicate,
    ring_shift,
    shard_along,
)
from adjoint_ode_adaptivity_tpu_torch.parallel.pipeline import pipeline_march

__all__ = [
    "RankGrid",
    "make_rank_grid",
    "shard_along",
    "replicate",
    "exchange",
    "all_reduce_sum",
    "all_gather",
    "barrier",
    "ring_shift",
    "RingShift",
    "init_dp_grid",
    "pipeline_march",
    "ensemble_vmap",
    "ensemble_batched",
    "ensemble_mean",
    "ensemble_refinement_signal",
    "local_operators",
    "advec_rhs_local",
    "advec_march_sharded",
    "advec_fwd_adj_estimate_sharded",
    "make_cuda_fwd_adj_estimate_sharded_blocked",
    "make_cuda_fwd_adj_estimate_tiled_grid_sharded",
]


def __getattr__(name):
    # the kernel pipelines over rank grids live with the kernels; exported
    # here too, loaded on first use (ops.cuda.dg_sharded imports this package)
    if name in ("make_cuda_fwd_adj_estimate_sharded_blocked",
                "make_cuda_fwd_adj_estimate_tiled_grid_sharded"):
        from adjoint_ode_adaptivity_tpu_torch.ops.cuda import dg_sharded

        return getattr(dg_sharded, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
