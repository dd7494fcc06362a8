from ray_tpu_torch.parallel.collectives import (
    all_gather,
    all_gather_replicated,
    chunked_psum,
    compiled_allreduce,
    pbroadcast,
    pmean,
    ppermute_next,
    psum,
    psum_replicated,
    quantized_psum,
    reduce_scatter,
)
from ray_tpu_torch.parallel.mesh_utils import (
    apply_tp_plan,
    auto_mesh,
    create_mesh,
    data_sharding,
    logical_to_physical,
    shard_index,
    shard_params_fsdp,
)
from ray_tpu_torch.parallel.pipeline import (
    build_pipeline_fn,
    pipeline_apply,
    stack_stage_params,
)

# create_hybrid_mesh and mesh_from_cluster wait for multi-node meshes
# (ROADMAP). The reference's replicated() sharding is what DDP gives the
# parameters it wraps, so it has no helper here.
__all__ = [
    "all_gather",
    "all_gather_replicated",
    "apply_tp_plan",
    "auto_mesh",
    "build_pipeline_fn",
    "chunked_psum",
    "compiled_allreduce",
    "create_mesh",
    "data_sharding",
    "logical_to_physical",
    "pbroadcast",
    "pipeline_apply",
    "pmean",
    "ppermute_next",
    "psum",
    "psum_replicated",
    "quantized_psum",
    "reduce_scatter",
    "shard_index",
    "shard_params_fsdp",
    "stack_stage_params",
]
