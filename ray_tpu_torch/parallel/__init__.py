from ray_tpu_torch.parallel.collectives import (
    all_gather,
    chunked_psum,
    compiled_allreduce,
    pmean,
    psum,
    quantized_psum,
    reduce_scatter,
)
from ray_tpu_torch.parallel.mesh_utils import (
    auto_mesh,
    create_mesh,
    data_sharding,
    shard_index,
    shard_params_fsdp,
)

# ppermute_next waits for sequence parallelism; create_hybrid_mesh,
# mesh_from_cluster and logical_to_physical for multi-node meshes (ROADMAP).
# The reference's replicated() sharding is what DDP gives the parameters
# it wraps, so it has no helper here.
__all__ = [
    "all_gather",
    "auto_mesh",
    "chunked_psum",
    "compiled_allreduce",
    "quantized_psum",
    "create_mesh",
    "data_sharding",
    "pmean",
    "psum",
    "reduce_scatter",
    "shard_index",
    "shard_params_fsdp",
]
