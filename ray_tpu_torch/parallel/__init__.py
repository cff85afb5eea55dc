from ray_tpu_torch.parallel.mesh import (
    AXIS_ORDER,
    MeshConfig,
    data_axes,
    initialize_multihost,
    make_mesh,
    mesh_axis_size,
)
from ray_tpu_torch.parallel.pipeline import (
    merge_microbatches,
    pipeline_apply,
    split_microbatches,
    stage_slice_params,
)
from ray_tpu_torch.parallel.sharding import (
    TRANSFORMER_RULES,
    P,
    ShardingRules,
    batch_spec,
    num_params,
    shard_tree,
    with_rules_constraint,
)

__all__ = [
    "MeshConfig", "make_mesh", "AXIS_ORDER", "data_axes", "mesh_axis_size",
    "initialize_multihost", "ShardingRules", "TRANSFORMER_RULES", "P",
    "batch_spec", "shard_tree", "with_rules_constraint", "num_params",
    "pipeline_apply", "split_microbatches", "merge_microbatches",
    "stage_slice_params",
]
