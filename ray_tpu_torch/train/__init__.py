from ray_tpu_torch.train.spmd import (
    TrainState,
    adamw,
    init_sharded_state,
    init_train_state,
    make_train_step,
    reshard_to_mesh,
    shard_train_step,
    state_specs_from_rules,
)

__all__ = ["TrainState", "adamw", "init_train_state", "make_train_step",
           "init_sharded_state", "shard_train_step", "state_specs_from_rules",
           "reshard_to_mesh"]
