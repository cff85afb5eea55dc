from ray_tpu_torch.train.spmd import (
    TrainState,
    adamw,
    init_train_state,
    make_train_step,
)

__all__ = ["TrainState", "adamw", "init_train_state", "make_train_step"]
