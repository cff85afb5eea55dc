from ray_tpu_torch.train import session
from ray_tpu_torch.train.checkpoint import Checkpoint, CheckpointManager
from ray_tpu_torch.train.config import (
    CheckpointConfig,
    ElasticConfig,
    FailureConfig,
    RunConfig,
    ScalingConfig,
)
from ray_tpu_torch.train.session import get_context, report
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
from ray_tpu_torch.train.trainer import Result, TorchTrainer

__all__ = ["TorchTrainer", "Result", "ScalingConfig", "RunConfig",
           "CheckpointConfig", "ElasticConfig", "FailureConfig", "Checkpoint",
           "CheckpointManager", "session", "get_context", "report",
           "TrainState", "adamw", "init_train_state", "make_train_step",
           "init_sharded_state", "shard_train_step", "state_specs_from_rules",
           "reshard_to_mesh"]
