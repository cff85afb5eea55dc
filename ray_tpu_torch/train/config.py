"""Train configuration dataclasses. Port of ray_tpu/train/config.py
(reference: python/ray/air/config.py: ScalingConfig, RunConfig,
CheckpointConfig, FailureConfig).

The reference's ScalingConfig speaks TPU chips (`use_tpu`,
`tpu_chips_per_worker`); here a worker takes GPUs (`use_gpu`,
`gpus_per_worker`), and its lease pins it to its cards. `use_gpu`
defaults to True: a gang runs on the card unless the caller asks for the
CPU. The reference's STRICT_ICI placement has no counterpart.
`elastic=ElasticConfig(...)` opts the gang into drain-driven resizes
(train/trainer.py's elastic path).
"""

from __future__ import annotations

from dataclasses import dataclass, field

@dataclass
class ElasticConfig:
    """Resize envelope for elastic gang training: a DRAINING member is a
    resize (pause at the step boundary, re-home state through the device
    plane, resume on the survivors), not a checkpoint restart.

    min_workers: the smallest gang that keeps training (below it the
      elastic path gives up and falls back to a checkpoint restart).
    max_workers: the grow-back ceiling (default ScalingConfig.num_workers).
    reshard_timeout_s: the budget for one resize (pause, state hand-off,
      rendezvous); overrunning it falls back to the checkpoint.
    grow_poll_s: how often the trainer probes for restored capacity.
    """

    min_workers: int = 1
    max_workers: int | None = None
    reshard_timeout_s: float = 30.0
    grow_poll_s: float = 2.0


@dataclass
class ScalingConfig:
    """How many workers, what resources, and the mesh.

    num_workers: worker processes (one per card, as torch runs).
    use_gpu: schedule each worker with `gpus_per_worker` GPUs; a share
      below 1 leaves the rest of its card to other leases (Data's
      landing tasks).
    mesh: logical mesh axis sizes for the in-worker SPMD program.
    placement_strategy: PACK/SPREAD/STRICT_PACK/STRICT_SPREAD.
    elastic: opt the gang into drain-driven resizes. An elastic gang is
      scheduled without a placement group (its membership changes at
      run time; DRAINING nodes are already excluded from placement), so
      it excludes the STRICT_* strategies.
    """

    num_workers: int = 1
    use_gpu: bool = True
    gpus_per_worker: float = 1.0
    resources_per_worker: dict | None = None
    mesh: dict | None = None
    placement_strategy: str = "PACK"
    trainer_resources: dict | None = None
    elastic: ElasticConfig | None = None

    def __post_init__(self):
        if self.placement_strategy == "STRICT_ICI":
            raise ValueError(
                "STRICT_ICI places a gang on one TPU slice and has no "
                "counterpart on GPUs; use PACK, SPREAD, STRICT_PACK or "
                "STRICT_SPREAD")

    def worker_resources(self) -> dict:
        res = dict(self.resources_per_worker or {})
        if self.use_gpu:
            res.setdefault("GPU", float(self.gpus_per_worker))
        res.setdefault("CPU", 1.0)
        return res

    def as_placement_group_bundles(self) -> list[dict]:
        return [self.worker_resources() for _ in range(self.num_workers)]


@dataclass
class CheckpointConfig:
    num_to_keep: int | None = None
    checkpoint_frequency: int = 0
    checkpoint_at_end: bool = True


@dataclass
class FailureConfig:
    max_failures: int = 0


@dataclass
class RunConfig:
    name: str | None = None
    storage_path: str | None = None
    checkpoint_config: CheckpointConfig = field(default_factory=CheckpointConfig)
    failure_config: FailureConfig = field(default_factory=FailureConfig)
    verbose: int = 1
