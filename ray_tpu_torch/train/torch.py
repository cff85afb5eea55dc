"""prepare_model / prepare_data_loader for a gang's train loop. Port of
ray_tpu/train/torch.py (reference: python/ray/train/torch/
train_loop_utils.py, prepare_model wraps DistributedDataParallel).

The reference's TorchTrainer here is a JaxTrainer with a gloo process
group; the port's trainer is TorchTrainer itself (`train/trainer.py`),
whose gang is such a group on NCCL or gloo, so this module keeps the
loop helpers that use it.
"""

from __future__ import annotations

from ray_tpu_torch.train.trainer import Result, TorchTrainer


def prepare_model(model):
    """Wrap for data-parallel training over the gang's default group
    (reference: prepare_model -> DDP). No-op for a world of one."""
    import torch.distributed as dist
    from torch.nn.parallel import DistributedDataParallel

    if dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1:
        return DistributedDataParallel(model)
    return model


def prepare_data_loader(loader):
    """Re-batch a DataLoader with a DistributedSampler shard (reference:
    prepare_data_loader). No-op for a world of one."""
    import torch.distributed as dist
    from torch.utils.data import DataLoader
    from torch.utils.data.distributed import DistributedSampler

    if not (dist.is_available() and dist.is_initialized()
            and dist.get_world_size() > 1):
        return loader
    sampler = DistributedSampler(loader.dataset,
                                 num_replicas=dist.get_world_size(),
                                 rank=dist.get_rank())
    return DataLoader(loader.dataset, batch_size=loader.batch_size,
                      sampler=sampler, num_workers=0,
                      collate_fn=loader.collate_fn,
                      drop_last=loader.drop_last)


__all__ = ["TorchTrainer", "prepare_model", "prepare_data_loader", "Result"]
