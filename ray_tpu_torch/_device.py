"""Device resolution for the port's entry points.

`None` means CUDA. A CUDA device with no card present raises: the port
never drops to the CPU on its own, the caller asks for it by name.
"""

from __future__ import annotations

import contextlib

import torch


def resolve_device(device=None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "ray_tpu_torch needs a CUDA device and none is available; "
            "pass device='cpu' to run the plain PyTorch versions")
    return dev


def device_context(device: torch.device):
    """Make `device` current on this thread (kernels launched through
    ctypes go to the current device)."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()
