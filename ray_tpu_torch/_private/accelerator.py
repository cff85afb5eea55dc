"""GPU detection for node resource specs, and per-lease card pinning.

The port's form of the reference's accelerator module
(ray_tpu/_private/accelerator.py: TPU chips counted from /dev/accel*
honouring TPU_VISIBLE_CHIPS, and a jax platform pin per lease). Here the
accelerator is an NVIDIA card:

- A node reports `{"GPU": n}`, n counted honouring CUDA_VISIBLE_DEVICES,
  else from `nvidia-smi -L` or /proc/driver/nvidia/gpus. Counting never
  creates a CUDA context: `torch.cuda.is_available()` and
  `torch.cuda.device_count()` may call cuInit, and a process forked
  after cuInit (the zygote's children) fails its first CUDA call.
- The raylet hands each GPU lease distinct card ids from a per-node free
  list in the native core (`native_raylet_core.py`). At task start a
  pool worker sets CUDA_VISIBLE_DEVICES to its lease's ids, or to ""
  when it holds no GPU, before anything in the process touches CUDA.
- A worker that has already initialised CUDA cannot change what it sees.
  A task whose lease names other cards fails retryable there and the
  worker exits, so the retry lands on a fresh worker
  (`current_task_needs_fresh_worker`).
"""

from __future__ import annotations

import os
import subprocess
import sys

CUDA_VISIBLE_DEVICES_ENV = "CUDA_VISIBLE_DEVICES"


def _nvidia_smi_count() -> int:
    try:
        out = subprocess.run(["nvidia-smi", "-L"], capture_output=True,
                             text=True, timeout=30)
    except (OSError, subprocess.SubprocessError):
        return 0
    if out.returncode != 0:
        return 0
    return sum(1 for line in out.stdout.splitlines()
               if line.startswith("GPU "))


def detect_gpu_ids() -> list[str]:
    """This node's card ids, as CUDA_VISIBLE_DEVICES names them: the
    entries of that variable where it is set ("" means none), else
    0..n-1 for the n cards the driver reports."""
    visible = os.environ.get(CUDA_VISIBLE_DEVICES_ENV)
    if visible is not None:
        return [c.strip() for c in visible.split(",") if c.strip() != ""]
    try:
        n = len(os.listdir("/proc/driver/nvidia/gpus"))
    except OSError:
        n = 0
    if n == 0:
        n = _nvidia_smi_count()
    return [str(i) for i in range(n)]


# ---------------------------------------------------------------------------
# Per-lease card pinning for pool workers.
# ---------------------------------------------------------------------------

# The card ids the current task's lease holds (None: no task yet).
_current_task_gpus: list[str] | None = None
# CUDA_VISIBLE_DEVICES as this process set it for its first CUDA use;
# frozen once CUDA is initialised.
_pinned_visible: str | None = None


def cuda_initialized() -> bool:
    """True once this process has initialised CUDA through torch (the
    check itself touches no CUDA)."""
    torch = sys.modules.get("torch")
    if torch is None:
        return False
    try:
        return bool(torch.cuda.is_initialized())
    except Exception:
        return False


def set_current_task_gpus(gpu_ids) -> None:
    global _current_task_gpus
    _current_task_gpus = [str(g) for g in (gpu_ids or [])]


def current_task_visible() -> str:
    return ",".join(_current_task_gpus or [])


def pinned_visible() -> str | None:
    return _pinned_visible


def current_task_needs_fresh_worker() -> bool:
    """True when this worker's frozen card set cannot serve the current
    task: CUDA is initialised here over other cards than the lease's."""
    return (cuda_initialized() and _pinned_visible is not None
            and _pinned_visible != current_task_visible())


def pin_cuda_visible_devices() -> None:
    """Set CUDA_VISIBLE_DEVICES to the current lease's cards, unless
    CUDA is already initialised (then the pin is frozen and
    `current_task_needs_fresh_worker` decides)."""
    global _pinned_visible
    if cuda_initialized():
        if _pinned_visible is None:
            _pinned_visible = os.environ.get(CUDA_VISIBLE_DEVICES_ENV, "")
        return
    visible = current_task_visible()
    os.environ[CUDA_VISIBLE_DEVICES_ENV] = visible
    _pinned_visible = visible


def worker_env() -> dict[str, str]:
    """Environment a pool worker starts with: no card until a lease
    names one, and torch's availability check on NVML, which does not
    call cuInit."""
    return {CUDA_VISIBLE_DEVICES_ENV: "",
            "PYTORCH_NVML_BASED_CUDA_CHECK": "1"}
