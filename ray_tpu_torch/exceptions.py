"""Public exception hierarchy.

Parity: python/ray/exceptions.py in the reference (RayError, RayTaskError,
RayActorError, GetTimeoutError, ObjectLostError, ...).
"""

from __future__ import annotations


class RayTpuError(Exception):
    """Base class for all ray_tpu_torch errors."""


class TaskError(RayTpuError):
    """A task raised an exception during execution.

    Re-raised at `ray_tpu_torch.get` with the remote traceback attached
    (reference: python/ray/exceptions.py RayTaskError)."""

    def __init__(self, cause: BaseException, remote_traceback: str = "",
                 task_name: str = ""):
        self.cause = cause
        self.remote_traceback = remote_traceback
        self.task_name = task_name
        super().__init__(
            f"task {task_name!r} failed: {type(cause).__name__}: {cause}\n"
            f"--- remote traceback ---\n{remote_traceback}"
        )


class ActorError(RayTpuError):
    """An actor died before or while executing a submitted method
    (reference: RayActorError)."""


class ActorDiedError(ActorError):
    pass


class ActorUnavailableError(ActorError):
    pass


class GetTimeoutError(RayTpuError, TimeoutError):
    pass


class ObjectLostError(RayTpuError):
    """All copies of an object were lost and it could not be reconstructed
    (reference: ObjectLostError / ObjectReconstructionFailedError)."""

    def __init__(self, object_id_hex: str, message: str = ""):
        self.object_id_hex = object_id_hex
        super().__init__(message or f"object {object_id_hex} lost")


class OwnerDiedError(ObjectLostError):
    pass


class DeviceObjectLostError(ObjectLostError):
    """The worker pinning a device-resident object (HBM tensor) died or
    dropped the pin before a consumer resolved it. Owners recover via
    lineage reconstruction (the creating task re-executes and re-pins);
    borrowers observe this error."""


class TaskCancelledError(RayTpuError):
    pass


class WorkerCrashedError(RayTpuError):
    pass


class RuntimeEnvSetupError(RayTpuError):
    pass


class PlacementGroupSchedulingError(RayTpuError):
    pass


class OutOfMemoryError(RayTpuError):
    pass


class NodeDiedError(RayTpuError):
    pass
