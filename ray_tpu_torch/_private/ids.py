"""Unique identifiers for the ray_tpu_torch runtime.

Re-design of the reference's binary ID scheme (reference: src/ray/common/id.h)
in Python: all IDs are fixed-width random byte strings. ObjectIDs embed the
owning task's ID plus a return/put index so lineage can be recovered from the
ID alone, mirroring the reference's ObjectID = TaskID + index layout
(reference: src/ray/common/id.h ObjectID::ForTaskReturn).
"""

from __future__ import annotations

import os
import binascii

# Sizes follow the reference: src/ray/common/id.h
JOB_ID_SIZE = 4
ACTOR_ID_SIZE = 16
TASK_ID_SIZE = 16
OBJECT_ID_SIZE = 20  # TaskID (16) + 4-byte index
NODE_ID_SIZE = 20
WORKER_ID_SIZE = 20
PLACEMENT_GROUP_ID_SIZE = 16


class BaseID:
    SIZE = 20
    __slots__ = ("_bytes", "_hex")

    def __init__(self, id_bytes: bytes):
        if len(id_bytes) != self.SIZE:
            raise ValueError(
                f"{type(self).__name__} requires {self.SIZE} bytes, got {len(id_bytes)}"
            )
        self._bytes = bytes(id_bytes)
        self._hex = None

    @classmethod
    def from_random(cls):
        return cls(os.urandom(cls.SIZE))

    @classmethod
    def _wrap(cls, id_bytes: bytes):
        """Trusted-caller constructor: skips the length check and the
        defensive copy (submission hot path builds thousands of ids/s
        from bytes it just concatenated)."""
        o = object.__new__(cls)
        o._bytes = id_bytes
        o._hex = None
        return o

    @classmethod
    def from_hex(cls, hex_str: str):
        return cls(binascii.unhexlify(hex_str))

    @classmethod
    def nil(cls):
        return cls(b"\xff" * cls.SIZE)

    def is_nil(self) -> bool:
        return self._bytes == b"\xff" * self.SIZE

    def binary(self) -> bytes:
        return self._bytes

    def hex(self) -> str:
        # Memoized: submission/completion hot paths hex the same id
        # several times per task.
        h = self._hex
        if h is None:
            h = self._hex = binascii.hexlify(self._bytes).decode()
        return h

    def __hash__(self):
        return hash(self._bytes)

    def __eq__(self, other):
        return type(other) is type(self) and other._bytes == self._bytes

    def __repr__(self):
        return f"{type(self).__name__}({self.hex()})"


class JobID(BaseID):
    SIZE = JOB_ID_SIZE


class NodeID(BaseID):
    SIZE = NODE_ID_SIZE


class WorkerID(BaseID):
    SIZE = WORKER_ID_SIZE


class ActorID(BaseID):
    SIZE = ACTOR_ID_SIZE


class PlacementGroupID(BaseID):
    SIZE = PLACEMENT_GROUP_ID_SIZE


class TaskID(BaseID):
    SIZE = TASK_ID_SIZE


class ObjectID(BaseID):
    """TaskID(16) + big-endian uint32 index.

    Index 0..2**31 are task returns; >= 2**31 are ray_tpu_torch.put objects
    (mirrors the reference's put/return index split, src/ray/common/id.h).
    """

    SIZE = OBJECT_ID_SIZE
    PUT_INDEX_BASE = 1 << 31

    @classmethod
    def for_task_return(cls, task_id: TaskID, index: int) -> "ObjectID":
        return cls(task_id.binary() + index.to_bytes(4, "big"))

    @classmethod
    def for_put(cls, task_id: TaskID, put_index: int) -> "ObjectID":
        return cls(task_id.binary() + (cls.PUT_INDEX_BASE + put_index).to_bytes(4, "big"))

    def task_id(self) -> TaskID:
        return TaskID(self._bytes[:TASK_ID_SIZE])

    def index(self) -> int:
        return int.from_bytes(self._bytes[TASK_ID_SIZE:], "big")

    def is_put(self) -> bool:
        return self.index() >= self.PUT_INDEX_BASE
