"""Binary ID types with embedded lineage.

Mirrors the reference's ID hierarchy (ray: src/ray/common/id.h): JobID (4B) is
embedded in ActorID (16B), ActorID in TaskID (24B), and TaskID in ObjectID
(28B, TaskID + 4B little-endian return index). IDs are immutable bytes with
hex round-tripping; random IDs come from ``os.urandom``.
"""

from __future__ import annotations

import os

JOB_ID_SIZE = 4
ACTOR_ID_UNIQUE_BYTES = 12
ACTOR_ID_SIZE = ACTOR_ID_UNIQUE_BYTES + JOB_ID_SIZE  # 16
TASK_ID_UNIQUE_BYTES = 8
TASK_ID_SIZE = TASK_ID_UNIQUE_BYTES + ACTOR_ID_SIZE  # 24
OBJECT_ID_INDEX_BYTES = 4
OBJECT_ID_SIZE = TASK_ID_SIZE + OBJECT_ID_INDEX_BYTES  # 28
UNIQUE_ID_SIZE = 28
NODE_ID_SIZE = 28
WORKER_ID_SIZE = 28
PLACEMENT_GROUP_ID_SIZE = 18


class BaseID:
    """Immutable fixed-width binary identifier."""

    SIZE = UNIQUE_ID_SIZE
    __slots__ = ("_binary", "_hash")

    def __init__(self, binary: bytes):
        if not isinstance(binary, (bytes, bytearray)):
            raise TypeError(f"{type(self).__name__} requires bytes, got {type(binary)}")
        if len(binary) != self.SIZE:
            raise ValueError(
                f"{type(self).__name__} requires {self.SIZE} bytes, got {len(binary)}"
            )
        object.__setattr__(self, "_binary", bytes(binary))
        object.__setattr__(self, "_hash", hash((type(self).__name__, bytes(binary))))

    @classmethod
    def from_random(cls):
        return cls(os.urandom(cls.SIZE))

    @classmethod
    def from_hex(cls, hex_str: str):
        return cls(bytes.fromhex(hex_str))

    @classmethod
    def nil(cls):
        return cls(b"\xff" * cls.SIZE)

    def binary(self) -> bytes:
        return self._binary

    def hex(self) -> str:
        return self._binary.hex()

    def is_nil(self) -> bool:
        return self._binary == b"\xff" * self.SIZE

    def __hash__(self):
        return self._hash

    def __eq__(self, other):
        return type(other) is type(self) and other._binary == self._binary

    def __ne__(self, other):
        return not self.__eq__(other)

    def __lt__(self, other):
        return self._binary < other._binary

    def __repr__(self):
        return f"{type(self).__name__}({self.hex()})"

    def __reduce__(self):
        return (type(self), (self._binary,))


class UniqueID(BaseID):
    SIZE = UNIQUE_ID_SIZE


class NodeID(BaseID):
    SIZE = NODE_ID_SIZE


class WorkerID(BaseID):
    SIZE = WORKER_ID_SIZE


class JobID(BaseID):
    SIZE = JOB_ID_SIZE

    @classmethod
    def from_int(cls, value: int) -> "JobID":
        return cls(value.to_bytes(JOB_ID_SIZE, "little"))

    def int_value(self) -> int:
        return int.from_bytes(self._binary, "little")


class ActorID(BaseID):
    SIZE = ACTOR_ID_SIZE

    @classmethod
    def of(cls, job_id: JobID) -> "ActorID":
        return cls(os.urandom(ACTOR_ID_UNIQUE_BYTES) + job_id.binary())

    def job_id(self) -> JobID:
        return JobID(self._binary[ACTOR_ID_UNIQUE_BYTES:])


class TaskID(BaseID):
    SIZE = TASK_ID_SIZE

    @classmethod
    def for_task(cls, job_id: JobID) -> "TaskID":
        nil_actor = b"\xff" * ACTOR_ID_UNIQUE_BYTES + job_id.binary()
        return cls(os.urandom(TASK_ID_UNIQUE_BYTES) + nil_actor)

    @classmethod
    def for_actor_task(cls, actor_id: ActorID) -> "TaskID":
        return cls(os.urandom(TASK_ID_UNIQUE_BYTES) + actor_id.binary())

    @classmethod
    def for_driver(cls, job_id: JobID) -> "TaskID":
        nil_actor = b"\xff" * ACTOR_ID_UNIQUE_BYTES + job_id.binary()
        return cls(b"\x00" * TASK_ID_UNIQUE_BYTES + nil_actor)

    def actor_id(self) -> ActorID:
        return ActorID(self._binary[TASK_ID_UNIQUE_BYTES:])

    def job_id(self) -> JobID:
        return self.actor_id().job_id()


class ObjectID(BaseID):
    SIZE = OBJECT_ID_SIZE

    @classmethod
    def from_index(cls, task_id: TaskID, index: int) -> "ObjectID":
        """Return object for the index-th return of task (1-based, like the ref)."""
        return cls(task_id.binary() + index.to_bytes(OBJECT_ID_INDEX_BYTES, "little"))

    @classmethod
    def for_put(cls, task_id: TaskID, put_index: int) -> "ObjectID":
        # Put objects use the high bit of the index to avoid colliding with returns.
        idx = put_index | 0x80000000
        return cls(task_id.binary() + idx.to_bytes(OBJECT_ID_INDEX_BYTES, "little"))

    def task_id(self) -> TaskID:
        return TaskID(self._binary[:TASK_ID_SIZE])

    def job_id(self) -> JobID:
        return self.task_id().job_id()

    def return_index(self) -> int:
        return int.from_bytes(self._binary[TASK_ID_SIZE:], "little") & 0x7FFFFFFF


class PlacementGroupID(BaseID):
    SIZE = PLACEMENT_GROUP_ID_SIZE

    @classmethod
    def of(cls, job_id: JobID) -> "PlacementGroupID":
        return cls(os.urandom(PLACEMENT_GROUP_ID_SIZE - JOB_ID_SIZE) + job_id.binary())


# --- submit hot path: block minting + raw wire forms -------------------
# The per-call cost of ``TaskID.for_task(JobID(...))`` is an urandom
# syscall plus two ID-object constructions (each with an isinstance/size
# check and an eager hash); ``ObjectID.from_index`` adds an int.to_bytes
# per return. The submit fast path (worker.submit_from_template) works in
# raw bytes instead: TaskSpec.task_id is bytes on the wire anyway.

_IDX_BYTES = tuple(
    i.to_bytes(OBJECT_ID_INDEX_BYTES, "little") for i in range(256)
)
_CTR_BYTES = tuple(bytes((i,)) for i in range(256))


def object_id_binary(task_binary: bytes, index: int) -> bytes:
    """28-byte ObjectID wire form for the index-th return of a task (same
    layout as ``ObjectID.from_index``) without intermediate ID objects."""
    if index < 256:
        return task_binary + _IDX_BYTES[index]
    return task_binary + index.to_bytes(OBJECT_ID_INDEX_BYTES, "little")


class TaskIDMinter:
    """Amortized task-id minting: one ``os.urandom`` call covers a block
    of ``BLOCK`` ids — a 7-byte random prefix plus a block-local counter
    byte form the 8 unique bytes of a TaskID. One minter per (worker,
    remote function / actor); the 16-byte suffix (nil-actor + job for
    plain tasks, the actor id for actor tasks) is fixed at construction.

    Uniqueness matches per-call minting: two blocks collide with
    probability 2^-56, and ids within a block differ in the counter byte.

    Thread safety: the whole block is pre-built as a list and handed out
    via ``list.pop()`` (atomic under the GIL). Racing refills at block
    exhaustion each draw their own random prefix, so ids are never
    duplicated — at worst a partial block is abandoned."""

    BLOCK = 64
    __slots__ = ("_suffix", "_block")

    def __init__(self, suffix: bytes):
        if len(suffix) != ACTOR_ID_SIZE:
            raise ValueError(
                f"minter suffix must be {ACTOR_ID_SIZE} bytes, "
                f"got {len(suffix)}"
            )
        self._suffix = bytes(suffix)
        self._block: list = []

    @classmethod
    def for_job(cls, job_id: JobID) -> "TaskIDMinter":
        return cls(b"\xff" * ACTOR_ID_UNIQUE_BYTES + job_id.binary())

    @classmethod
    def for_actor(cls, actor_id: ActorID) -> "TaskIDMinter":
        return cls(actor_id.binary())

    def next_binary(self) -> bytes:
        """24-byte TaskID wire form; a fresh random block every BLOCK
        calls. Blocks hand out ids in descending counter order (pop from
        the tail is O(1)); order within a block carries no meaning."""
        try:
            return self._block.pop()
        except IndexError:
            prefix = os.urandom(TASK_ID_UNIQUE_BYTES - 1)
            suffix = self._suffix
            self._block = blk = [
                prefix + _CTR_BYTES[i] + suffix
                for i in range(self.BLOCK)
            ]
            return blk.pop()
