"""ObjectRef: a future for a task return or put object.

Like the reference's ObjectRef (ray: python/ray/includes/object_ref.pxi), each
ref carries the binary ObjectID plus the owner's address so any holder can
locate the value (ownership-based object directory,
ray: src/ray/object_manager/ownership_based_object_directory.h). Refs support
``ray.get`` via the connected core worker and are serializable; serializing a
ref inside task args registers it as a dependency via a thread-local capture
list (ray: python/ray/_private/serialization.py object-ref capture).
"""

from __future__ import annotations

import threading
from typing import Optional

from ray_tpu_torch._private.ids import ObjectID

_capture = threading.local()


def start_ref_capture():
    _capture.refs = []


def captured_refs():
    return getattr(_capture, "refs", [])


def stop_ref_capture():
    refs = getattr(_capture, "refs", [])
    _capture.refs = None
    return refs


class ObjectRef:
    __slots__ = ("_id", "_owner", "_hash", "_counted", "__weakref__")

    def __init__(self, object_id: ObjectID, owner: Optional[tuple] = None):
        # owner: (node_id_hex, client_id_hex) of the owning core worker.
        self._id = object_id
        self._owner = owner
        self._hash = hash(object_id)
        # Set by CoreWorker.add_local_ref: this Python object holds one local
        # refcount on the owned object, released in __del__.
        self._counted = False

    def id(self) -> ObjectID:
        return self._id

    def binary(self) -> bytes:
        return self._id.binary()

    def hex(self) -> str:
        return self._id.hex()

    @property
    def owner(self):
        return self._owner

    def __hash__(self):
        return self._hash

    def __eq__(self, other):
        return isinstance(other, ObjectRef) and other._id == self._id

    def __repr__(self):
        return f"ObjectRef({self._id.hex()})"

    def __reduce__(self):
        refs = getattr(_capture, "refs", None)
        if refs is not None:
            refs.append(self)
        return (_rebuild_ref, (self._id.binary(), self._owner))

    def __del__(self):
        # NEVER release synchronously: __del__ runs at arbitrary GC points,
        # including inside core-worker sections that already hold the
        # ref-count lock (a same-thread re-acquire deadlocks). Enqueue the
        # release on a lock-free deque the worker drains outside its lock.
        if not getattr(self, "_counted", False):
            return
        try:
            from ray_tpu_torch._private.worker import global_worker

            cw = global_worker.core_worker
            if cw is not None and cw.connected:
                cw.defer_ref_release(self._id.binary())
        except Exception:
            pass

    def future(self):
        """Return a concurrent.futures.Future for this ref (via core worker)."""
        from ray_tpu_torch._private.worker import global_worker

        return global_worker.core_worker.future_for(self)

    def __await__(self):
        import asyncio

        fut = self.future()
        return asyncio.wrap_future(fut).__await__()


def _rebuild_ref(binary: bytes, owner):
    ref = ObjectRef(ObjectID(binary), owner)
    # When deserialized inside a connected worker, record the borrow so the
    # owner keeps the value alive (simplified borrower protocol,
    # ray: src/ray/core_worker/reference_count.h:61).
    try:
        from ray_tpu_torch._private.worker import global_worker

        if global_worker.connected:
            global_worker.core_worker.register_borrowed_ref(ref)
    except Exception:
        pass
    return ref
