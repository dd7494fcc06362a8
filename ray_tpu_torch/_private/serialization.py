"""Value (de)serialization for the object plane.

Analog of the reference's SerializationContext
(ray: python/ray/_private/serialization.py:108): cloudpickle for closures +
pickle protocol 5 out-of-band buffers so numpy arrays round-trip through the
shm store without copies on the read side. A serialized value is

  metadata: pickled {"fmt": ..., "buf_lens": [...], "nested_refs": [...]}
  data:     [8B pickle_len][pickle bytes][buffer 0][buffer 1]...

Errors are serialized with fmt="error" so ``get`` re-raises on the caller
(ray: python/ray/exceptions.py RayTaskError semantics).

Torch tensors. A CPU tensor pickles as torch pickles it (in-band, through
its storage's ``torch.save`` blob), as the reference's ``jax.Array`` does.
A CUDA tensor travels as its host bytes (one out-of-band buffer) plus its
dtype, shape and a device tag, and ``_rebuild_cuda_tensor`` puts it back on
the reader's current card where the reader sees one, else on the CPU, as
the reference rebuilds an array on the reader's default device. Torch's own
pickle of a CUDA tensor is rebuilt on ``cuda:<index>`` by ``torch.load`` and
raises in a process that hides the card itself (every RLlib env runner, an
actor whose ``runtime_env`` sets ``CUDA_VISIBLE_DEVICES=""``). No lease
narrows ``CUDA_VISIBLE_DEVICES`` (``raylet.py``), as no lease narrows the
chips a worker sees in the reference (one worker process owns all local
chips there), so an actor at ``num_gpus=0`` on a card's node sees the card,
and a CUDA tensor it reads is rebuilt there on its current card: a CUDA
context and card memory outside any lease. That is a limit the port shares
with the reference, which rebuilds an array on the reader's default device
the same way, not a fault of the port. Only plain ``torch.Tensor`` objects
take this path: a
``Parameter`` reduces to its ``.data``, which then does; other subclasses
pickle as torch pickles them.
"""

from __future__ import annotations

import io
import pickle
import sys
from typing import Any, List, Tuple

import cloudpickle

from ray_tpu_torch._private import object_ref as _object_ref

FMT_PICKLE5 = b"P5"
FMT_ERROR = b"ER"
FMT_RAW = b"RW"  # raw bytes payload, zero-copy


def _nbytes(b) -> int:
    return b.nbytes if isinstance(b, memoryview) else len(b)


class BufferList:
    """Wire form of a serialized value's data: the ordered buffer list of a
    ``SerializedValue`` (``[8B pickle_len][pickle][buf0][buf1]...``) kept as
    separate buffers instead of one joined blob.

    Pickling a BufferList under protocol 5 wraps each large member in a
    ``PickleBuffer``: over a v2 rpc connection those ride the frame's
    out-of-band buffer table — the payload bytes are written to the socket
    by reference and arrive as zero-copy memoryviews over the receiver's
    read buffer. Over a v1 connection (or any protocol-5 pickle without a
    buffer_callback) the same members serialize in-band — one copy, same
    bytes — so mixed-version peers interoperate. Unpickling yields a
    BufferList of bytes/memoryview members in the original order;
    ``deserialize`` consumes either form.
    """

    __slots__ = ("buffers",)

    def __init__(self, buffers):
        self.buffers = buffers if isinstance(buffers, list) else list(buffers)

    @property
    def nbytes(self) -> int:
        return sum(_nbytes(b) for b in self.buffers)

    def concat(self) -> bytes:
        bufs = self.buffers
        if len(bufs) == 1 and isinstance(bufs[0], bytes):
            return bufs[0]
        return b"".join(bufs)

    def __reduce_ex__(self, protocol):
        if protocol >= 5:
            # same tunable the connection's buffer_callback applies: below
            # it, a table entry + unjoined write costs more than the memcpy
            from ray_tpu_torch._private.config import GLOBAL_CONFIG

            oob_min = GLOBAL_CONFIG.rpc_oob_min_bytes
            return (BufferList, ([
                pickle.PickleBuffer(b) if _nbytes(b) >= oob_min
                else (b if isinstance(b, bytes) else bytes(b))
                for b in self.buffers
            ],))
        return (BufferList, ([
            b if isinstance(b, bytes) else bytes(b) for b in self.buffers
        ],))


class SerializedValue:
    __slots__ = ("metadata", "buffers", "total_data_len", "nested_refs")

    def __init__(self, metadata, buffers, total_data_len, nested_refs):
        self.metadata = metadata
        self.buffers = buffers
        self.total_data_len = total_data_len
        self.nested_refs = nested_refs

    def to_bytes(self) -> bytes:
        """Materialize the data as ONE bytes object (a snapshot: exactly one
        copy per buffer via join; buffers already bytes are returned or
        joined without an intermediate ``bytes(b)`` copy)."""
        bufs = self.buffers
        if len(bufs) == 1 and isinstance(bufs[0], bytes):
            return bufs[0]  # raw-bytes value: no copy at all
        return b"".join(bufs)

    def to_wire(self) -> BufferList:
        """Zero-copy wire form: the live buffer list (views into the value
        being serialized — e.g. a numpy array's memory). Large members cross
        v2 rpc frames out-of-band without ever being copied on the send
        side. Because the views alias the caller's value, the caller must
        not mutate the underlying buffers until the send completes (for a
        task call: until its result future resolves)."""
        return BufferList(self.buffers)


def _rebuild_cuda_tensor(host, dtype, shape, device_tag, requires_grad):
    """A CUDA tensor's host bytes ``host`` (uint8 numpy, read-only when it
    is a view of the store) back as a tensor of ``dtype`` and ``shape``: on
    the reader's current card where one is visible, else a CPU copy (the
    copy never aliases the store). ``device_tag`` ("cuda:0") names the
    writer's card; the reader's card is its own current one."""
    import warnings

    import torch

    with warnings.catch_warnings():  # read-only source: copied just below
        warnings.simplefilter("ignore", UserWarning)
        flat = torch.from_numpy(host)
    if torch.cuda.is_available():
        out = flat.to(torch.device("cuda", torch.cuda.current_device()))
    else:
        out = flat.clone()
    out = out.view(dtype).reshape(shape)
    if requires_grad:
        out.requires_grad_(True)
    return out


def _reduce_cuda_tensor(t):
    import torch

    host = t.detach().contiguous().reshape(-1).view(torch.uint8).cpu().numpy()
    return (_rebuild_cuda_tensor,
            (host, t.dtype, tuple(t.shape), str(t.device),
             bool(t.requires_grad and t.is_leaf)))


class _Pickler(cloudpickle.Pickler):
    """cloudpickle's pickler, with plain CUDA tensors reduced to host bytes
    plus a device tag (module docstring)."""

    def reducer_override(self, obj):
        torch = sys.modules.get("torch")  # a tensor implies torch is loaded
        if torch is not None and type(obj) is torch.Tensor and obj.is_cuda:
            return _reduce_cuda_tensor(obj)
        return super().reducer_override(obj)


def _dumps(value, buffer_callback) -> bytes:
    with io.BytesIO() as f:
        _Pickler(f, protocol=5, buffer_callback=buffer_callback).dump(value)
        return f.getvalue()


def _pack(fmt: bytes, pickled: bytes, oob: List, nested_refs) -> SerializedValue:
    buf_lens = [len(b) for b in oob]
    meta = pickle.dumps(
        {"fmt": fmt, "buf_lens": buf_lens, "nested_refs": nested_refs}, protocol=5
    )
    buffers = [len(pickled).to_bytes(8, "little"), pickled] + oob
    total = 8 + len(pickled) + sum(buf_lens)
    return SerializedValue(meta, buffers, total, nested_refs)


def serialize(value: Any) -> SerializedValue:
    if isinstance(value, bytes):
        meta = pickle.dumps({"fmt": FMT_RAW, "buf_lens": [], "nested_refs": []})
        return SerializedValue(meta, [value], len(value), [])
    oob: List = []

    def buffer_callback(pb: pickle.PickleBuffer):
        view = pb.raw()
        # store-layout threshold (distinct from the wire's
        # rpc_oob_min_bytes): tiny buffers stay inside the pickled stream
        if view.nbytes >= 512:
            oob.append(view)
            return False
        return True

    _object_ref.start_ref_capture()
    try:
        pickled = _dumps(value, buffer_callback)
        nested = [(r.binary(), r.owner) for r in _object_ref.captured_refs()]
    finally:
        _object_ref.stop_ref_capture()
    return _pack(FMT_PICKLE5, pickled, oob, nested)


def serialize_error(exc: BaseException, task_info: str = "") -> SerializedValue:
    import traceback

    tb = "".join(traceback.format_exception(type(exc), exc, exc.__traceback__))
    try:
        payload = cloudpickle.dumps((exc, tb, task_info), protocol=5)
    except Exception:
        payload = cloudpickle.dumps(
            (RuntimeError(f"{type(exc).__name__}: {exc}"), tb, task_info), protocol=5
        )
    return _pack(FMT_ERROR, payload, [], [])


class TaskError(Exception):
    """Wraps an exception raised inside a task, carrying the remote traceback.

    Analog of ray.exceptions.RayTaskError: re-raised at every ``get`` site.
    """

    def __init__(self, cause: BaseException, remote_traceback: str, task_info: str = ""):
        self.cause = cause
        self.remote_traceback = remote_traceback
        self.task_info = task_info
        super().__init__(str(cause))

    def __reduce__(self):
        return (type(self), (self.cause, self.remote_traceback, self.task_info))

    def __str__(self):
        return (
            f"{type(self.cause).__name__}: {self.cause}\n"
            f"--- remote traceback ({self.task_info}) ---\n{self.remote_traceback}"
        )


def deserialize(metadata: bytes, data) -> Any:
    """Deserialize from metadata + data, where ``data`` is a bytes-like view
    (zero-copy capable) or a ``BufferList`` as received off a v2 rpc frame
    (zero-copy: buffers are consumed in place, never joined)."""
    meta = pickle.loads(metadata)
    fmt = meta["fmt"]
    if isinstance(data, BufferList):
        bufs = data.buffers
        # fast path: the list still has _pack's structure
        # [8B pickle_len][pickle][oob buffers matching buf_lens] — feed the
        # out-of-band buffers straight to pickle without reassembly
        if (
            fmt != FMT_RAW
            and len(bufs) == len(meta["buf_lens"]) + 2
            and _nbytes(bufs[0]) == 8
            and int.from_bytes(bytes(bufs[0]), "little") == _nbytes(bufs[1])
            and all(
                _nbytes(b) == n for b, n in zip(bufs[2:], meta["buf_lens"])
            )
        ):
            value = pickle.loads(
                bufs[1], buffers=[memoryview(b) for b in bufs[2:]]
            )
            if fmt == FMT_ERROR:
                exc, tb, info = value
                raise TaskError(exc, tb, info)
            return value
        data = data.concat()  # re-chunked upstream: fall through
    if fmt == FMT_RAW and isinstance(data, bytes):
        return data
    view = memoryview(data)
    if fmt == FMT_RAW:
        return bytes(view)
    plen = int.from_bytes(bytes(view[:8]), "little")
    pickled = view[8 : 8 + plen]
    offset = 8 + plen
    buffers = []
    for blen in meta["buf_lens"]:
        buffers.append(view[offset : offset + blen])
        offset += blen
    # pickle.loads takes any buffer: feed the envelope as a view so a
    # slab/mmap-backed read never copies the pickle blob either — the
    # whole deserialize is views into the arena mapping
    value = pickle.loads(pickled, buffers=buffers)
    if fmt == FMT_ERROR:
        exc, tb, info = value
        raise TaskError(exc, tb, info)
    return value
