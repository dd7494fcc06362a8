"""Collective communication library.

API parity with the reference's ray.util.collective
(ray: python/ray/util/collective/collective.py:120-655 — init_collective_group,
create_collective_group, allreduce, allgather, reducescatter, broadcast,
send, recv, barrier), with the NCCL/Gloo backends replaced by:

- backend="nccl" (DEFAULT, the fast path): every rank is a process of ONE
  ``torch.distributed`` process group (which Train's TorchConfig forms for
  every worker gang: NCCL on CUDA cards, gloo on CPUs); the group runs on
  that process group and each op is one ``torch.distributed`` call
  (``all_reduce``/``all_gather_into_tensor``/``reduce_scatter_tensor``/
  ``broadcast``/``barrier``), so on a node of H100s the transfer rides
  NVLink. Collectives still belong INSIDE the train step for the inner
  loop (DDP's reducer, FSDP2); this API is the out-of-step parity surface.
- backend="store": a GCS-KV rendezvous fallback that works between any
  actors on any nodes with no process group, the analog of the reference's
  Gloo CPU backend. send/recv p2p always uses this path.

Out-of-step ops here are for control-plane-sized data (weight broadcast,
metric reduction); inner-loop gradient reduction belongs inside the step
(DDP, FSDP2, ray_tpu_torch.parallel's hooks), exactly as NCCL-allreduce
lives inside torch DDP in the reference.

The store-path allreduce is not a naive payload swap: three composable,
independently flag-gated levers rebuild the hot path (each A/B-able
against the steptrace (group, seq) skew series PR 11 shipped):

1. **Chunked pipeline transport** (``collective_chunk_bytes``, default
   1MB; 0 = off): tensors above the threshold are reduce-scattered and
   allgathered in fixed-size chunks — each rank OWNS 1/world of the
   tensor, peers publish their contribution chunks, the owner
   accumulates and republishes the reduced chunk as soon as its last
   contribution lands, and bounded in-flight windows
   (``collective_pipeline_depth``, one window per fetch kind) keep
   reduction of chunk N overlapping the RPC round trips of chunk N+1.
   Chunk payloads ride
   rpcio's v2 out-of-band buffer table (``BufferList``): tensor bytes
   are never copied into a pickle envelope.
2. **Block-wise int8 quantization** (EQuARX-style, arxiv 2506.17615):
   ``quant="int8"`` per group (or ``RAY_TPU_TORCH_collective_quant``) puts a
   per-chunk symmetric scale + int8 payload on the wire for SUM/MEAN
   float allreduces, dequantize-accumulate-requantize at the owner,
   fp32 restore at the end. All ranks — including the owner — decode
   the SAME requantized wire form, so results stay bit-identical
   across ranks. Non-SUM/MEAN ops and non-float dtypes fall back to
   exact full-precision transport.
3. **Straggler-tolerant chunk scheduling** (arxiv 2505.23523): each
   rank tracks the longest time it spent blocked on a peer's
   contribution chunks, relative to the fastest peer (receiver-clock
   only — no cross-host timestamp comparison, which NTP-grade clock
   offset would poison), folds it into an EWMA, and a peer whose lag
   exceeds
   ``collective_straggler_threshold`` has its chunks fetched LAST so
   the pipeline windows stay busy on ranks that have already
   published (0, the default = FIFO rank order).

Telemetry: every op (allreduce/allgather/reducescatter/broadcast/barrier)
consumes one per-group monotonic sequence number and records a steptrace
event (rank-local start/end/bytes keyed by (group, seq) — see
_private/steptrace.py) so a GCS-side merge can attribute per-collective
arrival skew to the rank that showed up last. Op records carry
``bytes`` (tensor size), ``wire`` (bytes this rank actually moved over
the transport, post-encoding) and ``logical`` (what the same movements
would have cost at full precision) — logical/wire is the
effective-bandwidth series the quantized path is judged by. Chunked ops
additionally record per-chunk spans (their own timeline lane; the
(group, seq) skew join still sees ONE collective row per op). With
RAY_TPU_TORCH_TRACING=1 each op additionally emits a tracing span,
interleaving with task spans in ``state.timeline()``.

No fallback: a "nccl" group needs an initialised process group and raises
without one; it never drops to the store path in silence.
"""

from __future__ import annotations

import asyncio
import pickle
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from ray_tpu_torch._private import steptrace
from ray_tpu_torch._private.config import GLOBAL_CONFIG
from ray_tpu_torch._private.serialization import BufferList
from ray_tpu_torch.util import tracing

_KV_NS = b"collective"

# sentinel suffix: presence of <keybase>:__abort__ tells every rank blocked
# in a rendezvous wait that this generation of the group is dead
_ABORT_SUFFIX = b":__abort__"


class CollectiveWorldChangedError(RuntimeError):
    """The group's membership changed (a rank died or the gang was re-formed)
    while this rank was inside a collective. In-flight rendezvous waits raise
    this instead of running out the full collective timeout, so supervisors
    can tear down and re-form the group in seconds.
    """


class ReduceOp:
    SUM = "sum"
    PRODUCT = "product"
    MIN = "min"
    MAX = "max"
    MEAN = "mean"


_REDUCERS = {
    ReduceOp.SUM: lambda xs: np.sum(xs, axis=0),
    ReduceOp.PRODUCT: lambda xs: np.prod(xs, axis=0),
    ReduceOp.MIN: lambda xs: np.min(xs, axis=0),
    ReduceOp.MAX: lambda xs: np.max(xs, axis=0),
    ReduceOp.MEAN: lambda xs: np.mean(xs, axis=0),
}

# pairwise accumulation ufuncs for the chunked path (MEAN = add + divide)
_ACC_UFUNC = {
    ReduceOp.SUM: np.add,
    ReduceOp.MEAN: np.add,
    ReduceOp.PRODUCT: np.multiply,
    ReduceOp.MIN: np.minimum,
    ReduceOp.MAX: np.maximum,
}

_metrics_cached = None


def _metrics():
    """Collective transport counters on the process registry (they ride
    the /metrics cluster scrape; run_chaos.sh triage greps them)."""
    global _metrics_cached
    if _metrics_cached is None:
        from ray_tpu_torch._private import metrics_core

        reg = metrics_core.registry()
        _metrics_cached = (
            reg.counter("collective_wire_bytes_total",
                        "bytes this process moved over the collective "
                        "transport (post chunk/quant encoding)"),
            reg.counter("collective_logical_bytes_total",
                        "full-precision-equivalent bytes of the same "
                        "collective transport movements"),
            reg.counter("collective_chunk_retries_total",
                        "extra rendezvous polls while waiting on "
                        "collective chunks (peer not yet published)"),
            reg.counter("collective_chunks_total",
                        "chunks moved by the chunked collective path"),
        )
    return _metrics_cached


# ---------------------------------------------------------------------------
# wire codec: header + raw tensor bytes as out-of-band BufferList buffers
# ---------------------------------------------------------------------------
#
# A tensor payload is BufferList([header, body]): the pickled header
# (dtype/shape/quant-scale, ~100B, stays in the pickle envelope) and
# the raw tensor bytes, which rpcio's v2 framing sends
# out-of-band by reference — no pickle.dumps copy of the tensor on the
# send side, and a zero-copy memoryview over the read buffer on the
# receive side. Object-dtype tensors (and b"" markers) stay plain bytes.

_QS_EPS = 0.0  # symmetric int8: scale = max|x| / 127, zero-safe below


def _quant_encode(arr: np.ndarray):
    """Symmetric per-block int8 quantization: returns (int8 array, scale).
    The scale is computed in float64 and stored as a python float so
    every rank dequantizes from the identical value."""
    amax = float(np.max(np.abs(arr), initial=0.0))
    scale = amax / 127.0
    if scale <= 0.0:
        return np.zeros(arr.shape, np.int8), 0.0
    q = np.clip(np.rint(arr.astype(np.float32) / np.float32(scale)),
                -127, 127).astype(np.int8)
    return q, scale


def _quant_decode(q: np.ndarray, scale: float) -> np.ndarray:
    """Dequantize — deterministic fp32 arithmetic, identical on every
    rank that holds the same wire bytes."""
    if scale <= 0.0:
        return np.zeros(q.shape, np.float32)
    return q.astype(np.float32) * np.float32(scale)


def _wrap_body(hd_fields: dict, body_arr: np.ndarray) -> BufferList:
    hd = pickle.dumps(hd_fields, protocol=5)
    # 1-D view keeps the memoryview cast-safe for 0-d/N-d inputs alike
    return BufferList([hd, memoryview(body_arr.reshape(-1)).cast("B")])


def _enc_quant(q: np.ndarray, scale: float, dtype_str: str,
               shape) -> BufferList:
    """Wire form of an ALREADY-quantized block — the owner publishes the
    exact int8+scale it will locally dequantize, which is what makes the
    reduced result bit-identical across ranks."""
    return _wrap_body({"d": dtype_str, "s": shape, "q": "int8",
                       "sc": scale}, q)


def _enc_tensor(arr: np.ndarray, quant: str = "") -> "BufferList | bytes":
    """Encode a tensor (or chunk view) for the rendezvous wire."""
    if arr.dtype == object:
        return pickle.dumps(arr, protocol=5)  # structured payloads: legacy
    shape = arr.shape  # before ascontiguousarray, which promotes 0-d to 1-d
    arr = np.ascontiguousarray(arr)
    if quant == "int8":
        q, scale = _quant_encode(arr)
        return _enc_quant(q, scale, str(arr.dtype), shape)
    return _wrap_body({"d": str(arr.dtype), "s": shape, "q": "",
                       "sc": None}, arr)


def _dec_tensor(value) -> "tuple[np.ndarray, Optional[dict]]":
    """Decode a wire payload -> (tensor, header). Quantized payloads come
    back dequantized to fp32 (all ranks run the identical arithmetic on
    the identical wire bytes). The returned array may be a read-only
    view over the receive buffer — reducers copy, callers that need
    ownership copy."""
    if isinstance(value, BufferList):
        bufs = value.buffers
        hd0 = bufs[0]
        hd = pickle.loads(hd0 if isinstance(hd0, bytes) else bytes(hd0))
        body = bufs[1] if len(bufs) > 1 else b""
        shape = hd["s"]
        if hd["q"] == "int8":
            q = np.frombuffer(body, dtype=np.int8).reshape(shape)
            return _quant_decode(q, hd["sc"] or 0.0), hd
        return np.frombuffer(body, dtype=np.dtype(hd["d"])).reshape(shape), hd
    return pickle.loads(value), None


def _vsize(value) -> int:
    """Encoded size of a wire payload (what actually crossed the wire)."""
    if isinstance(value, BufferList):
        return value.nbytes
    return len(value) if value is not None else 0


@dataclass
class _Group:
    name: str
    world_size: int
    rank: int
    backend: str
    # generation epoch: bumped each time a gang re-forms a group under the
    # same name (after a rank death). Threaded into every rendezvous key so
    # a new generation cannot mis-join stale KV state from the dead one.
    epoch: int = 0
    seq: int = 0  # per-group monotonic op counter (the steptrace join key)
    # "" (full precision) or "int8": block-wise quantized wire for
    # SUM/MEAN float allreduces on the store path (group-level opt-in;
    # the RAY_TPU_TORCH_collective_quant flag is the process-wide default)
    quant: str = ""
    # rank -> EWMA arrival lag (s) behind the op's fastest peer,
    # learned from receiver-local chunk wait times; drives
    # straggler-last chunk fetch ordering
    peer_lag: Dict[int, float] = field(default_factory=dict)
    # rank -> seconds into the previous chunked op's fetch loop when
    # that peer's LAST contribution chunk retired. Diagnostic for the
    # straggler-scheduling A/B: op completion is always bound by the
    # slowest contributor, but deferral retires fast peers' chunks
    # UNDER the straggler's delay instead of serialized after it, and
    # this is where that shows
    peer_cc_done: Dict[int, float] = field(default_factory=dict)
    p2p_send: Dict[int, int] = None  # per-destination send counters
    p2p_recv: Dict[int, int] = None  # per-source recv counters
    pg: object = None  # nccl backend: the process group (None: the default)

    def __post_init__(self):
        self.p2p_send = {}
        self.p2p_recv = {}

    def alloc_seq(self) -> int:
        """Consume the next per-group sequence number (wraps at
        steptrace.SEQ_MOD; all ranks wrap at the same count, so the
        (group, seq) join key stays aligned)."""
        seq = self.seq
        self.seq = (self.seq + 1) % steptrace.SEQ_MOD
        return seq

    @property
    def keybase(self) -> str:
        """Rendezvous key prefix: generation-qualified group name."""
        return _keybase(self.name, self.epoch)

    @property
    def trace_name(self) -> str:
        """Group name as it appears in steptrace (group, seq) records.
        Epoch 0 keeps the bare name so existing timelines/joins are
        unchanged; re-formed generations are visibly distinct."""
        return self.name if self.epoch == 0 else f"{self.name}@{self.epoch}"


def _keybase(name: str, epoch: int) -> str:
    return f"{name}@{epoch}"


_groups: Dict[str, _Group] = {}
_lock = threading.Lock()


def _cw():
    from ray_tpu_torch._private.worker import global_worker

    global_worker.check_connected()
    return global_worker.core_worker


def _kv_put(key: bytes, value, volatile: bool = False):
    """Put into the collective KV namespace. ``volatile=True`` marks
    rendezvous-lifetime data (tensor payloads a re-formed gang would
    republish anyway) that skips the GCS persist log; group membership,
    abort markers, and anything a GCS restart must replay stay
    persistent (the default)."""
    cw = _cw()
    cw.io.run(cw.gcs.request("kv_put", {"ns": _KV_NS, "key": key,
                                        "value": value,
                                        "volatile": volatile}))


def _kv_get(key: bytes):
    cw = _cw()
    return cw.io.run(cw.gcs.request("kv_get", {"ns": _KV_NS, "key": key}))


# async twins, scheduled on the core worker's io loop so the chunked
# transport can keep a pipelined window of puts/waits in flight while
# the calling thread reduces already-arrived chunks. The numpy work
# stays OFF the io loop — these coroutines only do RPC round trips.

async def _akv_put(cw, key: bytes, value):
    await cw.gcs.request("kv_put", {"ns": _KV_NS, "key": key,
                                    "value": value, "volatile": True})


async def _akv_wait(cw, key: bytes, timeout: float,
                    abort_key: Optional[bytes] = None):
    """Async poll for ``key`` (chunk rendezvous): same backoff + abort
    semantics as the sync ``_kv_wait``. Extra polls (the peer had not
    published yet) feed the chunk-retry counter chaos triage greps."""
    deadline = time.monotonic() + timeout
    delay = 0.002
    polls = 0
    while time.monotonic() < deadline:
        v = await cw.gcs.request("kv_get", {"ns": _KV_NS, "key": key})
        if v is not None:
            if polls:
                _metrics()[2].inc(polls)
            return v
        polls += 1
        if abort_key is not None and polls % 5 == 0:
            a = await cw.gcs.request("kv_get", {"ns": _KV_NS,
                                                "key": abort_key})
            if a is not None:
                raise CollectiveWorldChangedError(
                    f"collective group aborted while waiting on {key!r}: "
                    "membership changed (rank death or gang re-formation)"
                )
        await asyncio.sleep(delay)
        delay = min(delay * 1.5, 0.05)
    raise TimeoutError(f"collective rendezvous timed out on {key!r}")


def _kv_del_prefix(prefix: bytes):
    cw = _cw()
    cw.io.run(cw.gcs.request("kv_del", {"ns": _KV_NS, "key": prefix, "prefix": True}))


def _kv_wait(key: bytes, timeout: float, abort_key: bytes | None = None):
    """Poll ``key`` until it appears. When ``abort_key`` is given, every few
    polls also check for the group's abort marker — a supervisor killing a
    dead generation plants it so blocked survivors fail over in ~a poll
    interval with a typed error instead of running out ``timeout``."""
    deadline = time.monotonic() + timeout
    delay = 0.002
    polls = 0
    while time.monotonic() < deadline:
        v = _kv_get(key)
        if v is not None:
            return v
        polls += 1
        if abort_key is not None and polls % 5 == 0:
            if _kv_get(abort_key) is not None:
                raise CollectiveWorldChangedError(
                    f"collective group aborted while waiting on {key!r}: "
                    "membership changed (rank death or gang re-formation)"
                )
        time.sleep(delay)
        delay = min(delay * 1.5, 0.05)
    raise TimeoutError(f"collective rendezvous timed out on {key!r}")


def _build_nccl_group(world_size: int, rank: int, group_name: str) -> _Group:
    """Validate + build a group over the process's torch.distributed group.

    Every rank must be a process of one initialised process group whose
    world and rank are the group's (Train's TorchConfig forms it for worker
    gangs: NCCL when the workers lease a GPU, gloo otherwise); each op is
    one ``torch.distributed`` collective on it (reference analog: the NCCL
    communicator in ray: util/collective/collective_group/
    nccl_collective_group.py). Without one it raises: no fallback.
    """
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "backend='nccl' needs an initialised torch.distributed process "
            "group (TorchTrainer's TorchConfig forms one for every gang); "
            "use backend='store' without one")
    if dist.get_world_size() != world_size or dist.get_rank() != rank:
        raise RuntimeError(
            f"backend='nccl' group (world_size={world_size}, rank={rank}) "
            f"does not match the process group (world_size="
            f"{dist.get_world_size()}, rank={dist.get_rank()})")
    return _Group(group_name, world_size, rank, "nccl")


def init_collective_group(
    world_size: int,
    rank: int,
    backend: str = "nccl",
    group_name: str = "default",
    epoch: int = 0,
    quant: str = "",
):
    """Declare this process's membership in a collective group
    (ray parity: collective.py init_collective_group). ``epoch`` is the
    gang generation: a re-formed group at the same name must pass the new
    generation so its rendezvous keys cannot collide with the dead one's.
    ``quant="int8"`` opts this group's float SUM/MEAN allreduces into the
    block-wise quantized wire (must be passed identically on every
    rank)."""
    if world_size <= 0 or not (0 <= rank < world_size):
        raise ValueError(f"invalid world_size={world_size} rank={rank}")
    if backend not in ("nccl", "store"):
        raise ValueError(f"unsupported backend {backend!r} (nccl|store)")
    if quant not in ("", "int8"):
        raise ValueError(f"unsupported quant {quant!r} (''|'int8')")
    if backend == "nccl":
        # the process group is the membership: nothing goes to the KV, so
        # a gang outside the runtime (torchrun-style) can use it too
        g = _build_nccl_group(world_size, rank, group_name)
        g.epoch = epoch
    else:
        g = _Group(group_name, world_size, rank, backend, epoch=epoch)
    g.quant = quant
    with _lock:
        _groups[group_name] = g
    if backend == "store":
        _kv_put(f"{g.keybase}:member:{rank}".encode(), b"1")


def create_collective_group(
    actors: List,
    world_size: int,
    ranks: List[int],
    backend: str = "nccl",
    group_name: str = "default",
    epoch: int = 0,
    quant: str = "",
):
    """Declare a group over actor handles from the driver
    (ray parity: collective.py create_collective_group): each actor must call
    ``init_collective_group`` (we invoke it via a well-known method or
    remote call on ``_rt_init_collective``). ``epoch``/``quant`` are only
    forwarded when set: the hook is a public parity surface and existing
    actors define it without the parameters — only re-formed gangs
    (epoch > 0, e.g. Train's recovery path) or quant-opted groups, whose
    workers accept them, need the extras threaded through."""
    import ray_tpu_torch

    if quant not in ("", "int8"):
        raise ValueError(f"unsupported quant {quant!r} (''|'int8')")
    refs = []
    for actor, rank in zip(actors, ranks):
        extra = ()
        if quant:
            extra = (epoch, quant)
        elif epoch:
            extra = (epoch,)
        refs.append(
            actor._rt_init_collective.remote(
                world_size, rank, backend, group_name, *extra
            )
        )
    ray_tpu_torch.get(refs, timeout=60)


def is_group_initialized(group_name: str = "default") -> bool:
    return group_name in _groups


def destroy_collective_group(group_name: str = "default"):
    with _lock:
        _groups.pop(group_name, None)
    # epoch-qualified keys ("name@<epoch>:...") plus the legacy bare prefix
    _kv_del_prefix(f"{group_name}@".encode())
    _kv_del_prefix(f"{group_name}:".encode())


def abort_group(group_name: str = "default", epoch: int | None = None):
    """Plant the abort marker for a group generation. Every rank of that
    generation blocked in a rendezvous wait raises
    ``CollectiveWorldChangedError`` within a poll interval. Callable from
    any connected process (the driver-side gang supervisor does NOT hold
    the group locally, so it passes the generation explicitly)."""
    if epoch is None:
        g = _groups.get(group_name)
        epoch = g.epoch if g else 0
    _kv_put(_keybase(group_name, epoch).encode() + _ABORT_SUFFIX, b"1")


def get_rank(group_name: str = "default") -> int:
    g = _groups.get(group_name)
    return g.rank if g else -1


def get_collective_group_size(group_name: str = "default") -> int:
    g = _groups.get(group_name)
    return g.world_size if g else -1


def _group(group_name: str) -> _Group:
    g = _groups.get(group_name)
    if g is None:
        raise RuntimeError(
            f"collective group '{group_name}' not initialized; call "
            f"init_collective_group first"
        )
    return g


def _to_numpy(tensor) -> np.ndarray:
    if isinstance(tensor, np.ndarray):
        return tensor
    torch = sys.modules.get("torch")  # a torch tensor implies torch is loaded
    if torch is not None and isinstance(tensor, torch.Tensor):
        # numpy has no bfloat16 (the reference's ml_dtypes one is a JAX
        # dependency): a bf16 tensor travels, and comes back, as float32
        if tensor.dtype == torch.bfloat16:
            tensor = tensor.float()
        return tensor.detach().cpu().numpy()
    return np.asarray(tensor)


def _phase(g: _Group, op: str, timeout: float, payload,
           seq: Optional[int] = None, tel: Optional[dict] = None) -> List:
    """All ranks contribute payload; returns all contributions rank-ordered.

    KV-barrier rendezvous keyed by (group, seq, op). The GCS KV plays the
    role of the reference's rendezvous store (ray: util/collective/
    collective_group/nccl_util.py store-based unique-id exchange).
    ``seq`` is the op's already-allocated group sequence number (every
    public op allocates one up front so steptrace records and rendezvous
    keys agree); direct callers may omit it. ``payload`` is bytes or an
    encoded-tensor ``BufferList`` (the out-of-band form); ``tel``, when
    given, accumulates wire/logical transport bytes.
    """
    if seq is None:
        seq = g.alloc_seq()
    base = f"{g.keybase}:{seq}:{op}".encode()
    abort_key = g.keybase.encode() + _ABORT_SUFFIX
    _kv_put(base + f":{g.rank}".encode(), payload, volatile=True)
    outs = []
    for r in range(g.world_size):
        outs.append(_kv_wait(base + f":{r}".encode(), timeout,
                             abort_key=abort_key))
    if tel is not None:
        # monolithic transport is full precision: wire == logical
        moved = _vsize(payload) + sum(_vsize(o) for o in outs)
        tel["wire"] += moved
        tel["logical"] += moved
    # rank 0 garbage-collects the previous phase's keys
    if g.rank == 0 and seq > 0:
        _kv_del_prefix(f"{g.keybase}:{seq - 1}:".encode())
    return outs


def _op(g: _Group, op: str, nbytes: int, call):
    """Run one collective op under telemetry: allocate the per-group seq,
    time the rank-local interval into the steptrace ring, and (with
    tracing enabled) wrap it in a span so it interleaves with task spans
    in state.timeline(). ``call(seq, tel)`` performs the actual
    transport, accumulating actual/full-precision transport bytes into
    ``tel["wire"]``/``tel["logical"]`` (left 0 = transport didn't
    measure, e.g. the nccl path; the record then defaults both
    to ``nbytes``).

    The record lands in a ``finally``: a rank that RAISES (rendezvous
    timeout because a peer never arrived — the straggler failure this
    plane exists to diagnose) still records its arrival time and how
    long it waited, so the GCS merge shows the (group, seq) row with the
    wedged rank in ``missing`` instead of showing nothing at all."""
    seq = g.alloc_seq()
    tel = {"wire": 0, "logical": 0}
    start = time.time()
    try:
        if tracing.is_enabled():
            with tracing.span(f"collective.{op}", group=g.trace_name,
                              seq=seq, rank=g.rank, world=g.world_size,
                              bytes=nbytes):
                return call(seq, tel)
        return call(seq, tel)
    finally:
        wire = tel["wire"] or None
        logical = tel["logical"] or None
        if wire is not None:
            m = _metrics()
            m[0].inc(wire)
            m[1].inc(logical or wire)
        steptrace.record_collective(g.trace_name, seq, op, g.rank,
                                    g.world_size, start, time.time(),
                                    nbytes, wire=wire, logical=logical)


# ---------------------------------------------------------------------------
# chunked pipeline transport (store path): reduce-scatter + allgather over
# fixed-size chunks, pipelined on the core worker's io loop
# ---------------------------------------------------------------------------


def _chunk_layout(n: int, world: int, chunk_elems: int) -> List[List[tuple]]:
    """Owner-sharded chunk plan over a flat n-element tensor: shard o
    (owned by rank o) is elements [o*n//world, (o+1)*n//world); each
    shard splits into chunk_elems-sized pieces (chunk_elems <= 0 keeps
    one chunk per shard — the quant-without-chunking configuration).
    Every shard gets at least one (possibly empty) chunk so the
    rendezvous key schedule is uniform across ranks."""
    plan = []
    for o in range(world):
        lo, hi = o * n // world, (o + 1) * n // world
        if chunk_elems <= 0 or hi - lo <= chunk_elems:
            plan.append([(lo, hi)])
            continue
        cuts = list(range(lo, hi, chunk_elems)) + [hi]
        plan.append([(a, b) for a, b in zip(cuts, cuts[1:]) if a < b])
    return plan


def _fetch_order(g: _Group, peers: List[int]) -> "tuple[List[int], List[int]]":
    """Chunk-fetch peer scheduling: returns ``(pipelined, deferred)``.
    FIFO rank order normally; a peer whose EWMA arrival lag exceeds
    ``collective_straggler_threshold`` is deferred — ALL its chunks are
    fetched after every other peer's, so the known straggler's
    not-yet-published keys never occupy the bounded pipeline windows
    while fast peers' chunks are ready to flow (arxiv 2505.23523). By
    the time a window reaches a deferred peer its chunks have usually
    landed, so the tail waits drain at poll speed. Threshold <= 0 (the
    default-off flag) keeps pure FIFO."""
    peers = sorted(peers)
    thr = GLOBAL_CONFIG.collective_straggler_threshold
    if thr <= 0 or not g.peer_lag:
        return peers, []
    laggy = [p for p in peers if g.peer_lag.get(p, 0.0) > thr]
    if not laggy:
        return peers, []
    laggy.sort(key=lambda p: (g.peer_lag.get(p, 0.0), p))
    return [p for p in peers if p not in set(laggy)], laggy


def _chunked_allreduce(g: _Group, arr: np.ndarray, op: str, timeout: float,
                       seq: int, tel: dict, quant: str = "") -> np.ndarray:
    """Allreduce ``arr`` over the store transport in owner-sharded chunks.

    Rank o owns shard o. Every rank publishes its contribution chunks
    for peer-owned shards; each owner accumulates a chunk as soon as all
    contributions land and immediately republishes the reduced chunk,
    while per-kind bounded windows of chunk waits keep the next chunks'
    RPC round trips in flight under the numpy work (reduce of chunk N
    overlaps transport of chunk N+1). With ``quant="int8"`` the wire
    carries per-chunk scale + int8; the owner dequantize-accumulates in
    fp32, requantizes the reduced chunk, and uses the requantized wire
    form for its OWN output too, so all ranks hold bit-identical
    results. All rendezvous keys live under the op's seq prefix
    (``<keybase>:<seq>:c[cr]:...``), so the existing rank-0 GC of the
    previous seq and the PR 17 abort/epoch machinery cover chunked ops
    unchanged."""
    import concurrent.futures as cf

    cw = _cw()
    W, rank = g.world_size, g.rank
    flat = np.ascontiguousarray(arr).reshape(-1)
    n, itemsize = flat.size, flat.dtype.itemsize
    chunk_bytes = GLOBAL_CONFIG.collective_chunk_bytes
    chunk_elems = max(1, chunk_bytes // itemsize) if chunk_bytes > 0 else 0
    plan = _chunk_layout(n, W, chunk_elems)
    gbase = [0] * W  # owner -> global chunk index of its chunk 0
    for o in range(1, W):
        gbase[o] = gbase[o - 1] + len(plan[o - 1])
    prefix = f"{g.keybase}:{seq}"
    abort_key = g.keybase.encode() + _ABORT_SUFFIX
    depth = max(1, GLOBAL_CONFIG.collective_pipeline_depth)
    ufunc = _ACC_UFUNC[op]
    mean = op == ReduceOp.MEAN
    deadline = time.monotonic() + timeout

    if quant:
        res_dtype = np.dtype(np.float32)
    elif mean and flat.dtype.kind in "biu":
        res_dtype = np.dtype(np.float64)  # np.mean-like int promotion
    else:
        res_dtype = flat.dtype
    out = np.empty(n, dtype=res_dtype)

    def fp_size(elems: int) -> int:
        return elems * itemsize

    put_futs: List = []

    def aput(key: str, value, elems: int):
        tel["wire"] += _vsize(value)
        tel["logical"] += (_vsize(value) if not quant
                           else _vsize(value) - elems + fp_size(elems))
        put_futs.append(cw.io.submit(_akv_put(cw, key.encode(), value)))

    # -- publish contributions for every peer-owned shard, chunk-major so
    # each owner's chunk 0 is on the wire before anyone's chunk 1
    rounds = max(len(pl) for pl in plan)
    for ci in range(rounds):
        for o in range(W):
            if o == rank or ci >= len(plan[o]):
                continue
            lo, hi = plan[o][ci]
            aput(f"{prefix}:cc:{o}:{ci}:{rank}",
                 _enc_tensor(flat[lo:hi], quant), hi - lo)

    # -- seed own-shard accumulators with this rank's own contribution
    # (quantize-roundtripped when quant is on: the analytic error bound
    # assumes every rank's contribution was quantized, owner included)
    my_chunks = plan[rank]
    acc: Dict[int, np.ndarray] = {}
    remaining: Dict[int, int] = {}
    chunk_t0: Dict[tuple, float] = {}
    for ci, (lo, hi) in enumerate(my_chunks):
        own = flat[lo:hi]
        if quant:
            q, sc = _quant_encode(own)
            acc[ci] = _quant_decode(q, sc)
        else:
            acc[ci] = own.astype(res_dtype, copy=True)
        remaining[ci] = W - 1

    def finalize_chunk(ci: int):
        lo, hi = my_chunks[ci]
        value = acc[ci]
        if mean:
            value = value / W if quant else (value / W).astype(res_dtype)
        if quant:
            q, sc = _quant_encode(value)
            enc = _enc_quant(q, sc, "float32", value.shape)
            # peers decode the requantized wire form; so do we, for
            # bit-identical results on every rank
            out[lo:hi] = _quant_decode(q, sc)
        else:
            enc = _enc_tensor(value)
            out[lo:hi] = value
        aput(f"{prefix}:cr:{rank}:{ci}", enc, hi - lo)
        now = time.time()
        steptrace.record_chunk(g.trace_name, seq, gbase[rank] + ci, op,
                               rank, chunk_t0.get(("cc", ci), now), now,
                               fp_size(hi - lo))
        _metrics()[3].inc()

    # -- pipelined fetch loop: contributions to my shard + reduced chunks
    # of peer shards. The two kinds draw from SEPARATE depth-bounded
    # windows: a cr wait only completes after its owner finalized, i.e.
    # after that owner fetched all W-1 contributions of its own — so cr
    # waits parked in a shared in-order window ahead of not-yet-submitted
    # cc items would starve every rank's contribution fetches as soon as
    # W-1 > depth, and the mutually-waiting ranks would deadlock until
    # the rendezvous timeout. Per-kind windows keep contribution fetches
    # flowing regardless of how many reduced-chunk waits are pending,
    # while the streams still interleave for transport/reduce overlap.
    # Within each kind the schedule is chunk-major FIFO (matches the
    # chunk-major publish order); a deferred (straggler) peer's chunks
    # go globally last within its kind.
    order, deferred = _fetch_order(g, [p for p in range(W) if p != rank])

    def _sched(kind: str) -> List[tuple]:
        out_items = []
        for batch in (order, deferred):
            for ci in range(rounds):
                for p in batch:
                    if kind == "cc" and ci < len(my_chunks):
                        out_items.append((kind, p, ci))
                    elif kind == "cr" and ci < len(plan[p]):
                        out_items.append((kind, p, ci))
        return out_items

    iters = {kind: iter(_sched(kind)) for kind in ("cc", "cr")}
    inflight = {"cc": 0, "cr": 0}
    window: Dict = {}
    peer_ccw: Dict[int, float] = {}  # peer -> max cc wait observed (s)
    peer_cc_done: Dict[int, float] = {}  # peer -> last cc retire offset (s)
    loop_t0 = time.monotonic()

    def submit_next(kind: str) -> bool:
        item = next(iters[kind], None)
        if item is None:
            return False
        _, p, ci = item
        if kind == "cc":
            key = f"{prefix}:cc:{rank}:{ci}:{p}"
            chunk_t0.setdefault((kind, ci), time.time())
        else:
            key = f"{prefix}:cr:{p}:{ci}"
            chunk_t0.setdefault((kind, p, ci), time.time())
        budget = max(0.01, deadline - time.monotonic())
        fut = cw.io.submit(_akv_wait(cw, key.encode(), budget, abort_key))
        window[fut] = (kind, p, ci, time.monotonic())
        inflight[kind] += 1
        return True

    def fill_windows():
        for kind in ("cc", "cr"):
            while inflight[kind] < depth and submit_next(kind):
                pass

    try:
        fill_windows()
        while window:
            done, _ = cf.wait(list(window),
                              return_when=cf.FIRST_COMPLETED)
            for fut in done:
                kind, p, ci, t_sub = window.pop(fut)
                inflight[kind] -= 1
                value = fut.result()  # raises: abort/timeout unwedge
                dec, _hd = _dec_tensor(value)
                now_m = time.monotonic()
                if kind == "cc":
                    peer_ccw[p] = max(peer_ccw.get(p, 0.0), now_m - t_sub)
                    peer_cc_done[p] = now_m - loop_t0
                elems = dec.size
                tel["wire"] += _vsize(value)
                tel["logical"] += (_vsize(value) if not quant
                                   else _vsize(value) - elems
                                   + fp_size(elems))
                if kind == "cc":
                    ufunc(acc[ci], dec, out=acc[ci],
                          casting="same_kind")
                    remaining[ci] -= 1
                    if remaining[ci] == 0:
                        finalize_chunk(ci)
                else:
                    lo, hi = plan[p][ci]
                    out[lo:hi] = dec
                    now = time.time()
                    steptrace.record_chunk(
                        g.trace_name, seq, gbase[p] + ci, op, rank,
                        chunk_t0.get(("cr", p, ci), now), now,
                        fp_size(hi - lo))
                    _metrics()[3].inc()
            fill_windows()
        for fut in put_futs:
            fut.result(max(0.01, deadline - time.monotonic()))
    except BaseException:
        for fut in window:
            fut.cancel()
        for fut in put_futs:
            fut.cancel()
        raise

    # -- fold this op's per-peer cc waits into the straggler EWMA.
    # Lag is measured entirely on the RECEIVER's clock: the longest
    # time this rank spent blocked on one of a peer's CONTRIBUTION
    # chunks, relative to the fastest peer's floor (which subtracts the
    # shared RPC/poll round trip; with a single peer there is no
    # reference and the raw wait stands in). Contributions are
    # published at the peer's op entry, so the max cc wait tracks
    # arrival lateness even when a late peer then publishes everything
    # in a burst (its LATER chunks complete instantly — a min- or
    # mean-style statistic would wash the signal out). Reduced-chunk
    # waits are excluded: an owner's cr publish is gated on OTHER
    # ranks' inputs, so counting it would charge fast owners with a
    # straggler's delay. Producer-side header timestamps are never
    # compared — ordinary NTP-grade cross-host clock offset exceeds
    # any useful threshold and would fabricate (or mask) stragglers. A
    # deferred peer's chunks are fetched last and usually land
    # pre-published, so its measured lag shrinks and a rehabilitated
    # peer drifts back under the threshold within a few ops.
    if peer_ccw:
        base = min(peer_ccw.values()) if len(peer_ccw) > 1 else 0.0
        for p, w in peer_ccw.items():
            lag = max(0.0, w - base)
            old = g.peer_lag.get(p)
            g.peer_lag[p] = lag if old is None else 0.7 * old + 0.3 * lag
    g.peer_cc_done = peer_cc_done

    # rank 0 garbage-collects the previous op's keys (chunk sub-keys
    # live under the seq prefix, so the one delete covers both paths)
    if rank == 0 and seq > 0:
        _kv_del_prefix(f"{g.keybase}:{seq - 1}:".encode())
    return out.reshape(arr.shape)


# ---------------------------------------------------------------------------
# nccl backend: torch.distributed collectives on the gang's process group
# ---------------------------------------------------------------------------


def _is_torch(tensor) -> bool:
    torch = sys.modules.get("torch")
    return torch is not None and isinstance(tensor, torch.Tensor)


def _nbytes(tensor) -> int:
    if _is_torch(tensor):
        return tensor.numel() * tensor.element_size()
    return _to_numpy(tensor).nbytes


def _dist_input(g: _Group, tensor):
    """(torch tensor the op runs on, whether the caller passed numpy). A
    torch tensor is used as it is (the op runs in place on it); a numpy
    array is copied to the card under NCCL, kept on the CPU under gloo."""
    import torch
    import torch.distributed as dist

    if _is_torch(tensor):
        return tensor, False
    t = torch.from_numpy(np.array(tensor, copy=True))
    if dist.get_backend(g.pg) == "nccl":
        t = t.cuda()
    return t, True


def _dist_op(op: str):
    import torch.distributed as dist

    return {ReduceOp.SUM: dist.ReduceOp.SUM, ReduceOp.MEAN: dist.ReduceOp.SUM,
            ReduceOp.PRODUCT: dist.ReduceOp.PRODUCT,
            ReduceOp.MIN: dist.ReduceOp.MIN,
            ReduceOp.MAX: dist.ReduceOp.MAX}[op]


def _mean_ready(t, op: str):
    """MEAN runs as SUM then a division by the world (gloo has no AVG in
    every torch release): integer tensors become float64 first, as
    ``np.mean`` promotes them."""
    if op == ReduceOp.MEAN and not t.is_floating_point():
        return t.double()
    return t


def _nccl_allreduce(g: _Group, tensor, op: str):
    import torch.distributed as dist

    t, was_numpy = _dist_input(g, tensor)
    t = _mean_ready(t, op)
    dist.all_reduce(t, op=_dist_op(op), group=g.pg)
    if op == ReduceOp.MEAN:
        t.div_(g.world_size)
    return t.cpu().numpy() if was_numpy else t


def _nccl_allgather(g: _Group, tensor) -> list:
    import torch.distributed as dist

    t, was_numpy = _dist_input(g, tensor)
    flat = t.reshape(-1).contiguous()
    # the flat concatenation is the output form every backend takes
    out = flat.new_empty((g.world_size * flat.numel(),))
    dist.all_gather_into_tensor(out, flat, group=g.pg)
    parts = list(out.view((g.world_size,) + tuple(t.shape)).unbind(0))
    return [p.cpu().numpy() for p in parts] if was_numpy else parts


def _nccl_reducescatter(g: _Group, tensor, op: str):
    import torch.distributed as dist

    t, was_numpy = _dist_input(g, tensor)
    t = _mean_ready(t, op).contiguous()
    out = t.new_empty((t.shape[0] // g.world_size,) + tuple(t.shape[1:]))
    dist.reduce_scatter_tensor(out, t, op=_dist_op(op), group=g.pg)
    if op == ReduceOp.MEAN:
        out.div_(g.world_size)
    return out.cpu().numpy() if was_numpy else out


def _nccl_broadcast(g: _Group, tensor, src_rank: int):
    import torch.distributed as dist

    t, was_numpy = _dist_input(g, tensor)
    dist.broadcast(t, src=src_rank, group=g.pg)
    return t.cpu().numpy() if was_numpy else t


def _into(tensor, result):
    """Numpy inputs are updated in place for drop-in parity (when
    writable); anything else gets the result returned."""
    if isinstance(tensor, np.ndarray) and tensor.flags.writeable:
        np.copyto(tensor, np.asarray(result).astype(tensor.dtype, copy=False))
        return tensor
    return result


def allreduce(tensor, group_name: str = "default", op: str = ReduceOp.SUM,
              timeout: float = 120.0):
    """Allreduce across the group; returns the reduced tensor (numpy
    inputs are also updated in place for drop-in parity; on a "nccl"
    group a torch tensor is reduced in place and returned).

    Store-transport routing: tensors above ``collective_chunk_bytes`` —
    or any float SUM/MEAN when the group opted into quantization — take
    the chunked reduce-scatter+allgather pipeline; everything else takes
    the monolithic single-payload exchange (flags off == today's
    behavior, pinned byte-identical by test)."""
    g = _group(group_name)
    if g.backend == "nccl":
        return _into(tensor, _op(g, "allreduce", _nbytes(tensor),
                                 lambda seq, tel: _nccl_allreduce(g, tensor,
                                                                  op)))
    arr = _to_numpy(tensor)

    def _go(seq, tel):
        if g.world_size > 1 and arr.dtype != object and arr.size > 0:
            quant = ""
            if op in (ReduceOp.SUM, ReduceOp.MEAN) and arr.dtype.kind == "f":
                quant = g.quant or GLOBAL_CONFIG.collective_quant
            chunk_bytes = GLOBAL_CONFIG.collective_chunk_bytes
            if quant or (chunk_bytes > 0 and arr.nbytes > chunk_bytes):
                return _chunked_allreduce(g, arr, op, timeout, seq, tel,
                                          quant)
        outs = _phase(g, "ar", timeout, _enc_tensor(arr), seq=seq, tel=tel)
        return _REDUCERS[op](np.stack([_dec_tensor(o)[0] for o in outs]))

    result = _op(g, "allreduce", arr.nbytes, _go)
    if isinstance(tensor, np.ndarray) and tensor.flags.writeable:
        np.copyto(tensor, result.astype(tensor.dtype, copy=False))
        return tensor
    return result.astype(arr.dtype, copy=False)


def allreduce_multigpu(tensor_list, group_name: str = "default", op=ReduceOp.SUM):
    return [allreduce(t, group_name, op) for t in tensor_list]


def allgather(tensor, group_name: str = "default", timeout: float = 120.0):
    g = _group(group_name)
    if g.backend == "nccl":
        return _op(g, "allgather", _nbytes(tensor),
                   lambda seq, tel: _nccl_allgather(g, tensor))
    arr = _to_numpy(tensor)

    def _go(seq, tel):
        outs = _phase(g, "ag", timeout, _enc_tensor(arr), seq=seq, tel=tel)
        # gathered tensors escape to the caller: copy out of the rpc
        # receive buffers (the frames would pin them otherwise)
        return [np.array(_dec_tensor(o)[0]) for o in outs]

    return _op(g, "allgather", arr.nbytes, _go)


def reducescatter(tensor, group_name: str = "default", op: str = ReduceOp.SUM,
                  timeout: float = 120.0):
    """Reduce across ranks, then scatter: rank r receives shard r of the
    reduction (input's leading dim must divide by world_size)."""
    g = _group(group_name)
    lead = np.shape(tensor)[0]
    if lead % g.world_size != 0:
        raise ValueError(
            f"leading dim {lead} not divisible by world size {g.world_size}")
    if g.backend == "nccl":
        return _op(g, "reducescatter", _nbytes(tensor),
                   lambda seq, tel: _nccl_reducescatter(g, tensor, op))
    arr = _to_numpy(tensor)

    def _go(seq, tel):
        outs = _phase(g, "rs", timeout, _enc_tensor(arr), seq=seq, tel=tel)
        reduced = _REDUCERS[op](np.stack([_dec_tensor(o)[0] for o in outs]))
        return np.split(reduced, g.world_size, axis=0)[g.rank]

    return _op(g, "reducescatter", arr.nbytes, _go)


def broadcast(tensor, src_rank: int = 0, group_name: str = "default",
              timeout: float = 120.0):
    g = _group(group_name)
    if g.backend == "nccl":
        result = _op(g, "broadcast", _nbytes(tensor),
                     lambda seq, tel: _nccl_broadcast(g, tensor, src_rank))
        return tensor if g.rank == src_rank else _into(tensor, result)
    # Non-src store-backend ranks never touch their local tensor (its
    # contents are about to be overwritten): materializing it here only
    # to count bytes would force a device-to-host copy per broadcast.
    # They contribute 0 payload bytes to the telemetry, which is honest.
    if g.rank == src_rank:
        arr = _to_numpy(tensor)
        nbytes = arr.nbytes
    else:
        arr, nbytes = None, 0

    def _go(seq, tel):
        payload = _enc_tensor(arr) if g.rank == src_rank else b""
        outs = _phase(g, "bc", timeout, payload, seq=seq, tel=tel)
        # copy out of the rpc receive buffer: the decode is a read-only
        # view that would otherwise pin the frame (and surprise callers
        # who got owned writable arrays from the old pickle path)
        return np.array(_dec_tensor(outs[src_rank])[0])

    result = _op(g, "broadcast", nbytes, _go)
    if g.rank == src_rank:
        return tensor
    return _into(tensor, result)


def barrier(group_name: str = "default", timeout: float = 120.0):
    g = _group(group_name)

    def _go(seq, tel):
        if g.backend == "nccl":
            import torch.distributed as dist

            dist.barrier(group=g.pg)
            return None
        _phase(g, "barrier", timeout, b"1", seq=seq, tel=tel)
        return None

    _op(g, "barrier", 0, _go)


def send(tensor, dst_rank: int, group_name: str = "default"):
    """Point-to-point send (ray parity: collective.py send). Messages between
    each (src, dst) pair are ordered by a dedicated channel counter, so
    asymmetric patterns (rank0 sending to many peers) stay matched."""
    g = _group(group_name)
    seq = g.p2p_send.get(dst_rank, 0)
    g.p2p_send[dst_rank] = seq + 1
    key = f"{g.keybase}:p2p:{seq}:{g.rank}->{dst_rank}".encode()
    _kv_put(key, _enc_tensor(_to_numpy(tensor)), volatile=True)


def recv(tensor, src_rank: int, group_name: str = "default",
         timeout: float = 120.0):
    g = _group(group_name)
    seq = g.p2p_recv.get(src_rank, 0)
    g.p2p_recv[src_rank] = seq + 1
    key = f"{g.keybase}:p2p:{seq}:{src_rank}->{g.rank}".encode()
    data, _ = _dec_tensor(
        _kv_wait(key, timeout, abort_key=g.keybase.encode() + _ABORT_SUFFIX)
    )
    if isinstance(tensor, np.ndarray) and tensor.flags.writeable:
        np.copyto(tensor, data.astype(tensor.dtype, copy=False))
        return tensor
    # escaping result: own it — the decode may be a read-only view over
    # the rpc receive frame
    return np.array(data)
