"""Bidirectional async RPC substrate.

Plays the role of the reference's gRPC + asio layer (ray: src/ray/rpc/,
src/ray/common/asio/): every control-plane process (GCS, raylet, core worker)
runs one asyncio loop; peers hold persistent duplex connections over which
either side can issue requests or one-way notifications. Two frame formats
exist, negotiated per connection (see the auth preamble below):

  v1: ``[4B len][pickle((msg_id, kind, method, payload))]``
  v2: ``[4B total_len][1B nbufs][4B len x nbufs][pickle5 envelope][buf0]...``
  v3: v2 plus a 4-byte CRC32 trailer on the frame head:
      ``[4B total][1B nbufs][4B len x nbufs][envelope][4B crc][buf0]...``

v2 is the zero-copy out-of-band format: the envelope is pickled with a
``buffer_callback`` so large buffers (numpy arrays, shm chunk views,
``serialization.BufferList`` members) are never memcpy'd into the pickle
stream — the flush path writes them to the socket as vectored memoryviews,
and the receiver reconstructs zero-copy memoryviews over a single read
buffer. This makes the connection a data plane too: object-manager chunks
and inline task args/results ride frames without per-hop copies, while the
shm store stays the intra-node zero-copy path.

v3 adds the control-plane hardening layer (the reference gates releases on
RPC-level chaos; see faultsim.py):

  * frame integrity: the CRC32 trailer covers the frame HEAD (count byte,
    buffer table, pickle envelope) — everything that steers parsing and
    dispatch. Out-of-band payload buffers are excluded on purpose: they are
    multi-MB tensors whose checksum would re-scan memory the zero-copy path
    exists to avoid (TCP's checksum still covers them in transit). A CRC
    mismatch raises FrameCorruptError and resets the connection — a typed,
    loud failure instead of unpickling garbage.
  * per-request deadlines: ``request()`` applies ``rpc_request_timeout_s``
    when the caller passes no timeout, raising RpcTimeoutError (a subclass
    of asyncio.TimeoutError, so existing handlers keep matching) — no
    control-plane call can hang forever on a silent peer.
  * keepalive: idle connections exchange ``__ping``/``__pong`` notifies
    every ``rpc_keepalive_interval_s``; no inbound frame for
    ``rpc_keepalive_timeout_s`` declares the peer dead (a black-holed peer
    is detected in O(timeout) instead of hanging a request forever).
  * duplicate suppression: the receiver drops request frames whose msg_id
    was already dispatched on the same connection (wire-level duplication),
    and ``request(..., idem=token)`` registers the call in a process-wide
    idempotency cache so a RETRY on a fresh connection cannot double-execute
    a side-effectful handler — the receiver replays the first execution's
    result instead.
  * ``call_with_retries``: exponential-backoff retry for control-plane
    calls; side-effectful methods must pass an ``idem`` token.
"""

from __future__ import annotations

import asyncio
import collections
import concurrent.futures
import hashlib
import hmac
import itertools
import logging
import os
import pickle
import random
import threading
import time
import zlib
from typing import Any, Callable, Dict, Optional

from ray_tpu_torch._private import faultsim

logger = logging.getLogger(__name__)

KIND_REQ = 0
KIND_RESP = 1
KIND_ERR = 2
KIND_NOTIFY = 3

_HDR = 4
# frames above this size are written unjoined (joining would memcpy MBs);
# smaller parts coalesce into one socket write per tick
_JOIN_MAX = 128 * 1024
# v2 buffer table: 1-byte count field caps out-of-band buffers per frame;
# overflow buffers simply stay in-band (correct, one extra copy)
_MAX_OOB_BUFS = 255

_HAS_EAGER_FACTORY = hasattr(asyncio, "eager_task_factory")


def _max_msg() -> int:
    from ray_tpu_torch._private.config import GLOBAL_CONFIG

    return GLOBAL_CONFIG.rpc_max_message_bytes


def _oob_min() -> int:
    from ray_tpu_torch._private.config import GLOBAL_CONFIG

    return GLOBAL_CONFIG.rpc_oob_min_bytes


def _frame_version() -> int:
    from ray_tpu_torch._private.config import GLOBAL_CONFIG

    return GLOBAL_CONFIG.rpc_frame_version


def _nbytes(part) -> int:
    return part.nbytes if isinstance(part, memoryview) else len(part)

# --- connection authentication -----------------------------------------
# Frames are pickles, and unpickling executes code — so no frame may be
# read from an unauthenticated peer. Every client opens with a fixed-size
# raw preamble [5B magic][64B sha256(token) hex] before any pickle frame;
# the server closes mismatching connections without ever unpickling their
# bytes. The token is RAY_TPU_TORCH_CLUSTER_TOKEN (the head node generates one
# at startup and propagates it through package_env; remote drivers export
# it). The preamble is sent unconditionally — with an empty token it
# hashes "" — so a token-bearing client and a token-less server can never
# misparse each other's streams; they fail the digest compare and close.
# Plays the role of the reference's cluster auth token scoping.
#
# Threat model: this is a static bearer credential on a trusted LAN — it
# scopes which processes belong to the cluster and keeps stray/stale
# processes from delivering pickles. It is NOT a defense against an
# on-path network attacker: there is no nonce/challenge (an observed
# preamble replays) and clients do not authenticate the server. That
# matches the reference's cluster-token posture; deployments that face
# untrusted networks must wrap transport in TLS/VPN at a lower layer.
#
# Frame-version negotiation rides the preamble's magic: a client that
# speaks the v2 out-of-band frame format opens with magic "RTPU2" (same
# preamble length); a v2-aware server answers with a single version byte
# 0x02 and both sides speak v2 from the first frame. A v1-only server
# fails the digest compare on the unknown magic and closes — the client
# detects the EOF where the version byte should be and redials with the
# next-lower preamble, so mixed-version clusters never misparse streams.
# A v1 client sending "RTPU1" gets a silent (byte-free) v1 session from a
# newer server, exactly as before. v3 ("RTPU3", ack 0x03) is v2 framing
# plus the CRC32 head trailer; the downgrade chain is 3 -> 2 -> 1.

_AUTH_MAGIC = b"RTPU1"
_AUTH_MAGIC_V2 = b"RTPU2"
_AUTH_MAGIC_V3 = b"RTPU3"
_AUTH_LEN = len(_AUTH_MAGIC) + 64
_V2_ACK = b"\x02"
_V3_ACK = b"\x03"
_MAGICS = {1: _AUTH_MAGIC, 2: _AUTH_MAGIC_V2, 3: _AUTH_MAGIC_V3}
_ACKS = {2: _V2_ACK, 3: _V3_ACK}


def cluster_token() -> str:
    return os.environ.get("RAY_TPU_TORCH_CLUSTER_TOKEN", "")


def _auth_preamble(token: str, version: int = 1) -> bytes:
    digest = hashlib.sha256(token.encode()).hexdigest().encode()
    return _MAGICS[min(version, 3)] + digest


class RpcError(Exception):
    pass


class ConnectionLost(RpcError):
    pass


class RpcTimeoutError(RpcError, asyncio.TimeoutError):
    """A request exceeded its deadline. Subclasses asyncio.TimeoutError so
    pre-existing ``except asyncio.TimeoutError`` call sites keep working."""


class FrameCorruptError(ConnectionLost):
    """An inbound frame failed its integrity check (CRC mismatch or a
    structurally impossible header). The connection is reset: after one
    corrupt frame the stream offset can no longer be trusted."""


class Finalized:
    """Handler-return wrapper: ``payload`` is sent as the response, then
    ``release()`` runs once the frame has been handed to the transport —
    for responses carrying zero-copy views over resources that must
    outlive the write (e.g. mmap'd object-store chunks)."""

    __slots__ = ("payload", "release")

    def __init__(self, payload, release: Callable[[], None]):
        self.payload = payload
        self.release = release


def _decode_v2(data: bytes):
    """Decode a v2 frame body (everything after the 4B total-length header)
    into ``(msg_id, kind, method, payload)``. Out-of-band buffers become
    zero-copy memoryviews over ``data`` — they stay valid (and readonly)
    for as long as the payload holds them, independent of the connection."""
    if len(data) < 1:
        raise RpcError("corrupt v2 frame: empty body")
    nbufs = data[0]
    view = memoryview(data)
    if nbufs == 0:  # control-plane common case: no table to parse
        return pickle.loads(view[1:])
    env_start = 1 + 4 * nbufs
    if env_start > len(data):
        raise RpcError("corrupt v2 frame: buffer table truncated")
    lens = [
        int.from_bytes(view[1 + 4 * i: 5 + 4 * i], "little")
        for i in range(nbufs)
    ]
    env_end = len(data) - sum(lens)
    if env_end < env_start:
        raise RpcError("corrupt v2 frame: buffers exceed frame length")
    bufs = []
    pos = env_end
    for n in lens:
        bufs.append(view[pos: pos + n])
        pos += n
    return pickle.loads(view[env_start:env_end], buffers=bufs)


def _decode_v3(data: bytes):
    """Decode a v3 frame body: v2 layout with a 4-byte CRC32 trailer after
    the envelope, covering every byte before it (count byte + buffer table
    + envelope). Structural impossibilities and CRC mismatches both raise
    FrameCorruptError — either way the stream cannot be resynced."""
    if len(data) < 5:
        raise FrameCorruptError("corrupt v3 frame: short body")
    nbufs = data[0]
    view = memoryview(data)
    if nbufs == 0:
        crc_off = len(data) - 4
        if zlib.crc32(view[:crc_off]) != int.from_bytes(
                view[crc_off:], "little"):
            raise FrameCorruptError("v3 frame failed CRC32 check")
        return pickle.loads(view[1:crc_off])
    env_start = 1 + 4 * nbufs
    if env_start > len(data):
        raise FrameCorruptError("corrupt v3 frame: buffer table truncated")
    lens = [
        int.from_bytes(view[1 + 4 * i: 5 + 4 * i], "little")
        for i in range(nbufs)
    ]
    crc_off = len(data) - sum(lens) - 4
    if crc_off < env_start:
        raise FrameCorruptError("corrupt v3 frame: buffers exceed frame")
    if zlib.crc32(view[:crc_off]) != int.from_bytes(
            view[crc_off: crc_off + 4], "little"):
        raise FrameCorruptError("v3 frame failed CRC32 check")
    bufs = []
    pos = crc_off + 4
    for n in lens:
        bufs.append(view[pos: pos + n])
        pos += n
    return pickle.loads(view[env_start:crc_off], buffers=bufs)


# --- receiver-side idempotency (retry dedup) ---------------------------
# A retried side-effectful request may arrive on a DIFFERENT connection
# than its first attempt (the original died — that is why it was retried),
# so dedup state is process-wide, keyed by the caller-chosen token riding
# the payload's reserved "_idem" slot. The first arrival executes; every
# duplicate awaits and re-sends the first execution's result. Bounded LRU:
# old entries age out once the window where a retry could arrive is past.
_IDEM_MAX = 4096
_idem_results: dict = {}
# Claim-order ring beside the result dict: eviction pops from the left
# instead of the old OrderedDict's move_to_end-per-hit plus a full
# list() copy + scan once past the cap — O(1) amortized per claim (the
# submit hot path pays this on every batched frame). Tokens forgotten
# via _idem_forget leave a stale ring entry behind; eviction skips it.
_idem_order: "collections.deque" = collections.deque()


def _idem_claim(token) -> tuple:
    """Returns (future, is_owner). The owner executes the handler and must
    resolve the future; non-owners await it."""
    fut = _idem_results.get(token)
    if fut is not None:
        return fut, False
    fut = asyncio.get_running_loop().create_future()
    _idem_results[token] = fut
    _idem_order.append(token)
    # Evict oldest COMPLETED entries only: an in-flight future guards an
    # active execution — evicting it would let a concurrent retry claim
    # ownership and double-execute, the exact failure this cache exists
    # to prevent. Pending entries rotate to the back; the bounded scan
    # keeps a pathological all-pending cache from spinning this loop.
    scans = 0
    while len(_idem_order) > _IDEM_MAX and scans < 8:
        scans += 1
        old = _idem_order.popleft()
        entry = _idem_results.get(old)
        if entry is None:
            continue  # forgotten: the ring entry was already stale
        if entry.done():
            del _idem_results[old]
        else:
            _idem_order.append(old)
    return fut, True


def _idem_forget(token):
    _idem_results.pop(token, None)


def _backoff_delay(attempt: int, base: float, cap: float) -> float:
    """Jittered exponential backoff: 2^(attempt-1) doubling capped at
    ``cap``, scaled by a jitter factor in [0.5, 1.0] so concurrent
    retriers (a node's workers all reconnecting after a GCS restart)
    decorrelate instead of stampeding."""
    delay = min(cap, base * (2 ** min(attempt - 1, 16)))
    return delay * (0.5 + 0.5 * random.random())


# --- runtime metrics (metrics_core.py) ---------------------------------
# Built lazily so importing rpcio stays side-effect free; per-method
# histogram/counter children are cached in plain dicts (the label lookup
# must not cost a lock + tuple sort on the send hot path).
class _RpcMetrics:
    __slots__ = ("latency", "handled", "timeouts", "retries", "bytes_out",
                 "bytes_in", "keepalive_deaths", "crc_errors",
                 "_lat", "_handled", "_timeouts", "_retries")

    def __init__(self):
        from ray_tpu_torch._private import metrics_core as mc

        reg = mc.registry()
        self.latency = reg.histogram(
            "rpc_request_latency_seconds",
            "RPC request latency per verb, one record per ATTEMPT "
            "(a retried call records each attempt)", scale=mc.LATENCY)
        self.handled = reg.counter(
            "rpc_handled_total",
            "Requests whose handler actually EXECUTED here (idempotent "
            "replays of a deduped retry are not re-counted)")
        self.timeouts = reg.counter(
            "rpc_request_timeouts_total", "Requests that hit their deadline")
        self.retries = reg.counter(
            "rpc_retries_total", "call_with_retries re-attempts")
        self.bytes_out = reg.counter(
            "rpc_bytes_sent_total", "Frame bytes written to peers").default
        self.bytes_in = reg.counter(
            "rpc_bytes_received_total", "Frame bytes read from peers").default
        self.keepalive_deaths = reg.counter(
            "rpc_keepalive_deaths_total",
            "Connections reset after keepalive silence").default
        self.crc_errors = reg.counter(
            "rpc_frame_crc_errors_total",
            "Inbound frames failing the v3 CRC32 head check").default
        self._lat: Dict[str, Any] = {}
        self._handled: Dict[str, Any] = {}
        self._timeouts: Dict[str, Any] = {}
        self._retries: Dict[str, Any] = {}

    def lat(self, method: str):
        c = self._lat.get(method)
        if c is None:
            c = self._lat[method] = self.latency.labels(method=method)
        return c

    def handled_c(self, method: str):
        c = self._handled.get(method)
        if c is None:
            c = self._handled[method] = self.handled.labels(method=method)
        return c

    def timeout_c(self, method: str):
        c = self._timeouts.get(method)
        if c is None:
            c = self._timeouts[method] = self.timeouts.labels(method=method)
        return c

    def retry_c(self, method: str):
        c = self._retries.get(method)
        if c is None:
            c = self._retries[method] = self.retries.labels(method=method)
        return c


_MX: Optional[_RpcMetrics] = None


def _mx() -> _RpcMetrics:
    global _MX
    if _MX is None:
        _MX = _RpcMetrics()
    return _MX


# --- fault-injection write-queue markers (see faultsim.py) -------------
class _FaultMarker:
    __slots__ = ("seconds", "parts")

    def __init__(self, seconds: float = 0.0, parts: tuple = ()):
        self.seconds = seconds
        self.parts = parts


class _DelayMarker(_FaultMarker):
    pass


class _DropMarker(_FaultMarker):
    pass


class Connection:
    """One duplex peer connection. Owned by exactly one event loop."""

    _ids = itertools.count(1)

    def __init__(self, reader, writer, handler: Optional[object] = None,
                 name: str = "?", version: int = 1,
                 peer_addr: Optional[str] = None):
        self.reader = reader
        self.writer = writer
        self.handler = handler
        self.name = name
        # "host:port" of the remote end (faultsim partition matching and
        # diagnostics); server-side conns carry the peer's ephemeral addr
        self.peer_addr = peer_addr
        # negotiated frame format (1 = in-band pickle, 2 = out-of-band
        # buffer table, 3 = v2 + CRC head trailer); both peers agreed on
        # it during the auth preamble
        self.version = version
        # flags read once per connection: the recv/send loops are hot paths
        self._max_msg = _max_msg()
        self._oob_min = _oob_min()
        self._pending: Dict[int, asyncio.Future] = {}
        self._msg_ids = itertools.count(1)
        self._send_lock = asyncio.Lock()
        # tick-coalesced writes: frames queued in order, one flush task
        # joins small frames into a single socket write per loop tick
        self._wbuf: list = []
        self._wflush: Optional[asyncio.Task] = None
        self._closed = False
        self._close_error: Optional[Exception] = None
        self.on_close: Optional[Callable] = None
        self._recv_task: Optional[asyncio.Task] = None
        self._keepalive_task: Optional[asyncio.Task] = None
        self._last_rx = time.monotonic()
        # wire-duplicate suppression: request msg_ids already dispatched on
        # THIS connection (a duplicated frame must not re-run its handler)
        self._seen_reqs: set = set()
        self._seen_order: collections.deque = collections.deque(maxlen=1024)
        # Arbitrary peer metadata attached at registration time.
        self.meta: Dict[str, Any] = {}

    def start(self):
        loop = asyncio.get_running_loop()
        self._recv_task = loop.create_task(self._recv_loop())
        from ray_tpu_torch._private.config import GLOBAL_CONFIG

        # keepalive only on v3+ sessions: both ends are new enough to pong
        # (an old peer would log "no handler" warnings and never answer,
        # reading as dead). Gated off for interval <= 0.
        if self.version >= 3 and GLOBAL_CONFIG.rpc_keepalive_interval_s > 0:
            self._keepalive_task = loop.create_task(self._keepalive_loop())
        return self._recv_task

    async def _keepalive_loop(self):
        """Failure detector: ping when the connection goes quiet, declare
        the peer dead when NOTHING (ping, pong, or real traffic) has
        arrived for rpc_keepalive_timeout_s. A black-holed or hung peer is
        thereby detected in O(timeout) instead of hanging a request()
        forever (ray parity: gRPC keepalive + health checks)."""
        from ray_tpu_torch._private.config import GLOBAL_CONFIG

        interval = GLOBAL_CONFIG.rpc_keepalive_interval_s
        timeout = GLOBAL_CONFIG.rpc_keepalive_timeout_s
        tick = time.monotonic()
        try:
            while not self._closed:
                await asyncio.sleep(interval)
                if self._closed:
                    return
                now = time.monotonic()
                # a wake-up late by more than an interval is this process's
                # own stall (a paused host, a starved loop), not the peer's
                # silence: a peer paused with it had nothing to send
                self._last_rx += own_stall_s(now - tick, interval)
                tick = now
                idle = now - self._last_rx
                if idle > timeout:
                    logger.warning(
                        "rpc keepalive timeout on %s (%.1fs idle > %.1fs); "
                        "declaring peer dead", self.name, idle, timeout)
                    _mx().keepalive_deaths.inc()
                    await self._do_close(ConnectionLost(
                        f"keepalive timeout on {self.name}: peer silent "
                        f"for {idle:.1f}s"))
                    return
                if idle >= interval:
                    try:
                        # through the fault hook: a partition black-holes
                        # pings too (that's what makes it detectable)
                        self._enqueue_faulted(
                            "__ping",
                            self._encode_frame(0, KIND_NOTIFY, "__ping", None)
                        )
                    except Exception:
                        return
        except asyncio.CancelledError:
            raise

    def _enqueue_frame(self, parts: tuple) -> asyncio.Task:
        """Queue one frame's parts synchronously (caller order = wire
        order) and return the shared flush task."""
        self._wbuf.append(parts)
        if self._wflush is None or self._wflush.done():
            self._wflush = asyncio.get_running_loop().create_task(
                self._flush_writes()
            )
        return self._wflush

    def _encode_frame(self, msg_id: int, kind: int, method: str,
                      payload) -> tuple:
        """Encode one frame as a tuple of bytes-like parts (written to the
        socket in order, large parts by reference — no join memcpy).

        v1: one part, ``[4B len][pickle]``.
        v2: ``[4B total][1B nbufs][4B len x nbufs][envelope]`` as the head
        part, then each out-of-band buffer as its own part. The envelope is
        pickled with ``buffer_callback`` so protocol-5-aware payloads
        (numpy arrays, PickleBuffers, serialization.BufferList members)
        never enter the pickle stream.
        v3: v2 with a 4-byte CRC32 of the head (count byte + table +
        envelope) appended to the head part, before the buffers.

        Raises RpcError BEFORE anything is queued when the frame would
        exceed ``rpc_max_message_bytes`` — an oversized send must fail
        loudly at the caller, not opaquely kill the peer's recv loop.
        """
        if self.version < 2:
            data = pickle.dumps((msg_id, kind, method, payload), protocol=5)
            total = len(data)
            if total > self._max_msg:
                raise RpcError(
                    f"outgoing {method!r} message too large: {total} bytes "
                    f"> rpc_max_message_bytes={self._max_msg}"
                )
            return (total.to_bytes(_HDR, "little") + data,)
        bufs: list = []
        oob_min = self._oob_min

        def _cb(pb: pickle.PickleBuffer):
            try:
                view = pb.raw()
            except Exception:
                return True  # non-contiguous buffer: serialize in-band
            if view.nbytes < oob_min or len(bufs) >= _MAX_OOB_BUFS \
                    or view.nbytes > 0xFFFFFFFF:
                return True  # tiny / table-overflow / >4GiB: in-band
            bufs.append(view)
            return False

        env = pickle.dumps((msg_id, kind, method, payload), protocol=5,
                           buffer_callback=_cb)
        crc_len = 4 if self.version >= 3 else 0
        if not bufs:
            # control-plane common case: no table, same cost as a v1 frame
            total = 1 + len(env) + crc_len
            if total > self._max_msg:
                raise RpcError(
                    f"outgoing {method!r} message too large: {total} bytes "
                    f"> rpc_max_message_bytes={self._max_msg}"
                )
            if not crc_len:
                return (total.to_bytes(_HDR, "little") + b"\x00" + env,)
            crc = zlib.crc32(env, zlib.crc32(b"\x00"))
            return (total.to_bytes(_HDR, "little") + b"\x00" + env
                    + crc.to_bytes(4, "little"),)
        table = b"".join(v.nbytes.to_bytes(4, "little") for v in bufs)
        total = (1 + len(table) + len(env) + crc_len
                 + sum(v.nbytes for v in bufs))
        if total > self._max_msg:
            raise RpcError(
                f"outgoing {method!r} message too large: {total} bytes "
                f"({len(bufs)} out-of-band buffers) "
                f"> rpc_max_message_bytes={self._max_msg}"
            )
        nb = bytes((len(bufs),))
        head_parts = [total.to_bytes(_HDR, "little"), nb, table, env]
        if crc_len:
            # CRC over the head only: out-of-band buffers are the zero-copy
            # payload path and are excluded by design (see module docs)
            crc = zlib.crc32(env, zlib.crc32(table, zlib.crc32(nb)))
            head_parts.append(crc.to_bytes(4, "little"))
        return (b"".join(head_parts), *bufs)

    def _fault_peer(self) -> Optional[str]:
        """Identity string partition rules match against. Combines the
        socket address with the peer's REGISTERED identity (meta node_id,
        set at register_peer/register_node time) — a server-accepted conn's
        socket addr is the client's ephemeral port, which no rule can name,
        so without the registered id a partition would black-hole only the
        dialing side of a duplex connection."""
        nid = self.meta.get("node_id")
        if nid is None:
            return self.peer_addr
        if self.peer_addr is None:
            return str(nid)
        return f"{nid}|{self.peer_addr}"

    def _enqueue_faulted(self, method: str, parts: tuple):
        """Queue one frame, consulting the fault injector first. Returns
        the flush task, or None when the frame was black-holed (partition:
        the bytes vanish; deadlines/keepalive surface the loss). All fault
        actions are decided synchronously at enqueue time so frame order —
        and therefore the decision sequence per seeded rule — stays
        deterministic; delays/drops execute in-order inside the flush."""
        plan = faultsim.active_plan()
        if plan is not None:
            fault = plan.on_send(method, self._fault_peer())
            if fault is not None:
                kind, rule = fault
                faultsim.record_injection(kind, method)
                if kind == "partition":
                    return None
                if kind == "kill":
                    # rank death, not graceful exit: no flush, no atexit —
                    # the gang's supervisor must detect this, not be told
                    import signal as _signal

                    os.kill(os.getpid(), _signal.SIGKILL)
                if kind == "dup":
                    self._enqueue_frame(parts)
                elif kind == "delay":
                    self._enqueue_frame(
                        _DelayMarker((rule.param or 50.0) / 1000.0))
                elif kind == "drop":
                    return self._enqueue_frame(_DropMarker(parts=parts))
                elif kind == "corrupt":
                    head = bytearray(parts[0])
                    # flip one byte past the 4B length header (inside the
                    # CRC-covered head region), offset picked by the rule's
                    # own PRNG so the corruption site replays from the seed
                    off = _HDR + rule.rng.randrange(max(1, len(head) - _HDR))
                    head[off] ^= 0xFF
                    parts = (bytes(head),) + tuple(parts[1:])
        return self._enqueue_frame(parts)

    async def _send(self, msg_id: int, kind: int, method: str, payload):
        flush = self._enqueue_faulted(
            method, self._encode_frame(msg_id, kind, method, payload)
        )
        if flush is None:
            return  # black-holed by a partition rule
        # await the shared flush so callers keep drain() backpressure;
        # shield: one canceled sender must not kill everyone's flush
        await asyncio.shield(flush)

    def request_nowait(self, method: str, payload=None) -> asyncio.Future:
        """Enqueue a request frame SYNCHRONOUSLY and return the response
        future. Two request_nowait calls from the same tick hit the wire
        in call order — the ordered-pipelining primitive direct actor
        calls ride on (a plain ``await request()`` per call would
        serialize to one call per RTT or lose ordering across tasks)."""
        # hotpath: begin request_nowait (one frame per direct call — no
        # per-call dict copies or string formatting off the error paths)
        if self._closed:
            raise ConnectionLost(f"connection {self.name} closed",  # lint: allow-hotpath (close error path)
                                 ) from self._close_error
        msg_id = next(self._msg_ids)
        # encode before registering the future: an oversized frame raises
        # here and must not leave a pending entry behind
        parts = self._encode_frame(msg_id, KIND_REQ, method, payload)
        fut = asyncio.get_running_loop().create_future()
        self._pending[msg_id] = fut
        t0 = time.perf_counter()
        lat = _mx().lat(method)

        def _done(_f):
            self._pending.pop(msg_id, None)
            lat.record(time.perf_counter() - t0)

        fut.add_done_callback(_done)
        self._enqueue_faulted(method, parts)
        return fut
        # hotpath: end request_nowait

    async def _flush_writes(self):
        """Write every queued frame with ONE socket write per tick (frames
        stay in queue order — actor-call ordering rides on it). asyncio's
        transport issues a send syscall per write() when its buffer is
        empty, so a burst of small control frames written individually
        costs a syscall + receiver wakeup each; joined, the burst is one
        syscall and the peer's recv loop drains it in one poll."""
        # Explicit yield so the flush always runs past the currently
        # executing callback: under the loops' EAGER task factory,
        # create_task would otherwise run this body synchronously inside
        # the first _enqueue_frame and flush one-frame "bursts". Without
        # an eager factory (<=3.11) create_task already defers to the next
        # loop pass — the yield would only add a scheduling hop per burst.
        if _HAS_EAGER_FACTORY:
            await asyncio.sleep(0)
        async with self._send_lock:
            # loop until drained: frames appended while we're suspended in
            # drain() ride THIS task — a sender that sees the task not done
            # won't start another, so leaving them would stall delivery
            sent = 0
            while self._wbuf and not self._closed:
                buf, self._wbuf = self._wbuf, []
                run: list = []
                for frame in buf:
                    if isinstance(frame, _FaultMarker):
                        # injected fault tokens execute in queue order so
                        # they stall/kill the STREAM, never reorder it
                        if run:
                            self.writer.write(b"".join(run))
                            run = []
                        if isinstance(frame, _DelayMarker):
                            await self.writer.drain()
                            await asyncio.sleep(frame.seconds)
                        else:  # _DropMarker: sever mid-frame
                            head = bytes(frame.parts[0]) if frame.parts \
                                else b"\x00"
                            self.writer.write(head[:max(1, len(head) // 2)])
                            try:
                                await self.writer.drain()
                            except Exception:
                                pass
                            self._wbuf.clear()
                            await self._do_close(ConnectionLost(
                                f"fault injection dropped {self.name} "
                                f"mid-frame"))
                            return
                        continue
                    # a frame is a tuple of parts (v2 out-of-band buffers
                    # ride as separate memoryview parts, by reference)
                    for part in frame if isinstance(frame, tuple) \
                            else (frame,):
                        sent += _nbytes(part)
                        if _nbytes(part) > _JOIN_MAX:
                            # big part (object chunk / tensor): joining
                            # would memcpy MBs — flush the small run in
                            # order, then hand the view to the transport
                            if run:
                                self.writer.write(b"".join(run))
                                run = []
                            self.writer.write(part)
                        else:
                            run.append(part)
                if run:
                    self.writer.write(
                        run[0] if len(run) == 1 else b"".join(run)
                    )
                await self.writer.drain()
            if sent:
                # one counter bump per flush batch, not per frame
                _mx().bytes_out.inc(sent)

    async def request(self, method: str, payload=None, timeout: float = None,
                      idem=None) -> Any:
        """Issue one request and await its response.

        ``timeout``: seconds until RpcTimeoutError. None applies the
        ``rpc_request_timeout_s`` default — no control-plane call may hang
        forever on a silent peer; pass 0 for the rare legitimately
        unbounded wait.

        ``idem``: idempotency token for side-effectful methods. Riding the
        payload's reserved "_idem" slot, it registers the call in the
        receiver's process-wide dedup cache so a retry (possibly on a new
        connection) replays the first execution's result instead of
        double-executing the handler."""
        if self._closed:
            raise ConnectionLost(f"connection {self.name} closed"
                                 ) from self._close_error
        if timeout is None:
            from ray_tpu_torch._private.config import GLOBAL_CONFIG

            timeout = GLOBAL_CONFIG.rpc_request_timeout_s
        if idem is not None:
            payload = dict(payload or {})
            payload["_idem"] = idem
        msg_id = next(self._msg_ids)
        loop = asyncio.get_running_loop()
        fut = loop.create_future()
        self._pending[msg_id] = fut
        handle = None
        if timeout:
            def _expire():
                if not fut.done():
                    _mx().timeout_c(method).inc()
                    fut.set_exception(RpcTimeoutError(
                        f"request {method!r} on {self.name} exceeded "
                        f"{timeout}s deadline"))

            # call_later beats wait_for here: no wrapper task per request
            # on the hot path, just one timer handle
            handle = loop.call_later(timeout, _expire)
        t0 = time.perf_counter()
        try:
            await self._send(msg_id, KIND_REQ, method, payload)
            return await fut
        finally:
            # per-ATTEMPT latency: a retried call records every attempt
            # (including the failed ones) while the *_total counters count
            # logical executions exactly once — see _dispatch's dedup path
            _mx().lat(method).record(time.perf_counter() - t0)
            if handle is not None:
                handle.cancel()
            self._pending.pop(msg_id, None)

    async def notify(self, method: str, payload=None):
        if self._closed:
            raise ConnectionLost(f"connection {self.name} closed"
                                 ) from self._close_error
        await self._send(0, KIND_NOTIFY, method, payload)

    async def _recv_loop(self):
        error: Optional[Exception] = None
        try:
            while True:
                hdr = await self.reader.readexactly(_HDR)
                n = int.from_bytes(hdr, "little")
                if n > self._max_msg:
                    raise RpcError(f"oversized message: {n}")
                data = await self.reader.readexactly(n)
                self._last_rx = time.monotonic()
                _mx().bytes_in.inc(n + _HDR)
                if self.version >= 3:
                    msg_id, kind, method, payload = _decode_v3(data)
                elif self.version == 2:
                    # ONE read buffer per frame; payload buffers are
                    # zero-copy memoryviews into it (they keep it alive)
                    msg_id, kind, method, payload = _decode_v2(data)
                else:
                    msg_id, kind, method, payload = pickle.loads(data)
                if kind == KIND_RESP:
                    fut = self._pending.get(msg_id)
                    if fut and not fut.done():
                        fut.set_result(payload)
                elif kind == KIND_ERR:
                    fut = self._pending.get(msg_id)
                    if fut and not fut.done():
                        fut.set_exception(RpcError(payload))
                elif kind == KIND_NOTIFY and method == "__ping":
                    # answered inline (no dispatch task): the pong only
                    # proves the loop + socket are alive, which is the point
                    try:
                        self._enqueue_faulted(
                            "__pong",
                            self._encode_frame(0, KIND_NOTIFY, "__pong",
                                               None))
                    except Exception:
                        pass
                elif kind == KIND_NOTIFY and method == "__pong":
                    pass  # _last_rx above is the payload
                else:
                    if kind == KIND_REQ and msg_id:
                        # wire-duplicate suppression: a duplicated request
                        # frame (fault injection, future retransmit paths)
                        # must not re-run its handler — the first dispatch
                        # already owns sending the (single) response
                        if msg_id in self._seen_reqs:
                            logger.warning(
                                "%s: dropping duplicate request frame "
                                "%s #%d", self.name, method, msg_id)
                            continue
                        if len(self._seen_order) == self._seen_order.maxlen:
                            self._seen_reqs.discard(self._seen_order[0])
                        self._seen_order.append(msg_id)
                        self._seen_reqs.add(msg_id)
                    # spawn (strong ref): a GC'd dispatch task would drop
                    # the request without ever sending a reply
                    spawn(self._dispatch(msg_id, kind, method, payload))
        except (asyncio.IncompleteReadError, ConnectionResetError, BrokenPipeError):
            pass
        except asyncio.CancelledError:
            raise
        except FrameCorruptError as e:
            # typed, loud, and fatal for the CONNECTION only: the stream
            # offset is untrustworthy after a corrupt frame, so reset and
            # let deadlines/retries re-issue in-flight calls
            logger.warning("resetting %s: %s", self.name, e)
            _mx().crc_errors.inc()
            error = e
        except Exception as e:
            logger.exception("rpc recv loop error on %s", self.name)
            error = ConnectionLost(f"recv loop error on {self.name}: {e!r}")
        finally:
            await self._do_close(error)

    async def _dispatch(self, msg_id: int, kind: int, method: str, payload):
        task = asyncio.current_task()
        if task is not None:
            # name = the method being served: SIGUSR2 task dumps then show
            # WHICH handler a wedged dispatch is stuck in, not just that
            # one is stuck (negligible cost next to unpickle+handler)
            task.set_name(f"dispatch:{method}:{self.name}")
        handler = self.handler
        fn = getattr(handler, f"rpc_{method}", None) if handler else None
        if fn is None:
            if kind == KIND_REQ:
                await self._send(msg_id, KIND_ERR, method, f"no handler for {method!r}")
            else:
                logger.warning("%s: dropping notify %r (no handler)", self.name, method)
            return
        # Retry-level idempotency: a token claims a process-wide cache slot.
        # The first arrival executes the handler; a duplicate (a retried
        # request, possibly on a fresh connection after the original died)
        # awaits and re-sends the SAME result without re-executing.
        token = idem_fut = None
        if kind == KIND_REQ and isinstance(payload, dict):
            token = payload.pop("_idem", None)
        if token is not None:
            idem_fut, is_owner = _idem_claim(token)
            if not is_owner:
                # Replay the first execution's outcome on OUR connection.
                # An exception out of idem_fut is the CACHED EXECUTION's
                # failure (even a ConnectionLost the handler raised) — it
                # must still be answered, or the retrier stalls for its
                # whole deadline; only OUR OWN send failing is droppable.
                try:
                    result = await asyncio.shield(idem_fut)
                except asyncio.CancelledError:
                    raise
                except Exception as e:
                    out = (KIND_ERR, f"{type(e).__name__}: {e}")
                else:
                    out = (KIND_RESP, result)
                try:
                    await self._send(msg_id, out[0], method, out[1])
                except (ConnectionLost, ConnectionResetError,
                        BrokenPipeError):
                    pass
                return
        release = None
        try:
            # counted HERE — after the dedup replay path has returned — so
            # a retried idempotent request counts one logical execution no
            # matter how many attempts the client's latency histogram saw
            _mx().handled_c(method).inc()
            result = fn(self, payload)
            if asyncio.iscoroutine(result):
                result = await result
            if isinstance(result, Finalized):
                release = result.release
                result = result.payload
            if idem_fut is not None and not idem_fut.done():
                idem_fut.set_result(result)
            if kind == KIND_REQ:
                await self._send(msg_id, KIND_RESP, method, result)
        except (ConnectionLost, ConnectionResetError, BrokenPipeError) as e:
            if idem_fut is not None and not idem_fut.done():
                # a FAILED execution must not be replayed to retriers —
                # evict so the retry re-executes; hand waiters the error
                _idem_forget(token)
                idem_fut.set_exception(e)
                idem_fut.add_done_callback(lambda f: f.exception())
        except Exception as e:
            logger.exception("handler %s failed on %s", method, self.name)
            if idem_fut is not None and not idem_fut.done():
                _idem_forget(token)
                idem_fut.set_exception(e)
                idem_fut.add_done_callback(lambda f: f.exception())
            if kind == KIND_REQ:
                try:
                    await self._send(msg_id, KIND_ERR, method, f"{type(e).__name__}: {e}")
                except Exception:
                    pass
        finally:
            if release is not None:
                # the response frame is past _send (handed to the
                # transport); drop our own reference to the payload so its
                # buffer views die and release() can close the resource
                # (e.g. an ObjectBuffer mmap) instead of deferring to GC
                result = None
                try:
                    release()
                except Exception:
                    logger.exception("response finalizer failed for %s", method)

    async def _do_close(self, error: Optional[Exception] = None):
        if self._closed:
            return
        self._closed = True
        self._close_error = error
        if self._keepalive_task is not None:
            self._keepalive_task.cancel()
        for fut in self._pending.values():
            if not fut.done():
                fut.set_exception(
                    error if error is not None
                    else ConnectionLost(f"connection {self.name} lost"))
        self._pending.clear()
        try:
            self.writer.close()
        except Exception:
            pass
        if self.on_close:
            try:
                result = self.on_close(self)
                if asyncio.iscoroutine(result):
                    await result
            except Exception:
                logger.exception("on_close callback failed for %s", self.name)

    async def close(self):
        if self._recv_task:
            self._recv_task.cancel()
        await self._do_close()

    @property
    def closed(self):
        return self._closed


def own_stall_s(elapsed: float, interval: float) -> float:
    """The seconds a periodic check that slept ``interval`` and woke
    ``elapsed`` after its last round lost to its own process stalling:
    the overshoot once it exceeds one interval, else 0. A failure detector
    adds them to its peers' silence clock, so that a pause of the whole
    host (every process frozen alike) or of this process alone is not
    read as the peers' silence."""
    late = elapsed - interval
    return late if late > interval else 0.0


class RpcServer:
    """Asyncio TCP server; each accepted peer becomes a Connection with the
    given handler. The handler may implement ``on_connection(conn)`` /
    ``on_disconnect(conn)``."""

    def __init__(self, handler, host: str = "127.0.0.1", port: int = 0):
        self.handler = handler
        self.host = host
        self.port = port
        self._server: Optional[asyncio.AbstractServer] = None
        self.connections: set = set()

    async def start(self):
        self._server = await asyncio.start_server(self._accept, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        return self.port

    async def _accept(self, reader, writer):
        from ray_tpu_torch._private.config import GLOBAL_CONFIG

        try:
            preamble = await asyncio.wait_for(
                reader.readexactly(_AUTH_LEN), GLOBAL_CONFIG.rpc_auth_timeout_s
            )
        except Exception:
            writer.close()
            return
        # run ALL digest compares unconditionally (constant-time-ish); the
        # magic picks the negotiated frame version
        token = cluster_token()
        is_v3 = hmac.compare_digest(preamble, _auth_preamble(token, 3))
        is_v2 = hmac.compare_digest(preamble, _auth_preamble(token, 2))
        is_v1 = hmac.compare_digest(preamble, _auth_preamble(token, 1))
        if not (is_v1 or is_v2 or is_v3):
            logger.warning("rejecting unauthenticated peer on :%d", self.port)
            writer.close()
            return
        version = 3 if is_v3 else (2 if is_v2 else 1)
        if version >= 2:
            # version byte after the preamble: confirms v2/v3 to the client
            # (an older server would instead have closed the connection)
            writer.write(_ACKS[version])
        peername = writer.get_extra_info("peername")
        peer_addr = f"{peername[0]}:{peername[1]}" if peername else None
        conn = Connection(reader, writer, self.handler,
                          name=f"server:{self.port}", version=version,
                          peer_addr=peer_addr)
        self.connections.add(conn)

        def _closed(c):
            self.connections.discard(c)
            cb = getattr(self.handler, "on_disconnect", None)
            if cb:
                return cb(c)

        conn.on_close = _closed
        cb = getattr(self.handler, "on_connection", None)
        if cb:
            result = cb(conn)
            if asyncio.iscoroutine(result):
                await result
        conn.start()

    async def stop(self):
        if self._server:
            self._server.close()
            await self._server.wait_closed()
        for conn in list(self.connections):
            await conn.close()


async def connect(host: str, port: int, handler=None, name: str = "client",
                  retries: int = None, retry_delay: float = None,
                  token: Optional[str] = None,
                  version: Optional[int] = None,
                  total_timeout: Optional[float] = None) -> Connection:
    """``token`` overrides the ambient cluster token for THIS connection —
    the path to external services with their own credential (the remote
    KV metadata server, like Redis with requirepass).

    ``version`` pins the frame format (default: the rpc_frame_version
    flag). A v3 dial that the peer rejects — an older server closes the
    connection at the digest compare — falls back one version per redial
    (3 -> 2 -> 1), so mixed-version clusters interoperate for one release.

    Dial failures retry with EXPONENTIAL backoff + jitter: delay starts at
    ``retry_delay`` (flag: rpc_connect_retry_delay_s), doubles per attempt,
    and caps at rpc_connect_backoff_max_s — a dead peer costs attempts, not
    a connect storm. ``retries`` bounds attempts; ``total_timeout`` (used
    by GCS-outage reconnect paths) instead retries until the deadline,
    sized against gcs_client_reconnect_timeout_s."""
    from ray_tpu_torch._private.config import GLOBAL_CONFIG

    if retries is None:
        retries = GLOBAL_CONFIG.rpc_connect_retries
    if retry_delay is None:
        retry_delay = GLOBAL_CONFIG.rpc_connect_retry_delay_s
    cap = max(retry_delay, GLOBAL_CONFIG.rpc_connect_backoff_max_s)
    deadline = (time.monotonic() + total_timeout) if total_timeout else None
    want = min(_frame_version() if version is None else version, 3)
    addr = f"{host}:{port}"
    last = None
    attempt = 0
    while True:
        try:
            plan = faultsim.active_plan()
            if plan is not None and plan.on_connect(addr):
                faultsim.record_injection("partition", "connect")
                raise ConnectionRefusedError(
                    f"fault injection: partitioned from {addr}")
            reader, writer = await asyncio.open_connection(host, port)
            tok = cluster_token() if token is None else token
            negotiated = 1
            if want >= 2:
                writer.write(_auth_preamble(tok, want))
                await writer.drain()
                try:
                    ack = await asyncio.wait_for(
                        reader.readexactly(1),
                        GLOBAL_CONFIG.rpc_auth_timeout_s,
                    )
                except (asyncio.IncompleteReadError, asyncio.TimeoutError,
                        ConnectionResetError, OSError) as e:
                    try:
                        writer.close()
                    except Exception:
                        pass
                    # Downgrade ONLY on a clean EOF — that is an older
                    # server deliberately closing at the unknown magic (or
                    # a token mismatch — v1 surfaces those on first use
                    # too). A reset/timeout is a transient network event;
                    # downgrading on it would silently strip CRC+keepalive
                    # from a fully capable peer for the session's lifetime.
                    msg = f"v{want} handshake refused: {e!r}"
                    if isinstance(e, asyncio.IncompleteReadError):
                        want -= 1
                    raise ConnectionRefusedError(msg) from None
                if ack != _ACKS[want]:
                    try:
                        writer.close()
                    except Exception:
                        pass
                    raise ConnectionLost(
                        f"bad version ack from {addr}: {ack!r}"
                    )
                negotiated = want
            else:
                writer.write(_auth_preamble(tok, 1))
                await writer.drain()
            conn = Connection(reader, writer, handler, name=name,
                              version=negotiated, peer_addr=addr)
            # Client-side conns get disconnect callbacks too (raylet/worker
            # GCS-reconnect loops key off this).
            cb = getattr(handler, "on_disconnect", None)
            if cb is not None:
                conn.on_close = cb
            conn.start()
            return conn
        except (ConnectionRefusedError, OSError) as e:
            last = e
            attempt += 1
            if deadline is None:
                if attempt >= retries:
                    break
            elif time.monotonic() >= deadline:
                break
            await asyncio.sleep(_backoff_delay(attempt, retry_delay, cap))
    raise ConnectionLost(f"cannot connect to {addr}: {last}")


# Transient transport failures: safe to retry (with backoff) for idempotent
# methods, and for side-effectful ones that carry an ``idem`` token.
TRANSIENT_RPC_ERRORS = (ConnectionLost, RpcTimeoutError,
                        ConnectionResetError, BrokenPipeError, OSError)


async def call_with_retries(get_conn, method: str, payload=None, *,
                            timeout: Optional[float] = None,
                            idem=None, attempts: Optional[int] = None,
                            base_delay: Optional[float] = None,
                            max_delay: Optional[float] = None):
    """Issue ``method`` with exponential backoff + jitter across transient
    transport failures (the retry/backoff classification the control plane
    rides on; ray parity: gRPC retry policies on GCS channels).

    ``get_conn``: a live Connection, or a (possibly async) zero-arg
    callable returning the CURRENT connection — reconnect loops (e.g. the
    raylet's GCS conn) swap the object out underneath, and each attempt
    re-resolves it. Returning None means "not reconnected yet": the
    attempt is charged and backed off.

    Contract: idempotent methods (heartbeats, lookups, location queries)
    may be passed bare; side-effectful ones MUST carry ``idem`` — the
    receiver dedups on it, so a retry whose original actually executed
    (response lost) replays the result instead of double-executing.
    Non-transient errors (handler failures -> RpcError) propagate on the
    first occurrence: re-running a deterministic failure is pure latency.
    """
    from ray_tpu_torch._private.config import GLOBAL_CONFIG

    if attempts is None:
        attempts = GLOBAL_CONFIG.rpc_retry_attempts
    if base_delay is None:
        base_delay = GLOBAL_CONFIG.rpc_retry_base_delay_s
    if max_delay is None:
        max_delay = GLOBAL_CONFIG.rpc_retry_max_delay_s
    last = None
    for attempt in range(max(1, attempts)):
        if attempt:
            _mx().retry_c(method).inc()
            await asyncio.sleep(_backoff_delay(attempt, base_delay, max_delay))
        try:
            conn = get_conn() if callable(get_conn) else get_conn
            if asyncio.iscoroutine(conn):
                conn = await conn
            if conn is None or conn.closed:
                last = ConnectionLost(f"no live connection for {method!r}")
                continue
            return await conn.request(method, payload, timeout=timeout,
                                      idem=idem)
        except TRANSIENT_RPC_ERRORS as e:
            last = e
    raise last


_BG_TASKS: set = set()


def spawn(coro, name: str = None) -> asyncio.Task:
    """create_task with a STRONG reference held until completion, plus
    dropped-exception logging. The event loop keeps only weak task refs: a
    fire-and-forget task awaiting a future that is reachable only from the
    task itself forms an unrooted cycle the GC may collect mid-await —
    silently skipping the coroutine's finally blocks. (Observed in round 4:
    a collected pump task left its registry key behind and stranded every
    subsequent task of its scheduling class.) Every fire-and-forget
    create_task in system processes must go through here or an equivalent
    live structure."""
    task = asyncio.get_running_loop().create_task(coro, name=name)
    if task.done():
        # Eager task factory: the coroutine ran to completion synchronously
        # inside create_task — registering the done-callback AFTER adding to
        # _BG_TASKS would fire it immediately (discard before add) and leak
        # the entry forever. Log any exception and skip the registry.
        if not task.cancelled() and task.exception() is not None:
            logger.error("background task %s failed: %r", task.get_name(),
                         task.exception(), exc_info=task.exception())
        return task
    _BG_TASKS.add(task)

    def _done(t):
        _BG_TASKS.discard(t)
        if not t.cancelled() and t.exception() is not None:
            logger.error("background task %s failed: %r", t.get_name(),
                         t.exception(), exc_info=t.exception())

    task.add_done_callback(_done)
    return task


def enable_eager_tasks(loop: asyncio.AbstractEventLoop):
    """Python 3.12 eager task execution: a new task runs synchronously
    until its first suspension instead of paying a full loop round-trip
    before its first byte of work. For the control plane's short RPC
    dispatch handlers this removes one scheduling hop per message — the
    dominant per-op cost the BENCH_CORE analysis identified. Code that
    NEEDS deferred execution must make it explicit (``_flush_writes``
    leads with ``await asyncio.sleep(0)``)."""
    factory = getattr(asyncio, "eager_task_factory", None)
    if factory is not None:
        loop.set_task_factory(factory)


def _log_dropped_exception(fut) -> None:
    try:
        exc = fut.exception()
    except (asyncio.CancelledError, concurrent.futures.CancelledError):
        return
    if exc is not None:
        logger.error("fire-and-forget coroutine failed: %r", exc,
                     exc_info=exc)


class EventLoopThread:
    """A dedicated asyncio loop on a daemon thread, for sync callers.

    This is the analog of the reference's per-process io_context thread
    (ray: src/ray/common/asio/instrumented_io_context.h) embedded in a
    synchronous Python driver/worker.
    """

    def __init__(self, name: str = "rpc-io"):
        self.loop = asyncio.new_event_loop()
        enable_eager_tasks(self.loop)
        self.thread = threading.Thread(target=self._run, name=name, daemon=True)
        self.thread.start()

    def _run(self):
        asyncio.set_event_loop(self.loop)
        if os.environ.get("RAY_TPU_TORCH_PROFILE_DIR"):
            from ray_tpu_torch._private.profiling import maybe_profile_thread

            maybe_profile_thread(f"ioloop-{self.thread.name}")
        self.loop.run_forever()

    def run(self, coro, timeout: float = None):
        """Run coroutine on the loop from a foreign thread, blocking."""
        fut = asyncio.run_coroutine_threadsafe(coro, self.loop)
        return fut.result(timeout)

    def submit(self, coro) -> "concurrent.futures.Future":
        """Schedule a coroutine on the loop, returning its
        ``concurrent.futures.Future`` for the caller to consume later —
        the pipelined middle ground between ``run`` (block now) and
        ``call_soon`` (never look). The chunked-collective transport
        keeps a window of these in flight so reduction of one chunk
        overlaps the RPC round trips of the next."""
        if not self.loop.is_running():
            coro.close()
            raise RuntimeError("event loop is stopped")
        return asyncio.run_coroutine_threadsafe(coro, self.loop)

    def call_soon(self, coro):
        if not self.loop.is_running():
            # Shutdown race: close the coroutine (avoids the un-awaited
            # warning) but RAISE — a silent drop would hang any caller
            # blocking on a future this coroutine was meant to resolve
            # (e.g. worker._resolve_owned_missing). Fire-and-forget call
            # sites already wrap call_soon in try/except.
            coro.close()
            raise RuntimeError("event loop is stopped")
        fut = asyncio.run_coroutine_threadsafe(coro, self.loop)
        # Fire-and-forget callers never .result() this future, and
        # run_coroutine_threadsafe swallows coroutine exceptions into it —
        # a crashed submit/registration coroutine would strand its task
        # forever with no trace. Surface the loss loudly instead.
        fut.add_done_callback(_log_dropped_exception)
        return fut

    def stop(self):
        if self.thread.is_alive() and self.loop.is_running():
            self._drain_tasks()
        # ALWAYS queue the stop + join while the thread lives: a loop that
        # has not reached run_forever yet still executes queued callbacks
        # once it starts, so this is the path that keeps an early-shutdown
        # worker from leaking a spinning io thread
        if self.thread.is_alive():
            try:
                self.loop.call_soon_threadsafe(self.loop.stop)
                self.thread.join(timeout=5)
            except Exception:
                pass

    def _drain_tasks(self):
        async def _drain():
            tasks = [t for t in asyncio.all_tasks(self.loop)
                     if t is not asyncio.current_task()]
            for t in tasks:
                t.cancel()
            # let cancellations actually RUN: stopping the loop with
            # cancelled-but-unfinished tasks makes their destructors spam
            # "Task was destroyed but it is pending!" on every shutdown
            await asyncio.gather(*tasks, return_exceptions=True)

        try:
            asyncio.run_coroutine_threadsafe(_drain(), self.loop).result(
                timeout=2.0
            )
        except Exception:
            pass
