"""Pluggable GCS persistence.

Analog of the reference's StoreClient family
(ray: src/ray/gcs/store_client/in_memory_store_client.h,
redis_store_client.h; typed tables gcs_table_storage.h:50,248). The
reference persists GCS tables to Redis so a restarted GCS replays state
(`gcs_init_data.h`) and clients resubscribe. TPU-native we use an
append-only log file on the head node (Redis isn't a baked-in dependency);
the interface is small enough that a Redis/etcd client drops in.

Records are length-prefixed pickles of ``(table, key, value)`` where
``value=None`` tombstones the key. ``load()`` replays the log into
``{table: {key: value}}`` and compacts it (rewrites live records only), so
the log stays proportional to live state, not mutation count.
"""

from __future__ import annotations

import os
import pickle
import struct
import threading
from typing import Dict, Optional

_LEN = struct.Struct("<I")


class NullStore:
    """In-memory GCS: nothing survives restart (the default)."""

    def load(self) -> Dict[str, dict]:
        return {}

    def put(self, table: str, key, value) -> None:
        pass

    def close(self) -> None:
        pass


class FileLogStore:
    """Append-only log with replay + compaction on load."""

    def __init__(self, path: str, fsync: bool = False):
        self.path = path
        self.fsync = fsync
        self._lock = threading.Lock()
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._f = None

    # first bytes of a native-store (csrc/log_store.cpp) file — this store
    # must refuse it rather than compact it down to nothing
    NATIVE_MAGIC = b"RTPULG02"

    def load(self) -> Dict[str, dict]:
        tables: Dict[str, dict] = {}
        if os.path.exists(self.path):
            with open(self.path, "rb") as probe:
                if probe.read(8) == self.NATIVE_MAGIC:
                    raise RuntimeError(
                        f"{self.path} was written by the native log store "
                        "but the native library is unavailable; install "
                        "g++ so native_store builds it, or move the "
                        "file aside"
                    )
            with open(self.path, "rb") as f:
                while True:
                    header = f.read(_LEN.size)
                    if len(header) < _LEN.size:
                        break
                    (n,) = _LEN.unpack(header)
                    blob = f.read(n)
                    if len(blob) < n:  # torn tail write: stop replay here
                        break
                    try:
                        table, key, value = pickle.loads(blob)
                    except Exception:
                        break
                    if value is None:
                        tables.get(table, {}).pop(key, None)
                    else:
                        tables.setdefault(table, {})[key] = value
        self._compact(tables)
        return tables

    def _compact(self, tables: Dict[str, dict]) -> None:
        tmp = self.path + ".compact"
        with open(tmp, "wb") as f:
            for table, entries in tables.items():
                for key, value in entries.items():
                    blob = pickle.dumps((table, key, value), protocol=5)
                    f.write(_LEN.pack(len(blob)))
                    f.write(blob)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.path)
        self._f = open(self.path, "ab")

    def put(self, table: str, key, value) -> None:
        if self._f is None:
            self._f = open(self.path, "ab")
        blob = pickle.dumps((table, key, value), protocol=5)
        with self._lock:
            self._f.write(_LEN.pack(len(blob)))
            self._f.write(blob)
            self._f.flush()
            if self.fsync:
                os.fsync(self._f.fileno())

    def close(self) -> None:
        with self._lock:
            if self._f is not None:
                self._f.close()
                self._f = None


class NativeLogStore:
    """C++ append-log store (csrc/log_store.cpp) behind the same interface:
    native framing, torn-tail truncation, and compaction; keys/values stay
    pickled by this layer (opaque bytes to C++). Reference analog: the
    RedisStoreClient persistence role, collapsed to a local log."""

    def __init__(self, path: str, fsync: bool = False):
        import ctypes

        from ray_tpu_torch._private import native_store

        lib = native_store.load_library()
        if lib is None or not getattr(lib, "_has_log_store", False):
            raise OSError("native library lacks the log store")
        self._lib = lib
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._h = ctypes.c_void_p(
            lib.rtpu_log_open(path.encode(), 1 if fsync else 0)
        )
        if not self._h:
            raise OSError(f"native log store failed to open {path}")

    def load(self) -> Dict[str, dict]:
        import ctypes

        if not self._h:
            raise OSError("native log store is closed")
        tables: Dict[str, dict] = {}
        lib = self._lib
        lib.rtpu_log_iter_start(self._h)
        t = ctypes.POINTER(ctypes.c_uint8)()
        k = ctypes.POINTER(ctypes.c_uint8)()
        v = ctypes.POINTER(ctypes.c_uint8)()
        tl = ctypes.c_uint64()
        kl = ctypes.c_uint64()
        vl = ctypes.c_uint64()
        while lib.rtpu_log_iter_next(
            self._h, ctypes.byref(t), ctypes.byref(tl), ctypes.byref(k),
            ctypes.byref(kl), ctypes.byref(v), ctypes.byref(vl),
        ):
            table = ctypes.string_at(t, tl.value).decode()
            key = pickle.loads(ctypes.string_at(k, kl.value))
            value = pickle.loads(ctypes.string_at(v, vl.value))
            tables.setdefault(table, {})[key] = value
        return tables

    def put(self, table: str, key, value) -> None:
        if not self._h:
            raise OSError("native log store is closed")
        tb = table.encode()
        kb = pickle.dumps(key, protocol=5)
        if value is None:
            rc = self._lib.rtpu_log_put(self._h, tb, len(tb), kb, len(kb),
                                        None, 0)
        else:
            vb = pickle.dumps(value, protocol=5)
            rc = self._lib.rtpu_log_put(self._h, tb, len(tb), kb, len(kb),
                                        vb, len(vb))
        if rc != 0:
            raise OSError(
                f"native log store write failed (disk full?): {table!r}"
            )

    def close(self) -> None:
        if self._h:
            self._lib.rtpu_log_close(self._h)
            self._h = None


class SqliteStore:
    """Durable external storage backend (reference analog: the
    RedisStoreClient role, src/ray/gcs/store_client/redis_store_client.h
    — GCS tables live in a store that outlives the GCS process). Point
    it at LOCAL persistent disk outside the session dir and head-node
    session loss no longer loses cluster metadata. Do NOT put the file
    on NFS or similar network filesystems: SQLite's WAL mode needs
    shared memory and network-FS locking is unreliable — for
    network-attached durability, drop a Redis/etcd client behind the
    same load/put/close interface instead.

    Selected with a ``sqlite://<path>`` persist path (see make_store).
    WAL mode with synchronous=FULL: every commit is fsync'd — this
    store exists for the machine-loss case, not just process loss.

    ``cluster_id`` scopes ownership: reopening the DB from a DIFFERENT
    cluster wipes the previous cluster's state instead of resurrecting
    its actors/jobs into the new one (a restarted GCS of the SAME
    cluster replays normally).
    """

    def __init__(self, path: str, cluster_id: Optional[str] = None):
        import sqlite3

        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self.path = path
        self._lock = threading.Lock()
        self._db = sqlite3.connect(path, check_same_thread=False)
        self._db.execute("PRAGMA journal_mode=WAL")
        self._db.execute("PRAGMA synchronous=FULL")
        self._db.execute(
            "CREATE TABLE IF NOT EXISTS gcs_kv ("
            " tbl TEXT NOT NULL, key BLOB NOT NULL, value BLOB NOT NULL,"
            " PRIMARY KEY (tbl, key))"
        )
        self._db.execute(
            "CREATE TABLE IF NOT EXISTS gcs_meta ("
            " key TEXT PRIMARY KEY, value TEXT)"
        )
        self._db.commit()
        if cluster_id:
            row = self._db.execute(
                "SELECT value FROM gcs_meta WHERE key='cluster_id'"
            ).fetchone()
            if row is not None and row[0] != cluster_id:
                import logging

                logging.getLogger(__name__).warning(
                    "sqlite GCS store %s belonged to cluster %s; wiping "
                    "its state for new cluster %s", path, row[0], cluster_id,
                )
                self._db.execute("DELETE FROM gcs_kv")
            self._db.execute(
                "INSERT OR REPLACE INTO gcs_meta (key, value) "
                "VALUES ('cluster_id', ?)", (cluster_id,)
            )
            self._db.commit()

    def load(self) -> Dict[str, dict]:
        tables: Dict[str, dict] = {}
        with self._lock:
            rows = self._db.execute(
                "SELECT tbl, key, value FROM gcs_kv"
            ).fetchall()
        for tbl, key, value in rows:
            tables.setdefault(tbl, {})[pickle.loads(key)] = \
                pickle.loads(value)
        return tables

    def put(self, table: str, key, value) -> None:
        kb = pickle.dumps(key, protocol=5)
        with self._lock:
            if value is None:
                self._db.execute(
                    "DELETE FROM gcs_kv WHERE tbl=? AND key=?", (table, kb)
                )
            else:
                self._db.execute(
                    "INSERT OR REPLACE INTO gcs_kv (tbl, key, value) "
                    "VALUES (?, ?, ?)",
                    (table, kb, pickle.dumps(value, protocol=5)),
                )
            self._db.commit()

    def close(self) -> None:
        with self._lock:
            try:
                self._db.close()
            except Exception:
                pass


class RemoteKvStore:
    """GCS persistence against a REMOTE KV server (``kv://host:port`` —
    see kv_server.py). Reference parity: ray's Redis store client
    (src/ray/gcs/store_client/redis_store_client.h): cluster metadata
    lives OFF the head node, so losing the head's disk loses nothing —
    a restarted GCS loads the full snapshot back over the wire.

    ``put()`` never blocks the caller: it is called from GCS RPC
    handlers ON the GCS event loop (gcs.py _persist_actor/_persist_pg),
    where one synchronous KV round trip per mutation would stall the
    entire control plane — and a HUNG server would stall it longer than
    node_death_timeout_s, declaring healthy nodes dead. Mutations are
    queued FIFO and drained by one writer task on the kv io thread,
    pipelined in batches; the wire order equals the put order, so a
    tombstone after a write lands as a tombstone. ``aput()`` is the
    awaitable variant for client-observed writes (the GCS kv_put handler
    awaits the flush before acking, restoring the redis-store durability
    contract without blocking its loop). A failed flush trips a
    circuit breaker into the degraded no-persist posture (same posture
    as a full disk under the log store) for
    ``gcs_kv_breaker_cooldown_s``, then retries. ``close()`` drains the
    queue (bounded) so a clean shutdown loses nothing.
    """

    def __init__(self, address: str, cluster_id: Optional[str] = None):
        from ray_tpu_torch._private.rpcio import EventLoopThread, connect

        self.cluster_id = cluster_id or ""
        # kv://[:token@]host:port — the KV server is cluster-EXTERNAL, so
        # it authenticates with its own secret (redis requirepass shape),
        # not the per-cluster generated token
        token = None
        if "@" in address:
            userinfo, address = address.rsplit("@", 1)
            token = userinfo.lstrip(":")
        host, port = address.rsplit(":", 1)
        self._io = EventLoopThread("gcs-kv-store")
        self._conn = self._io.run(connect(host, int(port),
                                          name="gcs-kv-store",
                                          token=token))
        # fail fast on a wrong address instead of at first load
        self._io.run(self._conn.request("kv_ping", {}), timeout=10)
        from collections import deque

        self._q: deque = deque()  # of ((table, key, value), ack_fut|None)
        self._lock = threading.Lock()
        self._flushing = False
        self._degraded_until = 0.0
        self._dropped = 0
        self._setup_metrics()

    def _setup_metrics(self):
        """Snapshot-time gauges over the put pipeline: queue depth,
        breaker posture, drops (metrics_core.py — zero hot-path cost)."""
        try:
            import time as _time

            from ray_tpu_torch._private import metrics_core as mc

            reg = mc.registry()
            reg.gauge("gcs_kv_put_queue_depth",
                      "Remote-KV puts queued for the io thread"
                      ).set_fn(lambda: len(self._q))
            reg.gauge("gcs_kv_breaker_open",
                      "1 while the remote-KV circuit breaker holds the "
                      "degraded no-persist posture").set_fn(
                lambda: 1.0 if _time.monotonic() < self._degraded_until
                else 0.0)
            reg.counter("gcs_kv_puts_dropped_total",
                        "Puts dropped by overload/breaker"
                        ).default.set_fn(lambda: self._dropped)
        except Exception:  # metrics must never break persistence setup
            pass

    def _cfg(self):
        from ray_tpu_torch._private.config import GLOBAL_CONFIG

        return GLOBAL_CONFIG

    def load(self) -> Dict[str, dict]:
        out = self._io.run(
            self._conn.request("kv_load", {"cluster_id": self.cluster_id}),
            timeout=60,
        )
        return out.get("tables", {})

    def put(self, table: str, key, value) -> None:
        self._enqueue((table, key, value), None)

    async def aput(self, table: str, key, value) -> bool:
        """Awaitable put for callers on SOME event loop (the GCS kv_put
        handler): resolves once the mutation is flushed to the server, so
        a client-observed ack is durable — without ever blocking the
        caller's loop. Bounded: a degraded server resolves False after
        the put timeout (well under node_death_timeout_s) instead of
        stalling the control plane."""
        import asyncio
        import concurrent.futures

        fut: concurrent.futures.Future = concurrent.futures.Future()
        self._enqueue((table, key, value), fut)
        try:
            return bool(await asyncio.wait_for(
                asyncio.wrap_future(fut),
                self._cfg().gcs_kv_put_timeout_s + 1.0,
            ))
        except Exception:
            return False

    @staticmethod
    def _ack(fut, ok: bool):
        if fut is not None and not fut.done():
            fut.set_result(ok)

    def _enqueue(self, entry, fut) -> None:
        if not self._io.loop.is_running():
            # shutdown race: the drain task can never run
            self._ack(fut, False)
            return
        cfg = self._cfg()
        with self._lock:
            if len(self._q) >= cfg.gcs_kv_queue_max:
                # overload: drop the OLDEST entry — for a same-key churn
                # the newest write is the one that must win, and the
                # breaker below is what normally bounds the queue anyway
                _, old_fut = self._q.popleft()
                self._ack(old_fut, False)
                self._dropped += 1
            self._q.append((entry, fut))
            if self._flushing:
                return
            self._flushing = True
        try:
            self._io.loop.call_soon_threadsafe(self._start_drain)
        except RuntimeError:
            with self._lock:
                self._flushing = False
            self._ack(fut, False)

    def _start_drain(self):
        # on the kv io loop; keep a strong ref so the task can't be GC'd
        task = self._io.loop.create_task(self._drain())
        self._drain_task = task

    async def _drain(self):
        import asyncio
        import logging
        import time as _time

        cfg = self._cfg()
        log = logging.getLogger(__name__)
        try:
            while True:
                with self._lock:
                    if not self._q:
                        self._flushing = False
                        return
                    batch = []
                    while self._q and len(batch) < 256:
                        batch.append(self._q.popleft())
                entries = [entry for entry, _ in batch]
                futs = [fut for _, fut in batch]
                if _time.monotonic() < self._degraded_until:
                    # breaker open: degraded no-persist — drop and count
                    self._dropped += len(batch)
                    for fut in futs:
                        self._ack(fut, False)
                    continue
                try:
                    await self._conn.request(
                        "kv_put",
                        {"cluster_id": self.cluster_id, "entries": entries},
                        timeout=cfg.gcs_kv_put_timeout_s,
                    )
                    for fut in futs:
                        self._ack(fut, True)
                except asyncio.CancelledError:
                    raise
                except Exception as e:
                    self._dropped += len(batch)
                    for fut in futs:
                        self._ack(fut, False)
                    self._degraded_until = (
                        _time.monotonic() + cfg.gcs_kv_breaker_cooldown_s
                    )
                    log.warning(
                        "remote KV put failed (%s); persistence degraded "
                        "for %.0fs (%d mutations dropped so far)",
                        e, cfg.gcs_kv_breaker_cooldown_s, self._dropped,
                    )
        except BaseException:
            with self._lock:
                self._flushing = False
            raise

    def close(self) -> None:
        # bounded drain: a clean shutdown persists everything queued; a
        # degraded/hung server gives up after the put timeout instead of
        # wedging GCS teardown
        import time as _time

        deadline = _time.monotonic() + self._cfg().gcs_kv_put_timeout_s
        while _time.monotonic() < deadline:
            with self._lock:
                idle = not self._q and not self._flushing
            if idle or _time.monotonic() < self._degraded_until:
                break
            _time.sleep(0.01)
        self._io.stop()


def make_store(persist_path: Optional[str],
               cluster_id: Optional[str] = None):
    """Backend selection by scheme:

    - ``None``/empty        -> NullStore (in-memory, nothing survives)
    - ``sqlite://<path>``   -> SqliteStore (durable external store)
    - ``kv://host:port``    -> RemoteKvStore (external KV server; head
      disk loss loses no metadata — kv_server.py, redis-analog)
    - plain path            -> native C++ log store when the library
      loads, Python append-log fallback otherwise

    ``RAY_TPU_TORCH_GCS_STORAGE`` overrides the configured path wholesale, so
    an operator can point an existing deployment at durable storage
    without touching startup scripts. ``cluster_id`` (the session name)
    keeps an external store from resurrecting a previous cluster's
    state — session-dir log files are per-cluster by construction."""
    persist_path = os.environ.get("RAY_TPU_TORCH_GCS_STORAGE") or persist_path
    if not persist_path:
        return NullStore()
    if persist_path.startswith("sqlite://"):
        return SqliteStore(persist_path[len("sqlite://"):],
                           cluster_id=cluster_id)
    if persist_path.startswith("kv://"):
        return RemoteKvStore(persist_path[len("kv://"):],
                             cluster_id=cluster_id)
    try:
        from ray_tpu_torch._private import native_store

        if native_store.available():
            # Open refuses foreign formats (returns null -> OSError), so a
            # log written by the Python store falls through to it intact.
            return NativeLogStore(persist_path)
    except Exception:
        pass
    return FileLogStore(persist_path)
