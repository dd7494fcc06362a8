"""ctypes binding for the native (C++) object store.

Loads the port's own ``librtpu_store.so``, built with g++ from
``_private/csrc/`` at first load (never at import) into
``build/ray_tpu_torch/`` at the repository root, and exposes the same
surface as the pure-Python implementation in object_store.py. The runtime
picks native when available; set ``RAY_TPU_TORCH_NATIVE_STORE=0`` to force
the Python path, which also stands in when no compiler is present.

The library's file name carries a hash of the sources and the flags, so
an edited source rebuilds and an unchanged one loads the library already
built; ``compile_once`` builds it under a file lock and moves it into place
atomically.

Reference parity: this is the plasma-client boundary (ray:
src/ray/object_manager/plasma/client.h) collapsed to a C ABI — the data
plane stays mmap'd files in /dev/shm either way, so native and Python
processes interoperate on one store directory.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import threading
from pathlib import Path
from typing import Iterable, Optional, Sequence, Tuple

from ray_tpu_torch._private.compile_once import BUILD_DIR, compile_once

logger = logging.getLogger(__name__)

CSRC = Path(__file__).resolve().parent / "csrc"
LIB_SOURCES = ("object_store.cpp", "log_store.cpp", "scheduler.cpp")
CXX_FLAGS = ("-O2", "-fPIC", "-std=c++17", "-Wall", "-Wextra")

_lib = None
_lib_lock = threading.Lock()
_build_attempted = False


def output_path(stem: str, sources: Sequence[str], shared: bool) -> Path:
    """``build/ray_tpu_torch/<stem>-<hash>[.so]``: the hash covers the
    sources and the flags."""
    flags = CXX_FLAGS + (("-shared",) if shared else ())
    h = hashlib.sha256(" ".join(flags).encode())
    for name in sources:
        h.update(name.encode() + (CSRC / name).read_bytes())
    return BUILD_DIR / f"{stem}-{h.hexdigest()[:16]}{'.so' if shared else ''}"


def build(stem: str, sources: Sequence[str], shared: bool) -> Path:
    """Compile ``sources`` (names under ``csrc/``) with g++ unless the output
    exists; returns its path. Raises on a compiler failure."""
    out = output_path(stem, sources, shared)
    flags = CXX_FLAGS + (("-shared",) if shared else ())
    compile_once(out, stem, lambda tmp: ["g++", *flags, "-o", str(tmp), *(
        str(CSRC / name) for name in sources)])
    return out


def library_path() -> Path:
    return output_path("librtpu_store", LIB_SOURCES, shared=True)


def _configure(lib):
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.rtpu_write_object.restype = ctypes.c_long
    lib.rtpu_write_object.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_uint64,
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_uint64),
        ctypes.c_uint64,
    ]
    lib.rtpu_open_object.restype = ctypes.c_void_p
    lib.rtpu_open_object.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_uint64),
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_uint64),
    ]
    lib.rtpu_release_object.restype = None
    lib.rtpu_release_object.argtypes = [ctypes.c_void_p]
    lib.rtpu_object_exists.restype = ctypes.c_int
    lib.rtpu_object_exists.argtypes = [ctypes.c_char_p, ctypes.c_char_p]

    lib.rtpu_store_create.restype = ctypes.c_void_p
    lib.rtpu_store_create.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
    lib.rtpu_store_create2.restype = ctypes.c_void_p
    lib.rtpu_store_create2.argtypes = [
        ctypes.c_char_p, ctypes.c_uint64, ctypes.c_char_p
    ]
    lib.rtpu_store_restore.restype = ctypes.c_int
    lib.rtpu_store_restore.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.rtpu_store_is_spilled.restype = ctypes.c_int
    lib.rtpu_store_is_spilled.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.rtpu_store_spilled_bytes.restype = ctypes.c_uint64
    lib.rtpu_store_spilled_bytes.argtypes = [ctypes.c_void_p]
    lib.rtpu_store_destroy.restype = None
    lib.rtpu_store_destroy.argtypes = [ctypes.c_void_p]
    lib.rtpu_store_put.restype = ctypes.c_long
    lib.rtpu_store_put.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_uint64,
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_uint64),
        ctypes.c_uint64,
    ]
    for name in ("register_external", "touch", "pin", "unpin", "delete"):
        fn = getattr(lib, f"rtpu_store_{name}")
        fn.restype = None
        fn.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.rtpu_store_used.restype = ctypes.c_uint64
    lib.rtpu_store_used.argtypes = [ctypes.c_void_p]
    lib.rtpu_store_count.restype = ctypes.c_uint64
    lib.rtpu_store_count.argtypes = [ctypes.c_void_p]
    lib.rtpu_store_list.restype = ctypes.c_uint64
    lib.rtpu_store_list.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint64
    ]
    # append-log KV store (GCS persistence; csrc/log_store.cpp). Optional:
    # a library without these symbols still serves the object store.
    u8pp = ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8))
    u64p = ctypes.POINTER(ctypes.c_uint64)
    try:
        lib.rtpu_log_open
    except AttributeError:
        lib._has_log_store = False
        return lib
    lib._has_log_store = True
    lib.rtpu_log_open.restype = ctypes.c_void_p
    lib.rtpu_log_open.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.rtpu_log_put.restype = ctypes.c_int
    lib.rtpu_log_put.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint64,
        ctypes.c_char_p, ctypes.c_uint64, ctypes.c_char_p, ctypes.c_uint64,
    ]
    lib.rtpu_log_count.restype = ctypes.c_uint64
    lib.rtpu_log_count.argtypes = [ctypes.c_void_p]
    lib.rtpu_log_iter_start.restype = None
    lib.rtpu_log_iter_start.argtypes = [ctypes.c_void_p]
    lib.rtpu_log_iter_next.restype = ctypes.c_int
    lib.rtpu_log_iter_next.argtypes = [
        ctypes.c_void_p, u8pp, u64p, u8pp, u64p, u8pp, u64p,
    ]
    lib.rtpu_log_close.restype = None
    lib.rtpu_log_close.argtypes = [ctypes.c_void_p]
    return lib


def load_library() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native library; None if unavailable."""
    global _lib, _build_attempted
    if _lib is not None:
        return _lib
    if os.environ.get("RAY_TPU_TORCH_NATIVE_STORE", "1") == "0":
        return None
    with _lib_lock:
        if _lib is not None:
            return _lib
        path = library_path()
        if not path.exists() and not _build_attempted:
            _build_attempted = True
            try:
                build("librtpu_store", LIB_SOURCES, shared=True)
            except FileNotFoundError as e:  # no g++: the Python store
                logger.debug("native store not built: %s", e)
            except Exception as e:  # a compiler error in csrc/
                logger.warning("native store build failed: %s", e)
        if not path.exists():
            return None
        try:
            _lib = _configure(ctypes.CDLL(str(path)))
        except (OSError, AttributeError) as e:
            logger.warning("could not load native store: %s", e)
            return None
        return _lib


def available() -> bool:
    return load_library() is not None


def _buffer_pointers(metadata: bytes, buffers: Iterable):
    """(meta, bufs_array, lens_array, nbufs, keepalive) for a C call.

    Zero-copy for bytes and writable buffers; readonly non-bytes views are
    copied once (rare: big tensors expose writable buffers)."""
    keep = []
    ptrs = []
    lens = []
    for buf in buffers:
        if isinstance(buf, (bytes, bytearray)):
            ptrs.append(ctypes.cast(ctypes.c_char_p(bytes(buf) if isinstance(buf, bytearray) else buf), ctypes.c_void_p))
            keep.append(buf)
            lens.append(len(buf))
            continue
        mv = memoryview(buf)
        if mv.ndim != 1 or mv.format != "B":
            mv = mv.cast("B")
        if mv.readonly:
            b = bytes(mv)
            keep.append(b)
            ptrs.append(ctypes.cast(ctypes.c_char_p(b), ctypes.c_void_p))
            lens.append(len(b))
        else:
            c = (ctypes.c_char * len(mv)).from_buffer(mv)
            keep.append((mv, c))
            ptrs.append(ctypes.cast(ctypes.addressof(c), ctypes.c_void_p))
            lens.append(len(mv))
    n = len(ptrs)
    arr = (ctypes.c_void_p * n)(*ptrs)
    larr = (ctypes.c_uint64 * n)(*lens)
    return arr, larr, n, keep


def write_object(store_dir: str, oid_hex: str, metadata: bytes,
                 buffers: Iterable, total_data_len: int) -> int:
    lib = load_library()
    arr, larr, n, keep = _buffer_pointers(metadata, buffers)
    written = lib.rtpu_write_object(
        store_dir.encode(), oid_hex.encode(), metadata, len(metadata),
        arr, larr, n,
    )
    if written < 0:
        raise IOError(f"native write_object failed for {oid_hex}")
    return written


def open_object(store_dir: str, oid_hex: str
                ) -> Optional[Tuple[int, bytes, memoryview]]:
    """(handle, metadata, data_view) or None. Caller must release(handle)
    after the data view is no longer needed."""
    lib = load_library()
    meta_ptr = ctypes.c_void_p()
    meta_len = ctypes.c_uint64()
    data_ptr = ctypes.c_void_p()
    data_len = ctypes.c_uint64()
    handle = lib.rtpu_open_object(
        store_dir.encode(), oid_hex.encode(),
        ctypes.byref(meta_ptr), ctypes.byref(meta_len),
        ctypes.byref(data_ptr), ctypes.byref(data_len),
    )
    if not handle:
        return None
    metadata = ctypes.string_at(meta_ptr, meta_len.value)
    if data_len.value:
        carr = (ctypes.c_char * data_len.value).from_address(data_ptr.value)
        data = memoryview(carr)
    else:
        data = memoryview(b"")
    return handle, metadata, data


def release(handle: int):
    lib = load_library()
    lib.rtpu_release_object(ctypes.c_void_p(handle))


def object_exists(store_dir: str, oid_hex: str) -> bool:
    lib = load_library()
    return bool(lib.rtpu_object_exists(store_dir.encode(), oid_hex.encode()))


class NativeLocalObjectStore:
    """Owner-side accounting store backed by the C++ RtpuStore."""

    def __init__(self, store_dir: str, capacity_bytes: int,
                 spill_dir: Optional[str] = None):
        self._lib = load_library()
        assert self._lib is not None
        self.store_dir = store_dir
        self.capacity = capacity_bytes
        self.spill_dir = spill_dir
        self._store = ctypes.c_void_p(
            self._lib.rtpu_store_create2(
                store_dir.encode(), capacity_bytes,
                (spill_dir or "").encode(),
            )
        )

    # mirror of object_store.LocalObjectStore -------------------------
    def put(self, object_id, metadata: bytes, buffers, total_data_len: int):
        from ray_tpu_torch._private.object_store import ObjectStoreFullError

        arr, larr, n, keep = _buffer_pointers(metadata, buffers)
        rc = self._lib.rtpu_store_put(
            self._store, object_id.hex().encode(), metadata, len(metadata),
            arr, larr, n,
        )
        if rc == -2:
            raise ObjectStoreFullError(
                f"object does not fit: used={self.used_bytes()} "
                f"capacity={self.capacity} (all remaining objects pinned)"
            )
        if rc < 0:
            raise IOError(f"native store put failed for {object_id}")

    def register_external(self, object_id):
        self._lib.rtpu_store_register_external(
            self._store, object_id.hex().encode()
        )

    def get(self, object_id):
        from ray_tpu_torch._private import object_store as pystore

        buf = pystore.read_object(self.store_dir, object_id)
        if buf is None and self.restore_if_spilled(object_id):
            buf = pystore.read_object(self.store_dir, object_id)
        if buf is not None:
            self._lib.rtpu_store_touch(self._store, object_id.hex().encode())
        return buf

    def contains(self, object_id) -> bool:
        return object_exists(self.store_dir, object_id.hex()) or bool(
            self._lib.rtpu_store_is_spilled(
                self._store, object_id.hex().encode()
            )
        )

    def restore_if_spilled(self, object_id) -> bool:
        return self._lib.rtpu_store_restore(
            self._store, object_id.hex().encode()
        ) == 1

    def spilled_stats(self):
        return {
            "spilled_bytes_total": int(
                self._lib.rtpu_store_spilled_bytes(self._store)
            ),
        }

    def pin(self, object_id):
        self._lib.rtpu_store_pin(self._store, object_id.hex().encode())

    def unpin(self, object_id):
        self._lib.rtpu_store_unpin(self._store, object_id.hex().encode())

    def delete(self, object_id):
        self._lib.rtpu_store_delete(self._store, object_id.hex().encode())

    def used_bytes(self) -> int:
        return int(self._lib.rtpu_store_used(self._store))

    def object_ids(self):
        from ray_tpu_torch._private.ids import ObjectID

        n = int(self._lib.rtpu_store_count(self._store))
        if n == 0:
            return []
        buf = ctypes.create_string_buffer(65 * n)
        got = int(self._lib.rtpu_store_list(self._store, buf, n))
        out = []
        for i in range(got):
            hexid = buf.raw[i * 65 : (i + 1) * 65].split(b"\0", 1)[0].decode()
            out.append(ObjectID(bytes.fromhex(hexid)))
        return out
