"""URI-pluggable external storage for object spilling.

Reference parity: ray python/ray/_private/external_storage.py — the
reference's object_spilling_config selects a storage backend
(filesystem, S3 via smart_open) that IO workers stream spilled objects
through (src/ray/raylet/local_object_manager.h:40); restore brings them
back by URI. Here the raylet's store calls the same spill/restore/delete
contract; ``file://`` (or a bare path) is the filesystem backend, s3://
is boto3-gated, and tests register custom schemes to play the role of a
remote object store without network egress.

Spill keys are deterministic (object id derived), so a restarted raylet
can find a predecessor's spilled objects at the same URI — local-disk
spill dies with the node; external spill survives it.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Optional
from urllib.parse import urlparse


class ExternalStorage:
    """Contract: keys are opaque strings chosen by the caller; values are
    whole object files (the sealed on-disk format)."""

    def spill(self, key: str, local_path: str) -> None:
        """Upload local_path under key (overwrite allowed: objects are
        immutable, double-spill writes identical bytes)."""
        raise NotImplementedError

    def restore(self, key: str, local_path: str) -> bool:
        """Download key to local_path (atomically); False if absent."""
        raise NotImplementedError

    def delete(self, key: str) -> None:
        raise NotImplementedError

    def exists(self, key: str) -> bool:
        raise NotImplementedError


class FileSystemStorage(ExternalStorage):
    """file:///mount/point — shared filesystem (NFS/GCS-fuse) or plain
    local dir (the classic spill-to-disk)."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def _path(self, key: str) -> str:
        return os.path.join(self.root, key)

    def spill(self, key: str, local_path: str) -> None:
        dst = self._path(key)
        tmp = dst + ".tmp"
        with open(local_path, "rb") as fi, open(tmp, "wb") as fo:
            while True:
                chunk = fi.read(8 * 1024 * 1024)
                if not chunk:
                    break
                fo.write(chunk)
        os.replace(tmp, dst)

    def spill_move(self, key: str, local_path: str) -> bool:
        """Adopt ``local_path`` as the spilled copy by rename — atomic
        and copy-free when the caller staged on this filesystem. False
        (e.g. EXDEV across devices) means fall back to ``spill``."""
        try:
            os.replace(local_path, self._path(key))
            return True
        except OSError:
            return False

    def restore(self, key: str, local_path: str) -> bool:
        src = self._path(key)
        if not os.path.exists(src):
            return False
        tmp = local_path + ".restoring"
        with open(src, "rb") as fi, open(tmp, "wb") as fo:
            while True:
                chunk = fi.read(8 * 1024 * 1024)
                if not chunk:
                    break
                fo.write(chunk)
        os.replace(tmp, local_path)
        return True

    def delete(self, key: str) -> None:
        try:
            os.unlink(self._path(key))
        except FileNotFoundError:
            pass

    def exists(self, key: str) -> bool:
        return os.path.exists(self._path(key))


class S3Storage(ExternalStorage):
    """s3://bucket/prefix — boto3-gated (absent in this image: a clear
    error at construction, mirroring the reference's smart_open
    dependency for S3 spilling)."""

    def __init__(self, bucket: str, prefix: str):
        try:
            import boto3
        except ImportError as e:
            raise RuntimeError(
                "s3:// spilling needs boto3, which is not installed; use "
                "file:// or register a custom scheme via "
                "register_external_storage_scheme"
            ) from e
        self._s3 = boto3.client("s3")
        self.bucket = bucket
        self.prefix = prefix.strip("/")

    def _key(self, key: str) -> str:
        return f"{self.prefix}/{key}" if self.prefix else key

    def spill(self, key: str, local_path: str) -> None:
        self._s3.upload_file(local_path, self.bucket, self._key(key))

    def restore(self, key: str, local_path: str) -> bool:
        import botocore.exceptions

        tmp = local_path + ".restoring"
        try:
            self._s3.download_file(self.bucket, self._key(key), tmp)
        except botocore.exceptions.ClientError:
            return False
        os.replace(tmp, local_path)
        return True

    def delete(self, key: str) -> None:
        self._s3.delete_object(Bucket=self.bucket, Key=self._key(key))

    def exists(self, key: str) -> bool:
        import botocore.exceptions

        try:
            self._s3.head_object(Bucket=self.bucket, Key=self._key(key))
            return True
        except botocore.exceptions.ClientError:
            return False


_SCHEMES: Dict[str, Callable[[str], ExternalStorage]] = {}


def register_external_storage_scheme(
    scheme: str, factory: Callable[[str], ExternalStorage]
) -> None:
    """Plug a custom backend: ``factory(uri) -> ExternalStorage``. Tests
    use this as the s3-style remote stand-in; deployments can wire GCS,
    Azure, or an internal blob service the same way."""
    _SCHEMES[scheme] = factory


def make_external_storage(uri: Optional[str]) -> Optional[ExternalStorage]:
    """None for empty; FileSystemStorage for bare paths and file://;
    scheme registry / S3 otherwise."""
    if not uri:
        return None
    parsed = urlparse(uri)
    if parsed.scheme in ("", "file"):
        return FileSystemStorage(parsed.path or uri)
    if parsed.scheme in _SCHEMES:
        return _SCHEMES[parsed.scheme](uri)
    if parsed.scheme == "s3":
        return S3Storage(parsed.netloc, parsed.path)
    raise ValueError(
        f"unknown external storage scheme {parsed.scheme!r} in {uri!r}; "
        f"known: file, s3" + (", " + ", ".join(_SCHEMES) if _SCHEMES else "")
    )


def is_local_spill_uri(uri: Optional[str]) -> bool:
    """True when the target is plain-filesystem (native-store fast path
    applies); non-file schemes route through the Python store + driver."""
    if not uri:
        return True
    return urlparse(uri).scheme in ("", "file")
