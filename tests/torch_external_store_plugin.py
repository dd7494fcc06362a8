"""Custom external-storage scheme for tests: a content-addressed blob
dir with a manifest — a DIFFERENT layout from plain spill files, so a
passing test proves the driver (not path compatibility) moved the bytes.
Registered by the raylet via RAY_TPU_TORCH_EXTERNAL_STORAGE_SETUP_MODULE (the
plugin hook), standing in for an s3-style remote object store."""

import hashlib
import json
import os
from urllib.parse import urlparse

from ray_tpu_torch._private.external_storage import (
    ExternalStorage,
    register_external_storage_scheme,
)


class MockS3Storage(ExternalStorage):
    def __init__(self, uri: str):
        parsed = urlparse(uri)
        self.root = parsed.path or parsed.netloc
        os.makedirs(os.path.join(self.root, "blobs"), exist_ok=True)
        self._manifest_path = os.path.join(self.root, "manifest.json")

    def _manifest(self):
        try:
            with open(self._manifest_path) as f:
                return json.load(f)
        except (FileNotFoundError, json.JSONDecodeError):
            return {}

    def _write_manifest(self, m):
        tmp = self._manifest_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(m, f)
        os.replace(tmp, self._manifest_path)

    def spill(self, key, local_path):
        with open(local_path, "rb") as f:
            blob = f.read()
        digest = hashlib.sha256(blob).hexdigest()
        with open(os.path.join(self.root, "blobs", digest), "wb") as f:
            f.write(blob)
        m = self._manifest()
        m[key] = digest
        self._write_manifest(m)

    def restore(self, key, local_path):
        digest = self._manifest().get(key)
        if digest is None:
            return False
        tmp = local_path + ".restoring"
        with open(os.path.join(self.root, "blobs", digest), "rb") as fi, \
                open(tmp, "wb") as fo:
            fo.write(fi.read())
        os.replace(tmp, local_path)
        return True

    def delete(self, key):
        m = self._manifest()
        digest = m.pop(key, None)
        if digest is not None:
            self._write_manifest(m)
            if digest not in m.values():
                try:
                    os.unlink(os.path.join(self.root, "blobs", digest))
                except FileNotFoundError:
                    pass

    def exists(self, key):
        return key in self._manifest()


register_external_storage_scheme(
    "mocks3", lambda uri: MockS3Storage(uri)
)
