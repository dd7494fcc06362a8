"""Public custom-datasource plugin surface.

Reference parity: ray python/ray/data/datasource/datasource.py (Datasource
+ ReadTask) and file_based_datasource.py:821 (FileBasedDatasource — the
partitioned-file base every file-format reader subclasses). Users plug a
new format into the streaming executor by subclassing one of these and
calling ``ray_tpu_torch.data.read_datasource(my_source)``.

Worked example — a length-prefixed record format::

    class RecordDatasource(FileBasedDatasource):
        _FILE_EXTENSIONS = ["rec"]

        def _read_file(self, f, path):
            rows = []
            while True:
                hdr = f.read(4)
                if not hdr:
                    break
                n = int.from_bytes(hdr, "little")
                rows.append({"payload": f.read(n), "path": path})
            return rows

    ds = ray_tpu_torch.data.read_datasource(
        RecordDatasource("/data/shards/"), parallelism=16
    )

Each read task materializes one group of files as a block; groups are
contiguous slices of the expanded (sorted) file list chunked over
``parallelism`` (one task per file when there are fewer files). Rows
within a file may differ in schema from other files — each file becomes
its own block and the concat promotes schemas.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

from ray_tpu_torch.data.block import _to_table, concat_blocks, rows_to_block
from ray_tpu_torch.data.datasource import _chunk, _expand_paths


class Datasource:
    """Base contract: produce the read tasks one dataset read executes.

    ``get_read_tasks(parallelism)`` returns a list of zero-argument
    callables; each returns a block (the port's ``Table``, a mapping of
    column name to array, a pyarrow Table, or a list of row dicts, which
    is converted with ``rows_to_block``). Tasks run inside
    the streaming executor with the same scheduling/backpressure as the
    built-in readers.
    """

    def get_read_tasks(self, parallelism: int) -> List[Callable[[], Any]]:
        raise NotImplementedError

    def get_name(self) -> str:
        return type(self).__name__


class FileBasedDatasource(Datasource):
    """Partitioned-file base (ray: file_based_datasource.py).

    Subclasses implement ONE of:

    - ``_read_file(f, path) -> rows/Block`` — called with an open binary
      file object per file (the common case);
    - ``_read_path(path) -> rows/Block`` — called with the path when the
      reader needs library-side opening (e.g. tarfile, pyarrow).

    ``_FILE_EXTENSIONS`` (optional) filters the expanded listing.
    """

    _FILE_EXTENSIONS: Optional[List[str]] = None

    def __init__(self, paths, **open_args):
        self._paths = paths
        self._open_args = open_args

    # -- subclass surface ----------------------------------------------
    def _read_file(self, f, path: str):
        raise NotImplementedError(
            f"{type(self).__name__} must implement _read_file or _read_path"
        )

    def _read_path(self, path: str):
        with open(path, "rb", **self._open_args) as f:
            return self._read_file(f, path)

    # -- Datasource ----------------------------------------------------
    def _expand(self) -> List[str]:
        files = _expand_paths(self._paths)
        exts = self._FILE_EXTENSIONS
        if exts:
            files = [
                p for p in files
                if any(p.endswith(f".{e.lstrip('.')}") for e in exts)
            ]
        if not files:
            raise FileNotFoundError(
                f"{self.get_name()}: no matching files under {self._paths!r}"
                + (f" (extensions {exts})" if exts else "")
            )
        return files

    def get_read_tasks(self, parallelism: int) -> List[Callable[[], Any]]:
        source = self

        def make(group: List[str]):
            def read():
                # one block PER FILE, then schema-promoting concat:
                # pooling rows across files would key columns off the
                # first row and silently drop fields later files add
                blocks: List[Any] = []
                for path in group:
                    out = source._read_path(path)
                    if isinstance(out, list):
                        if out:
                            blocks.append(rows_to_block(out))
                    else:
                        blocks.append(_to_table(out))
                return concat_blocks(blocks)

            return read

        return [make(g) for g in _chunk(self._expand(), parallelism)]


def read_datasource(datasource: Datasource, *, parallelism: int = -1,
                    **_kw):
    """Materialize a custom Datasource as a Dataset through the streaming
    executor (ray parity: read_api.read_datasource)."""
    from ray_tpu_torch.data.dataset import Dataset
    from ray_tpu_torch.data.read_api import _par

    p = _par(parallelism)
    return Dataset.from_read_tasks(datasource.get_read_tasks(p), p)
