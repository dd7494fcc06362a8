"""One build of a compiled artifact, shared by every process of a host.

The port builds two kinds of native code at first use, never at import: its
CUDA kernels with nvcc (``ops/_build.py``) and its runtime's C++ library
with g++ (``_private/native_store.py``). Both name the output after a hash
of its sources and flags under ``BUILD_DIR`` (``build/ray_tpu_torch/`` at
the repository root, listed in ``.gitignore``), and both build it here: a
file lock per stem keeps concurrent processes from building the same output
twice while different stems build side by side, and the finished file is
moved into place atomically. This module imports nothing heavy: every
runtime process loads the native library through it.
"""

from __future__ import annotations

import fcntl
import os
import subprocess
import time
from pathlib import Path
from typing import Callable, List

BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "ray_tpu_torch"


def compile_once(out: Path, stem: str,
                 command: Callable[[Path], List[str]]) -> float:
    """Build ``out`` unless it exists: under the lock ``.{stem}.lock`` beside
    it, run ``command(tmp)``, which must write ``tmp``, and move ``tmp`` to
    ``out``; the compiler's output stays beside ``out`` as ``.log``.
    Returns the seconds the compiler ran (0.0 when ``out`` was there).
    Raises with the compiler's stderr when it fails."""
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out.parent / f".{stem}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():
            return 0.0
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = command(tmp)
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"{Path(cmd[0]).name} failed "
                               f"({proc.returncode}) on {stem}:\n"
                               f"{proc.stderr[-4000:]}")
        os.replace(tmp, out)
        return seconds
