"""Lazy nvcc build of the port's CUDA sources into a ctypes-loadable library.

Each source under ``ops/csrc/`` compiles on its own into
``build/ray_tpu_torch/<name>-<hash>.so`` at the repository root, at the first
launch of its kernel and never at import: the CPU-only test hosts import every
module and have no ``nvcc``. The file name carries a hash of the source, of
every ``*.cuh`` header it can include (those beside it and those in
``ops/csrc/``, both on nvcc's include path) and of the flags, so an edited
source or header rebuilds and an unchanged one loads the library already
built. Each build that runs nvcc is a compile event in the process's
step-telemetry ring (``steptrace.record_kernel_build``). A file lock per
source keeps concurrent processes from
building the same library twice while different sources build side by side;
the finished library is moved into place atomically.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import re
import subprocess
import time
from pathlib import Path
from typing import Dict, Tuple

from ray_tpu_torch._private import steptrace

BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "ray_tpu_torch"
CSRC = Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME): "
                           "cannot build the port's kernels")
    nvcc = Path(CUDA_HOME) / "bin" / "nvcc"
    if not nvcc.exists():
        raise RuntimeError(f"nvcc not found at {nvcc}")
    return str(nvcc)


def _include_dirs(source: Path) -> Tuple[Path, ...]:
    """Where ``source``'s quoted includes resolve: its own directory, then
    ``ops/csrc/`` (a variant copied elsewhere still finds the headers)."""
    return tuple(dict.fromkeys((source.resolve().parent, CSRC)))


def library_path(source: Path) -> Path:
    h = hashlib.sha256(source.read_bytes() + " ".join(NVCC_FLAGS).encode())
    for d in _include_dirs(source):
        for header in sorted(d.glob("*.cuh")):
            h.update(header.name.encode() + header.read_bytes())
    return BUILD_DIR / f"{source.stem}-{h.hexdigest()[:16]}.so"


def build(source: Path) -> Tuple[Path, float]:
    """Compile ``source`` unless its library exists; returns the library's
    path and the seconds spent compiling. Raises on any nvcc failure."""
    out = library_path(source)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / f".{source.stem}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():
            return out, 0.0
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        includes = [f"-I{d}" for d in _include_dirs(source)]
        cmd = [_nvcc(), *NVCC_FLAGS, *includes, "-o", str(tmp), str(source)]
        t0, wall0 = time.perf_counter(), time.time()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        steptrace.record_kernel_build(source.stem, wall0, time.time())
        out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed ({proc.returncode}) on {source}:\n"
                               f"{proc.stderr[-4000:]}")
        os.replace(tmp, out)
        return out, seconds


def ptxas_summary(library: Path) -> Dict[str, str]:
    """{kernel/type/D: "N registers, M bytes spilled"} from the
    ``-Xptxas -v`` log that ``build`` left beside ``library`` (empty when
    there is none); a kernel built with a live key length (the template
    flag after D set) is keyed kernel/type/D/k_len."""
    log = library.with_suffix(".log")
    if not log.exists():
        return {}
    out, name = {}, None
    for line in log.read_text().splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            t = re.search(r"(flash_[a-z_]+_kernel)I(\w+?)Li(\d+)E(Lb1E)?",
                          name)
            if t:
                name = (f"{t.group(1)}/{t.group(2).lstrip('0123456789_')}"
                        f"/{t.group(3)}" + ("/k_len" if t.group(4) else ""))
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and name:
            out[name] = f"{m.group(1)} bytes spilled"
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name] = f"{m.group(1)} registers, " + out.get(name, "")
    return out


def load(source: Path) -> ctypes.CDLL:
    """The built library for ``source``, building it on first use."""
    lib = _loaded.get(source.name)
    if lib is None:
        lib = _loaded[source.name] = ctypes.CDLL(str(build(source)[0]))
    return lib
