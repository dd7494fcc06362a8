"""Env-gated cProfile for system processes.

Set ``RAY_TPU_TORCH_PROFILE_DIR=/some/dir`` before starting a cluster and every
system process (gcs, raylet, worker) profiles itself, dumping
``<role>-<pid>.pstats`` on exit — the offline analog of attaching py-spy
to the reference's C++ processes (which perf/gperftools would cover).
Zero overhead when the variable is unset.
"""

from __future__ import annotations

import atexit
import os


def enable_crash_diagnostics():
    """faulthandler for every system process: fatal signals print all
    thread stacks to stderr (→ the process's session log), and SIGUSR1
    dumps stacks WITHOUT dying — the attach-a-debugger analog for
    diagnosing a wedged gcs/raylet/worker in place (ray parity:
    `ray stack`, which py-spy-dumps live processes)."""
    import faulthandler
    import signal

    try:
        faulthandler.enable()
        faulthandler.register(signal.SIGUSR1, all_threads=True, chain=False)
        signal.signal(signal.SIGUSR2, _dump_asyncio_tasks)
    except Exception:
        pass  # non-main-thread import or exotic platform: diagnostics only


def all_asyncio_tasks() -> list:
    """Every live asyncio task across ALL loops/threads in this process.
    ``asyncio.all_tasks()`` needs a running loop on the calling thread;
    the interpreter-wide registry moved between versions: 3.12 keeps
    WeakSets in the C module (``_asyncio._scheduled_tasks`` /
    ``_eager_tasks``), older versions in ``asyncio.tasks._all_tasks``."""
    try:
        import _asyncio

        tasks = list(getattr(_asyncio, "_scheduled_tasks", ()))
        tasks += list(getattr(_asyncio, "_eager_tasks", ()))
        if tasks:
            return tasks
    except ImportError:
        pass
    import asyncio

    return list(getattr(asyncio.tasks, "_all_tasks", ()))


def _dump_asyncio_tasks(signum=None, frame=None):
    """SIGUSR2: print every pending asyncio task's coroutine stack to
    stderr. Thread dumps (SIGUSR1) show event loops idle in select() no
    matter what their TASKS are wedged on — this is the view that actually
    localizes a stuck handler. Uses the interpreter-wide task registry so
    loops on non-main threads (worker EventLoopThread) are included."""
    import sys
    import traceback

    print(f"=== asyncio task dump pid={os.getpid()} ===", file=sys.stderr)
    try:
        tasks = all_asyncio_tasks()
    except Exception as e:  # registry is private: degrade, don't die
        print(f"(task registry unavailable: {e!r})", file=sys.stderr)
        tasks = []
    for t in tasks:
        try:
            if t.done():
                continue
            print(f"--- {t!r} ---", file=sys.stderr)
            t.print_stack(file=sys.stderr)
        except Exception:
            traceback.print_exc()
    print("=== end asyncio task dump ===", file=sys.stderr)
    sys.stderr.flush()


def maybe_profile_thread(role: str, snapshot_interval_s: float = 5.0):
    """Profile THE CALLING THREAD if RAY_TPU_TORCH_PROFILE_DIR is set (cProfile
    instruments only the enabling thread). For loops hosted off-main —
    the driver's EventLoopThread — where ``maybe_profile`` on the main
    thread sees nothing but lock waits."""
    out_dir = os.environ.get("RAY_TPU_TORCH_PROFILE_DIR")
    if not out_dir:
        return
    import cProfile
    import threading
    import time

    prof = cProfile.Profile()
    try:
        prof.enable()
    except ValueError:
        # 3.12 profiles process-wide: a system process that already runs
        # maybe_profile() covers this thread — a second profiler would
        # raise and kill the enabling thread (observed: worker io loop)
        return
    path = os.path.join(out_dir, f"{role}-{os.getpid()}.pstats")

    def dump():
        try:
            os.makedirs(out_dir, exist_ok=True)
            prof.create_stats()
            prof.dump_stats(path)
        except Exception:
            pass
        finally:
            try:
                prof.enable()
            except Exception:
                pass

    def loop():
        while True:
            time.sleep(snapshot_interval_s)
            dump()

    threading.Thread(target=loop, name=f"profile-snap-{role}",
                     daemon=True).start()
    atexit.register(dump)


def maybe_profile(role: str, snapshot_interval_s: float = 5.0):
    """Enable process-wide profiling if RAY_TPU_TORCH_PROFILE_DIR is set.

    Stats snapshot to disk every few seconds (and at exit): system
    processes die by SIGTERM→os._exit, which skips atexit hooks."""
    enable_crash_diagnostics()
    out_dir = os.environ.get("RAY_TPU_TORCH_PROFILE_DIR")
    if not out_dir:
        return
    import cProfile
    import threading

    prof = cProfile.Profile()
    prof.enable()
    path = os.path.join(out_dir, f"{role}-{os.getpid()}.pstats")

    def dump():
        try:
            os.makedirs(out_dir, exist_ok=True)
            prof.create_stats()  # NB: internally disables the profiler
            prof.dump_stats(path)
        except Exception:
            pass
        finally:
            try:
                prof.enable()
            except Exception:
                pass

    def loop():
        import time

        while True:
            time.sleep(snapshot_interval_s)
            dump()

    threading.Thread(target=loop, name="profile-snap", daemon=True).start()
    atexit.register(dump)
