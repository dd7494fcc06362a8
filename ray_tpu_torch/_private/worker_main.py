"""Worker process entrypoint (analog of ray: python/ray/_private/workers/
default_worker.py): connect the core worker to the local raylet + GCS, attach
the task executor, and serve until told to exit."""

from __future__ import annotations

import atexit
import logging
import os
import signal
import sys
import threading


def _flush_observability(cw):
    """Best-effort drain of this worker's observability buffers: buffered
    task events go to the raylet and stdio flushes into the log file, so
    the last records of a dying task — exactly the ones a chaos lane
    wants — survive the process. Safe to call more than once."""
    try:
        cw.flush_task_events_sync()
    except Exception:
        pass
    try:
        sys.stdout.flush()
        sys.stderr.flush()
    except Exception:
        pass


def main():
    from ray_tpu_torch._private.profiling import maybe_profile

    maybe_profile("worker")
    logging.basicConfig(
        level=os.environ.get("RAY_TPU_TORCH_LOG_LEVEL", "INFO"),
        format=f"[worker pid={os.getpid()}] %(levelname)s %(name)s: %(message)s",
    )
    gcs_host, gcs_port = os.environ["RAY_TPU_TORCH_GCS_ADDR"].rsplit(":", 1)
    raylet_port = int(os.environ["RAY_TPU_TORCH_RAYLET_PORT"])

    from ray_tpu_torch._private.executor import TaskExecutor
    from ray_tpu_torch._private.worker import CoreWorker, global_worker

    cw = CoreWorker(
        raylet_host="127.0.0.1",
        raylet_port=raylet_port,
        gcs_host=gcs_host,
        gcs_port=int(gcs_port),
        is_driver=False,
    )
    # Exit flushing: a graceful kill (raylet stop/reclaim sends SIGTERM),
    # a normal interpreter exit, and a fatal error below all drain the
    # task-event buffer + stdio first. SIGKILL/segfaults are out of reach,
    # but the raylet's final log drain still recovers their stdio tail.
    atexit.register(_flush_observability, cw)

    def _on_sigterm(signum, frame):
        # Spot preemption drain: a train worker with an active session
        # checkpoints at its next step boundary and exits cleanly (the
        # executor requeues the gang WITHOUT spending failure budget).
        # A grace timer bounds how long we run past the signal; workers
        # with no training in flight keep the immediate-exit behavior.
        sess_mod = sys.modules.get("ray_tpu_torch.train.session")
        if sess_mod is not None:
            try:
                accepted = sess_mod.request_drain()
            except Exception:
                accepted = False
            if accepted:
                try:
                    from ray_tpu_torch._private.config import GLOBAL_CONFIG

                    grace = float(GLOBAL_CONFIG.train_drain_grace_s)
                except Exception:
                    grace = 30.0

                def _grace_exit():
                    _flush_observability(cw)
                    os._exit(0)

                t = threading.Timer(grace, _grace_exit)
                t.daemon = True
                t.start()
                return
        _flush_observability(cw)
        os._exit(0)

    try:
        signal.signal(signal.SIGTERM, _on_sigterm)
    except (ValueError, OSError):
        pass  # non-main thread / exotic platform: atexit still covers us

    # Materialize this worker's runtime env (working_dir/py_modules URIs)
    # BEFORE attaching the executor: the pool keys workers by env hash, so
    # every task routed here expects the env to be in place.
    import json

    renv = os.environ.get("RAY_TPU_TORCH_RUNTIME_ENV")
    if renv:
        from ray_tpu_torch._private.runtime_env import materialize

        materialize(cw, json.loads(renv))

    try:
        TaskExecutor(cw)
        global_worker.core_worker = cw
        global_worker.mode = "worker"

        # Exit when our raylet goes away (the raylet owns worker
        # lifetimes). Runs ON the io loop: only stdio can flush here —
        # the event buffer's target (the raylet) is gone anyway, and
        # flush_task_events_sync would deadlock the loop on itself.
        def _raylet_gone(_conn):
            try:
                sys.stdout.flush()
                sys.stderr.flush()
            except Exception:
                pass
            os._exit(0)

        cw.raylet.on_close = _raylet_gone
        threading.Event().wait()  # serve forever; raylet kills us on shutdown
    finally:
        # fatal path (executor attach/materialize blew up): the traceback
        # printed above must reach the log file before the process dies
        _flush_observability(cw)


if __name__ == "__main__":
    main()
