"""Job submission: run a shell entrypoint on the cluster under a supervisor.

ray parity: dashboard/modules/job — JobManager (job_manager.py:516) spawns
a detached JobSupervisor actor (:140) per job that runs the entrypoint
command, tracks its status, and captures logs; the SDK
(JobSubmissionClient) submits/polls/stops over REST. Here there is no
dashboard process: the client connects as a driver, creates the detached
supervisor actor directly, and job status/logs live in the GCS KV, so any
client (and the CLI) can query them after the submitter disconnects.
"""

from __future__ import annotations

import time
import uuid
from typing import Dict, List, Optional

_KV_NS = b"job_submission"

# Job statuses (ray parity: job_submission JobStatus)
PENDING = "PENDING"
RUNNING = "RUNNING"
SUCCEEDED = "SUCCEEDED"
FAILED = "FAILED"
STOPPED = "STOPPED"


class JobSupervisorImpl:
    """Detached actor that owns one job's entrypoint subprocess.

    Runs the command in a background thread so status()/logs()/stop() stay
    responsive; publishes status + logs to the GCS KV on every transition
    (ray: JobSupervisor, job_manager.py:140).
    """

    # Seconds the supervisor lingers after a terminal status before exiting
    # (lets in-flight status/logs RPCs drain; state persists in the KV).
    EXIT_GRACE_S = 10.0

    def __init__(self, submission_id: str, entrypoint: str,
                 runtime_env: Optional[dict] = None,
                 metadata: Optional[dict] = None):
        import os
        import threading

        self.submission_id = submission_id
        self.entrypoint = entrypoint
        self.metadata = metadata or {}
        self._log_chunks: List[bytes] = []
        self._status = PENDING
        self._proc = None
        self._stop_requested = False
        self._lock = threading.Lock()
        env = dict(os.environ)
        for k, v in (runtime_env or {}).get("env_vars", {}).items():
            env[k] = str(v)
        cwd = (runtime_env or {}).get("working_dir") or None
        self._publish(with_logs=False)

        def run():
            import subprocess as sp

            with self._lock:
                if self._stop_requested:  # stopped while still PENDING
                    self._status = STOPPED
            if self._status == STOPPED:
                self._finish()
                return
            try:
                proc = sp.Popen(
                    entrypoint, shell=True, stdout=sp.PIPE, stderr=sp.STDOUT,
                    env=env, cwd=cwd,
                )
            except Exception as e:  # noqa: BLE001
                with self._lock:
                    self._status = FAILED
                    self._log_chunks.append(
                        f"failed to start: {e}\n".encode()
                    )
                self._finish()
                return
            with self._lock:
                self._proc = proc
                self._status = RUNNING
                if self._stop_requested:  # stop raced the launch
                    self._status = STOPPED
                    proc.terminate()
            self._publish(with_logs=False)
            for i, line in enumerate(proc.stdout):
                with self._lock:
                    self._log_chunks.append(line)
                    if len(self._log_chunks) > 10_000:
                        del self._log_chunks[:1000]
                if i and i % 200 == 0:
                    self._publish()  # periodic log persistence
            rc = proc.wait()
            with self._lock:
                if self._status != STOPPED:
                    self._status = SUCCEEDED if rc == 0 else FAILED
            self._finish()

        threading.Thread(target=run, daemon=True).start()

    def _finish(self):
        """Publish the terminal record, then exit this worker after a grace
        period — the reference's JobSupervisor exits when the entrypoint
        finishes; status/logs already persist in the KV."""
        import os
        import threading

        self._publish()

        def exit_later():
            time.sleep(self.EXIT_GRACE_S)
            os._exit(0)

        threading.Thread(target=exit_later, daemon=True).start()

    def _publish(self, with_logs: bool = True):
        """Write status (and optionally logs) to the GCS KV so they outlive
        this actor."""
        from ray_tpu_torch._private.worker import global_worker

        cw = global_worker.core_worker
        if cw is None:
            return
        with self._lock:
            info = {
                "submission_id": self.submission_id,
                "entrypoint": self.entrypoint,
                "status": self._status,
                "metadata": self.metadata,
                "ts": time.time(),
            }
            logs = b"".join(self._log_chunks) if with_logs else None
        try:
            import pickle

            cw.io.run(cw.gcs.request("kv_put", {
                "ns": _KV_NS,
                "key": f"info:{self.submission_id}".encode(),
                "value": pickle.dumps(info),
            }))
            if logs is not None:
                cw.io.run(cw.gcs.request("kv_put", {
                    "ns": _KV_NS,
                    "key": f"logs:{self.submission_id}".encode(),
                    "value": logs,
                }))
        except Exception:
            pass

    def status(self) -> str:
        self._publish(with_logs=False)
        return self._status

    def logs(self) -> bytes:
        with self._lock:
            return b"".join(self._log_chunks)

    def stop(self) -> bool:
        with self._lock:
            if self._status not in (PENDING, RUNNING):
                return False
            proc = self._proc
            self._stop_requested = True
            if proc is None:
                # Still PENDING: the run thread honors the flag before (or
                # right after) launching the entrypoint.
                return True
            self._status = STOPPED
        try:
            proc.terminate()
            try:
                proc.wait(timeout=5)
            except Exception:
                proc.kill()
        except Exception:
            pass
        self._publish()
        return True


class JobSubmissionClient:
    """Submit/inspect/stop jobs (ray parity: job_submission SDK client —
    the transport is the cluster connection instead of dashboard REST)."""

    def __init__(self, address: Optional[str] = None):
        import ray_tpu_torch

        if not ray_tpu_torch.is_initialized():
            ray_tpu_torch.init(address=address, namespace="_job_submission",
                         ignore_reinit_error=True)
        self._supervisors: Dict[str, object] = {}

    # -- helpers --------------------------------------------------------
    def _kv_get(self, key: str):
        from ray_tpu_torch._private.worker import global_worker

        cw = global_worker.core_worker
        return cw.io.run(cw.gcs.request(
            "kv_get", {"ns": _KV_NS, "key": key.encode()}
        ))

    def _kv_keys(self, prefix: str):
        from ray_tpu_torch._private.worker import global_worker

        cw = global_worker.core_worker
        return cw.io.run(cw.gcs.request(
            "kv_keys", {"ns": _KV_NS, "prefix": prefix.encode()}
        ))

    def _supervisor(self, submission_id: str):
        """(handle_or_None, definitely_dead). A name-lookup miss is
        authoritative (dead supervisors deregister their name); transient
        connection errors are NOT treated as death."""
        import ray_tpu_torch

        handle = self._supervisors.get(submission_id)
        if handle is not None:
            return handle, False
        try:
            handle = ray_tpu_torch.get_actor(
                f"_job_supervisor:{submission_id}",
                namespace="_job_submission",
            )
        except ValueError:
            return None, True
        except Exception:
            return None, False
        self._supervisors[submission_id] = handle
        return handle, False

    # -- API ------------------------------------------------------------
    def submit_job(self, *, entrypoint: str,
                   runtime_env: Optional[dict] = None,
                   metadata: Optional[dict] = None,
                   submission_id: Optional[str] = None) -> str:
        import ray_tpu_torch

        submission_id = submission_id or f"raysubmit_{uuid.uuid4().hex[:12]}"
        supervisor_cls = ray_tpu_torch.remote(num_cpus=0)(JobSupervisorImpl)
        handle = supervisor_cls.options(
            name=f"_job_supervisor:{submission_id}",
            namespace="_job_submission",
            lifetime="detached",
        ).remote(submission_id, entrypoint, runtime_env, metadata)
        self._supervisors[submission_id] = handle
        return submission_id

    def get_job_status(self, submission_id: str) -> str:
        import pickle

        import ray_tpu_torch

        handle, dead = self._supervisor(submission_id)
        if handle is not None:
            try:
                return ray_tpu_torch.get(handle.status.remote(), timeout=30)
            except Exception:
                # Stale handle (supervisor exited after finishing, or died):
                # re-resolve by name for the authoritative answer.
                self._supervisors.pop(submission_id, None)
                handle, dead = self._supervisor(submission_id)
                if handle is not None:
                    try:
                        return ray_tpu_torch.get(handle.status.remote(), timeout=30)
                    except Exception:
                        pass
        blob = self._kv_get(f"info:{submission_id}")
        if blob is None:
            raise ValueError(f"unknown job {submission_id!r}")
        info = pickle.loads(blob)
        status = info["status"]
        # A non-terminal KV record whose supervisor name no longer resolves
        # is a crashed job (dead supervisors deregister). Transient lookup
        # errors leave the recorded status untouched.
        if status in (PENDING, RUNNING) and dead:
            # The supervisor is unreachable but its last word was
            # non-terminal: the actor (or its node) died mid-job. Mark the
            # job failed so pollers terminate (ray: JobManager marks jobs
            # FAILED when the supervisor dies).
            info["status"] = status = FAILED
            info["message"] = "job supervisor died"
            from ray_tpu_torch._private.worker import global_worker

            cw = global_worker.core_worker
            try:
                cw.io.run(cw.gcs.request("kv_put", {
                    "ns": _KV_NS,
                    "key": f"info:{submission_id}".encode(),
                    "value": pickle.dumps(info),
                }))
            except Exception:
                pass
        return status

    def get_job_info(self, submission_id: str) -> dict:
        import pickle

        self.get_job_status(submission_id)  # refresh the KV record
        blob = self._kv_get(f"info:{submission_id}")
        if blob is None:
            raise ValueError(f"unknown job {submission_id!r}")
        return pickle.loads(blob)

    def get_job_logs(self, submission_id: str) -> str:
        import ray_tpu_torch

        handle, _ = self._supervisor(submission_id)
        if handle is not None:
            try:
                return ray_tpu_torch.get(
                    handle.logs.remote(), timeout=30
                ).decode(errors="replace")
            except Exception:
                pass
        blob = self._kv_get(f"logs:{submission_id}")
        return (blob or b"").decode(errors="replace")

    def stop_job(self, submission_id: str) -> bool:
        import ray_tpu_torch

        handle, _ = self._supervisor(submission_id)
        if handle is None:
            return False
        try:
            return ray_tpu_torch.get(handle.stop.remote(), timeout=30)
        except Exception:
            return False

    def list_jobs(self) -> List[dict]:
        import pickle

        out = []
        for key in self._kv_keys("info:"):
            blob = self._kv_get(key.decode())
            if blob:
                out.append(pickle.loads(blob))
        return sorted(out, key=lambda j: j.get("ts", 0))

    def wait_until_finished(self, submission_id: str,
                            timeout: float = 300.0) -> str:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            status = self.get_job_status(submission_id)
            if status in (SUCCEEDED, FAILED, STOPPED):
                return status
            time.sleep(0.5)
        raise TimeoutError(
            f"job {submission_id} not finished after {timeout}s"
        )
