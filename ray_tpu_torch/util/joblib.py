"""joblib backend: run sklearn/joblib parallel work on the cluster.

ray parity: python/ray/util/joblib/ray_backend.py — ``register_ray()``
then ``with joblib.parallel_backend("ray_tpu_torch"): ...`` routes joblib batches
through cluster tasks.
"""

from __future__ import annotations


def register_ray():
    """Register the "ray_tpu_torch" joblib parallel backend."""
    from joblib._parallel_backends import MultiprocessingBackend
    from joblib.parallel import register_parallel_backend

    class RayTpuTorchBackend(MultiprocessingBackend):
        """Batches execute as cluster tasks via our multiprocessing Pool."""

        supports_sharedmem = False

        def effective_n_jobs(self, n_jobs):
            import ray_tpu_torch

            if n_jobs == 1:
                return 1
            try:
                cpus = int(ray_tpu_torch.cluster_resources().get("CPU", 1))
            except Exception:
                cpus = 1
            if n_jobs is None or n_jobs == -1:
                return max(cpus, 1)
            if n_jobs < 0:  # joblib idiom: -2 means all-but-one, etc.
                return max(cpus + 1 + n_jobs, 1)
            return min(n_jobs, cpus)

        def configure(self, n_jobs=1, parallel=None, prefer=None,
                      require=None, **kwargs):
            from ray_tpu_torch.util.multiprocessing import Pool

            n_jobs = self.effective_n_jobs(n_jobs)
            self._pool = Pool(processes=n_jobs)
            self.parallel = parallel
            return n_jobs

        def terminate(self):
            if getattr(self, "_pool", None) is not None:
                self._pool.terminate()
                self._pool = None

        def _get_pool(self):
            return self._pool

    register_parallel_backend("ray_tpu_torch", RayTpuTorchBackend)
