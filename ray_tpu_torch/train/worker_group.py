"""Train worker gang.

ray parity: python/ray/train/_internal/worker_group.py:100 (WorkerGroup of
RayTrainWorker actors) — a gang of actors, one per CUDA card (or per CPU
worker), created inside a placement group, each running the user train loop
on a session thread and draining a result queue. A worker's device is
``cuda:{local_rank}``, its rank among the gang's workers on its node: the
raylet does not narrow ``CUDA_VISIBLE_DEVICES`` by lease, so every worker
sees every card of its node.
"""

from __future__ import annotations

import threading
import traceback
from typing import Any, Callable, List, Optional

import ray_tpu_torch
from ray_tpu_torch.air.checkpoint import Checkpoint
from ray_tpu_torch.train import session as session_mod


@ray_tpu_torch.remote
class TrainWorker:
    """ray parity: worker_group.py:18 RayTrainWorker."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._session = None
        self._final: Optional[dict] = None

    def setup_session(self, rank: int, world_size: int, local_rank: int,
                      node_rank: int, experiment_name: str, trial_id: str,
                      trial_dir: str, checkpoint: Optional[Checkpoint],
                      local_world_size: int = 1):
        ctx = session_mod.TrainContext(
            rank=rank, world_size=world_size, local_rank=local_rank,
            local_world_size=local_world_size, node_rank=node_rank,
            experiment_name=experiment_name, trial_id=trial_id,
            trial_dir=trial_dir,
        )
        self._session = session_mod.init_session(ctx, checkpoint)
        return True

    def execute(self, fn: Callable, *args, **kwargs):
        """Run an arbitrary callable on the worker (backend setup hooks)."""
        return fn(*args, **kwargs)

    def _rt_init_collective(self, world_size, rank, backend, group_name,
                            epoch=0, quant=""):
        from ray_tpu_torch.util import collective as col

        col.init_collective_group(world_size, rank, backend, group_name,
                                  epoch=epoch, quant=quant)
        return rank

    def node_id(self) -> str:
        return ray_tpu_torch.get_runtime_context().get_node_id()

    def ping(self):
        """Liveness probe: a dead worker raises ActorDiedError at the
        caller; a live one answers immediately (the gang is created with
        max_concurrency>1 so this never queues behind next_result)."""
        return True

    def health(self):
        """Progress snapshot for the executor's per-step watchdog."""
        return session_mod.health()

    def request_drain(self):
        """Preemption notice: checkpoint at the next step boundary and
        exit cleanly (same path the worker's SIGTERM handler takes)."""
        return session_mod.request_drain()

    def start_training(self, train_fn: Callable, config: dict):
        assert self._session is not None, "setup_session must run first"
        sess = self._session
        shards = config.pop("__datasets__", None)
        if shards:
            rank = sess.ctx.get_world_rank()
            sess.dataset_shards = {
                name: splits[rank] for name, splits in shards.items()
            }

        def _run():
            try:
                import inspect

                sig = inspect.signature(train_fn)
                if len(sig.parameters) >= 1:
                    train_fn(config)
                else:
                    train_fn()
                sess.queue.put({"type": "done"})
            except SystemExit:
                sess.queue.put({"type": "done"})
            except BaseException as e:  # noqa: BLE001
                sess.queue.put({
                    "type": "error",
                    "error": f"{type(e).__name__}: {e}",
                    "traceback": traceback.format_exc(),
                })

        self._thread = threading.Thread(target=_run, name="train-loop", daemon=True)
        self._thread.start()
        return True

    def next_result(self, timeout: float = 300.0):
        """Block for the next report/done/error from the train loop. An
        empty poll piggybacks the session health snapshot so the
        executor's watchdog sees per-rank step progress without a second
        RPC round."""
        import queue as _q

        try:
            return self._session.queue.get(timeout=timeout)
        except _q.Empty:
            return {"type": "timeout", "health": session_mod.health()}

    def request_stop(self):
        if self._session:
            self._session.stop_requested.set()
        return True

    def shutdown_session(self):
        session_mod.shutdown_session()
        return True


class WorkerGroup:
    def __init__(self, num_workers: int, resources_per_worker: dict,
                 placement_group=None, runtime_env: Optional[dict] = None,
                 generation: int = 0):
        from ray_tpu_torch.util.scheduling_strategies import PlacementGroupSchedulingStrategy

        self.num_workers = num_workers
        self.resources_per_worker = dict(resources_per_worker)
        # gang generation: 0 on first placement, bumped by the executor on
        # each recovery re-placement; threaded into the collective group
        # epoch so the re-formed gang's rendezvous keys are fresh
        self.generation = generation
        self.workers: List = []
        for i in range(num_workers):
            # max_concurrency=4: liveness pings and health polls must
            # interleave with the long-blocking next_result call
            opts = dict(resources=dict(resources_per_worker), num_cpus=0,
                        max_concurrency=4)
            if placement_group is not None:
                opts["scheduling_strategy"] = PlacementGroupSchedulingStrategy(
                    placement_group, placement_group_bundle_index=i
                )
            if runtime_env:
                opts["runtime_env"] = runtime_env
            self.workers.append(TrainWorker.options(**opts).remote())
        # local rank = index among this gang's workers on the same node;
        # node rank = the node's index in order of first appearance
        nodes = ray_tpu_torch.get([w.node_id.remote() for w in self.workers],
                                  timeout=600)
        order = list(dict.fromkeys(nodes))
        self.node_ranks = [order.index(n) for n in nodes]
        self.local_ranks = [nodes[:i].count(n) for i, n in enumerate(nodes)]
        self.local_world_sizes = [nodes.count(n) for n in nodes]

    def execute(self, fn: Callable, *args, **kwargs) -> List[Any]:
        return ray_tpu_torch.get(
            [w.execute.remote(fn, *args, **kwargs) for w in self.workers],
            timeout=600,
        )

    def execute_single(self, index: int, fn: Callable, *args, **kwargs) -> Any:
        return ray_tpu_torch.get(
            self.workers[index].execute.remote(fn, *args, **kwargs), timeout=600
        )

    def execute_async(self, fn: Callable, *args, **kwargs):
        return [w.execute.remote(fn, *args, **kwargs) for w in self.workers]

    def shutdown(self):
        for w in self.workers:
            try:
                ray_tpu_torch.kill(w)
            except Exception:
                pass
        self.workers = []
