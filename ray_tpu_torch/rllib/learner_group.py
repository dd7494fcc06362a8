"""LearnerGroup: data-parallel learner actors with lockstep gradient sync.

Reference parity: ray rllib/core/learner/learner_group.py:61,131 — N
learner actors in a placement group; ``update()`` shards the train batch
equally, each actor computes gradients on its shard, gradients mean-
allreduce across the group (the reference wraps torch DDP; here the
collective lib's "store" group does it between the split grad/apply halves
of the step, as ONE flat vector: ``torch.cat`` of the ``.grad``s, on the
host), and every actor applies the identical averaged gradients, so
replicas never drift and no weight broadcast is needed.

Each learner actor leases ``{"GPU": num_gpus_per_learner}`` (fractions
allowed: two learners at 0.5 share one card) and builds its module on the
card; with ``num_gpus_per_learner=0`` it leases CPUs only, sees no card and
learns on the CPU. The sampling plane runs on CPUs either way.
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.rllib.env_runner import RUNNER_RUNTIME_ENV
from ray_tpu_torch.rllib.sample_batch import SampleBatch
from ray_tpu_torch.util.placement_group import placement_group


class _LearnerWorker:
    """Actor hosting one Learner replica (rank) of the group."""

    def __init__(self, learner_cls, module_blob: bytes, config_blob: bytes,
                 rank: int, world: int, group_name: str):
        import cloudpickle

        module_factory = cloudpickle.loads(module_blob)
        config = cloudpickle.loads(config_blob)
        self.module = module_factory()
        self.learner = learner_cls(self.module, config)
        self.rank = rank
        self.world = world
        self.group_name = group_name
        self._col_ready = False
        self._timings: List[Dict[str, float]] = []
        self._allreduce_s = 0.0

    def init_group(self):
        """Collective rendezvous — all ranks must call concurrently."""
        from ray_tpu_torch.util.collective import collective as col

        col.init_collective_group(
            self.world, self.rank, backend="store",
            group_name=self.group_name,
        )
        self._col_ready = True
        return self.rank

    def _allreduce_tree(self, grads):
        """Mean-allreduce a list of gradients as ONE flat vector (one
        collective round instead of one per tensor)."""
        import torch

        from ray_tpu_torch.util.collective import collective as col

        t0 = time.perf_counter()
        flat = torch.cat([g.reshape(-1) for g in grads]).cpu().numpy()
        out = torch.from_numpy(np.array(col.allreduce(
            flat, group_name=self.group_name, op="mean")))
        self._allreduce_s += time.perf_counter() - t0
        return [piece.view_as(g) for piece, g in
                zip(out.split([g.numel() for g in grads]), grads)]

    def update(self, shard: SampleBatch) -> Dict[str, float]:
        assert self._col_ready, "init_group must run before update"
        self._allreduce_s = 0.0
        t0 = time.perf_counter()
        if self.world == 1:
            out = self.learner.update(SampleBatch(shard))
        else:
            out = self.learner.update_ddp(
                SampleBatch(shard), self._allreduce_tree
            )
        self._timings.append({"update_s": time.perf_counter() - t0,
                              "allreduce_s": self._allreduce_s})
        return out

    def pop_timings(self) -> List[Dict[str, float]]:
        """Host seconds of each ``update`` since the last call, and of the
        allreduces inside it (the update's metrics end in a host read, so
        its seconds cover the device work)."""
        out, self._timings = self._timings, []
        return out

    def device_info(self) -> Dict:
        """Where this replica learns: its pid, its parameters' device and,
        on a card, the card's name and this process's peak memory."""
        import os

        import torch

        dev = self.learner.device
        return {"pid": os.getpid(), "device": str(dev),
                "device_name": (torch.cuda.get_device_name(dev)
                                if dev.type == "cuda" else None),
                "peak_memory_bytes": (torch.cuda.max_memory_allocated(dev)
                                      if dev.type == "cuda" else None)}

    # -- state (rank 0 is authoritative; replicas are identical) --------
    def get_weights(self):
        return self.learner.get_weights()

    def set_weights(self, weights):
        self.learner.set_weights(weights)
        return True

    def get_optimizer_state(self):
        return self.learner.get_optimizer_state()

    def set_optimizer_state(self, state):
        self.learner.set_optimizer_state(state)
        return True

    def ping(self):
        return True


class LearnerGroup:
    """Drop-in for a single Learner inside Algorithm: same update /
    get_weights / set_weights / optimizer-state surface, fan-out inside."""

    def __init__(self, learner_cls, module_factory, config,
                 num_learners: int, num_cpus_per_learner: float = 0.5,
                 num_gpus_per_learner: float = 1):
        import cloudpickle
        import uuid

        self.num_learners = num_learners
        self._group_name = f"learner_group_{uuid.uuid4().hex[:8]}"
        # one bundle per learner; PACK keeps the gang tight so the
        # gradient allreduce rides intra-host links where possible
        # (ray parity: learner_group.py PG with learner bundles)
        bundle = {"CPU": num_cpus_per_learner}
        if num_gpus_per_learner:
            bundle["GPU"] = num_gpus_per_learner
        self._pg = placement_group(
            [dict(bundle) for _ in range(num_learners)], strategy="PACK"
        )
        if not self._pg.wait(timeout_seconds=120):
            raise TimeoutError("learner placement group did not become ready")
        opts = dict(num_cpus=num_cpus_per_learner)
        if num_gpus_per_learner:
            # the actor itself claims the share of the card its bundle
            # reserved
            opts["num_gpus"] = num_gpus_per_learner
        else:
            # a learner on the CPU must not open a context on the card
            opts["runtime_env"] = RUNNER_RUNTIME_ENV
        worker_cls = ray_tpu_torch.remote(**opts)(_LearnerWorker)
        module_blob = cloudpickle.dumps(module_factory)
        config_blob = cloudpickle.dumps(config)
        self.workers = [
            worker_cls.options(
                placement_group=self._pg, placement_group_bundle_index=i
            ).remote(
                learner_cls, module_blob, config_blob,
                i, num_learners, self._group_name,
            )
            for i in range(num_learners)
        ]
        # rendezvous: all ranks must be in init_group at once
        ray_tpu_torch.get([w.init_group.remote() for w in self.workers],
                    timeout=120)

    def update(self, batch: SampleBatch) -> Dict[str, float]:
        shards = batch.shards(self.num_learners)
        metrics: List[Dict[str, float]] = ray_tpu_torch.get(
            [w.update.remote(s) for w, s in zip(self.workers, shards)],
            timeout=600,
        )
        # replicas applied identical grads; average the (near-identical)
        # shard metrics for reporting
        out: Dict[str, float] = {}
        for k in metrics[0]:
            out[k] = float(np.mean([m[k] for m in metrics]))
        return out

    def get_weights(self):
        return ray_tpu_torch.get(self.workers[0].get_weights.remote(), timeout=120)

    def set_weights(self, weights):
        ray_tpu_torch.get(
            [w.set_weights.remote(weights) for w in self.workers],
            timeout=120,
        )

    def get_optimizer_state(self):
        return ray_tpu_torch.get(
            self.workers[0].get_optimizer_state.remote(), timeout=120
        )

    def set_optimizer_state(self, state):
        ray_tpu_torch.get(
            [w.set_optimizer_state.remote(state) for w in self.workers],
            timeout=120,
        )

    def shutdown(self):
        for w in self.workers:
            try:
                ray_tpu_torch.kill(w)
            except Exception:
                pass
        try:
            from ray_tpu_torch.util.placement_group import remove_placement_group

            remove_placement_group(self._pg)
        except Exception:
            pass
