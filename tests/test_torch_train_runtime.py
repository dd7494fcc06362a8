"""The port's Train runtime on the CPU (``use_gpu=False``, gloo), beside the
reference's.

One port cluster and one reference cluster run for the whole module. The
cases of ``tests/test_train.py`` run through ``ray_tpu_torch.train``: a
worker group, reports from 2 workers (the same program through both
packages, reports held against each other), checkpoint and resume, a
failing loop, ``TorchTrainer`` over gloo at 2 workers, and the reference's
data-parallel sync loop through the store collective (numpy gradients; both
packages, the same losses). Then what the port adds: the GPU seam of
``ScalingConfig``, the "nccl" collective backend over the gang's process
group (gloo here) with no fallback, ``TorchConfig(backend="nccl")`` on a
worker without CUDA, ``use_gpu=True`` on a cluster without a GPU, and
``TorchTrainer.fit()`` training GPT-2
(``small_test``) data-parallel at 2 workers through ``shard_train_state``,
``shard_batch``, ``build_train_step(mesh=...)`` and a ``save_pytree``
checkpoint, against one process on the whole batch. Loops are defined
inside the tests so they travel to the port's workers by value.
"""

import importlib
import os

import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu_torch


@pytest.fixture(scope="module")
def clusters():
    ray_tpu_torch.init(num_cpus=4)
    ray_tpu.init(num_cpus=4)
    yield
    ray_tpu.shutdown()
    ray_tpu_torch.shutdown()


def _scaling(pkg, n):
    train = importlib.import_module(f"{pkg}.train")
    if pkg == "ray_tpu_torch":
        return train.ScalingConfig(num_workers=n, use_gpu=False)
    return train.ScalingConfig(num_workers=n)


def _run_config(pkg, name, tmp_path, **kw):
    train = importlib.import_module(f"{pkg}.train")
    return train.RunConfig(name=name, storage_path=str(tmp_path / pkg), **kw)


# ---------------------------------------------------------------------------
# the cases of tests/test_train.py
# ---------------------------------------------------------------------------

def test_worker_group_basic(clusters):
    from ray_tpu_torch.train import WorkerGroup

    wg = WorkerGroup(2, {"CPU": 1})
    outs = wg.execute(lambda: os.getpid())
    assert len(outs) == 2 and outs[0] != outs[1] and os.getpid() not in outs
    assert wg.local_ranks == [0, 1] and wg.node_ranks == [0, 0]
    wg.shutdown()


def test_data_parallel_trainer_reports_match_the_reference(clusters,
                                                           tmp_path):
    def make_loop(pkg):
        def loop(config):
            import importlib

            train = importlib.import_module(f"{pkg}.train")
            ctx = train.get_context()
            for step in range(3):
                train.report({
                    "step": step,
                    "rank": ctx.get_world_rank(),
                    "world_size": ctx.get_world_size(),
                    "local_rank": ctx.get_local_rank(),
                    "loss": 1.0 / (step + 1),
                })
        return loop

    results = {}
    for pkg in ("ray_tpu_torch", "ray_tpu"):
        train = importlib.import_module(f"{pkg}.train")
        trainer = train.DataParallelTrainer(
            make_loop(pkg), scaling_config=_scaling(pkg, 2),
            run_config=_run_config(pkg, "t_basic", tmp_path))
        results[pkg] = trainer.fit()
        assert results[pkg].error is None, results[pkg].error
    port, ref = results["ray_tpu_torch"].metrics, results["ray_tpu"].metrics
    assert port["step"] == 2 and port["world_size"] == 2 and port["rank"] == 0
    assert {k: port[k] for k in ("step", "rank", "world_size", "loss")} == \
        {k: ref[k] for k in ("step", "rank", "world_size", "loss")}
    assert port["local_rank"] == 0
    assert results["ray_tpu_torch"].path.startswith(str(tmp_path))


def test_trainer_checkpointing_and_resume(clusters, tmp_path):
    from ray_tpu_torch import train
    from ray_tpu_torch.air import Checkpoint

    def loop(config):
        from ray_tpu_torch import train
        from ray_tpu_torch.air import Checkpoint

        start = 0
        ck = train.get_checkpoint()
        if ck is not None:
            start = ck.to_dict()["step"] + 1
        for step in range(start, start + 2):
            train.report(
                {"step": step},
                checkpoint=Checkpoint.from_dict({"step": step}),
            )

    trainer = train.DataParallelTrainer(
        loop, scaling_config=_scaling("ray_tpu_torch", 1),
        run_config=_run_config("ray_tpu_torch", "t_ckpt", tmp_path))
    result = trainer.fit()
    assert result.metrics["step"] == 1
    assert isinstance(result.checkpoint, Checkpoint)
    assert result.checkpoint.to_dict() == {"step": 1}
    trainer2 = train.DataParallelTrainer(
        loop, scaling_config=_scaling("ray_tpu_torch", 1),
        run_config=_run_config("ray_tpu_torch", "t_ckpt2", tmp_path),
        resume_from_checkpoint=result.checkpoint)
    assert trainer2.fit().metrics["step"] == 3


def test_trainer_failure(clusters, tmp_path):
    from ray_tpu_torch import train

    def loop(config):
        raise ValueError("train loop exploded")

    result = train.DataParallelTrainer(
        loop, scaling_config=_scaling("ray_tpu_torch", 1),
        run_config=_run_config("ray_tpu_torch", "t_fail", tmp_path)).fit()
    assert result.error is not None
    assert "exploded" in str(result.error)


def test_torch_trainer_gloo(clusters, tmp_path):
    from ray_tpu_torch import train

    def loop(config):
        import os

        import torch
        import torch.distributed as dist

        rank = dist.get_rank()
        world = dist.get_world_size()
        t = torch.ones(4) * (rank + 1)
        dist.all_reduce(t, op=dist.ReduceOp.SUM)
        train.report({"sum": t.tolist(), "world": world,
                      "backend": dist.get_backend(),
                      "local_rank": os.environ["LOCAL_RANK"]})

    result = train.TorchTrainer(
        loop, scaling_config=_scaling("ray_tpu_torch", 2),
        run_config=_run_config("ray_tpu_torch", "t_torch", tmp_path)).fit()
    assert result.error is None, result.error
    assert result.metrics["sum"] == [3.0, 3.0, 3.0, 3.0]
    assert result.metrics["world"] == 2
    assert result.metrics["backend"] == "gloo"
    assert result.metrics["local_rank"] == "0"


def test_dp_sync_loop_through_the_store_collective(clusters, tmp_path):
    """The reference's data-parallel sync loop (tests/test_train.py's
    ``test_jax_trainer_dp_sync``) with numpy gradients, through both
    packages' store collective: the same losses at every step."""

    def make_loop(pkg):
        def loop(config):
            import importlib

            import numpy as np

            train = importlib.import_module(f"{pkg}.train")
            col = importlib.import_module(f"{pkg}.util.collective")
            ctx = train.get_context()
            rank, world = ctx.get_world_rank(), ctx.get_world_size()
            rng = np.random.default_rng(42 + rank)
            X = rng.normal(size=(32, 4)).astype(np.float32)
            y = X @ np.array([1.0, -2.0, 3.0, 0.5], dtype=np.float32)
            w = np.zeros(4, np.float32)
            col.init_collective_group(world, rank, backend="store",
                                      group_name="dp_test")
            for step in range(5):
                err = X @ w - y
                loss = float(np.mean(err ** 2))
                g = (2.0 / len(y)) * (X.T @ err)
                g = col.allreduce(g.astype(np.float32), "dp_test",
                                  op=col.ReduceOp.MEAN)
                w = w - 0.1 * g
                train.report({"step": step, "loss": loss, "rank": rank,
                              "w": w.tolist()})
        return loop

    metrics = {}
    for pkg in ("ray_tpu_torch", "ray_tpu"):
        train = importlib.import_module(f"{pkg}.train")
        result = train.DataParallelTrainer(
            make_loop(pkg), scaling_config=_scaling(pkg, 2),
            run_config=_run_config(pkg, "t_dp", tmp_path)).fit()
        assert result.error is None, result.error
        metrics[pkg] = result.metrics
    port, ref = metrics["ray_tpu_torch"], metrics["ray_tpu"]
    assert port["step"] == 4 and port["loss"] < 15.0
    np.testing.assert_allclose(port["w"], ref["w"], rtol=1e-6)
    assert port["loss"] == pytest.approx(ref["loss"], rel=1e-6)


# ---------------------------------------------------------------------------
# what the port adds
# ---------------------------------------------------------------------------

def test_scaling_config_leases_a_gpu_and_has_no_tpu_fields():
    from ray_tpu_torch import train

    assert train.ScalingConfig().worker_resources() == {"CPU": 1,
                                                        "GPU": 1}
    assert train.ScalingConfig(use_gpu=False).worker_resources() == \
        {"CPU": 1}
    assert train.ScalingConfig(num_workers=2).as_placement_group_bundles() \
        == [{"CPU": 1, "GPU": 1}] * 2
    for field in ("use_tpu", "chips_per_worker", "topology"):
        with pytest.raises(TypeError):
            train.ScalingConfig(**{field: 1})
    for name in ("JaxTrainer", "JaxConfig", "TensorflowTrainer",
                 "SklearnTrainer"):
        assert not hasattr(train, name)
    assert train.TorchConfig().backend is None  # nccl with a GPU, else gloo
    with pytest.raises(NotImplementedError, match="Tune"):
        train.TorchTrainer(lambda: None).as_trainable()


def test_nccl_collective_group_needs_a_process_group():
    from ray_tpu_torch.util import collective as col

    with pytest.raises(RuntimeError, match="process group"):
        col.init_collective_group(1, 0, group_name="no_pg")
    assert not col.is_group_initialized("no_pg")


def test_nccl_collective_backend_over_the_gang_process_group(clusters,
                                                             tmp_path):
    from ray_tpu_torch import train

    def loop(config):
        import numpy as np
        import torch

        from ray_tpu_torch import train
        from ray_tpu_torch.util import collective as col

        ctx = train.get_context()
        rank, world = ctx.get_world_rank(), ctx.get_world_size()
        col.init_collective_group(world, rank, group_name="g")  # "nccl"
        t = torch.arange(4, dtype=torch.float32) + rank
        same = col.allreduce(t, "g")
        arr = np.arange(4, dtype=np.float64) + rank
        mean = col.allreduce(arr, "g", op=col.ReduceOp.MEAN)
        gathered = col.allgather(torch.tensor([rank, 10 + rank]), "g")
        shard = col.reducescatter(torch.arange(4.0) * (rank + 1), "g")
        b = col.broadcast(torch.full((2,), float(rank)), 1, "g")
        col.barrier("g")
        train.report({"sum": t.tolist(), "in_place": same is t,
                      "mean": mean.tolist(), "numpy_in_place": mean is arr,
                      "gathered": [g.tolist() for g in gathered],
                      "shard": shard.tolist(), "bcast": b.tolist()})

    result = train.TorchTrainer(
        loop, scaling_config=_scaling("ray_tpu_torch", 2),
        run_config=_run_config("ray_tpu_torch", "t_nccl", tmp_path)).fit()
    assert result.error is None, result.error
    m = result.metrics  # rank 0's
    assert m["sum"] == [1.0, 3.0, 5.0, 7.0] and m["in_place"] is True
    assert m["mean"] == [0.5, 1.5, 2.5, 3.5] and m["numpy_in_place"] is True
    assert m["gathered"] == [[0, 10], [1, 11]]
    assert m["shard"] == [0.0, 3.0]
    assert m["bcast"] == [1.0, 1.0]


def test_torch_config_nccl_without_cuda_fails_the_run(clusters, tmp_path):
    from ray_tpu_torch import train

    result = train.TorchTrainer(
        lambda: None, torch_config=train.TorchConfig(backend="nccl"),
        scaling_config=_scaling("ray_tpu_torch", 1),
        run_config=_run_config("ray_tpu_torch", "t_nonccl", tmp_path)).fit()
    assert isinstance(result.error, train.TrainingFailedError)
    assert "no CUDA device" in str(result.error)


def test_use_gpu_without_a_gpu_is_infeasible_not_a_cpu_run(
        clusters, tmp_path, monkeypatch):
    """No fallback: the default ``use_gpu=True`` on a cluster with no GPU
    leaves the placement group infeasible and ``fit()`` returns the
    reference's ``TrainingFailedError`` (the executor's 120 s placement
    wait is cut to 2 s here)."""
    from ray_tpu_torch import train
    from ray_tpu_torch.util.placement_group import PlacementGroup

    wait = PlacementGroup.wait
    monkeypatch.setattr(PlacementGroup, "wait",
                        lambda self, timeout_seconds=30.0: wait(self, 2.0))
    result = train.TorchTrainer(
        lambda: None, scaling_config=train.ScalingConfig(num_workers=1),
        run_config=_run_config("ray_tpu_torch", "t_nogpu", tmp_path)).fit()
    assert isinstance(result.error, train.TrainingFailedError)
    assert "infeasible" in str(result.error) and "GPU" in str(result.error)


def test_torch_trainer_trains_gpt2_data_parallel(clusters, tmp_path):
    """The slice's entry point on the CPU: 2 workers over gloo train GPT-2
    (``small_test``, f32, the flash attention's plain version) with DDP;
    the reported global-mean losses equal one process's on the whole batch,
    and the checkpoint it writes resumes the run."""
    from ray_tpu_torch import train
    from ray_tpu_torch.air import Checkpoint
    from ray_tpu_torch.models import gpt2

    def loop(config):
        import os

        import torch

        from ray_tpu_torch import parallel, train
        from ray_tpu_torch.air import Checkpoint, load_pytree, save_pytree
        from ray_tpu_torch.models import gpt2

        ctx = train.get_context()
        mesh = parallel.create_mesh({"data": ctx.get_world_size()})
        cfg = gpt2.GPT2Config.small_test(dtype=torch.float32,
                                         attention="flash", loss_chunks=4)
        model, opt = gpt2.make_train_state(
            cfg, torch.Generator().manual_seed(0), device="cpu")
        model, opt = gpt2.shard_train_state(model, opt, mesh)
        start = 0
        ck = train.get_checkpoint()
        if ck is not None:
            with ck.as_directory() as d:
                load_pytree(d, model, "model")
                load_pytree(d, opt, "optimizer", model=model)
                start = int(open(os.path.join(d, "step")).read()) + 1
        step = gpt2.build_train_step(model, opt, mesh=mesh)
        batch = gpt2.shard_batch(
            gpt2.synthetic_batch(1, 8, 32, cfg.vocab_size, device="cpu"),
            mesh)
        losses = []
        for i in range(start, config["steps"]):
            with train.step_phase("compute"):
                model, opt, loss = step(model, opt, batch)
            ckpt = None
            if i == 0:
                d = os.path.join(ctx.get_trial_dir(), f"step_{i}")
                save_pytree(model, d, "model")
                save_pytree(opt, d, "optimizer", model=model)
                if ctx.get_world_rank() == 0:
                    with open(os.path.join(d, "step"), "w") as f:
                        f.write(str(i))
                ckpt = Checkpoint.from_directory(d)
            losses.append(float(loss))
            train.report({"step": i, "losses": losses}, checkpoint=ckpt)

    losses = {}
    first = None
    for name in ("t_gpt2", "t_gpt2_resume"):
        result = train.TorchTrainer(
            loop, train_loop_config={"steps": 3},
            scaling_config=_scaling("ray_tpu_torch", 2),
            run_config=_run_config("ray_tpu_torch", name, tmp_path),
            resume_from_checkpoint=first).fit()
        assert result.error is None, result.error
        losses[name] = result.metrics["losses"]
        if first is None:
            first = Checkpoint.from_directory(
                os.path.join(result.path, "step_0"))
    model, opt = gpt2.make_train_state(
        gpt2.GPT2Config.small_test(dtype=torch.float32, attention="flash",
                                   loss_chunks=4),
        torch.Generator().manual_seed(0), device="cpu")
    step = gpt2.build_train_step(model, opt)
    batch = gpt2.synthetic_batch(1, 8, 32, 512, device="cpu")
    want = [float(step(model, opt, batch)[2]) for _ in range(3)]
    np.testing.assert_allclose(losses["t_gpt2"], want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(losses["t_gpt2_resume"], want[1:], rtol=0,
                               atol=1e-5)
