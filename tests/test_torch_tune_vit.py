"""The slice as a whole on the CPU: ``Tuner(TorchTrainer(...)).fit()`` runs
ASHA over the learning rate of ViT trials, held against the reference's
``Tuner(JaxTrainer(...))`` on the same weights, batch and grid.

Port side: ``ray_tpu_torch.tools.tune_runs.asha_tuner`` (the Tuner
``chip_smoke.py`` phase 21 runs at ViT-B/16's width) over ``small_test`` in
f32, ``use_gpu=False``, with the reference's seed-0 Flax weights carried
over by ``vision_params_from_jax``. Reference side: the same grid and ASHA
over ``ray_tpu.train.JaxTrainer`` running
``ray_tpu.models.vision.build_train_step``. One trial at a time on both, so
results reach ASHA in a fixed order. Then a port-only case: trials leasing a
quarter of the cluster's one GPU run four at a time (gloo process groups on
the CPU) and a fifth waits for a quarter to come back.
"""

import concurrent.futures
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu_torch
from ray_tpu.models import vision as jvision
from ray_tpu_torch.models import vision as tvision
from ray_tpu_torch.models.convert import vision_params_from_jax
from ray_tpu_torch.tools import tune_runs

LRS = (1e-3, 1e-2, 1e-4, 3e-3)
ASHA = dict(time_attr="training_iteration", max_t=4, grace_period=1,
            reduction_factor=2)
LOOP = dict(model="small_test", dtype="float32", weight_seed=0, batch_seed=1,
            batch=8, device="cpu")


@pytest.fixture(scope="module")
def clusters():
    ray_tpu_torch.init(num_cpus=8, num_gpus=1)
    ray_tpu.init(num_cpus=4)
    yield
    ray_tpu.shutdown()
    ray_tpu_torch.shutdown()


def _histories(pkg, experiment_dir):
    """lr -> the trial's losses in order, from the experiment's records."""
    import importlib

    analysis = importlib.import_module(f"{pkg}.tune.analysis")
    ea = analysis.ExperimentAnalysis(experiment_dir)
    configs = ea.get_all_configs()
    out = {}
    for trial in ea.trials:
        rows = [r for r in ea.trial_results(trial) if not r.get("done")]
        lr = configs[trial]["train_loop_config"]["lr"]
        out[lr] = [r["loss"] for r in sorted(
            rows, key=lambda r: r["training_iteration"])]
    return out


def _reference_tuner(batch_path, storage):
    from ray_tpu import train, tune
    from ray_tpu.tune.schedulers import ASHAScheduler

    def loop(config):
        import jax
        import jax.numpy as jnp
        import numpy as np

        from ray_tpu import train
        from ray_tpu.models import vision

        cfg = vision.ViTConfig.small_test(dtype=jnp.float32)
        model = vision.ViT(cfg)
        params, tx, opt_state = vision.make_train_state(
            model, cfg, jax.random.PRNGKey(0), config["lr"])
        step = vision.build_train_step(model, tx)
        data = np.load(config["batch_path"])
        batch = {"image": jnp.asarray(data["image"]),
                 "label": jnp.asarray(data["label"])}
        for i in range(config["steps"]):
            params, opt_state, loss = step(params, opt_state, batch)
            train.report({"loss": float(loss), "step": i})

    trainer = train.JaxTrainer(
        loop, train_loop_config={"steps": ASHA["max_t"],
                                 "batch_path": batch_path},
        jax_config=train.JaxConfig(env_vars={"JAX_PLATFORMS": "cpu"}),
        scaling_config=train.ScalingConfig(num_workers=1),
        run_config=train.RunConfig(name="tune_asha_vit",
                                   storage_path=storage))
    return tune.Tuner(
        trainer,
        param_space={"train_loop_config": {"lr": tune.grid_search(list(LRS))}},
        tune_config=tune.TuneConfig(metric="loss", mode="min",
                                    scheduler=ASHAScheduler(**ASHA),
                                    max_concurrent_trials=1))


def test_port_tuner_matches_the_reference_tuner(clusters, tmp_path):
    jcfg = jvision.ViTConfig.small_test(dtype=jnp.float32)
    jparams, _, _ = jvision.make_train_state(
        jvision.ViT(jcfg), jcfg, jax.random.PRNGKey(0), LRS[0])
    init = str(tmp_path / "init.pt")
    torch.save(vision_params_from_jax(jax.tree.map(np.asarray, jparams)),
               init)
    cfg = tvision.ViTConfig.small_test(dtype=torch.float32)
    batch = tvision.synthetic_image_batch(LOOP["batch_seed"], LOOP["batch"],
                                          cfg.image_size, cfg.num_classes,
                                          device="cpu")
    batch_path = str(tmp_path / "batch.npz")
    np.savez(batch_path,
             image=batch["image"].numpy().transpose(0, 2, 3, 1),
             label=batch["label"].numpy().astype(np.int32))

    tuner, asha = tune_runs.asha_tuner(
        LRS, dict(LOOP, init=init), max_t=ASHA["max_t"],
        grace_period=ASHA["grace_period"],
        reduction_factor=ASHA["reduction_factor"], max_concurrent_trials=1,
        use_gpu=False, storage_path=str(tmp_path / "port"))
    # the two clusters are independent: the reference's sweep runs on a
    # thread while the port's runs here
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ref = pool.submit(_reference_tuner(batch_path,
                                           str(tmp_path / "ref")).fit)
        port = tuner.fit()
        ref = ref.result()
    assert port.num_errors == 0 and ref.num_errors == 0
    assert len(port) == len(ref) == len(LRS)

    port_losses = _histories("ray_tpu_torch", port.experiment_path)
    ref_losses = _histories("ray_tpu", ref.experiment_path)
    # the same stops at the same iterations, and at least one early stop
    assert {lr: len(v) for lr, v in port_losses.items()} == \
        {lr: len(v) for lr, v in ref_losses.items()}
    assert min(len(v) for v in port_losses.values()) < ASHA["max_t"]
    for lr in LRS:
        np.testing.assert_allclose(port_losses[lr], ref_losses[lr],
                                   rtol=1e-4, err_msg=f"lr {lr}")
    best = lambda grid: grid.get_best_result().metrics["config"]
    assert best(port) == best(ref)
    assert tune_runs.stopped_early(asha)
    assert tune_runs.replay(asha.events, asha.trial_ids, metric="loss",
                            mode="min", **ASHA) == \
        [e[4] for e in asha.events if e[0] == "result"]
    # every report went through the plain attention: these are CPU tensors
    last = port.get_best_result().metrics
    assert last["plain_calls"] > 0
    assert last["launches"] == dict.fromkeys(tune_runs.KERNELS, 0)


def test_quarter_card_trials_run_four_at_a_time(clusters, tmp_path):
    """Each trial's worker leases {"CPU": 1, "GPU": 0.25} (gloo, on the
    CPU): four trials run at once, which their loops show by waiting at a
    barrier until all four have started, and the fifth starts only once a
    trial has ended and its quarter came back (through the gang's
    placement group, removed when the trial's actor dies)."""
    from ray_tpu_torch import train, tune

    barrier = str(tmp_path / "barrier")
    os.makedirs(barrier)

    def loop(config):
        import os
        import time

        from ray_tpu_torch.tools import tune_runs

        open(os.path.join(config["barrier"], str(config["lr"])), "w").close()
        deadline = time.time() + 120
        while len(os.listdir(config["barrier"])) < 4:
            if time.time() > deadline:
                raise RuntimeError("fewer than 4 trials ran at once")
            time.sleep(0.05)
        tune_runs.vit_trial_loop(config)

    asha = tune_runs.RecordingASHA(**ASHA)
    trainer = train.TorchTrainer(
        loop, train_loop_config=dict(LOOP, steps=ASHA["max_t"],
                                     barrier=barrier),
        torch_config=train.TorchConfig(backend="gloo"),
        scaling_config=train.ScalingConfig(
            num_workers=1, resources_per_worker={"CPU": 1, "GPU": 0.25}),
        run_config=train.RunConfig(storage_path=str(tmp_path / "runs")))
    lrs = LRS + (3e-4,)
    grid = tune.Tuner(
        trainer,
        param_space={"train_loop_config": {"lr": tune.grid_search(list(lrs))}},
        tune_config=tune.TuneConfig(metric="loss", mode="min",
                                    scheduler=asha,
                                    max_concurrent_trials=len(lrs)),
        run_config=train.RunConfig(storage_path=str(tmp_path / "tune")),
    ).fit()
    assert grid.num_errors == 0 and len(grid) == 5
    spans = sorted((r.metrics["loop_start"], r.metrics["reported_at"])
                   for r in grid)
    first, fifth = spans[:4], spans[4]
    assert max(s for s, _ in first) < min(e for _, e in first)
    assert fifth[0] >= min(e for _, e in first)
    assert tune_runs.replay(asha.events, asha.trial_ids, metric="loss",
                            mode="min", **ASHA) == \
        [e[4] for e in asha.events if e[0] == "result"]


# the first two losses a ``small_test`` trial reports at lr 1e-4, through
# ``tune_runs.vit_trial_loop`` on the CPU from the reference's seed-0 weights
_TRIAL_LOSSES = """
import sys

from ray_tpu_torch import train
from ray_tpu_torch.tools import tune_runs

seen = []
train.report = lambda metrics, **kw: seen.append(metrics)
tune_runs.vit_trial_loop(dict(tune_runs.LOOP, model="small_test",
                              dtype="float32", weight_seed=0, batch_seed=1,
                              batch=8, device="cpu", lr=1e-4, steps=2,
                              init=sys.argv[1]))
print(" ".join(m["loss"].hex() for m in seen))
"""


def test_trial_loop_losses_do_not_depend_on_the_cpu_thread_count(tmp_path):
    """A trial's worker computes on the CPU with however many intra-op
    threads its process starts with; at 7 the forward's sums split so that
    the first loss ends one ulp lower than at 8 (and 1-6). ASHA's first rung
    compares those first losses, which every trial shares, so the sweep
    held to the reference's above would stop its 1e-4 trial at iteration 1
    if one trial's worker started with another thread count. The loop
    computes with a fixed count on the CPU: the same bits at 7 and 8."""
    import subprocess
    import sys

    jcfg = jvision.ViTConfig.small_test(dtype=jnp.float32)
    jparams, _, _ = jvision.make_train_state(
        jvision.ViT(jcfg), jcfg, jax.random.PRNGKey(0), LRS[0])
    init = str(tmp_path / "init.pt")
    torch.save(vision_params_from_jax(jax.tree.map(np.asarray, jparams)),
               init)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    losses = {}
    for threads in ("7", "8"):
        env = dict(os.environ, OMP_NUM_THREADS=threads,
                   MKL_NUM_THREADS=threads, PYTHONPATH=repo)
        out = subprocess.run([sys.executable, "-c", _TRIAL_LOSSES, init],
                             env=env, cwd=repo, capture_output=True,
                             text=True, timeout=300)
        assert out.returncode == 0, out.stderr[-3000:]
        losses[threads] = out.stdout.split()
    assert len(losses["8"]) == 2
    assert losses["7"] == losses["8"], losses


def test_a_one_ulp_lower_first_loss_stops_the_1e4_trial_at_iteration_1():
    """The sweep above, replayed through a fresh ASHA from the first
    losses its trials report (every trial starts from the same weights, so
    at iteration 1 they tie): the 1e-4 trial continues past rung 1 and
    stops at 2, as the reference's does; with trial 0's first loss one ulp
    lower it stops at 1, the one iteration the port's sweep once
    recorded."""
    import math

    first = float.fromhex("0x1.a912040000000p+1")
    second = {"0": float.fromhex("0x1.7e72f60000000p+0"),
              "1": float.fromhex("0x1.0629540000000p+0"),
              "2": float.fromhex("0x1.89a6de0000000p+1")}

    def decisions(first_of_trial_0):
        events = []
        for trial, t1 in (("0", first_of_trial_0), ("1", first),
                          ("2", first)):
            events += [("result", trial, 1, t1), ("result", trial, 2,
                                                   second[trial])]
            if trial != "2":
                events += [("result", trial, 3, 0.5),
                           ("result", trial, 4, 0.25),
                           ("complete", trial, 4, 0.25)]
        got = tune_runs.replay(events, ["0", "1", "2"], metric="loss",
                               mode="min", **ASHA)
        results = [e for e in events if e[0] == "result"]
        return [(e[2], d) for e, d in zip(results, got) if e[1] == "2"]

    assert decisions(first) == [(1, "CONTINUE"), (2, "STOP")]
    assert decisions(math.nextafter(first, 0.0)) == [(1, "STOP"),
                                                      (2, "STOP")]
