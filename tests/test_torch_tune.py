"""The port's Tune on the CPU, beside the reference's.

One port cluster (4 CPUs and one logical GPU) and one reference cluster (4
CPUs) run for the whole module. The cases of ``tests/test_tune.py``,
``test_experiment_analysis.py``, ``test_resource_changing.py`` and
``test_air_integrations.py`` run through ``ray_tpu_torch.tune``; where the
outcome is deterministic the same program also runs through ``ray_tpu.tune``
and the two are held to each other. Then what the port adds: its results
root, the resource keys of ``tune.run`` ("gpu" → "GPU", "tpu" raises),
fractional "GPU" bundles, and actors and placement groups that die with the
actor that created them. Trial functions are defined inside the tests so
they travel to the workers by value.
"""

import importlib
import os
import random
import sys
import time
import types
from unittest import mock

import pytest

import ray_tpu
import ray_tpu_torch


@pytest.fixture(scope="module")
def clusters():
    ray_tpu_torch.init(num_cpus=4, num_gpus=1)
    ray_tpu.init(num_cpus=4)
    yield
    ray_tpu.shutdown()
    ray_tpu_torch.shutdown()


def _wait_for_idle_cpus(timeout=30.0):
    """Cases that lease the whole cluster start once the actors an earlier
    case killed have given their CPUs back (the reference runs such cases
    on a cluster of their own)."""
    total = ray_tpu_torch.cluster_resources()["CPU"]
    deadline = time.time() + timeout
    while ray_tpu_torch.available_resources().get("CPU", 0) < total:
        assert time.time() < deadline, ray_tpu_torch.available_resources()
        time.sleep(0.1)


def _tune(pkg):
    return importlib.import_module(f"{pkg}.tune")


PKGS = ("ray_tpu_torch", "ray_tpu")


# ---------------------------------------------------------------------------
# the cases of tests/test_tune.py
# ---------------------------------------------------------------------------

def test_sample_domains():
    from ray_tpu_torch import tune

    assert 0.0 <= tune.uniform(0, 1).sample() <= 1.0
    assert 1 <= tune.loguniform(1, 100).sample() <= 100
    v = tune.quniform(0, 10, 0.5).sample()
    assert abs(v / 0.5 - round(v / 0.5)) < 1e-9
    assert tune.randint(3, 7).sample() in range(3, 7)
    assert tune.choice(["a", "b"]).sample() in ("a", "b")

    def draws(pkg):
        t = _tune(pkg)
        rng = random.Random(7)
        domains = [t.uniform(0, 1), t.loguniform(1e-5, 1e-1),
                   t.quniform(0, 10, 0.5), t.randint(3, 7),
                   t.lograndint(16, 1024), t.choice(["a", "b", "c"]),
                   t.randn(0.0, 2.0), t.qloguniform(1e-4, 1e-1, 1e-4)]
        return [d.sample(rng) for d in domains for _ in range(5)]

    assert draws("ray_tpu_torch") == draws("ray_tpu")


def test_variant_generation():
    from ray_tpu_torch import tune
    from ray_tpu_torch.tune.search.variant_generator import (
        count_variants,
        generate_variants,
    )

    space = {
        "a": tune.grid_search([1, 2, 3]),
        "b": tune.grid_search(["x", "y"]),
        "c": tune.uniform(0, 1),
    }
    assert count_variants(space) == 6
    variants = list(generate_variants(space))
    assert len(variants) == 6
    configs = [cfg for _, cfg in variants]
    assert {(c["a"], c["b"]) for c in configs} == {
        (a, b) for a in (1, 2, 3) for b in ("x", "y")
    }
    assert all(0 <= c["c"] <= 1 for c in configs)

    def variants_of(pkg):
        t = _tune(pkg)
        vg = importlib.import_module(f"{pkg}.tune.search.variant_generator")
        space = {"a": t.grid_search([1, 2, 3]), "b": t.grid_search(["x", "y"]),
                 "c": t.uniform(0, 1), "d": {"e": t.loguniform(1e-4, 1e-1)},
                 "f": t.sample_from(lambda spec: spec["a"] * 10)}
        return list(vg.generate_variants(space, rng=random.Random(3)))

    assert variants_of("ray_tpu_torch") == variants_of("ray_tpu")


def test_tuner_function_trainable(clusters):
    from ray_tpu_torch import tune

    def objective(config):
        score = (config["x"] - 3) ** 2
        tune.report({"score": score})

    tuner = tune.Tuner(
        objective,
        param_space={"x": tune.grid_search([0, 1, 2, 3, 4])},
        tune_config=tune.TuneConfig(metric="score", mode="min"),
    )
    grid = tuner.fit()
    assert len(grid) == 5
    assert grid.num_errors == 0
    best = grid.get_best_result()
    assert best.metrics["config"]["x"] == 3
    assert best.metrics["score"] == 0


def test_tuner_multiple_reports_and_stop(clusters):
    from ray_tpu_torch import tune

    def objective(config):
        for i in range(20):
            tune.report({"iter": i, "loss": 1.0 / (i + 1)})

    tuner = tune.Tuner(
        objective,
        param_space={"lr": tune.uniform(0.1, 1.0)},
        tune_config=tune.TuneConfig(num_samples=2, metric="loss", mode="min"),
        run_config=ray_tpu_torch.air.RunConfig(
            stop={"training_iteration": 5}),
    )
    grid = tuner.fit()
    assert len(grid) == 2
    for res in grid:
        assert res.metrics["training_iteration"] == 5


def test_tuner_class_trainable(clusters):
    from ray_tpu_torch import tune

    class MyTrainable(tune.Trainable):
        def setup(self, config):
            self.x = config["x"]
            self.acc = 0.0

        def step(self):
            self.acc += self.x
            return {"acc": self.acc, "done": self.acc >= 10 * self.x}

        def save_checkpoint(self, checkpoint_dir=None):
            return {"acc": self.acc}

        def load_checkpoint(self, state):
            self.acc = state["acc"]

    tuner = tune.Tuner(
        MyTrainable,
        param_space={"x": tune.grid_search([1.0, 2.0])},
        tune_config=tune.TuneConfig(metric="acc", mode="max"),
    )
    grid = tuner.fit()
    assert len(grid) == 2
    best = grid.get_best_result()
    assert best.metrics["acc"] == 20.0


def test_asha_stops_bad_trials(clusters):
    """The reference's case, then the same sweep one trial at a time (so
    results arrive in a fixed order) through both packages: the same
    iterations per trial."""
    from ray_tpu_torch import tune
    from ray_tpu_torch.tune.schedulers import ASHAScheduler

    def objective(config):
        for i in range(30):
            tune.report({"score": config["q"] * (i + 1)})

    tuner = tune.Tuner(
        objective,
        param_space={"q": tune.grid_search([0.1, 0.2, 1.0, 2.0])},
        tune_config=tune.TuneConfig(
            metric="score",
            mode="max",
            scheduler=ASHAScheduler(max_t=30, grace_period=2,
                                    reduction_factor=2),
        ),
    )
    grid = tuner.fit()
    iters = {
        r.metrics["config"]["q"]: r.metrics["training_iteration"] for r in grid
    }
    # The best trial survives the full budget.
    assert iters[2.0] == 30
    assert grid.get_best_result().metrics["config"]["q"] == 2.0

    def serial(pkg):
        t = _tune(pkg)
        sched = importlib.import_module(f"{pkg}.tune.schedulers")

        def objective(config):
            import importlib

            tune = importlib.import_module(f"{pkg}.tune")
            for i in range(30):
                tune.report({"score": config["q"] * (i + 1)})

        grid = t.Tuner(
            objective,
            param_space={"q": t.grid_search([2.0, 0.1, 1.0, 0.2])},
            tune_config=t.TuneConfig(
                metric="score", mode="max", max_concurrent_trials=1,
                scheduler=sched.ASHAScheduler(max_t=30, grace_period=2,
                                              reduction_factor=2)),
        ).fit()
        return {r.metrics["config"]["q"]: r.metrics["training_iteration"]
                for r in grid}

    port = serial("ray_tpu_torch")
    assert port == serial("ray_tpu")
    assert min(port.values()) < 30


def test_median_stopping(clusters):
    from ray_tpu_torch import tune
    from ray_tpu_torch.tune.schedulers import MedianStoppingRule

    def objective(config):
        for i in range(15):
            tune.report({"score": config["lvl"]})

    tuner = tune.Tuner(
        objective,
        param_space={"lvl": tune.grid_search([1.0, 1.0, 1.0, 0.0])},
        tune_config=tune.TuneConfig(
            metric="score",
            mode="max",
            scheduler=MedianStoppingRule(grace_period=3,
                                         min_samples_required=2),
            max_concurrent_trials=4,
        ),
    )
    grid = tuner.fit()
    assert len(grid) == 4


def test_pbt_exploits(clusters, tmp_path):
    """The reference's case with its race taken out: there the trials
    finish their 12 iterations in milliseconds and may never overlap, so
    no trial is ever in the bottom quantile while a top one exists. Here
    every trial waits at a barrier until all four have started and sleeps
    a little each iteration, so they overlap by construction."""
    from ray_tpu_torch import tune
    from ray_tpu_torch.tune.schedulers import PopulationBasedTraining

    barrier = str(tmp_path)

    def objective(config):
        import os
        import time

        from ray_tpu_torch import air, tune

        open(os.path.join(barrier, str(config["rate"])), "w").close()
        deadline = time.time() + 60
        while len(os.listdir(barrier)) < 4 and time.time() < deadline:
            time.sleep(0.02)
        score = tune.get_checkpoint()
        base = score.to_dict()["score"] if score else 0.0
        for i in range(12):
            time.sleep(0.05)
            base += config["rate"]
            tune.report(
                {"score": base},
                checkpoint=air.Checkpoint.from_dict({"score": base}),
            )

    pbt = PopulationBasedTraining(
        metric="score",
        mode="max",
        perturbation_interval=3,
        hyperparam_mutations={"rate": tune.uniform(0.5, 2.0)},
        seed=0,
    )
    tuner = tune.Tuner(
        objective,
        param_space={"rate": tune.grid_search([0.01, 0.02, 1.0, 1.5])},
        tune_config=tune.TuneConfig(
            scheduler=pbt, max_concurrent_trials=4, metric="score",
            mode="max"
        ),
        run_config=ray_tpu_torch.air.RunConfig(
            stop={"training_iteration": 12}),
    )
    grid = tuner.fit()
    assert pbt.num_perturbations > 0
    assert grid.get_best_result().metrics["score"] > 1.0


def test_with_resources_and_parameters(clusters):
    from ray_tpu_torch import tune

    big = list(range(1000))

    def objective(config, data=None):
        tune.report({"n": len(data) + config["x"]})

    wrapped = tune.with_resources(
        tune.with_parameters(objective, data=big), {"CPU": 1}
    )
    grid = tune.Tuner(
        wrapped,
        param_space={"x": tune.grid_search([1, 2])},
        tune_config=tune.TuneConfig(metric="n", mode="max"),
    ).fit()
    assert grid.get_best_result().metrics["n"] == 1002


def test_trial_failure_marks_error(clusters):
    from ray_tpu_torch import tune

    def objective(config):
        if config["x"] == 1:
            raise ValueError("boom")
        tune.report({"ok": 1})

    grid = tune.Tuner(
        objective,
        param_space={"x": tune.grid_search([0, 1])},
        tune_config=tune.TuneConfig(metric="ok", mode="max"),
    ).fit()
    assert grid.num_errors == 1
    assert grid.num_terminated == 1


def test_concurrency_limiter(clusters):
    from ray_tpu_torch import tune
    from ray_tpu_torch.tune.search import (
        BasicVariantGenerator,
        ConcurrencyLimiter,
    )

    searcher = ConcurrencyLimiter(BasicVariantGenerator(), max_concurrent=1)

    def objective(config):
        tune.report({"v": config["x"]})

    grid = tune.Tuner(
        objective,
        param_space={"x": tune.grid_search([1, 2, 3])},
        tune_config=tune.TuneConfig(
            search_alg=searcher, metric="v", mode="max"
        ),
    ).fit()
    assert len(grid) == 3


def test_tune_run_legacy_api(clusters):
    from ray_tpu_torch import tune

    def objective(config):
        tune.report({"m": config["x"] * 2})

    grid = tune.run(
        objective,
        config={"x": tune.grid_search([1, 2])},
        metric="m",
        mode="max",
        resources_per_trial={"cpu": 1},
    )
    assert grid.get_best_result().metrics["m"] == 4


def test_tuner_over_trainer(clusters, tmp_path):
    """Tuner(trainer) parity: sweep over train_loop_config, the same
    program through both packages, the same results."""

    def sweep(pkg):
        t = _tune(pkg)
        train = importlib.import_module(f"{pkg}.train")

        def loop(config):
            import importlib

            train = importlib.import_module(f"{pkg}.train")
            for i in range(3):
                train.report({"loss": config["lr"] * (3 - i)})

        kw = {"use_gpu": False} if pkg == "ray_tpu_torch" else {}
        trainer = train.DataParallelTrainer(
            loop,
            scaling_config=train.ScalingConfig(num_workers=1, **kw),
            run_config=train.RunConfig(storage_path=str(tmp_path / pkg)),
        )
        grid = t.Tuner(
            trainer,
            param_space={
                "train_loop_config": {"lr": t.grid_search([0.1, 0.01])}
            },
            tune_config=t.TuneConfig(metric="loss", mode="min"),
        ).fit()
        assert len(grid) == 2
        assert grid.num_errors == 0
        return sorted((r.metrics["config"]["train_loop_config"]["lr"],
                       r.metrics["loss"], r.metrics["training_iteration"])
                      for r in grid), grid.get_best_result().metrics["loss"]

    port = sweep("ray_tpu_torch")
    assert abs(port[1] - 0.01) < 1e-9
    assert port == sweep("ray_tpu")


def test_tuner_over_trainer_full_cluster(clusters):
    """Train workers may claim the ENTIRE cluster: the trial actor must not
    double-count worker bundles or the workers can never schedule
    (regression: trial claimed a worker bundle on top of the executor's)."""
    from ray_tpu_torch import train, tune

    def loop(config):
        from ray_tpu_torch import train

        train.report({"ok": 1.0})

    _wait_for_idle_cpus()
    trainer = train.DataParallelTrainer(
        loop,
        # 4 workers x 1 CPU == the whole cluster's CPUs.
        scaling_config=train.ScalingConfig(num_workers=4, use_gpu=False),
    )
    grid = tune.Tuner(trainer).fit()
    assert len(grid) == 1
    assert grid.num_errors == 0


def test_function_trainable_without_checkpoint_has_none(clusters):
    """A trial that never reports a checkpoint must yield Result.checkpoint
    None even when checkpoint_at_end forces a save (regression: wrapper dict
    leaked through as a truthy empty Checkpoint)."""
    from ray_tpu_torch import air, tune

    def loop(config):
        tune.report({"x": 1.0})

    grid = tune.Tuner(
        loop,
        run_config=air.RunConfig(
            checkpoint_config=air.CheckpointConfig(checkpoint_at_end=True)
        ),
    ).fit()
    assert grid.num_errors == 0
    assert grid[0].checkpoint is None


def test_experiment_snapshot_and_restore(clusters, tmp_path):
    """Kill an experiment mid-flight, Tuner.restore, finish with trial
    checkpoints intact (ray parity: tune/execution/experiment_state.py)."""
    from ray_tpu_torch import tune
    from ray_tpu_torch.air.config import CheckpointConfig, RunConfig
    from ray_tpu_torch.tune.execution.tune_controller import TuneController
    from ray_tpu_torch.tune.logger import DEFAULT_CALLBACKS

    class Slow(tune.Trainable):
        def setup(self, config):
            self.x = config["x"]
            self.it = 0

        def step(self):
            self.it += 1
            return {"score": self.x * self.it, "done": self.it >= 6}

        def save_checkpoint(self, checkpoint_dir=None):
            return {"it": self.it}

        def load_checkpoint(self, state):
            self.it = state["it"]

    exp_dir = str(tmp_path / "exp")
    controller = TuneController(
        Slow,
        {"x": tune.grid_search([1.0, 2.0, 3.0, 4.0])},
        metric="score",
        mode="max",
        run_config=RunConfig(
            checkpoint_config=CheckpointConfig(checkpoint_frequency=1)
        ),
        callbacks=[cls() for cls in DEFAULT_CALLBACKS],
        experiment_dir=exp_dir,
        max_concurrent_trials=2,
    )
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline:
        controller.step()
        if any(
            t.checkpoint is not None and not t.is_finished()
            for t in controller.trials
        ):
            break
    assert not controller.is_finished(), "interrupted too late to be useful"
    controller.save_experiment_state()
    progressed = {
        t.trial_id: t.checkpoint["state"]["it"]
        for t in controller.trials
        if t.checkpoint is not None
    }
    assert progressed, "no trial checkpointed before the interrupt"
    controller.cleanup()  # the "kill": actors die, state file remains

    assert tune.Tuner.can_restore(exp_dir)
    tuner = tune.Tuner.restore(exp_dir, Slow)
    grid = tuner.fit()
    assert len(grid) == 4
    assert grid.num_errors == 0
    scores = sorted(r.metrics["score"] for r in grid)
    assert scores == [6.0, 12.0, 18.0, 24.0]


# ---------------------------------------------------------------------------
# the cases of tests/test_experiment_analysis.py
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def finished_experiment(clusters, tmp_path_factory):
    from ray_tpu_torch import tune

    def objective(config):
        for i in range(5):
            tune.report({"score": config["rate"] * (i + 1)})

    grid = tune.Tuner(
        objective,
        param_space={"rate": tune.grid_search([1.0, 3.0, 2.0])},
        tune_config=tune.TuneConfig(metric="score", mode="max"),
        run_config=ray_tpu_torch.air.RunConfig(
            storage_path=str(tmp_path_factory.mktemp("analysis"))),
    ).fit()
    return grid.experiment_path


def test_offline_best_queries(finished_experiment):
    """The port's experiment directory read by the port's analysis, and by
    the reference's: the same answers."""
    answers = {}
    for pkg in PKGS:
        analysis = importlib.import_module(f"{pkg}.tune.analysis")
        ea = analysis.ExperimentAnalysis(finished_experiment)
        assert ea.default_metric == "score" and ea.default_mode == "max"
        assert len(ea.trials) == 3
        best = ea.best_result()
        assert best["score"] == pytest.approx(15.0)  # rate 3.0 * 5 steps
        assert ea.best_config()["rate"] == 3.0
        worst_cfg = ea.best_config(metric="score", mode="min")
        assert worst_cfg["rate"] == 1.0
        answers[pkg] = (sorted(ea.trials), ea.best_config(),
                        ea.best_result()["score"], worst_cfg)
    assert answers["ray_tpu_torch"] == answers["ray_tpu"]


def test_dataframes(finished_experiment):
    from ray_tpu_torch.tune.analysis import ExperimentAnalysis

    ea = ExperimentAnalysis(finished_experiment)
    df = ea.dataframe()
    assert len(df) == 3
    assert set(df["config/rate"]) == {1.0, 2.0, 3.0}
    assert df["score"].max() == pytest.approx(15.0)
    per_trial = ea.trial_dataframes()
    # 5 reports + the terminal duplicate-result line
    assert all(len(v) in (5, 6) for v in per_trial.values())


def test_missing_dir_and_empty_dir(tmp_path):
    from ray_tpu_torch.tune.analysis import ExperimentAnalysis

    with pytest.raises(FileNotFoundError):
        ExperimentAnalysis(str(tmp_path / "nope"))
    with pytest.raises(ValueError, match="result.json"):
        ExperimentAnalysis(str(tmp_path))


# ---------------------------------------------------------------------------
# the cases of tests/test_resource_changing.py
# ---------------------------------------------------------------------------

class _RTrial:
    def __init__(self, tid):
        self.trial_id = tid
        self.resources = {"CPU": 1.0}
        self.status = "RUNNING"


def test_reallocation_unit():
    """Direct scheduler-interface drive: after the interval, the policy's
    allocation is applied through controller.change_trial_resources; the
    reference's scheduler makes the same calls."""

    class _Controller:
        def __init__(self, trials):
            self.trials = trials
            self.changes = []

        def change_trial_resources(self, trial, resources):
            self.changes.append((trial.trial_id, dict(resources)))
            trial.resources = dict(resources)
            return True

    def drive(pkg):
        rc = importlib.import_module(f"{pkg}.tune.schedulers.resource_changing")
        ts = importlib.import_module(f"{pkg}.tune.schedulers.trial_scheduler")
        t = _RTrial("a")
        ctl = _Controller([t])

        def alloc(controller, trial, base):
            return {"CPU": 3.0}

        sched = rc.ResourceChangingScheduler(
            resources_allocation_function=alloc, reallocate_interval=2,
            metric="m", mode="max",
        )
        sched.on_trial_add(ctl, t)
        decisions = [sched.on_trial_result(ctl, t, {"m": 1})]
        assert decisions[0] == ts.TrialScheduler.CONTINUE
        assert not ctl.changes  # below the interval
        decisions.append(sched.on_trial_result(ctl, t, {"m": 2}))
        assert ctl.changes == [("a", {"CPU": 3.0})]
        assert sched.num_resource_changes == 1
        # no further change while the allocation is already in effect
        decisions.append(sched.on_trial_result(ctl, t, {"m": 3}))
        decisions.append(sched.on_trial_result(ctl, t, {"m": 4}))
        assert sched.num_resource_changes == 1
        return decisions, ctl.changes

    assert drive("ray_tpu_torch") == drive("ray_tpu")


def test_distribute_resources_floor(clusters):
    """2 live trials over a 4-CPU cluster -> 2 CPUs each (floor 1); a
    single survivor absorbs the whole cluster. Each package reads its own
    cluster of 4 CPUs."""

    class _Controller:
        def __init__(self, trials):
            self.trials = trials

    for pkg in PKGS:
        rc = importlib.import_module(f"{pkg}.tune.schedulers.resource_changing")
        a, b = _RTrial("a"), _RTrial("b")
        out = rc.DistributeResources()(_Controller([a, b]), a, {"CPU": 1.0})
        assert out == {"CPU": 2.0}
        out = rc.DistributeResources()(_Controller([a]), a, {"CPU": 1.0})
        assert out == {"CPU": 4.0}


def test_e2e_survivor_absorbs_capacity(clusters):
    """Two trials on a 4-CPU cluster: once the short trial finishes, the
    survivor's next reallocation bumps it past its base request, and the
    trial keeps training through the checkpoint/restart."""
    from ray_tpu_torch import tune
    from ray_tpu_torch.tune.schedulers.resource_changing import (
        ResourceChangingScheduler,
    )

    def objective(config):
        from ray_tpu_torch import air, tune

        ck = tune.get_checkpoint()
        start = ck.to_dict()["i"] if ck else 0
        for i in range(start, config["steps"]):
            tune.report(
                {"step": i + 1},
                checkpoint=air.Checkpoint.from_dict({"i": i + 1}),
            )

    _wait_for_idle_cpus()
    sched = ResourceChangingScheduler(
        reallocate_interval=3, metric="step", mode="max",
    )
    grid = tune.Tuner(
        objective,
        param_space={"steps": tune.grid_search([3, 25])},
        tune_config=tune.TuneConfig(
            scheduler=sched, metric="step", mode="max",
            max_concurrent_trials=2,
        ),
    ).fit()
    assert all(r.error is None for r in grid)
    assert sorted(r.metrics["step"] for r in grid) == [3, 25]
    assert sched.num_resource_changes >= 1


# ---------------------------------------------------------------------------
# the cases of tests/test_air_integrations.py (stub client libraries)
# ---------------------------------------------------------------------------

class _ITrial:
    def __init__(self, tid="t1", config=None):
        self.trial_id = tid
        self.config = config or {"lr": 0.1}

    def __str__(self):
        return f"trial_{self.trial_id}"


def _stub_mlflow():
    mlflow = types.ModuleType("mlflow")
    tracking = types.ModuleType("mlflow.tracking")
    client = mock.MagicMock()
    client.get_experiment_by_name.return_value = None
    client.create_experiment.return_value = "exp1"
    run = mock.MagicMock()
    run.info.run_id = "run1"
    client.create_run.return_value = run

    class MlflowClient:
        def __new__(cls, *a, **k):
            return client

    tracking.MlflowClient = MlflowClient
    mlflow.set_tracking_uri = mock.MagicMock()
    mlflow.tracking = tracking
    return mlflow, tracking, client


def test_mlflow_callback_lifecycle(monkeypatch):
    mlflow, tracking, client = _stub_mlflow()
    monkeypatch.setitem(sys.modules, "mlflow", mlflow)
    monkeypatch.setitem(sys.modules, "mlflow.tracking", tracking)
    from ray_tpu_torch.air.integrations import MLflowLoggerCallback

    cb = MLflowLoggerCallback(experiment_name="e2e")
    trial = _ITrial()
    cb.on_trial_start(trial)
    client.create_run.assert_called_once()
    client.log_param.assert_any_call("run1", "lr", 0.1)
    cb.on_trial_result(trial, {"score": 1.5, "training_iteration": 3,
                               "note": "text-skipped"})
    client.log_metric.assert_any_call("run1", "score", 1.5, step=3)
    # non-numeric values never reach the tracker
    for call in client.log_metric.call_args_list:
        assert call.args[1] != "note"
    cb.on_trial_complete(trial)
    client.set_terminated.assert_called_once_with("run1", status="FINISHED")


def test_mlflow_missing_library_fails_at_construction(monkeypatch):
    monkeypatch.setitem(sys.modules, "mlflow", None)
    from ray_tpu_torch.air.integrations import MLflowLoggerCallback

    with pytest.raises(ImportError):
        MLflowLoggerCallback()


def test_wandb_callback_lifecycle(monkeypatch):
    wandb = types.ModuleType("wandb")
    run = mock.MagicMock()
    wandb.init = mock.MagicMock(return_value=run)
    monkeypatch.setitem(sys.modules, "wandb", wandb)
    from ray_tpu_torch.air.integrations import WandbLoggerCallback

    cb = WandbLoggerCallback(project="p")
    trial = _ITrial()
    cb.on_trial_start(trial)
    wandb.init.assert_called_once()
    cb.on_trial_result(trial, {"score": 2.0})
    run.log.assert_called_once_with({"score": 2.0})
    cb.on_trial_error(trial)
    run.finish.assert_called_once_with(exit_code=1)


# ---------------------------------------------------------------------------
# what the port adds
# ---------------------------------------------------------------------------

def test_results_root_is_the_ports(monkeypatch, tmp_path):
    """Without a storage path an experiment lands under
    ``~/ray_tpu_torch_results``, the root of the port's trainers, not the
    reference's ``~/ray_tpu_results``."""
    from ray_tpu_torch.tune.execution.tune_controller import TuneController

    monkeypatch.setenv("HOME", str(tmp_path))

    def objective(config):
        pass

    ctl = TuneController(objective, {}, max_concurrent_trials=1)
    assert ctl.experiment_dir.startswith(
        str(tmp_path / "ray_tpu_torch_results") + os.sep)
    assert os.path.isdir(ctl.experiment_dir)


@pytest.mark.parametrize("key", ["tpu", "TPU"])
def test_tune_run_refuses_tpus(key):
    """No node of the port advertises "TPU": a trial asking for one would
    stay pending for ever, so ``tune.run`` raises before any trial starts
    (no cluster needed)."""
    from ray_tpu_torch import tune

    def objective(config):
        tune.report({"m": 1})

    with pytest.raises(ValueError, match="GPU"):
        tune.run(objective, resources_per_trial={"cpu": 1, key: 1})


def test_tune_run_maps_gpu_to_the_gpu_resource(clusters):
    """``resources_per_trial={"gpu": 0.5}`` leases half of the cluster's
    one "GPU": the trial sees {"CPU": 1.0, "GPU": 0.5} and two trials fit
    the card at once."""
    from ray_tpu_torch import tune

    def objective(config):
        from ray_tpu_torch import tune

        tune.report({"res": tune.get_trial_resources()})

    grid = tune.run(objective, config={"x": tune.grid_search([1, 2])},
                    metric="x", mode="max",
                    resources_per_trial={"cpu": 1, "gpu": 0.5})
    assert grid.num_errors == 0
    assert [r.metrics["res"] for r in grid] == [{"CPU": 1, "GPU": 0.5}] * 2


def test_fractional_gpu_bundles_pack_four_to_a_card(clusters):
    """A quarter-card bundle is a real lease: four placement groups of
    {"CPU": 0.5, "GPU": 0.25} are ready on the cluster's one GPU, a fifth
    stays pending until one is removed."""
    from ray_tpu_torch.util.placement_group import (
        placement_group,
        remove_placement_group,
    )

    pgs = [placement_group([{"CPU": 0.5, "GPU": 0.25}]) for _ in range(4)]
    try:
        assert all(pg.wait(30) for pg in pgs)
        fifth = placement_group([{"CPU": 0.5, "GPU": 0.25}])
        pgs.append(fifth)
        assert not fifth.wait(2)
        remove_placement_group(pgs.pop(0))
        assert fifth.wait(30)
    finally:
        for pg in pgs:
            remove_placement_group(pg)


def test_actors_and_groups_die_with_the_actor_that_made_them(clusters):
    """Fate sharing: an actor's non-detached child actors and placement
    groups die with it, so a Tune trial killed by its scheduler returns
    its train gang's resources (the reference leaves the gang and its
    group leased to an orphan)."""
    from ray_tpu_torch.util.placement_group import (
        PlacementGroup,
        placement_group_table,
    )

    @ray_tpu_torch.remote(num_cpus=0)
    class Child:
        def pid(self):
            return os.getpid()

    @ray_tpu_torch.remote(num_cpus=0)
    class Parent:
        def spawn(self):
            from ray_tpu_torch.util.placement_group import placement_group

            self.pg = placement_group([{"CPU": 1, "GPU": 0.5}])
            assert self.pg.wait(30)
            self.child = Child.remote()
            self.detached = Child.options(
                name="tune_fate_detached", lifetime="detached").remote()
            return (self.pg.id_hex,
                    ray_tpu_torch.get(self.child.pid.remote(), timeout=30),
                    ray_tpu_torch.get(self.detached.pid.remote(),
                                      timeout=30))

    parent = Parent.remote()
    pg_id, child_pid, detached_pid = ray_tpu_torch.get(
        parent.spawn.remote(), timeout=60)
    ray_tpu_torch.kill(parent)
    deadline = time.time() + 30
    while time.time() < deadline:
        state = placement_group_table(PlacementGroup(pg_id, []))["state"]
        if state == "REMOVED" and not _alive(child_pid):
            break
        time.sleep(0.1)
    assert state == "REMOVED"
    assert not _alive(child_pid)
    detached = ray_tpu_torch.get_actor("tune_fate_detached")
    assert ray_tpu_torch.get(detached.pid.remote(), timeout=30) == \
        detached_pid
    ray_tpu_torch.kill(detached)


def test_an_actor_killed_in_creation_gives_its_lease_back(clusters):
    """A kill that lands while the raylet is still starting the actor's
    worker must end that actor: the GCS used to mark it alive when the
    raylet's reply came, and it kept its CPU with nobody holding its
    handle (``TuneController.cleanup`` of an interrupted experiment lost
    one CPU this way in both packages)."""

    @ray_tpu_torch.remote(num_cpus=1)
    class Idle:
        def ping(self):
            return 1

    _wait_for_idle_cpus()
    for delay in (0.0, 0.0, 0.3, 0.3):
        actor = Idle.remote()
        time.sleep(delay)
        ray_tpu_torch.kill(actor)
    # a resurrected actor takes its CPU once its worker has started: give
    # the creations in flight time to finish (a leak is for ever)
    time.sleep(5)
    _wait_for_idle_cpus(timeout=10)


def _alive(pid):
    try:
        with open(f"/proc/{pid}/status") as f:
            return "zombie" not in next(
                line for line in f if line.startswith("State:"))
    except (OSError, StopIteration):
        return False


def test_port_import_walk_covers_the_tune_modules():
    """The AST walk of ``tests/test_torch_serve_llm.py`` takes every
    ``ray_tpu_torch/**/*.py``, so the Tune modules and the AIR
    integrations are among the files it holds to importing neither JAX
    nor ``ray_tpu``; here the walk is run on them alone."""
    import ast
    from pathlib import Path

    repo = Path(__file__).resolve().parents[1]
    files = sorted((repo / "ray_tpu_torch" / "tune").rglob("*.py"))
    files += [repo / "ray_tpu_torch" / "air" / "integrations.py",
              repo / "ray_tpu_torch" / "tools" / "tune_runs.py"]
    assert len(files) == 29
    for f in files:
        tree = ast.parse(f.read_text(), str(f))
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            elif isinstance(node, ast.Constant) and \
                    isinstance(node.value, str):
                names = [node.value] if node.value == "ray_tpu" or \
                    node.value.startswith("ray_tpu.") else []
            for name in names:
                root = name.split(".")[0]
                assert root not in {"jax", "jaxlib", "flax", "optax",
                                    "ray_tpu"}, f"{f}: {name}"
