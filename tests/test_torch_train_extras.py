"""The port's trainers that wrap other libraries: ``TensorflowTrainer``
(``TensorflowConfig``'s TF_CONFIG wiring), ``SklearnTrainer``, the GBDT
trainers' gate and the HuggingFace bridge, on the CPU.

The reference's cases (``tests/test_train.py``'s TensorFlow and sklearn
cases, ``tests/test_breadth.py::test_gbdt_trainers_gate_without_libs`` and
``tests/test_train_hf.py``'s case, slow as the reference's is) run through
``ray_tpu_torch.train`` with their expected values. A tier-1 case drives
``RayTrainReportCallback`` and ``prepare_trainer`` against a stub session
and a stub HF trainer, beside the reference's on the same calls.
"""

import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest

import ray_tpu_torch

rt = ray_tpu_torch
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def cluster():
    rt.init(num_cpus=4)
    yield
    rt.shutdown()


def test_exports_equal_the_reference():
    import ray_tpu.train as jtrain
    import ray_tpu_torch.train as ttrain

    port_names = {"JaxConfig": "TorchConfig", "JaxTrainer": "TorchTrainer",
                  "JaxPredictor": "TorchPredictor"}
    want = {port_names.get(n, n) for n in jtrain.__all__}
    assert set(ttrain.__all__) == want
    for name in ("TensorflowTrainer", "TensorflowConfig", "SklearnTrainer",
                 "XGBoostTrainer", "LightGBMTrainer"):
        assert getattr(ttrain, name).__module__.startswith("ray_tpu_torch.")
    # the HF integration stays lazy: transformers loads on first access
    probe = subprocess.run([sys.executable, "-c", (
        "import sys, ray_tpu_torch.train as t\n"
        "assert 'transformers' not in sys.modules\n"
        "print(t.TransformersTrainer.__module__)\n"
        "assert 'transformers' in sys.modules\n")],
        capture_output=True, text=True, timeout=300, cwd=REPO,
        env=dict(os.environ, PYTHONPATH=REPO))
    assert probe.returncode == 0, probe.stderr[-2000:]
    assert probe.stdout.split() == ["ray_tpu_torch.train.huggingface"]


def test_tensorflow_trainer_tf_config_and_fit(cluster):
    """TF_CONFIG is wired per worker (cluster spec + task index); a
    single-worker keras fit runs under MultiWorkerMirroredStrategy
    (ray parity: tensorflow_trainer.py)."""
    from ray_tpu_torch import train
    from ray_tpu_torch.train import TensorflowTrainer

    def probe_loop():
        import os

        from ray_tpu_torch import train as train_mod

        cfg = json.loads(os.environ["TF_CONFIG"])
        ctx = train_mod.get_context()
        train_mod.report({
            "task_index": cfg["task"]["index"],
            "world": len(cfg["cluster"]["worker"]),
            "rank": ctx.get_world_rank(),
        })

    trainer = TensorflowTrainer(
        probe_loop, scaling_config=train.ScalingConfig(num_workers=2,
                                                       use_gpu=False)
    )
    result = trainer.fit()
    assert result.error is None
    assert result.metrics["world"] == 2
    assert result.metrics["task_index"] == result.metrics["rank"]

    def keras_loop():
        import numpy as np
        import tensorflow as tf

        from ray_tpu_torch import train as train_mod

        strategy = tf.distribute.MultiWorkerMirroredStrategy()
        with strategy.scope():
            model = tf.keras.Sequential([
                tf.keras.layers.Dense(4, activation="relu",
                                      input_shape=(2,)),
                tf.keras.layers.Dense(1),
            ])
            model.compile(optimizer="sgd", loss="mse")
        X = np.random.rand(64, 2).astype("float32")
        y = (X.sum(axis=1, keepdims=True)).astype("float32")
        hist = model.fit(X, y, epochs=2, verbose=0)
        train_mod.report({"loss": float(hist.history["loss"][-1])})

    trainer = TensorflowTrainer(
        keras_loop, scaling_config=train.ScalingConfig(num_workers=1,
                                                       use_gpu=False)
    )
    result = trainer.fit()
    assert result.error is None
    assert result.metrics["loss"] >= 0.0


def test_sklearn_trainer(cluster):
    import pandas as pd
    from sklearn.linear_model import LogisticRegression

    from ray_tpu_torch import data as rdata
    from ray_tpu_torch.train import ScalingConfig, SklearnTrainer

    rng = np.random.default_rng(0)
    X = rng.normal(size=(200, 3))
    y = (X[:, 0] + X[:, 1] > 0).astype(int)
    df = pd.DataFrame({"a": X[:, 0], "b": X[:, 1], "c": X[:, 2], "label": y})
    trainer = SklearnTrainer(
        estimator=LogisticRegression(max_iter=200),
        datasets={"train": rdata.from_pandas(df)},
        label_column="label",
        scaling_config=ScalingConfig(num_workers=1, use_gpu=False),
    )
    result = trainer.fit()
    assert result.error is None, result.error
    assert result.metrics["train_score"] > 0.9
    import cloudpickle

    model = cloudpickle.loads(result.checkpoint.to_dict()["model"])
    assert model.predict(np.array([[2.0, 2.0, 0.0]]))[0] == 1


def test_sklearn_trainer_refuses_what_the_reference_refuses():
    from sklearn.linear_model import LogisticRegression

    from ray_tpu_torch.train import ScalingConfig, SklearnTrainer

    with pytest.raises(ValueError, match="datasets"):
        SklearnTrainer(estimator=LogisticRegression(), datasets={},
                       label_column="y")
    with pytest.raises(ValueError, match="label_column"):
        SklearnTrainer(estimator=LogisticRegression(),
                       datasets={"train": object()}, label_column="")
    with pytest.raises(ValueError, match="num_workers must be 1"):
        SklearnTrainer(estimator=LogisticRegression(),
                       datasets={"train": object()}, label_column="y",
                       scaling_config=ScalingConfig(num_workers=2))


def test_gbdt_trainers_gate_without_libs():
    from ray_tpu_torch.train import LightGBMTrainer, XGBoostTrainer

    have_xgb = True
    try:
        import xgboost  # noqa: F401
    except ImportError:
        have_xgb = False
    if not have_xgb:
        with pytest.raises(ImportError, match="xgboost"):
            XGBoostTrainer(params={}, datasets={}, label_column="y")
    have_lgbm = True
    try:
        import lightgbm  # noqa: F401
    except ImportError:
        have_lgbm = False
    if not have_lgbm:
        with pytest.raises(ImportError, match="lightgbm"):
            LightGBMTrainer(params={}, datasets={}, label_column="y")


# ---------------------------------------------------------------------------
# HuggingFace
# ---------------------------------------------------------------------------

def _hf_calls(hf, monkeypatch, tmp_path):
    """Drive one package's RayTrainReportCallback and prepare_trainer with a
    stub session and a stub trainer; returns what reached ``report``."""
    reported = []
    monkeypatch.setattr(hf.session, "report",
                        lambda metrics, checkpoint=None: reported.append(
                            (metrics, None if checkpoint is None else
                             os.path.basename(checkpoint.path))))
    args = types.SimpleNamespace(output_dir=str(tmp_path))
    state = types.SimpleNamespace(global_step=3, epoch=0.5)
    cb = hf.RayTrainReportCallback()
    cb.on_log(args, state, None, logs={"loss": 1.25, "learning_rate": 1e-3})
    cb.on_save(args, state, None)  # no checkpoint dir yet: no report
    (tmp_path / "checkpoint-3").mkdir(parents=True)
    cb.on_save(args, state, None)
    state.global_step, state.epoch = 4, None
    cb.on_log(args, state, None, logs=None)

    class StubTrainer:
        def __init__(self):
            self.callback_handler = types.SimpleNamespace(callbacks=[])

        def add_callback(self, cb):
            self.callback_handler.callbacks.append(cb)

    trainer = StubTrainer()
    assert hf.prepare_trainer(trainer) is trainer
    hf.prepare_trainer(trainer)  # idempotent: one bridge only
    kinds = [type(c).__name__ for c in trainer.callback_handler.callbacks]
    return reported, kinds


def test_report_callback_and_prepare_trainer_equal_the_reference(
        monkeypatch, tmp_path):
    from ray_tpu.train import huggingface as jhf
    from ray_tpu_torch.train import huggingface as thf

    want = _hf_calls(jhf, monkeypatch, tmp_path / "ref")
    got = _hf_calls(thf, monkeypatch, tmp_path / "port")
    assert got == want
    reported, kinds = got
    assert kinds == ["RayTrainReportCallback"]
    assert reported == [
        ({"loss": 1.25, "learning_rate": 1e-3, "step": 3, "epoch": 0.5},
         None),
        ({"loss": 1.25, "learning_rate": 1e-3, "step": 3, "epoch": 0.5},
         "checkpoint-3"),
        ({"step": 4}, None),
    ]


@pytest.mark.slow  # the reference's HF-integration case: slow lane
def test_transformers_trainer_two_workers(cluster, tmp_path):
    import ray_tpu_torch.train as train
    from ray_tpu_torch.air.config import RunConfig, ScalingConfig

    out_dir = str(tmp_path / "hf_out")

    def trainer_init(config):
        import torch
        from transformers import (
            GPT2Config,
            GPT2LMHeadModel,
            Trainer,
            TrainingArguments,
        )

        model = GPT2LMHeadModel(GPT2Config(
            vocab_size=128, n_positions=32, n_embd=32, n_layer=2, n_head=2,
        ))

        class ToyLM(torch.utils.data.Dataset):
            def __len__(self):
                return 32

            def __getitem__(self, i):
                g = torch.Generator().manual_seed(i)
                ids = torch.randint(0, 128, (16,), generator=g)
                return {"input_ids": ids, "labels": ids.clone()}

        args = TrainingArguments(
            output_dir=config["output_dir"],
            max_steps=4,
            per_device_train_batch_size=4,
            logging_steps=1,
            save_steps=4,
            save_total_limit=1,
            report_to=[],
            use_cpu=True,
            disable_tqdm=True,
        )
        return Trainer(model=model, args=args, train_dataset=ToyLM())

    trainer = train.TransformersTrainer(
        trainer_init,
        scaling_config=ScalingConfig(num_workers=2, use_gpu=False),
        run_config=RunConfig(name="hf_test", storage_path=str(tmp_path)),
        train_loop_config={"output_dir": out_dir},
    )
    result = trainer.fit()
    assert result.error is None, result.error
    # last report is HF's end-of-train summary (train_loss); per-step
    # reports carried 'loss'
    assert result.metrics and (
        "loss" in result.metrics or "train_loss" in result.metrics
    ), result.metrics
    assert result.metrics["step"] >= 4
    # the HF checkpoint rode through as a Train checkpoint
    assert result.checkpoint is not None
    with result.checkpoint.as_directory() as d:
        assert any("model" in f or "safetensors" in f or "bin" in f
                   for f in os.listdir(d)), os.listdir(d)
