"""GBDT trainers: XGBoost + LightGBM.

ray parity: python/ray/train/gbdt_trainer.py:109 (GBDTTrainer) +
train/xgboost/xgboost_trainer.py, train/lightgbm/lightgbm_trainer.py —
boosting over Dataset shards with per-round metric reporting and the
fitted booster as the checkpoint. This image does not bundle xgboost/
lightgbm, so the trainers GATE: constructing one without its library
raises ImportError up front (never silently degrade); with the library
present the full fit/checkpoint/resume surface runs. Boosting itself is
single-process multi-threaded (the libraries' own parallelism) — the
reference's rabit/dask collective ring has no offline analog here.
"""

from __future__ import annotations

from typing import Optional

from ray_tpu_torch.air.config import RunConfig, ScalingConfig
from ray_tpu_torch.train.trainer import DataParallelTrainer


class _GBDTTrainer(DataParallelTrainer):
    """Shared driver: materialize the train/validation shards to matrices,
    boost num_boost_round rounds reporting eval metrics each round, ship
    the booster as the checkpoint (ray parity: gbdt_trainer.py:109)."""

    _module_name: str = ""

    def __init__(self, *, params: dict, datasets: dict, label_column: str,
                 num_boost_round: int = 10,
                 scaling_config: Optional[ScalingConfig] = None,
                 run_config: Optional[RunConfig] = None, **kwargs):
        self._check_import()
        if not datasets or "train" not in datasets:
            raise ValueError(
                f"{type(self).__name__} requires datasets={{'train': ...}}"
            )
        if not label_column:
            raise ValueError(f"{type(self).__name__} requires label_column")
        scaling_config = scaling_config or ScalingConfig(num_workers=1)
        if scaling_config.num_workers != 1:
            # N workers would each boost an independent model on 1/N of
            # the rows — silently worse, never what the caller meant
            raise ValueError(
                f"{type(self).__name__} boosts one model on the full "
                f"dataset; num_workers must be 1, got "
                f"{scaling_config.num_workers}"
            )
        module_name = self._module_name
        label = label_column
        has_valid = "validation" in datasets

        def train_loop():
            import importlib

            import numpy as np

            from ray_tpu_torch import train as train_mod
            from ray_tpu_torch.air import Checkpoint

            lib = importlib.import_module(module_name)

            def to_xy(name):
                ds = train_mod.get_dataset_shard(name)
                Xs, ys = [], []
                for batch in ds.iter_batches(batch_size=4096,
                                             batch_format="pandas"):
                    ys.append(batch[label].to_numpy())
                    Xs.append(batch.drop(columns=[label]).to_numpy())
                return np.concatenate(Xs), np.concatenate(ys)

            X, y = to_xy("train")
            evals = [("train", X, y)]
            if has_valid:
                Xv, yv = to_xy("validation")
                evals.append(("validation", Xv, yv))
            if module_name == "xgboost":
                dtrain = lib.DMatrix(X, label=y)
                # reuse dtrain in the watch list: a second DMatrix of the
                # same rows would double peak training-data memory
                watch = [(dtrain, "train")] + [
                    (lib.DMatrix(ex, label=ey), name)
                    for name, ex, ey in evals[1:]
                ]
                results: dict = {}
                booster = lib.train(
                    params, dtrain, num_boost_round=num_boost_round,
                    evals=watch, evals_result=results, verbose_eval=False,
                )
                for i in range(num_boost_round):
                    metrics = {
                        f"{split}-{metric}": vals[i]
                        for split, md in results.items()
                        for metric, vals in md.items()
                    }
                    metrics["training_iteration"] = i + 1
                    ckpt = None
                    if i == num_boost_round - 1:
                        ckpt = Checkpoint.from_dict(
                            {"model": booster.save_raw("ubj"),
                             "format": "xgboost-ubj"}
                        )
                    train_mod.report(metrics, checkpoint=ckpt)
            else:  # lightgbm
                dtrain = lib.Dataset(X, label=y)
                valid_sets = [
                    lib.Dataset(ex, label=ey, reference=dtrain)
                    for _, ex, ey in evals
                ]
                record: dict = {}
                booster = lib.train(
                    params, dtrain, num_boost_round=num_boost_round,
                    valid_sets=valid_sets,
                    valid_names=[name for name, _, _ in evals],
                    callbacks=[lib.record_evaluation(record)],
                )
                for i in range(num_boost_round):
                    metrics = {
                        f"{split}-{metric}": vals[i]
                        for split, md in record.items()
                        for metric, vals in md.items()
                    }
                    metrics["training_iteration"] = i + 1
                    ckpt = None
                    if i == num_boost_round - 1:
                        ckpt = Checkpoint.from_dict(
                            {"model": booster.model_to_string(),
                             "format": "lightgbm-str"}
                        )
                    train_mod.report(metrics, checkpoint=ckpt)

        super().__init__(
            train_loop,
            scaling_config=scaling_config,
            run_config=run_config,
            datasets=datasets,
            **kwargs,
        )

    def _check_import(self):
        import importlib

        try:
            importlib.import_module(self._module_name)
        except ImportError as e:
            raise ImportError(
                f"{type(self).__name__} requires the '{self._module_name}' "
                f"package, which is not installed in this environment"
            ) from e


class XGBoostTrainer(_GBDTTrainer):
    """ray parity: train/xgboost/xgboost_trainer.py XGBoostTrainer."""

    _module_name = "xgboost"

    @staticmethod
    def get_model(checkpoint):
        import xgboost as xgb

        d = checkpoint.to_dict()
        booster = xgb.Booster()
        booster.load_model(bytearray(d["model"]))
        return booster


class LightGBMTrainer(_GBDTTrainer):
    """ray parity: train/lightgbm/lightgbm_trainer.py LightGBMTrainer."""

    _module_name = "lightgbm"

    @staticmethod
    def get_model(checkpoint):
        import lightgbm as lgb

        d = checkpoint.to_dict()
        return lgb.Booster(model_str=d["model"])
