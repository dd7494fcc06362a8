"""Predictors + BatchPredictor: checkpoint -> inference, single-batch or
Dataset-scale.

Reference parity: ray python/ray/train/predictor.py (Predictor ABC),
train/batch_predictor.py (BatchPredictor: checkpoint + predictor class
fanned out over ``Dataset.map_batches`` with an actor pool), and the
per-framework predictors (torch/tensorflow/xgboost/sklearn
``*_predictor.py``). The first-class predictor here is ``TorchPredictor``
(the JAX package's is a jitted ``JaxPredictor``): a checkpointed
``nn.Module`` on the card, so batch scoring runs the model's own path
(ViT's attention through ``flash_fwd``). sklearn and XGBoost predictors
cover the tabular ecosystem.

A ``BatchPredictor``'s actors lease CPUs only (``map_batches`` takes no
``num_gpus``, as in the reference), and the raylet does not narrow
``CUDA_VISIBLE_DEVICES``, so a ``TorchPredictor`` in them reaches
``cuda:0`` without the raylet counting that use.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Type

import numpy as np

from ray_tpu_torch.air.checkpoint import Checkpoint

_PREDICTOR_BLOB = "predictor.pkl"


class Predictor:
    """Single-process inference over numpy batches (dict of arrays or a
    single array)."""

    @classmethod
    def from_checkpoint(cls, checkpoint: Checkpoint, **kwargs) -> "Predictor":
        raise NotImplementedError

    def predict(self, batch) -> Dict[str, np.ndarray]:
        raise NotImplementedError

    # -- checkpoint plumbing shared by the framework predictors ---------
    @staticmethod
    def _payload(checkpoint: Checkpoint) -> Dict[str, Any]:
        import cloudpickle

        data = checkpoint.to_dict()
        if _PREDICTOR_BLOB in data:
            return cloudpickle.loads(data[_PREDICTOR_BLOB])
        return data

    @staticmethod
    def pack_checkpoint(**payload) -> Checkpoint:
        """Build a Checkpoint a predictor can restore from (the shape the
        framework trainers' save paths produce)."""
        import cloudpickle

        return Checkpoint.from_dict(
            {_PREDICTOR_BLOB: cloudpickle.dumps(payload)}
        )


def _as_feature_matrix(batch) -> np.ndarray:
    if isinstance(batch, dict):
        cols = [np.asarray(v) for v in batch.values()]
        cols = [c[:, None] if c.ndim == 1 else c for c in cols]
        return np.concatenate(cols, axis=1)
    return np.asarray(batch)


class TorchPredictor(Predictor):
    """Applies a checkpointed ``torch.nn.Module`` in eval mode under
    ``torch.inference_mode()``.

    ``device``: the CUDA card unless the caller asks for another
    (``device="cpu"``); with no CUDA device and no ``device`` it raises.
    Construct checkpoints with ``TorchPredictor.pack(model)``."""

    def __init__(self, model, device=None):
        from ray_tpu_torch.device import resolve_device

        self._device = resolve_device(device)
        self._model = model.to(self._device).eval()

    @classmethod
    def pack(cls, model) -> Checkpoint:
        """The module with its tensors on the CPU (a copy when they lie
        elsewhere), pickled into the predictor payload."""
        import copy

        import torch

        on_cpu = all(t.device.type == "cpu" for t in
                     list(model.parameters()) + list(model.buffers()))
        if not on_cpu:
            model = copy.deepcopy(model).to(torch.device("cpu"))
        return cls.pack_checkpoint(model=model)

    @classmethod
    def from_checkpoint(cls, checkpoint: Checkpoint, device=None,
                        **_kw) -> "TorchPredictor":
        return cls(cls._payload(checkpoint)["model"], device=device)

    def predict(self, batch) -> Dict[str, np.ndarray]:
        import torch

        x = _as_feature_matrix(batch).astype(np.float32)
        with torch.inference_mode():
            out = self._model(torch.from_numpy(x).to(self._device))
        if out.dtype == torch.bfloat16:  # numpy has no bf16
            out = out.float()
        return {"predictions": out.cpu().numpy()}


class SklearnPredictor(Predictor):
    """Wraps a fitted sklearn estimator (ray parity:
    train/sklearn/sklearn_predictor.py)."""

    def __init__(self, estimator):
        self._est = estimator

    @classmethod
    def pack(cls, estimator) -> Checkpoint:
        return cls.pack_checkpoint(estimator=estimator)

    @classmethod
    def from_checkpoint(cls, checkpoint: Checkpoint,
                        **_kw) -> "SklearnPredictor":
        return cls(cls._payload(checkpoint)["estimator"])

    def predict(self, batch) -> Dict[str, np.ndarray]:
        x = _as_feature_matrix(batch)
        return {"predictions": np.asarray(self._est.predict(x))}


class XGBoostPredictor(Predictor):
    """Wraps a trained xgboost Booster (ray parity:
    train/xgboost/xgboost_predictor.py)."""

    def __init__(self, booster):
        self._booster = booster

    @classmethod
    def pack(cls, booster) -> Checkpoint:
        return cls.pack_checkpoint(raw=booster.save_raw())

    @classmethod
    def from_checkpoint(cls, checkpoint: Checkpoint,
                        **_kw) -> "XGBoostPredictor":
        import xgboost

        payload = cls._payload(checkpoint)
        booster = xgboost.Booster()
        booster.load_model(bytearray(payload["raw"]))
        return cls(booster)

    def predict(self, batch) -> Dict[str, np.ndarray]:
        import xgboost

        x = _as_feature_matrix(batch)
        return {
            "predictions": np.asarray(
                self._booster.predict(xgboost.DMatrix(x))
            )
        }


class _ScoringWorker:
    """Actor-pool callable for map_batches: loads the predictor ONCE per
    worker, scores every batch routed to it."""

    def __init__(self, checkpoint: Checkpoint,
                 predictor_cls: Type[Predictor], kwargs: Dict):
        self._predictor = predictor_cls.from_checkpoint(checkpoint, **kwargs)

    def __call__(self, batch):
        return self._predictor.predict(batch)


class BatchPredictor:
    """Offline batch scoring: a checkpoint + predictor class applied over
    a Dataset with an actor pool (ray parity:
    train/batch_predictor.py BatchPredictor.predict)."""

    def __init__(self, checkpoint: Checkpoint,
                 predictor_cls: Type[Predictor], **predictor_kwargs):
        self._checkpoint = checkpoint
        self._predictor_cls = predictor_cls
        self._kwargs = predictor_kwargs

    @classmethod
    def from_checkpoint(cls, checkpoint: Checkpoint,
                        predictor_cls: Type[Predictor],
                        **predictor_kwargs) -> "BatchPredictor":
        return cls(checkpoint, predictor_cls, **predictor_kwargs)

    def predict(self, dataset, *, batch_size: Optional[int] = None,
                concurrency: int = 2, num_cpus: float = 1.0):
        """Returns a Dataset of ``{"predictions": ...}`` blocks; lazy —
        consumption drives the streaming executor."""
        return dataset.map_batches(
            _ScoringWorker,
            batch_size=batch_size,
            batch_format="numpy",
            concurrency=concurrency,
            num_cpus=num_cpus,
            fn_constructor_args=(
                self._checkpoint, self._predictor_cls, self._kwargs
            ),
        )
