"""Preprocessors: fit statistics on a Dataset, transform batches.

ray parity: python/ray/data/preprocessors/ — Preprocessor base
(fit/transform/fit_transform/transform_batch), StandardScaler,
MinMaxScaler, LabelEncoder, OneHotEncoder, SimpleImputer, Concatenator,
Chain, BatchMapper. Stats are computed with Dataset aggregations
(distributed) and applied via map_batches; transform_batch applies the
fitted stats to a standalone pandas/dict batch for serving-time use.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np


class PreprocessorNotFittedError(RuntimeError):
    pass


class Preprocessor:
    _is_fittable = True

    def __init__(self):
        self.stats_: Optional[dict] = None

    def fit(self, dataset) -> "Preprocessor":
        if self._is_fittable:
            self.stats_ = self._fit(dataset)
        return self

    def transform(self, dataset):
        if self._is_fittable and self.stats_ is None:
            raise PreprocessorNotFittedError(
                f"{type(self).__name__} must be fit before transform"
            )
        return dataset.map_batches(self._transform_batch, batch_format="pandas")

    def fit_transform(self, dataset):
        return self.fit(dataset).transform(dataset)

    def transform_batch(self, batch):
        """Apply to a standalone batch (pandas DataFrame or dict of
        arrays) — the serving-time path."""
        import pandas as pd

        if isinstance(batch, dict):
            return self._transform_batch(pd.DataFrame(batch))
        return self._transform_batch(batch)

    # subclass hooks
    def _fit(self, dataset) -> dict:
        raise NotImplementedError

    def _transform_batch(self, df):
        raise NotImplementedError


def _col_stats(dataset, columns: List[str], fns: List[str]) -> Dict[str, dict]:
    """One pass of per-column aggregates via pandas on each block."""

    def agg_batch(df):
        import pandas as pd

        out = {}
        for col in columns:
            s = df[col].dropna()
            out[f"{col}__count"] = [len(s)]
            out[f"{col}__sum"] = [float(s.sum()) if len(s) else 0.0]
            out[f"{col}__sumsq"] = [float((s.astype(float) ** 2).sum()) if len(s) else 0.0]
            out[f"{col}__min"] = [float(s.min()) if len(s) else np.inf]
            out[f"{col}__max"] = [float(s.max()) if len(s) else -np.inf]
        return pd.DataFrame(out)

    parts = dataset.map_batches(agg_batch, batch_format="pandas").to_pandas()
    stats: Dict[str, dict] = {}
    for col in columns:
        count = parts[f"{col}__count"].sum()
        total = parts[f"{col}__sum"].sum()
        sumsq = parts[f"{col}__sumsq"].sum()
        mean = total / count if count else 0.0
        var = max(sumsq / count - mean * mean, 0.0) if count else 0.0
        stats[col] = {
            "count": int(count),
            "mean": mean,
            "std": float(np.sqrt(var)),
            "min": float(parts[f"{col}__min"].min()),
            "max": float(parts[f"{col}__max"].max()),
        }
    return stats


class StandardScaler(Preprocessor):
    """(x - mean) / std per column (ray: preprocessors/scaler.py)."""

    def __init__(self, columns: List[str]):
        super().__init__()
        self.columns = list(columns)

    def _fit(self, dataset):
        return _col_stats(dataset, self.columns, ["mean", "std"])

    def _transform_batch(self, df):
        df = df.copy()
        for col in self.columns:
            s = self.stats_[col]
            std = s["std"] or 1.0
            df[col] = (df[col] - s["mean"]) / std
        return df


class MinMaxScaler(Preprocessor):
    """(x - min) / (max - min) per column."""

    def __init__(self, columns: List[str]):
        super().__init__()
        self.columns = list(columns)

    def _fit(self, dataset):
        return _col_stats(dataset, self.columns, ["min", "max"])

    def _transform_batch(self, df):
        df = df.copy()
        for col in self.columns:
            s = self.stats_[col]
            span = (s["max"] - s["min"]) or 1.0
            df[col] = (df[col] - s["min"]) / span
        return df


def _unique_values(dataset, columns: List[str]) -> Dict[str, list]:
    def uniq_batch(df):
        import pandas as pd

        return pd.DataFrame({
            col: [sorted(df[col].dropna().unique().tolist())]
            for col in columns
        })

    parts = dataset.map_batches(uniq_batch, batch_format="pandas").to_pandas()
    return {
        col: sorted({v for row in parts[col] for v in row})
        for col in columns
    }


class LabelEncoder(Preprocessor):
    """Map a label column to contiguous ints (ray: preprocessors/encoder.py)."""

    def __init__(self, label_column: str):
        super().__init__()
        self.label_column = label_column

    def _fit(self, dataset):
        values = _unique_values(dataset, [self.label_column])[self.label_column]
        return {"mapping": {v: i for i, v in enumerate(values)}}

    def _transform_batch(self, df):
        df = df.copy()
        df[self.label_column] = df[self.label_column].map(self.stats_["mapping"])
        return df


class OneHotEncoder(Preprocessor):
    """Expand categorical columns into 0/1 indicator columns."""

    def __init__(self, columns: List[str]):
        super().__init__()
        self.columns = list(columns)

    def _fit(self, dataset):
        return {"values": _unique_values(dataset, self.columns)}

    def _transform_batch(self, df):
        df = df.copy()
        for col in self.columns:
            for v in self.stats_["values"][col]:
                df[f"{col}_{v}"] = (df[col] == v).astype(np.int8)
            df = df.drop(columns=[col])
        return df


class SimpleImputer(Preprocessor):
    """Fill missing values with mean ("mean") or a constant."""

    def __init__(self, columns: List[str], strategy: str = "mean",
                 fill_value=None):
        super().__init__()
        if strategy not in ("mean", "constant"):
            raise ValueError("strategy must be 'mean' or 'constant'")
        self.columns = list(columns)
        self.strategy = strategy
        self.fill_value = fill_value

    def _fit(self, dataset):
        if self.strategy == "constant":
            return {"fill": {c: self.fill_value for c in self.columns}}
        stats = _col_stats(dataset, self.columns, ["mean"])
        return {"fill": {c: stats[c]["mean"] for c in self.columns}}

    def _transform_batch(self, df):
        df = df.copy()
        for col in self.columns:
            df[col] = df[col].fillna(self.stats_["fill"][col])
        return df


class Concatenator(Preprocessor):
    """Concatenate numeric columns into one vector column."""

    _is_fittable = False

    def __init__(self, columns: List[str], output_column_name: str = "concat"):
        super().__init__()
        self.columns = list(columns)
        self.output_column_name = output_column_name

    def _transform_batch(self, df):
        df = df.copy()
        stacked = np.stack([df[c].to_numpy() for c in self.columns], axis=1)
        df = df.drop(columns=self.columns)
        df[self.output_column_name] = list(stacked)
        return df


class BatchMapper(Preprocessor):
    """Arbitrary per-batch function as a preprocessor."""

    _is_fittable = False

    def __init__(self, fn: Callable, batch_format: str = "pandas"):
        super().__init__()
        self.fn = fn
        self.batch_format = batch_format

    def _transform_batch(self, df):
        return self.fn(df)


class Chain(Preprocessor):
    """Apply preprocessors in sequence; fit propagates transformed data."""

    def __init__(self, *preprocessors: Preprocessor):
        super().__init__()
        self.preprocessors = list(preprocessors)

    def fit(self, dataset):
        for p in self.preprocessors:
            dataset = p.fit_transform(dataset)
        self.stats_ = {"fitted": True}
        return self

    def transform(self, dataset):
        for p in self.preprocessors:
            dataset = p.transform(dataset)
        return dataset

    def fit_transform(self, dataset):
        self.fit(dataset)  # fitting already transforms stepwise
        for p in self.preprocessors:
            dataset = p.transform(dataset)
        return dataset

    def transform_batch(self, batch):
        for p in self.preprocessors:
            batch = p.transform_batch(batch)
        return batch
