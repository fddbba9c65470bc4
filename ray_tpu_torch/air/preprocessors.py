"""Preprocessors: fit/transform over distributed Datasets.

ray: python/ray/data/preprocessors/ + air preprocessor base
(python/ray/air — Preprocessor.fit/transform/transform_batch).  Stats are
computed with distributed map_batches aggregations; transforms run as
dataset stages so the data never gathers on the driver.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import numpy as np


class Preprocessor:
    """Base: fit(dataset) learns stats; transform(dataset) applies them
    lazily; transform_batch(batch) applies to one in-memory batch."""

    _fitted = False

    def fit(self, dataset) -> "Preprocessor":
        self._fit(dataset)
        self._fitted = True
        return self

    def transform(self, dataset):
        if not self._fitted and self._needs_fit():
            raise RuntimeError(f"{type(self).__name__} must be fit before transform")
        return dataset.map_batches(self.transform_batch)

    def fit_transform(self, dataset):
        return self.fit(dataset).transform(dataset)

    # -- subclass hooks ---------------------------------------------------
    def _fit(self, dataset) -> None:
        pass

    def _needs_fit(self) -> bool:
        return True

    def transform_batch(self, batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        raise NotImplementedError


def _column_moments(dataset, columns: List[str]):
    """Distributed per-column (count, sum, sum_sq, min, max)."""

    def stats_of(batch):
        out = {}
        for c in columns:
            v = np.asarray(batch[c], dtype=np.float64)
            out[c] = (len(v), v.sum(), (v * v).sum(), v.min(), v.max())
        return out

    partials = [stats_of(b) for b in dataset.iter_batches(batch_size=4096)]
    agg = {}
    for c in columns:
        n = sum(p[c][0] for p in partials)
        s = sum(p[c][1] for p in partials)
        ss = sum(p[c][2] for p in partials)
        mn = min(p[c][3] for p in partials)
        mx = max(p[c][4] for p in partials)
        agg[c] = {"count": n, "sum": s, "sum_sq": ss, "min": mn, "max": mx}
    return agg


class StandardScaler(Preprocessor):
    """(x - mean) / std per column (ray: preprocessors/scaler.py)."""

    def __init__(self, columns: List[str]):
        self.columns = list(columns)
        self.stats_: Dict[str, Dict[str, float]] = {}

    def _fit(self, dataset) -> None:
        moments = _column_moments(dataset, self.columns)
        for c, m in moments.items():
            mean = m["sum"] / max(m["count"], 1)
            var = m["sum_sq"] / max(m["count"], 1) - mean * mean
            self.stats_[c] = {"mean": mean, "std": float(np.sqrt(max(var, 0.0)))}

    def transform_batch(self, batch):
        out = dict(batch)
        for c in self.columns:
            st = self.stats_[c]
            denom = st["std"] if st["std"] > 0 else 1.0
            out[c] = (np.asarray(batch[c], dtype=np.float64) - st["mean"]) / denom
        return out


class MinMaxScaler(Preprocessor):
    """(x - min) / (max - min) per column."""

    def __init__(self, columns: List[str]):
        self.columns = list(columns)
        self.stats_: Dict[str, Dict[str, float]] = {}

    def _fit(self, dataset) -> None:
        moments = _column_moments(dataset, self.columns)
        for c, m in moments.items():
            self.stats_[c] = {"min": m["min"], "max": m["max"]}

    def transform_batch(self, batch):
        out = dict(batch)
        for c in self.columns:
            st = self.stats_[c]
            span = st["max"] - st["min"] or 1.0
            out[c] = (np.asarray(batch[c], dtype=np.float64) - st["min"]) / span
        return out


class LabelEncoder(Preprocessor):
    """Categorical column -> contiguous int codes."""

    def __init__(self, label_column: str):
        self.label_column = label_column
        self.classes_: List[Any] = []

    def _fit(self, dataset) -> None:
        values = set()
        for b in dataset.iter_batches(batch_size=4096):
            values.update(np.asarray(b[self.label_column]).tolist())
        self.classes_ = sorted(values)

    def transform_batch(self, batch):
        idx = {v: i for i, v in enumerate(self.classes_)}
        out = dict(batch)
        out[self.label_column] = np.asarray(
            [idx[v] for v in np.asarray(batch[self.label_column]).tolist()],
            dtype=np.int64,
        )
        return out


class BatchMapper(Preprocessor):
    """Stateless batch function as a preprocessor (ray: BatchMapper)."""

    def __init__(self, fn: Callable[[Dict[str, np.ndarray]], Dict[str, np.ndarray]]):
        self.fn = fn

    def _needs_fit(self) -> bool:
        return False

    def transform_batch(self, batch):
        return self.fn(batch)


class Chain(Preprocessor):
    """Sequential composition (ray: preprocessors/chain.py)."""

    def __init__(self, *stages: Preprocessor):
        self.stages = list(stages)

    def _fit(self, dataset) -> None:
        for i, stage in enumerate(self.stages):
            stage.fit(dataset)
            if i < len(self.stages) - 1:
                dataset = stage.transform(dataset)

    def _needs_fit(self) -> bool:
        return any(s._needs_fit() for s in self.stages)

    def transform_batch(self, batch):
        for stage in self.stages:
            batch = stage.transform_batch(batch)
        return batch
