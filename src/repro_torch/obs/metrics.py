"""Counters / gauges / histograms behind one registry.

The repo's stat surfaces (``latency_stats``, ``migration_stats``,
executor summaries) grew as ad-hoc dict builders; this module gives
them one typed backend.  Adapters in :mod:`repro.fleet.metering` and
:meth:`repro.dvfs.executor.GovernorExecutor.metrics` route the existing
outputs *through* these instruments while producing byte-identical
dicts — :meth:`Histogram.percentiles` is the same ``np.percentile``
computation (NaN on empty) the old ``_pcts`` helper did, so p50/p99
numbers cannot drift by construction.

The port's copy of the JAX package's ``obs/metrics.py``.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np


class Counter:
    """Monotonic accumulator (float-valued; billing joules counts)."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def inc(self, v: float = 1.0) -> None:
        if v < 0:
            raise ValueError(f"counter increment must be >= 0, got {v}")
        self.value += v


class Gauge:
    """Last-write-wins sample (e.g. current cluster power)."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = float("nan")

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    """Exact-sample histogram with on-demand percentiles.

    Samples are kept raw (the repo's populations are small — requests,
    windows, migrations), so ``percentiles`` is exact, matching the
    legacy ``_pcts``: ``np.percentile`` over a float array, NaN for
    every requested percentile when empty."""

    __slots__ = ("samples",)

    def __init__(self):
        self.samples: List[float] = []

    def observe(self, v: float) -> None:
        self.samples.append(float(v))

    @property
    def count(self) -> int:
        return len(self.samples)

    @property
    def sum(self) -> float:
        return float(sum(self.samples))

    def percentiles(self, ps=(50, 99)) -> Dict[str, float]:
        if not self.samples:
            return {f"p{p}": float("nan") for p in ps}
        arr = np.asarray(self.samples, dtype=float)
        return {f"p{p}": float(np.percentile(arr, p)) for p in ps}


class MetricsRegistry:
    """Get-or-create instrument store keyed by (kind, name, labels)."""

    def __init__(self):
        self._instruments: Dict[Tuple, object] = {}

    def _get(self, kind: str, cls, name: str, labels: Optional[Dict]):
        key = (name, tuple(sorted((labels or {}).items())))
        inst = self._instruments.get(key)
        if inst is None:
            inst = self._instruments[key] = cls()
        elif not isinstance(inst, cls):
            raise TypeError(f"metric {name!r} already registered as "
                            f"{type(inst).__name__}")
        return inst

    def counter(self, name: str, **labels) -> Counter:
        return self._get("counter", Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get("gauge", Gauge, name, labels)

    def histogram(self, name: str, **labels) -> Histogram:
        return self._get("histogram", Histogram, name, labels)

    def __len__(self) -> int:
        return len(self._instruments)

    def snapshot(self) -> Dict[str, Dict]:
        """Flat JSON-able view: ``name{label=value,...}`` -> reading."""
        out: Dict[str, Dict] = {}
        for (name, labels), inst in sorted(
                self._instruments.items(),
                key=lambda kv: (kv[0][0], kv[0][1])):
            kind = type(inst).__name__.lower()
            label_s = ",".join(f"{k}={v}" for k, v in labels)
            key = f"{name}{{{label_s}}}" if label_s else name
            if kind == "histogram":
                out[key] = {"kind": kind, "count": inst.count,
                            "sum": inst.sum, **inst.percentiles()}
            else:
                out[key] = {"kind": kind, "value": inst.value}
        return out
