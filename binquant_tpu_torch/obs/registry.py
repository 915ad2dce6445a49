"""Metric primitives: Counter, Gauge and a fixed-bucket Histogram.

Port of ``binquant_tpu/obs/registry.py``: Prometheus-shaped families
without a dependency. A family is created through a
:class:`MetricsRegistry` (get-or-create: every instrumented module may
declare the family it uses, and the declarations must agree on kind and
labels); an unlabeled family is its own single child, a labeled one mints
children with ``.labels(key=value, ...)``. Mutation is lock-guarded.
Histograms count per bucket and expose cumulative counts for the
Prometheus text renderer (``obs/exposition.py``), which walks
:meth:`MetricsRegistry.collect`.
"""

from __future__ import annotations

import math
import re
import threading
from typing import Iterable

_METRIC_NAME = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_NAME = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

# Latency-in-ms default buckets, shaped around the p99 < 50 ms budget.
DEFAULT_LATENCY_BUCKETS_MS: tuple[float, ...] = (
    0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0,
    1000.0, 2500.0, 5000.0,
)


class Counter:
    """Monotonically increasing value (one label-child)."""

    def __init__(self) -> None:
        self._value = 0.0
        self._lock = threading.Lock()

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters can only increase")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        return self._value


class Gauge:
    """Freely settable value (one label-child)."""

    def __init__(self) -> None:
        self._value = 0.0
        self._lock = threading.Lock()

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.inc(-amount)

    @property
    def value(self) -> float:
        return self._value


class Histogram:
    """Fixed-bucket histogram (one label-child): ``buckets`` are inclusive
    upper bounds, strictly increasing, with an implicit ``+Inf`` bucket;
    counts are per bucket (not cumulative)."""

    def __init__(self, buckets: tuple[float, ...]) -> None:
        self.buckets = buckets
        self._counts = [0] * (len(buckets) + 1)
        self._sum = 0.0
        self._count = 0
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        value = float(value)
        i = len(self.buckets)
        for j, bound in enumerate(self.buckets):
            if value <= bound:
                i = j
                break
        with self._lock:
            self._counts[i] += 1
            self._sum += value
            self._count += 1

    @property
    def sum(self) -> float:
        return self._sum

    @property
    def count(self) -> int:
        return self._count

    def cumulative_counts(self) -> list[int]:
        """Per-``le`` cumulative counts, one per bucket plus ``+Inf``."""
        with self._lock:
            out, acc = [], 0
            for c in self._counts:
                acc += c
                out.append(acc)
            return out


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class MetricFamily:
    """All label-children of one metric name."""

    def __init__(
        self,
        name: str,
        documentation: str,
        kind: str,
        label_names: tuple[str, ...] = (),
        buckets: tuple[float, ...] | None = None,
    ) -> None:
        if not _METRIC_NAME.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        for ln in label_names:
            if not _LABEL_NAME.match(ln):
                raise ValueError(f"invalid label name {ln!r}")
        if kind not in _KINDS:
            raise ValueError(f"unknown metric kind {kind!r}")
        if kind == "histogram":
            buckets = tuple(float(b) for b in (buckets or DEFAULT_LATENCY_BUCKETS_MS))
            if list(buckets) != sorted(set(buckets)):
                raise ValueError("histogram buckets must be strictly increasing")
        self.name = name
        self.documentation = documentation
        self.kind = kind
        self.label_names = tuple(label_names)
        self.bucket_bounds = buckets
        self._children: dict[tuple[str, ...], Counter | Gauge | Histogram] = {}
        self._lock = threading.Lock()
        if not self.label_names:
            self._children[()] = self._new_child()

    def _new_child(self):
        if self.kind == "histogram":
            return Histogram(self.bucket_bounds)
        return _KINDS[self.kind]()

    def labels(self, **label_values: object):
        if set(label_values) != set(self.label_names):
            raise ValueError(
                f"{self.name} expects labels {self.label_names}, "
                f"got {tuple(sorted(label_values))}"
            )
        key = tuple(str(label_values[n]) for n in self.label_names)
        child = self._children.get(key)
        if child is None:
            with self._lock:
                child = self._children.setdefault(key, self._new_child())
        return child

    def children(self) -> Iterable[tuple[tuple[str, ...], object]]:
        with self._lock:
            return list(self._children.items())

    # -- unlabeled: the family is its single child

    def _solo(self):
        if self.label_names:
            raise ValueError(f"{self.name} is labeled; use .labels(...)")
        return self._children[()]

    def inc(self, amount: float = 1.0) -> None:
        self._solo().inc(amount)

    def dec(self, amount: float = 1.0) -> None:
        self._solo().dec(amount)

    def set(self, value: float) -> None:
        self._solo().set(value)

    def observe(self, value: float) -> None:
        self._solo().observe(value)

    @property
    def value(self) -> float:
        return self._solo().value


class MetricsRegistry:
    """Get-or-create family store; the exposition layer renders it."""

    def __init__(self) -> None:
        self._families: dict[str, MetricFamily] = {}
        self._lock = threading.Lock()

    def _family(
        self,
        name: str,
        documentation: str,
        kind: str,
        labels: tuple[str, ...],
        buckets: tuple[float, ...] | None = None,
    ) -> MetricFamily:
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = MetricFamily(name, documentation, kind, labels, buckets)
                self._families[name] = fam
                return fam
        if fam.kind != kind or fam.label_names != tuple(labels):
            raise ValueError(
                f"metric {name!r} re-declared as {kind}{tuple(labels)} but "
                f"exists as {fam.kind}{fam.label_names}"
            )
        return fam

    def counter(
        self, name: str, documentation: str, labels: tuple[str, ...] = ()
    ) -> MetricFamily:
        return self._family(name, documentation, "counter", tuple(labels))

    def gauge(
        self, name: str, documentation: str, labels: tuple[str, ...] = ()
    ) -> MetricFamily:
        return self._family(name, documentation, "gauge", tuple(labels))

    def histogram(
        self,
        name: str,
        documentation: str,
        labels: tuple[str, ...] = (),
        buckets: tuple[float, ...] | None = None,
    ) -> MetricFamily:
        return self._family(name, documentation, "histogram", tuple(labels), buckets)

    def get(self, name: str) -> MetricFamily | None:
        with self._lock:
            return self._families.get(name)

    def collect(self) -> list[MetricFamily]:
        with self._lock:
            return [self._families[n] for n in sorted(self._families)]


def format_value(v: float) -> str:
    """Prometheus sample value: integral floats render bare, +/-Inf and NaN
    in the exposition spellings."""
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if math.isnan(v):
        return "NaN"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


#: The process-wide registry every instrument of ``obs.instruments`` joins.
REGISTRY = MetricsRegistry()
