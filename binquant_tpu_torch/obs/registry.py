"""Metric primitives: Counter, Gauge and a fixed-bucket Histogram.

Port of the parts of ``binquant_tpu/obs/registry.py`` the outcome tracker
uses: Prometheus-shaped families without a dependency. A family is created
through a :class:`MetricsRegistry` (get-or-create: every instrumented
module may declare the family it uses, and the declarations must agree on
kind and labels); an unlabeled family is its own single child, a labeled
one mints children with ``.labels(key=value, ...)``. Mutation is
lock-guarded. The exposition renderer is not ported: nothing serves these
families over HTTP here, and tests read them through :meth:`get` and
``.value`` / ``.count``.
"""

from __future__ import annotations

import re
import threading

_METRIC_NAME = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_NAME = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")


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
            if not buckets:
                raise ValueError("a histogram needs its bucket bounds")
            buckets = tuple(float(b) for b in buckets)
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

    # -- unlabeled: the family is its single child

    def _solo(self):
        if self.label_names:
            raise ValueError(f"{self.name} is labeled; use .labels(...)")
        return self._children[()]

    def inc(self, amount: float = 1.0) -> None:
        self._solo().inc(amount)

    def set(self, value: float) -> None:
        self._solo().set(value)

    def observe(self, value: float) -> None:
        self._solo().observe(value)

    @property
    def value(self) -> float:
        return self._solo().value


class MetricsRegistry:
    """Get-or-create family store."""

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


#: The process-wide registry every instrument of ``obs.instruments`` joins.
REGISTRY = MetricsRegistry()
