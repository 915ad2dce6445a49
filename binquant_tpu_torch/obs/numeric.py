"""Host side of the numeric-health digest and the carry-drift meter.

Port of ``NumericHealthMonitor`` and ``DriftMeter`` from
``binquant_tpu/obs/numeric.py``: the card computes the numeric digest
(``engine/step.py _numeric_digest_block``, on the wire) and the audit tick's
drift scalars (``measure_carry_drift``); these classes decode them into the
``bqt_numeric_*`` / ``bqt_fired_rows_per_tick`` / ``bqt_carry_drift*``
families, keep the last values for the ``/healthz`` ``numeric`` section, and
write the reference's events: a sampled ``numeric_digest`` every
``event_every`` ticks, a ``carry_drift`` record per audit, and the
force-emitted ``numeric_anomaly`` / ``carry_drift_alarm`` (flight-recorder
style: the event with an engine snapshot, never sampled). ``record_history``,
the port's own, keeps every decoded value for equality drills (tests,
``chip_smoke.py``).
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np

from binquant_tpu_torch.engine.step import decode_numeric_digest
from binquant_tpu_torch.obs.events import get_event_log
from binquant_tpu_torch.obs.instruments import (
    CARRY_DRIFT,
    CARRY_DRIFT_ALARMS,
    CARRY_DRIFT_ULP,
    FIRED_PER_TICK,
    NUMERIC_ABSMAX,
    NUMERIC_ANOMALIES,
    NUMERIC_NONFINITE,
)


class NumericHealthMonitor:
    """Per-engine digest consumer: decode each digest-carrying tick, keep
    the gauges and the last decoded digest current, and force-emit
    ``numeric_anomaly`` when the leaked rows (NaN and Inf past the
    sufficiency gates) exceed ``nan_budget``. A healthy digest is filed as a
    ``numeric_digest`` event every ``event_every`` ticks."""

    def __init__(self, nan_budget: int = 0, event_every: int = 256) -> None:
        self.nan_budget = int(nan_budget)
        self.event_every = max(int(event_every), 1)
        self.last: dict | None = None
        self.ticks_seen = 0
        self.anomaly_ticks = 0
        self.record_history = False
        self.history: list[tuple[int | None, Any]] = []  # (tick_ms, raw block)

    def observe(
        self,
        digest_vec,
        tick_ms: int | None = None,
        trace_id: str | None = None,
        snapshot_fn: Callable[[], dict] | None = None,
    ) -> dict:
        """Decode one tick's digest block; returns the decoded dict."""
        digest = decode_numeric_digest(digest_vec)
        self.last = digest
        self.ticks_seen += 1
        if self.record_history:
            self.history.append((tick_ms, np.asarray(digest_vec, np.float32).copy()))

        for stage, count in digest["nan_rows"].items():
            NUMERIC_NONFINITE.labels(stage=stage, kind="nan").set(count)
        for stage, count in digest["inf_rows"].items():
            NUMERIC_NONFINITE.labels(stage=stage, kind="inf").set(count)
        # the strategy-output gate counts NaN and Inf as one (~isfinite)
        NUMERIC_NONFINITE.labels(stage="strategies", kind="nonfinite").set(
            sum(digest["strategy_nonfinite"].values())
        )
        for series, stats in digest["series"].items():
            if stats["absmax"] is not None:
                NUMERIC_ABSMAX.labels(series=series).set(stats["absmax"])
        for strategy, count in digest["fired"].items():
            FIRED_PER_TICK.labels(strategy=strategy).observe(count)

        leakage = digest["nan_total"] + digest["inf_total"]
        if leakage > self.nan_budget:
            self.anomaly_ticks += 1
            NUMERIC_ANOMALIES.inc()
            get_event_log().emit(
                "numeric_anomaly",
                leakage_rows=leakage,
                budget=self.nan_budget,
                digest=digest,
                tick_ms=tick_ms,
                trace_id=trace_id,
                engine=snapshot_fn() if snapshot_fn is not None else {},
            )
        elif self.ticks_seen % self.event_every == 0:
            get_event_log().emit("numeric_digest", digest=digest, tick_ms=tick_ms)
        return digest


class DriftMeter:
    """Audit-tick drift consumer: the histogram and gauge per family, the
    ``carry_drift`` record, the alarm event, and the last measured values
    for ``/healthz``."""

    def __init__(self, tol: float = 0.05) -> None:
        self.tol = float(tol)
        self.last: dict | None = None
        self.audits = 0
        self.alarms = 0
        self.skipped = 0  # audit ticks the meter could not measure
        self.record_history = False
        # (tick_ms, drift, breached families) per measured audit tick
        self.history: list[tuple[int | None, dict, list[str]]] = []

    def observe(
        self,
        drift: dict[str, dict[str, Any]],
        tick_ms: int | None = None,
        trace_id: str | None = None,
        snapshot_fn: Callable[[], dict] | None = None,
    ) -> list[str]:
        """Record one audit tick's per-family drift; returns the families
        whose relative drift (``max_rel``, scale-free across the price,
        volume-sum and correlation families) breached the tolerance,
        possibly none."""
        self.last = drift
        self.audits += 1
        breached: list[str] = []
        for family, v in drift.items():
            CARRY_DRIFT.labels(family=family).observe(v["max_abs"])
            CARRY_DRIFT_ULP.labels(family=family).set(v["max_ulp"])
            if v["compared"] > 0 and v.get("max_rel", 0.0) > self.tol:
                breached.append(family)
                CARRY_DRIFT_ALARMS.labels(family=family).inc()
        get_event_log().emit("carry_drift", drift=drift, tick_ms=tick_ms, trace_id=trace_id)
        if breached:
            self.alarms += 1
            get_event_log().emit(
                "carry_drift_alarm",
                families=sorted(breached),
                tol=self.tol,
                drift=drift,
                tick_ms=tick_ms,
                trace_id=trace_id,
                engine=snapshot_fn() if snapshot_fn is not None else {},
            )
        if self.record_history:
            self.history.append((tick_ms, drift, breached))
        return breached

    def note_skipped(self) -> None:
        """An audit tick the meter failed to measure (the engine logs the
        failure and the audit's resync proceeds)."""
        self.skipped += 1
