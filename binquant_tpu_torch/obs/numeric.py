"""Host side of the numeric-health digest and the carry-drift meter.

Port of ``NumericHealthMonitor`` and ``DriftMeter`` from
``binquant_tpu/obs/numeric.py``: the card computes the numeric digest
(``engine/step.py _numeric_digest_block``, on the wire) and the audit tick's
drift scalars (``measure_carry_drift``); these classes decode them, keep the
last values and counters, and give the budget and tolerance verdicts. The
reference's Prometheus instruments and event-log records belong to an
observability plane the port does not have: plain attributes take their
place, and ``record_history`` keeps every decoded value for equality drills
(tests, ``chip_smoke.py``).
"""

from __future__ import annotations

from typing import Any

import numpy as np

from binquant_tpu_torch.engine.step import decode_numeric_digest


class NumericHealthMonitor:
    """Per-engine digest consumer: decode each digest-carrying tick, keep
    the last decoded digest, and count the ticks whose leaked rows (NaN and
    Inf past the sufficiency gates) exceed ``nan_budget``."""

    def __init__(self, nan_budget: int = 0) -> None:
        self.nan_budget = int(nan_budget)
        self.last: dict | None = None
        self.ticks_seen = 0
        self.anomaly_ticks = 0
        self.record_history = False
        self.history: list[tuple[int | None, Any]] = []  # (tick_ms, raw block)

    def observe(self, digest_vec, tick_ms: int | None = None) -> dict:
        """Decode one tick's digest block; returns the decoded dict."""
        digest = decode_numeric_digest(digest_vec)
        self.last = digest
        self.ticks_seen += 1
        if self.record_history:
            self.history.append((tick_ms, np.asarray(digest_vec, np.float32).copy()))
        if digest["nan_total"] + digest["inf_total"] > self.nan_budget:
            self.anomaly_ticks += 1
        return digest


class DriftMeter:
    """Audit-tick drift consumer: the last measured drift, the audit and
    alarm counts, and the tolerance verdict on each family's
    scale-normalized drift (``max_rel``)."""

    def __init__(self, tol: float = 0.05) -> None:
        self.tol = float(tol)
        self.last: dict | None = None
        self.audits = 0
        self.alarms = 0
        self.skipped = 0  # audit ticks the meter could not measure
        self.record_history = False
        # (tick_ms, drift, breached families) per measured audit tick
        self.history: list[tuple[int | None, dict, list[str]]] = []

    def observe(self, drift: dict[str, dict[str, Any]], tick_ms: int | None = None) -> list[str]:
        """Record one audit tick's per-family drift; returns the families
        whose relative drift breached the tolerance (possibly none)."""
        self.last = drift
        self.audits += 1
        breached = [
            family for family, v in drift.items()
            if v["compared"] > 0 and v.get("max_rel", 0.0) > self.tol
        ]
        if breached:
            self.alarms += 1
        if self.record_history:
            self.history.append((tick_ms, drift, breached))
        return breached

    def note_skipped(self) -> None:
        """An audit tick the meter failed to measure (the engine logs the
        failure and the audit's resync proceeds)."""
        self.skipped += 1
