"""Host side of the ingest-health digest.

Port of the digest half of ``IngestHealthMonitor``
(``binquant_tpu/obs/ingest.py``): the card computes the per-tick ingest
digest (``engine/step.py _ingest_digest_block``, on the wire, after the
numeric digest); this class decodes it, keeps the last digest, and runs the
staleness budget: a tick whose 1x-stale rows (both intervals) exceed
``stale_budget`` is an anomaly tick, a run of them is a burn, and the first
clean tick after a burn is a recovery. Engine-level row churn is counted
(:meth:`note_churn`). The reference's per-symbol watermarks, SLO registry,
Prometheus instruments and event records are not ported; plain attributes
take their place, and ``record_history`` keeps every raw block for
equality drills.
"""

from __future__ import annotations

import numpy as np

from binquant_tpu_torch.engine.step import decode_ingest_digest


class IngestHealthMonitor:
    """Per-engine ingest-digest consumer."""

    def __init__(self, enabled: bool = True, stale_budget: int = 0) -> None:
        self.enabled = bool(enabled)
        self.stale_budget = int(stale_budget)
        self.last: dict | None = None
        self.ticks_seen = 0
        self.anomaly_ticks = 0
        self.recoveries = 0
        self.burning = False
        self.burn_ticks = 0  # length of the current burn
        self.churn_total = 0
        self.record_history = False
        self.digests: list[np.ndarray] = []

    def note_churn(self, count: int = 1) -> None:
        """Engine-level churn marks (a drain claimed new registry rows, or
        rows were pruned)."""
        if self.enabled:
            self.churn_total += int(count)

    def observe_digest(self, digest_vec) -> dict:
        """Decode one finalized tick's ingest block; returns the dict."""
        digest = decode_ingest_digest(digest_vec)
        if self.record_history:
            self.digests.append(np.asarray(digest_vec, np.float32).copy())
        self.last = digest
        self.ticks_seen += 1
        burning = digest["stale_total"] > self.stale_budget
        if burning:
            self.anomaly_ticks += 1
            self.burn_ticks += 1
        else:
            if self.burning:
                self.recoveries += 1
            self.burn_ticks = 0
        self.burning = burning
        return digest
