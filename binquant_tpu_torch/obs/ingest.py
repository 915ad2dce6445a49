"""Host side of the ingest-health observatory.

Port of ``binquant_tpu/obs/ingest.py``. The card computes the per-tick
ingest digest (``engine/step.py _ingest_digest_block``, on the wire, after
the numeric digest); this module decodes it and keeps the per-symbol
stream-health bookkeeping no per-tick aggregate can carry:

* **watermarks** — per registry row, the exchange event time of the newest
  candle seen (``close_time``), its host wall-clock arrival, and the wall
  clock of the tick that applied it (exchange → arrival → apply);
* **per-symbol counters** — appends, gap appends (a bucket skipped), host
  out-of-order/rewrite deliveries, and row churn (a known symbol re-homed
  to a different row by listing churn);
* **per-exchange feed lag** — arrival minus candle close, one histogram
  observation per ingested candle, and the newest close per exchange
  (:meth:`IngestHealthMonitor.exchange_watermarks`);
* **a health score** per symbol (worst-first ranking for the paginated
  ``GET /debug/symbols`` route): staleness relative to the market's
  freshest row, discounted by the row's gap/out-of-order history.

Digest decode drives the ``bqt_ingest_*`` families, the ``/healthz``
``ingest`` section and the staleness SLO: a tick whose 1x-stale row total
exceeds ``stale_budget`` is an anomaly tick (``ingest_anomaly``
force-emitted on burn entry and every ``event_every`` burning ticks;
``ingest_recovered`` on the first clean tick after a burn); healthy digests
are sampled as ``ingest_digest`` events every ``event_every`` ticks.
``record_history`` keeps every raw block for equality drills.
:meth:`IngestHealthMonitor.snapshot_state` / :meth:`restore_state` rewind
the per-row counters and watermarks to a chunk plan's start, so an
overflow re-drive of the scanned or backtest drive counts each candle once.
"""

from __future__ import annotations

import time
from typing import Callable

import numpy as np

from binquant_tpu_torch.engine.step import decode_ingest_digest
from binquant_tpu_torch.obs.events import get_event_log
from binquant_tpu_torch.obs.instruments import (
    INGEST_ANOMALIES,
    INGEST_APPLIED,
    INGEST_CHURN,
    INGEST_COVERAGE,
    INGEST_FEED_LAG,
    INGEST_MAX_AGE,
    INGEST_OOO,
    INGEST_STALE,
    INGEST_TRACKED,
)

_INTERVAL_S = {"5m": 300, "15m": 900}


class IngestHealthMonitor:
    """Per-engine ingest-health consumer + per-symbol watermark store."""

    def __init__(
        self,
        registry,
        enabled: bool = True,
        stale_budget: int = 0,
        event_every: int = 256,
        slo=None,
    ) -> None:
        self.registry = registry
        self.enabled = bool(enabled)
        self.stale_budget = int(stale_budget)
        # the unified SloRegistry: each digest also feeds the "staleness"
        # SLO's burn/recover model; ingest_anomaly/ingest_recovered events
        # fire either way
        self.slo = slo
        self.event_every = max(int(event_every), 1)
        cap = registry.capacity
        # per-row counters + watermarks (the row→symbol mapping is the
        # registry's; `names` mirrors it so re-homed rows are detected)
        self.appends = np.zeros(cap, np.int64)
        self.gaps = np.zeros(cap, np.int64)
        self.rewrites = np.zeros(cap, np.int64)
        self.out_of_order = np.zeros(cap, np.int64)
        self.churn = np.zeros(cap, np.int64)
        self.last_event_ms = np.full(cap, -1, np.int64)
        self.last_arrival_wall_ms = np.full(cap, np.nan, np.float64)
        self.last_apply_wall_ms = np.full(cap, np.nan, np.float64)
        self.latest_s = {
            "5m": np.full(cap, -1, np.int64),
            "15m": np.full(cap, -1, np.int64),
        }
        self.names: list[str | None] = [None] * cap
        # -1 forces the first reconcile: symbols registered BEFORE the
        # monitor was constructed (backfill, restored checkpoints) must
        # still appear in the name mirror
        self._registry_version = -1
        # digest-side state
        self.last: dict | None = None
        self.last_tick_ms: int | None = None
        self.anomaly_ticks = 0
        self.recoveries = 0
        self.burning = False
        self._burn_ticks = 0
        self._ticks_seen = 0
        self.churn_total = 0
        self.arrivals = 0
        self.feed_lag_last_ms: dict[str, float] = {}
        # per-exchange newest candle close ever seen — the watermark a
        # soak judge reads DURING an exchange-scoped outage, when
        # feed_lag_last_ms (a per-arrival measurement) goes quiet
        self.exchange_close_ms: dict[str, int] = {}
        # raw digest capture for equality drills (tests/scenarios only)
        self.record_history = False
        self.digests: list = []

    # -- per-candle / per-batch feeds ----------------------------------------

    def note_arrival(
        self,
        symbol: str,
        close_ms: int,
        exchange: str = "binance",
        now_ms: float | None = None,
    ) -> None:
        """One candle arrived at the host (``SignalEngine.ingest``)."""
        if not self.enabled:
            return
        now_ms = time.time() * 1000.0 if now_ms is None else float(now_ms)
        lag = now_ms - float(close_ms)
        INGEST_FEED_LAG.labels(exchange=exchange).observe(max(lag, 0.0))
        self.feed_lag_last_ms[exchange] = lag
        if int(close_ms) > self.exchange_close_ms.get(exchange, 0):
            self.exchange_close_ms[exchange] = int(close_ms)
        self.arrivals += 1
        row = self.registry.row_of(symbol)
        if row is None:
            return  # row claimed at drain; the apply feed establishes it
        if close_ms > self.last_event_ms[row]:
            self.last_event_ms[row] = int(close_ms)
        self.last_arrival_wall_ms[row] = now_ms

    def exchange_watermarks(self, now_ms: float) -> dict[str, float]:
        """Per-exchange feed-lag watermark vs NOW: how far behind ``now``
        each exchange's newest candle close is. Unlike
        ``feed_lag_last_ms`` (a measurement taken at arrival time, frozen
        when a feed dies), this keeps growing through an exchange-scoped
        outage — the surface a soak drill asserts diverges during a
        kucoin-only feed death while binance stays fresh."""
        return {
            ex: float(now_ms) - float(close)
            for ex, close in self.exchange_close_ms.items()
        }

    def note_applied_batch(
        self,
        interval: str,
        rows: np.ndarray,
        ts_s: np.ndarray,
        prev_latest_s: np.ndarray,
        now_ms: float | None = None,
    ) -> None:
        """One applied update sub-batch, classified against the HOST
        latest-ts mirror (the pre-apply per-row state the device's own
        routing sees): strictly-newer → append (gap when it skipped at
        least one whole bucket), at the latest bar → rewrite, behind it →
        out-of-order. Called by ``SignalEngine._note_applied`` on commit,
        in apply order."""
        if not self.enabled or len(rows) == 0:
            return
        now_ms = time.time() * 1000.0 if now_ms is None else float(now_ms)
        interval_s = _INTERVAL_S[interval]
        self._reconcile_names()
        appended = ts_s > prev_latest_s
        gap = appended & (prev_latest_s >= 0) & (
            ts_s - prev_latest_s > interval_s
        )
        rewrite = ts_s == prev_latest_s
        ooo = ts_s < prev_latest_s
        np.add.at(self.appends, rows[appended], 1)
        np.add.at(self.gaps, rows[gap], 1)
        np.add.at(self.rewrites, rows[rewrite], 1)
        np.add.at(self.out_of_order, rows[ooo], 1)
        n_ooo = int(np.count_nonzero(rewrite | ooo))
        if n_ooo:
            INGEST_OOO.labels(interval=interval).inc(n_ooo)
        latest = self.latest_s[interval]
        np.maximum.at(latest, rows, ts_s)
        self.last_apply_wall_ms[rows] = now_ms

    def note_churn(self, count: int = 1) -> None:
        """Engine-level churn marks (a drain claimed new registry rows)."""
        if not self.enabled:
            return
        self.churn_total += int(count)
        INGEST_CHURN.inc(count)

    def _reconcile_names(self) -> None:
        """Detect row re-homing lazily on registry version moves: a row
        whose occupant name changed resets its per-row stats (they belong
        to the departed symbol) and counts churn — O(capacity) once per
        membership change, zero on the steady path."""
        if self.registry.version == self._registry_version:
            return
        self._registry_version = self.registry.version
        for row in range(self.registry.capacity):
            name = self.registry.name_of(row)
            if name == self.names[row]:
                continue
            if self.names[row] is not None:
                # the row was re-assigned: the newcomer starts clean
                self.churn[row] += 1
                self.churn_total += 1
                INGEST_CHURN.inc()
                self.appends[row] = self.gaps[row] = 0
                self.rewrites[row] = self.out_of_order[row] = 0
                self.last_event_ms[row] = -1
                self.last_arrival_wall_ms[row] = np.nan
                self.last_apply_wall_ms[row] = np.nan
                for latest in self.latest_s.values():
                    latest[row] = -1
            self.names[row] = name

    # -- digest decode + SLO --------------------------------------------------

    # -- chunk-plan rewind ------------------------------------------------------

    # churn deliberately EXCLUDED: it fires on registry-version moves, which
    # a serial re-drive never replays (the rows stay claimed), so rewinding
    # it would erase it
    _SNAP_ARRAYS = (
        "appends", "gaps", "rewrites", "out_of_order",
        "last_event_ms", "last_arrival_wall_ms", "last_apply_wall_ms",
    )

    def snapshot_state(self) -> dict | None:
        """Copy of the rewindable per-row state (a chunk plan's anchor)."""
        if not self.enabled:
            return None
        snap = {k: getattr(self, k).copy() for k in self._SNAP_ARRAYS}
        snap["latest_s"] = {k: v.copy() for k, v in self.latest_s.items()}
        return snap

    def restore_state(self, snap: dict | None) -> None:
        """Rewind to a plan-start snapshot before a serial re-drive replays
        the plan's ticks; churn is not rewound (see ``_SNAP_ARRAYS``)."""
        if not self.enabled or snap is None:
            return
        for k in self._SNAP_ARRAYS:
            getattr(self, k)[:] = snap[k]
        for k, v in snap["latest_s"].items():
            self.latest_s[k][:] = v

    def observe_digest(
        self,
        digest_vec,
        tick_ms: int | None = None,
        trace_id: str | None = None,
        snapshot_fn: Callable[[], dict] | None = None,
    ) -> dict:
        """Decode one finalized tick's ingest block; returns the dict."""
        digest = decode_ingest_digest(digest_vec)
        if self.record_history:
            self.digests.append(np.asarray(digest_vec, np.float32).copy())
        self.last = digest
        self.last_tick_ms = tick_ms
        self._ticks_seen += 1

        INGEST_TRACKED.set(digest["tracked"])
        for interval in ("5m", "15m"):
            sect = digest[interval]
            for bucket in ("1x", "3x", "10x"):
                INGEST_STALE.labels(interval=interval, bucket=bucket).set(
                    sect[f"stale_{bucket}"]
                )
            for stage in ("covered", "min_bars", "fresh"):
                INGEST_COVERAGE.labels(interval=interval, stage=stage).set(
                    sect[stage]
                )
            INGEST_MAX_AGE.labels(interval=interval).set(
                sect["max_age_s"] or 0.0
            )
            for kind, field in (
                ("append", "appends"),
                ("rewrite", "rewrites"),
                ("gap_append", "gap_appends"),
                ("dropped", "dropped"),
            ):
                if sect[field]:
                    INGEST_APPLIED.labels(
                        interval=interval, kind=kind
                    ).inc(sect[field])

        burning = digest["stale_total"] > self.stale_budget
        if self.slo is not None:
            self.slo.observe(
                "staleness",
                ok=not burning,
                stale_rows=digest["stale_total"],
                budget=self.stale_budget,
            )
        if burning:
            self.anomaly_ticks += 1
            self._burn_ticks += 1
            INGEST_ANOMALIES.inc()
            if not self.burning or self._burn_ticks % self.event_every == 0:
                # force-emit, flight-recorder style, on burn ENTRY (then
                # re-emit at the sampling cadence — a multi-tick outage
                # must not flood one event per stale tick)
                get_event_log().emit(
                    "ingest_anomaly",
                    stale_rows=digest["stale_total"],
                    budget=self.stale_budget,
                    digest=digest,
                    worst_symbols=self.symbols_report(limit=8)["symbols"],
                    tick_ms=tick_ms,
                    trace_id=trace_id,
                    engine=snapshot_fn() if snapshot_fn is not None else {},
                )
        else:
            if self.burning:
                self.recoveries += 1
                get_event_log().emit(
                    "ingest_recovered",
                    burn_ticks=self._burn_ticks,
                    digest=digest,
                    tick_ms=tick_ms,
                    trace_id=trace_id,
                )
            elif self._ticks_seen % self.event_every == 0:
                get_event_log().emit(
                    "ingest_digest", digest=digest, tick_ms=tick_ms
                )
            self._burn_ticks = 0
        self.burning = burning
        return digest

    # -- reports --------------------------------------------------------------

    def _health_score(
        self, row: int, frontier_s: dict[str, int]
    ) -> float:
        """Deterministic [0, 1] heuristic for worst-first ranking: 1 /
        (1 + buckets-behind-the-market-frontier), discounted by the row's
        gap and out-of-order/rewrite history. A fresh clean feed reads
        1.0; a feed a day behind on 5m reads ~0.003."""
        behind = 0.0
        for interval, interval_s in _INTERVAL_S.items():
            latest = self.latest_s[interval][row]
            frontier = frontier_s.get(interval, -1)
            if latest >= 0 and frontier > latest:
                behind = max(
                    behind, (frontier - latest) / interval_s - 1.0
                )
            elif latest < 0 and frontier >= 0:
                behind = max(behind, 10.0)  # tracked but never delivered
        noise = 0.1 * self.gaps[row] + 0.05 * (
            self.rewrites[row] + self.out_of_order[row]
        )
        return 1.0 / (1.0 + max(behind, 0.0)) / (1.0 + noise)

    def symbols_report(
        self,
        offset: int = 0,
        limit: int = 50,
        prefix: str | None = None,
        min_score: float | None = None,
    ) -> dict:
        """Worst-first per-symbol scoreboard (the ``GET /debug/symbols``
        payload): filterable by symbol prefix and maximum health score
        (``min_score`` keeps rows AT OR BELOW it — the unhealthy tail),
        paginated with ``offset``/``limit``."""
        self._reconcile_names()
        frontier = {
            k: int(v.max()) if v.size else -1
            for k, v in self.latest_s.items()
        }
        now_ms = time.time() * 1000.0
        rows = []
        for row, name in enumerate(self.names):
            if name is None:
                continue
            if prefix and not name.startswith(prefix.upper()):
                continue
            score = self._health_score(row, frontier)
            if min_score is not None and score > min_score:
                continue
            rows.append((score, name, row))
        rows.sort(key=lambda r: (r[0], r[1]))
        total = len(rows)
        page = rows[max(offset, 0) : max(offset, 0) + max(limit, 0)]
        out = []
        for score, name, row in page:
            age_s = {
                interval: (
                    None
                    if self.latest_s[interval][row] < 0
                    or frontier[interval] < 0
                    else int(frontier[interval] - self.latest_s[interval][row])
                )
                for interval in _INTERVAL_S
            }
            arrival = self.last_arrival_wall_ms[row]
            applied = self.last_apply_wall_ms[row]
            out.append(
                {
                    "symbol": name,
                    "row": row,
                    "score": round(float(score), 4),
                    "age_s": age_s,
                    "appends": int(self.appends[row]),
                    "gaps": int(self.gaps[row]),
                    "rewrites": int(self.rewrites[row]),
                    "out_of_order": int(self.out_of_order[row]),
                    "churn": int(self.churn[row]),
                    "last_event_ms": (
                        None
                        if self.last_event_ms[row] < 0
                        else int(self.last_event_ms[row])
                    ),
                    "arrival_age_s": (
                        None
                        if arrival != arrival
                        else round((now_ms - arrival) / 1000.0, 1)
                    ),
                    "apply_age_s": (
                        None
                        if applied != applied
                        else round((now_ms - applied) / 1000.0, 1)
                    ),
                }
            )
        return {
            "total": total,
            "offset": max(offset, 0),
            "limit": max(limit, 0),
            "frontier_s": frontier,
            "symbols": out,
        }

    def snapshot(self) -> dict:
        """The /healthz ``ingest`` section (attribute reads + one cheap
        aggregate; safe inline on the event loop)."""
        status = "ok"
        if not self.enabled:
            status = "off"
        elif self.burning:
            status = "degraded"
        return {
            "enabled": self.enabled,
            "status": status,
            "stale_budget": self.stale_budget,
            "anomaly_ticks": self.anomaly_ticks,
            "recoveries": self.recoveries,
            "burning": self.burning,
            "arrivals": self.arrivals,
            "churn": self.churn_total,
            "feed_lag_last_ms": {
                k: round(v, 1) for k, v in self.feed_lag_last_ms.items()
            },
            "exchange_close_ms": dict(self.exchange_close_ms),
            "last_digest": self.last,
        }
