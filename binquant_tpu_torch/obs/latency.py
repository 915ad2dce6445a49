"""End-to-end latency observatory: freshness stamps + host-phase dwell.

Port of ``binquant_tpu/obs/latency.py``. Two host-side instruments:

* :class:`FreshnessTracker` — **how stale is a signal when it reaches a
  sink?** Every tick carries its evaluated candle-close time and its
  oldest pending candle's ingest-arrival stamp; finalize turns them into
  ``bqt_freshness_ms{stage}`` observations (close→dispatch,
  ingest→dispatch, dispatch→wire-fetch, close→emit, close→sink-ack) plus
  per-sink delivery histograms. A configured SLO
  (``Config.freshness_slo_ms``) force-emits a ``freshness_slo_breach``
  event, with the host-phase breakdown of the producing chunk and an
  engine snapshot, whenever a signal's worst close→sink-ack exceeds it.
  Mixed clocks by design: the ``close_to_*`` stages are *logical*
  (measured against the tick's own clock, exact live where tick time ≈
  wall clock, deterministic in replay), the ``ingest_to_dispatch`` /
  ``dispatch_to_*`` stages are real ``perf_counter`` deltas.

* :class:`PhaseAccountant` — **where do a drive's milliseconds go?** One
  phase taxonomy (:data:`PHASES` — plan, stack, dispatch, device_wait,
  decode, emit), recorded per drive into ``bqt_host_phase_ms{drive,phase}``,
  plus a per-chunk occupancy split: device-wait vs host-busy vs the dead
  gap neither accounts for, cumulative per drive and as
  ``bqt_chunk_occupancy_ratio`` gauges. ``device_wait`` brackets the wait
  on the wire copy's CUDA event, so on the card it is a *lower bound* on
  device busy time (work overlapping host phases is invisible to a host
  clock). The serial and pipelined drives close one chunk per
  ``process_tick``; the chunk methods also serve a scanned drive.

Both are on by default (``Config.freshness_enabled`` /
``Config.host_phase_enabled``). Disabled instances are no-ops, and nothing
here touches the device wire: with them off the sink payloads and event
records carry no freshness field.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Any, Callable

from binquant_tpu_torch.obs.events import get_event_log
from binquant_tpu_torch.obs.instruments import (
    CHUNK_OCCUPANCY,
    FRESHNESS,
    FRESHNESS_SLO_BREACHES,
    HOST_PHASE,
    SINK_DELIVERY,
)

#: The one phase taxonomy every drive reports (tests pin serial ==
#: scanned == backtest): plan (drain/route/per-tick planning), stack
#: (update packing + HostInputs build), dispatch (the jit launch),
#: device_wait (blocking wire fetch), decode (wire→FiredSignal,
#: dedupe, policy refresh), emit (sink dispatch).
PHASES = ("plan", "stack", "dispatch", "device_wait", "decode", "emit")

#: Freshness stages exported under bqt_freshness_ms{stage}.
FRESHNESS_STAGES = (
    "close_to_dispatch",
    "ingest_to_dispatch",
    "dispatch_to_fetch",
    "close_to_emit",
    "close_to_sink_ack",
)


class FreshnessTracker:
    """Candle-close→sink-ack freshness accounting for one engine."""

    def __init__(
        self, enabled: bool = True, slo_ms: float = 0.0, slo=None
    ) -> None:
        self.enabled = bool(enabled)
        # 0 disables the breach check (stamps still record when enabled)
        self.slo_ms = max(float(slo_ms), 0.0)
        # the unified SloRegistry: every observation also feeds the
        # "freshness" SLO's burn/recover model; the breach event below
        # fires either way
        self.slo = slo
        self.signals = 0
        self.breaches = 0
        # last observed value per stage (healthz introspection)
        self.last: dict[str, float] = {}

    def observe_stage(self, stage: str, ms: float) -> None:
        if not self.enabled:
            return
        ms = float(ms)
        FRESHNESS.labels(stage=stage).observe(ms)
        self.last[stage] = round(ms, 3)

    def observe_signal(
        self,
        strategy: str,
        symbol: str,
        close_to_emit_ms: float,
        sink_ack_ms: dict[str, float] | None = None,
        tick_ms: int | None = None,
        trace_id: str | None = None,
        phases: dict | None = None,
        snapshot_fn: Callable[[], dict] | None = None,
    ) -> float | None:
        """One emitted signal's freshness: records close→emit, per-sink
        delivery, and close→sink-ack (the worst sink); runs the SLO check.
        ``phases`` is the producing chunk's host-phase breakdown — a
        breach event must say where the milliseconds went, not just that
        they were spent. ``snapshot_fn`` is only called on a breach."""
        if not self.enabled:
            return None
        self.signals += 1
        self.observe_stage("close_to_emit", close_to_emit_ms)
        worst = float(close_to_emit_ms)
        for sink, ms in (sink_ack_ms or {}).items():
            ms = float(ms)
            SINK_DELIVERY.labels(sink=sink).observe(ms)
            worst = max(worst, ms)
        self.observe_stage("close_to_sink_ack", worst)
        breached = self.slo_ms > 0 and worst >= self.slo_ms
        if self.slo is not None and self.slo_ms > 0:
            self.slo.observe(
                "freshness",
                ok=not breached,
                worst_ms=round(worst, 3),
                strategy=strategy,
                symbol=symbol,
            )
        if breached:
            self.breaches += 1
            FRESHNESS_SLO_BREACHES.inc()
            get_event_log().emit(
                "freshness_slo_breach",
                strategy=strategy,
                symbol=symbol,
                close_to_sink_ack_ms=round(worst, 3),
                close_to_emit_ms=round(float(close_to_emit_ms), 3),
                slo_ms=self.slo_ms,
                sink_ack_ms={
                    k: round(float(v), 3)
                    for k, v in (sink_ack_ms or {}).items()
                },
                tick_ms=tick_ms,
                trace_id=trace_id,
                host_phases=phases or {},
                engine=snapshot_fn() if snapshot_fn is not None else {},
            )
        return worst

    def snapshot(self) -> dict:
        return {
            "enabled": self.enabled,
            "slo_ms": self.slo_ms,
            "signals": self.signals,
            "slo_breaches": self.breaches,
            "last_ms": dict(self.last),
        }


class PhaseAccountant:
    """Per-drive host-phase dwell totals + per-chunk occupancy splits."""

    def __init__(self, enabled: bool = True) -> None:
        self.enabled = bool(enabled)
        # drive -> phase -> [total_ms, count]
        self.totals: dict[str, dict[str, list]] = {}
        # drive -> cumulative occupancy tallies
        self.occupancy: dict[str, dict[str, float]] = {}
        # the newest chunk's full split (flight recorder / breach events)
        self.last_chunk: dict | None = None
        # drive -> marks at the OPEN chunk's start (begin_chunk); lets a
        # mid-chunk reader (an SLO breach fired during finalize) report
        # the PRODUCING chunk's split-so-far instead of the previous one
        self._open: dict[str, dict[str, float]] = {}

    def record(self, drive: str, phase: str, ms: float) -> None:
        if not self.enabled:
            return
        ms = float(ms)
        slot = self.totals.setdefault(drive, {}).setdefault(phase, [0.0, 0])
        slot[0] += ms
        slot[1] += 1
        HOST_PHASE.labels(drive=drive, phase=phase).observe(ms)

    @contextmanager
    def phase(self, drive: str, phase: str):
        """Time a block into ``record`` — free when disabled."""
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.record(drive, phase, (time.perf_counter() - t0) * 1000.0)

    def marks(self, drive: str) -> dict[str, float]:
        """Per-phase cumulative-ms snapshot — ``note_chunk`` diffs against
        it so a chunk's split only covers its own brackets."""
        return {p: s[0] for p, s in self.totals.get(drive, {}).items()}

    def begin_chunk(self, drive: str) -> None:
        """Open a chunk: snapshot the marks ``note_chunk`` will diff
        against, and make ``open_split`` report this chunk's phases."""
        if self.enabled:
            self._open[drive] = self.marks(drive)

    def _split_since(self, drive: str, marks: dict[str, float]) -> dict:
        now = self.marks(drive)
        phases = {
            p: round(now.get(p, 0.0) - marks.get(p, 0.0), 3)
            for p in set(now) | set(marks)
        }
        return {p: v for p, v in phases.items() if v}

    def open_split(self, drive: str) -> dict | None:
        """The OPEN chunk's per-phase dwell so far (``drive`` + phase
        deltas since ``begin_chunk``) — what an SLO breach fired mid-chunk
        attaches; None when no chunk is open (or disabled)."""
        marks = self._open.get(drive)
        if not self.enabled or marks is None:
            return None
        return {"drive": drive, **self._split_since(drive, marks)}

    def note_chunk(
        self, drive: str, wall_ms: float, ticks: int
    ) -> dict | None:
        """Close the open chunk's occupancy accounting: phase deltas since
        ``begin_chunk``, device-wait vs host-busy vs dead-gap against the
        chunk's wall clock (the serial drive calls this per tick)."""
        if not self.enabled:
            return None
        phases = self._split_since(drive, self._open.pop(drive, {}))
        device = phases.get("device_wait", 0.0)
        host = sum(v for p, v in phases.items() if p != "device_wait")
        dead = max(float(wall_ms) - device - host, 0.0)
        occ = {
            "drive": drive,
            "wall_ms": round(float(wall_ms), 3),
            "ticks": int(ticks),
            "device_wait_ms": round(device, 3),
            "host_ms": round(host, 3),
            "dead_gap_ms": round(dead, 3),
            "attributed_pct": (
                round(100.0 * (device + host) / wall_ms, 1)
                if wall_ms > 0
                else None
            ),
            "phases": phases,
        }
        self.last_chunk = occ
        agg = self.occupancy.setdefault(
            drive,
            {
                "wall_ms": 0.0,
                "device_wait_ms": 0.0,
                "host_ms": 0.0,
                "dead_gap_ms": 0.0,
                "chunks": 0,
                "ticks": 0,
            },
        )
        agg["wall_ms"] += float(wall_ms)
        agg["device_wait_ms"] += device
        agg["host_ms"] += host
        agg["dead_gap_ms"] += dead
        agg["chunks"] += 1
        agg["ticks"] += int(ticks)
        if wall_ms > 0:
            for component, value in (
                ("device_wait", device),
                ("host", host),
                ("dead_gap", dead),
            ):
                CHUNK_OCCUPANCY.labels(drive=drive, component=component).set(
                    round(value / wall_ms, 4)
                )
        return occ

    def reset(self) -> None:
        """Drop totals (benches reuse one engine across warmup/measure;
        the global histogram mirror is cumulative by design)."""
        self.totals.clear()
        self.occupancy.clear()
        self.last_chunk = None
        self._open.clear()

    def snapshot(self) -> dict:
        phase_ms: dict[str, dict[str, Any]] = {}
        for drive, by_phase in self.totals.items():
            phase_ms[drive] = {
                p: {"total_ms": round(s[0], 3), "count": s[1]}
                for p, s in by_phase.items()
            }
        occupancy: dict[str, dict[str, Any]] = {}
        for drive, agg in self.occupancy.items():
            wall = agg["wall_ms"]
            occupancy[drive] = {
                "wall_ms": round(wall, 3),
                "device_wait_ms": round(agg["device_wait_ms"], 3),
                "host_ms": round(agg["host_ms"], 3),
                "dead_gap_ms": round(agg["dead_gap_ms"], 3),
                "chunks": int(agg["chunks"]),
                "ticks": int(agg["ticks"]),
                "attributed_pct": (
                    round(
                        100.0
                        * (agg["device_wait_ms"] + agg["host_ms"])
                        / wall,
                        1,
                    )
                    if wall > 0
                    else None
                ),
            }
        return {
            "enabled": self.enabled,
            "phase_ms": phase_ms,
            "occupancy": occupancy,
            "last_chunk": self.last_chunk,
        }
