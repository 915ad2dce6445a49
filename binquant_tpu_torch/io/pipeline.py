"""The signal engine: ingest → device tick → emission, on one card.

A lean port of ``binquant_tpu/io/pipeline.py``'s ``SignalEngine`` for the
classic live tick at ``pipeline_depth=0``. Candles accumulate in two
:class:`IngestBatcher` s between ticks; ``process_tick`` drains them, folds
every sub-batch but the last into the rings (:meth:`_fold_updates`), runs ONE
classic wire step on the last, fetches the one float32 wire, and emits the
fired rows through the sinks after the once-per-bar dedupe.

Host carries feeding the step: the grid-only policy (resolved from the
previous tick's regime and the breadth series), the London quiet window of
the evaluated tick's clock, and the breadth scalars of a static breadth
series (the stub's; the REST client is not ported). Method names and call
shapes follow the reference engine, ``async def process_tick`` included.
"""

from __future__ import annotations

import math
import time
from datetime import datetime, timezone
from typing import Any, NamedTuple

import numpy as np
import torch

from binquant_tpu_torch import resolve_device
from binquant_tpu_torch.config import Config
from binquant_tpu_torch.engine.buffer import IngestBatcher, NUM_FIELDS, SymbolRegistry
from binquant_tpu_torch.engine.step import (
    EMISSION_LAYOUTS,
    FIVE_MIN_STRATEGIES,
    LIVE_STRATEGIES,
    HostInputs,
    apply_updates_step,
    initial_engine_state,
    tick_step,
    tick_step_wire,
    unpack_wire,
)
from binquant_tpu_torch.io.emission import RecordingSinks, extract_fired
from binquant_tpu_torch.regime.context import ContextConfig
from binquant_tpu_torch.regime.grid_policy import GridOnlyPolicy
from binquant_tpu_torch.regime.time_filter import is_quiet_hours
from binquant_tpu_torch.schemas import MarketBreadthSeries

FIFTEEN_MIN_S = 900
FIVE_MIN_S = 300


def breadth_scalars(
    mb: MarketBreadthSeries | None,
) -> tuple[float, float, float, float, float]:
    """(adp_latest, adp_prev, adp_diff, adp_diff_prev, momentum_points) from
    a market-breadth series."""
    nan = float("nan")
    if mb is None or len(mb.timestamp) < 2:
        return nan, nan, nan, nan, nan
    values = [nan if v is None else float(v) for v in mb.market_breadth]
    adp_latest = values[-1] if values else nan
    adp_prev = values[-2] if len(values) >= 2 else nan
    adp_diff = values[-1] - values[-2] if len(values) >= 2 else nan
    adp_diff_prev = values[-2] - values[-3] if len(values) >= 3 else nan
    ma = [
        float(v)
        for v in mb.market_breadth_ma
        if v is not None and math.isfinite(float(v))
    ]
    momentum = (ma[-1] - ma[-2]) * 100 if len(ma) >= 2 else (
        (values[-1] - values[-2]) * 100 if len(values) >= 2 else nan
    )
    return adp_latest, adp_prev, adp_diff, adp_diff_prev, momentum


class _PendingTick(NamedTuple):
    wire: torch.Tensor
    fallback: Any  # () -> TickOutputs, for a compaction overflow
    ts_ms: int
    ts5: int
    ts15: int
    bucket15: int
    rows: Any  # FrozenRows as of dispatch


class SignalEngine:
    """Owns the device state and drives classic ticks from queued klines."""

    def __init__(
        self,
        config: Config | None = None,
        sinks: RecordingSinks | None = None,
        registry: SymbolRegistry | None = None,
        window: int | None = None,
        device: str | torch.device | None = None,
        context_config: ContextConfig = ContextConfig(),
        btc_symbol: str = "BTCUSDT",
        enabled_strategies: set[str] | None = None,
        pipeline_depth: int = 0,
        breadth: dict | None = None,
        market_type: str = "FUTURES",
        exchange: str = "binance",
    ) -> None:
        self.device = resolve_device(device)
        if int(pipeline_depth) != 0:
            raise ValueError("this engine runs the serial path only (pipeline_depth=0)")
        self.config = config or Config()
        self.sinks = sinks if sinks is not None else RecordingSinks()
        self.capacity = int(self.config.max_symbols)
        self.window = int(window if window is not None else self.config.window_bars)
        self.registry = registry or SymbolRegistry(self.capacity)
        self.batcher5 = IngestBatcher(self.registry)
        self.batcher15 = IngestBatcher(self.registry)
        self.state = initial_engine_state(self.capacity, self.window, device=self.device)
        self.context_config = context_config
        self.btc_symbol = btc_symbol
        self.enabled_strategies = (
            None if enabled_strategies is None else frozenset(enabled_strategies)
        )
        self.pipeline_depth = 0
        self.market_type = market_type
        self.exchange = exchange
        self._breadth_payload = breadth
        self.market_breadth: MarketBreadthSeries | None = None
        self._last_breadth_bucket = -1
        self.grid_only_policy = GridOnlyPolicy.disabled("not_evaluated")
        # per-bar emission dedupe: (strategy, symbol) -> last emitted bar ts
        self._last_emitted: dict[tuple[str, str], int] = {}
        self._tracked_cache: tuple[int, torch.Tensor] | None = None
        self.tick_wall_ms: list[float] = []
        # the last fetched wire (host numpy), for inspection and comparison
        self.last_wire: np.ndarray | None = None

    # -- ingest ---------------------------------------------------------------

    def ingest(self, kline: dict) -> None:
        """Route one closed candle to its interval batcher by bar duration;
        anything but 5m/15m is dropped."""
        duration_s = (int(kline["close_time"]) - int(kline["open_time"])) // 1000
        if abs(duration_s - FIVE_MIN_S) <= 1:
            self.batcher5.add(kline)
        elif abs(duration_s - FIFTEEN_MIN_S) <= 1:
            self.batcher15.add(kline)

    def _to_device(self, batch) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        rows, ts, vals = batch
        return (
            torch.from_numpy(np.ascontiguousarray(rows, dtype=np.int32)).to(self.device),
            torch.from_numpy(np.ascontiguousarray(ts, dtype=np.int32)).to(self.device),
            torch.from_numpy(np.ascontiguousarray(vals, dtype=np.float32)).to(self.device),
        )

    def _empty_updates(self):
        return self._to_device(
            (np.zeros(0, np.int32), np.zeros(0, np.int32),
             np.zeros((0, NUM_FIELDS), np.float32))
        )

    def _fold_updates(self, batches5: list, batches15: list):
        """Apply all but the FINAL sub-batch pair with the update-only step
        (ordered replay — evaluating each would advance the dedupe carries
        and discard earlier signals); return the final pair to evaluate."""
        empty = self._empty_updates()
        upd5 = [self._to_device(b) for b in batches5] or [empty]
        upd15 = [self._to_device(b) for b in batches15] or [empty]
        n = max(len(upd5), len(upd15))
        for i in range(n - 1):
            self.state = apply_updates_step(
                self.state,
                upd5[i] if i < len(upd5) else empty,
                upd15[i] if i < len(upd15) else empty,
            )
        return (
            upd5[n - 1] if n - 1 < len(upd5) else empty,
            upd15[n - 1] if n - 1 < len(upd15) else empty,
        )

    # -- host carries ---------------------------------------------------------

    async def _refresh_market_breadth(self, bucket: int) -> None:
        if bucket == self._last_breadth_bucket:
            return
        self._last_breadth_bucket = bucket
        self.market_breadth = MarketBreadthSeries.from_payload(self._breadth_payload)

    def _tracked_mask(self) -> torch.Tensor:
        cached = self._tracked_cache
        if cached is not None and cached[0] == self.registry.version:
            return cached[1]
        mask = torch.from_numpy(self.registry.active_rows).to(self.device)
        self._tracked_cache = (self.registry.version, mask)
        return mask

    def _host_inputs(self, btc_row: int, ts15: int, ts5: int, quiet: bool) -> HostInputs:
        """The tick's HostInputs: every scalar in three small H2D copies."""
        adp_latest, adp_prev, adp_diff, adp_diff_prev, momentum = breadth_scalars(
            self.market_breadth
        )
        f = torch.tensor(
            [adp_latest, adp_prev, adp_diff, adp_diff_prev, momentum],
            dtype=torch.float32,
        ).to(self.device)
        i = torch.tensor([btc_row, ts15, ts5], dtype=torch.int32).to(self.device)
        b = torch.tensor(
            [
                quiet,
                self.grid_only_policy.allow_grid_ladder,
                str(self.market_type).upper().endswith("FUTURES"),
                False,  # dominance_is_losers: NEUTRAL
                False,  # market_domination_reversal
            ],
            dtype=torch.bool,
        ).to(self.device)
        return HostInputs(
            tracked=self._tracked_mask(),
            btc_row=i[0],
            timestamp_s=i[1],
            timestamp5_s=i[2],
            oi_growth=torch.full(
                (self.capacity,), float("nan"), dtype=torch.float32, device=self.device
            ),
            adp_latest=f[0],
            adp_prev=f[1],
            adp_diff=f[2],
            adp_diff_prev=f[3],
            breadth_momentum_points=f[4],
            quiet_hours=b[0],
            grid_policy_allows=b[1],
            is_futures=b[2],
            dominance_is_losers=b[3],
            market_domination_reversal=b[4],
        )

    def _wire_enabled_key(self) -> tuple[str, ...]:
        return tuple(
            sorted(
                LIVE_STRATEGIES
                if self.enabled_strategies is None
                else self.enabled_strategies
            )
        )

    # -- the tick ---------------------------------------------------------------

    async def process_tick(self, now_ms: int | None = None) -> list:
        """One tick: dispatch (drain → fold → wire step) and, at depth 0,
        finalize the same tick (wire fetch → emission). Returns the emitted
        signals, each stamped with ``tick_ms``."""
        t0 = time.perf_counter()
        ts_ms = now_ms if now_ms is not None else int(time.time() * 1000)
        pending = await self._dispatch_tick_inner(ts_ms)
        fired = await self._finalize_tick_inner(pending)
        self.tick_wall_ms.append((time.perf_counter() - t0) * 1000.0)
        return fired

    async def flush_pending(self) -> list:
        """Finalize every in-flight tick. At depth 0 each ``process_tick``
        finalizes its own tick, so nothing is ever in flight."""
        return []

    async def _dispatch_tick_inner(self, ts_ms: int) -> _PendingTick:
        ts_s = ts_ms // 1000
        # evaluate against the bar that just CLOSED
        bucket15 = ts_s // FIFTEEN_MIN_S
        ts15 = bucket15 * FIFTEEN_MIN_S - FIFTEEN_MIN_S
        ts5 = (ts_s // FIVE_MIN_S) * FIVE_MIN_S - FIVE_MIN_S
        await self._refresh_market_breadth(bucket15)

        batches5 = self.batcher5.drain()
        batches15 = self.batcher15.drain()
        # the window reads the EVALUATED tick time, so replays are deterministic
        quiet = is_quiet_hours(now=datetime.fromtimestamp(ts_ms / 1000, tz=timezone.utc))
        btc = self.registry.row_of(self.btc_symbol)
        btc_row = -1 if btc is None else int(btc)

        u5, u15 = self._fold_updates(batches5, batches15)
        inputs = self._host_inputs(btc_row, ts15, ts5, quiet)
        prev_state = self.state
        cfg, key = self.context_config, self._wire_enabled_key()
        self.state, wire = tick_step_wire(prev_state, u5, u15, inputs, cfg, wire_enabled=key)

        def fallback(_args=(prev_state, u5, u15, inputs, cfg, key)):
            st, a, b, inp, cfg_, key_ = _args
            _, full = tick_step(st, a, b, inp, cfg_, wire_enabled=key_)
            return full

        return _PendingTick(
            wire=wire,
            fallback=fallback,
            ts_ms=ts_ms,
            ts5=ts5,
            ts15=ts15,
            bucket15=bucket15,
            rows=self.registry.frozen_rows(),
        )

    async def _finalize_tick_inner(self, pending: _PendingTick) -> list:
        ts5, ts15 = pending.ts5, pending.ts15
        # ONE device fetch per tick: the packed wire
        self.last_wire = pending.wire.cpu().numpy()
        unpacked = unpack_wire(self.last_wire)
        fired_w, ctx = unpacked
        outputs = None
        if fired_w.overflow:
            outputs = pending.fallback()
        regime = ctx["market_regime"]
        has_ctx = ctx["valid"]
        self.grid_only_policy = GridOnlyPolicy.resolve(
            regime if has_ctx else None, self.market_breadth
        )
        fired = extract_fired(
            outputs,
            pending.rows,
            env=self.config.env,
            exchange=self.exchange,
            market_type=self.market_type,
            enabled=self.enabled_strategies,
            skip=lambda strategy, row: self._already_emitted(
                strategy, pending.rows.name_of(row), ts5, ts15
            ),
            unpacked=unpacked,
            diag_layout=EMISSION_LAYOUTS.get(self._wire_enabled_key()),
        )
        fired = self._dedupe_fired(fired, ts5, ts15)
        for signal in fired:
            signal.tick_ms = pending.ts_ms
            self.sinks.dispatch(signal)
        return fired

    def _already_emitted(
        self, strategy: str, symbol: str | None, ts5: int, ts15: int
    ) -> bool:
        """Whether this (strategy, symbol) already emitted for the bar being
        evaluated (keyed by symbol name: registry rows are recycled)."""
        if symbol is None:
            return True
        bar_ts = ts5 if strategy in FIVE_MIN_STRATEGIES else ts15
        return self._last_emitted.get((strategy, symbol)) == bar_ts

    def _dedupe_fired(self, fired: list, ts5: int, ts15: int) -> list:
        """Once-per-bar emission dedupe (mark + filter)."""
        kept = []
        for signal in fired:
            bar_ts = ts5 if signal.strategy in FIVE_MIN_STRATEGIES else ts15
            key = (signal.strategy, signal.symbol)
            if self._last_emitted.get(key) == bar_ts:
                continue
            self._last_emitted[key] = bar_ts
            kept.append(signal)
        return kept
