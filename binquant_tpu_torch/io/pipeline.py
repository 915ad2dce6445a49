"""The signal engine: ingest → device tick → emission, on one card.

A lean port of ``binquant_tpu/io/pipeline.py``'s ``SignalEngine`` for the
live tick. Candles accumulate in two :class:`IngestBatcher` s between
ticks; a tick drains them, folds every sub-batch but the last into the
rings (:meth:`_fold_updates`), runs ONE wire step on the last, copies the
one float32 wire to the host, and emits the fired rows through the sinks
after the once-per-bar dedupe.

The pipelined loop (``pipeline_depth``, production 1): ``process_tick``
first finalizes in-flight ticks while ``depth`` (at least one) are pending,
then dispatches the new tick, and at depth 0 finalizes that same tick. The
dispatch starts the wire's copy into a pinned host buffer (a rotation of
``depth + 1``, so a buffer is never overwritten before its tick is read)
and records a CUDA event; finalize waits on the event and decodes. So at
depth 1 the host never waits for the tick it just dispatched, and the host
carries feeding tick i (grid-only policy) still lag one tick, as at depth
0. ``flush_pending`` finalizes what is in flight; ``emit_ready`` lands the
oldest in-flight tick now instead of at the next call. Nothing between
dispatch and finalize reads the card: the overflow check, the digests and
the monitors all read the landed wire.

In-place rings (``donate``, production on): at depth <= 1 the folds and the
wire step scatter into the rings' own planes (``inplace=True``) instead of
cloning them, as the reference donates its state. A compaction overflow's
fallback then re-evaluates from the POST-tick rings (the updates already
landed) with empty update batches and the PRE-tick small carries (regime,
dedupe, indicator carry — produced functionally, so the pre-tick tensors
are simply kept). An exception after the tick's first in-place write (a
ring plane's version counter moved) resets the engine cold; one before it
leaves the state intact. At depth >= 2 (the double-buffered rotation,
:meth:`_donation_mode`) the tick writes a recycled ring slot holding a copy
of the live rings instead, so each in-flight tick's fallback reads its own
post state; a dispatch that raises drops the slot and keeps the live state.
``donate=False`` runs the copying step, whose fallback re-runs the tick
from the pre-tick state.

Routing (``incremental=True``, the production default): a tick runs the
INCREMENTAL step, reading indicators from the carried state advanced by one
bar, when every update since the last full recompute was a clean
strictly-newer single-bar append, judged on the host against a per-row
mirror of the latest applied open time (:meth:`_note_applied`). Otherwise
it runs the FULL step, which rebuilds the carry from the windows, with its
reason counted in ``full_recompute_reasons``: ``cold_start`` (the first
tick), ``rewrite`` (an update at or before a row's latest bar), ``churn``
(a row claimed in the drain, or rows freed by :meth:`prune_symbols`) and
``audit`` (every ``carry_audit_every`` ticks). On the incremental path the
folds advance the carry too, so a multi-bar drain stays incremental. With
``incremental=False`` every tick is the classic full step and no carry is
maintained.

Observability on the wire: with ``numeric_digest`` and ``ingest_digest`` the
wire carries both digest blocks, decoded at finalize into
:class:`NumericHealthMonitor` and :class:`IngestHealthMonitor`; the ingest
counts cover every folded sub-batch (the counted folds). With
``drift_meter`` every audit tick first measures the carry's drift against a
fresh init (:func:`measure_carry_drift`, on a functional copy that never
touches ``self.state``) into :class:`DriftMeter`.

Signal outcomes (``outcomes_enabled``, production on): at finalize, every
emitted signal registers with :class:`OutcomeTracker`, anchored on the
evaluated 5m bar, and everything due matures against the engine's current
5m ring in one gather (timestamp-bounded, so reading the ring a tick later
at depth 1 matures the same set).

Host carries feeding the step: the grid-only policy (resolved from the
previous tick's regime and the breadth series, and handed to the autotrade
consumer), the London quiet window of the evaluated tick's clock, the
breadth scalars of the market-breadth series (fetched through the binbot
client once per 15m bucket; a failed fetch keeps the previous series), the
market type of the autotrade settings, the autotrade consumer's
market-dominance flags ``current_market_dominance_is_losers`` and
``market_domination_reversal`` (False, the reference's NEUTRAL, unless a
caller scripts them), and the open-interest growth of the rows with fresh
15m candles, read from :class:`OpenInterestCache` (``futures_api``; its
``refresh_forever`` runs beside the consume loop, so a tick makes no REST
call; all NaN while the cache is empty). Method names and call shapes follow the reference
engine, ``async def process_tick`` included.

The sinks: with ``delivery_enabled`` (production on) finalize enqueues
every emitted signal into the delivery plane (``io/delivery.py``): one
fsynced WAL put for the autotrade sink and a bounded-queue put per sink,
on the tick's own thread; the plane's workers call the analytics POST,
the Telegram consumer and autotrade admission. Without it finalize calls
the three inline, each failure logged and swallowed, as the reference
does. :meth:`aclose_delivery` retires the plane.

Observability (on by default, as in the reference; ``Config.trace_*``,
``freshness_*``, ``host_phase_enabled``, ``slo_*``, ``delivery_health_*``):
every tick opens a span tree in ``_dispatch_tick`` (:class:`Tracer`,
``obs/tracing.py``) carried on its ``_PendingTick`` and completed when the
tick finalizes, with the reference's span names (``breadth_refresh``,
``ingest_drain``, ``route_decision``, ``carry_audit``, ``buffer_fold``,
``inputs_build``, ``device_dispatch``, ``wire_fetch``, ``numeric_digest``,
``ingest_digest``, ``overflow_fallback``, ``extract_fired``, ``dedupe``,
``emission`` and the sink spans under it); a tick whose busy time reaches
``trace_slow_ms`` is force-emitted with :meth:`_flight_snapshot`. Every
fired signal of a traced tick is stamped with its ``trace_id``/``tick_seq``
(autotrade metadata, analytics record, a ``- Trace:`` line on the Telegram
text, the delivery entry id) and, with freshness on, its ``freshness_ms``
(candle close → emit). :class:`FreshnessTracker` and
:class:`PhaseAccountant` (``obs/latency.py``) record the close→dispatch,
ingest→dispatch, dispatch→fetch, close→emit stages and the
plan/stack/dispatch/device_wait/decode/emit dwell of every
``process_tick``; the delivery plane gets the live freshness tracker and
:class:`DeliveryHealth` (close→ack lag per sink); :class:`SloRegistry`
judges the freshness, staleness and delivery SLOs and the plane's
zero-loss, zero-duplicate and breakers-closed invariants. The ingest
monitor keeps per-symbol watermarks (arrival and apply). Spans are host
clocks: none synchronizes the card, and only ``wire_fetch`` waits, on the
wire copy's CUDA event. :meth:`health_snapshot` is the ``/healthz``
payload and :meth:`touch_heartbeat` (every ``process_tick``) its liveness
file; ``obs/exposition.py`` serves both and ``/metrics``.

The subscription fan-out plane (``fanout_enabled``, production on, as in
the reference): :class:`FanoutPlane` compiles user subscriptions into
bitset planes on the engine's device; at finalize, after the provenance
stamps, the deduped fired set is matched against them in one match on the
device (span ``fanout_match``), each signal gets its frame and packed
recipient words (``fanout_frame``) and the outbox its line. With the
delivery plane on, :class:`FanoutSink` is its fourth (lossy) sink and the
hub handoff runs on that lane's worker; without it the plane offers each
frame to the hub's connections on the tick's thread.
:meth:`aclose_fanout` retires it; checkpoints save its snapshot sidecar.

The multi-tick drives (replay, catch-up, backtesting): with a stream known
up front, :meth:`process_ticks_scanned` plans runs of clean-append ticks
(each tick's drain and host inputs captured in the serial order by
:meth:`_plan_scan_tick`) and runs each run of at most ``scan_chunk`` ticks
as one :func:`tick_step_scan` chunk: the stacked inputs uploaded once, the
device loop on a COPY of the state (the in-place rings are never written),
the ``(T, L)`` wires read back in one copy, the new state committed only
when no tick's fired count overflowed the wire; an overflowed chunk is
dropped and re-driven serially from the plan's start (the host mirror and
the ingest monitor rewound, each tick with its plan-time registry
occupancy), so the emitted set is the serial drive's. A classic engine, a
rewrite, churn, a desynced carry or a due audit breaks the chunk and runs
serially. :meth:`process_ticks_backtest` is the classic engine's
time-batched backend (``binquant_tpu_torch/backtest``), on the same
planner; it replaces the rings with new tensors after each chunk. A deep
update-only drain (a backfill flush, a restore catch-up) folds through
:meth:`_scan_fold_prefix`.

The service around the tick (``main.py``'s boot and
``SignalEngine.consume_loop`` in the reference): every finalize hands the
regime notifier's digest to the Telegram consumer and, once per 15m
bucket, schedules leverage calibration on the wire's calibration rows as a
single-flight background worker (host numpy only; inline when no event
loop runs). :meth:`backfill` tops the rings up from REST history (the next
tick recomputes in full, reason ``backfill``); :meth:`host_carries`,
:meth:`restore_host_carries` and :meth:`note_state_restored` carry the host
state a checkpoint needs (``io/checkpoint.py``), under the reference's JSON
keys; :meth:`consume_loop` drains an ingest queue, ticks once per interval
and saves checkpoints.
"""

from __future__ import annotations

import asyncio
import contextlib
import logging
import math
import time
from collections import deque
from collections.abc import Callable
from datetime import datetime, timezone
from pathlib import Path
from typing import Any, NamedTuple

import numpy as np
import torch

from binquant_tpu_torch import resolve_device
from binquant_tpu_torch.config import Config
from binquant_tpu_torch.engine.buffer import (
    NUM_FIELDS,
    IngestBatcher,
    SymbolRegistry,
    reset_rows,
    ring_latest_times,
)
from binquant_tpu_torch.engine.step import (
    EMISSION_LAYOUTS,
    FIVE_MIN_STRATEGIES,
    LIVE_STRATEGIES,
    MIN_INCR_ENGINE_WINDOW,
    WIRE_FIRED_COUNT_OFF,
    WIRE_MAX_FIRED,
    HostInputs,
    RingSlot,
    apply_updates_carry_step,
    apply_updates_carry_step_counted,
    apply_updates_scan,
    apply_updates_scan_counted,
    apply_updates_step,
    apply_updates_step_counted,
    empty_ring_slot,
    initial_engine_state,
    into_ring_slot,
    measure_carry_drift,
    ring_slot_of,
    slot_is_free_of,
    slot_planes,
    slot_storages,
    small_carries_of,
    tick_step,
    tick_step_scan,
    tick_step_wire,
    tick_step_wire_inplace,
    unpack_wire,
    unpack_wire_block,
    with_small_carries,
)
from binquant_tpu_torch.fanout.plane import FanoutPlane, FanoutSink
from binquant_tpu_torch.io.autotrade import AutotradeConsumer
from binquant_tpu_torch.io.binbot import BinbotApi
from binquant_tpu_torch.io.delivery import DeliveryPlane
from binquant_tpu_torch.io.emission import (
    dispatch_signal_record,
    extract_fired,
    make_signal_sinks,
)
from binquant_tpu_torch.io.leverage import CalibrationInputs, LeverageCalibrator
from binquant_tpu_torch.io.metrics import LatencyTracker
from binquant_tpu_torch.io.telegram import TelegramConsumer
from binquant_tpu_torch.io.websocket import WS_HEALTH
from binquant_tpu_torch.obs.delivery_health import DeliveryHealth
from binquant_tpu_torch.obs.events import get_event_log
from binquant_tpu_torch.obs.ingest import IngestHealthMonitor
from binquant_tpu_torch.obs.instruments import (
    BC_DIRTY_ROWS,
    FULL_RECOMPUTE,
    HEARTBEAT_FAILURES,
    OVERFLOW_TICKS,
    QUEUE_DEPTH,
    SCAN_CHUNKS,
    SCAN_OVERFLOW_RERUNS,
    SCANNED_TICKS,
    SIGNALS,
    SYMBOLS_PER_TICK,
    TICKS,
)
from binquant_tpu_torch.obs.latency import FreshnessTracker, PhaseAccountant
from binquant_tpu_torch.obs.ledger import LEDGER
from binquant_tpu_torch.obs.numeric import DriftMeter, NumericHealthMonitor
from binquant_tpu_torch.obs.outcomes import OutcomeTracker
from binquant_tpu_torch.obs.slo import SloRegistry
from binquant_tpu_torch.obs.tracing import (
    NULL_TRACE,
    Tracer,
    detached,
    profiler_window_active,
    step_annotation,
)
from binquant_tpu_torch.parallel.mesh import (
    Mesh,
    ShardedInputs,
    assemble_sharded,
    resolve_mesh,
    shard_bounds,
    shard_engine_state,
)
from binquant_tpu_torch.parallel.step import reset_rows as reset_sharded_rows
from binquant_tpu_torch.parallel.step import route_batch
from binquant_tpu_torch.regime.context import ContextConfig
from binquant_tpu_torch.regime.grid_policy import GridOnlyPolicy, read_breadth_momentum
from binquant_tpu_torch.regime.time_filter import is_quiet_hours
from binquant_tpu_torch.schemas import MarketBreadthSeries
from binquant_tpu_torch.strategies.market_regime_notifier import MarketRegimeNotifier

FIFTEEN_MIN_S = 900
FIVE_MIN_S = 300
# an empty sub-batch: pads a chunk tick's shorter interval to its slot count
_EMPTY_BATCH = (np.zeros(0, np.int32), np.zeros(0, np.int32),
                np.zeros((0, NUM_FIELDS), np.float32))


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


class OpenInterestCache:
    """KuCoin futures open-interest growth per symbol, refreshed by a
    background task; the tick path only reads it.

    Port of the reference's ``OpenInterestCache``. :meth:`refresh_forever`
    walks the tracked universe in batches of ``batch_size`` a
    ``batch_interval_s``, ``max_concurrency`` requests at a time, off the
    event loop; :meth:`growth` is a cache read. Growth is the new sample
    over the newest sample at least ``growth_horizon_s`` old (the previous
    15m candle's cadence: a sweep-to-sweep ratio would almost never clear
    LiquidationSweepPump's 1.02 confirmation gate), and a value not
    refreshed within ``stale_after_s`` reads NaN, so a failing endpoint
    never keeps an old growth passing the gate. ``clock`` gives the
    cache's seconds (``time.monotonic`` when None, read at each call).
    """

    def __init__(
        self,
        futures_api: Any | None,
        max_concurrency: int = 8,
        batch_size: int = 40,
        batch_interval_s: float = 1.0,
        growth_horizon_s: float = 900.0,
        stale_after_s: float = 300.0,
        clock: Callable[[], float] | None = None,
    ) -> None:
        self.futures_api = futures_api
        self.max_concurrency = max_concurrency
        self.batch_size = batch_size
        self.batch_interval_s = batch_interval_s
        self.growth_horizon_s = growth_horizon_s
        self.stale_after_s = stale_after_s
        self.clock = clock
        self._growth: dict[str, tuple[float, float]] = {}  # sym -> (ts, ratio)
        self._samples: dict[str, deque[tuple[float, float]]] = {}
        self._cursor = 0
        self.requests_made = 0

    def _now(self) -> float:
        return time.monotonic() if self.clock is None else float(self.clock())

    @property
    def has_data(self) -> bool:
        return bool(self._growth)

    def growth(self, symbol: str) -> float:
        """Cache-only read (the tick path makes no REST call): the last
        growth, NaN when unsampled or stale."""
        entry = self._growth.get(symbol)
        if entry is None or self._now() - entry[0] > self.stale_after_s:
            return float("nan")
        return entry[1]

    async def refresh_batch(self, symbols: list[str]) -> None:
        """Fetch ``symbols``' open interest with bounded concurrency; a
        failed fetch is skipped. The baseline is chosen BEFORE the new
        sample is appended."""
        if self.futures_api is None or not symbols:
            return
        sem = asyncio.Semaphore(self.max_concurrency)

        async def one(symbol: str) -> None:
            async with sem:
                try:
                    oi = float(
                        await asyncio.to_thread(self.futures_api.get_open_interest, symbol)
                    )
                except Exception:
                    return
                self.requests_made += 1
                now = self._now()
                dq = self._samples.setdefault(symbol, deque())
                # the newest sample at least a horizon old (horizon 0: the
                # previous sample)
                cutoff = now - self.growth_horizon_s
                while len(dq) > 1 and dq[1][0] <= cutoff:
                    dq.popleft()
                baseline = dq[0] if dq and dq[0][0] <= cutoff else None
                dq.append((now, oi))
                if baseline is not None and baseline[1] > 0:
                    self._growth[symbol] = (now, oi / baseline[1])

        await asyncio.gather(*(one(s) for s in symbols))

    async def refresh_forever(self, symbols_fn) -> None:
        """Background loop: one batch of ``symbols_fn()`` per interval (a
        2,000-symbol sweep takes ~50 s at the defaults, inside a 15m
        bucket). Returns at once without a client."""
        if self.futures_api is None:
            return
        while True:
            try:
                names = symbols_fn()
                if names:
                    if self._cursor >= len(names):
                        self._cursor = 0
                        # a sweep wrapped: forget symbols that left the
                        # universe, so churn cannot grow the caches
                        keep = set(names)
                        for stale in [s for s in self._samples if s not in keep]:
                            self._samples.pop(stale, None)
                            self._growth.pop(stale, None)
                    batch = names[self._cursor: self._cursor + self.batch_size]
                    self._cursor += self.batch_size
                    await self.refresh_batch(batch)
            except asyncio.CancelledError:
                raise
            except Exception:
                logging.exception("OI refresh batch failed; continuing")
            await asyncio.sleep(self.batch_interval_s)


class _PendingTick(NamedTuple):
    """A dispatched tick whose wire has not been read yet."""

    wire: torch.Tensor  # on the engine's device
    host: torch.Tensor  # its host copy: a pinned buffer on a card, else the wire
    ready: Any  # torch.cuda.Event recorded after the copy (None on the CPU)
    fallback: Any  # () -> TickOutputs, for a compaction overflow
    ts_ms: int
    ts5: int
    ts15: int
    bucket15: int
    rows: Any  # FrozenRows as of dispatch
    dispatched_at: float  # perf_counter at dispatch (freshness anchor)
    # the tick's TickTrace (NULL_TRACE when sampled out), completed when
    # the tick finalizes; its trace_id is every sink payload's provenance
    trace: Any = NULL_TRACE
    # perf_counter of the oldest candle this tick drained (None: unknown)
    ingest_mono: float | None = None
    # the drive that dispatched it ("serial", "scanned" or "backtest"):
    # finalize books its decode/emit dwell to that drive's host phases
    drive: str = "serial"
    # (WireFired, ctx) already decoded by a chunk drive's one-pass block
    # decode; None: finalize decodes the wire itself
    unpacked: Any = None
    # double-buffered dispatch: (the tick's post rings, the state
    # generation), back into the slot rotation once the tick finalizes
    spare: Any = None


def _note_symbols_per_tick(slots5: list, slots15: list) -> None:
    """``bqt_symbols_per_tick``: the rows the dispatched step applies, per
    interval, counted on the host batches (no device read). The serial step
    applies its final slot; a chunk applies every slot of every tick."""
    for interval, slots in (("5m", slots5), ("15m", slots15)):
        SYMBOLS_PER_TICK.labels(interval=interval).set(
            sum(int(np.count_nonzero(np.asarray(b[0]) >= 0)) for b in slots)
        )


def _max_rows(batches) -> int:
    """The row width every stacked update slot of a chunk is padded to: its
    widest sub-batch's (at least 1)."""
    return max([1] + [len(b[0]) for b in batches])


def _scan_fallback_unavailable():
    """The fallback of a chunk drive's tick. Never reachable: a chunk whose
    fired count overflowed is re-driven serially before any decode."""
    raise RuntimeError(
        "a chunk drive's tick has no per-tick fallback — overflow chunks are "
        "re-driven serially (SignalEngine._flush_scan_plan)"
    )


class _ScanTickPlan(NamedTuple):
    """One replayed tick staged for a chunk drive: its drained sub-batches
    and every host input the serial dispatch would have built, captured at
    plan time in the serial drive's order (the breadth momentum BEFORE this
    tick's bucket refresh, the breadth scalars after)."""

    now_ms: int
    ts5: int
    ts15: int
    bucket15: int
    batches5: list
    batches15: list
    momentum_ok: bool  # the grid policy's breadth verdict as of finalize(t-1)
    breadth: Any  # MarketBreadthSeries as of this tick's dispatch
    # (S,) bool registry occupancy AS OF this tick: a later tick's claim
    # must not leak backwards into the context's coverage gate
    tracked: Any
    adp: tuple  # breadth_scalars() at dispatch
    quiet: bool
    btc_row: int
    rows: Any  # FrozenRows at plan time (no churn inside a chunk)
    is_futures: bool
    dominance_is_losers: bool
    market_domination_reversal: bool
    ingest_mono: float | None = None
    # (S,) open-interest growth read from the cache at plan time (None:
    # the cache was empty, every row NaN)
    oi: Any = None


class SignalEngine:
    """Owns the device state and drives the pipelined tick loop from queued
    klines."""

    def __init__(
        self,
        config: Config | None,
        binbot_api: BinbotApi | None,
        telegram_consumer: TelegramConsumer,
        at_consumer: AutotradeConsumer,
        registry: SymbolRegistry | None = None,
        window: int | None = None,
        device: str | torch.device | None = None,
        context_config: ContextConfig = ContextConfig(),
        btc_symbol: str = "BTCUSDT",
        enabled_strategies: set[str] | None = None,
        pipeline_depth: int | None = None,
        futures_api: Any | None = None,
    ) -> None:
        self.device = resolve_device(device)
        self.config = config or Config()
        depth = self.config.pipeline_depth if pipeline_depth is None else pipeline_depth
        if int(depth) < 0:
            raise ValueError(f"pipeline_depth {depth} < 0")
        # the binbot REST client (None: no breadth refresh, no leverage
        # PUTs, no analytics POSTs) and the other two sinks' consumers; the
        # autotrade consumer also holds the settings (market type,
        # exchange), the symbol list leverage calibration diffs against and
        # the market-dominance flags
        self.binbot_api = binbot_api
        self.telegram_consumer = telegram_consumer
        self.at_consumer = at_consumer
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
        self.pipeline_depth = int(depth)
        # dispatched ticks not finalized yet, oldest first
        self._pending: deque[_PendingTick] = deque()
        self.donate = bool(self.config.donate)
        # the pinned host buffers the wire copies land in, and the next one
        self._wire_bufs: list[torch.Tensor] | None = None
        self._wire_slot = 0
        self._empty: tuple[torch.Tensor, torch.Tensor, torch.Tensor] | None = None
        self.inplace_ticks = 0
        self.overflow_ticks = 0
        self.state_resets = 0
        # the double-buffered rotation (depth >= 2, see _donation_mode): free
        # ring slots, at most four; the light-load parking slot (a finalized
        # tick whose post state is still the live state); the generation a
        # cold reset or a restore bumps, so a pending tick of an older
        # lineage never pools its slot; and the slots allocated on a miss
        self._spare_slots: list[RingSlot] = []
        self._spare_slots_max = 4
        self._state_generation = 0
        self._deferred_spare: tuple[RingSlot, int] | None = None
        self.fresh_slots = 0
        # the symbol mesh (BQT_MESH_DEVICES > 1): the state placed over it
        # once; every step keeps it placed, and each tick's inputs and
        # update batches are placed per shard at the ingest boundary
        self.mesh: Mesh | None = None
        self.place_on_mesh()
        self.market_breadth: MarketBreadthSeries | None = None
        self._last_breadth_bucket = -1
        self.grid_only_policy = GridOnlyPolicy.disabled("not_evaluated")
        self.notifier = MarketRegimeNotifier(env=self.config.env)
        self.leverage_calibrator = LeverageCalibrator(binbot_api, at_consumer.exchange)
        # open-interest growth for LiquidationSweepPump, refreshed off the
        # tick path (refresh_forever beside the consume loop); no client:
        # every row reads NaN, which the strategy's gate passes
        self.oi_cache = OpenInterestCache(futures_api)
        # the all-NaN (S,) growth a tick uploads once while the cache is empty
        self._nan_oi: torch.Tensor | None = None
        self._last_calibration_bucket = -1
        self._calibration_task: asyncio.Task | None = None
        # host ms of each calibration run
        self.calibration_ms: list[float] = []
        # the last valid regime and its transition strength (checkpointed)
        self._last_regime: int | None = None
        self._last_transition_strength = 0.0
        self.signals_emitted = 0
        # the CheckpointManager the consume loop saves through (None: no saves)
        self.checkpoint = None
        self.early_emit = bool(self.config.early_emit)
        # readers of the state that a dispatch must not overlap (a save)
        self._state_holds = 0
        # the last backfill's bars, fetches and seconds
        self.backfill_stats: dict | None = None
        # per-bar emission dedupe: (strategy, symbol) -> last emitted bar ts
        self._last_emitted: dict[tuple[str, str], int] = {}
        self._tracked_cache: tuple[int, torch.Tensor] | None = None
        self.tick_wall_ms: list[float] = []
        # host ms of each finalize's emission: the plane's enqueues (WAL
        # puts included), or the inline sink calls with the plane off
        self.emit_ms: list[float] = []
        # the last fetched wire (host numpy), for inspection and comparison
        self.last_wire: np.ndarray | None = None
        self.ticks_processed = 0
        # -- incremental routing (see the module docstring)
        self.incremental = bool(self.config.incremental)
        if self.incremental and self.window < MIN_INCR_ENGINE_WINDOW:
            raise ValueError(
                f"window {self.window} < {MIN_INCR_ENGINE_WINDOW}, the incremental "
                "engine's minimum ring (engine/step.py MIN_INCR_ENGINE_WINDOW): "
                "grow the window or build the engine with incremental=False"
            )
        self.carry_audit_every = int(self.config.carry_audit_every_ticks or 0)
        # why the carry is desynced (None = synced); the first reason wins
        # until a full tick clears it
        self._carry_desync_reason: str | None = "cold_start"
        # last applied open time per registry row and interval: the host
        # mirror that detects rewrites without a device fetch
        self._host_latest: dict[str, np.ndarray] = {
            "5m": np.full(self.capacity, -1, dtype=np.int64),
            "15m": np.full(self.capacity, -1, dtype=np.int64),
        }
        self.incremental_ticks = 0
        self.full_recompute_ticks = 0
        self.full_recompute_reasons: dict[str, int] = {}
        # -- the multi-tick drives (see the module docstring): runs of
        # clean-append ticks fused into chunks of at most ``scan_chunk``
        # (scanned) or ``backtest_chunk`` (backtest, never under the
        # too-short floor) ticks; counters for tests and /healthz
        self.scan_chunk = max(int(self.config.scan_chunk or 64), 2)
        self.scanned_ticks = 0
        self.scan_chunks = 0
        self.scan_overflow_reruns = 0
        self.backtest_chunk = max(int(self.config.backtest_chunk or 16), self._SCAN_MIN_TICKS)
        self.backtest_ticks = 0
        self.backtest_chunks = 0
        self.backtest_overflow_reruns = 0
        self.ext_invariant = bool(self.config.ext_invariant)
        # an explicit StrategyParams (None: the kernels' defaults): a
        # backtest drive installs its params for the drive, so its serial
        # re-entries evaluate with the chunks' thresholds
        self.strategy_params = None
        # a serial re-drive's per-tick registry occupancy (None: the live one)
        self._tracked_override: np.ndarray | None = None
        # the last dispatched tick's path: "incremental", the full
        # recompute's reason, or "classic" on a classic engine
        self.last_path: str | None = None
        # -- liveness (/healthz): the heartbeat file and its bookkeeping
        self.heartbeat_path = Path(self.config.heartbeat_path)
        self._last_heartbeat_s: float | None = None
        self._last_tick_wall_s: float | None = None
        self.heartbeat_write_failures = 0
        self._hb_consecutive_failures = 0
        self._hb_last_warn = float("-inf")
        # the websocket tracker /healthz reads: None reads the module's
        # (the one the live connectors feed); a drill sets its own
        self.ws_health = None
        # -- the tick's observability (see the module docstring)
        self.latency = LatencyTracker()
        cfg = self.config
        self.tracer = Tracer(
            sample=cfg.trace_sample, slow_ms=cfg.trace_slow_ms, ring=cfg.trace_ring
        )
        self.slo = SloRegistry(event_every=cfg.slo_event_every) if cfg.slo_enabled else None
        self.freshness = FreshnessTracker(
            enabled=cfg.freshness_enabled, slo_ms=cfg.freshness_slo_ms, slo=self.slo
        )
        if self.slo is not None and self.freshness.enabled and self.freshness.slo_ms > 0:
            self.slo.register("freshness", "freshness", self.freshness.slo_ms)
        self.host_phase = PhaseAccountant(enabled=cfg.host_phase_enabled)
        # the trace's tick_seq: advances on every dispatch ATTEMPT (a failed
        # tick must not hand its number to the retry)
        self._tick_seq = 0
        # -- the wire digests and the carry-drift meter
        self.numeric_digest = bool(self.config.numeric_digest)
        self.ingest_digest = bool(self.config.ingest_digest)
        self.numeric = NumericHealthMonitor(
            nan_budget=self.config.numeric_nan_budget,
            event_every=self.carry_audit_every or 256,
        )
        self.ingest_monitor = IngestHealthMonitor(
            self.registry,
            enabled=self.ingest_digest,
            stale_budget=self.config.ingest_stale_budget,
            event_every=self.carry_audit_every or 256,
            slo=self.slo,
        )
        # the monitor's watermark half (the digest half runs regardless)
        self.ingest_watermarks = self.ingest_monitor.enabled and bool(
            self.config.ingest_watermarks_enabled
        )
        if self.slo is not None and self.ingest_monitor.enabled:
            self.slo.register(
                "staleness", "staleness", float(self.ingest_monitor.stale_budget),
                unit="rows",
            )
        # the (8,) ingest counts of this tick's folds, on the device
        self._ingest_fold_counts: torch.Tensor | None = None
        # a classic engine has no carry to drift
        self.drift_meter_enabled = bool(self.config.drift_meter) and self.incremental
        self.drift = DriftMeter(tol=self.config.drift_tol)
        # -- the signal-outcome observatory
        self.outcomes = OutcomeTracker(
            enabled=bool(self.config.outcomes_enabled),
            horizons=tuple(self.config.outcome_horizons),
            cap=int(self.config.outcome_cap),
        )
        # -- the subscription fan-out plane (None: off): subscriptions
        # compiled into bitset planes on this engine's device, every fired
        # tick's deduped signals matched against them at finalize; a
        # snapshot sidecar, when configured, restores the planes warm; its
        # recipient-set integrity joins the SLO verdict
        self.fanout: FanoutPlane | None = None
        if cfg.fanout_enabled:
            self.fanout = FanoutPlane(
                self.registry,
                capacity=int(cfg.fanout_capacity),
                outbox_path=cfg.fanout_outbox_path or None,
                outbox_cap=int(cfg.fanout_outbox_cap),
                conn_queue_max=int(cfg.fanout_conn_queue),
                # the explicit knob, else one partition per mesh shard
                outbox_shards=int(cfg.fanout_outbox_shards or 0)
                or (self.mesh.size if self.mesh is not None else 1),
                snapshot_path=cfg.fanout_snapshot_path or None,
                snapshot_shards=int(cfg.fanout_snapshot_shards or 0),
                compact_frac=float(cfg.fanout_compact_frac or 0.0),
                resume_tail=int(cfg.fanout_resume_tail or 0),
                device=self.device,
            )
            if self.fanout.snapshot_path is not None:
                self.fanout.try_restore_snapshot()
            if self.slo is not None:
                self.slo.add_invariant(
                    "fanout_recipient_set", self.fanout.recipient_set_invariant
                )
        # -- the delivery plane (None: the sinks are called inline), its
        # health collector and the plane's invariants in the SLO verdict;
        # the fan-out plane's broadcast is its fourth, lossy sink
        self.delivery: DeliveryPlane | None = None
        self.delivery_health: DeliveryHealth | None = None
        if self.config.delivery_enabled:
            self.delivery_health = DeliveryHealth(
                enabled=cfg.delivery_health_enabled,
                window=cfg.slo_window,
                slo=self.slo,
                slo_ms=cfg.delivery_slo_ms,
            )
            sinks = make_signal_sinks(binbot_api, telegram_consumer, at_consumer)
            if self.fanout is not None:
                sinks.append(FanoutSink(self.fanout))
            self.delivery = DeliveryPlane.from_config(
                self.config,
                sinks,
                freshness=self.freshness,
                health=self.delivery_health,
            )
            if self.slo is not None:
                self.slo.add_invariant(
                    "delivery_zero_loss", self.delivery.zero_loss_invariant
                )
                self.slo.add_invariant(
                    "delivery_zero_duplicate", self.delivery.zero_duplicate_invariant
                )
                self.slo.add_invariant(
                    "delivery_breakers_closed", self.delivery.breakers_closed_invariant
                )

    # -- the symbol mesh ------------------------------------------------------

    def place_on_mesh(self, mesh: Mesh | None = None) -> None:
        """Shard the engine over a symbol mesh: ``mesh`` when given (shards
        may share a device), else the one ``Config.mesh_devices`` resolves
        to (``parallel/mesh.py`` ``resolve_mesh``; None runs unsharded).
        The constructor calls it; call it again only on an engine with no
        tick in flight. A CUDA engine never places a shard on the CPU."""
        if self._pending:
            raise RuntimeError("place_on_mesh with a tick in flight: flush_pending() first")
        if mesh is None:
            mesh = resolve_mesh(int(self.config.mesh_devices or 0), self.capacity, self.device)
        if mesh is not None:
            if any(d.type != self.device.type for d in mesh.devices):
                raise ValueError(f"a {self.device.type} engine cannot shard over {mesh}")
            self.state = shard_engine_state(self.state, mesh)
        self.mesh = mesh
        self._tracked_cache = None
        self._nan_oi = None
        self._empty = None
        # no tick is in flight: only the pooled slots hold the old placement
        self._spare_slots.clear()
        self._deferred_spare = None

    def _fresh_state(self):
        """A cold empty state with the engine's placement (sharded over the
        mesh when there is one, built on the host and placed per shard)."""
        if self.mesh is None:
            return initial_engine_state(self.capacity, self.window, device=self.device)
        cold = initial_engine_state(self.capacity, self.window, device="cpu")
        return shard_engine_state(cold, self.mesh)

    def _place_symbol_array(self, arr: np.ndarray):
        """A host ``(S,)`` array on the engine's device, or split over the
        mesh: each shard's slice goes straight to its own device."""
        if self.mesh is None:
            return torch.from_numpy(arr).to(self.device)
        return assemble_sharded(self.mesh, arr)

    def _mesh_snapshot(self) -> dict:
        """The /healthz mesh section: geometry and each shard's tracked
        rows, read from the registry on the host (no device read)."""
        if self.mesh is None:
            return {"enabled": False}
        n = self.mesh.size
        active = self.registry.active_rows
        return {
            "enabled": True,
            "devices": n,
            "shards": [
                {"shard": k, "rows": [lo, hi], "tracked_rows": int(active[lo:hi].sum())}
                for k, (lo, hi) in enumerate(shard_bounds(self.registry.capacity, n))
            ],
            "state_generation": self._state_generation,
            "outbox_shards": (
                getattr(self.fanout, "outbox_shards", None)
                if self.fanout is not None
                else None
            ),
        }

    # -- ingest ---------------------------------------------------------------

    def ingest(self, kline: dict) -> None:
        """Route one closed candle to its interval batcher by bar duration;
        anything but 5m/15m is dropped."""
        duration_s = (int(kline["close_time"]) - int(kline["open_time"])) // 1000
        if abs(duration_s - FIVE_MIN_S) <= 1:
            self.batcher5.add(kline)
        elif abs(duration_s - FIFTEEN_MIN_S) <= 1:
            self.batcher15.add(kline)
        else:
            return
        if self.ingest_watermarks:
            # arrival watermark + per-exchange feed lag (replay streams
            # carry no exchange: binance)
            self.ingest_monitor.note_arrival(
                str(kline.get("symbol", "")).strip().upper(),
                int(kline["close_time"]),
                exchange=str(kline.get("exchange", "binance")),
            )

    def _to_device(self, batch) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        if self.mesh is not None:
            # the shard-local ingest boundary: each shard's rows (rebased)
            # go straight to its device
            return route_batch(self.mesh, self.capacity, batch)
        rows, ts, vals = batch
        return (
            torch.from_numpy(np.ascontiguousarray(rows, dtype=np.int32)).to(self.device),
            torch.from_numpy(np.ascontiguousarray(ts, dtype=np.int32)).to(self.device),
            torch.from_numpy(np.ascontiguousarray(vals, dtype=np.float32)).to(self.device),
        )

    def _empty_updates(self):
        if self._empty is None:
            self._empty = self._to_device(
                (np.zeros(0, np.int32), np.zeros(0, np.int32),
                 np.zeros((0, NUM_FIELDS), np.float32))
            )
        return self._empty

    def _slot_pairs(self, batches5: list, batches15: list) -> list[tuple]:
        """The drain's (upd5, upd15) sub-batch pairs on the device, in apply
        order; the shorter interval pads with empty batches."""
        empty = self._empty_updates()
        upd5 = [self._to_device(b) for b in batches5] or [empty]
        upd15 = [self._to_device(b) for b in batches15] or [empty]
        n = max(len(upd5), len(upd15))
        return [
            (upd5[i] if i < len(upd5) else empty, upd15[i] if i < len(upd15) else empty)
            for i in range(n)
        ]

    def _fold_updates(
        self,
        batches5: list,
        batches15: list,
        advance_carry: bool = False,
        btc_row: int = -1,
        inplace: bool = False,
        pairs: list[tuple] | None = None,
    ):
        """Apply all but the FINAL sub-batch pair without evaluating
        (ordered replay — evaluating each would advance the dedupe carries
        and discard earlier signals); return the final pair to evaluate.
        ``advance_carry`` folds with the carry-advancing step (only when the
        caller found every sub-batch a clean append); ``btc_row`` keeps the
        beta/corr pairing advancing through those folds. With the ingest
        digest on, the counted folds add each pair's ingest counts to the
        accumulator the evaluated tick's digest drains. A deep update-only
        drain (``_SCAN_FOLD_MIN`` folds or more: a backfill flush, a restore
        catch-up) folds through :meth:`_scan_fold_prefix` instead, a few
        stacked uploads instead of one per sub-batch. ``pairs`` passes the
        drain's device pairs when the caller already built them."""
        n = max(len(batches5), len(batches15), 1)
        if not advance_carry and n - 1 >= self._SCAN_FOLD_MIN:
            self._scan_fold_prefix(batches5, batches15, n, inplace)
            empty = self._empty_updates()
            return (
                self._to_device(batches5[n - 1]) if n - 1 < len(batches5) else empty,
                self._to_device(batches15[n - 1]) if n - 1 < len(batches15) else empty,
            )
        if pairs is None:
            pairs = self._slot_pairs(batches5, batches15)
        for a, b in pairs[:-1]:
            if self.ingest_digest:
                if advance_carry:
                    self.state, self._ingest_fold_counts = apply_updates_carry_step_counted(
                        self.state, a, b, btc_row=btc_row, counts=self._ingest_fold_acc(),
                        inplace=inplace,
                    )
                else:
                    self.state, self._ingest_fold_counts = apply_updates_step_counted(
                        self.state, a, b, self._ingest_fold_acc(), inplace=inplace
                    )
            elif advance_carry:
                self.state = apply_updates_carry_step(
                    self.state, a, b, btc_row=btc_row, inplace=inplace
                )
            else:
                self.state = apply_updates_step(self.state, a, b, inplace=inplace)
        return pairs[-1]

    # update-only folds shorter than this keep the per-sub-batch loop
    _SCAN_FOLD_MIN = 8

    def _scan_fold_prefix(self, batches5: list, batches15: list, n: int,
                          inplace: bool = False) -> None:
        """Fold sub-batch pairs [0, n-2] through :func:`apply_updates_scan`
        in ``scan_chunk``-bounded stacks: each stack is one upload per
        array, its slots padded to the stack's widest sub-batch per interval
        with rows -1 (exact no-ops)."""
        prefix5 = batches5[: n - 1]
        prefix15 = batches15[: n - 1]
        total = n - 1
        chunk = max(self.scan_chunk, self._SCAN_FOLD_MIN)
        for start in range(0, total, chunk):
            stop = min(start + chunk, total)
            part5, part15 = prefix5[start:stop], prefix15[start:stop]
            upd5 = self._stack_host([[b] for b in part5], stop - start, 1, _max_rows(part5))
            upd15 = self._stack_host([[b] for b in part15], stop - start, 1, _max_rows(part15))
            upd5 = self._to_device(tuple(x[:, 0] for x in upd5))
            upd15 = self._to_device(tuple(x[:, 0] for x in upd15))
            if self.ingest_digest:
                self.state, self._ingest_fold_counts = apply_updates_scan_counted(
                    self.state, upd5, upd15, self._ingest_fold_acc(), inplace=inplace
                )
            else:
                self.state = apply_updates_scan(self.state, upd5, upd15, inplace=inplace)

    def _stack_slots(self, per_tick: list[list], T: int, depth: int, rows: int):
        """Per-tick sub-batch lists as one ``(rows (T, depth, U), ts, vals
        (T, depth, U, F))`` upload: each tick's own batches at the TAIL of
        its ``depth`` slots (front-padded with empty ones, so its last slot
        is the evaluated one), each batch padded to ``rows`` with rows -1.
        Ticks past ``len(per_tick)`` are all padding."""
        return self._to_device(self._stack_host(per_tick, T, depth, rows))

    def _stack_host(self, per_tick: list[list], T: int, depth: int, rows: int):
        """:meth:`_stack_slots`'s arrays, on the host."""
        r = np.full((T, depth, rows), -1, np.int32)
        ts = np.full((T, depth, rows), -1, np.int32)
        v = np.zeros((T, depth, rows, NUM_FIELDS), np.float32)
        for i, batches in enumerate(per_tick):
            off = depth - len(batches)
            for d, (br, bt, bv) in enumerate(batches):
                k = len(br)
                r[i, off + d, :k] = br
                ts[i, off + d, :k] = bt
                v[i, off + d, :k] = bv
        return r, ts, v

    def _ingest_fold_acc(self) -> torch.Tensor:
        """The running (8,) fold-count accumulator (zeros before this
        tick's first counted fold)."""
        if self._ingest_fold_counts is not None:
            return self._ingest_fold_counts
        return torch.zeros((8,), dtype=torch.float32, device=self.device)

    def _take_ingest_fold_counts(self) -> torch.Tensor | None:
        """Consume the accumulated fold counts for the tick being
        dispatched (None while the ingest digest is off)."""
        if not self.ingest_digest:
            return None
        counts = self._ingest_fold_acc()
        self._ingest_fold_counts = None
        return counts

    def _note_applied(self, batches5: list, batches15: list, commit: bool = True) -> bool:
        """Move the host's per-row latest-open-time mirror over the
        sub-batches about to be applied; True when EVERY update is a clean
        strictly-newer append (safe for the carry advance). Called once per
        drained batch set, in apply order. ``commit=False`` judges on a
        scratch copy and moves nothing: the chunk drives peek before
        deciding whether a tick joins a chunk (committed then) or goes to
        the serial path (which judges and commits itself)."""
        clean = True
        feed_monitor = commit and self.ingest_watermarks
        for key, batches in (("5m", batches5), ("15m", batches15)):
            latest = self._host_latest[key]
            if not commit:
                latest = latest.copy()
            for rows, ts, _ in batches:
                if len(rows) == 0:
                    continue
                rows = np.asarray(rows, dtype=np.int64)
                ts64 = np.asarray(ts, dtype=np.int64)
                ok = (rows >= 0) & (rows < self.capacity)
                rows, ts64 = rows[ok], ts64[ok]
                if np.any(ts64 <= latest[rows]):
                    clean = False
                if feed_monitor:
                    # per-symbol watermarks and counters, classified
                    # against the pre-apply mirror
                    self.ingest_monitor.note_applied_batch(key, rows, ts64, latest[rows])
                np.maximum.at(latest, rows, ts64)
        return clean

    def _mark_carry_desynced(self, reason: str) -> None:
        """The carried state no longer matches the windows: the next tick
        runs the full recompute. The first reason wins until then."""
        if reason == "churn":
            self.ingest_monitor.note_churn()
        if self._carry_desync_reason is None:
            self._carry_desync_reason = reason

    def _route(self) -> tuple[bool, str | None]:
        """This tick's path: (incremental?, full-recompute reason). The
        audit runs on the engine's own tick count, so a replay audits the
        same ticks every run."""
        if not self.incremental:
            return False, None
        if self._carry_desync_reason is not None:
            return False, self._carry_desync_reason
        if (
            self.carry_audit_every > 0
            and self.ticks_processed > 0
            and self.ticks_processed % self.carry_audit_every == 0
        ):
            return False, "audit"
        return True, None

    def prune_symbols(self, keep: list[str]) -> int:
        """Drop registry rows of symbols outside ``keep`` and clear their
        buffer rows. A freed row can be reclaimed by a new symbol whose
        first append the stale carry would misread, so the next tick runs
        the full recompute (``churn``); the host mirror of the freed rows is
        reset, or a reclaimed row would be judged against a stale time."""
        keep_rows = {r for r in (self.registry.row_of(s) for s in keep) if r is not None}
        stale = [
            (sym, row) for sym, row in self.registry.to_mapping().items()
            if row not in keep_rows
        ]
        if not stale:
            return 0
        for sym, _ in stale:
            self.registry.remove(sym)
        rows_np = np.array([row for _, row in stale], np.int32)
        if self.mesh is not None:
            self.state = reset_sharded_rows(self.state, rows_np)
        else:
            rows = torch.from_numpy(rows_np).to(self.device)
            self.state = self.state._replace(
                buf5=reset_rows(self.state.buf5, rows),
                buf15=reset_rows(self.state.buf15, rows),
            )
        for latest in self._host_latest.values():
            latest[rows_np] = -1
        self._mark_carry_desynced("churn")
        return len(stale)

    # -- startup backfill ---------------------------------------------------------

    def _flush_batchers(self) -> None:
        """Drain both batchers into the rings, update-only. The carry is not
        advanced (hundreds of bars fold in), so the next tick recomputes in
        full from the final windows (reason ``backfill``). The folds write
        the ring planes in place: with no tick in flight and none
        dispatched meanwhile, nothing else reads the pre-fold rings."""
        self._refuse_while_held("a backfill flush")
        if self._pending:
            raise RuntimeError("backfill with a tick in flight: flush_pending() first")
        batches5, batches15 = self.batcher5.drain(), self.batcher15.drain()
        if not (batches5 or batches15):
            return
        self._note_applied(batches5, batches15)
        self._mark_carry_desynced("backfill")
        u5, u15 = self._fold_updates(batches5, batches15, inplace=True)
        if self.ingest_digest:
            # the last slot is update-only too: counted into the accumulator
            # the next evaluated tick drains
            self.state, self._ingest_fold_counts = apply_updates_step_counted(
                self.state, u5, u15, self._ingest_fold_acc(), inplace=True
            )
        else:
            self.state = apply_updates_step(self.state, u5, u15, inplace=True)

    def backfill(
        self,
        symbols: list[str],
        fetch: Callable[[str, str], list[dict]],
        now_ms: int | None = None,
        chunk: int = 50,
        concurrency: int = 8,
    ) -> int:
        """Seed both rings from REST history before going live (and top
        them up after a restore: a bar the archive already holds is written
        again unchanged). ``fetch(symbol, "5m" | "15m")`` returns kline
        dicts; only bars closed by ``now_ms`` load. The BTC symbol goes
        first; fetches run ``concurrency``-way in a thread pool while the
        batchers are fed on the calling thread; a failed fetch is logged
        and skipped; the batchers flush every ``chunk`` symbols. Returns the
        bars loaded; ``backfill_stats`` keeps the counts and seconds."""
        from concurrent.futures import ThreadPoolExecutor

        t_start = time.perf_counter()
        now = int(now_ms if now_ms is not None else time.time() * 1000)
        ordered = [self.btc_symbol] + [s for s in symbols if s != self.btc_symbol]
        loaded = requests = failures = 0

        def fetch_symbol(symbol: str):
            out = []
            for interval_key in ("5m", "15m"):
                try:
                    out.append((interval_key, fetch(symbol, interval_key)))
                except Exception:
                    logging.exception(
                        "backfill fetch failed for %s %s; skipping", symbol, interval_key
                    )
                    out.append((interval_key, None))
            return out

        with ThreadPoolExecutor(max_workers=max(1, concurrency)) as pool:
            for i, results in enumerate(pool.map(fetch_symbol, ordered)):
                for interval_key, klines in results:
                    if klines is None:
                        failures += 1
                        continue
                    requests += 1
                    batcher = self.batcher5 if interval_key == "5m" else self.batcher15
                    for k in klines:
                        if int(k["close_time"]) <= now:
                            batcher.add(k)
                            loaded += 1
                if (i + 1) % chunk == 0:
                    self._flush_batchers()
        self._flush_batchers()
        seconds = time.perf_counter() - t_start
        self.backfill_stats = {
            "bars": loaded, "symbols": len(ordered), "fetches_ok": requests,
            "fetches_failed": failures, "seconds": seconds,
        }
        logging.info(
            "backfill complete: %d bars across %d symbols in %.1fs "
            "(%d fetches ok, %d failed, %d-way)",
            loaded, len(ordered), seconds, requests, failures, concurrency,
        )
        return loaded

    # -- host carries ---------------------------------------------------------

    async def _refresh_market_breadth(self, bucket: int) -> None:
        if bucket == self._last_breadth_bucket:
            return
        self._last_breadth_bucket = bucket
        if self.binbot_api is None:
            return
        try:
            self.market_breadth = await self.binbot_api.get_market_breadth()
        except Exception:
            logging.exception("market breadth refresh failed; keeping previous")

    def _run_leverage_calibration(self, bucket: int, context, rows=None) -> None:
        """Schedule the bucket's leverage diff as a background worker: the
        PUTs must not ride the tick. The tick hands over only host inputs
        (the wire-decoded calibration rows, or a context) and the
        dispatch-time rows. Single-flight: a bucket whose predecessor's run
        is still in flight is skipped (an accelerated clock); with no
        running event loop the run is inline."""
        if bucket == self._last_calibration_bucket:
            return
        self._last_calibration_bucket = bucket
        task = self._calibration_task
        if task is not None and not task.done():
            logging.warning(
                "leverage calibration for bucket %s skipped: previous run still in "
                "flight (accelerated clock)",
                bucket,
            )
            return
        rows = rows if rows is not None else self.registry.frozen_rows()
        symbols = self.at_consumer.all_symbols

        def work() -> None:
            t0 = time.perf_counter()
            try:
                self.leverage_calibrator.calibrate_all(context, rows, symbols)
            except Exception:
                logging.exception("leverage calibration crashed; continuing")
            finally:
                ms = (time.perf_counter() - t0) * 1000.0
                self.calibration_ms.append(ms)
                self.latency.record("leverage_calibration_worker", ms)

        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:
            work()
            return
        # detach the tick's trace first: the worker thread would otherwise
        # inherit it through the context variable and race the tick's span
        # stack with its REST-call spans
        with detached():
            self._calibration_task = loop.create_task(asyncio.to_thread(work))

    def _tracked_mask(self) -> torch.Tensor:
        if self._tracked_override is not None:
            # a serial re-drive dispatches with the occupancy its plan saw
            return self._place_symbol_array(self._tracked_override)
        cached = self._tracked_cache
        if cached is not None and cached[0] == self.registry.version:
            return cached[1]
        mask = self._place_symbol_array(self.registry.active_rows)
        self._tracked_cache = (self.registry.version, mask)
        return mask

    def _oi_rows(self, batches15: list) -> np.ndarray | None:
        """(S,) open-interest growth for the rows of this tick's fresh 15m
        candles, read from the cache (no REST call), NaN elsewhere; None
        while the cache is empty (a spot deployment, or before the first
        sweep)."""
        if not self.oi_cache.has_data:
            return None
        oi = np.full(self.capacity, np.nan, dtype=np.float32)
        for rows, _, _ in batches15:
            for row in rows:
                symbol = self.registry.name_of(int(row))
                if symbol:
                    oi[int(row)] = self.oi_cache.growth(symbol)
        return oi

    def _host_inputs(self, btc_row: int, ts15: int, ts5: int, quiet: bool,
                     oi: np.ndarray | None = None) -> HostInputs:
        """The tick's HostInputs: every scalar in three small H2D copies,
        and the open-interest growth (one reused all-NaN tensor while
        ``oi`` is None)."""
        adp_latest, adp_prev, adp_diff, adp_diff_prev, momentum = breadth_scalars(
            self.market_breadth
        )
        f = torch.tensor(
            [adp_latest, adp_prev, adp_diff, adp_diff_prev, momentum],
            dtype=torch.float32,
        )
        i = torch.tensor([btc_row, ts15, ts5], dtype=torch.int32)
        at = self.at_consumer
        market_type = at.autotrade_settings.market_type
        b = torch.tensor(
            [
                quiet,
                self.grid_only_policy.allow_grid_ladder,
                str(getattr(market_type, "value", market_type)).lower().endswith("futures"),
                bool(getattr(at, "current_market_dominance_is_losers", False)),
                bool(at.market_domination_reversal),
            ],
            dtype=torch.bool,
        )
        tracked, oi_dev = self._tracked_mask(), self._oi_device(oi)
        if self.mesh is None:
            return self._inputs_on(self.device, f, i, b, tracked, oi_dev)
        # every shard gets its rows of the (S,) fields and its own copy of
        # the scalars (three small copies per shard)
        return ShardedInputs(
            [
                self._inputs_on(dev, f, i, b, tracked.pieces[k], oi_dev.pieces[k])
                for k, dev in enumerate(self.mesh.devices)
            ],
            self.mesh,
            btc_row,
        )

    @staticmethod
    def _inputs_on(device, f, i, b, tracked, oi) -> HostInputs:
        f, i, b = f.to(device), i.to(device), b.to(device)
        return HostInputs(
            tracked=tracked,
            btc_row=i[0],
            timestamp_s=i[1],
            timestamp5_s=i[2],
            oi_growth=oi,
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

    def _oi_device(self, oi: np.ndarray | None) -> torch.Tensor:
        if oi is not None:
            return self._place_symbol_array(oi)
        if self._nan_oi is None:
            self._nan_oi = self._place_symbol_array(
                np.full((self.capacity,), np.nan, dtype=np.float32)
            )
        return self._nan_oi

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
        """One tick of the pipelined loop: finalize in-flight ticks while
        ``max(depth, 1)`` are pending (at depth 1, tick i-1, whose wire has
        landed meanwhile), dispatch this tick (drain → fold → wire step →
        wire copy started), and at depth 0 finalize it too. Finalizing
        before dispatching keeps the host carries feeding this tick one
        tick behind, as at depth 0. Returns the emitted signals, each
        stamped with the ``tick_ms`` of the tick that produced it."""
        t0 = time.perf_counter()
        ts_ms = now_ms if now_ms is not None else int(time.time() * 1000)
        # one host-phase "chunk" per call: the finalize halves of evicted
        # ticks plus the new dispatch, against this call's wall clock
        self.host_phase.begin_chunk("serial")
        fired: list = []
        while len(self._pending) >= max(self.pipeline_depth, 1):
            fired.extend(await self._finalize_tick(self._pending.popleft()))
        self._pending.append(await self._dispatch_tick(ts_ms))
        if self.pipeline_depth == 0:
            fired.extend(await self._finalize_tick(self._pending.popleft()))
        tick_wall_ms = (time.perf_counter() - t0) * 1000.0
        self.tick_wall_ms.append(tick_wall_ms)
        self.latency.record("tick_total", tick_wall_ms)
        self.host_phase.note_chunk("serial", tick_wall_ms, 1)
        self.latency.maybe_log()
        self.ticks_processed += 1
        self._last_tick_wall_s = time.time()
        TICKS.inc()
        # event-log records carry the tick they were emitted under
        get_event_log().tick = self.ticks_processed
        self.touch_heartbeat()
        return fired

    async def flush_pending(self) -> list:
        """Finalize every in-flight tick (replay end, shutdown), so no
        dispatched tick's signals are lost."""
        fired: list = []
        while self._pending:
            fired.extend(await self._finalize_tick(self._pending.popleft()))
        return fired

    async def emit_ready(self) -> list:
        """Land and emit the oldest in-flight tick NOW instead of when the
        next tick evicts it: waits out only the wire copy, in a worker
        thread so the event loop keeps running. Finalize order, and so the
        host carries' one-tick lag, is unchanged."""
        if not self._pending:
            return []
        head = self._pending[0]
        if head.ready is not None:
            await asyncio.to_thread(head.ready.synchronize)
        if self._pending and self._pending[0] is head:
            self._pending.popleft()
            return await self._finalize_tick(head)
        return []

    # -- the multi-tick drives ------------------------------------------------------

    # runs shorter than this re-enter the serial path (a chunk is not worth a
    # handful of ticks)
    _SCAN_MIN_TICKS = 4

    def _drain_for_plan(self, feed) -> tuple[list, list, bool, float | None]:
        """A chunk drive's per-tick ingest: feed the batchers (a list of
        kline dicts, or a callable that loads them), drain both; returns
        ``(batches5, batches15, churn, ingest_mono)``."""
        if callable(feed):
            feed()
        else:
            for k in feed:
                self.ingest(k)
        version0 = self.registry.version
        ingest_mono = self._oldest_pending_mono()
        batches5 = self.batcher5.drain()
        batches15 = self.batcher15.drain()
        return batches5, batches15, self.registry.version != version0, ingest_mono

    async def _plan_tick(self, plan: dict | None, now_ms: int, batches5: list,
                         batches15: list, ingest_mono: float | None, t_plan0: float) -> dict:
        """Commit an eligible tick into the open plan (opening one): the
        mirror moves, the grid policy's momentum is judged on the breadth
        the PREVIOUS finalize saw, then this tick's bucket refreshes it."""
        if plan is None:
            plan = self._begin_scan_plan()
        self._note_applied(batches5, batches15)
        momentum_ok = self._grid_momentum_ok()
        await self._refresh_market_breadth((now_ms // 1000) // FIFTEEN_MIN_S)
        plan["ticks"].append(
            self._plan_scan_tick(now_ms, batches5, batches15, momentum_ok, ingest_mono)
        )
        # per-tick planning dwell, booked as the chunk's "plan" phase
        plan["plan_ms"] += (time.perf_counter() - t_plan0) * 1000.0
        return plan

    async def process_ticks_scanned(self, ticks) -> list:
        """Drive a sequence of replayed ticks, fusing eligible runs into
        scanned chunks (:func:`tick_step_scan`).

        ``ticks`` iterates ``(now_ms, feed)`` pairs, ``feed`` a list of
        kline dicts or a zero-argument callable that loads the batchers.
        Returns every emitted signal in tick order, each stamped with its
        tick's ``tick_ms``: the serial ``process_tick`` loop's contract and,
        by the chunk-break rules and the overflow re-drive, its signal set.
        A tick breaks the chunk and runs serially on a classic engine, after
        a dirty drain (a rewrite), churn (a claimed row), a desynced carry,
        or when its audit is due; runs shorter than ``_SCAN_MIN_TICKS`` run
        serially too."""
        # ticks in flight from before this drive still belong to the caller
        fired_all: list = await self.flush_pending()
        plan: dict | None = None
        for now_ms, feed in ticks:
            t_plan0 = time.perf_counter()
            batches5, batches15, churn, ingest_mono = self._drain_for_plan(feed)
            if churn:
                # the new row's carry needs a full recompute, and the
                # requeued serial dispatch below won't see the version move
                self._mark_carry_desynced("churn")
            clean = self._note_applied(batches5, batches15, commit=False)
            seq = self.ticks_processed + (0 if plan is None else len(plan["ticks"]))
            audit_due = (
                self.carry_audit_every > 0 and seq > 0 and seq % self.carry_audit_every == 0
            )
            scannable = (
                self.incremental
                and self.mesh is None
                and clean
                and not churn
                and self._carry_desync_reason is None
                and not audit_due
            )
            if not scannable:
                if plan is not None:
                    fired_all.extend(await self._flush_scan_plan(plan))
                    plan = None
                # the serial path judges the drain itself: hand it back
                self._requeue_batches(batches5, batches15)
                fired_all.extend(await self.process_tick(now_ms=now_ms))
                continue
            plan = await self._plan_tick(plan, now_ms, batches5, batches15, ingest_mono,
                                         t_plan0)
            if len(plan["ticks"]) >= self.scan_chunk:
                fired_all.extend(await self._flush_scan_plan(plan))
                plan = None
        if plan is not None:
            fired_all.extend(await self._flush_scan_plan(plan))
        return fired_all

    async def process_ticks_backtest(self, ticks, params=None, chunk=None) -> list:
        """Drive replayed ticks through the time-batched backtest backend
        (full-recompute semantics over ``(S, W+T)`` extended buffers; see
        ``binquant_tpu_torch/backtest``). Same contract as
        :meth:`process_ticks_scanned`."""
        from binquant_tpu_torch.backtest.driver import drive_ticks_backtest

        return await drive_ticks_backtest(self, ticks, params=params, chunk=chunk)

    def _begin_scan_plan(self) -> dict:
        """Plan-start snapshots: enough host state to re-judge the run's
        ticks serially (an overflow re-drive, a too-short run). The device
        anchor needs none: nothing dispatches while a plan accumulates and
        the chunk never writes ``self.state``."""
        # counts of update-only drains ride the next SERIAL tick's digest; a
        # chunk counts its own drains, so a stale accumulator is dropped
        self._ingest_fold_counts = None
        return {
            "ticks": [],
            "host_latest": {key: arr.copy() for key, arr in self._host_latest.items()},
            # an overflow re-drive replays the plan's ticks through
            # _note_applied again: the per-row counters must stay exactly-once
            "ingest_monitor": self.ingest_monitor.snapshot_state(),
            "plan_ms": 0.0,
        }

    def _requeue_batches(self, batches5: list, batches15: list) -> None:
        for b in batches5:
            self.batcher5.add_batch(*b)
        for b in batches15:
            self.batcher15.add_batch(*b)

    def _grid_momentum_ok(self) -> bool:
        """The host half of ``GridOnlyPolicy.resolve``: is a non-flat
        breadth-momentum reading available? The regime half runs per tick
        on the card."""
        momentum = read_breadth_momentum(self.market_breadth)
        return momentum is not None and momentum.leaning != "flat"

    def _plan_scan_tick(
        self, now_ms: int, batches5: list, batches15: list, momentum_ok: bool,
        ingest_mono: float | None = None,
    ) -> _ScanTickPlan:
        ts_s = now_ms // 1000
        bucket15 = ts_s // FIFTEEN_MIN_S
        at = self.at_consumer
        market_type = at.autotrade_settings.market_type
        btc = self.registry.row_of(self.btc_symbol)
        return _ScanTickPlan(
            now_ms=now_ms,
            ts5=(ts_s // FIVE_MIN_S) * FIVE_MIN_S - FIVE_MIN_S,
            ts15=bucket15 * FIFTEEN_MIN_S - FIFTEEN_MIN_S,
            bucket15=bucket15,
            batches5=batches5,
            batches15=batches15,
            momentum_ok=momentum_ok,
            breadth=self.market_breadth,
            tracked=self.registry.active_rows,
            adp=breadth_scalars(self.market_breadth),
            quiet=bool(is_quiet_hours(now=datetime.fromtimestamp(now_ms / 1000, tz=timezone.utc))),
            btc_row=-1 if btc is None else int(btc),
            rows=self.registry.frozen_rows(),
            is_futures=str(getattr(market_type, "value", market_type)).lower().endswith("futures"),
            dominance_is_losers=bool(getattr(at, "current_market_dominance_is_losers", False)),
            market_domination_reversal=bool(at.market_domination_reversal),
            ingest_mono=ingest_mono,
            oi=self._oi_rows(batches15),
        )

    async def _redrive_serial(self, plan: dict) -> list:
        """Run a plan's ticks through the serial path (a too-short run, an
        overflow re-drive): the mirror and the ingest monitor rewind to the
        plan's start first, so each tick is judged as the stream first was;
        each dispatches with its own plan-time registry occupancy."""
        self._host_latest = {key: arr.copy() for key, arr in plan["host_latest"].items()}
        self.ingest_monitor.restore_state(plan["ingest_monitor"])
        fired: list = []
        for p in plan["ticks"]:
            self._requeue_batches(p.batches5, p.batches15)
            self._tracked_override = p.tracked
            try:
                fired.extend(await self.process_tick(now_ms=p.now_ms))
            finally:
                self._tracked_override = None
        return fired

    def _open_chunk(self, drive: str, plan: dict, T: int):
        """Open a chunk's trace and host-phase accounting: the accumulated
        planning dwell lands as its "plan" phase (a span laid just before
        the chunk). Returns ``(trace, plan_ms, t_chunk0)``."""
        self._tick_seq += 1
        trace = self.tracer.begin_tick(self._tick_seq, tick_ms=plan["ticks"][-1].now_ms)
        trace.set_attr(path=drive)
        self.host_phase.begin_chunk(drive)
        plan_ms = float(plan["plan_ms"])
        self.host_phase.record(drive, "plan", plan_ms)
        t_chunk0 = time.perf_counter()
        if plan_ms:
            trace.record_span("plan", t_chunk0 - plan_ms / 1000.0, t_chunk0,
                              accumulated=True, ticks=T)
        return trace, plan_ms, t_chunk0

    async def _finalize_chunk(self, drive: str, plan: dict, wires: np.ndarray, trace,
                              plan_ms: float, t_chunk0: float) -> list:
        """Finalize a committed chunk's ticks in order from its landed
        ``(T, L)`` wires (decoded in one pass), then close its trace and
        accounting. Returns the emitted signals."""
        ticks = plan["ticks"]
        T = len(ticks)
        t_dec0 = time.perf_counter()
        seq = unpack_wire_block(
            wires, numeric_digest=self.numeric_digest, ingest_digest=self.ingest_digest
        )
        self.host_phase.record(drive, "decode", (time.perf_counter() - t_dec0) * 1000.0)
        per_tick_ms = (time.perf_counter() - t_chunk0) * 1000.0 / T
        fired_all: list = []
        t_fin0 = time.perf_counter()
        try:
            for i, p in enumerate(ticks):
                # finalize reads the breadth this tick's dispatch saw
                self.market_breadth = p.breadth
                pending = _PendingTick(
                    wire=None, host=wires[i], ready=None,
                    fallback=_scan_fallback_unavailable,
                    ts_ms=p.now_ms, ts5=p.ts5, ts15=p.ts15, bucket15=p.bucket15,
                    rows=p.rows, dispatched_at=t_chunk0, trace=NULL_TRACE,
                    ingest_mono=p.ingest_mono, drive=drive, unpacked=seq[i],
                )
                fired_all.extend(await self._finalize_tick(pending))
                self.tick_wall_ms.append(per_tick_ms)
                self.latency.record("tick_total", per_tick_ms)
                self.ticks_processed += 1
                self._last_tick_wall_s = time.time()
                TICKS.inc()
                get_event_log().tick = self.ticks_processed
        finally:
            # the chunk's trace closes after its finalizes (an errored
            # finalize still flight-records)
            trace.record_span("finalize", t_fin0, ticks=T)
            self.tracer.complete(trace, snapshot_fn=self._flight_snapshot)
            self.host_phase.note_chunk(
                drive, plan_ms + (time.perf_counter() - t_chunk0) * 1000.0, T
            )
        self.touch_heartbeat()
        return fired_all

    def _close_overflowed_chunk(self, drive: str, trace, plan_ms: float, t_chunk0: float,
                                T: int) -> None:
        """A chunk whose fired count overflowed: its outputs are dropped;
        close its trace and its accounting (the host spent that wall)."""
        trace.set_attr(overflow_rerun=True)
        self.tracer.complete(trace, snapshot_fn=self._flight_snapshot)
        self.host_phase.note_chunk(drive, plan_ms + (time.perf_counter() - t_chunk0) * 1000.0, T)

    async def _flush_scan_plan(self, plan: dict) -> list:
        """Dispatch one planned chunk through :func:`tick_step_scan` on a
        copy of the state, read its stacked wires in one copy, and commit
        the new state only when no tick's fired count overflowed the wire's
        compaction; otherwise drop the chunk and re-drive it serially (the
        serial path runs the overflow fallback), so the emitted set stays
        exact."""
        ticks = plan["ticks"]
        if not ticks:
            return []
        if len(ticks) < self._SCAN_MIN_TICKS or self.mesh is not None:
            return await self._redrive_serial(plan)
        # a depth >= 1 engine's still-pending serial ticks come first
        fired_all: list = await self.flush_pending()
        self._refuse_while_held("a scan chunk")
        T = len(ticks)
        depth = max(max(len(p.batches5), len(p.batches15), 1) for p in ticks)
        u5_rows = _max_rows([b for p in ticks for b in p.batches5])
        u15_rows = _max_rows([b for p in ticks for b in p.batches15])
        key = self._wire_enabled_key()
        trace, plan_ms, t_chunk0 = self._open_chunk("scanned", plan, T)
        try:
            with self.latency.stage("scan_chunk"), trace.span(
                "scan_chunk", ticks=T, depth=depth
            ), trace.activate():
                with trace.span("stack"), self.host_phase.phase("scanned", "stack"):
                    # the serial pairing: each tick's 5m and 15m batches
                    # start at the same slot, the shorter padded after
                    n_slots = [max(len(p.batches5), len(p.batches15), 1) for p in ticks]
                    upd5 = self._stack_slots(
                        [p.batches5 + [_EMPTY_BATCH] * (n - len(p.batches5))
                         for p, n in zip(ticks, n_slots)], T, depth, u5_rows,
                    )
                    upd15 = self._stack_slots(
                        [p.batches15 + [_EMPTY_BATCH] * (n - len(p.batches15))
                         for p, n in zip(ticks, n_slots)], T, depth, u15_rows,
                    )
                    inputs_seq, momentum_seq = self._stack_plan_inputs(ticks)
                    inputs_dev, momentum_dev, policy_prev = self._chunk_inputs_to_device(
                        inputs_seq, momentum_seq
                    )
                t_launch0 = time.perf_counter()
                with trace.span("dispatch"), self.host_phase.phase("scanned", "dispatch"):
                    _note_symbols_per_tick([b for p in ticks for b in p.batches5],
                                           [b for p in ticks for b in p.batches15])
                    # on a copy: self.state stays the pre-chunk anchor
                    new_state, wires_dev, _ = tick_step_scan(
                        self.state, upd5, upd15, inputs_dev, momentum_dev,
                        policy_prev, self.context_config, wire_enabled=key,
                        incremental=True, maintain_carry=True, params=self.strategy_params,
                        numeric_digest=self.numeric_digest, ingest_digest=self.ingest_digest,
                    )
                with trace.span("device_wait"), self.host_phase.phase("scanned", "device_wait"):
                    wires = wires_dev.cpu().numpy()
        except BaseException as exc:
            trace.mark_error(exc)
            self.tracer.complete(trace, snapshot_fn=self._flight_snapshot)
            raise
        self.freshness.observe_stage(
            "dispatch_to_fetch", (time.perf_counter() - t_launch0) * 1000.0
        )
        if np.any(wires[:, WIRE_FIRED_COUNT_OFF] > WIRE_MAX_FIRED):
            self._close_overflowed_chunk("scanned", trace, plan_ms, t_chunk0, T)
            self.scan_overflow_reruns += 1
            SCAN_OVERFLOW_RERUNS.inc()
            fired_all.extend(await self._redrive_serial(plan))
            return fired_all
        self.state = new_state
        self.scan_chunks += 1
        SCAN_CHUNKS.inc()
        self.incremental_ticks += T
        self.scanned_ticks += T
        SCANNED_TICKS.inc(T)
        self.last_path = "incremental"
        fired_all.extend(
            await self._finalize_chunk("scanned", plan, wires, trace, plan_ms, t_chunk0)
        )
        return fired_all

    def _stack_plan_inputs(self, ticks: list):
        """Stacked (T, ...) numpy HostInputs and the momentum vector of a
        list of :class:`_ScanTickPlan`: the one stacking both chunk drives
        share. ``grid_policy_allows`` is zeroed: both drives recompute it per tick
        on the card from their policy carry."""
        T = len(ticks)

        def col(name: str, dtype) -> np.ndarray:
            return np.asarray([getattr(p, name) for p in ticks], dtype=dtype)

        adp = np.asarray([p.adp for p in ticks], dtype=np.float32).reshape(T, 5)
        nan_oi = np.full(self.capacity, np.nan, dtype=np.float32)
        inputs_seq = HostInputs(
            tracked=np.stack([p.tracked for p in ticks]),
            btc_row=col("btc_row", np.int32),
            timestamp_s=col("ts15", np.int32),
            timestamp5_s=col("ts5", np.int32),
            oi_growth=np.stack([nan_oi if p.oi is None else p.oi for p in ticks]),
            adp_latest=adp[:, 0],
            adp_prev=adp[:, 1],
            adp_diff=adp[:, 2],
            adp_diff_prev=adp[:, 3],
            breadth_momentum_points=adp[:, 4],
            quiet_hours=col("quiet", np.bool_),
            grid_policy_allows=np.zeros((T,), np.bool_),
            is_futures=col("is_futures", np.bool_),
            dominance_is_losers=col("dominance_is_losers", np.bool_),
            market_domination_reversal=col("market_domination_reversal", np.bool_),
        )
        return inputs_seq, col("momentum_ok", np.bool_)

    def _chunk_inputs_to_device(self, inputs_seq: HostInputs, momentum_seq: np.ndarray):
        """One upload per leaf of a chunk's stacked inputs, plus the policy
        recursion's seed (the host's last finalized regime)."""
        dev = self.device
        inputs_dev = HostInputs(*(torch.from_numpy(np.ascontiguousarray(x)).to(dev)
                                  for x in inputs_seq))
        prev = torch.tensor(
            [self._last_regime is not None,
             -1 if self._last_regime is None else self._last_regime],
            dtype=torch.int32,
        ).to(dev)
        return inputs_dev, torch.from_numpy(momentum_seq).to(dev), (prev[0] != 0, prev[1])

    def _donation_mode(self) -> str | None:
        """How this dispatch treats the rings (the reference's modes):

        * None — the copying step (``donate`` off);
        * ``"single"`` — ``donate`` at depth <= 1: the folds and the step
          write the live rings in place. A tick always finalizes before the
          next dispatch writes them again, so its fallback's post-tick rings
          are still its own;
        * ``"double"`` — ``donate`` at depth >= 2: the live rings are copied
          into a recycled :class:`RingSlot` (:meth:`_take_slot`), which the
          folds and the step then write in place, so every in-flight tick's
          post state stays intact for its own fallback. A finalized tick's
          post rings return to the pool (:meth:`_rotate_spare`); a dispatch
          with no tick in flight pools the rings it replaced at once
          (:meth:`_release_rings`), so only the first tick allocates a slot.
          Every read and write stays on the one compute stream, so tick
          i+1's reads of a slot finish before tick i+2 writes it.
        """
        if not self.donate:
            return None
        return "single" if self.pipeline_depth <= 1 else "double"

    def _invalidate_spares(self, why: str) -> None:
        """Retire every slot of the current state lineage (a cold reset, a
        restore): the pool and the parking slot empty, and the generation
        moves on, so a pending tick of the old lineage pools nothing."""
        self._spare_slots.clear()
        self._deferred_spare = None
        self._state_generation += 1
        logging.info(
            "ring slots invalidated (%s); state generation now %d",
            why, self._state_generation,
        )

    def _pool_slot(self, slot: RingSlot) -> None:
        if len(self._spare_slots) < self._spare_slots_max:
            self._spare_slots.append(slot)

    def _take_slot(self, live) -> RingSlot:
        """The double-buffered dispatch's slot: the newest pooled one, or a
        fresh one (counted in ``fresh_slots``) when the pool is empty. A
        pooled slot that shares a storage with the live rings, or two of
        its planes one storage, is dropped for a fresh one."""
        slot = self._spare_slots.pop() if self._spare_slots else None
        if slot is None or not slot_is_free_of(slot, live):
            slot = empty_ring_slot(live)
            self.fresh_slots += 1
        return slot

    def _release_rings(self, live) -> None:
        """A double dispatch with no tick in flight: nothing reads the rings
        it replaced, nor the parking slot (those rings, or older ones a
        prune replaced), so both return to the pool now. This is where a
        parked slot is promoted: the dispatch after a parking always finds
        no tick in flight."""
        parked, self._deferred_spare = self._deferred_spare, None
        if parked is not None and parked[1] == self._state_generation and (
            slot_is_free_of(parked[0], self.state)
            and not slot_storages(parked[0]) & slot_storages(ring_slot_of(live))
        ):
            self._pool_slot(parked[0])
        if slot_is_free_of(ring_slot_of(live), self.state):
            self._pool_slot(ring_slot_of(live))

    def _rotate_spare(self, pending: _PendingTick) -> None:
        """After a double-buffered tick finalizes: its post rings return to
        the pool, or park while they are still the live rings (light load;
        :meth:`_release_rings` promotes them). A slot of a retired
        generation is dropped."""
        if pending.spare is None:
            return
        slot, gen = pending.spare
        if gen != self._state_generation:
            return
        if slot_is_free_of(slot, self.state):
            self._pool_slot(slot)
        else:
            self._deferred_spare = (slot, gen)

    def _ring_planes(self) -> list[torch.Tensor]:
        return slot_planes(ring_slot_of(self.state))

    def _reset_state_cold(self, why: str) -> None:
        """Replace an unusable engine state with a cold empty one: the
        engine recovers like a restart (strategies stay blind until the
        rings refill). Logged, counted in ``state_resets``."""
        self.state_resets += 1
        logging.error(
            "%s; resetting the engine state cold (reset #%d)", why, self.state_resets
        )
        self.state = self._fresh_state()
        # the slots may alias buffers of the failed lineage
        self._invalidate_spares(f"cold reset: {why}")
        for latest in self._host_latest.values():
            latest[:] = -1
        self._ingest_fold_counts = None
        self._carry_desync_reason = "cold_start"

    def _recover_after_inplace_failure(self, planes, versions) -> None:
        """A dispatch raised in in-place mode: if any ring plane was written
        (its version counter moved), the pre-tick rings are gone and the
        state is reset cold; otherwise the state is intact."""
        if any(p._version != v for p, v in zip(planes, versions)):
            self._reset_state_cold("an in-place tick failed after writing the rings")

    def _measure_drift(self, pairs: list[tuple], btc_row: int, ts_ms: int, span,
                       trace=NULL_TRACE) -> None:
        """The audit tick's carry-drift meter: replay this tick's
        carry-advancing folds on a FUNCTIONAL copy of ``self.state`` (the
        copying applies; the live rings are never written), then measure the
        final pair's advance against a fresh init. A failure is logged and
        counted, and the audit's resync proceeds."""
        try:
            st = self.state
            for a, b in pairs[:-1]:
                st = apply_updates_carry_step(st, a, b, btc_row=btc_row)
            drift = measure_carry_drift(st, *pairs[-1], btc_row)
        except Exception:
            self.drift.note_skipped()
            logging.exception("carry-drift metering failed; the audit proceeds unmeasured")
            return
        breached = self.drift.observe(
            drift, tick_ms=ts_ms, trace_id=trace.trace_id, snapshot_fn=self._flight_snapshot
        )
        span.set(
            breached=len(breached),
            **{f"drift_{fam}": v["max_abs"] for fam, v in drift.items()},
        )

    def _start_wire_copy(self, wire: torch.Tensor) -> tuple[torch.Tensor, Any]:
        """Start the wire's copy to the host: on a card, non-blocking into
        the next pinned buffer of the rotation, on the compute stream, with
        an event recorded after it; on the CPU the wire is the host copy."""
        if wire.device.type != "cuda":
            return wire, None
        if self._wire_bufs is None:
            self._wire_bufs = [
                torch.empty(wire.shape, dtype=wire.dtype, pin_memory=True)
                for _ in range(self.pipeline_depth + 1)
            ]
        host = self._wire_bufs[self._wire_slot]
        self._wire_slot = (self._wire_slot + 1) % len(self._wire_bufs)
        host.copy_(wire, non_blocking=True)
        ready = torch.cuda.Event()
        ready.record()
        return host, ready

    async def _dispatch_tick(self, ts_ms: int) -> _PendingTick:
        """Open this tick's trace (or NULL_TRACE when sampled out) and
        dispatch it. The trace rides the ``_PendingTick`` and is completed
        at finalize; a dispatch that raises completes it errored first (no
        ``_PendingTick`` will carry it)."""
        self._tick_seq += 1
        trace = self.tracer.begin_tick(self._tick_seq, tick_ms=ts_ms)
        try:
            return await self._dispatch_tick_inner(ts_ms, trace)
        except BaseException as exc:
            trace.mark_error(exc)
            self.tracer.complete(trace, snapshot_fn=self._flight_snapshot)
            raise

    async def _dispatch_tick_inner(self, ts_ms: int, trace=NULL_TRACE) -> _PendingTick:
        self._refuse_while_held("a tick dispatch")
        t_plan0 = time.perf_counter()
        ts_s = ts_ms // 1000
        # evaluate against the bar that just CLOSED
        bucket15 = ts_s // FIFTEEN_MIN_S
        ts15 = bucket15 * FIFTEEN_MIN_S - FIFTEEN_MIN_S
        ts5 = (ts_s // FIVE_MIN_S) * FIVE_MIN_S - FIVE_MIN_S
        with self.latency.stage("breadth_refresh"), trace.span("breadth_refresh"):
            await self._refresh_market_breadth(bucket15)

        with self.latency.stage("ingest_drain"), trace.span("ingest_drain") as sp_drain:
            # backlog at dispatch: how many deduped candles this tick drains
            QUEUE_DEPTH.labels(queue="batcher5").set(len(self.batcher5))
            QUEUE_DEPTH.labels(queue="batcher15").set(len(self.batcher15))
            # the ingest-arrival anchor: the oldest candle THIS tick drains
            # (read before the drain resets the stamps)
            ingest_mono = self._oldest_pending_mono()
            registry_version0 = self.registry.version
            batches5 = self.batcher5.drain()
            batches15 = self.batcher15.drain()
            if self.registry.version != registry_version0:
                # a symbol claimed a row in this drain: its carry was built
                # on whatever window the last full recompute saw
                self._mark_carry_desynced("churn")
            # a mid-history rewrite leaves the latest bar alone, so the
            # device carry cannot see it: the host mirror does
            clean_appends = self._note_applied(batches5, batches15)
            sp_drain.set(
                batches5=len(batches5), batches15=len(batches15),
                clean_appends=clean_appends,
            )
            if not clean_appends:
                self._mark_carry_desynced("rewrite")
            # open-interest growth of the rows with fresh 15m candles: cache
            # reads only, the background refresh owns the REST traffic
            oi = self._oi_rows(batches15)
        # the window reads the EVALUATED tick time, so replays are deterministic
        quiet = is_quiet_hours(now=datetime.fromtimestamp(ts_ms / 1000, tz=timezone.utc))
        btc = self.registry.row_of(self.btc_symbol)
        btc_row = -1 if btc is None else int(btc)

        with trace.span("route_decision") as sp_route:
            use_incremental, reason = self._route()
            if self.incremental:
                if use_incremental:
                    self.incremental_ticks += 1
                else:
                    self.full_recompute_ticks += 1
                    FULL_RECOMPUTE.labels(reason=reason).inc()
                    self.full_recompute_reasons[reason] = (
                        self.full_recompute_reasons.get(reason, 0) + 1
                    )
            path = "incremental" if use_incremental else "full"
            sp_route.set(path=path, full_recompute_reason=reason)
            trace.set_attr(path=path if reason is None else f"{path}:{reason}")
        self.last_path = "incremental" if use_incremental else (reason or "classic")
        # plan: breadth refresh, drain and routing; stack: the audit, the
        # folds and the inputs below
        self.host_phase.record("serial", "plan", (time.perf_counter() - t_plan0) * 1000.0)
        t_stack0 = time.perf_counter()

        # the drain's device pairs (built here only for the meter; the
        # folds build them otherwise, or stack a deep drain themselves)
        pairs = None
        if reason == "audit" and self.drift_meter_enabled:
            pairs = self._slot_pairs(batches5, batches15)
            # before the folds: the meter measures what this tick's
            # updates do to the carry, then the full step resyncs it
            with self.latency.stage("carry_audit"), trace.span("carry_audit") as sp_audit:
                self._measure_drift(pairs, btc_row, ts_ms, sp_audit, trace)

        mode = self._donation_mode()
        inplace = mode is not None
        cfg, key = self.context_config, self._wire_enabled_key()
        # a classic engine never reads the carry: no rebuild on its ticks
        flags = dict(
            incremental=use_incremental, maintain_carry=self.incremental,
            params=self.strategy_params,
            numeric_digest=self.numeric_digest, ingest_digest=self.ingest_digest,
        )
        planes = self._ring_planes()
        versions = [p._version for p in planes]
        live = self.state
        idle = not self._pending
        if mode == "double":
            # the live rings stay intact for the in-flight ticks' fallbacks:
            # this tick writes a recycled slot holding a copy of them
            self.state = into_ring_slot(live, self._take_slot(live))
        try:
            with trace.span("buffer_fold", advance_carry=use_incremental):
                u5, u15 = self._fold_updates(
                    batches5, batches15, advance_carry=use_incremental, btc_row=btc_row,
                    inplace=inplace, pairs=pairs,
                )
            t_inputs0 = time.perf_counter()
            inputs = self._host_inputs(btc_row, ts15, ts5, quiet, oi)
            self.latency.record("inputs_build", (time.perf_counter() - t_inputs0) * 1000.0)
            trace.record_span("inputs_build", t_inputs0)
            self.host_phase.record(
                "serial", "stack", (time.perf_counter() - t_stack0) * 1000.0
            )
            t_dispatch0 = time.perf_counter()
            # the step applies the drain's final slot pair
            n_slots = max(len(batches5), len(batches15), 1)
            _note_symbols_per_tick(batches5[n_slots - 1:], batches15[n_slots - 1:])
            pre = self.state
            step = tick_step_wire_inplace if inplace else tick_step_wire
            # a record_function range per tick while a profiler window is open
            step_ctx = (
                step_annotation(self._tick_seq)
                if profiler_window_active()
                else contextlib.nullcontext()
            )
            with self.latency.stage("device_dispatch"), trace.span(
                "device_dispatch", incremental=use_incremental, donated=inplace
            ), trace.activate(), step_ctx:
                self.state, wire = step(
                    pre, u5, u15, inputs, cfg, wire_enabled=key,
                    ingest_fold_counts=self._take_ingest_fold_counts(), **flags,
                )
                host, ready = self._start_wire_copy(wire)
        except BaseException:
            if mode == "double":
                # only the slot was written: drop it, keep the live state
                self.state = live
            elif inplace:
                self._recover_after_inplace_failure(planes, versions)
            raise
        if not use_incremental:
            self._carry_desync_reason = None
        spare = None
        if mode == "double":
            spare = (ring_slot_of(self.state), self._state_generation)
            if idle:
                self._release_rings(live)
        if inplace:
            self.inplace_ticks += 1
            # the pre-tick rings are gone: re-evaluate from this tick's
            # POST-tick rings, captured now (at depth >= 2 later dispatches
            # replace self.state before this tick finalizes; at depth <= 1
            # none writes them before then), with empty batches and the
            # pre-tick small carries, which the step left untouched
            small = small_carries_of(pre)
            empty = self._empty_updates()

            def fallback(_args=(self.state, small, inputs, cfg, key, flags, empty)):
                post, small_, inp, cfg_, key_, flags_, emp = _args
                st = with_small_carries(post, small_)
                _, full = tick_step(st, emp, emp, inp, cfg_, wire_enabled=key_, **flags_)
                return full
        else:
            # the copying step left the pre-tick state intact: re-run the
            # SAME path from it
            def fallback(_args=(pre, u5, u15, inputs, cfg, key, flags)):
                st, a, b, inp, cfg_, key_, flags_ = _args
                _, full = tick_step(st, a, b, inp, cfg_, wire_enabled=key_, **flags_)
                return full

        self.host_phase.record(
            "serial", "dispatch", (time.perf_counter() - t_dispatch0) * 1000.0
        )
        return _PendingTick(
            wire=wire,
            host=host,
            ready=ready,
            fallback=fallback,
            ts_ms=ts_ms,
            ts5=ts5,
            ts15=ts15,
            bucket15=bucket15,
            rows=self.registry.frozen_rows(),
            dispatched_at=time.perf_counter(),
            trace=trace,
            ingest_mono=ingest_mono,
            spare=spare,
        )

    def _oldest_pending_mono(self) -> float | None:
        """perf_counter of the oldest candle waiting in either batcher."""
        stamps = [
            m
            for m in (self.batcher5.first_pending_mono, self.batcher15.first_pending_mono)
            if m is not None
        ]
        return min(stamps) if stamps else None

    def _bar_close_ms(self, strategy: str, ts5: int, ts15: int) -> int:
        """Close time (ms) of the bar a strategy evaluated this tick: the
        anchor of every close→* freshness stamp."""
        bar_ts = ts5 + FIVE_MIN_S if strategy in FIVE_MIN_STRATEGIES else ts15 + FIFTEEN_MIN_S
        return bar_ts * 1000

    async def _finalize_tick(self, pending: _PendingTick) -> list:
        """Consume one dispatched tick's wire under its trace, then
        complete the trace (ring, ``trace`` event, flight recorder) even if
        finalize raised."""
        trace = pending.trace
        with trace.activate():
            try:
                return await self._finalize_tick_inner(pending)
            except BaseException as exc:
                trace.mark_error(exc)
                raise
            finally:
                self.tracer.complete(trace, snapshot_fn=self._flight_snapshot)
                self._rotate_spare(pending)

    async def _finalize_tick_inner(self, pending: _PendingTick) -> list:
        ts5, ts15 = pending.ts5, pending.ts15
        trace, drive = pending.trace, pending.drive
        # the tick's one device-to-host copy: wait for it to land (the
        # copy's CUDA event, nothing else), then read it; the pinned buffer
        # goes back into the rotation. A chunk drive's tick arrives landed
        # (a numpy row) and decoded.
        t_fetch0 = time.perf_counter()
        with self.latency.stage("wire_fetch"), trace.span("wire_fetch") as sp_wire:
            if pending.ready is not None:
                pending.ready.synchronize()
            host = pending.host
            self.last_wire = (
                host.numpy() if isinstance(host, torch.Tensor) else np.asarray(host)
            ).copy()
            unpacked = pending.unpacked
            if unpacked is None:
                unpacked = unpack_wire(
                    self.last_wire, numeric_digest=self.numeric_digest,
                    ingest_digest=self.ingest_digest,
                )
        t_fetch_end = time.perf_counter()
        self.host_phase.record(drive, "device_wait", (t_fetch_end - t_fetch0) * 1000.0)
        if self.freshness.enabled:
            # logical close→dispatch: this tick's clock vs the newest
            # evaluated bar's close
            close_ms = max(ts5 + FIVE_MIN_S, ts15 + FIFTEEN_MIN_S) * 1000
            self.freshness.observe_stage("close_to_dispatch", pending.ts_ms - close_ms)
            if pending.ingest_mono is not None:
                self.freshness.observe_stage(
                    "ingest_to_dispatch",
                    max((pending.dispatched_at - pending.ingest_mono) * 1000.0, 0.0),
                )
            self.freshness.observe_stage(
                "dispatch_to_fetch", (t_fetch_end - pending.dispatched_at) * 1000.0
            )
        t_decode0 = t_fetch_end
        fired_w, ctx = unpacked
        sp_wire.set(overflow=bool(fired_w.overflow))
        BC_DIRTY_ROWS.set(int(ctx.get("bc_dirty_rows", 0) or 0))
        if "numeric_digest" in ctx:
            with trace.span("numeric_digest") as sp_num:
                digest = self.numeric.observe(
                    ctx["numeric_digest"],
                    tick_ms=pending.ts_ms,
                    trace_id=trace.trace_id,
                    snapshot_fn=self._flight_snapshot,
                )
                sp_num.set(nan_rows=digest["nan_total"], inf_rows=digest["inf_total"])
        if "ingest_digest" in ctx:
            with trace.span("ingest_digest") as sp_ing:
                idig = self.ingest_monitor.observe_digest(
                    ctx["ingest_digest"],
                    tick_ms=pending.ts_ms,
                    trace_id=trace.trace_id,
                    snapshot_fn=self._flight_snapshot,
                )
                sp_ing.set(
                    stale_rows=idig["stale_total"],
                    fresh5=idig["5m"]["fresh"],
                    fresh15=idig["15m"]["fresh"],
                )
        outputs = None
        if fired_w.overflow:
            self.overflow_ticks += 1
            OVERFLOW_TICKS.inc()
            with self.latency.stage("overflow_fallback"), trace.span(
                "overflow_fallback", overflow=True
            ):
                outputs = pending.fallback()
        regime = ctx["market_regime"]
        has_ctx = ctx["valid"]
        self.grid_only_policy = GridOnlyPolicy.resolve(
            regime if has_ctx else None, self.market_breadth
        )
        self.at_consumer.grid_only_policy = self.grid_only_policy
        # the regime-transition digest
        digest = self.notifier.build_message(ctx)
        if digest:
            self.telegram_consumer.dispatch_signal(digest)
        if has_ctx:
            # leverage calibration once per 15m bucket, from the wire's
            # calibration rows (the full outputs' context where absent)
            if "calib_valid" in ctx:
                calib = CalibrationInputs(
                    valid=ctx["calib_valid"],
                    close=ctx["calib_close"],
                    atr_pct=ctx["calib_atr_pct"],
                    regime=regime,
                    stress=ctx["market_stress_score"],
                    confidence=1.0,
                )
            else:
                if outputs is None:
                    outputs = pending.fallback()
                calib = outputs.context
            self._run_leverage_calibration(pending.bucket15, calib, rows=pending.rows)
            self._last_regime = regime
            self._last_transition_strength = ctx["market_regime_transition_strength"]
        else:
            self._last_regime = None
            self._last_transition_strength = 0.0
        t_emit = time.perf_counter()
        settings = self.at_consumer.autotrade_settings
        with trace.span("extract_fired") as sp_extract:
            fired = extract_fired(
                outputs,
                pending.rows,
                env=self.config.env,
                exchange=self.at_consumer.exchange,
                market_type=getattr(settings.market_type, "value", settings.market_type),
                settings=settings,
                enabled=self.enabled_strategies,
                skip=lambda strategy, row: self._already_emitted(
                    strategy, pending.rows.name_of(row), ts5, ts15
                ),
                unpacked=unpacked,
                diag_layout=EMISSION_LAYOUTS.get(self._wire_enabled_key()),
            )
            sp_extract.set(fired=len(fired))
        with trace.span("dedupe") as sp_dedupe:
            fired = self._dedupe_fired(fired, ts5, ts15)
            sp_dedupe.set(kept=len(fired))
        if trace.active:
            # provenance: every outbound payload joins back to the tick that
            # produced it, stamped BEFORE any sink sees it
            for signal in fired:
                signal.trace_id = trace.trace_id
                signal.tick_seq = trace.tick_seq
                signal.value.metadata["trace_id"] = trace.trace_id
                signal.value.metadata["tick_seq"] = trace.tick_seq
                signal.analytics["trace_id"] = trace.trace_id
                signal.analytics["tick_seq"] = trace.tick_seq
                signal.message += f"\n- Trace: {trace.trace_id}/{trace.tick_seq}"
        # the fan-out match: the deduped, stamped fired set against the
        # subscription planes on the device, frames minted and appended to
        # the outbox; the hub handoff rides the delivery plane's fanout
        # lane when it is on, else the plane offers to connections here
        if self.fanout is not None and fired:
            with trace.span("fanout_match") as sp_fanout:
                fanout_stats = self.fanout.on_fired(fired, ctx, tick_ms=pending.ts_ms)
                sp_fanout.set(**fanout_stats)
        # decode done (wire -> deduped, stamped signals); emit is sink work
        t_emit_phase0 = time.perf_counter()
        self.host_phase.record(drive, "decode", (t_emit_phase0 - t_decode0) * 1000.0)
        with trace.span("emission", signals=len(fired)):
            for signal in fired:
                signal.tick_ms = pending.ts_ms
                # per-signal freshness, stamped BEFORE any sink sees it
                sink_acks: dict[str, float] | None = None
                lag0: float | None = None
                if self.freshness.enabled:
                    lag0 = pending.ts_ms - self._bar_close_ms(signal.strategy, ts5, ts15)
                    signal.freshness_ms = round(
                        lag0 + (time.perf_counter() - pending.dispatched_at) * 1000.0, 3
                    )
                    signal.analytics["freshness_ms"] = signal.freshness_ms
                    signal.value.metadata["freshness_ms"] = signal.freshness_ms
                    sink_acks = {}
                if self.delivery is not None:
                    # the tick's whole cost of delivery: a WAL put (fsynced)
                    # and the queue puts; the workers do the rest
                    with trace.span(
                        "delivery.enqueue", strategy=signal.strategy, symbol=signal.symbol
                    ):
                        self.delivery.enqueue_fired(
                            signal,
                            tick_ms=pending.ts_ms,
                            lag0_ms=lag0,
                            dispatched_at=pending.dispatched_at,
                        )
                    # the plane's acks observe close→sink-ack per sink
                    sink_acks = None
                else:
                    await self._dispatch_inline(
                        signal, trace, pending.dispatched_at, lag0, sink_acks
                    )
                if self.freshness.enabled:
                    self.freshness.observe_signal(
                        strategy=signal.strategy,
                        symbol=signal.symbol,
                        close_to_emit_ms=signal.freshness_ms,
                        sink_ack_ms=sink_acks,
                        tick_ms=pending.ts_ms,
                        trace_id=signal.trace_id,
                        phases=self.host_phase.open_split(drive) or self.host_phase.last_chunk,
                        snapshot_fn=self._flight_snapshot,
                    )
        self.emit_ms.append((time.perf_counter() - t_emit) * 1000.0)
        self.latency.record("emission", self.emit_ms[-1])
        self.signals_emitted += len(fired)
        emit_lag_ms = (time.perf_counter() - pending.dispatched_at) * 1000.0
        self.latency.record("dispatch_to_emit", emit_lag_ms)
        event_log = get_event_log()
        for signal in fired:
            SIGNALS.labels(strategy=signal.strategy).inc()
            extra = {} if signal.freshness_ms is None else {"freshness_ms": signal.freshness_ms}
            event_log.emit(
                "signal",
                strategy=signal.strategy,
                symbol=signal.symbol,
                direction=str(signal.value.direction),
                autotrade=bool(signal.value.autotrade),
                tick_ms=pending.ts_ms,
                trace_id=signal.trace_id,
                tick_seq=signal.tick_seq,
                **extra,
            )
            self.latency.record(
                "candle_to_emit",
                pending.ts_ms - self._bar_close_ms(signal.strategy, ts5, ts15) + emit_lag_ms,
            )
        # the emitted set enters the open registry anchored on this tick's
        # evaluated 5m bar; everything due matures against the current ring
        if self.outcomes.enabled:
            for signal in fired:
                self.outcomes.register(
                    strategy=signal.strategy,
                    symbol=signal.symbol,
                    row=signal.row,
                    entry_ts5=ts5,
                    direction=signal.value.direction,
                    trace_id=signal.trace_id,
                    tick_seq=signal.tick_seq,
                    tick_ms=pending.ts_ms,
                )
            self.outcomes.on_tick(
                ts5, self.state if self.mesh is not None else self.state.buf5
            )
        self.host_phase.record(drive, "emit", (time.perf_counter() - t_emit_phase0) * 1000.0)
        return fired

    async def _dispatch_inline(
        self, signal, trace, dispatched_at: float, lag0: float | None, acks: dict | None
    ) -> None:
        """The three sinks called inline (the plane off), each in its span:
        each failure is logged and swallowed, so one sink cannot stop the
        others. With freshness on, ``acks`` gets each sink's close→return
        ms (the autotrade sink's only on success)."""

        def ack(sink: str) -> None:
            if acks is not None:
                acks[sink] = lag0 + (time.perf_counter() - dispatched_at) * 1000.0

        with trace.span("sink.analytics", strategy=signal.strategy, symbol=signal.symbol):
            dispatch_signal_record(self.binbot_api, signal.analytics)
        ack("analytics")
        with trace.span("sink.telegram", strategy=signal.strategy, symbol=signal.symbol):
            self.telegram_consumer.dispatch_signal(signal.message)
        ack("telegram")
        try:
            with trace.span("sink.autotrade", strategy=signal.strategy, symbol=signal.symbol):
                await self.at_consumer.process_autotrade_restrictions(signal.value)
            ack("autotrade")
        except Exception:
            logging.exception(
                "autotrade processing crashed for %s/%s; continuing",
                signal.strategy,
                signal.symbol,
            )

    async def aclose_delivery(self, drain_s: float = 5.0) -> None:
        """Retire the delivery plane (replay end, shutdown): a best-effort
        drain, then the workers stop and the WAL is compacted. Entries a
        down sink never acked stay durable for the next boot. Never on the
        tick path: a sink outage must not stall the tick."""
        if self.delivery is not None and self.delivery.started:
            await self.delivery.aclose(drain_s=drain_s)

    async def aclose_fanout(self) -> None:
        """Retire the fan-out plane: stop the hub (if served), emit the
        ``fanout_summary`` scoreboard, close the outbox."""
        if self.fanout is not None:
            await self.fanout.aclose()

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

    # -- checkpoint/resume ----------------------------------------------------------

    @contextlib.contextmanager
    def hold_state(self, why: str):
        """Hold the state for a reader (a checkpoint save, perhaps in a
        worker thread): a tick dispatched or a backfill flushed meanwhile
        raises instead of writing the rings under the reader."""
        self._state_holds += 1
        try:
            yield
        finally:
            self._state_holds -= 1

    def _refuse_while_held(self, what: str) -> None:
        if self._state_holds:
            raise RuntimeError(f"{what} while the engine state is held (a checkpoint save)")

    def host_carries(self) -> dict:
        """The JSON-serializable host state a restart needs for an identical
        next tick, under the reference's keys: the per-bar emission dedupe,
        the last regime, the notifier's last transition, the open outcome
        registry. The breadth and calibration bucket marks are not carried:
        the breadth series does not survive a restart."""
        return {
            "saved_at_s": time.time(),
            "ticks_processed": self.ticks_processed,
            "signals_emitted": self.signals_emitted,
            "last_regime": self._last_regime,
            "last_transition_strength": self._last_transition_strength,
            "last_emitted": [
                [strategy, symbol, ts] for (strategy, symbol), ts in self._last_emitted.items()
            ],
            "notifier_last_transition": self.notifier.last_transition_sent,
            "outcomes_open": self.outcomes.snapshot_open(),
        }

    def restore_host_carries(self, carries: dict) -> None:
        self.ticks_processed = int(carries.get("ticks_processed", 0))
        self.signals_emitted = int(carries.get("signals_emitted", 0))
        regime = carries.get("last_regime")
        self._last_regime = None if regime is None else int(regime)
        self._last_transition_strength = float(carries.get("last_transition_strength", 0.0))
        self._last_emitted = {
            (strategy, symbol): int(ts) for strategy, symbol, ts in carries.get("last_emitted", [])
        }
        notifier_last = carries.get("notifier_last_transition")
        self.notifier.last_transition_sent = None if notifier_last is None else int(notifier_last)
        self.outcomes.restore_open(carries.get("outcomes_open"))

    def note_state_restored(self, migrated: bool = False) -> None:
        """After a restore: rebuild the host's latest-open-time mirror from
        the restored rings (one copy to the host) and judge the carry. It
        is trusted only when its last bar times equal the rings' (an
        archive of a classic engine, or of an older version, holds none
        that match): otherwise the first tick recomputes in full
        (``cold_start``)."""
        shards = self.state.shards if self.mesh is not None else (self.state,)
        latest = np.concatenate(
            [
                torch.stack([ring_latest_times(st.buf5), ring_latest_times(st.buf15)])
                .cpu().numpy().astype(np.int64)
                for st in shards
            ],
            axis=1,
        )
        carry_ts = None
        if all(st.indicator_carry is not None for st in shards):
            carry_ts = np.concatenate(
                [
                    torch.stack([st.indicator_carry.pack5.last_ts,
                                 st.indicator_carry.pack15.last_ts])
                    .cpu().numpy().astype(np.int64)
                    for st in shards
                ],
                axis=1,
            )
        self._host_latest = {"5m": latest[0].copy(), "15m": latest[1].copy()}
        synced = not migrated and carry_ts is not None and np.array_equal(carry_ts, latest)
        self._carry_desync_reason = None if synced else "cold_start"

    def recover_if_state_poisoned(self) -> None:
        """After a swallowed tick error: a failed device computation
        surfaces at the first use of its outputs, so probe one small leaf
        with a synchronizing copy and reset the engine cold if the probe
        fails. A healthy state passes in microseconds."""
        try:
            shards = self.state.shards if self.mesh is not None else (self.state,)
            for st in shards:
                st.mrf_last_emitted[:1].cpu()
            return
        except Exception:
            pass
        self._reset_state_cold("engine state poisoned by a failed device computation")

    # -- liveness and health ------------------------------------------------------

    _HB_WARN_EVERY_S = 60.0

    def touch_heartbeat(self) -> None:
        """Write the liveness file (every ``process_tick``). A write
        failure is counted (``bqt_heartbeat_write_failures_total``; /healthz
        reads ``degraded`` while they persist) and its warning rate-limited.
        From the second tick on it also emits the boot's ``compile_summary``
        (once: the kernel builds are synchronous, so none is in flight)."""
        if self.ticks_processed > 1 and not LEDGER.summary_emitted:
            LEDGER.emit_summary(reason="boot")
        try:
            self.heartbeat_path.write_text(str(time.time()))
            self._last_heartbeat_s = time.time()
            self._hb_consecutive_failures = 0
        except OSError:
            self.heartbeat_write_failures += 1
            self._hb_consecutive_failures += 1
            HEARTBEAT_FAILURES.inc()
            now = time.monotonic()
            if now - self._hb_last_warn >= self._HB_WARN_EVERY_S:
                self._hb_last_warn = now
                logging.warning(
                    "failed to write heartbeat file (%d consecutive, %d total; further "
                    "warnings rate-limited to one per %.0fs)",
                    self._hb_consecutive_failures,
                    self.heartbeat_write_failures,
                    self._HB_WARN_EVERY_S,
                )

    def _flight_snapshot(self) -> dict:
        """The engine state a flight-recorder force-emit (slow or errored
        tick, SLO breach) attaches. Attribute reads only: no device read."""
        return {
            "queue_depth": {
                "batcher5": len(self.batcher5),
                "batcher15": len(self.batcher15),
            },
            "symbols": len(self.registry),
            "pending_ticks": len(self._pending),
            "ticks_processed": self.ticks_processed,
            "signals_emitted": self.signals_emitted,
            "overflow_ticks": self.overflow_ticks,
            "incremental_ticks": self.incremental_ticks,
            "full_recompute_ticks": self.full_recompute_ticks,
            "scanned_ticks": self.scanned_ticks,
            "backtest_ticks": self.backtest_ticks,
            "carry_desync_reason": self._carry_desync_reason,
            "numeric_anomaly_ticks": self.numeric.anomaly_ticks,
            "drift_alarms": self.drift.alarms,
            "ingest_anomaly_ticks": self.ingest_monitor.anomaly_ticks,
            "ingest_burning": self.ingest_monitor.burning,
            "freshness_slo_breaches": self.freshness.breaches,
            "host_phase_last_chunk": self.host_phase.last_chunk,
            "outcomes_open": len(self.outcomes._open),
            "outcome_evictions": self.outcomes.evictions,
            "delivery": (
                {
                    name: {
                        "queue": lane.queue.qsize(),
                        "breaker": lane.breaker.state,
                        "deferred": lane.deferred,
                    }
                    for name, lane in self.delivery._lanes.items()
                }
                if self.delivery is not None
                else None
            ),
            # fan-out plane pressure at the breach (attribute reads only)
            "fanout": (
                {
                    "users": len(self.fanout.subscriptions),
                    "published": self.fanout.published,
                    "connections": self.fanout.hub.connections,
                    "shed": self.fanout.hub.shed,
                }
                if self.fanout is not None
                else None
            ),
        }

    def health_snapshot(self, max_age_s: float | None = None) -> dict:
        """The ``/healthz`` JSON (``obs/exposition.py``), under the
        reference's keys. ``status``: ``ok`` — a heartbeat write succeeded
        within ``max_age_s`` (``Config.heartbeat_max_age_s`` by default);
        ``degraded`` — ticking, but heartbeat writes are failing, the
        websocket tracker is storming or ingest staleness is burning;
        ``stale`` — no successful heartbeat inside the window. Sections of
        parts the port lacks (the mesh) answer what the reference answers
        with those parts off; the
        ``fanout`` section is the plane's :meth:`FanoutPlane.snapshot`, or
        ``{"enabled": False}`` with it off.
        Attribute reads only, safe inline on the event loop: no device
        read."""
        if max_age_s is None:
            max_age_s = float(self.config.heartbeat_max_age_s)
        now = time.time()
        heartbeat_age = (
            None if self._last_heartbeat_s is None else round(now - self._last_heartbeat_s, 3)
        )
        last_tick_age = (
            None if self._last_tick_wall_s is None else round(now - self._last_tick_wall_s, 3)
        )
        if heartbeat_age is not None and heartbeat_age <= max_age_s:
            status = "degraded" if self._hb_consecutive_failures else "ok"
        else:
            status = "stale"
        ws = (self.ws_health or WS_HEALTH).snapshot()
        if status == "ok" and ws["storming"]:
            status = "degraded"
        ingest = self.ingest_monitor.snapshot()
        if status == "ok" and ingest["status"] == "degraded":
            status = "degraded"
        return {
            "status": status,
            "ws": ws,
            "heartbeat_age_s": heartbeat_age,
            "heartbeat_max_age_s": max_age_s,
            "heartbeat_write_failures": self.heartbeat_write_failures,
            "last_tick_age_s": last_tick_age,
            "ticks_processed": self.ticks_processed,
            "signals_emitted": self.signals_emitted,
            "overflow_ticks": self.overflow_ticks,
            "pending_ticks": len(self._pending),
            "incremental_enabled": self.incremental,
            "incremental_ticks": self.incremental_ticks,
            "full_recompute_ticks": self.full_recompute_ticks,
            # ticks whose rings were written in place (the live rings or a
            # recycled slot), and cold resets after an in-place failure
            "donated_ticks": self.inplace_ticks,
            "donated_state_resets": self.state_resets,
            "scanned_ticks": self.scanned_ticks,
            "scan_chunks": self.scan_chunks,
            "scan_overflow_reruns": self.scan_overflow_reruns,
            "backtest_ticks": self.backtest_ticks,
            "backtest_chunks": self.backtest_chunks,
            "backtest_overflow_reruns": self.backtest_overflow_reruns,
            "numeric": {
                "digest_enabled": self.numeric_digest,
                "nan_budget": self.numeric.nan_budget,
                "anomaly_ticks": self.numeric.anomaly_ticks,
                "last_digest": self.numeric.last,
                "drift_meter": self.drift_meter_enabled,
                "drift_tol": self.drift.tol,
                "drift_audits": self.drift.audits,
                "drift_alarms": self.drift.alarms,
                "drift_audits_unmeasured": self.drift.skipped,
                "last_drift": self.drift.last,
            },
            "ingest": ingest,
            "mesh": self._mesh_snapshot(),
            "eventlog_dropped": get_event_log().dropped,
            "last_tick_trace": self.tracer.last_tick_trace(),
            "latency": {
                "freshness": self.freshness.snapshot(),
                "host_phase": self.host_phase.snapshot(),
            },
            "outcomes": self.outcomes.scoreboard(),
            "delivery": (
                self.delivery.snapshot() if self.delivery is not None else {"enabled": False}
            ),
            "fanout": (
                self.fanout.snapshot() if self.fanout is not None else {"enabled": False}
            ),
            "slo": (
                self.slo.verdict() if self.slo is not None else {"enabled": False, "ok": None}
            ),
        }

    # -- the live loop ------------------------------------------------------------

    async def consume_loop(
        self,
        queue: asyncio.Queue,
        tick_interval_s: float = 1.0,
        clock: Callable[[], int] | None = None,
    ) -> None:
        """Drain the ingest queue continuously; evaluate once per interval.

        Each interval that brought candles runs one :meth:`process_tick`
        (at ``clock()`` ms, the wall clock by default), then with
        ``early_emit`` lands and emits that tick as soon as its wire copy
        completes, then on the checkpoint cadence finalizes what is in
        flight and saves in a worker thread (no tick is dispatched until
        the save returns). A quiet interval finalizes what is still in
        flight. A tick error is logged, the state is probed
        (:meth:`recover_if_state_poisoned`) and the loop goes on.

        The delivery plane starts up front, so the previous process's
        unacked WAL entries replay at boot, not at the first new signal.
        On cancellation the ticks in flight are flushed (their signals
        enqueued), then the plane is retired last: a best-effort drain of
        two seconds, and what a down sink never acked stays in the WAL for
        the next boot. The fan-out plane retires after it (its lane's last
        frames reach the connections first)."""
        if self.delivery is not None:
            self.delivery.start()
        try:
            await self._consume_loop_body(queue, tick_interval_s, clock)
        finally:
            if self._pending:
                try:
                    await self.flush_pending()
                except asyncio.CancelledError:
                    logging.warning("shutdown flush interrupted mid-emission")
                except Exception:
                    logging.exception("shutdown flush failed")
            try:
                await self.aclose_delivery(drain_s=2.0)
            except asyncio.CancelledError:
                logging.warning("shutdown delivery drain interrupted")
            except Exception:
                logging.exception("shutdown delivery close failed")
            try:
                await self.aclose_fanout()
            except asyncio.CancelledError:
                logging.warning("shutdown fanout close interrupted")
            except Exception:
                logging.exception("shutdown fanout close failed")

    async def _consume_loop_body(
        self,
        queue: asyncio.Queue,
        tick_interval_s: float,
        clock: Callable[[], int] | None,
    ) -> None:
        last_tick = 0.0
        while True:
            try:
                timeout = max(tick_interval_s - (time.monotonic() - last_tick), 0.01)
                try:
                    self.ingest(await asyncio.wait_for(queue.get(), timeout=timeout))
                    while True:
                        try:
                            self.ingest(queue.get_nowait())
                        except asyncio.QueueEmpty:
                            break
                except (TimeoutError, asyncio.TimeoutError):
                    pass
                QUEUE_DEPTH.labels(queue="ingest").set(queue.qsize())
                if time.monotonic() - last_tick >= tick_interval_s:
                    if len(self.batcher5) or len(self.batcher15):
                        last_tick = time.monotonic()
                        await self.process_tick(None if clock is None else clock())
                        if self.early_emit and self._pending:
                            await self.emit_ready()
                        if self.checkpoint is not None and self.checkpoint.should_save(self):
                            # the snapshot's host carries must match the
                            # state: finalize what is in flight first
                            await self.flush_pending()
                            await asyncio.to_thread(self.checkpoint.maybe_save, self)
                    elif self._pending:
                        # a quiet interval: land the last burst's signals now
                        last_tick = time.monotonic()
                        await self.flush_pending()
            except asyncio.CancelledError:
                raise
            except Exception:
                logging.exception("tick processing failed; continuing")
                self.recover_if_state_poisoned()
