"""The metric families the port emits, defined once.

Port of the families of ``binquant_tpu/obs/instruments.py`` the port's
modules export (the signal outcomes, the binbot client, checkpoints, the
fan-out plane, the sinks, the delivery plane, the tick loop, traces, the
latency and ingest observatories, the numeric-health digest and the drift
meter, kernel builds, the symbol registry, the websocket connectors,
delivery health and the SLO plane), under the
reference's names and help texts, so a dashboard reads either package. Labels
are bounded sets (strategy names, horizons); symbols go in events, never in
labels.
"""

from __future__ import annotations

from binquant_tpu_torch.obs.registry import REGISTRY

# -- signal-outcome observatory (obs/outcomes.py) -----------------------------

SIGNAL_FWD_RETURN = REGISTRY.histogram(
    "bqt_signal_forward_return",
    "Direction-signed forward return of an emitted signal at a fixed "
    "horizon (5m bars past the entry anchor), gathered from the live ring "
    "at maturation. Positive = the signal's direction won.",
    labels=("strategy", "horizon"),
    buckets=(-0.1, -0.05, -0.02, -0.01, -0.005, -0.002, 0.0,
             0.002, 0.005, 0.01, 0.02, 0.05, 0.1),
)
SIGNAL_MAE = REGISTRY.histogram(
    "bqt_signal_mae",
    "Max adverse excursion within the horizon, in direction-signed "
    "return space (always <= 0; LONG reads the window's lowest low, "
    "SHORT the highest high).",
    labels=("strategy", "horizon"),
    buckets=(-0.2, -0.1, -0.05, -0.02, -0.01, -0.005, -0.002, -0.001, 0.0),
)
SIGNAL_MFE = REGISTRY.histogram(
    "bqt_signal_mfe",
    "Max favorable excursion within the horizon, in direction-signed "
    "return space (always >= 0).",
    labels=("strategy", "horizon"),
    buckets=(0.0, 0.001, 0.002, 0.005, 0.01, 0.02, 0.05, 0.1, 0.2),
)
SIGNAL_HIT_RATE = REGISTRY.gauge(
    "bqt_signal_hit_rate",
    "Fraction of matured signals per (strategy, horizon) whose "
    "direction-signed forward return was positive.",
    labels=("strategy", "horizon"),
)
OUTCOME_OPEN = REGISTRY.gauge(
    "bqt_signal_outcomes_open",
    "Open-signal registry occupancy: emitted signals with at least one "
    "horizon still maturing.",
)
OUTCOME_MATURED = REGISTRY.counter(
    "bqt_signal_outcomes_matured_total",
    "Matured (signal, horizon) outcome pairs per strategy and horizon.",
    labels=("strategy", "horizon"),
)
OUTCOME_EVICTIONS = REGISTRY.counter(
    "bqt_signal_outcome_evictions_total",
    "Open signals evicted unmatured because the registry hit its cap "
    "(oldest first).",
)
OUTCOME_TRUNCATED = REGISTRY.counter(
    "bqt_signal_outcomes_truncated_total",
    "Matured pairs excluded from the scoreboard because the ring no "
    "longer held the full horizon window or the row's history vanished.",
)

# -- the binbot REST client (io/binbot.py) and checkpoints (io/checkpoint.py) -

BINBOT_REQUESTS = REGISTRY.counter(
    "bqt_binbot_requests_total",
    "Binbot backend REST calls by method and outcome "
    "(ok / http_error / backend_error / transport_error).",
    labels=("method", "outcome"),
)
BINBOT_RETRIES = REGISTRY.counter(
    "bqt_binbot_retries_total",
    "Binbot REST retry outcomes: retry (a capped, jittered in-client "
    "retry ran after a transport error / 5xx) and exhausted (the retry "
    "budget was spent; the error surfaced to the caller and a "
    "binbot_retry_exhausted event recorded it).",
    labels=("outcome",),
)
CHECKPOINT_SAVES = REGISTRY.counter(
    "bqt_checkpoint_saves_total",
    "Engine-state snapshot attempts by outcome (ok / error).",
    labels=("outcome",),
)

# -- the subscription fan-out plane (fanout/) -----------------------------------

FANOUT_SUBSCRIPTIONS = REGISTRY.gauge(
    "bqt_fanout_subscriptions",
    "Live subscriptions compiled into the device bitset planes "
    "(user x symbols/strategies/regimes/min-strength).",
)
FANOUT_RECOMPILES = REGISTRY.counter(
    "bqt_fanout_recompiles_total",
    "Device plane resyncs by kind: incremental (dirty word columns "
    "scattered in one jit'd update after churn) vs full (first use, "
    "capacity growth, or a symbol-row refresh after registry churn — "
    "the only case that retraces the match kernel; the tick step never "
    "retraces either way).",
    labels=("kind",),
)
FANOUT_MATCH_DISPATCHES = REGISTRY.counter(
    "bqt_fanout_match_dispatches_total",
    "Per-tick subscription match kernel launches (one per fired tick, "
    "joining every deduped fired slot in a single dispatch).",
)
FANOUT_RECIPIENTS = REGISTRY.counter(
    "bqt_fanout_matched_recipients_total",
    "Total (signal, subscriber) matches the kernel produced.",
)
FANOUT_PUBLISHED = REGISTRY.counter(
    "bqt_fanout_published_total",
    "Signal frames entering the broadcast tier (outbox-appended; "
    "delivered to connections by the hub or the delivery worker).",
)
FANOUT_FRAMES = REGISTRY.counter(
    "bqt_fanout_frames_total",
    "Frames written to subscriber connections, per transport.",
    labels=("transport",),
)
FANOUT_CONNECTIONS = REGISTRY.gauge(
    "bqt_fanout_connections",
    "Open hub connections per transport (ws / sse).",
    labels=("transport",),
)
FANOUT_SHED = REGISTRY.counter(
    "bqt_fanout_shed_total",
    "Broadcast frames dropped by reason (slow_consumer: a connection's "
    "bounded queue was full; resume_overflow: a reconnect gap exceeded "
    "the queue) — counted, never silent; the client recovers by "
    "reconnecting with its cursor.",
    labels=("reason",),
)
FANOUT_RESUME_REPLAYED = REGISTRY.counter(
    "bqt_fanout_resume_replayed_total",
    "Frames replayed from the broadcast outbox to reconnecting clients "
    "presenting a cursor.",
)
FANOUT_RESUME_FALLBACK = REGISTRY.counter(
    "bqt_fanout_resume_fallback_total",
    "Cursor reconnects that could NOT be served from the hub's in-memory "
    "tail ring and fell back to a full outbox scan, by reason "
    "(tail_off: ring disabled; tail_cold: nothing broadcast yet this "
    "boot / ring invalidated by compaction; cursor_gap: cursor older "
    "than the retained ring; trace_cursor: provenance cursors resolve "
    "through the outbox).",
    labels=("reason",),
)
FANOUT_DELTA_WORDS = REGISTRY.histogram(
    "bqt_fanout_delta_words",
    "Words patched per incremental apply_subscription_deltas dispatch — "
    "the per-tick device cost of subscription churn (O(cells touched), "
    "independent of the resident population).",
    buckets=(1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0, 256.0, 512.0,
             1024.0, 4096.0),
)
FANOUT_COMPACTIONS = REGISTRY.counter(
    "bqt_fanout_compactions_total",
    "Tombstone-folding plane compactions (fragmentation crossed the "
    "fanout_compact_frac threshold): live slots re-packed dense, "
    "capacity shrunk toward the initial allocation, one counted FULL "
    "device resync.",
)
FANOUT_SNAPSHOT = REGISTRY.counter(
    "bqt_fanout_snapshot_total",
    "Fan-out snapshot sidecar operations by op (save / restore) and "
    "outcome (ok / rejected / error): the restart-warm boot path — "
    "rejected restores (torn save, version or plane-shape mismatch) "
    "fall back to a cold rebuild.",
    labels=("op", "outcome"),
)

# -- the sinks (io/telegram.py, io/autotrade.py, io/emission.py) ------------

SINK_EMISSIONS = REGISTRY.counter(
    "bqt_sink_emissions_total",
    "Per-sink emission outcomes (ok / error / retry / suppressed / "
    "attempt / refused / launched / grid_deployed).",
    labels=("sink", "outcome"),
)
AUTOTRADE_REFUSALS = REGISTRY.counter(
    "bqt_autotrade_refusals_total",
    "Autotrade admissions refused, by gate name.",
    labels=("gate",),
)
SINK_DELIVERY = REGISTRY.histogram(
    "bqt_sink_delivery_ms",
    "Per-sink delivery latency: candle close to the sink call returning "
    "(telegram measures the paced-queue enqueue ack, not wire delivery).",
    labels=("sink",),
    buckets=(1.0, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0, 1000.0,
             2500.0, 10000.0, 60000.0),
)

# -- the delivery plane (io/delivery.py) --------------------------------------

DELIVERY_ENQUEUED = REGISTRY.counter(
    "bqt_delivery_enqueued_total",
    "Signals accepted by the delivery plane per sink (finalize enqueues "
    "and returns; the WAL put for at-least-once sinks precedes this).",
    labels=("sink",),
)
DELIVERY_ACKED = REGISTRY.counter(
    "bqt_delivery_acked_total",
    "Deliveries the sink confirmed, per sink (at-least-once sinks also "
    "write the WAL ack record here).",
    labels=("sink",),
)
DELIVERY_RETRIES = REGISTRY.counter(
    "bqt_delivery_retries_total",
    "Failed delivery attempts per sink (each schedules a jittered "
    "exponential-backoff retry, or a shed once a lossy sink's attempt "
    "budget is spent).",
    labels=("sink",),
)
DELIVERY_SHED = REGISTRY.counter(
    "bqt_delivery_shed_total",
    "Lossy-class signals dropped by the plane, by reason (queue_full / "
    "breaker_open / retries_exhausted / encode_error). At-least-once "
    "sinks never appear here except queue_full with durability disabled.",
    labels=("sink", "reason"),
)
DELIVERY_BREAKER = REGISTRY.counter(
    "bqt_delivery_breaker_transitions_total",
    "Circuit-breaker state transitions per sink (open / half_open / "
    "closed); each also emits a delivery_breaker event.",
    labels=("sink", "state"),
)
DELIVERY_BREAKER_STATE = REGISTRY.gauge(
    "bqt_delivery_breaker_state",
    "Current circuit-breaker state per sink (0=closed, 1=half_open, "
    "2=open) — the level companion to the "
    "bqt_delivery_breaker_transitions_total edge counter.",
    labels=("sink",),
)
DELIVERY_QUEUE = REGISTRY.gauge(
    "bqt_delivery_queue_depth",
    "Outbox queue occupancy per sink (bounded by delivery_queue_max).",
    labels=("sink",),
)
DELIVERY_WAL_UNACKED = REGISTRY.gauge(
    "bqt_delivery_wal_unacked",
    "Write-ahead-log puts without an ack yet, per at-least-once sink — "
    "sustained growth means the sink is down and the outbox is absorbing.",
    labels=("sink",),
)
DELIVERY_WAL_REPLAYED = REGISTRY.counter(
    "bqt_delivery_wal_replayed_total",
    "Unacked WAL entries re-enqueued at boot (the previous process was "
    "killed between accept and sink ack) — the at-least-once replay path.",
    labels=("sink",),
)
DELIVERY_OLDEST_AGE = REGISTRY.gauge(
    "bqt_delivery_oldest_unacked_ms",
    "Age of the oldest unacked WAL record per at-least-once sink (wall "
    "clock since its put) — the outbox watermark: sustained growth means "
    "the head of the backlog is not moving.",
    labels=("sink",),
)
DELIVERY_CURSOR_LAG = REGISTRY.gauge(
    "bqt_delivery_cursor_lag",
    "Records behind head per consumer group: the three sink workers "
    "(queued + inflight + WAL-deferred entries not yet acked) and the "
    "fan-out hub as a fourth group (broadcast frames the laggiest open "
    "connection has not received).",
    labels=("group",),
)
FANOUT_CONN_QUEUE_DEPTH = REGISTRY.histogram(
    "bqt_fanout_conn_queue_depth",
    "Per-connection frame-queue occupancy sampled at every broadcast "
    "offer — the distribution (not just the max) of how far behind the "
    "hub's consumers run.",
    buckets=(0.0, 1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0, 256.0),
)
FANOUT_WRITE_LATENCY = REGISTRY.histogram(
    "bqt_fanout_write_latency_ms",
    "Subscriber match→socket-write latency per transport: the device "
    "match dispatch that selected the recipient to the frame leaving "
    "for that connection's socket.",
    labels=("transport",),
    buckets=(0.1, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0,
             1000.0, 5000.0),
)

# -- the multi-tick drives (io/pipeline.py, backtest/) ---------------------------

SCANNED_TICKS = REGISTRY.counter(
    "bqt_scanned_ticks_total",
    "Replayed ticks evaluated inside scanned chunks (replay, catch-up, "
    "backtesting lanes) instead of one serial tick each.",
)
SCAN_CHUNKS = REGISTRY.counter(
    "bqt_scan_chunks_total",
    "Scanned chunks committed (each replaces chunk-length serial ticks).",
)
SCAN_OVERFLOW_RERUNS = REGISTRY.counter(
    "bqt_scan_overflow_reruns_total",
    "Scan chunks re-driven through the serial per-tick path because a "
    "tick's fired set overflowed the wire's compaction slots.",
)
BACKTEST_TICKS = REGISTRY.counter(
    "bqt_backtest_ticks_total",
    "Replayed ticks evaluated inside time-batched backtest chunks "
    "(full-recompute (S, W+T) kernel) instead of one serial tick each.",
)
BACKTEST_CHUNKS = REGISTRY.counter(
    "bqt_backtest_chunks_total",
    "Time-batched backtest chunks committed.",
)
BACKTEST_OVERFLOW_RERUNS = REGISTRY.counter(
    "bqt_backtest_overflow_reruns_total",
    "Backtest chunks re-driven through the serial per-tick path because "
    "a tick's fired set overflowed the wire's compaction slots.",
)

# -- the tick loop (io/pipeline.py) and the heartbeat ---------------------------

TICKS = REGISTRY.counter(
    "bqt_ticks_total", "Engine ticks processed (one batched device step each)."
)

SIGNALS = REGISTRY.counter(
    "bqt_signals_total",
    "Signals emitted through the sinks, after per-bar dedupe.",
    labels=("strategy",),
)

OVERFLOW_TICKS = REGISTRY.counter(
    "bqt_wire_overflow_ticks_total",
    "Ticks whose fired set overflowed the wire's compaction slots "
    "(full-summary fallback ran).",
)

QUEUE_DEPTH = REGISTRY.gauge(
    "bqt_queue_depth",
    "Ingest backlog: asyncio queue (consume loop) and per-interval "
    "batcher pending-candle counts at tick dispatch.",
    labels=("queue",),
)

FULL_RECOMPUTE = REGISTRY.counter(
    "bqt_full_recompute_total",
    "Ticks routed to the full-window recompute while the incremental "
    "fast path is enabled, by reason (cold_start / rewrite / backfill / "
    "churn / audit). Full ticks re-anchor the carried indicator state.",
    labels=("reason",),
)

SYMBOLS_PER_TICK = REGISTRY.gauge(
    "bqt_symbols_per_tick",
    "Symbols with fresh candles applied in the last dispatched tick.",
    labels=("interval",),
)

BC_DIRTY_ROWS = REGISTRY.gauge(
    "bqt_bc_dirty_rows",
    "Beta/corr carry rows marked dirty on the last incremental tick "
    "(asymmetric append vs the BTC row; they decode as null until the "
    "next full-recompute resync) — sustained non-zero means resync "
    "pressure.",
)

STAGE_LATENCY = REGISTRY.histogram(
    "bqt_stage_latency_ms",
    "Per-stage pipeline latency in milliseconds (absorbs LatencyTracker; "
    "tick_total is the p99<50ms budget stage).",
    labels=("stage",),
)

HEARTBEAT_FAILURES = REGISTRY.counter(
    "bqt_heartbeat_write_failures_total",
    "Failed heartbeat-file writes (persistent failure degrades /healthz).",
)

EVENTLOG_DROPPED = REGISTRY.counter(
    "bqt_eventlog_dropped_total",
    "Event-log records dropped: the sink write failed, or emit was "
    "called after close().",
)


# -- tick traces (obs/tracing.py) and the latency observatory (obs/latency.py) ---

SLOW_TICKS = REGISTRY.counter(
    "bqt_slow_ticks_total",
    "Traced ticks whose busy time breached BQT_TRACE_SLOW_MS (or that "
    "errored), attributed to the dominant top-level stage; the flight "
    "recorder force-emits each one's span tree + engine snapshot.",
    labels=("stage",),
)

FRESHNESS = REGISTRY.histogram(
    "bqt_freshness_ms",
    "End-to-end signal freshness per stage: close_to_dispatch / "
    "ingest_to_dispatch / dispatch_to_fetch / close_to_emit / "
    "close_to_sink_ack. close_to_* stages are logical (measured against "
    "the tick's own clock — exact live, deterministic in replay); the "
    "rest are real monotonic deltas.",
    labels=("stage",),
    buckets=(1.0, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0, 1000.0,
             2500.0, 10000.0, 60000.0),
)

FRESHNESS_SLO_BREACHES = REGISTRY.counter(
    "bqt_freshness_slo_breaches_total",
    "Signals whose worst close→sink-ack exceeded BQT_FRESHNESS_SLO_MS "
    "(each force-emits a freshness_slo_breach event with the producing "
    "chunk's host-phase breakdown).",
)

HOST_PHASE = REGISTRY.histogram(
    "bqt_host_phase_ms",
    "Host-phase dwell per drive (serial / scanned / backtest) and phase "
    "(plan / stack / dispatch / device_wait / decode / emit) — one "
    "observation per tick on the serial drive, per chunk-level bracket "
    "on the batch drives.",
    labels=("drive", "phase"),
    buckets=(0.1, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0,
             1000.0, 5000.0),
)

CHUNK_OCCUPANCY = REGISTRY.gauge(
    "bqt_chunk_occupancy_ratio",
    "The newest chunk's wall-clock split per drive: device_wait (blocking "
    "wire fetch — a lower bound on device busy), host (named host "
    "phases), dead_gap (unattributed residual), each as a fraction of "
    "chunk wall.",
    labels=("drive", "component"),
)


# -- numeric-health digest and carry-drift meter (obs/numeric.py) ---------------

NUMERIC_NONFINITE = REGISTRY.gauge(
    "bqt_numeric_nonfinite_rows",
    "Rows with NaN/Inf leakage on the last digest-carrying tick, per "
    "pipeline stage (features5 / features15 / indicators / strategies), "
    "counted only among rows whose data-sufficiency gates promise finite "
    "values — warm-up NaN is excluded by construction.",
    labels=("stage", "kind"),
)

NUMERIC_ANOMALIES = REGISTRY.counter(
    "bqt_numeric_anomaly_ticks_total",
    "Ticks whose digest NaN/Inf leakage exceeded BQT_NUMERIC_NAN_BUDGET "
    "(each force-emits a numeric_anomaly event with the decoded digest "
    "and an engine snapshot).",
)

NUMERIC_ABSMAX = REGISTRY.gauge(
    "bqt_numeric_absmax",
    "Absolute-max of key device intermediates on the last digest-carrying "
    "tick (close5 / close15 / volume5 / volume15 / score) — a runaway "
    "series shows here before it NaNs.",
    labels=("series",),
)

FIRED_PER_TICK = REGISTRY.histogram(
    "bqt_fired_rows_per_tick",
    "Device-side per-strategy trigger counts per digest-carrying tick "
    "(pre-dedupe, pre-enablement-filter) — the fired-breadth histogram.",
    labels=("strategy",),
    buckets=(0.0, 1.0, 2.0, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0),
)

CARRY_DRIFT = REGISTRY.histogram(
    "bqt_carry_drift",
    "Max-abs drift between the carried indicator state and the fresh "
    "full-recompute values, measured per family at every audit tick "
    "BEFORE the resync overwrites the carry (BQT_CARRY_AUDIT_EVERY).",
    labels=("family",),
    buckets=(1e-7, 1e-6, 1e-5, 1e-4, 1e-3, 1e-2, 1e-1, 1.0, 10.0, 100.0),
)

CARRY_DRIFT_ULP = REGISTRY.gauge(
    "bqt_carry_drift_ulp",
    "Max f32-ULP distance of the last audit tick's carried-vs-fresh "
    "comparison, per family.",
    labels=("family",),
)

CARRY_DRIFT_ALARMS = REGISTRY.counter(
    "bqt_carry_drift_alarms_total",
    "Audit ticks where a family's scale-normalized drift (each leaf's "
    "max-abs over that leaf's magnitude scale, maxed across the family's "
    "leaves) exceeded BQT_DRIFT_TOL — each force-emits a "
    "carry_drift_alarm event.",
    labels=("family",),
)


# -- kernel builds (obs/ledger.py) ----------------------------------------------

COMPILE_SECONDS = REGISTRY.counter(
    "bqt_compile_seconds",
    "Wall seconds spent compiling each engine-owned jit executable "
    "(first launch per dispatch signature; persistent-cache hits "
    "deserialize in ~100ms and still count here).",
    labels=("executable",),
)


# -- the ingest observatory (engine/buffer.py, obs/ingest.py) -------------------

INGEST_DEDUP_OVERWRITES = REGISTRY.counter(
    "bqt_ingest_dedup_overwrites_total",
    "Pending candles overwritten before drain by a re-sent (symbol, "
    "open_time) — the keep-last dedupe evicting the stale payload.",
)

REGISTRY_SYMBOLS = REGISTRY.gauge(
    "bqt_registry_symbols",
    "Occupied symbol rows in the device ring buffer registry.",
)

REGISTRY_CAPACITY_ERRORS = REGISTRY.counter(
    "bqt_registry_capacity_errors_total",
    "Symbol-add attempts refused because the registry overflowed "
    "BQT_MAX_SYMBOLS.",
)


# -- websocket ingest (io/websocket.py) -----------------------------------------

WS_FRAMES = REGISTRY.counter(
    "bqt_ws_frames_total",
    "Raw websocket frames received, per exchange (all message kinds).",
    labels=("exchange",),
)

WS_RECONNECTS = REGISTRY.counter(
    "bqt_ws_reconnects_total",
    "Websocket client drops that entered the reconnect-backoff loop.",
    labels=("exchange",),
)

WS_PARSE_ERRORS = REGISTRY.counter(
    "bqt_ws_parse_errors_total",
    "Websocket frames that failed JSON/shape parsing, per exchange — a "
    "poisoned feed shows here (plus rate-limited ws_bad_frame events), "
    "not just in the error log.",
    labels=("exchange",),
)

INGEST_TRACKED = REGISTRY.gauge(
    "bqt_ingest_tracked_rows",
    "Tracked registry rows on the last ingest-digest tick (the universe "
    "the staleness/coverage counts below are judged over).",
)

INGEST_STALE = REGISTRY.gauge(
    "bqt_ingest_stale_rows",
    "Tracked rows with data whose newest bar's age exceeds the bucket "
    "threshold (1x / 3x / 10x the bar interval; cumulative thresholds — "
    "a row counted under 10x also counts under 1x), per interval, on the "
    "last digest tick. Sustained non-zero means per-symbol feed death.",
    labels=("interval", "bucket"),
)

INGEST_COVERAGE = REGISTRY.gauge(
    "bqt_ingest_coverage_rows",
    "Coverage funnel per interval on the last digest tick: covered "
    "(tracked rows holding any data) -> min_bars (filled >= MIN_BARS, "
    "strategy-sufficient) -> fresh (sufficient AND holding the evaluated "
    "bucket's bar).",
    labels=("interval", "stage"),
)

INGEST_MAX_AGE = REGISTRY.gauge(
    "bqt_ingest_max_age_seconds",
    "Age of the stalest tracked row's newest bar per interval on the "
    "last digest tick (0 when every covered row is fresh).",
    labels=("interval",),
)

INGEST_APPLIED = REGISTRY.counter(
    "bqt_ingest_applied_total",
    "Update-batch routing decoded from the per-tick ingest digest, per "
    "interval and kind (append / rewrite / gap_append / dropped) — "
    "device-classified with apply_updates' exact rules, summed over "
    "every sub-batch each finalized tick applied.",
    labels=("interval", "kind"),
)

INGEST_FEED_LAG = REGISTRY.histogram(
    "bqt_ingest_feed_lag_ms",
    "Exchange feed lag per candle at ingest: host wall-clock arrival "
    "minus the candle's close_time, per exchange. Replay lanes carry "
    "historical close times, so their readings saturate the top bucket "
    "by design.",
    labels=("exchange",),
    buckets=(50.0, 100.0, 250.0, 500.0, 1000.0, 2500.0, 5000.0, 15000.0,
             60000.0, 300000.0),
)

INGEST_ANOMALIES = REGISTRY.counter(
    "bqt_ingest_anomaly_ticks_total",
    "Digest ticks whose 1x-stale row total exceeded "
    "BQT_INGEST_STALE_BUDGET (each force-emits an ingest_anomaly event "
    "with the decoded digest, the worst symbols, and an engine snapshot).",
)

INGEST_CHURN = REGISTRY.counter(
    "bqt_ingest_churn_total",
    "Symbol churn observed by the ingest monitor: a known symbol's "
    "registry row moved (listing churn re-homing) or the engine marked "
    "a churn carry-desync.",
)

INGEST_OOO = REGISTRY.counter(
    "bqt_ingest_out_of_order_total",
    "Host-classified non-append deliveries per interval (a candle at or "
    "behind the row's latest applied bar: same-bar rewrites and "
    "mid-history corrections/drops).",
    labels=("interval",),
)


# -- delivery health (obs/delivery_health.py) and the SLO plane (obs/slo.py) ----

DELIVERY_LAG = REGISTRY.histogram(
    "bqt_delivery_lag_ms",
    "End-to-end delivery lag per sink: candle close to the sink's FINAL "
    "successful ack (queue dwell + every retry/backoff included; "
    "WAL-replayed entries carry their original close anchor across the "
    "process kill). bqt_sink_delivery_ms predates the plane and keeps "
    "its freshness-gated semantics; this family is the ack-side truth.",
    labels=("sink",),
    buckets=(1.0, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0, 1000.0,
             2500.0, 10000.0, 60000.0),
)

SLO_BURNING = REGISTRY.gauge(
    "bqt_slo_burning",
    "Whether the named SLO is currently burning (1) or clean (0) in the "
    "unified registry (obs/slo.py) — freshness / staleness / "
    "delivery.<sink>.",
    labels=("slo",),
)

SLO_BREACHES = REGISTRY.counter(
    "bqt_slo_breaches_total",
    "Failing observations per registered SLO (burn entry force-emits an "
    "slo_burn event; re-emits ride the BQT_SLO_EVENT_EVERY cadence).",
    labels=("slo",),
)

SLO_RECOVERIES = REGISTRY.counter(
    "bqt_slo_recoveries_total",
    "Burn→clean transitions per registered SLO (each emits an "
    "slo_recover event carrying the burn length).",
    labels=("slo",),
)
