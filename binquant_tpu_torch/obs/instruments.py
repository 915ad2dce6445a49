"""The metric families the port emits, defined once.

Port of the signal-outcome, binbot-client, checkpoint, sink and
delivery-plane families of ``binquant_tpu/obs/instruments.py`` under the
reference's names, so a dashboard reads either package. Labels
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
    "Records behind head per consumer group: the sink workers (queued + "
    "inflight + WAL-deferred entries not yet acked).",
    labels=("group",),
)
