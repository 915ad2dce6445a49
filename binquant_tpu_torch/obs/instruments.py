"""The metric families the port emits, defined once.

Port of the signal-outcome, binbot-client and checkpoint families of
``binquant_tpu/obs/instruments.py`` under the reference's names, so a
dashboard reads either package. Labels
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
