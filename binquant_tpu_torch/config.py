"""Engine settings the live tick reads.

The port's own copy of the fields of ``binquant_tpu/config.py`` the ported
slices use, as one small dataclass built explicitly by the caller (no
environment parsing at import time).

Building one validates the environment as the reference's ``Config()``
does: outside ``ENV=CI`` each of the 17 variables of
:data:`REQUIRED_VARS` must be set and non-empty, or the constructor raises
:class:`~binquant_tpu_torch.exceptions.ConfigurationError` naming the
missing ones (a production deploy that forgets ``ENV`` fails loudly rather
than sliding into the CI bypass). ``env`` is the ``ENV`` the check reads;
a caller may pass it, as the stub engines do with ``ENV``'s value or
``"CI"`` when it is unset. The credentials and switches read from the same
variables: ``autotrade_enabled`` (``AUTOTRADE`` of 1/true/yes), the
Binance and KuCoin keys, and ``postgres_dsn`` (from ``POSTGRES_*``).

Defaults are the production shape:
2048 symbol rows, a 400-bar ring per interval, the incremental tick
(carried indicator state, resynced by a full recompute every
``carry_audit_every_ticks`` ticks; 0 disables the audit), and the
pipelined production loop:

* ``pipeline_depth`` — dispatch tick i, emit tick i-depth, whose wire
  copy has landed meanwhile; 0 is the serial (same-tick) loop;
* ``donate`` — the ring planes are written in place instead of cloned on
  every apply (the reference donates its state): at depth <= 1 the live
  rings themselves, at depth >= 2 a recycled slot the live rings are
  copied into first, so an in-flight tick's rings stay intact;
* ``early_emit`` — the live loop lands a dispatched tick's wire and emits
  it as soon as the copy completes (``SignalEngine.emit_ready``);
* ``numeric_digest`` / ``ingest_digest`` — the numeric-health and
  ingest-health blocks ride the wire, judged against
  ``numeric_nan_budget`` leaked rows and ``ingest_stale_budget`` stale
  rows per tick;
* ``drift_meter`` — every audit tick measures how far the carried
  indicator state drifted from a fresh recompute, alarming past
  ``drift_tol`` (scale-normalized);
* ``outcomes_enabled`` — every emitted signal registers with the outcome
  tracker and matures at ``outcome_horizons`` 5m bars against the live
  ring, at most ``outcome_cap`` open signals (``obs/outcomes.py``);
* ``checkpoint_path`` — where :class:`CheckpointManager` snapshots the
  engine every ``checkpoint_every_ticks`` ticks (empty: no checkpoints);
  ``ckpt_shards`` above 1 writes that many per-shard archives (0: the
  mesh size, 1 unsharded; a restore reads any count, ``io/checkpoint.py``);
* ``mesh_devices`` (``BQT_MESH_DEVICES``, read when the Config is built) —
  shard the symbol axis over this many cards (0 or 1: unsharded): a CUDA
  engine over ``cuda:0 .. cuda:N-1``, a CPU engine over N shards on the
  CPU; with fewer cards visible, or a capacity the count does not divide,
  it warns and runs unsharded (``parallel/mesh.py``);
* ``binbot_timeout_s``, ``binbot_retry_max``, ``binbot_retry_backoff_s`` —
  the binbot REST client's deadline per request and its bounded, jittered
  retries (``io/binbot.py``);
* ``delivery_enabled`` — finalize enqueues every fired signal into the
  delivery plane's per-sink outbox queues (``io/delivery.py``) instead of
  calling the sinks inline: ``delivery_wal_path`` is the at-least-once
  class's write-ahead log (empty: no durability; by default in the
  temporary directory, as the reference keeps it in ``/tmp``), ``delivery_queue_max``
  each sink's queue bound, ``delivery_attempt_timeout_s`` the deadline per
  attempt, ``delivery_retry_max`` a lossy entry's attempt budget,
  ``delivery_backoff_s``/``delivery_backoff_max_s`` the jittered
  exponential retry backoff, ``delivery_breaker_threshold`` the
  consecutive failures that open a sink's breaker and
  ``delivery_breaker_cooldown_s`` its open dwell before one probe,
  ``wal_compact_every`` the acks between WAL compactions (0: none). The
  WAL is fsynced on every record;
* ``telegram_bot_token``, ``telegram_user_id`` — the Telegram bot and the
  chat the alerts go to (``TELEGRAM_BOT_TOKEN``, ``TELEGRAM_USER_ID``);
* the service's own settings, read from the reference's environment
  variables when the Config is built: ``log_level`` (``LOG_LEVEL``,
  ``INFO``), ``event_log`` (``BQT_EVENT_LOG``: empty disables the
  structured event log, ``stderr``/``-`` writes to stderr, anything else is
  a rotating file), ``binbot_api_url`` (``BINBOT_API_URL``),
  ``profile_dir`` (``BQT_PROFILE_DIR``, where an on-demand profiler window
  writes its trace; by default in the temporary directory, as the
  reference keeps it in ``/tmp``) and ``profile_remote_ok``
  (``BQT_PROFILE_REMOTE=1`` lets a non-loopback peer open one); the ports
  the service serves, ``metrics_port`` (``BQT_METRICS_PORT``) and
  ``fanout_port``/``fanout_host`` (``BQT_FANOUT_PORT``,
  ``BQT_FANOUT_HOST``), and its checkpoint ``checkpoint_path``
  (``BQT_CHECKPOINT_PATH``) every ``checkpoint_every_ticks``
  (``BQT_CHECKPOINT_EVERY_TICKS``) ticks;
* the tick's observability, all on by default as in the reference:
  ``trace_sample`` (1 traces every tick, 0.25 every 4th, 0 none),
  ``trace_slow_ms`` (the flight recorder's busy-time budget) and
  ``trace_ring`` (completed traces kept) for ``obs/tracing.py``;
  ``freshness_enabled`` with ``freshness_slo_ms`` (0: no breach check) and
  ``host_phase_enabled`` for ``obs/latency.py``; ``slo_enabled`` with
  ``slo_window`` (the per-sink sample window of the delivery SLO's p99) and
  ``slo_event_every`` (burning observations between re-emitted ``slo_burn``
  events) for ``obs/slo.py``; ``delivery_health_enabled`` with
  ``delivery_slo_ms`` (0: no delivery SLO) for ``obs/delivery_health.py``;
  ``metrics_port`` (0: no ``/metrics`` server) and the liveness file
  ``heartbeat_path`` (in the temporary directory by default) with its
  staleness bound ``heartbeat_max_age_s`` for ``/healthz``;
* ``ingest_watermarks_enabled`` — the ingest monitor's watermark half
  (per-candle arrival and per-batch apply watermarks, ``symbols_report``).
  The port's own switch: the reference runs it whenever the ingest digest
  is on, as the port does by default. Off only to measure what it costs;
* ``fanout_enabled`` — the subscription fan-out plane (``fanout/``): user
  subscriptions compiled into bitset planes on the engine's device, every
  fired tick's deduped signals matched against them at finalize, the
  matched frames appended to the outbox and broadcast over the WS/SSE hub
  (behind the delivery plane when it is on). ``fanout_capacity`` is the
  initial user-slot capacity (rounded up to a multiple of 32; growing past
  it doubles the planes); ``fanout_port`` the hub's port (0: not served by
  the service; matching and the outbox still run) on ``fanout_host``;
  ``fanout_conn_queue`` each connection's bounded frame queue (a full one
  sheds, ``slow_consumer``); ``fanout_outbox_path`` the frame outbox a
  reconnecting cursor replays from (empty: no replay; by default in the
  temporary directory, as the reference keeps it in ``/tmp``) with
  ``fanout_outbox_cap`` entries a generation; ``fanout_outbox_shards``
  above 1 splits the outbox into that many partitions by the firing row's
  shard under one cursor, and ``fanout_snapshot_shards`` above 1 splits the
  snapshot's symbol rows into that many archives (0: the checkpoint's
  count);
  ``fanout_snapshot_path`` the snapshot-warm boot sidecar saved with every
  checkpoint (empty: none); ``fanout_compact_frac`` the freed/claimed slot
  fraction past which an unsubscribe compacts the planes (0: never);
  ``fanout_resume_tail`` the hub's in-memory ring of recent frames that
  serves a reconnect's cursor without an outbox scan (0: no ring);
* the multi-tick drives, read from the reference's environment variables
  when the Config is built (not at import): ``scan_chunk``
  (``BQT_SCAN_CHUNK``, 64) bounds the ticks of one chunk of the scanned
  drive (``SignalEngine.process_ticks_scanned``) and the sub-batch slots of
  one deep update-only fold; ``backtest_chunk`` (``BQT_BACKTEST_CHUNK``, 16)
  the ticks of one time-batched backtest chunk (``backtest/``), whose
  ``(T, S, W, F)`` window views make it the backend's memory knob;
  ``ext_invariant`` (``BQT_EXT_INVARIANT``, on) runs the backtest chunk's
  feature packs, symbol features and BTC block once over the ``(S, W+N)``
  extension instead of per tick over the views, held to the gate-margin
  contract instead of bit equality; ``sweep_mem_budget_mb``
  (``BQT_SWEEP_MEM_BUDGET_MB``, 1024) the device-memory budget from which
  ``run_param_sweep`` derives its chunk when none is given.
"""

from __future__ import annotations

import os
import tempfile
from dataclasses import dataclass, field

from binquant_tpu_torch.exceptions import ConfigurationError

REQUIRED_VARS = (
    "ENV",
    "BINBOT_API_URL",
    "TELEGRAM_BOT_TOKEN",
    "TELEGRAM_USER_ID",
    "BINANCE_API_KEY",
    "BINANCE_API_SECRET",
    "KUCOIN_API_KEY",
    "KUCOIN_API_SECRET",
    "KUCOIN_API_PASSPHRASE",
    "POSTGRES_HOST",
    "POSTGRES_PORT",
    "POSTGRES_DB",
    "POSTGRES_USER",
    "POSTGRES_PASSWORD",
    "BINANCE_KEY_ID",
    "AUTOTRADE",
    "LOG_LEVEL",
)


def _env_int(name: str, default: int) -> int:
    """An integer knob from the environment; unset or empty is ``default``."""
    return int(os.environ.get(name, "") or default)


def _env_str(name: str, default: str = "") -> str:
    return os.environ.get(name, default)


def _postgres_dsn() -> str:
    host = _env_str("POSTGRES_HOST", "localhost")
    port = _env_str("POSTGRES_PORT", "5432")
    db = _env_str("POSTGRES_DB", "binquant")
    user = _env_str("POSTGRES_USER", "postgres")
    pwd = _env_str("POSTGRES_PASSWORD", "")
    return f"postgresql://{user}:{pwd}@{host}:{port}/{db}"


@dataclass
class Config:
    max_symbols: int = 2048
    window_bars: int = 400
    pipeline_depth: int = 1
    donate: bool = True
    early_emit: bool = True
    incremental: bool = True
    carry_audit_every_ticks: int = 256
    numeric_digest: bool = True
    numeric_nan_budget: int = 0
    ingest_digest: bool = True
    ingest_stale_budget: int = 0
    drift_meter: bool = True
    drift_tol: float = 0.05
    outcomes_enabled: bool = True
    outcome_horizons: tuple[int, ...] = (1, 4, 16, 96)
    outcome_cap: int = 1024
    checkpoint_path: str = field(default_factory=lambda: os.environ.get("BQT_CHECKPOINT_PATH", ""))
    checkpoint_every_ticks: int = field(
        default_factory=lambda: _env_int("BQT_CHECKPOINT_EVERY_TICKS", 60)
    )
    ckpt_shards: int = 0
    mesh_devices: int = field(default_factory=lambda: _env_int("BQT_MESH_DEVICES", 0))
    binbot_timeout_s: float = 10.0
    binbot_retry_max: int = 2
    binbot_retry_backoff_s: float = 0.2
    delivery_enabled: bool = True
    delivery_wal_path: str = field(
        default_factory=lambda: os.path.join(tempfile.gettempdir(), "binquant_tpu.wal.jsonl")
    )
    delivery_queue_max: int = 512
    delivery_attempt_timeout_s: float = 5.0
    delivery_retry_max: int = 3
    delivery_backoff_s: float = 0.25
    delivery_backoff_max_s: float = 30.0
    delivery_breaker_threshold: int = 5
    delivery_breaker_cooldown_s: float = 30.0
    wal_compact_every: int = 256
    trace_sample: float = 1.0
    trace_slow_ms: float = 50.0
    trace_ring: int = 256
    freshness_enabled: bool = True
    freshness_slo_ms: float = 0.0
    host_phase_enabled: bool = True
    slo_enabled: bool = True
    slo_window: int = 512
    slo_event_every: int = 256
    delivery_health_enabled: bool = True
    delivery_slo_ms: float = 0.0
    metrics_port: int = field(default_factory=lambda: _env_int("BQT_METRICS_PORT", 0))
    heartbeat_path: str = field(
        default_factory=lambda: os.path.join(tempfile.gettempdir(), "binquant_tpu.heartbeat")
    )
    heartbeat_max_age_s: float = 1500.0
    ingest_watermarks_enabled: bool = True
    fanout_enabled: bool = True
    fanout_capacity: int = 1024
    fanout_port: int = field(default_factory=lambda: _env_int("BQT_FANOUT_PORT", 0))
    fanout_host: str = field(
        default_factory=lambda: os.environ.get("BQT_FANOUT_HOST", "") or "0.0.0.0"
    )
    fanout_conn_queue: int = 256
    fanout_outbox_path: str = field(
        default_factory=lambda: os.path.join(
            tempfile.gettempdir(), "binquant_tpu.fanout.jsonl"
        )
    )
    fanout_outbox_cap: int = 4096
    fanout_outbox_shards: int = 0
    fanout_snapshot_path: str = ""
    fanout_snapshot_shards: int = 0
    fanout_compact_frac: float = 0.5
    fanout_resume_tail: int = 1024
    scan_chunk: int = field(default_factory=lambda: _env_int("BQT_SCAN_CHUNK", 64))
    backtest_chunk: int = field(default_factory=lambda: _env_int("BQT_BACKTEST_CHUNK", 16))
    ext_invariant: bool = field(
        default_factory=lambda: os.environ.get("BQT_EXT_INVARIANT", "1") == "1"
    )
    sweep_mem_budget_mb: int = field(
        default_factory=lambda: _env_int("BQT_SWEEP_MEM_BUDGET_MB", 1024)
    )
    telegram_bot_token: str = field(default_factory=lambda: os.environ.get("TELEGRAM_BOT_TOKEN", ""))
    telegram_user_id: str = field(default_factory=lambda: os.environ.get("TELEGRAM_USER_ID", ""))
    log_level: str = field(default_factory=lambda: os.environ.get("LOG_LEVEL", "INFO"))
    event_log: str = field(default_factory=lambda: os.environ.get("BQT_EVENT_LOG", ""))
    binbot_api_url: str = field(
        default_factory=lambda: os.environ.get("BINBOT_API_URL", "http://localhost:8008")
    )
    profile_dir: str = field(
        default_factory=lambda: os.environ.get("BQT_PROFILE_DIR")
        or os.path.join(tempfile.gettempdir(), "bqt_profile")
    )
    profile_remote_ok: bool = field(
        default_factory=lambda: os.environ.get("BQT_PROFILE_REMOTE", "0") == "1"
    )
    autotrade_enabled: bool = field(
        default_factory=lambda: _env_str("AUTOTRADE", "false").lower() in {"1", "true", "yes"}
    )
    binance_api_key: str = field(default_factory=lambda: _env_str("BINANCE_API_KEY"))
    binance_api_secret: str = field(default_factory=lambda: _env_str("BINANCE_API_SECRET"))
    kucoin_api_key: str = field(default_factory=lambda: _env_str("KUCOIN_API_KEY"))
    kucoin_api_secret: str = field(default_factory=lambda: _env_str("KUCOIN_API_SECRET"))
    kucoin_api_passphrase: str = field(
        default_factory=lambda: _env_str("KUCOIN_API_PASSPHRASE")
    )
    postgres_dsn: str = field(default_factory=_postgres_dsn)
    env: str = field(default_factory=lambda: os.environ.get("ENV", ""))

    def __post_init__(self) -> None:
        if self.is_ci:
            return
        missing = [
            v for v in REQUIRED_VARS
            if not (self.env if v == "ENV" else os.environ.get(v))
        ]
        if missing:
            raise ConfigurationError(
                f"Missing required environment variables: {', '.join(sorted(missing))}"
            )

    @property
    def is_ci(self) -> bool:
        return self.env.upper() == "CI"
