"""Offline replay harness for the port.

Feeds a JSONL file of closed klines through the engine with every network
client stubbed: one engine tick per 15m delivery bucket, ``now_ms`` just
after the bucket's bars close. The sinks are the real ones (the delivery
plane on by default) over fakes: the binbot client over
:class:`StubSession`, the Telegram consumer over a recording transport
(``engine._telegram_sent``), and autotrade admission with autotrade off,
whose received payloads ``engine._autotrade_received`` keeps. Own copies of the reference's replay-file generator and
tick grouping (``binquant_tpu/io/replay.py``), so the two packages replay
identical streams: the reference's overflow drill
(:func:`generate_burst_replay`), its two dormant-strategy markets
(:func:`generate_dormant_replay`, :func:`generate_dormant_extended_replay`)
and its signal-outcome stream (:func:`generate_outcome_replay`). The binbot
backend is :class:`StubSession`, an in-memory fake behind the real client.
The same streams drive the per-symbol oracle on the host
(:func:`run_replay_oracle`, the ``--backend reference`` mode) and the A/B
check that holds the engine to it (:func:`run_replay_ab`).
"""

from __future__ import annotations

import asyncio
import atexit
import contextlib
import gzip
import json
import os
import re
import tempfile
import time
from collections import Counter
from pathlib import Path
from typing import Any

import numpy as np

from binquant_tpu_torch.config import Config
from binquant_tpu_torch.enums import market_regime_label
from binquant_tpu_torch.io.autotrade import AutotradeConsumer
from binquant_tpu_torch.io.binbot import BinbotApi
from binquant_tpu_torch.io.pipeline import SignalEngine, breadth_scalars
from binquant_tpu_torch.io.telegram import TelegramConsumer
from binquant_tpu_torch.obs.events import get_event_log
from binquant_tpu_torch.oracle import OracleEvaluator
from binquant_tpu_torch.regime.context import ContextConfig
from binquant_tpu_torch.regime.grid_policy import GridOnlyPolicy
from binquant_tpu_torch.schemas import (
    AutotradeSettingsSchema,
    MarketBreadthSeries,
    MarketType,
    TestAutotradeSettingsSchema,
)


class StubSession:
    """An in-memory binbot backend: records every request and answers it.

    ``breadth`` scripts the market-breadth payload (None: the empty
    series, which leaves the breadth-gated strategies dormant). A dict
    with a ``"schedule"`` key scripts one payload per market-breadth call
    instead (the engine refreshes once per 15m bucket, so entry k feeds
    bucket k); the last entry repeats, and the entry ``"error"`` answers
    HTTP 500, a stalled upstream whose engine keeps its previous series."""

    class _Resp:
        def __init__(self, payload: Any, status_code: int = 200) -> None:
            self._payload = payload
            self.status_code = status_code
            self.text = json.dumps(payload)

        def json(self) -> Any:
            return self._payload

    def __init__(self, breadth: dict | None = None) -> None:
        self.requests: list[tuple[str, str, Any]] = []
        self.breadth = breadth
        self._breadth_calls = 0

    def _breadth_payload(self):
        breadth = self.breadth
        if isinstance(breadth, dict) and "schedule" in breadth:
            schedule = breadth["schedule"]
            idx = min(self._breadth_calls, len(schedule) - 1)
            self._breadth_calls += 1
            entry = schedule[idx] if schedule else None
            if entry == "error":
                return self._Resp({"error": "breadth upstream down"}, 500)
            return self._Resp({"data": entry or {}})
        return self._Resp({"data": breadth or {}})

    def request(self, method: str, url: str, **kwargs):
        self.requests.append((method, url, kwargs.get("json")))
        if "available-fiat" in url:
            return self._Resp({"data": {"amount": 1000.0}})
        if "active-pairs" in url or "excluded" in url or "grid-ladders/active" in url:
            return self._Resp({"data": []})
        if "/bot" in url and method == "POST":
            return self._Resp(
                {"message": "ok", "error": 0,
                 "data": {"pair": "X", "id": "00000000-0000-0000-0000-000000000000"}}
            )
        if "activate" in url:
            return self._Resp({"message": "ok", "error": 0, "data": {"pair": "X"}})
        if "market-breadth" in url:
            return self._breadth_payload()
        return self._Resp({"data": {}})

    def get(self, url, params=None):
        return self.request("GET", url, params=params)


def make_stub_engine(
    capacity: int = 256,
    window: int = 200,
    breadth: dict | None = None,
    pipeline_depth: int | None = None,
    enabled_strategies: set[str] | None = None,
    context_config: ContextConfig | None = None,
    device: str | None = None,
    incremental: bool | None = None,
    carry_audit_every: int | None = None,
    donate: bool | None = None,
    numeric_digest: bool | None = None,
    ingest_digest: bool | None = None,
    drift_meter: bool | None = None,
    outcomes: bool | None = None,
    outcome_horizons: tuple[int, ...] | None = None,
    session=None,
    all_symbols: list | None = None,
    telegram_transport=None,
    delivery: bool | None = None,
    delivery_wal: str | None = None,
    delivery_overrides: dict | None = None,
    trace_sample: float | None = None,
    freshness: bool | None = None,
    host_phase: bool | None = None,
    freshness_slo_ms: float | None = None,
    slo: bool | None = None,
    delivery_health: bool | None = None,
    ingest_watermarks: bool | None = None,
    fanout: bool | None = None,
    fanout_overrides: dict | None = None,
    scan_chunk: int | None = None,
    backtest_chunk: int | None = None,
    ext_invariant: bool | None = None,
    mesh_devices: int | None = None,
) -> SignalEngine:
    """A SignalEngine wired to stubs (no network): a binbot client over
    ``session`` (a :class:`StubSession` serving ``breadth`` by default), a
    Telegram consumer whose transport records every sent text in
    ``engine._telegram_sent`` (``telegram_transport``, when given, is
    awaited first: raise in it to script a failed send, which is then not
    recorded), and an autotrade consumer on futures with autotrade off
    whose received payloads ``engine._autotrade_received`` keeps;
    small-universe context gates unless ``context_config`` is given.
    ``all_symbols`` is the symbol list leverage calibration diffs against
    (none by default). The recording transport needs no flood pacing, so
    the stub's Telegram consumer sends without the one-second spacing.

    The delivery plane is on unless ``delivery=False``. Without
    ``delivery_wal`` it writes a throwaway WAL in the temporary directory,
    removed at exit: a stub engine never shares the production default
    path. ``delivery_overrides`` sets config fields by name (drill-scale
    backoff, breaker and queue knobs).

    ``trace_sample``, ``freshness``, ``host_phase``, ``freshness_slo_ms``,
    ``slo`` and ``delivery_health`` set the tick's observability knobs
    (``Config.trace_sample``, ``freshness_enabled``, ``host_phase_enabled``,
    ``freshness_slo_ms``, ``slo_enabled``, ``delivery_health_enabled``); all
    on by default, as in production. A drive compared with a reference
    engine that runs with them off passes the same values here.
    ``ingest_watermarks`` (``Config.ingest_watermarks_enabled``, the port's
    own switch) turns the ingest monitor's watermark half off, so a drive
    can measure what it costs; the reference always runs it.

    The fan-out plane is on unless ``fanout=False``. Unless
    ``fanout_overrides`` names ``fanout_outbox_path``, each engine writes
    its own throwaway frame outbox in the temporary directory, removed at
    exit: a plane seeds its frame ``seq`` from a retained outbox, so engines
    sharing one would read each other's frames. ``fanout_overrides`` sets
    the other ``fanout_*`` fields by name.

    Runs on ``device`` — CUDA by default; raises when CUDA is missing unless
    ``device="cpu"``. Every other argument left None keeps the config's
    production default: depth 1 with rings in place, both digests, the drift
    meter, the outcome tracker and the delivery plane on, the incremental
    path with an audit every 256 ticks. ``scan_chunk``, ``backtest_chunk``
    and ``ext_invariant`` set the multi-tick drives' knobs (``Config``'s,
    read from the environment by default). ``mesh_devices`` shards the
    engine over a symbol mesh (``Config.mesh_devices``, read from
    ``BQT_MESH_DEVICES`` by default; a CPU engine gets that many shards on
    the CPU)."""
    config = Config(
        max_symbols=capacity, window_bars=window, env=os.environ.get("ENV", "CI")
    )
    overrides = {
        "pipeline_depth": pipeline_depth,
        "incremental": incremental,
        "carry_audit_every_ticks": carry_audit_every,
        "donate": donate,
        "numeric_digest": numeric_digest,
        "ingest_digest": ingest_digest,
        "drift_meter": drift_meter,
        "outcomes_enabled": outcomes,
        "delivery_enabled": delivery,
        "trace_sample": trace_sample,
        "freshness_enabled": freshness,
        "host_phase_enabled": host_phase,
        "freshness_slo_ms": freshness_slo_ms,
        "slo_enabled": slo,
        "delivery_health_enabled": delivery_health,
        "ingest_watermarks_enabled": ingest_watermarks,
        "scan_chunk": scan_chunk,
        "backtest_chunk": backtest_chunk,
        "ext_invariant": ext_invariant,
        "mesh_devices": mesh_devices,
    }
    for name, value in overrides.items():
        if value is not None:
            setattr(config, name, type(getattr(config, name))(value))
    if outcome_horizons is not None:
        config.outcome_horizons = tuple(int(h) for h in outcome_horizons)
    if delivery_wal is not None:
        config.delivery_wal_path = str(delivery_wal)
    elif config.delivery_enabled:
        config.delivery_wal_path = _throwaway_wal()
    for name, value in (delivery_overrides or {}).items():
        setattr(config, name, value)
    if fanout is not None:
        config.fanout_enabled = bool(fanout)
    if config.fanout_enabled and "fanout_outbox_path" not in (fanout_overrides or {}):
        config.fanout_outbox_path = _throwaway_path(".fanout.jsonl")
    for name, value in (fanout_overrides or {}).items():
        setattr(config, name, value)
    binbot_api = BinbotApi(
        "http://stub", session=session if session is not None else StubSession(breadth)
    )
    sent: list[str] = []

    async def capture_transport(chat_id: str, text: str) -> None:
        if telegram_transport is not None:
            await telegram_transport(chat_id, text)
        sent.append(text)

    telegram = TelegramConsumer(token="", chat_id="stub", transport=capture_transport)
    telegram._min_send_interval_seconds = 0.0
    at_consumer = _RecordingAutotrade(
        autotrade_settings=AutotradeSettingsSchema(
            autotrade=False, market_type=MarketType.FUTURES
        ),
        active_test_bots=[],
        all_symbols=list(all_symbols or []),
        test_autotrade_settings=TestAutotradeSettingsSchema(autotrade=False),
        active_grid_ladders=[],
        binbot_api=binbot_api,
    )
    engine = SignalEngine(
        config,
        binbot_api,
        telegram,
        at_consumer,
        window=window,
        device=device,
        context_config=context_config
        or ContextConfig(required_fresh_symbols=4, min_coverage_ratio=0.5),
        enabled_strategies=enabled_strategies,
    )
    engine._telegram_sent = sent
    engine._autotrade_received = at_consumer.received
    return engine


class _RecordingAutotrade(AutotradeConsumer):
    """The stub's autotrade consumer: admission as in production, and every
    payload it was handed kept in ``received``, in arrival order."""

    def __init__(self, **kwargs) -> None:
        super().__init__(**kwargs)
        self.received: list = []

    async def process_autotrade_restrictions(self, result) -> None:
        self.received.append(result)
        await super().process_autotrade_restrictions(result)


def _throwaway_wal() -> str:
    """A fresh WAL path in the temporary directory, removed at exit."""
    return _throwaway_path(".wal.jsonl")


def _throwaway_path(suffix: str) -> str:
    """A fresh file in the temporary directory, removed at exit with its
    ``.tmp`` and rotated ``.1`` siblings."""
    fd, path = tempfile.mkstemp(prefix="bqt_stub_", suffix=suffix)
    os.close(fd)

    def discard(path: str = path) -> None:
        for p in (path, path + ".tmp", path + ".1"):
            with contextlib.suppress(OSError):
                os.unlink(p)

    atexit.register(discard)
    return path


_NUMBER = re.compile(r"-?\d+(?:\.\d+)?(?:[eE][-+]?\d+)?")


def payloads_match(a: Any, b: Any, rtol: float = 1e-4, atol: float = 1e-4) -> bool:
    """Two delivered payloads (JSON-shaped: analytics records, Telegram
    texts, autotrade dumps) equal but for float rounding: the same keys,
    lengths, strings and booleans; numbers, and the numbers inside strings
    (a message's rounded values), within ``rtol``/``atol``. The absolute
    floor is a few float32 ulps of a price near 100, the scale of an
    indicator that is a difference of two price averages (MACD)."""
    if isinstance(a, bool) or isinstance(b, bool) or a is None or b is None:
        return a is b or a == b
    if isinstance(a, (int, float)) and isinstance(b, (int, float)):
        return bool(np.isclose(a, b, rtol=rtol, atol=atol, equal_nan=True))
    if isinstance(a, str) and isinstance(b, str):
        if a == b:
            return True
        if _NUMBER.split(a) != _NUMBER.split(b):
            return False
        return all(
            np.isclose(float(x), float(y), rtol=rtol, atol=atol)
            for x, y in zip(_NUMBER.findall(a), _NUMBER.findall(b), strict=True)
        )
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(
            payloads_match(a[k], b[k], rtol, atol) for k in a
        )
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(
            payloads_match(x, y, rtol, atol) for x, y in zip(a, b)
        )
    return a == b


def delivered_tuples(payloads, tracer=None) -> list[tuple]:
    """Autotrade payloads the delivery plane handed over → the
    :func:`signal_tuples` form, the tick time read from the ``delivery_id``
    each carries: an untraced id holds it (``t{tick_ms}/0/{strategy}/
    {symbol}``), a traced one (``{trace_id}/{tick_seq}/...``) is resolved
    through ``tracer``'s ring of completed traces (the engine's
    :class:`Tracer`). The ring keeps the last ``trace_ring`` ticks: a drive
    longer than that raises ``LookupError`` for its early entries."""
    ticks = {}
    if tracer is not None:
        ticks = {
            e["summary"]["trace_id"]: e["spans"]["attrs"]["tick_ms"] for e in tracer.entries()
        }
    out = []
    for p in payloads:
        tid = p.metadata["delivery_id"].split("/", 1)[0]
        if tid.startswith("t") and tid[1:].isdigit():
            tick_ms = int(tid[1:])
        elif tid in ticks:
            tick_ms = ticks[tid]
        else:
            ring = None if tracer is None else tracer._ring.maxlen
            raise LookupError(
                f"trace {tid} of {p.metadata['delivery_id']} is not in the tracer's ring "
                f"(trace_ring={ring}): a traced id resolves only for the last trace_ring "
                "ticks, so drive fewer ticks or raise trace_ring"
            )
        out.append((tick_ms, p.algorithm_name, p.symbol, str(p.direction), bool(p.autotrade)))
    return out


def load_klines_by_tick(path: str | Path) -> dict[int, list[dict]]:
    """Group a JSONL (optionally gzip) kline file by 15m delivery bucket; a
    line's optional ``_deliver_bucket`` key overrides its own bucket."""
    opener = gzip.open if str(path).endswith(".gz") else open
    klines_by_tick: dict[int, list[dict]] = {}
    with opener(path, "rt") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            k = json.loads(line)
            deliver = k.pop("_deliver_bucket", None)
            bucket = int(deliver) if deliver is not None else int(k["open_time"]) // 1000 // 900
            klines_by_tick.setdefault(bucket, []).append(k)
    return klines_by_tick


def tick_seq(path: str | Path) -> list[tuple[int, list[dict]]]:
    """One (now_ms, klines) tick per 15m delivery bucket, in order."""
    klines_by_tick = load_klines_by_tick(path)
    return [
        (
            (bucket + 1) * 900 * 1000,
            sorted(klines_by_tick[bucket], key=lambda k: k["open_time"]),
        )
        for bucket in sorted(klines_by_tick)
    ]


def signal_tuples(fired) -> list[tuple]:
    """Fired signals → ``(tick_ms, strategy, symbol, direction, autotrade)``."""
    return [
        (s.tick_ms, s.strategy, s.symbol, str(s.value.direction), bool(s.value.autotrade))
        for s in fired
    ]


def run_replay(
    path: str | Path,
    capacity: int = 256,
    window: int = 200,
    collect: list | None = None,
    breadth: dict | None = None,
    pipeline_depth: int | None = None,
    enabled_strategies: set | None = None,
    context_config: ContextConfig | None = None,
    device: str | None = None,
    incremental: bool | None = None,
    carry_audit_every: int | None = None,
    donate: bool | None = None,
    numeric_digest: bool | None = None,
    ingest_digest: bool | None = None,
    drift_meter: bool | None = None,
    dominance_is_losers: bool = False,
    market_domination_reversal: bool = False,
    outcomes: bool | None = None,
    outcome_horizons: tuple[int, ...] | None = None,
    collect_outcomes: list | None = None,
    delivery: bool | None = None,
    scanned: bool = False,
    scan_chunk: int | None = None,
) -> dict:
    """Replay a JSONL kline file; returns run statistics, the routing
    counters among them. With ``collect`` a list, every fired signal is
    appended as a :func:`signal_tuples` tuple. The engine's arguments are
    :func:`make_stub_engine`'s; the ticks still in flight at the end of the
    file are flushed, then the delivery plane is retired (drained, WAL
    compacted) and the fan-out plane after it. ``dominance_is_losers`` and
    ``market_domination_reversal`` script the host's market-dominance flags
    (the dominance-gated dormant strategies read them). With the outcome
    tracker on, the stats carry its scoreboard under ``outcomes`` and
    ``collect_outcomes`` (a list) receives the sorted matured set.
    ``scanned=True`` drives the same stream through
    :meth:`SignalEngine.process_ticks_scanned` (runs of clean-append
    incremental ticks fused into chunks of at most ``scan_chunk``): the
    serial drive's signal set by construction; the stats count its ticks,
    chunks and overflow re-drives."""
    engine = make_stub_engine(
        capacity=capacity,
        window=window,
        breadth=breadth,
        pipeline_depth=pipeline_depth,
        enabled_strategies=enabled_strategies,
        context_config=context_config,
        device=device,
        incremental=incremental,
        carry_audit_every=carry_audit_every,
        donate=donate,
        numeric_digest=numeric_digest,
        ingest_digest=ingest_digest,
        drift_meter=drift_meter,
        outcomes=outcomes,
        outcome_horizons=outcome_horizons,
        delivery=delivery,
        scan_chunk=scan_chunk,
    )
    engine.at_consumer.current_market_dominance_is_losers = dominance_is_losers
    engine.at_consumer.market_domination_reversal = market_domination_reversal
    seq = tick_seq(path)
    fired_total = 0
    t_start = time.perf_counter()

    def record(fired) -> None:
        nonlocal fired_total
        fired_total += len(fired)
        if collect is not None:
            collect.extend(signal_tuples(fired))

    async def drive() -> None:
        if scanned:
            record(await engine.process_ticks_scanned(seq))
        else:
            for tick_ms, klines in seq:
                for k in klines:
                    engine.ingest(k)
                record(await engine.process_tick(now_ms=tick_ms))
        record(await engine.flush_pending())
        await engine.aclose_delivery()
        await engine.aclose_fanout()

    asyncio.run(drive())
    wall = time.perf_counter() - t_start
    lat = np.asarray(engine.tick_wall_ms, dtype=np.float64)
    outcome_summary = None
    if engine.outcomes.enabled:
        if collect_outcomes is not None:
            collect_outcomes.extend(sorted(engine.outcomes.matured_set()))
        outcome_summary = engine.outcomes.scoreboard()
        get_event_log().emit("outcome_summary", **outcome_summary)
    return {
        **({"outcomes": outcome_summary} if outcome_summary else {}),
        "device": str(engine.device),
        "ticks": len(seq),
        "signals": fired_total,
        "wall_s": wall,
        "tick_p50_ms": float(np.percentile(lat, 50)) if lat.size else 0.0,
        "tick_p99_ms": float(np.percentile(lat, 99)) if lat.size else 0.0,
        "incremental_ticks": engine.incremental_ticks,
        "full_recompute_ticks": engine.full_recompute_ticks,
        "full_recompute_reasons": dict(engine.full_recompute_reasons),
        "overflow_ticks": engine.overflow_ticks,
        "inplace_ticks": engine.inplace_ticks,
        "state_resets": engine.state_resets,
        # the scanned drive's accounting (0 on the serial drive)
        "scanned_ticks": engine.scanned_ticks,
        "scan_chunks": engine.scan_chunks,
        "scan_overflow_reruns": engine.scan_overflow_reruns,
    }


def drive_oracle(
    evaluator: OracleEvaluator,
    seq,
    breadth: dict | None = None,
    dominance_is_losers: bool = False,
    market_domination_reversal: bool = False,
    collect_regimes: list | None = None,
) -> list[tuple]:
    """Feed ``(now_ms, klines)`` ticks to the per-symbol oracle and return
    the fired ``(tick_ms, strategy, symbol, direction, autotrade)`` tuples.
    The host's breadth handling is the engine's: the adp scalars from the
    (static) series by :func:`~binquant_tpu_torch.io.pipeline.breadth_scalars`,
    and the grid-only policy resolved from the PREVIOUS tick's regime (the
    engine reads last tick's policy and refreshes it after the evaluation).
    ``collect_regimes`` (a list) gets ``(tick_ms, regime label or None,
    transition strength)`` per tick."""
    mb = MarketBreadthSeries(**breadth) if breadth else None
    adp_latest, adp_prev, adp_diff, adp_diff_prev, _ = breadth_scalars(mb)
    policy = GridOnlyPolicy.disabled("not_evaluated")
    out: list[tuple] = []
    for tick_ms, klines in seq:
        for k in klines:
            evaluator.ingest(k)
        for strategy, sym, direction, autotrade in evaluator.evaluate(
            tick_ms,
            grid_policy_allows=policy.allow_grid_ladder,
            adp_latest=adp_latest,
            adp_prev=adp_prev,
            adp_diff=adp_diff,
            adp_diff_prev=adp_diff_prev,
            dominance_is_losers=dominance_is_losers,
            market_domination_reversal=market_domination_reversal,
        ):
            out.append((tick_ms, strategy, sym, direction, autotrade))
        # next tick's policy from THIS tick's regime (None when invalid)
        policy = GridOnlyPolicy.resolve(evaluator.last_regime, mb)
        if collect_regimes is not None:
            code = evaluator.last_regime
            collect_regimes.append(
                (tick_ms, market_regime_label(code) if code is not None else None,
                 float(evaluator.last_strength))
            )
    return out


def run_replay_oracle(
    path: str | Path,
    window: int = 200,
    breadth: dict | None = None,
    enabled_strategies: set | None = None,
    dominance_is_losers: bool = False,
    market_domination_reversal: bool = False,
    collect_regimes: list | None = None,
) -> list[tuple]:
    """Replay a kline file through the legacy per-symbol backend
    (``--backend reference``) on the host; returns the fired ``(tick_ms,
    strategy, symbol, direction, autotrade)`` tuples. Its context gates are
    the stub engine's (4 fresh symbols, half the tracked ones)."""
    evaluator = OracleEvaluator(
        window=window,
        required_fresh_symbols=4,
        min_coverage_ratio=0.5,
        is_futures=True,
        enabled_strategies=enabled_strategies,
    )
    return drive_oracle(
        evaluator, tick_seq(path), breadth, dominance_is_losers,
        market_domination_reversal, collect_regimes,
    )


def run_replay_ab(
    path: str | Path,
    capacity: int = 256,
    window: int = 200,
    breadth: dict | None = None,
    enabled_strategies: set | None = None,
    dominance_is_losers: bool = False,
    market_domination_reversal: bool = False,
    incremental: bool | None = None,
    donate: bool | None = None,
    scanned: bool = False,
    oracle_signals: list | None = None,
    device: str | None = None,
) -> dict:
    """A/B parity: the batched engine (on ``device``, the card by default)
    and the per-symbol oracle (on the host) replay the same file and must
    emit the same signal set. ``enabled_strategies`` sets the dispatch set
    of both; the dominance flags script the host's market-dominance state
    both read; ``scanned=True`` drives the engine through the scanned
    multi-tick drive. ``oracle_signals`` is a precomputed
    :func:`run_replay_oracle` run for these same arguments (several A/Bs of
    one file share one). The result keeps the reference's keys: ``tpu_*``
    name the batched engine's arm."""
    engine_signals: list[tuple] = []
    stats = run_replay(
        path,
        capacity=capacity,
        window=window,
        collect=engine_signals,
        breadth=breadth,
        enabled_strategies=enabled_strategies,
        dominance_is_losers=dominance_is_losers,
        market_domination_reversal=market_domination_reversal,
        incremental=incremental,
        donate=donate,
        scanned=scanned,
        device=device,
    )
    if oracle_signals is None:
        oracle_signals = run_replay_oracle(
            path, window=window, breadth=breadth,
            enabled_strategies=enabled_strategies,
            dominance_is_losers=dominance_is_losers,
            market_domination_reversal=market_domination_reversal,
        )
    engine_set, oracle_set = set(engine_signals), set(oracle_signals)
    per_tick = Counter(t for t, *_ in engine_set)
    return {
        "per_tick_max": max(per_tick.values()) if per_tick else 0,
        "match": engine_set == oracle_set,
        "tpu_count": len(engine_set),
        "oracle_count": len(oracle_set),
        "only_tpu": sorted(engine_set - oracle_set),
        "only_oracle": sorted(oracle_set - engine_set),
        "strategies": sorted({s for _, s, _, _, _ in engine_set}),
        "tpu_stats": stats,
    }


def kline_record(
    symbol: str, ts_s: int, interval_s: int, o, h, low, c, volume,
    trades: float = 300.0,
) -> dict:
    """One ExtendedKline-shaped dict (close_time = open+interval-1ms)."""
    return {
        "symbol": symbol,
        "open_time": ts_s * 1000,
        "close_time": (ts_s + interval_s) * 1000 - 1,
        "open": round(float(o), 6),
        "high": round(float(h), 6),
        "low": round(float(low), 6),
        "close": round(float(c), 6),
        "volume": round(float(volume), 3),
        "quote_asset_volume": round(float(volume * c), 3),
        "number_of_trades": trades,
        "taker_buy_base_volume": round(float(volume / 2), 3),
        "taker_buy_quote_volume": round(float(volume * c / 2), 3),
    }


def _kline_json(symbol, ts_s, interval_s, o, h, low, c, volume, trades=300.0) -> str:
    return json.dumps(kline_record(symbol, ts_s, interval_s, o, h, low, c, volume, trades)) + "\n"


def generate_replay_file(
    path: str | Path,
    n_symbols: int = 100,
    n_ticks: int = 150,
    seed: int = 7,
) -> None:
    """Synthesize a dual-interval (5m + 15m) market replay with crafted
    setups: an activity burst on S001's 5m stream, a MeanReversionFade hammer
    on S005's 15m stream and a LiquidationSweepPump pump on S003, on the last
    tick. Same generator, same seed, same file as the reference's."""
    rng = np.random.default_rng(seed)
    # 15m-bucket-aligned: the evaluated bar's open time is bucket*900-900
    t0 = 1_780_272_000
    px = 20 + rng.random(n_symbols) * 100

    with open(path, "w") as f:
        for tick in range(n_ticks):
            ts15 = t0 + tick * 900
            rets = rng.normal(0, 0.004, n_symbols)
            rets[5] -= 0.008
            last_tick = tick == n_ticks - 1
            if last_tick and n_symbols > 3:
                rets[0] = 0.005
                rets[3] = 0.03
            new_px = px * (1 + rets)
            for i in range(n_symbols):
                symbol = "BTCUSDT" if i == 0 else f"S{i:03d}USDT"
                o, c = px[i], new_px[i]
                vol15 = abs(rng.normal(1000, 200))
                if last_tick and i == 3:
                    vol15 *= 8.0
                h, low = max(o, c) * 1.002, min(o, c) * 0.998
                if last_tick and i == 5:
                    o = px[i] * 0.955
                    c = o * 1.003
                    h, low = c * 1.001, o * 0.997
                    new_px[i] = c
                    vol15 *= 3.0
                f.write(_kline_json(symbol, ts15, 900, o, h, low, c, vol15))
                sub_o = o
                for j in range(3):
                    frac = (j + 1) / 3
                    sub_c = o + (c - o) * frac
                    vol5 = vol15 / 3
                    sh, sl = max(sub_o, sub_c) * 1.001, min(sub_o, sub_c) * 0.999
                    if last_tick and i == 1:
                        if j < 2:
                            sub_c = sub_o * 1.003
                            sh, sl = sub_c * 1.001, sub_o * 0.999
                        else:
                            sub_c = sub_o * 1.03
                            sh, sl = sub_c * 1.002, sub_o * 0.998
                            vol5 *= 8.0
                        new_px[i] = sub_c
                    f.write(_kline_json(symbol, ts15 + j * 300, 300, sub_o, sh, sl, sub_c, vol5))
                    sub_o = sub_c
            px = new_px


def generate_burst_replay(
    path: str | Path,
    n_symbols: int = 160,
    n_ticks: int = 108,
    seed: int = 23,
) -> None:
    """A market-wide crash on the last tick that fires MeanReversionFade on
    every symbol at once: more fired (strategy, row) pairs than the wire's
    compaction slots (WIRE_MAX_FIRED = 128 at the default 160 symbols), so
    the overflow fallback runs from dispatch to emission. Same generator,
    same seed, same file as the reference's."""
    rng = np.random.default_rng(seed)
    t0 = 1_780_272_000
    px = 20 + rng.random(n_symbols) * 100

    with open(path, "w") as f:
        for tick in range(n_ticks):
            ts15 = t0 + tick * 900
            # a steady market-wide downtrend keeps every symbol's RSI pinned
            rets = rng.normal(-0.004, 0.002, n_symbols)
            new_px = px * (1 + rets)
            last_tick = tick == n_ticks - 1
            for i in range(n_symbols):
                symbol = "BTCUSDT" if i == 0 else f"S{i:03d}USDT"
                o, c = px[i], new_px[i]
                vol15 = abs(rng.normal(1000, 200))
                h, low = max(o, c) * 1.002, min(o, c) * 0.998
                if last_tick:
                    # a green hammer, market-wide: a deep gap down below the
                    # lower band, a green close, 3x volume
                    o = px[i] * 0.955
                    c = o * 1.003
                    h, low = c * 1.001, o * 0.997
                    new_px[i] = c
                    vol15 *= 3.0
                f.write(_kline_json(symbol, ts15, 900, o, h, low, c, vol15))
                sub_o = o
                for j in range(3):
                    sub_c = o + (c - o) * (j + 1) / 3
                    sh = max(sub_o, sub_c) * 1.001
                    sl = min(sub_o, sub_c) * 0.999
                    f.write(_kline_json(symbol, ts15 + j * 300, 300, sub_o, sh, sl, sub_c, vol15 / 3))
                    sub_o = sub_c
            px = new_px


def _write_bars(path: str | Path, bars: dict, t0: int) -> None:
    """Write :func:`dormant_market_bars`-shaped bars as a kline file: per
    tick, per symbol, the 15m bar then its three 5m sub-bars."""
    b15, b5 = bars["15m"], bars["5m"]
    n_ticks, n_symbols = b15["close"].shape
    with open(path, "w") as f:
        for tick in range(n_ticks):
            ts15 = t0 + tick * 900
            for i in range(n_symbols):
                symbol = "BTCUSDT" if i == 0 else f"S{i:03d}USDT"
                f.write(_kline_json(symbol, ts15, 900, *(b15[k][tick, i] for k in _OHLCV)))
                for j in range(3):
                    f.write(_kline_json(symbol, ts15 + j * 300, 300,
                                        *(b5[k][tick, i, j] for k in _OHLCV)))


_OHLCV = ("open", "high", "low", "close", "volume")


def _with_sub_bars(o, h, low, c, vol15, wick: float) -> dict:
    """The 15m bars and their three 5m sub-bars splitting each 15m move
    (open to close in thirds, wicks of ``wick`` either side, a third of the
    volume each); arrays (n_ticks, n_symbols) and (n_ticks, n_symbols, 3)."""
    sub_c = np.stack([o + (c - o) * ((j + 1) / 3) for j in range(3)], axis=-1)
    sub_o = np.concatenate([o[..., None], sub_c[..., :2]], axis=-1)
    return {
        "15m": dict(open=o, high=h, low=low, close=c, volume=vol15),
        "5m": dict(
            open=sub_o,
            high=np.maximum(sub_o, sub_c) * (1 + wick),
            low=np.minimum(sub_o, sub_c) * (1 - wick),
            close=sub_c,
            volume=np.repeat((vol15 / 3)[..., None], 3, axis=-1),
        ),
    }


def dormant_market_bars(n_symbols: int = 24, n_ticks: int = 130, seed: int = 23) -> dict:
    """The bars of :func:`generate_dormant_replay` as arrays: a calm RANGE
    market with crafted setups for three dormant strategies on the last
    tick (BuyTheDip, BBExtremeReversion, RangeBbRsiMeanReversion):

    * S002 — BuyTheDip: a −4% shelf drop starting ~22 bars before the end
      (inside the 24-bar lookback), a flat base, then a green reclaim bar
      over prev close + EMA20 on the final tick;
    * S003 — BBExtremeReversion: two consecutive hard red 15m bars ending
      below the 20-bar −2σ band (Connors RSI(2) pins to 0);
    * S004 — RangeBbRsiMeanReversion: a choppy zig-zag bleed (keeps the
      rolling-sum ADX under 32 while RSI(14) sits ≤35) ending in a hammer
      that undershoots −2σ, closes green near its high, below the mid.

    The rest of the universe oscillates gently so the macro regime stays
    RANGE with low stress.
    """
    rng = np.random.default_rng(seed)
    levels = 20 + rng.random(n_symbols) * 100
    closes = np.zeros((n_ticks, n_symbols))
    # base: per-symbol sine oscillation ±0.25% + tiny noise; BTC flat-ish
    phase = rng.random(n_symbols) * 2 * np.pi
    for i in range(n_symbols):
        wave = 0.0025 * np.sin(2 * np.pi * np.arange(n_ticks) / 16.0 + phase[i])
        noise = rng.normal(0, 0.0006, n_ticks).cumsum() * 0.2
        closes[:, i] = levels[i] * (1 + wave + noise)
    last = n_ticks - 1

    # S002 BuyTheDip: drop over [last-22, last-16], flat base, green pop
    s = 2
    base = closes[last - 30, s]
    for k, t in enumerate(range(last - 22, last - 16)):
        closes[t, s] = base * (1 - 0.007 * (k + 1))
    shelf = base * (1 - 0.042)
    for t in range(last - 16, last):
        closes[t, s] = shelf * (1 + rng.normal(0, 0.0003))
    closes[last, s] = shelf * 1.011  # reclaim: > prev close and > EMA20

    # S003 BBX: two hard red bars to below the lower band
    s = 3
    lvl = closes[last - 2, s]
    closes[last - 1, s] = lvl * 0.975
    closes[last, s] = lvl * 0.950

    # S004 RBR: choppy bleed then hammer (bar shapes set below)
    s = 4
    lvl = closes[last - 20, s]
    px_s4 = lvl
    for k, t in enumerate(range(last - 19, last)):
        px_s4 *= (1 - 0.0035) if k % 2 == 0 else (1 + 0.0015)
        closes[t, s] = px_s4
    closes[last, s] = closes[last - 1, s] * 0.988  # green close, set shapes below

    c = closes
    o = np.concatenate([closes[:1], closes[:-1]])  # each bar opens at the last close
    h, low = np.maximum(o, c) * 1.001, np.minimum(o, c) * 0.999
    # one volume draw per (tick, symbol), in tick-major order
    vol15 = np.abs(rng.normal(1000, 150, (n_ticks, n_symbols)))
    # RBR bleed's up-bars carry tall high wicks: +DM then balances the
    # down-bars' −DM so the rolling-sum ADX stays under the 32 veto while
    # closes still bleed (RSI ≤ 35) — the shape the strategy hunts: choppy
    # range, not a trend
    up = np.arange(last - 18, last, 2)
    h[up, 4] = np.maximum(o[up, 4], c[up, 4]) * 1.0075
    # RBR hammer: gap down, deep low poke through −2σ, green close near
    # the candle high
    o[last, 4] = closes[last - 1, 4] * 0.986
    low[last, 4] = o[last, 4] * 0.9875
    h[last, 4] = c[last, 4] * 1.0008
    # BTD reclaim bar: clean green, modest wicks
    h[last, 2], low[last, 2] = c[last, 2] * 1.0005, o[last, 2] * 0.9995
    return _with_sub_bars(o, h, low, c, vol15, wick=0.0005)


def generate_dormant_replay(
    path: str | Path,
    n_symbols: int = 24,
    n_ticks: int = 130,
    seed: int = 23,
) -> None:
    """Write :func:`dormant_market_bars` as a kline file (15m bars with
    their 5m sub-bars), the reference's dormant market byte for byte."""
    _write_bars(path, dormant_market_bars(n_symbols, n_ticks, seed), 1_780_272_000)


def dormant_extended_market_bars(
    n_symbols: int = 24, n_ticks: int = 130, seed: int = 31
) -> dict:
    """The bars of :func:`generate_dormant_extended_replay` as arrays: a
    market for the other dormant strategies (twap sniper, supertrend swing
    reversal, buy-low-sell-high, inverse price tracker, RS reversal range):

    * most symbols drift mildly up (advancers-heavy TRANSITIONAL/TREND_UP
      market for IPT's routing; BTC drifts with them);
    * S005 — a strong 15m rally with wide bars (supertrend pinned up,
      micro TREND_UP), then six final ticks of tiny red 5m sub-bars: the
      5m RSI/MFI pin low with MACD negative while the supertrend band
      holds — SupertrendSwingReversal and InversePriceTracker arm at tick
      last-1 (with rising scripted breadth + LOSERS dominance for STS);
    * S006 — an early +15% rally then a slow −0.15%/bar bleed: RSI(14)
      pins ~0 while price stays above MA25 (BuyLowSellHigh with scripted
      domination reversal) and under its 80-bar TWAP (TwapMomentumSniper);
    * final tick — BTC and S008..S017 drop ~5% while S007 pumps +3.5%: on
      the 24-symbol default, half the universe in a broad RANGE selloff
      with an RS leader (RelativeStrengthReversalRange).
    """
    rng = np.random.default_rng(seed)
    levels = 20 + rng.random(n_symbols) * 100
    closes = np.zeros((n_ticks, n_symbols))
    for i in range(n_symbols):
        drift = 0.0012 * np.arange(n_ticks)  # mild up-drift (advancers-heavy)
        noise = rng.normal(0, 0.0008, n_ticks).cumsum() * 0.3
        closes[:, i] = levels[i] * (1 + drift + noise)
    last = n_ticks - 1

    # S005: strong rally, then a fade of tiny red 5m sub-bars over the
    # final six ticks
    s = 5
    closes[:, s] = levels[s] * (1 + 0.003 * np.arange(n_ticks))
    fade_start = last - 5
    peak = closes[fade_start - 1, s]
    for k, t in enumerate(range(fade_start, last + 1)):
        closes[t, s] = peak * (1 - 0.0012 * (k + 1))

    # S006: flat base → STEEP 14-bar rally (+2%/bar) ending 18 bars before
    # the end → 17-bar slow bleed. The 25-bar MA window then spans the
    # rally's low prices, so the bleed's close stays ABOVE ma25 while the
    # all-red last 14 bars pin RSI(14) at 0 — the BLSH transient.
    s = 6
    rally_end = last - 17
    rally_len = 14
    base = levels[s]
    # gently rising base — a perfectly flat price makes twap == price, an
    # f32-vs-f64 knife edge a comparison can land on either side of
    closes[: rally_end - rally_len, s] = base * (
        1 + 0.0004 * np.arange(rally_end - rally_len)
    )
    base = closes[rally_end - rally_len - 1, s]
    for k, t in enumerate(range(rally_end - rally_len, rally_end)):
        closes[t, s] = base * (1.02 ** (k + 1))
    top = closes[rally_end - 1, s]
    for k, t in enumerate(range(rally_end, last + 1)):
        closes[t, s] = top * (1 - 0.0015 * (k + 1))

    # final-tick broad selloff with an RS leader
    droppers = [0] + list(range(8, 18))  # BTC + ten others
    for i in droppers:
        closes[last, i] = closes[last - 1, i] * 0.948
    closes[last, 7] = closes[last - 1, 7] * 1.035  # S007: the leader

    c = closes
    o = np.concatenate([closes[:1], closes[:-1]])
    vol15 = np.abs(rng.normal(1000, 150, (n_ticks, n_symbols)))
    h, low = np.maximum(o, c) * 1.001, np.minimum(o, c) * 0.999
    # wide rally bars keep the supertrend band ~1.5% below
    h[:fade_start, 5] = np.maximum(o[:fade_start, 5], c[:fade_start, 5]) * 1.005
    low[:fade_start, 5] = np.minimum(o[:fade_start, 5], c[:fade_start, 5]) * 0.995
    # the fade's sub-bars are strictly monotone red by construction
    return _with_sub_bars(o, h, low, c, vol15, wick=0.0005)


def generate_dormant_extended_replay(
    path: str | Path,
    n_symbols: int = 24,
    n_ticks: int = 130,
    seed: int = 31,
) -> None:
    """Write :func:`dormant_extended_market_bars` as a kline file, the
    reference's extended dormant market byte for byte."""
    _write_bars(path, dormant_extended_market_bars(n_symbols, n_ticks, seed), 1_780_272_000)


def generate_outcome_replay(
    path: str | Path,
    n_symbols: int = 8,
    n_ticks: int = 128,
    fire_ticks: tuple[int, int] = (104, 110),
    seed: int = 11,
) -> None:
    """MID-stream MeanReversionFade hammers with scripted aftermaths, the
    signal-outcome tracker's fixture. Unlike the other generators
    (whose crafted setups land on the LAST tick, leaving nothing to
    mature), this stream fires early enough that every 5m-bar horizon up
    to ``3 * (n_ticks - fire_ticks[1] - 1)`` completes before EOF, with
    deliberately opposite aftermaths:

    * S005 — steady bleed, green hammer at ``fire_ticks[0]``, then a
      +0.35%/tick RECOVERY: positive forward returns, small MAE;
    * S006 — the same recipe at ``fire_ticks[1]``, then the bleed simply
      CONTINUES at −0.4%/tick: negative forward returns, deep MAE, tiny
      MFE.

    The rest of the universe random-walks gently (BTC row 0 flat-ish).
    """
    rng = np.random.default_rng(seed)
    t0 = 1_780_272_000
    assert t0 % 900 == 0
    assert n_symbols >= 7 and n_ticks > max(fire_ticks) + 2
    px = 20 + rng.random(n_symbols) * 100

    with open(path, "w") as f:
        for tick in range(n_ticks):
            ts15 = t0 + tick * 900
            rets = rng.normal(0, 0.003, n_symbols)
            for s, fire in zip((5, 6), fire_ticks):
                if tick < fire:
                    rets[s] = -0.006  # bleed: RSI pins low pre-hammer
                elif tick > fire:
                    rets[s] = 0.0035 if s == 5 else -0.004
            new_px = px * (1 + rets)
            for i in range(n_symbols):
                symbol = "BTCUSDT" if i == 0 else f"S{i:03d}USDT"
                o, c = px[i], new_px[i]
                vol15 = abs(rng.normal(1000, 200))
                h, low = max(o, c) * 1.002, min(o, c) * 0.998
                if i in (5, 6) and tick == fire_ticks[0 if i == 5 else 1]:
                    # the green-hammer recipe (generate_replay_file): deep
                    # gap below the 20-bar lower band, green close, 3x vol
                    o = px[i] * 0.955
                    c = o * 1.003
                    h, low = c * 1.001, o * 0.997
                    new_px[i] = c
                    vol15 *= 3.0
                f.write(_kline_json(symbol, ts15, 900, o, h, low, c, vol15))
                sub_o = o
                for j in range(3):
                    sub_c = o + (c - o) * (j + 1) / 3
                    sh = max(sub_o, sub_c) * 1.001
                    sl = min(sub_o, sub_c) * 0.999
                    f.write(
                        _kline_json(
                            symbol, ts15 + j * 300, 300,
                            sub_o, sh, sl, sub_c, vol15 / 3,
                        )
                    )
                    sub_o = sub_c
            px = new_px
