"""Signal emission: fired wire slots → SignalsConsumer payloads + sinks.

Port of ``binquant_tpu/io/emission.py``: for only the fired (strategy,
symbol) pairs, the host builds the ``SignalsConsumer`` payload (with the
strategy's bot params, or a grid ladder's deployment request sized by the
autotrade settings), the structured Telegram message (the reference's
uniform key/value line shape) and the analytics record, all from the ONE
fetched wire — its per-slot payload carries every value needed. When the
compaction overflowed, the full step's summary is read instead.

The three sinks, as the delivery plane (``io/delivery.py``) sees them:
:class:`SignalSink` subclasses whose ``deliver`` raises on failure
(analytics and Telegram lossy, autotrade at-least-once through the WAL,
with ``to_wal``/``from_wal``/``stamp``). :func:`make_signal_sinks` builds
them in the inline path's dispatch order; :func:`dispatch_signal_record`
is the inline path's analytics POST, which swallows and logs a failure.
"""

from __future__ import annotations

import asyncio
import logging
from datetime import UTC, datetime
from typing import Any

import numpy as np

from binquant_tpu_torch.engine.step import (
    EMISSION_BASE_FIELDS,
    EMISSION_DIAG_WIDTH,
    FIVE_MIN_STRATEGIES,
    LIVE_STRATEGIES,
    STRATEGY_ORDER,
    TickOutputs,
    unpack_wire,
)
from binquant_tpu_torch.enums import (
    Direction,
    MarketRegimeCode,
    MarketTransitionCode,
    MarketType,
    MicroRegimeCode,
    MicroTransitionCode,
    Position,
    SignalKind,
)
from binquant_tpu_torch.obs.instruments import SINK_EMISSIONS
from binquant_tpu_torch.schemas import (
    BotBase,
    GridDeploymentRequest,
    HABollinguerSpread,
    SignalsConsumer,
)
from binquant_tpu_torch.utils import (
    build_links_msg,
    format_context_timestamp_line,
    round_numbers,
)

__all__ = [
    "FIVE_MIN_STRATEGIES",
    "LIVE_STRATEGIES",
    "AnalyticsSink",
    "AutotradeSink",
    "FiredSignal",
    "SignalSink",
    "TelegramSink",
    "dispatch_signal_record",
    "extract_fired",
    "make_signal_sinks",
]

# strategies that trade FUTURES in their bot params
_FUTURES_BOT_STRATEGIES = {"activity_burst_pump", "mean_reversion_fade"}
_NO_REVERSAL = {"coinrule_price_tracker", "mean_reversion_fade"}
# BuyTheDip's bot reverses into a margin short
_WITH_REVERSAL = {"coinrule_buy_the_dip"}


def _name(enum_cls, code: int, fallback: str | None = "UNAVAILABLE") -> str | None:
    try:
        if code < 0:
            return fallback
        return enum_cls(code).name
    except ValueError:
        return fallback


class FiredSignal:
    """One fired (strategy, symbol) pair with host-materialized payloads."""

    def __init__(
        self,
        strategy: str,
        symbol: str,
        row: int,
        value: SignalsConsumer,
        message: str,
        analytics: dict[str, Any],
    ) -> None:
        self.strategy = strategy
        self.symbol = symbol
        self.row = row
        self.value = value
        self.message = message
        self.analytics = analytics
        # the evaluated tick's wall-clock ms, stamped at finalize
        self.tick_ms: int | None = None
        # the tick's trace provenance, stamped at finalize when the tick was
        # traced (None otherwise: the delivery plane's entry id then takes
        # its untraced form)
        self.trace_id: str | None = None
        self.tick_seq: int | None = None
        # candle close → emit ms, stamped at finalize while the freshness
        # observatory is on
        self.freshness_ms: float | None = None
        # the fan-out broadcast handoff (frame dict, packed recipient
        # words, publish perf_counter), stamped by FanoutPlane.on_fired at
        # finalize: what the delivery plane's fanout consumer group
        # delivers
        self.fanout_frame: tuple | None = None


def _cast_diag(kind: str, v: float):
    if kind == "b":
        return np.bool_(v > 0.5)
    if kind == "i":
        return np.int32(round(v))
    return np.float32(v)


def extract_fired(
    outputs: TickOutputs | None,
    registry,
    env: str = "",
    exchange: str = "kucoin",
    market_type: str = "futures",
    settings=None,
    enabled: frozenset[str] | set[str] | None = None,
    skip=None,
    unpacked=None,
    diag_layout: dict[str, list[tuple[str, str]]] | None = None,
) -> list[FiredSignal]:
    """Materialize FiredSignal objects for the wire's fired slots (or, on a
    compaction overflow, for every set bit of ``outputs.summary``).
    ``settings`` (the autotrade settings, or None) size a grid ladder's
    deployment request; ``skip(strategy, row)`` drops rows before any
    payload is built."""
    if enabled is None:
        enabled = LIVE_STRATEGIES
    fired_w, ctx_s = unpacked if unpacked is not None else unpack_wire(
        outputs.wire.cpu().numpy()
    )
    entries: list[tuple] = []
    if fired_w.overflow:
        trig = outputs.summary.trigger.cpu().numpy()
        auto = outputs.summary.autotrade.cpu().numpy()
        dirn = outputs.summary.direction.cpu().numpy()
        scor = outputs.summary.score.cpu().numpy()
        stop = outputs.summary.stop_loss_pct.cpu().numpy()
        for si, row in zip(*np.nonzero(trig)):
            entries.append(
                (int(si), int(row), bool(auto[si, row]), int(dirn[si, row]),
                 float(scor[si, row]), float(stop[si, row]), None)
            )
    else:
        has_payload = fired_w.payload is not None and diag_layout is not None
        for j in range(len(fired_w.strategy_idx)):
            entries.append(
                (
                    int(fired_w.strategy_idx[j]),
                    int(fired_w.row[j]),
                    bool(fired_w.autotrade[j]),
                    int(fired_w.direction[j]),
                    float(fired_w.score[j]),
                    float(fired_w.stop_loss_pct[j]),
                    fired_w.payload[j] if has_payload else None,
                )
            )

    by_strategy: dict[int, list[tuple]] = {}
    for si, row, autotrade, direction_code, score, stop_loss, slot in entries:
        strategy = STRATEGY_ORDER[si]
        if strategy not in enabled:
            continue
        if skip is not None and skip(strategy, row):
            continue
        by_strategy.setdefault(si, []).append(
            (row, autotrade, direction_code, score, stop_loss, slot)
        )
    if not by_strategy:
        return []

    ctx_np = {
        "market_regime": ctx_s["market_regime"],
        "transition": ctx_s["market_regime_transition"],
        "transition_strength": ctx_s["market_regime_transition_strength"],
        "stress": ctx_s["market_stress_score"],
        "timestamp_ms": ctx_s["timestamp"] * 1000,
        "valid": ctx_s["valid"],
    }
    n_base = len(EMISSION_BASE_FIELDS)
    fired: list[FiredSignal] = []
    for si in sorted(by_strategy):
        strategy = STRATEGY_ORDER[si]
        five_min = strategy in FIVE_MIN_STRATEGIES
        legacy = None
        if any(slot is None for *_, slot in by_strategy[si]):
            # overflow: read this strategy's tensors from the full outputs
            so = outputs.strategies[strategy]
            pack = outputs.pack5 if five_min else outputs.pack15
            feats = outputs.context.features
            legacy = (
                {k: v.cpu().numpy() for k, v in so.diagnostics.items()},
                pack.close.cpu().numpy(),
                pack.bb_upper.cpu().numpy(),
                pack.bb_mid.cpu().numpy(),
                pack.bb_lower.cpu().numpy(),
                pack.volume.cpu().numpy(),
                feats.micro_regime.cpu().numpy(),
                feats.micro_transition.cpu().numpy(),
                outputs.btc_beta.cpu().numpy(),
                outputs.btc_corr.cpu().numpy(),
            )

        for row, autotrade, direction_code, score, stop_loss, slot in by_strategy[si]:
            symbol = registry.name_of(row)
            if symbol is None:
                continue
            if slot is not None:
                slot_base = len(slot) - EMISSION_DIAG_WIDTH
                base = slot[:slot_base]
                off = 0 if five_min else 5
                current_price = float(base[0 + off])
                volume = float(base[1 + off])
                bb_high_v = float(base[2 + off])
                bb_mid_v = float(base[3 + off])
                bb_low_v = float(base[4 + off])
                micro = int(base[10])
                micro_trans = int(base[11])
                btc_rel = (
                    (float(base[12]), float(base[13])) if slot_base >= n_base else None
                )
                diag_vec = slot[slot_base:]
                diag_row = {
                    key: _cast_diag(kind, float(diag_vec[t]))
                    for t, (key, kind) in enumerate(diag_layout[strategy])
                }
            else:
                diags, closes, bb_h, bb_m, bb_l, volumes, mic, mtr, beta, corr = legacy
                current_price = float(closes[row])
                volume = float(volumes[row])
                bb_high_v, bb_mid_v, bb_low_v = (
                    float(bb_h[row]), float(bb_m[row]), float(bb_l[row])
                )
                micro = int(mic[row])
                micro_trans = int(mtr[row])
                btc_rel = (float(beta[row]), float(corr[row]))
                diag_row = {
                    k: (v[row] if v.ndim else v[()]) for k, v in diags.items()
                }

            direction = Direction(direction_code).name
            position = Position.short if direction == "SHORT" else Position.long
            spreads = HABollinguerSpread(
                bb_high=round_numbers(bb_high_v, 6),
                bb_mid=round_numbers(bb_mid_v, 6),
                bb_low=round_numbers(bb_low_v, 6),
            )
            if strategy == "grid_ladder":
                value = _grid_signal(
                    symbol, diag_row, current_price, exchange, market_type,
                    autotrade, ctx_np, settings,
                )
            else:
                bot_kwargs: dict[str, Any] = dict(
                    pair=symbol, name=strategy, position=position
                )
                if strategy in _FUTURES_BOT_STRATEGIES:
                    bot_kwargs["market_type"] = MarketType.FUTURES
                else:
                    bot_kwargs["market_type"] = MarketType(market_type)
                if strategy in _NO_REVERSAL:
                    bot_kwargs["margin_short_reversal"] = False
                if strategy in _WITH_REVERSAL:
                    bot_kwargs["margin_short_reversal"] = True
                if strategy == "mean_reversion_fade":
                    bot_kwargs["dynamic_trailing"] = True
                    bot_kwargs["stop_loss"] = stop_loss
                value = SignalsConsumer(
                    autotrade=autotrade,
                    current_price=current_price,
                    direction=direction,
                    score=score,
                    volume=volume,
                    signal_kind=SignalKind.standard,
                    algorithm_name=strategy,
                    symbol=symbol,
                    bot_params=BotBase(**bot_kwargs),
                    bb_spreads=spreads,
                )
            message = _build_message(
                strategy, symbol, value, diag_row, ctx_np, micro, micro_trans,
                env, exchange, market_type,
            )
            analytics = _analytics_record(
                strategy, symbol, value, diag_row, ctx_np, btc_rel=btc_rel
            )
            fired.append(FiredSignal(strategy, symbol, row, value, message, analytics))
    return fired


def _grid_signal(
    symbol, diag_row, current_price, exchange, market_type, autotrade, ctx_np,
    settings,
) -> SignalsConsumer:
    """GridDeploymentRequest payload: margin, level count, fiat and the
    allocation split from the autotrade ``settings`` (the reference's
    fallbacks without them); ``diag_row`` holds this row's diagnostics as
    scalars."""
    total_margin = getattr(settings, "grid_total_margin", 10.0) if settings else 10.0
    level_count = getattr(settings, "grid_level_count", 7) if settings else 7
    fiat = getattr(settings, "fiat", "USDT") if settings else "USDT"
    allocation = getattr(settings, "grid_allocation_pct", None) if settings else None
    reserve = getattr(settings, "grid_cash_reserve_pct", None) if settings else None
    grid_params = GridDeploymentRequest(
        symbol=symbol,
        fiat=fiat,
        exchange=exchange,
        market_type=MarketType(market_type),
        algorithm_name="grid_ladder",
        generated_at=datetime.now(UTC),
        range_low=float(diag_row["range_low"]),
        range_high=float(diag_row["range_high"]),
        breakout_low=float(diag_row["breakout_low"]),
        breakout_high=float(diag_row["breakout_high"]),
        total_margin=total_margin,
        level_count=level_count,
        current_price=current_price,
        current_regime=_name(MarketRegimeCode, ctx_np["market_regime"], None),
        allocation_pct=allocation,
        cash_reserve_pct=reserve,
        indicators={
            "range_width_pct": float(diag_row["range_width_pct"]),
            "atr_buffer_pct": float(diag_row["atr_buffer_pct"]),
        },
    )
    return SignalsConsumer(
        signal_kind=SignalKind.grid_deploy,
        direction="grid",
        current_price=current_price,
        autotrade=autotrade,
        algorithm_name="grid_ladder",
        symbol=symbol,
        grid_params=grid_params,
    )


def _build_message(
    strategy, symbol, value, diag_row, ctx_np, micro, micro_trans, env, exchange,
    market_type,
) -> str:
    """Structured Telegram message in the reference's key/value line shape."""
    exchange_link, terminal_link = build_links_msg(env, exchange, market_type, symbol)
    direction = value.direction if value.direction != "grid" else "GRID"
    action = f"{direction} ENTRY" if direction != "GRID" else "GRID DEPLOY"
    regime_name = (
        _name(MarketRegimeCode, ctx_np["market_regime"]) if ctx_np["valid"] else "UNAVAILABLE"
    )
    lines = [
        f"- [{env}] <strong>#{strategy} algorithm</strong> #{symbol}",
        f"- Action: {action}",
        f"- Current price: {round_numbers(value.current_price, 6)}",
        "- Strategy: "
        + ("short" if value.direction == "SHORT" else "long" if value.direction == "LONG" else "grid"),
        f"- Market regime: {regime_name}",
        f"- Market transition: {_name(MarketTransitionCode, ctx_np['transition'], 'None')}",
        format_context_timestamp_line(ctx_np["timestamp_ms"] if ctx_np["valid"] else None),
        f"- Coin regime: {_name(MicroRegimeCode, micro)}",
        f"- Coin transition: {_name(MicroTransitionCode, micro_trans, 'None')}",
        f"- Market stress: {round_numbers(ctx_np['stress'], 3)}",
    ]
    if value.score:
        lines.append(f"- Score: {round_numbers(value.score, 4)}")
    for key, val in diag_row.items():
        if key == "route" or getattr(val, "dtype", None) == np.bool_:
            continue
        lines.append(f"- {key}: {round_numbers(float(val), 6)}")
    lines.extend(
        [
            f"- {'Autotrade is enabled' if value.autotrade else 'Autotrade is disabled'}",
            f"- <a href='{exchange_link}'>Exchange</a>",
            f"- <a href='{terminal_link}'>Dashboard trade</a>",
        ]
    )
    return "\n".join(lines)


def _analytics_record(
    strategy, symbol, value, diag_row, ctx_np, btc_rel=None
) -> dict[str, Any]:
    """POST /signals analytics body."""
    merged: dict[str, Any] = {key: float(val) for key, val in diag_row.items()}
    if btc_rel is not None:
        beta_v, corr_v = float(btc_rel[0]), float(btc_rel[1])
        merged.setdefault("btc_beta", None if beta_v != beta_v else beta_v)
        merged.setdefault("btc_corr", None if corr_v != corr_v else corr_v)
    if value.bb_spreads is not None:
        merged.setdefault("bb_spreads", value.bb_spreads.model_dump(mode="json"))
    if value.current_price:
        merged.setdefault("current_price", value.current_price)
    if value.score:
        merged.setdefault("score", value.score)
    return {
        "algorithm_name": strategy,
        "symbol": symbol,
        "generated_at": datetime.now(UTC).isoformat(),
        "direction": value.direction,
        "autotrade": value.autotrade,
        "current_regime": _name(MarketRegimeCode, ctx_np["market_regime"], None)
        if ctx_np["valid"]
        else None,
        "signal_kind": str(value.signal_kind.value),
        "bot_params": value.bot_params.model_dump(mode="json") if value.bot_params else {},
        "grid_params": value.grid_params.model_dump(mode="json") if value.grid_params else {},
        "indicators": merged,
    }


def dispatch_signal_record(binbot_api, record: dict[str, Any]) -> None:
    """The inline path's analytics POST: a failure is counted and logged,
    never raised into the trade path. The delivery plane calls
    :meth:`AnalyticsSink.deliver` instead, which raises into its retries
    and breaker."""
    try:
        binbot_api.dispatch_create_signal(record)
        SINK_EMISSIONS.labels(sink="analytics", outcome="ok").inc()
    except Exception:
        SINK_EMISSIONS.labels(sink="analytics", outcome="error").inc()
        logging.exception(
            "dispatch_signal_record failed for %s; trade path continues.",
            record.get("symbol"),
        )


# -- the sinks as the delivery plane sees them -----------------------------------
#
# ``deliver`` RAISES on failure (the plane owns retries, backoff and the
# circuit breaker; the inline path's per-sink swallowing lives in the
# engine's finalize for the plane-off configuration). ``encode`` builds the
# sink-native payload once at enqueue (the FiredSignal itself never rides a
# queue); ``to_wal``/``from_wal`` round-trip it through the JSONL
# write-ahead log for the at-least-once class.


class SignalSink:
    """One delivery target behind the plane. Subclasses set ``name`` and
    ``policy`` ("at_least_once": WAL-durable, never dropped; "lossy":
    bounded retries, shed with a counter under pressure)."""

    name = "sink"
    policy = "lossy"

    def encode(self, signal: FiredSignal) -> Any:
        """FiredSignal → the sink-native payload enqueued on the plane."""
        raise NotImplementedError

    def to_wal(self, payload: Any) -> Any:
        """Payload → a JSON-serializable WAL record body."""
        return payload

    def stamp(self, payload: Any, entry_id: str) -> None:
        """Attach the plane's delivery identity to the payload itself so
        it travels to the consumer on every (re)delivery (at-least-once
        sinks only): the downstream dedupe key of a post-kill replay."""

    def from_wal(self, data: Any) -> Any:
        """WAL record body → the payload ``deliver`` accepts (restart
        replay)."""
        return data

    async def deliver(self, payload: Any) -> None:
        """One delivery attempt; MUST raise on failure."""
        raise NotImplementedError


class AnalyticsSink(SignalSink):
    """POST /signals analytics record (lossy: a shed record is a counted,
    bounded loss, and the trade path stays fresh)."""

    name = "analytics"
    policy = "lossy"

    def __init__(self, binbot_api) -> None:
        self.binbot_api = binbot_api

    def encode(self, signal: FiredSignal) -> dict[str, Any]:
        return signal.analytics

    async def deliver(self, payload: dict[str, Any]) -> None:
        try:
            # the binbot client is synchronous: its round trip runs in a
            # worker thread, so the event loop stays free
            await asyncio.to_thread(self.binbot_api.dispatch_create_signal, payload)
        except Exception:
            SINK_EMISSIONS.labels(sink="analytics", outcome="error").inc()
            raise
        SINK_EMISSIONS.labels(sink="analytics", outcome="ok").inc()


class TelegramSink(SignalSink):
    """Telegram alert (lossy: an alert that missed its moment is noise; the
    cooldown ledger's duplicate suppression still applies and counts as a
    successful no-op delivery)."""

    name = "telegram"
    policy = "lossy"

    def __init__(self, consumer) -> None:
        self.consumer = consumer

    def encode(self, signal: FiredSignal) -> str:
        return signal.message

    async def deliver(self, payload: str) -> None:
        await self.consumer.deliver_signal(payload)


class AutotradeSink(SignalSink):
    """Autotrade admission (at_least_once: a lost trade signal is lost
    money; unacked WAL entries replay on restart, and downstream dedupes on
    the ``delivery_id`` every redelivery carries)."""

    name = "autotrade"
    policy = "at_least_once"

    def __init__(self, at_consumer) -> None:
        self.at_consumer = at_consumer

    def encode(self, signal: FiredSignal) -> SignalsConsumer:
        return signal.value

    def to_wal(self, payload: SignalsConsumer) -> dict[str, Any]:
        return payload.model_dump(mode="json")

    def from_wal(self, data: Any) -> SignalsConsumer:
        return SignalsConsumer.model_validate(data)

    def stamp(self, payload: SignalsConsumer, entry_id: str) -> None:
        # the WAL round trip (model_dump/model_validate) keeps metadata, so
        # a post-kill replay redelivers the same id
        payload.metadata.setdefault("delivery_id", entry_id)

    async def deliver(self, payload: SignalsConsumer) -> None:
        # Admission is async in name only: every await bottoms out in
        # synchronous binbot REST, which would wedge the shared event loop,
        # and the plane's per-attempt deadline cannot preempt blocked code.
        # A worker thread with its own loop keeps the tick path responsive;
        # a deadline cancel abandons the thread's result and the
        # redelivery dedupes downstream. The coroutine is made in the
        # thread, so an attempt cancelled before the thread starts leaves
        # none unawaited.
        await asyncio.to_thread(
            lambda: asyncio.run(self.at_consumer.process_autotrade_restrictions(payload))
        )


def make_signal_sinks(binbot_api, telegram_consumer, at_consumer) -> list[SignalSink]:
    """The production sink set, in the inline path's dispatch order."""
    return [
        AnalyticsSink(binbot_api),
        TelegramSink(telegram_consumer),
        AutotradeSink(at_consumer),
    ]
