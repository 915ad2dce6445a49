"""Trade admission and bot lifecycle.

The port's own copy of ``binquant_tpu/io/autotrade.py``:

* **Pure math at module level** — ``bollinger_exit_params`` (BB-envelope
  derived stop/take/trailing), ``ContractTerms.lot_margin`` and
  ``size_futures_order`` (one-lot margin + round-trip fees, reversal
  reserve, auto-scale-down). No I/O.
* **Gate tables** — admission to the real-bot, paper-bot and grid paths
  is a declared sequence of named gate methods, each returning a refusal
  reason or None; ``_refusal`` runs the table in order, which is also the
  REST call order (the cap gates refresh the active pairs, the ladder
  gate refetches the ladders).
* **BotDraft** — an override-aware builder: fields the signal explicitly
  set (its ``model_fields_set``) are *pinned*, and derived defaults
  (cooldowns, BB exits) cannot move them.
* **BotEndpoints** — the paper/real REST verb bundle (create, activate,
  event log, rollback) resolved once, so the launch sequence with its
  compensating cleanup is written once.

Gate order, sizing arithmetic, REST sequences, the 1 h grid attempt
cooldown, the short-position margin preflight and the cleanup on an
activation failure are the reference's. Enum fields hold enum members
here (the reference's models store their values), so every comparison
and every key reads the value. ``Autotrade`` builds its exchange clients
with no session, as the reference does; the port's clients open their
``httpx`` client only at a first request (``io/exchanges.py``).
"""

from __future__ import annotations

import logging
from collections.abc import Callable
from dataclasses import dataclass
from datetime import UTC, datetime
from typing import Any

from binquant_tpu_torch.exceptions import AutotradeError, BinbotError
from binquant_tpu_torch.io.binbot import BinbotApi
from binquant_tpu_torch.io.exchanges import BinanceApi, KucoinApi, KucoinFutures
from binquant_tpu_torch.obs.events import get_event_log
from binquant_tpu_torch.obs.instruments import AUTOTRADE_REFUSALS, SINK_EMISSIONS
from binquant_tpu_torch.obs.tracing import current_trace_id
from binquant_tpu_torch.regime.grid_policy import GridOnlyPolicy
from binquant_tpu_torch.schemas import (
    AutotradeSettingsSchema,
    BotBase,
    BotModel,
    BotResponse,
    GridDeploymentRequest,
    Position,
    RecoveryParams,
    SignalsConsumer,
    SymbolModel,
    TestAutotradeSettingsSchema,
)
from binquant_tpu_torch.utils import round_numbers

log = logging.getLogger(__name__)


# ---------------------------------------------------------------------------
# Pure trade math
# ---------------------------------------------------------------------------

# Exit parameters derived from a Bollinger envelope narrower than 2% close
# positions immediately; wider than 20% risks too much. Outside the band the
# settings defaults stand. (Reference guard: shared/autotrade.py:139.)
BB_ENVELOPE_MIN_PCT = 2.0
BB_ENVELOPE_MAX_PCT = 20.0


def bollinger_exit_params(bb: Any, *, short: bool) -> dict[str, float]:
    """Stop/take/trailing percentages from the signal's BB envelope.

    The full-envelope width becomes the stop; the half toward profit
    becomes the take-profit; the opposite half the trailing deviation.
    Returns {} when bands are missing or the envelope is out of band.
    """
    if bb is None or not (bb.bb_high and bb.bb_mid and bb.bb_low):
        return {}
    envelope = abs(bb.bb_high - bb.bb_low) / bb.bb_high * 100
    if not (BB_ENVELOPE_MIN_PCT < envelope < BB_ENVELOPE_MAX_PCT):
        return {}
    upper_half = abs(bb.bb_high - bb.bb_mid) / bb.bb_high * 100
    lower_half = abs(bb.bb_mid - bb.bb_low) / bb.bb_mid * 100
    toward_profit, against = (
        (lower_half, upper_half) if short else (upper_half, lower_half)
    )
    return {
        "stop_loss": round_numbers(envelope),
        "take_profit": round_numbers(toward_profit),
        "trailing_deviation": round_numbers(against),
    }


@dataclass(frozen=True)
class ContractTerms:
    """KuCoin futures contract economics for one symbol."""

    lot_size: float
    multiplier: float
    taker_fee_rate: float
    leverage: float  # the LeverageCalibrator-written futures_leverage

    def lot_margin(self, price: float) -> float:
        """Initial margin plus round-trip taker fees for one minimum lot."""
        if self.lot_size <= 0 or price <= 0:
            return 0.0
        notional = self.lot_size * price * self.multiplier
        return round_numbers(
            notional / self.leverage + 2 * notional * self.taker_fee_rate, 8
        )


@dataclass(frozen=True)
class Sizing:
    """Outcome of futures order sizing: a margin to commit, or a veto."""

    order_size: float | None
    reason: str


def size_futures_order(
    terms_of: Callable[[], ContractTerms],
    *,
    price: float,
    stop_loss: float,
    requested: float,
    balance: float,
    reversal_buffer: float,
) -> Sizing:
    """Resolve the margin committed to a futures trade.

    The committed cash must cover at least one lot, and the balance must
    additionally hold back one lot + ``reversal_buffer`` so a reversal
    trade can always open. Within those bounds the request is granted,
    scaled down to what the balance allows. ``terms_of`` is a thunk so the
    two REST lookups only happen once the cheap vetoes pass (the reference
    orders its calls the same way, autotrade_consumer.py:105-118).
    """
    if price <= 0:
        # Without a price there is nothing to size against; let the trade
        # proceed at the requested margin rather than veto it.
        return Sizing(requested, "unpriced_signal")
    if stop_loss <= 0:
        return Sizing(None, "stop_loss_unset")

    terms = terms_of()
    lot = terms.lot_margin(price)
    if lot <= 0:
        return Sizing(None, "degenerate_contract")

    spendable = balance - (lot + reversal_buffer)
    if spendable < lot:
        return Sizing(None, "reversal_reserve_exceeds_balance")
    if requested < lot:
        return Sizing(None, "request_below_one_lot")

    granted = min(requested, spendable)
    reason = "scaled_to_balance" if granted < requested else "granted"
    return Sizing(round_numbers(granted, 8), reason)


# ---------------------------------------------------------------------------
# Bot assembly
# ---------------------------------------------------------------------------


def _value(x: Any) -> Any:
    """An enum member's value (the reference's models store values)."""
    return getattr(x, "value", x)


def _is_short(bot: BotBase) -> bool:
    return bot.position in (Position.short, Position.short.value)


def _on_futures(bot: BotBase) -> bool:
    return str(_value(bot.market_type)).lower() == "futures"


class BotDraft:
    """A ``BotBase`` under assembly with pin-aware defaulting.

    Fields the signal explicitly carried are *pinned*: derived values
    (cooldowns, BB-envelope exits) may only fill fields the signal left
    alone. An explicit null is meaningful solely for ``recovery_params``,
    where it pins recovery OFF. (Reference bookkeeping:
    shared/autotrade.py:95-117.)
    """

    def __init__(self, bot: BotBase) -> None:
        self.bot = bot
        self._pinned: set[str] = set()

    def absorb_signal(self, params: BotBase | None) -> None:
        if params is None:
            return
        for name in params.model_fields_set:
            value = getattr(params, name)
            if value is None:
                if name == "recovery_params":
                    self._pinned.add(name)
                    self.bot.recovery_params = None
                continue
            self._pinned.add(name)
            setattr(self.bot, name, value)

    def pinned(self, name: str) -> bool:
        return name in self._pinned

    def suggest(self, name: str, value: Any) -> None:
        if name not in self._pinned:
            setattr(self.bot, name, value)

    def suggest_all(self, values: dict[str, Any]) -> None:
        for name, value in values.items():
            self.suggest(name, value)


@dataclass(frozen=True)
class BotEndpoints:
    """The REST verb bundle for one bot collection (paper vs real)."""

    create: Callable[[dict], Any]
    activate: Callable[[str], Any]
    log_event: Callable[[str, str], Any]
    discard: Callable[[str], None]


class Autotrade:
    """One bot launch: assemble → preflight → create → activate, with
    compensating rollback on activation failure
    (shared/autotrade.py:220-331)."""

    def __init__(
        self,
        pair: str,
        settings: AutotradeSettingsSchema | TestAutotradeSettingsSchema,
        algorithm_name: str,
        binbot_api: BinbotApi,
        db_collection_name: str = "paper_trading",
        exchange_api: Any | None = None,
        futures_api: KucoinFutures | None = None,
    ) -> None:
        self.pair = pair
        self.binbot_api = binbot_api
        self.exchange = settings.exchange_id
        self.api = exchange_api or (
            KucoinApi() if self.exchange == "kucoin" else BinanceApi()
        )
        self.futures_api = futures_api or KucoinFutures()
        self.symbol_data: SymbolModel = binbot_api.get_single_symbol(pair)
        self.algorithm_name = algorithm_name
        self.db_collection_name = db_collection_name
        # Explicit keyword-by-keyword seeding from settings: BotBase
        # ignores unknown fields (pydantic extra='ignore'), so a spread
        # from a name table would turn a typo into a silently-defaulted
        # bot parameter. The field pairing mirrors shared/autotrade.py:73-89.
        self.default_bot = BotBase(
            pair=pair,
            mode="autotrade",
            name=algorithm_name,
            quote_asset=self.symbol_data.quote_asset,
            position=Position.long,
            dynamic_trailing=True,
            fiat=settings.fiat,
            fiat_order_size=settings.base_order_size,
            stop_loss=settings.stop_loss,
            take_profit=settings.take_profit,
            trailing=settings.trailing,
            trailing_deviation=settings.trailing_deviation,
            trailing_profit=settings.trailing_profit,
            margin_short_reversal=settings.autoswitch,
        )

    # -- assembly phases ----------------------------------------------------

    def _default_recovery(self, draft: BotDraft) -> None:
        # Real KuCoin futures bots get recovery params derived from the
        # reversal flag unless the signal pinned them either way.
        if (
            self.db_collection_name == "bots"
            and self.exchange == "kucoin"
            and _on_futures(draft.bot)
            and not draft.pinned("recovery_params")
        ):
            draft.bot.recovery_params = (
                RecoveryParams() if draft.bot.margin_short_reversal else None
            )

    def _tune_draft(
        self, draft: BotDraft, data: SignalsConsumer, *, short: bool, real: bool
    ) -> None:
        if short:
            # Binance walks isolated pairs through a 24 h deactivation
            # after a short closes; bake that into the cooldown.
            draft.suggest("cooldown", 1440)
        elif real:
            draft.suggest("cooldown", 360)  # stop bots cannibalizing profit
            if (
                self.exchange == "binance"
                and not self.symbol_data.is_margin_trading_allowed
            ):
                draft.bot.margin_short_reversal = False
        draft.suggest_all(bollinger_exit_params(data.bb_spreads, short=short))

    # -- short preflight ----------------------------------------------------

    def _entry_price(self, bot: BotBase) -> float:
        if self.exchange == "kucoin" and _on_futures(bot):
            return self.futures_api.get_mark_price(bot.pair)
        return self.api.get_ticker_price(bot.pair)

    def _short_loss_coverable(self, bot: BotBase) -> bool:
        """A real short must be able to fund the worst-case buy-back."""
        entry = self._entry_price(bot)
        quantity = float(bot.fiat_order_size) / entry
        buyback = entry * (1 + bot.stop_loss / 100) * quantity
        held = self.binbot_api.get_available_fiat(
            exchange=self.exchange, fiat=bot.fiat
        )
        if held < buyback:
            log.error(
                "Not enough funds to autotrade short bot. "
                "balance: %s, transfer qty: %s",
                held,
                buyback,
            )
            return False
        return True

    # -- launch -------------------------------------------------------------

    def _endpoints(self, real: bool) -> BotEndpoints:
        api = self.binbot_api
        if not real:
            return BotEndpoints(
                create=api.create_paper_bot,
                activate=api.activate_paper_bot,
                log_event=api.submit_paper_trading_event_logs,
                discard=api.delete_paper_bot,
            )

        def deactivate(bot_id: str) -> None:
            try:
                api.deactivate_bot(bot_id, algorithmic_close=True)
            except Exception:
                log.exception(
                    "Failed to deactivate bot %s after activation error", bot_id
                )

        return BotEndpoints(
            create=api.create_bot,
            activate=api.activate_bot,
            log_event=api.submit_bot_event_logs,
            discard=deactivate,
        )

    @staticmethod
    def _unwrap(response: BotResponse) -> BotModel:
        if not isinstance(response.data, BotModel):
            raise AutotradeError(response.message)
        return response.data

    async def _launch(self, bot: BotBase, *, short: bool, real: bool) -> None:
        ep = self._endpoints(real)
        created = BotResponse.model_validate(ep.create(bot.model_dump(mode="json")))
        if created.error == 1:
            raise AutotradeError(created.message)
        bot_id = str(self._unwrap(created).id)

        try:
            outcome = BotResponse.model_validate(ep.activate(bot_id))
        except BinbotError as refused:
            # The client raises on error payloads; the rollback below must
            # see the refusal as a response, not an exception.
            outcome = BotResponse(message=str(refused), error=1, data=None)

        if outcome.error > 0:
            ep.log_event(bot_id, outcome.message)
            if short:
                self.binbot_api.clean_margin_short(bot.pair)
            ep.discard(bot_id)
            raise AutotradeError(outcome.message)

        verb = "submitted" if _value(self._unwrap(outcome).status) == "pending" else "opened"
        ep.log_event(
            bot_id,
            f"Succesful {self.db_collection_name} autotrade, "
            f"{verb} with {self.pair}!",
        )

    async def activate_autotrade(self, data: SignalsConsumer) -> None:
        if self.pair in self.binbot_api.filter_excluded_symbols():
            log.info(
                "Autotrade already active or excluded for %s, skipping", self.pair
            )
            return

        draft = BotDraft(self.default_bot)
        draft.absorb_signal(data.bot_params)
        self._default_recovery(draft)

        short = _is_short(draft.bot)
        real = self.db_collection_name == "bots"
        if real and short and not self._short_loss_coverable(draft.bot):
            return
        self._tune_draft(draft, data, short=short, real=real)
        await self._launch(draft.bot, short=short, real=real)


# ---------------------------------------------------------------------------
# Grid attempt cooldown
# ---------------------------------------------------------------------------


class _AttemptLedger:
    """Grid-create attempts per (exchange, market_type, symbol, algorithm).

    A create that was *attempted* — succeeded, raced, or errored — is not
    retried inside the window; a create that never happened (calculation
    veto) does not consume the window. Timestamps come from the signal's
    ``generated_at`` so replays behave deterministically.
    """

    def __init__(self, window_seconds: float) -> None:
        self.window_seconds = window_seconds
        self.attempts: dict[tuple[str, str, str, str], float] = {}

    @staticmethod
    def _key(params: GridDeploymentRequest) -> tuple[str, str, str, str]:
        return (
            str(params.exchange),
            str(_value(params.market_type)),
            params.symbol,
            params.algorithm_name,
        )

    @staticmethod
    def _when(params: GridDeploymentRequest) -> float:
        stamp = params.generated_at
        if not isinstance(stamp, datetime):
            return datetime.now(UTC).timestamp()
        if stamp.tzinfo is None:
            stamp = stamp.replace(tzinfo=UTC)
        return stamp.timestamp()

    def on_cooldown(self, params: GridDeploymentRequest) -> bool:
        previous = self.attempts.get(self._key(params))
        if previous is None:
            return False
        return 0 <= self._when(params) - previous < self.window_seconds

    def note(self, params: GridDeploymentRequest) -> None:
        self.attempts[self._key(params)] = self._when(params)


# ---------------------------------------------------------------------------
# The consumer: resolved intent + gate tables
# ---------------------------------------------------------------------------


@dataclass
class TradeIntent:
    """A signal's trade request resolved against settings defaults."""

    signal: SignalsConsumer
    params: BotBase
    symbol: str
    algorithm: str
    fiat: str
    order_size: float
    stop_loss: float
    market_type: str
    balance: float = 0.0


class AutotradeConsumer:
    """Pre-trade policy: every signal passes the gate tables below before
    any bot or grid ladder is created
    (consumers/autotrade_consumer.py:344-457)."""

    FUTURES_REVERSAL_BUFFER = 1.40
    GRID_DEPLOYMENT_ATTEMPT_COOLDOWN_SECONDS = 60 * 60

    # Admission tables: (gate name, method). Order is load-bearing — the
    # cap gates refresh the active-pair caches the duplicate gates read.
    _REAL_BOT_GATES = (
        ("bot_cap", "_gate_bot_cap"),
        ("ladder_owns_symbol", "_gate_ladder_ownership"),
        ("duplicate_bot", "_gate_duplicate_bot"),
    )
    _PAPER_GATES = (
        ("paper_cap", "_gate_paper_cap"),
        ("duplicate_paper_bot", "_gate_duplicate_paper_bot"),
    )

    def __init__(
        self,
        autotrade_settings: AutotradeSettingsSchema,
        active_test_bots: list[str],
        all_symbols: list[SymbolModel],
        test_autotrade_settings: TestAutotradeSettingsSchema,
        active_grid_ladders: list[dict],
        binbot_api: BinbotApi,
        kucoin_futures_api: KucoinFutures | None = None,
    ) -> None:
        # gainers-vs-losers dominance; stays False in this snapshot, as in
        # the reference (context_evaluator.py:95-97 initializes NEUTRAL and
        # nothing flips it) — scriptable by the replay/A-B harness
        self.market_domination_reversal = False
        self.current_market_dominance_is_losers = False
        self.active_bots: list[str] = []
        self.active_test_bots = active_test_bots
        self.active_grid_ladders = active_grid_ladders
        self.grid_only_policy = GridOnlyPolicy.disabled("not_evaluated")
        self.autotrade_settings = autotrade_settings
        self.test_autotrade_settings = test_autotrade_settings
        self.all_symbols = all_symbols
        self.exchange = autotrade_settings.exchange_id
        self.binbot_api = binbot_api
        self.kucoin_futures_api = kucoin_futures_api or KucoinFutures()
        self._grid_attempts = _AttemptLedger(
            self.GRID_DEPLOYMENT_ATTEMPT_COOLDOWN_SECONDS
        )
        # compat alias: the raw attempt map, visible as before
        self.grid_ladder_attempts = self._grid_attempts.attempts

    # -- small shared helpers ----------------------------------------------

    @staticmethod
    def _signal_or_default(params: BotBase, name: str, default: Any) -> Any:
        """Signal-provided means explicitly set AND non-null."""
        if name in params.model_fields_set:
            value = getattr(params, name)
            if value is not None:
                return value
        return default

    @staticmethod
    def _field(record: Any, name: str) -> Any:
        if isinstance(record, dict):
            return record.get(name)
        return getattr(record, name, None)

    def _refresh_active(self, collection: str) -> list[str]:
        return self.binbot_api.get_active_pairs(collection_name=collection)

    def is_margin_available(self, symbol: str) -> bool:
        return next(
            (s.is_margin_trading_allowed for s in self.all_symbols if s.id == symbol),
            False,
        )

    def _intend(self, result: SignalsConsumer) -> TradeIntent:
        params = result.bot_params
        pick = self._signal_or_default
        return TradeIntent(
            signal=result,
            params=params,
            symbol=params.pair,
            algorithm=params.name,
            fiat=pick(params, "fiat", self.autotrade_settings.fiat),
            order_size=float(
                pick(params, "fiat_order_size", self.autotrade_settings.base_order_size)
            ),
            stop_loss=float(
                pick(params, "stop_loss", self.autotrade_settings.stop_loss)
            ),
            # normalize to the plain wire value: validated models store
            # "FUTURES", but a raw enum would stringify as
            # "MarketType.FUTURES" and silently miss every gate compare
            market_type=str(_value(params.market_type) or "FUTURES"),
        )

    # -- gate bodies --------------------------------------------------------

    def _refusal(self, gates, intent: TradeIntent) -> str | None:
        for name, method in gates:
            why = getattr(self, method)(intent)
            if why is not None:
                AUTOTRADE_REFUSALS.labels(gate=name).inc()
                SINK_EMISSIONS.labels(sink="autotrade", outcome="refused").inc()
                log.info(
                    "autotrade gate %s refused %s: %s", name, intent.symbol, why
                )
                return name
        return None

    def _gate_bot_cap(self, intent: TradeIntent) -> str | None:
        self.active_bots = self._refresh_active("bots")
        cap = self.autotrade_settings.max_active_autotrade_bots
        if len(self.active_bots) > cap:
            return f"{len(self.active_bots)} active bots exceed cap {cap}"
        return None

    def _gate_ladder_ownership(self, intent: TradeIntent) -> str | None:
        self.active_grid_ladders = self.binbot_api.get_active_grid_ladders()
        for ladder in self.active_grid_ladders:
            if self._field(ladder, "symbol") != intent.symbol:
                continue
            ladder_mt = self._field(ladder, "market_type")
            # a ladder with no market type blocks conservatively;
            # case-insensitive: backend records carry either case
            if (
                ladder_mt is None
                or str(ladder_mt).lower() == str(intent.market_type).lower()
            ):
                return "an active grid ladder owns the symbol"
        return None

    def _gate_duplicate_bot(self, intent: TradeIntent) -> str | None:
        if intent.symbol in self.active_bots:
            return "an active bot already exists"
        return None

    def _gate_paper_cap(self, intent: TradeIntent) -> str | None:
        self.active_test_bots = self._refresh_active("paper_trading")
        cap = self.test_autotrade_settings.max_active_autotrade_bots
        if len(self.active_test_bots) > cap:
            return f"{len(self.active_test_bots)} paper bots exceed cap {cap}"
        return None

    def _gate_duplicate_paper_bot(self, intent: TradeIntent) -> str | None:
        if intent.symbol in self.active_test_bots:
            return "a paper bot already exists"
        return None

    # -- funding ------------------------------------------------------------

    def _contract_terms(self, symbol: str) -> ContractTerms:
        symbol_row = self.binbot_api.get_single_symbol(symbol)
        contract = self.kucoin_futures_api.get_symbol_info(symbol)
        return ContractTerms(
            lot_size=float(contract.lot_size),
            multiplier=float(contract.multiplier),
            taker_fee_rate=float(contract.taker_fee_rate),
            leverage=float(symbol_row.futures_leverage) or 1.0,
        )

    def _fund(self, intent: TradeIntent) -> bool:
        """Fetch the balance once; apply the spot gate or futures sizing."""
        intent.balance = float(
            self.binbot_api.get_available_fiat(exchange=self.exchange, fiat=intent.fiat)
        )
        if str(intent.market_type).lower() != "futures":
            if intent.balance < intent.order_size:
                log.info("Not enough funds to autotrade [bots].")
                return False
            return True
        if self.exchange != "kucoin":
            return True

        sizing = size_futures_order(
            lambda: self._contract_terms(intent.symbol),
            price=float(intent.signal.current_price),
            stop_loss=intent.stop_loss,
            requested=intent.order_size,
            balance=intent.balance,
            reversal_buffer=self.FUTURES_REVERSAL_BUFFER,
        )
        if sizing.order_size is None:
            log.info(
                "futures sizing vetoed %s: %s (requested %s, balance %s)",
                intent.symbol,
                sizing.reason,
                intent.order_size,
                intent.balance,
            )
            return False
        if sizing.reason == "scaled_to_balance":
            log.info(
                "futures order for %s scaled %s -> %s to fit balance %s",
                intent.symbol,
                intent.order_size,
                sizing.order_size,
                intent.balance,
            )
        # Propagate the approved margin so downstream sizing matches the gate.
        intent.params.fiat_order_size = sizing.order_size
        return True

    # -- launches -----------------------------------------------------------

    async def _launch_bot(
        self,
        intent: TradeIntent,
        settings: AutotradeSettingsSchema | TestAutotradeSettingsSchema,
        collection: str,
    ) -> None:
        runner = Autotrade(
            pair=intent.symbol,
            settings=settings,
            algorithm_name=intent.algorithm,
            binbot_api=self.binbot_api,
            db_collection_name=collection,
        )
        await runner.activate_autotrade(intent.signal)
        SINK_EMISSIONS.labels(sink="autotrade", outcome="launched").inc()
        get_event_log().emit(
            "autotrade_launch",
            symbol=intent.symbol,
            algorithm=intent.algorithm,
            collection=collection,
            trace_id=current_trace_id(),
        )

    # -- grid path ----------------------------------------------------------

    async def process_grid_deployment(self, data: SignalsConsumer) -> None:
        params = data.grid_params
        if not params or not (data.autotrade and self.autotrade_settings.autotrade):
            log.info("grid_ladder skipped: missing params or autotrade off")
            return
        if self._grid_attempts.on_cooldown(params):
            log.info(
                "grid_ladder skipped: attempt for %s within %ss",
                params.symbol,
                self.GRID_DEPLOYMENT_ATTEMPT_COOLDOWN_SECONDS,
            )
            return

        symbol = params.symbol
        self.active_bots = self._refresh_active("bots")
        if symbol in self.active_bots:
            log.info("grid_ladder skipped: active bot owns %s", symbol)
            return

        self.active_grid_ladders = self.binbot_api.get_active_grid_ladders()
        crowded = (
            len(self.active_grid_ladders)
            >= self.autotrade_settings.max_active_grid_ladders
        )
        symbol_taken = any(
            self._field(ladder, "symbol") == symbol
            for ladder in self.active_grid_ladders
        )
        unallocated = params.allocation_pct is None or params.cash_reserve_pct is None
        if crowded or symbol_taken or unallocated:
            log.info(
                "grid_ladder skipped: ladder limit, symbol already active, "
                "or missing allocation params"
            )
            return

        payload = params.model_dump(mode="json")
        try:
            # calculate-before-create: an uncomputable grid never consumes
            # the attempt cooldown
            self.binbot_api.calculate_grid_levels(payload)
        except BinbotError as veto:
            log.info(str(veto))
            return
        except Exception:
            log.exception(
                "calculate_grid_levels failed for %s; skipping create.", symbol
            )
            return

        self._grid_attempts.note(params)
        try:
            # Race-tolerant create: two workers can both pass the
            # active-ladder check; the 400 against the partial unique index
            # is logged, not raised.
            self.binbot_api.create_grid_ladder(payload)
            SINK_EMISSIONS.labels(sink="autotrade", outcome="grid_deployed").inc()
            get_event_log().emit(
                "autotrade_grid_deploy",
                symbol=symbol,
                algorithm="grid_ladder",
                trace_id=current_trace_id(),
            )
        except BinbotError as raced:
            log.info(str(raced))
        except Exception:
            log.exception(
                "create_grid_ladder failed for %s; another worker may have raced.",
                symbol,
            )

    # -- entry point --------------------------------------------------------

    async def process_autotrade_restrictions(self, result: SignalsConsumer) -> None:
        SINK_EMISSIONS.labels(sink="autotrade", outcome="attempt").inc()
        get_event_log().emit(
            "autotrade_attempt",
            symbol=result.symbol,
            algorithm=result.algorithm_name,
            kind=str(_value(result.signal_kind)),
            autotrade=bool(result.autotrade),
            trace_id=current_trace_id(),
        )
        if _value(result.signal_kind) == "grid_deploy":
            await self.process_grid_deployment(result)
            return
        if result.bot_params is None:
            log.info("Skipping autotrade: signal carries no bot_params.")
            return

        intent = self._intend(result)

        # Paper trading decides independently of the real-trade flags.
        if self.test_autotrade_settings.autotrade and not result.autotrade:
            if self._refusal(self._PAPER_GATES, intent) is None:
                await self._launch_bot(
                    intent, self.test_autotrade_settings, "paper_trading"
                )

        if self.grid_only_policy.block_standard_bots:
            log.info(
                "Skipping autotrade: grid-only policy active (%s)",
                self.grid_only_policy.reason,
            )
            return

        if not self._fund(intent):
            return

        if self.autotrade_settings.autotrade and result.autotrade:
            if self._refusal(self._REAL_BOT_GATES, intent) is None:
                await self._launch_bot(intent, self.autotrade_settings, "bots")
