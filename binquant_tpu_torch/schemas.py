"""The emitted payload shapes, as plain dataclasses.

The port's own copy of the parts of ``binquant_tpu/schemas.py`` emission,
the sinks and the service around the tick use: ``SignalsConsumer`` (the
signal every sink receives), ``BotBase``, ``GridDeploymentRequest``,
``HABollinguerSpread``, the bot as the backend returns it (``BotModel``
with its ``DealBase`` and ``OrderBase`` parts, inside a ``BotResponse``),
``RecoveryParams``, the market-breadth series the host policies read, and
the binbot client's ``SymbolModel``, ``AutotradeSettingsSchema`` and
``TestAutotradeSettingsSchema``; the kline payloads (``KlineProduceModel``,
``ExtendedKline``), the market-regime models (``SymbolMarketFeatures``,
``LiveMarketContext``, ``MarketContextScore``,
``SignalContextEvaluation``), ``OrderModel``, ``DealModel`` and
``BBExtremeReversionDecision``. Field names and defaults follow the
reference models so a payload serializes to the same JSON body.

The parts of pydantic's model behaviour the sinks read, on plain classes:

* construction and :meth:`_Model.model_validate` coerce every value passed
  to its field's type: scalars, enums (``"spot"`` becomes
  ``MarketType.SPOT``), nested models from dicts, ``Optional``, ``list``
  and typed ``dict`` fields, datetimes from ISO strings or epoch seconds,
  UUIDs from strings; a ``Literal`` field refuses a value outside it.
  Unknown keys are ignored, or refused by a model that forbids them
  (``_forbid_extra``, pydantic's ``extra="forbid"``). Defaults are not
  coerced, as pydantic leaves them;
* a model's ``_bounds`` (pydantic's ``Field(ge=, le=)``) and its field
  validators (``_check``) hold the values passed; ``_prepare`` runs before
  coercion (a ``mode="before"`` validator) and ``_check`` may also hold the
  whole model (a ``mode="after"`` model validator). A refusal raises
  ``ValueError``, as pydantic's ``ValidationError`` is one;
* ``model_fields_set`` holds the names passed to the constructor or to
  ``model_validate`` and those assigned since, as pydantic's does (the
  autotrade gates tell a signal's explicit choice from a default by it);
* ``model_dump(mode="json")`` is the JSON view: enums as their values,
  UUIDs as strings, datetimes as pydantic writes them (``Z`` for UTC, a
  ``±HH:MM`` offset otherwise, six fractional digits when there are
  microseconds, none for a naive datetime), and, inside untyped containers
  (``dict[str, Any]``), non-finite floats as ``None`` (a typed container,
  ``dict[str, float]``, keeps them, as pydantic does).
"""

from __future__ import annotations

import dataclasses
import math
import types
import typing
from collections.abc import Callable
from dataclasses import dataclass, field
from datetime import datetime, timezone
from enum import Enum
from typing import Any, ClassVar
from uuid import UUID, uuid4

from binquant_tpu_torch.enums import (
    MarketRegime,
    MarketRegimeTransition,
    MarketType,
    MicroRegime,
    MicroRegimeTransition,
    Position,
    SignalKind,
    Status,
)

__all__ = [
    "AutotradeSettingsSchema",
    "BBExtremeReversionDecision",
    "BotBase",
    "BotModel",
    "BotResponse",
    "CloseConditions",
    "DealBase",
    "DealModel",
    "ExtendedKline",
    "GridDeploymentRequest",
    "HABollinguerSpread",
    "KlineProduceModel",
    "LiveMarketContext",
    "MarketBreadthSeries",
    "MarketContextScore",
    "MarketType",
    "OrderBase",
    "OrderModel",
    "Position",
    "RecoveryParams",
    "SignalContextEvaluation",
    "SignalsConsumer",
    "SymbolMarketFeatures",
    "SymbolModel",
    "TestAutotradeSettingsSchema",
]


class CloseConditions(str, Enum):
    dynamic_trailing = "dynamic_trailing"
    timestamp = "timestamp"
    market_reversal = "market_reversal"


# -- the JSON view ---------------------------------------------------------------


def json_datetime(value: datetime) -> str:
    """``value`` as pydantic's JSON mode writes it."""
    base = value.replace(tzinfo=None).isoformat()
    offset = value.utcoffset()
    if offset is None:
        return base
    seconds = int(offset.total_seconds())
    if seconds == 0:
        return base + "Z"
    sign = "-" if seconds < 0 else "+"
    seconds = abs(seconds)
    return f"{base}{sign}{seconds // 3600:02d}:{seconds % 3600 // 60:02d}"


def _jsonable(value: Any, untyped: bool = False, typed: bool = False) -> Any:
    """The JSON view of ``value``; ``untyped`` marks the contents of an
    untyped container, where a non-finite float becomes ``None``, and
    ``typed`` a dict whose values have a declared type."""
    if isinstance(value, _Model):
        typed_dicts = type(value)._typed_dicts()
        return {
            name: _jsonable(getattr(value, name), typed=name in typed_dicts)
            for name in type(value)._field_names()
        }
    if isinstance(value, Enum):
        return value.value
    if isinstance(value, datetime):
        return json_datetime(value)
    if isinstance(value, UUID):
        return str(value)
    if isinstance(value, dict):
        return {k: _jsonable(v, not typed) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_jsonable(v, untyped) for v in value]
    if untyped and isinstance(value, float) and not math.isfinite(value):
        return None
    return value


# -- coercion --------------------------------------------------------------------


def _identity(value: Any) -> Any:
    return value


def _parse_datetime(value: Any) -> datetime:
    if isinstance(value, datetime):
        return value
    if isinstance(value, (int, float)):
        return datetime.fromtimestamp(value, tz=timezone.utc)
    return datetime.fromisoformat(str(value))


def _coercer(kind: Any) -> Callable[[Any], Any]:
    """A function taking a value to a field of type ``kind``."""
    origin = typing.get_origin(kind)
    if origin is typing.Literal:
        allowed = typing.get_args(kind)

        def literal(v: Any) -> Any:
            if v not in allowed:
                raise ValueError(f"{v!r} is not one of {allowed}")
            return v

        return literal
    if origin is dict:
        args = typing.get_args(kind)
        item = _coercer(args[1]) if len(args) == 2 else _identity
        if item is _identity:
            return _identity
        return lambda v: {k: item(x) for k, x in v.items()}
    if origin in (typing.Union, types.UnionType):
        args = [a for a in typing.get_args(kind) if a is not type(None)]
        inner = _coercer(args[0]) if len(args) == 1 else _identity
        return lambda v: None if v is None else inner(v)
    if origin is list:
        args = typing.get_args(kind)
        item = _coercer(args[0]) if args else _identity
        return lambda v: [item(x) for x in v]
    if kind is bool:
        return lambda v: v if type(v) is bool else bool(v)
    if kind in (float, int, str):
        return lambda v: v if type(v) is kind else kind(v)
    if not isinstance(kind, type):
        return _identity
    if issubclass(kind, Enum):
        return lambda v: v if type(v) is kind else kind(v)
    if issubclass(kind, _Model):
        return lambda v: v if isinstance(v, kind) else kind.model_validate(v)
    if kind is datetime:
        return _parse_datetime
    if kind is UUID:
        return lambda v: v if isinstance(v, UUID) else UUID(str(v))
    return _identity


_FIELD_NAMES: dict[type, tuple[str, ...]] = {}
_COERCERS: dict[type, dict[str, Callable[[Any], Any]]] = {}
_TYPED_DICTS: dict[type, frozenset[str]] = {}


class _Model:
    """Base of the plain models (see the module docstring)."""

    _forbid_extra: ClassVar[bool] = False
    _bounds: ClassVar[dict[str, tuple[float | None, float | None]]] = {}

    def __new__(cls, *args: Any, **kwargs: Any):
        self = super().__new__(cls)
        if args or kwargs:  # (a copy or an unpickling passes none)
            passed = set(cls._field_names()[: len(args)])
            passed.update(kwargs)
            object.__setattr__(self, "_init_set", passed)
        return self

    def __post_init__(self) -> None:
        d = self.__dict__
        passed = d.pop("_init_set", set())
        cls = type(self)
        cls._prepare(d, passed)
        coercers = cls._coercers()
        for name in passed:
            d[name] = coercers[name](d[name])
        for name, (lo, hi) in cls._bounds.items():
            if name in passed and d[name] is not None and not (
                (lo is None or d[name] >= lo) and (hi is None or d[name] <= hi)
            ):
                raise ValueError(f"{cls.__name__}.{name}={d[name]!r} outside [{lo}, {hi}]")
        d["_fields_set"] = passed
        self._check(passed)

    @classmethod
    def _prepare(cls, values: dict[str, Any], passed: set[str]) -> None:
        """Hook: the passed values before coercion."""

    def _check(self, passed: set[str]) -> None:
        """Hook: the coerced model; raise ``ValueError`` to refuse it."""

    def __setattr__(self, name: str, value: Any) -> None:
        d = self.__dict__
        fields_set = d.get("_fields_set")
        if fields_set is not None and name in type(self)._field_names():
            fields_set.add(name)
        d[name] = value

    @classmethod
    def _field_names(cls) -> tuple[str, ...]:
        names = _FIELD_NAMES.get(cls)
        if names is None:
            names = tuple(f.name for f in dataclasses.fields(cls))
            _FIELD_NAMES[cls] = names
        return names

    @classmethod
    def _coercers(cls) -> dict[str, Callable[[Any], Any]]:
        table = _COERCERS.get(cls)
        if table is None:
            hints = typing.get_type_hints(cls)
            table = {name: _coercer(hints[name]) for name in cls._field_names()}
            _COERCERS[cls] = table
        return table

    @classmethod
    def _typed_dicts(cls) -> frozenset[str]:
        names = _TYPED_DICTS.get(cls)
        if names is None:
            hints = typing.get_type_hints(cls)
            names = frozenset(
                name for name in cls._field_names()
                if typing.get_origin(hints[name]) is dict
                and _coercer(hints[name]) is not _identity
            )
            _TYPED_DICTS[cls] = names
        return names

    @property
    def model_fields_set(self) -> set[str]:
        return self.__dict__.setdefault("_fields_set", set())

    def model_dump(self, mode: str = "json") -> dict[str, Any]:
        return _jsonable(self)

    @classmethod
    def model_validate(cls, data: Any):
        if isinstance(data, cls):
            return data
        if cls._forbid_extra:
            extra = sorted(set(data) - set(cls._field_names()))
            if extra:
                raise ValueError(f"{cls.__name__}: extra fields not permitted: {extra}")
        return cls(**{name: data[name] for name in cls._field_names() if name in data})


# -- bots ------------------------------------------------------------------------


@dataclass
class RecoveryParams(_Model):
    """Bounded-recovery (reversal) parameters on a bot."""

    reversal_path: str = "source"
    source_contracts: float = 0.0
    source_loss_fiat: float = 0.0
    stop_loss_pct: float = 0.0


@dataclass
class OrderBase(_Model):
    order_id: int = 0
    order_type: str = ""
    time_in_force: str = ""
    timestamp: float = 0.0
    order_side: str = ""
    pair: str = ""
    qty: float = 0.0
    status: str = ""
    price: float = 0.0
    deal_type: str = "base_order"


@dataclass
class DealBase(_Model):
    current_price: float = 0.0
    take_profit_price: float = 0.0
    trailling_stop_loss_price: float = 0.0
    trailling_profit_price: float = 0.0
    stop_loss_price: float = 0.0
    total_commissions: float = 0.0
    margin_loan_id: int = 0
    margin_short_loan_principal: float = 0.0
    opening_price: float = 0.0
    opening_qty: float = 0.0
    opening_timestamp: float = 0.0
    closing_price: float = 0.0
    closing_qty: float = 0.0
    closing_timestamp: float = 0.0


@dataclass
class BotBase(_Model):
    """Bot creation payload sent to the binbot REST API."""

    pair: str
    name: str = "terminal"
    fiat: str = "USDT"
    quote_asset: str = "USDC"
    fiat_order_size: float = 15.0
    candlestick_interval: str = "15m"
    close_condition: CloseConditions = CloseConditions.dynamic_trailing
    cooldown: int = 0
    dynamic_trailing: bool = False
    logs: list[str] = field(default_factory=list)
    mode: str = "manual"
    status: Status = Status.inactive
    stop_loss: float = 0.0
    take_profit: float = 2.3
    trailing: bool = True
    trailing_deviation: float = 0.63
    trailing_profit: float = 2.3
    margin_short_reversal: bool = False
    position: Position = Position.long
    market_type: MarketType = MarketType.SPOT
    leverage: float = 1.0
    recovery_params: RecoveryParams | None = None
    created_at: float = 0.0
    updated_at: float = 0.0


@dataclass
class OrderModel(OrderBase):
    pass


@dataclass
class DealModel(DealBase):
    @classmethod
    def validate_margin_loan_id(cls, value: Any) -> Any:
        if isinstance(value, float):
            return int(value)
        return value

    @classmethod
    def _prepare(cls, values: dict[str, Any], passed: set[str]) -> None:
        if "margin_loan_id" in passed:
            values["margin_loan_id"] = cls.validate_margin_loan_id(values["margin_loan_id"])


@dataclass
class BotModel(BotBase):
    """Bot as returned by the binbot API (id, deal and orders filled in)."""

    id: UUID = field(default_factory=uuid4)
    deal: DealModel = field(default_factory=DealModel)
    orders: list[OrderModel] = field(default_factory=list)


@dataclass
class BotResponse(_Model):
    message: str = ""
    error: int = 0
    data: BotModel | None = None


# -- grid deployment and the signal ----------------------------------------------


@dataclass
class GridDeploymentRequest(_Model):
    symbol: str
    fiat: str
    exchange: str
    market_type: MarketType
    algorithm_name: str
    generated_at: datetime
    range_low: float
    range_high: float
    breakout_low: float
    breakout_high: float
    total_margin: float
    level_count: int
    leverage: float = 1.0
    current_price: float = 0.0
    current_regime: str | None = None
    context: dict[str, Any] = field(default_factory=dict)
    indicators: dict[str, Any] = field(default_factory=dict)
    allocation_pct: float | None = None
    cash_reserve_pct: float | None = None
    metadata: dict[str, Any] = field(default_factory=dict)


@dataclass
class HABollinguerSpread(_Model):
    bb_high: float = 0.0
    bb_mid: float = 0.0
    bb_low: float = 0.0


@dataclass
class SignalsConsumer(_Model):
    """The signal emitted to all three sinks (telegram/analytics/autotrade)."""

    autotrade: bool = False
    current_price: float = 0.0
    direction: str = "LONG"
    score: float = 0.0
    volume: float = 0.0
    signal_kind: SignalKind = SignalKind.standard
    algorithm_name: str = ""
    symbol: str = ""
    bot_params: BotBase | None = None
    grid_params: GridDeploymentRequest | None = None
    bb_spreads: HABollinguerSpread | None = None
    metadata: dict[str, Any] = field(default_factory=dict)


@dataclass
class MarketBreadthSeries(_Model):
    """Rolling market-breadth series (newest first, as the analytics API
    serves it); consumers order by timestamp and drop non-finite entries."""

    timestamp: list[Any] = field(default_factory=list)
    market_breadth: list[float | None] = field(default_factory=list)
    market_breadth_ma: list[float | None] = field(default_factory=list)

    @classmethod
    def from_payload(cls, data: dict | None) -> "MarketBreadthSeries":
        data = data or {}
        return cls(
            timestamp=list(data.get("timestamp", [])),
            market_breadth=list(data.get("market_breadth", [])),
            market_breadth_ma=list(data.get("market_breadth_ma", [])),
        )

    @classmethod
    def model_validate(cls, data: Any) -> "MarketBreadthSeries":
        if isinstance(data, cls):
            return data
        return cls.from_payload(data)


# -- symbols and settings (the binbot client's models) -------------------------


@dataclass
class SymbolModel(_Model):
    id: str
    base_asset: str = ""
    quote_asset: str = "USDT"
    active: bool = True
    is_margin_trading_allowed: bool = False
    price_precision: int = 6
    qty_precision: int = 6
    min_notional: float = 5.0
    cooldown: int = 0
    cooldown_start_ts: int = 0
    leverage: float = 1.0
    futures_leverage: float = 1.0
    blacklist_reason: str = ""


@dataclass
class AutotradeSettingsSchema(_Model):
    autotrade: bool = False
    exchange_id: str = "binance"
    market_type: MarketType = MarketType.SPOT
    candlestick_interval: str = "15m"
    fiat: str = "USDT"
    base_order_size: float = 15.0
    stop_loss: float = 3.0
    take_profit: float = 2.3
    trailing: bool = True
    trailing_deviation: float = 0.63
    trailing_profit: float = 2.3
    autoswitch: bool = False
    max_active_autotrade_bots: int = 10
    grid_total_margin: float = 10.0
    grid_level_count: int = 7
    max_active_grid_ladders: int = 3
    grid_allocation_pct: float | None = 60.0
    grid_cash_reserve_pct: float | None = 40.0
    test_autotrade: bool = False


@dataclass
class TestAutotradeSettingsSchema(AutotradeSettingsSchema):
    __test__ = False  # a model, not a pytest class

    test_autotrade: bool = True


# -- kline payloads ----------------------------------------------------------------


@dataclass(kw_only=True)
class KlineProduceModel(_Model):
    """One closed candle as the websocket connector produces it."""

    symbol: str
    open_time: str
    close_time: str
    open_price: str
    high_price: str
    low_price: str
    close_price: str
    volume: str


@dataclass(kw_only=True)
class ExtendedKline(_Model):
    """The closed-candle payload the ring keeps: ``KlineProduceModel``'s
    fields and Binance's quote volume, trade count and taker-buy splits."""

    symbol: str
    open_time: int
    close_time: int
    open: float
    high: float
    low: float
    close: float
    volume: float
    quote_asset_volume: float = 0.0
    number_of_trades: float = 0.0
    taker_buy_base_volume: float = 0.0
    taker_buy_quote_volume: float = 0.0

    @classmethod
    def from_produce_model(cls, m: KlineProduceModel | dict[str, Any]) -> "ExtendedKline":
        if isinstance(m, dict):
            m = KlineProduceModel.model_validate(m)
        return cls(
            symbol=m.symbol,
            open_time=int(float(m.open_time)),
            close_time=int(float(m.close_time)),
            open=float(m.open_price),
            high=float(m.high_price),
            low=float(m.low_price),
            close=float(m.close_price),
            volume=float(m.volume),
        )


# -- market-regime models -------------------------------------------------------


def _normalize_direction(value: str) -> str:
    return value.upper().strip()


def _canonicalize_symbol(value: str) -> str:
    return value.upper().strip().replace("-", "").replace("_", "")


_UNIT = (0.0, 1.0)
_SIGNED_UNIT = (-1.0, 1.0)
_NON_NEGATIVE = (0.0, None)


@dataclass(kw_only=True)
class SymbolMarketFeatures(_Model):
    _forbid_extra: ClassVar[bool] = True
    _bounds: ClassVar[dict] = {
        "micro_regime_strength": _UNIT,
        "micro_regime_transition_strength": _UNIT,
    }

    symbol: str
    timestamp: int
    close: float
    return_pct: float
    ema20: float
    ema50: float
    above_ema20: bool
    above_ema50: bool
    trend_score: float
    relative_strength_vs_btc: float
    atr_pct: float
    bb_width: float
    micro_regime: MicroRegime | None = None
    micro_regime_strength: float = 0.0
    micro_regime_transition: MicroRegimeTransition | None = None
    micro_regime_transition_strength: float = 0.0

    @classmethod
    def validate_symbol(cls, value: str) -> str:
        return value.strip().upper()

    @classmethod
    def validate_timestamp(cls, value: int) -> int:
        if value < 0:
            raise ValueError("timestamp must be non-negative")
        return value

    def _check(self, passed: set[str]) -> None:
        if "symbol" in passed:
            self.__dict__["symbol"] = self.validate_symbol(self.symbol)
        if "timestamp" in passed:
            self.validate_timestamp(self.timestamp)


@dataclass(kw_only=True)
class LiveMarketContext(_Model):
    _forbid_extra: ClassVar[bool] = True
    _bounds: ClassVar[dict] = {
        "coverage_ratio": _UNIT,
        "confidence": _UNIT,
        "advancers_ratio": _UNIT,
        "decliners_ratio": _UNIT,
        "advancers_decliners_ratio": _NON_NEGATIVE,
        "pct_above_ema20": _UNIT,
        "pct_above_ema50": _UNIT,
        "average_atr_pct": _NON_NEGATIVE,
        "average_bb_width": _NON_NEGATIVE,
        "btc_regime_score": _SIGNED_UNIT,
        "market_stress_score": _UNIT,
        "long_tailwind": _SIGNED_UNIT,
        "short_tailwind": _SIGNED_UNIT,
        "market_regime_transition_strength": _UNIT,
        "long_regime_score": _UNIT,
        "short_regime_score": _UNIT,
        "range_regime_score": _UNIT,
        "stress_regime_score": _UNIT,
    }
    _NON_NEGATIVE_INTS: ClassVar[tuple[str, ...]] = (
        "timestamp", "fresh_count", "total_tracked_symbols", "advancers", "decliners",
    )

    timestamp: int
    fresh_count: int
    total_tracked_symbols: int
    coverage_ratio: float
    btc_symbol: str
    btc_present: bool
    confidence: float
    is_provisional: bool
    advancers: int
    decliners: int
    advancers_ratio: float
    decliners_ratio: float
    advancers_decliners_ratio: float
    average_return: float
    average_relative_strength_vs_btc: float
    pct_above_ema20: float
    pct_above_ema50: float
    average_trend_score: float
    average_atr_pct: float
    average_bb_width: float
    btc_return: float
    btc_trend_score: float
    btc_regime_score: float
    market_stress_score: float
    long_tailwind: float
    short_tailwind: float
    market_regime: MarketRegime | None = None
    previous_market_regime: MarketRegime | None = None
    market_regime_transition: MarketRegimeTransition | None = None
    market_regime_transition_strength: float = 0.0
    long_regime_score: float = 0.0
    short_regime_score: float = 0.0
    range_regime_score: float = 0.0
    stress_regime_score: float = 0.0
    regime_is_transitioning: bool = False
    # ms timestamp at which the current market_regime was first entered
    regime_stable_since: int | None = None
    symbol_features: dict[str, SymbolMarketFeatures] = field(default_factory=dict)
    metadata: dict[str, Any] = field(default_factory=dict)

    @classmethod
    def validate_btc_symbol(cls, value: str) -> str:
        return value.strip().upper()

    @classmethod
    def validate_non_negative_ints(cls, value: int) -> int:
        if value < 0:
            raise ValueError("value must be non-negative")
        return value

    @property
    def is_full(self) -> bool:
        return not self.is_provisional

    def validate_consistency(self) -> "LiveMarketContext":
        if self.fresh_count > self.total_tracked_symbols:
            raise ValueError("fresh_count cannot exceed total_tracked_symbols")
        if self.advancers + self.decliners > self.fresh_count:
            raise ValueError("advancers plus decliners cannot exceed fresh_count")
        return self

    def get_symbol_features(self, symbol: str) -> SymbolMarketFeatures | None:
        normalized = symbol.strip().upper()
        direct = self.symbol_features.get(normalized)
        if direct is not None:
            return direct
        canonical = _canonicalize_symbol(normalized)
        for known_symbol, features in self.symbol_features.items():
            if _canonicalize_symbol(known_symbol) == canonical:
                return features
        return None

    def _check(self, passed: set[str]) -> None:
        if "btc_symbol" in passed:
            self.__dict__["btc_symbol"] = self.validate_btc_symbol(self.btc_symbol)
        for name in self._NON_NEGATIVE_INTS:
            if name in passed:
                self.validate_non_negative_ints(getattr(self, name))
        self.validate_consistency()


@dataclass(kw_only=True)
class MarketContextScore(_Model):
    _forbid_extra: ClassVar[bool] = True
    _bounds: ClassVar[dict] = {
        "confidence": _UNIT,
        "long_tailwind": _SIGNED_UNIT,
        "short_tailwind": _SIGNED_UNIT,
        "breadth_score": _SIGNED_UNIT,
        "btc_alignment_score": _SIGNED_UNIT,
        "cross_asset_confirmation": _SIGNED_UNIT,
        "market_stress_score": _UNIT,
        "followthrough_score": _SIGNED_UNIT,
        "adverse_excursion_risk": _UNIT,
        "override_strength": _UNIT,
        "supportiveness_score": _SIGNED_UNIT,
    }

    symbol: str
    direction: str
    context_timestamp: int | None
    confidence: float
    long_tailwind: float
    short_tailwind: float
    breadth_score: float
    btc_alignment_score: float
    cross_asset_confirmation: float
    market_stress_score: float
    followthrough_score: float
    adverse_excursion_risk: float
    override_strength: float
    supportiveness_score: float
    metadata: dict[str, Any] = field(default_factory=dict)

    @classmethod
    def validate_symbol(cls, value: str) -> str:
        return value.strip().upper()

    @classmethod
    def validate_direction(cls, value: str) -> str:
        return _normalize_direction(value)

    def _check(self, passed: set[str]) -> None:
        if "symbol" in passed:
            self.__dict__["symbol"] = self.validate_symbol(self.symbol)
        if "direction" in passed:
            self.__dict__["direction"] = self.validate_direction(self.direction)


@dataclass(kw_only=True)
class SignalContextEvaluation(_Model):
    _forbid_extra: ClassVar[bool] = True

    symbol: str
    direction: str
    local_score: float
    local_features: dict[str, float]
    adjusted_score: float
    emit: bool = True
    context_score: MarketContextScore


# -- structured strategy decisions ---------------------------------------------


@dataclass(kw_only=True)
class BBExtremeReversionDecision(_Model):
    fired: bool
    direction: str | None = None
    reason: str = ""
    connors_rsi: float | None = None
    close: float | None = None
    bb_high: float | None = None
    bb_low: float | None = None
    score: float = 0.0
