"""The emitted payload shapes, as plain dataclasses.

The port's own copy of the parts of ``binquant_tpu/schemas.py`` emission,
the sinks and the service around the tick use: ``SignalsConsumer`` (the
signal every sink receives), ``BotBase``, ``GridDeploymentRequest``,
``HABollinguerSpread``, the bot as the backend returns it (``BotModel``
with its ``DealBase`` and ``OrderBase`` parts, inside a ``BotResponse``),
``RecoveryParams``, the market-breadth series the host policies read, and
the binbot client's ``SymbolModel``, ``AutotradeSettingsSchema`` and
``TestAutotradeSettingsSchema``. Field names and defaults follow the
reference models so a payload serializes to the same JSON body.

The parts of pydantic's model behaviour the sinks read, on plain classes:

* construction and :meth:`_Model.model_validate` coerce every value passed
  to its field's type: scalars, enums (``"spot"`` becomes
  ``MarketType.SPOT``), nested models from dicts, ``Optional`` and ``list``
  fields, datetimes from ISO strings or epoch seconds, UUIDs from strings.
  Unknown keys are ignored. Defaults are not coerced, as pydantic leaves
  them;
* ``model_fields_set`` holds the names passed to the constructor or to
  ``model_validate`` and those assigned since, as pydantic's does (the
  autotrade gates tell a signal's explicit choice from a default by it);
* ``model_dump(mode="json")`` is the JSON view: enums as their values,
  UUIDs as strings, datetimes as pydantic writes them (``Z`` for UTC, a
  ``±HH:MM`` offset otherwise, six fractional digits when there are
  microseconds, none for a naive datetime), and, inside untyped containers
  (``dict[str, Any]``), non-finite floats as ``None``.
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
from typing import Any
from uuid import UUID, uuid4

from binquant_tpu_torch.enums import MarketType, Position, SignalKind, Status

__all__ = [
    "AutotradeSettingsSchema",
    "BotBase",
    "BotModel",
    "BotResponse",
    "CloseConditions",
    "DealBase",
    "GridDeploymentRequest",
    "HABollinguerSpread",
    "MarketBreadthSeries",
    "MarketType",
    "OrderBase",
    "Position",
    "RecoveryParams",
    "SignalsConsumer",
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


def _jsonable(value: Any, untyped: bool = False) -> Any:
    """The JSON view of ``value``; ``untyped`` marks the contents of an
    untyped container, where a non-finite float becomes ``None``."""
    if isinstance(value, _Model):
        return {
            name: _jsonable(getattr(value, name))
            for name in type(value)._field_names()
        }
    if isinstance(value, Enum):
        return value.value
    if isinstance(value, datetime):
        return json_datetime(value)
    if isinstance(value, UUID):
        return str(value)
    if isinstance(value, dict):
        return {k: _jsonable(v, True) for k, v in value.items()}
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


class _Model:
    """Base of the plain models (see the module docstring)."""

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
        coercers = type(self)._coercers()
        for name in passed:
            d[name] = coercers[name](d[name])
        d["_fields_set"] = passed

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

    @property
    def model_fields_set(self) -> set[str]:
        return self.__dict__.setdefault("_fields_set", set())

    def model_dump(self, mode: str = "json") -> dict[str, Any]:
        return _jsonable(self)

    @classmethod
    def model_validate(cls, data: Any):
        if isinstance(data, cls):
            return data
        return cls(**{name: data[name] for name in cls._field_names() if name in data})


# -- bots ------------------------------------------------------------------------


@dataclass
class RecoveryParams(_Model):
    """Bounded-recovery (reversal) parameters on a bot."""

    reversal_path: str = "source"
    source_contracts: float = 0
    source_loss_fiat: float = 0
    stop_loss_pct: float = 0


@dataclass
class OrderBase(_Model):
    order_id: int = 0
    order_type: str = ""
    time_in_force: str = ""
    timestamp: float = 0
    order_side: str = ""
    pair: str = ""
    qty: float = 0
    status: str = ""
    price: float = 0
    deal_type: str = "base_order"


@dataclass
class DealBase(_Model):
    current_price: float = 0
    take_profit_price: float = 0
    trailling_stop_loss_price: float = 0
    trailling_profit_price: float = 0
    stop_loss_price: float = 0
    total_commissions: float = 0
    margin_loan_id: int = 0
    margin_short_loan_principal: float = 0
    opening_price: float = 0
    opening_qty: float = 0
    opening_timestamp: float = 0
    closing_price: float = 0
    closing_qty: float = 0
    closing_timestamp: float = 0


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
class BotModel(BotBase):
    """Bot as returned by the binbot API (id, deal and orders filled in)."""

    id: UUID = field(default_factory=uuid4)
    deal: DealBase = field(default_factory=DealBase)
    orders: list[OrderBase] = field(default_factory=list)


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
