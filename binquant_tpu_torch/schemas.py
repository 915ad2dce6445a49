"""The emitted payload shapes, as plain dataclasses.

The port's own copy of the parts of ``binquant_tpu/schemas.py`` emission
and the service around the tick use: ``SignalsConsumer`` (the signal every
sink receives), ``BotBase``, ``GridDeploymentRequest``,
``HABollinguerSpread``, the market-breadth series the host policies read,
and the binbot client's ``SymbolModel``, ``AutotradeSettingsSchema`` and
``TestAutotradeSettingsSchema``. Field names and defaults follow the
reference models so a payload serializes to the same JSON body;
``model_dump()`` is the JSON view (enums as their values, datetimes as ISO
strings) and ``model_validate(dict)`` builds a model from a JSON body,
keeping the known fields (others are ignored) and coercing scalars to the
field's type as the reference's models do.
"""

from __future__ import annotations

import dataclasses
import types
import typing
from dataclasses import dataclass, field
from datetime import datetime
from enum import Enum
from typing import Any

from binquant_tpu_torch.enums import MarketType, Position, SignalKind


def _jsonable(value: Any) -> Any:
    if isinstance(value, Enum):
        return value.value
    if isinstance(value, datetime):
        return value.isoformat()
    if dataclasses.is_dataclass(value):
        return {f.name: _jsonable(getattr(value, f.name)) for f in dataclasses.fields(value)}
    if isinstance(value, dict):
        return {k: _jsonable(v) for k, v in value.items()}
    if isinstance(value, list):
        return [_jsonable(v) for v in value]
    return value


def _coerce(kind: Any, value: Any) -> Any:
    """``value`` as a field of type ``kind``: optional fields keep None,
    scalars and enums are converted, anything else passes through."""
    if typing.get_origin(kind) in (typing.Union, types.UnionType):
        args = [a for a in typing.get_args(kind) if a is not type(None)]
        if value is None:
            return None
        return _coerce(args[0], value) if len(args) == 1 else value
    if kind in (float, int, str, bool):
        return kind(value)
    if isinstance(kind, type) and issubclass(kind, Enum):
        return kind(value)
    return value


class _Model:
    def model_dump(self, mode: str = "json") -> dict[str, Any]:
        return _jsonable(self)

    @classmethod
    def model_validate(cls, data: Any):
        if isinstance(data, cls):
            return data
        hints = typing.get_type_hints(cls)
        return cls(**{
            f.name: _coerce(hints[f.name], data[f.name])
            for f in dataclasses.fields(cls)
            if f.name in data
        })


@dataclass
class BotBase(_Model):
    pair: str
    name: str = "terminal"
    fiat: str = "USDT"
    quote_asset: str = "USDC"
    fiat_order_size: float = 15.0
    candlestick_interval: str = "15m"
    close_condition: str = "dynamic_trailing"
    cooldown: int = 0
    dynamic_trailing: bool = False
    logs: list[str] = field(default_factory=list)
    mode: str = "manual"
    status: str = "inactive"
    stop_loss: float = 0.0
    take_profit: float = 2.3
    trailing: bool = True
    trailing_deviation: float = 0.63
    trailing_profit: float = 2.3
    margin_short_reversal: bool = False
    position: Position = Position.long
    market_type: MarketType = MarketType.SPOT
    leverage: float = 1.0
    recovery_params: dict[str, Any] | None = None
    created_at: float = 0.0
    updated_at: float = 0.0


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
