"""The emitted payload shapes, as plain dataclasses.

The port's own copy of the parts of ``binquant_tpu/schemas.py`` emission
builds: ``SignalsConsumer`` (the signal every sink receives), ``BotBase``,
``GridDeploymentRequest``, ``HABollinguerSpread`` and the market-breadth
series the host policies read. Field names and defaults follow the
reference models so a payload serializes to the same JSON body;
``model_dump()`` is the JSON view (enums as their values, datetimes as ISO
strings).
"""

from __future__ import annotations

import dataclasses
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


class _Model:
    def model_dump(self, mode: str = "json") -> dict[str, Any]:
        return _jsonable(self)


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
