"""Integer regime codes and the host-edge enumerations.

The port's own copy of ``binquant_tpu/enums.py``: every categorical is an
int32 code on the device, and the string views (the ``*_label`` functions
and the ``Literal`` aliases) are the wire vocabulary emitted payloads, the
schema models and the oracle's regime log carry.
"""

from __future__ import annotations

from enum import Enum, IntEnum
from typing import Literal

direction_type = Literal["LONG", "SHORT"]


class Direction(IntEnum):
    LONG = 0
    SHORT = 1

    @property
    def label(self) -> str:
        return self.name


class MarketRegimeCode(IntEnum):
    TRANSITIONAL = 0
    TREND_UP = 1
    TREND_DOWN = 2
    RANGE = 3
    HIGH_STRESS = 4


class MicroRegimeCode(IntEnum):
    TRANSITIONAL = 0
    TREND_UP = 1
    TREND_DOWN = 2
    RANGE = 3
    VOLATILE = 4


class MarketTransitionCode(IntEnum):
    NONE = 0
    STRESS_SPIKE = 1
    STRESS_RELIEF = 2
    ENTERED_TREND_UP = 3
    ENTERED_TREND_DOWN = 4
    ENTERED_RANGE = 5
    LOST_REGIME_EDGE = 6


class MicroTransitionCode(IntEnum):
    NONE = 0
    VOLATILITY_EXPANSION = 1
    BREAKOUT_UP = 2
    BREAKDOWN = 3
    RECOVERY = 4
    MEAN_REVERSION = 5
    ENTERED_TREND_UP = 6
    ENTERED_TREND_DOWN = 7
    ENTERED_RANGE = 8
    ENTERED_TRANSITIONAL = 9


MarketRegime = Literal[
    "TRANSITIONAL", "TREND_UP", "TREND_DOWN", "RANGE", "HIGH_STRESS"
]
MicroRegime = Literal["TRANSITIONAL", "TREND_UP", "TREND_DOWN", "RANGE", "VOLATILE"]
MarketRegimeTransition = Literal[
    "STRESS_SPIKE",
    "STRESS_RELIEF",
    "ENTERED_TREND_UP",
    "ENTERED_TREND_DOWN",
    "ENTERED_RANGE",
    "LOST_REGIME_EDGE",
]
MicroRegimeTransition = Literal[
    "VOLATILITY_EXPANSION",
    "BREAKOUT_UP",
    "BREAKDOWN",
    "RECOVERY",
    "MEAN_REVERSION",
    "ENTERED_TREND_UP",
    "ENTERED_TREND_DOWN",
    "ENTERED_RANGE",
    "ENTERED_TRANSITIONAL",
]


def market_regime_label(code: int) -> MarketRegime:
    return MarketRegimeCode(int(code)).name  # type: ignore[return-value]


def micro_regime_label(code: int) -> MicroRegime:
    return MicroRegimeCode(int(code)).name  # type: ignore[return-value]


def market_transition_label(code: int) -> str | None:
    c = MarketTransitionCode(int(code))
    return None if c == MarketTransitionCode.NONE else c.name


def micro_transition_label(code: int) -> str | None:
    c = MicroTransitionCode(int(code))
    return None if c == MicroTransitionCode.NONE else c.name


class ExchangeId(str, Enum):
    BINANCE = "binance"
    KUCOIN = "kucoin"


class MarketType(str, Enum):
    """Wire values are uppercase; parsing is case-insensitive."""

    SPOT = "SPOT"
    FUTURES = "FUTURES"

    @classmethod
    def _missing_(cls, value):
        if isinstance(value, str):
            upper = value.upper()
            for member in cls:
                if member.value == upper:
                    return member
        return None


class SignalKind(str, Enum):
    standard = "standard"
    grid_deploy = "grid_deploy"
    notification = "notification"


class Position(str, Enum):
    long = "long"
    short = "short"


class Status(str, Enum):
    inactive = "inactive"
    # a submitted-but-not-yet-opened bot (a resting limit entry): the
    # activation path reports it as "submitted" rather than "opened"
    pending = "pending"
    active = "active"
    completed = "completed"
    error = "error"
    archived = "archived"


class Strategy(str, Enum):
    long = "long"
    margin_short = "margin_short"


class DealType(str, Enum):
    base_order = "base_order"
    take_profit = "take_profit"
    stop_loss = "stop_loss"
    short_sell = "short_sell"
    short_buy = "short_buy"
    trailling_profit = "trailling_profit"


class MarketDominance(str, Enum):
    NEUTRAL = "NEUTRAL"
    GAINERS = "GAINERS"
    LOSERS = "LOSERS"


class KlineInterval(str, Enum):
    """Candle intervals with millisecond arithmetic."""

    one_minute = "1m"
    three_minutes = "3m"
    five_minutes = "5m"
    fifteen_minutes = "15m"
    thirty_minutes = "30m"
    one_hour = "1h"
    two_hours = "2h"
    four_hours = "4h"
    six_hours = "6h"
    twelve_hours = "12h"
    one_day = "1d"
    one_week = "1w"

    def get_ms(self) -> int:
        unit = self.value[-1]
        qty = int(self.value[:-1])
        scale = {
            "m": 60_000,
            "h": 3_600_000,
            "d": 86_400_000,
            "w": 604_800_000,
        }[unit]
        return qty * scale

    def bars_per(self, other: "KlineInterval") -> int:
        """How many of ``self`` fit in ``other`` (15m.bars_per(1h) == 4)."""
        return other.get_ms() // self.get_ms()
