"""Integer regime codes and the host-edge enumerations emission needs.

The port's own copy of the parts of ``binquant_tpu/enums.py`` the classic
tick and its emission read: every categorical is an int32 code on the device,
and the string views (the ``*_label`` functions) are the wire vocabulary
emitted payloads and the oracle's regime log carry.
"""

from __future__ import annotations

from enum import Enum, IntEnum


class Direction(IntEnum):
    LONG = 0
    SHORT = 1


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


def market_regime_label(code: int) -> str:
    return MarketRegimeCode(int(code)).name


def micro_regime_label(code: int) -> str:
    return MicroRegimeCode(int(code)).name


def market_transition_label(code: int) -> str | None:
    c = MarketTransitionCode(int(code))
    return None if c == MarketTransitionCode.NONE else c.name


def micro_transition_label(code: int) -> str | None:
    c = MicroTransitionCode(int(code))
    return None if c == MicroTransitionCode.NONE else c.name


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
