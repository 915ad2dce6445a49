"""Time-of-day autotrade filter (host edge).

Port of ``binquant_tpu/regime/time_filter.py``: autotrade activations are
suppressed inside the 20:00–23:00 London quiet window unless the market is
in a strong, stable trend. The device step applies the same override
against the tick's own context (``engine.step.quiet_suppression``, from the
constants below); the per-symbol oracle resolves it here
(:func:`is_autotrade_suppressed`), as a frozen :class:`QuietHoursDecision`,
and a suppressed activation's Telegram block is
:func:`build_quiet_hours_signal_msg`.

London local time is computed from the UK civil-time rule (GMT, and BST =
UTC+1 from 01:00 UTC on the last Sunday of March to 01:00 UTC on the last
Sunday of October) instead of a time-zone database, so the filter's
decision does not hang on the host's tz data. :data:`LONDON` is the
reference's zone, ``ZoneInfo("Europe/London")``, for callers that want it.
"""

from __future__ import annotations

import calendar
import os
from datetime import datetime, timedelta, timezone
from typing import NamedTuple
from zoneinfo import ZoneInfo

from binquant_tpu_torch.enums import MarketRegimeCode, MarketTransitionCode

LONDON = ZoneInfo("Europe/London")

QUIET_START_HOUR = 20
QUIET_END_HOUR = 23

OVERRIDE_REGIMES = {int(MarketRegimeCode.TREND_UP), int(MarketRegimeCode.TREND_DOWN)}
MIN_TRANSITION_STRENGTH = 0.7


class QuietHoursDecision(NamedTuple):
    """The quiet-hours verdict for one instant and context."""

    suppressed: bool
    in_window: bool  # the London wall clock inside the quiet window
    override: bool  # the strong-stable-trend override engaged
    reason: str  # a short machine-readable cause


def _last_sunday_utc(year: int, month: int) -> datetime:
    last_day = calendar.monthrange(year, month)[1]
    d = datetime(year, month, last_day, 1, 0, tzinfo=timezone.utc)
    return d - timedelta(days=(d.weekday() - 6) % 7)


def london_time(now: datetime) -> datetime:
    """``now`` (aware) as naive London civil time."""
    utc = now.astimezone(timezone.utc)
    bst = _last_sunday_utc(utc.year, 3) <= utc < _last_sunday_utc(utc.year, 10)
    return (utc + timedelta(hours=1 if bst else 0)).replace(tzinfo=None)


def is_quiet_hours(now: datetime | None = None) -> bool:
    """True when the London-local hour is in [QUIET_START_HOUR, QUIET_END_HOUR)."""
    now = now or datetime.now(tz=timezone.utc)
    return QUIET_START_HOUR <= london_time(now).hour < QUIET_END_HOUR


def resolve_quiet_hours(
    market_regime: int | None,
    transition_strength: float,
    now: datetime | None = None,
) -> QuietHoursDecision:
    """The whole resolution. ``market_regime`` is the int code; None or a
    negative code means no valid context, which always suppresses inside
    the window. The override needs a trending regime AND a transition
    strength of at least :data:`MIN_TRANSITION_STRENGTH`."""
    if not is_quiet_hours(now):
        return QuietHoursDecision(False, False, False, "outside_window")
    if market_regime is None or market_regime < 0:
        return QuietHoursDecision(True, True, False, "no_context")
    if market_regime in OVERRIDE_REGIMES and transition_strength >= MIN_TRANSITION_STRENGTH:
        return QuietHoursDecision(False, True, True, "strong_trend")
    return QuietHoursDecision(True, True, False, "quiet_window")


def is_autotrade_suppressed(
    market_regime: int | None,
    transition_strength: float,
    now: datetime | None = None,
) -> bool:
    """Boolean view of :func:`resolve_quiet_hours`."""
    return resolve_quiet_hours(market_regime, transition_strength, now).suppressed


def _regime_name(market_regime: int | None) -> str:
    if market_regime is None or market_regime < 0:
        return "UNAVAILABLE"
    return MarketRegimeCode(market_regime).name


def _transition_name(transition: int | None) -> str:
    if transition is None or transition < 0:
        return "None"
    return MarketTransitionCode(transition).name


def _fmt3(value: float | None) -> str:
    return f"{value:.3f}" if value is not None else "n/a"


def build_quiet_hours_signal_msg(
    symbol: str,
    algo: str,
    side: str,
    market_regime: int | None,
    transition: int | None,
    transition_strength: float | None,
    stress: float | None,
    now: datetime | None = None,
) -> str:
    """The Telegram block of a suppressed activation; its key/value lines
    are what downstream parsers read, kept as the reference writes them."""
    london_now = london_time(now or datetime.now(tz=timezone.utc))
    return f"""
        - [{os.getenv("ENV", "")}] <strong>#time_of_day_block</strong>
        - Symbol: {symbol}
        - Algorithm: {algo}
        - Side: {side}
        - Reason: London time {london_now.strftime("%H:%M")} falls in the {QUIET_START_HOUR:02d}:00-{QUIET_END_HOUR:02d}:00 quiet window
        - Market regime: {_regime_name(market_regime)}
        - Market transition: {_transition_name(transition)}
        - Transition strength: {_fmt3(transition_strength)}
        - Market stress: {_fmt3(stress)}
        - Action: autotrade suppressed (signal kept as alert only)
    """
