"""Time-of-day autotrade filter (host edge).

Port of the quiet-hours window of ``binquant_tpu/regime/time_filter.py``:
autotrade activations are suppressed inside the 20:00–23:00 London quiet
window unless the market is in a strong, stable trend (applied device-side
by ``engine.step.quiet_suppression`` from the constants below).

London local time is computed from the UK civil-time rule (GMT, and BST =
UTC+1 from 01:00 UTC on the last Sunday of March to 01:00 UTC on the last
Sunday of October) instead of a time-zone database, so the filter needs no
tz data on the host it runs on.
"""

from __future__ import annotations

import calendar
from datetime import datetime, timedelta, timezone

from binquant_tpu_torch.enums import MarketRegimeCode

QUIET_START_HOUR = 20
QUIET_END_HOUR = 23

OVERRIDE_REGIMES = {int(MarketRegimeCode.TREND_UP), int(MarketRegimeCode.TREND_DOWN)}
MIN_TRANSITION_STRENGTH = 0.7


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
