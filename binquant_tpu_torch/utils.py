"""Scalar and tensor math helpers, the host-edge formatting helpers emission
uses, and Binance's request-weight guard.

The scalar ``clamp``/``non_negative``/``safe_pct`` (python floats, the
per-symbol oracle's) and the tensor ``jsafe_div``/``jclamp``/
``jnon_negative``/``jsafe_pct`` keep the reference package's names
(``binquant_tpu/utils.py``) so the ported formulas read the same.
"""

from __future__ import annotations

from datetime import datetime, timezone
from typing import Any

import torch

UTC = timezone.utc


def clamp(value: float, low: float = -1.0, high: float = 1.0) -> float:
    return max(low, min(high, float(value)))


def non_negative(value: float) -> float:
    return max(0.0, float(value))


def safe_pct(current: float, previous: float) -> float:
    if previous == 0:
        return 0.0
    return (float(current) - float(previous)) / abs(float(previous))


def jclamp(value: torch.Tensor, low: float = -1.0, high: float = 1.0) -> torch.Tensor:
    return torch.clamp(value, low, high)


def jnon_negative(value: torch.Tensor) -> torch.Tensor:
    return torch.clamp(value, min=0.0)


def jsafe_pct(current: torch.Tensor, previous: torch.Tensor) -> torch.Tensor:
    """(current - previous) / |previous|, 0 where previous == 0."""
    denom = torch.abs(previous)
    ok = denom > 0
    return torch.where(
        ok, (current - previous) / torch.where(ok, denom, torch.ones_like(denom)), 0.0
    )


def jsafe_div(
    num: torch.Tensor, den: torch.Tensor, default: float = 0.0
) -> torch.Tensor:
    """num / den with ``default`` where den == 0 (no NaN/Inf)."""
    ok = den != 0
    return torch.where(ok, num / torch.where(ok, den, torch.ones_like(den)), default)


def normalize_timestamp(value: Any) -> datetime:
    """Coerce a ms-epoch int/float or a datetime into an aware UTC datetime."""
    if isinstance(value, datetime):
        if value.tzinfo is None:
            return value.replace(tzinfo=UTC)
        return value.astimezone(UTC)
    return datetime.fromtimestamp(float(value) / 1000, tz=UTC)


def safe_format(value: Any, spec: str = ".2f") -> str:
    """Format a value numerically, falling back to str() on non-numerics."""
    try:
        return format(float(value), spec)
    except (TypeError, ValueError):
        return str(value)


def round_numbers(value: float, decimals: int = 6) -> float:
    return float(round(float(value), decimals))


def timestamp_to_datetime(value: Any) -> str:
    return normalize_timestamp(value).strftime("%Y-%m-%d %H:%M:%S UTC")


def format_context_timestamp_line(timestamp_ms: int | None) -> str:
    if timestamp_ms is None:
        return "- Context timestamp: UNAVAILABLE"
    return f"- Context timestamp: {timestamp_to_datetime(timestamp_ms)}"


def build_links_msg(
    env: str, exchange: str, market_type: str, symbol: str
) -> tuple[str, str]:
    """(exchange_link, terminal_link) for Telegram messages."""
    exchange = str(exchange).lower()
    market_type = str(market_type).lower()
    if exchange == "binance":
        exchange_link = f"https://www.binance.com/en/trade/{symbol}"
    elif market_type == "futures":
        exchange_link = f"https://www.kucoin.com/trade/futures/{symbol}"
    else:
        exchange_link = f"https://www.kucoin.com/trade/{symbol}"
    terminal_host = (
        "https://terminal.binbot.in" if env == "production" else "http://localhost:3000"
    )
    terminal_link = (
        f"{terminal_host}/bots/futures/new/{symbol}"
        if market_type == "futures"
        else f"{terminal_host}/bots/new/{symbol}"
    )
    return exchange_link, terminal_link


# Binance's request-weight guard: the REST client pauses near the 1200/min cap
BINANCE_WEIGHT_LIMIT_PER_MIN = 1200
BINANCE_WEIGHT_SOFT_CAP = 1000


def binance_weight_backoff_seconds(used_weight: int) -> float:
    """Seconds to sleep given the ``x-mbx-used-weight-1m`` header value: a
    minute once the used weight passes the soft cap, else none."""
    if used_weight <= BINANCE_WEIGHT_SOFT_CAP:
        return 0.0
    return 60.0
