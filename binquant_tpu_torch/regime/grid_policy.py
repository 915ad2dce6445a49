"""Grid-only trading mode (host edge).

Port of ``binquant_tpu/regime/grid_policy.py``: in RANGE/TRANSITIONAL
regimes, non-flat market-breadth momentum flips the engine into "grid
ladders only" mode (ladder deploys allowed). The verdict feeds the next
tick's ``grid_policy_allows`` host input.
"""

from __future__ import annotations

from datetime import datetime, timezone
from math import isfinite
from typing import Any, NamedTuple

from binquant_tpu_torch.enums import MarketRegimeCode
from binquant_tpu_torch.schemas import MarketBreadthSeries


def _as_finite(value: Any) -> float | None:
    try:
        parsed = float(value)
    except (TypeError, ValueError):
        return None
    return parsed if isfinite(parsed) else None


def timestamp_sort_key(value: Any) -> float | None:
    """Epoch-seconds sort key for mixed timestamp payloads (numerics >= 1e11
    are epoch-ms; ISO strings parse with naive stamps pinned to UTC)."""
    numeric = _as_finite(value)
    if numeric is not None:
        return numeric / 1000.0 if abs(numeric) >= 1e11 else numeric
    if isinstance(value, str):
        try:
            parsed = datetime.fromisoformat(value)
        except ValueError:
            return None
        if parsed.tzinfo is None:
            parsed = parsed.replace(tzinfo=timezone.utc)
        return parsed.timestamp()
    return None


def _oldest_to_newest(
    values: list[Any], timestamps: list[Any], *, api_is_newest_first: bool
) -> list[float]:
    if len(values) >= 2 and len(timestamps) >= len(values):
        stamped = sorted(
            (
                (key, parsed)
                for ts, raw in zip(timestamps, values)
                if (key := timestamp_sort_key(ts)) is not None
                and (parsed := _as_finite(raw)) is not None
            ),
            key=lambda pair: pair[0],
        )
        if len(stamped) >= 2:
            return [parsed for _, parsed in stamped]
    cleaned = [parsed for raw in values if (parsed := _as_finite(raw)) is not None]
    return cleaned[::-1] if api_is_newest_first else cleaned


class BreadthMomentum(NamedTuple):
    source: str
    previous: float
    latest: float

    @property
    def leaning(self) -> str:
        if abs(self.latest) > abs(self.previous):
            return "toward_trend"
        if abs(self.latest) < abs(self.previous):
            return "toward_range"
        return "flat"


def read_breadth_momentum(
    breadth: MarketBreadthSeries | None,
) -> BreadthMomentum | None:
    if breadth is None or len(breadth.timestamp) < 2:
        return None
    for source in ("market_breadth_ma", "market_breadth"):
        series = _oldest_to_newest(
            getattr(breadth, source), breadth.timestamp, api_is_newest_first=True
        )
        if len(series) >= 2:
            return BreadthMomentum(source=source, previous=series[-2], latest=series[-1])
    return None


class GridOnlyPolicy(NamedTuple):
    """Immutable verdict of the grid-only decision ladder."""

    allow_grid_ladder: bool = False
    block_standard_bots: bool = False
    reason: str = "not_evaluated"
    direction: str | None = None
    source: str | None = None
    latest: float | None = None
    previous: float | None = None
    momentum_points: float | None = None

    @classmethod
    def disabled(cls, reason: str) -> "GridOnlyPolicy":
        return cls(reason=reason)

    @classmethod
    def active(
        cls, *, direction: str, source: str, latest: float, previous: float
    ) -> "GridOnlyPolicy":
        return cls(
            allow_grid_ladder=True,
            block_standard_bots=True,
            reason=f"breadth_momentum_{direction}_{source}",
            direction=direction,
            source=source,
            latest=latest,
            previous=previous,
            momentum_points=(latest - previous) * 100,
        )

    @classmethod
    def resolve(
        cls, market_regime: int | None, breadth: MarketBreadthSeries | None
    ) -> "GridOnlyPolicy":
        """Decision ladder; ``market_regime`` is the device regime code
        (None = no context, -1 = context invalid)."""
        if market_regime is None:
            return cls.disabled("market_context_unavailable")
        if market_regime < 0:
            return cls.disabled("market_regime_unavailable")
        regime = MarketRegimeCode(market_regime)
        if regime not in (MarketRegimeCode.RANGE, MarketRegimeCode.TRANSITIONAL):
            return cls.disabled(f"market_regime_{regime.name.lower()}")
        momentum = read_breadth_momentum(breadth)
        if momentum is None:
            return cls.disabled("breadth_momentum_unavailable")
        if momentum.leaning == "flat":
            return cls.disabled("breadth_momentum_flat")
        return cls.active(
            direction=momentum.leaning,
            source=momentum.source,
            latest=momentum.latest,
            previous=momentum.previous,
        )
