"""LiquidationSweepPump — 15m pump detector with breadth-fade routing.

Port of the full-tail kernel of ``binquant_tpu/strategies/liquidation_sweep_pump.py``
(:func:`lsp_core`, :func:`_routing`, :func:`_lsp_outputs`,
:func:`liquidation_sweep_pump`): pump score = rel_volume · (1+momentum) ·
OI factor / range fraction, 2-bar smoothed; trigger when max(smooth, raw)
clears the 80th percentile of the last 48 smoothed scores; optional
open-interest confirmation; direction from the breadth-fade routing.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from binquant_tpu_torch.engine.buffer import Field, MarketBuffer
from binquant_tpu_torch.enums import Direction, MicroRegimeCode
from binquant_tpu_torch.ops.rolling import (
    _quantile_of_windows,
    rolling_max,
    rolling_mean,
    rolling_min,
    shift,
)
from binquant_tpu_torch.regime.context import MarketContext
from binquant_tpu_torch.strategies.base import StrategyOutputs

ROUTE_SHORT = 0
ROUTE_LONG = 1
ROUTE_NO_CONTEXT = 2
ROUTE_STRESS = 3
ROUTE_HOT_NOT_FALLING = 4
ROUTE_BTC_NOT_STALLED = 5
ROUTE_NO_SYMBOL_FEATURES = 6
ROUTE_FOLLOWTHROUGH_NOT_WEAK = 7
ROUTE_WASHED_NOT_INCREASING = 8
ROUTE_BTC_NOT_INCREASING = 9
ROUTE_ADP_NOT_EXTREME = 10


class LSPParams(NamedTuple):
    short_adp_threshold: float = 0.3
    long_adp_threshold: float = -0.4
    btc_stalled_momentum_abs: float = 0.002
    window_hours: int = 3
    score_window: int = 48
    score_quantile: float = 0.80
    min_oi_growth: float = 1.02
    max_stress: float = 0.35


# the score series needs rel_volume score_window+1 bars back, each needing
# volume 9 bars back: 64 covers it
TAIL = 64


def _select(pairs, default):
    out = default
    for cond, value in reversed(pairs):
        out = torch.where(cond, value, out)
    return out


def _routing(context: MarketContext, adp_latest, adp_prev, btc_momentum, p: LSPParams):
    """Breadth-fade routing. Returns (routed, short_ok, route, has_context)."""
    feats = context.features
    has_context = context.valid
    stress_ok = context.market_stress_score < p.max_stress
    has_breadth_pair = torch.isfinite(adp_prev)
    falling = has_breadth_pair & (adp_latest < adp_prev)
    increasing = has_breadth_pair & (adp_latest > adp_prev)
    btc_stalled = torch.abs(btc_momentum) <= p.btc_stalled_momentum_abs

    weak_followthrough = (feats.relative_strength_vs_btc <= 0) & (
        (feats.trend_score <= 0)
        | ~feats.above_ema20
        | (feats.micro_regime != MicroRegimeCode.TREND_UP)
    )
    hot = adp_latest > p.short_adp_threshold
    washed = adp_latest <= p.long_adp_threshold

    short_ok = hot & falling & btc_stalled & feats.valid & weak_followthrough
    long_ok = washed & increasing & (btc_momentum > 0)

    S = feats.valid.shape[0]
    hot_route = _select(
        [
            (~falling, ROUTE_HOT_NOT_FALLING),
            (~btc_stalled, ROUTE_BTC_NOT_STALLED),
            (~feats.valid, ROUTE_NO_SYMBOL_FEATURES),
            (weak_followthrough, ROUTE_SHORT),
        ],
        torch.full((S,), ROUTE_FOLLOWTHROUGH_NOT_WEAK, dtype=torch.int32,
                   device=feats.valid.device),
    )
    washed_route = torch.where(
        ~increasing,
        ROUTE_WASHED_NOT_INCREASING,
        torch.where(btc_momentum > 0, ROUTE_LONG, ROUTE_BTC_NOT_INCREASING),
    )
    route = _select(
        [
            (~has_context, ROUTE_NO_CONTEXT),
            (~stress_ok, ROUTE_STRESS),
            (hot, hot_route),
            (washed, washed_route),
        ],
        torch.full((S,), ROUTE_ADP_NOT_EXTREME, dtype=torch.int32,
                   device=feats.valid.device),
    ).to(torch.int32)

    routed = has_context & stress_ok & (short_ok | long_ok)
    return routed, short_ok, route, has_context


def _oi_factor(oi_growth: torch.Tensor) -> torch.Tensor:
    return torch.where(
        torch.isfinite(oi_growth), 1.0 + torch.clamp(oi_growth - 1.0, min=0.0), 1.0
    )


def _lsp_outputs(
    filled, score_ok, trigger_score, threshold, routed, short_ok, route,
    oi_growth, adp_latest, btc_momentum, volume_last, p: LSPParams,
) -> StrategyOutputs:
    oi_ok = ~torch.isfinite(oi_growth) | (oi_growth >= p.min_oi_growth)
    fired = score_ok & oi_ok & routed & (filled > 0)
    direction = torch.where(
        short_ok, int(Direction.SHORT), int(Direction.LONG)
    ).to(torch.int32)
    S = filled.shape[0]
    finite_score = torch.where(torch.isfinite(trigger_score), trigger_score, 0.0)
    return StrategyOutputs(
        trigger=fired,
        direction=direction,
        score=finite_score,
        autotrade=fired,
        stop_loss_pct=torch.zeros((S,), dtype=torch.float32, device=filled.device),
        diagnostics={
            "trigger_score": finite_score,
            "threshold": torch.where(torch.isfinite(threshold), threshold, 0.0),
            "oi_growth": torch.where(torch.isfinite(oi_growth), oi_growth, 1.0),
            "adp": torch.broadcast_to(adp_latest, (S,)),
            "btc_momentum": torch.broadcast_to(btc_momentum, (S,)),
            "route": route,
            "volume": volume_last,
        },
    )


def lsp_core(
    buf15: MarketBuffer, oi_growth: torch.Tensor, params: LSPParams = LSPParams()
):
    """Pump-score pipeline + the 48-bar quantile trigger. Returns
    ``(score_ok, trigger_score, threshold, volume_last)``."""
    p = params
    wh = p.window_hours
    v = buf15.values[:, -TAIL:]
    volume = v[:, :, Field.VOLUME]
    close = v[:, :, Field.CLOSE]
    high = v[:, :, Field.HIGH]
    low = v[:, :, Field.LOW]

    rel_volume = volume / shift(rolling_mean(volume, wh * 2), wh)
    momentum = close / shift(close, wh) - 1.0
    range_frac = (rolling_max(high, wh * 2) - rolling_min(low, wh * 2)) / close

    oi_factor = _oi_factor(oi_growth)[:, None]
    pump_score = rel_volume * (1.0 + momentum) * oi_factor / range_frac
    smooth = rolling_mean(pump_score, 2)

    # top quintile of the last score_window smoothed scores (one window;
    # an all-NaN window gives NaN, which score_ok's cnt > 0 also rejects)
    recent = smooth[:, -p.score_window:]
    threshold = _quantile_of_windows(recent, p.score_window, p.score_quantile, 1)
    cnt = torch.isfinite(recent).sum(dim=-1)

    latest_smooth = smooth[:, -1]
    trigger_score = torch.maximum(latest_smooth, pump_score[:, -1])
    score_ok = (
        torch.isfinite(latest_smooth) & (cnt > 0) & (trigger_score >= threshold)
    )
    return score_ok, trigger_score, threshold, volume[:, -1]


def liquidation_sweep_pump(
    buf15: MarketBuffer,
    context: MarketContext,
    oi_growth: torch.Tensor,  # (S,) f32, NaN = unavailable
    adp_latest: torch.Tensor,  # scalar f32
    adp_prev: torch.Tensor,  # scalar f32, NaN = no history
    btc_momentum: torch.Tensor,  # scalar f32
    params: LSPParams = LSPParams(),
) -> StrategyOutputs:
    p = params
    score_ok, trigger_score, threshold, volume_last = lsp_core(buf15, oi_growth, p)
    routed, short_ok, route, _ = _routing(context, adp_latest, adp_prev, btc_momentum, p)
    return _lsp_outputs(
        buf15.filled, score_ok, trigger_score, threshold, routed, short_ok,
        route, oi_growth, adp_latest, btc_momentum, volume_last, p,
    )
