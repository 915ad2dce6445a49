"""LiquidationSweepPump — 15m pump detector with breadth-fade routing.

Port of the full-tail kernel of ``binquant_tpu/strategies/liquidation_sweep_pump.py``
(:func:`lsp_core`, :func:`_routing`, :func:`_lsp_outputs`,
:func:`liquidation_sweep_pump`): pump score = rel_volume · (1+momentum) ·
OI factor / range fraction, 2-bar smoothed; trigger when max(smooth, raw)
clears the 80th percentile of the last 48 smoothed scores; optional
open-interest confirmation; direction from the breadth-fade routing.

The incremental tick reads it from :class:`LSPCarry` instead: the 48-bar
sorted window of the UNSCALED smoothed score (the OI factor is a positive
per-row scalar on the whole series, so the quantile scales with it and the
factor is applied at readout), fed by ~20 column reads per bar
(:func:`_lsp_new_bar`).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from binquant_tpu_torch.engine.buffer import Field, MarketBuffer
from binquant_tpu_torch.enums import Direction, MicroRegimeCode
from binquant_tpu_torch.ops.incremental import (
    SortedCarry,
    sorted_advance,
    sorted_init,
    sorted_quantile,
    tree_where,
)
from binquant_tpu_torch.ops.rolling import (
    _quantile_of_windows,
    fixed_order_sum,
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

# the deepest column the one-bar advance reads: the shifted volume mean's
# oldest sample at -(3*window_hours)
LSP_MIN_WINDOW = 3 * LSPParams().window_hours + 1
# the init keeps score_window trailing smoothed scores
LSP_INIT_MIN_WINDOW = LSPParams().score_window


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


# ---------------------------------------------------------------------------
# Incremental carry: the same kernel from column reads + one sorted merge
# ---------------------------------------------------------------------------


class LSPCarry(NamedTuple):
    """Carried LiquidationSweepPump state; every score UNSCALED (no OI
    factor). ``smooth_ring`` is the sorted window's eviction source (its
    newest entry is this bar's smooth score); ``prev_raw`` is the previous
    bar's raw score, for the 2-bar smoother."""

    score_q: SortedCarry  # (S, score_window)
    smooth_ring: torch.Tensor  # (S, score_window) f32, oldest first
    prev_raw: torch.Tensor  # (S,) f32


def empty_lsp_carry(
    num_symbols: int, p: LSPParams = LSPParams(), *, device: torch.device | str
) -> LSPCarry:
    S = num_symbols
    return LSPCarry(
        score_q=SortedCarry(
            sorted=torch.full(
                (S, p.score_window), float("inf"), dtype=torch.float32, device=device
            ),
            cnt=torch.zeros((S,), dtype=torch.int32, device=device),
        ),
        smooth_ring=torch.full(
            (S, p.score_window), float("nan"), dtype=torch.float32, device=device
        ),
        prev_raw=torch.full((S,), float("nan"), dtype=torch.float32, device=device),
    )


def lsp_init_from_window(buf15: MarketBuffer, p: LSPParams = LSPParams()) -> LSPCarry:
    """Carry from the full tail: the kernel's series with the OI factor
    pinned to 1.0."""
    wh = p.window_hours
    assert buf15.window >= p.score_window, (
        f"window {buf15.window} too short for the LSP carry init "
        f"(need >= {p.score_window})"
    )
    v = buf15.values[:, -TAIL:]
    volume = v[:, :, Field.VOLUME]
    close = v[:, :, Field.CLOSE]
    high = v[:, :, Field.HIGH]
    low = v[:, :, Field.LOW]

    rel_volume = volume / shift(rolling_mean(volume, wh * 2), wh)
    momentum = close / shift(close, wh) - 1.0
    range_frac = (rolling_max(high, wh * 2) - rolling_min(low, wh * 2)) / close
    pump_u = rel_volume * (1.0 + momentum) / range_frac
    smooth_u = rolling_mean(pump_u, 2)
    return LSPCarry(
        score_q=sorted_init(smooth_u, p.score_window),
        smooth_ring=smooth_u[:, -p.score_window:].to(torch.float32),
        prev_raw=pump_u[:, -1].to(torch.float32),
    )


def _lsp_new_bar(
    buf15: MarketBuffer, prev_raw: torch.Tensor, p: LSPParams
) -> tuple[torch.Tensor, torch.Tensor]:
    """(pump_u, smooth_u) at the newest bar from ~20 column reads: the full
    kernel's formulas with the rolling primitives' NaN-aware min_periods
    semantics reproduced on stacked columns."""
    wh = p.window_hours
    v = buf15.values

    def col(pos, f):
        return v[:, pos, int(f)]

    # shift(rolling_mean(volume, 2*wh), wh) at the last position: the mean
    # of the 2*wh bars ending wh+1 back, all finite
    vols = torch.stack([col(-(wh + 1) - k, Field.VOLUME) for k in range(2 * wh)], dim=-1)
    vm = torch.isfinite(vols)
    v_ok = vm.sum(dim=-1) >= 2 * wh
    v_mean = torch.where(
        v_ok, fixed_order_sum(torch.where(vm, vols, 0.0)) / (2.0 * wh), float("nan")
    )
    rel_u = col(-1, Field.VOLUME) / v_mean
    momentum = col(-1, Field.CLOSE) / col(-(wh + 1), Field.CLOSE) - 1.0

    highs = torch.stack([col(-1 - k, Field.HIGH) for k in range(2 * wh)], dim=-1)
    lows = torch.stack([col(-1 - k, Field.LOW) for k in range(2 * wh)], dim=-1)
    hm, lm = torch.isfinite(highs), torch.isfinite(lows)
    h_max = torch.where(
        hm.sum(dim=-1) >= 2 * wh,
        torch.where(hm, highs, float("-inf")).amax(dim=-1),
        float("nan"),
    )
    l_min = torch.where(
        lm.sum(dim=-1) >= 2 * wh,
        torch.where(lm, lows, float("inf")).amin(dim=-1),
        float("nan"),
    )
    range_frac = (h_max - l_min) / col(-1, Field.CLOSE)

    pump_u = rel_u * (1.0 + momentum) / range_frac
    both = torch.isfinite(pump_u) & torch.isfinite(prev_raw)
    smooth_u = torch.where(both, (pump_u + prev_raw) / 2.0, float("nan"))
    return pump_u.to(torch.float32), smooth_u.to(torch.float32)


def lsp_advance_one_bar(
    buf15: MarketBuffer,
    carry: LSPCarry,
    advanced: torch.Tensor,
    p: LSPParams = LSPParams(),
) -> LSPCarry:
    """Advance the carry by the buffer's newest bar on ``advanced`` rows."""
    assert buf15.window >= 3 * p.window_hours + 1, (
        f"window {buf15.window} too short for the LSP carry advance "
        f"(deepest read -(3*window_hours) with the shifted mean's +1)"
    )
    pump_u, smooth_u = _lsp_new_bar(buf15, carry.prev_raw, p)
    new = LSPCarry(
        score_q=sorted_advance(carry.score_q, smooth_u, carry.smooth_ring[:, 0]),
        smooth_ring=torch.cat([carry.smooth_ring[:, 1:], smooth_u[:, None]], dim=1),
        prev_raw=pump_u,
    )
    return tree_where(advanced, new, carry)


def liquidation_sweep_pump_from_carry(
    buf15: MarketBuffer,
    carry: LSPCarry,
    context: MarketContext,
    oi_growth: torch.Tensor,
    adp_latest: torch.Tensor,
    adp_prev: torch.Tensor,
    btc_momentum: torch.Tensor,
    stale: torch.Tensor,
    params: LSPParams = LSPParams(),
) -> StrategyOutputs:
    """The incremental twin of :func:`liquidation_sweep_pump`: the latest
    raw/smooth scores from the carry, the threshold from one sorted-window
    quantile, the OI factor applied at readout. STALE rows cannot fire."""
    p = params
    oi = _oi_factor(oi_growth)
    latest_raw = carry.prev_raw * oi
    latest_smooth = carry.smooth_ring[:, -1] * oi
    threshold = sorted_quantile(carry.score_q, p.score_quantile, min_periods=1) * oi
    trigger_score = torch.maximum(latest_smooth, latest_raw)
    score_ok = (
        torch.isfinite(latest_smooth)
        & (carry.score_q.cnt > 0)
        & (trigger_score >= threshold)
        & ~stale
    )
    routed, short_ok, route, _ = _routing(context, adp_latest, adp_prev, btc_momentum, p)
    return _lsp_outputs(
        buf15.filled, score_ok, trigger_score, threshold, routed, short_ok,
        route, oi_growth, adp_latest, btc_momentum,
        buf15.values[:, -1, Field.VOLUME], p,
    )
