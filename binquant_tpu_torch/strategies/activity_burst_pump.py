"""ActivityBurstPump — 5m volume/price-burst long entry, batched.

Port of the full-tail kernel of ``binquant_tpu/strategies/activity_burst_pump.py``
(:func:`abp_core`, :func:`_abp_outputs`, :func:`activity_burst_pump`):
shifted rolling-median volume baselines, price jump/range/body/close-to-high
quality flags, the burst score against the shifted rolling 92nd percentile
of its own history, and the 3-bar cooldown. Long-only; a valid context that
denies long autotrade suppresses the signal, a missing context emits with
autotrade off.

The 92nd-percentile threshold is the repository's one hand-written kernel:
``ops.quantile_tail.rolling_quantile_tail`` launches ``csrc/qtail.cu`` on
the card every tick.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from binquant_tpu_torch.engine.buffer import Field, MarketBuffer
from binquant_tpu_torch.ops.quantile_tail import rolling_quantile_tail
from binquant_tpu_torch.ops.rolling import rolling_median, shift
from binquant_tpu_torch.regime.context import MarketContext
from binquant_tpu_torch.regime.routing import allows_long_autotrade_mask
from binquant_tpu_torch.strategies.base import StrategyOutputs


class ABPParams(NamedTuple):
    volume_multiplier: float = 2.75
    quote_volume_multiplier: float = 2.5
    price_threshold: float = 0.01
    lookback_window: int = 20
    min_baseline_volume: float = 1e-8
    min_range_frac: float = 0.012
    min_body_frac: float = 0.45
    max_close_to_high: float = 0.35
    min_recent_up_closes: int = 2
    score_quantile: float = 0.92
    score_lookback: int = 80
    cooldown_bars: int = 3


# threshold at the cooldown positions needs scores score_lookback+cooldown
# back, each needing lookback+2 bars of baseline history: 128 covers it
TAIL = 128

ROUTE_UNAVAILABLE = 0  # "market_context_unavailable"
ROUTE_ALLOWED = 1  # "long_autotrade_allowed"


def _baseline_window(p: ABPParams) -> int:
    """Rolling window after shift(2)."""
    return max(p.lookback_window, 2) - 1


def _abp_outputs(
    filled: torch.Tensor,
    context: MarketContext,
    qualified: torch.Tensor,
    score_last: torch.Tensor,
    diag: dict[str, torch.Tensor],
    p: ABPParams,
) -> StrategyOutputs:
    """Trigger gating + output assembly (keys, order and dtypes fixed: the
    wire's emission layout is read from them)."""
    fired = qualified & (filled >= p.lookback_window + 1)
    gate = allows_long_autotrade_mask(context)
    has_context = context.valid
    fired = fired & (~has_context | gate)
    autotrade = fired & has_context & gate
    route = torch.where(has_context, ROUTE_ALLOWED, ROUTE_UNAVAILABLE)
    S = filled.shape[0]
    dev = filled.device
    return StrategyOutputs(
        trigger=fired,
        direction=torch.zeros((S,), dtype=torch.int32, device=dev),
        score=torch.where(torch.isfinite(score_last), score_last, 0.0),
        autotrade=autotrade,
        stop_loss_pct=torch.zeros((S,), dtype=torch.float32, device=dev),
        diagnostics={
            **diag,
            "route": torch.broadcast_to(route, (S,)).to(torch.int32),
        },
    )


def abp_core(
    buf5: MarketBuffer, params: ABPParams = ABPParams()
) -> tuple[torch.Tensor, torch.Tensor, dict[str, torch.Tensor]]:
    """The context-free heavy half: the full-tail windowed math up to the
    cooldown-gated ``qualified`` mask. Returns ``(qualified, score_last,
    diagnostics)``."""
    p = params
    v = buf5.values[:, -TAIL:]
    volume = v[:, :, Field.VOLUME]
    quote_volume = v[:, :, Field.QUOTE_VOLUME]
    close = v[:, :, Field.CLOSE]
    open_ = v[:, :, Field.OPEN]
    high = v[:, :, Field.HIGH]
    low = v[:, :, Field.LOW]
    minb = p.min_baseline_volume

    bw = _baseline_window(p)
    baseline = rolling_median(shift(volume, 2), bw, min_periods=bw)
    baseline_safe = torch.clamp(baseline, min=minb)
    volume_ratio = volume / baseline_safe

    # feeds without quote volume: quote confirmation is neutral
    has_qav = (quote_volume > 0).any(dim=-1, keepdim=True)
    q_baseline = rolling_median(shift(quote_volume, 2), bw, min_periods=bw)
    q_baseline_safe = torch.clamp(q_baseline, min=minb)
    quote_ratio = torch.where(has_qav, quote_volume / q_baseline_safe, 1.0)

    prev_close = torch.clamp(shift(close, 1), min=minb)
    candle_range = torch.clamp(high - low, min=minb)
    body = torch.abs(close - open_)

    price_jump = (close - shift(close, 1)) / prev_close
    range_frac = candle_range / torch.clamp(close, min=minb)
    body_frac = body / candle_range
    close_to_high = (high - close) / candle_range
    is_bullish = close > open_
    up_close = (close > shift(close, 1)).to(torch.float32)
    recent_up = up_close + shift(up_close, 1, 0.0) + shift(up_close, 2, 0.0)

    vol_spike = volume > p.volume_multiplier * baseline_safe
    quote_spike = torch.where(
        has_qav, quote_volume > p.quote_volume_multiplier * q_baseline_safe, True
    )
    jump_flag = price_jump > p.price_threshold
    range_flag = range_frac > p.min_range_frac
    body_flag = (
        is_bullish & (body_frac > p.min_body_frac) & (close_to_high < p.max_close_to_high)
    )
    trend_flag = recent_up >= torch.where(
        has_qav, float(p.min_recent_up_closes), 1.0
    )

    score = torch.where(
        has_qav,
        volume_ratio * quote_ratio * torch.clamp(price_jump, min=0.0) * (1.0 + body_frac),
        volume_ratio * torch.clamp(price_jump, min=0.0),
    )
    # the cooldown reads `raw` at the trailing cooldown_bars+1 positions
    # only, so the threshold is computed for just those windows — by the
    # hand-written kernel on the card
    n_out = p.cooldown_bars + 1
    threshold_tail = rolling_quantile_tail(
        shift(score, 1).contiguous(), p.score_lookback, p.score_quantile,
        num_out=n_out, min_periods=p.lookback_window,
    )
    threshold_filled = torch.where(
        torch.isfinite(threshold_tail), threshold_tail, 0.0
    )

    def tail_n(a):
        return a[:, -n_out:]

    raw = (
        tail_n(vol_spike)
        & tail_n(quote_spike)
        & tail_n(jump_flag)
        & tail_n(range_flag)
        & tail_n(body_flag)
        & tail_n(trend_flag)
        & torch.isfinite(tail_n(score))
        & (tail_n(score) >= threshold_filled)
    )
    qualified = raw[:, -1] & ~raw[:, :-1].any(dim=-1)
    return (
        qualified,
        score[:, -1],
        {
            "baseline_volume": baseline_safe[:, -1],
            "volume_ratio": volume_ratio[:, -1],
            "quote_volume_ratio": quote_ratio[:, -1],
            "price_jump": price_jump[:, -1],
            "range_frac": range_frac[:, -1],
            "body_frac": body_frac[:, -1],
            "score_threshold": threshold_filled[:, -1],
            "volume": volume[:, -1],
        },
    )


def activity_burst_pump(
    buf5: MarketBuffer,
    context: MarketContext,
    params: ABPParams = ABPParams(),
) -> StrategyOutputs:
    qualified, score_last, diag = abp_core(buf5, params)
    return _abp_outputs(buf5.filled, context, qualified, score_last, diag, params)
