"""LadderDeployer — grid-ladder deployment in stable ranges, batched.

Port of ``binquant_tpu/strategies/ladder_deployer.py``: futures-only grid
deployment behind the grid-only policy, micro regime RANGE/TRANSITIONAL
without a blocking transition, long_regime_score >= 0.2, BB width stable
over 8 candles, price inside a 1.5–8% wide band, and an ATR-derived
breakout buffer clamped to 0.5–4%.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from binquant_tpu_torch.enums import MicroRegimeCode, MicroTransitionCode
from binquant_tpu_torch.regime.context import MarketContext
from binquant_tpu_torch.strategies.base import StrategyOutputs, no_signal
from binquant_tpu_torch.strategies.features import BB_WIDTH_HISTORY, FeaturePack


class LadderParams(NamedTuple):
    enabled: bool = True
    autotrade: bool = True
    min_range_width_pct: float = 1.5
    max_range_width_pct: float = 8.0
    min_breakout_buffer_pct: float = 0.5
    max_breakout_buffer_pct: float = 4.0
    breakout_atr_multiplier: float = 1.5
    min_long_regime_score: float = 0.2
    max_bb_width_change_pct: float = 20.0


def ladder_deployer(
    pack15: FeaturePack,
    context: MarketContext,
    grid_policy_allows: torch.Tensor,  # scalar bool
    is_futures: torch.Tensor,  # scalar bool
    params: LadderParams = LadderParams(),
) -> StrategyOutputs:
    p = params
    f = pack15
    S = f.close.shape[0]
    if not p.enabled:
        return no_signal(S, device=f.close.device)

    feats = context.features
    micro = feats.micro_regime
    micro_ok = feats.valid & (
        (micro == MicroRegimeCode.RANGE) | (micro == MicroRegimeCode.TRANSITIONAL)
    )
    trans = feats.micro_transition
    transition_ok = (
        (trans != MicroTransitionCode.BREAKDOWN)
        & (trans != MicroTransitionCode.VOLATILITY_EXPANSION)
        & (trans != MicroTransitionCode.ENTERED_TREND_DOWN)
    )
    breadth_ok = context.long_regime_score >= p.min_long_regime_score

    widths = f.bb_widths  # (S, 8)
    widths_ok = (torch.isfinite(widths) & (widths > 0)).all(dim=-1) & (
        f.filled >= 20 + BB_WIDTH_HISTORY - 1
    )
    w_first = widths[:, 0]
    w_last = widths[:, -1]
    change_pct = torch.abs(
        (w_last - w_first) / torch.where(w_first != 0, w_first, torch.ones_like(w_first))
    ) * 100.0
    bb_stable = widths_ok & (change_pct <= p.max_bb_width_change_pct)

    range_low = f.bb_lower
    range_high = f.bb_upper
    price = f.close
    in_range = (range_low < price) & (price < range_high)
    range_width_pct = torch.where(
        f.bb_mid > 0, (range_high - range_low) / f.bb_mid * 100.0, 0.0
    )
    width_ok = (range_width_pct >= p.min_range_width_pct) & (
        range_width_pct <= p.max_range_width_pct
    )
    atr_pct = torch.where(price > 0, f.atr / price, 0.0)
    raw_buffer = atr_pct * 100.0 * p.breakout_atr_multiplier
    buffer_pct = torch.clamp(
        raw_buffer, p.min_breakout_buffer_pct, p.max_breakout_buffer_pct
    )

    fired = (
        is_futures
        & grid_policy_allows
        & context.valid
        & micro_ok
        & transition_ok
        & breadth_ok
        & bb_stable
        & in_range
        & width_ok
        & f.valid
    )
    return StrategyOutputs(
        trigger=fired,
        direction=torch.zeros((S,), dtype=torch.int32, device=f.close.device),
        score=torch.zeros((S,), dtype=torch.float32, device=f.close.device),
        autotrade=fired & p.autotrade,
        stop_loss_pct=torch.zeros((S,), dtype=torch.float32, device=f.close.device),
        diagnostics={
            "range_low": range_low,
            "range_high": range_high,
            "breakout_low": range_low * (1.0 - buffer_pct / 100.0),
            "breakout_high": range_high * (1.0 + buffer_pct / 100.0),
            "range_width_pct": range_width_pct,
            "atr_buffer_pct": buffer_pct,
            "bb_width_change_pct": change_pct,
        },
    )
