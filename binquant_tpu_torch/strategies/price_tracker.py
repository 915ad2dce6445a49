"""Coinrule PriceTracker — 5m oversold mean-reversion long, batched.

Port of ``binquant_tpu/strategies/price_tracker.py``: entry RSI(14)<30 ∧
MACD<0 ∧ MFI<20, a local score from oversold depth, the context-adjusted
score with the strategy's scorer weights and telemetry gates, its RANGE-only
regime routing, a 12-bar entry cooldown on close_time carried as a device
tensor, and quiet-hours autotrade suppression.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from binquant_tpu_torch.enums import MarketRegimeCode, MicroRegimeCode, MicroTransitionCode
from binquant_tpu_torch.regime.context import MarketContext
from binquant_tpu_torch.regime.scoring import ScorerWeights, score_signal_candidate
from binquant_tpu_torch.strategies.base import StrategyOutputs
from binquant_tpu_torch.strategies.features import FeaturePack
from binquant_tpu_torch.utils import jsafe_div

ROUTE_SYMBOL_RANGE = 0
ROUTE_NO_CONTEXT = 1
ROUTE_TRANSITIONING = 2
ROUTE_STRESS = 3
ROUTE_BREADTH_UNSTABLE = 4
ROUTE_NOT_RANGE = 5
ROUTE_NO_SYMBOL_FEATURES = 6
ROUTE_SYMBOL_TRANSITION = 7
ROUTE_RS_INSUFFICIENT = 8
ROUTE_SYMBOL_REGIME = 9
ROUTE_QUIET_HOURS = 10


class PTParams(NamedTuple):
    entry_cooldown_bars: int = 12
    min_rs_vs_btc: float = 0.005
    stress_threshold: float = 0.3
    rsi_oversold: float = 30.0
    mfi_oversold: float = 20.0
    macd_entry_max: float = 0.0
    weights: ScorerWeights = ScorerWeights(
        context_weight=0.35, risk_weight=0.35, support_weight=0.2
    )


def _has_stable_breadth(context: MarketContext) -> torch.Tensor:
    """Breadth balanced 0.48–0.62 and tailwind gap <= 0.35."""
    balanced = (context.advancers_ratio >= 0.48) & (context.advancers_ratio <= 0.62)
    tailwinds = torch.abs(context.long_tailwind - context.short_tailwind) <= 0.35
    return balanced & tailwinds


def price_tracker(
    pack5: FeaturePack,
    context: MarketContext,
    quiet_hours_suppressed: torch.Tensor,  # scalar bool
    last_signal_close_time: torch.Tensor,  # (S,) int32 carry, -1 = never
    interval_s: int = 300,
    params: PTParams = PTParams(),
) -> tuple[StrategyOutputs, torch.Tensor]:
    p = params
    f = pack5
    S = f.close.shape[0]
    dev = f.close.device

    enough = (
        (f.filled >= 30)
        & torch.isfinite(f.rsi)
        & torch.isfinite(f.macd)
        & torch.isfinite(f.mfi)
    )
    entry = (f.rsi < p.rsi_oversold) & (f.macd < p.macd_entry_max) & (f.mfi < p.mfi_oversold)

    local_score = (
        1.0
        + torch.clamp((p.rsi_oversold - f.rsi) / p.rsi_oversold, min=0.0) * 0.35
        + torch.clamp((p.mfi_oversold - f.mfi) / p.mfi_oversold, min=0.0) * 0.35
        + torch.clamp(torch.abs(f.macd) * 100.0, max=1.0) * 0.3
    )
    trend_score = torch.where(
        f.ema21 != 0, jsafe_div(f.ema9 - f.ema21, torch.abs(f.ema21)), 0.0
    )

    feats = context.features
    evaluation = score_signal_candidate(
        context,
        is_short=torch.zeros((), dtype=torch.bool, device=dev),
        local_score=local_score,
        symbol_rs=feats.relative_strength_vs_btc,
        symbol_trend=trend_score,
        weights=p.weights,
        emit_threshold=1.0,
    )
    cs = evaluation.context_score
    has_context = context.valid
    telemetry_ok = (
        (cs.followthrough_score >= -0.2)
        & (cs.adverse_excursion_risk <= 0.6)
        & (cs.confidence >= 0.5)
    )

    stable_breadth = _has_stable_breadth(context)
    micro = feats.micro_regime
    trans = feats.micro_transition
    bad_transition = (trans == MicroTransitionCode.BREAKDOWN) | (
        trans == MicroTransitionCode.VOLATILITY_EXPANSION
    )
    rs_ok = feats.relative_strength_vs_btc > p.min_rs_vs_btc

    route = torch.full((S,), ROUTE_SYMBOL_RANGE, dtype=torch.int32, device=dev)

    def set_route(route, cond, code):
        return torch.where((route == ROUTE_SYMBOL_RANGE) & cond, code, route)

    route = torch.where(~has_context, ROUTE_NO_CONTEXT, route)
    route = set_route(route, context.regime_is_transitioning, ROUTE_TRANSITIONING)
    route = set_route(route, context.market_stress_score >= p.stress_threshold, ROUTE_STRESS)
    route = set_route(route, ~stable_breadth, ROUTE_BREADTH_UNSTABLE)
    route = set_route(route, context.market_regime != MarketRegimeCode.RANGE, ROUTE_NOT_RANGE)
    route = set_route(route, ~feats.valid | (micro < 0), ROUTE_NO_SYMBOL_FEATURES)
    route = set_route(route, bad_transition, ROUTE_SYMBOL_TRANSITION)
    route = set_route(route, ~rs_ok, ROUTE_RS_INSUFFICIENT)
    route = set_route(route, micro != MicroRegimeCode.RANGE, ROUTE_SYMBOL_REGIME)
    autotrade = route == ROUTE_SYMBOL_RANGE

    elapsed = f.close_time - last_signal_close_time
    cooldown_active = (
        (last_signal_close_time >= 0)
        & (elapsed >= 0)
        & (elapsed < p.entry_cooldown_bars * interval_s)
    )
    fired = entry & enough & has_context & telemetry_ok & ~cooldown_active & f.valid

    suppressed = autotrade & quiet_hours_suppressed
    autotrade = autotrade & ~quiet_hours_suppressed
    route = torch.where(fired & suppressed, ROUTE_QUIET_HOURS, route)

    new_carry = torch.where(fired, f.close_time, last_signal_close_time).to(torch.int32)
    outputs = StrategyOutputs(
        trigger=fired,
        direction=torch.zeros((S,), dtype=torch.int32, device=dev),
        score=torch.where(fired, local_score, 0.0),
        autotrade=fired & autotrade,
        stop_loss_pct=torch.zeros((S,), dtype=torch.float32, device=dev),
        diagnostics={
            "rsi": f.rsi,
            "macd": f.macd,
            "mfi": f.mfi,
            "adjusted_score": evaluation.adjusted_score,
            "confidence": cs.confidence,
            "followthrough": cs.followthrough_score,
            "risk": cs.adverse_excursion_risk,
            "breadth_stable": stable_breadth,
            "relative_strength_vs_btc": feats.relative_strength_vs_btc,
            "route": route,
            "quiet_hours_suppressed": suppressed,
        },
    )
    return outputs, new_carry
