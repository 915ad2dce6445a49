"""Context-conditioned signal scoring, batched.

Port of ``binquant_tpu/regime/scoring.py``: the direction-conditioned
context model (breadth, BTC alignment, cross-asset confirmation, override,
supportiveness, followthrough, risk), the scorer's ``adjust_score`` and the
``score_signal_candidate`` seam. Everything broadcasts over (S,) rows; an
invalid context has confidence 0, which zeroes the scores.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from binquant_tpu_torch.regime.context import MarketContext
from binquant_tpu_torch.utils import jclamp, jnon_negative


class ContextScoreArrays(NamedTuple):
    confidence: torch.Tensor
    long_tailwind: torch.Tensor
    short_tailwind: torch.Tensor
    breadth_score: torch.Tensor
    btc_alignment_score: torch.Tensor
    cross_asset_confirmation: torch.Tensor
    market_stress_score: torch.Tensor
    followthrough_score: torch.Tensor
    adverse_excursion_risk: torch.Tensor
    override_strength: torch.Tensor
    supportiveness_score: torch.Tensor


class ScorerWeights(NamedTuple):
    context_weight: float = 1.0
    risk_weight: float = 0.5
    support_weight: float = 0.35


def evaluate_context_score(
    context: MarketContext,
    is_short: torch.Tensor,
    symbol_rs: torch.Tensor,
    symbol_trend: torch.Tensor,
) -> ContextScoreArrays:
    confidence = torch.where(context.valid, 1.0, 0.0)

    breadth = torch.where(is_short, context.short_tailwind, context.long_tailwind)
    btc_align = torch.where(
        is_short, jclamp(-context.btc_regime_score), jclamp(context.btc_regime_score)
    )
    rs_signed = torch.where(is_short, -symbol_rs, symbol_rs)
    trend_signed = torch.where(is_short, -symbol_trend, symbol_trend)
    cross_asset = jclamp(0.6 * rs_signed + 0.4 * trend_signed)
    override = jclamp(
        0.6 * jnon_negative(rs_signed) + 0.4 * jnon_negative(trend_signed), 0.0, 1.0
    )
    directional_stress = torch.where(
        is_short, context.market_stress_score * 0.35, -context.market_stress_score
    )

    supportiveness = jclamp(
        0.35 * breadth
        + 0.25 * btc_align
        + 0.25 * cross_asset
        + 0.15 * directional_stress
    )
    followthrough = jclamp(0.45 * breadth + 0.3 * btc_align + 0.25 * cross_asset)
    risk = jclamp(
        0.55 * context.market_stress_score
        + 0.25 * jnon_negative(-supportiveness)
        + 0.2 * (1.0 - override),
        0.0,
        1.0,
    )

    # relative-strength override bumps
    weak_breadth_override = (breadth < 0) & (override > 0)
    long_bump = weak_breadth_override & ~is_short
    short_bump = weak_breadth_override & is_short
    supportiveness = torch.where(
        long_bump, jclamp(supportiveness + 0.2 * override), supportiveness
    )
    followthrough = torch.where(
        long_bump, jclamp(followthrough + 0.15 * override), followthrough
    )
    supportiveness = torch.where(
        short_bump, jclamp(supportiveness + 0.1 * override), supportiveness
    )

    z = confidence
    return ContextScoreArrays(
        confidence=confidence,
        long_tailwind=context.long_tailwind * z,
        short_tailwind=context.short_tailwind * z,
        breadth_score=breadth * z,
        btc_alignment_score=btc_align * z,
        cross_asset_confirmation=cross_asset * z,
        market_stress_score=context.market_stress_score * z,
        followthrough_score=followthrough * z,
        adverse_excursion_risk=risk * z,
        override_strength=override * z,
        supportiveness_score=supportiveness * z,
    )


def adjust_score(
    local_score: torch.Tensor,
    score: ContextScoreArrays,
    weights: ScorerWeights = ScorerWeights(),
) -> torch.Tensor:
    delta = (
        score.confidence
        * weights.context_weight
        * (
            score.followthrough_score
            + weights.support_weight * score.supportiveness_score
            - weights.risk_weight * score.adverse_excursion_risk
        )
    )
    return local_score + delta


class SignalEvaluation(NamedTuple):
    local_score: torch.Tensor
    adjusted_score: torch.Tensor
    emit: torch.Tensor
    context_score: ContextScoreArrays


def score_signal_candidate(
    context: MarketContext,
    is_short: torch.Tensor,
    local_score: torch.Tensor,
    symbol_rs: torch.Tensor,
    symbol_trend: torch.Tensor,
    weights: ScorerWeights = ScorerWeights(),
    emit_threshold: float | None = None,
) -> SignalEvaluation:
    cs = evaluate_context_score(context, is_short, symbol_rs, symbol_trend)
    adjusted = adjust_score(local_score, cs, weights)
    if emit_threshold is None:
        emit = torch.ones_like(adjusted, dtype=torch.bool)
    else:
        emit = adjusted >= emit_threshold
    return SignalEvaluation(
        local_score=local_score, adjusted_score=adjusted, emit=emit, context_score=cs
    )
