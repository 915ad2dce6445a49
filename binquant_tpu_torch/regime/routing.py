"""Autotrade regime routing as masks over the whole symbol batch.

Port of ``allows_long_autotrade_mask`` (``binquant_tpu/regime/routing.py``):
long autotrade is blocked on transitioning, unstable or hostile regimes.
"""

from __future__ import annotations

import torch

from binquant_tpu_torch.enums import MarketRegimeCode, MicroRegimeCode, MicroTransitionCode
from binquant_tpu_torch.regime.context import MarketContext

# 30 min minimum regime age, in seconds
DEFAULT_REGIME_STABILITY_S = 30 * 60


def regime_age_s(context: MarketContext) -> torch.Tensor:
    """Seconds the current market regime has held (>= 0); -1 without an
    anchor."""
    has_anchor = context.regime_stable_since >= 0
    age = torch.clamp(context.timestamp - context.regime_stable_since, min=0)
    return torch.where(has_anchor, age, -1)


def is_regime_stable(
    context: MarketContext, min_age_s: int = DEFAULT_REGIME_STABILITY_S
) -> torch.Tensor:
    age = regime_age_s(context)
    return (
        context.valid
        & ~context.regime_is_transitioning
        & (age >= 0)
        & (age >= min_age_s)
    )


def allows_long_autotrade_mask(
    context: MarketContext, min_age_s: int = DEFAULT_REGIME_STABILITY_S
) -> torch.Tensor:
    """(S,) bool — ``allows_long_autotrade(context, symbol)`` for every row.
    Rows without valid features fall back to the symbol-less policy
    (market regime in {TREND_UP, RANGE})."""
    R, M = MarketRegimeCode, MicroRegimeCode
    market_regime_ok = (context.market_regime == R.TREND_UP) | (
        context.market_regime == R.RANGE
    )
    market_ok = (
        is_regime_stable(context, min_age_s)
        & market_regime_ok
        & (context.market_stress_score < 0.35)
    )
    f = context.features
    micro = f.micro_regime
    micro_allows = torch.where(
        micro == M.TREND_DOWN,
        f.micro_transition == MicroTransitionCode.RECOVERY,
        torch.where(
            micro == M.VOLATILE,
            False,
            (micro == M.TREND_UP) | (micro == M.RANGE) | (micro == M.TRANSITIONAL),
        ),
    )
    per_symbol = torch.where(f.valid & (micro >= 0), micro_allows, market_regime_ok)
    return market_ok & per_symbol
