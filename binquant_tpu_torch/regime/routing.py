"""Autotrade regime routing as masks over the whole symbol batch.

Port of ``binquant_tpu/regime/routing.py``: long autotrade is blocked on
transitioning, unstable or hostile regimes. :func:`allows_long_autotrade_mask`
decides it for every row at once on the device; the host-side
:func:`long_autotrade_decision` gives the same decision for one row with its
reason string.
"""

from __future__ import annotations

import numpy as np
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


_MARKET_REGIME_NAMES = {c.value: c.name for c in MarketRegimeCode}
_MICRO_REGIME_NAMES = {c.value: c.name for c in MicroRegimeCode}


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def long_autotrade_decision(
    context: MarketContext, row: int, min_age_s: int = DEFAULT_REGIME_STABILITY_S
) -> tuple[bool, str]:
    """(allowed, reason) for one symbol row of a context (its leaves on any
    device, or numpy): the mask's decision, with the reason the emission
    path annotates a blocked signal with."""
    c = context
    if not bool(_host(c.valid)):
        return False, "market_context_unavailable"
    if bool(_host(c.regime_is_transitioning)):
        return False, "regime_transitioning"
    anchor = int(_host(c.regime_stable_since))
    if anchor < 0:
        return False, "regime_stability_unknown"
    age = max(int(_host(c.timestamp)) - anchor, 0)
    if age < min_age_s:
        return False, f"regime_unstable_{age}s"
    name = _MARKET_REGIME_NAMES.get(int(_host(c.market_regime)), "UNKNOWN")
    if name in {"HIGH_STRESS", "TREND_DOWN", "TRANSITIONAL"}:
        return False, f"market_regime_{name.lower()}"
    if float(_host(c.market_stress_score)) >= 0.35:
        return False, "market_stress_elevated"
    if name not in {"TREND_UP", "RANGE"}:
        return False, f"market_regime_{name.lower()}"
    f = c.features
    micro = int(_host(f.micro_regime)[row])
    if not bool(_host(f.valid)[row]) or micro < 0:
        return True, f"market_regime_{name.lower()}_no_symbol_features"
    micro_name = _MICRO_REGIME_NAMES.get(micro, "UNKNOWN")
    if micro == MicroRegimeCode.TREND_DOWN:
        if int(_host(f.micro_transition)[row]) == MicroTransitionCode.RECOVERY:
            return True, "micro_trend_down_recovery"
        return False, "micro_regime_trend_down"
    if micro == MicroRegimeCode.VOLATILE:
        return False, "micro_regime_volatile"
    if micro in {MicroRegimeCode.TREND_UP, MicroRegimeCode.RANGE, MicroRegimeCode.TRANSITIONAL}:
        return True, f"micro_regime_{micro_name.lower()}"
    return False, f"micro_regime_{micro_name.lower()}"
