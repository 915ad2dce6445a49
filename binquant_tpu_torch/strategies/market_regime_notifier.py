"""MarketRegimeNotifier: the Telegram digest on a market regime transition.

The port's own copy of ``binquant_tpu/strategies/market_regime_notifier.py``.
One market, one message per tick at most, so it stays on the host: a
structured digest on each NEW transition, deduplicated by remembering the
last transition sent. The text equals the reference's character for
character.
"""

from __future__ import annotations

import torch

from binquant_tpu_torch.enums import MarketRegimeCode, MarketTransitionCode
from binquant_tpu_torch.regime.context import MarketContext


def _regime_summary(regime: int) -> str:
    if regime == MarketRegimeCode.TREND_UP:
        return "market conditions now favor long continuation"
    if regime == MarketRegimeCode.TREND_DOWN:
        return "market conditions now favor downside continuation"
    if regime == MarketRegimeCode.HIGH_STRESS:
        return "market conditions have shifted into a stressed risk-off state"
    if regime == MarketRegimeCode.RANGE:
        return "market conditions now favor mean-reversion and range trading"
    return "market conditions are mixed, transitional, or range-bound"


_INT_SCALARS = ("market_regime", "previous_market_regime", "market_regime_transition",
                "fresh_count", "timestamp", "regime_stable_since")
_BOOL_SCALARS = ("valid", "regime_is_transitioning")
_FLOAT_SCALARS = (
    "market_regime_transition_strength", "market_stress_score", "advancers_ratio",
    "long_tailwind", "short_tailwind", "average_return", "long_regime_score",
    "short_regime_score", "range_regime_score", "stress_regime_score", "btc_regime_score",
)


def context_scalars(context: MarketContext) -> dict:
    """The digest's scalars of a device :class:`MarketContext`, in the
    shape ``unpack_wire`` decodes them. A test and debug convenience: the
    engine reads them from the wire, in one copy."""
    vals = torch.stack([
        getattr(context, k).detach().to(torch.float64).reshape(())
        for k in _INT_SCALARS + _BOOL_SCALARS + _FLOAT_SCALARS
    ]).cpu().tolist()
    out: dict = {}
    for i, k in enumerate(_INT_SCALARS):
        out[k] = int(vals[i])
    for i, k in enumerate(_BOOL_SCALARS, len(_INT_SCALARS)):
        out[k] = bool(vals[i])
    for i, k in enumerate(_FLOAT_SCALARS, len(_INT_SCALARS) + len(_BOOL_SCALARS)):
        out[k] = float(vals[i])
    return out


class MarketRegimeNotifier:
    def __init__(self, env: str = "") -> None:
        self.env = env
        self.last_transition_sent: int | None = None

    def build_message(self, ctx) -> str | None:
        """The digest for a new transition, or None when there is nothing
        to send. ``ctx`` is the scalar dict of ``unpack_wire`` (or
        :func:`context_scalars`); a :class:`MarketContext` is converted."""
        if not isinstance(ctx, dict):
            ctx = context_scalars(ctx)
        if not ctx["valid"]:
            return None
        transition = ctx["market_regime_transition"]
        previous = ctx["previous_market_regime"]
        current = ctx["market_regime"]
        if transition < 0 or previous < 0 or current < 0:
            return None
        if transition == self.last_transition_sent:
            return None
        self.last_transition_sent = transition

        def r3(v):
            return round(float(v), 3)

        prev_name = MarketRegimeCode(previous).name
        cur_name = MarketRegimeCode(current).name
        transition_name = MarketTransitionCode(transition).name
        ts = ctx["timestamp"] * 1000
        return f"""
            - [{self.env}] <strong>#market_regime_transition</strong>
            - Event: {transition_name}
            - Regime transition: {prev_name} -> {cur_name}
            - Market regime: {cur_name}
            - Market transition: {transition_name}
            - Interpretation: {_regime_summary(current)}
            - Context timestamp: {ts}
            - Confidence: 1.0
            - Transition strength: {r3(ctx["market_regime_transition_strength"])}
            - Fresh symbols: {ctx["fresh_count"]}
            - Advancers ratio: {r3(ctx["advancers_ratio"])}
            - Long regime score: {r3(ctx["long_regime_score"])}
            - Short regime score: {r3(ctx["short_regime_score"])}
            - Range regime score: {r3(ctx["range_regime_score"])}
            - Stress regime score: {r3(ctx["stress_regime_score"])}
            - Avg return: {round(float(ctx["average_return"]), 4)}
            - BTC regime score: {r3(ctx["btc_regime_score"])}
            - Long tailwind: {r3(ctx["long_tailwind"])}
            - Short tailwind: {r3(ctx["short_tailwind"])}
            - Market stress: {r3(ctx["market_stress_score"])}
        """
