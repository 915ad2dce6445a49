"""Batched market-context construction + regime annotation.

Port of ``binquant_tpu/regime/context.py``: per-symbol features (EMA20/50,
ATR-14, BB-20 width, trend score, last-bar return) from the window or, on
the incremental tick, from the carried 15m feature state (and, for the
backtest's extension-invariant chunk, T ticks of them from one pass over an
extended series, :func:`compute_symbol_features_ext`),
coverage gates, the RS-vs-BTC rewrite, masked market aggregates, the derived
scores, and the macro/micro regime ladders with transitions against a
carried previous state (:class:`RegimeCarry`). Scalars are 0-d tensors on
the buffer's device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from binquant_tpu_torch.engine.buffer import Field, MarketBuffer
from binquant_tpu_torch.enums import (
    MarketRegimeCode,
    MarketTransitionCode,
    MicroRegimeCode,
    MicroTransitionCode,
)
from binquant_tpu_torch.ops.indicators import true_range
from binquant_tpu_torch.ops.rolling import (
    ewm_mean_last,
    rolling_mean_last,
    rolling_std_last,
)
from binquant_tpu_torch.utils import jclamp, jnon_negative, jsafe_div, jsafe_pct

REQUIRED_FRESH_SYMBOLS = 40
MIN_COVERAGE_RATIO = 0.70
TRANSITION_STRENGTH_FLOOR = 0.08

I32 = torch.int32
F32 = torch.float32


class ContextConfig(NamedTuple):
    """Gate thresholds (overridable for small-universe tests)."""

    required_fresh_symbols: int = REQUIRED_FRESH_SYMBOLS
    min_coverage_ratio: float = MIN_COVERAGE_RATIO


class SymbolFeatureArrays(NamedTuple):
    """Per-symbol feature batch, (S,) each. ``valid`` gates everything."""

    valid: torch.Tensor  # bool — fresh & >=2 bars
    timestamp: torch.Tensor  # int32 seconds of latest bar
    close: torch.Tensor
    return_pct: torch.Tensor
    ema20: torch.Tensor
    ema50: torch.Tensor
    above_ema20: torch.Tensor  # bool
    above_ema50: torch.Tensor  # bool
    trend_score: torch.Tensor
    relative_strength_vs_btc: torch.Tensor
    atr_pct: torch.Tensor
    bb_width: torch.Tensor
    micro_regime: torch.Tensor  # int32, -1 where invalid
    micro_regime_strength: torch.Tensor
    micro_transition: torch.Tensor  # int32, -1 none
    micro_transition_strength: torch.Tensor


class RegimeCarry(NamedTuple):
    """Cross-tick regime state: the *previous* slots hold the last context
    from a strictly older timestamp, the *stage* slots the latest evaluation
    of the current one (promoted when a newer timestamp arrives)."""

    has_prev: torch.Tensor  # bool scalar
    market_regime: torch.Tensor  # int32 scalar
    market_scores: torch.Tensor  # (4,) long/short/range/stress
    stable_since: torch.Tensor  # int32 seconds
    micro_has_prev: torch.Tensor  # (S,) bool
    micro_regime: torch.Tensor  # (S,) int32
    micro_strength: torch.Tensor  # (S,)
    stage_ts: torch.Tensor  # int32 scalar, -1 = empty
    stage_valid: torch.Tensor  # bool scalar
    stage_regime: torch.Tensor  # int32 scalar
    stage_scores: torch.Tensor  # (4,)
    stage_stable_since: torch.Tensor  # int32
    stage_micro_valid: torch.Tensor  # (S,) bool
    stage_micro_regime: torch.Tensor  # (S,) int32
    stage_micro_strength: torch.Tensor  # (S,)


class MarketContext(NamedTuple):
    """Device-side live market context: scalars + per-symbol features."""

    valid: torch.Tensor
    timestamp: torch.Tensor
    fresh_count: torch.Tensor
    total_tracked_symbols: torch.Tensor
    coverage_ratio: torch.Tensor
    btc_present: torch.Tensor
    advancers: torch.Tensor
    decliners: torch.Tensor
    advancers_ratio: torch.Tensor
    decliners_ratio: torch.Tensor
    advancers_decliners_ratio: torch.Tensor
    average_return: torch.Tensor
    average_relative_strength_vs_btc: torch.Tensor
    pct_above_ema20: torch.Tensor
    pct_above_ema50: torch.Tensor
    average_trend_score: torch.Tensor
    average_atr_pct: torch.Tensor
    average_bb_width: torch.Tensor
    btc_return: torch.Tensor
    btc_trend_score: torch.Tensor
    btc_regime_score: torch.Tensor
    market_stress_score: torch.Tensor
    long_tailwind: torch.Tensor
    short_tailwind: torch.Tensor
    market_regime: torch.Tensor
    previous_market_regime: torch.Tensor
    market_regime_transition: torch.Tensor
    market_regime_transition_strength: torch.Tensor
    long_regime_score: torch.Tensor
    short_regime_score: torch.Tensor
    range_regime_score: torch.Tensor
    stress_regime_score: torch.Tensor
    regime_is_transitioning: torch.Tensor
    regime_stable_since: torch.Tensor
    features: SymbolFeatureArrays


def initial_regime_carry(
    num_symbols: int, *, device: torch.device | str
) -> RegimeCarry:
    def scalar(v, dtype):
        return torch.tensor(v, dtype=dtype, device=device)

    def vec(v, dtype):
        return torch.full((num_symbols,), v, dtype=dtype, device=device)

    return RegimeCarry(
        has_prev=scalar(False, torch.bool),
        market_regime=scalar(-1, I32),
        market_scores=torch.zeros((4,), dtype=F32, device=device),
        stable_since=scalar(-1, I32),
        micro_has_prev=vec(False, torch.bool),
        micro_regime=vec(-1, I32),
        micro_strength=vec(0.0, F32),
        stage_ts=scalar(-1, I32),
        stage_valid=scalar(False, torch.bool),
        stage_regime=scalar(-1, I32),
        stage_scores=torch.zeros((4,), dtype=F32, device=device),
        stage_stable_since=scalar(-1, I32),
        stage_micro_valid=vec(False, torch.bool),
        stage_micro_regime=vec(-1, I32),
        stage_micro_strength=vec(0.0, F32),
    )


# ---------------------------------------------------------------------------
# Per-symbol features
# ---------------------------------------------------------------------------


def _assemble_symbol_feature_values(
    latest_close, prev_close, times_last, filled, eligible, ema20, ema50, atr, mid, std
) -> SymbolFeatureArrays:
    bb_upper = mid + 2.0 * std
    bb_lower = mid - 2.0 * std
    atr_pct = torch.where(latest_close != 0, jsafe_div(atr, latest_close), 0.0)
    bb_width = torch.where(mid != 0, jsafe_div(bb_upper - bb_lower, torch.abs(mid)), 0.0)
    trend_score = torch.where(
        ema50 != 0, jsafe_div(ema20 - ema50, torch.abs(ema50)), 0.0
    )
    return SymbolFeatureArrays(
        valid=eligible & (filled >= 2),
        timestamp=times_last,
        close=latest_close,
        return_pct=jsafe_pct(latest_close, prev_close),
        ema20=ema20,
        ema50=ema50,
        above_ema20=latest_close > ema20,
        above_ema50=latest_close > ema50,
        trend_score=trend_score,
        relative_strength_vs_btc=torch.zeros_like(latest_close),
        atr_pct=atr_pct,
        bb_width=bb_width,
        micro_regime=torch.full(latest_close.shape, -1, dtype=I32, device=latest_close.device),
        micro_regime_strength=torch.zeros_like(latest_close),
        micro_transition=torch.full(latest_close.shape, -1, dtype=I32, device=latest_close.device),
        micro_transition_strength=torch.zeros_like(latest_close),
    )


def compute_symbol_features(
    buf: MarketBuffer, eligible: torch.Tensor
) -> SymbolFeatureArrays:
    """Per-symbol features over every buffer row; ``eligible`` is the fresh
    (& tracked) mask, and a row is valid with at least 2 bars."""
    close = buf.values[:, :, Field.CLOSE]
    high = buf.values[:, :, Field.HIGH]
    low = buf.values[:, :, Field.LOW]
    ema20 = ewm_mean_last(close, span=20, min_periods=1)
    ema50 = ewm_mean_last(close, span=50, min_periods=1)
    tr_tail = true_range(high[:, -15:], low[:, -15:], close[:, -15:])
    atr = rolling_mean_last(tr_tail, 14, min_periods=1)
    mid = rolling_mean_last(close, 20, min_periods=1)
    std = rolling_std_last(close, 20, min_periods=1, ddof=0)
    std = torch.where(torch.isfinite(std), std, 0.0)
    return _assemble_symbol_feature_values(
        close[:, -1], close[:, -2], buf.times[:, -1], buf.filled,
        eligible, ema20, ema50, atr, mid, std,
    )


def compute_symbol_features_ext(
    ext_times: torch.Tensor,  # (S, L) int32
    ext_vals: torch.Tensor,  # (S, L, F)
    counts: torch.Tensor,  # (T, S)
    filled0: torch.Tensor,  # (S,)
    window: int,
    eligible: torch.Tensor,  # (T, S) fresh & tracked per tick
) -> SymbolFeatureArrays:
    """T ticks of :func:`compute_symbol_features` from ONE pass over the
    backtest's (S, L = W + N) extended buffers (leaves (T, S)-leading).
    The contract of ``compute_feature_pack_ext``: the assembly is
    elementwise-identical, the indicator readouts anchor at the series
    start (float32 ulps for the rolling moments, ``(1-alpha)^W`` for the
    EMAs). The view path's 15-bar TR tail drops its first element from the
    trailing-14 mean, so the consumed TR positions match the full series'."""
    from binquant_tpu_torch.ops.rolling import ewm_mean, rolling_mean, rolling_std
    from binquant_tpu_torch.strategies.features import ext_gather

    close = ext_vals[:, :, Field.CLOSE]
    high = ext_vals[:, :, Field.HIGH]
    low = ext_vals[:, :, Field.LOW]
    last = counts.to(I32) + (window - 1)

    def g(s):
        return ext_gather(s, last)

    ema20 = g(ewm_mean(close, span=20, min_periods=1))
    ema50 = g(ewm_mean(close, span=50, min_periods=1))
    atr = g(rolling_mean(true_range(high, low, close), 14, min_periods=1))
    mid = g(rolling_mean(close, 20, min_periods=1))
    std = g(rolling_std(close, 20, min_periods=1, ddof=0))
    std = torch.where(torch.isfinite(std), std, 0.0)
    filled = torch.clamp(filled0[None, :] + counts, max=window).to(I32)
    return _assemble_symbol_feature_values(
        g(close), ext_gather(close, last - 1), ext_gather(ext_times, last),
        filled, eligible, ema20, ema50, atr, mid, std,
    )


def symbol_features_from_carry(
    buf: MarketBuffer, carry, eligible: torch.Tensor, stale: torch.Tensor
) -> SymbolFeatureArrays:
    """The same symbol features read from the 15m ``FeatureCarry`` (the
    incremental tick's path): ``min_periods=1`` readouts of the carried
    sums the feature pack uses. ``stale`` rows are left out of ``valid``
    so they cannot feed the market aggregates before the resync."""
    from binquant_tpu_torch.ops.incremental import ewm_value, moment_mean, moment_std
    from binquant_tpu_torch.strategies.features import ATR_WINDOW, BB_WINDOW

    ema20 = ewm_value(carry.ema20, 1)
    ema50 = ewm_value(carry.ema50, 1)
    atr = moment_mean(carry.tr_m, ATR_WINDOW, min_periods=1)
    mid = moment_mean(carry.close_m, BB_WINDOW, min_periods=1)
    std = moment_std(carry.close_m, BB_WINDOW, min_periods=1, ddof=0)
    std = torch.where(torch.isfinite(std), std, 0.0)
    close = buf.values[:, :, Field.CLOSE]
    return _assemble_symbol_feature_values(
        close[:, -1], close[:, -2], buf.times[:, -1], buf.filled,
        eligible & ~stale, ema20, ema50, atr, mid, std,
    )


def _masked_mean(x, mask, count):
    return jsafe_div(torch.where(mask, x, 0.0).sum(), torch.clamp(count, min=1))


# ---------------------------------------------------------------------------
# Macro regime ladder + transitions
# ---------------------------------------------------------------------------


def _select(pairs, default):
    """Nested ``where`` ladder: the first true condition wins."""
    out = default
    for cond, value in reversed(pairs):
        out = torch.where(cond, value, out)
    return out


def _market_transition_event(prev_regime, regime):
    T, R = MarketTransitionCode, MarketRegimeCode
    return _select(
        [
            (regime == R.HIGH_STRESS, int(T.STRESS_SPIKE)),
            ((prev_regime == R.HIGH_STRESS) & (regime != R.HIGH_STRESS), int(T.STRESS_RELIEF)),
            (regime == R.TREND_UP, int(T.ENTERED_TREND_UP)),
            (regime == R.TREND_DOWN, int(T.ENTERED_TREND_DOWN)),
            (regime == R.RANGE, int(T.ENTERED_RANGE)),
        ],
        torch.full_like(regime, int(T.LOST_REGIME_EDGE)),
    ).to(I32)


def _micro_transition_event(prev_regime, regime):
    T, R = MicroTransitionCode, MicroRegimeCode
    from_range_like = (prev_regime == R.RANGE) | (prev_regime == R.TRANSITIONAL)
    return _select(
        [
            (regime == R.VOLATILE, int(T.VOLATILITY_EXPANSION)),
            (from_range_like & (regime == R.TREND_UP), int(T.BREAKOUT_UP)),
            (from_range_like & (regime == R.TREND_DOWN), int(T.BREAKDOWN)),
            ((prev_regime == R.TREND_DOWN) & (regime == R.TREND_UP), int(T.RECOVERY)),
            ((prev_regime == R.TREND_UP) & (regime == R.RANGE), int(T.MEAN_REVERSION)),
            (regime == R.TREND_UP, int(T.ENTERED_TREND_UP)),
            (regime == R.TREND_DOWN, int(T.ENTERED_TREND_DOWN)),
            (regime == R.RANGE, int(T.ENTERED_RANGE)),
        ],
        torch.full_like(regime, int(T.ENTERED_TRANSITIONAL)),
    ).to(I32)


def _annotate_market_regime(ctx: dict, carry: RegimeCarry, timestamp) -> dict:
    R = MarketRegimeCode
    breadth_score = jclamp((ctx["advancers_ratio"] - 0.5) / 0.25)
    trend_participation = jclamp(
        ((ctx["pct_above_ema20"] + ctx["pct_above_ema50"]) - 1.0) * 1.4
    )
    avg_trend_bias = jclamp(ctx["average_trend_score"] * 20.0)
    calm_score = jclamp(1.0 - ctx["market_stress_score"], 0.0, 1.0)

    long_score = jclamp(
        0.3 * jnon_negative(ctx["long_tailwind"])
        + 0.24 * jnon_negative(ctx["btc_regime_score"])
        + 0.2 * jnon_negative(breadth_score)
        + 0.14 * jnon_negative(trend_participation)
        + 0.12 * calm_score,
        0.0,
        1.0,
    )
    short_score = jclamp(
        0.28 * jnon_negative(ctx["short_tailwind"])
        + 0.24 * jnon_negative(-ctx["btc_regime_score"])
        + 0.16 * jnon_negative(-breadth_score)
        + 0.1 * jnon_negative(-avg_trend_bias)
        + 0.22 * ctx["market_stress_score"],
        0.0,
        1.0,
    )
    range_score = jclamp(
        0.32 * (1.0 - torch.abs(breadth_score))
        + 0.22 * (1.0 - torch.abs(ctx["btc_regime_score"]))
        + 0.24 * calm_score
        + 0.12 * (1.0 - torch.abs(avg_trend_bias))
        + 0.1 * (1.0 - torch.abs(ctx["long_tailwind"] - ctx["short_tailwind"])),
        0.0,
        1.0,
    )
    stress_score = jclamp(
        0.7 * ctx["market_stress_score"]
        + 0.18 * jnon_negative(-ctx["average_return"] * 20.0)
        + 0.12 * jnon_negative(short_score - long_score),
        0.0,
        1.0,
    )

    dominant = torch.maximum(
        torch.maximum(long_score, short_score), torch.maximum(range_score, stress_score)
    )
    regime = _select(
        [
            ((stress_score >= 0.5) & (ctx["market_stress_score"] >= 0.35), int(R.HIGH_STRESS)),
            ((long_score >= 0.44) & (long_score >= short_score + 0.08), int(R.TREND_UP)),
            ((short_score >= 0.42) & (short_score >= long_score + 0.08), int(R.TREND_DOWN)),
            (range_score >= 0.5, int(R.RANGE)),
        ],
        torch.full((), int(R.TRANSITIONAL), dtype=I32, device=long_score.device),
    ).to(I32)

    prev_regime = torch.where(carry.has_prev, carry.market_regime, -1).to(I32)
    changed = carry.has_prev & (prev_regime != regime)

    scores = torch.stack([long_score, short_score, range_score, stress_score])
    max_delta = torch.abs(scores - carry.market_scores).max()
    transition_strength = torch.where(
        changed, jclamp(dominant + max_delta - 0.25, 0.0, 1.0), 0.0
    )
    transition = torch.where(
        changed, _market_transition_event(prev_regime, regime), -1
    ).to(I32)
    regime_is_transitioning = (regime == R.TRANSITIONAL) | (
        changed & (transition_strength >= TRANSITION_STRENGTH_FLOOR)
    )
    keep_anchor = carry.has_prev & (prev_regime == regime) & (carry.stable_since >= 0)
    stable_since = torch.where(keep_anchor, carry.stable_since, timestamp).to(I32)

    ctx.update(
        market_regime=regime,
        previous_market_regime=prev_regime,
        market_regime_transition=transition,
        market_regime_transition_strength=transition_strength,
        long_regime_score=long_score,
        short_regime_score=short_score,
        range_regime_score=range_score,
        stress_regime_score=stress_score,
        regime_is_transitioning=regime_is_transitioning,
        regime_stable_since=stable_since,
    )
    return ctx


def _annotate_micro_regimes(
    feats: SymbolFeatureArrays, carry: RegimeCarry
) -> SymbolFeatureArrays:
    R = MicroRegimeCode
    up_score = jclamp(
        0.45 * jnon_negative(feats.trend_score * 30.0)
        + 0.2 * feats.above_ema20.to(F32)
        + 0.15 * feats.above_ema50.to(F32)
        + 0.2 * jnon_negative(feats.relative_strength_vs_btc * 20.0),
        0.0,
        1.0,
    )
    down_score = jclamp(
        0.45 * jnon_negative(-feats.trend_score * 30.0)
        + 0.2 * (~feats.above_ema20).to(F32)
        + 0.15 * (~feats.above_ema50).to(F32)
        + 0.2 * jnon_negative(-feats.relative_strength_vs_btc * 20.0),
        0.0,
        1.0,
    )
    range_score = jclamp(
        0.38 * (1.0 - torch.clamp(torch.abs(feats.trend_score) * 30.0, max=1.0))
        + 0.34 * (1.0 - torch.clamp(feats.bb_width / 0.08, max=1.0))
        + 0.28 * (1.0 - torch.clamp(feats.atr_pct / 0.04, max=1.0)),
        0.0,
        1.0,
    )
    volatile_score = jclamp(
        0.55 * torch.clamp(feats.atr_pct / 0.05, max=1.0)
        + 0.45 * torch.clamp(feats.bb_width / 0.12, max=1.0),
        0.0,
        1.0,
    )

    strength = torch.maximum(
        torch.maximum(up_score, down_score), torch.maximum(range_score, volatile_score)
    )
    regime = _select(
        [
            ((volatile_score >= 0.72) & (torch.abs(feats.return_pct) >= 0.015), int(R.VOLATILE)),
            ((up_score >= 0.52) & (up_score >= down_score + 0.1), int(R.TREND_UP)),
            ((down_score >= 0.52) & (down_score >= up_score + 0.1), int(R.TREND_DOWN)),
            (range_score >= 0.5, int(R.RANGE)),
        ],
        torch.full(up_score.shape, int(R.TRANSITIONAL), dtype=I32, device=up_score.device),
    ).to(I32)

    had_prev = carry.micro_has_prev & (carry.micro_regime >= 0)
    changed = had_prev & (carry.micro_regime != regime)
    transition = torch.where(
        changed, _micro_transition_event(carry.micro_regime, regime), -1
    ).to(I32)
    transition_strength = torch.where(
        changed,
        jclamp(strength + torch.abs(strength - carry.micro_strength) - 0.25, 0.0, 1.0),
        0.0,
    )
    return feats._replace(
        micro_regime=torch.where(feats.valid, regime, -1).to(I32),
        micro_regime_strength=torch.where(feats.valid, strength, 0.0),
        micro_transition=torch.where(feats.valid, transition, -1).to(I32),
        micro_transition_strength=torch.where(feats.valid, transition_strength, 0.0),
    )


# ---------------------------------------------------------------------------
# Full context build
# ---------------------------------------------------------------------------


class MarketColumns(NamedTuple):
    """The ``(S,)`` columns the market-wide scalars read: what a sharded
    tick gathers in row order for :func:`market_scalars`."""

    filled: torch.Tensor
    tracked: torch.Tensor
    valid: torch.Tensor
    return_pct: torch.Tensor
    above_ema20: torch.Tensor
    above_ema50: torch.Tensor
    trend_score: torch.Tensor
    atr_pct: torch.Tensor
    bb_width: torch.Tensor


# the RegimeCarry fields that are one scalar (or score vector) per market
MARKET_CARRY_FIELDS: tuple[str, ...] = (
    "has_prev", "market_regime", "market_scores", "stable_since",
    "stage_ts", "stage_valid", "stage_regime", "stage_scores", "stage_stable_since",
)


def market_scalars(
    cols: MarketColumns,
    btc_row: torch.Tensor,
    timestamp: torch.Tensor,
    carry: RegimeCarry,
    cfg: ContextConfig = ContextConfig(),
) -> dict[str, torch.Tensor]:
    """Every market-wide scalar of one tick from the universe's columns:
    the BTC row's features, the coverage gates, the masked aggregates and
    scores, the macro regime with its transition, and the new carry's
    market fields (``carry.<field>`` for :data:`MARKET_CARRY_FIELDS`). Also
    ``newer`` (a strictly newer timestamp) and ``safe_btc`` (the clamped BTC
    row) for the per-row half. Reads only ``carry``'s market fields."""
    S = cols.valid.shape[0]
    dev = cols.valid.device
    # BTC features come from its row even when BTC itself is not fresh
    btc_ok = (btc_row >= 0) & (btc_row < S)
    safe_btc = torch.clamp(btc_row, 0, S - 1).long()

    def at_btc(x: torch.Tensor) -> torch.Tensor:
        # a gather, not an index by a 0-d tensor (which reads it on the host)
        return x.index_select(0, safe_btc.reshape(1))[0]

    btc_present = btc_ok & (at_btc(cols.filled) >= 2)
    btc_return = torch.where(btc_present, at_btc(cols.return_pct), 0.0)
    btc_trend = torch.where(btc_present, at_btc(cols.trend_score), 0.0)

    # RS-vs-BTC rewrite: every symbol except BTC itself
    is_btc_row = torch.arange(S, device=dev) == safe_btc
    rs = torch.where(btc_present & ~is_btc_row, cols.return_pct - btc_return, 0.0)

    m = cols.valid
    effective = m.sum(dtype=I32)
    total_tracked = torch.maximum(cols.tracked.sum(dtype=I32), effective)

    advancers = (m & (cols.return_pct > 0)).sum(dtype=I32)
    decliners = (m & (cols.return_pct < 0)).sum(dtype=I32)
    advancers_ratio = jsafe_div(advancers, torch.clamp(effective, min=1))
    decliners_ratio = jsafe_div(decliners, torch.clamp(effective, min=1))
    adv_dec_ratio = jsafe_div(advancers, torch.clamp(decliners, min=1))

    average_return = _masked_mean(cols.return_pct, m, effective)
    average_rs = _masked_mean(rs, m, effective)
    pct_above_ema20 = _masked_mean(cols.above_ema20.to(F32), m, effective)
    pct_above_ema50 = _masked_mean(cols.above_ema50.to(F32), m, effective)
    average_trend = _masked_mean(cols.trend_score, m, effective)
    average_atr_pct = _masked_mean(cols.atr_pct, m, effective)
    average_bb_width = _masked_mean(cols.bb_width, m, effective)

    breadth_balance = jclamp((advancers_ratio - decliners_ratio) * 1.5)
    ema_balance = jclamp(((pct_above_ema20 + pct_above_ema50) - 1.0) * 1.5)
    average_return_score = jclamp(average_return * 12.0)
    btc_regime_score = torch.where(
        btc_present, jclamp(btc_return * 12.0 + btc_trend * 6.0), 0.0
    )
    stress_from_volatility = jclamp((average_atr_pct - 0.02) * 12.0, 0.0, 1.0)
    stress_from_bandwidth = jclamp((average_bb_width - 0.08) * 4.0, 0.0, 1.0)
    stress_from_selloff = jclamp((-average_return) * 16.0, 0.0, 1.0)
    market_stress_score = (
        0.4 * stress_from_volatility
        + 0.25 * stress_from_bandwidth
        + 0.35 * stress_from_selloff
    )
    long_tailwind = jclamp(
        0.4 * breadth_balance
        + 0.2 * ema_balance
        + 0.25 * btc_regime_score
        + 0.15 * average_return_score
        - 0.35 * market_stress_score
    )
    short_tailwind = jclamp(
        -0.35 * breadth_balance
        - 0.15 * ema_balance
        - 0.2 * btc_regime_score
        - 0.15 * average_return_score
        + 0.45 * market_stress_score
    )

    # coverage gates
    required = torch.clamp(
        torch.ceil(total_tracked * cfg.min_coverage_ratio).to(I32),
        min=cfg.required_fresh_symbols,
    )
    coverage_ratio = jsafe_div(effective, torch.clamp(total_tracked, min=1))
    valid = (
        (effective >= required)
        & (total_tracked > 0)
        & (effective >= cfg.required_fresh_symbols)
        & (coverage_ratio >= cfg.min_coverage_ratio)
    )

    ctx: dict[str, torch.Tensor] = dict(
        advancers_ratio=advancers_ratio,
        pct_above_ema20=pct_above_ema20,
        pct_above_ema50=pct_above_ema50,
        average_trend_score=average_trend,
        average_return=average_return,
        market_stress_score=market_stress_score,
        btc_regime_score=btc_regime_score,
        long_tailwind=long_tailwind,
        short_tailwind=short_tailwind,
    )
    # promote the staged context to "previous" only on a strictly newer ts
    ts32 = timestamp.to(I32)
    newer = ts32 > carry.stage_ts
    promote = newer & carry.stage_valid
    eff_carry = carry._replace(
        has_prev=carry.has_prev | promote,
        market_regime=torch.where(promote, carry.stage_regime, carry.market_regime),
        market_scores=torch.where(promote, carry.stage_scores, carry.market_scores),
        stable_since=torch.where(promote, carry.stage_stable_since, carry.stable_since),
    )
    ctx = _annotate_market_regime(ctx, eff_carry, ts32)

    # only the STAGE is overwritten by this evaluation (and only when valid)
    new_scores = torch.stack(
        [
            ctx["long_regime_score"],
            ctx["short_regime_score"],
            ctx["range_regime_score"],
            ctx["stress_regime_score"],
        ]
    )
    out = dict(
        valid=valid,
        timestamp=ts32,
        fresh_count=effective,
        total_tracked_symbols=total_tracked,
        coverage_ratio=coverage_ratio,
        btc_present=btc_present,
        advancers=advancers,
        decliners=decliners,
        advancers_ratio=advancers_ratio,
        decliners_ratio=decliners_ratio,
        advancers_decliners_ratio=adv_dec_ratio,
        average_return=average_return,
        average_relative_strength_vs_btc=average_rs,
        pct_above_ema20=pct_above_ema20,
        pct_above_ema50=pct_above_ema50,
        average_trend_score=average_trend,
        average_atr_pct=average_atr_pct,
        average_bb_width=average_bb_width,
        btc_return=btc_return,
        btc_trend_score=btc_trend,
        btc_regime_score=btc_regime_score,
        market_stress_score=market_stress_score,
        long_tailwind=long_tailwind,
        short_tailwind=short_tailwind,
        market_regime=ctx["market_regime"],
        previous_market_regime=ctx["previous_market_regime"],
        market_regime_transition=ctx["market_regime_transition"],
        market_regime_transition_strength=ctx["market_regime_transition_strength"],
        long_regime_score=ctx["long_regime_score"],
        short_regime_score=ctx["short_regime_score"],
        range_regime_score=ctx["range_regime_score"],
        stress_regime_score=ctx["stress_regime_score"],
        regime_is_transitioning=ctx["regime_is_transitioning"],
        regime_stable_since=ctx["regime_stable_since"],
        newer=newer,
        safe_btc=safe_btc,
    )
    stage = {
        "stage_ts": torch.where(newer, ts32, carry.stage_ts).to(I32),
        "stage_valid": torch.where(newer, valid, carry.stage_valid | valid),
        "stage_regime": torch.where(
            valid, ctx["market_regime"], torch.where(newer, -1, carry.stage_regime)
        ).to(I32),
        "stage_scores": torch.where(
            valid, new_scores, torch.where(newer, 0.0, carry.stage_scores)
        ),
        "stage_stable_since": torch.where(
            valid,
            ctx["regime_stable_since"],
            torch.where(newer, -1, carry.stage_stable_since),
        ).to(I32),
    }
    for f in MARKET_CARRY_FIELDS:
        out[f"carry.{f}"] = stage[f] if f in stage else getattr(eff_carry, f)
    return out


def compute_market_context(
    buf: MarketBuffer,
    fresh: torch.Tensor,  # (S,) bool — latest bar == evaluated tick
    tracked: torch.Tensor,  # (S,) bool — registry-occupied rows
    btc_row: torch.Tensor,  # int32 scalar; -1 when BTC untracked
    timestamp: torch.Tensor,  # int32 seconds, the tick being evaluated
    carry: RegimeCarry,
    cfg: ContextConfig = ContextConfig(),
    feats: SymbolFeatureArrays | None = None,
    comm=None,
) -> tuple[MarketContext, RegimeCarry]:
    """One tick's market context for the whole universe + updated carry.
    When the coverage gates fail ``context.valid`` is False and only the
    stage bookkeeping moves. ``feats`` passes in symbol features read from
    the carried indicator state (:func:`symbol_features_from_carry`, the
    incremental tick); None computes them from the window.

    Two halves: the market-wide scalars (:func:`market_scalars`) and the
    per-row rest (the RS-vs-BTC rewrite, the micro regimes, the carry's
    per-row fields). Under a sharded tick (``comm``, a
    :class:`~binquant_tpu_torch.parallel.collectives.ShardComm`) each shard
    holds its own rows: the scalars' columns are gathered in row order,
    computed once by the same code on shard 0 and handed to every shard, so
    every shard reads the bits the unsharded tick computes."""
    if feats is None:
        feats = compute_symbol_features(buf, fresh & tracked)
    cols = MarketColumns(
        filled=buf.filled, tracked=tracked, valid=feats.valid,
        return_pct=feats.return_pct, above_ema20=feats.above_ema20,
        above_ema50=feats.above_ema50, trend_score=feats.trend_score,
        atr_pct=feats.atr_pct, bb_width=feats.bb_width,
    )

    def scalars(full: MarketColumns) -> dict[str, torch.Tensor]:
        return market_scalars(full, btc_row, timestamp, carry, cfg)

    mk = scalars(cols) if comm is None else comm.finalize(scalars, cols, kind="context")
    lo = 0 if comm is None else comm.lo
    rows = torch.arange(lo, lo + buf.filled.shape[0], device=buf.filled.device)

    # RS-vs-BTC rewrite: every symbol except BTC itself
    is_btc_row = rows == mk["safe_btc"]
    rs = torch.where(
        mk["btc_present"] & ~is_btc_row, feats.return_pct - mk["btc_return"], 0.0
    )
    feats = feats._replace(relative_strength_vs_btc=rs)

    promote_micro = mk["newer"] & carry.stage_micro_valid
    eff_carry = carry._replace(
        micro_has_prev=carry.micro_has_prev | promote_micro,
        micro_regime=torch.where(promote_micro, carry.stage_micro_regime, carry.micro_regime),
        micro_strength=torch.where(
            promote_micro, carry.stage_micro_strength, carry.micro_strength
        ),
    )
    feats = _annotate_micro_regimes(feats, eff_carry)
    context = MarketContext(
        **{f: mk[f] for f in MarketContext._fields if f != "features"}, features=feats
    )

    newer, valid = mk["newer"], mk["valid"]
    micro_update = valid & feats.valid
    new_carry = eff_carry._replace(
        **{f: mk[f"carry.{f}"] for f in MARKET_CARRY_FIELDS},
        stage_micro_valid=torch.where(
            newer, micro_update, carry.stage_micro_valid | micro_update
        ),
        stage_micro_regime=torch.where(
            micro_update,
            feats.micro_regime,
            torch.where(newer, -1, carry.stage_micro_regime),
        ).to(I32),
        stage_micro_strength=torch.where(
            micro_update,
            feats.micro_regime_strength,
            torch.where(newer, 0.0, carry.stage_micro_strength),
        ),
    )
    return context, new_carry
