"""The dormant strategy set, batched: nine last-bar kernels.

Port of ``binquant_tpu/strategies/dormant.py``. The reference keeps these
strategies off its live dispatch list but test-covered as capability
surface; an engine runs each one that its ``enabled_strategies`` names:

* three coinrule rules: :func:`twap_momentum_sniper` (on a calendar-aligned
  15m→1h resample, :func:`_resample_1h`), :func:`supertrend_swing_reversal`
  and :func:`buy_low_sell_high`;
* :func:`buy_the_dip`, :func:`bb_extreme_reversion`,
  :func:`inverse_price_tracker`, :func:`range_bb_rsi_mean_reversion`,
  :func:`range_failed_breakout_fade` (on the spike detector's flags) and
  :func:`relative_strength_reversal_range`.

Route codes and counts are int32 and masks bool, as in the reference. The
two order statistics here (the RSR volume percentile, and the spike
detector's calibration in ``spike_hunter``) sort with non-finite values as
+inf in a stable sort, so ties keep their column order.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from binquant_tpu_torch.engine.buffer import Field, MarketBuffer
from binquant_tpu_torch.enums import (
    Direction,
    MarketRegimeCode,
    MicroRegimeCode,
    MicroTransitionCode,
)
from binquant_tpu_torch.ops.indicators import supertrend_from
from binquant_tpu_torch.ops.rolling import (
    ewm_mean_last,
    rolling_mean,
    rolling_mean_last,
    rolling_std_last,
    rolling_sum,
    shift,
)
from binquant_tpu_torch.regime.context import MarketContext
from binquant_tpu_torch.regime.scoring import ScorerWeights, score_signal_candidate
from binquant_tpu_torch.strategies.base import StrategyOutputs, no_signal
from binquant_tpu_torch.strategies.features import FeaturePack
from binquant_tpu_torch.strategies.spike_hunter import SpikeSignal
from binquant_tpu_torch.utils import jsafe_div

I32 = torch.int32
F32 = torch.float32
NAN = float("nan")


def _zeros(S: int, dev, dtype=F32) -> torch.Tensor:
    return torch.zeros((S,), dtype=dtype, device=dev)


def _code(c: int, dev) -> torch.Tensor:
    # a fill, not an upload: a blocking copy would synchronize with the card
    return torch.full((), int(c), dtype=I32, device=dev)


# ---------------------------------------------------------------------------
# coinrule: twap_momentum_sniper
# ---------------------------------------------------------------------------


def _resample_1h(buf15: MarketBuffer, n_buckets: int):
    """Calendar-aligned 15m→1h OHLC resample: bars are bucketed by
    ``open_time // 3600``; the last bucket is each row's current (possibly
    partial) hour, the ones before it the hours before that. Returns
    (open, high, low, close), (S, n_buckets) each, NaN where an hour has no
    bar; bars more than ``n_buckets`` hours before a row's newest bar are
    dropped. The open and close come from the first and last POSITION in
    each hour. Segment reductions are ``scatter_reduce`` over
    ``n_buckets + 1`` segments, the last one collecting the dropped bars."""
    S, W = buf15.times.shape
    dev = buf15.times.device
    times = buf15.times
    has_bar = times >= 0
    hour = torch.div(times, 3600, rounding_mode="floor")
    last_hour = torch.where(has_bar, hour, -1).amax(dim=1, keepdim=True)
    idx = hour - last_hour + (n_buckets - 1)
    in_range = has_bar & (idx >= 0) & (idx < n_buckets)
    seg = torch.where(in_range, idx, n_buckets).long()
    n_seg = n_buckets + 1
    pos = torch.broadcast_to(torch.arange(W, dtype=torch.int64, device=dev), (S, W))

    def reduce(src, how, init):
        out = torch.full((S, n_seg), init, dtype=src.dtype, device=dev)
        return out.scatter_reduce(1, seg, src, how, include_self=False)[:, :-1]

    first = reduce(pos, "amin", W)
    last = reduce(pos, "amax", -1)
    filled = first <= last
    vals = buf15.values

    def at(pos_k, f):
        col = vals[:, :, f]
        return torch.gather(col, 1, torch.clamp(pos_k, 0, W - 1))

    open_1h = torch.where(filled, at(first, Field.OPEN), NAN)
    close_1h = torch.where(filled, at(last, Field.CLOSE), NAN)
    high_1h = torch.where(filled, reduce(vals[:, :, Field.HIGH], "amax", NAN), NAN)
    low_1h = torch.where(filled, reduce(vals[:, :, Field.LOW], "amin", NAN), NAN)
    return open_1h, high_1h, low_1h, close_1h


def twap_momentum_sniper(
    buf15: MarketBuffer,
    pack5: FeaturePack,
    twap_window: int = 20,
) -> StrategyOutputs:
    """TWAP of the last ``twap_window`` wall-clock hours above the price,
    with no sharp recent selloff; telemetry only (autotrade off). The TWAP
    is the nan-mean of the hourly (o+h+l+c)/4, hours with no bars skipped."""
    S = buf15.capacity
    dev = buf15.times.device
    open_1h, high_1h, low_1h, close_1h = _resample_1h(buf15, twap_window + 2)
    bar_avg = (open_1h + high_1h + low_1h + close_1h) / 4.0
    tail = bar_avg[:, -twap_window:]
    twap_last = torch.nanmean(torch.where(torch.isfinite(tail), tail, NAN), dim=1)
    # "price_decrease" as the reference writes it: close[-1] - close[-2]/close[-1]
    price_decrease = close_1h[:, -1] - jsafe_div(close_1h[:, -2], close_1h[:, -1])
    enough = (pack5.filled >= 10) & (buf15.filled >= 8)
    fired = enough & (twap_last > pack5.close) & (price_decrease > -0.05)
    return StrategyOutputs(
        trigger=fired,
        direction=_zeros(S, dev, I32),
        score=_zeros(S, dev),
        autotrade=_zeros(S, dev, torch.bool),  # manual only
        stop_loss_pct=_zeros(S, dev),
        diagnostics={"twap": twap_last, "price_decrease": price_decrease},
    )


# ---------------------------------------------------------------------------
# coinrule: supertrend_swing_reversal
# ---------------------------------------------------------------------------


def supertrend_swing_reversal(
    buf5: MarketBuffer,
    pack5: FeaturePack,
    context: MarketContext,
    long_gate: torch.Tensor,  # (S,) allows_long_autotrade mask
    adp_diff: torch.Tensor,  # scalar: breadth[-1] - breadth[-2], NaN if missing
    adp_diff_prev: torch.Tensor,  # scalar: breadth[-2] - breadth[-3]
    dominance_is_losers: torch.Tensor,  # scalar bool
    st_up: torch.Tensor | None = None,  # (S,) bool: the carried readout
) -> StrategyOutputs:
    """Supertrend(10, 3) up ∧ RSI < 30 ∧ trades > 5 ∧ breadth rising twice ∧
    LOSERS dominance. Long; autotrade through the standard long gate.
    ``st_up`` is the incremental engine's supertrend direction read from
    its carry; without it the scan runs over the window from each row's
    seed: the first bar after the 100-bar indicator warm-up."""
    S = buf5.capacity
    dev = buf5.times.device
    W = buf5.window
    if st_up is None:
        start = (W - pack5.filled + 99).to(I32)
        v = buf5.values
        st = supertrend_from(
            v[:, :, Field.HIGH], v[:, :, Field.LOW], v[:, :, Field.CLOSE], start,
            window=10, multiplier=3.0,
        )
        last = st.direction[:, -1]
        st_up = torch.where(torch.isfinite(last), last > 0, False)
    breadth_ok = (
        torch.isfinite(adp_diff) & torch.isfinite(adp_diff_prev)
        & (adp_diff > 0) & (adp_diff_prev > 0)
    )
    fired = (
        st_up & (pack5.rsi < 30.0) & (pack5.num_trades > 5) & breadth_ok
        & dominance_is_losers & pack5.valid
    )
    autotrade = fired & torch.where(context.valid, long_gate, True)
    return StrategyOutputs(
        trigger=fired,
        direction=_zeros(S, dev, I32),
        score=_zeros(S, dev),
        autotrade=autotrade,
        stop_loss_pct=_zeros(S, dev),
        diagnostics={
            "rsi": pack5.rsi,
            "number_of_trades": pack5.num_trades,
            "supertrend_up": st_up,
        },
    )


# ---------------------------------------------------------------------------
# coinrule: buy_low_sell_high
# ---------------------------------------------------------------------------


def buy_low_sell_high(
    buf15: MarketBuffer,
    pack15: FeaturePack,
    market_domination_reversal: torch.Tensor,  # scalar bool (host)
) -> StrategyOutputs:
    """RSI < 35 ∧ price > MA25 ∧ a domination reversal; telemetry only."""
    S = buf15.capacity
    dev = buf15.times.device
    ma25 = rolling_mean_last(buf15.values[:, :, Field.CLOSE], 25, min_periods=1)
    fired = (
        (pack15.rsi < 35.0) & (pack15.close > ma25) & market_domination_reversal
        & pack15.valid
    )
    return StrategyOutputs(
        trigger=fired,
        direction=_zeros(S, dev, I32),
        score=_zeros(S, dev),
        autotrade=_zeros(S, dev, torch.bool),  # manual only
        stop_loss_pct=_zeros(S, dev),
        diagnostics={"rsi": pack15.rsi, "ma_25": ma25},
    )


# ---------------------------------------------------------------------------
# BuyTheDip
# ---------------------------------------------------------------------------

BTD_ROUTE_ALLOWED_RANGE = 0
BTD_ROUTE_NO_CONTEXT = 1
BTD_ROUTE_TRANSITIONING = 2
BTD_ROUTE_STRESS = 3
BTD_ROUTE_MARKET_REGIME = 4
BTD_ROUTE_SYMBOL_REGIME = 5
BTD_ROUTE_QUIET_HOURS = 6


class BTDParams(NamedTuple):
    lookback_candles: int = 24
    lookback_bars_6h: int = 24  # 6h of 15m bars
    dip_min_pct: float = -5.0  # exclusive lower bound
    dip_max_pct: float = -2.0  # exclusive upper bound
    # the strategy's go-live time: no fires on bars closing before it, so a
    # restart's backfill never fires the rule retroactively
    live_since_s: int = 1_776_036_060


def buy_the_dip(
    buf15: MarketBuffer,
    pack15: FeaturePack,
    context: MarketContext,
    quiet_hours_suppressed: torch.Tensor,  # scalar bool
    params: BTDParams = BTDParams(),
) -> StrategyOutputs:
    """A -2%..-5% dip over the 6h lookback and a reclaim of the prior close
    and the EMA20; trend regimes block the entry; autotrade only in RANGE or
    TRANSITIONAL market and micro regimes."""
    p = params
    S, W = buf15.times.shape
    dev = buf15.times.device
    close = buf15.values[:, :, Field.CLOSE]
    current = pack15.close

    # the last close at or before now-6h: with contiguous 15m bars, the bar
    # lookback_bars_6h back
    idx = W - 1 - p.lookback_bars_6h
    reference = close[:, idx] if idx >= 0 else torch.full((S,), NAN, device=dev)
    has_ref = torch.isfinite(reference) & (buf15.filled > p.lookback_bars_6h)
    change_6h = jsafe_div(current - reference, torch.abs(reference)) * 100.0
    dip = (change_6h <= p.dip_max_pct) & (change_6h > p.dip_min_pct)
    ema20 = ewm_mean_last(close, span=20, min_periods=1)
    reclaimed = (current > pack15.prev_close) & (current > ema20)

    feats = context.features
    market_regime = context.market_regime
    micro = feats.micro_regime
    market_trend_blocked = context.valid & (
        (market_regime == MarketRegimeCode.TREND_DOWN)
        | (market_regime == MarketRegimeCode.TREND_UP)
    )
    symbol_trend_blocked = feats.valid & (
        (micro == MicroRegimeCode.TREND_DOWN) | (micro == MicroRegimeCode.TREND_UP)
    )
    entry_allowed = ~market_trend_blocked & ~symbol_trend_blocked
    # the evaluated bar's close time against the go-live time
    live = (buf15.times[:, -1] + 900) >= p.live_since_s
    fired = (
        (pack15.filled >= p.lookback_candles) & has_ref & dip & live & entry_allowed
        & reclaimed & pack15.valid
    )

    market_rt = (market_regime == MarketRegimeCode.RANGE) | (
        market_regime == MarketRegimeCode.TRANSITIONAL
    )
    micro_rt_ok = (micro == MicroRegimeCode.RANGE) | (micro == MicroRegimeCode.TRANSITIONAL)
    micro_blocked = (
        (micro == MicroRegimeCode.TREND_DOWN)
        | (micro == MicroRegimeCode.TREND_UP)
        | (micro == MicroRegimeCode.VOLATILE)
    )
    base_autotrade = (
        context.valid
        & ~context.regime_is_transitioning
        & (context.market_stress_score < 0.35)
        & market_rt
        & torch.where(feats.valid, ~micro_blocked & micro_rt_ok, True)
    )
    autotrade = base_autotrade & ~quiet_hours_suppressed

    def c(v):
        return _code(v, dev)

    route = torch.where(
        ~context.valid,
        c(BTD_ROUTE_NO_CONTEXT),
        torch.where(
            context.regime_is_transitioning,
            c(BTD_ROUTE_TRANSITIONING),
            torch.where(
                context.market_stress_score >= 0.35,
                c(BTD_ROUTE_STRESS),
                torch.where(
                    ~market_rt,
                    c(BTD_ROUTE_MARKET_REGIME),
                    torch.where(
                        feats.valid & micro_blocked,
                        c(BTD_ROUTE_SYMBOL_REGIME),
                        c(BTD_ROUTE_ALLOWED_RANGE),
                    ),
                ),
            ),
        ),
    )
    route = torch.where(
        fired & base_autotrade & quiet_hours_suppressed, c(BTD_ROUTE_QUIET_HOURS), route
    )
    return StrategyOutputs(
        trigger=fired,
        direction=_zeros(S, dev, I32),
        score=_zeros(S, dev),
        autotrade=fired & autotrade,
        stop_loss_pct=_zeros(S, dev),
        diagnostics={
            "reference_price": torch.where(has_ref, reference, 0.0),
            "change_6h": torch.where(has_ref, change_6h, 0.0),
            "route": route,
        },
    )


# ---------------------------------------------------------------------------
# BBExtremeReversion
# ---------------------------------------------------------------------------


class BBXParams(NamedTuple):
    enabled: bool = False  # the reference ships it disabled
    rsi_window: int = 2
    oversold_rsi: float = 5.0
    overbought_rsi: float = 95.0
    max_lower_band_position: float = 0.0
    min_upper_band_position: float = 1.0
    stress_threshold: float = 0.35
    micro_min_strength: float = 0.5


def bb_extreme_reversion(
    buf15: MarketBuffer,
    pack15: FeaturePack,
    context: MarketContext,
    params: BBXParams = BBXParams(),
) -> StrategyOutputs:
    """Connors-style RSI(2) <= 5 / >= 95 at or beyond the Bollinger bands,
    with direction-specific autotrade routing. Disabled unless
    ``params.enabled``."""
    p = params
    S = buf15.capacity
    dev = buf15.times.device
    if not p.enabled:
        return no_signal(S, device=dev)

    close = buf15.values[:, :, Field.CLOSE]
    delta = close - shift(close, 1)
    gain = rolling_mean_last(torch.clamp(delta, min=0.0), p.rsi_window)
    loss = rolling_mean_last(torch.clamp(-delta, min=0.0), p.rsi_window)
    rsi2 = torch.where(
        loss == 0,
        torch.where(gain == 0, NAN, 100.0),
        100.0 - 100.0 / (1.0 + jsafe_div(gain, torch.where(loss == 0, 1.0, loss))),
    )
    rsi2 = torch.clamp(
        torch.where(torch.isfinite(gain) & torch.isfinite(loss), rsi2, NAN), 0, 100
    )

    band_span = pack15.bb_upper - pack15.bb_lower
    band_position = torch.where(
        band_span > 0, (pack15.close - pack15.bb_lower) / band_span, 0.5
    )
    buy = (rsi2 <= p.oversold_rsi) & (band_position <= p.max_lower_band_position)
    sell = (rsi2 >= p.overbought_rsi) & (band_position >= p.min_upper_band_position)
    fired = (buy | sell) & torch.isfinite(rsi2) & (band_span > 0) & pack15.valid

    feats = context.features
    base_ok = (
        context.valid
        & ~context.regime_is_transitioning
        & (context.market_stress_score < p.stress_threshold)
        & (context.market_regime == MarketRegimeCode.RANGE)
    )
    trans = feats.micro_transition
    trans_blocked = (
        (trans == MicroTransitionCode.VOLATILITY_EXPANSION)
        | (trans == MicroTransitionCode.BREAKDOWN)
        | (trans == MicroTransitionCode.ENTERED_TRANSITIONAL)
    )
    micro = feats.micro_regime
    shortable = (
        (micro == MicroRegimeCode.RANGE)
        | (micro == MicroRegimeCode.TRANSITIONAL)
        | (micro == MicroRegimeCode.TREND_DOWN)
    )
    directional_ok = (
        feats.valid
        & ~trans_blocked
        & (feats.micro_regime_strength >= p.micro_min_strength)
        & torch.where(sell, shortable, micro != MicroRegimeCode.TREND_DOWN)
    )
    autotrade = fired & base_ok & directional_ok
    return StrategyOutputs(
        trigger=fired,
        direction=torch.where(sell, _code(Direction.SHORT, dev), _code(Direction.LONG, dev)),
        score=_zeros(S, dev),
        autotrade=autotrade,
        stop_loss_pct=_zeros(S, dev),
        diagnostics={
            "rsi2": torch.where(torch.isfinite(rsi2), rsi2, 50.0),
            "band_position": band_position,
            "bb_width": jsafe_div(band_span, pack15.bb_mid),
        },
    )


# ---------------------------------------------------------------------------
# InversePriceTracker
# ---------------------------------------------------------------------------

IPT_ROUTE_TREND_UP = 0
IPT_ROUTE_TRANSITIONAL_BULLISH = 1
IPT_ROUTE_TRANSITIONAL_TELEMETRY = 2
IPT_ROUTE_RANGE_LEADER = 3
IPT_ROUTE_BLOCKED = 4


class IPTParams(NamedTuple):
    range_rs_min: float = 0.05
    confidence_min: float = 0.4
    followthrough_min: float = -0.1
    adverse_risk_max: float = 0.65
    weights: ScorerWeights = ScorerWeights(
        context_weight=0.35, risk_weight=0.35, support_weight=0.2
    )


def inverse_price_tracker(
    pack5: FeaturePack,
    context: MarketContext,
    params: IPTParams = IPTParams(),
) -> StrategyOutputs:
    """PriceTracker's oversold trio, routed to TREND_UP, bullish
    TRANSITIONAL and RANGE-leader markets; telemetry only."""
    p = params
    f = pack5
    S = f.close.shape[0]
    dev = f.close.device
    enough = (
        (f.filled >= 30) & torch.isfinite(f.rsi) & torch.isfinite(f.macd) & torch.isfinite(f.mfi)
    )
    entry = (f.rsi < 30.0) & (f.macd < 0.0) & (f.mfi < 20.0)

    feats = context.features
    micro = feats.micro_regime
    bullish_transitional_market = (
        (context.market_regime == MarketRegimeCode.TRANSITIONAL)
        & (context.long_tailwind > 0)
        & (context.long_regime_score > context.short_regime_score)
        & (context.long_regime_score > context.range_regime_score)
        & (context.long_regime_score > context.stress_regime_score)
    )
    bullish_transitional_symbol = (
        (micro == MicroRegimeCode.TRANSITIONAL)
        & (feats.trend_score > 0)
        & feats.above_ema20
        & (feats.relative_strength_vs_btc >= 0)
    )
    range_leader = (
        ((micro == MicroRegimeCode.TREND_UP) | (micro == MicroRegimeCode.TRANSITIONAL))
        & (feats.trend_score > 0)
        & (feats.relative_strength_vs_btc >= p.range_rs_min)
    )
    stress_ok = context.market_stress_score < 0.35
    market_trend_up = context.market_regime == MarketRegimeCode.TREND_UP
    market_transitional = context.market_regime == MarketRegimeCode.TRANSITIONAL
    market_range = context.market_regime == MarketRegimeCode.RANGE

    symbol_ok = (micro == MicroRegimeCode.TREND_UP) | bullish_transitional_symbol
    routed = (
        context.valid
        & stress_ok
        & feats.valid
        & (
            ((market_trend_up | market_transitional) & symbol_ok)
            | (market_range & range_leader)
        )
    )

    def c(v):
        return _code(v, dev)

    route = torch.where(
        routed & market_trend_up,
        c(IPT_ROUTE_TREND_UP),
        torch.where(
            routed & bullish_transitional_market,
            c(IPT_ROUTE_TRANSITIONAL_BULLISH),
            torch.where(
                routed & market_transitional,
                c(IPT_ROUTE_TRANSITIONAL_TELEMETRY),
                torch.where(routed, c(IPT_ROUTE_RANGE_LEADER), c(IPT_ROUTE_BLOCKED)),
            ),
        ),
    )

    local_score = (
        1.0
        + torch.clamp((30.0 - f.rsi) / 30.0, min=0.0) * 0.35
        + torch.clamp((20.0 - f.mfi) / 20.0, min=0.0) * 0.35
        + torch.clamp(torch.abs(f.macd) * 100.0, max=1.0) * 0.3
    )
    trend_score = torch.where(
        f.ema21 != 0, jsafe_div(f.ema9 - f.ema21, torch.abs(f.ema21)), 0.0
    )
    ev = score_signal_candidate(
        context,
        is_short=torch.zeros((), dtype=torch.bool, device=dev),
        local_score=local_score,
        symbol_rs=feats.relative_strength_vs_btc,
        symbol_trend=trend_score,
        weights=p.weights,
        emit_threshold=1.0,
    )
    cs = ev.context_score
    telemetry_ok = (
        (cs.confidence >= p.confidence_min)
        & (cs.followthrough_score >= p.followthrough_min)
        & (cs.adverse_excursion_risk <= p.adverse_risk_max)
    )
    fired = entry & enough & routed & telemetry_ok & f.valid
    return StrategyOutputs(
        trigger=fired,
        direction=_zeros(S, dev, I32),
        score=torch.where(fired, local_score, 0.0),
        autotrade=_zeros(S, dev, torch.bool),  # telemetry only
        stop_loss_pct=_zeros(S, dev),
        diagnostics={
            "rsi": f.rsi,
            "mfi": f.mfi,
            "macd": f.macd,
            "adjusted_score": ev.adjusted_score,
            "route": route,
        },
    )


# ---------------------------------------------------------------------------
# RangeBbRsiMeanReversion
# ---------------------------------------------------------------------------


class RBRParams(NamedTuple):
    min_candles: int = 40
    adx_window: int = 14
    zscore_window: int = 20
    adx_max: float = 32.0
    long_rsi_max: float = 35.0
    short_rsi_min: float = 65.0
    long_zscore_max: float = -2.0
    short_zscore_min: float = 2.0
    band_touch_tolerance: float = 0.002
    max_market_stress: float = 0.35
    max_symbol_atr_pct: float = 0.04
    max_symbol_bb_width: float = 0.08
    min_rejection_wick_frac: float = 0.30
    long_close_position_min: float = 0.55
    short_close_position_max: float = 0.45


def _adx_rolling_sum(
    high: torch.Tensor, low: torch.Tensor, close: torch.Tensor, window: int
) -> torch.Tensor:
    """The strategy's own rolling-sum ADX (not Wilder's EWM); the last
    value, 100.0 where NaN."""
    hd = high - shift(high, 1)
    ld = shift(low, 1) - low
    plus_dm = torch.where((hd > ld) & (hd > 0), hd, 0.0)
    minus_dm = torch.where((ld > hd) & (ld > 0), ld, 0.0)
    pc = shift(close, 1)
    tr = torch.maximum(high - low, torch.maximum(torch.abs(high - pc), torch.abs(low - pc)))
    tr = torch.where(torch.isfinite(pc), tr, high - low)
    atr_sum = rolling_sum(tr, window)
    plus_di = 100.0 * jsafe_div(rolling_sum(plus_dm, window), atr_sum)
    minus_di = 100.0 * jsafe_div(rolling_sum(minus_dm, window), atr_sum)
    di_total = plus_di + minus_di
    dx = torch.where(
        di_total != 0,
        100.0 * torch.abs(plus_di - minus_di) / torch.where(di_total != 0, di_total, 1.0),
        0.0,
    )
    dx = torch.where(torch.isfinite(atr_sum), dx, NAN)
    adx = rolling_mean(dx, window)[:, -1]
    return torch.where(torch.isfinite(adx), adx, 100.0)


def range_bb_rsi_mean_reversion(
    buf15: MarketBuffer,
    pack15: FeaturePack,
    context: MarketContext,
    params: RBRParams = RBRParams(),
) -> StrategyOutputs:
    """A RANGE × RANGE fade with an ADX < 32 veto, a ±2σ z-score and
    wick-rejection candle filters; autotrade on when fired."""
    p = params
    f = pack15
    S = buf15.capacity
    dev = buf15.times.device
    high = buf15.values[:, :, Field.HIGH]
    low = buf15.values[:, :, Field.LOW]
    close = buf15.values[:, :, Field.CLOSE]

    feats = context.features
    trans = feats.micro_transition
    routing_ok = (
        context.valid
        & (context.market_stress_score < p.max_market_stress)
        & (context.market_regime == MarketRegimeCode.RANGE)
        & feats.valid
        & (feats.micro_regime == MicroRegimeCode.RANGE)
        & (trans != MicroTransitionCode.BREAKOUT_UP)
        & (trans != MicroTransitionCode.BREAKDOWN)
        & (trans != MicroTransitionCode.VOLATILITY_EXPANSION)
        & (feats.atr_pct <= p.max_symbol_atr_pct)
        & (feats.bb_width <= p.max_symbol_bb_width)
    )
    adx = _adx_rolling_sum(high, low, close, p.adx_window)
    adx_ok = adx <= p.adx_max

    mean = rolling_mean_last(close, p.zscore_window)
    std = rolling_std_last(close, p.zscore_window, ddof=0)
    z = torch.where(
        (std > 0) & torch.isfinite(std),
        (f.close - mean) / torch.where(std > 0, std, 1.0),
        0.0,
    )

    candle_range = f.high - f.low
    range_ok = candle_range > 0
    lower_wick = torch.minimum(f.open, f.close) - f.low
    upper_wick = f.high - torch.maximum(f.open, f.close)
    close_position = jsafe_div(f.close - f.low, candle_range)
    bullish_rej = (
        range_ok
        & (f.low <= f.bb_lower * (1.0 + p.band_touch_tolerance))
        & (f.close > f.open)
        & (jsafe_div(lower_wick, candle_range) >= p.min_rejection_wick_frac)
        & (close_position >= p.long_close_position_min)
    )
    bearish_rej = (
        range_ok
        & (f.high >= f.bb_upper * (1.0 - p.band_touch_tolerance))
        & (f.close < f.open)
        & (jsafe_div(upper_wick, candle_range) >= p.min_rejection_wick_frac)
        & (close_position <= p.short_close_position_max)
    )
    long_setup = (
        (f.close <= f.bb_mid) & (f.rsi <= p.long_rsi_max) & (z <= p.long_zscore_max)
        & bullish_rej
    )
    short_setup = (
        (f.close >= f.bb_mid) & (f.rsi >= p.short_rsi_min) & (z >= p.short_zscore_min)
        & bearish_rej
    )
    fired = (
        (f.filled >= p.min_candles) & torch.isfinite(f.rsi) & routing_ok & adx_ok
        & (long_setup | short_setup)
    )
    return StrategyOutputs(
        trigger=fired,
        direction=torch.where(
            short_setup, _code(Direction.SHORT, dev), _code(Direction.LONG, dev)
        ),
        score=_zeros(S, dev),
        autotrade=fired,
        stop_loss_pct=_zeros(S, dev),
        diagnostics={"adx": adx, "zscore": z, "rsi": f.rsi},
    )


# ---------------------------------------------------------------------------
# RangeFailedBreakoutFade
# ---------------------------------------------------------------------------


def range_failed_breakout_fade(
    spikes: SpikeSignal,
    context: MarketContext,
    avg_return_max: float = -0.005,
) -> StrategyOutputs:
    """Short a fresh bullish spike (any spike flag and an upward streak)
    when the market is RANGE, the average return under -0.5%, and the
    symbol an outperformer (RS >= 0)."""
    feats = context.features
    long_flags = (
        spikes.cumulative_price_break_flag
        | spikes.volume_cluster_flag
        | spikes.price_break_flag
        | spikes.accel_spike_flag
    )
    spike_ok = long_flags & spikes.upward
    routing_ok = (
        context.valid
        & (context.market_regime == MarketRegimeCode.RANGE)
        & (context.average_return < avg_return_max)
        & feats.valid
        & (feats.relative_strength_vs_btc >= 0)
    )
    fired = spike_ok & routing_ok
    S = spikes.close.shape[0]
    dev = spikes.close.device
    return StrategyOutputs(
        trigger=fired,
        direction=torch.full((S,), int(Direction.SHORT), dtype=I32, device=dev),
        score=_zeros(S, dev),
        autotrade=fired,
        stop_loss_pct=_zeros(S, dev),
        diagnostics={
            "volume_cluster_flag": spikes.volume_cluster_flag,
            "price_break_flag": spikes.price_break_flag,
            "cumulative_price_break_flag": spikes.cumulative_price_break_flag,
            "accel_spike_flag": spikes.accel_spike_flag,
            "volume": spikes.volume,
            "quote_asset_volume": spikes.quote_asset_volume,
        },
    )


# ---------------------------------------------------------------------------
# RelativeStrengthReversalRange
# ---------------------------------------------------------------------------


class RSRParams(NamedTuple):
    avg_return_max: float = -0.02
    rs_vs_btc_min: float = 0.05
    volume_percentile: float = 0.20
    volume_window: int = 96


def relative_strength_reversal_range(
    buf15: MarketBuffer,
    pack15: FeaturePack,
    context: MarketContext,
    params: RSRParams = RSRParams(),
) -> StrategyOutputs:
    """A contrarian long on an RS leader (> +5% vs BTC) during a broad
    selloff (average return < -2%), above the 20th percentile of the last
    24h's volume; telemetry only."""
    p = params
    S = buf15.capacity
    dev = buf15.times.device
    feats = context.features
    routing_ok = (
        context.valid
        & (context.market_regime == MarketRegimeCode.RANGE)
        & (context.average_return < p.avg_return_max)
        & feats.valid
        & (feats.relative_strength_vs_btc > p.rs_vs_btc_min)
    )

    volume = buf15.values[:, -p.volume_window:, Field.VOLUME]
    finite = torch.isfinite(volume)
    cnt = finite.sum(dim=-1, dtype=I32)
    s, _ = torch.sort(torch.where(finite, volume, float("inf")), dim=-1, stable=True)
    rank = p.volume_percentile * (cnt.to(F32) - 1.0)
    lo = torch.clamp(torch.floor(rank).to(I32), 0, p.volume_window - 1)
    hi = torch.clamp(lo + 1, 0, p.volume_window - 1)
    frac = rank - lo.to(F32)
    v_lo = torch.gather(s, -1, lo[:, None].long())[:, 0]
    v_hi = torch.gather(s, -1, torch.minimum(hi, torch.clamp(cnt - 1, min=0))[:, None].long())[:, 0]
    floor = v_lo + (v_hi - v_lo) * frac

    fired = (
        (pack15.filled >= p.volume_window) & routing_ok & (pack15.volume > floor)
        & pack15.valid
    )
    return StrategyOutputs(
        trigger=fired,
        direction=_zeros(S, dev, I32),
        score=_zeros(S, dev),
        autotrade=_zeros(S, dev, torch.bool),  # telemetry only
        stop_loss_pct=_zeros(S, dev),
        diagnostics={
            "volume_floor": torch.where(torch.isfinite(floor), floor, 0.0),
            "relative_strength_vs_btc": feats.relative_strength_vs_btc,
        },
    )
