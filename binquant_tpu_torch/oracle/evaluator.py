"""Per-symbol evaluation on the host: the legacy backend and the A/B oracle.

Port of ``binquant_tpu/oracle/evaluator.py`` with the same control flow: a
rolling store of each symbol's bars, indicators computed one symbol at a
time, a Python loop over the fresh symbols for the market context, and each
strategy evaluated per symbol with its cooldowns held in dicts. The
reference computes on pandas ``DataFrame`` columns; here each column is a
float64 numpy array and :mod:`binquant_tpu_torch.oracle.frame` gives the
pandas semantics the formulas read (rolling windows that skip NaN,
``ewm(adjust=False)``, the NaN-skipping row max).

It shares no code with the batched path (no ``ops``, ``strategies`` or
``engine`` module): it is the independent implementation the batched engine
is held to (:func:`binquant_tpu_torch.io.replay.run_replay_ab`), on the CPU
and on the card alike, and the ``--backend reference`` mode of the entry
point. It is deliberately not batched across symbols.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from datetime import datetime, timezone

import numpy as np

from binquant_tpu_torch.enums import (
    Direction,
    MarketRegimeCode,
    MicroRegimeCode,
    MicroTransitionCode,
)
from binquant_tpu_torch.oracle import frame as F
from binquant_tpu_torch.regime.time_filter import is_autotrade_suppressed
from binquant_tpu_torch.utils import clamp, non_negative, safe_pct

MIN_BARS = 100  # the context's MA-100 sufficiency
FIFTEEN_MIN_S = 900
FIVE_MIN_S = 300
REGIME_STABILITY_S = 30 * 60
TRANSITION_STRENGTH_FLOOR = 0.08

LIVE_STRATEGIES = (
    "activity_burst_pump",
    "coinrule_price_tracker",
    "liquidation_sweep_pump",
    "mean_reversion_fade",
    "grid_ladder",
)

# dormant strategies whose inline indicator variants (BuyTheDip's 6h dip
# reference, BBX's Connors RSI(2), RBR's rolling-sum ADX) carry the most
# formula-drift risk
DORMANT_ORACLE_STRATEGIES = (
    "coinrule_buy_the_dip",
    "bb_extreme_reversion",
    "range_bb_rsi_mean_reversion",
)

# the rest of the dormant set: with these every one of the 14 strategies has
# an oracle (RangeFailedBreakoutFade with the spike detector's flag pipeline)
DORMANT_ORACLE_EXTENDED = (
    "coinrule_twap_momentum_sniper",
    "coinrule_supertrend_swing_reversal",
    "coinrule_buy_low_sell_high",
    "inverse_price_tracker",
    "relative_strength_reversal_range",
    "range_failed_breakout_fade",
)

FIELDS = (
    "open", "high", "low", "close", "volume", "quote_asset_volume", "number_of_trades",
)
# the bars ActivityBurstPump's last four flags read: 3 before the last, the
# threshold's 80 scores before those (shifted by 1) and each score's baseline
# (the median of 19 volumes, shifted by 2)
ABP_TAIL = 4 + 80 + 1 + 19 + 2
# the bars LiquidationSweepPump reads: its 48 smoothed scores (2 bars each),
# each from a 6-bar volume mean shifted by 3 and 6-bar extremes
LSP_TAIL = 48 + 1 + 6 + 3


def _nz(x: float, default: float = 0.0) -> float:
    return float(x) if math.isfinite(float(x)) else default


def _last(roll: np.ndarray) -> float:
    return float(roll[-1]) if len(roll) else float("nan")


def _true_range(high: np.ndarray, low: np.ndarray, close: np.ndarray) -> np.ndarray:
    """max(h - l, |h - prev c|, |l - prev c|), NaN skipped: the first row is h - l."""
    pc = F.shift(close, 1)
    return F.row_max(high - low, np.abs(high - pc), np.abs(low - pc))


def _rsi14_sma(close: np.ndarray) -> float | None:
    """Simple-rolling-mean RSI(14), the plain RSI column every oracle strategy
    that reads one shares (MRF's Wilder variant stays inline there). None
    while the 14-bar warm-up is unmet."""
    delta = F.diff(close)
    avg_gain = _last(F.rolling(F.clip(delta, lower=0)[-14:], 14, 14).mean())
    avg_loss = _last(F.rolling(F.clip(-delta, lower=0)[-14:], 14, 14).mean())
    if not (math.isfinite(avg_gain) and math.isfinite(avg_loss)):
        return None
    denom = avg_gain + avg_loss
    return 100.0 * avg_gain / denom if denom != 0 else 50.0


# ---------------------------------------------------------------------------
# The rolling store (the reference's MarketStateStore: dedupe, sort, tail)
# ---------------------------------------------------------------------------


class Frame:
    """One symbol's bars, oldest first: ``open_time`` (int64 ms) and one
    float64 column per field, at most ``window`` rows. The column
    properties are views; readers must not write to them."""

    __slots__ = ("_times", "_vals", "_lo", "_hi", "window")

    def __init__(self, window: int) -> None:
        self.window = window
        self._times = np.zeros(2 * window, dtype=np.int64)
        self._vals = np.zeros((len(FIELDS), 2 * window), dtype=np.float64)
        self._lo = self._hi = 0

    def __len__(self) -> int:
        return self._hi - self._lo

    open = property(lambda self: self._vals[0, self._lo:self._hi])
    high = property(lambda self: self._vals[1, self._lo:self._hi])
    low = property(lambda self: self._vals[2, self._lo:self._hi])
    close = property(lambda self: self._vals[3, self._lo:self._hi])
    volume = property(lambda self: self._vals[4, self._lo:self._hi])
    quote_asset_volume = property(lambda self: self._vals[5, self._lo:self._hi])
    number_of_trades = property(lambda self: self._vals[6, self._lo:self._hi])
    open_time = property(lambda self: self._times[self._lo:self._hi])

    def put(self, open_time: int, row: tuple) -> None:
        """The reference's update: a row with the same ``open_time`` is
        replaced, the rows stay sorted by time, and only the newest
        ``window`` are kept (a late bar lands in the middle, or is dropped
        when it is older than every row of a full store)."""
        lo, hi = self._lo, self._hi
        if hi == lo or open_time > self._times[hi - 1]:  # the common case
            if hi == len(self._times):
                n = hi - lo
                self._times[:n] = self._times[lo:hi]
                self._vals[:, :n] = self._vals[:, lo:hi]
                lo, hi = 0, n
            self._times[hi] = open_time
            self._vals[:, hi] = row
            hi += 1
            self._lo, self._hi = max(lo, hi - self.window), hi
            return
        times = self._times[lo:hi]
        pos = int(np.searchsorted(times, open_time))
        if pos < len(times) and times[pos] == open_time:  # a correction
            self._vals[:, lo + pos] = row
            return
        times = np.insert(times, pos, open_time)[-self.window:]
        vals = np.insert(self._vals[:, lo:hi], pos, row, axis=1)[:, -self.window:]
        n = len(times)
        self._times[:n] = times
        self._vals[:, :n] = vals
        self._lo, self._hi = 0, n


class FrameStore:
    def __init__(self, window: int) -> None:
        self.window = window
        self.frames: dict[str, Frame] = {}

    def update(self, kline: dict) -> None:
        sym = kline["symbol"]
        frame = self.frames.get(sym)
        if frame is None:
            frame = self.frames[sym] = Frame(self.window)
        frame.put(int(kline["open_time"]), (
            float(kline["open"]), float(kline["high"]), float(kline["low"]),
            float(kline["close"]), float(kline["volume"]), float(kline["quote_asset_volume"]),
            float(kline["number_of_trades"]),
        ))  # FIELDS' order

    def fresh(self, ts_s: int) -> list[str]:
        return [
            s for s, frame in self.frames.items()
            if int(frame._times[frame._hi - 1]) // 1000 == ts_s
        ]


# ---------------------------------------------------------------------------
# Market context (accumulator and regime transitions, a per-symbol loop)
# ---------------------------------------------------------------------------


@dataclass
class SymbolFeatures:
    valid: bool = False
    close: float = 0.0
    return_pct: float = 0.0
    ema20: float = 0.0
    ema50: float = 0.0
    above_ema20: bool = False
    above_ema50: bool = False
    trend_score: float = 0.0
    relative_strength_vs_btc: float = 0.0
    atr_pct: float = 0.0
    bb_width: float = 0.0
    micro_regime: int = -1
    micro_strength: float = 0.0
    micro_transition: int = -1


@dataclass
class OracleContext:
    valid: bool = False
    timestamp: int = -1
    advancers_ratio: float = 0.0
    pct_above_ema20: float = 0.0
    pct_above_ema50: float = 0.0
    average_trend_score: float = 0.0
    average_return: float = 0.0
    market_stress_score: float = 0.0
    btc_regime_score: float = 0.0
    long_tailwind: float = 0.0
    short_tailwind: float = 0.0
    market_regime: int = -1
    market_regime_transition_strength: float = 0.0
    regime_is_transitioning: bool = False
    regime_stable_since: int = -1
    long_regime_score: float = 0.0
    short_regime_score: float = 0.0
    range_regime_score: float = 0.0
    stress_regime_score: float = 0.0
    features: dict[str, SymbolFeatures] = field(default_factory=dict)


def _symbol_features(df: Frame) -> SymbolFeatures | None:
    """The accumulator's per-symbol features; None under two bars."""
    if len(df) < 2:
        return None
    close = df.close
    latest = float(close[-1])
    prev = float(close[-2])
    ema20 = float(F.ewm_mean(close, span=20, min_periods=1)[-1])
    ema50 = float(F.ewm_mean(close, span=50, min_periods=1)[-1])
    tr = _true_range(df.high[-15:], df.low[-15:], close[-15:])
    atr = _last(F.rolling(tr[-14:], 14, 1).mean())
    last20 = F.rolling(close[-20:], 20, 1)
    mid = _last(last20.mean())
    std = _nz(_last(last20.std(ddof=0)), 0.0)
    bb_upper, bb_lower = mid + 2 * std, mid - 2 * std
    return SymbolFeatures(
        valid=True,
        close=latest,
        return_pct=safe_pct(latest, prev),
        ema20=ema20,
        ema50=ema50,
        above_ema20=latest > ema20,
        above_ema50=latest > ema50,
        trend_score=(ema20 - ema50) / abs(ema50) if ema50 != 0 else 0.0,
        atr_pct=atr / latest if latest != 0 else 0.0,
        bb_width=(bb_upper - bb_lower) / abs(mid) if mid != 0 else 0.0,
    )


def _micro_scores(f: SymbolFeatures) -> tuple[int, float]:
    """The per-symbol regime ladder."""
    up = clamp(
        0.45 * non_negative(f.trend_score * 30.0)
        + 0.2 * float(f.above_ema20)
        + 0.15 * float(f.above_ema50)
        + 0.2 * non_negative(f.relative_strength_vs_btc * 20.0),
        0.0,
        1.0,
    )
    down = clamp(
        0.45 * non_negative(-f.trend_score * 30.0)
        + 0.2 * float(not f.above_ema20)
        + 0.15 * float(not f.above_ema50)
        + 0.2 * non_negative(-f.relative_strength_vs_btc * 20.0),
        0.0,
        1.0,
    )
    rng = clamp(
        0.38 * (1.0 - min(abs(f.trend_score) * 30.0, 1.0))
        + 0.34 * (1.0 - min(f.bb_width / 0.08, 1.0))
        + 0.28 * (1.0 - min(f.atr_pct / 0.04, 1.0)),
        0.0,
        1.0,
    )
    vol = clamp(
        0.55 * min(f.atr_pct / 0.05, 1.0) + 0.45 * min(f.bb_width / 0.12, 1.0),
        0.0,
        1.0,
    )
    strength = max(up, down, rng, vol)
    if vol >= 0.72 and abs(f.return_pct) >= 0.015:
        regime = int(MicroRegimeCode.VOLATILE)
    elif up >= 0.52 and up >= down + 0.1:
        regime = int(MicroRegimeCode.TREND_UP)
    elif down >= 0.52 and down >= up + 0.1:
        regime = int(MicroRegimeCode.TREND_DOWN)
    elif rng >= 0.5:
        regime = int(MicroRegimeCode.RANGE)
    else:
        regime = int(MicroRegimeCode.TRANSITIONAL)
    return regime, strength


def _micro_transition(prev: int, regime: int) -> int:
    T, R = MicroTransitionCode, MicroRegimeCode
    from_range_like = prev in (int(R.RANGE), int(R.TRANSITIONAL))
    if regime == int(R.VOLATILE):
        return int(T.VOLATILITY_EXPANSION)
    if from_range_like and regime == int(R.TREND_UP):
        return int(T.BREAKOUT_UP)
    if from_range_like and regime == int(R.TREND_DOWN):
        return int(T.BREAKDOWN)
    if prev == int(R.TREND_DOWN) and regime == int(R.TREND_UP):
        return int(T.RECOVERY)
    if prev == int(R.TREND_UP) and regime == int(R.RANGE):
        return int(T.MEAN_REVERSION)
    if regime == int(R.TREND_UP):
        return int(T.ENTERED_TREND_UP)
    if regime == int(R.TREND_DOWN):
        return int(T.ENTERED_TREND_DOWN)
    if regime == int(R.RANGE):
        return int(T.ENTERED_RANGE)
    return int(T.ENTERED_TRANSITIONAL)


# ---------------------------------------------------------------------------
# Context-conditioned scoring
# ---------------------------------------------------------------------------


def _context_score(
    ctx: OracleContext, is_short: bool, symbol_rs: float, symbol_trend: float
) -> dict:
    confidence = 1.0 if ctx.valid else 0.0
    breadth = ctx.short_tailwind if is_short else ctx.long_tailwind
    btc_align = clamp(-ctx.btc_regime_score if is_short else ctx.btc_regime_score)
    rs_signed = -symbol_rs if is_short else symbol_rs
    trend_signed = -symbol_trend if is_short else symbol_trend
    cross_asset = clamp(0.6 * rs_signed + 0.4 * trend_signed)
    override = clamp(
        0.6 * non_negative(rs_signed) + 0.4 * non_negative(trend_signed), 0.0, 1.0
    )
    directional_stress = (
        ctx.market_stress_score * 0.35 if is_short else -ctx.market_stress_score
    )
    supportiveness = clamp(
        0.35 * breadth + 0.25 * btc_align + 0.25 * cross_asset
        + 0.15 * directional_stress
    )
    followthrough = clamp(0.45 * breadth + 0.3 * btc_align + 0.25 * cross_asset)
    risk = clamp(
        0.55 * ctx.market_stress_score
        + 0.25 * non_negative(-supportiveness)
        + 0.2 * (1.0 - override),
        0.0,
        1.0,
    )
    if breadth < 0 and override > 0:
        if not is_short:
            supportiveness = clamp(supportiveness + 0.2 * override)
            followthrough = clamp(followthrough + 0.15 * override)
        else:
            supportiveness = clamp(supportiveness + 0.1 * override)
    z = confidence
    return {
        "confidence": confidence,
        "followthrough": followthrough * z,
        "risk": risk * z,
        "supportiveness": supportiveness * z,
    }


def _allows_long_autotrade(ctx: OracleContext, sym: str) -> bool:
    """The long-autotrade regime routing for one symbol."""
    if not ctx.valid or ctx.regime_is_transitioning:
        return False
    if ctx.regime_stable_since < 0:
        return False
    age = max(ctx.timestamp - ctx.regime_stable_since, 0)
    if age < REGIME_STABILITY_S:
        return False
    market_regime_ok = ctx.market_regime in (
        int(MarketRegimeCode.TREND_UP),
        int(MarketRegimeCode.RANGE),
    )
    if not market_regime_ok or ctx.market_stress_score >= 0.35:
        return False
    f = ctx.features.get(sym)
    if f is None or not f.valid or f.micro_regime < 0:
        return market_regime_ok
    if f.micro_regime == int(MicroRegimeCode.TREND_DOWN):
        return f.micro_transition == int(MicroTransitionCode.RECOVERY)
    if f.micro_regime == int(MicroRegimeCode.VOLATILE):
        return False
    return f.micro_regime in (
        int(MicroRegimeCode.TREND_UP),
        int(MicroRegimeCode.RANGE),
        int(MicroRegimeCode.TRANSITIONAL),
    )


def _macd_line(close: np.ndarray) -> float:
    """The last MACD line value, EMA12 - EMA26."""
    fast = F.ewm_mean(close, span=12, min_periods=1)
    return float((fast - F.ewm_mean(close, span=26, min_periods=1))[-1])


def _mfi14(df: Frame) -> float | None:
    """The last 14 typical-price moves' money-flow index; None while one of
    them is missing."""
    tp = (df.high + df.low + df.close) / 3.0
    flow = tp * df.volume
    last14 = F.diff(tp)[-14:]
    if np.isnan(last14).any() or len(last14) < 14:
        return None
    pos = float(flow[-14:][last14 > 0].sum())
    neg = float(flow[-14:][last14 < 0].sum())
    total = pos + neg
    return 100.0 * pos / total if total != 0 else 50.0


def _oversold(df: Frame) -> bool:
    """PriceTracker's oversold trio on the 5m bars: RSI(14) under 30, the MACD
    line under 0, MFI(14) under 20 (the MACD, two EWMs over the whole store,
    only once RSI has passed)."""
    rsi = _rsi14_sma(df.close)
    mfi = _mfi14(df) if rsi is not None else None
    return mfi is not None and rsi < 30.0 and _macd_line(df.close) < 0.0 and mfi < 20.0


def _short_trend(close: np.ndarray) -> float:
    """(EMA9 - EMA21) / |EMA21|, the telemetry gates' trend."""
    ema9 = float(F.ewm_mean(close, span=9, min_periods=1)[-1])
    ema21 = float(F.ewm_mean(close, span=21, min_periods=1)[-1])
    return (ema9 - ema21) / abs(ema21) if ema21 != 0 else 0.0


def _bands20(close: np.ndarray) -> tuple[float, float]:
    """The last 20-bar mean and population std (NaN until 20 bars)."""
    last20 = F.rolling(close[-20:], 20)
    return _last(last20.mean()), _last(last20.std(ddof=0))


# ---------------------------------------------------------------------------
# The evaluator
# ---------------------------------------------------------------------------


class OracleEvaluator:
    """A reference-shaped engine: ingest klines, evaluate per tick, emit
    (strategy, symbol, direction, autotrade) tuples."""

    def __init__(
        self,
        window: int = 200,
        btc_symbol: str = "BTCUSDT",
        required_fresh_symbols: int = 40,
        min_coverage_ratio: float = 0.70,
        is_futures: bool = True,
        enabled_strategies: set[str] | frozenset[str] | tuple | None = None,
    ) -> None:
        self.store5 = FrameStore(window)
        self.store15 = FrameStore(window)
        self.btc_symbol = btc_symbol
        self.required_fresh = required_fresh_symbols
        self.min_coverage = min_coverage_ratio
        self.is_futures = is_futures
        self.enabled = frozenset(
            LIVE_STRATEGIES if enabled_strategies is None else enabled_strategies
        )
        # the regime carry: previous (strictly older ts) and stage (current ts)
        self._prev_market: tuple[int, tuple, int] | None = None  # regime, scores, since
        self._prev_micro: dict[str, tuple[int, float]] = {}
        self._stage_ts: int = -1
        self._stage_market: tuple[int, tuple, int] | None = None
        self._stage_micro: dict[str, tuple[int, float]] = {}
        # the strategies' carries
        self.pt_last_close: dict[str, int] = {}
        self.mrf_last_open: dict[str, int] = {}
        self.last_emitted: dict[tuple[str, str], int] = {}
        # the most recent VALID regime: the grid-only policy's input next
        # tick (the quiet-hours override reads the current tick's context)
        self._last_regime: int | None = None
        self._last_strength: float = 0.0

    @property
    def last_regime(self) -> int | None:
        """The last evaluation's market regime; None when its context failed
        coverage."""
        return self._last_regime

    @property
    def last_strength(self) -> float:
        """The last evaluation's regime-transition strength (0.0 when its
        context was invalid), paired with :attr:`last_regime`."""
        return self._last_strength

    # -- ingest ------------------------------------------------------------

    def ingest(self, kline: dict) -> None:
        duration_s = (int(kline["close_time"]) - int(kline["open_time"])) // 1000
        if abs(duration_s - FIVE_MIN_S) <= 1:
            self.store5.update(kline)
        elif abs(duration_s - FIFTEEN_MIN_S) <= 1:
            self.store15.update(kline)

    # -- context -----------------------------------------------------------

    def _build_context(self, ts15: int) -> OracleContext:
        # promote the stage when a strictly newer timestamp arrives
        if ts15 > self._stage_ts:
            if self._stage_market is not None:
                self._prev_market = self._stage_market
            self._prev_micro.update(self._stage_micro)
            self._stage_market = None
            self._stage_micro = {}
            self._stage_ts = ts15

        tracked = set(self.store5.frames) | set(self.store15.frames)
        fresh = self.store15.fresh(ts15)  # always a subset of tracked
        feats: dict[str, SymbolFeatures] = {}
        for sym in fresh:
            f = _symbol_features(self.store15.frames[sym])
            if f is not None:
                feats[sym] = f

        # BTC's features from its frame whether it is fresh or not
        btc_df = self.store15.frames.get(self.btc_symbol)
        btc_present = btc_df is not None and len(btc_df) >= 2
        btc_f = _symbol_features(btc_df) if btc_present else None
        btc_return = btc_f.return_pct if btc_f else 0.0
        btc_trend = btc_f.trend_score if btc_f else 0.0

        for sym, f in feats.items():
            if btc_present and sym != self.btc_symbol:
                f.relative_strength_vs_btc = f.return_pct - btc_return

        effective = len(feats)
        total_tracked = max(len(tracked), effective)
        ctx = OracleContext(timestamp=ts15, features=feats)
        vals = list(feats.values())
        n = max(effective, 1)
        advancers = sum(1 for f in vals if f.return_pct > 0)
        decliners = sum(1 for f in vals if f.return_pct < 0)
        ctx.advancers_ratio = advancers / n
        decliners_ratio = decliners / n
        ctx.average_return = sum(f.return_pct for f in vals) / n
        ctx.pct_above_ema20 = sum(f.above_ema20 for f in vals) / n
        ctx.pct_above_ema50 = sum(f.above_ema50 for f in vals) / n
        ctx.average_trend_score = sum(f.trend_score for f in vals) / n
        average_atr_pct = sum(f.atr_pct for f in vals) / n
        average_bb_width = sum(f.bb_width for f in vals) / n

        breadth_balance = clamp((ctx.advancers_ratio - decliners_ratio) * 1.5)
        ema_balance = clamp(
            ((ctx.pct_above_ema20 + ctx.pct_above_ema50) - 1.0) * 1.5
        )
        average_return_score = clamp(ctx.average_return * 12.0)
        ctx.btc_regime_score = (
            clamp(btc_return * 12.0 + btc_trend * 6.0) if btc_present else 0.0
        )
        stress_vol = clamp((average_atr_pct - 0.02) * 12.0, 0.0, 1.0)
        stress_bw = clamp((average_bb_width - 0.08) * 4.0, 0.0, 1.0)
        stress_sell = clamp((-ctx.average_return) * 16.0, 0.0, 1.0)
        ctx.market_stress_score = (
            0.4 * stress_vol + 0.25 * stress_bw + 0.35 * stress_sell
        )
        ctx.long_tailwind = clamp(
            0.4 * breadth_balance
            + 0.2 * ema_balance
            + 0.25 * ctx.btc_regime_score
            + 0.15 * average_return_score
            - 0.35 * ctx.market_stress_score
        )
        ctx.short_tailwind = clamp(
            -0.35 * breadth_balance
            - 0.15 * ema_balance
            - 0.2 * ctx.btc_regime_score
            - 0.15 * average_return_score
            + 0.45 * ctx.market_stress_score
        )

        # effective >= required implies both the fresh-count and the
        # coverage-ratio gates (required is the larger threshold)
        required = max(
            self.required_fresh, math.ceil(total_tracked * self.min_coverage)
        )
        ctx.valid = total_tracked > 0 and effective >= required

        # --- the macro ladder and its transition
        R = MarketRegimeCode
        breadth_score = clamp((ctx.advancers_ratio - 0.5) / 0.25)
        trend_participation = clamp(
            ((ctx.pct_above_ema20 + ctx.pct_above_ema50) - 1.0) * 1.4
        )
        avg_trend_bias = clamp(ctx.average_trend_score * 20.0)
        calm = clamp(1.0 - ctx.market_stress_score, 0.0, 1.0)
        long_score = clamp(
            0.3 * non_negative(ctx.long_tailwind)
            + 0.24 * non_negative(ctx.btc_regime_score)
            + 0.2 * non_negative(breadth_score)
            + 0.14 * non_negative(trend_participation)
            + 0.12 * calm,
            0.0,
            1.0,
        )
        short_score = clamp(
            0.28 * non_negative(ctx.short_tailwind)
            + 0.24 * non_negative(-ctx.btc_regime_score)
            + 0.16 * non_negative(-breadth_score)
            + 0.1 * non_negative(-avg_trend_bias)
            + 0.22 * ctx.market_stress_score,
            0.0,
            1.0,
        )
        range_score = clamp(
            0.32 * (1.0 - abs(breadth_score))
            + 0.22 * (1.0 - abs(ctx.btc_regime_score))
            + 0.24 * calm
            + 0.12 * (1.0 - abs(avg_trend_bias))
            + 0.1 * (1.0 - abs(ctx.long_tailwind - ctx.short_tailwind)),
            0.0,
            1.0,
        )
        stress_score = clamp(
            0.7 * ctx.market_stress_score
            + 0.18 * non_negative(-ctx.average_return * 20.0)
            + 0.12 * non_negative(short_score - long_score),
            0.0,
            1.0,
        )
        dominant = max(long_score, short_score, range_score, stress_score)
        if stress_score >= 0.5 and ctx.market_stress_score >= 0.35:
            regime = int(R.HIGH_STRESS)
        elif long_score >= 0.44 and long_score >= short_score + 0.08:
            regime = int(R.TREND_UP)
        elif short_score >= 0.42 and short_score >= long_score + 0.08:
            regime = int(R.TREND_DOWN)
        elif range_score >= 0.5:
            regime = int(R.RANGE)
        else:
            regime = int(R.TRANSITIONAL)
        ctx.long_regime_score = long_score
        ctx.short_regime_score = short_score
        ctx.range_regime_score = range_score
        ctx.stress_regime_score = stress_score
        ctx.market_regime = regime

        prev = self._prev_market
        changed = prev is not None and prev[0] != regime
        scores = (long_score, short_score, range_score, stress_score)
        if changed:
            max_delta = max(abs(a - b) for a, b in zip(scores, prev[1]))
            strength = clamp(dominant + max_delta - 0.25, 0.0, 1.0)
        else:
            strength = 0.0
        ctx.market_regime_transition_strength = strength
        ctx.regime_is_transitioning = regime == int(R.TRANSITIONAL) or (
            changed and strength >= TRANSITION_STRENGTH_FLOOR
        )
        keep_anchor = prev is not None and prev[0] == regime and prev[2] >= 0
        ctx.regime_stable_since = prev[2] if keep_anchor else ts15

        # --- the micro ladders and their transitions against the carry
        for sym, f in feats.items():
            m_regime, m_strength = _micro_scores(f)
            f.micro_regime = m_regime
            f.micro_strength = m_strength
            p = self._prev_micro.get(sym)
            if p is not None and p[0] >= 0 and p[0] != m_regime:
                f.micro_transition = _micro_transition(p[0], m_regime)
            else:
                f.micro_transition = -1

        # --- only a valid evaluation is staged
        if ctx.valid:
            self._stage_market = (regime, scores, ctx.regime_stable_since)
            for sym, f in feats.items():
                self._stage_micro[sym] = (f.micro_regime, f.micro_strength)
        return ctx

    # -- strategies --------------------------------------------------------

    def _abp(self, sym: str, ctx: OracleContext) -> tuple[bool, bool] | None:
        """ActivityBurstPump: (fired, autotrade)."""
        df = self.store5.frames[sym]
        if len(df) < 21:
            return None
        has_qav = bool((df.quote_asset_volume > 0).any())
        # the flags are read at the last 4 bars, whose thresholds read the
        # scores of the 80 bars before, whose baselines read 21 bars more:
        # the series are computed over that tail, every value read the same
        t = ABP_TAIL
        volume, qav = df.volume[-t:], df.quote_asset_volume[-t:]
        close, open_ = df.close[-t:], df.open[-t:]
        high, low = df.high[-t:], df.low[-t:]
        eps = 1e-8
        bw = 19
        with np.errstate(invalid="ignore", divide="ignore"):
            baseline = F.rolling(F.shift(volume, 2), bw, bw).median()
            baseline_safe = F.clip(baseline, lower=eps)
            volume_ratio = volume / baseline_safe
            q_baseline = F.clip(F.rolling(F.shift(qav, 2), bw, bw).median(), lower=eps)
            quote_ratio = qav / q_baseline
            prev_close = F.clip(F.shift(close, 1), lower=eps)
            candle_range = F.clip(high - low, lower=eps)
            body = np.abs(close - open_)
            price_jump = (close - F.shift(close, 1)) / prev_close
            range_frac = candle_range / F.clip(close, lower=eps)
            body_frac = body / candle_range
            close_to_high = (high - close) / candle_range
            is_bullish = close > open_
            up_close = (close > F.shift(close, 1)).astype(np.float64)
            recent_up = F.rolling(up_close, 3, 1).sum()

            vol_spike = volume > 2.75 * baseline_safe
            quote_spike = qav > 2.5 * q_baseline if has_qav else True
            jump_flag = price_jump > 0.01
            range_flag = range_frac > 0.012
            body_flag = is_bullish & (body_frac > 0.45) & (close_to_high < 0.35)
            trend_flag = recent_up >= (2 if has_qav else 1)
            if has_qav:
                score = volume_ratio * quote_ratio * F.clip(price_jump, lower=0) * (1 + body_frac)
            else:
                score = volume_ratio * F.clip(price_jump, lower=0)
            threshold = F.rolling(F.shift(score, 1), 80, 20).quantile(0.92)
            raw = (
                vol_spike & quote_spike & jump_flag & range_flag & body_flag
                & trend_flag & ~np.isnan(score)
                & (score >= np.where(np.isnan(threshold), 0.0, threshold))
            )
        qualified = bool(raw[-1]) and not bool(raw[-4:-1].any())
        if not qualified:
            return None
        # the context gate
        gate = _allows_long_autotrade(ctx, sym)
        if ctx.valid and not gate:
            return None
        return True, ctx.valid and gate

    def _pt(self, sym: str, ctx: OracleContext, quiet: bool) -> tuple[bool, bool] | None:
        """Coinrule PriceTracker: (fired, autotrade)."""
        df = self.store5.frames[sym]
        if len(df) < 30 or not ctx.valid:
            return None
        if not _oversold(df):
            return None
        # the telemetry gates
        trend_score = _short_trend(df.close)
        f = ctx.features.get(sym)
        rs = f.relative_strength_vs_btc if f else 0.0
        cs = _context_score(ctx, is_short=False, symbol_rs=rs, symbol_trend=trend_score)
        if not (
            cs["followthrough"] >= -0.2
            and cs["risk"] <= 0.6
            and cs["confidence"] >= 0.5
        ):
            return None
        # the cooldown, on the bar's close time
        close_time = int(df.open_time[-1]) // 1000 + FIVE_MIN_S
        last = self.pt_last_close.get(sym)
        if last is not None and 0 <= close_time - last < 12 * FIVE_MIN_S:
            return None
        self.pt_last_close[sym] = close_time
        # the routing
        stable_breadth = (
            0.48 <= ctx.advancers_ratio <= 0.62
            and abs(ctx.long_tailwind - ctx.short_tailwind) <= 0.35
        )
        autotrade = (
            not ctx.regime_is_transitioning
            and ctx.market_stress_score < 0.3
            and stable_breadth
            and ctx.market_regime == int(MarketRegimeCode.RANGE)
            and f is not None
            and f.valid
            and f.micro_regime >= 0
            and f.micro_transition
            not in (
                int(MicroTransitionCode.BREAKDOWN),
                int(MicroTransitionCode.VOLATILITY_EXPANSION),
            )
            and rs > 0.005
            and f.micro_regime == int(MicroRegimeCode.RANGE)
        )
        return True, autotrade and not quiet

    def _lsp(
        self,
        sym: str,
        ctx: OracleContext,
        oi_growth: float,
        adp_latest: float,
        adp_prev: float,
        btc_momentum: float,
    ) -> tuple[bool, bool, int] | None:
        """LiquidationSweepPump: (fired, autotrade, direction)."""
        df = self.store15.frames[sym]
        wh = 3
        t = LSP_TAIL  # the bars its last 48 smoothed scores read
        volume, close = df.volume[-t:], df.close[-t:]
        high, low = df.high[-t:], df.low[-t:]
        with np.errstate(invalid="ignore", divide="ignore"):
            rel_volume = volume / F.shift(F.rolling(volume, wh * 2).mean(), wh)
            momentum = close / F.shift(close, wh) - 1.0
            range_frac = (
                F.rolling(high, wh * 2).max() - F.rolling(low, wh * 2).min()
            ) / close
            oi_factor = 1.0 + max(0.0, oi_growth - 1.0) if math.isfinite(oi_growth) else 1.0
            pump_score = rel_volume * (1.0 + momentum) * oi_factor / range_frac
            smooth = F.rolling(pump_score, 2).mean()
        recent = smooth[-48:]
        finite = recent[np.isfinite(recent)]
        latest_smooth = float(smooth[-1]) if len(smooth) else float("nan")
        if not (math.isfinite(latest_smooth) and len(finite)):
            return None
        threshold = float(np.quantile(finite, 0.80))
        trigger_score = max(latest_smooth, _nz(pump_score[-1], -np.inf))
        if trigger_score < threshold:
            return None
        if math.isfinite(oi_growth) and oi_growth < 1.02:
            return None
        # the breadth-fade routing
        if not ctx.valid or ctx.market_stress_score >= 0.35:
            return None
        has_pair = math.isfinite(adp_prev)
        falling = has_pair and adp_latest < adp_prev
        increasing = has_pair and adp_latest > adp_prev
        btc_stalled = abs(btc_momentum) <= 0.002
        f = ctx.features.get(sym)
        weak = (
            f is not None
            and f.valid
            and f.relative_strength_vs_btc <= 0
            and (
                f.trend_score <= 0
                or not f.above_ema20
                or f.micro_regime != int(MicroRegimeCode.TREND_UP)
            )
        )
        hot = adp_latest > 0.3
        washed = adp_latest <= -0.4
        short_ok = hot and falling and btc_stalled and f is not None and f.valid and weak
        long_ok = washed and increasing and btc_momentum > 0
        if not (short_ok or long_ok):
            return None
        direction = int(Direction.SHORT) if short_ok else int(Direction.LONG)
        return True, True, direction

    def _mrf(self, sym: str) -> tuple[bool, bool, int] | None:
        """MeanReversionFade: (fired, autotrade, direction)."""
        if not self.is_futures:
            return None
        df = self.store15.frames[sym]
        close, open_ = df.close, df.open
        delta = F.diff(close)
        avg_gain = F.ewm_mean(F.clip(delta, lower=0), alpha=1 / 14, min_periods=14)[-1]
        avg_loss = F.ewm_mean(F.clip(-delta, lower=0), alpha=1 / 14, min_periods=14)[-1]
        volume_ma = _last(F.rolling(df.volume[-20:], 20).mean())
        tr = _true_range(df.high[-35:], df.low[-35:], close[-35:])[1:]
        atr_series = F.rolling(tr, 14).mean()
        atr = atr_series[-1]
        atr_ma = _last(F.rolling(atr_series[-20:], 20).mean())
        if not all(
            math.isfinite(_nz(v, np.nan))
            for v in (avg_gain, avg_loss, volume_ma, atr, atr_ma)
        ):
            return None
        denom = avg_gain + avg_loss
        rsi = 100.0 * avg_gain / denom if denom != 0 else 50.0
        if not (atr < 2.0 * atr_ma):
            return None
        if not (df.volume[-1] >= volume_ma):
            return None
        mid, std = _bands20(close)
        if not (math.isfinite(mid) and math.isfinite(std)):
            return None
        bb_upper, bb_lower = mid + 2 * std, mid - 2 * std
        c, o = float(close[-1]), float(open_[-1])
        long_setup = rsi <= 25.0 and c <= bb_lower and c > o
        short_setup = rsi >= 75.0 and c >= bb_upper and c < o
        if not (long_setup or short_setup):
            return None
        open_time = int(df.open_time[-1]) // 1000
        if self.mrf_last_open.get(sym) == open_time:
            return None
        self.mrf_last_open[sym] = open_time
        direction = int(Direction.SHORT) if short_setup else int(Direction.LONG)
        return True, True, direction

    def _ladder(
        self, sym: str, ctx: OracleContext, grid_policy_allows: bool
    ) -> tuple[bool, bool] | None:
        """The grid LadderDeployer: (fired, autotrade)."""
        if not (self.is_futures and grid_policy_allows and ctx.valid):
            return None
        f = ctx.features.get(sym)
        if f is None or not f.valid:
            return None
        if f.micro_regime not in (
            int(MicroRegimeCode.RANGE),
            int(MicroRegimeCode.TRANSITIONAL),
        ):
            return None
        if f.micro_transition in (
            int(MicroTransitionCode.BREAKDOWN),
            int(MicroTransitionCode.VOLATILITY_EXPANSION),
            int(MicroTransitionCode.ENTERED_TREND_DOWN),
        ):
            return None
        if ctx.long_regime_score < 0.2:
            return None
        df = self.store15.frames[sym]
        if len(df) < 27:
            return None
        close = df.close
        roll = F.rolling(close[-27:], 20)  # the last 8 widths read 27 bars
        mid = roll.mean()
        std = roll.std(ddof=0)
        with np.errstate(invalid="ignore", divide="ignore"):
            widths = ((mid + 2 * std) - (mid - 2 * std)) / mid
        w = widths[-8:]
        with np.errstate(invalid="ignore"):
            if len(w) < 8 or not bool((np.isfinite(w) & (w > 0)).all()):
                return None
        change_pct = abs(
            (float(w[-1]) - float(w[0])) / (float(w[0]) if w[0] != 0 else 1.0)
        ) * 100.0
        if change_pct > 20.0:
            return None
        range_low = float((mid - 2 * std)[-1])
        range_high = float((mid + 2 * std)[-1])
        price = float(close[-1])
        if not (range_low < price < range_high):
            return None
        bb_mid = float(mid[-1])
        width_pct = (range_high - range_low) / bb_mid * 100.0 if bb_mid > 0 else 0.0
        if not (1.5 <= width_pct <= 8.0):
            return None
        return True, True

    # -- the dormant set ---------------------------------------------------

    def _btd(
        self, sym: str, ctx: OracleContext, quiet: bool
    ) -> tuple[bool, bool] | None:
        """Coinrule BuyTheDip: a -2..-5% dip over 24 15m bars and a reclaim
        of the previous close AND EMA20; trend regimes blocked;
        RANGE/TRANSITIONAL autotrade."""
        df = self.store15.frames[sym]
        lookback = 24
        if len(df) <= lookback:
            return None
        # the go-live gate (2026-04-12 23:21 UTC, on the bar's close time)
        if int(df.open_time[-1]) // 1000 + 900 < 1_776_036_060:
            return None
        close = df.close
        current = float(close[-1])
        reference = float(close[-1 - lookback])
        if not math.isfinite(reference) or reference == 0:
            return None
        change_6h = (current - reference) / abs(reference) * 100.0
        if not (-5.0 < change_6h <= -2.0):
            return None
        ema20 = float(F.ewm_mean(close, span=20, min_periods=1)[-1])
        prev_close = float(close[-2])
        if not (current > prev_close and current > ema20):
            return None
        f = ctx.features.get(sym)
        R, M = MarketRegimeCode, MicroRegimeCode
        market_trend_blocked = ctx.valid and ctx.market_regime in (
            int(R.TREND_DOWN), int(R.TREND_UP),
        )
        symbol_trend_blocked = (
            f is not None
            and f.valid
            and f.micro_regime in (int(M.TREND_DOWN), int(M.TREND_UP))
        )
        if market_trend_blocked or symbol_trend_blocked:
            return None
        market_rt = ctx.market_regime in (int(R.RANGE), int(R.TRANSITIONAL))
        if f is not None and f.valid:
            micro_blocked = f.micro_regime in (
                int(M.TREND_DOWN), int(M.TREND_UP), int(M.VOLATILE),
            )
            micro_ok = (
                not micro_blocked
                and f.micro_regime in (int(M.RANGE), int(M.TRANSITIONAL))
            )
        else:
            micro_ok = True
        autotrade = (
            ctx.valid
            and not ctx.regime_is_transitioning
            and ctx.market_stress_score < 0.35
            and market_rt
            and micro_ok
            and not quiet
        )
        return True, autotrade

    def _bbx(self, sym: str, ctx: OracleContext) -> tuple[bool, bool, int] | None:
        """BBExtremeReversion: Connors RSI(2) at most 5 / at least 95 at or
        beyond the Bollinger bands; direction-specific routing."""
        df = self.store15.frames[sym]
        close = df.close
        delta = F.diff(close)
        gain = _last(F.rolling(F.clip(delta, lower=0)[-2:], 2, 2).mean())
        loss = _last(F.rolling(F.clip(-delta, lower=0)[-2:], 2, 2).mean())
        if not (math.isfinite(gain) and math.isfinite(loss)):
            return None
        if loss == 0:
            if gain == 0:
                return None  # flat: RSI undefined
            rsi2 = 100.0
        else:
            rsi2 = clamp(100.0 - 100.0 / (1.0 + gain / loss), 0.0, 100.0)
        mid, std = _bands20(close)
        if not (math.isfinite(mid) and math.isfinite(std)):
            return None
        bb_upper, bb_lower = mid + 2 * std, mid - 2 * std
        span = bb_upper - bb_lower
        if not span > 0:
            return None
        price = float(close[-1])
        band_position = (price - bb_lower) / span
        buy = rsi2 <= 5.0 and band_position <= 0.0
        sell = rsi2 >= 95.0 and band_position >= 1.0
        if not (buy or sell):
            return None
        f = ctx.features.get(sym)
        M, T = MicroRegimeCode, MicroTransitionCode
        base_ok = (
            ctx.valid
            and not ctx.regime_is_transitioning
            and ctx.market_stress_score < 0.35
            and ctx.market_regime == int(MarketRegimeCode.RANGE)
        )
        directional_ok = False
        if f is not None and f.valid:
            trans_blocked = f.micro_transition in (
                int(T.VOLATILITY_EXPANSION), int(T.BREAKDOWN),
                int(T.ENTERED_TRANSITIONAL),
            )
            if sell:
                direction_micro_ok = f.micro_regime in (
                    int(M.RANGE), int(M.TRANSITIONAL), int(M.TREND_DOWN),
                )
            else:
                direction_micro_ok = f.micro_regime != int(M.TREND_DOWN)
            directional_ok = (
                not trans_blocked
                and f.micro_strength >= 0.5
                and direction_micro_ok
            )
        direction = int(Direction.SHORT) if sell else int(Direction.LONG)
        return True, base_ok and directional_ok, direction

    def _rbr(self, sym: str, ctx: OracleContext) -> tuple[bool, bool, int] | None:
        """RangeBbRsiMeanReversion: the RANGE x RANGE fade — a rolling-sum
        ADX under 32, a 2-sigma z-score, wick-rejection candles."""
        f = ctx.features.get(sym)
        M, T = MicroRegimeCode, MicroTransitionCode
        if not (
            ctx.valid
            and ctx.market_stress_score < 0.35
            and ctx.market_regime == int(MarketRegimeCode.RANGE)
            and f is not None
            and f.valid
            and f.micro_regime == int(M.RANGE)
            and f.micro_transition
            not in (
                int(T.BREAKOUT_UP), int(T.BREAKDOWN), int(T.VOLATILITY_EXPANSION),
            )
            and f.atr_pct <= 0.04
            and f.bb_width <= 0.08
        ):
            return None
        df = self.store15.frames[sym]
        if len(df) < 40:
            return None
        close, high, low, open_ = df.close, df.high, df.low, df.open
        rsi = _rsi14_sma(close)
        if rsi is None:
            return None

        # the inline rolling-SUM ADX (not Wilder's EWM); sdiv is 0 where the
        # denominator is exactly 0 and propagates NaN elsewhere
        def sdiv(a, b):
            a, b = np.asarray(a, float), np.asarray(b, float)
            ok = b != 0
            with np.errstate(invalid="ignore", divide="ignore"):
                return np.where(ok, a / np.where(ok, b, 1.0), 0.0)

        with np.errstate(invalid="ignore"):
            hd = F.diff(high)
            ld = F.shift(low, 1) - low
            plus_dm = np.where((hd > ld) & (hd > 0), hd, 0.0)
            minus_dm = np.where((ld > hd) & (ld > 0), ld, 0.0)
            pc = F.shift(close, 1)
            tr = F.where(_true_range(high, low, close), ~np.isnan(pc), high - low)
            atr_sum = F.rolling(tr, 14).sum()
            plus_di = 100.0 * sdiv(F.rolling(plus_dm, 14).sum(), atr_sum)
            minus_di = 100.0 * sdiv(F.rolling(minus_dm, 14).sum(), atr_sum)
            di_total = plus_di + minus_di
            dx = np.where(
                di_total != 0, 100.0 * sdiv(np.abs(plus_di - minus_di), di_total), 0.0
            )
        dx = np.where(np.isfinite(atr_sum), dx, np.nan)
        adx = _nz(_last(F.rolling(dx[-14:], 14).mean()), 100.0)
        if adx > 32.0:
            return None
        mean, std = _bands20(close)
        if math.isfinite(std) and std > 0:
            z = (float(close[-1]) - mean) / std
        else:
            z = 0.0
        mid = mean
        bb_std = std
        if not (math.isfinite(mid) and math.isfinite(bb_std)):
            return None
        bb_upper, bb_lower = mid + 2 * bb_std, mid - 2 * bb_std
        c, o = float(close[-1]), float(open_[-1])
        h, lo_ = float(high[-1]), float(low[-1])
        candle_range = h - lo_
        if not candle_range > 0:
            return None
        lower_wick = min(o, c) - lo_
        upper_wick = h - max(o, c)
        close_position = (c - lo_) / candle_range
        bullish_rej = (
            lo_ <= bb_lower * 1.002
            and c > o
            and lower_wick / candle_range >= 0.30
            and close_position >= 0.55
        )
        bearish_rej = (
            h >= bb_upper * (1.0 - 0.002)
            and c < o
            and upper_wick / candle_range >= 0.30
            and close_position <= 0.45
        )
        long_setup = c <= mid and rsi <= 35.0 and z <= -2.0 and bullish_rej
        short_setup = c >= mid and rsi >= 65.0 and z >= 2.0 and bearish_rej
        if not (long_setup or short_setup):
            return None
        direction = int(Direction.SHORT) if short_setup else int(Direction.LONG)
        return True, True, direction

    def _twap(self, sym: str) -> tuple[bool, bool] | None:
        """Coinrule TwapMomentumSniper: the TWAP of the last 20 calendar
        hours above the price and no sharp selloff. The 15m bars are
        resampled to calendar hours as ``df.resample('1h')`` does (22 hour
        buckets, the last, partial hour included, an empty hour NaN and
        skipped by the mean)."""
        df15 = self.store15.frames[sym]
        df5 = self.store5.frames.get(sym)
        if df5 is None or len(df5) < 10 or len(df15) < 8:
            return None
        hours = df15.open_time // 3_600_000
        last_hr = int(hours[-1])
        span = np.arange(last_hr - 21, last_hr + 1)
        starts = np.searchsorted(hours, span, side="left")
        ends = np.searchsorted(hours, span, side="right")
        o, h, lo, c = (np.full(len(span), np.nan) for _ in range(4))
        for i, (a, b) in enumerate(zip(starts, ends)):
            if a == b:
                continue
            opens, closes = df15.open[a:b], df15.close[a:b]
            highs, lows = df15.high[a:b], df15.low[a:b]
            ok_o, ok_c = ~np.isnan(opens), ~np.isnan(closes)
            if ok_o.any():
                o[i] = opens[ok_o][0]  # the group's first valid value
            if ok_c.any():
                c[i] = closes[ok_c][-1]  # and its last
            if (~np.isnan(highs)).any():
                h[i] = np.nanmax(highs)
            if (~np.isnan(lows)).any():
                lo[i] = np.nanmin(lows)
        bar_avg = (o + h + lo + c) / 4.0
        tail = bar_avg[-20:]
        twap = float(np.nanmean(tail)) if (~np.isnan(tail)).any() else float("nan")
        if not (np.isfinite(c[-1]) and np.isfinite(c[-2])):
            return None
        price = float(df5.close[-1])
        # "price_decrease" exactly as the reference writes it
        price_decrease = c[-1] - c[-2] / c[-1]
        if not (twap > price and price_decrease > -0.05):
            return None
        return True, False  # manual only

    def _sts(
        self,
        sym: str,
        ctx: OracleContext,
        adp_diff: float,
        adp_diff_prev: float,
        dominance_is_losers: bool,
    ) -> tuple[bool, bool] | None:
        """Coinrule SupertrendSwingReversal: a supertrend(10, 3) uptrend, RSI(14)
        under 30, more than 5 trades, the breadth rising twice, LOSERS
        dominance."""
        if not (
            math.isfinite(adp_diff)
            and math.isfinite(adp_diff_prev)
            and adp_diff > 0
            and adp_diff_prev > 0
            and dominance_is_losers
        ):
            return None
        df = self.store5.frames[sym]
        rsi = _rsi14_sma(df.close)
        trades = float(df.number_of_trades[-1])
        if rsi is None or not (rsi < 30.0 and trades > 5):
            return None
        # supertrend on the frame left after the enrichment's warm-up is
        # dropped: the series begins 99 rows past the first bar (the ratchet
        # is path-dependent, so the seed matters)
        if len(df) <= 99:
            return None
        close, high, low = df.close[99:], df.high[99:], df.low[99:]
        pc = F.shift(close, 1)
        tr = F.where(_true_range(high, low, close), ~np.isnan(pc), high - low)
        atr = F.ewm_mean(tr, alpha=1.0 / 10, min_periods=10)
        hl2 = (high + low) / 2.0
        upper = (hl2 + 3.0 * atr).tolist()
        lower = (hl2 - 3.0 * atr).tolist()
        fu, fl, d, prev_close = math.inf, -math.inf, 1.0, 0.0
        for ub, lb, cl in zip(upper, lower, close.tolist()):
            ub = ub if math.isfinite(ub) else math.inf
            lb = lb if math.isfinite(lb) else -math.inf
            fu = ub if (ub < fu or prev_close > fu) else fu
            fl = lb if (lb > fl or prev_close < fl) else fl
            d = 1.0 if cl > fu else (-1.0 if cl < fl else d)
            prev_close = cl
        st_up = math.isfinite(float(atr[-1])) and d > 0
        if not st_up:
            return None
        # autotrade by the standard long gate; an invalid context passes
        autotrade = _allows_long_autotrade(ctx, sym) if ctx.valid else True
        return True, autotrade

    def _blsh(
        self, sym: str, market_domination_reversal: bool
    ) -> tuple[bool, bool] | None:
        """Coinrule BuyLowSellHigh: RSI(14) under 35, the price above MA25, a
        domination reversal; telemetry only."""
        if not market_domination_reversal:
            return None
        df = self.store15.frames[sym]
        close = df.close
        rsi = _rsi14_sma(close)
        if rsi is None:
            return None
        ma25 = _last(F.rolling(close[-25:], 25, 1).mean())
        if not (rsi < 35.0 and float(close[-1]) > ma25):
            return None
        return True, False  # manual only

    def _ipt(self, sym: str, ctx: OracleContext) -> tuple[bool, bool] | None:
        """InversePriceTracker: PriceTracker's oversold trio routed to
        TREND_UP, bullish TRANSITIONAL and RANGE-leader markets; telemetry
        only."""
        df = self.store5.frames[sym]
        if len(df) < 30:
            return None
        if not _oversold(df):
            return None
        f = ctx.features.get(sym)
        M, R = MicroRegimeCode, MarketRegimeCode
        if not (ctx.valid and ctx.market_stress_score < 0.35 and f and f.valid):
            return None
        bullish_transitional_symbol = (
            f.micro_regime == int(M.TRANSITIONAL)
            and f.trend_score > 0
            and f.above_ema20
            and f.relative_strength_vs_btc >= 0
        )
        range_leader = (
            f.micro_regime in (int(M.TREND_UP), int(M.TRANSITIONAL))
            and f.trend_score > 0
            and f.relative_strength_vs_btc >= 0.05
        )
        symbol_ok = f.micro_regime == int(M.TREND_UP) or bullish_transitional_symbol
        routed = (
            ctx.market_regime in (int(R.TREND_UP), int(R.TRANSITIONAL))
            and symbol_ok
        ) or (ctx.market_regime == int(R.RANGE) and range_leader)
        if not routed:
            return None
        # the telemetry gates (confidence 0.4, followthrough -0.1, risk 0.65)
        cs = _context_score(
            ctx, is_short=False,
            symbol_rs=f.relative_strength_vs_btc, symbol_trend=_short_trend(df.close),
        )
        if not (
            cs["confidence"] >= 0.4
            and cs["followthrough"] >= -0.1
            and cs["risk"] <= 0.65
        ):
            return None
        return True, False  # telemetry only

    def _rfbf(self, sym: str, ctx: OracleContext) -> tuple[bool, bool] | None:
        """RangeFailedBreakoutFade: short a fresh bullish spike while the
        market is RANGE with an average return under -0.5% and the symbol
        outperforms. The spike detector's flag pipeline: an auto-calibrated
        volume cluster, a dynamic price break, a cumulative break, an
        acceleration."""
        f = ctx.features.get(sym)
        if not (
            ctx.valid
            and ctx.market_regime == int(MarketRegimeCode.RANGE)
            and ctx.average_return < -0.005
            and f is not None
            and f.valid
            and f.relative_strength_vs_btc >= 0
        ):
            return None
        df = self.store15.frames[sym]
        close, open_, volume = df.close, df.open, df.volume
        # an upward streak: ALL of the last 3 candles green
        if len(df) < 4:
            return None
        if not bool((close[-3:] > open_[-3:]).all()):
            return None

        def nanq(arr: np.ndarray, q: float) -> float:
            a = arr[np.isfinite(arr)]
            return float(np.quantile(a, q)) if len(a) else float("nan")

        pc = close / F.shift(close, 1) - 1.0
        pc_abs = np.abs(pc)
        vma = F.rolling(volume, 12, 12).mean()
        vr = volume / (vma + 1e-6)
        pc_last, pc_abs_last, vr_last = pc[-1], pc_abs[-1], vr[-1]

        # the auto-calibration over the whole stored window; the NaN
        # fallbacks are resolved BEFORE the max, as the device orders them
        q_vol = nanq(vr, 0.97)
        vol_thr = max(1.15, q_vol) if math.isfinite(q_vol) else 1.6
        q_pf = nanq(pc_abs, 0.75)
        pf = max(0.015, q_pf) if math.isfinite(q_pf) else 0.0
        price_floor = max(0.03, pf)

        # the volume cluster: the trailing 8 ratios, 2 or more crossings and
        # a hot last bar
        vrw = vr[-8:]
        fin = np.isfinite(vrw)
        vc_flag = (
            bool(fin.any())
            and int(np.where(fin, vrw >= vol_thr, False).sum()) >= 2
            and bool(vr_last >= vol_thr)
        )
        # the dynamic price break: the trailing 60's 0.85 quantile, at least
        # 20 finite
        t60 = pc_abs[-60:]
        fin60 = t60[np.isfinite(t60)]
        dyn = float(np.quantile(fin60, 0.85)) if len(fin60) >= 20 else float("nan")
        pb_flag = math.isfinite(dyn) and bool(pc_abs_last >= max(price_floor, dyn))
        # the cumulative break over the trailing 3 bars
        pcw = pc[-3:]
        finw = np.isfinite(pcw)
        vr3 = vr[-3:]
        fin3 = np.isfinite(vr3)
        vol_cond = int(fin3.sum()) >= 3 and bool((vr3[fin3] >= vol_thr * 0.8).any())
        cum_flag = (
            int(finw.sum()) >= 3
            and float(np.maximum(pcw, 0.0)[finw].sum()) >= 0.025
            and vol_cond
        )
        # the acceleration: the volume ratio's 3-bar rise and a real move
        vr_lag = vr[-4] if len(vr) > 3 else float("nan")
        accel_base = (
            math.isfinite(vr_lag)
            and math.isfinite(vr_last)
            and vr_last - vr_lag >= 0.45
            and pc_abs_last >= 0.015
        )
        accel_flag = accel_base and pc_last > 0
        if not (cum_flag or vc_flag or pb_flag or accel_flag):
            return None
        return True, True  # shorts the spike; autotrade on

    def _rsr(self, sym: str, ctx: OracleContext) -> tuple[bool, bool] | None:
        """RelativeStrengthReversalRange: a contrarian long on an RS leader
        in a broad RANGE selloff, its volume above the 20th percentile of
        the last 96 bars; telemetry only."""
        f = ctx.features.get(sym)
        if not (
            ctx.valid
            and ctx.market_regime == int(MarketRegimeCode.RANGE)
            and ctx.average_return < -0.02
            and f is not None
            and f.valid
            and f.relative_strength_vs_btc > 0.05
        ):
            return None
        df = self.store15.frames[sym]
        if len(df) < 96:
            return None
        vol = df.volume[-96:]
        finite = vol[np.isfinite(vol)]
        if not len(finite):
            return None
        floor = float(np.quantile(finite, 0.20))
        if not float(df.volume[-1]) > floor:
            return None
        return True, False  # telemetry only

    # -- the tick ----------------------------------------------------------

    def evaluate(
        self,
        now_ms: int,
        quiet: bool | None = None,
        grid_policy_allows: bool = False,
        oi_growth: dict[str, float] | None = None,
        adp_latest: float = float("nan"),
        adp_prev: float = float("nan"),
        adp_diff: float = float("nan"),
        adp_diff_prev: float = float("nan"),
        dominance_is_losers: bool = False,
        market_domination_reversal: bool = False,
    ) -> list[tuple[str, str, str, bool]]:
        """One tick; returns the fired (strategy, symbol, direction,
        autotrade) tuples.

        ``quiet=None`` resolves the quiet-hours filter at the evaluated
        tick's time (London, with DST) against the context built THIS tick,
        the inputs the device step reads.
        """
        ts_s = now_ms // 1000
        ts15 = ts_s // FIFTEEN_MIN_S * FIFTEEN_MIN_S - FIFTEEN_MIN_S
        ts5 = ts_s // FIVE_MIN_S * FIVE_MIN_S - FIVE_MIN_S

        ctx = self._build_context(ts15)
        if ctx.valid:
            self._last_regime = ctx.market_regime
            self._last_strength = ctx.market_regime_transition_strength
        else:
            self._last_regime = None
            self._last_strength = 0.0

        if quiet is None:
            quiet = is_autotrade_suppressed(
                ctx.market_regime if ctx.valid else None,
                ctx.market_regime_transition_strength if ctx.valid else 0.0,
                now=datetime.fromtimestamp(now_ms / 1000, tz=timezone.utc),
            )

        btc_df = self.store15.frames.get(self.btc_symbol)
        btc_momentum = 0.0
        if btc_df is not None and len(btc_df) >= 2:
            prev = float(btc_df.close[-2])
            if prev != 0 and math.isfinite(prev):
                btc_momentum = float(btc_df.close[-1]) / prev - 1.0

        fresh5 = {
            s
            for s in self.store5.fresh(ts5)
            if len(self.store5.frames[s]) >= MIN_BARS
        }
        fresh15 = {
            s
            for s in self.store15.fresh(ts15)
            if len(self.store15.frames[s]) >= MIN_BARS
        }
        oi = oi_growth or {}

        fired: list[tuple[str, str, str, bool]] = []

        def emit(strategy, sym, direction, autotrade, bar_ts):
            key = (strategy, sym)
            if self.last_emitted.get(key) == bar_ts:
                return
            self.last_emitted[key] = bar_ts
            fired.append((strategy, sym, direction, autotrade))

        if "activity_burst_pump" in self.enabled:
            for sym in sorted(fresh5):
                r = self._abp(sym, ctx)
                if r:
                    emit("activity_burst_pump", sym, "LONG", r[1], ts5)
        if "coinrule_price_tracker" in self.enabled:
            for sym in sorted(fresh5):
                r = self._pt(sym, ctx, quiet)
                if r:
                    emit("coinrule_price_tracker", sym, "LONG", r[1], ts5)
        if "liquidation_sweep_pump" in self.enabled:
            for sym in sorted(fresh15):
                r = self._lsp(
                    sym, ctx, oi.get(sym, float("nan")), adp_latest, adp_prev,
                    btc_momentum,
                )
                if r:
                    emit(
                        "liquidation_sweep_pump", sym,
                        Direction(r[2]).name, r[1], ts15,
                    )
        if "mean_reversion_fade" in self.enabled:
            for sym in sorted(fresh15):
                r = self._mrf(sym)
                if r:
                    emit("mean_reversion_fade", sym, Direction(r[2]).name, r[1], ts15)
        if "grid_ladder" in self.enabled:
            for sym in sorted(fresh15):
                r = self._ladder(sym, ctx, grid_policy_allows)
                if r:
                    emit("grid_ladder", sym, "grid", r[1], ts15)
        # the dormant set (named by enabled_strategies only)
        if "coinrule_twap_momentum_sniper" in self.enabled:
            for sym in sorted(fresh5):
                r = self._twap(sym)
                if r:
                    emit("coinrule_twap_momentum_sniper", sym, "LONG", r[1], ts5)
        if "coinrule_supertrend_swing_reversal" in self.enabled:
            for sym in sorted(fresh5):
                r = self._sts(
                    sym, ctx, adp_diff, adp_diff_prev, dominance_is_losers
                )
                if r:
                    emit(
                        "coinrule_supertrend_swing_reversal", sym,
                        "LONG", r[1], ts5,
                    )
        if "inverse_price_tracker" in self.enabled:
            for sym in sorted(fresh5):
                r = self._ipt(sym, ctx)
                if r:
                    emit("inverse_price_tracker", sym, "LONG", r[1], ts5)
        if "coinrule_buy_low_sell_high" in self.enabled:
            for sym in sorted(fresh15):
                r = self._blsh(sym, market_domination_reversal)
                if r:
                    emit("coinrule_buy_low_sell_high", sym, "LONG", r[1], ts15)
        if "relative_strength_reversal_range" in self.enabled:
            for sym in sorted(fresh15):
                r = self._rsr(sym, ctx)
                if r:
                    emit(
                        "relative_strength_reversal_range", sym,
                        "LONG", r[1], ts15,
                    )
        if "range_failed_breakout_fade" in self.enabled:
            for sym in sorted(fresh15):
                r = self._rfbf(sym, ctx)
                if r:
                    emit(
                        "range_failed_breakout_fade", sym, "SHORT", r[1], ts15
                    )
        if "coinrule_buy_the_dip" in self.enabled:
            for sym in sorted(fresh15):
                r = self._btd(sym, ctx, quiet)
                if r:
                    emit("coinrule_buy_the_dip", sym, "LONG", r[1], ts15)
        if "bb_extreme_reversion" in self.enabled:
            for sym in sorted(fresh15):
                r = self._bbx(sym, ctx)
                if r:
                    emit(
                        "bb_extreme_reversion", sym,
                        Direction(r[2]).name, r[1], ts15,
                    )
        if "range_bb_rsi_mean_reversion" in self.enabled:
            for sym in sorted(fresh15):
                r = self._rbr(sym, ctx)
                if r:
                    emit(
                        "range_bb_rsi_mean_reversion", sym,
                        Direction(r[2]).name, r[1], ts15,
                    )
        return fired
