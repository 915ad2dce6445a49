"""Technical-indicator kernels, batched along the last axis.

Port of ``binquant_tpu/ops/indicators.py``: every function takes and returns
``(..., W)`` tensors, so a ``(S, W)`` market ring flows through whole, with
NaN marking the warm-up as in pandas. The live wire step reads
``true_range`` (feature packs, market context), ``log_returns`` and
``rolling_beta_corr`` (the BTC-relative block) and the supertrend recursion
(``_supertrend_step``, ``supertrend_scan_init``, ``_supertrend_scan``),
whose final carry every full recompute of the incremental engine keeps and
whose series :func:`supertrend_from` gives the dormant
SupertrendSwingReversal. The rest is the reference's batched library with
its names and result tuples (``sma``, ``ema``, ``atr``, the RSIs, ``macd``,
``mfi``, ``bollinger``, ``twap``, ``supertrend``, ``adx``, ``connors_rsi``,
``zscore``, the MA and band spreads), plain torch over ``ops/rolling.py``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from binquant_tpu_torch.ops.rolling import (
    _windowed_view,
    diff,
    ewm_mean,
    rolling_mean,
    rolling_std,
    rolling_sum,
    rolling_var,
    shift,
)
from binquant_tpu_torch.utils import jsafe_div

__all__ = [
    "sma",
    "ema",
    "true_range",
    "atr",
    "atr_wilder",
    "rsi_wilder",
    "rsi_sma",
    "macd",
    "mfi",
    "bollinger",
    "twap",
    "typical_price",
    "supertrend",
    "adx",
    "connors_rsi",
    "zscore",
    "rolling_beta_corr",
    "log_returns",
    "ma_spreads",
    "bb_spreads",
]

NAN = float("nan")


def sma(close: torch.Tensor, window: int, min_periods: int | None = None) -> torch.Tensor:
    return rolling_mean(close, window, min_periods)


def ema(close: torch.Tensor, span: float, min_periods: int = 1) -> torch.Tensor:
    return ewm_mean(close, span=span, min_periods=min_periods)


def _div(x: torch.Tensor, d: float) -> torch.Tensor:
    """``x / d`` rounded as a true division on every device: the card divides
    by a Python scalar as a product with its rounded reciprocal, an ulp off
    the CPU's (and the reference's) quotient, which flips a typical price's
    up/down move; dividing by a tensor divides on both."""
    return x / torch.full((), d, dtype=x.dtype, device=x.device)


def typical_price(high: torch.Tensor, low: torch.Tensor, close: torch.Tensor) -> torch.Tensor:
    return _div(high + low + close, 3.0)


def true_range(
    high: torch.Tensor, low: torch.Tensor, close: torch.Tensor
) -> torch.Tensor:
    """max(h-l, |h-prev_c|, |l-prev_c|); the first bar falls back to h-l."""
    prev_close = shift(close, 1)
    hl = high - low
    hc = torch.abs(high - prev_close)
    lc = torch.abs(low - prev_close)
    tr = torch.maximum(hl, torch.maximum(hc, lc))
    return torch.where(torch.isfinite(prev_close), tr, hl)


def atr(
    high: torch.Tensor,
    low: torch.Tensor,
    close: torch.Tensor,
    window: int = 14,
    min_periods: int | None = None,
) -> torch.Tensor:
    """SMA-of-true-range ATR (the market context's variant)."""
    return rolling_mean(true_range(high, low, close), window, min_periods)


def atr_wilder(
    high: torch.Tensor, low: torch.Tensor, close: torch.Tensor, window: int = 14
) -> torch.Tensor:
    """Wilder-smoothed ATR (ewm alpha = 1/window)."""
    return ewm_mean(true_range(high, low, close), alpha=1.0 / window, min_periods=window)


def _rsi_from(avg_gain: torch.Tensor, avg_loss: torch.Tensor) -> torch.Tensor:
    """100*gain/(gain+loss), 50 on a flat window, NaN while either is warm."""
    denom = avg_gain + avg_loss
    ok = denom != 0
    out = torch.where(ok, 100.0 * avg_gain / torch.where(ok, denom, 1.0), 50.0)
    return torch.where(torch.isfinite(avg_gain) & torch.isfinite(avg_loss), out, NAN)


def rsi_wilder(close: torch.Tensor, window: int = 14) -> torch.Tensor:
    """Wilder/EWM RSI, MeanReversionFade's backtested variant."""
    delta = diff(close, 1)
    a = 1.0 / window
    avg_gain = ewm_mean(torch.clamp(delta, min=0.0), alpha=a, min_periods=window)
    avg_loss = ewm_mean(torch.clamp(-delta, min=0.0), alpha=a, min_periods=window)
    return _rsi_from(avg_gain, avg_loss)


def rsi_sma(close: torch.Tensor, window: int = 14) -> torch.Tensor:
    """Simple-rolling-mean RSI (the indicator library's plain RSI column)."""
    delta = diff(close, 1)
    avg_gain = rolling_mean(torch.clamp(delta, min=0.0), window)
    avg_loss = rolling_mean(torch.clamp(-delta, min=0.0), window)
    return _rsi_from(avg_gain, avg_loss)


class MACDResult(NamedTuple):
    macd: torch.Tensor
    signal: torch.Tensor
    histogram: torch.Tensor


def macd(close: torch.Tensor, fast: int = 12, slow: int = 26, signal: int = 9) -> MACDResult:
    line = ema(close, fast) - ema(close, slow)
    sig = ewm_mean(line, span=signal)
    return MACDResult(line, sig, line - sig)


def mfi(
    high: torch.Tensor,
    low: torch.Tensor,
    close: torch.Tensor,
    volume: torch.Tensor,
    window: int = 14,
) -> torch.Tensor:
    tp = typical_price(high, low, close)
    flow = tp * volume
    move = diff(tp, 1)
    pos = rolling_sum(torch.where(move > 0, flow, 0.0), window)
    neg = rolling_sum(torch.where(move < 0, flow, 0.0), window)
    return _rsi_from(pos, neg)


class BollingerResult(NamedTuple):
    upper: torch.Tensor
    mid: torch.Tensor
    lower: torch.Tensor


def bollinger(
    close: torch.Tensor,
    window: int = 20,
    num_std: float = 2.0,
    min_periods: int | None = None,
    ddof: int = 0,
) -> BollingerResult:
    mid = rolling_mean(close, window, min_periods)
    sd = rolling_std(close, window, min_periods, ddof=ddof)
    sd = torch.where(torch.isfinite(sd), sd, 0.0)
    return BollingerResult(mid + num_std * sd, mid, mid - num_std * sd)


def twap(
    open_: torch.Tensor,
    high: torch.Tensor,
    low: torch.Tensor,
    close: torch.Tensor,
    window: int = 20,
) -> torch.Tensor:
    """Rolling time-weighted average price over the bars' OHLC means."""
    return rolling_mean((open_ + high + low + close) / 4.0, window, min_periods=1)


def adx(
    high: torch.Tensor, low: torch.Tensor, close: torch.Tensor, window: int = 14
) -> torch.Tensor:
    """Wilder ADX from the +DM/-DM/TR ewm smoothing."""
    up_move = diff(high, 1)
    down_move = -diff(low, 1)
    plus_dm = torch.where((up_move > down_move) & (up_move > 0), up_move, 0.0)
    minus_dm = torch.where((down_move > up_move) & (down_move > 0), down_move, 0.0)
    a = 1.0 / window
    tr_s = ewm_mean(true_range(high, low, close), alpha=a, min_periods=window)
    plus_di = 100.0 * jsafe_div(ewm_mean(plus_dm, alpha=a, min_periods=window), tr_s)
    minus_di = 100.0 * jsafe_div(ewm_mean(minus_dm, alpha=a, min_periods=window), tr_s)
    dx = 100.0 * jsafe_div(torch.abs(plus_di - minus_di), plus_di + minus_di)
    dx = torch.where(torch.isfinite(tr_s), dx, NAN)
    return ewm_mean(dx, alpha=a, min_periods=window)


def _percent_rank(x: torch.Tensor, window: int) -> torch.Tensor:
    """Percent of the previous ``window`` values strictly below the current."""
    win = _windowed_view(shift(x, 1), window)
    cur = x[..., None]
    finite = torch.isfinite(win)
    below = torch.where(finite, (win < cur).to(x.dtype), 0.0).sum(dim=-1)
    cnt = finite.sum(dim=-1)
    return torch.where(cnt >= window, 100.0 * below / torch.clamp(cnt, min=1), NAN)


def connors_rsi(
    close: torch.Tensor,
    rsi_window: int = 3,
    streak_window: int = 2,
    rank_window: int = 100,
) -> torch.Tensor:
    """Connors RSI: the mean of RSI(close, 3), RSI(streak, 2) and the 100-bar
    percent rank of the return. The signed up/down streak is sequential: a
    loop over the columns."""
    d = diff(close, 1)
    sign = torch.sign(d)
    streak = torch.zeros(close.shape[:-1], dtype=close.dtype, device=close.device)
    streaks = []
    for j in range(close.shape[-1]):
        s = sign[..., j]
        streak = torch.where(
            s > 0,
            torch.where(streak > 0, streak + 1, 1.0),
            torch.where(s < 0, torch.where(streak < 0, streak - 1, -1.0), 0.0),
        )
        streaks.append(streak)
    streak = torch.stack(streaks, dim=-1)
    ret = jsafe_div(d, shift(close, 1))
    r1 = rsi_wilder(close, rsi_window)
    r2 = rsi_wilder(streak, streak_window)
    r3 = _percent_rank(ret, rank_window)
    return _div(r1 + r2 + r3, 3.0)


def zscore(x: torch.Tensor, window: int = 20, ddof: int = 0) -> torch.Tensor:
    mu = rolling_mean(x, window)
    sd = rolling_std(x, window, ddof=ddof)
    return jsafe_div(x - mu, sd)


def log_returns(close: torch.Tensor) -> torch.Tensor:
    prev = shift(close, 1)
    ok = (close > 0) & (prev > 0)
    ratio = close / torch.where(prev > 0, prev, torch.ones_like(prev))
    return torch.where(ok, torch.log(torch.where(ok, ratio, 1.0)), float("nan"))


class BetaCorrResult(NamedTuple):
    beta: torch.Tensor
    corr: torch.Tensor


def rolling_beta_corr(
    asset_returns: torch.Tensor,
    bench_returns: torch.Tensor,
    window: int = 50,
) -> BetaCorrResult:
    """Rolling OLS beta and Pearson correlation of asset vs benchmark
    returns; ``bench_returns`` broadcasts against ``asset_returns``."""
    b = torch.broadcast_to(bench_returns, asset_returns.shape)
    both = torch.isfinite(asset_returns) & torch.isfinite(b)
    x = torch.where(both, asset_returns, float("nan"))
    y = torch.where(both, b, float("nan"))
    mx = rolling_mean(x, window)
    my = rolling_mean(y, window)
    mxy = rolling_mean(x * y, window)
    myy = rolling_mean(y * y, window)
    vx = rolling_var(x, window, ddof=0)
    cov = mxy - mx * my
    var_b = myy - my * my
    beta = jsafe_div(cov, var_b)
    corr = jsafe_div(cov, torch.sqrt(torch.clamp(vx * var_b, min=0.0)))
    return BetaCorrResult(beta, torch.clamp(corr, -1.0, 1.0))


def _supertrend_step(
    carry: tuple,
    hb: torch.Tensor,
    lb_: torch.Tensor,
    cb: torch.Tensor,
    active: torch.Tensor,
    window: int,
    multiplier: float,
) -> tuple[tuple, torch.Tensor, torch.Tensor]:
    """ONE bar of the path-dependent supertrend recursion, elementwise over
    the lanes: the single copy shared by the scan below and the incremental
    carry (``ops.incremental.supertrend_advance``). Returns (carry', line,
    direction), NaN until the ATR recursion is warm."""
    atr, n_seen, fu, fl, d, prev_close = carry
    alpha = 1.0 / window
    hl2 = (hb + lb_) / 2.0
    tr_first = hb - lb_
    tr = torch.where(
        n_seen == 0,
        tr_first,
        torch.maximum(
            tr_first,
            torch.maximum(torch.abs(hb - prev_close), torch.abs(lb_ - prev_close)),
        ),
    )
    atr_new = torch.where(n_seen == 0, tr, atr + alpha * (tr - atr))
    n_new = n_seen + 1
    atr_ready = n_new >= window
    ub = torch.where(atr_ready, hl2 + multiplier * atr_new, float("inf"))
    lb = torch.where(atr_ready, hl2 - multiplier * atr_new, float("-inf"))
    fu_new = torch.where((ub < fu) | (prev_close > fu), ub, fu)
    fl_new = torch.where((lb > fl) | (prev_close < fl), lb, fl)
    d_new = torch.where(cb > fu_new, 1.0, torch.where(cb < fl_new, -1.0, d))

    def keep(new, old):  # lanes before their start keep the initial carry
        return torch.where(active, new, old)

    new_carry = (
        keep(atr_new, atr),
        keep(n_new, n_seen).to(torch.int32),
        keep(fu_new, fu),
        keep(fl_new, fl),
        keep(d_new, d),
        keep(cb, prev_close),
    )
    line = torch.where(d_new > 0, fl_new, fu_new)
    # a mid-series NaN bar poisons the ATR recursion for good: the output
    # stays NaN from the gap on instead of serving frozen bands
    valid = active & atr_ready & torch.isfinite(atr_new)
    nan = float("nan")
    return new_carry, torch.where(valid, line, nan), torch.where(valid, d_new, nan)


def supertrend_scan_init(
    batch_shape: tuple[int, ...], *, device: torch.device | str
) -> tuple:
    """The recursion's initial carry (atr, n_seen, final_upper, final_lower,
    direction, prev_close), float leaves float32, the counter int32."""
    f32 = torch.float32
    return (
        torch.zeros(batch_shape, dtype=f32, device=device),
        torch.zeros(batch_shape, dtype=torch.int32, device=device),
        torch.full(batch_shape, float("inf"), dtype=f32, device=device),
        torch.full(batch_shape, float("-inf"), dtype=f32, device=device),
        torch.ones(batch_shape, dtype=f32, device=device),
        torch.zeros(batch_shape, dtype=f32, device=device),
    )


def _supertrend_scan(
    high: torch.Tensor,
    low: torch.Tensor,
    close: torch.Tensor,
    start: torch.Tensor,
    window: int,
    multiplier: float,
) -> tuple[tuple, torch.Tensor, torch.Tensor]:
    """Run the recursion over the window's columns, lane by lane from each
    lane's ``start``: the FINAL carry (the incremental seed) plus the full
    (..., W) line and direction series. The recursion is sequential, so
    this is a loop of W small elementwise steps (the reference's
    ``lax.scan``)."""
    W = close.shape[-1]
    batch_shape = close.shape[:-1]
    start_b = torch.broadcast_to(start, batch_shape)
    carry = supertrend_scan_init(batch_shape, device=close.device)
    lines, dirs = [], []
    for j in range(W):
        carry, line, dirn = _supertrend_step(
            carry, high[..., j], low[..., j], close[..., j], start_b <= j,
            window, multiplier,
        )
        lines.append(line)
        dirs.append(dirn)
    return carry, torch.stack(lines, dim=-1), torch.stack(dirs, dim=-1)


class SupertrendResult(NamedTuple):
    supertrend: torch.Tensor  # (..., W) the line, NaN until warm
    direction: torch.Tensor  # (..., W) +1 up / -1 down, NaN until warm


def supertrend_from(
    high: torch.Tensor,
    low: torch.Tensor,
    close: torch.Tensor,
    start: torch.Tensor,
    window: int = 10,
    multiplier: float = 3.0,
) -> SupertrendResult:
    """Supertrend whose series BEGINS at each lane's index ``start``: TR,
    the Wilder ATR and the band ratchet all restart there and bars before
    it are ignored, as the reference computes supertrend on the frame left
    after the indicator warm-up is dropped. The one scan is
    :func:`_supertrend_scan`."""
    _, line, direction = _supertrend_scan(high, low, close, start, window, multiplier)
    return SupertrendResult(line, direction)


def supertrend(
    high: torch.Tensor,
    low: torch.Tensor,
    close: torch.Tensor,
    window: int = 10,
    multiplier: float = 3.0,
) -> SupertrendResult:
    """Supertrend over the whole series: :func:`supertrend_from` started at
    each lane's first finite bar (a ring left-pads an unfilled lane with
    NaN)."""
    W = close.shape[-1]
    finite = torch.isfinite(high) & torch.isfinite(low) & torch.isfinite(close)
    idx = torch.arange(W, dtype=torch.int32, device=close.device)
    start = torch.where(finite, idx, W).amin(dim=-1)
    return supertrend_from(high, low, close, start, window, multiplier)


class MASpreads(NamedTuple):
    ma_7_25: torch.Tensor
    ma_25_100: torch.Tensor
    ma_7_100: torch.Tensor


def ma_spreads(close: torch.Tensor) -> MASpreads:
    """Relative spreads between the 7, 25 and 100-bar moving averages."""
    ma7 = rolling_mean(close, 7, min_periods=1)
    ma25 = rolling_mean(close, 25, min_periods=1)
    ma100 = rolling_mean(close, 100, min_periods=1)
    return MASpreads(
        jsafe_div(ma7 - ma25, ma25),
        jsafe_div(ma25 - ma100, ma100),
        jsafe_div(ma7 - ma100, ma100),
    )


class BBSpreads(NamedTuple):
    band_spread: torch.Tensor  # (upper - lower) / mid
    top_spread: torch.Tensor  # (upper - mid) / mid
    bottom_spread: torch.Tensor  # (mid - lower) / mid


def bb_spreads(bb: BollingerResult) -> BBSpreads:
    return BBSpreads(
        jsafe_div(bb.upper - bb.lower, bb.mid),
        jsafe_div(bb.upper - bb.mid, bb.mid),
        jsafe_div(bb.mid - bb.lower, bb.mid),
    )
