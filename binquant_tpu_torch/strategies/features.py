"""Shared per-timeframe feature pack: last-bar indicator values for every
symbol, each indicator computed once per tick.

Port of ``compute_feature_pack`` (``binquant_tpu/strategies/features.py``);
the incremental carry functions belong to a later slice. Variant pins match
the reference: ``rsi`` is the simple-rolling-mean RSI, ``rsi_wilder`` the
Wilder/EWM RSI, ``atr`` the SMA of true range, Bollinger 20/2σ with ddof=0.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from binquant_tpu_torch.engine.buffer import Field, MarketBuffer
from binquant_tpu_torch.ops.indicators import true_range
from binquant_tpu_torch.ops.rolling import (
    ewm_mean,
    ewm_mean_last,
    rolling_mean,
    rolling_mean_last,
    rolling_std,
    shift,
)
from binquant_tpu_torch.utils import jsafe_div

# bars of BB-width history kept for LadderDeployer's stability check
BB_WIDTH_HISTORY = 8

NAN = float("nan")


class FeaturePack(NamedTuple):
    """Last-bar indicator batch for one timeframe; (S,) f32 unless noted,
    NaN where history is insufficient."""

    open_time: torch.Tensor  # (S,) int32 seconds
    close_time: torch.Tensor  # (S,) int32 seconds (open_time + duration)
    open: torch.Tensor
    high: torch.Tensor
    low: torch.Tensor
    close: torch.Tensor
    prev_close: torch.Tensor
    volume: torch.Tensor
    quote_volume: torch.Tensor
    num_trades: torch.Tensor
    rsi: torch.Tensor
    rsi_wilder: torch.Tensor
    macd: torch.Tensor
    macd_signal: torch.Tensor
    mfi: torch.Tensor
    bb_upper: torch.Tensor
    bb_mid: torch.Tensor
    bb_lower: torch.Tensor
    bb_widths: torch.Tensor  # (S, BB_WIDTH_HISTORY) trailing (u-l)/mid
    atr: torch.Tensor
    atr_ma: torch.Tensor
    volume_ma: torch.Tensor
    ema9: torch.Tensor
    ema21: torch.Tensor
    filled: torch.Tensor  # (S,) int32
    valid: torch.Tensor  # (S,) bool


def _rsi(avg_gain: torch.Tensor, avg_loss: torch.Tensor) -> torch.Tensor:
    denom = avg_gain + avg_loss
    nz = denom != 0
    out = torch.where(
        nz, 100.0 * avg_gain / torch.where(nz, denom, torch.ones_like(denom)), 50.0
    )
    return torch.where(torch.isfinite(avg_gain) & torch.isfinite(avg_loss), out, NAN)


def compute_feature_pack(buf: MarketBuffer) -> FeaturePack:
    v = buf.values
    close = v[:, :, Field.CLOSE]
    high = v[:, :, Field.HIGH]
    low = v[:, :, Field.LOW]
    open_ = v[:, :, Field.OPEN]
    volume = v[:, :, Field.VOLUME]

    # RSI, both variants
    delta = close - shift(close, 1)
    gain = torch.clamp(delta, min=0.0)
    loss = torch.clamp(-delta, min=0.0)
    rsi_wilder = _rsi(
        ewm_mean_last(gain, alpha=1.0 / 14, min_periods=14),
        ewm_mean_last(loss, alpha=1.0 / 14, min_periods=14),
    )
    rsi_sma = _rsi(rolling_mean_last(gain, 14), rolling_mean_last(loss, 14))

    # MACD: the signal EMA needs the line's full series
    macd_line = ewm_mean(close, span=12, min_periods=1) - ewm_mean(
        close, span=26, min_periods=1
    )
    macd_last = macd_line[:, -1]
    macd_signal = ewm_mean_last(macd_line, span=9, min_periods=1)

    # MFI(14) from the trailing 15 bars
    tp = (high + low + close) / 3.0
    flow = tp * volume
    tp_delta = tp - shift(tp, 1)
    pos_flow = torch.where(tp_delta > 0, flow, 0.0)[:, -14:]
    neg_flow = torch.where(tp_delta < 0, flow, 0.0)[:, -14:]
    flow_ok = torch.isfinite(tp_delta[:, -14:])
    pos_sum = torch.where(flow_ok, pos_flow, 0.0).sum(dim=-1)
    neg_sum = torch.where(flow_ok, neg_flow, 0.0).sum(dim=-1)
    total = pos_sum + neg_sum
    nz = total != 0
    mfi = torch.where(
        nz, 100.0 * pos_sum / torch.where(nz, total, torch.ones_like(total)), 50.0
    )
    mfi = torch.where(flow_ok.sum(dim=-1) >= 14, mfi, NAN)

    # Bollinger 20/2σ (ddof=0): last bar + trailing width history
    k = BB_WIDTH_HISTORY
    tail = close[:, -(20 + k - 1):]
    mids = rolling_mean(tail, 20)[:, -k:]
    stds = rolling_std(tail, 20, ddof=0)[:, -k:]
    uppers = mids + 2.0 * stds
    lowers = mids - 2.0 * stds
    bb_widths = jsafe_div(uppers - lowers, mids)

    # ATR(14) SMA variant + its 20-bar MA: 35-bar slice, first TR dropped
    tr = true_range(high[:, -35:], low[:, -35:], close[:, -35:])[:, 1:]
    atr_series = rolling_mean(tr, 14)
    atr_ma = rolling_mean_last(atr_series, 20)

    duration = v[:, -1, Field.DURATION_S]
    duration = torch.where(torch.isfinite(duration), duration, 0.0).to(torch.int32)
    return FeaturePack(
        open_time=buf.times[:, -1],
        close_time=buf.times[:, -1] + duration,
        open=open_[:, -1],
        high=high[:, -1],
        low=low[:, -1],
        close=close[:, -1],
        prev_close=close[:, -2],
        volume=volume[:, -1],
        quote_volume=v[:, -1, Field.QUOTE_VOLUME],
        num_trades=v[:, -1, Field.NUM_TRADES],
        rsi=rsi_sma,
        rsi_wilder=rsi_wilder,
        macd=macd_last,
        macd_signal=macd_signal,
        mfi=mfi,
        bb_upper=uppers[:, -1],
        bb_mid=mids[:, -1],
        bb_lower=lowers[:, -1],
        bb_widths=bb_widths,
        atr=atr_series[:, -1],
        atr_ma=atr_ma,
        volume_ma=rolling_mean_last(volume, 20),
        ema9=ewm_mean_last(close, span=9, min_periods=1),
        ema21=ewm_mean_last(close, span=21, min_periods=1),
        filled=buf.filled,
        valid=buf.filled > 0,
    )
