"""Shared per-timeframe feature pack: last-bar indicator values for every
symbol, each indicator computed once per tick.

Port of ``binquant_tpu/strategies/features.py``: the full-window pack
(:func:`compute_feature_pack`) and its incremental twin — a
:class:`FeatureCarry` built from the window by every full recompute
(:func:`init_feature_carry`), advanced by one bar per clean append
(:func:`advance_feature_carry`) and read out as the same pack
(:func:`feature_pack_from_carry`); :func:`compute_feature_pack_incremental`
does both in one call. Variant pins match the reference:
``rsi`` is the simple-rolling-mean RSI, ``rsi_wilder`` the Wilder/EWM RSI,
``atr`` the SMA of true range, Bollinger 20/2σ with ddof=0. For the
backtest's extension-invariant chunk, :func:`compute_feature_pack_ext`
computes T ticks' packs from one pass over an extended series
(:func:`ext_gather` reads them out).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from binquant_tpu_torch.engine.buffer import Field, MarketBuffer
from binquant_tpu_torch.ops.incremental import (
    EwmCarry,
    MomentCarry,
    SumCarry,
    ewm_advance,
    ewm_init,
    ewm_value,
    moment_advance,
    moment_init,
    moment_mean,
    moment_std,
    sum_advance,
    sum_init,
    sum_mean,
    sum_value,
    tree_where,
)
from binquant_tpu_torch.ops.indicators import true_range
from binquant_tpu_torch.ops.rolling import (
    ewm_last_state,
    ewm_mean,
    fixed_order_sum,
    ewm_mean_last,
    rolling_mean,
    rolling_mean_last,
    rolling_std,
    shift,
)
from binquant_tpu_torch.utils import jsafe_div

# bars of BB-width history kept for LadderDeployer's stability check
BB_WIDTH_HISTORY = 8

# windows and spans shared by the full pack, the carry and the context
# features that read the same carry
RSI_WINDOW = 14
MFI_WINDOW = 14
BB_WINDOW = 20
ATR_WINDOW = 14
ATR_MA_WINDOW = 20
VOLUME_MA_WINDOW = 20
MACD_FAST, MACD_SLOW, MACD_SIGNAL = 12, 26, 9
# the deepest ring column the one-bar advance reads
MIN_INCREMENTAL_WINDOW = max(BB_WINDOW, VOLUME_MA_WINDOW) + 2

NAN = float("nan")
I32 = torch.int32
F32 = torch.float32
# The carry's typical price is (h+l+c)·(1/3), not (h+l+c)/3: PyTorch's CUDA
# division by a Python scalar multiplies by its reciprocal while the CPU
# divides, an ulp apart, and the MFI flow sums would carry that ulp in their
# add/subtract residue (an MFI near 0 IS that residue). A product rounds
# alike on both. (The full-window pack keeps the reference's division.)
THIRD = 1.0 / 3.0
# the float32 value a float32 tensor multiplies by for THIRD, as a float64
THIRD_F64 = float(np.float32(THIRD))


def _A(span: float) -> float:
    """The EWM alpha of a pandas span."""
    return 2.0 / (span + 1.0)


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


def _ewm_last_fixed(x: torch.Tensor, alpha: float) -> torch.Tensor:
    """``ewm_mean(x, alpha, min_periods=1)[..., -1]`` summed in the fixed
    order of :func:`fixed_order_sum`."""
    mean, _, any_valid = ewm_last_state(x, alpha, fixed_order=True)
    return torch.where(any_valid, mean, NAN)


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

    # MACD: the signal EMA needs the line's full series; the line's last
    # value is summed in the carry init's fixed order, so the card and the
    # CPU give the same bits (a score adds 30 x |MACD|, which would carry a
    # matrix product's price-scale rounding into the score)
    macd_line = ewm_mean(close, span=12, min_periods=1) - ewm_mean(
        close, span=26, min_periods=1
    )
    macd_last = _ewm_last_fixed(close, _A(MACD_FAST)) - _ewm_last_fixed(close, _A(MACD_SLOW))
    macd_signal = ewm_mean_last(macd_line, span=9, min_periods=1)

    # MFI(14) from the trailing 15 bars
    # a division by a device tensor: the card divides by a Python scalar as
    # a multiplication by its rounded reciprocal, which rounds some typical
    # prices the other way and flips MFI's up/down classification of a bar
    tp = (high + low + close) / torch.full((), 3.0, device=close.device)
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


# ---------------------------------------------------------------------------
# Incremental carry: the same pack in O(1) bytes per symbol per tick
# ---------------------------------------------------------------------------


class FeatureCarry(NamedTuple):
    """Carried indicator state for ONE timeframe, (S,)/(S, k) leaves.

    ``last_ts`` is the bar open time the carry is synced to (-1 = never);
    a row advances only on a clean single-bar append. ema20/ema50 ride here
    so the 15m carry also feeds the market-context symbol features.
    """

    last_ts: torch.Tensor  # (S,) int32
    ema9: EwmCarry
    ema21: EwmCarry
    ema20: EwmCarry
    ema50: EwmCarry
    macd_fast: EwmCarry
    macd_slow: EwmCarry
    macd_sig: EwmCarry
    gain_w: EwmCarry  # Wilder RSI average gain (alpha=1/14)
    loss_w: EwmCarry
    gain_s: SumCarry  # simple-RSI rolling gain sum (14)
    loss_s: SumCarry
    pos_flow: SumCarry  # MFI flows (14)
    neg_flow: SumCarry
    close_m: MomentCarry  # Bollinger mid/std + context mid/std (20)
    vol_m: MomentCarry  # volume MA (20)
    tr_m: MomentCarry  # SMA-of-TR ATR (14)
    atr_hist: torch.Tensor  # (S, ATR_MA_WINDOW) trailing ATR values
    bb_width_hist: torch.Tensor  # (S, BB_WIDTH_HISTORY) trailing widths


def empty_feature_carry(
    num_symbols: int, *, device: torch.device | str
) -> FeatureCarry:
    S = num_symbols

    def ewm():
        return EwmCarry(
            mean=torch.zeros((S,), dtype=F32, device=device),
            rel=torch.full((S,), -1, dtype=I32, device=device),
        )

    def sums():
        return SumCarry(
            wsum=torch.zeros((S,), dtype=F32, device=device),
            cnt=torch.zeros((S,), dtype=I32, device=device),
        )

    def moment():
        return MomentCarry(
            center=torch.zeros((S,), dtype=F32, device=device),
            wsum=torch.zeros((S,), dtype=F32, device=device),
            wsq=torch.zeros((S,), dtype=F32, device=device),
            cnt=torch.zeros((S,), dtype=I32, device=device),
        )

    return FeatureCarry(
        last_ts=torch.full((S,), -1, dtype=I32, device=device),
        ema9=ewm(), ema21=ewm(), ema20=ewm(), ema50=ewm(),
        macd_fast=ewm(), macd_slow=ewm(), macd_sig=ewm(),
        gain_w=ewm(), loss_w=ewm(),
        gain_s=sums(), loss_s=sums(), pos_flow=sums(), neg_flow=sums(),
        close_m=moment(), vol_m=moment(), tr_m=moment(),
        atr_hist=torch.full((S, ATR_MA_WINDOW), NAN, dtype=F32, device=device),
        bb_width_hist=torch.full(
            (S, BB_WIDTH_HISTORY), NAN, dtype=F32, device=device
        ),
    )


def init_feature_carry(buf: MarketBuffer) -> FeatureCarry:
    """Carry from the full window: every sub-carry evaluates the same
    expressions as the full-window pack, so a full recompute re-anchors the
    incremental path."""
    W = buf.window
    assert W >= 36, f"window {W} too short for carry init (need >= 36)"
    v = buf.values
    close = v[:, :, Field.CLOSE]
    high = v[:, :, Field.HIGH]
    low = v[:, :, Field.LOW]
    volume = v[:, :, Field.VOLUME]

    delta = close - shift(close, 1)
    gain = torch.clamp(delta, min=0.0)
    loss = torch.clamp(-delta, min=0.0)

    macd_line = ewm_mean(close, span=MACD_FAST, min_periods=1) - ewm_mean(
        close, span=MACD_SLOW, min_periods=1
    )
    tp = (high + low + close) * THIRD
    flow = tp * volume
    tp_delta = tp - shift(tp, 1)
    tp_fin = torch.isfinite(tp_delta)
    pos_flow_series = torch.where(tp_fin, torch.where(tp_delta > 0, flow, 0.0), NAN)
    neg_flow_series = torch.where(tp_fin, torch.where(tp_delta < 0, flow, 0.0), NAN)
    tr = true_range(high[:, -35:], low[:, -35:], close[:, -35:])[:, 1:]
    atr_series = rolling_mean(tr, ATR_WINDOW)

    k = BB_WIDTH_HISTORY
    tail = close[:, -(BB_WINDOW + k - 1):]
    mids = rolling_mean(tail, BB_WINDOW)[:, -k:]
    stds = rolling_std(tail, BB_WINDOW, ddof=0)[:, -k:]
    widths = jsafe_div(4.0 * stds, mids)  # (upper-lower)/mid = 4σ/mid

    return FeatureCarry(
        last_ts=buf.times[:, -1].to(I32),
        ema9=ewm_init(close, _A(9)),
        ema21=ewm_init(close, _A(21)),
        ema20=ewm_init(close, _A(20)),
        ema50=ewm_init(close, _A(50)),
        macd_fast=ewm_init(close, _A(MACD_FAST)),
        macd_slow=ewm_init(close, _A(MACD_SLOW)),
        macd_sig=ewm_init(macd_line, _A(MACD_SIGNAL)),
        gain_w=ewm_init(gain, 1.0 / RSI_WINDOW),
        loss_w=ewm_init(loss, 1.0 / RSI_WINDOW),
        gain_s=sum_init(gain, RSI_WINDOW),
        loss_s=sum_init(loss, RSI_WINDOW),
        pos_flow=sum_init(pos_flow_series, MFI_WINDOW),
        neg_flow=sum_init(neg_flow_series, MFI_WINDOW),
        close_m=moment_init(close, BB_WINDOW),
        vol_m=moment_init(volume, VOLUME_MA_WINDOW),
        tr_m=moment_init(tr, ATR_WINDOW),
        atr_hist=atr_series[:, -ATR_MA_WINDOW:].to(F32),
        bb_width_hist=widths.to(F32),
    )


def _col(buf: MarketBuffer, pos: int, f: Field) -> torch.Tensor:
    """(S,) column read — O(1) bytes per symbol."""
    return buf.values[:, pos, int(f)]


def _tr_at(buf: MarketBuffer, pos: int) -> torch.Tensor:
    """True range of the bar at ``pos`` from its own and the previous close."""
    h, lo = _col(buf, pos, Field.HIGH), _col(buf, pos, Field.LOW)
    pc = _col(buf, pos - 1, Field.CLOSE)
    hl = h - lo
    tr = torch.maximum(hl, torch.maximum(torch.abs(h - pc), torch.abs(lo - pc)))
    return torch.where(torch.isfinite(pc), tr, hl)


def _gain_loss_at(buf: MarketBuffer, pos: int):
    delta = _col(buf, pos, Field.CLOSE) - _col(buf, pos - 1, Field.CLOSE)
    fin = torch.isfinite(delta)
    gain = torch.where(fin, torch.clamp(delta, min=0.0), NAN)
    loss = torch.where(fin, torch.clamp(-delta, min=0.0), NAN)
    return gain, loss


def _flows_at(buf: MarketBuffer, pos: int):
    """The bar's MFI flow on its up or down side, as the reference's
    compiled advance books it. XLA turns ``(h+l+c)/3.0 - (h'+l'+c')/3.0``
    into ``s·0.333333343 - s'·0.333333343`` inside one loop fusion, where
    the newer bar's product also feeds the flow; the CPU backend then
    contracts the subtraction with the OLDER bar's single-use product:
    ``fma(-s', THIRD, round(s·THIRD))``. So two bars with equal ``h+l+c``
    give a typical-price delta of one rounding residue, not 0, and the flat
    bar is booked up or down by that residue's sign. A product of two f32
    values is exact in f64, so the f64 difference below has the FMA's sign
    (the delta is read only for its sign and finiteness), alike on the card
    and the CPU. (The full-window init and pack book such a bar as flat, as
    the reference's do.)"""
    def hlc(p):
        return _col(buf, p, Field.HIGH) + _col(buf, p, Field.LOW) + _col(buf, p, Field.CLOSE)

    tp = hlc(pos) * THIRD
    tpd = (tp.double() - hlc(pos - 1).double() * THIRD_F64).float()
    flow = tp * _col(buf, pos, Field.VOLUME)
    fin = torch.isfinite(tpd)
    pos_f = torch.where(fin, torch.where(tpd > 0, flow, 0.0), NAN)
    neg_f = torch.where(fin, torch.where(tpd < 0, flow, 0.0), NAN)
    return pos_f, neg_f


def carry_advance_masks(
    buf: MarketBuffer, last_ts: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """(advanced, stale) row masks for a one-bar advance, the one copy of
    the clean-append test every carry family shares:

    * ``advanced`` — a new latest ts whose previous slot holds exactly
      ``last_ts`` (a clean single-bar append);
    * ``stale`` — the latest ts moved any other way (a reset row reclaimed,
      a desync): the carry is kept and readers NaN-mask the row until the
      host's full recompute lands.
    """
    ts = buf.times[:, -1]
    prev_ts = buf.times[:, -2]
    advanced = (ts >= 0) & (ts != last_ts) & (prev_ts == last_ts)
    stale = (ts != last_ts) & ~advanced
    return advanced, stale


def advance_feature_carry(
    buf: MarketBuffer,
    carry: FeatureCarry,
    masks: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> tuple[FeatureCarry, torch.Tensor]:
    """Advance the carry by the buffer's newest bar on clean-append rows;
    other rows keep their state. Returns (carry', stale mask). Mid-history
    rewrites leave the latest ts alone and are invisible here: the host
    routes them to the full step. ``masks`` passes in an already computed
    :func:`carry_advance_masks` pair."""
    W = buf.window
    assert W >= MIN_INCREMENTAL_WINDOW, (
        f"window {W} too short for incremental advance "
        f"(need >= {MIN_INCREMENTAL_WINDOW})"
    )
    ts = buf.times[:, -1]
    advanced, stale = (
        masks if masks is not None else carry_advance_masks(buf, carry.last_ts)
    )

    close_new = _col(buf, -1, Field.CLOSE)
    vol_new = _col(buf, -1, Field.VOLUME)
    gain_new, loss_new = _gain_loss_at(buf, -1)
    gain_old, loss_old = _gain_loss_at(buf, -(RSI_WINDOW + 1))
    pos_new, neg_new = _flows_at(buf, -1)
    pos_old, neg_old = _flows_at(buf, -(MFI_WINDOW + 1))
    tr_new = _tr_at(buf, -1)
    tr_old = _tr_at(buf, -(ATR_WINDOW + 1))

    macd_fast = ewm_advance(carry.macd_fast, close_new, _A(MACD_FAST))
    macd_slow = ewm_advance(carry.macd_slow, close_new, _A(MACD_SLOW))
    line_new = ewm_value(macd_fast, 1) - ewm_value(macd_slow, 1)
    close_m = moment_advance(
        carry.close_m, close_new, _col(buf, -(BB_WINDOW + 1), Field.CLOSE)
    )
    tr_m = moment_advance(carry.tr_m, tr_new, tr_old)

    atr_today = moment_mean(tr_m, ATR_WINDOW)
    mid = moment_mean(close_m, BB_WINDOW)
    std = moment_std(close_m, BB_WINDOW, ddof=0)
    width_today = jsafe_div(4.0 * std, mid)

    new = FeatureCarry(
        last_ts=ts.to(I32),
        ema9=ewm_advance(carry.ema9, close_new, _A(9)),
        ema21=ewm_advance(carry.ema21, close_new, _A(21)),
        ema20=ewm_advance(carry.ema20, close_new, _A(20)),
        ema50=ewm_advance(carry.ema50, close_new, _A(50)),
        macd_fast=macd_fast,
        macd_slow=macd_slow,
        macd_sig=ewm_advance(carry.macd_sig, line_new, _A(MACD_SIGNAL)),
        gain_w=ewm_advance(carry.gain_w, gain_new, 1.0 / RSI_WINDOW),
        loss_w=ewm_advance(carry.loss_w, loss_new, 1.0 / RSI_WINDOW),
        gain_s=sum_advance(carry.gain_s, gain_new, gain_old),
        loss_s=sum_advance(carry.loss_s, loss_new, loss_old),
        pos_flow=sum_advance(carry.pos_flow, pos_new, pos_old),
        neg_flow=sum_advance(carry.neg_flow, neg_new, neg_old),
        close_m=close_m,
        vol_m=moment_advance(
            carry.vol_m, vol_new, _col(buf, -(VOLUME_MA_WINDOW + 1), Field.VOLUME)
        ),
        tr_m=tr_m,
        atr_hist=torch.cat([carry.atr_hist[:, 1:], atr_today[:, None]], dim=1),
        bb_width_hist=torch.cat(
            [carry.bb_width_hist[:, 1:], width_today[:, None]], dim=1
        ),
    )
    return tree_where(advanced, new, carry), stale


def feature_pack_from_carry(
    buf: MarketBuffer, carry: FeatureCarry, stale: torch.Tensor
) -> FeaturePack:
    """The pack read from carried state — the incremental twin of
    :func:`compute_feature_pack` (same masks, same formulas). Raw bar
    fields come from the buffer's last columns; indicator fields of STALE
    rows are NaN."""
    v = buf.values
    rsi_wilder = _rsi(ewm_value(carry.gain_w, RSI_WINDOW), ewm_value(carry.loss_w, RSI_WINDOW))
    rsi_sma = _rsi(
        sum_mean(carry.gain_s, RSI_WINDOW), sum_mean(carry.loss_s, RSI_WINDOW)
    )
    macd_last = ewm_value(carry.macd_fast, 1) - ewm_value(carry.macd_slow, 1)
    macd_signal = ewm_value(carry.macd_sig, 1)
    mfi = _rsi(
        sum_value(carry.pos_flow, MFI_WINDOW), sum_value(carry.neg_flow, MFI_WINDOW)
    )
    bb_mid = moment_mean(carry.close_m, BB_WINDOW)
    bb_std = moment_std(carry.close_m, BB_WINDOW, ddof=0)
    bb_upper = bb_mid + 2.0 * bb_std
    bb_lower = bb_mid - 2.0 * bb_std
    atr = moment_mean(carry.tr_m, ATR_WINDOW)
    hist_fin = torch.isfinite(carry.atr_hist)
    hist_cnt = hist_fin.sum(dim=-1, dtype=I32)
    atr_ma = torch.where(
        hist_cnt >= ATR_MA_WINDOW,
        fixed_order_sum(torch.where(hist_fin, carry.atr_hist, 0.0))
        / torch.clamp(hist_cnt, min=1),
        NAN,
    )
    volume_ma = moment_mean(carry.vol_m, VOLUME_MA_WINDOW)

    def nanify(x):
        return torch.where(stale, NAN, x)

    duration = v[:, -1, Field.DURATION_S]
    duration = torch.where(torch.isfinite(duration), duration, 0.0).to(I32)
    return FeaturePack(
        open_time=buf.times[:, -1],
        close_time=buf.times[:, -1] + duration,
        open=v[:, -1, Field.OPEN],
        high=v[:, -1, Field.HIGH],
        low=v[:, -1, Field.LOW],
        close=v[:, -1, Field.CLOSE],
        prev_close=v[:, -2, Field.CLOSE],
        volume=v[:, -1, Field.VOLUME],
        quote_volume=v[:, -1, Field.QUOTE_VOLUME],
        num_trades=v[:, -1, Field.NUM_TRADES],
        rsi=nanify(rsi_sma),
        rsi_wilder=nanify(rsi_wilder),
        macd=nanify(macd_last),
        macd_signal=nanify(macd_signal),
        mfi=nanify(mfi),
        bb_upper=nanify(bb_upper),
        bb_mid=nanify(bb_mid),
        bb_lower=nanify(bb_lower),
        bb_widths=torch.where(stale[:, None], NAN, carry.bb_width_hist),
        atr=nanify(atr),
        atr_ma=nanify(atr_ma),
        volume_ma=nanify(volume_ma),
        ema9=nanify(ewm_value(carry.ema9, 1)),
        ema21=nanify(ewm_value(carry.ema21, 1)),
        filled=buf.filled,
        valid=buf.filled > 0,
    )


def compute_feature_pack_incremental(
    buf: MarketBuffer, carry: FeatureCarry
) -> tuple[FeaturePack, FeatureCarry]:
    """One-bar advance and readout: the pack of the newest bar from the
    carry, and the advanced carry."""
    new_carry, stale = advance_feature_carry(buf, carry)
    return feature_pack_from_carry(buf, new_carry, stale), new_carry


# ---------------------------------------------------------------------------
# The backtest's extension-invariant pack: T ticks from one series pass
# ---------------------------------------------------------------------------


def ext_gather(series: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Per-tick gather from an (S, L) extended series: ``out[t, s] =
    series[s, idx[t, s]]``, the (T, S) batch of what each backtest tick's
    right-aligned window view holds at the gathered column."""
    T = idx.shape[0]
    return torch.gather(series[None].expand((T,) + tuple(series.shape)), 2,
                        idx.long()[:, :, None])[..., 0]


def compute_feature_pack_ext(
    ext_times: torch.Tensor,  # (S, L) int32, -1 pad
    ext_vals: torch.Tensor,  # (S, L, F) f32, NaN pad
    counts: torch.Tensor,  # (T, S) int32 bars applied through tick t
    filled0: torch.Tensor,  # (S,) pre-chunk fill
    window: int,
) -> FeaturePack:
    """The T per-tick FeaturePacks from ONE pass over the (S, L = W + N)
    extended series; tick t's pack is the gather at ``counts[t] + window -
    1``. Leaves are (T, S)-leading ((T, S, BB_WIDTH_HISTORY) for
    ``bb_widths``).

    Numeric contract (the reference's ``BQT_EXT_INVARIANT`` one): positional
    fields (bar values, times, filled) are bit-identical to the per-tick
    pack; windowed sums, means and stds anchor their cumsums at the series
    start instead of each view's window start (float32 ulps apart); EWM
    fields also see the prefix before the window, a ``(1-alpha)^W``-scale
    divergence. Strategies gating on them declare a gate margin
    (``strategies/params.py declared_gate_margins``)."""
    from binquant_tpu_torch.ops.rolling import rolling_sum

    close = ext_vals[:, :, Field.CLOSE]
    high = ext_vals[:, :, Field.HIGH]
    low = ext_vals[:, :, Field.LOW]
    open_ = ext_vals[:, :, Field.OPEN]
    volume = ext_vals[:, :, Field.VOLUME]

    last = counts.to(I32) + (window - 1)  # (T, S)

    def g(s):
        return ext_gather(s, last)

    delta = close - shift(close, 1)
    gain = torch.clamp(delta, min=0.0)
    loss = torch.clamp(-delta, min=0.0)
    rsi_wilder = _rsi(
        g(ewm_mean(gain, alpha=1.0 / RSI_WINDOW, min_periods=RSI_WINDOW)),
        g(ewm_mean(loss, alpha=1.0 / RSI_WINDOW, min_periods=RSI_WINDOW)),
    )
    rsi_sma = _rsi(g(rolling_mean(gain, RSI_WINDOW)), g(rolling_mean(loss, RSI_WINDOW)))

    macd_line = ewm_mean(close, span=MACD_FAST, min_periods=1) - ewm_mean(
        close, span=MACD_SLOW, min_periods=1
    )
    macd_last = g(macd_line)
    macd_signal = g(ewm_mean(macd_line, span=MACD_SIGNAL, min_periods=1))

    # MFI: NaN-marked flow series + NaN-aware rolling sums reproduce the
    # view's >= 14 finite-delta gate exactly
    tp = (high + low + close) / torch.full((), 3.0, device=close.device)
    flow = tp * volume
    tp_delta = tp - shift(tp, 1)
    fin = torch.isfinite(tp_delta)
    pos_series = torch.where(fin, torch.where(tp_delta > 0, flow, 0.0), NAN)
    neg_series = torch.where(fin, torch.where(tp_delta < 0, flow, 0.0), NAN)
    mfi = _rsi(g(rolling_sum(pos_series, MFI_WINDOW)), g(rolling_sum(neg_series, MFI_WINDOW)))

    mids = rolling_mean(close, BB_WINDOW)
    stds = rolling_std(close, BB_WINDOW, ddof=0)
    uppers = mids + 2.0 * stds
    lowers = mids - 2.0 * stds
    width_series = jsafe_div(uppers - lowers, mids)
    k = BB_WIDTH_HISTORY
    T = last.shape[0]
    hist_cols = last[:, :, None] + torch.arange(-(k - 1), 1, dtype=I32, device=last.device)
    bb_widths = torch.gather(
        width_series[None].expand((T,) + tuple(width_series.shape)), 2, hist_cols.long()
    )

    # the view path's dropped first TR is never among the positions atr and
    # atr_ma consume (deepest reach: last - 32)
    tr = true_range(high, low, close)
    atr_series = rolling_mean(tr, ATR_WINDOW)

    open_time = ext_gather(ext_times, last)
    duration = g(ext_vals[:, :, Field.DURATION_S])
    duration = torch.where(torch.isfinite(duration), duration, 0.0).to(I32)
    filled = torch.clamp(filled0[None, :] + counts, max=window).to(I32)
    return FeaturePack(
        open_time=open_time,
        close_time=open_time + duration,
        open=g(open_),
        high=g(high),
        low=g(low),
        close=g(close),
        prev_close=ext_gather(close, last - 1),
        volume=g(volume),
        quote_volume=g(ext_vals[:, :, Field.QUOTE_VOLUME]),
        num_trades=g(ext_vals[:, :, Field.NUM_TRADES]),
        rsi=rsi_sma,
        rsi_wilder=rsi_wilder,
        macd=macd_last,
        macd_signal=macd_signal,
        mfi=mfi,
        bb_upper=g(uppers),
        bb_mid=g(mids),
        bb_lower=g(lowers),
        bb_widths=bb_widths,
        atr=g(atr_series),
        atr_ma=g(rolling_mean(atr_series, ATR_MA_WINDOW)),
        volume_ma=g(rolling_mean(volume, VOLUME_MA_WINDOW)),
        ema9=g(ewm_mean(close, span=9, min_periods=1)),
        ema21=g(ewm_mean(close, span=21, min_periods=1)),
        filled=filled,
        valid=filled > 0,
    )
