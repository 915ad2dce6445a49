"""SpikeHunterV3's spike detector and its breadth-momentum strategy, batched.

Port of ``binquant_tpu/strategies/spike_hunter.py``: one pass over the 15m
buffer computes, for every symbol's last bar, the per-symbol
auto-calibration from whole-window quantiles, the volume-cluster, dynamic
price-break, cumulative-break and acceleration flags, the long and short
labels and the three-candle streaks. Only the last bar is consumed
downstream (RangeFailedBreakoutFade reads the flags), so each flag is
computed on its trailing slice.

The dynamic price break is the trailing 60-bar 85th percentile of the
absolute price change: :func:`rolling_quantile_tail` with
``site="detect_spikes"``, which launches ``csrc/qtail.cu`` on a CUDA tensor
(or raises) and runs the kernel's plain twin on a CPU tensor.

The strategy itself (:func:`spike_hunter`) is disabled on the reference's
live dispatch and kept for capability parity.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from binquant_tpu_torch.engine.buffer import Field, MarketBuffer
from binquant_tpu_torch.enums import Direction
from binquant_tpu_torch.ops.quantile_tail import rolling_quantile_tail
from binquant_tpu_torch.ops.rolling import rolling_mean, shift
from binquant_tpu_torch.regime.context import MarketContext
from binquant_tpu_torch.strategies.base import StrategyOutputs

I32 = torch.int32
NAN = float("nan")

# routing codes (the reference's breadth_momentum_direction)
ROUTE_LONG = 0
ROUTE_SHORT = 1
ROUTE_NO_CONTEXT = 2
ROUTE_STRESS = 3
ROUTE_BREADTH_UNAVAILABLE = 4
ROUTE_BREADTH_FLAT = 5
ROUTE_SYMBOL_NOT_CONFIRMED = 6


class SpikeParams(NamedTuple):
    """Detector thresholds and auto-calibration knobs."""

    volume_cluster_min_ratio: float = 1.6
    volume_cluster_window: int = 8
    volume_cluster_min_count: int = 2
    price_break_base_threshold: float = 0.03
    price_break_dynamic_q: float = 0.85
    cumulative_price_window: int = 3
    cumulative_price_threshold: float = 0.025
    accel_volume_deriv_window: int = 3
    accel_volume_deriv_min: float = 0.45
    accel_price_change_min: float = 0.015
    require_bullish_spike: bool = True
    base_window: int = 12  # the volume moving average's window
    calib_volume_quantile: float = 0.97
    calib_price_floor_quantile: float = 0.75
    calib_min_volume_ratio: float = 1.15
    calib_min_price_abs_floor: float = 0.015
    max_market_stress: float = 0.35


class SpikeSignal(NamedTuple):
    """The detector's last-bar verdict, (S,) each."""

    close: torch.Tensor
    label: torch.Tensor  # bool — bullish final spike
    label_short: torch.Tensor  # bool
    volume_cluster_flag: torch.Tensor  # bool
    price_break_flag: torch.Tensor  # bool
    cumulative_price_break_flag: torch.Tensor  # bool
    accel_spike_flag: torch.Tensor  # bool
    cumulative_price_break_short_flag: torch.Tensor  # bool
    accel_spike_short_flag: torch.Tensor  # bool
    upward: torch.Tensor  # bool — 3 green candles
    downward: torch.Tensor  # bool
    volume: torch.Tensor
    quote_asset_volume: torch.Tensor
    volume_ratio_threshold: torch.Tensor  # calibrated per symbol
    price_break_threshold: torch.Tensor


def _nanquantile_last(x: torch.Tensor, q: float) -> torch.Tensor:
    """``np.quantile`` over the finite values along the last axis (linear
    interpolation): one stable sort with non-finite values as +inf, the
    upper neighbour clipped to the last finite rank."""
    finite = torch.isfinite(x)
    cnt = finite.sum(dim=-1, dtype=I32)
    s, _ = torch.sort(torch.where(finite, x, float("inf")), dim=-1, stable=True)
    W = x.shape[-1]
    rank = q * (cnt.to(torch.float32) - 1.0)
    lo = torch.clamp(torch.floor(rank).to(I32), 0, W - 1)
    hi = torch.clamp(lo + 1, 0, W - 1)
    frac = rank - lo.to(torch.float32)
    v_lo = torch.gather(s, -1, lo[..., None].long())[..., 0]
    v_hi = torch.gather(
        s, -1, torch.minimum(hi, torch.clamp(cnt - 1, min=0))[..., None].long()
    )[..., 0]
    out = v_lo + (v_hi - v_lo) * frac
    return torch.where(cnt > 0, out, NAN)


def detect_spikes(buf15: MarketBuffer, params: SpikeParams = SpikeParams()) -> SpikeSignal:
    """The full detector at the last bar of every row of ``buf15``."""
    p = params
    close = buf15.values[:, :, Field.CLOSE]
    open_ = buf15.values[:, :, Field.OPEN]
    volume = buf15.values[:, :, Field.VOLUME]

    price_change = close / shift(close, 1) - 1.0
    price_change_abs = torch.abs(price_change)
    volume_ma = rolling_mean(volume, p.base_window)
    volume_ratio = volume / (volume_ma + 1e-6)
    pc_last = price_change[:, -1]
    pc_abs_last = price_change_abs[:, -1]
    vr_last = volume_ratio[:, -1]

    # auto-calibration from the whole-window distributions (a NaN quantile
    # propagates through the floors, as the reference's maximum does)
    vol_thr = torch.clamp(
        _nanquantile_last(volume_ratio, p.calib_volume_quantile), min=p.calib_min_volume_ratio
    )
    vol_thr = torch.where(torch.isfinite(vol_thr), vol_thr, p.volume_cluster_min_ratio)
    price_floor = torch.clamp(
        _nanquantile_last(price_change_abs, p.calib_price_floor_quantile),
        min=p.calib_min_price_abs_floor,
    )
    price_floor = torch.clamp(
        torch.where(torch.isfinite(price_floor), price_floor, 0.0),
        min=p.price_break_base_threshold,
    )

    # volume cluster at the live edge: threshold crossings in the trailing
    # cluster window (at least one finite sample)
    vrw = volume_ratio[:, -p.volume_cluster_window:]
    finite_vrw = torch.isfinite(vrw)
    cluster_count = (finite_vrw & (vrw >= vol_thr[:, None])).sum(dim=-1, dtype=I32)
    has_any = finite_vrw.any(dim=-1)
    vc_flag = has_any & (cluster_count >= p.volume_cluster_min_count) & (vr_last >= vol_thr)

    # dynamic price break: the trailing 60-bar quantile, on the kernel
    dyn = rolling_quantile_tail(
        price_change_abs.contiguous(), 60, p.price_break_dynamic_q, num_out=1,
        min_periods=20, site="detect_spikes",
    )[:, -1]
    thr = torch.maximum(price_floor, dyn)  # a NaN dyn (pre-warmup) stays NaN
    pb_flag = pc_abs_last >= thr

    # cumulative break over the trailing w bars
    w = p.cumulative_price_window
    pcw = price_change[:, -w:]
    finite_pcw = torch.isfinite(pcw)
    full_w = finite_pcw.sum(dim=-1, dtype=I32) >= w
    cum_pos = torch.where(finite_pcw, torch.clamp(pcw, min=0.0), 0.0).sum(dim=-1)
    cum_neg = torch.where(finite_pcw, torch.abs(torch.clamp(pcw, max=0.0)), 0.0).sum(dim=-1)
    vrw3 = volume_ratio[:, -w:]
    finite_vrw3 = torch.isfinite(vrw3)
    vol_cond = (finite_vrw3.sum(dim=-1, dtype=I32) >= w) & (
        finite_vrw3 & (vrw3 >= vol_thr[:, None] * 0.8)
    ).any(dim=-1)
    cum_flag = full_w & (cum_pos >= p.cumulative_price_threshold) & vol_cond
    cum_short_flag = full_w & (cum_neg >= p.cumulative_price_threshold) & vol_cond

    # acceleration
    k = p.accel_volume_deriv_window
    if volume_ratio.shape[-1] > k:
        vr_lag = volume_ratio[:, -1 - k]
    else:
        vr_lag = torch.full_like(vr_last, NAN)
    vol_deriv = vr_last - vr_lag
    accel_base = (vol_deriv >= p.accel_volume_deriv_min) & (
        pc_abs_last >= p.accel_price_change_min
    )
    accel_flag = accel_base & (pc_last > 0)
    accel_short_flag = accel_base & (pc_last < 0)

    # labels (require_both_patterns off, as in the reference's default)
    base_combo = vc_flag | pb_flag
    bullish = close[:, -1] > open_[:, -1]
    bearish = close[:, -1] < open_[:, -1]
    label = base_combo | cum_flag | accel_flag
    if p.require_bullish_spike:
        label = label & bullish
    label_short = (base_combo | cum_short_flag | accel_short_flag) & bearish

    # streaks: all of the last 3 candles green / red
    upward = (close[:, -3:] > open_[:, -3:]).all(dim=-1)
    downward = (close[:, -3:] < open_[:, -3:]).all(dim=-1)

    has_bars = buf15.filled > 0
    return SpikeSignal(
        close=close[:, -1],
        label=label & has_bars,
        label_short=label_short & has_bars,
        volume_cluster_flag=vc_flag,
        price_break_flag=pb_flag,
        cumulative_price_break_flag=cum_flag,
        accel_spike_flag=accel_flag,
        cumulative_price_break_short_flag=cum_short_flag,
        accel_spike_short_flag=accel_short_flag,
        upward=upward,
        downward=downward,
        volume=buf15.values[:, -1, Field.VOLUME],
        quote_asset_volume=buf15.values[:, -1, Field.QUOTE_VOLUME],
        volume_ratio_threshold=vol_thr,
        price_break_threshold=torch.where(torch.isfinite(thr), thr, price_floor),
    )


def spike_hunter(
    spikes: SpikeSignal,
    context: MarketContext,
    breadth_momentum_points: torch.Tensor,  # scalar f32, NaN = unavailable
    params: SpikeParams = SpikeParams(),
) -> StrategyOutputs:
    """The breadth-momentum direction confirmed by the symbol's spike flags.
    Kept for capability parity: the reference's live dispatch disables it."""
    has_context = context.valid
    stress_ok = context.market_stress_score < params.max_market_stress
    has_momentum = torch.isfinite(breadth_momentum_points)
    go_long = has_momentum & (breadth_momentum_points > 0.0)
    go_short = has_momentum & (breadth_momentum_points < 0.0)

    long_confirm = (
        spikes.cumulative_price_break_flag | spikes.volume_cluster_flag | spikes.accel_spike_flag
    ) & spikes.upward
    short_confirm = (
        spikes.cumulative_price_break_short_flag
        | spikes.volume_cluster_flag
        | spikes.accel_spike_short_flag
    ) & spikes.downward

    fired = has_context & stress_ok & ((go_long & long_confirm) | (go_short & short_confirm))
    S = spikes.close.shape[0]
    dev = spikes.close.device
    direction = torch.where(go_short, int(Direction.SHORT), int(Direction.LONG)).to(I32)
    direction = torch.broadcast_to(direction, (S,))

    def code(c: int) -> torch.Tensor:
        return torch.full((), int(c), dtype=I32, device=dev)

    route = torch.where(
        ~has_context,
        code(ROUTE_NO_CONTEXT),
        torch.where(
            ~stress_ok,
            code(ROUTE_STRESS),
            torch.where(
                ~has_momentum,
                code(ROUTE_BREADTH_UNAVAILABLE),
                torch.where(
                    go_long,
                    torch.where(long_confirm, code(ROUTE_LONG), code(ROUTE_SYMBOL_NOT_CONFIRMED)),
                    torch.where(
                        go_short,
                        torch.where(
                            short_confirm, code(ROUTE_SHORT), code(ROUTE_SYMBOL_NOT_CONFIRMED)
                        ),
                        code(ROUTE_BREADTH_FLAT),
                    ),
                ),
            ),
        ),
    )
    route = torch.broadcast_to(route, (S,))
    zeros = torch.zeros((S,), dtype=torch.float32, device=dev)
    return StrategyOutputs(
        trigger=fired,
        direction=direction,
        score=zeros,
        autotrade=fired,
        stop_loss_pct=zeros,
        diagnostics={
            "route": route,
            "volume": spikes.volume,
            "quote_asset_volume": spikes.quote_asset_volume,
            "upward": spikes.upward,
            "downward": spikes.downward,
        },
    )
