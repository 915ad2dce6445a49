"""ActivityBurstPump — 5m volume/price-burst long entry, batched.

Port of the full-tail kernel of ``binquant_tpu/strategies/activity_burst_pump.py``
(:func:`abp_core`, :func:`_abp_outputs`, :func:`activity_burst_pump`):
shifted rolling-median volume baselines, price jump/range/body/close-to-high
quality flags, the burst score against the shifted rolling 92nd percentile
of its own history, and the 3-bar cooldown. Long-only; a valid context that
denies long autotrade suppresses the signal, a missing context emits with
autotrade off.

The 92nd-percentile threshold is the repository's one hand-written kernel:
``ops.quantile_tail.rolling_quantile_tail`` launches ``csrc/qtail.cu`` on
the card at every call site here: :func:`abp_core` (every full tick),
:func:`abp_init_from_window` (every carry resync, and the drift meter's
fresh init on every audit tick, counted as the ``carry_drift`` site) and
:func:`abp_core_batch` (the backtest chunk's T ticks from one pass over the
extended series, twice per chunk).

The incremental tick reads the strategy from a carry instead
(:class:`ABPCarry`): sorted windows of the shifted volume series and of the
shifted score (``ops.incremental.SortedCarry``), a score ring feeding the
score window's entering and leaving samples, and a raw-signal ring for the
cooldown. :func:`abp_advance_one_bar` moves them by one bar and
:func:`activity_burst_pump_from_carry` reads the same outputs from them,
with the threshold from the sorted score window — no kernel launch on an
incremental tick. The last-bar math both carry functions share is
:func:`_abp_last_bar`, expression for expression the full kernel's formulas
at the newest position.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from binquant_tpu_torch.engine.buffer import Field, MarketBuffer
from binquant_tpu_torch.ops.incremental import (
    SortedCarry,
    sorted_advance,
    sorted_init,
    sorted_median,
    sorted_quantile,
    tree_where,
)
from binquant_tpu_torch.ops.quantile_tail import rolling_quantile_tail
from binquant_tpu_torch.ops.rolling import rolling_median, shift
from binquant_tpu_torch.regime.context import MarketContext
from binquant_tpu_torch.regime.routing import allows_long_autotrade_mask
from binquant_tpu_torch.strategies.base import StrategyOutputs


class ABPParams(NamedTuple):
    volume_multiplier: float = 2.75
    quote_volume_multiplier: float = 2.5
    price_threshold: float = 0.01
    lookback_window: int = 20
    min_baseline_volume: float = 1e-8
    min_range_frac: float = 0.012
    min_body_frac: float = 0.45
    max_close_to_high: float = 0.35
    min_recent_up_closes: int = 2
    score_quantile: float = 0.92
    score_lookback: int = 80
    cooldown_bars: int = 3


# threshold at the cooldown positions needs scores score_lookback+cooldown
# back, each needing lookback+2 bars of baseline history: 128 covers it
TAIL = 128

ROUTE_UNAVAILABLE = 0  # "market_context_unavailable"
ROUTE_ALLOWED = 1  # "long_autotrade_allowed"


def _baseline_window(p: ABPParams) -> int:
    """Rolling window after shift(2)."""
    return max(p.lookback_window, 2) - 1


class _LastBar(NamedTuple):
    """Newest-position intermediates shared by the carry advance and the
    carry readout."""

    baseline_safe: torch.Tensor
    volume_ratio: torch.Tensor
    quote_ratio: torch.Tensor
    price_jump: torch.Tensor
    range_frac: torch.Tensor
    body_frac: torch.Tensor
    score: torch.Tensor
    threshold_filled: torch.Tensor
    raw: torch.Tensor
    volume: torch.Tensor


def _col(buf: MarketBuffer, pos: int, f: Field) -> torch.Tensor:
    """(S,) column read — O(1) bytes per symbol."""
    return buf.values[:, pos, int(f)]


def _abp_last_bar(
    buf5: MarketBuffer,
    vol_med: SortedCarry,
    qvol_med: SortedCarry,
    score_q: SortedCarry,
    has_qav: torch.Tensor,
    p: ABPParams,
) -> _LastBar:
    """The kernel's newest-position math from carried order statistics and
    a dozen (S,) column reads: the formulas of :func:`abp_core` at the last
    tail position, so a carried score equals the full path's recompute."""
    bw = _baseline_window(p)
    minb = p.min_baseline_volume
    volume = _col(buf5, -1, Field.VOLUME)
    quote_volume = _col(buf5, -1, Field.QUOTE_VOLUME)
    close = _col(buf5, -1, Field.CLOSE)
    open_ = _col(buf5, -1, Field.OPEN)
    high = _col(buf5, -1, Field.HIGH)
    low = _col(buf5, -1, Field.LOW)
    c1 = _col(buf5, -2, Field.CLOSE)
    c2 = _col(buf5, -3, Field.CLOSE)
    c3 = _col(buf5, -4, Field.CLOSE)

    baseline_safe = torch.clamp(sorted_median(vol_med, min_periods=bw), min=minb)
    volume_ratio = volume / baseline_safe
    q_baseline_safe = torch.clamp(sorted_median(qvol_med, min_periods=bw), min=minb)
    quote_ratio = torch.where(has_qav, quote_volume / q_baseline_safe, 1.0)

    prev_close = torch.clamp(c1, min=minb)
    candle_range = torch.clamp(high - low, min=minb)
    body = torch.abs(close - open_)

    price_jump = (close - c1) / prev_close
    range_frac = candle_range / torch.clamp(close, min=minb)
    body_frac = body / candle_range
    close_to_high = (high - close) / candle_range
    is_bullish = close > open_
    # a NaN close compares False -> 0.0, the full path's shift fill
    recent_up = (
        (close > c1).to(torch.float32)
        + (c1 > c2).to(torch.float32)
        + (c2 > c3).to(torch.float32)
    )

    vol_spike = volume > p.volume_multiplier * baseline_safe
    quote_spike = torch.where(
        has_qav, quote_volume > p.quote_volume_multiplier * q_baseline_safe, True
    )
    jump_flag = price_jump > p.price_threshold
    range_flag = range_frac > p.min_range_frac
    body_flag = (
        is_bullish & (body_frac > p.min_body_frac) & (close_to_high < p.max_close_to_high)
    )
    trend_flag = recent_up >= torch.where(
        has_qav, float(p.min_recent_up_closes), 1.0
    )
    score = torch.where(
        has_qav,
        volume_ratio * quote_ratio * torch.clamp(price_jump, min=0.0) * (1.0 + body_frac),
        volume_ratio * torch.clamp(price_jump, min=0.0),
    )
    threshold = sorted_quantile(score_q, p.score_quantile, min_periods=p.lookback_window)
    threshold_filled = torch.where(torch.isfinite(threshold), threshold, 0.0)
    raw = (
        vol_spike
        & quote_spike
        & jump_flag
        & range_flag
        & body_flag
        & trend_flag
        & torch.isfinite(score)
        & (score >= threshold_filled)
    )
    return _LastBar(
        baseline_safe=baseline_safe,
        volume_ratio=volume_ratio,
        quote_ratio=quote_ratio,
        price_jump=price_jump,
        range_frac=range_frac,
        body_frac=body_frac,
        score=score,
        threshold_filled=threshold_filled,
        raw=raw,
        volume=volume,
    )


def _abp_outputs(
    filled: torch.Tensor,
    context: MarketContext,
    qualified: torch.Tensor,
    score_last: torch.Tensor,
    diag: dict[str, torch.Tensor],
    p: ABPParams,
) -> StrategyOutputs:
    """Trigger gating + output assembly (keys, order and dtypes fixed: the
    wire's emission layout is read from them)."""
    fired = qualified & (filled >= p.lookback_window + 1)
    gate = allows_long_autotrade_mask(context)
    has_context = context.valid
    fired = fired & (~has_context | gate)
    autotrade = fired & has_context & gate
    route = torch.where(has_context, ROUTE_ALLOWED, ROUTE_UNAVAILABLE)
    S = filled.shape[0]
    dev = filled.device
    return StrategyOutputs(
        trigger=fired,
        direction=torch.zeros((S,), dtype=torch.int32, device=dev),
        score=torch.where(torch.isfinite(score_last), score_last, 0.0),
        autotrade=autotrade,
        stop_loss_pct=torch.zeros((S,), dtype=torch.float32, device=dev),
        diagnostics={
            **diag,
            "route": torch.broadcast_to(route, (S,)).to(torch.int32),
        },
    )


class _Tail(NamedTuple):
    """The full kernel's series over the trailing TAIL bars, shared by the
    full tick (:func:`abp_core`) and the carry init
    (:func:`abp_init_from_window`); ``threshold_filled`` and ``raw`` cover
    the trailing ``cooldown_bars+1`` positions only."""

    volume: torch.Tensor
    quote_volume: torch.Tensor
    has_qav: torch.Tensor  # (S, 1)
    baseline_safe: torch.Tensor
    volume_ratio: torch.Tensor
    quote_ratio: torch.Tensor
    price_jump: torch.Tensor
    range_frac: torch.Tensor
    body_frac: torch.Tensor
    score: torch.Tensor
    threshold_filled: torch.Tensor
    raw: torch.Tensor


def _abp_tail(buf5: MarketBuffer, p: ABPParams, site: str) -> _Tail:
    """The windowed math up to the raw signal at the cooldown positions.
    ``site`` names the caller at the qtail kernel's launch count."""
    v = buf5.values[:, -TAIL:]
    volume = v[:, :, Field.VOLUME]
    quote_volume = v[:, :, Field.QUOTE_VOLUME]
    close = v[:, :, Field.CLOSE]
    open_ = v[:, :, Field.OPEN]
    high = v[:, :, Field.HIGH]
    low = v[:, :, Field.LOW]
    minb = p.min_baseline_volume

    bw = _baseline_window(p)
    baseline = rolling_median(shift(volume, 2), bw, min_periods=bw)
    baseline_safe = torch.clamp(baseline, min=minb)
    volume_ratio = volume / baseline_safe

    # feeds without quote volume: quote confirmation is neutral
    has_qav = (quote_volume > 0).any(dim=-1, keepdim=True)
    q_baseline = rolling_median(shift(quote_volume, 2), bw, min_periods=bw)
    q_baseline_safe = torch.clamp(q_baseline, min=minb)
    quote_ratio = torch.where(has_qav, quote_volume / q_baseline_safe, 1.0)

    prev_close = torch.clamp(shift(close, 1), min=minb)
    candle_range = torch.clamp(high - low, min=minb)
    body = torch.abs(close - open_)

    price_jump = (close - shift(close, 1)) / prev_close
    range_frac = candle_range / torch.clamp(close, min=minb)
    body_frac = body / candle_range
    close_to_high = (high - close) / candle_range
    is_bullish = close > open_
    up_close = (close > shift(close, 1)).to(torch.float32)
    recent_up = up_close + shift(up_close, 1, 0.0) + shift(up_close, 2, 0.0)

    vol_spike = volume > p.volume_multiplier * baseline_safe
    quote_spike = torch.where(
        has_qav, quote_volume > p.quote_volume_multiplier * q_baseline_safe, True
    )
    jump_flag = price_jump > p.price_threshold
    range_flag = range_frac > p.min_range_frac
    body_flag = (
        is_bullish & (body_frac > p.min_body_frac) & (close_to_high < p.max_close_to_high)
    )
    trend_flag = recent_up >= torch.where(
        has_qav, float(p.min_recent_up_closes), 1.0
    )

    score = torch.where(
        has_qav,
        volume_ratio * quote_ratio * torch.clamp(price_jump, min=0.0) * (1.0 + body_frac),
        volume_ratio * torch.clamp(price_jump, min=0.0),
    )
    # the cooldown reads `raw` at the trailing cooldown_bars+1 positions
    # only, so the threshold is computed for just those windows — by the
    # hand-written kernel on the card
    n_out = p.cooldown_bars + 1
    threshold_tail = rolling_quantile_tail(
        shift(score, 1).contiguous(), p.score_lookback, p.score_quantile,
        num_out=n_out, min_periods=p.lookback_window, site=site,
    )
    threshold_filled = torch.where(
        torch.isfinite(threshold_tail), threshold_tail, 0.0
    )

    def tail_n(a):
        return a[:, -n_out:]

    raw = (
        tail_n(vol_spike)
        & tail_n(quote_spike)
        & tail_n(jump_flag)
        & tail_n(range_flag)
        & tail_n(body_flag)
        & tail_n(trend_flag)
        & torch.isfinite(tail_n(score))
        & (tail_n(score) >= threshold_filled)
    )
    return _Tail(
        volume=volume, quote_volume=quote_volume, has_qav=has_qav,
        baseline_safe=baseline_safe, volume_ratio=volume_ratio,
        quote_ratio=quote_ratio, price_jump=price_jump, range_frac=range_frac,
        body_frac=body_frac, score=score, threshold_filled=threshold_filled, raw=raw,
    )


def abp_core(
    buf5: MarketBuffer, params: ABPParams = ABPParams()
) -> tuple[torch.Tensor, torch.Tensor, dict[str, torch.Tensor]]:
    """The context-free heavy half: the full-tail windowed math up to the
    cooldown-gated ``qualified`` mask. Returns ``(qualified, score_last,
    diagnostics)``."""
    t = _abp_tail(buf5, params, "abp_core")
    # 3-bar cooldown: any raw signal in the previous cooldown_bars bars
    qualified = t.raw[:, -1] & ~t.raw[:, :-1].any(dim=-1)
    return (
        qualified,
        t.score[:, -1],
        {
            "baseline_volume": t.baseline_safe[:, -1],
            "volume_ratio": t.volume_ratio[:, -1],
            "quote_volume_ratio": t.quote_ratio[:, -1],
            "price_jump": t.price_jump[:, -1],
            "range_frac": t.range_frac[:, -1],
            "body_frac": t.body_frac[:, -1],
            "score_threshold": t.threshold_filled[:, -1],
            "volume": t.volume[:, -1],
        },
    )


def activity_burst_pump(
    buf5: MarketBuffer,
    context: MarketContext,
    params: ABPParams = ABPParams(),
) -> StrategyOutputs:
    qualified, score_last, diag = abp_core(buf5, params)
    return _abp_outputs(buf5.filled, context, qualified, score_last, diag, params)


# The extended-series twin needs every consumed rolling window to fit inside
# the ring without touching its left edge (where the per-tick view and the
# extension differ — the view truncates, the extension holds older real
# bars): the threshold at the earliest cooldown position reads scores
# score_lookback back, each score the shifted baseline window another bw+2.
def _abp_ext_min_window(p: ABPParams) -> int:
    return p.score_lookback + _baseline_window(p) + 2 + p.cooldown_bars + 1


ABP_EXT_MIN_WINDOW = _abp_ext_min_window(ABPParams())


def abp_core_batch(
    ext_vals: torch.Tensor,  # (S, L, F) extended series (ring + appends)
    counts: torch.Tensor,  # (T, S) int32 — bars applied through tick t
    window: int,  # ring width W (tick t's view = columns [counts_t, +W))
    params: ABPParams = ABPParams(),
) -> tuple[torch.Tensor, torch.Tensor, dict[str, torch.Tensor]]:
    """T ticks of :func:`abp_core` from ONE pass over the extended series.

    Every rolling input of the kernel is position-local and sort/shift
    based, so a value at extended position ``p`` is bit-identical to the
    per-tick view's value at the matching position whenever the consumed
    windows stay inside the ring (the window guard below): the T
    overlapping per-tick tails collapse into one series pass + (T, S)
    gathers. The one per-tick whole-window input, ``has_qav``, becomes a
    rolling any; the score, threshold and raw series are computed for both
    of its variants and selected per (tick, row) at readout.

    Both threshold series are the qtail kernel's (site ``abp_core_batch``)
    at shape ``(S, min(L, TAIL + n_ext))`` with ``num_out = n_ext +
    cooldown_bars + 1``: two launches per call. Returns ``(qualified (T,
    S), score_last (T, S), diag of (T, S))``."""
    from binquant_tpu_torch.ops.rolling import rolling_max

    p = params
    if window < _abp_ext_min_window(p):
        raise ValueError(
            f"window {window} too short for the extended-series ABP core "
            f"(need >= {_abp_ext_min_window(p)})"
        )
    S, L, _ = ext_vals.shape
    n_ext = L - window
    # trailing working slice: the union of every tick's consumed tail
    K = min(L, TAIL + n_ext)
    off = L - K

    def col(f):
        return ext_vals[:, off:, int(f)]

    volume = col(Field.VOLUME)
    quote_volume = col(Field.QUOTE_VOLUME)
    close = col(Field.CLOSE)
    open_ = col(Field.OPEN)
    high = col(Field.HIGH)
    low = col(Field.LOW)

    bw = _baseline_window(p)
    minb = p.min_baseline_volume
    baseline_safe = torch.clamp(rolling_median(shift(volume, 2), bw, min_periods=bw), min=minb)
    volume_ratio = volume / baseline_safe
    q_baseline_safe = torch.clamp(
        rolling_median(shift(quote_volume, 2), bw, min_periods=bw), min=minb
    )
    quote_ratio_q = quote_volume / q_baseline_safe

    prev_close = torch.clamp(shift(close, 1), min=minb)
    candle_range = torch.clamp(high - low, min=minb)
    body = torch.abs(close - open_)
    price_jump = (close - shift(close, 1)) / prev_close
    range_frac = candle_range / torch.clamp(close, min=minb)
    body_frac = body / candle_range
    close_to_high = (high - close) / candle_range
    is_bullish = close > open_
    up_close = (close > shift(close, 1)).to(torch.float32)
    recent_up = up_close + shift(up_close, 1, 0.0) + shift(up_close, 2, 0.0)

    score_q = (
        volume_ratio * quote_ratio_q * torch.clamp(price_jump, min=0.0) * (1.0 + body_frac)
    )
    score_n = volume_ratio * torch.clamp(price_jump, min=0.0)

    vol_spike = volume > p.volume_multiplier * baseline_safe
    quote_spike_q = quote_volume > p.quote_volume_multiplier * q_baseline_safe
    jump_flag = price_jump > p.price_threshold
    range_flag = range_frac > p.min_range_frac
    body_flag = (
        is_bullish & (body_frac > p.min_body_frac) & (close_to_high < p.max_close_to_high)
    )
    trend_q = recent_up >= p.min_recent_up_closes
    trend_n = recent_up >= 1

    # thresholds at the union of every tick's cooldown positions, by the
    # hand-written kernel on the card
    n_out = min(n_ext + p.cooldown_bars + 1, K)
    thr_q, thr_n = (
        rolling_quantile_tail(
            shift(score, 1).contiguous(), p.score_lookback, p.score_quantile,
            num_out=n_out, min_periods=p.lookback_window, site="abp_core_batch",
        )
        for score in (score_q, score_n)
    )
    thr_q_f = torch.where(torch.isfinite(thr_q), thr_q, 0.0)
    thr_n_f = torch.where(torch.isfinite(thr_n), thr_n, 0.0)

    def tail_n(a):
        return a[:, -n_out:]

    base_flags = tail_n(vol_spike) & tail_n(jump_flag) & tail_n(range_flag) & tail_n(body_flag)
    raw_q = (
        base_flags & tail_n(quote_spike_q) & tail_n(trend_q)
        & torch.isfinite(tail_n(score_q)) & (tail_n(score_q) >= thr_q_f)
    )
    raw_n = (
        base_flags & tail_n(trend_n)
        & torch.isfinite(tail_n(score_n)) & (tail_n(score_n) >= thr_n_f)
    )

    # per-tick has_qav: the kernel's whole-view any over the last
    # min(W, TAIL) columns, as a rolling any over the full extension
    TW = min(window, TAIL)
    qpos = (ext_vals[:, :, int(Field.QUOTE_VOLUME)] > 0).to(torch.float32)
    any_q = rolling_max(qpos, TW, min_periods=1) > 0  # (S, L)

    T = counts.shape[0]
    last_idx = counts.to(torch.int64) + (window - 1)  # absolute extended position

    def g_abs(arr: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        """arr (S, N) at per-(tick, row) absolute positions -> (T, S)."""
        rel = idx - (L - arr.shape[1])
        return torch.gather(arr[None].expand((T,) + tuple(arr.shape)), 2, rel[:, :, None])[..., 0]

    has_qav = g_abs(any_q, last_idx)

    def sel(a_q, a_n):
        return torch.where(has_qav, g_abs(a_q, last_idx), g_abs(a_n, last_idx))

    raws = [
        torch.where(has_qav, g_abs(raw_q, last_idx - k), g_abs(raw_n, last_idx - k))
        for k in range(p.cooldown_bars + 1)
    ]
    qualified = raws[0]
    for r in raws[1:]:
        qualified = qualified & ~r

    diag = {
        "baseline_volume": g_abs(baseline_safe, last_idx),
        "volume_ratio": g_abs(volume_ratio, last_idx),
        "quote_volume_ratio": torch.where(has_qav, g_abs(quote_ratio_q, last_idx), 1.0),
        "price_jump": g_abs(price_jump, last_idx),
        "range_frac": g_abs(range_frac, last_idx),
        "body_frac": g_abs(body_frac, last_idx),
        "score_threshold": sel(thr_q_f, thr_n_f),
        "volume": g_abs(volume, last_idx),
    }
    return qualified, sel(score_q, score_n), diag


# ---------------------------------------------------------------------------
# Incremental carry: the same kernel in O(window) merges per symbol per tick
# ---------------------------------------------------------------------------


class ABPCarry(NamedTuple):
    """Carried ActivityBurstPump state, (S,)/(S, k) leaves.

    ``vol_med``/``qvol_med`` hold ``shift(volume, 2)``'s trailing window
    (entering sample: the ring column three back), ``score_q`` holds
    ``shift(score, 1)``'s, fed from ``score_ring``; ``raw_ring`` is the raw
    signal at the trailing ``cooldown_bars+1`` positions. A ``has_qav``
    flip (a feed starting or stopping quote volume) switches the whole
    score formula, which no one-bar advance can rewrite: it sets ``dirty``,
    the row cannot fire, and the next full recompute clears it.
    """

    vol_med: SortedCarry
    qvol_med: SortedCarry
    score_q: SortedCarry
    score_ring: torch.Tensor  # (S, score_lookback+1) f32, oldest first
    raw_ring: torch.Tensor  # (S, cooldown_bars+1) bool, oldest first
    has_qav: torch.Tensor  # (S,) bool
    dirty: torch.Tensor  # (S,) bool


# the deepest column the one-bar advance reads: the baseline leaver at -(bw+3)
ABP_MIN_WINDOW = _baseline_window(ABPParams()) + 3
# the init keeps score_lookback+1 trailing scores
ABP_INIT_MIN_WINDOW = ABPParams().score_lookback + 1


def empty_abp_carry(
    num_symbols: int, p: ABPParams = ABPParams(), *, device: torch.device | str
) -> ABPCarry:
    bw = _baseline_window(p)
    S = num_symbols

    def empty_sorted(w):
        return SortedCarry(
            sorted=torch.full((S, w), float("inf"), dtype=torch.float32, device=device),
            cnt=torch.zeros((S,), dtype=torch.int32, device=device),
        )

    return ABPCarry(
        vol_med=empty_sorted(bw),
        qvol_med=empty_sorted(bw),
        score_q=empty_sorted(p.score_lookback),
        score_ring=torch.full(
            (S, p.score_lookback + 1), float("nan"), dtype=torch.float32, device=device
        ),
        raw_ring=torch.zeros((S, p.cooldown_bars + 1), dtype=torch.bool, device=device),
        has_qav=torch.zeros((S,), dtype=torch.bool, device=device),
        dirty=torch.zeros((S,), dtype=torch.bool, device=device),
    )


def abp_init_from_window(
    buf5: MarketBuffer, p: ABPParams = ABPParams(), site: str = "abp_init_from_window"
) -> ABPCarry:
    """Carry from the full tail: the series of :func:`abp_core` (one copy,
    :func:`_abp_tail`), so every readout at the init tick equals the full
    kernel's. Its cooldown-ring threshold is the kernel's second call site
    (``site`` labels the launch: the drift meter's init is ``carry_drift``)."""
    # the ring slices below pin the carry's leaf shapes
    assert buf5.window >= p.score_lookback + 1, (
        f"window {buf5.window} too short for the ABP carry init "
        f"(need >= {p.score_lookback + 1})"
    )
    bw = _baseline_window(p)
    t = _abp_tail(buf5, p, site)
    return ABPCarry(
        vol_med=sorted_init(shift(t.volume, 2), bw),
        qvol_med=sorted_init(shift(t.quote_volume, 2), bw),
        score_q=sorted_init(shift(t.score, 1), p.score_lookback),
        score_ring=t.score[:, -(p.score_lookback + 1):].to(torch.float32),
        raw_ring=t.raw,
        has_qav=t.has_qav[:, 0],
        dirty=torch.zeros((buf5.capacity,), dtype=torch.bool, device=t.score.device),
    )


def abp_advance_one_bar(
    buf5: MarketBuffer,
    carry: ABPCarry,
    advanced: torch.Tensor,
    p: ABPParams = ABPParams(),
) -> ABPCarry:
    """Advance the carry by the buffer's newest bar on ``advanced`` rows
    (the engine's shared clean-append mask); other rows keep their state."""
    bw = _baseline_window(p)
    assert buf5.window >= bw + 3, (
        f"window {buf5.window} too short for the ABP carry advance "
        f"(deepest read -(bw+3) = -{bw + 3})"
    )
    # the shifted baseline window ends two bars back: entering sample at
    # column -3, leaver at -(bw+3)
    vol_med = sorted_advance(
        carry.vol_med, _col(buf5, -3, Field.VOLUME), _col(buf5, -(bw + 3), Field.VOLUME)
    )
    qvol_med = sorted_advance(
        carry.qvol_med,
        _col(buf5, -3, Field.QUOTE_VOLUME),
        _col(buf5, -(bw + 3), Field.QUOTE_VOLUME),
    )
    # shift(score, 1)'s window: enters last tick's score, evicts the oldest
    score_q = sorted_advance(carry.score_q, carry.score_ring[:, -1], carry.score_ring[:, 0])

    has_qav = (buf5.values[:, -TAIL:, Field.QUOTE_VOLUME] > 0).any(dim=-1)
    dirty = carry.dirty | (has_qav != carry.has_qav)

    last = _abp_last_bar(buf5, vol_med, qvol_med, score_q, has_qav, p)
    new = ABPCarry(
        vol_med=vol_med,
        qvol_med=qvol_med,
        score_q=score_q,
        score_ring=torch.cat(
            [carry.score_ring[:, 1:], last.score[:, None].to(torch.float32)], dim=1
        ),
        raw_ring=torch.cat([carry.raw_ring[:, 1:], last.raw[:, None]], dim=1),
        has_qav=has_qav,
        dirty=dirty,
    )
    return tree_where(advanced, new, carry)


def activity_burst_pump_from_carry(
    buf5: MarketBuffer,
    carry: ABPCarry,
    context: MarketContext,
    stale: torch.Tensor,
    params: ABPParams = ABPParams(),
) -> StrategyOutputs:
    """The incremental twin of :func:`activity_burst_pump`: the same
    formulas from carried order statistics and column reads. STALE rows
    (carry desynced) and DIRTY rows (has_qav flip) cannot fire."""
    p = params
    last = _abp_last_bar(
        buf5, carry.vol_med, carry.qvol_med, carry.score_q, carry.has_qav, p
    )
    # cooldown: the ring's last entry is this bar's raw (pushed by the
    # advance); the previous cooldown_bars entries veto
    qualified = last.raw & ~carry.raw_ring[:, :-1].any(dim=-1) & ~stale & ~carry.dirty
    return _abp_outputs(
        buf5.filled,
        context,
        qualified,
        last.score,
        {
            "baseline_volume": last.baseline_safe,
            "volume_ratio": last.volume_ratio,
            "quote_volume_ratio": last.quote_ratio,
            "price_jump": last.price_jump,
            "range_frac": last.range_frac,
            "body_frac": last.body_frac,
            "score_threshold": last.threshold_filled,
            "volume": last.volume,
        },
        p,
    )
