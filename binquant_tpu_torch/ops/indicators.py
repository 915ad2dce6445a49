"""Technical-indicator kernels the classic tick reaches, batched along the
last axis.

Port of the parts of ``binquant_tpu/ops/indicators.py`` the live wire step
calls: ``true_range`` (feature packs, market context), ``log_returns`` and
``rolling_beta_corr`` (the BTC-relative block), and the supertrend
recursion (``_supertrend_step``, ``supertrend_scan_init``,
``_supertrend_scan``), whose final carry every full recompute of the
incremental engine keeps, and whose series :func:`supertrend_from` gives
the dormant SupertrendSwingReversal. The reference's other indicators
(``connors_rsi``, ``adx``, ...) feed no ported path and are not ported.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from binquant_tpu_torch.ops.rolling import rolling_mean, rolling_var, shift
from binquant_tpu_torch.utils import jsafe_div


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
    line: torch.Tensor  # (..., W) supertrend line, NaN until warm
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
