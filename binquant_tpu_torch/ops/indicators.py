"""Technical-indicator kernels the classic tick reaches, batched along the
last axis.

Port of the parts of ``binquant_tpu/ops/indicators.py`` the classic wire
step calls: ``true_range`` (feature packs, market context), ``log_returns``
and ``rolling_beta_corr`` (the BTC-relative block). The supertrend scan and
Connors RSI feed only dormant strategies and are not ported in this slice.
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
