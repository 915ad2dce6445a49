"""Rolling-window primitives along the last axis, pandas-parity semantics.

Port of ``binquant_tpu/ops/rolling.py``. Every function takes ``(..., W)``
tensors; NaN encodes missing/warm-up exactly as pandas does, and rolling
reducers honour ``min_periods``.

* Moments via cumsum on row-centered data. The summation order differs from
  the reference's (torch's CPU cumsum accumulates in float64 and rounds each
  output; the card's scans in float32), so cumsum-derived outputs agree to
  a few float32 ulps, not bit for bit.
* EWM as a matmul against a cached lower-triangular decay matrix plus an
  exact warm-start correction. ``torch.matmul`` runs in full float32 here
  (the package turns TF32 off at import).
* Extrema via ``unfold`` + ``amax``/``amin`` over a left-padded view.
* Quantiles via an explicit windowed sort — positional, so bit-exact.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

NAN = float("nan")
INF = float("inf")


def shift(x: torch.Tensor, n: int = 1, fill_value: float = NAN) -> torch.Tensor:
    """pandas .shift(n) along the last axis (n may be negative)."""
    if n == 0:
        return x
    W = x.shape[-1]
    if abs(n) >= W:
        return torch.full_like(x, fill_value)
    pad = torch.full(
        x.shape[:-1] + (abs(n),), fill_value, dtype=x.dtype, device=x.device
    )
    if n > 0:
        return torch.cat([pad, x[..., :-n]], dim=-1)
    return torch.cat([x[..., -n:], pad], dim=-1)


def diff(x: torch.Tensor, n: int = 1) -> torch.Tensor:
    return x - shift(x, n)


def _window_sums(
    x: torch.Tensor, window: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """NaN-aware (windowed sum, windowed finite-count) via cumsum."""
    m = torch.isfinite(x)
    xf = torch.where(m, x, 0.0)
    cs = torch.cumsum(xf, dim=-1)
    cn = torch.cumsum(m.to(x.dtype), dim=-1)
    return cs - shift(cs, window, 0.0), cn - shift(cn, window, 0.0)


def _resolve_min_periods(window: int, min_periods: int | None) -> int:
    return window if min_periods is None else min_periods


def rolling_sum(
    x: torch.Tensor, window: int, min_periods: int | None = None
) -> torch.Tensor:
    wsum, cnt = _window_sums(x, window)
    return torch.where(cnt >= _resolve_min_periods(window, min_periods), wsum, NAN)


def rolling_mean(
    x: torch.Tensor, window: int, min_periods: int | None = None
) -> torch.Tensor:
    wsum, cnt = _window_sums(x, window)
    mp = max(_resolve_min_periods(window, min_periods), 1)
    return torch.where(
        cnt >= mp, wsum / torch.where(cnt > 0, cnt, torch.ones_like(cnt)), NAN
    )


def rolling_var(
    x: torch.Tensor, window: int, min_periods: int | None = None, ddof: int = 1
) -> torch.Tensor:
    # centre each row by its global nanmean first: windowed sums of squares
    # on centred values keep float32 exact at BTC-scale prices
    m = torch.isfinite(x)
    row_cnt = m.sum(dim=-1, keepdim=True, dtype=torch.int32)
    row_mean = torch.where(m, x, 0.0).sum(dim=-1, keepdim=True) / torch.clamp(
        row_cnt, min=1
    )
    xc = x - row_mean
    wsum, cnt = _window_sums(xc, window)
    wsq, _ = _window_sums(xc * xc, window)
    mp = max(_resolve_min_periods(window, min_periods), 1)
    safe_cnt = torch.clamp(cnt, min=1.0)
    var = (wsq - wsum * wsum / safe_cnt) / torch.clamp(cnt - ddof, min=1.0)
    var = torch.clamp(var, min=0.0)
    return torch.where((cnt >= mp) & (cnt > ddof), var, NAN)


def rolling_std(
    x: torch.Tensor, window: int, min_periods: int | None = None, ddof: int = 1
) -> torch.Tensor:
    return torch.sqrt(rolling_var(x, window, min_periods, ddof))


def _rolling_extremum(
    x: torch.Tensor, window: int, min_periods: int | None, largest: bool
) -> torch.Tensor:
    mp = max(_resolve_min_periods(window, min_periods), 1)
    neutral = -INF if largest else INF
    xf = torch.where(torch.isfinite(x), x, neutral).to(torch.float32)
    pad = torch.full(
        xf.shape[:-1] + (window - 1,), neutral, dtype=xf.dtype, device=xf.device
    )
    win = torch.cat([pad, xf], dim=-1).unfold(-1, window, 1)  # (..., W, window)
    out = win.amax(dim=-1) if largest else win.amin(dim=-1)
    _, cnt = _window_sums(x, window)
    return torch.where(cnt >= mp, out, NAN)


def rolling_max(
    x: torch.Tensor, window: int, min_periods: int | None = None
) -> torch.Tensor:
    return _rolling_extremum(x, window, min_periods, largest=True)


def rolling_min(
    x: torch.Tensor, window: int, min_periods: int | None = None
) -> torch.Tensor:
    return _rolling_extremum(x, window, min_periods, largest=False)


def _windowed_view(x: torch.Tensor, window: int) -> torch.Tensor:
    """(..., W) -> (..., W, window): the trailing window ending at each
    position, NaN before the array start."""
    pad = torch.full(
        x.shape[:-1] + (window - 1,), NAN, dtype=x.dtype, device=x.device
    )
    return torch.cat([pad, x], dim=-1).unfold(-1, window, 1)


def _quantile_of_windows(
    win: torch.Tensor, window: int, q: float, mp: int
) -> torch.Tensor:
    """Linear-interpolated q-quantile of each (..., window) row of ``win``,
    NaN-aware: non-finite values sort to the end, the finite count drives the
    rank, and fewer than ``mp`` finite values give NaN."""
    finite = torch.isfinite(win)
    cnt = finite.sum(dim=-1, dtype=torch.int32)
    s = torch.sort(torch.where(finite, win, INF), dim=-1).values
    rank = q * (cnt.to(torch.float32) - 1.0)
    lo = torch.clamp(torch.floor(rank).to(torch.int32), 0, window - 1)
    hi = torch.clamp(lo + 1, 0, window - 1)
    hi = torch.minimum(hi, torch.clamp(cnt - 1, min=0))
    frac = rank - lo.to(torch.float32)
    v_lo = torch.gather(s, -1, lo.long()[..., None])[..., 0]
    v_hi = torch.gather(s, -1, hi.long()[..., None])[..., 0]
    out = v_lo + (v_hi - v_lo) * frac
    return torch.where(cnt >= mp, out, NAN)


def rolling_quantile(
    x: torch.Tensor, window: int, q: float, min_periods: int | None = None
) -> torch.Tensor:
    """pandas rolling(...).quantile(q, interpolation='linear'), NaN-aware,
    by sorting explicit trailing windows."""
    mp = max(_resolve_min_periods(window, min_periods), 1)
    return _quantile_of_windows(_windowed_view(x, window), window, q, mp)


def rolling_median(
    x: torch.Tensor, window: int, min_periods: int | None = None
) -> torch.Tensor:
    return rolling_quantile(x, window, 0.5, min_periods)


@lru_cache(maxsize=64)
def _decay_matrix_np(alpha: float, length: int) -> np.ndarray:
    """Lower-triangular A with A[t, s] = alpha * (1-alpha)^(t-s), s <= t."""
    d = 1.0 - alpha
    t = np.arange(length)
    expo = t[:, None] - t[None, :]
    with np.errstate(over="ignore"):
        mat = alpha * np.power(d, np.maximum(expo, 0), dtype=np.float64)
    mat = np.where(expo >= 0, mat, 0.0)
    return mat.astype(np.float32)


_DECAY_CACHE: dict[tuple, torch.Tensor] = {}


def _decay_matrix(alpha: float, length: int, device: torch.device) -> torch.Tensor:
    """The decay matrix, transposed for ``x @ A.T`` and kept on ``device``
    (built once: an upload per call would synchronize with the card)."""
    key = (alpha, length, str(device))
    mat = _DECAY_CACHE.get(key)
    if mat is None:
        mat = torch.from_numpy(_decay_matrix_np(alpha, length).T.copy()).to(device)
        _DECAY_CACHE[key] = mat
    return mat


def _ewm_weights(alpha: float, length: int, device: torch.device) -> torch.Tensor:
    """The last row of the decay matrix (oldest first), kept on ``device``."""
    key = ("w", alpha, length, str(device))
    w = _DECAY_CACHE.get(key)
    if w is None:
        w = torch.from_numpy(
            (alpha * np.power(1.0 - alpha, np.arange(length - 1, -1, -1), dtype=np.float64)
             ).astype(np.float32)
        ).to(device)
        _DECAY_CACHE[key] = w
    return w


def _first_valid(m: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(index of the first True along the last axis — 0 if none, any)."""
    s0 = m.to(torch.int32).argmax(dim=-1)  # first max wins
    return s0, m.any(dim=-1)


def ewm_mean(
    x: torch.Tensor,
    alpha: float | None = None,
    span: float | None = None,
    min_periods: int = 0,
) -> torch.Tensor:
    """pandas ``ewm(alpha|span, adjust=False).mean()`` as one matmul plus the
    closed-form warm start ``(1-alpha)^(t-s0+1) * x[s0]`` at the first valid
    sample ``s0`` (exact for the leading-NaN pattern the ring produces)."""
    if alpha is None:
        if span is None:
            raise ValueError("ewm_mean requires alpha or span")
        alpha = 2.0 / (span + 1.0)
    W = x.shape[-1]
    d = 1.0 - alpha
    m = torch.isfinite(x)
    xf = torch.where(m, x, 0.0).to(torch.float32)
    base = torch.matmul(xf, _decay_matrix(float(alpha), W, x.device))

    s0, any_valid = _first_valid(m)
    x0 = torch.gather(x, -1, s0.long()[..., None])[..., 0]
    t_idx = torch.arange(W, dtype=torch.int32, device=x.device)
    rel = t_idx - s0[..., None]
    corr = torch.pow(
        torch.full((), d, dtype=torch.float32, device=x.device),
        (rel + 1).to(torch.float32),
    ) * x0[..., None]
    y = base + torch.where(rel >= 0, corr, 0.0)
    ok = (rel >= 0) & (rel + 1 >= max(min_periods, 1)) & any_valid[..., None]
    return torch.where(ok, y, NAN)


def fixed_order_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum along the last axis in one fixed pairwise order, built from
    elementwise adds only: zero-padded to a power of two, then halved until
    one column is left. Every add is a correctly rounded float32 add, so
    the card and the CPU return the same bits (a library reduction or
    matrix product sums in an order of its own on each)."""
    n = x.shape[-1]
    width = 1 << max(n - 1, 0).bit_length()
    if width > n:
        pad = torch.zeros(x.shape[:-1] + (width - n,), dtype=x.dtype, device=x.device)
        x = torch.cat([x, pad], dim=-1)
    while width > 1:
        width //= 2
        x = x[..., :width] + x[..., width:]
    return x[..., 0]


def ewm_last_state(
    x: torch.Tensor, alpha: float, fixed_order: bool = False
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(mean, rel, any_valid) of the ``adjust=False`` recursion at the last
    window position; ``rel`` is the last column's offset from the first
    valid sample. ``fixed_order`` sums the weighted window with
    :func:`fixed_order_sum` instead of a matrix-vector product: the
    incremental carry's init, which the card and the CPU then build bit for
    bit alike."""
    W = x.shape[-1]
    d = 1.0 - alpha
    w = _ewm_weights(float(alpha), W, x.device)
    m = torch.isfinite(x)
    xf = torch.where(m, x, 0.0).to(torch.float32)
    base = fixed_order_sum(xf * w) if fixed_order else torch.matmul(xf, w)
    s0, any_valid = _first_valid(m)
    x0 = torch.gather(x, -1, s0.long()[..., None])[..., 0]
    rel = (W - 1) - s0
    corr = torch.pow(
        torch.full((), d, dtype=torch.float32, device=x.device),
        (rel + 1).to(torch.float32),
    ) * x0
    return base + corr, rel, any_valid


def ewm_mean_last(
    x: torch.Tensor,
    alpha: float | None = None,
    span: float | None = None,
    min_periods: int = 0,
) -> torch.Tensor:
    """Last value of :func:`ewm_mean` in O(W) per row."""
    if alpha is None:
        if span is None:
            raise ValueError("ewm_mean_last requires alpha or span")
        alpha = 2.0 / (span + 1.0)
    y, rel, any_valid = ewm_last_state(x, float(alpha))
    ok = any_valid & (rel + 1 >= max(min_periods, 1))
    return torch.where(ok, y, NAN)


def rolling_mean_last(
    x: torch.Tensor, window: int, min_periods: int | None = None
) -> torch.Tensor:
    """Last value of :func:`rolling_mean` from just the trailing slice."""
    tail = x[..., -window:]
    m = torch.isfinite(tail)
    cnt = m.sum(dim=-1, dtype=torch.int32)
    mp = max(_resolve_min_periods(window, min_periods), 1)
    mean = torch.where(m, tail, 0.0).sum(dim=-1) / torch.clamp(cnt, min=1)
    return torch.where(cnt >= mp, mean, NAN)


def rolling_std_last(
    x: torch.Tensor, window: int, min_periods: int | None = None, ddof: int = 1
) -> torch.Tensor:
    """Last value of :func:`rolling_std` from just the trailing slice."""
    tail = x[..., -window:]
    m = torch.isfinite(tail)
    cnt = m.sum(dim=-1, dtype=torch.int32)
    mp = max(_resolve_min_periods(window, min_periods), 1)
    mean = torch.where(m, tail, 0.0).sum(dim=-1) / torch.clamp(cnt, min=1)
    sq = torch.where(m, (tail - mean[..., None]) ** 2, 0.0).sum(dim=-1)
    var = sq / torch.clamp(cnt - ddof, min=1)
    ok = (cnt >= mp) & (cnt > ddof)
    return torch.where(ok, torch.sqrt(torch.clamp(var, min=0.0)), NAN)


def cummax(x: torch.Tensor) -> torch.Tensor:
    """Running max along the last axis; a NaN propagates forward."""
    return torch.cummax(x, dim=-1).values


def cummin(x: torch.Tensor) -> torch.Tensor:
    """Running min along the last axis; a NaN propagates forward."""
    return torch.cummin(x, dim=-1).values
