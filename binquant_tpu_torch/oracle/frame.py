"""The pandas semantics the per-symbol oracle reads, on one symbol's float64
column (a 1-D numpy array), with NaN as pandas' missing value.

The reference's oracle (``binquant_tpu/oracle/evaluator.py``) evaluates each
symbol on pandas ``DataFrame`` columns; the port's host has no pandas, so
these helpers give the same results on numpy arrays:

* :func:`shift`, :func:`diff`, :func:`clip`, :func:`where` — positional, exact;
* :func:`row_max` — ``pd.concat([...], axis=1).max(axis=1)``: NaN-skipping
  (a row of NaN only is NaN), so a true range's first row is ``high - low``;
* :class:`Rolling` (``rolling(x, window, min_periods)``) — ``sum``, ``mean``,
  ``var``/``std`` (``ddof``), ``median``, ``quantile`` (linear, as pandas
  interpolates), ``max``, ``min`` over the trailing window, NaN skipped,
  ``min_periods`` counted over the valid values (default: the window).
  Order statistics are exact. Sums are summed per window, where pandas
  keeps a compensated running sum: they agree to the last few bits, and
  exactly where pandas takes its shortcut — a window whose valid values
  are all equal gives that value (mean) and ``nobs`` times it (sum). Such a
  window's variance is exactly 0, as pandas 2 returned it (pandas 3 keeps a
  running Welford sum there and returns its residual, ~1e-13 of the square
  of the values), so a flat window never passes a ``std > 0`` gate; so is a
  window of one valid value at ``ddof=0`` (``ddof=1`` gives NaN there);
* :func:`ewm_mean` — ``ewm(span=|alpha=, adjust=False, min_periods=)
  .mean()`` by pandas' own recursion (its ``alpha`` from the centre of
  mass, the renormalising divide, the constant-series skip): bit for bit.
  ``min_periods`` only masks the values before the k-th valid one; it does
  not restart the recursion.

This module reads no other module of the package: the oracle must share
nothing with the batched path it checks.
"""

from __future__ import annotations

import numpy as np

NAN = float("nan")


def _f64(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float64)


def shift(x, n: int = 1) -> np.ndarray:
    """``Series.shift(n)``: ``n`` NaN in front (behind for negative ``n``)."""
    x = _f64(x)
    out = np.full_like(x, NAN)
    if n == 0:
        out[:] = x
    elif n > 0:
        out[n:] = x[:-n]
    else:
        out[:n] = x[-n:]
    return out


def diff(x, n: int = 1) -> np.ndarray:
    x = _f64(x)
    return x - shift(x, n)


def clip(x, lower: float | None = None, upper: float | None = None) -> np.ndarray:
    """``Series.clip``: NaN stays NaN."""
    out = _f64(x).copy()
    if lower is not None:
        out = np.where(out < lower, lower, out)
    if upper is not None:
        out = np.where(out > upper, upper, out)
    return out


def where(x, cond, other) -> np.ndarray:
    """``Series.where(cond, other)``: ``x`` where ``cond`` holds, else ``other``."""
    return np.where(np.asarray(cond, dtype=bool), _f64(x), other)


def row_max(*cols) -> np.ndarray:
    """Row-wise max over columns, NaN skipped; NaN where every column is."""
    stack = np.stack([_f64(c) for c in cols], axis=1)
    valid = ~np.isnan(stack)
    out = np.max(np.where(valid, stack, -np.inf), axis=1)
    return np.where(valid.any(axis=1), out, NAN)


class Rolling:
    """``Series.rolling(window, min_periods)`` over a 1-D float64 array."""

    def __init__(self, x, window: int, min_periods: int | None = None) -> None:
        x = _f64(x)
        self.n = len(x)
        self.window = int(window)
        self.min_periods = self.window if min_periods is None else int(min_periods)
        padded = np.empty(self.n + self.window - 1)
        padded[: self.window - 1] = NAN
        padded[self.window - 1:] = x
        # (n, window): row i is the window ending at x[i], NaN before x[0]
        self.win = np.ndarray((self.n, self.window), np.float64, padded, 0, (8, 8))
        self.valid = ~np.isnan(self.win)
        self.nobs = self.valid.sum(axis=1)

    def _ready(self) -> np.ndarray:
        return (self.nobs >= self.min_periods) & (self.nobs > 0)

    def _masked(self, fill: float) -> np.ndarray:
        """The windows with ``fill`` in place of NaN."""
        return np.where(self.valid, self.win, fill)

    def _constant(self) -> tuple[np.ndarray, np.ndarray]:
        """(whether a window's valid values are all equal, that value):
        pandas' shortcut for a run of equal values."""
        lo = np.min(self._masked(np.inf), axis=1)
        hi = np.max(self._masked(-np.inf), axis=1)
        return (lo == hi) & (self.nobs > 0), lo

    def _sums(self) -> np.ndarray:
        return np.sum(self._masked(0.0), axis=1)

    def sum(self) -> np.ndarray:
        same, value = self._constant()
        with np.errstate(invalid="ignore"):
            out = np.where(same, value * self.nobs, self._sums())
        ok = self.nobs >= self.min_periods
        return np.where(ok, np.where(self.nobs == 0, 0.0, out), NAN)

    def mean(self) -> np.ndarray:
        same, value = self._constant()
        with np.errstate(invalid="ignore", divide="ignore"):
            out = np.where(same, value, self._sums() / self.nobs)
        return np.where(self._ready(), out, NAN)

    def var(self, ddof: int = 1) -> np.ndarray:
        same, _ = self._constant()
        with np.errstate(invalid="ignore", divide="ignore"):
            mu = self._sums() / self.nobs
            dev = np.where(self.valid, self.win - mu[:, None], 0.0)
            out = np.sum(dev * dev, axis=1) / (self.nobs - ddof)
        out = np.where(same | (self.nobs == 1), 0.0, out)
        return np.where(self._ready() & (self.nobs > ddof), out, NAN)

    def std(self, ddof: int = 1) -> np.ndarray:
        return np.sqrt(self.var(ddof))

    def _sorted(self) -> np.ndarray:
        return np.sort(self._masked(np.inf), axis=1)

    def median(self) -> np.ndarray:
        s = self._sorted()
        rows = np.arange(self.n)
        mid = self.nobs // 2
        odd = s[rows, np.minimum(mid, self.window - 1)]
        even = (s[rows, np.minimum(mid, self.window - 1)] + s[rows, np.maximum(mid - 1, 0)]) / 2
        return np.where(self._ready(), np.where(self.nobs % 2 == 1, odd, even), NAN)

    def quantile(self, q: float) -> np.ndarray:
        """Linear interpolation between the valid values' order statistics
        at rank ``q * (nobs - 1)``, pandas' formula ``lo + (hi - lo) * frac``."""
        s = self._sorted()
        rows = np.arange(self.n)
        rank = q * (self.nobs - 1).astype(np.float64)
        idx = np.clip(np.floor(rank).astype(np.int64), 0, self.window - 1)
        lo = s[rows, idx]
        hi = s[rows, np.minimum(idx + 1, self.window - 1)]
        exact = (rank == idx) | (self.nobs == 1)
        with np.errstate(invalid="ignore"):
            out = np.where(exact, lo, lo + (hi - lo) * (rank - idx))
        return np.where(self._ready(), out, NAN)

    def max(self) -> np.ndarray:
        return np.where(self._ready(), np.max(self._masked(-np.inf), axis=1), NAN)

    def min(self) -> np.ndarray:
        return np.where(self._ready(), np.min(self._masked(np.inf), axis=1), NAN)


def rolling(x, window: int, min_periods: int | None = None) -> Rolling:
    return Rolling(x, window, min_periods)


def ewm_mean(
    x, span: float | None = None, alpha: float | None = None, min_periods: int = 0
) -> np.ndarray:
    """``Series.ewm(span=|alpha=, adjust=False, min_periods=).mean()``, NaN
    not ignored (a gap decays the old weight), by pandas' recursion."""
    if (span is None) == (alpha is None):
        raise ValueError("ewm_mean takes exactly one of span and alpha")
    com = (float(span) - 1) / 2.0 if span is not None else 1.0 / float(alpha) - 1
    a = 1.0 / (1.0 + com)
    old_factor = 1.0 - a
    vals = _f64(x).tolist()
    out = [NAN] * len(vals)
    if not vals:
        return np.asarray(out)
    minp = max(int(min_periods), 1)
    weighted = vals[0]
    nobs = int(weighted == weighted)
    out[0] = weighted if nobs >= minp else NAN
    old_wt = 1.0
    for i in range(1, len(vals)):
        cur = vals[i]
        obs = cur == cur
        nobs += obs
        if weighted == weighted:
            old_wt *= old_factor
            if obs:
                if weighted != cur:  # pandas skips the update on a constant run
                    weighted = (old_wt * weighted + a * cur) / (old_wt + a)
                old_wt = 1.0
        elif obs:
            weighted = cur
        out[i] = weighted if nobs >= minp else NAN
    return np.asarray(out)
