"""The port's batched indicator library against the reference's
(``binquant_tpu/ops/indicators.py``): every function on the same seeded
(S=8, W=120) float32 OHLCV rows, each row with a warm-up of leading NaN of
its own length (0 to 35 bars).

NaN positions must be equal; values within ``rtol=1e-5, atol=1e-6`` (the
rolling sums, variances and EWMs are summed in another order on each side);
the supertrend's direction exactly. Two functions divide the difference of
two float32 averages of prices by something smaller than a price, and are
held at the scale of their inputs instead: ``ma_spreads`` (a moving
average's float32 error, rtol of the price, over an average: ``atol =
rtol``) and ``zscore`` (over the rolling std: ``atol = rtol * |close| /
std``). Both packages sit that far from a float64 computation, each on its
own side.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from binquant_tpu.ops import indicators as jind
from binquant_tpu_torch.ops import indicators as tind

torch.set_num_threads(1)

S, W = 8, 120
RTOL, ATOL = 1e-5, 1e-6


def _ohlcv(seed: int = 14) -> dict:
    rng = np.random.default_rng(seed)
    close = (20 + rng.random((S, 1)) * 100) * np.exp(
        np.cumsum(rng.normal(0.0, 0.01, (S, W)), axis=1)
    )
    open_ = np.concatenate([close[:, :1], close[:, :-1]], axis=1)
    high = np.maximum(open_, close) * (1 + rng.random((S, W)) * 0.004)
    low = np.minimum(open_, close) * (1 - rng.random((S, W)) * 0.004)
    volume = np.abs(rng.normal(1000, 300, (S, W)))
    close[2, 40:46] = close[2, 39]  # a flat run: zero moves, zero-width bars
    high[2, 40:46] = low[2, 40:46] = open_[2, 40:46] = close[2, 39]
    out = dict(open=open_, high=high, low=low, close=close, volume=volume)
    for r, warm in enumerate((0, 3, 7, 11, 19, 25, 30, 35)):
        for v in out.values():
            v[r, :warm] = np.nan
    return {k: v.astype(np.float32) for k, v in out.items()}


@pytest.fixture(scope="module")
def bars():
    m = _ohlcv()
    return (
        {k: jnp.asarray(v) for k, v in m.items()},
        {k: torch.from_numpy(v.copy()) for k, v in m.items()},
    )


def _close(j, t, exact: bool = False, atol=ATOL) -> None:
    j = np.asarray(j)
    t = t.numpy()
    assert j.shape == t.shape and j.dtype == t.dtype, (j.shape, t.shape, j.dtype, t.dtype)
    np.testing.assert_array_equal(np.isnan(j), np.isnan(t))
    if exact:
        np.testing.assert_array_equal(np.nan_to_num(j, nan=-7.0), np.nan_to_num(t, nan=-7.0))
    else:
        fin = np.isfinite(j)
        err = np.abs(t.astype(np.float64) - j)
        bound = np.broadcast_to(atol, j.shape) + RTOL * np.abs(j.astype(np.float64))
        bad = np.flatnonzero(fin & (err > bound))
        assert not bad.size, (bad[:5], t.flat[bad[:5]], j.flat[bad[:5]])
        np.testing.assert_array_equal(t[~fin], j[~fin])


def _input_scale(name: str, m: dict) -> float | np.ndarray:
    """The absolute tolerance of a case (the module docstring's scales)."""
    if name == "ma_spreads":
        return RTOL
    if name == "zscore":
        close = m["close"].astype(np.float64)
        win = np.lib.stride_tricks.sliding_window_view(close, 20, axis=1)
        std = np.concatenate([np.full((S, 19), np.nan), win.std(axis=-1)], axis=1)
        with np.errstate(invalid="ignore", divide="ignore"):
            return np.nan_to_num(RTOL * np.abs(close) / std, nan=ATOL, posinf=ATOL)
    return ATOL


CASES = {
    "sma": lambda m, lib: lib.sma(m["close"], 20),
    "sma_min_periods": lambda m, lib: lib.sma(m["close"], 25, min_periods=1),
    "ema": lambda m, lib: lib.ema(m["close"], 20),
    "typical_price": lambda m, lib: lib.typical_price(m["high"], m["low"], m["close"]),
    "true_range": lambda m, lib: lib.true_range(m["high"], m["low"], m["close"]),
    "atr": lambda m, lib: lib.atr(m["high"], m["low"], m["close"], 14),
    "atr_wilder": lambda m, lib: lib.atr_wilder(m["high"], m["low"], m["close"], 14),
    "rsi_wilder": lambda m, lib: lib.rsi_wilder(m["close"], 14),
    "rsi_sma": lambda m, lib: lib.rsi_sma(m["close"], 14),
    "macd": lambda m, lib: lib.macd(m["close"]),
    "mfi": lambda m, lib: lib.mfi(m["high"], m["low"], m["close"], m["volume"], 14),
    "bollinger": lambda m, lib: lib.bollinger(m["close"], 20),
    "bollinger_ddof1": lambda m, lib: lib.bollinger(m["close"], 20, 2.5, min_periods=5, ddof=1),
    "twap": lambda m, lib: lib.twap(m["open"], m["high"], m["low"], m["close"], 20),
    "adx": lambda m, lib: lib.adx(m["high"], m["low"], m["close"], 14),
    "connors_rsi": lambda m, lib: lib.connors_rsi(m["close"], 3, 2, 50),
    "zscore": lambda m, lib: lib.zscore(m["close"], 20),
    "log_returns": lambda m, lib: lib.log_returns(m["close"]),
    "ma_spreads": lambda m, lib: lib.ma_spreads(m["close"]),
    "bb_spreads": lambda m, lib: lib.bb_spreads(lib.bollinger(m["close"], 20)),
    "rolling_beta_corr": lambda m, lib: lib.rolling_beta_corr(
        lib.log_returns(m["close"]), lib.log_returns(m["close"][:1]), 50
    ),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_indicator_matches_reference(bars, name):
    jm, tm = bars
    j, t = CASES[name](jm, jind), CASES[name](tm, tind)
    atol = _input_scale(name, {k: v.numpy() for k, v in tm.items()})
    if isinstance(j, tuple):
        assert type(t).__name__ == type(j).__name__ and t._fields == j._fields
        for a, b in zip(j, t, strict=True):
            _close(a, b, atol=atol)
    else:
        _close(j, t, atol=atol)
    # the warm-up is NaN on both sides, so the NaN check above is not vacuous
    assert np.isnan(np.asarray(j[0] if isinstance(j, tuple) else j)).any()


def test_supertrend_matches_reference(bars):
    jm, tm = bars
    j = jind.supertrend(jm["high"], jm["low"], jm["close"], 10, 3.0)
    t = tind.supertrend(tm["high"], tm["low"], tm["close"], 10, 3.0)
    assert t._fields == j._fields == ("supertrend", "direction")
    _close(j.direction, t.direction, exact=True)
    _close(j.supertrend, t.supertrend)
    d = t.direction.numpy()
    assert {1.0, -1.0} <= set(np.unique(d[np.isfinite(d)]).tolist())  # both trends occur
