"""The port's rolling/EWM/indicator primitives against the reference's, on
the inputs ``tests/test_ops_parity.py`` uses (the ``ohlcv`` random-walk
fixture, leading-NaN and BTC-scale variants).

Tolerances: positional and sort-based outputs (shift, diff, extrema,
quantiles, medians, cummax/cummin, true range) must be BIT-EXACT. Outputs
built on cumsums, matmuls or libm calls (rolling sums/means/variances, EWMs,
log returns, beta/corr) are compared with rtol=1e-5 / atol=1e-6 because
their summation order differs: the reference's float32 cumsum and XLA's
blocked dot vs torch's float64-accumulated CPU cumsum and its sgemm. The
cancellation-heavy ones (variance, beta/corr) are held relative to the
magnitude of their inputs, which the test states where it applies.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from binquant_tpu.ops import indicators as jind
from binquant_tpu.ops import rolling as jroll
from binquant_tpu_torch.ops import indicators as tind
from binquant_tpu_torch.ops import rolling as troll

# small shapes: extra intra-op threads only spin and crowd parallel test workers
torch.set_num_threads(1)


# the reference's associative-scan cummax/cummin run jitted: op by op the
# scan dispatches hundreds of tiny computations (max is exact either way)
JROLL = SimpleNamespace(
    **{k: getattr(jroll, k) for k in dir(jroll) if not k.startswith("__")}
)
JROLL.cummax = jax.jit(jroll.cummax)
JROLL.cummin = jax.jit(jroll.cummin)


def f32(x):
    return np.asarray(x, dtype=np.float32)


def both(x):
    x = f32(x)
    return jnp.asarray(x), torch.from_numpy(x.copy())


def check(ref, out, exact: bool, rtol=1e-5, atol=1e-6):
    ref = np.asarray(ref)
    out = out.numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    assert ref.shape == out.shape
    assert out.dtype == ref.dtype, (out.dtype, ref.dtype)
    np.testing.assert_array_equal(np.isnan(ref), np.isnan(out))
    if exact:
        np.testing.assert_array_equal(np.nan_to_num(ref, nan=-1.0), np.nan_to_num(out, nan=-1.0))
    else:
        np.testing.assert_allclose(out, ref, rtol=rtol, atol=atol, equal_nan=True)


def _closes(ohlcv, lead_nan: int = 0):
    c = f32(ohlcv["close"]).copy()
    c[:lead_nan] = np.nan
    return c


POSITIONAL = {
    "shift+3": lambda m, x: m.shift(x, 3),
    "shift-2": lambda m, x: m.shift(x, -2),
    "shift_fill0": lambda m, x: m.shift(x, 5, 0.0),
    "diff": lambda m, x: m.diff(x, 1),
    "rolling_max48": lambda m, x: m.rolling_max(x, 48),
    "rolling_min48": lambda m, x: m.rolling_min(x, 48),
    "rolling_max_mp": lambda m, x: m.rolling_max(x, 20, 5),
    "quantile50": lambda m, x: m.rolling_quantile(x, 48, 0.5),
    "quantile80": lambda m, x: m.rolling_quantile(x, 48, 0.8),
    "quantile92_mp": lambda m, x: m.rolling_quantile(x, 48, 0.92, 20),
    "median_shifted": lambda m, x: m.rolling_median(m.shift(x, 1), 24),
    "cummax": lambda m, x: m.cummax(x),
    "cummin": lambda m, x: m.cummin(x),
}


@pytest.mark.parametrize("name", sorted(POSITIONAL))
@pytest.mark.parametrize("lead_nan", [0, 37])
def test_positional_ops_bit_exact(ohlcv, name, lead_nan):
    x = f32(ohlcv["volume"]).copy()
    x[:lead_nan] = np.nan
    x[200] = np.nan  # an interior hole
    if name.startswith(("cummax", "cummin")):
        x[200] = 5000.0  # NaN propagation is checked separately below
    jx, tx = both(x)
    check(POSITIONAL[name](JROLL, jx), POSITIONAL[name](troll, tx), exact=True)


def test_cummax_cummin_nan_propagates_like_reference():
    x = f32([3.0, 1.0, 4.0, np.nan, 5.0, 2.0, 9.0])
    jx, tx = both(x)
    check(JROLL.cummax(jx), troll.cummax(tx), exact=True)
    check(JROLL.cummin(jx), troll.cummin(tx), exact=True)


def test_extrema_skip_inf_like_nan():
    x = f32(np.arange(60.0))
    x[30] = np.inf
    x[40] = -np.inf
    jx, tx = both(x)
    check(jroll.rolling_max(jx, 8, 1), troll.rolling_max(tx, 8, 1), exact=True)
    check(jroll.rolling_min(jx, 8, 1), troll.rolling_min(tx, 8, 1), exact=True)


CUMSUM = {
    "sum20": lambda m, x: m.rolling_sum(x, 20),
    "mean20": lambda m, x: m.rolling_mean(x, 20),
    "mean14_mp1": lambda m, x: m.rolling_mean(x, 14, 1),
    "mean96_mp48": lambda m, x: m.rolling_mean(x, 96, 48),
    "mean_last20": lambda m, x: m.rolling_mean_last(x, 20),
    "mean_last14_mp1": lambda m, x: m.rolling_mean_last(x, 14, 1),
}


@pytest.mark.parametrize("name", sorted(CUMSUM))
@pytest.mark.parametrize("lead_nan", [0, 37])
def test_cumsum_ops_within_ulps(ohlcv, name, lead_nan):
    jx, tx = both(_closes(ohlcv, lead_nan))
    check(CUMSUM[name](jroll, jx), CUMSUM[name](troll, tx), exact=False)


@pytest.mark.parametrize("ddof", [0, 1])
@pytest.mark.parametrize("scale", [1.0, 680.0])  # ~100 and BTC-scale ~68000
def test_rolling_std_within_ulps(ohlcv, ddof, scale):
    # the variance cancels: its error scales with the row's magnitude, so
    # the absolute tolerance is float32 epsilon-relative to the prices
    x = _closes(ohlcv) * f32(scale)
    jx, tx = both(x)
    atol = float(np.nanmax(np.abs(x))) * 1e-6
    check(jroll.rolling_std(jx, 20, ddof=ddof), troll.rolling_std(tx, 20, ddof=ddof),
          exact=False, atol=atol)
    check(jroll.rolling_std_last(jx, 20, ddof=ddof),
          troll.rolling_std_last(tx, 20, ddof=ddof), exact=False, atol=atol)


@pytest.mark.parametrize(
    "kw",
    [dict(span=7), dict(span=20), dict(span=26, min_periods=1), dict(span=50),
     dict(alpha=1 / 14, min_periods=14)],
)
@pytest.mark.parametrize("lead_nan", [0, 53])
def test_ewm_within_ulps(ohlcv, kw, lead_nan):
    jx, tx = both(_closes(ohlcv, lead_nan))
    check(jroll.ewm_mean(jx, **kw), troll.ewm_mean(tx, **kw), exact=False)
    check(jroll.ewm_mean_last(jx, **kw), troll.ewm_mean_last(tx, **kw), exact=False)


def test_ewm_last_batched_rows(rng):
    x = f32(rng.normal(100, 5, size=(7, 64)))
    x[2, :30] = np.nan
    x[5, :] = np.nan
    jx, tx = both(x)
    check(jroll.ewm_mean_last(jx, span=20, min_periods=1),
          troll.ewm_mean_last(tx, span=20, min_periods=1), exact=False)


def test_true_range_bit_exact(ohlcv):
    (jh, th), (jl, tl), (jc, tc) = (both(ohlcv[k]) for k in ("high", "low", "close"))
    check(jind.true_range(jh, jl, jc), tind.true_range(th, tl, tc), exact=True)


def test_log_returns_within_ulps(ohlcv):
    c = _closes(ohlcv, 10)
    c[100] = 0.0  # non-positive close -> NaN
    jx, tx = both(c)
    check(jind.log_returns(jx), tind.log_returns(tx), exact=False)


def test_rolling_beta_corr_within_tolerance(rng):
    bench = f32(rng.normal(0, 0.01, (1, 300)))
    asset = f32(1.5 * bench + rng.normal(0, 0.005, (4, 300)))
    asset[2, :80] = np.nan
    jb, tb = both(bench)
    ja, ta = both(asset)
    ref = jind.rolling_beta_corr(ja, jb, 50)
    out = tind.rolling_beta_corr(ta, tb, 50)
    # beta/corr divide a cumsum covariance by a cumsum variance of returns
    # ~1e-2: the ratio keeps ~1e-4 relative of float32 cumsum drift
    check(ref.beta, out.beta, exact=False, rtol=1e-4, atol=1e-4)
    check(ref.corr, out.corr, exact=False, rtol=1e-4, atol=1e-4)
