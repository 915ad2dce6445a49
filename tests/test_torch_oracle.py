"""The port's per-symbol oracle (``binquant_tpu_torch/oracle``) against the
reference's pandas oracle (``binquant_tpu/oracle``), on the CPU.

* Both replay the four A/B fixtures of ``tests/test_ab_parity.py``: the
  seed-7 replay without and with the washed-out breadth, the dormant market
  with ``DORMANT_ORACLE_STRATEGIES`` and the extended dormant market with
  ``DORMANT_ORACLE_EXTENDED``, its rising breadth and both dominance flags.
  The fired tuples must be exactly equal (and fire on the reference's
  side), the per-tick regime labels equal, their strengths within
  ``rtol=1e-9``; the market context and every symbol's features at the last
  tick of the breadth run within ``rtol=1e-9, atol=1e-12``, integer and
  boolean fields exact. Each reference run is made once for the module
  (~20-35 s each).
* Each helper of ``oracle/frame.py`` against pandas on seeded columns with
  leading NaN, a gap and a constant run: positional helpers, the NaN-skipping
  row max, medians, quantiles, extrema and both EWM forms exact; sums and
  means within ``rtol=1e-12``, and exactly pandas' on a window of equal
  values (pandas returns the value, and the value times the count, there);
  variances within ``rtol=1e-8`` (pandas keeps a running Welford sum whose
  error on short windows after a constant run reaches a few 1e-9; the
  oracle sums each window afresh). On a window of equal values the
  oracle's variance is exactly 0, as pandas 2 returned it; pandas 3's
  running sum leaves a residual there, checked to be under 1e-12 of the
  square of the values.
* ``FrameStore`` against the reference's on one symbol's stream with a
  same-timestamp correction and late bars.
"""

import math

import numpy as np
import pandas as pd
import pytest

from binquant_tpu.io import replay as jreplay
from binquant_tpu.oracle import evaluator as jev
from binquant_tpu_torch.io import replay as treplay
from binquant_tpu_torch.oracle import evaluator as tev
from binquant_tpu_torch.oracle import frame as F

WINDOW = 200
WASHED_BREADTH = {
    "timestamp": [1, 2, 3],
    "market_breadth": [-0.50, -0.47, -0.44],
    "market_breadth_ma": [-0.50, -0.46],
}
RISING_BREADTH = {
    "timestamp": [1, 2, 3, 4],
    "market_breadth": [0.30, 0.34, 0.38, 0.42],
    "market_breadth_ma": [0.30, 0.36],
}
FIXTURES = {
    "seed7": ("seed7", {}),
    "seed7_washed": ("seed7", {"breadth": WASHED_BREADTH}),
    "dormant": ("dormant", {"enabled_strategies": set(jev.DORMANT_ORACLE_STRATEGIES)}),
    "dormant_extended": ("extended", {
        "enabled_strategies": set(jev.DORMANT_ORACLE_EXTENDED),
        "breadth": RISING_BREADTH,
        "dominance_is_losers": True,
        "market_domination_reversal": True,
    }),
}
CONTEXT_CASE = "seed7_washed"


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("oracle")
    paths = {name: d / f"{name}.jsonl" for name in ("seed7", "dormant", "extended")}
    jreplay.generate_replay_file(paths["seed7"], n_symbols=24, n_ticks=120, seed=7)
    jreplay.generate_dormant_replay(paths["dormant"])
    jreplay.generate_dormant_extended_replay(paths["extended"])
    return paths


def _recording(cls, into: dict):
    """A subclass of ``cls`` that keeps every context it builds, by tick."""

    class Recording(cls):
        def _build_context(self, ts15):
            ctx = super()._build_context(ts15)
            into[ts15] = ctx
            return ctx

    return Recording


@pytest.fixture(scope="module")
def runs(files):
    """Each fixture through both oracles once: (fired, regimes, contexts by
    tick) for the reference and for the port; contexts are kept on the
    context case only."""
    import binquant_tpu.oracle as joracle

    # where each replay looks its evaluator up
    homes = ((jreplay, jev, joracle), (treplay, tev, treplay))
    out = {}
    for name, (file, kw) in FIXTURES.items():
        pair = []
        for mod, ev, home in homes:
            regimes, contexts = [], {}
            with pytest.MonkeyPatch.context() as mp:
                if name == CONTEXT_CASE:
                    mp.setattr(home, "OracleEvaluator", _recording(ev.OracleEvaluator, contexts))
                fired = mod.run_replay_oracle(
                    files[file], window=WINDOW, collect_regimes=regimes, **kw
                )
            pair.append((fired, regimes, contexts))
        out[name] = pair
    return out


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_fired_tuples_equal_reference(runs, name):
    (jfired, _, _), (tfired, _, _) = runs[name]
    assert jfired, f"{name}: the reference fired nothing; the comparison would be vacuous"
    assert tfired == jfired


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_regime_labels_equal_reference(runs, name):
    (_, jreg, _), (_, treg, _) = runs[name]
    assert len(treg) == len(jreg) > 0
    assert [r[:2] for r in treg] == [r[:2] for r in jreg]
    np.testing.assert_allclose([r[2] for r in treg], [r[2] for r in jreg], rtol=1e-9, atol=0)
    assert any(r[1] is not None for r in jreg)


def _fields_close(a, b, label: str) -> None:
    for name in a.__dataclass_fields__:
        if name == "features":
            continue
        x, y = getattr(a, name), getattr(b, name)
        if isinstance(x, float):
            assert math.isclose(y, x, rel_tol=1e-9, abs_tol=1e-12), (label, name, x, y)
        else:
            assert type(y) is type(x) and y == x, (label, name, x, y)


def test_context_and_features_equal_reference(runs):
    (_, _, jctx), (_, _, tctx) = runs[CONTEXT_CASE]
    assert sorted(tctx) == sorted(jctx)
    ts = max(t for t, c in jctx.items() if c.valid)
    j, t = jctx[ts], tctx[ts]
    _fields_close(j, t, "context")
    assert list(t.features) == list(j.features) and len(j.features) == 24
    for sym in j.features:
        _fields_close(j.features[sym], t.features[sym], sym)
    assert {f.micro_regime for f in j.features.values()} - {-1}  # classified, not vacuous


# ---------------------------------------------------------------------------
# oracle/frame.py against pandas
# ---------------------------------------------------------------------------


def _column(seed: int, n: int = 300) -> np.ndarray:
    rng = np.random.default_rng(seed)
    x = 50 * np.exp(np.cumsum(rng.normal(0.0, 0.01, n)))
    x[:9] = np.nan  # a leading warm-up
    x[120] = np.nan  # a gap
    x[150:190] = x[150]  # a constant run (equal values, not exactly representable sums)
    x[230:236] = 0.3
    return x


def _same(a, b, rtol: float = 0.0) -> None:
    a, b = np.asarray(a, float), np.asarray(b, float)
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    if rtol:
        np.testing.assert_allclose(a, b, rtol=rtol, atol=0, equal_nan=True)
    else:
        np.testing.assert_array_equal(np.nan_to_num(a, nan=-1.0), np.nan_to_num(b, nan=-1.0))


ROLLING = [(20, None), (20, 1), (14, 14), (3, 1), (2, 2), (80, 20), (6, None)]


@pytest.mark.parametrize("window,min_periods", ROLLING)
@pytest.mark.parametrize("seed", [3, 4])
def test_rolling_matches_pandas(seed, window, min_periods):
    x = _column(seed)
    ours, theirs = F.rolling(x, window, min_periods), pd.Series(x).rolling(
        window, min_periods=min_periods
    )
    _same(ours.sum(), theirs.sum(), rtol=1e-12)
    _same(ours.mean(), theirs.mean(), rtol=1e-12)
    # the windows whose valid values are all equal (the constant runs)
    win = np.lib.stride_tricks.sliding_window_view(
        np.concatenate([np.full(window - 1, np.nan), x]), window
    )
    valid = ~np.isnan(win)
    same = (
        np.max(np.where(valid, win, -np.inf), axis=1) == np.min(np.where(valid, win, np.inf), axis=1)
    ) & np.isfinite(ours.mean())
    assert same.sum() >= (1 if window <= 40 else 0)
    for ddof in (0, 1):
        var, ref = ours.var(ddof), theirs.var(ddof=ddof).to_numpy()
        _same(np.where(same, 0.0, var), np.where(same, 0.0, ref), rtol=1e-8)
        _same(np.where(same, 0.0, ours.std(ddof)),
              np.where(same, 0.0, theirs.std(ddof=ddof).to_numpy()), rtol=1e-8)
        # a constant window: exactly 0 here; pandas leaves its running sum's
        # residual, far under the square of the values
        assert (var[same & np.isfinite(var)] == 0.0).all()
        assert (np.abs(ref[same & np.isfinite(ref)]) <= 1e-12 * x[same & np.isfinite(ref)] ** 2).all()
    _same(ours.median(), theirs.median())
    for q in (0.92, 0.5, 0.2, 0.0, 1.0):
        _same(ours.quantile(q), theirs.quantile(q))
    _same(ours.max(), theirs.max())
    _same(ours.min(), theirs.min())
    # over a constant run pandas returns the value itself (mean) and the
    # value times the count (sum), not their running sums: taken alike
    np.testing.assert_array_equal(ours.mean()[same], theirs.mean().to_numpy()[same])
    np.testing.assert_array_equal(ours.sum()[same], theirs.sum().to_numpy()[same])


def test_rolling_single_observation_ddof():
    x = np.array([np.nan, np.nan, 5.0, np.nan])
    s = pd.Series(x).rolling(3, min_periods=1)
    _same(F.rolling(x, 3, 1).std(0), s.std(ddof=0))  # one value: 0
    _same(F.rolling(x, 3, 1).std(1), s.std(ddof=1))  # one value: NaN
    assert F.rolling(x, 3, 1).std(0)[2] == 0.0 and np.isnan(F.rolling(x, 3, 1).std(1)[2])


@pytest.mark.parametrize("kw", [
    {"span": 20, "min_periods": 1}, {"span": 50, "min_periods": 1}, {"span": 9},
    {"alpha": 1 / 14, "min_periods": 14}, {"alpha": 1.0 / 10, "min_periods": 10},
])
def test_ewm_matches_pandas_bit_for_bit(kw):
    x = _column(5)
    _same(F.ewm_mean(x, **kw), pd.Series(x).ewm(adjust=False, **kw).mean())


def test_positional_helpers_match_pandas():
    x = _column(6)
    s = pd.Series(x)
    for n in (1, 2, 3, -2):
        _same(F.shift(x, n), s.shift(n))
    _same(F.diff(x), s.diff())
    _same(F.clip(x - 50, lower=0), (s - 50).clip(lower=0))
    _same(F.clip(x, lower=45, upper=55), s.clip(lower=45, upper=55))
    cond = x > 50
    _same(F.where(x, cond, -1.0), s.where(cond, -1.0))


def test_row_max_skips_nan_as_pandas_does():
    x = _column(7)
    high, low = x * 1.01, x * 0.99
    pc = F.shift(x, 1)
    cols = [high - low, np.abs(high - pc), np.abs(low - pc)]
    ours = F.row_max(*cols)
    theirs = pd.concat([pd.Series(c) for c in cols], axis=1).max(axis=1)
    _same(ours, theirs)
    assert ours[9] == (high - low)[9]  # the first bar's true range: high - low
    assert np.isnan(ours[0])  # every column NaN


def _kline(t: int, close: float, interval_s: int = 900) -> dict:
    return {
        "symbol": "AAAUSDT", "open_time": t * 1000, "close_time": (t + interval_s) * 1000 - 1,
        "open": close * 0.99, "high": close * 1.01, "low": close * 0.98, "close": close,
        "volume": 100.0 + t % 7, "quote_asset_volume": close * 100.0, "number_of_trades": 10.0,
    }


def test_frame_store_matches_reference():
    stream = [_kline(900 * i, 10.0 + i) for i in range(12)]
    stream.append(_kline(900 * 11, 99.0))  # a correction of the newest bar
    stream.append(_kline(900 * 5, 77.0))  # a correction in the middle
    stream += [_kline(900 * i, 20.0 + i) for i in range(12, 14)]
    stream.append(_kline(900 * 2 + 450, 55.0))  # a late bar between two stored bars
    stream.append(_kline(-900, 1.0))  # a late bar older than every stored one
    ours, theirs = tev.FrameStore(8), jev.FrameStore(8)
    for k in stream:
        ours.update(k)
        theirs.update(k)
        a, b = ours.frames["AAAUSDT"], theirs.frames["AAAUSDT"]
        assert len(a) == len(b)
        np.testing.assert_array_equal(a.open_time, b["open_time"].to_numpy())
        for field in tev.FIELDS:
            np.testing.assert_array_equal(getattr(a, field), b[field].to_numpy())
    assert 55.0 in ours.frames["AAAUSDT"].close or len(ours.frames["AAAUSDT"]) == 8
    assert ours.fresh(900 * 13) == theirs.fresh(900 * 13) == ["AAAUSDT"]
