"""The spike detector and SpikeHunter: the port against the reference.

Both packages run ``detect_spikes`` on one seeded 15m ring (S=24, W=200)
whose rows hold what the live stream can hold: a zero close mid-window
(the next bar's price change is +inf), a zero close on the last bar and on
the bar before it (a -100% and a +inf last change), a NaN gap, rows of 15,
19 and 40 bars (under and over the 20-bar ``min_periods`` of the 60-bar
price-break quantile), an empty row, and crafted spikes (volume bursts,
3% green bars, three-bar green and red streaks). The dynamic price break
goes through the port's ``rolling_quantile_tail`` (its CPU twin here).

Contract: every flag, label and streak bit-exact; the last close, volume
and quote volume and the price-break threshold (built from order
statistics and elementwise math only) bit-exact; the calibrated volume
threshold, a quantile of a ratio over a cumsum moving average, at
``rtol=1e-5``. ``spike_hunter`` is held to the reference on the
reference's own detector output and market context for four breadth
readings (up, down, flat, unavailable): masks, directions and route codes
bit-exact, with the reference's int32 dtypes.
"""

from importlib import import_module

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from binquant_tpu.engine import buffer as jbuf
from binquant_tpu.regime import context as jctx
from binquant_tpu_torch.engine import buffer as tbuf
from binquant_tpu_torch.ops import quantile_tail as qt
from binquant_tpu_torch.regime import context as tctx
from binquant_tpu_torch.strategies import spike_hunter as tsh

# small shapes: extra intra-op threads only spin and crowd parallel test workers
torch.set_num_threads(1)

# the reference's strategies package re-exports a function named like the
# module, so the module is fetched by its full name
jsh = import_module("binquant_tpu.strategies.spike_hunter")

S, W = 24, 200
T0 = 1_780_272_000


def _ring15(rng):
    rets = rng.normal(0, 0.006, (S, W))
    close = 30 * np.exp(np.cumsum(rets, axis=1))
    open_ = np.concatenate([close[:, :1], close[:, :-1]], axis=1)
    vol = np.abs(rng.normal(1000, 200, (S, W)))
    # crafted spikes on the last bars
    for r in (1, 12, 13):  # three green bars, the last +3.5% on 6x volume
        for j in (-3, -2, -1):
            open_[r, j] = close[r, j - 1]
            close[r, j] = open_[r, j] * (1.035 if j == -1 else 1.004)
        vol[r, -1] *= 6.0
        vol[r, -4] *= 3.0  # a second volume-cluster crossing
    for r in (14, 15):  # three red bars, the last -4% on 5x volume
        for j in (-3, -2, -1):
            open_[r, j] = close[r, j - 1]
            close[r, j] = open_[r, j] * (0.96 if j == -1 else 0.995)
        vol[r, -1] *= 5.0
    open_[16, -1] = close[16, -2]  # acceleration: the volume ratio climbs
    close[16, -1] = open_[16, -1] * 1.02
    vol[16, -4:] *= np.array([0.6, 1.5, 2.5, 4.0])
    close[2, 120] = 0.0  # a zero close mid-window: the next change is +inf
    close[3, -1] = 0.0  # the last bar at zero: -100%
    close[4, -2] = 0.0  # the bar before the last at zero: +inf last change
    high = np.maximum(open_, close) * 1.002
    low = np.minimum(open_, close) * 0.998
    vals = np.stack(
        [open_, high, low, close, vol, vol * close, np.full_like(close, 300.0),
         vol / 2, vol * close / 2, np.full_like(close, 900.0)], axis=-1,
    ).astype(np.float32)
    vals[11, 100:110] = np.nan  # a gap
    times = np.broadcast_to(
        (T0 - 900 * np.arange(W - 1, -1, -1)).astype(np.int32), (S, W)
    ).copy()
    filled = np.full(S, W, np.int32)
    filled[[7, 8, 9, 10]] = [0, 15, 19, 40]
    for r in (7, 8, 9, 10):
        times[r, : W - filled[r]] = -1
        vals[r, : W - filled[r]] = np.nan
    return times, vals, filled


@pytest.fixture(scope="module")
def world():
    times, vals, filled = _ring15(np.random.default_rng(53))
    zeros = np.zeros(S, np.int32)
    jb = jbuf.MarketBuffer(jnp.asarray(times), jnp.asarray(vals), jnp.asarray(filled),
                           jnp.asarray(zeros))
    tb = tbuf.MarketBuffer(*(torch.from_numpy(a) for a in (times, vals, filled, zeros)))
    fresh = np.ones(S, bool)
    jcontext, _ = jctx.compute_market_context(
        jb, jnp.asarray(fresh), jnp.asarray(fresh), jnp.int32(0), jnp.int32(T0),
        jctx.initial_regime_carry(S),
        jctx.ContextConfig(required_fresh_symbols=4, min_coverage_ratio=0.5),
    )
    feats = tctx.SymbolFeatureArrays(
        **{f: torch.from_numpy(np.array(getattr(jcontext.features, f)))
           for f in jcontext.features._fields}
    )
    tcontext = tctx.MarketContext(
        **{f: feats if f == "features" else torch.from_numpy(np.array(getattr(jcontext, f)))
           for f in jcontext._fields}
    )
    jspikes = jax.jit(jsh.detect_spikes)(jb)
    qt.reset_launches()
    tspikes = tsh.detect_spikes(tb)
    return dict(jb=jb, tb=tb, jctx=jcontext, tctx=tcontext, jspikes=jspikes,
                tspikes=tspikes, launches=(qt.launches, dict(qt.launches_by_site)))


ROUGH = {"volume_ratio_threshold"}  # a quantile of a ratio over a cumsum mean


@pytest.mark.parametrize("field", jsh.SpikeSignal._fields)
def test_detect_spikes_matches_reference(world, field):
    ref = np.asarray(getattr(world["jspikes"], field))
    out = getattr(world["tspikes"], field).numpy()
    assert ref.dtype == out.dtype and ref.shape == out.shape == (S,), field
    if field in ROUGH:
        np.testing.assert_array_equal(np.isnan(ref), np.isnan(out))
        np.testing.assert_allclose(out, ref, rtol=1e-5, equal_nan=True)
    else:
        np.testing.assert_array_equal(out, ref, err_msg=field)


def test_the_crafted_rows_exercise_the_detector(world):
    sp = world["tspikes"]
    assert sp.label[[1, 12, 13]].all() and sp.upward[[1, 12, 13]].all()
    assert sp.label_short[[14, 15]].all() and sp.downward[[14, 15]].all()
    assert sp.price_break_flag.any() and sp.volume_cluster_flag.any()
    assert sp.accel_spike_flag.any() or sp.accel_spike_short_flag.any()
    # the rows under 20 bars have no dynamic threshold: their floor stands
    assert torch.isfinite(sp.price_break_threshold).all()
    assert not sp.label[7] and not sp.label_short[7]  # the empty row


def test_cpu_tensors_run_the_twin(world):
    # a CPU tensor never counts as a kernel launch, at any call site
    assert world["launches"] == (0, {})


def test_nanquantile_last_matches_reference():
    rng = np.random.default_rng(5)
    x = rng.normal(0, 1, (12, 40)).astype(np.float32)
    x[0] = np.nan  # no finite value
    x[1, ::2] = np.inf  # half non-finite
    x[2, :] = 0.0
    x[2, ::3] = -0.0  # signed zeros tie
    x[3, :] = np.round(x[3, :])  # many ties
    x[4, :39] = np.nan  # one finite value
    for q in (0.0, 0.2, 0.75, 0.97, 1.0):
        ref = np.asarray(jax.jit(jsh._nanquantile_last, static_argnums=1)(jnp.asarray(x), q))
        out = tsh._nanquantile_last(torch.from_numpy(x), q).numpy()
        np.testing.assert_array_equal(out, ref, err_msg=str(q))


BREADTH = {"up": 2.5, "down": -2.5, "flat": 0.0, "unavailable": float("nan")}


@pytest.mark.parametrize("breadth", sorted(BREADTH))
def test_spike_hunter_matches_reference(world, breadth):
    b = np.float32(BREADTH[breadth])
    tspikes = jsh.SpikeSignal(*(np.asarray(v) for v in world["jspikes"]))
    tspikes = tsh.SpikeSignal(*(torch.from_numpy(np.array(v)) for v in tspikes))
    ref = jax.jit(jsh.spike_hunter)(world["jspikes"], world["jctx"], jnp.float32(b))
    out = tsh.spike_hunter(tspikes, world["tctx"], torch.tensor(b))
    for f in ("trigger", "direction", "autotrade", "score", "stop_loss_pct"):
        r, o = np.asarray(getattr(ref, f)), getattr(out, f).numpy()
        assert r.dtype == o.dtype, f
        np.testing.assert_array_equal(o, r, err_msg=f)
    assert sorted(ref.diagnostics) == sorted(out.diagnostics)
    for k, r in ref.diagnostics.items():
        r, o = np.asarray(r), out.diagnostics[k].numpy()
        assert r.dtype == o.dtype, k
        np.testing.assert_array_equal(o, r, err_msg=k)
