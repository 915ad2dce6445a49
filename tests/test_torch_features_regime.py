"""Feature pack and market context: the port against the reference.

``compute_feature_pack`` is compared field by field on one seeded ring
(rows at different fill levels, a NaN hole, a flat row); then
``compute_market_context`` + ``RegimeCarry`` run over consecutive ticks of
appended bars, with the carry threaded through both packages.

Positional fields (bar values, times, counts, codes, masks) must be
bit-exact. Indicator fields built from cumsums, sums and the EWM matmul are
compared at rtol=1e-5 with an absolute floor of 1e-6 times the price scale:
their summation order differs between XLA and torch, and the MACD line is a
difference of two price-scale EMAs, so its float32 error is price-relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from binquant_tpu.engine import buffer as jbuf
from binquant_tpu.regime import context as jctx
from binquant_tpu.strategies import features as jfeat
from binquant_tpu_torch.engine import buffer as tbuf
from binquant_tpu_torch.regime import context as tctx
from binquant_tpu_torch.strategies import features as tfeat

# small shapes: extra intra-op threads only spin and crowd parallel test workers
torch.set_num_threads(1)

S, W, F = 24, 200, tbuf.NUM_FIELDS
PRICE = 100.0
T0 = 1_780_272_000

EXACT_PACK = {
    "open_time", "close_time", "open", "high", "low", "close", "prev_close",
    "volume", "quote_volume", "num_trades", "filled", "valid",
}


def market(rng, n_bars: int) -> np.ndarray:
    """(S, n_bars, F) float32 bars, random walks around PRICE."""
    rets = rng.normal(0, 0.006, (S, n_bars))
    rets[3] -= 0.004  # a falling row
    close = PRICE * np.exp(np.cumsum(rets, axis=1))
    open_ = np.concatenate([close[:, :1], close[:, :-1]], axis=1)
    spread = np.abs(rng.normal(0, 0.002, (S, n_bars))) * close
    high = np.maximum(open_, close) + spread
    low = np.minimum(open_, close) - spread
    vol = np.abs(rng.normal(1000, 250, (S, n_bars)))
    vals = np.stack(
        [open_, high, low, close, vol, vol * close, np.full_like(close, 300.0),
         vol / 2, vol * close / 2, np.full_like(close, 900.0)], axis=-1,
    ).astype(np.float32)
    vals[5, :, :] = vals[5, :1, :]  # a flat row
    return vals


def canonical(vals: np.ndarray, filled: np.ndarray, t_last: int):
    """Right-aligned ring holding each row's last ``filled`` bars."""
    times = np.full((S, W), -1, np.int32)
    values = np.full((S, W, F), np.nan, np.float32)
    for r in range(S):
        n = int(filled[r])
        if n:
            times[r, W - n:] = t_last - 900 * np.arange(n - 1, -1, -1)
            values[r, W - n:] = vals[r, -n:]
    cursor = np.zeros(S, np.int32)
    return (
        jbuf.MarketBuffer(jnp.asarray(times), jnp.asarray(values),
                          jnp.asarray(filled), jnp.asarray(cursor)),
        tbuf.MarketBuffer(torch.from_numpy(times), torch.from_numpy(values),
                          torch.from_numpy(filled.copy()), torch.from_numpy(cursor)),
    )


def check_field(name, ref, out, exact, scale=PRICE):
    ref = np.asarray(ref)
    out = out.numpy()
    assert ref.dtype == out.dtype, (name, ref.dtype, out.dtype)
    assert ref.shape == out.shape, name
    if ref.dtype.kind in "biu":
        np.testing.assert_array_equal(ref, out, err_msg=name)
        return
    np.testing.assert_array_equal(np.isnan(ref), np.isnan(out), err_msg=name)
    if exact:
        np.testing.assert_array_equal(np.nan_to_num(ref), np.nan_to_num(out), err_msg=name)
    else:
        np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6 * scale,
                                   equal_nan=True, err_msg=name)


@pytest.fixture(scope="module")
def ring():
    rng = np.random.default_rng(23)
    vals = market(rng, W + 8)
    filled = np.full(S, W, np.int32)
    filled[[1, 2, 9]] = [30, 120, 1]  # warm-up rows
    filled[[11]] = 0  # empty row
    vals[7, -60, :] = np.nan  # a NaN hole inside the window
    return vals, filled


@pytest.fixture(scope="module")
def packs(ring):
    vals, filled = ring
    jb, tb = canonical(vals[:, :W], filled, T0)
    return jax.jit(jfeat.compute_feature_pack)(jb), tfeat.compute_feature_pack(tb)


def test_feature_pack_layout(packs):
    ref, out = packs
    assert ref._fields == out._fields
    assert np.isfinite(out.rsi.numpy()).sum() >= S - 4


@pytest.mark.parametrize("name", tfeat.FeaturePack._fields)
def test_feature_pack_field_matches(packs, name):
    ref, out = packs
    check_field(name, getattr(ref, name), getattr(out, name), name in EXACT_PACK)


def test_market_context_and_regime_carry_over_ticks(ring):
    vals, filled = ring
    cfg_j = jctx.ContextConfig(required_fresh_symbols=4, min_coverage_ratio=0.5)
    cfg_t = tctx.ContextConfig(required_fresh_symbols=4, min_coverage_ratio=0.5)
    jcarry = jctx.initial_regime_carry(S)
    tcarry = tctx.initial_regime_carry(S, device="cpu")
    tracked = np.ones(S, bool)
    tracked[11] = False
    seen_valid = 0
    for tick in range(5):
        t_last = T0 + 900 * tick
        jb, tb = canonical(vals[:, tick: W + tick], filled, t_last)
        fresh = filled > 0
        fresh[[4, 8]] = tick % 2 == 0  # two rows go stale on odd ticks
        btc_row = 0 if tick != 3 else -1  # BTC missing on one tick
        ts = t_last if tick != 2 else t_last - 900  # a same-bucket re-evaluation
        jc, jcarry = jctx.compute_market_context(
            jb, jnp.asarray(fresh), jnp.asarray(tracked), jnp.int32(btc_row),
            jnp.int32(ts), jcarry, cfg_j,
        )
        tc, tcarry = tctx.compute_market_context(
            tb, torch.from_numpy(fresh), torch.from_numpy(tracked),
            torch.tensor(btc_row, dtype=torch.int32), torch.tensor(ts, dtype=torch.int32),
            tcarry, cfg_t,
        )
        for name in jc._fields:
            if name == "features":
                continue
            check_field(f"context.{name}", getattr(jc, name), getattr(tc, name), False, 1.0)
        for name in jc.features._fields:
            check_field(f"features.{name}", getattr(jc.features, name),
                        getattr(tc.features, name),
                        name in ("valid", "timestamp", "close", "above_ema20", "above_ema50"),
                        1.0)
        for name in jcarry._fields:
            check_field(f"carry.{name}", getattr(jcarry, name), getattr(tcarry, name), False, 1.0)
        seen_valid += bool(np.asarray(jc.valid))
    assert seen_valid >= 3
    assert bool(np.asarray(jcarry.has_prev))
