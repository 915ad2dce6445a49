"""Leverage calibration and the regime notifier: the port against the
reference.

* The reference's own cases (``tests/test_io.py::TestLeverageCalibrator``):
  the RANGE ladder with its diff (two PUTs, one row unchanged) from a
  ``MarketContext``, and the defensive, spiky, expensive and stressed rungs
  of ``target_leverage``; the batch ladder against the scalar one on seeded
  rows, NaN ATR among them.
* One replay (``generate_burst_replay``, 40 symbols, 40 ticks: a downtrend
  that ends in a crash) through both packages' engines on the classic
  serial path: every finalize's calibration inputs decoded from the wire
  (valid rows, closes and the regime exactly; ATR% and the stress score
  within float32 summation order, rtol 1e-5),
  the PUTs that ``calibrate_all`` makes from them for a seeded symbol list
  (the same rows, targets and order), and the notifier's digests over the
  replay (it crosses four regime transitions), equal strings.
* The notifier fed a raw ``MarketContext`` (``context_scalars``): the same
  digest as the reference's, deduplicated on the same transition.
"""

from __future__ import annotations

import asyncio

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from binquant_tpu.engine.buffer import SymbolRegistry as JRegistry
from binquant_tpu.enums import MarketRegimeCode
from binquant_tpu.io import binbot as jbinbot
from binquant_tpu.io import leverage as jlev
from binquant_tpu.io import replay as jreplay
from binquant_tpu.regime import context as jctx
from binquant_tpu.schemas import SymbolModel as JSymbol
from binquant_tpu_torch.engine.buffer import SymbolRegistry as TRegistry
from binquant_tpu_torch.io import binbot as tbinbot
from binquant_tpu_torch.io import leverage as tlev
from binquant_tpu_torch.io import replay as treplay
from binquant_tpu_torch.regime import context as tctx
from binquant_tpu_torch.schemas import SymbolModel as TSymbol

torch.set_num_threads(1)

CAPACITY, WINDOW = 64, 200
SERIAL = dict(pipeline_depth=0, donate=False, numeric_digest=False, ingest_digest=False,
              drift_meter=False, outcomes=False)


def _contexts(n: int, regime: int, **feature_over):
    """One MarketContext per package from the same values: a valid,
    stable context over ``n`` valid rows (the reference test's
    ``mk_context`` shape)."""
    feats = dict(
        valid=np.ones(n, bool), timestamp=np.full(n, 1000, np.int32),
        close=np.full(n, 10.0, np.float32), return_pct=np.zeros(n, np.float32),
        ema20=np.full(n, 10.0, np.float32), ema50=np.full(n, 10.0, np.float32),
        above_ema20=np.ones(n, bool), above_ema50=np.ones(n, bool),
        trend_score=np.zeros(n, np.float32), relative_strength_vs_btc=np.zeros(n, np.float32),
        atr_pct=np.full(n, 0.01, np.float32), bb_width=np.full(n, 0.03, np.float32),
        micro_regime=np.full(n, 3, np.int32), micro_regime_strength=np.full(n, 0.6, np.float32),
        micro_transition=np.full(n, -1, np.int32),
        micro_transition_strength=np.zeros(n, np.float32),
    )
    feats.update(feature_over)
    scalars = {name: np.float32(0.1) for name in jctx.MarketContext._fields}
    scalars.update(
        valid=np.bool_(True), timestamp=np.int32(100_000), fresh_count=np.int32(50),
        total_tracked_symbols=np.int32(50), btc_present=np.bool_(True),
        advancers=np.int32(25), decliners=np.int32(20), market_regime=np.int32(regime),
        previous_market_regime=np.int32(regime), market_regime_transition=np.int32(-1),
        regime_is_transitioning=np.bool_(False), regime_stable_since=np.int32(1),
    )
    assert tctx.MarketContext._fields == jctx.MarketContext._fields
    jc = jctx.MarketContext(**{
        k: (jctx.SymbolFeatureArrays(**{f: jnp.asarray(v) for f, v in feats.items()})
            if k == "features" else jnp.asarray(scalars[k]))
        for k in jctx.MarketContext._fields
    })
    tc = tctx.MarketContext(**{
        k: (tctx.SymbolFeatureArrays(**{f: torch.from_numpy(v.copy()) for f, v in feats.items()})
            if k == "features" else torch.tensor(scalars[k]))
        for k in tctx.MarketContext._fields
    })
    return jc, tc


def _calibrators():
    js, ts = jreplay.StubSession(), treplay.StubSession()
    return (jlev.LeverageCalibrator(jbinbot.BinbotApi("http://f", session=js), "kucoin"), js,
            tlev.LeverageCalibrator(tbinbot.BinbotApi("http://f", session=ts), "kucoin"), ts)


def test_ladder_and_diffing():
    jcal, js, tcal, ts = _calibrators()
    jreg, treg = JRegistry(6), TRegistry(6)
    for s in ["AUSDT", "BUSDT", "CUSDT"]:
        jreg.add(s)
        treg.add(s)
    jctx_, tctx_ = _contexts(6, int(MarketRegimeCode.RANGE))
    levs = {"AUSDT": 1, "BUSDT": 2, "CUSDT": 1}
    jrows = [JSymbol(id=k, futures_leverage=v) for k, v in levs.items()]
    trows = [TSymbol(id=k, futures_leverage=v) for k, v in levs.items()]
    jout = jcal.calibrate_all(jctx_, jreg, jrows)
    tout = tcal.calibrate_all(tctx_, treg, trows)
    # RANGE -> 2x: A and C change, B already 2x
    assert tout == jout == {"applied": 2, "no_change": 1, "skipped": 3}
    assert [r.futures_leverage for r in trows] == [r.futures_leverage for r in jrows] == [2, 2, 2]
    assert ts.requests == js.requests and len(ts.requests) == 2


def test_defensive_regime_forces_1x():
    jcal, _, tcal, _ = _calibrators()
    cases = [
        (10.0, 0.01, MarketRegimeCode.HIGH_STRESS, 0.1, 1.0, 1),
        (10.0, 0.01, MarketRegimeCode.TREND_UP, 0.1, 1.0, 3),
        (10.0, 0.05, MarketRegimeCode.TREND_UP, 0.1, 1.0, 1),  # spiky
        (600.0, 0.01, MarketRegimeCode.TREND_UP, 0.1, 1.0, 1),  # expensive
        (10.0, 0.01, MarketRegimeCode.RANGE, 0.8, 1.0, 1),  # stressed
        (10.0, None, MarketRegimeCode.TREND_DOWN, 0.1, 0.4, 1),  # low confidence
        (10.0, None, MarketRegimeCode.TRANSITIONAL, 0.1, 1.0, 1),
    ]
    for close, atr, regime, stress, conf, want in cases:
        args = (close, atr, int(regime), stress, conf)
        assert tcal.target_leverage(*args) == jcal.target_leverage(*args) == want
    rng = np.random.default_rng(3)
    closes = rng.uniform(1, 900, 256)
    atrs = rng.uniform(0, 0.08, 256)
    atrs[::7] = np.nan
    for regime in range(5):
        for stress, conf in ((0.1, 1.0), (0.9, 1.0), (0.1, 0.0)):
            j = jcal.target_leverage_batch(closes, atrs, regime, stress, conf)
            t = tcal.target_leverage_batch(closes, atrs, regime, stress, conf)
            np.testing.assert_array_equal(t, j)
            assert t.dtype == j.dtype
            scalar = [tcal.target_leverage(c, None if np.isnan(a) else a, regime, stress, conf)
                      for c, a in zip(closes, atrs)]
            np.testing.assert_array_equal(t, scalar)


@pytest.fixture(scope="module")
def replayed(tmp_path_factory):
    """Both engines over the burst replay; per package the calibration
    inputs handed over at each finalize, the digests and the registry."""
    path = tmp_path_factory.mktemp("lev") / "burst.jsonl"
    treplay.generate_burst_replay(path, n_symbols=40, n_ticks=40)
    seq = treplay.tick_seq(path)
    assert seq == jreplay.tick_seq(path)
    j = jreplay.make_stub_engine(capacity=CAPACITY, window=WINDOW, incremental=False)
    t = treplay.make_stub_engine(capacity=CAPACITY, window=WINDOW, device="cpu",
                                 incremental=False, fanout=False, **SERIAL)
    out = {"j": {"calib": []}, "t": {"calib": []}}
    for key, eng in (("j", j), ("t", t)):
        eng._run_leverage_calibration = (
            lambda bucket, context, rows=None, _k=key: out[_k]["calib"].append((bucket, context))
        )
    # the reference stub paces its sends a second apart; and every digest
    # shares one dedupe key, so the 900 s cooldown would let only the first
    # through (each tick's sends land before the next tick, so the key is
    # never in flight)
    j.telegram_consumer._min_send_interval_seconds = 0.0
    for eng in (j, t):
        eng.telegram_consumer._signal_dedupe_seconds = 0.0

    async def go():
        for now_ms, klines in seq:
            for eng in (j, t):
                for k in klines:
                    eng.ingest(k)
                await eng.process_tick(now_ms=now_ms)
                await asyncio.gather(*eng.telegram_consumer._background_tasks)
        await t.aclose_delivery()

    asyncio.run(go())
    # the digests among what each Telegram consumer sent (a signal's
    # message names its algorithm)
    for key, eng in (("j", j), ("t", t)):
        out[key]["digests"] = [m for m in eng._telegram_sent if "algorithm</strong>" not in m]
    out["j"]["registry"], out["t"]["registry"] = j.registry, t.registry
    return out


def test_notifier_digests_equal(replayed):
    j, t = replayed["j"]["digests"], replayed["t"]["digests"]
    assert len(j) >= 3 and any("ENTERED_TREND_DOWN" in d for d in j)
    assert t == j


def test_calibration_inputs_and_puts_equal(replayed):
    jc, tc = replayed["j"]["calib"], replayed["t"]["calib"]
    assert len(jc) == len(tc) >= 30
    assert [b for b, _ in jc] == [b for b, _ in tc]
    for (_, a), (_, b) in zip(jc, tc):
        assert isinstance(a, jlev.CalibrationInputs) and isinstance(b, tlev.CalibrationInputs)
        np.testing.assert_array_equal(b.valid, a.valid)
        np.testing.assert_array_equal(b.close, a.close)
        np.testing.assert_allclose(b.atr_pct, a.atr_pct, rtol=1e-5, atol=1e-7)
        assert (b.regime, b.confidence) == (a.regime, a.confidence)
        assert b.stress == pytest.approx(a.stress, rel=1e-5)
    names = replayed["t"]["registry"].to_mapping()
    assert names == replayed["j"]["registry"].to_mapping()
    rng = np.random.default_rng(5)
    levels = {n: float(rng.choice([1.0, 2.0, 3.0, 2.5])) for n in sorted(names)}
    jrows = [JSymbol(id=n, futures_leverage=v) for n, v in levels.items()]
    trows = [TSymbol(id=n, futures_leverage=v) for n, v in levels.items()]
    jcal, js, tcal, ts = _calibrators()
    puts = 0
    for (_, a), (_, b) in list(zip(jc, tc))[::6]:
        jout = jcal.calibrate_all(a, replayed["j"]["registry"], jrows)
        tout = tcal.calibrate_all(b, replayed["t"]["registry"], trows)
        assert tout == jout
        puts += tout["applied"]
    assert ts.requests == js.requests
    assert puts == len(ts.requests) > 0
    assert [r.futures_leverage for r in trows] == [r.futures_leverage for r in jrows]


def test_notifier_reads_a_context_as_the_reference():
    """``build_message`` from a raw MarketContext (``context_scalars``):
    the same text as the reference's, then deduped on the same transition."""
    from binquant_tpu.strategies.market_regime_notifier import MarketRegimeNotifier as JN
    from binquant_tpu_torch.strategies.market_regime_notifier import MarketRegimeNotifier as TN

    jc, tc = _contexts(6, int(MarketRegimeCode.TREND_DOWN))
    over = dict(previous_market_regime=np.int32(MarketRegimeCode.RANGE),
                market_regime_transition=np.int32(4),
                market_regime_transition_strength=np.float32(0.73125))
    jc = jc._replace(**{k: jnp.asarray(v) for k, v in over.items()})
    tc = tc._replace(**{k: torch.tensor(v) for k, v in over.items()})
    jn, tn = JN(env="CI"), TN(env="CI")
    msg = tn.build_message(tc)
    assert msg is not None and msg == jn.build_message(jc)
    assert "ENTERED_TREND_DOWN" in msg and "RANGE -> TREND_DOWN" in msg
    assert tn.build_message(tc) is None and jn.build_message(jc) is None
