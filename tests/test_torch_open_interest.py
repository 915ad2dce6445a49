"""The open-interest feed into LiquidationSweepPump against the reference's.

* The cache: ``OpenInterestCache`` of both packages, one fake futures client
  and one driven clock (the reference's module clock patched, the port's
  ``clock``): equal growth through the 900-s horizon (sweeps every 50 s),
  the 300-s staleness, an erroring symbol, and bounded batches; equal
  request counts.
* The engine: a 32-symbol market whose BTC stalls while the breadth is hot
  and falling (LiquidationSweepPump's SHORT route), replayed serially and
  through the scanned drive by both packages (capacity 32, window 120, the
  incremental path; the reference on the CPU) with one fake futures client
  whose 900-s growth is 1.01, 1.02 or 1.05 by symbol and stale for one
  symbol. Every signal tuple is equal between the packages, exactly, and
  each score at the wire contract (``rtol=1e-4, atol=1e-5``). The port
  without the feed fires the LSP rows the feed vetoes (growth 1.01) and the
  others at their unscaled scores: the test fails unless at least one row
  is vetoed and one scaled. No tick makes an open-interest request.
"""

from __future__ import annotations

import asyncio
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from binquant_tpu.io import pipeline as jpipeline
from binquant_tpu.io import replay as jreplay
from binquant_tpu_torch.io import pipeline as tpipeline
from binquant_tpu_torch.io import replay as treplay

torch.set_num_threads(1)

CAPACITY, WINDOW, N_TICKS = 32, 120, 112
GROWTH = (1.01, 1.02, 1.05)  # by symbol index mod 3
STALE = "S007USDT"  # its fetch fails at the last sweep: its growth reads stale
# the reference engines run under tests/conftest.py's pins: the port's
# observability, delivery plane and fan-out plane off to match
PINS = dict(trace_sample=0.0, freshness=False, host_phase=False, slo=False,
            delivery_health=False, fanout=False, delivery=False, outcomes=False)
# hot (> 0.3) and falling: LSP's SHORT route
BREADTH = {"timestamp": [1, 2, 3, 4], "market_breadth": [0.5, 0.45, 0.4, 0.35],
           "market_breadth_ma": [0.5, 0.45, 0.4, 0.35]}
LSP = "liquidation_sweep_pump"


class FakeTime:
    """The ``time`` module with ``monotonic`` driven by the test."""

    def __init__(self) -> None:
        self.now = 0.0

    def monotonic(self) -> float:
        return self.now

    def __getattr__(self, name):
        return getattr(time, name)


class FuturesApi:
    """Open interest growing ``GROWTH[i % 3]`` every 900 s of the driven
    clock; ``failing`` symbols raise; every call counted."""

    def __init__(self, clock: FakeTime, names: list[str]) -> None:
        self.clock = clock
        self.index = {n: i for i, n in enumerate(names)}
        self.failing: set[str] = set()
        self.calls = 0

    def get_open_interest(self, symbol: str) -> float:
        self.calls += 1
        if symbol in self.failing:
            raise ConnectionError(f"{symbol}: open interest unavailable")
        i = self.index[symbol]
        return 1000.0 * (1 + i % 5) * GROWTH[i % 3] ** (self.clock.now / 900.0 + 2)


def _growths(cache, names) -> list:
    return [cache.growth(n) for n in names]


def _same(a: list, b: list) -> bool:
    return np.array_equal(np.asarray(a, np.float64), np.asarray(b, np.float64), equal_nan=True)


def test_cache_growth_horizon_staleness_and_errors(monkeypatch):
    names = [f"S{i:03d}USDTM" for i in range(9)] + ["BADUSDTM"]
    clock = FakeTime()
    monkeypatch.setattr(jpipeline, "time", clock)
    api_j, api_t = FuturesApi(clock, names), FuturesApi(clock, names)
    for api in (api_j, api_t):
        api.failing = {"BADUSDTM"}
    jcache = jpipeline.OpenInterestCache(api_j, max_concurrency=3)
    tcache = tpipeline.OpenInterestCache(api_t, max_concurrency=3, clock=clock.monotonic)
    seen_finite = False
    for step in range(40):  # sweeps every 50 s for 2,000 s
        clock.now = 50.0 * step
        if step == 25:
            for api in (api_j, api_t):
                api.failing.add("S004USDTM")  # refreshes stop: stale 300 s later
        for cache in (jcache, tcache):
            asyncio.run(cache.refresh_batch(names))
        a, b = _growths(jcache, names), _growths(tcache, names)
        assert _same(a, b), (step, a, b)
        if clock.now < 900.0:
            assert np.isnan(b).all()
        seen_finite |= bool(np.isfinite(b).any())
    assert seen_finite
    assert np.isnan(tcache.growth("BADUSDTM")) and np.isnan(tcache.growth("S004USDTM"))
    assert tcache.growth("S001USDTM") == pytest.approx(1.02, rel=1e-12)
    assert jcache.requests_made == tcache.requests_made == api_t.calls - 40 - 15
    assert api_j.calls == api_t.calls
    # a read is a cache read: no request
    calls = api_t.calls
    _growths(tcache, names)
    assert api_t.calls == calls


def test_refresh_forever_rotates_in_batches_alike(monkeypatch):
    names = [f"S{i}" for i in range(7)]
    out = []
    for mod in (jpipeline, tpipeline):
        clock = FakeTime()
        api = FuturesApi(clock, names)
        seen: list = []
        get = api.get_open_interest
        api.get_open_interest = lambda s, get=get: (seen.append(s), get(s))[1]
        cache = mod.OpenInterestCache(api, batch_size=3, batch_interval_s=0.0)

        async def run(cache=cache, seen=seen):
            task = asyncio.create_task(cache.refresh_forever(lambda: names))
            while len(seen) < 10:
                await asyncio.sleep(0.001)
            task.cancel()
            with pytest.raises(asyncio.CancelledError):
                await task

        asyncio.run(run())
        # batches of 3, the last of a sweep short; then the sweep wraps
        out.append([sorted(seen[:3]), sorted(seen[3:6]), seen[6:7], sorted(seen[7:10])])
    assert out[0] == out[1] == [["S0", "S1", "S2"], ["S3", "S4", "S5"], ["S6"],
                                ["S0", "S1", "S2"]]
    assert asyncio.run(tpipeline.OpenInterestCache(None).refresh_forever(lambda: names)) is None


def write_market(path: Path, seed: int = 31) -> list[str]:
    """A 32-symbol, N_TICKS-tick replay: 5m random walks and the 15m bars
    aggregated from them, BTC nearly flat (its 15m momentum inside LSP's
    stalled band), every 4th symbol trading heavy on the last 8 ticks."""
    rng = np.random.default_rng(seed)
    names = ["BTCUSDT"] + [f"S{i:03d}USDT" for i in range(1, CAPACITY)]
    n5 = 3 * N_TICKS
    sig = np.full((CAPACITY, 1), 0.004)
    sig[0] = 0.0002
    close = (20 + rng.random((CAPACITY, 1)) * 80) * np.exp(
        np.cumsum(rng.normal(0.0, 1.0, (CAPACITY, n5)) * sig, axis=1))
    open_ = np.concatenate([close[:, :1], close[:, :-1]], axis=1)
    high = np.maximum(open_, close) * 1.001
    low = np.minimum(open_, close) * 0.999
    vol = np.abs(rng.normal(1000, 200, (CAPACITY, n5)))
    vol[3::4, -24:] *= 4.0
    t0 = 1_780_272_000
    lines = []
    for t in range(N_TICKS):
        ts15 = t0 + 900 * t
        for r, name in enumerate(names):
            c5 = slice(3 * t, 3 * t + 3)
            lines.append(treplay._kline_json(
                name, ts15, 900, open_[r, 3 * t], high[r, c5].max(), low[r, c5].min(),
                close[r, 3 * t + 2], vol[r, c5].sum()))
            for j in range(3):
                lines.append(treplay._kline_json(
                    name, ts15 + 300 * j, 300, open_[r, 3 * t + j], high[r, 3 * t + j],
                    low[r, 3 * t + j], close[r, 3 * t + j], vol[r, 3 * t + j]))
    path.write_text("".join(lines))
    return names


def _drive(engine, seq, scanned: bool) -> list:
    out: list = []

    async def go():
        if scanned:
            out.extend(await engine.process_ticks_scanned(seq))
        else:
            for now_ms, klines in seq:
                for k in klines:
                    engine.ingest(k)
                out.extend(await engine.process_tick(now_ms=now_ms))
        out.extend(await engine.flush_pending())

    asyncio.run(go())
    return [(*t, float(s.value.score)) for t, s in zip(treplay.signal_tuples(out), out)]


def _fill(cache, names, clock: FakeTime, api: FuturesApi) -> None:
    """Sweeps at -900, 0 and 900 s; STALE fails the last, so at 900 s its
    growth (of 0 s) is stale and every other symbol's is one horizon."""
    for now in (-900.0, 0.0, 900.0):
        clock.now = now
        api.failing = {STALE} if now == 900.0 else set()
        asyncio.run(cache.refresh_batch(names))


@pytest.fixture(scope="module")
def drives(tmp_path_factory):
    path = tmp_path_factory.mktemp("torch_oi") / "oi_market.jsonl"
    names = write_market(path)
    seq = treplay.tick_seq(path)
    mp = pytest.MonkeyPatch()
    clock = FakeTime()
    mp.setattr(jpipeline, "time", clock)
    out: dict = {}
    try:
        for scanned in (False, True):
            jeng = jreplay.make_stub_engine(capacity=CAPACITY, window=WINDOW, incremental=True,
                                            scan_chunk=32, breadth=BREADTH)
            api = FuturesApi(clock, names)
            jeng.oi_cache = jpipeline.OpenInterestCache(api)
            _fill(jeng.oi_cache, names, clock, api)
            calls = api.calls
            out[("jax", scanned)] = _drive(jeng, seq, scanned)
            assert api.calls == calls  # no request from a tick
        for scanned, oi in ((False, True), (True, True), (False, False)):
            eng = treplay.make_stub_engine(capacity=CAPACITY, window=WINDOW, device="cpu",
                                           incremental=True, scan_chunk=32, breadth=BREADTH,
                                           **PINS)
            if oi:
                api = FuturesApi(clock, names)
                eng.oi_cache = tpipeline.OpenInterestCache(api, clock=clock.monotonic)
                _fill(eng.oi_cache, names, clock, api)
                calls = api.calls
            out[("port", scanned, oi)] = _drive(eng, seq, scanned)
            if oi:
                assert api.calls == calls
                assert eng.scanned_ticks > 0 if scanned else eng.scanned_ticks == 0
    finally:
        mp.undo()
    return names, out


def _match(a: list, b: list) -> None:
    assert [t[:5] for t in a] == [t[:5] for t in b]
    np.testing.assert_allclose([t[5] for t in a], [t[5] for t in b], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("scanned", [False, True], ids=["serial", "scanned"])
def test_signals_and_lsp_scores_equal_the_reference(drives, scanned):
    _, out = drives
    jax, port = out[("jax", scanned)], out[("port", scanned, True)]
    assert any(t[1] == LSP for t in jax)
    _match(port, jax)


def test_serial_and_scanned_agree(drives):
    _, out = drives
    _match(out[("port", True, True)], out[("port", False, True)])


def test_the_feed_vetoes_and_scales_lsp(drives):
    names, out = drives
    growth = {n: GROWTH[i % 3] for i, n in enumerate(names)}
    growth[STALE] = float("nan")
    with_oi = {(t[0], t[2]): t[5] for t in out[("port", False, True)] if t[1] == LSP}
    without = {(t[0], t[2]): t[5] for t in out[("port", False, False)] if t[1] == LSP}
    vetoed = set(without) - set(with_oi)
    assert vetoed and not set(with_oi) - set(without)
    assert all(growth[sym] < 1.02 for _, sym in vetoed)
    scaled = 0
    for key, score in with_oi.items():
        g = growth[key[1]]
        factor = g if np.isfinite(g) and g > 1.0 else 1.0
        assert score == pytest.approx(without[key] * factor, rel=1e-4, abs=1e-5)
        scaled += factor > 1.0
    assert scaled >= 1
