"""The port's incremental engine against the reference's, end to end.

* The 120-tick replay (24 symbols, seed 7, capacity 64, window 200, an
  audit every 16 ticks), both packages on the incremental path at depth 0
  (the reference with both wire digests on, the port serial with copied
  rings and no digests), the port on the CPU: the emitted signal tuples
  ``(tick_ms, strategy, symbol, direction, autotrade)`` are EQUAL, in
  order, and the routing counters are equal — one cold start and seven
  audits, 112 incremental ticks.
* The same replay through the port's production loop (depth 1, rings in
  place, both digests and the drift meter on): the same signal tuples in
  the same order, the same routing, every tick's ingest digest block equal
  to the reference's bit for bit, every numeric digest block's counts
  equal exactly, and the meter run on each of the seven audit ticks.
* The routing reasons, tick by tick, on one scripted stream (the
  reference's ``tests/test_incremental.py::test_pipeline_gating_reasons``,
  extended): ``cold_start`` on the first tick, ``audit`` every 7 ticks, a
  re-sent bucket (``rewrite``), ``prune_symbols`` (``churn``) and the
  pruned symbol coming back into a reclaimed row (``churn``). After every
  tick the port's ``incremental_ticks``, ``full_recompute_ticks`` and
  ``full_recompute_reasons`` equal the reference engine's, and both
  engines emit the same signals (none: 30 ticks are under the strategies'
  100-bar floor; the replay above covers the signals).
"""

from __future__ import annotations

import asyncio
import copy

import numpy as np
import pytest
import torch

from binquant_tpu.io import replay as jreplay
from binquant_tpu_torch.io import replay as treplay

# small shapes: extra intra-op threads only spin and crowd parallel test workers
torch.set_num_threads(1)

CAPACITY, WINDOW = 64, 200
# the serial loop (depth 0) with copied rings and no digests or meter
SERIAL = dict(pipeline_depth=0, donate=False, numeric_digest=False, ingest_digest=False,
              drift_meter=False)


@pytest.fixture(scope="module")
def replay_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("torch_incr_replay") / "rp_7.jsonl"
    treplay.generate_replay_file(path, n_symbols=24, n_ticks=120, seed=7)
    return path


def _drive_recorded(engine, path) -> tuple[list, list]:
    """The replay through one engine, as ``run_replay`` drives it (flush
    at the end); returns the signal tuples and each finalized tick's
    numeric digest block, in tick order."""
    numeric: list = []
    observe = engine.numeric.observe

    def record(vec, *args, **kwargs):
        numeric.append(np.array(vec, np.float32))
        return observe(vec, *args, **kwargs)

    engine.numeric.observe = record
    engine.ingest_monitor.record_history = True
    sig: list = []

    async def go():
        for tick_ms, klines in treplay.tick_seq(path):
            for k in klines:
                engine.ingest(k)
            sig.extend(treplay.signal_tuples(await engine.process_tick(now_ms=tick_ms)))
        sig.extend(treplay.signal_tuples(await engine.flush_pending()))

    asyncio.run(go())
    return sig, numeric


@pytest.fixture(scope="module")
def runs(replay_path):
    # the reference's incremental engine at depth 0 with both digests on
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("BQT_NUMERIC_DIGEST", "1")
        mp.setenv("BQT_INGEST_DIGEST", "1")
        mp.setenv("BQT_DRIFT_METER", "0")
        jeng = jreplay.make_stub_engine(capacity=CAPACITY, window=WINDOW, incremental=True,
                                        carry_audit_every=16, pipeline_depth=0)
        assert jeng.numeric_digest and jeng.ingest_digest
        jax_sig, jax_numeric = _drive_recorded(jeng, replay_path)
    jstats = {k: getattr(jeng, k) for k in ("incremental_ticks", "full_recompute_ticks")}
    port_sig: list = []
    tstats = treplay.run_replay(
        replay_path, capacity=CAPACITY, window=WINDOW, collect=port_sig,
        device="cpu", incremental=True, carry_audit_every=16, **SERIAL,
    )
    return dict(jax_sig=jax_sig, jstats=jstats, port_sig=port_sig, tstats=tstats,
                jax_numeric=jax_numeric, jax_ingest=jeng.ingest_monitor.digests)


def test_incremental_replay_signal_tuples_equal_reference(runs):
    jax_sig, port_sig, tstats = runs["jax_sig"], runs["port_sig"], runs["tstats"]
    assert tstats["device"] == "cpu" and tstats["ticks"] == 120
    assert len(jax_sig) > 0  # the crafted setups fire: not an empty-vs-empty match
    assert {s[1] for s in jax_sig} >= {"activity_burst_pump", "mean_reversion_fade"}
    assert port_sig == jax_sig


@pytest.mark.parametrize("counter", ["incremental_ticks", "full_recompute_ticks"])
def test_incremental_replay_routing_counts_equal_reference(runs, counter):
    jstats, tstats = runs["jstats"], runs["tstats"]
    assert tstats[counter] == jstats[counter]
    assert tstats["incremental_ticks"] == 112 and tstats["full_recompute_ticks"] == 8
    assert tstats["full_recompute_reasons"] == {"cold_start": 1, "audit": 7}


# --------------------------------------------------------------------------
# the production loop: depth 1, rings in place, digests and meter on
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def pipelined(replay_path):
    engine = treplay.make_stub_engine(capacity=CAPACITY, window=WINDOW, device="cpu",
                                      incremental=True, carry_audit_every=16, fanout=False)
    assert engine.pipeline_depth == 1 and engine._donation_mode() == "single"
    assert engine.numeric_digest and engine.ingest_digest and engine.drift_meter_enabled
    sig, numeric = _drive_recorded(engine, replay_path)
    return engine, sig, numeric


def test_pipelined_replay_signal_tuples_and_routing_equal_reference(runs, pipelined):
    engine, sig, _ = pipelined
    assert sig == runs["jax_sig"] and len(sig) == 106
    assert engine.incremental_ticks == 112 and engine.full_recompute_ticks == 8
    assert engine.full_recompute_reasons == {"cold_start": 1, "audit": 7}
    assert engine.inplace_ticks == 120 and engine.state_resets == 0
    assert engine.overflow_ticks == 0 and not engine._pending


def test_pipelined_replay_ingest_digest_blocks_bit_exact(runs, pipelined):
    engine = pipelined[0]
    jblocks, tblocks = runs["jax_ingest"], engine.ingest_monitor.digests
    assert len(jblocks) == len(tblocks) == 120
    for i, (a, b) in enumerate(zip(jblocks, tblocks)):
        np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32), err_msg=f"tick {i}")
    assert engine.ingest_monitor.anomaly_ticks == 0


def test_pipelined_replay_numeric_digest_counts_exact(runs, pipelined):
    """Every count field (leaked rows per stage, non-finite and fired per
    strategy) equal on every tick; the float fields are held in
    ``tests/test_torch_step.py`` and ``tests/test_torch_incremental_step.py``."""
    from binquant_tpu_torch.engine import step as tstep

    n_counts = 2 * len(tstep.NUMERIC_STAGES) + 2 * len(tstep.STRATEGY_ORDER)
    jnum, tnum = runs["jax_numeric"], pipelined[2]
    assert len(jnum) == len(tnum) == 120
    for i, (a, b) in enumerate(zip(jnum, tnum)):
        np.testing.assert_array_equal(a[:n_counts], b[:n_counts], err_msg=f"tick {i}")
    assert sum(v[n_counts - len(tstep.STRATEGY_ORDER):n_counts].sum() for v in tnum) >= 106
    assert pipelined[0].numeric.anomaly_ticks == 0


def test_pipelined_replay_meters_every_audit_tick(pipelined):
    engine = pipelined[0]
    assert engine.drift.audits == 7 and engine.drift.skipped == 0
    assert set(engine.drift.last) == {"ewm", "sums", "moments", "supertrend", "beta_corr",
                                      "abp_sorted", "lsp_sorted"}


# --------------------------------------------------------------------------
# routing reasons, tick by tick
# --------------------------------------------------------------------------

PRUNED = "S005USDT"
N_TICKS = 30
RESEND, PRUNE = 20, 21  # a re-sent bucket; a prune (the symbol returns on tick 22)


def _script(replay_path):
    """(bucket, klines, prune-before?) per tick: the replay's first buckets,
    bucket RESEND carrying the previous bucket again (a rewrite of every
    symbol's newest bars), the PRUNE tick without the pruned symbol, which
    comes back on the next tick into a reclaimed row."""
    by_tick = treplay.load_klines_by_tick(replay_path)
    buckets = sorted(by_tick)[:N_TICKS]
    script = []
    for i, b in enumerate(buckets):
        klines = [dict(k) for k in by_tick[b]]
        if i == RESEND:
            klines += [dict(k, close=k["close"] * 1.001) for k in by_tick[buckets[i - 1]]]
        if i == PRUNE:
            klines = [k for k in klines if k["symbol"] != PRUNED]
        script.append((b, klines, i == PRUNE))
    return script


def _drive_counted(engine, script) -> list:
    symbols = sorted({k["symbol"] for _, klines, _ in script for k in klines})
    out = []

    async def go():
        for bucket, klines, prune in script:
            if prune:
                assert engine.prune_symbols([s for s in symbols if s != PRUNED]) == 1
            for k in sorted(copy.deepcopy(klines), key=lambda k: k["open_time"]):
                engine.ingest(k)
            fired = await engine.process_tick(now_ms=(bucket + 1) * 900 * 1000)
            out.append((
                engine.incremental_ticks,
                engine.full_recompute_ticks,
                dict(engine.full_recompute_reasons),
                sorted((s.strategy, s.symbol) for s in fired),
            ))

    asyncio.run(go())
    return out


def test_routing_reasons_match_reference_tick_by_tick(replay_path, runs):
    script = _script(replay_path)
    # the reference engine with the digests of the ``runs`` engine, whose
    # compiled steps it reuses; the digests do not change the routing
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("BQT_NUMERIC_DIGEST", "1")
        mp.setenv("BQT_INGEST_DIGEST", "1")
        jeng = jreplay.make_stub_engine(capacity=CAPACITY, window=WINDOW, incremental=True,
                                        carry_audit_every=7)
        jout = _drive_counted(jeng, script)
    teng = treplay.make_stub_engine(capacity=CAPACITY, window=WINDOW, incremental=True,
                                    carry_audit_every=7, device="cpu", fanout=False, **SERIAL)
    tout = _drive_counted(teng, script)
    for i, (j, t) in enumerate(zip(jout, tout, strict=True)):
        assert t == j, f"tick {i}: port {t[:3]} vs reference {j[:3]}"
    reasons = tout[-1][2]
    # cold start; audits at 7, 14 and 28 (21 is the prune's churn tick);
    # one rewrite; two churns (the prune, the reclaimed row)
    assert reasons == {"cold_start": 1, "audit": 3, "rewrite": 1, "churn": 2}
    assert tout[-1][0] == N_TICKS - 7
