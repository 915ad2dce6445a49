"""The port's incremental engine against the reference's, end to end.

* The 120-tick replay (24 symbols, seed 7, capacity 64, window 200, an
  audit every 16 ticks), both packages on the incremental path at depth 0,
  the port on the CPU: the emitted signal tuples ``(tick_ms, strategy,
  symbol, direction, autotrade)`` are EQUAL, in order, and the routing
  counters are equal — one cold start and seven audits, 112 incremental
  ticks.
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

import pytest
import torch

from binquant_tpu.io import replay as jreplay
from binquant_tpu_torch.io import replay as treplay

# small shapes: extra intra-op threads only spin and crowd parallel test workers
torch.set_num_threads(1)

CAPACITY, WINDOW = 64, 200


@pytest.fixture(scope="module")
def replay_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("torch_incr_replay") / "rp_7.jsonl"
    treplay.generate_replay_file(path, n_symbols=24, n_ticks=120, seed=7)
    return path


@pytest.fixture(scope="module")
def runs(replay_path):
    jax_sig: list = []
    jstats = jreplay.run_replay(
        replay_path, capacity=CAPACITY, window=WINDOW, collect=jax_sig,
        incremental=True, carry_audit_every=16, pipeline_depth=0,
    )
    port_sig: list = []
    tstats = treplay.run_replay(
        replay_path, capacity=CAPACITY, window=WINDOW, collect=port_sig,
        device="cpu", incremental=True, carry_audit_every=16,
    )
    return jax_sig, jstats, port_sig, tstats


def test_incremental_replay_signal_tuples_equal_reference(runs):
    jax_sig, _, port_sig, tstats = runs
    assert tstats["device"] == "cpu" and tstats["ticks"] == 120
    assert len(jax_sig) > 0  # the crafted setups fire: not an empty-vs-empty match
    assert {s[1] for s in jax_sig} >= {"activity_burst_pump", "mean_reversion_fade"}
    assert port_sig == jax_sig


@pytest.mark.parametrize("counter", ["incremental_ticks", "full_recompute_ticks"])
def test_incremental_replay_routing_counts_equal_reference(runs, counter):
    _, jstats, _, tstats = runs
    assert tstats[counter] == jstats[counter]
    assert tstats["incremental_ticks"] == 112 and tstats["full_recompute_ticks"] == 8
    assert tstats["full_recompute_reasons"] == {"cold_start": 1, "audit": 7}


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
    jeng = jreplay.make_stub_engine(capacity=CAPACITY, window=WINDOW, incremental=True,
                                    carry_audit_every=7)
    teng = treplay.make_stub_engine(capacity=CAPACITY, window=WINDOW, incremental=True,
                                    carry_audit_every=7, device="cpu")
    jout = _drive_counted(jeng, script)
    tout = _drive_counted(teng, script)
    for i, (j, t) in enumerate(zip(jout, tout, strict=True)):
        assert t == j, f"tick {i}: port {t[:3]} vs reference {j[:3]}"
    reasons = tout[-1][2]
    # cold start; audits at 7, 14 and 28 (21 is the prune's churn tick);
    # one rewrite; two churns (the prune, the reclaimed row)
    assert reasons == {"cold_start": 1, "audit": 3, "rewrite": 1, "churn": 2}
    assert tout[-1][0] == N_TICKS - 7
