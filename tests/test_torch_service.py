"""The service around the tick: the startup backfill and the consume loop.

* ``backfill`` from a fake REST source (the replay file's bars per symbol
  and interval, one symbol's fetches raising, bars that close after
  ``now_ms`` served too), flushed every 3 symbols, through both packages'
  engines on the incremental path: BTC claims the first row even when
  listed last, the failing symbol is skipped, no bar after ``now_ms``
  lands, the registries and the rings equal the reference's bit for bit,
  and the next tick recomputes in full in both (``cold_start``: a cold
  engine has no carry to resync), the one after it incremental, with
  equal fired tuples. A second backfill on the running engine (the top-up
  after a restore) routes the next tick as ``backfill`` in both, and its
  fired tuples agree.
* ``consume_loop`` (the production loop: depth 1, rings in place, both
  digests, the drift meter, outcomes) fed bucket by bucket from an
  ``asyncio.Queue``, with a checkpoint every 4 ticks: engine A is
  cancelled one tick after its save at tick 108 with that tick still in
  flight (early emission off), and the shutdown flush emits it; engine B
  boots cold, restores the archive, tops the rings up by ``backfill``
  (the bars it already holds, written again) and consumes the rest. A's
  tuples through the cut are ``run_replay``'s, and A's through the save
  followed by B's are the uninterrupted run's tuples exactly; B's first
  tick is the ``backfill`` full recompute.
* While a checkpoint save holds the state, a tick dispatch and a backfill
  flush raise; after it, the engine ticks on.
* ``recover_if_state_poisoned`` leaves a healthy state alone and resets a
  state whose probe fails cold.
"""

from __future__ import annotations

import asyncio
from collections import defaultdict

import numpy as np
import pytest
import torch

from binquant_tpu.engine import step as jstep
from binquant_tpu.io import replay as jreplay
from binquant_tpu_torch.engine import step as tstep
from binquant_tpu_torch.io import checkpoint as tckpt
from binquant_tpu_torch.io import replay as treplay

torch.set_num_threads(1)

CAP, WIN = 16, 130
N_SYMBOLS, N_TICKS = 8, 112
SERIAL = dict(pipeline_depth=0, donate=False, numeric_digest=False, ingest_digest=False,
              drift_meter=False, outcomes=False)
FAILING = "S003USDT"


@pytest.fixture(scope="module")
def stream(tmp_path_factory):
    path = tmp_path_factory.mktemp("tservice") / "replay.jsonl"
    treplay.generate_replay_file(path, n_symbols=N_SYMBOLS, n_ticks=N_TICKS, seed=7)
    seq = treplay.tick_seq(path)
    history = defaultdict(list)
    for _, klines in seq:
        for k in klines:
            interval = "5m" if k["close_time"] - k["open_time"] < 400_000 else "15m"
            history[(k["symbol"], interval)].append(k)
    return {"path": path, "seq": seq, "history": history}


def _fetcher(history, fail: str | None = FAILING):
    calls = []

    def fetch(symbol: str, interval: str) -> list[dict]:
        calls.append((symbol, interval))
        if symbol == fail:
            raise ConnectionError(f"{symbol} history unavailable")
        return [dict(k) for k in history[(symbol, interval)]]

    return fetch, calls


def _drive(engine, ticks) -> list:
    async def go():
        out = []
        for now_ms, klines in ticks:
            for k in klines:
                engine.ingest(k)
            out.extend(treplay.signal_tuples(await engine.process_tick(now_ms=now_ms)))
        out.extend(treplay.signal_tuples(await engine.flush_pending()))
        return out

    return asyncio.run(go())


def test_backfill_matches_reference(stream):
    seq, history = stream["seq"], stream["history"]
    cut = N_TICKS - 3
    assert cut + 3 == len(seq)
    now_ms = seq[cut - 1][0]
    symbols = sorted({s for s, _ in history if s != "BTCUSDT"}) + ["BTCUSDT"]
    jeng = jreplay.make_stub_engine(capacity=CAP, window=WIN, incremental=True,
                                    carry_audit_every=48)
    teng = treplay.make_stub_engine(capacity=CAP, window=WIN, device="cpu", incremental=True,
                                    carry_audit_every=48, fanout=False, **SERIAL)
    jfetch, _ = _fetcher(history)
    tfetch, calls = _fetcher(history)
    jn = jeng.backfill(symbols, jfetch, now_ms=now_ms, chunk=3, concurrency=4)
    tn = teng.backfill(symbols, tfetch, now_ms=now_ms, chunk=3, concurrency=4)
    assert tn == jn == (N_SYMBOLS - 1) * 4 * cut
    assert sorted(calls) == sorted((s, i) for s in symbols for i in ("5m", "15m"))
    assert teng.backfill_stats["fetches_failed"] == 2
    mapping = teng.registry.to_mapping()
    assert mapping == jeng.registry.to_mapping()
    assert mapping["BTCUSDT"] == 0 and FAILING not in mapping
    canon = tstep.canonicalize_state(teng.state)
    jcanon = jstep.canonicalize_state(jeng.state)
    for ring in ("buf5", "buf15"):
        for f in ("times", "values", "filled"):
            t = getattr(getattr(canon, ring), f).numpy()
            j = np.asarray(getattr(getattr(jcanon, ring), f))
            assert t.dtype == j.dtype
            assert np.array_equal(t, j, equal_nan=t.dtype.kind == "f"), (ring, f)
        assert getattr(canon, ring).times.max().item() * 1000 < now_ms
    # a cold engine has no carry to resync: its first tick is the cold start
    assert teng._carry_desync_reason == jeng._carry_desync_reason == "cold_start"

    paths = []
    for tick in seq[cut:cut + 2]:
        ft, fj = _drive(teng, [tick]), _drive(jeng, [tick])
        assert ft == fj
        paths.append(teng.last_path)
    # the top-up of a running engine (after a restore, as at boot): the bars
    # it holds are written again, and the carry is resynced by a full tick
    top = seq[cut + 1][0]
    assert teng.backfill(symbols, tfetch, now_ms=top, chunk=3) == jeng.backfill(
        symbols, jfetch, now_ms=top, chunk=3)
    assert teng._carry_desync_reason == jeng._carry_desync_reason == "backfill"
    ft, fj = _drive(teng, seq[-1:]), _drive(jeng, seq[-1:])
    assert ft == fj and len(ft) > 0
    paths.append(teng.last_path)
    assert paths == ["cold_start", "incremental", "backfill"]
    assert teng.full_recompute_reasons == jeng.full_recompute_reasons == {
        "cold_start": 1, "backfill": 1}


class _Clock:
    now_ms = 0

    def __call__(self) -> int:
        return self.now_ms


async def _consume(engine, ticks, clock: _Clock, stop_after: int | None = None):
    """Feed one bucket at a time into the engine's consume loop; cancel the
    loop once ``stop_after`` ticks ran (else after the last) and return."""
    queue: asyncio.Queue = asyncio.Queue()
    task = asyncio.create_task(engine.consume_loop(queue, tick_interval_s=0.0, clock=clock))
    for now_ms, klines in ticks:
        clock.now_ms = now_ms
        before = engine.ticks_processed
        for k in klines:
            queue.put_nowait(k)
        while engine.ticks_processed == before:
            await asyncio.sleep(0.001)
        if stop_after is not None and engine.ticks_processed >= stop_after:
            break
    # let a due checkpoint save finish before the cancel
    while engine.checkpoint is not None and engine.checkpoint.should_save(engine) and (
        engine.checkpoint.last_saved_tick != engine.ticks_processed
    ):
        await asyncio.sleep(0.001)
    task.cancel()
    with pytest.raises(asyncio.CancelledError):
        await task


def test_consume_loop_kill_and_restart(stream, tmp_path):
    seq, history = stream["seq"], stream["history"]
    whole: list = []
    treplay.run_replay(stream["path"], capacity=CAP, window=WIN, collect=whole, device="cpu")
    assert whole

    archive = tmp_path / "loop.ckpt.npz"
    save_tick, cut = 108, 109
    a = treplay.make_stub_engine(capacity=CAP, window=WIN, device="cpu")
    a.checkpoint = tckpt.CheckpointManager(archive, every_ticks=4)
    a.early_emit = False  # the cut tick is still in flight at the cancel
    clock = _Clock()
    asyncio.run(_consume(a, seq, clock, stop_after=cut))
    assert a.ticks_processed == cut and not a._pending
    assert a.checkpoint.last_saved_tick == save_tick
    # what the autotrade consumer was handed through the delivery plane
    got_a = treplay.delivered_tuples(a._autotrade_received, tracer=a.tracer)
    assert got_a == [s for s in whole if s[0] <= seq[cut - 1][0]]

    b = treplay.make_stub_engine(capacity=CAP, window=WIN, device="cpu")
    b.checkpoint = tckpt.CheckpointManager(archive, every_ticks=4)
    assert b.checkpoint.try_restore(b) and b.ticks_processed == save_tick
    fetch, _ = _fetcher(history, fail=None)
    b.backfill(sorted({s for s, _ in history}), fetch, now_ms=seq[save_tick - 1][0])
    assert b._carry_desync_reason == "backfill"
    paths: list = []
    record = b._route

    def route():
        out = record()
        paths.append(out)
        return out

    b._route = route
    asyncio.run(_consume(b, seq[save_tick:], clock))
    assert paths[0] == (False, "backfill") and all(p == (True, None) for p in paths[1:])
    got = [s for s in got_a if s[0] <= seq[save_tick - 1][0]] + treplay.delivered_tuples(
        b._autotrade_received, tracer=b.tracer)
    assert got == whole


def test_no_tick_while_a_save_holds_the_state(stream):
    """A tick dispatched, or a backfill flushed, while a checkpoint save
    reads the state raises instead of writing the rings under it."""
    eng = treplay.make_stub_engine(capacity=CAP, window=WIN, device="cpu", **SERIAL)
    _drive(eng, stream["seq"][:2])
    with eng.hold_state("checkpoint save"):
        with pytest.raises(RuntimeError, match="held"):
            _drive(eng, stream["seq"][2:3])
        fetch, _ = _fetcher(stream["history"], fail=None)
        with pytest.raises(RuntimeError, match="held"):
            eng.backfill(["BTCUSDT"], fetch, now_ms=stream["seq"][1][0])
    assert eng.ticks_processed == 2
    _drive(eng, stream["seq"][2:3])
    assert eng.ticks_processed == 3


def test_poisoned_state_resets_cold(stream):
    """After a swallowed tick error the loop probes the state: a healthy
    one is left alone, one whose probe fails is reset cold."""
    eng = treplay.make_stub_engine(capacity=CAP, window=WIN, device="cpu", **SERIAL)
    _drive(eng, stream["seq"][:2])
    state = eng.state
    eng.recover_if_state_poisoned()
    assert eng.state is state and eng.state_resets == 0

    class Poisoned:
        def __getitem__(self, key):
            raise RuntimeError("CUDA error: an illegal memory access was encountered")

    eng.state = eng.state._replace(mrf_last_emitted=Poisoned())
    eng.recover_if_state_poisoned()
    assert eng.state_resets == 1 and eng._carry_desync_reason == "cold_start"
    assert not eng.state.buf5.filled.any()
