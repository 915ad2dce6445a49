"""The port's pipelined production loop on the CPU (no reference run).

Mirrors ``tests/test_pipelined_tick.py`` for the port, and adds what the
in-place rings ask for:

* depth 1 (the production default, rings in place, digests and the drift
  meter on): the first call returns nothing; every signal a call returns
  carries the PREVIOUS tick's ``tick_ms``; ``emit_ready`` lands and emits
  the in-flight tick at once, so the next call has nothing of it;
  ``flush_pending`` emits the last tick; the whole replay emits the serial
  loop's signal tuples in the same order. Depth 0 returns each tick's
  signals from its own call; depth 2 emits the same set through the copying
  step (``donate`` off) and the double-buffered one (on).
* Depth >= 2 on double-buffered rings: no slot shares a storage with the
  live rings, an in-flight tick's rings or another slot; the overflow
  drill emits the copying set; a cold reset retires the pooled slots; the
  pool keeps at most four; under light load (a flush after every tick) the
  parked slots are reused, one slot allocated in all; a failed dispatch
  drops its slot and keeps the live state.
* The overflow drill (``generate_burst_replay``: a market-wide crash fires
  MeanReversionFade on more rows than the wire's 128 compaction slots): at
  depth 1 with rings in place the fallback re-evaluates from the post-tick
  rings and emits the copying serial loop's signals exactly.
* Failure: an exception after the tick's first in-place write resets the
  engine cold (it then recovers through a cold-start tick); one before any
  write leaves the state intact.

The step-level equality of the in-place step and its fallback with the
copying step is in ``tests/test_torch_step.py`` and
``tests/test_torch_incremental_step.py``.
"""

from __future__ import annotations

import asyncio

import pytest
import torch

from binquant_tpu_torch.engine import buffer as tbuf
from binquant_tpu_torch.engine import step as tstep
from binquant_tpu_torch.io import replay as treplay

# small shapes: extra intra-op threads only spin and crowd parallel test workers
torch.set_num_threads(1)

CAP, WIN = 16, 130
# the serial loop (depth 0) with copied rings and no digests or meter
SERIAL = dict(pipeline_depth=0, donate=False, numeric_digest=False, ingest_digest=False,
              drift_meter=False)


@pytest.fixture(scope="module")
def seq(tmp_path_factory):
    path = tmp_path_factory.mktemp("torch_pipelined") / "rp.jsonl"
    # 104 ticks: past the strategies' 100-bar floor, with signals on many
    # ticks and the crafted setups on the last
    treplay.generate_replay_file(path, n_symbols=8, n_ticks=104)
    return treplay.tick_seq(path)


def _drive(engine, seq, emit_ready_at: int | None = None) -> dict:
    """Per call: the signals it returned; ``emit_ready`` right after the
    call of tick ``emit_ready_at``; the flush at the end."""
    out = {"returned": [], "early": None, "tail": None}

    async def go():
        for k, (tick_ms, klines) in enumerate(seq):
            for kl in klines:
                engine.ingest(kl)
            out["returned"].append(await engine.process_tick(now_ms=tick_ms))
            if k == emit_ready_at:
                out["early"] = await engine.emit_ready()
                assert not engine._pending
        out["tail"] = await engine.flush_pending()

    asyncio.run(go())
    out["engine"] = engine
    return out


def _tuples(signals) -> list[tuple]:
    return treplay.signal_tuples(signals)


@pytest.fixture(scope="module")
def serial(seq):
    run = _drive(treplay.make_stub_engine(capacity=CAP, window=WIN, device="cpu", **SERIAL), seq)
    return run, [t for r in run["returned"] for t in _tuples(r)]


def test_depth_zero_is_same_tick(seq, serial):
    run, tuples = serial
    for (tick_ms, _), fired in zip(seq, run["returned"]):
        assert all(s.tick_ms == tick_ms for s in fired)
    assert tuples and run["tail"] == [] and not run["engine"]._pending
    assert run["engine"].inplace_ticks == 0


def test_depth1_defers_one_tick_emit_ready_and_flush(seq, serial):
    n = len(seq)
    engine = treplay.make_stub_engine(capacity=CAP, window=WIN, device="cpu")
    assert engine.pipeline_depth == 1 and engine._donation_mode() == "single"
    run = _drive(engine, seq, emit_ready_at=n - 2)
    ms = [t for t, _ in seq]
    returned = run["returned"]
    # the first call cannot emit: its own tick is still in flight
    assert returned[0] == []
    # a call emits the PRIOR tick's signals, stamped with that tick's time
    for k in range(1, n):
        assert all(s.tick_ms == ms[k - 1] for s in returned[k]), k
    # emit_ready landed tick n-2 early: its signals, and none left for the
    # next call to emit
    assert run["early"] and all(s.tick_ms == ms[n - 2] for s in run["early"])
    assert returned[n - 1] == []
    # the last tick surfaces only through the flush
    assert run["tail"] and all(s.tick_ms == ms[-1] for s in run["tail"])
    assert not engine._pending
    got = [t for r in returned[: n - 1] for t in _tuples(r)]
    got += _tuples(run["early"]) + _tuples(run["tail"])
    assert got == serial[1]
    assert engine.inplace_ticks == n and engine.state_resets == 0


def test_depth2_runs_the_copying_step_and_emits_the_serial_set(seq, serial):
    """Depth 2 without ``donate`` runs the copying step; with it (the
    default) the double-buffered step: every tick writes a recycled ring
    slot, one slot is allocated on the first tick and none after. Both emit
    the serial set, two ticks late."""
    for donate, mode in ((False, None), (True, "double")):
        engine = treplay.make_stub_engine(capacity=CAP, window=WIN, device="cpu",
                                          pipeline_depth=2, donate=donate)
        assert engine._donation_mode() == mode
        run = _drive(engine, seq)
        assert run["returned"][0] == [] and run["returned"][1] == []
        got = {t for r in run["returned"] for t in _tuples(r)} | set(_tuples(run["tail"]))
        assert got == set(serial[1])
        assert engine.inplace_ticks == (len(seq) if donate else 0)
        assert engine.fresh_slots == (1 if donate else 0) and engine.state_resets == 0


BURST_SYMBOLS = 130
BURST_KW = dict(capacity=136, window=110, device="cpu")


@pytest.fixture(scope="module")
def burst(tmp_path_factory):
    """The overflow drill's replay and the copying serial loop's run of it."""
    assert BURST_SYMBOLS > tstep.WIRE_MAX_FIRED
    path = tmp_path_factory.mktemp("torch_burst") / "burst.jsonl"
    treplay.generate_burst_replay(path, n_symbols=BURST_SYMBOLS, n_ticks=108)
    copying: list = []
    cstats = treplay.run_replay(path, collect=copying, **BURST_KW, **SERIAL)
    return path, copying, cstats


def test_overflow_fallback_in_place_emits_the_copying_set(burst):
    path, copying, cstats = burst
    n_symbols, kw = BURST_SYMBOLS, BURST_KW
    inplace: list = []
    istats = treplay.run_replay(path, collect=inplace, **kw)
    assert cstats["overflow_ticks"] == istats["overflow_ticks"] == 1
    assert istats["inplace_ticks"] == 108 and istats["state_resets"] == 0
    assert len(copying) >= n_symbols  # the crash fired on every row
    assert inplace == copying


def _warm(engine, seq, ticks: int) -> None:
    async def go():
        for tick_ms, klines in seq[:ticks]:
            for kl in klines:
                engine.ingest(kl)
            await engine.process_tick(now_ms=tick_ms)

    asyncio.run(go())


def _tick(engine, seq, k: int):
    tick_ms, klines = seq[k]
    for kl in klines:
        engine.ingest(kl)
    return asyncio.run(engine.process_tick(now_ms=tick_ms))


def test_failure_after_an_inplace_write_resets_cold(seq, monkeypatch):
    engine = treplay.make_stub_engine(capacity=CAP, window=WIN, device="cpu")
    _warm(engine, seq, 3)
    planes = [engine.state.buf5.values, engine.state.buf15.times]
    versions = [p._version for p in planes]

    def device_fault(*args, **kwargs):
        raise RuntimeError("device fault after the scatter")

    # the step has scattered the tick into the rings when the context fails
    monkeypatch.setattr(tstep, "compute_market_context", device_fault)
    with pytest.raises(RuntimeError, match="device fault"):
        _tick(engine, seq, 3)
    assert any(p._version != v for p, v in zip(planes, versions))
    assert engine.state_resets == 1
    assert int(engine.state.buf5.filled.max()) == 0 and int(engine.state.buf15.filled.max()) == 0
    assert engine._carry_desync_reason == "cold_start"
    assert all((latest == -1).all() for latest in engine._host_latest.values())
    monkeypatch.undo()
    _tick(engine, seq, 4)  # recovers through a cold start
    assert engine.last_path == "cold_start" and int(engine.state.buf15.filled.max()) == 1


def test_failure_before_any_inplace_write_keeps_the_state(seq, monkeypatch):
    engine = treplay.make_stub_engine(capacity=CAP, window=WIN, device="cpu")
    _warm(engine, seq, 3)
    st = engine.state
    planes = [st.buf5.times, st.buf5.values, st.buf15.times, st.buf15.values]
    versions = [p._version for p in planes]

    def host_fault(*args, **kwargs):
        raise RuntimeError("host fault before the scatter")

    # the first fold's routing fails: nothing was written
    monkeypatch.setattr(tbuf, "route_updates", host_fault)
    with pytest.raises(RuntimeError, match="host fault"):
        _tick(engine, seq, 3)
    assert engine.state is st and engine.state_resets == 0
    assert [p._version for p in planes] == versions
    assert int(st.buf15.filled.max()) == 3


# -- depth >= 2: the double-buffered rotation ---------------------------------------


def _storages(slot) -> set[int]:
    return tstep.slot_storages(slot)


def test_depth2_slots_never_alias_the_live_or_in_flight_rings(seq):
    """After every call at depth 2 the live rings, each in-flight tick's
    post rings and every pooled slot use storages of their own (checked by
    ``data_ptr`` of each plane's storage); the fallback of each in-flight
    tick holds its own post rings, not the live ones."""
    engine = treplay.make_stub_engine(capacity=CAP, window=WIN, device="cpu", pipeline_depth=2)

    async def go():
        for tick_ms, klines in seq[:40]:
            for kl in klines:
                engine.ingest(kl)
            await engine.process_tick(now_ms=tick_ms)
            live = _storages(tstep.ring_slot_of(engine.state))
            assert len(live) == 4
            # the newest in-flight tick's post rings ARE the live rings
            *older, newest = engine._pending
            assert _storages(newest.spare[0]) == live
            groups = [live] + [_storages(p.spare[0]) for p in older]
            groups += [_storages(s) for s in engine._spare_slots]
            flat = [ptr for g in groups for ptr in g]
            assert len(flat) == len(set(flat))
            assert len(engine._spare_slots) <= engine._spare_slots_max
        await engine.flush_pending()

    asyncio.run(go())
    assert engine.fresh_slots == 1 and engine.inplace_ticks == 40


def test_depth2_overflow_fallback_emits_the_copying_set(burst):
    """A >128-fire crash at depth 2 overflows the wire: the fallback of the
    in-flight crash tick re-evaluates from its own post rings (a later tick
    has replaced the live state by then) and emits the copying serial
    loop's set."""
    path, copying, cstats = burst
    double: list = []
    dstats = treplay.run_replay(path, collect=double, pipeline_depth=2, **BURST_KW)
    assert cstats["overflow_ticks"] == dstats["overflow_ticks"] == 1
    assert dstats["inplace_ticks"] == 108 and dstats["state_resets"] == 0
    assert len(copying) >= BURST_SYMBOLS
    assert sorted(double) == sorted(copying)


def test_cold_reset_invalidates_pooled_slots(seq, monkeypatch):
    """A cold reset retires the lineage: the pool and the parking slot
    empty, the generation moves on, and the in-flight ticks of the old
    lineage pool nothing when they finalize."""
    engine = treplay.make_stub_engine(capacity=CAP, window=WIN, device="cpu", pipeline_depth=2)
    _warm(engine, seq, 6)
    asyncio.run(engine.emit_ready())  # the oldest tick's post rings: pooled
    assert len(engine._spare_slots) == 1 and len(engine._pending) == 1
    gen = engine._state_generation
    engine.recover_if_state_poisoned()  # a healthy state: nothing happens
    assert engine._state_generation == gen
    monkeypatch.setattr(torch.Tensor, "cpu", lambda self: (_ for _ in ()).throw(RuntimeError()))
    engine.recover_if_state_poisoned()
    monkeypatch.undo()
    assert engine.state_resets == 1 and engine._state_generation == gen + 1
    assert engine._spare_slots == [] and engine._deferred_spare is None
    asyncio.run(engine.flush_pending())
    # the finalized tick was of the old lineage: nothing pooled or parked
    assert engine._spare_slots == [] and engine._deferred_spare is None
    fresh = engine.fresh_slots
    _tick(engine, seq, 6)
    assert engine.last_path == "cold_start" and engine.fresh_slots == fresh + 1


def test_the_pool_never_exceeds_four(seq):
    """A deep pipeline's flush finalizes many ticks at once; the pool keeps
    at most four slots (the rest are freed), as the reference's does."""
    engine = treplay.make_stub_engine(capacity=CAP, window=WIN, device="cpu", pipeline_depth=7)
    _warm(engine, seq, 12)
    assert len(engine._pending) == 7
    pooled: list = []
    pool = engine._pool_slot

    def spy(slot):
        pooled.append(slot)
        pool(slot)

    engine._pool_slot = spy
    asyncio.run(engine.flush_pending())
    # six of the seven post states are free at the flush, the last is live
    assert len(pooled) == 6 and len(engine._spare_slots) == 4
    assert engine._deferred_spare is not None


def test_light_load_reuses_parked_slots(seq):
    """A flush after every tick (light load: each tick finalizes before the
    next dispatch) parks the finalized post rings, which are still the live
    ones; the next dispatch pools them and a later one takes them back, so
    only the first tick allocates a slot."""
    engine = treplay.make_stub_engine(capacity=CAP, window=WIN, device="cpu", pipeline_depth=2)
    taken: list = []
    take = engine._take_slot

    def spy(live):
        slot = take(live)
        taken.append(_storages(slot))
        return slot

    engine._take_slot = spy
    parked: list = []

    async def go():
        for tick_ms, klines in seq[:12]:
            for kl in klines:
                engine.ingest(kl)
            await engine.process_tick(now_ms=tick_ms)
            await engine.flush_pending()
            assert engine._deferred_spare is not None
            parked.append(_storages(engine._deferred_spare[0]))

    asyncio.run(go())
    assert engine.fresh_slots == 1
    # from the third tick on, each tick writes the rings parked two ticks ago
    for k in range(2, 12):
        assert taken[k] == parked[k - 2], k


def test_double_failure_drops_the_slot_and_keeps_the_state(seq, monkeypatch):
    """A dispatch that raises after writing its slot drops the slot and
    keeps the live state, unwritten; no reset is counted and the next tick
    runs on."""
    engine = treplay.make_stub_engine(capacity=CAP, window=WIN, device="cpu", pipeline_depth=2)
    _warm(engine, seq, 4)
    live = engine.state
    planes = list(tstep.ring_slot_of(live))
    versions = [p._version for p in planes]
    before = [p.clone() for p in planes]
    taken: list = []
    take = engine._take_slot

    def spy(live_):
        slot = take(live_)
        taken.append(slot)
        return slot

    engine._take_slot = spy

    def device_fault(*args, **kwargs):
        raise RuntimeError("device fault after the scatter")

    # the step has scattered the tick into the slot when the context fails
    monkeypatch.setattr(tstep, "compute_market_context", device_fault)
    with pytest.raises(RuntimeError, match="device fault"):
        _tick(engine, seq, 4)
    monkeypatch.undo()
    assert engine.state is live and engine.state_resets == 0
    assert [p._version for p in planes] == versions
    for a, b in zip(before, planes):
        assert torch.equal(torch.nan_to_num(a.float(), nan=-1.0),
                           torch.nan_to_num(b.float(), nan=-1.0))
    # the slot was written (copied into, then scattered) and is not pooled
    slot_versions = [p._version for p in taken[0]]
    assert all(v > 0 for v in slot_versions)
    dropped = _storages(taken[0])
    assert all(not dropped & _storages(s) for s in engine._spare_slots)
    _tick(engine, seq, 5)
    assert engine.inplace_ticks == 5 and not _storages(taken[1]) & dropped
