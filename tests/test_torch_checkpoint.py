"""Checkpoint and restore: the port's own round trip, and archives crossing
between the packages.

* The archive's leaf sequence: the port's ``_archive_leaves`` against the
  reference's (``jax.tree_util.tree_leaves`` of the cursor-stripped
  state), leaf by leaf — count, shape and dtype — on an initial state and
  on a driven one.
* Kill and restore in the port (``tests/test_checkpoint.py:69``'s drill):
  engine A runs all but the last tick of a 112-tick replay and saves; B
  boots cold and restores; both run the last tick. The restored state,
  the registry and the host carries equal A's, and the next tick's fired
  tuples and state equal A's. At depth 0 with copied rings, and in the
  production loop (depth 1, rings in place, both digests, the drift meter,
  outcomes), whose A finalizes what is in flight before the save, as the
  consume loop does.
* Across packages, on the incremental path at depth 0 without digests: a
  reference-written archive restores into the port, and a port-written
  one restores through the reference's own ``load_state``; in both
  directions the next tick's fired tuples are equal and its wire is within
  the wire contract (fired block exact, floats ``1e-5`` of scale).
* A classic engine's archive (no carry kept) restored into an incremental
  engine: the first tick recomputes in full, the next is incremental.
* Migrations and refusals: a v3 archive (zero cursors re-attached,
  identical next tick); a v2 archive (carry suffix dropped: the template's
  empty carry, ``_carry_rebuilt``, a ``cold_start`` first tick); a
  capacity change and a sharded manifest whose sibling is missing start
  cold, a whole sharded set restores (the cross-package sharded archives
  are in ``tests/test_torch_sharded.py``).
* The open outcome registry survives a restart mid-horizon
  (``tests/test_outcomes.py:276``): the restored drive matures the set of
  the uninterrupted one, which equals the reference's.
"""

from __future__ import annotations

import asyncio
import json

import jax
import numpy as np
import pytest
import torch

from binquant_tpu.engine import step as jstep
from binquant_tpu.io import checkpoint as jckpt
from binquant_tpu.io import pipeline as jpipeline
from binquant_tpu.io import replay as jreplay
from binquant_tpu_torch.engine import step as tstep
from binquant_tpu_torch.io import checkpoint as tckpt
from binquant_tpu_torch.io import replay as treplay

torch.set_num_threads(1)

CAP, WIN = 16, 130
N_SYMBOLS, N_TICKS = 8, 112
SERIAL = dict(pipeline_depth=0, donate=False, numeric_digest=False, ingest_digest=False,
              drift_meter=False, outcomes=False)
PRODUCTION: dict = {}  # the config's defaults: depth 1 in place, digests, meter, outcomes


@pytest.fixture(scope="module")
def seq(tmp_path_factory):
    path = tmp_path_factory.mktemp("tckpt") / "replay.jsonl"
    treplay.generate_replay_file(path, n_symbols=N_SYMBOLS, n_ticks=N_TICKS, seed=7)
    return treplay.tick_seq(path)


def _port(**kw):
    return treplay.make_stub_engine(capacity=CAP, window=WIN, device="cpu",
                                    carry_audit_every=48, fanout=False, **kw)


def _drive(engine, ticks, flush: bool = True) -> list:
    async def go():
        out = []
        for now_ms, klines in ticks:
            for k in klines:
                engine.ingest(k)
            out.extend(treplay.signal_tuples(await engine.process_tick(now_ms=now_ms)))
        if flush:
            out.extend(treplay.signal_tuples(await engine.flush_pending()))
        return out

    return asyncio.run(go())


def _canonical_leaves(state) -> list[np.ndarray]:
    return [t.numpy() for t in tckpt._archive_leaves(tstep.canonicalize_state(state))]


def _assert_leaves_equal(a: list, b: list) -> None:
    assert len(a) == len(b)
    for i, (x, y) in enumerate(zip(a, b)):
        assert x.shape == y.shape and x.dtype == y.dtype, i
        assert np.array_equal(x, y, equal_nan=x.dtype.kind == "f"), i


def _carries(engine) -> dict:
    c = engine.host_carries()
    c.pop("saved_at_s")
    # an open outcome's trace id and tick_seq are its engine's own (ids are
    # random per process, the sequence restarts with the engine)
    c["outcomes_open"] = [
        {k: v for k, v in slot.items() if k not in ("trace_id", "tick_seq")}
        for slot in c["outcomes_open"]
    ]
    return c


def test_leaf_sequence_matches_reference(seq):
    jst = jstep.initial_engine_state(CAP, window=WIN)
    tst = tstep.initial_engine_state(CAP, WIN, device="cpu")
    j = [np.asarray(x) for x in jckpt._archive_leaves(jst)]
    t = [x.numpy() for x in tckpt._archive_leaves(tst)]
    assert len(t) == len(j) == len(jax.tree_util.tree_leaves(jst)) - 2  # no cursors
    for i, (a, b) in enumerate(zip(j, t)):
        assert (b.shape, b.dtype) == (a.shape, a.dtype), i
    # and on a driven state, whose int leaves came out of torch ops
    eng = _port(**SERIAL, incremental=True)
    _drive(eng, seq[:4])
    for i, (a, b) in enumerate(zip(j, _canonical_leaves(eng.state))):
        assert (b.shape, b.dtype) == (a.shape, a.dtype), i


@pytest.mark.parametrize("config", ["depth0", "production"])
def test_kill_and_restore_identical_next_tick(seq, tmp_path, config):
    kw = dict(SERIAL) if config == "depth0" else dict(PRODUCTION)
    path = tmp_path / "engine.ckpt.npz"
    a = _port(**kw)
    _drive(a, seq[:-1])  # flushed: the host carries match the state
    mgr = tckpt.CheckpointManager(path, every_ticks=1)
    assert mgr.maybe_save(a) and path.exists()
    assert mgr.last_save_ms is not None

    b = _port(**kw)
    assert tckpt.CheckpointManager(path).try_restore(b)
    assert b.ticks_processed == a.ticks_processed == N_TICKS - 1
    assert b.registry.to_mapping() == a.registry.to_mapping()
    _assert_leaves_equal(_canonical_leaves(a.state), _canonical_leaves(b.state))
    assert _carries(a) == _carries(b)
    if config == "production":
        assert _carries(b)["outcomes_open"]  # signals still maturing
    assert b._carry_desync_reason is None  # the restored carry matches the rings

    fa, fb = _drive(a, seq[-1:]), _drive(b, seq[-1:])
    assert fa == fb and len(fa) > 0
    assert a.last_path == b.last_path == "incremental"
    _assert_leaves_equal(_canonical_leaves(a.state), _canonical_leaves(b.state))
    assert _carries(a) == _carries(b)


def _wire_contract(tw: np.ndarray, jw: np.ndarray) -> None:
    assert tw.dtype == jw.dtype == np.float32 and tw.shape == jw.shape
    off, K = tstep.WIRE_FIRED_COUNT_OFF, tstep.WIRE_MAX_FIRED
    assert tw[off] == jw[off]
    jb = jw[off + 1: off + 1 + 6 * K].reshape(6, K)
    tb = tw[off + 1: off + 1 + 6 * K].reshape(6, K)
    np.testing.assert_array_equal(tb[:4], jb[:4])
    fin = np.isfinite(jw)
    assert np.array_equal(fin, np.isfinite(tw)) and np.array_equal(np.isnan(jw), np.isnan(tw))
    scale = np.maximum(np.abs(jw), 1.0)
    assert np.all(np.abs(tw[fin] - jw[fin]) <= 1e-5 * scale[fin])


@pytest.fixture
def jwires(monkeypatch):
    """The reference engine's wires, as its finalize decodes them."""
    wires: list = []
    unpack = jpipeline.unpack_wire

    def record(wire, *args, **kwargs):
        wires.append(np.asarray(wire))
        return unpack(wire, *args, **kwargs)

    monkeypatch.setattr(jpipeline, "unpack_wire", record)
    return wires


def _jax_engine():
    return jreplay.make_stub_engine(capacity=CAP, window=WIN, incremental=True,
                                    carry_audit_every=48)


@pytest.mark.parametrize("direction", ["reference_to_port", "port_to_reference"])
def test_archives_cross_packages(seq, tmp_path, jwires, direction):
    path = tmp_path / "cross.ckpt.npz"
    if direction == "reference_to_port":
        src = _jax_engine()
        _drive(src, seq[:-1])
        jckpt.save_state(path, src.state, src.registry, host_carries=src.host_carries())
        dst = _port(**SERIAL, incremental=True)
        assert tckpt.CheckpointManager(path).try_restore(dst)
        jeng, teng = src, dst
    else:
        src = _port(**SERIAL, incremental=True)
        _drive(src, seq[:-1])
        tckpt.save_state(path, src.state, src.registry, host_carries=src.host_carries())
        dst = _jax_engine()
        state, carries = jckpt.load_state(path, dst.state, dst.registry)  # the reference's loader
        dst.state = state
        dst.restore_host_carries(carries)
        dst.note_state_restored(migrated=bool(carries.get("_carry_rebuilt", False)))
        jeng, teng = dst, src
    assert jeng.registry.to_mapping() == teng.registry.to_mapping()
    assert jeng.ticks_processed == teng.ticks_processed == N_TICKS - 1
    assert jeng._carry_desync_reason is None and teng._carry_desync_reason is None
    jwires.clear()
    fj, ft = _drive(jeng, seq[-1:]), _drive(teng, seq[-1:])
    assert ft == fj and len(ft) > 0
    _wire_contract(teng.last_wire, jwires[-1])


def test_classic_archive_restores_into_a_full_first_tick(seq, tmp_path):
    """A classic engine keeps no carry: restored into an incremental
    engine, its archive's carry does not match the rings, so the first tick
    recomputes in full (``cold_start``) and the next runs incremental."""
    a = _port(**SERIAL, incremental=False)
    _drive(a, seq[:-2])
    path = tmp_path / "classic.ckpt.npz"
    tckpt.save_state(path, a.state, a.registry, host_carries=a.host_carries())
    b = _port(**SERIAL, incremental=True)
    assert tckpt.CheckpointManager(path).try_restore(b)
    assert b._carry_desync_reason == "cold_start"
    _drive(b, seq[-2:-1])
    assert b.last_path == "cold_start"
    _drive(b, seq[-1:])
    assert b.last_path == "incremental"


def test_v3_archive_migrates(seq, tmp_path):
    a = _port(**SERIAL, incremental=True)
    _drive(a, seq[:-1])
    leaves = tckpt._archive_leaves(tstep.canonicalize_state(a.state))
    meta = {"version": 3, "n_leaves": len(leaves), "registry": a.registry.to_mapping(),
            "host_carries": a.host_carries()}
    path = tmp_path / "v3.ckpt.npz"
    np.savez(path, __meta=np.frombuffer(json.dumps(meta).encode(), np.uint8),
             **{f"leaf_{i}": x.numpy() for i, x in enumerate(leaves)})
    b = _port(**SERIAL, incremental=True)
    assert tckpt.CheckpointManager(path).try_restore(b)
    assert not b.state.buf5.cursor.any() and not b.state.buf15.cursor.any()
    _assert_leaves_equal(_canonical_leaves(a.state), _canonical_leaves(b.state))
    assert _drive(a, seq[-1:]) == _drive(b, seq[-1:])


def test_v2_archive_rebuilds_the_carry(seq, tmp_path):
    a = _port(**SERIAL, incremental=True)
    _drive(a, seq[:-1])
    ic = a.state.indicator_carry
    n_drop = len(tckpt._flatten(ic)) - len(tckpt._flatten((ic.pack5, ic.pack15)))
    leaves = tckpt._archive_leaves(tstep.canonicalize_state(a.state))[:-n_drop]
    meta = {"version": 2, "n_leaves": len(leaves), "registry": a.registry.to_mapping(),
            "host_carries": a.host_carries()}
    path = tmp_path / "v2.ckpt.npz"
    np.savez(path, __meta=np.frombuffer(json.dumps(meta).encode(), np.uint8),
             **{f"leaf_{i}": x.numpy() for i, x in enumerate(leaves)})
    b = _port(**SERIAL, incremental=True)
    empty = tckpt._flatten(b.state.indicator_carry)[-n_drop:]
    state, carries = tckpt.load_state(path, b.state, b.registry)
    assert carries["_carry_rebuilt"] is True
    _assert_leaves_equal([t.numpy() for t in tckpt._flatten(state.indicator_carry)[-n_drop:]],
                         [t.numpy() for t in empty])
    assert tckpt.CheckpointManager(path).try_restore(b)
    assert b._carry_desync_reason == "cold_start"
    assert _drive(a, seq[-1:]) == _drive(b, seq[-1:])
    assert b.last_path == "cold_start"


def test_shape_mismatch_and_sharded_manifest_start_cold(seq, tmp_path, caplog):
    """A capacity change and a sharded manifest whose sibling is missing
    start cold; a whole sharded set restores the saved state."""
    a = _port(**SERIAL)
    _drive(a, seq[:2])
    path = tmp_path / "small.ckpt.npz"
    tckpt.save_state(path, a.state, a.registry, host_carries=a.host_carries())
    c = treplay.make_stub_engine(capacity=CAP * 2, window=WIN, device="cpu", **SERIAL)
    assert not tckpt.CheckpointManager(path).try_restore(c)
    assert c.ticks_processed == 0 and len(c.registry.to_mapping()) == 0
    assert not tckpt.CheckpointManager(tmp_path / "absent.npz").try_restore(c)

    with np.load(path) as data:
        arrays = {k: data[k] for k in data.files}
    meta = json.loads(bytes(arrays.pop("__meta").tobytes()).decode())
    meta.update(shard_count=2, shard_index=0, symbol_leaves=[], nonce="0")
    torn = tmp_path / "torn.ckpt.npz"
    tckpt.atomic_savez(torn, arrays, meta)  # a manifest without its sibling
    d = _port(**SERIAL)
    with pytest.raises(ValueError, match="missing"):
        tckpt.load_state(torn, d.state, d.registry)
    assert not tckpt.CheckpointManager(torn).try_restore(d)
    assert d.ticks_processed == 0 and "missing" in caplog.text

    sharded = tmp_path / "sharded.ckpt.npz"
    tckpt.save_state_sharded(sharded, a.state, a.registry, 2, host_carries=a.host_carries())
    assert (tmp_path / "sharded.ckpt.npz.shard1-of-2").exists()
    with pytest.raises(ValueError, match="non-manifest"):
        tckpt.load_state(tmp_path / "sharded.ckpt.npz.shard1-of-2", d.state, d.registry)
    assert tckpt.CheckpointManager(sharded).try_restore(d)
    assert d.ticks_processed == a.ticks_processed == 2
    assert d.registry.to_mapping() == a.registry.to_mapping()
    _assert_leaves_equal(_canonical_leaves(a.state), _canonical_leaves(d.state))


def test_open_outcome_registry_survives_mid_horizon(tmp_path):
    """The reference's drill: cut after the first fire with horizons
    pending and before the second; the restored engine matures the rest."""
    path = tmp_path / "outcomes.jsonl"
    treplay.generate_outcome_replay(path, n_symbols=8, n_ticks=128, fire_ticks=(104, 110))
    seq = treplay.tick_seq(path)
    kw = dict(capacity=8, window=160, enabled_strategies={"mean_reversion_fade"},
              incremental=True, outcomes=True, outcome_horizons=(1, 4, 16))
    whole = treplay.make_stub_engine(device="cpu", **kw, **{
        k: v for k, v in SERIAL.items() if k != "outcomes"})
    _drive(whole, seq)
    oracle: list = []
    jreplay.run_replay(path, collect_outcomes=oracle, donate=False, **kw)
    assert sorted(whole.outcomes.matured_set()) == oracle

    cut = 107
    a = treplay.make_stub_engine(device="cpu", **kw)  # the production loop
    _drive(a, seq[:cut])
    assert a.outcomes._open
    ckpt = tmp_path / "engine.ckpt.npz"
    tckpt.save_state(ckpt, a.state, a.registry, host_carries=a.host_carries())
    b = treplay.make_stub_engine(device="cpu", **kw)
    assert tckpt.CheckpointManager(ckpt).try_restore(b)
    assert [s["symbol"] for s in b.outcomes.snapshot_open()] == [
        s["symbol"] for s in a.outcomes.snapshot_open()
    ]
    _drive(b, seq[cut:])
    assert b.outcomes.matured_set()
    assert sorted(a.outcomes.matured_set() | b.outcomes.matured_set()) == oracle
