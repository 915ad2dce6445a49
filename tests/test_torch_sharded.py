"""The symbol-axis partitioning and the sharded archives, against the
reference package, on the CPU.

* ``shard_bounds`` / ``shard_of_row`` equal the reference's over a grid of
  capacities and shard counts, the ValueError included.
* Checkpoints of 1, 2 and 4 shards cross between the packages both ways:
  each package's archive set holds the other's arrays (the nonce aside),
  and each loader restores the other's set with every leaf bit-equal, the
  registry and the host carries equal.
* A torn or partial roster (a missing sibling, a sibling of an older save,
  a sibling whose roster disagrees, a manifest at a new count whose
  sibling is gone beside an older count's) starts cold in both packages.
* A port engine saved at 4 shards and restored by an unsharded one runs
  the identical next tick (wire bit for bit); ``shard_count_for`` equals
  the reference's.
* ``ShardedBroadcastOutbox`` partitions written by one package read by the
  other: the merged seq order, cursor resolution, replays, the retired
  partitions of an earlier count and a single-file log folded in, the
  plane's routing by the firing row's shard.
* Fan-out snapshots of 4 shards both ways, and the odd-count fallback.
* ``mesh_devices``: fewer cards than asked warns and runs unsharded, that
  many raises.
"""

from __future__ import annotations

import asyncio
import json
import logging
import shutil
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from binquant_tpu.engine import buffer as jbuf
from binquant_tpu.engine import step as jstep
from binquant_tpu.fanout import hub as jh
from binquant_tpu.fanout import plane as jp
from binquant_tpu.fanout import registry as jr
from binquant_tpu.io import checkpoint as jckpt
from binquant_tpu.parallel import mesh as jmesh
from binquant_tpu_torch.engine import step as tstep
from binquant_tpu_torch.fanout import hub as th
from binquant_tpu_torch.fanout import plane as tp
from binquant_tpu_torch.fanout import registry as tr
from binquant_tpu_torch.io import checkpoint as tckpt
from binquant_tpu_torch.io import replay as treplay
from binquant_tpu_torch.parallel import mesh as tmesh
from tests.test_torch_fanout import PLANES, _populate, _Rows

torch.set_num_threads(1)

CAP, WIN = 16, 130
SERIAL = dict(pipeline_depth=0, donate=False, numeric_digest=False, ingest_digest=False,
              drift_meter=False, outcomes=False)


def _port(**kw):
    return treplay.make_stub_engine(capacity=CAP, window=WIN, device="cpu",
                                    carry_audit_every=48, fanout=False, **kw)


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


@pytest.fixture(scope="module")
def seq(tmp_path_factory):
    path = tmp_path_factory.mktemp("tsharded") / "replay.jsonl"
    treplay.generate_replay_file(path, n_symbols=8, n_ticks=112, seed=7)
    return treplay.tick_seq(path)


@pytest.fixture(scope="module")
def donor(seq):
    """A port engine driven through all but the last tick (flushed)."""
    engine = _port(**SERIAL, incremental=True)
    _drive(engine, seq[:-1])
    return engine


def _port_leaves(state) -> list[np.ndarray]:
    return [t.numpy() for t in tckpt._archive_leaves(tstep.canonicalize_state(state))]


def _ref_leaves(state) -> list[np.ndarray]:
    return [np.asarray(x) for x in jckpt._archive_leaves(jstep.canonicalize_state(state))]


def _equal_leaves(a: list, b: list) -> None:
    assert len(a) == len(b)
    for i, (x, y) in enumerate(zip(a, b)):
        assert x.shape == y.shape and x.dtype == y.dtype, i
        assert np.array_equal(x, y, equal_nan=x.dtype.kind == "f"), i


def _ref_template():
    return jstep.initial_engine_state(CAP, window=WIN), jbuf.SymbolRegistry(CAP)


def _ref_state_of(donor, tmp_path):
    """The donor's state as a reference state (through a monolithic
    archive and the reference's own loader)."""
    mono = tmp_path / "mono.ckpt.npz"
    tckpt.save_state(mono, donor.state, donor.registry, host_carries=donor.host_carries())
    state, reg = _ref_template()
    state, carries = jckpt.load_state(mono, state, reg)
    return state, reg, carries


def _archive_files(path) -> dict:
    """Every file of an archive set: {name: (arrays, meta without nonce)}."""
    out = {}
    for f in sorted(path.parent.glob(path.name + "*")):
        with np.load(f) as data:
            arrays = {k: data[k] for k in data.files if k != "__meta"}
            meta = json.loads(bytes(data["__meta"].tobytes()).decode())
        meta.pop("nonce", None)
        meta.get("host_carries", {}).pop("saved_at_s", None)
        out[f.name.replace(path.name, "")] = (arrays, meta)
    return out


# -- the partitioning ------------------------------------------------------------


@pytest.mark.parametrize("capacity", [8, 12, 16, 2048])
@pytest.mark.parametrize("n", [1, 2, 3, 4, 8])
def test_shard_bounds_and_shard_of_row_equal_the_reference(capacity, n):
    try:
        want = jmesh.shard_bounds(capacity, n)
    except ValueError as exc:
        with pytest.raises(ValueError, match="not divisible"):
            tmesh.shard_bounds(capacity, n)
        assert "not divisible" in str(exc)
        return
    assert tmesh.shard_bounds(capacity, n) == want
    rows = range(capacity) if capacity <= 16 else range(0, capacity, 7)
    assert [tmesh.shard_of_row(r, capacity, n) for r in rows] == [
        jmesh.shard_of_row(r, capacity, n) for r in rows]
    for bad in (-1, capacity):
        with pytest.raises(ValueError, match="outside capacity"):
            tmesh.shard_of_row(bad, capacity, n)
        with pytest.raises(ValueError, match="outside capacity"):
            jmesh.shard_of_row(bad, capacity, n)


# -- checkpoints -------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 2, 4])
def test_checkpoints_cross_between_the_packages(donor, tmp_path, n):
    jstate, jreg, _ = _ref_state_of(donor, tmp_path)
    carries = donor.host_carries()
    pdir, rdir = tmp_path / "port", tmp_path / "ref"
    pdir.mkdir(), rdir.mkdir()
    tckpt.save_state_sharded(pdir / "e.npz", donor.state, donor.registry, n, host_carries=carries)
    jckpt.save_state_sharded(rdir / "e.npz", jstate, jreg, n, host_carries=carries)
    # the two sets hold the same files, arrays and metadata
    pf, rf = _archive_files(pdir / "e.npz"), _archive_files(rdir / "e.npz")
    assert list(pf) == list(rf) and len(pf) == n
    for name in pf:
        (pa, pm), (ra, rm) = pf[name], rf[name]
        assert pm == rm, name
        assert set(pa) == set(ra), name
        for k in pa:
            assert pa[k].dtype == ra[k].dtype and np.array_equal(
                pa[k], ra[k], equal_nan=pa[k].dtype.kind == "f"), (name, k)
    # the port's set into the reference, the reference's into the port
    state, reg = _ref_template()
    state, rcarries = jckpt.load_state(pdir / "e.npz", state, reg)
    _equal_leaves(_ref_leaves(state), _port_leaves(donor.state))
    assert reg.to_mapping() == donor.registry.to_mapping()
    engine = _port(**SERIAL, incremental=True)
    tstate, tcarries = tckpt.load_state(rdir / "e.npz", engine.state, engine.registry)
    _equal_leaves(_port_leaves(tstate), _port_leaves(donor.state))
    assert engine.registry.to_mapping() == donor.registry.to_mapping()
    assert json.loads(json.dumps(carries)) == rcarries == tcarries


def _tear(path, fault: str, writer) -> None:
    """Make the archive set at ``path`` (written at 4 shards) torn."""
    sib = path.with_name(path.name + ".shard2-of-4")
    if fault == "missing_sibling":
        sib.unlink()
    elif fault == "older_sibling":
        keep = path.parent / "keep"
        keep.mkdir()
        shutil.copy(sib, keep / sib.name)
        writer(path, 4)  # a newer save; then its sibling is replaced by the older one
        shutil.copy(keep / sib.name, sib)
    elif fault == "roster":
        with np.load(sib) as data:
            arrays = {k: data[k] for k in data.files if k != "__meta"}
            meta = json.loads(bytes(data["__meta"].tobytes()).decode())
        meta["shard_index"] = 3
        tckpt.atomic_savez(sib, arrays, meta)
    elif fault == "stale_count":
        writer(path, 2)  # the manifest moves to 2 shards beside the 4-shard siblings
        path.with_name(path.name + ".shard1-of-2").unlink()


@pytest.mark.parametrize("writer_pkg", ["port", "reference"])
@pytest.mark.parametrize("fault", ["missing_sibling", "older_sibling", "roster", "stale_count"])
def test_torn_rosters_start_cold_in_both_packages(donor, tmp_path, writer_pkg, fault, caplog):
    jstate, jreg, _ = _ref_state_of(donor, tmp_path)
    if writer_pkg == "port":
        def writer(path, n):
            tckpt.save_state_sharded(path, donor.state, donor.registry, n)
    else:
        def writer(path, n):
            jckpt.save_state_sharded(path, jstate, jreg, n)
    path = tmp_path / "e.npz"
    writer(path, 4)
    _tear(path, fault, writer)
    state, reg = _ref_template()
    with pytest.raises(ValueError):
        jckpt.load_state(path, state, reg)
    engine = _port(**SERIAL)
    with pytest.raises(ValueError):
        tckpt.load_state(path, engine.state, engine.registry)
    assert not tckpt.CheckpointManager(path).try_restore(engine)
    assert engine.ticks_processed == 0 and len(engine.registry.to_mapping()) == 0


def test_saved_at_4_restored_at_1_runs_the_identical_next_tick(seq, tmp_path):
    a = _port(**SERIAL, incremental=True)
    _drive(a, seq[:-1])
    a.config.ckpt_shards = 4
    path = tmp_path / "e.npz"
    mgr = tckpt.CheckpointManager(path, every_ticks=1)
    assert mgr.shard_count_for(a) == 4 and mgr.maybe_save(a)
    assert sorted(p.name for p in tmp_path.glob("e.npz*")) == [
        "e.npz", "e.npz.shard1-of-4", "e.npz.shard2-of-4", "e.npz.shard3-of-4"]
    b = _port(**SERIAL, incremental=True)
    assert tckpt.CheckpointManager(path).shard_count_for(b) == 1
    assert tckpt.CheckpointManager(path).try_restore(b)
    assert b._carry_desync_reason is None and b.ticks_processed == a.ticks_processed
    fa, fb = _drive(a, seq[-1:]), _drive(b, seq[-1:])
    assert fa == fb and len(fa) > 0
    assert a.last_path == b.last_path == "incremental"
    assert np.array_equal(a.last_wire, b.last_wire, equal_nan=True)
    _equal_leaves(_port_leaves(a.state), _port_leaves(b.state))


@pytest.mark.parametrize("ckpt_shards", [0, 1, 2, 4])
def test_shard_count_for_equals_the_reference(ckpt_shards):
    engine = SimpleNamespace(config=SimpleNamespace(ckpt_shards=ckpt_shards), mesh=None)
    assert tckpt.CheckpointManager.shard_count_for(engine) == (
        jckpt.CheckpointManager.shard_count_for(engine))


# -- the fan-out outbox --------------------------------------------------------------


def _frames(first: int, count: int, seed: int) -> list[tuple[dict, np.ndarray]]:
    rng = np.random.default_rng(seed)
    out = []
    for seq_no in range(first, first + count):
        row = int(rng.integers(0, CAP))
        frame = {"seq": seq_no, "row": row, "symbol": f"S{row:03d}USDT",
                 "trace_id": f"t{seq_no // 3}", "tick_seq": seq_no // 3}
        out.append((frame, rng.integers(0, 2**32, 3, dtype=np.uint64).astype(np.uint32)))
    return out


def _route(mod_mesh, n):
    return lambda frame: mod_mesh.shard_of_row(int(frame["row"]), CAP, n)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_sharded_outbox_crosses_between_the_packages(tmp_path, writer):
    (W, wmesh), (R, rmesh) = ((th, tmesh), (jh, jmesh)) if writer == "port" else (
        (jh, jmesh), (th, tmesh))
    path = tmp_path / "fan.jsonl"
    # an earlier deployment: a single-file outbox, then 2 partitions
    legacy = W.BroadcastOutbox(path)
    for frame, words in _frames(0, 5, 1):
        legacy.append(frame, words)
    legacy.close()
    two = W.ShardedBroadcastOutbox(path, 2, cap=64, shard_of=_route(wmesh, 2))
    assert two.last_seq() == 4
    for frame, words in _frames(5, 5, 2):
        two.append(frame, words)
    two.close()
    # now 4 partitions, each rotating at 6 lines
    out = W.ShardedBroadcastOutbox(path, 4, cap=6, shard_of=_route(wmesh, 4))
    assert out.last_seq() == 9
    fresh = _frames(10, 30, 3)
    for frame, words in fresh:
        out.append(frame, words)
    assert out.appends == 30 and out.rotations >= 1
    for k in range(4):  # each frame in its row's partition (live or rotated)
        part = out._parts[k]
        for frame, _ in part.entries():
            assert wmesh.shard_of_row(frame["row"], CAP, 4) == k
    reader = R.ShardedBroadcastOutbox(path, 4, cap=6, shard_of=_route(rmesh, 4))
    got, want = reader.entries(), out.entries()
    assert [f for f, _ in got] == [f for f, _ in want]
    assert [f["seq"] for f, _ in got] == list(range(40))
    for (_, a), (_, b) in zip(got, want):
        assert np.array_equal(a, b)
    assert reader.last_seq() == out.last_seq() == 39
    for cursor in ("7", "t4/4", "t12/12", "nope/1", "x", ""):
        assert reader.resolve_cursor(cursor) == out.resolve_cursor(cursor), cursor
    for seq_no in (-1, 3, 9, 25):
        for slot in (0, 5, 31, 40, 95):
            assert reader.replay_after(seq_no, slot) == out.replay_after(seq_no, slot)
    out.close()
    reader.close()


def test_the_plane_routes_frames_by_the_firing_rows_shard(tmp_path):
    rows = {f"S{r:03d}USDT": r for r in range(CAP)}
    j = jp.FanoutPlane(_Rows(rows, capacity=CAP), capacity=64, outbox_shards=4,
                       outbox_path=str(tmp_path / "j" / "fan.jsonl"))
    t = tp.FanoutPlane(_Rows(rows, capacity=CAP), capacity=64, outbox_shards=4,
                       outbox_path=str(tmp_path / "t" / "fan.jsonl"), device="cpu")
    assert j.outbox_shards == t.outbox_shards == 4
    frames = _frames(0, 24, 5)
    frames.append(({"seq": 24, "symbol": "NOROW"}, frames[0][1]))  # no row: hashed
    for plane in (j, t):
        for frame, words in frames:
            plane.outbox.append(frame, words)
        plane.outbox.close()
    for k in range(4):
        name = f"fan.jsonl.p{k}-of-4"
        assert (tmp_path / "j" / name).read_text() == (tmp_path / "t" / name).read_text(), k


# -- the fan-out snapshots -----------------------------------------------------------


@pytest.mark.parametrize("donor_pkg", ["port", "reference"])
def test_sharded_snapshots_cross_between_the_packages(tmp_path, donor_pkg):
    rows_map = {"BTCUSDT": 0, "ETHUSDT": 1, "XRPUSDT": 2, "ADAUSDT": 3}
    if donor_pkg == "port":
        donor = tp.FanoutPlane(_Rows(rows_map), capacity=64, device="cpu",
                               snapshot_path=str(tmp_path / "s.npz"), snapshot_shards=4)
        _populate(donor, tr)
        warm = jp.FanoutPlane(_Rows(rows_map), capacity=64)
        twin = jp.FanoutPlane(_Rows(rows_map), capacity=64, snapshot_path=str(tmp_path / "r.npz"))
        _populate(twin, jr)
    else:
        donor = jp.FanoutPlane(_Rows(rows_map), capacity=64,
                               snapshot_path=str(tmp_path / "s.npz"), snapshot_shards=4)
        _populate(donor, jr)
        warm = tp.FanoutPlane(_Rows(rows_map), capacity=64, device="cpu")
        twin = tp.FanoutPlane(_Rows(rows_map), capacity=64, device="cpu",
                              snapshot_path=str(tmp_path / "r.npz"))
        _populate(twin, tr)
    assert donor.maybe_save_snapshot(default_shards=1)  # snapshot_shards wins
    twin.save_snapshot(n_shards=4)
    names = sorted(p.name for p in tmp_path.glob("s.npz*"))
    assert names == ["s.npz", "s.npz.shard1-of-4", "s.npz.shard2-of-4", "s.npz.shard3-of-4"]
    # both packages' sets hold the same arrays
    a, b = _archive_files(tmp_path / "s.npz"), _archive_files(tmp_path / "r.npz")
    assert list(a) == list(b)
    for name in a:
        for k in a[name][0]:
            assert np.array_equal(a[name][0][k], b[name][0][k]), (name, k)
        ma, mb = dict(a[name][1]), dict(b[name][1])
        ma.pop("saved_unix", None), mb.pop("saved_unix", None)
        assert ma == mb, name
    assert warm.try_restore_snapshot(donor.snapshot_path)
    for name in PLANES:
        assert np.array_equal(getattr(warm.subscriptions, name),
                              getattr(donor.subscriptions, name)), name
    assert warm._slot_min_seq == donor._slot_min_seq and warm.seq == donor.seq
    assert len(warm.subscriptions) == len(donor.subscriptions) == 31


@pytest.mark.parametrize("plane_mod", [tp, jp])
def test_an_odd_snapshot_shard_count_saves_one_archive(tmp_path, plane_mod):
    kw = {"device": "cpu"} if plane_mod is tp else {}
    plane = plane_mod.FanoutPlane(_Rows({"BTCUSDT": 0}), capacity=64,
                                  snapshot_path=str(tmp_path / "s.npz"), snapshot_shards=3, **kw)
    assert plane.maybe_save_snapshot()
    assert [p.name for p in tmp_path.glob("s.npz*")] == ["s.npz"]


# -- the mesh setting ----------------------------------------------------------------


def test_mesh_devices_warns_without_the_cards_and_raises_with_them(monkeypatch, caplog):
    """The reference's rules for ``mesh_devices`` (``resolve_mesh``): fewer
    visible cards than asked warns and runs unsharded, so does a capacity
    the count does not divide; that many cards shards over them, and a CPU
    engine shards over that many CPU shards. (Named from when that many
    cards raised, before the multi-card tick was ported.)"""
    with caplog.at_level(logging.WARNING):
        engine = treplay.make_stub_engine(capacity=CAP, window=WIN, device="cpu",
                                          fanout=False, **SERIAL)
        assert engine.mesh is None
        assert tmesh.resolve_mesh(4, CAP, "cuda") is None
    assert "only 0 device(s) visible; running single-chip" in caplog.text
    assert engine.health_snapshot()["mesh"] == {"enabled": False}
    caplog.clear()
    with caplog.at_level(logging.WARNING):
        assert tmesh.resolve_mesh(4, 18, "cpu") is None  # a capacity 4 does not divide
    assert "capacity 18 not divisible by mesh size 4; running single-chip" in caplog.text
    assert tmesh.resolve_mesh(1, CAP) is None and tmesh.resolve_mesh(0, CAP) is None
    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "device_count", lambda: 4)
        mesh = tmesh.resolve_mesh(4, CAP, "cuda")
    assert mesh.devices == tuple(torch.device(f"cuda:{k}") for k in range(4))
    monkeypatch.setenv("BQT_MESH_DEVICES", "4")
    engine = treplay.make_stub_engine(capacity=CAP, window=WIN, device="cpu", fanout=False)
    assert engine.mesh.devices == (torch.device("cpu"),) * 4
    assert isinstance(engine.state, tmesh.ShardedState)
    assert [s.buf15.times.shape[0] for s in engine.state.shards] == [CAP // 4] * 4
    assert engine.health_snapshot()["mesh"]["devices"] == 4
