"""The fan-out plane's parts against the reference package, on the CPU.

Seeded numpy inputs go through ``binquant_tpu/fanout`` (JAX on the CPU) and
``binquant_tpu_torch/fanout`` (torch on the CPU); every comparison is
bitwise (tolerance: none): the device pack, the match words at 64 and 96
slots and fired buckets of 4, 8 and 16 (the no-row bucket, the
invalid-regime row, NaN and ±inf scores, ``+inf`` floors), the delta
scatter with its pads, both registries after one churn script (planes,
floors, dirty cells, versions, ``export_columns``), snapshot archives
crossing between the packages both ways and the rejections (the sharded
sets are in ``tests/test_torch_sharded.py``), and the hub
over real 127.0.0.1 sockets (WS and SSE delivery, the slow consumer's
shed, cursor resume from the outbox and the tail ring, outbox rotation).
The 1M-slot match is marked ``slow``.
"""

from __future__ import annotations

import asyncio
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from binquant_tpu.fanout import kernel as jk
from binquant_tpu.fanout import plane as jp
from binquant_tpu.fanout import registry as jr
from binquant_tpu_torch.engine.step import STRATEGY_ORDER
from binquant_tpu_torch.enums import MarketRegimeCode
from binquant_tpu_torch.fanout import hub as th
from binquant_tpu_torch.fanout import kernel as tk
from binquant_tpu_torch.fanout import plane as tp
from binquant_tpu_torch.fanout import registry as tr
from binquant_tpu_torch.fanout import snapshot as ts
from tests.test_fanout import _random_population

# small shapes: extra intra-op threads only spin and crowd parallel test workers
torch.set_num_threads(1)

N_STRAT = len(STRATEGY_ORDER)
R_ROWS = len(MarketRegimeCode) + 1
INVALID = len(MarketRegimeCode)
PLANES = ("sym_plane", "strat_plane", "regime_plane", "any_masks", "floors")


def _port_sub(sub) -> tr.Subscription:
    return tr.Subscription(
        sub.user_id, symbols=sub.symbols, strategies=sub.strategies,
        regimes=sub.regimes, min_strength=sub.min_strength,
    )


def _words(rng, n, u32):
    return rng.integers(0, 2**32, (n, u32), dtype=np.uint64).astype(np.uint32)


def _random_planes(rng, s: int, u: int):
    """Random planes of the registry's shapes: the no-row bucket empty,
    sparse wildcards, floors in [0, 1) with ``+inf`` (empty) slots."""
    u32 = u // 32
    sym = _words(rng, s + 1, u32)
    sym[s] = 0
    anym = _words(rng, 3, u32) & _words(rng, 3, u32) & _words(rng, 3, u32)
    floors = rng.random(u).astype(np.float32)
    floors[rng.random(u) < 0.2] = np.inf
    floors[:3] = [0.0, 1e6, 0.5]
    return sym, _words(rng, N_STRAT, u32), _words(rng, R_ROWS, u32), anym, floors


def _torch_planes(planes):
    *words, floors = planes
    return (*(tk.to_device_words(w, "cpu") for w in words), torch.from_numpy(floors.copy()))


# -- the device pack and the match -------------------------------------------------


@pytest.mark.parametrize("shape", [(4, 64), (8, 96), (16, 32)])
def test_pack_equals_reference(shape):
    rng = np.random.default_rng(shape[0] * 1000 + shape[1])
    bits = rng.random(shape) < 0.4
    bits[0] = True  # bit 31 of every word set: the sign bit of the int32 view
    got = tk.pack_bits_device(bits, "cpu")
    assert got.dtype == np.uint32
    assert np.array_equal(got, jk.pack_bits_device(bits))
    assert np.array_equal(got, tk.pack_words_np(bits))
    assert np.array_equal(tk.unpack_words_np(got), bits)


@pytest.mark.parametrize("u", [64, 96])
@pytest.mark.parametrize("k", [4, 8, 16])
def test_match_words_equal_reference(u, k):
    """``match_planes`` against the reference's ``_match_impl`` on the same
    planes and fired bucket: one padding slot, the no-row bucket, NaN and
    ±inf scores, a score equal to a floor, every regime row."""
    rng = np.random.default_rng(u * 100 + k)
    s = 8
    planes = _random_planes(rng, s, u)
    rows = rng.integers(0, s + 1, k).astype(np.int32)
    rows[0] = s  # a fired symbol with no current row
    strats = rng.integers(0, N_STRAT, k).astype(np.int32)
    scores = rng.normal(0, 1, k).astype(np.float32)
    scores[1:4] = [np.nan, np.inf, -np.inf]
    scores[0] = -0.5  # |score| equal to slot 2's floor
    valid = np.arange(k) < k - 1
    targs = _torch_planes(planes)
    hits = 0
    for regime_row in range(R_ROWS):
        want = np.asarray(jk._match_impl(
            *(jnp.asarray(p) for p in planes), jnp.asarray(rows), jnp.asarray(strats),
            jnp.asarray(scores), jnp.asarray(valid), jnp.int32(regime_row),
        ))
        got = tk.to_host_words(tk.match_planes(
            *targs, torch.from_numpy(rows.astype(np.int64)),
            torch.from_numpy(strats.astype(np.int64)), torch.from_numpy(scores),
            torch.from_numpy(valid), regime_row,
        ))
        assert got.dtype == want.dtype == np.uint32
        assert np.array_equal(got, want), regime_row
        assert not got[~valid].any()
        hits += tk.popcount_words(got)
    assert hits > 0  # not an all-zero comparison


def test_apply_subscription_deltas_equals_reference():
    """The one-word scatter, pads (cell (0, 0) carrying its current value)
    and duplicate cells included, on every plane and the floors."""
    rng = np.random.default_rng(3)
    s, u, b, f = 8, 96, 16, 4
    planes = _random_planes(rng, s, u)
    args = []
    for plane in planes[:4]:
        r = rng.integers(0, plane.shape[0], b).astype(np.int32)
        w = rng.integers(0, plane.shape[1], b).astype(np.int32)
        r[-3:] = 0
        w[-3:] = 0  # pads
        v = _words(rng, 1, b)[0]
        r[5], w[5] = r[4], w[4]  # a duplicate cell writes the same value
        v[-3:] = plane[0, 0]
        v[5] = v[4]
        args.append((r, w, v))
    fidx = np.array([2, 0, 1, 0], np.int32)
    fvals = rng.random((f, 32)).astype(np.float32)
    fvals[3] = fvals[1]
    want = jk.apply_subscription_deltas(
        *(jnp.asarray(p) for p in planes),
        *(jnp.asarray(a) for trip in args for a in trip),
        jnp.asarray(fidx), jnp.asarray(fvals),
    )
    targs = []
    for r, w, v in args:
        targs += [torch.from_numpy(r.astype(np.int64)), torch.from_numpy(w.astype(np.int64)),
                  tk.to_device_words(v, "cpu")]
    got = tk.apply_subscription_deltas(
        *_torch_planes(planes), *targs, torch.from_numpy(fidx.astype(np.int64)),
        torch.from_numpy(fvals),
    )
    for name, g, w in zip(PLANES, got, want):
        host = g.numpy() if name == "floors" else tk.to_host_words(g)
        assert np.array_equal(host, np.asarray(w)), name


def test_device_planes_match_equals_reference_and_oracle():
    """Both packages' ``DevicePlanes`` over equal registries of a random
    population: equal words on every regime (invalid included) and the
    recipient sets of ``match_oracle``."""
    rng = np.random.default_rng(41)
    symbols = [f"S{i:03d}USDT" for i in range(12)]
    rows = {s: i for i, s in enumerate(symbols)}
    jreg = jr.SubscriptionRegistry(symbol_capacity=16, capacity=64)
    treg = tr.SubscriptionRegistry(symbol_capacity=16, capacity=64)
    for sub in _random_population(rng, 50, symbols, rows):
        jreg.add(sub, row_of=rows.get)
        treg.add(_port_sub(sub), row_of=rows.get)
    jdev, tdev = jk.DevicePlanes(jreg), tk.DevicePlanes(treg, device="cpu")
    assert jdev.sync() == tdev.sync() == "full"
    for regime in [None, *range(len(MarketRegimeCode))]:
        n = int(rng.integers(1, 7))
        picks = rng.integers(0, len(symbols), n)
        strats = rng.integers(0, N_STRAT, n)
        scores = np.float32(rng.normal(0, 0.6, n))
        row = INVALID if regime is None else regime
        want = jdev.match(picks.astype(np.int32), strats.astype(np.int32), scores, row)
        got = tdev.match(picks.astype(np.int32), strats.astype(np.int32), scores, row)
        assert np.array_equal(got, want)
        oracle = treg.match_oracle(
            [(STRATEGY_ORDER[a], symbols[b], float(c)) for a, b, c in zip(strats, picks, scores)],
            regime,
        )
        for i in range(n):
            assert set(treg.users_of_slots(tk.unpack_slots(got[i]))) == oracle[i]


# -- the registry under churn --------------------------------------------------------


def _registry_state(reg) -> dict:
    return {
        **{name: getattr(reg, name).copy() for name in PLANES},
        "capacity": reg.capacity,
        "version": reg.version,
        "generation": reg.capacity_generation,
        "dirty_cells": set(reg.dirty_cells),
        "dirty_floor_words": set(reg.dirty_floor_words),
        "columns": reg.export_columns(),
        "snapshot": reg.snapshot(),
    }


def _assert_same(a: dict, b: dict, step: str) -> None:
    assert set(a) == set(b)
    for key in a:
        if key == "columns":
            assert set(a[key]) == set(b[key])
            for col in a[key]:
                assert a[key][col].dtype == b[key][col].dtype, (step, col)
                assert np.array_equal(a[key][col], b[key][col]), (step, col)
        elif isinstance(a[key], np.ndarray):
            assert a[key].dtype == b[key].dtype, (step, key)
            assert np.array_equal(a[key], b[key]), (step, key)
        else:
            assert a[key] == b[key], (step, key)


def test_churn_script_leaves_both_registries_equal():
    """One churn script on both packages' registries — adds, updates,
    removes, a bulk load that grows the planes, a symbol-row refresh after
    symbols were pruned and re-homed, a compaction — with each package's
    device copy synced after every step: planes, floors, dirty cells,
    versions, ``export_columns`` and the device planes equal throughout,
    and the sync kinds equal."""
    rng = np.random.default_rng(1234)
    symbols = [f"S{i:03d}USDT" for i in range(8)]
    rows = {s: i for i, s in enumerate(symbols)}
    jreg = jr.SubscriptionRegistry(symbol_capacity=8, capacity=32)
    treg = tr.SubscriptionRegistry(symbol_capacity=8, capacity=32)
    jdev, tdev = jk.DevicePlanes(jreg), tk.DevicePlanes(treg, device="cpu")
    kinds = []

    def both(step, fn):
        fn(jreg, jr.Subscription)
        fn(treg, tr.Subscription)
        _assert_same(_registry_state(jreg), _registry_state(treg), step)
        kind = jdev.sync()
        assert tdev.sync() == kind, step
        kinds.append(kind)
        for name, got, want in zip(PLANES, tdev.host_planes(), jdev._arrays):
            assert np.array_equal(got, np.asarray(want)), (step, name)

    live: dict[str, object] = {}
    next_id = 0
    for burst in range(6):
        for _ in range(12):
            op = rng.random()
            if op < 0.5 or not live:
                proto = _random_population(rng, 1, symbols, rows)[0]
                uid = f"d{next_id:04d}"
                next_id += 1
                live[uid] = proto

                def add(reg, cls, p=proto, uid=uid):
                    reg.add(cls(uid, p.symbols, p.strategies, p.regimes, p.min_strength),
                            row_of=rows.get)

                both(f"add {uid}", add)
            elif op < 0.75:
                uid = str(rng.choice(sorted(live)))
                floor = float(np.float32(rng.random()))
                p = live[uid]

                def update(reg, cls, p=p, uid=uid, floor=floor):
                    reg.update(cls(uid, p.symbols, None, p.regimes, floor), row_of=rows.get)

                both(f"update {uid}", update)
            else:
                uid = str(rng.choice(sorted(live)))
                del live[uid]
                both(f"remove {uid}", lambda reg, cls, uid=uid: reg.remove(uid))
        if burst == 2:
            bulk = _random_population(rng, 40, symbols, rows)

            def load(reg, cls, bulk=bulk, burst=burst):
                reg.bulk_load(
                    [cls(f"b{burst}_{s.user_id}", s.symbols, s.strategies, s.regimes,
                         s.min_strength) for s in bulk],
                    row_of=rows.get,
                )

            both("bulk_load", load)
            live.update({f"b{burst}_{s.user_id}": s for s in bulk})
        if burst == 3:
            # two symbols pruned, one listed into a freed row, one re-homed
            rows = {"S001USDT": 0, "NEWUSDT": 1, **{s: i for i, s in enumerate(symbols)
                                                    if i >= 3}}
            both("refresh_rows", lambda reg, cls: reg.refresh_rows(rows.get, 7))
        if burst == 4:
            both("compact", lambda reg, cls: reg.compact())
    assert {"full", "incremental"} <= set(kinds)
    assert jreg.capacity > 32
    # a restored population exports the same columns from either package
    for name, arr in jreg.export_columns().items():
        assert np.array_equal(arr, treg.export_columns()[name]), name


# -- the plane, the snapshot sidecar ------------------------------------------------


class _Rows:
    """A stand-in for the engine's SymbolRegistry."""

    def __init__(self, mapping: dict, capacity: int = 8, version: int = 1) -> None:
        self.mapping = dict(mapping)
        self.capacity = capacity
        self.version = version

    def row_of(self, name):
        return self.mapping.get(name)

    def to_mapping(self):
        return dict(self.mapping)


def _planes(tmp_path, snap, rows_map, **kw):
    """One plane of each package over equal symbol rows and one snapshot
    path (each writes its own archive name)."""
    j = jp.FanoutPlane(_Rows(rows_map), capacity=64, snapshot_path=str(tmp_path / f"j.{snap}"),
                       **kw)
    t = tp.FanoutPlane(_Rows(rows_map), capacity=64, snapshot_path=str(tmp_path / f"t.{snap}"),
                       device="cpu", **kw)
    return j, t


def _populate(plane, mod, rng_seed=11):
    rng = np.random.default_rng(rng_seed)
    symbols = ["BTCUSDT", "ETHUSDT", "XRPUSDT", "ADAUSDT"]
    subs = _random_population(rng, 40, symbols, {s: i for i, s in enumerate(symbols)})
    plane.bulk_load([mod.Subscription(s.user_id, s.symbols, s.strategies, s.regimes,
                                      s.min_strength) for s in subs])
    plane.seq = 5
    for i in range(10):
        plane.unsubscribe(f"user{i:04d}")
    plane.subscribe(mod.Subscription("late", min_strength=0.25))
    plane.sync_device()


def test_snapshot_archives_cross_between_the_packages(tmp_path):
    """An archive saved by either package restores into the other: planes
    bit for bit, records lazy until touched, min-seq floors, seq, the
    archived rows adopted under an equal engine fingerprint; the restored
    plane's first match equals the donor's."""
    rows_map = {"BTCUSDT": 0, "ETHUSDT": 1, "XRPUSDT": 2, "ADAUSDT": 3}
    j, t = _planes(tmp_path, "snap.npz", rows_map)
    assert t._engine_fingerprint() == j._engine_fingerprint()
    _populate(j, jr)
    _populate(t, tr)
    assert j.maybe_save_snapshot() and t.maybe_save_snapshot()
    for donor, warm in ((j, tp.FanoutPlane(_Rows(rows_map), capacity=64, device="cpu")),
                        (t, jp.FanoutPlane(_Rows(rows_map), capacity=64))):
        assert warm.try_restore_snapshot(donor.snapshot_path)
        wreg, dreg = warm.subscriptions, donor.subscriptions
        for name in PLANES:
            assert np.array_equal(getattr(wreg, name), getattr(dreg, name)), name
        assert len(wreg) == len(dreg) == 31 and wreg._records.lazy_count == 31
        assert wreg.slot_of("late") == dreg.slot_of("late")
        assert wreg.get("late").min_strength == 0.25 and wreg._records.lazy_count == 30
        assert warm._slot_min_seq == donor._slot_min_seq
        assert warm.seq == donor.seq == 5
        assert wreg._rows_version == warm.engine_registry.version
        assert warm.sync_device() == "full"
        for regime in (INVALID, 0):
            args = (np.array([0, 2], np.int32), np.array([1, 3], np.int32),
                    np.array([0.6, -0.2], np.float32), regime)
            assert np.array_equal(warm._device.match(*args), donor._device.match(*args))
    # the archives of both packages hold the same arrays
    with np.load(j.snapshot_path) as a, np.load(t.snapshot_path) as b:
        assert set(a.files) == set(b.files)
        for name in a.files:
            if name != "__meta":
                assert np.array_equal(a[name], b[name]), name
        ma = json.loads(bytes(a["__meta"]).decode())
        mb = json.loads(bytes(b["__meta"]).decode())
        for key in ("nonce", "saved_unix"):
            ma.pop(key), mb.pop(key)
        assert ma == mb


def test_snapshot_rejections_start_cold(tmp_path, monkeypatch):
    """The port's restore starts cold, never raises, on: a torn archive, a
    future layout version, a symbol capacity the engine does not have, and
    a sharded set with a sibling missing. The reference's sharded manifest
    restores, the port writes one, and the plane partitions its outbox."""
    rows_map = {"BTCUSDT": 0, "ETHUSDT": 1}
    j, t = _planes(tmp_path, "snap.npz", rows_map)
    for plane, mod in ((j, jr), (t, tr)):
        plane.subscribe(mod.Subscription("amy"))
    t.save_snapshot()
    j.save_snapshot(n_shards=4)  # the reference's sharded manifest + 3 siblings

    def cold(path, **rows_kw) -> bool:
        plane = tp.FanoutPlane(_Rows(rows_map, **rows_kw), capacity=64, device="cpu")
        ok = plane.try_restore_snapshot(path)
        assert ok or len(plane.subscriptions) == 0
        return not ok

    assert not cold(j.snapshot_path)  # sharded: restored
    assert int(ts.load_snapshot(j.snapshot_path)[2]["shard_count"]) == 4
    sharded = tmp_path / "t2.snap.npz"
    assert t.save_snapshot(sharded, n_shards=2)["shard_count"] == 2
    assert not cold(sharded)
    (tmp_path / "t2.snap.npz.shard1-of-2").unlink()  # a torn roster
    assert cold(sharded)
    assert not cold(t.snapshot_path)
    assert cold(t.snapshot_path, capacity=16)  # the engine's symbol axis grew
    monkeypatch.setattr(ts, "FANOUT_SNAP_VERSION", 99)
    assert cold(t.snapshot_path)
    monkeypatch.undo()
    t.snapshot_path.write_bytes(t.snapshot_path.read_bytes()[:100])  # torn
    assert cold(t.snapshot_path)
    part = tp.FanoutPlane(_Rows(rows_map), outbox_shards=2, device="cpu",
                          outbox_path=str(tmp_path / "out.jsonl"))
    assert isinstance(part.outbox, th.ShardedBroadcastOutbox) and part.outbox_shards == 2


def test_snapshot_fingerprint_mismatch_refreshes_rows(tmp_path):
    """Symbols re-homed while the process was down: the port restores the
    reference's archive but marks its rows unsound, and the first sync
    re-resolves every explicit subscription."""
    j, _ = _planes(tmp_path, "snap.npz", {"BTCUSDT": 0, "ETHUSDT": 1})
    j.subscribe(jr.Subscription("pin", symbols=frozenset({"BTCUSDT"})))
    slot = j.subscriptions.slot_of("pin")
    j.save_snapshot()
    swapped = tp.FanoutPlane(_Rows({"ETHUSDT": 0, "BTCUSDT": 1}), capacity=64, device="cpu")
    assert swapped.try_restore_snapshot(j.snapshot_path)
    reg = swapped.subscriptions
    assert reg._rows_version is None
    assert swapped.sync_device() == "full"
    assert (reg.sym_plane[1, slot >> 5] >> (slot & 31)) & 1
    assert not (reg.sym_plane[0, slot >> 5] >> (slot & 31)) & 1


def test_compaction_and_listing_churn_match_the_reference(tmp_path):
    """The plane's compaction (threshold, re-pack, shrink, moved users'
    floors) and a match across listing churn (re-homed and delisted
    symbols), step for step in both packages."""
    from types import SimpleNamespace

    out = {}
    for key, mod, pmod, kw in (("j", jr, jp, {}), ("t", tr, tp, {"device": "cpu"})):
        rows = _Rows({"AAAUSDT": 0, "BBBUSDT": 1})
        plane = pmod.FanoutPlane(rows, capacity=64, **kw)
        for i in range(80):
            plane.subscribe(mod.Subscription(
                f"u{i:03d}", symbols=frozenset({"AAAUSDT"}) if i % 3 == 0 else None,
                min_strength=0.1))
        plane.sync_device()
        plane.seq = 7
        for i in list(range(0, 80, 2)) + list(range(1, 21, 2)):
            plane.unsubscribe(f"u{i:03d}")
        assert not plane.maybe_compact()  # frac 0: off
        plane.compact_frac = 0.6
        assert plane.maybe_compact()  # 50/80 crosses it
        got = [dict(plane._slot_min_seq), plane.subscriptions.capacity, plane.sync_device()]

        def recipients(symbol):
            sig = SimpleNamespace(
                strategy=STRATEGY_ORDER[0], symbol=symbol, row=0, trace_id="t0", tick_seq=0,
                value=SimpleNamespace(score=0.9, direction="LONG", autotrade=False),
                fanout_frame=None)
            plane.on_fired([sig], {"valid": False}, tick_ms=900)
            return sorted(plane.subscriptions.users_of_slots(tk.unpack_slots(
                sig.fanout_frame[1])))

        got.append(recipients("AAAUSDT"))
        rows.mapping, rows.version = {"CCCUSDT": 0, "BBBUSDT": 1, "AAAUSDT": 2}, 2
        got += [recipients("AAAUSDT"), recipients("CCCUSDT")]
        rows.mapping, rows.version = {"CCCUSDT": 0, "BBBUSDT": 1}, 3
        got += [recipients("AAAUSDT"), dict(plane.recompiles), plane.seq]
        out[key] = got
    assert out["t"] == out["j"]
    assert out["t"][1] == 64 and len(out["t"][3]) == 30


# -- the hub over real sockets --------------------------------------------------------


async def _ws_connect(port: int, user: str, cursor: str | None = None):
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    q = f"/ws?user={user}" + (f"&cursor={cursor}" if cursor else "")
    writer.write(
        (f"GET {q} HTTP/1.1\r\nHost: x\r\nUpgrade: websocket\r\nConnection: Upgrade\r\n"
         "Sec-WebSocket-Key: dGhlIHNhbXBsZQ==\r\nSec-WebSocket-Version: 13\r\n\r\n").encode())
    await writer.drain()
    status = await reader.readline()
    while (await reader.readline()) not in (b"\r\n", b""):
        pass
    return reader, writer, status.decode()


async def _ws_read_json(reader):
    opcode, payload = await th.ws_read_frame(reader)
    assert opcode == 0x1
    return json.loads(payload)


async def _sse_connect(port: int, user: str, cursor: str | None = None):
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    q = f"/sse?user={user}" + (f"&cursor={cursor}" if cursor else "")
    writer.write(f"GET {q} HTTP/1.1\r\nHost: x\r\n\r\n".encode())
    await writer.drain()
    status = await reader.readline()
    while (await reader.readline()) not in (b"\r\n", b""):
        pass
    return reader, writer, status.decode()


async def _sse_read_json(reader):
    sid = data = None
    while True:
        line = (await reader.readline()).decode().strip()
        if line.startswith("id:"):
            sid = int(line[3:].strip())
        elif line.startswith("data:"):
            data = json.loads(line[5:].strip())
        elif not line and data is not None:
            return sid, data


def _mk_plane(tmp_path, conn_queue_max=256, **kw):
    return tp.FanoutPlane(_Rows({"BTCUSDT": 0}), capacity=64,
                          outbox_path=str(tmp_path / "outbox.jsonl"),
                          conn_queue_max=conn_queue_max, device="cpu", **kw)


def _frame(plane, users: set[str], i: int) -> dict:
    """Mint and publish one frame addressed to ``users``."""
    bits = np.zeros(plane.subscriptions.capacity, bool)
    bits[sorted(plane.subscriptions.slot_of(u) for u in users)] = True
    words = tk.pack_words_np(bits[None, :])[0]
    frame = {"seq": plane.seq, "trace_id": f"trace{i // 2}", "tick_seq": i // 2,
             "strategy": "mrf", "symbol": "BTCUSDT", "direction": "LONG", "score": 0.5,
             "recipients": len(users)}
    plane.seq += 1
    plane.outbox.append(frame, words)
    plane.hub.broadcast(frame, words)
    return frame


def test_hub_ws_sse_delivery_shed_and_cursor_resume(tmp_path):
    """WS and SSE clients receive exactly their frames; a stalled consumer's
    2-frame queue sheds (``slow_consumer``) while the others stay fresh; a
    reconnect with a seq cursor, and one with a trace/tick cursor, replay
    the gap from the outbox; an unknown user is refused."""
    plane = _mk_plane(tmp_path, conn_queue_max=64)
    for u in ("amy", "ben", "cal"):
        plane.subscriptions.add(tr.Subscription(u))

    async def go():
        port = await plane.serve(0, host="127.0.0.1")
        r_amy, w_amy, st = await _ws_connect(port, "amy")
        assert "101" in st
        r_ben, w_ben, st = await _sse_connect(port, "ben")
        assert "200" in st
        r_x, w_x = await asyncio.open_connection("127.0.0.1", port)
        w_x.write(b"GET /ws?user=nobody HTTP/1.1\r\nHost: x\r\n\r\n")
        await w_x.drain()
        assert "404" in (await r_x.readline()).decode()
        w_x.close()
        cal = th._Connection("cal", plane.subscriptions.slot_of("cal"), "ws", queue_max=2)
        plane.hub._conns.add(cal)
        sent = []
        for i in range(6):
            to = {"amy", "ben", "cal"} if i % 2 == 0 else {"amy"}
            sent.append((_frame(plane, to, i), to))
        for frame, _ in sent:
            assert (await asyncio.wait_for(_ws_read_json(r_amy), 5))["seq"] == frame["seq"]
        for frame, to in sent:
            if "ben" in to:
                sid, got = await asyncio.wait_for(_sse_read_json(r_ben), 5)
                assert sid == frame["seq"] == got["seq"]
        assert cal.dropped == 1 and cal.gapped and plane.hub.shed == 1
        plane.hub._conns.discard(cal)
        r_cal, w_cal, st = await _ws_connect(port, "cal", cursor="-1")
        assert "101" in st
        got = [(await asyncio.wait_for(_ws_read_json(r_cal), 5))["seq"] for _ in range(3)]
        assert got == [0, 2, 4] and plane.hub.resumed >= 3
        r_amy2, w_amy2, st = await _sse_connect(port, "amy", cursor="trace1/1")
        sid, _ = await asyncio.wait_for(_sse_read_json(r_amy2), 5)
        assert sid == 4  # trace1/1 covers seqs 2 and 3
        assert plane.hub.frames_sent >= 13
        # unsubscribing closes the user's open connection
        assert plane.unsubscribe("amy") is not None
        with pytest.raises(ConnectionError):
            while True:
                await asyncio.wait_for(th.ws_read_frame(r_amy), 5)
        for w in (w_amy, w_ben, w_amy2, w_cal):
            w.close()
        await plane.aclose()

    asyncio.run(go())
    # no tail ring: each cursor took the outbox, its reason counted
    assert plane.hub.resume_fallbacks == {"tail_off": 1, "trace_cursor": 1}


def test_hub_tail_resume_skips_the_outbox(tmp_path):
    """A cursor inside the tail ring replays from memory (the outbox is not
    scanned); one older than the ring falls back to the outbox, counted
    ``cursor_gap``, and still replays in full."""
    plane = _mk_plane(tmp_path, resume_tail=8)
    for u in ("amy", "ben"):
        plane.subscribe(tr.Subscription(u))
    for i in range(12):
        _frame(plane, {"amy", "ben"} if i % 2 else {"ben"}, i)
    assert plane.hub.snapshot()["tail_retained"] == 8

    async def go():
        port = await plane.serve(0, host="127.0.0.1")

        async def no_scan():
            raise AssertionError("outbox scanned on an in-window cursor")

        real = plane.hub._scan_outbox_stable
        plane.hub._scan_outbox_stable = no_scan
        reader, writer, _ = await _ws_connect(port, "amy", cursor="7")
        got = [(await asyncio.wait_for(_ws_read_json(reader), 5))["seq"] for _ in range(2)]
        assert got == [9, 11] and plane.hub.tail_resumes == 2
        plane.hub._scan_outbox_stable = real
        r2, w2, _ = await _ws_connect(port, "ben", cursor="0")
        got = [(await asyncio.wait_for(_ws_read_json(r2), 5))["seq"] for _ in range(11)]
        assert got == list(range(1, 12))
        assert plane.hub.resume_fallbacks == {"cursor_gap": 1}
        writer.close()
        w2.close()
        await plane.aclose()

    asyncio.run(go())


def test_outbox_rotation_cursors_and_reference_files(tmp_path):
    """The two-generation rotation, cursor resolution and per-slot replay
    equal the reference's on the same appends, each reading the other's
    files; a reopened outbox seeds the plane's seq past its tail."""
    words = np.array([1], np.uint32)
    boxes = {}
    for key, mod in (("j", jp), ("t", tp)):
        path = tmp_path / f"{key}.jsonl"
        box = mod.BroadcastOutbox(path, cap=8)
        for i in range(20):
            box.append({"seq": i, "trace_id": f"t{i}", "tick_seq": i}, words)
        box.close()
        boxes[key] = path
    assert boxes["j"].read_bytes() == boxes["t"].read_bytes()
    seen = []
    for mod in (jp, tp):
        for key in ("j", "t"):
            box = mod.BroadcastOutbox(boxes[key], cap=8)
            ents = box.entries()
            seen.append((
                box.rotations, [f["seq"] for f, _ in ents], box.resolve_cursor("17"),
                box.resolve_cursor(f"t{ents[0][0]['seq']}/{ents[0][0]['seq']}"),
                box.resolve_cursor("t0/0"), box.resolve_cursor("garbage"),
                [f["seq"] for f in box.replay_after(17, slot=0)], box.replay_after(17, slot=1),
                box.last_seq(),
            ))
            box.close()
    assert all(s == seen[0] for s in seen)
    assert seen[0][1][-1] == 19 and len(seen[0][1]) <= 16
    plane = tp.FanoutPlane(_Rows({"BTCUSDT": 0}), outbox_path=str(boxes["j"]), device="cpu")
    assert plane.seq == 20
    plane.outbox.close()


def test_restore_excludes_post_save_frames_from_replay(tmp_path):
    """Frames published after the snapshot was saved were addressed by
    churn the restore cannot see: the hub excludes them from every replay."""
    snap = str(tmp_path / "fan.snap.npz")
    plane = _mk_plane(tmp_path, snapshot_path=snap)
    for u in ("amy", "ben"):
        plane.subscribe(tr.Subscription(u))
    for i in range(6):
        _frame(plane, {"amy", "ben"} if i % 2 else {"amy"}, i)
    saved_seq = plane.seq
    assert plane.maybe_save_snapshot()
    ben_slot = plane.subscriptions.slot_of("ben")
    plane.unsubscribe("ben")
    assert plane.subscribe(tr.Subscription("cal")) == ben_slot
    for i in range(6, 9):
        _frame(plane, {"cal"}, i)
    plane.outbox.close()
    warm = _mk_plane(tmp_path, snapshot_path=snap)
    assert warm.try_restore_snapshot()
    assert warm.hub.replay_excluded == (saved_seq, 8) and warm.seq == 9

    async def go():
        port = await warm.serve(0, host="127.0.0.1")
        reader, writer, _ = await _ws_connect(port, "ben", cursor="0")
        got = [(await asyncio.wait_for(_ws_read_json(reader), 5))["seq"] for _ in range(3)]
        assert got == [1, 3, 5]
        _frame(warm, {"ben"}, 99)
        assert (await asyncio.wait_for(_ws_read_json(reader), 5))["seq"] == 9
        writer.close()
        await warm.aclose()

    asyncio.run(go())


def test_hub_stops_although_an_sse_peer_left(tmp_path):
    """An SSE subscriber that went away (its handler never reads the
    socket, so it does not notice): the port's hub closes its connections
    and then waits for the server, so ``stop()`` returns at once. The
    reference waits for the server first, and since Python 3.12.1
    ``Server.wait_closed()`` waits for every open connection, so its
    ``stop()`` never returns (bounded here at 2 s)."""
    import sys

    async def stops(plane) -> bool:
        port = await plane.serve(0, host="127.0.0.1")
        _, writer, status = await _sse_connect(port, "amy")
        assert "200" in status
        writer.close()
        await asyncio.sleep(0.05)
        try:
            await asyncio.wait_for(plane.hub.stop(), 2.0)
        except (TimeoutError, asyncio.TimeoutError):
            return False
        return True

    port_plane = _mk_plane(tmp_path / "t")
    ref_plane = jp.FanoutPlane(_Rows({"BTCUSDT": 0}), capacity=64,
                               outbox_path=str(tmp_path / "j" / "outbox.jsonl"))
    for plane, mod in ((port_plane, tr), (ref_plane, jr)):
        plane.subscriptions.add(mod.Subscription("amy"))
    assert asyncio.run(stops(port_plane))
    assert asyncio.run(stops(ref_plane)) is (sys.version_info < (3, 12, 1))


def test_fanout_config_defaults_equal_the_reference(monkeypatch):
    """The fan-out knobs at their defaults equal the reference's
    environment-free defaults; the plane is on."""
    import os

    from binquant_tpu.config import Config as JConfig
    from binquant_tpu_torch.config import Config as TConfig

    for key in [k for k in os.environ if k.startswith("BQT_")]:
        monkeypatch.delenv(key)
    JConfig.reset()
    try:
        ref, port = JConfig(), TConfig()
        names = [n for n in vars(port) if n.startswith("fanout_")]
        assert len(names) == 12 and port.fanout_enabled is True
        for name in names:
            want, got = getattr(ref, name), getattr(port, name)
            if name == "fanout_outbox_path":
                assert got.rsplit("/", 1)[-1] == want.rsplit("/", 1)[-1]
            else:
                assert type(got)(want) == got, name
    finally:
        JConfig.reset()


@pytest.mark.slow
def test_million_subscription_match():
    """1M subscriptions bulk-loaded: the torch match equals a vectorized
    numpy oracle over the whole population."""
    n = 1_000_000
    reg = tr.SubscriptionRegistry(symbol_capacity=8, capacity=n)
    strat_of = np.arange(n) % N_STRAT
    floor_of = np.float32((np.arange(n) % 100) / 100.0)
    assert reg.bulk_load(
        tr.Subscription(f"u{i}", strategies=frozenset({STRATEGY_ORDER[strat_of[i]]}),
                        min_strength=float(floor_of[i])) for i in range(n)) == n
    dev = tk.DevicePlanes(reg, device="cpu")
    assert dev.sync() == "full"
    strats = np.array([0, 3, 7, 13], np.int32)
    scores = np.array([0.55, -0.10, 0.999, 0.31], np.float32)
    words = dev.match(np.zeros(4, np.int32), strats, scores, INVALID)
    expect = np.zeros((4, reg.capacity), bool)
    for k in range(4):
        expect[k, :n] = (strat_of == strats[k]) & (np.abs(scores[k]) >= floor_of)
    assert np.array_equal(words, tk.pack_words_np(expect))
    assert tk.popcount_words(words) == int(expect.sum()) > 100_000
