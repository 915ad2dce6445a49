"""The sharded tick over the symbol mesh (``binquant_tpu_torch/parallel``).

* Placement: ``assemble_sharded``, ``assemble_from_slices``,
  ``shard_engine_state`` and ``shard_host_inputs`` at 2, 4 and 8 shards
  give the pieces the reference's ``NamedSharding`` gives on its virtual
  CPU devices (``addressable_shards`` of the same seeded state and inputs,
  ``__graft_entry__._example_inputs``), leaf by leaf; placing again changes
  nothing.
* The sharded tick against the unsharded port (S=64, W=120, 2/4/8 shards):
  the classic full tick with every output, the incremental wire step (in
  place too) and the carry-drift meter, bit for bit: the market scalars are
  computed once from the row-ordered columns, the digests combine exact
  counts and extremes, and the fired block is compacted from the gathered
  trigger bits.
* The port's sharded tick against the reference's sharded ``tick_step`` on
  its 8-device virtual mesh, to ``_parity_check``'s rule (the rebuilt
  indicator carry under the carry contract of
  ``tests/test_torch_incremental_step.py``).
* The traffic audit (S=64, W=400): no collective's result reaches
  S·W·F·4/16 bytes over a classic, an incremental and an audit tick, and an
  injected ``(S, W)`` gather trips the check.
* ``make_mesh`` refuses a multi-rank ``torch.distributed`` job.
* A 4-shard CPU engine: the unsharded engine's signal tuples on a pinned
  stream with a rewrite storm and a listing-churn tick (depth 1 and depth 2
  on per-shard ring slots), the scanned drive's serial fallback, a 4-shard
  save restored at 2 shards and unsharded running the identical next tick,
  the /healthz mesh section against the reference's, and the fan-out
  outbox's default partition count.
"""

from __future__ import annotations

import asyncio
import json

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from binquant_tpu.engine import step as jstep
from binquant_tpu.io import replay as jreplay
from binquant_tpu.parallel import mesh as jmesh
from binquant_tpu.regime.context import ContextConfig as JCfg
from binquant_tpu_torch.engine import step as tstep
from binquant_tpu_torch.engine.buffer import NUM_FIELDS
from binquant_tpu_torch.engine.convert import engine_state_from_numpy, engine_state_to_numpy
from binquant_tpu_torch.io import replay as treplay
from binquant_tpu_torch.io.checkpoint import CheckpointManager
from binquant_tpu_torch.parallel import collectives as tcoll
from binquant_tpu_torch.parallel import mesh as tmesh
from binquant_tpu_torch.regime.context import ContextConfig as TCfg
from binquant_tpu_torch.sim.scenarios import (
    ScenarioSpec,
    _bleed_then_hammer,
    base_market,
    emit_stream,
    listing_churn,
    rewrite_storm,
)
from tests.test_torch_incremental_step import _compare_carries

# small shapes: extra intra-op threads only spin and crowd parallel test workers
torch.set_num_threads(1)

SHARDS = (2, 4, 8)
ALL = tuple(sorted(tstep.STRATEGY_ORDER))


def _np_tree(tree):
    if tree is None:
        return None
    if isinstance(tree, tuple):
        return {f: _np_tree(v) for f, v in zip(tree._fields, tree)}
    return np.asarray(tree)


def _paths(tree, prefix: str = "") -> dict:
    """``{"buf5.times": leaf, ...}`` of a nested dict or named tuple."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = zip(tree._fields, tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        if v is not None:
            out.update(_paths(v, f"{prefix}.{k}" if prefix else k))
    return out


def _jax_pieces(arr) -> list[np.ndarray]:
    """A placed jax array's per-device pieces in row order."""
    shards = sorted(
        arr.addressable_shards,
        key=lambda s: (s.index[0].start or 0) if s.index else 0,
    )
    return [np.asarray(s.data) for s in shards]


def _is_split(arr) -> bool:
    spec = arr.sharding.spec
    return len(spec) > 0 and spec[0] == "symbols"


def _torch_inputs(jinputs) -> tstep.HostInputs:
    return tstep.HostInputs(*(torch.from_numpy(np.array(np.asarray(x))) for x in jinputs))


@pytest.fixture(scope="module")
def example():
    jstate, jupd, jinputs = graft._example_inputs(num_symbols=64, window=120)
    tstate = engine_state_from_numpy(_np_tree(jstate), "cpu")
    return jstate, jupd, jinputs, tstate


# -- placement ---------------------------------------------------------------------


@pytest.mark.parametrize("n", SHARDS)
def test_placement_gives_the_reference_pieces(example, n):
    jstate, _, jinputs, tstate = example
    jm = jmesh.make_mesh(jax.devices()[:n])
    tm = tmesh.make_mesh(["cpu"] * n)

    js = jmesh.shard_engine_state(jstate, jm)
    ts = tmesh.shard_engine_state(tstate, tm)
    assert len(ts.shards) == n and ts.capacity == 64
    split = _paths(ts.split)
    pieces = [_paths(engine_state_to_numpy(s)) for s in ts.shards]
    jleaves = _paths(js)
    assert set(jleaves) == set(split) == set(pieces[0])
    for path, arr in jleaves.items():
        assert split[path] == _is_split(arr), path
        want = _jax_pieces(arr) if split[path] else [np.asarray(arr)] * n
        for k in range(n):
            assert np.array_equal(pieces[k][path], want[k], equal_nan=True), (path, k)

    ji = jmesh.shard_host_inputs(jinputs, jm)
    ti = tmesh.shard_host_inputs(_torch_inputs(jinputs), tm)
    assert ti.btc_row == int(np.asarray(jinputs.btc_row))
    for field, arr in zip(ji._fields, ji):
        want = _jax_pieces(arr) if _is_split(arr) else [np.asarray(arr)] * n
        for k in range(n):
            got = getattr(ti.shards[k], field).numpy()
            assert np.array_equal(got, want[k], equal_nan=True), (field, k)

    # a second placement changes nothing
    assert tmesh.shard_engine_state(ts, tm) is ts
    assert tmesh.shard_host_inputs(ti, tm) is ti
    again = tmesh.shard_engine_state(tmesh.unshard_state(ts), tm)
    for a, b in zip(tmesh.tree_leaves(again.shards), tmesh.tree_leaves(ts.shards)):
        assert torch.equal(a.nan_to_num(), b.nan_to_num())
    # and a state gathered back is the one placed
    for a, b in zip(tmesh.tree_leaves(tmesh.unshard_state(ts)), tmesh.tree_leaves(tstate)):
        assert np.array_equal(a.numpy(), b.numpy(), equal_nan=True)


@pytest.mark.parametrize("n", SHARDS)
def test_assembly_gives_the_reference_pieces(n):
    rng = np.random.default_rng(n)
    host = rng.random((64, 5)).astype(np.float32)
    jm = jmesh.make_mesh(jax.devices()[:n])
    tm = tmesh.make_mesh(["cpu"] * n)
    ja, ta = jmesh.assemble_sharded(jm, host), tmesh.assemble_sharded(tm, host)
    assert ta.shape == (64, 5) and ta.sharding.is_split
    for got, want in zip(ta.pieces, _jax_pieces(ja), strict=True):
        assert np.array_equal(got.numpy(), want)
    scalar = tmesh.assemble_sharded(tm, np.float32(3.5))  # a 0-d array replicates
    assert not scalar.sharding.is_split
    assert [float(p) for p in scalar.pieces] == [float(x) for x in _jax_pieces(
        jmesh.assemble_sharded(jm, np.float32(3.5)))]
    slices = np.split(host, n)
    sharding = tmesh.symbol_sharding(tm, 2)
    tf = tmesh.assemble_from_slices(tm, slices, sharding)
    jf = jmesh.assemble_from_slices(jm, slices, jmesh.symbol_sharding(jm, 2))
    assert tf.shape == tuple(jf.shape)
    for got, want in zip(tf.pieces, _jax_pieces(jf), strict=True):
        assert np.array_equal(got.numpy(), want)
    # each piece owns its storage: writing one leaves the host array alone
    tf.pieces[0].zero_()
    assert host[0, 0] != 0.0
    assert tmesh._put(tm, tf, sharding) is tf
    with pytest.raises(ValueError, match="slices for"):
        tmesh.assemble_from_slices(tm, slices[:-1], sharding)


def test_make_mesh_refuses_a_multi_process_job(monkeypatch):
    monkeypatch.setattr(torch.distributed, "is_available", lambda: True)
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda *a, **k: 4)
    with pytest.raises(NotImplementedError, match="single-process"):
        tmesh.make_mesh(["cpu"] * 2)


# -- the sharded tick against the unsharded port ------------------------------------

S, W = 64, 120
T15 = 1_780_272_000
T5 = T15 + 600
BTC_ROW = 37  # shard 1 of 2, 2 of 4, 4 of 8
CFG = TCfg(required_fresh_symbols=4, min_coverage_ratio=0.5)


def _ring(rng, t_last: int, interval: int, filled: np.ndarray, window: int) -> dict:
    rets = rng.normal(0, 0.006, (S, window))
    rets[:8] -= 0.004  # a few oversold rows
    close = 40 * np.exp(np.cumsum(rets, axis=1))
    open_ = np.concatenate([close[:, :1], close[:, :-1]], axis=1)
    vol = np.abs(rng.normal(1000, 200, (S, window)))
    vals = np.stack(
        [open_, np.maximum(open_, close) * 1.002, np.minimum(open_, close) * 0.998, close,
         vol, vol * close, np.full_like(close, 300.0), vol / 2, vol * close / 2,
         np.full_like(close, float(interval))], axis=-1,
    ).astype(np.float32)
    times = np.broadcast_to(
        (t_last - interval * np.arange(window - 1, -1, -1)).astype(np.int32), (S, window)
    ).copy()
    for r in range(S):
        times[r, : window - filled[r]] = -1
        vals[r, : window - filled[r]] = np.nan
    # full rows mid-phase: the newest bar is not the last column
    cursor = (np.arange(S) * 7 % window).astype(np.int32)
    cursor[filled < window] = 0
    for r in range(S):
        times[r] = np.roll(times[r], cursor[r])
        vals[r] = np.roll(vals[r], cursor[r], axis=0)
    return {"times": times, "values": vals, "filled": filled.copy(), "cursor": cursor}


def _update(rng, ts: int, interval: int, messy: bool):
    rows = np.arange(S, dtype=np.int32)
    c = 40 * (1 + rng.normal(0, 0.01, S))
    v = np.abs(rng.normal(1000, 200, S))
    vals = np.stack([c, c * 1.002, c * 0.998, c, v, v * c, np.full(S, 300.0), v / 2,
                     v * c / 2, np.full(S, float(interval))], axis=-1).astype(np.float32)
    ts_arr = np.full(S, ts, np.int32)
    if messy:
        ts_arr[2] = ts - interval  # a correction of the newest stored bar
        ts_arr[33] = ts - interval * 500  # a stale insert: dropped
        rows = np.concatenate([rows, [-1, S + 4, 40]])  # pads, a repeated row
        ts_arr = np.concatenate([ts_arr, [ts, ts, ts]])
        vals = np.concatenate([vals, vals[:3] * 1.01])
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in (rows.astype(np.int32),
                                                                     ts_arr, vals))


def _market(window: int, seed: int):
    rng = np.random.default_rng(seed)
    filled = np.full(S, window, np.int32)
    filled[[5, 6, 45]] = [window - 10, 60, 0]
    leaves = {
        "buf5": _ring(rng, T5 - 300, 300, filled, window),
        "buf15": _ring(rng, T15 - 900, 900, filled, window),
        "mrf_last_emitted": np.full(S, -1, np.int32),
        "pt_last_signal_close": np.full(S, -1, np.int32),
    }
    carry = _np_tree(jstep.initial_regime_carry(S))
    carry.update(
        has_prev=np.asarray(True), market_regime=np.asarray(3, np.int32),
        stable_since=np.asarray(T15 - 7200, np.int32),
        stage_ts=np.asarray(T15 - 900, np.int32), stage_valid=np.asarray(True),
        stage_regime=np.asarray(3, np.int32),
        stage_scores=np.asarray([0.3, 0.2, 0.55, 0.1], np.float32),
        stage_stable_since=np.asarray(T15 - 7200, np.int32),
    )
    leaves["regime_carry"] = carry
    leaves["indicator_carry"] = _np_tree(tstep.empty_indicator_carry(S, device="cpu"))
    state = engine_state_from_numpy(leaves, "cpu")
    tracked = torch.from_numpy(filled > 0)

    def inputs(ts15: int, ts5: int) -> tstep.HostInputs:
        return tstep.default_host_inputs(S, device="cpu")._replace(
            tracked=tracked, btc_row=torch.tensor(BTC_ROW, dtype=torch.int32),
            timestamp_s=torch.tensor(ts15, dtype=torch.int32),
            timestamp5_s=torch.tensor(ts5, dtype=torch.int32),
            adp_latest=torch.tensor(-0.44), adp_prev=torch.tensor(-0.47),
            adp_diff=torch.tensor(0.03), breadth_momentum_points=torch.tensor(4.0),
            grid_policy_allows=torch.tensor(True),
        )

    ticks = [
        (_update(rng, T5, 300, True), _update(rng, T15, 900, True), inputs(T15, T5)),
        (_update(rng, T5 + 900, 300, False), _update(rng, T15 + 900, 900, False),
         inputs(T15 + 900, T5 + 900)),
    ]
    return state, ticks


def _bits_equal(a, b, what) -> None:
    la, lb = tmesh.tree_leaves(a), tmesh.tree_leaves(b)
    assert len(la) == len(lb), what
    for i, (x, y) in enumerate(zip(la, lb)):
        assert x.dtype == y.dtype and x.shape == y.shape, (what, i)
        if x.dtype.is_floating_point:
            x, y = x.contiguous().view(torch.int32), y.contiguous().view(torch.int32)
        assert torch.equal(x.cpu(), y.cpu()), (what, i)


@pytest.fixture(scope="module")
def unsharded():
    state0, ticks = _market(W, 7)
    (a5, a15, in1), (b5, b15, in2) = ticks
    flags = dict(wire_enabled=ALL, numeric_digest=True, ingest_digest=True)
    state1, out1 = tstep.tick_step(state0, a5, a15, in1, CFG, **flags)
    state2, wire2 = tstep.tick_step_wire(state1, b5, b15, in2, CFG, incremental=True, **flags)
    drift = tstep.measure_carry_drift(state1, b5, b15, BTC_ROW)
    return dict(state0=state0, ticks=ticks, flags=flags, state1=state1, out1=out1,
                state2=state2, wire2=wire2, drift=drift)


@pytest.mark.parametrize("n", SHARDS)
def test_sharded_tick_is_the_unsharded_tick_bit_for_bit(unsharded, n):
    u = unsharded
    (a5, a15, in1), (b5, b15, in2) = u["ticks"]
    mesh = tmesh.make_mesh(["cpu"] * n)
    placed = tmesh.shard_engine_state(u["state0"], mesh)

    state1, out1 = tstep.tick_step(placed, a5, a15, in1, CFG, **u["flags"])
    assert int(u["out1"].wire[tstep.WIRE_FIRED_COUNT_OFF]) > 0  # the block is not empty
    _bits_equal(out1, u["out1"], "classic outputs")
    _bits_equal(tmesh.unshard_state(state1), u["state1"], "classic state")

    state2, wire2 = tstep.tick_step_wire(state1, b5, b15, in2, CFG, incremental=True,
                                         **u["flags"])
    _bits_equal(wire2, u["wire2"], "incremental wire")
    _bits_equal(tmesh.unshard_state(state2), u["state2"], "incremental state")
    # every replicated leaf is one value on every shard
    for split, *leaves in zip(tmesh.tree_leaves(state2.split),
                              *(tmesh.tree_leaves(s) for s in state2.shards)):
        if not split:
            for leaf in leaves[1:]:
                _bits_equal(leaf, leaves[0], "replicated leaf")

    # in place on every shard's rings: the same wire
    copy = tmesh.shard_engine_state(tmesh.unshard_state(state1), mesh)
    _, wire_ip = tstep.tick_step_wire_inplace(copy, b5, b15, in2, CFG, incremental=True,
                                              **u["flags"])
    _bits_equal(wire_ip, u["wire2"], "in-place wire")

    assert tstep.measure_carry_drift(state1, b5, b15, BTC_ROW) == u["drift"]


def test_sharded_tick_matches_the_reference_sharded_tick(example):
    """The reference's ``_parity_check`` rule on its 8-device virtual mesh:
    floats to atol/rtol 1e-5 with NaN equal, integers and the fired block
    exact."""
    jstate, jupd, jinputs, tstate = example
    cfg = dict(required_fresh_symbols=4, min_coverage_ratio=0.5)
    jm = jmesh.make_mesh(jax.devices()[:8])
    jnew, jout = jstep.tick_step(jmesh.shard_engine_state(jstate, jm), jupd, jupd,
                                 jmesh.shard_host_inputs(jinputs, jm), JCfg(**cfg))
    tm = tmesh.make_mesh(["cpu"] * 8)
    upd = tuple(torch.from_numpy(np.array(np.asarray(x))) for x in jupd)
    tnew, tout = tstep.tick_step(tmesh.shard_engine_state(tstate, tm), upd, upd,
                                 _torch_inputs(jinputs), TCfg(**cfg))
    jw, tw = np.asarray(jout.wire), tout.wire.numpy()
    assert jw.shape == tw.shape
    off = tstep.WIRE_FIRED_COUNT_OFF
    fired_end = off + 1 + 6 * tstep.WIRE_MAX_FIRED
    assert np.array_equal(jw[off:fired_end], tw[off:fired_end])
    assert np.allclose(jw, tw, atol=1e-5, rtol=1e-5, equal_nan=True)
    whole = tmesh.unshard_state(tnew)
    want = _paths(_np_tree(jnew._replace(indicator_carry=None)))
    got = _paths(engine_state_to_numpy(whole._replace(indicator_carry=None)))
    assert set(want) == set(got)
    for path, a in want.items():
        b = got[path]
        if a.dtype.kind == "f":
            assert np.allclose(a, b, atol=1e-5, rtol=1e-5, equal_nan=True), path
        else:
            assert np.array_equal(a, b), path
    # the rebuilt carry under the carry contract (its sums in torch's order)
    _compare_carries(jnew.indicator_carry, whole.indicator_carry, "sharded carry")


# -- the traffic audit --------------------------------------------------------------


def test_no_buffer_scale_field_crosses_shards():
    state0, ticks = _market(400, 11)
    (a5, a15, in1), (b5, b15, in2) = ticks
    limit = tcoll.traffic_limit(S, 400, NUM_FIELDS)
    assert limit == S * 400 * NUM_FIELDS * 4 // 16
    mesh = tmesh.make_mesh(["cpu"] * 4)
    placed = tmesh.shard_engine_state(state0, mesh)
    flags = dict(numeric_digest=True, ingest_digest=True)
    seen = {}

    def audited(kind, fn):
        tcoll.TRAFFIC.reset()
        out = fn()
        snap = tcoll.TRAFFIC.snapshot()
        tcoll.check_traffic(snap, limit)
        seen[kind] = snap
        return out

    state1, _ = audited("classic", lambda: tstep.tick_step_wire(
        placed, a5, a15, in1, CFG, incremental=False, **flags))
    audited("incremental", lambda: tstep.tick_step_wire(
        state1, b5, b15, in2, CFG, incremental=True, **flags))
    audited("audit", lambda: (tstep.measure_carry_drift(state1, b5, b15, BTC_ROW),
                              tstep.tick_step_wire(state1, b5, b15, in2, CFG, **flags)))
    for kind, snap in seen.items():
        assert 0 < snap["largest"] < limit, kind
        assert {"context", "fired", "calib", "digest"} <= set(snap["by_kind"]), kind
    assert "drift" in seen["audit"]["by_kind"]
    assert "btc_row" in seen["incremental"]["by_kind"]

    # an (S, W) field gathered across the shards trips the audit
    def leak(comm, st):
        comm.gather_rows(st.buf15.times, kind="leak")

    tcoll.TRAFFIC.reset()
    tcoll.run_shards(mesh, leak, [(s,) for s in state1.shards], S)
    snap = tcoll.TRAFFIC.snapshot()
    assert snap["by_kind"]["leak"]["largest"] == S * 400 * 4
    with pytest.raises(AssertionError, match="buffer-scale data crossed the mesh"):
        tcoll.check_traffic(snap, limit)


def test_a_failing_shard_program_raises_and_releases_the_others():
    mesh = tmesh.make_mesh(["cpu"] * 4)

    def program(comm, x):
        if comm.rank == 2:
            raise RuntimeError("shard 2 failed")
        return comm.count_sum(x)

    with pytest.raises(RuntimeError, match="shard 2 failed"):
        tcoll.run_shards(mesh, program, [(torch.tensor(k),) for k in range(4)], 16)
    out = tcoll.run_shards(mesh, lambda comm, x: comm.count_sum(x),
                           [(torch.tensor(k),) for k in range(4)], 16)
    assert [int(o) for o in out] == [6] * 4


# -- the engine in mesh mode --------------------------------------------------------

CAP, WIN, N_TICKS, WARM = 16, 120, 112, 100
SPEC = ScenarioSpec(name="_shard", description="", n_symbols=12, n_ticks=N_TICKS,
                    capacity=CAP, window=WIN)
QUIET = dict(delivery=False, trace_sample=0.0, freshness=False, host_phase=False, slo=False,
             delivery_health=False)


@pytest.fixture(scope="module")
def pinned(tmp_path_factory):
    """A stream with MeanReversionFade setups on three rows into the last
    tick, a rewrite storm six ticks from the end and a listing that claims
    a row eight ticks from the end; the first ``WARM`` ticks are the
    backfill."""
    closes, vols, _ = base_market(SPEC)
    shapes: dict = {}
    _bleed_then_hammer(closes, vols, shapes, (2, 5, 9), N_TICKS - 27, N_TICKS - 1)
    klines = emit_stream(SPEC, closes, vols, shapes)
    rewrite_storm(klines, [N_TICKS - 6], per_tick=2)
    listing_churn(klines, listings={11: N_TICKS - 8}, delistings={}, n_symbols=12)
    path = tmp_path_factory.mktemp("mesh") / "pinned.jsonl"
    path.write_text("".join(json.dumps(k) + "\n" for k in klines))
    return treplay.tick_seq(path)


def _engine(mesh_devices: int, **kw):
    return treplay.make_stub_engine(capacity=CAP, window=WIN, device="cpu",
                                    mesh_devices=mesh_devices, **{**QUIET, **kw})


def _warm(engine, ticks) -> None:
    for _, klines in ticks[:WARM]:
        for k in klines:
            engine.ingest(k)
    engine._flush_batchers()


async def _serial(engine, ticks) -> list:
    out = []
    for now_ms, klines in ticks:
        for k in klines:
            engine.ingest(k)
        out.extend(await engine.process_tick(now_ms=now_ms))
    return out + await engine.flush_pending()


def _drive(mesh_devices: int, ticks, **kw):
    engine = _engine(mesh_devices, **kw)
    _warm(engine, ticks)
    return engine, asyncio.run(_serial(engine, ticks[WARM:]))


@pytest.mark.parametrize("depth", [1, 2])
def test_four_shards_emit_the_unsharded_signal_tuples(pinned, depth):
    oracle, sig_o = _drive(0, pinned, pipeline_depth=depth)
    sharded, sig_s = _drive(4, pinned, pipeline_depth=depth)
    assert oracle.mesh is None and sharded.mesh.size == 4
    assert isinstance(sharded.state, tmesh.ShardedState)
    assert len(sig_o) >= 3
    assert treplay.signal_tuples(sig_s) == treplay.signal_tuples(sig_o)
    assert sharded.registry.to_mapping() == oracle.registry.to_mapping()
    assert sharded.full_recompute_reasons == oracle.full_recompute_reasons
    assert {"rewrite", "churn"} <= set(sharded.full_recompute_reasons)
    np.testing.assert_array_equal(sharded.last_wire, oracle.last_wire)
    if depth == 2:
        # the double-buffered rings are per shard: one slot of four shard
        # slots allocated, each on its shard's rows with storages of its own
        assert sharded.fresh_slots == oracle.fresh_slots == 1
        slot = tstep.ring_slot_of(sharded.state)
        assert len(slot) == 4 and all(isinstance(s, tstep.RingSlot) for s in slot)
        assert {s.values5.shape[0] for s in slot} == {CAP // 4}
        assert all(tstep.slot_is_free_of(s, sharded.state) for s in sharded._spare_slots)


def test_the_scanned_drive_runs_serially_on_a_mesh(pinned):
    engine = _engine(4)
    _warm(engine, pinned)

    async def go():
        return await engine.process_ticks_scanned(pinned[WARM:]) + await engine.flush_pending()

    fired = asyncio.run(go())
    assert engine.scanned_ticks == 0 and engine.scan_chunks == 0
    _, sig_o = _drive(0, pinned)
    assert treplay.signal_tuples(fired) == treplay.signal_tuples(sig_o)


def test_a_four_shard_save_restores_at_two_shards_and_unsharded(pinned, tmp_path):
    saver = _engine(4, pipeline_depth=0, donate=False)
    _warm(saver, pinned)
    asyncio.run(_serial(saver, pinned[WARM:WARM + 8]))
    ckpt = CheckpointManager(tmp_path / "state.npz", every_ticks=1)
    assert CheckpointManager.shard_count_for(saver) == 4
    assert ckpt.maybe_save(saver)
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "state.npz", "state.npz.shard1-of-4", "state.npz.shard2-of-4", "state.npz.shard3-of-4"]
    saved = tmesh.unshard_state(tstep.canonicalize_state(saver.state))
    nxt = pinned[WARM + 8:WARM + 9]
    wires, sigs = [], []
    for engine in (saver, _engine(2, pipeline_depth=0, donate=False),
                   _engine(0, pipeline_depth=0, donate=False)):
        if engine is not saver:
            assert ckpt.try_restore(engine)
            got = engine.state if engine.mesh is None else tmesh.unshard_state(engine.state)
            for a, b in zip(tmesh.tree_leaves(saved), tmesh.tree_leaves(got)):
                assert np.array_equal(a.numpy(), b.numpy(), equal_nan=True)
        sigs.append(treplay.signal_tuples(asyncio.run(_serial(engine, nxt))))
        wires.append(engine.last_wire)
    assert sigs[0] == sigs[1] == sigs[2]
    np.testing.assert_array_equal(wires[0], wires[1])
    np.testing.assert_array_equal(wires[0], wires[2])


def test_healthz_mesh_section_is_the_reference_s(monkeypatch):
    symbols = ["BTCUSDT", "ETHUSDT", "SOLUSDT", "XRPUSDT", "ADAUSDT", "DOGEUSDT"]
    monkeypatch.setenv("BQT_MESH_DEVICES", "4")
    jeng = jreplay.make_stub_engine(capacity=CAP, window=WIN, fanout=True)
    teng = treplay.make_stub_engine(capacity=CAP, window=WIN, device="cpu", fanout=True,
                                    **QUIET)
    for eng in (jeng, teng):
        for sym in symbols:
            eng.registry.add(sym)
        eng.registry.remove("SOLUSDT")
    want = jeng._mesh_snapshot()
    assert want["enabled"] and want["devices"] == 4
    assert teng._mesh_snapshot() == want
    assert teng.health_snapshot()["mesh"] == want


def test_the_outbox_partitions_default_to_the_mesh_size():
    assert _engine(4, fanout=True).fanout.outbox_shards == 4
    assert _engine(0, fanout=True).fanout.outbox_shards == 1
    pinned = _engine(4, fanout=True, fanout_overrides={"fanout_outbox_shards": 2})
    assert pinned.fanout.outbox_shards == 2
