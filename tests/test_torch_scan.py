"""The port's scanned multi-tick drive against the reference's and its own
serial drive, on the CPU.

* The drive: the reference's small market with a mid-stream rewrite
  (``tests/test_scan_replay.py::replay_with_rewrite``: 16 symbols, 112
  ticks, a corrected 15m candle re-sent two ticks later), capacity 32,
  window 120, chunks of at most 32 ticks. The port's
  ``process_ticks_scanned`` at its production loop (depth 1, rings in
  place, both digests) emits the reference's ``process_ticks_scanned``
  signal tuples and its own serial drive's, exactly; ``scanned_ticks``,
  ``scan_chunks`` and ``scan_overflow_reruns`` equal the reference's.
* The step: :func:`tick_step_scan` over 3-slot ticks (one tick padded to 3
  with an empty slot) against the serial folds and wire
  step, wires and final state BIT for bit, with and without the ingest
  digest; :func:`apply_updates_scan` (and its counted twin) against N serial
  folds and against the reference's, bit for bit;
  :func:`unpack_wire_block` against per-tick :func:`unpack_wire`, exactly.
* The overflow re-drive (``slow``): a burst market whose crash tick fires
  more pairs than the wire's 128 slots inside a chunk is re-driven
  serially, with the serial drive's fired set.
"""

from __future__ import annotations

import asyncio

import numpy as np
import pytest
import torch

from binquant_tpu.engine import step as jstep
from binquant_tpu.io import replay as jreplay
from binquant_tpu_torch.engine import step as tstep
from binquant_tpu_torch.engine.buffer import NUM_FIELDS, Field
from binquant_tpu_torch.io import replay as treplay

torch.set_num_threads(1)

CAPACITY, WINDOW = 32, 120
# the reference engines run under tests/conftest.py's pins: the port's
# observability and fan-out plane off to match (signal tuples do not
# depend on them)
PINS = dict(trace_sample=0.0, freshness=False, host_phase=False, slo=False,
            delivery_health=False, fanout=False, delivery=False, outcomes=False)


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
    return out


@pytest.fixture(scope="module")
def replay_with_rewrite(tmp_path_factory):
    """The reference's fixture: a corrected copy of an applied 15m candle
    (same open_time, close +0.4%) re-sent two ticks later."""
    path = tmp_path_factory.mktemp("torch_scan") / "scan_16.jsonl"
    jreplay.generate_replay_file(path, n_symbols=16, n_ticks=112)
    seq = treplay.tick_seq(path)
    donor_tick = len(seq) - 6
    donor = next(
        k for k in seq[donor_tick][1]
        if k["symbol"] == "S002USDT" and (k["close_time"] - k["open_time"]) // 1000 >= 899
    )
    corrected = dict(donor)
    corrected["close"] = round(donor["close"] * 1.004, 6)
    corrected["high"] = max(corrected["high"], corrected["close"])
    seq[donor_tick + 2][1].append(corrected)
    return seq


@pytest.fixture(scope="module")
def drives(replay_with_rewrite):
    seq = replay_with_rewrite
    jeng = jreplay.make_stub_engine(capacity=CAPACITY, window=WINDOW, incremental=True,
                                    scan_chunk=32)
    jax_sig = treplay.signal_tuples(_drive(jeng, seq, scanned=True))
    port = {}
    for scanned in (True, False):
        eng = treplay.make_stub_engine(capacity=CAPACITY, window=WINDOW, device="cpu",
                                       incremental=True, scan_chunk=32, **PINS)
        port[scanned] = (treplay.signal_tuples(_drive(eng, seq, scanned)), eng)
    return jeng, jax_sig, port


def test_scanned_drive_emits_reference_tuples(drives):
    """Exact: the port's scanned tuples are the reference's scanned tuples
    (both in tick order)."""
    _, jax_sig, port = drives
    sig, eng = port[True]
    assert len(jax_sig) > 0
    assert eng.pipeline_depth == 1 and eng._donation_mode() == "single"
    assert sig == jax_sig


def test_scanned_drive_emits_serial_tuples(drives):
    """Exact: the port's scanned drive emits its own serial drive's tuples,
    through the rewrite's chunk break (cold start and rewrite: two full
    ticks on both)."""
    _, _, port = drives
    (sig_scan, eng_scan), (sig_serial, eng_serial) = port[True], port[False]
    assert sig_scan == sig_serial
    assert eng_scan.ticks_processed == eng_serial.ticks_processed == 112
    assert eng_scan.full_recompute_reasons == eng_serial.full_recompute_reasons == {
        "cold_start": 1, "rewrite": 1,
    }
    assert eng_scan.incremental_ticks == eng_serial.incremental_ticks


@pytest.mark.parametrize("counter", ["scanned_ticks", "scan_chunks", "scan_overflow_reruns"])
def test_scan_counters_equal_reference(drives, counter):
    """Exact: the chunk counters equal the reference engine's."""
    jeng, _, port = drives
    eng = port[True][1]
    assert getattr(eng, counter) == getattr(jeng, counter)
    assert eng.scanned_ticks > 0 and eng.scan_chunks >= 2
    health = eng.health_snapshot()
    assert health[counter] == getattr(eng, counter)


def test_metrics_render_the_drive_counters(drives):
    """``/metrics`` renders the six counters under the reference's names,
    the scanned drive's moved by its chunks."""
    from binquant_tpu_torch.obs.exposition import render_text

    eng = drives[2][True][1]
    text = render_text().splitlines()
    for name in ("bqt_scanned_ticks_total", "bqt_scan_chunks_total",
                 "bqt_scan_overflow_reruns_total", "bqt_backtest_ticks_total",
                 "bqt_backtest_chunks_total", "bqt_backtest_overflow_reruns_total"):
        assert f"# TYPE {name} counter" in text, name
    scanned = next(line for line in text if line.startswith("bqt_scanned_ticks_total "))
    assert float(scanned.split()[1]) >= eng.scanned_ticks > 0


# --------------------------------------------------------------------------
# the step
# --------------------------------------------------------------------------

S_UNIT, W_UNIT = 8, 120
T0 = 1_780_272_000
# the regimes in which the grid-only policy can allow ladders
POLICY_REGIMES = (int(tstep.MarketRegimeCode.RANGE), int(tstep.MarketRegimeCode.TRANSITIONAL))


def _bars(rng, px, n, interval_s):
    """n bars per row, (n, S, F) float32, and the closing prices."""
    out = np.zeros((n, S_UNIT, NUM_FIELDS), np.float32)
    for i in range(n):
        new = px * (1 + rng.normal(0, 0.004, S_UNIT))
        out[i, :, Field.OPEN] = px
        out[i, :, Field.HIGH] = np.maximum(px, new) * 1.001
        out[i, :, Field.LOW] = np.minimum(px, new) * 0.999
        out[i, :, Field.CLOSE] = new
        out[i, :, Field.VOLUME] = 800 + 400 * rng.random(S_UNIT)
        out[i, :, Field.QUOTE_VOLUME] = out[i, :, Field.VOLUME] * new
        out[i, :, Field.NUM_TRADES] = 300.0
        out[i, :, Field.TAKER_BUY_BASE] = out[i, :, Field.VOLUME] / 2
        out[i, :, Field.TAKER_BUY_QUOTE] = out[i, :, Field.QUOTE_VOLUME] / 2
        out[i, :, Field.DURATION_S] = float(interval_s)
        px = new
    return out, px


def _batch(ts, vals):
    rows = np.arange(S_UNIT, dtype=np.int32)
    return rows, np.full(S_UNIT, ts, np.int32), vals


def _t(batch):
    return tuple(torch.from_numpy(np.ascontiguousarray(x)) for x in batch)


def _inputs(ts15, ts5, allow):
    inp = tstep.default_host_inputs(S_UNIT, device="cpu")
    return inp._replace(
        tracked=torch.ones(S_UNIT, dtype=torch.bool),
        btc_row=torch.tensor(0, dtype=torch.int32),
        timestamp_s=torch.tensor(ts15, dtype=torch.int32),
        timestamp5_s=torch.tensor(ts5, dtype=torch.int32),
        grid_policy_allows=torch.tensor(bool(allow)),
    )


@pytest.fixture(scope="module")
def warm_state():
    """A synced incremental state: 110 bars folded per interval, then one
    full tick that builds the carry. Returns (state, rng, prices, t15, t5)."""
    rng = np.random.default_rng(5)
    px5 = px15 = 20 + rng.random(S_UNIT) * 50
    h15, px15 = _bars(rng, px15, 111, 900)
    h5, px5 = _bars(rng, px5, 111, 300)
    st = tstep.initial_engine_state(S_UNIT, W_UNIT, device="cpu")
    t15 = T0 - 900 * 111
    t5 = T0 - 300 * 111
    for k in range(110):
        st = tstep.apply_updates_step(st, _t(_batch(t15 + 900 * k, h15[k])),
                                      _t(_batch(t5 + 300 * k, h5[k])))
    st, _ = tstep.tick_step_wire(
        st, _t(_batch(t5 + 300 * 110, h5[110])), _t(_batch(t15 + 900 * 110, h15[110])),
        _inputs(t15 + 900 * 110, t5 + 300 * 110, False), incremental=False,
    )
    return st, rng, (px5, px15), t15 + 900 * 111, t5 + 300 * 111


def _bits(x: torch.Tensor) -> torch.Tensor:
    if x.dtype == torch.float32:
        return x.view(torch.int32)
    return x


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [leaf for v in tree for leaf in _leaves(v)]


@pytest.mark.parametrize("ingest_digest", [False, True])
def test_tick_step_scan_bit_equal_to_serial(warm_state, ingest_digest):
    """Bit for bit: four 3-slot ticks (the second has two 5m bars, so its
    slots are front-padded with an empty one) through :func:`tick_step_scan`
    give the serial folds' and wire steps' wires and final state; the grid
    policy's recursion on the device gives the host's verdicts."""
    st0, rng, (px5, px15), t15, t5 = warm_state
    rng = np.random.default_rng(11)
    ticks = []  # per tick: (5m batches, 15m batches, ts15 evaluated, ts5)
    c15, c5 = t15, t5
    for i in range(4):
        n5 = 2 if i == 1 else 3
        b15, px15 = _bars(rng, px15, 1, 900)
        b5, px5 = _bars(rng, px5, n5, 300)
        batches5 = [_batch(c5 + 300 * j, b5[j]) for j in range(n5)]
        c5 += 300 * 3
        ticks.append((batches5, [_batch(c15, b15[0])], c15, c5 - 300))
        c15 += 900
    momentum = [True, False, True, True]

    # serial: the engine's fold order, the policy resolved on the host
    st = st0
    serial_wires = []
    prev_valid, prev_regime = False, -1
    for (b5, b15, ts15, ts5), mok in zip(ticks, momentum):
        empty = (np.zeros(0, np.int32), np.zeros(0, np.int32), np.zeros((0, NUM_FIELDS), np.float32))
        n = max(len(b5), len(b15))
        pairs = [(_t(b5[i] if i < len(b5) else empty), _t(b15[i] if i < len(b15) else empty))
                 for i in range(n)]
        counts = torch.zeros(8, dtype=torch.float32) if ingest_digest else None
        for a, b in pairs[:-1]:
            if ingest_digest:
                st, counts = tstep.apply_updates_carry_step_counted(st, a, b, 0, counts)
            else:
                st = tstep.apply_updates_carry_step(st, a, b, btc_row=0)
        allow = mok and prev_valid and prev_regime in POLICY_REGIMES
        st, wire = tstep.tick_step_wire(
            st, *pairs[-1], _inputs(ts15, ts5, allow), incremental=True,
            ingest_digest=ingest_digest, ingest_fold_counts=counts,
        )
        prev_valid, prev_regime = bool(wire[0] > 0.5), int(wire[1])
        serial_wires.append(wire)

    # the scan: each tick's slots at the tail of depth 3, rows padded to 8
    depth, T = 3, 4
    r = np.full((2, T, depth, S_UNIT), -1, np.int32)
    ts = np.full((2, T, depth, S_UNIT), -1, np.int32)
    v = np.zeros((2, T, depth, S_UNIT, NUM_FIELDS), np.float32)
    for i, (b5, b15, _, _) in enumerate(ticks):
        n = max(len(b5), len(b15))
        for k, batches in enumerate((b5, b15)):
            for d, (br, bt, bv) in enumerate(batches):
                r[k, i, depth - n + d], ts[k, i, depth - n + d], v[k, i, depth - n + d] = br, bt, bv
    upd = [tuple(torch.from_numpy(x[k]) for x in (r, ts, v)) for k in range(2)]
    per_tick = [_inputs(ts15, ts5, False) for _, _, ts15, ts5 in ticks]
    inputs_seq = tstep.HostInputs(*(torch.stack(xs) for xs in zip(*per_tick)))
    st_scan, wires, fired = tstep.tick_step_scan(
        st0, upd[0], upd[1], inputs_seq, torch.tensor(momentum),
        (torch.tensor(False), torch.tensor(-1, dtype=torch.int32)),
        incremental=True, ingest_digest=ingest_digest,
    )
    for i in range(T):
        assert torch.equal(_bits(wires[i]), _bits(serial_wires[i])), f"tick {i}"
    assert torch.equal(fired, wires[:, tstep.WIRE_FIRED_COUNT_OFF])
    for a, b in zip(_leaves(st_scan), _leaves(st), strict=True):
        assert torch.equal(_bits(a), _bits(b))


def _fold_slots(rng, T, S, W_shift):
    """T stacked update slots per interval with padded rows (-1) and one
    all-padding slot: ``(rows (T, U), ts (T, U), vals (T, U, F))``."""
    U = S + 4
    out = []
    for interval in (300, 900):
        rows = np.full((T, U), -1, np.int32)
        ts = np.full((T, U), -1, np.int32)
        vals = np.zeros((T, U, NUM_FIELDS), np.float32)
        for t in range(T):
            if t == 3:
                continue  # an all-padding slot
            keep = rng.random(S) < 0.8
            r = np.flatnonzero(keep).astype(np.int32)
            rows[t, : len(r)] = r
            ts[t, : len(r)] = T0 + interval * (t - W_shift)
            vals[t, : len(r)] = rng.random((len(r), NUM_FIELDS)).astype(np.float32) + 1.0
        out.append((rows, ts, vals))
    return out


@pytest.mark.parametrize("counted", [False, True])
def test_apply_updates_scan_bit_equal(counted):
    """Bit for bit: :func:`apply_updates_scan` (``counted``: its counted
    twin) of 12 stacked slots equals 12 serial folds and the reference's
    scan on the same slots (rings; counts)."""
    import jax.numpy as jnp

    S, W, T = 16, 40, 12
    rng = np.random.default_rng(3)
    s5, s15 = _fold_slots(rng, T, S, W_shift=T)
    st = tstep.initial_engine_state(S, W, device="cpu")
    t5 = tuple(torch.from_numpy(x) for x in s5)
    t15 = tuple(torch.from_numpy(x) for x in s15)
    serial = st
    counts0 = torch.zeros(8, dtype=torch.float32)
    c_serial = counts0
    for t in range(T):
        a, b = tuple(x[t] for x in t5), tuple(x[t] for x in t15)
        if counted:
            serial, c_serial = tstep.apply_updates_step_counted(serial, a, b, c_serial)
        else:
            serial = tstep.apply_updates_step(serial, a, b)
    jst = jstep.initial_engine_state(S, window=W)
    if counted:
        got, c_got = tstep.apply_updates_scan_counted(st, t5, t15, counts0)
        jgot, jc = jstep.apply_updates_scan_counted(
            jst, s5, s15, jnp.zeros((8,), jnp.float32)
        )
        assert torch.equal(c_got, c_serial)
        np.testing.assert_array_equal(c_got.numpy(), np.asarray(jc))
        assert c_got[0] > 0
    else:
        got = tstep.apply_updates_scan(st, t5, t15)
        jgot = jstep.apply_updates_scan(jst, s5, s15)
    for name in ("buf5", "buf15"):
        for f in ("times", "values", "filled", "cursor"):
            a = getattr(getattr(got, name), f)
            assert torch.equal(_bits(a), _bits(getattr(getattr(serial, name), f))), (name, f)
            ref = np.asarray(getattr(getattr(jgot, name), f))
            if ref.dtype == np.float32:
                ref = ref.view(np.int32)
            np.testing.assert_array_equal(_bits(a).numpy(), ref, err_msg=f"{name}.{f}")


@pytest.mark.parametrize("numeric_digest,ingest_digest",
                         [(False, False), (True, False), (True, True)])
def test_unpack_wire_block_matches_per_tick(numeric_digest, ingest_digest):
    """Exact: :func:`unpack_wire_block` returns the per-tick
    :func:`unpack_wire` tuples (values, dtypes, overflow flags, digest
    blocks) on the reference's synthetic wires, an overflow tick among
    them."""
    from tests.test_backtest_ext import _synthetic_wires

    T, S = 7, 16
    wires = _synthetic_wires(T, S, numeric_digest, ingest_digest, seed=3, overflow_tick=4)
    batch = tstep.unpack_wire_block(wires, numeric_digest=numeric_digest,
                                    ingest_digest=ingest_digest)
    assert len(batch) == T
    for t in range(T):
        ref_fired, ref_ctx = tstep.unpack_wire(wires[t], numeric_digest=numeric_digest,
                                               ingest_digest=ingest_digest)
        got_fired, got_ctx = batch[t]
        assert (got_fired.n, got_fired.overflow) == (ref_fired.n, ref_fired.overflow)
        for f in ("strategy_idx", "row", "autotrade", "direction", "score", "stop_loss_pct",
                  "payload"):
            rv, gv = getattr(ref_fired, f), getattr(got_fired, f)
            assert rv.dtype == gv.dtype, f
            np.testing.assert_array_equal(rv, gv, err_msg=f)
        assert set(ref_ctx) == set(got_ctx)
        for k, rv in ref_ctx.items():
            gv = got_ctx[k]
            if isinstance(rv, np.ndarray):
                np.testing.assert_array_equal(rv, gv, err_msg=k)
            else:
                assert type(rv) is type(gv) and rv == gv, k
    assert batch[4][0].overflow


@pytest.mark.slow
def test_scanned_overflow_chunk_redrives_serially(tmp_path):
    """Exact: on the reference's burst market (160 symbols; the crash tick
    fires more pairs than the wire's 128 slots inside a chunk) the scanned
    drive re-drives that chunk serially and emits the serial drive's set;
    earlier chunks still fuse."""
    path = tmp_path / "burst.jsonl"
    jreplay.generate_burst_replay(path, n_symbols=160, n_ticks=108)
    seq = treplay.tick_seq(path)
    runs = {}
    for scanned in (False, True):
        eng = treplay.make_stub_engine(capacity=192, window=200, device="cpu",
                                       incremental=True, **PINS)
        runs[scanned] = (treplay.signal_tuples(_drive(eng, seq, scanned)), eng)
    (serial, e_serial), (scan, e_scan) = runs[False], runs[True]
    assert sorted(serial) == sorted(scan)
    assert e_serial.overflow_ticks >= 1
    assert e_scan.scan_overflow_reruns >= 1 and e_scan.overflow_ticks >= 1
    assert e_scan.scanned_ticks > 0
