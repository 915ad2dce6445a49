"""The signal-outcome observatory: the port against the reference.

* The maturation gather on seeded 5m rings, both packages on the same
  numpy inputs: padding slots (row -1), a horizon bar missing from the
  ring, a window the ring has clipped (an entry before its oldest bar), an
  entry with no bar at or before it, and rows rotated to a mid-phase
  cursor. The float32 (4, K) and int32 (2, K) outputs must be bit-equal, and
  a rotated ring must give what its canonical order gives.
* The tracker cases of ``tests/test_outcomes.py`` on the port's tracker:
  the cap and its eviction, snapshot and restore of the open registry,
  maturation with the scoreboard, truncation; the sign convention; the
  instruments move under the reference's metric names.
* The matured set of the port's replay against the reference's on
  ``generate_outcome_replay`` (capacity 8, window 160, horizons 1/4/16,
  MeanReversionFade, incremental): the reference's serial drive with the
  tracker on, the port's production loop (depth 1, rings in place). The
  sets must be equal.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from binquant_tpu.engine.buffer import NUM_FIELDS, Field
from binquant_tpu.io import replay as jreplay
from binquant_tpu.obs import outcomes as jout
from binquant_tpu_torch.io import replay as treplay
from binquant_tpu_torch.obs import outcomes as tout
from binquant_tpu_torch.obs.instruments import OUTCOME_EVICTIONS
from binquant_tpu_torch.obs.registry import REGISTRY

# small shapes: extra intra-op threads only spin and crowd parallel test workers
torch.set_num_threads(1)

CAP, WIN = 8, 160
HORIZONS = (1, 4, 16)
ENABLED = {"mean_reversion_fade"}
FIRE_TICKS = (104, 110)
N_TICKS = 128


def _ring(closes, t0=300_000, step=300, n_rows=2):
    W = len(closes)
    times = np.full((n_rows, W), -1, np.int32)
    vals = np.full((n_rows, W, NUM_FIELDS), np.nan, np.float32)
    for k, c in enumerate(closes):
        times[0, k] = t0 + k * step
        vals[0, k, Field.CLOSE] = c
        vals[0, k, Field.HIGH] = c * 1.01
        vals[0, k, Field.LOW] = c * 0.99
    return times, vals, t0


class _Buf:
    def __init__(self, times, values):
        self.times = torch.from_numpy(times)
        self.values = torch.from_numpy(values)


# -- the gather ---------------------------------------------------------------

S, W = 12, 96
T0 = 1_780_272_000


@pytest.fixture(scope="module")
def rings():
    rng = np.random.default_rng(61)
    close = 50 * np.exp(np.cumsum(rng.normal(0, 0.004, (S, W)), axis=1))
    times = np.broadcast_to((T0 + 300 * np.arange(W)).astype(np.int32), (S, W)).copy()
    vals = np.full((S, W, NUM_FIELDS), np.nan, np.float32)
    vals[:, :, Field.CLOSE] = close
    vals[:, :, Field.HIGH] = close * (1 + rng.random((S, W)) * 0.01)
    vals[:, :, Field.LOW] = close * (1 - rng.random((S, W)) * 0.01)
    times[3, 40:44] = -1  # missing bars: row 3's horizon bar at column 42 among them
    vals[3, 40:44] = np.nan
    times[5, :30] = -1  # a short row: its window before column 30 is clipped
    vals[5, :30] = np.nan
    times[7] = -1  # an empty row
    vals[7] = np.nan
    # the same rings rotated to mid-phase cursors, as rings written in place
    rot_t, rot_v = times.copy(), vals.copy()
    for r in range(S):
        rot_t[r] = np.roll(times[r], 13 * r)
        rot_v[r] = np.roll(vals[r], 13 * r, axis=0)
    return dict(canonical=(times, vals), rotated=(rot_t, rot_v))


def _pairs():
    """(rows, entry, horizon): 24 pairs padded to 32 with -1 rows."""
    spec = [
        (0, 20, 1), (0, 20, 4), (0, 20, 16), (1, 60, 16), (2, 90, 4),  # horizon past the ring
        (3, 38, 4), (3, 39, 1), (3, 40, 2),  # missing bars in the window / at the entry
        (4, 0, 8), (4, -3, 2),  # an entry at the first bar, one before it
        (5, 20, 4), (5, 29, 16), (5, 30, 4),  # clipped windows, then a whole one
        (6, 70, 16), (7, 10, 4),  # an empty row
        (8, 95, 1), (9, 50, 96), (10, 33, 4), (11, 80, 16), (2, 10, 96),
        (6, 5, 1), (8, 47, 4), (9, 94, 1), (10, 1, 16),
    ]
    K = 32
    rows = np.full(K, -1, np.int32)
    entry = np.zeros(K, np.int32)
    horizon = np.zeros(K, np.int32)
    for i, (r, col, h) in enumerate(spec):
        rows[i], entry[i] = r, T0 + 300 * col
        horizon[i] = entry[i] + 300 * h
    return rows, entry, horizon


@pytest.mark.parametrize("layout", ("canonical", "rotated"))
def test_gather_matches_reference_bit_for_bit(rings, layout):
    times, vals = rings[layout]
    rows, entry, horizon = _pairs()
    jf, ji = jout.outcome_gather(times, vals, rows, entry, horizon)
    tf, ti = tout.outcome_gather(torch.from_numpy(times), torch.from_numpy(vals), rows, entry,
                                 horizon)
    assert tf.dtype == jf.dtype == np.float32 and ti.dtype == ji.dtype == np.int32
    assert tf.shape == (4, 32) and ti.shape == (2, 32)
    np.testing.assert_array_equal(tf.view(np.int32), jf.view(np.int32))
    np.testing.assert_array_equal(ti, ji)
    # the cases the pairs were chosen for are there
    assert np.isnan(tf[:, 24:]).all() and (ti[0, 24:] == 0).all()  # padding
    assert ti[0, 5] < 4 and ti[1, 10] > entry[10]  # a missing bar; a clipped window
    assert np.isnan(tf[0, 9])  # no bar at or before the entry


def test_rotated_ring_gathers_what_the_canonical_one_does(rings):
    rows, entry, horizon = _pairs()
    a = tout.outcome_gather(*map(torch.from_numpy, rings["canonical"]), rows, entry, horizon)
    b = tout.outcome_gather(*map(torch.from_numpy, rings["rotated"]), rows, entry, horizon)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.view(np.int32), y.view(np.int32))


def test_gather_kernel_math():
    closes = [100, 101, 102, 103, 104, 105, 104, 103, 102, 101]
    times, vals, t0 = _ring(closes)
    entry_ts = t0 + 2 * 300
    rows = np.array([0, 0, -1, -1], np.int32)
    entry = np.array([entry_ts, entry_ts, 0, 0], np.int32)
    horizon = np.array([entry_ts + 300, entry_ts + 4 * 300, 0, 0], np.int32)
    floats, ints = tout.outcome_gather(torch.from_numpy(times), torch.from_numpy(vals), rows,
                                       entry, horizon)
    assert floats[0, 0] == closes[2]
    assert floats[1, 0] == closes[3]
    assert floats[1, 1] == closes[6]
    assert ints[0, 1] == 4
    assert np.isclose(floats[3, 1], max(closes[3:7]) * 1.01)
    assert np.isclose(floats[2, 1], min(closes[3:7]) * 0.99)
    assert np.isnan(floats[0, 2]) and ints[0, 2] == 0
    assert ints[1, 0] == t0


def test_signed_outcome_convention():
    assert tout.signed_outcome(1, 100.0, 103.0, 99.0, 104.0) == jout.signed_outcome(
        1, 100.0, 103.0, 99.0, 104.0)
    fwd, mae, mfe = tout.signed_outcome(-1, 100.0, 103.0, 99.0, 104.0)
    assert fwd == pytest.approx(-0.03) and mae == pytest.approx(-0.04)
    assert mfe == pytest.approx(0.01)
    assert tout.signed_outcome(1, 100.0, 101.0, 100.5, 102.0)[1] == 0.0
    assert tout.signed_outcome(1, float("nan"), 1.0, 1.0, 1.0) is None
    assert tout.signed_outcome(1, 0.0, 1.0, 1.0, 1.0) is None
    for d in ("SHORT", "LONG", "grid", 1, "1"):
        assert tout.direction_sign(d) == jout.direction_sign(d)
    assert [tout._pow2(n) for n in (0, 8, 9, 1000)] == [jout._pow2(n) for n in (0, 8, 9, 1000)]


# -- the tracker ----------------------------------------------------------------


def test_tracker_cap_eviction_and_restore():
    before = OUTCOME_EVICTIONS.value
    tr = tout.OutcomeTracker(enabled=True, horizons=(1, 4), cap=2)
    for i, sym in enumerate(("A", "B", "C")):
        tr.register("s", sym, 0, 300_000, "LONG", tick_ms=i)
    assert tr.evictions == 1 and OUTCOME_EVICTIONS.value == before + 1
    assert [s["symbol"] for s in tr._open] == ["B", "C"]
    blob = json.loads(json.dumps(tr.snapshot_open()))
    tr2 = tout.OutcomeTracker(enabled=True, horizons=(1, 4), cap=4)
    tr2.restore_open(blob)
    assert [s["symbol"] for s in tr2._open] == ["B", "C"]
    assert tr2._open[0]["pending"] == [1, 4]
    # the reference's tracker takes the port's snapshot, and the reverse
    jtr = jout.OutcomeTracker(enabled=True, horizons=(1, 4), cap=4)
    jtr.restore_open(blob)
    assert jtr.snapshot_open() == tr2.snapshot_open()
    # a disabled tracker adopts nothing
    off = tout.OutcomeTracker(enabled=False)
    off.restore_open(blob)
    assert not off._open and not tout.OutcomeTracker(horizons=(0,)).enabled


def test_tracker_matures_and_scoreboard():
    closes = [100, 101, 102, 103, 104, 105, 104, 103, 102, 101]
    times, vals, t0 = _ring(closes)
    trackers = (tout.OutcomeTracker(enabled=True, horizons=(1, 4), cap=8),
                jout.OutcomeTracker(enabled=True, horizons=(1, 4), cap=8))
    bufs = (_Buf(times, vals), type("B", (), {"times": times, "values": vals}))
    for tr, buf in zip(trackers, bufs):
        tr.register("s", "LONGY", 0, t0 + 2 * 300, "LONG", tick_ms=1)
        tr.register("s", "SHORTY", 0, t0 + 2 * 300, "SHORT", tick_ms=2)
        assert tr.on_tick(t0 + 2 * 300, buf) == []  # nothing due at the entry tick
    matured = trackers[0].on_tick(t0 + 6 * 300, bufs[0])
    assert matured == trackers[1].on_tick(t0 + 6 * 300, bufs[1])
    assert len(matured) == 4 and not trackers[0]._open
    board = trackers[0].scoreboard()
    assert board == trackers[1].scoreboard()
    assert board["matured"] == 4 and board["truncated"] == 0
    cell = board["per_strategy"]["s"]["4"]
    assert cell["n"] == 2 and cell["hit_rate"] == 0.5
    assert cell["avg_fwd"] == pytest.approx(0.0, abs=1e-9)
    (timing,) = trackers[0].timings  # one maturation tick: gather, copy, fold
    assert timing["pairs"] == 4 and min(timing[k] for k in timing) >= 0
    hist = REGISTRY.get("bqt_signal_forward_return").labels(strategy="s", horizon="4")
    assert hist.count >= 2


def test_tracker_truncation_detected():
    closes = [100, 101, 102, 103]
    times, vals, t0 = _ring(closes)
    tr = tout.OutcomeTracker(enabled=True, horizons=(1,), cap=8)
    tr.register("s", "OLD", 0, t0 - 300, "LONG", tick_ms=1)
    tr.on_tick(t0 + 3 * 300, _Buf(times, vals))
    assert tr.truncated == 1 and tr.matured == 1
    assert not tr.matured_set()


# -- the replay: matured sets ----------------------------------------------------


@pytest.fixture(scope="module")
def stream(tmp_path_factory):
    path = tmp_path_factory.mktemp("torch_outcomes") / "stream.jsonl"
    treplay.generate_outcome_replay(path, n_symbols=CAP, n_ticks=N_TICKS,
                                    fire_ticks=FIRE_TICKS)
    ref = path.with_name("ref.jsonl")
    jreplay.generate_outcome_replay(ref, n_symbols=CAP, n_ticks=N_TICKS, fire_ticks=FIRE_TICKS)
    assert ref.read_bytes() == path.read_bytes()
    return path


def test_replay_matured_set_equals_reference(stream):
    jsig: list = []
    jmat: list = []
    jstats = jreplay.run_replay(
        stream, capacity=CAP, window=WIN, enabled_strategies=ENABLED, incremental=True,
        donate=False, collect=jsig, outcomes=True, outcome_horizons=HORIZONS,
        collect_outcomes=jmat,
    )
    tsig: list = []
    tmat: list = []
    tstats = treplay.run_replay(
        stream, capacity=CAP, window=WIN, enabled_strategies=ENABLED, incremental=True,
        device="cpu", collect=tsig, outcome_horizons=HORIZONS, collect_outcomes=tmat,
    )
    assert tsig == jsig and len(jsig) >= 2
    assert len(jmat) >= len(HORIZONS) * 2
    assert tmat == jmat
    board, ref = tstats["outcomes"], jstats["outcomes"]
    for k in ("registered", "matured", "truncated", "evictions", "open", "per_strategy"):
        assert board[k] == ref[k], k
