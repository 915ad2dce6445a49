"""One classic wire step: the port against the reference from one state.

A seeded numpy state (two canonical rings, a regime carry with a previous
context, dedupe/cooldown carries) is loaded into both packages — the port's
through ``engine_state_from_numpy`` — and both run one wire step
(``incremental=False``, ``maintain_carry=False``, digests off) on the same
update batches: an append for every row, a same-bar correction, a stale
insert and an out-of-range row.

Contract: the wire lengths are equal; the fired block (count, strategy, row,
autotrade, direction) matches exactly; context codes, flags and timestamps
match exactly; float scalars, scores and the per-slot payload match at
rtol=1e-5 with an absolute floor of 1e-6 of their scale (cumsum/EWM/sum
orders differ); the returned rings match bit for bit and the carries
exactly or within the same float tolerance. Dtypes of every state leaf and
of the wire are pinned. Emission of each wire gives the same signals and
analytics records in both packages, and a forced compaction overflow emits
the same signals from the step's full outputs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from binquant_tpu.engine import buffer as jbuf
from binquant_tpu.engine import step as jstep
from binquant_tpu.io import emission as jemission
from binquant_tpu.regime.context import ContextConfig as JCfg
from binquant_tpu.regime.context import RegimeCarry as JCarry
from binquant_tpu_torch.engine import step as tstep
from binquant_tpu_torch.engine.buffer import FrozenRows
from binquant_tpu_torch.engine.convert import engine_state_from_numpy, engine_state_to_numpy
from binquant_tpu_torch.io import emission as temission
from binquant_tpu_torch.regime.context import ContextConfig as TCfg

# small shapes: extra intra-op threads only spin and crowd parallel test workers
torch.set_num_threads(1)

S, W, F = 32, 200, jbuf.NUM_FIELDS
T15 = 1_780_272_000  # evaluated 15m bar open
T5 = T15 + 600  # evaluated 5m bar open (the bucket's last 5m bar)
KEY = tuple(sorted(jstep.LIVE_STRATEGIES))


def _ring(rng, t_last: int, interval: int, filled: np.ndarray) -> dict:
    rets = rng.normal(0, 0.006, (S, W))
    rets[4] -= 0.008  # oversold row
    close = 40 * np.exp(np.cumsum(rets, axis=1))
    open_ = np.concatenate([close[:, :1], close[:, :-1]], axis=1)
    high = np.maximum(open_, close) * 1.002
    low = np.minimum(open_, close) * 0.998
    vol = np.abs(rng.normal(1000, 200, (S, W)))
    vals = np.stack(
        [open_, high, low, close, vol, vol * close, np.full_like(close, 300.0),
         vol / 2, vol * close / 2, np.full_like(close, float(interval))], axis=-1,
    ).astype(np.float32)
    times = np.broadcast_to(
        (t_last - interval * np.arange(W - 1, -1, -1)).astype(np.int32), (S, W)
    ).copy()
    for r in range(S):
        times[r, : W - filled[r]] = -1
        vals[r, : W - filled[r]] = np.nan
    # a ring with a mid-phase cursor: rotate rows so the newest bar is not last
    cursor = (np.arange(S) * 7 % W).astype(np.int32)
    cursor[filled < W] = 0
    for r in range(S):
        times[r] = np.roll(times[r], cursor[r])
        vals[r] = np.roll(vals[r], cursor[r], axis=0)
    return {"times": times, "values": vals, "filled": filled.copy(), "cursor": cursor}


def _update(rng, ring: dict, ts: int, interval: int):
    """An append for every filled row, plus a correction, a stale insert and
    an out-of-range row."""
    rows = np.arange(S, dtype=np.int32)
    last_close = np.array(
        [ring["values"][r, (ring["cursor"][r] - 1) % W, 3] for r in range(S)], np.float32
    )
    c = np.where(np.isfinite(last_close), last_close, 40.0) * (1 + rng.normal(0, 0.006, S))
    o = np.where(np.isfinite(last_close), last_close, 40.0)
    v = np.abs(rng.normal(1000, 200, S))
    vals = np.stack([o, np.maximum(o, c) * 1.002, np.minimum(o, c) * 0.998, c, v, v * c,
                     np.full(S, 300.0), v / 2, v * c / 2, np.full(S, float(interval))],
                    axis=-1).astype(np.float32)
    ts_arr = np.full(S, ts, np.int32)
    ts_arr[2] = ts - interval  # correction of the newest stored bar
    ts_arr[3] = ts - interval * W * 3  # stale insert -> dropped
    return (np.concatenate([rows, [-1, S + 4]]).astype(np.int32),
            np.concatenate([ts_arr, [ts, ts]]).astype(np.int32),
            np.concatenate([vals, vals[:2]]))


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(31)
    filled = np.full(S, W, np.int32)
    filled[[5, 6]] = [150, 60]
    filled[7] = 0
    leaves = {
        "buf5": _ring(rng, T5 - 300, 300, filled),
        "buf15": _ring(rng, T15 - 900, 900, filled),
        "mrf_last_emitted": np.full(S, -1, np.int32),
        "pt_last_signal_close": np.full(S, -1, np.int32),
    }
    leaves["pt_last_signal_close"][9] = T5 - 600
    carry = {k: np.asarray(v) for k, v in jstep.initial_regime_carry(S)._asdict().items()}
    carry.update(
        has_prev=np.asarray(True), market_regime=np.asarray(3, np.int32),
        stable_since=np.asarray(T15 - 7200, np.int32),
        stage_ts=np.asarray(T15 - 900, np.int32), stage_valid=np.asarray(True),
        stage_regime=np.asarray(3, np.int32),
        stage_scores=np.asarray([0.3, 0.2, 0.55, 0.1], np.float32),
        stage_stable_since=np.asarray(T15 - 7200, np.int32),
    )
    leaves["regime_carry"] = carry
    u5 = _update(rng, leaves["buf5"], T5, 300)
    u15 = _update(rng, leaves["buf15"], T15, 900)

    tracked = filled > 0
    nan = np.float32(np.nan)
    jin = jstep.default_host_inputs(S)._replace(
        tracked=jnp.asarray(tracked), btc_row=jnp.int32(0), timestamp_s=jnp.int32(T15),
        timestamp5_s=jnp.int32(T5), adp_latest=jnp.float32(-0.44),
        adp_prev=jnp.float32(-0.47), adp_diff=jnp.float32(0.03), adp_diff_prev=nan,
        breadth_momentum_points=jnp.float32(4.0), grid_policy_allows=jnp.asarray(True),
    )
    tin = tstep.default_host_inputs(S, device="cpu")._replace(
        tracked=torch.from_numpy(tracked), btc_row=torch.tensor(0, dtype=torch.int32),
        timestamp_s=torch.tensor(T15, dtype=torch.int32),
        timestamp5_s=torch.tensor(T5, dtype=torch.int32),
        adp_latest=torch.tensor(-0.44), adp_prev=torch.tensor(-0.47),
        adp_diff=torch.tensor(0.03), breadth_momentum_points=torch.tensor(4.0),
        grid_policy_allows=torch.tensor(True),
    )
    jstate = jstep.EngineState(
        buf5=jbuf.MarketBuffer(*(jnp.asarray(leaves["buf5"][f]) for f in jbuf.MarketBuffer._fields)),
        buf15=jbuf.MarketBuffer(*(jnp.asarray(leaves["buf15"][f]) for f in jbuf.MarketBuffer._fields)),
        regime_carry=JCarry(**{k: jnp.asarray(v) for k, v in carry.items()}),
        mrf_last_emitted=jnp.asarray(leaves["mrf_last_emitted"]),
        pt_last_signal_close=jnp.asarray(leaves["pt_last_signal_close"]),
        indicator_carry=jstep.empty_indicator_carry(S),
    )
    cfg = dict(required_fresh_symbols=4, min_coverage_ratio=0.5)
    return dict(
        jargs=(jstate, tuple(map(jnp.asarray, u5)), tuple(map(jnp.asarray, u15)), jin,
               JCfg(**cfg)),
        targs=(engine_state_from_numpy(leaves, "cpu"), tuple(map(torch.from_numpy, u5)),
               tuple(map(torch.from_numpy, u15)), tin, TCfg(**cfg)),
    )


@pytest.fixture(scope="module")
def stepped(inputs):
    jnew, jwire = jstep.tick_step_wire(
        *inputs["jargs"], wire_enabled=KEY, incremental=False, maintain_carry=False
    )
    tnew, twire = tstep.tick_step_wire(
        *inputs["targs"], wire_enabled=KEY, incremental=False, maintain_carry=False
    )
    return jnew, np.asarray(jwire), tnew, twire


def test_wire_length_and_dtype(stepped):
    _, jw, _, tw = stepped
    assert tw.dtype == torch.float32 and jw.dtype == np.float32
    assert tw.shape == jw.shape == (tstep.wire_length(S),)


def test_fired_block_exact(stepped):
    _, jw, _, tw = stepped
    tw = tw.numpy()
    off, K = tstep.WIRE_FIRED_COUNT_OFF, tstep.WIRE_MAX_FIRED
    assert jw[off] == tw[off] and jw[off] > 0  # something fired
    jb = jw[off + 1: off + 1 + 6 * K].reshape(6, K)
    tb = tw[off + 1: off + 1 + 6 * K].reshape(6, K)
    np.testing.assert_array_equal(jb[:4], tb[:4])
    np.testing.assert_allclose(tb[4:], jb[4:], rtol=1e-5, atol=1e-6)


def test_scalars_and_payload_within_contract(stepped):
    _, jw, _, tw = stepped
    jf, jctx = jstep.unpack_wire(jw)
    tf, tctx = tstep.unpack_wire(tw.numpy())
    exact = {"valid", "market_regime", "previous_market_regime", "market_regime_transition",
             "regime_is_transitioning", "fresh_count", "timestamp", "regime_stable_since"}
    for k in jstep.WIRE_SCALARS_A + jstep.WIRE_SCALARS_B + ("timestamp", "regime_stable_since"):
        if k in exact:
            assert jctx[k] == tctx[k], k
        else:
            np.testing.assert_allclose(tctx[k], jctx[k], rtol=1e-5, atol=1e-6, err_msg=k)
    np.testing.assert_array_equal(jctx["calib_valid"], tctx["calib_valid"])
    np.testing.assert_array_equal(jctx["calib_close"], tctx["calib_close"])
    np.testing.assert_allclose(tctx["calib_atr_pct"], jctx["calib_atr_pct"], rtol=1e-5, atol=1e-7)
    assert jf.payload.shape == tf.payload.shape and len(jf.row) > 0
    scale = np.maximum(np.abs(jf.payload), 1.0)
    assert np.all(np.abs(tf.payload - jf.payload) <= 1e-5 * scale), np.abs(tf.payload - jf.payload).max()


def test_emission_layout_matches(stepped):
    assert tstep.EMISSION_LAYOUTS[KEY] == jstep.EMISSION_LAYOUTS[KEY]


def test_returned_state_leaves_match(stepped):
    jnew, _, tnew, _ = stepped
    got = engine_state_to_numpy(tnew)
    for ring in ("buf5", "buf15"):
        for f in jbuf.MarketBuffer._fields:
            a, b = np.asarray(getattr(getattr(jnew, ring), f)), got[ring][f]
            assert a.dtype == b.dtype, (ring, f)
            np.testing.assert_array_equal(np.nan_to_num(a, nan=-3.0), np.nan_to_num(b, nan=-3.0))
    for k in ("mrf_last_emitted", "pt_last_signal_close"):
        a = np.asarray(getattr(jnew, k))
        assert a.dtype == got[k].dtype == np.int32
        np.testing.assert_array_equal(a, got[k])
    for k, b in got["regime_carry"].items():
        a = np.asarray(getattr(jnew.regime_carry, k))
        assert a.dtype == b.dtype and a.shape == b.shape, k
        if a.dtype.kind == "f":
            np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-6, err_msg=k)
        else:
            np.testing.assert_array_equal(a, b, err_msg=k)
    assert tnew.indicator_carry is None


ROWS = FrozenRows({r: f"S{r:03d}USDT" for r in range(S)})


def _signals(fired) -> list[tuple]:
    return [(f.strategy, f.symbol, f.row, f.value.direction, f.value.autotrade) for f in fired]


def _check_analytics(ref, out, key="analytics") -> None:
    """Equal structure and values; floats (indicators, rounded band levels)
    within the float contract."""
    if isinstance(ref, dict):
        assert ref.keys() == out.keys(), key
        for k in ref:
            if k != "generated_at":  # the emission's wall clock
                _check_analytics(ref[k], out[k], k)
    elif isinstance(ref, float):
        np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6, err_msg=key)
    else:
        assert ref == out, key


def test_emission_matches_reference(stepped):
    _, jw, _, tw = stepped
    jfired = jemission.extract_fired(
        None, ROWS, env="CI", unpacked=jstep.unpack_wire(jw),
        diag_layout=jstep.EMISSION_LAYOUTS[KEY],
    )
    tfired = temission.extract_fired(
        None, ROWS, env="CI", unpacked=tstep.unpack_wire(tw.numpy()),
        diag_layout=tstep.EMISSION_LAYOUTS[KEY],
    )
    assert _signals(tfired) == _signals(jfired) and tfired
    for j, t in zip(jfired, tfired):
        _check_analytics(j.analytics, t.analytics)


def test_overflow_emission_reads_the_full_outputs(inputs, stepped):
    # a wire whose fired count exceeds its 128 slots makes emission read the
    # full step's summary and tensors; both routes must emit the same signals
    _, _, _, tw = stepped
    _, outputs = tstep.tick_step(
        *inputs["targs"], wire_enabled=KEY, incremental=False, maintain_carry=False
    )
    wire = outputs.wire.numpy().copy()
    np.testing.assert_array_equal(wire, tw.numpy())
    wire[tstep.WIRE_FIRED_COUNT_OFF] = tstep.WIRE_MAX_FIRED + 1
    unpacked = tstep.unpack_wire(wire)
    assert unpacked[0].overflow
    layout = tstep.EMISSION_LAYOUTS[KEY]
    over = temission.extract_fired(outputs, ROWS, env="CI", unpacked=unpacked,
                                   diag_layout=layout)
    via_wire = temission.extract_fired(None, ROWS, env="CI",
                                       unpacked=tstep.unpack_wire(tw.numpy()),
                                       diag_layout=layout)
    assert _signals(over) == _signals(via_wire) and over
    for a, b in zip(via_wire, over):
        _check_analytics(a.analytics, b.analytics)


# --------------------------------------------------------------------------
# the same tick with both digests on, a NaN close smuggled past the gate,
# and the same tick in place
# --------------------------------------------------------------------------

# a full, tracked row (not BTC): the gate promises its values finite. Only
# its 5m close is poisoned: a NaN 15m close would turn the market context's
# aggregates NaN too and silence every strategy
POISON_ROW = 10
# a gate margin is the distance of an RSI/MFI (0-100 points) from its
# threshold: it carries that indicator's few-ulp difference at its scale
MARGIN_TOL = 8 * float(np.spacing(np.float32(100.0)))


def _poisoned(upd, to):
    rows, ts, vals = (np.array(a) for a in upd)
    vals[POISON_ROW, jbuf.Field.CLOSE] = np.nan
    return tuple(to(a) for a in (rows, ts, vals))


@pytest.fixture(scope="module")
def digest_stepped(inputs):
    jstate, ju5, ju15, jin, jcfg = inputs["jargs"]
    tstate, tu5, tu15, tin, tcfg = inputs["targs"]
    jargs = (jstate, _poisoned(ju5, jnp.asarray), ju15, jin, jcfg)
    targs = (tstate, _poisoned(tu5, torch.from_numpy), tu15, tin, tcfg)
    paths = dict(wire_enabled=KEY, incremental=False, maintain_carry=False)
    _, jwire = jstep.tick_step_wire(*jargs, **paths, numeric_digest=True, ingest_digest=True)
    _, twire = tstep.tick_step_wire(*targs, **paths, numeric_digest=True, ingest_digest=True)
    _, toff = tstep.tick_step_wire(*targs, **paths)
    return np.asarray(jwire), twire.numpy(), toff.numpy()


def test_digest_wire_is_an_append_to_the_plain_wire(digest_stepped):
    jw, tw, toff = digest_stepped
    assert tw.shape == jw.shape == (tstep.wire_length(S, True, True),)
    assert toff.shape == (tstep.wire_length(S),)
    np.testing.assert_array_equal(tw[: len(toff)].view(np.int32), toff.view(np.int32))
    off, K = tstep.WIRE_FIRED_COUNT_OFF, tstep.WIRE_MAX_FIRED
    assert jw[off] == tw[off] and jw[off] > 0
    np.testing.assert_array_equal(jw[off + 1: off + 1 + 4 * K], tw[off + 1: off + 1 + 4 * K])


def test_numeric_digest_matches_reference_with_nan_past_the_gate(digest_stepped):
    """Counts (leaked NaN/Inf rows per stage, non-finite and fired counts
    per strategy) exact; close/volume stats exact (ring columns); score
    stats at the wire's float contract (rtol 1e-5); gate margins within
    ``MARGIN_TOL``."""
    jw, tw, _ = digest_stepped
    _, jctx = jstep.unpack_wire(jw, numeric_digest=True, ingest_digest=True)
    _, tctx = tstep.unpack_wire(tw, numeric_digest=True, ingest_digest=True)
    jd, td = jctx["numeric_digest"], tctx["numeric_digest"]
    layout = tstep.numeric_digest_layout()
    for i, name in enumerate(layout):
        a, b = jd[i], td[i]
        if name.startswith(("margin.", "score.")):
            assert np.isnan(a) == np.isnan(b), name
            tol = MARGIN_TOL if name.startswith("margin.") else 1e-5 * abs(a)
            assert np.isnan(a) or abs(a - b) <= tol, (name, a, b)
        else:
            assert a.view(np.int32) == b.view(np.int32), (name, a, b)
    dec = tstep.decode_numeric_digest(td)
    # the smuggled NaN is counted as leakage in the 5m feature stage
    assert dec["nan_rows"]["features5"] >= 1 and dec["nan_total"] >= 1
    assert dec["fired"] == jstep.decode_numeric_digest(jd)["fired"]
    assert sum(dec["fired"].values()) == int(jw[tstep.WIRE_FIRED_COUNT_OFF])


def test_ingest_digest_bit_exact(digest_stepped):
    jw, tw, _ = digest_stepped
    jd = jstep.unpack_wire(jw, numeric_digest=True, ingest_digest=True)[1]["ingest_digest"]
    td = tstep.unpack_wire(tw, numeric_digest=True, ingest_digest=True)[1]["ingest_digest"]
    np.testing.assert_array_equal(jd.view(np.int32), td.view(np.int32))
    dec = tstep.decode_ingest_digest(td)
    # the batches' correction and stale insert are routed and counted
    assert dec["15m"]["rewrites"] == 1 and dec["15m"]["dropped"] == 1
    assert dec["5m"]["appends"] > 0


def _leaves_equal(a, b, skip_wire_tail: int = 0) -> None:
    la, _ = torch.utils._pytree.tree_flatten(a)
    lb, _ = torch.utils._pytree.tree_flatten(b)
    assert len(la) == len(lb)
    for i, (x, y) in enumerate(zip(la, lb)):
        if x is None or y is None:  # an output the step did not compute
            assert x is None and y is None, i
            continue
        assert x.dtype == y.dtype and x.shape == y.shape, i
        if x.dtype.is_floating_point:
            x, y = x.view(torch.int32), y.view(torch.int32)
        assert torch.equal(x, y), i


def test_inplace_step_and_its_fallback_equal_the_copying_step(inputs):
    """The full tick, in place: its wire and rings equal the copying
    step's bit for bit, and the in-place fallback (post-tick rings, empty
    batches, the pre-tick small carries) re-derives the copying step's
    TickOutputs bit for bit — but for the ingest digest's counts, which an
    empty batch does not have."""
    tstate, u5, u15, tin, tcfg = inputs["targs"]
    paths = dict(wire_enabled=KEY, incremental=False, maintain_carry=False,
                 numeric_digest=True, ingest_digest=True)
    # the wire step's strategy set: the full-outputs default (compute_all)
    # would also count the dormant strategies' triggers in the digest
    copy_state, copy_out = tstep.tick_step(tstate, u5, u15, tin, tcfg, **paths,
                                           compute_all=False)
    pre = engine_state_from_numpy(engine_state_to_numpy(tstate), "cpu")
    planes = (pre.buf5.values, pre.buf15.times)
    post, wire = tstep.tick_step_wire_inplace(pre, u5, u15, tin, tcfg, **paths)
    assert planes[0]._version > 0 and planes[1]._version > 0  # written in place
    np.testing.assert_array_equal(wire.numpy().view(np.int32), copy_out.wire.numpy().view(np.int32))
    _leaves_equal((post.buf5, post.buf15), (copy_state.buf5, copy_state.buf15))

    empty = (torch.zeros(0, dtype=torch.int32), torch.zeros(0, dtype=torch.int32),
             torch.zeros((0, F), dtype=torch.float32))
    fb_state = post._replace(
        regime_carry=pre.regime_carry, mrf_last_emitted=pre.mrf_last_emitted,
        pt_last_signal_close=pre.pt_last_signal_close, indicator_carry=pre.indicator_carry,
    )
    _, fb = tstep.tick_step(fb_state, empty, empty, tin, tcfg, **paths, compute_all=False)
    n_counts = len(tstep.INGEST_COUNT_FIELDS)
    width = len(tstep.INGEST_STAT_FIELDS) + n_counts
    counts = np.concatenate([np.arange(1 + width - n_counts, 1 + width),
                             np.arange(1 + 2 * width - n_counts, 1 + 2 * width)])
    keep = np.ones(len(wire), bool)
    keep[len(wire) - tstep.INGEST_DIGEST_WIDTH + counts] = False
    np.testing.assert_array_equal(fb.wire.numpy()[keep].view(np.int32),
                                  copy_out.wire.numpy()[keep].view(np.int32))
    assert not fb.wire.numpy()[~keep].any()  # no batch, no counts
    _leaves_equal(fb._replace(wire=torch.zeros(0)), copy_out._replace(wire=torch.zeros(0)))
