"""The incremental wire step: the port against the reference, and against
its own classic step.

* The indicator carry: ``empty_indicator_carry``, ``init_indicator_carry``
  on seeded canonical rings and ``advance_indicator_carry`` over a few
  ticks of clean appends, in both packages. Every leaf has the reference's
  field path, dtype and shape. Integer counters, masks, rings and the
  sorted windows whose samples are ring columns or position-local scores
  (ABP's) are bit-equal. Float leaves that accumulate sums — EWM means,
  window sums, moment centers, the beta/corr sums, the supertrend's ATR and
  bands, the feature histories — agree within ``rtol=1e-5`` and an
  absolute floor of ``1e-5`` of the leaf's scale; LSP's smoothed scores
  come from a windowed mean (a cumsum, summed in another order in torch),
  so its score window and ring sit in the same tolerance; a moment carry's
  centered sums within the ulps of its center (``_moment_sums_close``).
  One advance from the SAME carry keeps every float leaf within 4 ulps.
* One incremental wire step from the reference's state converted into the
  port (rings mid-phase, carry from the reference's init): the wires
  agree under the contract of ``tests/test_torch_step.py`` (fired block
  exact; float scalars and payload at ``rtol=1e-5`` with an absolute floor
  of 1e-6 of their scale), the returned rings are bit-equal and stay
  mid-phase, and the returned carries agree as above.
* The same tick with both digests on, after the ingest digest's counted
  carry folds: the fold counts and the ingest block bit for bit, the
  numeric block's counts exact and its floats within the wire contract;
  and the port's in-place step and its overflow fallback against its
  copying step, bit for bit.
* The port's incremental engine against its own classic engine on one
  replay: every full recompute (cold start and audits) gives the classic
  engine's fired block exactly and its floats within the card contract,
  the carry a resync leaves equals ``init_indicator_carry`` of the classic
  engine's rings bit for bit, and the two runs emit the same signals.

The reference runs jitted, as it runs in production: its compiler may fuse
a multiply and an add, so float leaves are held to ulps, not bits.
"""

from __future__ import annotations

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from binquant_tpu.engine import buffer as jbuf
from binquant_tpu.engine import step as jstep
from binquant_tpu.regime.context import ContextConfig as JCfg
from binquant_tpu.regime.context import RegimeCarry as JCarry
from binquant_tpu_torch.engine import buffer as tbuf
from binquant_tpu_torch.engine import step as tstep
from binquant_tpu_torch.engine.convert import engine_state_from_numpy, engine_state_to_numpy
from binquant_tpu_torch.io import replay as treplay
from binquant_tpu_torch.regime.context import ContextConfig as TCfg

# small shapes: extra intra-op threads only spin and crowd parallel test workers
torch.set_num_threads(1)

S, W, F = 32, 200, jbuf.NUM_FIELDS
T15 = 1_780_272_000  # the first evaluated 15m bar open
KEY = tuple(sorted(jstep.LIVE_STRATEGIES))
RTOL, ATOL = 1e-5, 1e-5
ADVANCES = 3

# leaves equal bit for bit whatever order each package sums in
EXACT = {"last_ts", "rel", "cnt", "n_seen", "has_qav", "dirty", "bc_dirty", "raw_ring",
         "abp5.vol_med.sorted", "abp5.qvol_med.sorted", "abp5.score_q.sorted",
         "abp5.score_ring", "st5.direction"}


def _ring(rng, t_last: int, interval: int, filled: np.ndarray) -> dict:
    """A canonical (cursor 0) ring with bars of seeded OHLCV."""
    rets = rng.normal(0, 0.006, (S, W))
    close = 40 * np.exp(np.cumsum(rets, axis=1))
    open_ = np.concatenate([close[:, :1], close[:, :-1]], axis=1)
    high = np.maximum(open_, close) * 1.002
    low = np.minimum(open_, close) * 0.998
    vol = np.abs(rng.normal(1000, 200, (S, W)))
    qav = vol * close
    qav[9] = 0.0  # a feed without quote volume: ABP's no-QAV branch
    vals = np.stack(
        [open_, high, low, close, vol, qav, np.full_like(close, 300.0),
         vol / 2, qav / 2, np.full_like(close, float(interval))], axis=-1,
    ).astype(np.float32)
    times = np.broadcast_to(
        (t_last - interval * np.arange(W - 1, -1, -1)).astype(np.int32), (S, W)
    ).copy()
    for r in range(S):
        times[r, : W - filled[r]] = -1
        vals[r, : W - filled[r]] = np.nan
    return {"times": times, "values": vals, "filled": filled.copy(),
            "cursor": np.zeros(S, np.int32)}


def _rotate(ring: dict, cursor: np.ndarray) -> dict:
    """The same ring with a mid-phase cursor (full rows only)."""
    out = {k: v.copy() for k, v in ring.items()}
    cursor = np.where(ring["filled"] == W, cursor, 0).astype(np.int32)
    for r in range(S):
        out["times"][r] = np.roll(ring["times"][r], cursor[r])
        out["values"][r] = np.roll(ring["values"][r], cursor[r], axis=0)
    out["cursor"] = cursor
    return out


def _append(rng, last_close: np.ndarray, ts: int, interval: int, burst=()) -> tuple:
    """A clean append for every row but row 3 (no bar this tick) and the
    empty row 7; ``burst`` rows jump +3% on 8x volume."""
    c0 = np.where(np.isfinite(last_close), last_close, 40.0)
    c = c0 * (1 + rng.normal(0, 0.004, S))
    v = np.abs(rng.normal(1000, 200, S))
    for r in burst:
        c[r] = c0[r] * 1.03
        v[r] *= 8.0
    qav = v * c
    qav[9] = 0.0
    vals = np.stack([c0, np.maximum(c0, c) * 1.001, np.minimum(c0, c) * 0.999, c, v, qav,
                     np.full(S, 300.0), v / 2, qav / 2, np.full(S, float(interval))],
                    axis=-1).astype(np.float32)
    rows = np.array([r for r in range(S) if r not in (3, 7)], np.int32)
    return rows, np.full(len(rows), ts, np.int32), vals[rows], c.astype(np.float32)


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(47)
    filled = np.full(S, W, np.int32)
    filled[[5, 6, 7, 8]] = [150, 90, 0, 120]
    t5_last, t15_last = T15 + 600 - 300, T15 - 900
    ring5 = _ring(rng, t5_last, 300, filled)
    ring15 = _ring(rng, t15_last, 900, filled)
    # up-closes on the last two 5m bars of the burst rows: ABP's setup
    for r in (11, 12, 13, 14):
        for j in (-2, -1):
            prev = ring5["values"][r, j - 1, 3]
            ring5["values"][r, j, 0] = prev
            ring5["values"][r, j, 3] = prev * 1.003
            ring5["values"][r, j, 1] = prev * 1.004
            ring5["values"][r, j, 2] = prev * 0.999
    # the tick's updates: one 15m bar, three 5m bars, the last with bursts
    upd15 = _append(rng, ring15["values"][:, -1, 3], T15, 900)
    c5 = ring5["values"][:, -1, 3]
    upd5 = []
    for j in range(3):
        u = _append(rng, c5, T15 + 300 * j, 300, burst=(11, 12, 13, 14) if j == 2 else ())
        c5 = np.where(np.isin(np.arange(S), u[0]), u[3], c5).astype(np.float32)
        upd5.append(u[:3])
    regime = {k: np.asarray(v) for k, v in jstep.initial_regime_carry(S)._asdict().items()}
    regime.update(
        has_prev=np.asarray(True), market_regime=np.asarray(3, np.int32),
        stable_since=np.asarray(T15 - 7200, np.int32),
        stage_ts=np.asarray(T15 - 900, np.int32), stage_valid=np.asarray(True),
        stage_regime=np.asarray(3, np.int32),
        stage_scores=np.asarray([0.3, 0.2, 0.55, 0.1], np.float32),
        stage_stable_since=np.asarray(T15 - 7200, np.int32),
    )
    return dict(ring5=ring5, ring15=ring15, upd5=upd5, upd15=upd15[:3], regime=regime)


def _jbuf(d: dict) -> jbuf.MarketBuffer:
    return jbuf.MarketBuffer(*(jnp.asarray(d[f]) for f in jbuf.MarketBuffer._fields))


def _tbuf(d: dict) -> tbuf.MarketBuffer:
    return tbuf.MarketBuffer(*(torch.from_numpy(d[f].copy()) for f in tbuf.MarketBuffer._fields))


def _leaves(tree, prefix=""):
    """(dotted path, leaf) pairs of a nested named tuple."""
    if isinstance(tree, tuple):
        for f, v in zip(tree._fields, tree):
            yield from _leaves(v, f"{prefix}{f}.")
    else:
        yield prefix[:-1], tree


def _exact(path: str) -> bool:
    return path in EXACT or path.rsplit(".", 1)[-1] in EXACT


def _compare_carries(jc, tc, where: str, all_exact: bool = False, prefix: str = "") -> None:
    jl, tl = dict(_leaves(jc, prefix)), dict(_leaves(tc, prefix))
    assert list(jl) == list(tl), where
    for path, a in jl.items():
        a, b = np.asarray(a), tl[path].detach().numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, (where, path, a.dtype, b.dtype)
        if all_exact or _exact(path):
            assert np.array_equal(a, b, equal_nan=a.dtype.kind == "f"), (where, path)
            continue
        if path.endswith((".wsum", ".wsq")) and path.rsplit(".", 2)[-2] in MOMENTS:
            _moment_sums_close(jl, tl, path, where)
            continue
        finite = np.isfinite(a)
        assert np.array_equal(finite, np.isfinite(b)), (where, path)
        scale = max(float(np.abs(a[finite]).max()), 1.0) if finite.any() else 1.0
        np.testing.assert_allclose(b[finite], a[finite], rtol=RTOL, atol=ATOL * scale,
                                   err_msg=f"{where} {path}")
        assert np.array_equal(a[~finite], b[~finite], equal_nan=True), (where, path)


MOMENTS = {"close_m", "vol_m", "tr_m"}


def _moment_sums_close(jl, tl, path: str, where: str) -> None:
    """A moment carry's center is a window mean: another summation order
    moves it by a few ulps, every centered sample by the same amount, and
    Σ(x−c) by up to cnt of them. ``wsum`` within 8·(cnt+1) ulps of the
    center; ``wsq`` within rtol 1e-5 beside 2·|wsum| times that."""
    base = path.rsplit(".", 1)[0]
    center = np.abs(np.asarray(jl[base + ".center"])).astype(np.float32)
    cnt = np.asarray(jl[base + ".cnt"])
    tol = 8 * (cnt + 1) * np.spacing(center) + ATOL
    a, b = np.asarray(jl[path]), tl[path].detach().numpy()
    if path.endswith(".wsq"):
        tol = RTOL * np.abs(a) + 2 * np.abs(np.asarray(jl[base + ".wsum"])) * tol + ATOL
    assert np.all(np.abs(a - b) <= tol), (where, path, np.abs(a - b).max())


def _upd_pairs(world):
    """The tick's sub-batch pairs in fold order, as (upd5, upd15) numpy."""
    empty = (np.zeros(0, np.int32), np.zeros(0, np.int32), np.zeros((0, F), np.float32))
    return [(world["upd5"][i], world["upd15"] if i == 0 else empty) for i in range(3)]


def test_empty_indicator_carry_matches_reference():
    _compare_carries(jstep.empty_indicator_carry(S),
                     tstep.empty_indicator_carry(S, device="cpu"), "empty", all_exact=True)


@pytest.fixture(scope="module")
def carries(world):
    """Both packages' init on the canonical rings, then ADVANCES one-bar
    advances (each package from its own carry, and one from a shared one)."""
    j5, j15 = _jbuf(world["ring5"]), _jbuf(world["ring15"])
    t5, t15 = _tbuf(world["ring5"]), _tbuf(world["ring15"])
    btc = 0
    jinit = jax.jit(jstep.init_indicator_carry)(j5, j15, btc)
    jadvance = jax.jit(jstep.advance_indicator_carry)
    out = {"jinit": jinit,
           "tinit": tstep.init_indicator_carry(t5, t15, torch.tensor(btc, dtype=torch.int32))}
    jc, tc = jinit, out["tinit"]
    shared = None
    for k, (u5, u15) in enumerate(_upd_pairs(world)[:ADVANCES]):
        j5 = jbuf.apply_updates(j5, *map(jnp.asarray, u5))
        j15 = jbuf.apply_updates(j15, *map(jnp.asarray, u15))
        t5 = tbuf.apply_updates(t5, *map(torch.from_numpy, u5))
        t15 = tbuf.apply_updates(t15, *map(torch.from_numpy, u15))
        jt5, jt15 = (jbuf.materialize_tail(b, jstep.INCR_TAIL_WINDOW) for b in (j5, j15))
        tt5, tt15 = (tbuf.materialize_tail(b, tstep.INCR_TAIL_WINDOW) for b in (t5, t15))
        row = torch.tensor(btc, dtype=torch.int32)
        if k == 0:
            # one advance from the reference's carry converted into the port
            conv = engine_state_from_numpy(
                {**_state_leaves(world), "indicator_carry": _np_tree(jc)}, "cpu"
            ).indicator_carry
            shared = (jadvance(jt5, jt15, jc, jnp.int32(btc)),
                      tstep.advance_indicator_carry(tt5, tt15, conv, row))
        jc, js5, js15 = jadvance(jt5, jt15, jc, jnp.int32(btc))
        tc, ts5, ts15 = tstep.advance_indicator_carry(tt5, tt15, tc, row)
        np.testing.assert_array_equal(np.asarray(js5), ts5.numpy())
        np.testing.assert_array_equal(np.asarray(js15), ts15.numpy())
    out.update(jadv=jc, tadv=tc, shared=shared)
    return out


def _np_tree(tree):
    if isinstance(tree, tuple):
        return {f: _np_tree(v) for f, v in zip(tree._fields, tree)}
    return np.asarray(tree)


def _state_leaves(world) -> dict:
    return {
        "buf5": world["ring5"], "buf15": world["ring15"], "regime_carry": world["regime"],
        "mrf_last_emitted": np.full(S, -1, np.int32),
        "pt_last_signal_close": np.full(S, -1, np.int32),
    }


FAMILIES = tstep.IndicatorCarry._fields


@pytest.mark.parametrize("family", FAMILIES)
def test_init_indicator_carry_matches_reference(carries, family):
    _compare_carries(getattr(carries["jinit"], family), getattr(carries["tinit"], family),
                     "init", prefix=f"{family}.")


@pytest.mark.parametrize("family", FAMILIES)
def test_advance_indicator_carry_matches_reference(carries, family):
    _compare_carries(getattr(carries["jadv"], family), getattr(carries["tadv"], family),
                     f"after {ADVANCES} advances", prefix=f"{family}.")
    assert carries["jadv"].abp5.score_q.cnt.sum() > 0  # the windows hold data


def test_advance_from_shared_carry_matches_reference(carries):
    """One advance from the reference's own carry: the order-free leaves
    bit for bit, every float leaf within 4 ulps of itself (the reference's
    compiler may fuse a multiply and an add: one rounding fewer), the MACD
    signal within 4 ulps of the price it is the EWM of a difference of."""
    (jc, _, _), (tc, _, _) = carries["shared"]
    jl, tl = dict(_leaves(jc)), dict(_leaves(tc))
    for path, a in jl.items():
        a, b = np.asarray(a), tl[path].numpy()
        if _exact(path) or a.dtype.kind != "f":
            assert np.array_equal(a, b, equal_nan=a.dtype.kind == "f"), path
            continue
        ref = np.asarray(jl[path.replace("macd_sig", "macd_fast")]) if "macd_sig" in path else a
        fin = np.isfinite(a)
        assert np.array_equal(fin, np.isfinite(b)), path
        tol = 4 * np.spacing(np.abs(ref[fin]).astype(np.float32))
        assert np.all(np.abs(a[fin] - b[fin]) <= tol), (path, np.abs(a[fin] - b[fin]).max())


# --------------------------------------------------------------------------
# one incremental wire step from the reference's state
# --------------------------------------------------------------------------


def _inputs(tracked):
    nan = np.float32(np.nan)
    jin = jstep.default_host_inputs(S)._replace(
        tracked=jnp.asarray(tracked), btc_row=jnp.int32(0), timestamp_s=jnp.int32(T15),
        timestamp5_s=jnp.int32(T15 + 600), adp_latest=jnp.float32(-0.44),
        adp_prev=jnp.float32(-0.47), adp_diff=jnp.float32(0.03), adp_diff_prev=nan,
        breadth_momentum_points=jnp.float32(4.0), grid_policy_allows=jnp.asarray(True),
    )
    tin = tstep.default_host_inputs(S, device="cpu")._replace(
        tracked=torch.from_numpy(tracked), btc_row=torch.tensor(0, dtype=torch.int32),
        timestamp_s=torch.tensor(T15, dtype=torch.int32),
        timestamp5_s=torch.tensor(T15 + 600, dtype=torch.int32),
        adp_latest=torch.tensor(-0.44), adp_prev=torch.tensor(-0.47),
        adp_diff=torch.tensor(0.03), breadth_momentum_points=torch.tensor(4.0),
        grid_policy_allows=torch.tensor(True),
    )
    return jin, tin


def _start(world, carries):
    """Both packages' state before the tick — mid-phase rings and the
    reference's init carry — with the tick's inputs and sub-batch pairs."""
    cursor = (np.arange(S) * 7 % W).astype(np.int32)
    leaves = {**_state_leaves(world), "indicator_carry": _np_tree(carries["jinit"])}
    leaves["buf5"] = _rotate(world["ring5"], cursor)
    leaves["buf15"] = _rotate(world["ring15"], cursor)
    jstate = jstep.EngineState(
        buf5=_jbuf(leaves["buf5"]), buf15=_jbuf(leaves["buf15"]),
        regime_carry=JCarry(**{k: jnp.asarray(v) for k, v in world["regime"].items()}),
        mrf_last_emitted=jnp.asarray(leaves["mrf_last_emitted"]),
        pt_last_signal_close=jnp.asarray(leaves["pt_last_signal_close"]),
        indicator_carry=carries["jinit"],
    )
    tstate = engine_state_from_numpy(leaves, "cpu")
    jin, tin = _inputs(world["ring5"]["filled"] > 0)
    cfg = dict(required_fresh_symbols=4, min_coverage_ratio=0.5)
    return jstate, tstate, jin, tin, cfg, _upd_pairs(world)


@pytest.fixture(scope="module")
def stepped(world, carries):
    """Both packages fold the tick's first two sub-batch pairs with the
    carry-advancing step, then run one incremental wire step on the last,
    from the same state: mid-phase rings and the reference's init carry."""
    jstate, tstate, jin, tin, cfg, pairs = _start(world, carries)
    for u5, u15 in pairs[:-1]:
        jstate = jstep.apply_updates_carry_step(
            jstate, tuple(map(jnp.asarray, u5)), tuple(map(jnp.asarray, u15)), btc_row=0)
        tstate = tstep.apply_updates_carry_step(
            tstate, tuple(map(torch.from_numpy, u5)), tuple(map(torch.from_numpy, u15)),
            btc_row=0)
    u5, u15 = pairs[-1]
    jnew, jwire = jstep.tick_step_wire(
        jstate, tuple(map(jnp.asarray, u5)), tuple(map(jnp.asarray, u15)), jin,
        JCfg(**cfg), wire_enabled=KEY, incremental=True, maintain_carry=True,
    )
    tnew, twire = tstep.tick_step_wire(
        tstate, tuple(map(torch.from_numpy, u5)), tuple(map(torch.from_numpy, u15)), tin,
        TCfg(**cfg), wire_enabled=KEY, incremental=True, maintain_carry=True,
    )
    return jnew, np.asarray(jwire), tnew, twire.numpy()


def test_incremental_wire_matches_reference(stepped):
    _, jw, _, tw = stepped
    assert tw.dtype == jw.dtype == np.float32 and tw.shape == jw.shape
    off, K = tstep.WIRE_FIRED_COUNT_OFF, tstep.WIRE_MAX_FIRED
    assert jw[off] == tw[off] and jw[off] > 0  # something fired
    jb = jw[off + 1: off + 1 + 6 * K].reshape(6, K)
    tb = tw[off + 1: off + 1 + 6 * K].reshape(6, K)
    np.testing.assert_array_equal(jb[:4], tb[:4])
    assert 0 in set(jb[0, : int(jw[off])].astype(int))  # ActivityBurstPump fired
    scale = np.maximum(np.abs(jw), 1.0)
    fin = np.isfinite(jw)
    assert np.array_equal(fin, np.isfinite(tw)) and np.array_equal(np.isnan(jw), np.isnan(tw))
    assert np.all(np.abs(tw[fin] - jw[fin]) <= 1e-5 * scale[fin]), np.abs(tw - jw)[fin].max()


def test_incremental_step_state_matches_reference(stepped):
    jnew, _, tnew, _ = stepped
    got = engine_state_to_numpy(tnew)
    for ring in ("buf5", "buf15"):
        for f in jbuf.MarketBuffer._fields:
            a = np.asarray(getattr(getattr(jnew, ring), f))
            assert a.dtype == got[ring][f].dtype, (ring, f)
            assert np.array_equal(a, got[ring][f], equal_nan=a.dtype.kind == "f"), (ring, f)
        # the incremental tick leaves the ring mid-phase
        assert got[ring]["cursor"].any()
    _compare_carries(jnew.indicator_carry, tnew.indicator_carry, "after the wire step")


# --------------------------------------------------------------------------
# the same tick with both digests on: counted carry folds, digest blocks,
# and the same tick in place
# --------------------------------------------------------------------------


def _np(t):
    return tuple(map(jnp.asarray, t)), tuple(map(torch.from_numpy, t))


@pytest.fixture(scope="module")
def digest_stepped(world, carries):
    """The tick of ``stepped`` with the ingest digest's counted carry folds
    and both digest blocks on the wire step."""
    jstate, tstate, jin, tin, cfg, pairs = _start(world, carries)
    jcounts = tcounts = None
    folds = []
    for u5, u15 in pairs[:-1]:
        (j5, t5), (j15, t15) = _np(u5), _np(u15)
        jstate, jcounts = jstep.apply_updates_carry_step_counted(
            jstate, j5, j15, btc_row=0, counts=jcounts)
        tstate, tcounts = tstep.apply_updates_carry_step_counted(
            tstate, t5, t15, btc_row=0, counts=tcounts)
        folds.append((np.asarray(jcounts), tcounts.numpy().copy()))
    (j5, t5), (j15, t15) = _np(pairs[-1][0]), _np(pairs[-1][1])
    flags = dict(wire_enabled=KEY, incremental=True, maintain_carry=True,
                 numeric_digest=True, ingest_digest=True)
    jnew, jwire = jstep.tick_step_wire(jstate, j5, j15, jin, JCfg(**cfg), **flags,
                                       ingest_fold_counts=jcounts)
    tnew, twire = tstep.tick_step_wire(tstate, t5, t15, tin, TCfg(**cfg), **flags,
                                       ingest_fold_counts=tcounts)
    return dict(folds=folds, jfolded=jstate, tfolded=tstate, jwire=np.asarray(jwire),
                twire=twire.numpy(), tcounts=tcounts, targs=(t5, t15, tin, TCfg(**cfg)),
                flags=flags)


def test_counted_carry_folds_match_reference(digest_stepped):
    """The (8,) fold counts bit for bit after each fold; the folded rings
    bit for bit and the folded carry under the carry contract above."""
    for a, b in digest_stepped["folds"]:
        np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))
    assert digest_stepped["folds"][-1][0][:4].sum() == 60  # both 5m folds were counted
    jst, tst = digest_stepped["jfolded"], digest_stepped["tfolded"]
    got = engine_state_to_numpy(tst)
    for ring in ("buf5", "buf15"):
        for f in jbuf.MarketBuffer._fields:
            a = np.asarray(getattr(getattr(jst, ring), f))
            assert np.array_equal(a, got[ring][f], equal_nan=a.dtype.kind == "f"), (ring, f)
    _compare_carries(jst.indicator_carry, tst.indicator_carry, "after the counted folds")


def test_incremental_digest_wire_matches_reference(digest_stepped):
    """The pre-digest wire under the contract above; the numeric digest's
    counts exact, its stats and margins within the float contract of the
    wire (rtol 1e-5; margins within 8 ulps of the 0-100 indicator scale);
    the ingest digest — the tick's batch plus the two folds' counts — bit
    for bit."""
    jw, tw = digest_stepped["jwire"], digest_stepped["twire"]
    assert tw.shape == jw.shape == (tstep.wire_length(S, True, True),)
    base = tstep.wire_length(S)
    off, K = tstep.WIRE_FIRED_COUNT_OFF, tstep.WIRE_MAX_FIRED
    assert jw[off] == tw[off] and jw[off] > 0
    np.testing.assert_array_equal(jw[off + 1: off + 1 + 4 * K], tw[off + 1: off + 1 + 4 * K])
    scale = np.maximum(np.abs(jw[:base]), 1.0)
    fin = np.isfinite(jw[:base])
    assert np.array_equal(fin, np.isfinite(tw[:base]))
    assert np.all(np.abs(tw[:base][fin] - jw[:base][fin]) <= 1e-5 * scale[fin])
    _, jctx = jstep.unpack_wire(jw, numeric_digest=True, ingest_digest=True)
    _, tctx = tstep.unpack_wire(tw, numeric_digest=True, ingest_digest=True)
    margin_tol = 8 * float(np.spacing(np.float32(100.0)))
    for name, a, b in zip(tstep.numeric_digest_layout(), jctx["numeric_digest"],
                          tctx["numeric_digest"]):
        assert np.isnan(a) == np.isnan(b), name
        if name.startswith("margin."):
            assert np.isnan(a) or abs(a - b) <= margin_tol, (name, a, b)
        elif name.startswith(tuple(f"{x}." for x in tstep.NUMERIC_SERIES)):
            assert np.isnan(a) or abs(a - b) <= 1e-5 * abs(a), (name, a, b)
        else:
            assert a == b, (name, a, b)
    np.testing.assert_array_equal(jctx["ingest_digest"].view(np.int32),
                                  tctx["ingest_digest"].view(np.int32))
    dec = tstep.decode_ingest_digest(tctx["ingest_digest"])
    # three 5m sub-batches (two folded) of 30 rows each, one 15m batch
    routed = ("appends", "rewrites", "dropped")
    assert sum(dec["5m"][k] for k in routed) == 90 and dec["15m"]["appends"] == 30


def _leaves_equal(a, b) -> None:
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


def test_inplace_incremental_step_and_its_fallback_equal_the_copying_step(digest_stepped):
    """The incremental tick in place: wire, rings and carry equal the
    copying step's bit for bit; the in-place fallback (post-tick rings,
    empty batches, pre-tick small carries) re-derives the copying step's
    TickOutputs bit for bit but for the ingest digest's counts."""
    t5, t15, tin, tcfg = digest_stepped["targs"]
    flags = digest_stepped["flags"]
    folded = digest_stepped["tfolded"]
    counts = digest_stepped["tcounts"]
    # the wire step's strategy set: the full-outputs default (compute_all)
    # would also count the dormant strategies' triggers in the digest
    copy_state, copy_out = tstep.tick_step(folded, t5, t15, tin, tcfg, **flags,
                                           ingest_fold_counts=counts, compute_all=False)
    np.testing.assert_array_equal(copy_out.wire.numpy(), digest_stepped["twire"])
    pre = engine_state_from_numpy(engine_state_to_numpy(folded), "cpu")
    ring = pre.buf5.values
    post, wire = tstep.tick_step_wire_inplace(pre, t5, t15, tin, tcfg, **flags,
                                              ingest_fold_counts=counts)
    assert post.buf5.values is ring and ring._version > 0  # the ring itself moved on
    np.testing.assert_array_equal(wire.numpy().view(np.int32), copy_out.wire.numpy().view(np.int32))
    _leaves_equal(post, copy_state)

    empty = (torch.zeros(0, dtype=torch.int32), torch.zeros(0, dtype=torch.int32),
             torch.zeros((0, F), dtype=torch.float32))
    fb_state = post._replace(
        regime_carry=pre.regime_carry, mrf_last_emitted=pre.mrf_last_emitted,
        pt_last_signal_close=pre.pt_last_signal_close, indicator_carry=pre.indicator_carry,
    )
    _, fb = tstep.tick_step(fb_state, empty, empty, tin, tcfg, **flags, compute_all=False)
    n = len(wire) - tstep.INGEST_DIGEST_WIDTH
    np.testing.assert_array_equal(fb.wire.numpy()[:n].view(np.int32),
                                  copy_out.wire.numpy()[:n].view(np.int32))
    jf = tstep.decode_ingest_digest(fb.wire.numpy()[n:])
    jc = tstep.decode_ingest_digest(copy_out.wire.numpy()[n:])
    for iv in tstep.INGEST_INTERVALS:
        for f in tstep.INGEST_STAT_FIELDS:
            assert jf[iv][f] == jc[iv][f], (iv, f)
        assert all(jf[iv][f] == 0 for f in tstep.INGEST_COUNT_FIELDS)  # no batch
    _leaves_equal(fb._replace(wire=torch.zeros(0)), copy_out._replace(wire=torch.zeros(0)))


# --------------------------------------------------------------------------
# the port's incremental engine against its own classic engine
# --------------------------------------------------------------------------


# the serial loop (depth 0) with copied rings and no digests or meter: the
# engine tests below read each tick's own wire and keep each tick's state
SERIAL = dict(pipeline_depth=0, donate=False, numeric_digest=False, ingest_digest=False,
              drift_meter=False)


def _drive(engine, seq) -> list[tuple]:
    """Tick by tick: (path, wire, fired tuples, the state after)."""
    out = []

    async def run():
        for tick_ms, klines in seq:
            for k in klines:
                engine.ingest(k)
            fired = await engine.process_tick(now_ms=tick_ms)
            out.append((engine.last_path, engine.last_wire.copy(),
                        treplay.signal_tuples(fired), engine.state))

    asyncio.run(run())
    return out


def test_incremental_engine_matches_classic_at_resync_ticks(tmp_path):
    path = tmp_path / "rp.jsonl"
    treplay.generate_replay_file(path, n_symbols=16, n_ticks=112, seed=11)
    seq = treplay.tick_seq(path)
    kw = dict(capacity=32, window=W, device="cpu", **SERIAL)
    incr = _drive(treplay.make_stub_engine(incremental=True, carry_audit_every=12, **kw), seq)
    classic = _drive(treplay.make_stub_engine(incremental=False, **kw), seq)

    paths = [p for p, *_ in incr]
    assert paths[0] == "cold_start" and paths.count("audit") == 9
    assert {p for p, *_ in classic} == {"classic"}
    off, K = tstep.WIRE_FIRED_COUNT_OFF, tstep.WIRE_MAX_FIRED
    for (p, wi, _, si), (_, wc, _, sc) in zip(incr, classic):
        if p == "incremental":
            continue
        assert wi[off] == wc[off]
        blk = slice(off + 1, off + 1 + 4 * K)
        np.testing.assert_array_equal(wi[blk], wc[blk])
        assert np.all(np.isclose(wi, wc, rtol=1e-4, atol=1e-5, equal_nan=True)), p
        # the resync's carry is the init of the same (canonical) windows
        expect = tstep.init_indicator_carry(sc.buf5, sc.buf15, torch.tensor(0, dtype=torch.int32))
        _compare_carries_port(expect, si.indicator_carry)
    fired_i = [s for *_, f, _ in incr for s in f]
    fired_c = [s for *_, f, _ in classic for s in f]
    assert fired_i == fired_c and fired_i


def _compare_carries_port(a, b) -> None:
    for (path, x), (_, y) in zip(_leaves(a), _leaves(b)):
        assert x.dtype == y.dtype and torch.equal(
            torch.nan_to_num(x.float(), nan=-7.0), torch.nan_to_num(y.float(), nan=-7.0)
        ), path


def test_overflow_fallback_reruns_the_same_path(tmp_path):
    """A compaction overflow re-evaluates the tick with the full step
    outputs: from the pre-tick state, on the path the wire step took, so
    its wire is the wire step's bit for bit on incremental and full ticks."""
    path = tmp_path / "rp.jsonl"
    treplay.generate_replay_file(path, n_symbols=12, n_ticks=12, seed=5)
    engine = treplay.make_stub_engine(capacity=16, window=W, device="cpu",
                                      incremental=True, carry_audit_every=5, **SERIAL)
    paths = []

    async def run():
        for tick_ms, klines in treplay.tick_seq(path):
            for k in klines:
                engine.ingest(k)
            pending = await engine._dispatch_tick_inner(tick_ms)
            full = pending.fallback()
            assert torch.equal(full.wire.view(torch.int32), pending.wire.view(torch.int32))
            await engine._finalize_tick_inner(pending)
            engine.ticks_processed += 1
            paths.append(engine.last_path)

    asyncio.run(run())
    assert paths[0] == "cold_start" and "audit" in paths and "incremental" in paths
