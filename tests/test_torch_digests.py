"""The wire's two digest blocks: the port against the reference.

* Layouts: the numeric and ingest digest layouts and widths, and the wire
  length with either block, equal the reference's.
* Ingest digest: one seeded stream of sub-batch pairs (appends, gap
  appends, same-bar rewrites, mid-history rewrites, dropped mid-history
  inserts, out-of-range rows) through both packages' counted folds
  (``apply_updates_step_counted``), the port's in place as well as copying:
  the (8,) counts and the rings after every pair are equal bit for bit, and
  so are the per-interval staleness/coverage stats and the assembled block
  (every entry is an exact integer reduction).
* Numeric digest pieces on crafted inputs: the series stats over NaN, ±inf,
  signed zeros and empty masks and the margin minimum equal the reference's
  (by value: a max over -0.0 and +0.0 may return either zero), and the
  regime-score top1-top2 spread on tied and NaN scores equals it bit for
  bit.
* Decoding and splitting: ``decode_*_digest`` and ``unpack_wire`` with the
  blocks on give the reference's dicts on the same vectors.

The blocks inside whole wire steps are held to the reference in
``tests/test_torch_step.py`` (classic) and
``tests/test_torch_incremental_step.py`` (incremental, counted carry folds).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from binquant_tpu.engine import step as jstep
from binquant_tpu_torch.engine import step as tstep

# small shapes: extra intra-op threads only spin and crowd parallel test workers
torch.set_num_threads(1)

S, W, F, U = 16, 12, 10, 8
T0 = 1_780_272_000


@pytest.mark.parametrize("kind", ["numeric", "ingest"])
def test_digest_layouts_match_reference(kind):
    layout = getattr(tstep, f"{kind}_digest_layout")()
    assert layout == getattr(jstep, f"{kind}_digest_layout")()
    width = getattr(tstep, f"{kind.upper()}_DIGEST_WIDTH")
    assert width == getattr(jstep, f"{kind.upper()}_DIGEST_WIDTH") == len(layout)
    assert len(set(layout)) == len(layout)
    flags = {f"{kind}_digest": True}
    assert tstep.wire_length(S, **flags) == jstep.wire_length(S, **flags)
    assert tstep.wire_length(S, True, True) == jstep.wire_length(S, True, True)


def _stream(rng, interval: int, steps: int = 30):
    """(rows, ts, vals) batches against one ring: appends (a third of them
    skipping one or two buckets), same-bar corrections, mid-history
    rewrites, stale inserts that must drop, and out-of-range rows."""
    latest = np.full(S, -1, np.int64)
    history: dict[int, list[int]] = {r: [] for r in range(S)}
    batches = []
    for _ in range(steps):
        n = int(rng.integers(3, U + 1))
        rows = rng.choice(S, size=n, replace=False)
        ts = []
        for r in rows:
            kind = rng.random()
            if latest[r] < 0 or kind < 0.6:
                t = (latest[r] if latest[r] >= 0 else T0) + interval * int(rng.choice([1, 1, 2, 3]))
            elif kind < 0.72:
                t = latest[r]
            elif kind < 0.86 and len(history[r]) > 2:
                t = history[r][-int(rng.integers(2, min(len(history[r]), W) + 1))]
            else:
                t = latest[r] - interval // 2
            ts.append(t)
            if t > latest[r]:
                latest[r] = t
                history[r].append(t)
        vals = rng.normal(100, 5, (n, F)).astype(np.float32)
        # out-of-range rows pad every batch to U + 2 entries (one shape)
        pad = U + 2 - n
        rows = np.concatenate([rows, [-1, S + 2] + [-1] * (pad - 2)])
        ts = np.concatenate([np.asarray(ts), [T0] * pad])
        vals = np.concatenate([vals, np.full((pad, F), 9.0, np.float32)])
        batches.append((rows.astype(np.int32), ts.astype(np.int32), vals))
    return batches, latest


def _rings_equal(jstate, tstate) -> None:
    for ring in ("buf5", "buf15"):
        for f in ("times", "values", "filled", "cursor"):
            a = np.asarray(getattr(getattr(jstate, ring), f))
            b = getattr(getattr(tstate, ring), f).numpy()
            assert a.dtype == b.dtype and np.array_equal(a, b, equal_nan=a.dtype.kind == "f"), (
                ring, f)


@jax.jit
def _jax_ingest_block(state, tracked, eval5, eval15, counts):
    return jstep._ingest_digest_block(
        tracked,
        jstep._ingest_interval_stats(
            jstep.ring_latest_times(state.buf5), state.buf5.filled, tracked, eval5, 300),
        jstep._ingest_interval_stats(
            jstep.ring_latest_times(state.buf15), state.buf15.filled, tracked, eval15, 900),
        counts[:4], counts[4:],
    )


@pytest.mark.parametrize("inplace", [False, True])
def test_counted_folds_and_ingest_block_bit_exact(inplace):
    rng = np.random.default_rng(5)
    s5, latest5 = _stream(rng, 300)
    s15, latest15 = _stream(rng, 900)
    tracked = np.ones(S, bool)
    tracked[[4, 9]] = False
    jstate = jstep.initial_engine_state(S, window=W)
    tstate = tstep.initial_engine_state(S, W, device="cpu")
    jcounts = jnp.zeros((8,), jnp.float32)
    tcounts = torch.zeros((8,), dtype=torch.float32)
    seen = np.zeros(8)
    for k, (u5, u15) in enumerate(zip(s5, s15)):
        planes = (tstate.buf5.values, tstate.buf15.times)
        jstate, jcounts = jstep.apply_updates_step_counted(
            jstate, tuple(map(jnp.asarray, u5)), tuple(map(jnp.asarray, u15)), jcounts
        )
        tstate, tcounts = tstep.apply_updates_step_counted(
            tstate, tuple(map(torch.from_numpy, u5)), tuple(map(torch.from_numpy, u15)),
            tcounts, inplace=inplace,
        )
        # the in-place fold writes the very planes it was given
        assert (tstate.buf5.values is planes[0]) == inplace
        assert (tstate.buf15.times is planes[1]) == inplace
        assert tcounts.dtype == torch.float32 and tcounts.shape == (8,)
        np.testing.assert_array_equal(np.asarray(jcounts).view(np.int32), tcounts.numpy().view(np.int32))
        _rings_equal(jstate, tstate)
        seen = np.maximum(seen, np.asarray(jcounts))
        if k % 5 == 4:
            # the evaluated bucket: some rows fresh, some behind, some ahead
            eval5 = int(np.median(latest5))
            eval15 = int(np.median(latest15))
            tt = torch.from_numpy(tracked)
            jblock = _jax_ingest_block(
                jstate, jnp.asarray(tracked), jnp.int32(eval5), jnp.int32(eval15), jcounts)
            tblock = tstep._ingest_digest_block(
                tt,
                tstep._ingest_interval_stats(
                    tstep.ring_latest_times(tstate.buf5), tstate.buf5.filled, tt,
                    torch.tensor(eval5, dtype=torch.int32), 300),
                tstep._ingest_interval_stats(
                    tstep.ring_latest_times(tstate.buf15), tstate.buf15.filled, tt,
                    torch.tensor(eval15, dtype=torch.int32), 900),
                tcounts[:4], tcounts[4:],
            )
            assert tblock.shape == (tstep.INGEST_DIGEST_WIDTH,) and tblock.dtype == torch.float32
            np.testing.assert_array_equal(np.asarray(jblock).view(np.int32), tblock.numpy().view(np.int32))
            assert tstep.decode_ingest_digest(tblock.numpy()) == jstep.decode_ingest_digest(
                np.asarray(jblock))
    # the stream exercised every count: appends, rewrites, gaps, drops
    assert (seen > 0).all(), seen


def test_ingest_pair_counts_standalone():
    rng = np.random.default_rng(8)
    s5, _ = _stream(rng, 300, steps=6)
    s15, _ = _stream(rng, 900, steps=6)
    jstate = jstep.initial_engine_state(S, window=W)
    tstate = tstep.initial_engine_state(S, W, device="cpu")
    jcounts = jax.jit(jstep._ingest_pair_counts)
    for u5, u15 in zip(s5, s15):
        j = jcounts(jstate, tuple(map(jnp.asarray, u5)), tuple(map(jnp.asarray, u15)))
        t = tstep._ingest_pair_counts(
            tstate, tuple(map(torch.from_numpy, u5)), tuple(map(torch.from_numpy, u15)))
        np.testing.assert_array_equal(np.asarray(j), t.numpy())
        jstate = jstep.apply_updates_step(jstate, tuple(map(jnp.asarray, u5)), tuple(map(jnp.asarray, u15)))
        tstate = tstep.apply_updates_step(
            tstate, tuple(map(torch.from_numpy, u5)), tuple(map(torch.from_numpy, u15)))


def _bits(x) -> np.ndarray:
    return np.asarray(x, np.float32).reshape(-1).view(np.int32)


SERIES_CASES = {
    "finite": ([3.0, -1.5, 2.0, 7.25], [True, True, False, True]),
    "nan_and_inf": ([np.nan, np.inf, -np.inf, 4.0, -2.0], [True, True, True, True, True]),
    "nothing_qualifies": ([np.nan, 1.0, 2.0], [True, False, False]),
    "signed_zeros": ([-0.0, 0.0, -0.0], [True, True, True]),
}


@pytest.mark.parametrize("case", sorted(SERIES_CASES))
def test_series_stats_and_margin_min_bit_exact(case):
    x, m = SERIES_CASES[case]
    x32, m = np.asarray(x, np.float32), np.asarray(m)
    j = jstep._series_stats(jnp.asarray(x32), jnp.asarray(m))
    t = tstep._series_stats(torch.from_numpy(x32), torch.from_numpy(m))
    for a, b in zip(j, t):
        assert b.dtype == torch.float32
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    # the margin minimum (the reference's closure inside the digest block)
    prox = np.abs(x32 - 1.0)
    jm = jnp.where(
        jnp.any(jnp.asarray(m) & jnp.isfinite(jnp.asarray(prox))),
        jnp.min(jnp.where(jnp.asarray(m) & jnp.isfinite(jnp.asarray(prox)), jnp.asarray(prox), jnp.inf)),
        jnp.nan,
    ).astype(jnp.float32)
    tm = tstep._margin_min(torch.from_numpy(prox), torch.from_numpy(m))
    np.testing.assert_array_equal(_bits(jm), _bits(tm.numpy()))


SPREADS = {
    "ordered": [0.3, 0.2, 0.55, 0.1],
    "tied_top": [0.4, 0.4, 0.1, 0.0],
    "all_tied": [0.25, 0.25, 0.25, 0.25],
    "one_nan": [0.5, np.nan, 0.2, 0.1],
    "all_nan": [np.nan] * 4,
    "inf": [np.inf, 0.5, -np.inf, 0.0],
}


@pytest.mark.parametrize("case", sorted(SPREADS))
def test_regime_score_spread_matches_reference_top_k(case):
    """The gate-margin tail's last entry: the reference's ``lax.top_k``
    spread on tied and NaN scores, bit for bit."""
    scores = np.asarray(SPREADS[case], np.float32)
    top2 = jax.lax.top_k(jnp.asarray(scores), 2)[0]
    want = np.asarray((top2[0] - top2[1]).astype(jnp.float32))

    class Ctx:
        pass

    ctx = Ctx()
    for name, v in zip(("long", "short", "range", "stress"), scores):
        setattr(ctx, f"{name}_regime_score", torch.tensor(v))
    # the spread is the block's last entry; the rest is exercised elsewhere
    N = len(tstep.STRATEGY_ORDER)
    packs = _tiny_pack(4)
    summary = tstep.TriggerSummary(
        trigger=torch.zeros((N, 4), dtype=torch.bool),
        autotrade=torch.zeros((N, 4), dtype=torch.bool),
        direction=torch.zeros((N, 4), dtype=torch.int32),
        score=torch.zeros((N, 4)), stop_loss_pct=torch.zeros((N, 4)),
    )
    ones = torch.ones(4, dtype=torch.bool)
    block = tstep._numeric_digest_block(
        packs, packs, summary, torch.zeros(4), torch.zeros(4), ones, ones, ones, ones, ones,
        torch.zeros(4, dtype=torch.bool), context=ctx,
    )
    np.testing.assert_array_equal(_bits(want), _bits(block[-1:].numpy()))


def _tiny_pack(n: int):
    """A FeaturePack of constant finite values (the fields the digest reads)."""
    fields = tstep.FeaturePack._fields
    return tstep.FeaturePack(**{f: torch.full((n,), 50.0) for f in fields})


def test_decode_and_unpack_match_reference():
    rng = np.random.default_rng(2)
    ndig = rng.integers(0, 9, tstep.NUMERIC_DIGEST_WIDTH).astype(np.float32)
    ndig[40:48] = [np.nan, 1.5, -2.0, np.inf, 0.25, np.nan, 3.0, 4.0]
    idig = rng.integers(0, 40, tstep.INGEST_DIGEST_WIDTH).astype(np.float32)
    idig[4] = np.nan  # 5m max_age_s: no tracked row holds data
    assert tstep.decode_numeric_digest(ndig) == jstep.decode_numeric_digest(ndig)
    assert tstep.decode_ingest_digest(idig) == jstep.decode_ingest_digest(idig)

    base = rng.normal(0, 1, tstep.wire_length(S)).astype(np.float32)
    base[tstep.WIRE_FIRED_COUNT_OFF] = 3.0
    for numeric, ingest in ((False, False), (True, False), (False, True), (True, True)):
        wire = np.concatenate([base] + [ndig] * numeric + [idig] * ingest)
        assert len(wire) == tstep.wire_length(S, numeric, ingest)
        jf, jctx = jstep.unpack_wire(wire, numeric_digest=numeric, ingest_digest=ingest)
        tf, tctx = tstep.unpack_wire(wire, numeric_digest=numeric, ingest_digest=ingest)
        assert jctx.keys() == tctx.keys()
        for k, v in jctx.items():
            np.testing.assert_array_equal(np.asarray(v), np.asarray(tctx[k]), err_msg=k)
        for k in ("n", "overflow"):
            assert getattr(jf, k) == getattr(tf, k)
        np.testing.assert_array_equal(jf.payload, tf.payload)
        assert ("numeric_digest" in tctx) == numeric and ("ingest_digest" in tctx) == ingest
