"""The port's ring buffer against the reference, leaf by leaf, bit for bit.

One seeded update stream — appends that wrap the ring, same-timestamp
corrections, mid-ring rewrites, stale inserts that must drop, out-of-range
rows and ``reset_rows`` churn — runs through both packages'
``apply_updates``; after every batch each leaf of the ring, of its canonical
``materialize`` view and of a ``materialize_tail`` view must be identical.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from binquant_tpu.engine import buffer as jbuf
from binquant_tpu_torch.engine import buffer as tbuf

# small shapes: extra intra-op threads only spin and crowd parallel test workers
torch.set_num_threads(1)

S, W, F, U = 16, 12, tbuf.NUM_FIELDS, 8


LEAVES = ("times", "values", "filled", "cursor")


def _assert_same(jb, tb) -> None:
    for k in LEAVES:
        a = np.asarray(getattr(jb, k))
        b = getattr(tb, k).numpy()
        assert a.dtype == b.dtype, (k, a.dtype, b.dtype)
        if a.dtype.kind == "f":
            np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=k)
            a, b = np.nan_to_num(a, nan=-7.0), np.nan_to_num(b, nan=-7.0)
        np.testing.assert_array_equal(a, b, err_msg=k)


def _stream(rng):
    """(rows (U,), ts (U,), vals (U, F)) batches, no duplicate row within a
    batch; padding rows are -1 / S / S+3 (out of range, dropped)."""
    latest = np.full(S, -1, np.int64)
    history: dict[int, list[int]] = {r: [] for r in range(S)}
    batches = []
    for step in range(40):
        n = int(rng.integers(3, U + 1))
        rows = rng.choice(S, size=n, replace=False)
        ts = []
        for r in rows:
            kind = rng.random()
            if latest[r] < 0 or kind < 0.6:  # append (sometimes skipping a bar)
                t = (latest[r] if latest[r] >= 0 else 1000 + r) + 300 * int(rng.integers(1, 3))
            elif kind < 0.75:  # same-timestamp correction of the newest bar
                t = latest[r]
            elif kind < 0.9 and len(history[r]) > 2:  # mid-ring rewrite
                t = history[r][-int(rng.integers(2, min(len(history[r]), W) + 1))]
            else:  # stale insert: older than newest, never stored -> dropped
                t = latest[r] - 150
            ts.append(t)
            if t > latest[r]:
                latest[r] = t
                history[r].append(t)
        vals = rng.normal(100, 5, (n, F)).astype(np.float32)
        pad = U - n
        rows = np.concatenate([rows, np.array([-1, S, S + 3, -5][:pad] + [-1] * max(pad - 4, 0))])
        ts = np.concatenate([np.asarray(ts), np.full(pad, 5)])
        vals = np.concatenate([vals, np.full((pad, F), 9.0, np.float32)])
        batches.append((rows.astype(np.int32), ts.astype(np.int32), vals))
    return batches


def test_ring_stream_matches_reference_every_leaf():
    rng = np.random.default_rng(11)
    jb = jbuf.empty_buffer(S, W)
    tb = tbuf.empty_buffer(S, W, device="cpu")
    _assert_same(jb, tb)
    for step, (rows, ts, vals) in enumerate(_stream(rng)):
        jb = jbuf.apply_updates(jb, jnp.asarray(rows), jnp.asarray(ts), jnp.asarray(vals))
        tb = tbuf.apply_updates(tb, torch.from_numpy(rows), torch.from_numpy(ts),
                                torch.from_numpy(vals))
        _assert_same(jb, tb)
        if step % 4 == 3:
            _assert_same(jbuf.materialize(jb), tbuf.materialize(tb))
            _assert_same(jbuf.materialize_tail(jb, 5), tbuf.materialize_tail(tb, 5))
            t5 = int(ts[0])
            np.testing.assert_array_equal(
                np.asarray(jbuf.fresh_mask(jb, jnp.int32(t5))),
                tbuf.fresh_mask(tb, torch.tensor(t5, dtype=torch.int32)).numpy(),
            )
            np.testing.assert_array_equal(
                np.asarray(jbuf.valid_mask(jb)), tbuf.valid_mask(tb).numpy()
            )
            np.testing.assert_array_equal(
                np.asarray(jbuf.ring_latest_times(jb)), tbuf.ring_latest_times(tb).numpy()
            )
        if step % 9 == 8:  # churn: clear two rows plus out-of-range ids
            churn = np.array([int(rng.integers(S)), int(rng.integers(S)), -1, S + 2], np.int32)
            jb = jbuf.reset_rows(jb, jnp.asarray(churn))
            tb = tbuf.reset_rows(tb, torch.from_numpy(churn))
            _assert_same(jb, tb)
    assert int(np.asarray(jb.filled).max()) == W  # the ring wrapped


def test_repeated_row_keeps_last_entry():
    """A row repeated within one batch keeps its last entry — what the
    reference's host batcher guarantees by deduping before the scatter."""
    tb = tbuf.empty_buffer(S, W, device="cpu")
    jb = jbuf.empty_buffer(S, W)
    rows = np.array([3, 5, 3, 7, 3], np.int32)
    ts = np.array([600, 600, 900, 600, 1200], np.int32)
    vals = np.arange(5 * F, dtype=np.float32).reshape(5, F)
    tb = tbuf.apply_updates(tb, torch.from_numpy(rows), torch.from_numpy(ts), torch.from_numpy(vals))
    keep = np.array([1, 3, 4])
    jb = jbuf.apply_updates(jb, jnp.asarray(rows[keep]), jnp.asarray(ts[keep]), jnp.asarray(vals[keep]))
    _assert_same(jb, tb)


def test_ingest_batcher_and_registry_drain_identically():
    klines = []
    for i, sym in enumerate(["btcusdt", "ETHUSDT", "S1USDT", "ETHUSDT"]):
        for j, t in enumerate((0, 300, 300, 600)[: 2 + i % 3]):
            klines.append({
                "symbol": sym, "open_time": (1_700_000_100 + t) * 1000,
                "close_time": (1_700_000_400 + t) * 1000 - 1,
                "open": 1.0 + i, "high": 2.0 + j, "low": 0.5, "close": 1.5 + j,
                "volume": 10.0 * (i + 1), "quote_asset_volume": 5.0,
            })
    out = []
    for reg_cls, bat_cls in ((jbuf.SymbolRegistry, jbuf.IngestBatcher),
                             (tbuf.SymbolRegistry, tbuf.IngestBatcher)):
        reg = reg_cls(8)
        bat = bat_cls(reg)
        bat.add_batch(np.array([0]), np.array([5]), np.ones((1, F), np.float32))
        for k in klines:
            bat.add(k)
        out.append((bat.drain(), [reg.row_of(s) for s in ("BTCUSDT", "ethusdt", "S1USDT")]))
    (jd, jr), (td, tr) = out
    assert jr == tr
    assert len(jd) == len(td)
    for a, b in zip(jd, td):
        for x, y in zip(a, b):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("dtype_leaf", ["times", "values", "filled", "cursor"])
def test_empty_buffer_dtypes(dtype_leaf):
    want = {"times": torch.int32, "values": torch.float32, "filled": torch.int32,
            "cursor": torch.int32}[dtype_leaf]
    assert getattr(tbuf.empty_buffer(4, 6, device="cpu"), dtype_leaf).dtype == want
