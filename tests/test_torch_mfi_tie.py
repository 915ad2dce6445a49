"""The MFI flow of a flat bar on the incremental path: the port against
the reference, including the reference's compiled rounding.

The reference's carry advance computes a bar's typical-price delta as
``(h+l+c)/3.0 - (h'+l'+c')/3.0``. XLA compiles the division into a
multiplication by ``f32(1/3)``, and the CPU backend contracts the
subtraction with the older bar's product into one fused multiply-add, so a
bar whose ``h+l+c`` equals its predecessor's gets a delta of one rounding
residue, not 0, and its flow is booked up or down by the residue's sign.
The port reproduces that form (``strategies/features.py::_flows_at``).

* S027USDT's two tied 5m bars of ``tests/fixtures/market_36h_100sym.jsonl.gz``
  (opens 1753108500000 and 1753108800000, ``h+l+c`` = f32 0.20666301 for
  both), with rows of repeated bars beside them, advanced by both packages'
  ``advance_feature_carry`` from the same carry: the MFI flow sums bit for
  bit, the reference jitted as its engine runs it. On these bars the tie
  books a flow (the sums move by the bar's flow), as the reference does.
* The same on seeded rows at two more shapes; the full-window init books
  a tied bar as flat in both packages.
* ``slow``: the whole fixture replayed by both packages on the incremental
  path (capacity 128, window 200, depth 0, no digests), with the live set
  and with all fourteen strategies: equal signal tuples, in order (~70 s
  on the CPU for both).
"""

from __future__ import annotations

import gzip
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from binquant_tpu.engine import buffer as jbuf
from binquant_tpu.io import replay as jreplay
from binquant_tpu.strategies import features as jfeat
from binquant_tpu_torch.engine import buffer as tbuf
from binquant_tpu_torch.engine.step import STRATEGY_ORDER
from binquant_tpu_torch.io import replay as treplay
from binquant_tpu_torch.ops import incremental as tinc
from binquant_tpu_torch.strategies import features as tfeat

# small shapes: extra intra-op threads only spin and crowd parallel test workers
torch.set_num_threads(1)

FIXTURE = Path(__file__).resolve().parent / "fixtures" / "market_36h_100sym.jsonl.gz"
TIE_OPENS = (1753108500000, 1753108800000)
FIELDS = ("open", "high", "low", "close", "volume", "quote_asset_volume",
          "number_of_trades", "taker_buy_base_volume", "taker_buy_quote_volume")


def _s027_bars(n: int) -> np.ndarray:
    """S027USDT's last ``n`` 5m bars up to the second tied bar, (n, 10) f32
    in the ring's field order."""
    bars = {}
    with gzip.open(FIXTURE, "rt") as f:
        for line in f:
            k = json.loads(line)
            if k["symbol"] != "S027USDT" or k["close_time"] - k["open_time"] != 299_999:
                continue
            if k["open_time"] <= TIE_OPENS[1]:
                bars[k["open_time"]] = [float(k[f]) for f in FIELDS] + [300.0]
    opens = sorted(bars)[-n:]
    assert opens[-2:] == list(TIE_OPENS)
    return np.asarray([bars[o] for o in opens], np.float32)


def _rows(rng, S: int, n: int, s027: np.ndarray | None) -> np.ndarray:
    """(S, n, 10) bars: seeded random walks whose last bar repeats the one
    before it (a tie) on every row; row 0 is S027USDT's own bars."""
    close = (rng.uniform(0.01, 200.0, (S, 1))
             * np.exp(np.cumsum(rng.normal(0, 0.01, (S, n)), axis=1)))
    high, low = close * 1.004, close * 0.996
    vol = rng.uniform(1.0, 5000.0, (S, n))
    vals = np.stack(
        [close, high, low, close, vol, vol * close, np.full_like(close, 50.0),
         vol / 2, vol * close / 2, np.full_like(close, 300.0)], axis=-1,
    ).astype(np.float32)
    vals[:, -1, :4] = vals[:, -2, :4]
    if s027 is not None:
        vals[0] = s027
    return vals


def _buffers(vals: np.ndarray, lo: int, W: int):
    S = vals.shape[0]
    times = (np.arange(lo, lo + W, dtype=np.int32) * 300)[None].repeat(S, 0) + 1_750_000_000
    v = np.ascontiguousarray(vals[:, lo:lo + W])
    filled = np.full(S, W, np.int32)
    cursor = np.zeros(S, np.int32)
    j = jbuf.MarketBuffer(jnp.asarray(times), jnp.asarray(v), jnp.asarray(filled),
                          jnp.asarray(cursor))
    t = tbuf.MarketBuffer(torch.from_numpy(times), torch.from_numpy(v),
                          torch.from_numpy(filled), torch.from_numpy(cursor))
    return j, t


def _to_port(jc) -> tfeat.FeatureCarry:
    def conv(v):
        if isinstance(v, tuple):
            return type(v)(*(conv(x) for x in v))
        return torch.from_numpy(np.array(np.asarray(v)))

    fields = {}
    for name in jfeat.FeatureCarry._fields:
        v = getattr(jc, name)
        if isinstance(v, tuple):
            cls = getattr(tinc, type(v).__name__)
            fields[name] = cls(*(conv(x) for x in v))
        else:
            fields[name] = conv(v)
    return tfeat.FeatureCarry(**fields)


def _advance_both(vals: np.ndarray, W: int):
    """The reference's jitted init on the window before the last bar, then
    its jitted advance by the last bar, and the port's advance from the
    same (converted) carry; returns both carries before and after."""
    j0, _ = _buffers(vals, 0, W)
    j1, t1 = _buffers(vals, 1, W)
    jc0 = jax.jit(jfeat.init_feature_carry)(j0)
    jc1, _ = jax.jit(jfeat.advance_feature_carry)(j1, jc0)
    tc1, _ = tfeat.advance_feature_carry(t1, _to_port(jc0))
    return jc0, jc1, tc1


def _assert_flows_equal(jc1, tc1) -> None:
    for family in ("pos_flow", "neg_flow"):
        for leaf in ("wsum", "cnt"):
            j = np.asarray(getattr(getattr(jc1, family), leaf))
            t = getattr(getattr(tc1, family), leaf).numpy()
            assert j.dtype == t.dtype, (family, leaf)
            np.testing.assert_array_equal(t, j, err_msg=f"{family}.{leaf}")


def test_s027_tied_bars_book_the_reference_flow():
    W = 40
    s027 = _s027_bars(W + 1)
    hlc = s027[-2:, 1] + s027[-2:, 2]
    hlc = hlc + s027[-2:, 3]
    assert hlc[0] == hlc[1] == np.float32(0.20666301)
    vals = _rows(np.random.default_rng(6), 8, W + 1, s027)
    jc0, jc1, tc1 = _advance_both(vals, W)
    _assert_flows_equal(jc1, tc1)
    # the tie books the bar's flow on one side: the sums move by it
    moved = [
        float(np.asarray(getattr(jc1, f).wsum)[0]) - float(np.asarray(getattr(jc0, f).wsum)[0])
        for f in ("pos_flow", "neg_flow")
    ]
    flow = float(s027[-1, 1] + s027[-1, 2] + s027[-1, 3]) / 3 * float(s027[-1, 4])
    old_pos, old_neg = (
        float(v) for v in (tfeat._flows_at(_buffers(vals, 1, W)[1], -15)[i][0] for i in (0, 1))
    )
    assert max(abs(moved[0] + old_pos), abs(moved[1] + old_neg)) == pytest.approx(flow, rel=1e-3)


@pytest.mark.parametrize("shape", [(16, 40), (64, 130)])
def test_tied_rows_book_the_reference_flow(shape):
    S, W = shape
    vals = _rows(np.random.default_rng(S + W), S, W + 1, None)
    _, jc1, tc1 = _advance_both(vals, W)
    _assert_flows_equal(jc1, tc1)


def test_init_books_a_tie_as_flat_as_the_reference():
    """The full-window carry init has no such contraction in either
    package: a tied bar inside the window books no flow, so the sums agree
    to summation order (a booked tie would move them by the bar's flow)."""
    W = 40
    vals = _rows(np.random.default_rng(9), 32, W + 1, _s027_bars(W + 1))
    vals[:, 10, :4] = vals[:, 9, :4]  # a second tie inside the window
    j0, t0 = _buffers(vals, 1, W)
    jc = jax.jit(jfeat.init_feature_carry)(j0)
    tc = tfeat.init_feature_carry(t0)
    for family in ("pos_flow", "neg_flow"):
        j, t = getattr(jc, family), getattr(tc, family)
        np.testing.assert_array_equal(t.cnt.numpy(), np.asarray(j.cnt))
        np.testing.assert_allclose(t.wsum.numpy(), np.asarray(j.wsum), rtol=1e-5)


@pytest.mark.slow
@pytest.mark.parametrize("enabled", ["live", "all"])
def test_fixture_replay_incremental_equal(enabled):
    strategies = None if enabled == "live" else set(STRATEGY_ORDER)
    j: list = []
    jreplay.run_replay(FIXTURE, capacity=128, window=200, collect=j, pipeline_depth=0,
                       incremental=True, enabled_strategies=strategies)
    t: list = []
    treplay.run_replay(FIXTURE, capacity=128, window=200, collect=t, device="cpu",
                       incremental=True, pipeline_depth=0, donate=False,
                       numeric_digest=False, ingest_digest=False, drift_meter=False,
                       outcomes=False, enabled_strategies=strategies)
    assert len(t) == len(j) > 200
    assert t == j
