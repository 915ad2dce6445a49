"""The carry-drift meter: the port against the reference.

* ``_ulp_distance`` and ``_drift_of`` on crafted pairs (adjacent floats,
  signed zeros, a sign crossing, NaN, ±inf, masked positions) equal the
  reference's bit for bit.
* ``measure_carry_drift`` on ONE state — the reference's rings and carry
  after a few carry-advancing folds, converted into the port with
  ``engine/convert.py`` — measured with the same update in both packages:
  every family's ``compared`` count is exact and so is the alarm verdict;
  ``max_rel`` agrees within 4e-5 (the carry leaves it compares agree
  within ``rtol=1e-5`` of their scale across the packages, and it is the
  gap of two of them over that scale). ``max_abs`` and ``max_ulp`` are not
  held: each is a maximum over leaves of different scales. Measured on a
  clean stream and on a volatile one whose carried supertrend has drifted
  further (the reference's own divergence drill).
* An audit tick with the meter on leaves the engine's rings and carry bit
  for bit as the same tick with the meter off, with the rings updated in
  place (the meter applies its updates to a functional copy).
"""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from binquant_tpu.engine import buffer as jbuf
from binquant_tpu.engine import step as jstep
from binquant_tpu_torch.engine import step as tstep
from binquant_tpu_torch.engine.convert import engine_state_from_numpy
from binquant_tpu_torch.io import replay as treplay

# small shapes: extra intra-op threads only spin and crowd parallel test workers
torch.set_num_threads(1)

S, W, F = 16, 130, jbuf.NUM_FIELDS
T0 = 1_780_272_000


def test_ulp_distance_and_drift_of_bit_exact():
    one = np.float32(1.0)
    a = np.array([1.0, -2.5, 0.0, -0.0, 3.0, np.nan, np.inf, -1e-30, 7.0, 1e30],
                 np.float32)
    b = np.array([np.nextafter(one, np.float32(2)), -2.5, -0.0, 1e-45, -3.0, 1.0, np.inf,
                  1e-30, 7.000002, 1.0000001e30], np.float32)
    ju = np.asarray(jstep._ulp_distance(jnp.asarray(a), jnp.asarray(b)))
    tu = tstep._ulp_distance(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_array_equal(ju.view(np.int32), tu.view(np.int32))
    assert tu[0] == 1 and tu[1] == 0 and tu[2] == 0  # adjacent, equal, ±0
    mask = np.array([1, 1, 1, 1, 1, 1, 1, 1, 0, 1], bool)
    pairs = [(a, b, mask), (a.reshape(2, 5), b.reshape(2, 5), mask.reshape(2, 5)[:, :1])]
    jd = jstep._drift_of([tuple(map(jnp.asarray, p)) for p in pairs])
    td = tstep._drift_of([tuple(map(torch.from_numpy, p)) for p in pairs])
    for k in ("max_abs", "max_rel", "max_ulp", "compared"):
        assert td[k].dtype == (torch.int32 if k == "compared" else torch.float32)
        np.testing.assert_array_equal(np.asarray(jd[k]), td[k].numpy(), err_msg=k)


def _bars(rng, n: int, vol: float) -> np.ndarray:
    """(S, n, F) seeded bars in the ring's field order."""
    rets = rng.normal(0.0, vol, (S, n))
    close = (30 + np.arange(S)[:, None]) * np.exp(np.cumsum(rets, axis=1))
    open_ = np.concatenate([close[:, :1], close[:, :-1]], axis=1)
    high = np.maximum(open_, close) * (1 + vol / 3)
    low = np.minimum(open_, close) * (1 - vol / 3)
    v = np.abs(rng.normal(1000, 250, (S, n)))
    return np.stack([open_, high, low, close, v, v * close, np.full_like(v, 300.0),
                     v / 2, v * close / 2, np.full_like(v, 900.0)], axis=-1).astype(np.float32)


def _upd(bars: np.ndarray, k: int, ts: int, rows: np.ndarray):
    return (rows.astype(np.int32), np.full(len(rows), ts, np.int32), bars[rows, k])


def _measured(seed: int, vol: float, advances: int):
    """The reference's state after ``advances`` carry-advancing folds from a
    fresh init, its conversion into the port, and the next tick's update."""
    rng = np.random.default_rng(seed)
    bars = _bars(rng, W + advances + 1, vol)
    rows = np.arange(S)
    rows_short = rows[rows != 6]  # row 6 misses the bars after the init: stale
    jstate = jstep.initial_engine_state(S, window=W)
    fill = jax.jit(jstep.apply_updates_step)
    for k in range(W):
        u = tuple(map(jnp.asarray, _upd(bars, k, T0 + 900 * k, rows)))
        jstate = fill(jstate, u, u)
    jstate = jstate._replace(
        indicator_carry=jax.jit(jstep.init_indicator_carry)(jstate.buf5, jstate.buf15, 0))
    for k in range(W, W + advances):
        u = tuple(map(jnp.asarray, _upd(bars, k, T0 + 900 * k, rows_short)))
        jstate = jstep.apply_updates_carry_step(jstate, u, u, btc_row=0)
    k = W + advances
    u = _upd(bars, k, T0 + 900 * k, rows_short)
    leaves = jax.tree_util.tree_map(np.asarray, jstate)
    tstate = engine_state_from_numpy(_as_dict(leaves), "cpu")
    jd = jstep.measure_carry_drift(jstate, tuple(map(jnp.asarray, u)), tuple(map(jnp.asarray, u)), 0)
    td = tstep.measure_carry_drift(tstate, tuple(map(torch.from_numpy, u)),
                                   tuple(map(torch.from_numpy, u)), 0)
    return jd, td


def _as_dict(tree):
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return {f: _as_dict(v) for f, v in zip(tree._fields, tree)}
    return tree


@pytest.mark.parametrize("stream", ["clean", "volatile"])
def test_measure_carry_drift_matches_reference(stream):
    jd, td = _measured(*{"clean": (5, 0.006, 3), "volatile": (9, 0.02, 30)}[stream])
    assert list(td) == list(tstep.DRIFT_FAMILIES) and set(jd) == set(td)
    tol = 0.05
    for fam in tstep.DRIFT_FAMILIES:
        j, t = jd[fam], td[fam]
        assert t["compared"] == j["compared"], fam
        assert (t["compared"] > 0 and t["max_rel"] > tol) == (j["compared"] > 0 and j["max_rel"] > tol), fam
        assert abs(t["max_rel"] - j["max_rel"]) <= 4e-5, (fam, j, t)
    assert all(td[f]["compared"] > 0 for f in ("ewm", "sums", "moments", "abp_sorted", "lsp_sorted"))


def _engine_drive(drift_meter: bool, path):
    engine = treplay.make_stub_engine(capacity=16, window=100, device="cpu",
                                      incremental=True, carry_audit_every=5,
                                      drift_meter=drift_meter)
    assert engine._donation_mode() == "single"  # the rings update in place

    async def go():
        for tick_ms, klines in treplay.tick_seq(path):
            for k in klines:
                engine.ingest(k)
            await engine.process_tick(now_ms=tick_ms)
        await engine.flush_pending()

    asyncio.run(go())
    return engine


def test_audit_tick_with_the_meter_leaves_the_state_as_without(tmp_path):
    path = tmp_path / "rp.jsonl"
    treplay.generate_replay_file(path, n_symbols=8, n_ticks=12, seed=4)
    on = _engine_drive(True, path)
    off = _engine_drive(False, path)
    assert on.drift.audits == 2 and on.drift.skipped == 0 and off.drift.audits == 0
    assert on.full_recompute_reasons == off.full_recompute_reasons == {"cold_start": 1, "audit": 2}
    la, _ = torch.utils._pytree.tree_flatten(on.state)
    lb, _ = torch.utils._pytree.tree_flatten(off.state)
    for a, b in zip(la, lb, strict=True):
        assert a.dtype == b.dtype and torch.equal(
            a.view(torch.int32) if a.dtype.is_floating_point else a,
            b.view(torch.int32) if b.dtype.is_floating_point else b,
        )
