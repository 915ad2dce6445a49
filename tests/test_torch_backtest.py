"""The port's time-batched backtest backend against the reference's and its
own serial classic drive, on the CPU.

* ``run_backtest`` on the reference's small stream (``tests/test_backtest.py``
  ``::small_stream``: 16 symbols, 112 ticks; capacity 32, window 120,
  chunks of 16) with ``ext_invariant`` off: its signal tuples equal the
  reference's ``run_backtest`` and the port's serial full-recompute drive
  (``run_replay(incremental=False)``), exactly and in order; the chunk
  counters equal the reference's. With ``ext_invariant`` on, the fired set
  equals the serial drive's but for flips inside
  ``declared_gate_margins()``. An incremental engine and a dormant set are
  refused with the reference's errors.
* ``abp_core_batch`` bit for bit against the reference's at the default
  chunk's extension (16 ticks, three 5m bars a tick: ``n_ext`` 48 past a
  400-bar ring) and against the port's per-tick ``abp_core`` on the
  matching window views; two qtail calls per chunk at its site.
* ``compute_feature_pack_ext`` / ``compute_symbol_features_ext`` on the
  reference's synthetic extension
  (``tests/test_backtest_ext.py::test_precompute_ext_parity_synthetic``'s
  inputs): positional fields bit for bit against the per-tick pack on the
  window views and the reference's extension pass; windowed fields within
  that test's governed tolerances (``rtol=5e-4, atol=5e-3``; EWM fields
  ``rtol=2e-3, atol=0.15``), the NaN pattern equal.
* ``make_param_grid``'s combos and leaves equal the reference's; a
  4-combo ``run_param_sweep`` gives the reference's per-combo trigger and
  autotrade counts, rankings and outcome scores, exactly.
"""

from __future__ import annotations

import asyncio

import numpy as np
import pytest
import torch

from binquant_tpu.io import replay as jreplay
from binquant_tpu_torch.io import replay as treplay

torch.set_num_threads(1)

CAPACITY, WINDOW = 32, 120
# the reference engines run under tests/conftest.py's pins (observability,
# fan-out, delivery, outcomes off; ext_invariant off): the port's engines
# match where the compared quantity depends on them
PINS = dict(trace_sample=0.0, freshness=False, host_phase=False, slo=False,
            delivery_health=False, fanout=False, delivery=False)
SWEEP_AXES = {"pt.rsi_oversold": [25.0, 35.0], "abp.score_quantile": [0.9, 0.92]}


@pytest.fixture(scope="module")
def small_stream(tmp_path_factory):
    path = tmp_path_factory.mktemp("torch_bt") / "bt_16.jsonl"
    jreplay.generate_replay_file(path, n_symbols=16, n_ticks=112)
    return path


@pytest.fixture(scope="module")
def backtests(small_stream):
    from binquant_tpu.backtest import run_backtest as jrun_backtest
    from binquant_tpu_torch.backtest import run_backtest

    jax_sig: list = []
    jstats = jrun_backtest(small_stream, capacity=CAPACITY, window=WINDOW, collect=jax_sig,
                           chunk=16)
    port_sig: list = []
    stats = run_backtest(small_stream, capacity=CAPACITY, window=WINDOW, collect=port_sig,
                         chunk=16, device="cpu", ext_invariant=False)
    eng = treplay.make_stub_engine(capacity=CAPACITY, window=WINDOW, device="cpu",
                                   incremental=False, pipeline_depth=0, donate=False,
                                   outcomes=False, **PINS)
    serial = _signals(eng, treplay.tick_seq(small_stream), backtest=False)
    return jax_sig, jstats, port_sig, stats, serial


def test_backtest_tuples_equal_reference(backtests):
    """Exact: the port's backtest tuples are the reference's, in order."""
    jax_sig, _, port_sig, stats, _ = backtests
    assert len(jax_sig) > 0 and stats["device"] == "cpu"
    assert port_sig == jax_sig


def test_backtest_tuples_equal_serial_classic(backtests):
    """Exact: the backtest emits the port's serial full-recompute tuples;
    only the cold start's churn tick ran serially."""
    _, _, port_sig, stats, serial = backtests
    assert port_sig == list(serial)
    assert stats["serial_ticks"] == 1 and stats["backtest_chunks"] >= 2


@pytest.mark.parametrize(
    "counter", ["ticks", "backtest_ticks", "backtest_chunks", "backtest_overflow_reruns",
                "serial_ticks", "signals"],
)
def test_backtest_counters_equal_reference(backtests, counter):
    _, jstats, _, stats, _ = backtests
    assert stats[counter] == jstats[counter]


def _signals(engine, seq, backtest: bool) -> dict:
    """(tuple -> indicator payload) of every emitted signal of one drive."""
    out: list = []

    async def go():
        if backtest:
            out.extend(await engine.process_ticks_backtest(seq))
        else:
            for now_ms, klines in seq:
                for k in klines:
                    engine.ingest(k)
                out.extend(await engine.process_tick(now_ms=now_ms))
        out.extend(await engine.flush_pending())

    asyncio.run(go())
    return {t: s.analytics["indicators"] for s, t in zip(out, treplay.signal_tuples(out))}


def test_backtest_ext_invariant_within_gate_margins(small_stream, backtests):
    """The gate-margin contract: with ``ext_invariant`` on, the backtest's
    fired set equals the serial classic drive's but for flips of declared
    strategies whose gated RSI/MFI lies within the declared margin of its
    threshold."""
    from binquant_tpu_torch.strategies.params import StrategyParams, declared_gate_margins

    seq = treplay.tick_seq(small_stream)
    eng = treplay.make_stub_engine(capacity=CAPACITY, window=WINDOW, device="cpu",
                                   incremental=False, pipeline_depth=0, donate=False,
                                   outcomes=False, ext_invariant=True, **PINS)
    got = _signals(eng, seq, backtest=True)
    assert eng.ext_invariant and eng.backtest_chunks >= 2
    serial = backtests[4]
    margins = declared_gate_margins()
    p = StrategyParams()
    gates = {
        "coinrule_price_tracker": [("rsi", p.pt.rsi_oversold), ("mfi", p.pt.mfi_oversold)],
        "mean_reversion_fade": [("rsi", p.mrf.rsi_long_max), ("rsi", p.mrf.rsi_short_min)],
    }
    for flip in set(got) ^ set(serial):
        ind = got.get(flip, {})
        dists = [abs(float(ind[k]) - thr) for k, thr in gates.get(flip[1], ())
                 if ind.get(k) is not None]
        assert flip[1] in margins and dists and min(dists) <= margins[flip[1]], flip
    assert len(got) > 0


def test_backtest_rejects_incremental_engines_and_dormant_sets(small_stream):
    """The reference's guard rails and errors: full-recompute engines only,
    and only the strategies whose gated half reads no buffer."""
    from binquant_tpu_torch.backtest import run_backtest
    from binquant_tpu_torch.backtest.driver import drive_ticks_backtest

    eng = treplay.make_stub_engine(capacity=CAPACITY, window=WINDOW, device="cpu",
                                   incremental=True, **PINS)
    with pytest.raises(ValueError, match="full-recompute"):
        asyncio.run(drive_ticks_backtest(eng, []))
    with pytest.raises(ValueError, match="cannot evaluate"):
        run_backtest(small_stream, capacity=CAPACITY, window=WINDOW, device="cpu",
                     enabled_strategies={"coinrule_buy_the_dip"})


# --------------------------------------------------------------------------
# the kernels
# --------------------------------------------------------------------------


def _abp_extension(S: int, W: int, T: int, seed: int = 4):
    """A 5m extension at the default chunk's shape: W ring bars with mixed
    history depth, then 3 bars a tick for T ticks (a few rows miss bars),
    volume bursts on a tenth of the appended bars."""
    from tests.test_backtest_ext import _make_ext

    ext_t, ext_v, _, filled0, _, _ = _make_ext(S, W, 3 * T, seed=seed, spacing=300)
    rng = np.random.default_rng(seed)
    burst = rng.random((S, 3 * T)) < 0.1
    app = ext_v[:, W:]
    app[..., 4] = np.where(burst, app[..., 4] * 8.0, app[..., 4])
    app[..., 3] = np.where(burst, app[..., 0] * 1.03, app[..., 3])
    app[..., 1] = np.maximum(app[..., 1], app[..., 3] * 1.002)
    app[..., 5] = app[..., 4] * app[..., 3]
    counts = np.tile((3 * np.arange(1, T + 1, dtype=np.int32))[:, None], (1, S))
    counts[:, 5] = np.minimum(counts[:, 5], 3 * T - 6)  # a row that lags
    ext_v[5, W + 3 * T - 6:] = np.nan
    ext_t[5, W + 3 * T - 6:] = -1
    return ext_t, ext_v, counts, filled0


def test_abp_core_batch_bit_equal_reference_and_per_tick():
    """Bit for bit: the port's ``abp_core_batch`` at 64 x (400 + 48), 16
    ticks, equals the reference's and the port's ``abp_core`` on each
    tick's window view; the qtail twin served two calls at its site."""
    import jax.numpy as jnp

    from binquant_tpu.strategies.activity_burst_pump import abp_core_batch as jabp
    from binquant_tpu_torch.backtest.kernel import _at, _window_views
    from binquant_tpu_torch.ops import quantile_tail as qt
    from binquant_tpu_torch.strategies.activity_burst_pump import abp_core, abp_core_batch

    S, W, T = 64, 400, 16
    ext_t, ext_v, counts, filled0 = _abp_extension(S, W, T)
    qt.reset_launches()
    q, score, diag = abp_core_batch(torch.from_numpy(ext_v), torch.from_numpy(counts), W)
    assert qt.twin_calls_by_site == {"abp_core_batch": 2}
    jq, jscore, jdiag = jabp(jnp.asarray(ext_v), jnp.asarray(counts), W)

    def same(a, b, name):
        a = a.numpy()
        b = np.asarray(b)
        if a.dtype == np.float32:
            a, b = a.view(np.int32), b.view(np.int32)
        np.testing.assert_array_equal(a, b, err_msg=name)

    same(q, jq, "qualified")
    same(score, jscore, "score_last")
    assert list(diag) == list(jdiag)
    for k in diag:
        same(diag[k], jdiag[k], k)
    assert q.any()  # the bursts qualify somewhere: not an all-False match

    views = _window_views(torch.from_numpy(ext_t), torch.from_numpy(ext_v),
                          torch.from_numpy(counts), torch.from_numpy(filled0), W)
    for t in range(T):
        q1, s1, d1 = abp_core(_at(views, t))
        assert torch.equal(q1, q[t])
        assert torch.equal(s1.view(torch.int32), score[t].view(torch.int32))
        for k in d1:
            assert torch.equal(d1[k].view(torch.int32), diag[k][t].view(torch.int32)), k


def test_feature_pack_and_symbol_features_ext_margin_contract():
    """The extension-invariant contract on the reference's synthetic chunk
    (8 symbols, window 120, 12 ticks): positional fields bit for bit and
    windowed fields within the governed tolerances, against the port's
    per-tick pack on the window views and against the reference's
    extension pass."""
    import jax.numpy as jnp

    from binquant_tpu.regime.context import compute_symbol_features_ext as jfeats_ext
    from binquant_tpu.strategies.features import compute_feature_pack_ext as jpack_ext
    from binquant_tpu_torch.backtest.kernel import _at, _window_views
    from binquant_tpu_torch.regime.context import (
        compute_symbol_features,
        compute_symbol_features_ext,
    )
    from binquant_tpu_torch.strategies.features import (
        compute_feature_pack,
        compute_feature_pack_ext,
    )
    from tests.test_backtest_ext import (
        CUMSUM_PACK_FIELDS,
        EWM_PACK_FIELDS,
        POSITIONAL_PACK_FIELDS,
        _assert_governed_close,
        _make_ext,
    )

    S, W, N = 8, 120, 12
    ext_t, ext_v, counts, f0, _, _ = _make_ext(S, W, N, seed=1, spacing=900,
                                                t0=1_780_272_000 - 900)
    tt, tv, tc, tf = (torch.from_numpy(x) for x in (ext_t, ext_v, counts, f0))
    pack = compute_feature_pack_ext(tt, tv, tc, tf, W)
    eligible = torch.ones((N, S), dtype=torch.bool)
    feats = compute_symbol_features_ext(tt, tv, tc, tf, W, eligible)
    views = _window_views(tt, tv, tc, tf, W)
    per_tick = [compute_feature_pack(_at(views, t)) for t in range(N)]
    per_tick_feats = [compute_symbol_features(_at(views, t), eligible[t]) for t in range(N)]
    jpack = jpack_ext(jnp.asarray(ext_t), jnp.asarray(ext_v), jnp.asarray(counts),
                      jnp.asarray(f0), W)
    jfeats = jfeats_ext(jnp.asarray(ext_t), jnp.asarray(ext_v), jnp.asarray(counts),
                        jnp.asarray(f0), W, jnp.asarray(eligible.numpy()))

    ref_pack = {f: np.stack([getattr(p, f).numpy() for p in per_tick]) for f in pack._fields}
    for f in pack._fields:
        got = getattr(pack, f).numpy()
        for ref, who in ((ref_pack[f], "views"), (np.asarray(getattr(jpack, f)), "reference")):
            if f in POSITIONAL_PACK_FIELDS:
                np.testing.assert_array_equal(got, ref, err_msg=f"{f} vs {who}")
            elif f in CUMSUM_PACK_FIELDS:
                _assert_governed_close(f"{f} vs {who}", ref, got)
            else:
                assert f in EWM_PACK_FIELDS
                _assert_governed_close(f"{f} vs {who}", ref, got, rtol=2e-3, atol=0.15)
    for f in feats._fields:
        got = getattr(feats, f).numpy()
        views_ref = np.stack([getattr(x, f).numpy() for x in per_tick_feats])
        for ref, who in ((views_ref, "views"), (np.asarray(getattr(jfeats, f)), "reference")):
            if got.dtype.kind in "biu":
                np.testing.assert_array_equal(got, ref, err_msg=f"feats.{f} vs {who}")
            else:
                _assert_governed_close(f"feats.{f} vs {who}", ref, got, rtol=2e-3, atol=0.15)


# --------------------------------------------------------------------------
# the sweep
# --------------------------------------------------------------------------


def test_param_grid_equals_reference():
    """Exact: the sweepable axes, the combos and every leaf of the grid
    (float32 columns on the swept leaves, the base value elsewhere) equal
    the reference's; structural and unknown axes raise its errors."""
    from binquant_tpu.strategies import params as jparams
    from binquant_tpu_torch.strategies import params as tparams

    assert tparams.sweepable_axes() == jparams.sweepable_axes()
    axes = {"mrf.rsi_long_max": [20.0, 25.0], "pt.rsi_oversold": [25.0, 30.0, 35.0],
            "pt.weights.context_weight": [0.1, 0.3]}
    grid, combos = tparams.make_param_grid(axes)
    jgrid, jcombos = jparams.make_param_grid(axes)
    assert combos == jcombos
    assert tparams.grid_size(grid) == jparams.grid_size(jgrid) == 12
    for (path, _, _, v), (jpath, _, _, jv) in zip(
        tparams._leaf_path_items(grid), jparams._leaf_path_items(jgrid), strict=True
    ):
        assert path == jpath
        if isinstance(jv, np.ndarray):
            assert v.dtype == jv.dtype and np.array_equal(v, jv), path
            assert tparams.param_axes(grid) is not None
        else:
            assert type(v) is type(jv) and v == jv, path
    assert tparams.grid_combo(grid, 7).pt.rsi_oversold == combos[7]["pt.rsi_oversold"]
    with pytest.raises(KeyError):
        tparams.make_param_grid({"abp.nope": [1.0]})
    with pytest.raises(ValueError):
        tparams.make_param_grid({"abp.lookback_window": [10, 20]})


@pytest.fixture(scope="module")
def sweeps(small_stream):
    from binquant_tpu.backtest import run_param_sweep as jsweep
    from binquant_tpu_torch.backtest import run_param_sweep

    kw = dict(axes=SWEEP_AXES, capacity=CAPACITY, window=WINDOW, chunk=16)
    return jsweep(small_stream, **kw), run_param_sweep(small_stream, device="cpu", **kw)


@pytest.mark.parametrize(
    "key", ["P", "combos", "trig_counts", "autotrade_counts", "total_fired", "ranking",
            "evaluated_ticks", "dispatches", "candles"],
)
def test_param_sweep_counts_equal_reference(sweeps, key):
    """Exact: the 4-combo sweep's per-combo counts and ranking."""
    ref, got = sweeps
    assert got[key] == ref[key]
    assert sum(got["total_fired"]) > 0


def test_param_sweep_outcomes_equal_reference(sweeps):
    """Exact: the outcome scorer's ranking by return, per-combo scores and
    pair accounting (the same float32 gathers, the same host arithmetic)."""
    ref, got = sweeps
    a, b = ref["outcomes"], got["outcomes"]
    for k in ("enabled", "horizons", "score_horizon", "combo_score", "ranking_by_return",
              "matured_pairs", "truncated", "unmatured_pair_horizons",
              "overflow_dropped_slots", "per_combo"):
        assert a[k] == b[k], k
    assert b["matured_pairs"] > 0


def test_auto_sweep_chunk_matches_reference():
    from binquant_tpu.backtest.driver import _auto_sweep_chunk as jauto
    from binquant_tpu_torch.backtest.driver import _auto_sweep_chunk

    for args in ((16, 4, 64, 1024), (16, 4096, 512, 1024), (64, 256, 256, 1024),
                 (16, 10_000, 4096, 64)):
        assert _auto_sweep_chunk(*args) == jauto(*args)
