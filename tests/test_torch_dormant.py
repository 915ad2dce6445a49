"""The dormant strategy set: the port against the reference.

* The nine kernels. Both packages evaluate each one on the same pair of
  rings (5m and 15m, S=24, W=200) built from the reference's two dormant
  markets (``generate_dormant_replay``, ``generate_dormant_extended_replay``:
  their crafted setups sit on the last bar; the second also one tick
  earlier, where BuyLowSellHigh fires) and on ONE market context, the
  reference's, handed to the port as tensors: once as computed, once
  recast as a low-stress RANGE selloff so that the range-gated kernels
  route. SupertrendSwingReversal runs both from the window scan and from a
  carried ``st_up`` readout; BBExtremeReversion enabled. Masks, directions,
  route codes and sort-based outputs must be bit-exact with the
  reference's dtypes; floats built on sums or EWMs at ``rtol=1e-5`` with a
  price-scale absolute floor.
* One wire step with all fourteen strategies enabled, classic and
  incremental, against the reference's ``tick_step_wire`` from the same
  state: the fired block (count, strategy, row, autotrade, direction)
  exact, floats at ``rtol=1e-5`` with an absolute floor of 1e-5 of their
  scale, and dormant strategies among the fired.

The replays of the two markets sit in ``tests/test_torch_dormant_replay.py``.
"""

from importlib import import_module

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from binquant_tpu.engine import buffer as jbuf
from binquant_tpu.engine import step as jstep
from binquant_tpu.regime import context as jctx
from binquant_tpu.strategies import features as jfeat
from binquant_tpu_torch.engine import buffer as tbuf
from binquant_tpu_torch.engine import step as tstep
from binquant_tpu_torch.engine.convert import engine_state_from_numpy
from binquant_tpu_torch.io import replay as treplay
from binquant_tpu_torch.regime import context as tctx
from binquant_tpu_torch.strategies import dormant as tdor
from binquant_tpu_torch.strategies import features as tfeat
from binquant_tpu_torch.strategies import spike_hunter as tsh

# small shapes: extra intra-op threads only spin and crowd parallel test workers
torch.set_num_threads(1)

jdor = import_module("binquant_tpu.strategies.dormant")
jsh = import_module("binquant_tpu.strategies.spike_hunter")

N_SYMBOLS, W, F = 24, 200, jbuf.NUM_FIELDS
DORMANT = (
    "coinrule_supertrend_swing_reversal", "coinrule_twap_momentum_sniper",
    "coinrule_buy_low_sell_high", "coinrule_buy_the_dip", "bb_extreme_reversion",
    "inverse_price_tracker", "range_bb_rsi_mean_reversion", "range_failed_breakout_fade",
    "relative_strength_reversal_range",
)
FIELDS = ("open", "high", "low", "close", "volume", "quote_asset_volume",
          "number_of_trades", "taker_buy_base_volume", "taker_buy_quote_volume")


def _rings(path, drop_last: bool = False):
    """Right-aligned canonical 5m and 15m rings (numpy leaves) from a kline
    file; ``drop_last`` leaves the last 15m bar and its three 5m bars out
    and returns them as the tick's update batches."""
    bars = {300: {}, 900: {}}
    for _, klines in treplay.tick_seq(path):
        for k in klines:
            iv = (k["close_time"] + 1 - k["open_time"]) // 1000
            row = 0 if k["symbol"] == "BTCUSDT" else int(k["symbol"][1:4])
            vals = [k[f] for f in FIELDS] + [float(iv)]
            bars[iv].setdefault(row, []).append((k["open_time"] // 1000, vals))
    rings, last = {}, {}
    for iv, per_row in bars.items():
        times = np.full((N_SYMBOLS, W), -1, np.int32)
        values = np.full((N_SYMBOLS, W, F), np.nan, np.float32)
        filled = np.zeros(N_SYMBOLS, np.int32)
        n_last = 3 if iv == 300 else 1
        last[iv] = []
        for row, seq in per_row.items():
            seq = sorted(seq)
            if drop_last:
                last[iv].append((row, seq[-n_last:]))
                seq = seq[:-n_last]
            seq = seq[-W:]
            times[row, W - len(seq):] = [t for t, _ in seq]
            values[row, W - len(seq):] = [v for _, v in seq]
            filled[row] = len(seq)
        rings[iv] = dict(times=times, values=values, filled=filled,
                         cursor=np.zeros(N_SYMBOLS, np.int32))
    if not drop_last:
        return rings
    updates = {}
    for iv, per_row in last.items():
        n = 3 if iv == 300 else 1
        updates[iv] = [
            (np.array([r for r, _ in per_row], np.int32),
             np.array([seq[j][0] for _, seq in per_row], np.int32),
             np.array([seq[j][1] for _, seq in per_row], np.float32))
            for j in range(n)
        ]
    return rings, updates


def _jbuf(d):
    return jbuf.MarketBuffer(*(jnp.asarray(d[f]) for f in jbuf.MarketBuffer._fields))


def _tbuf(d):
    return tbuf.MarketBuffer(*(torch.from_numpy(d[f].copy()) for f in tbuf.MarketBuffer._fields))


def _port_nt(cls, ref):
    return cls(**{f: torch.from_numpy(np.array(getattr(ref, f))) for f in ref._fields})


def _port_context(jc):
    feats = _port_nt(tctx.SymbolFeatureArrays, jc.features)
    return tctx.MarketContext(
        **{f: feats if f == "features" else torch.from_numpy(np.array(getattr(jc, f)))
           for f in jc._fields}
    )


@pytest.fixture(scope="module")
def markets(tmp_path_factory):
    d = tmp_path_factory.mktemp("dormant")
    paths = {"dormant": d / "dormant.jsonl", "extended": d / "extended.jsonl"}
    treplay.generate_dormant_replay(paths["dormant"])
    treplay.generate_dormant_extended_replay(paths["extended"])
    return paths


@pytest.fixture(scope="module")
def worlds(markets):
    out = {}
    pack = jax.jit(jfeat.compute_feature_pack)
    sources = {
        "dormant": _rings(markets["dormant"]),
        "extended": _rings(markets["extended"]),
        # the tick before: BuyLowSellHigh's transient fires here
        "extended_prev": _rings(markets["extended"], drop_last=True)[0],
    }
    for name, rings in sources.items():
        jb5, jb15 = _jbuf(rings[300]), _jbuf(rings[900])
        tb5, tb15 = _tbuf(rings[300]), _tbuf(rings[900])
        fresh = rings[900]["filled"] > 0
        ts15 = int(rings[900]["times"][0, -1])
        jc, _ = jctx.compute_market_context(
            jb15, jnp.asarray(fresh), jnp.asarray(fresh), jnp.int32(0), jnp.int32(ts15),
            jctx.initial_regime_carry(N_SYMBOLS),
            jctx.ContextConfig(required_fresh_symbols=4, min_coverage_ratio=0.5),
        )
        # the same context recast as a low-stress RANGE selloff
        jrange = jc._replace(
            valid=jnp.asarray(True), market_regime=jnp.asarray(3, jnp.int32),
            regime_is_transitioning=jnp.asarray(False),
            market_stress_score=jnp.float32(0.1), average_return=jnp.float32(-0.03),
        )
        jp5, jp15 = pack(jb5), pack(jb15)
        jspikes = jax.jit(jsh.detect_spikes)(jb15)
        for ctx_name, jcc in (("computed", jc), ("range", jrange)):
            out[(name, ctx_name)] = dict(
                jb5=jb5, jb15=jb15, tb5=tb5, tb15=tb15, jctx=jcc, tctx=_port_context(jcc),
                jp5=jp5, jp15=jp15, tp5=_port_nt(tfeat.FeaturePack, jp5),
                tp15=_port_nt(tfeat.FeaturePack, jp15), jspikes=jspikes,
                tspikes=tsh.detect_spikes(tb15),
            )
    return out


def _scalars(quiet: bool):
    j = dict(adp=jnp.float32(0.04), dom=jnp.asarray(True), quiet=jnp.asarray(quiet))
    t = dict(adp=torch.tensor(0.04), dom=torch.tensor(True), quiet=torch.tensor(quiet))
    return j, t


def _run(kernel, w, quiet):
    js, ts = _scalars(quiet)
    gate = np.arange(N_SYMBOLS) % 3 != 0
    if kernel == "coinrule_supertrend_swing_reversal":
        args = lambda m, s, g, st=None: (  # noqa: E731
            w[m + "b5"], w[m + "p5"], w[m + "ctx"], g, s["adp"], s["adp"], s["dom"], st)
        return (jax.jit(jdor.supertrend_swing_reversal)(*args("j", js, jnp.asarray(gate))),
                tdor.supertrend_swing_reversal(*args("t", ts, torch.from_numpy(gate))))
    if kernel == "supertrend_swing_reversal_carried":
        st_up = np.arange(N_SYMBOLS) % 2 == 0
        return (jax.jit(jdor.supertrend_swing_reversal)(
                    w["jb5"], w["jp5"], w["jctx"], jnp.asarray(gate), js["adp"], js["adp"],
                    js["dom"], jnp.asarray(st_up)),
                tdor.supertrend_swing_reversal(
                    w["tb5"], w["tp5"], w["tctx"], torch.from_numpy(gate), ts["adp"],
                    ts["adp"], ts["dom"], st_up=torch.from_numpy(st_up)))
    if kernel == "coinrule_twap_momentum_sniper":
        return (jax.jit(jdor.twap_momentum_sniper)(w["jb15"], w["jp5"]),
                tdor.twap_momentum_sniper(w["tb15"], w["tp5"]))
    if kernel == "coinrule_buy_low_sell_high":
        return (jax.jit(jdor.buy_low_sell_high)(w["jb15"], w["jp15"], js["dom"]),
                tdor.buy_low_sell_high(w["tb15"], w["tp15"], ts["dom"]))
    if kernel == "coinrule_buy_the_dip":
        return (jax.jit(jdor.buy_the_dip)(w["jb15"], w["jp15"], w["jctx"], js["quiet"]),
                tdor.buy_the_dip(w["tb15"], w["tp15"], w["tctx"], ts["quiet"]))
    if kernel == "bb_extreme_reversion":
        jp, tp = jdor.BBXParams(enabled=True), tdor.BBXParams(enabled=True)
        return (jax.jit(jdor.bb_extreme_reversion, static_argnums=3)(
                    w["jb15"], w["jp15"], w["jctx"], jp),
                tdor.bb_extreme_reversion(w["tb15"], w["tp15"], w["tctx"], tp))
    if kernel == "inverse_price_tracker":
        return (jax.jit(jdor.inverse_price_tracker)(w["jp5"], w["jctx"]),
                tdor.inverse_price_tracker(w["tp5"], w["tctx"]))
    if kernel == "range_bb_rsi_mean_reversion":
        return (jax.jit(jdor.range_bb_rsi_mean_reversion)(w["jb15"], w["jp15"], w["jctx"]),
                tdor.range_bb_rsi_mean_reversion(w["tb15"], w["tp15"], w["tctx"]))
    if kernel == "range_failed_breakout_fade":
        return (jax.jit(jdor.range_failed_breakout_fade)(w["jspikes"], w["jctx"]),
                tdor.range_failed_breakout_fade(w["tspikes"], w["tctx"]))
    if kernel == "relative_strength_reversal_range":
        return (jax.jit(jdor.relative_strength_reversal_range)(w["jb15"], w["jp15"], w["jctx"]),
                tdor.relative_strength_reversal_range(w["tb15"], w["tp15"], w["tctx"]))
    raise KeyError(kernel)


def _check(name, ref, out, scale=1.0):
    ref, out = np.asarray(ref), out.numpy()
    assert ref.dtype == out.dtype, (name, ref.dtype, out.dtype)
    if ref.dtype.kind in "biu":
        np.testing.assert_array_equal(out, ref, err_msg=name)
    else:
        np.testing.assert_array_equal(np.isnan(ref), np.isnan(out), err_msg=name)
        scale = np.maximum(np.nan_to_num(np.abs(ref)), np.nan_to_num(scale, nan=1.0))
        ok = np.isnan(ref) | (np.abs(np.nan_to_num(out - ref)) <= 1e-5 * scale)
        assert ok.all(), (name, ref[~ok], out[~ok])


def _zscore_scale(w) -> np.ndarray:
    """A z-score divides a close minus its 20-bar mean by the 20-bar std:
    an ulp-level difference of the mean at the price's scale reaches it
    multiplied by close / std, the scale its tolerance is taken at."""
    close = np.asarray(w["jb15"].values[:, -20:, 3], np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.maximum(np.abs(close[:, -1]) / close.std(axis=1), 1.0)


KERNELS = DORMANT + ("supertrend_swing_reversal_carried",)
_FIRED: dict = {}


@pytest.mark.parametrize("ctx", ("computed", "range"))
@pytest.mark.parametrize("market", ("dormant", "extended", "extended_prev"))
@pytest.mark.parametrize("kernel", KERNELS)
def test_dormant_kernel_matches_reference(worlds, kernel, market, ctx):
    ref, out = _run(kernel, worlds[(market, ctx)], quiet=ctx == "range")
    for field in ("trigger", "direction", "autotrade", "score", "stop_loss_pct"):
        _check(f"{kernel}.{field}", getattr(ref, field), getattr(out, field))
    # jit returns dicts key-sorted; the wire layout pins the order elsewhere
    assert sorted(ref.diagnostics) == sorted(out.diagnostics)
    for key, r in ref.diagnostics.items():
        r = np.broadcast_to(np.asarray(r), (N_SYMBOLS,))
        _check(f"{kernel}.{key}", r, torch.broadcast_to(out.diagnostics[key], (N_SYMBOLS,)),
               scale=_zscore_scale(worlds[(market, ctx)]) if key == "zscore" else 1.0)
    _FIRED[(kernel, market, ctx)] = int(out.trigger.sum())


def test_the_markets_fire_every_dormant_kernel(worlds):
    """Not an empty-against-empty match: across the markets and the two
    contexts, every dormant kernel fires somewhere (in both packages, by
    the test above)."""
    for kernel in KERNELS:
        fired = 0
        for key, w in worlds.items():
            fired += int(_run(kernel, w, quiet=key[1] == "range")[1].trigger.sum())
        assert fired > 0, kernel


def test_bbx_is_off_unless_enabled(worlds):
    w = worlds[("dormant", "range")]
    out = tdor.bb_extreme_reversion(w["tb15"], w["tp15"], w["tctx"])
    assert not out.trigger.any() and out.diagnostics == {}


# --------------------------------------------------------------------------
# one wire step with all fourteen strategies enabled
# --------------------------------------------------------------------------

KEY = tuple(sorted(tstep.STRATEGY_ORDER))


def _inputs(rings, updates):
    tracked = rings[900]["filled"] > 0
    ts15 = int(updates[900][0][1][0])
    ts5 = int(updates[300][-1][1][0])
    jin = jstep.default_host_inputs(N_SYMBOLS)._replace(
        tracked=jnp.asarray(tracked), btc_row=jnp.int32(0), timestamp_s=jnp.int32(ts15),
        timestamp5_s=jnp.int32(ts5), adp_latest=jnp.float32(0.42), adp_prev=jnp.float32(0.38),
        adp_diff=jnp.float32(0.04), adp_diff_prev=jnp.float32(0.04),
        breadth_momentum_points=jnp.float32(4.0), grid_policy_allows=jnp.asarray(True),
        dominance_is_losers=jnp.asarray(True), market_domination_reversal=jnp.asarray(True),
    )
    tin = tstep.default_host_inputs(N_SYMBOLS, device="cpu")._replace(
        tracked=torch.from_numpy(tracked), btc_row=torch.tensor(0, dtype=torch.int32),
        timestamp_s=torch.tensor(ts15, dtype=torch.int32),
        timestamp5_s=torch.tensor(ts5, dtype=torch.int32),
        adp_latest=torch.tensor(0.42), adp_prev=torch.tensor(0.38),
        adp_diff=torch.tensor(0.04), adp_diff_prev=torch.tensor(0.04),
        breadth_momentum_points=torch.tensor(4.0), grid_policy_allows=torch.tensor(True),
        dominance_is_losers=torch.tensor(True), market_domination_reversal=torch.tensor(True),
    )
    return jin, tin


def _np_tree(tree):
    if isinstance(tree, tuple):
        return {f: _np_tree(v) for f, v in zip(tree._fields, tree)}
    return np.asarray(tree)


@pytest.mark.parametrize("incremental", (False, True), ids=("classic", "incremental"))
def test_wire_with_every_strategy_matches_reference(markets, incremental):
    """The extended market's last tick: two 5m sub-batches folded, then
    one wire step on the last 5m bar and the 15m bar."""
    rings, updates = _rings(markets["extended"], drop_last=True)
    jb5, jb15 = _jbuf(rings[300]), _jbuf(rings[900])
    leaves = {
        "buf5": rings[300], "buf15": rings[900],
        "regime_carry": {k: np.asarray(v)
                         for k, v in jstep.initial_regime_carry(N_SYMBOLS)._asdict().items()},
        "mrf_last_emitted": np.full(N_SYMBOLS, -1, np.int32),
        "pt_last_signal_close": np.full(N_SYMBOLS, -1, np.int32),
    }
    jcarry = (jax.jit(jstep.init_indicator_carry)(jb5, jb15, 0) if incremental
              else jstep.empty_indicator_carry(N_SYMBOLS))
    leaves["indicator_carry"] = _np_tree(jcarry)
    jstate = jstep.EngineState(
        buf5=jb5, buf15=jb15, regime_carry=jstep.initial_regime_carry(N_SYMBOLS),
        mrf_last_emitted=jnp.asarray(leaves["mrf_last_emitted"]),
        pt_last_signal_close=jnp.asarray(leaves["pt_last_signal_close"]),
        indicator_carry=jcarry,
    )
    tstate = engine_state_from_numpy(leaves, "cpu")
    empty = (np.zeros(0, np.int32), np.zeros(0, np.int32), np.zeros((0, F), np.float32))
    pairs = [(updates[300][0], updates[900][0]), (updates[300][1], empty),
             (updates[300][2], empty)]
    jfold = jstep.apply_updates_carry_step if incremental else jstep.apply_updates_step
    tfold = tstep.apply_updates_carry_step if incremental else tstep.apply_updates_step
    kw = dict(btc_row=0) if incremental else {}
    for u5, u15 in pairs[:-1]:
        jstate = jfold(jstate, tuple(map(jnp.asarray, u5)), tuple(map(jnp.asarray, u15)), **kw)
        tstate = tfold(tstate, tuple(map(torch.from_numpy, u5)),
                       tuple(map(torch.from_numpy, u15)), **kw)
    jin, tin = _inputs(rings, updates)
    cfg = dict(required_fresh_symbols=4, min_coverage_ratio=0.5)
    u5, u15 = pairs[-1]
    flags = dict(wire_enabled=KEY, incremental=incremental, maintain_carry=incremental)
    _, jw = jstep.tick_step_wire(jstate, tuple(map(jnp.asarray, u5)),
                                 tuple(map(jnp.asarray, u15)), jin,
                                 jctx.ContextConfig(**cfg), **flags)
    _, tw = tstep.tick_step_wire(tstate, tuple(map(torch.from_numpy, u5)),
                                 tuple(map(torch.from_numpy, u15)), tin,
                                 tctx.ContextConfig(**cfg), **flags)
    jw, tw = np.asarray(jw), tw.numpy()
    assert tw.dtype == jw.dtype == np.float32 and tw.shape == jw.shape
    off, K = tstep.WIRE_FIRED_COUNT_OFF, tstep.WIRE_MAX_FIRED
    assert jw[off] == tw[off]
    jb = jw[off + 1: off + 1 + 6 * K].reshape(6, K)
    tb = tw[off + 1: off + 1 + 6 * K].reshape(6, K)
    np.testing.assert_array_equal(jb[:4], tb[:4])
    fired = {tstep.STRATEGY_ORDER[int(i)] for i in tb[0, : int(tw[off])]}
    assert fired & set(DORMANT), fired  # dormant strategies on the wire
    assert tstep.EMISSION_LAYOUTS[KEY] == jstep.EMISSION_LAYOUTS[KEY]
    fin = np.isfinite(jw)
    assert np.array_equal(fin, np.isfinite(tw)) and np.array_equal(np.isnan(jw), np.isnan(tw))
    scale = np.maximum(np.abs(jw), 1.0)
    assert np.all(np.abs(tw[fin] - jw[fin]) <= 1e-5 * scale[fin]), np.abs(tw - jw)[fin].max()
