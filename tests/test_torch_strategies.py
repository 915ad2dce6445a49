"""The five live strategies: the port's StrategyOutputs against the reference.

Both packages evaluate each strategy on one seeded pair of rings (5m and
15m, with an activity burst, a pump, a hammer and a falling row crafted in)
and on ONE market context — the reference's, handed to the port as tensors —
so each comparison isolates the strategy itself. ActivityBurstPump's 92nd
percentile threshold runs through the port's ``rolling_quantile_tail`` (the
kernel's CPU twin here).

Masks, directions, codes and positional diagnostics must be bit-exact;
float scores/diagnostics built on rolling means, sums or EWMs are compared
at rtol=1e-5 (summation order), with a price-scale absolute floor.
"""

from importlib import import_module

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from binquant_tpu.engine import buffer as jbuf
from binquant_tpu.regime import context as jctx
from binquant_tpu.strategies import features as jfeat
from binquant_tpu_torch.engine import buffer as tbuf
from binquant_tpu_torch.regime import context as tctx
from binquant_tpu_torch.strategies import activity_burst_pump as tabp
from binquant_tpu_torch.strategies import features as tfeat
from binquant_tpu_torch.strategies import ladder_deployer as tlad
from binquant_tpu_torch.strategies import liquidation_sweep_pump as tlsp
from binquant_tpu_torch.strategies import mean_reversion_fade as tmrf
from binquant_tpu_torch.strategies import price_tracker as tpt

# small shapes: extra intra-op threads only spin and crowd parallel test workers
torch.set_num_threads(1)

# the reference's strategies package re-exports same-named functions, so
# its modules are fetched by full name
jabp, jlad, jlsp, jmrf, jpt = (
    import_module(f"binquant_tpu.strategies.{m}")
    for m in ("activity_burst_pump", "ladder_deployer", "liquidation_sweep_pump",
              "mean_reversion_fade", "price_tracker")
)

S, W, F = 24, 200, tbuf.NUM_FIELDS
T0 = 1_780_272_000


def _bars(rng, interval_s: int, crafted) -> tuple[np.ndarray, np.ndarray]:
    rets = rng.normal(0, 0.005, (S, W))
    rets[4] -= 0.006  # a falling row: oversold setups
    close = 50 * np.exp(np.cumsum(rets, axis=1))
    open_ = np.concatenate([close[:, :1], close[:, :-1]], axis=1)
    high = np.maximum(open_, close) * 1.001
    low = np.minimum(open_, close) * 0.999
    vol = np.abs(rng.normal(1000, 200, (S, W)))
    crafted(open_, high, low, close, vol)
    vals = np.stack(
        [open_, high, low, close, vol, vol * close, np.full_like(close, 300.0),
         vol / 2, vol * close / 2, np.full_like(close, float(interval_s))], axis=-1,
    ).astype(np.float32)
    times = (T0 - interval_s * np.arange(W - 1, -1, -1)).astype(np.int32)
    times = np.broadcast_to(times, (S, W)).copy()
    filled = np.full(S, W, np.int32)
    filled[9] = 40  # a short-history row
    times[9, : W - 40] = -1
    vals[9, : W - 40] = np.nan
    return times, vals, filled


def _burst(o, h, lo, c, v):
    for r in (1, 2):  # +3% green bar at highs on 8x volume after two up bars
        c[r, -3], c[r, -2] = o[r, -3] * 1.003, o[r, -3] * 1.006
        o[r, -2], o[r, -1] = c[r, -3], c[r, -2]
        c[r, -1] = o[r, -1] * 1.03
        h[r, -3:] = np.maximum(o[r, -3:], c[r, -3:]) * 1.0005
        lo[r, -3:] = np.minimum(o[r, -3:], c[r, -3:]) * 0.9995
        v[r, -1] *= 8.0


def _pump_and_hammer(o, h, lo, c, v):
    c[3, -1] = o[3, -1] * 1.03  # pump
    h[3, -1], v[3, -1] = c[3, -1] * 1.002, v[3, -1] * 8.0
    o[5, -1] = c[5, -2] * 0.955  # green hammer far below the band
    c[5, -1] = o[5, -1] * 1.003
    h[5, -1], lo[5, -1], v[5, -1] = c[5, -1] * 1.001, o[5, -1] * 0.997, v[5, -1] * 3.0


def _to_torch(x):
    if hasattr(x, "_fields"):
        return type(x)._make(_to_torch(v) for v in x)  # same field names
    return torch.from_numpy(np.array(x))


def _port_nt(cls, ref):
    return cls(**{f: _to_torch(getattr(ref, f)) for f in ref._fields})


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(17)
    t5, v5, f5 = _bars(rng, 300, _burst)
    t15, v15, f15 = _bars(rng, 900, _pump_and_hammer)
    jb5 = jbuf.MarketBuffer(jnp.asarray(t5), jnp.asarray(v5), jnp.asarray(f5), jnp.zeros(S, jnp.int32))
    jb15 = jbuf.MarketBuffer(jnp.asarray(t15), jnp.asarray(v15), jnp.asarray(f15), jnp.zeros(S, jnp.int32))
    tb5 = tbuf.MarketBuffer(torch.from_numpy(t5), torch.from_numpy(v5), torch.from_numpy(f5),
                            torch.zeros(S, dtype=torch.int32))
    tb15 = tbuf.MarketBuffer(torch.from_numpy(t15), torch.from_numpy(v15), torch.from_numpy(f15),
                             torch.zeros(S, dtype=torch.int32))
    fresh = np.ones(S, bool)
    jcontext, _ = jctx.compute_market_context(
        jb15, jnp.asarray(fresh), jnp.asarray(fresh), jnp.int32(0), jnp.int32(T0),
        jctx.initial_regime_carry(S),
        jctx.ContextConfig(required_fresh_symbols=4, min_coverage_ratio=0.5),
    )
    tfeats = _port_nt(tctx.SymbolFeatureArrays, jcontext.features)
    tcontext = tctx.MarketContext(
        **{f: (tfeats if f == "features" else _to_torch(getattr(jcontext, f)))
           for f in jcontext._fields}
    )
    pack = jax.jit(jfeat.compute_feature_pack)
    jp5, jp15 = pack(jb5), pack(jb15)
    tp5 = _port_nt(tfeat.FeaturePack, jp5)
    tp15 = _port_nt(tfeat.FeaturePack, jp15)
    return dict(jb5=jb5, jb15=jb15, tb5=tb5, tb15=tb15, jctx=jcontext, tctx=tcontext,
                jp5=jp5, jp15=jp15, tp5=tp5, tp15=tp15)


def _run(name, w):
    oi = np.full(S, np.nan, np.float32)
    oi[3] = 1.05
    last = np.full(S, -1, np.int32)
    last[7] = T0 - 300  # a cooldown / dedupe entry
    if name == "activity_burst_pump":
        return (jax.jit(jabp.activity_burst_pump)(w["jb5"], w["jctx"]),
                tabp.activity_burst_pump(w["tb5"], w["tctx"]))
    if name == "coinrule_price_tracker":
        j, jc = jax.jit(jpt.price_tracker)(w["jp5"], w["jctx"], jnp.asarray(False),
                                           jnp.asarray(last))
        t, tc = tpt.price_tracker(w["tp5"], w["tctx"], torch.tensor(False), torch.from_numpy(last))
        np.testing.assert_array_equal(np.asarray(jc), tc.numpy())
        return j, t
    if name == "liquidation_sweep_pump":
        args_j = (jnp.asarray(oi), jnp.float32(-0.44), jnp.float32(-0.47), jnp.float32(0.004))
        args_t = (torch.from_numpy(oi), torch.tensor(-0.44), torch.tensor(-0.47), torch.tensor(0.004))
        return (jax.jit(jlsp.liquidation_sweep_pump)(w["jb15"], w["jctx"], *args_j),
                tlsp.liquidation_sweep_pump(w["tb15"], w["tctx"], *args_t))
    if name == "mean_reversion_fade":
        j, jc = jax.jit(jmrf.mean_reversion_fade)(w["jp15"], jnp.asarray(True), jnp.asarray(last))
        t, tc = tmrf.mean_reversion_fade(w["tp15"], torch.tensor(True), torch.from_numpy(last))
        np.testing.assert_array_equal(np.asarray(jc), tc.numpy())
        return j, t
    if name == "grid_ladder":
        return (jax.jit(jlad.ladder_deployer)(w["jp15"], w["jctx"], jnp.asarray(True),
                                              jnp.asarray(True)),
                tlad.ladder_deployer(w["tp15"], w["tctx"], torch.tensor(True), torch.tensor(True)))
    raise KeyError(name)


def _check(name, ref, out):
    ref = np.asarray(ref)
    out = out.numpy()
    assert ref.dtype == out.dtype, (name, ref.dtype, out.dtype)
    if ref.dtype.kind in "biu":
        np.testing.assert_array_equal(ref, out, err_msg=name)
    else:
        np.testing.assert_array_equal(np.isnan(ref), np.isnan(out), err_msg=name)
        np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6, equal_nan=True, err_msg=name)


STRATEGIES = (
    "activity_burst_pump", "coinrule_price_tracker", "liquidation_sweep_pump",
    "mean_reversion_fade", "grid_ladder",
)


@pytest.mark.parametrize("name", STRATEGIES)
def test_strategy_outputs_match(world, name):
    ref, out = _run(name, world)
    for field in ("trigger", "direction", "autotrade", "score", "stop_loss_pct"):
        _check(f"{name}.{field}", getattr(ref, field), getattr(out, field))
    # jit returns dicts key-sorted; the wire's layout order is pinned by
    # test_torch_step through the emission layout
    assert sorted(ref.diagnostics) == sorted(out.diagnostics)
    for key in ref.diagnostics:
        r, o = np.asarray(ref.diagnostics[key]), out.diagnostics[key]
        _check(f"{name}.{key}", np.broadcast_to(r, (S,)), torch.broadcast_to(o, (S,)))


def test_crafted_setups_fire(world):
    # the burst rows qualify in ActivityBurstPump's core (the kernel's call
    # site) in both packages; the context gate then decides emission
    jq = np.asarray(jax.jit(jabp.abp_core)(world["jb5"])[0])
    tq = tabp.abp_core(world["tb5"])[0].numpy()
    np.testing.assert_array_equal(jq, tq)
    assert tq[1] and tq[2], np.flatnonzero(tq)
    assert np.flatnonzero(tpt.price_tracker(
        world["tp5"], world["tctx"], torch.tensor(False), torch.full((S,), -1, dtype=torch.int32)
    )[0].trigger.numpy()).size > 0
