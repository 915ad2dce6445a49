"""The last public names of ``binquant_tpu`` in the port, each against the
reference's.

* ``apply_updates_shift``: the port's is bit-equal to the reference's and to
  the port's cursor ring, materialized, over a stream with appends, a
  same-timestamp correction, a mid-history rewrite, a late bar dropped and
  symbol churn (rows reset and reclaimed);
* ``s_to_ms``, ``FIELDS``, ``field``, ``MarketBuffer.latest_times``,
  ``SymbolRegistry.rows_for``, ``GridOnlyPolicy.active`` (and ``resolve``,
  which now builds through it), ``Direction.label``,
  ``default_strategy_params``, ``LONDON`` (and ``london_time`` against it)
  and the exceptions equal the
  reference's;
* every enum's members and values, and the ``Literal`` aliases, equal;
* the nine schema models take and dump the JSON the reference's pydantic
  models do on the same payloads, and refuse what they refuse;
* the package exports what the reference's exports.
"""

from __future__ import annotations

import enum
import typing
from datetime import datetime, timedelta, timezone
from zoneinfo import ZoneInfo

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import binquant_tpu
import binquant_tpu_torch
from binquant_tpu import enums as jenums
from binquant_tpu import exceptions as jexc
from binquant_tpu import schemas as jsch
from binquant_tpu.engine import buffer as jbuf
from binquant_tpu.regime import grid_policy as jgp
from binquant_tpu.regime import time_filter as jtf
from binquant_tpu.strategies import params as jparams
from binquant_tpu_torch import enums as tenums
from binquant_tpu_torch import exceptions as texc
from binquant_tpu_torch import schemas as tsch
from binquant_tpu_torch.engine import buffer as tbuf
from binquant_tpu_torch.io.replay import StubSession
from binquant_tpu_torch.regime import grid_policy as tgp
from binquant_tpu_torch.regime import time_filter as ttf
from binquant_tpu_torch.strategies import params as tparams

# small shapes: extra intra-op threads only spin and crowd parallel test workers
torch.set_num_threads(1)

S, W, F = 8, 12, tbuf.NUM_FIELDS
T0 = 1_780_272_000


def _batches() -> list:
    """(kind, payload) steps: ``upd`` (rows, ts, vals) or ``reset`` rows."""
    rng = np.random.default_rng(3)

    def vals(n):
        return rng.normal(100.0, 5.0, (n, F)).astype(np.float32)

    steps = []
    for k in range(16):  # appends; rows 6-7 skip some bars
        rows = np.array([r for r in range(S) if not (r >= 6 and k % 3 == 1)], np.int32)
        steps.append(("upd", (rows, np.full(len(rows), T0 + 900 * k, np.int32), vals(len(rows)))))
    # a same-timestamp correction of the newest bar on rows 0-3
    steps.append(("upd", (np.arange(4, dtype=np.int32), np.full(4, T0 + 900 * 15, np.int32),
                          vals(4))))
    # a mid-history rewrite (row 1), a late bar with no slot (row 2), out of range (row 99)
    steps.append(("upd", (np.array([1, 2, 99], np.int32),
                          np.array([T0 + 900 * 10, T0 - 900 * 50, T0 + 900 * 16], np.int32),
                          vals(3))))
    steps.append(("reset", np.array([3, 5], np.int32)))  # churn: two symbols leave
    for k in range(16, 20):  # their rows are reclaimed by newcomers
        rows = np.arange(S, dtype=np.int32)
        steps.append(("upd", (rows, np.full(S, T0 + 900 * k, np.int32), vals(S))))
    return steps


def _bits(x) -> np.ndarray:
    a = np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _equal(a: tuple, b: tuple, where: str) -> None:
    for f, x, y in zip(tbuf.MarketBuffer._fields, a, b, strict=True):
        np.testing.assert_array_equal(_bits(x), _bits(y), err_msg=f"{where} {f}")


def test_apply_updates_shift_is_the_reference_and_the_cursor_ring():
    j = jbuf.empty_buffer(S, W)
    t_shift = tbuf.empty_buffer(S, W, device="cpu")
    t_ring = tbuf.empty_buffer(S, W, device="cpu")
    for i, (kind, payload) in enumerate(_batches()):
        if kind == "reset":
            j = jbuf.reset_rows(j, jnp.asarray(payload))
            t_shift = tbuf.reset_rows(t_shift, torch.from_numpy(payload))
            t_ring = tbuf.reset_rows(t_ring, torch.from_numpy(payload))
        else:
            j = jbuf.apply_updates_shift(j, *map(jnp.asarray, payload))
            t_shift = tbuf.apply_updates_shift(t_shift, *map(torch.from_numpy, payload))
            t_ring = tbuf.apply_updates(t_ring, *map(torch.from_numpy, payload))
        _equal(j, t_shift, f"step {i}: reference vs port shift")
        _equal(tbuf.materialize(t_ring), t_shift, f"step {i}: cursor ring vs shift")
        assert (t_shift.cursor == 0).all()
    assert (t_ring.cursor != 0).any()  # the ring really ran mid-phase
    # latest_times: the ring's newest bar per row, as the reference reads it
    j_ring = jbuf.MarketBuffer(*(jnp.asarray(x.numpy()) for x in t_ring))
    np.testing.assert_array_equal(np.asarray(j_ring.latest_times), t_ring.latest_times.numpy())
    assert torch.equal(t_ring.latest_times, tbuf.ring_latest_times(t_ring))
    for f in tbuf.Field:
        np.testing.assert_array_equal(
            _bits(jbuf.field(j, jbuf.Field(int(f)))), _bits(tbuf.field(t_shift, f)))
    assert tbuf.FIELDS == jbuf.FIELDS


def test_time_helpers_and_registry_rows():
    for ts in (0, 1_780_272_000, 2**31 - 1):
        assert tbuf.s_to_ms(ts) == jbuf.s_to_ms(ts)
        assert type(tbuf.s_to_ms(ts)) is type(jbuf.s_to_ms(ts))
    arr = np.array([0, 900, 1_780_272_000], np.int32)
    got, want = tbuf.s_to_ms(arr), jbuf.s_to_ms(arr)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    jr, tr = jbuf.SymbolRegistry(6), tbuf.SymbolRegistry(6)
    for symbols, add in ((["btcusdt", "ETHUSDT", " solusdt "], True),
                         (["ETHUSDT", "XRPUSDT", "BTCUSDT"], False),
                         (["XRPUSDT", "ADAUSDT", "ethusdt"], True)):
        a, b = jr.rows_for(symbols, add), tr.rows_for(symbols, add)
        assert a.dtype == b.dtype and np.array_equal(a, b)
    jr.remove("ETHUSDT"), tr.remove("ETHUSDT")
    assert np.array_equal(jr.rows_for(["DOTUSDT", "ETHUSDT"]), tr.rows_for(["DOTUSDT", "ETHUSDT"]))
    with pytest.raises(texc.BufferCapacityError):
        tr.rows_for(["A1", "A2", "A3"])


def test_grid_policy_direction_and_default_params():
    for kw in (dict(direction="toward_trend", source="market_breadth_ma", latest=0.42,
                    previous=0.31),
               dict(direction="toward_range", source="market_breadth", latest=-0.1,
                    previous=-0.35)):
        assert tuple(tgp.GridOnlyPolicy.active(**kw)) == tuple(jgp.GridOnlyPolicy.active(**kw))
    assert tgp.GridOnlyPolicy._fields == jgp.GridOnlyPolicy._fields
    payload = {"timestamp": [3, 2, 1], "market_breadth": [0.4, 0.3, 0.2],
               "market_breadth_ma": [0.35, 0.3, 0.25]}
    for regime in (None, -1, 0, 1, 3):
        got = tgp.GridOnlyPolicy.resolve(regime, tsch.MarketBreadthSeries.model_validate(payload))
        want = jgp.GridOnlyPolicy.resolve(regime, jsch.MarketBreadthSeries.model_validate(payload))
        assert tuple(got) == tuple(want), regime
    for d in tenums.Direction:
        assert d.label == jenums.Direction(int(d)).label == d.name
    assert tparams.default_strategy_params() == tparams.StrategyParams()
    assert tuple(tparams.default_strategy_params()) == tuple(jparams.default_strategy_params())


def _enum_classes(mod) -> dict[str, type]:
    return {n: v for n, v in vars(mod).items()
            if isinstance(v, type) and issubclass(v, enum.Enum) and v.__module__ == mod.__name__}


def test_every_enum_and_literal_equals_the_reference():
    ref, port = _enum_classes(jenums), _enum_classes(tenums)
    # the reference keeps Position in its schemas module; the port in its enums
    assert set(ref) == set(port) - {"Position"}
    for name, cls in ref.items():
        got = port[name]
        assert [(m.name, m.value) for m in got] == [(m.name, m.value) for m in cls], name
        assert issubclass(got, int) == issubclass(cls, int)
        assert issubclass(got, str) == issubclass(cls, str)
    assert [(m.name, m.value) for m in tenums.Position] == [
        (m.name, m.value) for m in jsch.Position]
    for alias in ("direction_type", "MarketRegime", "MicroRegime", "MarketRegimeTransition",
                  "MicroRegimeTransition"):
        assert typing.get_args(getattr(tenums, alias)) == typing.get_args(getattr(jenums, alias))
    for a in tenums.KlineInterval:
        b = jenums.KlineInterval(a.value)
        assert a.get_ms() == b.get_ms()
        for c in tenums.KlineInterval:
            assert a.bars_per(c) == b.bars_per(jenums.KlineInterval(c.value))
    assert tenums.MarketType("futures") is tenums.MarketType.FUTURES


def test_london_and_the_exceptions():
    zone = ZoneInfo("Europe/London")
    assert ttf.LONDON == jtf.LONDON == zone
    t = datetime(2024, 3, 30, tzinfo=timezone.utc)
    for _ in range(0, 24 * 60 * 400, 20):  # every 20 minutes over both 2024 transitions
        assert ttf.london_time(t) == t.astimezone(zone).replace(tzinfo=None)
        t += timedelta(minutes=20)
        if t.month == 4:
            t = datetime(2024, 10, 26, tzinfo=timezone.utc)
    for name in ("ConfigurationError", "RestartStreaming", "InvalidSymbol"):
        got, want = getattr(texc, name), getattr(jexc, name)
        assert [c.__name__ for c in got.__mro__] == [c.__name__ for c in want.__mro__]
        assert got.__doc__ == want.__doc__


def _features(symbol="btcusdt ", **kw) -> dict:
    out = {"symbol": symbol, "timestamp": 1_780_272_000_000, "close": 64_000.5,
           "return_pct": -0.012, "ema20": 63_800.0, "ema50": 63_100.25, "above_ema20": True,
           "above_ema50": 1, "trend_score": 0.4, "relative_strength_vs_btc": 0,
           "atr_pct": 0.011, "bb_width": 0.05, "micro_regime": "RANGE",
           "micro_regime_strength": 0.5, "micro_regime_transition": "BREAKOUT_UP",
           "micro_regime_transition_strength": 1}
    out.update(kw)
    return out


def _context(**kw) -> dict:
    out = {"timestamp": 1_780_272_000_000, "fresh_count": 40, "total_tracked_symbols": 50,
           "coverage_ratio": 0.8, "btc_symbol": " btcusdt", "btc_present": True,
           "confidence": 0.9, "is_provisional": False, "advancers": 25, "decliners": 10,
           "advancers_ratio": 0.625, "decliners_ratio": 0.25, "advancers_decliners_ratio": 2.5,
           "average_return": 0.003, "average_relative_strength_vs_btc": -0.001,
           "pct_above_ema20": 0.6, "pct_above_ema50": 0.55, "average_trend_score": 0.2,
           "average_atr_pct": 0.02, "average_bb_width": 0.06, "btc_return": 0.004,
           "btc_trend_score": 0.3, "btc_regime_score": 0.5, "market_stress_score": 0.1,
           "long_tailwind": 0.3, "short_tailwind": -0.3, "market_regime": "TREND_UP",
           "previous_market_regime": "RANGE", "market_regime_transition": "ENTERED_TREND_UP",
           "market_regime_transition_strength": 0.8, "long_regime_score": 0.7,
           "regime_is_transitioning": True, "regime_stable_since": 1_780_271_000_000,
           "symbol_features": {"BTCUSDT": _features(), "ETH-USDT": _features("eth-usdt")},
           "metadata": {"source": "tick", "nan": float("nan"), "n": [1, 2]}}
    out.update(kw)
    return out


def _score(**kw) -> dict:
    out = {"symbol": " solusdt", "direction": " long ", "context_timestamp": None,
           "confidence": 0.5, "long_tailwind": 0.2, "short_tailwind": -0.2,
           "breadth_score": 0.1, "btc_alignment_score": -0.4, "cross_asset_confirmation": 0.0,
           "market_stress_score": 0.3, "followthrough_score": 0.25,
           "adverse_excursion_risk": 0.15, "override_strength": 0, "supportiveness_score": 1,
           "metadata": {"why": "test"}}
    out.update(kw)
    return out


VALID = {
    "KlineProduceModel": [{"symbol": "BTCUSDT", "open_time": "1780272000000",
                           "close_time": "1780272899999", "open_price": "64000.1",
                           "high_price": "64100", "low_price": "63900.5",
                           "close_price": "64050", "volume": "12.5"}],
    "ExtendedKline": [{"symbol": "BTCUSDT", "open_time": 1780272000000,
                       "close_time": 1780272899999, "open": 64000.1, "high": 64100,
                       "low": 63900.5, "close": 64050, "volume": 12.5,
                       "number_of_trades": 150}],
    "SymbolMarketFeatures": [_features(), _features(micro_regime=None,
                                                    micro_regime_transition=None)],
    "LiveMarketContext": [_context(), _context(market_regime=None, symbol_features={},
                                               is_provisional=True)],
    "MarketContextScore": [_score(), _score(context_timestamp=1_780_272_000_000)],
    "SignalContextEvaluation": [{"symbol": "SOLUSDT", "direction": "long", "local_score": 0.7,
                                 "local_features": {"rsi": 28, "gap": float("inf")},
                                 "adjusted_score": 0.65, "context_score": _score()}],
    "OrderModel": [{"order_id": 7, "order_type": "LIMIT", "pair": "BTCUSDT", "qty": 0.5,
                    "price": 64000, "deal_type": "take_profit"}],
    "DealModel": [{"margin_loan_id": 12.0, "opening_price": 64000, "current_price": 64100.5},
                  {"margin_loan_id": 3}],
    "BBExtremeReversionDecision": [{"fired": True, "direction": "LONG", "reason": "bb_low",
                                    "connors_rsi": 8.5, "close": 99.0, "bb_high": 110,
                                    "bb_low": 100, "score": 0.8}, {"fired": False}],
}
INVALID = {
    "SymbolMarketFeatures": [_features(timestamp=-1), _features(micro_regime="SIDEWAYS"),
                             _features(micro_regime_strength=1.5), _features(extra=1)],
    "LiveMarketContext": [_context(fresh_count=60), _context(advancers=35),
                          _context(decliners=-1), _context(coverage_ratio=1.2),
                          _context(btc_regime_score=-1.5), _context(unknown=0)],
    "MarketContextScore": [_score(confidence=-0.1), _score(supportiveness_score=2),
                           _score(extra="x")],
    "SignalContextEvaluation": [{"symbol": "X", "direction": "long", "local_score": 0.7,
                                 "local_features": {}, "adjusted_score": 0.6,
                                 "context_score": _score(confidence=3)}],
}


def _dump(model) -> dict:
    return model.model_dump(mode="json")


def _same(a, b) -> bool:
    """Equal JSON views, NaN equal to NaN."""
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return isinstance(b, list) and len(a) == len(b) and all(map(_same, a, b))
    if isinstance(a, float) and isinstance(b, float) and a != a:
        return b != b
    return type(a) is type(b) and a == b


@pytest.mark.parametrize("name", sorted(VALID))
def test_models_take_and_dump_what_the_reference_does(name):
    ref, port = getattr(jsch, name), getattr(tsch, name)
    for payload in VALID[name]:
        want, got = _dump(ref.model_validate(payload)), _dump(port.model_validate(payload))
        assert _same(got, want), (name, got, want)
        assert got.keys() == ref.model_fields.keys()
        again = port.model_validate(got)
        assert _same(_dump(again), want)
    for payload in INVALID.get(name, []):
        with pytest.raises(ValueError):
            ref.model_validate(payload)
        with pytest.raises(ValueError):
            port.model_validate(payload)


def test_model_helpers_equal_the_reference():
    kline = VALID["KlineProduceModel"][0]
    assert _same(_dump(tsch.ExtendedKline.from_produce_model(kline)),
                 _dump(jsch.ExtendedKline.from_produce_model(kline)))
    assert _same(
        _dump(tsch.ExtendedKline.from_produce_model(tsch.KlineProduceModel(**kline))),
        _dump(jsch.ExtendedKline.from_produce_model(jsch.KlineProduceModel(**kline))))
    jc, tc = (m.LiveMarketContext.model_validate(_context()) for m in (jsch, tsch))
    for symbol in ("btcusdt", "ETHUSDT", "eth_usdt", "SOLUSDT"):
        a, b = jc.get_symbol_features(symbol), tc.get_symbol_features(symbol)
        assert (a is None) == (b is None) and (a is None or _same(_dump(a), _dump(b)))
    assert tc.is_full == jc.is_full is True
    assert tc.validate_consistency() is tc
    for value in (2.0, 7, "9"):
        assert tsch.DealModel.validate_margin_loan_id(value) == \
            jsch.DealModel.validate_margin_loan_id(value)
    # the bot the backend returns carries the deal and order models
    bot = tsch.BotModel.model_validate({"pair": "BTCUSDT", "deal": {"margin_loan_id": 4.0},
                                        "orders": [{"order_id": 1}]})
    assert isinstance(bot.deal, tsch.DealModel) and bot.deal.margin_loan_id == 4
    assert isinstance(bot.orders[0], tsch.OrderModel)


def test_package_exports_and_stub_session_get():
    names = ("Config", "Direction", "KlineInterval", "MarketRegimeCode", "MicroRegimeCode")
    for name in names:
        assert hasattr(binquant_tpu, name) and hasattr(binquant_tpu_torch, name)
    assert binquant_tpu_torch.KlineInterval is tenums.KlineInterval
    session = StubSession({"market_breadth": [0.5]})
    resp = session.get("http://stub/market-breadth", params={"size": 2})
    assert resp.json() == {"data": {"market_breadth": [0.5]}}
    assert session.requests == [("GET", "http://stub/market-breadth", None)]
