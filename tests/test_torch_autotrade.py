"""The port's autotrade admission against the reference's: the gate matrix.

Every case of ``tests/test_autotrade_gates.py`` (KuCoin futures margin
resolution, the max-active caps and the duplicate and ownership checks by
market type, the independent paper branch, the grid deployment path with
its calculate-before-create and race-tolerant create, the short margin
preflight and the compensating cleanup on an activation failure) and the
autotrade cases of ``tests/test_io.py`` run through both packages over the
same scripted backend, and the recorded REST sequences ``(method, url,
json)`` must be equal, as must what each backend created and any refusal
raised. The pure trade math is swept against the reference's too.
"""

import asyncio
from datetime import UTC, datetime
from types import SimpleNamespace

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from binquant_tpu import exceptions as jexc
from binquant_tpu import schemas as jschemas
from binquant_tpu.io import autotrade as jauto
from binquant_tpu.io.binbot import BinbotApi as JBinbotApi
from binquant_tpu.regime import grid_policy as jgp
from binquant_tpu_torch import exceptions as texc
from binquant_tpu_torch import schemas as tschemas
from binquant_tpu_torch.io import autotrade as tauto
from binquant_tpu_torch.io.binbot import BinbotApi as TBinbotApi
from binquant_tpu_torch.regime import grid_policy as tgp
from tests.test_autotrade_gates import FakeFuturesApi, FakeTicker, FuturesFakeSession

J = SimpleNamespace(
    auto=jauto, schemas=jschemas, BinbotApi=JBinbotApi, AutotradeError=jexc.AutotradeError,
    grid_only=lambda: jgp.GridOnlyPolicy.active(
        direction="toward_range", source="x", latest=0.4, previous=0.5),
)
T = SimpleNamespace(
    auto=tauto, schemas=tschemas, BinbotApi=TBinbotApi, AutotradeError=texc.AutotradeError,
    grid_only=lambda: tgp.GridOnlyPolicy(
        allow_grid_ladder=True, block_standard_bots=True, reason="grid_only_toward_range"),
)
GENERATED = datetime(2026, 6, 1, 8, 15, tzinfo=UTC)


def run(coro, limit_s: float = 10.0):
    return asyncio.run(asyncio.wait_for(coro, timeout=limit_s))


class NoExchange:
    """What a launch builds for its own exchange clients here: every price
    lookup answers from the script, so no case reaches a network."""

    def __init__(self, *args, **kwargs):
        pass

    def get_ticker_price(self, symbol):
        return 100.0

    def get_mark_price(self, symbol):
        return 100.0


@pytest.fixture(autouse=True)
def no_exchange_network(monkeypatch):
    for mod in (jauto, tauto):
        for name in ("BinanceApi", "KucoinApi", "KucoinFutures"):
            monkeypatch.setattr(mod, name, NoExchange)


def both(case):
    """``case(P)`` for each package; the outcomes must be equal."""
    out = {"jax": case(J), "torch": case(T)}
    assert out["torch"] == out["jax"]
    return out["torch"]


def outcome(session, **extra):
    return {"calls": list(session.calls), "created": list(session.created), **extra}


def attempt(P, consumer, signal):
    """One admission; a refusal the backend raised is part of the outcome."""
    try:
        run(consumer.process_autotrade_restrictions(signal))
    except P.AutotradeError as exc:
        return str(exc)
    return None


# -- consumers and signals, per package ----------------------------------------------


def futures_consumer(P, balance=1000.0, futures_leverage=5.0, order_size=50.0,
                     stop_loss=3.0, autotrade=True, paper=False, max_bots=10):
    session = FuturesFakeSession(futures_leverage=futures_leverage)
    session.balance = balance
    consumer = P.auto.AutotradeConsumer(
        autotrade_settings=P.schemas.AutotradeSettingsSchema(
            autotrade=autotrade, exchange_id="kucoin", market_type="futures",
            base_order_size=order_size, stop_loss=stop_loss,
            max_active_autotrade_bots=max_bots,
        ),
        active_test_bots=[],
        all_symbols=[P.schemas.SymbolModel(id="XBTUSDTM")],
        test_autotrade_settings=P.schemas.TestAutotradeSettingsSchema(autotrade=paper),
        active_grid_ladders=[],
        binbot_api=P.BinbotApi("http://fake", session=session),
        kucoin_futures_api=FakeFuturesApi(),
    )
    return consumer, session


def futures_signal(P, pair="XBTUSDTM", price=2.0, autotrade=True):
    return P.schemas.SignalsConsumer(
        autotrade=autotrade, current_price=price, direction="LONG",
        bot_params=P.schemas.BotBase(pair=pair, name="mean_reversion_fade",
                                     market_type="futures"),
    )


def spot_consumer(P, exchange="binance", **kw):
    session = FuturesFakeSession()
    consumer = P.auto.AutotradeConsumer(
        autotrade_settings=P.schemas.AutotradeSettingsSchema(
            autotrade=True, exchange_id=exchange, market_type="spot", **kw),
        active_test_bots=[],
        all_symbols=[P.schemas.SymbolModel(id="BTCUSDT")],
        test_autotrade_settings=P.schemas.TestAutotradeSettingsSchema(autotrade=False),
        active_grid_ladders=[],
        binbot_api=P.BinbotApi("http://fake", session=session),
        kucoin_futures_api=FakeFuturesApi(),
    )
    return consumer, session


def spot_signal(P, pair="BTCUSDT", name="mean_reversion_fade"):
    return P.schemas.SignalsConsumer(
        autotrade=True, current_price=100.0, direction="LONG",
        bot_params=P.schemas.BotBase(pair=pair, name=name, market_type="spot"),
        bb_spreads=P.schemas.HABollinguerSpread(bb_high=105, bb_mid=100, bb_low=95),
    )


def grid_signal(P, symbol="BTCUSDT", allocation=60.0):
    params = P.schemas.GridDeploymentRequest(
        symbol=symbol, fiat="USDT", exchange="binance", market_type="spot",
        algorithm_name="grid_ladder", generated_at=GENERATED,
        range_low=95, range_high=105, breakout_low=94, breakout_high=106,
        total_margin=10, level_count=7, allocation_pct=allocation, cash_reserve_pct=40.0,
    )
    return P.schemas.SignalsConsumer(
        signal_kind="grid_deploy", direction="grid", autotrade=True, current_price=100.0,
        grid_params=params,
    )


# -- KuCoin futures margin resolution -------------------------------------------------

FUTURES_CASES = {
    "full_size_when_balance_ample": dict(balance=1000.0, order_size=50.0),
    "auto_scale_down_to_spendable": dict(balance=10.0, order_size=50.0),
    "reversal_reserve_blocks_when_underfunded": dict(balance=8.0, order_size=50.0),
    "calibrated_futures_leverage_is_read": dict(balance=8.0, order_size=50.0,
                                                futures_leverage=10.0),
    "order_below_one_lot_margin_skipped": dict(balance=1000.0, order_size=3.0),
    "missing_stop_loss_skips_futures": dict(balance=1000.0, stop_loss=0.0),
    "missing_price_skips_margin_check": dict(balance=1000.0, order_size=50.0),
}
FUTURES_SIZE = {
    "full_size_when_balance_ample": 50.0,
    "auto_scale_down_to_spendable": 4.576,
    "calibrated_futures_leverage_is_read": 8.0 - 3.424,
    "missing_price_skips_margin_check": 50.0,
}


@pytest.mark.parametrize("case", sorted(FUTURES_CASES))
def test_futures_margin_resolution(case):
    def go(P):
        consumer, session = futures_consumer(P, **FUTURES_CASES[case])
        price = 0.0 if case == "missing_price_skips_margin_check" else 2.0
        return outcome(session, raised=attempt(P, consumer, futures_signal(P, price=price)))

    out = both(go)
    bots = [p for k, p in out["created"] if k == "bot"]
    if case in FUTURES_SIZE:
        assert len(bots) == 1
        assert bots[0]["fiat_order_size"] == pytest.approx(FUTURES_SIZE[case])
    else:
        assert out["created"] == []


# -- caps, duplicates and ownership ----------------------------------------------------


def _caps(name):
    def go(P):
        if name == "max_active_bots_cap":
            consumer, session = futures_consumer(P, max_bots=2)
            session.active_pairs = ["AUSDTM", "BUSDTM", "CUSDTM"]
            raised = attempt(P, consumer, futures_signal(P))
            return outcome(session, raised=raised, active=list(consumer.active_bots))
        if name.startswith("ladder_"):
            consumer, session = futures_consumer(P)
            session.grid_ladders = {
                "ladder_same_market_type_blocks": [{"symbol": "XBTUSDTM",
                                                    "market_type": "futures"}],
                "ladder_other_market_type_passes": [{"symbol": "XBTUSDTM",
                                                     "market_type": "spot"}],
                "ladder_without_market_type_blocks": [{"symbol": "XBTUSDTM"}],
            }[name]
            return outcome(session, raised=attempt(P, consumer, futures_signal(P)))
        if name == "paper_cap_and_duplicate":
            consumer, session = futures_consumer(P, autotrade=False, paper=True)
            consumer.test_autotrade_settings.max_active_autotrade_bots = 1
            session.paper_pairs = ["AUSDTM", "BUSDTM"]
            first = attempt(P, consumer, futures_signal(P, autotrade=False))
            session.paper_pairs = ["XBTUSDTM"]
            consumer.test_autotrade_settings.max_active_autotrade_bots = 10
            second = attempt(P, consumer, futures_signal(P, autotrade=False))
            return outcome(session, raised=(first, second))
        if name == "paper_branch_runs_independently":
            consumer, session = futures_consumer(P, autotrade=True, paper=True)
            return outcome(session, raised=attempt(P, consumer,
                                                   futures_signal(P, autotrade=False)))
        raise AssertionError(name)

    return go


CAP_CASES = ["max_active_bots_cap", "ladder_same_market_type_blocks",
             "ladder_other_market_type_passes", "ladder_without_market_type_blocks",
             "paper_cap_and_duplicate", "paper_branch_runs_independently"]


@pytest.mark.parametrize("case", CAP_CASES)
def test_caps_and_ownership(case):
    out = both(_caps(case))
    kinds = [k for k, _ in out["created"]]
    if case in ("ladder_other_market_type_passes", "paper_branch_runs_independently"):
        assert kinds == ["bot"]
    else:
        assert kinds == []
    if case == "max_active_bots_cap":
        assert out["active"] == ["AUSDTM", "BUSDTM", "CUSDTM"]


# -- the grid path -------------------------------------------------------------------


def _grid(name):
    def go(P):
        kw = {"max_active_grid_ladders": 2} if name == "ladder_limit_reached" else {}
        consumer, session = spot_consumer(P, **kw)
        if name == "active_bot_owns_symbol":
            session.active_pairs = ["BTCUSDT"]
        if name == "ladder_limit_reached":
            session.grid_ladders = [{"symbol": "AUSDT"}, {"symbol": "BUSDT"}]
        if name == "symbol_already_has_ladder":
            session.grid_ladders = [{"symbol": "BTCUSDT"}]
        if name == "missing_allocation_params":
            return outcome(session, raised=attempt(P, consumer, grid_signal(P, allocation=None)))
        if name == "calculate_failure_allows_retry":
            session.calc_error = True
            first = attempt(P, consumer, grid_signal(P))
            session.calc_error = False
            return outcome(session, raised=(first, attempt(P, consumer, grid_signal(P))))
        if name == "race_tolerant_create":
            session.create_grid_error = True
            first = attempt(P, consumer, grid_signal(P))
            session.create_grid_error = False
            return outcome(session, raised=(first, attempt(P, consumer, grid_signal(P))))
        if name == "attempt_cooldown":
            first = attempt(P, consumer, grid_signal(P))
            return outcome(session, raised=(first, attempt(P, consumer, grid_signal(P))))
        return outcome(session, raised=attempt(P, consumer, grid_signal(P)))

    return go


GRID_CASES = ["active_bot_owns_symbol", "ladder_limit_reached", "symbol_already_has_ladder",
              "missing_allocation_params", "calculate_failure_allows_retry",
              "race_tolerant_create", "attempt_cooldown"]


@pytest.mark.parametrize("case", GRID_CASES)
def test_grid_deployment(case):
    out = both(_grid(case))
    kinds = [k for k, _ in out["created"]]
    assert kinds == (["grid"] if case in ("calculate_failure_allows_retry",
                                          "attempt_cooldown") else [])
    if case == "race_tolerant_create":
        assert sum("calculate" in u for _, u, _ in out["calls"]) == 1


# -- spot admission (tests/test_io.py) --------------------------------------------


def _spot(name):
    def go(P):
        consumer, session = spot_consumer(P)
        if name == "insufficient_balance_blocks":
            session.balance = 1.0
        if name == "grid_only_policy_blocks":
            consumer.grid_only_policy = P.grid_only()
        if name == "duplicate_bot_blocks":
            session.active_pairs = ["BTCUSDT"]
        if name == "activation_failure_cleans_up":
            session.activation_error = True
        if name == "excluded_symbol_skipped":
            session.excluded = ["BTCUSDT"]
        return outcome(session, raised=attempt(P, consumer, spot_signal(P)),
                       activated=list(session.activated))

    return go


SPOT_CASES = ["full_path_creates_and_activates", "insufficient_balance_blocks",
              "grid_only_policy_blocks", "duplicate_bot_blocks",
              "activation_failure_cleans_up", "excluded_symbol_skipped"]


@pytest.mark.parametrize("case", SPOT_CASES)
def test_spot_admission(case):
    out = both(_spot(case))
    if case == "full_path_creates_and_activates":
        assert [k for k, _ in out["created"]] == ["bot"] and out["activated"]
        assert 2 < out["created"][0][1]["stop_loss"] < 20
    elif case == "activation_failure_cleans_up":
        assert out["raised"] == "boom"
        assert any("deactivate" in u for _, u, _ in out["calls"])
    else:
        assert out["created"] == []


# -- the bot lifecycle: short preflight and compensating cleanup ---------------------


def lifecycle(P, collection="bots", position="long"):
    session = FuturesFakeSession()
    at = P.auto.Autotrade(
        pair="BTCUSDT",
        settings=P.schemas.AutotradeSettingsSchema(autotrade=True, exchange_id="binance",
                                                   market_type="spot"),
        algorithm_name="test_algo",
        binbot_api=P.BinbotApi("http://fake", session=session),
        db_collection_name=collection,
        exchange_api=FakeTicker(),
    )
    sig = P.schemas.SignalsConsumer(
        autotrade=True, current_price=100.0, direction="LONG",
        bot_params=P.schemas.BotBase(pair="BTCUSDT", name="test_algo", position=position),
        bb_spreads=P.schemas.HABollinguerSpread(bb_high=105, bb_mid=100, bb_low=95),
    )
    return at, sig, session


def _life(name):
    def go(P):
        collection = "paper_trading" if name == "paper_activation_failure_deletes" else "bots"
        position = "short" if name.startswith("short") else "long"
        at, sig, session = lifecycle(P, collection=collection, position=position)
        session.balance = 10.0 if name == "short_margin_preflight_blocks" else 1000.0
        if name in ("short_activation_failure_cleans_margin",
                    "paper_activation_failure_deletes"):
            session.activation_error = True
        if name == "bb_spread_guard_keeps_defaults":
            sig.bb_spreads = P.schemas.HABollinguerSpread(bb_high=100.5, bb_mid=100,
                                                          bb_low=99.5)
        if name == "cooldown_override_preserved":
            sig.bot_params.cooldown = 77
        if name == "signal_override_beats_bb":
            sig.bot_params.stop_loss = 7.77
        try:
            run(at.activate_autotrade(sig))
            raised = None
        except P.AutotradeError as exc:
            raised = str(exc)
        return outcome(session, raised=raised)

    return go


LIFE_CASES = ["short_margin_preflight_blocks", "short_preflight_passes_with_funds",
              "short_activation_failure_cleans_margin", "paper_activation_failure_deletes",
              "activation_success_submits_event_log", "bb_spread_guard_keeps_defaults",
              "cooldown_override_preserved", "signal_override_beats_bb"]


@pytest.mark.parametrize("case", LIFE_CASES)
def test_bot_lifecycle(case):
    out = both(_life(case))
    bots = [p for k, p in out["created"] if k == "bot"]
    if case == "short_margin_preflight_blocks":
        assert bots == []
    if case == "short_preflight_passes_with_funds":
        assert bots[0]["cooldown"] == 1440
    if case == "short_activation_failure_cleans_margin":
        assert out["raised"] == "boom"
        assert any("clean-margin-short" in u for _, u, _ in out["calls"])
    if case == "paper_activation_failure_deletes":
        assert [m for m, u, _ in out["calls"] if "/paper-trading/" in u][-1] == "DELETE"
    if case == "activation_success_submits_event_log":
        logs = [p for m, u, p in out["calls"] if m == "POST" and "errors" in u]
        assert logs and "Succesful" in logs[-1]["errors"]
    if case == "bb_spread_guard_keeps_defaults":
        assert (bots[0]["stop_loss"], bots[0]["take_profit"]) == (3.0, 2.3)
    if case == "cooldown_override_preserved":
        assert bots[0]["cooldown"] == 77
    if case == "signal_override_beats_bb":
        assert bots[0]["stop_loss"] == 7.77


# -- the pure trade math ----------------------------------------------------------------


@settings(max_examples=200, deadline=None)
@given(
    lot=st.floats(0.0, 10.0), mult=st.floats(0.001, 100.0), fee=st.floats(0.0, 0.01),
    lev=st.floats(1.0, 50.0), price=st.floats(-1.0, 1e4), stop=st.floats(-1.0, 10.0),
    requested=st.floats(0.0, 1e3), balance=st.floats(0.0, 1e4),
    high=st.floats(1.0, 200.0), width=st.floats(0.0, 0.5), short=st.booleans(),
)
def test_trade_math_matches_the_reference(lot, mult, fee, lev, price, stop, requested,
                                          balance, high, width, short):
    sizing = []
    for P in (J, T):
        terms = P.auto.ContractTerms(lot_size=lot, multiplier=mult, taker_fee_rate=fee,
                                     leverage=lev)
        s = P.auto.size_futures_order(lambda terms=terms: terms, price=price, stop_loss=stop,
                                      requested=requested, balance=balance,
                                      reversal_buffer=1.40)
        bb = P.schemas.HABollinguerSpread(bb_high=high, bb_mid=high * (1 - width / 2),
                                          bb_low=high * (1 - width))
        sizing.append((s.order_size, s.reason, terms.lot_margin(price),
                       P.auto.bollinger_exit_params(bb, short=short)))
    assert sizing[1] == sizing[0]


def test_wal_replayed_payload_is_admitted_as_the_reference_admits_it():
    """A payload that went through the autotrade sink's WAL round trip
    (model_dump, then model_validate) comes back with every field marked as
    set, so admission reads its dumped defaults (a stop loss of 0) as the
    signal's own choices: the futures sizing vetoes what the original
    payload would have launched. The port does what the reference does, on
    both payloads."""
    from binquant_tpu.io.emission import AutotradeSink as JSink
    from binquant_tpu_torch.io.emission import AutotradeSink as TSink

    def go(P, sink):
        consumer, session = futures_consumer(P)
        original = futures_signal(P)
        attempt(P, consumer, original)
        first = list(session.calls)
        replayed = sink(None).from_wal(sink(None).to_wal(futures_signal(P)))
        attempt(P, consumer, replayed)
        return first, session.calls[len(first):], sorted(replayed.bot_params.model_fields_set)

    j, t = go(J, JSink), go(T, TSink)
    assert t == j
    first, again, fields = t
    assert any(u.endswith("/bot") for _, u, _ in first)
    assert not any(u.endswith("/bot") for _, u, _ in again)
    assert "stop_loss" in fields
