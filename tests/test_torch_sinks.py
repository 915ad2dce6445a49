"""The payloads the sinks receive, and the sinks, against the reference.

* The grid ladder's deployment request reads the autotrade settings: one
  scripted wire with a fired grid_ladder slot goes through both packages'
  ``extract_fired`` under the default settings, under settings without an
  allocation split, and with no settings; the signals' dumps must be equal
  (``generated_at`` compared by its format: each package stamps its own
  clock).
* The JSON view of a datetime is pydantic's (a hypothesis sweep of aware
  and naive datetimes, with and without microseconds).
* ``model_validate`` rebuilds nested models, datetimes and enums, and
  ``model_fields_set`` names what was passed: SignalsConsumer payloads with
  bot params, grid params and bands round-trip through dump, JSON and
  validate in each package, to equal dumps and equal field sets.
* The sink classes: the autotrade sink's WAL round trip keeps its delivery
  id, the inline analytics POST swallows a failure, the sink set's order.
* Both packages' stub engines on the reference's 120-tick replay, autotrade
  on, classic path at depth 0: with the delivery plane on they hand every
  sink equal payloads by entry id (tracing off in the reference, so its ids
  take the port's untraced form), and admission makes the same ordered REST
  calls; with the plane off they make the same ordered binbot REST
  sequence.
"""

import asyncio
import json
import random
import re
from datetime import UTC, datetime, timedelta, timezone
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from binquant_tpu import schemas as jschemas
from binquant_tpu.engine import step as jstep
from binquant_tpu.io import autotrade as jauto
from binquant_tpu.io import emission as jemission
from binquant_tpu.io import replay as jreplay
from binquant_tpu.io.binbot import BinbotApi as JBinbotApi
from binquant_tpu_torch import schemas as tschemas
from binquant_tpu_torch.engine import step as tstep
from binquant_tpu_torch.io import autotrade as tauto
from binquant_tpu_torch.io import emission as temission
from binquant_tpu_torch.io import replay as treplay
from binquant_tpu_torch.io.binbot import BinbotApi as TBinbotApi
from tests.test_autotrade_gates import FuturesFakeSession

# small shapes: extra intra-op threads only spin and crowd parallel test workers
torch.set_num_threads(1)

# the observability knobs the reference engine runs with here (its
# trace_sample/freshness arguments and the test lane's pins) and its
# pinned-off fan-out plane: the port's engine takes the same, so both hand
# the same sinks the same payloads
REFERENCE_PINS = dict(
    trace_sample=0.0, freshness=False, host_phase=False, slo=False, delivery_health=False,
    fanout=False,
)

JSON_UTC = re.compile(r"^\d{4}-\d{2}-\d{2}T\d{2}:\d{2}:\d{2}(\.\d{6})?Z$")


def run(coro, limit_s: float = 60.0):
    return asyncio.run(asyncio.wait_for(coro, timeout=limit_s))


# -- the grid payload reads the autotrade settings -------------------------------

GRID_LAYOUT = {"grid_ladder": [
    ("range_low", "f"), ("range_high", "f"), ("breakout_low", "f"), ("breakout_high", "f"),
    ("range_width_pct", "f"), ("atr_buffer_pct", "f"), ("bb_width_change_pct", "f"),
]}


def scripted_grid_wire(step):
    """One fired grid_ladder slot (row 3, autotrade on) and a valid RANGE
    context, in ``step``'s wire types."""
    base = np.zeros(len(step.EMISSION_BASE_FIELDS), np.float32)
    base[5:10] = [101.25, 5300.0, 104.5, 101.0, 97.5]  # close, volume, bands (15m)
    diag = np.zeros(step.EMISSION_DIAG_WIDTH, np.float32)
    diag[:7] = [98.0, 104.0, 97.3, 104.7, 6.12, 0.75, -3.5]
    fired = step.WireFired(
        n=1, overflow=False,
        strategy_idx=np.array([step.STRATEGY_ORDER.index("grid_ladder")]),
        row=np.array([3]), autotrade=np.array([True]), direction=np.array([0]),
        score=np.array([0.0], np.float32), stop_loss_pct=np.array([0.0], np.float32),
        payload=np.concatenate([base, diag])[None, :],
    )
    ctx = {"valid": True, "market_regime": 3, "market_regime_transition": 0,
           "market_regime_transition_strength": 0.0, "market_stress_score": 0.125,
           "timestamp": 1_780_272_000, "advancers_ratio": 0.5, "long_tailwind": 0.0,
           "short_tailwind": 0.0}
    return fired, ctx


GRID_SETTINGS = {
    "default": {},
    "no_allocation": {"grid_allocation_pct": None},
    "custom": {"grid_total_margin": 25.0, "grid_level_count": 9, "fiat": "USDC",
               "grid_allocation_pct": 55.0, "grid_cash_reserve_pct": 45.0},
    "none": None,
}


@pytest.mark.parametrize("case", sorted(GRID_SETTINGS))
def test_grid_payload_reads_the_autotrade_settings(case):
    registry = SimpleNamespace(name_of=lambda row: f"S{row:03d}USDT")
    dumps = []
    for step, emission, schemas in ((jstep, jemission, jschemas), (tstep, temission, tschemas)):
        kw = GRID_SETTINGS[case]
        settings_ = None if kw is None else schemas.AutotradeSettingsSchema(**kw)
        fired = emission.extract_fired(
            None, registry, env="CI", exchange="binance", market_type="SPOT",
            settings=settings_, enabled={"grid_ladder"}, unpacked=scripted_grid_wire(step),
            diag_layout=GRID_LAYOUT,
        )
        assert len(fired) == 1 and fired[0].strategy == "grid_ladder"
        dump = fired[0].value.model_dump(mode="json")
        assert JSON_UTC.match(dump["grid_params"].pop("generated_at"))
        dumps.append(dump)
    assert dumps[1] == dumps[0]
    grid = dumps[1]["grid_params"]
    if case == "default":
        assert (grid["allocation_pct"], grid["cash_reserve_pct"]) == (60.0, 40.0)
    if case == "custom":
        assert (grid["total_margin"], grid["level_count"], grid["fiat"]) == (25.0, 9, "USDC")


# -- the JSON view of a datetime ---------------------------------------------------

OFFSETS = st.one_of(
    st.none(),
    st.just(UTC),
    st.integers(-23 * 60 - 59, 23 * 60 + 59).map(lambda m: timezone(timedelta(minutes=m))),
)


def _grid_request(schemas, generated_at):
    return schemas.GridDeploymentRequest(
        symbol="BTCUSDT", fiat="USDT", exchange="binance", market_type="spot",
        algorithm_name="grid_ladder", generated_at=generated_at, range_low=95.0,
        range_high=105.0, breakout_low=94.0, breakout_high=106.0, total_margin=10.0,
        level_count=7,
    )


@settings(max_examples=300, deadline=None)
@given(
    moment=st.datetimes(min_value=datetime(1970, 1, 2), max_value=datetime(2200, 1, 1)),
    tz=OFFSETS,
    whole_seconds=st.booleans(),
)
def test_datetime_json_view_is_pydantics(moment, tz, whole_seconds):
    if whole_seconds:
        moment = moment.replace(microsecond=0)
    moment = moment.replace(tzinfo=tz)
    ref = _grid_request(jschemas, moment).model_dump(mode="json")["generated_at"]
    assert _grid_request(tschemas, moment).model_dump(mode="json")["generated_at"] == ref
    assert tschemas.json_datetime(moment) == ref


# -- nested model_validate and model_fields_set -----------------------------------


def _payloads(schemas):
    """SignalsConsumer payloads as emission builds them: a MeanReversionFade
    signal with bot params and bands, a grid deployment, a bare one."""
    mrf = schemas.SignalsConsumer(
        autotrade=True, current_price=12.5, direction="SHORT", score=1.25, volume=300.0,
        signal_kind="standard", algorithm_name="mean_reversion_fade", symbol="S001USDT",
        bot_params=schemas.BotBase(
            pair="S001USDT", name="mean_reversion_fade", position="short",
            market_type="FUTURES", margin_short_reversal=False, dynamic_trailing=True,
            stop_loss=2.5, recovery_params={"reversal_path": "source", "stop_loss_pct": 1.5},
        ),
        bb_spreads=schemas.HABollinguerSpread(bb_high=13.0, bb_mid=12.0, bb_low=11.0),
        metadata={"delivery_id": "t1780272900000/0/mean_reversion_fade/S001USDT"},
    )
    grid = schemas.SignalsConsumer(
        signal_kind="grid_deploy", direction="grid", current_price=101.0, autotrade=True,
        algorithm_name="grid_ladder", symbol="S002USDT",
        grid_params=_grid_request(schemas, datetime(2026, 5, 1, 12, 30, 5, 250000, UTC)),
    )
    bare = schemas.SignalsConsumer(symbol="S003USDT")
    return [mrf, grid, bare]


def _fields_sets(model) -> dict:
    out = {"": sorted(model.model_fields_set)}
    for name in ("bot_params", "grid_params", "bb_spreads"):
        sub = getattr(model, name, None)
        if sub is not None:
            out[name] = sorted(sub.model_fields_set)
            rp = getattr(sub, "recovery_params", None)
            if rp is not None:
                out[name + ".recovery_params"] = sorted(rp.model_fields_set)
    return out


def test_model_validate_rebuilds_nested_models_and_fields_set():
    seen = {}
    for key, schemas in (("j", jschemas), ("t", tschemas)):
        rows = []
        for payload in _payloads(schemas):
            text = json.dumps(payload.model_dump(mode="json"))
            back = schemas.SignalsConsumer.model_validate(json.loads(text))
            assert isinstance(back.model_dump(mode="json"), dict)
            if back.bot_params is not None:
                assert isinstance(back.bot_params, schemas.BotBase)
                assert isinstance(back.bot_params.recovery_params, schemas.RecoveryParams)
            if back.grid_params is not None:
                assert isinstance(back.grid_params.generated_at, datetime)
                assert back.grid_params.generated_at == payload.grid_params.generated_at
            rows.append((payload.model_dump(mode="json"), back.model_dump(mode="json"),
                         _fields_sets(payload), _fields_sets(back)))
        seen[key] = rows
    assert seen["t"] == seen["j"]
    # an assignment joins the field set, as pydantic's does
    for schemas in (jschemas, tschemas):
        bot = schemas.BotBase(pair="X")
        bot.cooldown = 77
        assert bot.model_fields_set == {"pair", "cooldown"}


def test_bot_response_validates_the_backend_reply():
    reply = {"message": "ok", "error": 0, "data": {
        "pair": "X", "id": "11111111-1111-1111-1111-111111111111", "status": "pending",
        "deal": {"opening_price": 2.5}, "orders": [{"order_id": 7, "qty": 1.5}]}}
    j = jschemas.BotResponse.model_validate(reply)
    t = tschemas.BotResponse.model_validate(reply)
    assert t.model_dump(mode="json") == j.model_dump(mode="json")
    assert isinstance(t.data.deal, tschemas.DealBase) and t.data.orders[0].order_id == 7
    assert t.data.status == tschemas.Status.pending


# -- the sink classes ----------------------------------------------------------------


def test_autotrade_delivery_id_stamp_survives_wal_roundtrip():
    for emission, schemas in ((jemission, jschemas), (temission, tschemas)):
        sink = emission.AutotradeSink(at_consumer=None)
        value = schemas.SignalsConsumer(symbol="TESTUSDT", algorithm_name="mrf")
        sink.stamp(value, "t1978200/0/mrf/TESTUSDT")
        back = sink.from_wal(json.loads(json.dumps(sink.to_wal(value))))
        assert back.metadata["delivery_id"] == "t1978200/0/mrf/TESTUSDT"
        sink.stamp(back, "other/1/mrf/TESTUSDT")  # idempotent
        assert back.metadata["delivery_id"] == "t1978200/0/mrf/TESTUSDT"


def test_sink_set_order_policies_and_inline_analytics():
    names = [(s.name, s.policy) for s in temission.make_signal_sinks(None, None, None)]
    assert names == [(s.name, s.policy) for s in jemission.make_signal_sinks(None, None, None)]
    assert names == [("analytics", "lossy"), ("telegram", "lossy"),
                     ("autotrade", "at_least_once")]

    class Down:
        def dispatch_create_signal(self, record):
            raise ConnectionError("analytics down")

    temission.dispatch_signal_record(Down(), {"symbol": "X"})  # swallowed, counted

    async def deliver():
        with pytest.raises(ConnectionError):
            await temission.AnalyticsSink(Down()).deliver({"symbol": "X"})

    run(deliver(), 10)


# -- both stub engines on the reference replay ------------------------------------

CAPACITY, WINDOW = 64, 200


class FakeTicker:
    """Spot ticker stand-in for the exchange clients a bot launch builds."""

    def __init__(self, *args, **kwargs):
        pass

    def get_ticker_price(self, symbol):
        return 50.0

    def get_mark_price(self, symbol):
        return 50.0


@pytest.fixture
def no_exchange_network(monkeypatch):
    """A launch builds its exchange clients itself; answer their price
    lookups here, in both packages."""
    for mod in (jauto, tauto):
        for name in ("BinanceApi", "KucoinApi", "KucoinFutures"):
            monkeypatch.setattr(mod, name, FakeTicker)


@pytest.fixture(scope="module")
def replay_seq(tmp_path_factory):
    path = tmp_path_factory.mktemp("sinks_replay") / "rp_7.jsonl"
    treplay.generate_replay_file(path, n_symbols=24, n_ticks=120, seed=7)
    return treplay.tick_seq(path)


def _engines(tmp_path, delivery: bool):
    """Both stub engines, classic at depth 0, autotrade on, each sink over
    its own scripted backend: the binbot client (breadth, analytics) and
    admission's client each over a FuturesFakeSession."""
    j = jreplay.make_stub_engine(
        capacity=CAPACITY, window=WINDOW, incremental=False, pipeline_depth=0,
        trace_sample=0.0, freshness=False, outcomes=False, delivery=delivery,
        session=FuturesFakeSession(),
        **({"delivery_wal": str(tmp_path / "j.wal.jsonl")} if delivery else {}),
    )
    t = treplay.make_stub_engine(
        capacity=CAPACITY, window=WINDOW, device="cpu", incremental=False, pipeline_depth=0,
        donate=False, numeric_digest=False, ingest_digest=False, drift_meter=False,
        outcomes=False, delivery=delivery, session=FuturesFakeSession(), **REFERENCE_PINS,
        **({"delivery_wal": str(tmp_path / "t.wal.jsonl")} if delivery else {}),
    )
    j.telegram_consumer._min_send_interval_seconds = 0.0
    for eng, api in ((j, JBinbotApi), (t, TBinbotApi)):
        eng.at_consumer.autotrade_settings.autotrade = True
        eng.at_consumer.binbot_api = api("http://stub", session=FuturesFakeSession())
    return j, t


def _acks(plane) -> dict:
    """(sink, entry id) -> payload of every acked delivery of ``plane``."""
    got = {}
    ack = plane._ack

    def record(lane, env):
        got[(lane.sink.name, env.entry_id)] = env.payload
        ack(lane, env)

    plane._ack = record
    return got


def _comparable(sink: str, payload):
    if sink == "autotrade":
        payload = payload.model_dump(mode="json")
        if payload.get("grid_params"):
            payload["grid_params"].pop("generated_at")
    elif sink == "analytics":
        payload = dict(payload)
        payload.pop("generated_at")
    return payload


def _drive(engines, seq) -> list:
    async def go():
        fired = {id(e): [] for e in engines}
        for now_ms, klines in seq:
            for eng in engines:
                for k in klines:
                    eng.ingest(k)
                fired[id(eng)].extend(await eng.process_tick(now_ms=now_ms))
                # the tick's fire-and-forget sends land before the next tick
                await asyncio.gather(*eng.telegram_consumer._background_tasks)
        for eng in engines:
            fired[id(eng)].extend(await eng.flush_pending())
            await asyncio.gather(*eng.telegram_consumer._background_tasks)
            if eng.delivery is not None:
                assert await eng.delivery.drain(timeout_s=60)
            await eng.aclose_delivery()
        return [fired[id(e)] for e in engines]

    return run(go(), 300)


def test_stub_engines_hand_every_sink_equal_payloads(replay_seq, tmp_path, no_exchange_network):
    j, t = _engines(tmp_path, delivery=True)
    acked = {"j": _acks(j.delivery), "t": _acks(t.delivery)}
    fired_j, fired_t = _drive((j, t), replay_seq)
    assert jreplay.signal_tuples(fired_j) == treplay.signal_tuples(fired_t)
    assert len(fired_t) > 0
    assert set(acked["t"]) == set(acked["j"])
    assert {s for s, _ in acked["t"]} == {"analytics", "telegram", "autotrade"}
    assert len(acked["t"]) == 3 * len(fired_t)
    for key in sorted(acked["t"]):
        a = _comparable(key[0], acked["j"][key])
        b = _comparable(key[0], acked["t"][key])
        assert treplay.payloads_match(a, b), key
    # admission's REST calls, one lane each, in order
    jr = j.at_consumer.binbot_api.session.calls
    tr = t.at_consumer.binbot_api.session.calls
    assert any(m == "POST" and u.endswith("/bot") for m, u, _ in tr)
    assert [(m, u) for m, u, _ in tr] == [(m, u) for m, u, _ in jr]
    assert all(treplay.payloads_match(a, b) for (_, _, a), (_, _, b) in zip(jr, tr))
    for plane in (j.delivery, t.delivery):
        assert plane.wal.unacked_count() == 0 and plane.wal.dup_acks == 0
    assert [len(e._telegram_sent) for e in (j, t)] == [len(j._telegram_sent)] * 2


def test_stub_engines_inline_make_the_same_rest_sequence(replay_seq, tmp_path,
                                                          no_exchange_network):
    j, t = _engines(tmp_path, delivery=False)
    assert j.delivery is None and t.delivery is None
    fired_j, fired_t = _drive((j, t), replay_seq)
    assert jreplay.signal_tuples(fired_j) == treplay.signal_tuples(fired_t)
    for eng_j, eng_t in ((j.binbot_api, t.binbot_api),
                         (j.at_consumer.binbot_api, t.at_consumer.binbot_api)):
        jr, tr = eng_j.session.calls, eng_t.session.calls
        assert [(m, u) for m, u, _ in tr] == [(m, u) for m, u, _ in jr]
        for (_, url, a), (_, _, b) in zip(jr, tr):
            if url.endswith("/signals"):
                a, b = _comparable("analytics", a), _comparable("analytics", b)
            assert treplay.payloads_match(a, b), url
    posts = [u for m, u, _ in t.binbot_api.session.calls if m == "POST"]
    assert len(posts) == len(fired_t) > 0
    assert treplay.payloads_match(j._telegram_sent, t._telegram_sent)


def test_delivery_entry_ids_match_the_reference_untraced_form():
    from binquant_tpu.io.delivery import entry_id_of as jid
    from binquant_tpu_torch.io.delivery import entry_id_of as tid

    rng = random.Random(3)
    for _ in range(50):
        args = (None, None, rng.choice(["mrf", "abp"]), f"S{rng.randrange(999):03d}USDT",
                rng.randrange(1 << 42))
        assert tid(*args) == jid(*args) == f"t{args[4]}/0/{args[2]}/{args[3]}"

