"""The port's chaos lane (``binquant_tpu_torch/sim/chaos.py``) against the
reference's (``binquant_tpu/sim/chaos.py``) on the CPU.

* The fault seams, driven by the same scripts through both packages with
  equal outcomes: the scripted websocket (frames, drops, stalls, unknown
  verbs, exhaustion), refused connects and the connect factory, the
  Binance kline frame of every candle of a scenario stream (byte-equal),
  the flaky binbot session over each package's ``StubSession``, the flaky
  Telegram transport, the flaky delivery sink, the autotrade content key
  and the burn→recover ordering.
* ``ws_chaos_drill`` on a port engine on the CPU: every candle of the
  disconnect storm lands exactly once, the engine ticks, the sinks fail as
  scripted, the heartbeat stays live, and the drill's websocket tracker saw
  the storm while the module's did not.
* ``slow``: the three drills (websocket, delivery plane, fan-out plane)
  through both packages, the port's engines on the CPU: every check of
  each equal to the reference's, and all green.
"""

from __future__ import annotations

import asyncio
import types

import pytest
import torch

from binquant_tpu.io.replay import StubSession as RefStub
from binquant_tpu.sim import chaos as rchaos
from binquant_tpu.sim import scenarios as rscn
from binquant_tpu_torch.io.replay import StubSession as PortStub
from binquant_tpu_torch.sim import chaos as pchaos
from binquant_tpu_torch.sim import scenarios as pscn

torch.set_num_threads(1)

MODS = {"reference": (rchaos, RefStub), "port": (pchaos, PortStub)}


def _drain_ws(mod, events, max_items=10):
    """What a connector would see from one scripted session."""
    seen: list = []

    async def go():
        ws = mod.ScriptedWs(events)
        async with ws:
            await ws.send("sub")
            it = ws.__aiter__()
            for _ in range(max_items):
                try:
                    seen.append(("frame", await it.__anext__()))
                except StopAsyncIteration:
                    seen.append(("end",))
                    break
                except ConnectionError as exc:
                    seen.append(("drop", str(exc)))
        seen.append(("sent", tuple(ws.sent)))

    asyncio.run(go())
    return seen


@pytest.mark.parametrize(
    "events",
    [
        [("frame", "a"), ("frame", "b")],
        [("frame", "a"), ("drop", "storm"), ("frame", "c")],
        [("drop",), ("sleep", 0.0), ("frame", "x")],
        [("bogus", 1), ("frame", "y")],
        [],
    ],
    ids=["frames", "drop", "default_drop_and_sleep", "unknown_verb", "empty"],
)
def test_scripted_ws_equal(events):
    assert _drain_ws(pchaos, list(events)) == _drain_ws(rchaos, list(events))


def test_refused_connect_and_factory_equal():
    def run(mod):
        out = []
        factory = mod.FaultyConnectFactory([mod.RefusedConnect("down"), mod.ScriptedWs([])])

        async def go():
            for _ in range(3):
                session = factory("wss://x")
                try:
                    async with session:
                        out.append(type(session).__name__)
                except ConnectionError as exc:
                    out.append(str(exc))
            out.append(factory.connects)

        asyncio.run(go())
        return out

    assert run(pchaos) == run(rchaos) == ["down", "ScriptedWs", "ScriptedWs", 3]
    assert pchaos.GARBAGE_FRAMES == rchaos.GARBAGE_FRAMES


def test_binance_frames_of_a_scenario_stream_equal():
    spec = pscn.ScenarioSpec(name="chaos", description="", n_symbols=4, n_ticks=3)
    closes, vols, _ = pscn.base_market(spec)
    port = pscn.emit_stream(spec, closes, vols)
    rspec = rscn.ScenarioSpec(name="chaos", description="", n_symbols=4, n_ticks=3)
    rcloses, rvols, _ = rscn.base_market(rspec)
    ref = rscn.emit_stream(rspec, rcloses, rvols)
    assert port == ref
    assert [pchaos.binance_frame(k) for k in port] == [rchaos.binance_frame(k) for k in ref]


def test_flaky_session_equal():
    plan = ["ok", "timeout", "5xx", "ok", "5xx"]
    urls = ["/available-fiat", "/market-breadth", "/bot", "/active-pairs", "/bot",
            "/market-breadth", "/x"]

    def run(mod, stub):
        session = mod.FlakySession(stub(), plan=list(plan))
        out = []
        for url in urls:
            try:
                resp = session.request("POST" if url == "/bot" else "GET", url)
                out.append((resp.status_code, resp.json()))
            except TimeoutError as exc:
                out.append(("timeout", str(exc)))
        out.append(("get", session.get("/available-fiat").status_code))
        return out, session.failures

    assert run(*MODS["port"]) == run(*MODS["reference"])
    assert run(*MODS["port"])[1] == 3


def test_flaky_transport_equal():
    def run(mod):
        transport = mod.flaky_transport(plan=["error", "ok", "error"])
        out = []

        async def go():
            for i in range(5):
                try:
                    await transport("chat", f"m{i}")
                    out.append("sent")
                except RuntimeError as exc:
                    out.append(str(exc))

        asyncio.run(go())
        return out, dict(transport.calls)

    assert run(pchaos) == run(rchaos)
    assert run(pchaos)[1] == {"attempts": 5, "failed": 2}


def test_flaky_sink_and_keys_equal():
    inner = types.SimpleNamespace(
        name="autotrade", policy="at_least_once", encode=lambda s: {"e": s},
        to_wal=lambda p: {"w": p}, from_wal=lambda d: d["w"],
    )

    def run(mod):
        sink = mod.FlakySink(inner, plan=["5xx", "ok", "timeout"])
        out = [sink.name, sink.policy, sink.encode(1), sink.to_wal(2), sink.from_wal({"w": 3})]

        async def go():
            for i in range(4):
                try:
                    await sink.deliver(i)
                    out.append("ok")
                except ConnectionError as exc:
                    out.append(str(exc))

        asyncio.run(go())
        return out, sink.failures, sink.delivered

    assert run(pchaos) == run(rchaos)
    payload = types.SimpleNamespace(algorithm_name="mrf", symbol="S001USDT",
                                    direction="LONG", current_price=1.234567891234)
    assert pchaos._autotrade_key(payload) == rchaos._autotrade_key(payload)
    events = [{"event": "slo_burn", "slo": "a"}, {"event": "slo_recover", "slo": "b"},
              {"event": "slo_recover", "slo": "a"}, {"event": "slo_burn", "slo": "b"}]
    for name in ("a", "b", "c"):
        assert pchaos._burn_then_recover(events, name) == rchaos._burn_then_recover(events, name)
    assert pchaos._burn_then_recover(events, "a") and not pchaos._burn_then_recover(events, "b")


def test_ws_chaos_drill_on_the_cpu():
    from binquant_tpu_torch.io.websocket import WS_HEALTH

    facts = pchaos.ws_chaos_drill(device="cpu")
    assert facts["ok"], facts
    assert facts["landed"] and facts["lost_candles"] == 0
    assert facts["ticks"] > 0 and facts["reconnect_connects"] >= 3
    assert facts["sink_faults"] > 0 and facts["heartbeat_live"]
    # the storm degraded the drill's own tracker, which /healthz read
    assert facts["ws"]["storming"] and facts["health"]["ws"] == facts["ws"]
    assert not WS_HEALTH.snapshot()["storming"]


DRILLS = ["ws_chaos_drill", "delivery_chaos_drill", "fanout_chaos_drill"]


@pytest.mark.slow
@pytest.mark.parametrize("drill", DRILLS)
def test_drill_on_the_cpu_matches_the_reference(drill, tmp_path):
    if drill == "ws_chaos_drill":
        ref, port = rchaos.ws_chaos_drill(), pchaos.ws_chaos_drill(device="cpu")
        keys = ("landed", "lost_candles", "reconnect_connects", "heartbeat_live", "ok")
        assert {k: port[k] for k in keys} == {k: ref[k] for k in keys}
        assert port["ok"]
        return
    ref = getattr(rchaos, drill)(workdir=str(tmp_path / "ref"))
    port = getattr(pchaos, drill)(workdir=str(tmp_path / "port"), device="cpu")
    assert port["ok"], port["checks"]
    assert port["checks"] == ref["checks"]
