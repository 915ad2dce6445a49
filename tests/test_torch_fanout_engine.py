"""The fan-out plane inside the engine, against the reference engine's.

The reference's 16-symbol burst replay (``generate_replay_file(n_symbols=16,
n_ticks=60)``) goes through the reference stub engine with the plane on
(``make_stub_engine(fanout=True, capacity=32, window=120)``, the test lane's
pins: classic path, plane off, no tracing, no compaction, no tail ring) and
through two port engines with the same knobs on the CPU: the serial loop
(depth 0) and the production loop's depth 1 with rings in place. The
population is the reference test's eight subscriptions, and churn between
ticks subscribes, updates, unsubscribes and re-claims a slot (each engine
finalizes what is in flight before a churn step, so every engine matches a
signal against the same population). Per signal, the device's recipient
set must equal the oracle's and the other engines' and the recipient words
must be bit-equal; frames, outbox entries and the ``fanout_publish`` events
must be equal, the trace id masked: exact, but a frame's ``score`` against
the reference's at the wire contract (``payloads_match``: rtol 1e-4; the
packages' scores differ by float32 ulps, and the population's floors, 0 or
unreachable, sit nowhere near them) and bit-equal between the port's two
drives; the port's event log rendered by
``tools/fanout_report.py`` must equal the reference's; the ``/healthz``
``fanout`` section and the flight snapshot's must have the reference's
keys. ``FanoutSink`` rides the delivery plane as the reference's does.
"""

from __future__ import annotations

import asyncio
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from binquant_tpu.fanout import registry as jr
from binquant_tpu.io import replay as jreplay
from binquant_tpu.obs import events as jevents
from binquant_tpu_torch.engine.step import STRATEGY_ORDER
from binquant_tpu_torch.enums import MarketRegimeCode
from binquant_tpu_torch.fanout import kernel as tk
from binquant_tpu_torch.fanout import registry as tr
from binquant_tpu_torch.io import replay as treplay
from binquant_tpu_torch.obs import events as tevents
from tests.test_fanout import _fanout_population
from tests.test_torch_fanout import _ws_connect, _ws_read_json

# small shapes: extra intra-op threads only spin and crowd parallel test workers
torch.set_num_threads(1)

CAPACITY, WINDOW = 32, 120
ROOT = Path(__file__).resolve().parent.parent
# the port's knobs that the reference engine runs with under the test lane's
# pins (classic path, no digests, no tracing, inline sinks); the plane's
# compaction and tail ring pinned off as the lane pins the reference's
PORT_PINS = dict(
    incremental=False, numeric_digest=False, ingest_digest=False, drift_meter=False,
    outcomes=False, delivery=False, trace_sample=0.0, freshness=False, host_phase=False,
    slo=False, delivery_health=False, fanout=True,
    fanout_overrides=dict(fanout_compact_frac=0.0, fanout_resume_tail=0),
)
S0, S1 = STRATEGY_ORDER[0], STRATEGY_ORDER[1]
# churn before the tick of that index, (op, user, criteria); the stream's
# signals fire on ticks 33-59
CHURN = {
    12: [("subscribe", "late_all", {}), ("update", "abp_fans", {"strategies": {S0, S1}})],
    36: [("unsubscribe", "btc_only", None), ("subscribe", "cpt_fans", {"strategies": {S1}})],
    44: [("update", "multi", {"symbols": {"S005USDT", "S013USDT"}}),
         ("unsubscribe", "regime_zero", None)],
    52: [("update", "too_picky", {}), ("subscribe", "btc_only", {"symbols": {"BTCUSDT"}})],
}


def _churn(plane, mod, step) -> None:
    for op, user, crit in step:
        if op == "unsubscribe":
            plane.unsubscribe(user)
            continue
        crit = {k: frozenset(v) for k, v in crit.items()}
        getattr(plane, op)(mod.Subscription(user, **crit))


def _spy(plane, records: list) -> None:
    """Record, per fired signal, the tick, the pair, the frame (trace id
    masked), the device's recipient set and the oracle's on the exact
    match input."""
    orig = plane.on_fired

    def spy(fired, ctx, tick_ms=None):
        stats = orig(fired, ctx, tick_ms=tick_ms)
        regime = int(ctx.get("market_regime", -1))
        valid = bool(ctx.get("valid", False))
        oracle = plane.subscriptions.match_oracle(
            [(s.strategy, s.symbol, float(s.value.score or 0.0)) for s in fired],
            regime if valid and 0 <= regime < len(MarketRegimeCode) else None,
        )
        for s, want in zip(fired, oracle):
            frame, words, _ = s.fanout_frame
            users = plane.subscriptions.users_of_slots(tk.unpack_slots(words))
            records.append(dict(frame=dict(frame, trace_id="<id>"), got=frozenset(users),
                                oracle=frozenset(want), words=np.asarray(words).copy()))
        return stats

    plane.on_fired = spy


def _drive(engine, seq, mod, ev, log_path) -> dict:
    for sub in _fanout_population():
        engine.fanout.subscribe(mod.Subscription(sub.user_id, sub.symbols, sub.strategies,
                                                 sub.regimes, sub.min_strength))
    records: list = []
    _spy(engine.fanout, records)
    log = ev.EventLog(log_path)
    ev.set_event_log(log)

    async def go():
        fired = []
        for i, (now_ms, klines) in enumerate(seq):
            if i in CHURN:
                fired.extend(await engine.flush_pending())
                _churn(engine.fanout, mod, CHURN[i])
            for k in klines:
                engine.ingest(k)
            fired.extend(await engine.process_tick(now_ms=now_ms))
        fired.extend(await engine.flush_pending())
        out = dict(health=engine.health_snapshot(), flight=engine._flight_snapshot())
        await engine.aclose_fanout()
        return fired, out

    try:
        fired, out = asyncio.run(go())
    finally:
        ev.set_event_log(None)
        log.close()
    events = [json.loads(x) for x in Path(log_path).read_text().splitlines()]
    outbox = engine.fanout.outbox.entries()
    return dict(out, engine=engine, fired=fired, records=records, events=events,
                tick_ms=[t for t, _ in seq],
                outbox=[(dict(f, trace_id="<id>"), w.tolist()) for f, w in outbox],
                log=log_path)


@pytest.fixture(scope="module")
def burst_drives(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fanout_engine")
    path = tmp / "burst_16.jsonl"
    jreplay.generate_replay_file(path, n_symbols=16, n_ticks=60)
    seq = treplay.tick_seq(path)
    assert seq == jreplay.tick_seq(path)
    out = {}
    j = jreplay.make_stub_engine(capacity=CAPACITY, window=WINDOW, fanout=True)
    assert j.fanout is not None and not j.fanout.compact_frac
    out["ref"] = _drive(j, seq, jr, jevents, tmp / "j.events.jsonl")
    for key, kw in (("serial", dict(pipeline_depth=0, donate=False)),
                    ("depth1", dict(pipeline_depth=1, donate=True))):
        t = treplay.make_stub_engine(capacity=CAPACITY, window=WINDOW, device="cpu", **kw,
                                     **PORT_PINS)
        out[key] = _drive(t, seq, tr, tevents, tmp / f"{key}.events.jsonl")
    return out


def _masked_events(events, kind):
    drop = {"ts", "mono", "seq", "tick"}
    return [{k: ("<id>" if k == "trace_id" else v) for k, v in e.items() if k not in drop}
            for e in events if e["event"] == kind]


@pytest.mark.parametrize("drive", ["serial", "depth1"])
def test_recipient_sets_equal_the_oracle_and_the_reference(burst_drives, drive):
    ref, port = burst_drives["ref"], burst_drives[drive]
    assert treplay.signal_tuples(port["fired"]) == jreplay.signal_tuples(ref["fired"])
    assert len(port["records"]) == len(ref["records"]) == len(port["fired"]) > 0
    for rec in port["records"]:
        assert rec["got"] == rec["oracle"], rec["frame"]
    for a, b, c in zip(port["records"], ref["records"], burst_drives["serial"]["records"]):
        assert {k: v for k, v in a["frame"].items() if k != "score"} == {
            k: v for k, v in b["frame"].items() if k != "score"}
        assert treplay.payloads_match(a["frame"], b["frame"]), (a["frame"], b["frame"])
        assert a["frame"] == c["frame"]
        assert a["got"] == b["got"], a["frame"]
        assert np.array_equal(a["words"], b["words"])
    sets = [(r["frame"]["tick_ms"], r["got"]) for r in port["records"]]
    assert any(len(s) > 2 for _, s in sets)  # more than the wildcards matched
    # the churn changed who got what: an update widened a filter, a new
    # user took a freed slot, a floor dropped from unreachable to 0
    t36, t52 = (port["tick_ms"][i] for i in (36, 52))
    assert any("abp_fans" in s for _, s in sets) and all("late_all" in s for _, s in sets)
    assert any("cpt_fans" in s for t, s in sets if t >= t36)
    assert not any("cpt_fans" in s for t, s in sets if t < t36)
    assert any("too_picky" in s for t, s in sets if t >= t52)
    assert not any("too_picky" in s for t, s in sets if t < t52)
    assert port["engine"].fanout.recompiles == ref["engine"].fanout.recompiles
    assert port["engine"].fanout.match_dispatches == ref["engine"].fanout.match_dispatches
    assert len(port["outbox"]) == len(ref["outbox"]) == len(port["records"])
    for (fa, wa), (fb, wb) in zip(port["outbox"], ref["outbox"]):
        assert wa == wb and treplay.payloads_match(fa, fb)
    assert port["outbox"] == burst_drives["serial"]["outbox"]


@pytest.mark.parametrize("kind", ["fanout_publish", "fanout_churn", "fanout_summary"])
def test_fanout_events_equal_the_reference(burst_drives, kind):
    ref = _masked_events(burst_drives["ref"]["events"], kind)
    assert ref
    for drive in ("serial", "depth1"):
        assert _masked_events(burst_drives[drive]["events"], kind) == ref, drive


def test_fanout_report_renders_the_reference_story(burst_drives):
    sys.path.insert(0, str(ROOT / "tools"))
    try:
        import fanout_report
    finally:
        sys.path.remove(str(ROOT / "tools"))
    want = fanout_report.render_report(fanout_report.load_fanout_events(
        burst_drives["ref"]["log"]))
    assert "publish" in want and "churn" in want
    for drive in ("serial", "depth1"):
        got = fanout_report.render_report(fanout_report.load_fanout_events(
            burst_drives[drive]["log"]))
        assert got == want, drive


def _key_tree(d, depth=3):
    if not isinstance(d, dict) or depth == 0:
        return None
    return {k: _key_tree(v, depth - 1) for k, v in d.items()}


def test_health_and_flight_fanout_sections_have_the_reference_keys(burst_drives):
    ref = burst_drives["ref"]
    for drive in ("serial", "depth1"):
        port = burst_drives[drive]
        assert _key_tree(port["health"]["fanout"]) == _key_tree(ref["health"]["fanout"])
        assert port["health"]["fanout"]["enabled"] is True
        assert port["flight"]["fanout"] == ref["flight"]["fanout"]
        sub_t, sub_j = (d["health"]["fanout"]["subscriptions"] for d in (port, ref))
        assert sub_t == sub_j
    off = treplay.make_stub_engine(capacity=8, window=96, device="cpu", fanout=False)
    assert off.fanout is None
    assert off.health_snapshot()["fanout"] == {"enabled": False}
    assert off._flight_snapshot()["fanout"] is None


def test_fanout_sink_rides_the_delivery_plane(tmp_path):
    """With the delivery plane on, finalize only stamps the frame; the hub
    handoff runs on the fanout lane's worker and a connected subscriber
    receives it, as from the reference's plane; a signal without a frame
    delivers as a no-op."""
    from binquant_tpu.io.emission import FiredSignal as JSignal
    from binquant_tpu.schemas import SignalsConsumer as JValue
    from binquant_tpu_torch.io.emission import FiredSignal as TSignal
    from binquant_tpu_torch.schemas import SignalsConsumer as TValue

    got = {}
    for key, rp, mod, sig_cls, val_cls, kw in (
        ("ref", jreplay, jr, JSignal, JValue, {}),
        ("port", treplay, tr, TSignal, TValue, {"device": "cpu"}),
    ):
        engine = rp.make_stub_engine(
            capacity=16, window=WINDOW, fanout=True, delivery=True,
            delivery_wal=str(tmp_path / f"{key}.wal.jsonl"),
            delivery_overrides={"delivery_backoff_s": 0.001}, **kw,
        )
        assert engine.fanout.sink_attached and "fanout" in engine.delivery._lanes
        engine.telegram_consumer._min_send_interval_seconds = 0.0
        engine.fanout.subscribe(mod.Subscription("amy"))
        value = val_cls(autotrade=False, current_price=42.0, direction="LONG",
                        algorithm_name="mrf", symbol="TESTUSDT", score=0.7)
        signal = sig_cls(STRATEGY_ORDER[0], "TESTUSDT", 0, value, "- Action: LONG ENTRY\n- m",
                         {"symbol": "TESTUSDT", "algorithm_name": "mrf"})
        signal.trace_id, signal.tick_seq = "tr0", 1
        bare = sig_cls(STRATEGY_ORDER[0], "TESTUSDT", 0, value, "- Action: LONG ENTRY\n- m",
                       {"symbol": "TESTUSDT", "algorithm_name": "mrf"})

        async def go(engine=engine, signal=signal, bare=bare):
            port = await engine.fanout.serve(0, host="127.0.0.1")
            reader, writer, status = await _ws_connect(port, "amy")
            assert "101" in status
            engine.fanout.on_fired([signal], {"valid": False}, tick_ms=900)
            assert signal.fanout_frame is not None and bare.fanout_frame is None
            engine.delivery.start()
            engine.delivery.enqueue_fired(bare, tick_ms=900)
            engine.delivery.enqueue_fired(signal, tick_ms=900)
            assert await engine.delivery.drain(timeout_s=5.0)
            frame = await asyncio.wait_for(_ws_read_json(reader), 5)
            snap = engine.health_snapshot()
            writer.close()
            await engine.aclose_delivery()
            await engine.aclose_fanout()
            return frame, snap

        frame, snap = asyncio.run(go())
        assert snap["delivery"]["sinks"]["fanout"]["acked"] == 2
        assert snap["fanout"]["behind_delivery"] and snap["fanout"]["hub"]["frames_sent"] == 1
        got[key] = frame
    assert got["port"] == got["ref"]
    assert got["port"]["symbol"] == "TESTUSDT" and got["port"]["recipients"] == 1
