"""The tick's default observability against the reference.

Unit parity on scripted inputs, timings injected: both packages'
:class:`FreshnessTracker`, :class:`PhaseAccountant`, :class:`SloRegistry`
(burn/recover events, invariants, the verdict), :class:`DeliveryHealth`,
the ingest monitor's watermarks, churn and ``symbols_report``,
:class:`LatencyTracker` and :class:`WsHealth` give identical snapshots and
event sequences; the port's ``Config`` defaults equal the reference's
environment-free defaults for every knob the port has; a WAL entry
replayed by a restarted plane restores its ``lag0`` and trace and leaves
``dispatched_at`` None in both packages; the kernel-build ledger's snapshot
keeps the reference's keys. The port alone: its switch of the watermark
half, and ``delivered_tuples`` resolving a traced id only while its tick is
in the tracer's ring.

The engine drive (``slow``: the reference's CPU compiles of the
incremental, digest and donated steps take ~30 s): both stub engines at
production defaults (depth 1, rings in place, the incremental path, both
digests, the meter, outcomes, tracing at sample 1, freshness, host phase,
the SLO plane, delivery health and the delivery plane with temporary WALs;
the reference's fan-out plane, which the port lacks, off) on a seeded
32-symbol crash market with autotrade on. They must give equal span names
per tick, equal traced entry sets ``(tick_seq, strategy, symbol)`` per
sink, equal sink payloads once the trace id and ``freshness_ms`` are masked
(``freshness_ms`` present, finite and at least the signal's lag0 on both
sides), equal ``autotrade_launch`` trace-id presence, and
``health_snapshot()`` with the reference's key set.
"""

import asyncio
import itertools
import json
import math
import re

import numpy as np
import pytest

from binquant_tpu.engine import buffer as jbuffer
from binquant_tpu.io import autotrade as jauto
from binquant_tpu.io import delivery as jdelivery
from binquant_tpu.io import metrics as jmetrics
from binquant_tpu.io import replay as jreplay
from binquant_tpu.io import websocket as jwebsocket
from binquant_tpu.io.binbot import BinbotApi as JBinbotApi
from binquant_tpu.obs import delivery_health as jdh
from binquant_tpu.obs import events as jevents
from binquant_tpu.obs import ingest as jingest
from binquant_tpu.obs import latency as jlatency
from binquant_tpu.obs import ledger as jledger
from binquant_tpu.obs import slo as jslo
from binquant_tpu_torch.config import Config as TConfig
from binquant_tpu_torch.engine import buffer as tbuffer
from binquant_tpu_torch.io import autotrade as tauto
from binquant_tpu_torch.io import delivery as tdelivery
from binquant_tpu_torch.io import metrics as tmetrics
from binquant_tpu_torch.io import replay as treplay
from binquant_tpu_torch.io import websocket as twebsocket
from binquant_tpu_torch.io.binbot import BinbotApi as TBinbotApi
from binquant_tpu_torch.obs import delivery_health as tdh
from binquant_tpu_torch.obs import events as tevents
from binquant_tpu_torch.obs import ingest as tingest
from binquant_tpu_torch.obs import latency as tlatency
from binquant_tpu_torch.obs import ledger as tledger
from binquant_tpu_torch.obs import slo as tslo
from tests.test_autotrade_gates import FuturesFakeSession
from tests.test_torch_sinks import FakeTicker


class Recorder:
    """An event log stand-in keeping every record (no clock fields)."""

    def __init__(self):
        self.records = []
        self.enabled = True
        self.dropped = 0
        self.tick = 0

    def emit(self, event, **fields):
        self.records.append({"event": event, **fields})
        return fields


@pytest.fixture
def recorders(monkeypatch):
    """One Recorder per package, installed as every module's event log."""
    out = []
    for mods in (
        (jlatency, jslo, jingest), (tlatency, tslo, tingest),
    ):
        rec = Recorder()
        for mod in mods:
            monkeypatch.setattr(mod, "get_event_log", lambda _r=rec: _r)
        out.append(rec)
    return out


def script_freshness(lat, slo_mod, rec):
    slo = slo_mod.SloRegistry(event_every=2)
    slo.register("freshness", "freshness", 40.0)
    fr = lat.FreshnessTracker(enabled=True, slo_ms=40.0, slo=slo)
    for i, ms in enumerate([5.0, 12.5, 41.0, 80.0, 3.0, 39.9, 45.0, 46.0, 47.0]):
        fr.observe_stage("close_to_dispatch", ms / 2)
        fr.observe_stage("ingest_to_dispatch", ms / 3)
        fr.observe_signal(
            strategy="mrf", symbol=f"S{i:03d}USDT", close_to_emit_ms=ms,
            sink_ack_ms={"telegram": ms + 1.0, "analytics": ms + 0.5} if i % 2 else None,
            tick_ms=1_780_000_000_000 + i, trace_id=f"{i:016x}",
            phases={"drive": "serial", "decode": 1.5}, snapshot_fn=lambda: {"q": 1},
        )
    off = lat.FreshnessTracker(enabled=False)
    assert off.observe_signal("mrf", "X", 1.0) is None
    return fr.snapshot(), slo.verdict(), rec.records


def test_freshness_tracker_parity(recorders):
    j = script_freshness(jlatency, jslo, recorders[0])
    t = script_freshness(tlatency, tslo, recorders[1])
    assert j == t
    snap, verdict, events = t
    # 41, 80, 40.9 (a sink ack), 45, 46, 47 reach the 40 ms budget
    assert snap["signals"] == 9 and snap["slo_breaches"] == 6
    assert [e["event"] for e in events].count("freshness_slo_breach") == 6
    assert verdict["slos"]["freshness"]["recoveries"] == 1


def script_phases(lat):
    acc = lat.PhaseAccountant(enabled=True)
    walls = [12.0, 7.5, 30.0]
    for tick, wall in enumerate(walls):
        acc.begin_chunk("serial")
        for k, phase in enumerate(lat.PHASES):
            acc.record("serial", phase, 0.25 * (k + 1) + tick)
        split = acc.open_split("serial")
        acc.note_chunk("serial", wall, 1)
    off = lat.PhaseAccountant(enabled=False)
    with off.phase("serial", "plan"):
        pass
    assert off.note_chunk("serial", 1.0, 1) is None
    return acc.snapshot(), split, acc.marks("serial")


def test_phase_accountant_parity():
    assert script_phases(jlatency) == script_phases(tlatency)
    assert jlatency.PHASES == tlatency.PHASES
    assert jlatency.FRESHNESS_STAGES == tlatency.FRESHNESS_STAGES


def script_slo(slo_mod, rec, phase):
    slo = slo_mod.SloRegistry(event_every=3)
    slo.register("staleness", "staleness", 0.0, unit="rows")
    slo.register("delivery.telegram", "delivery", 100.0)
    slo.ensure("delivery.telegram", "delivery", 999.0)  # never re-parameterized
    flips = iter([True, False, True])
    slo.add_invariant("delivery_zero_loss", lambda: {"ok": True, "unacked": 0})
    slo.add_invariant("flaky", lambda: next(flips))
    if phase:
        slo.begin_phase("storm")
    pattern = [True, False, False, False, False, True, False, True, True]
    for i, ok in enumerate(pattern):
        slo.observe("staleness", ok=ok, stale_rows=0 if ok else i, budget=7)
        slo.observe("delivery.telegram", ok=i % 4 != 1, p99_ms=50.0 + i)
        slo.observe("unregistered", ok=False)
    probes = [slo.probe_invariants() for _ in range(3)]
    out = (slo.verdict(), slo.snapshot(), probes, rec.records)
    off = slo_mod.SloRegistry(enabled=False)
    off.register("x", "x", 1.0)
    off.observe("x", ok=False)
    return out + (off.verdict(), slo_mod.slo_verdict(None))


@pytest.mark.parametrize("phase", [False, True])
def test_slo_registry_parity(recorders, phase):
    j = script_slo(jslo, recorders[0], phase)
    t = script_slo(tslo, recorders[1], phase)
    assert json.dumps(j, sort_keys=True, default=str) == json.dumps(t, sort_keys=True, default=str)
    verdict, _, _, events = t[:4]
    assert verdict["ok"] is False  # the flaky probe's failure latched
    kinds = [e["event"] for e in events]
    assert "slo_burn" in kinds and "slo_recover" in kinds
    assert "invariant_probe_failed" in kinds
    assert t[4] == {"enabled": False, "ok": None, "slos": {}, "invariants": {}}


def script_delivery_health(dh_mod, slo_mod):
    slo = slo_mod.SloRegistry(event_every=256)
    health = dh_mod.DeliveryHealth(enabled=True, window=5, slo=slo, slo_ms=60.0)
    for i in range(14):
        for sink in ("autotrade", "telegram"):
            health.on_ack(sink, lag_ms=10.0 * (i % 7) + (5.0 if sink == "telegram" else 0.0),
                          attempts=1 + i % 2, replayed=i == 3)
    off = dh_mod.DeliveryHealth(enabled=False)
    off.on_ack("autotrade", 5.0)
    return health.snapshot(), slo.verdict(), off.snapshot(), health.p99("none")


def test_delivery_health_parity(recorders):
    j = script_delivery_health(jdh, jslo)
    t = script_delivery_health(tdh, tslo)
    assert j == t
    snap, verdict = t[0], t[1]
    assert snap["sinks"]["autotrade"]["acks"] == 14
    assert set(verdict["slos"]) == {"delivery.autotrade", "delivery.telegram"}


def script_ingest(buffer_mod, ingest_mod, slo_mod, rng_seed, monkeypatch):
    """Arrivals, applied batches (appends, a gap, rewrites, out-of-order),
    registry churn (a row freed and re-claimed by a new symbol), the
    per-exchange watermarks and the worst-first report."""
    monkeypatch.setattr(ingest_mod.time, "time", lambda: 1_780_010_000.0)
    rng = np.random.default_rng(rng_seed)
    reg = buffer_mod.SymbolRegistry(16)
    names = ["BTCUSDT"] + [f"S{i:03d}USDT" for i in range(1, 12)]
    for n in names:
        reg.add(n)
    slo = slo_mod.SloRegistry()
    slo.register("staleness", "staleness", 0.0, unit="rows")
    mon = ingest_mod.IngestHealthMonitor(reg, enabled=True, stale_budget=0, event_every=4,
                                         slo=slo)
    latest = {"5m": np.full(16, -1, np.int64), "15m": np.full(16, -1, np.int64)}
    t0 = 1_780_000_200
    for step in range(6):
        for interval, iv in (("5m", 300), ("15m", 900)):
            rows = np.arange(12, dtype=np.int64)
            ts = np.full(12, t0 + iv * step, np.int64)
            if step == 3:
                ts[2] += iv  # a gap
                ts[4] -= iv  # a rewrite of the latest bar
                ts[5] -= 2 * iv  # out of order
            if step == 4 and interval == "5m":
                rows, ts = rows[rng.permutation(12)[:7]], ts[:7]
            for r, t in zip(rows, ts):
                mon.note_arrival(names[r], int((t + iv) * 1000 - 1),
                                 exchange="kucoin" if r % 3 == 0 else "binance",
                                 now_ms=float((t + iv) * 1000 + 150 + r))
            mon.note_applied_batch(interval, rows, ts, latest[interval][rows],
                                   now_ms=float(t0 * 1000 + step))
            np.maximum.at(latest[interval], rows, ts)
        if step == 2:
            reg.remove("S007USDT")
            reg.add("NEWUSDT")  # re-claims row 7
            mon.note_churn()
    report = mon.symbols_report(limit=20)
    page = mon.symbols_report(offset=3, limit=4, prefix="s0", min_score=0.99)
    snap = mon.snapshot()
    return (report, page, snap, mon.exchange_watermarks(1_780_011_000_000.0),
            mon.churn_total)


def test_ingest_watermarks_parity(monkeypatch):
    j = script_ingest(jbuffer, jingest, jslo, 4, monkeypatch)
    t = script_ingest(tbuffer, tingest, tslo, 4, monkeypatch)
    assert j == t
    report = t[0]
    assert report["total"] == 12 and t[4] == 2
    by_sym = {r["symbol"]: r for r in report["symbols"]}
    assert by_sym["S002USDT"]["gaps"] >= 1 and by_sym["S005USDT"]["out_of_order"] >= 1
    assert by_sym["NEWUSDT"]["churn"] == 1
    assert set(t[3]) == {"binance", "kucoin"}


@pytest.mark.parametrize("seed", [0, 1])
def test_ingest_digest_decode_parity(recorders, seed):
    """The same digest blocks through both monitors: staleness burn and
    recovery, the SLO feed, the anomaly and recovered events."""
    from binquant_tpu.engine import step as jstep
    from binquant_tpu_torch.engine import step as tstep

    rng = np.random.default_rng(seed)
    n = jstep.INGEST_DIGEST_WIDTH
    assert n == tstep.INGEST_DIGEST_WIDTH
    blocks = [np.zeros(n, np.float32) for _ in range(6)]
    for b in blocks[1:4]:
        b[:] = rng.integers(0, 5, n).astype(np.float32)
    out = []
    for buffer_mod, ingest_mod, slo_mod, step_mod, rec in (
        (jbuffer, jingest, jslo, jstep, recorders[0]),
        (tbuffer, tingest, tslo, tstep, recorders[1]),
    ):
        reg = buffer_mod.SymbolRegistry(8)
        slo = slo_mod.SloRegistry()
        slo.register("staleness", "staleness", 0.0, unit="rows")
        mon = ingest_mod.IngestHealthMonitor(reg, enabled=True, event_every=2, slo=slo)
        digests = [mon.observe_digest(b, tick_ms=i, trace_id=f"{i:016x}",
                                      snapshot_fn=lambda: {"e": 1})
                   for i, b in enumerate(blocks)]
        out.append((digests, mon.snapshot(), slo.verdict(),
                    [e for e in rec.records]))
    assert json.dumps(out[0], sort_keys=True, default=str) == json.dumps(
        out[1], sort_keys=True, default=str)


def test_latency_tracker_and_ws_health_parity():
    out = []
    for metrics, ws in ((jmetrics, jwebsocket), (tmetrics, twebsocket)):
        lt = metrics.LatencyTracker(window=8, mirror=False)
        for i in range(20):
            lt.record("tick_total", 3.0 + (i * 7) % 11)
            lt.record("emission", 0.5 * i)
        health = ws.WsHealth(window_s=60.0, degrade_reconnects=3)
        for k in range(4):
            health.note_reconnect("binance", k, backoff_s=2.0 * k, now=100.0 + k)
        health.note_connected("binance", 1)
        out.append((lt.stats(), health.snapshot(now=130.0), health.snapshot(now=200.0),
                    ws.WS_HEALTH.snapshot(now=0.0)))
    assert out[0] == out[1]
    assert out[1][1]["storming"] and not out[1][2]["storming"]


OBS_KNOBS = (
    "trace_sample", "trace_slow_ms", "trace_ring", "freshness_enabled", "freshness_slo_ms",
    "host_phase_enabled", "slo_enabled", "slo_window", "slo_event_every",
    "delivery_health_enabled", "delivery_slo_ms", "metrics_port", "heartbeat_max_age_s",
)


# the port's knobs the reference names differently
REFERENCE_NAMES = {"incremental": "incremental_enabled", "donate": "donate_enabled"}


@pytest.fixture
def env_free_reference_config(monkeypatch):
    import os

    from binquant_tpu.config import Config as JConfig

    for key in [k for k in os.environ if k.startswith("BQT_")]:
        monkeypatch.delenv(key)
    JConfig.reset()
    yield JConfig()
    JConfig.reset()


def test_config_defaults_equal_the_reference(env_free_reference_config):
    """Every knob the port's Config has, at its default, equals the
    reference's environment-free default. Paths and directories compare by
    their last component: the port keeps its files in the temporary
    directory, the reference in /tmp."""
    import dataclasses

    ref, port = env_free_reference_config, TConfig()
    names = [f.name for f in dataclasses.fields(TConfig)]
    assert set(OBS_KNOBS) <= set(names)
    compared = 0
    for name in names:
        if name in ("env", "telegram_bot_token", "telegram_user_id"):
            continue  # read from the environment by the reference
        if name == "checkpoint_path":
            continue  # the port saves only where its caller names a path
        if name == "ingest_watermarks_enabled":
            continue  # the port's own switch (on, as the reference always is)
        ref_name = REFERENCE_NAMES.get(name, name)
        assert hasattr(ref, ref_name), name
        want, got = getattr(ref, ref_name), getattr(port, name)
        if name.endswith(("_path", "_dir")) and want:
            assert got.rsplit("/", 1)[-1] == want.rsplit("/", 1)[-1], name
        elif isinstance(want, tuple) or isinstance(got, tuple):
            assert tuple(got) == tuple(want), name
        else:
            assert type(got)(want) == got, (name, want, got)
        compared += 1
    assert compared >= len(OBS_KNOBS) + 20


def test_wal_replay_restores_lag0_and_trace(tmp_path):
    """A WAL put carries the entry's lag0 and trace; a restarted plane
    replays it with them and ``dispatched_at`` None, in both packages, and
    its ack reports the cross-process lag to the health collector."""

    class Payload:
        def __init__(self):
            self.metadata = {}

    class DownSink:
        name, policy = "autotrade", "at_least_once"

        def __init__(self, up):
            self.up = up

        def encode(self, signal):
            return {"symbol": signal.symbol, "metadata": {}}

        def stamp(self, payload, entry_id):
            payload["metadata"]["delivery_id"] = entry_id

        def to_wal(self, payload):
            return payload

        def from_wal(self, raw):
            return raw

        async def deliver(self, payload):
            if not self.up:
                raise RuntimeError("down")

    class Signal:
        strategy, symbol = "mrf", "S001USDT"
        trace_id, tick_seq = "00000000000000ab", 7

    out = []
    for delivery, dh in ((jdelivery, jdh), (tdelivery, tdh)):
        wal = tmp_path / f"{delivery.__name__}.wal.jsonl"

        async def run(_delivery=delivery, _dh=dh, _wal=wal):
            down = _delivery.DeliveryPlane([DownSink(False)], wal_path=_wal, backoff_s=60.0)
            down.enqueue_fired(Signal(), tick_ms=1_780_000_000_000, lag0_ms=12.5,
                               dispatched_at=0.0)
            await asyncio.sleep(0.05)
            await down.aclose(drain_s=0.0)
            health = _dh.DeliveryHealth(enabled=True)
            up = _delivery.DeliveryPlane([DownSink(True)], wal_path=_wal, health=health)
            seen = []
            decode = up._decode_wal_record

            def spy(lane, rec):
                env = decode(lane, rec)
                seen.append((env.entry_id, env.lag0_ms, env.dispatched_at, env.trace_id,
                             env.replayed))
                return env

            up._decode_wal_record = spy
            up.start()
            assert await up.drain(timeout_s=10)
            await up.aclose(drain_s=1.0)
            return seen, health.acks

        out.append(asyncio.run(run()))
        records = [json.loads(line) for line in wal.read_text().splitlines() if line]
        assert all(r.get("op") != "put" or r["lag0"] == 12.5 for r in records)
    assert out[0] == out[1]
    seen, acks = out[1]
    assert seen == [("00000000000000ab/7/mrf/S001USDT", 12.5, None, "00000000000000ab", True)]
    assert acks == {"autotrade": 1}


@pytest.mark.parametrize("watermarks", [True, False])
def test_ingest_watermarks_switch(watermarks):
    """The port's switch of the monitor's watermark half: on by default, as
    the reference always runs it; off, an ingested candle leaves no arrival
    watermark while the digest half stays on."""
    kw = {} if watermarks else {"ingest_watermarks": False}
    engine = treplay.make_stub_engine(capacity=8, window=96, device="cpu", delivery=False, **kw)
    assert engine.ingest_monitor.enabled and engine.ingest_watermarks is watermarks
    t0 = 1_780_000_200_000
    engine.ingest({"symbol": "BTCUSDT", "open_time": t0, "close_time": t0 + 299_999,
                   "open": 1.0, "high": 1.0, "low": 1.0, "close": 1.0, "volume": 1.0})
    marks = engine.ingest_monitor.exchange_watermarks(t0 + 300_000)
    assert marks == ({"binance": 1.0} if watermarks else {})


def test_delivered_tuples_past_the_tracer_ring():
    """A traced delivery id resolves through the tracer's ring while its
    tick is still there; past the ring it raises, naming the ring's size."""
    from binquant_tpu_torch.obs.tracing import Tracer

    tracer = Tracer(ring=2)
    ids = []
    for seq in (1, 2, 3):
        trace = tracer.begin_tick(seq, tick_ms=1_780_000_000_000 + 900_000 * seq)
        ids.append(trace.trace_id)
        tracer.complete(trace)

    class Payload:
        algorithm_name, symbol, direction, autotrade = "mrf", "S001USDT", "LONG", True

        def __init__(self, entry_id):
            self.metadata = {"delivery_id": entry_id}

    got = treplay.delivered_tuples(
        [Payload(f"{ids[2]}/3/mrf/S001USDT"), Payload("t1780000000000/0/mrf/S001USDT")],
        tracer=tracer,
    )
    assert [g[0] for g in got] == [1_780_000_000_000 + 2_700_000, 1_780_000_000_000]
    with pytest.raises(LookupError, match="trace_ring=2"):
        treplay.delivered_tuples([Payload(f"{ids[0]}/1/mrf/S001USDT")], tracer=tracer)


def test_build_ledger_keeps_the_reference_keys():
    ref, port = jledger.ExecutableLedger(), tledger.ExecutableLedger()
    port.record("qt.build", "csrc/qtail.cu sm_90a libqtail_x", 2.5, "cold")
    port.record("qt.build", "csrc/qtail.cu sm_90a libqtail_x", 0.0, "warm")
    snap, rsnap = port.snapshot(), ref.snapshot()
    assert set(snap) == set(rsnap) and set(snap["totals"]) == set(rsnap["totals"])
    entry = snap["executables"][0]
    assert entry["compiles"] == 2 and entry["compile_seconds"] == 2.5
    assert entry["cache"] == "warm" and entry["cost"] is None
    assert snap["totals"]["persistent_cache_hits"] == 1
    rec = Recorder()
    import binquant_tpu_torch.obs.ledger as ledger_mod

    ledger_mod_get = ledger_mod.get_event_log
    ledger_mod.get_event_log = lambda: rec
    try:
        assert port.emit_summary("boot") is not None
        assert port.emit_summary("boot") is None  # once per boot
    finally:
        ledger_mod.get_event_log = ledger_mod_get
    assert rec.records[0]["event"] == "compile_summary"
    assert set(rec.records[0]) - {"event", "reason"} == set(rsnap["totals"])


# -- the engine drive at production defaults (both packages) ---------------------

S, W, LIVE = 32, 130, 5
T0 = 1_780_000_200 // 900 * 900
NAMES = ["BTCUSDT"] + [f"S{i:03d}USDT" for i in range(1, S)]
# the reference's production knobs the stub engine takes no argument for
REFERENCE_ENV = dict(BQT_NUMERIC_DIGEST="1", BQT_DRIFT_METER="1", BQT_INGEST_DIGEST="1",
                     BQT_SLO="1", BQT_DELIVERY_HEALTH="1", BQT_FANOUT="0")


def crash_market(seed: int = 11):
    """W 15m bars of a seeded random walk (with their 5m legs), then LIVE
    bars of a market-wide downtrend ending in a hammer 4.5% under the last
    close on 3x volume (MeanReversionFade's setup)."""
    rng = np.random.default_rng(seed)
    rets5 = rng.normal(0.0, 0.004, (S, 3 * W))
    close5 = (20 + rng.random((S, 1)) * 100) * np.exp(np.cumsum(rets5, axis=1))
    open5 = np.concatenate([close5[:, :1], close5[:, :-1]], axis=1)
    vol5 = np.abs(rng.normal(1000, 200, (S, 3 * W)))
    last = close5[:, -1:]
    close = last * np.exp(np.cumsum(rng.normal(-0.004, 0.002, (S, LIVE)), axis=1))
    open_ = np.concatenate([last, close[:, :-1]], axis=1)
    vol = np.abs(rng.normal(3000, 600, (S, LIVE)))
    open_[:, -1] *= 0.955
    close[:, -1] = open_[:, -1] * 1.003
    vol[:, -1] *= 3.0
    legs = [open_ + (close - open_) * (j + 1) / 3 for j in range(3)]
    open5 = np.concatenate(
        [open5, np.stack([open_, legs[0], legs[1]], axis=2).reshape(S, 3 * LIVE)], axis=1)
    close5 = np.concatenate([close5, np.stack(legs, axis=2).reshape(S, 3 * LIVE)], axis=1)
    vol5 = np.concatenate([vol5, np.repeat(vol / 3, 3, axis=1)], axis=1)
    m5 = dict(open=open5, high=np.maximum(open5, close5) * 1.001,
              low=np.minimum(open5, close5) * 0.999, close=close5, volume=vol5)
    g = lambda a: a.reshape(S, W + LIVE, 3)  # noqa: E731
    m15 = dict(open=g(m5["open"])[:, :, 0], high=g(m5["high"]).max(axis=2),
               low=g(m5["low"]).min(axis=2), close=g(close5)[:, :, 2],
               volume=g(vol5).sum(axis=2))
    return m5, m15


def _values(m, cols, iv):
    o, h, lo, c, v = (m[k][:, cols] for k in ("open", "high", "low", "close", "volume"))
    return np.stack([o, h, lo, c, v, v * c, np.full_like(c, 300.0), v / 2, v * c / 2,
                     np.full_like(c, float(iv))], -1).astype(np.float32)


def _kline(r, ts, iv, m, i):
    o, h, lo, c, v = (float(m[k][r, i]) for k in ("open", "high", "low", "close", "volume"))
    return {"symbol": NAMES[r], "open_time": ts * 1000, "close_time": (ts + iv) * 1000 - 1,
            "open": o, "high": h, "low": lo, "close": c, "volume": v,
            "quote_asset_volume": v * c, "number_of_trades": 300.0,
            "taker_buy_base_volume": v / 2, "taker_buy_quote_volume": v * c / 2}


def tick_plan(engine, m5, m15):
    """W bars of history queued as sub-batches (folded by the warm tick),
    then the LIVE ticks of closed klines."""
    rows = np.array([engine.registry.add(n) for n in NAMES], np.int32)
    w15, w5 = _values(m15, slice(0, W), 900), _values(m5, slice(2 * W, 3 * W), 300)
    for k in range(W):
        engine.batcher15.add_batch(rows, np.full(S, T0 - 900 * (W - k), np.int32), w15[:, k])
        engine.batcher5.add_batch(rows, np.full(S, T0 - 300 * (W - k), np.int32), w5[:, k])
    ticks = [(T0 * 1000, [])]
    for t in range(LIVE):
        ts = T0 + 900 * t
        kk = []
        for r in range(S):
            kk.append(_kline(r, ts, 900, m15, W + t))
            kk += [_kline(r, ts + 300 * j, 300, m5, 3 * (W + t) + j) for j in range(3)]
        ticks.append(((ts + 900) * 1000, kk))
    return ticks


def _span_names(node) -> list:
    return [node["name"]] + [n for c in node.get("children", ()) for n in _span_names(c)]


def _acks(plane) -> dict:
    got = {}
    ack = plane._ack

    def record(lane, env):
        got[(lane.sink.name, env.entry_id)] = env.payload
        ack(lane, env)

    plane._ack = record
    return got


_TRACE_LINE = re.compile(r"\n- Trace: ([0-9a-f]{16})/(\d+)$")


def _masked(sink: str, payload):
    """A sink payload with its trace id and freshness_ms value masked (the
    tick_seq stays); asserts freshness_ms is present and finite."""
    if sink == "telegram":
        m = _TRACE_LINE.search(payload)
        assert m, payload[-80:]
        return payload[: m.start()] + f"\n- Trace: <id>/{m.group(2)}"
    if sink == "autotrade":
        payload = payload.model_dump(mode="json")
        meta = payload["metadata"]
        if payload.get("grid_params"):
            payload["grid_params"].pop("generated_at")
    else:
        payload = dict(payload)
        payload.pop("generated_at")
        meta = payload
    assert re.fullmatch(r"[0-9a-f]{16}", meta["trace_id"])
    assert math.isfinite(meta["freshness_ms"])
    meta["trace_id"] = meta["freshness_ms"] = "<masked>"
    if "delivery_id" in meta:
        meta["delivery_id"] = "<id>/" + meta["delivery_id"].split("/", 1)[1]
    return payload


@pytest.fixture(scope="module")
def production_drives(tmp_path_factory):
    """Both stub engines at production defaults through the same ticks;
    returns what each traced, delivered and reported."""
    tmp = tmp_path_factory.mktemp("obs_drive")
    m5, m15 = crash_market()
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for mod in (jauto, tauto):
            for name in ("BinanceApi", "KucoinApi", "KucoinFutures"):
                mp.setattr(mod, name, FakeTicker)
        for k, v in REFERENCE_ENV.items():
            mp.setenv(k, v)
        j = jreplay.make_stub_engine(
            capacity=S, window=W, pipeline_depth=1, incremental=True, donate=True,
            trace_sample=1.0, freshness=True, host_phase=True, outcomes=True, delivery=True,
            delivery_wal=str(tmp / "j.wal.jsonl"), session=FuturesFakeSession(),
        )
        t = treplay.make_stub_engine(
            capacity=S, window=W, device="cpu", delivery_wal=str(tmp / "t.wal.jsonl"),
            session=FuturesFakeSession(), fanout=False,
        )
        j.telegram_consumer._min_send_interval_seconds = 0.0
        for eng, api, ev in ((j, JBinbotApi, jevents), (t, TBinbotApi, tevents)):
            eng.at_consumer.autotrade_settings.autotrade = True
            eng.at_consumer.binbot_api = api("http://stub", session=FuturesFakeSession())
        logs = {}
        for key, eng, ev in (("j", j, jevents), ("t", t, tevents)):
            log = ev.EventLog(tmp / f"{key}.events.jsonl")
            ev.set_event_log(log)
            acked = _acks(eng.delivery)
            fired = []

            async def go(_eng=eng, _fired=fired):
                for now_ms, klines in tick_plan(_eng, m5, m15):
                    for k in klines:
                        _eng.ingest(k)
                    _fired.extend(await _eng.process_tick(now_ms=now_ms))
                _fired.extend(await _eng.flush_pending())
                assert await _eng.delivery.drain(timeout_s=60)
                health = _eng.health_snapshot()
                await _eng.aclose_delivery()
                return health

            health = asyncio.run(asyncio.wait_for(go(), timeout=300))
            ev.set_event_log(None)
            log.close()
            events = [json.loads(x) for x in (tmp / f"{key}.events.jsonl").read_text().splitlines()]
            logs[key] = events
            out[key] = dict(engine=eng, fired=fired, acked=acked, health=health, events=events)
    return out


@pytest.mark.slow
def test_production_drive_span_names_per_tick(production_drives):
    j, t = production_drives["j"], production_drives["t"]
    assert jreplay.signal_tuples(j["fired"]) == treplay.signal_tuples(t["fired"])
    assert len(t["fired"]) > 0
    tj = [e for e in j["events"] if e["event"] == "trace"]
    tt = [e for e in t["events"] if e["event"] == "trace"]
    assert len(tt) == len(tj) == LIVE + 1
    for a, b in zip(tj, tt):
        assert a["tick_seq"] == b["tick_seq"]
        assert _span_names(a["spans"]) == _span_names(b["spans"]), a["tick_seq"]
        assert a["path"] == b["path"]
    names = set(itertools.chain.from_iterable(_span_names(e["spans"]) for e in tt))
    assert {"breadth_refresh", "ingest_drain", "route_decision", "buffer_fold",
            "inputs_build", "device_dispatch", "wire_fetch", "numeric_digest",
            "ingest_digest", "extract_fired", "dedupe", "emission",
            "delivery.enqueue"} <= names


@pytest.mark.slow
def test_production_drive_traced_entries_and_payloads(production_drives):
    j, t = production_drives["j"], production_drives["t"]

    def keys(acked):
        out = set()
        for sink, entry_id in acked:
            tid, seq, strategy, symbol = entry_id.split("/")
            assert re.fullmatch(r"[0-9a-f]{16}", tid), entry_id
            out.add((sink, int(seq), strategy, symbol))
        return out

    assert keys(t["acked"]) == keys(j["acked"])
    assert {s for s, _ in t["acked"]} == {"analytics", "telegram", "autotrade"}
    by_key = {}
    for side in ("j", "t"):
        for (sink, entry_id), payload in production_drives[side]["acked"].items():
            _, seq, strategy, symbol = entry_id.split("/")
            by_key.setdefault((sink, int(seq), strategy, symbol), {})[side] = payload
    for key, pair in sorted(by_key.items()):
        a, b = _masked(key[0], pair["j"]), _masked(key[0], pair["t"])
        assert treplay.payloads_match(a, b), key
    # freshness_ms: at least the signal's lag0 (tick clock minus the bar close)
    for side in ("j", "t"):
        for sig in production_drives[side]["fired"]:
            eng = production_drives[side]["engine"]
            ts_s = sig.tick_ms // 1000
            ts15 = ts_s // 900 * 900 - 900
            ts5 = ts_s // 300 * 300 - 300
            lag0 = sig.tick_ms - eng._bar_close_ms(sig.strategy, ts5, ts15)
            assert math.isfinite(sig.freshness_ms) and sig.freshness_ms >= lag0


@pytest.mark.slow
def test_production_drive_launch_trace_presence_and_health_keys(production_drives):
    j, t = production_drives["j"], production_drives["t"]
    lj = [e for e in j["events"] if e["event"] == "autotrade_launch"]
    lt = [e for e in t["events"] if e["event"] == "autotrade_launch"]
    assert len(lt) == len(lj) > 0
    assert [e["trace_id"] is None for e in lt] == [e["trace_id"] is None for e in lj]

    def key_tree(d, depth=2):
        if not isinstance(d, dict) or depth == 0:
            return None
        return {k: key_tree(v, depth - 1) for k, v in d.items()}

    hj, ht = j["health"], t["health"]
    assert set(ht) == set(hj)
    for section in ("ws", "numeric", "ingest", "latency", "slo", "mesh", "fanout"):
        assert key_tree(ht[section]) == key_tree(hj[section]), section
    assert set(ht["delivery"]) == set(hj["delivery"])
    assert ht["status"] == hj["status"] == "ok"
    assert ht["slo"]["ok"] is hj["slo"]["ok"] is True
    assert set(ht["slo"]["invariants"]) == set(hj["slo"]["invariants"])
    assert set(ht["slo"]["slos"]) == set(hj["slo"]["slos"])
    assert ht["signals_emitted"] == len(t["fired"])
