"""Transport/sink fault injection for the chaos lane.

The port's own copy of the reference's chaos lane (``binquant_tpu/sim/
chaos.py``): the same fault seams and the same three drills, each on
``device`` (CUDA unless the caller asks for the CPU). It uses the seams
the io layer already exposes instead of monkeypatching:
the websocket connectors take an injectable ``connect`` factory
(:class:`FaultyConnectFactory` scripts disconnect storms, malformed and
partial frames, refused/delayed reconnects), ``BinbotApi`` takes an
injectable session (:class:`FlakySession` injects 5xx and timeout storms
around the replay stub), and ``TelegramConsumer`` takes an injectable
transport (:func:`flaky_transport`).

:func:`ws_chaos_drill` is the end-to-end drill the corpus runs: a
real ``KlinesConnector`` + ``SignalEngine.consume_loop`` stack under a
scripted disconnect storm, garbage frames, AND flaky sinks — asserting
the engine keeps ticking, the heartbeat stays live, and ZERO closed
candles are lost across the reconnects.
"""

from __future__ import annotations

import asyncio
import json
import time
from typing import Any

import numpy as np


class ScriptedWs:
    """One scripted websocket session: an async context manager + async
    frame iterator driven by an event list:

    * ``("frame", payload)`` — yield one raw frame;
    * ``("drop", msg)``      — raise (the connector reconnects);
    * ``("sleep", seconds)`` — stall the stream;
    * ``("idle",)``          — stay connected, delivering nothing.
    """

    def __init__(self, events: list[tuple]) -> None:
        self._events = list(events)
        self.sent: list[str] = []

    async def __aenter__(self) -> "ScriptedWs":
        return self

    async def __aexit__(self, *exc) -> bool:
        return False

    async def send(self, payload: str) -> None:
        self.sent.append(payload)

    def __aiter__(self) -> "ScriptedWs":
        return self

    async def __anext__(self) -> str:
        while self._events:
            kind, *args = self._events[0]
            if kind == "frame":
                self._events.pop(0)
                return args[0]
            if kind == "sleep":
                self._events.pop(0)
                await asyncio.sleep(args[0])
                continue
            if kind == "drop":
                self._events.pop(0)
                raise ConnectionError(args[0] if args else "scripted drop")
            if kind == "idle":
                await asyncio.sleep(3600.0)
            else:  # unknown event: skip rather than wedge the drill
                self._events.pop(0)
        raise StopAsyncIteration


class RefusedConnect:
    """A connect attempt that fails at the handshake — the delayed-
    reconnect case (exchange still down when the client retries)."""

    def __init__(self, msg: str = "scripted connection refused") -> None:
        self.msg = msg

    async def __aenter__(self):
        raise ConnectionError(self.msg)

    async def __aexit__(self, *exc) -> bool:
        return False


class FaultyConnectFactory:
    """Injectable ``connect`` for the connectors: each call hands out the
    next scripted session; exhausted scripts idle connected so the drill
    ends with a healthy stream."""

    def __init__(self, sessions: list[Any]) -> None:
        self._sessions = list(sessions)
        self.connects = 0

    def __call__(self, url: str, **_kw):
        self.connects += 1
        if self._sessions:
            return self._sessions.pop(0)
        return ScriptedWs([("idle",)])


def binance_frame(k: dict) -> str:
    """One closed-candle Binance kline frame for an ExtendedKline dict —
    the inverse of ``parse_binance_kline_frame``'s field mapping."""
    return json.dumps(
        {
            "e": "kline",
            "k": {
                "s": k["symbol"],
                "t": k["open_time"],
                "T": k["close_time"],
                "x": True,
                "o": str(k["open"]),
                "h": str(k["high"]),
                "l": str(k["low"]),
                "c": str(k["close"]),
                "v": str(k["volume"]),
                "q": str(k.get("quote_asset_volume", 0.0)),
                "n": k.get("number_of_trades", 0.0),
                "V": str(k.get("taker_buy_base_volume", 0.0)),
                "Q": str(k.get("taker_buy_quote_volume", 0.0)),
            },
        }
    )


GARBAGE_FRAMES = (
    "{not json at all",
    '{"e": "kline", "k": ',  # torn mid-frame
    "\x00\x01\x02binary noise",
)


class FlakySession:
    """Wraps the replay ``StubSession`` (or any session) with a scripted
    per-request fault plan: ``"ok"`` passes through, ``"5xx"`` returns a
    503 error body, ``"timeout"`` raises. The plan is consumed one entry
    per request; exhausted → ok. ``failures`` counts injected faults."""

    def __init__(self, inner: Any, plan: list[str] | tuple = ()) -> None:
        self.inner = inner
        self.plan = list(plan)
        self.failures = 0

    def _mode(self) -> str:
        return self.plan.pop(0) if self.plan else "ok"

    def request(self, method: str, url: str, **kwargs):
        mode = self._mode()
        if mode == "timeout":
            self.failures += 1
            raise TimeoutError(f"scripted timeout: {method} {url}")
        if mode == "5xx":
            self.failures += 1
            resp = self.inner.request(method, url, **kwargs)
            resp.status_code = 503
            return resp
        return self.inner.request(method, url, **kwargs)

    def get(self, url, params=None):
        return self.request("GET", url, params=params)


def flaky_transport(plan: list[str] | tuple = ()):
    """An async Telegram transport failing per plan entry (``"error"`` /
    ``"ok"``; exhausted → ok). ``transport.calls`` tallies attempts and
    injected failures."""
    plan_list = list(plan)
    calls = {"attempts": 0, "failed": 0}

    async def transport(chat_id: str, text: str) -> None:
        calls["attempts"] += 1
        mode = plan_list.pop(0) if plan_list else "ok"
        if mode == "error":
            calls["failed"] += 1
            raise RuntimeError("scripted telegram transport failure")

    transport.calls = calls  # type: ignore[attr-defined]
    return transport


# -- the end-to-end chaos drill ----------------------------------------------


def ws_chaos_drill(
    n_symbols: int = 8,
    n_ticks: int = 6,
    timeout_s: float = 30.0,
    device: str = "cuda",
) -> dict:
    """Disconnect storm + garbage frames + sink 5xx storm through the REAL
    ingest stack: a ``KlinesConnector`` (scripted factory, fast jittered
    backoff) feeding ``SignalEngine.consume_loop`` whose binbot session
    and Telegram transport are flaky. Returns the facts the scenario lane
    asserts: the engine ticked, the heartbeat stayed live, reconnects
    were observed (and surfaced via the ws health tracker), and every
    closed candle in the script landed in the device buffers exactly
    once (``lost_candles == 0``)."""
    from binquant_tpu_torch.io.replay import StubSession
    from binquant_tpu_torch.sim.runner import corpus_engine
    from binquant_tpu_torch.io.websocket import KlinesConnector, WsHealth
    from binquant_tpu_torch.schemas import SymbolModel
    from binquant_tpu_torch.sim.scenarios import (
        ScenarioSpec,
        base_market,
        emit_stream,
        symbol_names,
    )

    spec = ScenarioSpec(
        name="chaos", description="", n_symbols=n_symbols, n_ticks=n_ticks
    )
    closes, vols, _rng = base_market(spec)
    klines = emit_stream(spec, closes, vols)
    frames = [binance_frame(k) for k in klines]
    cut = len(frames) // 3

    # session 1: a third of the stream, then a hard drop mid-feed;
    # session 2: the exchange refuses the reconnect (delayed recovery);
    # session 3: garbage + torn frames mixed into the rest, then idle.
    sessions = [
        ScriptedWs([("frame", f) for f in frames[:cut]] + [("drop", "storm")]),
        RefusedConnect(),
        ScriptedWs(
            [("frame", GARBAGE_FRAMES[0]), ("frame", GARBAGE_FRAMES[1])]
            + [("frame", f) for f in frames[cut:]]
            + [("frame", GARBAGE_FRAMES[2]), ("idle",)]
        ),
    ]
    factory = FaultyConnectFactory(sessions)
    health = WsHealth(window_s=60.0, degrade_reconnects=2)

    flaky_session = FlakySession(
        StubSession(),
        # a FULL sink outage: every backend call during the drill eats a
        # timeout or a 503 (the drill ticks on a wall clock, so only a
        # handful of calls — e.g. the per-bucket breadth refresh — happen;
        # all of them must fail and the engine must not care)
        plan=["timeout", "5xx"] * 50,
    )
    telegram = flaky_transport(plan=["error", "ok"] * 20)
    engine = corpus_engine(
        capacity=32,
        window=120,
        device=device,
        session=flaky_session,
        telegram_transport=telegram,
        # this drill pins the INLINE sink path's isolation; the delivery
        # plane's storm/kill/restore drill is delivery_chaos_drill below
        # and the fan-out plane's churn/stall drill is fanout_chaos_drill
        delivery=False,
        fanout=False,
    )
    engine.ws_health = health

    symbols = [
        SymbolModel(id=name, base_asset=name[:-4], quote_asset="USDT")
        for name in symbol_names(n_symbols)
    ]
    queue: asyncio.Queue = asyncio.Queue()
    connector = KlinesConnector(
        queue,
        symbols,
        connect=factory,
        reconnect_seed=7,
        initial_backoff_s=0.02,
        max_backoff_s=0.1,
        health=health,
    )

    expected15 = n_ticks
    expected5 = n_ticks * 3

    async def drill() -> dict:
        await connector.start_stream()
        consume = asyncio.create_task(
            engine.consume_loop(queue, tick_interval_s=0.05)
        )
        deadline = time.monotonic() + timeout_s

        def all_landed() -> bool:
            rows = [engine.registry.row_of(s.id) for s in symbols]
            if any(r is None for r in rows):
                return False
            f15 = engine.state.buf15.filled.cpu().numpy()
            f5 = engine.state.buf5.filled.cpu().numpy()
            return all(
                f15[r] >= expected15 and f5[r] >= expected5 for r in rows
            )

        landed = False
        while time.monotonic() < deadline:
            await asyncio.sleep(0.05)
            if engine.ticks_processed > 0 and all_landed():
                landed = True
                break
        # a couple more intervals so the post-storm engine provably keeps
        # ticking with the stream idle-connected
        ticks_at_land = engine.ticks_processed
        await asyncio.sleep(0.2)
        consume.cancel()
        await asyncio.gather(consume, return_exceptions=True)
        await connector.stop()

        lost = 0
        for s_idx, name in enumerate(symbol_names(n_symbols)):
            row = engine.registry.row_of(name)
            if row is None:
                lost += expected15 + expected5
                continue
            lost += max(
                0, expected15 - int(engine.state.buf15.filled[row])
            )
            lost += max(
                0, expected5 - int(engine.state.buf5.filled[row])
            )
        return {
            "landed": landed,
            "lost_candles": lost,
            "ticks": engine.ticks_processed,
            "ticks_after_storm": engine.ticks_processed - ticks_at_land,
            "reconnect_connects": factory.connects,
            "ws": health.snapshot(),
            "sink_faults": flaky_session.failures,
            "telegram": dict(telegram.calls),
            "health": engine.health_snapshot(),
            "heartbeat_live": engine.health_snapshot()["heartbeat_age_s"]
            is not None,
        }

    facts = asyncio.run(drill())
    facts["ok"] = bool(
        facts["landed"]
        and facts["lost_candles"] == 0
        and facts["ticks"] > 0
        and facts["reconnect_connects"] >= 3
        and facts["sink_faults"] > 0
        and facts["heartbeat_live"]
    )
    return facts


# -- the delivery-plane chaos drill -------------------------------------------


class FlakySink:
    """Wraps a :class:`~binquant_tpu_torch.io.emission.SignalSink` with a
    scripted per-ATTEMPT fault plan — the delivery plane's chaos seam.
    Plan entries: ``"ok"`` records the payload in ``delivered``;
    ``"5xx"``/``"timeout"``/anything else raises (exhausted → ok).
    ``latency_s`` stalls every attempt first, so a drill can prove the
    tick thread never waits on the sink."""

    def __init__(
        self, inner: Any, plan: list[str] | tuple = (), latency_s: float = 0.0
    ) -> None:
        self.inner = inner
        self.name = inner.name
        self.policy = inner.policy
        self.plan = list(plan)
        self.latency_s = float(latency_s)
        self.failures = 0
        self.delivered: list[Any] = []

    def encode(self, signal):
        return self.inner.encode(signal)

    def to_wal(self, payload):
        return self.inner.to_wal(payload)

    def from_wal(self, data):
        return self.inner.from_wal(data)

    async def deliver(self, payload) -> None:
        if self.latency_s:
            await asyncio.sleep(self.latency_s)
        mode = self.plan.pop(0) if self.plan else "ok"
        if mode != "ok":
            self.failures += 1
            raise ConnectionError(f"scripted sink fault: {mode}")
        self.delivered.append(payload)


def _autotrade_key(payload) -> tuple:
    """Content identity of a delivered autotrade payload — stable across
    independent drives (trace ids differ per process; price/direction/
    symbol/strategy pin the producing bar on a deterministic stream)."""
    return (
        str(payload.algorithm_name),
        str(payload.symbol),
        str(payload.direction),
        round(float(payload.current_price), 8),
    )


def _burst_signal(i: int):
    """A synthetic FiredSignal for the queue-saturation burst."""
    from binquant_tpu_torch.io.emission import FiredSignal
    from binquant_tpu_torch.schemas import SignalsConsumer

    value = SignalsConsumer(
        autotrade=False,
        current_price=1.0 + i,
        direction="LONG",
        algorithm_name="burst",
        symbol=f"BURST{i:03d}USDT",
    )
    return FiredSignal(
        "burst", value.symbol, i, value, f"burst {i}", {"symbol": value.symbol}
    )


def delivery_chaos_drill(workdir: str | None = None, device: str = "cuda") -> dict:
    """The delivery plane's drill: a scripted autotrade 5xx/timeout
    storm, scripted breaker open→half_open→open→half_open→closed cycle,
    an analytics queue-saturation burst, and a process kill mid-storm
    (workers cancelled hard, WAL left unacked and uncompacted) followed
    by a checkpoint restore — asserting

    * ZERO autotrade-signal loss and ZERO duplicates past the delivery
      dedupe key: victim+resumed delivered set == the uninterrupted
      oracle's, each key exactly once;
    * the WAL replay actually carried entries across the kill;
    * the breaker walked the scripted transition sequence;
    * lossy queue saturation shed with reason=queue_full (counted, not
      silent);
    * finalize's ``emit`` host-phase dwell stayed bounded while the sink
      burned orders of magnitude more wall time (the tick thread never
      blocks on a sink);
    * the unified SLO plane judged the storm: the
      delivery.autotrade SLO emitted ``slo_burn`` during the 5xx storm
      and ``slo_recover`` after the post-restore clean soak, the
      mid-storm ``slo_verdict()`` read NOT-ok while the breaker was open
      (no false green), the post-recovery verdict read ok, and the
      close→ack lag histograms populated for every sink.
    """
    import tempfile
    from pathlib import Path

    from binquant_tpu_torch.io.checkpoint import load_state, save_state
    from binquant_tpu_torch.io.replay import tick_seq
    from binquant_tpu_torch.sim.runner import corpus_engine
    from binquant_tpu_torch.obs.events import get_event_log
    from binquant_tpu_torch.obs.slo import slo_verdict
    from binquant_tpu_torch.sim.scenarios import (
        Scenario,
        ScenarioSpec,
        _bleed_then_hammer,
        base_market,
        emit_stream,
        write_scenario_file,
    )

    workdir = Path(workdir or tempfile.mkdtemp(prefix="bqt_delivery_"))
    workdir.mkdir(parents=True, exist_ok=True)
    # the drill's own two-pulse stream (not a registered corpus family):
    # THREE capitulation hammers before the kill point — the first walks
    # the scripted breaker cycle to a delivery, the other two sit unacked
    # in the WAL when the kill lands — and two more after it
    spec = ScenarioSpec(
        name="delivery_storm",
        description="two signal pulses bracketing a mid-storm kill",
    )

    def _build(sp: ScenarioSpec) -> list[dict]:
        closes, vols, _rng = base_market(sp)
        shapes: dict = {}
        _bleed_then_hammer(
            closes, vols, shapes, (2, 5, 8), sp.n_ticks - 36, sp.n_ticks - 10
        )
        _bleed_then_hammer(
            closes, vols, shapes, (3, 6), sp.n_ticks - 27, sp.n_ticks - 1
        )
        return emit_stream(sp, closes, vols, shapes)

    stream = workdir / "delivery_storm.jsonl"
    write_scenario_file(Scenario(spec=spec, build=_build), stream)
    seq = tick_seq(stream)
    # split between the storm's two signal pulses (the restore-under-
    # fault geometry): signals exist on BOTH sides of the kill
    split = spec.n_ticks - 6

    knobs = dict(
        delivery_queue_max=64,
        delivery_attempt_timeout_s=2.0,
        delivery_retry_max=2,
        delivery_backoff_s=0.01,
        delivery_backoff_max_s=0.05,
        delivery_breaker_threshold=2,
        delivery_breaker_cooldown_s=0.05,
        wal_compact_every=0,  # the kill must find an uncompacted WAL
        # unified SLO plane: judge the storm live. Tiny p99
        # window so the post-restore clean soak deterministically washes
        # the storm's lags back under budget (nearest-rank p99 over 4
        # samples is the window max — one retained storm lag pins it)
        slo_enabled=True,
        delivery_health_enabled=True,
        delivery_slo_ms=25.0,
        slo_window=4,
        slo_event_every=4,
        # keep the verdict scoped to the delivery plane: a synthetic
        # replay stream must not fold ingest staleness into the
        # ok-after-recovery assertion
        ingest_stale_budget=10_000,
    )

    def build(wal: Path):
        return corpus_engine(
            capacity=spec.capacity,
            window=spec.window,
            device=device,
            incremental=True,
            scan_chunk=spec.scan_chunk,
            enabled_strategies=set(spec.enabled_strategies),
            host_phase=True,
            delivery=True,
            delivery_wal=str(wal),
            delivery_overrides=dict(knobs),
            # this drill pins the pre-fanout three-sink delivery story
            # (lane names, healthz shapes); fanout_chaos_drill owns the
            # four-lane composition
            fanout=False,
        )

    async def drive(engine, ticks) -> None:
        engine.delivery.start()
        for now_ms, klines in ticks:
            for k in klines:
                engine.ingest(k)
            await engine.process_tick(now_ms=now_ms)
        await engine.flush_pending()

    # -- the uninterrupted oracle (healthy recorder sinks) -------------------
    oracle = build(workdir / "oracle.wal.jsonl")
    at_oracle = FlakySink(oracle.delivery.lane("autotrade").sink)
    oracle.delivery.lane("autotrade").sink = at_oracle

    async def run_oracle() -> None:
        await drive(oracle, seq)
        await oracle.delivery.aclose(drain_s=10.0)

    asyncio.run(run_oracle())
    oracle_keys = {_autotrade_key(p) for p in at_oracle.delivered}

    # -- the victim: storm + breaker script + burst, then a hard kill --------
    wal_path = workdir / "victim.wal.jsonl"
    victim = build(wal_path)
    # breaker choreography (threshold 2): two failures OPEN, the first
    # half-open probe FAILS (re-open), the second probe succeeds (CLOSE);
    # then the storm resumes failing everything until the kill
    at_victim = FlakySink(
        victim.delivery.lane("autotrade").sink,
        plan=["5xx", "timeout", "5xx", "ok"] + ["5xx"] * 10_000,
        latency_s=0.002,
    )
    victim.delivery.lane("autotrade").sink = at_victim
    # analytics saturation target: a slow sink behind a 64-slot queue
    an_victim = FlakySink(
        victim.delivery.lane("analytics").sink, latency_s=0.5
    )
    victim.delivery.lane("analytics").sink = an_victim

    async def run_victim() -> dict:
        await drive(victim, seq[:split])
        # queue-saturation burst: 80 synthetic lossy records against the
        # 64-slot analytics queue while its worker crawls — the overflow
        # must shed with an explicit counter, never block or grow
        # (analytics lane only: a burst into the autotrade lane would be
        # WAL-durable by design and pollute the oracle-equality check)
        from binquant_tpu_torch.io.delivery import Envelope

        an_lane = victim.delivery.lane("analytics")
        for i in range(80):
            sig = _burst_signal(i)
            victim.delivery.enqueue(
                Envelope(
                    entry_id=f"burst/{i}",
                    sink="analytics",
                    payload=an_lane.sink.encode(sig),
                    ts_ms=0,
                )
            )
        # give the breaker script room to complete its scripted cycle,
        # and catch one slo_verdict() WHILE the breaker is open (the
        # storm keeps failing the still-unacked WAL entries, so the
        # breaker re-opens after the scripted close) — the no-false-green
        # probe
        deadline = time.monotonic() + 8.0
        breaker = victim.delivery.breaker("autotrade")
        storm_verdict: dict | None = None
        while time.monotonic() < deadline:
            if storm_verdict is None and breaker.state == "open":
                storm_verdict = slo_verdict(victim.slo)
            if len(breaker.transitions) >= 5 and storm_verdict is not None:
                break
            await asyncio.sleep(0.01)
        # HARD KILL: cancel the workers mid-flight — no drain, no ack
        # flush, no WAL compaction (what SIGKILL leaves behind). closed
        # goes up BEFORE the cancels and the join re-cancels on a short
        # timeout — an older wait_for can swallow a cancel that lands as
        # the inner attempt completes (CPython bpo-42130, same defense as
        # DeliveryPlane.aclose); a swallow-survivor then parks on
        # queue.get forever and a bare gather deadlocks the drill.
        # Neither flag nor re-cancel acks or compacts anything, so the
        # WAL state the restore finds is still exactly SIGKILL residue.
        victim.delivery.closed = True
        workers = [
            lane.worker
            for lane in victim.delivery._lanes.values()
            if lane.worker is not None
        ]
        for w in workers:
            w.cancel()
        for w in workers:
            for _ in range(25):
                done, _pending = await asyncio.wait({w}, timeout=0.2)
                if done:
                    try:
                        await w
                    except (asyncio.CancelledError, Exception):
                        pass
                    break
                w.cancel()
        victim.delivery.wal.close()
        return {
            "breaker_transitions": list(breaker.transitions),
            "storm_verdict": storm_verdict,
            "analytics_shed": dict(
                victim.delivery.lane("analytics").shed
            ),
            "emit_ms": (
                victim.host_phase.totals.get("serial", {})
                .get("emit", [0.0, 0])[0]
            ),
            "sink_wall_ms": 1000.0
            * (
                0.5 * (len(an_victim.delivered) + an_victim.failures)
                + 0.002 * (len(at_victim.delivered) + at_victim.failures)
            ),
        }

    # tap slo_burn/slo_recover off the event-log emit path (works even
    # with the process log disabled, and without redirecting it away from
    # a smoke run's BQT_EVENT_LOG file) — the same monkeypatch idiom as
    # the fanout drill's on_fired spy
    slo_events: list[dict] = []
    _evlog = get_event_log()
    _orig_emit = _evlog.emit

    def _tap_emit(event: str, **fields):
        if event in ("slo_burn", "slo_recover"):
            slo_events.append({"event": event, **fields})
        return _orig_emit(event, **fields)

    _evlog.emit = _tap_emit  # type: ignore[method-assign]
    after_verdict: dict = {}
    try:
        victim_facts = asyncio.run(run_victim())
        victim_keys = {_autotrade_key(p) for p in at_victim.delivered}
        from binquant_tpu_torch.io.delivery import DeliveryWal

        wal_probe = DeliveryWal(wal_path, fsync=False, compact_every=0)
        unacked_at_kill = len(wal_probe.unacked())
        wal_probe.close()
        ckpt = workdir / "victim.ckpt.npz"
        save_state(ckpt, victim.state, victim.registry, victim.host_carries())

        # -- restore: same WAL, healthy sink; replay then the stream tail ----
        resumed = build(wal_path)
        at_resumed = FlakySink(resumed.delivery.lane("autotrade").sink)
        resumed.delivery.lane("autotrade").sink = at_resumed
        state, carries = load_state(ckpt, resumed.state, resumed.registry)
        resumed.state = state
        resumed.restore_host_carries(carries)
        resumed.note_state_restored(
            migrated=bool(carries.get("_carry_rebuilt", False))
        )

        async def run_resumed() -> None:
            await drive(resumed, seq[split:])
            await resumed.delivery.drain(timeout_s=10.0)
            # post-storm clean soak THROUGH the collector path: replayed
            # entries report their true cross-kill lag (seconds — they
            # keep the delivery.autotrade SLO burning), so wash the tiny
            # p99 window with in-budget acks to drive the recover edge
            # deterministically (pulse 2 may deliver fewer fresh acks
            # than the window holds). Every lane is washed: an event-loop
            # stall (a first launch mid-drive) can push ANY lane's queue
            # dwell past the drill budget, and the final-verdict check
            # is about the recover edge, not residual stall lag
            for sink in ("autotrade", "telegram", "analytics"):
                for _ in range(resumed.delivery_health.window):
                    resumed.delivery_health.on_ack(sink, 1.0)
            after_verdict.update(slo_verdict(resumed.slo))
            await resumed.delivery.aclose(drain_s=10.0)

        asyncio.run(run_resumed())
    finally:
        _evlog.emit = _orig_emit  # type: ignore[method-assign]
    resumed_keys = {_autotrade_key(p) for p in at_resumed.delivered}

    delivered = [
        _autotrade_key(p)
        for p in (*at_victim.delivered, *at_resumed.delivered)
    ]
    facts = {
        "oracle_autotrade": len(oracle_keys),
        "delivered_autotrade": len(set(delivered)),
        "lost_autotrade": len(oracle_keys - set(delivered)),
        "duplicate_keys": len(delivered) - len(set(delivered)),
        "extra_keys": len(set(delivered) - oracle_keys),
        "victim_delivered": len(victim_keys),
        "resumed_delivered": len(resumed_keys),
        "unacked_at_kill": unacked_at_kill,
        "wal_replayed": resumed.delivery.wal_replayed,
        "breaker_transitions": victim_facts["breaker_transitions"],
        "analytics_shed": victim_facts["analytics_shed"],
        "emit_ms": round(victim_facts["emit_ms"], 3),
        "sink_wall_ms": round(victim_facts["sink_wall_ms"], 1),
        "slo_burns": sum(
            1 for e in slo_events if e["event"] == "slo_burn"
        ),
        "slo_recovers": sum(
            1 for e in slo_events if e["event"] == "slo_recover"
        ),
        "storm_verdict_ok": (victim_facts["storm_verdict"] or {}).get("ok"),
        "after_verdict_ok": after_verdict.get("ok"),
        "lag_sinks": sorted(
            set(victim.delivery_health.snapshot()["sinks"])
            | set(resumed.delivery_health.snapshot()["sinks"])
        ),
    }
    checks = {
        "zero_autotrade_loss": facts["lost_autotrade"] == 0
        and facts["extra_keys"] == 0
        and len(oracle_keys) > 0,
        "zero_duplicates_past_key": facts["duplicate_keys"] == 0,
        "signals_on_both_sides": len(victim_keys) > 0
        and len(resumed_keys - victim_keys) > 0,
        "kill_left_unacked_wal": unacked_at_kill > 0,
        "wal_replay_ran": facts["wal_replayed"] > 0,
        "breaker_cycle_scripted": facts["breaker_transitions"][:5]
        == ["open", "half_open", "open", "half_open", "closed"],
        "queue_saturation_shed": facts["analytics_shed"].get("queue_full", 0)
        > 0,
        # the tick thread enqueues; the sinks burn wall time elsewhere
        "emit_dwell_bounded": facts["emit_ms"]
        < max(0.1 * facts["sink_wall_ms"], 250.0),
        # unified SLO plane: the storm burned the autotrade
        # delivery SLO, the clean soak recovered it, and the burn
        # preceded the recover
        "slo_burn_then_recover": _burn_then_recover(
            slo_events, "delivery.autotrade"
        ),
        # no false green: the verdict caught mid-storm (breaker open)
        # read NOT-ok, with the breaker invariant naming the sink
        "no_false_green_breaker_open": (
            (victim_facts["storm_verdict"] or {}).get("ok") is False
            and not (victim_facts["storm_verdict"] or {})
            .get("invariants", {})
            .get("delivery_breakers_closed", {})
            .get("ok", True)
        ),
        # ...and the post-recovery verdict folds back to one green ok
        "verdict_ok_after_recovery": after_verdict.get("enabled") is True
        and after_verdict.get("ok") is True,
        # close→ack lag histograms populated for every sink in the drill
        "lag_histograms_per_sink": {
            "autotrade",
            "telegram",
            "analytics",
        }
        <= set(facts["lag_sinks"]),
    }
    facts["checks"] = checks
    facts["ok"] = all(checks.values())
    return facts


def _burn_then_recover(slo_events: list[dict], slo_name: str) -> bool:
    """True when ``slo_name`` emitted a burn AND a later recover — the
    drills' contract for the burn→recover event sequence."""
    burn_at = next(
        (
            i
            for i, e in enumerate(slo_events)
            if e["event"] == "slo_burn" and e.get("slo") == slo_name
        ),
        None,
    )
    recover_at = next(
        (
            i
            for i, e in enumerate(slo_events)
            if e["event"] == "slo_recover" and e.get("slo") == slo_name
        ),
        None,
    )
    return (
        burn_at is not None
        and recover_at is not None
        and burn_at < recover_at
    )


def fanout_chaos_drill(workdir: str | None = None, device: str = "cuda") -> dict:
    """The fan-out plane's drill: a subscriber churn storm riding the
    whole stream (adds/updates/removes between every tick, growing the
    slot planes mid-storm) while signal pulses broadcast to a healthy
    WebSocket watcher AND a stalled consumer whose 2-slot queue can never
    drain — asserting

    * device recipient sets equal the Python oracle on EVERY fired tick
      of the churn storm (the compiled planes track churn exactly);
    * the plane resynced incrementally through churn, with full
      recompiles only at first use / capacity growth;
    * zero tick-thread stall: every tick processed, the finalize emit
      dwell stays bounded while the stalled consumer wedges, and the
      healthy watcher still receives every frame addressed to it;
    * sheds are COUNTED, never silent (hub.shed == the stalled
      connection's drops, and the shed reason is slow_consumer);
    * the autotrade consumer group is unaffected: delivered set == the
      fanout-off oracle run's, zero loss, zero duplicates;
    * a reconnect presenting a cursor replays the stalled consumer's
      whole gap from the broadcast outbox;
    * the unified SLO plane judged the wedge: the hub's
      cursor-lag watermark caught the sloth's backlog, a slow-ack probe
      through the delivery-health collector burned the delivery.fanout
      SLO (verdict NOT-ok while burning — no false green), the
      post-replay clean soak recovered it, and the final verdict folded
      back to one green ok with the recipient-set invariant passing.
    """
    import tempfile
    from pathlib import Path

    from binquant_tpu_torch.fanout.hub import _Connection, ws_read_frame
    from binquant_tpu_torch.fanout.registry import Subscription
    from binquant_tpu_torch.io.replay import tick_seq
    from binquant_tpu_torch.sim.runner import corpus_engine
    from binquant_tpu_torch.obs.events import get_event_log
    from binquant_tpu_torch.obs.slo import slo_verdict
    from binquant_tpu_torch.sim.scenarios import (
        Scenario,
        ScenarioSpec,
        _bleed_then_hammer,
        base_market,
        emit_stream,
        symbol_names,
        write_scenario_file,
    )

    workdir = Path(workdir or tempfile.mkdtemp(prefix="bqt_fanout_"))
    workdir.mkdir(parents=True, exist_ok=True)
    spec = ScenarioSpec(
        name="fanout_storm",
        description="three hammer pulses under a subscription churn storm",
    )

    def _build(sp: ScenarioSpec) -> list[dict]:
        closes, vols, _rng = base_market(sp)
        shapes: dict = {}
        # three pulses, all past MIN_BARS(=100) where strategies arm:
        # t-10 / t-4 / t-1, so the t-7 flash mob's plane growth lands
        # BETWEEN live matches and the t-4 -> t-1 gap is churn-only (the
        # incremental column-scatter resync the drill must exercise)
        _bleed_then_hammer(
            closes, vols, shapes, (2, 5, 8), sp.n_ticks - 40, sp.n_ticks - 10
        )
        _bleed_then_hammer(
            closes, vols, shapes, (3, 6), sp.n_ticks - 31, sp.n_ticks - 4
        )
        _bleed_then_hammer(
            closes, vols, shapes, (4, 7), sp.n_ticks - 24, sp.n_ticks - 1
        )
        return emit_stream(sp, closes, vols, shapes)

    stream = workdir / "fanout_storm.jsonl"
    write_scenario_file(Scenario(spec=spec, build=_build), stream)
    seq = tick_seq(stream)
    symbols = symbol_names(spec.n_symbols)

    def build(fanout: bool, wal: Path):
        return corpus_engine(
            capacity=spec.capacity,
            window=spec.window,
            device=device,
            incremental=True,
            scan_chunk=spec.scan_chunk,
            enabled_strategies=set(spec.enabled_strategies),
            host_phase=True,
            delivery=True,
            delivery_wal=str(wal),
            delivery_overrides={
                "delivery_backoff_s": 0.005,
                # unified SLO plane: same drill-scale knobs
                # as delivery_chaos_drill (tiny p99 window so the clean
                # soak deterministically recovers the burned SLO)
                "slo_enabled": True,
                "delivery_health_enabled": True,
                "delivery_slo_ms": 25.0,
                "slo_window": 4,
                "slo_event_every": 4,
                "ingest_stale_budget": 10_000,
            },
            fanout=fanout,
            fanout_overrides=(
                # small slot capacity so the churn storm forces plane
                # growth (the match kernel's one legitimate retrace);
                # roomy outbox so the stalled user's whole gap replays;
                # a small tail ring so the reconnect storm exercises BOTH
                # resume sources (in-window cursors from memory, stale /
                # trace cursors falling back to the outbox scan);
                # compaction pinned off — the dedicated compaction tests
                # own that seam, and a mid-storm slot re-pack would
                # invalidate the storm's replay oracle
                {
                    "fanout_capacity": 64,
                    "fanout_outbox_cap": 4096,
                    "fanout_resume_tail": 64,
                    "fanout_compact_frac": 0.0,
                }
                if fanout
                else {}
            ),
        )

    async def drive(engine, churn=None) -> list:
        engine.delivery.start()
        ticks = []
        for i, (now_ms, klines) in enumerate(seq):
            if churn is not None:
                churn(i)
            for k in klines:
                engine.ingest(k)
            t0 = time.perf_counter()
            await engine.process_tick(now_ms=now_ms)
            ticks.append((time.perf_counter() - t0) * 1000)
        await engine.flush_pending()
        return ticks

    # -- the fanout-off oracle: what autotrade must deliver regardless ------
    oracle = build(False, workdir / "oracle.wal.jsonl")
    at_oracle = FlakySink(oracle.delivery.lane("autotrade").sink)
    oracle.delivery.lane("autotrade").sink = at_oracle

    async def run_oracle() -> None:
        await drive(oracle)
        await oracle.delivery.aclose(drain_s=10.0)

    asyncio.run(run_oracle())
    oracle_keys = {_autotrade_key(p) for p in at_oracle.delivered}

    # -- the subject: churn storm + stalled consumer + healthy watcher ------
    subject = build(True, workdir / "subject.wal.jsonl")
    at_subject = FlakySink(subject.delivery.lane("autotrade").sink)
    subject.delivery.lane("autotrade").sink = at_subject
    plane = subject.fanout
    rng = np.random.default_rng(spec.seed)
    strategies = list(spec.enabled_strategies)

    # standing population: the watcher and the sloth subscribe to all,
    # plus the reconnect-storm cohort — subscribed up front so
    # every published frame addresses them and their post-drive cursor
    # replays have a full gap to prove against
    plane.subscribe(Subscription("watcher"))
    plane.subscribe(Subscription("sloth"))
    storm_cohort = [f"storm{i}" for i in range(6)]
    for uid in storm_cohort:
        plane.subscribe(Subscription(uid))
    churn_pool: list[str] = []
    churn_ops = {"subscribe": 0, "update": 0, "unsubscribe": 0}
    next_id = 0

    def _random_sub(uid: str) -> Subscription:
        return Subscription(
            uid,
            symbols=(
                None
                if rng.random() < 0.5
                else frozenset(
                    str(s)
                    for s in rng.choice(
                        symbols, size=int(rng.integers(1, 4)), replace=False
                    )
                )
            ),
            strategies=(
                None
                if rng.random() < 0.5
                else frozenset(
                    str(s)
                    for s in rng.choice(
                        strategies,
                        size=int(rng.integers(1, 3)),
                        replace=False,
                    )
                )
            ),
            min_strength=float(np.float32(rng.random() * 0.5)),
        )

    def churn(tick: int) -> None:
        nonlocal next_id
        # a flash mob BETWEEN the signal pulses: 300 signups in one tick
        # force a slot-capacity growth bracketed by two live matches, so
        # the storm exercises the grow -> full-device-resync path (the
        # match kernel's one legitimate retrace) mid-stream
        adds = 6 + (300 if tick == spec.n_ticks - 7 else 0)
        for _ in range(adds):
            uid = f"churn{next_id:05d}"
            next_id += 1
            plane.subscribe(_random_sub(uid))
            churn_pool.append(uid)
            churn_ops["subscribe"] += 1
        for _ in range(2):
            if churn_pool:
                plane.update(_random_sub(str(rng.choice(churn_pool))))
                churn_ops["update"] += 1
        for _ in range(2):
            if churn_pool:
                uid = str(rng.choice(churn_pool))
                churn_pool.remove(uid)
                plane.unsubscribe(uid)
                churn_ops["unsubscribe"] += 1

    # per-fired-tick oracle equality spy over the churning population
    mismatches: list = []
    matched_ticks = {"n": 0}
    orig_on_fired = plane.on_fired

    def spy(fired, ctx_scalars, tick_ms=None):
        from binquant_tpu_torch.enums import MarketRegimeCode
        from binquant_tpu_torch.fanout.kernel import unpack_words_np

        stats = orig_on_fired(fired, ctx_scalars, tick_ms=tick_ms)
        regime = int(ctx_scalars.get("market_regime", -1))
        valid = bool(ctx_scalars.get("valid", False))
        want = plane.subscriptions.match_oracle(
            [
                (s.strategy, s.symbol, float(s.value.score or 0.0))
                for s in fired
            ],
            regime if valid and 0 <= regime < len(MarketRegimeCode) else None,
        )
        matched_ticks["n"] += 1
        for s, w in zip(fired, want):
            _frame, words, _t = s.fanout_frame
            got = set(
                plane.subscriptions.users_of_slots(
                    np.flatnonzero(unpack_words_np(words))
                )
            )
            if got != w:
                mismatches.append((tick_ms, s.strategy, s.symbol))
        return stats

    plane.on_fired = spy

    watcher_frames: list[dict] = []
    facts: dict = {}

    async def run_subject() -> None:
        port = await plane.serve(0, host="127.0.0.1")
        # healthy watcher over a real WS socket
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        writer.write(
            b"GET /ws?user=watcher HTTP/1.1\r\nHost: x\r\n"
            b"Upgrade: websocket\r\nConnection: Upgrade\r\n"
            b"Sec-WebSocket-Key: dGhlIHNhbXBsZQ==\r\n\r\n"
        )
        await writer.drain()
        await reader.readline()
        while (await reader.readline()) not in (b"\r\n", b""):
            pass

        async def watch() -> None:
            try:
                while True:
                    opcode, payload = await ws_read_frame(reader)
                    if opcode == 0x1:
                        watcher_frames.append(json.loads(payload))
            except (ConnectionError, asyncio.CancelledError):
                pass

        watch_task = asyncio.ensure_future(watch())
        # the stalled consumer: a registered connection whose writer task
        # never drains its 2-slot queue (the bounded-queue chaos seam — a
        # live socket's kernel buffer would mask the wedge)
        sloth = _Connection(
            "sloth", plane.subscriptions.slot_of("sloth"), "ws", queue_max=2
        )
        plane.hub._conns.add(sloth)

        tick_ms_list = await drive(subject, churn=churn)
        facts["drained"] = await subject.delivery.drain(timeout_s=15.0)
        # let the watcher catch the tail
        deadline = time.monotonic() + 5.0
        while (
            time.monotonic() < deadline
            and len(watcher_frames) < plane.published
        ):
            await asyncio.sleep(0.02)
        # the cursor-lag watermark must catch the wedge WHILE the sloth
        # is still registered: its never-drained 2-slot queue is the
        # hub's laggiest consumer
        facts["wedged_cursor_lag"] = plane.hub.cursor_lag()
        # wedge-period SLO probe through the delivery-health collector:
        # four over-budget fanout acks burn the delivery.fanout SLO, and
        # the verdict must read NOT-ok while it burns (no false green)
        for _ in range(subject.delivery_health.window):
            subject.delivery_health.on_ack("fanout", 500.0)
        facts["wedged_verdict_ok"] = slo_verdict(subject.slo).get("ok")
        plane.hub._conns.discard(sloth)

        # reconnect-with-cursor: the sloth's gap replays from the outbox
        r2, w2 = await asyncio.open_connection("127.0.0.1", port)
        w2.write(
            b"GET /ws?user=sloth&cursor=-1 HTTP/1.1\r\nHost: x\r\n"
            b"Upgrade: websocket\r\nConnection: Upgrade\r\n"
            b"Sec-WebSocket-Key: dGhlIHNhbXBsZQ==\r\n\r\n"
        )
        await w2.drain()
        await r2.readline()
        while (await r2.readline()) not in (b"\r\n", b""):
            pass
        sloth_slot = plane.subscriptions.slot_of("sloth")
        addressed = [
            f["seq"]
            for f, words in plane.outbox.entries()
            if (
                sloth_slot >> 5 < len(words)
                and (int(words[sloth_slot >> 5]) >> (sloth_slot & 31)) & 1
            )
        ]
        replayed = []
        try:
            while len(replayed) < len(addressed):
                opcode, payload = await asyncio.wait_for(
                    ws_read_frame(r2), timeout=5.0
                )
                if opcode == 0x1:
                    replayed.append(json.loads(payload)["seq"])
        except (TimeoutError, asyncio.TimeoutError):
            pass
        writer.close()
        w2.close()
        watch_task.cancel()

        # -- churn × reconnect storm: the cohort reconnects
        # with fresh cursors WHILE a 100-op subscription churn burst
        # races the handshakes on the same loop. Replay must stay
        # bit-exact per user whichever source serves it — the in-memory
        # tail ring for in-window cursors, the outbox scan for stale and
        # trace-id cursors (fallbacks counted by reason, never silent).
        entries_pre = plane.outbox.entries()
        head = plane.seq - 1

        def _addressed_after(user: str, after_seq: int) -> list[int]:
            s = plane.subscriptions.slot_of(user)
            return [
                int(f["seq"])
                for f, words in entries_pre
                if int(f["seq"]) > after_seq
                and s >> 5 < len(words)
                and (int(words[s >> 5]) >> (s & 31)) & 1
            ]

        # cursor mix: in-window numerics (tail ring), a stale numeric
        # (outbox path when the ring has evicted past it), and one
        # trace-id cursor (always an outbox resolution → counted fallback)
        tr_frame = entries_pre[-1][0]
        trace_cursor = f"{tr_frame['trace_id']}/{tr_frame['tick_seq']}"
        trace_resolved = max(
            int(f["seq"])
            for f, _ in entries_pre
            if f.get("trace_id") == tr_frame["trace_id"]
            and f.get("tick_seq") == tr_frame["tick_seq"]
        )
        cursor_of = {
            "storm0": str(max(head - 3, -1)),
            "storm1": str(max(head - 5, -1)),
            "storm2": str(max(head - 2, -1)),
            "storm3": "0",
            "storm4": "-1",
            "storm5": trace_cursor,
        }
        expected_of = {
            u: _addressed_after(
                u,
                trace_resolved if u == "storm5" else int(cursor_of[u]),
            )
            for u in storm_cohort
        }

        def _storm_burst(n: int) -> None:
            nonlocal next_id
            for _ in range(n):
                r = rng.random()
                if r < 0.4 or not churn_pool:
                    uid = f"burst{next_id:05d}"
                    next_id += 1
                    plane.subscribe(_random_sub(uid))
                    churn_pool.append(uid)
                elif r < 0.7:
                    plane.update(_random_sub(str(rng.choice(churn_pool))))
                else:
                    uid = str(rng.choice(churn_pool))
                    churn_pool.remove(uid)
                    plane.unsubscribe(uid)
                facts["storm_churn_ops"] = (
                    facts.get("storm_churn_ops", 0) + 1
                )

        async def _storm_reconnect(user: str) -> tuple[str, list[int]]:
            r, w = await asyncio.open_connection("127.0.0.1", port)
            w.write(
                (
                    f"GET /ws?user={user}&cursor={cursor_of[user]} "
                    "HTTP/1.1\r\nHost: x\r\n"
                    "Upgrade: websocket\r\nConnection: Upgrade\r\n"
                    "Sec-WebSocket-Key: dGhlIHNhbXBsZQ==\r\n\r\n"
                ).encode()
            )
            await w.drain()
            await r.readline()
            while (await r.readline()) not in (b"\r\n", b""):
                pass
            got: list[int] = []
            try:
                while len(got) < len(expected_of[user]):
                    opcode, payload = await asyncio.wait_for(
                        ws_read_frame(r), timeout=5.0
                    )
                    if opcode == 0x1:
                        got.append(json.loads(payload)["seq"])
            except (TimeoutError, asyncio.TimeoutError):
                pass
            w.close()
            return user, got

        storm_tasks = [
            asyncio.ensure_future(_storm_reconnect(u)) for u in storm_cohort
        ]
        # interleave the churn burst with the in-flight handshakes: every
        # yield lets accept/upgrade/replay steps run between ops
        for _ in range(10):
            _storm_burst(10)
            await asyncio.sleep(0)
        storm_got = dict(await asyncio.gather(*storm_tasks))
        facts["storm_replays"] = {
            u: {"got": len(storm_got[u]), "want": len(expected_of[u])}
            for u in storm_cohort
        }
        facts["storm_replay_exact"] = all(
            storm_got[u] == expected_of[u] for u in storm_cohort
        )
        facts["storm_expected_total"] = sum(
            len(v) for v in expected_of.values()
        )
        facts["tail_resumes"] = plane.hub.tail_resumes
        facts["resume_fallbacks"] = dict(plane.hub.resume_fallbacks)

        # post-replay clean soak: in-budget acks wash the tiny p99
        # window and fire the recover edge; the final verdict must fold
        # back to green with the recipient-set invariant passing. Every
        # lane is washed — an event-loop stall (the flash mob's plane
        # recompile) can push any lane's queue dwell past the drill
        # budget, and this check is about the recover edge
        for sink in ("autotrade", "telegram", "analytics", "fanout"):
            for _ in range(subject.delivery_health.window):
                subject.delivery_health.on_ack(sink, 1.0)
        facts["final_verdict"] = slo_verdict(subject.slo)
        await subject.delivery.aclose(drain_s=5.0)
        await subject.aclose_fanout()
        facts["tick_p99_ms"] = float(np.percentile(tick_ms_list, 99))
        facts["sloth_addressed"] = len(addressed)
        facts["sloth_replayed"] = len(replayed)
        facts["sloth_gap_replayed"] = replayed == addressed
        facts["sloth_dropped"] = sloth.dropped
        facts["sloth_gapped"] = sloth.gapped

    # tap slo_burn/slo_recover off the emit path (same idiom as the
    # delivery drill — works with the process event log disabled)
    slo_events: list[dict] = []
    _evlog = get_event_log()
    _orig_emit = _evlog.emit

    def _tap_emit(event: str, **fields):
        if event in ("slo_burn", "slo_recover"):
            slo_events.append({"event": event, **fields})
        return _orig_emit(event, **fields)

    _evlog.emit = _tap_emit  # type: ignore[method-assign]
    try:
        asyncio.run(run_subject())
    finally:
        _evlog.emit = _orig_emit  # type: ignore[method-assign]
    subject_keys = {_autotrade_key(p) for p in at_subject.delivered}
    delivered = [_autotrade_key(p) for p in at_subject.delivered]
    watcher_seqs = sorted(f["seq"] for f in watcher_frames)
    emit_ms = (
        subject.host_phase.totals.get("serial", {}).get("emit", [0.0, 0])[0]
    )
    facts.update(
        {
            "ticks": subject.ticks_processed,
            "published": plane.published,
            "matched_ticks": matched_ticks["n"],
            "oracle_mismatches": mismatches[:5],
            "churn_ops": dict(churn_ops),
            "subscriptions_live": len(plane.subscriptions),
            "slot_capacity": plane.subscriptions.capacity,
            "recompiles": dict(plane.recompiles),
            "hub_shed": plane.hub.shed,
            "watcher_frames": len(watcher_frames),
            "oracle_autotrade": len(oracle_keys),
            "delivered_autotrade": len(subject_keys),
            "duplicate_keys": len(delivered) - len(subject_keys),
            "emit_ms": round(emit_ms, 3),
        }
    )
    checks = {
        "delivery_drained": bool(facts.get("drained")),
        # churn storm correctness: the compiled planes tracked every op
        "oracle_equal_through_churn": not mismatches
        and matched_ticks["n"] >= 2,
        "churn_storm_ran": churn_ops["subscribe"] > 300
        and churn_ops["unsubscribe"] > 50,
        "plane_grew_mid_storm": plane.subscriptions.capacity > 64
        and plane.recompiles.get("full", 0) >= 2,
        "incremental_resyncs": plane.recompiles.get("incremental", 0) > 0,
        # zero tick-thread stall: every tick processed while the sloth
        # wedged, and finalize's emit dwell stayed an enqueue
        "all_ticks_processed": subject.ticks_processed == len(seq),
        "emit_dwell_bounded": emit_ms < 250.0,
        # sheds counted, never silent
        "sheds_counted": facts["sloth_dropped"] > 0
        and plane.hub.shed == facts["sloth_dropped"],
        # the healthy consumer missed nothing
        "watcher_complete": watcher_seqs == list(range(plane.published))
        and plane.published > 0,
        # the trade path is a different consumer group entirely
        "autotrade_unaffected": subject_keys == oracle_keys
        and len(oracle_keys) > 0
        and facts["duplicate_keys"] == 0,
        # reconnect-with-cursor replays the whole gap from the outbox
        "cursor_replayed_gap": facts["sloth_gap_replayed"]
        and facts["sloth_addressed"] > 0,
        # churn × reconnect storm: every cohort reconnect
        # replayed its exact gap while 100 churn ops raced the handshakes
        "storm_replay_exact": bool(facts.get("storm_replay_exact"))
        and facts.get("storm_expected_total", 0) > 0
        and facts.get("storm_churn_ops", 0) >= 100,
        # in-window cursors resumed from the tail ring (no outbox scan)...
        "storm_tail_resume_engaged": facts.get("tail_resumes", 0) > 0,
        # ...and the cursors the ring can't serve fell back with a
        # counted reason (the trace cursor always needs the log)
        "storm_fallback_counted": (
            facts.get("resume_fallbacks", {}).get("trace_cursor", 0) >= 1
        ),
        # unified SLO plane: the hub's cursor-lag watermark
        # caught the sloth's wedged backlog (its 2-slot queue full)
        "cursor_lag_caught_wedge": facts.get("wedged_cursor_lag", 0) >= 2,
        # the wedge-period probe burned delivery.fanout and the
        # post-replay soak recovered it, in that order
        "slo_burn_then_recover": _burn_then_recover(
            slo_events, "delivery.fanout"
        ),
        # no false green while the SLO burned...
        "no_false_green_while_burning": facts.get("wedged_verdict_ok")
        is False,
        # ...and the final verdict folds back to one green ok with the
        # recipient-set invariant passing
        "verdict_ok_after_recovery": (
            (facts.get("final_verdict") or {}).get("ok") is True
            and (facts.get("final_verdict") or {})
            .get("invariants", {})
            .get("fanout_recipient_set", {})
            .get("ok")
            is True
        ),
    }
    facts["checks"] = checks
    facts["ok"] = all(checks.values())
    return facts
