"""Durable signal delivery plane: a crash-safe at-least-once outbox.

The port's own copy of ``binquant_tpu/io/delivery.py``. Finalize
*enqueues* each fired signal and returns; per-sink async workers own the
sink round trips, and the autotrade class survives a process kill.

Three cooperating pieces:

* :class:`DeliveryWal` — an append-only JSONL write-ahead log keyed by
  ``(entry id, sink)``: a ``put`` record is written (flushed and fsynced)
  BEFORE the in-memory enqueue, an ``ack`` record after the sink
  confirmed, and compaction rewrites the file keeping only unacked puts
  (atomic tmp-file + ``os.replace``). On restart :meth:`DeliveryWal.unacked`
  is exactly the set of signals the previous process accepted but never
  delivered; the plane replays them. The entry id is stamped into the
  payload's ``metadata["delivery_id"]`` before the WAL put, so it travels
  with every redelivery and downstream consumers dedupe on it. A torn
  trailing line (a kill mid-write) is skipped.

* :class:`CircuitBreaker` — per sink: ``closed`` → ``open`` after
  ``threshold`` consecutive failures (every transition is a
  ``delivery_breaker`` event + ``bqt_delivery_breaker_transitions_total``),
  ``open`` → ``half_open`` after the cooldown (ONE probe attempt),
  ``half_open`` → ``closed`` on probe success / back to ``open`` on
  failure. While open, lossy sinks shed immediately and at-least-once
  entries wait (they are already WAL-durable).

* :class:`DeliveryPlane` — per-sink bounded queues + one worker each.
  Per-sink-class policy (``SignalSink.policy``, ``io/emission.py``):

  - ``at_least_once`` (autotrade): never dropped. WAL-put before enqueue;
    unbounded retries with exponential backoff + jitter behind the
    breaker; a full queue defers the entry to the WAL (the worker sweeps
    unacked entries back in whenever its queue runs dry).
  - ``lossy`` (telegram, analytics): bounded effort. A full queue, an open
    breaker, or ``retry_max`` exhausted attempts shed the entry with an
    explicit reason (``bqt_delivery_shed_total{sink,reason}``).

Entry ids: a signal of a traced tick carries ``trace_id``/``tick_seq`` and
its id is ``{trace_id}/{tick_seq}/{strategy}/{symbol}``; a tick sampled
out of tracing gives the ``t{tick_ms}/0/{strategy}/{symbol}`` form. The
engine hands the plane its live ``freshness`` (``obs/latency.py``: every
ack observes ``bqt_sink_delivery_ms``) and ``health``
(``obs/delivery_health.py``: close→final-ack lag per sink, the delivery
SLO, and one ``sink_span`` event per attempt of a traced entry). The WAL
put carries the entry's ``lag0`` (candle close → dispatch, ms) and
``trace``; a replayed entry restores them and leaves ``dispatched_at``
None, so its lag is measured from the put's wall clock.
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
import random
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any

from binquant_tpu_torch.io.binbot import reconnect_delay
from binquant_tpu_torch.obs.events import get_event_log
from binquant_tpu_torch.obs.instruments import (
    DELIVERY_ACKED,
    DELIVERY_BREAKER,
    DELIVERY_BREAKER_STATE,
    DELIVERY_CURSOR_LAG,
    DELIVERY_ENQUEUED,
    DELIVERY_OLDEST_AGE,
    DELIVERY_QUEUE,
    DELIVERY_RETRIES,
    DELIVERY_SHED,
    DELIVERY_WAL_REPLAYED,
    DELIVERY_WAL_UNACKED,
    SINK_DELIVERY,
)

log = logging.getLogger(__name__)

AT_LEAST_ONCE = "at_least_once"
LOSSY = "lossy"


def entry_id_of(
    trace_id: str | None,
    tick_seq: int | None,
    strategy: str,
    symbol: str,
    tick_ms: int | None = None,
) -> str:
    """The delivery-dedupe identity of one fired signal: the
    trace_id/tick_seq provenance stamps plus the (strategy, symbol) pair
    (one traced tick can fire many pairs). When tracing is sampled off
    the tick's evaluated wall-clock stands in for the trace id — still
    unique per (tick, strategy, symbol), which is all the dedupe needs."""
    tid = trace_id if trace_id else f"t{int(tick_ms or 0)}"
    seq = int(tick_seq) if tick_seq is not None else 0
    return f"{tid}/{seq}/{strategy}/{symbol}"


# -- write-ahead log ----------------------------------------------------------


class DeliveryWal:
    """Append-only JSONL outbox for the at-least-once sink class.

    Records: ``{"op": "put", "id": ..., "sink": ..., "ts_ms": ...,
    "payload": ...}`` and ``{"op": "ack", "id": ..., "sink": ...}``.
    Writes are flushed + fsynced per record: the whole point is surviving
    a kill between sink call and ack, so an accepted signal is on disk
    before the tick goes on. A torn trailing line (killed mid-write) is
    skipped by the reader, never fatal.
    """

    def __init__(
        self, path: str | Path, fsync: bool = True, compact_every: int = 256
    ) -> None:
        self.path = Path(path)
        self.fsync = bool(fsync)
        self.compact_every = max(int(compact_every), 0)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        # live unacked view, seeded from whatever the previous process
        # left behind — ``puts - acks`` process counters can't express a
        # boot backlog (replayed acks have no in-process puts)
        puts, acked = self._scan()
        self._unacked_keys: set[tuple[str, str]] = {
            key for key in puts if key not in acked
        }
        # per-unacked-key put wall clock (epoch ms) for the oldest-record
        # -age watermark; pre-observatory records without a `wall` field
        # fall back to boot time — a conservative LOWER bound on age
        boot_wall_ms = time.time() * 1000.0
        self._put_wall_ms: dict[tuple[str, str], float] = {
            key: float(puts[key].get("wall") or boot_wall_ms)
            for key in self._unacked_keys
        }
        self._f = open(self.path, "a", encoding="utf-8")
        self._terminate_torn_tail()
        self._acks_since_compact = 0
        self.puts = 0
        self.acks = 0
        self.compactions = 0
        # acks for keys not currently unacked — the zero-duplicate
        # invariant's meter (a worker acking the same entry twice)
        self.dup_acks = 0

    def _terminate_torn_tail(self) -> None:
        """End a torn trailing line (a kill mid-write) before appending: the
        reader skips it either way, but the next record appended to it
        would be skipped with it. (The reference appends to the torn line,
        so its first record after such a kill is lost.)"""
        if self.path.stat().st_size == 0:
            return
        with open(self.path, "rb") as f:
            f.seek(-1, os.SEEK_END)
            torn = f.read(1) != b"\n"
        if torn:
            self._f.write("\n")
            self._f.flush()

    def _append(self, record: dict) -> None:
        self._f.write(json.dumps(record, separators=(",", ":")) + "\n")
        self._f.flush()
        if self.fsync:
            try:
                os.fsync(self._f.fileno())
            except OSError:  # pragma: no cover - exotic filesystems
                pass

    def append_put(
        self,
        entry_id: str,
        sink: str,
        payload: Any,
        ts_ms: int | None = None,
        lag0_ms: float | None = None,
        trace_id: str | None = None,
    ) -> None:
        """``lag0_ms``/``trace_id`` are provenance stamps riding the put
        record (additive fields: a WAL without them replays fine): the candle-close lag at enqueue and the
        originating tick's trace id, plus the put's own wall clock so a
        replayed ack can report the true cross-process close→ack lag."""
        self.puts += 1
        key = (entry_id, sink)
        self._unacked_keys.add(key)
        wall = time.time() * 1000.0
        self._put_wall_ms[key] = wall
        record = {
            "op": "put",
            "id": entry_id,
            "sink": sink,
            "ts_ms": ts_ms,
            "payload": payload,
            "wall": round(wall, 3),
        }
        if lag0_ms is not None:
            record["lag0"] = round(float(lag0_ms), 3)
        if trace_id is not None:
            record["trace"] = trace_id
        self._append(record)

    def append_ack(self, entry_id: str, sink: str) -> None:
        self.acks += 1
        key = (entry_id, sink)
        if key not in self._unacked_keys:
            self.dup_acks += 1
        self._unacked_keys.discard(key)
        self._put_wall_ms.pop(key, None)
        self._append({"op": "ack", "id": entry_id, "sink": sink})
        self._acks_since_compact += 1
        if self.compact_every and self._acks_since_compact >= self.compact_every:
            self.compact()

    def oldest_put_wall_ms(self, sink: str) -> float | None:
        """Put wall clock of the sink's oldest unacked record (the
        oldest-record-age watermark's anchor); None when fully acked."""
        walls = [
            wall
            for (_, s), wall in self._put_wall_ms.items()
            if s == sink
        ]
        return min(walls) if walls else None

    def unacked_count(self, sink: str | None = None) -> int:
        """Live unacked-entry count (boot backlog included) — what the
        ``bqt_delivery_wal_unacked`` gauge and /healthz report; sustained
        growth means the sink is down."""
        if sink is None:
            return len(self._unacked_keys)
        return sum(1 for _, s in self._unacked_keys if s == sink)

    def _scan(self) -> tuple[dict[tuple[str, str], dict], set[tuple[str, str]]]:
        """(puts by (id, sink) in file order, acked (id, sink) keys)."""
        puts: dict[tuple[str, str], dict] = {}
        acked: set[tuple[str, str]] = set()
        if not self.path.exists():
            return puts, acked
        with open(self.path, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue  # torn trailing line from a mid-write kill
                key = (str(rec.get("id")), str(rec.get("sink")))
                if rec.get("op") == "put":
                    puts[key] = rec
                elif rec.get("op") == "ack":
                    acked.add(key)
        return puts, acked

    def unacked(self) -> list[dict]:
        """Every put without a matching ack, in append order."""
        puts, acked = self._scan()
        return [rec for key, rec in puts.items() if key not in acked]

    def compact(self) -> int:
        """Rewrite the file keeping only unacked puts (atomic replace);
        returns the surviving entry count."""
        pending = self.unacked()
        tmp = self.path.with_suffix(self.path.suffix + ".tmp")
        with open(tmp, "w", encoding="utf-8") as f:
            for rec in pending:
                f.write(json.dumps(rec, separators=(",", ":")) + "\n")
            f.flush()
            try:
                os.fsync(f.fileno())
            except OSError:  # pragma: no cover
                pass
        self._f.close()
        os.replace(tmp, self.path)
        self._f = open(self.path, "a", encoding="utf-8")
        self._terminate_torn_tail()
        self._acks_since_compact = 0
        self.compactions += 1
        return len(pending)

    def close(self) -> None:
        try:
            self._f.close()
        except Exception:  # pragma: no cover
            pass


# -- circuit breaker ----------------------------------------------------------


class CircuitBreaker:
    """closed → open (threshold consecutive failures) → half_open (one
    probe after the cooldown) → closed on probe success / open on probe
    failure. Transitions land in the event log + metric family, and in
    ``self.transitions`` for scripted-drill assertions."""

    def __init__(
        self,
        sink: str,
        threshold: int = 5,
        cooldown_s: float = 30.0,
        clock=time.monotonic,
    ) -> None:
        self.sink = sink
        self.threshold = max(int(threshold), 1)
        self.cooldown_s = float(cooldown_s)
        self._clock = clock
        self.state = "closed"
        self.consecutive = 0
        self._opened_at: float | None = None
        self.transitions: list[str] = []

    #: gauge encoding for bqt_delivery_breaker_state (level companion to
    #: the transitions counter; alert on >0, not on edges)
    STATE_CODES = {"closed": 0, "half_open": 1, "open": 2}

    def _transition(self, state: str) -> None:
        if state == self.state:
            return
        self.state = state
        self.transitions.append(state)
        DELIVERY_BREAKER.labels(sink=self.sink, state=state).inc()
        DELIVERY_BREAKER_STATE.labels(sink=self.sink).set(
            self.STATE_CODES.get(state, 0)
        )
        get_event_log().emit(
            "delivery_breaker",
            sink=self.sink,
            state=state,
            consecutive_failures=self.consecutive,
        )

    def allow(self) -> bool:
        """May an attempt run now? An open breaker past its cooldown
        transitions to half_open and admits ONE probe."""
        if self.state == "closed":
            return True
        if self.state == "half_open":
            # one probe is already in flight (the caller that flipped us)
            return False
        if (
            self._opened_at is not None
            and self._clock() - self._opened_at >= self.cooldown_s
        ):
            self._transition("half_open")
            return True
        return False

    def cooldown_remaining(self) -> float:
        if self.state != "open" or self._opened_at is None:
            return 0.0
        return max(self.cooldown_s - (self._clock() - self._opened_at), 0.0)

    def record_success(self) -> None:
        self.consecutive = 0
        if self.state != "closed":
            self._transition("closed")
        self._opened_at = None

    def record_failure(self) -> None:
        self.consecutive += 1
        if self.state == "half_open" or (
            self.state == "closed" and self.consecutive >= self.threshold
        ):
            self._opened_at = self._clock()
            self._transition("open")


# -- the plane ---------------------------------------------------------------


@dataclass
class Envelope:
    """One (signal, sink) delivery unit riding a queue."""

    entry_id: str
    sink: str
    payload: Any
    ts_ms: int | None = None
    attempts: int = 0
    replayed: bool = False  # came back off the WAL (restart / deferral)
    # freshness anchors (live enqueues only): candle-close lag at dispatch
    # plus the dispatch perf_counter — the ack computes close→acked from
    # them. Replayed entries restore lag0_ms + put_wall_ms off the WAL
    # record instead (wall-clock delta since the put — the true
    # cross-process lag), leaving dispatched_at None.
    lag0_ms: float | None = None
    dispatched_at: float | None = None
    # provenance: the originating tick's trace id (sink spans +
    # WAL record) and the WAL put's wall clock (replayed-lag anchor)
    trace_id: str | None = None
    put_wall_ms: float | None = None


@dataclass
class _SinkLane:
    sink: Any  # SignalSink
    queue: asyncio.Queue
    breaker: CircuitBreaker
    worker: asyncio.Task | None = None
    inflight: int = 0
    deferred: int = 0  # at-least-once entries parked WAL-only (queue full)
    enqueued: int = 0
    acked: int = 0
    retries: int = 0
    replayed: int = 0
    shed: dict[str, int] = field(default_factory=dict)


class DeliveryPlane:
    """Per-sink outbox: finalize enqueues, workers deliver, acks close the
    loop. See the module docstring for the policy table."""

    def __init__(
        self,
        sinks: list[Any],
        wal_path: str | Path | None = None,
        queue_max: int = 512,
        attempt_timeout_s: float = 5.0,
        retry_max: int = 3,
        backoff_s: float = 0.25,
        backoff_max_s: float = 30.0,
        breaker_threshold: int = 5,
        breaker_cooldown_s: float = 30.0,
        wal_fsync: bool = True,
        wal_compact_every: int = 256,
        rng: random.Random | None = None,
        freshness: Any | None = None,
        health: Any | None = None,
    ) -> None:
        self.queue_max = max(int(queue_max), 1)
        self.attempt_timeout_s = float(attempt_timeout_s)
        self.retry_max = max(int(retry_max), 1)
        self.backoff_s = float(backoff_s)
        self.backoff_max_s = float(backoff_max_s)
        self._rng = rng or random.Random()
        self.freshness = freshness
        # the delivery-health collector (obs/delivery_health.py): the
        # ack-side close→ack lag consumer + per-attempt sink-span gate
        self.health = health
        self.wal: DeliveryWal | None = (
            DeliveryWal(
                wal_path, fsync=wal_fsync, compact_every=wal_compact_every
            )
            if wal_path
            else None
        )
        self._lanes: dict[str, _SinkLane] = {}
        for sink in sinks:
            self._lanes[sink.name] = _SinkLane(
                sink=sink,
                queue=asyncio.Queue(maxsize=self.queue_max),
                breaker=CircuitBreaker(
                    sink.name,
                    threshold=breaker_threshold,
                    cooldown_s=breaker_cooldown_s,
                ),
            )
        self.started = False
        self.closed = False
        self.wal_replayed = 0

    @classmethod
    def from_config(
        cls,
        config: Any,
        sinks: list[Any],
        freshness: Any | None = None,
        health: Any | None = None,
    ) -> "DeliveryPlane":
        """A plane over ``sinks`` with the config's delivery knobs (the
        engine's at boot, and a restarted plane's) and the engine's
        observatories."""
        return cls(
            sinks=sinks,
            wal_path=config.delivery_wal_path or None,
            queue_max=config.delivery_queue_max,
            attempt_timeout_s=config.delivery_attempt_timeout_s,
            retry_max=config.delivery_retry_max,
            backoff_s=config.delivery_backoff_s,
            backoff_max_s=config.delivery_backoff_max_s,
            breaker_threshold=config.delivery_breaker_threshold,
            breaker_cooldown_s=config.delivery_breaker_cooldown_s,
            wal_compact_every=config.wal_compact_every,
            freshness=freshness,
            health=health,
        )

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        """Start the per-sink workers (requires a running loop) and replay
        any unacked WAL entries the previous process left behind.
        Idempotent; ``enqueue_fired`` calls it lazily."""
        if self.started or self.closed:
            return
        self.started = True
        loop = asyncio.get_running_loop()
        for lane in self._lanes.values():
            lane.worker = loop.create_task(
                self._worker(lane), name=f"delivery-{lane.sink.name}"
            )
        self._replay_wal()

    @staticmethod
    def _decode_wal_record(lane: _SinkLane, rec: dict) -> Envelope | None:
        """WAL record → replay Envelope (shared by the boot replay and
        the deferred sweep); undecodable entries are logged and skipped —
        the replay semantics live in exactly one place."""
        try:
            payload = lane.sink.from_wal(rec.get("payload"))
        except Exception:
            log.exception(
                "WAL replay: undecodable %s entry %s; skipping",
                rec.get("sink"),
                rec.get("id"),
            )
            return None
        return Envelope(
            entry_id=str(rec.get("id")),
            sink=lane.sink.name,
            payload=payload,
            ts_ms=rec.get("ts_ms"),
            replayed=True,
            # anchors riding the put record: lag-at-enqueue + the put's
            # wall clock let the ack report the TRUE cross-process
            # close→ack lag; absent on records written without them
            lag0_ms=rec.get("lag0"),
            put_wall_ms=rec.get("wall"),
            trace_id=rec.get("trace"),
        )

    def _replay_wal(self) -> None:
        if self.wal is None:
            return
        pending = self.wal.unacked()
        if not pending:
            return
        replayed = 0
        for rec in pending:
            lane = self._lanes.get(rec.get("sink", ""))
            if lane is None:
                continue
            env = self._decode_wal_record(lane, rec)
            if env is None:
                continue
            # WAL backlog can exceed the queue bound; the overflow stays
            # deferred (the worker sweeps it back in as the queue drains)
            try:
                lane.queue.put_nowait(env)
            except asyncio.QueueFull:
                lane.deferred += 1
            lane.replayed += 1
            replayed += 1
            DELIVERY_WAL_REPLAYED.labels(sink=lane.sink.name).inc()
        self.wal_replayed = replayed
        if replayed:
            get_event_log().emit(
                "delivery_wal_replay",
                entries=replayed,
                by_sink={
                    n: lane.replayed for n, lane in self._lanes.items()
                    if lane.replayed
                },
            )
            log.info(
                "delivery WAL replay: %d unacked entr%s re-enqueued",
                replayed,
                "y" if replayed == 1 else "ies",
            )

    async def drain(self, timeout_s: float = 10.0) -> bool:
        """Wait until every lane is idle (queue empty, nothing in flight,
        nothing deferred) or the timeout passes; True when fully drained.
        An at-least-once lane mid-outage may never drain — the caller gets
        False and the WAL keeps the entries."""
        deadline = time.monotonic() + float(timeout_s)
        while time.monotonic() < deadline:
            if all(
                lane.queue.empty() and lane.inflight == 0 and lane.deferred == 0
                for lane in self._lanes.values()
            ):
                return True
            await asyncio.sleep(0.01)
        return False

    async def aclose(self, drain_s: float = 5.0) -> None:
        """Best-effort drain, then stop workers and compact the WAL.
        Undelivered at-least-once entries stay durable for the next boot."""
        if self.closed:
            return
        if self.started:
            await self.drain(timeout_s=drain_s)
        self.closed = True
        for lane in self._lanes.values():
            if lane.worker is not None:
                lane.worker.cancel()
        for lane in self._lanes.values():
            worker = lane.worker
            if worker is None:
                continue
            # Python 3.10's wait_for can SWALLOW a cancellation that lands
            # while the inner deliver is already done (bpo-42130): the
            # worker resumes as if the attempt succeeded and parks back on
            # queue.get never having observed the cancel — a bare `await
            # worker` here then deadlocks the closing task (seen live as a
            # replay-drive hang whenever drain timed out with a worker
            # mid-attempt). Re-cancel on a short timeout until the task
            # actually exits; the loop-top `closed` check in _worker makes
            # the recheck (or the second cancel) land immediately.
            for _ in range(25):
                done, _pending = await asyncio.wait({worker}, timeout=0.2)
                if done:
                    try:
                        await worker
                    except (asyncio.CancelledError, Exception):
                        pass
                    break
                worker.cancel()
            else:
                log.warning(
                    "delivery worker %s ignored shutdown; abandoned",
                    lane.sink.name,
                )
        self.emit_summary()
        if self.wal is not None:
            try:
                self.wal.compact()
            finally:
                self.wal.close()

    def emit_summary(self) -> None:
        """One ``delivery_summary`` event with the per-sink scoreboard —
        what tools/delivery_report.py renders after a drill/replay."""
        get_event_log().emit("delivery_summary", sinks=self._sink_counts())

    # -- enqueue (the tick thread's entire cost) ------------------------------

    def enqueue_fired(
        self,
        signal: Any,
        tick_ms: int | None = None,
        lag0_ms: float | None = None,
        dispatched_at: float | None = None,
    ) -> None:
        """Fan one FiredSignal out to every sink's queue — O(sinks) dict
        ops + one WAL append per durable sink; never blocks, never raises
        into the tick thread."""
        if not self.started:
            self.start()
        # delivery-health fallback anchors: with freshness OFF no caller
        # stamps lag0/dispatched_at, so the lag histogram would stay
        # empty — anchor at the enqueue instead (lag measures
        # enqueue→ack; documented in README §Delivery observatory)
        if (
            lag0_ms is None
            and self.health is not None
            and getattr(self.health, "enabled", False)
        ):
            lag0_ms = 0.0
        if dispatched_at is None and lag0_ms is not None:
            dispatched_at = time.perf_counter()
        for lane in self._lanes.values():
            try:
                payload = lane.sink.encode(signal)
            except Exception:
                log.exception(
                    "sink %s payload encode failed for %s/%s; dropping",
                    lane.sink.name,
                    getattr(signal, "strategy", "?"),
                    getattr(signal, "symbol", "?"),
                )
                self._shed(lane, "encode_error")
                continue
            entry_id = entry_id_of(
                getattr(signal, "trace_id", None),
                getattr(signal, "tick_seq", None),
                getattr(signal, "strategy", "?"),
                getattr(signal, "symbol", "?"),
                tick_ms=tick_ms,
            )
            stamp = getattr(lane.sink, "stamp", None)
            if lane.sink.policy == AT_LEAST_ONCE and stamp is not None:
                # stamped BEFORE the WAL put so the identity rides the
                # payload into the WAL and out again on replay — the
                # downstream dedupe key even when trace sampling left the
                # payload without trace_id/tick_seq metadata
                try:
                    stamp(payload, entry_id)
                except Exception:  # pragma: no cover
                    log.exception(
                        "sink %s payload stamp failed for %s",
                        lane.sink.name,
                        entry_id,
                    )
            env = Envelope(
                entry_id=entry_id,
                sink=lane.sink.name,
                payload=payload,
                ts_ms=tick_ms,
                lag0_ms=lag0_ms,
                dispatched_at=dispatched_at,
                trace_id=getattr(signal, "trace_id", None),
            )
            self.enqueue(env)

    def enqueue(self, env: Envelope) -> None:
        lane = self._lanes[env.sink]
        durable = lane.sink.policy == AT_LEAST_ONCE
        if durable and self.wal is not None and not env.replayed:
            # durability FIRST: once the put is on disk the signal cannot
            # be lost to a crash, full queue, or slow sink
            self.wal.append_put(
                env.entry_id,
                env.sink,
                lane.sink.to_wal(env.payload),
                ts_ms=env.ts_ms,
                lag0_ms=env.lag0_ms,
                trace_id=env.trace_id,
            )
            # the gauge must move on PUTS too: during an outage acks stop
            # but backlog keeps growing — that growth IS the signal
            DELIVERY_WAL_UNACKED.labels(sink=env.sink).set(
                self.wal.unacked_count(env.sink)
            )
        lane.enqueued += 1
        DELIVERY_ENQUEUED.labels(sink=env.sink).inc()
        try:
            lane.queue.put_nowait(env)
        except asyncio.QueueFull:
            if durable and self.wal is not None:
                # bounded backpressure, unbounded durability: the entry is
                # already WAL-resident; the worker sweeps it back in when
                # its queue runs dry
                lane.deferred += 1
            else:
                # no WAL behind this lane (durability disabled) — the
                # bound still holds, the loss is counted
                self._shed(lane, "queue_full")
        DELIVERY_QUEUE.labels(sink=env.sink).set(lane.queue.qsize())

    def _shed(self, lane: _SinkLane, reason: str) -> None:
        lane.shed[reason] = lane.shed.get(reason, 0) + 1
        DELIVERY_SHED.labels(sink=lane.sink.name, reason=reason).inc()
        get_event_log().emit(
            "delivery_shed", sink=lane.sink.name, reason=reason
        )

    # -- workers -------------------------------------------------------------

    def _sweep_deferred(self, lane: _SinkLane) -> bool:
        """Move WAL-deferred entries back into a drained queue; True when
        anything was recovered."""
        if lane.deferred <= 0 or self.wal is None:
            return False
        consumed = 0
        moved = 0
        for rec in self.wal.unacked():
            if rec.get("sink") != lane.sink.name or lane.queue.full():
                continue
            env = self._decode_wal_record(lane, rec)
            # an undecodable entry still consumes its deferral slot —
            # otherwise it re-fails every sweep and drain() never settles
            consumed += 1
            if env is None:
                continue
            lane.queue.put_nowait(env)
            moved += 1
        lane.deferred = max(lane.deferred - consumed, 0)
        return moved > 0

    async def _worker(self, lane: _SinkLane) -> None:
        # loop-top closed check: a worker whose shutdown cancel was
        # swallowed by 3.10's wait_for (see aclose) exits here instead of
        # parking on an empty queue forever
        while not self.closed:
            try:
                env = lane.queue.get_nowait()
            except asyncio.QueueEmpty:
                if self._sweep_deferred(lane):
                    continue
                env = await lane.queue.get()
            lane.inflight += 1
            try:
                await self._deliver(lane, env)
            except asyncio.CancelledError:
                raise
            except Exception:  # a bug in _deliver must not kill the lane
                log.exception(
                    "delivery worker error for sink %s entry %s",
                    lane.sink.name,
                    env.entry_id,
                )
                # the envelope must not vanish either: at-least-once goes
                # back in the queue (it is already WAL-resident — a full
                # queue just defers it to the sweep), lossy is a counted
                # shed; the sleep keeps a deterministically-raising bug
                # from hot-looping the lane
                if lane.sink.policy == AT_LEAST_ONCE:
                    try:
                        lane.queue.put_nowait(env)
                    except asyncio.QueueFull:
                        lane.deferred += 1
                else:
                    self._shed(lane, "worker_error")
                await asyncio.sleep(max(self.backoff_s, 0.05))
            finally:
                lane.inflight -= 1
                DELIVERY_QUEUE.labels(sink=lane.sink.name).set(
                    lane.queue.qsize()
                )

    async def _deliver(self, lane: _SinkLane, env: Envelope) -> None:
        durable = lane.sink.policy == AT_LEAST_ONCE
        backoff = self.backoff_s
        while True:
            if not lane.breaker.allow():
                if not durable:
                    self._shed(lane, "breaker_open")
                    return
                # at-least-once rides out the open window (WAL-durable);
                # wake at least once a second so a scripted clock or a
                # short cooldown is honored promptly
                await asyncio.sleep(
                    min(max(lane.breaker.cooldown_remaining(), 0.01), 1.0)
                )
                continue
            t_attempt = time.perf_counter()
            try:
                await asyncio.wait_for(
                    lane.sink.deliver(env.payload),
                    timeout=self.attempt_timeout_s,
                )
            except asyncio.CancelledError:
                raise
            except Exception as exc:
                env.attempts += 1
                lane.retries += 1
                lane.breaker.record_failure()
                DELIVERY_RETRIES.labels(sink=lane.sink.name).inc()
                self._sink_span(
                    lane, env, t_attempt, env.attempts, type(exc).__name__
                )
                if not durable and env.attempts >= self.retry_max:
                    self._shed(lane, "retries_exhausted")
                    log.warning(
                        "sink %s shed %s after %d attempts: %s",
                        lane.sink.name,
                        env.entry_id,
                        env.attempts,
                        exc,
                    )
                    return
                # exponential with ±jitter so a herd of retrying workers
                # doesn't re-storm the sink
                await asyncio.sleep(reconnect_delay(backoff, self._rng))
                backoff = min(backoff * 2.0, self.backoff_max_s)
                continue
            lane.breaker.record_success()
            self._sink_span(lane, env, t_attempt, env.attempts + 1, "ok")
            self._ack(lane, env)
            return

    def _sink_span(
        self,
        lane: _SinkLane,
        env: Envelope,
        t0: float,
        attempt: int,
        outcome: str,
    ) -> None:
        """One per-attempt sink span, joined to the originating tick by
        the trace_id riding the envelope/WAL record.
        The tick's trace completed at emit — its span tree is already in
        the log — so these are standalone events tools/trace_report.py
        grafts onto the matching waterfall, extending it past enqueue to
        the ack. Gated like the lag accounting (health on + a trace id);
        the event log never raises."""
        if (
            self.health is None
            or not getattr(self.health, "enabled", False)
            or not env.trace_id
        ):
            return
        get_event_log().emit(
            "sink_span",
            trace_id=env.trace_id,
            sink=lane.sink.name,
            attempt=int(attempt),
            ms=round((time.perf_counter() - t0) * 1000.0, 3),
            outcome=outcome,
            entry_id=env.entry_id,
            replayed=env.replayed,
        )

    def _lag_ms(self, env: Envelope) -> float | None:
        """End-to-end close→ack lag of one confirmed delivery. Live
        entries: candle-close lag at dispatch + the monotonic dwell since.
        Replayed entries: lag-at-put + the WALL-clock delta since the put
        (the delta spans the process kill — exactly the lag a consumer
        experienced). None when no anchors rode the envelope."""
        if env.replayed:
            if env.lag0_ms is None or env.put_wall_ms is None:
                return None
            return float(env.lag0_ms) + max(
                time.time() * 1000.0 - float(env.put_wall_ms), 0.0
            )
        if env.dispatched_at is None or env.lag0_ms is None:
            return None
        return (
            float(env.lag0_ms)
            + (time.perf_counter() - env.dispatched_at) * 1000.0
        )

    def _ack(self, lane: _SinkLane, env: Envelope) -> None:
        lane.acked += 1
        DELIVERY_ACKED.labels(sink=lane.sink.name).inc()
        if lane.sink.policy == AT_LEAST_ONCE and self.wal is not None:
            self.wal.append_ack(env.entry_id, env.sink)
            DELIVERY_WAL_UNACKED.labels(sink=lane.sink.name).set(
                self.wal.unacked_count(lane.sink.name)
            )
        try:
            get_event_log().emit(
                "delivery_ack",
                sink=lane.sink.name,
                id=env.entry_id,
                attempts=env.attempts + 1,
                replayed=env.replayed,
            )
            # freshness loop closure: close→acked-through-the-queue.
            # Replayed entries predate this process's clock anchors — no
            # stamp here (the delivery-health lag histogram covers them
            # through the WAL wall-clock anchor instead).
            if (
                self.freshness is not None
                and getattr(self.freshness, "enabled", False)
                and env.dispatched_at is not None
                and env.lag0_ms is not None
            ):
                SINK_DELIVERY.labels(sink=lane.sink.name).observe(
                    env.lag0_ms
                    + (time.perf_counter() - env.dispatched_at) * 1000.0
                )
            # the ack-side close→ack lag (to the FINAL
            # successful ack — this runs once per envelope, after every
            # retry) feeding bqt_delivery_lag_ms + the delivery SLO
            if self.health is not None and getattr(
                self.health, "enabled", False
            ):
                lag_ms = self._lag_ms(env)
                if lag_ms is not None:
                    self.health.on_ack(
                        lane.sink.name,
                        lag_ms,
                        attempts=env.attempts + 1,
                        replayed=env.replayed,
                    )
        except Exception:  # pragma: no cover - observability-side failure
            # the sink confirmed and the WAL ack landed — a failing event
            # log or histogram must not turn a delivered entry into a
            # worker error (which would redeliver it)
            log.exception(
                "delivery ack observability failed for %s", env.entry_id
            )

    # -- introspection --------------------------------------------------------

    def _sink_counts(self) -> dict[str, dict]:
        return {
            name: {
                "policy": lane.sink.policy,
                "enqueued": lane.enqueued,
                "acked": lane.acked,
                "retries": lane.retries,
                "shed": dict(lane.shed),
                "deferred": lane.deferred,
                "wal_replayed": lane.replayed,
                "breaker": lane.breaker.state,
                "breaker_transitions": list(lane.breaker.transitions),
                "queue_depth": lane.queue.qsize(),
                "inflight": lane.inflight,
            }
            for name, lane in self._lanes.items()
        }

    def breaker(self, sink: str) -> CircuitBreaker:
        return self._lanes[sink].breaker

    def lane(self, sink: str) -> _SinkLane:
        return self._lanes[sink]

    def watermarks(self) -> dict:
        """Outbox watermarks per consumer group: records
        behind head (queued + inflight + WAL-deferred, i.e. accepted but
        not yet acked in-process) and the oldest unacked WAL record's
        age. Refreshes the bqt_delivery_cursor_lag /
        bqt_delivery_oldest_unacked_ms gauges on read (snapshot-driven —
        the watermarks are levels, not edges)."""
        now_wall_ms = time.time() * 1000.0
        groups: dict[str, dict] = {}
        for name, lane in self._lanes.items():
            cursor_lag = lane.queue.qsize() + lane.inflight + lane.deferred
            DELIVERY_CURSOR_LAG.labels(group=name).set(cursor_lag)
            cell: dict[str, Any] = {
                "cursor_lag": cursor_lag,
                "queue_depth": lane.queue.qsize(),
                "inflight": lane.inflight,
                "deferred": lane.deferred,
            }
            if (
                self.wal is not None
                and lane.sink.policy == AT_LEAST_ONCE
            ):
                oldest = self.wal.oldest_put_wall_ms(name)
                age_ms = (
                    max(now_wall_ms - oldest, 0.0)
                    if oldest is not None
                    else 0.0
                )
                DELIVERY_OLDEST_AGE.labels(sink=name).set(round(age_ms, 3))
                cell["oldest_unacked_ms"] = round(age_ms, 3)
            groups[name] = cell
        return groups

    # -- SLO-plane invariant probes -----------------------------------------

    def zero_loss_invariant(self) -> dict:
        """Zero-loss contract: the at-least-once class NEVER sheds (only
        lossy lanes may drop under pressure)."""
        shed = {
            name: dict(lane.shed)
            for name, lane in self._lanes.items()
            if lane.sink.policy == AT_LEAST_ONCE and lane.shed
        }
        return {"ok": not shed, "durable_sheds": shed}

    def zero_duplicate_invariant(self) -> dict:
        """Zero-duplicate contract: no entry acks twice (sink-side idempotency
        keys make redelivery safe, but a double ack in-process would mean
        the outbox double-delivered). No WAL → vacuously true."""
        dups = self.wal.dup_acks if self.wal is not None else 0
        return {"ok": dups == 0, "dup_acks": dups}

    def breakers_closed_invariant(self) -> dict:
        """An open (or half-open) breaker means a sink is DOWN — the
        verdict must not read green while one is tripped, even if every
        SLO window has since washed clean."""
        open_ = {
            name: lane.breaker.state
            for name, lane in self._lanes.items()
            if lane.breaker.state != "closed"
        }
        return {"ok": not open_, "open": open_}

    def snapshot(self) -> dict:
        """The /healthz ``delivery`` section: per-sink queue/breaker/
        counter state plus WAL occupancy. Attribute reads only — safe
        inline on the event loop (a degraded plane keeps
        /healthz at HTTP 200; only a stale heartbeat is 503)."""
        wal = None
        if self.wal is not None:
            wal = {
                "path": str(self.wal.path),
                "puts": self.wal.puts,
                "acks": self.wal.acks,
                "dup_acks": self.wal.dup_acks,
                "unacked": self.wal.unacked_count(),
                "compactions": self.wal.compactions,
                "replayed_at_boot": self.wal_replayed,
            }
        out = {
            "enabled": True,
            "started": self.started,
            "sinks": self._sink_counts(),
            "wal": wal,
            "watermarks": self.watermarks(),
        }
        if self.health is not None and getattr(
            self.health, "enabled", False
        ):
            out["lag"] = self.health.snapshot()
        return out
