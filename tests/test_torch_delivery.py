"""The port's delivery plane against the reference's, case by case.

Every case of ``tests/test_delivery.py`` (the WAL's puts, acks, compaction,
torn-line tolerance and boot backlog; the breaker on a scripted clock; the
plane's delivery, retries, sheds, deferral, hard-kill replay, worker
errors and the shutdown of a worker that swallowed its cancel) runs through
both packages on the same script, with a seeded ``rng``, and must give the
same outcome: the same delivered payloads and the same ack, shed, retry,
deferral and WAL counts. A WAL written by either package replays in the
other's plane with the same unacked set and the same decoded payloads.
Every async drive runs under ``asyncio.wait_for`` with a limit of its own.
"""

import asyncio
import contextlib
import json
import random
import time
from types import SimpleNamespace

import pytest

from binquant_tpu.io import delivery as jd
from binquant_tpu_torch.io import delivery as td

PACKAGES = {"jax": jd, "torch": td}


def run(coro, limit_s: float = 20.0):
    return asyncio.run(asyncio.wait_for(coro, timeout=limit_s))


class FakeSink:
    """Scriptable sink: fail the first ``fail_times`` attempts."""

    def __init__(self, name="analytics", policy="lossy", fail_times=0, latency_s=0.0):
        self.name = name
        self.policy = policy
        self.fail_times = fail_times
        self.latency_s = latency_s
        self.attempts = 0
        self.delivered = []

    def encode(self, signal):
        return {"strategy": signal.strategy, "symbol": signal.symbol,
                "seq": getattr(signal, "tick_seq", 0)}

    def to_wal(self, payload):
        return payload

    def from_wal(self, data):
        return data

    async def deliver(self, payload):
        self.attempts += 1
        if self.latency_s:
            await asyncio.sleep(self.latency_s)
        if self.fail_times > 0:
            self.fail_times -= 1
            raise ConnectionError("scripted sink failure")
        self.delivered.append(payload)


def make_plane(d, sinks, tmp_path=None, **kw):
    kw.setdefault("queue_max", 8)
    kw.setdefault("attempt_timeout_s", 1.0)
    kw.setdefault("retry_max", 3)
    kw.setdefault("backoff_s", 0.001)
    kw.setdefault("backoff_max_s", 0.005)
    kw.setdefault("breaker_threshold", 3)
    kw.setdefault("breaker_cooldown_s", 0.02)
    kw.setdefault("wal_fsync", False)
    kw.setdefault("rng", random.Random(7))
    if tmp_path is not None:
        kw.setdefault("wal_path", tmp_path / "outbox.wal.jsonl")
    return d.DeliveryPlane(sinks=sinks, **kw)


def fake_signal(i=0, strategy="mrf", symbol=None):
    return SimpleNamespace(strategy=strategy, symbol=symbol or f"S{i:03d}USDT",
                           trace_id=f"trace{i}", tick_seq=i)


def counts(plane) -> dict:
    out = {}
    for name, c in plane._sink_counts().items():
        out[name] = {k: c[k] for k in ("enqueued", "acked", "retries", "shed", "deferred",
                                       "wal_replayed", "breaker")}
    if plane.wal is not None:
        out["wal"] = (plane.wal.puts, plane.wal.acks, plane.wal.dup_acks,
                      plane.wal.unacked_count())
    return out


def both(case, tmp_path_factory) -> dict:
    """Run ``case(d, tmp_path)`` for each package in a fresh directory;
    the outcomes must be equal. Returns the port's."""
    out = {key: case(d, tmp_path_factory.mktemp(key)) for key, d in PACKAGES.items()}
    assert out["torch"] == out["jax"]
    return out["torch"]


# -- WAL ----------------------------------------------------------------------


def _wal_roundtrip(d, tmp):
    wal = d.DeliveryWal(tmp / "w.jsonl", fsync=False, compact_every=0)
    for i, x in enumerate((1, 2, 3), start=1):
        wal.append_put(f"a/{i}", "autotrade", {"x": x}, ts_ms=10 * i)
    wal.append_ack("a/2", "autotrade")
    pending = [(r["id"], r["payload"]) for r in wal.unacked()]
    survivors = wal.compact()
    lines = [json.loads(ln)["id"] for ln in (tmp / "w.jsonl").read_text().splitlines()]
    wal.append_ack("a/1", "autotrade")
    after = [r["id"] for r in wal.unacked()]
    wal.close()
    return pending, survivors, lines, after


def _wal_torn(d, tmp):
    path = tmp / "w.jsonl"
    wal = d.DeliveryWal(path, fsync=False)
    wal.append_put("a/1", "autotrade", {"x": 1})
    wal.close()
    with open(path, "a") as f:
        f.write('{"op": "put", "id": "a/2", "si')  # killed mid-write
    wal2 = d.DeliveryWal(path, fsync=False)
    ids = [r["id"] for r in wal2.unacked()]
    wal2.close()
    return ids


def _wal_backlog(d, tmp):
    path = tmp / "w.jsonl"
    wal = d.DeliveryWal(path, fsync=False)
    wal.append_put("a/1", "autotrade", 1)
    wal.append_put("a/2", "autotrade", 2)
    wal.append_put("t/1", "telegram", 3)
    wal.append_ack("a/1", "autotrade")
    first = (wal.unacked_count(), wal.unacked_count("autotrade"))
    wal.close()
    wal2 = d.DeliveryWal(path, fsync=False)
    second = (wal2.unacked_count(), wal2.unacked_count("telegram"))
    wal2.append_ack("a/2", "autotrade")
    third = wal2.unacked_count("autotrade")
    wal2.close()
    return first, second, third


def _wal_auto_compact(d, tmp):
    wal = d.DeliveryWal(tmp / "w.jsonl", fsync=True, compact_every=2)
    for i in range(4):
        wal.append_put(f"a/{i}", "autotrade", i)
        wal.append_ack(f"a/{i}", "autotrade")
    out = (wal.compactions, wal.unacked(), wal.puts, wal.acks, wal.dup_acks)
    wal.append_ack("a/0", "autotrade")  # an ack for an acked key counts as a duplicate
    out += (wal.dup_acks,)
    wal.close()
    return out


def test_wal_put_ack_compact_roundtrip(tmp_path_factory):
    pending, survivors, lines, after = both(_wal_roundtrip, tmp_path_factory)
    assert pending == [("a/1", {"x": 1}), ("a/3", {"x": 3})]
    assert survivors == 2 and set(lines) == {"a/1", "a/3"} and after == ["a/3"]


def test_wal_tolerates_torn_trailing_line(tmp_path_factory):
    assert both(_wal_torn, tmp_path_factory) == ["a/1"]


def test_wal_unacked_count_seeds_from_boot_backlog(tmp_path_factory):
    assert both(_wal_backlog, tmp_path_factory) == ((2, 1), (2, 1), 0)


def test_wal_auto_compacts_on_ack_cadence(tmp_path_factory):
    assert both(_wal_auto_compact, tmp_path_factory) == (2, [], 4, 4, 0, 1)


def test_wal_keeps_the_first_record_after_a_torn_tail(tmp_path):
    """A record appended after a kill mid-write survives in the port's WAL,
    which ends the torn line on open; the reference appends to the torn
    line and loses the record with it."""
    kept = {}
    for key, d in PACKAGES.items():
        path = tmp_path / f"{key}.wal.jsonl"
        wal = d.DeliveryWal(path, fsync=False)
        wal.append_put("a/1", "autotrade", 1)
        wal.close()
        with open(path, "a") as f:
            f.write('{"op": "put", "id": "a/2", "si')  # killed mid-write
        wal = d.DeliveryWal(path, fsync=False)
        wal.append_put("a/3", "autotrade", 3)
        wal.close()
        kept[key] = [r["id"] for r in d.DeliveryWal(path, fsync=False).unacked()]
    assert kept == {"torch": ["a/1", "a/3"], "jax": ["a/1"]}


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_wal_crosses_between_packages(writer, tmp_path):
    """A WAL one package's plane wrote (puts and acks after a hard kill)
    replays in the other's plane: the same unacked set, the same decoded
    payloads, delivered and acked."""
    reader = "torch" if writer == "jax" else "jax"
    wd, rd = PACKAGES[writer], PACKAGES[reader]
    path = tmp_path / "x.wal.jsonl"
    sink = FakeSink("autotrade", policy="at_least_once", fail_times=10_000)
    plane = make_plane(wd, [sink], wal_path=path, breaker_threshold=2)

    async def storm():
        plane.start()
        for i in range(5):
            plane.enqueue_fired(fake_signal(i), tick_ms=1000 + i)
        await asyncio.sleep(0.03)
        for lane in plane._lanes.values():
            lane.worker.cancel()
        await asyncio.gather(*(lane.worker for lane in plane._lanes.values()),
                             return_exceptions=True)
        plane.closed = True
        plane.wal.append_ack(wd.entry_id_of("trace1", 1, "mrf", "S001USDT"), "autotrade")
        plane.wal.close()

    run(storm())
    want = [(r["id"], r["payload"]) for r in wd.DeliveryWal(path, fsync=False).unacked()]
    got_wal = rd.DeliveryWal(path, fsync=False)
    assert [(r["id"], r["payload"]) for r in got_wal.unacked()] == want
    assert got_wal.unacked_count("autotrade") == 4
    got_wal.close()

    sink2 = FakeSink("autotrade", policy="at_least_once")
    plane2 = make_plane(rd, [sink2], wal_path=path)

    async def recover():
        plane2.start()
        assert await plane2.drain(timeout_s=5.0)
        await plane2.aclose()

    run(recover())
    assert plane2.wal_replayed == 4
    assert sink2.delivered == [p for _, p in want]
    assert rd.DeliveryWal(path, fsync=False).unacked() == []


# -- circuit breaker ----------------------------------------------------------


def _breaker(d, tmp):
    clock = SimpleNamespace(now=0.0)
    br = d.CircuitBreaker("autotrade", threshold=2, cooldown_s=10.0, clock=lambda: clock.now)
    seen = [(br.state, br.allow())]
    br.record_failure()
    seen.append(br.state)
    br.record_failure()
    seen.append((br.state, br.allow(), br.cooldown_remaining()))
    clock.now = 11.0
    seen.append((br.allow(), br.state, br.allow()))
    br.record_failure()
    seen.append(br.state)
    clock.now = 22.0
    seen.append(br.allow())
    br.record_success()
    seen.append((br.state, br.consecutive, list(br.transitions)))
    return seen


def test_breaker_state_machine_scripted_clock(tmp_path_factory):
    seen = both(_breaker, tmp_path_factory)
    assert seen[-1] == ("closed", 0, ["open", "half_open", "open", "half_open", "closed"])


# -- plane semantics ----------------------------------------------------------


def _delivers(d, tmp):
    at = FakeSink("autotrade", policy="at_least_once")
    an = FakeSink("analytics", policy="lossy")
    plane = make_plane(d, [at, an], tmp)

    async def go():
        plane.start()
        for i in range(3):
            plane.enqueue_fired(fake_signal(i), tick_ms=1000 + i)
        assert await plane.drain(timeout_s=5.0)
        await plane.aclose()

    run(go())
    return (at.delivered, an.delivered, counts(plane),
            (tmp / "outbox.wal.jsonl").read_text(),
            d.entry_id_of("trace0", 0, "mrf", "S000USDT"),
            d.entry_id_of(None, None, "mrf", "S000USDT", tick_ms=1000))


def _retries(d, tmp):
    at = FakeSink("autotrade", policy="at_least_once", fail_times=2)
    plane = make_plane(d, [at], tmp, breaker_threshold=10)

    async def go():
        plane.start()
        plane.enqueue_fired(fake_signal(0))
        assert await plane.drain(timeout_s=5.0)
        await plane.aclose()

    run(go())
    return at.attempts, at.delivered, counts(plane)


def _lossy_sheds(d, tmp):
    an = FakeSink("analytics", policy="lossy", fail_times=99)
    plane = make_plane(d, [an], tmp, retry_max=2, queue_max=1, breaker_threshold=100)

    async def go():
        plane.start()
        plane.enqueue_fired(fake_signal(0))
        await plane.drain(timeout_s=5.0)
        await plane.aclose()

    run(go())
    an2 = FakeSink("analytics", policy="lossy")
    plane2 = make_plane(d, [an2], tmp / "second", queue_max=1)
    for i in range(3):
        plane2.enqueue(d.Envelope(entry_id=f"b/{i}", sink="analytics", payload=i))
    return an.attempts, an.delivered, counts(plane), counts(plane2)


def _defers(d, tmp):
    at = FakeSink("autotrade", policy="at_least_once", latency_s=0.002)
    plane = make_plane(d, [at], tmp, queue_max=2)

    async def go():
        plane.start()
        for i in range(8):
            plane.enqueue_fired(fake_signal(i))
        deferred = plane.lane("autotrade").deferred
        assert await plane.drain(timeout_s=10.0)
        await plane.aclose()
        return deferred

    deferred = run(go())
    return deferred, at.delivered, counts(plane)


def _breaker_parks(d, tmp):
    at = FakeSink("autotrade", policy="at_least_once", fail_times=4)
    an = FakeSink("analytics", policy="lossy", fail_times=2)
    plane = make_plane(d, [at, an], tmp, retry_max=1, breaker_threshold=2,
                       breaker_cooldown_s=0.02)

    async def go():
        plane.start()
        for i in range(3):
            plane.enqueue_fired(fake_signal(i))
        assert await plane.drain(timeout_s=10.0)
        await plane.aclose()

    run(go())
    an_lane, at_lane = plane.lane("analytics"), plane.lane("autotrade")
    # the analytics lane's third entry sheds on the open breaker or rides
    # the half-open probe, by timing: the outcome compared is its balance
    return (an_lane.breaker.transitions[0], sum(an_lane.shed.values()) + len(an.delivered),
            len(an.delivered) + sum(an_lane.shed.values()) == an_lane.enqueued,
            sorted(p["symbol"] for p in at.delivered), "open" in at_lane.breaker.transitions,
            at_lane.breaker.state, at_lane.acked, plane.wal.unacked_count())


def _hard_kill(d, tmp):
    wal = tmp / "kill.wal.jsonl"
    at = FakeSink("autotrade", policy="at_least_once", fail_times=10_000)
    plane = make_plane(d, [at], wal_path=wal, breaker_threshold=2)

    async def storm():
        plane.start()
        for i in range(3):
            plane.enqueue_fired(fake_signal(i))
        await asyncio.sleep(0.05)
        for lane in plane._lanes.values():  # HARD KILL: no drain, no ack, no compaction
            lane.worker.cancel()
        await asyncio.gather(*(lane.worker for lane in plane._lanes.values()),
                             return_exceptions=True)
        plane.closed = True
        plane.wal.close()

    run(storm())
    probe = d.DeliveryWal(wal, fsync=False)
    unacked = len(probe.unacked())
    probe.close()
    at2 = FakeSink("autotrade", policy="at_least_once")
    plane2 = make_plane(d, [at2], wal_path=wal)

    async def recover():
        plane2.start()
        assert await plane2.drain(timeout_s=5.0)
        await plane2.aclose()

    run(recover())
    probe = d.DeliveryWal(wal, fsync=False)
    left = probe.unacked()
    probe.close()
    return unacked, plane2.wal_replayed, at2.delivered, counts(plane2), left


def _worker_error_durable(d, tmp):
    sink = FakeSink(name="autotrade", policy="at_least_once")
    plane = make_plane(d, [sink], tmp)
    orig = plane._deliver
    calls = {"n": 0}

    async def flaky_deliver(lane, env):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("scripted worker bug")
        await orig(lane, env)

    plane._deliver = flaky_deliver

    async def go():
        plane.start()
        plane.enqueue_fired(fake_signal(1))
        assert await plane.drain(timeout_s=5.0)
        await plane.aclose()

    run(go())
    return sink.delivered, counts(plane)


def _worker_error_lossy(d, tmp):
    sink = FakeSink(name="analytics", policy="lossy")
    plane = make_plane(d, [sink])

    async def broken_deliver(lane, env):
        raise RuntimeError("scripted worker bug")

    plane._deliver = broken_deliver

    async def go():
        plane.start()
        plane.enqueue_fired(fake_signal(2))
        assert await plane.drain(timeout_s=5.0)
        await plane.aclose()

    run(go())
    return counts(plane)


def test_plane_delivers_and_acks_through_wal(tmp_path_factory):
    at, an, c, wal_text, traced, untraced = both(_delivers, tmp_path_factory)
    assert len(at) == len(an) == 3 and c["autotrade"]["acked"] == 3 and wal_text == ""
    assert (traced, untraced) == ("trace0/0/mrf/S000USDT", "t1000/0/mrf/S000USDT")


def test_plane_retries_then_delivers(tmp_path_factory):
    attempts, delivered, c = both(_retries, tmp_path_factory)
    assert attempts == 3 and len(delivered) == 1 and c["autotrade"]["retries"] == 2


def test_lossy_sheds_on_retries_exhausted_and_queue_full(tmp_path_factory):
    attempts, delivered, c, c2 = both(_lossy_sheds, tmp_path_factory)
    assert attempts == 2 and delivered == []
    assert c["analytics"]["shed"] == {"retries_exhausted": 1}
    assert c2["analytics"]["shed"] == {"queue_full": 2}


def test_at_least_once_defers_to_wal_on_queue_full(tmp_path_factory):
    deferred, delivered, c = both(_defers, tmp_path_factory)
    assert deferred == 6 and len(delivered) == 8 and c["autotrade"]["deferred"] == 0


def test_breaker_open_sheds_lossy_and_parks_durable(tmp_path_factory):
    out = both(_breaker_parks, tmp_path_factory)
    assert out == ("open", 3, True, ["S000USDT", "S001USDT", "S002USDT"], True,
                   "closed", 3, 0)


def test_wal_replay_after_hard_kill(tmp_path_factory):
    unacked, replayed, delivered, c, left = both(_hard_kill, tmp_path_factory)
    assert unacked == replayed == len(delivered) == 3 and left == []
    assert c["wal"] == (0, 3, 0, 0)


def test_worker_error_requeues_durable_envelope(tmp_path_factory):
    delivered, _ = both(_worker_error_durable, tmp_path_factory)
    assert [p["symbol"] for p in delivered] == ["S001USDT"]


def test_worker_error_sheds_lossy_envelope_counted(tmp_path_factory):
    c = both(_worker_error_lossy, tmp_path_factory)
    assert c["analytics"]["shed"] == {"worker_error": 1}


@pytest.mark.parametrize("package", sorted(PACKAGES))
def test_aclose_unsticks_worker_that_swallowed_its_cancel(package):
    """A worker that ate its shutdown cancel and parked on its queue again
    must not deadlock ``aclose``: it re-cancels until the worker exits."""
    d = PACKAGES[package]
    sink = FakeSink(name="telegram", policy="lossy")
    plane = make_plane(d, [sink])

    async def go():
        plane.start()
        lane = plane.lane("telegram")
        real = lane.worker
        real.cancel()
        with contextlib.suppress(asyncio.CancelledError):
            await real

        async def stubborn():
            try:
                await asyncio.sleep(3600)
            except asyncio.CancelledError:
                pass  # the swallow
            await lane.queue.get()

        lane.worker = asyncio.get_running_loop().create_task(stubborn())
        await asyncio.sleep(0)
        t0 = time.monotonic()
        await asyncio.wait_for(plane.aclose(drain_s=0.05), timeout=10.0)
        assert time.monotonic() - t0 < 5.0, "aclose deadlocked on the swallowed-cancel worker"

    run(go())
    assert plane.closed


def test_invariants_watermarks_and_snapshot(tmp_path_factory):
    def case(d, tmp):
        at = FakeSink("autotrade", policy="at_least_once", fail_times=10_000)
        an = FakeSink("analytics", policy="lossy")
        plane = make_plane(d, [at, an], tmp, breaker_threshold=1, breaker_cooldown_s=60.0)

        async def go():
            plane.start()
            for i in range(2):
                plane.enqueue_fired(fake_signal(i), tick_ms=5)
            await asyncio.sleep(0.05)
            marks = plane.watermarks()
            snap = plane.snapshot()
            await plane.aclose(drain_s=0.05)
            return marks, snap

        marks, snap = run(go())
        for cell in marks.values():
            cell.pop("oldest_unacked_ms", None)
        snap["wal"].pop("path")
        snap.pop("watermarks")
        return (marks, snap, plane.zero_loss_invariant(), plane.zero_duplicate_invariant(),
                plane.breakers_closed_invariant())

    marks, snap, loss, dup, closed = both(case, tmp_path_factory)
    assert loss["ok"] and dup["ok"] and not closed["ok"]
    assert snap["wal"]["unacked"] == 2 and marks["autotrade"]["cursor_lag"] == 2
