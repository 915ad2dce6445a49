"""Tick tracing against the reference (``binquant_tpu/obs/tracing.py``).

Both packages' :class:`Tracer`, :class:`TickTrace` and
:class:`ProfileController` run the same scripted sequences with the clock
injected (``time.perf_counter`` replaced by a scripted clock restarted for
each package), so summaries, span trees and the flight recorder's events
must be equal once the random ids are masked: sampling picks the same
tick_seqs, busy time is the sum of the root's direct children, a slow or
errored tick force-emits ``slow_tick`` attributed to its dominant stage,
completion deactivates the trace, ``detached`` clears the current trace,
and the profiler window's status dicts match. Nothing here builds an
engine.
"""

import itertools
import json
import re

import pytest

from binquant_tpu.obs import events as jevents
from binquant_tpu.obs import instruments as jinstruments
from binquant_tpu.obs import tracing as jtracing
from binquant_tpu_torch.obs import events as tevents
from binquant_tpu_torch.obs import instruments as tinstruments
from binquant_tpu_torch.obs import tracing as ttracing

PAIRS = ((jtracing, jevents), (ttracing, tevents))


class ScriptedClock:
    """perf_counter readings advancing by scripted steps (ms); ``reset``
    restarts the script, so each package reads the same sequence."""

    STEPS_MS = (0.5, 1.25, 7.0, 3.0)

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self._steps = itertools.cycle(self.STEPS_MS)
        self.now = 1000.0

    def __call__(self) -> float:
        self.now += next(self._steps) / 1000.0
        return self.now


@pytest.fixture
def clocks(monkeypatch):
    """The tracing clock (both modules read ``time.perf_counter``) replaced
    by a scripted clock, and each package's event log writing to a list.
    Returns (clock, [reference records, port records])."""
    clock = ScriptedClock()
    monkeypatch.setattr(jtracing.time, "perf_counter", clock)
    logs = []
    for mod, ev in PAIRS:
        records = []
        log = ev.EventLog(None)
        log.enabled = True
        log.emit = lambda event, _r=records, **f: _r.append({"event": event, **f}) or f
        monkeypatch.setattr(mod, "get_event_log", lambda _l=log: _l)
        logs.append(records)
    return clock, logs


_HEX = re.compile(r"\b[0-9a-f]{8}(?:[0-9a-f]{8})?\b")


def masked(obj):
    """JSON text of ``obj`` with every hex id replaced."""
    return _HEX.sub("<id>", json.dumps(obj, sort_keys=True, default=str))


def scripted_tick(tracing, tracer, seq: int, error: bool, extra_stage: bool):
    """One tick in the engine's shape: dispatch spans, then finalize spans
    under the activated trace, with a nested sink span and an inputs span
    recorded from explicit readings."""
    trace = tracer.begin_tick(seq, tick_ms=1_780_000_000_000 + 900_000 * seq)
    with trace.span("breadth_refresh"):
        pass
    with trace.span("ingest_drain") as sp:
        sp.set(batches5=3, batches15=1, clean_appends=True)
    with trace.span("route_decision") as sp:
        sp.set(path="incremental", full_recompute_reason=None)
        trace.set_attr(path="incremental")
    t0 = tracing.time.perf_counter()
    trace.record_span("inputs_build", t0)
    with trace.span("device_dispatch", incremental=True, donated=True), trace.activate():
        assert tracing.current_trace_id() == trace.trace_id
    assert tracing.current_trace_id() is None
    with trace.activate():
        with trace.span("wire_fetch") as sp:
            sp.set(overflow=False)
        if extra_stage:
            with trace.span("overflow_fallback", overflow=True):
                pass
        with trace.span("emission", signals=2):
            for sym in ("AAAUSDT", "BBBUSDT"):
                with trace.span("delivery.enqueue", strategy="mrf", symbol=sym):
                    pass
        with tracing.detached():
            assert tracing.current_trace_id() is None
        if error:
            try:
                with trace.span("dedupe"):
                    raise ValueError("scripted")
            except ValueError as exc:
                trace.mark_error(exc)
    return trace


@pytest.mark.parametrize("sample", [1.0, 0.25, 0.4, 0.0])
def test_sampling_traces_the_same_tick_seqs(sample):
    picked = []
    for mod, _ in PAIRS:
        tracer = mod.Tracer(sample=sample)
        picked.append([seq for seq in range(1, 41) if tracer.begin_tick(seq).active])
    assert picked[0] == picked[1]
    assert len(picked[1]) == int(40 * sample)
    if sample == 0.25:
        assert picked[1] == list(range(4, 41, 4))


@pytest.mark.parametrize("slow_ms", [50.0, 0.0, 1e9])
@pytest.mark.parametrize("error", [False, True])
def test_complete_summary_tree_and_flight_recorder(clocks, slow_ms, error):
    clock, logs = clocks
    out = []
    for (mod, _), records in zip(PAIRS, logs):
        clock.reset()
        tracer = mod.Tracer(sample=1.0, slow_ms=slow_ms, ring=3)
        summaries = []
        for seq in range(1, 6):
            trace = scripted_tick(mod, tracer, seq, error=error and seq == 3,
                                  extra_stage=seq == 4)
            summaries.append(tracer.complete(trace, snapshot_fn=lambda: {"pending_ticks": 1}))
            assert not trace.active and tracer.complete(trace) is None  # twice: no-op
        out.append({
            "summaries": summaries,
            "ring": [e["summary"]["tick_seq"] for e in tracer.entries()],
            "last": tracer.last_tick_trace(),
            "events": records,
        })
    assert masked(out[0]) == masked(out[1])
    kinds = [e["event"] for e in out[1]["events"]]
    assert kinds.count("trace") == 5
    slow = [e for e in out[1]["events"] if e["event"] == "slow_tick"]
    breached = [s for s in out[1]["summaries"] if s["busy_ms"] >= slow_ms or s["status"] == "error"]
    assert len(slow) == len(breached) == {0.0: 5, 1e9: int(error)}.get(slow_ms, len(breached))
    assert [e["status"] for e in slow] == [s["status"] for s in breached]
    for e in slow:
        assert e["engine"] == {"pending_ticks": 1}
        assert e["stage"] == e["slowest_stage"]
    assert out[1]["ring"] == [3, 4, 5]


def test_busy_time_and_dominant_stage(clocks):
    clock, _ = clocks
    for mod, _ in PAIRS:
        clock.reset()
        tracer = mod.Tracer(sample=1.0, slow_ms=1e9)
        trace = scripted_tick(mod, tracer, 1, error=False, extra_stage=True)
        trace.finish()
        kids = trace.children_of(trace.root)
        assert [s.name for s in kids] == [
            "breadth_refresh", "ingest_drain", "route_decision", "inputs_build",
            "device_dispatch", "wire_fetch", "overflow_fallback", "emission",
        ]
        assert trace.busy_ms() == pytest.approx(sum(s.duration_ms for s in kids))
        assert trace.dominant_stage() == max(kids, key=lambda s: s.duration_ms).name
        assert trace.busy_ms() < trace.root.duration_ms
    empty = [mod.TickTrace(1) for mod, _ in PAIRS]
    assert [t.dominant_stage() for t in empty] == ["untracked", "untracked"]


def test_slow_ticks_counted_by_stage(clocks):
    before = [
        {k: c.value for k, c in inst.SLOW_TICKS.children()} for inst in (jinstruments, tinstruments)
    ]
    for mod, _ in PAIRS:
        tracer = mod.Tracer(sample=1.0, slow_ms=0.0)
        tracer.complete(scripted_tick(mod, tracer, 1, error=False, extra_stage=False))
    after = [
        {k: c.value for k, c in inst.SLOW_TICKS.children()} for inst in (jinstruments, tinstruments)
    ]
    deltas = [
        {k: v - b.get(k, 0.0) for k, v in a.items() if v != b.get(k, 0.0)}
        for a, b in zip(after, before)
    ]
    assert deltas[0] == deltas[1] and sum(deltas[1].values()) == 1


def test_null_trace_is_inert():
    for mod, _ in PAIRS:
        null = mod.Tracer(sample=0.0).begin_tick(7)
        assert null is mod.NULL_TRACE and not null.active
        assert null.trace_id is None and null.tick_seq is None
        with null.span("x", a=1) as sp:
            sp.set(b=2)
        null.set_attr(path="full")
        null.mark_error(ValueError())
        null.record_span("inputs_build", 0.0).set(c=3)
        with null.activate():
            assert mod.current_trace_id() is None


def test_completed_trace_is_no_longer_current():
    for mod, _ in PAIRS:
        tracer = mod.Tracer(sample=1.0, slow_ms=1e9)
        trace = tracer.begin_tick(1)
        with trace.activate():
            assert mod.current_trace() is trace
            tracer.complete(trace)
            assert mod.current_trace() is None and mod.current_trace_id() is None


def test_ids_are_hex_and_distinct_per_process():
    j, t = jtracing.TickTrace(1), ttracing.TickTrace(1)
    for trace in (j, t):
        assert re.fullmatch(r"[0-9a-f]{16}", trace.trace_id)
        assert re.fullmatch(r"[0-9a-f]{8}", trace.root.span_id)
    ids = {ttracing.TickTrace(s).trace_id for s in range(50)}
    assert len(ids) == 50


@pytest.mark.parametrize("seconds", [0.05, 1.0])
def test_profile_window_status(seconds):
    """Injected start/stop callables: the same status dicts, one window at
    a time, the window flag cleared when it closes (timer thread: no loop
    runs here)."""
    results = []
    for mod, ev in PAIRS:
        calls = []
        ctl = mod.ProfileController(
            log_dir="unused", start_fn=lambda d, _c=calls: _c.append(("start", d)),
            stop_fn=lambda _c=calls: _c.append(("stop",)),
        )
        first = ctl.start_window(seconds)
        busy = ctl.start_window(seconds)
        assert mod.profiler_window_active() and ctl.active
        ctl._stop_task.join(timeout=10)
        assert not mod.profiler_window_active()
        results.append((first, busy, calls))
    assert results[0] == results[1]
    assert results[1][0]["started"] and results[1][1] == {
        "started": False, "reason": "already_active"}


def test_profile_window_start_failure_reports():
    out = []
    for mod, _ in PAIRS:

        def boom(_d):
            raise RuntimeError("no profiler here")

        ctl = mod.ProfileController(log_dir="unused", start_fn=boom, stop_fn=lambda: None)
        out.append(ctl.start_window(1.0))
        assert not mod.profiler_window_active()
    assert out[0] == out[1] == {"started": False, "reason": "start_failed: no profiler here"}


def test_step_annotation_only_inside_a_window(monkeypatch):
    """Outside a window the tick annotation creates no profiler range; the
    default controller builds its torch.profiler only when a window opens."""
    import torch.profiler

    made = []

    class Spy:
        def __init__(self, name):
            made.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.profiler, "record_function", Spy)
    with ttracing.step_annotation(3):
        pass
    assert made == []
    ttracing._PROFILE_WINDOW.set()
    try:
        with ttracing.step_annotation(4):
            pass
    finally:
        ttracing._PROFILE_WINDOW.clear()
    assert made == ["bqt_tick#4"]
    ctl = ttracing.ProfileController()
    assert ctl.last_trace is None and not ctl.active
