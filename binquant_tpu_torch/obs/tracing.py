"""Per-tick tracing: span trees, a slow-tick flight recorder, and an
on-demand torch profiler window.

Port of ``binquant_tpu/obs/tracing.py``. The metrics registry answers *how
often* and the histograms *how slow in aggregate*; this module answers
**why was THIS tick slow** and **which tick produced THIS order**:

* :class:`TickTrace` / :class:`Span` — one monotonic-clock span tree per
  engine tick (``trace_id`` / ``span_id`` / parent links, attributes,
  status). The engine opens the root in ``_dispatch_tick``, carries the
  trace on the ``_PendingTick`` and completes it when the tick finalizes,
  so a trace covers dispatch work, the pipeline dwell and emission.
* :class:`Tracer` — sampling (``Config.trace_sample``; a deterministic
  accumulator, no RNG, so replays trace the same ticks), a bounded ring of
  completed traces, and the **flight recorder**: a tick whose busy time
  reaches ``Config.trace_slow_ms`` (or that errored) is force-emitted to
  the event log with an engine snapshot and counted under its dominant
  stage in ``bqt_slow_ticks_total{stage}``. Every completed trace also
  lands as one ``trace`` event with its span tree inlined.
* :class:`ProfileController` — an on-demand ``torch.profiler`` window over
  the CPU and, on a card, the CUDA activities (``/debug/profile?seconds=N``
  on the metrics server), written as a Chrome trace; while a window is
  open :func:`step_annotation` wraps each tick's device dispatch in a
  ``torch.profiler.record_function`` range. Nothing here creates a
  profiler, or reads ``torch.profiler``, until a window opens.

Busy time is the sum of the root's direct children, which cover only
work: a pipelined tick's wall time includes the dwell between dispatch
and finalize. Both numbers ride the summary. Spans are host clocks only:
around an asynchronous launch they measure its issue, and no span
synchronizes the card.

Ids: a random 64-bit base per process plus a counter (two syscall-free hex
ids per span); a card engine and a CPU engine never share them. Sampling
off (``trace_sample=0``) costs nothing: ``begin_tick`` returns the shared
:data:`NULL_TRACE`, whose ``span`` / ``activate`` are no-ops.
"""

from __future__ import annotations

import asyncio
import itertools
import logging
import os
import tempfile
import threading
import time
from collections import deque
from contextlib import contextmanager
from contextvars import ContextVar
from typing import Any, Callable

from binquant_tpu_torch.obs.events import get_event_log
from binquant_tpu_torch.obs.instruments import SLOW_TICKS

log = logging.getLogger(__name__)

# Process-unique ids: a random 64-bit base plus an atomic counter.
_IDS = itertools.count(int.from_bytes(os.urandom(8), "big"))


def _next_id(hex_chars: int = 16) -> str:
    return format(next(_IDS) & ((1 << (4 * hex_chars)) - 1), f"0{hex_chars}x")


class Span:
    """One timed operation inside a tick trace."""

    __slots__ = ("name", "span_id", "parent_id", "start", "end", "attrs", "status")

    def __init__(self, name: str, parent_id: str | None) -> None:
        self.name = name
        self.span_id = _next_id(8)
        self.parent_id = parent_id
        self.start = time.perf_counter()
        self.end: float | None = None
        self.attrs: dict[str, Any] = {}
        self.status = "ok"

    def set(self, **attrs: Any) -> None:
        self.attrs.update(attrs)

    @property
    def duration_ms(self) -> float:
        end = self.end if self.end is not None else time.perf_counter()
        return (end - self.start) * 1000.0


class _NullSpan:
    __slots__ = ()

    def set(self, **attrs: Any) -> None:
        pass


class _NullTrace:
    """Shared no-op trace for unsampled ticks: every method is free."""

    __slots__ = ()
    active = False
    trace_id = None
    tick_seq = None

    @contextmanager
    def span(self, name: str, **attrs: Any):
        yield _NULL_SPAN

    def set_attr(self, **attrs: Any) -> None:
        pass

    def mark_error(self, exc: BaseException | None = None) -> None:
        pass

    def record_span(self, name: str, start: float, end: float | None = None,
                    **attrs: Any):
        return _NULL_SPAN

    @contextmanager
    def activate(self):
        yield self


_NULL_SPAN = _NullSpan()
NULL_TRACE = _NullTrace()

# The trace of the tick being dispatched/finalized: sink code (binbot REST,
# autotrade events) reads it to join its records to the producing tick.
_CURRENT: ContextVar[Any] = ContextVar("bqt_current_trace", default=None)


def current_trace():
    """The active TickTrace of the tick being processed, or None."""
    trace = _CURRENT.get()
    return trace if trace is not None and trace.active else None


def current_trace_id() -> str | None:
    trace = current_trace()
    return None if trace is None else trace.trace_id


@contextmanager
def detached():
    """Clear the current trace for work handed to another task or thread.

    A TickTrace is single-threaded (its span stack is unsynchronized);
    background work spawned while a tick's trace is active — the leverage
    calibration worker — is created under this guard so a worker thread
    cannot race the tick's span stack."""
    token = _CURRENT.set(None)
    try:
        yield
    finally:
        _CURRENT.reset(token)


class TickTrace:
    """The span tree of one engine tick (root span ``tick``).

    Spans nest via a stack: a tick's processing is sequential (dispatch,
    then finalize), though several ticks' traces can be open at once under
    pipelining (each rides its own ``_PendingTick``). A span that sees an
    exception is marked errored in the tree; only :meth:`mark_error`
    (called for exceptions that escape the tick) flags the TRACE.
    ``Tracer.complete`` deactivates the trace, so background work that
    inherited it through the context variable can no longer add spans to a
    tree that was already written.
    """

    def __init__(self, tick_seq: int, tick_ms: int | None = None) -> None:
        self.active = True
        self.trace_id = _next_id(16)
        self.tick_seq = int(tick_seq)
        self.status = "ok"
        self.root = Span("tick", None)
        if tick_ms is not None:
            self.root.attrs["tick_ms"] = int(tick_ms)
        self.spans: list[Span] = [self.root]
        self._stack: list[Span] = [self.root]

    @contextmanager
    def span(self, name: str, **attrs: Any):
        span = Span(name, self._stack[-1].span_id)
        if attrs:
            span.attrs.update(attrs)
        self.spans.append(span)
        self._stack.append(span)
        try:
            yield span
        except BaseException:
            span.status = "error"
            raise
        finally:
            span.end = time.perf_counter()
            self._stack.pop()

    def set_attr(self, **attrs: Any) -> None:
        self.root.attrs.update(attrs)

    def mark_error(self, exc: BaseException | None = None) -> None:
        """Flag the whole trace errored (force-emits on completion)."""
        self.status = "error"
        if exc is not None:
            self.root.attrs["error"] = repr(exc)

    def record_span(
        self, name: str, start: float, end: float | None = None, **attrs: Any
    ) -> Span:
        """A completed span from explicit ``perf_counter`` readings, for
        sections that already time themselves."""
        span = Span(name, self._stack[-1].span_id)
        span.start = start
        span.end = end if end is not None else time.perf_counter()
        if attrs:
            span.attrs.update(attrs)
        self.spans.append(span)
        return span

    @contextmanager
    def activate(self):
        token = _CURRENT.set(self)
        try:
            yield self
        finally:
            _CURRENT.reset(token)

    # -- completion ---------------------------------------------------------

    def finish(self) -> None:
        while len(self._stack) > 1:  # leaked span (error path): close it
            self._stack.pop().end = time.perf_counter()
        if self.root.end is None:
            self.root.end = time.perf_counter()

    def _child_index(self) -> dict[str | None, list[Span]]:
        """parent_id -> children in one pass over the span list (spans keep
        insertion order)."""
        index: dict[str | None, list[Span]] = {}
        for span in self.spans:
            if span.parent_id is not None:
                index.setdefault(span.parent_id, []).append(span)
        return index

    def children_of(self, span: Span) -> list[Span]:
        return self._child_index().get(span.span_id, [])

    def busy_ms(self) -> float:
        """Work attributable to this tick: the root's direct children."""
        return sum(s.duration_ms for s in self.children_of(self.root))

    def dominant_stage(self) -> str:
        """The top-level stage that cost the most: the label a slow tick is
        attributed to."""
        children = self.children_of(self.root)
        if not children:
            return "untracked"
        return max(children, key=lambda s: s.duration_ms).name

    def tree(self, index: dict[str | None, list[Span]] | None = None) -> dict:
        """The nested span tree, JSON-ready (inlined into trace events)."""
        index = index if index is not None else self._child_index()

        def node(span: Span) -> dict:
            out: dict[str, Any] = {
                "name": span.name,
                "span_id": span.span_id,
                "ms": round(span.duration_ms, 3),
                # offset from the root's start, ms
                "t0": round((span.start - self.root.start) * 1000.0, 3),
                "status": span.status,
            }
            if span.attrs:
                out["attrs"] = dict(span.attrs)
            kids = [node(s) for s in index.get(span.span_id, ())]
            if kids:
                out["children"] = kids
            return out

        return node(self.root)


class Tracer:
    """Per-tick trace lifecycle: sampling, the completed-trace ring, and
    the slow-tick flight recorder."""

    def __init__(
        self,
        sample: float = 1.0,
        slow_ms: float = 50.0,
        ring: int = 256,
    ) -> None:
        self.sample = max(float(sample), 0.0)
        self.slow_ms = float(slow_ms)
        self._ring: deque[dict] = deque(maxlen=max(int(ring), 1))
        self._accum = 0.0
        self._lock = threading.Lock()

    @property
    def enabled(self) -> bool:
        return self.sample > 0.0

    def begin_tick(self, tick_seq: int, tick_ms: int | None = None):
        """A TickTrace for this tick, or NULL_TRACE when sampled out.
        Sampling is a deterministic accumulator (sample=0.25 traces every
        4th tick)."""
        if not self.enabled:
            return NULL_TRACE
        self._accum += self.sample
        if self._accum < 1.0:
            return NULL_TRACE
        self._accum -= 1.0
        return TickTrace(tick_seq, tick_ms=tick_ms)

    def complete(
        self, trace, snapshot_fn: Callable[[], dict] | None = None
    ) -> dict | None:
        """Close a tick's trace: ring it, emit the ``trace`` event, and run
        the flight recorder (force-emit + ``bqt_slow_ticks_total``) when
        the busy time reached the budget or the trace errored.
        ``snapshot_fn`` is called only on a breach. Deactivates the trace;
        completing twice is a no-op."""
        if not trace.active:
            return None
        trace.active = False
        trace.finish()
        index = trace._child_index()
        stage_spans = index.get(trace.root.span_id, [])
        busy = sum(s.duration_ms for s in stage_spans)
        wall = trace.root.duration_ms
        slowest = (
            max(stage_spans, key=lambda s: s.duration_ms) if stage_spans else None
        )
        summary = {
            "trace_id": trace.trace_id,
            "tick_seq": trace.tick_seq,
            "busy_ms": round(busy, 3),
            "wall_ms": round(wall, 3),
            "status": trace.status,
            "slowest_stage": None if slowest is None else slowest.name,
            "slowest_stage_ms": (
                None if slowest is None else round(slowest.duration_ms, 3)
            ),
            "path": trace.root.attrs.get("path"),
        }
        tree = trace.tree(index)
        with self._lock:
            self._ring.append({"summary": summary, "spans": tree})
        event_log = get_event_log()
        event_log.emit("trace", **summary, spans=tree)
        if trace.status == "error" or busy >= self.slow_ms:
            stage = (
                max(stage_spans, key=lambda s: s.duration_ms).name
                if stage_spans
                else "untracked"
            )
            SLOW_TICKS.labels(stage=stage).inc()
            event_log.emit(
                "slow_tick",
                **summary,
                budget_ms=self.slow_ms,
                stage=stage,
                engine=snapshot_fn() if snapshot_fn is not None else {},
                spans=tree,
            )
        return summary

    def entries(self) -> list[dict]:
        with self._lock:
            return list(self._ring)

    def last_tick_trace(self) -> dict | None:
        """The newest completed tick's summary (the ``/healthz`` block)."""
        with self._lock:
            return dict(self._ring[-1]["summary"]) if self._ring else None


# -- the torch profiler window ------------------------------------------------

_PROFILE_WINDOW = threading.Event()


def profiler_window_active() -> bool:
    """True while an on-demand profiler window is open."""
    return _PROFILE_WINDOW.is_set()


@contextmanager
def step_annotation(step_num: int):
    """A ``torch.profiler.record_function`` range named ``bqt_tick#<n>``
    around a tick's device dispatch while a profiler window is open, so the
    trace groups each tick's launches; a no-op otherwise."""
    if not _PROFILE_WINDOW.is_set():
        yield
        return
    from torch.profiler import record_function

    with record_function(f"bqt_tick#{int(step_num)}"):
        yield


def _torch_profiler_fns(log_dir: str):
    """(start, stop) over one ``torch.profiler.profile``: CPU activities,
    plus CUDA where a card is present; ``stop`` writes the Chrome trace
    into ``log_dir`` and returns its path."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    state: dict[str, Any] = {}

    def start(directory: str) -> None:
        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        prof = profile(activities=activities)
        prof.start()
        state["prof"] = prof
        state["dir"] = directory

    def stop() -> str:
        prof = state.pop("prof")
        prof.stop()
        os.makedirs(state["dir"], exist_ok=True)
        path = os.path.join(
            state["dir"], f"bqt_trace_{os.getpid()}_{int(time.time() * 1000)}.json"
        )
        prof.export_chrome_trace(path)
        return path

    return start, stop


_AUTO = object()


def _loop_running() -> bool:
    try:
        asyncio.get_running_loop()
    except RuntimeError:
        return False
    return True


class ProfileController:
    """On-demand profiler windows.

    ``start_window(seconds)`` opens one window and schedules its close (an
    asyncio task when a loop is running — the ``/debug/profile`` handler;
    a daemon timer thread otherwise, for injected callables only: a torch
    profiler must stop on the thread that started it, so the default one
    opens only from a running event loop). One window at a time. The
    start/stop callables are injectable for tests and resolve to a
    ``torch.profiler.profile`` by default; the default stop writes a Chrome
    trace under ``log_dir`` (the temporary directory's ``bqt_profile``
    unless given), whose path ``last_trace`` keeps; ``closed`` is set when
    the window has closed.
    """

    MAX_SECONDS = 300.0

    def __init__(
        self,
        log_dir: str | None = None,
        start_fn: Any = _AUTO,
        stop_fn: Any = _AUTO,
    ) -> None:
        self.log_dir = log_dir or os.path.join(tempfile.gettempdir(), "bqt_profile")
        self._start_fn = start_fn
        self._stop_fn = stop_fn
        self._stop_task: Any = None
        self.last_trace: str | None = None
        self.closed = threading.Event()

    def _resolve(self):
        if self._start_fn is not _AUTO:
            return self._start_fn, self._stop_fn
        try:
            return _torch_profiler_fns(self.log_dir)
        except Exception:  # pragma: no cover - torch ships its profiler
            return None, None

    @property
    def active(self) -> bool:
        return _PROFILE_WINDOW.is_set()

    def start_window(self, seconds: float) -> dict:
        """Open a window for ``seconds``; returns a status dict (never
        raises: the exposition layer serves it as JSON)."""
        if _PROFILE_WINDOW.is_set():
            return {"started": False, "reason": "already_active"}
        if self._start_fn is _AUTO and not _loop_running():
            # a torch profiler must stop on the thread that started it: the
            # window closes from the event loop, never from a timer thread
            return {"started": False, "reason": "no_event_loop"}
        start, stop = self._resolve()
        if start is None:
            return {"started": False, "reason": "profiler_unavailable"}
        try:
            start(self.log_dir)
        except Exception as exc:
            log.exception("profiler start failed")
            return {"started": False, "reason": f"start_failed: {exc}"}
        _PROFILE_WINDOW.set()
        self.closed.clear()
        get_event_log().emit(
            "profile_window", seconds=float(seconds), log_dir=self.log_dir
        )

        def _close() -> None:
            try:
                if stop is not None:
                    out = stop()
                    if isinstance(out, str):
                        self.last_trace = out
            except Exception:
                log.exception("profiler stop failed")
            finally:
                _PROFILE_WINDOW.clear()
                self.closed.set()

        async def _close_later() -> None:
            try:
                await asyncio.sleep(seconds)
            finally:
                _close()

        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:
            timer = threading.Timer(seconds, _close)
            timer.daemon = True
            timer.start()
            self._stop_task = timer
        else:
            self._stop_task = loop.create_task(_close_later())
        return {
            "started": True,
            "seconds": float(seconds),
            "log_dir": self.log_dir,
        }
