"""Structured JSONL event log for discrete operational facts.

Port of the part of ``binquant_tpu/obs/events.py`` the outcome tracker
uses. Every record carries ``event`` (its kind), ``ts`` (epoch seconds),
``mono`` (``time.monotonic()``), ``seq`` (per-log sequence number),
``tick`` (the engine tick counter, advanced by the owner) and the event's
own fields, one JSON object per line.

Sinks: ``None`` disables the log (``emit`` is a cheap no-op), ``"stderr"``
or ``"-"`` writes to stderr, anything else is a file path appended to.
``emit`` never raises: a failed write is counted in ``dropped``. The
process default (:func:`get_event_log`) is disabled until a caller
installs one with :func:`set_event_log`; the port reads no environment
variable for it.
"""

from __future__ import annotations

import json
import sys
import threading
import time
from pathlib import Path
from typing import IO, Any


class EventLog:
    def __init__(self, sink: str | Path | None = None) -> None:
        self.tick = 0
        self.dropped = 0
        self._seq = 0
        self._lock = threading.Lock()
        self._fh: IO[str] | None = None
        self._path: Path | None = None
        if sink in (None, ""):
            self.enabled = False
        elif str(sink) in ("stderr", "-"):
            self.enabled = True
            self._fh = sys.stderr
        else:
            self.enabled = True
            self._path = Path(sink)

    def emit(self, event: str, **fields: Any) -> dict | None:
        """Write one record and return it, or None when the log is disabled
        or the write failed. Never raises."""
        if not self.enabled:
            return None
        with self._lock:
            self._seq += 1
            record = {
                "event": event,
                "ts": time.time(),
                "mono": time.monotonic(),
                "seq": self._seq,
                "tick": self.tick,
                **fields,
            }
            try:
                if self._fh is None:
                    self._path.parent.mkdir(parents=True, exist_ok=True)
                    self._fh = self._path.open("a", encoding="utf-8")
                self._fh.write(json.dumps(record, default=str, separators=(",", ":")) + "\n")
                self._fh.flush()
            except (OSError, TypeError, ValueError):
                self.dropped += 1
                return None
            return record

    def close(self) -> None:
        """Close a path sink (a later emit reopens it)."""
        with self._lock:
            if self._path is not None and self._fh is not None:
                self._fh.close()
                self._fh = None


_default_log: EventLog | None = None
_default_lock = threading.Lock()


def get_event_log() -> EventLog:
    """The process-default event log (disabled unless one was installed)."""
    global _default_log
    if _default_log is None:
        with _default_lock:
            if _default_log is None:
                _default_log = EventLog(None)
    return _default_log


def set_event_log(event_log: EventLog | None) -> None:
    """Install (or clear, with None) the process-default event log."""
    global _default_log
    with _default_lock:
        _default_log = event_log
