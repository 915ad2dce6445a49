"""Structured JSONL event log for discrete operational facts.

Port of ``binquant_tpu/obs/events.py``. Every record carries ``event`` (its
kind), ``ts`` (epoch seconds), ``mono`` (``time.monotonic()``), ``seq``
(per-log sequence number), ``tick`` (the engine tick counter, advanced by
the engine once per processed tick) and the event's own fields, one JSON
object per line. The tick traces (``trace``, ``slow_tick``), the SLO plane
(``slo_burn``, ``slo_recover``), the delivery plane's ``sink_span`` and the
kernel-build ledger (``compile``, ``compile_summary``) write here.

Sinks: ``None`` disables the log (``emit`` is a cheap no-op), ``"stderr"``
or ``"-"`` writes to stderr, anything else is a file path with size-based
rotation (``path`` -> ``path.1`` once it reaches ``max_bytes``, keeping
``backups`` old files). ``emit`` never raises: a failed write, and every
emit after :meth:`EventLog.close`, is counted in ``dropped`` and in
``bqt_eventlog_dropped_total``. The process default (:func:`get_event_log`)
is disabled until a caller installs one with :func:`set_event_log`; the
port reads no environment variable for it.
"""

from __future__ import annotations

import json
import logging
import os
import sys
import threading
import time
from pathlib import Path
from typing import IO, Any

log = logging.getLogger(__name__)


class EventLog:
    def __init__(
        self,
        sink: str | Path | None = None,
        max_bytes: int = 64 * 1024 * 1024,
        backups: int = 1,
    ) -> None:
        self.max_bytes = int(max_bytes)
        self.backups = max(int(backups), 0)
        self.tick = 0
        self.dropped = 0
        self._seq = 0
        self._lock = threading.Lock()
        self._fh: IO[str] | None = None
        self._path: Path | None = None
        self._warned = False
        self._closed = False
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
            if self._closed:
                self._drop()
                return None
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
                line = json.dumps(record, default=str, separators=(",", ":"))
                fh = self._file()
                fh.write(line + "\n")
                fh.flush()
            except Exception:
                self._drop()
                if not self._warned:
                    self._warned = True
                    log.exception(
                        "event log write failed; further failures counted "
                        "in bqt_eventlog_dropped_total, not logged"
                    )
                return None
            return record

    def _drop(self) -> None:
        from binquant_tpu_torch.obs.instruments import EVENTLOG_DROPPED

        self.dropped += 1
        EVENTLOG_DROPPED.inc()

    def _file(self) -> IO[str]:
        if self._path is None:
            assert self._fh is not None  # stderr sink
            return self._fh
        if self._fh is not None and self._fh.tell() >= self.max_bytes:
            self._rotate()
        if self._fh is None:
            self._path.parent.mkdir(parents=True, exist_ok=True)
            self._fh = self._path.open("a", encoding="utf-8")
        return self._fh

    def _rotate(self) -> None:
        assert self._path is not None
        self._fh.close()  # type: ignore[union-attr]
        self._fh = None
        if self.backups <= 0:
            self._path.unlink(missing_ok=True)
            return
        # shift path.(n-1) -> path.n, ..., path -> path.1
        for i in range(self.backups, 0, -1):
            src = self._path if i == 1 else Path(f"{self._path}.{i - 1}")
            if src.exists():
                os.replace(src, f"{self._path}.{i}")

    def close(self) -> None:
        """Close a path sink. Later emits are dropped (counted in
        ``dropped`` / ``bqt_eventlog_dropped_total``) rather than silently
        reopening the file a shutdown sequence believes is closed."""
        with self._lock:
            if self._path is not None:
                self._closed = True
                if self._fh is not None:
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
