"""Websocket ingest health: the reconnect-storm tracker ``/healthz`` reads.

Port of :class:`WsHealth` and its process singleton :data:`WS_HEALTH` from
``binquant_tpu/io/websocket.py``. The exchange connectors that feed it
(reconnects, backoff) are not ported yet; with nothing feeding it the
``ws`` section of ``SignalEngine.health_snapshot`` answers as the
reference's does when no connector has reported: no reconnects, no client
backing off, not storming. The singleton takes the reference's default
window and threshold; the port reads no environment variable for them.
"""

from __future__ import annotations

import time
from collections import deque


class WsHealth:
    """Rolling reconnect-storm tracker surfaced as the ``ws`` section of
    ``/healthz``. Connectors report drops and recoveries; a reconnect rate
    past ``degrade_reconnects`` inside the window marks the probe
    ``degraded``, which stays HTTP 200 (alive but impaired; only ``stale``
    is 503)."""

    def __init__(
        self, window_s: float = 300.0, degrade_reconnects: int = 6
    ) -> None:
        self.window_s = float(window_s)
        self.degrade_reconnects = int(degrade_reconnects)
        self._reconnects: deque[float] = deque(maxlen=4096)
        self._backoff: dict[str, float] = {}  # "exchange/client" -> seconds

    def note_reconnect(
        self, exchange: str, client: int, backoff_s: float,
        now: float | None = None,
    ) -> None:
        self._reconnects.append(
            time.monotonic() if now is None else float(now)
        )
        self._backoff[f"{exchange}/{client}"] = float(backoff_s)

    def note_connected(self, exchange: str, client: int) -> None:
        self._backoff.pop(f"{exchange}/{client}", None)

    def reset(self) -> None:
        self._reconnects.clear()
        self._backoff.clear()

    def snapshot(self, now: float | None = None) -> dict:
        now = time.monotonic() if now is None else float(now)
        recent = sum(1 for t in self._reconnects if now - t <= self.window_s)
        return {
            "reconnects_recent": recent,
            "window_s": self.window_s,
            "degrade_reconnects": self.degrade_reconnects,
            "clients_backing_off": len(self._backoff),
            "max_backoff_s": max(self._backoff.values(), default=0.0),
            "storming": recent >= self.degrade_reconnects,
        }


# Process singleton the connectors feed and health_snapshot reads.
WS_HEALTH = WsHealth()
