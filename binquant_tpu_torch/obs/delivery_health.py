"""Delivery-plane health collector: close→sink-ack lag + SLO feed.

Port of ``binquant_tpu/obs/delivery_health.py``. The delivery plane moved
the sink round trips off the tick thread, so the freshness SLO measures
candle-close→**enqueue**; this collector is the ack-side consumer —
:meth:`DeliveryHealth.on_ack` is called by ``DeliveryPlane._ack`` with the
end-to-end lag of every confirmed delivery (to the FINAL successful ack,
retries and queue dwell included; replayed entries carry their original
candle-close anchor through the WAL record, so a kill-and-restore
redelivery reports the true cross-process lag):

* ``bqt_delivery_lag_ms{sink}`` — the per-sink close→ack histogram;
* a rolling per-sink sample window feeding the p99 the delivery SLO is
  judged against (``Config.delivery_slo_ms``, one ``delivery.<sink>`` SLO
  minted lazily per sink in the unified registry, ``obs/slo.py``).

The collector is ack-driven only: it adds nothing to the tick thread.
Disabled instances are no-ops.
"""

from __future__ import annotations

from collections import deque

from binquant_tpu_torch.obs.instruments import DELIVERY_LAG


def _p99(samples) -> float:
    """Nearest-rank p99 of a small sample window (no numpy on the ack
    path — workers are plain asyncio coroutines)."""
    ordered = sorted(samples)
    idx = max(int(len(ordered) * 0.99 + 0.5) - 1, 0)
    return ordered[min(idx, len(ordered) - 1)]


class DeliveryHealth:
    """Per-sink close→ack lag windows + the delivery-SLO feed."""

    def __init__(
        self,
        enabled: bool = True,
        window: int = 512,
        slo=None,
        slo_ms: float = 0.0,
    ) -> None:
        self.enabled = bool(enabled)
        self.window = max(int(window), 1)
        # the unified SloRegistry (obs/slo.py); None = lag histograms
        # only, no SLO judging
        self.slo = slo
        self.slo_ms = max(float(slo_ms), 0.0)
        self._lags: dict[str, deque] = {}
        self.acks: dict[str, int] = {}
        self.last_lag_ms: dict[str, float] = {}

    def on_ack(
        self,
        sink: str,
        lag_ms: float,
        attempts: int = 1,
        replayed: bool = False,
    ) -> None:
        """One confirmed delivery's end-to-end lag (close→final ack)."""
        if not self.enabled:
            return
        lag_ms = max(float(lag_ms), 0.0)
        DELIVERY_LAG.labels(sink=sink).observe(lag_ms)
        window = self._lags.get(sink)
        if window is None:
            window = self._lags[sink] = deque(maxlen=self.window)
        window.append(lag_ms)
        self.acks[sink] = self.acks.get(sink, 0) + 1
        self.last_lag_ms[sink] = lag_ms
        if self.slo is not None and self.slo_ms > 0:
            p99 = _p99(window)
            name = f"delivery.{sink}"
            self.slo.ensure(name, "delivery", self.slo_ms)
            self.slo.observe(
                name,
                ok=p99 <= self.slo_ms,
                sink=sink,
                p99_ms=round(p99, 3),
                lag_ms=round(lag_ms, 3),
                attempts=int(attempts),
                replayed=bool(replayed),
            )

    def p99(self, sink: str) -> float | None:
        window = self._lags.get(sink)
        return round(_p99(window), 3) if window else None

    def snapshot(self) -> dict:
        """The /healthz contribution: per-sink ack counts + lag summary
        (attribute reads + one small sort; safe inline on the event
        loop)."""
        return {
            "enabled": self.enabled,
            "slo_ms": self.slo_ms,
            "window": self.window,
            "sinks": {
                sink: {
                    "acks": self.acks.get(sink, 0),
                    "last_lag_ms": round(self.last_lag_ms.get(sink, 0.0), 3),
                    "p99_ms": self.p99(sink),
                }
                for sink in sorted(self._lags)
            },
        }
