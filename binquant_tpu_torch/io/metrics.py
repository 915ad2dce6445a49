"""Per-tick / per-stage latency tracking.

Port of ``binquant_tpu/io/metrics.py``. ``LatencyTracker`` keeps rolling
reservoirs per stage and logs p50/p99 periodically; ``health_snapshot``'s
``latency`` section and the engine's ``self.latency.stage(...)`` brackets
read it. Every ``record`` is also absorbed into the process-global
``bqt_stage_latency_ms`` histogram family
(``binquant_tpu_torch.obs.instruments.STAGE_LATENCY``) so a ``/metrics``
scrape sees the same stages: the tracker keeps the exact rolling
percentiles, the histogram the scrapeable cumulative view. Pass
``mirror=False`` to opt a tracker out.
"""

from __future__ import annotations

import logging
import time
from collections import deque
from contextlib import contextmanager

import numpy as np

from binquant_tpu_torch.obs.instruments import STAGE_LATENCY


class LatencyTracker:
    """Rolling per-stage latency histograms with periodic logging."""

    def __init__(
        self,
        window: int = 1024,
        log_every_s: float = 300.0,
        mirror: bool = True,
    ) -> None:
        self.window = window
        self.log_every_s = log_every_s
        self.mirror = mirror
        self._samples: dict[str, deque[float]] = {}
        self._last_log = time.monotonic()

    def record(self, stage: str, ms: float) -> None:
        buf = self._samples.get(stage)
        if buf is None:
            buf = self._samples[stage] = deque(maxlen=self.window)
        buf.append(float(ms))
        if self.mirror:
            STAGE_LATENCY.labels(stage=stage).observe(ms)

    @contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.record(name, (time.perf_counter() - t0) * 1000.0)

    def reset(self) -> None:
        """Drop all samples (benches reuse one tracker across phases; the
        global histogram mirror is cumulative by design and unaffected)."""
        self._samples.clear()

    def stats(self) -> dict[str, dict[str, float]]:
        out: dict[str, dict[str, float]] = {}
        for stage, buf in self._samples.items():
            if not buf:
                continue
            vals = np.asarray(buf)
            p50, p99 = np.percentile(vals, [50, 99])
            out[stage] = {
                "n": len(vals),
                "p50_ms": round(float(p50), 3),
                "p99_ms": round(float(p99), 3),
                "mean_ms": round(float(vals.mean()), 3),
                "max_ms": round(float(vals.max()), 3),
            }
        return out

    def maybe_log(self) -> bool:
        """Log the stage table at the configured cadence; True if logged."""
        now = time.monotonic()
        if now - self._last_log < self.log_every_s:
            return False
        self._last_log = now
        stats = self.stats()
        if stats:
            line = " ".join(
                f"{stage}[p50={s['p50_ms']}ms p99={s['p99_ms']}ms n={s['n']}]"
                for stage, s in sorted(stats.items())
            )
            logging.info("tick latency: %s", line)
        return True
