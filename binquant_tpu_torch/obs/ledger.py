"""Build ledger: every kernel the engine compiles, accounted.

The part of ``binquant_tpu/obs/ledger.py`` with a torch counterpart. The
reference listens on ``jax.monitoring`` for the compiles of its jit
executables; eager torch compiles nothing at dispatch, so the port's
compile records are its kernel builds: the qtail kernel's ``nvcc`` build of
``csrc/qtail.cu`` (``ops/quantile_tail.py``), recorded once per process at
first use as executable ``qt.build`` with its nvcc seconds and a cache
outcome of ``warm`` (the shared library for this source was reused from
the build directory) or ``cold`` (nvcc ran).

Exports keep the reference's names: ``bqt_compile_seconds{executable}``,
one ``compile`` event per record, a once-per-boot ``compile_summary``
event, and the ``GET /debug/executables`` JSON (``obs/exposition.py``).
Per-dispatch bytes and flops (the reference's ``cost_analysis`` of a
lowered executable) have no counterpart for a hand-written kernel: the
entries' ``cost`` stays null and ``cost_status`` ``"none"``.
"""

from __future__ import annotations

import threading
import time
from typing import Any

from binquant_tpu_torch.obs.events import get_event_log
from binquant_tpu_torch.obs.instruments import COMPILE_SECONDS


class ExecutableLedger:
    """Thread-safe registry of (executable, signature) build records."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._entries: dict[tuple[str, str], dict[str, Any]] = {}
        self._summary_emitted = False
        self.cache_hits = 0
        self.cache_misses = 0

    def record(
        self,
        executable: str,
        signature: str,
        seconds: float,
        cache: str,
    ) -> dict:
        """One build: ``cache`` is ``warm`` (a built library reused) or
        ``cold`` (the compiler ran). Returns the entry."""
        with self._lock:
            key = (executable, signature)
            entry = self._entries.get(key)
            if entry is None:
                entry = {
                    "executable": executable,
                    "signature": signature,
                    "compiles": 0,
                    "compile_seconds": 0.0,
                    "backend_compile_seconds": 0.0,
                    "cache": cache,
                    "cost": None,
                    "cost_status": "none",
                    "first_recorded_s": time.time(),
                    "tick": None,  # the reference's dispatching tick; a build has none
                }
                self._entries[key] = entry
            entry["compiles"] += 1
            entry["compile_seconds"] += float(seconds)
            entry["backend_compile_seconds"] += float(seconds)
            entry["cache"] = cache
            if cache == "warm":
                self.cache_hits += 1
            else:
                self.cache_misses += 1
            out = dict(entry)
        COMPILE_SECONDS.labels(executable=executable).inc(float(seconds))
        get_event_log().emit(
            "compile",
            executable=executable,
            signature=signature,
            seconds=round(float(seconds), 3),
            backend_compile_s=round(float(seconds), 3),
            cache=cache,
        )
        return out

    def snapshot(self) -> dict:
        """The ``/debug/executables`` payload (JSON-safe)."""
        with self._lock:
            entries = [dict(e) for e in self._entries.values()]
            seconds = sum(e["compile_seconds"] for e in entries)
            totals = {
                "executables": len(entries),
                "compiles": sum(e["compiles"] for e in entries),
                "compile_seconds": round(seconds, 3),
                "backend_compile_seconds_total": round(seconds, 3),
                "unattributed_compile_seconds": 0.0,
                "persistent_cache_hits": self.cache_hits,
                "persistent_cache_misses": self.cache_misses,
                "cost_pending": 0,
            }
        entries.sort(key=lambda e: -e["compile_seconds"])
        for e in entries:
            e["compile_seconds"] = round(e["compile_seconds"], 3)
            e["backend_compile_seconds"] = round(e["backend_compile_seconds"], 3)
        return {"totals": totals, "executables": entries}

    def emit_summary(self, reason: str = "startup") -> dict | None:
        """One ``compile_summary`` event per boot; later calls are
        no-ops."""
        with self._lock:
            if self._summary_emitted:
                return None
            self._summary_emitted = True
        snap = self.snapshot()
        return get_event_log().emit("compile_summary", reason=reason, **snap["totals"])

    @property
    def summary_emitted(self) -> bool:
        return self._summary_emitted


#: Process-global ledger: every kernel build records here, and
#: /debug/executables serves it.
LEDGER = ExecutableLedger()
