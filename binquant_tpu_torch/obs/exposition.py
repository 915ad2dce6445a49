"""Prometheus text exposition + the /metrics + /healthz HTTP endpoint.

Port of ``binquant_tpu/obs/exposition.py``. ``render_text`` turns a
:class:`~binquant_tpu_torch.obs.registry.MetricsRegistry` into Prometheus
text format 0.0.4. :class:`MetricsServer` is a small asyncio HTTP server
(stdlib only) serving:

* ``GET /metrics`` — the rendered registry;
* ``GET /healthz`` — liveness JSON from an injected callable
  (``SignalEngine.health_snapshot`` in production): HTTP 200 while the
  process is live (``status`` ``ok`` or ``degraded``) and 503 otherwise
  (``stale``), so an orchestrator can probe it directly;
* ``GET /debug/profile?seconds=N`` — opens an on-demand torch profiler
  window through an injected
  :class:`~binquant_tpu_torch.obs.tracing.ProfileController` (400 on a
  missing/invalid/out-of-range ``seconds``, 409 while a window is already
  open, a JSON no-op without a controller). It has a side effect
  (profiling overhead on the live tick loop, a trace file on disk), so it
  answers loopback peers only unless ``profile_remote_ok`` is set;
* ``GET /debug/executables`` — the kernel-build ledger
  (:data:`binquant_tpu_torch.obs.ledger.LEDGER` by default);
* ``GET /debug/symbols?offset=&limit=&prefix=&min_score=`` — the ingest
  monitor's paginated worst-first per-symbol stream-health scoreboard;
* ``GET /debug/slo`` — the unified SLO verdict
  (:meth:`binquant_tpu_torch.obs.slo.SloRegistry.snapshot`).

The read-only routes answer any peer. The handlers run inline on the
event loop: a scrape waits for the loop to be free between ticks.
``port=0`` binds an ephemeral port, reported by :meth:`MetricsServer.start`;
the engine's ``Config.metrics_port`` names the port a deployment serves.
"""

from __future__ import annotations

import asyncio
import json
import logging
from collections.abc import Callable

from binquant_tpu_torch.obs.registry import (
    REGISTRY,
    MetricFamily,
    MetricsRegistry,
    format_value,
)

CONTENT_TYPE_LATEST = "text/plain; version=0.0.4; charset=utf-8"

log = logging.getLogger(__name__)


def _escape_help(text: str) -> str:
    return text.replace("\\", r"\\").replace("\n", r"\n")


def _escape_label_value(text: str) -> str:
    return (
        text.replace("\\", r"\\").replace('"', r"\"").replace("\n", r"\n")
    )


def _label_str(names: tuple[str, ...], values: tuple[str, ...],
               extra: tuple[tuple[str, str], ...] = ()) -> str:
    pairs = [
        f'{n}="{_escape_label_value(v)}"' for n, v in zip(names, values)
    ] + [f'{n}="{_escape_label_value(v)}"' for n, v in extra]
    return "{" + ",".join(pairs) + "}" if pairs else ""


def _render_family(fam: MetricFamily, out: list[str]) -> None:
    out.append(f"# HELP {fam.name} {_escape_help(fam.documentation)}")
    out.append(f"# TYPE {fam.name} {fam.kind}")
    for key, child in sorted(fam.children()):
        if fam.kind == "histogram":
            bounds = list(fam.bucket_bounds) + [float("inf")]
            for bound, cum in zip(bounds, child.cumulative_counts()):
                labels = _label_str(
                    fam.label_names, key, extra=(("le", format_value(bound)),)
                )
                out.append(f"{fam.name}_bucket{labels} {cum}")
            base = _label_str(fam.label_names, key)
            out.append(f"{fam.name}_sum{base} {format_value(child.sum)}")
            out.append(f"{fam.name}_count{base} {child.count}")
        else:
            labels = _label_str(fam.label_names, key)
            out.append(f"{fam.name}{labels} {format_value(child.value)}")


def render_text(registry: MetricsRegistry | None = None) -> str:
    """The whole registry in Prometheus text format (trailing newline)."""
    registry = registry if registry is not None else REGISTRY
    out: list[str] = []
    for fam in registry.collect():
        _render_family(fam, out)
    return "\n".join(out) + "\n"


class MetricsServer:
    """``/metrics`` + ``/healthz`` on an asyncio socket server.

    ``health_fn`` returns the liveness JSON payload (a dict with at least
    ``status``); it runs inline on the event loop, so it must be cheap and
    non-blocking — ``SignalEngine.health_snapshot`` only reads attributes.
    """

    def __init__(
        self,
        registry: MetricsRegistry | None = None,
        health_fn: Callable[[], dict] | None = None,
        port: int = 9464,
        host: str = "0.0.0.0",
        profiler=None,
        profile_remote_ok: bool = False,
        ledger=None,
        ingest=None,
        slo=None,
    ) -> None:
        self.registry = registry if registry is not None else REGISTRY
        self.health_fn = health_fn
        self.host = host
        self.port = port
        self.profiler = profiler
        self.profile_remote_ok = profile_remote_ok
        if ledger is None:
            from binquant_tpu_torch.obs.ledger import LEDGER as ledger
        self.ledger = ledger
        # the engine's IngestHealthMonitor (GET /debug/symbols); None
        # keeps the route answering with a JSON not-configured no-op
        self.ingest = ingest
        # the engine's SloRegistry (GET /debug/slo); same no-op contract
        self.slo = slo
        self._server: asyncio.AbstractServer | None = None

    async def start(self) -> int:
        """Bind and serve; returns the bound port (resolves ``port=0``)."""
        self._server = await asyncio.start_server(
            self._handle, self.host, self.port
        )
        self.port = self._server.sockets[0].getsockname()[1]
        log.info("metrics exporter listening on %s:%d", self.host, self.port)
        return self.port

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None

    # -- request handling ---------------------------------------------------

    def _respond(self, status: int, reason: str, ctype: str, body: str) -> bytes:
        payload = body.encode("utf-8")
        head = (
            f"HTTP/1.1 {status} {reason}\r\n"
            f"Content-Type: {ctype}\r\n"
            f"Content-Length: {len(payload)}\r\n"
            "Connection: close\r\n\r\n"
        )
        return head.encode("ascii") + payload

    def _route(self, target: str, peer: tuple | None = None) -> bytes:
        path, _, query = target.partition("?")
        if path == "/debug/profile":
            return self._route_profile(query, peer)
        if path == "/debug/symbols":
            return self._route_symbols(query)
        if path == "/debug/slo":
            return self._route_slo()
        if path == "/debug/executables":
            # read-only like /metrics; snapshot() is attribute reads under
            # a lock, safe inline on the event loop
            try:
                payload = self.ledger.snapshot()
            except Exception:
                log.exception("executable-ledger snapshot crashed")
                payload = {"error": "ledger_snapshot_failed"}
            return self._respond(
                200, "OK", "application/json", json.dumps(payload)
            )
        if path == "/metrics":
            return self._respond(
                200, "OK", CONTENT_TYPE_LATEST, render_text(self.registry)
            )
        if path == "/healthz":
            if self.health_fn is None:
                payload: dict = {"status": "unknown"}
            else:
                try:
                    payload = self.health_fn()
                except Exception:
                    log.exception("health_fn crashed")
                    payload = {"status": "error"}
            # degraded = alive-but-impaired: visible in the payload (and
            # the heartbeat-failure counter) but NOT a probe failure — a
            # restart doesn't fix the underlying write failure
            ok = payload.get("status") in ("ok", "degraded")
            return self._respond(
                200 if ok else 503,
                "OK" if ok else "Service Unavailable",
                "application/json",
                json.dumps(payload),
            )
        return self._respond(404, "Not Found", "text/plain", "not found\n")

    def _route_symbols(self, query: str) -> bytes:
        """``/debug/symbols?offset=&limit=&prefix=&min_score=`` — the
        ingest monitor's worst-first per-symbol stream-health scoreboard
        Read-only, served to any peer like ``/metrics``;
        strict 400 on malformed numeric args so a typo'd probe reads as a
        typo, not as page one."""
        from urllib.parse import parse_qs

        if self.ingest is None or not getattr(self.ingest, "enabled", False):
            return self._respond(
                200, "OK", "application/json",
                json.dumps({"enabled": False, "symbols": []}),
            )
        qs = parse_qs(query)
        try:
            offset = int(qs.get("offset", ["0"])[0])
            limit = int(qs.get("limit", ["50"])[0])
            raw_min = qs.get("min_score", [None])[0]
            min_score = None if raw_min is None else float(raw_min)
        except ValueError:
            return self._respond(
                400, "Bad Request", "application/json",
                json.dumps({"error": "offset/limit must be integers, "
                            "min_score a float"}),
            )
        prefix = qs.get("prefix", [None])[0]
        try:
            payload = self.ingest.symbols_report(
                offset=offset, limit=limit, prefix=prefix,
                min_score=min_score,
            )
            payload["enabled"] = True
        except Exception:
            log.exception("ingest symbols_report crashed")
            # a broken scoreboard must not read as success to probes
            return self._respond(
                500, "Internal Server Error", "application/json",
                json.dumps({"error": "symbols_report_failed"}),
            )
        return self._respond(
            200, "OK", "application/json", json.dumps(payload)
        )

    def _route_slo(self) -> bytes:
        """``/debug/slo`` — the unified verdict: SLO burn
        states + invariant probes folded to one top-level ``ok``.
        Read-only, served to any peer like ``/metrics``. A crashed
        snapshot is a 500 — the judging surface must never read as
        passing by accident."""
        if self.slo is None or not getattr(self.slo, "enabled", False):
            return self._respond(
                200, "OK", "application/json",
                json.dumps(
                    {"enabled": False, "ok": None,
                     "slos": {}, "invariants": {}}
                ),
            )
        try:
            payload = self.slo.snapshot()
        except Exception:
            log.exception("slo snapshot crashed")
            return self._respond(
                500, "Internal Server Error", "application/json",
                json.dumps({"error": "slo_snapshot_failed"}),
            )
        return self._respond(
            200, "OK", "application/json", json.dumps(payload)
        )

    @staticmethod
    def _is_loopback(peer: tuple | None) -> bool:
        if peer is None:  # non-inet transport (tests, unix sockets)
            return True
        host = str(peer[0])
        return host in ("127.0.0.1", "::1") or host.startswith("::ffff:127.")

    def _route_profile(self, query: str, peer: tuple | None = None) -> bytes:
        """``/debug/profile?seconds=N``: open one torch profiler
        window. Arg validation is strict (400) — a typo'd probe must not
        silently start a multi-minute trace; an unavailable profiler is a
        200 no-op so probing the endpoint is always safe. The route is
        side-effectful (live profiling overhead + capture files on disk),
        so non-loopback peers are refused unless ``profile_remote_ok``."""
        from urllib.parse import parse_qs

        if not self.profile_remote_ok and not self._is_loopback(peer):
            return self._respond(
                403, "Forbidden", "application/json",
                json.dumps({"error": "profiling is loopback-only "
                            "(profile_remote_ok allows remote peers)"}),
            )
        if self.profiler is None:
            return self._respond(
                200, "OK", "application/json",
                json.dumps({"started": False, "reason": "profiler_not_configured"}),
            )
        raw = parse_qs(query).get("seconds", [])
        try:
            seconds = float(raw[0])
        except (IndexError, ValueError):
            return self._respond(
                400, "Bad Request", "application/json",
                json.dumps({"error": "seconds=N required (0 < N <= "
                            f"{self.profiler.MAX_SECONDS:g})"}),
            )
        if not (0 < seconds <= self.profiler.MAX_SECONDS):
            return self._respond(
                400, "Bad Request", "application/json",
                json.dumps({"error": "seconds out of range (0 < N <= "
                            f"{self.profiler.MAX_SECONDS:g})"}),
            )
        result = self.profiler.start_window(seconds)
        busy = result.get("reason") == "already_active"
        return self._respond(
            409 if busy else 200,
            "Conflict" if busy else "OK",
            "application/json",
            json.dumps(result),
        )

    async def _handle(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        try:
            request_line = await asyncio.wait_for(reader.readline(), timeout=5)
            parts = request_line.decode("latin-1").split()
            # drain headers, HARD-capped: a slow-drip client feeding one
            # header line per <5s would otherwise hold this task (and its
            # socket) open forever — a scraper sends a handful of lines
            for _ in range(100):
                line = await asyncio.wait_for(reader.readline(), timeout=5)
                if line in (b"\r\n", b"\n", b""):
                    break
            if len(parts) < 2 or parts[0] != "GET":
                writer.write(
                    self._respond(
                        405, "Method Not Allowed", "text/plain", "GET only\n"
                    )
                )
            else:
                peer = writer.get_extra_info("peername")
                writer.write(self._route(parts[1], peer=peer))
            await writer.drain()
        except (TimeoutError, asyncio.TimeoutError, ConnectionError, OSError):
            pass  # scraper went away (or never spoke); nothing to salvage
        except Exception:
            log.exception("metrics request handling failed")
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except Exception:
                pass
