"""/metrics, /healthz and the debug routes against the reference.

* ``render_text`` is byte-equal to the reference's for the same scripted
  families (counters, gauges and histograms, labeled and not, label values
  needing escapes, help texts with newlines, +Inf/-Inf/NaN and integral
  values).
* Both packages' ``MetricsServer`` on 127.0.0.1:0, over the same scripted
  health payloads, SLO registry and ingest monitor, answer every route with
  the same status and body: ``/metrics``, ``/healthz`` (200 for ok and
  degraded, 503 for stale, a crashing health function), ``/debug/slo``,
  ``/debug/symbols`` (pages, a bad argument), ``/debug/profile`` (missing,
  out-of-range, a window, a busy window, no controller), 404 and 405.
* A port engine at production defaults (CPU, 32 symbols) served through
  ``MetricsServer`` and scraped between its ticks: ``bqt_signals_total``
  equals the signals it emitted, ``/healthz`` answers 200 with ``ok``,
  ``/debug/slo`` and ``/debug/symbols`` answer, ``/debug/executables``
  serves the build ledger.
"""

import asyncio
import json

import numpy as np
import pytest

from binquant_tpu.engine import buffer as jbuffer
from binquant_tpu.obs import exposition as jexp
from binquant_tpu.obs import ingest as jingest
from binquant_tpu.obs import registry as jregistry
from binquant_tpu.obs import slo as jslo
from binquant_tpu.obs import tracing as jtracing
from binquant_tpu_torch.engine import buffer as tbuffer
from binquant_tpu_torch.obs import exposition as texp
from binquant_tpu_torch.obs import ingest as tingest
from binquant_tpu_torch.obs import registry as tregistry
from binquant_tpu_torch.obs import slo as tslo
from binquant_tpu_torch.obs import tracing as ttracing


def scripted_registry(registry_mod):
    reg = registry_mod.MetricsRegistry()
    c = reg.counter("bqt_a_total", "A counter.\nSecond line \\ with slash.")
    c.inc(3)
    lc = reg.counter("bqt_b_total", "Labeled.", labels=("sink", "outcome"))
    lc.labels(sink="telegram", outcome="ok").inc(2.5)
    lc.labels(sink='we"ird\\na\nme', outcome="error").inc()
    g = reg.gauge("bqt_g", "A gauge.", labels=("slo",))
    g.labels(slo="freshness").set(float("inf"))
    g.labels(slo="delivery.autotrade").set(float("-inf"))
    g.labels(slo="staleness").set(float("nan"))
    g.labels(slo="big").set(1e16)
    g.labels(slo="frac").set(0.125)
    reg.gauge("bqt_unset", "Never set.")
    h = reg.histogram("bqt_h_ms", "A histogram.", labels=("stage",),
                      buckets=(1.0, 5.0, 25.0))
    for v in (0.5, 1.0, 3.0, 30.0, 7.25):
        h.labels(stage="wire_fetch").observe(v)
    h.labels(stage="emission").observe(2.0)
    d = reg.histogram("bqt_default_ms", "Default buckets.")
    for v in (0.1, 49.0, 5000.0, 1e6):
        d.observe(v)
    return reg


def test_render_text_byte_equal():
    j = jexp.render_text(scripted_registry(jregistry))
    t = texp.render_text(scripted_registry(tregistry))
    assert t == j
    assert 'le="+Inf"' in t and "bqt_g{slo=\"staleness\"} NaN" in t


def test_render_text_of_the_port_families():
    """Every family the port declares renders (the default registry)."""
    import binquant_tpu_torch.obs.instruments  # noqa: F401

    text = texp.render_text()
    for name in ("bqt_slow_ticks_total", "bqt_freshness_ms", "bqt_host_phase_ms",
                 "bqt_delivery_lag_ms", "bqt_slo_burning", "bqt_ingest_feed_lag_ms",
                 "bqt_full_recompute_total", "bqt_signals_total", "bqt_ticks_total",
                 "bqt_compile_seconds"):
        assert f"# TYPE {name} " in text


async def http_get(port: int, target: str, method: str = "GET") -> tuple[int, str]:
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write(f"{method} {target} HTTP/1.1\r\nHost: x\r\n\r\n".encode())
    await writer.drain()
    raw = await asyncio.wait_for(reader.read(), timeout=10)
    writer.close()
    head, _, body = raw.decode().partition("\r\n\r\n")
    return int(head.split()[1]), body


def _ingest(buffer_mod, ingest_mod):
    reg = buffer_mod.SymbolRegistry(8)
    for n in ("BTCUSDT", "ETHUSDT", "SOLUSDT"):
        reg.add(n)
    mon = ingest_mod.IngestHealthMonitor(reg, enabled=True)
    rows = np.array([0, 1, 2], np.int64)
    mon.note_applied_batch("5m", rows, np.array([600, 300, 600], np.int64),
                           np.full(3, -1, np.int64), now_ms=1.0)
    return mon


def _slo(slo_mod):
    slo = slo_mod.SloRegistry()
    slo.register("freshness", "freshness", 100.0)
    slo.observe("freshness", ok=False, worst_ms=150.0)
    slo.add_invariant("delivery_zero_loss", lambda: {"ok": True})
    return slo


ROUTES = [
    "/metrics", "/healthz", "/debug/slo", "/debug/symbols",
    "/debug/symbols?offset=1&limit=1", "/debug/symbols?limit=x",
    "/debug/symbols?prefix=so&min_score=1.0", "/debug/profile",
    "/debug/profile?seconds=0", "/debug/profile?seconds=1000",
    "/debug/profile?seconds=0.05", "/debug/profile?seconds=0.05", "/nope",
]


@pytest.mark.parametrize("status", ["ok", "degraded", "stale", "crash"])
def test_servers_answer_alike(status, monkeypatch):
    for mod in (jtracing, ttracing):
        monkeypatch.setattr(mod, "get_event_log", lambda: _NullLog())

    def health():
        if status == "crash":
            raise RuntimeError("boom")
        return {"status": status, "ticks_processed": 3}

    async def serve(exp, reg_mod, buf, ing, slo_mod, trc):
        starts = []
        ctl = trc.ProfileController(log_dir="unused", start_fn=starts.append,
                                    stop_fn=lambda: None)
        server = exp.MetricsServer(
            registry=scripted_registry(reg_mod), health_fn=health, port=0, host="127.0.0.1",
            profiler=ctl, ingest=_ingest(buf, ing), slo=_slo(slo_mod),
        )
        port = await server.start()
        out = [await http_get(port, r) for r in ROUTES]
        out.append(await http_get(port, "/metrics", method="POST"))
        bare = exp.MetricsServer(port=0, host="127.0.0.1")
        bport = await bare.start()
        out += [await http_get(bport, r) for r in ("/healthz", "/debug/slo", "/debug/symbols",
                                                    "/debug/profile?seconds=1")]
        await bare.stop()
        await server.stop()
        if ctl._stop_task is not None:
            ctl._stop_task.cancel()
            try:
                await ctl._stop_task
            except asyncio.CancelledError:
                pass
        trc._PROFILE_WINDOW.clear()
        return out, starts

    j = asyncio.run(serve(jexp, jregistry, jbuffer, jingest, jslo, jtracing))
    t = asyncio.run(serve(texp, tregistry, tbuffer, tingest, tslo, ttracing))
    assert [c for c, _ in t[0]] == [c for c, _ in j[0]]
    for route, (cj, bj), (ct, bt) in zip(ROUTES + ["POST"] + ["bare"] * 4, j[0], t[0]):
        if route.startswith("/debug/symbols") and cj == 200:
            bj, bt = json.loads(bj), json.loads(bt)
            for page in (bj, bt):
                for row in page.get("symbols", []):
                    row.pop("apply_age_s")  # wall-clock ages
        elif route.startswith("/debug/profile") and cj == 200:
            bj, bt = json.loads(bj), json.loads(bt)
        assert bt == bj, route
    codes = dict(zip(ROUTES[:2], [c for c, _ in t[0][:2]]))
    assert codes["/healthz"] == (200 if status in ("ok", "degraded") else 503)
    assert j[1] == t[1] == ["unused"]  # one window opened, the second busy


class _NullLog:
    def emit(self, *a, **k):
        return None


async def _scrape_between_ticks(engine, ticks, server_port):
    scrapes = []
    for now_ms, klines in ticks:
        for k in klines:
            engine.ingest(k)
        await engine.process_tick(now_ms=now_ms)
        scrapes.append(await asyncio.wait_for(http_get(server_port, "/metrics"), 10))
    await engine.flush_pending()
    return scrapes


def _counter_total(text: str, name: str) -> float:
    total = 0.0
    for line in text.splitlines():
        if line.startswith(name + "{") or line.startswith(name + " "):
            total += float(line.rsplit(" ", 1)[1])
    return total


def test_engine_served_and_scraped_between_ticks(tmp_path):
    from binquant_tpu_torch.io import replay as treplay
    from binquant_tpu_torch.obs.instruments import SIGNALS
    from tests.test_torch_observability import S, crash_market, tick_plan

    engine = treplay.make_stub_engine(capacity=S, window=130, device="cpu",
                                      delivery_wal=str(tmp_path / "w.jsonl"))
    seq = tick_plan(engine, *crash_market())
    before = sum(c.value for _, c in SIGNALS.children())

    async def run():
        server = texp.MetricsServer(
            health_fn=engine.health_snapshot, port=0, host="127.0.0.1",
            ingest=engine.ingest_monitor, slo=engine.slo,
        )
        port = await server.start()
        scrapes = await _scrape_between_ticks(engine, seq, port)
        await engine.delivery.drain(timeout_s=30)
        routes = {r: await http_get(port, r) for r in
                  ("/healthz", "/debug/slo", "/debug/symbols?limit=3", "/debug/executables",
                   "/metrics")}
        await engine.aclose_delivery()
        await server.stop()
        return scrapes, routes

    scrapes, routes = asyncio.run(run())
    assert len(scrapes) == len(seq)
    assert all(code == 200 for code, _ in scrapes)
    total = _counter_total(routes["/metrics"][1], "bqt_signals_total")
    assert engine.signals_emitted > 0
    assert total - before == engine.signals_emitted
    code, body = routes["/healthz"]
    assert code == 200 and json.loads(body)["status"] == "ok"
    assert json.loads(routes["/debug/slo"][1])["ok"] is True
    page = json.loads(routes["/debug/symbols?limit=3"][1])
    assert page["enabled"] and page["total"] == S and len(page["symbols"]) == 3
    assert set(json.loads(routes["/debug/executables"][1])) == {"totals", "executables"}
    assert engine.tracer.last_tick_trace()["tick_seq"] == len(seq)
