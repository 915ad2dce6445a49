"""The operator tools against the port's own files.

A small CPU replay of the port at its production defaults (tracing, the
delivery plane, outcomes, the SLO plane; a freshness SLO of 1 µs so that it
burns), with the event log installed, plus the ``scenario_run`` verdict of
the port's websocket chaos drill (as ``sim/runner.py`` writes it, and a
failing copy of it), gives one event log. Then:

* the root renderers that need no package module (``trace_report``,
  ``delivery_report``, ``health_report``, ``slo_report``,
  ``latency_report``) render it with exit 0 and output;
* the root ``healthcheck.py`` passes against the port's heartbeat file and
  against its ``/healthz`` (and fails on a stale heartbeat);
* the port's ``scenario_report`` and ``outcome_report`` print the same bytes
  and exit codes as the root scripts on it.
"""

from __future__ import annotations

import asyncio
import contextlib
import importlib.util
import io
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from binquant_tpu_torch.obs import events as tevents
from binquant_tpu_torch.tools import outcome_report, scenario_report

# small shapes: extra intra-op threads only spin and crowd parallel test workers
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent


def _root_tool(name: str):
    spec = importlib.util.spec_from_file_location(f"root_tool_{name}",
                                                  ROOT / "tools" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    from binquant_tpu_torch.io import replay
    from binquant_tpu_torch.sim.chaos import ws_chaos_drill

    tmp = tmp_path_factory.mktemp("port_run")
    log = tmp / "events.jsonl"
    stream = tmp / "outcomes.jsonl"
    replay.generate_outcome_replay(stream, n_symbols=8, n_ticks=112, fire_ticks=(88, 94))
    made = []
    real = replay.make_stub_engine

    def stub(**kw):
        engine = real(**kw, freshness_slo_ms=0.001,
                      fanout_overrides={"fanout_outbox_path": str(tmp / "fanout.jsonl")})
        engine.heartbeat_path = tmp / "heartbeat"
        made.append(engine)
        return engine

    previous = tevents.get_event_log()
    event_log = tevents.EventLog(log)
    tevents.set_event_log(event_log)
    try:
        replay.make_stub_engine = stub
        stats = replay.run_replay(stream, capacity=8, window=120, device="cpu")
        facts = ws_chaos_drill(device="cpu")
        verdict = {
            "scenario": "chaos_drill", "ok": facts["ok"], "signals": 0,
            "ticks": facts["ticks"], "routing": {},
            "checks": {"stream_landed": facts["landed"],
                       "zero_lost_candles": facts["lost_candles"] == 0,
                       "engine_ticking": facts["ticks"] > 0,
                       "reconnect_storm_ran": facts["reconnect_connects"] >= 3,
                       "sink_faults_injected": facts["sink_faults"] > 0,
                       "heartbeat_live": facts["heartbeat_live"]},
            "ws": facts["ws"],
        }
        event_log.emit("scenario_run", **verdict)
        failing = dict(verdict, scenario="chaos_drill_copy", ok=False,
                       checks={**verdict["checks"], "zero_lost_candles": False})
        event_log.emit("scenario_run", **failing)
    finally:
        replay.make_stub_engine = real
        tevents.set_event_log(previous)
        close = getattr(event_log, "close", None)
        if close is not None:
            close()
    assert stats["signals"] > 0
    return {"log": log, "engine": made[0], "stats": stats}


def _run(main, argv) -> tuple[int, str]:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue()


@pytest.mark.parametrize(
    "tool", ["trace_report", "delivery_report", "health_report", "slo_report", "latency_report"]
)
def test_root_renderers_read_the_ports_event_log(port_run, tool):
    rc, text = _run(_root_tool(tool).main, [str(port_run["log"])])
    assert rc == 0 and text.strip()


def test_the_event_log_holds_what_the_renderers_read(port_run):
    import json

    kinds = {json.loads(line)["event"] for line in port_run["log"].read_text().splitlines()}
    assert {"trace", "delivery_ack", "delivery_summary", "slo_burn", "signal",
            "signal_outcome", "freshness_slo_breach", "scenario_run"} <= kinds


def test_healthcheck_passes_against_the_ports_heartbeat_and_healthz(port_run):
    from binquant_tpu_torch.obs.exposition import MetricsServer

    engine = port_run["engine"]
    engine.touch_heartbeat()
    env = {k: v for k, v in os.environ.items() if k != "BQT_METRICS_PORT"}
    env["BQT_HEARTBEAT_PATH"] = str(engine.heartbeat_path)

    def probe(extra: dict) -> subprocess.CompletedProcess:
        return subprocess.run([sys.executable, str(ROOT / "healthcheck.py")],
                              env={**env, **extra}, capture_output=True, text=True, timeout=60)

    assert probe({}).returncode == 0
    stale = probe({"BQT_HEARTBEAT_MAX_AGE": "-1"})
    assert stale.returncode == 1 and "heartbeat stale" in stale.stderr

    async def served() -> subprocess.CompletedProcess:
        server = MetricsServer(
            health_fn=lambda: engine.health_snapshot(engine.config.heartbeat_max_age_s),
            port=0, host="127.0.0.1",
        )
        port = await server.start()
        try:
            # the file check must not be what passes: point it at nothing
            proc = await asyncio.create_subprocess_exec(
                sys.executable, str(ROOT / "healthcheck.py"),
                env={**env, "BQT_METRICS_PORT": str(port),
                     "BQT_HEARTBEAT_PATH": str(port_run["log"].parent / "absent")},
                stdout=asyncio.subprocess.PIPE, stderr=asyncio.subprocess.PIPE,
            )
            out, err = await asyncio.wait_for(proc.communicate(), 60)
            return subprocess.CompletedProcess([], proc.returncode, out.decode(), err.decode())
        finally:
            await server.stop()

    via_healthz = asyncio.run(served())
    assert via_healthz.returncode == 0, via_healthz.stderr
    assert engine.health_snapshot(engine.config.heartbeat_max_age_s)["status"] == "ok"


@pytest.mark.parametrize(
    "tool, args",
    [("outcome_report", []), ("outcome_report", ["--json"]),
     ("outcome_report", ["--strategy", "mean_reversion_fade"]),
     ("outcome_report", ["--strategy", "no_such_strategy"]),
     ("scenario_report", []), ("scenario_report", ["--scenario", "chaos_drill"])],
)
def test_port_reports_print_the_root_scripts_bytes(port_run, tool, args):
    port = {"outcome_report": outcome_report, "scenario_report": scenario_report}[tool]
    argv = [str(port_run["log"]), *args]
    want = _run(_root_tool(tool).main, argv)
    got = _run(port.main, argv)
    assert got == want
    if args != ["--strategy", "no_such_strategy"]:
        assert got[1].strip()
