"""Scenario-corpus runner: every scenario driven scanned AND serial
through the full engine, with the graceful-degradation invariants checked
after each run.

The port's own copy of the reference's runner (``binquant_tpu/sim/
runner.py``). Per scenario, three drives over the identical generated
stream, each on ``device`` (CUDA unless the caller asks for the CPU):

1. serial incremental (the live per-tick path),
2. scanned incremental (``process_ticks_scanned`` fused chunks),
3. serial full-recompute (``incremental=False`` — the carried path's
   in-engine oracle).

Checks: exact signal-set equality across all three; recompute-routing
reasons equal to the scenario's script (and identical between the serial
and scanned drives); zero crash-ring entries (errored traces, cold state
resets); per-bar emission dedupe holds; heartbeat live; overflow
expectations (a fire burst must overflow AND re-drive; everything else
must not); outcome parity; numeric health clean; and equality with the
pinned signal sets of ``tests/fixtures/scenario_signals.json`` — the
reference engine's own output, read here as data. The runner never writes
that file: :func:`run_corpus` repins only to a path its caller names.
"""

from __future__ import annotations

import asyncio
import json
import tempfile
from pathlib import Path

import numpy as np

from binquant_tpu_torch.engine.step import decode_ingest_digest
from binquant_tpu_torch.io.replay import make_stub_engine, signal_tuples, tick_seq
from binquant_tpu_torch.io.websocket import WsHealth
from binquant_tpu_torch.obs.events import get_event_log
from binquant_tpu_torch.sim.scenarios import SCENARIOS, Scenario, write_scenario_file

PINNED_FIXTURE = (
    Path(__file__).resolve().parents[2] / "tests" / "fixtures" / "scenario_signals.json"
)

# The engine the reference's corpus lane builds: its ``make_stub_engine``
# (the serial loop, depth 0 by default) under the ``BQT_*`` switches its
# test settings pin (``tests/conftest.py``), the settings under which the
# reference's corpus and drills pass. The port's stub defaults to the
# depth-1 production loop with every observatory on, so each knob is
# passed here; a drive or drill turns on what it scripts (the ingest
# digest of a feed-fault scenario, the SLO plane of a delivery drill).
REFERENCE_ENGINE = dict(
    pipeline_depth=0,
    incremental=False,
    donate=False,
    carry_audit_every=256,
    numeric_digest=False,
    ingest_digest=False,
    drift_meter=False,
    freshness=False,
    host_phase=False,
    slo=False,
    delivery_health=False,
    ext_invariant=False,
)


def corpus_engine(**knobs):
    """A stub engine as the reference's corpus lane and drills build it:
    :data:`REFERENCE_ENGINE` under the caller's ``knobs``."""
    return make_stub_engine(**{**REFERENCE_ENGINE, **knobs})


def drive_scenario(
    scenario: Scenario, path, *, scanned: bool, incremental: bool, device: str = "cuda"
):
    """One drive of a generated scenario stream; returns (signal tuples,
    engine) — the engine is kept for invariant introspection."""
    spec = scenario.spec
    engine = corpus_engine(
        capacity=spec.capacity,
        window=spec.window,
        breadth=spec.breadth,
        device=device,
        incremental=incremental,
        scan_chunk=spec.scan_chunk,
        enabled_strategies=set(spec.enabled_strategies),
        trace_sample=1.0,  # every tick traced: the crash-ring invariant
        # scenarios that script feed faults pin the ingest digest and its
        # monitor on (the default zero budget: any stale row burns), so the
        # staleness alarm and the cross-drive digest equality become
        # invariants
        ingest_digest=spec.ingest,
        # the signal-outcome observatory with short horizons: the scripted
        # streams' events land just past MIN_BARS near the end of the
        # stream (longer horizons would never mature), and the matured set
        # is one more cross-drive equality
        outcomes=True,
        outcome_horizons=(1, 4),
        # the corpus pins inline sink semantics (Telegram counts read right
        # after the drive); the delivery and fan-out planes have drills of
        # their own (sim/chaos.py)
        delivery=False,
        fanout=False,
    )
    # an isolated websocket tracker: the module's may carry another drill's
    # reconnect storm, which would flip this run's health to degraded
    engine.ws_health = WsHealth()
    if spec.ingest:
        # every tick's raw digest vector: the runner pins bit-identical
        # digest streams across the three drives
        engine.ingest_monitor.record_history = True
    seq = tick_seq(path)
    out: list = []

    async def go() -> None:
        if scanned:
            out.extend(await engine.process_ticks_scanned(seq))
        else:
            for now_ms, klines in seq:
                for k in klines:
                    engine.ingest(k)
                out.extend(await engine.process_tick(now_ms=now_ms))
        out.extend(await engine.flush_pending())

    asyncio.run(go())
    return signal_tuples(out), engine


def _crash_ring_entries(engine) -> int:
    """Errored entries in the engine's completed-trace ring plus cold state
    resets — the 'something went down mid-run' tally that must be zero
    after every scenario."""
    errored = sum(1 for e in engine.tracer.entries() if e["summary"].get("status") != "ok")
    return errored + engine.state_resets


def _dedupe_holds(signals: list[tuple]) -> bool:
    """Per-bar emission dedupe: at most one emission per (strategy, symbol)
    per producing tick, and no duplicated tuples at all."""
    keys = [(t, strat, sym) for t, strat, sym, *_ in signals]
    return len(keys) == len(set(keys)) and len(signals) == len(set(signals))


def run_scenario(
    name: str, workdir: str | Path, pinned: dict | None = None, device: str = "cuda"
) -> dict:
    """Generate and drive one scenario; returns the verdict dict (also
    emitted as a ``scenario_run`` event)."""
    scenario = SCENARIOS[name]
    return run_spec(scenario, workdir, pinned=pinned, device=device)


def run_spec(
    scenario: Scenario, workdir: str | Path, pinned: dict | None = None, device: str = "cuda"
) -> dict:
    """:func:`run_scenario` for a scenario given whole (a registered family
    at another shape, ``dataclasses.replace`` of its spec)."""
    spec = scenario.spec
    name = spec.name
    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    path = workdir / f"{name}.jsonl"
    lines = write_scenario_file(scenario, path)

    serial, eng_s = drive_scenario(scenario, path, scanned=False, incremental=True, device=device)
    scanned, eng_c = drive_scenario(scenario, path, scanned=True, incremental=True, device=device)
    full, eng_f = drive_scenario(scenario, path, scanned=False, incremental=False, device=device)
    engines = (eng_s, eng_c, eng_f)

    signal_set = sorted(set(serial))
    checks: dict[str, bool] = {}
    checks["serial_eq_scanned"] = set(serial) == set(scanned)
    checks["carried_eq_full_oracle"] = set(serial) == set(full)
    checks["scan_fused"] = eng_c.scanned_ticks > 0
    routing = dict(eng_s.full_recompute_reasons)
    checks["routing_matches_script"] = (
        set(routing) == set(spec.expect_routing)
        and eng_c.full_recompute_reasons == routing
        and all(routing.get(r, 0) >= n for r, n in spec.routing_min)
    )
    checks["zero_crash_ring_entries"] = sum(_crash_ring_entries(e) for e in engines) == 0
    checks["dedupe_holds"] = all(_dedupe_holds(sigs) for sigs in (serial, scanned, full))
    checks["heartbeat_live"] = all(e.health_snapshot()["status"] == "ok" for e in engines)
    if spec.expect_overflow:
        checks["overflow_script"] = eng_s.overflow_ticks >= 1 and eng_c.scan_overflow_reruns >= 1
    else:
        checks["overflow_script"] = eng_s.overflow_ticks == 0 and eng_c.scan_overflow_reruns == 0
    checks["min_signals"] = len(signal_set) >= spec.min_signals
    checks["min_telegram"] = len(eng_s._telegram_sent) >= spec.min_telegram
    checks["numeric_clean"] = all(
        e.numeric.anomaly_ticks == 0 and e.drift.alarms == 0 for e in engines
    )
    if pinned is not None and name in pinned:
        checks["pinned_signal_set"] = [list(t) for t in signal_set] == pinned[name]["signals"]
    # the matured (strategy, symbol, entry, horizon, fwd/mae/mfe) sets agree
    # across the drives: outcomes derive from the (equal) signal sets and
    # the shared stream, so a mismatch means a gather read other history
    checks["outcome_parity"] = (
        eng_s.outcomes.matured_set()
        == eng_c.outcomes.matured_set()
        == eng_f.outcomes.matured_set()
    )
    outcomes = _outcome_columns(eng_s)
    ingest = None
    if spec.ingest:
        # bit-identical per-tick ingest digests across the three drives
        ds, dc, df = (np.stack(e.ingest_monitor.digests) for e in engines)
        checks["ingest_digest_parity"] = bool(
            ds.shape == dc.shape == df.shape
            and np.array_equal(ds, dc, equal_nan=True)
            and np.array_equal(ds, df, equal_nan=True)
        )
        if spec.expect_ingest_anomaly:
            # the staleness alarm trips during the scripted fault and clears
            # after catch-up in every drive, /healthz back to ok at the end
            checks["ingest_alarm_trips_and_clears"] = all(
                e.ingest_monitor.anomaly_ticks > 0
                and e.ingest_monitor.recoveries >= 1
                and not e.ingest_monitor.burning
                and e.health_snapshot()["ingest"]["status"] == "ok"
                for e in engines
            )
        else:
            checks["ingest_quiet"] = all(e.ingest_monitor.anomaly_ticks == 0 for e in engines)
        mon = eng_s.ingest_monitor
        ingest = {
            "anomaly_ticks": mon.anomaly_ticks,
            "recoveries": mon.recoveries,
            "peak_stale_rows": int(
                max((decode_ingest_digest(d)["stale_total"] for d in ds), default=0)
            ),
        }

    verdict = {
        "scenario": name,
        "ok": all(checks.values()),
        "signals": len(signal_set),
        "telegram": len(eng_s._telegram_sent),
        "ticks": eng_s.ticks_processed,
        "lines": lines,
        "scan_chunks": eng_c.scan_chunks,
        "scanned_ticks": eng_c.scanned_ticks,
        "overflow_ticks": eng_s.overflow_ticks,
        "scan_overflow_reruns": eng_c.scan_overflow_reruns,
        "routing": routing,
        "outcomes": outcomes,
        "ingest": ingest,
        "checks": checks,
    }
    get_event_log().emit("scenario_run", **verdict)
    verdict["signal_set"] = signal_set  # not in the event: corpus pinning
    return verdict


def _outcome_columns(engine) -> dict:
    """Per-scenario outcome summary for the verdict line: matured-pair
    count plus hit rate and average MAE/MFE folded over every strategy at
    the largest matured horizon."""
    board = engine.outcomes.scoreboard()
    best_h = None
    for by_h in board["per_strategy"].values():
        for h in by_h:
            best_h = max(best_h or 0, int(h))
    if best_h is None:
        return {"matured": 0}
    n = hits = 0
    sum_mae = sum_mfe = 0.0
    for by_h in board["per_strategy"].values():
        cell = by_h.get(str(best_h))
        if not cell or not cell["n"]:
            continue
        n += cell["n"]
        hits += cell["hits"]
        sum_mae += cell["avg_mae"] * cell["n"]
        sum_mfe += cell["avg_mfe"] * cell["n"]
    return {
        "matured": board["matured"],
        "horizon": best_h,
        "n": n,
        "hit_rate": round(hits / n, 3) if n else None,
        "avg_mae": round(sum_mae / n, 5) if n else None,
        "avg_mfe": round(sum_mfe / n, 5) if n else None,
    }


def load_pinned(path: str | Path = PINNED_FIXTURE) -> dict | None:
    path = Path(path)
    if not path.exists():
        return None
    with open(path) as f:
        return json.load(f)


def _drill_events(device: str) -> list[dict]:
    """The three chaos drills as ``scenario_run`` verdicts."""
    from binquant_tpu_torch.sim.chaos import (
        delivery_chaos_drill,
        fanout_chaos_drill,
        ws_chaos_drill,
    )

    facts = ws_chaos_drill(device=device)
    ws = {
        "scenario": "chaos_drill",
        "ok": facts["ok"],
        "signals": 0,
        "ticks": facts["ticks"],
        "routing": {},
        "checks": {
            "stream_landed": facts["landed"],
            "zero_lost_candles": facts["lost_candles"] == 0,
            "engine_ticking": facts["ticks"] > 0,
            "reconnect_storm_ran": facts["reconnect_connects"] >= 3,
            "sink_faults_injected": facts["sink_faults"] > 0,
            "heartbeat_live": facts["heartbeat_live"],
        },
        "ws": facts["ws"],
    }
    # the delivery plane: sink 5xx/timeout storm, scripted breaker cycle,
    # queue-saturation burst, a kill and a restore with zero autotrade loss
    dfacts = delivery_chaos_drill(device=device)
    delivery = {
        "scenario": "delivery_drill",
        "ok": dfacts["ok"],
        "signals": dfacts["delivered_autotrade"],
        "ticks": 0,
        "routing": {},
        "checks": dfacts["checks"],
        "delivery": {
            k: dfacts[k]
            for k in (
                "oracle_autotrade", "delivered_autotrade", "lost_autotrade",
                "duplicate_keys", "unacked_at_kill", "wal_replayed",
                "breaker_transitions", "analytics_shed", "emit_ms",
            )
        },
    }
    # the fan-out plane: subscriber churn storm and a stalled consumer
    ffacts = fanout_chaos_drill(device=device)
    fanout = {
        "scenario": "fanout_drill",
        "ok": ffacts["ok"],
        "signals": ffacts["published"],
        "ticks": ffacts["ticks"],
        "routing": {},
        "checks": ffacts["checks"],
        "fanout": {
            k: ffacts[k]
            for k in (
                "published", "matched_ticks", "churn_ops", "subscriptions_live",
                "slot_capacity", "recompiles", "hub_shed", "watcher_frames",
                "sloth_dropped", "sloth_replayed", "oracle_autotrade",
                "delivered_autotrade", "emit_ms",
            )
        },
    }
    events = [ws, delivery, fanout]
    for event in events:
        get_event_log().emit("scenario_run", **event)
    return events


def run_corpus(
    names: list[str] | None = None,
    workdir: str | Path | None = None,
    include_slow: bool = True,
    repin: str | Path | None = None,
    pinned_path: str | Path = PINNED_FIXTURE,
    chaos: bool = True,
    device: str = "cuda",
) -> list[dict]:
    """Run the scenario corpus (and the three chaos drills) and compare the
    pinned signal sets. ``repin`` names a file to write the passing
    scenarios' signal sets into (merged over what it holds) instead of
    comparing; there is no default. ``workdir`` defaults to a fresh
    temporary directory."""
    workdir = Path(workdir) if workdir is not None else Path(tempfile.mkdtemp(prefix="bqt_scn_"))
    pinned = None if repin is not None else load_pinned(pinned_path)
    if names is None:
        names = [n for n, sc in SCENARIOS.items() if include_slow or not sc.spec.slow]
    verdicts = [run_scenario(n, workdir, pinned=pinned, device=device) for n in names]
    if repin is not None:
        # never pin a broken run: a scenario whose invariants failed must
        # not have its signal set kept as the golden corpus
        corpus = {
            v["scenario"]: {"signals": [list(t) for t in v["signal_set"]], "count": v["signals"]}
            for v in verdicts
            if v["ok"]
        }
        skipped = [v["scenario"] for v in verdicts if not v["ok"]]
        if skipped:
            print(f"repin SKIPPED failing scenarios: {', '.join(skipped)}")
        existing = load_pinned(repin) or {}
        existing.update(corpus)
        Path(repin).parent.mkdir(parents=True, exist_ok=True)
        with open(repin, "w") as f:
            json.dump(existing, f, indent=1, sort_keys=True)
            f.write("\n")
    if chaos:
        verdicts.extend(_drill_events(device))
    return verdicts


def render_verdict(event: dict) -> str:
    """One ``scenario_run`` event → the deterministic report line(s), the
    reference's format byte for byte."""
    checks = event.get("checks") or {}
    failed = sorted(k for k, v in checks.items() if not v)
    status = "PASS" if event.get("ok") else "FAIL"
    routing = ",".join(f"{k}={v}" for k, v in sorted((event.get("routing") or {}).items()))
    line = (
        f"{event.get('scenario', '?'):<20} {status}"
        f"  signals {event.get('signals', 0):>4}"
        f"  ticks {event.get('ticks', 0):>4}"
        f"  scan_chunks {event.get('scan_chunks', 0):>3}"
        f"  overflow {event.get('overflow_ticks', 0):>2}"
        f"  routing {routing or '-'}"
    )
    # per-family outcome columns, only when the run matured anything
    outcomes = event.get("outcomes") or {}
    if outcomes.get("matured") and outcomes.get("n"):
        line += (
            f"  outcomes h{outcomes['horizon']}"
            f" n {outcomes['n']}"
            f" hit {outcomes['hit_rate']:.3f}"
            f" mae {outcomes['avg_mae']:+.5f}"
            f" mfe {outcomes['avg_mfe']:+.5f}"
        )
    # ingest columns, only when a scenario drove with the observatory pinned
    ingest = event.get("ingest") or {}
    if ingest.get("anomaly_ticks") is not None:
        line += (
            f"  ingest anomalies {ingest['anomaly_ticks']}"
            f" recovered {ingest['recoveries']}"
            f" peak_stale {ingest['peak_stale_rows']}"
        )
    if failed:
        line += f"\n  failed: {', '.join(failed)}"
    return line


def main_cli(arg: str, device: str = "cuda") -> int:
    """``python -m binquant_tpu_torch --scenario`` entry: a scenario name,
    ``all``, or ``list``. Prints one verdict line per run; non-zero when
    any failed."""
    if arg == "list":
        for name, sc in sorted(SCENARIOS.items()):
            print(f"{name:<20} {'[slow] ' if sc.spec.slow else ''}{sc.spec.description}")
        return 0
    if arg == "all":
        verdicts = run_corpus(device=device)
    elif arg in SCENARIOS:
        workdir = tempfile.mkdtemp(prefix="bqt_scn_")
        verdicts = [run_scenario(arg, workdir, pinned=load_pinned(), device=device)]
    else:
        print(f"unknown scenario {arg!r}; try --scenario list")
        return 2
    for v in verdicts:
        print(render_verdict(v))
    return 0 if all(v["ok"] for v in verdicts) else 1
