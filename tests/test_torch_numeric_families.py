"""The numeric-health, drift and registry metric families against the
reference's.

* The families: the port's registry holds every family of the reference's
  (``bqt_numeric_*``, ``bqt_fired_rows_per_tick``, ``bqt_carry_drift*``,
  ``bqt_registry_*``, ``bqt_symbols_per_tick``, ``bqt_ws_*`` among them)
  under the same name, kind, labels and buckets (and, for the families
  above, the same help text), but the compile ledger's (``bqt_jit_recompiles_total``, ``bqt_executable_*``),
  which the port leaves out because it compiles nothing per shape.
* One small drive through both packages' engines (16 symbols, window 130,
  the incremental path with an audit every 2 ticks, the numeric digest and
  the drift meter on, the drift tolerance tiny): bulk history in the first
  tick, a clean tick, the audit, then a tick whose candle close for one
  symbol is NaN. The two ``/metrics`` renderings carry the same family
  set (less the ledger's); ``bqt_numeric_nonfinite_rows`` and
  ``bqt_registry_symbols`` and ``bqt_symbols_per_tick`` are equal,
  ``bqt_numeric_absmax`` at the wire contract, the anomaly counter and the
  fired-rows histogram moved alike; each event log holds exactly one
  ``numeric_anomaly`` and exactly one ``carry_drift_alarm`` (and one
  ``carry_drift`` record per audit).
"""

from __future__ import annotations

import asyncio
import json

import numpy as np
import pytest
import torch

from binquant_tpu.io import replay as jreplay
from binquant_tpu.obs import events as jevents
from binquant_tpu.obs.exposition import render_text as jrender
from binquant_tpu.obs.registry import REGISTRY as JREGISTRY
from binquant_tpu_torch.io import replay as treplay
from binquant_tpu_torch.obs import events as tevents
from binquant_tpu_torch.obs.exposition import render_text as trender
from binquant_tpu_torch.obs.registry import REGISTRY as TREGISTRY
from tests.conftest import make_ohlcv

torch.set_num_threads(1)

LEDGER_FAMILIES = {"bqt_jit_recompiles_total", "bqt_executable_bytes", "bqt_executable_flops"}
S_CAP, WINDOW, N_ROWS = 16, 130, 8
T0 = 1_780_272_000
C3 = ("bqt_numeric_nonfinite_rows", "bqt_numeric_absmax", "bqt_numeric_anomaly_ticks_total",
      "bqt_fired_rows_per_tick", "bqt_carry_drift", "bqt_carry_drift_ulp",
      "bqt_carry_drift_alarms_total", "bqt_registry_symbols",
      "bqt_registry_capacity_errors_total", "bqt_symbols_per_tick")
PINS = dict(trace_sample=0.0, freshness=False, host_phase=False, slo=False,
            delivery_health=False, fanout=False, delivery=False, outcomes=False,
            pipeline_depth=0, donate=False, ingest_digest=False)


def test_families_match_the_reference():
    jfams = {f.name: f for f in JREGISTRY.collect()}
    tfams = {f.name: f for f in TREGISTRY.collect()}
    assert set(jfams) - set(tfams) == LEDGER_FAMILIES
    assert set(tfams) <= set(jfams)
    for name in set(C3) | {"bqt_ws_frames_total", "bqt_ws_reconnects_total",
                           "bqt_ws_parse_errors_total"}:
        assert name in tfams, name
    for name, t in tfams.items():
        j = jfams[name]
        assert (t.kind, t.label_names, t.bucket_bounds) == (
            j.kind, j.label_names, j.bucket_bounds), name
        if name in C3 or name.startswith("bqt_ws_"):
            assert t.documentation == j.documentation, name


def _frames() -> dict:
    rng = np.random.default_rng(11)
    return {i: make_ohlcv(rng, n=WINDOW, start_price=30 + i, vol=0.006, interval_ms=900_000,
                          t0=T0 * 1000) for i in range(N_ROWS)}


def _drive(engine, frames: dict) -> None:
    """Bulk history in one tick, a clean tick, the audit tick, then the
    tick whose row 0 close is NaN; each bar feeds a 5m and a 15m candle at
    the same open."""
    names = [f"S{i:03d}" for i in range(N_ROWS)]
    for i, name in enumerate(names):
        assert engine.registry.add(name) == i

    def feed(bar: int, poison: bool = False) -> int:
        for i, name in enumerate(names):
            d = frames[i]
            base = {
                "symbol": name, "open_time": int(d["open_time"][bar]),
                "open": float(d["open"][bar]), "high": float(d["high"][bar]),
                "low": float(d["low"][bar]),
                "close": float("nan") if poison and i == 0 else float(d["close"][bar]),
                "volume": float(d["volume"][bar]),
                "quote_asset_volume": float(d["quote_asset_volume"][bar]),
                "number_of_trades": 100, "taker_buy_base_volume": 1.0,
                "taker_buy_quote_volume": 1.0,
            }
            for dur_ms in (300_000, 900_000):
                engine.ingest(dict(base, close_time=base["open_time"] + dur_ms - 1))
        return (int(frames[0]["open_time"][bar]) // 1000 + 900) * 1000

    async def go():
        for b in range(WINDOW - 3):
            now = feed(b)
        await engine.process_tick(now_ms=now)
        for b in (WINDOW - 3, WINDOW - 2):
            await engine.process_tick(now_ms=feed(b))
        await engine.process_tick(now_ms=feed(WINDOW - 1, poison=True))
        await engine.flush_pending()

    asyncio.run(go())


def _samples(text: str) -> dict:
    """family -> {sample line key: float value}."""
    kinds, out = {}, {}
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            _, _, name, kind = line.split()
            kinds[name] = kind
            out.setdefault(name, {})
        elif line and not line.startswith("#"):
            key, value = line.rsplit(" ", 1)
            name = key.split("{", 1)[0]
            for suffix in ("_bucket", "_sum", "_count"):
                if name.endswith(suffix) and kinds.get(name[: -len(suffix)]) == "histogram":
                    name = name[: -len(suffix)]
            out.setdefault(name, {})[key] = float(value)
    return out


def _moved(before: dict, after: dict, fam: str) -> dict:
    return {k: v - before.get(fam, {}).get(k, 0.0) for k, v in after.get(fam, {}).items()}


@pytest.fixture(scope="module")
def drives(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_numeric_families")
    frames = _frames()
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("BQT_NUMERIC_DIGEST", "1")
        mp.setenv("BQT_DRIFT_METER", "1")
        jeng = jreplay.make_stub_engine(capacity=S_CAP, window=WINDOW, incremental=True,
                                        carry_audit_every=2)
    teng = treplay.make_stub_engine(capacity=S_CAP, window=WINDOW, device="cpu",
                                    incremental=True, carry_audit_every=2, **PINS)
    for name, eng, events, render in (("jax", jeng, jevents, jrender),
                                      ("port", teng, tevents, trender)):
        assert eng.numeric_digest and eng.drift_meter_enabled
        eng.drift.tol = 1e-12
        log_path = tmp / f"{name}.events.jsonl"
        log = events.EventLog(log_path)
        events.set_event_log(log)
        before = _samples(render())
        try:
            _drive(eng, frames)
        finally:
            log.close()
            events.set_event_log(None)
        records = [json.loads(line) for line in log_path.read_text().splitlines()]
        out[name] = dict(engine=eng, before=before, after=_samples(render()), events=records)
    return out


def test_rendered_family_sets_equal(drives):
    j, t = drives["jax"]["after"], drives["port"]["after"]
    assert set(j) - set(t) == LEDGER_FAMILIES and set(t) <= set(j)


@pytest.mark.parametrize("family", ["bqt_numeric_nonfinite_rows", "bqt_registry_symbols",
                                    "bqt_symbols_per_tick"])
def test_gauges_equal(drives, family):
    j, t = drives["jax"]["after"][family], drives["port"]["after"][family]
    assert j and j == t


def test_absmax_at_the_wire_contract(drives):
    j, t = drives["jax"]["after"]["bqt_numeric_absmax"], drives["port"]["after"]["bqt_numeric_absmax"]
    assert j.keys() == t.keys() and len(j) >= 5
    np.testing.assert_allclose([t[k] for k in j], [j[k] for k in j], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("family", ["bqt_numeric_anomaly_ticks_total", "bqt_fired_rows_per_tick"])
def test_counters_moved_alike(drives, family):
    moved = [_moved(drives[p]["before"], drives[p]["after"], family) for p in ("jax", "port")]
    assert moved[0] == moved[1]
    if family == "bqt_numeric_anomaly_ticks_total":
        assert moved[1] == {family: 1.0}


def test_drift_families_set_alike(drives):
    for fam in ("bqt_carry_drift", "bqt_carry_drift_ulp", "bqt_carry_drift_alarms_total"):
        keys = [set(_moved(drives[p]["before"], drives[p]["after"], fam)) for p in ("jax", "port")]
        assert keys[0] == keys[1] and keys[1], fam


@pytest.mark.parametrize("event,count", [("numeric_anomaly", 1), ("carry_drift_alarm", 1),
                                         ("carry_drift", 1)])
def test_events_equal(drives, event, count):
    got = [[e for e in drives[p]["events"] if e["event"] == event] for p in ("jax", "port")]
    assert len(got[0]) == len(got[1]) == count
    if event == "numeric_anomaly":
        j, t = got[0][0], got[1][0]
        assert j["leakage_rows"] == t["leakage_rows"] > 0
        assert j["digest"]["nan_rows"] == t["digest"]["nan_rows"]
        assert "queue_depth" in t["engine"]
    if event == "carry_drift_alarm":
        assert got[0][0]["families"] == got[1][0]["families"]
