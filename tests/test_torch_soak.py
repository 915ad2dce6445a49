"""The port's soak observatory (``binquant_tpu_torch/soak/``) against the
reference's (``binquant_tpu/soak/``) on the CPU.

* The judge: every case of ``tests/test_soak.py``'s judge tests (plane
  mapping, attribution inside and outside a window, non-vacuity by burn
  and by probe, recovery-overlap credit, episode continuity across a kill
  and restore, a restore healing a silent episode, burning at the end,
  probe-failure attribution, the duplicate-ack latch, phase windows) is
  scripted once and run through both packages — the judge and the SLO
  registry of each — with equal verdicts.
* The stream: ``kucoin_frame``, ``synthetic_klines``, ``merge_streams`` and
  the fault schedule equal the reference's; the KuCoin stream round-trips
  through the port's connector field for field, and equals what the
  reference's connector gives; the soak's composed two-exchange stream is
  byte for byte the reference's.
* ``slow``: ``soak_drill(full=False)`` through both packages, the port's
  engines on the CPU: the same checks, all green, and an ok verdict.
"""

from __future__ import annotations

import json
import types
from pathlib import Path

import pytest
import torch

import binquant_tpu.soak as rsoak
import binquant_tpu_torch.soak as psoak
from binquant_tpu.io.delivery import DeliveryWal as RefWal
from binquant_tpu.obs.slo import SloRegistry as RefRegistry
from binquant_tpu.soak import drill as rdrill
from binquant_tpu.soak import stream as rstream
from binquant_tpu_torch.io.delivery import DeliveryWal as PortWal
from binquant_tpu_torch.obs.slo import SloRegistry as PortRegistry
from binquant_tpu_torch.soak import drill as pdrill
from binquant_tpu_torch.soak import stream as pstream

torch.set_num_threads(1)

PKGS = {
    "reference": types.SimpleNamespace(soak=rsoak, SloRegistry=RefRegistry, DeliveryWal=RefWal),
    "port": types.SimpleNamespace(soak=psoak, SloRegistry=PortRegistry, DeliveryWal=PortWal),
}


def _judge(ns, *windows, registry=None, probe_every=2):
    judge = ns.soak.SoakJudge(ns.soak.FaultSchedule(list(windows)), probe_every=probe_every)
    judge.attach(registry if registry is not None else ns.SloRegistry(enabled=True))
    return judge


def _burn(judge, slo, burn_obs, entering=True):
    judge.on_event("slo_burn", {"slo": slo, "burn_obs": burn_obs, "entering": entering})


def case_plane_of(ns, tmp_path):
    names = ["freshness", "staleness", "ingest_digest", "delivery.autotrade",
             "delivery_zero_loss", "delivery_zero_duplicate", "delivery_breakers_closed",
             "delivery.fanout", "fanout_recipient_set", "signal_parity", "outcome_parity",
             "ext_parity", "something_else"]
    return {n: ns.soak.plane_of(n) for n in names}


def case_breach_inside_window(ns, tmp_path):
    W = ns.soak.FaultWindow
    judge = _judge(ns, W("outage", "feed_outage", 5, 10, may=("freshness",),
                         expect=("freshness",)))
    judge.note_tick(6)
    _burn(judge, "freshness", 1)
    judge.note_tick(9)
    judge.on_event("slo_recover", {"slo": "freshness", "burn_obs": 3})
    judge.finish()
    return judge.verdict()


def case_breach_outside_window(ns, tmp_path):
    judge = _judge(ns, ns.soak.FaultWindow("outage", "feed_outage", 5, 10, may=("freshness",)))
    judge.note_tick(20)
    _burn(judge, "freshness", 1)
    judge.note_tick(21)
    judge.on_event("slo_recover", {"slo": "freshness", "burn_obs": 2})
    judge.finish()
    return judge.verdict()


def case_fault_never_trips(ns, tmp_path):
    judge = _judge(ns, ns.soak.FaultWindow("quiet_outage", "feed_outage", 5, 10,
                                           expect=("staleness",)))
    judge.note_tick(11)
    judge.finish()
    return judge.verdict()


def case_probe_satisfies_non_vacuity(ns, tmp_path):
    out = []
    for ok in (True, False):
        judge = _judge(ns, ns.soak.FaultWindow("wedge", "fanout_wedge", 5, 10,
                                               may=("fanout",), probe="wedge"))
        judge.note_tick(11)
        judge.resolve_probe("wedge", ok)
        judge.finish()
        out.append(judge.verdict())
    return out


def case_overlapping_windows(ns, tmp_path):
    W = ns.soak.FaultWindow
    judge = _judge(ns, W("outage_a", "feed_outage", 5, 10, expect=("staleness",)),
                   W("outage_b", "feed_outage", 9, 15, expect=("staleness",)))
    judge.note_tick(6)
    _burn(judge, "staleness", 1)
    judge.note_tick(12)
    judge.on_event("slo_recover", {"slo": "staleness", "burn_obs": 6})
    judge.finish()
    return judge.verdict()


def _storm(ns):
    return ns.soak.FaultWindow("storm", "sink_5xx", 5, 20, may=("delivery",),
                               expect=("delivery",))


def case_episode_continues_across_kill(ns, tmp_path):
    judge = _judge(ns, _storm(ns))
    judge.note_tick(6)
    _burn(judge, "delivery.autotrade", 1)
    judge.note_tick(10)
    _burn(judge, "delivery.autotrade", 5, entering=False)
    judge.note_tick(12)
    judge.attach(ns.SloRegistry(enabled=True))
    judge.note_tick(14)
    _burn(judge, "delivery.autotrade", 2)
    judge.note_tick(16)
    judge.on_event("slo_recover", {"slo": "delivery.autotrade", "burn_obs": 4})
    judge.finish()
    return judge.verdict()


def case_restore_heals_silent_episode(ns, tmp_path):
    judge = _judge(ns, _storm(ns))
    judge.note_tick(6)
    _burn(judge, "delivery.autotrade", 1)
    judge.note_tick(12)
    judge.attach(ns.SloRegistry(enabled=True))
    judge.note_tick(18)
    judge.finish()
    return judge.verdict()


def case_still_burning_at_end(ns, tmp_path):
    judge = _judge(ns, _storm(ns))
    judge.note_tick(6)
    _burn(judge, "delivery.autotrade", 1)
    judge.note_tick(19)
    judge.finish()
    return judge.verdict()


def case_probe_failure_attribution(ns, tmp_path):
    out = []
    for tick, invariant in ((6, "delivery_breakers_closed"), (30, "delivery_zero_loss")):
        judge = _judge(ns, ns.soak.FaultWindow("storm", "sink_5xx", 5, 10, may=("delivery",)))
        judge.note_tick(tick)
        judge.on_event("invariant_probe_failed", {"invariant": invariant})
        judge.finish()
        out.append(judge.verdict())
    return out


def case_duplicate_ack_latch(ns, tmp_path):
    wal = ns.DeliveryWal(tmp_path / "wal.jsonl", fsync=False, compact_every=0)
    registry = ns.SloRegistry(enabled=True)
    registry.add_invariant(
        "delivery_zero_duplicate", lambda: {"ok": wal.dup_acks == 0, "dup_acks": wal.dup_acks}
    )
    schedule = ns.soak.FaultSchedule(
        [ns.soak.FaultWindow("storm", "sink_5xx", 0, 10, may=("delivery",))]
    )
    judge = ns.soak.SoakJudge(schedule, probe_every=2)
    judge.attach(registry)
    judge.install()
    try:
        judge.note_tick(0)
        wal.append_put("e1", "autotrade", {"p": 1})
        wal.append_ack("e1", "autotrade")
        wal.append_ack("e1", "autotrade")  # the injected duplicate
        dup = wal.dup_acks
        judge.note_tick(12)  # the cadence probe catches it, no fault active
        wal.dup_acks = 0  # a transient that heals before shutdown
        judge.note_tick(14)
        judge.finish()
    finally:
        judge.uninstall()
        wal.close()
    return {"dup": dup, "end_state": registry.verdict(), "verdict": judge.verdict()}


def case_phase_windows(ns, tmp_path):
    registry = ns.SloRegistry(enabled=True, event_every=4)
    registry.register("freshness", "latency", 100.0)
    for phase, oks in (("clear", [True]), ("pulse_outage", [False, False]), ("clear", [True])):
        registry.begin_phase(phase)
        for ok in oks:
            registry.observe("freshness", ok=ok)
    return registry.verdict()["slos"]["freshness"]


CASES = {name[len("case_"):]: fn for name, fn in dict(globals()).items()
         if name.startswith("case_")}
# what tests/test_soak.py asserts of each case's verdict, held here too
OK = {
    "breach_inside_window": True, "breach_outside_window": False,
    "fault_never_trips": False, "overlapping_windows": True,
    "episode_continues_across_kill": True, "restore_heals_silent_episode": True,
    "still_burning_at_end": False,
}


def _jsonable(x):
    return json.loads(json.dumps(x, sort_keys=True, default=repr))


@pytest.mark.parametrize("case", sorted(CASES))
def test_judge_case_equal_through_both_packages(case, tmp_path):
    got = {}
    for pkg, ns in PKGS.items():
        (tmp_path / pkg).mkdir()
        got[pkg] = _jsonable(CASES[case](ns, tmp_path / pkg))
    assert got["port"] == got["reference"]
    port = got["port"]
    if case in OK:
        assert port["ok"] is OK[case]
    elif case in ("probe_satisfies_non_vacuity", "probe_failure_attribution"):
        assert [v["ok"] for v in port] == [True, False]
    elif case == "duplicate_ack_latch":
        assert port["dup"] == 1 and port["end_state"]["ok"] is False
        assert port["verdict"]["ok"] is False and len(port["verdict"]["unattributed"]) == 1
    elif case == "phase_windows":
        assert port["phases"]["pulse_outage"] == {"observations": 2, "breaches": 2}
    else:
        assert port["something_else"] == "other" and port["delivery.fanout"] == "fanout"


def test_fault_schedule_equal():
    for n_ticks in (112, 224):
        a, b = rdrill.fault_schedule(n_ticks), pdrill.fault_schedule(n_ticks)
        assert [vars(w) for w in a.windows] == [vars(w) for w in b.windows]
        assert len(b.windows) == 9 and len({w.kind for w in b.windows}) == 8
        for tick in range(n_ticks):
            assert a.phase_label(tick) == b.phase_label(tick)


def test_kucoin_frames_and_synthetic_klines_equal():
    names = ["K001USDT", "K002USDT", "BTCUSDT"]
    a, b = rstream.synthetic_klines(names, 5, seed=3), pstream.synthetic_klines(names, 5, seed=3)
    assert a == b and len(b) == 5 * 3 * 4
    assert [rstream.kucoin_frame(k) for k in a] == [pstream.kucoin_frame(k) for k in b]
    assert pstream.kucoin_symbol("K001USDT") == "K001-USDT" == rstream.kucoin_symbol("K001USDT")


def test_kucoin_stream_round_trips_through_the_port_connector():
    src = pstream.synthetic_klines(["AAAUSDT", "BBBUSDT"], 3)
    out = pstream.kucoin_scenario_stream(src)
    assert len(out) == len(src)
    assert all(k["exchange"] == "kucoin" for k in out)

    def key(k):
        return (k["symbol"], int(k["open_time"]), int(k["close_time"]))

    got = {key(k): k for k in out}
    assert set(got) == {key(k) for k in src}
    for k in src:
        parsed = got[key(k)]
        for field in ("open", "high", "low", "close", "volume", "quote_asset_volume"):
            assert parsed[field] == pytest.approx(k[field]), field
    assert out == rstream.kucoin_scenario_stream(src)


def test_merge_streams_bytes_equal(tmp_path):
    a = pstream.synthetic_klines(["AAAUSDT"], 4, seed=1)
    b = pstream.synthetic_klines(["BBBUSDT", "CCCUSDT"], 4, seed=2)
    for k in b[:6]:
        k["_deliver_bucket"] = int(k["open_time"]) // 1000 // 900 + 2
    n_ref = rstream.merge_streams(tmp_path / "ref.jsonl", a, b)
    n_port = pstream.merge_streams(tmp_path / "port.jsonl", a, b)
    assert n_ref == n_port == len(a) + len(b)
    assert (tmp_path / "ref.jsonl").read_bytes() == (tmp_path / "port.jsonl").read_bytes()


def test_soak_stream_bytes_equal(tmp_path):
    (tmp_path / "ref").mkdir()
    (tmp_path / "port").mkdir()
    pa, na, sa = rdrill.build_soak_stream(tmp_path / "ref", 112, 12, 3)
    pb, nb, sb = pdrill.build_soak_stream(tmp_path / "port", 112, 12, 3)
    assert na == nb > 0
    assert Path(pa).read_bytes() == Path(pb).read_bytes()
    assert (sa.name, sa.n_symbols, sa.n_ticks, sa.seed) == (sb.name, sb.n_symbols,
                                                            sb.n_ticks, sb.seed)


@pytest.mark.slow
def test_soak_drill_on_the_cpu_matches_the_reference(tmp_path):
    ref = rdrill.soak_drill(workdir=str(tmp_path / "ref"), full=False)
    port = pdrill.soak_drill(workdir=str(tmp_path / "port"), full=False, device="cpu")
    assert port["ok"], port["checks"]
    assert port["checks"] == ref["checks"]
    doc = json.loads((tmp_path / "port" / "soak_verdict.json").read_text())
    assert doc["ok"] is True and doc["verdict"]["ok"] is True
    assert len(doc["verdict"]["planes"]) >= 5
    assert all(f["non_vacuous"] for f in port["verdict"]["faults"])
    assert port["unacked_at_kill"] > 0 and port["wal_replayed"] > 0
