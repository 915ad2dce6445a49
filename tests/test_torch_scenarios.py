"""The port's scenario engine (``binquant_tpu_torch/sim/``) against the
reference's (``binquant_tpu/sim/``) on the CPU.

* Streams: every one of the twelve families' ``write_scenario_file`` is
  byte for byte the reference's, and the registries carry the same specs.
* The runner: the port's ``flash_crash`` verdict — three drives (serial
  incremental, scanned, serial classic) on port engines — is ok, its
  signal set is the pinned corpus's (``tests/fixtures/scenario_signals.json``,
  the reference engine's output), its routing is ``{"cold_start": 1}`` and
  the scanned drive fused at least two chunks. The engine knobs the runner
  passes equal the reference's under the test settings it is pinned to.
* Text: ``render_verdict`` and ``main_cli("list")`` print what the
  reference's print for the same input; ``python -m binquant_tpu_torch
  --scenario`` answers through :func:`main` with the reference's argument
  errors.
* Repinning writes only the path its caller names.
* ``slow``: every non-slow corpus scenario on the port against its pinned
  signal set, every check green.
"""

from __future__ import annotations

import dataclasses
import filecmp
import inspect
import json

import pytest
import torch

from binquant_tpu.config import Config as RefConfig
from binquant_tpu.io.replay import make_stub_engine as ref_make_stub_engine
from binquant_tpu.sim import runner as rrunner
from binquant_tpu.sim import scenarios as rscn
from binquant_tpu_torch import __main__ as entry
from binquant_tpu_torch.sim import runner as prunner
from binquant_tpu_torch.sim import scenarios as pscn

torch.set_num_threads(1)

NON_SLOW = sorted(n for n, sc in pscn.SCENARIOS.items() if not sc.spec.slow)


def _spec_dict(spec) -> dict:
    return {f.name: getattr(spec, f.name) for f in dataclasses.fields(spec)}


def test_registries_carry_the_same_specs():
    assert list(pscn.SCENARIOS) == list(rscn.SCENARIOS)
    assert len(pscn.SCENARIOS) == 12
    assert len(NON_SLOW) == 11
    for name, sc in pscn.SCENARIOS.items():
        assert _spec_dict(sc.spec) == _spec_dict(rscn.SCENARIOS[name].spec), name


@pytest.mark.parametrize("name", sorted(rscn.SCENARIOS))
def test_scenario_stream_bytes_equal(name, tmp_path):
    a, b = tmp_path / "ref.jsonl", tmp_path / "port.jsonl"
    n_ref = rscn.write_scenario_file(name, a)
    n_port = pscn.write_scenario_file(pscn.SCENARIOS[name], b)
    assert n_ref == n_port > 0
    assert filecmp.cmp(a, b, shallow=False)


def test_corpus_engine_knobs_are_the_reference_lanes():
    """The runner pins every knob the reference's stub reads from its
    environment to what the reference's corpus lane runs under (this
    session's test settings), and depth 0, the reference stub's default."""
    RefConfig.reset()
    ref = RefConfig()
    knobs = prunner.REFERENCE_ENGINE
    depth = inspect.signature(ref_make_stub_engine).parameters["pipeline_depth"].default
    assert knobs["pipeline_depth"] == depth == 0
    pairs = {
        "incremental": ref.incremental_enabled,
        "donate": ref.donate_enabled,
        "carry_audit_every": ref.carry_audit_every_ticks,
        "numeric_digest": ref.numeric_digest,
        "ingest_digest": ref.ingest_digest,
        "drift_meter": ref.drift_meter,
        "freshness": ref.freshness_enabled,
        "host_phase": ref.host_phase_enabled,
        "slo": ref.slo_enabled,
        "delivery_health": ref.delivery_health_enabled,
        "ext_invariant": ref.ext_invariant,
    }
    assert {k: knobs[k] for k in pairs} == pairs
    engine = prunner.corpus_engine(capacity=8, window=96, device="cpu", delivery=False,
                                   fanout=False)
    cfg = engine.config
    assert (cfg.pipeline_depth, cfg.incremental, cfg.donate, cfg.numeric_digest,
            cfg.ingest_digest, cfg.drift_meter, cfg.slo_enabled) == (
        0, False, False, False, False, False, False)
    assert cfg.ingest_stale_budget == ref.ingest_stale_budget == 0


def test_flash_crash_verdict_on_the_cpu(tmp_path):
    verdict = prunner.run_scenario("flash_crash", tmp_path, pinned=prunner.load_pinned(),
                                   device="cpu")
    assert verdict["ok"], verdict["checks"]
    assert verdict["checks"]["pinned_signal_set"] is True
    pinned = prunner.load_pinned()["flash_crash"]
    assert [list(t) for t in verdict["signal_set"]] == pinned["signals"]
    assert verdict["signals"] == pinned["count"] >= 1
    assert verdict["routing"] == {"cold_start": 1}
    assert verdict["scan_chunks"] >= 2
    assert verdict["ticks"] == 112 and verdict["lines"] == 112 * 16 * 4
    # the reference renders the port's verdict as the port does
    event = {k: v for k, v in verdict.items() if k != "signal_set"}
    assert prunner.render_verdict(event) == rrunner.render_verdict(event)


EVENTS = {
    "pass": {"scenario": "flash_crash", "ok": True, "signals": 12, "ticks": 112,
             "scan_chunks": 4, "overflow_ticks": 0, "routing": {"cold_start": 1},
             "checks": {"serial_eq_scanned": True}},
    "fail": {"scenario": "rewrite_storm", "ok": False, "signals": 3, "ticks": 112,
             "scan_chunks": 2, "overflow_ticks": 0, "routing": {"cold_start": 1, "rewrite": 8},
             "checks": {"serial_eq_scanned": False, "dedupe_holds": True,
                        "heartbeat_live": False}},
    "outcomes": {"scenario": "pump_frenzy", "ok": True, "signals": 2, "ticks": 112,
                 "scan_chunks": 4, "overflow_ticks": 0, "routing": {"cold_start": 1},
                 "outcomes": {"matured": 3, "horizon": 4, "n": 3, "hit_rate": 0.667,
                              "avg_mae": -0.01234, "avg_mfe": 0.04321},
                 "checks": {}},
    "ingest": {"scenario": "feed_outage", "ok": True, "signals": 1, "ticks": 112,
               "scan_chunks": 3, "overflow_ticks": 0, "routing": {"cold_start": 1},
               "outcomes": {"matured": 0}, "ingest": {"anomaly_ticks": 7, "recoveries": 1,
                                                      "peak_stale_rows": 3},
               "checks": {"ingest_digest_parity": True}},
    "drill": {"scenario": "delivery_drill", "ok": True, "signals": 5, "ticks": 0,
              "routing": {}, "checks": {"zero_autotrade_loss": True}},
    "sparse": {"scenario": "x", "ok": False},
    "long_name": {"scenario": "a_scenario_name_longer_than_twenty", "ok": True,
                  "signals": 12345, "ticks": 1, "scan_chunks": 1000, "overflow_ticks": 123,
                  "routing": {"b": 2, "a": 1}, "checks": {}},
}


@pytest.mark.parametrize("case", sorted(EVENTS))
def test_render_verdict_matches_the_reference(case):
    event = EVENTS[case]
    assert prunner.render_verdict(event) == rrunner.render_verdict(event)


def test_main_cli_list_matches_the_reference(capsys):
    assert rrunner.main_cli("list") == 0
    want = capsys.readouterr().out
    assert prunner.main_cli("list") == 0
    assert capsys.readouterr().out == want
    assert want.count("\n") == 12 and "[slow]" in want


def test_main_cli_unknown_scenario_matches_the_reference(capsys):
    assert rrunner.main_cli("no_such_family") == 2
    want = capsys.readouterr().out
    assert prunner.main_cli("no_such_family", device="cpu") == 2
    assert capsys.readouterr().out == want


def test_entry_point_scenario_list(capsys):
    assert entry.main(["--scenario", "list"]) == 0
    out = capsys.readouterr().out
    assert out.splitlines()[0].startswith("bc_dirty_pressure")
    assert len(out.splitlines()) == 12


@pytest.mark.parametrize(
    "extra", [["--replay", "x.jsonl"], ["--scanned"], ["--backtest"]],
    ids=["replay", "scanned", "backtest"],
)
def test_entry_point_scenario_argument_errors(extra, capsys):
    with pytest.raises(SystemExit) as exc:
        entry.main(["--scenario", "list", *extra])
    assert exc.value.code == 2
    assert "--scenario runs the sim corpus on its own drives" in capsys.readouterr().err


def test_entry_point_scenario_takes_the_device(monkeypatch):
    seen = []
    monkeypatch.setattr(prunner, "main_cli", lambda arg, device="cuda": seen.append(
        (arg, device)) or 0)
    assert entry.main(["--scenario", "flash_crash", "--device", "cpu"]) == 0
    assert entry.main(["--scenario", "all"]) == 0
    assert seen == [("flash_crash", "cpu"), ("all", "cuda")]


def test_repin_writes_only_the_named_path(tmp_path, monkeypatch):
    """``repin`` has no default and the reference's repin switch in the
    environment does nothing: the pinned corpus is read, never written."""
    assert inspect.signature(prunner.run_corpus).parameters["repin"].default is None
    before = prunner.PINNED_FIXTURE.read_bytes()
    monkeypatch.setenv("BQT_SCENARIO_REPIN", "1")
    fake = {
        "good": {"scenario": "good", "ok": True, "signals": 1,
                 "signal_set": [(1, "mean_reversion_fade", "S001USDT", "LONG", False)]},
        "bad": {"scenario": "bad", "ok": False, "signals": 0, "signal_set": []},
    }
    runs = []

    def fake_run(name, workdir, pinned=None, device="cuda"):
        runs.append((name, pinned is None, device))
        return dict(fake[name])

    monkeypatch.setattr(prunner, "run_scenario", fake_run)
    assert prunner.run_corpus(names=["good"], chaos=False, device="cpu")[0]["ok"]
    assert runs == [("good", False, "cpu")]  # compared against the pins
    target = tmp_path / "pins" / "corpus.json"
    target.parent.mkdir()
    target.write_text(json.dumps({"old": {"signals": [], "count": 0}}))
    prunner.run_corpus(names=["good", "bad"], repin=target, chaos=False, device="cpu")
    assert runs[1:] == [("good", True, "cpu"), ("bad", True, "cpu")]
    assert json.loads(target.read_text()) == {
        "good": {"signals": [[1, "mean_reversion_fade", "S001USDT", "LONG", False]], "count": 1},
        "old": {"signals": [], "count": 0},
    }
    assert prunner.PINNED_FIXTURE.read_bytes() == before


@pytest.mark.slow
@pytest.mark.parametrize("name", NON_SLOW)
def test_corpus_scenario_on_the_cpu_equals_its_pins(name, tmp_path):
    verdict = prunner.run_scenario(name, tmp_path, pinned=prunner.load_pinned(), device="cpu")
    assert verdict["ok"], verdict["checks"]
    assert verdict["checks"]["pinned_signal_set"] is True
    spec = pscn.SCENARIOS[name].spec
    assert set(verdict["routing"]) == set(spec.expect_routing)


@pytest.mark.parametrize(
    "entry_point",
    ["run_scenario", "main_cli", "ws_chaos_drill", "delivery_chaos_drill",
     "fanout_chaos_drill", "soak_drill"],
)
def test_runs_default_to_cuda_and_raise_without_it(entry_point, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible; the no-CUDA refusal cannot be shown")
    from binquant_tpu_torch.sim import chaos
    from binquant_tpu_torch.soak import drill

    calls = {
        "run_scenario": lambda: prunner.run_scenario("flash_crash", tmp_path),
        "main_cli": lambda: prunner.main_cli("flash_crash"),
        "ws_chaos_drill": chaos.ws_chaos_drill,
        "delivery_chaos_drill": lambda: chaos.delivery_chaos_drill(workdir=str(tmp_path)),
        "fanout_chaos_drill": lambda: chaos.fanout_chaos_drill(workdir=str(tmp_path)),
        "soak_drill": lambda: drill.soak_drill(workdir=str(tmp_path)),
    }
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        calls[entry_point]()
