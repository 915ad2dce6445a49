"""The port's A/B check and its legacy per-symbol backend, on the CPU.

* ``run_replay_ab(device="cpu")`` on the reference's seed-7 A/B fixture (24
  symbols, 120 ticks, capacity 64, window 200; the incremental engine and
  in-place rings on, as the reference's A/B runs them): the port's batched
  engine and its per-symbol oracle emit the same signal set, the engine
  took incremental ticks, and with the washed-out breadth all five live
  strategies fire.
* ``python -m binquant_tpu_torch --backend reference|ab`` through
  ``main(argv)``: the reference backend prints the oracle's signal count,
  ``ab`` prints ``match: True`` and exits 0, and exits 1 when the two sets
  differ (one oracle tuple taken away); the argument errors are the root
  ``main.py``'s (its "TPU backend" is the port's "batched backend"); the
  default backend is ``batch``.
"""

from __future__ import annotations

import sys

import pytest
import torch

import main as jmain
from binquant_tpu_torch import __main__ as tmain
from binquant_tpu_torch.io import replay as treplay
from binquant_tpu_torch.oracle import LIVE_STRATEGIES

torch.set_num_threads(1)

CAPACITY, WINDOW = 64, 200
WASHED_BREADTH = {
    "timestamp": [1, 2, 3],
    "market_breadth": [-0.50, -0.47, -0.44],
    "market_breadth_ma": [-0.50, -0.46],
}


@pytest.fixture(scope="module")
def replay_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("torch_ab") / "ab_7.jsonl"
    treplay.generate_replay_file(path, n_symbols=24, n_ticks=120, seed=7)
    return path


@pytest.fixture(scope="module")
def oracle_signals(replay_path):
    return treplay.run_replay_oracle(replay_path, window=WINDOW)


def _assert_match(result: dict) -> None:
    assert result["match"], {
        "only_tpu": result["only_tpu"][:5], "only_oracle": result["only_oracle"][:5]
    }
    assert result["tpu_count"] == result["oracle_count"] > 0


def test_ab_signal_sets_identical(replay_path, oracle_signals):
    result = treplay.run_replay_ab(
        replay_path, capacity=CAPACITY, window=WINDOW, incremental=True, donate=True,
        oracle_signals=oracle_signals, device="cpu",
    )
    _assert_match(result)
    stats = result["tpu_stats"]
    assert stats["device"] == "cpu"
    assert stats["incremental_ticks"] > 0 and stats["inplace_ticks"] > 0
    for name in ("activity_burst_pump", "coinrule_price_tracker", "mean_reversion_fade"):
        assert name in result["strategies"], result["strategies"]


def test_ab_with_breadth_all_five_live_strategies_engage(replay_path):
    result = treplay.run_replay_ab(
        replay_path, capacity=CAPACITY, window=WINDOW, breadth=WASHED_BREADTH,
        incremental=True, donate=True, device="cpu",
    )
    _assert_match(result)
    assert result["tpu_stats"]["incremental_ticks"] > 0
    assert result["tpu_stats"]["state_resets"] == 0
    assert sorted(result["strategies"]) == sorted(LIVE_STRATEGIES)


def test_reference_backend_prints_the_oracle_count(replay_path, oracle_signals, capsys):
    assert tmain.main(["--replay", str(replay_path), "--backend", "reference"]) == 0
    assert capsys.readouterr().out.strip() == str(
        {"backend": "reference", "signals": len(oracle_signals)}
    )


def test_ab_backend_exit_codes(replay_path, oracle_signals, monkeypatch, capsys):
    argv = ["--replay", str(replay_path), "--backend", "ab", "--device", "cpu"]
    assert tmain.main(argv) == 0
    out = capsys.readouterr().out
    assert out.splitlines()[-1] == "match: True" and "'match': True" in out
    # a forced mismatch: the oracle arm loses one of its tuples
    real = treplay.run_replay_oracle
    monkeypatch.setattr(treplay, "run_replay_oracle", lambda *a, **k: real(*a, **k)[1:])
    assert tmain.main(argv) == 1
    out = capsys.readouterr().out
    assert out.splitlines()[-1] == "match: False"
    assert f"'only_tpu': [{oracle_signals[0]!r}]" in out


@pytest.mark.parametrize("argv", [
    ["--backend", "reference"],
    ["--backend", "ab", "--scanned"],
    ["--scenario", "list", "--backend", "reference"],
    ["--backtest", "--backend", "ab", "--replay", "x.jsonl"],
])
def test_argument_errors_match_main_py(argv, monkeypatch, capsys):
    errors = []
    for run in (lambda: jmain.main(), lambda: tmain.main(argv)):
        monkeypatch.setattr(sys, "argv", ["main.py", *argv])
        with pytest.raises(SystemExit) as exc:
            run()
        err = capsys.readouterr().err
        errors.append((exc.value.code, err.strip().splitlines()[-1].split("error: ", 1)[1]))
    assert errors[1] == (errors[0][0], errors[0][1].replace("TPU backend", "batched backend"))
    assert errors[1][0] == 2


def test_default_backend_is_batch(monkeypatch, capsys):
    assert tmain.build_parser().parse_args([]).backend == "batch"
    with pytest.raises(SystemExit):
        tmain.main(["--replay", "x.jsonl", "--backend", "tpu"])  # the port has no "tpu"
    assert "invalid choice: 'tpu'" in capsys.readouterr().err
