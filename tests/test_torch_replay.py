"""The port's replay against the reference engine's, end to end.

Both packages generate the same 120-tick, 24-symbol replay file and drive it
through their own ``run_replay`` on the classic path at depth 0 (the port
with copied rings and no digests; capacity
64, window 200: the drive shapes of ``tests/test_ab_parity.py``), the port
on the CPU. The emitted signal tuples ``(tick_ms, strategy, symbol,
direction, autotrade)`` must be EQUAL, in order, and something must fire.
"""

import pytest
import torch

from binquant_tpu.io import replay as jreplay
from binquant_tpu_torch.io import replay as treplay

# small shapes: extra intra-op threads only spin and crowd parallel test workers
torch.set_num_threads(1)

CAPACITY, WINDOW = 64, 200


@pytest.fixture(scope="module")
def replay_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("torch_replay") / "rp_7.jsonl"
    treplay.generate_replay_file(path, n_symbols=24, n_ticks=120, seed=7)
    return path


def test_generator_writes_the_reference_file(replay_path, tmp_path):
    ref = tmp_path / "ref.jsonl"
    jreplay.generate_replay_file(ref, n_symbols=24, n_ticks=120, seed=7)
    assert ref.read_bytes() == replay_path.read_bytes()
    assert treplay.tick_seq(replay_path) == jreplay.tick_seq(ref)


def test_signal_tuples_equal_reference(replay_path):
    jax_sig: list = []
    jreplay.run_replay(
        replay_path, capacity=CAPACITY, window=WINDOW, collect=jax_sig,
        incremental=False, pipeline_depth=0,
    )
    port_sig: list = []
    stats = treplay.run_replay(
        replay_path, capacity=CAPACITY, window=WINDOW, collect=port_sig,
        device="cpu", incremental=False, pipeline_depth=0, donate=False,
        numeric_digest=False, ingest_digest=False,
    )
    assert stats["device"] == "cpu" and stats["ticks"] == 120
    assert len(jax_sig) > 0  # the crafted setups fire: not an empty-vs-empty match
    assert {s[1] for s in jax_sig} >= {"activity_burst_pump", "mean_reversion_fade"}
    assert port_sig == jax_sig
