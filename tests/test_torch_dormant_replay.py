"""The dormant strategy set end to end: the port's replay against the
reference's.

* ``generate_dormant_replay`` at capacity 32, window 200, with BuyTheDip,
  BBExtremeReversion and RangeBbRsiMeanReversion enabled: the reference
  emits 13 signal tuples. The port must emit the same tuples, in order, on
  the classic path (depth 0, as the reference drives it) and on the
  incremental production loop (depth 1, rings in place, digests, drift
  meter and outcomes on). The reference's incremental engine emits the
  same 13 (``tests/test_ab_parity.py`` holds it to the pandas oracle, whose
  tuples its classic engine emits too), so both drives are held to one
  reference run. Before the port evaluated dormant strategies, its replay
  emitted none of them.
* ``generate_dormant_extended_replay`` with the other six dormant
  strategies enabled (SpikeHunter's detector feeding
  RangeFailedBreakoutFade), a rising breadth series and the scripted
  dominance flags (LOSERS dominance, a domination reversal) reaching the
  step through ``HostInputs``: the tuples are equal and every one of the six
  fires.
"""

import pytest
import torch

from binquant_tpu.io import replay as jreplay
from binquant_tpu_torch.io import replay as treplay

# small shapes: extra intra-op threads only spin and crowd parallel test workers
torch.set_num_threads(1)

CAPACITY, WINDOW = 32, 200
ORACLE3 = {"coinrule_buy_the_dip", "bb_extreme_reversion", "range_bb_rsi_mean_reversion"}
EXTENDED = {
    "coinrule_twap_momentum_sniper", "coinrule_supertrend_swing_reversal",
    "coinrule_buy_low_sell_high", "inverse_price_tracker",
    "relative_strength_reversal_range", "range_failed_breakout_fade",
}
RISING_BREADTH = {
    "timestamp": [1, 2, 3, 4],
    "market_breadth": [0.30, 0.34, 0.38, 0.42],
    "market_breadth_ma": [0.30, 0.36],
}


@pytest.fixture(scope="module")
def markets(tmp_path_factory):
    d = tmp_path_factory.mktemp("dormant_replay")
    paths = {"dormant": d / "dormant.jsonl", "extended": d / "extended.jsonl"}
    treplay.generate_dormant_replay(paths["dormant"])
    treplay.generate_dormant_extended_replay(paths["extended"])
    return paths


def test_generators_write_the_reference_files(markets, tmp_path):
    for name, gen in (("dormant", jreplay.generate_dormant_replay),
                      ("extended", jreplay.generate_dormant_extended_replay)):
        ref = tmp_path / f"{name}.jsonl"
        gen(ref)
        assert ref.read_bytes() == markets[name].read_bytes(), name


@pytest.fixture(scope="module")
def reference_signals(markets):
    sig: list = []
    jreplay.run_replay(markets["dormant"], capacity=CAPACITY, window=WINDOW, collect=sig,
                       enabled_strategies=set(ORACLE3), incremental=False, donate=False)
    return sig


@pytest.mark.parametrize("path", ("classic", "incremental"))
def test_dormant_replay_signal_tuples_equal_reference(markets, reference_signals, path):
    sig: list = []
    flags = (dict(incremental=False, pipeline_depth=0, donate=False) if path == "classic"
             else dict(incremental=True))
    stats = treplay.run_replay(markets["dormant"], capacity=CAPACITY, window=WINDOW,
                               collect=sig, enabled_strategies=set(ORACLE3), device="cpu",
                               **flags)
    assert len(reference_signals) == 13
    assert {s[1] for s in reference_signals} == ORACLE3
    assert sig == reference_signals
    assert stats["signals"] == 13


def test_extended_replay_signal_tuples_equal_reference(markets):
    kw = dict(capacity=CAPACITY, window=WINDOW, enabled_strategies=set(EXTENDED),
              breadth=RISING_BREADTH, dominance_is_losers=True,
              market_domination_reversal=True, incremental=False)
    jsig: list = []
    jreplay.run_replay(markets["extended"], collect=jsig, donate=False, **kw)
    tsig: list = []
    treplay.run_replay(markets["extended"], collect=tsig, device="cpu", pipeline_depth=0,
                       donate=False, **kw)
    assert {s[1] for s in jsig} == EXTENDED
    assert tsig == jsig
