"""Strategy parameters: every live threshold in one NamedTuple.

Port of ``StrategyParams``, ``resolve_params`` and ``declared_gate_margins``
from ``binquant_tpu/strategies/params.py``. The port runs eagerly, so the
parameters are plain Python values (no traced-leaf carrier is needed).
"""

from __future__ import annotations

from typing import NamedTuple

from binquant_tpu_torch.strategies.activity_burst_pump import ABPParams
from binquant_tpu_torch.strategies.ladder_deployer import LadderParams
from binquant_tpu_torch.strategies.liquidation_sweep_pump import LSPParams
from binquant_tpu_torch.strategies.mean_reversion_fade import MRFParams
from binquant_tpu_torch.strategies.price_tracker import PTParams


class StrategyParams(NamedTuple):
    """The live dispatch set's tunables; the defaults are the reference's
    class constants."""

    abp: ABPParams = ABPParams()
    pt: PTParams = PTParams()
    lsp: LSPParams = LSPParams()
    mrf: MRFParams = MRFParams()
    ladder: LadderParams = LadderParams()


def resolve_params(params: StrategyParams | None) -> StrategyParams:
    """None → the defaults; an explicit StrategyParams passes through."""
    return StrategyParams() if params is None else params


def declared_gate_margins() -> dict[str, float]:
    """Per-strategy gate margins (RSI/MFI points): a fired/not-fired flip
    between two evaluations whose float32 summation orders differ is only
    admissible when the row's gated indicator sits inside this band of its
    threshold. Strategies absent here gate on bit-exact positional values."""
    return {
        "coinrule_price_tracker": 0.25,
        "mean_reversion_fade": 0.25,
        "inverse_price_tracker": 0.25,
    }
