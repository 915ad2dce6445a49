"""The legacy per-symbol backend (``--backend reference``) and the A/B
oracle: a reference-shaped evaluation over the same kline stream as the
batched engine — one symbol at a time on numpy columns, Python loops, dict
carries — that emits the same signal tuples
(:func:`binquant_tpu_torch.io.replay.run_replay_ab` holds the two to each
other)."""

from binquant_tpu_torch.oracle.evaluator import (
    DORMANT_ORACLE_EXTENDED,
    DORMANT_ORACLE_STRATEGIES,
    LIVE_STRATEGIES,
    OracleEvaluator,
)

__all__ = [
    "DORMANT_ORACLE_EXTENDED",
    "DORMANT_ORACLE_STRATEGIES",
    "LIVE_STRATEGIES",
    "OracleEvaluator",
]
