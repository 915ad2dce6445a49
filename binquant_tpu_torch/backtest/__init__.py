"""The time-batched backtest backend.

Port of ``binquant_tpu/backtest``: a backend beside the live tick and the
scanned drive that evaluates the FULL-recompute tick semantics over an
``(S, W+T)`` extended buffer — per-tick window views are gathers, the ABP
core runs once over the extension (the qtail kernel at ``abp_core_batch``),
and only the sequential recursions (the regime carry, the dedupe cooldowns,
the grid-policy feedback) run tick by tick. :func:`run_param_sweep` scores
a parameter grid over one stream.
"""

from binquant_tpu_torch.backtest.driver import (  # noqa: F401
    run_backtest,
    run_param_sweep,
)
from binquant_tpu_torch.backtest.kernel import (  # noqa: F401
    BACKTEST_STRATEGIES,
    backtest_chunk,
    backtest_chunk_sweep,
)
