"""Production-day soak observatory.

One compressed-time full-stack drill — a two-exchange stream, nine
overlapping fault windows including a kill and a checkpoint restore —
judged concurrently by every SLO plane into a single machine-readable
verdict.

* :mod:`binquant_tpu_torch.soak.judge` — fault schedule, per-plane episode
  attribution, non-vacuity enforcement, the verdict fold;
* :mod:`binquant_tpu_torch.soak.stream` — live-format kucoin frames
  through the real connector seam, merged with the binance scenario
  stream;
* :mod:`binquant_tpu_torch.soak.drill` — the orchestrator,
  :func:`soak_drill`.
"""

from binquant_tpu_torch.soak.judge import (
    FaultSchedule,
    FaultWindow,
    SoakJudge,
    plane_of,
)
from binquant_tpu_torch.soak.stream import (
    kucoin_frame,
    kucoin_scenario_stream,
    merge_streams,
    synthetic_klines,
)

__all__ = [
    "FaultSchedule",
    "FaultWindow",
    "SoakJudge",
    "plane_of",
    "kucoin_frame",
    "kucoin_scenario_stream",
    "merge_streams",
    "synthetic_klines",
    "soak_drill",
]


def soak_drill(*args, **kwargs):
    """Lazy forwarder: importing the package does not load the engine
    stack until a drill runs."""
    from binquant_tpu_torch.soak.drill import soak_drill as _drill

    return _drill(*args, **kwargs)
