"""binquant_tpu_torch — the PyTorch/CUDA port of the binquant signal engine.

A second package beside ``binquant_tpu`` (the JAX reference). It runs the
signal engine on one NVIDIA Hopper card: the live tick (ring-buffer ingest,
feature packs, market context, every strategy, the packed wire and its
digests, host emission) on the incremental path (indicator state carried
from tick to tick, resynced by full recomputes; the production default) or
the classic one, the pipelined production loop, the service around it
(backfill, checkpoints, the delivery plane and its sinks, observability,
the subscription fan-out), the multi-tick drives (scanned replay, the
time-batched backtest and parameter sweeps), and, as a service of its own
(``python -m binquant_tpu_torch``, :mod:`binquant_tpu_torch.__main__`),
the exchange websocket connectors, the REST history backfill and the
open-interest feed. The repository's one hand-written kernel (the trailing
rolling quantile, ``ops/quantile_tail.py`` + ``csrc/qtail.cu``) is the
card's implementation of ``rolling_quantile_tail``.

Device policy: entry points (``SignalEngine``, ``make_stub_engine``,
``run_replay``, ``run_backtest``, ``run_live``, the command) default to
``device="cuda"`` and raise when CUDA is absent unless the caller passes
``device="cpu"`` explicitly — a run never drops to the CPU on its own. Float32 matrix products stay in full float32 (the EWM
decay matmul ran at ``Precision.HIGHEST`` in the reference; TF32 would break
parity), so the TF32 switches are turned off here at import.
"""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

__version__ = "0.1.0"

from binquant_tpu_torch.config import Config  # noqa: E402,F401
from binquant_tpu_torch.enums import (  # noqa: E402,F401
    Direction,
    KlineInterval,
    MarketRegimeCode,
    MicroRegimeCode,
)


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for something else. A CUDA device without a visible card raises — the
    port never falls back to the CPU behind the caller's back."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "binquant_tpu_torch: CUDA is not available; pass device='cpu' "
            "to run on the CPU explicitly"
        )
    return dev
