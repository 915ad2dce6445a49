"""Strategy kernel contract: one verdict batch per strategy per tick."""

from __future__ import annotations

from typing import NamedTuple

import torch


class StrategyOutputs(NamedTuple):
    """One strategy's verdict for every symbol row this tick."""

    trigger: torch.Tensor  # (S,) bool — emit a signal for this row
    direction: torch.Tensor  # (S,) int32 — 0 LONG / 1 SHORT
    score: torch.Tensor  # (S,) f32 — local score (0 when unused)
    autotrade: torch.Tensor  # (S,) bool — device-side autotrade verdict
    stop_loss_pct: torch.Tensor  # (S,) f32 — 0 when unused
    diagnostics: dict[str, torch.Tensor]  # (S,) telemetry for host formatting


def no_signal(num_symbols: int, *, device: torch.device | str) -> StrategyOutputs:
    return StrategyOutputs(
        trigger=torch.zeros((num_symbols,), dtype=torch.bool, device=device),
        direction=torch.zeros((num_symbols,), dtype=torch.int32, device=device),
        score=torch.zeros((num_symbols,), dtype=torch.float32, device=device),
        autotrade=torch.zeros((num_symbols,), dtype=torch.bool, device=device),
        stop_loss_pct=torch.zeros((num_symbols,), dtype=torch.float32, device=device),
        diagnostics={},
    )
