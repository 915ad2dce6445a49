"""MeanReversionFade — 15m RSI+Bollinger extreme fade, batched.

Port of ``binquant_tpu/strategies/mean_reversion_fade.py``: futures only,
Wilder RSI(14) from the feature pack, long = RSI<=25 ∧ close<=bb_low ∧ green,
short = RSI>=75 ∧ close>=bb_high ∧ red, 20-bar volume floor and ATR-spike
veto, an ATR-sized stop-loss pct, and per-candle emit dedupe carried as a
last-emitted open-time tensor.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from binquant_tpu_torch.enums import Direction
from binquant_tpu_torch.strategies.base import StrategyOutputs
from binquant_tpu_torch.strategies.features import FeaturePack

REASON_NONE = 0
REASON_LONG = 1
REASON_SHORT = 2
REASON_ATR_SPIKE = 3
REASON_LOW_VOLUME = 4


class MRFParams(NamedTuple):
    rsi_long_max: float = 25.0
    rsi_short_min: float = 75.0
    volume_ratio_min: float = 1.0
    atr_spike_max: float = 2.0
    atr_stop_mult: float = 2.0


def _round4(x: torch.Tensor) -> torch.Tensor:
    """``jnp.round(x, 4)``: scale, round half to even, unscale, in float32."""
    return torch.round(x * 10000.0) / 10000.0


def mean_reversion_fade(
    pack15: FeaturePack,
    is_futures: torch.Tensor,  # scalar bool
    last_emitted: torch.Tensor,  # (S,) int32 carry: open_time of last emit
    params: MRFParams = MRFParams(),
) -> tuple[StrategyOutputs, torch.Tensor]:
    p = params
    f = pack15
    rsi = f.rsi_wilder

    ready = (
        torch.isfinite(rsi)
        & torch.isfinite(f.volume_ma)
        & torch.isfinite(f.atr)
        & torch.isfinite(f.atr_ma)
    )
    atr_ok = f.atr < p.atr_spike_max * f.atr_ma
    volume_ok = f.volume >= p.volume_ratio_min * f.volume_ma
    long_setup = (rsi <= p.rsi_long_max) & (f.close <= f.bb_lower) & (f.close > f.open)
    short_setup = (rsi >= p.rsi_short_min) & (f.close >= f.bb_upper) & (f.close < f.open)

    setup = ready & atr_ok & volume_ok & (long_setup | short_setup)
    not_duplicate = last_emitted != f.open_time
    fired = setup & not_duplicate & is_futures & f.valid

    direction = torch.where(
        short_setup, int(Direction.SHORT), int(Direction.LONG)
    ).to(torch.int32)
    long_depth = torch.clamp((p.rsi_long_max - rsi) / p.rsi_long_max, min=0.0)
    short_depth = torch.clamp(
        (rsi - p.rsi_short_min) / (100.0 - p.rsi_short_min), min=0.0
    )
    score = _round4(1.0 + torch.where(short_setup, short_depth, long_depth))

    stop_pct = torch.where(f.close > 0, p.atr_stop_mult * f.atr / f.close * 100.0, 0.0)
    stop_pct = _round4(torch.clamp(stop_pct, 0.0, 101.0))

    reason = torch.where(
        ~ready,
        REASON_NONE,
        torch.where(
            ~atr_ok,
            REASON_ATR_SPIKE,
            torch.where(
                ~volume_ok,
                REASON_LOW_VOLUME,
                torch.where(
                    long_setup,
                    REASON_LONG,
                    torch.where(short_setup, REASON_SHORT, REASON_NONE),
                ),
            ),
        ),
    ).to(torch.int32)

    new_carry = torch.where(fired, f.open_time, last_emitted).to(torch.int32)
    outputs = StrategyOutputs(
        trigger=fired,
        direction=direction,
        score=torch.where(fired, score, 0.0),
        autotrade=fired,
        stop_loss_pct=torch.where(fired, stop_pct, 0.0),
        diagnostics={
            "rsi": rsi,
            "volume_ma": f.volume_ma,
            "atr": f.atr,
            "atr_ma": f.atr_ma,
            "entry_reason": reason,
            "candidate_open_time": f.open_time,
        },
    )
    return outputs, new_carry
