"""Leverage calibrator.

The port's own copy of ``binquant_tpu/io/leverage.py``: once per 15-minute
bucket, map the market regime to a per-symbol futures leverage ladder
(expensive, defensive, stressed, low-confidence or spiky: 1x; RANGE: 2x;
trends: 3x) and PUT it through ``edit_symbol`` only where it changes. It
runs on the host, in numpy, off the tick: its inputs are the wire's (3, S)
calibration rows, which the engine decodes at finalize (or, for tests and
direct use, a :class:`MarketContext`, fetched here).
"""

from __future__ import annotations

import logging
from typing import NamedTuple

import numpy as np
import torch

from binquant_tpu_torch.engine.buffer import FrozenRows, SymbolRegistry
from binquant_tpu_torch.enums import MarketRegimeCode
from binquant_tpu_torch.io.binbot import BinbotApi
from binquant_tpu_torch.regime.context import MarketContext
from binquant_tpu_torch.schemas import SymbolModel


class CalibrationInputs(NamedTuple):
    """The calibrator's per-symbol inputs, decoded from the tick's wire."""

    valid: np.ndarray  # (S,) bool
    close: np.ndarray  # (S,) f32
    atr_pct: np.ndarray  # (S,) f32
    regime: int
    stress: float
    confidence: float


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class LeverageCalibrator:
    MAX_LEVERAGE = 3
    DEFAULT_PRICE_HIGH_THRESHOLD = 500.0
    DEFAULT_STRESS_THRESHOLD = 0.7
    DEFAULT_CONFIDENCE_FLOOR = 0.5
    DEFAULT_ATR_HIGH_THRESHOLD = 0.04

    def __init__(
        self,
        binbot_api: BinbotApi,
        exchange: str,
        *,
        price_high_threshold: float = DEFAULT_PRICE_HIGH_THRESHOLD,
        stress_threshold: float = DEFAULT_STRESS_THRESHOLD,
        confidence_floor: float = DEFAULT_CONFIDENCE_FLOOR,
        atr_high_threshold: float = DEFAULT_ATR_HIGH_THRESHOLD,
    ) -> None:
        self.binbot_api = binbot_api
        self.exchange = exchange
        self.price_high_threshold = price_high_threshold
        self.stress_threshold = stress_threshold
        self.confidence_floor = confidence_floor
        self.atr_high_threshold = atr_high_threshold

    def _regime_defensive(self, regime: int) -> bool:
        return regime in (int(MarketRegimeCode.HIGH_STRESS), int(MarketRegimeCode.TRANSITIONAL))

    def _regime_leverage(self, regime: int, stress: float, confidence: float) -> int:
        if (
            self._regime_defensive(regime)
            or stress > self.stress_threshold
            or confidence < self.confidence_floor
        ):
            return 1
        if regime == int(MarketRegimeCode.RANGE):
            return 2
        if regime in (int(MarketRegimeCode.TREND_UP), int(MarketRegimeCode.TREND_DOWN)):
            return self.MAX_LEVERAGE
        return 1

    def target_leverage(
        self, close: float, atr_pct: float | None, regime: int, stress: float,
        confidence: float,
    ) -> int:
        """The decision ladder for one symbol."""
        if close >= self.price_high_threshold:
            return 1
        if atr_pct is not None and atr_pct > self.atr_high_threshold:
            return 1
        return self._regime_leverage(regime, stress, confidence)

    def target_leverage_batch(
        self,
        closes: np.ndarray,
        atr_pcts: np.ndarray,
        regime: int,
        stress: float,
        confidence: float,
    ) -> np.ndarray:
        """The ladder over all rows at once. A NaN ``atr_pct`` means
        unavailable and, like the scalar ladder's None, does not cap."""
        capped = (closes >= self.price_high_threshold) | (atr_pcts > self.atr_high_threshold)
        return np.where(capped, 1, self._regime_leverage(regime, stress, confidence)).astype(
            np.int64
        )

    @staticmethod
    def _row_models(
        registry: SymbolRegistry | FrozenRows, all_symbols: list[SymbolModel]
    ) -> tuple[np.ndarray, list[SymbolModel]]:
        """The (rows, models) of the symbols the registry holds, in
        ``all_symbols`` order, in one pass over the list. Takes a live
        :class:`SymbolRegistry` or a dispatch-time :class:`FrozenRows`."""
        if not all_symbols:
            return np.empty(0, np.int64), []
        if isinstance(registry, FrozenRows):
            lookup = {name: row for row, name in registry._row_to_name.items()}.get
        else:
            lookup = registry.row_of
        rows: list[int] = []
        models: list[SymbolModel] = []
        for model in all_symbols:
            row = lookup(model.id)
            if row is not None and int(row) >= 0:
                rows.append(int(row))
                models.append(model)
        return np.asarray(rows, np.int64), models

    def calibrate_all(
        self,
        context: MarketContext | CalibrationInputs,
        registry: SymbolRegistry | FrozenRows,
        all_symbols: list[SymbolModel],
    ) -> dict[str, int]:
        """Diff and PUT for every feature-valid row the symbol list covers;
        only rows whose leverage changes reach the PUT loop, in row order."""
        applied = no_change = skipped = 0
        if isinstance(context, CalibrationInputs):
            valid, closes, atr_pcts = context.valid, context.close, context.atr_pct
            regime, stress, confidence = context.regime, context.stress, context.confidence
        else:
            valid = _host(context.features.valid)
            closes = _host(context.features.close)
            atr_pcts = _host(context.features.atr_pct)
            regime = int(_host(context.market_regime))
            stress = float(_host(context.market_stress_score))
            confidence = 1.0 if bool(_host(context.valid)) else 0.0

        targets = self.target_leverage_batch(
            np.asarray(closes, np.float64),
            np.asarray(atr_pcts, np.float64),
            int(regime),
            float(stress),
            float(confidence),
        )
        valid = np.asarray(valid, bool)
        model_rows, model_refs = self._row_models(registry, all_symbols)
        in_range = model_rows < valid.shape[0]
        model_rows = model_rows[in_range]
        model_refs = [m for m, ok in zip(model_refs, in_range) if ok]
        model_of = dict(zip(model_rows.tolist(), model_refs))
        covered = np.zeros(valid.shape, bool)
        covered[model_rows] = True
        # float: a 2.5x leverage must not read as 2x and never be corrected
        current = np.full(valid.shape, -1.0, np.float64)
        if len(model_rows):
            current[model_rows] = [m.futures_leverage for m in model_refs]
        skipped += int(np.count_nonzero(valid & ~covered))
        no_change += int(np.count_nonzero(valid & covered & (targets == current)))
        for row_idx in np.nonzero(valid & covered & (targets != current))[0]:
            row = model_of[int(row_idx)]
            target = int(targets[row_idx])
            try:
                self.binbot_api.edit_symbol(
                    row.id, exchange_id=self.exchange, futures_leverage=target
                )
                row.futures_leverage = target
                applied += 1
            except Exception:
                logging.exception(
                    "[LeverageCalibrator] failed to update %s -> %s", row.id, target
                )
                skipped += 1
        logging.info(
            "[LeverageCalibrator] applied=%d no_change=%d skipped=%d",
            applied, no_change, skipped,
        )
        return {"applied": applied, "no_change": no_change, "skipped": skipped}
