"""Engine state carried across packages as numpy leaves.

:func:`engine_state_from_numpy` builds the port's :class:`EngineState` from
the leaves of a reference ``EngineState`` passed as numpy arrays, and
:func:`engine_state_to_numpy` turns the port's state back into the same
layout, so the tests and ``chip_smoke.py`` can start two engines from one
state and compare what they return. The layout is a nested dict keyed by
field name::

    {"buf5": {"times", "values", "filled", "cursor"},
     "buf15": {...},
     "regime_carry": {<RegimeCarry field>: array, ...},
     "mrf_last_emitted": array, "pt_last_signal_close": array}

Dtypes are checked, never converted: int32 times/counts/cursors, float32
values, bool masks — an int64 or float64 leaf is a caller error.
"""

from __future__ import annotations

import numpy as np
import torch

from binquant_tpu_torch.engine.buffer import MarketBuffer
from binquant_tpu_torch.engine.step import EngineState
from binquant_tpu_torch.regime.context import RegimeCarry

_NP_TO_TORCH = {
    np.dtype(np.int32): torch.int32,
    np.dtype(np.float32): torch.float32,
    np.dtype(np.bool_): torch.bool,
}


def _leaf(arr, device) -> torch.Tensor:
    a = np.asarray(arr)
    if a.dtype not in _NP_TO_TORCH:
        raise TypeError(f"engine state leaf has dtype {a.dtype}; expected int32, float32 or bool")
    # a C-ordered copy: np.ascontiguousarray would turn a 0-d scalar into (1,)
    return torch.from_numpy(np.array(a, order="C")).to(device)


def engine_state_from_numpy(leaves: dict, device: str | torch.device) -> EngineState:
    def buf(d):
        return MarketBuffer(*(_leaf(d[f], device) for f in MarketBuffer._fields))

    rc = leaves["regime_carry"]
    return EngineState(
        buf5=buf(leaves["buf5"]),
        buf15=buf(leaves["buf15"]),
        regime_carry=RegimeCarry(*(_leaf(rc[f], device) for f in RegimeCarry._fields)),
        mrf_last_emitted=_leaf(leaves["mrf_last_emitted"], device),
        pt_last_signal_close=_leaf(leaves["pt_last_signal_close"], device),
        indicator_carry=None,
    )


def engine_state_to_numpy(state: EngineState) -> dict:
    def np_(t: torch.Tensor) -> np.ndarray:
        return t.detach().cpu().numpy()

    def buf(b: MarketBuffer) -> dict:
        return {f: np_(getattr(b, f)) for f in MarketBuffer._fields}

    return {
        "buf5": buf(state.buf5),
        "buf15": buf(state.buf15),
        "regime_carry": {f: np_(getattr(state.regime_carry, f)) for f in RegimeCarry._fields},
        "mrf_last_emitted": np_(state.mrf_last_emitted),
        "pt_last_signal_close": np_(state.pt_last_signal_close),
    }
