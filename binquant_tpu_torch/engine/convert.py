"""Engine state carried across packages as numpy leaves.

:func:`engine_state_from_numpy` builds the port's :class:`EngineState` from
the leaves of a reference ``EngineState`` passed as numpy arrays, and
:func:`engine_state_to_numpy` turns the port's state back into the same
layout, so the tests and ``chip_smoke.py`` can start two engines from one
state and compare what they return. The layout is a nested dict keyed by
field name, one level per named tuple::

    {"buf5": {"times", "values", "filled", "cursor"},
     "buf15": {...},
     "regime_carry": {<RegimeCarry field>: array, ...},
     "mrf_last_emitted": array, "pt_last_signal_close": array,
     "indicator_carry": {"pack5": {"last_ts": array, "ema9": {"mean", "rel"},
                                   ...},
                         "abp5": {...}, ..., "bc_dirty": array}}

``indicator_carry`` may be absent (or None): the state then has none, as a
classic step that never maintains one passes through.

Dtypes are checked, never converted: int32 times/counts/cursors, float32
values, bool masks — an int64 or float64 leaf is a caller error.
"""

from __future__ import annotations

import typing

import numpy as np
import torch

from binquant_tpu_torch.engine.step import EngineState, IndicatorCarry

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


def _is_named_tuple(t) -> bool:
    return isinstance(t, type) and issubclass(t, tuple) and hasattr(t, "_fields")


def _from_numpy(cls, leaves: dict, device):
    """A named tuple of tensors (nested named tuples recurse) from a dict."""
    hints = typing.get_type_hints(cls)
    return cls(*(
        _from_numpy(hints[f], leaves[f], device)
        if _is_named_tuple(hints[f])
        else _leaf(leaves[f], device)
        for f in cls._fields
    ))


def _to_numpy(value):
    if isinstance(value, tuple):
        return {f: _to_numpy(v) for f, v in zip(value._fields, value)}
    return value.detach().cpu().numpy()


def engine_state_from_numpy(leaves: dict, device: str | torch.device) -> EngineState:
    fields = {}
    for f, cls in typing.get_type_hints(EngineState).items():
        if f == "indicator_carry":
            d = leaves.get(f)
            fields[f] = None if d is None else _from_numpy(IndicatorCarry, d, device)
        elif _is_named_tuple(cls):
            fields[f] = _from_numpy(cls, leaves[f], device)
        else:
            fields[f] = _leaf(leaves[f], device)
    return EngineState(**fields)


def engine_state_to_numpy(state: EngineState) -> dict:
    return {
        f: None if v is None else _to_numpy(v)
        for f, v in zip(EngineState._fields, state)
    }
