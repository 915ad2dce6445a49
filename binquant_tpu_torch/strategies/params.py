"""Strategy parameters: every live threshold in one NamedTuple.

Port of ``binquant_tpu/strategies/params.py``: ``StrategyParams``,
``default_strategy_params``, ``resolve_params``, ``declared_gate_margins`` and the sweep's grid helpers
(:func:`sweepable_axes`, :func:`make_param_grid`, :func:`param_axes`,
:func:`grid_size`, and :func:`grid_combo`, which slices one combo out of a
grid). The port runs eagerly, so the parameters are plain Python values;
the reference's ``DynamicParams``/``dynamic_params`` exist only to carry
float leaves through ``jit`` and ``vmap`` tracing and have no counterpart
here.

Float leaves are sweepable; int and bool leaves are STRUCTURAL (they size
rolling windows and rings) and cannot ride a grid axis.
"""

from __future__ import annotations

from itertools import product
from typing import NamedTuple, Sequence

import numpy as np

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


def default_strategy_params() -> StrategyParams:
    return StrategyParams()


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


def _leaf_path_items(params: StrategyParams):
    """Yield ("strategy.field", sub_name, field path, value) per leaf of the
    two-level params tuple (ScorerWeights nests one level deeper, addressed
    as e.g. ``pt.weights.context_weight``)."""
    for sub_name, sub in params._asdict().items():
        for name, value in sub._asdict().items():
            if hasattr(value, "_asdict"):
                for inner, v2 in value._asdict().items():
                    yield f"{sub_name}.{name}.{inner}", sub_name, (name, inner), v2
            else:
                yield f"{sub_name}.{name}", sub_name, (name,), value


def sweepable_axes(params: StrategyParams | None = None) -> list[str]:
    """Dotted names of every float leaf (the legal grid axes)."""
    params = params or StrategyParams()
    return [path for path, _, _, v in _leaf_path_items(params) if isinstance(v, float)]


def _set_leaf(params: StrategyParams, sub: str, fields: tuple, value) -> StrategyParams:
    sub_tuple = getattr(params, sub)
    if len(fields) == 1:
        sub_tuple = sub_tuple._replace(**{fields[0]: value})
    else:
        inner = getattr(sub_tuple, fields[0])._replace(**{fields[1]: value})
        sub_tuple = sub_tuple._replace(**{fields[0]: inner})
    return params._replace(**{sub: sub_tuple})


def make_param_grid(
    axes: dict[str, Sequence[float]],
    base: StrategyParams | None = None,
) -> tuple[StrategyParams, list[dict[str, float]]]:
    """Cartesian-product grid as one params tuple: the swept leaves become
    ``(P,)`` float32 arrays (P = product of the axis lengths), every other
    leaf keeps its value; ``combos[i]`` names combo i's axis values."""
    base = base or StrategyParams()
    legal = set(sweepable_axes(base))
    by_path = {path: (s, f) for path, s, f, _ in _leaf_path_items(base)}
    for name in axes:
        if name not in by_path:
            raise KeyError(f"unknown param axis {name!r}")
        if name not in legal:
            raise ValueError(
                f"param axis {name!r} is structural (int/bool) — only float "
                "leaves can be swept"
            )
    names = list(axes)
    grids = [np.asarray(axes[n], dtype=np.float32) for n in names]
    combos_nd = list(product(*[range(len(g)) for g in grids]))
    params = base
    for j, (name, grid) in enumerate(zip(names, grids)):
        sub, fields = by_path[name]
        col = np.asarray([grid[idx[j]] for idx in combos_nd], dtype=np.float32)
        params = _set_leaf(params, sub, fields, col)
    combos = [
        {name: float(grids[j][idx[j]]) for j, name in enumerate(names)}
        for idx in combos_nd
    ]
    return params, combos


def _tree_map(fn, tree):
    """``fn`` over every leaf of a (nested) NamedTuple."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, v) for v in tree))
    return fn(tree)


def _leaves(tree) -> list:
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [leaf for v in tree for leaf in _leaves(v)]
    return [tree]


def _batched(leaf) -> bool:
    return getattr(leaf, "ndim", 0) >= 1


def param_axes(params: StrategyParams):
    """The reference's ``vmap`` in_axes tree: 0 for batched ``(P,)``
    leaves, None for scalars."""
    return _tree_map(lambda leaf: 0 if _batched(leaf) else None, params)


def grid_size(params: StrategyParams) -> int:
    """P of a batched grid (1 for an unbatched params tuple)."""
    sizes = {leaf.shape[0] for leaf in _leaves(params) if _batched(leaf)}
    if not sizes:
        return 1
    if len(sizes) > 1:
        raise ValueError(f"inconsistent grid axis lengths: {sorted(sizes)}")
    return int(sizes.pop())


def grid_combo(params: StrategyParams, i: int) -> StrategyParams:
    """Combo ``i`` of a grid as a plain StrategyParams: each batched leaf
    becomes its i-th float32 value as a Python float, which the kernels
    round back to the same float32."""
    return _tree_map(lambda leaf: float(leaf[i]) if _batched(leaf) else leaf, params)
