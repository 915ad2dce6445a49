"""The symbol mesh: the engine state placed over shards, one block of rows each.

The port's own copy of ``binquant_tpu/parallel/mesh.py``. The reference
builds a 1-D ``symbols`` mesh, places every ``(S, ...)`` leaf split along
the symbol axis and every scalar replicated, and lets XLA insert the few
collectives the market context needs. The port holds the same placement
explicitly:

* a :class:`Mesh` is the ordered device list and the axis name. Devices may
  repeat: N shards on one card (or on the CPU) run exactly the code a host
  with N cards runs with shard ``k`` on ``cuda:k``, as the reference's
  virtual CPU mesh runs the code of a pod;
* a :class:`NamedSharding` says "split the leading axis at
  :func:`shard_bounds`" (:func:`symbol_sharding`) or "one equal copy per
  shard" (:func:`_replicated`);
* a placed leaf is a :class:`ShardedArray`, one tensor per shard on that
  shard's device, each with a storage of its own (:func:`assemble_sharded`
  slices a host array, :func:`assemble_from_slices` takes slices that are
  already cut);
* a placed engine state is a :class:`ShardedState`: one ``EngineState`` of
  capacity S/N per shard, rows ``[lo, hi)``, on the shard's device, with the
  mesh (:func:`shard_engine_state`); placed host inputs are a
  :class:`ShardedInputs` (:func:`shard_host_inputs`). Placing a placed value
  on the same mesh again returns it as it is, as the reference's ``_put``
  skips a leaf that already carries its sharding.

The sharded tick (``parallel/step.py``) runs one program per shard over
these and meets at the collectives of ``parallel/collectives.py``; no
``(S, ...)`` leaf of a placed state is ever held whole on the tick path.
:func:`unshard_state` gathers one back whole, off the tick path (a
checkpoint save, a test).

:func:`make_mesh` refuses a multi-process ``torch.distributed`` job, as the
reference refuses multi-process JAX: the placement is process-local, but
the control plane around it (one registry claiming rows, one ingest
batcher, one outbox cursor) is one process.

:func:`resolve_mesh` reads the ``mesh_devices`` setting
(``BQT_MESH_DEVICES``) by the reference's rules (``io/pipeline.py``): 0 or
1 is no mesh; a capacity the count does not divide, or a CUDA engine with
fewer visible cards than asked, warns and runs unsharded; otherwise a CUDA
engine gets a mesh over ``cuda:0 .. cuda:N-1`` and a CPU engine N shards on
``cpu``, the counterpart of the reference's virtual CPU devices.

:func:`shard_bounds` and :func:`shard_of_row` are the routing primitives
every split derives from: the ingest router, the sharded archives
(``io/checkpoint.py``, ``fanout/snapshot.py``) and the outbox partitions
(``fanout/hub.py``).
"""

from __future__ import annotations

import logging
from typing import NamedTuple

import numpy as np
import torch

SYMBOLS = "symbols"


def shard_bounds(capacity: int, n_shards: int) -> list[tuple[int, int]]:
    """The contiguous ``[lo, hi)`` row range each of ``n_shards`` owns:
    shard ``k`` rows ``[k·S/n, (k+1)·S/n)``."""
    if capacity % n_shards:
        raise ValueError(f"capacity {capacity} not divisible by {n_shards} shards")
    block = capacity // n_shards
    return [(k * block, (k + 1) * block) for k in range(n_shards)]


def shard_of_row(row: int, capacity: int, n_shards: int) -> int:
    """The shard that owns registry row ``row`` (see :func:`shard_bounds`)."""
    block = capacity // n_shards
    if row < 0 or row >= capacity:
        raise ValueError(f"row {row} outside capacity {capacity}")
    return row // block


class Mesh:
    """The ordered devices of a 1-D mesh and its axis name; entries may
    repeat (several shards on one device)."""

    def __init__(self, devices, axis_names: tuple[str, ...] = (SYMBOLS,)) -> None:
        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.axis_names = tuple(axis_names)

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def shape(self) -> dict[str, int]:
        return {self.axis_names[0]: self.size}

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, Mesh)
            and self.devices == other.devices
            and self.axis_names == other.axis_names
        )

    def __hash__(self) -> int:
        return hash((self.devices, self.axis_names))

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.devices]}, axis_names={self.axis_names})"


def make_mesh(devices: list | None = None, axis: str = SYMBOLS) -> Mesh:
    """A 1-D mesh over ``devices`` (default: every visible card, else the
    CPU). Refuses a multi-process ``torch.distributed`` job."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        raise NotImplementedError(
            "binquant_tpu_torch's mesh mode is single-process: the per-shard "
            "placement is process-local, but the registry/ingest/outbox control "
            "plane is one process (see parallel/mesh.py's docstring)"
        )
    if devices is None:
        n = torch.cuda.device_count()
        devices = [f"cuda:{k}" for k in range(n)] if n else ["cpu"]
    return Mesh(devices, axis_names=(axis,))


class NamedSharding(NamedTuple):
    """How a leaf lies on a mesh: ``spec`` ``()`` is one equal copy per
    shard, ``(axis, None, ...)`` the leading axis split at
    :func:`shard_bounds`."""

    mesh: Mesh
    spec: tuple

    @property
    def is_split(self) -> bool:
        return bool(self.spec) and self.spec[0] is not None

    def indices(self, shape: tuple[int, ...]) -> list[tuple[slice, ...]]:
        """Each shard's index into a leaf of the global ``shape``."""
        if not self.is_split:
            return [() for _ in self.mesh.devices]
        return [(slice(lo, hi),) for lo, hi in shard_bounds(shape[0], self.mesh.size)]


def symbol_sharding(mesh: Mesh, ndim: int = 1, axis: str = SYMBOLS) -> NamedSharding:
    """The sharding that splits the leading (symbol) axis."""
    return NamedSharding(mesh, (axis, *([None] * (ndim - 1))))


def _replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, ())


class ShardedArray(NamedTuple):
    """One leaf placed on a mesh: ``pieces[k]`` on ``mesh.devices[k]``."""

    pieces: tuple
    sharding: NamedSharding
    shape: tuple


def _to_device(x, device: torch.device) -> torch.Tensor:
    """``x`` (numpy, scalar or tensor) as a tensor of its own storage on
    ``device``: a slice never keeps the whole leaf alive."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, copy=True)
    return torch.from_numpy(np.array(x, order="C")).to(device)


def _host_int(x) -> int:
    if isinstance(x, torch.Tensor):
        return int(x.item())
    return int(np.asarray(x))


def _as_host(x):
    if isinstance(x, ShardedArray):
        return unshard_array(x)
    if isinstance(x, torch.Tensor):
        return x
    return np.asarray(x)


def assemble_sharded(mesh: Mesh, host, sharding: NamedSharding | None = None) -> ShardedArray:
    """Place a whole array: each shard's slice (its rows for a split
    sharding, all of it for a replicated one) goes to that shard's device
    alone. A 0-d array replicates."""
    host = _as_host(host)
    shape = tuple(host.shape)
    if sharding is None:
        sharding = symbol_sharding(mesh, max(len(shape), 1))
    if len(shape) == 0:
        sharding = _replicated(mesh)
    pieces = tuple(
        _to_device(host[idx], dev) for dev, idx in zip(mesh.devices, sharding.indices(shape))
    )
    return ShardedArray(pieces, sharding, shape)


def assemble_from_slices(mesh: Mesh, slices: list, sharding: NamedSharding) -> ShardedArray:
    """Place slices that are already cut (ingest routing, a sharded
    restore): ``slices[k]`` goes to mesh device ``k`` as it is, and no
    whole array is built on the host."""
    if len(slices) != mesh.size:
        raise ValueError(f"{len(slices)} slices for {mesh.size} mesh devices")
    pieces = tuple(_to_device(s, d) for s, d in zip(slices, mesh.devices))
    trailing = tuple(pieces[0].shape)
    if sharding.is_split:
        shape = (sum(int(p.shape[0]) for p in pieces), *trailing[1:])
    else:
        shape = trailing
    return ShardedArray(pieces, sharding, shape)


def unshard_array(x: ShardedArray, device: str | torch.device = "cpu") -> torch.Tensor:
    """A placed leaf whole on ``device`` (off the tick path)."""
    if x.sharding.is_split:
        return torch.cat([p.to(device) for p in x.pieces], dim=0)
    return x.pieces[0].to(device)


def _put(mesh: Mesh, x, sharding: NamedSharding) -> ShardedArray:
    """Place one leaf, returning a leaf that already carries the target
    sharding as it is (a placement is idempotent)."""
    if isinstance(x, ShardedArray) and x.sharding == sharding:
        return x
    return assemble_sharded(mesh, x, sharding)


# --- trees of named tuples ---------------------------------------------------


def _is_node(x) -> bool:
    return isinstance(x, tuple) and not isinstance(x, ShardedArray)


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested (named) tuples and dicts, None kept
    as None."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if _is_node(tree):
        children = [tree_map(fn, *kids) for kids in zip(tree, *rest, strict=True)]
        return type(tree)(*children) if hasattr(tree, "_fields") else tuple(children)
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    if _is_node(tree):
        return [leaf for child in tree for leaf in tree_leaves(child)]
    return [tree]


def _shard_buffer(buf, mesh: Mesh):
    s1, s2, s3 = (symbol_sharding(mesh, n) for n in (1, 2, 3))
    return buf._replace(
        times=_put(mesh, buf.times, s2),
        values=_put(mesh, buf.values, s3),
        filled=_put(mesh, buf.filled, s1),
        cursor=_put(mesh, buf.cursor, s1),
    )


def _shard_carry(carry, mesh: Mesh, num_symbols: int):
    """Classify carry leaves by shape: ``(S, ...)`` leaves split over
    symbols, scalars and the ``(4,)`` score vectors replicate. Shape-based,
    as the reference's, so a future carry field is placed right without a
    registry; the regime carry and the indicator carry both route here."""
    # the (4,) market-score vectors must not be mistaken for a symbol axis
    assert num_symbols != 4, "capacity of 4 is ambiguous with score vectors"
    rep = _replicated(mesh)

    def place(x):
        shape = tuple(x.shape) if hasattr(x, "shape") else ()
        split = len(shape) >= 1 and shape[0] == num_symbols
        return _put(mesh, x, symbol_sharding(mesh, len(shape)) if split else rep)

    return tree_map(place, carry)


class ShardedState:
    """A placed engine state: ``shards[k]`` is the ``EngineState`` of rows
    ``bounds[k]`` on ``mesh.devices[k]`` (its replicated leaves a copy of
    the scalars); ``split`` is the state-shaped tree of which leaves are
    split over symbols."""

    __slots__ = ("shards", "mesh", "split")

    def __init__(self, shards, mesh: Mesh, split) -> None:
        if len(shards) != mesh.size:
            raise ValueError(f"{len(shards)} shard states for {mesh.size} mesh devices")
        self.shards = tuple(shards)
        self.mesh = mesh
        self.split = split

    @property
    def capacity(self) -> int:
        return sum(int(s.buf15.times.shape[0]) for s in self.shards)

    @property
    def window(self) -> int:
        return int(self.shards[0].buf15.times.shape[1])

    @property
    def bounds(self) -> list[tuple[int, int]]:
        return shard_bounds(self.capacity, self.mesh.size)

    def with_shards(self, shards) -> ShardedState:
        """The same placement over new per-shard states."""
        return ShardedState(shards, self.mesh, self.split)

    def __repr__(self) -> str:
        return f"ShardedState(capacity={self.capacity}, mesh={self.mesh!r})"


def _pieces(placed, k: int):
    return tree_map(lambda a: a.pieces[k], placed)


def shard_engine_state(state, mesh: Mesh) -> ShardedState:
    """Place the engine state: the rings' leaves, the dedupe carries and
    every ``(S, ...)`` carry leaf split over symbols, the regime carry's
    scalars and score vectors replicated. A state already placed on this
    mesh is returned as it is; one placed on another mesh is gathered and
    placed again (a restore at another shard count)."""
    if isinstance(state, ShardedState):
        if state.mesh == mesh:
            return state
        state = unshard_state(state)
    capacity = int(state.buf15.times.shape[0])
    s1 = symbol_sharding(mesh, 1)
    placed = state._replace(
        buf5=_shard_buffer(state.buf5, mesh),
        buf15=_shard_buffer(state.buf15, mesh),
        regime_carry=_shard_carry(state.regime_carry, mesh, capacity),
        mrf_last_emitted=_put(mesh, state.mrf_last_emitted, s1),
        pt_last_signal_close=_put(mesh, state.pt_last_signal_close, s1),
        indicator_carry=_shard_carry(state.indicator_carry, mesh, capacity),
    )
    return ShardedState(
        tuple(_pieces(placed, k) for k in range(mesh.size)),
        mesh,
        tree_map(lambda a: a.sharding.is_split, placed),
    )


def unshard_state(state: ShardedState, device: str | torch.device = "cpu"):
    """The placed state whole on ``device``: split leaves concatenated in
    row order, replicated ones from shard 0. Off the tick path."""

    def join(split, *pieces):
        if split:
            return torch.cat([p.to(device) for p in pieces], dim=0)
        return pieces[0].to(device)

    return tree_map(join, state.split, *state.shards)


# HostInputs fields split over symbols; every other field is a replicated scalar
SYMBOL_INPUTS = frozenset({"tracked", "oi_growth"})


class ShardedInputs:
    """Placed host inputs: ``shards[k]`` is shard ``k``'s ``HostInputs``
    (its rows of the ``(S,)`` fields, the scalars replicated); ``btc_row``
    is the BTC row on the host, which names the shard that owns it."""

    __slots__ = ("shards", "mesh", "btc_row")

    def __init__(self, shards, mesh: Mesh, btc_row: int) -> None:
        self.shards = tuple(shards)
        self.mesh = mesh
        self.btc_row = int(btc_row)


def _place_input(mesh: Mesh, field: str, value) -> ShardedArray:
    if field in SYMBOL_INPUTS:
        return assemble_sharded(mesh, value, symbol_sharding(mesh, 1))
    return assemble_sharded(mesh, value, _replicated(mesh))


def shard_host_inputs(inputs, mesh: Mesh) -> ShardedInputs:
    """The ``(S,)`` inputs (``tracked``, ``oi_growth``) split over symbols
    through per-shard slices, every scalar replicated (one small copy per
    shard). Inputs already placed on this mesh are returned as they are."""
    if isinstance(inputs, ShardedInputs):
        if inputs.mesh == mesh:
            return inputs
        raise ValueError("inputs placed on another mesh")
    placed = {f: _place_input(mesh, f, getattr(inputs, f)) for f in inputs._fields}
    shards = tuple(
        inputs._replace(**{f: a.pieces[k] for f, a in placed.items()})
        for k in range(mesh.size)
    )
    return ShardedInputs(shards, mesh, _host_int(inputs.btc_row))


def resolve_mesh(
    mesh_devices: int, capacity: int, device: str | torch.device = "cuda"
) -> Mesh | None:
    """The engine's mesh for ``mesh_devices`` (0 or 1: none), by the
    reference's rules: fewer visible cards than asked (a CUDA engine) or a
    capacity the count does not divide warns and returns None, the
    unsharded engine; otherwise a mesh over ``cuda:0 .. cuda:N-1``, or N
    shards on the CPU for a CPU engine."""
    n = int(mesh_devices or 0)
    if n <= 1:
        return None
    device = torch.device(device)
    if device.type == "cuda":
        visible = torch.cuda.device_count()
        if visible < n:
            logging.warning(
                "BQT_MESH_DEVICES=%d but only %d device(s) visible; running single-chip",
                n,
                visible,
            )
            return None
    if capacity % n:
        logging.warning(
            "capacity %d not divisible by mesh size %d; running single-chip",
            capacity,
            n,
        )
        return None
    if device.type == "cuda":
        mesh = make_mesh([f"cuda:{k}" for k in range(n)])
    else:
        mesh = make_mesh([device] * n)
    logging.info("symbol axis sharded over %d devices (%s)", n, mesh.shape)
    return mesh
