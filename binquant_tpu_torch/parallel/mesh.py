"""The symbol-axis partitioning, and the mesh setting.

The port's own copy of the row routing of ``binquant_tpu/parallel/mesh.py``:
:func:`shard_bounds` and :func:`shard_of_row` give the contiguous block of
registry rows each of ``n`` shards owns, shard ``k`` rows
``[k·S/n, (k+1)·S/n)``, the split the reference's 1-D ``symbols`` mesh
places the state by. The sharded archives that cross between the packages
(``io/checkpoint.py``, ``fanout/snapshot.py``) and the sharded fan-out
outbox (``fanout/hub.py``) split at these bounds, so an archive written at
any shard count restores into either package.

The tick itself runs on one card. :func:`resolve_mesh` reads the
``mesh_devices`` setting (``BQT_MESH_DEVICES``) as the reference's engine
does: with fewer visible cards than asked, or a capacity the count does not
divide, it warns and the engine runs unsharded; with that many cards it
raises, because the multi-card tick is not ported (ROADMAP, queue A: the
multi-card tick).
"""

from __future__ import annotations

import logging

import torch


def shard_bounds(capacity: int, n_shards: int) -> list[tuple[int, int]]:
    """The contiguous ``[lo, hi)`` row range each of ``n_shards`` owns."""
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


def resolve_mesh(mesh_devices: int, capacity: int) -> None:
    """The engine's mesh for ``mesh_devices`` (0 or 1: none). Returns None,
    the unsharded engine, after a warning when fewer cards are visible than
    asked or the capacity does not split evenly; raises when the cards are
    there, since the port has no multi-card tick."""
    if mesh_devices <= 1:
        return None
    visible = torch.cuda.device_count()
    if visible < mesh_devices:
        logging.warning(
            "BQT_MESH_DEVICES=%d but only %d device(s) visible; running single-chip",
            mesh_devices,
            visible,
        )
        return None
    if capacity % mesh_devices:
        logging.warning(
            "capacity %d not divisible by mesh size %d; running single-chip",
            capacity,
            mesh_devices,
        )
        return None
    raise NotImplementedError(
        f"mesh_devices={mesh_devices} with {visible} cards visible: the multi-card tick is "
        "not ported (ROADMAP queue A, the multi-card tick); run with mesh_devices=0"
    )
