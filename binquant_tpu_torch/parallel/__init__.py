"""The symbol mesh: the engine state split over shards by contiguous blocks
of registry rows, and the sharded tick over it. The port of
``binquant_tpu/parallel``: the placement (:mod:`.mesh`), the shard programs
and their collectives (:mod:`.collectives`), and the step functions on a
placed state (:mod:`.step`, reached through ``engine/step.py``)."""

from binquant_tpu_torch.parallel.mesh import (
    make_mesh,
    resolve_mesh,
    shard_bounds,
    shard_engine_state,
    shard_host_inputs,
    shard_of_row,
    symbol_sharding,
)

__all__ = [
    "make_mesh",
    "resolve_mesh",
    "shard_bounds",
    "shard_engine_state",
    "shard_host_inputs",
    "shard_of_row",
    "symbol_sharding",
]
