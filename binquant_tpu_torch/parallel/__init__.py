"""The symbol-axis partitioning: which contiguous block of registry rows
each shard owns. The port of ``binquant_tpu/parallel``'s row routing; the
port runs the tick on one card (see :mod:`binquant_tpu_torch.parallel.mesh`)."""

from binquant_tpu_torch.parallel.mesh import resolve_mesh, shard_bounds, shard_of_row

__all__ = ["resolve_mesh", "shard_bounds", "shard_of_row"]
