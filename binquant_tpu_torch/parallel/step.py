"""The sharded tick: ``engine/step.py``'s public functions on a placed state.

Each public step function of ``engine/step.py`` hands a
:class:`~binquant_tpu_torch.parallel.mesh.ShardedState` here. The call
routes the update batches to the shards that own their rows
(:func:`shard_updates`, rows rebased to shard-local), places the host
inputs (:func:`~binquant_tpu_torch.parallel.mesh.shard_host_inputs`), and
runs one program per shard (:func:`~binquant_tpu_torch.parallel.collectives.run_shards`):
the unsharded code on the shard's rows under its device, meeting the other
shards only at the collectives the tick's cross-row points call (the BTC
row, the market context, the digests' counts, the wire). The result is the
placed state of the per-shard results and, for the wire steps, shard 0's
wire, in the unsharded layout.

The ring-slot functions work per shard, so depth 2 runs on double-buffered
per-shard rings: a sharded slot is the tuple of the shards' slots. The
folds need the collectives only where they advance the carry (the BTC row's
returns).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from binquant_tpu_torch.engine import step as _step
from binquant_tpu_torch.engine.buffer import (
    apply_updates,
    materialize,
    reset_rows as _reset_buffer_rows,
    split_updates,
)
from binquant_tpu_torch.parallel.collectives import TRAFFIC, run_shards
from binquant_tpu_torch.parallel.mesh import Mesh, ShardedState, shard_host_inputs, tree_map

I32 = torch.int32
F32 = torch.float32


class ShardedUpdates(NamedTuple):
    """One update batch already routed: ``parts[k]`` is shard ``k``'s
    ``(rows, ts, vals)`` on its device, rows local to the shard."""

    parts: tuple


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def route_batch(mesh: Mesh, capacity: int, batch) -> ShardedUpdates:
    """A whole update batch (host arrays or tensors) routed to the shards
    that own its rows (``engine/buffer.py`` ``split_updates``, on the host):
    each shard's rows, rebased, go straight to its device."""
    parts = split_updates(*(_host(x) for x in batch), capacity, mesh.size)
    return ShardedUpdates(tuple(
        tuple(torch.from_numpy(a).to(dev) for a in part)
        for part, dev in zip(parts, mesh.devices, strict=True)
    ))


def shard_updates(state: ShardedState, batch) -> tuple:
    """``batch`` as per-shard ``(rows, ts, vals)`` triples: a
    :class:`ShardedUpdates`'s parts as they are, a whole batch routed by
    :func:`route_batch`."""
    if not isinstance(batch, ShardedUpdates):
        batch = route_batch(state.mesh, state.capacity, batch)
    return batch.parts


def _shard_counts(counts, state: ShardedState) -> tuple:
    """The ingest digest's fold-count accumulator per shard: a tuple as it
    is, one tensor (a fresh accumulator) on shard 0 with zeros elsewhere,
    None for none."""
    n = state.mesh.size
    if counts is None:
        return (None,) * n
    if isinstance(counts, tuple):
        return counts
    devs = state.mesh.devices
    return (counts.to(devs[0]),) + tuple(
        torch.zeros_like(counts, device=d) for d in devs[1:]
    )


def _run(state: ShardedState, program, *per_shard, btc_row=-1) -> list:
    args = list(zip(state.shards, *per_shard, strict=True))
    return run_shards(state.mesh, program, args, state.capacity, -1 if btc_row is None else btc_row)


def _tick(state: ShardedState, upd5, upd15, inputs, cfg, wire_enabled, incremental,
          maintain_carry, params, numeric_digest, ingest_digest, ingest_fold_counts,
          inplace: bool, compute_all: bool):
    sinputs = shard_host_inputs(inputs, state.mesh)

    def program(comm, st, a, b, inp, counts):
        return _step._tick_step_impl(
            st, a, b, inp, cfg, wire_enabled, incremental, maintain_carry, params,
            numeric_digest, ingest_digest, counts, inplace=inplace,
            compute_all=compute_all, comm=comm,
        )

    results = _run(
        state, program, shard_updates(state, upd5), shard_updates(state, upd15),
        sinputs.shards, _shard_counts(ingest_fold_counts, state), btc_row=sinputs.btc_row,
    )
    return state.with_shards([r[0] for r in results]), [r[1] for r in results]


def tick_step_wire(state, upd5, upd15, inputs, cfg, wire_enabled, incremental=False,
                   maintain_carry=True, params=None, numeric_digest=False,
                   ingest_digest=False, ingest_fold_counts=None, inplace: bool = False):
    """The wire step over the shards (copying, or in place on every
    shard's rings): the new placed state and shard 0's wire."""
    new_state, outputs = _tick(
        state, upd5, upd15, inputs, cfg, wire_enabled, incremental, maintain_carry,
        params, numeric_digest, ingest_digest, ingest_fold_counts, inplace, False,
    )
    return new_state, outputs[0].wire


def tick_step(state, upd5, upd15, inputs, cfg, wire_enabled, incremental=False,
              maintain_carry=True, params=None, numeric_digest=False, ingest_digest=False,
              ingest_fold_counts=None, compute_all: bool = True):
    """The full-outputs step over the shards: the new placed state and the
    outputs gathered whole in row order (:func:`gather_outputs`)."""
    new_state, outputs = _tick(
        state, upd5, upd15, inputs, cfg, wire_enabled, incremental, maintain_carry,
        params, numeric_digest, ingest_digest, ingest_fold_counts, False, compute_all,
    )
    return new_state, gather_outputs(outputs, state)


def gather_outputs(outputs: list, state: ShardedState):
    """The shards' ``TickOutputs`` as one, on shard 0's device: per-row
    leaves concatenated in row order (the trigger summary along its symbol
    axis), market scalars and the wire from shard 0. Only the full-outputs
    step (tests, the overflow fallback) gathers them; every leaf is
    ``(S,)``-scale."""
    root = state.mesh.devices[0]
    rows = int(state.shards[0].buf15.times.shape[0])

    def cat(leaves, dim: int):
        sizes = [leaf.numel() * leaf.element_size() for leaf in leaves]
        TRAFFIC.note("outputs", sum(sizes[1:]), sum(sizes))
        return torch.cat([leaf.to(root) for leaf in leaves], dim=dim)

    def join(*leaves):
        head = leaves[0]
        if head.dim() >= 1 and head.shape[0] == rows:
            return cat(leaves, 0)
        return head

    def join_summary(*leaves):
        return cat(leaves, 1)

    head = outputs[0]
    merged = tree_map(join, head._replace(summary=None, wire=None),
                      *(o._replace(summary=None, wire=None) for o in outputs[1:]))
    summary = tree_map(join_summary, *(o.summary for o in outputs))
    return merged._replace(summary=summary, wire=head.wire)


# --- folds ------------------------------------------------------------------------


def apply_updates_step(state: ShardedState, upd5, upd15, inplace: bool = False):
    def program(comm, st, a, b):
        return _step.apply_updates_step(st, a, b, inplace)

    return state.with_shards(
        _run(state, program, shard_updates(state, upd5), shard_updates(state, upd15))
    )


def apply_updates_carry_step(state: ShardedState, upd5, upd15, btc_row=None,
                             inplace: bool = False):
    def program(comm, st, a, b):
        buf5 = apply_updates(st.buf5, *a, inplace=inplace)
        buf15 = apply_updates(st.buf15, *b, inplace=inplace)
        return _step._advance_folded(st, buf5, buf15, btc_row, comm)

    return state.with_shards(
        _run(state, program, shard_updates(state, upd5), shard_updates(state, upd15),
             btc_row=btc_row)
    )


def apply_updates_step_counted(state: ShardedState, upd5, upd15, counts, inplace=False):
    def program(comm, st, a, b, cnt):
        return _step.apply_updates_step_counted(st, a, b, cnt, inplace)

    results = _run(state, program, shard_updates(state, upd5), shard_updates(state, upd15),
                   _shard_counts(counts, state))
    return state.with_shards([r[0] for r in results]), tuple(r[1] for r in results)


def apply_updates_carry_step_counted(state: ShardedState, upd5, upd15, btc_row=None,
                                     counts=None, inplace: bool = False):
    if counts is None:
        counts = torch.zeros((8,), dtype=F32, device=state.mesh.devices[0])

    def program(comm, st, a, b, cnt):
        buf5, buf15, cnt = _step._counted_fold_bufs(st, a, b, cnt, inplace)
        return _step._advance_folded(st, buf5, buf15, btc_row, comm), cnt

    results = _run(state, program, shard_updates(state, upd5), shard_updates(state, upd15),
                   _shard_counts(counts, state), btc_row=btc_row)
    return state.with_shards([r[0] for r in results]), tuple(r[1] for r in results)


def apply_updates_scan(state: ShardedState, upd5_seq, upd15_seq, inplace: bool = False):
    def program(comm, st, a, b):
        return _step.apply_updates_scan(st, a, b, inplace)

    return state.with_shards(
        _run(state, program, shard_updates(state, upd5_seq), shard_updates(state, upd15_seq))
    )


def apply_updates_scan_counted(state: ShardedState, upd5_seq, upd15_seq, counts,
                               inplace: bool = False):
    def program(comm, st, a, b, cnt):
        return _step.apply_updates_scan_counted(st, a, b, cnt, inplace)

    results = _run(state, program, shard_updates(state, upd5_seq),
                   shard_updates(state, upd15_seq), _shard_counts(counts, state))
    return state.with_shards([r[0] for r in results]), tuple(r[1] for r in results)


def carry_drift(state: ShardedState, upd5, upd15, btc_row, params=None) -> dict:
    """The carry-drift meter over the shards: each measures its rows, shard
    0 combines the leaves' stats (``engine/step.py`` ``_carry_drift_impl``)."""

    def program(comm, st, a, b):
        row = torch.as_tensor(btc_row, dtype=I32, device=comm.device)
        return _step._carry_drift_impl(st, a, b, row, params, comm)

    return _run(state, program, shard_updates(state, upd5), shard_updates(state, upd15),
                btc_row=btc_row)[0]


def reset_rows(state: ShardedState, rows) -> ShardedState:
    """Clear registry rows (symbols that left the universe) on the shards
    that own them."""
    rows = np.asarray(rows, dtype=np.int64)
    shards = []
    for st, (lo, hi), dev in zip(state.shards, state.bounds, state.mesh.devices, strict=True):
        local = rows[(rows >= lo) & (rows < hi)] - lo
        if len(local) == 0:
            shards.append(st)
            continue
        idx = torch.from_numpy(local.astype(np.int32)).to(dev)
        shards.append(st._replace(buf5=_reset_buffer_rows(st.buf5, idx),
                                  buf15=_reset_buffer_rows(st.buf15, idx)))
    return state.with_shards(shards)


# --- ring slots (depth >= 2 on per-shard double-buffered rings) ---------------------


def ring_slot_of(state: ShardedState) -> tuple:
    return tuple(_step.ring_slot_of(s) for s in state.shards)


def empty_ring_slot(state: ShardedState) -> tuple:
    return tuple(_step.empty_ring_slot(s) for s in state.shards)


def into_ring_slot(state: ShardedState, slot: tuple) -> ShardedState:
    return state.with_shards(
        [_step.into_ring_slot(s, sl) for s, sl in zip(state.shards, slot, strict=True)]
    )


def canonicalize_state(state: ShardedState) -> ShardedState:
    return state.with_shards(
        [s._replace(buf5=materialize(s.buf5), buf15=materialize(s.buf15)) for s in state.shards]
    )
