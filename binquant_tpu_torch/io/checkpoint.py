"""Checkpoint and restore of the engine's device state.

The port's own copy of ``binquant_tpu/io/checkpoint.py``, archive for
archive: the state's leaves, the symbol↔row registry and the host carries
go into one ``np.savez`` archive, and a restore gives the same next tick.
An archive written by either package restores into the other.

Format (version 4): leaf ``i`` of the state is ``leaf_{i}``, in the order
``jax.tree_util.tree_leaves`` gives the reference's state with its ring
cursors stripped — named-tuple fields in declaration order, depth first,
each ring as its (times, values, filled) triple, an absent indicator carry
contributing nothing (:func:`_archive_leaves`). ``__meta`` is a JSON blob:
version, leaf count, registry mapping, host carries. Saves canonicalize
both rings first (right-aligned, cursor 0), so the cursor is never
archived, and a restore re-attaches zero cursors.

Older archives migrate as the reference's do: version 3 has v4's layout;
versions 1 and 2 lack a suffix of the indicator carry, whose leaves keep
the engine's empty carry, and the restore reports ``_carry_rebuilt`` so
the first tick recomputes it from the windows.

Sharded archives (:func:`save_state_sharded`, the reference's format): one
archive per shard. ``<path>`` holds shard 0 and the manifest (registry,
host carries, the shard roster, a per-save nonce, the indices of the
symbol leaves), ``<path>.shardK-of-N`` the others. A leaf whose leading
dimension is the capacity is a symbol leaf and is split at
:func:`~binquant_tpu_torch.parallel.mesh.shard_bounds`; every other leaf
rides shard 0 once. The siblings are written first and the manifest last,
so a torn save leaves a roster the loader rejects: a missing sibling, a
nonce that differs from the manifest's, or a sibling of another shard
count all start cold. :func:`load_state` reads a monolithic archive or a
manifest alike and concatenates the slices back, so an archive saved at
any shard count restores into an engine of either package.

Every save also writes the fan-out plane's snapshot sidecar
(``fanout/snapshot.py``) when the engine has a plane with a snapshot path.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from binquant_tpu_torch.engine.buffer import MarketBuffer
from binquant_tpu_torch.engine.step import EngineState, canonicalize_state, initial_engine_state
from binquant_tpu_torch.obs.events import get_event_log
from binquant_tpu_torch.obs.instruments import CHECKPOINT_SAVES
from binquant_tpu_torch.parallel.mesh import (
    ShardedState,
    shard_bounds,
    shard_engine_state,
    unshard_state,
)

CKPT_VERSION = 4

_NUMPY_DTYPES = {torch.int32: np.int32, torch.float32: np.float32, torch.bool: np.bool_}


def atomic_savez(target: str | Path, arrays: dict, meta: dict) -> None:
    """Write one ``np.savez`` archive with a ``__meta`` JSON blob
    atomically: a temporary file in the same directory, then a rename."""
    target = Path(target)
    target.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=target.parent, suffix=".ckpt.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(
                f,
                __meta=np.frombuffer(json.dumps(meta).encode(), np.uint8),
                **arrays,
            )
        os.replace(tmp, target)
    except BaseException:
        with contextlib.suppress(FileNotFoundError):
            os.unlink(tmp)
        raise


def _sans_cursor(state: EngineState) -> EngineState:
    """``state`` with each ring replaced by its (times, values, filled)
    triple: the archive's leaf sequence has no cursor."""
    return state._replace(
        buf5=(state.buf5.times, state.buf5.values, state.buf5.filled),
        buf15=(state.buf15.times, state.buf15.values, state.buf15.filled),
    )


def _flatten(tree) -> list[torch.Tensor]:
    """Leaves of nested tuples (named or plain) of tensors, depth first in
    field order; None contributes none."""
    if tree is None:
        return []
    if isinstance(tree, tuple):
        return [leaf for item in tree for leaf in _flatten(item)]
    return [tree]


def _unflatten(template, leaves: list):
    """``template``'s structure with its leaves taken in order from
    ``leaves`` (consumed from the front)."""
    if template is None:
        return None
    if isinstance(template, tuple):
        items = [_unflatten(item, leaves) for item in template]
        return type(template)(*items) if hasattr(template, "_fields") else tuple(items)
    return leaves.pop(0)


def _archive_leaves(state: EngineState) -> list[torch.Tensor]:
    return _flatten(_sans_cursor(state))


def _canonical_whole(state) -> EngineState:
    """The state a save writes: rings canonical, and a state placed on a
    symbol mesh gathered whole on the host (off the tick path: the engine
    is held while a save reads it)."""
    state = canonicalize_state(state)
    return unshard_state(state) if isinstance(state, ShardedState) else state


def _host_leaf(leaf: torch.Tensor) -> np.ndarray:
    """One leaf on the host with the reference's dtype (int32, float32 or
    bool): a wider dtype would restore into the reference and fail later."""
    if leaf.dtype not in _NUMPY_DTYPES:
        raise TypeError(f"engine state leaf has dtype {leaf.dtype}; expected int32, float32 or bool")
    return leaf.detach().cpu().numpy()


def save_state(
    path: str | Path,
    state: EngineState,
    registry,
    host_carries: dict | None = None,
) -> None:
    """Atomically write the engine snapshot, rings canonicalized and
    cursors stripped."""
    leaves = _archive_leaves(_canonical_whole(state))
    arrays = {f"leaf_{i}": _host_leaf(leaf) for i, leaf in enumerate(leaves)}
    meta = {
        "version": CKPT_VERSION,
        "n_leaves": len(leaves),
        "registry": registry.to_mapping(),
        "host_carries": host_carries or {},
    }
    atomic_savez(path, arrays, meta)


def _shard_path(path: Path, k: int, n: int) -> Path:
    """The archive holding shard ``k`` of ``n`` (shard 0 is ``path``)."""
    if k == 0:
        return path
    return path.with_name(f"{path.name}.shard{k}-of-{n}")


def _symbol_leaf_flags(leaves: list, capacity: int) -> list[bool]:
    """Which archive leaves carry the symbol axis (leading dimension equal
    to the capacity), the reference's rule."""
    if capacity == 4:
        raise ValueError("a capacity of 4 is ambiguous with the score vectors")
    return [leaf.dim() >= 1 and leaf.shape[0] == capacity for leaf in leaves]


def save_state_sharded(
    path: str | Path,
    state: EngineState,
    registry,
    n_shards: int,
    host_carries: dict | None = None,
) -> None:
    """Write the snapshot as ``n_shards`` archives (see the module
    docstring); one shard is :func:`save_state`'s monolithic archive."""
    n_shards = int(n_shards)
    if n_shards <= 1:
        return save_state(path, state, registry, host_carries=host_carries)
    state = _canonical_whole(state)
    leaves = _archive_leaves(state)
    capacity = int(state.buf15.filled.shape[0])
    flags = _symbol_leaf_flags(leaves, capacity)
    bounds = shard_bounds(capacity, n_shards)
    nonce = os.urandom(8).hex()
    path = Path(path)
    host = [_host_leaf(leaf) for leaf in leaves]
    for k in range(n_shards - 1, -1, -1):  # the manifest (k = 0) commits last
        lo, hi = bounds[k]
        arrays = {
            f"leaf_{i}": (host[i][lo:hi] if flags[i] else host[i])
            for i in range(len(host))
            if flags[i] or k == 0
        }
        meta = {
            "version": CKPT_VERSION,
            "n_leaves": len(leaves),
            "shard_count": n_shards,
            "shard_index": k,
            "rows": [lo, hi],
            "nonce": nonce,
        }
        if k == 0:
            meta["registry"] = registry.to_mapping()
            meta["host_carries"] = host_carries or {}
            meta["symbol_leaves"] = [i for i, f in enumerate(flags) if f]
        atomic_savez(_shard_path(path, k, n_shards), arrays, meta)


def _read_meta(data) -> dict:
    return json.loads(bytes(data["__meta"].tobytes()).decode())


def _sharded_arrays(path: Path, meta: dict, data, n_leaves: int) -> list[np.ndarray]:
    """A sharded archive set's leaves as whole host arrays: each symbol
    leaf's slices concatenated in shard order, the others from the
    manifest. Raises ValueError on a torn roster."""
    n = int(meta["shard_count"])
    sym = set(meta["symbol_leaves"])
    parts: dict[int, list] = {i: [data[f"leaf_{i}"]] for i in sym}
    for k in range(1, n):
        sp = _shard_path(path, k, n)
        if not sp.exists():
            raise ValueError(f"shard file {sp.name} missing (torn save) — start cold")
        with np.load(sp) as sd:
            smeta = _read_meta(sd)
            if smeta.get("nonce") != meta.get("nonce"):
                raise ValueError(f"shard {k} nonce mismatch (torn save) — start cold")
            if smeta.get("shard_index") != k or smeta.get("shard_count") != n:
                raise ValueError(f"shard file {sp.name} roster mismatch — start cold")
            for i in sym:
                parts[i].append(sd[f"leaf_{i}"])
    return [
        np.concatenate(parts[i], axis=0) if i in sym else data[f"leaf_{i}"]
        for i in range(n_leaves)
    ]


def _reattach_cursors(state: EngineState) -> EngineState:
    """Re-attach the canonical (zero) cursors the archive strips."""

    def with_cursor(triple) -> MarketBuffer:
        times, values, filled = triple
        return MarketBuffer(
            times=times, values=values, filled=filled, cursor=torch.zeros_like(filled)
        )

    return state._replace(buf5=with_cursor(state.buf5), buf15=with_cursor(state.buf15))


def load_state(path: str | Path, template_state: EngineState, registry):
    """Restore ``(state, host_carries)`` from ``path`` (a monolithic
    archive or a sharded set's manifest) into the template's structure, on
    the template's device; the registry is rebuilt row for row in place.
    Raises ValueError on a leaf count, shape or dtype that does not match
    (capacity or window changed: start cold instead), on a torn shard
    roster and on a sibling shard file given as the path."""
    path = Path(path)
    device = template_state.buf5.times.device
    with np.load(path) as data:
        meta = _read_meta(data)
        version = meta["version"]
        if version not in (1, 2, 3, CKPT_VERSION):
            raise ValueError(f"checkpoint version {version} unsupported")
        sharded = int(meta.get("shard_count", 1)) > 1
        if sharded and int(meta.get("shard_index", 0)) != 0:
            raise ValueError(
                f"{path.name} is a non-manifest shard file — restore from the manifest path"
            )
        t_leaves = _archive_leaves(template_state)
        ic = template_state.indicator_carry
        if version == 1:
            # v1 predates the indicator carry, the state's last field
            expected = len(t_leaves) - len(_flatten(ic))
        elif version == 2:
            # v2 holds the feature packs only; the later sub-carries follow
            expected = len(t_leaves) - (len(_flatten(ic)) - len(_flatten((ic.pack5, ic.pack15))))
        else:
            expected = len(t_leaves)
        if meta["n_leaves"] != expected:
            raise ValueError(
                f"checkpoint has {meta['n_leaves']} leaves, engine expects {expected}"
            )
        arrays = (
            _sharded_arrays(path, meta, data, len(t_leaves))
            if sharded
            else [data[f"leaf_{i}"] for i in range(meta["n_leaves"])]
        )
        leaves = []
        for i, t in enumerate(t_leaves):
            if i >= meta["n_leaves"]:
                leaves.append(t.clone())  # the template's empty carry (v1, v2)
                continue
            arr = arrays[i]
            if tuple(arr.shape) != tuple(t.shape):
                raise ValueError(
                    f"checkpoint leaf {i} shape {arr.shape} != {tuple(t.shape)} "
                    "(capacity/window changed — start cold)"
                )
            if arr.dtype != _NUMPY_DTYPES[t.dtype]:
                raise ValueError(f"checkpoint leaf {i} dtype {arr.dtype} != {t.dtype}")
            leaves.append(torch.from_numpy(np.array(arr, order="C")).to(device))
    state = _reattach_cursors(_unflatten(_sans_cursor(template_state), leaves))
    registry.restore(meta["registry"])
    carries = dict(meta.get("host_carries", {}))
    if version < 3:
        carries["_carry_rebuilt"] = True
    return state, carries


class CheckpointManager:
    """Periodic snapshots for the SignalEngine (a save every N ticks)."""

    def __init__(self, path: str | Path, every_ticks: int = 60) -> None:
        self.path = Path(path)
        self.every_ticks = max(int(every_ticks), 1)
        # host ms of the last save and restore: the device-to-host copy plus
        # ``savez``, and ``load`` plus the host-to-device copy
        self.last_save_ms: float | None = None
        self.last_restore_ms: float | None = None
        # the engine tick of the last successful save
        self.last_saved_tick: int | None = None

    def should_save(self, engine) -> bool:
        """The cadence check, cheap enough to run on the event loop."""
        return engine.ticks_processed > 0 and engine.ticks_processed % self.every_ticks == 0

    def maybe_save(self, engine) -> bool:
        """Save on the cadence; a failure is logged and counted, never
        raised. The engine must have no tick in flight (the consume loop
        flushes first), and none may be dispatched while the save reads
        the state (``engine.hold_state`` refuses a dispatch meanwhile)."""
        if not self.should_save(engine):
            return False
        t0 = time.perf_counter()
        try:
            n_shards = self.shard_count_for(engine)
            with engine.hold_state("checkpoint save"):
                save_state_sharded(self.path, engine.state, engine.registry, n_shards,
                                   host_carries=engine.host_carries())
        except Exception:
            CHECKPOINT_SAVES.labels(outcome="error").inc()
            logging.exception("checkpoint save failed; continuing")
            return False
        self.last_save_ms = (time.perf_counter() - t0) * 1000.0
        self.last_saved_tick = engine.ticks_processed
        CHECKPOINT_SAVES.labels(outcome="ok").inc()
        get_event_log().emit(
            "checkpoint_save",
            path=str(self.path),
            ticks=engine.ticks_processed,
            shards=n_shards,
            duration_ms=round(self.last_save_ms, 3),
        )
        fan = getattr(engine, "fanout", None)
        if fan is not None:
            # the fan-out snapshot sidecar rides the same cadence, so a
            # restart is warm on both planes or neither (a no-op without a
            # snapshot path; its failures are counted inside, never
            # failing the engine's save)
            fan.maybe_save_snapshot(default_shards=n_shards)
        return True

    @staticmethod
    def shard_count_for(engine) -> int:
        """The archives a save writes: the config's ``ckpt_shards`` when
        set, else the engine's mesh size (1 unsharded). A restore reads any
        saved count."""
        mesh = getattr(engine, "mesh", None)
        return int(getattr(engine.config, "ckpt_shards", 0) or 0) or (
            mesh.size if mesh is not None else 1
        )

    def try_restore(self, engine) -> bool:
        """Restore the engine from the archive; False (a cold start) when
        there is none or it cannot be loaded."""
        if not self.path.exists():
            return False
        t0 = time.perf_counter()
        mesh = getattr(engine, "mesh", None)
        # a sharded engine loads whole on the host, then places the state on
        # its own mesh, whatever shard count saved it
        template = (
            engine.state
            if mesh is None
            else initial_engine_state(engine.capacity, engine.window, device="cpu")
        )
        try:
            state, carries = load_state(self.path, template, engine.registry)
        except Exception:
            logging.exception("checkpoint restore failed; starting cold")
            return False
        if mesh is not None:
            state = shard_engine_state(state, mesh)
        engine.state = state
        # a restored state is a new lineage: no ring slot of the old one
        # may be written into it
        engine._invalidate_spares("checkpoint restore")
        engine.restore_host_carries(carries)
        engine.note_state_restored(migrated=bool(carries.get("_carry_rebuilt", False)))
        if engine.device.type == "cuda":
            torch.cuda.synchronize(engine.device)
        self.last_restore_ms = (time.perf_counter() - t0) * 1000.0
        get_event_log().emit(
            "checkpoint_restore",
            path=str(self.path),
            symbols=len(engine.registry),
            ticks=carries.get("ticks_processed"),
        )
        logging.info(
            "restored checkpoint: %d symbols, tick %s",
            len(engine.registry),
            carries.get("ticks_processed"),
        )
        return True
