"""Fan-out snapshot sidecar: restart-warm subscription planes.

The port's copy of ``binquant_tpu/fanout/snapshot.py``, one archive only.
The sidecar archives the COMPILED bitset planes plus a columnar image of
the subscription index (:meth:`~binquant_tpu_torch.fanout.registry.
SubscriptionRegistry.export_columns`), so a restart restores by array
load instead of rebuilding the population: the registry re-attaches the
columns as a lazy record base and the device takes one full push.

Layout (version 1, the reference's): one ``np.savez`` archive written by
:func:`~binquant_tpu_torch.io.checkpoint.atomic_savez` (temporary file,
then a rename) with a ``__meta`` JSON blob carrying the plane fields, a
per-save ``nonce``, ``shard_count`` 1 and ``symbol_rows``; ``sym_plane``
rides as ``sym_body`` (the symbol rows) and ``sym_tail`` (the no-row
bucket). An archive written by either package restores into the other.

Sharded archives (``n_shards > 1``: ``sym_plane`` rows split at the engine
mesh's shard bounds into sibling files) are not ported: saving one
raises, and loading a manifest with ``shard_count > 1`` raises, so the
plane starts cold, as it does on a torn or version-mismatched archive.
"""

from __future__ import annotations

import json
import os
from pathlib import Path

import numpy as np

from binquant_tpu_torch.io.checkpoint import atomic_savez

FANOUT_SNAP_VERSION = 1

# archive keys holding the raw plane arrays (sym_plane rides apart, as
# body + tail)
_PLANE_KEYS = ("strat_plane", "regime_plane", "any_masks", "floors")
_COLUMN_KEYS = (
    "uid_blob", "slots",
    "sym_counts", "sym_blob",
    "strat_counts", "strat_blob",
    "reg_counts", "reg_flat",
    "row_counts", "rows_flat",
    "free_slots",
    "min_seq_slots", "min_seq_vals",
)


def save_snapshot(
    path: str | Path,
    planes: dict[str, np.ndarray],
    columns: dict[str, np.ndarray],
    meta: dict,
    n_shards: int = 1,
) -> dict:
    """Write the sidecar archive; returns the manifest meta.

    ``planes`` must hold ``sym_plane`` (``(S+1, U32)``) plus
    ``_PLANE_KEYS``; ``columns`` is :meth:`SubscriptionRegistry
    .export_columns` output plus the min-seq columns; ``meta`` carries the
    plane-level fields (capacity, seq, fingerprint, …) echoed back at
    load."""
    if int(n_shards) > 1:
        raise ValueError(
            f"fanout snapshot n_shards={n_shards}: sharded archives are not "
            "ported yet (ROADMAP A10)"
        )
    sym_plane = np.ascontiguousarray(planes["sym_plane"], np.uint32)
    s = sym_plane.shape[0] - 1  # body rows; the tail bucket rides apart
    manifest_meta = dict(meta)
    manifest_meta.update(
        version=FANOUT_SNAP_VERSION,
        nonce=os.urandom(8).hex(),
        shard_count=1,
        shard_index=0,
        symbol_rows=s,
    )
    arrays = {
        "sym_body": sym_plane[:s],
        "sym_tail": sym_plane[s:],
        **{k: planes[k] for k in _PLANE_KEYS},
        **{k: columns[k] for k in _COLUMN_KEYS},
    }
    atomic_savez(path, arrays, manifest_meta)
    return manifest_meta


def load_snapshot(
    path: str | Path,
) -> tuple[dict[str, np.ndarray], dict[str, np.ndarray], dict]:
    """Load the archive → ``(planes, columns, meta)``.

    Raises ``ValueError`` on an unsupported version, a shard file, a
    sharded manifest or a row count that disagrees with the manifest (and
    whatever ``np.load`` raises on a torn file) — the caller starts cold.
    Arrays come back writable."""
    path = Path(path)
    with np.load(path) as data:
        meta = json.loads(bytes(data["__meta"].tobytes()).decode())
        if meta.get("version") != FANOUT_SNAP_VERSION:
            raise ValueError(
                f"fanout snapshot version {meta.get('version')} "
                f"unsupported (want {FANOUT_SNAP_VERSION})"
            )
        if int(meta.get("shard_index", 0)) != 0:
            raise ValueError(
                f"{path.name} is a non-manifest shard file — restore "
                "from the manifest path"
            )
        if int(meta.get("shard_count", 1)) > 1:
            raise ValueError(
                f"fanout snapshot {path.name} is sharded "
                f"(shard_count={meta['shard_count']}): not ported yet "
                "(ROADMAP A10) — start cold"
            )
        body = np.array(data["sym_body"])
        tail = np.array(data["sym_tail"])
        planes = {k: np.array(data[k]) for k in _PLANE_KEYS}
        columns = {k: np.array(data[k]) for k in _COLUMN_KEYS}
    sym_plane = np.concatenate([body, tail], axis=0)
    if sym_plane.shape[0] != int(meta["symbol_rows"]) + 1:
        raise ValueError(
            f"fanout snapshot holds {sym_plane.shape[0]} symbol rows, "
            f"manifest says {int(meta['symbol_rows']) + 1}"
        )
    planes["sym_plane"] = sym_plane
    return planes, columns, meta
