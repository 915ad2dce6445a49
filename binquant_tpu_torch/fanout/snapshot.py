"""Fan-out snapshot sidecar: restart-warm subscription planes.

The port's copy of ``binquant_tpu/fanout/snapshot.py``.
The sidecar archives the COMPILED bitset planes plus a columnar image of
the subscription index (:meth:`~binquant_tpu_torch.fanout.registry.
SubscriptionRegistry.export_columns`), so a restart restores by array
load instead of rebuilding the population: the registry re-attaches the
columns as a lazy record base and the device takes one full push.

Layout (version 1, the reference's): ``np.savez`` archives written by
:func:`~binquant_tpu_torch.io.checkpoint.atomic_savez` (temporary file,
then a rename), each with a ``__meta`` JSON blob. The manifest ``<path>``
carries the plane fields, a per-save ``nonce``, ``shard_count`` and
``symbol_rows``; ``sym_plane`` rides as ``sym_body`` (symbol rows) and
``sym_tail`` (the no-row bucket, on the manifest). At ``n_shards > 1`` the
symbol rows split at :func:`~binquant_tpu_torch.parallel.mesh.shard_bounds`
into ``<path>.shardK-of-N`` siblings, committed before the manifest, so a
torn save (a missing sibling, a nonce or roster that differs from the
manifest's) is rejected into a cold start. An archive set written by
either package at any shard count restores into the other.
"""

from __future__ import annotations

import json
import os
from pathlib import Path

import numpy as np

from binquant_tpu_torch.io.checkpoint import _shard_path, atomic_savez
from binquant_tpu_torch.parallel.mesh import shard_bounds

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
    """Write the sidecar archive set; returns the manifest meta.

    ``planes`` must hold ``sym_plane`` (``(S+1, U32)``) plus
    ``_PLANE_KEYS``; ``columns`` is :meth:`SubscriptionRegistry
    .export_columns` output plus the min-seq columns; ``meta`` carries the
    plane-level fields (capacity, seq, fingerprint, …) echoed back at
    load."""
    path = Path(path)
    n_shards = max(int(n_shards), 1)
    sym_plane = np.ascontiguousarray(planes["sym_plane"], np.uint32)
    s = sym_plane.shape[0] - 1  # body rows; the tail bucket rides the manifest
    nonce = os.urandom(8).hex()
    manifest_meta = dict(meta)
    manifest_meta.update(
        version=FANOUT_SNAP_VERSION,
        nonce=nonce,
        shard_count=n_shards,
        shard_index=0,
        symbol_rows=s,
    )
    bounds = shard_bounds(s, n_shards)
    if n_shards > 1:
        manifest_meta["shard_bounds"] = [list(b) for b in bounds]
    # the siblings first, the manifest last
    for k in range(n_shards - 1, 0, -1):
        lo, hi = bounds[k]
        atomic_savez(
            _shard_path(path, k, n_shards),
            {"sym_body": sym_plane[lo:hi]},
            {
                "version": FANOUT_SNAP_VERSION,
                "nonce": nonce,
                "shard_count": n_shards,
                "shard_index": k,
                "rows": [int(lo), int(hi)],
            },
        )
    lo, hi = bounds[0]
    arrays = {
        "sym_body": sym_plane[lo:hi],
        "sym_tail": sym_plane[s:],
        **{k: planes[k] for k in _PLANE_KEYS},
        **{k: columns[k] for k in _COLUMN_KEYS},
    }
    atomic_savez(path, arrays, manifest_meta)
    return manifest_meta


def load_snapshot(
    path: str | Path,
) -> tuple[dict[str, np.ndarray], dict[str, np.ndarray], dict]:
    """Load and reassemble the archive set → ``(planes, columns, meta)``.

    Raises ``ValueError`` on an unsupported version, a sibling file given
    as the path, a torn roster (a missing sibling, a nonce or roster that
    differs from the manifest's) or a row count that disagrees with the
    manifest (and whatever ``np.load`` raises on a torn file) — the caller
    starts cold. Arrays come back writable."""
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
        n = int(meta.get("shard_count", 1))
        parts = [np.array(data["sym_body"])]
        tail = np.array(data["sym_tail"])
        planes = {k: np.array(data[k]) for k in _PLANE_KEYS}
        columns = {k: np.array(data[k]) for k in _COLUMN_KEYS}
    for k in range(1, n):
        sp = _shard_path(path, k, n)
        if not sp.exists():
            raise ValueError(f"fanout snapshot shard {sp.name} missing (torn save) — start cold")
        with np.load(sp) as sd:
            smeta = json.loads(bytes(sd["__meta"].tobytes()).decode())
            if smeta.get("nonce") != meta.get("nonce"):
                raise ValueError(
                    f"fanout snapshot shard {k} nonce mismatch (torn save) — start cold"
                )
            if smeta.get("shard_index") != k or smeta.get("shard_count") != n:
                raise ValueError(f"fanout snapshot shard {sp.name} roster mismatch — start cold")
            parts.append(np.array(sd["sym_body"]))
    sym_plane = np.concatenate(parts + [tail], axis=0)
    if sym_plane.shape[0] != int(meta["symbol_rows"]) + 1:
        raise ValueError(
            f"fanout snapshot holds {sym_plane.shape[0]} symbol rows, "
            f"manifest says {int(meta['symbol_rows']) + 1}"
        )
    planes["sym_plane"] = sym_plane
    return planes, columns, meta
