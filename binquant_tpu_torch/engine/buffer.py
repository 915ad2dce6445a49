"""Resident market ring buffer on the card.

Port of ``binquant_tpu/engine/buffer.py``: the whole market lives in one
fixed-shape ``(S symbols, W bars, F fields)`` tensor per interval, updated by
one batched scatter per candle sub-batch.

* **Circular write cursor**: each symbol's ``cursor`` is the slot its next
  append lands in; the k-th newest bar lives at ``(cursor - k) mod W``.
  ``cursor == 0`` with data packed at the right edge is the canonical
  (right-aligned) layout that :func:`materialize` returns. Full ticks keep
  the ring canonical; the incremental tick keeps it mid-phase and gathers
  only a right-aligned tail (:func:`materialize_tail`).
* **Routing** (:func:`route_updates`): a newer timestamp appends at the
  cursor, a timestamp already in the window (latest or mid-history)
  overwrites its slot in place, an older timestamp with no matching bar is
  dropped.
* Out-of-range rows are masked out before any scatter (the reference relies
  on ``mode="drop"`` scatters, which torch indexing does not have), and a row
  repeated within one batch keeps its LAST entry.

:func:`apply_updates_shift` is the reference's original shift-append update
on the canonical layout, kept as the cursor ring's bit-equality oracle in
the tests, never a live path.

The functions are functional: they return new tensors and leave their inputs
untouched, so a caller can keep the pre-update state (tests compare it). The
one exception is the in-place form of :func:`apply_updates_routed` /
:func:`apply_updates` (``inplace=True``): it scatters into the ring's own
``times`` and ``values`` planes instead of cloning them first — the
engine's step at ``pipeline_depth <= 1``, where the reference donates its
state (~72 MB of clones per apply at 2048 x 400 saved). Times are int32
seconds since epoch; values float32 with NaN where empty.
"""

from __future__ import annotations

import time
from enum import IntEnum
from typing import NamedTuple

import numpy as np
import torch

from binquant_tpu_torch.exceptions import BufferCapacityError
from binquant_tpu_torch.obs.instruments import (
    INGEST_DEDUP_OVERWRITES,
    REGISTRY_CAPACITY_ERRORS,
    REGISTRY_SYMBOLS,
)


class Field(IntEnum):
    """Column layout of the values tensor."""

    OPEN = 0
    HIGH = 1
    LOW = 2
    CLOSE = 3
    VOLUME = 4
    QUOTE_VOLUME = 5
    NUM_TRADES = 6
    TAKER_BUY_BASE = 7
    TAKER_BUY_QUOTE = 8
    DURATION_S = 9


FIELDS: tuple[str, ...] = tuple(f.name.lower() for f in Field)
NUM_FIELDS = len(Field)


def ms_to_s(ts_ms: int) -> int:
    return int(ts_ms) // 1000


def s_to_ms(ts_s: int | np.ndarray) -> np.ndarray | int:
    if isinstance(ts_s, np.ndarray):
        return ts_s.astype(np.int64) * 1000
    return int(ts_s) * 1000


class MarketBuffer(NamedTuple):
    times: torch.Tensor  # (S, W) int32 open-time seconds, -1 where empty
    values: torch.Tensor  # (S, W, F) float32, NaN where empty
    filled: torch.Tensor  # (S,) int32 count of valid bars (<= W)
    cursor: torch.Tensor  # (S,) int32 next-append slot in [0, W)

    @property
    def capacity(self) -> int:
        return self.times.shape[0]

    @property
    def window(self) -> int:
        return self.times.shape[1]

    @property
    def latest_times(self) -> torch.Tensor:
        return ring_latest_times(self)


def empty_buffer(
    num_symbols: int, window: int = 400, *, device: torch.device | str
) -> MarketBuffer:
    return MarketBuffer(
        times=torch.full((num_symbols, window), -1, dtype=torch.int32, device=device),
        values=torch.full(
            (num_symbols, window, NUM_FIELDS), float("nan"),
            dtype=torch.float32, device=device,
        ),
        filled=torch.zeros((num_symbols,), dtype=torch.int32, device=device),
        cursor=torch.zeros((num_symbols,), dtype=torch.int32, device=device),
    )


def ring_latest_times(buf: MarketBuffer) -> torch.Tensor:
    """(S,) open time of each symbol's newest bar (-1 where empty)."""
    W = buf.times.shape[1]
    idx = ((buf.cursor - 1) % W).long()
    return torch.gather(buf.times, 1, idx[:, None])[:, 0]


class UpdateRouting(NamedTuple):
    """One update batch's routing verdicts against the PRE-update ring."""

    upd_ts: torch.Tensor  # (S,) int32 per-row update ts, -1 = no update
    target: torch.Tensor  # (U,) int64 scatter row, S = dropped
    has_update: torch.Tensor  # (S,) bool
    is_append: torch.Tensor  # (S,) strictly-newer bar (or first bar)
    last_ts: torch.Tensor  # (S,) pre-update newest bar ts
    slot_match: torch.Tensor  # (S, W) the bar already holding upd_ts
    is_rewrite: torch.Tensor  # (S,) non-append with a matching bar


def _keep_last(rows: torch.Tensor, in_range: torch.Tensor, S: int) -> torch.Tensor:
    """(U,) bool: in-range entries that are the last occurrence of their row
    in the batch — the keep-last dedupe the host batcher guarantees, made
    explicit so the scatter below never sees a duplicate index."""
    U = rows.shape[0]
    pos = torch.arange(U, dtype=torch.int64, device=rows.device)
    target = torch.where(in_range, rows, S)
    last = torch.full((S + 1,), -1, dtype=torch.int64, device=rows.device)
    last.scatter_reduce_(0, target, pos, reduce="amax")
    return in_range & (last[target] == pos)


def route_updates(
    buf: MarketBuffer, row_idx: torch.Tensor, ts: torch.Tensor
) -> UpdateRouting:
    """Classify one update batch against the pre-update ring. The rewrite
    match reads only the (S, W) int32 times plane; per-symbol times are
    strictly increasing in ring order, so at most one slot matches."""
    S, W = buf.times.shape
    rows = row_idx.long()
    in_range = (rows >= 0) & (rows < S)
    keep = _keep_last(rows, in_range, S)
    # dropped entries scatter into a spare slot S that is cut off below:
    # no data-dependent shapes, so the card never waits on the host
    target = torch.where(keep, rows, S)
    upd = torch.full((S + 1,), -1, dtype=torch.int32, device=buf.times.device)
    upd.scatter_(0, target, ts.to(torch.int32))
    upd_ts = upd[:S]
    has_update = upd_ts >= 0
    last_ts = ring_latest_times(buf)
    is_append = has_update & ((buf.filled == 0) | (upd_ts > last_ts))
    slot_match = (buf.times == upd_ts[:, None]) & has_update[:, None]
    is_rewrite = has_update & ~is_append & slot_match.any(dim=1)
    return UpdateRouting(
        upd_ts, target, has_update, is_append, last_ts, slot_match, is_rewrite
    )


def _scatter_updates(buf: MarketBuffer, row_idx, ts, vals):
    """Routing plus the (S, F) per-row update values."""
    S = buf.times.shape[0]
    r = route_updates(buf, row_idx, ts)
    vals = vals.to(torch.float32)
    upd = torch.zeros(
        (S + 1, NUM_FIELDS), dtype=torch.float32, device=buf.values.device
    )
    upd.scatter_(0, r.target[:, None].expand(-1, NUM_FIELDS), vals)
    return r, upd[:S]


def apply_updates_routed(
    buf: MarketBuffer, r: UpdateRouting, upd_vals: torch.Tensor, inplace: bool = False
) -> MarketBuffer:
    """Scatter core of :func:`apply_updates` over a precomputed routing:
    appends write one column at the cursor, rewrites overwrite the slot
    already holding the timestamp. ``inplace`` writes ``buf.times`` and
    ``buf.values`` themselves (the returned ring shares them); otherwise
    both planes are cloned first and ``buf`` is left untouched."""
    S, W, F = buf.values.shape

    def put(plane, slot, new, write):
        # one column per row at ``slot``; rows not written get their own
        # value back, so every row scatters exactly one index
        if plane.dim() == 2:
            idx = slot[:, None]
            old = torch.gather(plane, 1, idx)[:, 0]
            plane.scatter_(1, idx, torch.where(write, new, old)[:, None])
        else:
            idx = slot[:, None, None].expand(S, 1, F)
            old = torch.gather(plane, 1, idx)[:, 0]
            plane.scatter_(
                1, idx, torch.where(write[:, None], new, old)[:, None, :]
            )

    app = r.is_append
    cursor = buf.cursor.long()
    times = buf.times if inplace else buf.times.clone()
    values = buf.values if inplace else buf.values.clone()
    put(times, cursor, r.upd_ts, app)
    put(values, cursor, upd_vals, app)
    rw_slot = r.slot_match.to(torch.int32).argmax(dim=1)
    put(values, rw_slot, upd_vals, r.is_rewrite)

    filled = torch.where(
        app, torch.clamp(buf.filled + 1, max=W), buf.filled
    ).to(torch.int32)
    new_cursor = torch.where(app, (buf.cursor + 1) % W, buf.cursor).to(torch.int32)
    return MarketBuffer(times=times, values=values, filled=filled, cursor=new_cursor)


def apply_updates(
    buf: MarketBuffer,
    row_idx: torch.Tensor,  # (U,) int32 registry rows; out-of-range ignored
    ts: torch.Tensor,  # (U,) int32 open-time seconds
    vals: torch.Tensor,  # (U, F) float32
    inplace: bool = False,
) -> MarketBuffer:
    """Apply one sub-batch of closed candles in a single batched update
    (``inplace``: see :func:`apply_updates_routed`)."""
    r, upd_vals = _scatter_updates(buf, row_idx, ts, vals)
    return apply_updates_routed(buf, r, upd_vals, inplace)


def apply_updates_shift(
    buf: MarketBuffer,
    row_idx: torch.Tensor,
    ts: torch.Tensor,
    vals: torch.Tensor,
) -> MarketBuffer:
    """The reference's original shift-append update, canonical layout only
    (``cursor`` all zeros, and it stays zero): an append shifts the row
    left by one bar and writes the new bar at ``W-1``, a rewrite overwrites
    the bar holding its timestamp. The bit-equality oracle for the cursor
    ring (``materialize`` of :func:`apply_updates`'s ring equals it); not a
    live path."""
    W = buf.times.shape[1]
    r, upd_vals = _scatter_updates(buf, row_idx, ts, vals)
    app_times = torch.cat([buf.times[:, 1:], r.upd_ts[:, None]], dim=1)
    app_vals = torch.cat([buf.values[:, 1:, :], upd_vals[:, None, :]], dim=1)
    rw_vals = torch.where(
        (r.is_rewrite[:, None] & r.slot_match)[..., None],
        upd_vals[:, None, :],
        buf.values,
    )
    sel_a = r.is_append[:, None]
    times = torch.where(sel_a, app_times, buf.times)
    values = torch.where(sel_a[..., None], app_vals, rw_vals)
    filled = torch.where(
        r.is_append, torch.clamp(buf.filled + 1, max=W), buf.filled
    ).to(torch.int32)
    return MarketBuffer(times=times, values=values, filled=filled, cursor=buf.cursor)


def materialize_tail(buf: MarketBuffer, width: int) -> MarketBuffer:
    """Right-aligned view of each symbol's newest ``width`` bars (empties at
    the -1/NaN sentinels); ``filled`` stays the true count."""
    S, W = buf.times.shape
    width = min(width, W)
    offs = torch.arange(width, dtype=torch.int64, device=buf.times.device) - width
    idx = (buf.cursor.long()[:, None] + offs[None, :]) % W
    t = torch.gather(buf.times, 1, idx)
    v = torch.gather(
        buf.values, 1, idx[:, :, None].expand(S, width, buf.values.shape[2])
    )
    return MarketBuffer(
        times=t, values=v, filled=buf.filled, cursor=torch.zeros_like(buf.cursor)
    )


def materialize(buf: MarketBuffer) -> MarketBuffer:
    """Canonical (right-aligned, ``cursor = 0``) view of a ring."""
    return materialize_tail(buf, buf.times.shape[1])


def fresh_mask(buf: MarketBuffer, timestamp_s: torch.Tensor) -> torch.Tensor:
    """(S,) bool — symbols whose latest closed bar is exactly ``timestamp_s``."""
    return (buf.filled > 0) & (ring_latest_times(buf) == timestamp_s)


def valid_mask(buf: MarketBuffer) -> torch.Tensor:
    """(S, W) bool — True where a real bar is stored."""
    return buf.times >= 0


def field(buf: MarketBuffer, f: Field) -> torch.Tensor:
    """(S, W) view of one OHLCV field."""
    return buf.values[:, :, int(f)]


def reset_rows(buf: MarketBuffer, rows: torch.Tensor) -> MarketBuffer:
    """Clear specific rows (symbols that left the universe); out-of-range
    indices are ignored."""
    S = buf.times.shape[0]
    rows = rows.long()
    target = torch.where((rows >= 0) & (rows < S), rows, S)
    mask = torch.zeros((S + 1,), dtype=torch.bool, device=buf.times.device)
    mask[target] = True
    mask = mask[:S]
    return MarketBuffer(
        times=torch.where(mask[:, None], -1, buf.times).to(torch.int32),
        values=torch.where(mask[:, None, None], float("nan"), buf.values),
        filled=torch.where(mask, 0, buf.filled).to(torch.int32),
        cursor=torch.where(mask, 0, buf.cursor).to(torch.int32),
    )


def split_updates(rows, ts, vals, capacity: int, n_shards: int) -> list[tuple]:
    """Route one host update batch ``(rows (..., U), ts (..., U), vals (...,
    U, F))`` to the shards that own its rows (``parallel/mesh.py``
    ``shard_bounds``), each row rebased to its shard's local index: a list
    of per-shard host batches. Leading slot axes (a stacked batch) are
    kept: a slot's entries of one shard move to its front, in their order
    (so a repeated row still keeps its last entry), padded with rows -1 to
    that shard's widest slot. An entry no shard owns (a -1 pad, an
    out-of-range row) goes nowhere; the apply drops it either way."""
    rows = np.asarray(rows, dtype=np.int32)
    ts = np.asarray(ts, dtype=np.int32)
    vals = np.asarray(vals, dtype=np.float32)
    lead, width = rows.shape[:-1], rows.shape[-1]
    n_slots = int(np.prod(lead, dtype=np.int64))
    r2 = rows.reshape(n_slots, width)
    t2 = ts.reshape(n_slots, width)
    v2 = vals.reshape(n_slots, width, vals.shape[-1])
    block = capacity // n_shards
    out = []
    for k in range(n_shards):
        lo = k * block
        own = (r2 >= lo) & (r2 < lo + block)
        counts = own.sum(axis=1)
        w = int(counts.max()) if len(counts) else 0
        rk = np.full((len(r2), w), -1, np.int32)
        tk = np.full((len(r2), w), -1, np.int32)
        vk = np.zeros((len(r2), w, v2.shape[-1]), np.float32)
        for i in range(len(r2)):
            sel = own[i]
            n = int(counts[i])
            rk[i, :n] = r2[i, sel] - lo
            tk[i, :n] = t2[i, sel]
            vk[i, :n] = v2[i, sel]
        out.append((rk.reshape(*lead, w), tk.reshape(*lead, w), vk.reshape(*lead, w, v2.shape[-1])))
    return out


class FrozenRows:
    """Point-in-time row→name mapping (see SymbolRegistry.frozen_rows)."""

    def __init__(self, row_to_name: dict[int, str]) -> None:
        self._row_to_name = row_to_name

    def name_of(self, row: int) -> str | None:
        return self._row_to_name.get(int(row))


class SymbolRegistry:
    """Host-side symbol↔row mapping with a free list. Symbols joining claim
    the lowest free row; capacity is static so tensor shapes never change."""

    def __init__(self, capacity: int) -> None:
        self.capacity = capacity
        self._name_to_row: dict[str, int] = {}
        self._row_to_name: dict[int, str] = {}
        self._free: list[int] = list(range(capacity - 1, -1, -1))  # pop() → lowest
        self.version = 0

    def __len__(self) -> int:
        return len(self._name_to_row)

    def __contains__(self, symbol: str) -> bool:
        return self._norm(symbol) in self._name_to_row

    @staticmethod
    def _norm(symbol: str) -> str:
        return symbol.strip().upper()

    def row_of(self, symbol: str) -> int | None:
        return self._name_to_row.get(self._norm(symbol))

    def name_of(self, row: int) -> str | None:
        return self._row_to_name.get(row)

    def rows_for(self, symbols: list[str], add_missing: bool = True) -> np.ndarray:
        """(N,) int32 rows of ``symbols``, claiming rows for new ones
        (``add_missing``) or -1 for unknown ones."""
        out = np.empty(len(symbols), dtype=np.int32)
        for i, s in enumerate(symbols):
            if add_missing:
                out[i] = self.add(s)
            else:
                row = self.row_of(s)
                out[i] = -1 if row is None else row
        return out

    @property
    def names(self) -> list[str]:
        """The registered symbols, sorted (the open-interest refresh walks
        them)."""
        return sorted(self._name_to_row)

    def to_mapping(self) -> dict[str, int]:
        """A copy of the symbol → row mapping."""
        return dict(self._name_to_row)

    def frozen_rows(self) -> FrozenRows:
        return FrozenRows(dict(self._row_to_name))

    def add(self, symbol: str) -> int:
        """Return the symbol's row, claiming one if new. Raises when full."""
        key = self._norm(symbol)
        row = self._name_to_row.get(key)
        if row is not None:
            return row
        if not self._free:
            REGISTRY_CAPACITY_ERRORS.inc()
            raise BufferCapacityError(
                f"SymbolRegistry full ({self.capacity}); grow the buffer capacity"
            )
        row = self._free.pop()
        self._name_to_row[key] = row
        self._row_to_name[row] = key
        self.version += 1
        REGISTRY_SYMBOLS.set(len(self._name_to_row))
        return row

    def remove(self, symbol: str) -> int | None:
        key = self._norm(symbol)
        row = self._name_to_row.pop(key, None)
        if row is not None:
            del self._row_to_name[row]
            self._free.append(row)
            self.version += 1
            REGISTRY_SYMBOLS.set(len(self._name_to_row))
        return row

    def restore(self, mapping: dict[str, int]) -> None:
        """Rebuild the exact symbol↔row assignment of a checkpoint, so the
        restored rings line up with their symbols."""
        self._name_to_row = {}
        self._row_to_name = {}
        for symbol, row in mapping.items():
            row = int(row)
            if not 0 <= row < self.capacity:
                raise BufferCapacityError(
                    f"checkpoint row {row} outside capacity {self.capacity}"
                )
            key = self._norm(symbol)
            self._name_to_row[key] = row
            self._row_to_name[row] = key
        used = set(self._row_to_name)
        self._free = [r for r in range(self.capacity - 1, -1, -1) if r not in used]
        self.version += 1
        REGISTRY_SYMBOLS.set(len(self._name_to_row))

    @property
    def active_rows(self) -> np.ndarray:
        """(S,) bool mask of occupied rows."""
        mask = np.zeros(self.capacity, dtype=bool)
        for row in self._row_to_name:
            mask[row] = True
        return mask


class IngestBatcher:
    """Host-side accumulator turning per-candle dicts into update batches.

    Dedupes by (symbol, open_time) keep-last and yields one sub-batch per
    timestamp rank, oldest first, so sequential :func:`apply_updates` calls
    replay a symbol's pending bars in order. Pre-normalized sub-batches from
    :meth:`add_batch` drain first.
    """

    def __init__(self, registry: SymbolRegistry) -> None:
        self.registry = registry
        self._pending: dict[tuple[str, int], np.ndarray] = {}
        self._prebuilt: list[tuple[np.ndarray, np.ndarray, np.ndarray]] = []
        # perf_counter of the OLDEST candle waiting since the last drain:
        # the ingest-arrival anchor of the tick that drains it (the
        # ingest→dispatch freshness stage). Reset by drain().
        self.first_pending_mono: float | None = None

    def __len__(self) -> int:
        return len(self._pending) + sum(len(r) for r, _, _ in self._prebuilt)

    def add_batch(
        self, row_idx: np.ndarray, ts_s: np.ndarray, vals: np.ndarray
    ) -> None:
        """Bulk ingest of an already-normalized (row_idx, ts_s, vals (U, F))
        sub-batch; rows must already be registry rows."""
        if self.first_pending_mono is None:
            self.first_pending_mono = time.perf_counter()
        self._prebuilt.append(
            (
                np.asarray(row_idx, dtype=np.int32),
                np.asarray(ts_s, dtype=np.int32),
                np.asarray(vals, dtype=np.float32),
            )
        )

    def add(self, kline: dict) -> None:
        symbol = str(kline.get("symbol", "")).strip().upper()
        if not symbol:
            return  # malformed kline; never claim a registry row for ""
        if self.first_pending_mono is None:
            self.first_pending_mono = time.perf_counter()
        open_time_ms = int(kline.get("open_time", 0))
        close_time_ms = int(kline.get("close_time", 0)) or open_time_ms
        row = np.array(
            [
                float(kline.get("open", 0.0)),
                float(kline.get("high", 0.0)),
                float(kline.get("low", 0.0)),
                float(kline.get("close", 0.0)),
                float(kline.get("volume", 0.0)),
                float(kline.get("quote_asset_volume", 0.0)),
                float(kline.get("number_of_trades", 0.0)),
                float(kline.get("taker_buy_base_volume", 0.0)),
                float(kline.get("taker_buy_quote_volume", 0.0)),
                # round, don't floor: Binance close_time is open+interval-1ms
                float(round((close_time_ms - open_time_ms) / 1000.0)),
            ],
            dtype=np.float32,
        )
        key = (symbol, ms_to_s(open_time_ms))
        if key in self._pending:
            # keep-last dedupe evicting a stale payload for the same bar
            INGEST_DEDUP_OVERWRITES.inc()
        self._pending[key] = row

    def drain(self) -> list[tuple[np.ndarray, np.ndarray, np.ndarray]]:
        """(row_idx, ts_s, vals) sub-batches, at most one candle per symbol
        each, oldest timestamp first per symbol. Clears pending state."""
        per_symbol: dict[str, list[tuple[int, np.ndarray]]] = {}
        for (symbol, t), v in self._pending.items():
            per_symbol.setdefault(symbol, []).append((t, v))
        max_depth = 0
        for entries in per_symbol.values():
            entries.sort(key=lambda e: e[0])
            max_depth = max(max_depth, len(entries))

        batches: list[tuple[np.ndarray, np.ndarray, np.ndarray]] = []
        if self._prebuilt:
            batches.extend(self._prebuilt)
            self._prebuilt = []
        for depth in range(max_depth):
            rows_d = [
                (self.registry.add(sym), *entries[depth])
                for sym, entries in per_symbol.items()
                if len(entries) > depth
            ]
            row_idx = np.array([r for r, _, _ in rows_d], dtype=np.int32)
            ts = np.array([t for _, t, _ in rows_d], dtype=np.int32)
            vals = np.stack([v for _, _, v in rows_d]).astype(np.float32)
            batches.append((row_idx, ts, vals))
        # clear only after every registry.add() succeeded, so a full
        # registry raises without losing the tick's candles
        self._pending.clear()
        self.first_pending_mono = None
        return batches
