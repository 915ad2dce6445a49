"""Subscription registry and packed-bitset plane compiler.

The port's own copy of ``binquant_tpu/fanout/registry.py`` (numpy only).
A :class:`Subscription` is one user's standing filter — symbols ×
strategies × regimes × a minimum signal strength — and the
:class:`SubscriptionRegistry` compiles the whole user population into
dense uint32 bitset planes the device match (:mod:`.kernel`) joins
against a tick's fired slots:

* ``sym_plane``    — ``(S + 1, U32)``: bit ``u`` of word column set when
  user ``u`` subscribed to the symbol occupying engine row ``s``
  explicitly; the trailing row is the always-empty bucket a fired symbol
  with no current row gathers;
* ``strat_plane``  — ``(N_strategies, U32)``: per-strategy user bits, row
  order = ``engine.step.STRATEGY_ORDER``;
* ``regime_plane`` — ``(len(MarketRegimeCode) + 1, U32)``: per-regime user
  bits; the extra trailing row is the *invalid-context* bucket (a tick
  whose market context has not stabilized matches only regime-wildcard
  subscribers);
* ``any_masks``    — ``(3, U32)``: the wildcard words (symbols=None /
  strategies=None / regimes=None — "all"), OR-ed into the corresponding
  plane gather at match time;
* ``floors``       — ``(U,)`` f32 per-slot minimum strength (matched
  against ``|score|``; unoccupied slots carry ``+inf``).

``U32 = capacity // 32`` and ``U = capacity``; slot ``u`` → word ``u >> 5``,
bit ``u & 31`` (``np.packbits(..., bitorder="little")``'s layout).

Churn (add / update / remove) flips ONE bit column host-side and records
the touched ``(plane, row, word)`` cells dirty; the device copy patches
them at the next match (``kind="incremental"``). Growth past the capacity,
:meth:`SubscriptionRegistry.compact`, a symbol-row refresh and a restore
force one full push (``kind="full"``). Symbol subscriptions are stored by
NAME and re-resolve against the engine's ``SymbolRegistry`` whenever its
``version`` moves.

Snapshot-warm boot: :meth:`SubscriptionRegistry.export_columns` emits a
slot-ordered columnar image of the subscription index that
:meth:`~SubscriptionRegistry.restore_columns` adopts wholesale — restored
records materialize lazily on first touch through :class:`_RecordMap`.
Archives cross between this package and the reference both ways.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Iterable, Iterator

import numpy as np

from binquant_tpu_torch.engine.step import STRATEGY_ORDER
from binquant_tpu_torch.enums import MarketRegimeCode

# index into regime_plane for a tick without a valid market context
REGIME_ROWS = len(MarketRegimeCode) + 1
INVALID_REGIME_ROW = len(MarketRegimeCode)

_STRAT_IDX: dict[str, int] = {s: i for i, s in enumerate(STRATEGY_ORDER)}

# any_masks rows
ANY_SYM, ANY_STRAT, ANY_REGIME = 0, 1, 2

# delta-cell plane ids: a dirty cell is (plane_id, row, word) — the unit
# the jit'd apply_subscription_deltas scatter patches on device
P_SYM, P_STRAT, P_REGIME, P_ANY = 0, 1, 2, 3


@dataclass(frozen=True)
class Subscription:
    """One user's standing signal filter. ``None`` criteria mean "all"."""

    user_id: str
    symbols: frozenset[str] | None = None
    strategies: frozenset[str] | None = None
    regimes: frozenset[int] | None = None
    min_strength: float = 0.0

    def __post_init__(self) -> None:
        # the floor is quantized to f32 AT THE MODEL BOUNDARY: the device
        # planes store f32, and an unquantized f64 here would let oracle
        # and kernel disagree on scores inside the rounding gap (e.g.
        # floor 0.1: f32(0.1)=0.100000001 matches a score of 0.099999999
        # on device but not in f64)
        object.__setattr__(
            self, "min_strength", float(np.float32(self.min_strength))
        )
        if self.strategies is not None:
            unknown = set(self.strategies) - set(STRATEGY_ORDER)
            if unknown:
                raise ValueError(
                    f"unknown strategies {sorted(unknown)}; valid: "
                    f"{list(STRATEGY_ORDER)}"
                )
        if self.regimes is not None:
            bad = [r for r in self.regimes if not 0 <= int(r) < len(MarketRegimeCode)]
            if bad:
                raise ValueError(
                    f"regime codes {bad} outside MarketRegimeCode range"
                )

    def matches(
        self, strategy: str, symbol: str, score: float,
        regime: int | None,
    ) -> bool:
        """The Python-oracle predicate the device kernel must agree with
        bit-for-bit. ``regime=None`` is the invalid-context tick."""
        if self.strategies is not None and strategy not in self.strategies:
            return False
        if self.symbols is not None and symbol not in self.symbols:
            return False
        if self.regimes is not None and (
            regime is None or int(regime) not in {int(r) for r in self.regimes}
        ):
            return False
        # compare in f32, exactly as the kernel does (score is cast f32
        # on the way to the device; min_strength is f32-quantized above)
        return bool(
            np.abs(np.float32(score)) >= np.float32(self.min_strength)
        )


@dataclass
class _SlotRecord:
    sub: Subscription
    slot: int
    # engine rows the symbol set resolved to at the last row refresh
    rows: list[int] = field(default_factory=list)


def _norm_symbols(symbols: Iterable[str] | None) -> frozenset[str] | None:
    if symbols is None:
        return None
    return frozenset(s.strip().upper() for s in symbols)


def _fast_sub(
    user_id: str,
    symbols: frozenset[str] | None,
    strategies: frozenset[str] | None,
    regimes: frozenset[int] | None,
    min_strength: float,
) -> Subscription:
    """Rebuild a Subscription from archived columns WITHOUT
    ``__post_init__``: every field was validated and f32-quantized when
    originally added, so re-running the checks would only burn the
    warm-boot budget (a million eager constructions take seconds)."""
    sub = Subscription.__new__(Subscription)
    d = sub.__dict__
    d["user_id"] = user_id
    d["symbols"] = symbols
    d["strategies"] = strategies
    d["regimes"] = regimes
    d["min_strength"] = min_strength
    return sub


class _ColumnarBase:
    """Decoded snapshot columns + the per-user lazy record factory.

    Holds the slot-ordered arrays :meth:`SubscriptionRegistry
    .export_columns` archived — uids, slots, per-criterion counts (−1 =
    wildcard) with flattened name/code blobs, resolved symbol rows — and
    a reference to the registry's live ``floors`` array (a slot's floor
    only mutates through ``_set_bits`` on a record that is then live, so
    reading it at materialization time is always current)."""

    __slots__ = (
        "uids", "slots", "floors",
        "sym_counts", "sym_names", "sym_off",
        "strat_counts", "strat_names", "strat_off",
        "reg_counts", "reg_flat", "reg_off",
        "row_counts", "rows_flat", "row_off",
    )

    @staticmethod
    def _split(blob: np.ndarray) -> list[str]:
        if blob.size == 0:
            return []
        return blob.tobytes().decode("utf-8").split("\n")

    @staticmethod
    def _offsets(counts: np.ndarray) -> np.ndarray:
        return np.concatenate(
            ([0], np.cumsum(np.maximum(counts, 0), dtype=np.int64))
        )

    def __init__(self, arrays: dict, floors: np.ndarray) -> None:
        self.uids = self._split(arrays["uid_blob"])
        self.slots = np.asarray(arrays["slots"], np.int64)
        self.floors = floors
        self.sym_counts = np.asarray(arrays["sym_counts"], np.int64)
        self.sym_names = self._split(arrays["sym_blob"])
        self.sym_off = self._offsets(self.sym_counts)
        self.strat_counts = np.asarray(arrays["strat_counts"], np.int64)
        self.strat_names = self._split(arrays["strat_blob"])
        self.strat_off = self._offsets(self.strat_counts)
        self.reg_counts = np.asarray(arrays["reg_counts"], np.int64)
        self.reg_flat = np.asarray(arrays["reg_flat"], np.int64)
        self.reg_off = self._offsets(self.reg_counts)
        self.row_counts = np.asarray(arrays["row_counts"], np.int64)
        self.rows_flat = np.asarray(arrays["rows_flat"], np.int64)
        self.row_off = self._offsets(self.row_counts)

    def row(self, k: int) -> tuple:
        """Column slice ``k`` as an export tuple — no object builds."""
        syms = (
            self.sym_names[self.sym_off[k]: self.sym_off[k + 1]]
            if self.sym_counts[k] >= 0 else None
        )
        strats = (
            self.strat_names[self.strat_off[k]: self.strat_off[k + 1]]
            if self.strat_counts[k] >= 0 else None
        )
        regs = (
            self.reg_flat[self.reg_off[k]: self.reg_off[k + 1]].tolist()
            if self.reg_counts[k] >= 0 else None
        )
        rows = self.rows_flat[self.row_off[k]: self.row_off[k + 1]].tolist()
        return (self.uids[k], int(self.slots[k]), syms, strats, regs, rows)

    def record(self, k: int) -> _SlotRecord:
        uid, slot, syms, strats, regs, rows = self.row(k)
        sub = _fast_sub(
            uid,
            frozenset(syms) if syms is not None else None,
            frozenset(strats) if strats is not None else None,
            frozenset(int(r) for r in regs) if regs is not None else None,
            float(self.floors[slot]),
        )
        return _SlotRecord(sub=sub, slot=slot, rows=rows)


class _RecordMap:
    """``user_id → _SlotRecord`` mapping with an optional columnar base.

    Without a base it is a plain dict. After :meth:`SubscriptionRegistry
    .restore_columns` attaches one, records materialize on first touch
    (get/pop/setitem), keeping warm boot O(archive load); bulk consumers
    (``values``/``items`` — the match oracle, compaction, tests)
    materialize everything and are deliberately the slow path."""

    __slots__ = ("_live", "_base", "_base_idx")

    def __init__(self) -> None:
        self._live: dict[str, _SlotRecord] = {}
        self._base: _ColumnarBase | None = None
        # uid → column index for records NOT yet materialized (keys are
        # always disjoint from _live)
        self._base_idx: dict[str, int] = {}

    def attach_base(self, base: _ColumnarBase) -> None:
        self._base = base
        self._base_idx = {u: k for k, u in enumerate(base.uids)}

    @property
    def lazy_count(self) -> int:
        return len(self._base_idx)

    def _materialize(self, uid: str) -> _SlotRecord:
        k = self._base_idx.pop(uid)
        rec = self._base.record(k)
        self._live[uid] = rec
        return rec

    def __len__(self) -> int:
        return len(self._live) + len(self._base_idx)

    def __contains__(self, uid: str) -> bool:
        return uid in self._live or uid in self._base_idx

    def __iter__(self) -> Iterator[str]:
        yield from self._live
        yield from list(self._base_idx)

    def get(self, uid: str, default=None):
        rec = self._live.get(uid)
        if rec is not None:
            return rec
        if uid in self._base_idx:
            return self._materialize(uid)
        return default

    def __getitem__(self, uid: str) -> _SlotRecord:
        rec = self.get(uid)
        if rec is None:
            raise KeyError(uid)
        return rec

    def __setitem__(self, uid: str, rec: _SlotRecord) -> None:
        self._base_idx.pop(uid, None)
        self._live[uid] = rec

    def pop(self, uid: str, default=None):
        if uid in self._base_idx:
            self._materialize(uid)
        return self._live.pop(uid, default)

    def values(self):
        for uid in list(self._base_idx):
            self._materialize(uid)
        return self._live.values()

    def items(self):
        for uid in list(self._base_idx):
            self._materialize(uid)
        return self._live.items()

    def export_rows(self) -> Iterator[tuple]:
        """Yield ``(uid, slot, symbols, strategies, regimes, rows)`` for
        every record — live ones from their objects, lazy ones straight
        from the columns (no materialization; criteria lists sorted for a
        deterministic archive)."""
        for rec in self._live.values():
            sub = rec.sub
            yield (
                sub.user_id,
                rec.slot,
                sorted(sub.symbols) if sub.symbols is not None else None,
                sorted(sub.strategies)
                if sub.strategies is not None else None,
                sorted(int(r) for r in sub.regimes)
                if sub.regimes is not None else None,
                list(rec.rows),
            )
        if self._base is not None:
            for uid in list(self._base_idx):
                yield self._base.row(self._base_idx[uid])


class SubscriptionRegistry:
    """Host-authoritative subscription store + bitset plane compiler.

    ``capacity`` is the user-slot bound (rounded up to a multiple of 32);
    adding past it doubles the planes (a deliberate, counted match-kernel
    retrace — the only one). Every mutation updates the numpy planes in
    place and records the touched (plane, row, word) cells dirty; the
    device sync policy lives in
    :class:`binquant_tpu_torch.fanout.plane.FanoutPlane`.
    """

    def __init__(self, symbol_capacity: int, capacity: int = 1024) -> None:
        self.symbol_capacity = int(symbol_capacity)
        cap = max(int(capacity), 32)
        self.capacity = (cap + 31) & ~31
        self._initial_capacity = self.capacity
        self._records = _RecordMap()
        # user_ids with EXPLICIT symbol criteria — the only records a
        # symbol-row refresh must re-resolve (keeps listing churn
        # O(explicit subs), not O(population))
        self._explicit: set[str] = set()
        self._slot_user: dict[int, str] = {}
        self._free: list[int] = []
        self._next_slot = 0
        # bumped on every mutation that changed any plane bit; the plane
        # uses it to invalidate cached device copies
        self.version = 0
        # capacity generation: bumped whenever the host planes must be
        # re-pushed wholesale (growth, compaction, row refresh, restore)
        self.capacity_generation = 0
        # the delta queue: (plane_id, row, word) cells + floor words the
        # next device sync patches in ONE apply_subscription_deltas
        # dispatch — O(cells), never O(population)
        self.dirty_cells: set[tuple[int, int, int]] = set()
        self.dirty_floor_words: set[int] = set()
        self._alloc_planes()
        # engine-registry version the symbol rows were resolved against
        self._rows_version: int | None = None

    # -- plane storage -------------------------------------------------------

    def _alloc_planes(self) -> None:
        u32 = self.capacity // 32
        # one trailing always-zero row: the "no such symbol" bucket a
        # match can gather when a fired symbol no longer resolves to an
        # engine row (delisted between dispatch and finalize) — explicit
        # subscribers get nothing, wildcards still match via any_masks
        self.sym_plane = np.zeros((self.symbol_capacity + 1, u32), np.uint32)
        self.strat_plane = np.zeros((len(STRATEGY_ORDER), u32), np.uint32)
        self.regime_plane = np.zeros((REGIME_ROWS, u32), np.uint32)
        self.any_masks = np.zeros((3, u32), np.uint32)
        self.floors = np.full(self.capacity, np.inf, np.float32)

    def _clear_dirty(self) -> None:
        self.dirty_cells.clear()
        self.dirty_floor_words.clear()

    @property
    def words(self) -> int:
        return self.capacity // 32

    def __len__(self) -> int:
        return len(self._records)

    def __contains__(self, user_id: str) -> bool:
        return user_id in self._records

    def get(self, user_id: str) -> Subscription | None:
        rec = self._records.get(user_id)
        return rec.sub if rec is not None else None

    def slot_of(self, user_id: str) -> int | None:
        rec = self._records.get(user_id)
        return rec.slot if rec is not None else None

    def user_of(self, slot: int) -> str | None:
        return self._slot_user.get(int(slot))

    def users_of_slots(self, slots: Iterable[int]) -> list[str]:
        return [
            u for u in (self._slot_user.get(int(s)) for s in slots)
            if u is not None
        ]

    # -- churn ---------------------------------------------------------------

    def _claim_slot(self) -> int:
        if self._free:
            return self._free.pop()
        if self._next_slot >= self.capacity:
            self._grow()
        slot = self._next_slot
        self._next_slot += 1
        return slot

    def _grow(self) -> None:
        """Double the slot capacity. Slots never move on growth and words
        are append-only in the packed layout, so growth PADS each plane
        with zero words on the right — bit-identical to a from-scratch
        replay (pinned by tests) without materializing a single record.
        Counted by the plane as a FULL device recompile (and the match
        kernel's one legitimate retrace)."""
        self.capacity *= 2
        u32 = self.capacity // 32

        def _wide(plane: np.ndarray) -> np.ndarray:
            out = np.zeros((plane.shape[0], u32), np.uint32)
            out[:, : plane.shape[1]] = plane
            return out

        self.sym_plane = _wide(self.sym_plane)
        self.strat_plane = _wide(self.strat_plane)
        self.regime_plane = _wide(self.regime_plane)
        self.any_masks = _wide(self.any_masks)
        floors = np.full(self.capacity, np.inf, np.float32)
        floors[: self.floors.shape[0]] = self.floors
        self.floors = floors
        self.capacity_generation += 1
        self._clear_dirty()  # full resync supersedes the delta queue

    def _set_bits(self, rec: _SlotRecord, on: bool) -> None:
        sub, slot = rec.sub, rec.slot
        w, bit = slot >> 5, np.uint32(1 << (slot & 31))
        planes_bits: list[tuple[int, np.ndarray, int]] = []
        if sub.symbols is None:
            planes_bits.append((P_ANY, self.any_masks, ANY_SYM))
        else:
            for row in rec.rows:
                planes_bits.append((P_SYM, self.sym_plane, row))
        if sub.strategies is None:
            planes_bits.append((P_ANY, self.any_masks, ANY_STRAT))
        else:
            for name in sub.strategies:
                planes_bits.append(
                    (P_STRAT, self.strat_plane, _STRAT_IDX[name])
                )
        if sub.regimes is None:
            planes_bits.append((P_ANY, self.any_masks, ANY_REGIME))
        else:
            for code in sub.regimes:
                planes_bits.append((P_REGIME, self.regime_plane, int(code)))
        if on:
            for _, plane, r in planes_bits:
                plane[r, w] |= bit
            self.floors[slot] = np.float32(sub.min_strength)
        else:
            inv = np.uint32(~bit)
            for _, plane, r in planes_bits:
                plane[r, w] &= inv
            self.floors[slot] = np.inf
        cells = self.dirty_cells
        for pid, _, r in planes_bits:
            cells.add((pid, r, w))
        self.dirty_floor_words.add(w)
        self.version += 1

    def _resolve_rows(
        self, symbols: frozenset[str] | None, row_of: Callable[[str], int | None]
    ) -> list[int]:
        if symbols is None:
            return []
        rows = (row_of(s) for s in symbols)
        return sorted(
            r for r in rows if r is not None and 0 <= r < self.symbol_capacity
        )

    def add(
        self,
        sub: Subscription,
        row_of: Callable[[str], int | None] | None = None,
    ) -> int:
        """Insert (or replace — churn ``update`` is remove+add on the SAME
        slot) one subscription; returns the user's slot. ``row_of``
        resolves symbol names to engine rows (None = unresolved yet; the
        plane re-resolves on its registry-version check)."""
        sub = Subscription(
            user_id=sub.user_id,
            symbols=_norm_symbols(sub.symbols),
            strategies=sub.strategies,
            regimes=sub.regimes,
            min_strength=sub.min_strength,
        )
        existing = self._records.get(sub.user_id)
        if existing is not None:
            self._set_bits(existing, on=False)
            slot = existing.slot
        else:
            slot = self._claim_slot()
        rec = _SlotRecord(sub=sub, slot=slot)
        if row_of is not None:
            rec.rows = self._resolve_rows(sub.symbols, row_of)
        self._records[sub.user_id] = rec
        if sub.symbols is not None:
            self._explicit.add(sub.user_id)
        else:
            self._explicit.discard(sub.user_id)
        self._slot_user[slot] = sub.user_id
        self._set_bits(rec, on=True)
        return slot

    def update(
        self,
        sub: Subscription,
        row_of: Callable[[str], int | None] | None = None,
    ) -> int:
        """Alias of :meth:`add` for churn-intent readability (slot kept)."""
        return self.add(sub, row_of=row_of)

    def remove(self, user_id: str) -> int | None:
        rec = self._records.pop(user_id, None)
        if rec is None:
            return None
        self._explicit.discard(user_id)
        self._set_bits(rec, on=False)
        del self._slot_user[rec.slot]
        self._free.append(rec.slot)
        return rec.slot

    def fragmentation(self) -> float:
        """Tombstone fraction of the claimed slot range — what the
        plane's compaction threshold compares against."""
        return len(self._free) / self._next_slot if self._next_slot else 0.0

    def compact(self) -> dict[str, tuple[int, int]]:
        """Fold tombstones back into dense planes: re-pack every live
        record into the lowest slots (stable old-slot order), shrink
        capacity back toward the initial allocation when occupancy
        allows, and rebuild the planes. Returns ``{user_id: (old_slot,
        new_slot)}`` for every user whose slot moved.

        A deliberate heavyweight pass (fragmentation-triggered, never
        steady-state churn): a lazily-restored population materializes
        here, and the plane counts the follow-up device sync as FULL.
        """
        recs = sorted(self._records.values(), key=lambda r: r.slot)
        n = len(recs)
        cap = self.capacity
        # keep >= 50% headroom above the live population so the compact
        # → grow → compact flap can't happen at a stable size
        while cap // 2 >= self._initial_capacity and 2 * n <= cap // 2:
            cap //= 2
        self.capacity = cap
        moved: dict[str, tuple[int, int]] = {}
        self._alloc_planes()
        self._slot_user.clear()
        self._free = []
        for new_slot, rec in enumerate(recs):
            if rec.slot != new_slot:
                moved[rec.sub.user_id] = (rec.slot, new_slot)
                rec.slot = new_slot
            self._slot_user[new_slot] = rec.sub.user_id
            self._set_bits(rec, on=True)
        self._next_slot = n
        self.capacity_generation += 1
        self._clear_dirty()  # the full resync supersedes the delta queue
        self.version += 1
        return moved

    def bulk_load(
        self,
        subs: Iterable[Subscription],
        row_of: Callable[[str], int | None] | None = None,
    ) -> int:
        """Vectorized initial load (the 1M-subscription path): one grouped
        ``np.bitwise_or.at`` pass per plane instead of per-user bit flips.
        Produces planes IDENTICAL to sequential :meth:`add` calls (pinned
        by tests). Returns the number of users loaded."""
        subs = list(subs)
        # validate BEFORE any mutation: a duplicate found mid-loop would
        # otherwise leave earlier records registered without plane bits
        # (a silent device-vs-oracle divergence no later sync repairs)
        seen: set[str] = set()
        for raw in subs:
            if raw.user_id in self._records or raw.user_id in seen:
                raise ValueError(
                    f"bulk_load of existing user {raw.user_id!r}; use "
                    "update() for churn"
                )
            seen.add(raw.user_id)
        need = self._next_slot + len(subs) - len(self._free)
        while need > self.capacity:
            self._grow()
        sym_i: list[int] = []
        sym_w: list[int] = []
        sym_b: list[int] = []
        strat_i: list[int] = []
        strat_w: list[int] = []
        strat_b: list[int] = []
        reg_i: list[int] = []
        reg_w: list[int] = []
        reg_b: list[int] = []
        any_i: list[int] = []
        any_w: list[int] = []
        any_b: list[int] = []
        slots = np.empty(len(subs), np.int64)
        floors = np.empty(len(subs), np.float32)
        for k, raw in enumerate(subs):
            sub = Subscription(
                user_id=raw.user_id,
                symbols=_norm_symbols(raw.symbols),
                strategies=raw.strategies,
                regimes=raw.regimes,
                min_strength=raw.min_strength,
            )
            slot = self._claim_slot()
            rec = _SlotRecord(sub=sub, slot=slot)
            if row_of is not None:
                rec.rows = self._resolve_rows(sub.symbols, row_of)
            self._records[sub.user_id] = rec
            if sub.symbols is not None:
                self._explicit.add(sub.user_id)
            self._slot_user[slot] = sub.user_id
            slots[k] = slot
            floors[k] = sub.min_strength
            w, b = slot >> 5, slot & 31
            if sub.symbols is None:
                any_i.append(ANY_SYM); any_w.append(w); any_b.append(b)
            else:
                for row in rec.rows:
                    sym_i.append(row); sym_w.append(w); sym_b.append(b)
            if sub.strategies is None:
                any_i.append(ANY_STRAT); any_w.append(w); any_b.append(b)
            else:
                for name in sub.strategies:
                    strat_i.append(_STRAT_IDX[name])
                    strat_w.append(w); strat_b.append(b)
            if sub.regimes is None:
                any_i.append(ANY_REGIME); any_w.append(w); any_b.append(b)
            else:
                for code in sub.regimes:
                    reg_i.append(int(code)); reg_w.append(w); reg_b.append(b)
        one = np.uint32(1)
        groups = (
            (P_SYM, self.sym_plane, sym_i, sym_w, sym_b),
            (P_STRAT, self.strat_plane, strat_i, strat_w, strat_b),
            (P_REGIME, self.regime_plane, reg_i, reg_w, reg_b),
            (P_ANY, self.any_masks, any_i, any_w, any_b),
        )
        for _, plane, ii, ww, bb in groups:
            if ii:
                np.bitwise_or.at(
                    plane,
                    (np.asarray(ii, np.int64), np.asarray(ww, np.int64)),
                    one << np.asarray(bb, np.uint32),
                )
        self.floors[slots] = floors
        if len(subs) * 4 >= self.capacity:
            # a load touching a large fraction of the plane resyncs
            # faster as one full push than as O(load) word scatters
            self.capacity_generation += 1
            self._clear_dirty()
        else:
            cells = self.dirty_cells
            for pid, _, ii, ww, _b in groups:
                cells.update((pid, i, w) for i, w in zip(ii, ww))
            self.dirty_floor_words.update(
                int(w) for w in np.unique(slots >> 5)
            )
        self.version += 1
        return len(subs)

    # -- symbol-row refresh --------------------------------------------------

    def refresh_rows(
        self, row_of: Callable[[str], int | None], registry_version: int
    ) -> bool:
        """Re-resolve every explicit symbol subscription against the
        engine registry when its ``version`` moved (listing churn re-homes
        rows). Rebuilds ``sym_plane`` from scratch — symbol churn is rare
        and row reuse makes per-row patching unsound (a freed row's old
        bits must vanish). Returns True when anything was rebuilt."""
        if self._rows_version == registry_version:
            return False
        self._rows_version = registry_version
        if not self._explicit:
            # wildcard-only population: sym_plane is all zero and stays
            # so — recording the version is enough; forcing a full device
            # re-push here would re-upload megabytes of unchanged planes
            # on every engine listing-churn version bump
            return False
        self.sym_plane.fill(0)
        # only EXPLICIT symbol subscriptions re-resolve (the _explicit
        # index keeps listing churn O(explicit subs), not O(population));
        # bits land in one grouped scatter instead of per-record writes
        rr: list[int] = []
        ww: list[int] = []
        bb: list[int] = []
        for uid in self._explicit:
            rec = self._records[uid]
            rec.rows = self._resolve_rows(rec.sub.symbols, row_of)
            if rec.rows:
                w, b = rec.slot >> 5, rec.slot & 31
                rr.extend(rec.rows)
                ww.extend([w] * len(rec.rows))
                bb.extend([b] * len(rec.rows))
        if rr:
            np.bitwise_or.at(
                self.sym_plane,
                (np.asarray(rr, np.int64), np.asarray(ww, np.int64)),
                np.uint32(1) << np.asarray(bb, np.uint32),
            )
        # every word column of sym_plane may have changed: force a full
        # device resync rather than enumerating all cells as dirty
        self.capacity_generation += 1
        self._clear_dirty()
        self.version += 1
        return True

    # -- snapshot-warm boot ----------------------------------------------------

    def export_columns(self) -> dict[str, np.ndarray]:
        """Slot-ordered columnar image of the subscription index — what
        the snapshot sidecar archives next to the raw planes. Lazy
        (never-touched) restored records export straight from their
        columns; criteria lists are sorted, so the archive bytes are
        deterministic for a given population."""
        rows = sorted(self._records.export_rows(), key=lambda t: t[1])
        uids: list[str] = []
        slots: list[int] = []
        sym_counts: list[int] = []
        sym_names: list[str] = []
        strat_counts: list[int] = []
        strat_names: list[str] = []
        reg_counts: list[int] = []
        reg_flat: list[int] = []
        row_counts: list[int] = []
        rows_flat: list[int] = []
        for uid, slot, syms, strats, regs, rrows in rows:
            if "\n" in uid:
                # the archive joins ids on newline; a newline-bearing uid
                # would silently split on restore — refuse loudly instead
                raise ValueError(
                    f"user id {uid!r} contains a newline; not archivable"
                )
            uids.append(uid)
            slots.append(slot)
            if syms is None:
                sym_counts.append(-1)
            else:
                sym_counts.append(len(syms))
                sym_names.extend(syms)
            if strats is None:
                strat_counts.append(-1)
            else:
                strat_counts.append(len(strats))
                strat_names.extend(strats)
            if regs is None:
                reg_counts.append(-1)
            else:
                reg_counts.append(len(regs))
                reg_flat.extend(int(r) for r in regs)
            row_counts.append(len(rrows))
            rows_flat.extend(int(r) for r in rrows)

        def _blob(parts: list[str]) -> np.ndarray:
            if not parts:
                return np.zeros(0, np.uint8)
            return np.frombuffer(
                "\n".join(parts).encode("utf-8"), np.uint8
            ).copy()

        return {
            "uid_blob": _blob(uids),
            "slots": np.asarray(slots, np.int64),
            "sym_counts": np.asarray(sym_counts, np.int32),
            "sym_blob": _blob(sym_names),
            "strat_counts": np.asarray(strat_counts, np.int32),
            "strat_blob": _blob(strat_names),
            "reg_counts": np.asarray(reg_counts, np.int32),
            "reg_flat": np.asarray(reg_flat, np.int16),
            "row_counts": np.asarray(row_counts, np.int32),
            "rows_flat": np.asarray(rows_flat, np.int32),
            "free_slots": np.asarray(sorted(self._free), np.int32),
        }

    def restore_columns(
        self,
        planes: dict[str, np.ndarray],
        columns: dict[str, np.ndarray],
        capacity: int,
        next_slot: int,
        rows_version: int | None,
    ) -> int:
        """Adopt a snapshot archive wholesale: plane arrays become the
        host truth, the columnar subscription index attaches as a LAZY
        record base (per-user materialization on first touch), and the
        device copy is invalidated for one full push. ``rows_version``
        is the engine-registry version the archived rows are valid for
        (None = unknown/mismatched → the next sync's ``refresh_rows``
        rebuilds sym_plane the slow, safe way). Returns the restored
        user count."""
        capacity = int(capacity)
        assert capacity % 32 == 0 and capacity >= 32, capacity
        self.capacity = capacity
        self.sym_plane = np.ascontiguousarray(planes["sym_plane"], np.uint32)
        self.strat_plane = np.ascontiguousarray(
            planes["strat_plane"], np.uint32
        )
        self.regime_plane = np.ascontiguousarray(
            planes["regime_plane"], np.uint32
        )
        self.any_masks = np.ascontiguousarray(planes["any_masks"], np.uint32)
        self.floors = np.ascontiguousarray(planes["floors"], np.float32)
        base = _ColumnarBase(columns, self.floors)
        self._records = _RecordMap()
        self._records.attach_base(base)
        self._slot_user = dict(zip(base.slots.tolist(), base.uids))
        counts = base.sym_counts.tolist()
        self._explicit = {
            u for u, c in zip(base.uids, counts) if c >= 0
        }
        self._free = [int(s) for s in columns["free_slots"]]
        self._next_slot = int(next_slot)
        self.version += 1
        self.capacity_generation += 1  # device must take one full push
        self._clear_dirty()
        self._rows_version = rows_version
        return len(base.uids)

    # -- oracle --------------------------------------------------------------

    def match_oracle(
        self,
        entries: list[tuple[str, str, float]],
        regime: int | None,
        unresolved: frozenset[str] = frozenset(),
    ) -> list[set[str]]:
        """Per-entry recipient user-id sets for ``(strategy, symbol,
        score)`` fired entries — the pure-Python reference the device
        kernel's packed output must equal exactly. ``unresolved`` names
        fired symbols with NO current engine row (delisted between
        dispatch and finalize): the kernel gathers the empty no-row
        bucket for those, so explicit-symbol subscribers do not match —
        only wildcards do — and the oracle must agree."""
        out: list[set[str]] = []
        for strategy, symbol, score in entries:
            sym = symbol.strip().upper()
            out.append(
                {
                    rec.sub.user_id
                    for rec in self._records.values()
                    if rec.sub.matches(strategy, sym, score, regime)
                    and not (
                        rec.sub.symbols is not None and sym in unresolved
                    )
                }
            )
        return out

    def snapshot(self) -> dict:
        """Attribute-read stats for /healthz and the flight recorder."""
        return {
            "users": len(self._records),
            "capacity": self.capacity,
            "words": self.words,
            "version": self.version,
            "dirty_cells": len(self.dirty_cells),
            "dirty_floor_words": len(self.dirty_floor_words),
            "free_slots": len(self._free),
            "lazy_records": self._records.lazy_count,
        }
