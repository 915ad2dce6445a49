"""The fan-out plane: the match at finalize and the broadcast consumer group.

The port of ``binquant_tpu/fanout/plane.py``. :class:`FanoutPlane` is what
the engine owns (``SignalEngine.fanout``, ``Config.fanout_enabled``): the
subscription registry, its device copy on the engine's device (the match
and the delta scatter run there: CUDA tensors on a card, CPU tensors only
when the caller asked for the CPU), the per-tick match, the frame outbox
and, when served, the WS/SSE hub. The tick's whole cost is one match on
fired ticks plus an outbox append per frame; broadcast rides the delivery
plane as a lossy consumer group (:class:`FanoutSink`) when the plane is
on, or a direct bounded-queue offer when it is not. A failure of the match
raises into finalize; only the outbox's append failure is counted and
passed over (``outbox_error``), as in the reference.

The match input is the deduped, provenance-stamped fired set of the one
finalize, and frame sequence numbers advance in emission order, so the
(seq, frame, recipient-set) stream equals the reference's on the same
ticks and equals the pure-Python
:meth:`~binquant_tpu_torch.fanout.registry.SubscriptionRegistry.match_oracle`.

Sharding, as in the reference: ``outbox_shards`` above 1 partitions the
outbox by the firing row's shard (:class:`~binquant_tpu_torch.fanout.hub.
ShardedBroadcastOutbox`, one merged cursor), and a snapshot saved at
``snapshot_shards`` (0: the checkpoint's count) above 1 splits
``sym_plane`` at the shard bounds (``fanout/snapshot.py``).
"""

from __future__ import annotations

import logging
import time
from pathlib import Path
from typing import Any

import numpy as np

from binquant_tpu_torch.engine.step import STRATEGY_ORDER
from binquant_tpu_torch.enums import MarketRegimeCode
from binquant_tpu_torch.fanout.hub import BroadcastOutbox, FanoutHub, ShardedBroadcastOutbox
from binquant_tpu_torch.fanout.kernel import DevicePlanes, popcount_words
from binquant_tpu_torch.fanout.registry import (
    INVALID_REGIME_ROW,
    REGIME_ROWS,
    _STRAT_IDX,
    Subscription,
    SubscriptionRegistry,
)
from binquant_tpu_torch.io.emission import SignalSink
from binquant_tpu_torch.obs.events import get_event_log
from binquant_tpu_torch.obs.instruments import (
    FANOUT_COMPACTIONS,
    FANOUT_DELTA_WORDS,
    FANOUT_MATCH_DISPATCHES,
    FANOUT_PUBLISHED,
    FANOUT_RECIPIENTS,
    FANOUT_RECOMPILES,
    FANOUT_SHED,
    FANOUT_SNAPSHOT,
    FANOUT_SUBSCRIPTIONS,
)
from binquant_tpu_torch.parallel.mesh import shard_of_row

log = logging.getLogger(__name__)


class FanoutPlane:
    """Subscription fan-out over the engine's fired wire slots.

    ``engine_registry`` is the engine's
    :class:`~binquant_tpu_torch.engine.buffer.SymbolRegistry` (symbol-name
    subscriptions resolve to its rows and re-resolve on its ``version``);
    ``device`` holds the device planes and runs the match (the engine's
    device); ``outbox_path`` enables cursor-replayable broadcast
    durability; :meth:`serve` binds the WS/SSE hub when a deployment wants
    the broadcast tier up.
    """

    def __init__(
        self,
        engine_registry,
        capacity: int = 1024,
        outbox_path: str | None = None,
        outbox_cap: int = 4096,
        conn_queue_max: int = 256,
        outbox_shards: int = 1,
        snapshot_path: str | None = None,
        snapshot_shards: int = 0,
        compact_frac: float = 0.0,
        resume_tail: int = 0,
        *,
        device,
    ) -> None:
        self.engine_registry = engine_registry
        self.subscriptions = SubscriptionRegistry(
            symbol_capacity=engine_registry.capacity, capacity=capacity
        )
        # snapshot-warm boot sidecar: when a path is set, restarts restore
        # the compiled planes + subscription index by load instead of
        # rebuild
        self.snapshot_path = Path(snapshot_path) if snapshot_path else None
        self.snapshot_shards = int(snapshot_shards)
        # tombstone-folding threshold: compact when free/claimed slots
        # crosses this fraction (0 = off)
        self.compact_frac = float(compact_frac)
        self.compactions = 0
        self._device = DevicePlanes(self.subscriptions, device=device)
        self.outbox_shards = int(outbox_shards) if outbox_path else 0
        if outbox_path and int(outbox_shards) > 1:
            # per-shard partitions under one global cursor: a frame goes
            # to the partition of its firing row's shard, the hub reads one
            # merged, seq-ordered stream
            cap_rows, n = engine_registry.capacity, int(outbox_shards)

            def frame_shard(frame: dict) -> int:
                return shard_of_row(int(frame["row"]), cap_rows, n)

            self.outbox = ShardedBroadcastOutbox(
                outbox_path, n_shards=n, cap=outbox_cap, shard_of=frame_shard
            )
        else:
            self.outbox = (
                BroadcastOutbox(outbox_path, cap=outbox_cap) if outbox_path else None
            )
        # per-slot minimum frame seq: slots are RECYCLED on unsubscribe,
        # and outbox frames / in-flight delivery-worker frames encode
        # recipients as slot bits — a new claimant must never receive (or
        # cursor-replay) frames addressed to the slot's previous owner.
        # Cursor replay therefore only covers frames published since the
        # user's CURRENT subscription was created (which also makes a
        # retained outbox from a previous process — whose slot bits are
        # meaningless against this boot's fresh registry — unreplayable).
        self._slot_min_seq: dict[int, int] = {}
        self.hub = FanoutHub(
            slot_of=self.subscriptions.slot_of,
            outbox=self.outbox,
            conn_queue_max=conn_queue_max,
            min_seq_of=lambda slot: self._slot_min_seq.get(slot, 0),
            tail_cap=int(resume_tail),
        )
        self._served = False
        # behind-the-delivery-plane handoff (FanoutSink attached): the
        # finalize path skips the direct broadcast and lets the worker
        # deliver
        self.sink_attached = False
        # monotonically increasing frame sequence — the reconnect cursor;
        # deterministic across drives (advances in emission order). A
        # reopened persistent outbox seeds it PAST the retained tail so
        # post-restart frames never collide with logged seqs (a collision
        # would hide them from every cursor replay)
        self.seq = (
            self.outbox.last_seq() + 1 if self.outbox is not None else 0
        )
        self.match_dispatches = 0
        self.published = 0
        self.matched_recipients = 0
        self.recompiles = {"full": 0, "incremental": 0}
        # outbox append failures (lossy-tier: counted, never aborting
        # finalize) — the SLO plane's recipient-set invariant reads this
        self.outbox_errors = 0

    # -- subscription churn (delegates stamping metrics) ---------------------

    def subscribe(self, sub: Subscription) -> int:
        fresh = sub.user_id not in self.subscriptions
        slot = self.subscriptions.add(sub, row_of=self.engine_registry.row_of)
        if fresh:
            self._slot_min_seq[slot] = self.seq
        self._note_churn("subscribe", sub.user_id, slot)
        return slot

    def update(self, sub: Subscription) -> int:
        fresh = sub.user_id not in self.subscriptions
        slot = self.subscriptions.update(
            sub, row_of=self.engine_registry.row_of
        )
        if fresh:  # update of an unknown user claims a slot like subscribe
            self._slot_min_seq[slot] = self.seq
        self._note_churn("update", sub.user_id, slot)
        return slot

    def unsubscribe(self, user_id: str) -> int | None:
        slot = self.subscriptions.remove(user_id)
        if slot is not None:
            # the freed slot may be reclaimed by another user: any still-
            # open connection bound to it must close NOW or it would
            # receive the next claimant's frames (cross-user misdelivery)
            self.hub.close_user(user_id)
            self._note_churn("unsubscribe", user_id, slot)
            # unsubscribe is the only op that mints tombstones, so the
            # fragmentation check rides here (amortized O(1))
            self.maybe_compact()
        return slot

    def bulk_load(self, subs) -> int:
        subs = list(subs)
        n = self.subscriptions.bulk_load(
            subs, row_of=self.engine_registry.row_of
        )
        for sub in subs:
            slot = self.subscriptions.slot_of(sub.user_id)
            if slot is not None:
                self._slot_min_seq[slot] = self.seq
        FANOUT_SUBSCRIPTIONS.set(len(self.subscriptions))
        return n

    def _note_churn(self, op: str, user_id: str, slot: int) -> None:
        FANOUT_SUBSCRIPTIONS.set(len(self.subscriptions))
        get_event_log().emit("fanout_churn", op=op, user=user_id, slot=slot)

    # -- device sync ---------------------------------------------------------

    def sync_device(self) -> str | None:
        """Bring the device planes current (symbol-row refresh first);
        returns the recompile kind performed, if any."""
        self.subscriptions.refresh_rows(
            self.engine_registry.row_of, self.engine_registry.version
        )
        kind = self._device.sync()
        if kind is not None:
            self.recompiles[kind] = self.recompiles.get(kind, 0) + 1
            FANOUT_RECOMPILES.labels(kind=kind).inc()
            if kind == "incremental":
                FANOUT_DELTA_WORDS.observe(self._device.last_delta_words)
        return kind

    # -- compaction ------------------------------------------------------------

    def maybe_compact(self) -> bool:
        """Fold tombstones when fragmentation (free / claimed slots)
        crosses ``compact_frac``. Cheap check on the churn path; the
        pass itself is a counted heavyweight (one full device resync)."""
        frac = self.compact_frac
        reg = self.subscriptions
        if frac <= 0.0 or reg._next_slot < 64:
            return False
        if reg.fragmentation() < frac:
            return False
        self.compact()
        return True

    def compact(self) -> dict[str, tuple[int, int]]:
        """Re-pack live slots dense + shrink capacity (see
        :meth:`SubscriptionRegistry.compact`), then repair every
        slot-addressed structure around the registry:

        * moved users' min-seq floors advance to the CURRENT seq —
          outbox frames and the hub's tail ring address recipients by
          their OLD slot bits, so pre-compaction frames must never
          deliver or replay against the new layout (documented replay
          gap for moved users; unmoved slots keep their floors and
          their full replay window);
        * live hub connections re-bind to their users' new slots;
        * the hub's tail ring resets (its packed words are old-layout).
        """
        t0 = time.perf_counter()
        reg = self.subscriptions
        before = reg.snapshot()
        moved = reg.compact()
        for _uid, (old_slot, new_slot) in moved.items():
            self._slot_min_seq.pop(old_slot, None)
            self._slot_min_seq[new_slot] = self.seq
        # slots past the compacted range no longer exist; drop floors
        self._slot_min_seq = {
            s: q for s, q in self._slot_min_seq.items()
            if s < reg._next_slot
        }
        self.hub.rebind_slots(reason="compaction")
        self.compactions += 1
        FANOUT_COMPACTIONS.inc()
        get_event_log().emit(
            "fanout_compact",
            users=len(reg),
            moved=len(moved),
            capacity_before=before["capacity"],
            capacity_after=reg.capacity,
            freed_slots=before["free_slots"],
            duration_ms=round((time.perf_counter() - t0) * 1000.0, 3),
        )
        return moved

    # -- snapshot-warm boot ----------------------------------------------------

    def _engine_fingerprint(self) -> str:
        """Hash of the engine registry's symbol→row mapping — archived
        rows are valid verbatim only against the same mapping."""
        import hashlib
        import json

        blob = json.dumps(
            self.engine_registry.to_mapping(), sort_keys=True
        ).encode()
        return hashlib.sha256(blob).hexdigest()[:16]

    def maybe_save_snapshot(self, default_shards: int = 1) -> bool:
        """Sidecar save when a snapshot path is configured — failures
        counted, never propagated (the lossy-tier contract)."""
        if self.snapshot_path is None:
            return False
        try:
            self.save_snapshot(n_shards=self.snapshot_shards or default_shards)
            return True
        except Exception:
            FANOUT_SNAPSHOT.labels(op="save", outcome="error").inc()
            log.exception("fanout snapshot save failed; continuing")
            return False

    def save_snapshot(
        self, path: str | Path | None = None, n_shards: int = 1
    ) -> dict:
        """Archive the compiled planes + columnar subscription index +
        per-slot min-seq floors as the versioned sidecar (see
        :mod:`binquant_tpu_torch.fanout.snapshot`). Returns the manifest meta.
        """
        from binquant_tpu_torch.fanout.snapshot import save_snapshot

        target = Path(path) if path is not None else self.snapshot_path
        assert target is not None, "no snapshot path configured"
        reg = self.subscriptions
        t0 = time.perf_counter()
        n_shards = max(int(n_shards), 1)
        if n_shards > 1 and reg.symbol_capacity % n_shards:
            # the shard bounds need even blocks: an odd count saves one
            # monolithic archive rather than failing the save
            n_shards = 1
        columns = reg.export_columns()
        ms = sorted(self._slot_min_seq.items())
        columns["min_seq_slots"] = np.asarray([s for s, _ in ms], np.int64)
        columns["min_seq_vals"] = np.asarray([q for _, q in ms], np.int64)
        planes = {
            "sym_plane": reg.sym_plane,
            "strat_plane": reg.strat_plane,
            "regime_plane": reg.regime_plane,
            "any_masks": reg.any_masks,
            "floors": reg.floors,
        }
        meta = {
            "capacity": reg.capacity,
            "symbol_capacity": reg.symbol_capacity,
            "strategy_order": list(STRATEGY_ORDER),
            "regime_rows": REGIME_ROWS,
            "n_users": len(reg),
            "next_slot": reg._next_slot,
            "seq": self.seq,
            "fingerprint": self._engine_fingerprint(),
            "saved_unix": time.time(),
        }
        info = save_snapshot(
            target, planes, columns, meta, n_shards=n_shards
        )
        FANOUT_SNAPSHOT.labels(op="save", outcome="ok").inc()
        get_event_log().emit(
            "fanout_snapshot_save",
            path=str(target),
            users=len(reg),
            shards=n_shards,
            duration_ms=round((time.perf_counter() - t0) * 1000.0, 3),
        )
        return info

    def try_restore_snapshot(self, path: str | Path | None = None) -> bool:
        """Warm boot: adopt the sidecar archive if present and valid —
        planes restore by load (lazy record materialization), the device
        takes one full push at the next sync, and cursor replay across
        the restart stays sound:

        * per-slot min-seq floors restore with the planes, so a RETAINED
          outbox's pre-snapshot frames replay correctly (slot layout is
          the snapshot's own);
        * frames published AFTER the snapshot was taken (seq in
          [archived seq, boot head]) were addressed by a registry whose
          post-save churn this restore cannot see — the hub excludes
          that range from replay (cross-user misdelivery guard).

        Returns False (cold start) on any rejection: torn/missing/
        version-mismatched archive, or plane geometry that disagrees
        with the running engine.
        """
        from binquant_tpu_torch.fanout.snapshot import load_snapshot

        target = Path(path) if path is not None else self.snapshot_path
        if target is None or not target.exists():
            return False
        reg = self.subscriptions
        t0 = time.perf_counter()
        try:
            planes, columns, meta = load_snapshot(target)
            if int(meta["symbol_capacity"]) != reg.symbol_capacity:
                raise ValueError(
                    f"snapshot symbol capacity {meta['symbol_capacity']} "
                    f"!= engine {reg.symbol_capacity} — start cold"
                )
            if list(meta["strategy_order"]) != list(STRATEGY_ORDER):
                raise ValueError(
                    "snapshot strategy order differs from this build — "
                    "strat_plane rows unsound, start cold"
                )
            if int(meta["regime_rows"]) != REGIME_ROWS:
                raise ValueError(
                    "snapshot regime row count differs — start cold"
                )
        except Exception:
            FANOUT_SNAPSHOT.labels(op="restore", outcome="rejected").inc()
            log.warning(
                "fanout snapshot %s rejected; starting cold",
                target,
                exc_info=True,
            )
            return False
        fingerprint_ok = meta.get("fingerprint") == self._engine_fingerprint()
        users = reg.restore_columns(
            planes,
            columns,
            capacity=int(meta["capacity"]),
            next_slot=int(meta["next_slot"]),
            # matching fingerprint: archived symbol rows are valid
            # verbatim; otherwise the next sync's refresh_rows rebuilds
            # sym_plane against the CURRENT engine mapping (slow, safe)
            rows_version=(
                self.engine_registry.version if fingerprint_ok else None
            ),
        )
        self._slot_min_seq = {
            int(s): int(q)
            for s, q in zip(
                columns["min_seq_slots"], columns["min_seq_vals"]
            )
        }
        saved_seq = int(meta["seq"])
        boot_head = self.seq - 1  # ctor seeded past the retained outbox
        if boot_head >= saved_seq:
            self.hub.replay_excluded = (saved_seq, boot_head)
        self.seq = max(self.seq, saved_seq)
        FANOUT_SUBSCRIPTIONS.set(len(reg))
        FANOUT_SNAPSHOT.labels(op="restore", outcome="ok").inc()
        get_event_log().emit(
            "fanout_snapshot_restore",
            path=str(target),
            users=users,
            fingerprint_ok=fingerprint_ok,
            shards=int(meta.get("shard_count", 1)),
            seq=self.seq,
            duration_ms=round((time.perf_counter() - t0) * 1000.0, 3),
        )
        return True

    # -- the per-tick join ---------------------------------------------------

    @staticmethod
    def regime_row(ctx_scalars: dict) -> int:
        regime = int(ctx_scalars.get("market_regime", -1))
        valid = bool(ctx_scalars.get("valid", False))
        if valid and 0 <= regime < len(MarketRegimeCode):
            return regime
        return INVALID_REGIME_ROW

    def match(self, fired: list, ctx_scalars: dict) -> np.ndarray:
        """One dispatch joining the deduped fired signals against the
        subscription planes → ``(len(fired), U32)`` packed recipient
        words. Fired symbols resolve by NAME against the registry the
        planes were just synced to — NOT the signal's dispatch-time row,
        which listing churn may have re-homed between dispatch and
        finalize; a symbol that no longer resolves gathers the planes'
        always-empty no-row bucket (wildcard subscribers still match)."""
        self.sync_device()
        cap = self.subscriptions.symbol_capacity
        row_of = self.engine_registry.row_of

        def current_row(symbol: str) -> int:
            r = row_of(symbol)
            return r if r is not None and 0 <= r < cap else cap

        rows = np.asarray([current_row(s.symbol) for s in fired], np.int32)
        strats = np.asarray(
            [_STRAT_IDX[s.strategy] for s in fired], np.int32
        )
        scores = np.asarray(
            [float(s.value.score or 0.0) for s in fired], np.float32
        )
        words = self._device.match(
            rows, strats, scores, self.regime_row(ctx_scalars)
        )
        self.match_dispatches += 1
        FANOUT_MATCH_DISPATCHES.inc()
        return words

    def on_fired(
        self,
        fired: list,
        ctx_scalars: dict,
        tick_ms: int | None = None,
    ) -> dict:
        """The finalize hook: match, mint frames (seq + provenance),
        append the outbox, stamp each signal's ``fanout_frame`` for the
        delivery consumer group (or broadcast directly when the plane is
        not behind the delivery tier). Returns span stats."""
        if not fired:
            return {"signals": 0, "recipients": 0}
        words = self.match(fired, ctx_scalars)
        t_pub = time.perf_counter()
        total = 0
        for signal, wrow in zip(fired, words):
            n = popcount_words(wrow)
            total += n
            frame = {
                "seq": self.seq,
                "trace_id": signal.trace_id,
                "tick_seq": signal.tick_seq,
                "tick_ms": tick_ms,
                "strategy": signal.strategy,
                "symbol": signal.symbol,
                "row": int(getattr(signal, "row", -1)),
                "direction": str(signal.value.direction),
                "score": float(signal.value.score or 0.0),
                "autotrade": bool(signal.value.autotrade),
                "recipients": n,
            }
            self.seq += 1
            self.published += 1
            FANOUT_PUBLISHED.inc()
            if self.outbox is not None:
                # lossy-tier contract: a broadcast-durability I/O failure
                # (ENOSPC, dead handle) must never abort finalize — the
                # frame still broadcasts live; only its cursor replay is
                # lost, counted never silent
                try:
                    self.outbox.append(frame, wrow)
                except Exception:
                    self.outbox_errors += 1
                    FANOUT_SHED.labels(reason="outbox_error").inc()
                    get_event_log().emit(
                        "fanout_shed",
                        reason="outbox_error",
                        seq=frame["seq"],
                        count=1,
                    )
                    log.warning(
                        "fanout outbox append failed (seq=%d)",
                        frame["seq"],
                        exc_info=True,
                    )
            get_event_log().emit(
                "fanout_publish",
                seq=frame["seq"],
                strategy=frame["strategy"],
                symbol=frame["symbol"],
                recipients=n,
                trace_id=frame["trace_id"],
                tick_seq=frame["tick_seq"],
            )
            signal.fanout_frame = (frame, wrow, t_pub)
            if not self.sink_attached:
                # no delivery plane behind us: bounded-queue offers on the
                # tick thread (O(connections); the served-at-scale shape
                # runs behind the delivery worker instead)
                self.hub.broadcast(frame, wrow, t_pub=t_pub)
        self.matched_recipients += total
        FANOUT_RECIPIENTS.inc(total)
        return {"signals": len(fired), "recipients": total}

    # -- serving -------------------------------------------------------------

    async def serve(self, port: int, host: str = "0.0.0.0") -> int:
        self.hub.host = host
        self.hub.port = int(port)
        bound = await self.hub.start()
        self._served = True
        return bound

    async def aclose(self) -> None:
        if self._served:
            await self.hub.stop()
            self._served = False
        self.emit_summary()
        if self.outbox is not None:
            self.outbox.close()

    def emit_summary(self) -> None:
        hub = self.hub.snapshot()
        top = sorted(
            self.hub.totals_by_user.items(), key=lambda kv: (-kv[1], kv[0])
        )[:10]
        get_event_log().emit(
            "fanout_summary",
            users=len(self.subscriptions),
            published=self.published,
            matched_recipients=self.matched_recipients,
            match_dispatches=self.match_dispatches,
            recompiles=dict(self.recompiles),
            frames_sent=hub["frames_sent"],
            shed=hub["shed"],
            resumed=hub["resumed"],
            top_users=[{"user": u, "delivered": n} for u, n in top],
        )

    def snapshot(self) -> dict:
        """/healthz ``fanout`` section — attribute reads only."""
        return {
            "enabled": True,
            "subscriptions": self.subscriptions.snapshot(),
            "published": self.published,
            "matched_recipients": self.matched_recipients,
            "match_dispatches": self.match_dispatches,
            "recompiles": dict(self.recompiles),
            "behind_delivery": self.sink_attached,
            "outbox_errors": self.outbox_errors,
            "compactions": self.compactions,
            "snapshot_path": (
                str(self.snapshot_path) if self.snapshot_path else None
            ),
            "hub": self.hub.snapshot(),
        }

    def recipient_set_invariant(self) -> dict:
        """The recipient-set integrity contract as an SLO-plane
        probe: every published frame made it into the cursor-replay log
        (no outbox_error sheds), and no slot's min-seq floor ran ahead of
        the frame counter (a floor past ``seq`` would silently suppress
        live frames for that slot's owner)."""
        floors_ok = all(
            floor <= self.seq for floor in self._slot_min_seq.values()
        )
        return {
            "ok": self.outbox_errors == 0 and floors_ok,
            "outbox_errors": self.outbox_errors,
            "slot_floors_ok": floors_ok,
        }


class FanoutSink(SignalSink):
    """The broadcast tier as a delivery-plane consumer group: lossy class — under
    pressure the trade path stays fresh and broadcast loss is counted
    (per-connection sheds), never blocking. ``deliver`` hands the matched
    frame to the hub off the tick thread; a signal the match addressed to
    nobody delivers as a no-op (still acked — the frame is already in
    the outbox for cursor replay)."""

    name = "fanout"
    policy = "lossy"

    def __init__(self, plane: FanoutPlane) -> None:
        self.plane = plane
        plane.sink_attached = True

    def encode(self, signal) -> Any:
        return getattr(signal, "fanout_frame", None)

    async def deliver(self, payload: Any) -> None:
        if payload is None:
            return
        frame, words, t_pub = payload
        self.plane.hub.broadcast(frame, words, t_pub=t_pub)
