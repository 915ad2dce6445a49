"""Signal-outcome observatory: forward returns of emitted signals, gathered
on the device.

Port of ``binquant_tpu/obs/outcomes.py``. Every emitted signal registers
here (strategy, symbol row, the evaluated 5m bar as the entry anchor) and
matures at fixed horizons in 5m bars (:data:`DEFAULT_HORIZONS`) through ONE
batched gather over the open pairs against the live 5m ring per maturation
tick: :func:`_outcome_gather_impl`, torch ops on the ring planes, whose two
outputs (float32 (4, K), int32 (2, K)) are each copied to the host once.

The gather is timestamp-bounded: a (slot, horizon) pair reads exactly the
ring bars with ``entry_ts < t <= entry_ts + horizon*300`` plus the entry
bar, masked by timestamp at any cursor phase (the rings are written in
place and rotate), so when maturation runs does not change what it
computes. The ring must still hold the pair's window: a clipped window is
detected through the row's oldest retained bar (an exact int32; float32
would round ~1.78e9 s to ±128 s) and the pair counts as ``truncated``.

Outcomes are direction-relative: ``fwd_ret`` the signed return at the
horizon close (a hit is ``fwd_ret > 0``), ``mae`` (<= 0) the worst signed
excursion, ``mfe`` (>= 0) the best. The open registry is bounded (``cap``;
registering past it evicts the oldest open signal) and survives a restart
through :meth:`OutcomeTracker.snapshot_open` / :meth:`restore_open`.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Any

import numpy as np
import torch

from binquant_tpu_torch.engine.buffer import Field
from binquant_tpu_torch.obs.events import get_event_log
from binquant_tpu_torch.obs.instruments import (
    OUTCOME_EVICTIONS,
    OUTCOME_MATURED,
    OUTCOME_OPEN,
    OUTCOME_TRUNCATED,
    SIGNAL_FWD_RETURN,
    SIGNAL_HIT_RATE,
    SIGNAL_MAE,
    SIGNAL_MFE,
)
from binquant_tpu_torch.parallel.mesh import ShardedState

#: Maturation horizons in 5m bars: next bar, ~20 min, ~80 min, ~8 h.
DEFAULT_HORIZONS: tuple[int, ...] = (1, 4, 16, 96)

FIVE_MIN_S = 300
_I32_MIN = -(2**31)
_I32_MAX = 2**31 - 1


def _outcome_gather_impl(
    times: torch.Tensor,
    values: torch.Tensor,
    rows: torch.Tensor,
    entry_ts: torch.Tensor,
    horizon_ts: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The one device pass per maturation tick.

    ``times`` (S, W) int32 / ``values`` (S, W, F) are the live 5m ring
    planes in raw ring order; ``rows`` (K,) the open pairs' symbol rows
    (padding -1), ``entry_ts`` / ``horizon_ts`` (K,) int32 bound each
    pair's window. Returns float32 (4, K): the entry close (the last bar at
    or before the anchor), the horizon close (the last bar inside the
    window), the window's min low and max high; and int32 (2, K): the bars
    inside the window and the row's oldest retained bar time. "Last" is the
    argmax over the masked times, never a column position."""
    S = times.shape[0]
    safe = torch.clamp(rows, 0, S - 1).long()
    t = times[safe]  # (K, W)
    live = (t >= 0) & (rows[:, None] >= 0)
    close = values[:, :, Field.CLOSE][safe]
    high = values[:, :, Field.HIGH][safe]
    low = values[:, :, Field.LOW][safe]
    in_win = live & (t > entry_ts[:, None]) & (t <= horizon_ts[:, None])
    at_entry = live & (t <= entry_ts[:, None])
    nan = float("nan")

    def last_close(sel):
        has = sel.any(dim=1)
        idx = torch.where(sel, t, _I32_MIN).argmax(dim=1)
        c = torch.gather(close, 1, idx[:, None])[:, 0]
        return torch.where(has, c, nan)

    any_win = in_win.any(dim=1)
    min_low = torch.where(in_win, low, float("inf")).amin(dim=1)
    max_high = torch.where(in_win, high, float("-inf")).amax(dim=1)
    floats = torch.stack(
        [
            last_close(at_entry),
            last_close(in_win),
            torch.where(any_win, min_low, nan),
            torch.where(any_win, max_high, nan),
        ]
    )
    oldest = torch.where(live, t, _I32_MAX).amin(dim=1)
    ints = torch.stack([in_win.sum(dim=1, dtype=torch.int32), oldest.to(torch.int32)])
    return floats, ints


def _gather_on_device(times, values, rows, entry_ts, horizon_ts):
    """Upload the pair bounds in one copy and launch the gather on the
    ring's device; the outputs stay there."""
    bounds = np.stack([
        np.asarray(rows, np.int32), np.asarray(entry_ts, np.int32),
        np.asarray(horizon_ts, np.int32),
    ])
    b = torch.from_numpy(bounds).to(times.device)
    return _outcome_gather_impl(times, values, b[0], b[1], b[2])


def _gather_sharded(state: ShardedState, rows, entry_ts, horizon_ts):
    """The maturation gather over a state placed on a symbol mesh: each
    shard gathers the pairs whose rows it owns (rebased; the others padded
    to -1), and each pair's result is taken from its owner on the host."""
    rows = np.asarray(rows, np.int32)
    floats = ints = None
    for st, (lo, hi) in zip(state.shards, state.bounds, strict=True):
        own = (rows >= lo) & (rows < hi)
        local = np.where(own, rows - lo, -1).astype(np.int32)
        f, i = _gather_on_device(st.buf5.times, st.buf5.values, local, entry_ts, horizon_ts)
        f, i = f.cpu().numpy(), i.cpu().numpy()
        if floats is None:
            floats, ints = f.copy(), i.copy()
        else:
            floats[:, own], ints[:, own] = f[:, own], i[:, own]
    return floats, ints


def outcome_gather(times, values, rows, entry_ts, horizon_ts):
    """Host entry for the maturation gather: the ring planes as tensors,
    the pair bounds as numpy (the caller pads ``rows`` to its bucket with
    -1); returns the (4, K) float32 and (2, K) int32 results as numpy."""
    floats, ints = _gather_on_device(times, values, rows, entry_ts, horizon_ts)
    return floats.cpu().numpy(), ints.cpu().numpy()


def signed_outcome(
    direction: int,
    entry_close: float,
    fwd_close: float,
    min_low: float,
    max_high: float,
) -> tuple[float, float, float] | None:
    """(fwd_ret, mae, mfe) in direction-relative return space, or None when
    the raw gather is unusable (no entry bar, an empty window, a
    non-positive entry)."""
    if not (
        entry_close == entry_close
        and fwd_close == fwd_close
        and min_low == min_low
        and max_high == max_high
        and entry_close > 0
    ):
        return None
    fwd_raw = fwd_close / entry_close - 1.0
    lo = min_low / entry_close - 1.0
    hi = max_high / entry_close - 1.0
    if direction >= 0:
        return fwd_raw, min(0.0, lo), max(0.0, hi)
    return -fwd_raw, min(0.0, -hi), max(0.0, -lo)


def direction_sign(direction: Any) -> int:
    """'SHORT' / Direction.SHORT / 1 → -1; anything else (LONG, grid) +1."""
    s = str(direction)
    if s in ("SHORT", "1", "Direction.SHORT"):
        return -1
    return 1


def _pow2(n: int, floor: int = 8) -> int:
    """The gather's pair-axis bucket: the next power of two, at least
    ``floor``."""
    size = floor
    while size < n:
        size *= 2
    return size


class _Agg:
    """Per-(strategy, horizon) scoreboard cell."""

    __slots__ = ("n", "hits", "sum_fwd", "sum_mae", "sum_mfe", "worst_mae")

    def __init__(self) -> None:
        self.n = 0
        self.hits = 0
        self.sum_fwd = 0.0
        self.sum_mae = 0.0
        self.sum_mfe = 0.0
        self.worst_mae = 0.0

    def add(self, fwd: float, mae: float, mfe: float) -> None:
        self.n += 1
        self.hits += 1 if fwd > 0 else 0
        self.sum_fwd += fwd
        self.sum_mae += mae
        self.sum_mfe += mfe
        self.worst_mae = min(self.worst_mae, mae)

    def as_dict(self) -> dict:
        n = self.n
        return {
            "n": n,
            "hits": self.hits,
            "hit_rate": round(self.hits / n, 4) if n else None,
            "avg_fwd": round(self.sum_fwd / n, 6) if n else None,
            "avg_mae": round(self.sum_mae / n, 6) if n else None,
            "avg_mfe": round(self.sum_mfe / n, 6) if n else None,
            "worst_mae": round(self.worst_mae, 6) if n else None,
        }


class OutcomeTracker:
    """Open-signal registry and maturation for one engine.

    ``timings`` keeps, per maturation tick, the host milliseconds of the
    gather's issue (``gather_ms``), of the two device-to-host copies
    (``copy_ms``, which wait for the gather on a card) and of the fold into
    the scoreboard (``fold_ms``), with the pairs matured (the last 4096
    maturation ticks)."""

    def __init__(
        self,
        enabled: bool = True,
        horizons: tuple[int, ...] = DEFAULT_HORIZONS,
        cap: int = 1024,
    ) -> None:
        self.horizons = tuple(sorted({int(h) for h in (horizons or ()) if int(h) > 0}))
        # no positive horizon: the observatory is off
        self.enabled = bool(enabled) and bool(self.horizons)
        self.cap = max(int(cap), 1)
        # open slots in registration order (eviction pops the head)
        self._open: deque[dict] = deque()
        self.registered = 0
        self.evictions = 0
        self.matured = 0  # (signal, horizon) pairs matured
        self.truncated = 0  # matured pairs whose ring window was clipped
        self._agg: dict[tuple[str, int], _Agg] = {}
        # matured comparison tuples (strategy, symbol, entry_ts, horizon,
        # fwd, mae, mfe, bars), bounded
        self.recent: deque[tuple] = deque(maxlen=8192)
        self.timings: deque[dict] = deque(maxlen=4096)

    # -- registration ----------------------------------------------------------

    def register(
        self,
        strategy: str,
        symbol: str,
        row: int,
        entry_ts5: int,
        direction: Any,
        trace_id: str | None = None,
        tick_seq: int | None = None,
        tick_ms: int | None = None,
    ) -> None:
        """One emitted signal enters the open registry; ``entry_ts5`` is the
        evaluated 5m bar's open time (seconds), whose close is gathered as
        the entry anchor at maturation."""
        if not self.enabled:
            return
        if len(self._open) >= self.cap:
            self._open.popleft()
            self.evictions += 1
            OUTCOME_EVICTIONS.inc()
        self._open.append(
            {
                "strategy": strategy,
                "symbol": symbol,
                "row": int(row),
                "entry_ts": int(entry_ts5),
                "dir": direction_sign(direction),
                "trace_id": trace_id,
                "tick_seq": tick_seq,
                "tick_ms": tick_ms,
                "pending": list(self.horizons),
            }
        )
        self.registered += 1
        OUTCOME_OPEN.set(len(self._open))

    # -- maturation ------------------------------------------------------------

    def due_pairs(self, now_ts5: int) -> list[tuple[dict, int]]:
        """(slot, horizon) pairs whose horizon bar has closed by the tick
        evaluating the 5m bar that opens at ``now_ts5``."""
        out: list[tuple[dict, int]] = []
        for slot in self._open:
            for h in slot["pending"]:
                if slot["entry_ts"] + h * FIVE_MIN_S <= now_ts5:
                    out.append((slot, h))
        return out

    def on_tick(self, now_ts5: int, buf5) -> list[tuple]:
        """Mature everything due at this tick against the live 5m ring
        (``buf5.times`` / ``buf5.values``, or every shard's of a state placed
        on a symbol mesh). Returns the newly matured comparison tuples,
        also kept in ``recent``."""
        if not self.enabled or not self._open:
            return []
        pairs = self.due_pairs(int(now_ts5))
        if not pairs:
            return []
        K = _pow2(len(pairs))
        rows = np.full(K, -1, np.int32)
        entry = np.zeros(K, np.int32)
        horizon = np.zeros(K, np.int32)
        for i, (slot, h) in enumerate(pairs):
            rows[i] = slot["row"]
            entry[i] = slot["entry_ts"]
            horizon[i] = slot["entry_ts"] + h * FIVE_MIN_S
        t0 = time.perf_counter()
        if isinstance(buf5, ShardedState):
            floats, ints = _gather_sharded(buf5, rows, entry, horizon)
            t1 = t2 = time.perf_counter()
        else:
            floats_d, ints_d = _gather_on_device(buf5.times, buf5.values, rows, entry, horizon)
            t1 = time.perf_counter()
            floats, ints = floats_d.cpu().numpy(), ints_d.cpu().numpy()
            t2 = time.perf_counter()
        matured = self._fold(pairs, floats, ints)
        self.timings.append({
            "pairs": len(pairs),
            "gather_ms": (t1 - t0) * 1000.0,
            "copy_ms": (t2 - t1) * 1000.0,
            "fold_ms": (time.perf_counter() - t2) * 1000.0,
        })
        return matured

    def _fold(self, pairs, floats: np.ndarray, ints: np.ndarray) -> list[tuple]:
        log = get_event_log()
        matured: list[tuple] = []
        touched: set[tuple[str, int]] = set()
        for i, (slot, h) in enumerate(pairs):
            slot["pending"].remove(h)
            # plain floats: the values land in JSON events and snapshots
            outcome = signed_outcome(
                slot["dir"], float(floats[0, i]), float(floats[1, i]),
                float(floats[2, i]), float(floats[3, i]),
            )
            # the ring must still hold the pair's whole window: its oldest
            # retained bar at or before the entry anchor
            clipped = int(ints[1, i]) > slot["entry_ts"]
            self.matured += 1
            event: dict[str, Any] = {
                "strategy": slot["strategy"],
                "symbol": slot["symbol"],
                "horizon": h,
                "entry_ts": slot["entry_ts"],
                "bars": int(ints[0, i]),
                "tick_ms": slot["tick_ms"],
                "trace_id": slot["trace_id"],
                "tick_seq": slot["tick_seq"],
                "direction": "SHORT" if slot["dir"] < 0 else "LONG",
            }
            if outcome is None or clipped:
                self.truncated += 1
                OUTCOME_TRUNCATED.inc()
                event["truncated"] = True
                log.emit("signal_outcome", **event)
                continue
            fwd, mae, mfe = outcome
            key = (slot["strategy"], h)
            self._agg.setdefault(key, _Agg()).add(fwd, mae, mfe)
            touched.add(key)
            labels = dict(strategy=slot["strategy"], horizon=str(h))
            SIGNAL_FWD_RETURN.labels(**labels).observe(fwd)
            SIGNAL_MAE.labels(**labels).observe(mae)
            SIGNAL_MFE.labels(**labels).observe(mfe)
            OUTCOME_MATURED.labels(**labels).inc()
            event.update(fwd_ret=round(fwd, 6), mae=round(mae, 6), mfe=round(mfe, 6))
            log.emit("signal_outcome", **event)
            tup = (
                slot["strategy"], slot["symbol"], slot["entry_ts"], h,
                round(fwd, 6), round(mae, 6), round(mfe, 6), int(ints[0, i]),
            )
            self.recent.append(tup)
            matured.append(tup)
        for strategy, h in touched:
            agg = self._agg[(strategy, h)]
            SIGNAL_HIT_RATE.labels(strategy=strategy, horizon=str(h)).set(agg.hits / agg.n)
        # drop fully matured slots (registration order kept)
        self._open = deque(s for s in self._open if s["pending"])
        OUTCOME_OPEN.set(len(self._open))
        return matured

    # -- introspection and persistence -------------------------------------------

    def scoreboard(self) -> dict:
        """Counters and the per-(strategy, horizon) aggregates."""
        per_strategy: dict[str, dict[str, dict]] = {}
        for (strategy, h), agg in sorted(self._agg.items()):
            per_strategy.setdefault(strategy, {})[str(h)] = agg.as_dict()
        return {
            "enabled": self.enabled,
            "horizons": list(self.horizons),
            "cap": self.cap,
            "open": len(self._open),
            "registered": self.registered,
            "matured": self.matured,
            "truncated": self.truncated,
            "evictions": self.evictions,
            "per_strategy": per_strategy,
        }

    def snapshot_open(self) -> list[dict]:
        """JSON-safe snapshot of the open registry (the aggregates restart
        fresh; the open signals are what a restart must keep maturing)."""
        return [dict(slot, pending=list(slot["pending"])) for slot in self._open]

    def restore_open(self, slots: list[dict] | None) -> None:
        # a disabled tracker adopts nothing: it would never mature the slots
        if not slots or not self.enabled:
            return
        for slot in slots:
            self._open.append(
                {
                    "strategy": str(slot["strategy"]),
                    "symbol": str(slot["symbol"]),
                    "row": int(slot["row"]),
                    "entry_ts": int(slot["entry_ts"]),
                    "dir": int(slot.get("dir", 1)),
                    "trace_id": slot.get("trace_id"),
                    "tick_seq": slot.get("tick_seq"),
                    "tick_ms": slot.get("tick_ms"),
                    "pending": [int(h) for h in slot["pending"]],
                }
            )
        while len(self._open) > self.cap:
            self._open.popleft()
            self.evictions += 1
            OUTCOME_EVICTIONS.inc()
        OUTCOME_OPEN.set(len(self._open))

    def matured_set(self) -> set[tuple]:
        """The matured comparison tuples."""
        return set(self.recent)
