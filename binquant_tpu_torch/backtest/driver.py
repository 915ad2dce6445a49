"""Host driver of the time-batched backtest backend.

Port of ``binquant_tpu/backtest/driver.py``. It follows the scanned drive
(``SignalEngine.process_ticks_scanned``): runs of clean-append ticks
accumulate into a plan, each tick's host inputs captured in the serial
drive's order by the SAME planner (``_plan_scan_tick``); an ineligible tick
(the cold start's churn, a rewrite) flushes the plan and runs serially,
which on the full-recompute engines this backend requires evaluates as a
never-batched drive would. A chunk whose fired count overflows the wire's
compaction is re-driven serially from the plan's start, so the emitted set
stays exact.

What differs from the scanned drive: the planner lays the chunk's appends
out as an ``(S, W+N)`` extension of the pre-chunk ring on the engine's
device (only the appended columns are uploaded) plus per-tick cumulative
bar counts, and runs ``backtest_chunk``. After the chunk, the engine's rings
are REPLACED by the extension's final window (new canonical tensors,
bit-equal to serially applied appends) and the regime and dedupe carries
are committed, so serial ticks interleave freely: every later dispatch, a
checkpoint save (refused while it holds the state) and the in-place
path's version checks read the new tensors.

``run_backtest`` is the entry over a JSONL stream (stub sinks, the
``run_replay`` contract); ``run_param_sweep`` scores a parameter grid per
chunk (``backtest_chunk_sweep``) and ranks the combos by their signals'
forward returns through the live outcome tracker's gather.
"""

from __future__ import annotations

import asyncio
import time
from pathlib import Path

import numpy as np
import torch

from binquant_tpu_torch.backtest.kernel import (
    BACKTEST_STRATEGIES,
    backtest_chunk,
    backtest_chunk_sweep,
)
from binquant_tpu_torch.engine.buffer import NUM_FIELDS, MarketBuffer
from binquant_tpu_torch.engine.step import (
    STRATEGY_ORDER,
    WIRE_FIRED_COUNT_OFF,
    WIRE_MAX_FIRED,
    EngineState,
    canonicalize_state,
)
from binquant_tpu_torch.strategies.params import (
    StrategyParams,
    grid_combo,
    grid_size,
    make_param_grid,
)


def _build_extension(base_times, base_vals, ticks_batches: list[list], window: int):
    """Lay a chunk's clean appends out past the pre-chunk ring.

    ``base_times`` (S, W) / ``base_vals`` (S, W, F) are the canonical ring
    (tensors on the engine's device, or numpy). Returns ``(ext_times (S,
    W+N), ext_vals (S, W+N, F), counts (T, S))`` of the same kind, with
    numpy ``counts``: ``counts[t, s]`` is how many bars symbol s has applied
    through tick t, the window views' gather offset. Column ``W + k`` holds
    the symbol's k-th appended bar; only those columns are built on the
    host (and uploaded)."""
    S = base_times.shape[0]
    T = len(ticks_batches)
    totals = np.zeros(S, np.int64)
    for batches in ticks_batches:
        for rows, _, _ in batches:
            rows = np.asarray(rows)
            np.add.at(totals, rows[(rows >= 0) & (rows < S)], 1)
    n_ext = int(totals.max()) if S else 0
    app_t = np.full((S, n_ext), -1, np.int32)
    app_v = np.full((S, n_ext, NUM_FIELDS), np.nan, np.float32)
    cnt = np.zeros(S, np.int64)
    counts = np.zeros((T, S), np.int32)
    for t, batches in enumerate(ticks_batches):
        for rows, ts, vals in batches:
            rows = np.asarray(rows, np.int64)
            ok = (rows >= 0) & (rows < S)
            r = rows[ok]
            app_t[r, cnt[r]] = np.asarray(ts)[ok]
            app_v[r, cnt[r]] = np.asarray(vals, np.float32)[ok]
            cnt[r] += 1
        counts[t] = cnt
    if isinstance(base_times, torch.Tensor):
        dev = base_times.device
        ext_t = torch.cat([base_times, torch.from_numpy(app_t).to(dev)], dim=1)
        ext_v = torch.cat([base_vals, torch.from_numpy(app_v).to(dev)], dim=1)
    else:
        ext_t = np.concatenate([np.asarray(base_times, np.int32), app_t], axis=1)
        ext_v = np.concatenate([np.asarray(base_vals, np.float32), app_v], axis=1)
    return ext_t, ext_v, counts


def _final_window(ext_t, ext_v, start, filled0, window: int) -> MarketBuffer:
    """The post-chunk ring: each symbol's last W extension columns from
    ``start`` (its appended bars), exactly what serial appends produce, as
    NEW canonical tensors (or numpy arrays for numpy inputs)."""
    if isinstance(ext_t, torch.Tensor):
        dev = ext_t.device
        start = torch.as_tensor(np.asarray(start), dtype=torch.int64).to(dev)
        cols = start[:, None] + torch.arange(window, device=dev)
        times = torch.gather(ext_t, 1, cols)
        vals = torch.gather(ext_v, 1, cols[:, :, None].expand(-1, -1, NUM_FIELDS))
        filled = torch.clamp(filled0.to(torch.int64) + start, max=window).to(torch.int32)
        return MarketBuffer(times=times, values=vals, filled=filled,
                            cursor=torch.zeros_like(filled))
    cols = np.asarray(start, np.int64)[:, None] + np.arange(window)
    filled = np.minimum(np.asarray(filled0, np.int64) + start, window).astype(np.int32)
    return MarketBuffer(
        times=np.take_along_axis(ext_t, cols, axis=1),
        values=np.take_along_axis(ext_v, cols[:, :, None], axis=1),
        filled=filled,
        cursor=np.zeros(filled.shape, np.int32),
    )


def _check_supported(enabled, window: int | None = None) -> None:
    unsupported = set(enabled) - BACKTEST_STRATEGIES
    if unsupported:
        raise ValueError(
            f"backtest backend cannot evaluate {sorted(unsupported)}; "
            f"supported: {sorted(BACKTEST_STRATEGIES)} (use the serial "
            "replay drives for buffer-consuming dormant strategies)"
        )
    from binquant_tpu_torch.strategies.activity_burst_pump import ABP_EXT_MIN_WINDOW

    if window is not None and "activity_burst_pump" in enabled and window < ABP_EXT_MIN_WINDOW:
        raise ValueError(
            f"window {window} too short for the backtest backend's "
            f"extended-series ABP core (need >= {ABP_EXT_MIN_WINDOW}); "
            "grow the window or disable activity_burst_pump"
        )


async def _flush_backtest_plan(engine, plan: dict, params) -> list:
    """Run one planned chunk through ``backtest_chunk``, commit the
    post-chunk state, and finalize its ticks through the standard decode.
    An overflow re-drives the plan serially from its start. One
    ``backtest_chunk`` span (stack / dispatch / device_wait children, plan
    and finalize spans, ``path=backtest``) and ``backtest`` host-phase
    accounting per chunk, as the scanned drive books its chunks."""
    from binquant_tpu_torch.obs.instruments import (
        BACKTEST_CHUNKS,
        BACKTEST_OVERFLOW_RERUNS,
        BACKTEST_TICKS,
    )

    ticks = plan["ticks"]
    if not ticks:
        return []
    if len(ticks) < engine._SCAN_MIN_TICKS or engine.mesh is not None:
        return await engine._redrive_serial(plan)
    fired_all: list = await engine.flush_pending()
    engine._refuse_while_held("a backtest chunk")
    T = len(ticks)
    W = engine.window
    dev = engine.device
    trace, plan_ms, t_chunk0 = engine._open_chunk("backtest", plan, T)
    try:
        with engine.latency.stage("backtest_chunk"), trace.span(
            "backtest_chunk", ticks=T
        ), trace.activate():
            with trace.span("stack"), engine.host_phase.phase("backtest", "stack"):
                # the extension lays appends past a RIGHT-ALIGNED base: a
                # mid-phase ring canonicalizes here, once per chunk
                state = canonicalize_state(engine.state)
                ext5_t, ext5_v, counts5 = _build_extension(
                    state.buf5.times, state.buf5.values, [p.batches5 for p in ticks], W
                )
                ext15_t, ext15_v, counts15 = _build_extension(
                    state.buf15.times, state.buf15.values, [p.batches15 for p in ticks], W
                )
                filled0 = (state.buf5.filled, state.buf15.filled)
                inputs_seq, momentum_seq = engine._stack_plan_inputs(ticks)
                inputs_dev, momentum_dev, policy_prev = engine._chunk_inputs_to_device(
                    inputs_seq, momentum_seq
                )
                counts_dev = torch.from_numpy(np.stack([counts5, counts15])).to(dev)
                key = engine._wire_enabled_key()
                # the extension-invariant block assumes ONE btc_row across
                # the chunk; a chunk where the bench moved takes the views
                btc_rows = inputs_seq.btc_row
                ext_invariant = bool(engine.ext_invariant) and bool(
                    np.all(btc_rows == btc_rows[0])
                )
            t_launch0 = time.perf_counter()
            with trace.span("dispatch"), engine.host_phase.phase("backtest", "dispatch"):
                carries, _policy, wires_dev, _fired, _counts = backtest_chunk(
                    (ext5_t, ext5_v), (ext15_t, ext15_v), counts_dev[0], counts_dev[1],
                    filled0,
                    (state.regime_carry, state.mrf_last_emitted, state.pt_last_signal_close),
                    inputs_dev, momentum_dev, policy_prev, engine.context_config,
                    wire_enabled=key, window=W, params=params,
                    numeric_digest=engine.numeric_digest, ingest_digest=engine.ingest_digest,
                    ext_invariant=ext_invariant,
                )
            with trace.span("device_wait"), engine.host_phase.phase("backtest", "device_wait"):
                wires = wires_dev.cpu().numpy()
    except BaseException as exc:
        trace.mark_error(exc)
        engine.tracer.complete(trace, snapshot_fn=engine._flight_snapshot)
        raise
    engine.freshness.observe_stage("dispatch_to_fetch", (time.perf_counter() - t_launch0) * 1000.0)
    if np.any(wires[:, WIRE_FIRED_COUNT_OFF] > WIRE_MAX_FIRED):
        engine._close_overflowed_chunk("backtest", trace, plan_ms, t_chunk0, T)
        engine.backtest_overflow_reruns += 1
        BACKTEST_OVERFLOW_RERUNS.inc()
        fired_all.extend(await engine._redrive_serial(plan))
        return fired_all
    regime_carry, mrf_carry, pt_carry = carries
    engine.state = EngineState(
        buf5=_final_window(ext5_t, ext5_v, counts5[-1], filled0[0], W),
        buf15=_final_window(ext15_t, ext15_v, counts15[-1], filled0[1], W),
        regime_carry=regime_carry,
        mrf_last_emitted=mrf_carry,
        pt_last_signal_close=pt_carry,
        # a full-recompute backend never reads the indicator carry
        indicator_carry=state.indicator_carry,
    )
    engine.backtest_chunks += 1
    BACKTEST_CHUNKS.inc()
    engine.backtest_ticks += T
    BACKTEST_TICKS.inc(T)
    engine.last_path = "classic"
    fired_all.extend(
        await engine._finalize_chunk("backtest", plan, wires, trace, plan_ms, t_chunk0)
    )
    return fired_all


async def drive_ticks_backtest(engine, ticks, params=None, chunk=None) -> list:
    """Drive a replayed tick sequence through the time-batched backend.

    The contract of ``process_ticks_scanned``: ``ticks`` iterates ``(now_ms,
    feed)`` pairs, every emitted signal returns in tick order stamped with
    its tick. Requires a FULL-recompute engine (``incremental=False``): the
    backend evaluates the full path and commits chunk state the carried
    path could not resync from. ``params`` (a StrategyParams) is installed
    on the engine for the drive, so its serial re-entries evaluate with the
    chunks' thresholds, then restored."""
    if engine.incremental:
        raise ValueError(
            "the backtest backend requires a full-recompute engine — "
            "construct it with incremental=False"
        )
    _check_supported(engine._wire_enabled_key(), engine.window)
    chunk = int(chunk or engine.backtest_chunk)
    prev_params = engine.strategy_params
    if params is not None:
        engine.strategy_params = params
    try:
        fired_all: list = await engine.flush_pending()
        plan: dict | None = None
        for now_ms, feed in ticks:
            t_plan0 = time.perf_counter()
            batches5, batches15, churn, ingest_mono = engine._drain_for_plan(feed)
            clean = engine._note_applied(batches5, batches15, commit=False)
            # a sharded engine runs every tick serially, as the reference's
            if not clean or churn or engine.mesh is not None:
                if plan is not None:
                    fired_all.extend(await _flush_backtest_plan(engine, plan, params))
                    plan = None
                engine._requeue_batches(batches5, batches15)
                fired_all.extend(await engine.process_tick(now_ms=now_ms))
                continue
            plan = await engine._plan_tick(plan, now_ms, batches5, batches15, ingest_mono,
                                           t_plan0)
            if len(plan["ticks"]) >= chunk:
                fired_all.extend(await _flush_backtest_plan(engine, plan, params))
                plan = None
        if plan is not None:
            fired_all.extend(await _flush_backtest_plan(engine, plan, params))
        return fired_all
    finally:
        engine.strategy_params = prev_params


def run_backtest(
    path: str | Path,
    capacity: int = 256,
    window: int = 200,
    collect: list | None = None,
    breadth: dict | None = None,
    enabled_strategies: set | None = None,
    dominance_is_losers: bool = False,
    market_domination_reversal: bool = False,
    context_config=None,
    params: StrategyParams | None = None,
    chunk: int | None = None,
    outcomes: bool | None = None,
    outcome_horizons: tuple[int, ...] | None = None,
    collect_outcomes: list | None = None,
    ext_invariant: bool | None = None,
    device: str | None = None,
) -> dict:
    """Backtest a JSONL kline stream through the time-batched backend: the
    ``run_replay`` twin (stub sinks called inline, one tick per 15m
    bucket), fired signals appended to ``collect`` as ``(tick_ms, strategy,
    symbol, direction, autotrade)`` tuples. With ``ext_invariant`` off the
    emitted set is EXACTLY the serial full-recompute drive's
    (``run_replay(incremental=False)``). Runs on ``device`` (the card
    unless ``"cpu"``)."""
    from binquant_tpu_torch.io.replay import make_stub_engine, signal_tuples, tick_seq

    if enabled_strategies is not None:
        _check_supported(frozenset(enabled_strategies))
    engine = make_stub_engine(
        capacity=capacity, window=window, breadth=breadth, pipeline_depth=0,
        enabled_strategies=enabled_strategies, context_config=context_config, device=device,
        incremental=False, donate=False, outcomes=outcomes,
        outcome_horizons=outcome_horizons, ext_invariant=ext_invariant,
        # the inline sinks: the backtest lane's sink effects are synchronous
        delivery=False, fanout=False,
    )
    engine.at_consumer.market_domination_reversal = market_domination_reversal
    engine.at_consumer.current_market_dominance_is_losers = dominance_is_losers
    seq = tick_seq(path)
    candles = sum(len(klines) for _, klines in seq)
    fired_total = 0

    def record(fired) -> None:
        nonlocal fired_total
        fired_total += len(fired)
        if collect is not None:
            collect.extend(signal_tuples(fired))

    async def drive() -> None:
        record(await drive_ticks_backtest(engine, seq, params=params, chunk=chunk))
        record(await engine.flush_pending())

    t_start = time.perf_counter()
    asyncio.run(drive())
    wall = time.perf_counter() - t_start
    if engine.outcomes.enabled and collect_outcomes is not None:
        collect_outcomes.extend(sorted(engine.outcomes.matured_set()))
    return {
        **({"outcomes": engine.outcomes.scoreboard()} if engine.outcomes.enabled else {}),
        "device": str(engine.device),
        "ticks": engine.ticks_processed,
        "backtest_ticks": engine.backtest_ticks,
        "backtest_chunks": engine.backtest_chunks,
        "backtest_overflow_reruns": engine.backtest_overflow_reruns,
        "serial_ticks": engine.ticks_processed - engine.backtest_ticks,
        "signals": fired_total,
        "candles": candles,
        "wall_s": round(wall, 3),
        "candles_per_sec": round(candles / wall, 1) if wall > 0 else None,
    }


class _SweepOutcomeScorer:
    """Economic scoring of :func:`run_param_sweep`.

    One price stream is shared by every combo, so a fired signal's outcome
    depends only on its (symbol row, entry bar) pair and the horizon: each
    UNIQUE pair matures once through the live tracker's gather
    (``obs.outcomes.outcome_gather``, on the sweep's committed 5m ring) and
    the result is attributed, signed per direction, to every (combo,
    strategy, direction) that fired it. Maturation runs at each chunk's
    flush; the gather is timestamp-bounded, so maturing later than due
    changes nothing while the ring still holds the window (a clipped window
    counts as truncated, as in the live tracker)."""

    def __init__(self, P: int, horizons: tuple[int, ...] | None) -> None:
        from binquant_tpu_torch.obs.outcomes import _Agg

        self.P = int(P)
        self.horizons = tuple(sorted({int(h) for h in (horizons or ()) if int(h) > 0}))
        self._agg_cls = _Agg
        self._pair_ids: dict[tuple[int, int], int] = {}
        self._pairs: list[dict] = []  # {row, entry_ts, pending}
        self._refs: list[list[tuple[int, int, int]]] = []  # (p, si, sign)
        # per combo: (si, horizon) -> the live tracker's scoreboard cell
        self.agg: list[dict[tuple[int, int], object]] = [{} for _ in range(self.P)]
        self.matured_pairs = 0
        self.truncated = 0
        # fired slots past the wire's compaction on a burst tick: the sweep
        # has no serial path, so they are dropped from scoring, counted
        self.overflow_dropped = 0

    @property
    def enabled(self) -> bool:
        """No positive horizon: scoring off."""
        return bool(self.horizons)

    def register_chunk(self, slots, nfired, tick_ts5: list[int]) -> None:
        """One chunk's fired compactions: ``slots`` (P, T, 3, K) rows
        (strategy_idx, row, direction), ``nfired`` (P, T)."""
        from binquant_tpu_torch.obs.outcomes import direction_sign

        if not self.enabled:
            return
        slots = np.asarray(slots)
        nfired = np.asarray(nfired)
        K = slots.shape[-1]
        for t, ts5 in enumerate(tick_ts5):
            for p in range(self.P):
                n = int(nfired[p, t])
                k = min(n, K)
                if n > K:
                    self.overflow_dropped += n - K
                if k <= 0:
                    continue
                si = slots[p, t, 0, :k].astype(np.int64)
                row = slots[p, t, 1, :k].astype(np.int64)
                dirn = slots[p, t, 2, :k].astype(np.int64)
                ok = row >= 0
                for s, r, d in zip(si[ok], row[ok], dirn[ok]):
                    key = (int(r), int(ts5))
                    pid = self._pair_ids.get(key)
                    if pid is None:
                        pid = len(self._pairs)
                        self._pair_ids[key] = pid
                        self._pairs.append(
                            {"row": int(r), "entry_ts": int(ts5), "pending": list(self.horizons)}
                        )
                        self._refs.append([])
                    self._refs[pid].append((p, int(s), direction_sign(int(d))))

    def mature(self, times5, vals5, now_ts5: int) -> None:
        """Mature every due (pair, horizon) against the committed 5m ring
        (``times5``/``vals5`` tensors on the gather's device)."""
        from binquant_tpu_torch.obs.outcomes import (
            FIVE_MIN_S,
            _pow2,
            outcome_gather,
            signed_outcome,
        )

        if not self.enabled:
            return
        due = [
            (pid, h)
            for pid, pair in enumerate(self._pairs)
            for h in pair["pending"]
            if pair["entry_ts"] + h * FIVE_MIN_S <= now_ts5
        ]
        if not due:
            return
        K = _pow2(len(due))
        rows = np.full(K, -1, np.int32)
        entry = np.zeros(K, np.int32)
        horizon = np.zeros(K, np.int32)
        for i, (pid, h) in enumerate(due):
            rows[i] = self._pairs[pid]["row"]
            entry[i] = self._pairs[pid]["entry_ts"]
            horizon[i] = entry[i] + h * FIVE_MIN_S
        floats, ints = outcome_gather(times5, vals5, rows, entry, horizon)
        for i, (pid, h) in enumerate(due):
            pair = self._pairs[pid]
            pair["pending"].remove(h)
            self.matured_pairs += 1
            clipped = int(ints[1, i]) > pair["entry_ts"]
            raw = tuple(float(floats[j, i]) for j in range(4))
            # an unusable raw gather counts as truncated, as in the live
            # tracker; usability does not depend on the direction
            if clipped or signed_outcome(1, *raw) is None:
                self.truncated += 1
                continue
            for p, si, sign in self._refs[pid]:
                fwd, mae, mfe = signed_outcome(sign, *raw)
                cell = self.agg[p].get((si, h))
                if cell is None:
                    cell = self.agg[p][(si, h)] = self._agg_cls()
                cell.add(fwd, mae, mfe)

    def result(self, score_horizon: int | None = None) -> dict:
        """The sweep's ``outcomes`` section: per-combo per-strategy
        scoreboards (the live tracker's cells) and one score row per combo
        at the scoring horizon (the largest that matured anything, unless
        pinned); ``ranking_by_return`` orders the combos by summed signed
        forward return."""
        if not self.enabled:
            return {"enabled": False}
        matured_h = {h for by in self.agg for (_, h) in by}
        if score_horizon is None:
            score_horizon = max(matured_h) if matured_h else max(self.horizons)
        per_combo = []
        combo_score = []
        for p in range(self.P):
            by_strategy: dict[str, dict[str, dict]] = {}
            for (si, h), cell in sorted(self.agg[p].items()):
                by_strategy.setdefault(STRATEGY_ORDER[si], {})[str(h)] = cell.as_dict()
            per_combo.append(by_strategy)
            n = hits = 0
            sum_fwd = sum_mae = 0.0
            for (_, h), cell in self.agg[p].items():
                if h != score_horizon:
                    continue
                n += cell.n
                hits += cell.hits
                sum_fwd += cell.sum_fwd
                sum_mae += cell.sum_mae
            combo_score.append({
                "n": n,
                "hit_rate": round(hits / n, 4) if n else None,
                "avg_fwd": round(sum_fwd / n, 6) if n else None,
                "sum_fwd": round(sum_fwd, 6),
                "avg_mae": round(sum_mae / n, 6) if n else None,
            })
        ranking = sorted(range(self.P), key=lambda p: (-combo_score[p]["sum_fwd"], p))
        return {
            "enabled": True,
            "horizons": list(self.horizons),
            "score_horizon": int(score_horizon),
            "per_combo": per_combo,
            "combo_score": combo_score,
            "ranking_by_return": [int(p) for p in ranking],
            "matured_pairs": self.matured_pairs,
            "truncated": self.truncated,
            "unmatured_pair_horizons": int(sum(len(pair["pending"]) for pair in self._pairs)),
            "overflow_dropped_slots": self.overflow_dropped,
        }


def _apply_host_updates(times, vals, filled, batches, window: int) -> None:
    """``apply_updates`` on host numpy rings (the sweep's state): a
    strictly-newer bar shift-appends, a matching timestamp overwrites in
    place, a stale bar with no match is dropped."""
    for rows, ts, v in batches:
        ts = np.asarray(ts)
        v = np.asarray(v, np.float32)
        for i, row in enumerate(np.asarray(rows, np.int64)):
            if not 0 <= row < times.shape[0]:
                continue
            t_i = int(ts[i])
            if filled[row] == 0 or t_i > times[row, -1]:
                times[row, :-1] = times[row, 1:]
                times[row, -1] = t_i
                vals[row, :-1] = vals[row, 1:]
                vals[row, -1] = v[i]
                filled[row] = min(filled[row] + 1, window)
            else:
                match = np.nonzero(times[row] == t_i)[0]
                if len(match):
                    vals[row, match[0]] = v[i]


def _auto_sweep_chunk(base_chunk: int, P: int, capacity: int, budget_mb: int) -> int:
    """The sweep's chunk from a device-memory budget: its dominant batched
    term is the outcome scorer's quantile windows, P combos x S rows x ~80
    float32 per chunk tick; the chunk drops until that fits ``budget_mb``.
    Small grids keep ``base_chunk``."""
    per_tick_bytes = max(1, P * capacity * 80 * 4)
    fit = int((int(budget_mb) << 20) // per_tick_bytes)
    return max(1, min(int(base_chunk), fit))


def run_param_sweep(
    path: str | Path,
    axes: dict,
    capacity: int = 64,
    window: int = 200,
    breadth: dict | None = None,
    enabled_strategies: set | None = None,
    context_config=None,
    chunk: int | None = None,
    base_params: StrategyParams | None = None,
    horizons: tuple[int, ...] | None = (1, 4, 16, 96),
    score_horizon: int | None = None,
    device: str | None = None,
    seq: list | None = None,
) -> dict:
    """Score a strategy-parameter grid over a kline stream: every chunk is
    evaluated for every combo (``backtest_chunk_sweep``).

    The per-combo carries (regime state, dedupe cooldowns, grid policy)
    evolve independently across chunks; the rings and the features are
    shared. A non-append tick (a rewrite) flushes the chunk, applies on the
    host and keeps sweeping — the sweep scores, it emits nothing. Returns
    per-combo per-strategy trigger and autotrade counts, and the economic
    proxies: each combo's fired signals matured through the live tracker's
    gather at ``horizons`` 5m bars, ``outcomes.ranking_by_return`` ranking
    the combos by summed signed forward return at ``score_horizon``.
    ``horizons`` with no positive entry turns scoring off. ``seq`` passes
    the ``(now_ms, feed)`` ticks instead of reading ``path``: ``feed`` a
    list of klines, or a callable that loads the sweep engine's batchers
    (``feed(engine)``, e.g. a bulk history through ``add_batch``). Runs on
    ``device`` (the card unless ``"cpu"``)."""
    from binquant_tpu_torch.io.pipeline import FIFTEEN_MIN_S
    from binquant_tpu_torch.io.replay import make_stub_engine, tick_seq
    from binquant_tpu_torch.regime.context import initial_regime_carry

    grid, combos = make_param_grid(axes, base_params)
    P = max(grid_size(grid), 1)
    combo_params = [grid_combo(grid, i) for i in range(P)]
    engine = make_stub_engine(
        capacity=capacity, window=window, breadth=breadth, pipeline_depth=0,
        enabled_strategies=enabled_strategies, context_config=context_config, device=device,
        incremental=False, donate=False, delivery=False, fanout=False,
    )
    dev = engine.device
    key = engine._wire_enabled_key()
    _check_supported(key, window)
    if not chunk:
        chunk = _auto_sweep_chunk(
            engine.backtest_chunk, P, capacity, int(engine.config.sweep_mem_budget_mb or 1024)
        )
    chunk = int(chunk)
    S, W = capacity, window

    # host rings shared by every combo (params never touch the buffers)
    times5 = np.full((S, W), -1, np.int32)
    vals5 = np.full((S, W, NUM_FIELDS), np.nan, np.float32)
    filled5 = np.zeros(S, np.int64)
    times15 = np.full((S, W), -1, np.int32)
    vals15 = np.full((S, W, NUM_FIELDS), np.nan, np.float32)
    filled15 = np.zeros(S, np.int64)

    carriesP = [
        (initial_regime_carry(S, device=dev),
         torch.full((S,), -1, dtype=torch.int32, device=dev),
         torch.full((S,), -1, dtype=torch.int32, device=dev))
        for _ in range(P)
    ]
    policyP = [
        (torch.zeros((), dtype=torch.bool, device=dev),
         torch.full((), -1, dtype=torch.int32, device=dev))
        for _ in range(P)
    ]
    n_strat = len(STRATEGY_ORDER)
    trig_totals = np.zeros((P, n_strat), np.int64)
    at_totals = np.zeros((P, n_strat), np.int64)
    evaluated = dispatches = candles = 0
    chunk_ms: list[float] = []
    scorer = _SweepOutcomeScorer(P, horizons)
    if seq is None:
        seq = tick_seq(path)
    plan: list = []  # (tick plan, appended batches5, appended batches15)

    def flush() -> None:
        nonlocal carriesP, policyP, evaluated, dispatches
        nonlocal times5, vals5, filled5, times15, vals15, filled15
        if not plan:
            return
        t0 = time.perf_counter()
        ticks = [p for p, _, _ in plan]
        T = len(ticks)
        ext5_t, ext5_v, counts5 = _build_extension(times5, vals5, [b for _, b, _ in plan], W)
        ext15_t, ext15_v, counts15 = _build_extension(times15, vals15, [b for _, _, b in plan], W)
        inputs_seq, momentum_seq = engine._stack_plan_inputs(ticks)
        inputs_dev, momentum_dev, _ = engine._chunk_inputs_to_device(inputs_seq, momentum_seq)
        ext5 = tuple(torch.from_numpy(x).to(dev) for x in (ext5_t, ext5_v))
        ext15 = tuple(torch.from_numpy(x).to(dev) for x in (ext15_t, ext15_v))
        counts_dev = torch.from_numpy(np.stack([counts5, counts15])).to(dev)
        filled0 = tuple(
            torch.from_numpy(f.astype(np.int32)).to(dev) for f in (filled5, filled15)
        )
        carriesP, policyP, fired, tc, ac, fired_slots = backtest_chunk_sweep(
            ext5, ext15, counts_dev[0], counts_dev[1], filled0, carriesP, inputs_dev,
            momentum_dev, policyP, engine.context_config, wire_enabled=key,
            window=W, params=combo_params, with_fired_slots=scorer.enabled,
        )
        trig_totals[:] += tc.sum(dim=1).cpu().numpy()
        at_totals[:] += ac.sum(dim=1).cpu().numpy()
        evaluated += T
        dispatches += 1
        # register every combo's fired slots against their entry bars
        # BEFORE the rings move on...
        if scorer.enabled:
            scorer.register_chunk(fired_slots.cpu().numpy(), fired.cpu().numpy(),
                                  [p.ts5 for p in ticks])
        # ...commit the post-chunk rings (the host copy; the card's for
        # the maturation gather)...
        buf5 = _final_window(ext5_t, ext5_v, counts5[-1], filled5, W)
        buf15 = _final_window(ext15_t, ext15_v, counts15[-1], filled15, W)
        times5, vals5, filled5 = buf5.times, buf5.values, buf5.filled.astype(np.int64)
        times15, vals15, filled15 = buf15.times, buf15.values, buf15.filled.astype(np.int64)
        # ...then mature everything due by the chunk's last evaluated bar
        if scorer.enabled:
            ring5 = _final_window(ext5[0], ext5[1], counts5[-1], filled0[0], W)
            scorer.mature(ring5.times, ring5.values, ticks[-1].ts5)
        chunk_ms.append((time.perf_counter() - t0) * 1000.0)
        plan.clear()

    t_start = time.perf_counter()
    for now_ms, feed in seq:
        if callable(feed):
            feed(engine)
            candles += len(engine.batcher5) + len(engine.batcher15)
        else:
            for k in feed:
                engine.ingest(k)
            candles += len(feed)
        batches5 = engine.batcher5.drain()
        batches15 = engine.batcher15.drain()
        clean = engine._note_applied(batches5, batches15)
        momentum_ok = engine._grid_momentum_ok()
        asyncio.run(engine._refresh_market_breadth((now_ms // 1000) // FIFTEEN_MIN_S))
        tick_plan = engine._plan_scan_tick(now_ms, batches5, batches15, momentum_ok)
        if not clean:
            # a rewrite: flush, apply with overwrite semantics, and evaluate
            # this tick against the corrected rings with no appends
            flush()
            _apply_host_updates(times5, vals5, filled5, batches5, W)
            _apply_host_updates(times15, vals15, filled15, batches15, W)
            plan.append((tick_plan, [], []))
        else:
            plan.append((tick_plan, batches5, batches15))
        if len(plan) >= chunk:
            flush()
    flush()
    wall = time.perf_counter() - t_start

    order = np.argsort(-trig_totals.sum(axis=1), kind="stable")
    return {
        "P": P,
        "device": str(dev),
        "outcomes": scorer.result(score_horizon=score_horizon),
        "combos": combos,
        "axes": {k: [float(v) for v in vs] for k, vs in axes.items()},
        "strategies": list(STRATEGY_ORDER),
        "trig_counts": trig_totals.tolist(),
        "autotrade_counts": at_totals.tolist(),
        "total_fired": trig_totals.sum(axis=1).tolist(),
        "ranking": [int(i) for i in order],
        "evaluated_ticks": evaluated,
        "dispatches": dispatches,
        "chunk_ms": chunk_ms,
        "candles": candles,
        "wall_s": round(wall, 3),
        "combo_candles_per_sec": round(P * candles / wall, 1) if wall > 0 else None,
    }
