"""Per-stage profiler of the tick on the card: the port of the root
``tools/profile_stages.py``.

Times each stage of the tick's evaluation separately, warmed and
synchronized, at production width, plus the transfer and round-trip costs,
so that kernel work is directed by measurement instead of guessing::

    python -m binquant_tpu_torch.tools.profile_stages [--symbols 2048] \\
        [--window 400] [--trace DIR] [--json PATH] [--device cuda|cpu]

The stages, their names and order are the reference script's; so are the
market (seed 7: W bars of a random walk on every row, then one more bar as
the live tick's update) and the totals it prints. The port's rings are
filled with one bulk write of those W bars, equal to what W
``apply_updates`` calls would leave (:func:`fill_rings`). The reference
pads the tick's update batch to a compile bucket (``pad_updates``); the
port compiles nothing per shape, so the stages take the S-row batch as it
is. ``h2d: HostInputs (16 leaves)`` keeps the reference's name; the port's
``HostInputs`` has 15 leaves.

Per stage it reports, on standard error, the reference's p50 and max wall
ms of a synchronized call and beside them: ``dev``, the device ms between
two CUDA events recorded around the call (device time when the device is
the slower side, else the host's issue time), ``issue``, the host ms until
the call returns, before the sync, ``busy``, the device's busy ms and
``ops``, its operations (kernels, copies, fills), both counted by
``torch.profiler`` over one extra, untimed call (printed in a second block;
"not measured" where the profiler lost that call's records), and, for the
rows that
reach the qtail kernel (``abp``, ``detect_spikes``, the full
``tick_step``), that call's launches by call site. On the CPU
(``--device cpu``, only when asked: without a card the default fails) the
device columns are not measured, and the qtail column counts the twin's
calls instead of launches. ``--json PATH`` writes the rows and totals;
``--trace DIR`` writes a Chrome trace of three full ticks.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from binquant_tpu_torch import resolve_device
from binquant_tpu_torch.engine.buffer import NUM_FIELDS, Field, MarketBuffer
from binquant_tpu_torch.engine.step import (
    EngineState,
    HostInputs,
    default_host_inputs,
    initial_engine_state,
)

SEED = 7
ITERS, WARMUP = 8, 2  # timed and warm-up calls per stage, as the reference's
T0 = 1_753_000_000  # the first bar's open time (s)
BAR_S = 900

STAGES = (
    "rtt: tiny jit + D2H fetch",
    "h2d: update batch (3 arrays)",
    "h2d: HostInputs (16 leaves)",
    "apply_updates (one buffer)",
    "compute_feature_pack",
    "compute_feature_pack (incremental)",
    "detect_spikes",
    "compute_market_context",
    "btc beta/corr",
    "abp",
    "price_tracker",
    "liquidation_sweep_pump",
    "mean_reversion_fade",
    "ladder_deployer",
    "supertrend_swing_reversal",
    "twap_momentum_sniper",
    "buy_low_sell_high",
    "buy_the_dip",
    "bb_extreme_reversion",
    "inverse_price_tracker",
    "range_bb_rsi_mean_reversion",
    "range_failed_breakout_fade",
    "relative_strength_reversal_range",
    "tick_step (device-resident inputs)",
    "tick_step (incremental carry)",
    "tick_step (host inputs + D2H)",
)
FULL_STEP, INCR_STEP = STAGES[-3], STAGES[-2]
QTAIL_STAGES = ("abp", "detect_spikes", FULL_STEP)
# the spin kernel that marks both ends of a counted call, and its length;
# the idle seconds at both ends of the counting session
MARK_KERNEL, MARK_CYCLES = "spin_kernel", 1000
EDGE_S = 0.5


# -- the market ------------------------------------------------------------------


class Market(NamedTuple):
    """The reference's profiling market: ``times`` (W,) bar open times,
    ``vals`` (W, S, F) the bars every row closed, and the live tick's
    ``now`` with its update batch ``upd`` (rows, ts, vals) on the host."""

    times: np.ndarray
    vals: np.ndarray
    now: int
    upd: tuple[np.ndarray, np.ndarray, np.ndarray]


def make_market(symbols: int, window: int, seed: int = SEED) -> Market:
    """W bars and the live tick's bar, drawn exactly as the reference
    script draws them (the same generator calls, in the same order)."""
    S = symbols
    rng = np.random.default_rng(seed)
    px = 20.0 + rng.random(S).astype(np.float32) * 100

    def make_updates(ts_s, px):
        rows = np.arange(S, dtype=np.int32)
        ts = np.full(S, ts_s, dtype=np.int32)
        closes = px * (1 + rng.normal(0, 0.004, S))
        vals = np.zeros((S, NUM_FIELDS), dtype=np.float32)
        vals[:, Field.OPEN] = px
        vals[:, Field.CLOSE] = closes
        vals[:, Field.HIGH] = np.maximum(px, closes) * 1.002
        vals[:, Field.LOW] = np.minimum(px, closes) * 0.998
        vals[:, Field.VOLUME] = np.abs(rng.normal(1000, 150, S))
        vals[:, Field.QUOTE_VOLUME] = vals[:, Field.VOLUME] * closes
        vals[:, Field.NUM_TRADES] = 150
        vals[:, Field.DURATION_S] = 900
        return rows, ts, vals, closes

    times = T0 + BAR_S * np.arange(window, dtype=np.int32)
    bars = np.empty((window, S, NUM_FIELDS), dtype=np.float32)
    for b in range(window):
        _, _, bars[b], px = make_updates(int(times[b]), px)
    now = T0 + window * BAR_S
    rows, ts, vals, _ = make_updates(now, px)
    return Market(times, bars, now, (rows, ts, vals))


def fill_rings(market: Market, device: torch.device | str) -> EngineState:
    """The engine state with both rings holding the market's W bars, in
    one write each: the canonical ring (cursor 0, every row full) that W
    ``apply_updates`` calls from an empty ring leave."""
    W, S, _ = market.vals.shape
    state = initial_engine_state(S, W, device=device)
    times = torch.from_numpy(np.broadcast_to(market.times, (S, W)).copy()).to(device)
    values = torch.from_numpy(market.vals.transpose(1, 0, 2).copy()).to(device)
    filled = torch.full((S,), W, dtype=torch.int32, device=device)

    def ring() -> MarketBuffer:
        return MarketBuffer(times.clone(), values.clone(), filled.clone(),
                            torch.zeros_like(filled))

    return state._replace(buf5=ring(), buf15=ring())


def host_inputs(market: Market) -> HostInputs:
    """The tick's host inputs as numpy values (every row tracked, BTC at row
    0, the live bar's bucket on both intervals)."""
    S = market.upd[0].shape[0]
    base = default_host_inputs(S, device="cpu")._replace(
        tracked=torch.ones(S, dtype=torch.bool),
        btc_row=torch.tensor(0, dtype=torch.int32),
        timestamp_s=torch.tensor(market.now, dtype=torch.int32),
        timestamp5_s=torch.tensor(market.now, dtype=torch.int32),
    )
    return HostInputs(*(leaf.numpy() for leaf in base))


def to_device(host: Any, device: torch.device | str) -> Any:
    """A tuple (or NamedTuple) of numpy leaves as tensors on ``device``."""
    leaves = [torch.as_tensor(x).to(device) for x in host]
    return type(host)(*leaves) if hasattr(host, "_fields") else tuple(leaves)


# -- timing ----------------------------------------------------------------------


def _qtail_counts(device: torch.device) -> dict[str, int]:
    from binquant_tpu_torch.ops import quantile_tail as qt

    counts = qt.launches_by_site if device.type == "cuda" else qt.twin_calls_by_site
    return dict(counts)


class Profiler:
    """Times stages on ``device`` (:meth:`stage`), then counts each stage's
    device operations over one more call under ``torch.profiler``
    (:meth:`count_operations`)."""

    def __init__(self, device: torch.device, iters: int, warmup: int, out) -> None:
        self.device, self.iters, self.warmup, self.out = device, iters, warmup, out
        self.cuda = device.type == "cuda"
        self.rows: list[dict] = []
        self._fns: dict[str, Callable[[], Any]] = {}

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize(self.device)

    def stage(self, name: str, fn: Callable[[], Any]) -> None:
        for _ in range(self.warmup):
            fn()
            self.sync()
        wall, issue, dev = [], [], []
        for _ in range(self.iters):
            if self.cuda:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
            t0 = time.perf_counter()
            fn()
            t1 = time.perf_counter()
            if self.cuda:
                end.record()
            self.sync()
            wall.append((time.perf_counter() - t0) * 1000.0)
            issue.append((t1 - t0) * 1000.0)
            if self.cuda:
                dev.append(start.elapsed_time(end))
        row = {
            "name": name,
            "p50_ms": float(np.median(wall)),
            "max_ms": float(np.max(wall)),
            "device_ms": float(np.median(dev)) if dev else None,
            "host_issue_ms": float(np.median(issue)),
            "busy_ms": None,
            "device_ops": None,
            "qtail": None,
        }
        self.rows.append(row)
        self._fns[name] = fn
        dev_s = "-" if row["device_ms"] is None else f"{row['device_ms']:9.3f}"
        print(f"{name:38s} p50={row['p50_ms']:9.3f} ms  max={row['max_ms']:9.3f} ms  "
              f"dev={dev_s} ms  issue={row['host_issue_ms']:9.3f} ms",
              file=self.out, flush=True)

    def count_operations(self) -> None:
        """One more call of every stage: its qtail launches by site and, on
        the card, the device operations it issued and their busy ms (the
        union of their intervals); printed a line a stage. The calls run in
        one profiler session of the card's activities (:meth:`_spans`)."""
        qtail = []
        spans = self._spans(qtail) if self.cuda else None
        if not self.cuda:
            for row in self.rows:
                before = _qtail_counts(self.device)
                self._fns[row["name"]]()
                qtail.append((before, _qtail_counts(self.device)))
        for i, row in enumerate(self.rows):
            before, after = qtail[i]
            if row["name"] in QTAIL_STAGES:
                row["qtail"] = {k: v - before.get(k, 0) for k, v in after.items()
                                if v - before.get(k, 0)}
            if spans is None:
                continue
            if spans[i] is not None:
                busy, end_ns = 0, -1
                for start, end in spans[i]:
                    busy += max(0, end - max(start, end_ns))
                    end_ns = max(end_ns, end)
                row["device_ops"], row["busy_ms"] = len(spans[i]), busy / 1e6
            busy = "-" if row["busy_ms"] is None else f"{row['busy_ms']:9.3f}"
            ops = "not measured" if row["device_ops"] is None else row["device_ops"]
            print(f"{row['name']:38s} busy={busy} ms  ops={ops}"
                  + (f"  qtail={row['qtail']}" if row["qtail"] else ""),
                  file=self.out, flush=True)

    def _spans(self, qtail: list) -> list:
        """Each stage's device activities (start, end ns) over one call, in
        one profiler session; ``qtail`` gets each call's launch counts
        before and after. A spin kernel marks both ends of every call, so
        the session's activities split into the calls' by the marks, read
        from the profiler's raw events (no event tree is built, which would
        cost more than the calls at the tick's ~50,000). Idle margins at the
        session's ends keep the first and last calls clear of its edges. A
        call whose marks did not both arrive is not measured (None)."""
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            self.sync()
            time.sleep(EDGE_S)
            for row in self.rows:
                before = _qtail_counts(self.device)
                torch.cuda._sleep(MARK_CYCLES)
                self._fns[row["name"]]()
                torch.cuda._sleep(MARK_CYCLES)
                self.sync()
                qtail.append((before, _qtail_counts(self.device)))
            time.sleep(EDGE_S)
        cuda = torch.autograd.DeviceType.CUDA
        events = sorted(
            (e.start_ns(), e.start_ns() + e.duration_ns(), MARK_KERNEL in e.name())
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == cuda and not e.is_user_annotation()
        )
        marks = [i for i, e in enumerate(events) if e[2]]
        if len(marks) != 2 * len(self.rows):
            print(f"device operations not measured: the profiler delivered {len(marks)} of "
                  f"{2 * len(self.rows)} marks among {len(events)} activities",
                  file=self.out, flush=True)
            return [None] * len(self.rows)
        return [[e[:2] for e in events[marks[2 * k] + 1: marks[2 * k + 1]]]
                for k in range(len(self.rows))]

    def trace(self, path: str | Path, fn: Callable[[], Any], calls: int = 3) -> None:
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.cuda:
            activities.append(ProfilerActivity.CUDA)
        with profile(activities=activities) as prof:
            for _ in range(calls):
                fn()
                self.sync()
        Path(path).mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(Path(path) / "tick_step.trace.json"))


# -- the stages ------------------------------------------------------------------


def run(symbols: int = 2048, window: int = 400, device: str | torch.device = "cuda",
        iters: int | None = None, warmup: int | None = None, trace: str | None = None,
        out=None) -> dict:
    """Time every stage of :data:`STAGES`, in order, on ``device`` (the
    card unless ``"cpu"``), ``iters`` timed calls after ``warmup`` ones
    (:data:`ITERS` and :data:`WARMUP` by default), printing to ``out``
    (standard error by default); returns the rows and the totals."""
    out = sys.stderr if out is None else out
    from binquant_tpu_torch.engine.buffer import apply_updates
    from binquant_tpu_torch.engine.step import init_indicator_carry, tick_step
    from binquant_tpu_torch.ops.indicators import log_returns, rolling_beta_corr
    from binquant_tpu_torch.regime.context import ContextConfig, compute_market_context
    from binquant_tpu_torch.regime.routing import allows_long_autotrade_mask
    from binquant_tpu_torch.strategies.activity_burst_pump import activity_burst_pump
    from binquant_tpu_torch.strategies.dormant import (
        bb_extreme_reversion,
        buy_low_sell_high,
        buy_the_dip,
        inverse_price_tracker,
        range_bb_rsi_mean_reversion,
        range_failed_breakout_fade,
        relative_strength_reversal_range,
        supertrend_swing_reversal,
        twap_momentum_sniper,
    )
    from binquant_tpu_torch.strategies.features import (
        compute_feature_pack,
        compute_feature_pack_incremental,
        init_feature_carry,
    )
    from binquant_tpu_torch.strategies.ladder_deployer import ladder_deployer
    from binquant_tpu_torch.strategies.liquidation_sweep_pump import liquidation_sweep_pump
    from binquant_tpu_torch.strategies.mean_reversion_fade import mean_reversion_fade
    from binquant_tpu_torch.strategies.price_tracker import price_tracker
    from binquant_tpu_torch.strategies.spike_hunter import detect_spikes

    dev = resolve_device(device)
    S, W = symbols, window
    print(f"device={dev.type} S={S} W={W}", file=out)
    cfg = ContextConfig()
    market = make_market(S, W)
    state = fill_rings(market, dev)
    upd_host = market.upd
    inputs_host = host_inputs(market)
    upd_dev = to_device(upd_host, dev)
    inputs_dev = to_device(inputs_host, dev)
    p = Profiler(dev, ITERS if iters is None else iters,
                 WARMUP if warmup is None else warmup, out)

    # --- transfer / round-trip costs
    tiny_in = torch.zeros(1, dtype=torch.float32, device=dev)
    p.stage(STAGES[0], lambda: (tiny_in + 1).cpu())
    p.stage(STAGES[1], lambda: to_device(upd_host, dev))
    p.stage(STAGES[2], lambda: to_device(inputs_host, dev))

    # --- compute stages (inputs already on the device)
    p.stage(STAGES[3], lambda: apply_updates(state.buf5, *upd_dev))
    p.stage(STAGES[4], lambda: compute_feature_pack(state.buf15))
    carry15 = init_feature_carry(state.buf15)
    p.stage(STAGES[5], lambda: compute_feature_pack_incremental(state.buf15, carry15))
    p.stage(STAGES[6], lambda: detect_spikes(state.buf15))
    fresh = torch.ones(S, dtype=torch.bool, device=dev)

    def ctx_fn():
        return compute_market_context(
            state.buf15, fresh, inputs_dev.tracked, inputs_dev.btc_row,
            inputs_dev.timestamp_s, state.regime_carry, cfg,
        )

    p.stage(STAGES[7], ctx_fn)

    def beta_fn():
        rets = log_returns(state.buf15.values[:, :, Field.CLOSE])
        return rolling_beta_corr(rets, rets[0][None, :], window=50)

    p.stage(STAGES[8], beta_fn)

    # --- the strategies, each over prebuilt packs, context and scalars
    pack5 = compute_feature_pack(state.buf5)
    pack15 = compute_feature_pack(state.buf15)
    ctx, _ = ctx_fn()
    spikes = detect_spikes(state.buf15)
    nanv = torch.full((S,), float("nan"), dtype=torch.float32, device=dev)
    nan = torch.tensor(float("nan"), dtype=torch.float32, device=dev)
    no, yes = (torch.tensor(v, device=dev) for v in (False, True))
    long_gate = allows_long_autotrade_mask(ctx)
    buf5, buf15 = state.buf5, state.buf15
    mrf_last, pt_last = state.mrf_last_emitted, state.pt_last_signal_close
    strategies = (
        lambda: activity_burst_pump(buf5, ctx),
        lambda: price_tracker(pack5, ctx, no, pt_last),
        lambda: liquidation_sweep_pump(buf15, ctx, nanv, nan, nan, nan),
        lambda: mean_reversion_fade(pack15, yes, mrf_last),
        lambda: ladder_deployer(pack15, ctx, no, yes),
        lambda: supertrend_swing_reversal(buf5, pack5, ctx, long_gate, nan, nan, no),
        lambda: twap_momentum_sniper(buf15, pack5),
        lambda: buy_low_sell_high(buf15, pack15, no),
        lambda: buy_the_dip(buf15, pack15, ctx, no),
        lambda: bb_extreme_reversion(buf15, pack15, ctx),
        lambda: inverse_price_tracker(pack5, ctx),
        lambda: range_bb_rsi_mean_reversion(buf15, pack15, ctx),
        lambda: range_failed_breakout_fade(spikes, ctx),
        lambda: relative_strength_reversal_range(buf15, pack15, ctx),
    )
    for name, fn in zip(STAGES[9:23], strategies, strict=True):
        p.stage(name, fn)

    # --- end to end: the full recompute against the incremental tick
    def full_dev():
        return tick_step(state, upd_dev, upd_dev, inputs_dev, cfg)[1].summary.trigger

    p.stage(FULL_STEP, full_dev)
    state_sync = state._replace(
        indicator_carry=init_indicator_carry(state.buf5, state.buf15, inputs_dev.btc_row)
    )

    def incr_dev():
        return tick_step(
            state_sync, upd_dev, upd_dev, inputs_dev, cfg, incremental=True
        )[1].summary.trigger

    p.stage(INCR_STEP, incr_dev)

    def full_host():
        upd = to_device(upd_host, dev)
        inputs = to_device(inputs_host, dev)
        return tick_step(state, upd, upd, inputs, cfg)[1].summary.trigger.cpu()

    p.stage(STAGES[-1], full_host)
    p.count_operations()
    if trace:
        p.trace(trace, full_dev)
        print(f"trace written to {trace}", file=out)
    return {"device": dev.type, "symbols": S, "window": W, "rows": p.rows,
            "totals": report_totals(p.rows, out)}


def report_totals(rows: list[dict], out) -> dict:
    """The reference's "sum of compute stages" and "full vs incremental
    step" lines, the share of the full tick's device operations the
    compute stages account for, and the reference's counter line."""
    from binquant_tpu_torch.obs.instruments import FULL_RECOMPUTE, TICKS

    compute = [r for r in rows if not r["name"].startswith(("rtt", "h2d", "tick_step"))]
    total_compute = sum(r["p50_ms"] for r in compute)
    print(f"{'sum of compute stages':38s} p50={total_compute:9.3f} ms", file=out)
    by_name = {r["name"]: r for r in rows}
    full, incr = by_name.get(FULL_STEP), by_name.get(INCR_STEP)
    totals: dict = {"sum_of_compute_stages_ms": total_compute}
    if full and incr:
        ratio = full["p50_ms"] / max(incr["p50_ms"], 1e-9)
        print(f"{'full vs incremental step':38s} {full['p50_ms']:9.3f} ms vs "
              f"{incr['p50_ms']:9.3f} ms ({ratio:.2f}x)", file=out)
        totals["full_vs_incremental"] = ratio
    ops = [r["device_ops"] for r in compute]
    if full and full["device_ops"] and None not in ops:
        share = sum(ops) / full["device_ops"]
        print(f"{'compute stages / full tick ops':38s} {sum(ops)} of "
              f"{full['device_ops']} ({share:.3f})", file=out)
        totals["stage_ops"], totals["full_tick_ops"] = sum(ops), full["device_ops"]
        totals["stage_ops_share"] = share
    recompute = {labels: child.value for labels, child in FULL_RECOMPUTE.children()}
    print(f"bqt_full_recompute_total={recompute or 0} bqt_ticks_total={TICKS.value}",
          file=out)
    return totals


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--symbols", type=int, default=2048)
    parser.add_argument("--window", type=int, default=400)
    parser.add_argument("--trace", type=str, default=None)
    parser.add_argument("--json", type=str, default=None, help="write the rows as JSON")
    parser.add_argument("--device", default="cuda",
                        help="cuda (the default; fails without a card) or cpu")
    args = parser.parse_args(argv)
    result = run(args.symbols, args.window, args.device, trace=args.trace)
    if args.json:
        Path(args.json).write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
