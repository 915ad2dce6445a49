"""Composable adversarial-scenario generator.

The port's own copy of the reference's scenario engine
(``binquant_tpu/sim/scenarios.py``): the same twelve families, the same
bar shapes and stream faults, so every scenario's kline stream comes out
byte for byte as the reference's.

Every scenario is a GARCH base stream (``io/market_sim.py``'s stylized
facts at 15m granularity: Student-t innovations, GARCH(1,1) market factor
plus per-symbol idiosyncratic variance, betas, |r|-coupled volume) with
two layers of composable events on top:

* **array events** edit the (T, S) close/volume paths — flash crashes,
  liquidation cascades, depegs, regime flips — and **bar shapes** craft a
  specific (tick, symbol) bar's OHLC/sub-bars (green hammers, activity
  bursts);
* **stream events** rewrite the emitted kline stream itself — rewrite
  storms re-delivering corrected old candles, exchange-outage gaps whose
  bars all arrive in one catch-up drain, listing/delisting churn waves —
  through the ``_deliver_bucket`` transport key ``load_klines_by_tick``
  honors.

The output is the dual-interval (5m + 15m) kline JSONL every replay lane
consumes; ``sim/runner.py`` drives each scenario scanned AND serial
through the full engine and checks the graceful-degradation invariants.
"""

from __future__ import annotations

import json
import math
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable

import numpy as np

from binquant_tpu_torch.io.market_sim import _garch_path
from binquant_tpu_torch.io.replay import kline_record

FIVE_MIN_S = 300
FIFTEEN_MIN_S = 900
# 15m-aligned epoch shared with the crafted fixtures (replay.py)
T0 = 1_780_272_000
assert T0 % FIFTEEN_MIN_S == 0


@dataclass(frozen=True)
class ScenarioSpec:
    """One corpus entry: the market shape, the engine shape it is driven
    at, and the graceful-degradation script the runner asserts."""

    name: str
    description: str
    n_symbols: int = 16
    n_ticks: int = 112  # 15m ticks; events sit past MIN_BARS(=100)
    seed: int = 29
    capacity: int = 32
    window: int = 120
    scan_chunk: int = 32
    # scripted market-breadth series (None = breadth-gated paths dormant)
    breadth: dict | None = None
    # The dispatch set the scenario drives with. Default: the live set
    # MINUS coinrule_price_tracker. The corpus pins EXACT signal-set
    # equality across three differently-compiled drives, and PT's
    # oversold gates (RSI<30 ∧ MACD<0 ∧ MFI<20) on an adversarial
    # oversold-rich stream cross their thresholds INSIDE the drives'
    # f32 accumulation-order spread (measured: carry leaves diverge
    # serial-vs-scanned by ~1e-2 abs after 40 folded ticks, flipping
    # PT ~10x/run) — a rounding lottery, not a semantic signal. PT is
    # carry-owning, so its dedupe/cooldown carries still advance
    # identically; every other strategy sees identical state.
    enabled_strategies: tuple[str, ...] = (
        "activity_burst_pump",
        "grid_ladder",
        "liquidation_sweep_pump",
        "mean_reversion_fade",
    )
    # full-recompute routing reasons that must appear — EXACTLY this set
    # (both drives; the scanned drive's chunk breaks must route the same)
    expect_routing: tuple[str, ...] = ("cold_start",)
    # per-reason minimum counts on top of the set equality
    routing_min: tuple[tuple[str, int], ...] = ()
    # >WIRE_MAX_FIRED compaction overflow expected (and asserted absent
    # when False)
    expect_overflow: bool = False
    min_signals: int = 0
    min_telegram: int = 0  # regime-notifier digests (btc_regime_flip)
    # drive with the ingest-health observatory pinned ON (digest riding
    # every backend's wire + the host monitor) — per-tick digest
    # equality across the three drives becomes one more invariant
    ingest: bool = False
    # staleness SLO script: the bqt_ingest stale alarm must TRIP during
    # the scripted fault and CLEAR after catch-up (requires ingest=True)
    expect_ingest_anomaly: bool = False
    # heavy shapes excluded from the tier-1 drill (make scenarios runs all)
    slow: bool = False


@dataclass(frozen=True)
class Scenario:
    spec: ScenarioSpec
    build: Callable[[ScenarioSpec], list[dict]] = field(repr=False)


SCENARIOS: dict[str, Scenario] = {}


def _scenario(spec: ScenarioSpec):
    def wrap(fn):
        SCENARIOS[spec.name] = Scenario(spec=spec, build=fn)
        return fn

    return wrap


def symbol_names(n_symbols: int) -> list[str]:
    return ["BTCUSDT"] + [f"S{i:03d}USDT" for i in range(1, n_symbols)]


# -- the GARCH base stream ---------------------------------------------------


def base_market(
    spec: ScenarioSpec,
    drift_per_tick: float | np.ndarray = 0.0,
    factor_vol: float = 0.002,
) -> tuple[np.ndarray, np.ndarray, np.random.Generator]:
    """(T, S) 15m close + volume paths with market_sim's stylized facts at
    scenario scale. ``drift_per_tick`` (scalar or (T, S)) shapes regimes;
    events then edit the returned arrays in place."""
    rng = np.random.default_rng(spec.seed)
    T, S = spec.n_ticks, spec.n_symbols
    t_df = 4.0
    scale = math.sqrt(t_df / (t_df - 2.0))
    innov_m = rng.standard_t(t_df, size=T) / scale
    innov_i = rng.standard_t(t_df, size=(T, S)) / scale
    r_m = _garch_path(innov_m[:, None], factor_vol, 0.12, 0.85)[:, 0]
    betas = rng.uniform(0.5, 1.6, size=S)
    betas[0] = 1.0  # BTC IS the factor
    idio_vol = rng.uniform(0.001, 0.004, size=S)
    idio_vol[0] = factor_vol * 0.15
    r_i = _garch_path(innov_i, 1.0, 0.12, 0.85)
    r = betas[None, :] * r_m[:, None] + r_i * idio_vol[None, :] + drift_per_tick
    p0 = np.exp(rng.uniform(np.log(0.5), np.log(300.0), size=S))
    p0[0] = 65_000.0
    closes = p0[None, :] * np.cumprod(1.0 + r, axis=0)
    base_v = rng.uniform(np.log(300.0), np.log(3000.0), size=S)
    zscore = np.abs(r) / (betas[None, :] * factor_vol + idio_vol[None, :])
    vols = np.exp(
        base_v[None, :]
        + 0.3 * np.minimum(zscore, 6.0)
        + 0.3 * rng.standard_normal((T, S))
    )
    return closes, vols, rng


# -- bar shapes (the crafted-fixture recipes, reusable per (tick, sym)) ------


def green_hammer(o, c, vol15):
    """MeanReversionFade's prey: deep gap down below the shifted lower
    band, green close, 3x volume (replay.py's single- and market-wide
    hammer recipe)."""
    o2 = o * 0.955
    c2 = o2 * 1.003
    return o2, c2 * 1.001, o2 * 0.997, c2, vol15 * 3.0, None


def tight_bar(o, c, vol15):
    """A bar with ±0.2% wicks — the steady-bleed shape whose stable true
    range keeps MeanReversionFade's ATR-spike veto (atr < 2·atr_ma)
    open for the hammer that follows."""
    return o, max(o, c) * 1.002, min(o, c) * 0.998, c, vol15, None


def activity_burst(o, c, vol15):
    """ActivityBurstPump's prey on the 5m stream: two +0.3% run-up
    sub-bars then a +3% green sub-bar at the highs on 8x volume."""
    subs = []
    sub_o = o
    for j in range(3):
        if j < 2:
            sub_c = sub_o * 1.003
            sh, sl, sv = sub_c * 1.001, sub_o * 0.999, vol15 / 3
        else:
            sub_c = sub_o * 1.03
            sh, sl, sv = sub_c * 1.002, sub_o * 0.998, vol15 / 3 * 8
        subs.append((sub_o, sh, sl, sub_c, sv))
        sub_o = sub_c
    c2 = subs[-1][3]
    high = max(s[1] for s in subs)
    low = min(s[2] for s in subs)
    return o, high, low, c2, vol15 * 2.0, subs


# -- emission: (T, S) paths -> the dual-interval kline stream ----------------


def _interp_sub_bars(o, c, vol15):
    subs = []
    sub_o = o
    for j in range(3):
        sub_c = o + (c - o) * (j + 1) / 3
        sh, sl = max(sub_o, sub_c) * 1.0005, min(sub_o, sub_c) * 0.9995
        subs.append((sub_o, sh, sl, sub_c, vol15 / 3))
        sub_o = sub_c
    return subs


def emit_stream(
    spec: ScenarioSpec,
    closes: np.ndarray,
    vols: np.ndarray,
    shapes: dict | None = None,
) -> list[dict]:
    """The (T, S) paths → a flat ExtendedKline dict stream: one 15m bar +
    three 5m sub-bars per (tick, symbol), the same dual-interval contract
    every crafted fixture uses. ``shapes`` maps (tick, sym) to a bar-shape
    callable ``(open, close, vol15) -> (o, h, l, c, vol15, sub_bars)``;
    its returned close is written back into the path so the next bar's
    open follows the crafted bar."""
    closes = np.array(closes, dtype=float)  # copy: shapes write back
    names = symbol_names(spec.n_symbols)
    shapes = shapes or {}
    out: list[dict] = []
    for t in range(spec.n_ticks):
        ts15 = T0 + t * FIFTEEN_MIN_S
        for s in range(spec.n_symbols):
            c = float(closes[t, s])
            o = float(closes[t - 1, s]) if t else c
            vol15 = float(vols[t, s])
            move = abs(c / o - 1.0) if o else 0.0
            h = max(o, c) * (1.0 + 0.3 * move + 0.0005)
            low = min(o, c) * (1.0 - 0.3 * move - 0.0005)
            sub_bars = None
            shape = shapes.get((t, s))
            if shape is not None:
                o, h, low, c, vol15, sub_bars = shape(o, c, vol15)
                closes[t, s] = c
            out.append(
                kline_record(names[s], ts15, FIFTEEN_MIN_S, o, h, low, c, vol15)
            )
            if sub_bars is None:
                sub_bars = _interp_sub_bars(o, c, vol15)
            for j, (so, sh, sl, sc, sv) in enumerate(sub_bars):
                out.append(
                    kline_record(
                        names[s], ts15 + j * FIVE_MIN_S, FIVE_MIN_S,
                        so, sh, sl, sc, sv,
                    )
                )
    return out


# -- stream events (delivery-scripted faults) --------------------------------


def _bucket0() -> int:
    return T0 // FIFTEEN_MIN_S


def _tick_of(k: dict) -> int:
    return int(k["open_time"]) // 1000 // FIFTEEN_MIN_S - _bucket0()


def rewrite_storm(
    klines: list[dict],
    ticks,
    lag: int = 3,
    per_tick: int = 2,
    shift: float = 0.004,
) -> None:
    """Correction storm: during each storm tick, re-deliver ``per_tick``
    already-applied 15m candles from ``lag`` ticks earlier with shifted
    closes. ``_deliver_bucket`` routes them to the storm tick, so the
    host latest-ts mirror sees a non-append and must route the tick to
    the full recompute (reason ``rewrite``) — in BOTH drives."""
    by_key = {
        (k["symbol"], k["open_time"]): k
        for k in klines
        if (k["close_time"] - k["open_time"]) // 1000 >= FIFTEEN_MIN_S - 1
    }
    syms = sorted({k["symbol"] for k in klines})
    extra = []
    for i, t in enumerate(ticks):
        src_ts = (_bucket0() + t - lag) * FIFTEEN_MIN_S * 1000
        for j in range(per_tick):
            sym = syms[(i * per_tick + j) % len(syms)]
            src = by_key.get((sym, src_ts))
            if src is None:
                continue
            corrected = dict(src)
            corrected["close"] = round(src["close"] * (1.0 + shift), 6)
            corrected["high"] = max(corrected["high"], corrected["close"])
            corrected["_deliver_bucket"] = _bucket0() + t
            extra.append(corrected)
    klines.extend(extra)


def outage(klines: list[dict], gap_ticks: range, recover_tick: int) -> None:
    """Exchange outage: every candle whose bucket falls in ``gap_ticks``
    is delivered in ONE catch-up drain at ``recover_tick``. The engine
    never ticks during the gap (no fresh candles), then folds a
    multi-bucket backlog of clean appends carry-forward — the deep
    ordered-sub-batch drain both the serial fold and the scan plan's
    slot depth must absorb."""
    gap = set(gap_ticks)
    for k in klines:
        if _tick_of(k) in gap:
            k["_deliver_bucket"] = _bucket0() + recover_tick


def listing_churn(
    klines: list[dict],
    listings: dict[int, int],
    delistings: dict[int, int],
    n_symbols: int,
) -> None:
    """Listing/delisting waves: a listed symbol's candles only exist from
    its listing tick (its first drain claims a registry row mid-stream —
    the churn full-recompute route); a delisted symbol goes quiet (its
    row stays, the freshness gate sidelines it)."""
    names = symbol_names(n_symbols)
    keep = []
    for k in klines:
        idx = names.index(k["symbol"])
        t = _tick_of(k)
        if idx in listings and t < listings[idx]:
            continue
        if idx in delistings and t >= delistings[idx]:
            continue
        keep.append(k)
    klines[:] = keep


# -- the corpus ---------------------------------------------------------------


def _bleed_then_hammer(
    closes, vols, shapes, syms, bleed_from, hammer_tick, rate=0.004
):
    """Per-symbol MeanReversionFade setup — the recipe the crafted
    fixtures established: OVERWRITE the symbol's path with a steady
    -0.4%/tick tight-wick bleed (all-red bars pin Wilder RSI(14) low
    while the stable true range keeps the ATR-spike veto open; crafted
    symbols deliberately bypass the scenario's market-wide shock, whose
    ATR spike would veto the reclaim) and steady volume (the hammer's 3x
    must clear the 20-bar volume floor), then the green-hammer bar."""
    for s in syms:
        base = closes[bleed_from - 1, s]
        for k, t in enumerate(range(bleed_from, hammer_tick)):
            closes[t, s] = base * (1.0 - rate) ** (k + 1)
            shapes[(t, s)] = tight_bar
        closes[hammer_tick:, s] = closes[hammer_tick - 1, s]
        vols[bleed_from : hammer_tick + 1, s] = 1000.0
        shapes[(hammer_tick, s)] = green_hammer


@_scenario(
    ScenarioSpec(
        name="flash_crash",
        description="market-wide -7% bar on 8x volume with partial "
        "rebound; four bleeding symbols print capitulation hammers",
        min_signals=1,
    )
)
def _flash_crash(spec: ScenarioSpec) -> list[dict]:
    closes, vols, _rng = base_market(spec)
    crash = spec.n_ticks - 6
    hammer = spec.n_ticks - 1
    closes[crash:] *= 0.93
    closes[crash + 1 :] *= 1.018
    closes[crash + 2 :] *= 1.012
    vols[crash] *= 8.0
    vols[crash + 1] *= 4.0
    shapes: dict = {}
    _bleed_then_hammer(closes, vols, shapes, (2, 5, 9, 12), hammer - 26, hammer)
    return emit_stream(spec, closes, vols, shapes)


@_scenario(
    ScenarioSpec(
        name="liquidation_cascade",
        description="multi-bar market-wide cascade (market_sim's shape) "
        "with volume blowout and partial rebound, then reclaim hammers",
        min_signals=1,
    )
)
def _liquidation_cascade(spec: ScenarioSpec) -> list[dict]:
    closes, vols, _rng = base_market(spec)
    start = spec.n_ticks - 9
    cascade = (-0.022, -0.034, -0.016, 0.013, 0.006)
    for i, dr in enumerate(cascade):
        closes[start + i :] *= 1.0 + dr
    vols[start : start + 5] *= np.array([7.0, 12.0, 8.0, 5.0, 3.0])[:, None]
    shapes: dict = {}
    _bleed_then_hammer(
        closes, vols, shapes, (4, 11), spec.n_ticks - 27, spec.n_ticks - 1
    )
    return emit_stream(spec, closes, vols, shapes)


@_scenario(
    ScenarioSpec(
        name="stablecoin_depeg",
        description="one $1-pinned symbol breaks peg hard (-9% over two "
        "bars on 12x volume, partial re-peg) while a second bleeds off "
        "its peg in a slow staircase ending in the capitulation hammer",
        min_signals=1,
    )
)
def _stablecoin_depeg(spec: ScenarioSpec) -> list[dict]:
    closes, vols, rng = base_market(spec)
    # S003: the hard depeg (ATR spike — MRF's veto must HOLD here)
    s = 3
    closes[:, s] = 1.0 + rng.normal(0.0, 0.0002, spec.n_ticks)
    depeg = spec.n_ticks - 7
    closes[depeg:, s] *= 0.95
    closes[depeg + 1 :, s] *= 0.96
    closes[depeg + 3 :, s] *= 1.05  # partial re-peg
    vols[depeg : depeg + 4, s] *= 12.0
    # S007: the slow staircase depeg ending in the reclaim hammer
    s2 = 7
    closes[:, s2] = 1.0 + rng.normal(0.0, 0.0002, spec.n_ticks)
    shapes: dict = {}
    _bleed_then_hammer(
        closes, vols, shapes, (s2,), spec.n_ticks - 27, spec.n_ticks - 1
    )
    return emit_stream(spec, closes, vols, shapes)


@_scenario(
    ScenarioSpec(
        name="btc_regime_flip",
        description="market-wide trend-up drift flips to trend-down at a "
        "15m bucket boundary — the regime ladder must transition (and "
        "the notifier digest it)",
        min_telegram=1,
    )
)
def _btc_regime_flip(spec: ScenarioSpec) -> list[dict]:
    flip = spec.n_ticks - 10
    drift = np.full((spec.n_ticks, spec.n_symbols), 0.0025)
    drift[flip:] = -0.004
    closes, vols, _rng = base_market(spec, drift_per_tick=drift)
    vols[flip : flip + 3] *= 3.0
    return emit_stream(spec, closes, vols)


@_scenario(
    ScenarioSpec(
        name="rewrite_storm",
        description="two correction-storm pulses (4 + 3 ticks) each "
        "re-deliver corrected copies of already-applied 15m candles — "
        "every storm tick must route to the full recompute "
        "(reason=rewrite) in both drives; the inter-pulse gap leaves a "
        "mid-phase ring cursor for the restore-under-fault drill",
        expect_routing=("cold_start", "rewrite"),
        routing_min=(("rewrite", 6),),
        min_signals=2,
    )
)
def _rewrite_storm(spec: ScenarioSpec) -> list[dict]:
    closes, vols, _rng = base_market(spec)
    shapes: dict = {}
    # one hammer early in the storm and one at the end: the restore-
    # under-fault drill splits mid-storm and needs signals on both sides
    # (both hammers sit past MIN_BARS=100 bars, where strategies arm)
    _bleed_then_hammer(
        closes, vols, shapes, (8,), spec.n_ticks - 36, spec.n_ticks - 10
    )
    _bleed_then_hammer(
        closes, vols, shapes, (6,), spec.n_ticks - 27, spec.n_ticks - 1
    )
    klines = emit_stream(spec, closes, vols, shapes)
    rewrite_storm(
        klines,
        list(range(spec.n_ticks - 12, spec.n_ticks - 8))
        + list(range(spec.n_ticks - 6, spec.n_ticks - 3)),
    )
    return klines


@_scenario(
    ScenarioSpec(
        name="listing_churn",
        description="two listing waves claim registry rows mid-stream "
        "(full-recompute reason=churn re-anchors every carry) and one "
        "symbol delists (goes quiet; freshness sidelines its row)",
        expect_routing=("cold_start", "churn"),
        routing_min=(("churn", 2),),
        min_signals=1,
    )
)
def _listing_churn(spec: ScenarioSpec) -> list[dict]:
    closes, vols, _rng = base_market(spec)
    shapes: dict = {}
    _bleed_then_hammer(
        closes, vols, shapes, (5,), spec.n_ticks - 27, spec.n_ticks - 1
    )
    klines = emit_stream(spec, closes, vols, shapes)
    listing_churn(
        klines,
        listings={10: 30, 11: 30, 12: 45, 13: 45},
        delistings={14: 80},
        n_symbols=spec.n_symbols,
    )
    return klines


@_scenario(
    ScenarioSpec(
        name="cold_start_gap",
        description="six-bucket exchange outage delivered as ONE catch-up "
        "drain: the engine never ticks through the gap, then folds the "
        "multi-bucket backlog carry-forward (clean appends — no "
        "full-recompute reroute)",
        min_signals=1,
    )
)
def _cold_start_gap(spec: ScenarioSpec) -> list[dict]:
    closes, vols, _rng = base_market(spec)
    shapes: dict = {}
    _bleed_then_hammer(
        closes, vols, shapes, (7,), spec.n_ticks - 27, spec.n_ticks - 1
    )
    klines = emit_stream(spec, closes, vols, shapes)
    outage(
        klines,
        gap_ticks=range(spec.n_ticks - 32, spec.n_ticks - 26),
        recover_tick=spec.n_ticks - 26,
    )
    return klines


@_scenario(
    ScenarioSpec(
        name="pump_frenzy",
        description="idiosyncratic pumps: a 5m activity burst (ABP's "
        "prey) plus a +3% 8x-volume 15m pump with BTC momentum up and "
        "rising scripted breadth (LSP's routing engaged)",
        breadth={
            "timestamp": [1, 2, 3, 4],
            "market_breadth": [0.30, 0.34, 0.38, 0.42],
            "market_breadth_ma": [0.30, 0.36],
        },
        min_signals=1,
    )
)
def _pump_frenzy(spec: ScenarioSpec) -> list[dict]:
    closes, vols, _rng = base_market(spec)
    last = spec.n_ticks - 1
    # BTC momentum up into the pump (LSP's long route needs it)
    closes[last, 0] = closes[last - 1, 0] * 1.005
    # S003: +3% 15m pump on 8x volume
    closes[last, 3] = closes[last - 1, 3] * 1.03
    vols[last, 3] *= 8.0
    shapes = {(last, 1): activity_burst}
    return emit_stream(spec, closes, vols, shapes)


@_scenario(
    ScenarioSpec(
        name="fire_burst",
        description=">WIRE_MAX_FIRED burst: a market-wide capitulation "
        "hammer fires MeanReversionFade on 160 symbols in one tick — the "
        "wire overflows, the scanned chunk rewinds and re-drives "
        "serially, and the emitted set stays exact",
        n_symbols=160,
        n_ticks=108,
        seed=23,
        capacity=192,
        window=200,
        expect_overflow=True,
        min_signals=129,
        slow=True,
    )
)
def _fire_burst(spec: ScenarioSpec) -> list[dict]:
    closes, vols, _rng = base_market(spec, factor_vol=0.001)
    last = spec.n_ticks - 1
    shapes: dict = {}
    # EVERY symbol runs the bleed-then-hammer recipe into the same tick:
    # 160 MeanReversionFade fires > WIRE_MAX_FIRED=128 compaction slots
    _bleed_then_hammer(
        closes, vols, shapes, range(spec.n_symbols), last - 26, last
    )
    return emit_stream(spec, closes, vols, shapes)


def btc_withhold(
    klines: list[dict], ticks, recover_tick: int
) -> None:
    """bc_dirty pressure: withhold ONLY the BTC row's
    candles during ``ticks`` and deliver them in one catch-up drain at
    ``recover_tick`` — every other symbol keeps appending, so each
    withheld 15m bucket is an ASYMMETRIC advance vs the BTC row and the
    beta/corr carry marks every advancing row dirty (engine/step.py
    ``bc_dirty``). Dirty rows decode btc_beta/corr as NaN → the analytics
    payload serializes null (the NaN-decode invariant) until a full
    recompute re-anchors them. The late BTC bars are still strictly-newer
    appends for their row, so routing stays clean (no rewrite reroute) —
    the pressure is purely on the carry's pairing, which is the point."""
    gap = set(ticks)
    for k in klines:
        if k["symbol"] == "BTCUSDT" and _tick_of(k) in gap:
            k["_deliver_bucket"] = _bucket0() + recover_tick


@_scenario(
    ScenarioSpec(
        name="bc_dirty_pressure",
        description="asymmetric BTC-row appends: BTC's candles are "
        "withheld for six mid-stream buckets (every other symbol keeps "
        "appending — the beta/corr carry marks advancing rows dirty and "
        "decodes their BTC posture as NaN/null) and arrive in one "
        "catch-up drain; a capitulation hammer fires INSIDE the dirty "
        "window so emitted analytics carry the null-not-zero invariant",
        min_signals=1,
    )
)
def _bc_dirty_pressure(spec: ScenarioSpec) -> list[dict]:
    closes, vols, _rng = base_market(spec)
    shapes: dict = {}
    # the hammer lands mid-window WHILE the carry is dirty: its emitted
    # analytics record must serialize btc_beta/btc_corr as null
    _bleed_then_hammer(
        closes, vols, shapes, (4, 9), spec.n_ticks - 31, spec.n_ticks - 5
    )
    klines = emit_stream(spec, closes, vols, shapes)
    btc_withhold(
        klines,
        ticks=range(spec.n_ticks - 9, spec.n_ticks - 3),
        recover_tick=spec.n_ticks - 3,
    )
    return klines


def feed_outage(
    klines: list[dict], symbol_idx, ticks, recover_tick: int, n_symbols: int
) -> None:
    """Per-symbol feed death: ONLY the listed symbols' candles
    are withheld during ``ticks`` and delivered in one catch-up drain at
    ``recover_tick`` — every other symbol keeps appending, so the engine
    keeps ticking while the dead rows' staleness buckets grow (the
    dominant production failure mode the ingest observatory exists for;
    contrast :func:`outage`, which silences whole buckets so no tick ever
    observes the gap). The late bars are strictly-newer appends for their
    rows, so routing stays clean and the scanned drive stays fused."""
    names = symbol_names(n_symbols)
    dead = {names[i] for i in symbol_idx}
    gap = set(ticks)
    for k in klines:
        if k["symbol"] in dead and _tick_of(k) in gap:
            k["_deliver_bucket"] = _bucket0() + recover_tick


@_scenario(
    ScenarioSpec(
        name="feed_outage",
        description="per-symbol feed death: three symbols' streams go "
        "silent for seven mid-stream buckets while the rest keep "
        "appending — the ingest staleness alarm must trip while they are "
        "dark (bqt_ingest_stale_rows + ingest_anomaly + degraded "
        "/healthz ingest section) and clear after the one-drain catch-up",
        ingest=True,
        expect_ingest_anomaly=True,
        min_signals=1,
    )
)
def _feed_outage(spec: ScenarioSpec) -> list[dict]:
    closes, vols, _rng = base_market(spec)
    shapes: dict = {}
    # the hammer symbol keeps a LIVE feed; the dead rows are elsewhere
    _bleed_then_hammer(
        closes, vols, shapes, (5,), spec.n_ticks - 27, spec.n_ticks - 1
    )
    klines = emit_stream(spec, closes, vols, shapes)
    feed_outage(
        klines,
        symbol_idx=(3, 7, 11),
        ticks=range(spec.n_ticks - 12, spec.n_ticks - 5),
        recover_tick=spec.n_ticks - 5,
        n_symbols=spec.n_symbols,
    )
    return klines


def _breadth_stall_schedule(n_ticks: int) -> dict:
    """Scripted per-bucket market-breadth stream (breadth faults):
    healthy rising readings, then NaN-holed entries (the live API nulls
    individual points), then the stream VANISHES entirely
    (empty payloads — breadth-gated routing loses its inputs mid-run),
    then a recovered rising series. One schedule entry per 15m bucket
    (StubSession consumes them per market-breadth call)."""
    healthy = {
        "timestamp": [1, 2, 3, 4],
        "market_breadth": [0.30, 0.34, 0.38, 0.42],
        "market_breadth_ma": [0.30, 0.36],
    }
    holed = {
        "timestamp": [1, 2, 3, 4],
        "market_breadth": [0.30, None, None, 0.38],
        "market_breadth_ma": [None, None],
    }
    schedule: list = []
    for t in range(n_ticks):
        if t < n_ticks - 32:
            schedule.append(healthy)
        elif t < n_ticks - 24:
            schedule.append(holed)  # NaN holes mid-series
        elif t < n_ticks - 16:
            schedule.append(None)  # stream vanished (empty payload)
        else:
            schedule.append(healthy)  # recovered
    return {"schedule": schedule}


# one tick-count constant shared by the spec AND its breadth schedule —
# the schedule's fault windows are phased against n_ticks, so the two
# must never drift apart
_BREADTH_STALL_TICKS = 112


@_scenario(
    ScenarioSpec(
        name="breadth_stall",
        description="breadth-series fault family (ROADMAP 5a): the "
        "scripted breadth stream degrades mid-run — NaN-holed entries, "
        "then an empty (vanished) series, then recovery — while pumps "
        "and a capitulation hammer fire; the breadth-gated paths must "
        "degrade gracefully and all three drives stay signal-identical",
        n_ticks=_BREADTH_STALL_TICKS,
        breadth=_breadth_stall_schedule(_BREADTH_STALL_TICKS),
        min_signals=1,
    )
)
def _breadth_stall(spec: ScenarioSpec) -> list[dict]:
    closes, vols, _rng = base_market(spec)
    shapes: dict = {}
    # one hammer INSIDE the vanished-breadth window (MRF is not
    # breadth-gated — signals must keep flowing while breadth is dark)
    # and one after recovery
    _bleed_then_hammer(
        closes, vols, shapes, (4,), spec.n_ticks - 46, spec.n_ticks - 20
    )
    _bleed_then_hammer(
        closes, vols, shapes, (9,), spec.n_ticks - 27, spec.n_ticks - 1
    )
    # BTC momentum up + a 15m pump during the healthy tail (LSP's long
    # route re-engages once breadth recovers)
    last = spec.n_ticks - 1
    closes[last, 0] = closes[last - 1, 0] * 1.005
    closes[last, 3] = closes[last - 1, 3] * 1.03
    vols[last, 3] *= 8.0
    return emit_stream(spec, closes, vols, shapes)


def write_scenario_file(scenario: Scenario | str, path: str | Path) -> int:
    """Generate one scenario's kline stream to ``path`` (JSONL, with any
    ``_deliver_bucket`` transport keys); returns the line count."""
    if isinstance(scenario, str):
        scenario = SCENARIOS[scenario]
    klines = scenario.build(scenario.spec)
    with open(path, "w") as f:
        for k in klines:
            f.write(json.dumps(k) + "\n")
    return len(klines)
