"""Offline replay harness for the port.

Feeds a JSONL file of closed klines through the engine with every sink
stubbed: one engine tick per 15m delivery bucket, ``now_ms`` just after the
bucket's bars close. Own copies of the reference's replay-file generator and
tick grouping (``binquant_tpu/io/replay.py``), so the two packages replay
identical streams (and the reference's overflow drill,
:func:`generate_burst_replay`).
"""

from __future__ import annotations

import asyncio
import gzip
import json
import os
import time
from pathlib import Path

import numpy as np

from binquant_tpu_torch.config import Config
from binquant_tpu_torch.io.emission import RecordingSinks
from binquant_tpu_torch.io.pipeline import SignalEngine
from binquant_tpu_torch.regime.context import ContextConfig


def make_stub_engine(
    capacity: int = 256,
    window: int = 200,
    breadth: dict | None = None,
    pipeline_depth: int | None = None,
    enabled_strategies: set[str] | None = None,
    context_config: ContextConfig | None = None,
    device: str | None = None,
    incremental: bool | None = None,
    carry_audit_every: int | None = None,
    donate: bool | None = None,
    numeric_digest: bool | None = None,
    ingest_digest: bool | None = None,
    drift_meter: bool | None = None,
) -> SignalEngine:
    """A SignalEngine wired to recording sinks (no network), futures market
    type, small-universe context gates unless ``context_config`` is given.
    Runs on ``device`` — CUDA by default; raises when CUDA is missing unless
    ``device="cpu"``. Every other argument left None keeps the config's
    production default: depth 1 with rings in place, both digests and the
    drift meter on, the incremental path with an audit every 256 ticks."""
    config = Config(
        max_symbols=capacity, window_bars=window, env=os.environ.get("ENV", "CI")
    )
    overrides = {
        "pipeline_depth": pipeline_depth,
        "incremental": incremental,
        "carry_audit_every_ticks": carry_audit_every,
        "donate": donate,
        "numeric_digest": numeric_digest,
        "ingest_digest": ingest_digest,
        "drift_meter": drift_meter,
    }
    for name, value in overrides.items():
        if value is not None:
            setattr(config, name, type(getattr(config, name))(value))
    return SignalEngine(
        config=config,
        sinks=RecordingSinks(),
        window=window,
        device=device,
        context_config=context_config
        or ContextConfig(required_fresh_symbols=4, min_coverage_ratio=0.5),
        enabled_strategies=enabled_strategies,
        breadth=breadth,
    )


def load_klines_by_tick(path: str | Path) -> dict[int, list[dict]]:
    """Group a JSONL (optionally gzip) kline file by 15m delivery bucket; a
    line's optional ``_deliver_bucket`` key overrides its own bucket."""
    opener = gzip.open if str(path).endswith(".gz") else open
    klines_by_tick: dict[int, list[dict]] = {}
    with opener(path, "rt") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            k = json.loads(line)
            deliver = k.pop("_deliver_bucket", None)
            bucket = int(deliver) if deliver is not None else int(k["open_time"]) // 1000 // 900
            klines_by_tick.setdefault(bucket, []).append(k)
    return klines_by_tick


def tick_seq(path: str | Path) -> list[tuple[int, list[dict]]]:
    """One (now_ms, klines) tick per 15m delivery bucket, in order."""
    klines_by_tick = load_klines_by_tick(path)
    return [
        (
            (bucket + 1) * 900 * 1000,
            sorted(klines_by_tick[bucket], key=lambda k: k["open_time"]),
        )
        for bucket in sorted(klines_by_tick)
    ]


def signal_tuples(fired) -> list[tuple]:
    """Fired signals → ``(tick_ms, strategy, symbol, direction, autotrade)``."""
    return [
        (s.tick_ms, s.strategy, s.symbol, str(s.value.direction), bool(s.value.autotrade))
        for s in fired
    ]


def run_replay(
    path: str | Path,
    capacity: int = 256,
    window: int = 200,
    collect: list | None = None,
    breadth: dict | None = None,
    pipeline_depth: int | None = None,
    enabled_strategies: set | None = None,
    context_config: ContextConfig | None = None,
    device: str | None = None,
    incremental: bool | None = None,
    carry_audit_every: int | None = None,
    donate: bool | None = None,
    numeric_digest: bool | None = None,
    ingest_digest: bool | None = None,
    drift_meter: bool | None = None,
) -> dict:
    """Replay a JSONL kline file; returns run statistics, the routing
    counters among them. With ``collect`` a list, every fired signal is
    appended as a :func:`signal_tuples` tuple. The engine's arguments are
    :func:`make_stub_engine`'s; the ticks still in flight at the end of the
    file are flushed."""
    engine = make_stub_engine(
        capacity=capacity,
        window=window,
        breadth=breadth,
        pipeline_depth=pipeline_depth,
        enabled_strategies=enabled_strategies,
        context_config=context_config,
        device=device,
        incremental=incremental,
        carry_audit_every=carry_audit_every,
        donate=donate,
        numeric_digest=numeric_digest,
        ingest_digest=ingest_digest,
        drift_meter=drift_meter,
    )
    seq = tick_seq(path)
    fired_total = 0
    t_start = time.perf_counter()

    def record(fired) -> None:
        nonlocal fired_total
        fired_total += len(fired)
        if collect is not None:
            collect.extend(signal_tuples(fired))

    async def drive() -> None:
        for tick_ms, klines in seq:
            for k in klines:
                engine.ingest(k)
            record(await engine.process_tick(now_ms=tick_ms))
        record(await engine.flush_pending())

    asyncio.run(drive())
    wall = time.perf_counter() - t_start
    lat = np.asarray(engine.tick_wall_ms, dtype=np.float64)
    return {
        "device": str(engine.device),
        "ticks": len(seq),
        "signals": fired_total,
        "wall_s": wall,
        "tick_p50_ms": float(np.percentile(lat, 50)) if lat.size else 0.0,
        "tick_p99_ms": float(np.percentile(lat, 99)) if lat.size else 0.0,
        "incremental_ticks": engine.incremental_ticks,
        "full_recompute_ticks": engine.full_recompute_ticks,
        "full_recompute_reasons": dict(engine.full_recompute_reasons),
        "overflow_ticks": engine.overflow_ticks,
        "inplace_ticks": engine.inplace_ticks,
        "state_resets": engine.state_resets,
    }


def kline_record(
    symbol: str, ts_s: int, interval_s: int, o, h, low, c, volume,
    trades: float = 300.0,
) -> dict:
    """One ExtendedKline-shaped dict (close_time = open+interval-1ms)."""
    return {
        "symbol": symbol,
        "open_time": ts_s * 1000,
        "close_time": (ts_s + interval_s) * 1000 - 1,
        "open": round(float(o), 6),
        "high": round(float(h), 6),
        "low": round(float(low), 6),
        "close": round(float(c), 6),
        "volume": round(float(volume), 3),
        "quote_asset_volume": round(float(volume * c), 3),
        "number_of_trades": trades,
        "taker_buy_base_volume": round(float(volume / 2), 3),
        "taker_buy_quote_volume": round(float(volume * c / 2), 3),
    }


def _kline_json(symbol, ts_s, interval_s, o, h, low, c, volume, trades=300.0) -> str:
    return json.dumps(kline_record(symbol, ts_s, interval_s, o, h, low, c, volume, trades)) + "\n"


def generate_replay_file(
    path: str | Path,
    n_symbols: int = 100,
    n_ticks: int = 150,
    seed: int = 7,
) -> None:
    """Synthesize a dual-interval (5m + 15m) market replay with crafted
    setups: an activity burst on S001's 5m stream, a MeanReversionFade hammer
    on S005's 15m stream and a LiquidationSweepPump pump on S003, on the last
    tick. Same generator, same seed, same file as the reference's."""
    rng = np.random.default_rng(seed)
    # 15m-bucket-aligned: the evaluated bar's open time is bucket*900-900
    t0 = 1_780_272_000
    px = 20 + rng.random(n_symbols) * 100

    with open(path, "w") as f:
        for tick in range(n_ticks):
            ts15 = t0 + tick * 900
            rets = rng.normal(0, 0.004, n_symbols)
            rets[5] -= 0.008
            last_tick = tick == n_ticks - 1
            if last_tick and n_symbols > 3:
                rets[0] = 0.005
                rets[3] = 0.03
            new_px = px * (1 + rets)
            for i in range(n_symbols):
                symbol = "BTCUSDT" if i == 0 else f"S{i:03d}USDT"
                o, c = px[i], new_px[i]
                vol15 = abs(rng.normal(1000, 200))
                if last_tick and i == 3:
                    vol15 *= 8.0
                h, low = max(o, c) * 1.002, min(o, c) * 0.998
                if last_tick and i == 5:
                    o = px[i] * 0.955
                    c = o * 1.003
                    h, low = c * 1.001, o * 0.997
                    new_px[i] = c
                    vol15 *= 3.0
                f.write(_kline_json(symbol, ts15, 900, o, h, low, c, vol15))
                sub_o = o
                for j in range(3):
                    frac = (j + 1) / 3
                    sub_c = o + (c - o) * frac
                    vol5 = vol15 / 3
                    sh, sl = max(sub_o, sub_c) * 1.001, min(sub_o, sub_c) * 0.999
                    if last_tick and i == 1:
                        if j < 2:
                            sub_c = sub_o * 1.003
                            sh, sl = sub_c * 1.001, sub_o * 0.999
                        else:
                            sub_c = sub_o * 1.03
                            sh, sl = sub_c * 1.002, sub_o * 0.998
                            vol5 *= 8.0
                        new_px[i] = sub_c
                    f.write(_kline_json(symbol, ts15 + j * 300, 300, sub_o, sh, sl, sub_c, vol5))
                    sub_o = sub_c
            px = new_px


def generate_burst_replay(
    path: str | Path,
    n_symbols: int = 160,
    n_ticks: int = 108,
    seed: int = 23,
) -> None:
    """A market-wide crash on the last tick that fires MeanReversionFade on
    every symbol at once: more fired (strategy, row) pairs than the wire's
    compaction slots (WIRE_MAX_FIRED = 128 at the default 160 symbols), so
    the overflow fallback runs from dispatch to emission. Same generator,
    same seed, same file as the reference's."""
    rng = np.random.default_rng(seed)
    t0 = 1_780_272_000
    px = 20 + rng.random(n_symbols) * 100

    with open(path, "w") as f:
        for tick in range(n_ticks):
            ts15 = t0 + tick * 900
            # a steady market-wide downtrend keeps every symbol's RSI pinned
            rets = rng.normal(-0.004, 0.002, n_symbols)
            new_px = px * (1 + rets)
            last_tick = tick == n_ticks - 1
            for i in range(n_symbols):
                symbol = "BTCUSDT" if i == 0 else f"S{i:03d}USDT"
                o, c = px[i], new_px[i]
                vol15 = abs(rng.normal(1000, 200))
                h, low = max(o, c) * 1.002, min(o, c) * 0.998
                if last_tick:
                    # a green hammer, market-wide: a deep gap down below the
                    # lower band, a green close, 3x volume
                    o = px[i] * 0.955
                    c = o * 1.003
                    h, low = c * 1.001, o * 0.997
                    new_px[i] = c
                    vol15 *= 3.0
                f.write(_kline_json(symbol, ts15, 900, o, h, low, c, vol15))
                sub_o = o
                for j in range(3):
                    sub_c = o + (c - o) * (j + 1) / 3
                    sh = max(sub_o, sub_c) * 1.001
                    sl = min(sub_o, sub_c) * 0.999
                    f.write(_kline_json(symbol, ts15 + j * 300, 300, sub_o, sh, sl, sub_c, vol15 / 3))
                    sub_o = sub_c
            px = new_px
