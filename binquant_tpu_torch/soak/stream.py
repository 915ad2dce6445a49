"""Multi-exchange soak stream.

The port's own copy of the reference's soak stream (``binquant_tpu/soak/
stream.py``). KuCoin symbols are not synthesized as kline dicts: they are
rendered as live-format KuCoin websocket frames (spot ``/market/candles``
topic shape, the o/c/h/l field order and all) and pushed through the
port's :class:`KucoinKlinesConnector` — scripted ``connect=``/
``token_fetch=`` seams, the same parser, the same closed-on-newer-open
emission rule production runs. What comes out of the connector's queue
(``exchange="kucoin"``-tagged kline dicts) is what the soak stream merges
with the binance side, so a kucoin-only outage in the soak bed diverges
the real per-exchange watermarks.

Reusable pieces:

* :func:`kucoin_frame` — one ExtendedKline dict → the raw ws frame text;
* :func:`kucoin_scenario_stream` — klines → frames → connector →
  parsed closed candles (the reusable scenario-stream seam);
* :func:`merge_streams` — interleave per-exchange kline lists into one
  delivery-ordered JSONL scenario file.
"""

from __future__ import annotations

import asyncio
import json
from pathlib import Path

from binquant_tpu_torch.io.exchanges import KUCOIN_INTERVALS
from binquant_tpu_torch.schemas import SymbolModel
from binquant_tpu_torch.sim.scenarios import FIFTEEN_MIN_S, FIVE_MIN_S

#: bar seconds → KuCoin ws interval string (io/exchanges.py is the one
#: source of truth for the names)
_INTERVAL_NAME = {
    FIVE_MIN_S: KUCOIN_INTERVALS["5m"],
    FIFTEEN_MIN_S: KUCOIN_INTERVALS["15m"],
}


def kucoin_symbol(symbol: str, quote: str = "USDT") -> str:
    """Engine id → dashed KuCoin spot form (``K001USDT`` → ``K001-USDT``);
    the parser strips the dash back off, so the round trip is exact."""
    if symbol.endswith(quote):
        return f"{symbol[: -len(quote)]}-{quote}"
    return symbol


def kucoin_symbol_model(symbol: str, quote: str = "USDT") -> SymbolModel:
    base = symbol[: -len(quote)] if symbol.endswith(quote) else symbol
    return SymbolModel(id=symbol, base_asset=base, quote_asset=quote)


def kucoin_frame(k: dict) -> str:
    """One ExtendedKline dict → the live KuCoin SPOT ws frame that
    parses back to it (parse_kucoin_candle_message): topic
    ``/market/candles:{sym}_{iv}``, candles =
    ``[time_s, open, close, high, low, volume, turnover]`` — note the
    spot o/c/h/l order, the classic integration trap the parser pins."""
    interval_s = (int(k["close_time"]) - int(k["open_time"]) + 1) // 1000
    iv = _INTERVAL_NAME[interval_s]
    sym = kucoin_symbol(k["symbol"])
    return json.dumps(
        {
            "type": "message",
            "topic": f"/market/candles:{sym}_{iv}",
            "subject": "trade.candles.update",
            "data": {
                "symbol": sym,
                "candles": [
                    str(int(k["open_time"]) // 1000),
                    str(k["open"]),
                    str(k["close"]),
                    str(k["high"]),
                    str(k["low"]),
                    str(k["volume"]),
                    str(k.get("quote_asset_volume", 0.0)),
                ],
                "time": int(k["close_time"]) * 1_000_000,
            },
        }
    )


class _ScriptedKucoinWs:
    """Async-context websocket double replaying scripted frame text, then
    idling (the ScriptedWs shape from sim/chaos.py, minus fault verbs —
    stream-level kucoin faults are scripted on the parsed klines)."""

    def __init__(self, frames: list[str]) -> None:
        self._frames = list(frames)
        self.sent: list[str] = []

    async def __aenter__(self) -> "_ScriptedKucoinWs":
        return self

    async def __aexit__(self, *exc) -> bool:
        return False

    async def send(self, payload: str) -> None:
        self.sent.append(payload)

    def __aiter__(self) -> "_ScriptedKucoinWs":
        return self

    async def __anext__(self) -> str:
        if self._frames:
            await asyncio.sleep(0)
            return self._frames.pop(0)
        # subscription exhausted: idle like a quiet live socket until the
        # connector is cancelled
        await asyncio.sleep(3600)
        raise StopAsyncIteration


def kucoin_scenario_stream(
    klines: list[dict], timeout_s: float = 10.0
) -> list[dict]:
    """Script ``klines`` as live KuCoin frames through the real
    connector seam and return the parsed CLOSED candles, stream-ordered.

    KuCoin pushes the in-progress candle and the connector emits it as
    closed only when a newer open time arrives for the same (symbol,
    interval) — so one trailing sentinel frame per (symbol, interval)
    past the last bar flushes the tail, exactly how a live session's
    next bar would."""
    from binquant_tpu_torch.io.websocket import KucoinKlinesConnector

    order: list[tuple[str, int]] = []
    last: dict[tuple[str, int], dict] = {}
    for k in klines:
        key = (
            k["symbol"],
            (int(k["close_time"]) - int(k["open_time"]) + 1) // 1000,
        )
        if key not in last:
            order.append(key)
        if (
            key not in last
            or int(k["open_time"]) > int(last[key]["open_time"])
        ):
            last[key] = k
    frames = [kucoin_frame(k) for k in klines]
    for sym, interval_s in order:
        tail = dict(last[(sym, interval_s)])
        tail["open_time"] = int(tail["open_time"]) + interval_s * 1000
        tail["close_time"] = int(tail["close_time"]) + interval_s * 1000
        frames.append(kucoin_frame(tail))

    expected = len(klines)
    out: list[dict] = []

    async def run() -> None:
        queue: asyncio.Queue = asyncio.Queue()
        symbols = sorted({k["symbol"] for k in klines})
        connector = KucoinKlinesConnector(
            queue,
            [kucoin_symbol_model(s) for s in symbols],
            market_type="spot",
            intervals=tuple(
                _INTERVAL_NAME[s] for s in sorted({s for _, s in order})
            ),
            connect=lambda url, **_kw: _ScriptedKucoinWs(list(frames)),
            token_fetch=lambda: ("wss://scripted.local", "tok", 3600.0),
            max_topics_per_connection=10_000,  # one scripted session
        )
        await connector.start_stream()
        try:
            deadline = asyncio.get_event_loop().time() + timeout_s
            while len(out) < expected:
                remaining = deadline - asyncio.get_event_loop().time()
                if remaining <= 0:
                    break
                try:
                    out.append(
                        await asyncio.wait_for(queue.get(), remaining)
                    )
                except (TimeoutError, asyncio.TimeoutError):
                    break
        finally:
            await connector.stop()

    asyncio.run(run())
    return out


def synthetic_klines(
    names: list[str], n_ticks: int, seed: int = 53
) -> list[dict]:
    """A small random-walk market for a second exchange's symbols, in the
    corpus dual-interval contract (one 15m bar + three 5m sub-bars per
    tick) on the same T0 clock as the binance side — the input
    :func:`kucoin_scenario_stream` renders as live frames."""
    import numpy as np

    from binquant_tpu_torch.io.replay import kline_record
    from binquant_tpu_torch.sim.scenarios import T0, _interp_sub_bars

    rng = np.random.default_rng(seed)
    px = 5.0 + rng.random(len(names)) * 50.0
    out: list[dict] = []
    for t in range(n_ticks):
        ts15 = T0 + t * FIFTEEN_MIN_S
        new = px * (1.0 + rng.normal(0.0, 0.003, len(names)))
        for i, name in enumerate(names):
            o, c = float(px[i]), float(new[i])
            h = max(o, c) * 1.0007
            low = min(o, c) * 0.9993
            vol = 100.0 + float(rng.random()) * 50.0
            out.append(
                kline_record(name, ts15, FIFTEEN_MIN_S, o, h, low, c, vol)
            )
            for j, (so, sh, sl, sc, sv) in enumerate(
                _interp_sub_bars(o, c, vol)
            ):
                out.append(
                    kline_record(
                        name,
                        ts15 + j * FIVE_MIN_S,
                        FIVE_MIN_S,
                        so,
                        sh,
                        sl,
                        sc,
                        sv,
                    )
                )
        px = new
    return out


def merge_streams(
    path: str | Path, *streams: list[dict]
) -> int:
    """Interleave per-exchange kline lists into ONE delivery-ordered
    scenario JSONL (``_deliver_bucket`` transport keys ride through);
    returns the line count."""
    merged = [k for stream in streams for k in stream]
    merged.sort(
        key=lambda k: (
            k.get("_deliver_bucket", int(k["open_time"]) // 1000 // 900),
            int(k["open_time"]),
            k["symbol"],
        )
    )
    with open(path, "w") as f:
        for k in merged:
            f.write(json.dumps(k) + "\n")
    return len(merged)
