"""Websocket ingest: the exchange kline connectors and their health.

The port's own copy of ``binquant_tpu/io/websocket.py``. Symbols are chunked
across connections (400 markets a Binance client, 300 topics a KuCoin
connection), every frame is JSON-parsed, and **closed candles only** are put
on the asyncio queue as the kline dicts ``SignalEngine.ingest`` reads
(quote volume, trade count and the taker-buy splits included, where the
exchange sends them). Binance marks a closed candle (``k.x``); KuCoin pushes
the candle in progress, so a candle counts as closed when a newer open time
arrives for the same symbol and interval. A closed socket reconnects and
resubscribes after a per-client jittered exponential backoff
(:func:`reconnect_delay`), so the chunked clients of one exchange do not
resubscribe in step after an outage.

Every frame counts in ``bqt_ws_frames_total``, every drop in
``bqt_ws_reconnects_total`` (with a ``ws_reconnect`` event and a report to
:data:`WS_HEALTH`, the ``ws`` section of ``/healthz``), every frame that
fails to parse in ``bqt_ws_parse_errors_total`` (with a rate-limited
``ws_bad_frame`` event): a bad frame never tears a connection down.

The connection factory is injectable (``connect=``, and KuCoin's bullet
handshake ``token_fetch=``), so tests and ``chip_smoke.py`` drive the real
parsing and reconnect paths over fake sockets. The defaults import
``websockets`` and ``httpx`` inside the client that needs them, never at
import time.
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
import random
import time
from collections import deque
from collections.abc import Callable
from typing import Any

from binquant_tpu_torch.exceptions import WebSocketError
from binquant_tpu_torch.io.exchanges import INTERVAL_SECONDS
from binquant_tpu_torch.io.exchanges import KUCOIN_INTERVALS as KUCOIN_WS_INTERVALS
from binquant_tpu_torch.obs.events import get_event_log
from binquant_tpu_torch.obs.instruments import WS_FRAMES, WS_PARSE_ERRORS, WS_RECONNECTS
from binquant_tpu_torch.schemas import SymbolModel

BINANCE_WS_BASE = "wss://stream.binance.com:9443/ws"
MAX_MARKETS_PER_CLIENT = 400  # Binance
MAX_TOPICS_PER_CONNECTION = 300  # KuCoin

FIAT_PREFIXES = ("USDT", "USDC", "BUSD", "EUR", "TRY", "DAI")

# Reconnect backoff shared by both connectors; the ±25% jitter keeps the
# chunked clients of one exchange from resubscribing in step after an
# exchange-wide outage.
RECONNECT_INITIAL_BACKOFF_S = 1.0
RECONNECT_MAX_BACKOFF_S = 30.0
RECONNECT_JITTER = 0.25


def reconnect_delay(backoff: float, rng: random.Random, jitter: float = RECONNECT_JITTER) -> float:
    """``backoff`` spread by ±``jitter`` of itself, drawn from the client's
    own rng."""
    if jitter <= 0:
        return backoff
    return backoff * (1.0 + jitter * (2.0 * rng.random() - 1.0))


class _BadFrameMeter:
    """Counts parse failures (``bqt_ws_parse_errors_total``) and emits a
    ``ws_bad_frame`` event at most every ``every_s`` seconds per exchange;
    the suppressed ones are tallied on the next event."""

    def __init__(self, every_s: float = 30.0) -> None:
        self.every_s = float(every_s)
        self._last: dict[str, float] = {}
        self._suppressed: dict[str, int] = {}

    def note(self, exchange: str, error: str, raw_len: int) -> None:
        WS_PARSE_ERRORS.labels(exchange=exchange).inc()
        now = time.monotonic()
        if now - self._last.get(exchange, float("-inf")) < self.every_s:
            self._suppressed[exchange] = self._suppressed.get(exchange, 0) + 1
            return
        self._last[exchange] = now
        get_event_log().emit(
            "ws_bad_frame",
            exchange=exchange,
            error=str(error)[:200],
            raw_len=int(raw_len),
            suppressed_since_last=self._suppressed.pop(exchange, 0),
        )


BAD_FRAMES = _BadFrameMeter()


class WsHealth:
    """Rolling reconnect-storm tracker surfaced as the ``ws`` section of
    ``/healthz``. Connectors report drops and recoveries; a reconnect rate
    past ``degrade_reconnects`` inside the window marks the probe
    ``degraded``, which stays HTTP 200 (alive but impaired; only ``stale``
    is 503)."""

    def __init__(
        self, window_s: float = 300.0, degrade_reconnects: int = 6
    ) -> None:
        self.window_s = float(window_s)
        self.degrade_reconnects = int(degrade_reconnects)
        self._reconnects: deque[float] = deque(maxlen=4096)
        self._backoff: dict[str, float] = {}  # "exchange/client" -> seconds

    def note_reconnect(
        self, exchange: str, client: int, backoff_s: float,
        now: float | None = None,
    ) -> None:
        self._reconnects.append(
            time.monotonic() if now is None else float(now)
        )
        self._backoff[f"{exchange}/{client}"] = float(backoff_s)

    def note_connected(self, exchange: str, client: int) -> None:
        self._backoff.pop(f"{exchange}/{client}", None)

    def reset(self) -> None:
        self._reconnects.clear()
        self._backoff.clear()

    def snapshot(self, now: float | None = None) -> dict:
        now = time.monotonic() if now is None else float(now)
        recent = sum(1 for t in self._reconnects if now - t <= self.window_s)
        return {
            "reconnects_recent": recent,
            "window_s": self.window_s,
            "degrade_reconnects": self.degrade_reconnects,
            "clients_backing_off": len(self._backoff),
            "max_backoff_s": max(self._backoff.values(), default=0.0),
            "storming": recent >= self.degrade_reconnects,
        }


# Process singleton the connectors feed and health_snapshot reads; its
# window and threshold come from the environment, not the Config
# (BQT_WS_DEGRADE_WINDOW, BQT_WS_DEGRADE_RECONNECTS), as in the reference.
WS_HEALTH = WsHealth(
    window_s=float(os.environ.get("BQT_WS_DEGRADE_WINDOW", "300") or "300"),
    degrade_reconnects=int(os.environ.get("BQT_WS_DEGRADE_RECONNECTS", "6") or "6"),
)


def filter_fiat_symbols(symbols: list[SymbolModel]) -> list[SymbolModel]:
    """The active symbols that are not fiat-to-fiat pairs."""
    return [
        s for s in symbols
        if s.active and not any(s.id.startswith(p) for p in FIAT_PREFIXES)
    ]


def kucoin_spot_api_symbol(s: SymbolModel) -> str:
    """Engine id -> the dashed KuCoin spot form (``BTC-USDT``), shared by
    the websocket topics and the REST backfill so the two never disagree.
    A symbol without ``base_asset`` keeps its id, with a warning."""
    if not s.base_asset:
        logging.warning("symbol %s has no base_asset; KuCoin spot form unknown", s.id)
        return s.id
    return f"{s.base_asset}-{s.quote_asset}"


def kucoin_futures_ids(symbols: list[SymbolModel]) -> list[str]:
    """The KuCoin futures universe: the ``…USDTM`` contract ids, shared by
    the websocket subscription and the backfill."""
    return [s.id for s in symbols if s.id.endswith("USDTM")]


def parse_binance_kline_frame(raw: str | bytes) -> dict | None:
    """One Binance frame -> a kline dict for a closed candle, else None
    (another event, an unclosed candle, or a frame that does not parse,
    which is counted)."""
    try:
        res = json.loads(raw)
    except Exception as e:
        BAD_FRAMES.note("binance", str(e), len(str(raw)))
        logging.error("Failed to decode ws message: %s; len=%s", e, len(str(raw)))
        return None
    if res.get("e") != "kline":
        logging.debug("Non-kline event received: %s", res.get("e"))
        return None
    k = res.get("k", {})
    if not k.get("s") or not k.get("x"):  # closed candles only
        return None
    try:
        return {
            "symbol": k["s"],
            "open_time": int(k["t"]),
            "close_time": int(k["T"]),
            "open": float(k["o"]),
            "high": float(k["h"]),
            "low": float(k["l"]),
            "close": float(k["c"]),
            "volume": float(k["v"]),
            "quote_asset_volume": float(k.get("q", 0.0)),
            "number_of_trades": float(k.get("n", 0.0)),
            "taker_buy_base_volume": float(k.get("V", 0.0)),
            "taker_buy_quote_volume": float(k.get("Q", 0.0)),
            # the ingest monitor's per-exchange feed-lag tag
            "exchange": "binance",
        }
    except (TypeError, ValueError, KeyError) as e:
        # valid JSON, malformed fields: counted, never a phantom reconnect
        BAD_FRAMES.note("binance", f"bad kline fields: {e}", len(str(raw)))
        logging.error("Malformed kline frame fields: %s", e)
        return None


class _Connector:
    """What both exchange connectors share: the per-client jitter rng, the
    reconnect bookkeeping and the task lifecycle."""

    EXCHANGE = ""
    NOTHING_TO_SUBSCRIBE = ""

    def __init__(
        self,
        queue: asyncio.Queue,
        connect: Callable[..., Any] | None,
        reconnect_jitter: float,
        reconnect_seed: int | None,
        initial_backoff_s: float,
        max_backoff_s: float,
        health: WsHealth | None,
    ) -> None:
        self.queue = queue
        if connect is None:
            import websockets

            connect = websockets.connect
        self._connect = connect
        self._tasks: list[asyncio.Task] = []
        self._reconnect_jitter = reconnect_jitter
        self._reconnect_seed = reconnect_seed
        self._initial_backoff_s = initial_backoff_s
        self._max_backoff_s = max_backoff_s
        self._health = health or WS_HEALTH

    def _client_rng(self, idx: int) -> random.Random:
        """The client's jitter rng: seeded ``reconnect_seed + idx`` when a
        seed is given, distinct per client either way."""
        if self._reconnect_seed is None:
            return random.Random()
        return random.Random(self._reconnect_seed + idx)

    async def _backoff_after_drop(self, idx: int, error: Exception, backoff: float,
                                  rng: random.Random) -> float:
        """Count and report a dropped client, sleep its jittered backoff,
        and return the next backoff."""
        exchange = self.EXCHANGE
        WS_RECONNECTS.labels(exchange=exchange).inc()
        self._health.note_reconnect(exchange, idx, backoff)
        get_event_log().emit(
            "ws_reconnect", exchange=exchange, client=idx, error=str(error), backoff_s=backoff,
        )
        logging.warning(
            "%s ws client %d dropped (%s); reconnecting in %.0fs", exchange, idx, error, backoff,
        )
        await asyncio.sleep(reconnect_delay(backoff, rng, self._reconnect_jitter))
        return min(backoff * 2, self._max_backoff_s)

    def _chunks(self) -> list[list[str]]:
        raise NotImplementedError

    async def _run_client(self, idx: int, chunk: list[str]) -> None:
        raise NotImplementedError

    async def start_stream(self) -> None:
        chunks = self._chunks()
        if not chunks:
            raise WebSocketError(self.NOTHING_TO_SUBSCRIBE)
        for idx, chunk in enumerate(chunks):
            self._tasks.append(asyncio.create_task(self._run_client(idx, chunk)))

    async def stop(self) -> None:
        for task in self._tasks:
            task.cancel()
        await asyncio.gather(*self._tasks, return_exceptions=True)
        self._tasks.clear()


class KlinesConnector(_Connector):
    """Binance kline streams over chunked connections. Both engine intervals
    (5m and 15m) are subscribed per symbol: each ring needs live frames."""

    EXCHANGE = "binance"
    NOTHING_TO_SUBSCRIBE = "no symbols to subscribe"

    def __init__(
        self,
        queue: asyncio.Queue,
        symbols: list[SymbolModel],
        intervals: tuple[str, ...] = ("5m", "15m"),
        connect: Callable[..., Any] | None = None,
        max_markets_per_client: int = MAX_MARKETS_PER_CLIENT,
        reconnect_jitter: float = RECONNECT_JITTER,
        reconnect_seed: int | None = None,
        initial_backoff_s: float = RECONNECT_INITIAL_BACKOFF_S,
        max_backoff_s: float = RECONNECT_MAX_BACKOFF_S,
        health: WsHealth | None = None,
    ) -> None:
        super().__init__(queue, connect, reconnect_jitter, reconnect_seed, initial_backoff_s,
                         max_backoff_s, health)
        self.symbols = filter_fiat_symbols(symbols)
        self.intervals = intervals
        self.max_markets_per_client = max_markets_per_client

    def _chunks(self) -> list[list[str]]:
        """Stream names per client, every interval of a symbol on the same
        client, each client under the stream cap."""
        per_client = max(self.max_markets_per_client // len(self.intervals), 1)
        return [
            [f"{s.id.lower()}@kline_{iv}" for s in self.symbols[i: i + per_client]
             for iv in self.intervals]
            for i in range(0, len(self.symbols), per_client)
        ]

    async def _run_client(self, idx: int, markets: list[str]) -> None:
        """One connection: subscribe, pump frames, reconnect on a drop."""
        backoff = self._initial_backoff_s
        rng = self._client_rng(idx)
        while True:
            try:
                async with self._connect(BINANCE_WS_BASE) as ws:
                    await ws.send(json.dumps({"method": "SUBSCRIBE", "params": markets, "id": 1}))
                    logging.info("Subscribed client %d to %d markets", idx, len(markets))
                    backoff = self._initial_backoff_s
                    self._health.note_connected("binance", idx)
                    async for raw in ws:
                        WS_FRAMES.labels(exchange="binance").inc()
                        kline = parse_binance_kline_frame(raw)
                        if kline is not None:
                            await self.queue.put(kline)
            except asyncio.CancelledError:
                raise
            except Exception as e:
                backoff = await self._backoff_after_drop(idx, e, backoff, rng)


# KuCoin's websocket interval -> seconds, from the REST client's tables (one
# source of interval names for the topics and the backfill)
_KUCOIN_INTERVAL_S = {KUCOIN_WS_INTERVALS[k]: INTERVAL_SECONDS[k] for k in KUCOIN_WS_INTERVALS}


def parse_kucoin_candle_message(raw: str | bytes, market_type: str) -> tuple[str, str, dict] | None:
    """One KuCoin frame -> ``(symbol, interval, candle)`` or None. The spot
    topic ``/market/candles:{sym}_{iv}`` carries ``data.candles = [time_s,
    open, close, high, low, volume, turnover]``, the futures topic
    ``/contractMarket/limitCandle:{sym}_{iv}`` ``[time_s, open, high, low,
    close, volume]``; both describe the candle in progress (the connector
    decides when it closed). A frame that does not parse is counted."""
    try:
        msg = json.loads(raw)
    except Exception as e:
        BAD_FRAMES.note("kucoin", str(e), len(str(raw)))
        logging.error("Failed to decode kucoin ws message: %s", e)
        return None
    if msg.get("type") != "message":
        return None
    topic = str(msg.get("topic", ""))
    data = msg.get("data") or {}
    candles = data.get("candles")
    if not candles or ":" not in topic:
        return None
    try:
        symbol, interval = topic.split(":", 1)[1].rsplit("_", 1)
    except ValueError:
        return None
    interval_s = _KUCOIN_INTERVAL_S.get(interval)
    if interval_s is None:
        return None
    try:
        t = int(float(candles[0])) * 1000
        if str(market_type).lower() == "futures":
            o, h, low, c = (float(candles[i]) for i in (1, 2, 3, 4))
            volume = float(candles[5]) if len(candles) > 5 else 0.0
            turnover = 0.0
        else:
            o, c, h, low = (float(candles[i]) for i in (1, 2, 3, 4))
            volume = float(candles[5]) if len(candles) > 5 else 0.0
            turnover = float(candles[6]) if len(candles) > 6 else 0.0
    except (TypeError, ValueError, IndexError) as e:
        BAD_FRAMES.note("kucoin", f"bad candle fields: {e}", len(str(raw)))
        logging.error("Malformed kucoin candle fields: %s", e)
        return None
    return (
        symbol,
        interval,
        {
            "symbol": symbol.replace("-", ""),
            "open_time": t,
            "close_time": t + interval_s * 1000 - 1,
            "open": o,
            "high": h,
            "low": low,
            "close": c,
            "volume": volume,
            "quote_asset_volume": turnover,
            "number_of_trades": 0.0,
            "taker_buy_base_volume": 0.0,
            "taker_buy_quote_volume": 0.0,
            "exchange": "kucoin",
        },
    )


class KucoinKlinesConnector(_Connector):
    """KuCoin spot or futures kline streams: POST the public bullet endpoint
    for a token and the websocket endpoint, connect with ``?token=``,
    subscribe at most 300 topics a connection (comma-joined, 100 a message,
    under KuCoin's uplink message limit), ping at the cadence the bullet
    gives. A candle is put on the queue when a frame with a newer open time
    arrives for its symbol and interval."""

    EXCHANGE = "kucoin"
    NOTHING_TO_SUBSCRIBE = "no kucoin topics to subscribe"
    SPOT_BULLET = "https://api.kucoin.com/api/v1/bullet-public"
    FUTURES_BULLET = "https://api-futures.kucoin.com/api/v1/bullet-public"

    def __init__(
        self,
        queue: asyncio.Queue,
        symbols: list[SymbolModel],
        market_type: str = "futures",
        intervals: tuple[str, ...] = ("5min", "15min"),
        connect: Callable[..., Any] | None = None,
        token_fetch: Callable[[], tuple[str, str, float]] | None = None,
        max_topics_per_connection: int = MAX_TOPICS_PER_CONNECTION,
        reconnect_jitter: float = RECONNECT_JITTER,
        reconnect_seed: int | None = None,
        initial_backoff_s: float = RECONNECT_INITIAL_BACKOFF_S,
        max_backoff_s: float = RECONNECT_MAX_BACKOFF_S,
        health: WsHealth | None = None,
    ) -> None:
        super().__init__(queue, connect, reconnect_jitter, reconnect_seed, initial_backoff_s,
                         max_backoff_s, health)
        self.market_type = market_type
        symbols = filter_fiat_symbols(symbols)
        if str(market_type).lower() == "futures":
            self.topic_symbols = kucoin_futures_ids(symbols)
        else:
            self.topic_symbols = [kucoin_spot_api_symbol(s) for s in symbols]
        self.intervals = intervals
        self.max_topics_per_connection = max_topics_per_connection
        self._token_fetch = token_fetch or self._default_token_fetch
        # (symbol, interval) -> the candle in progress
        self._last_candle: dict[tuple[str, str], dict] = {}

    def _default_token_fetch(self) -> tuple[str, str, float]:
        """(ws_endpoint, token, ping_interval_s) from the public bullet."""
        import httpx

        url = (
            self.FUTURES_BULLET
            if str(self.market_type).lower() == "futures"
            else self.SPOT_BULLET
        )
        data = httpx.post(url, timeout=10).json()["data"]
        server = data["instanceServers"][0]
        return (
            server["endpoint"],
            data["token"],
            float(server.get("pingInterval", 18000)) / 1000.0,
        )

    def _topic(self, symbol: str, interval: str) -> str:
        if str(self.market_type).lower() == "futures":
            return f"/contractMarket/limitCandle:{symbol}_{interval}"
        return f"/market/candles:{symbol}_{interval}"

    def _chunks(self) -> list[list[str]]:
        topics = [self._topic(sym, iv) for sym in self.topic_symbols for iv in self.intervals]
        n = self.max_topics_per_connection
        return [topics[i: i + n] for i in range(0, len(topics), n)]

    async def _on_candle(self, symbol: str, interval: str, candle: dict) -> None:
        """Keep the candle in progress; put the previous one on the queue
        when the open time advances."""
        key = (symbol, interval)
        prev = self._last_candle.get(key)
        if prev is not None and candle["open_time"] > prev["open_time"]:
            await self.queue.put(prev)
        self._last_candle[key] = candle

    async def _run_client(self, idx: int, topics: list[str]) -> None:
        backoff = self._initial_backoff_s
        rng = self._client_rng(idx)
        while True:
            try:
                # the bullet handshake is a blocking POST: off the loop, so
                # the other clients' pings are not starved
                endpoint, token, ping_interval = await asyncio.to_thread(self._token_fetch)
                url = f"{endpoint}?token={token}&connectId=bq{idx}"
                async with self._connect(url) as ws:
                    prefix = topics[0].split(":", 1)[0]
                    suffixes = [t.split(":", 1)[1] for t in topics]
                    per_msg = 100
                    for i in range(0, len(suffixes), per_msg):
                        await ws.send(json.dumps({
                            "id": i // per_msg + 1,
                            "type": "subscribe",
                            "topic": f"{prefix}:" + ",".join(suffixes[i: i + per_msg]),
                            "privateChannel": False,
                            "response": False,
                        }))
                        await asyncio.sleep(0.1)
                    logging.info(
                        "kucoin %s client %d subscribed %d topics",
                        self.market_type, idx, len(topics),
                    )
                    backoff = self._initial_backoff_s
                    self._health.note_connected("kucoin", idx)

                    async def ping_loop() -> None:
                        n = 0
                        while True:
                            await asyncio.sleep(ping_interval)
                            n += 1
                            await ws.send(json.dumps({"id": f"ping{n}", "type": "ping"}))

                    ping_task = asyncio.create_task(ping_loop())
                    try:
                        async for raw in ws:
                            WS_FRAMES.labels(exchange="kucoin").inc()
                            parsed = parse_kucoin_candle_message(raw, self.market_type)
                            if parsed is not None:
                                await self._on_candle(*parsed)
                    finally:
                        ping_task.cancel()
            except asyncio.CancelledError:
                raise
            except Exception as e:
                # forget this client's candles in progress: after an outage
                # across a bar boundary the next frame's newer open time
                # would otherwise put the partial pre-drop candle on the
                # queue as closed
                for topic in topics:
                    sym_iv = topic.split(":", 1)[-1]
                    if "_" in sym_iv:
                        self._last_candle.pop(tuple(sym_iv.rsplit("_", 1)), None)
                backoff = await self._backoff_after_drop(idx, e, backoff, rng)


class WebsocketClientFactory:
    """Chooses the connector from the autotrade settings' exchange. Both
    engine intervals are subscribed on either exchange."""

    def __init__(
        self,
        queue: asyncio.Queue,
        symbols: list[SymbolModel],
        exchange_id: str = "binance",
        market_type: str = "futures",
        connect: Callable[..., Any] | None = None,
        token_fetch: Callable[[], tuple[str, str, float]] | None = None,
    ) -> None:
        self.queue = queue
        self.symbols = symbols
        self.exchange_id = exchange_id
        self.market_type = market_type
        self._connect = connect
        self._token_fetch = token_fetch

    def create_connector(self, **kwargs) -> KlinesConnector | KucoinKlinesConnector:
        """The exchange's connector; ``kwargs`` go to its constructor (the
        reconnect backoff and seed)."""
        if self.exchange_id.lower().startswith("kucoin"):
            return KucoinKlinesConnector(
                self.queue,
                self.symbols,
                market_type=self.market_type,
                intervals=tuple(KUCOIN_WS_INTERVALS[k] for k in ("5m", "15m")),
                connect=self._connect,
                token_fetch=self._token_fetch,
                **kwargs,
            )
        return KlinesConnector(
            self.queue, self.symbols, intervals=("5m", "15m"), connect=self._connect, **kwargs,
        )
