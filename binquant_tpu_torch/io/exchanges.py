"""Exchange REST clients: Binance spot, KuCoin spot and KuCoin futures.

The port's own copy of ``binquant_tpu/io/exchanges.py``: what a bot launch
reads (the spot ticker price, the futures contract terms and mark price),
what the startup backfill fetches (``get_ui_klines`` on all three clients,
the three ``normalize_*_klines`` converters and :func:`make_history_fetcher`,
which hides each exchange's interval names, row layout, order and symbol
form), the open interest LiquidationSweepPump's gate reads
(``KucoinFutures.get_open_interest``), and Binance's used-weight guard,
which paces the backfill's thousands of requests on every response
(``_on_response``).

Sessions are injectable (anything with ``get(url, params=)``). One
deviation from the reference: a client built without a session opens its
``httpx`` client on its first request, not in ``__init__``. The
reference's ``Autotrade`` builds its exchange clients with no session for
every launch, and a launch that never asks for a price must not need
``httpx``.
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import Any, NamedTuple

from binquant_tpu_torch.utils import binance_weight_backoff_seconds


def _blocking_sleep_allowed() -> bool:
    """True when NOT on a running event loop: a rate-limit sleep may block
    a worker thread, never the loop that runs the ticks."""
    try:
        asyncio.get_running_loop()
    except RuntimeError:
        return True
    return False


class FuturesSymbolInfo(NamedTuple):
    """Fields the futures margin resolver reads."""

    symbol: str
    multiplier: float
    lot_size: float
    taker_fee_rate: float


class _RestClient:
    def __init__(self, base_url: str, session: Any | None = None) -> None:
        self.base_url = base_url.rstrip("/")
        self._session = session

    @property
    def session(self) -> Any:
        if self._session is None:
            import httpx

            self._session = httpx.Client(timeout=10)
        return self._session

    def _get(self, path: str, params: dict | None = None) -> Any:
        resp = self.session.get(f"{self.base_url}{path}", params=params or {})
        if getattr(resp, "status_code", 200) == 429 and _blocking_sleep_allowed():
            # a hard rate-limit hit: honour Retry-After once, then retry
            # (worker threads only; on the event loop the 429 raises below)
            headers = getattr(resp, "headers", None) or {}
            retry_s = float(headers.get("retry-after", 60) or 60)
            logging.warning("%s returned 429; sleeping %.0fs before retry", path, retry_s)
            time.sleep(retry_s)
            resp = self.session.get(f"{self.base_url}{path}", params=params or {})
        self._on_response(resp)
        resp.raise_for_status()
        return resp.json()

    def _on_response(self, resp: Any) -> None:
        """Per-response hook (rate-limit accounting); default no-op."""


class BinanceApi(_RestClient):
    BASE = "https://api.binance.com"

    def __init__(self, key: str = "", secret: str = "", session: Any | None = None):
        super().__init__(self.BASE, session)
        self.key, self.secret = key, secret
        self.backoffs_engaged = 0

    def _on_response(self, resp: Any) -> None:
        """The used-weight guard on every response: past the soft cap of the
        (account-wide) per-minute weight, a worker thread sleeps out the
        minute; on the event loop it only warns, never freezing the ticks."""
        used = self.get_request_weight(getattr(resp, "headers", None) or {})
        delay = binance_weight_backoff_seconds(used)
        if delay > 0:
            self.backoffs_engaged += 1
            if _blocking_sleep_allowed():
                logging.warning(
                    "binance used weight %d near the 1200/min cap; sleeping %.0fs",
                    used, delay,
                )
                time.sleep(delay)
            else:
                logging.warning(
                    "binance used weight %d near the 1200/min cap "
                    "(event-loop call; not pausing the engine)",
                    used,
                )

    def get_ui_klines(self, symbol: str, interval: str = "15m", limit: int = 400) -> list[list]:
        return self._get(
            "/api/v3/uiKlines", {"symbol": symbol, "interval": interval, "limit": limit}
        )

    def get_ticker_price(self, symbol: str) -> float:
        data = self._get("/api/v3/ticker/price", {"symbol": symbol})
        return float(data["price"])

    def get_request_weight(self, resp_headers: Any) -> int:
        """The ``x-mbx-used-weight-1m`` header as an int (0 when absent or
        malformed)."""
        try:
            return int(resp_headers.get("x-mbx-used-weight-1m", 0) or 0)
        except (TypeError, ValueError, AttributeError):
            return 0


class KucoinApi(_RestClient):
    BASE = "https://api.kucoin.com"

    def __init__(
        self,
        key: str = "",
        secret: str = "",
        passphrase: str = "",
        session: Any | None = None,
    ):
        super().__init__(self.BASE, session)
        self.key, self.secret, self.passphrase = key, secret, passphrase

    def get_ticker_price(self, symbol: str) -> float:
        data = self._get("/api/v1/market/orderbook/level1", {"symbol": symbol})
        return float(data["data"]["price"])

    def get_ui_klines(self, symbol: str, interval: str = "15min", limit: int = 400) -> list[list]:
        """Spot candles, newest first, for a DASHED KuCoin symbol
        (``BTC-USDT``; :func:`make_history_fetcher` translates engine ids).
        A KuCoin error envelope raises: a silent empty list would make the
        startup backfill a no-op."""
        data = self._get("/api/v1/market/candles", {"symbol": symbol, "type": interval})
        code = str(data.get("code", "200000"))
        if code != "200000":
            raise RuntimeError(f"kucoin candles error for {symbol}: {code} {data.get('msg')}")
        return list(data.get("data") or [])[:limit]


INTERVAL_SECONDS = {"5m": 300, "15m": 900}
# engine interval key -> each exchange's REST interval
BINANCE_INTERVALS = {"5m": "5m", "15m": "15m"}
KUCOIN_INTERVALS = {"5m": "5min", "15m": "15min"}
KUCOIN_FUTURES_GRANULARITY = {"5m": 5, "15m": 15}  # minutes


def normalize_binance_klines(symbol: str, rows: list[list]) -> list[dict]:
    """Binance uiKlines rows (oldest first) -> kline dicts. A row is
    ``[open_time_ms, open, high, low, close, volume, close_time_ms,
    quote_asset_volume, num_trades, taker_buy_base, taker_buy_quote, _]``."""
    return [
        {
            "symbol": symbol,
            "open_time": int(r[0]),
            "close_time": int(r[6]),
            "open": float(r[1]),
            "high": float(r[2]),
            "low": float(r[3]),
            "close": float(r[4]),
            "volume": float(r[5]),
            "quote_asset_volume": float(r[7]),
            "number_of_trades": float(r[8]),
            "taker_buy_base_volume": float(r[9]),
            "taker_buy_quote_volume": float(r[10]),
        }
        for r in rows
    ]


def normalize_kucoin_klines(symbol: str, rows: list[list], interval_s: int) -> list[dict]:
    """KuCoin spot /market/candles rows (NEWEST first) -> kline dicts,
    oldest first. A row is ``[time_s, open, close, high, low, volume,
    turnover]``."""
    out = []
    for r in reversed(rows):
        t = int(r[0]) * 1000
        out.append(
            {
                "symbol": symbol,
                "open_time": t,
                "close_time": t + interval_s * 1000 - 1,
                "open": float(r[1]),
                "high": float(r[3]),
                "low": float(r[4]),
                "close": float(r[2]),
                "volume": float(r[5]),
                "quote_asset_volume": float(r[6]),
                "number_of_trades": 0.0,
                "taker_buy_base_volume": 0.0,
                "taker_buy_quote_volume": 0.0,
            }
        )
    return out


def normalize_kucoin_futures_klines(symbol: str, rows: list[list], interval_s: int) -> list[dict]:
    """KuCoin futures /kline/query rows (oldest first) -> kline dicts. A row
    is ``[time_ms, open, high, low, close, volume]``. The quote volume is 0,
    as the futures websocket frame carries no turnover: a window mixing
    seeded turnover with live zeros would flip ActivityBurstPump's
    quote-volume branch for the whole backfilled tail."""
    out = []
    for r in rows:
        t = int(r[0])
        out.append(
            {
                "symbol": symbol,
                "open_time": t,
                "close_time": t + interval_s * 1000 - 1,
                "open": float(r[1]),
                "high": float(r[2]),
                "low": float(r[3]),
                "close": float(r[4]),
                "volume": float(r[5]),
                "quote_asset_volume": 0.0,
                "number_of_trades": 0.0,
                "taker_buy_base_volume": 0.0,
                "taker_buy_quote_volume": 0.0,
            }
        )
    return out


def make_history_fetcher(
    api,
    exchange_id: str = "binance",
    limit: int = 400,
    market_type: str = "spot",
    api_symbol_of=None,
):
    """``fetch(symbol, interval_key)`` for ``interval_key`` in ``5m``/``15m``:
    the startup backfill's source. The exchanges differ in interval names,
    row layout, order and symbol form (KuCoin spot wants ``BTC-USDT``, its
    futures contracts such as ``XBTUSDTM`` live on another API);
    ``api_symbol_of`` maps an engine id to the API's symbol (identity when
    omitted), and the returned klines carry the ENGINE id."""
    kucoin = exchange_id.lower().startswith("kucoin")
    futures = str(market_type).lower().endswith("futures")
    to_api = api_symbol_of or (lambda s: s)

    def fetch(symbol: str, interval_key: str) -> list[dict]:
        interval_s = INTERVAL_SECONDS[interval_key]
        api_symbol = to_api(symbol)
        if kucoin and futures:
            rows = api.get_ui_klines(
                api_symbol, KUCOIN_FUTURES_GRANULARITY[interval_key], limit=limit
            )
            return normalize_kucoin_futures_klines(symbol, rows, interval_s)
        if kucoin:
            rows = api.get_ui_klines(api_symbol, KUCOIN_INTERVALS[interval_key], limit=limit)
            return normalize_kucoin_klines(symbol, rows, interval_s)
        rows = api.get_ui_klines(api_symbol, BINANCE_INTERVALS[interval_key], limit=limit)
        return normalize_binance_klines(symbol, rows)

    return fetch


class KucoinFutures(_RestClient):
    BASE = "https://api-futures.kucoin.com"

    def __init__(
        self,
        key: str = "",
        secret: str = "",
        passphrase: str = "",
        session: Any | None = None,
    ):
        super().__init__(self.BASE, session)
        self.key, self.secret, self.passphrase = key, secret, passphrase

    def get_symbol_info(self, symbol: str) -> FuturesSymbolInfo:
        data = self._get(f"/api/v1/contracts/{symbol}")["data"]
        return FuturesSymbolInfo(
            symbol=symbol,
            multiplier=float(data.get("multiplier", 1.0)),
            lot_size=float(data.get("lotSize", 1.0)),
            taker_fee_rate=float(data.get("takerFeeRate", 0.0006)),
        )

    # rows per request of /api/v1/kline/query; longer ranges paginate
    KLINE_PAGE = 200

    def get_ui_klines(
        self, symbol: str, granularity_min: int = 15, limit: int = 400
    ) -> list[list]:
        """Contract candles, oldest first. The endpoint caps a request at
        ~200 rows and, without a range, answers only its recent default:
        pages of at most ``KLINE_PAGE`` bars walk back from now until
        ``limit`` bars are covered; overlaps at page edges are deduped. A
        KuCoin error envelope raises."""
        end_ms = int(time.time() * 1000)
        bar_ms = granularity_min * 60_000
        rows: list[list] = []
        remaining = limit
        while remaining > 0:
            span = min(remaining, self.KLINE_PAGE)
            from_ms = end_ms - span * bar_ms
            data = self._get(
                "/api/v1/kline/query",
                {"symbol": symbol, "granularity": granularity_min, "from": from_ms,
                 "to": end_ms},
            )
            code = str(data.get("code", "200000"))
            if code != "200000":
                raise RuntimeError(
                    f"kucoin futures klines error for {symbol}: {code} {data.get('msg')}"
                )
            rows = list(data.get("data") or []) + rows
            remaining -= span
            end_ms = from_ms
        seen: dict[int, list] = {}
        for r in rows:
            seen[int(r[0])] = r
        return [seen[t] for t in sorted(seen)][-limit:]

    def get_mark_price(self, symbol: str) -> float:
        data = self._get(f"/api/v1/mark-price/{symbol}/current")["data"]
        return float(data["value"])

    def get_open_interest(self, symbol: str) -> float:
        data = self._get(f"/api/v1/contracts/{symbol}")["data"]
        return float(data.get("openInterest", 0.0) or 0.0)
