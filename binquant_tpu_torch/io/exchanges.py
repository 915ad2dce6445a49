"""Exchange REST clients: the part autotrade admission calls.

The port's own copy of the parts of ``binquant_tpu/io/exchanges.py`` a
bot launch reads: the spot ticker price (Binance and KuCoin), and the
KuCoin futures contract terms and mark price. Klines, the websocket, open
interest and Binance's used-weight guard (which paces the bulk kline
backfill) are not ported yet (ROADMAP queue A, item 8).

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
        resp.raise_for_status()
        return resp.json()


class BinanceApi(_RestClient):
    BASE = "https://api.binance.com"

    def __init__(self, key: str = "", secret: str = "", session: Any | None = None):
        super().__init__(self.BASE, session)
        self.key, self.secret = key, secret

    def get_ticker_price(self, symbol: str) -> float:
        data = self._get("/api/v3/ticker/price", {"symbol": symbol})
        return float(data["price"])


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

    def get_mark_price(self, symbol: str) -> float:
        data = self._get(f"/api/v1/mark-price/{symbol}/current")["data"]
        return float(data["value"])
