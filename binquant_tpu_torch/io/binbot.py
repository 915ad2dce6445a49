"""Binbot backend REST client.

The port's own copy of ``binquant_tpu/io/binbot.py``: symbols and settings,
bot lifecycle (real and paper), grid ladders, analytics dispatch and market
breadth, as thin JSON over HTTP with an injectable session, so the whole
surface runs against a fake (``io/replay.py``'s :class:`StubSession`).
``httpx`` is imported only when no session is passed.

Every request is bounded: up to ``retry_max`` in-client retries after a
transport error or a 5xx, each after a jittered exponential backoff drawn
from the client's own ``random.Random``; a 4xx and a backend error body
(``{"error": 1}``) are not retried. Exhaustion is counted
(``bqt_binbot_retries_total{outcome="exhausted"}``) and recorded as a
``binbot_retry_exhausted`` event before the error propagates. A request
made while a tick trace is active (on the tick's emission path) gets its
own ``binbot.<method>`` span; off-tick calls see only the counters.
"""

from __future__ import annotations

import logging
import random
import time
from typing import Any

from binquant_tpu_torch.exceptions import BinbotError
from binquant_tpu_torch.obs.events import get_event_log
from binquant_tpu_torch.obs.instruments import BINBOT_REQUESTS, BINBOT_RETRIES
from binquant_tpu_torch.obs.tracing import current_trace
from binquant_tpu_torch.schemas import (
    AutotradeSettingsSchema,
    MarketBreadthSeries,
    SymbolModel,
    TestAutotradeSettingsSchema,
)

# the spread of a retry's backoff, as the websocket connectors jitter theirs
RECONNECT_JITTER = 0.25


def reconnect_delay(
    backoff: float, rng: random.Random, jitter: float = RECONNECT_JITTER
) -> float:
    """``backoff`` spread by ±``jitter`` of itself through ``rng``: a fleet
    of clients must not retry in step."""
    if jitter <= 0:
        return backoff
    return backoff * (1.0 + jitter * (2.0 * rng.random() - 1.0))


class BinbotApi:
    """Endpoints mirror the reference's consumption sites."""

    def __init__(
        self,
        base_url: str,
        session: Any | None = None,
        timeout_s: float = 10.0,
        retry_max: int = 0,
        retry_backoff_s: float = 0.2,
        rng: random.Random | None = None,
    ) -> None:
        self.base_url = base_url.rstrip("/")
        if session is None:
            import httpx

            session = httpx.Client(timeout=timeout_s)
        self.session = session
        self.timeout_s = float(timeout_s)
        self.retry_max = max(int(retry_max), 0)
        self.retry_backoff_s = float(retry_backoff_s)
        self._rng = rng or random.Random()

    # -- plumbing -----------------------------------------------------------

    def _request(self, method: str, path: str, **kwargs) -> Any:
        """One REST round trip, inside a ``binbot.<method>`` span of the
        active tick trace when there is one (a failure marks the span, not
        the trace)."""
        trace = current_trace()
        if trace is None:
            return self._request_inner(method, path, **kwargs)
        with trace.span(f"binbot.{method.lower()}", path=path) as span:
            try:
                payload = self._request_inner(method, path, **kwargs)
            except Exception as exc:
                span.set(error=str(exc))
                raise
            return payload

    def _request_inner(self, method: str, path: str, **kwargs) -> Any:
        """One bounded round trip (see the module docstring)."""
        url = f"{self.base_url}{path}"
        attempts = self.retry_max + 1
        backoff = self.retry_backoff_s
        for attempt in range(attempts):
            try:
                resp = self.session.request(method, url, **kwargs)
            except Exception:
                BINBOT_REQUESTS.labels(method=method, outcome="transport_error").inc()
                if attempt + 1 >= attempts:
                    if self.retry_max:
                        self._note_exhausted(method, path, "transport_error")
                    raise
            else:
                if resp.status_code >= 500:
                    BINBOT_REQUESTS.labels(method=method, outcome="http_error").inc()
                    if attempt + 1 >= attempts:
                        if self.retry_max:
                            self._note_exhausted(method, path, f"http_{resp.status_code}")
                        raise BinbotError(f"{method} {path} -> {resp.status_code}: {resp.text}")
                elif resp.status_code >= 400:
                    BINBOT_REQUESTS.labels(method=method, outcome="http_error").inc()
                    raise BinbotError(f"{method} {path} -> {resp.status_code}: {resp.text}")
                else:
                    payload = resp.json()
                    if isinstance(payload, dict) and payload.get("error") == 1:
                        BINBOT_REQUESTS.labels(method=method, outcome="backend_error").inc()
                        raise BinbotError(str(payload.get("message", "unknown binbot error")))
                    BINBOT_REQUESTS.labels(method=method, outcome="ok").inc()
                    return payload
            BINBOT_RETRIES.labels(outcome="retry").inc()
            time.sleep(reconnect_delay(backoff, self._rng))
            backoff *= 2.0
        raise BinbotError(f"{method} {path}: retry loop exited")  # unreachable

    def _note_exhausted(self, method: str, path: str, reason: str) -> None:
        BINBOT_RETRIES.labels(outcome="exhausted").inc()
        get_event_log().emit(
            "binbot_retry_exhausted",
            method=method,
            path=path,
            reason=reason,
            retries=self.retry_max,
        )

    def _get(self, path: str, **kwargs) -> Any:
        return self._request("GET", path, **kwargs)

    def _post(self, path: str, json: Any = None, **kwargs) -> Any:
        return self._request("POST", path, json=json, **kwargs)

    def _put(self, path: str, json: Any = None, **kwargs) -> Any:
        return self._request("PUT", path, json=json, **kwargs)

    def _delete(self, path: str, **kwargs) -> Any:
        return self._request("DELETE", path, **kwargs)

    @staticmethod
    def _data(payload: Any) -> Any:
        if isinstance(payload, dict) and "data" in payload:
            return payload["data"]
        return payload

    # -- symbols & settings -------------------------------------------------

    def get_symbols(self) -> list[SymbolModel]:
        rows = self._data(self._get("/symbols"))
        return [SymbolModel.model_validate(r) for r in rows]

    def get_single_symbol(self, symbol: str) -> SymbolModel:
        return SymbolModel.model_validate(self._data(self._get(f"/symbol/{symbol}")))

    def edit_symbol(self, symbol: str, **fields: Any) -> Any:
        return self._put(f"/symbol/{symbol}", json=fields)

    def get_autotrade_settings(self) -> AutotradeSettingsSchema:
        row = self._data(self._get("/autotrade-settings/bots"))
        return AutotradeSettingsSchema.model_validate(row)

    def get_test_autotrade_settings(self) -> TestAutotradeSettingsSchema:
        row = self._data(self._get("/autotrade-settings/paper-trading"))
        return TestAutotradeSettingsSchema.model_validate(row)

    def filter_excluded_symbols(self) -> list[str]:
        return list(self._data(self._get("/symbols/excluded")) or [])

    # -- bots (real + paper) ------------------------------------------------

    def create_bot(self, payload: dict) -> Any:
        return self._post("/bot", json=payload)

    def activate_bot(self, bot_id: str) -> Any:
        return self._get(f"/bot/activate/{bot_id}")

    def deactivate_bot(self, bot_id: str, algorithmic_close: bool = False) -> Any:
        return self._delete(
            f"/bot/deactivate/{bot_id}", params={"algorithmic_close": algorithmic_close}
        )

    def create_paper_bot(self, payload: dict) -> Any:
        return self._post("/paper-trading", json=payload)

    def activate_paper_bot(self, bot_id: str) -> Any:
        return self._get(f"/paper-trading/activate/{bot_id}")

    def delete_paper_bot(self, bot_id: str) -> Any:
        return self._delete(f"/paper-trading/{bot_id}")

    def get_active_pairs(self, collection_name: str = "bots") -> list[str]:
        return list(self._data(self._get(f"/bots/active-pairs/{collection_name}")) or [])

    def submit_bot_event_logs(self, bot_id: str, message: str) -> Any:
        try:
            return self._post(f"/bot/errors/{bot_id}", json={"errors": message})
        except BinbotError:
            logging.exception("submit_bot_event_logs failed for %s", bot_id)
            return None

    def submit_paper_trading_event_logs(self, bot_id: str, message: str) -> Any:
        try:
            return self._post(f"/paper-trading/errors/{bot_id}", json={"errors": message})
        except BinbotError:
            logging.exception("submit_paper_trading_event_logs failed for %s", bot_id)
            return None

    def clean_margin_short(self, pair: str) -> Any:
        return self._get(f"/bot/clean-margin-short/{pair}")

    def get_available_fiat(self, exchange: str, fiat: str = "USDT") -> float:
        data = self._data(
            self._get("/balance/available-fiat", params={"exchange": exchange, "fiat": fiat})
        )
        if isinstance(data, dict):
            return float(data.get("amount", 0.0))
        return float(data or 0.0)

    # -- grid ladders -------------------------------------------------------

    def get_active_grid_ladders(self) -> list[dict]:
        return list(self._data(self._get("/grid-ladders/active")) or [])

    def calculate_grid_levels(self, payload: dict) -> Any:
        return self._post("/grid-ladders/calculate", json=payload)

    def create_grid_ladder(self, payload: dict) -> Any:
        return self._post("/grid-ladders", json=payload)

    # -- analytics ----------------------------------------------------------

    def dispatch_create_signal(self, payload: dict) -> Any:
        """Analytics record for every strategy emission."""
        return self._post("/signals", json=payload)

    # -- market data --------------------------------------------------------

    async def get_market_breadth(self, size: int = 7) -> MarketBreadthSeries:
        """Async, as the reference's; the transport is synchronous."""
        data = self._data(self._get("/market-breadth", params={"size": size}))
        return MarketBreadthSeries.model_validate(data or {})
