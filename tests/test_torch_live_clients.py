"""The port's live clients against the reference's, on the same inputs.

* Frame parsing: every frame of the recorded KuCoin session
  (``tests/fixtures/kucoin_session.json``, spot and futures) and seeded
  Binance frames (closed, unclosed, malformed) parse to equal klines in both
  packages, and a malformed frame counts one parse error in each.
* Connectors: both packages' ``KucoinKlinesConnector`` driven over the
  fixture by one replay fake send equal subscribe messages and queue equal
  klines; the same for ``KlinesConnector`` over seeded Binance frames, and a
  dropped connection reconnects and resubscribes in both.
* Reconnect backoff: ``reconnect_delay`` sequences are equal for one seed.
* REST helpers: the three ``normalize_*_klines``, ``make_history_fetcher``'s
  symbol forms and routes, ``binance_weight_backoff_seconds`` over a grid,
  Binance's used-weight guard and the 429 retry.

Every comparison is exact.
"""

import asyncio
import json
import random
from pathlib import Path

import numpy as np
import pytest

from binquant_tpu import utils as jutils
from binquant_tpu.io import exchanges as jex
from binquant_tpu.io import websocket as jws
from binquant_tpu.obs import instruments as jinst
from binquant_tpu.schemas import SymbolModel as JSymbol
from binquant_tpu_torch import utils as tutils
from binquant_tpu_torch.io import exchanges as tex
from binquant_tpu_torch.io import websocket as tws
from binquant_tpu_torch.obs import instruments as tinst
from binquant_tpu_torch.schemas import SymbolModel as TSymbol

FIXTURE = Path(__file__).parent / "fixtures" / "kucoin_session.json"
PACKAGES = (
    (jws, jex, jinst, JSymbol),
    (tws, tex, tinst, TSymbol),
)


@pytest.fixture(scope="module")
def session():
    return json.loads(FIXTURE.read_text())


def binance_frames(seed: int = 11, n: int = 40) -> list[str]:
    """Seeded Binance stream frames: closed and unclosed klines of three
    symbols and two intervals, another event kind, undecodable JSON and a
    kline with a malformed field."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        sym = ["BTCUSDT", "ETHUSDT", "SOLUSDT"][i % 3]
        iv, step = (("5m", 300_000), ("15m", 900_000))[i % 2]
        t = 1_753_000_200_000 + step * (i // 6)
        o = float(rng.uniform(10, 100))
        c = o * float(rng.uniform(0.98, 1.02))
        k = {
            "t": t, "T": t + step - 1, "s": sym, "i": iv,
            "o": repr(o), "c": repr(c), "h": repr(max(o, c) * 1.001),
            "l": repr(min(o, c) * 0.999), "v": repr(float(rng.uniform(1, 1e4))),
            "n": int(rng.integers(1, 500)), "x": bool(i % 4 != 1),
            "q": repr(float(rng.uniform(1, 1e6))), "V": repr(float(rng.uniform(1, 1e3))),
            "Q": repr(float(rng.uniform(1, 1e5))),
        }
        out.append(json.dumps({"e": "kline", "E": t + 5, "s": sym, "k": k}))
    out.insert(3, json.dumps({"e": "trade", "s": "BTCUSDT"}))
    out.insert(7, "{not json")
    bad = json.loads(out[10])
    bad["k"]["o"] = "not-a-price"
    bad["k"]["x"] = True
    out.insert(11, json.dumps(bad))
    return out


def test_kucoin_fixture_frames_parse_alike(session):
    frames = [(f, "futures") for f in session["futures_frames"]]
    frames += [(f, "spot") for f in session["spot_frames"]]
    parsed = 0
    for frame, market in frames:
        raw = json.dumps(frame)
        a = jws.parse_kucoin_candle_message(raw, market)
        b = tws.parse_kucoin_candle_message(raw, market)
        assert a == b, raw
        parsed += a is not None
    assert parsed >= 6  # the candle pushes, not only the junk frames


def test_binance_frames_parse_alike_and_count_the_malformed():
    errors = [inst.WS_PARSE_ERRORS.labels(exchange="binance").value for inst in (jinst, tinst)]
    kinds = {"closed": 0, "none": 0}
    for raw in binance_frames():
        a = jws.parse_binance_kline_frame(raw)
        b = tws.parse_binance_kline_frame(raw)
        assert a == b, raw
        kinds["closed" if a is not None else "none"] += 1
    assert kinds["closed"] >= 20 and kinds["none"] >= 10
    for before, inst in zip(errors, (jinst, tinst)):
        # the undecodable frame and the malformed field
        assert inst.WS_PARSE_ERRORS.labels(exchange="binance").value - before == 2


class ReplayConnect:
    """An async context manager yielding a frame log, then holding the
    connection open; ``drop_after`` frames in, the first connection raises
    instead (the peer closed it)."""

    def __init__(self, frames: list[str], drop_after: int | None = None) -> None:
        self.frames = frames
        self.drop_after = drop_after
        self.sent: list[dict] = []
        self.urls: list[str] = []

    def __call__(self, url: str):
        self.urls.append(url)
        return self

    async def __aenter__(self):
        outer = self
        first = len(self.urls) == 1

        class Ws:
            def __init__(self) -> None:
                self.i = 0

            async def send(self, msg: str) -> None:
                outer.sent.append(json.loads(msg))

            def __aiter__(self):
                return self

            async def __anext__(self) -> str:
                if first and outer.drop_after is not None and self.i == outer.drop_after:
                    raise ConnectionError("socket closed by the peer")
                if self.i < len(outer.frames) and (first or outer.drop_after is not None):
                    self.i += 1
                    return outer.frames[self.i - 1]
                await asyncio.sleep(3600)
                raise StopAsyncIteration

        return Ws()

    async def __aexit__(self, *exc) -> bool:
        return False


def _drain(queue: asyncio.Queue) -> list:
    out = []
    while not queue.empty():
        out.append(queue.get_nowait())
    return out


def _run_connector(make, settle_s: float = 0.6):
    async def run():
        queue: asyncio.Queue = asyncio.Queue()
        conn = make(queue)
        await conn.start_stream()
        await asyncio.sleep(settle_s)
        await conn.stop()
        return _drain(queue)

    return asyncio.run(run())


def test_kucoin_connectors_replay_the_session_alike(session):
    out = []
    for ws_mod, _, _, Symbol in PACKAGES:
        runs = {}
        for market in ("futures", "spot"):
            frames = [json.dumps(f) for f in session[f"{market}_frames"]]
            fake = ReplayConnect(frames)
            symbols = ([Symbol(id="XBTUSDTM"), Symbol(id="ETHUSDTM")] if market == "futures"
                       else [Symbol(id="BTCUSDT", base_asset="BTC", quote_asset="USDT")])
            klines = _run_connector(lambda q, m=market, s=symbols, f=fake: ws_mod.KucoinKlinesConnector(
                q, s, market_type=m, connect=f, token_fetch=lambda: ("wss://fixture", "tok", 18.0),
            ))
            runs[market] = (fake.urls, fake.sent, klines)
        out.append(runs)
    assert out[0] == out[1]
    futures_urls, futures_sent, futures_klines = out[1]["futures"]
    assert futures_urls[0].startswith("wss://fixture?token=tok&connectId=bq0")
    assert futures_sent[0]["type"] == "subscribe" and futures_sent[0]["response"] is False
    # the two XBTUSDTM updates collapse; the bar closes when a newer open time arrives
    assert [k["symbol"] for k in futures_klines] == ["XBTUSDTM"]
    assert futures_klines[0]["close"] == 117988.4


def test_binance_connectors_alike_through_a_dropped_connection():
    """Both connectors subscribe both intervals in chunks under the stream
    cap, queue the closed candles only, count the drop and resubscribe."""
    frames = binance_frames(seed=5, n=24)
    out = []
    for ws_mod, _, inst, Symbol in PACKAGES:
        health = ws_mod.WsHealth()
        reconnects = inst.WS_RECONNECTS.labels(exchange="binance").value
        fake = ReplayConnect(frames, drop_after=9)
        symbols = [Symbol(id=s) for s in ("BTCUSDT", "ETHUSDT", "SOLUSDT", "USDTTRY")]
        klines = _run_connector(lambda q, f=fake, s=symbols, h=health: ws_mod.KlinesConnector(
            q, s, connect=f, max_markets_per_client=4, reconnect_seed=3,
            initial_backoff_s=0.01, health=h,
        ))
        out.append((fake.urls, fake.sent, klines,
                    inst.WS_RECONNECTS.labels(exchange="binance").value - reconnects,
                    health.snapshot()["reconnects_recent"]))
    assert out[0] == out[1]
    urls, sent, klines, reconnects, recent = out[1]
    assert reconnects == 1 and recent == 1
    # two clients of two symbols (4 markets each, the fiat pair filtered out)
    # the first connection dropped and came back: three subscribes
    assert len(urls) == 3 and len(sent) == 3
    assert sent[0]["params"] == ["btcusdt@kline_5m", "btcusdt@kline_15m",
                                 "ethusdt@kline_5m", "ethusdt@kline_15m"]
    assert klines and all(k["exchange"] == "binance" for k in klines)


def test_reconnect_delay_sequences_alike():
    for seed in (0, 7, 2026):
        seqs = []
        for ws_mod, *_ in PACKAGES:
            rng = random.Random(seed)
            backoff, seq = ws_mod.RECONNECT_INITIAL_BACKOFF_S, []
            for _ in range(8):
                seq.append(ws_mod.reconnect_delay(backoff, rng))
                backoff = min(backoff * 2, ws_mod.RECONNECT_MAX_BACKOFF_S)
            seq.append(ws_mod.reconnect_delay(5.0, rng, jitter=0.0))
            seqs.append(seq)
        assert seqs[0] == seqs[1]
    # each client's rng: seeded per client, distinct across clients
    rngs = []
    for ws_mod, _, _, Symbol in PACKAGES:
        conn = ws_mod.KlinesConnector(asyncio.Queue(), [Symbol(id="BTCUSDT")],
                                      connect=lambda *_: None, reconnect_seed=42)
        rngs.append([conn._client_rng(i).random() for i in range(3)])
    assert rngs[0] == rngs[1] and len(set(rngs[1])) == 3


def test_symbol_helpers_alike():
    rows = [dict(id="BTCUSDT", base_asset="BTC"), dict(id="USDCUSDT", base_asset="USDC"),
            dict(id="ETHUSDTM"), dict(id="EURUSDT", base_asset="EUR"),
            dict(id="SOLUSDT", base_asset="SOL", active=False), dict(id="XBTUSDTM")]
    out = []
    for ws_mod, _, _, Symbol in PACKAGES:
        symbols = [Symbol(**r) for r in rows]
        kept = ws_mod.filter_fiat_symbols(symbols)
        out.append(([s.id for s in kept], ws_mod.kucoin_futures_ids(kept),
                    [ws_mod.kucoin_spot_api_symbol(s) for s in symbols]))
    assert out[0] == out[1]


def _rows(seed: int, n: int, kind: str) -> list[list]:
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        o = float(rng.uniform(10, 100))
        h, lo, c = o * 1.01, o * 0.99, o * float(rng.uniform(0.99, 1.01))
        v, q = float(rng.uniform(1, 1e4)), float(rng.uniform(1, 1e6))
        if kind == "binance":
            t = 1_753_000_200_000 + 900_000 * i
            rows.append([t, str(o), str(h), str(lo), str(c), str(v), t + 899_999, str(q),
                         int(rng.integers(1, 500)), str(v / 2), str(q / 2), "0"])
        elif kind == "kucoin":
            t = 1_753_000_200 + 900 * (n - i)  # newest first
            rows.append([str(t), str(o), str(c), str(h), str(lo), str(v), str(q)])
        else:
            t = 1_753_000_200_000 + 900_000 * i
            rows.append([t, o, h, lo, c, int(v)])
    return rows


def test_normalizers_alike():
    for seed in range(3):
        assert (jex.normalize_binance_klines("BTCUSDT", _rows(seed, 9, "binance"))
                == tex.normalize_binance_klines("BTCUSDT", _rows(seed, 9, "binance")))
        for interval_s in (300, 900):
            assert (jex.normalize_kucoin_klines("BTCUSDT", _rows(seed, 7, "kucoin"), interval_s)
                    == tex.normalize_kucoin_klines("BTCUSDT", _rows(seed, 7, "kucoin"),
                                                   interval_s))
            assert (jex.normalize_kucoin_futures_klines("XBTUSDTM", _rows(seed, 7, "fut"),
                                                        interval_s)
                    == tex.normalize_kucoin_futures_klines("XBTUSDTM", _rows(seed, 7, "fut"),
                                                           interval_s))


class HistoryApi:
    """Records each ``get_ui_klines`` call and answers it in the layout of
    the exchange asked for."""

    def __init__(self, kind: str) -> None:
        self.kind = kind
        self.calls: list = []

    def get_ui_klines(self, symbol, interval, limit=400):
        self.calls.append((symbol, interval, limit))
        return _rows(len(self.calls), 5, self.kind)


@pytest.mark.parametrize("exchange,market,kind,api_symbol", [
    ("binance", "spot", "binance", None),
    ("kucoin", "spot", "kucoin", {"BTCUSDT": "BTC-USDT"}),
    ("kucoin", "futures", "fut", None),
])
def test_history_fetcher_alike(exchange, market, kind, api_symbol):
    out = []
    for _, ex, _, _ in PACKAGES:
        api = HistoryApi(kind)
        to_api = None if api_symbol is None else (lambda s, m=api_symbol: m.get(s, s))
        fetch = ex.make_history_fetcher(api, exchange, limit=123, market_type=market,
                                        api_symbol_of=to_api)
        got = [fetch(sym, iv) for sym in ("BTCUSDT", "XBTUSDTM") for iv in ("5m", "15m")]
        out.append((api.calls, got))
    assert out[0] == out[1]
    calls, got = out[1]
    assert all(k["symbol"] in ("BTCUSDT", "XBTUSDTM") for run in got for k in run)
    if api_symbol:
        assert calls[0][0] == "BTC-USDT"


def test_binance_weight_backoff_alike():
    for used in (0, 1, 999, 1000, 1001, 1199, 1200, 5000, -3):
        assert (jutils.binance_weight_backoff_seconds(used)
                == tutils.binance_weight_backoff_seconds(used))
    assert tutils.binance_weight_backoff_seconds(1001) == 60.0


class Resp:
    def __init__(self, payload, status_code: int = 200, headers: dict | None = None) -> None:
        self.payload, self.status_code, self.headers = payload, status_code, headers or {}

    def json(self):
        return self.payload

    def raise_for_status(self) -> None:
        if self.status_code >= 400:
            raise RuntimeError(f"HTTP {self.status_code}")


class ScriptedSession:
    """Answers each GET from a script; records the calls."""

    def __init__(self, replies: list) -> None:
        self.replies = list(replies)
        self.calls: list = []

    def get(self, url, params=None):
        self.calls.append((url, dict(params or {})))
        return self.replies.pop(0)


def test_429_retry_and_weight_guard_alike(monkeypatch):
    slept: list = []
    monkeypatch.setattr("time.sleep", lambda s: slept.append(s))
    out = []
    for _, ex, _, _ in PACKAGES:
        del slept[:]
        session = ScriptedSession([
            Resp({}, 429, {"retry-after": "7"}),
            Resp([[1, "1", "2", "0.5", "1.5", "10", 2, "15", 3, "5", "7", "0"]], 200,
                 {"x-mbx-used-weight-1m": "1100"}),
            Resp({"price": "42.5"}, 200, {"x-mbx-used-weight-1m": "12"}),
            Resp({"price": "43"}, 200, {"x-mbx-used-weight-1m": "junk"}),
        ])
        api = ex.BinanceApi(session=session)
        rows = api.get_ui_klines("BTCUSDT", "15m", limit=1)
        prices = [api.get_ticker_price("BTCUSDT"), api.get_ticker_price("BTCUSDT")]
        out.append((session.calls, rows, prices, list(slept), api.backoffs_engaged,
                    api.get_request_weight({"x-mbx-used-weight-1m": "17"})))
    assert out[0] == out[1]
    calls, rows, prices, sleeps, engaged, weight = out[1]
    assert len(calls) == 4 and sleeps == [7.0, 60.0] and engaged == 1 and weight == 17


def test_kucoin_rest_clients_alike(monkeypatch):
    """KuCoin spot candles (and an error envelope), futures candles paged
    back from a fixed now and deduplicated, and open interest."""
    import time

    monkeypatch.setattr(time, "time", lambda: 1_753_010_000.0)
    out = []
    for _, ex, _, _ in PACKAGES:
        page = [[1_753_000_000_000 + 900_000 * i, 1.0, 2.0, 0.5, 1.5, 10] for i in range(5)]
        session = ScriptedSession([
            Resp({"code": "200000", "data": _rows(1, 4, "kucoin")}),
            Resp({"code": "400100", "msg": "bad symbol"}),
            Resp({"code": "200000", "data": page[2:]}),
            Resp({"code": "200000", "data": page[:3]}),
            Resp({"data": {"openInterest": "12345.5"}}),
            Resp({"data": {}}),
        ])
        spot = ex.KucoinApi(session=session)
        fut = ex.KucoinFutures(session=session)
        fut.KLINE_PAGE = 3
        got = [spot.get_ui_klines("BTC-USDT", "15min", limit=3)]
        with pytest.raises(RuntimeError, match="400100"):
            spot.get_ui_klines("NOPE-USDT")
        got.append(fut.get_ui_klines("XBTUSDTM", 15, limit=5))
        got.append([fut.get_open_interest("XBTUSDTM"), fut.get_open_interest("ETHUSDTM")])
        out.append((session.calls, got))
    assert out[0] == out[1]
    assert out[1][1][2] == [12345.5, 0.0]
