"""``python -m binquant_tpu_torch``, the port's own entry point, against the
JAX package's.

* Offline modes: ``--replay FILE --device cpu`` (a subprocess, as a user
  runs it), ``--scanned`` and ``--backtest`` (through the same ``main``)
  on the reference's 24-symbol, 120-tick replay emit the signal tuples of
  the reference's ``run_replay`` on the same file (read back from each run's
  ``signal`` events in ``BQT_EVENT_LOG``), exactly.
* Argument errors: the same as the root ``main.py``'s, message for message.
* Live: the port's ``run_live(device="cpu", ...)`` booted as a KuCoin
  futures deployment over fakes (the binbot backend, the Telegram
  transport, the KuCoin futures REST history, the websocket) on a driven
  clock delivers, tick for tick, the signals the reference's
  ``SignalEngine`` delivers when the test boots it the way ``main.py`` does
  (its backfill through ``make_history_fetcher``, its connector, its
  ``consume_loop``) over the same fakes and clock: tuples exact, scores at
  the wire contract.
* No card: without ``--device`` the command fails and does not run on the
  CPU.
"""

from __future__ import annotations

import asyncio
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import main as jmain
from binquant_tpu.io import replay as jreplay
from binquant_tpu_torch import __main__ as tmain
from binquant_tpu_torch.io import replay as treplay
from binquant_tpu_torch.obs import events as tevents

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def replay_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("torch_entrypoint") / "rp_7.jsonl"
    treplay.generate_replay_file(path, n_symbols=24, n_ticks=120, seed=7)
    return path


@pytest.fixture(scope="module")
def reference_tuples(replay_file):
    sig: list = []
    jreplay.run_replay(replay_file, capacity=64, window=200, collect=sig,
                       incremental=False, pipeline_depth=0)
    assert len(sig) > 0
    return sorted(sig)


def _signal_events(path: Path) -> list:
    records = [json.loads(line) for line in path.read_text().splitlines()]
    return sorted((e["tick_ms"], e["strategy"], e["symbol"], e["direction"], e["autotrade"])
                  for e in records if e["event"] == "signal")


def _child_env(**extra) -> dict:
    env = dict(os.environ, OMP_NUM_THREADS="1", **extra)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT), env.get("PYTHONPATH", "")]).rstrip(os.pathsep)
    return env


def test_replay_command_emits_the_reference_tuples(replay_file, reference_tuples, tmp_path):
    events = tmp_path / "events.jsonl"
    proc = subprocess.run(
        [sys.executable, "-m", "binquant_tpu_torch", "--replay", str(replay_file),
         "--device", "cpu"],
        cwd=ROOT, env=_child_env(BQT_EVENT_LOG=str(events)), capture_output=True, text=True,
        timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "'device': 'cpu'" in proc.stdout and "'ticks': 120" in proc.stdout
    assert _signal_events(events) == reference_tuples


@pytest.mark.parametrize("mode", ["--scanned", "--backtest"])
def test_drive_modes_emit_the_reference_tuples(replay_file, reference_tuples, tmp_path,
                                               monkeypatch, capsys, mode):
    events = tmp_path / "events.jsonl"
    monkeypatch.setenv("BQT_EVENT_LOG", str(events))
    try:
        assert tmain.main(["--replay", str(replay_file), mode, "--device", "cpu"]) == 0
    finally:
        tevents.get_event_log().close()
        tevents.set_event_log(None)
    out = capsys.readouterr().out
    assert ("'scan_chunks'" if mode == "--scanned" else "'backtest_chunks'") in out
    assert _signal_events(events) == reference_tuples


@pytest.mark.parametrize("argv", [
    ["--scanned"],
    ["--backtest"],
    ["--backtest", "--scanned", "--replay", "x.jsonl"],
    ["--no-such-flag"],
])
def test_argument_errors_match_main_py(argv, monkeypatch, capsys):
    errors = []
    for run in (lambda: jmain.main(), lambda: tmain.main(argv)):
        monkeypatch.setattr(sys, "argv", ["main.py", *argv])
        with pytest.raises(SystemExit) as exc:
            run()
        err = capsys.readouterr().err
        errors.append((exc.value.code, err.strip().splitlines()[-1].split("error: ", 1)[1]))
    assert errors[0] == errors[1]
    assert errors[1][0] == 2


def test_without_a_card_the_command_fails(replay_file, tmp_path):
    assert not torch.cuda.is_available()
    events = tmp_path / "events.jsonl"
    proc = subprocess.run(
        [sys.executable, "-m", "binquant_tpu_torch", "--replay", str(replay_file)],
        cwd=ROOT, env=_child_env(BQT_EVENT_LOG=str(events)), capture_output=True, text=True,
        timeout=300,
    )
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr
    assert not events.exists() or not _signal_events(events)  # nothing ran on the CPU


def test_live_service_without_a_card_fails_before_any_request():
    backend = treplay.StubSession()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        asyncio.run(tmain.run_live(binbot_session=backend))
    assert backend.requests == []


# --------------------------------------------------------------------------
# the live service over fakes
# --------------------------------------------------------------------------

CAPACITY, WINDOW, LIVE_TICKS = 64, 200, 4
T_LIVE0 = 1_780_272_000 + 900 * 3000  # the first live bar's open
NAMES = ["XBTUSDTM"] + [f"S{i:03d}USDTM" for i in range(1, CAPACITY)]
BREADTH = {"timestamp": [1, 2, 3, 4], "market_breadth": [0.5, 0.45, 0.4, 0.35],
           "market_breadth_ma": [0.5, 0.45, 0.4, 0.35]}


def live_market(seed: int = 19):
    """400 15m bars of history and LIVE_TICKS + 1 live ones, 5m bars under
    them; BTC nearly flat (LSP's stalled band, the breadth hot and
    falling), every 4th symbol trading heavy on the live bars."""
    rng = np.random.default_rng(seed)
    n15 = 400 + LIVE_TICKS + 1
    n5 = 3 * n15
    sig = np.full((CAPACITY, 1), 0.004)
    sig[0] = 0.0002
    c5 = (20 + rng.random((CAPACITY, 1)) * 80) * np.exp(
        np.cumsum(rng.normal(0.0, 1.0, (CAPACITY, n5)) * sig, axis=1))
    o5 = np.concatenate([c5[:, :1], c5[:, :-1]], axis=1)
    v5 = np.abs(rng.normal(1000, 200, (CAPACITY, n5)))
    v5[3::4, 3 * 400:] *= 4.0
    m5 = dict(open=o5, high=np.maximum(o5, c5) * 1.001, low=np.minimum(o5, c5) * 0.999,
              close=c5, volume=v5)
    g = lambda a: a.reshape(CAPACITY, n15, 3)  # noqa: E731
    m15 = dict(open=g(o5)[:, :, 0], high=g(m5["high"]).max(axis=2),
               low=g(m5["low"]).min(axis=2), close=g(c5)[:, :, 2], volume=g(v5).sum(axis=2))
    return m5, m15


def _ts(interval_s: int, col: int, n_hist: int) -> int:
    return T_LIVE0 + interval_s * (col - n_hist)


class Futures:
    """KuCoin futures REST: ``/kline/query`` rows of the market (400 closed
    bars and the open one); open interest unavailable (every row reads
    NaN, the same in both packages)."""

    def __init__(self, m5: dict, m15: dict) -> None:
        self.m = {5: (m5, 1200), 15: (m15, 400)}

    def get_ui_klines(self, symbol: str, granularity_min: int = 15, limit: int = 400) -> list:
        m, n_hist = self.m[granularity_min]
        r = NAMES.index(symbol)
        return [[_ts(60 * granularity_min, c, n_hist) * 1000,
                 *(float(m[k][r, c]) for k in ("open", "high", "low", "close", "volume"))]
                for c in range(n_hist - limit, n_hist + 1)]

    def get_open_interest(self, symbol: str) -> float:
        raise ConnectionError("open interest unavailable")


class Backend(treplay.StubSession):
    """The binbot backend: KuCoin futures settings with autotrade off, the
    universe, a hot and falling breadth."""

    def __init__(self) -> None:
        super().__init__(BREADTH)

    def request(self, method: str, url: str, **kwargs):
        if url.endswith("/autotrade-settings/bots"):
            return self._Resp({"data": {"autotrade": False, "exchange_id": "kucoin",
                                        "market_type": "futures"}})
        if url.endswith("/symbols"):
            return self._Resp({"data": [{"id": n, "futures_leverage": 5.0} for n in NAMES]})
        return super().request(method, url, **kwargs)


class Wire:
    """One fake KuCoin websocket connection (the universe fits one):
    records the subscribed topics, serves what :meth:`push` queues."""

    def __init__(self) -> None:
        self.topics: list[str] = []
        self.queue: asyncio.Queue | None = None
        self.reading = False

    def connect(self, url: str):
        wire = self

        class Ws:
            async def send(self, msg: str) -> None:
                m = json.loads(msg)
                if m.get("type") == "subscribe":
                    wire.topics.extend(m["topic"].split(":", 1)[1].split(","))

            def __aiter__(self):
                return self

            async def __anext__(self) -> str:
                wire.reading = True
                return await wire.queue.get()

        class Conn:
            async def __aenter__(self):
                wire.queue = asyncio.Queue()
                return Ws()

            async def __aexit__(self, *exc) -> bool:
                return False

        return Conn()

    def token_fetch(self):
        return "wss://test.invalid/endpoint", "token", 3600.0

    def push(self, frames: list[str]) -> None:
        for f in frames:
            self.queue.put_nowait(f)


def _frame(symbol: str, interval: str, ts_s: int, m: dict, r: int, c: int) -> str:
    candles = [str(ts_s)] + [repr(float(m[k][r, c])) for k in ("open", "high", "low", "close",
                                                                "volume")]
    return json.dumps({"type": "message", "topic": f"/contractMarket/limitCandle:{symbol}_{interval}",
                       "subject": "candle.stick", "data": {"symbol": symbol, "candles": candles}})


def bursts(m5: dict, m15: dict) -> list:
    """Burst 0 opens live bar 0; burst k sends 5m bars 3k-2..3k and 15m bar
    k, whose arrival closes the bars before them (each bar one frame)."""
    out = []
    for k in range(LIVE_TICKS + 1):
        frames = []
        for r, name in enumerate(NAMES):
            cols5 = [0] if k == 0 else [3 * k - 2, 3 * k - 1, 3 * k]
            for c in cols5:
                frames.append(_frame(name, "5min", _ts(300, 1200 + c, 1200), m5, r, 1200 + c))
            frames.append(_frame(name, "15min", _ts(900, 400 + k, 400), m15, r, 400 + k))
        out.append(frames)
    return out


class Clock:
    """The driven milliseconds, and a ``time`` module whose ``time()``
    reads them (the reference's pipeline takes its tick time from it)."""

    def __init__(self) -> None:
        self.ms = T_LIVE0 * 1000

    def __call__(self) -> int:
        return self.ms

    def time(self) -> float:
        return self.ms / 1000.0

    def __getattr__(self, name):
        return getattr(time, name)


async def _drive_session(engine_ref: dict, wire: Wire, clock: Clock, frames: list, task) -> None:
    async def until(cond, what: str) -> None:
        t0 = time.perf_counter()
        while not cond():
            if task.done():
                task.result()
                raise AssertionError(f"the service stopped while waiting for {what}")
            assert time.perf_counter() - t0 < 120, what
            await asyncio.sleep(0.002)

    await until(lambda: wire.reading and len(wire.topics) == 2 * CAPACITY, "the subscription")
    wire.push(frames[0])
    # the port's engine keeps its backfill's stats; the reference's drive
    # marks the end of its backfill itself
    await until(lambda: engine_ref.get("ready") or getattr(
        engine_ref.get("engine"), "backfill_stats", None), "the backfill")
    engine = engine_ref["engine"]
    for k in range(1, LIVE_TICKS + 1):
        clock.ms = (T_LIVE0 + 900 * k) * 1000
        ticks0 = engine.ticks_processed
        engine_ref["tick"] = k
        wire.push(frames[k])
        await until(lambda: engine.ticks_processed > ticks0 and not engine._pending,
                    f"live tick {k}")
    task.cancel()
    with pytest.raises(asyncio.CancelledError):
        await task


def _record(engine_ref: dict, engine, delivered: list) -> None:
    engine_ref["engine"] = engine
    admit = engine.at_consumer.process_autotrade_restrictions

    async def received(result):
        delivered.append((engine_ref["tick"], result.algorithm_name, result.symbol,
                          str(result.direction), bool(result.autotrade), float(result.score)))
        await admit(result)

    engine.at_consumer.process_autotrade_restrictions = received


def run_port(m5, m15, frames, tmp: Path) -> list:
    from binquant_tpu_torch.config import Config

    wire, clock, delivered, ref = Wire(), Clock(), [], {"tick": 0}
    config = Config(
        max_symbols=CAPACITY, window_bars=WINDOW, pipeline_depth=0, incremental=False,
        donate=False, numeric_digest=False, ingest_digest=False, drift_meter=False,
        outcomes_enabled=False, delivery_enabled=False, trace_sample=0.0,
        freshness_enabled=False, host_phase_enabled=False, slo_enabled=False,
        delivery_health_enabled=False, fanout_enabled=False, env="CI", metrics_port=0,
        fanout_port=0, checkpoint_path="", event_log="", telegram_user_id="t",
        heartbeat_path=str(tmp / "port.heartbeat"),
        log_level="WARNING",  # the root logger's default: later tests see no change
    )

    async def transport(chat_id, text):
        pass

    async def go():
        task = asyncio.create_task(tmain.run_live(
            "cpu", config=config, binbot_session=Backend(), telegram_transport=transport,
            futures_api=Futures(m5, m15), ws_connect=wire.connect,
            ws_token_fetch=wire.token_fetch, clock=clock, tick_interval_s=0.0,
            backfill_chunk=CAPACITY, on_engine=lambda e: _record(ref, e, delivered),
        ))
        await _drive_session(ref, wire, clock, frames, task)

    asyncio.run(go())
    return delivered


def run_reference(m5, m15, frames, monkeypatch) -> list:
    """The reference's engine booted the way ``main.py`` boots it, over the
    same fakes, its pipeline's wall clock replaced by the driven one."""
    from binquant_tpu.config import Config
    from binquant_tpu.io import pipeline as jpipeline
    from binquant_tpu.io.autotrade import AutotradeConsumer
    from binquant_tpu.io.binbot import BinbotApi
    from binquant_tpu.io.exchanges import make_history_fetcher
    from binquant_tpu.io.telegram import TelegramConsumer
    from binquant_tpu.io.websocket import (
        WebsocketClientFactory,
        filter_fiat_symbols,
        kucoin_futures_ids,
    )

    wire, clock, delivered, ref = Wire(), Clock(), [], {"tick": 0}
    monkeypatch.setattr(jpipeline, "time", clock)
    Config.reset()
    config = Config()
    config.__dict__.update(max_symbols=CAPACITY, window_bars=WINDOW, pipeline_depth=0)

    async def transport(chat_id, text):
        pass

    async def go():
        binbot = BinbotApi("http://stub", session=Backend())
        settings = binbot.get_autotrade_settings()
        symbols = binbot.get_symbols()
        at = AutotradeConsumer(
            autotrade_settings=settings, active_test_bots=[], all_symbols=symbols,
            test_autotrade_settings=binbot.get_test_autotrade_settings(),
            active_grid_ladders=[], binbot_api=binbot,
        )
        futures = Futures(m5, m15)
        engine = jpipeline.SignalEngine(
            config=config, binbot_api=binbot,
            telegram_consumer=TelegramConsumer(token="", chat_id="t", transport=transport),
            at_consumer=at, futures_api=futures, window=WINDOW, btc_symbol="XBTUSDTM",
            pipeline_depth=0,
        )
        _record(ref, engine, delivered)
        tracked = kucoin_futures_ids(filter_fiat_symbols(symbols))
        engine.prune_symbols(tracked + ["XBTUSDTM"])
        queue: asyncio.Queue = asyncio.Queue()
        connector = WebsocketClientFactory(
            queue, symbols, exchange_id="kucoin", market_type="futures",
            connect=wire.connect, token_fetch=wire.token_fetch,
        ).create_connector()
        await connector.start_stream()

        async def service():
            try:
                await asyncio.to_thread(
                    engine.backfill, tracked,
                    make_history_fetcher(futures, "kucoin", market_type="futures"),
                    None, CAPACITY,
                )
                ref["ready"] = True
                await asyncio.gather(
                    engine.consume_loop(queue, tick_interval_s=0.0),
                    engine.oi_cache.refresh_forever(lambda: engine.registry.names),
                )
            finally:
                await connector.stop()

        await _drive_session(ref, wire, clock, frames, asyncio.create_task(service()))

    asyncio.run(go())
    return delivered


def test_run_live_delivers_the_reference_signals(monkeypatch, tmp_path):
    m5, m15 = live_market()
    frames = bursts(m5, m15)
    port = run_port(m5, m15, frames, tmp_path)
    ref = run_reference(m5, m15, frames, monkeypatch)
    key = lambda t: t[:5]  # noqa: E731
    port, ref = sorted(port, key=key), sorted(ref, key=key)
    assert [t[:5] for t in port] == [t[:5] for t in ref]
    assert {t[0] for t in ref} >= {1} and len(ref) >= 3  # signals on the live ticks
    assert any(t[1] == "liquidation_sweep_pump" for t in ref)
    np.testing.assert_allclose([t[5] for t in port], [t[5] for t in ref], rtol=1e-4, atol=1e-5)
