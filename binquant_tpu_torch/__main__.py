"""The port as a service: ``python -m binquant_tpu_torch``.

The port's own entry point, doing what the JAX package's root ``main.py``
does, in the same order, with nothing of the JAX package:

1. the binbot client and the settings reads (autotrade settings, paper
   trading settings, the symbol list);
2. the three consumers (Telegram, autotrade admission, the binbot client);
3. the market: the exchange and market type of the autotrade settings,
   ``XBTUSDTM`` as BTC on KuCoin futures;
4. ``SignalEngine`` with the KuCoin futures client as its open-interest
   source;
5. the checkpoint restore (``BQT_CHECKPOINT_PATH``);
6. ``prune_symbols`` to the tracked universe;
7. the websocket connector, started BEFORE the backfill, so bars closing
   during the backfill wait in the queue;
8. the REST backfill through :func:`make_history_fetcher`;
9. the profiler controller, and SIGUSR2 for a 10-second window;
10. ``/metrics`` and ``/healthz`` when ``BQT_METRICS_PORT`` is set;
11. the fan-out hub when ``BQT_FANOUT_PORT`` is set;
12. the consume loop beside the open-interest refresh.

Offline modes, without network: ``--replay FILE`` (the serial drive, or
``--scanned``), ``--backtest`` (the time-batched backend), ``--backend
reference`` (the legacy per-symbol backend, on the host) and ``--backend
ab`` (the engine and that backend on one replay, exit 1 when their signal
sets differ: the port's strongest correctness drive), ``--scenario
NAME|all|list`` (the scenario corpus and the chaos drills,
``sim/runner.py``), with ``main.py``'s argument checks; ``--replay-report`` is accepted as there,
and the run's statistics are printed either way. ``--device`` (``cuda`` by
default) picks the card; without one the command fails, and it runs on the
CPU only when asked (``--device cpu``). The settings are ``Config``'s,
read from the reference's environment variables, and validated where the
reference validates them: the live service builds its ``Config()`` first
and, outside ``ENV=CI``, fails with ``ConfigurationError`` before any
client is built when a required variable is missing; the offline modes
validate inside the stub engines they build, which read an unset ``ENV``
as ``CI`` as the reference's stub does.

:func:`run_live` takes keyword seams for every client that leaves the
process (the binbot backend's session, the Telegram transport, the futures
client that serves open interest and, on KuCoin futures, the history, the
history client of the other markets, the websocket ``connect`` and
``token_fetch``), each the real one by default, so tests and
``chip_smoke.py`` run the whole service over fakes.
"""

from __future__ import annotations

import argparse
import asyncio
import logging
import os
import sys
from collections.abc import Callable
from typing import Any


def configure_logging(level: str = "INFO") -> None:
    logging.basicConfig(
        level=getattr(logging, level.upper(), logging.INFO),
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
    )


def install_event_log(path: str) -> None:
    """Install the process event log at ``path`` (``BQT_EVENT_LOG``); an
    empty path leaves it off."""
    if path:
        from binquant_tpu_torch.obs.events import EventLog, set_event_log

        set_event_log(EventLog(path))


def _event_log_path() -> str:
    """``BQT_EVENT_LOG`` for the offline modes, read without building a
    ``Config``: the stub engines those modes build validate the settings."""
    return os.environ.get("BQT_EVENT_LOG", "")


async def run_live(
    device: str | None = "cuda",
    *,
    config=None,
    binbot_session: Any = None,
    telegram_transport: Callable | None = None,
    futures_api: Any = None,
    history_api: Any = None,
    ws_connect: Callable | None = None,
    ws_token_fetch: Callable | None = None,
    connector_options: dict | None = None,
    clock: Callable[[], int] | None = None,
    tick_interval_s: float = 1.0,
    backfill_chunk: int = 50,
    on_engine: Callable | None = None,
) -> None:
    """Run the live service until cancelled.

    The seams (None: the real client): ``binbot_session`` is the binbot
    REST client's session, ``telegram_transport`` the Telegram consumer's
    transport, ``futures_api`` the KuCoin futures client (open interest,
    contract terms, and the history on KuCoin futures), ``history_api`` the
    REST history client on the other markets, ``ws_connect`` /
    ``ws_token_fetch`` the websocket connection factory and KuCoin's bullet
    handshake, ``connector_options`` the connector's reconnect settings.
    ``clock`` gives the service's milliseconds (the tick clock, the
    backfill's cut-off, and, in seconds, the open-interest cache's clock;
    the wall clock and ``time.monotonic`` when None); ``tick_interval_s``
    is the consume loop's tick cadence and ``backfill_chunk`` the
    backfill's flush cadence in symbols. ``on_engine(engine)`` is called
    once the engine is built, before the restore."""
    from binquant_tpu_torch import resolve_device
    from binquant_tpu_torch.config import Config
    from binquant_tpu_torch.io.autotrade import AutotradeConsumer
    from binquant_tpu_torch.io.binbot import BinbotApi
    from binquant_tpu_torch.io.checkpoint import CheckpointManager
    from binquant_tpu_torch.io.exchanges import (
        BinanceApi,
        KucoinApi,
        KucoinFutures,
        make_history_fetcher,
    )
    from binquant_tpu_torch.io.pipeline import SignalEngine
    from binquant_tpu_torch.io.telegram import TelegramConsumer
    from binquant_tpu_torch.io.websocket import (
        WebsocketClientFactory,
        filter_fiat_symbols,
        kucoin_futures_ids,
        kucoin_spot_api_symbol,
    )
    from binquant_tpu_torch.obs.tracing import ProfileController

    # no card, no service: fail before any client is built or called
    resolve_device(device)
    config = config or Config()
    configure_logging(config.log_level)
    install_event_log(config.event_log)
    binbot_api = BinbotApi(
        config.binbot_api_url,
        session=binbot_session,
        timeout_s=config.binbot_timeout_s,
        retry_max=config.binbot_retry_max,
        retry_backoff_s=config.binbot_retry_backoff_s,
    )
    autotrade_settings = binbot_api.get_autotrade_settings()
    test_settings = binbot_api.get_test_autotrade_settings()
    all_symbols = binbot_api.get_symbols()

    futures_api = futures_api if futures_api is not None else KucoinFutures()
    telegram_consumer = TelegramConsumer(
        token=config.telegram_bot_token, chat_id=config.telegram_user_id,
        transport=telegram_transport,
    )
    at_consumer = AutotradeConsumer(
        autotrade_settings=autotrade_settings,
        active_test_bots=binbot_api.get_active_pairs("paper_trading"),
        all_symbols=all_symbols,
        test_autotrade_settings=test_settings,
        active_grid_ladders=binbot_api.get_active_grid_ladders(),
        binbot_api=binbot_api,
        kucoin_futures_api=futures_api,
    )
    exchange_id = str(autotrade_settings.exchange_id)
    market_type = str(getattr(autotrade_settings.market_type, "value",
                              autotrade_settings.market_type))
    is_kucoin = exchange_id.lower().startswith("kucoin")
    is_futures = market_type.lower().endswith("futures")
    # the KuCoin futures universe has no BTCUSDT row: the XBTUSDTM contract is BTC
    btc_symbol = "XBTUSDTM" if (is_kucoin and is_futures) else "BTCUSDT"

    engine = SignalEngine(
        config,
        binbot_api,
        telegram_consumer,
        at_consumer,
        window=config.window_bars,
        device=device,
        btc_symbol=btc_symbol,
        pipeline_depth=config.pipeline_depth,
        futures_api=futures_api,
    )
    if clock is not None:
        engine.oi_cache.clock = lambda: clock() / 1000.0
    if on_engine is not None:
        on_engine(engine)

    if config.checkpoint_path:
        engine.checkpoint = CheckpointManager(
            config.checkpoint_path, every_ticks=config.checkpoint_every_ticks
        )
        engine.checkpoint.try_restore(engine)

    fiat_filtered = filter_fiat_symbols(all_symbols)
    api_symbol_of = None
    if is_kucoin and is_futures:
        # the universe and the client the websocket subscription uses
        tracked = kucoin_futures_ids(fiat_filtered)
        history_api = futures_api
    elif is_kucoin:
        # the engine tracks undashed ids; KuCoin spot REST wants BASE-QUOTE
        dash = {s.id: kucoin_spot_api_symbol(s) for s in fiat_filtered}
        tracked = [s.id for s in fiat_filtered]
        history_api = history_api if history_api is not None else KucoinApi()
        api_symbol_of = lambda sym: dash.get(sym, sym)  # noqa: E731
    else:
        tracked = [s.id for s in fiat_filtered]
        history_api = history_api if history_api is not None else BinanceApi()
    # a restored archive can hold symbols that left the universe
    engine.prune_symbols(tracked + [btc_symbol])

    queue: asyncio.Queue = asyncio.Queue()
    factory = WebsocketClientFactory(
        queue, all_symbols, exchange_id=exchange_id, market_type=market_type,
        connect=ws_connect, token_fetch=ws_token_fetch,
    )
    connector = factory.create_connector(**(connector_options or {}))
    await connector.start_stream()
    metrics_server = None
    loop = asyncio.get_running_loop()
    sigusr2 = None
    try:
        await asyncio.to_thread(
            engine.backfill,
            tracked,
            make_history_fetcher(history_api, exchange_id, market_type=market_type,
                                 api_symbol_of=api_symbol_of),
            None if clock is None else clock(),
            backfill_chunk,
        )
        import signal as signal_module

        profile_controller = ProfileController(log_dir=config.profile_dir)
        sigusr2 = getattr(signal_module, "SIGUSR2", None)
        if sigusr2 is not None:
            try:
                loop.add_signal_handler(sigusr2, lambda: profile_controller.start_window(10.0))
            except (NotImplementedError, RuntimeError, ValueError):
                sigusr2 = None  # no loop signal handlers here
        if config.metrics_port:
            from binquant_tpu_torch.obs.exposition import MetricsServer
            from binquant_tpu_torch.obs.ledger import LEDGER

            metrics_server = MetricsServer(
                health_fn=lambda: engine.health_snapshot(config.heartbeat_max_age_s),
                port=config.metrics_port,
                profiler=profile_controller,
                # /debug/profile opens a window: loopback only unless allowed
                profile_remote_ok=config.profile_remote_ok,
                ledger=LEDGER,
                ingest=engine.ingest_monitor,
                slo=engine.slo,
            )
            await metrics_server.start()
        if engine.fanout is not None and config.fanout_port:
            port = await engine.fanout.serve(config.fanout_port, host=config.fanout_host)
            logging.info("fanout hub serving ws/sse on port %d", port)
        logging.info("binquant_tpu_torch started on %s: %d symbols tracked",
                     engine.device, len(all_symbols))
        # the open-interest refresh runs beside the ticks; a tick only reads
        # its cache
        await asyncio.gather(
            engine.consume_loop(queue, tick_interval_s=tick_interval_s, clock=clock),
            engine.oi_cache.refresh_forever(lambda: engine.registry.names),
        )
    finally:
        await connector.stop()
        if metrics_server is not None:
            await metrics_server.stop()
        if sigusr2 is not None:
            loop.remove_signal_handler(sigusr2)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="python -m binquant_tpu_torch")
    parser.add_argument("--replay", help="JSONL kline file for offline replay")
    parser.add_argument("--replay-report", action="store_true")
    parser.add_argument(
        "--scanned",
        action="store_true",
        help="drive the replay through the scanned multi-tick drive (runs of "
        "clean-append incremental ticks fused into chunks); the emitted signal "
        "set is the serial drive's",
    )
    parser.add_argument(
        "--backtest",
        action="store_true",
        help="drive the replay through the time-batched backtest backend "
        "(full-recompute semantics, one dispatch per chunk of ticks); the "
        "emitted signal set is the serial full-recompute drive's",
    )
    parser.add_argument(
        "--scenario",
        help="run the adversarial scenario engine: a scenario name from "
        "binquant_tpu_torch/sim, 'all' for the whole corpus and the three "
        "chaos drills, or 'list'. Each scenario is driven scanned AND serial "
        "and through the full-recompute oracle, with signal-set equality, the "
        "pinned corpus and the graceful-degradation invariants asserted; "
        "verdicts also land in the event log (BQT_EVENT_LOG)",
    )
    parser.add_argument(
        "--backend",
        choices=("batch", "reference", "ab"),
        default="batch",
        help="the replay's backend: 'batch' (the batched engine), 'reference' "
        "(the legacy per-symbol backend, on the host) or 'ab' (both on one "
        "replay; exits 1 when their signal sets differ)",
    )
    parser.add_argument(
        "--device",
        default="cuda",
        help="the torch device to run on (default cuda; the command fails "
        "without a card unless --device cpu is given)",
    )
    return parser


def main(argv: list[str] | None = None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.scenario:
        if args.replay or args.scanned or args.backtest or args.backend != "batch":
            parser.error(
                "--scenario runs the sim corpus on its own drives (serial "
                "+ scanned + full-oracle); combining it with --replay/"
                "--backend/--scanned/--backtest would be silently ignored"
            )
        from binquant_tpu_torch.sim.runner import main_cli

        install_event_log(_event_log_path())
        return main_cli(args.scenario, device=args.device)
    if args.backend != "batch" and not args.replay:
        parser.error("--backend reference/ab requires --replay")
    if args.scanned and not args.replay:
        parser.error("--scanned requires --replay")
    if args.backtest and (not args.replay or args.scanned):
        parser.error("--backtest requires --replay and excludes --scanned")
    if args.backtest and args.backend != "batch":
        parser.error(
            "--backtest drives the batched backend only (it would be silently "
            "ignored with --backend reference/ab)"
        )

    if args.replay:
        install_event_log(_event_log_path())
        if args.backend == "reference":
            from binquant_tpu_torch.io.replay import run_replay_oracle

            signals = run_replay_oracle(args.replay)
            print({"backend": "reference", "signals": len(signals)})
            return 0
        if args.backend == "ab":
            from binquant_tpu_torch.io.replay import run_replay_ab

            result = run_replay_ab(args.replay, scanned=args.scanned, device=args.device)
            print(result)
            print(f"match: {result['match']}")
            return 0 if result["match"] else 1
        if args.backtest:
            from binquant_tpu_torch.backtest import run_backtest

            print(run_backtest(args.replay, device=args.device))
            return 0
        from binquant_tpu_torch.io.replay import run_replay

        print(run_replay(args.replay, scanned=args.scanned, device=args.device))
        return 0

    asyncio.run(run_live(device=args.device))
    return 0


if __name__ == "__main__":
    sys.exit(main())
