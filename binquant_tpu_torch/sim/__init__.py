"""Scenario engine and chaos lane.

``scenarios`` — the composable adversarial market generator layered on
``io/market_sim.py``'s GARCH base stream, emitting the kline-stream format
``run_replay`` consumes (plus the optional ``_deliver_bucket`` transport
key for delivery-scripted faults).

``chaos`` — fault injection at the transport and sink boundary: a scripted
websocket connection factory, flaky wrappers for the binbot session, the
Telegram transport and the delivery sinks, and the three drills (the
websocket, delivery-plane and fan-out-plane chaos drills).

``runner`` — drives every scenario scanned AND serial through the full
engine with signal-set equality, the pinned-corpus comparison and the
graceful-degradation invariants checked after each run
(``python -m binquant_tpu_torch --scenario``).
"""

from binquant_tpu_torch.sim.scenarios import (  # noqa: F401
    SCENARIOS,
    Scenario,
    ScenarioSpec,
    write_scenario_file,
)
