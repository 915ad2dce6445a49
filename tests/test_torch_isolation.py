"""The port stands alone: no JAX, nothing of the reference package, no
pydantic, no pandas (and its per-symbol oracle nothing of the batched
path), ``httpx`` only where a network client is built without a session
or transport (and then only at its first request, but for the binbot
client), ``websockets`` only where a connector is built without a
connection factory, ``urllib.request`` only in the AI report's default
fetch, and no silent CPU fallback at its entry points. ``import torch``
itself loads ``torch.profiler``, so the import check asserts instead that no
profiler is created until a profiler window opens."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

# small shapes: extra intra-op threads only spin and crowd parallel test workers
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "binquant_tpu_torch"


def test_import_pulls_in_no_jax_and_no_reference_module():
    code = (
        "import sys\n"
        "import binquant_tpu_torch.io.replay, binquant_tpu_torch.engine.convert\n"
        "import binquant_tpu_torch.obs.numeric, binquant_tpu_torch.obs.ingest\n"
        "import binquant_tpu_torch.strategies.dormant, binquant_tpu_torch.strategies.spike_hunter\n"
        "import binquant_tpu_torch.obs.outcomes, binquant_tpu_torch.obs.events\n"
        "import binquant_tpu_torch.obs.registry, binquant_tpu_torch.obs.instruments\n"
        "import binquant_tpu_torch.exceptions, binquant_tpu_torch.io.binbot\n"
        "import binquant_tpu_torch.io.leverage, binquant_tpu_torch.io.checkpoint\n"
        "import binquant_tpu_torch.strategies.market_regime_notifier\n"
        "import binquant_tpu_torch.io.delivery, binquant_tpu_torch.io.telegram\n"
        "import binquant_tpu_torch.io.autotrade, binquant_tpu_torch.io.exchanges\n"
        "import binquant_tpu_torch.io.emission, binquant_tpu_torch.obs.tracing\n"
        "import binquant_tpu_torch.obs.latency, binquant_tpu_torch.obs.slo\n"
        "import binquant_tpu_torch.obs.delivery_health, binquant_tpu_torch.obs.exposition\n"
        "import binquant_tpu_torch.obs.ledger, binquant_tpu_torch.io.metrics\n"
        "import binquant_tpu_torch.io.websocket\n"
        "import binquant_tpu_torch.fanout, binquant_tpu_torch.fanout.snapshot\n"
        "import binquant_tpu_torch.backtest, binquant_tpu_torch.backtest.kernel\n"
        "import binquant_tpu_torch.backtest.driver\n"
        "import binquant_tpu_torch.__main__, binquant_tpu_torch.utils\n"
        "import binquant_tpu_torch.parallel, binquant_tpu_torch.parallel.mesh\n"
        "import binquant_tpu_torch.strategies.binance_report_ai\n"
        "import binquant_tpu_torch.io.market_sim, binquant_tpu_torch.sim\n"
        "import binquant_tpu_torch.sim.scenarios, binquant_tpu_torch.sim.runner\n"
        "import binquant_tpu_torch.sim.chaos, binquant_tpu_torch.soak\n"
        "import binquant_tpu_torch.soak.judge, binquant_tpu_torch.soak.stream\n"
        "import binquant_tpu_torch.soak.drill\n"
        "import binquant_tpu_torch.oracle, binquant_tpu_torch.oracle.frame\n"
        "import binquant_tpu_torch.oracle.evaluator, binquant_tpu_torch.ops.indicators\n"
        "import binquant_tpu_torch.regime.routing, binquant_tpu_torch.regime.time_filter\n"
        "import binquant_tpu_torch.tools, binquant_tpu_torch.tools.profile_stages\n"
        "import binquant_tpu_torch.tools.sweep_report, binquant_tpu_torch.tools.scenario_report\n"
        "import binquant_tpu_torch.tools.outcome_report\n"
        "import asyncio\n"
        "import torch.profiler\n"
        "made = []\n"
        "class Spy(torch.profiler.profile):\n"
        "    def __init__(self, *a, **k):\n"
        "        made.append(1)\n"
        "        super().__init__(*a, **k)\n"
        "torch.profiler.profile = Spy\n"
        "from binquant_tpu_torch.io.emission import FiredSignal\n"
        "from binquant_tpu_torch.io.replay import StubSession, make_stub_engine\n"
        "from binquant_tpu_torch.schemas import BotBase, SignalsConsumer\n"
        "eng = make_stub_engine(capacity=8, window=96, device='cpu')\n"
        "assert eng.delivery is not None and eng.fanout is not None\n"
        "assert eng.fanout._device.device.type == 'cpu'\n"
        "value = SignalsConsumer(autotrade=True, symbol='XUSDT', algorithm_name='mrf',\n"
        "                        bot_params=BotBase(pair='XUSDT', name='mrf'))\n"
        "sig = FiredSignal('mrf', 'XUSDT', 0, value, '- Action: LONG ENTRY\\n#XUSDT', {})\n"
        "async def go():\n"
        "    eng.delivery.enqueue_fired(sig, tick_ms=1000)\n"
        "    assert await eng.delivery.drain(timeout_s=30)\n"
        "    await eng.aclose_delivery()\n"
        "asyncio.run(go())\n"
        "assert len(eng._telegram_sent) == 1 and len(eng._autotrade_received) == 1\n"
        "assert eng.tracer.enabled and eng.slo is not None and eng.delivery_health.enabled\n"
        "# no profiler exists until a window opens; the window builds one\n"
        "assert made == []\n"
        "from binquant_tpu_torch.obs.tracing import ProfileController\n"
        "import tempfile\n"
        "ctl = ProfileController(log_dir=tempfile.mkdtemp())\n"
        "assert ctl.start_window(0.01) == {'started': False, 'reason': 'no_event_loop'}\n"
        "async def window():\n"
        "    assert ctl.start_window(0.01)['started']\n"
        "    await ctl._stop_task\n"
        "asyncio.run(window())\n"
        "assert ctl.closed.is_set() and made == [1] and ctl.last_trace is not None\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'binquant_tpu', 'httpx', 'pydantic', 'websockets', 'pandas'))\n"
        "print(','.join(bad))\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
        timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == ""


def _imported_roots(path: Path) -> set[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


def test_sources_import_no_jax_and_no_reference_package():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    assert {PKG / "backtest" / f for f in ("__init__.py", "kernel.py", "driver.py")} <= set(files)
    assert {PKG / "__main__.py", PKG / "io" / "websocket.py", PKG / "io" / "exchanges.py"} <= set(
        files)
    assert {PKG / "parallel" / "__init__.py", PKG / "parallel" / "mesh.py",
            PKG / "strategies" / "binance_report_ai.py"} <= set(files)
    assert {PKG / "io" / "market_sim.py"} | {
        PKG / "sim" / f for f in ("__init__.py", "scenarios.py", "runner.py", "chaos.py")
    } | {PKG / "soak" / f for f in ("__init__.py", "judge.py", "stream.py", "drill.py")} <= set(
        files)
    assert {PKG / "oracle" / f for f in ("__init__.py", "frame.py", "evaluator.py")} <= set(files)
    assert {PKG / "tools" / f for f in ("__init__.py", "profile_stages.py", "sweep_report.py",
                                        "scenario_report.py", "outcome_report.py")} <= set(files)
    for path in files:
        roots = _imported_roots(path)
        assert not roots & {"jax", "jaxlib", "binquant_tpu", "pydantic", "pandas"}, (path, roots)
        # nothing that opens a connection is imported when a module loads
        top = set()
        for node in ast.parse(path.read_text()).body:
            if isinstance(node, ast.Import):
                top.update(a.name.split(".")[0] for a in node.names)
            elif isinstance(node, ast.ImportFrom) and node.module:
                top.add(node.module.split(".")[0])
        assert not top & {"websockets", "httpx"}, (path, top)


def test_oracle_shares_nothing_with_the_batched_path():
    """The per-symbol oracle is the batched engine's independent check: no
    module of ``oracle/`` imports the port's ``ops``, ``strategies`` or
    ``engine``, directly or through what it imports, and none imports
    pandas (the card's machine has none)."""
    batched = ("binquant_tpu_torch.ops", "binquant_tpu_torch.strategies",
               "binquant_tpu_torch.engine")
    for path in sorted((PKG / "oracle").glob("*.py")):
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            names = (
                [a.name for a in node.names] if isinstance(node, ast.Import)
                else [node.module or ""] if isinstance(node, ast.ImportFrom) else []
            )
            for name in names:
                assert not name.startswith(batched), (path, name)
    code = (
        "import sys\n"
        "import binquant_tpu_torch.oracle.evaluator\n"
        f"print(','.join(sorted(m for m in sys.modules if m.startswith({batched!r}) "
        "or m.split('.')[0] in ('pandas', 'jax', 'binquant_tpu'))))\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == ""


def test_report_ai_reaches_the_network_only_in_its_default_fetch():
    """``strategies/binance_report_ai.py`` imports ``urllib`` only inside
    ``default_fetch``, the one function that POSTs to the endpoint."""
    path = PKG / "strategies" / "binance_report_ai.py"
    tree = ast.parse(path.read_text())
    holders = [
        node.name for node in ast.walk(tree)
        if isinstance(node, ast.FunctionDef)
        and any(isinstance(n, ast.Import) and any(a.name.startswith("urllib") for a in n.names)
                for n in ast.walk(node))
    ]
    assert holders == ["default_fetch"]
    top = {a.name.split(".")[0] for node in tree.body if isinstance(node, ast.Import)
           for a in node.names}
    assert "urllib" not in top


def test_websockets_is_imported_only_where_no_connect_is_given():
    """``websockets`` is imported once in the port: in the connectors'
    shared constructor, in its no-connection-factory branch."""
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    hits = []
    for path in files:
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import) and any(a.name == "websockets" for a in node.names):
                hits.append((path, node, tree))
    assert [p for p, _, _ in hits] == [PKG / "io" / "websocket.py"]
    tree = hits[0][2]
    init = next(n for n in ast.walk(tree) if isinstance(n, ast.ClassDef) and n.name == "_Connector")
    init = next(n for n in init.body if isinstance(n, ast.FunctionDef) and n.name == "__init__")
    branch = next(n for n in ast.walk(init)
                  if isinstance(n, ast.If) and ast.unparse(n.test) == "connect is None")
    assert hits[0][1] in list(ast.walk(branch))


def test_httpx_is_imported_only_where_no_session_is_given():
    """``httpx`` is imported in four places and nowhere else (no other
    port module, nor the smoke script, names it): the binbot client's
    constructor, in its no-session branch; the exchange clients' session,
    in its no-session branch, at the first request; the Telegram bot
    transport's send, which is built only for a consumer with a token and
    no transport; KuCoin's bullet handshake, which runs only for a
    connector built without ``token_fetch``."""
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    allowed = {  # file -> (function holding the import, branch test or None)
        PKG / "io" / "binbot.py": ("__init__", "session is None"),
        PKG / "io" / "exchanges.py": ("session", "self._session is None"),
        PKG / "io" / "telegram.py": ("post", None),
        PKG / "io" / "websocket.py": ("_default_token_fetch", None),
    }
    for path in files:
        tree = ast.parse(path.read_text(), filename=str(path))
        found = [
            node for node in ast.walk(tree)
            if isinstance(node, ast.Import) and any(a.name == "httpx" for a in node.names)
            or isinstance(node, ast.ImportFrom) and (node.module or "").startswith("httpx")
        ]
        if path not in allowed:
            assert not found, path
            continue
        assert len(found) == 1, path
        func, test = allowed[path]
        holder = next(
            n for n in ast.walk(tree)
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)) and n.name == func
        )
        if test is not None:
            holder = next(
                n for n in ast.walk(holder)
                if isinstance(n, ast.If) and ast.unparse(n.test) == test
            )
        assert found[0] in list(ast.walk(holder)), path


@pytest.mark.parametrize(
    "entry", ["make_stub_engine", "SignalEngine", "run_replay", "run_backtest", "run_param_sweep",
              "run_replay_ab", "backend_ab", "profile_stages", "sweep_report"]
)
def test_entry_points_raise_without_cuda_unless_cpu_requested(entry, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible; the no-CUDA refusal cannot be shown")
    from binquant_tpu_torch import __main__ as tmain
    from binquant_tpu_torch.backtest import run_backtest, run_param_sweep
    from binquant_tpu_torch.config import Config
    from binquant_tpu_torch.io import pipeline, replay
    from binquant_tpu_torch.io.autotrade import AutotradeConsumer
    from binquant_tpu_torch.io.telegram import TelegramConsumer
    from binquant_tpu_torch.schemas import (
        AutotradeSettingsSchema,
        TestAutotradeSettingsSchema,
    )
    from binquant_tpu_torch.tools import profile_stages, sweep_report

    def engine(**kw):
        consumer = AutotradeConsumer(
            AutotradeSettingsSchema(), [], [], TestAutotradeSettingsSchema(), [], None
        )
        return pipeline.SignalEngine(
            Config(delivery_wal_path=str(tmp_path / "w.jsonl")), None,
            TelegramConsumer(token="", chat_id="c"), consumer, window=96, **kw,
        )

    calls = {
        # window 96: the incremental engine's minimum ring is 81 bars
        "make_stub_engine": lambda **kw: replay.make_stub_engine(capacity=8, window=96, **kw),
        "SignalEngine": engine,
        "run_replay": lambda **kw: replay.run_replay(tmp_path / "empty.jsonl", **kw),
        "run_backtest": lambda **kw: run_backtest(tmp_path / "empty.jsonl", **kw),
        "run_param_sweep": lambda **kw: run_param_sweep(
            tmp_path / "empty.jsonl", {"pt.rsi_oversold": [25.0, 30.0]}, **kw
        ),
        "run_replay_ab": lambda **kw: replay.run_replay_ab(tmp_path / "empty.jsonl", **kw),
        # the command line: ``--backend ab`` without ``--device cpu``
        "backend_ab": lambda **kw: tmain.main(
            ["--replay", str(tmp_path / "empty.jsonl"), "--backend", "ab"]
            + (["--device", kw["device"]] if kw else [])
        ),
        # the tools: without ``--device`` they take the card
        "profile_stages": lambda **kw: profile_stages.run(
            8, 96, iters=1, warmup=0, **({"device": kw["device"]} if kw else {})
        ),
        "sweep_report": lambda **kw: sweep_report.main(
            [str(tmp_path / "empty.jsonl"), "--axis", "pt.rsi_oversold=25,30"]
            + (["--device", kw["device"]] if kw else [])
        ),
    }
    (tmp_path / "empty.jsonl").write_text("")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        calls[entry]()
    calls[entry](device="cpu")  # the explicit CPU request works


@pytest.mark.parametrize(
    "ctor",
    ["empty_buffer", "initial_regime_carry", "no_signal", "default_host_inputs",
     "initial_engine_state", "engine_state_from_numpy"],
)
def test_state_constructors_take_no_default_device(ctor):
    """State built outside an entry point names its device: none of the
    constructors picks one, so nothing lands on the CPU unasked."""
    from binquant_tpu_torch.engine import buffer, convert, step
    from binquant_tpu_torch.regime import context
    from binquant_tpu_torch.strategies import base

    calls = {
        "empty_buffer": lambda **kw: buffer.empty_buffer(4, 6, **kw),
        "initial_regime_carry": lambda **kw: context.initial_regime_carry(4, **kw),
        "no_signal": lambda **kw: base.no_signal(4, **kw),
        "default_host_inputs": lambda **kw: step.default_host_inputs(4, **kw),
        "initial_engine_state": lambda **kw: step.initial_engine_state(4, 6, **kw),
        "engine_state_from_numpy": lambda **kw: convert.engine_state_from_numpy(
            convert.engine_state_to_numpy(step.initial_engine_state(4, 6, device="cpu")),
            **kw,
        ),
    }
    with pytest.raises(TypeError, match="device"):
        calls[ctor]()
    built = calls[ctor](device="cpu")
    leaves = [t for t in torch.utils._pytree.tree_leaves(built) if isinstance(t, torch.Tensor)]
    assert leaves and all(t.device.type == "cpu" for t in leaves)


@pytest.mark.parametrize("ctor", ["DevicePlanes", "FanoutPlane"])
def test_fanout_planes_take_no_default_device(ctor):
    """The fan-out plane's device copy names its device, as the state
    constructors do: the engine hands it its own."""
    from binquant_tpu_torch.engine.buffer import SymbolRegistry
    from binquant_tpu_torch.fanout import kernel, plane, registry

    def make(**kw):
        if ctor == "DevicePlanes":
            return kernel.DevicePlanes(registry.SubscriptionRegistry(4, capacity=32), **kw)
        return plane.FanoutPlane(SymbolRegistry(4), **kw)._device

    with pytest.raises(TypeError, match="device"):
        make()
    planes = make(device="cpu")
    planes.registry.add(registry.Subscription("amy"))
    assert planes.sync() == "full"
    assert all(t.device.type == "cpu" for t in planes._arrays)
