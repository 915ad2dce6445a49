"""Completeness guard: every public name of ``binquant_tpu`` has its
counterpart in the port's module of the same name.

The two packages' sources are walked as ASTs (nothing is imported). A
module's public names are its top-level functions, classes and assigned
names not starting with ``_``, and a public class's public methods, its
bases' in the same module included. Every public name and method of a
reference module must exist in the port's module at the same path, as a
name, a method, or a class-level field (a dataclass field stands for the
reference's cached accessor of the same name), but for the two written
lists below:

* :data:`RENAMED` — the port holds it under another name or module, each
  with its reason; the target must exist;
* :data:`WAITING` — not ported, each with its reason (ROADMAP lists them).
"""

from __future__ import annotations

import ast
import shutil
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
REF, PORT = ROOT / "binquant_tpu", ROOT / "binquant_tpu_torch"

RENAMED = {
    "ops/pallas_rolling.py:rolling_quantile_tail_pallas": (
        "ops/quantile_tail.py:rolling_quantile_tail",
        "the TPU kernel's launcher: the port's wrapper launches the Hopper kernel",
    ),
    "ops/pallas_rolling.py:rolling_quantile_tail_auto": (
        "ops/quantile_tail.py:rolling_quantile_tail",
        "the kernel-or-XLA dispatch: the wrapper is the dispatch (CUDA tensor: the "
        "kernel; CPU tensor: the twin)",
    ),
    "ops/rolling.py:rolling_quantile_tail": (
        "ops/quantile_tail.py:rolling_quantile_tail",
        "the windowed-sort version the kernel replaces lives beside the kernel",
    ),
    "engine/step.py:tick_step_donated": (
        "engine/step.py:tick_step_wire_inplace",
        "the donated step: the port writes the rings in place",
    ),
    "engine/step.py:tick_step_wire_donated": (
        "engine/step.py:tick_step_wire_inplace",
        "the donated wire step: the port writes the rings in place",
    ),
    "engine/step.py:tick_step_wire_db": (
        "engine/step.py:into_ring_slot",
        "the double-buffered donated step: a recycled ring slot, then the in-place step",
    ),
    "config.py:Config.incremental_enabled": (
        "config.py:Config.incremental", "the switch's field name in the port's dataclass",
    ),
    "config.py:Config.donate_enabled": (
        "config.py:Config.donate", "the switch's field name in the port's dataclass",
    ),
}

_COMPILE = "the XLA compile ledger and its instruments: the port compiles nothing per shape"
_REFDIFF = ("drives the upstream binquant source from a checkout of it, which is not in "
            "the repository")
WAITING = {
    "config.py:Config.reset": "clears the reference's process-wide singleton; the port's "
                              "Config is built anew by each caller",
    "engine/step.py:pad_updates": "buckets update shapes for XLA's compile cache; the port "
                                  "compiles nothing per shape",
    "engine/step.py:observe_dispatch": "feeds the reference's recompile ledger: " + _COMPILE,
    "engine/step.py:tick_step_scan_donated": "serves only the reference bench's throughput "
                                             "arms",
    "strategies/params.py:DynamicParams": "carries parameters through a jit/vmap boundary "
                                          "the port does not have",
    "strategies/params.py:DynamicParams.tree_flatten": "a jax pytree hook of DynamicParams",
    "strategies/params.py:DynamicParams.tree_unflatten": "a jax pytree hook of DynamicParams",
    "strategies/params.py:dynamic_params": "builds DynamicParams (see there)",
    "ops/pallas_rolling.py:micro_bench": "the TPU kernel's micro-benchmark; chip_smoke.py "
                                         "phase 2 times the Hopper kernel",
    "ops/pallas_rolling.py:pallas_available": "asks whether Pallas can run; the port's "
                                              "wrapper launches the kernel or raises",
    "obs/instruments.py:EXECUTABLE_BYTES": _COMPILE,
    "obs/instruments.py:EXECUTABLE_FLOPS": _COMPILE,
    "obs/instruments.py:JIT_RECOMPILES": _COMPILE,
    "obs/ledger.py:abstract_args": _COMPILE,
    "obs/ledger.py:lowered_cost": _COMPILE,
    "obs/ledger.py:log": "the compile ledger's logger: " + _COMPILE,
    "obs/ledger.py:ExecutableLedger.compute_costs": _COMPILE,
    "obs/ledger.py:ExecutableLedger.emit_summary_when_quiet": _COMPILE,
    "obs/ledger.py:ExecutableLedger.reset": _COMPILE,
    "obs/ledger.py:ExecutableLedger.watch": _COMPILE,
    "obs/numeric.py:log": "a module logger the reference defines and never uses",
    "refdiff/*": _REFDIFF,
}


def _class_members(cls: ast.ClassDef, classes: dict[str, ast.ClassDef], fields: bool,
                   seen=()) -> set[str]:
    names = set()
    for node in cls.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            names.add(node.name)
        elif fields and isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            names.add(node.target.id)
        elif fields and isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets if isinstance(t, ast.Name))
    for base in cls.bases:
        if isinstance(base, ast.Name) and base.id in classes and base.id not in seen:
            names |= _class_members(classes[base.id], classes, fields, (*seen, cls.name))
    return {n for n in names if not n.startswith("_")}


def public_names(path: Path, fields: bool = True) -> set[str]:
    """``name`` for each public top-level name, ``Class.member`` for each
    public method of a public class (and each class-level field, with
    ``fields``)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    classes = {n.name: n for n in tree.body if isinstance(n, ast.ClassDef)}
    out: set[str] = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            if node.name.startswith("_"):
                continue
            out.add(node.name)
            if isinstance(node, ast.ClassDef):
                out |= {f"{node.name}.{m}" for m in _class_members(node, classes, fields)}
        elif isinstance(node, ast.Assign):
            out |= {t.id for t in node.targets
                    if isinstance(t, ast.Name) and not t.id.startswith("_")}
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            if not node.target.id.startswith("_"):
                out.add(node.target.id)
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            # a name re-exported at the top (``from x import y``) counts
            out |= {(a.asname or a.name).split(".")[0] for a in node.names
                    if not (a.asname or a.name).startswith("_")}
    return out


def _defined(path: Path) -> set[str]:
    """The reference module's own names and methods: imports excluded."""
    tree = ast.parse(path.read_text(), filename=str(path))
    imported = {(a.asname or a.name).split(".")[0] for node in tree.body
                if isinstance(node, (ast.Import, ast.ImportFrom)) for a in node.names}
    return {n for n in public_names(path, fields=False) if n not in imported}


def _port_has(key: str, port_root: Path = PORT) -> bool:
    rel, name = key.split(":")
    path = port_root / rel
    return path.exists() and name in public_names(path)


def missing_names(port_root: Path = PORT) -> list[str]:
    missing = []
    for ref in sorted(REF.rglob("*.py")):
        rel = ref.relative_to(REF).as_posix()
        if f"{rel.split('/')[0]}/*" in WAITING:
            continue
        port = port_root / rel
        have = public_names(port) if port.exists() else set()
        for name in sorted(_defined(ref)):
            key = f"{rel}:{name}"
            if name in have or key in WAITING:
                continue
            if key in RENAMED and _port_has(RENAMED[key][0], port_root):
                continue
            missing.append(key)
    return missing


def test_every_public_name_has_a_counterpart_or_a_written_reason():
    assert missing_names() == []


def test_the_lists_are_live_and_reasoned():
    """No entry outlives its name: each one names something the reference
    still has, the port lacks under that name, and a reason; each rename's
    target exists in the port."""
    for key, (target, reason) in RENAMED.items():
        rel, name = key.split(":")
        assert name in _defined(REF / rel), key
        assert not _port_has(key), f"{key} is ported under its own name"
        assert _port_has(target), target
        assert reason
    for key, reason in WAITING.items():
        assert reason, key
        rel, name = key.split(":") if ":" in key else (key, None)
        if name is None:
            assert (REF / rel.removesuffix("/*")).is_dir(), key
            continue
        assert name in _defined(REF / rel), key
        assert not _port_has(key), f"{key} is ported: take it off the waiting list"


def test_the_walk_sees_the_names_it_guards(tmp_path):
    """The guard is not vacuous: it finds the reference's names, a name
    and a method removed from a copy of the port are reported, and the
    fields of a dataclass and the methods of a base class count."""
    copy = tmp_path / "port"
    shutil.copytree(PORT, copy, ignore=shutil.ignore_patterns("__pycache__", "*.cu"))
    buffer = copy / "engine" / "buffer.py"
    buffer.write_text(buffer.read_text().replace("def s_to_ms(", "def _s_to_ms(")
                      .replace("def rows_for(", "def _rows_for("))
    assert missing_names(copy) == ["engine/buffer.py:SymbolRegistry.rows_for",
                                   "engine/buffer.py:s_to_ms"]
    assert len({n for p in REF.rglob("*.py") for n in _defined(p)}) > 800
    assert "Config.postgres_dsn" in public_names(PORT / "config.py")
    assert "KlinesConnector.start_stream" in public_names(PORT / "io" / "websocket.py")
    assert "MarketBuffer.latest_times" in public_names(PORT / "engine" / "buffer.py")
    assert "apply_updates_shift" in _defined(REF / "engine" / "buffer.py")
