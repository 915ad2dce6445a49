"""Render scenario-lane verdicts from the JSONL event log: the port of the
root ``tools/scenario_report.py``.

The port's scenario runner (``binquant_tpu_torch/sim/runner.py``, driven by
``python -m binquant_tpu_torch --scenario``) emits one ``scenario_run``
event per corpus entry: signal counts, routing tallies, and every
graceful-degradation invariant's pass or fail. This tool turns an event log
back into the per-scenario verdict table through the runner's own
``render_verdict``, byte for byte the root script's output:

    python -m binquant_tpu_torch.tools.scenario_report /tmp/bqt_scenario_events.jsonl
    python -m binquant_tpu_torch.tools.scenario_report events.jsonl --scenario rewrite_storm
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from binquant_tpu_torch.sim.runner import render_verdict


def load_scenario_events(path: str | Path) -> list[dict]:
    """All ``scenario_run`` events, in file order; corrupt lines (a torn
    write at rotation) are skipped, not fatal."""
    out: list[dict] = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                record = json.loads(line)
            except json.JSONDecodeError:
                continue
            if record.get("event") == "scenario_run":
                out.append(record)
    return out


def render_report(events: list[dict]) -> str:
    lines = [render_verdict(e) for e in events]
    passed = sum(1 for e in events if e.get("ok"))
    lines.append(f"{passed}/{len(events)} scenarios passed")
    return "\n".join(lines)


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("log", help="JSONL event log (BQT_EVENT_LOG file)")
    parser.add_argument(
        "--scenario", help="render only this scenario's verdict"
    )
    args = parser.parse_args(argv)

    events = load_scenario_events(args.log)
    if args.scenario:
        events = [e for e in events if e.get("scenario") == args.scenario]
    if not events:
        print(f"no scenario_run events in {args.log}", file=sys.stderr)
        return 1
    print(render_report(events))
    return 0 if all(e.get("ok") for e in events) else 1


if __name__ == "__main__":
    sys.exit(main())
