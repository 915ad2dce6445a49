"""Render the signal-outcome scoreboard from the JSONL event log: the port
of the root ``tools/outcome_report.py``.

The port's outcome tracker (``binquant_tpu_torch/obs/outcomes.py``) emits
one ``signal_outcome`` event per matured (signal, horizon) pair, joinable
to its ``signal`` event by trace_id/tick_seq. This tool folds an event log
back into the per-(strategy, horizon) scoreboard through the tracker's own
cell, byte for byte the root script's output:

    python -m binquant_tpu_torch.tools.outcome_report /tmp/bqt_outcome_events.jsonl
    python -m binquant_tpu_torch.tools.outcome_report events.jsonl --strategy mean_reversion_fade
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path


def load_outcome_events(path: str | Path) -> list[dict]:
    """All ``signal_outcome`` events, in file order; corrupt lines (a
    torn write at rotation) are skipped, not fatal."""
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
            if record.get("event") == "signal_outcome":
                out.append(record)
    return out


def aggregate(events: list[dict]) -> dict:
    """(strategy, horizon) scoreboard cells from raw events, folded
    through the live tracker's own ``_Agg`` cell (one fold, one rounding),
    so this report cannot drift from the /healthz scoreboard."""
    from binquant_tpu_torch.obs.outcomes import _Agg

    cells: dict[tuple[str, int], _Agg] = {}
    truncated = 0
    for e in events:
        if e.get("truncated"):
            truncated += 1
            continue
        key = (str(e.get("strategy", "?")), int(e.get("horizon", 0)))
        cells.setdefault(key, _Agg()).add(
            float(e.get("fwd_ret", 0.0)),
            float(e.get("mae", 0.0)),
            float(e.get("mfe", 0.0)),
        )
    return {"cells": cells, "truncated": truncated}


def render_report(events: list[dict]) -> str:
    agg = aggregate(events)
    cells = agg["cells"]
    matured = sum(c.n for c in cells.values())
    lines = [
        f"signal-outcome scoreboard: {matured} matured pairs "
        f"({agg['truncated']} truncated)"
    ]
    header = (
        f"{'strategy':<28} {'h':>4} {'n':>5} {'hit%':>6} "
        f"{'avg_fwd':>9} {'avg_mae':>9} {'avg_mfe':>9} {'worst_mae':>10}"
    )
    lines.append(header)
    for (strategy, h), c in sorted(cells.items()):
        lines.append(
            f"{strategy:<28} {h:>4} {c.n:>5} "
            f"{100.0 * c.hits / c.n:>5.1f}% "
            f"{c.sum_fwd / c.n:>+9.4f} {c.sum_mae / c.n:>+9.4f} "
            f"{c.sum_mfe / c.n:>+9.4f} {c.worst_mae:>+10.4f}"
        )
    return "\n".join(lines)


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("log", help="JSONL event log (BQT_EVENT_LOG file)")
    parser.add_argument(
        "--strategy", help="render only this strategy's scoreboard rows"
    )
    parser.add_argument(
        "--json", action="store_true",
        help="dump the aggregated cells as JSON instead of the table",
    )
    args = parser.parse_args(argv)

    events = load_outcome_events(args.log)
    if args.strategy:
        events = [e for e in events if e.get("strategy") == args.strategy]
    if not events:
        print(f"no signal_outcome events in {args.log}", file=sys.stderr)
        return 1
    if args.json:
        agg = aggregate(events)
        out = {
            f"{s}@{h}": c.as_dict()
            for (s, h), c in sorted(agg["cells"].items())
        }
        print(json.dumps(out, indent=1, sort_keys=True))
        return 0
    print(render_report(events))
    return 0


if __name__ == "__main__":
    sys.exit(main())
