"""Strategy-parameter sweep report: the port of the root
``tools/sweep_report.py``.

Runs the port's ``backtest.run_param_sweep`` over a kline stream and
prints a per-combo table of signal fire counts and the outcome columns
(hit rate, average signed forward return and average MAE at the scoring
horizon). One dispatch per chunk scores every combo; outcomes mature
through the gather the live tracker uses.

Usage::

    python -m binquant_tpu_torch.tools.sweep_report STREAM.jsonl \\
        --axis pt.rsi_oversold=20,30,40 \\
        --axis mrf.rsi_long_max=15,25,35 \\
        [--capacity 64] [--window 200] [--chunk 32] [--top 10] [--json OUT] \\
        [--horizons 1,4,16] [--rank-by return|fires] [--device cuda|cpu]

    python -m binquant_tpu_torch.tools.sweep_report --demo   # a synthetic stream, default grid

Axis names are dotted float leaves of ``strategies.params.StrategyParams``
(``--list-axes`` prints them); int/bool leaves are structural and cannot
be swept. The sweep runs on ``--device``: the card by default (failing
without one), the CPU only when asked.
"""

from __future__ import annotations

import argparse
import json
import shutil
import tempfile


def _parse_axis(spec: str) -> tuple[str, list[float]]:
    if "=" not in spec:
        raise SystemExit(f"bad --axis {spec!r}: expected name=v1,v2,...")
    name, _, values = spec.partition("=")
    try:
        parsed = [float(v) for v in values.split(",") if v.strip()]
    except ValueError as exc:
        raise SystemExit(f"bad --axis {spec!r}: {exc}") from exc
    if not parsed:
        raise SystemExit(f"bad --axis {spec!r}: no values")
    return name.strip(), parsed


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        description="batched strategy-parameter sweep report"
    )
    parser.add_argument("stream", nargs="?", help="JSONL kline stream")
    parser.add_argument(
        "--axis", action="append", default=[],
        metavar="name=v1,v2,...",
        help="grid axis (repeatable); dotted StrategyParams float leaf",
    )
    parser.add_argument("--capacity", type=int, default=64)
    parser.add_argument("--window", type=int, default=200)
    parser.add_argument("--chunk", type=int, default=None)
    parser.add_argument(
        "--top", type=int, default=10, help="combos shown (by total fires)"
    )
    parser.add_argument("--json", help="also dump the full result as JSON")
    parser.add_argument(
        "--horizons", default="1,4,16,96",
        help="outcome maturation horizons in 5m bars (comma-separated)",
    )
    parser.add_argument(
        "--rank-by", choices=("return", "fires"), default="return",
        help="rank combos by total signed forward return at the scoring "
        "horizon (the economic proxy) or by raw fire counts",
    )
    parser.add_argument(
        "--list-axes", action="store_true",
        help="print the sweepable axis names and exit",
    )
    parser.add_argument(
        "--demo", action="store_true",
        help="synthesize a small market and sweep a default grid",
    )
    parser.add_argument(
        "--device", default="cuda",
        help="cuda (the default; fails without a card) or cpu",
    )
    args = parser.parse_args(argv)

    from binquant_tpu_torch.strategies.params import sweepable_axes

    if args.list_axes:
        for name in sweepable_axes():
            print(name)
        return 0

    axes = dict(_parse_axis(spec) for spec in args.axis)
    demo_dir = None
    if args.demo:
        from binquant_tpu_torch.io.replay import generate_outcome_replay

        demo_dir = tempfile.mkdtemp(prefix="bqt_sweep_")
        args.stream = f"{demo_dir}/demo.jsonl"
        # mid-stream fires (unlike generate_replay_file's last-tick
        # setups), so the demo's outcome columns mature
        generate_outcome_replay(args.stream, n_symbols=24, n_ticks=128)
        args.capacity, args.window = 32, 160
        axes = axes or {
            "pt.rsi_oversold": [15.0, 30.0, 45.0, 60.0],
            "mrf.rsi_long_max": [10.0, 25.0, 40.0, 55.0],
            "abp.volume_multiplier": [1.5, 2.75, 4.0, 8.0],
        }
    if not args.stream or not axes:
        parser.error("need a stream and at least one --axis (or --demo)")

    from binquant_tpu_torch.backtest import run_param_sweep

    horizons = tuple(
        int(v) for v in str(args.horizons).split(",") if v.strip()
    )
    try:
        res = run_param_sweep(
            args.stream,
            axes=axes,
            capacity=args.capacity,
            window=args.window,
            chunk=args.chunk,
            horizons=horizons or (1, 4, 16, 96),
            device=args.device,
        )
    finally:
        if demo_dir is not None:  # the demo's stream is the sweep's alone
            shutil.rmtree(demo_dir, ignore_errors=True)

    strategies = res["strategies"]
    live_cols = [
        i for i, s in enumerate(strategies)
        if any(res["trig_counts"][p][i] for p in range(res["P"]))
    ]
    axis_names = list(axes)
    outcomes = res.get("outcomes") or {}
    scored = bool(outcomes.get("enabled"))
    print(
        f"sweep: P={res['P']} combos x {res['evaluated_ticks']} ticks "
        f"({res['candles']} candles) in {res['dispatches']} dispatches, "
        f"{res['wall_s']}s "
        f"({res['combo_candles_per_sec']} combo-candles/s)"
    )
    if scored:
        H = outcomes["score_horizon"]
        print(
            f"outcomes: {outcomes['matured_pairs']} matured pairs "
            f"({outcomes['truncated']} truncated, "
            f"{outcomes['unmatured_pair_horizons']} unmatured horizons), "
            f"scored at h={H} bars of 5m; ranked by {args.rank_by}"
        )
    else:
        print("outcomes: scoring disabled (no positive horizons); "
              "ranked by fires")
    ranking = (
        outcomes["ranking_by_return"]
        if scored and args.rank_by == "return"
        else res["ranking"]
    )

    def _fmt(v, pct=False):
        if v is None:
            return "-"
        return f"{v * 100:.1f}%" if pct else f"{v:+.4f}"

    score_cols = [f"hit@{H}", f"fwd@{H}", f"mae@{H}"] if scored else []
    header = (
        ["#", "total", *score_cols]
        + [strategies[i] for i in live_cols]
        + axis_names
    )
    rows = []
    for rank, p in enumerate(ranking[: args.top]):
        combo = res["combos"][p]
        score_cells = []
        if scored:
            score = outcomes["combo_score"][p]
            score_cells = [
                _fmt(score["hit_rate"], pct=True),
                _fmt(score["avg_fwd"]),
                _fmt(score["avg_mae"]),
            ]
        rows.append(
            [str(rank + 1), str(res["total_fired"][p]), *score_cells]
            + [str(res["trig_counts"][p][i]) for i in live_cols]
            + [f"{combo[name]:g}" for name in axis_names]
        )
    widths = [
        max(len(header[c]), *(len(r[c]) for r in rows)) if rows else len(header[c])
        for c in range(len(header))
    ]
    fmt = "  ".join(f"{{:>{w}}}" for w in widths)
    print(fmt.format(*header))
    for r in rows:
        print(fmt.format(*r))

    if args.json:
        with open(args.json, "w") as f:
            json.dump(res, f, indent=1)
        print(f"full result written to {args.json}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
