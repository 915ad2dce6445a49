"""The per-stage profiler of the tick (``binquant_tpu_torch/tools/
profile_stages.py``) against the reference script ``tools/profile_stages.py``,
and ``compute_feature_pack_incremental`` against the reference's.

* the port's stages are the reference script's, by name and in order (read
  from the script's ``stage(...)`` calls);
* every row runs on the CPU at S=64, W=200, its line printed in order, and
  ``--json`` writes what was printed;
* the bulk ring fill equals W ``apply_updates`` calls from empty rings;
* without a card and without ``--device cpu`` the tool fails (no fallback);
* ``compute_feature_pack_incremental`` on the same seeded ring and carry:
  positional fields and integers exactly, the EWM and windowed-sum leaves
  within 16 float32 ulps of the largest value their terms reach (the price
  for the price EWMs, the MACD and the centered close moments; the volume
  for the volume moments; the leaf itself elsewhere).
"""

from __future__ import annotations

import ast
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from binquant_tpu.engine import buffer as jbuf
from binquant_tpu.strategies import features as jfeat
from binquant_tpu_torch.engine import buffer as tbuf
from binquant_tpu_torch.strategies import features as tfeat
from binquant_tpu_torch.tools import profile_stages as ps

# small shapes: extra intra-op threads only spin and crowd parallel test workers
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent


def _reference_stages() -> list[str]:
    tree = ast.parse((ROOT / "tools" / "profile_stages.py").read_text())
    return [
        node.args[0].value for node in ast.walk(tree)
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
        and node.func.id == "stage" and node.args and isinstance(node.args[0], ast.Constant)
    ]


def test_stage_list_is_the_reference_scripts():
    ref = _reference_stages()
    assert len(ref) == 26
    assert list(ps.STAGES) == ref
    assert ps.SEED == 7


def test_every_row_runs_on_the_cpu_and_json_round_trips(tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(ps, "ITERS", 1)
    monkeypatch.setattr(ps, "WARMUP", 0)
    out = tmp_path / "rows.json"
    assert ps.main(["--device", "cpu", "--symbols", "64", "--window", "200",
                    "--json", str(out)]) == 0
    err = capsys.readouterr().err.splitlines()
    assert err[0] == "device=cpu S=64 W=200"
    printed = [line for line in err[1:] if " p50=" in line]
    assert [line[:38].rstrip() for line in printed[:26]] == list(ps.STAGES)
    result = json.loads(out.read_text())
    assert (result["device"], result["symbols"], result["window"]) == ("cpu", 64, 200)
    rows = result["rows"]
    assert [r["name"] for r in rows] == list(ps.STAGES)
    for row, line in zip(rows, printed, strict=False):
        assert f"p50={row['p50_ms']:9.3f} ms  max={row['max_ms']:9.3f} ms" in line
        assert row["max_ms"] >= row["p50_ms"] > 0
        # no device on the CPU: nothing is reported under a device metric
        assert row["device_ms"] is None and row["busy_ms"] is None
        assert row["device_ops"] is None
    # the qtail column counts the twin's calls on the CPU, at the rows that reach it
    sites = {r["name"]: r["qtail"] for r in rows if r["qtail"] is not None}
    assert sites == {
        "abp": {"abp_core": 1},
        "detect_spikes": {"detect_spikes": 1},
        "tick_step (device-resident inputs)": {
            "abp_core": 1, "abp_init_from_window": 1, "detect_spikes": 1},
    }
    totals = result["totals"]
    compute = [r["p50_ms"] for r in rows if not r["name"].startswith(("rtt", "h2d", "tick"))]
    assert totals["sum_of_compute_stages_ms"] == pytest.approx(sum(compute))
    summary = [line for line in err if line.startswith(("sum of compute", "full vs incr"))]
    assert len(summary) == 2
    assert f"p50={totals['sum_of_compute_stages_ms']:9.3f} ms" in summary[0]


def test_without_a_card_the_default_device_fails():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible; the no-CUDA refusal cannot be shown")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ps.main(["--symbols", "8", "--window", "96"])


def _bits(t: torch.Tensor) -> np.ndarray:
    a = t.numpy()
    return a.view(np.int32) if a.dtype == np.float32 else a


def test_bulk_fill_equals_apply_updates():
    S, W = 24, 96
    market = ps.make_market(S, W)
    bulk = ps.fill_rings(market, "cpu")
    ring = tbuf.empty_buffer(S, W, device="cpu")
    rows = torch.arange(S, dtype=torch.int32)
    for b in range(W):
        ts = torch.full((S,), int(market.times[b]), dtype=torch.int32)
        ring = tbuf.apply_updates(ring, rows, ts, torch.from_numpy(market.vals[b]))
    for buf in (bulk.buf5, bulk.buf15):
        for got, want in zip(buf, ring, strict=True):
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(_bits(got), _bits(want))
    # the live tick's update is the next bar on every row
    upd_rows, upd_ts, upd_vals = market.upd
    assert (upd_rows == np.arange(S)).all() and (upd_ts == market.now).all()
    assert market.now == int(market.times[-1]) + ps.BAR_S
    np.testing.assert_array_equal(upd_vals[:, tbuf.Field.OPEN], market.vals[-1][:, 3])


def _leaves(x, prefix=""):
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        for f, v in zip(x._fields, x, strict=True):
            yield from _leaves(v, f"{prefix}{f}.")
    else:
        yield prefix[:-1], x


POSITIONAL = {"open_time", "close_time", "open", "high", "low", "close", "prev_close",
              "volume", "quote_volume", "num_trades", "filled", "valid", "last_ts"}


def _hold(jtree, ttree, price: float, volume: float, where: str) -> None:
    term_scale = {"macd": price, "macd_signal": price, "macd_sig.mean": price,
                  "close_m.wsum": price * 20, "close_m.wsq": price * price,
                  "vol_m.wsum": volume * 20, "vol_m.wsq": volume * volume}
    names = []
    for (jname, jv), (tname, tv) in zip(_leaves(jtree), _leaves(ttree), strict=True):
        assert jname == tname, where
        a, b = np.asarray(jv), tv.numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, (where, jname)
        names.append(jname)
        if a.dtype.kind != "f" or jname in POSITIONAL:
            np.testing.assert_array_equal(a, b, err_msg=f"{where} {jname}")
            continue
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=f"{where} {jname}")
        fin = np.isfinite(a)
        scale = max(float(np.abs(a[fin]).max(initial=0.0)), term_scale.get(jname, 0.0))
        tol = 16 * float(np.spacing(np.float32(scale)))
        np.testing.assert_allclose(b[fin], a[fin], rtol=0, atol=tol, err_msg=f"{where} {jname}")
    assert names


def test_feature_pack_incremental_matches_the_reference():
    """The reference profiler's call (the carry of the ring itself: no new
    bar) and a one-bar advance (the live tick's bar appended)."""
    S, W = 32, 120
    market = ps.make_market(S, W)
    t_ring = ps.fill_rings(market, "cpu").buf15
    j_ring = jbuf.MarketBuffer(*(jnp.asarray(x.numpy()) for x in t_ring))
    rows, ts, vals = market.upd
    t_next = tbuf.materialize(tbuf.apply_updates(t_ring, *map(torch.from_numpy, (rows, ts, vals))))
    j_carry = jax.jit(jfeat.init_feature_carry)(j_ring)
    j_next = jbuf.materialize(jbuf.apply_updates(j_ring, *map(jnp.asarray, (rows, ts, vals))))
    j_incr = jax.jit(jfeat.compute_feature_pack_incremental)
    j_same, j_adv = j_incr(j_ring, j_carry), j_incr(j_next, j_carry)
    t_carry = tfeat.init_feature_carry(t_ring)
    t_same = tfeat.compute_feature_pack_incremental(t_ring, t_carry)
    t_adv = tfeat.compute_feature_pack_incremental(t_next, t_carry)
    close = market.vals[:, :, tbuf.Field.CLOSE]
    price, volume = float(np.abs(close).max()), float(market.vals[:, :, tbuf.Field.VOLUME].max())
    for where, (j, t) in {"no new bar": (j_same, t_same), "one-bar advance": (j_adv, t_adv)}.items():
        _hold(j[0], t[0], price, volume, f"{where} pack")
        _hold(j[1], t[1], price, volume, f"{where} carry")
    # the advance moved the carry and read the new bar; the other kept it
    assert (t_adv[1].last_ts == market.now).all() and (t_same[1].last_ts == market.now - 900).all()
    assert torch.equal(t_adv[0].close, torch.from_numpy(vals[:, tbuf.Field.CLOSE]))
    assert torch.isfinite(t_adv[0].rsi_wilder).all() and torch.isfinite(t_adv[0].macd).all()
