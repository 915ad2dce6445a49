"""The incremental engine on the card against the same engine on the CPU.

This file imports torch and the port only (no jax), so it runs on a machine
with a CUDA card and no JAX:

    python -m pytest tests/test_torch_incremental_card.py -m cuda -q

Without a card its tests skip. One seeded replay (200 symbols in 256 rows,
104 ticks, a 200-bar ring, an audit every 100 ticks: a cold start, 98
incremental ticks, the audit, three more incremental ticks) drives one
engine on the card and one on the CPU, both serial (depth 0) with copied
rings and no digests; ``tests/test_torch_pipelined_card.py`` drives the
production loop. Contract:

* the routing is the same on both, tick by tick;
* the rolling-quantile kernel launches exactly twice on every full tick
  (``abp_core`` and ``abp_init_from_window``) and never on an incremental
  tick;
* the fired sets are equal; the wires agree with the fired block exact and
  floats within ``rtol=1e-4, atol=1e-5``, NaN where NaN;
* the rings are equal bit for bit (positional scatters and gathers), and
  the carry's integer counters, masks, rings and ABP's sorted windows too;
  its float sums within ``rtol=1e-4`` and an absolute ``1e-5`` of the
  leaf's scale (the card sums in other orders: cuBLAS, its scans), a
  moment carry's centered sums within the ulps of its center.
"""

from __future__ import annotations

import asyncio

import numpy as np
import pytest
import torch

from binquant_tpu_torch.io import replay as treplay
from binquant_tpu_torch.ops import quantile_tail as qt

# small shapes: extra intra-op threads only spin and crowd parallel test workers
torch.set_num_threads(1)

CAPACITY, WINDOW, TICKS, AUDIT = 256, 200, 104, 100
EXACT = {"last_ts", "rel", "cnt", "n_seen", "has_qav", "dirty", "bc_dirty", "raw_ring",
         "abp5.vol_med.sorted", "abp5.qvol_med.sorted", "abp5.score_q.sorted",
         "abp5.score_ring"}


def _card() -> None:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the GPU machine)")


def _drive(device: str, seq) -> dict:
    # the serial loop with copied rings and no digests or meter: each tick's
    # own wire and launches are read right after it
    engine = treplay.make_stub_engine(
        capacity=CAPACITY, window=WINDOW, device=device, incremental=True,
        carry_audit_every=AUDIT, pipeline_depth=0, donate=False, numeric_digest=False,
        ingest_digest=False, drift_meter=False,
    )
    paths, launches, wires, fired = [], [], [], []

    async def run():
        for tick_ms, klines in seq:
            for k in klines:
                engine.ingest(k)
            before = qt.launches
            out = await engine.process_tick(now_ms=tick_ms)
            launches.append(qt.launches - before)
            paths.append(engine.last_path)
            wires.append(engine.last_wire.copy())
            fired.extend(treplay.signal_tuples(out))

    asyncio.run(run())
    return {"engine": engine, "paths": paths, "launches": launches, "wires": wires,
            "fired": fired}


@pytest.fixture(scope="module")
def drives(tmp_path_factory):
    _card()
    path = tmp_path_factory.mktemp("incr_card") / "rp.jsonl"
    treplay.generate_replay_file(path, n_symbols=200, n_ticks=TICKS, seed=3)
    seq = treplay.tick_seq(path)
    return _drive("cuda", seq), _drive("cpu", seq)


def _leaves(tree, prefix=""):
    if isinstance(tree, tuple):
        for f, v in zip(tree._fields, tree):
            yield from _leaves(v, f"{prefix}{f}.")
    else:
        yield prefix[:-1], tree


@pytest.mark.cuda
def test_routing_and_kernel_launches_on_card(drives):
    gpu, cpu = drives
    assert gpu["paths"] == cpu["paths"]
    full = [p != "incremental" for p in gpu["paths"]]
    assert gpu["paths"][0] == "cold_start" and gpu["paths"][AUDIT] == "audit"
    assert sum(full) == 2
    assert gpu["launches"] == [2 if f else 0 for f in full]
    assert all(n == 0 for n in cpu["launches"])  # the CPU runs the twin


@pytest.mark.cuda
def test_wires_and_fired_sets_match_cpu(drives):
    from binquant_tpu_torch.engine.step import WIRE_FIRED_COUNT_OFF, WIRE_MAX_FIRED

    gpu, cpu = drives
    assert gpu["fired"] and sorted(gpu["fired"]) == sorted(cpu["fired"])
    off, K = WIRE_FIRED_COUNT_OFF, WIRE_MAX_FIRED
    for wg, wc in zip(gpu["wires"], cpu["wires"], strict=True):
        assert wg.shape == wc.shape and wg[off] == wc[off]
        np.testing.assert_array_equal(wg[off + 1: off + 1 + 4 * K], wc[off + 1: off + 1 + 4 * K])
        assert np.isclose(wg, wc, rtol=1e-4, atol=1e-5, equal_nan=True).all()


@pytest.mark.cuda
def test_state_matches_cpu(drives):
    gpu, cpu = drives
    sg, sc = gpu["engine"].state, cpu["engine"].state
    for ring in ("buf5", "buf15"):
        for (f, a), (_, b) in zip(_leaves(getattr(sg, ring)), _leaves(getattr(sc, ring))):
            assert torch.equal(a.cpu().nan_to_num(nan=-1.0), b.nan_to_num(nan=-1.0)), (ring, f)
    card = {p: v.cpu().numpy() for p, v in _leaves(sg.indicator_carry)}
    host = {p: v.numpy() for p, v in _leaves(sc.indicator_carry)}
    assert list(card) == list(host)
    for path, a in card.items():
        b = host[path]
        assert a.dtype == b.dtype and a.shape == b.shape, path
        if path in EXACT or path.rsplit(".", 1)[-1] in EXACT or a.dtype.kind != "f":
            assert np.array_equal(a, b, equal_nan=a.dtype.kind == "f"), path
            continue
        if path.endswith((".wsum", ".wsq")) and ".center" not in path:
            base = path.rsplit(".", 1)[0]
            if base + ".center" in host:
                # a moment carry: its center is a window mean, summed in
                # another order on the card; Σ(x−c) moves by up to cnt
                # times the center's shift (the step test's contract)
                ulp = np.spacing(np.abs(host[base + ".center"]).astype(np.float32))
                tol = 8 * (host[base + ".cnt"] + 1) * ulp + 1e-5
                if path.endswith(".wsq"):
                    tol = 1e-4 * np.abs(b) + 2 * np.abs(host[base + ".wsum"]) * tol + 1e-5
                assert np.all(np.abs(a - b) <= tol), path
                continue
        fin = np.isfinite(b)
        assert np.array_equal(fin, np.isfinite(a)), path
        scale = max(float(np.abs(b[fin]).max()), 1.0) if fin.any() else 1.0
        np.testing.assert_allclose(a[fin], b[fin], rtol=1e-4, atol=1e-5 * scale, err_msg=path)
