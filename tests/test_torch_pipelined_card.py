"""The production loop on the card against the serial loop on the CPU.

This file imports torch and the port only (no jax), so it runs on a machine
with a CUDA card and no JAX:

    python -m pytest tests/test_torch_pipelined_card.py -m cuda -q

Without a card its tests skip. One seeded replay (the overflow drill's
market: 200 symbols in 256 rows, 104 ticks of a steady downtrend ending in
a market-wide crash that fires more pairs than the wire's 128 slots; a
200-bar ring; an audit every 50 ticks) drives the production engine on the
card (depth 1, rings in place, both digests and the drift meter on) and the
serial engine on the CPU (depth 0, copied rings, the same flags). Contract:

* the routing is the same, tick by tick; the rolling-quantile kernel
  launches 2 times on the cold start (``abp_core``,
  ``abp_init_from_window``), 3 on each audit (and ``carry_drift``) and
  none on an incremental tick;
* every dispatched tick's wire copy lands in one of two pinned host
  buffers, used in turn, behind a CUDA event;
* the fired sets are equal, the crash tick overflowing the wire on both;
* every tick's ingest digest block is equal bit for bit, every numeric
  digest block's counts exactly and its floats within ``rtol=1e-4,
  atol=1e-5`` (NaN where NaN); each audit's drift has the same
  ``compared`` counts and alarm verdicts;
* the rings are equal bit for bit after the drive;
* at depth 2 on double-buffered rings the card engine launches as at depth
  1, emits the CPU's set (the crash tick's fallback from its own post
  rings), ends with the CPU's rings and allocates one ring slot in all.
"""

from __future__ import annotations

import asyncio

import numpy as np
import pytest
import torch

from binquant_tpu_torch.engine import step as tstep
from binquant_tpu_torch.io import replay as treplay
from binquant_tpu_torch.ops import quantile_tail as qt

# small shapes: extra intra-op threads only spin and crowd parallel test workers
torch.set_num_threads(1)

CAPACITY, WINDOW, SYMBOLS, TICKS, AUDIT = 256, 200, 200, 104, 50


def _card() -> None:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the GPU machine)")


def _drive(device: str, seq, **serial) -> dict:
    engine = treplay.make_stub_engine(
        capacity=CAPACITY, window=WINDOW, device=device, incremental=True,
        carry_audit_every=AUDIT, **serial,
    )
    engine.numeric.record_history = True
    engine.ingest_monitor.record_history = True
    engine.drift.record_history = True
    out = {"paths": [], "sites": [], "hosts": [], "fired": []}

    async def run():
        for tick_ms, klines in seq:
            for k in klines:
                engine.ingest(k)
            before = dict(qt.launches_by_site)
            fired = await engine.process_tick(now_ms=tick_ms)
            out["sites"].append({
                k: v - before.get(k, 0) for k, v in qt.launches_by_site.items()
                if v != before.get(k, 0)
            })
            out["paths"].append(engine.last_path)
            if engine._pending:
                head = engine._pending[-1]
                out["hosts"].append((head.host.data_ptr(), head.host.is_pinned(), head.ready))
            out["fired"].extend(treplay.signal_tuples(fired))
        out["fired"].extend(treplay.signal_tuples(await engine.flush_pending()))

    asyncio.run(run())
    out["engine"] = engine
    return out


@pytest.fixture(scope="module")
def seq(tmp_path_factory):
    _card()
    path = tmp_path_factory.mktemp("pipelined_card") / "burst.jsonl"
    treplay.generate_burst_replay(path, n_symbols=SYMBOLS, n_ticks=TICKS)
    return treplay.tick_seq(path)


@pytest.fixture(scope="module")
def drives(seq):
    gpu = _drive("cuda", seq)
    cpu = _drive("cpu", seq, pipeline_depth=0, donate=False)
    return gpu, cpu


@pytest.mark.cuda
def test_routing_and_kernel_launches_per_site(drives):
    gpu, cpu = drives
    assert gpu["paths"] == cpu["paths"]
    assert gpu["paths"][0] == "cold_start"
    assert [i for i, p in enumerate(gpu["paths"]) if p == "audit"] == [AUDIT, 2 * AUDIT]
    for path, sites in zip(gpu["paths"], gpu["sites"]):
        want = {}
        if path != "incremental":
            want = {"abp_core": 1, "abp_init_from_window": 1}
        if path == "audit":
            want["carry_drift"] = 1
        assert sites == want, (path, sites)
    assert all(not s for s in cpu["sites"])  # the CPU runs the twin
    eng = gpu["engine"]
    assert eng.drift.audits == 2 and eng.drift.skipped == 0


@pytest.mark.cuda
def test_wire_copies_rotate_two_pinned_buffers(drives):
    gpu, _ = drives
    eng = gpu["engine"]
    assert eng.pipeline_depth == 1 and eng.inplace_ticks == TICKS and eng.state_resets == 0
    assert len(eng._wire_bufs) == 2 and all(b.is_pinned() for b in eng._wire_bufs)
    ptrs = [p for p, _, _ in gpu["hosts"]]
    assert len(ptrs) == TICKS and len(set(ptrs)) == 2
    assert all(a != b for a, b in zip(ptrs, ptrs[1:]))  # never the in-flight buffer
    assert all(pinned and isinstance(ev, torch.cuda.Event) for _, pinned, ev in gpu["hosts"])


@pytest.mark.cuda
def test_fired_sets_and_overflow_match_cpu(drives):
    gpu, cpu = drives
    assert gpu["engine"].overflow_ticks == cpu["engine"].overflow_ticks == 1
    assert len(gpu["fired"]) > tstep.WIRE_MAX_FIRED
    assert sorted(gpu["fired"]) == sorted(cpu["fired"])


@pytest.mark.cuda
def test_digests_and_drift_match_cpu(drives):
    gpu, cpu = drives
    g, c = gpu["engine"], cpu["engine"]
    assert len(g.ingest_monitor.digests) == len(c.ingest_monitor.digests) == TICKS
    for a, b in zip(g.ingest_monitor.digests, c.ingest_monitor.digests):
        np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))
    n_counts = 2 * len(tstep.NUMERIC_STAGES) + 2 * len(tstep.STRATEGY_ORDER)
    assert len(g.numeric.history) == len(c.numeric.history) == TICKS
    for (_, a), (_, b) in zip(g.numeric.history, c.numeric.history):
        np.testing.assert_array_equal(a[:n_counts], b[:n_counts])
        assert np.isclose(a, b, rtol=1e-4, atol=1e-5, equal_nan=True).all()
    assert len(g.drift.history) == len(c.drift.history) == 2
    for (_, dg, bg), (_, dc, bc) in zip(g.drift.history, c.drift.history):
        assert bg == bc
        assert {f: v["compared"] for f, v in dg.items()} == {f: v["compared"] for f, v in dc.items()}


@pytest.mark.cuda
def test_rings_match_cpu(drives):
    gpu, cpu = drives
    sg, sc = gpu["engine"].state, cpu["engine"].state
    for ring in ("buf5", "buf15"):
        for f in ("times", "values", "filled", "cursor"):
            a, b = getattr(getattr(sg, ring), f).cpu(), getattr(getattr(sc, ring), f)
            assert torch.equal(a.nan_to_num(nan=-1.0), b.nan_to_num(nan=-1.0)), (ring, f)


@pytest.mark.cuda
def test_depth2_double_buffered_rings_match_cpu(seq, drives):
    gpu, cpu = drives
    d2 = _drive("cuda", seq, pipeline_depth=2)
    eng = d2["engine"]
    assert eng._donation_mode() == "double"
    assert d2["paths"] == cpu["paths"] and d2["sites"] == gpu["sites"]
    assert eng.inplace_ticks == TICKS and eng.state_resets == 0 and eng.fresh_slots == 1
    assert eng.overflow_ticks == 1 and sorted(d2["fired"]) == sorted(cpu["fired"])
    for ring in ("buf5", "buf15"):
        for f in ("times", "values", "filled", "cursor"):
            a = getattr(getattr(eng.state, ring), f).cpu()
            b = getattr(getattr(cpu["engine"].state, ring), f)
            assert torch.equal(a.nan_to_num(nan=-1.0), b.nan_to_num(nan=-1.0)), (ring, f)
    live = tstep.slot_storages(tstep.ring_slot_of(eng.state))
    assert all(not live & tstep.slot_storages(slot) for slot in eng._spare_slots)
