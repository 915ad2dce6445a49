"""The multi-tick drives on the card: ``abp_core_batch``'s qtail launches,
a backtest chunk and a scanned chunk against the CPU port.

This file imports torch and the port only (no jax), so it runs on a machine
with a CUDA card and no JAX:

    python -m pytest tests/test_torch_backtest_card.py -m cuda -q

Without a card its tests skip.

* ``abp_core_batch`` on a CUDA extension at the default chunk's shape
  (2048 symbols, a 400-bar ring and 48 appended 5m bars, 16 ticks)
  launches ``csrc/qtail.cu`` twice at the ``abp_core_batch`` site (2048x176,
  K=52) and never the twin; its outputs equal the CPU port's bit for bit
  (order statistics, shifts and elementwise math).
* A scanned chunk (``tick_step_scan``, 4 incremental ticks of three 5m
  slots at 256 symbols) issues no synchronizing operation
  (``torch.cuda.set_sync_debug_mode("error")`` would raise) and its wires
  equal the serial steps' on the card bit for bit.
"""

import numpy as np
import pytest
import torch

from binquant_tpu_torch.engine import step
from binquant_tpu_torch.engine.buffer import NUM_FIELDS, Field
from binquant_tpu_torch.ops import quantile_tail as qt
from binquant_tpu_torch.strategies.activity_burst_pump import abp_core_batch

# small shapes: extra intra-op threads only spin and crowd parallel test workers
torch.set_num_threads(1)


def _card() -> None:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the GPU machine)")


def _bars(rng, S: int, n: int, interval_s: float, px=None) -> tuple[np.ndarray, np.ndarray]:
    """(S, n, F) float32 bars of a random walk with volume bursts."""
    px = 20 + rng.random(S) * 60 if px is None else px
    out = np.zeros((S, n, NUM_FIELDS), np.float32)
    for j in range(n):
        new = px * (1 + rng.normal(0, 0.004, S))
        burst = rng.random(S) < 0.03
        new = np.where(burst, px * 1.03, new)
        vol = (800 + 400 * rng.random(S)) * np.where(burst, 8.0, 1.0)
        out[:, j, Field.OPEN] = px
        out[:, j, Field.HIGH] = np.maximum(px, new) * 1.001
        out[:, j, Field.LOW] = np.minimum(px, new) * 0.999
        out[:, j, Field.CLOSE] = new
        out[:, j, Field.VOLUME] = vol
        out[:, j, Field.QUOTE_VOLUME] = vol * new
        out[:, j, Field.NUM_TRADES] = 300.0
        out[:, j, Field.TAKER_BUY_BASE] = vol / 2
        out[:, j, Field.TAKER_BUY_QUOTE] = vol * new / 2
        out[:, j, Field.DURATION_S] = interval_s
        px = new
    return out, px


@pytest.mark.cuda
def test_abp_core_batch_launches_kernel_equal_to_cpu():
    _card()
    S, W, T = 2048, 400, 16
    rng = np.random.default_rng(3)
    vals, _ = _bars(rng, S, W + 3 * T, 300.0)
    vals[5, : W // 2] = np.nan  # a row with half a ring of history
    counts = np.tile((3 * np.arange(1, T + 1, dtype=np.int32))[:, None], (1, S))
    cpu = abp_core_batch(torch.from_numpy(vals), torch.from_numpy(counts), W)
    qt.reset_launches()
    card = abp_core_batch(torch.from_numpy(vals).cuda(), torch.from_numpy(counts).cuda(), W)
    torch.cuda.synchronize()
    assert qt.launches_by_site == {"abp_core_batch": 2} and qt.twin_calls_by_site == {}
    q, score, diag = (x.cpu() if isinstance(x, torch.Tensor) else x for x in card)
    assert torch.equal(q, cpu[0]) and bool(q.any())
    assert torch.equal(score.view(torch.int32), cpu[1].view(torch.int32))
    for k, v in cpu[2].items():
        assert torch.equal(diag[k].cpu().view(torch.int32), v.view(torch.int32)), k


@pytest.mark.cuda
def test_scanned_chunk_is_sync_free_and_equal_to_serial():
    _card()
    S, W, dev = 256, 120, "cuda"
    rng = np.random.default_rng(9)
    h15, px15 = _bars(rng, S, 111, 900.0)
    h5, px5 = _bars(rng, S, 111, 300.0)
    t15, t5 = 1_780_272_000 - 900 * 111, 1_780_272_000 - 300 * 111
    rows = torch.arange(S, dtype=torch.int32, device=dev)

    def batch(ts, v):
        return rows, torch.full((S,), ts, dtype=torch.int32, device=dev), torch.from_numpy(
            np.ascontiguousarray(v)).to(dev)

    def inputs(ts15, ts5):
        return step.default_host_inputs(S, device=dev)._replace(
            tracked=torch.ones(S, dtype=torch.bool, device=dev),
            btc_row=torch.zeros((), dtype=torch.int32, device=dev),
            timestamp_s=torch.full((), ts15, dtype=torch.int32, device=dev),
            timestamp5_s=torch.full((), ts5, dtype=torch.int32, device=dev),
        )

    st = step.initial_engine_state(S, W, device=dev)
    for k in range(110):
        st = step.apply_updates_step(st, batch(t5 + 300 * k, h5[:, k]),
                                     batch(t15 + 900 * k, h15[:, k]))
    st, _ = step.tick_step_wire(st, batch(t5 + 300 * 110, h5[:, 110]),
                                batch(t15 + 900 * 110, h15[:, 110]),
                                inputs(t15 + 900 * 110, t5 + 300 * 110), incremental=False)
    c15, c5 = t15 + 900 * 111, t5 + 300 * 111
    T = 4
    new15, _ = _bars(rng, S, T, 900.0, px15)
    new5, _ = _bars(rng, S, 3 * T, 300.0, px5)
    serial, wires = st, []
    empty = tuple(x[:0] for x in batch(0, h5[:, 0]))
    for t in range(T):
        b5 = [batch(c5 + 300 * (3 * t + j), new5[:, 3 * t + j]) for j in range(3)]
        b15 = [batch(c15 + 900 * t, new15[:, t]), empty, empty]
        for j in range(2):
            serial = step.apply_updates_carry_step(serial, b5[j], b15[j], btc_row=0)
        serial, wire = step.tick_step_wire(serial, b5[2], b15[2],
                                           inputs(c15 + 900 * t, c5 + 300 * (3 * t + 2)),
                                           incremental=True)
        wires.append(wire)
    # the stacked form: the 15m batch in slot 0, slots 1-2 padded (rows -1)
    r = np.full((2, T, 3, S), -1, np.int32)
    ts = np.full((2, T, 3, S), -1, np.int32)
    v = np.zeros((2, T, 3, S, NUM_FIELDS), np.float32)
    for t in range(T):
        for j in range(3):
            r[0, t, j], ts[0, t, j], v[0, t, j] = np.arange(S), c5 + 300 * (3 * t + j), new5[:, 3 * t + j]
        r[1, t, 0], ts[1, t, 0], v[1, t, 0] = np.arange(S), c15 + 900 * t, new15[:, t]
    upd = [tuple(torch.from_numpy(x[k]).to(dev) for x in (r, ts, v)) for k in range(2)]
    per_tick = [inputs(c15 + 900 * t, c5 + 300 * (3 * t + 2)) for t in range(T)]
    inputs_seq = step.HostInputs(*(torch.stack(xs) for xs in zip(*per_tick)))
    prev = (torch.zeros((), dtype=torch.bool, device=dev),
            torch.full((), -1, dtype=torch.int32, device=dev))
    momentum = torch.zeros(T, dtype=torch.bool, device=dev)
    step.tick_step_scan(st, upd[0], upd[1], inputs_seq, momentum, prev)  # warm
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, scanned, _ = step.tick_step_scan(st, upd[0], upd[1], inputs_seq, momentum, prev)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    for t in range(T):
        assert torch.equal(scanned[t].view(torch.int32), wires[t].view(torch.int32)), t
