"""The spike detector on the card: its qtail launch against the twin.

This file imports torch and the port only (no jax), so it runs on a machine
with a CUDA card and no JAX:

    python -m pytest tests/test_torch_dormant_card.py -m cuda -q

Without a card its tests skip. ``detect_spikes`` on a CUDA buffer launches
``csrc/qtail.cu`` at the ``detect_spikes`` call site (2048x400, L=60, K=1,
q=0.85, min_periods=20) exactly once, never the twin; the launch's output
equals the twin's bit for bit on rows holding a zero close (a +inf and a
-100% price change), a NaN gap and rows under 20 bars; and the detector's
verdict equals the CPU port's: every flag and the price-break threshold
(order statistics and elementwise math) bit for bit, the calibrated volume
threshold (a quantile over a cumsum moving average) within the card
contract, ``rtol=1e-4``. The CPU parity with the reference is
``tests/test_torch_spikes.py``.
"""

import numpy as np
import pytest
import torch

from binquant_tpu_torch.engine.buffer import Field, MarketBuffer
from binquant_tpu_torch.ops import quantile_tail as qt
from binquant_tpu_torch.ops.rolling import shift
from binquant_tpu_torch.strategies.spike_hunter import SpikeSignal, detect_spikes

# small shapes: extra intra-op threads only spin and crowd parallel test workers
torch.set_num_threads(1)

S, W = 2048, 400


def _card() -> None:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the GPU machine)")


def _buffer(seed: int = 7) -> MarketBuffer:
    """A seeded (S, W) 15m buffer with spikes, zero closes, a NaN gap and
    short rows, on the CPU."""
    rng = np.random.default_rng(seed)
    close = 30 * np.exp(np.cumsum(rng.normal(0, 0.006, (S, W)), axis=1))
    open_ = np.concatenate([close[:, :1], close[:, :-1]], axis=1)
    vol = np.abs(rng.normal(1000, 200, (S, W)))
    spikes = rng.choice(np.arange(20, S), 64, replace=False)
    for r in spikes:
        for j in (-3, -2, -1):
            open_[r, j] = close[r, j - 1]
            close[r, j] = open_[r, j] * (1.035 if j == -1 else 1.004)
        vol[r, -1] *= 6.0
    close[2, 200] = 0.0
    close[3, -1] = 0.0
    close[4, -2] = 0.0
    vals = np.stack(
        [open_, np.maximum(open_, close) * 1.002, np.minimum(open_, close) * 0.998, close,
         vol, vol * close, np.full_like(close, 300.0), vol / 2, vol * close / 2,
         np.full_like(close, 900.0)], axis=-1,
    ).astype(np.float32)
    vals[11, 100:110] = np.nan
    times = np.broadcast_to(
        (1_780_272_000 - 900 * np.arange(W - 1, -1, -1)).astype(np.int32), (S, W)
    ).copy()
    filled = np.full(S, W, np.int32)
    filled[[7, 8, 9, 10]] = [0, 15, 19, 40]
    for r in (7, 8, 9, 10):
        times[r, : W - filled[r]] = -1
        vals[r, : W - filled[r]] = np.nan
    return MarketBuffer(torch.from_numpy(times), torch.from_numpy(vals),
                        torch.from_numpy(filled), torch.zeros(S, dtype=torch.int32))


def _bits(x: torch.Tensor) -> np.ndarray:
    a = x.cpu().numpy()
    return np.nan_to_num(a, nan=-9e9).view(np.int32) if a.dtype == np.float32 else a


@pytest.mark.cuda
def test_detect_spikes_site_launches_the_kernel_bit_equal_to_the_twin():
    _card()
    buf = _buffer()
    close = buf.values[:, :, Field.CLOSE].cuda()
    pca = torch.abs(close / shift(close, 1) - 1.0).contiguous()
    qt.reset_launches()
    out = qt.rolling_quantile_tail(pca, 60, 0.85, num_out=1, min_periods=20,
                                   site="detect_spikes")
    assert qt.launches == 1 and qt.launches_by_site == {"detect_spikes": 1}
    twin = qt.rolling_quantile_tail_reference(pca, 60, 0.85, num_out=1, min_periods=20)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(_bits(out), _bits(twin))
    assert torch.isinf(pca[[2, 4]]).any()  # the zero closes reached the kernel


@pytest.mark.cuda
def test_detect_spikes_on_the_card_equals_the_cpu_port():
    _card()
    buf = _buffer()
    cpu = detect_spikes(buf)
    dev = MarketBuffer(*(t.cuda() for t in buf))
    qt.reset_launches()
    card = detect_spikes(dev)
    torch.cuda.synchronize()
    assert qt.launches == 1 and qt.launches_by_site == {"detect_spikes": 1}
    for field in SpikeSignal._fields:
        a, b = getattr(card, field), getattr(cpu, field)
        assert a.device.type == "cuda" and a.dtype == b.dtype and a.shape == b.shape, field
        if field == "volume_ratio_threshold":
            np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=1e-4)
        else:
            np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=field)
    assert card.label.any() and card.price_break_flag.any()
