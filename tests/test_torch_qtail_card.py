"""The qtail CUDA kernel against its plain torch twin, on the card.

This file imports torch and the port only (no jax), so it runs on a machine
with a CUDA card and no JAX:

    python -m pytest tests/test_torch_qtail_card.py -m cuda -q

Without a card its tests skip. The CPU parity of the twin with the
reference package is ``tests/test_torch_quantile_tail.py``, which shares
this file's inputs.
"""

import numpy as np
import pytest
import torch

from binquant_tpu_torch.ops import quantile_tail as qt

# small shapes: extra intra-op threads only spin and crowd parallel test workers
torch.set_num_threads(1)


def qtail_cases(cols: int = 128, seed: int = 5) -> np.ndarray:
    """(40, cols) float32 rows with the hard cases placed inside the
    trailing windows at any width: NaN runs, an all-NaN row, ±inf blocks,
    ties, ±0.0 blocks, constant rows."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((40, cols)).astype(np.float32)
    a, b = cols // 4, cols // 8 + 1
    x[3, : cols // 2] = np.nan  # leading NaN (the ring buffer's warm-up pattern)
    x[7, :] = np.nan  # all-NaN row
    x[11, -3:] = np.nan  # NaN inside the evaluated windows
    x[12, -a:-b] = np.nan  # a NaN run inside the tail
    x[13, :] = np.round(x[13] * 2) / 2  # ties everywhere
    x[14, -a:] = x[14, -1]  # a tied block at the end
    x[17, -a:-b] = np.inf  # +inf inside the windows
    x[19, -a:] = -np.inf
    x[20, -a:] = np.where(np.arange(a) % 2 == 0, -0.0, 0.0)  # interleaved ±0.0
    x[21, :] = np.where(rng.random(cols) < 0.5, -0.0, 0.0)  # only zeros
    x[22, ::3] = 0.0
    x[22, 1::3] = -0.0
    x[23, :] = 0.25  # every element ties
    x[24, :] = np.inf
    mixed = rng.random(cols)
    x[25, mixed < 0.15] = np.nan
    x[25, (mixed >= 0.15) & (mixed < 0.25)] = np.inf
    x[25, (mixed >= 0.25) & (mixed < 0.3)] = -np.inf
    x[26, :] = np.abs(x[26])  # one-signed rows
    x[27, :] = -np.abs(x[27])
    return x


def assert_bit_exact(ref: np.ndarray, out: np.ndarray) -> None:
    assert ref.shape == out.shape
    np.testing.assert_array_equal(np.isnan(ref), np.isnan(out))
    np.testing.assert_array_equal(
        np.nan_to_num(ref, nan=-9e9).view(np.int32),
        np.nan_to_num(out, nan=-9e9).view(np.int32),
    )


def _card() -> None:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the GPU machine)")


# (cols, window, num_out, q): ABP's shape, SpikeHunter's, a backtest chunk's
# (T = 179), short inputs, the smallest, the shared-memory path (T = 479) and
# its limit (T = 4096)
CARD_CASES = [
    (128, 80, 4, 0.92), (400, 60, 1, 0.85), (128, 80, 4, 0.5),
    (224, 80, 100, 0.92), (60, 80, 4, 0.92), (16, 5, 40, 0.1),
    (16, 1, 1, 0.5), (512, 80, 400, 0.92), (1200, 2900, 1197, 0.1),
]


@pytest.mark.cuda
def test_kernel_matches_twin_on_card():
    _card()
    for cols, window, num_out, q in CARD_CASES:
        x = torch.from_numpy(qtail_cases(cols)).cuda()
        qt.reset_launches()
        out = qt.rolling_quantile_tail(x, window, q, num_out=num_out, min_periods=20)
        assert qt.launches == 1
        twin = qt.rolling_quantile_tail_reference(x, window, q, num_out=num_out,
                                                  min_periods=20)
        torch.cuda.synchronize()
        assert_bit_exact(twin.cpu().numpy(), out.cpu().numpy())


@pytest.mark.cuda
def test_kernel_in_cuda_graph_replays_bit_equal():
    _card()
    x = torch.from_numpy(qtail_cases(224)).cuda()
    twin = qt.rolling_quantile_tail_reference(x, 80, 0.92, num_out=100, min_periods=20)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        qt.rolling_quantile_tail(x, 80, 0.92, num_out=100, min_periods=20)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = qt.rolling_quantile_tail(x, 80, 0.92, num_out=100, min_periods=20)
    x.copy_(torch.from_numpy(qtail_cases(224, seed=6)).cuda())  # new input, same buffer
    graph.replay()
    torch.cuda.synchronize()
    twin2 = qt.rolling_quantile_tail_reference(x, 80, 0.92, num_out=100, min_periods=20)
    assert_bit_exact(twin2.cpu().numpy(), out.cpu().numpy())
    assert not torch.equal(torch.nan_to_num(twin), torch.nan_to_num(twin2))


@pytest.mark.cuda
def test_wrapper_raises_past_the_kernel_limit():
    _card()
    x = torch.zeros((4, 256), dtype=torch.float32, device="cuda")
    qt.reset_launches()
    with pytest.raises(ValueError, match="limit"):
        qt.rolling_quantile_tail(x, 4000, 0.5, num_out=200)  # T = 4199
    assert qt.launches == 0
