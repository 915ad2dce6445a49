"""The qtail CUDA kernel against its plain torch twin, on the card.

This file imports torch and the port only (no jax), so it runs on a machine
with a CUDA card and no JAX:

    python -m pytest tests/test_torch_qtail_card.py -m cuda -q

Without a card its test skips. The CPU parity of the twin with the
reference package is ``tests/test_torch_quantile_tail.py``, which shares
this file's inputs.
"""

import numpy as np
import pytest
import torch

from binquant_tpu_torch.ops import quantile_tail as qt

# small shapes: extra intra-op threads only spin and crowd parallel test workers
torch.set_num_threads(1)


def qtail_cases() -> np.ndarray:
    """(37, 128) float32 rows with the TPU kernel test's hard cases."""
    rng = np.random.default_rng(5)
    x = rng.random((37, 128)).astype(np.float32)
    x[3, :50] = np.nan  # leading NaN (the ring buffer's warm-up pattern)
    x[7, :] = np.nan  # all-NaN row
    x[11, -3:] = np.nan  # NaN inside the evaluated windows
    x[13, 10:20] = x[13, 0]  # ties
    x[17, -40:-30] = np.inf  # +inf inside the windows
    x[19, -70:-60] = -np.inf
    x[23, :] = 0.25  # every element ties
    return x


def assert_bit_exact(ref: np.ndarray, out: np.ndarray) -> None:
    assert ref.shape == out.shape
    np.testing.assert_array_equal(np.isnan(ref), np.isnan(out))
    np.testing.assert_array_equal(
        np.nan_to_num(ref, nan=-9e9).view(np.int32),
        np.nan_to_num(out, nan=-9e9).view(np.int32),
    )


@pytest.mark.cuda
def test_kernel_matches_twin_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the GPU machine)")
    x = torch.from_numpy(qtail_cases()).cuda()
    short = torch.from_numpy(np.ascontiguousarray(qtail_cases()[:, :60])).cuda()
    for inp, q, num_out, window in (
        (x, 0.92, 4, 80), (x, 0.85, 1, 60), (x, 0.5, 4, 80), (short, 0.92, 4, 80),
    ):
        qt.reset_launches()
        out = qt.rolling_quantile_tail(inp, window, q, num_out=num_out, min_periods=20)
        assert qt.launches == 1
        twin = qt.rolling_quantile_tail_reference(inp, window, q, num_out=num_out,
                                                  min_periods=20)
        torch.cuda.synchronize()
        assert_bit_exact(twin.cpu().numpy(), out.cpu().numpy())
