"""The port's rolling_quantile_tail against the reference.

The CUDA kernel (``binquant_tpu_torch/csrc/qtail.cu``) runs only on a card;
here its plain torch twin — the same sort-once, select-per-window
bookkeeping — is held BIT-EXACT against the reference package's
``rolling_quantile_tail`` (a sort per window), on rows with NaN runs, an
all-NaN row, ±inf blocks, ties, ±0.0 blocks and constant rows, at the
kernel's call-site shapes: ActivityBurstPump's (L=80, K=4), SpikeHunter's
(L=60, K=1), a 96-tick backtest chunk's (L=80, K=100), inputs shorter than
``L + K - 1``, the smallest window, and ``num_out`` above the width. The
wrapper's input checks run here too; the kernel-vs-twin check on the card
is ``tests/test_torch_qtail_card.py`` (and ``chip_smoke.py``).

The reference runs op by op, as its own kernel test runs it: under ``jit``
XLA's CPU backend may contract the final interpolation ``lo + (hi-lo)*frac``
into a fused multiply-add, one ulp away from the separately rounded
operations the TPU kernel, the CUDA kernel and the twin all perform.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from binquant_tpu.ops.rolling import rolling_quantile_tail as jax_qtail
from binquant_tpu_torch.ops import quantile_tail as qt
from tests.test_torch_qtail_card import assert_bit_exact, qtail_cases

# small shapes: extra intra-op threads only spin and crowd parallel test workers
torch.set_num_threads(1)


def _check(window: int, num_out: int, cols: int, q: float) -> np.ndarray:
    x = qtail_cases(cols)
    mp = min(20, max(1, window // 2))
    ref = np.asarray(jax_qtail(jnp.asarray(x), window, q, num_out=num_out, min_periods=mp))
    out = qt.rolling_quantile_tail(
        torch.from_numpy(x), window, q, num_out=num_out, min_periods=mp
    ).numpy()
    assert out.dtype == np.float32
    assert out.shape == (x.shape[0], min(num_out, cols))
    assert_bit_exact(ref, out)
    return out


@pytest.mark.parametrize("q", [0.1, 0.5, 0.92])
@pytest.mark.parametrize(
    "window,num_out,cols", [(80, 4, 128), (60, 1, 400), (80, 100, 224), (1, 1, 16)]
)
def test_twin_matches_reference_bit_exact(q, window, num_out, cols):
    out = _check(window, num_out, cols, q)
    assert np.isfinite(out).any() and np.isnan(out).any()


@pytest.mark.parametrize("q", [0.1, 0.5, 0.92])
@pytest.mark.parametrize(
    "window,num_out,cols",
    [(80, 4, 60), (80, 1, 60), (5, 40, 16)],  # W < L + K - 1; K > W is cut to W
)
def test_short_input_pads_like_reference(q, window, num_out, cols):
    _check(window, num_out, cols, q)


def test_cpu_tensor_runs_the_twin_not_the_kernel():
    qt.reset_launches()
    qt.rolling_quantile_tail(torch.from_numpy(qtail_cases()), 80, 0.92, num_out=4)
    assert qt.launches == 0


@pytest.mark.parametrize(
    "bad, exc",
    [
        (torch.zeros((4, 100), dtype=torch.float64), TypeError),
        (torch.zeros((4, 100), dtype=torch.int32), TypeError),
        (torch.zeros((100,), dtype=torch.float32), ValueError),
        (torch.zeros((2, 4, 100), dtype=torch.float32), ValueError),
        (torch.zeros((100, 4), dtype=torch.float32).T, ValueError),
    ],
)
def test_wrapper_rejects_bad_input(bad, exc):
    with pytest.raises(exc):
        qt.rolling_quantile_tail(bad, 80, 0.92, num_out=4)
