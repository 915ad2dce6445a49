"""The port's rolling_quantile_tail against the reference.

The CUDA kernel (``binquant_tpu_torch/csrc/qtail.cu``) runs only on a card;
here its plain torch twin — the same count-rank selection — is held BIT-EXACT
against the reference package's ``rolling_quantile_tail`` (the windowed sort
the TPU kernel is pinned to), on the TPU kernel test's cases
(``tests/test_pallas_rolling.py``): leading NaN, an all-NaN row, NaN inside
the window, ties, and ±inf added. The wrapper's input checks run here too;
the kernel-vs-twin check on the card is ``tests/test_torch_qtail_card.py``
(and ``chip_smoke.py``).

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


@pytest.mark.parametrize("q", [0.5, 0.8, 0.92])
@pytest.mark.parametrize("num_out", [1, 4])
@pytest.mark.parametrize("window,min_periods", [(80, 20), (60, 20)])
def test_twin_matches_reference_bit_exact(q, num_out, window, min_periods):
    x = qtail_cases()
    ref = np.asarray(
        jax_qtail(jnp.asarray(x), window, q, num_out=num_out, min_periods=min_periods)
    )
    out = qt.rolling_quantile_tail(
        torch.from_numpy(x), window, q, num_out=num_out, min_periods=min_periods
    ).numpy()
    assert out.dtype == np.float32
    assert_bit_exact(ref, out)
    assert np.isfinite(out).any() and np.isnan(out).any()


@pytest.mark.parametrize("num_out", [1, 4])
def test_short_input_pads_like_reference(num_out):
    x = np.ascontiguousarray(qtail_cases()[:, :60])  # W < window + num_out - 1
    ref = np.asarray(jax_qtail(jnp.asarray(x), 80, 0.92, num_out=num_out, min_periods=20))
    out = qt.rolling_quantile_tail(torch.from_numpy(x), 80, 0.92, num_out=num_out,
                                   min_periods=20).numpy()
    assert_bit_exact(ref, out)


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
