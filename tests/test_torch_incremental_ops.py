"""The incremental carries: the port against the reference, carry by carry.

Every carry of ``binquant_tpu_torch/ops/incremental.py`` is built from the
first ``W0`` columns of a seeded stream and advanced column by column over
the rest, in both packages; the carried leaves and the readouts are compared
after the init and after every advance. The stream's rows hold NaN runs,
+inf and -inf, runs of ties, interleaved ±0.0, and NaN runs longer than the
window, so windows empty out and refill.

The reference runs op by op (``jax.disable_jit()``): XLA's CPU compiler may
contract ``a*x + b*y`` into a fused multiply-add inside a jitted function,
which the port's separate torch ops never do, and that one-ulp difference is
the compiler's, not the algorithm's.

Contract:

* integer counters (``rel``, ``cnt``, ``n_seen``) exactly;
* sorted windows and their quantile/median readouts bit for bit (a sorted
  carry holds the window's multiset, and ±0.0 and ties keep column order);
* one advance from the SAME carry (the reference's carry converted into the
  port) bit for bit, for every family: each advance is elementwise;
* float leaves that accumulate sums (EWM, sum, moment, beta/corr sums, the
  supertrend's ATR and bands) within ``rtol=1e-5, atol=1e-5`` of values of
  order 1 (about 84 float32 ulps): the init's window sums and matmul run in
  another order in torch, and the add/subtract streams carry that residue.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from binquant_tpu.ops import incremental as J
from binquant_tpu.ops import indicators as JI
from binquant_tpu_torch.ops import incremental as T
from binquant_tpu_torch.ops import indicators as TI

# small shapes: extra intra-op threads only spin and crowd parallel test workers
torch.set_num_threads(1)

S, N, W0 = 24, 120, 40  # rows, stream columns, columns before the first advance
RTOL = ATOL = 1e-5


def _stream(seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    x = rng.normal(0.0, 1.0, (S, N)).astype(np.float32)
    x[1, 10:30] = np.nan  # a NaN run inside the first window
    x[2, 35:90] = np.nan  # longer than the windows: they empty out
    x[3, 50] = np.inf
    x[3, 70] = -np.inf
    x[4, 20:60] = x[4, 20]  # a run of ties
    x[5, :] = np.where(np.arange(N) % 2 == 0, -0.0, 0.0)  # interleaved ±0.0
    x[6, 60:] = np.nan  # stops for good
    x[7, :25] = np.nan  # starts late
    x[8, ::7] = np.nan  # scattered gaps
    x[9, 40:80] = np.round(x[9, 40:80])  # many ties, zeros among them
    x[10, :] = np.nan  # never any data
    return x


@pytest.fixture(scope="module")
def xs() -> dict:
    return {"x": _stream(7), "y": _stream(8)[0]}


def _np(v) -> np.ndarray:
    return np.asarray(v.detach().numpy() if isinstance(v, torch.Tensor) else v)


def _to_port(jcarry, cls):
    """The reference's carry as the port's (same fields, same dtypes)."""
    return cls(*(torch.from_numpy(np.array(np.asarray(v))) for v in jcarry))


def _check_leaves(jc, tc, exact: set[str], where: str) -> None:
    assert type(tc)._fields == type(jc)._fields, where
    for f in type(jc)._fields:
        a, b = np.asarray(getattr(jc, f)), _np(getattr(tc, f))
        assert a.dtype == b.dtype and a.shape == b.shape, (where, f, a.dtype, b.dtype)
        if f in exact or a.dtype.kind != "f":
            _bits_equal(a, b, f"{where} {f}")
        else:
            np.testing.assert_allclose(b, a, rtol=RTOL, atol=ATOL, err_msg=f"{where} {f}")


def _bits_equal(a, b, what: str) -> None:
    a, b = np.asarray(a), np.asarray(b)
    if a.dtype.kind == "f":
        assert np.array_equal(np.isnan(a), np.isnan(b)), what
        a = np.where(np.isnan(a), np.float32(0), a).view(np.int32)
        b = np.where(np.isnan(b), np.float32(0), b).view(np.int32)
    np.testing.assert_array_equal(a, b, err_msg=what)


def _readouts_close(a, b, what: str) -> None:
    np.testing.assert_allclose(_np(b), np.asarray(a), rtol=RTOL, atol=ATOL, err_msg=what)


# --------------------------------------------------------------------------
# EWM
# --------------------------------------------------------------------------


@pytest.mark.parametrize("alpha", [2.0 / 10.0, 2.0 / 27.0, 1.0 / 14.0])
def test_ewm_carry(xs, alpha):
    x = xs["x"]
    with jax.disable_jit():
        jc = J.ewm_init(jnp.asarray(x[:, :W0]), alpha)
        tc = T.ewm_init(torch.from_numpy(x[:, :W0]), alpha)
        _check_leaves(jc, tc, set(), "init")
        for t in range(W0, N):
            jc = J.ewm_advance(jc, jnp.asarray(x[:, t]), alpha)
            tc = T.ewm_advance(tc, torch.from_numpy(x[:, t]), alpha)
            _check_leaves(jc, tc, set(), f"advance {t}")
            for mp in (1, 14):
                _readouts_close(J.ewm_value(jc, mp), T.ewm_value(tc, mp), f"value {t}")


# --------------------------------------------------------------------------
# Rolling sums and moments
# --------------------------------------------------------------------------


@pytest.mark.parametrize("window", [14, 20])
def test_sum_carry(xs, window):
    x = xs["x"]
    with jax.disable_jit():
        jc = J.sum_init(jnp.asarray(x[:, :W0]), window)
        tc = T.sum_init(torch.from_numpy(x[:, :W0]), window)
        _check_leaves(jc, tc, set(), "init")
        for t in range(W0, N):
            args = x[:, t], x[:, t - window]
            jc = J.sum_advance(jc, *map(jnp.asarray, args))
            tc = T.sum_advance(tc, *map(torch.from_numpy, args))
            _check_leaves(jc, tc, set(), f"advance {t}")
            for mp in (None, 1):
                _readouts_close(J.sum_value(jc, window, mp), T.sum_value(tc, window, mp), "value")
                _readouts_close(J.sum_mean(jc, window, mp), T.sum_mean(tc, window, mp), "mean")


@pytest.mark.parametrize("window", [14, 20])
def test_moment_carry(xs, window):
    x = xs["x"] * 50.0 + 60000.0  # BTC-scale prices: the centering matters
    x = x.astype(np.float32)
    with jax.disable_jit():
        jc = J.moment_init(jnp.asarray(x[:, :W0]), window)
        tc = T.moment_init(torch.from_numpy(x[:, :W0]), window)
        _check_moment(jc, tc, "init")
        for t in range(W0, N):
            args = x[:, t], x[:, t - window]
            jc = J.moment_advance(jc, *map(jnp.asarray, args))
            tc = T.moment_advance(tc, *map(torch.from_numpy, args))
            _check_moment(jc, tc, f"advance {t}")
            for mp in (None, 1):
                a, b = J.moment_mean(jc, window, mp), T.moment_mean(tc, window, mp)
                np.testing.assert_allclose(_np(b), np.asarray(a), rtol=RTOL, err_msg="mean")
                # the variance, not the std: a window down to one sample
                # reads sqrt(residue of Σd²), and d≈100 leaves a residue of
                # a few ulps of 1e4 in either package
                a, b = J.moment_var(jc, window, mp, 0), T.moment_var(tc, window, mp, 0)
                np.testing.assert_allclose(_np(b), np.asarray(a), rtol=1e-4, atol=1e-2,
                                           err_msg="var")


def _check_moment(jc, tc, where: str) -> None:
    """The center is a window mean, so another summation order moves it by
    a few ulps; every centered sample then moves by the same amount, and
    Σ(x−c) by up to cnt of them. Tolerances in ulps of the center:
    ``center`` 8, ``wsum`` 8·(cnt+1), ``wsq`` rtol 1e-5 beside 2·|wsum| of
    those ulps (the readouts, mean and variance, are held above)."""
    a = {f: np.asarray(getattr(jc, f)) for f in J.MomentCarry._fields}
    b = {f: _np(getattr(tc, f)) for f in T.MomentCarry._fields}
    for f in a:
        assert a[f].dtype == b[f].dtype and a[f].shape == b[f].shape, (where, f)
    np.testing.assert_array_equal(a["cnt"], b["cnt"], err_msg=f"{where} cnt")
    ulp = np.spacing(np.abs(a["center"]).astype(np.float32))
    assert np.all(np.abs(a["center"] - b["center"]) <= 8 * ulp), f"{where} center"
    tol_sum = 8 * (a["cnt"] + 1) * ulp
    assert np.all(np.abs(a["wsum"] - b["wsum"]) <= tol_sum + ATOL), f"{where} wsum"
    tol_sq = RTOL * np.abs(a["wsq"]) + 2 * np.abs(a["wsum"]) * tol_sum + ATOL
    assert np.all(np.abs(a["wsq"] - b["wsq"]) <= tol_sq), f"{where} wsq"


# --------------------------------------------------------------------------
# Beta / correlation
# --------------------------------------------------------------------------


def test_beta_corr_carry(xs):
    x, y = xs["x"] * 0.01, xs["y"] * 0.01
    window = 30
    with jax.disable_jit():
        jc = J.beta_corr_init(jnp.asarray(x[:, :W0]), jnp.asarray(y[None, :W0]), window)
        tc = T.beta_corr_init(torch.from_numpy(x[:, :W0]), torch.from_numpy(y[None, :W0]),
                              window)
        _check_leaves(jc, tc, set(), "init")
        for t in range(W0, N):
            args = (x[:, t], np.float32(y[t]), x[:, t - window], np.float32(y[t - window]))
            jc = J.beta_corr_advance(jc, *map(jnp.asarray, args))
            tc = T.beta_corr_advance(tc, *(torch.tensor(a) for a in args))
            _check_leaves(jc, tc, set(), f"advance {t}")
            (jb, jr), (tb, tr) = J.beta_corr_value(jc, window), T.beta_corr_value(tc, window)
            np.testing.assert_allclose(_np(tb), np.asarray(jb), rtol=1e-3, atol=1e-3)
            np.testing.assert_allclose(_np(tr), np.asarray(jr), rtol=1e-3, atol=1e-3)


# --------------------------------------------------------------------------
# Sorted windows: bit for bit
# --------------------------------------------------------------------------


@pytest.mark.parametrize("window", [19, 48, 80])
def test_sorted_carry_bit_exact(xs, window):
    # init on the columns just before each row's empty-out run, then 64
    # advances: every window sees the NaN runs enter, fill and leave
    x = np.concatenate([xs["x"], xs["x"]], axis=1)
    w0 = max(W0, window)
    with jax.disable_jit():
        jc = J.sorted_init(jnp.asarray(x[:, :w0]), window)
        tc = T.sorted_init(torch.from_numpy(x[:, :w0]), window)
        _check_leaves(jc, tc, {"sorted"}, "init")
        for t in range(w0, w0 + 64):
            args = x[:, t], x[:, t - window]
            jc = J.sorted_advance(jc, *map(jnp.asarray, args))
            tc = T.sorted_advance(tc, *map(torch.from_numpy, args))
            _check_leaves(jc, tc, {"sorted"}, f"advance {t}")
            if t % 4:
                continue
            for q, mp in ((0.92, 20), (0.8, 1), (0.5, window)):
                _bits_equal(J.sorted_quantile(jc, q, mp), _np(T.sorted_quantile(tc, q, mp)),
                            f"quantile {q} at {t}")
            _bits_equal(J.sorted_median(jc, 1), _np(T.sorted_median(tc, 1)), f"median {t}")


# --------------------------------------------------------------------------
# Supertrend
# --------------------------------------------------------------------------


def _ohlc(xs):
    close = (100.0 + np.cumsum(np.nan_to_num(xs["x"], posinf=0.0, neginf=0.0), axis=1))
    close = close.astype(np.float32)
    close[2, 35:90] = np.nan  # a mid-series gap poisons the ATR
    high = (close * 1.01).astype(np.float32)
    low = (close * 0.99).astype(np.float32)
    start = np.array([0, 5, 0, 3, 30, 100, 0, 25, 2, 0, 0] + [1] * (S - 11), np.int32)
    return high, low, close, start


def test_supertrend_scan_and_advance(xs):
    high, low, close, start = _ohlc(xs)
    with jax.disable_jit():
        jinit = J.supertrend_init(*(jnp.asarray(a[:, :W0]) for a in (high, low, close)),
                                  10, 3.0, start=jnp.asarray(start))
        tinit = T.supertrend_init(*(torch.from_numpy(a[:, :W0]) for a in (high, low, close)),
                                  10, 3.0, start=torch.from_numpy(start))
        _check_leaves(jinit, tinit, {"direction", "final_upper", "final_lower"}, "init")
        # the scan's full series over the init columns
        jf, jl, jd = JI._supertrend_scan(*(jnp.asarray(a[:, :W0]) for a in (high, low, close)),
                                         jnp.asarray(start), 10, 3.0)
        tf, tl, td = TI._supertrend_scan(
            *(torch.from_numpy(a[:, :W0]) for a in (high, low, close)),
            torch.from_numpy(start), 10, 3.0,
        )
        _bits_equal(np.asarray(jd), _np(td), "direction series")
        np.testing.assert_allclose(_np(tl), np.asarray(jl), rtol=RTOL, err_msg="line series")
        jc, tc = jinit, tinit
        for t in range(W0, W0 + 50):
            active = np.arange(S) % 5 != 4  # some lanes sit out
            args = (high[:, t], low[:, t], close[:, t])
            jc, jline, jdir = J.supertrend_advance(jc, *map(jnp.asarray, args), 10, 3.0,
                                                   active=jnp.asarray(active))
            tc, tline, tdir = T.supertrend_advance(tc, *map(torch.from_numpy, args), 10, 3.0,
                                                   active=torch.from_numpy(active))
            _check_leaves(jc, tc, {"direction"}, f"advance {t}")
            _bits_equal(np.asarray(jdir), _np(tdir), f"direction {t}")
            np.testing.assert_allclose(_np(tline), np.asarray(jline), rtol=RTOL)


def test_supertrend_empty_carry_matches():
    j = J.empty_supertrend_carry(S)
    t = T.empty_supertrend_carry(S, device="cpu")
    _check_leaves(j, t, set(J.SupertrendCarry._fields), "empty")


# --------------------------------------------------------------------------
# One advance from the SAME carry: bit for bit, every family
# --------------------------------------------------------------------------


FAMILIES = ["ewm", "sum", "moment", "beta_corr", "sorted", "supertrend"]


@pytest.mark.parametrize("family", FAMILIES)
def test_advance_from_shared_carry_bit_exact(xs, family):
    x, y = xs["x"], xs["y"]
    high, low, close, start = _ohlc(xs)
    a_new, a_old = x[:, W0], x[:, W0 - 20]
    with jax.disable_jit():
        if family == "ewm":
            jc = J.ewm_init(jnp.asarray(x[:, :W0]), 0.2)
            step = (lambda m, c, a, b: m.ewm_advance(c, a, 0.2)), T.EwmCarry
        elif family == "sum":
            jc = J.sum_init(jnp.asarray(x[:, :W0]), 20)
            step = (lambda m, c, a, b: m.sum_advance(c, a, b)), T.SumCarry
        elif family == "moment":
            jc = J.moment_init(jnp.asarray(x[:, :W0]), 20)
            step = (lambda m, c, a, b: m.moment_advance(c, a, b)), T.MomentCarry
        elif family == "beta_corr":
            jc = J.beta_corr_init(jnp.asarray(x[:, :W0]), jnp.asarray(y[None, :W0]), 20)
            yn, yo = np.float32(y[W0]), np.float32(y[W0 - 20])

            def adv(m, c, a, b, yn=yn, yo=yo):
                conv = jnp.asarray if m is J else torch.tensor
                return m.beta_corr_advance(c, a, conv(yn), b, conv(yo))

            step = adv, T.BetaCorrCarry
        elif family == "sorted":
            jc = J.sorted_init(jnp.asarray(x[:, :W0]), 20)
            step = (lambda m, c, a, b: m.sorted_advance(c, a, b)), T.SortedCarry
        else:
            jc = J.supertrend_init(*(jnp.asarray(a[:, :W0]) for a in (high, low, close)),
                                   10, 3.0, start=jnp.asarray(start))
            a_new, a_old = close[:, W0], None

            def adv(m, c, a, b):
                conv = jnp.asarray if m is J else torch.from_numpy
                return m.supertrend_advance(c, conv(high[:, W0]), conv(low[:, W0]), a,
                                            10, 3.0)[0]

            step = adv, T.SupertrendCarry
        fn, cls = step
        tc = _to_port(jc, cls)
        jn = fn(J, jc, jnp.asarray(a_new), None if a_old is None else jnp.asarray(a_old))
        tn = fn(T, tc, torch.from_numpy(a_new),
                None if a_old is None else torch.from_numpy(a_old))
    _check_leaves(jn, tn, set(cls._fields), family)


def test_tree_where_selects_rows():
    new = T.SumCarry(wsum=torch.ones(4), cnt=torch.ones(4, dtype=torch.int32))
    old = T.SumCarry(wsum=torch.zeros(4), cnt=torch.zeros(4, dtype=torch.int32))
    mask = torch.tensor([True, False, True, False])
    out = T.tree_where(mask, new, old)
    assert out.wsum.tolist() == [1, 0, 1, 0] and out.cnt.dtype == torch.int32
    ring = T.tree_where(mask, torch.ones(4, 3), torch.zeros(4, 3))
    assert ring[:, 0].tolist() == [1, 0, 1, 0] and ring.shape == (4, 3)
