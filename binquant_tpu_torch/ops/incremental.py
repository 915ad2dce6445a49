"""Incremental indicator state: carries that advance by one bar per tick.

Port of ``binquant_tpu/ops/incremental.py``. Each carry has ``*_init``
(from a full window, evaluating the full-window kernels' expressions, so
the init tick reads out as the full path does, to float32 ulps where a sum
is involved) and ``*_advance`` (one new bar per symbol, O(1) bytes per row;
the sorted window O(window)):

* ``EwmCarry`` — the pandas ``adjust=False`` recursion ``y' = (1-a)·y + a·x``
  plus positions since the first valid sample for ``min_periods``;
* ``SumCarry`` — windowed sum + finite count, adding the entering sample
  and subtracting the leaver (still in the ring at ``-(window+1)``);
* ``MomentCarry`` — windowed Σ(x−c), Σ(x−c)² around a per-row center ``c``
  (re-anchored when the window empties), which keeps float32 variances
  exact at BTC-scale prices;
* ``SupertrendCarry`` — the supertrend scan's carry, advanced by the same
  step body the scan runs (``ops.indicators._supertrend_step``);
* ``BetaCorrCarry`` — the five windowed sums behind the beta/corr readout;
* ``SortedCarry`` — a per-row sorted window (finite values ascending,
  ``+inf`` padding) advanced by evict-one/insert-one; its readouts
  interpolate exactly like ``ops.rolling.rolling_quantile``.

All leaves are ``(S,)`` or ``(S, k)`` tensors of the reference's dtypes
(int32 counters, float32 values, bool masks): torch's int64 defaults are
cast back wherever an expression would produce them. Drift from float32
accumulation is bounded by the engine's periodic full recompute
(``io/pipeline.py``).

The inits sum their windows with ``ops.rolling.fixed_order_sum`` (the EWM's
weighted window too, where the reference takes a dot product): the card
and the CPU then build the same carry from the same window, and since every
advance is elementwise, carry the same bits from tick to tick. With a
library reduction the two differ by a few ulps, which the carries keep and
the readouts amplify: the MACD line is the difference of two price-level
EWMs (a few ulps of a price near 100 are ~1e-5 of MACD, ×30 in
PriceTracker's score), and an MFI near 0 is the add/subtract residue of
flows near 1e5. Against the reference the inits agree to float32 ulps, as
a dot product and a reduction in another order do.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from binquant_tpu_torch.ops.rolling import ewm_last_state, fixed_order_sum
from binquant_tpu_torch.utils import jsafe_div

I32 = torch.int32
F32 = torch.float32
INF = float("inf")
NAN = float("nan")


def _fin(x: torch.Tensor) -> torch.Tensor:
    return torch.isfinite(x)


def tree_where(mask: torch.Tensor, new, old):
    """Row-select between two carries of the same structure: ``new`` where
    the (S,) ``mask`` holds, ``old`` elsewhere, leaf by leaf (the
    reference's ``tree_map(jnp.where(mask, n, o))``)."""
    if isinstance(new, tuple):
        return type(new)(*(tree_where(mask, n, o) for n, o in zip(new, old)))
    m = mask.view(-1, *([1] * (new.dim() - 1)))
    return torch.where(m, new, old)


# ---------------------------------------------------------------------------
# EWM (pandas ewm(adjust=False).mean() recursion)
# ---------------------------------------------------------------------------


class EwmCarry(NamedTuple):
    """``rel`` counts positions since the first valid sample (-1 = none)."""

    mean: torch.Tensor  # (...,) f32, 0 before the first valid sample
    rel: torch.Tensor  # (...,) int32


def ewm_init(x: torch.Tensor, alpha: float) -> EwmCarry:
    """The recursion over the window ``x`` (..., W), from the closed form
    ``ops.rolling.ewm_mean_last`` evaluates (``ewm_last_state``), summed in
    the fixed order."""
    mean, rel, any_valid = ewm_last_state(x, alpha, fixed_order=True)
    return EwmCarry(
        mean=torch.where(any_valid, mean, 0.0).to(F32),
        rel=torch.where(any_valid, rel.to(I32), -1).to(I32),
    )


def ewm_advance(carry: EwmCarry, x: torch.Tensor, alpha: float) -> EwmCarry:
    """One bar: ``y' = (1-a)·y + a·x``; a NaN contributes 0 and decays the
    carry (the full path's zero-filled matmul)."""
    started = carry.rel >= 0
    fin = _fin(x)
    xf = torch.where(fin, x, 0.0).to(F32)
    mean = torch.where(started, (1.0 - alpha) * carry.mean + alpha * xf, xf)
    rel = torch.where(
        started, carry.rel + 1, torch.where(fin, 0, -1).to(I32)
    ).to(I32)
    return EwmCarry(mean=torch.where(rel >= 0, mean, 0.0).to(F32), rel=rel)


def ewm_value(carry: EwmCarry, min_periods: int = 0) -> torch.Tensor:
    """Readout with ``min_periods`` gating (NaN before warm-up)."""
    ok = (carry.rel >= 0) & (carry.rel + 1 >= max(min_periods, 1))
    return torch.where(ok, carry.mean, NAN)


# ---------------------------------------------------------------------------
# Rolling sum (NaN-aware windowed sum + finite count)
# ---------------------------------------------------------------------------


class SumCarry(NamedTuple):
    wsum: torch.Tensor  # (...,) f32 windowed sum over finite samples
    cnt: torch.Tensor  # (...,) int32 finite samples in the window


def sum_init(x: torch.Tensor, window: int) -> SumCarry:
    tail = x[..., -window:]
    m = _fin(tail)
    return SumCarry(
        wsum=fixed_order_sum(torch.where(m, tail, 0.0)).to(F32),
        cnt=m.sum(dim=-1, dtype=I32),
    )


def sum_advance(
    carry: SumCarry, x_new: torch.Tensor, x_old: torch.Tensor
) -> SumCarry:
    """Add the entering sample, subtract the leaver (``x_old``)."""
    fn, fo = _fin(x_new), _fin(x_old)
    wsum = carry.wsum + torch.where(fn, x_new, 0.0) - torch.where(fo, x_old, 0.0)
    cnt = carry.cnt + fn.to(I32) - fo.to(I32)
    # a window that empties sheds the residue of the add/sub stream
    wsum = torch.where(cnt == 0, 0.0, wsum)
    return SumCarry(wsum=wsum.to(F32), cnt=cnt.to(I32))


def sum_value(
    carry: SumCarry, window: int, min_periods: int | None = None
) -> torch.Tensor:
    mp = window if min_periods is None else min_periods
    return torch.where(carry.cnt >= mp, carry.wsum, NAN)


def sum_mean(
    carry: SumCarry, window: int, min_periods: int | None = None
) -> torch.Tensor:
    mp = max(window if min_periods is None else min_periods, 1)
    return torch.where(
        carry.cnt >= mp, carry.wsum / torch.clamp(carry.cnt, min=1), NAN
    )


# ---------------------------------------------------------------------------
# Rolling moments (mean/std/var around a carried center)
# ---------------------------------------------------------------------------


class MomentCarry(NamedTuple):
    """Windowed Σ(x−c), Σ(x−c)² around a per-row reference ``c``, anchored
    at init and whenever the window empties: within an epoch each sample's
    centered contribution is added and later subtracted as the same f32."""

    center: torch.Tensor  # (...,) f32
    wsum: torch.Tensor  # (...,) f32 Σ(x−c)
    wsq: torch.Tensor  # (...,) f32 Σ(x−c)²
    cnt: torch.Tensor  # (...,) int32


def moment_init(x: torch.Tensor, window: int) -> MomentCarry:
    tail = x[..., -window:]
    m = _fin(tail)
    cnt = m.sum(dim=-1, dtype=I32)
    center = fixed_order_sum(torch.where(m, tail, 0.0)) / torch.clamp(cnt, min=1)
    center = torch.where(cnt > 0, center, 0.0)
    d = torch.where(m, tail - center[..., None], 0.0)
    return MomentCarry(
        center=center.to(F32),
        wsum=fixed_order_sum(d).to(F32),
        wsq=fixed_order_sum(d * d).to(F32),
        cnt=cnt,
    )


def moment_advance(
    carry: MomentCarry, x_new: torch.Tensor, x_old: torch.Tensor
) -> MomentCarry:
    fn, fo = _fin(x_new), _fin(x_old)
    center = torch.where((carry.cnt == 0) & fn, x_new, carry.center)
    dn = torch.where(fn, x_new - center, 0.0)
    do = torch.where(fo, x_old - center, 0.0)
    cnt = (carry.cnt + fn.to(I32) - fo.to(I32)).to(I32)
    wsum = carry.wsum + dn - do
    wsq = carry.wsq + dn * dn - do * do
    empty = cnt == 0
    return MomentCarry(
        center=center.to(F32),
        wsum=torch.where(empty, 0.0, wsum).to(F32),
        wsq=torch.where(empty, 0.0, torch.clamp(wsq, min=0.0)).to(F32),
        cnt=cnt,
    )


def moment_mean(
    carry: MomentCarry, window: int, min_periods: int | None = None
) -> torch.Tensor:
    mp = max(window if min_periods is None else min_periods, 1)
    mean = carry.center + carry.wsum / torch.clamp(carry.cnt, min=1)
    return torch.where(carry.cnt >= mp, mean, NAN)


def moment_var(
    carry: MomentCarry,
    window: int,
    min_periods: int | None = None,
    ddof: int = 1,
) -> torch.Tensor:
    """Σ(x−x̄)² = Σd² − (Σd)²/n, as ``rolling_std_last``."""
    mp = max(window if min_periods is None else min_periods, 1)
    cnt = carry.cnt
    sq = carry.wsq - carry.wsum * carry.wsum / torch.clamp(cnt, min=1)
    var = torch.clamp(sq, min=0.0) / torch.clamp(cnt - ddof, min=1)
    ok = (cnt >= mp) & (cnt > ddof)
    return torch.where(ok, var, NAN)


def moment_std(
    carry: MomentCarry,
    window: int,
    min_periods: int | None = None,
    ddof: int = 1,
) -> torch.Tensor:
    return torch.sqrt(moment_var(carry, window, min_periods, ddof))


# ---------------------------------------------------------------------------
# Supertrend (band ratchet + Wilder ATR — the scan's carry)
# ---------------------------------------------------------------------------


class SupertrendCarry(NamedTuple):
    atr: torch.Tensor  # (...,) f32 Wilder-ATR recursion value
    n_seen: torch.Tensor  # (...,) int32 bars consumed since the series start
    final_upper: torch.Tensor  # (...,) f32 ratcheted upper band
    final_lower: torch.Tensor  # (...,) f32 ratcheted lower band
    direction: torch.Tensor  # (...,) f32 +1/-1
    prev_close: torch.Tensor  # (...,) f32


def empty_supertrend_carry(
    num_symbols: int, *, device: torch.device | str
) -> SupertrendCarry:
    """The scan's initial carry at (S,), from the recursion's own seed."""
    from binquant_tpu_torch.ops.indicators import supertrend_scan_init

    return SupertrendCarry(*supertrend_scan_init((num_symbols,), device=device))


def supertrend_init(
    high: torch.Tensor,
    low: torch.Tensor,
    close: torch.Tensor,
    window: int = 10,
    multiplier: float = 3.0,
    start: torch.Tensor | None = None,
) -> SupertrendCarry:
    """Run the full-window scan once and keep its final carry. The series
    starts at each row's first finite bar, or at an explicit per-row
    ``start``."""
    from binquant_tpu_torch.ops.indicators import _supertrend_scan

    W = close.shape[-1]
    if start is None:
        finite = _fin(high) & _fin(low) & _fin(close)
        cols = torch.arange(W, dtype=I32, device=close.device)
        start = torch.where(finite, cols, W).amin(dim=-1).to(I32)
    carry, _, _ = _supertrend_scan(high, low, close, start, window, multiplier)
    return SupertrendCarry(*carry)


def supertrend_advance(
    carry: SupertrendCarry,
    high: torch.Tensor,
    low: torch.Tensor,
    close: torch.Tensor,
    window: int = 10,
    multiplier: float = 3.0,
    active: torch.Tensor | bool = True,
) -> tuple[SupertrendCarry, torch.Tensor, torch.Tensor]:
    """One bar through the shared step body → (carry', line, direction)."""
    from binquant_tpu_torch.ops.indicators import _supertrend_step

    if not isinstance(active, torch.Tensor):
        active = torch.full((), bool(active), device=close.device)
    active = torch.broadcast_to(active, close.shape)
    new_carry, line, dirn = _supertrend_step(
        tuple(carry), high, low, close, active, window, multiplier
    )
    return SupertrendCarry(*new_carry), line, dirn


# ---------------------------------------------------------------------------
# Rolling beta / correlation vs a benchmark (the five windowed sums)
# ---------------------------------------------------------------------------


class BetaCorrCarry(NamedTuple):
    sx: torch.Tensor
    sy: torch.Tensor
    sxy: torch.Tensor
    sxx: torch.Tensor
    syy: torch.Tensor
    cnt: torch.Tensor  # int32 both-finite pairs in the window


def empty_beta_corr_carry(
    num_symbols: int, *, device: torch.device | str
) -> BetaCorrCarry:
    def z():
        return torch.zeros((num_symbols,), dtype=F32, device=device)

    return BetaCorrCarry(
        sx=z(), sy=z(), sxy=z(), sxx=z(), syy=z(),
        cnt=torch.zeros((num_symbols,), dtype=I32, device=device),
    )


def _pairs(x: torch.Tensor, y: torch.Tensor):
    both = _fin(x) & _fin(y)
    return both, torch.where(both, x, 0.0), torch.where(both, y, 0.0)


def beta_corr_init(
    x: torch.Tensor, y: torch.Tensor, window: int = 50
) -> BetaCorrCarry:
    bx = torch.broadcast_to(y, x.shape)
    both, xf, yf = _pairs(x[..., -window:], bx[..., -window:])
    return BetaCorrCarry(
        sx=fixed_order_sum(xf).to(F32),
        sy=fixed_order_sum(yf).to(F32),
        sxy=fixed_order_sum(xf * yf).to(F32),
        sxx=fixed_order_sum(xf * xf).to(F32),
        syy=fixed_order_sum(yf * yf).to(F32),
        cnt=both.sum(dim=-1, dtype=I32),
    )


def beta_corr_advance(
    carry: BetaCorrCarry,
    x_new: torch.Tensor,
    y_new: torch.Tensor,
    x_old: torch.Tensor,
    y_old: torch.Tensor,
) -> BetaCorrCarry:
    y_new = torch.broadcast_to(y_new, x_new.shape)
    y_old = torch.broadcast_to(y_old, x_old.shape)
    fn, xn, yn = _pairs(x_new, y_new)
    fo, xo, yo = _pairs(x_old, y_old)
    cnt = (carry.cnt + fn.to(I32) - fo.to(I32)).to(I32)
    z = cnt == 0

    def upd(s, add, sub):
        return torch.where(z, 0.0, s + add - sub).to(F32)

    return BetaCorrCarry(
        sx=upd(carry.sx, xn, xo),
        sy=upd(carry.sy, yn, yo),
        sxy=upd(carry.sxy, xn * yn, xo * yo),
        sxx=upd(carry.sxx, xn * xn, xo * xo),
        syy=upd(carry.syy, yn * yn, yo * yo),
        cnt=cnt,
    )


def beta_corr_value(
    carry: BetaCorrCarry, window: int = 50
) -> tuple[torch.Tensor, torch.Tensor]:
    """(beta, corr) as ``ops.indicators.rolling_beta_corr``'s last values
    (min_periods = window, ddof=0 variance)."""
    n = torch.clamp(carry.cnt, min=1)
    mx, my = carry.sx / n, carry.sy / n
    cov = carry.sxy / n - mx * my
    var_b = carry.syy / n - my * my
    vx = torch.clamp(carry.sxx / n - mx * mx, min=0.0)
    beta = jsafe_div(cov, var_b)
    corr = torch.clamp(
        jsafe_div(cov, torch.sqrt(torch.clamp(vx * var_b, min=0.0))), -1.0, 1.0
    )
    ok = carry.cnt >= window
    return torch.where(ok, beta, NAN), torch.where(ok, corr, NAN)


# ---------------------------------------------------------------------------
# Sorted sliding window (rolling median / quantile order statistics)
# ---------------------------------------------------------------------------


class SortedCarry(NamedTuple):
    """Per-row sorted window: finite values ascending, ``+inf`` padding;
    ``cnt`` is the finite count. Eviction is by VALUE: the caller passes
    the bit-identical f32 that entered ``window`` advances ago (a ring
    column or a companion history ring returns the stored bits)."""

    sorted: torch.Tensor  # (..., window) f32
    cnt: torch.Tensor  # (...,) int32


def sorted_init(x: torch.Tensor, window: int) -> SortedCarry:
    """Carry from the trailing ``window`` samples of ``x`` (..., W>=window):
    the full-window kernels' sort (stable, so equal values, ±0.0 among
    them, keep column order as the reference's sort does)."""
    tail = x[..., -window:]
    m = _fin(tail)
    return SortedCarry(
        sorted=torch.sort(
            torch.where(m, tail, INF), dim=-1, stable=True
        ).values.to(F32),
        cnt=m.sum(dim=-1, dtype=I32),
    )


def sorted_advance(
    carry: SortedCarry, x_new: torch.Tensor, x_old: torch.Tensor
) -> SortedCarry:
    """One bar: remove ``x_old``, insert ``x_new`` — two ranks and two
    O(window) gathers per row. Non-finite samples map to the ``+inf``
    padding on both sides, so they move only the padding and ``cnt``."""
    s = carry.sorted
    window = s.shape[-1]
    fn, fo = _fin(x_new), _fin(x_old)
    xo = torch.where(fo, x_old, INF).to(F32)
    xn = torch.where(fn, x_new, INF).to(F32)

    idx = torch.arange(window, device=s.device).expand_as(s)
    # evict: the first slot holding a value >= x_old is its slot; shift
    # everything after it left (torch.gather does not broadcast: the
    # (S, window) index is built in full)
    e = (s < xo[..., None]).sum(dim=-1, keepdim=True)
    t = torch.gather(s, -1, torch.clamp(idx + (idx >= e).long(), max=window - 1))
    # insert: rank among the window-1 survivors, then shift right from it
    i = (t[..., : window - 1] < xn[..., None]).sum(dim=-1, keepdim=True)
    u = torch.where(
        idx == i,
        xn[..., None],
        torch.gather(t, -1, idx - (idx > i).long()),
    )
    cnt = (carry.cnt + fn.to(I32) - fo.to(I32)).to(I32)
    return SortedCarry(sorted=u.to(F32), cnt=cnt)


def sorted_quantile(
    carry: SortedCarry, q: float, min_periods: int = 1
) -> torch.Tensor:
    """Linear-interpolated quantile at rank ``q·(cnt−1)``, with the clamps
    and indexing of ``ops.rolling.rolling_quantile``."""
    s = carry.sorted
    window = s.shape[-1]
    cnt = carry.cnt
    rank = q * (cnt - 1.0)
    lo = torch.clamp(torch.floor(rank).to(I32), 0, window - 1)
    hi = torch.clamp(lo + 1, 0, window - 1)
    frac = rank - lo.to(s.dtype)
    v_lo = torch.gather(s, -1, lo.long()[..., None])[..., 0]
    v_hi = torch.gather(
        s, -1, torch.minimum(hi, torch.clamp(cnt - 1, min=0)).long()[..., None]
    )[..., 0]
    out = v_lo + (v_hi - v_lo) * frac
    return torch.where(cnt >= max(min_periods, 1), out, NAN)


def sorted_median(carry: SortedCarry, min_periods: int = 1) -> torch.Tensor:
    return sorted_quantile(carry, 0.5, min_periods)
