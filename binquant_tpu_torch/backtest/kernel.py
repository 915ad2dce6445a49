"""The time-batched backtest kernel: T full-recompute ticks per chunk.

Port of ``binquant_tpu/backtest/kernel.py``. The scanned drive
(``engine/step.py tick_step_scan``) threads the carried per-tick recursion
through time; this backend uses what a backtest knows up front (the whole
candle stream) to break that dependency:

* **Extended buffers**: the chunk's clean appends are laid out once as an
  ``(S, W+N)`` extension of the pre-chunk ring; the right-aligned window the
  serial drive would hold at tick t is exactly the column slice ``[c_t,
  c_t+W)``, ``c_t`` the symbol's bars applied so far. Window views are
  gathers, bit-identical to the serial rings (:func:`_window_views`).
* **Precompute**: everything context-free in the full tick — feature packs,
  symbol features, the LSP heavy core, the BTC beta/corr block — per tick on
  those views with the SAME functions the serial full tick calls
  (:func:`_precompute_one`), or, with ``ext_invariant``, once over the
  extension (:func:`_precompute_ext`, held to the gate-margin contract).
  The ABP heavy core collapses the T overlapping tails into ONE
  extended-series pass (``abp_core_batch``: the qtail kernel twice per
  chunk, site ``abp_core_batch``).
* **Sequential residue**: only the cross-tick recursions remain in the tick
  loop — the market-regime carry, PriceTracker/MeanReversionFade dedupe
  cooldowns and the grid-only policy's feedback (the scanned drive's device
  recursion) — a few (S,)-sized ops per tick (:func:`_evaluate_tick`).

The chunk emits the scanned drive's stacked ``(T, wire_length)`` wires (one
shared ``pack_wire``), so the host decodes them unchanged. Its fired set is
the serial FULL-recompute drive's (the classic engine's), not the carried
fast path's.

:func:`backtest_chunk_sweep` scores P parameter combos on one chunk: the
params-independent precompute runs once per distinct LSP parameter set,
``abp_core_batch`` once per distinct ABP parameter set, and the tick loop
once per combo (the qtail kernel is a ctypes launch, which ``vmap`` cannot
batch).

Memory: :func:`_window_views` materializes a ``(T, S, W, F)`` float32 block
per interval (T x 32.8 MB at S=2048, W=400), which ``backtest_chunk``
bounds; the per-tick feature intermediates are freed tick by tick.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from binquant_tpu_torch.engine.buffer import NUM_FIELDS, Field, MarketBuffer, fresh_mask
from binquant_tpu_torch.engine.step import (
    BC_WINDOW,
    FIFTEEN_MIN_S,
    FIVE_MIN_S,
    LIVE_STRATEGIES,
    MIN_BARS,
    WIRE_FIRED_COUNT_OFF,
    WIRE_MAX_FIRED,
    HostInputs,
    _btc_change_96,
    _btc_momentum_pair,
    _btc_row_mask,
    _ingest_digest_block,
    _ingest_interval_stats,
    _mask_outputs,
    _numeric_digest_block,
    build_summary,
    enabled_strategy_mask,
    pack_wire,
    quiet_suppression,
)
from binquant_tpu_torch.enums import MarketRegimeCode
from binquant_tpu_torch.ops.indicators import log_returns, rolling_beta_corr
from binquant_tpu_torch.regime.context import (
    ContextConfig,
    RegimeCarry,
    compute_market_context,
    compute_symbol_features,
    compute_symbol_features_ext,
)
from binquant_tpu_torch.strategies.activity_burst_pump import _abp_outputs, abp_core_batch
from binquant_tpu_torch.strategies.base import no_signal
from binquant_tpu_torch.strategies.dormant import inverse_price_tracker
from binquant_tpu_torch.strategies.features import (
    FeaturePack,
    compute_feature_pack,
    compute_feature_pack_ext,
    ext_gather,
)
from binquant_tpu_torch.strategies.ladder_deployer import ladder_deployer
from binquant_tpu_torch.strategies.liquidation_sweep_pump import (
    _lsp_outputs,
    _routing,
    lsp_core,
)
from binquant_tpu_torch.strategies.mean_reversion_fade import mean_reversion_fade
from binquant_tpu_torch.strategies.params import resolve_params
from binquant_tpu_torch.strategies.price_tracker import price_tracker

I32 = torch.int32
F32 = torch.float32

# Strategies the backend evaluates exactly: the live five plus the pack-only
# dormant InversePriceTracker. The other dormant kernels read raw buffer
# windows inside the gated half of the tick, which the precompute/evaluate
# split does not carry (they run on the serial drives).
BACKTEST_STRATEGIES: frozenset[str] = frozenset(LIVE_STRATEGIES) | {"inverse_price_tracker"}


class TickPre(NamedTuple):
    """The context-free precompute of the chunk's ticks: (T, ...) leaves
    (a FeaturePack or SymbolFeatureArrays of (T, S) leaves), read per tick
    by :func:`_at`."""

    fresh5: torch.Tensor
    fresh15: torch.Tensor
    filled5: torch.Tensor
    filled15: torch.Tensor
    pack5: FeaturePack
    pack15: FeaturePack
    feats15: object  # SymbolFeatureArrays, before the RS-vs-BTC rewrite
    lsp_score_ok: torch.Tensor
    lsp_trigger_score: torch.Tensor
    lsp_threshold: torch.Tensor
    lsp_volume_last: torch.Tensor
    btc_beta: torch.Tensor
    btc_corr: torch.Tensor
    btc_mom: torch.Tensor
    btc_change_96: torch.Tensor


def _at(tree, t: int):
    """Tick ``t`` of a (T, ...)-leading tree of tensors, NamedTuples and
    dicts."""
    if isinstance(tree, torch.Tensor):
        return tree[t]
    if isinstance(tree, dict):
        return {k: _at(v, t) for k, v in tree.items()}
    if isinstance(tree, tuple):
        items = [_at(v, t) for v in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)
    return tree


def _stack_trees(trees: list):
    """The (T, ...) stack of T same-shaped trees."""
    first = trees[0]
    if isinstance(first, torch.Tensor):
        return torch.stack(trees)
    if isinstance(first, dict):
        return {k: _stack_trees([tr[k] for tr in trees]) for k in first}
    items = [_stack_trees(list(xs)) for xs in zip(*trees)]
    return type(first)(*items) if hasattr(first, "_fields") else tuple(items)


def _window_views(
    ext_times: torch.Tensor,  # (S, L) int32
    ext_vals: torch.Tensor,  # (S, L, F)
    counts: torch.Tensor,  # (T, S)
    filled0: torch.Tensor,  # (S,)
    window: int,
) -> MarketBuffer:
    """The right-aligned (S, W) rings the serial drive would hold at every
    tick, stacked to (T, S, W(, F)): tick t's window is columns
    ``[counts[t], counts[t] + window)`` of the extension, per symbol. One
    materialized block that every consumer reads; canonical by
    construction (cursor 0)."""
    T = counts.shape[0]
    S, L = ext_times.shape
    cols = counts.long()[:, :, None] + torch.arange(window, device=counts.device)
    times = torch.gather(ext_times[None].expand(T, S, L), 2, cols)
    vals = torch.gather(
        ext_vals[None].expand(T, S, L, NUM_FIELDS), 2,
        cols[:, :, :, None].expand(T, S, window, NUM_FIELDS),
    )
    filled = torch.clamp(filled0[None, :] + counts, max=window).to(I32)
    return MarketBuffer(times=times, values=vals, filled=filled, cursor=torch.zeros_like(filled))


def _precompute_one(buf5: MarketBuffer, buf15: MarketBuffer, inp: HostInputs, sp) -> TickPre:
    """One tick's context-free half of the full tick: the same expressions
    as ``_tick_step_impl``'s full path, on that tick's window views."""
    fresh5 = fresh_mask(buf5, inp.timestamp5_s)
    fresh15 = fresh_mask(buf15, inp.timestamp_s)
    pack5 = compute_feature_pack(buf5)
    pack15 = compute_feature_pack(buf15)
    feats15 = compute_symbol_features(buf15, fresh15 & inp.tracked)
    # LSP's core stays per tick: its means and extrema are cumsum/view
    # anchored, so an extended-series pass would differ by float32 ulps
    lsp_score_ok, lsp_score, lsp_thr, lsp_vol = lsp_core(buf15, inp.oi_growth, sp.lsp)

    # the BTC-relative block, expression for expression the full path's
    S = buf15.capacity
    W = buf15.times.shape[1]
    nan = float("nan")
    onehot_rows, btc_ok = _btc_row_mask(inp.btc_row, S)
    close15 = buf15.values[:, :, Field.CLOSE]
    rets = log_returns(close15)
    btc_onehot = onehot_rows[:, None]
    btc_rets_row = torch.where(btc_onehot, rets, 0.0).sum(dim=0)
    btc_close_row = torch.where(btc_onehot, close15, 0.0).sum(dim=0)
    btc_rets = torch.where(btc_ok, btc_rets_row, nan)
    bc = rolling_beta_corr(rets, btc_rets[None, :], window=BC_WINDOW)
    btc_beta = torch.where(torch.isfinite(bc.beta[:, -1]), bc.beta[:, -1], 0.0)
    btc_corr = torch.where(torch.isfinite(bc.corr[:, -1]), bc.corr[:, -1], 0.0)
    btc_close = torch.where(btc_ok, btc_close_row, nan)
    if W > 96:
        btc_change = _btc_change_96(btc_close[-1], btc_close[-97], btc_ok)
    else:
        btc_change = torch.zeros((), dtype=F32, device=close15.device)
    btc_mom = _btc_momentum_pair(btc_close[-1], btc_close[-2])
    return TickPre(
        fresh5=fresh5, fresh15=fresh15, filled5=buf5.filled, filled15=buf15.filled,
        pack5=pack5, pack15=pack15, feats15=feats15,
        lsp_score_ok=lsp_score_ok, lsp_trigger_score=lsp_score,
        lsp_threshold=lsp_thr, lsp_volume_last=lsp_vol,
        btc_beta=btc_beta, btc_corr=btc_corr, btc_mom=btc_mom, btc_change_96=btc_change,
    )


def _precompute_ext(
    ext5: tuple[torch.Tensor, torch.Tensor],
    ext15: tuple[torch.Tensor, torch.Tensor],
    counts5: torch.Tensor,
    counts15: torch.Tensor,
    filled0: tuple[torch.Tensor, torch.Tensor],
    inputs_seq: HostInputs,  # (T, ...) leaves
    sp,
    window: int,
    wire_enabled: tuple[str, ...],
    times5_last: torch.Tensor,  # (T, S) each tick's newest bar time
    times15_last: torch.Tensor,
    filled5: torch.Tensor,  # (T, S)
    filled15: torch.Tensor,
) -> TickPre:
    """The extension-invariant precompute (``ext_invariant``): every
    position-local kernel runs ONCE over the (S, L = W + N) extension
    instead of T times over gathered views.

    Against :func:`_precompute_one`: the packs and symbol features come
    from the ``*_ext`` kernels (positional fields bit-identical, windowed
    and EWM fields under the gate-margin contract); the 15m views are
    materialized only for LSP's per-tick core, and only when it is on the
    wire; the BTC beta/corr block is ONE ``rolling_beta_corr`` over the
    extension against the extended bench row — valid because ``driver.py``
    routes here only chunks whose ``btc_row`` is constant; the per-tick
    change_96/momentum closes are exact positional gathers."""
    fresh5 = (filled5 > 0) & (times5_last == inputs_seq.timestamp5_s[:, None])
    fresh15 = (filled15 > 0) & (times15_last == inputs_seq.timestamp_s[:, None])
    pack5 = compute_feature_pack_ext(ext5[0], ext5[1], counts5, filled0[0], window)
    pack15 = compute_feature_pack_ext(ext15[0], ext15[1], counts15, filled0[1], window)
    feats15 = compute_symbol_features_ext(
        ext15[0], ext15[1], counts15, filled0[1], window, fresh15 & inputs_seq.tracked
    )
    T, S = counts15.shape
    dev = counts15.device
    if "liquidation_sweep_pump" in wire_enabled:
        views15 = _window_views(*ext15, counts15, filled0[1], window)
        lsp = _stack_trees([
            lsp_core(_at(views15, t), inputs_seq.oi_growth[t], sp.lsp) for t in range(T)
        ])
        del views15
    else:
        zeros = torch.zeros((T, S), dtype=F32, device=dev)
        lsp = (torch.zeros((T, S), dtype=torch.bool, device=dev), zeros, zeros, zeros)

    last15 = counts15.to(I32) + (window - 1)
    nan = float("nan")
    onehot_rows, btc_ok = _btc_row_mask(inputs_seq.btc_row[0], S)
    close15 = ext15[1][:, :, Field.CLOSE]
    rets = log_returns(close15)
    btc_onehot = onehot_rows[:, None]
    btc_rets_row = torch.where(btc_onehot, rets, 0.0).sum(dim=0)  # (L,)
    btc_close_row = torch.where(btc_onehot, close15, 0.0).sum(dim=0)
    btc_rets = torch.where(btc_ok, btc_rets_row, nan)
    bc = rolling_beta_corr(rets, btc_rets[None, :], window=BC_WINDOW)
    beta_g = ext_gather(bc.beta, last15)
    corr_g = ext_gather(bc.corr, last15)
    btc_close = torch.where(btc_ok, btc_close_row, nan)
    btc_counts = (counts15 * onehot_rows[None, :]).sum(dim=1)  # (T,)
    p = (btc_counts + (window - 1)).long()
    if window > 96:
        btc_change = _btc_change_96(btc_close[p], btc_close[p - 96], btc_ok)
    else:
        btc_change = torch.zeros((T,), dtype=F32, device=dev)
    return TickPre(
        fresh5=fresh5, fresh15=fresh15, filled5=filled5, filled15=filled15,
        pack5=pack5, pack15=pack15, feats15=feats15,
        lsp_score_ok=lsp[0], lsp_trigger_score=lsp[1], lsp_threshold=lsp[2],
        lsp_volume_last=lsp[3],
        btc_beta=torch.where(torch.isfinite(beta_g), beta_g, 0.0),
        btc_corr=torch.where(torch.isfinite(corr_g), corr_g, 0.0),
        btc_mom=_btc_momentum_pair(btc_close[p], btc_close[p - 1]),
        btc_change_96=btc_change,
    )


def _evaluate_tick(
    pre: TickPre,
    abp_pre: tuple,
    inp: HostInputs,
    regime_carry: RegimeCarry,
    mrf_carry: torch.Tensor,
    pt_carry: torch.Tensor,
    cfg: ContextConfig,
    wire_enabled: tuple[str, ...],
    sp,
    numeric_digest: bool = False,
    ingest_block: torch.Tensor | None = None,
    enabled_mask: torch.Tensor | None = None,
):
    """The gated half of one full tick from its precompute: the market
    context (symbol features injected), the strategy gates and the shared
    wire packing, line for line ``_tick_step_impl``'s classic path after
    its precompute. Returns ``((regime', mrf', pt'), wire, trig_counts,
    autotrade_counts)``; the counts cover the strategies of
    ``enabled_mask`` ((N,) bool in ``STRATEGY_ORDER``, built from
    ``wire_enabled`` when None)."""
    S = pre.filled15.shape[0]
    dev = pre.filled15.device
    # with injected features the context reads only the buffer's capacity
    # and fill: a thin (S, 1) shell carries both
    thin15 = MarketBuffer(
        times=torch.zeros((S, 1), dtype=I32, device=dev),
        values=torch.zeros((S, 1, NUM_FIELDS), dtype=F32, device=dev),
        filled=pre.filled15,
        cursor=torch.zeros((S,), dtype=I32, device=dev),
    )
    context, regime_carry2 = compute_market_context(
        thin15, pre.fresh15, inp.tracked, inp.btc_row, inp.timestamp_s,
        regime_carry, cfg, feats=pre.feats15,
    )
    ok5 = pre.pack5.filled >= MIN_BARS
    ok15 = pre.pack15.filled >= MIN_BARS
    ok5f, ok15f = ok5 & pre.fresh5, ok15 & pre.fresh15
    quiet_suppressed = quiet_suppression(context, inp.quiet_hours)
    skipped = no_signal(S, device=dev)

    def want(name: str) -> bool:
        return name in wire_enabled

    abp = skipped
    if want("activity_burst_pump"):
        qualified, score_last, diag = abp_pre
        abp = _mask_outputs(
            _abp_outputs(pre.filled5, context, qualified, score_last, diag, sp.abp), ok5f
        )
    pt, pt_carry2 = price_tracker(pre.pack5, context, quiet_suppressed, pt_carry, params=sp.pt)
    pt = _mask_outputs(pt, ok5f)
    pt_carry2 = torch.where(ok5f, pt_carry2, pt_carry)
    lsp = skipped
    if want("liquidation_sweep_pump"):
        routed, short_ok, route, _ = _routing(
            context, inp.adp_latest, inp.adp_prev, pre.btc_mom, sp.lsp
        )
        lsp = _mask_outputs(
            _lsp_outputs(
                pre.filled15, pre.lsp_score_ok, pre.lsp_trigger_score, pre.lsp_threshold,
                routed, short_ok, route, inp.oi_growth, inp.adp_latest, pre.btc_mom,
                pre.lsp_volume_last, sp.lsp,
            ),
            ok15f,
        )
    mrf, mrf_carry2 = mean_reversion_fade(pre.pack15, inp.is_futures, mrf_carry, sp.mrf)
    mrf = _mask_outputs(mrf, ok15f)
    mrf_carry2 = torch.where(ok15f, mrf_carry2, mrf_carry)
    ladder = skipped
    if want("grid_ladder"):
        ladder = _mask_outputs(
            ladder_deployer(
                pre.pack15, context, inp.grid_policy_allows, inp.is_futures, sp.ladder
            ),
            ok15f,
        )
    ipt = skipped
    if want("inverse_price_tracker"):
        ipt = _mask_outputs(inverse_price_tracker(pre.pack5, context), ok5f)
    strategies = {
        "activity_burst_pump": abp,
        "coinrule_price_tracker": pt,
        "liquidation_sweep_pump": lsp,
        "mean_reversion_fade": mrf,
        "grid_ladder": ladder,
        "coinrule_supertrend_swing_reversal": skipped,
        "coinrule_twap_momentum_sniper": skipped,
        "coinrule_buy_low_sell_high": skipped,
        "coinrule_buy_the_dip": skipped,
        "bb_extreme_reversion": skipped,
        "inverse_price_tracker": ipt,
        "range_bb_rsi_mean_reversion": skipped,
        "range_failed_breakout_fade": skipped,
        "relative_strength_reversal_range": skipped,
    }
    summary = build_summary(strategies)
    digest = None
    if numeric_digest:
        digest = _numeric_digest_block(
            pre.pack5, pre.pack15, summary, pre.btc_beta, pre.btc_corr,
            inp.tracked, ok5, ok15, pre.fresh5, pre.fresh15,
            torch.zeros((S,), dtype=torch.bool, device=dev),  # full path: no NaN beta rows
            # the classic step's wire-field subset
            wire_fields_only=True, sp=sp, context=context,
        )
    wire = pack_wire(
        context, strategies, summary, pre.pack5, pre.pack15,
        pre.btc_beta, pre.btc_corr, pre.btc_change_96,
        torch.zeros((), dtype=F32, device=dev),  # full path: no dirty bc rows
        tuple(wire_enabled), digest=digest, ingest=ingest_block,
    )
    enabled = (
        enabled_strategy_mask(wire_enabled, dev) if enabled_mask is None else enabled_mask
    )
    trig_counts = (summary.trigger & enabled[:, None]).sum(dim=1, dtype=I32)
    at_counts = (summary.autotrade & summary.trigger & enabled[:, None]).sum(dim=1, dtype=I32)
    return (regime_carry2, mrf_carry2, pt_carry2), wire, trig_counts, at_counts


def _chunk_ingest_counts(
    ext_times: torch.Tensor,  # (S, W+N) extension times
    counts: torch.Tensor,  # (T, S) bars applied through tick t
    window: int,
    interval_s: int,
) -> torch.Tensor:
    """(T, 4) per-tick ``(appends, rewrites, gaps, drops)`` of the ingest
    digest. The drive batches only clean strictly-newer appends, so
    rewrites and drops are zero; a gap bar (more than one interval past its
    ring predecessor) is judged position by position through one cumsum."""
    S = ext_times.shape[0]
    laid = ext_times[:, window:]  # (S, N): the k-th laid bar per symbol
    prev = ext_times[:, window - 1 : -1]
    gapflag = (laid >= 0) & (prev >= 0) & ((laid - prev) > interval_s)
    gcum = torch.cat(
        [torch.zeros((S, 1), dtype=I32, device=laid.device),
         torch.cumsum(gapflag.to(I32), dim=1, dtype=I32)],
        dim=1,
    )
    prev_counts = torch.cat([torch.zeros_like(counts[:1]), counts[:-1]], dim=0)
    appends = (counts - prev_counts).sum(dim=1).to(F32)
    g_hi = torch.gather(gcum, 1, counts.T.long())
    g_lo = torch.gather(gcum, 1, prev_counts.T.long())
    gaps = (g_hi - g_lo).sum(dim=0).to(F32)
    zeros = torch.zeros_like(appends)
    return torch.stack([appends, zeros, gaps, zeros], dim=1)


def _chunk_ingest_blocks(
    times5_last, filled5, times15_last, filled15, ext5, ext15, counts5, counts15,
    inputs_seq: HostInputs, window: int,
) -> list[torch.Tensor]:
    """Each tick's ingest block: the serial step's own interval stats over
    each tick's newest bar time and fill, the counts from
    :func:`_chunk_ingest_counts` (exact integer arithmetic: the serial
    drive's blocks bit for bit)."""
    c5 = _chunk_ingest_counts(ext5[0], counts5, window, FIVE_MIN_S)
    c15 = _chunk_ingest_counts(ext15[0], counts15, window, FIFTEEN_MIN_S)
    out = []
    for t in range(counts5.shape[0]):
        tracked = inputs_seq.tracked[t]
        out.append(_ingest_digest_block(
            tracked,
            _ingest_interval_stats(times5_last[t], filled5[t], tracked,
                                   inputs_seq.timestamp5_s[t], FIVE_MIN_S),
            _ingest_interval_stats(times15_last[t], filled15[t], tracked,
                                   inputs_seq.timestamp_s[t], FIFTEEN_MIN_S),
            c5[t], c15[t],
        ))
    return out


def _check_wire_enabled(wire_enabled) -> None:
    unsupported = set(wire_enabled) - BACKTEST_STRATEGIES
    if unsupported:
        raise ValueError(
            f"backtest backend cannot evaluate {sorted(unsupported)} — "
            "buffer-consuming dormant kernels run via the serial drives"
        )


def backtest_precompute(
    ext5, ext15, counts5, counts15, filled0, inputs_seq: HostInputs, window: int,
    wire_enabled: tuple[str, ...], sp, ext_invariant: bool = False,
) -> tuple[TickPre, tuple]:
    """The chunk's params-independent half, shared by every combo of a
    sweep with the same LSP parameters: the precompute (per tick on the
    window views, or ``ext_invariant`` over the extension), each tick's
    newest bar times and fills, and the ingest inputs. Returns ``(pre,
    (times5_last, filled5, times15_last, filled15))``."""
    T = counts5.shape[0]
    if ext_invariant:
        last5 = counts5.to(I32) + (window - 1)
        last15 = counts15.to(I32) + (window - 1)
        times5_last = ext_gather(ext5[0], last5)
        times15_last = ext_gather(ext15[0], last15)
        filled5 = torch.clamp(filled0[0][None, :] + counts5, max=window).to(I32)
        filled15 = torch.clamp(filled0[1][None, :] + counts15, max=window).to(I32)
        pre = _precompute_ext(
            ext5, ext15, counts5, counts15, filled0, inputs_seq, sp, window,
            wire_enabled, times5_last, times15_last, filled5, filled15,
        )
    else:
        views5 = _window_views(*ext5, counts5, filled0[0], window)
        views15 = _window_views(*ext15, counts15, filled0[1], window)
        pre = _stack_trees([
            _precompute_one(_at(views5, t), _at(views15, t), _at(inputs_seq, t), sp)
            for t in range(T)
        ])
        times5_last, filled5 = views5.times[:, :, -1], views5.filled
        times15_last, filled15 = views15.times[:, :, -1], views15.filled
        del views5, views15
    return pre, (times5_last, filled5, times15_last, filled15)


def abp_precompute(ext5, counts5, window: int, wire_enabled: tuple[str, ...], sp) -> tuple:
    """ABP's heavy core for the chunk's T ticks in one extended-series pass
    (two qtail launches), or zeros when ABP is not on the wire (its window
    guard must not fire for a set that never evaluates it)."""
    if "activity_burst_pump" in wire_enabled:
        return abp_core_batch(ext5[1], counts5, window, sp.abp)
    T, S = counts5.shape
    zeros = torch.zeros((T, S), dtype=F32, device=counts5.device)
    return torch.zeros((T, S), dtype=torch.bool, device=counts5.device), zeros, {}


def backtest_chunk(
    ext5: tuple[torch.Tensor, torch.Tensor],
    ext15: tuple[torch.Tensor, torch.Tensor],
    counts5: torch.Tensor,  # (T, S) int32 — bars applied through tick t
    counts15: torch.Tensor,
    filled0: tuple[torch.Tensor, torch.Tensor],  # (S,) per interval
    carries: tuple[RegimeCarry, torch.Tensor, torch.Tensor],
    inputs_seq: HostInputs,  # (T, ...) leaves
    momentum_ok: torch.Tensor,  # (T,) bool
    policy_prev: tuple[torch.Tensor, torch.Tensor],
    cfg: ContextConfig = ContextConfig(),
    wire_enabled: tuple[str, ...] = tuple(sorted(LIVE_STRATEGIES)),
    window: int = 400,
    params=None,
    numeric_digest: bool = False,
    ingest_digest: bool = False,
    ext_invariant: bool = False,
    shared: tuple | None = None,
):
    """T full-recompute ticks over the extended buffers.

    Returns ``(carries', (valid, regime), wires (T, L), fired_count (T,),
    (trig_counts, autotrade_counts) (T, N))``. Nothing here writes an
    input: a caller re-drives serially from its pre-chunk state when a
    tick's fired count exceeds ``WIRE_MAX_FIRED``. ``shared`` passes a
    sweep's ``(backtest_precompute(...), abp_precompute(...))`` results.
    ``ext_invariant`` selects :func:`_precompute_ext` (the gate-margin
    contract, never bit-pinned); ``driver.py`` routes only chunks with a
    constant ``btc_row`` there."""
    sp = resolve_params(params)
    _check_wire_enabled(wire_enabled)
    dev = ext5[0].device
    if shared is None:
        shared = (
            backtest_precompute(ext5, ext15, counts5, counts15, filled0, inputs_seq, window,
                                wire_enabled, sp, ext_invariant),
            abp_precompute(ext5, counts5, window, wire_enabled, sp),
        )
    (pre, last_bars), abp_pre = shared
    ing = (
        _chunk_ingest_blocks(*last_bars, ext5, ext15, counts5, counts15, inputs_seq, window)
        if ingest_digest else None
    )
    range_code = int(MarketRegimeCode.RANGE)
    trans_code = int(MarketRegimeCode.TRANSITIONAL)
    regime_c, mrf_c, pt_c = carries
    prev_valid, prev_regime = policy_prev
    enabled = enabled_strategy_mask(wire_enabled, dev)
    wires, tcounts, acounts = [], [], []
    for t in range(len(momentum_ok)):
        allow = momentum_ok[t] & prev_valid & (
            (prev_regime == range_code) | (prev_regime == trans_code)
        )
        inp = _at(inputs_seq, t)._replace(grid_policy_allows=allow)
        (regime_c, mrf_c, pt_c), wire, tc, ac = _evaluate_tick(
            _at(pre, t), _at(abp_pre, t), inp, regime_c, mrf_c, pt_c, cfg, wire_enabled,
            sp, numeric_digest, ingest_block=None if ing is None else ing[t],
            enabled_mask=enabled,
        )
        prev_valid = wire[0] > 0.5
        prev_regime = wire[1].to(I32)
        wires.append(wire)
        tcounts.append(tc)
        acounts.append(ac)
    stacked = torch.stack(wires)
    return (
        (regime_c, mrf_c, pt_c),
        (prev_valid, prev_regime),
        stacked,
        stacked[:, WIRE_FIRED_COUNT_OFF],
        (torch.stack(tcounts), torch.stack(acounts)),
    )


def backtest_chunk_sweep(
    ext5,
    ext15,
    counts5,
    counts15,
    filled0,
    carries: list,  # per combo: (RegimeCarry, mrf, pt)
    inputs_seq: HostInputs,
    momentum_ok: torch.Tensor,
    policy_prev: list,  # per combo: (valid, regime)
    cfg: ContextConfig = ContextConfig(),
    wire_enabled: tuple[str, ...] = tuple(sorted(LIVE_STRATEGIES)),
    window: int = 400,
    params: list | None = None,  # per combo StrategyParams
    with_fired_slots: bool = True,
    ext_invariant: bool = False,
):
    """P parameter combos over one chunk. The precompute runs once per
    distinct LSP parameter set and ``abp_core_batch`` once per distinct
    ABP parameter set (once in all when neither is swept); the tick loop
    runs per combo. Returns ``(carries' [P], policy' [P], fired_count (P,
    T), trig_counts (P, T, N), autotrade_counts (P, T, N), fired_slots (P,
    T, 3, K) or None)``: the slots are rows (strategy_idx, row, direction)
    of each wire's fired block, the outcome scorer's join keys; the wires
    themselves are not kept."""
    K = WIRE_MAX_FIRED
    off = WIRE_FIRED_COUNT_OFF
    sps = [resolve_params(p) for p in (params or [None] * len(carries))]
    pre_cache: dict = {}
    abp_cache: dict = {}
    out_c, out_p, fired, tcs, acs, slots = [], [], [], [], [], []
    for carries_one, policy_one, sp in zip(carries, policy_prev, sps):
        if sp.lsp not in pre_cache:
            pre_cache[sp.lsp] = backtest_precompute(
                ext5, ext15, counts5, counts15, filled0, inputs_seq, window, wire_enabled,
                sp, ext_invariant,
            )
        if sp.abp not in abp_cache:
            abp_cache[sp.abp] = abp_precompute(ext5, counts5, window, wire_enabled, sp)
        c2, p2, wires, f, (tc, ac) = backtest_chunk(
            ext5, ext15, counts5, counts15, filled0, carries_one, inputs_seq,
            momentum_ok, policy_one, cfg, wire_enabled, window, sp,
            ext_invariant=ext_invariant, shared=(pre_cache[sp.lsp], abp_cache[sp.abp]),
        )
        out_c.append(c2)
        out_p.append(p2)
        fired.append(f)
        tcs.append(tc)
        acs.append(ac)
        if with_fired_slots:
            blocks = wires[:, off + 1 : off + 1 + 6 * K].reshape(wires.shape[0], 6, K)
            slots.append(blocks[:, [0, 1, 3], :])
    return (
        out_c, out_p, torch.stack(fired), torch.stack(tcs), torch.stack(acs),
        torch.stack(slots) if with_fired_slots else None,
    )
