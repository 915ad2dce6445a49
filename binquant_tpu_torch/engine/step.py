"""The per-tick step: the live wire path on the card.

Port of ``binquant_tpu/engine/step.py`` for the live wire step
(``compute_all=False``, both digests off): apply the candle updates to the
two rings, compute the feature packs, the market context, the BTC-relative
block and the five live strategies for ALL symbols at once, and pack
everything the host needs into ONE float32 wire — context scalars, a
fixed-size compaction of the fired (strategy, row) pairs, a per-slot
emission payload and the (3, S) calibration rows. The wire layout is the
reference's, so :func:`unpack_wire` decodes either package's wire.

Two paths, chosen by the host per tick:

* the FULL tick (``incremental=False``) materializes both rings
  canonically (cursor 0) and recomputes every indicator from the windows;
  with ``maintain_carry`` it also rebuilds the :class:`IndicatorCarry`
  from the windows (:func:`init_indicator_carry`), the resync every cold
  start, rewrite, churn and audit tick provides;
* the INCREMENTAL tick (``incremental=True``) gathers only a shallow tail
  of each ring (the ring itself stays mid-phase), advances every carried
  family by the newest bar (:func:`advance_indicator_carry`) and reads
  the packs, the context's symbol features, ABP, LSP and the beta/corr
  block from the carry.

Dormant strategies are not evaluated: they ride the summary as
``no_signal`` rows, exactly as the reference's wire-only step compiles them
away. The spike detector feeds only a dormant strategy and is skipped.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from binquant_tpu_torch.engine.buffer import (
    Field,
    MarketBuffer,
    apply_updates,
    empty_buffer,
    fresh_mask,
    materialize,
    materialize_tail,
)
from binquant_tpu_torch.ops.incremental import (
    BetaCorrCarry,
    SupertrendCarry,
    beta_corr_advance,
    beta_corr_init,
    beta_corr_value,
    empty_beta_corr_carry,
    empty_supertrend_carry,
    supertrend_advance,
    supertrend_init,
    tree_where,
)
from binquant_tpu_torch.ops.indicators import log_returns, rolling_beta_corr
from binquant_tpu_torch.regime.context import (
    ContextConfig,
    MarketContext,
    RegimeCarry,
    compute_market_context,
    initial_regime_carry,
    symbol_features_from_carry,
)
from binquant_tpu_torch.regime.routing import allows_long_autotrade_mask
from binquant_tpu_torch.regime.time_filter import (
    MIN_TRANSITION_STRENGTH,
    OVERRIDE_REGIMES,
)
from binquant_tpu_torch.strategies.activity_burst_pump import (
    ABP_INIT_MIN_WINDOW,
    ABP_MIN_WINDOW,
    TAIL as _ABP_TAIL,
    ABPCarry,
    _baseline_window,
    abp_advance_one_bar,
    abp_init_from_window,
    activity_burst_pump,
    activity_burst_pump_from_carry,
    empty_abp_carry,
)
from binquant_tpu_torch.strategies.base import StrategyOutputs, no_signal
from binquant_tpu_torch.strategies.features import (
    FeatureCarry,
    FeaturePack,
    advance_feature_carry,
    carry_advance_masks,
    compute_feature_pack,
    empty_feature_carry,
    feature_pack_from_carry,
    init_feature_carry,
)
from binquant_tpu_torch.strategies.ladder_deployer import ladder_deployer
from binquant_tpu_torch.strategies.liquidation_sweep_pump import (
    LSP_INIT_MIN_WINDOW,
    LSP_MIN_WINDOW,
    LSPCarry,
    empty_lsp_carry,
    liquidation_sweep_pump,
    liquidation_sweep_pump_from_carry,
    lsp_advance_one_bar,
    lsp_init_from_window,
)
from binquant_tpu_torch.strategies.mean_reversion_fade import mean_reversion_fade
from binquant_tpu_torch.strategies.params import resolve_params
from binquant_tpu_torch.strategies.price_tracker import price_tracker

I32 = torch.int32
F32 = torch.float32

# data sufficiency: strategies are masked where filled < 100
MIN_BARS = 100
# the supertrend carry's (window, multiplier) and the beta/corr window
ST_WINDOW, ST_MULT = 10, 3.0
BC_WINDOW = 50

LIVE_STRATEGIES: frozenset[str] = frozenset(
    {
        "activity_burst_pump",
        "coinrule_price_tracker",
        "liquidation_sweep_pump",
        "mean_reversion_fade",
        "grid_ladder",
    }
)

STRATEGY_ORDER: tuple[str, ...] = (
    "activity_burst_pump",
    "coinrule_price_tracker",
    "liquidation_sweep_pump",
    "mean_reversion_fade",
    "grid_ladder",
    "coinrule_supertrend_swing_reversal",
    "coinrule_twap_momentum_sniper",
    "coinrule_buy_low_sell_high",
    "coinrule_buy_the_dip",
    "bb_extreme_reversion",
    "inverse_price_tracker",
    "range_bb_rsi_mean_reversion",
    "range_failed_breakout_fade",
    "relative_strength_reversal_range",
)

FIVE_MIN_STRATEGIES: frozenset[str] = frozenset(
    {
        "activity_burst_pump",
        "coinrule_price_tracker",
        "coinrule_supertrend_swing_reversal",
        "coinrule_twap_momentum_sniper",
        "inverse_price_tracker",
    }
)

# --- wire layout (identical to the reference's) ---------------------------
WIRE_MAX_FIRED = 128
EMISSION_DIAG_WIDTH = 16
EMISSION_BASE_FIELDS: tuple[str, ...] = (
    "close5", "volume5", "bb_upper5", "bb_mid5", "bb_lower5",
    "close15", "volume15", "bb_upper15", "bb_mid15", "bb_lower15",
    "micro_regime", "micro_transition", "btc_beta", "btc_corr",
)
EMISSION_SLOT_WIDTH = len(EMISSION_BASE_FIELDS) + EMISSION_DIAG_WIDTH
# (key, kind) per strategy per wire_enabled key, kind in {"b","i","f"};
# refreshed by every pack_wire call and read by io.emission
EMISSION_LAYOUTS: dict[tuple, dict[str, list[tuple[str, str]]]] = {}
WIRE_SCALARS_A: tuple[str, ...] = (
    "valid",
    "market_regime",
    "previous_market_regime",
    "market_regime_transition",
    "market_regime_transition_strength",
    "regime_is_transitioning",
    "market_stress_score",
    "advancers_ratio",
    "long_tailwind",
    "short_tailwind",
    "fresh_count",
    "average_return",
)
WIRE_SCALARS_B: tuple[str, ...] = (
    "long_regime_score",
    "short_regime_score",
    "range_regime_score",
    "stress_regime_score",
    "btc_regime_score",
    "btc_price_change_96",
    "bc_dirty_rows",
)
_WIRE_TS_BASE = 65536
WIRE_FIRED_COUNT_OFF = len(WIRE_SCALARS_A) + len(WIRE_SCALARS_B) + 4


def wire_length(num_symbols: int) -> int:
    """Length of the classic wire for ``num_symbols`` rows."""
    return (
        WIRE_FIRED_COUNT_OFF + 1 + 6 * WIRE_MAX_FIRED
        + WIRE_MAX_FIRED * EMISSION_SLOT_WIDTH + 3 * num_symbols
    )


class IndicatorCarry(NamedTuple):
    """Incremental indicator and strategy-stage state, rebuilt from the
    windows by every full tick and advanced by one bar per incremental
    tick:

    * ``pack5``/``pack15`` — the per-timeframe feature packs;
    * ``abp5``/``lsp15`` — the ActivityBurstPump / LiquidationSweepPump
      order-statistic carries;
    * ``st5`` — the supertrend scan carry (it feeds only the dormant
      ``coinrule_supertrend_swing_reversal``, and rides the state as in
      the reference). The carry continues ONE recursion between resyncs;
      the full path re-runs it from the sliding seed, so the two differ by
      the Wilder ATR's forgotten prefix;
    * ``bc15``/``bc_dirty`` — the BTC beta/corr windowed sums. A row that
      advances out of step with the BTC row would re-pair its whole window
      (the full kernel pairs positionally): it goes dirty and reads NaN
      until the next full recompute.
    """

    pack5: FeatureCarry
    pack15: FeatureCarry
    abp5: ABPCarry
    lsp15: LSPCarry
    st5: SupertrendCarry
    bc15: BetaCorrCarry
    bc_dirty: torch.Tensor  # (S,) bool


class EngineState(NamedTuple):
    """Device-resident state carried across ticks. ``indicator_carry`` is
    the incremental path's carry (None only where a caller built a state
    without one; a classic step passes it through)."""

    buf5: MarketBuffer
    buf15: MarketBuffer
    regime_carry: RegimeCarry
    mrf_last_emitted: torch.Tensor  # (S,) int32 — MeanReversionFade dedupe
    pt_last_signal_close: torch.Tensor  # (S,) int32 — PriceTracker cooldown
    indicator_carry: IndicatorCarry | None = None


class HostInputs(NamedTuple):
    """Per-tick host-resolved scalars/arrays (REST-derived state, wall
    clock, settings), as tensors on the engine's device."""

    tracked: torch.Tensor  # (S,) bool
    btc_row: torch.Tensor  # int32 scalar
    timestamp_s: torch.Tensor  # int32 scalar — evaluated 15m bucket open
    timestamp5_s: torch.Tensor  # int32 scalar — current 5m bucket open
    oi_growth: torch.Tensor  # (S,) f32, NaN unavailable
    adp_latest: torch.Tensor  # f32
    adp_prev: torch.Tensor  # f32, NaN = no history
    adp_diff: torch.Tensor  # f32
    adp_diff_prev: torch.Tensor  # f32
    breadth_momentum_points: torch.Tensor  # f32
    quiet_hours: torch.Tensor  # bool — London quiet window active
    grid_policy_allows: torch.Tensor  # bool
    is_futures: torch.Tensor  # bool
    dominance_is_losers: torch.Tensor  # bool
    market_domination_reversal: torch.Tensor  # bool


class TriggerSummary(NamedTuple):
    trigger: torch.Tensor  # (N, S) bool
    autotrade: torch.Tensor  # (N, S) bool
    direction: torch.Tensor  # (N, S) int32
    score: torch.Tensor  # (N, S) f32
    stop_loss_pct: torch.Tensor  # (N, S) f32


class TickOutputs(NamedTuple):
    context: MarketContext
    fresh5: torch.Tensor
    fresh15: torch.Tensor
    long_gate: torch.Tensor
    pack5: FeaturePack
    pack15: FeaturePack
    btc_beta: torch.Tensor
    btc_corr: torch.Tensor
    btc_price_change_96: torch.Tensor
    strategies: dict[str, StrategyOutputs]
    summary: TriggerSummary
    wire: torch.Tensor


def default_host_inputs(
    num_symbols: int, *, device: torch.device | str
) -> HostInputs:
    def s(v, dtype):
        return torch.tensor(v, dtype=dtype, device=device)

    nan = float("nan")
    return HostInputs(
        tracked=torch.zeros((num_symbols,), dtype=torch.bool, device=device),
        btc_row=s(-1, I32),
        timestamp_s=s(0, I32),
        timestamp5_s=s(0, I32),
        oi_growth=torch.full((num_symbols,), nan, dtype=F32, device=device),
        adp_latest=s(nan, F32),
        adp_prev=s(nan, F32),
        adp_diff=s(nan, F32),
        adp_diff_prev=s(nan, F32),
        breadth_momentum_points=s(nan, F32),
        quiet_hours=s(False, torch.bool),
        grid_policy_allows=s(False, torch.bool),
        is_futures=s(True, torch.bool),
        dominance_is_losers=s(False, torch.bool),
        market_domination_reversal=s(False, torch.bool),
    )


def empty_indicator_carry(
    num_symbols: int, *, device: torch.device | str
) -> IndicatorCarry:
    return IndicatorCarry(
        pack5=empty_feature_carry(num_symbols, device=device),
        pack15=empty_feature_carry(num_symbols, device=device),
        abp5=empty_abp_carry(num_symbols, device=device),
        lsp15=empty_lsp_carry(num_symbols, device=device),
        st5=empty_supertrend_carry(num_symbols, device=device),
        bc15=empty_beta_corr_carry(num_symbols, device=device),
        bc_dirty=torch.zeros((num_symbols,), dtype=torch.bool, device=device),
    )


def initial_engine_state(
    num_symbols: int, window: int = 400, *, device: torch.device | str
) -> EngineState:
    return EngineState(
        buf5=empty_buffer(num_symbols, window, device=device),
        buf15=empty_buffer(num_symbols, window, device=device),
        regime_carry=initial_regime_carry(num_symbols, device=device),
        mrf_last_emitted=torch.full((num_symbols,), -1, dtype=I32, device=device),
        pt_last_signal_close=torch.full((num_symbols,), -1, dtype=I32, device=device),
        indicator_carry=empty_indicator_carry(num_symbols, device=device),
    )


def _btc_row_mask(btc_row: torch.Tensor, num_symbols: int):
    """(onehot (S,), ok scalar) for the masked-reduction BTC row extract."""
    safe = torch.clamp(btc_row, 0, num_symbols - 1)
    ok = (btc_row >= 0) & (btc_row < num_symbols)
    return torch.arange(num_symbols, device=btc_row.device) == safe, ok


def _ret_at(buf: MarketBuffer, pos: int) -> torch.Tensor:
    """Log return of the bar at ``pos`` from two close columns — the
    column-read twin of :func:`ops.indicators.log_returns`."""
    c = buf.values[:, pos, Field.CLOSE]
    prev = buf.values[:, pos - 1, Field.CLOSE]
    ok = (c > 0) & (prev > 0)
    ratio = torch.where(ok, c / torch.where(prev > 0, prev, 1.0), 1.0)
    return torch.where(ok, torch.log(ratio), float("nan"))


def init_indicator_carry(
    buf5: MarketBuffer,
    buf15: MarketBuffer,
    btc_row: torch.Tensor,
    params=None,
) -> IndicatorCarry:
    """The carry rebuilt from both windows (what every full tick emits).
    A ``btc_row`` of -1 leaves the beta/corr pair sums empty (readouts 0,
    the full kernel's no-BTC fill)."""
    sp = resolve_params(params)
    S = buf15.capacity
    dev = buf15.times.device
    rets = log_returns(buf15.values[:, :, Field.CLOSE])
    onehot, btc_ok = _btc_row_mask(torch.as_tensor(btc_row, dtype=I32, device=dev), S)
    btc_rets = torch.where(
        btc_ok, torch.where(onehot[:, None], rets, 0.0).sum(dim=0), float("nan")
    )
    W5 = buf5.times.shape[1]
    # the dormant strategy's dropna'd-frame seed: the series starts
    # MIN_BARS-1 rows past each row's first bar
    st_start = (W5 - buf5.filled + (MIN_BARS - 1)).to(I32)
    return IndicatorCarry(
        pack5=init_feature_carry(buf5),
        pack15=init_feature_carry(buf15),
        abp5=abp_init_from_window(buf5, sp.abp),
        lsp15=lsp_init_from_window(buf15, sp.lsp),
        st5=supertrend_init(
            buf5.values[:, :, Field.HIGH],
            buf5.values[:, :, Field.LOW],
            buf5.values[:, :, Field.CLOSE],
            window=ST_WINDOW,
            multiplier=ST_MULT,
            start=st_start,
        ),
        bc15=beta_corr_init(rets, btc_rets[None, :], window=BC_WINDOW),
        bc_dirty=torch.zeros((S,), dtype=torch.bool, device=dev),
    )


# The smallest ring the incremental engine takes: the largest need of any
# carried family's init or advance (the ABP init's score ring binds).
MIN_INCR_ENGINE_WINDOW = max(
    BC_WINDOW + 2,
    ABP_MIN_WINDOW,
    ABP_INIT_MIN_WINDOW,
    LSP_MIN_WINDOW,
    LSP_INIT_MIN_WINDOW,
)

# The incremental tick gathers only a shallow tail of each ring: its
# deepest reads are ABP's has_qav scan over its 128-bar TAIL, the BTC
# 24h-change column at -97, the beta/corr leaver at -(BC_WINDOW+2) and the
# feature-carry leavers near -22.
INCR_TAIL_WINDOW = max(_ABP_TAIL, 98, BC_WINDOW + 2, MIN_INCR_ENGINE_WINDOW)

# Wire-enabled strategies that read deeper windows than that tail (dormant
# kernels over the whole ring); enabling any of them gathers the full
# window on the incremental tick instead. Negative slices CLAMP, so a deep
# read against a too-narrow tail would be silently wrong: a new
# buffer-reading strategy stays within INCR_TAIL_WINDOW or joins this set.
DEEP_WINDOW_STRATEGIES: frozenset[str] = frozenset(
    {
        "coinrule_twap_momentum_sniper",
        "coinrule_buy_low_sell_high",
        "coinrule_buy_the_dip",
        "bb_extreme_reversion",
        "range_bb_rsi_mean_reversion",
        "range_failed_breakout_fade",
        "relative_strength_reversal_range",
    }
)


def _advance_tail_floor(params=None) -> int:
    """The deepest ring column the carry advance and readout need at the
    resolved params (an override can deepen the ABP/LSP windows)."""
    sp = resolve_params(params)
    return max(
        INCR_TAIL_WINDOW,
        _baseline_window(sp.abp) + 3,  # ABP advance's deepest column
        3 * sp.lsp.window_hours + 1,  # LSP advance's deepest column
    )


def _incr_tail_width(window: int, wire_enabled: tuple[str, ...], params=None) -> int:
    """Width of the incremental tick's materialized tail: the whole window
    when a deep-window strategy is on the wire, else the advance's floor.
    Values read through either width are identical."""
    if any(s in DEEP_WINDOW_STRATEGIES for s in wire_enabled):
        return window
    return min(window, _advance_tail_floor(params))


def advance_indicator_carry(
    buf5: MarketBuffer,
    buf15: MarketBuffer,
    carry: IndicatorCarry,
    btc_row: torch.Tensor,
    params=None,
) -> tuple[IndicatorCarry, torch.Tensor, torch.Tensor]:
    """One-bar advance of EVERY carried family under the shared clean-append
    masks. Returns ``(carry', stale5, stale15)``: stale rows kept their
    state and are masked by readers until the host's full recompute."""
    sp = resolve_params(params)
    assert buf15.times.shape[1] >= MIN_INCR_ENGINE_WINDOW, (
        f"window {buf15.times.shape[1]} too short for the engine-level "
        f"incremental advance (need >= {MIN_INCR_ENGINE_WINDOW})"
    )
    S = buf15.capacity
    adv5, stale5 = carry_advance_masks(buf5, carry.pack5.last_ts)
    adv15, stale15 = carry_advance_masks(buf15, carry.pack15.last_ts)
    pack5, _ = advance_feature_carry(buf5, carry.pack5, masks=(adv5, stale5))
    pack15, _ = advance_feature_carry(buf15, carry.pack15, masks=(adv15, stale15))
    abp5 = abp_advance_one_bar(buf5, carry.abp5, adv5, sp.abp)
    lsp15 = lsp_advance_one_bar(buf15, carry.lsp15, adv15, sp.lsp)

    # a row's supertrend series starts once MIN_BARS of history exist —
    # when the dropna'd-frame seed reaches the newest bar
    st5, _, _ = supertrend_advance(
        carry.st5,
        buf5.values[:, -1, Field.HIGH],
        buf5.values[:, -1, Field.LOW],
        buf5.values[:, -1, Field.CLOSE],
        window=ST_WINDOW,
        multiplier=ST_MULT,
        active=adv5 & (buf5.filled >= MIN_BARS),
    )

    # beta/corr pairs positionally: only rows advancing in step with the
    # BTC row slide their window; the others go dirty
    onehot, btc_ok = _btc_row_mask(btc_row, S)
    btc_adv = (onehot & adv15).any() & btc_ok
    ret_new = _ret_at(buf15, -1)
    ret_old = _ret_at(buf15, -(BC_WINDOW + 1))
    nan = float("nan")
    y_new = torch.where(btc_ok, torch.where(onehot, ret_new, 0.0).sum(), nan)
    y_old = torch.where(btc_ok, torch.where(onehot, ret_old, 0.0).sum(), nan)
    bc_new = beta_corr_advance(carry.bc15, ret_new, y_new, ret_old, y_old)
    bc15 = tree_where(adv15 & btc_adv, bc_new, carry.bc15)
    bc_dirty = carry.bc_dirty | ((adv15 != btc_adv) & (buf15.filled > 0))
    return (
        IndicatorCarry(
            pack5=pack5, pack15=pack15, abp5=abp5, lsp15=lsp15, st5=st5,
            bc15=bc15, bc_dirty=bc_dirty,
        ),
        stale5,
        stale15,
    )


def _btc_momentum_pair(last: torch.Tensor, prev: torch.Tensor) -> torch.Tensor:
    """BTC close pct_change at the last bar."""
    ok = torch.isfinite(prev) & (prev != 0) & torch.isfinite(last)
    return torch.where(ok, last / torch.where(ok, prev, 1.0) - 1.0, 0.0)


def _btc_change_96(last, base, btc_ok) -> torch.Tensor:
    """BTC 24h %-change (96 15m bars back)."""
    ok = btc_ok & torch.isfinite(base) & (base != 0) & torch.isfinite(last)
    return torch.where(ok, (last / torch.where(ok, base, 1.0) - 1.0) * 100.0, 0.0)


def _mask_outputs(out: StrategyOutputs, ok: torch.Tensor) -> StrategyOutputs:
    return out._replace(trigger=out.trigger & ok, autotrade=out.autotrade & ok)


def quiet_suppression(context: MarketContext, quiet_hours) -> torch.Tensor:
    """Quiet-hours suppression with the strong-stable-trend override judged
    against the context computed THIS tick."""
    strong_trend = torch.zeros((), dtype=torch.bool, device=context.market_regime.device)
    for code in sorted(OVERRIDE_REGIMES):
        strong_trend = strong_trend | (context.market_regime == code)
    trend_override = (
        context.valid
        & strong_trend
        & (context.market_regime_transition_strength >= MIN_TRANSITION_STRENGTH)
    )
    return quiet_hours & ~trend_override


def build_summary(strategies: dict[str, StrategyOutputs]) -> TriggerSummary:
    ordered = [strategies[name] for name in STRATEGY_ORDER]
    return TriggerSummary(
        trigger=torch.stack([so.trigger for so in ordered]),
        autotrade=torch.stack([so.autotrade for so in ordered]),
        direction=torch.stack([so.direction for so in ordered]),
        score=torch.stack([so.score for so in ordered]),
        stop_loss_pct=torch.stack([so.stop_loss_pct for so in ordered]),
    )


def _diag_kind(arr: torch.Tensor) -> str:
    if arr.dtype == torch.bool:
        return "b"
    if not arr.dtype.is_floating_point:
        return "i"
    return "f"


def _compact_fired(flat_trig: torch.Tensor, K: int) -> torch.Tensor:
    """(K,) int64 flat indices of the first K True entries, ascending, -1
    padded — ``jnp.nonzero(size=K, fill_value=-1)`` without a data-dependent
    shape: a cumsum gives each True entry its slot, entries past slot K
    scatter into a spare slot that is cut off."""
    n = flat_trig.shape[0]
    pos = torch.cumsum(flat_trig.to(torch.int64), dim=0) - 1
    target = torch.where(flat_trig & (pos < K), pos, K)
    idx = torch.full((K + 1,), -1, dtype=torch.int64, device=flat_trig.device)
    idx.scatter_(0, target, torch.arange(n, dtype=torch.int64, device=flat_trig.device))
    return idx[:K]


def pack_wire(
    context: MarketContext,
    strategies: dict[str, StrategyOutputs],
    summary: TriggerSummary,
    pack5: FeaturePack,
    pack15: FeaturePack,
    btc_beta: torch.Tensor,
    btc_corr: torch.Tensor,
    btc_change_96: torch.Tensor,
    bc_dirty_rows: torch.Tensor,
    wire_enabled: tuple[str, ...],
) -> torch.Tensor:
    """Pack one tick's evaluation into the single float32 wire: context
    scalars + fired compaction + per-slot emission payload + the (3, S)
    calibration block. Records the emission layout for ``wire_enabled``."""
    S = summary.trigger.shape[1]
    dev = summary.trigger.device
    scalar_values = {
        "valid": context.valid,
        "market_regime": context.market_regime,
        "previous_market_regime": context.previous_market_regime,
        "market_regime_transition": context.market_regime_transition,
        "market_regime_transition_strength": context.market_regime_transition_strength,
        "regime_is_transitioning": context.regime_is_transitioning,
        "market_stress_score": context.market_stress_score,
        "advancers_ratio": context.advancers_ratio,
        "long_tailwind": context.long_tailwind,
        "short_tailwind": context.short_tailwind,
        "fresh_count": context.fresh_count,
        "average_return": context.average_return,
        "long_regime_score": context.long_regime_score,
        "short_regime_score": context.short_regime_score,
        "range_regime_score": context.range_regime_score,
        "stress_regime_score": context.stress_regime_score,
        "btc_regime_score": context.btc_regime_score,
        "btc_price_change_96": btc_change_96,
        "bc_dirty_rows": bc_dirty_rows,
    }
    # int32 arithmetic before the cast: ~1.7e9 s exceeds float32's exact
    # integer range, the base-65536 parts do not
    ts32 = context.timestamp.to(I32)
    ss32 = context.regime_stable_since.to(I32)
    scalars = torch.stack(
        [scalar_values[k].to(F32) for k in WIRE_SCALARS_A]
        + [scalar_values[k].to(F32) for k in WIRE_SCALARS_B]
        + [
            torch.div(ts32, _WIRE_TS_BASE, rounding_mode="floor").to(F32),
            torch.remainder(ts32, _WIRE_TS_BASE).to(F32),
            torch.div(ss32, _WIRE_TS_BASE, rounding_mode="floor").to(F32),
            torch.remainder(ss32, _WIRE_TS_BASE).to(F32),
        ]
    )

    # fired (strategy, row) compaction, strategy-major, enabled set only
    K = WIRE_MAX_FIRED
    enabled_mask = torch.tensor(
        [s in wire_enabled for s in STRATEGY_ORDER], dtype=torch.bool, device=dev
    )
    flat_trig = (summary.trigger & enabled_mask[:, None]).reshape(-1)
    n_fired = flat_trig.sum().to(F32)
    idx = _compact_fired(flat_trig, K)
    valid_idx = idx >= 0
    safe = torch.clamp(idx, min=0)
    si = torch.div(safe, S, rounding_mode="floor")
    row = torch.remainder(safe, S)

    def gather(arr):
        return arr.reshape(-1)[safe].to(F32)

    zero = torch.zeros((), dtype=F32, device=dev)
    fired_block = torch.stack(
        [
            torch.where(valid_idx, si.to(F32), -1.0),
            torch.where(valid_idx, row.to(F32), -1.0),
            torch.where(valid_idx, gather(summary.autotrade), zero),
            torch.where(valid_idx, gather(summary.direction), zero),
            torch.where(valid_idx, gather(summary.score), zero),
            torch.where(valid_idx, gather(summary.stop_loss_pct), zero),
        ]
    )  # (6, K)

    # per-slot emission payload: features + the firing strategy's diagnostics
    layout: dict[str, list[tuple[str, str]]] = {}
    diag_mats = []
    for name in STRATEGY_ORDER:
        entries: list[tuple[str, str]] = []
        rows = []
        for key, arr in strategies[name].diagnostics.items():
            if arr.dim() == 0:
                arr = torch.broadcast_to(arr, (S,))
            entries.append((key, _diag_kind(arr)))
            rows.append(arr.to(F32))
        if len(entries) > EMISSION_DIAG_WIDTH:
            raise ValueError(f"{name}: {len(entries)} diagnostics > {EMISSION_DIAG_WIDTH}")
        rows += [torch.zeros((S,), dtype=F32, device=dev)] * (
            EMISSION_DIAG_WIDTH - len(rows)
        )
        layout[name] = entries
        diag_mats.append(torch.stack(rows))
    EMISSION_LAYOUTS[tuple(wire_enabled)] = layout
    diag_all = torch.stack(diag_mats)  # (N, D, S)
    base_feats = torch.stack(
        [
            pack5.close, pack5.volume, pack5.bb_upper, pack5.bb_mid, pack5.bb_lower,
            pack15.close, pack15.volume, pack15.bb_upper, pack15.bb_mid,
            pack15.bb_lower,
            context.features.micro_regime.to(F32),
            context.features.micro_transition.to(F32),
            btc_beta.to(F32),
            btc_corr.to(F32),
        ]
    )  # (len(EMISSION_BASE_FIELDS), S)
    slot_base = base_feats[:, row].T  # (K, B)
    slot_diag = diag_all[si, :, row]  # (K, D)
    slot_payload = torch.where(
        valid_idx[:, None], torch.cat([slot_base, slot_diag], dim=1), zero
    )

    calib_block = torch.stack(
        [
            context.features.valid.to(F32),
            context.features.close.to(F32),
            context.features.atr_pct.to(F32),
        ]
    )  # (3, S)
    return torch.cat(
        [
            scalars,
            n_fired[None],
            fired_block.reshape(-1),
            slot_payload.reshape(-1),
            calib_block.reshape(-1),
        ]
    )


def _tick_step_impl(
    state: EngineState,
    upd5: tuple[torch.Tensor, torch.Tensor, torch.Tensor],
    upd15: tuple[torch.Tensor, torch.Tensor, torch.Tensor],
    inputs: HostInputs,
    cfg: ContextConfig = ContextConfig(),
    wire_enabled: tuple[str, ...] = tuple(sorted(LIVE_STRATEGIES)),
    incremental: bool = False,
    maintain_carry: bool = True,
    params=None,
) -> tuple[EngineState, TickOutputs]:
    """One tick: apply the (row_idx, ts_s, vals) update batches, evaluate,
    pack the wire.

    ``incremental=False`` is the full tick: both rings are materialized
    canonically and every indicator is recomputed from the windows; with
    ``maintain_carry`` the indicator carry is rebuilt from the same windows
    (a classic deployment passes False and the carry rides through
    untouched). ``incremental=True`` reads the packs, the symbol features,
    ABP, LSP and the beta/corr block from the carry advanced by the newest
    bar; valid only when every update since the last full tick was a clean
    single-bar append — the host decides (``io/pipeline.py``).

    Only the strategies in ``wire_enabled`` are evaluated, except the two
    carry-owning ones (PriceTracker, MeanReversionFade), which always run so
    their device dedupe state advances identically whatever is enabled."""
    sp = resolve_params(params)
    ring5 = apply_updates(state.buf5, *upd5)
    ring15 = apply_updates(state.buf15, *upd15)
    # the incremental tick gathers a shallow tail and keeps the rings
    # mid-phase; the full tick gathers whole windows and its returned
    # rings are canonical (cursor 0)
    if incremental:
        buf5 = materialize_tail(ring5, _incr_tail_width(ring5.window, wire_enabled, params))
        buf15 = materialize_tail(
            ring15, _incr_tail_width(ring15.window, wire_enabled, params)
        )
    else:
        ring5 = materialize(ring5)
        ring15 = materialize(ring15)
        buf5, buf15 = ring5, ring15

    fresh5 = fresh_mask(buf5, inputs.timestamp5_s)
    fresh15 = fresh_mask(buf15, inputs.timestamp_s)
    if incremental:
        indicator_carry, stale5, stale15 = advance_indicator_carry(
            buf5, buf15, state.indicator_carry, inputs.btc_row, params
        )
        pack5 = feature_pack_from_carry(buf5, indicator_carry.pack5, stale5)
        pack15 = feature_pack_from_carry(buf15, indicator_carry.pack15, stale15)
        feats15 = symbol_features_from_carry(
            buf15, indicator_carry.pack15, fresh15 & inputs.tracked, stale15
        )
    else:
        pack5 = compute_feature_pack(buf5)
        pack15 = compute_feature_pack(buf15)
        feats15 = None
        stale5 = stale15 = None
        indicator_carry = (
            init_indicator_carry(buf5, buf15, inputs.btc_row, params)
            if maintain_carry
            else state.indicator_carry
        )

    context, regime_carry = compute_market_context(
        buf15, fresh15, inputs.tracked, inputs.btc_row, inputs.timestamp_s,
        state.regime_carry, cfg, feats=feats15,
    )
    long_gate = allows_long_autotrade_mask(context)

    # BTC-relative block: the BTC row is extracted as a masked reduction
    S = buf15.capacity
    W = buf15.window
    dev = buf15.times.device
    nan = float("nan")
    onehot_rows, btc_ok = _btc_row_mask(inputs.btc_row, S)
    if incremental:
        # carried beta/corr; the BTC closes come from single columns
        beta, corr = beta_corr_value(indicator_carry.bc15, BC_WINDOW)
        bc_ok = ~indicator_carry.bc_dirty & ~stale15
        # a DIRTY row's posture is unknown, not zero: it decodes NaN, kept
        # apart from the full kernel's measured 0.0 fill
        dirty = indicator_carry.bc_dirty
        btc_beta = torch.where(
            dirty, nan, torch.where(torch.isfinite(beta) & bc_ok, beta, 0.0)
        )
        btc_corr = torch.where(
            dirty, nan, torch.where(torch.isfinite(corr) & bc_ok, corr, 0.0)
        )
        bc_dirty_rows = dirty.sum().to(F32)

        def pick(pos):
            col = buf15.values[:, pos, Field.CLOSE]
            return torch.where(btc_ok, torch.where(onehot_rows, col, 0.0).sum(), nan)

        btc_last, btc_prev = pick(-1), pick(-2)
        if W > 96:
            btc_change_96 = _btc_change_96(btc_last, pick(-97), btc_ok)
        else:
            btc_change_96 = torch.zeros((), dtype=F32, device=dev)
        btc_mom = _btc_momentum_pair(btc_last, btc_prev)
    else:
        close15 = buf15.values[:, :, Field.CLOSE]
        rets = log_returns(close15)
        btc_onehot = onehot_rows[:, None]
        btc_rets_row = torch.where(btc_onehot, rets, 0.0).sum(dim=0)
        btc_close_row = torch.where(btc_onehot, close15, 0.0).sum(dim=0)
        btc_rets = torch.where(btc_ok, btc_rets_row, nan)
        bc = rolling_beta_corr(rets, btc_rets[None, :], window=BC_WINDOW)
        btc_beta = torch.where(torch.isfinite(bc.beta[:, -1]), bc.beta[:, -1], 0.0)
        btc_corr = torch.where(torch.isfinite(bc.corr[:, -1]), bc.corr[:, -1], 0.0)
        bc_dirty_rows = torch.zeros((), dtype=F32, device=dev)
        btc_close = torch.where(btc_ok, btc_close_row, nan)
        if W > 96:
            btc_change_96 = _btc_change_96(btc_close[-1], btc_close[-97], btc_ok)
        else:
            btc_change_96 = torch.zeros((), dtype=F32, device=dev)
        btc_mom = _btc_momentum_pair(btc_close[-1], btc_close[-2])

    ok5 = pack5.filled >= MIN_BARS
    ok15 = pack15.filled >= MIN_BARS
    quiet_suppressed = quiet_suppression(context, inputs.quiet_hours)
    skipped = no_signal(S, device=dev)

    def want(name: str) -> bool:
        return name in wire_enabled

    if not want("activity_burst_pump"):
        abp = skipped
    elif incremental:
        abp = activity_burst_pump_from_carry(
            buf5, indicator_carry.abp5, context, stale5, sp.abp
        )
    else:
        abp = activity_burst_pump(buf5, context, sp.abp)
    abp = _mask_outputs(abp, ok5 & fresh5)
    pt, pt_carry = price_tracker(
        pack5, context, quiet_suppressed, state.pt_last_signal_close, params=sp.pt
    )
    pt = _mask_outputs(pt, ok5 & fresh5)
    pt_carry = torch.where(ok5 & fresh5, pt_carry, state.pt_last_signal_close)

    lsp_args = (context, inputs.oi_growth, inputs.adp_latest, inputs.adp_prev, btc_mom)
    if not want("liquidation_sweep_pump"):
        lsp = skipped
    elif incremental:
        lsp = liquidation_sweep_pump_from_carry(
            buf15, indicator_carry.lsp15, *lsp_args, stale15, sp.lsp
        )
    else:
        lsp = liquidation_sweep_pump(buf15, *lsp_args, sp.lsp)
    lsp = _mask_outputs(lsp, ok15 & fresh15)
    mrf, mrf_carry = mean_reversion_fade(
        pack15, inputs.is_futures, state.mrf_last_emitted, sp.mrf
    )
    mrf = _mask_outputs(mrf, ok15 & fresh15)
    mrf_carry = torch.where(ok15 & fresh15, mrf_carry, state.mrf_last_emitted)
    ladder = (
        _mask_outputs(
            ladder_deployer(
                pack15, context, inputs.grid_policy_allows, inputs.is_futures,
                sp.ladder,
            ),
            ok15 & fresh15,
        )
        if want("grid_ladder")
        else skipped
    )

    strategies = {name: skipped for name in STRATEGY_ORDER}
    strategies.update(
        {
            "activity_burst_pump": abp,
            "coinrule_price_tracker": pt,
            "liquidation_sweep_pump": lsp,
            "mean_reversion_fade": mrf,
            "grid_ladder": ladder,
        }
    )
    summary = build_summary(strategies)
    wire = pack_wire(
        context, strategies, summary, pack5, pack15,
        btc_beta, btc_corr, btc_change_96, bc_dirty_rows, tuple(wire_enabled),
    )
    new_state = EngineState(
        buf5=ring5,
        buf15=ring15,
        regime_carry=regime_carry,
        mrf_last_emitted=mrf_carry,
        pt_last_signal_close=pt_carry,
        indicator_carry=indicator_carry,
    )
    outputs = TickOutputs(
        context=context,
        fresh5=fresh5,
        fresh15=fresh15,
        long_gate=long_gate,
        pack5=pack5,
        pack15=pack15,
        btc_beta=btc_beta,
        btc_corr=btc_corr,
        btc_price_change_96=btc_change_96,
        strategies=strategies,
        summary=summary,
        wire=wire,
    )
    return new_state, outputs


def tick_step(
    state: EngineState,
    upd5,
    upd15,
    inputs: HostInputs,
    cfg: ContextConfig = ContextConfig(),
    wire_enabled: tuple[str, ...] = tuple(sorted(LIVE_STRATEGIES)),
    incremental: bool = False,
    maintain_carry: bool = True,
    params=None,
) -> tuple[EngineState, TickOutputs]:
    """The step with every output (tests, overflow fallback)."""
    return _tick_step_impl(
        state, upd5, upd15, inputs, cfg, wire_enabled, incremental,
        maintain_carry, params,
    )


def tick_step_wire(
    state: EngineState,
    upd5,
    upd15,
    inputs: HostInputs,
    cfg: ContextConfig = ContextConfig(),
    wire_enabled: tuple[str, ...] = tuple(sorted(LIVE_STRATEGIES)),
    incremental: bool = False,
    maintain_carry: bool = True,
    params=None,
) -> tuple[EngineState, torch.Tensor]:
    """The live engine's step: the same evaluation, only the wire returned."""
    new_state, outputs = _tick_step_impl(
        state, upd5, upd15, inputs, cfg, wire_enabled, incremental,
        maintain_carry, params,
    )
    return new_state, outputs.wire


def apply_updates_step(state: EngineState, upd5, upd15) -> EngineState:
    """Update-only fold of one sub-batch pair (no evaluation). Leaves the
    indicator carry untouched: an incremental engine folds with
    :func:`apply_updates_carry_step` or marks the carry desynced."""
    return state._replace(
        buf5=apply_updates(state.buf5, *upd5),
        buf15=apply_updates(state.buf15, *upd15),
    )


def apply_updates_carry_step(
    state: EngineState, upd5, upd15, btc_row: torch.Tensor | int | None = None
) -> EngineState:
    """Sub-batch fold that ALSO advances every carried family, so a
    multi-bar drain of clean appends (three 5m bars in one 15m tick) stays
    on the incremental path. ``btc_row`` keeps the beta/corr pairing
    advancing through the folds; None marks those rows dirty instead."""
    buf5 = apply_updates(state.buf5, *upd5)
    buf15 = apply_updates(state.buf15, *upd15)
    row = torch.as_tensor(
        -1 if btc_row is None else btc_row, dtype=I32, device=buf15.times.device
    )
    carry, _, _ = advance_indicator_carry(
        materialize_tail(buf5, min(buf5.window, INCR_TAIL_WINDOW)),
        materialize_tail(buf15, min(buf15.window, INCR_TAIL_WINDOW)),
        state.indicator_carry,
        row,
    )
    return state._replace(buf5=buf5, buf15=buf15, indicator_carry=carry)


class WireFired(NamedTuple):
    """Host-side (numpy) compacted fired entries; first ``n`` rows valid."""

    n: int
    overflow: bool
    strategy_idx: object
    row: object
    autotrade: object
    direction: object
    score: object
    stop_loss_pct: object
    payload: object = None


def unpack_wire(wire) -> tuple[WireFired, dict]:
    """Split one fetched wire into fired entries + context scalars."""
    w = np.asarray(wire)
    na, nb = len(WIRE_SCALARS_A), len(WIRE_SCALARS_B)
    a = w[:na]
    b = w[na : na + nb + 4]
    ctx = {k: float(a[i]) for i, k in enumerate(WIRE_SCALARS_A)}
    ctx.update({k: float(b[i]) for i, k in enumerate(WIRE_SCALARS_B)})
    ctx["timestamp"] = int(b[nb]) * _WIRE_TS_BASE + int(b[nb + 1])
    ctx["regime_stable_since"] = int(b[nb + 2]) * _WIRE_TS_BASE + int(b[nb + 3])
    for k in ("market_regime", "previous_market_regime", "market_regime_transition",
              "fresh_count"):
        ctx[k] = int(ctx[k])
    ctx["valid"] = ctx["valid"] > 0.5
    ctx["regime_is_transitioning"] = ctx["regime_is_transitioning"] > 0.5

    off = WIRE_FIRED_COUNT_OFF
    K = WIRE_MAX_FIRED
    n = int(w[off])
    blocks = w[off + 1 : off + 1 + 6 * K].reshape(6, K)
    kept = min(n, K)
    payload_off = off + 1 + 6 * K
    payload = None
    if len(w) >= payload_off + K * EMISSION_SLOT_WIDTH:
        payload = w[payload_off : payload_off + K * EMISSION_SLOT_WIDTH].reshape(
            K, EMISSION_SLOT_WIDTH
        )[:kept]
        calib_off = payload_off + K * EMISSION_SLOT_WIDTH
        rest = len(w) - calib_off
        if rest > 0 and rest % 3 == 0:
            calib = w[calib_off:].reshape(3, rest // 3)
            ctx["calib_valid"] = calib[0] > 0.5
            ctx["calib_close"] = calib[1]
            ctx["calib_atr_pct"] = calib[2]
    fired = WireFired(
        n=n,
        overflow=n > K,
        strategy_idx=blocks[0, :kept].astype(np.int32),
        row=blocks[1, :kept].astype(np.int32),
        autotrade=blocks[2, :kept] > 0.5,
        direction=blocks[3, :kept].astype(np.int32),
        score=blocks[4, :kept],
        stop_loss_pct=blocks[5, :kept],
        payload=payload,
    )
    return fired, ctx
