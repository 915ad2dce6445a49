"""The per-tick step: the live wire path on the card.

Port of ``binquant_tpu/engine/step.py``: apply the candle updates to the
two rings, compute the feature packs, the market context, the BTC-relative
block, the spike detector and every strategy the tick evaluates for ALL
symbols at once, and pack everything the host needs into ONE float32 wire —
context scalars, a fixed-size compaction of the fired (strategy, row)
pairs, a per-slot emission payload, the (3, S) calibration rows and,
behind their flags, the numeric-health digest and the ingest-health digest
(in that order, strictly after the calibration rows, so every earlier
offset is the same either way). The wire layout is the
reference's, so :func:`unpack_wire` decodes either package's wire.

The step has a copying form (the default: the rings are cloned before the
scatter, the input state is left untouched) and an in-place form
(``inplace=True``, :func:`tick_step_wire_inplace` and the folds' ``inplace``
argument): the scatter writes the input state's ring planes, as the
reference donates its state at ``pipeline_depth <= 1``. A caller of the
in-place form must not read the input state's rings as pre-tick data
afterwards. The double-buffered form (the reference's ``tick_step_wire_db``,
``pipeline_depth >= 2``) is the in-place form over a recycled
:class:`RingSlot`: :func:`into_ring_slot` copies the input state's rings
into the slot first, so the input state stays intact while the tick writes
the slot.

The multi-tick drives' device side: :func:`tick_step_scan` runs a chunk of
replayed ticks (each :func:`_fold_and_step_wire`: the folds, then the wire
step) as one device-side loop with the grid-only policy's feedback on the
card, and :func:`apply_updates_scan` (:func:`apply_updates_scan_counted`)
folds a deep update-only drain; :func:`unpack_wire_block` decodes a chunk's
stacked wires in one pass.

Off the step, :func:`measure_carry_drift` is the audit tick's carry-drift
meter: the carried indicator state advanced by the tick's updates against a
fresh init from the post-update windows, per family.

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

Which strategies a tick evaluates: the five live ones that
``wire_enabled`` names, the two carry-owning ones (PriceTracker,
MeanReversionFade) always, and each of the nine dormant strategies that
``wire_enabled`` names; under ``compute_all`` (the full-outputs
:func:`tick_step`, as in the reference) every one of them. A strategy not
evaluated rides the summary as a ``no_signal`` row; a name outside
:data:`STRATEGY_ORDER` is ignored. The spike detector
(:func:`~binquant_tpu_torch.strategies.spike_hunter.detect_spikes`, the
qtail kernel's ``detect_spikes`` call site) runs when
RangeFailedBreakoutFade is evaluated, and its verdict rides
``TickOutputs.spikes`` (None otherwise). On the incremental path
SupertrendSwingReversal reads the supertrend direction from the carry.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from binquant_tpu_torch.engine.buffer import (
    Field,
    MarketBuffer,
    UpdateRouting,
    _scatter_updates,
    apply_updates,
    apply_updates_routed,
    empty_buffer,
    fresh_mask,
    materialize,
    materialize_tail,
    ring_latest_times,
    route_updates,
)
from binquant_tpu_torch.enums import MarketRegimeCode
from binquant_tpu_torch.ops.incremental import (
    BetaCorrCarry,
    SupertrendCarry,
    beta_corr_advance,
    beta_corr_init,
    beta_corr_value,
    empty_beta_corr_carry,
    empty_supertrend_carry,
    moment_mean,
    moment_std,
    supertrend_advance,
    supertrend_init,
    tree_where,
)
from binquant_tpu_torch.ops.indicators import log_returns, rolling_beta_corr
from binquant_tpu_torch.parallel.mesh import ShardedState
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
from binquant_tpu_torch.strategies.dormant import (
    BBXParams,
    bb_extreme_reversion,
    buy_low_sell_high,
    buy_the_dip,
    inverse_price_tracker,
    range_bb_rsi_mean_reversion,
    range_failed_breakout_fade,
    relative_strength_reversal_range,
    supertrend_swing_reversal,
    twap_momentum_sniper,
)
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
from binquant_tpu_torch.strategies.spike_hunter import SpikeSignal, detect_spikes

I32 = torch.int32
F32 = torch.float32


def _sharded():
    """The sharded tick (``parallel/step.py``), which every public step
    function here hands a :class:`~binquant_tpu_torch.parallel.mesh.ShardedState`
    to: the same call on a placed state, as a jitted JAX function takes
    sharded arrays."""
    from binquant_tpu_torch.parallel import step

    return step

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


def wire_length(
    num_symbols: int, numeric_digest: bool = False, ingest_digest: bool = False
) -> int:
    """Length of one tick's wire for ``num_symbols`` rows: scalars, the
    fired compaction, the per-slot payload, the (3, S) calibration rows,
    and each digest block whose flag is on."""
    return (
        WIRE_FIRED_COUNT_OFF + 1 + 6 * WIRE_MAX_FIRED
        + WIRE_MAX_FIRED * EMISSION_SLOT_WIDTH + 3 * num_symbols
        + (NUMERIC_DIGEST_WIDTH if numeric_digest else 0)
        + (INGEST_DIGEST_WIDTH if ingest_digest else 0)
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
    spikes: SpikeSignal | None  # None when RangeFailedBreakoutFade was not evaluated
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


def _btc_row_mask(btc_row: torch.Tensor, num_symbols: int, comm=None):
    """(onehot over the ``num_symbols`` rows held here, ok scalar) for the
    masked-reduction BTC row extract. Under a sharded tick (``comm``) the
    rows are this shard's, ``[lo, hi)`` of the whole capacity."""
    S = num_symbols if comm is None else comm.capacity
    lo = 0 if comm is None else comm.lo
    safe = torch.clamp(btc_row, 0, S - 1)
    ok = (btc_row >= 0) & (btc_row < S)
    rows = torch.arange(lo, lo + num_symbols, device=btc_row.device)
    return rows == safe, ok


def _from_btc(comm, fn):
    """``fn()``, a masked reduction over the BTC row: computed here, or under
    a sharded tick by the shard that owns the row and handed to every shard
    (a ``(W,)`` row or a few scalars cross shards, never an ``(S, W)``
    field)."""
    return fn() if comm is None else comm.from_owner(fn)


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
    site: str = "abp_init_from_window",
    comm=None,
) -> IndicatorCarry:
    """The carry rebuilt from both windows (what every full tick emits).
    A ``btc_row`` of -1 leaves the beta/corr pair sums empty (readouts 0,
    the full kernel's no-BTC fill). ``site`` labels the ABP init's qtail
    launch (the drift meter's fresh init counts as ``carry_drift``)."""
    sp = resolve_params(params)
    S = buf15.capacity
    dev = buf15.times.device
    rets = log_returns(buf15.values[:, :, Field.CLOSE])
    onehot, btc_ok = _btc_row_mask(torch.as_tensor(btc_row, dtype=I32, device=dev), S, comm)
    btc_rets = torch.where(
        btc_ok,
        _from_btc(comm, lambda: torch.where(onehot[:, None], rets, 0.0).sum(dim=0)),
        float("nan"),
    )
    W5 = buf5.times.shape[1]
    # the dormant strategy's dropna'd-frame seed: the series starts
    # MIN_BARS-1 rows past each row's first bar
    st_start = (W5 - buf5.filled + (MIN_BARS - 1)).to(I32)
    return IndicatorCarry(
        pack5=init_feature_carry(buf5),
        pack15=init_feature_carry(buf15),
        abp5=abp_init_from_window(buf5, sp.abp, site=site),
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


def _incr_tail_width(
    window: int, wire_enabled: tuple[str, ...], compute_all: bool = False, params=None
) -> int:
    """Width of the incremental tick's materialized tail: the whole window
    under ``compute_all`` or when a deep-window strategy is on the wire,
    else the advance's floor. Values read through either width are
    identical, so the wire is the same either way."""
    if compute_all or any(s in DEEP_WINDOW_STRATEGIES for s in wire_enabled):
        return window
    return min(window, _advance_tail_floor(params))


def advance_indicator_carry(
    buf5: MarketBuffer,
    buf15: MarketBuffer,
    carry: IndicatorCarry,
    btc_row: torch.Tensor,
    params=None,
    comm=None,
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
    onehot, btc_ok = _btc_row_mask(btc_row, S, comm)
    ret_new = _ret_at(buf15, -1)
    ret_old = _ret_at(buf15, -(BC_WINDOW + 1))
    btc_adv_any, y_new_sum, y_old_sum = _from_btc(
        comm,
        lambda: (
            (onehot & adv15).any(),
            torch.where(onehot, ret_new, 0.0).sum(),
            torch.where(onehot, ret_old, 0.0).sum(),
        ),
    )
    btc_adv = btc_adv_any & btc_ok
    nan = float("nan")
    y_new = torch.where(btc_ok, y_new_sum, nan)
    y_old = torch.where(btc_ok, y_old_sum, nan)
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


_ENABLED_MASKS: dict[tuple, torch.Tensor] = {}


def enabled_strategy_mask(wire_enabled, device) -> torch.Tensor:
    """(N,) bool over ``STRATEGY_ORDER``: the strategies on the wire. Built
    once per (set, device) and kept there, so a tick makes no upload (a
    blocking copy would synchronize the host with the card)."""
    key = (tuple(wire_enabled), str(device))
    mask = _ENABLED_MASKS.get(key)
    if mask is None:
        mask = torch.tensor([s in wire_enabled for s in STRATEGY_ORDER]).to(device)
        _ENABLED_MASKS[key] = mask
    return mask


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


# --- numeric-health digest ---------------------------------------------------
# Per-stage NaN/Inf row counts among rows whose sufficiency gates promise
# finite values, per-strategy non-finite and fired counts, min/max/absmax of
# key series, and the gate-margin tail: one gate-margin distance per
# strategy plus the regime-score top1-top2 spread. Appended after the
# calibration rows when ``numeric_digest`` is on.
NUMERIC_STAGES: tuple[str, ...] = ("features5", "features15", "indicators")
NUMERIC_SERIES: tuple[str, ...] = ("close5", "close15", "volume5", "volume15", "score")
NUMERIC_DIGEST_WIDTH = (
    2 * len(NUMERIC_STAGES)
    + 2 * len(STRATEGY_ORDER)
    + 3 * len(NUMERIC_SERIES)
    + len(STRATEGY_ORDER)
    + 1
)


def numeric_digest_ops() -> tuple[str, ...]:
    """How a sharded tick combines its shards' numeric digest blocks,
    position by position (``parallel/collectives.py`` ``combine_blocks``):
    counts sum, series extremes and gate margins min/max, the regime-score
    spread (from the replicated context) is shard 0's. Every entry is an
    exact count or an extreme, so the combined block is the unsharded one."""
    ops = ["sum"] * (2 * len(NUMERIC_STAGES) + 2 * len(STRATEGY_ORDER))
    ops += ["min", "max", "max"] * len(NUMERIC_SERIES)
    ops += ["min"] * len(STRATEGY_ORDER)
    return (*ops, "first")


def numeric_digest_layout() -> list[str]:
    """Field names of the numeric digest block, in wire order."""
    names: list[str] = []
    for stage in NUMERIC_STAGES:
        names += [f"{stage}.nan_rows", f"{stage}.inf_rows"]
    names += [f"nonfinite.{s}" for s in STRATEGY_ORDER]
    names += [f"fired.{s}" for s in STRATEGY_ORDER]
    for series in NUMERIC_SERIES:
        names += [f"{series}.min", f"{series}.max", f"{series}.absmax"]
    names += [f"margin.{s}" for s in STRATEGY_ORDER]
    names += ["margin.market_regime"]
    return names


def _count(mask: torch.Tensor) -> torch.Tensor:
    """A bool count as a float32 scalar (exact below 2**24)."""
    return mask.sum().to(F32)


def _series_stats(x: torch.Tensor, mask: torch.Tensor) -> list[torch.Tensor]:
    """(min, max, absmax) over ``mask``-selected finite entries; NaN when
    nothing qualifies."""
    m = mask & torch.isfinite(x)
    any_m = m.any()
    nan = float("nan")
    return [
        torch.where(any_m, torch.where(m, x, float("inf")).min(), nan).to(F32),
        torch.where(any_m, torch.where(m, x, float("-inf")).max(), nan).to(F32),
        torch.where(any_m, torch.where(m, torch.abs(x), 0.0).max(), nan).to(F32),
    ]


def _margin_min(prox: torch.Tensor, eligible: torch.Tensor) -> torch.Tensor:
    m = eligible & torch.isfinite(prox)
    mn = torch.where(m, prox, float("inf")).min()
    return torch.where(m.any(), mn, float("nan")).to(F32)


def _numeric_digest_block(
    pack5: FeaturePack,
    pack15: FeaturePack,
    summary: TriggerSummary,
    btc_beta: torch.Tensor,
    btc_corr: torch.Tensor,
    tracked: torch.Tensor,
    ok5: torch.Tensor,
    ok15: torch.Tensor,
    fresh5: torch.Tensor,
    fresh15: torch.Tensor,
    beta_expected_nan: torch.Tensor,
    wire_fields_only: bool = False,
    sp=None,
    context: MarketContext | None = None,
) -> torch.Tensor:
    """The (NUMERIC_DIGEST_WIDTH,) float32 numeric-health block.

    NaN/Inf rows are counted only where tracked rows pass ``filled >=
    MIN_BARS`` (warm-up NaN is by design, a NaN past the gate is leakage);
    ``beta_expected_nan`` masks the incremental path's dirty/stale beta rows,
    which decode NaN on purpose. ``wire_fields_only`` (a classic deployment's
    ticks) scans only the pack fields the wire's payload carries; every
    other tick scans the twelve gated fields."""
    suff5 = tracked & ok5
    suff15 = tracked & ok15

    def stage_counts(fields, sufficient):
        nan_any = torch.zeros_like(sufficient)
        inf_any = torch.zeros_like(sufficient)
        for f in fields:
            nan_any = nan_any | torch.isnan(f)
            inf_any = inf_any | torch.isinf(f)
        return [_count(nan_any & sufficient), _count(inf_any & sufficient)]

    def pack_fields(pack):
        if wire_fields_only:
            return (pack.close, pack.volume, pack.bb_upper, pack.bb_mid, pack.bb_lower)
        # quote volume is left out: feeds legitimately omit it
        return (
            pack.close, pack.volume, pack.rsi, pack.mfi, pack.macd, pack.macd_signal,
            pack.bb_upper, pack.bb_mid, pack.bb_lower, pack.atr, pack.ema9, pack.ema21,
        )

    out: list[torch.Tensor] = []
    out += stage_counts(pack_fields(pack5), suff5)
    out += stage_counts(pack_fields(pack15), suff15)
    ind_mask = suff15 & ~beta_expected_nan
    out += [
        _count((torch.isnan(btc_beta) | torch.isnan(btc_corr)) & ind_mask),
        _count((torch.isinf(btc_beta) | torch.isinf(btc_corr)) & ind_mask),
    ]
    for k, name in enumerate(STRATEGY_ORDER):
        gate = suff5 & fresh5 if name in FIVE_MIN_STRATEGIES else suff15 & fresh15
        bad = ~torch.isfinite(summary.score[k]) | ~torch.isfinite(summary.stop_loss_pct[k])
        out.append(_count(bad & gate))
    for k in range(len(STRATEGY_ORDER)):
        out.append(_count(summary.trigger[k]))
    out += _series_stats(pack5.close, suff5)
    out += _series_stats(pack15.close, suff15)
    out += _series_stats(pack5.volume, suff5)
    out += _series_stats(pack15.volume, suff15)
    out += _series_stats(summary.score, torch.broadcast_to(tracked, summary.score.shape))

    # gate-margin tail: per strategy, the least distance between a gated
    # indicator and its threshold over eligible rows (NaN when none is)
    spv = resolve_params(sp)
    elig5 = suff5 & fresh5
    elig15 = suff15 & fresh15
    margins = {
        "coinrule_price_tracker": _margin_min(
            torch.minimum(
                torch.abs(pack5.rsi - spv.pt.rsi_oversold),
                torch.abs(pack5.mfi - spv.pt.mfi_oversold),
            ),
            elig5,
        ),
        "mean_reversion_fade": _margin_min(
            torch.minimum(
                torch.abs(pack15.rsi_wilder - spv.mrf.rsi_long_max),
                torch.abs(pack15.rsi_wilder - spv.mrf.rsi_short_min),
            ),
            elig15,
        ),
        # inverse_price_tracker keeps the reference's baked constants
        "inverse_price_tracker": _margin_min(
            torch.minimum(torch.abs(pack5.rsi - 30.0), torch.abs(pack5.mfi - 20.0)),
            elig5,
        ),
    }
    nan32 = torch.full((), float("nan"), dtype=F32, device=tracked.device)
    for name in STRATEGY_ORDER:
        out.append(margins.get(name, nan32))
    if context is not None:
        scores = torch.stack(
            [
                context.long_regime_score, context.short_regime_score,
                context.range_regime_score, context.stress_regime_score,
            ]
        ).to(F32)
        top2 = torch.topk(scores, 2).values
        # the reference's top_k ranks NaN first, so any NaN score spreads
        # to NaN; held explicitly, whatever the device's topk does with NaN
        out.append(torch.where(torch.isnan(scores).any(), nan32, top2[0] - top2[1]))
    else:
        out.append(nan32)
    return torch.stack(out)


def decode_numeric_digest(block) -> dict:
    """Host-side decode of one tick's numeric digest block into a nested
    dict; non-finite series stats and margins decode to None."""
    vec = np.asarray(block, dtype=np.float64)
    if vec.shape != (NUMERIC_DIGEST_WIDTH,):
        raise ValueError(f"numeric digest block of shape {vec.shape}")
    i = 0
    nan_rows: dict[str, int] = {}
    inf_rows: dict[str, int] = {}
    for stage in NUMERIC_STAGES:
        nan_rows[stage] = int(vec[i])
        inf_rows[stage] = int(vec[i + 1])
        i += 2
    nonfinite = {}
    for name in STRATEGY_ORDER:
        nonfinite[name] = int(vec[i])
        i += 1
    fired = {}
    for name in STRATEGY_ORDER:
        fired[name] = int(vec[i])
        i += 1
    series = {}
    for name in NUMERIC_SERIES:
        mn, mx, am = vec[i], vec[i + 1], vec[i + 2]
        series[name] = {
            "min": None if mn != mn else float(mn),
            "max": None if mx != mx else float(mx),
            "absmax": None if am != am else float(am),
        }
        i += 3
    margin: dict[str, float | None] = {}
    for name in [*STRATEGY_ORDER, "market_regime"]:
        v = vec[i]
        margin[name] = None if v != v else float(v)
        i += 1
    return {
        "nan_rows": nan_rows,
        "inf_rows": inf_rows,
        "strategy_nonfinite": nonfinite,
        "fired": fired,
        "series": series,
        "margin": margin,
        "nan_total": sum(nan_rows.values()) + sum(nonfinite.values()),
        "inf_total": sum(inf_rows.values()),
    }


# --- ingest-health digest ----------------------------------------------------
# Per interval: staleness buckets (tracked rows whose newest bar is at least
# 1x/3x/10x the interval behind the evaluated bucket), the stalest row's age,
# the coverage funnel (covered, >= MIN_BARS, fresh), and the tick's
# append/rewrite/gap/drop routing counts summed over EVERY sub-batch the
# tick applied (the counted folds carry the fold slots' counts in). Appended
# after the numeric digest when ``ingest_digest`` is on. Every entry is an
# exact integer reduction cast to float32, so every backend gives the same
# bits.
FIVE_MIN_S = 300
FIFTEEN_MIN_S = 900
INGEST_INTERVALS: tuple[str, ...] = ("5m", "15m")
INGEST_STAT_FIELDS: tuple[str, ...] = (
    "stale_1x", "stale_3x", "stale_10x", "max_age_s", "covered", "min_bars", "fresh",
)
INGEST_COUNT_FIELDS: tuple[str, ...] = ("appends", "rewrites", "gap_appends", "dropped")
INGEST_DIGEST_WIDTH = 1 + len(INGEST_INTERVALS) * (
    len(INGEST_STAT_FIELDS) + len(INGEST_COUNT_FIELDS)
)


def ingest_digest_ops() -> tuple[str, ...]:
    """The ingest digest's combination across shards: every entry a count
    (summed) but ``max_age_s`` (the largest, NaN where no shard covers a
    row)."""
    per_interval = ["max" if f == "max_age_s" else "sum" for f in INGEST_STAT_FIELDS]
    per_interval += ["sum"] * len(INGEST_COUNT_FIELDS)
    return ("sum", *(per_interval * len(INGEST_INTERVALS)))


def ingest_digest_layout() -> list[str]:
    """Field names of the ingest digest block, in wire order."""
    names = ["tracked"]
    for interval in INGEST_INTERVALS:
        names += [f"{interval}.{f}" for f in INGEST_STAT_FIELDS]
        names += [f"{interval}.{f}" for f in INGEST_COUNT_FIELDS]
    return names


def _ingest_interval_stats(
    latest_ts: torch.Tensor,  # (S,) int32 newest bar open time, -1 empty
    filled: torch.Tensor,  # (S,) int32
    tracked: torch.Tensor,  # (S,) bool
    eval_ts: torch.Tensor,  # int32 scalar: the evaluated bucket's open time
    interval_s: int,
) -> list[torch.Tensor]:
    """The 7 per-interval staleness/coverage scalars of the POST-update
    ring. A row's age is ``eval_ts - latest_ts``: a fresh row has age 0, a
    row one bar behind exactly ``interval_s`` (neither is stale);
    ``max_age_s`` is NaN when no tracked row holds data."""
    covered = tracked & (filled > 0)
    age = torch.where(covered, eval_ts - latest_ts, 0).to(I32)
    max_age = torch.where(covered, age, 0).max().to(F32)
    min_bars = tracked & (filled >= MIN_BARS)
    fresh = min_bars & (latest_ts == eval_ts)
    return [
        _count(covered & (age > 1 * interval_s)),
        _count(covered & (age > 3 * interval_s)),
        _count(covered & (age > 10 * interval_s)),
        torch.where(covered.any(), max_age, float("nan")).to(F32),
        _count(covered),
        _count(min_bars),
        _count(fresh),
    ]


def _ingest_counts_from_routing(
    r: UpdateRouting,
    filled: torch.Tensor,  # (S,) int32 PRE-update fill counts
    interval_s: int,
) -> torch.Tensor:
    """(4,) float32 ``(appends, rewrites, gap_appends, dropped)`` of one
    routed batch. A gap append is a new bar more than one interval past the
    row's previous newest bar; a dropped update is a mid-history insert the
    apply discards."""
    dropped = r.has_update & ~r.is_append & ~r.is_rewrite
    gap = r.is_append & (filled > 0) & (r.upd_ts - r.last_ts > interval_s)
    return torch.stack([_count(r.is_append), _count(r.is_rewrite), _count(gap), _count(dropped)])


def _ingest_batch_counts(
    buf: MarketBuffer, row_idx: torch.Tensor, ts: torch.Tensor, interval_s: int
) -> torch.Tensor:
    """(4,) batch counts classified against the PRE-update ring through the
    same :func:`route_updates` the apply resolves — for callers that do not
    apply the batch; the step and the folds share one routing instead."""
    return _ingest_counts_from_routing(route_updates(buf, row_idx, ts), buf.filled, interval_s)


def _ingest_digest_block(
    tracked: torch.Tensor,
    stats5: list,
    stats15: list,
    counts5: torch.Tensor,
    counts15: torch.Tensor,
) -> torch.Tensor:
    """The (INGEST_DIGEST_WIDTH,) float32 block in layout order."""
    return torch.cat(
        [torch.stack([_count(tracked)] + stats5), counts5, torch.stack(stats15), counts15]
    )


def decode_ingest_digest(block) -> dict:
    """Host-side decode of one tick's ingest digest block; ``max_age_s``
    decodes NaN to None (no tracked row holds data)."""
    vec = np.asarray(block, dtype=np.float64)
    if vec.shape != (INGEST_DIGEST_WIDTH,):
        raise ValueError(f"ingest digest block of shape {vec.shape}")
    out: dict = {"tracked": int(vec[0])}
    i = 1
    for interval in INGEST_INTERVALS:
        sect: dict = {}
        for f in INGEST_STAT_FIELDS:
            v = vec[i]
            if f == "max_age_s":
                sect[f] = None if v != v else float(v)
            else:
                sect[f] = int(v)
            i += 1
        for f in INGEST_COUNT_FIELDS:
            sect[f] = int(vec[i])
            i += 1
        out[interval] = sect
    out["stale_total"] = out["5m"]["stale_1x"] + out["15m"]["stale_1x"]
    return out


def _ingest_pair_counts(state: EngineState, upd5, upd15) -> torch.Tensor:
    """(8,) float32: both intervals' batch counts, 5m first."""
    return torch.cat(
        [
            _ingest_batch_counts(state.buf5, upd5[0], upd5[1], FIVE_MIN_S),
            _ingest_batch_counts(state.buf15, upd15[0], upd15[1], FIFTEEN_MIN_S),
        ]
    )


def _counted_fold_bufs(state: EngineState, upd5, upd15, counts, inplace: bool = False):
    """One routing per ring feeds both the count reductions and the apply
    scatter. Returns ``(buf5, buf15, counts)`` with the (8,) accumulator
    advanced."""
    r5, uv5 = _scatter_updates(state.buf5, *upd5)
    r15, uv15 = _scatter_updates(state.buf15, *upd15)
    counts = counts + torch.cat(
        [
            _ingest_counts_from_routing(r5, state.buf5.filled, FIVE_MIN_S),
            _ingest_counts_from_routing(r15, state.buf15.filled, FIFTEEN_MIN_S),
        ]
    )
    buf5 = apply_updates_routed(state.buf5, r5, uv5, inplace)
    buf15 = apply_updates_routed(state.buf15, r15, uv15, inplace)
    return buf5, buf15, counts


def _slot_values(
    context: MarketContext,
    strategies: dict[str, StrategyOutputs],
    summary: TriggerSummary,
    pack5: FeaturePack,
    pack15: FeaturePack,
    btc_beta: torch.Tensor,
    btc_corr: torch.Tensor,
    wire_enabled: tuple[str, ...],
    si: torch.Tensor,
    row: torch.Tensor,
) -> torch.Tensor:
    """The ``(K, 4 + B + D)`` float32 values of K fired slots at strategy
    ``si`` and row ``row`` of the rows held here: autotrade, direction,
    score and stop loss, then the emission payload (the base features and
    the firing strategy's diagnostics). Records the emission layout for
    ``wire_enabled``."""
    S = summary.trigger.shape[1]
    dev = summary.trigger.device

    def gather(arr):
        return arr[si, row].to(F32)

    layout: dict[str, list[tuple[str, str]]] = {}
    diag_mats = []
    for name in STRATEGY_ORDER:
        entries: list[tuple[str, str]] = []
        rows = []
        for dkey, arr in strategies[name].diagnostics.items():
            if arr.dim() == 0:
                arr = torch.broadcast_to(arr, (S,))
            entries.append((dkey, _diag_kind(arr)))
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
    return torch.cat(
        [
            torch.stack(
                [
                    gather(summary.autotrade), gather(summary.direction),
                    gather(summary.score), gather(summary.stop_loss_pct),
                ],
                dim=1,
            ),
            base_feats[:, row].T,  # (K, B)
            diag_all[si, :, row],  # (K, D)
        ],
        dim=1,
    )


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
    digest: torch.Tensor | None = None,
    ingest: torch.Tensor | None = None,
    comm=None,
) -> torch.Tensor | None:
    """Pack one tick's evaluation into the single float32 wire: context
    scalars + fired compaction + per-slot emission payload + the (3, S)
    calibration block, then the numeric ``digest`` and the ``ingest``
    digest where given. Records the emission layout for ``wire_enabled``.

    Under a sharded tick (``comm``) every shard passes its own rows: the
    trigger bits and the calibration rows are gathered in global row order,
    shard 0 compacts the fired entries, each slot's values come from the
    shard owning its row, and shard 0 packs the wire, the unsharded layout
    bit for bit (every other shard returns None)."""
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

    # fired (strategy, row) compaction, strategy-major, enabled set only;
    # sharded, the trigger bits are gathered in row order and shard 0
    # compacts them, and every slot's values come from the shard that owns
    # its row
    K = WIRE_MAX_FIRED
    S_here = summary.trigger.shape[1]
    trig = summary.trigger & enabled_strategy_mask(wire_enabled, dev)[:, None]
    if comm is None:
        lo, S = 0, S_here
        n_fired = trig.sum()
        idx = _compact_fired(trig.reshape(-1), K)
    else:
        lo, S = comm.lo, comm.capacity
        full = comm.gather_rows(trig.T, kind="fired")  # (S, N) on shard 0
        n_fired = None if full is None else full.sum()
        idx = None if full is None else _compact_fired(full.T.reshape(-1), K)
        idx = comm.broadcast(idx, 0, kind="fired")
    valid_idx = idx >= 0
    safe = torch.clamp(idx, min=0)
    si = torch.div(safe, S, rounding_mode="floor")
    row = torch.remainder(safe, S)
    own = valid_idx & (row >= lo) & (row < lo + S_here)
    values = _slot_values(
        context, strategies, summary, pack5, pack15, btc_beta, btc_corr,
        tuple(wire_enabled), si, torch.clamp(row - lo, 0, S_here - 1),
    )
    feats = context.features
    calib = (feats.valid.to(F32), feats.close.to(F32), feats.atr_pct.to(F32))
    if comm is not None:
        values = comm.select_rows(values, own, kind="fired")
        calib = comm.gather_rows(calib, kind="calib")
        if values is None:
            return None
    zero = torch.zeros((), dtype=F32, device=dev)
    fired_block = torch.stack(
        [
            torch.where(valid_idx, si.to(F32), -1.0),
            torch.where(valid_idx, row.to(F32), -1.0),
            torch.where(valid_idx, values[:, 0], zero),
            torch.where(valid_idx, values[:, 1], zero),
            torch.where(valid_idx, values[:, 2], zero),
            torch.where(valid_idx, values[:, 3], zero),
        ]
    )  # (6, K)
    slot_payload = torch.where(valid_idx[:, None], values[:, 4:], zero)
    calib_block = torch.stack(calib)  # (3, S)
    parts = [
        scalars,
        n_fired.to(F32)[None],
        fired_block.reshape(-1),
        slot_payload.reshape(-1),
        calib_block.reshape(-1),
    ]
    if digest is not None:
        parts.append(digest.to(F32))
    if ingest is not None:
        parts.append(ingest.to(F32))
    return torch.cat(parts)


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
    numeric_digest: bool = False,
    ingest_digest: bool = False,
    ingest_fold_counts: torch.Tensor | None = None,
    inplace: bool = False,
    compute_all: bool = False,
    comm=None,
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
    their device dedupe state advances identically whatever is enabled;
    ``compute_all`` evaluates every strategy (the full-outputs variant).
    The wire's fired block and payload carry the ``wire_enabled`` set only.

    ``numeric_digest`` and ``ingest_digest`` append their blocks to the
    wire; both off, the wire is the pre-digest layout bit for bit.
    ``ingest_fold_counts`` ((8,) float32 or None) carries the counts of the
    fold sub-batches the caller applied before this batch, so the ingest
    digest covers the whole drain. ``inplace`` writes the input state's ring
    planes instead of cloning them (see the module docstring).

    ``comm`` runs the tick as one shard's program of a sharded tick
    (``parallel/step.py``): ``state``, the updates and ``inputs`` are this
    shard's rows, and every read across rows (the BTC row, the market
    context, the digests' counts, the wire) goes through the collectives.
    The returned wire is shard 0's (None on the other shards)."""
    sp = resolve_params(params)
    if ingest_digest:
        # one routing per ring feeds both the digest's counts and the apply
        r5, uv5 = _scatter_updates(state.buf5, *upd5)
        r15, uv15 = _scatter_updates(state.buf15, *upd15)
        icnt5 = _ingest_counts_from_routing(r5, state.buf5.filled, FIVE_MIN_S)
        icnt15 = _ingest_counts_from_routing(r15, state.buf15.filled, FIFTEEN_MIN_S)
        if ingest_fold_counts is not None:
            icnt5 = icnt5 + ingest_fold_counts[:4]
            icnt15 = icnt15 + ingest_fold_counts[4:]
        ring5 = apply_updates_routed(state.buf5, r5, uv5, inplace)
        ring15 = apply_updates_routed(state.buf15, r15, uv15, inplace)
    else:
        ring5 = apply_updates(state.buf5, *upd5, inplace=inplace)
        ring15 = apply_updates(state.buf15, *upd15, inplace=inplace)
    # the incremental tick gathers a shallow tail and keeps the rings
    # mid-phase; the full tick gathers whole windows and its returned
    # rings are canonical (cursor 0)
    if incremental:
        buf5 = materialize_tail(
            ring5, _incr_tail_width(ring5.window, wire_enabled, compute_all, params)
        )
        buf15 = materialize_tail(
            ring15, _incr_tail_width(ring15.window, wire_enabled, compute_all, params)
        )
    else:
        ring5 = materialize(ring5)
        ring15 = materialize(ring15)
        buf5, buf15 = ring5, ring15

    fresh5 = fresh_mask(buf5, inputs.timestamp5_s)
    fresh15 = fresh_mask(buf15, inputs.timestamp_s)
    if incremental:
        indicator_carry, stale5, stale15 = advance_indicator_carry(
            buf5, buf15, state.indicator_carry, inputs.btc_row, params, comm
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
            init_indicator_carry(buf5, buf15, inputs.btc_row, params, comm=comm)
            if maintain_carry
            else state.indicator_carry
        )

    context, regime_carry = compute_market_context(
        buf15, fresh15, inputs.tracked, inputs.btc_row, inputs.timestamp_s,
        state.regime_carry, cfg, feats=feats15, comm=comm,
    )
    long_gate = allows_long_autotrade_mask(context)

    # BTC-relative block: the BTC row is extracted as a masked reduction
    S = buf15.capacity
    W = buf15.window
    dev = buf15.times.device
    nan = float("nan")
    onehot_rows, btc_ok = _btc_row_mask(inputs.btc_row, S, comm)
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
        n_dirty = dirty.sum()
        if comm is not None:
            n_dirty = comm.count_sum(n_dirty)
        bc_dirty_rows = n_dirty.to(F32)

        # the BTC closes at -1, -2 and -97 (one broadcast from the owner)
        positions = (-1, -2, -97) if W > 96 else (-1, -2)
        closes = _from_btc(
            comm,
            lambda: torch.stack([
                torch.where(onehot_rows, buf15.values[:, pos, Field.CLOSE], 0.0).sum()
                for pos in positions
            ]),
        )
        picked = [torch.where(btc_ok, closes[i], nan) for i in range(len(positions))]
        btc_last, btc_prev = picked[0], picked[1]
        if W > 96:
            btc_change_96 = _btc_change_96(btc_last, picked[2], btc_ok)
        else:
            btc_change_96 = torch.zeros((), dtype=F32, device=dev)
        btc_mom = _btc_momentum_pair(btc_last, btc_prev)
    else:
        close15 = buf15.values[:, :, Field.CLOSE]
        rets = log_returns(close15)
        btc_onehot = onehot_rows[:, None]
        btc_rets_row, btc_close_row = _from_btc(
            comm,
            lambda: (
                torch.where(btc_onehot, rets, 0.0).sum(dim=0),
                torch.where(btc_onehot, close15, 0.0).sum(dim=0),
            ),
        )
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
        return compute_all or name in wire_enabled

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

    # --- the dormant set, in the reference's order
    ok5f, ok15f = ok5 & fresh5, ok15 & fresh15
    spikes = detect_spikes(buf15) if want("range_failed_breakout_fade") else None
    sts = twap = blsh = btd = bbx = ipt = rbr = rfbf = rsr = skipped
    if want("coinrule_supertrend_swing_reversal"):
        st_up_carry = None
        if incremental:
            # the carried supertrend readout under the scan's own validity
            # rules (ATR warm and unpoisoned); stale rows read not-up
            stc = indicator_carry.st5
            st_up_carry = (
                (stc.n_seen >= ST_WINDOW) & torch.isfinite(stc.atr) & (stc.direction > 0)
                & ~stale5
            )
        sts = _mask_outputs(
            supertrend_swing_reversal(
                buf5, pack5, context, long_gate, inputs.adp_diff, inputs.adp_diff_prev,
                inputs.dominance_is_losers, st_up=st_up_carry,
            ),
            ok5f,
        )
    if want("coinrule_twap_momentum_sniper"):
        twap = _mask_outputs(twap_momentum_sniper(buf15, pack5), ok5f)
    if want("coinrule_buy_low_sell_high"):
        blsh = _mask_outputs(
            buy_low_sell_high(buf15, pack15, inputs.market_domination_reversal), ok15f
        )
    if want("coinrule_buy_the_dip"):
        btd = _mask_outputs(buy_the_dip(buf15, pack15, context, quiet_suppressed), ok15f)
    if want("bb_extreme_reversion"):
        # the reference ships BBX disabled: naming it on the wire enables it
        bbx = _mask_outputs(
            bb_extreme_reversion(
                buf15, pack15, context,
                BBXParams(enabled="bb_extreme_reversion" in wire_enabled),
            ),
            ok15f,
        )
    if want("inverse_price_tracker"):
        ipt = _mask_outputs(inverse_price_tracker(pack5, context), ok5f)
    if want("range_bb_rsi_mean_reversion"):
        rbr = _mask_outputs(range_bb_rsi_mean_reversion(buf15, pack15, context), ok15f)
    if want("range_failed_breakout_fade"):
        rfbf = _mask_outputs(range_failed_breakout_fade(spikes, context), ok15f)
    if want("relative_strength_reversal_range"):
        rsr = _mask_outputs(relative_strength_reversal_range(buf15, pack15, context), ok15f)

    strategies = {
        "activity_burst_pump": abp,
        "coinrule_price_tracker": pt,
        "liquidation_sweep_pump": lsp,
        "mean_reversion_fade": mrf,
        "grid_ladder": ladder,
        "coinrule_supertrend_swing_reversal": sts,
        "coinrule_twap_momentum_sniper": twap,
        "coinrule_buy_low_sell_high": blsh,
        "coinrule_buy_the_dip": btd,
        "bb_extreme_reversion": bbx,
        "inverse_price_tracker": ipt,
        "range_bb_rsi_mean_reversion": rbr,
        "range_failed_breakout_fade": rfbf,
        "relative_strength_reversal_range": rsr,
    }
    summary = build_summary(strategies)
    digest = ingest_block = None
    if numeric_digest:
        # the incremental path's dirty/stale beta rows decode NaN on purpose
        beta_expected_nan = (
            indicator_carry.bc_dirty | stale15
            if incremental
            else torch.zeros((S,), dtype=torch.bool, device=dev)
        )
        digest = _numeric_digest_block(
            pack5, pack15, summary, btc_beta, btc_corr,
            inputs.tracked, ok5, ok15, fresh5, fresh15, beta_expected_nan,
            # a classic deployment's ticks scan only the wire's pack fields;
            # an incremental deployment's full ticks resync the carry and
            # keep the twelve-field scan
            wire_fields_only=not incremental and not maintain_carry,
            sp=sp,
            context=context,
        )
        if comm is not None:
            digest = comm.reduce_blocks(digest, numeric_digest_ops(), kind="digest")
    if ingest_digest:
        ingest_block = _ingest_digest_block(
            inputs.tracked,
            _ingest_interval_stats(
                ring_latest_times(ring5), ring5.filled, inputs.tracked,
                inputs.timestamp5_s, FIVE_MIN_S,
            ),
            _ingest_interval_stats(
                ring_latest_times(ring15), ring15.filled, inputs.tracked,
                inputs.timestamp_s, FIFTEEN_MIN_S,
            ),
            icnt5,
            icnt15,
        )
        if comm is not None:
            ingest_block = comm.reduce_blocks(ingest_block, ingest_digest_ops(), kind="digest")
    wire = pack_wire(
        context, strategies, summary, pack5, pack15,
        btc_beta, btc_corr, btc_change_96, bc_dirty_rows, tuple(wire_enabled),
        digest=digest, ingest=ingest_block, comm=comm,
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
        spikes=spikes,
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
    numeric_digest: bool = False,
    ingest_digest: bool = False,
    ingest_fold_counts: torch.Tensor | None = None,
    compute_all: bool = True,
) -> tuple[EngineState, TickOutputs]:
    """The copying step with every output (tests, overflow fallback). By
    default it evaluates every strategy (``compute_all``), as the
    reference's full-outputs step does; the wire's fired block still
    carries the ``wire_enabled`` set only."""
    if isinstance(state, ShardedState):
        return _sharded().tick_step(
            state, upd5, upd15, inputs, cfg, wire_enabled, incremental,
            maintain_carry, params, numeric_digest, ingest_digest, ingest_fold_counts,
            compute_all=compute_all,
        )
    return _tick_step_impl(
        state, upd5, upd15, inputs, cfg, wire_enabled, incremental,
        maintain_carry, params, numeric_digest, ingest_digest, ingest_fold_counts,
        compute_all=compute_all,
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
    numeric_digest: bool = False,
    ingest_digest: bool = False,
    ingest_fold_counts: torch.Tensor | None = None,
) -> tuple[EngineState, torch.Tensor]:
    """The live engine's copying step: the same evaluation, only the wire
    returned; the input state is left untouched."""
    if isinstance(state, ShardedState):
        return _sharded().tick_step_wire(
            state, upd5, upd15, inputs, cfg, wire_enabled, incremental,
            maintain_carry, params, numeric_digest, ingest_digest, ingest_fold_counts,
        )
    new_state, outputs = _tick_step_impl(
        state, upd5, upd15, inputs, cfg, wire_enabled, incremental,
        maintain_carry, params, numeric_digest, ingest_digest, ingest_fold_counts,
    )
    return new_state, outputs.wire


def tick_step_wire_inplace(
    state: EngineState,
    upd5,
    upd15,
    inputs: HostInputs,
    cfg: ContextConfig = ContextConfig(),
    wire_enabled: tuple[str, ...] = tuple(sorted(LIVE_STRATEGIES)),
    incremental: bool = False,
    maintain_carry: bool = True,
    params=None,
    numeric_digest: bool = False,
    ingest_digest: bool = False,
    ingest_fold_counts: torch.Tensor | None = None,
) -> tuple[EngineState, torch.Tensor]:
    """The live engine's in-place step (the counterpart of the reference's
    donated ``tick_step_wire_donated``): the updates scatter into the input
    state's ring planes, which the returned state goes on using until a
    full tick gathers them canonically. The caller must not read the input
    state's rings as pre-tick data afterwards; the small carries (regime,
    dedupe, indicator) are produced functionally and stay readable."""
    if isinstance(state, ShardedState):
        return _sharded().tick_step_wire(
            state, upd5, upd15, inputs, cfg, wire_enabled, incremental,
            maintain_carry, params, numeric_digest, ingest_digest, ingest_fold_counts,
            inplace=True,
        )
    new_state, outputs = _tick_step_impl(
        state, upd5, upd15, inputs, cfg, wire_enabled, incremental,
        maintain_carry, params, numeric_digest, ingest_digest, ingest_fold_counts,
        inplace=True,
    )
    return new_state, outputs.wire


class RingSlot(NamedTuple):
    """The four ring planes of one engine state: the double-buffered
    step's scratch slot (the counterpart of the state slot the reference's
    ``tick_step_wire_db`` donates). Everything else in a state is small and
    produced functionally by every step."""

    times5: torch.Tensor
    values5: torch.Tensor
    times15: torch.Tensor
    values15: torch.Tensor


def ring_slot_of(state: EngineState) -> RingSlot:
    if isinstance(state, ShardedState):
        return _sharded().ring_slot_of(state)
    return RingSlot(state.buf5.times, state.buf5.values, state.buf15.times, state.buf15.values)


def empty_ring_slot(state: EngineState) -> RingSlot:
    """A fresh slot shaped like ``state``'s rings (uninitialized: the slot
    is always overwritten whole before it is read)."""
    if isinstance(state, ShardedState):
        return _sharded().empty_ring_slot(state)
    return RingSlot(*(torch.empty_like(p) for p in ring_slot_of(state)))


def into_ring_slot(state: EngineState, slot: RingSlot) -> EngineState:
    """The double-buffered step's first half: copy ``state``'s ring planes
    into ``slot`` and return the state re-pointed at the slot. The in-place
    folds and :func:`tick_step_wire_inplace` then write the slot, and
    ``state`` itself stays intact for an in-flight tick's fallback. The
    caller keeps every read of ``state`` and every write of ``slot`` on one
    stream, so a later write into ``state``'s planes (once they are a slot
    themselves) follows this copy's read."""
    if isinstance(state, ShardedState):
        return _sharded().into_ring_slot(state, slot)
    for src, dst in zip(ring_slot_of(state), slot, strict=True):
        dst.copy_(src)
    return state._replace(
        buf5=state.buf5._replace(times=slot.times5, values=slot.values5),
        buf15=state.buf15._replace(times=slot.times15, values=slot.values15),
    )


def slot_storages(slot: RingSlot) -> set[int]:
    """The storage addresses of a slot's planes (every shard's, for a
    sharded slot)."""
    return {p.untyped_storage().data_ptr() for p in slot_planes(slot)}


def slot_planes(slot) -> list[torch.Tensor]:
    """A slot's ring planes: its four, or every shard slot's four."""
    if isinstance(slot[0], RingSlot):
        return [p for sub in slot for p in sub]
    return list(slot)


def slot_is_free_of(slot: RingSlot, state: EngineState) -> bool:
    """The torch counterpart of the reference's ``_unique_buffers`` check:
    True when the slot's four planes use four storages of their own, none
    of them one of ``state``'s ring planes'."""
    own = slot_storages(slot)
    return len(own) == len(slot_planes(slot)) and not own & slot_storages(ring_slot_of(state))


def canonicalize_state(state: EngineState) -> EngineState:
    """Both rings materialized to the canonical right-aligned layout
    (cursor 0), new tensors that no later in-place tick writes: what a
    checkpoint persists. Every other leaf passes through."""
    if isinstance(state, ShardedState):
        return _sharded().canonicalize_state(state)
    return state._replace(buf5=materialize(state.buf5), buf15=materialize(state.buf15))


def small_carries_of(state: EngineState):
    """Everything of a state but its rings (regime, dedupe and indicator
    carries), which every step produces functionally: what an in-place
    tick's fallback re-attaches to the post-tick rings."""
    if isinstance(state, ShardedState):
        return tuple(small_carries_of(s) for s in state.shards)
    return (state.regime_carry, state.mrf_last_emitted, state.pt_last_signal_close,
            state.indicator_carry)


def with_small_carries(state: EngineState, small) -> EngineState:
    """``state``'s rings with the small carries :func:`small_carries_of`
    took."""
    if isinstance(state, ShardedState):
        return state.with_shards(
            [with_small_carries(s, c) for s, c in zip(state.shards, small, strict=True)]
        )
    return state._replace(
        regime_carry=small[0], mrf_last_emitted=small[1],
        pt_last_signal_close=small[2], indicator_carry=small[3],
    )


def apply_updates_step(
    state: EngineState, upd5, upd15, inplace: bool = False
) -> EngineState:
    """Update-only fold of one sub-batch pair (no evaluation). Leaves the
    indicator carry untouched: an incremental engine folds with
    :func:`apply_updates_carry_step` or marks the carry desynced."""
    if isinstance(state, ShardedState):
        return _sharded().apply_updates_step(state, upd5, upd15, inplace)
    return state._replace(
        buf5=apply_updates(state.buf5, *upd5, inplace=inplace),
        buf15=apply_updates(state.buf15, *upd15, inplace=inplace),
    )


def _advance_folded(state: EngineState, buf5, buf15, btc_row, comm=None) -> EngineState:
    """The folded rings with the carry advanced by their newest bar."""
    row = torch.as_tensor(
        -1 if btc_row is None else btc_row, dtype=I32, device=buf15.times.device
    )
    carry, _, _ = advance_indicator_carry(
        materialize_tail(buf5, min(buf5.window, INCR_TAIL_WINDOW)),
        materialize_tail(buf15, min(buf15.window, INCR_TAIL_WINDOW)),
        state.indicator_carry,
        row,
        comm=comm,
    )
    return state._replace(buf5=buf5, buf15=buf15, indicator_carry=carry)


def apply_updates_carry_step(
    state: EngineState,
    upd5,
    upd15,
    btc_row: torch.Tensor | int | None = None,
    inplace: bool = False,
) -> EngineState:
    """Sub-batch fold that ALSO advances every carried family, so a
    multi-bar drain of clean appends (three 5m bars in one 15m tick) stays
    on the incremental path. ``btc_row`` keeps the beta/corr pairing
    advancing through the folds; None marks those rows dirty instead."""
    if isinstance(state, ShardedState):
        return _sharded().apply_updates_carry_step(state, upd5, upd15, btc_row, inplace)
    buf5 = apply_updates(state.buf5, *upd5, inplace=inplace)
    buf15 = apply_updates(state.buf15, *upd15, inplace=inplace)
    return _advance_folded(state, buf5, buf15, btc_row)


def apply_updates_step_counted(
    state: EngineState, upd5, upd15, counts: torch.Tensor, inplace: bool = False
) -> tuple[EngineState, torch.Tensor]:
    """Counted twin of :func:`apply_updates_step`: also adds the sub-batch
    pair's (8,) ingest counts, classified against the pre-fold rings, to
    ``counts``."""
    if isinstance(state, ShardedState):
        return _sharded().apply_updates_step_counted(state, upd5, upd15, counts, inplace)
    buf5, buf15, counts = _counted_fold_bufs(state, upd5, upd15, counts, inplace)
    return state._replace(buf5=buf5, buf15=buf15), counts


def apply_updates_carry_step_counted(
    state: EngineState,
    upd5,
    upd15,
    btc_row: torch.Tensor | int | None = None,
    counts: torch.Tensor | None = None,
    inplace: bool = False,
) -> tuple[EngineState, torch.Tensor]:
    """Counted twin of :func:`apply_updates_carry_step` (``counts`` None
    starts from zeros)."""
    if isinstance(state, ShardedState):
        return _sharded().apply_updates_carry_step_counted(
            state, upd5, upd15, btc_row, counts, inplace
        )
    if counts is None:
        counts = torch.zeros((8,), dtype=F32, device=state.buf15.times.device)
    buf5, buf15, counts = _counted_fold_bufs(state, upd5, upd15, counts, inplace)
    return _advance_folded(state, buf5, buf15, btc_row), counts


# --- the multi-tick drives' device side ---------------------------------------
# The scanned drive (``SignalEngine.process_ticks_scanned``) runs T replayed
# ticks as one device-side loop: the stacked inputs are uploaded once, and
# nothing inside the loop reads the card from the host, so the host issues
# the whole chunk before the one copy of the stacked wires. Nothing here
# writes its input state: the caller keeps it as the overflow re-drive's
# anchor.


def apply_updates_scan(
    state: EngineState, upd5_seq, upd15_seq, inplace: bool = False
) -> EngineState:
    """Update-only fold of T stacked sub-batch pairs, ``(rows (T, U), ts
    (T, U), vals (T, U, F))`` per interval, in order: the loop form of T
    :func:`apply_updates_step` folds (backfill and restore catch-up). Padding
    slots (rows -1) are exact no-ops. The indicator carry is left untouched
    (the caller marks it desynced)."""
    if isinstance(state, ShardedState):
        return _sharded().apply_updates_scan(state, upd5_seq, upd15_seq, inplace)
    for t in range(upd5_seq[0].shape[0]):
        state = apply_updates_step(
            state, tuple(x[t] for x in upd5_seq), tuple(x[t] for x in upd15_seq),
            inplace=inplace,
        )
    return state


def apply_updates_scan_counted(
    state: EngineState, upd5_seq, upd15_seq, counts: torch.Tensor, inplace: bool = False
) -> tuple[EngineState, torch.Tensor]:
    """Counted twin of :func:`apply_updates_scan`: the (8,) ingest counts of
    every folded slot accumulate into ``counts``."""
    if isinstance(state, ShardedState):
        return _sharded().apply_updates_scan_counted(state, upd5_seq, upd15_seq, counts, inplace)
    for t in range(upd5_seq[0].shape[0]):
        state, counts = apply_updates_step_counted(
            state, tuple(x[t] for x in upd5_seq), tuple(x[t] for x in upd15_seq),
            counts, inplace=inplace,
        )
    return state, counts


def _fold_and_step_wire(
    state: EngineState,
    upd5_slots,
    upd15_slots,
    inputs: HostInputs,
    cfg: ContextConfig,
    wire_enabled: tuple[str, ...],
    incremental: bool,
    maintain_carry: bool,
    params=None,
    numeric_digest: bool = False,
    ingest_digest: bool = False,
) -> tuple[EngineState, torch.Tensor]:
    """One replayed tick of the scan: fold every sub-batch slot but the
    last (the serial ``_fold_updates``; on the incremental path each fold
    advances every carried family), then the wire step on the last slot.
    ``upd*_slots`` are ``(rows (N, U), ts (N, U), vals (N, U, F))``; empty
    slots (all rows -1) are exact no-ops on the rings and the carries. With
    the ingest digest on, each fold slot's counts accumulate so the wire's
    ingest block covers the tick's whole drain."""
    n = upd5_slots[0].shape[0]
    fold_counts = (
        torch.zeros((8,), dtype=F32, device=state.buf15.times.device)
        if ingest_digest else None
    )
    for d in range(n - 1):
        u5 = tuple(x[d] for x in upd5_slots)
        u15 = tuple(x[d] for x in upd15_slots)
        if ingest_digest:
            buf5, buf15, fold_counts = _counted_fold_bufs(state, u5, u15, fold_counts)
        else:
            buf5 = apply_updates(state.buf5, *u5)
            buf15 = apply_updates(state.buf15, *u15)
        carry = state.indicator_carry
        if incremental:
            fold_tw = _advance_tail_floor(params)
            carry, _, _ = advance_indicator_carry(
                materialize_tail(buf5, min(buf5.window, fold_tw)),
                materialize_tail(buf15, min(buf15.window, fold_tw)),
                carry, inputs.btc_row, params,
            )
        state = state._replace(buf5=buf5, buf15=buf15, indicator_carry=carry)
    return tick_step_wire(
        state,
        tuple(x[n - 1] for x in upd5_slots),
        tuple(x[n - 1] for x in upd15_slots),
        inputs, cfg, wire_enabled, incremental, maintain_carry, params,
        numeric_digest, ingest_digest, fold_counts,
    )


def tick_step_scan(
    state: EngineState,
    upd5_seq,
    upd15_seq,
    inputs_seq: HostInputs,
    momentum_ok: torch.Tensor,
    policy_prev: tuple[torch.Tensor, torch.Tensor],
    cfg: ContextConfig = ContextConfig(),
    wire_enabled: tuple[str, ...] = tuple(sorted(LIVE_STRATEGIES)),
    incremental: bool = True,
    maintain_carry: bool = True,
    params=None,
    numeric_digest: bool = False,
    ingest_digest: bool = False,
) -> tuple[EngineState, torch.Tensor, torch.Tensor]:
    """T replayed ticks as one device-side loop (the reference's
    ``lax.scan`` of ``_fold_and_step_wire``).

    * ``upd5_seq``/``upd15_seq`` — ``(rows (T, N, U), ts (T, N, U), vals
      (T, N, U, F))`` stacked per-tick sub-batch slots, each tick's own
      slots at the tail (front-padded with empty ones), so its last slot is
      the evaluated one;
    * ``inputs_seq`` — ``HostInputs`` with every leaf stacked to (T, ...);
    * ``momentum_ok``/``policy_prev`` — the grid-only policy's recursion on
      the card: ``allow = momentum_ok[t] & prev_valid & prev_regime in
      {RANGE, TRANSITIONAL}``, ``GridOnlyPolicy.resolve``'s ladder, with
      (valid, regime) taken from each tick's wire and seeded by the host's
      last finalized tick.

    Returns ``(final_state, wires (T, wire_length), fired_count (T,))``; the
    input state is left untouched (copying steps), so a caller can drop the
    result and re-drive serially when a tick's fired count exceeds
    ``WIRE_MAX_FIRED``."""
    range_code = int(MarketRegimeCode.RANGE)
    trans_code = int(MarketRegimeCode.TRANSITIONAL)
    prev_valid, prev_regime = policy_prev
    wires = []
    for t in range(len(momentum_ok)):
        allow = momentum_ok[t] & prev_valid & (
            (prev_regime == range_code) | (prev_regime == trans_code)
        )
        inp = HostInputs(*(leaf[t] for leaf in inputs_seq))._replace(grid_policy_allows=allow)
        state, wire = _fold_and_step_wire(
            state,
            tuple(x[t] for x in upd5_seq),
            tuple(x[t] for x in upd15_seq),
            inp, cfg, wire_enabled, incremental, maintain_carry, params,
            numeric_digest, ingest_digest,
        )
        prev_valid = wire[0] > 0.5
        prev_regime = wire[1].to(I32)
        wires.append(wire)
    stacked = torch.stack(wires)
    return state, stacked, stacked[:, WIRE_FIRED_COUNT_OFF]


# --- the carry-drift meter ---------------------------------------------------
# On an audit tick: the carried indicator state advanced by the tick's
# updates (what the incremental path would read) against a fresh init from
# the post-update windows (what the audit's resync installs), per family.

DRIFT_FAMILIES: tuple[str, ...] = (
    "ewm", "sums", "moments", "supertrend", "beta_corr", "abp_sorted", "lsp_sorted",
)
_EWM_LEAVES = (
    "ema9", "ema21", "ema20", "ema50",
    "macd_fast", "macd_slow", "macd_sig", "gain_w", "loss_w",
)
_SUM_LEAVES = ("gain_s", "loss_s", "pos_flow", "neg_flow")
_MOMENT_LEAVES = ("close_m", "vol_m", "tr_m")


def _ulp_distance(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """float32 ULP distance through the ordered-integer mapping of the bit
    patterns (adjacent floats differ by 1). A same-sign difference is taken
    in exact int32 arithmetic; a cross-sign one, already huge, sums the
    magnitudes in float32. Returned as float32."""

    def ordered(x):
        bits = x.to(F32).contiguous().view(torch.int32)
        mag = bits & 0x7FFFFFFF
        return torch.where(bits >= 0, bits, -mag)

    ka, kb = ordered(a), ordered(b)
    same_sign = (ka >= 0) == (kb >= 0)
    # same sign: both keys in [0, 2**31) or both in (-2**31, 0], so the
    # int32 difference cannot overflow
    exact = torch.abs(ka - kb).to(F32)
    crossed = torch.abs(ka.to(F32)) + torch.abs(kb.to(F32))
    return torch.where(same_sign, exact, crossed)


def _leaf_stats(pairs) -> tuple[torch.Tensor, torch.Tensor]:
    """Per (carried, fresh, mask) leaf, over the positions finite on BOTH
    sides: ``(L, 3)`` float32 (max abs difference, largest compared
    magnitude, max ULP distance) and ``(L,)`` int32 compared counts. Each is
    an extreme or a count, so a sharded tick combines its shards' stats
    exactly (max, max, max, sum) before :func:`_family_drift` reads them."""
    stats, counts = [], []
    for c, f, m in pairs:
        both = torch.broadcast_to(m, c.shape) & torch.isfinite(c) & torch.isfinite(f)
        cf, ff = c.to(F32), f.to(F32)
        mag = torch.maximum(torch.abs(cf), torch.abs(ff))
        stats.append(torch.stack([
            torch.where(both, torch.abs(cf - ff), 0.0).max(),
            torch.where(both, mag, 0.0).max(),
            torch.where(both, _ulp_distance(c, f), 0.0).max(),
        ]))
        counts.append(both.sum(dtype=I32))
    return torch.stack(stats), torch.stack(counts)


def _drift_of(pairs) -> dict[str, torch.Tensor]:
    """Max-abs, scale-normalized and max-ULP drift over (carried, fresh,
    mask) triples; only positions finite on BOTH sides compare."""
    return _family_drift(*_leaf_stats(pairs))


def _family_drift(stats: torch.Tensor, counts: torch.Tensor) -> dict[str, torch.Tensor]:
    """Max-abs, scale-normalized and max-ULP drift of one family from its
    leaves' :func:`_leaf_stats`. ``max_rel`` (what the alarm judges) is each
    leaf's max-abs drift over that leaf's largest compared magnitude, maxed
    over the family's leaves."""
    zero = torch.zeros((), dtype=F32, device=stats.device)
    leaf_abs, leaf_scale, leaf_ulp = stats.unbind(dim=1)
    return {
        "max_abs": torch.maximum(zero, leaf_abs.max()),
        "max_rel": torch.maximum(zero, (leaf_abs / torch.clamp(leaf_scale, min=1e-30)).max()),
        "max_ulp": torch.maximum(zero, leaf_ulp.max()),
        "compared": counts.sum(dtype=I32),
    }


def _carry_drift_impl(
    state: EngineState, upd5, upd15, btc_row: torch.Tensor, params=None, comm=None
) -> dict[str, dict[str, torch.Tensor]] | None:
    """Per-family drift between the carried state advanced by this tick's
    updates and a fresh init from the post-update windows. Rows the advance
    marked stale, dirty beta/corr rows and dirty ABP rows are left out:
    their divergence is documented behaviour, not drift. The updates apply
    through the COPYING form: the meter never writes the live rings. Under
    a sharded tick (``comm``) each shard measures its rows and shard 0
    combines the leaves' stats (None on the other shards)."""
    buf5 = materialize(apply_updates(state.buf5, *upd5))
    buf15 = materialize(apply_updates(state.buf15, *upd15))

    def canonical_tail(buf: MarketBuffer, width: int) -> MarketBuffer:
        # buf is canonical already: its tail is a plain slice
        width = min(width, buf.window)
        return MarketBuffer(
            times=buf.times[:, -width:], values=buf.values[:, -width:],
            filled=buf.filled, cursor=buf.cursor,
        )

    tail = _advance_tail_floor(params)
    carried, stale5, stale15 = advance_indicator_carry(
        canonical_tail(buf5, tail), canonical_tail(buf15, tail),
        state.indicator_carry, btc_row, params, comm,
    )
    fresh = init_indicator_carry(buf5, buf15, btc_row, params, site="carry_drift", comm=comm)
    live5 = ~stale5 & (buf5.filled > 0)
    live15 = ~stale15 & (buf15.filled > 0)

    ewm_pairs, sum_pairs, moment_pairs = [], [], []
    for pc, pf, mask in ((carried.pack5, fresh.pack5, live5), (carried.pack15, fresh.pack15, live15)):
        for name in _EWM_LEAVES:
            c, f = getattr(pc, name), getattr(pf, name)
            ewm_pairs.append((c.mean, f.mean, mask & (c.rel >= 0) & (f.rel >= 0)))
        for name in _SUM_LEAVES:
            c, f = getattr(pc, name), getattr(pf, name)
            sum_pairs.append((c.wsum, f.wsum, mask & (c.cnt == f.cnt) & (c.cnt > 0)))
        for name in _MOMENT_LEAVES:
            c, f = getattr(pc, name), getattr(pf, name)
            m = mask & (c.cnt == f.cnt) & (c.cnt > 0)
            moment_pairs.append((moment_mean(c, 1, 1), moment_mean(f, 1, 1), m))
            moment_pairs.append((moment_std(c, 1, 1), moment_std(f, 1, 1), m))

    stc, stf = carried.st5, fresh.st5
    st_mask = live5 & (stc.n_seen >= ST_WINDOW) & (stf.n_seen >= ST_WINDOW)
    st_pairs = [
        (stc.atr, stf.atr, st_mask),
        (stc.final_upper, stf.final_upper, st_mask),
        (stc.final_lower, stf.final_lower, st_mask),
        (stc.direction, stf.direction, st_mask),
    ]

    cb, cc = beta_corr_value(carried.bc15, BC_WINDOW)
    fb, fc = beta_corr_value(fresh.bc15, BC_WINDOW)
    bc_mask = (
        live15 & ~carried.bc_dirty
        & (carried.bc15.cnt >= BC_WINDOW) & (fresh.bc15.cnt >= BC_WINDOW)
    )
    bc_pairs = [(cb, fb, bc_mask), (cc, fc, bc_mask)]

    abpc, abpf = carried.abp5, fresh.abp5
    abp_mask = live5 & ~abpc.dirty
    abp_pairs = [
        (c.sorted, f.sorted, (abp_mask & (c.cnt == f.cnt))[:, None])
        for c, f in (
            (abpc.vol_med, abpf.vol_med),
            (abpc.qvol_med, abpf.qvol_med),
            (abpc.score_q, abpf.score_q),
        )
    ]

    lspc, lspf = carried.lsp15, fresh.lsp15
    lsp_pairs = [
        (
            lspc.score_q.sorted, lspf.score_q.sorted,
            (live15 & (lspc.score_q.cnt == lspf.score_q.cnt))[:, None],
        ),
        (lspc.prev_raw, lspf.prev_raw, live15),
    ]
    families = (ewm_pairs, sum_pairs, moment_pairs, st_pairs, bc_pairs, abp_pairs, lsp_pairs)
    stats = [_leaf_stats(pairs) for pairs in families]
    if comm is not None:
        parts = comm.gather(tuple(stats), kind="drift")
        if parts is None:
            return None
        stats = [
            (
                torch.stack([p[i][0] for p in parts]).amax(dim=0),
                torch.stack([p[i][1] for p in parts]).sum(dim=0, dtype=I32),
            )
            for i in range(len(families))
        ]
    return {fam: _family_drift(*st) for fam, st in zip(DRIFT_FAMILIES, stats, strict=True)}


_DRIFT_FIELDS = ("max_abs", "max_rel", "max_ulp", "compared")


def measure_carry_drift(state: EngineState, upd5, upd15, btc_row, params=None) -> dict:
    """Host entry of the meter: ``{family: {"max_abs": float, "max_rel":
    float, "max_ulp": int, "compared": int}}`` for every
    :data:`DRIFT_FAMILIES` entry. The 28 scalars land in ONE device-to-host
    copy (``compared`` rides bit for bit as int32 in the float32 vector)."""
    if isinstance(state, ShardedState):
        out = _sharded().carry_drift(state, upd5, upd15, btc_row, params)
    else:
        dev = state.buf15.times.device
        out = _carry_drift_impl(
            state, upd5, upd15, torch.as_tensor(btc_row, dtype=I32, device=dev), params
        )
    return _drift_to_host(out)


def _drift_to_host(out: dict) -> dict:
    flat = torch.stack(
        [
            out[fam][k] if k != "compared" else out[fam][k].reshape(1).view(F32)[0]
            for fam in DRIFT_FAMILIES
            for k in _DRIFT_FIELDS
        ]
    ).cpu().numpy()
    counts = flat.view(np.int32)
    result = {}
    for i, fam in enumerate(DRIFT_FAMILIES):
        base = i * len(_DRIFT_FIELDS)
        result[fam] = {
            "max_abs": float(flat[base]),
            "max_rel": float(flat[base + 1]),
            "max_ulp": int(flat[base + 2]),
            "compared": int(counts[base + 3]),
        }
    return result


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


def unpack_wire(
    wire, numeric_digest: bool = False, ingest_digest: bool = False
) -> tuple[WireFired, dict]:
    """Split one fetched wire into fired entries + context scalars. With
    ``ingest_digest`` the trailing ingest block is stripped into
    ``ctx["ingest_digest"]`` first, then with ``numeric_digest`` the numeric
    block into ``ctx["numeric_digest"]``, so the calibration rows are found
    at the pre-digest layout."""
    w = np.asarray(wire)
    ingest = digest = None
    if ingest_digest:
        ingest = w[-INGEST_DIGEST_WIDTH:]
        w = w[:-INGEST_DIGEST_WIDTH]
    if numeric_digest:
        digest = w[-NUMERIC_DIGEST_WIDTH:]
        w = w[:-NUMERIC_DIGEST_WIDTH]
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
    if digest is not None:
        ctx["numeric_digest"] = digest
    if ingest is not None:
        ctx["ingest_digest"] = ingest
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


def unpack_wire_block(
    wires, numeric_digest: bool = False, ingest_digest: bool = False
) -> list[tuple[WireFired, dict]]:
    """Vectorized twin of :func:`unpack_wire` over a stacked ``(T, L)`` wire
    block: one numpy pass for the digest, scalar, fired-block and payload
    slicing instead of T per-tick re-slices. Returns exactly the tuples
    ``[unpack_wire(w, ...) for w in wires]`` would (one bulk float32 →
    float64 widen is bit-identical to per-element ``float()``)."""
    w = np.asarray(wires)
    if w.ndim != 2:
        raise ValueError(f"unpack_wire_block expects (T, L), got {w.shape}")
    T = w.shape[0]
    ingest = digest = None
    if ingest_digest:
        ingest = w[:, -INGEST_DIGEST_WIDTH:]
        w = w[:, :-INGEST_DIGEST_WIDTH]
    if numeric_digest:
        digest = w[:, -NUMERIC_DIGEST_WIDTH:]
        w = w[:, :-NUMERIC_DIGEST_WIDTH]
    na, nb = len(WIRE_SCALARS_A), len(WIRE_SCALARS_B)
    off = WIRE_FIRED_COUNT_OFF
    scal = w[:, :off].astype(np.float64).tolist()
    K = WIRE_MAX_FIRED
    ns = w[:, off]
    blocks = w[:, off + 1 : off + 1 + 6 * K].reshape(T, 6, K)
    strat_all = blocks[:, 0, :].astype(np.int32)
    row_all = blocks[:, 1, :].astype(np.int32)
    auto_all = blocks[:, 2, :] > 0.5
    dir_all = blocks[:, 3, :].astype(np.int32)
    payload_off = off + 1 + 6 * K
    L = w.shape[1]
    payload_all = calib_all = None
    if L >= payload_off + K * EMISSION_SLOT_WIDTH:
        payload_all = w[:, payload_off : payload_off + K * EMISSION_SLOT_WIDTH].reshape(
            T, K, EMISSION_SLOT_WIDTH
        )
        calib_off = payload_off + K * EMISSION_SLOT_WIDTH
        rest = L - calib_off
        if rest > 0 and rest % 3 == 0:
            calib_all = w[:, calib_off:].reshape(T, 3, rest // 3)
    out: list[tuple[WireFired, dict]] = []
    for t in range(T):
        vals = scal[t]
        ctx = dict(zip(WIRE_SCALARS_A, vals))
        ctx.update(zip(WIRE_SCALARS_B, vals[na:]))
        ctx["timestamp"] = int(vals[na + nb]) * _WIRE_TS_BASE + int(vals[na + nb + 1])
        ctx["regime_stable_since"] = (
            int(vals[na + nb + 2]) * _WIRE_TS_BASE + int(vals[na + nb + 3])
        )
        for k in ("market_regime", "previous_market_regime", "market_regime_transition",
                  "fresh_count"):
            ctx[k] = int(ctx[k])
        ctx["valid"] = ctx["valid"] > 0.5
        ctx["regime_is_transitioning"] = ctx["regime_is_transitioning"] > 0.5
        n = int(ns[t])
        kept = min(n, K)
        payload = None
        if payload_all is not None:
            payload = payload_all[t, :kept]
            if calib_all is not None:
                ctx["calib_valid"] = calib_all[t, 0] > 0.5
                ctx["calib_close"] = calib_all[t, 1]
                ctx["calib_atr_pct"] = calib_all[t, 2]
        if digest is not None:
            ctx["numeric_digest"] = digest[t]
        if ingest is not None:
            ctx["ingest_digest"] = ingest[t]
        fired = WireFired(
            n=n,
            overflow=n > K,
            strategy_idx=strat_all[t, :kept],
            row=row_all[t, :kept],
            autotrade=auto_all[t, :kept],
            direction=dir_all[t, :kept],
            score=blocks[t, 4, :kept],
            stop_loss_pct=blocks[t, 5, :kept],
            payload=payload,
        )
        out.append((fired, ctx))
    return out
