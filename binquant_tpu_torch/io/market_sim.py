"""Stylized-facts crypto market simulator.

The port's own copy of the reference's generator
(``binquant_tpu/io/market_sim.py``), pure numpy: the same seed gives the
same arrays bit for bit, and :func:`write_market_file` the same bytes. A
GARCH(1,1) market factor and per-symbol idiosyncratic streams with
Student-t innovations (volatility clustering, fat tails), betas to the
factor, volume coupled to the bar's normalized move with an intraday
season, liquidation cascades (multi-bar market-wide crashes on blown-out
volume with a partial rebound) and idiosyncratic pumps (a +5..8% bar on
8-14x volume after a short run-up).

5m bars are generated first; 15m bars are exact 3-bar aggregates, so the
two interval streams agree. The scenario engine (``sim/scenarios.py``)
reuses :func:`_garch_path` at 15m granularity.
"""

from __future__ import annotations

import gzip
import math
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from binquant_tpu_torch.io.replay import _kline_json

FIVE_MIN_S = 300


@dataclass(frozen=True)
class MarketSimConfig:
    n_symbols: int = 100
    hours: int = 36
    seed: int = 17
    # Student-t tail index for return innovations
    t_df: float = 4.0
    # GARCH(1,1): sigma2_t = omega + alpha r2_{t-1} + beta sigma2_{t-1}
    garch_alpha: float = 0.12
    garch_beta: float = 0.85
    # long-run per-5m-bar vol of the market factor (~0.18%: BTC-like)
    factor_vol: float = 0.0018
    # per-symbol long-run idio vol range (altcoins noisier than BTC)
    idio_vol_range: tuple[float, float] = (0.0012, 0.0045)
    beta_range: tuple[float, float] = (0.5, 1.6)
    # events are placed after this many hours so MIN_BARS(=100) of 15m
    # history exists when strategies see them
    event_start_hour: int = 27
    n_cascades: int = 1
    n_pumps: int = 8
    # volume model: log V = base + vol_sensitivity * |r|/sigma + season
    vol_sensitivity: float = 0.9


def _garch_path(
    innov: np.ndarray, long_run_vol: float, alpha: float, beta: float
) -> np.ndarray:
    """Return series with GARCH(1,1) variance driven by ``innov`` (unit
    variance), time on the first axis, vectorized over the others."""
    T = innov.shape[0]
    long_var = long_run_vol**2
    omega = (1.0 - alpha - beta) * long_var
    var = np.full(innov.shape[1:], long_var)
    out = np.empty_like(innov)
    for t in range(T):
        sigma = np.sqrt(var)
        out[t] = sigma * innov[t]
        var = omega + alpha * out[t] ** 2 + beta * var
    return out


def simulate_market(cfg: MarketSimConfig) -> dict:
    """Simulate the market; returns 5m OHLCV arrays of shape (T, S)."""
    rng = np.random.default_rng(cfg.seed)
    S = cfg.n_symbols
    T = cfg.hours * 12  # 5m bars

    # unit-variance Student-t innovations (fat tails)
    scale = math.sqrt(cfg.t_df / (cfg.t_df - 2.0))
    innov_m = rng.standard_t(cfg.t_df, size=T) / scale
    innov_i = rng.standard_t(cfg.t_df, size=(T, S)) / scale

    # market factor with volatility clustering
    r_m = _garch_path(
        innov_m[:, None], cfg.factor_vol, cfg.garch_alpha, cfg.garch_beta
    )[:, 0]

    # liquidation cascades: multi-bar crash + volume blowout + rebound
    event_vol_mult = np.ones(T)
    first_event_bar = cfg.event_start_hour * 12
    cascade_shape = np.array([-0.022, -0.034, -0.016, 0.013, 0.006])
    for _ in range(cfg.n_cascades):
        lo = first_event_bar + 8
        hi = T - len(cascade_shape) - 4
        if hi <= lo:
            break
        start = int(rng.integers(lo, hi))
        jitter = 1.0 + 0.3 * rng.standard_normal(len(cascade_shape))
        r_m[start : start + len(cascade_shape)] += cascade_shape * jitter
        event_vol_mult[start : start + len(cascade_shape)] *= np.array(
            [7.0, 12.0, 8.0, 5.0, 3.0]
        )

    # symbols: beta to the factor + idiosyncratic GARCH stream
    betas = rng.uniform(*cfg.beta_range, size=S)
    betas[0] = 1.0  # BTC IS the factor
    idio_vol = rng.uniform(*cfg.idio_vol_range, size=S)
    idio_vol[0] = cfg.factor_vol * 0.15
    r_i = _garch_path(innov_i, 1.0, cfg.garch_alpha, cfg.garch_beta)
    r = betas[None, :] * r_m[:, None] + r_i * idio_vol[None, :]

    # idiosyncratic pumps: 2-bar run-up then a +5..8% bar (never on BTC,
    # so at least one altcoin is needed)
    pump_vol_mult = np.ones((T, S))
    for _ in range(cfg.n_pumps if S > 1 else 0):
        sym = int(rng.integers(1, S))
        bar = int(rng.integers(first_event_bar + 4, T - 2))
        r[bar - 2 : bar, sym] = np.abs(r[bar - 2 : bar, sym]) + 0.004
        r[bar, sym] = rng.uniform(0.05, 0.08)
        pump_vol_mult[bar, sym] = rng.uniform(8.0, 14.0)
        pump_vol_mult[bar - 2 : bar, sym] = 2.0

    # price paths
    p0 = np.exp(rng.uniform(np.log(0.05), np.log(300.0), size=S))
    p0[0] = 65_000.0
    close = p0[None, :] * np.cumprod(1.0 + r, axis=0)
    open_ = np.vstack([p0[None, :], close[:-1]])

    # intrabar wicks: half-normal extension scaled to the bar's own move
    bar_scale = np.abs(r) + idio_vol[None, :]
    wick_up = np.abs(rng.standard_normal((T, S))) * 0.35 * bar_scale
    wick_dn = np.abs(rng.standard_normal((T, S))) * 0.35 * bar_scale
    high = np.maximum(open_, close) * (1.0 + wick_up)
    low = np.minimum(open_, close) * (1.0 - wick_dn)

    # volume: base level per symbol, |r|/sigma coupling, intraday season
    base_v = rng.uniform(np.log(200.0), np.log(5000.0), size=S)
    sigma_proxy = betas[None, :] * cfg.factor_vol + idio_vol[None, :]
    zscore = np.abs(r) / sigma_proxy
    hour_of_day = (np.arange(T) // 12) % 24
    season = 0.25 * np.sin(2 * np.pi * (hour_of_day - 3) / 24.0)[:, None]
    noise = 0.35 * rng.standard_normal((T, S))
    volume = np.exp(
        base_v[None, :] + cfg.vol_sensitivity * np.minimum(zscore, 6.0) * 0.35
        + season + noise
    )
    volume *= event_vol_mult[:, None] * pump_vol_mult

    trades = np.maximum(5.0, volume * 0.3).round()
    return {
        "open": open_, "high": high, "low": low, "close": close,
        "volume": volume, "trades": trades,
    }


def write_market_file(
    path: str | Path, cfg: MarketSimConfig = MarketSimConfig(),
    t0: int = 1_753_000_200,
) -> dict:
    """Write the simulated market as the dual-interval replay JSONL
    (gzipped when the path ends in .gz); 15m bars are exact aggregates of
    their three 5m bars. Returns the simulated arrays."""
    assert t0 % 900 == 0, "replay files must be 15m-aligned"
    sim = simulate_market(cfg)
    S = cfg.n_symbols
    T = sim["close"].shape[0]
    names = ["BTCUSDT"] + [f"S{i:03d}USDT" for i in range(1, S)]

    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "wt") as f:
        for b in range(T // 3):  # 15m bucket index
            ts15 = t0 + b * 900
            i0 = b * 3
            for s in range(S):
                o = sim["open"][i0, s]
                c = sim["close"][i0 + 2, s]
                h = sim["high"][i0 : i0 + 3, s].max()
                lo = sim["low"][i0 : i0 + 3, s].min()
                v = sim["volume"][i0 : i0 + 3, s].sum()
                n = sim["trades"][i0 : i0 + 3, s].sum()
                f.write(_kline_json(names[s], ts15, 900, o, h, lo, c, v, n))
                for j in range(3):
                    t = i0 + j
                    f.write(
                        _kline_json(
                            names[s], ts15 + j * FIVE_MIN_S, FIVE_MIN_S,
                            sim["open"][t, s], sim["high"][t, s],
                            sim["low"][t, s], sim["close"][t, s],
                            sim["volume"][t, s], sim["trades"][t, s],
                        )
                    )
    return sim
