"""The host-edge helpers the per-symbol oracle and emission read, against the
reference's: the quiet-hours resolution and its Telegram block
(``regime/time_filter.py``: the port's London time is the UK civil-time
rule, the reference's ``zoneinfo``; every 20 minutes over two years,
across both DST changes, the verdicts are equal), the long-autotrade
explainer (``regime/routing.py`` ``long_autotrade_decision``: every branch,
the port's context on torch tensors, the reference's on numpy), the
regime and transition labels (``enums.py``) and the scalar helpers
(``utils.py``)."""

from datetime import datetime, timedelta, timezone
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from binquant_tpu import enums as jenums
from binquant_tpu import utils as jutils
from binquant_tpu.regime import routing as jrouting
from binquant_tpu.regime import time_filter as jtf
from binquant_tpu_torch import enums as tenums
from binquant_tpu_torch import utils as tutils
from binquant_tpu_torch.regime import routing as trouting
from binquant_tpu_torch.regime import time_filter as ttf

UTC = timezone.utc


def _instants():
    t = datetime(2026, 1, 1, tzinfo=UTC)
    while t < datetime(2028, 1, 1, tzinfo=UTC):
        yield t
        t += timedelta(minutes=20)


@pytest.mark.parametrize("regime,strength", [
    (None, 0.0), (-1, 0.9), (1, 0.7), (2, 0.95), (1, 0.69), (3, 0.9), (0, 0.0),
])
def test_quiet_hours_resolution_matches_reference(regime, strength):
    seen = set()
    for now in _instants():
        j = jtf.resolve_quiet_hours(regime, strength, now=now)
        t = ttf.resolve_quiet_hours(regime, strength, now=now)
        assert tuple(t) == tuple(j), now
        assert ttf.is_autotrade_suppressed(regime, strength, now=now) == j.suppressed
        seen.add(j.reason)
    assert "outside_window" in seen and len(seen) == 2  # the window is entered


def test_quiet_hours_message_matches_reference(monkeypatch):
    monkeypatch.setenv("ENV", "staging")
    for now in (datetime(2026, 7, 1, 19, 5, tzinfo=UTC), datetime(2026, 12, 1, 21, 40, tzinfo=UTC)):
        for args in (("XUSDT", "pt", "LONG", 3, 5, 0.41, 0.2),
                     ("YUSDT", "abp", "LONG", None, None, None, None),
                     ("ZUSDT", "mrf", "SHORT", -1, 0, 0.0, 0.5)):
            assert ttf.build_quiet_hours_signal_msg(*args, now=now) == \
                jtf.build_quiet_hours_signal_msg(*args, now=now)


def _contexts():
    """Contexts reaching every branch of the explainer: (fields, row)."""
    base = dict(valid=True, regime_is_transitioning=False, regime_stable_since=0,
                timestamp=3600, market_regime=1, market_stress_score=0.1)
    feats = dict(valid=[True, True, True, True, True, False, True],
                 micro_regime=[1, 2, 2, 4, 3, 1, -1],
                 micro_transition=[-1, 4, 3, -1, 8, -1, -1])
    cases = [({**base, **over}, row) for row in range(7)
             for over in ({}, {"market_regime": 3})]
    for over in ({"valid": False}, {"regime_is_transitioning": True},
                 {"regime_stable_since": -1}, {"timestamp": 600}, {"market_regime": 4},
                 {"market_regime": 2}, {"market_regime": 0}, {"market_stress_score": 0.35}):
        cases.append(({**base, **over}, 0))
    return [(c, feats, row) for c, row in cases]


@pytest.mark.parametrize("case", range(len(_contexts())))
def test_long_autotrade_decision_matches_reference(case):
    ctx, feats, row = _contexts()[case]
    j = SimpleNamespace(**{k: np.asarray(v) for k, v in ctx.items()},
                        features=SimpleNamespace(**{k: np.asarray(v) for k, v in feats.items()}))
    # the same dtypes on both sides (a stress of exactly 0.35 sits on the gate)
    t = SimpleNamespace(**{k: torch.from_numpy(np.asarray(v)) for k, v in ctx.items()},
                        features=SimpleNamespace(**{k: torch.from_numpy(np.asarray(v))
                                                    for k, v in feats.items()}))
    assert trouting.long_autotrade_decision(t, row) == jrouting.long_autotrade_decision(j, row)


def test_labels_and_scalar_helpers_match_reference():
    for name in ("market_regime_label", "micro_regime_label", "market_transition_label",
                 "micro_transition_label"):
        jf, tf = getattr(jenums, name), getattr(tenums, name)
        codes = range(10 if "micro_transition" in name else 7 if "transition" in name else 5)
        assert [tf(c) for c in codes] == [jf(c) for c in codes], name
    for v in (-3.0, -1.0, -0.2, 0.0, 0.4, 1.0, 7.5):
        assert tutils.clamp(v) == jutils.clamp(v)
        assert tutils.clamp(v, 0.0, 1.0) == jutils.clamp(v, 0.0, 1.0)
        assert tutils.non_negative(v) == jutils.non_negative(v)
        for prev in (0.0, 2.0, -4.0):
            assert tutils.safe_pct(v, prev) == jutils.safe_pct(v, prev)
    for value in (1_780_272_000_123, 1.5e12, datetime(2026, 3, 29, 1, 30),
                  datetime(2026, 3, 29, 1, 30, tzinfo=UTC)):
        assert tutils.normalize_timestamp(value) == jutils.normalize_timestamp(value)
        assert tutils.timestamp_to_datetime(value) == jutils.timestamp_to_datetime(value)
    for value, spec in ((3.14159, ".2f"), ("n/a", ".2f"), (None, ".3f"), (2, ".1%")):
        assert tutils.safe_format(value, spec) == jutils.safe_format(value, spec)
