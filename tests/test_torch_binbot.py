"""The binbot REST client and its stub backend: the port against the
reference.

One scripted session (a queue of responses and transport errors) and one
seeded ``random.Random`` drive both packages' ``BinbotApi`` through the same
calls. Per case the two must agree on: the payload returned or the error
raised (type and message), the requests the session saw, the jittered
backoff before each retry (``time.sleep`` is recorded, not slept), the
request and retry counters, and the ``binbot_retry_exhausted`` events.
Cases: a 5xx that recovers within the retry budget, transport errors that
exhaust it, a 4xx and an ``{"error": 1}`` body (never retried), a 5xx
without retries (no exhaustion event), and the typed endpoints
(``get_symbols``, the settings, ``edit_symbol``, ``get_market_breadth``).
``StubSession``'s scripted breadth schedule (its ``"error"`` entry a
stalled upstream) gives both engines the same series bucket by bucket, the
previous one kept through the stall.
"""

from __future__ import annotations

import asyncio
import dataclasses
import json
import random

import pytest
import torch

import binquant_tpu.obs.events as jevents
from binquant_tpu.io import binbot as jbinbot
from binquant_tpu.io import replay as jreplay
from binquant_tpu.obs import instruments as jinst
from binquant_tpu_torch.io import binbot as tbinbot
from binquant_tpu_torch.io import replay as treplay
from binquant_tpu_torch.obs import instruments as tinst

torch.set_num_threads(1)


class _Resp:
    def __init__(self, payload, status_code=200):
        self._payload = payload
        self.status_code = status_code
        self.text = json.dumps(payload)

    def json(self):
        return self._payload


class ScriptedSession:
    """Answers each request with the next scripted item: a (status,
    payload) pair, or an exception instance to raise."""

    def __init__(self, script):
        self.script = list(script)
        self.calls = []

    def request(self, method, url, **kwargs):
        self.calls.append((method, url, json.dumps(kwargs, sort_keys=True, default=str)))
        item = self.script.pop(0)
        if isinstance(item, Exception):
            raise item
        status, payload = item
        return _Resp(payload, status)


class Recorder:
    def __init__(self):
        self.events = []

    def emit(self, event, **fields):
        self.events.append((event, fields))


@pytest.fixture
def sleeps(monkeypatch):
    slept = []
    monkeypatch.setattr(jbinbot.time, "sleep", slept.append)
    return slept


def _counts(inst) -> dict:
    fams = (inst.BINBOT_REQUESTS, inst.BINBOT_RETRIES)
    return {
        (fam.name, key): child.value
        for fam in fams for key, child in sorted(fam._children.items())
    }


def _delta(before: dict, after: dict) -> dict:
    return {k: v - before.get(k, 0.0) for k, v in after.items() if v != before.get(k, 0.0)}


def _run(pkg, inst, script, call, retry_max, monkeypatch, sleeps):
    rec = Recorder()
    if pkg is jbinbot:
        monkeypatch.setattr(jevents, "get_event_log", lambda: rec)
    else:
        monkeypatch.setattr(tbinbot, "get_event_log", lambda: rec)
    session = ScriptedSession(script)
    api = pkg.BinbotApi("http://fake/", session=session, retry_max=retry_max,
                        retry_backoff_s=0.2, rng=random.Random(11))
    before = _counts(inst)
    sleeps.clear()
    try:
        out = ("ok", call(api))
    except Exception as exc:  # noqa: BLE001 — the error IS the result compared
        out = ("raised", type(exc).__name__, str(exc))
    return {
        "out": out, "calls": session.calls, "sleeps": list(sleeps),
        "counts": _delta(before, _counts(inst)), "events": rec.events,
    }


def _model(x):
    if hasattr(x, "model_dump"):
        return x.model_dump()
    if isinstance(x, list):
        return [_model(v) for v in x]
    return x


CASES = {
    "5xx_then_ok": ([(502, {"x": 1}), (503, {}), (200, {"data": {"amount": 7.5}})],
                    lambda api: api.get_available_fiat("binance"), 2),
    "transport_exhausted": ([ConnectionError("down")] * 3,
                            lambda api: api.get_active_pairs(), 2),
    "4xx_not_retried": ([(404, {"detail": "no"})], lambda api: api.filter_excluded_symbols(), 2),
    "error_body": ([(200, {"error": 1, "message": "rejected"})],
                   lambda api: api.create_bot({"pair": "X"}), 2),
    "5xx_no_retry": ([(500, {"detail": "boom"})], lambda api: api.get_active_grid_ladders(), 0),
    "5xx_exhausted": ([(500, {})] * 4, lambda api: api.edit_symbol("AUSDT", futures_leverage=2), 3),
    "symbols": ([(200, {"data": [{"id": "AUSDT", "futures_leverage": "2"},
                                 {"id": "BUSDT", "extra": 1}]})],
                lambda api: _model(api.get_symbols()), 0),
    "settings": ([(200, {"data": {"autotrade": True, "market_type": "FUTURES",
                                  "grid_allocation_pct": None}}),
                  (200, {"data": {"autotrade": False}})],
                 lambda api: [_model(api.get_autotrade_settings()),
                              _model(api.get_test_autotrade_settings())], 0),
    "breadth": ([(200, {"data": {"timestamp": [1, 2], "market_breadth": [0.1, None],
                                 "market_breadth_ma": [0.2, 0.3]}})],
                lambda api: asyncio.run(api.get_market_breadth()), 0),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_client_matches_reference(case, monkeypatch, sleeps):
    script, call, retry_max = CASES[case]
    j = _run(jbinbot, jinst, script, call, retry_max, monkeypatch, sleeps)
    t = _run(tbinbot, tinst, script, call, retry_max, monkeypatch, sleeps)
    if case == "breadth":
        jb, tb = j.pop("out")[1], t.pop("out")[1]
        for f in dataclasses.fields(tb):
            assert getattr(tb, f.name) == getattr(jb, f.name), f.name
    if case == "settings":
        # the reference's pydantic models serialize the enum by value too
        assert j["out"][1][0]["market_type"] == t["out"][1][0]["market_type"] == "FUTURES"
    assert t == j
    if case.endswith("exhausted"):
        assert t["events"] and t["events"][0][0] == "binbot_retry_exhausted"
        assert len(t["sleeps"]) == retry_max and all(d > 0 for d in t["sleeps"])


def test_stub_breadth_schedule_feeds_both_engines():
    schedule = {"schedule": [
        {"timestamp": [1, 2], "market_breadth": [0.3, 0.35], "market_breadth_ma": [0.3, 0.31]},
        "error",
        {"timestamp": [2, 3], "market_breadth": [0.35, 0.2], "market_breadth_ma": [0.31, 0.29]},
    ]}
    j = jreplay.make_stub_engine(capacity=8, window=130, breadth=schedule)
    t = treplay.make_stub_engine(capacity=8, window=130, breadth=schedule, device="cpu",
                                 fanout=False)
    seen = []

    async def go():
        for bucket in range(4):
            await j._refresh_market_breadth(bucket)
            await t._refresh_market_breadth(bucket)
            seen.append((j.market_breadth.market_breadth, t.market_breadth.market_breadth))

    asyncio.run(go())
    assert [a for a, _ in seen] == [b for _, b in seen] == [
        [0.3, 0.35], [0.3, 0.35], [0.35, 0.2], [0.35, 0.2],
    ]
    # the same requests reached each stub backend
    assert j.binbot_api.session.requests == t.binbot_api.session.requests
