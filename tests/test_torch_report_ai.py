"""BinanceAIReport in the port against the reference, on the same report
JSONs: the feature dict, the signal dict, the social flags and the verdict
are equal for each case of ``tests/test_strategies_dormant.py``'s
``TestBinanceAIReport`` (mirrored here, with the expected values it pins)
and for a bearish report, a mixed one, a report without its ``report``
wrapper, one without ``updateAt`` and one without modules. The clock is
injected, so both packages read one ``now``; nothing reaches the network.
"""

from __future__ import annotations

import pytest

from binquant_tpu.strategies import binance_report_ai as jai
from binquant_tpu_torch.strategies import binance_report_ai as tai

NOW_MS = 1_760_000_000_000.0


def _report(texts, opp=3, risk=1, update_age_min=10, posts=12, wrap=True, overview=None,
            risk_texts=()):
    risks = list(risk_texts) + ["risk"] * (risk - len(risk_texts))
    modules = [
        {"type": "opportunities", "points": [{"content": t} for t in texts[:opp]]},
        {"type": "risks", "points": [{"content": t} for t in risks]},
        {
            "type": "community_sentiment",
            "points": [
                {"content": "chatter", "citationRefs": [{"type": "post", "count": posts}]}
            ],
        },
    ]
    if overview is not None:
        modules.append({"type": "summary", "overview": overview, "points": None})
    original = {
        "reportMeta": {"updateAt": int(NOW_MS - update_age_min * 60000)},
        "modules": modules,
    }
    return {"data": {"report": {"original": original}} if wrap else {"original": original}}


CASES = {
    "bullish": _report(
        ["macd bullish crossover", "institutional adoption rising", "strong resilience"],
        opp=3, risk=0),
    "stale": _report(["macd"], update_age_min=10_000),
    "unavailable": None,
    "bearish": _report([], opp=0, risk=4, posts=1,
                       risk_texts=("EMA7 below EMA25, bearish", "net outflow", "tariff")),
    "mixed": _report(["mixed sentiment on premium gaps", "coinbase weak demand",
                      "decreasing volatility"], opp=2, risk=2, posts=2,
                     overview="Tariff and geopolitical trade tensions"),
    "unwrapped": _report(["macd"], wrap=False),
    "no_update": {"data": {"report": {"original": {"modules": []}}}},
    "empty": {"data": {}},
}


def _pair(report):
    def fetch(symbol, token):
        assert (symbol, token) == ("BTCUSDT", "BTC")
        return report

    clock = lambda: NOW_MS  # noqa: E731
    return (jai.BinanceAIReport("BTC-USDT", fetch=fetch, now_ms=clock),
            tai.BinanceAIReport("BTC-USDT", fetch=fetch, now_ms=clock))


@pytest.mark.parametrize("case", sorted(CASES))
def test_both_packages_derive_the_same_report(case):
    ref, port = _pair(CASES[case])
    assert port.base_asset == ref.base_asset == "BTC"
    assert port.extract_features() == ref.extract_features()
    assert port.extract_features(max_fresh_minutes=5, normalize=False) == (
        ref.extract_features(max_fresh_minutes=5, normalize=False))
    assert port.ai_report_signal() == ref.ai_report_signal()
    assert port.ai_report_signal(0.9, 2.0, 3) == ref.ai_report_signal(0.9, 2.0, 3)
    assert port.social_features_flag() == ref.social_features_flag()
    assert port.final_report() == ref.final_report()


def test_bullish_final_report():
    _, ai = _pair(CASES["bullish"])
    feats = ai.extract_features()
    assert feats["macd_bullish_flag"] == 1
    assert feats["net_signal_score"] == 3
    assert feats["large_discussion_flag"] == 1
    assert ai.final_report() == 1
    assert ai.ai_report_signal() is not None


def test_stale_report_only_base_fields():
    _, ai = _pair(CASES["stale"])
    feats = ai.extract_features()
    assert feats["external_stale_flag"] == 1
    assert "opp_count" not in feats
    assert ai.final_report() == 0


def test_unavailable():
    _, ai = _pair(None)
    assert ai.extract_features() is None
    assert ai.final_report() == 0


def test_bearish_verdict_and_the_pure_functions():
    _, ai = _pair(CASES["bearish"])
    assert ai.final_report() == -1
    digest = tai.digest_report(CASES["bearish"], now_ms=NOW_MS)
    ref = jai.digest_report(CASES["bearish"], now_ms=NOW_MS)
    assert (digest.flags, digest.net_bias, digest.risk_points) == (
        ref.flags, ref.net_bias, ref.risk_points)
    assert tai.digest_features(digest) == jai.digest_features(ref)
    for symbol in ("ETHUSDT", "ETH-BTC", "USDT", "btctry", "SOLEUR", "PEPE"):
        assert tai.base_asset_of(symbol) == jai.base_asset_of(symbol), symbol
    assert tai.BINANCE_AI_ENDPOINT == jai.BINANCE_AI_ENDPOINT
