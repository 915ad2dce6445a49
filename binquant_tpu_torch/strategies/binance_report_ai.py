"""BinanceAIReport: features from Binance's per-token AI report (host side).

The port's own copy of ``binquant_tpu/strategies/binance_report_ai.py``:
the per-token AI-report JSON becomes a numeric feature dict, a directional
signal dict, social/community flags and a ternary verdict. No tensor is
involved and no tick calls it.

The implementation is table-driven:

* ``_LEXICON`` declares every keyword flag once: its feature name, its
  bias polarity (bull/bear/neutral), whether it is exported in the
  feature dict, and the phrases that raise it;
* :class:`ReportDigest` is the parsed intermediate (freshness, point
  counts, community posts, raised flags), produced by pure functions over
  the JSON;
* the bull and bear cases are each a tuple of named predicates; the
  signal dict, the fired test and the verdict all derive from them.

The network is injected (``fetch``), so tests and offline replay never
reach it; :func:`default_fetch` POSTs to the public endpoint.
"""

from __future__ import annotations

import time
from collections.abc import Callable
from dataclasses import dataclass, field
from math import tanh
from typing import Any

BINANCE_AI_ENDPOINT = (
    "https://www.binance.com/bapi/bigdata/v3/friendly/bigdata/search/ai-report/report"
)
# Simple heuristic for deriving a base token from a trading symbol.
QUOTE_ASSETS = ("USDT", "USDC", "BUSD", "TRY", "EUR", "BTC", "ETH")

DEFAULT_FRESH_MINUTES = 8 * 60


def base_asset_of(symbol: str) -> str:
    """Strip a known quote asset suffix: BTCUSDT -> BTC."""
    plain = symbol.replace("-", "").upper()
    for quote in QUOTE_ASSETS:
        if plain.endswith(quote) and len(plain) > len(quote):
            return plain[: -len(quote)]
    return plain


def default_fetch(symbol: str, token: str) -> dict | None:  # pragma: no cover
    """POST to the Binance AI-report endpoint; None on any failure."""
    import json
    import urllib.request

    body = {
        "lang": "en",
        "token": token,
        "symbol": symbol.upper(),
        "product": "web-spot",
        "timestamp": str(int(time.time() * 1000)),
        "translateToken": None,
    }
    try:
        request = urllib.request.Request(
            BINANCE_AI_ENDPOINT,
            data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"},
        )
        with urllib.request.urlopen(request, timeout=10) as resp:
            return json.loads(resp.read())
    except Exception:
        return None


# ---------------------------------------------------------------------------
# Lexicon: every keyword flag, declared once.
# polarity: +1 feeds bull support, -1 feeds bear pressure, 0 is contextual.
# exported: whether the flag appears in the feature dict (five of the nine
# are; the other four only feed the bias sum).
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class _Cue:
    name: str
    polarity: int
    exported: bool
    phrases: tuple[str, ...]


_LEXICON = (
    _Cue("macd_bullish_flag", +1, True, ("macd", "bullish crossover")),
    _Cue("price_resilience_flag", +1, False, ("resilience", "altcoins", "80-99%")),
    _Cue(
        "institutional_adoption_flag",
        +1,
        False,
        ("institutional", "adoption", "survey"),
    ),
    _Cue("ema_bearish_flag", -1, True, ("ema7", "ema25", "ema99", "bearish")),
    _Cue("outflow_flag", -1, False, ("net outflow", "outflow")),
    _Cue(
        "macro_headwind_flag", -1, False, ("geopolitical", "trade tensions", "tariff")
    ),
    _Cue("volatility_decreasing_flag", 0, True, ("decreasing volatility",)),
    _Cue(
        "coinbase_premium_weak_flag",
        0,
        True,
        ("premium gaps", "weak demand", "coinbase"),
    ),
    _Cue("sentiment_mixed_flag", 0, True, ("mixed sentiment", "mixed outlook")),
)

LARGE_DISCUSSION_POST_COUNT = 10


# ---------------------------------------------------------------------------
# Parsing: pure functions over the report JSON
# ---------------------------------------------------------------------------


def _report_original(report_json: dict) -> dict:
    data = report_json.get("data", {})
    if "report" in data:
        return data.get("report", {}).get("original", {})
    return data.get("original", {})


def _points_of(module: dict) -> list[dict]:
    return module.get("points", []) or []


def _corpus(modules: list[dict]) -> str:
    """All point contents + module overviews, lowercased for matching."""
    texts: list[str] = []
    for module in modules:
        texts.extend(p["content"] for p in _points_of(module) if p.get("content"))
        if module.get("overview"):
            texts.append(module["overview"])
    return " \n ".join(texts).lower()


def _post_citations(modules: list[dict]) -> int:
    posts = 0
    for module in modules:
        if module.get("type") != "community_sentiment":
            continue
        for point in _points_of(module):
            for ref in point.get("citationRefs", []) or []:
                if ref.get("type") == "post":
                    posts += int(ref.get("count", 0))
    return posts


def _point_total(modules: list[dict], module_type: str) -> int:
    return sum(
        len(_points_of(m)) for m in modules if m.get("type") == module_type
    )


@dataclass
class ReportDigest:
    """Parsed intermediate between the raw JSON and the feature dict."""

    age_minutes: float
    fresh: bool
    opportunity_points: int = 0
    risk_points: int = 0
    community_posts: int = 0
    flags: dict[str, int] = field(default_factory=dict)

    @property
    def net_bias(self) -> int:
        return sum(
            cue.polarity * self.flags.get(cue.name, 0) for cue in _LEXICON
        )


def digest_report(
    report_json: dict,
    *,
    now_ms: float,
    max_fresh_minutes: float = DEFAULT_FRESH_MINUTES,
) -> ReportDigest | None:
    original = _report_original(report_json)
    if not original:
        return None

    update_ms = int(original.get("reportMeta", {}).get("updateAt", 0))
    age_minutes = (now_ms - update_ms) / 60000.0 if update_ms else 1e9
    digest = ReportDigest(
        age_minutes=age_minutes, fresh=age_minutes <= max_fresh_minutes
    )
    if not digest.fresh:
        return digest

    modules = original.get("modules", []) or []
    digest.opportunity_points = _point_total(modules, "opportunities")
    digest.risk_points = _point_total(modules, "risks")
    digest.community_posts = _post_citations(modules)
    corpus = _corpus(modules)
    digest.flags = {
        cue.name: int(any(ph.lower() in corpus for ph in cue.phrases))
        for cue in _LEXICON
    }
    return digest


def digest_features(digest: ReportDigest, *, normalize: bool = True) -> dict:
    """The flat feature dict downstream consumers read."""
    features: dict[str, Any] = {
        "external_available": 1,
        "external_stale_flag": int(not digest.fresh),
        "external_age_minutes": round(digest.age_minutes, 2),
    }
    if not digest.fresh:
        return features

    opp, risk = digest.opportunity_points, digest.risk_points
    bias = digest.net_bias
    features.update(
        {
            "opp_count": opp,
            "risk_count": risk,
            "opp_risk_ratio": round((opp + 1) / (risk + 1), 4),
            "net_signal_score": opp - risk,
            "community_post_count": digest.community_posts,
            "large_discussion_flag": int(
                digest.community_posts >= LARGE_DISCUSSION_POST_COUNT
            ),
            "external_net_bias": bias,
            "external_bias_normalized": round(tanh(bias) if normalize else bias, 4),
        }
    )
    features.update(
        {cue.name: digest.flags.get(cue.name, 0) for cue in _LEXICON if cue.exported}
    )
    return features


# ---------------------------------------------------------------------------
# Signal derivation: the bull and bear cases as predicate tables
# ---------------------------------------------------------------------------

# Each entry: (feature key, predicate(features value, thresholds)).
# The bull case fires on strong positive bias, opportunity dominance, and a
# MACD cue; the bear case mirrors it with EMA weakness.
_BULL_CASE = (
    ("external_bias_normalized", lambda v, t: v > t.bias),
    ("opp_risk_ratio", lambda v, t: v > t.opp_risk),
    ("net_signal_score", lambda v, t: v > t.net),
    ("macd_bullish_flag", lambda v, t: v == 1),
)
_BEAR_CASE = (
    ("external_bias_normalized", lambda v, t: v < -t.bias),
    ("opp_risk_ratio", lambda v, t: v < 1),
    ("net_signal_score", lambda v, t: v < -t.net),
    ("ema_bearish_flag", lambda v, t: v == 1),
)

# Which fields land in the signal dict, and when. The ratio rides along
# whenever it exists so consumers always see the opportunity/risk balance.
_SIGNAL_EXPORTS = (
    ("external_bias_normalized", lambda v, t: v > t.bias or v < -t.bias),
    ("opp_risk_ratio", lambda v, t: bool(v)),
    ("net_signal_score", lambda v, t: v > t.net or v < -t.net),
    ("macd_bullish_flag", lambda v, t: v == 1),
    ("ema_bearish_flag", lambda v, t: v == 1),
)

# Social surface: (field, include-in-dict predicate, fires predicate).
_SOCIAL_EXPORTS = (
    ("large_discussion_flag", lambda v: v > 0, lambda v: v > 1),
    ("community_post_count", lambda v: v >= 2, lambda v: v > 1),
    ("sentiment_mixed_flag", lambda v: v > 0, lambda v: v > 1),
    ("coinbase_premium_weak_flag", lambda v: v > 1, lambda v: v > 1),
)

_FEATURE_DEFAULTS = {"opp_risk_ratio": 1}


@dataclass(frozen=True)
class Thresholds:
    bias: float = 0.5
    opp_risk: float = 1.2
    net: int = 1


def _case_votes(features: dict, case, thresholds: Thresholds) -> list[bool]:
    return [
        bool(check(features.get(name, _FEATURE_DEFAULTS.get(name, 0)), thresholds))
        for name, check in case
    ]


class BinanceAIReport:
    """Fetch, digest and derive, per symbol."""

    def __init__(
        self,
        symbol: str,
        base_asset: str = "",
        fetch: Callable[[str, str], dict | None] = default_fetch,
        now_ms: Callable[[], float] | None = None,
    ) -> None:
        self.symbol = symbol.replace("-", "")
        # callers that know the exchange's base asset pass it; otherwise
        # fall back to the quote-suffix heuristic
        self.base_asset = base_asset or base_asset_of(self.symbol)
        self._fetch = fetch
        self._now_ms = now_ms or (lambda: time.time() * 1000)

    def fetch_report(self) -> dict | None:
        if not self.base_asset:
            return None
        return self._fetch(self.symbol, self.base_asset)

    def extract_features(
        self, max_fresh_minutes: int = DEFAULT_FRESH_MINUTES, normalize: bool = True
    ) -> dict | None:
        report_json = self.fetch_report()
        if not report_json:
            return None
        digest = digest_report(
            report_json,
            now_ms=self._now_ms(),
            max_fresh_minutes=max_fresh_minutes,
        )
        if digest is None:
            return None
        return digest_features(digest, normalize=normalize)

    def ai_report_signal(
        self, bias_thr: float = 0.5, opp_risk_thr: float = 1.2, net_score_thr: int = 1
    ) -> dict | None:
        """The notable directional fields, or None when nothing is notable."""
        features = self.extract_features()
        if not features:
            return None
        thresholds = Thresholds(bias_thr, opp_risk_thr, net_score_thr)

        fired = any(_case_votes(features, _BULL_CASE, thresholds)) or any(
            _case_votes(features, _BEAR_CASE, thresholds)
        )
        if not fired:
            return None
        return {
            name: features.get(name, _FEATURE_DEFAULTS.get(name, 0))
            for name, include in _SIGNAL_EXPORTS
            if include(features.get(name, _FEATURE_DEFAULTS.get(name, 0)), thresholds)
        }

    def social_features_flag(self) -> dict | None:
        """Notable social/community context. Polarity is the caller's call:
        mixed sentiment and weak premium signal caution, not bullishness."""
        features = self.extract_features()
        if not features:
            return None
        fired = any(
            fires(features.get(name, 0)) for name, _, fires in _SOCIAL_EXPORTS
        )
        if not fired:
            return None
        return {
            name: features[name]
            for name, include, _ in _SOCIAL_EXPORTS
            if include(features.get(name, 0))
        }

    def final_report(
        self, bias_thr: float = 0.5, opp_risk_thr: float = 1.2, net_score_thr: int = 1
    ) -> int:
        """Ternary verdict: 1 when the whole bull case holds, -1 when the
        whole bear case holds, else 0."""
        features = self.extract_features()
        if not features or not features.get("external_available", 0):
            return 0
        thresholds = Thresholds(bias_thr, opp_risk_thr, net_score_thr)
        if all(_case_votes(features, _BULL_CASE, thresholds)):
            return 1
        if all(_case_votes(features, _BEAR_CASE, thresholds)):
            return -1
        return 0
