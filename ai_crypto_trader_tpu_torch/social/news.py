"""News analysis: sentiment, entities, topics, summaries, market impact.

Capability parity with NewsAnalysisService + NewsAnalyzer
(`services/news_analysis_service.py`, `services/utils/news_analyzer.py`):
  * sentiment scoring (:409-501) — the VADER dependency is replaced by a
    built-in crypto-tuned lexicon with negation and intensifier handling
    (same output range: compound ∈ [-1, 1]); an optional transformers
    pipeline can be injected where available;
  * entity extraction (:502-560) — asset/ticker recognition over a symbol
    table + $TICKER / capitalized-name patterns;
  * topic extraction (:561-595) — keyword buckets (regulation, adoption,
    hacks, defi, etfs, macro, mining, stablecoins);
  * extractive summarization (:596-640) — frequency-scored sentences;
  * market-impact score (config.json:612-623) — relevance × recency ×
    sentiment-magnitude weighted blend.

Source fetching (CryptoPanic / RSS / LunarCrush, :144-370) is network I/O
and is injected: the analyzer consumes article dicts from any provider.

The port's own copy of `ai_crypto_trader_tpu/social/news.py`, host code:
the same lexicon, rules and bus keys, so the same articles give the same
analyses and the same published payloads.
"""

from __future__ import annotations

import math
import re
import time
from dataclasses import dataclass, field

POSITIVE = {
    "surge": 2.0, "rally": 2.0, "bullish": 2.5, "gain": 1.5, "gains": 1.5,
    "soar": 2.5, "soars": 2.5, "adoption": 1.5, "approval": 2.0,
    "approve": 2.0, "approved": 2.0, "partnership": 1.5, "upgrade": 1.5,
    "breakout": 1.5, "record": 1.5, "high": 1.0, "growth": 1.5,
    "institutional": 1.0, "etf": 1.0, "halving": 0.5, "moon": 2.0,
    "profit": 1.5, "win": 1.0, "success": 1.5, "launch": 1.0,
    "integration": 1.0, "support": 0.5, "recover": 1.5, "recovery": 1.5,
}
NEGATIVE = {
    "crash": -2.5, "plunge": -2.5, "plunges": -2.5, "bearish": -2.5,
    "dump": -2.0, "hack": -2.5, "hacked": -2.5, "exploit": -2.0,
    "scam": -2.5, "fraud": -2.5, "ban": -2.0, "banned": -2.0,
    "lawsuit": -1.5, "sec": -0.5, "crackdown": -2.0, "selloff": -2.0,
    "liquidation": -1.5, "liquidations": -1.5, "fear": -1.5, "fud": -1.5,
    "collapse": -2.5, "bankruptcy": -2.5, "insolvent": -2.5, "loss": -1.5,
    "losses": -1.5, "drop": -1.5, "drops": -1.5, "decline": -1.5,
    "warning": -1.0, "risk": -0.5, "delay": -1.0, "outage": -1.5,
}
NEGATORS = {"not", "no", "never", "without", "barely", "hardly"}
INTENSIFIERS = {"very": 1.5, "extremely": 2.0, "massive": 1.8, "huge": 1.6,
                "slightly": 0.5, "somewhat": 0.7}

KNOWN_ASSETS = {
    "bitcoin": "BTC", "btc": "BTC", "ethereum": "ETH", "eth": "ETH",
    "solana": "SOL", "sol": "SOL", "ripple": "XRP", "xrp": "XRP",
    "dogecoin": "DOGE", "doge": "DOGE", "cardano": "ADA", "ada": "ADA",
    "binance": "BNB", "bnb": "BNB", "polygon": "MATIC", "matic": "MATIC",
    "avalanche": "AVAX", "avax": "AVAX", "chainlink": "LINK", "link": "LINK",
    "litecoin": "LTC", "ltc": "LTC", "polkadot": "DOT", "dot": "DOT",
}

TOPIC_KEYWORDS = {
    "regulation": {"sec", "regulation", "regulatory", "ban", "lawsuit",
                   "compliance", "crackdown", "license"},
    "adoption": {"adoption", "partnership", "integration", "institutional",
                 "payment", "merchant"},
    "security": {"hack", "hacked", "exploit", "breach", "scam", "fraud",
                 "vulnerability", "stolen"},
    "defi": {"defi", "liquidity", "yield", "staking", "protocol", "dex"},
    "etf": {"etf", "fund", "blackrock", "fidelity", "approval"},
    "macro": {"fed", "inflation", "rates", "recession", "dollar", "cpi"},
    "mining": {"mining", "miner", "miners", "hashrate", "halving"},
    "stablecoins": {"stablecoin", "usdt", "usdc", "tether", "peg", "depeg"},
}

_WORD = re.compile(r"[a-z$][a-z0-9$]*")


def _direction(compound: float) -> str:
    """Single source of truth for the ±0.05 direction thresholds (used for
    both per-article and aggregate direction)."""
    return ("bullish" if compound > 0.05 else
            "bearish" if compound < -0.05 else "neutral")


def lexicon_sentiment(text: str) -> dict:
    """Compound ∈ [-1,1] + pos/neg/neu fractions — VADER-shaped output
    (`news_analyzer.py:409-501`)."""
    words = _WORD.findall(text.lower())
    score, pos_n, neg_n = 0.0, 0, 0
    for i, w in enumerate(words):
        val = POSITIVE.get(w, 0.0) + NEGATIVE.get(w, 0.0)
        if val == 0.0:
            continue
        mult = 1.0
        window = words[max(i - 2, 0): i]
        if any(x in NEGATORS for x in window):
            mult = -0.8
        for x in window:
            mult *= INTENSIFIERS.get(x, 1.0)
        val *= mult
        score += val
        if val > 0:
            pos_n += 1
        elif val < 0:
            neg_n += 1
    n = max(len(words), 1)
    compound = math.tanh(score / 4.0)
    return {"compound": compound, "pos": pos_n / n, "neg": neg_n / n,
            "neu": 1.0 - (pos_n + neg_n) / n}


def extract_entities(text: str) -> list[str]:
    """Asset mentions: known names/tickers + $TICKER patterns
    (`news_analyzer.py:502-560`)."""
    found = []
    lower = text.lower()
    for name, ticker in KNOWN_ASSETS.items():
        if re.search(rf"\b{re.escape(name)}\b", lower) and ticker not in found:
            found.append(ticker)
    for m in re.findall(r"\$([A-Z]{2,6})\b", text):
        if m not in found:
            found.append(m)
    return found


def extract_topics(text: str) -> list[str]:
    words = set(_WORD.findall(text.lower()))
    return [topic for topic, kws in TOPIC_KEYWORDS.items() if words & kws]


def summarize(text: str, max_sentences: int = 2) -> str:
    """Extractive summary: sentences ranked by normalized word-frequency
    score (`news_analyzer.py:596-640`)."""
    sentences = re.split(r"(?<=[.!?])\s+", text.strip())
    if len(sentences) <= max_sentences:
        return text.strip()
    freqs: dict[str, int] = {}
    for w in _WORD.findall(text.lower()):
        if len(w) > 3:
            freqs[w] = freqs.get(w, 0) + 1
    def score(s):
        ws = [w for w in _WORD.findall(s.lower()) if len(w) > 3]
        return sum(freqs.get(w, 0) for w in ws) / max(len(ws), 1)
    ranked = sorted(range(len(sentences)), key=lambda i: -score(sentences[i]))
    keep = sorted(ranked[:max_sentences])
    return " ".join(sentences[i] for i in keep)


@dataclass
class NewsAnalyzer:
    """Analyze article dicts {'title', 'body'?, 'published_at'?, 'source'?}."""

    relevance_weight: float = 0.4     # config.json:612-623 blend
    recency_weight: float = 0.3
    sentiment_weight: float = 0.3
    recency_half_life_h: float = 12.0
    now_fn: any = time.time
    transformer_pipeline: any = None  # optional injected HF pipeline

    def analyze_article(self, article: dict, symbol_asset: str | None = None) -> dict:
        text = " ".join(filter(None, [article.get("title", ""),
                                      article.get("body", "")]))
        if self.transformer_pipeline is not None:
            out = self.transformer_pipeline(text[:512])[0]
            sign = {"POS": 1, "NEU": 0, "NEG": -1}.get(out["label"][:3].upper(), 0)
            sent = {"compound": sign * float(out["score"]),
                    "pos": 0.0, "neg": 0.0, "neu": 1.0}
        else:
            sent = lexicon_sentiment(text)
        entities = extract_entities(text)
        topics = extract_topics(text)

        relevance = 1.0 if (symbol_asset and symbol_asset in entities) else \
            (0.5 if entities else 0.2)
        age_h = max((self.now_fn() - article.get("published_at", self.now_fn()))
                    / 3600.0, 0.0)
        recency = 0.5 ** (age_h / self.recency_half_life_h)
        impact = (self.relevance_weight * relevance
                  + self.recency_weight * recency
                  + self.sentiment_weight * abs(sent["compound"]))
        return {
            "sentiment": sent, "entities": entities, "topics": topics,
            "summary": summarize(text), "relevance": relevance,
            "recency": recency, "market_impact": impact,
            "direction": _direction(sent["compound"]),
        }

    def aggregate(self, articles: list[dict], symbol_asset: str | None = None) -> dict:
        """Impact-weighted aggregate sentiment for a symbol — the shape the
        analyzer service publishes per symbol."""
        if not articles:
            return {"sentiment": 0.0, "n_articles": 0, "top_topics": [],
                    "market_impact": 0.0, "direction": "neutral"}
        analyses = [self.analyze_article(a, symbol_asset) for a in articles]
        weights = [a["market_impact"] for a in analyses]
        total_w = sum(weights) or 1.0
        sentiment = sum(a["sentiment"]["compound"] * w
                        for a, w in zip(analyses, weights)) / total_w
        topic_counts: dict[str, int] = {}
        for a in analyses:
            for t in a["topics"]:
                topic_counts[t] = topic_counts.get(t, 0) + 1
        return {
            "sentiment": sentiment,
            "n_articles": len(articles),
            "top_topics": sorted(topic_counts, key=topic_counts.get,
                                 reverse=True)[:3],
            "market_impact": max(weights),
            "direction": _direction(sentiment),
            "analyses": analyses,
        }


# ---------------------------------------------------------------------------
# Bus-facing service (NewsAnalysisService parity)
# ---------------------------------------------------------------------------

def deterministic_news_provider(bus, symbol: str) -> list[dict]:
    """Offline stand-in source: synthesizes headline dicts from recent price
    action on the bus, so the full analyze→publish pipeline runs without the
    reference's CryptoPanic/RSS network fetchers
    (`services/news_analysis_service.py:144-370` — source I/O is the
    injected boundary, exactly like the social provider)."""
    md = bus.get(f"market_data_{symbol}")
    if not md:
        return []
    from ai_crypto_trader_tpu_torch.utils.symbols import base_asset

    asset = base_asset(symbol)
    names: dict[str, str] = {}
    for k, v in KNOWN_ASSETS.items():    # first alias is the full name
        names.setdefault(v, k)
    name = names.get(asset, asset).capitalize()
    chg = float(md.get("price_change_15m", 0.0))
    price = float(md.get("current_price", 0.0))
    ts = float(md.get("timestamp", 0.0))
    if chg >= 1.0:
        title = f"{name} surges {chg:.1f}% as momentum builds"
    elif chg >= 0.2:
        title = f"{name} posts steady gains amid growing adoption"
    elif chg <= -1.0:
        title = f"{name} drops {abs(chg):.1f}% in sudden selloff"
    elif chg <= -0.2:
        title = f"{name} declines as traders book profit"
    else:
        title = f"{name} trades flat near {price:,.0f}"
    return [{"title": title,
             "body": f"{name} ({asset}) moved {chg:+.2f}% over the last 15 "
                     f"minutes to {price:,.2f}.",
             "published_at": ts, "source": "synthetic"}]


@dataclass
class NewsService:
    """News analysis as a launcher cadence service.

    Capability parity with NewsAnalysisService's polling loop
    (`services/news_analysis_service.py:98-143`: fetch per symbol on an
    interval, analyze, publish to Redis for the dashboard's news panel and
    the AI analyzer's context): polls the injected article provider,
    aggregates with NewsAnalyzer, and publishes

      news_analysis_{symbol}   impact-weighted aggregate (the key
                               shell/analyzer.py already consumes)
      news_recent_{symbol}     bounded per-article feed for the dashboard
      news_updates             pub/sub channel (reference dashboard.py:91-99
                               subscribes its news channel the same way)
    """

    bus: any
    symbols: list[str] = field(default_factory=lambda: ["BTCUSDC"])
    provider: any = None                 # callable(bus, symbol) -> articles
    poll_interval_s: float = 600.0
    history_len: int = 50
    now_fn: any = time.time
    name: str = "news"
    _last: dict = field(default_factory=dict)

    async def run_once(self) -> dict:
        from ai_crypto_trader_tpu_torch.utils.symbols import base_asset

        provider = self.provider or deterministic_news_provider
        analyzer = NewsAnalyzer(now_fn=self.now_fn)
        published = 0
        now = self.now_fn()
        for symbol in self.symbols:
            if now - self._last.get(symbol, -1e18) < self.poll_interval_s:
                continue
            # burn the poll slot BEFORE the empty-fetch continue: an empty
            # provider response must still respect poll_interval_s instead
            # of re-polling (and re-billing the upstream) every tick
            self._last[symbol] = now
            articles = provider(self.bus, symbol)
            if not articles:
                continue
            agg = analyzer.aggregate(articles, base_asset(symbol))
            analyses = agg.pop("analyses", [])
            agg.update({"symbol": symbol, "timestamp": now})
            recent = self.bus.get(f"news_recent_{symbol}") or []
            # dedup against the whole retained window, not just the tail:
            # a provider that re-serves a BATCH of headlines would pass a
            # tail-only check for every entry but the last one.  Articles
            # without a published_at (optional field) can't key on the
            # stored poll-time default (every re-serve would look fresh) —
            # they dedup on title, but only against the last batch-width of
            # entries: a re-served batch is caught, while a recurring
            # headline (a daily wrap) re-enters once the feed has moved on.
            seen = {(e.get("title"), e.get("published_at")) for e in recent}
            seen_titles = {e.get("title") for e in recent[-len(articles):]}
            for article, analysis in zip(articles, analyses):
                raw_pub = article.get("published_at")
                entry = {
                    "title": article.get("title", ""),
                    "source": article.get("source", ""),
                    "published_at": now if raw_pub is None else raw_pub,
                    "direction": analysis["direction"],
                    "sentiment": analysis["sentiment"]["compound"],
                    "market_impact": analysis["market_impact"],
                    "topics": analysis["topics"],
                }
                if (raw_pub is None and entry["title"] in seen_titles) or \
                        (entry["title"], raw_pub) in seen:
                    continue
                seen.add((entry["title"], entry["published_at"]))
                seen_titles.add(entry["title"])
                recent.append(entry)
            self.bus.set(f"news_analysis_{symbol}", agg)
            self.bus.set(f"news_recent_{symbol}", recent[-self.history_len:])
            await self.bus.publish("news_updates", agg)
            published += 1
        return {"published": published}
