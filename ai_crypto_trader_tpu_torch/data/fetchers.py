"""Network data-source fetchers over an injectable transport.

The port's own copy of `ai_crypto_trader_tpu/data/fetchers.py:33-280`: the
fetch/pagination/parse logic of the reference's three network surfaces,
written against a transport seam so that it runs (and is tested) without
a network:

  * paginated Binance klines — `backtesting/data_manager.py:47-114`
    (1000/request, cursor = last row's open-time + 1 ms, 0.1 s pacing);
  * LunarCrush daily social timeseries — `backtesting/data_manager.py:116-172`
    (single call, 90-day API cap, bearer auth, timeSeries extraction);
  * news sources — `services/utils/news_analyzer.py:144-370`
    (CryptoPanic JSON, LunarCrush feeds JSON, CoinDesk / CoinTelegraph
    HTML scraping, URL-based dedup).

A transport is any async callable `(url, params, headers) -> Response`.
`UrllibTransport` is the real-network implementation; the tests inject
fake transports.  Every fetcher is pure parse/paginate logic — no config
reads, no env vars, no wall clock.  Host-side only: the candles become
tensors where the compute path starts.  `SocialDaily` is the class of
`data.ingest`, where the port defines it.
"""

from __future__ import annotations

import asyncio
import json
import re
from dataclasses import dataclass
from typing import Awaitable, Callable

import numpy as np

from ai_crypto_trader_tpu_torch.data.ingest import OHLCV, SocialDaily, klines_to_arrays
from ai_crypto_trader_tpu_torch.utils.symbols import base_asset

BINANCE_API = "https://api.binance.com/api/v3"
LUNARCRUSH_API = "https://lunarcrush.com/api/v4"
CRYPTOPANIC_API = "https://cryptopanic.com/api/v1/posts/"


@dataclass
class Response:
    status: int
    body: str = ""
    _json: object = None

    def json(self):
        if self._json is None:
            self._json = json.loads(self.body)
        return self._json


Transport = Callable[..., Awaitable[Response]]


class UrllibTransport:
    """Real-network transport (stdlib only)."""

    def __init__(self, timeout_s: float = 15.0):
        self.timeout_s = timeout_s

    async def __call__(self, url: str, params: dict | None = None,
                       headers: dict | None = None) -> Response:
        import urllib.parse
        import urllib.request

        if params:
            url = f"{url}?{urllib.parse.urlencode(params)}"
        req = urllib.request.Request(url, headers=headers or {})

        def fetch():
            import urllib.error

            try:
                with urllib.request.urlopen(req, timeout=self.timeout_s) as r:
                    return Response(r.status, r.read().decode())
            except urllib.error.HTTPError as e:
                # error statuses must surface as Response objects so the
                # fetchers' non-200 degradation branches run (urlopen
                # raises instead of returning on 4xx/5xx)
                return Response(e.code, e.read().decode(errors="replace"))

        return await asyncio.to_thread(fetch)


# --------------------------------------------------------------------------
# Binance klines (paginated)
# --------------------------------------------------------------------------

async def fetch_klines(transport: Transport, symbol: str, interval: str,
                       start_ms: int, end_ms: int, *, limit: int = 1000,
                       pace_s: float = 0.1,
                       sleep=asyncio.sleep) -> list[list]:
    """Paginated klines fetch (`data_manager.py:47-114` semantics): request
    `limit` rows from the cursor, append, advance cursor to last open-time
    + 1 ms, stop on an empty page or when the cursor passes `end_ms`.
    Raises on any non-200 (the reference raises and aborts the fetch)."""
    rows: list[list] = []
    cursor = int(start_ms)
    while cursor < end_ms:
        r = await transport(f"{BINANCE_API}/klines", params={
            "symbol": symbol, "interval": interval, "startTime": cursor,
            "endTime": int(end_ms), "limit": limit})
        if r.status != 200:
            raise RuntimeError(f"klines fetch failed: HTTP {r.status} "
                               f"{r.body[:200]}")
        page = r.json()
        if not page:
            break
        rows.extend(page)
        cursor = int(page[-1][0]) + 1
        await sleep(pace_s)              # reference's inter-page pacing
    return rows


async def fetch_klines_ohlcv(transport: Transport, symbol: str,
                             interval: str, start_ms: int, end_ms: int,
                             **kw) -> OHLCV:
    rows = await fetch_klines(transport, symbol, interval, start_ms, end_ms,
                              **kw)
    return klines_to_arrays(rows, symbol=symbol, interval=interval)


# --------------------------------------------------------------------------
# LunarCrush daily social metrics
# --------------------------------------------------------------------------

async def fetch_social_daily(transport: Transport, symbol: str,
                             start_s: int, end_s: int, *, api_key: str,
                             max_days: int = 90) -> SocialDaily:
    """Daily social timeseries (`data_manager.py:116-172`): one call, days
    capped at the API's 90, bearer auth, rows filtered to [start, end]."""
    base = _base_ticker(symbol)
    days = min(int((end_s - start_s) // 86_400) + 1, max_days)
    r = await transport(
        f"{LUNARCRUSH_API}/assets",
        params={"symbol": base, "interval": "1d", "days": days},
        headers={"Authorization": f"Bearer {api_key}",
                 "Accept": "application/json"})
    if r.status != 200:
        return SocialDaily(np.zeros(0, np.int64))
    data = r.json().get("data") or []
    series = data[0].get("timeSeries", []) if data else []
    rows = [row for row in series
            if start_s <= int(row.get("time", 0)) <= end_s]
    if not rows:
        return SocialDaily(np.zeros(0, np.int64))
    rows.sort(key=lambda row: int(row["time"]))
    ts = np.asarray([int(row["time"]) for row in rows], np.int64)
    numeric = {k for row in rows for k, v in row.items()
               if k != "time" and isinstance(v, (int, float))}
    cols = {k: np.asarray([float(row.get(k, np.nan)) for row in rows],
                          np.float32) for k in sorted(numeric)}
    return SocialDaily(ts, cols)


# --------------------------------------------------------------------------
# News sources
# --------------------------------------------------------------------------

def _base_ticker(symbol: str) -> str:
    return base_asset(symbol)


async def fetch_cryptopanic(transport: Transport, symbol: str, *,
                            api_key: str) -> list[dict]:
    """`news_analyzer.py:178-215`: posts API, important-news filter."""
    r = await transport(CRYPTOPANIC_API, params={
        "auth_token": api_key, "currencies": _base_ticker(symbol),
        "kind": "news", "public": "true", "filter": "important"})
    if r.status != 200:
        return []
    return [{"title": it.get("title", ""), "url": it.get("url", ""),
             "source": "CryptoPanic",
             "published_at": it.get("published_at", ""),
             "content": it.get("body", "")}
            for it in r.json().get("results", [])]


async def fetch_lunarcrush_news(transport: Transport, symbol: str, *,
                                api_key: str, limit: int = 10) -> list[dict]:
    """`news_analyzer.py:217-268`: feeds API, news source filter."""
    r = await transport(
        f"{LUNARCRUSH_API}/feeds",
        params={"symbol": _base_ticker(symbol), "limit": limit,
                "sources": "news"},
        headers={"Authorization": f"Bearer {api_key}"})
    if r.status != 200:
        return []
    return [{"title": it.get("title", ""), "url": it.get("url", ""),
             "source": "LunarCrush",
             "published_at": it.get("time", 0),
             "content": it.get("body", ""),
             "sentiment": it.get("sentiment", 0)}
            for it in r.json().get("data", [])]


_HTML_SOURCES = {
    # source -> (url builder, item regex with (?P<title>)/(?P<url>) groups,
    #            date regex, link base). Title and URL are captured by ONE
    #            structural regex so they can never be paired by unrelated
    #            index position (a bare href findall would sweep up every
    #            nav/header anchor on the page).
    "coindesk": (
        lambda t: f"https://www.coindesk.com/search?s={t}",
        r'<h4[^>]*class="[^"]*title[^"]*"[^>]*>(?P<title>[^<]+)</h4>'
        r'\s*<a[^>]*href="(?P<url>[^"]+)"',
        r'<time[^>]*datetime="([^"]+)"[^>]*>',
        "https://www.coindesk.com"),
    "cointelegraph": (
        lambda t: f"https://cointelegraph.com/tags/{t.lower()}",
        r'<a[^>]*class="[^"]*post-card__title-link[^"]*"[^>]*'
        r'href="(?P<url>[^"]+)"[^>]*>(?P<title>[^<]+)</a>',
        r'<time[^>]*datetime="([^"]+)"[^>]*>',
        "https://cointelegraph.com"),
}


async def fetch_html_news(transport: Transport, symbol: str, source: str,
                          *, max_items: int = 5) -> list[dict]:
    """CoinDesk / CoinTelegraph page scraping
    (`news_analyzer.py:270-370`: regex title/url/date extraction, first 5,
    relative links resolved against the site base)."""
    build_url, item_re, date_re, base = _HTML_SOURCES[source]
    r = await transport(build_url(_base_ticker(symbol)))
    if r.status != 200:
        return []
    matches = list(re.finditer(item_re, r.body))[:max_items]
    dates = re.findall(date_re, r.body)
    items = []
    for i, m in enumerate(matches):
        url = m.group("url")
        if not url.startswith("http"):
            url = f"{base}{url}"
        items.append({"title": m.group("title").strip(), "url": url,
                      "source": source.capitalize(),
                      "published_at": dates[i] if i < len(dates) else "",
                      "content": ""})
    return items


async def fetch_news(transport: Transport, symbol: str, *,
                     sources: list[str] | None = None,
                     api_keys: dict | None = None) -> list[dict]:
    """Fan out to all sources, tolerate per-source failures, dedup by URL
    (`news_analyzer.py:144-176`)."""
    sources = sources or ["cryptopanic", "lunarcrush", "coindesk",
                          "cointelegraph"]
    api_keys = api_keys or {}
    out: list[dict] = []
    for source in sources:
        try:
            if source == "cryptopanic":
                items = await fetch_cryptopanic(
                    transport, symbol, api_key=api_keys.get(source, ""))
            elif source == "lunarcrush":
                items = await fetch_lunarcrush_news(
                    transport, symbol, api_key=api_keys.get(source, ""))
            else:
                items = await fetch_html_news(transport, symbol, source)
        except Exception:                              # noqa: BLE001
            continue                       # per-source failures tolerated
        out.extend(items)
    seen: dict[str, dict] = {}
    for item in out:
        if item.get("url") and item["url"] not in seen:
            seen[item["url"]] = item
    return list(seen.values())
