"""The port's network fetchers (data/fetchers.py) against the JAX package's,
on the CPU, over the same fake transports: nothing touches the network.

The same replies give the same requests (URL, params, headers), the same
rows, `OHLCV` arrays, `SocialDaily` columns and news lists, and the same
error branches.  `UrllibTransport`'s `HTTPError` branch is driven with
`urlopen` monkeypatched.  The port's `SocialDaily` is `data.ingest`'s
class, not a second one.  `cli fetch` writes the same CSV bytes as the JAX
CLI's, synthetic and (over a fake transport) from Binance's pages.
"""

import asyncio
import io
import json
import urllib.error
import urllib.request

import numpy as np
import pytest

from ai_crypto_trader_tpu.data import fetchers as jf
from ai_crypto_trader_tpu_torch.data import fetchers as tf
from ai_crypto_trader_tpu_torch.data import ingest as tingest


def kline_row(t_ms, price=100.0):
    return [t_ms, price, price + 1, price - 1, price + 0.5, 10.0,
            t_ms + 59_999, 1000.0, 5, 5.0, 500.0, 0]


class PagedKlines:
    """Binance-like pages of minute candles [0, n_total); each package's
    transport builds its own package's `Response`."""

    def __init__(self, response, n_total, page_limit=1000, fail_at_page=None):
        self.response, self.n_total = response, n_total
        self.page_limit, self.fail_at_page = page_limit, fail_at_page
        self.requests = []

    async def __call__(self, url, params=None, headers=None):
        self.requests.append((url, dict(params or {}), headers))
        if self.fail_at_page is not None and len(self.requests) == self.fail_at_page:
            return self.response(500, "oops " * 100)
        start = -(-max(int(params["startTime"]), 0) // 60_000)
        limit = min(int(params["limit"]), self.page_limit)
        rows = [kline_row(i * 60_000, 100 + 0.01 * i)
                for i in range(start, min(start + limit, self.n_total))
                if i * 60_000 <= int(params["endTime"])]
        return self.response(200, json.dumps(rows))


class Replay:
    """One canned reply (or a URL router) for every call, recording them."""

    def __init__(self, response, status=200, payload=None, body="", route=None):
        self.response, self.status = response, status
        self.body = json.dumps(payload) if payload is not None else body
        self.route = route
        self.calls = []

    async def __call__(self, url, params=None, headers=None):
        self.calls.append((url, params, headers))
        if self.route is not None:
            return self.route(self.response, url)
        return self.response(self.status, self.body)


async def _no_sleep(_):
    return None


def _both(make, run):
    """``run(module, transport)`` for each package over its own transport;
    (JAX result, port result, JAX transport, port transport)."""
    jt, tt = make(jf.Response), make(tf.Response)
    return asyncio.run(run(jf, jt)), asyncio.run(run(tf, tt)), jt, tt


@pytest.mark.parametrize("n_total,end", [(2500, 2500 * 60_000), (150, 10**12), (0, 10**6)])
def test_paginated_klines_match(n_total, end):
    ref, got, jt, tt = _both(
        lambda r: PagedKlines(r, n_total),
        lambda m, t: m.fetch_klines(t, "BTCUSDC", "1m", 0, end, pace_s=0, sleep=_no_sleep))
    assert got == ref and tt.requests == jt.requests
    ref, got, _, _ = _both(
        lambda r: PagedKlines(r, n_total),
        lambda m, t: m.fetch_klines_ohlcv(t, "ETHUSDC", "1m", 0, end, pace_s=0,
                                          sleep=_no_sleep) if n_total else _empty())
    if n_total:
        for f in ("timestamp", "open", "high", "low", "close", "volume"):
            a, b = getattr(got, f), getattr(ref, f)
            assert a.dtype == b.dtype and np.array_equal(a, b), f
        assert (got.symbol, got.interval) == (ref.symbol, ref.interval)


async def _empty():
    return None


def test_klines_http_error_raises_the_same():
    errs = []
    for m in (jf, tf):
        t = PagedKlines(m.Response, 2500, fail_at_page=2)
        with pytest.raises(RuntimeError) as ex:
            asyncio.run(m.fetch_klines(t, "BTCUSDC", "1m", 0, 2500 * 60_000, pace_s=0,
                                       sleep=_no_sleep))
        errs.append((str(ex.value), t.requests))
    assert errs[0] == errs[1] and "HTTP 500" in errs[1][0]


LUNARCRUSH = {"data": [{"symbol": "BTC", "timeSeries": [
    {"time": 86_400 * d, "galaxy_score": 60 + d, "social_volume": 1000 * d,
     "sentiment": 3.5, "name": "ignored-non-numeric", **({"alt_rank": d} if d % 2 else {})}
    for d in (4, 1, 3, 7, 2, 9, 5, 10, 6, 8)]}]}


@pytest.mark.parametrize("case", ["range", "cap", "http_error", "no_data", "empty_range"])
def test_social_daily_match(case):
    status, payload, start, end = 200, LUNARCRUSH, 86_400 * 3, 86_400 * 7
    if case == "cap":
        start, end = 0, 86_400 * 400
    elif case == "http_error":
        status = 503
    elif case == "no_data":
        payload = {"data": []}
    elif case == "empty_range":
        start, end = 86_400 * 50, 86_400 * 60
    ref, got, jt, tt = _both(
        lambda r: Replay(r, status, payload),
        lambda m, t: m.fetch_social_daily(t, "BTCUSDC", start, end, api_key="k"))
    assert tt.calls == jt.calls
    assert type(got) is tingest.SocialDaily
    assert got.timestamp.dtype == ref.timestamp.dtype
    assert np.array_equal(got.timestamp, ref.timestamp)
    assert list(got.columns) == list(ref.columns)
    for k in ref.columns:
        a, b = got.columns[k], ref.columns[k]
        assert a.dtype == b.dtype and np.array_equal(a, b, equal_nan=True), k


def test_social_daily_is_the_ingest_class():
    assert tf.SocialDaily is tingest.SocialDaily


COINDESK_HTML = """
<nav><a href="/home">home</a></nav>
<div><h4 class="heading title">Bitcoin rallies</h4>
<a href="/markets/2026/btc-rallies">x</a>
<time datetime="2026-07-01T10:00:00Z"></time></div>
<div><h4 class="card title">ETF inflows grow</h4>
<a href="https://www.coindesk.com/policy/etf-inflows">x</a></div>
""" + "".join(f'<div><h4 class="t title">Story {i}</h4>\n<a href="/s/{i}">x</a></div>'
              for i in range(6))

COINTELEGRAPH_HTML = (
    '<a class="post-card__title-link" href="/news/eth-up">ETH up </a>'
    '<time datetime="2026-07-03"></time>'
    '<a class="x post-card__title-link y" href="https://cointelegraph.com/news/b">B</a>')

CRYPTOPANIC = {"results": [
    {"title": "Bitcoin rallies", "url": "https://news/a", "published_at": "2026-07-01",
     "body": "up"},
    {"title": "Dup story", "url": "https://news/a", "published_at": "2026-07-01"},
    {"url": "https://news/b"}]}

LUNAR_FEEDS = {"data": [{"title": "Feed", "url": "https://news/c", "time": 7, "body": "b",
                         "sentiment": 4}, {"title": "No url"}]}


@pytest.mark.parametrize("source,status,body", [
    ("cryptopanic", 200, json.dumps(CRYPTOPANIC)), ("cryptopanic", 401, ""),
    ("lunarcrush", 200, json.dumps(LUNAR_FEEDS)), ("lunarcrush", 500, ""),
    ("coindesk", 200, COINDESK_HTML), ("coindesk", 404, ""),
    ("cointelegraph", 200, COINTELEGRAPH_HTML)])
def test_news_sources_match(source, status, body):
    def run(m, t):
        if source == "cryptopanic":
            return m.fetch_cryptopanic(t, "ETHUSDC", api_key="k")
        if source == "lunarcrush":
            return m.fetch_lunarcrush_news(t, "ETHUSDC", api_key="k", limit=3)
        return m.fetch_html_news(t, "ETHUSDC", source)

    ref, got, jt, tt = _both(lambda r: Replay(r, status, body=body), run)
    assert got == ref and tt.calls == jt.calls
    if status == 200:
        assert got


def test_fetch_news_fans_out_and_dedups_the_same():
    def route(response, url):
        if "cryptopanic" in url:
            return response(200, json.dumps(CRYPTOPANIC))
        if "lunarcrush" in url:
            return response(200, json.dumps(LUNAR_FEEDS))
        if "coindesk" in url:
            raise ConnectionError("no route")           # a source dies
        return response(200, COINTELEGRAPH_HTML)

    ref, got, jt, tt = _both(
        lambda r: Replay(r, route=route),
        lambda m, t: m.fetch_news(t, "BTCUSDC", api_keys={"cryptopanic": "k"}))
    assert got == ref and tt.calls == jt.calls
    assert len({i["url"] for i in got}) == len(got) >= 4


def test_constants_and_html_sources_match():
    for name in ("BINANCE_API", "LUNARCRUSH_API", "CRYPTOPANIC_API"):
        assert getattr(tf, name) == getattr(jf, name)
    assert tf._HTML_SOURCES.keys() == jf._HTML_SOURCES.keys()
    for k, (build, item, date, base) in jf._HTML_SOURCES.items():
        tb, ti, td, tbase = tf._HTML_SOURCES[k]
        assert (ti, td, tbase) == (item, date, base) and tb("ETH") == build("ETH")
    for sym in ("BTCUSDC", "ETHUSDT", "SOLBTC", "WEIRD"):
        assert tf._base_ticker(sym) == jf._base_ticker(sym)


class _Reply:
    def __init__(self, status, body):
        self.status, self._body = status, body

    def read(self):
        return self._body

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


@pytest.mark.parametrize("mode", ["ok", "http_error"])
def test_urllib_transport_matches(monkeypatch, mode):
    """The real transport with `urlopen` patched: the success branch and
    the HTTPError → Response branch, with the same request URL/headers."""
    seen = []

    def urlopen(req, timeout=None):
        seen.append((req.full_url, dict(req.header_items()), timeout))
        if mode == "http_error":
            raise urllib.error.HTTPError(req.full_url, 429, "Too Many", {},
                                         io.BytesIO(b"rate \xff limited"))
        return _Reply(200, b'[[1, "2"]]')

    monkeypatch.setattr(urllib.request, "urlopen", urlopen)
    out = []
    for m in (jf, tf):
        r = asyncio.run(m.UrllibTransport(timeout_s=3.0)(
            "https://example.invalid/api", params={"symbol": "BTCUSDC", "limit": 5},
            headers={"Authorization": "Bearer k"}))
        out.append((r.status, r.body, r.json() if mode == "ok" else None))
    assert out[0] == out[1]
    assert seen[0] == seen[1] and seen[0][2] == 3.0
    assert out[1][0] == (429 if mode == "http_error" else 200)


def _run_fetch(cli, argv):
    args = cli.build_parser().parse_args(argv)
    args.fn(args)


@pytest.mark.parametrize("source", ["synthetic", "binance"])
def test_cli_fetch_writes_the_jax_csv(tmp_path, monkeypatch, capsys, source):
    from ai_crypto_trader_tpu import cli as jcli
    from ai_crypto_trader_tpu_torch import cli as tcli

    argv = ["fetch", "--symbol", "ETHUSDC", "--days", "1", "--seed", "4"]
    if source == "binance":
        argv += ["--source", "binance"]
        # Binance's pages over a fake transport at a pinned clock
        for m in (jf, tf):
            pages = PagedKlines(m.Response, 10**6)
            monkeypatch.setattr(m.UrllibTransport, "__call__",
                                lambda self, url, params=None, headers=None, p=pages:
                                p(url, params, headers))
        for cli in (jcli, tcli):
            monkeypatch.setattr(cli.time, "time", lambda: 200_000.0)
    outs = {}
    for name, cli in (("jax", jcli), ("torch", tcli)):
        (tmp_path / name).mkdir()
        monkeypatch.chdir(tmp_path / name)
        _run_fetch(cli, argv)
        outs[name] = capsys.readouterr().out
    rel = "backtesting/data/market/ETHUSDC/ETHUSDC_1m.csv"
    ref, got = (tmp_path / "jax" / rel).read_bytes(), (tmp_path / "torch" / rel).read_bytes()
    assert got == ref and outs["torch"] == outs["jax"]
    assert len(ref.splitlines()) == 1 + 1440             # a header and one day of candles
