"""The port's social services (social/service.py, news.py, provider.py,
strategy_integrator.py) against the JAX package's, on the CPU.

Tolerances, and why:

  * `SocialMonitorService` over 3 symbols and 70 polls on twin buses and
    one virtual clock: the published metrics, histories, snapshots (their
    float32 tensors), accuracy reports, source weights and every `run_once`
    return exactly equal.  The anomaly score within 2·cond·2⁻²⁴ of
    the fitted covariance (at least the analyzer's 1e-4,
    tests/test_torch_social_analyzer.py) and its flag equal but where
    JAX's score lies that close to 1: the deterministic provider's volume
    and engagement are both linear in |Δprice|, so the covariance of its
    three features has a condition number near 2.5e5 and its float32
    inverse carries the matmuls' rounding (summed in another order by XLA)
    that many times over.  The lead-lag report's correlations within atol
    1e-6 and its lags equal (the same test's bound).  One host read a poll (every
    due symbol's anomaly check) and one a report.
  * The executor's social factors over the service's snapshot: within
    1e-6 of the JAX executor's, in one read.
  * `NewsAnalyzer` and `NewsService`: host code, exactly equal.
  * The provider's joins, lookups and indicators: NumPy, exactly equal;
    `social_inputs`: the JAX package's arrays bit for bit, as float32
    tensors; `evolvable_backtest(social=...)` (one genome) and
    `population_backtest(social=...)` stats at the engine's
    tolerance (tests/test_torch_evolvable.py).
  * The strategy integrator: float64 NumPy, exactly equal.
"""

import asyncio

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from test_torch_backtest import assert_stats_equal  # noqa: E402

from ai_crypto_trader_tpu.backtest import evolvable as jev  # noqa: E402
from ai_crypto_trader_tpu.backtest import sample_params  # noqa: E402
from ai_crypto_trader_tpu.data import generate_ohlcv  # noqa: E402
from ai_crypto_trader_tpu.data.fetchers import SocialDaily as JSocialDaily  # noqa: E402
from ai_crypto_trader_tpu.shell import bus as jbus  # noqa: E402
from ai_crypto_trader_tpu.shell import executor as jexecutor  # noqa: E402
from ai_crypto_trader_tpu.shell.exchange import FakeExchange as JFakeExchange  # noqa: E402
from ai_crypto_trader_tpu.social import news as jnews  # noqa: E402
from ai_crypto_trader_tpu.social import provider as jprov  # noqa: E402
from ai_crypto_trader_tpu.social import service as jsvc  # noqa: E402
from ai_crypto_trader_tpu.social import strategy_integrator as jint  # noqa: E402
from ai_crypto_trader_tpu_torch import convert  # noqa: E402
from ai_crypto_trader_tpu_torch.backtest import evolvable as tev  # noqa: E402
from ai_crypto_trader_tpu_torch.data.ingest import SocialDaily  # noqa: E402
from ai_crypto_trader_tpu_torch.risk.social import SocialSnapshot  # noqa: E402
from ai_crypto_trader_tpu_torch.shell import bus as tbus  # noqa: E402
from ai_crypto_trader_tpu_torch.shell import executor as texecutor  # noqa: E402
from ai_crypto_trader_tpu_torch.shell.exchange import FakeExchange  # noqa: E402
from ai_crypto_trader_tpu_torch.social import news as tnews  # noqa: E402
from ai_crypto_trader_tpu_torch.social import provider as tprov  # noqa: E402
from ai_crypto_trader_tpu_torch.social import service as tsvc  # noqa: E402
from ai_crypto_trader_tpu_torch.social import strategy_integrator as tint  # noqa: E402

SYMBOLS = ["BTCUSDC", "ETHUSDC", "SOLUSDC"]
POLLS = 70                       # past the 50-row anomaly gate, the report gates
SCORE_RTOL = 1e-4
DAY = 86_400


# --- SocialMonitorService ---------------------------------------------------

def _market(seed=0, n=POLLS + 400):
    """Per symbol: 1m closes and 15-minute % changes that swing sentiment."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, s in enumerate(SYMBOLS):
        close = 100.0 * (k + 1) * np.cumprod(1 + rng.normal(0, 0.004, n))
        chg = np.zeros(n)
        chg[15:] = (close[15:] / close[:-15] - 1) * 100
        chg[rng.integers(0, n, 6)] *= 8.0                  # volume spikes
        out[s] = (close, chg)
    return out


def _feed(bus, market, t, now):
    for s, (close, chg) in market.items():
        bus.set(f"market_data_{s}", {"price_change_15m": float(chg[t]),
                                      "current_price": float(close[t]), "timestamp": now})
        lo = max(0, t - 299)
        bus.set(f"historical_data_{s}_1m",
                [[i * 60_000.0, float(close[i]), float(close[i]) * 1.001,
                  float(close[i]) * 0.999, float(close[i]), 10.0] for i in range(lo, t + 1)])


def _plain(v):
    """A snapshot's tensors or arrays as NumPy."""
    if isinstance(v, tuple) and hasattr(v, "_fields"):
        return {f: np.asarray(x.numpy() if torch.is_tensor(x) else x)
                for f, x in zip(v._fields, v)}
    return v


@pytest.fixture(scope="module")
def monitor_runs():
    market = _market()
    kw = dict(symbols=list(SYMBOLS), cache_ttl_s=60.0, lead_lag_interval_s=600.0,
              accuracy_interval_s=900.0, accuracy_horizon=12)
    clock = [1_000_000.0]
    buses = {"jax": jbus.EventBus(), "port": tbus.EventBus()}
    svcs = {"jax": jsvc.SocialMonitorService(buses["jax"], now_fn=lambda: clock[0], **kw),
            "port": tsvc.SocialMonitorService(buses["port"], now_fn=lambda: clock[0],
                                              device="cpu", **kw)}
    queues = {k: b.subscribe("social_updates") for k, b in buses.items()}
    reads, real = [], tsvc.host_read
    records = {"jax": [], "port": []}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tsvc, "host_read", lambda x: reads.append(tuple(x.shape)) or real(x))
        for t in range(300, 300 + POLLS):
            clock[0] += 60.0
            for pkg in ("jax", "port"):
                _feed(buses[pkg], market, t, clock[0])
                n_reads = len(reads)
                out = asyncio.run(svcs[pkg].run_once())
                b = buses[pkg]
                records[pkg].append({
                    "out": out, "reads": len(reads) - n_reads,
                    "updates": [queues[pkg].get_nowait()["data"]
                                for _ in range(queues[pkg].qsize())],
                    **{f"{k}_{s}": _plain(b.get(f"{k}_{s}")) for s in SYMBOLS
                       for k in ("social_metrics", "social_history", "social_snapshot")},
                    "lead_lag": b.get("social_lead_lag_report"),
                    "accuracy": b.get("social_accuracy_report"),
                    "weights": dict(svcs[pkg].source_weights)})
                records[pkg][-1]["score_rtol"] = {
                    s: score_rtol(svcs[pkg]._anomaly_models.get(s)) for s in SYMBOLS}
    return records, svcs, buses


def score_rtol(model):
    """The anomaly score's rounding bound for the model: 2·cond·2⁻²⁴ of its
    covariance (the precision matrix is its inverse, so a perturbation of a
    few ulps in the covariance moves it by up to cond times as much),
    never below the analyzer's SCORE_RTOL."""
    if model is None:
        return SCORE_RTOL
    cond = float(np.linalg.cond(np.asarray(model.prec, np.float64)))
    return max(SCORE_RTOL, 2.0 * cond * 2.0 ** -24)


def _anomaly_close(got, ref, flips, rtol):
    g, r = got.pop("anomaly"), ref.pop("anomaly")
    np.testing.assert_allclose(g["score"], r["score"], rtol=rtol, atol=1e-7)
    if g["is_anomaly"] != r["is_anomaly"]:
        assert abs(r["score"] - 1.0) <= rtol, (g, r)
        flips.append(r)


def test_monitor_polls_equal_jax(monitor_runs):
    records, svcs, _ = monitor_runs
    flips, scored = [], 0
    for got, ref in zip(records["port"], records["jax"]):
        assert got["out"] == ref["out"]
        for s in SYMBOLS:
            g, r = dict(got[f"social_metrics_{s}"]), dict(ref[f"social_metrics_{s}"])
            scored += r["anomaly"]["score"] != 0.0
            _anomaly_close(g, r, flips, got["score_rtol"][s])
            assert g == r
            assert got[f"social_history_{s}"] == ref[f"social_history_{s}"]
            gs, rs = got[f"social_snapshot_{s}"], ref[f"social_snapshot_{s}"]
            for f in rs:
                assert gs[f].dtype == rs[f].dtype == np.float32
                np.testing.assert_array_equal(gs[f], rs[f], err_msg=f)
        for g, r in zip(got["updates"], ref["updates"]):
            g, r = dict(g), dict(r)
            _anomaly_close(g, r, [], got["score_rtol"][r["symbol"]])
            assert g == r
    assert scored >= 3 * (POLLS - 50) and len(flips) <= 2
    # the deterministic provider's volume and engagement are both linear in
    # |Δprice|: nearly collinear features, an ill-conditioned covariance
    assert max(max(r["score_rtol"].values()) for r in records["port"]) < 0.05
    assert records["jax"][-1]["out"]["published"] == len(SYMBOLS)


def test_monitor_reports_equal_jax(monitor_runs):
    records, svcs, _ = monitor_runs
    n_ll = n_acc = 0
    for got, ref in zip(records["port"], records["jax"]):
        assert got["accuracy"] == ref["accuracy"]
        assert got["weights"] == ref["weights"]
        gl, rl = got["lead_lag"], ref["lead_lag"]
        assert (gl is None) == (rl is None)
        if rl is not None:
            assert gl["timestamp"] == rl["timestamp"] and gl["symbols"].keys() == rl["symbols"].keys()
            for s, r in rl["symbols"].items():
                g = gl["symbols"][s]
                assert (g["optimal_lag"], g["lag_unit_s"]) == (r["optimal_lag"], r["lag_unit_s"])
                assert abs(g["correlation"] - r["correlation"]) <= 1e-6
        n_ll += got["out"]["lead_lag"]
        n_acc += got["out"]["accuracy"]
    assert n_ll >= 3 and n_acc >= 2
    assert records["jax"][-1]["accuracy"]["total_symbols"] == len(SYMBOLS)
    assert svcs["port"].source_weights_by_symbol == svcs["jax"].source_weights_by_symbol


def test_monitor_reads(monitor_runs):
    """One read a poll once a symbol holds 50 rows (every symbol's anomaly
    check in it), one a lead-lag report and one an accuracy report."""
    records, _, _ = monitor_runs
    for t, rec in enumerate(records["port"]):
        out = rec["out"]
        want = (t + 1 >= 50) + out["lead_lag"] + out["accuracy"]
        assert rec["reads"] == want, (t, rec["reads"], out)


def test_snapshot_feeds_the_executor_sizing(monitor_runs, monkeypatch):
    """The service's last snapshot through each executor's social factors:
    within 1e-6 of the JAX executor's, in one read."""
    _, _, buses = monitor_runs
    reads, real = [], texecutor.host_read
    monkeypatch.setattr(texecutor, "host_read", lambda x: reads.append(1) or real(x))
    for s in SYMBOLS:
        snap = buses["port"].get(f"social_snapshot_{s}")
        assert isinstance(snap, SocialSnapshot)
        got = texecutor.TradeExecutor(buses["port"], FakeExchange({}),
                                      device="cpu")._social_factors(s)
        ref = jexecutor.TradeExecutor(buses["jax"], JFakeExchange({}))._social_factors(s)
        assert got.keys() == ref.keys()
        for k in ref:
            assert abs(got[k] - ref[k]) <= 1e-6, k
    assert len(reads) == len(SYMBOLS)


@pytest.mark.parametrize("n_hist,n_close", [(10, 300), (40, 300), (120, 90), (300, 300)])
def test_assess_accuracy_equal(n_hist, n_close, monkeypatch):
    """`assess_accuracy` on one symbol: the same report, weights and
    service weights as JAX's (or the same refusal), in one read."""
    rng = np.random.default_rng(n_hist)
    rows = [{**{s: float(v) for s, v in zip(jsvc.SOURCES, rng.uniform(0.2, 0.8, 4))},
             "ts": 60.0 * i} for i in range(n_hist)]
    close = (100.0 * np.cumprod(1 + rng.normal(0, 0.01, n_close))).astype(np.float32)
    svcs = {"jax": jsvc.SocialMonitorService(jbus.EventBus()),
            "port": tsvc.SocialMonitorService(tbus.EventBus(), device="cpu")}
    for svc in svcs.values():
        svc._history["X"] = [dict(r) for r in rows]
    reads, real = [], tsvc.host_read
    monkeypatch.setattr(tsvc, "host_read", lambda x: reads.append(1) or real(x))
    got = svcs["port"].assess_accuracy("X", close, horizon=12)
    assert got == svcs["jax"].assess_accuracy("X", close, horizon=12)
    assert svcs["port"].source_weights == svcs["jax"].source_weights
    assert len(reads) == ("accuracy" in got)


@pytest.mark.parametrize("n_rows", [1, 3, 7, 23, 40])
def test_snapshot_buckets(n_rows):
    """The snapshot's bucketed length and its values against JAX's."""
    clock = [0.0]
    svcs = {"jax": jsvc.SocialMonitorService(jbus.EventBus(), now_fn=lambda: clock[0]),
            "port": tsvc.SocialMonitorService(tbus.EventBus(), now_fn=lambda: clock[0],
                                              device="cpu")}
    rows = [{"twitter_sentiment": 0.3 + 0.01 * i, "overall_sentiment": 0.6 - 0.005 * i,
             "ts": 100.0 * i} for i in range(n_rows)]
    for svc in svcs.values():
        svc._history["X"] = [dict(r) for r in rows]
    got = _plain(svcs["port"]._snapshot("X", 5_000.0))
    ref = _plain(svcs["jax"]._snapshot("X", 5_000.0))
    for f in ref:
        np.testing.assert_array_equal(got[f], ref[f], err_msg=f)


def test_resample_tail_and_provider_equal():
    a = np.arange(23, dtype=np.float32)
    for stride in (0, 1, 2, 5, 30):
        np.testing.assert_array_equal(tsvc.resample_tail(a, stride),
                                      jsvc.resample_tail(a, stride))
    bus = {"jax": jbus.EventBus(), "port": tbus.EventBus()}
    for chg in (-12.0, -0.4, 0.0, 0.7, 3.3, 40.0):
        for b in bus.values():
            b.set("market_data_X", {"price_change_15m": chg})
        assert tsvc.deterministic_provider(bus["port"], "X") == \
            jsvc.deterministic_provider(bus["jax"], "X")
    assert tsvc.deterministic_provider(tbus.EventBus(), "X") is None


# --- NewsAnalyzer and NewsService -------------------------------------------

ARTICLES = [
    {"title": "Bitcoin surges as ETF approval nears", "body": "Massive institutional "
     "adoption. Analysts are very bullish. The SEC has not delayed the decision.",
     "published_at": 990_000.0, "source": "wire"},
    {"title": "Exchange hacked, $ETH and $SOL drop", "body": "A huge exploit drained "
     "funds. Fear spreads across DeFi protocols. Liquidations follow.",
     "published_at": 950_000.0},
    {"title": "Markets trade flat", "body": "Nothing happened. Fed rates steady."},
    {"title": "Dogecoin is not bullish, hardly a rally", "source": "blog",
     "published_at": 999_000.0},
]


@pytest.mark.parametrize("asset", [None, "BTC", "ETH", "XRP"])
def test_news_analyzer_equal(asset):
    kw = dict(now_fn=lambda: 1_000_000.0)
    got, ref = tnews.NewsAnalyzer(**kw), jnews.NewsAnalyzer(**kw)
    for a in ARTICLES:
        assert got.analyze_article(a, asset) == ref.analyze_article(a, asset)
        text = a["title"] + " " + a.get("body", "")
        assert tnews.lexicon_sentiment(text) == jnews.lexicon_sentiment(text)
        assert tnews.extract_entities(text) == jnews.extract_entities(text)
        assert tnews.extract_topics(text) == jnews.extract_topics(text)
        assert tnews.summarize(text, 1) == jnews.summarize(text, 1)
    assert got.aggregate(ARTICLES, asset) == ref.aggregate(ARTICLES, asset)
    assert got.aggregate([], asset) == ref.aggregate([], asset)


def test_news_service_equal():
    market = _market(seed=1)
    clock = [1_000_000.0]
    repeat = [dict(ARTICLES[0]), {"title": "No date here", "source": "x"}]

    def provider(pkg):
        det = (jnews if pkg == "jax" else tnews).deterministic_news_provider

        def fetch(bus, symbol):
            # every third poll re-serves a batch (dedup), one symbol's feed is
            # empty now and then
            t = int(clock[0] // 60) % 7
            if symbol == "SOLUSDC" and t == 3:
                return []
            return det(bus, symbol) + (repeat if t % 3 == 0 else [])
        return fetch

    records = {}
    for pkg, mod, bus_mod in (("jax", jnews, jbus), ("port", tnews, tbus)):
        clock[0] = 1_000_000.0
        bus = bus_mod.EventBus()
        q = bus.subscribe("news_updates")
        svc = mod.NewsService(bus, list(SYMBOLS), provider=provider(pkg),
                              poll_interval_s=120.0, history_len=6, now_fn=lambda: clock[0])
        rec = []
        for t in range(300, 340):
            clock[0] += 60.0
            _feed(bus, market, t, clock[0])
            rec.append((asyncio.run(svc.run_once()),
                        [bus.get(f"news_{k}_{s}") for s in SYMBOLS
                         for k in ("analysis", "recent")],
                        [q.get_nowait()["data"] for _ in range(q.qsize())]))
        records[pkg] = rec
    assert records["port"] == records["jax"]
    assert sum(r[0]["published"] for r in records["jax"]) >= 40


# --- the point-in-time provider ---------------------------------------------

def _daily(pkg, days=30, seed=0, start=1_700_000_000 - (1_700_000_000 % DAY), nan=True):
    rng = np.random.default_rng(seed)
    ts = start + np.arange(days, dtype=np.int64) * DAY
    ts[5:] += 3_600                                           # an interior gap
    cols = {"social_volume": rng.integers(100, 50_000, days).astype(np.float32),
            "social_engagement": rng.integers(10, 5_000, days).astype(np.float32),
            "social_sentiment": rng.uniform(0.1, 0.9, days).astype(np.float32),
            "social_contributors": rng.integers(1, 500, days).astype(np.float32),
            "news_sentiment": rng.uniform(0.2, 0.8, days).astype(np.float32)}
    if nan:
        cols["social_sentiment"][3] = np.nan
        cols["news_sentiment"][7] = np.nan
    return (JSocialDaily if pkg == "jax" else SocialDaily)(ts, cols)


@pytest.mark.parametrize("step", [60, 300, 3_600, DAY])
def test_resample_ffill_and_asof_equal(step):
    d = _daily("jax")
    for got, ref in zip(tprov.resample_ffill(d.timestamp, step),
                        jprov.resample_ffill(d.timestamp, step)):
        np.testing.assert_array_equal(got, ref)
    rng = np.random.default_rng(step)
    left = np.sort(rng.integers(d.timestamp[0] - 3 * DAY, d.timestamp[-1] + 3 * DAY, 500))
    for direction in ("backward", "nearest"):
        np.testing.assert_array_equal(tprov.asof_indices(left, d.timestamp, direction),
                                      jprov.asof_indices(left, d.timestamp, direction))
    np.testing.assert_array_equal(tprov.asof_indices(left, np.zeros(0, np.int64)),
                                  jprov.asof_indices(left, np.zeros(0, np.int64)))
    with pytest.raises(ValueError):
        tprov.asof_indices(left, d.timestamp, "forward")


@pytest.mark.parametrize("interval,offset", [("1m", -2 * DAY), ("5m", 2 * DAY),
                                             ("1h", 10 * DAY), ("1d", 0)])
def test_provider_lookups_equal(interval, offset):
    got, ref = tprov.SocialDataProvider(_daily("port")), jprov.SocialDataProvider(_daily("jax"))
    start = int(_daily("jax").timestamp[0]) + offset
    ts = start + np.arange(2_000, dtype=np.int64) * 617
    gm, rm = got.metrics_at(ts, interval), ref.metrics_at(ts, interval)
    gi, ri = got.indicators_at(ts), ref.indicators_at(ts)
    for g, r in ((gm, rm), (gi, ri)):
        assert g.keys() == r.keys()
        for k in r:
            assert g[k].dtype == r[k].dtype
            np.testing.assert_array_equal(g[k], r[k], err_msg=k)
    for t in ts[::97]:
        t = int(t)
        assert got.get_social_metrics_at(t) == ref.get_social_metrics_at(t)
        assert got.get_news_sentiment(t) == ref.get_news_sentiment(t)
        assert got.generate_market_update_with_social({"price": 1.0}, t) == \
            ref.generate_market_update_with_social({"price": 1.0}, t)


def test_provider_empty_and_short_series():
    for days in (0, 1):
        g = tprov.SocialDataProvider(SocialDaily(np.arange(days, dtype=np.int64) * DAY))
        r = jprov.SocialDataProvider(JSocialDaily(np.arange(days, dtype=np.int64) * DAY))
        ts = np.arange(50, dtype=np.int64) * 3_600
        for a, b in ((g.metrics_at(ts), r.metrics_at(ts)),
                     (g.indicators_at(ts), r.indicators_at(ts))):
            for k in b:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)


T_SOC, POP = 1024, 8


def test_social_inputs_and_evolvable_backtest_equal():
    """30 days of SocialDaily joined onto 1m candles → SocialInputs (the JAX
    arrays bit for bit) → `evolvable_backtest(social=...)` over a
    population, stats at the engine's tolerance."""
    daily = {pkg: _daily(pkg, nan=False) for pkg in ("jax", "port")}
    ts = int(daily["jax"].timestamp[2]) + np.arange(T_SOC, dtype=np.int64) * 60 * 37
    got = tprov.SocialDataProvider(daily["port"]).social_inputs(ts, "1m", device="cpu")
    ref = jprov.SocialDataProvider(daily["jax"]).social_inputs(ts, "1m")
    for f in ref._fields:
        g, r = getattr(got, f), np.asarray(getattr(ref, f))
        assert g.dtype == torch.float32 and g.device.type == "cpu"
        np.testing.assert_array_equal(g.numpy(), r, err_msg=f)
    d = {k: v for k, v in generate_ohlcv(n=T_SOC, seed=5).items() if k != "regime"}
    jd = {k: jnp.asarray(v) for k, v in d.items()}
    pop = sample_params(jax.random.PRNGKey(3), POP)
    tpop = convert.params_from_numpy(pop, device="cpu")
    for i in (0, 5):
        one = jax.tree.map(lambda x: x[i], pop)
        assert_stats_equal(
            jev.evolvable_backtest(jd, one, social=ref),
            tev.evolvable_backtest(d, convert.params_from_numpy(one, device="cpu"),
                                   social=got, device="cpu"))
    g_stats = tev.population_backtest(d, tpop, social=got, device="cpu")
    assert_stats_equal(jev.population_backtest(jd, pop, social=ref), g_stats)
    plain = tev.population_backtest(d, tpop, device="cpu")
    assert (plain.total_trades != g_stats.total_trades).any() or \
        (plain.final_balance != g_stats.final_balance).any()


# --- the social strategy integrator -----------------------------------------

def _correlated(rng, n=200, sign=1.0, lead=0):
    sent = rng.uniform(-1, 1, n)
    rets = np.zeros(n)
    for t in range(n - 1):
        src = sent[t - lead] if t - lead >= 0 else 0.0
        rets[t + 1] = sign * 0.01 * src + rng.normal(0, 0.001)
    return sent, 100 * np.cumprod(1 + rets)


@pytest.mark.parametrize("sign,lead,n", [(1.0, 0, 200), (-1.0, 0, 200), (1.0, 6, 300),
                                         (0.0, 0, 120), (1.0, 0, 20)])
def test_impact_and_strategy_equal(sign, lead, n):
    sent, close = _correlated(np.random.default_rng(n + lead), n, sign, lead)
    got, ref = tint.analyze_social_impact(sent, close), jint.analyze_social_impact(sent, close)
    assert got == ref
    assert tint.generate_social_strategy("BTCUSDC", got) == \
        jint.generate_social_strategy("BTCUSDC", ref)
    assert tint.SOCIAL_STRATEGY_TEMPLATES == jint.SOCIAL_STRATEGY_TEMPLATES
    np.testing.assert_array_equal(tint.to_signed(sent), jint.to_signed(sent))


def test_integrator_service_equal():
    rng = np.random.default_rng(11)
    sent, close = _correlated(rng, 3_000, 1.0, 2)
    hist = [[1_000_000.0 + 300.0 * i, float((s + 1) / 2)] for i, s in enumerate(sent[:400])]
    klines = [[i * 60_000.0, c, c, c, c, 1.0] for i, c in enumerate(close)]
    records = {}
    for pkg, mod, bus_mod in (("jax", jint, jbus), ("port", tint, tbus)):
        clock = [1_200_000.0]
        bus = bus_mod.EventBus()
        q = bus.subscribe("social_strategy_updates")
        bus.set("social_history_BTCUSDC", hist)
        bus.set("historical_data_BTCUSDC_1m", klines)
        bus.set("social_history_ETHUSDC", [[0.0, 0.5, 1.0]])      # malformed: skipped
        svc = mod.SocialStrategyIntegrator(bus, ["BTCUSDC", "ETHUSDC", "SOLUSDC"],
                                           now_fn=lambda: clock[0], check_interval_s=600.0,
                                           strategy_ttl_s=1_800.0)
        rec = []
        for _ in range(12):
            clock[0] += 300.0
            rec.append((asyncio.run(svc.run_once()),
                        bus.get("social_impact_analysis_BTCUSDC"),
                        bus.get("social_strategy_BTCUSDC"),
                        [q.get_nowait()["data"] for _ in range(q.qsize())]))
        records[pkg] = rec
    assert records["port"] == records["jax"]
    assert sum(r[0]["generated"] for r in records["jax"]) >= 2
