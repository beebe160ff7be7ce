"""The port's regime detection against the JAX package's, on the CPU.

Same seeded candles through both packages (the JAX side jitted, as its
package runs it; the port's EWMA replays the JAX scan's rounding on the
CPU):

  * `regime_features` column by column, each within a few float32 ulps of
    the magnitude it is computed from (stated per column below);
  * k-means, the GMM and the HMM fitted by the port on the JAX package's
    features and its draw of the first centroid: centroids, labels and the
    named regimes equal, probabilities and posteriors within 1e-4;
  * the port's predictions, posteriors and Viterbi on JAX-fitted models
    (`convert.*_from_jax`): labels and paths equal, probabilities within
    1e-4; PCA projections equal up to each column's sign;
  * `RegimeDetector.detect` and `label_series` for all four methods;
  * `MarketRegimeService.update` and `RegimeDataCollector` on the JAX
    package's `EventBus`.
"""

import asyncio
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ai_crypto_trader_tpu.data.synthetic import generate_ohlcv
from ai_crypto_trader_tpu.regime import cluster as jcl
from ai_crypto_trader_tpu.regime import detector as jdet
from ai_crypto_trader_tpu.regime import hmm as jhmm
from ai_crypto_trader_tpu_torch import convert
from ai_crypto_trader_tpu_torch.regime import cluster as pcl
from ai_crypto_trader_tpu_torch.regime import detector as pdet
from ai_crypto_trader_tpu_torch.regime import hmm as phmm

PROB_ATOL = 1e-4
ULP = 2.0 ** -23          # float32 spacing at 1


def _ohlcv(n=500, seed=2):
    return {k: v for k, v in generate_ohlcv(n=n, seed=seed).items() if k != "regime"}


def _jax_index(n, seed=0):
    """The JAX package's k-means draw of the first centroid's index."""
    _, k0 = jax.random.split(jax.random.PRNGKey(seed))
    return int(jax.random.randint(k0, (), 0, n))


@pytest.fixture(scope="module")
def data():
    d = _ohlcv()
    jf = np.asarray(jdet.regime_features({k: jnp.asarray(v) for k, v in d.items()}))
    std = jcl.standardize_fit(jnp.asarray(jf))
    pca = jcl.pca_fit(std.transform(jnp.asarray(jf)), 5)
    z = np.asarray(pca.transform(std.transform(jnp.asarray(jf))))
    return {"ohlcv": d, "jax_features": jf, "std": std, "pca": pca, "z": z,
            "index": _jax_index(len(z))}


def test_regime_features_follow_the_jax_package(data):
    d, jf = data["ohlcv"], data["jax_features"]
    pf = pdet.regime_features(d, device="cpu").numpy()
    assert pf.shape == jf.shape == (len(d["close"]), 6) and np.isfinite(pf).all()
    close = d["close"].astype(np.float64)
    window = 20
    ramp_sum = np.abs(np.arange(window) - (window - 1) / 2).sum()
    ss_t = window * (window * window - 1) / 12.0
    atol = {
        # ret, and its rolling std: logs of the close rounded by each
        # package's log (8 ulps of the largest log)
        0: 8 * ULP * np.log(close).max(),
        1: 8 * ULP * np.log(close).max(),
        # slope: 8 ulps of Σ|ramp|·x / ss_t / close, the magnitude summed
        2: 8 * ULP * ramp_sum / ss_t * (close.max() / close.min()),
        # MACD / close: EMA-12 − EMA-26, each ≈ close: 16 ulps of 1
        4: 16 * ULP,
    }
    # Bollinger width 4·sd/mid: sd = √(m2 − m²) over prices centred on their
    # mean c, so 8 ulps of the largest (x − c)² in the variance move sd by
    # that over 2·sd
    m2 = ((close - close.mean()) ** 2).max()
    sd = np.maximum(jf[:, 5] * close / 4.0, 1e-12)
    atol[5] = 4.0 * 8 * ULP * m2 / (2.0 * sd) / close
    for c in range(6):
        diff = np.abs(pf[:, c] - jf[:, c])
        bound = atol.get(c, 0.0) + 1e-5 * np.abs(jf[:, c])
        assert (diff <= bound).all(), (c, float(diff.max()), float(np.max(diff / bound)))


def test_standardizer_and_pca_follow_up_to_sign(data):
    jf, z = data["jax_features"], data["z"]
    std = pcl.standardize_fit(jf, device="cpu")
    np.testing.assert_allclose(std.mean.numpy(), np.asarray(data["std"].mean), rtol=1e-5,
                               atol=1e-9)
    np.testing.assert_allclose(std.std.numpy(), np.asarray(data["std"].std), rtol=1e-5)
    jf = jf.copy()
    pca = pcl.pca_fit(std.transform(torch.from_numpy(jf)), 5, device="cpu")
    got = pca.transform(std.transform(torch.from_numpy(jf))).numpy()
    signs = np.sign((got * z).sum(axis=0))
    np.testing.assert_allclose(got * signs, z, atol=1e-4)
    # the JAX package's fitted transforms give its projections
    mine = convert.pca_from_jax(data["pca"], device="cpu").transform(
        convert.standardizer_from_jax(data["std"], device="cpu").transform(
            torch.from_numpy(jf)))
    np.testing.assert_allclose(mine.numpy(), z, atol=1e-5)


def test_kmeans_on_the_jax_draw(data):
    z, idx = data["z"], data["index"]
    ref = jcl.kmeans_fit(jax.random.PRNGKey(0), jnp.asarray(z), 4)
    km = pcl.kmeans_fit(idx, z, 4, device="cpu")
    np.testing.assert_allclose(km.centroids.numpy(), np.asarray(ref.centroids), atol=1e-5)
    labels = pcl.kmeans_predict(km, z).numpy()
    np.testing.assert_array_equal(labels, np.asarray(jcl.kmeans_predict(ref, z)))
    np.testing.assert_array_equal(
        pcl.kmeans_predict(convert.kmeans_from_jax(ref, device="cpu"), z).numpy(), labels)
    feats = data["jax_features"]
    np.testing.assert_array_equal(pdet._name_clusters(feats, labels, 4),
                                  jdet._name_clusters(feats, labels, 4))
    # a generator's draw stays in range and fits as deterministically
    a = pcl.kmeans_fit(torch.Generator().manual_seed(3), z, 4, device="cpu")
    b = pcl.kmeans_fit(torch.Generator().manual_seed(3), z, 4, device="cpu")
    assert torch.equal(a.centroids, b.centroids)


def test_gmm_on_the_jax_draw(data):
    z, idx = data["z"], data["index"]
    ref = jcl.gmm_fit(jax.random.PRNGKey(0), jnp.asarray(z), 4)
    gmm = pcl.gmm_fit(idx, z, 4, device="cpu")
    want = np.asarray(jcl.gmm_predict_proba(ref, z))
    got = pcl.gmm_predict_proba(gmm, z).numpy()
    np.testing.assert_allclose(got, want, atol=PROB_ATOL)
    np.testing.assert_array_equal(got.argmax(1), want.argmax(1))
    on_jax = pcl.gmm_predict_proba(convert.gmm_from_jax(ref, device="cpu"), z).numpy()
    np.testing.assert_allclose(on_jax, want, atol=PROB_ATOL)


def test_hmm_on_the_jax_draw_and_on_a_jax_fitted_model(data):
    z, idx = data["z"][:300], _jax_index(300)
    ref = jhmm.hmm_fit(jax.random.PRNGKey(0), jnp.asarray(z), 4)
    mine = phmm.hmm_fit(idx, z, 4, device="cpu")
    gamma_j, ll_j = jhmm.hmm_posteriors(ref, z)
    gamma_p, ll_p = phmm.hmm_posteriors(mine, z)
    np.testing.assert_allclose(gamma_p.numpy(), np.asarray(gamma_j), atol=PROB_ATOL)
    np.testing.assert_allclose(float(ll_p), float(ll_j), rtol=1e-5)
    path = np.asarray(jhmm.hmm_viterbi(ref, z))
    np.testing.assert_array_equal(phmm.hmm_viterbi(mine, z).numpy(), path)
    # the JAX-fitted model through the port's posteriors and Viterbi
    model = convert.hmm_from_jax(ref, device="cpu")
    np.testing.assert_array_equal(phmm.hmm_viterbi(model, z).numpy(), path)
    gamma, ll = phmm.hmm_posteriors(model, z)
    np.testing.assert_allclose(gamma.numpy(), np.asarray(gamma_j), atol=PROB_ATOL)
    np.testing.assert_allclose(float(ll), float(ll_j), rtol=1e-5)


@pytest.mark.parametrize("method", ["kmeans", "gmm", "hmm", "rules"])
def test_detector_detect_and_label_series(method):
    d = _ohlcv(n=360, seed=5)
    ref = jdet.RegimeDetector(method=method).fit(d)
    mine = pdet.RegimeDetector(method=method, key=_jax_index(360), device="cpu").fit(d)
    np.testing.assert_array_equal(mine._state["mapping"], ref._state["mapping"])
    a, b = ref.detect(d), mine.detect(d)
    assert b["regime"] == a["regime"]
    for name, p in a["probabilities"].items():
        assert abs(b["probabilities"][name] - p) <= PROB_ATOL, (name, b, a)
    assert abs(sum(b["probabilities"].values()) - 1.0) <= 1e-5
    np.testing.assert_array_equal(mine.label_series(d), ref.label_series(d))


def test_rules_regime_thresholds(data):
    feats = data["jax_features"].copy()
    got = pdet.rules_regime(torch.from_numpy(feats)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jdet.rules_regime(jnp.asarray(feats))))
    assert got.dtype == np.int32 and set(np.unique(got)) <= {0, 1, 2, 3}


def _klines(d):
    t0 = 1_700_000_000_000
    return [[t0 + 60_000 * i, float(d["open"][i]), float(d["high"][i]), float(d["low"][i]),
             float(d["close"][i]), float(d["volume"][i])] for i in range(len(d["close"]))]


def test_market_regime_service_on_the_jax_bus(monkeypatch):
    from ai_crypto_trader_tpu.regime.service import MarketRegimeService as JaxService
    from ai_crypto_trader_tpu.shell.bus import EventBus
    from ai_crypto_trader_tpu_torch.regime import service as port_service

    buses = {"jax": EventBus(), "port": EventBus()}
    long, thin = _ohlcv(n=320, seed=4), _ohlcv(n=120, seed=6)
    for bus in buses.values():
        bus.set("historical_data_AAA_1m", _klines(long))
        bus.set("historical_data_BBB_1m", _klines(thin))
        bus.set("historical_data_CCC_1m", _klines(_ohlcv(n=40, seed=1)))
    # the port's detector on the JAX package's k-means draw
    monkeypatch.setattr(port_service, "RegimeDetector",
                        functools.partial(pdet.RegimeDetector, key=_jax_index(320)))
    svcs = {"jax": JaxService(buses["jax"], now_fn=lambda: 50.0),
            "port": port_service.MarketRegimeService(buses["port"], now_fn=lambda: 50.0,
                                                     device="cpu")}
    for sym in ("AAA", "BBB", "CCC"):
        out = {k: asyncio.run(s.update(sym)) for k, s in svcs.items()}
        assert out["port"]["regime"] == out["jax"]["regime"], sym
        assert abs(out["port"]["confidence"] - out["jax"]["confidence"]) <= PROB_ATOL
        assert out["port"].keys() == out["jax"].keys()
    assert svcs["port"].detectors["AAA"].method == "kmeans"
    assert svcs["port"].detectors["BBB"].method == "rules"
    assert "CCC" not in svcs["port"].detectors
    assert sorted(buses["port"].keys("market_regime*")) == sorted(buses["jax"].keys("market_regime*"))
    assert buses["port"].published_counts["regime_updates"] == \
        buses["jax"].published_counts["regime_updates"] == 2
    for k in ("market_regime_AAA", "market_regime"):
        assert buses["port"].get(k)["regime"] == buses["jax"].get(k)["regime"]
    for s in svcs.values():
        s.record_trade("grid", 12.0, regime="bull")
        s.record_trade("grid", -4.0, regime="bull")
        s.record_trade("dca", 30.0, regime="bull")
    assert svcs["port"].regime_score("grid", "bull") == svcs["jax"].regime_score("grid", "bull")
    assert svcs["port"].best_strategy_for_regime("bull") == "dca"
    assert svcs["port"].switch_recommendation("grid") == svcs["jax"].switch_recommendation("grid")


def test_regime_data_collector_on_the_jax_bus():
    from ai_crypto_trader_tpu.regime.collector import RegimeDataCollector as JaxCollector
    from ai_crypto_trader_tpu.shell.bus import EventBus
    from ai_crypto_trader_tpu_torch.regime import RegimeDataCollector

    bus = EventBus()
    rng = np.random.default_rng(0)
    mine, ref = RegimeDataCollector(bus), JaxCollector(bus)
    for i in range(14):
        sym = ("AAA", "BBB")[i % 2]
        bus.set(f"market_data_{sym}", {"timestamp": 100.0 * i, "current_price": 50.0 + i,
                                       "rsi": float(rng.uniform(20, 80)),
                                       "volatility": float(rng.uniform(0, 0.05)),
                                       "trend_strength": float(rng.uniform(0, 1)),
                                       "trend": "up", "signal": "BUY",
                                       "signal_strength": float(rng.uniform(0, 100))})
        bus.set(f"latest_signal_{sym}", {"decision": "BUY", "confidence": 0.7})
        assert mine.collect_snapshot(sym) == ref.collect_snapshot(sym)
    assert mine.collect_snapshot("ZZZ") is None
    trades = [{"symbol": "AAA", "closed_at": 410.0, "pnl": 5.0},
              {"symbol": "BBB", "closed_at": 900.0, "pnl": -2.0}]
    assert mine.attach_outcomes(trades) == ref.attach_outcomes(trades) == 2
    a, b = mine.training_arrays(), ref.training_arrays()
    assert a.keys() == b.keys() and a["n_labeled"] == b["n_labeled"] == 2
    np.testing.assert_array_equal(a["features"], b["features"])
    np.testing.assert_array_equal(a["outcomes"], b["outcomes"])
