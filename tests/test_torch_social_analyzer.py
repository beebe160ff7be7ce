"""The port's social analyzer (social/analyzer.py) against the JAX
package's, on the CPU, over 30 days of hourly metrics (T = 720 × F = 8).

Tolerances, and why:

  * `normalize_metrics`: exactly equal (sort, the two neighbours of the
    percentile's rank weighted in float32 — jnp.percentile's arithmetic);
  * `fit_anomaly_model`: mean within 1e-6 of its scale, the precision
    matrix and threshold within rtol 1e-4 (a float32 covariance and its
    inverse; the inverse amplifies the sums' rounding by the condition
    number); `detect_anomalies`: scores within rtol 1e-4, flags equal but
    where JAX's score lies within 1e-4 of the threshold (score 1);
  * `lead_lag_correlation`: correlations within atol 1e-6, the argmax lag
    equal; `sentiment_accuracy`: equal, in JAX's dtypes;
    `adaptive_source_weights`: equal floats.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from ai_crypto_trader_tpu.social import analyzer as J  # noqa: E402
from ai_crypto_trader_tpu_torch import social  # noqa: E402
from ai_crypto_trader_tpu_torch.social import analyzer as P  # noqa: E402

T, F = 720, 8
SCORE_RTOL = 1e-4


def _metrics(seed):
    rng = np.random.default_rng(seed)
    x = rng.lognormal(mean=2.0, sigma=0.6, size=(T, F)).astype(np.float32)
    x[:, 3] = rng.normal(size=T).astype(np.float32)           # a signed column
    x[rng.integers(0, T, 12), rng.integers(0, F, 12)] *= 25.0  # outliers
    return x


@pytest.mark.parametrize("seed", [0, 1])
def test_normalize_metrics_equal(seed):
    x = _metrics(seed)
    x[:, 5] = 7.0                                               # constant: range 1
    got = P.normalize_metrics(x, device="cpu")
    ref = np.asarray(J.normalize_metrics(jnp.asarray(x)))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("contamination", [0.05, 0.1])
def test_anomaly_model_against_jax(contamination):
    x = _metrics(2)
    ref = J.fit_anomaly_model(jnp.asarray(x), contamination)
    got = P.fit_anomaly_model(x, contamination, device="cpu")
    np.testing.assert_allclose(got.mean.numpy(), np.asarray(ref.mean), rtol=1e-6)
    np.testing.assert_allclose(got.prec.numpy(), np.asarray(ref.prec), rtol=SCORE_RTOL,
                               atol=SCORE_RTOL * float(np.abs(np.asarray(ref.prec)).max()))
    np.testing.assert_allclose(float(got.threshold), float(ref.threshold), rtol=SCORE_RTOL)
    new = _metrics(3)
    flags_j, score_j = (np.asarray(v) for v in J.detect_anomalies(ref, jnp.asarray(new)))
    flags_p, score_p = (v.numpy() for v in P.detect_anomalies(got, new, device="cpu"))
    np.testing.assert_allclose(score_p, score_j, rtol=SCORE_RTOL)
    differ = np.flatnonzero(flags_p != flags_j)
    assert np.all(np.abs(score_j[differ] - 1.0) <= SCORE_RTOL), score_j[differ]
    assert flags_p.dtype == bool and flags_p.sum() > 0
    # the JAX package's model in the port's detector
    flags_x, _ = P.detect_anomalies(ref, new, device="cpu")
    assert (flags_x.numpy() != flags_j).sum() <= len(differ) + 1


@pytest.mark.parametrize("lead", [0, 5, -3])
def test_lead_lag_correlation_against_jax(lead):
    rng = np.random.default_rng(10 + lead)
    s = rng.normal(size=T).astype(np.float32)
    r = (0.6 * np.roll(s, lead) + rng.normal(size=T)).astype(np.float32)
    lags_j, corr_j = (np.asarray(v) for v in J.lead_lag_correlation(jnp.asarray(s),
                                                                     jnp.asarray(r), 24))
    lags_p, corr_p = P.lead_lag_correlation(s, r, max_lag=24, device="cpu")
    np.testing.assert_array_equal(lags_p.numpy(), lags_j)
    assert lags_p.dtype == torch.int32
    np.testing.assert_allclose(corr_p.numpy(), corr_j, atol=1e-6, rtol=0)
    assert int(lags_p[torch.argmax(corr_p)]) == int(lags_j[np.argmax(corr_j)]) == lead
    # a constant social series has no correlation
    _, zero = P.lead_lag_correlation(np.ones(T, np.float32), r, max_lag=4, device="cpu")
    assert torch.equal(zero, torch.zeros(9))


@pytest.mark.parametrize("horizon,band", [(12, 0.05), (1, 0.0), (700, 0.05)])
def test_sentiment_accuracy_against_jax(horizon, band):
    rng = np.random.default_rng(horizon)
    close = (100.0 * np.cumprod(1.0 + rng.normal(scale=0.01, size=T))).astype(np.float32)
    sent = rng.uniform(size=T).astype(np.float32)
    ref = J.sentiment_accuracy(jnp.asarray(sent), jnp.asarray(close), horizon, band)
    got = P.sentiment_accuracy(sent, close, horizon, band, device="cpu")
    assert got.keys() == ref.keys()
    for k in ref:
        assert got[k].numpy().dtype == np.asarray(ref[k]).dtype, k
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]), err_msg=k)


def test_adaptive_source_weights_against_jax():
    rng = np.random.default_rng(4)
    close = (100.0 * np.cumprod(1.0 + rng.normal(scale=0.01, size=T))).astype(np.float32)
    fwd = np.roll(close, -12) / close - 1.0
    good = np.clip(0.5 + 20.0 * fwd, 0.0, 1.0).astype(np.float32)
    sources = {"twitter": good, "reddit": rng.uniform(size=T).astype(np.float32),
               "news": (1.0 - good).astype(np.float32)}
    ref = J.adaptive_source_weights(sources, close)
    got = social.adaptive_source_weights(sources, close, device="cpu")
    assert got == ref
    assert got["twitter"] > got["reddit"] and abs(sum(got.values()) - 1.0) < 1e-12


def test_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = _metrics(0)
    for call in (lambda: P.normalize_metrics(x), lambda: P.fit_anomaly_model(x),
                 lambda: P.lead_lag_correlation(x[:, 0], x[:, 1]),
                 lambda: P.sentiment_accuracy(x[:, 0], x[:, 1]),
                 lambda: P.adaptive_source_weights({"a": x[:, 0]}, x[:, 1])):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    assert set(social.__all__ if hasattr(social, "__all__") else dir(social)) >= {
        "normalize_metrics", "fit_anomaly_model", "detect_anomalies", "lead_lag_correlation",
        "sentiment_accuracy", "adaptive_source_weights"}
