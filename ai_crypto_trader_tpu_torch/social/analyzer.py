"""Social-metrics analytics: normalization, anomaly detection, lead/lag
cross-correlation, sentiment accuracy, adaptive source weights.

Port of `ai_crypto_trader_tpu/social/analyzer.py:27-124` (the reference's
SocialMetricsAnalyzer, `services/utils/social_metrics_analyzer.py`):

  * `normalize_metrics` — robust min-max between the 5th and 95th
    percentiles (`jnp.percentile`'s linear interpolation, with the one
    fused multiply-add XLA makes of it);
  * `fit_anomaly_model` / `detect_anomalies` — a Mahalanobis-distance
    detector (mean + float32 covariance with the 1e-6 ridge, its inverse,
    a percentile threshold: `contamination` of the training data flagged);
  * `lead_lag_correlation` — Pearson correlation of social[t − lag] with
    returns[t] for every lag in [-max_lag, max_lag] at once, over a [L, T]
    gather of the rolled series (positive lag = social leads price);
  * `sentiment_accuracy` — directional hit rate of bullish / bearish
    sentiment over a horizon (integer counts in int32, their ratios
    float32, as the JAX package's dtypes);
  * `adaptive_source_weights` — sources re-weighted by that accuracy (host).

Entry points take ``device=None``, the CUDA card; their outputs stay on the
device but for `adaptive_source_weights`, which returns Python floats.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ai_crypto_trader_tpu_torch.device import div_const, plus_product, resolve_device, to_device

_F = np.float32


def _percentile(x, p: float, dim: int = 0):
    """``jnp.percentile(x, p, axis=dim)`` as the JAX package's compiled
    program computes it: q = p / 100 in float32, the sorted values at
    floor and ceil of q·(n − 1), and ``low·lw + high·hw`` with the first
    product and the sum rounded once (XLA's fused multiply-add; the
    separately rounded form differs by an ulp in ~1 of 8 columns).  The
    ranks are host integers: nothing is read back."""
    a = torch.sort(x, dim=dim).values
    n = a.shape[dim]
    pos = (_F(p) / _F(100.0)) * _F(n - 1)
    low, high = _F(np.floor(pos)), _F(np.ceil(pos))
    hw = _F(pos - low)
    lw = _F(_F(1.0) - hw)
    lv = a.select(dim, int(np.clip(low, 0, n - 1)))
    hv = a.select(dim, int(np.clip(high, 0, n - 1)))
    out = plus_product(hv * float(hw), lv, float(lw))
    return torch.where(torch.isnan(x).any(dim), torch.nan, out)


def normalize_metrics(x, device=None) -> torch.Tensor:
    """[T, F] → [0, 1] per feature using 5th/95th percentile bounds
    (robust to the outliers social feeds are full of)."""
    x = to_device(x, resolve_device(device), torch.float32)
    lo = _percentile(x, 5.0)
    hi = _percentile(x, 95.0)
    rng = torch.where(hi - lo == 0.0, 1.0, hi - lo)
    return torch.clamp((x - lo) / rng, 0.0, 1.0)


class AnomalyModel(NamedTuple):
    mean: torch.Tensor       # [F]
    prec: torch.Tensor       # [F, F] inverse covariance
    threshold: torch.Tensor  # squared-distance cutoff


def _sq_distance(xc, prec):
    """xc_t · prec · xc_t for every row t."""
    return torch.sum((xc @ prec) * xc, dim=-1)


def fit_anomaly_model(x, contamination: float = 0.05, device=None) -> AnomalyModel:
    """Fit on [T, F] history; threshold set so ``contamination`` of the
    training data is flagged (IsolationForest-equivalent contract)."""
    x = to_device(x, resolve_device(device), torch.float32)
    mean = torch.mean(x, dim=0)
    xc = x - mean
    cov = div_const(xc.T @ xc, x.shape[0]) + 1e-6 * torch.eye(x.shape[1], device=x.device)
    # inv_ex: the inverse without inv's singularity check, a read to the host
    prec = torch.linalg.inv_ex(cov).inverse
    d2 = _sq_distance(xc, prec)
    threshold = _percentile(d2, 100.0 * (1.0 - contamination))
    return AnomalyModel(mean, prec, threshold)


def detect_anomalies(model: AnomalyModel, x, device=None):
    """Returns (is_anomaly [T] bool, score [T] — distance / threshold)."""
    dev = resolve_device(device)
    model = AnomalyModel(*(to_device(v, dev, torch.float32) for v in model))
    xc = to_device(x, dev, torch.float32) - model.mean
    d2 = _sq_distance(xc, model.prec)
    return d2 > model.threshold, d2 / torch.clamp_min(model.threshold, 1e-9)


def lead_lag_correlation(social, returns, max_lag: int = 24, device=None):
    """Pearson correlation of social[t-lag] vs returns[t] for lag ∈
    [-max_lag, max_lag] (positive lag = social LEADS price), over the pairs
    that do not wrap around.

    Returns (lags [L] int32, correlations [L]); the argmax lag is the
    detected lead (`social_metrics_analyzer.py:321-456`)."""
    dev = resolve_device(device)
    social = to_device(social, dev, torch.float32)
    returns = to_device(returns, dev, torch.float32)
    T = social.shape[0]
    lags = torch.arange(-max_lag, max_lag + 1, device=dev)
    t = torch.arange(T, device=dev)
    s = social[(t[None, :] - lags[:, None]) % T]                  # roll(social, lag)
    mask = (t[None, :] >= torch.clamp_min(lags, 0)[:, None]) & \
        (t[None, :] < T + torch.clamp_max(lags, 0)[:, None])
    w = mask.to(torch.float32)
    n = torch.clamp_min(torch.sum(w, dim=1, keepdim=True), 1.0)
    ms = torch.sum(s * w, dim=1, keepdim=True) / n
    mr = torch.sum(returns * w, dim=1, keepdim=True) / n
    cov = torch.sum((s - ms) * (returns - mr) * w, dim=1) / n[:, 0]
    vs = torch.sum((s - ms) ** 2 * w, dim=1) / n[:, 0]
    vr = torch.sum((returns - mr) ** 2 * w, dim=1) / n[:, 0]
    denom = torch.sqrt(vs * vr)
    return lags.to(torch.int32), torch.where(denom > 0, cov / denom, 0.0)


def sentiment_accuracy(sentiment, close, horizon: int = 12, neutral_band: float = 0.05,
                       device=None) -> dict:
    """Directional hit rate: bullish sentiment (>0.5+band) predicting an
    up-move over ``horizon``, bearish predicting down
    (`social_metrics_analyzer.py:457-634`).  0-d tensors: accuracy and
    coverage float32, n_calls int32."""
    dev = resolve_device(device)
    sentiment = to_device(sentiment, dev, torch.float32)
    close = to_device(close, dev, torch.float32)
    fwd = torch.roll(close, -horizon) / close - 1.0
    t = torch.arange(close.shape[0], device=dev)
    valid = t < close.shape[0] - horizon
    bullish = sentiment > 0.5 + neutral_band
    bearish = sentiment < 0.5 - neutral_band
    decided = (bullish | bearish) & valid
    correct = (bullish & (fwd > 0)) | (bearish & (fwd < 0))
    count = lambda m: torch.sum(m).to(torch.int32)  # noqa: E731
    n_calls = count(decided)
    return {
        "accuracy": count(correct & decided) / torch.clamp_min(n_calls, 1),
        "n_calls": n_calls,
        "coverage": n_calls / torch.clamp_min(count(valid), 1),
    }


def adaptive_source_weights(per_source_sentiment: dict, close, horizon: int = 12,
                            floor: float = 0.05, device=None) -> dict[str, float]:
    """Re-weight sources by their directional accuracy (:635): weight ∝
    max(accuracy - 0.5, floor) so a coin-flip source decays toward the
    floor rather than zero.  One read of the accuracies."""
    dev = resolve_device(device)
    close = to_device(close, dev, torch.float32)
    names = list(per_source_sentiment)
    acc = torch.stack([sentiment_accuracy(per_source_sentiment[n], close, horizon,
                                          device=dev)["accuracy"] for n in names])
    raw = {n: max(float(a) - 0.5, floor) for n, a in zip(names, acc.cpu().numpy())}
    total = sum(raw.values())
    return {k: v / total for k, v in raw.items()}
