"""Market-regime detection: rules + k-means / GMM / HMM, with the cluster →
regime-name mapping of the reference.

Port of `ai_crypto_trader_tpu/regime/detector.py`:

  * `regime_features` — return, rolling volatility, trend slope, RSI, MACD
    (price-normalised) and Bollinger width per candle, through the port's
    `ops.rsi`, `ops.macd` and `ops.bollinger`: the EMA family goes through
    `ops.ewma.fused_ewma`, the CUDA kernel on the card (four launches a
    call: RSI's, MACD's two EMAs and its signal);
  * standardisation, and PCA when there are more features than
    ``pca_components``; the kmeans / gmm / hmm back ends
    (`regime.cluster`, `regime.hmm`) and the branch-free threshold rules;
  * cluster → regime name by mean return and volatility rank: highest
    return → bull, lowest → bear, highest volatility of the rest →
    volatile, the rest ranging;
  * `RegimeDetector.detect` → (regime, confidence, probabilities over
    `REGIME_NAMES`) of the last candle; `label_series` → per-candle labels.

The trend slope is the JAX package's convolution with the time ramp,
summed here in float64 and rounded once, so it agrees with the JAX
package's float32 convolution within float32 rounding, not bit for bit.
k-means' one draw (the first centroid) comes from a ``torch.Generator``
seeded with ``seed`` on the detector's device, or from ``key`` when given
(an integer index: a test hands over the JAX package's draw).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from ai_crypto_trader_tpu_torch import ops
from ai_crypto_trader_tpu_torch.device import div_const, resolve_device, to_device
from ai_crypto_trader_tpu_torch.mc.engine import quantile
from ai_crypto_trader_tpu_torch.regime import cluster as cl
from ai_crypto_trader_tpu_torch.regime import hmm as hmm_mod

REGIME_NAMES = ("bull", "bear", "ranging", "volatile")


def regime_features(ohlcv: dict, window: int = 20, device=None) -> torch.Tensor:
    """[T, 6] feature matrix on ``device`` (None: the CUDA card): return,
    rolling volatility, trend slope, RSI, MACD (price-normalised),
    Bollinger width."""
    close = to_device(ohlcv["close"], resolve_device(device), torch.float32)
    lc = torch.log(close)
    ret = lc - torch.cat([lc[:1], lc[:-1]])
    vol = ops.nanfill(ops.rolling_std(ret, window))
    # trend slope: the per-candle OLS slope of close over the window,
    # normalised by price so it is scale-free
    slope = ops.nanfill(_rolling_slope(close, window)) / close
    rsi = div_const(ops.nanfill(ops.rsi(close)), 100.0)
    macd_line, _, _ = ops.macd(close)
    macd_n = ops.nanfill(macd_line) / close
    bbw = ops.nanfill(ops.bollinger(close).width)
    return torch.stack([ret, vol, slope, rsi, macd_n, bbw], dim=-1)


def _rolling_slope(x, window: int):
    """OLS slope of x on t over a trailing window: Σᵢ (i − t̄)·x_{t−w+1+i} /
    Σᵢ (i − t̄)², the JAX package's ``convolve(x, ramp[::-1], "full")[:T]``
    — a cross-correlation of the left-zero-padded series with the ramp,
    summed in float64."""
    t_mean = (window - 1) / 2.0
    ss_t = window * (window * window - 1) / 12.0      # Σ (i − t̄)²
    ramp = torch.arange(window, dtype=torch.float32, device=x.device) - t_mean
    xp = F.pad(x.double(), (window - 1, 0))
    tx = F.conv1d(xp.view(1, 1, -1), ramp.double().view(1, 1, -1)).view(-1).float()
    tx = torch.where(torch.arange(x.shape[0], device=x.device) < window - 1, torch.nan, tx)
    return div_const(tx, ss_t)


def rules_regime(features: torch.Tensor, slope_thresh: float = 5e-5,
                 vol_quantile: float = 0.8) -> torch.Tensor:
    """Branch-free threshold rules: high volatility → volatile; else the
    slope's sign picks bull / bear; flat → ranging.  [T] int32 labels
    indexing REGIME_NAMES."""
    vol, slope = features[:, 1], features[:, 2]
    vol_hi = vol > quantile(vol, vol_quantile)
    lbl = torch.where(vol_hi, 3, torch.where(slope > slope_thresh, 0,
                                             torch.where(slope < -slope_thresh, 1, 2)))
    return lbl.to(torch.int32)


def _name_clusters(features, labels, k: int):
    """Cluster index → regime-name index by return / volatility ranking
    (host NumPy, as the JAX package's)."""
    feats = np.asarray(features)
    labels = np.asarray(labels)
    counts = np.array([(labels == c).sum() for c in range(k)])
    rets = np.array([feats[labels == c, 0].mean() if counts[c] else np.nan for c in range(k)])
    vols = np.array([feats[labels == c, 1].mean() if counts[c] else np.nan for c in range(k)])
    mapping = np.full(k, 2, dtype=np.int32)          # default ranging
    occupied = np.where(counts > 0)[0]
    if len(occupied) == 0:
        return mapping
    # rank only occupied clusters: an empty one must never take bull/bear
    bull = int(occupied[np.nanargmax(rets[occupied])])
    bear = int(occupied[np.nanargmin(rets[occupied])])
    mapping[bull] = 0
    if bear != bull:
        mapping[bear] = 1
    remaining = [c for c in occupied if c not in (bull, bear)]
    if remaining:
        mapping[max(remaining, key=lambda c: vols[c])] = 3   # volatile
    return mapping


@dataclass
class RegimeDetector:
    """fit / detect façade over the back ends, on ``device`` (None: the
    CUDA card).  ``key`` overrides the seeded draw of k-means' first
    centroid (a generator or an integer index)."""

    method: str = "kmeans"      # kmeans | gmm | hmm | rules
    n_regimes: int = 4
    pca_components: int = 5
    seed: int = 0
    device: Any = None
    key: Any = None
    _state: dict = field(default_factory=dict)

    def __post_init__(self):
        self.device = resolve_device(self.device)

    def _key(self):
        if self.key is not None:
            return self.key
        return torch.Generator(self.device).manual_seed(self.seed)

    def fit(self, ohlcv: dict) -> "RegimeDetector":
        feats = regime_features(ohlcv, device=self.device)
        std = cl.standardize_fit(feats, device=self.device)
        z = std.transform(feats)
        pca = None
        if z.shape[1] > self.pca_components:
            pca = cl.pca_fit(z, self.pca_components, device=self.device)
            z = pca.transform(z)
        dev = self.device
        if self.method == "kmeans":
            model = cl.kmeans_fit(self._key(), z, self.n_regimes, device=dev)
            labels = cl.kmeans_predict(model, z)
        elif self.method == "gmm":
            model = cl.gmm_fit(self._key(), z, self.n_regimes, device=dev)
            labels = torch.argmax(cl.gmm_predict_proba(model, z), dim=1)
        elif self.method == "hmm":
            model = hmm_mod.hmm_fit(self._key(), z, self.n_regimes, device=dev)
            labels = hmm_mod.hmm_viterbi(model, z)
        elif self.method == "rules":
            model, labels = None, rules_regime(feats)
        else:
            raise ValueError(f"unknown regime method {self.method!r}")
        if self.method == "rules":
            mapping = np.arange(self.n_regimes, dtype=np.int32)
        else:
            # one read: the return and volatility columns beside the labels
            host = torch.cat([feats[:, :2], labels[:, None].float()], dim=1).cpu().numpy()
            mapping = _name_clusters(host[:, :2], host[:, 2].astype(np.int64), self.n_regimes)
        self._state = {"std": std, "pca": pca, "model": model, "mapping": mapping}
        return self

    def _project(self, ohlcv: dict):
        feats = regime_features(ohlcv, device=self.device)
        z = self._state["std"].transform(feats)
        if self._state["pca"] is not None:
            z = self._state["pca"].transform(z)
        return feats, z

    def detect(self, ohlcv: dict) -> dict:
        """Regime of the final candle: name, confidence, the probability of
        each of REGIME_NAMES.  One read of the card."""
        feats, z = self._project(ohlcv)
        mapping = self._state["mapping"]
        probs4 = np.zeros(4, dtype=np.float64)
        if self.method == "rules":
            probs4[int(rules_regime(feats)[-1].cpu())] = 1.0
        else:
            if self.method == "kmeans":
                d = cl._sq_dists(z[-1:], self._state["model"].centroids)[0].cpu().numpy()
                sim = np.exp(-d / (d.mean() + 1e-9))
                p = sim / sim.sum()
            elif self.method == "gmm":
                p = cl.gmm_predict_proba(self._state["model"], z[-1:])[0].cpu().numpy()
            else:
                gamma, _ = hmm_mod.hmm_posteriors(self._state["model"], z)
                p = gamma[-1].cpu().numpy()
            for c, pr in enumerate(p):
                probs4[mapping[c]] += pr
        idx = int(np.argmax(probs4))
        return {"regime": REGIME_NAMES[idx],
                "confidence": float(probs4[idx]),
                "probabilities": {n: float(probs4[i]) for i, n in enumerate(REGIME_NAMES)}}

    def label_series(self, ohlcv: dict) -> np.ndarray:
        """Per-candle regime labels (NumPy)."""
        feats, z = self._project(ohlcv)
        model = self._state["model"]
        if self.method == "kmeans":
            lbl = cl.kmeans_predict(model, z)
        elif self.method == "gmm":
            lbl = torch.argmax(cl.gmm_predict_proba(model, z), dim=1)
        elif self.method == "hmm":
            lbl = hmm_mod.hmm_viterbi(model, z)
        else:
            return rules_regime(feats).cpu().numpy()
        return self._state["mapping"][lbl.cpu().numpy()]
