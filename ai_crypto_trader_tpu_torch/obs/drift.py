"""Feature-drift spec: the per-feature PSI the tick program computes.

The port's own copy of `ai_crypto_trader_tpu/obs/drift.py` (lines 31-78),
NumPy only.  The Population Stability Index compares the live distribution
of a signal feature over the candle window against a reference
distribution (training time, or the first full window observed after
warm-up):

    PSI = sum_bins (p_live - p_ref) * ln(p_live / p_ref)

with epsilon smoothing so empty bins don't blow up.  The classic reading:
< 0.1 stable, 0.1-0.25 moderate shift, > 0.25 significant drift.

The histograms themselves are made inside the tick program
(`ops.tick_engine`); this module owns the spec (which features, what
ranges, how many bins) and the host-side helpers.  Bin ranges are fixed
per feature; out-of-range values clamp into the edge bins, so a mass
migration past the range shows up as edge-bin inflation.
"""

from __future__ import annotations

import numpy as np

N_BINS = 16
PSI_EPS = 1e-4
PSI_ALERT_THRESHOLD = 0.25

# (name, lo, hi): the engine series each row bins.  `macd_norm` is
# macd / close (the raw MACD scales with price); the rest are naturally
# bounded.
DRIFT_FEATURES = (
    ("rsi", 0.0, 100.0),
    ("stoch_k", 0.0, 100.0),
    ("bb_position", -0.5, 1.5),
    ("macd_norm", -0.02, 0.02),
    ("volatility", 0.0, 0.05),
)


def feature_names() -> tuple:
    return tuple(name for name, _, _ in DRIFT_FEATURES)


def reference_histogram(series: dict) -> np.ndarray:
    """[K, N_BINS] reference probabilities from host-side feature arrays
    (training-time stats: the same features the engine computes over the
    training window).  Missing features get a uniform row, which the
    engine's first-window capture overwrites."""
    out = np.full((len(DRIFT_FEATURES), N_BINS), 1.0 / N_BINS, np.float32)
    for k, (name, lo, hi) in enumerate(DRIFT_FEATURES):
        x = series.get(name)
        if x is None:
            continue
        x = np.asarray(x, np.float64).ravel()
        x = x[np.isfinite(x)]
        if x.size == 0:
            continue
        idx = np.clip(((x - lo) / (hi - lo) * N_BINS).astype(np.int64),
                      0, N_BINS - 1)
        counts = np.bincount(idx, minlength=N_BINS).astype(np.float32)
        out[k] = counts / counts.sum()
    return out


def psi(live: np.ndarray, ref: np.ndarray) -> np.ndarray:
    """Host-side PSI twin of the in-program computation.  ``live`` and
    ``ref`` are [..., N_BINS] probabilities."""
    p = np.asarray(live, np.float64) + PSI_EPS
    q = np.asarray(ref, np.float64) + PSI_EPS
    return ((p - q) * np.log(p / q)).sum(axis=-1)
