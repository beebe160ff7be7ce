"""Market-regime detection on the card: features through the EWMA kernel,
standardise / PCA / k-means / GMM / HMM, the rules, and the services
around them."""

from ai_crypto_trader_tpu_torch.regime.detector import (  # noqa: F401
    REGIME_NAMES,
    RegimeDetector,
    regime_features,
    rules_regime,
)
from ai_crypto_trader_tpu_torch.regime.cluster import (  # noqa: F401
    gmm_fit,
    gmm_predict_proba,
    kmeans_fit,
    kmeans_predict,
    pca_fit,
    standardize_fit,
)
from ai_crypto_trader_tpu_torch.regime.hmm import (  # noqa: F401
    hmm_fit,
    hmm_posteriors,
    hmm_viterbi,
)
from ai_crypto_trader_tpu_torch.regime.collector import RegimeDataCollector  # noqa: F401
from ai_crypto_trader_tpu_torch.regime.service import MarketRegimeService  # noqa: F401
