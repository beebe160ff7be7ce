"""The price-prediction model zoo of the port and its serving path
(`models.zoo`, `models.fused_lstm`, `models.train`)."""

from ai_crypto_trader_tpu_torch.models.zoo import (  # noqa: F401
    MODEL_REGISTRY,
    build_model,
)
from ai_crypto_trader_tpu_torch.models.train import (  # noqa: F401
    Scaler,
    TrainResult,
    fit_scaler,
    make_windows,
    predict_prices,
)
