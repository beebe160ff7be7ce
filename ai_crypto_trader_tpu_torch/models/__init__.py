"""The price-prediction model zoo of the port: its modules (`models.zoo`,
`models.fused_lstm`, `models.layers`), training and prediction
(`models.train`, `models.train_loop`), HPO (`models.hpo`), feature
importance (`models.importance`), the prediction service
(`models.service`) and the long-context transformer
(`models.long_context`)."""

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
    predict_prices_batched,
    train_model,
)
from ai_crypto_trader_tpu_torch.models.hpo import optimize_hyperparameters  # noqa: F401
from ai_crypto_trader_tpu_torch.models.train_loop import (  # noqa: F401
    EpochTrainer,
    snapshot_params,
)
from ai_crypto_trader_tpu_torch.models.importance import feature_importance  # noqa: F401
from ai_crypto_trader_tpu_torch.models.long_context import (  # noqa: F401
    LongContextBlock,
    LongContextTransformer,
    RingSelfAttention,
    long_context_loss,
)
