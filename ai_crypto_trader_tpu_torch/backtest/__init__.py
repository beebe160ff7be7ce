from ai_crypto_trader_tpu_torch.backtest.signals import (  # noqa: F401
    SignalFeatures,
    compute_signal_features,
    position_size,
    reference_signal,
)
from ai_crypto_trader_tpu_torch.backtest.strategy import (  # noqa: F401
    PARAM_RANGES,
    StrategyParams,
    clamp_params,
    default_params,
    sample_params,
)
from ai_crypto_trader_tpu_torch.backtest.engine import (  # noqa: F401
    BacktestInputs,
    BacktestStats,
    prepare_inputs,
    run_backtest,
    sweep,
)
from ai_crypto_trader_tpu_torch.backtest.metrics import compute_metrics  # noqa: F401
