from ai_crypto_trader_tpu_torch.ops.indicators import (  # noqa: F401
    INDICATOR_NAMES,
    atr,
    bollinger,
    compute_indicators,
    ema,
    ffill,
    first_order_recursion,
    ichimoku,
    macd,
    nanfill,
    obv,
    roc,
    rolling_max,
    rolling_mean,
    rolling_min,
    rolling_std,
    rolling_sum,
    rsi,
    sma,
    stochastic,
    true_range,
    vwap,
    williams_r,
)
from ai_crypto_trader_tpu_torch.ops.ewma import fused_ewma  # noqa: F401
from ai_crypto_trader_tpu_torch.ops.volume_profile import volume_profile  # noqa: F401
from ai_crypto_trader_tpu_torch.ops.combinations import (  # noqa: F401
    combination_signal,
    combined_indicators,
)
from ai_crypto_trader_tpu_torch.ops.tick_engine import TickEngine  # noqa: F401
from ai_crypto_trader_tpu_torch.ops.tenant_engine import TenantEngine  # noqa: F401
