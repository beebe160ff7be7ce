from ai_crypto_trader_tpu_torch.data.synthetic import generate_ohlcv  # noqa: F401
from ai_crypto_trader_tpu_torch.data.ingest import (  # noqa: F401
    OHLCV,
    from_dict,
    load_csv,
)
