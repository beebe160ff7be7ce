from ai_crypto_trader_tpu_torch.data.synthetic import generate_ohlcv  # noqa: F401
from ai_crypto_trader_tpu_torch.data.ingest import (  # noqa: F401
    OHLCV,
    SocialDaily,
    from_dict,
    klines_to_arrays,
    load_csv,
    load_social_csv,
    save_csv,
    save_social_csv,
)
