"""The chart-pattern classifier of the port (`patterns.model`), its
synthetic training data (`patterns.synthetic`) and the pattern service
over it (`patterns.service`)."""

from ai_crypto_trader_tpu_torch.patterns.synthetic import (  # noqa: F401
    PATTERN_CLASSES,
    generate_dataset,
    generate_pattern,
)
from ai_crypto_trader_tpu_torch.patterns.model import (  # noqa: F401
    PATTERN_IMPLICATIONS,
    PatternRecognizer,
    detect_patterns,
    pattern_completion,
    preprocess_window,
    train_pattern_model,
)
from ai_crypto_trader_tpu_torch.patterns.service import (  # noqa: F401
    ChartPatternService,
    pattern_trading_signals,
)
