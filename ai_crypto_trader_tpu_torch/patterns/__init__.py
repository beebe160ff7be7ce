"""The chart-pattern classifier of the port (`patterns.model`) and its
synthetic training data (`patterns.synthetic`)."""

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
