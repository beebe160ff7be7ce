"""The chart-pattern classifier of the port, serving (`patterns.model`)."""

from ai_crypto_trader_tpu_torch.patterns.model import (  # noqa: F401
    PATTERN_CLASSES,
    PATTERN_IMPLICATIONS,
    PatternRecognizer,
    detect_patterns,
    pattern_completion,
    preprocess_window,
)
