"""Host utilities of the port: the circuit breaker and token bucket of the
exchange seam, checkpoints, the metrics registry, tracing, the write-ahead
journal, symbol helpers, and the trading system's rim: alerts, health,
saturation, stage supervision and the structured log."""

from ai_crypto_trader_tpu_torch.utils.circuit_breaker import (  # noqa: F401
    CircuitBreaker,
    CircuitState,
    get_circuit_breaker,
    retry_with_backoff,
)
from ai_crypto_trader_tpu_torch.utils.rate_limiter import TokenBucket  # noqa: F401
from ai_crypto_trader_tpu_torch.utils.checkpoint import (  # noqa: F401
    load_checkpoint,
    save_checkpoint,
)
from ai_crypto_trader_tpu_torch.utils.metrics import MetricsRegistry  # noqa: F401
