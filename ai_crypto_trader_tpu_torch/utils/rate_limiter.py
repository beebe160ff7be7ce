"""Token-bucket rate limiter (parity with `services/utils/rate_limiter.py`,
used for exchange/LLM API quotas). Deterministic via injectable clock.

The port's own copy of `ai_crypto_trader_tpu/utils/rate_limiter.py`.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable


@dataclass
class TokenBucket:
    rate_per_s: float
    capacity: float
    now_fn: Callable[[], float] = time.time
    tokens: float = field(default=-1.0)
    last_refill: float = field(default=-1.0)

    def __post_init__(self):
        if self.tokens < 0:
            self.tokens = self.capacity
        if self.last_refill < 0:
            self.last_refill = self.now_fn()

    def _refill(self):
        now = self.now_fn()
        self.tokens = min(self.capacity,
                          self.tokens + (now - self.last_refill) * self.rate_per_s)
        self.last_refill = now

    def try_acquire(self, n: float = 1.0) -> bool:
        self._refill()
        if self.tokens >= n:
            self.tokens -= n
            return True
        return False

    def wait_time(self, n: float = 1.0) -> float:
        """Seconds until n tokens would be available."""
        self._refill()
        deficit = max(n - self.tokens, 0.0)
        return deficit / self.rate_per_s if deficit else 0.0
