"""Circuit breaker + retry-with-backoff for external I/O.

Capability parity with `services/utils/circuit_breaker.py`: the CLOSED /
OPEN / HALF_OPEN state machine (CircuitState :14, CircuitBreaker :31-208),
sync+async callables, a process-global registry (`get_circuit_breaker:281`),
and `retry_with_backoff:227` with exponential backoff + jitter.  Wired by
the shell exactly where the reference wires it: exchange (3 failures/30 s)
and bus access (`market_monitor_service.py:96-115`).

Deterministic: time and jitter are injectable (`now_fn`, `rng`).

The port's own copy of `ai_crypto_trader_tpu/utils/circuit_breaker.py`.
"""

from __future__ import annotations

import asyncio
import enum
import random
import time
from dataclasses import dataclass, field
from typing import Any, Callable


class CircuitState(enum.Enum):
    CLOSED = "closed"
    OPEN = "open"
    HALF_OPEN = "half_open"


@dataclass
class CircuitBreaker:
    name: str
    failure_threshold: int = 3
    reset_timeout_s: float = 30.0
    half_open_max_calls: int = 1
    now_fn: Callable[[], float] = time.time

    state: CircuitState = CircuitState.CLOSED
    failures: int = 0
    opened_at: float = 0.0
    half_open_calls: int = 0
    stats: dict = field(default_factory=lambda: {
        "calls": 0, "failures": 0, "rejected": 0, "state_changes": []})

    def _transition(self, new: CircuitState):
        if new is not self.state:
            self.stats["state_changes"].append((self.state.value, new.value,
                                                self.now_fn()))
            self.state = new

    def _pre_call(self) -> bool:
        """True if the call may proceed."""
        if self.state is CircuitState.OPEN:
            if self.now_fn() - self.opened_at >= self.reset_timeout_s:
                self._transition(CircuitState.HALF_OPEN)
                self.half_open_calls = 0
            else:
                self.stats["rejected"] += 1
                return False
        if self.state is CircuitState.HALF_OPEN:
            if self.half_open_calls >= self.half_open_max_calls:
                self.stats["rejected"] += 1
                return False
            self.half_open_calls += 1
        return True

    def _on_success(self):
        if self.state is CircuitState.HALF_OPEN:
            self._transition(CircuitState.CLOSED)
        self.failures = 0

    def _on_failure(self):
        self.failures += 1
        self.stats["failures"] += 1
        if (self.state is CircuitState.HALF_OPEN
                or self.failures >= self.failure_threshold):
            self._transition(CircuitState.OPEN)
            self.opened_at = self.now_fn()

    # Public surface for callers that manage their own try/except around the
    # protected operation (e.g. ResilientExchange, which retries reads
    # before deciding the op failed). call()/call_async() are built on it.
    def allow(self) -> bool:
        """Whether a call may proceed now (advances OPEN→HALF_OPEN)."""
        return self._pre_call()

    def record_success(self):
        self._on_success()

    def record_failure(self):
        self._on_failure()

    def call(self, fn: Callable, *args, **kw) -> Any | None:
        """Invoke fn under the breaker; returns None when rejected/failed
        (the reference's decorated services treat that as a skipped cycle)."""
        if not self.allow():
            return None
        self.stats["calls"] += 1
        try:
            out = fn(*args, **kw)
        except Exception:
            self.record_failure()
            return None
        self.record_success()
        return out

    async def call_async(self, fn: Callable, *args, **kw) -> Any | None:
        if not self.allow():
            return None
        self.stats["calls"] += 1
        try:
            out = await fn(*args, **kw)
        except Exception:
            self.record_failure()
            return None
        self.record_success()
        return out


_REGISTRY: dict[str, CircuitBreaker] = {}


def get_circuit_breaker(name: str, **kw) -> CircuitBreaker:
    """Global registry (`circuit_breaker.py:281`)."""
    if name not in _REGISTRY:
        _REGISTRY[name] = CircuitBreaker(name, **kw)
    return _REGISTRY[name]


def backoff_delays(max_retries: int, base_delay_s: float = 0.5,
                   max_delay_s: float = 30.0, jitter: float = 0.1,
                   rng: random.Random | None = None):
    """Yield the jittered delay before each retry — the single backoff
    schedule shared by retry_with_backoff and sync callers
    (ResilientExchange)."""
    rng = rng or random.Random()
    for attempt in range(max_retries):
        delay = min(base_delay_s * 2**attempt, max_delay_s)
        yield delay * (1.0 + jitter * rng.random())


async def retry_with_backoff(fn: Callable, *args, max_retries: int = 3,
                             base_delay_s: float = 0.5, max_delay_s: float = 30.0,
                             jitter: float = 0.1,
                             rng: random.Random | None = None,
                             sleep=asyncio.sleep, **kw):
    """Exponential backoff + jitter (`circuit_breaker.py:227`)."""
    delays = backoff_delays(max_retries, base_delay_s, max_delay_s, jitter, rng)
    last_exc: Exception | None = None
    for attempt in range(max_retries + 1):
        try:
            result = fn(*args, **kw)
            if asyncio.iscoroutine(result):
                result = await result
            return result
        except Exception as exc:                      # noqa: BLE001
            last_exc = exc
            delay = next(delays, None)
            if delay is None:
                break
            await sleep(delay)
    raise last_exc  # type: ignore[misc]
