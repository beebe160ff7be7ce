"""Per-stage crash-loop supervision for the single-loop launcher.

The reference survives a crashing service because each one is a container
docker-compose restarts (SURVEY §5.3).  Here every stage shares one event
loop, so one stage throwing on every tick must be ISOLATED, not allowed to
kill `run()` — but also must not silently spin: a stage that fails
``max_failures`` consecutive times is quarantined (withheld from the loop,
its heartbeat goes stale, a ServiceCrashLoop alert fires) and is only
probed again after ``quarantine_s`` — the in-process equivalent of a
restart-backoff + CrashLoopBackOff policy.

Deterministic: the clock is whatever ``now`` the caller passes in.

The port's own copy of `ai_crypto_trader_tpu/utils/supervision.py`.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class StageBreaker:
    """Failure accounting + gating for ONE pipeline stage."""

    name: str
    max_failures: int = 3            # consecutive failures → quarantine
    base_backoff_s: float = 2.0      # skip window after the 1st failure
    max_backoff_s: float = 60.0
    quarantine_s: float = 300.0      # probe retry cadence once quarantined
    failures: int = 0                # consecutive (reset on success)
    total_failures: int = 0
    quarantined: bool = False
    quarantined_at: float | None = None
    last_error: str | None = None
    _retry_at: float = field(default=-1e18)

    def should_run(self, now: float) -> bool:
        """Gate: False while inside a backoff window or quarantined (a
        quarantine probe is allowed every ``quarantine_s``)."""
        return now >= self._retry_at

    def record_success(self, now: float) -> bool:
        """Returns True when this success ENDS a quarantine (recovery)."""
        recovered = self.quarantined
        self.failures = 0
        self.quarantined = False
        self.quarantined_at = None
        self._retry_at = -1e18
        return recovered

    def record_failure(self, now: float, error: str = "") -> bool:
        """Returns True exactly when this failure TRIPS the quarantine
        (callers fire the ServiceCrashLoop alert on that edge)."""
        self.failures += 1
        self.total_failures += 1
        self.last_error = error
        if self.failures >= self.max_failures:
            tripped = not self.quarantined
            self.quarantined = True
            if tripped:
                self.quarantined_at = now
            self._retry_at = now + self.quarantine_s
            return tripped
        self._retry_at = now + min(
            self.base_backoff_s * 2.0 ** (self.failures - 1),
            self.max_backoff_s)
        return False

    def state(self) -> dict:
        return {"failures": self.failures,
                "total_failures": self.total_failures,
                "quarantined": self.quarantined,
                "last_error": self.last_error}
