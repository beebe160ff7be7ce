"""Sliding-window quantiles for the observatories.

The port's own copy of the two helpers of `ai_crypto_trader_tpu/utils/
devprof.py` (lines 69-104) that `obs.tickpath` folds its phases with:
`percentile` and `SlidingQuantiles`.  The rest of the JAX module (cost
cards, SLO burn rates, donation checks) is not ported yet.
"""

from __future__ import annotations

from collections import deque


def percentile(values, q: float) -> float:
    """Nearest-rank percentile over an unsorted sequence (0 when empty).
    No numpy: this runs on hot-path export with tiny windows."""
    if not values:
        return 0.0
    s = sorted(values)
    idx = max(0, min(len(s) - 1, round(q / 100.0 * (len(s) - 1))))
    return s[idx]


class SlidingQuantiles:
    """Bounded-window quantile estimator: observations land in a deque of
    ``window`` samples; quantiles are exact over that window (long-run
    decay for free — old samples fall off the back)."""

    def __init__(self, window: int = 1024):
        self.buf: deque = deque(maxlen=window)
        self.count = 0                       # total ever observed

    def observe(self, value: float) -> None:
        self.buf.append(float(value))
        self.count += 1

    def quantile(self, q: float) -> float:
        return percentile(self.buf, q)

    def frac_over(self, threshold: float) -> float:
        """Fraction of the current window exceeding ``threshold``."""
        if not self.buf:
            return 0.0
        return sum(1 for v in self.buf if v > threshold) / len(self.buf)

    def summary(self) -> dict:
        return {"count": self.count, "window": len(self.buf),
                "p50": self.quantile(50), "p99": self.quantile(99)}
