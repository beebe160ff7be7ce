"""Static-shape hygiene helpers: geometric length buckets.

The port's own copy of `ai_crypto_trader_tpu/utils/shapes.py`.  Host code
that feeds the device from GROWING histories (the structure search's candle
accumulator) takes the LAST ``bucket_len(n)`` samples, so the device sees
O(log) distinct shapes over a process's lifetime — for the JAX package one
compiled program each, for the port one set of cached allocations each.
"""

from __future__ import annotations

# Geometric (~1.5×) length buckets shared by the growing-history call sites.
LEN_BUCKETS = (8, 12, 16, 24, 32, 48, 64, 96, 128, 192, 256, 384, 512)


def bucket_len(n: int, buckets: tuple = LEN_BUCKETS) -> int | None:
    """Largest bucket ≤ n (None when n is below the smallest bucket)."""
    fit = None
    for b in buckets:
        if b <= n:
            fit = b
    return fit
