"""The yardstick of the rooflines: the card's published peaks and the work
each layer's call needs, counted from its shapes alone.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at its 700 W
limit): float32 outside the tensor cores 67 TFLOP/s, HBM 3.35 TB/s.  The
least time of a call is the larger of its operations over the FLOP peak and
its bytes over the bandwidth peak; a roofline share is that least time over
the call's device time.  The counts do not depend on what implements the
call: each input byte is read once, each output byte written once, and the
operations are those the inputs need.
"""

from __future__ import annotations

PEAK_FLOPS_F32 = 67e12
PEAK_BYTES_PER_S = 3.35e12
F32 = 4

REPLAY_STREAMS = 9          # close, signal, strength, volatility, volume,
#                             confidence, decision, the two stop overrides
REPLAY_PARAMS = 2           # stop_loss, take_profit of each strategy
REPLAY_STATS = 14           # the stats written for each strategy
WARMUP = 10


def least_time(ops: float, nbytes: float) -> tuple[float, str]:
    """(seconds, "operations" or "bytes"): the larger bound and its name."""
    t_ops, t_bytes = ops / PEAK_FLOPS_F32, nbytes / PEAK_BYTES_PER_S
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def replay_work(T: int, B: int) -> tuple[float, float]:
    """(operations, bytes) of B strategies replayed over T candles: each
    strategy compares each candle past the warm-up once (its stop band
    while holding); the streams read once, the stops read and the stats
    written once a strategy."""
    ops = float(B) * max(T - WARMUP, 0)
    nbytes = REPLAY_STREAMS * T * F32 + (REPLAY_PARAMS + REPLAY_STATS) * B * F32
    return ops, float(nbytes)


def share_pct(seconds_least: float, ms_measured: list) -> float | None:
    """100 x least time over the mean measured time, or None without one."""
    if not ms_measured:
        return None
    mean_s = sum(ms_measured) / len(ms_measured) / 1e3
    return 100.0 * seconds_least / mean_s if mean_s > 0 else None
