"""Seeded synthetic OHLCV candles: the market data of the sweep cells.

A frozen copy of the port's `data/synthetic.generate_ohlcv` (regime-switching
GBM candles with intrabar wicks, shaped like Binance 1-minute klines), so
that a later change to the program cannot change the benchmark's data.
`portbench/tests/test_portbench_reference.py` holds it against the
program's generator for one seed, as it stood when it was copied.
"""

from __future__ import annotations

import numpy as np

# Per-regime (quiet / trending / volatile) drift and volatility multipliers.
REGIME_DRIFT_MULT = np.array([0.0, 8.0, -3.0])
REGIME_VOL_MULT = np.array([0.6, 1.2, 2.5])


def regime_chain(switches: np.ndarray, choices: np.ndarray) -> np.ndarray:
    """The regime at candle i is ``choices`` at the last switch <= i
    (initial regime 0)."""
    n = switches.shape[-1]
    idx = np.maximum.accumulate(np.where(switches, np.arange(n), -1), axis=-1)
    filled = np.take_along_axis(np.asarray(choices), np.maximum(idx, 0), axis=-1)
    return np.where(idx >= 0, filled, 0).astype(np.int64)


def generate_ohlcv(n: int, seed: int, s0: float = 40_000.0,
                   base_drift: float = 0.00002, base_vol: float = 0.0015,
                   regime_switch_p: float = 0.002,
                   base_volume: float = 25.0) -> dict:
    """float32 open/high/low/close/volume arrays of length ``n`` for one
    seed."""
    rng = np.random.default_rng(int(seed))
    switches = rng.random(n) < regime_switch_p
    choices = rng.integers(0, 3, size=n)
    z = rng.standard_normal(n)
    wick_z = np.abs(rng.standard_normal((2, n)))
    vol_z = rng.standard_normal(n)

    regimes = regime_chain(switches, choices)
    rets = (base_drift * REGIME_DRIFT_MULT[regimes]
            + base_vol * REGIME_VOL_MULT[regimes] * z)
    close = s0 * np.exp(np.cumsum(rets))
    open_ = np.concatenate([[s0], close[:-1]])
    wick = wick_z * base_vol * REGIME_VOL_MULT[regimes][None, :] * close[None, :]
    high = np.maximum(open_, close) + wick[0]
    low = np.minimum(open_, close) - wick[1]
    volume = base_volume * np.exp(0.35 * vol_z) * REGIME_VOL_MULT[regimes]
    return {"open": open_.astype(np.float32), "high": high.astype(np.float32),
            "low": low.astype(np.float32), "close": close.astype(np.float32),
            "volume": volume.astype(np.float32)}
