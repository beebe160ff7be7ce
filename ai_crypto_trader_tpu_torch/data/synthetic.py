"""Deterministic synthetic OHLCV generation (NumPy).

The port's own copy of `ai_crypto_trader_tpu/data/synthetic.py:25-106`:
seeded, regime-switching GBM candles with intrabar high/low structure,
shaped like Binance klines.  It must stay bit-identical to the JAX
package's generator (tests/test_torch_package.py checks it), so the two
packages are always fed the same candles.

The regime chain is vectorized: a regime at candle i is the choice drawn
at the LAST switch candle ≤ i, a running-maximum scan over switch indices.
`seed` may be a sequence, in which case one call returns a batch of
independent series with a leading [B] axis, each row bit-identical to the
scalar call with that seed.
"""

from __future__ import annotations

import numpy as np

# Per-regime (quiet / trending / volatile) drift & vol multipliers.
REGIME_DRIFT_MULT = np.array([0.0, 8.0, -3.0])
REGIME_VOL_MULT = np.array([0.6, 1.2, 2.5])


def regime_chain(switches: np.ndarray, choices: np.ndarray) -> np.ndarray:
    """Vectorized 3-regime Markov chain over the trailing axis.

    ``switches`` [..., n] bool marks candles where the state re-draws;
    ``choices`` [..., n] int holds the redrawn state per candle.  The state
    at candle i is ``choices`` at the last switch ≤ i (initial state 0), so
    the whole chain is one running-max over switch indices + one gather —
    identical semantics to the sequential loop it replaces.
    """
    n = switches.shape[-1]
    idx = np.maximum.accumulate(
        np.where(switches, np.arange(n), -1), axis=-1)
    filled = np.take_along_axis(np.asarray(choices), np.maximum(idx, 0),
                                axis=-1)
    return np.where(idx >= 0, filled, 0).astype(np.int64)


def generate_ohlcv(
    n: int = 10_000,
    seed: int | list | tuple | np.ndarray = 0,
    s0: float = 40_000.0,
    base_drift: float = 0.00002,
    base_vol: float = 0.0015,
    regime_switch_p: float = 0.002,
    base_volume: float = 25.0,
):
    """Return a dict of float32 arrays: open/high/low/close/volume, length n.

    A 3-regime (quiet / trending / volatile) Markov chain modulates drift and
    vol so regime-detection components have something real to find.

    ``seed`` may be a sequence of B seeds: the result then carries a leading
    [B] batch axis on every array, row b bit-identical to
    ``generate_ohlcv(n, seed=seed[b], ...)`` — one call, B independent
    series.
    """
    batched = np.ndim(seed) > 0
    seeds = [int(s) for s in np.atleast_1d(np.asarray(seed))]

    # Per-seed draws in the scalar call's exact order (bit-compat per row);
    # everything downstream is vectorized over the [B, n] stack.
    draws = []
    for s in seeds:
        rng = np.random.default_rng(s)
        draws.append((rng.random(n) < regime_switch_p,
                      rng.integers(0, 3, size=n),
                      rng.standard_normal(n),
                      np.abs(rng.standard_normal((2, n))),
                      rng.standard_normal(n)))
    switches, choices, z, wick_z, vol_z = (np.stack(a) for a in zip(*draws))

    regimes = regime_chain(switches, choices)
    rets = (base_drift * REGIME_DRIFT_MULT[regimes]
            + base_vol * REGIME_VOL_MULT[regimes] * z)
    close = s0 * np.exp(np.cumsum(rets, axis=-1))
    open_ = np.concatenate(
        [np.full_like(close[..., :1], s0), close[..., :-1]], axis=-1)

    # Intrabar range: wick sizes scale with the bar's regime vol.
    wick = wick_z * base_vol * REGIME_VOL_MULT[regimes][..., None, :] * \
        close[..., None, :]
    high = np.maximum(open_, close) + wick[..., 0, :]
    low = np.minimum(open_, close) - wick[..., 1, :]

    volume = (base_volume * np.exp(0.35 * vol_z)
              * REGIME_VOL_MULT[regimes])

    out = {
        "open": open_.astype(np.float32),
        "high": high.astype(np.float32),
        "low": low.astype(np.float32),
        "close": close.astype(np.float32),
        "volume": volume.astype(np.float32),
        "regime": regimes,
    }
    if not batched:
        out = {k: v[0] for k, v in out.items()}
    return out
