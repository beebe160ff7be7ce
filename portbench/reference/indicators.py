"""The indicator table, written plainly from its definitions.

The 21 columns of the reference system's TechnicalAnalyzer (`ta`'s
defaults) over one candle series: simple moving averages, the EMA family
(pandas ``ewm(adjust=False)``), Wilder's RSI and ATR, the stochastic
oscillator, Williams %R, Bollinger bands (population std), Ichimoku's two
spans unshifted and a rolling VWAP.  A column is NaN before its first full
window (pandas ``min_periods``) and then filled forward, backward and with
0, as the analyzer's NaN handling does.

Inputs are arrays in the format they are computed in (`numerics`): float64
for the reference, `BF16` for its control.  Windowed sums add the window's
values one by one; an EWMA is the first-order recursion solved by doubling
(log2 T vectorised steps).  Nothing here comes from the program.
"""

from __future__ import annotations

import numpy as np

NAMES = (
    "sma_20", "sma_50", "sma_200", "ema_12", "ema_26",
    "macd", "macd_signal", "macd_diff",
    "ichimoku_a", "ichimoku_b",
    "rsi", "stoch_k", "stoch_d", "williams_r",
    "bb_high", "bb_mid", "bb_low", "bb_width", "bb_position",
    "atr", "vwap",
)


def _nan_before(y, n):
    """NaN at positions < n."""
    return np.where(np.arange(y.shape[-1]) < n, np.nan, y)


def _shifted(x, w, j, fill):
    """x[t - (w - 1) + j] for every t, ``fill`` before the series."""
    T = x.shape[-1]
    lag = w - 1 - j
    out = np.full_like(x, fill)
    if lag < T:
        out[lag:] = x[:T - lag]
    return out


def rolling_sum(x, w):
    acc = np.zeros_like(x)
    for j in range(w):
        acc = acc + _shifted(x, w, j, 0.0)
    return _nan_before(acc, w - 1)


def rolling_mean(x, w):
    return rolling_sum(x, w) / w


def rolling_max(x, w):
    acc = _shifted(x, w, 0, -np.inf)
    for j in range(1, w):
        acc = np.maximum(acc, _shifted(x, w, j, -np.inf))
    return _nan_before(acc, w - 1)


def rolling_min(x, w):
    acc = _shifted(x, w, 0, np.inf)
    for j in range(1, w):
        acc = np.minimum(acc, _shifted(x, w, j, np.inf))
    return _nan_before(acc, w - 1)


def rolling_std(x, w):
    """Population std over the window, of the series centred on its mean."""
    xc = x - np.mean(x)
    m = rolling_mean(xc, w)
    var = rolling_mean(xc * xc, w) - m * m
    return np.sqrt(np.maximum(var, 0.0))


def ewm(x, alpha, start):
    """pandas ``ewm(alpha, adjust=False).mean()`` of x[start:], seeded with
    x[start]; NaN before ``start``."""
    T = x.shape[-1]
    t = np.arange(T)
    xs = np.where(t >= start, x, 0.0)
    a = np.where(t > start, 1.0 - alpha, 0.0) + np.zeros_like(x)
    b = np.where(t > start, alpha * xs, xs)
    k = 1
    while k < T:
        b_prev = np.concatenate([np.zeros_like(b[:k]), b[:T - k]])
        a_prev = np.concatenate([np.ones_like(a[:k]), a[:T - k]])
        b = a * b_prev + b
        a = a * a_prev
        k *= 2
    return _nan_before(b, start)


def _nan_where_zero(x):
    return np.where(x == 0.0, np.nan, x)


def nanfill(x):
    """Forward fill, then backward fill, then 0."""
    T = x.shape[-1]
    idx = np.maximum.accumulate(np.where(np.isnan(x), -1, np.arange(T)))
    y = np.where(idx < 0, np.nan, x[np.maximum(idx, 0)])
    ridx = np.minimum.accumulate(np.where(np.isnan(y), T, np.arange(T))[::-1])[::-1]
    y = np.where(ridx >= T, np.nan, y[np.minimum(ridx, T - 1)])
    return np.where(np.isnan(y), 0.0, y)


def indicator_table(high, low, close, volume) -> dict:
    """The 21 columns, filled, in the inputs' format."""
    T = close.shape[-1]
    t = np.arange(T)
    out = {"sma_20": rolling_mean(close, 20), "sma_50": rolling_mean(close, 50),
           "sma_200": rolling_mean(close, 200)}

    e12 = ewm(close, 2.0 / 13.0, 0)
    e26 = ewm(close, 2.0 / 27.0, 0)
    out["ema_12"] = _nan_before(e12, 11)
    out["ema_26"] = _nan_before(e26, 25)
    line = _nan_before(e12 - e26, 25)
    signal = _nan_before(ewm(line, 2.0 / 10.0, 25), 33)
    out["macd"], out["macd_signal"], out["macd_diff"] = line, signal, line - signal

    conv = (rolling_max(high, 9) + rolling_min(low, 9)) / 2.0
    base = (rolling_max(high, 26) + rolling_min(low, 26)) / 2.0
    out["ichimoku_a"] = (conv + base) / 2.0
    out["ichimoku_b"] = (rolling_max(high, 52) + rolling_min(low, 52)) / 2.0

    prev = np.concatenate([close[:1], close[:-1]])
    diff = close - prev
    gain = ewm(np.maximum(diff, 0.0), 1.0 / 14.0, 1)
    loss = ewm(np.maximum(-diff, 0.0), 1.0 / 14.0, 1)
    rsi = np.where(loss == 0.0, np.where(gain == 0.0, 50.0, 100.0),
                   100.0 - 100.0 / (1.0 + gain / np.where(loss == 0.0, 1.0, loss)))
    out["rsi"] = _nan_before(rsi, 14)

    hh, ll = rolling_max(high, 14), rolling_min(low, 14)
    k = 100.0 * (close - ll) / _nan_where_zero(hh - ll)
    out["stoch_k"] = k
    out["stoch_d"] = _nan_before(rolling_mean(k, 3), 15)
    out["williams_r"] = -100.0 * (hh - close) / _nan_where_zero(hh - ll)

    mid = rolling_mean(close, 20)
    sd = rolling_std(close, 20)
    hi, lo = mid + 2.0 * sd, mid - 2.0 * sd
    out["bb_high"], out["bb_mid"], out["bb_low"] = hi, mid, lo
    out["bb_width"] = (hi - lo) / mid
    out["bb_position"] = (close - lo) / _nan_where_zero(hi - lo)

    tr = np.maximum(high - low, np.maximum(np.abs(high - prev), np.abs(low - prev)))
    tr = np.where(t == 0, np.nan, tr)
    out["atr"] = _nan_before(ewm(tr, 1.0 / 14.0, 1), 14)

    typical = (high + low + close) / 3.0
    out["vwap"] = rolling_sum(typical * volume, 14) / _nan_where_zero(rolling_sum(volume, 14))
    return {name: nanfill(out[name]) for name in NAMES}
