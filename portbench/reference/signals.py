"""The signal rule and the entry gate, written plainly.

The reference system's TradingSignal votes over one indicator table: RSI,
stochastic %K, MACD, Williams %R, the trend against SMA 20 / 50 and the
Bollinger position, each worth 3, 2 or 0 buy votes; a BUY at a vote ratio
of 0.6 or more out of 6, a SELL at 0.3 or less.  Its quirks are part of the
rule: the strong-MACD branch can never fire, an exact 0.0 of Williams %R,
the trend strength or the Bollinger position counts as missing, and the
strength of a NEUTRAL candle is 0.  The replay opens a position where the
gate holds: past the warm-up, confidence >= 0.7, strength >= 70, and the
decision equal to the signal and BUY.

Computed in float32 (the configuration's precision) or, for the control,
in `BF16`.
"""

from __future__ import annotations

import numpy as np

BUY, NEUTRAL, SELL = 1, 0, -1
WARMUP = 10
CONFIDENCE_MIN = 0.7
STRENGTH_MIN = 70.0


def _votes(strong, moderate):
    return np.where(strong, 3.0, np.where(moderate, 2.0, 0.0))


def signal_inputs(table: dict) -> dict:
    """close, signal, strength, volatility and the average quote volume of
    every candle, from the indicator table's arrays (all one format)."""
    close, sma20, sma50 = table["close"], table["sma_20"], table["sma_50"]
    trend = np.where((close > sma20) & (sma20 > sma50), 1,
                     np.where((close < sma20) & (sma20 < sma50), -1, 0))
    trend_strength = np.abs(((close - sma20) / sma20 * 100.0
                             + (close - sma50) / sma50 * 100.0) / 2.0)
    rsi, stoch_k, macd = table["rsi"], table["stoch_k"], table["macd"]
    williams, bb_pos = table["williams_r"], table["bb_position"]
    fmt = close.dtype.type
    mean = lambda x: fmt(np.mean(np.asarray(x, dtype=np.float64)))  # noqa: E731
    avg_volume = np.zeros_like(close) + mean(table["volume"]) * mean(close)

    buy = _votes(rsi < 35.0, rsi < 45.0)
    buy = buy + _votes(stoch_k < 20.0, stoch_k < 30.0)
    buy = buy + np.where(macd > 0.0, 2.0, 0.0)
    w_valid = williams != 0.0
    buy = buy + _votes(w_valid & (williams < -80.0), w_valid & (williams < -65.0))
    ts_valid = trend_strength != 0.0
    up = trend == 1
    buy = buy + _votes(up & ts_valid & (trend_strength > 10.0),
                       up & ts_valid & (trend_strength > 5.0))
    bb_valid = bb_pos != 0.0
    buy = buy + _votes(bb_valid & (bb_pos < 0.2), bb_valid & (bb_pos < 0.4))
    ratio = buy / 6.0
    signal = np.where(ratio >= 0.6, BUY, np.where(ratio <= 0.3, SELL, NEUTRAL))

    is_buy, is_sell = signal == BUY, signal == SELL
    rsi_str = np.where(is_buy, (45.0 - np.minimum(rsi, 45.0)) / 15.0,
                       (np.maximum(rsi, 55.0) - 55.0) / 15.0)
    stoch_str = np.where(is_buy, (30.0 - np.minimum(stoch_k, 30.0)) / 30.0,
                         (np.maximum(stoch_k, 70.0) - 70.0) / 30.0)
    macd_str = np.minimum(np.abs(macd), 1.0)
    volume_str = np.minimum(avg_volume / 100_000.0, 1.0)
    trend_str = np.minimum(trend_strength / 20.0, 1.0)
    aligned = (is_buy & (trend == 1)) | (is_sell & (trend == -1))
    strength = (rsi_str * 30.0 + stoch_str * 20.0 + macd_str * 20.0 + volume_str * 15.0
                + np.where(ts_valid & aligned, trend_str * 15.0, 0.0))
    strength = np.where(signal == NEUTRAL, 0.0, np.clip(strength, 0.0, 100.0))
    return {"close": close, "signal": signal.astype(np.int32), "strength": strength,
            "volatility": table["atr"] / close, "volume": avg_volume}


def entry_gate(signal, strength, confidence=None, decision=None):
    """Where a flat strategy opens a position (bool per candle).  The
    default AI gate passes everything: confidence 1, decision = signal."""
    decision = signal if decision is None else decision
    ok_conf = True if confidence is None else (np.asarray(confidence) >= np.float32(CONFIDENCE_MIN))
    t = np.arange(signal.shape[-1])
    return ((t >= WARMUP) & ok_conf & (np.asarray(strength) >= np.float32(STRENGTH_MIN))
            & (signal == decision) & (decision == BUY))
