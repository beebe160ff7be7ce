"""Combined technical indicators — confirmation scores across indicators.

Port of `ai_crypto_trader_tpu/ops/combinations.py:31-134`: the 15
combination families of the reference's IndicatorCombinations (trend
confirmation, momentum/trend alignment, triple MA, volatility-adjusted
momentum, volatility trend score, oscillator consensus, stoch-RSI, double
RSI, volume-weighted price momentum, volume/price confirmation,
trend-strength index, market-regime indicator, reversal probability,
breakout confirmation, divergence detector) per candle over whole tensors
[..., T], and the weighted confluence of the directional ones.

Input: the `compute_indicators` output dict.  Scores lie in [-1, 1]
(bearish → bullish) or [0, 1] for probability-style outputs.  The fast RSI
(`rsi(close, 7)`) is one launch of the fused-EWMA kernel on the card.
Divisions by a constant are reciprocal multiplies (`device.div_const`), as
the JAX package's compiled program computes them.
"""

from __future__ import annotations

import torch

from ai_crypto_trader_tpu_torch.device import div_const
from ai_crypto_trader_tpu_torch.ops.indicators import (
    nanfill,
    roc,
    rolling_max,
    rolling_mean,
    rolling_min,
    rsi,
)

DIRECTIONAL = ("trend_confirmation", "momentum_trend_alignment",
               "triple_moving_average", "oscillator_consensus",
               "volume_weighted_price_momentum", "market_regime_indicator")


def _pct_change(close, n):
    """`roc` with zero-filled warmup (NaN would poison the tanh blends)."""
    return torch.nan_to_num(roc(close, n))


def _f32(mask):
    return mask.to(torch.float32)


def combined_indicators(ind: dict) -> dict:
    """All 15 combination scores, each [..., T]."""
    close = ind["close"]
    rsi14 = ind["rsi"]
    macd_line = ind["macd"]
    macd_sig = ind["macd_signal"]
    stoch = ind["stoch_k"]
    willr = ind["williams_r"]
    bb_pos = ind["bb_position"]
    bb_width = ind["bb_width"]
    atr = ind["atr"]
    volume = ind["volume"]
    sma20, sma50, sma200 = ind["sma_20"], ind["sma_50"], ind["sma_200"]

    chg1 = _pct_change(close, 1)
    chg5 = _pct_change(close, 5)
    vol_ma = nanfill(rolling_mean(volume, 20))
    vol_ratio = volume / torch.where(vol_ma == 0, 1.0, vol_ma)
    volatility = atr / close

    up_trend = _f32((close > sma20) & (sma20 > sma50))
    dn_trend = _f32((close < sma20) & (sma20 < sma50))
    trend_dir = up_trend - dn_trend                                # [-1, 1]

    # --- trend strength combinations ---------------------------------------
    macd_conf = torch.tanh((macd_line - macd_sig) / close * 1e3)
    trend_confirmation = trend_dir * 0.5 + macd_conf * 0.5
    momentum_trend_alignment = trend_dir * torch.tanh(div_const(chg5, 2.0))
    triple_ma = div_const(torch.sign(close - sma20) + torch.sign(sma20 - sma50)
                          + torch.sign(sma50 - sma200), 3.0)

    # --- volatility-adjusted -----------------------------------------------
    vol_safe = torch.where(volatility == 0, 1e-6, volatility)
    volatility_adjusted_momentum = torch.tanh(chg5 / (vol_safe * 100.0))
    volatility_trend_score = trend_dir * torch.clamp(1.0 - div_const(volatility, 0.05),
                                                     0.0, 1.0)

    # --- oscillators --------------------------------------------------------
    rsi_score = div_const(50.0 - rsi14, 50.0)            # oversold → +1
    stoch_score = div_const(50.0 - stoch, 50.0)
    willr_score = div_const(-50.0 - willr, 50.0)         # willr ∈ [-100, 0]
    oscillator_consensus = div_const(rsi_score + stoch_score + willr_score, 3.0)
    stoch_rsi = div_const(rsi_score + stoch_score, 2.0)
    rsi_fast = div_const(50.0 - nanfill(rsi(close, 7)), 50.0)
    double_rsi = div_const(rsi_score + rsi_fast, 2.0)

    # --- volume -------------------------------------------------------------
    volume_weighted_price_momentum = torch.tanh(chg1 * torch.clamp_max(vol_ratio, 3.0))
    volume_price_confirmation = torch.sign(chg1) * torch.clamp(vol_ratio - 1.0, 0.0, 1.0)

    # --- compound -----------------------------------------------------------
    trend_strength_index = torch.clamp(
        torch.abs(trend_confirmation) * 0.4 + torch.abs(triple_ma) * 0.3
        + torch.abs(momentum_trend_alignment) * 0.3, 0.0, 1.0)
    market_regime_indicator = trend_dir * trend_strength_index
    reversal_probability = torch.clamp(
        torch.abs(oscillator_consensus) * 0.6
        + (torch.abs(bb_pos - 0.5) * 2.0) * 0.4, 0.0, 1.0)
    bbw_ma = nanfill(rolling_mean(bb_width, 50))
    squeeze = bb_width < torch.where(bbw_ma == 0, 1.0, bbw_ma) * 0.8
    breakout_confirmation = torch.where(squeeze & (vol_ratio > 1.5), torch.sign(chg1), 0.0)
    # divergence: price making new 14-bar highs while RSI is not (bearish),
    # and vice versa
    price_hh = close >= nanfill(rolling_max(close, 14))
    rsi_hh = rsi14 >= nanfill(rolling_max(rsi14, 14))
    price_ll = close <= nanfill(rolling_min(close, 14))
    rsi_ll = rsi14 <= nanfill(rolling_min(rsi14, 14))
    divergence_detector = _f32(price_ll & ~rsi_ll) - _f32(price_hh & ~rsi_hh)

    return {
        "trend_confirmation": trend_confirmation,
        "momentum_trend_alignment": momentum_trend_alignment,
        "triple_moving_average": triple_ma,
        "volatility_adjusted_momentum": volatility_adjusted_momentum,
        "volatility_trend_score": volatility_trend_score,
        "oscillator_consensus": oscillator_consensus,
        "stoch_rsi": stoch_rsi,
        "double_rsi": double_rsi,
        "volume_weighted_price_momentum": volume_weighted_price_momentum,
        "volume_price_confirmation": volume_price_confirmation,
        "trend_strength_index": trend_strength_index,
        "market_regime_indicator": market_regime_indicator,
        "reversal_probability": reversal_probability,
        "breakout_confirmation": breakout_confirmation,
        "divergence_detector": divergence_detector,
    }


def combination_signal(combos: dict, weights: dict | None = None):
    """Weighted confluence score ∈ [-1, 1] across the directional combos
    (the reference's combined-signal aggregation)."""
    w = weights or {k: 1.0 for k in DIRECTIONAL}
    total = sum(w.get(k, 0.0) for k in DIRECTIONAL)
    acc = sum(combos[k] * w.get(k, 0.0) for k in DIRECTIONAL)
    return div_const(acc, max(total, 1e-9))
