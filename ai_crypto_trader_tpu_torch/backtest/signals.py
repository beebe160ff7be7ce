"""Vectorized trading-signal scoring — TradingSignal parity, in PyTorch.

Port of `ai_crypto_trader_tpu/backtest/signals.py`: the reference's
per-candle if/else trees (TradingSignal, get_trend, PositionSizer) as
`torch.where` arithmetic over whole candle axes.  The reference's quirks
are kept exactly, as in the JAX package (signals.py:13-20 there):

  * the MACD "strong momentum" branch `macd > 0 and macd > macd * 1.1` is
    unsatisfiable for positive macd, so only the +2.0 branch can fire;
  * `if self.williams_r and ...` / `if self.bb_position and ...` treat an
    exact 0.0 as "missing" (Python falsiness): explicit != 0 masks;
  * 'SELL' fires whenever the *buy* vote ratio is ≤ 0.3 — there are no
    sell-side votes in the reference.

Products keep the JAX operand order (``total_capital * position_pct *
volume_factor`` is evaluated left to right).  Signals are int32: +1 BUY,
0 NEUTRAL, -1 SELL.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ai_crypto_trader_tpu_torch.device import div_const

BUY, NEUTRAL, SELL = 1, 0, -1


class SignalFeatures(NamedTuple):
    """Per-candle feature set consumed by the signal rule."""

    close: torch.Tensor
    rsi: torch.Tensor
    stoch_k: torch.Tensor
    macd: torch.Tensor
    williams_r: torch.Tensor
    bb_position: torch.Tensor
    trend: torch.Tensor           # +1 uptrend / 0 sideways / -1 downtrend
    trend_strength: torch.Tensor  # percent distance from SMAs
    volatility: torch.Tensor      # ATR / close
    volume: torch.Tensor          # avg volume in quote units (broadcast)


def _mean_last(x):
    """Mean over the last axis, summed in float64 and rounded once — the
    value the JAX package's compiled mean gives for these series."""
    return x.double().mean(dim=-1, keepdim=True).float()


def compute_signal_features(ind: dict, per_candle_trend: bool = True) -> SignalFeatures:
    """SignalFeatures from a compute_indicators() output dict.
    ``per_candle_trend=False`` broadcasts the last candle's values, as the
    reference's backtester froze them."""
    close, sma20, sma50 = ind["close"], ind["sma_20"], ind["sma_50"]
    up = (close > sma20) & (sma20 > sma50)
    dn = (close < sma20) & (sma20 < sma50)
    trend = torch.where(up, 1, torch.where(dn, -1, 0)).to(torch.int32)
    strength = torch.abs(div_const(
        (close - sma20) / sma20 * 100.0 + (close - sma50) / sma50 * 100.0, 2.0))
    vol = ind["atr"] / close
    avg_volume = _mean_last(ind["volume"]) * _mean_last(close)
    feats = SignalFeatures(
        close=close,
        rsi=ind["rsi"],
        stoch_k=ind["stoch_k"],
        macd=ind["macd"],
        williams_r=ind["williams_r"],
        bb_position=ind["bb_position"],
        trend=trend,
        trend_strength=strength,
        volatility=vol,
        volume=avg_volume.expand(close.shape),
    )
    if not per_candle_trend:
        last = lambda x: x[..., -1:].expand(x.shape)  # noqa: E731
        feats = feats._replace(
            rsi=last(feats.rsi), stoch_k=last(feats.stoch_k),
            macd=last(feats.macd), williams_r=last(feats.williams_r),
            bb_position=last(feats.bb_position), trend=last(feats.trend),
            trend_strength=last(feats.trend_strength),
            volatility=last(feats.volatility),
        )
    return feats


def _votes(cond_strong, cond_moderate):
    return torch.where(cond_strong, 3.0, torch.where(cond_moderate, 2.0, 0.0))


def reference_signal(f: SignalFeatures):
    """TradingSignal._calculate_signal + _calculate_strength, vectorized.
    Returns (signal int32 ∈ {-1,0,1}, strength float32 ∈ [0,100])."""
    buy = _votes(f.rsi < 35.0, f.rsi < 45.0)
    buy = buy + _votes(f.stoch_k < 20.0, f.stoch_k < 30.0)
    # macd>0 and macd>macd*1.1 is unsatisfiable → only the +2 branch exists.
    buy = buy + torch.where(f.macd > 0.0, 2.0, 0.0)
    w_valid = f.williams_r != 0.0  # Python truthiness of the reference
    buy = buy + _votes(w_valid & (f.williams_r < -80.0),
                       w_valid & (f.williams_r < -65.0))
    ts_valid = f.trend_strength != 0.0
    uptrend = f.trend == 1
    buy = buy + _votes(uptrend & ts_valid & (f.trend_strength > 10.0),
                       uptrend & ts_valid & (f.trend_strength > 5.0))
    bb_valid = f.bb_position != 0.0
    buy = buy + _votes(bb_valid & (f.bb_position < 0.2),
                       bb_valid & (f.bb_position < 0.4))

    ratio = div_const(buy, 6.0)
    signal = torch.where(ratio >= 0.6, BUY,
                         torch.where(ratio <= 0.3, SELL, NEUTRAL)).to(torch.int32)

    is_buy = signal == BUY
    is_sell = signal == SELL
    rsi_str = torch.where(is_buy, div_const(45.0 - torch.clamp_max(f.rsi, 45.0), 15.0),
                          div_const(torch.clamp_min(f.rsi, 55.0) - 55.0, 15.0))
    stoch_str = torch.where(is_buy, div_const(30.0 - torch.clamp_max(f.stoch_k, 30.0), 30.0),
                            div_const(torch.clamp_min(f.stoch_k, 70.0) - 70.0, 30.0))
    macd_str = torch.clamp_max(torch.abs(f.macd), 1.0)
    volume_str = torch.clamp_max(div_const(f.volume, 100_000.0), 1.0)
    trend_str = torch.clamp_max(div_const(f.trend_strength, 20.0), 1.0)
    trend_aligned = (is_buy & (f.trend == 1)) | (is_sell & (f.trend == -1))

    strength = (
        rsi_str * 30.0
        + stoch_str * 20.0
        + macd_str * 20.0
        + volume_str * 15.0
        + torch.where(ts_valid & trend_aligned, trend_str * 15.0, 0.0)
    )
    strength = torch.clamp(strength, 0.0, 100.0)
    strength = torch.where(signal == NEUTRAL, 0.0, strength)
    return signal, strength


class PositionPlan(NamedTuple):
    size: torch.Tensor            # quote-currency position size
    stop_loss_pct: torch.Tensor   # reference units: FRACTION (0.02 = "2%")
    take_profit_pct: torch.Tensor
    trailing_activation: torch.Tensor
    trailing_distance: torch.Tensor


def position_size(total_capital, volatility, volume,
                  max_risk_per_trade: float = 0.15) -> PositionPlan:
    """PositionSizer.calculate_position_size, vectorized.  stop_loss_pct is
    the reference's FRACTION; the engine decides its unit
    (``reference_quirks``)."""
    hi = volatility > 0.02
    mid = (~hi) & (volatility > 0.01)
    position_pct = torch.where(hi, 0.25, torch.where(mid, 0.20, 0.15))
    sl = torch.where(hi, 0.02, torch.where(mid, 0.015, 0.01))

    volume_factor = torch.clamp_max(div_const(volume, 50_000.0), 1.0)
    size = total_capital * position_pct * volume_factor
    size = torch.minimum(size, total_capital * max_risk_per_trade / sl)
    size = torch.minimum(size, total_capital * 0.20)
    size = torch.maximum(size, total_capital * 0.10)
    size = torch.clamp_min(size, 40.0)

    return PositionPlan(
        size=size,
        stop_loss_pct=sl,
        take_profit_pct=sl * 2.0,
        trailing_activation=sl * 1.5,
        trailing_distance=sl * 0.75,
    )
