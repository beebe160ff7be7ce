"""Signal explainability: structured explanations + factor weights.

The port's own copy of `ai_crypto_trader_tpu/strategy/explain.py` (pure
Python and JSON).  Capability parity with AIExplainabilityService
(`services/ai_explainability_service.py:138-354`): consumes a trading
signal, produces a structured explanation with per-factor contributions
(the same voters the signal rule scores), persists JSON artifacts.
"""

from __future__ import annotations

import json
import os
import time


def explain_signal(signal: dict, out_dir: str | None = None) -> dict:
    """Decompose the technical vote into factor contributions.

    The weights mirror TradingSignal's strength components
    (`binance_ml_strategy.py:545-581`): RSI 30 %, stochastic 20 %, MACD
    20 %, volume 15 %, trend 15 %."""
    rsi = float(signal.get("rsi", 50.0))
    stoch = float(signal.get("stoch_k", 50.0))
    macd = float(signal.get("macd", 0.0))
    volume = float(signal.get("avg_volume", 0.0))
    trend = signal.get("trend", "sideways")
    ts = float(signal.get("trend_strength", 0.0))
    decision = signal.get("decision", signal.get("signal", "HOLD"))

    factors = {
        "rsi": {"value": rsi, "weight": 0.30,
                "reading": "oversold" if rsi < 35 else
                           "overbought" if rsi > 65 else "neutral"},
        "stochastic": {"value": stoch, "weight": 0.20,
                       "reading": "oversold" if stoch < 20 else
                                  "overbought" if stoch > 80 else "neutral"},
        "macd": {"value": macd, "weight": 0.20,
                 "reading": "bullish" if macd > 0 else "bearish"},
        "volume": {"value": volume, "weight": 0.15,
                   "reading": "high" if volume > 100_000 else "normal"},
        "trend": {"value": ts, "weight": 0.15, "reading": trend},
    }
    supporting = [k for k, f in factors.items()
                  if (decision == "BUY" and f["reading"] in
                      ("oversold", "bullish", "uptrend", "high"))
                  or (decision == "SELL" and f["reading"] in
                      ("overbought", "bearish", "downtrend"))]
    explanation = {
        "symbol": signal.get("symbol"),
        "decision": decision,
        "confidence": signal.get("confidence"),
        "factors": factors,
        "supporting_factors": supporting,
        "narrative": (
            f"{decision} driven by {', '.join(supporting) or 'no aligned factors'}; "
            f"RSI {rsi:.1f}, stochastic {stoch:.1f}, MACD "
            f"{'positive' if macd > 0 else 'negative'}, trend {trend} "
            f"(strength {ts:.1f})."),
        "generated_at": time.time(),
    }
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        fname = os.path.join(
            out_dir, f"explanation_{signal.get('symbol', 'NA')}_{int(time.time()*1000)}.json")
        with open(fname, "w") as f:
            json.dump(explanation, f, indent=2)
        explanation["artifact"] = fname
    return explanation
