"""Regime-training data collection from live system state.

Port of `ai_crypto_trader_tpu/regime/collector.py` (host Python): assembles
training samples from the bus's market data, signals and trade outcomes,
with the per-sample feature block.  The bundle (``{'features': [N, 4],
'outcomes': [N]}``) feeds `regime.cluster` and the trade-outcome models;
full-series detection runs on candle arrays through `RegimeDetector`.
The bus is injected and read through ``get`` only (the JAX package's
``EventBus`` or anything with its ``get``).
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass

import numpy as np


@dataclass
class RegimeDataCollector:
    bus: object                     # get / set / keys / await publish
    max_samples: int = 5_000
    samples: deque = None  # type: ignore[assignment]

    def __post_init__(self):
        if self.samples is None:
            self.samples = deque(maxlen=self.max_samples)

    def collect_snapshot(self, symbol: str) -> dict | None:
        """One (features, context) sample from current bus state."""
        md = self.bus.get(f"market_data_{symbol}")
        if not md:
            return None
        def num(key, default=0.0):
            v = md.get(key)
            return float(v) if isinstance(v, (int, float)) else default

        sample = {
            "symbol": symbol,
            "timestamp": num("timestamp"),
            "price": num("current_price"),
            "rsi": md.get("rsi") if isinstance(md.get("rsi"), (int, float)) else None,
            "volatility": md.get("volatility")
            if isinstance(md.get("volatility"), (int, float)) else None,
            "trend_strength": num("trend_strength"),
            "trend": md.get("trend"),
            "signal": md.get("signal"),
            "signal_strength": num("signal_strength"),
        }
        latest_signal = self.bus.get(f"latest_signal_{symbol}")
        if latest_signal:
            sample["decision"] = latest_signal.get("decision")
            sample["confidence"] = latest_signal.get("confidence")
        self.samples.append(sample)
        return sample

    def attach_outcomes(self, closed_trades: list[dict],
                        window_s: float = 3600.0) -> int:
        """Join trade outcomes onto collected snapshots by symbol + time
        proximity. Returns #samples labeled."""
        n = 0
        for trade in closed_trades:
            t_close = trade.get("closed_at", 0.0)
            best, best_dt = None, window_s
            for s in self.samples:
                if s["symbol"] != trade["symbol"] or "outcome" in s:
                    continue
                dt = abs((s.get("timestamp") or 0.0) - t_close)
                if dt <= best_dt:
                    best, best_dt = s, dt
            if best is not None:
                best["outcome"] = "win" if trade["pnl"] > 0 else "loss"
                best["pnl"] = trade["pnl"]
                n += 1
        return n

    def training_arrays(self) -> dict | None:
        """Dense arrays for detector training / outcome modeling."""
        usable = [s for s in self.samples
                  if s.get("rsi") is not None and s.get("volatility") is not None]
        if len(usable) < 10:
            return None
        feats = np.asarray([[s["rsi"], s["volatility"],
                             s["trend_strength"], s["signal_strength"]]
                            for s in usable], np.float32)
        outcomes = np.asarray([1 if s.get("outcome") == "win" else
                               0 if s.get("outcome") == "loss" else -1
                               for s in usable], np.int32)
        return {"features": feats, "outcomes": outcomes,
                "feature_names": ["rsi", "volatility", "trend_strength",
                                  "signal_strength"],
                "n_labeled": int((outcomes >= 0).sum())}
