"""Market-regime service: periodic training, per-regime strategy
performance, and switching recommendations.

Port of `ai_crypto_trader_tpu/regime/service.py`: hybrid rule + ML
detection (the rules below ``min_candles`` of history), re-training each
symbol's detector every ``retrain_interval_s``, per-regime strategy
performance and switch recommendations, published on the bus as the JAX
package does (``market_regime_{symbol}``, ``market_regime`` and the
``regime_updates`` channel).  Detection runs on ``device`` (None: the CUDA
card).  The bus is injected and used only through ``get``, ``set`` and
``await publish`` (the JAX package's ``EventBus`` or anything with those).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any

import numpy as np

from ai_crypto_trader_tpu_torch.device import resolve_device
from ai_crypto_trader_tpu_torch.regime.detector import RegimeDetector


@dataclass
class MarketRegimeService:
    bus: object                      # get / set / keys / await publish
    method: str = "kmeans"           # hybrid: rules fallback on thin history
    retrain_interval_s: float = 86_400.0
    min_candles: int = 300           # ML methods need this much history
    min_candles_rules: int = 60      # below min_candles, the rules detector runs
    now_fn: any = time.time
    # All per-symbol: one symbol's fitted clusters must never classify another
    detectors: dict = field(default_factory=dict)
    _last_train: dict = field(default_factory=dict)
    regimes: dict = field(default_factory=dict)   # symbol -> latest detection
    # regime -> strategy_id -> list of trade pnls
    regime_performance: dict = field(default_factory=dict)
    device: Any = None

    def __post_init__(self):
        self.device = resolve_device(self.device)

    @property
    def current_regime(self) -> dict:
        """Most recent detection across symbols (legacy single-key view)."""
        if not self.regimes:
            return {"regime": "ranging", "confidence": 0.0}
        return max(self.regimes.values(), key=lambda r: r.get("timestamp", 0.0))

    def _history_arrays(self, symbol: str) -> dict | None:
        klines = self.bus.get(f"historical_data_{symbol}_1m")
        if not klines or len(klines) < self.min_candles_rules:
            return None
        arr = np.asarray([row[1:6] for row in klines], np.float32)
        return {k: arr[:, i] for i, k in enumerate(("open", "high", "low", "close", "volume"))}

    async def update(self, symbol: str = "BTCUSDC") -> dict:
        """Detect (retraining on schedule); publish + store."""
        arrays = self._history_arrays(symbol)
        if arrays is None:
            return self.regimes.get(symbol,
                                    {"regime": "ranging", "confidence": 0.0})
        now = self.now_fn()
        thin = int(np.asarray(arrays["close"]).shape[0]) < self.min_candles
        method = "rules" if thin else self.method
        det = self.detectors.get(symbol)
        stale = now - self._last_train.get(symbol, -1e18) >= self.retrain_interval_s
        if det is None or stale or det.method != method:
            det = RegimeDetector(method=method, device=self.device).fit(arrays)
            self.detectors[symbol] = det
            self._last_train[symbol] = now
        out = det.detect(arrays)
        out["timestamp"] = now
        out["symbol"] = symbol
        self.regimes[symbol] = out
        self.bus.set(f"market_regime_{symbol}", out)
        self.bus.set("market_regime", out)   # legacy single-key consumers
        await self.bus.publish("regime_updates", out)
        return out

    # --- per-regime strategy performance -----------------------
    def record_trade(self, strategy_id: str, pnl: float,
                     regime: str | None = None):
        regime = regime or self.current_regime.get("regime", "ranging")
        self.regime_performance.setdefault(regime, {}).setdefault(
            strategy_id, []).append(pnl)

    def regime_score(self, strategy_id: str, regime: str | None = None) -> float:
        """Win-rate-and-expectancy blend of a strategy within a regime
        (`_calculate_regime_score`)."""
        regime = regime or self.current_regime.get("regime", "ranging")
        pnls = self.regime_performance.get(regime, {}).get(strategy_id, [])
        if not pnls:
            return 0.5
        arr = np.asarray(pnls)
        win_rate = (arr > 0).mean()
        expectancy = arr.mean()
        return float(np.clip(0.5 * win_rate
                             + 0.5 * (0.5 + np.tanh(expectancy / 50.0) / 2.0),
                             0.0, 1.0))

    def best_strategy_for_regime(self, regime: str | None = None) -> str | None:
        regime = regime or self.current_regime.get("regime", "ranging")
        perf = self.regime_performance.get(regime, {})
        if not perf:
            return None
        return max(perf, key=lambda s: self.regime_score(s, regime))

    def switch_recommendation(self, current_strategy: str) -> dict:
        """Recommend a switch when another strategy clearly outperforms in
        the current regime."""
        regime = self.current_regime.get("regime", "ranging")
        best = self.best_strategy_for_regime(regime)
        if best is None or best == current_strategy:
            return {"switch": False, "regime": regime}
        cur = self.regime_score(current_strategy, regime)
        cand = self.regime_score(best, regime)
        return {"switch": cand > cur + 0.1, "regime": regime,
                "candidate": best, "candidate_score": cand,
                "current_score": cur}
