"""Strategy selection: weighted multi-factor scoring + cooldown switching.

The port's own copy of `ai_crypto_trader_tpu/strategy/selection.py` (pure
Python and NumPy).  Capability parity with StrategySelectionService
(`services/strategy_selection_service.py`): factor scores for market regime
fit, historical performance, risk profile, social sentiment, market
volatility, feature importance (:772-870), LEARNED per-hour performance
profiles + time-window adjustments (:689-770), and cooldown-guarded
`should_switch_strategy` (:884).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np

# UTC time windows (`strategy_selection_service.py:90-93`).
TIME_WINDOWS = {
    "high_volatility": (14, 22),     # market opens
    "low_activity": (0, 8),
}


def hourly_performance(trades: list[dict]) -> dict:
    """Per-UTC-hour {win_rate, trade_count} profile from closed-trade
    records ({'pnl', 'closed_at'} — executor/backtest shapes). This is the
    learned profile the reference reads from each strategy's metrics
    (`:725-735`), built here instead of assumed to exist in Redis."""
    buckets: dict[int, list[bool]] = {}
    for t in trades:
        when = t.get("closed_at")
        if when is None:
            continue
        hour = int(when // 3600) % 24
        buckets.setdefault(hour, []).append(float(t.get("pnl", 0.0)) > 0)
    return {str(h): {"win_rate": float(np.mean(w)), "trade_count": len(w)}
            for h, w in buckets.items()}

DEFAULT_WEIGHTS = {
    "market_regime": 0.25,
    "historical_performance": 0.25,
    "risk_profile": 0.15,
    "social_sentiment": 0.10,
    "market_volatility": 0.15,
    "feature_importance": 0.10,
}

# Which regimes each strategy archetype thrives in (regime fit scores).
REGIME_FIT = {
    "trend_following": {"bull": 1.0, "bear": 0.7, "ranging": 0.2, "volatile": 0.4},
    "mean_reversion": {"bull": 0.4, "bear": 0.4, "ranging": 1.0, "volatile": 0.5},
    "breakout": {"bull": 0.8, "bear": 0.6, "ranging": 0.3, "volatile": 1.0},
    "grid": {"bull": 0.3, "bear": 0.3, "ranging": 1.0, "volatile": 0.6},
    "dca": {"bull": 0.8, "bear": 0.9, "ranging": 0.6, "volatile": 0.5},
}


@dataclass
class StrategySelector:
    weights: dict = field(default_factory=lambda: dict(DEFAULT_WEIGHTS))
    switch_cooldown_s: float = 3600.0
    min_improvement: float = 0.1       # required score edge to switch
    now_fn: any = time.time
    _last_switch: float = field(default=-1e18)
    current_id: str | None = None

    def score_strategy(self, strategy: dict, *, regime: str = "ranging",
                       volatility: float = 0.01,
                       social_sentiment: float = 0.5,
                       hour_of_day: int | None = None) -> dict:
        """Combine factor scores with weights
        (`select_optimal_strategy:772-870`). `strategy` carries its metrics
        dict and archetype."""
        m = strategy.get("metrics", {})
        archetype = strategy.get("archetype", "trend_following")

        regime_score = REGIME_FIT.get(archetype, {}).get(regime, 0.5)
        sharpe = m.get("sharpe_ratio", 0.0)
        perf_score = float(np.clip(sharpe / 3.0 + 0.5, 0.0, 1.0))
        dd = m.get("max_drawdown_pct", 0.0)
        risk_score = float(np.clip(1.0 - dd / 30.0, 0.0, 1.0))
        social_score = float(np.clip(social_sentiment, 0.0, 1.0))
        vol_pref = 1.0 if archetype in ("breakout", "grid") else 0.0
        vol_level = float(np.clip(volatility / 0.05, 0.0, 1.0))
        vol_score = 1.0 - abs(vol_level - vol_pref)
        fi_score = strategy.get("feature_alignment", 0.5)

        combined = (
            regime_score * self.weights["market_regime"]
            + perf_score * self.weights["historical_performance"]
            + risk_score * self.weights["risk_profile"]
            + social_score * self.weights["social_sentiment"]
            + vol_score * self.weights["market_volatility"]
            + fi_score * self.weights["feature_importance"]
        )
        # time-of-day adjustments (`apply_time_based_adjustments:689-770`):
        # learned per-hour profile + volatility/activity windows, clamped
        combined = float(np.clip(combined, 0.0, 1.0))
        hour_detail = {}
        if hour_of_day is not None:
            hourly = strategy.get("hourly_performance")
            if hourly is None:
                # derived profile, cached keyed by trade count: it only
                # changes when a trade closes, and the selector re-scores
                # every cycle — an unkeyed cache went stale at exactly
                # that moment (r4 advisor)
                n_trades = len(strategy.get("trades", []))
                cached = strategy.get("_hourly_cache")
                if cached is not None and cached[0] == n_trades:
                    hourly = cached[1]
                else:
                    hourly = hourly_performance(strategy.get("trades", []))
                    strategy["_hourly_cache"] = (n_trades, hourly)
            perf = hourly.get(str(int(hour_of_day)), {})
            count = perf.get("trade_count", 0)
            if count >= 10:              # enough data (:733)
                hour_factor = (perf.get("win_rate", 0.5) - 0.5) * 2.0
                combined += hour_factor * 0.1            # ±10% (:735)
                hour_detail["hour_factor"] = hour_factor
            lo, hi = TIME_WINDOWS["high_volatility"]
            if lo <= hour_of_day < hi:                   # (:740-749)
                atr_mult = strategy.get("params", {}).get("atr_multiplier", 1.0)
                combined += min(atr_mult / 2.0, 1.0) * 0.05
            lo, hi = TIME_WINDOWS["low_activity"]
            if lo <= hour_of_day < hi:                   # (:752-758)
                per_hour = strategy.get("avg_trades_per_hour", 10.0)
                combined += max(0.0, 1.0 - per_hour / 20.0) * 0.05
            combined = float(np.clip(combined, 0.0, 1.0))  # (:763-765)
        return {
            "combined": combined,
            **hour_detail,
            "factors": {
                "market_regime": regime_score,
                "historical_performance": perf_score,
                "risk_profile": risk_score,
                "social_sentiment": social_score,
                "market_volatility": vol_score,
                "feature_importance": fi_score,
            },
        }

    def select(self, strategies: list[dict], **ctx) -> dict | None:
        """Highest combined score wins (`:840-870`)."""
        if not strategies:
            return None
        scored = []
        for s in strategies:
            out = self.score_strategy(s, **ctx)
            scored.append((out["combined"], s, out))
        scored.sort(key=lambda x: -x[0])
        best_score, best, detail = scored[0]
        return {**best, "selection_score": best_score,
                "factor_scores": detail["factors"]}

    def should_switch(self, current_score: float, candidate_score: float) -> bool:
        """Cooldown + minimum-edge guard (`should_switch_strategy:884`)."""
        if self.now_fn() - self._last_switch < self.switch_cooldown_s:
            return False
        return candidate_score > current_score + self.min_improvement

    def record_switch(self, strategy_id: str):
        self.current_id = strategy_id
        self._last_switch = self.now_fn()
