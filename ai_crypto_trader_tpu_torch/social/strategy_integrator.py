"""Social strategy integrator: sentiment-impact analysis → strategy variants.

Capability parity with SocialStrategyIntegrator
(`services/social_strategy_integrator.py`):
  * the four social strategy templates (trend_following / contrarian /
    news_reactive / volume_driven, :108-152) with their parameter tables,
  * sentiment-impact analysis (:400-552): correlation of sentiment with
    forward 1h/4h/24h returns, mean returns per sentiment category
    (thresholds :54-60), strongest timeframe, ±24 h lead/lag scan,
  * strategy generation (:566-662): |corr_24h| > 0.4 dispatches
    trend_following vs contrarian by sign, a leading sentiment
    (optimal lag > 3 h, corr > 0.3) dispatches news_reactive; parameters
    are tuned from the analysis (best-returning sentiment category sets the
    threshold, lookback = max(6, 2·lag), entry/exit weights rise with
    correlation strength, capped 0.8/0.7, floored 0.3/0.2 when weak),
  * the service cadence: per symbol, (re)generate when absent or stale and
    store on the bus.

The reference recomputes every correlation with per-lag pandas merges; here
one pass over dense hourly arrays produces the whole report (sentiment in
[-1, 1]; the bus-side 0-1 convention converts via ``to_signed``).

The port's own copy of `ai_crypto_trader_tpu/social/strategy_integrator.py`,
host code (float64 NumPy), over the port's `social.provider` and
`social.service` helpers.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

SENTIMENT_THRESHOLDS = {            # :54-60, sentiment ∈ [-1, 1]
    "very_negative": -0.7,
    "negative": -0.3,
    "neutral": 0.3,
    "positive": 0.7,
    "very_positive": 0.9,
}

SOCIAL_STRATEGY_TEMPLATES = {       # :108-152
    "trend_following": {
        "description": "Follows the social sentiment trend",
        "parameters": {"sentiment_threshold": 0.5, "volume_threshold": 5000,
                       "engagement_threshold": 2000, "sentiment_lookback": 24,
                       "entry_weight": 0.6, "exit_weight": 0.4},
    },
    "contrarian": {
        "description": "Takes positions contrary to extreme social sentiment",
        "parameters": {"sentiment_threshold": 0.8, "volume_threshold": 10000,
                       "engagement_threshold": 5000, "sentiment_lookback": 12,
                       "entry_weight": 0.7, "exit_weight": 0.5},
    },
    "news_reactive": {
        "description": "Reacts quickly to news sentiment changes",
        "parameters": {"sentiment_threshold": 0.3, "volume_threshold": 3000,
                       "engagement_threshold": 1500, "sentiment_lookback": 6,
                       "entry_weight": 0.8, "exit_weight": 0.7},
    },
    "volume_driven": {
        "description": "Focuses on social volume rather than sentiment",
        "parameters": {"sentiment_threshold": 0.2, "volume_threshold": 15000,
                       "engagement_threshold": 7500, "sentiment_lookback": 48,
                       "entry_weight": 0.5, "exit_weight": 0.4},
    },
}


def to_signed(sentiment01: np.ndarray) -> np.ndarray:
    """Bus convention 0-1 (0.5 neutral) → the integrator's [-1, 1]."""
    return np.asarray(sentiment01, np.float64) * 2.0 - 1.0


def _corr(a: np.ndarray, b: np.ndarray) -> float:
    mask = np.isfinite(a) & np.isfinite(b)
    if mask.sum() < 3 or a[mask].std() == 0 or b[mask].std() == 0:
        return 0.0
    return float(np.corrcoef(a[mask], b[mask])[0, 1])


def _fwd_return(close: np.ndarray, h: int) -> np.ndarray:
    """next_{h}h_return (:440-442): forward pct change over h steps."""
    out = np.full(close.shape, np.nan)
    if h < len(close):
        out[:-h] = close[h:] / close[:-h] - 1.0
    return out


def analyze_social_impact(sentiment: np.ndarray, close: np.ndarray,
                          max_lag: int = 24) -> dict:
    """Impact report over aligned hourly sentiment ∈ [-1,1] and closes
    (`analyze_social_sentiment_impact`, :400-552)."""
    sentiment = np.asarray(sentiment, np.float64)
    close = np.asarray(close, np.float64)
    n = min(len(sentiment), len(close))
    if n < 30:
        return {"error": "insufficient_data", "data_points": n}
    sentiment, close = sentiment[-n:], close[-n:]

    fwd = {h: _fwd_return(close, h) for h in (1, 4, 24)}
    correlations = {f"{h}h": _corr(sentiment, fwd[h]) for h in (1, 4, 24)}
    strongest = max(correlations.items(), key=lambda kv: abs(kv[1]))

    # returns by sentiment category (:460-487). Each name covers up to its
    # own threshold: ≤-0.7 / (-0.7,-0.3] / (-0.3,0.3] / (0.3,0.7] / >0.7.
    # (The reference's bucket loop pairs each name with the NEXT threshold,
    # leaving (-0.7,-0.3] in no bucket at all — an off-by-one we fix.)
    names = list(SENTIMENT_THRESHOLDS)
    values = list(SENTIMENT_THRESHOLDS.values())
    masks = {names[0]: sentiment <= values[0],
             names[-1]: sentiment > values[-2]}
    for i in range(1, len(names) - 1):
        masks[names[i]] = (sentiment > values[i - 1]) & (sentiment <= values[i])
    returns_by_sentiment = {}
    for name, mask in masks.items():
        if mask.sum() > 0:
            returns_by_sentiment[name] = {
                **{f"{h}h": float(np.nanmean(fwd[h][mask]) * 100.0)
                   if np.isfinite(fwd[h][mask]).any() else 0.0
                   for h in (1, 4, 24)},
                "count": int(mask.sum()),
            }

    # ±max_lag lead/lag scan (:498-531): positive lag = sentiment LEADS.
    # Lag 0 is the CONTEMPORANEOUS per-step return — reusing the 1h forward
    # correlation there would duplicate lag +1 and, winning max()'s
    # tie-break, misreport a one-step lead as "coincident".
    step_returns = np.full(close.shape, np.nan)
    step_returns[1:] = np.diff(close) / close[:-1]
    lead_lag = []
    for lag in range(-max_lag, max_lag + 1):
        if lag == 0:
            lead_lag.append((0, _corr(sentiment, step_returns)))
        elif lag > 0:
            lead_lag.append((lag, _corr(sentiment, _fwd_return(close, lag))))
        else:
            trailing = np.full(close.shape, np.nan)
            trailing[-lag:] = close[-lag:] / close[:lag] - 1.0
            lead_lag.append((lag, _corr(sentiment, trailing)))
    optimal = max(lead_lag, key=lambda kv: abs(kv[1]) if np.isfinite(kv[1]) else 0)

    return {
        "correlations": correlations,
        "strongest_timeframe": {"timeframe": strongest[0],
                                "correlation": strongest[1]},
        "returns_by_sentiment": returns_by_sentiment,
        "lead_lag_relationship": ("sentiment_leads" if optimal[0] > 0
                                  else "price_leads" if optimal[0] < 0
                                  else "coincident"),
        "optimal_lag": optimal[0],
        "optimal_lag_correlation": optimal[1],
        "data_points": n,
    }


def generate_social_strategy(symbol: str, impact: dict) -> dict:
    """Dispatch + parameter tuning (`generate_social_trading_strategy`,
    :566-662)."""
    if "error" in impact:
        return {"error": impact["error"]}

    best_type = "trend_following"
    corr_24h = impact["correlations"]["24h"]
    if abs(corr_24h) > 0.4:
        best_type = "trend_following" if corr_24h > 0 else "contrarian"
    if (impact["optimal_lag"] > 3
            and impact["optimal_lag_correlation"] > 0.3):
        best_type = "news_reactive"

    base = SOCIAL_STRATEGY_TEMPLATES[best_type]
    params = dict(base["parameters"])

    # sentiment threshold from the best-returning category (≥5 samples)
    best_cat, best_ret = None, -np.inf
    for cat, rets in impact["returns_by_sentiment"].items():
        if rets["count"] >= 5 and rets["24h"] > best_ret:
            best_cat, best_ret = cat, rets["24h"]
    if best_cat in ("positive", "very_positive"):
        params["sentiment_threshold"] = SENTIMENT_THRESHOLDS["positive"]
    elif best_cat in ("negative", "very_negative"):
        params["sentiment_threshold"] = SENTIMENT_THRESHOLDS["negative"]

    lag = abs(impact["optimal_lag"])
    if lag > 0:
        params["sentiment_lookback"] = max(6, lag * 2)

    strength = abs(impact["strongest_timeframe"]["correlation"])
    if strength > 0.3:
        params["entry_weight"] = min(0.8, 0.4 + strength)
        params["exit_weight"] = min(0.7, 0.3 + strength)
    else:
        params["entry_weight"], params["exit_weight"] = 0.3, 0.2

    return {
        "symbol": symbol,
        "strategy_type": best_type,
        "description": base["description"],
        "parameters": params,
        "impact_analysis": {
            "correlation": impact["strongest_timeframe"]["correlation"],
            "timeframe": impact["strongest_timeframe"]["timeframe"],
            "lead_lag": impact["lead_lag_relationship"],
        },
    }


@dataclass
class SocialStrategyIntegrator:
    """Bus-attached cadence (`run`, :685-720): per symbol with social
    history, (re)generate the social strategy when absent or stale."""

    bus: any
    symbols: list[str]
    now_fn: any = None
    check_interval_s: float = 3600.0
    strategy_ttl_s: float = 6 * 3600.0
    name: str = "social_strategy"
    _last_check: float = field(default=-1e18)

    def __post_init__(self):
        if self.now_fn is None:
            import time

            self.now_fn = time.time

    def _series(self, symbol: str):
        """Hourly sentiment + close from the social monitor's history and
        kline state on the bus.

        Both sides are resampled to HOURLY so the analysis' 1h/4h/24h step
        units hold: sentiment history arrives as timestamped [ts, value]
        pairs at the monitor's poll cadence and is as-of-sampled onto an
        hourly grid; 1m klines take every 60th close (index-aligning raw
        poll-cadence sentiment with hourly closes would scale every lag by
        the cadence ratio)."""
        from ai_crypto_trader_tpu_torch.social.provider import asof_indices
        from ai_crypto_trader_tpu_torch.social.service import resample_tail

        snap = self.bus.get(f"social_history_{symbol}")
        klines = self.bus.get(f"historical_data_{symbol}_1h")
        stride = 1
        if not klines:
            klines = self.bus.get(f"historical_data_{symbol}_1m")
            stride = 60
        if not snap or not klines:
            return None
        pairs = np.asarray(snap, np.float64)
        if pairs.ndim != 2 or pairs.shape[1] != 2:
            return None
        ts, values = pairs[:, 0].astype(np.int64), pairs[:, 1]
        grid = np.arange(ts[0], ts[-1] + 1, 3600, dtype=np.int64)
        idx = asof_indices(grid, ts, "backward")
        sent = to_signed(values[np.maximum(idx, 0)])
        close = resample_tail(
            np.asarray([row[4] for row in klines], np.float64), stride)
        return sent, close

    async def run_once(self) -> dict:
        now = self.now_fn()
        if now - self._last_check < self.check_interval_s:
            return {"generated": 0}
        generated = 0
        processed_any = False
        for symbol in self.symbols:
            existing = self.bus.get(f"social_strategy_{symbol}")
            if existing and now - existing.get("generation_time", -1e18) \
                    < self.strategy_ttl_s:
                processed_any = True       # fresh strategy = cadence working
                continue
            series = self._series(symbol)
            if series is None:
                continue
            processed_any = True
            impact = analyze_social_impact(*series)
            self.bus.set(f"social_impact_analysis_{symbol}", impact)
            strategy = generate_social_strategy(symbol, impact)
            if "error" not in strategy:
                strategy["generation_time"] = now
                self.bus.set(f"social_strategy_{symbol}", strategy)
                await self.bus.publish("social_strategy_updates", strategy)
                generated += 1
        if processed_any:
            # slot burned only when some symbol was processable — data
            # arriving just after an empty tick shouldn't wait a full
            # check interval (same pattern as the report cadences)
            self._last_check = now
        return {"generated": generated}
