"""Point-in-time social data for backtests — vectorized as-of joins.

Port of `ai_crypto_trader_tpu/social/provider.py`, the re-expression of
the reference's social backtest data path:

* `backtesting/data_manager.py:373-415` resamples a *daily* social series to
  the candle frequency with forward-fill, then `pd.merge_asof(...,
  direction='nearest')` joins it onto the market frame;
* `backtesting/social_data_provider.py:44-232` does scalar point-in-time
  lookups per candle (`get_social_metrics_at`), derived indicators
  (`get_social_indicators`: momentum / trend / intensity / engagement rate)
  and per-candle dict enrichment (`generate_market_update_with_social`).

The reference walks these lookups one candle at a time inside the replay
loop.  Here the whole join is two `np.searchsorted` gathers producing dense
``f32[T]`` columns up front — the compute path (the replay and the
evolvable strategy's social votes) never sees a timestamp, only aligned
arrays.  Derived indicators are computed once per *daily* row and gathered
through the same index map, so the per-candle cost is O(1) and the arrays
drop straight into `backtest.evolvable.SocialInputs`.

The joins and the indicators are host code (NumPy, the JAX package's
operations in its dtypes); `social_inputs` uploads the three columns to
``device`` (None: the CUDA card), where the replay reads them.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ai_crypto_trader_tpu_torch.backtest.evolvable import SocialInputs
from ai_crypto_trader_tpu_torch.data.ingest import SocialDaily
from ai_crypto_trader_tpu_torch.device import resolve_device, upload

# Neutral defaults used wherever no social observation precedes the candle
# (`social_data_provider.py:17-25`).
DEFAULT_METRICS = {
    "social_volume": 0.0,
    "social_engagement": 0.0,
    "social_contributors": 0.0,
    "social_sentiment": 0.5,   # neutral
    "twitter_volume": 0.0,
    "reddit_volume": 0.0,
    "news_volume": 0.0,
}

INTERVAL_SECONDS = {
    "1m": 60, "3m": 180, "5m": 300, "15m": 900, "30m": 1800,
    "1h": 3600, "2h": 7200, "4h": 14400, "6h": 21600, "8h": 28800,
    "12h": 43200, "1d": 86400, "3d": 259200, "1w": 604800,
}


def resample_ffill(ts: np.ndarray, step_s: int) -> tuple[np.ndarray, np.ndarray]:
    """Forward-fill a sparse (daily) series onto a regular grid.

    Returns ``(grid_ts, src_idx)``: grid timestamps at ``step_s`` spacing
    from the first observation to the last (inclusive), and for each grid
    point the index of the most recent source observation.  Mirrors
    ``social_data.resample(freq).ffill()`` (`data_manager.py:395-401`)
    without materializing per-column frames — one index map serves every
    column.
    """
    ts = np.asarray(ts, np.int64)
    if ts.size == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.intp)
    # pandas resample anchors the grid at the bucket floor of the first
    # observation (origin='start_day' for 1D; epoch-aligned for intraday
    # frequencies).
    origin = ts[0] - (ts[0] % step_s)
    grid = np.arange(origin, ts[-1] + 1, step_s, dtype=np.int64)
    src = np.searchsorted(ts, grid, side="right") - 1
    keep = src >= 0
    return grid[keep], src[keep]


def asof_indices(left_ts: np.ndarray, right_ts: np.ndarray,
                 direction: str = "backward") -> np.ndarray:
    """Vectorized ``merge_asof`` index map: for each left timestamp the
    chosen right-row index, -1 where no match exists.

    direction='backward' → most recent right row ≤ t (the reference's
    point-in-time rule, `social_data_provider.py:57-66`);
    direction='nearest' → closest row either side (`data_manager.py:404-409`).
    """
    left = np.asarray(left_ts, np.int64)
    right = np.asarray(right_ts, np.int64)
    if right.size == 0:
        return np.full(left.shape, -1, np.intp)
    back = np.searchsorted(right, left, side="right") - 1
    if direction == "backward":
        return back
    if direction != "nearest":
        raise ValueError(f"unknown direction {direction!r}")
    fwd = np.minimum(back + 1, right.size - 1)
    back_c = np.maximum(back, 0)
    d_back = np.abs(left - right[back_c])
    d_fwd = np.abs(right[fwd] - left)
    # ties go backward, matching pandas merge_asof nearest
    return np.where((back < 0) | (d_fwd < d_back), fwd, back_c)


def _gather(col: np.ndarray, idx: np.ndarray, default: float) -> np.ndarray:
    out = np.where(idx >= 0, col[np.maximum(idx, 0)], default)
    return np.where(np.isnan(out), default, out).astype(np.float32)


@dataclass
class SocialDataProvider:
    """Columnar point-in-time provider over a SocialDaily series.

    One instance per symbol; all methods are vectorized over a whole candle
    timestamp array (epoch-seconds).  Scalar parity methods mirror the
    reference API for the live shell.
    """

    daily: SocialDaily
    _cache: dict = field(default_factory=dict)

    # -- core join -----------------------------------------------------------
    def metrics_at(self, candle_ts: np.ndarray,
                   interval: str = "1m") -> dict[str, np.ndarray]:
        """Dense per-candle metric columns via daily→candle ffill-resample +
        nearest as-of join (`data_manager.py:373-415` semantics), defaults
        where the series starts later than the candles."""
        candle_ts = np.asarray(candle_ts, np.int64)
        step = INTERVAL_SECONDS.get(interval, 86_400)
        key = (interval, hash(candle_ts.tobytes()))
        if key not in self._cache:
            grid, src = resample_ffill(self.daily.timestamp, step)
            if grid.size == 0:
                self._cache[key] = np.full(candle_ts.shape, -1, np.intp)
            else:
                idx_grid = asof_indices(candle_ts, grid, "nearest")
                # compose candle→grid→daily into one gather map
                self._cache[key] = np.where(
                    idx_grid >= 0, src[np.maximum(idx_grid, 0)], -1)
        idx = self._cache[key]
        out = {}
        for name, default in DEFAULT_METRICS.items():
            col = self.daily.columns.get(name)
            out[name] = (np.full(candle_ts.shape, default, np.float32)
                         if col is None else _gather(col, idx, default))
        return out

    # -- derived indicators (social_data_provider.py:129-199) ---------------
    def indicators_at(self, candle_ts: np.ndarray,
                      intensity_window: int = 30) -> dict[str, np.ndarray]:
        """Momentum / trend / intensity / engagement-rate per candle.

        Each is computed once per daily row (prefix quantities over the
        daily series) and gathered with the backward as-of map — identical
        values to the reference's per-candle lookback recomputation, at
        O(days) instead of O(candles × lookback)."""
        candle_ts = np.asarray(candle_ts, np.int64)
        idx = asof_indices(candle_ts, self.daily.timestamp, "backward")
        n = len(self.daily)
        vol = self.daily.columns.get("social_volume")
        eng = self.daily.columns.get("social_engagement")
        zeros = np.zeros(candle_ts.shape, np.float32)
        if vol is None or n < 2:
            return {"social_momentum": zeros, "social_trend": zeros,
                    "social_intensity": zeros.copy(),
                    "social_engagement_rate": zeros.copy()}
        vol = np.asarray(vol, np.float64)
        # momentum: day-over-day % change of social volume (:161-166)
        mom_daily = np.zeros(n)
        mom_daily[1:] = (vol[1:] - vol[:-1]) / np.maximum(vol[:-1], 1.0) * 100.0
        # intensity: std of pct_change over a trailing window (:176-180 uses
        # the whole loaded 30-day lookback; window defaults to the same 30)
        pct = np.zeros(n)
        pct[1:] = np.where(vol[:-1] != 0.0, (vol[1:] - vol[:-1]) / vol[:-1], 0.0)
        inten_daily = np.zeros(n)
        for i in range(2, n):
            # reference: np.diff(vol[-window:]) → window-1 pct-change samples
            lo = max(1, i + 2 - intensity_window)
            w = pct[lo:i + 1]
            inten_daily[i] = w.std(ddof=1) * 100.0 if w.size > 1 else 0.0
        # engagement rate (:183-187)
        rate_daily = (np.asarray(eng, np.float64) / np.maximum(vol, 1.0)
                      if eng is not None else np.zeros(n))
        # fewer than 2 daily points as-of t → all zeros (:152-158)
        ok = idx >= 1
        mom = np.where(ok, mom_daily[np.maximum(idx, 0)], 0.0).astype(np.float32)
        trend = np.where(mom > 20.0, 1.0,
                         np.where(mom < -20.0, -1.0, 0.0)).astype(np.float32)
        inten = np.where(ok, inten_daily[np.maximum(idx, 0)], 0.0).astype(np.float32)
        rate = np.where(ok, rate_daily[np.maximum(idx, 0)], 0.0).astype(np.float32)
        return {"social_momentum": mom, "social_trend": trend,
                "social_intensity": inten, "social_engagement_rate": rate}

    # -- backtest consumption ------------------------------------------------
    def social_inputs(self, candle_ts: np.ndarray, interval: str = "1m",
                      device=None) -> SocialInputs:
        """Dense `backtest.evolvable.SocialInputs` for the candle grid, as
        float32 tensors on ``device`` (None: the CUDA card).

        Sentiment is rescaled 0-1 → 0-100 to match the evolvable genome's
        social_sentiment_threshold range (strategy.PARAM_RANGES: 50-80,
        mirroring `strategy_evolution_service.py:98-117`)."""
        dev = resolve_device(device)
        m = self.metrics_at(candle_ts, interval)
        return SocialInputs(
            sentiment=upload(m["social_sentiment"] * 100.0, dev, torch.float32),
            volume=upload(m["social_volume"], dev, torch.float32),
            engagement=upload(m["social_engagement"], dev, torch.float32),
        )

    # -- scalar parity API (live shell path) ---------------------------------
    def get_social_metrics_at(self, ts: int) -> dict:
        """Scalar point-in-time lookup (`social_data_provider.py:44-80`):
        most recent daily row ≤ ts, defaults where absent."""
        idx = int(asof_indices(np.asarray([ts]), self.daily.timestamp,
                               "backward")[0])
        if idx < 0:
            return dict(DEFAULT_METRICS)
        out = {}
        for name, default in DEFAULT_METRICS.items():
            col = self.daily.columns.get(name)
            v = default if col is None else float(col[idx])
            out[name] = default if np.isnan(v) else v
        return out

    def get_news_sentiment(self, ts: int) -> dict:
        """news_sentiment column if present, else social_sentiment, else
        neutral 0.5 (`social_data_provider.py:84-130`)."""
        idx = int(asof_indices(np.asarray([ts]), self.daily.timestamp,
                               "backward")[0])
        for name in ("news_sentiment", "social_sentiment"):
            col = self.daily.columns.get(name)
            if col is not None and idx >= 0 and not np.isnan(col[idx]):
                return {"sentiment": float(col[idx]), "recent_news": []}
        return {"sentiment": 0.5, "recent_news": []}

    def generate_market_update_with_social(self, market_update: dict,
                                           ts: int) -> dict:
        """Enrich one market-update dict (`social_data_provider.py:201-232`)."""
        out = dict(market_update)
        out.update(self.get_social_metrics_at(ts))
        out["news_sentiment"] = self.get_news_sentiment(ts)["sentiment"]
        out["recent_news"] = []
        arr = np.asarray([ts])
        ind = self.indicators_at(arr)
        trend = float(ind["social_trend"][0])
        out.update({
            "social_momentum": float(ind["social_momentum"][0]),
            "social_trend": {1.0: "bullish", -1.0: "bearish"}.get(trend, "neutral"),
            "social_intensity": float(ind["social_intensity"][0]),
            "social_engagement_rate": float(ind["social_engagement_rate"][0]),
        })
        return out
