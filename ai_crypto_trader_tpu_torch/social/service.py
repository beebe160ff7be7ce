"""Social monitoring service — the bus-facing wrapper over the analytics.

Capability parity with SocialMonitorService / EnhancedSocialMonitorService
(`services/social_monitor_service.py`, `enhanced_social_monitor_service.py`):
polling with a 300 s cache, anomaly detection on incoming metrics,
time-weighted sentiment, accuracy assessment against subsequent price moves
(:365-452), adaptive source weights, and performance reporting — publishing
`social_updates` and the per-symbol `social_metrics_{symbol}` /
`social_snapshot_{symbol}` keys the analyzer and risk adjuster consume.

The provider (LunarCrush in the reference) is injected as any callable
returning metric dicts; the deterministic default derives pseudo-social
series from price action so the full pipeline runs offline.

Port of `ai_crypto_trader_tpu/social/service.py`: the cadences, the
history and the bus payloads are host code, copied.  The analytics run on
``device`` (None: the CUDA card) through the port's `social.analyzer`:
the anomaly model (normalisation, fit, distance), the per-source accuracy
and the lead/lag correlation.  Their results come back through
`host_read`, once a call for each: one read a poll (every due symbol's
anomaly flag and score together), one an accuracy report (every symbol's
four source accuracies) and one a lead-lag report (every symbol's
correlations).  `social_snapshot_{symbol}` is a `risk.social.SocialSnapshot`
on ``device``, uploaded in one copy, where the executor's social risk
adjustment reads it.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from ai_crypto_trader_tpu_torch.device import resolve_device, upload
from ai_crypto_trader_tpu_torch.risk.social import SocialSnapshot
from ai_crypto_trader_tpu_torch.shell.bus import EventBus
from ai_crypto_trader_tpu_torch.social.analyzer import (
    detect_anomalies,
    fit_anomaly_model,
    lead_lag_correlation,
    normalize_metrics,
    sentiment_accuracy,
)
# Growing-history analytics are fed bucketed tails (see utils/shapes.py).
from ai_crypto_trader_tpu_torch.utils.shapes import bucket_len

SOURCES = ("twitter_sentiment", "reddit_sentiment", "news_sentiment",
           "overall_sentiment")
ANOMALY_FEATURES = ("social_volume", "social_engagement", "overall_sentiment")
LEAD_LAG_MAX = 24                 # lead_lag_correlation's default lag range


def host_read(values: torch.Tensor) -> list:
    """The social service's device→host read: ``values`` as (nested)
    Python floats, in one copy.  A module-level seam, so a caller can wrap
    it to count the service's reads."""
    return values.tolist()


def resample_tail(arr: np.ndarray, stride: int) -> np.ndarray:
    """Every ``stride``-th element counted from the END (the most recent
    sample is always retained) — the alignment idiom shared by every
    sentiment↔close correlation site."""
    if stride <= 1:
        return arr
    return arr[::-1][::stride][::-1]


def deterministic_provider(bus: EventBus, symbol: str) -> dict | None:
    """Offline stand-in provider: derives social-shaped metrics from recent
    price action on the bus (momentum-chasing sentiment with noise-free
    determinism)."""
    md = bus.get(f"market_data_{symbol}")
    if not md:
        return None
    chg = float(md.get("price_change_15m", 0.0))
    base = float(np.clip(0.5 + chg / 10.0, 0.05, 0.95))
    return {
        "twitter_sentiment": base,
        "reddit_sentiment": float(np.clip(base + 0.05, 0, 1)),
        "news_sentiment": float(np.clip(base - 0.05, 0, 1)),
        "overall_sentiment": base,
        "social_volume": 10_000.0 * (1.0 + abs(chg)),
        "social_engagement": 5_000.0 * (1.0 + abs(chg) / 2),
        "social_contributors": 800.0,
    }


@dataclass
class SocialMonitorService:
    bus: EventBus
    symbols: list[str] = field(default_factory=lambda: ["BTCUSDC"])
    provider: Any = None                # callable(bus, symbol) -> metrics
    cache_ttl_s: float = 300.0
    history_len: int = 500
    now_fn: Any = time.time
    # enhanced-service cadences (`enhanced_social_monitor_service.py:365-452`)
    accuracy_interval_s: float = 3600.0
    lead_lag_interval_s: float = 6 * 3600.0
    accuracy_horizon: int = 12
    name: str = "social"
    _cache: dict = field(default_factory=dict)
    _history: dict = field(default_factory=dict)   # symbol -> list of rows
    _anomaly_models: dict = field(default_factory=dict)
    _samples_since_fit: dict = field(default_factory=dict)
    _last_accuracy: float = field(default=-1e18)
    _last_lead_lag: float = field(default=-1e18)
    source_weights: dict = field(default_factory=lambda: {
        s: w for s, w in zip(SOURCES, (0.35, 0.30, 0.25, 0.10))})
    source_weights_by_symbol: dict = field(default_factory=dict)
    device: Any = None                  # None: the CUDA card

    def __post_init__(self):
        self.device = resolve_device(self.device)

    async def poll(self, force: bool = False) -> int:
        """Poll every due symbol's provider, then publish each in order.
        The due symbols' anomaly checks come back in one read."""
        provider = self.provider or deterministic_provider
        now = self.now_fn()
        due = []
        for symbol in self.symbols:
            ts, _ = self._cache.get(symbol, (-1e18, None))
            if not force and now - ts < self.cache_ttl_s:
                continue
            metrics = provider(self.bus, symbol)
            if metrics is None:
                continue
            self._cache[symbol] = (now, metrics)
            hist = self._history.setdefault(symbol, [])
            hist.append({**metrics, "ts": now})
            del hist[: -self.history_len]
            due.append((symbol, metrics, self._anomaly_scores(symbol)))

        checks = [c for _, _, c in due if c is not None]
        read = iter(host_read(torch.stack(checks)) if checks else ())
        for symbol, metrics, check in due:
            enriched = dict(metrics)
            if check is None:
                enriched["anomaly"] = {"is_anomaly": False, "score": 0.0}
            else:
                flag, score = next(read)
                enriched["anomaly"] = {"is_anomaly": bool(flag), "score": score}
            enriched["symbol"] = symbol
            enriched["timestamp"] = now

            self.bus.set(f"social_metrics_{symbol}", enriched)
            self.bus.set(f"social_snapshot_{symbol}", self._snapshot(symbol, now))
            # timestamped sentiment history for the strategy integrator —
            # timestamps let the consumer resample to ITS analysis cadence
            # instead of guessing this service's poll interval
            self.bus.set(f"social_history_{symbol}",
                         [[r["ts"], r.get("overall_sentiment", 0.5)]
                          for r in self._history[symbol]])
            await self.bus.publish("social_updates", enriched)
        return len(due)

    def _snapshot(self, symbol: str, now: float) -> SocialSnapshot:
        """Recent observations as the risk adjuster's input, on the device
        (one upload).  The window is bucketed so the risk adjustment sees a
        handful of shapes, not one per history length."""
        rows = self._history.get(symbol, [])[-24:]
        b = bucket_len(len(rows), (1, 2, 4, 8, 16, 24))
        rows = rows[-b:] if b else rows
        sent = np.asarray([[r.get(s, 0.5) for s in SOURCES] for r in rows]
                          or [[0.5] * 4], np.float32)
        ages = np.asarray([(now - r["ts"]) / 3600.0 for r in rows] or [0.0],
                          np.float32)
        quality = min(len(rows) / 6.0, 1.0)
        n = len(ages)
        packed = upload(np.concatenate([sent.reshape(-1), ages,
                                        np.asarray([quality], np.float32)]),
                        self.device)
        return SocialSnapshot(sentiments=packed[:4 * n].view(n, 4),
                              age_hours=packed[4 * n:5 * n],
                              data_quality=packed[5 * n])

    def _anomaly_scores(self, symbol: str) -> torch.Tensor | None:
        """[flag, score] of the newest row against the symbol's anomaly
        model, a float32 pair on the device; None below 50 rows."""
        hist = self._history.get(symbol, [])
        if len(hist) < 50:
            return None
        # bucketed tail: one new shape per poll would give the device a new
        # shape every poll
        hist = hist[-bucket_len(len(hist)):]
        x = upload(np.asarray([[r.get(f, 0.0) for f in ANOMALY_FEATURES]
                               for r in hist], np.float32), self.device)
        z = normalize_metrics(x, device=self.device)
        # refit every 50 appended samples (a len(hist)-based check would
        # refit on EVERY poll once the deque saturates at history_len)
        since = self._samples_since_fit.get(symbol, 50)
        if symbol not in self._anomaly_models or since >= 50:
            self._anomaly_models[symbol] = fit_anomaly_model(z, device=self.device)
            self._samples_since_fit[symbol] = 0
        self._samples_since_fit[symbol] = self._samples_since_fit.get(symbol, 0) + 1
        flag, score = detect_anomalies(self._anomaly_models[symbol], z[-1:],
                                       device=self.device)
        return torch.stack([flag[0].to(torch.float32), score[0]])

    def _accuracy_tensor(self, symbol: str, close: np.ndarray,
                         horizon: int) -> torch.Tensor | None:
        """The four sources' directional accuracies, [4] on the device;
        None when the history is too short."""
        hist = self._history.get(symbol, [])
        if len(hist) < horizon + 5:
            return None
        n = bucket_len(min(len(close), len(hist)))
        if n is None or n < horizon + 5:
            return None
        per_source = np.asarray([[r.get(s, 0.5) for r in hist[-n:]] for s in SOURCES],
                                np.float32)
        close_t = upload(np.asarray(close[-n:], np.float32), self.device)
        sent = upload(per_source, self.device)
        return torch.stack([sentiment_accuracy(sent[i], close_t, horizon,
                                               device=self.device)["accuracy"]
                            for i in range(len(SOURCES))])

    def _apply_accuracy(self, symbol: str, accuracies: list) -> dict:
        report = dict(zip(SOURCES, accuracies))
        # weights derived from the report directly (adaptive_source_weights'
        # formula) — no second accuracy pass
        floor = 0.05
        raw = {s: max(acc - 0.5, floor) for s, acc in report.items()}
        total = sum(raw.values())
        weights = {s: v / total for s, v in raw.items()}
        # per-symbol weights; the service-level weights aggregate across
        # symbols (a bare overwrite would be last-symbol-wins, order- and
        # data-availability-dependent)
        self.source_weights_by_symbol[symbol] = weights
        per_sym = list(self.source_weights_by_symbol.values())
        self.source_weights = {
            s: float(np.mean([w[s] for w in per_sym])) for s in SOURCES}
        return {"accuracy": report, "weights": weights}

    def assess_accuracy(self, symbol: str, close: np.ndarray,
                        horizon: int = 12) -> dict:
        """Accuracy assessment + adaptive re-weighting
        (`enhanced_social_monitor_service.py:365-452`); one read."""
        acc = self._accuracy_tensor(symbol, close, horizon)
        if acc is None:
            return {"status": "insufficient_history"}
        return self._apply_accuracy(symbol, host_read(acc))

    @property
    def poll_stride(self) -> int:
        """Poll cadence expressed in 1m candles."""
        return max(1, int(round(self.cache_ttl_s / 60.0))) \
            if self.cache_ttl_s > 0 else 1

    def _closes(self, symbol: str) -> np.ndarray | None:
        klines = self.bus.get(f"historical_data_{symbol}_1m")
        if not klines:
            return None
        return np.asarray([row[4] for row in klines], np.float32)

    def _sentiment_series(self, symbol: str) -> np.ndarray | None:
        hist = self._history.get(symbol, [])
        if len(hist) < 5:
            return None
        return np.asarray([r.get("overall_sentiment", 0.5) for r in hist],
                          np.float32)

    def _lead_lag_report(self) -> dict:
        """{symbol: best lag} over every symbol with enough history; the
        symbols' correlations come back in one read."""
        # closes are resampled to the POLL cadence so sentiment[i] and
        # close[i] describe the same instant — index-aligning 1m candles
        # with 300 s-cadence sentiment would scale every lag by the
        # cadence ratio. Lags are therefore in stride-minute units.
        stride = self.poll_stride
        names, corrs = [], []
        for symbol in self.symbols:
            sent, close = self._sentiment_series(symbol), self._closes(symbol)
            if sent is None or close is None:
                continue
            close = resample_tail(close, stride)
            if len(close) < 10:
                continue
            n = bucket_len(min(len(sent), len(close)))
            if n is None:
                continue
            c = close[-n:]
            returns = np.zeros(n, np.float32)
            returns[1:] = np.diff(c) / c[:-1]
            _, corr = lead_lag_correlation(upload(sent[-n:], self.device),
                                           upload(returns, self.device), LEAD_LAG_MAX,
                                           device=self.device)
            names.append(symbol)
            corrs.append(corr)
        if not names:
            return {}
        lags = np.arange(-LEAD_LAG_MAX, LEAD_LAG_MAX + 1)
        results = {}
        for symbol, row in zip(names, host_read(torch.stack(corrs))):
            row = np.asarray(row, np.float32)
            best = int(np.argmax(np.abs(row)))
            results[symbol] = {"optimal_lag": int(lags[best]),
                               "correlation": float(row[best]),
                               "lag_unit_s": stride * 60.0}
        return results

    async def run_once(self) -> dict:
        """Poll + the enhanced service's periodic analyses
        (`enhanced_social_monitor_service.py:365-452`): a lead-lag report
        every ``lead_lag_interval_s`` and a multi-symbol accuracy report
        (driving adaptive weights) every ``accuracy_interval_s``. Report
        slots are consumed only when a report is actually produced."""
        now = self.now_fn()
        published = await self.poll()
        out = {"published": published, "lead_lag": False, "accuracy": False}

        if now - self._last_lead_lag >= self.lead_lag_interval_s:
            results = self._lead_lag_report()
            if results:
                self._last_lead_lag = now
                self.bus.set("social_lead_lag_report",
                             {"timestamp": now, "symbols": results})
                out["lead_lag"] = True

        if now - self._last_accuracy >= self.accuracy_interval_s:
            report = {"symbols": {}, "timestamp": now,
                      "average_direction_accuracy": 0.0, "total_symbols": 0}
            names, accs = [], []
            for symbol in self.symbols:
                close = self._closes(symbol)
                if close is None:
                    continue
                # same poll-cadence alignment as the lead-lag block: the
                # horizon is in sentiment observations, so closes must be too
                acc = self._accuracy_tensor(
                    symbol, resample_tail(close, self.poll_stride),
                    self.accuracy_horizon)
                if acc is not None:
                    names.append(symbol)
                    accs.append(acc)
            rows = host_read(torch.stack(accs)) if accs else []
            for symbol, row in zip(names, rows):
                res = self._apply_accuracy(symbol, row)
                direction = res["accuracy"].get("overall_sentiment", 0.0)
                report["symbols"][symbol] = {
                    "direction_accuracy": direction,
                    "per_source": res["accuracy"],
                    "weights": res["weights"],
                }
                report["total_symbols"] += 1
                report["average_direction_accuracy"] += direction
            if report["total_symbols"]:
                report["average_direction_accuracy"] /= report["total_symbols"]
                self._last_accuracy = now
                self.bus.set("social_accuracy_report", report)
                out["accuracy"] = True
        return out
