"""Chart-pattern recognition service: interval-gated detection, signal
publication, and the combined report.

Port of `ai_crypto_trader_tpu/patterns/service.py` (the reference's
PatternRecognitionService):

  * a per-symbol update-interval gate;
  * detection over the 5m timeframe when present, else 1m, through the
    port's `detect_patterns` on ``device`` (None: the CUDA card; one host
    read a symbol);
  * signal derivation: completion % → strength label (≥ 90 very_strong
    0.9 / ≥ 75 strong 0.7 / ≥ 50 moderate 0.5 / else weak 0.3), scaled by
    confidence and completion, bias → buy / sell above the 0.3 floor;
  * ``pattern_signals`` published when the signal is not neutral and its
    strength ≥ 0.3, per-symbol pattern state stored;
  * the periodic combined report (bullish / bearish / neutral counts and
    the strongest signal).

Host-side cadence clocked by ``now_fn``.  The bus is injected and used
only through ``get``, ``set`` and ``await publish``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import numpy as np

from ai_crypto_trader_tpu_torch.device import resolve_device
from ai_crypto_trader_tpu_torch.patterns.model import PatternRecognizer, detect_patterns

STRENGTH_LABELS = ((90.0, "very_strong", 0.9), (75.0, "strong", 0.7),
                   (50.0, "moderate", 0.5), (-1.0, "weak", 0.3))


def pattern_trading_signals(analysis: dict,
                            confidence_threshold: float = 0.5) -> dict:
    """The reference's ``get_pattern_trading_signals``: an analysis →
    {signal, strength, ...}."""
    if not analysis or not analysis.get("detected"):
        return {"signal": "neutral", "strength": 0.0}
    confidence = analysis.get("confidence", 0.0)
    if confidence < confidence_threshold:
        return {"signal": "neutral", "strength": 0.0}
    completion = float(analysis.get("completion", 0.0)) * 100.0 \
        if analysis.get("completion", 0.0) <= 1.0 else float(analysis["completion"])
    implications = analysis.get("implications", {})
    bias = implications.get("bias", "neutral")

    label, numeric = "weak", 0.3
    for floor, lab, num in STRENGTH_LABELS:
        if completion >= floor:
            label, numeric = lab, num
            break
    strength = round(numeric * confidence * (completion / 100.0), 2)
    if bias == "bullish" and strength > 0.3:
        signal = "buy"
    elif bias == "bearish" and strength > 0.3:
        signal = "sell"
    else:
        signal = "neutral"
    return {
        "signal": signal, "strength": strength,
        "pattern": analysis.get("primary_pattern", "no_pattern"),
        "bias": bias, "completion": completion,
        "signal_strength": label,
        "confirmation": implications.get("confirmation", ""),
        "invalidation": implications.get("invalidation", ""),
    }


@dataclass
class ChartPatternService:
    bus: object                     # get / set / await publish
    recognizer: PatternRecognizer
    symbols: list[str]
    update_interval_s: float = 300.0
    report_interval_s: float = 300.0
    confidence_threshold: float = 0.5
    min_publish_strength: float = 0.3
    seq_len: int = 60
    stride: int = 5
    now_fn: any = None
    name: str = "patterns"
    device: Any = None

    pattern_data: dict = field(default_factory=dict)
    _last_update: dict = field(default_factory=dict)
    _last_report: float = field(default=-1e18)

    def __post_init__(self):
        self.device = resolve_device(self.device)
        if self.now_fn is None:
            import time

            self.now_fn = time.time

    def _ohlcv(self, symbol: str) -> np.ndarray | None:
        """5m timeframe preferred, 1m fallback."""
        for iv in ("5m", "1m"):
            klines = self.bus.get(f"historical_data_{symbol}_{iv}")
            if klines and len(klines) >= self.seq_len:
                return np.asarray([row[1:6] for row in klines], np.float32)
        return None

    async def analyze_symbol(self, symbol: str, now: float) -> dict | None:
        """Gate → detect → publish; returns the published signal or None."""
        if now - self._last_update.get(symbol, -1e18) < self.update_interval_s:
            return None
        ohlcv = self._ohlcv(symbol)
        if ohlcv is None:
            return None
        self._last_update[symbol] = now
        analysis = detect_patterns(
            self.recognizer, ohlcv, seq_len=self.seq_len, stride=self.stride,
            confidence_threshold=self.confidence_threshold, device=self.device)
        untrained = not getattr(self.recognizer, "trained", True)
        if untrained:
            # a random-init recognizer: keep the cadence alive but mark
            # every artifact so consumers can gate
            analysis["model_status"] = "untrained"
        self.pattern_data[symbol] = analysis
        self.bus.set(f"pattern_analysis_{symbol}", analysis)

        signals = pattern_trading_signals(analysis, self.confidence_threshold)
        if (signals["signal"] != "neutral"
                and signals["strength"] >= self.min_publish_strength):
            signals.update({"symbol": symbol, "timestamp": now,
                            "source": "pattern_recognition"})
            if untrained:
                signals["model_status"] = "untrained"
            await self.bus.publish("pattern_signals", signals)
            self.bus.set(f"pattern_signals_{symbol}", signals)
            return signals
        return None

    def combined_report(self, now: float) -> dict:
        """The reference's ``generate_combined_analysis``: non-neutral signals per
        symbol + summary counts + strongest."""
        per_symbol = {}
        for symbol, analysis in self.pattern_data.items():
            s = pattern_trading_signals(analysis, self.confidence_threshold)
            if s["signal"] != "neutral":
                per_symbol[symbol] = s
        count = lambda b: sum(1 for s in per_symbol.values() if s["bias"] == b)
        strongest = max(per_symbol.items(), key=lambda kv: kv[1]["strength"],
                        default=(None, {"strength": 0.0}))
        return {
            "timestamp": now,
            "signals": per_symbol,
            "summary": {
                "bullish_patterns": count("bullish"),
                "bearish_patterns": count("bearish"),
                # analyzed symbols whose pattern produced no actionable
                # signal (a non-neutral signal implies a directional bias,
                # so counting neutral inside per_symbol would be dead 0)
                "neutral_patterns": len(self.pattern_data) - len(per_symbol),
                "strongest_signal": {"symbol": strongest[0],
                                     **strongest[1]},
            },
        }

    async def run_once(self) -> dict:
        now = self.now_fn()
        published = 0
        for symbol in self.symbols:
            if await self.analyze_symbol(symbol, now) is not None:
                published += 1
        reported = False
        if (now - self._last_report >= self.report_interval_s
                and self.pattern_data):
            # the slot is only burned when a report is actually emitted —
            # otherwise the first real report would wait a full interval
            self._last_report = now
            self.bus.set("pattern_analysis_report", self.combined_report(now))
            reported = True
        return {"published": published, "reported": reported}
