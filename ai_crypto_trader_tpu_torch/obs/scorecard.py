"""Live prediction-outcome scoring: the model-quality scorecard.

The port's own copy of `ai_crypto_trader_tpu/obs/scorecard.py` (pure
Python; the port imports nothing of the JAX package).  When a published
prediction's horizon elapses, the realized candle is read from the
monitor's bus kline window and the outcome feeds rolling windows per
(architecture, symbol, interval):

  * directional accuracy — sign(predicted − reference) vs realized,
  * hit rate             — |predicted − realized| within ``hit_tolerance``,
  * Brier score          — mean (confidence − correct)².

Everything is keyed by the klines' own timestamps (milliseconds), so a
virtual clock and a wall clock behave alike.  ``adoption_gate`` compares a
candidate's score against the incumbent's (live windows, or offline
scores handed in — the PBT winner's simulator fitness,
`rl.population.adopt_winner`), and ``record_adoption`` keeps the verdict
trail.  The bus is injected and read only through ``keys`` and ``get``.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field


def _sign(x: float) -> int:
    return (x > 0) - (x < 0)


@dataclass
class Scorecard:
    bus: object = None
    metrics: object = None
    now_fn: object = time.time
    window: int = 256              # outcomes kept per (arch, symbol, interval)
    min_samples: int = 16          # below this, scores are not "live" yet
    hit_tolerance: float = 0.005   # |pred-realized|/realized for a "hit"
    # a prediction whose realized candle never shows up (symbol dropped,
    # venue gap) expires after this many horizons instead of leaking
    expire_horizons: float = 50.0

    _pending: dict = field(default_factory=dict)   # (s, iv, ref_ts) -> payload
    _last_ref: dict = field(default_factory=dict)  # (s, iv) -> newest ref_ts
    _stats: dict = field(default_factory=dict)     # (arch, s, iv) -> deque
    resolved_total: int = 0
    expired_total: int = 0
    # adoption-gate verdict trail (bounded): every candidate that passed
    # through `adoption_gate` on its way into the registry — the PBT
    # trainer records each generation's winner here so operators can see
    # WHY a policy went active or shadow without grepping a journal
    adoptions: deque = field(default_factory=lambda: deque(maxlen=64))

    # -- intake --------------------------------------------------------------
    def record_prediction(self, payload: dict) -> bool:
        """Register one prediction for future resolution.  Needs the
        explicit provenance fields the service now snapshots:
        ``reference_ts`` (ms), ``horizon_s``, ``reference_price``,
        ``predicted_price``, ``model_type``.  Returns True if queued."""
        s, iv = payload.get("symbol"), payload.get("interval")
        ref_ts = payload.get("reference_ts")
        if not s or not iv or ref_ts is None \
                or payload.get("horizon_s") is None \
                or payload.get("reference_price") is None:
            return False
        if self._last_ref.get((s, iv), -1) >= ref_ts:
            return False                   # already registered this forecast
        self._last_ref[(s, iv)] = ref_ts
        self._pending[(s, iv, ref_ts)] = dict(payload)
        return True

    def observe_bus(self) -> int:
        """Sweep every ``nn_prediction_*`` bus key (the launcher drives
        this each tick — polling KV state like every other consumer, no
        subscription plumbing; whatever (symbol, interval) pairs the
        prediction service serves are picked up automatically)."""
        if self.bus is None:
            return 0
        n = 0
        for key in self.bus.keys("nn_prediction_*"):
            p = self.bus.get(key)
            if isinstance(p, dict) and self.record_prediction(p):
                n += 1
        return n

    # -- resolution ----------------------------------------------------------
    def _klines(self, symbol: str, interval: str):
        if self.bus is None:
            return None
        return self.bus.get(f"historical_data_{symbol}_{interval}")

    def resolve_due(self, klines_fn=None) -> int:
        """Resolve every pending prediction whose horizon has elapsed in
        KLINE TIME: realized price = close of the first candle at/after
        reference_ts + horizon.  The window the monitor already holds is
        the only data source — zero additional I/O."""
        klines_fn = klines_fn or self._klines
        resolved = 0
        for key, p in list(self._pending.items()):
            s, iv, ref_ts = key
            horizon_ms = float(p["horizon_s"]) * 1000.0
            rows = klines_fn(s, iv)
            if not rows:
                continue
            due_ts = ref_ts + horizon_ms
            realized = None
            for j, row in enumerate(rows):
                if float(row[0]) >= due_ts:
                    # never score against the NEWEST row: live venues
                    # include the still-forming candle as the last kline,
                    # whose close is a transient mid-candle price.  A later
                    # row existing proves this one closed.
                    if j < len(rows) - 1:
                        realized = float(row[4])   # close column
                    break
            if realized is None:
                newest = float(rows[-1][0])
                if newest - ref_ts > horizon_ms * self.expire_horizons:
                    self._pending.pop(key, None)   # unresolvable: expire
                    self.expired_total += 1
                continue
            self._pending.pop(key, None)
            self._score(p, realized)
            resolved += 1
        return resolved

    def _score(self, p: dict, realized: float) -> None:
        arch = p.get("model_type") or "unknown"
        s, iv = p["symbol"], p["interval"]
        ref = float(p["reference_price"])
        pred = float(p["predicted_price"])
        conf = min(max(float(p.get("confidence") or 0.0), 0.0), 1.0)
        correct = _sign(pred - ref) == _sign(realized - ref)
        denom = max(abs(realized), 1e-9)
        hit = abs(pred - realized) / denom <= self.hit_tolerance
        brier = (conf - (1.0 if correct else 0.0)) ** 2
        q = self._stats.setdefault((arch, s, iv), deque(maxlen=self.window))
        q.append((bool(correct), bool(hit), float(brier)))
        self.resolved_total += 1
        if self.metrics is not None:
            self.metrics.inc("model_outcomes_resolved_total",
                             arch=arch, symbol=s, interval=iv)

    # -- scores --------------------------------------------------------------
    def scores(self) -> dict:
        out = {}
        for (arch, s, iv), q in self._stats.items():
            n = len(q)
            if n == 0:
                continue
            out[(arch, s, iv)] = {
                "n": n,
                "directional_accuracy": sum(c for c, _, _ in q) / n,
                "hit_rate": sum(h for _, h, _ in q) / n,
                "brier": sum(b for _, _, b in q) / n,
                "live": n >= self.min_samples,
            }
        return out

    def live_score(self, arch: str, symbol: str, interval: str) -> float | None:
        """The adoption-gate score: directional accuracy over the window,
        None until ``min_samples`` outcomes have resolved."""
        q = self._stats.get((arch, symbol, interval))
        if not q or len(q) < self.min_samples:
            return None
        return sum(c for c, _, _ in q) / len(q)

    def adoption_gate(self, candidate_arch: str, incumbent_arch: str,
                      symbol: str, interval: str,
                      candidate_score: float | None = None,
                      incumbent_score: float | None = None
                      ) -> tuple[bool, str]:
        """May ``candidate_arch`` replace ``incumbent_arch`` live?

        Blocks only a candidate with a KNOWN-WORSE score than a scored
        incumbent; an unscored candidate passes flagged (it has never
        served, so it has no live score to compare — the registry
        records the adoption as shadow-grade).

        Scores default to the live directional-accuracy windows; the
        ``candidate_score`` / ``incumbent_score`` overrides let OFFLINE
        champions gate on a shared offline metric instead — the PBT
        winner (rl/population.py) submits simulator fitness for both
        sides, so a freshly trained policy that never served live can
        still be refused when it is measurably worse than the incumbent
        policy on the same simulated markets."""
        if candidate_arch == incumbent_arch:
            return True, "same_architecture"
        inc = (incumbent_score if incumbent_score is not None
               else self.live_score(incumbent_arch, symbol, interval))
        cand = (candidate_score if candidate_score is not None
                else self.live_score(candidate_arch, symbol, interval))
        if inc is None:
            return True, "incumbent_unscored"
        if cand is None:
            return True, "candidate_unscored"
        if cand > inc:
            return True, "candidate_better"
        return False, (f"candidate {candidate_arch} live score {cand:.3f} "
                       f"<= incumbent {incumbent_arch} {inc:.3f}")

    def record_adoption(self, verdict: dict) -> dict:
        """Append one adoption-gate verdict (``{"version", "adopted",
        "reason", "fitness", ...}`` — the `rl/population.adopt_winner`
        return shape plus caller context) to the bounded trail and stamp
        it with the scorecard clock.  Returns the stored record."""
        rec = dict(verdict, at=self.now_fn())
        self.adoptions.append(rec)
        return rec

    # -- export --------------------------------------------------------------
    def export(self) -> None:
        m = self.metrics
        if m is None:
            return
        for (arch, s, iv), sc in self.scores().items():
            m.set_gauge("model_directional_accuracy",
                        sc["directional_accuracy"],
                        arch=arch, symbol=s, interval=iv)
            m.set_gauge("model_hit_rate", sc["hit_rate"],
                        arch=arch, symbol=s, interval=iv)
            m.set_gauge("model_brier_score", sc["brier"],
                        arch=arch, symbol=s, interval=iv)
        m.set_gauge("model_predictions_pending", len(self._pending))

    def alert_state(self) -> dict:
        """Worst-case inputs for the in-process alert rules, only from
        windows with ``min_samples`` outcomes (a 2-sample window must not
        page)."""
        live = [sc for sc in self.scores().values() if sc["live"]]
        out = {}
        if live:
            out["model_accuracy_worst"] = min(
                sc["directional_accuracy"] for sc in live)
            out["model_brier_worst"] = max(sc["brier"] for sc in live)
        return out

    def status(self) -> dict:
        out = {"pending": len(self._pending),
               "resolved": self.resolved_total,
               "expired": self.expired_total,
               "groups": {f"{a}:{s}:{iv}": sc for (a, s, iv), sc
                          in self.scores().items()}}
        if self.adoptions:
            out["adoptions"] = list(self.adoptions)[-8:]
        return out
