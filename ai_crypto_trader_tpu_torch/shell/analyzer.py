"""Signal analyzer service: market_updates → AI gate → trading_signals.

Capability parity with AIAnalyzerService (`services/ai_analyzer_service.py`):
per-symbol analysis-interval gate (60 s, :382), market-context assembly from
technical + social + news inputs (:153-380), LLM analysis via the adapter,
and publication of `trading_signals` carrying decision/confidence plus the
technical signal (the executor cross-checks both, as in the reference).

Port of `ai_crypto_trader_tpu/shell/analyzer.py`: host code, copied, over
the port's `LLMTrader` (the offline `TechnicalPolicyBackend` by default),
`strategy.explain` and `obs.tickpath`'s event age.  The trade-outcome gate
and the flight recorder stay injected (``None`` by default); the trading
system (`shell.launcher`) wires its `obs.flightrec.FlightRecorder` in.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

from ai_crypto_trader_tpu_torch.obs import tickpath
from ai_crypto_trader_tpu_torch.shell.bus import EventBus
from ai_crypto_trader_tpu_torch.shell.llm import LLMTrader
from ai_crypto_trader_tpu_torch.utils import tracing


def _flat_features(ctx: dict) -> dict:
    """Flatten one level of nested context dicts (social/news/pattern) into
    the flat numeric feature namespace the pruned outcome model was fitted
    on (FEATURE_GROUPS names like social_sentiment) — nested dicts would
    otherwise silently read as 0.0 in the gate."""
    flat = {k: v for k, v in ctx.items() if isinstance(v, (int, float))}
    for v in ctx.values():
        if isinstance(v, dict):
            for k2, v2 in v.items():
                if isinstance(v2, (int, float)) and k2 not in flat:
                    flat[k2] = v2
    return flat


@dataclass
class SignalAnalyzer:
    bus: EventBus
    trader: LLMTrader = field(default_factory=LLMTrader)
    analysis_interval_s: float = 60.0
    now_fn: any = time.time
    # Optional trade-outcome gate (strategy.integration
    # FeatureImportanceIntegrator or models.trade_importance analyzer): BUY
    # decisions whose pruned-model success probability falls below the
    # threshold are downgraded to HOLD (the integrator consumption path,
    # `services/model_integration.py:220-288`).
    outcome_model: any = None
    min_success_probability: float = 0.45
    # Decision-provenance flight recorder (obs/flightrec.py), wired by the
    # launcher (default-on there).  None = disabled: every call site below
    # is a single attribute check, the tracing/devprof discipline.
    flightrec: any = None
    # Tenant-lane tag (ROADMAP item 4 / testing/loadgen.py): when set,
    # signals carry `lane` AND publish on the per-lane channel
    # `trading_signals.<lane>`, so each tenant's executor subscribes to
    # exactly its own lane — N tenants cost O(N) bus fanout, not N² with
    # consumer-side filtering.  None (the default, the one-tenant
    # launcher) keeps the shared `trading_signals` channel untagged.
    lane: str | None = None
    _last_analysis: dict = field(default_factory=dict)

    def _decision_features(self, update: dict) -> dict:
        """The compact feature/confluence slice the flight recorder keeps
        per decision — enough to answer `cli why` without replaying the
        whole market payload."""
        keys = ("current_price", "signal", "signal_strength", "confluence",
                "rsi", "macd", "volatility", "trend", "trend_strength",
                "top_family", "top_family_score", "structure_version",
                "structure_blend")
        return {k: update[k] for k in keys if k in update}

    def _prediction_snapshot(self, symbol: str) -> dict:
        """Each architecture's live prediction for this symbol (the
        nn_prediction_* bus keys the prediction service maintains)."""
        out = {}
        for key in self.bus.keys(f"nn_prediction_{symbol}_*"):
            p = self.bus.get(key)
            if not isinstance(p, dict):
                continue
            tag = f"{p.get('model_type', 'nn')}:{p.get('interval', '?')}"
            out[tag] = {k: p[k] for k in ("predicted_price", "confidence",
                                          "reference_price", "horizon_s")
                        if k in p}
        return out

    def _build_context(self, update: dict) -> dict:
        """Market context string/dict (`ai_analyzer_service.py:153-380`) —
        technical core plus whatever social/news state services posted."""
        ctx = dict(update)
        symbol = update["symbol"]
        social = self.bus.get(f"social_metrics_{symbol}")
        if social:
            ctx["social"] = social
        news = self.bus.get(f"news_analysis_{symbol}")
        if news:
            ctx["news"] = news
        pattern = self.bus.get(f"pattern_signals_{symbol}")
        if pattern:
            ctx["chart_pattern"] = pattern
        return ctx

    async def handle_update(self, update: dict) -> dict | None:
        """Process one market update; returns the published signal or None
        when gated."""
        symbol = update["symbol"]
        now = self.now_fn()
        fr = self.flightrec
        rec_id = None
        if now - self._last_analysis.get(symbol, -1e18) < self.analysis_interval_s:
            # throttle hit — the COMMON path (every poll between analysis
            # cadences).  Counted, not recorded: no feature slice, no
            # bus-wide prediction-snapshot scan, no ring slot — the hot
            # path stays O(1) and real decisions own the ring.
            if fr is not None:
                fr.throttled(symbol)
            return None
        self._last_analysis[symbol] = now
        # event→decision age (obs/tickpath.py): venue event time E (the
        # monitor stamps `event_ms` onto the update) → this decision.
        # The scope clamps a negative age (host clock behind the venue)
        # to 0 and counts tickpath_clock_skew_total; None when the
        # observatory is off (the field then stays unset on the record).
        event_age_ms = None
        ev_ms = update.get("event_ms")
        if ev_ms:
            event_age_ms = tickpath.observe_event_age(
                now * 1000.0 - float(ev_ms))
        if fr is not None:
            rec_id = fr.begin(symbol,
                              features=self._decision_features(update),
                              predictions=self._prediction_snapshot(symbol),
                              event_age_ms=event_age_ms)

        ctx = self._build_context(update)
        analysis = await self.trader.analyze_trade_opportunity(ctx)
        signal = {
            "symbol": symbol,
            "timestamp": now,
            "current_price": update["current_price"],
            "signal": update.get("signal", "NEUTRAL"),
            "signal_strength": update.get("signal_strength", 0.0),
            "volatility": update.get("volatility", 0.0),
            "avg_volume": update.get("avg_volume", 0.0),
            "decision": analysis.get("decision", "HOLD"),
            "confidence": float(analysis.get("confidence", 0.0)),
            "reasoning": analysis.get("reasoning", ""),
            "model_version": analysis.get("model_version"),
            # entry-signal provenance riding to the executor and, for
            # executed trades, into the journal closure records the PnL
            # attribution folds (obs/attribution.py)
            "top_family": update.get("top_family"),
            "structure_version": update.get("structure_version"),
        }
        channel = "trading_signals"
        if self.lane is not None:
            signal["lane"] = self.lane
            channel = f"trading_signals.{self.lane}"
        if rec_id is not None:
            signal["decision_id"] = rec_id
        outcome_veto = None
        if self.outcome_model is not None and signal["decision"] == "BUY":
            outcome = self.outcome_model.predict_trade_outcome(
                _flat_features(ctx))
            signal["success_probability"] = outcome["success_probability"]
            if (outcome["status"] == "success"
                    and outcome["success_probability"]
                    < self.min_success_probability):
                signal["decision"] = "HOLD"
                signal["reasoning"] = (
                    f"{signal['reasoning']} [outcome gate: win probability "
                    f"{outcome['success_probability']:.2f} < "
                    f"{self.min_success_probability:.2f}]").strip()
                # the veto is TERMINAL (journals the record) — deferred
                # until after set_verdict below so the durable copy carries
                # the verdict + explanation, not just the gate
                outcome_veto = f"p={outcome['success_probability']:.2f}"
        await self.bus.publish(channel, signal)
        self.bus.set(f"latest_signal_{symbol}", signal)
        # structured explanation per signal (AIExplainabilityService consumes
        # trading_signals, `services/ai_explainability_service.py:138-354`;
        # the dashboard's drill-down panel renders this bounded history)
        from ai_crypto_trader_tpu_torch.strategy.explain import explain_signal

        explanation = explain_signal({**update, **signal})
        self.bus.set(f"explanation_{symbol}", explanation)
        history = self.bus.get("explanations") or []
        history.append(explanation)
        self.bus.set("explanations", history[-50:])
        if fr is not None:
            # the verdict + structured explanation land on the decision
            # record BEFORE the executor finalizes it (veto/execution)
            fr.set_verdict(rec_id, {
                "decision": signal["decision"],
                "confidence": signal["confidence"],
                "model_version": signal.get("model_version"),
            }, explanation=explanation)
            if outcome_veto is not None:
                fr.veto(rec_id, "outcome_probability", detail=outcome_veto)
        return signal

    def _queue(self):
        # Persistent subscription — a fresh queue per drain would miss every
        # message published before the drain started.
        if not hasattr(self, "_q"):
            self._q = self.bus.subscribe("market_updates")
        return self._q

    async def run_once(self) -> int:
        """Drain pending market_updates (used by tests / the launcher tick)."""
        n = 0
        q = self._queue()
        while not q.empty():
            env = q.get_nowait()
            # span parents to the publish that produced this envelope (the
            # carried trace context), so one trace_id follows the tick
            # across the service boundary
            with tracing.consumer_span(
                    env, "analyzer.handle_update", service="analyzer",
                    attributes={"symbol": env["data"].get("symbol")}) as sp:
                signal = await self.handle_update(env["data"])
                if signal:
                    sp.set_attribute("decision", signal.get("decision"))
                    n += 1
                else:
                    sp.set_attribute("gated", True)
        return n
