"""Alert rules engine.

Capability parity with `monitoring/alert_rules.yml` (15+ Prometheus rules —
ServiceDown, HighErrorRate, LowAIModelConfidence, StaleMarketData,
HighPortfolioVaR > 10 %, ExcessiveDrawdown, HighRequestLatency p95 > 5 s,
ExtremeSocialSentiment, connection failures…): the same thresholds
evaluated directly over the in-process state (MetricsRegistry + bus KV)
instead of a PromQL engine.  Fired alerts publish on the bus `alerts`
channel and are listed in the dashboard.

The port's own copy of `ai_crypto_trader_tpu/utils/alerts.py`: the same
rules, thresholds and messages, so the same state dicts fire the same
alerts.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable


@dataclass
class AlertRule:
    name: str
    severity: str                 # info | warning | critical
    predicate: Callable[[dict], bool]
    description: str = ""


def default_rules() -> list[AlertRule]:
    """The reference's alert_rules.yml thresholds."""
    return [
        AlertRule("ServiceDown", "critical",
                  lambda s: any(not h for h in s.get("service_health", {"ok": True}).values()),
                  "a service heartbeat is missing"),
        AlertRule("HighErrorRate", "warning",
                  lambda s: s.get("errors_per_min", 0.0) > 1.0,
                  "error rate above 1/min"),
        AlertRule("LowAIModelConfidence", "warning",
                  lambda s: 0.0 < s.get("ai_confidence", 1.0) < 0.4,
                  "model confidence below 0.4"),
        AlertRule("StaleMarketData", "warning",
                  lambda s: s.get("market_data_age_s", 0.0) > 300.0,
                  "no market update for 5 minutes"),
        AlertRule("HighPortfolioVaR", "critical",
                  lambda s: s.get("portfolio_var", 0.0) > 0.10,
                  "portfolio VaR above 10%"),
        AlertRule("ExcessiveDrawdown", "critical",
                  lambda s: s.get("drawdown_usd", 0.0) > 1000.0,
                  "drawdown beyond $1000"),
        AlertRule("HighRequestLatency", "warning",
                  lambda s: s.get("p95_latency_s", 0.0) > 5.0,
                  "p95 request latency above 5s"),
        AlertRule("ExtremeSocialSentiment", "info",
                  lambda s: abs(s.get("social_sentiment", 0.5) - 0.5) > 0.45,
                  "social sentiment at an extreme"),
        AlertRule("ExchangeCircuitOpen", "critical",
                  lambda s: s.get("exchange_circuit_state", "closed") == "open",
                  "exchange circuit breaker is open"),
        AlertRule("ServiceCrashLoop", "critical",
                  lambda s: bool(s.get("crash_looped_services")),
                  "a pipeline stage is quarantined after repeated crashes"),
        # --- streaming ingest (shell/stream.py) ---
        # active while the websocket feed is quarantined or stale beyond
        # its budget and the monitor is carrying the load over REST; the
        # edge-triggered StreamDisconnected/StreamFlapping alerts come
        # from the supervisor itself, the PromQL twins ride stream_mode /
        # stream_connected / stream_reconnects_total.
        AlertRule("StreamDegradedToPoll", "warning",
                  lambda s: bool(s.get("stream_degraded")),
                  "websocket feed unhealthy; monitor polling REST until "
                  "it recovers"),
        # NOT a ring-fill alert: a keep-last-N ring sits at 1.0 forever
        # by design.  This fires when a configured capture JOURNAL has
        # spent its record budget — new depth frames are no longer
        # persisted and the calibration pipeline's source goes stale.
        # The PromQL twins ride crypto_trader_tpu_depth_frames_dropped_
        # total, which counts exactly those unpersisted frames.
        AlertRule("DepthCaptureSaturated", "warning",
                  lambda s: bool(s.get("depth_journal_exhausted")),
                  "depth-capture journal budget spent; new depth frames "
                  "are no longer persisted"),
        # --- load & capacity observatory (utils/saturation.py) ---
        # saturated_stages is windowed AND min-sample gated at the source
        # (SaturationMonitor), so one compile-heavy cold tick can never
        # page; the PromQL twins gate on saturation_samples the same way.
        AlertRule("StageSaturated", "warning",
                  lambda s: bool(s.get("saturated_stages")),
                  "a pipeline stage's duty cycle is consuming most of the "
                  "tick latency budget"),
        AlertRule("BusBackpressure", "warning",
                  lambda s: bool(s.get("bus_backpressure_channels")),
                  "a bus channel queue is pinned near capacity (slow "
                  "subscriber backpressure; drop-oldest loss imminent)"),
        AlertRule("EventLoopLagHigh", "warning",
                  lambda s: (s.get("event_loop_lag_s", 0.0)
                             > s.get("event_loop_lag_budget_s", 0.25)),
                  "asyncio event-loop scheduling lag above budget — a "
                  "stage is blocking the shared loop"),
        AlertRule("MaxPositionsReached", "info",
                  lambda s: s.get("open_positions", 0) >= s.get("max_positions", 5),
                  "position slots exhausted"),
        # --- device-runtime observatory (utils/devprof.py) ---
        # burn rate = frac-of-window over the SLO target / error budget:
        # 14.4 is the classic fast-burn page (a 30 d budget gone in ~2 d),
        # 6 the slow-burn warning.  The launcher feeds `slo_burn_rates`
        # from DevProf.burn_rates(); monitoring/alert_rules.yml carries
        # the PromQL twins over crypto_trader_tpu_slo_burn_rate.
        AlertRule("LatencySLOBurnRateCritical", "critical",
                  lambda s: any(v > 14.4 for v in
                                s.get("slo_burn_rates", {}).values()),
                  "a latency SLO error budget is burning >14.4x"),
        AlertRule("LatencySLOBurnRateWarning", "warning",
                  lambda s: any(6.0 < v <= 14.4 for v in
                                s.get("slo_burn_rates", {}).values()),
                  "a latency SLO error budget is burning >6x"),
        AlertRule("DonatedBufferNotFreed", "warning",
                  lambda s: bool(s.get("donation_failures")),
                  "a donated input buffer survived its dispatch "
                  "(XLA fell back to a silent copy — doubles HBM)"),
        # --- mesh runtime observatory (utils/meshprof.py) ---
        # the recompile sentinel attributes jax.monitoring compile events
        # to named hot programs via watch windows; a compile AFTER a
        # program's warmup window (and not marked cold by the caller) is a
        # steady-state re-trace — the zero-recompile contract tests as a
        # live invariant.  The PromQL twins ride the mesh_* counters.
        AlertRule("SteadyStateRecompile", "warning",
                  lambda s: bool(s.get("steady_recompile_programs")),
                  "a carded hot program re-traced after warmup (shape "
                  "churn on the fused tick / GA / sweep paths)"),
        AlertRule("UnintendedHostTransfer", "warning",
                  lambda s: bool(s.get("guarded_transfer_programs")),
                  "a guarded dispatch pulled device data to the host "
                  "outside the sanctioned host_read seam"),
        AlertRule("MeshPaddingWasteHigh", "info",
                  lambda s: (s.get("mesh_pad_fraction_max", 0.0)
                             > s.get("mesh_pad_waste_threshold", 0.25)),
                  "a sharded program pads away more than a quarter of its "
                  "mesh lanes (ragged population vs device count)"),
        AlertRule("DeviceMemoryImbalance", "warning",
                  lambda s: (s.get("mesh_devices", 1) > 1
                             and s.get("mesh_memory_imbalance", 0.0)
                             > s.get("mesh_imbalance_threshold", 2.0)),
                  "one device holds more than its fair share of live "
                  "buffers (max/mean bytes skew across the mesh)"),
        # --- trading-quality observatory (obs/) ---
        # PSI > 0.25 is the classic "significant shift" reading; the
        # feature histograms come out of the fused tick dispatch itself
        # (ops/tick_engine.py), so this fires on live serving data.
        AlertRule("SignalDrift", "warning",
                  lambda s: s.get("feature_psi_max", 0.0) > 0.25,
                  "a live feature distribution drifted from its "
                  "reference (PSI > 0.25)"),
        # scorecard inputs only exist once a window holds min_samples
        # resolved outcomes (obs/scorecard.py alert_state), so a cold
        # start can never page.  Brier 0.35 ≈ a confident model that is
        # wrong more often than it claims; accuracy 0.45 = worse than a
        # coin on direction.
        AlertRule("ModelCalibrationBreach", "warning",
                  lambda s: s.get("model_brier_worst", 0.0) > 0.35,
                  "a model's live calibration error (Brier) breached 0.35"),
        AlertRule("ModelAccuracyDegraded", "warning",
                  lambda s: s.get("model_accuracy_worst", 1.0) < 0.45,
                  "a model's live directional accuracy fell below 0.45"),
        # --- decision critical-path observatory (obs/tickpath.py) ---
        # event→decision age is windowed AND min-sample gated at the
        # source (TickPathScope.alert_state reports p99 = 0 below
        # min_samples), so one cold tick or a restart can never page;
        # the budget rides the state so the rule evaluates the scope's
        # configuration.  The scope also names the bottleneck phase
        # (`tickpath_bottleneck_phase`) so the payload tells the operator
        # WHERE the budget went, not just that it is gone; the PromQL
        # twin rides latency_p99_seconds{slo="event_to_decision"}.
        AlertRule("DecisionLatencyBudgetBreach", "warning",
                  lambda s: (s.get("event_age_p99_ms", 0.0)
                             > s.get("event_age_budget_ms", 2000.0)),
                  "p99 venue-event→decision age breached the latency "
                  "budget — check tickpath_bottleneck_phase for the "
                  "phase that is eating it"),
        # --- fleet observatory (obs/fleetscope.py) ---
        # all four read device-aggregated inputs off the vmapped tenant
        # engine's own dispatch (FleetScope.alert_state); thresholds ride
        # the state so the rule evaluates the scope's configuration, not
        # a second hardcoded constant.  Dominance and starvation are
        # windowed + min-sample gated at the source, so a cold fleet can
        # never page.  monitoring/alert_rules.yml carries the PromQL
        # twins over the fleet_* gauges.
        AlertRule("FleetGateDominance", "warning",
                  lambda s: (s.get("fleet_gate_dominance", 0.0)
                             > s.get("fleet_gate_dominance_threshold",
                                     0.95)),
                  "one veto gate dominates the fleet's decision mix — a "
                  "config push or poisoned feed is vetoing every lane "
                  "the same way"),
        AlertRule("FleetPnLDispersionHigh", "warning",
                  lambda s: (s.get("fleet_pnl_spread", 0.0)
                             > s.get("fleet_pnl_spread_budget", 500.0)),
                  "fleet rolling-PnL dispersion (p95−p5) above budget — "
                  "lanes are diverging far beyond their shared market"),
        AlertRule("FleetLaneStarved", "warning",
                  lambda s: s.get("fleet_starved_lanes", 0) > 0,
                  "lanes produced no decision in every decide of the "
                  "window while the rest of the fleet kept deciding"),
        AlertRule("FleetBalanceDrift", "warning",
                  lambda s: (s.get("fleet_balance_drift", 0.0)
                             > s.get("fleet_balance_drift_budget", 0.01)),
                  "engine-mirror balance diverged from venue truth "
                  "beyond the re-anchor budget with no explaining "
                  "closure (fee-model error or mirror corruption)"),
        AlertRule("FleetLaneQuarantined", "warning",
                  lambda s: s.get("fleet_quarantined_lanes", 0) > 0,
                  "lanes quarantined by the in-program poison detector "
                  "(NaN/Inf in lane state or params) — masked out of "
                  "sizing/entry until the host healer re-seeds them "
                  "from venue truth"),
        AlertRule("TrainingFleetStalled", "warning",
                  lambda s: (s.get("pbt_generation_age_s", 0.0)
                             > s.get("pbt_stall_after_s", float("inf"))),
                  "the continuous PBT trainer has not completed a "
                  "generation within its stall budget — crash-looping "
                  "stage, hung dispatch, or a starved cadence"),
        AlertRule("MemberQuarantined", "warning",
                  lambda s: s.get("pbt_quarantined_members", 0) > 0,
                  "training-fleet members quarantined by the in-program "
                  "finiteness scan (NaN/Inf params, opt state or "
                  "fitness) — masked out of ranking and selection until "
                  "the forced-exploit heal clones a survivor over them"),
    ]


@dataclass
class AlertManager:
    rules: list = field(default_factory=default_rules)
    now_fn: Callable[[], float] = time.time
    active: dict = field(default_factory=dict)
    history: list = field(default_factory=list)

    def evaluate(self, state: dict) -> list[dict]:
        """Evaluate all rules; returns newly-fired alerts. Resolved alerts
        are removed from `active`."""
        fired = []
        for rule in self.rules:
            try:
                hit = bool(rule.predicate(state))
            except Exception:
                continue
            if hit and rule.name not in self.active:
                alert = {"name": rule.name, "severity": rule.severity,
                         "description": rule.description, "at": self.now_fn()}
                self.active[rule.name] = alert
                self.history.append(alert)
                fired.append(alert)
            elif not hit and rule.name in self.active:
                self.active.pop(rule.name)
        return fired
