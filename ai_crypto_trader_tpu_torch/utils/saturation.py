"""Saturation telemetry: USE-style per-stage utilization for the tick loop.

The three observability layers shipped so far answer "what happened"
(tracing), "what does the device cost" (devprof cost cards / SLOs) and
"why did we trade" (decision provenance).  None of them answers the
capacity question ROADMAP item 4 needs measured before the multi-tenant
refactor: *which stage saturates first as load grows, and how close is
each resource to its ceiling right now?*  Podracer (arXiv:2104.06272)
frames the same requirement for training — throughput claims only mean
something as a closed loop against a latency/utilization budget.

`SaturationMonitor` collects, per launcher tick:

  * **stage duty cycle** — busy seconds per stage divided by the tick
    latency *budget* (the tick SLO target, default 1 s).  A stage whose
    windowed duty crosses `duty_threshold` is *saturating*: it alone is
    consuming most of the latency budget the p99 SLO is written against.
    Dividing by the budget (not the measured wall) keeps the gauge
    meaningful on an idle host (tiny duty) AND under a flat-out load
    ramp (duty → 1.0 exactly when the SLO is about to breach);
  * **bus queue depth vs capacity** — per-channel utilization against the
    bus's bounded-queue capacity plus monotone high-watermarks (the
    backpressure input: a queue pinned near its bound means a subscriber
    cannot keep up and drop-oldest loss is imminent);
  * **scatter-list occupancy** — upload rows vs the fused tick engine's
    fixed scatter capacity (`TickEngine.last_stats`); a full scatter list
    forces whole-ring re-seeds, the upload cliff;
  * **host-readback share** — the one device→host sync's fraction of the
    measured tick wall time (where a device-queue stall surfaces first);
  * **asyncio event-loop lag** — scheduling delay fed from
    `utils.health.EventLoopLagProbe` (a blocking host call in any stage
    shows up here even when its own stage timer looks innocent).

Exported gauges (MetricsRegistry): ``stage_duty_cycle{stage}``,
``saturation_samples{stage}``, ``stage_busy_seconds_total{stage}``,
``bus_queue_utilization{channel}``, ``bus_queue_high_watermark{channel}``,
``scatter_list_occupancy``, ``host_readback_share``,
``event_loop_lag_seconds``, ``tenant_lanes{mode=}`` (decision lanes
served, object-lane vs vmapped tenant engine).  `alert_state()` feeds the
in-process
StageSaturated / BusBackpressure / EventLoopLagHigh rules
(utils/alerts.py); monitoring/alert_rules.yml carries the PromQL twins.
`status()` is the `capacity` block on the dashboard's /state.json.

The port's own copy of `ai_crypto_trader_tpu/utils/saturation.py`, host
code; `close_tick` reads the port's `TickEngine.last_stats`, which carries
the keys the JAX engine's does.
"""

from __future__ import annotations

import time
from collections import deque
from contextlib import contextmanager

#: duty fraction of the tick budget past which a stage counts as
#: saturating (windowed mean, min-sample gated like the SLO burn alerts)
DEFAULT_DUTY_THRESHOLD = 0.75
#: per-channel queue utilization past which backpressure is flagged
DEFAULT_BACKPRESSURE_UTILIZATION = 0.75
#: asyncio scheduling delay budget (seconds)
DEFAULT_LOOP_LAG_BUDGET_S = 0.25


class SaturationMonitor:
    """Per-tick saturation accounting for the launcher / load harness.

    Drive it once per tick: time stages via ``stage(name)`` (or
    ``observe_stage``), feed the shared-resource snapshots
    (``observe_bus`` / ``observe_engine`` / ``observe_loop_lag``), then
    ``end_tick(wall_s)`` closes the sample and ``export()`` publishes
    the gauges.  All windows are bounded deques; the disabled path in
    call sites is a single None check (the tracing/devprof discipline).
    """

    def __init__(self, metrics=None, *, tick_budget_s: float = 1.0,
                 window: int = 256, min_samples: int = 16,
                 duty_threshold: float = DEFAULT_DUTY_THRESHOLD,
                 backpressure_utilization: float =
                 DEFAULT_BACKPRESSURE_UTILIZATION,
                 loop_lag_budget_s: float = DEFAULT_LOOP_LAG_BUDGET_S):
        self.metrics = metrics
        self.tick_budget_s = float(tick_budget_s)
        self.window = int(window)
        self.min_samples = int(min_samples)
        self.duty_threshold = float(duty_threshold)
        self.backpressure_utilization = float(backpressure_utilization)
        self.loop_lag_budget_s = float(loop_lag_budget_s)
        self.ticks = 0
        self._busy: dict[str, float] = {}          # this tick's busy seconds
        self._windows: dict[str, deque] = {}       # stage -> duty samples
        self._busy_total: dict[str, float] = {}    # cumulative busy seconds
        self._engine: dict = {}                    # latest TickEngine stats
        self._engine_src: dict | None = None       # identity of last stats
        self._engine_fresh = False                 # new dispatch this tick?
        self._share_window: deque = deque(maxlen=self.window)
        self.last_loop_lag_s = 0.0
        self.last_bus: dict = {}                   # channel -> snapshot
        self.bus_watermarks: dict[str, int] = {}
        self.last_duty: dict[str, float] = {}
        self.last_wall_s = 0.0
        # tenant decision lanes currently served (tenants × symbols) and
        # how they are evaluated: "objects" = per-lane Python services,
        # "vmapped" = the batched tenant engine (ops/tenant_engine.py).
        # Exported as tenant_lanes{mode=} and carried on status().
        self.tenant_lanes = 0
        self.tenant_mode = "objects"

    # -- per-stage busy time --------------------------------------------------
    @contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.observe_stage(name, time.perf_counter() - t0)

    def observe_stage(self, name: str, busy_s: float) -> None:
        self._busy[name] = self._busy.get(name, 0.0) + max(busy_s, 0.0)

    # -- shared resources -----------------------------------------------------
    def observe_bus(self, bus) -> None:
        """Per-channel queue depth vs capacity.  ``bus`` is an EventBus:
        bounded channels saturate against ``max_queue``; "grow" channels
        are unbounded but report against the same soft limit (utilization
        past 1.0 = a backlog the soft-limit warnings are already about).

        Per-lane channels (`trading_signals.<lane>`) fold into ONE
        `trading_signals.*` family entry — depth/watermark take the max
        over lanes (the worst lane is the backpressure signal), drops
        sum.  Without the rollup a 1020-lane fleet exports 1020+ series
        per bus gauge family, eats the registry's 512-series cap, and
        silently clips unrelated channels (utils/metrics.channel_family;
        the regression test pins a 1000-lane bus under the cap)."""
        from ai_crypto_trader_tpu_torch.utils.metrics import channel_family

        cap = max(int(getattr(bus, "max_queue", 0) or 0), 1)
        sync = getattr(bus, "sync_family_depth_gauges", None)
        if sync is not None:
            # re-anchor the bus's max-held family depth gauges on the
            # true current maxes (per-tick correction of the per-publish
            # max-hold — a drained backlog must read as drained)
            sync()
        depths = bus.queue_depths()
        watermarks = getattr(bus, "depth_watermarks", {})
        agg: dict = {}
        for channel, depth in depths.items():
            fam = channel_family(channel)
            a = agg.setdefault(fam, {"depth": 0, "hw": 0, "dropped": 0,
                                     "lanes": 0})
            a["depth"] = max(a["depth"], int(depth))
            a["hw"] = max(a["hw"], int(watermarks.get(channel, 0)))
            a["dropped"] += int(bus.dropped_counts.get(channel, 0))
            a["lanes"] += 1
        snapshot = {}
        for fam, a in agg.items():
            hw = max(a["hw"], self.bus_watermarks.get(fam, 0), a["depth"])
            self.bus_watermarks[fam] = hw
            snapshot[fam] = {
                "depth": a["depth"], "capacity": cap,
                "utilization": a["depth"] / cap, "high_watermark": int(hw),
                "dropped_total": a["dropped"],
                # lanes folded into this family (1 = a plain channel)
                "channels": a["lanes"],
            }
        self.last_bus = snapshot

    def observe_engine(self, stats: dict) -> None:
        """Latest `TickEngine.last_stats` (scatter occupancy + host-read
        share ride the engine's own per-step accounting).  The engine
        builds a FRESH stats dict per dispatch, so object identity tells
        a new dispatch from a stale re-read — on a tick that never
        dispatched (outage skip, warming universe) the host-readback
        share must sample 0, not `stale host_read_s / tiny wall` = 1.0."""
        if not stats or stats is self._engine_src:
            return
        self._engine_src = stats
        self._engine = dict(stats)
        self._engine_fresh = True

    def observe_loop_lag(self, lag_s: float) -> None:
        self.last_loop_lag_s = max(float(lag_s), 0.0)

    # -- tick close-out -------------------------------------------------------
    def end_tick(self, wall_s: float) -> dict:
        """Close one tick: fold this tick's busy seconds into per-stage
        duty windows (stages that did not run this tick record duty 0 so
        windows stay aligned) and the host-readback share window.
        Returns {stage: duty} for this tick."""
        self.ticks += 1
        self.last_wall_s = max(float(wall_s), 0.0)
        budget = max(self.tick_budget_s, 1e-9)
        duty = {}
        for name in set(self._windows) | set(self._busy):
            busy = self._busy.get(name, 0.0)
            d = busy / budget
            duty[name] = d
            self._windows.setdefault(
                name, deque(maxlen=self.window)).append(d)
            if busy:
                self._busy_total[name] = self._busy_total.get(name, 0.0) + busy
        self._busy.clear()
        self.last_duty = duty
        share = 0.0
        if self._engine_fresh and self.last_wall_s > 0:
            share = min(self._engine.get("host_read_s", 0.0)
                        / self.last_wall_s, 1.0)
        self._engine_fresh = False
        self._share_window.append(share)
        return duty

    def close_tick(self, wall_s: float, *, bus=None, engine_stats=None,
                   lag_s: float | None = None) -> dict:
        """The whole per-tick close-out protocol in one call (shared by
        the launcher and the load harness so the sequence cannot drift):
        resource snapshots → duty fold → gauge export."""
        if lag_s is not None:
            self.observe_loop_lag(lag_s)
        if bus is not None:
            self.observe_bus(bus)
        if engine_stats:
            self.observe_engine(engine_stats)
        duty = self.end_tick(wall_s)
        self.export()
        return duty

    def discard_tick(self) -> None:
        """Drop the current tick's busy accumulation without folding it
        into the duty windows (warmup/compile ticks in the load harness
        would otherwise pollute the attribution surface)."""
        self._busy.clear()

    def set_tenant_lanes(self, lanes: int, mode: str = "objects") -> None:
        self.tenant_lanes = int(lanes)
        self.tenant_mode = str(mode)

    def reset_windows(self) -> None:
        """Start a fresh measurement window: clear the sliding duty /
        host-read-share quantile windows, the per-tick busy accumulation,
        bus snapshots and watermarks.  The load ramp calls this between
        steps — without it a heavy step's tail bleeds into the next
        step's windows and the bisect can converge on a STALE breach
        (the regression tests/test_loadgen.py pins).  Cumulative busy
        totals survive (they are counters, not windows)."""
        self.ticks = 0
        self._busy.clear()
        self._windows.clear()
        self._share_window.clear()
        self._engine = {}
        self._engine_src = None
        self._engine_fresh = False
        self.last_loop_lag_s = 0.0
        self.last_bus = {}
        self.bus_watermarks = {}
        self.last_duty = {}
        self.last_wall_s = 0.0

    # -- views ----------------------------------------------------------------
    def windowed_duty(self) -> dict:
        """{stage: mean duty over the window} — the attribution surface."""
        return {name: sum(w) / len(w)
                for name, w in self._windows.items() if w}

    def saturated_stages(self) -> dict:
        """Stages whose windowed duty crosses the threshold — min-sample
        gated so one compile-heavy cold tick can never page (the PR 6
        burn-alert discipline)."""
        return {name: round(sum(w) / len(w), 4)
                for name, w in self._windows.items()
                if len(w) >= self.min_samples
                and sum(w) / len(w) > self.duty_threshold}

    def bottleneck_stage(self) -> str | None:
        """The stage with the highest windowed duty (named even below the
        saturation threshold — 'what would saturate first')."""
        duty = self.windowed_duty()
        return max(duty, key=duty.get) if duty else None

    def backpressured_channels(self) -> list[str]:
        return sorted(ch for ch, s in self.last_bus.items()
                      if s["utilization"] > self.backpressure_utilization)

    def scatter_occupancy(self) -> float:
        cap = self._engine.get("scatter_capacity", 0)
        if not cap:
            return 0.0
        return min(self._engine.get("upload_rows", 0) / cap, 1.0)

    def host_read_share(self) -> float:
        if not self._share_window:
            return 0.0
        return sum(self._share_window) / len(self._share_window)

    def alert_state(self) -> dict:
        """Inputs for the in-process StageSaturated / BusBackpressure /
        EventLoopLagHigh rules (utils/alerts.py default_rules).  The lag
        budget rides along so the rule's threshold is THIS monitor's
        configuration, not a second hardcoded constant."""
        return {
            "saturated_stages": sorted(self.saturated_stages()),
            "bus_backpressure_channels": self.backpressured_channels(),
            "event_loop_lag_s": self.last_loop_lag_s,
            "event_loop_lag_budget_s": self.loop_lag_budget_s,
        }

    def export(self) -> None:
        """Publish the capacity gauges (one call per tick)."""
        m = self.metrics
        if m is None:
            return
        for name, w in self._windows.items():
            m.set_gauge("stage_duty_cycle", sum(w) / len(w), stage=name)
            m.set_gauge("saturation_samples", len(w), stage=name)
        for name, d in self.last_duty.items():
            busy = d * self.tick_budget_s
            if busy:
                m.inc("stage_busy_seconds_total", busy, stage=name)
        for channel, s in self.last_bus.items():
            m.set_gauge("bus_queue_utilization", s["utilization"],
                        channel=channel)
            m.set_gauge("bus_queue_high_watermark", s["high_watermark"],
                        channel=channel)
        m.set_gauge("scatter_list_occupancy", self.scatter_occupancy())
        m.set_gauge("host_readback_share", self.host_read_share())
        m.set_gauge("event_loop_lag_seconds", self.last_loop_lag_s)
        if self.tenant_lanes:
            m.set_gauge("tenant_lanes", self.tenant_lanes,
                        mode=self.tenant_mode)

    def status(self) -> dict:
        """JSON-able snapshot — the `capacity` block on /state.json."""
        duty = self.windowed_duty()
        return {
            "ticks": self.ticks,
            "tick_budget_s": self.tick_budget_s,
            "tenant_lanes": self.tenant_lanes,
            "tenant_mode": self.tenant_mode,
            "stage_duty": {k: round(v, 4) for k, v in sorted(duty.items())},
            "stage_busy_seconds_total": {
                k: round(v, 4)
                for k, v in sorted(self._busy_total.items())},
            "saturated_stages": self.saturated_stages(),
            "bottleneck_stage": self.bottleneck_stage(),
            "bus": self.last_bus,
            "bus_high_watermarks": dict(self.bus_watermarks),
            "scatter_list_occupancy": round(self.scatter_occupancy(), 4),
            "host_readback_share": round(self.host_read_share(), 4),
            "event_loop_lag_s": round(self.last_loop_lag_s, 6),
        }
