"""The all-in-one launcher — `run_trader.py` re-designed.

The reference launches 14 daemon threads each spinning a private asyncio
loop plus an AutoTrader and a 5-second status printer
(`run_trader.py:1326-1494`).  Here every service is an async task on ONE
event loop sharing ONE bus (no GIL-bound thread zoo), with the numeric work
already living inside jit on the device:

    monitor → analyzer → executor            (the live signal path)
    evolver                                  (periodic strategy evolution)
    alerts + metrics + dashboard             (observability)

`TradingSystem.tick()` advances everything once (deterministic, used by
tests and paper-mode stepping); `run()` is the wall-clock loop.

Port of `ai_crypto_trader_tpu/shell/launcher.py`: the wiring, the stage
supervision, the observability rim and the books are host code, copied,
with the same fields, `status()` keys, bus keys and metric names.  The
system computes on ``device`` (None: the CUDA card, ``RuntimeError``
without one; ``"cpu"`` on request): it hands the device to the
`MarketMonitor` (its `TickEngine`, three launches of the fused-EWMA kernel
a poll), the `TradeExecutor`, the scanner of `with_discovery` and the risk
block's `risk.var` calls, whose results come back through `host_read`
(one read of the four VaR figures a tick, one of the correlation matrix).
`build_info` records torch's version, the backend and the card's name
where the JAX package records jax's.  `attach_stream` makes a
`shell.stream.StreamSupervisor` the market-data path: its drain is the
monitor's poll on the system's device, fed by the stream's candle books.
The options whose modules are not ported yet (`enable_devprof`,
`enable_meshprof`, `aot_cache_dir`) raise `NotImplementedError`; their
defaults behave as the JAX package's.
"""

from __future__ import annotations

import asyncio
import time
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from ai_crypto_trader_tpu_torch.config import FrameworkConfig
from ai_crypto_trader_tpu_torch.device import resolve_device
from ai_crypto_trader_tpu_torch.shell.analyzer import SignalAnalyzer
from ai_crypto_trader_tpu_torch.shell.bus import EventBus
from ai_crypto_trader_tpu_torch.shell.dashboard import write_dashboard
from ai_crypto_trader_tpu_torch.shell.exchange import ExchangeInterface
from ai_crypto_trader_tpu_torch.shell.executor import TradeExecutor
from ai_crypto_trader_tpu_torch.shell.monitor import MarketMonitor
from ai_crypto_trader_tpu_torch.utils import tracing
from ai_crypto_trader_tpu_torch.utils.alerts import AlertManager
from ai_crypto_trader_tpu_torch.utils.health import EventLoopLagProbe, HeartbeatRegistry
from ai_crypto_trader_tpu_torch.utils.metrics import MetricsRegistry
from ai_crypto_trader_tpu_torch.utils.saturation import SaturationMonitor


def host_read(values: torch.Tensor) -> list:
    """The risk block's device→host read: ``values`` as (nested) Python
    floats, in one copy.  A module-level seam, so a caller can wrap it to
    count the system's reads."""
    return values.tolist()


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to ai_crypto_trader_tpu_torch yet "
        "(ROADMAP item 16)")


@dataclass
class TradingSystem:
    exchange: ExchangeInterface
    symbols: list[str]
    config: FrameworkConfig = field(default_factory=FrameworkConfig)
    now_fn: any = time.time
    dashboard_path: str | None = None
    # Optional cadence services (objects with .name and async run_once(), e.g.
    # models.service.PredictionService): driven every tick, exchange-independent
    # — they read/write only the bus, so an exchange outage doesn't skip them.
    extra_services: list = field(default_factory=list)
    # Structured JSON-lines log sink (utils/structlog.py); None → no file.
    log_path: str | None = None
    # End-to-end tracing (utils/tracing.py). Default OFF: the disabled hot
    # path is a single module-global check. `enable_tracing=True` activates
    # span collection (ring buffer + dashboard /traces); `trace_jsonl`
    # additionally appends every finished span to a JSONL file (implies
    # enable_tracing).
    enable_tracing: bool = False
    trace_jsonl: str | None = None
    # Device-runtime observatory (utils/devprof.py) and mesh runtime
    # observatory (utils/meshprof.py): not ported yet, so True raises.
    enable_devprof: bool = False
    enable_meshprof: bool = False
    # Fleet observatory (obs/fleetscope.py). Default OFF like tracing
    # (disabled hot path = one module-global check).
    # When on: any vmapped TenantEngine in this process emits its
    # device-aggregated fleet block (gate histogram, PnL/balance
    # dispersion quantiles, top-k lane rank) through its own dispatch,
    # the fleet_* gauges land on this system's registry, /state.json
    # gains a `fleet` block, and the Fleet* alert rules arm.  The
    # launcher's own one-tenant objects deployment produces no fleet
    # data — the flag exists for vmapped deployments sharing the stack.
    enable_fleetscope: bool = False
    # Crash-safe trading state (utils/journal.py): when set, the executor
    # write-ahead-journals every order intent/ack/closure here, and
    # `recover()` replays + reconciles it after a restart.
    journal_path: str | None = None
    # Durable FLEET state (utils/journal.py SnapshotJournal): when set
    # and a vmapped TenantEngine is attached (attach_tenant_engine),
    # `fleet_checkpoint()` writes periodic checksummed snapshots of the
    # [N] lane-state mirror here and `recover()` restores the newest
    # intact one before per-lane venue reconciliation — the journal_path
    # story extended from one object lane to the whole batch axis.
    fleet_journal_path: str | None = None
    # Decision provenance & model quality (obs/): the flight recorder is
    # DEFAULT-ON — one compact record per (symbol, tick) decision in a
    # bounded ring (dashboard /decisions, `cli why`); `flightrec_path`
    # additionally appends each terminal decision/fill/closure as a
    # checksummed JSONL record that survives restarts.  The prediction
    # scorecard and PnL attribution ride the same flag.
    enable_flightrec: bool = True
    flightrec_path: str | None = None
    # Decision critical-path observatory (obs/tickpath.py). DEFAULT-ON
    # like the flight recorder: the per-tick phase waterfall (frame_wait →
    # parse → scatter_build → dispatch → device_compute → host_read →
    # publish → analyzer → executor), the named bottleneck phase, overlap
    # headroom, the event→decision age SLO behind
    # DecisionLatencyBudgetBreach, and the cold-start compile ledger —
    # the measurement substrate for the ROADMAP item-4 pipelining work.
    # Measured fused-tick overhead is budgeted ≤5% (stamped by the bench
    # stream_latency row); the disabled path is one module-global check.
    enable_tickpath: bool = True
    # Pipelined tick path (ROADMAP item 4, ops/tick_engine.py): the fused
    # monitor double-buffers the candle ring and publishes tick T−1 while
    # T computes on device — host work overlaps device_compute, and the
    # waterfall's host_read collapses into reclaimed overlap
    # (tickpath_overlap_reclaimed_seconds).  Serial (False) stays the
    # default and the parity oracle.
    pipelined: bool = False
    # Matmul precision for the fused decide programs ("bf16" = the PR 2
    # reduced-precision knob threaded through tick/tenant engines);
    # None = full f32.
    precision: str | None = None
    # Persistent AOT compile cache (utils/aotcache.py): not ported yet,
    # so a directory raises.
    aot_cache_dir: str | None = None
    # Stage supervision (utils/supervision.py): a non-ExchangeUnavailable
    # exception inside monitor/analyzer/executor is isolated with
    # exponential backoff; N consecutive failures quarantine the stage
    # (heartbeat withheld, ServiceCrashLoop alert) while the rest of the
    # system keeps ticking.
    stage_max_failures: int = 3
    stage_backoff_s: float = 2.0
    stage_quarantine_s: float = 300.0
    # Saturation telemetry (utils/saturation.py): USE-style per-stage duty
    # cycles against the tick latency budget, bus queue utilization +
    # high-watermarks, scatter-list occupancy, host-readback share and
    # asyncio event-loop lag — the capacity axis ROADMAP item 4 measures.
    # Default ON: the cost is a handful of perf_counter reads per tick.
    enable_saturation: bool = True
    tick_budget_s: float = 1.0        # the tick latency SLO target the
    #                                   duty cycles are normalized against
    # Streaming ingest (shell/stream.py, wired via attach_stream): while a
    # stream is attached AND healthy, the websocket feed carries market
    # data (zero REST kline calls) and the polling monitor stands down;
    # quarantine or staleness past the supervisor's budget degrades back
    # to REST polling, and a SL/TP ticker price older than
    # `ticker_fence_s` (exchange EVENT time) is fenced off — a delayed
    # feed must not drive stop maintenance with stale prices.
    ticker_fence_s: float = 10.0
    # where the monitor, the executor, the scanner and the risk block
    # compute: None = the CUDA card, "cpu" = the CPU
    device: Any = None

    @classmethod
    def with_discovery(cls, exchange, scanner=None, **kw):
        """Build the system on a scanner-discovered symbol universe instead
        of a configured list — the reference's CryptoScanner feeding
        AutoTrader (`binance_ml_strategy.py:293-468` → `auto_trader.py:601`),
        as a construction mode: discovery runs once up front and the chosen
        universe drives monitor/analyzer/executor."""
        from ai_crypto_trader_tpu_torch.shell.scanner import MarketScanner

        scanner = scanner or MarketScanner(exchange, device=kw.get("device"))
        symbols = scanner.top_symbols()
        if not symbols:
            raise ValueError(
                "scanner found no eligible symbols (volume/volatility "
                "filters rejected the whole universe)")
        system = cls(exchange, symbols, **kw)
        system.scanner = scanner
        return system

    def __post_init__(self):
        from ai_crypto_trader_tpu_torch.utils.structlog import StructuredLogger

        self.device = resolve_device(self.device)
        for flag, what in ((self.enable_devprof, "enable_devprof (utils/devprof)"),
                           (self.enable_meshprof, "enable_meshprof (utils/meshprof)"),
                           (self.aot_cache_dir, "aot_cache_dir (utils/aotcache)")):
            if flag:
                raise _not_ported(what)

        self.log = StructuredLogger("launcher", path=self.log_path,
                                    now_fn=self.now_fn)
        self.metrics = MetricsRegistry(now_fn=self.now_fn)
        self.tracer = None
        if self.enable_tracing or self.trace_jsonl:
            self.tracer = tracing.configure(tracing.Tracer(
                service="trader", now_fn=self.now_fn,
                jsonl_path=self.trace_jsonl, metrics=self.metrics))
            # build-vs-execute attribution for every traced dispatch, plus
            # the kernel_build_seconds histogram
            tracing.KernelBuildMonitor.install(metrics=self.metrics)
        self.devprof = None                # utils/devprof: not ported yet
        self.meshprof = None               # utils/meshprof: not ported yet
        self.fleetscope = None
        if self.enable_fleetscope:
            from ai_crypto_trader_tpu_torch.obs import fleetscope as fleet_mod

            self.fleetscope = fleet_mod.configure(
                fleet_mod.FleetScope(metrics=self.metrics))
        self.tickpath = None
        if self.enable_tickpath:
            from ai_crypto_trader_tpu_torch.obs import tickpath as tickpath_mod

            self.tickpath = tickpath_mod.configure(
                tickpath_mod.TickPathScope(metrics=self.metrics))
        # build provenance (/state.json `build`, `cli status`): which
        # runtime produced the numbers an operator is reading
        self.build_info = {"process_start": self.now_fn(),
                           "torch_version": torch.__version__,
                           "backend": self.device.type,
                           "device_kind": (torch.cuda.get_device_name(self.device)
                                           if self.device.type == "cuda" else "cpu")}
        self.aot_cache = None              # utils/aotcache: not ported yet
        # bus telemetry: fanout latency + queue depth metrics, and slow-
        # subscriber warnings through the structured log (trace-correlated)
        self.bus = EventBus(now_fn=self.now_fn, metrics=self.metrics,
                            log=self.log.child("bus"))
        self.alerts = AlertManager(now_fn=self.now_fn)
        self.heartbeats = HeartbeatRegistry(now_fn=self.now_fn,
                                            log=self.log.child("health"))
        # load & capacity observatory (utils/saturation.py): per-stage duty
        # vs the tick budget, bus/scatter/host-readback utilization and the
        # event-loop lag probe — exported every tick, feeds the
        # StageSaturated/BusBackpressure/EventLoopLagHigh rules and the
        # /state.json `capacity` block
        self.saturation = (SaturationMonitor(metrics=self.metrics,
                                             tick_budget_s=self.tick_budget_s)
                           if self.enable_saturation else None)
        if self.saturation is not None:
            # the launcher is the one-tenant deployment: its decision
            # lanes are 1 tenant × the symbol universe, evaluated through
            # per-symbol Python services — tenant_lanes{mode="objects"}.
            # The vmapped tenant engine (ops/tenant_engine.py) stamps
            # mode="vmapped" through the load harness.
            self.saturation.set_tenant_lanes(len(self.symbols), "objects")
        self.loop_lag = EventLoopLagProbe()
        # decision provenance & model quality (obs/): flight recorder +
        # prediction scorecard + PnL attribution, default-on (the trading
        # twin of the device observatory; disabled path = one None check)
        self.flightrec = None
        self.scorecard = None
        self.attribution = None
        if self.enable_flightrec or self.flightrec_path:
            from ai_crypto_trader_tpu_torch.obs.attribution import PnLAttribution
            from ai_crypto_trader_tpu_torch.obs.flightrec import FlightRecorder
            from ai_crypto_trader_tpu_torch.obs.scorecard import Scorecard

            self.flightrec = FlightRecorder(path=self.flightrec_path,
                                            metrics=self.metrics,
                                            now_fn=self.now_fn)
            self.scorecard = Scorecard(bus=self.bus, metrics=self.metrics,
                                       now_fn=self.now_fn)
            self.attribution = PnLAttribution(metrics=self.metrics)
        self._attr_cursor = 0
        self.monitor = MarketMonitor(self.bus, self.exchange,
                                     symbols=self.symbols, now_fn=self.now_fn,
                                     pipelined=self.pipelined,
                                     precision=self.precision,
                                     device=self.device)
        self.analyzer = SignalAnalyzer(
            self.bus, now_fn=self.now_fn, flightrec=self.flightrec,
            analysis_interval_s=self.config.trading.ai_analysis_interval)
        self.journal = None
        if self.journal_path:
            from ai_crypto_trader_tpu_torch.utils.journal import WriteAheadJournal

            self.journal = WriteAheadJournal(self.journal_path,
                                             now_fn=self.now_fn)
        self.tenant_engine = None          # via attach_tenant_engine
        self.fleet_journal = None
        if self.fleet_journal_path:
            from ai_crypto_trader_tpu_torch.utils.journal import SnapshotJournal

            self.fleet_journal = SnapshotJournal(self.fleet_journal_path,
                                                 now_fn=self.now_fn)
        self.executor = TradeExecutor(self.bus, self.exchange,
                                      trading=self.config.trading,
                                      trailing=self.config.risk.trailing_stop,
                                      now_fn=self.now_fn,
                                      journal=self.journal,
                                      flightrec=self.flightrec,
                                      device=self.device)
        from ai_crypto_trader_tpu_torch.utils.supervision import StageBreaker

        self.stage_breakers = {
            name: StageBreaker(name,
                               max_failures=self.stage_max_failures,
                               base_backoff_s=self.stage_backoff_s,
                               quarantine_s=self.stage_quarantine_s)
            for name in ("monitor", "analyzer", "executor")}
        # register every core stage up front: a stage that crashes before
        # its FIRST beat still shows (unhealthy) in service_health
        for name in self.stage_breakers:
            self.heartbeats.expect(name)
        # subscribe before any publish so tick-0 messages aren't missed
        self.analyzer._queue()
        self.executor._queue()
        self._last_market_update = self.now_fn()
        self._logged_closures = 0
        self.stream = None                 # StreamSupervisor via attach_stream
        self._stream_degraded = True       # polling until the feed is healthy

    def attach_stream(self, supervisor) -> None:
        """Register a shell/stream.StreamSupervisor as the market-data
        path: its `step()` runs as a supervised stage each tick, the
        polling monitor automatically resumes while the stream is
        quarantined or stale, and hands back when it recovers."""
        from ai_crypto_trader_tpu_torch.utils.supervision import StageBreaker

        if supervisor.bus is None:
            supervisor.bus = self.bus
        if supervisor.metrics is None:
            supervisor.metrics = self.metrics
        self.stream = supervisor
        self.stage_breakers["stream"] = StageBreaker(
            "stream", max_failures=self.stage_max_failures,
            base_backoff_s=self.stage_backoff_s,
            quarantine_s=self.stage_quarantine_s)
        self.heartbeats.expect("stream")

    def attach_tenant_engine(self, engine) -> None:
        """Register a vmapped ops/tenant_engine.TenantEngine with this
        system's durability rim: `fleet_checkpoint()` snapshots its [N]
        lane-state mirror into the fleet journal and `recover()` restores
        the newest intact snapshot before per-lane reconciliation."""
        self.tenant_engine = engine

    def attach_trainer(self, service) -> None:
        """Register a rl/trainer_service.PBTTrainerService under FULL
        stage supervision: unlike plain ``extra_services`` entries (which
        only get exception isolation), an attached trainer gets its own
        StageBreaker — a crash-looping training loop backs off and
        quarantines like a core stage (`TrainingFleetStalled` then fires
        off its withheld generation timestamps) — and its
        ``alert_state()`` feeds the in-process rule engine each tick."""
        from ai_crypto_trader_tpu_torch.utils.supervision import StageBreaker

        if getattr(service, "metrics", None) is None:
            service.metrics = self.metrics
        name = getattr(service, "name", "trainer")
        self.stage_breakers[name] = StageBreaker(
            name, max_failures=self.stage_max_failures,
            base_backoff_s=self.stage_backoff_s,
            quarantine_s=self.stage_quarantine_s)
        self.heartbeats.expect(name)
        self.extra_services.append(service)

    def fleet_checkpoint(self) -> int | None:
        """Durably snapshot the attached tenant engine's lane mirror as
        one checksummed WAL record (bounded by the snapshot journal's
        compaction).  ZERO extra device syncs: the mirror is already
        host-side after each decide's one host_read.  Returns the
        snapshot record's sequence number, or None when no engine/journal
        is wired."""
        if self.tenant_engine is None or self.fleet_journal is None:
            return None
        return self.fleet_journal.write(self.tenant_engine.snapshot())

    async def recover(self, journal_path: str | None = None) -> dict:
        """Restart recovery: replay the write-ahead journal into the
        executor's books, reconcile against exchange ground truth
        (re-adopt live protective orders, finalize positions that closed
        while we were down, cancel orphans), and compact the journal.
        Call once after construction, before the first tick."""
        journal = self.journal
        if journal_path is not None and (journal is None
                                         or journal.path != journal_path):
            from ai_crypto_trader_tpu_torch.utils.journal import WriteAheadJournal

            journal = WriteAheadJournal(journal_path, now_fn=self.now_fn)
            self.journal = self.executor.journal = journal
        if journal is None:
            raise ValueError("recover() needs a journal_path (ctor or arg)")
        report = await self.executor.recover_from_journal(journal)
        if self.tenant_engine is not None and self.fleet_journal is not None:
            # fleet restore rides the same recovery pass: newest intact
            # snapshot (torn tails fall back to the previous one) rebuilds
            # the [N] lane mirrors; venue truth then re-anchors lane by
            # lane through the sync_positions/sync_balance seams exactly
            # as it does every steady-state tick
            from ai_crypto_trader_tpu_torch.utils.journal import load_snapshot

            payload, snap_stats = load_snapshot(self.fleet_journal.path)
            if payload is not None:
                fleet = self.tenant_engine.restore(payload)
                fleet["snapshot_torn_tail"] = snap_stats["torn_tail"]
                report["fleet"] = fleet
                self.log.info("restored fleet state from snapshot",
                              journal=self.fleet_journal.path, **fleet)
        # replayed closures were logged by the previous process — only NEW
        # closures from here on produce structured trade-closed lines
        self._logged_closures = len(self.executor.closed_trades)
        self.log.info("recovered trading state from journal",
                      journal=journal.path, **{
                          k: v for k, v in report.items() if k != "journal"})
        self.metrics.set_gauge("open_positions",
                               len(self.executor.active_trades))
        return report

    async def tick(self) -> dict:
        """One full pass of the live signal path + observability.

        With tracing enabled the whole pass runs under one root `tick` span
        so monitor publish → analyzer handling → executor → model predict
        all share one trace_id (the envelope-carried context additionally
        parents each consumer span to the exact publish that caused it).

        An exchange outage (open breaker / exhausted retries surfacing as
        ExchangeUnavailable from the resilient adapter) skips the affected
        stage for this tick instead of killing the loop — the reference's
        services likewise treat a circuit-broken call as a skipped cycle
        (`market_monitor_service.py:96-115`)."""
        with tracing.span("tick", service="launcher") as sp:
            out = await self._tick_inner()
            sp.set_attribute("published", out.get("published", 0))
            sp.set_attribute("analyzed", out.get("analyzed", 0))
            sp.set_attribute("executed", out.get("executed", 0))
        if self.saturation is not None:
            # one true loop yield per tick: completes the event-loop-lag
            # probe's callback (sampled at the top of the tick — a stage
            # that blocked the loop shows up as the measured delay) and
            # lets call_soon work queued by stages actually run in
            # tick-driven harnesses that never otherwise suspend
            await asyncio.sleep(0)
        return out

    async def _run_stage(self, name: str, fn):
        """Supervised stage execution: success beats the heartbeat;
        ExchangeUnavailable propagates (the skip-tick path); any OTHER
        exception is isolated here — backoff, then quarantine after N
        consecutive failures — so one crash-looping stage can never kill
        `run()` while the rest of the system stays alive."""
        from ai_crypto_trader_tpu_torch.shell.exchange import ExchangeUnavailable

        br = self.stage_breakers[name]
        now = self.now_fn()
        if not br.should_run(now):
            if (name == "executor" and br.quarantined
                    and self.flightrec is not None):
                # published decisions the quarantined executor will not
                # drain record their gate instead of dangling "open"
                self.flightrec.mark_open("quarantine")
            return None                    # backoff/quarantine window
        t0 = time.perf_counter()
        try:
            out = await fn()
        except ExchangeUnavailable:
            raise                          # outage semantics unchanged
        except asyncio.CancelledError:
            raise
        except Exception as exc:           # noqa: BLE001 — stage isolation
            tripped = br.record_failure(self.now_fn(), error=str(exc))
            self.metrics.inc("errors_total", kind=f"stage_{name}")
            self.metrics.set_gauge("stage_consecutive_failures", br.failures,
                                   stage=name)
            self.log.error("stage failure isolated", stage=name,
                           error=f"{type(exc).__name__}: {exc}",
                           consecutive=br.failures, quarantined=br.quarantined)
            await self.bus.publish("alerts", {
                "name": "StageError", "severity": "warning", "service": name,
                "message": f"{type(exc).__name__}: {exc}",
                "at": self.now_fn()})
            if tripped:
                self.metrics.inc("stage_quarantines_total", stage=name)
                if name == "executor" and self.flightrec is not None:
                    self.flightrec.mark_open("quarantine")
                await self.bus.publish("alerts", {
                    "name": "ServiceCrashLoop", "severity": "critical",
                    "service": name, "failures": br.failures,
                    "message": f"stage {name} quarantined after "
                               f"{br.failures} consecutive failures",
                    "at": self.now_fn()})
            return None
        finally:
            # busy-time accounting on EVERY exit path (success, isolated
            # failure, outage) — the duty-cycle gauge must charge a stage
            # for the time it burned even when the tick skips
            if self.saturation is not None:
                self.saturation.observe_stage(name,
                                              time.perf_counter() - t0)
            if self.tickpath is not None and name in ("analyzer",
                                                      "executor"):
                # the waterfall's downstream phases: analyzer/executor
                # drains ride the same stage timing saturation charges
                self.tickpath.observe_phase(name, time.perf_counter() - t0)
        if br.record_success(self.now_fn()):
            self.log.info("stage recovered from crash loop", stage=name)
            await self.bus.publish("alerts", {
                "name": "ServiceCrashLoopRecovered", "severity": "info",
                "service": name, "at": self.now_fn()})
        self.metrics.set_gauge("stage_consecutive_failures", 0, stage=name)
        self.heartbeats.beat(name)
        return out

    async def _poll_market(self) -> int:
        """Market-data stage with the degradation ladder.

        No stream attached → the REST polling monitor (unchanged).  With a
        stream: the supervised `stream` stage drains queued frames through
        the monitor's publication path (the stream's candle books as the
        kline source — zero REST on the happy path); while the stage is
        quarantined or the feed is stale beyond its budget the polling
        monitor AUTOMATICALLY resumes, and hands back once the stream is
        healthy again.  The `stream_mode` gauge (1 = streaming,
        0 = degraded to poll) makes every transition observable."""
        if self.stream is None:
            return await self._run_stage("monitor", self.monitor.poll) or 0
        published = await self._run_stage("stream", self._stream_stage) or 0
        # gauges are re-exported here, NOT only inside step(): a failing or
        # quarantined stage never reaches step()'s export, and Prometheus
        # would keep scraping the last healthy-looking stream_* values
        # during exactly the outage the PromQL alerts exist for
        self.stream.export(self.now_fn())
        degraded = (self.stage_breakers["stream"].quarantined
                    or self.stream.degraded(self.now_fn()))
        if degraded != self._stream_degraded:
            self._stream_degraded = degraded
            if degraded:
                self.log.warning("stream degraded; monitor resuming REST "
                                 "polling", staleness_s=round(
                                     self.stream.staleness(self.now_fn()), 1))
            else:
                self.log.info("stream healthy; polling monitor stands down")
        self.metrics.set_gauge("stream_mode", 0.0 if degraded else 1.0)
        if degraded:
            published += await self._run_stage("monitor",
                                               self.monitor.poll) or 0
        return published

    async def _stream_stage(self):
        n = await self.stream.step()
        if not self.stream.degraded(self.now_fn()):
            # the monitor's DUTY (market-data publication) was genuinely
            # served through the healthy stream's drain — beat its
            # heartbeat.  While DEGRADED the polling monitor beats for
            # itself (or doesn't), so a total market-data outage still
            # fires ServiceDown(monitor).
            self.heartbeats.beat("monitor")
        return n

    def _sl_tp_price(self, symbol: str, now: float) -> float | None:
        """Price driving the executor's SL/TP maintenance: the stream's
        sub-candle ticker when its EXCHANGE EVENT time is fresh (within
        `ticker_fence_s`), else the last published candle close.  A stale
        stream price is fenced off — event time, not receive time, is the
        authority (a delayed feed stamps old events with fresh arrivals)."""
        md = self.bus.get(f"market_data_{symbol}")
        price = md.get("current_price") if md else None
        tick = self.bus.get(f"ticker_{symbol}")
        if tick is not None:
            event_t = tick.get("event_time", tick.get("timestamp", 0.0))
            if now - event_t <= self.ticker_fence_s:
                price = tick.get("price", price)
        return price

    async def _executor_stage(self):
        executed = await self.executor.run_once()
        now = self.now_fn()
        for symbol in self.symbols:
            if symbol not in self.executor.active_trades:
                continue
            price = self._sl_tp_price(symbol, now)
            if price is not None:
                await self.executor.on_price(symbol, price)
        return executed

    async def _tick_inner(self) -> dict:
        from ai_crypto_trader_tpu_torch.shell.exchange import ExchangeUnavailable

        published = analyzed = executed = 0
        if self.saturation is not None:
            # lag measurement armed BEFORE the stages: a blocking host
            # call anywhere below delays the callback's completion, and
            # the next tick's close-out reads the measured delay
            self.loop_lag.sample()
        t0 = time.perf_counter()      # wall time: now_fn may be a virtual
        #                               clock in paper mode, and the latency
        #                               panel must show real compute time
        try:
            published = await self._poll_market()
            if published:
                self._last_market_update = self.now_fn()
            analyzed = await self._run_stage("analyzer",
                                             self.analyzer.run_once) or 0
            executed = await self._run_stage("executor",
                                             self._executor_stage) or 0
            balances = self.exchange.get_balances()
        except ExchangeUnavailable as exc:
            self.metrics.inc("errors_total", kind="exchange_unavailable")
            # work done before the outage hit still counts — the rate
            # panels would otherwise under-report exactly during outages
            self.metrics.inc("market_updates_total", published)
            self.metrics.inc("trading_signals_total", analyzed)
            self.metrics.inc("signals_processed_total", executed)
            self.metrics.observe("tick_duration_seconds",
                                 time.perf_counter() - t0)
            self._emit_health_gauges()
            self._observe_saturation(time.perf_counter() - t0)
            self.log.warning("exchange unavailable; tick skipped",
                             error=str(exc))
            await self.bus.publish("alerts", {
                "name": "ExchangeUnavailable", "severity": "warning",
                "message": str(exc), "at": self.now_fn()})
            await self._run_extra_services()
            # Still evaluate the rule-based alerts: a sustained outage is
            # exactly when StaleMarketData / service-health alerts must
            # fire (and show on the dashboard, which renders alerts.active).
            fired = await self._fire_alerts()
            if self.dashboard_path:
                self._render_dashboard()
            return {"published": published, "analyzed": analyzed,
                    "executed": executed, "alerts": 1 + len(fired),
                    "skipped": str(exc)}
        await self._run_extra_services()
        self._observe_trading_quality()
        # total portfolio value: quote balances + base holdings marked at the
        # latest price (free USDC alone would show a phantom loss while a
        # position is open); dedup by base asset via the shared helper
        from ai_crypto_trader_tpu_torch.utils.symbols import mark_holdings

        total = sum(mark_holdings(
            balances, self.symbols,
            lambda s: self.bus.get(f"market_data_{s}")).values())
        self.metrics.set_gauge("portfolio_value_usd", total)
        # bounded portfolio-value history: the dashboard's main time-series
        # panel (reference dashboard.py portfolio chart)
        pv = self.bus.get("portfolio_value_history") or []
        pv.append({"t": self.now_fn(), "value": total})
        self.bus.set("portfolio_value_history", pv[-500:])
        self.metrics.set_gauge("open_positions", len(self.executor.active_trades))
        # the series the Grafana system-overview dashboard panels query
        # (monitoring/grafana/provisioning/dashboards/system_overview.json)
        self.metrics.inc("market_updates_total", published)
        self.metrics.inc("trading_signals_total", analyzed)
        self.metrics.inc("signals_processed_total", executed)
        self.metrics.set_gauge("closed_trades", self.executor.closed_count())
        self.metrics.observe("tick_duration_seconds",
                             time.perf_counter() - t0)
        self._emit_health_gauges()
        self._observe_saturation(time.perf_counter() - t0)
        self._peak_value = max(getattr(self, "_peak_value", total), total)
        self.metrics.set_gauge("drawdown_usd", self._peak_value - total)
        for symbol in self.symbols:
            sig = self.bus.get(f"latest_signal_{symbol}")
            if sig:
                self.metrics.set_gauge("ai_model_confidence",
                                       sig.get("confidence", 0.0),
                                       symbol=symbol)
            soc = self.bus.get(f"social_metrics_{symbol}")
            if soc:
                self.metrics.set_gauge("social_sentiment",
                                       soc.get("overall_sentiment", 0.5),
                                       symbol=symbol)
        # Snapshot for out-of-loop readers (dashboard server handler
        # threads): they must never call the exchange themselves — that
        # would burn trading rate-limit tokens and, in paper mode, advance
        # the simulation's virtual clock from a foreign thread.
        self._status_cache = self._status_from(balances, total)

        # structured trade-closure records (the aggregation pipeline's most
        # queried events; reference logs these per service)
        n_closed = len(self.executor.closed_trades)
        for rec in self.executor.closed_trades[self._logged_closures:n_closed]:
            self.log.info("trade closed", **rec)
        self._logged_closures = n_closed

        self._update_risk()
        fired = await self._fire_alerts()
        if self.dashboard_path:
            self._render_dashboard()
        return {"published": published, "analyzed": analyzed,
                "executed": executed, "alerts": len(fired)}

    def _observe_trading_quality(self):
        """Per-tick drive of the trading-quality observatory (obs/):

        * scorecard — register fresh predictions off the bus, resolve the
          ones whose horizon elapsed against the kline windows already in
          memory, export hit-rate/accuracy/Brier gauges;
        * drift — export the monitor's on-device PSI as
          ``feature_psi{symbol, feature}`` gauges (SignalDrift input);
        * attribution — fold new journal closures into per-source
          realized-PnL / win-rate gauges + the dashboard card's bus key;
        * flight recorder — ring-size gauge.
        """
        sc = self.scorecard
        if sc is not None:
            sc.observe_bus()
            sc.resolve_due()
            sc.export()
            self.bus.set("model_scorecard", sc.status()["groups"])
        for symbol, feats in self.monitor.last_drift.items():
            for feature, value in feats.items():
                self.metrics.set_gauge("feature_psi", value,
                                       symbol=symbol, feature=feature)
        closed = self.executor.closed_trades
        self._attr_cursor = min(self._attr_cursor, len(closed))
        if self.attribution is not None and self._attr_cursor < len(closed):
            self._attr_cursor = self.attribution.fold_new(closed,
                                                          self._attr_cursor)
            self.attribution.export()
            self.bus.set("pnl_attribution", self.attribution.summary())
        if self.flightrec is not None:
            self.flightrec.export()

    def _observe_saturation(self, wall_s: float):
        """Close one tick's saturation sample (both tick paths, like the
        health gauges): shared-resource snapshots → duty-cycle fold →
        gauge export.  The loop-lag reading is the probe measurement
        armed at the top of the tick (one per tick, completed at the
        tick-end loop yield — any blocking host call in between lands
        in it)."""
        sat = self.saturation
        if sat is None:
            return
        eng = getattr(self.monitor, "_engine", None)
        sat.close_tick(wall_s, bus=self.bus,
                       engine_stats=eng.last_stats if eng is not None
                       else None,
                       lag_s=self.loop_lag.last_lag_s)

    def _emit_health_gauges(self):
        """Health/alert-rule gauges (monitoring/alert_rules.yml). Emitted on
        BOTH tick paths — an open circuit or stale heartbeat must be visible
        to Prometheus precisely during the outage ticks that skip the main
        body, or ExchangeCircuitOpen/ServiceDown could never fire."""
        for service, healthy in self.heartbeats.health().items():
            self.metrics.set_gauge("service_health", 1.0 if healthy else 0.0,
                                   service=service)
        for service, beat_t in self.heartbeats.beats.items():
            self.metrics.set_gauge("heartbeat_timestamp", beat_t,
                                   service=service)
        # continuous staleness per registered service: Grafana graphs the
        # drift toward the threshold, not just the ServiceDown edge
        for service, age in self.heartbeats.staleness().items():
            self.metrics.set_gauge("heartbeat_staleness_seconds", age,
                                   service=service)
        if self.tickpath is not None:
            # decision critical-path export: per-phase p50/p99, the named
            # bottleneck, overlap headroom, event-age SLO and cold-start
            # totals — on BOTH tick paths, so the waterfall stays live
            # through outages too
            self.tickpath.export()
        self.metrics.set_gauge("last_market_update_timestamp",
                               self._last_market_update)
        self.metrics.set_gauge("max_positions",
                               self.config.trading.max_positions)
        breaker = self.monitor.breaker or getattr(self.exchange, "breaker",
                                                  None)
        if breaker is not None:
            # label key is `breaker` (not `name`): `name` is the metric-name
            # parameter of set_gauge itself
            self.metrics.set_gauge(
                "circuit_state",
                {"closed": 0.0, "open": 1.0, "half_open": 0.5}.get(
                    breaker.state.value, 0.0),
                breaker=breaker.name)

    def _update_risk(self):
        """Portfolio risk from live bus data (PortfolioRiskService parity,
        `services/portfolio_risk_service.py:217-328`): equal-weight VaR /
        CVaR over the symbols' kline returns, the cross-asset correlation
        matrix, and a bounded VaR history — the state behind the
        dashboard's risk, heatmap and VaR-history panels."""
        from ai_crypto_trader_tpu_torch.risk import (
            correlation_matrix, cvar, historical_var, parametric_var)

        rets, syms = [], []
        interval = self.monitor.intervals[0]
        for s in self.symbols:
            kl = self.bus.get(f"historical_data_{s}_{interval}")
            if not kl or len(kl) < 32:
                continue
            close = np.asarray([row[4] for row in kl], np.float32)
            rets.append(np.diff(close) / close[:-1])
            syms.append(s)
        if not rets:
            return
        n = min(len(r) for r in rets)
        matrix = np.stack([r[-n:] for r in rets])
        port = torch.from_numpy(matrix.mean(axis=0)).to(self.device)
        dev = self.device
        # float32 on the device, the four figures in one host read
        var95, var99, pvar, cv = host_read(torch.stack([
            historical_var(port, device=dev), historical_var(port, 0.99, device=dev),
            parametric_var(port, device=dev), cvar(port, device=dev)]))
        risk = {
            "var_95_pct": var95 * 100.0,
            "var_99_pct": var99 * 100.0,
            "parametric_var_95_pct": pvar * 100.0,
            "cvar_95_pct": cv * 100.0,
            "n_assets": len(syms),
        }
        self.bus.set("risk_metrics", risk)
        self.metrics.set_gauge("portfolio_var_pct", risk["var_95_pct"])
        if len(syms) >= 2:
            corr = host_read(correlation_matrix(torch.from_numpy(matrix).to(dev),
                                                device=dev))
            self.bus.set("correlation_matrix",
                         {"symbols": syms, "matrix": corr})
        history = self.bus.get("var_history") or []
        history.append({"t": self.now_fn(), "var_95": risk["var_95_pct"]})
        self.bus.set("var_history", history[-500:])

    def _alert_state(self) -> dict:
        """State for the rule set in utils/alerts.py default_rules —
        including the LowAIModelConfidence / ExtremeSocialSentiment inputs
        (worst case across symbols)."""
        state = {
            "market_data_age_s": self.now_fn() - self._last_market_update,
            "open_positions": len(self.executor.active_trades),
            "max_positions": self.config.trading.max_positions,
            "service_health": self.heartbeats.health(),
            "crash_looped_services": [n for n, b in self.stage_breakers.items()
                                      if b.quarantined],
        }
        if self.stream is not None:
            # degrade-to-poll visibility: the in-process rule engine's
            # StreamDegradedToPoll input (PromQL twin: stream_mode == 0)
            state["stream_degraded"] = self._stream_degraded
            state["stream_staleness_s"] = self.stream.staleness(self.now_fn())
            # depth-capture persistence health (DepthCaptureSaturated
            # input; PromQL twin: depth_frames_dropped_total counting
            # the unpersisted frames)
            capture = getattr(self.stream.stream, "depth", None)
            if capture is not None:
                state["depth_journal_exhausted"] = capture.journal_exhausted
                state["depth_ring_fill"] = capture.watermark
        if self.saturation is not None:
            # capacity observatory inputs: saturating stages (windowed,
            # min-sample gated), backpressured bus channels, loop lag
            state.update(self.saturation.alert_state())
        if self.tickpath is not None:
            # decision critical-path inputs: event→decision p99 vs budget
            # (DecisionLatencyBudgetBreach) with the bottleneck phase the
            # alert payload names
            state.update(self.tickpath.alert_state())
        if self.fleetscope is not None and self.fleetscope.decides:
            # fleet observatory inputs: gate dominance, PnL dispersion,
            # lane starvation and balance drift off the vmapped tenant
            # engine's device aggregates (only once a fleet has decided —
            # the launcher's own objects deployment produces none)
            state.update(self.fleetscope.alert_state())
        # trading-quality observatory inputs (obs/): worst live model
        # calibration/accuracy and the max on-device feature PSI
        if self.scorecard is not None:
            state.update(self.scorecard.alert_state())
        # cadence services that publish rule inputs (the PBT trainer's
        # TrainingFleetStalled / MemberQuarantined predicates read these)
        for svc in self.extra_services:
            svc_state = getattr(svc, "alert_state", None)
            if svc_state is not None:
                state.update(svc_state())
        psi_values = [v for feats in self.monitor.last_drift.values()
                      for v in feats.values()]
        if psi_values:
            state["feature_psi_max"] = max(psi_values)
        confidences = [
            s.get("confidence", 0.0)
            for s in (self.bus.get(f"latest_signal_{sym}")
                      for sym in self.symbols) if s]
        if any(c > 0 for c in confidences):
            state["ai_confidence"] = min(c for c in confidences if c > 0)
        sentiments = [
            m.get("overall_sentiment", 0.5)
            for m in (self.bus.get(f"social_metrics_{sym}")
                      for sym in self.symbols) if m]
        if sentiments:
            state["social_sentiment"] = max(sentiments,
                                            key=lambda v: abs(v - 0.5))
        return state

    async def _fire_alerts(self) -> list[dict]:
        fired = self.alerts.evaluate(self._alert_state())
        for alert in fired:
            self.log.warning("alert fired", **alert)
            await self.bus.publish("alerts", alert)
        return fired

    async def _run_extra_services(self):
        for svc in self.extra_services:
            name = getattr(svc, "name", type(svc).__name__)
            if name in self.stage_breakers:
                # breaker-registered services (attach_trainer) get the
                # full stage treatment: backoff, quarantine, crash-loop
                # alerts, heartbeat — not just exception isolation
                await self._run_stage(name, svc.run_once)
                continue
            t0 = time.perf_counter()
            try:
                await svc.run_once()
            except Exception as exc:       # noqa: BLE001 — service isolation:
                # one failing cadence service must not kill the trading loop;
                # withholding its heartbeat lets the service-health alert fire
                self.metrics.inc("errors_total", kind=f"service_{name}")
                await self.bus.publish("alerts", {
                    "name": "ServiceError", "severity": "warning",
                    "service": name, "message": str(exc),
                    "at": self.now_fn()})
                continue
            finally:
                if self.saturation is not None:
                    self.saturation.observe_stage(
                        name, time.perf_counter() - t0)
            self.heartbeats.beat(name)

    def _render_dashboard(self):
        sym = self.symbols[0]
        klines = self.bus.get(f"historical_data_{sym}_1m") or []
        prices = [row[4] for row in klines] if klines else None
        write_dashboard(self.dashboard_path, bus=self.bus,
                        price_series=prices, symbol=sym,
                        alerts=list(self.alerts.active.values()),
                        traces=(self.tracer.traces(limit=8)
                                if self.tracer is not None else None),
                        now_fn=self.now_fn)

    def _status_from(self, balances: dict, portfolio_value: float | None = None) -> dict:
        status = {
            "balances": balances,
            "active_trades": {s: t.entry_price
                              for s, t in self.executor.active_trades.items()},
            "closed_trades": self.executor.closed_count(),
            "total_pnl": self.executor.closed_pnl(),
            "alerts": list(self.alerts.active),
            "channels": dict(self.bus.published_counts),
        }
        if portfolio_value is not None:
            status["portfolio_value_usd"] = portfolio_value
        return status

    def status(self) -> dict:
        """`print_status` parity (`run_trader.py:39`). Calls the exchange;
        out-of-loop readers should use status_cached()."""
        return self._status_from(self.exchange.get_balances())

    def status_cached(self) -> dict:
        """Last tick's snapshot — no exchange calls, safe from any thread."""
        cached = getattr(self, "_status_cache", None)
        return cached if cached is not None else self._status_from({})

    def shutdown(self):
        """Release process-global observability hooks: deactivate THIS
        system's tracer (a later system's tracer is left alone) and close
        its JSONL handle — without this, a discarded traced system keeps
        stamping every future bus publish in the process."""
        if self.tracer is not None:
            if tracing.active() is self.tracer:
                tracing.disable()
            monitor = tracing.KernelBuildMonitor._instance
            if monitor is not None and monitor.metrics is self.metrics:
                # stop routing future build observations into the
                # discarded registry (listener registration is permanent)
                monitor.metrics = None
            self.tracer.close()
        if self.fleetscope is not None:
            from ai_crypto_trader_tpu_torch.obs import fleetscope as fleet_mod

            if fleet_mod.active() is self.fleetscope:
                fleet_mod.disable()
        if self.tickpath is not None:
            from ai_crypto_trader_tpu_torch.obs import tickpath as tickpath_mod

            if tickpath_mod.active() is self.tickpath:
                tickpath_mod.disable()
        if self.journal is not None:
            self.journal.close()           # flush the buffered tail
        if self.fleet_journal is not None:
            self.fleet_journal.close()
        if self.flightrec is not None:
            self.flightrec.close()         # flush the decision JSONL tail
        if self.stream is not None:
            capture = getattr(self.stream.stream, "depth", None)
            if capture is not None:
                capture.close()            # flush the depth JSONL tail

    async def run(self, duration_s: float | None = None,
                  tick_interval_s: float = 5.0):
        """Wall-clock loop (the `while running` of run_trader.py:1492).
        With a stream attached whose supervisor owns a transport
        (`source_factory`), the reconnecting pump runs as a background
        task for the duration of the loop."""
        pump_task = None
        if self.stream is not None and self.stream.source_factory is not None:
            pump_task = asyncio.ensure_future(self.stream.pump())
        try:
            start = self.now_fn()
            while duration_s is None or self.now_fn() - start < duration_s:
                await self.tick()
                await asyncio.sleep(tick_interval_s)
        finally:
            if pump_task is not None:
                pump_task.cancel()
                try:
                    await pump_task
                except (asyncio.CancelledError, Exception):  # noqa: BLE001
                    pass
