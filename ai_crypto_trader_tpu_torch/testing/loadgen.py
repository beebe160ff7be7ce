"""Load & capacity observatory: synthetic tenant traffic + the closed-loop
ramp that finds a host's max sustainable tenants×symbols at a fixed tick
latency SLO.

ROADMAP item 4's "millions of users" axis gets its first *measured* number
here: N tenant decision lanes driven through the REAL serving path —
recorded kline frames offered to a `StreamSupervisor`, drained through
`MarketMonitor.poll` into ONE fused `TickEngine` dispatch, then the tenant
decision layer on the shared bus.  Nothing is mocked below the frame
transport: the harness exercises the same parse/continuity/scatter-
list/dispatch/fan-out machinery production runs, so the latency it
measures is the latency a host would serve (Podracer, arXiv:2104.06272:
throughput claims only mean something as a closed loop against a
latency/utilization budget).

Two tenant modes (`LoadConfig.mode`):

  * **"objects"** — each tenant is its own `SignalAnalyzer` +
    `TradeExecutor` Python object pair on per-lane
    `trading_signals.<lane>` channels.  Host cost grows O(N·S) in
    interpreter work: the baseline, kept as the parity oracle.
  * **"vmapped"** — tenants are DATA (ops/tenant_engine.py): one
    `TenantEngine` dispatch evaluates every (tenant, symbol) verdict,
    veto gate and position size straight from the fused tick engine's
    output pytree, and only the EXECUTABLE decisions fan out to lazily
    created per-tenant executors (fills/journaling keep the per-tenant
    client-order-id namespace — the thin Python rim the venue forces).
    One shared `market_updates` subscription feeds every lane.

Layers:

  * **`SyntheticTenantTraffic`** — one deterministic, seeded load point
    (`tenants × symbols` at full tick rate).  Each tick: advance the
    venue clock, build the tick's kline frames (`testing/chaos.py
    kline_frames_for`), offer them to the supervisor, drain, run the
    tenant layer, and record the wall-clock event→decision latency.  A
    `SaturationMonitor` (utils/saturation.py) times every stage against
    the SLO budget, so a breach is *attributed* by telemetry, never
    inferred.  `set_tenants()` re-provisions the tenant layer in place
    (the stream stays warm) and `reset_measurement()` re-windows every
    sliding quantile/duty window — each ramp step measures ONLY itself.
  * **`ramp()`** — the closed-loop controller: ONE traffic harness, the
    tenant count stepped up a schedule, each point measured in a fresh
    window, stop at the first p99 SLO breach, bisect to ±1 tenant, and
    report the max sustainable point plus the saturated stage(s) the
    gauges name at the breach.  `bench.py`'s `capacity` row and
    `cli load --ramp` both drive this.

Deterministic and wall-clock-honest: market data rides a virtual clock
(seeded synthetic series), but latencies are `perf_counter` wall time —
the thing the SLO is written against.

Port of `ai_crypto_trader_tpu/testing/loadgen.py`: host code, copied, with
the same reports.  `LoadConfig.device` (None: the CUDA card,
``RuntimeError`` without one; ``"cpu"`` on request) is handed to the
monitor's `TickEngine` (three launches of the fused-EWMA kernel a step, one
host read), the `TenantEngine` (one decide and one host read a tick in
vmapped mode) and every lane's `TradeExecutor`.  `run_load` and `ramp`
install the fleet scope for their run only and put back what was there on
every exit, a raising one included.
"""

from __future__ import annotations

import asyncio
import contextlib
import time
from dataclasses import dataclass, replace

from typing import Any

import numpy as np

from ai_crypto_trader_tpu_torch.config import TradingParams
from ai_crypto_trader_tpu_torch.data.ingest import OHLCV
from ai_crypto_trader_tpu_torch.data.synthetic import generate_ohlcv
from ai_crypto_trader_tpu_torch.device import resolve_device
from ai_crypto_trader_tpu_torch.obs import fleetscope
from ai_crypto_trader_tpu_torch.obs.flightrec import GATES, FlightRecorder
from ai_crypto_trader_tpu_torch.ops.tenant_engine import NO_DECISION, TenantEngine
from ai_crypto_trader_tpu_torch.shell.analyzer import SignalAnalyzer
from ai_crypto_trader_tpu_torch.shell.bus import EventBus
from ai_crypto_trader_tpu_torch.shell.exchange import FakeExchange
from ai_crypto_trader_tpu_torch.shell.executor import TradeExecutor
from ai_crypto_trader_tpu_torch.shell.monitor import MarketMonitor
from ai_crypto_trader_tpu_torch.shell.stream import (
    MarketStream,
    StreamSupervisor,
    interval_ms,
)
from ai_crypto_trader_tpu_torch.testing.chaos import CountingKlines, kline_frames_for
from ai_crypto_trader_tpu_torch.utils.health import EventLoopLagProbe
from ai_crypto_trader_tpu_torch.utils.journal import SnapshotJournal
from ai_crypto_trader_tpu_torch.utils.metrics import MetricsRegistry
from ai_crypto_trader_tpu_torch.utils.saturation import SaturationMonitor
from ai_crypto_trader_tpu_torch.utils.supervision import StageBreaker


@dataclass
class LoadConfig:
    """One load point: N tenant lanes over an S-symbol universe."""

    tenants: int = 2
    symbols: int = 4
    ticks: int = 12                   # measured ticks (after warmup)
    warmup_ticks: int = 2             # untimed: compile + REST book seeds
    window: int = 64                  # candle window (engine + monitor)
    intervals: tuple = ("1m",)
    seed: int = 0
    slo_p99_ms: float = 250.0         # the fixed tick-latency SLO the ramp
    #                                   holds; also the duty-cycle budget
    min_samples: int = 4              # saturation window gate (short steps)
    duty_threshold: float = 0.75
    tick_step_s: float = 60.0         # virtual-clock advance per tick
    # Tenant evaluation mode: "objects" (per-lane Python services — the
    # baseline and parity oracle) or "vmapped" (one TenantEngine
    # dispatch for all N tenants, ops/tenant_engine.py).
    mode: str = "objects"
    # Per-lane injected BLOCKING delay per tick (seconds) — deterministic
    # saturation for tests/drills: total stage busy grows linearly with
    # tenants, so the ramp breaches at a known point and the named stage
    # is the one that was actually loaded.  (objects mode; in vmapped
    # mode `engine_lag_s` blocks once per tick inside the tenant stage.)
    analyzer_lag_s: float = 0.0
    executor_lag_s: float = 0.0
    engine_lag_s: float = 0.0
    # Per-tenant execution gates: default params veto most signals (the
    # decision fan-out IS the load); permissive params open real positions
    # so the venue/SL-TP path is loaded too.
    trading: TradingParams | None = None
    # Fleet observatory (obs/fleetscope.py), vmapped mode only: device-
    # aggregated gate histogram / dispersion / rank table in the tenant
    # engine's own dispatch, fleet_* gauges on the harness registry, and
    # crc32-sampled lane provenance through a dedicated FlightRecorder.
    # run_load()/ramp() activate the module-global scope for the run
    # (unless one is already configured); OFF measures the bare engine —
    # the bench capacity row's fleetscope_overhead_pct probe.
    fleetscope: bool = True
    # Persist the sampled lanes' decision provenance as checksummed JSONL
    # (the flight-recorder journal format) — `cli why SYMBOL --lane N
    # --file PATH` reads it back offline.
    flightrec_path: str | None = None
    # Fault containment (vmapped mode): trace the per-lane NaN/Inf
    # quarantine predicates into the decide program (OFF measures the
    # bare program — the bench capacity row's containment_overhead_pct
    # probe), and run the host healer that re-seeds cooled-down
    # quarantined lanes from venue truth each tick.
    containment: bool = True
    heal: bool = True
    # Durable fleet state: periodic checksummed snapshots of the [N]
    # lane-state mirror in the WAL snapshot format (utils/journal.py
    # SnapshotJournal — bounded by compaction).  The kill-and-restart
    # soak restores from this + the per-lane ld<i>- journal namespaces.
    fleet_journal_path: str | None = None
    fleet_snapshot_every: int = 4     # decided ticks between snapshots
    # where the tick engine, the tenant engine and the lane executors
    # compute: None = the CUDA card, "cpu" = the CPU
    device: Any = None


@dataclass
class _TenantLane:
    name: str
    venue: FakeExchange
    executor: TradeExecutor
    analyzer: SignalAnalyzer | None = None


def _synthetic_series(cfg: LoadConfig, n_hist: int) -> dict:
    d = generate_ohlcv(n=n_hist, seed=cfg.seed + 11)
    series = {}
    for i in range(cfg.symbols):
        sym = f"L{i:03d}USDC"
        scale = np.float64(1.0 + 0.03 * i)
        series[sym] = OHLCV(
            timestamp=np.arange(n_hist, dtype=np.int64) * 60_000,
            open=d["open"] * scale, high=d["high"] * scale,
            low=d["low"] * scale, close=d["close"] * scale,
            volume=d["volume"] * (1.0 + 0.01 * i), symbol=sym)
    return series


class SyntheticTenantTraffic:
    """One load harness, fully assembled: venue → frames → supervisor →
    fused monitor → the tenant decision layer on one bus.

    ``points`` sizes the synthetic history for that many measurement
    windows, so `ramp()` can reuse ONE harness (warm stream, shared
    compiled programs) across its whole schedule."""

    def __init__(self, cfg: LoadConfig, metrics: MetricsRegistry | None = None,
                 points: int = 1):
        self.cfg = cfg
        self.device = resolve_device(cfg.device)
        self.clock = {"t": 0.0}
        self.metrics = metrics if metrics is not None else MetricsRegistry(
            now_fn=self._now)
        mult = max(int(np.ceil(interval_ms(iv) / 60_000))
                   for iv in cfg.intervals)
        per_point = cfg.ticks + cfg.warmup_ticks
        n_hist = cfg.window * mult + per_point * max(int(points), 1) + 64
        self._series = _synthetic_series(cfg, n_hist)
        self.market = FakeExchange(self._series)
        self.market.advance(steps=n_hist - per_point * max(int(points), 1)
                            - 8)
        self.symbols = sorted(self._series)
        # transport-call counter: the steady state must serve from the
        # stream's candle books, ZERO REST kline calls (the stream's contract
        # — at load, REST fallback would BE the bottleneck)
        self.counting = CountingKlines(self.market)
        self.bus = EventBus(now_fn=self._now, metrics=self.metrics)
        self.monitor = MarketMonitor(self.bus, self.counting,
                                     symbols=self.symbols,
                                     intervals=cfg.intervals,
                                     kline_limit=cfg.window,
                                     now_fn=self._now, device=self.device)
        self.stream = MarketStream(self.monitor, now_fn=self._now)
        self.supervisor = StreamSupervisor(self.stream, bus=self.bus,
                                           metrics=self.metrics,
                                           now_fn=self._now)
        self.saturation = SaturationMonitor(
            self.metrics, tick_budget_s=cfg.slo_p99_ms / 1e3,
            min_samples=cfg.min_samples, duty_threshold=cfg.duty_threshold)
        self.loop_lag = EventLoopLagProbe()
        self.lanes: list[_TenantLane] = []
        self.tenant_engine: TenantEngine | None = None
        self._updates_q = None
        self._vm_lanes: dict[int, _TenantLane] = {}
        # sampled-lane decision provenance (vmapped mode): a dedicated
        # recorder with metrics=None — the fleet's veto COUNTS come from
        # the device histogram (one inc per gate per tick), so the
        # sampled records must not double-count decision_vetoes_total
        self.flightrec = (FlightRecorder(path=cfg.flightrec_path,
                                         metrics=None, now_fn=self._now)
                          if cfg.mode == "vmapped" else None)
        self._pending_rids: dict[tuple[int, int], str] = {}
        self.last_fanout: list[tuple[int, int]] = []
        self.latencies_ms: list[float] = []
        self.published = self.analyzed = self.executed = 0
        self._seed_rest_calls = 0
        # durable fleet state + dispatch-level degradation (vmapped):
        # snapshots of the [N] mirror ride the WAL snapshot format; a
        # failed fused dispatch trips the breaker → retry from the last
        # good mirror → degrade the sampled lanes to the object parity
        # path (the stream's degrade-then-hand-back ladder at fleet scope)
        self.fleet_journal = (SnapshotJournal(cfg.fleet_journal_path,
                                              now_fn=self._now)
                              if cfg.mode == "vmapped"
                              and cfg.fleet_journal_path else None)
        self._snap_due = 0
        self.engine_breaker = StageBreaker(
            "tenant_engine", max_failures=2,
            base_backoff_s=cfg.tick_step_s, quarantine_s=4 * cfg.tick_step_s)
        self.degraded_ticks = 0
        self.set_tenants(cfg.tenants)

    def _now(self) -> float:
        return self.clock["t"]

    # -- tenant provisioning --------------------------------------------------
    def _lane(self, i: int, with_analyzer: bool = True,
              flightrec=None) -> _TenantLane:
        name = f"t{i}"
        venue = FakeExchange(self._series, quote_balance=10_000.0)
        venue.cursor = dict(self.market.cursor)      # lockstep prices
        executor = TradeExecutor(self.bus, venue, now_fn=self._now,
                                 lane=name, coid_prefix=f"ld{i}",
                                 trading=self.cfg.trading or TradingParams(),
                                 flightrec=flightrec, device=self.device)
        analyzer = None
        if with_analyzer:
            analyzer = SignalAnalyzer(self.bus, now_fn=self._now,
                                      analysis_interval_s=0.0, lane=name)
            # subscribe before the first publish (the launcher discipline)
            analyzer._queue()
        executor._queue()
        return _TenantLane(name, venue, executor, analyzer)

    def _drop_lane(self, lane: _TenantLane) -> None:
        if lane.analyzer is not None and hasattr(lane.analyzer, "_q"):
            self.bus.unsubscribe("market_updates", lane.analyzer._q)
        if hasattr(lane.executor, "_q"):
            self.bus.unsubscribe(f"trading_signals.{lane.name}",
                                 lane.executor._q)

    def set_tenants(self, n: int) -> None:
        """Re-provision the tenant layer for ``n`` tenants in place: the
        stream/monitor stay warm (their compiled programs and candle
        books carry over), tenant state starts fresh — each ramp step is
        a clean load point over a hot serving path."""
        self.cfg = replace(self.cfg, tenants=int(n))
        for lane in self.lanes:
            self._drop_lane(lane)
        for lane in self._vm_lanes.values():
            self._drop_lane(lane)
        self._vm_lanes = {}
        self.lanes = []
        if self.cfg.mode == "vmapped":
            if self._updates_q is None:
                # ONE shared market_updates subscription feeds all lanes
                self._updates_q = self.bus.subscribe("market_updates")
            if self.tenant_engine is None:
                self.tenant_engine = TenantEngine(
                    self.symbols, n, trading=self.cfg.trading,
                    containment=self.cfg.containment, device=self.device)
            else:
                self.tenant_engine.configure(n, trading=self.cfg.trading)
        else:
            self.lanes = [self._lane(i) for i in range(self.cfg.tenants)]
        self.saturation.set_tenant_lanes(
            self.cfg.tenants * self.cfg.symbols, self.cfg.mode)

    def close(self) -> None:
        """Flush/close the sampled-provenance journal (a batched veto
        tail must land on disk before `cli why --file` reads it) and the
        fleet snapshot journal."""
        if self.flightrec is not None:
            self.flightrec.close()
        if self.fleet_journal is not None:
            self.fleet_journal.close()

    def reset_measurement(self) -> None:
        """Start a fresh measurement window: latencies, throughput
        counters, saturation duty/quantile windows and the loop-lag
        probe all reset so a heavy step's tail can NEVER bleed into the
        next step's p99 (the ramp bisect's correctness contract)."""
        self.latencies_ms = []
        self.published = self.analyzed = self.executed = 0
        self._seed_rest_calls = self.counting.kline_calls
        self.saturation.reset_windows()
        self.loop_lag.reset()

    # -- vmapped decision layer ----------------------------------------------
    def _vm_lane(self, i: int) -> _TenantLane:
        lane = self._vm_lanes.get(i)
        if lane is None:
            # executors exist per tenant only once the tenant actually
            # trades — the venue-forced rim stays O(executing tenants).
            # A provenance-sampled lane's executor gets the recorder, so
            # its executions/fills/closures chain onto the sampled
            # decision records exactly like an object lane's would.
            fs = fleetscope.active()
            fr = (self.flightrec
                  if fs is not None and fs.sampled(i) else None)
            lane = self._vm_lanes[i] = self._lane(i, with_analyzer=False,
                                                  flightrec=fr)
        return lane

    async def _vm_tick(self) -> set[int]:
        """Drain the shared market_updates subscription, run ONE tenant
        engine dispatch over the fused tick output, fan the executable
        decisions out on their per-lane channels.  Returns the lane
        indices that received signals (only those executors drain)."""
        eng = self.tenant_engine
        updates: dict = {}
        q = self._updates_q
        while not q.empty():
            u = q.get_nowait()["data"]
            updates[u["symbol"]] = u
        if not updates:
            return set()
        live = self.bus.get("strategy_params") or {}
        eng.set_live_overrides(
            live.get("stop_loss") if isinstance(live.get("stop_loss"),
                                                (int, float)) else None,
            live.get("take_profit") if isinstance(live.get("take_profit"),
                                                  (int, float)) else None)
        tick_eng = self.monitor._engine
        due = np.zeros(eng.S, bool)
        for sym in updates:
            s = eng.sym_index.get(sym)
            if s is not None:
                due[s] = True
        if tick_eng is not None and tick_eng.last_out is not None:
            feats = eng.feats_from_tick(tick_eng.last_out,
                                        tick_eng.last_valid, due_mask=due)
        else:                        # per-symbol monitor path fallback
            feats = eng.feats_from_updates(updates)
        # dispatch-level degradation ladder: a failed/aborted fused
        # dispatch (XLA error, transfer-guard abort) retries ONCE from
        # the last good host mirror (decide's abort path flags the
        # re-seed — the donated carry is unknown, the mirror is
        # authoritative); a second failure feeds the tenant_engine
        # breaker and this tick degrades to the object parity path.
        # Once the breaker quarantines, the dispatch is only probed on
        # its quarantine cadence and every other tick degrades.
        brk, now = self.engine_breaker, self._now()
        out = None
        if brk.should_run(now):
            try:
                out = eng.decide(feats)
                brk.record_success(now)
            except Exception as e:             # noqa: BLE001
                brk.record_failure(now, repr(e))
                try:
                    out = eng.decide(feats)    # retry from the mirror
                    brk.record_success(now)
                except Exception as e2:        # noqa: BLE001
                    brk.record_failure(now, repr(e2))
        if out is None:
            self.degraded_ticks += 1
            self.metrics.inc("fleet_degraded_ticks_total")
            return await self._vm_degraded(updates)
        if self.cfg.engine_lag_s:
            time.sleep(self.cfg.engine_lag_s)        # BLOCKING on purpose
        self.analyzed += eng.n_tenants * len(updates)
        fs = fleetscope.active()
        if fs is not None and eng.last_fleet is not None:
            # device-aggregated gate histogram (obs/fleetscope.py): the
            # counts come off the dispatch itself — no host scan over the
            # [N, S] table, one counter inc per gate per tick
            counts = fs.veto_counts(eng.last_fleet)
        else:
            counts = eng.veto_counts(out)
        for gate, count in counts.items():
            self.metrics.inc("decision_vetoes_total", count, gate=gate)
        if fs is not None and self.flightrec is not None:
            self._record_sampled(fs, eng, feats, out)
        self.last_fanout = eng.executable(out)
        dirty: set[int] = set()
        for n, s in self.last_fanout:
            sym = self.symbols[s]
            u = updates.get(sym)
            if u is None:
                continue
            lane = self._vm_lane(n)
            signal = {
                "symbol": sym, "timestamp": self._now(),
                "current_price": u.get("current_price"),
                "signal": u.get("signal", "NEUTRAL"),
                "signal_strength": u.get("signal_strength", 0.0),
                "volatility": u.get("volatility", 0.0),
                "avg_volume": u.get("avg_volume", 0.0),
                "decision": "BUY",
                "confidence": float(out["confidence"][n, s]),
                "reasoning": "vmapped tenant engine",
                "model_version": None,
                "top_family": u.get("top_family"),
                "structure_version": u.get("structure_version"),
                "lane": lane.name,
            }
            # a sampled lane's open decision record follows its signal
            # (the analyzer convention): the lane executor's flightrec
            # finalizes the SAME record through execution → fill → PnL
            rid = self._pending_rids.pop((n, s), None)
            if rid is not None:
                signal["decision_id"] = rid
            await self.bus.publish(f"trading_signals.{lane.name}", signal)
            dirty.add(n)
        return dirty

    def _record_sampled(self, fs, eng, feats: dict, out: dict) -> None:
        """Full decision provenance for the crc32-sampled lanes: one
        FlightRecorder record per (sampled lane, decided symbol) straight
        from the device decision table — gate/verdict for vetoes
        (terminal immediately), an OPEN record for executables whose id
        rides the fan-out signal so the lane executor completes the
        chain.  O(sampled lanes × symbols) host work, independent of N."""
        fr = self.flightrec
        # a rid never claimed by the fan-out (throttled symbol) stays an
        # honest PENDING record in the ring; drop the stale index so it
        # can never mis-attach to a LATER tick's signal
        self._pending_rids.clear()
        sig_name = {1: "BUY", -1: "SELL", 0: "NEUTRAL"}
        for n in fs.sample_lanes(eng.n_tenants):
            for s in range(len(self.symbols)):
                gate = int(out["gate"][n, s])
                if gate == NO_DECISION:
                    continue
                verdict = {
                    "decision": sig_name.get(int(out["decision"][n, s]),
                                             "HOLD"),
                    "confidence": float(out["confidence"][n, s]),
                }
                features = {
                    "price": float(feats["price"][s]),
                    "signal": sig_name.get(int(feats["signal"][s]),
                                           "NEUTRAL"),
                    "signal_strength": float(feats["strength"][s]),
                    "volatility": float(feats["volatility"][s]),
                    "avg_volume": float(feats["avg_volume"][s]),
                }
                rid = fr.begin(self.symbols[s], features=features,
                               verdict=verdict, lane=n)
                if gate >= 0:
                    fr.veto(rid, GATES[gate],
                            detail=f"vmapped lane {n}")
                else:
                    self._pending_rids[(n, s)] = rid

    async def _vm_degraded(self, updates: dict) -> set[int]:
        """The breaker's degraded mode: with the fused dispatch down, the
        SAMPLED lanes fall back to the object-lane parity path — raw
        market updates fan out as analyzer-style signals and each lane
        executor's OWN veto_reason gates them (the object-lane baseline,
        gate-for-gate).  Unsampled lanes pause (no decisions) rather
        than trade without their device state: bounded service beats
        unbounded risk.  Hand-back is automatic — the breaker's next
        successful probe resumes the fused path, and the engine re-seeds
        from its mirror (venue truth re-anchored it all along via
        `_vm_reconcile`)."""
        fs = fleetscope.active()
        eng = self.tenant_engine
        lanes = (fs.sample_lanes(eng.n_tenants) if fs is not None
                 else sorted(self._vm_lanes))
        dirty: set[int] = set()
        for n in lanes:
            lane = self._vm_lane(n)
            for sym, u in updates.items():
                strength = float(u.get("signal_strength", 0.0) or 0.0)
                signal = {
                    "symbol": sym, "timestamp": self._now(),
                    "current_price": u.get("current_price"),
                    "signal": u.get("signal", "NEUTRAL"),
                    "signal_strength": strength,
                    "volatility": u.get("volatility", 0.0),
                    "avg_volume": u.get("avg_volume", 0.0),
                    # the deterministic analyzer verdict
                    # (TechnicalPolicyBackend): the executor's gates veto
                    # from here exactly as they do for object lanes
                    "decision": ("BUY" if u.get("signal") == "BUY"
                                 else "HOLD"),
                    "confidence": round(min(strength / 100.0, 1.0) * 0.9,
                                        3),
                    "reasoning": "degraded: fused dispatch quarantined",
                    "model_version": None,
                    "lane": lane.name,
                }
                await self.bus.publish(f"trading_signals.{lane.name}",
                                       signal)
            self.analyzed += len(updates)
            dirty.add(n)
        return dirty

    def _vm_heal(self) -> None:
        """The host healer: quarantined lanes whose cooldown expired
        re-seed from VENUE TRUTH — the lane venue's quote balance plus
        the lane executor's surviving position book.  A lane whose venue
        read is itself non-finite or failing (poisoned/out venue — the
        chaos harness makes both) stays quarantined: healing from poison
        would re-trip the detector on the very next dispatch."""
        eng = self.tenant_engine
        for n in eng.heal_ready():
            lane = self._vm_lane(n)
            try:
                bal = float(lane.venue.get_balances().get("USDC", 0.0))
            except Exception:                  # noqa: BLE001
                continue                       # venue down — next tick
            positions = {sym: (float(t.entry_price), float(t.quantity))
                         for sym, t in lane.executor.active_trades.items()}
            vals = [bal] + [v for eq in positions.values() for v in eq]
            if not np.isfinite(vals).all():
                continue                       # venue truth is poisoned
            eng.heal_lane(n, balance=bal, positions=positions)

    def _fleet_snapshot(self) -> None:
        """Periodic durable snapshot of the [N] lane mirror (the mirror
        is already host-side after the decide's one host_read — zero
        extra syncs), bounded by the journal's compaction."""
        if self.fleet_journal is None or self.tenant_engine is None:
            return
        self._snap_due += 1
        if self._snap_due >= max(self.cfg.fleet_snapshot_every, 1):
            self._snap_due = 0
            self.fleet_journal.write(self.tenant_engine.snapshot())

    def _vm_reconcile(self) -> None:
        """Venue truth wins, per MATERIALIZED tenant: the engine's open
        set re-anchors on the executor's books (an entry that never
        landed is cleared; a position the executor closed — protective
        SL/TP filled venue-side, exit sold — frees its position_open
        flag and max_positions slot) and the balance re-anchors on the
        venue (closure proceeds / protective credits the engine's entry
        model never sees — exactly what object-lane executors size
        from).  O(trading tenants) host work; a correction re-seeds from
        the mirror on the next dispatch (a transfer, never a compile)."""
        for n, lane in self._vm_lanes.items():
            closed = self.tenant_engine.sync_positions(
                n, lane.executor.active_trades)
            # a balance jump right after a learned closure is venue truth
            # doing its job (sale proceeds the engine's entry model never
            # sees) — `expected` exempts it from the FleetBalanceDrift
            # accounting; an UNEXPLAINED divergence still counts
            try:
                balance = lane.venue.get_balances().get("USDC", 0.0)
            except Exception:
                # that lane's venue is down: keep the mirror's last truth
                # rather than failing the whole fleet's reconcile pass —
                # the lane re-anchors on the next healthy read
                continue
            self.tenant_engine.sync_balance(n, balance, expected=closed)

    # -- one tick -------------------------------------------------------------
    async def tick(self, timed: bool = True) -> float:
        """One full load tick; returns the wall event→decision latency in
        ms.  The timed region starts when the tick's frames hit the
        supervisor (`offer`) and ends when every tenant decision has been
        drained — frame parse + continuity + scatter-list upload + ONE
        fused dispatch + ONE host readback + bus fan-out + the tenant
        layer (N×(analyze + execute) in objects mode; ONE TenantEngine
        dispatch + executable-only fan-out in vmapped mode)."""
        cfg, sat = self.cfg, self.saturation
        self.clock["t"] += cfg.tick_step_s
        self.market.advance(steps=1)
        for lane in self.lanes:
            lane.venue.advance(steps=1)
        for lane in self._vm_lanes.values():
            lane.venue.advance(steps=1)
        frames = kline_frames_for(self.market, self.symbols, cfg.intervals)
        if timed:
            # never sampled during warmup: the first dispatch's compile
            # would stamp a multi-second "lag" into the probe's max
            self.loop_lag.sample()
        t0 = time.perf_counter()
        for f in frames:
            self.supervisor.offer(f)
        with sat.stage("stream"):
            self.published += await self.supervisor.step()
        if cfg.mode == "vmapped":
            with sat.stage("tenant_engine"):
                dirty = await self._vm_tick()
            with sat.stage("executor"):
                for n in sorted(dirty):
                    lane = self._vm_lanes[n]
                    self.executed += await lane.executor.run_once()
                    if cfg.executor_lag_s:
                        time.sleep(cfg.executor_lag_s)
                self._vm_reconcile()
                if cfg.heal:
                    self._vm_heal()
                self._fleet_snapshot()
        else:
            with sat.stage("analyzer"):
                for lane in self.lanes:
                    self.analyzed += await lane.analyzer.run_once()
                    if cfg.analyzer_lag_s:
                        time.sleep(cfg.analyzer_lag_s)  # BLOCKING on purpose
            with sat.stage("executor"):
                for lane in self.lanes:
                    self.executed += await lane.executor.run_once()
                    if cfg.executor_lag_s:
                        time.sleep(cfg.executor_lag_s)
        wall_ms = (time.perf_counter() - t0) * 1e3
        # one real loop iteration so the lag probe's callback (and any
        # call_soon work the stages queued) completes inside this tick
        await asyncio.sleep(0)
        if timed:
            eng = self.monitor._engine
            sat.close_tick(wall_ms / 1e3, bus=self.bus,
                           engine_stats=eng.last_stats if eng is not None
                           else None,
                           lag_s=self.loop_lag.last_lag_s)
            self.latencies_ms.append(wall_ms)
        else:
            sat.discard_tick()       # warmup busy time must not pollute
            #                          the duty windows (compile + seeds)
        return wall_ms

    async def run(self) -> dict:
        for _ in range(self.cfg.warmup_ticks):
            await self.tick(timed=False)
        # measured window starts clean: warmup publishes/analyses (and
        # the REST seeds) belong to compile/seed, not the load point —
        # and on a REUSED harness the previous step's quantile/duty
        # windows must not bleed into this one
        self.reset_measurement()
        for _ in range(self.cfg.ticks):
            await self.tick(timed=True)
        return self.report()

    def report(self) -> dict:
        cfg, sat = self.cfg, self.saturation
        lat = np.asarray(self.latencies_ms or [0.0])
        fs = fleetscope.active()
        fleet = (fs.status() if fs is not None and fs.decides else None)
        eng = self.tenant_engine
        containment = None
        if eng is not None:
            containment = {
                "enabled": eng.containment,
                "quarantined": eng.quarantined_lanes(),
                "quarantine_trips": eng.quarantine_trips,
                "heals_total": eng.heals_total,
                "degraded_ticks": self.degraded_ticks,
                "engine_breaker": self.engine_breaker.state(),
                "snapshots": (self.fleet_journal.writes
                              if self.fleet_journal is not None else 0),
            }
        return {
            **({"fleet": fleet} if fleet else {}),
            **({"containment": containment} if containment else {}),
            "tenants": cfg.tenants, "symbols": cfg.symbols,
            "lanes": cfg.tenants * cfg.symbols,
            "mode": cfg.mode,
            "ticks": len(self.latencies_ms),
            "p50_ms": round(float(np.percentile(lat, 50)), 3),
            "p99_ms": round(float(np.percentile(lat, 99)), 3),
            "max_ms": round(float(lat.max()), 3),
            "published": self.published, "analyzed": self.analyzed,
            "executed": self.executed,
            "rest_kline_calls_steady":
                int(self.counting.kline_calls - self._seed_rest_calls),
            "stage_duty": {k: round(v, 4)
                           for k, v in sorted(sat.windowed_duty().items())},
            "saturated_stages": sat.saturated_stages(),
            "bottleneck_stage": sat.bottleneck_stage(),
            "event_loop_lag_max_s": round(self.loop_lag.max_lag_s, 6),
            "capacity": sat.status(),
        }


def _fleet_scope(traffic: SyntheticTenantTraffic):
    """Scoped fleet-observatory activation for a measured run: vmapped
    mode with `cfg.fleetscope` gets a FleetScope on the harness registry
    unless the caller already configured one (tests drive their own via
    `fleetscope.use`); objects mode / opted-out runs measure bare."""
    cfg = traffic.cfg
    if (cfg.mode == "vmapped" and cfg.fleetscope
            and fleetscope.active() is None):
        return fleetscope.use(
            fleetscope.FleetScope(metrics=traffic.metrics))
    return contextlib.nullcontext(fleetscope.active())


def run_load(cfg: LoadConfig,
             metrics: MetricsRegistry | None = None) -> dict:
    """Measure ONE load point (blocking entry; builds its own loop)."""
    traffic = SyntheticTenantTraffic(cfg, metrics=metrics)
    with _fleet_scope(traffic):
        try:
            return asyncio.run(traffic.run())
        finally:
            traffic.close()


def default_tenant_steps(max_tenants: int) -> list[int]:
    """Doubling ramp schedule: 1, 2, 4, … up to (and including) the cap."""
    steps, t = [], 1
    while t < max_tenants:
        steps.append(t)
        t *= 2
    steps.append(max_tenants)
    return sorted(set(steps))


def ramp(base: LoadConfig, tenant_steps: list[int] | None = None,
         metrics: MetricsRegistry | None = None,
         refine: bool = True) -> dict:
    """Closed-loop ramp: step tenants up the schedule until the measured
    p99 tick latency breaches the SLO; report the max sustainable
    tenants×symbols point and the saturated stage(s) telemetry NAMES at
    the breach (the acceptance contract: attribution comes from the
    duty-cycle gauges, not from guessing).

    ONE harness serves the whole schedule: `set_tenants()` re-provisions
    the tenant layer per step over the warm stream/engine, and
    `reset_measurement()` re-windows every sliding quantile/duty window
    per step — a heavy step's latency tail must never pollute the next
    step's p99, or the bisect converges on a stale breach (the
    regression tests/test_loadgen.py pins).

    ``refine`` (default on) bisects the gap between the last sustainable
    step and the breaching step down to ±1 tenant.  The doubling
    schedule alone quantizes the headline to powers of two — a breach
    one step earlier would read as a 50% capacity drop, which would trip
    the bench gate's 10% tolerance on ordinary jitter; the refined value
    moves by at most one tenant's worth instead."""
    steps = tenant_steps or default_tenant_steps(base.tenants)
    slo_ms = base.slo_p99_ms
    # history capacity for every scheduled step + the bisect's worst case
    # (bounded by log2 of the LARGEST step — caller-supplied schedules may
    # exceed base.tenants, and exhausting the synthetic series would
    # silently freeze prices at the cursor clamp)
    cap = max(max(steps), base.tenants, 2)
    points = len(steps) + int(np.ceil(np.log2(cap))) + 4
    traffic = SyntheticTenantTraffic(replace(base, tenants=steps[0]),
                                     metrics=metrics, points=points)

    def measure(tenants: int) -> dict:
        traffic.set_tenants(tenants)
        rep = asyncio.run(traffic.run())
        rep["slo_p99_ms"] = slo_ms
        rep["breached"] = rep["p99_ms"] > slo_ms
        return rep

    reports, max_sustainable, breach = [], None, None
    with _fleet_scope(traffic):
        try:
            for tenants in steps:
                rep = measure(tenants)
                reports.append(rep)
                if rep["breached"]:
                    breach = rep
                    break
                max_sustainable = rep
            if breach is not None and refine:
                lo = max_sustainable["tenants"] if max_sustainable else 0
                hi = breach["tenants"]
                while hi - lo > 1:
                    rep = measure((lo + hi) // 2)
                    rep["refined"] = True
                    reports.append(rep)
                    if rep["breached"]:
                        hi, breach = rep["tenants"], rep
                    else:
                        lo, max_sustainable = rep["tenants"], rep
        finally:
            # an aborted step (engine error, Ctrl-C mid-bisect) must not
            # lose the sampled-provenance journal's buffered tail
            traffic.close()

    def point(rep):
        return {k: rep[k] for k in ("tenants", "symbols", "lanes",
                                    "p50_ms", "p99_ms")}

    return {
        "slo_p99_ms": slo_ms,
        "mode": base.mode,
        "steps": reports,
        "max_sustainable": point(max_sustainable) if max_sustainable else None,
        "breach": point(breach) if breach else None,
        # the attribution surface: which stage(s) the gauges say saturated
        # at the breach point (bottleneck = argmax duty, always named)
        "saturated_stages": (breach or reports[-1])["saturated_stages"],
        "bottleneck_stage": (breach or reports[-1])["bottleneck_stage"],
    }
