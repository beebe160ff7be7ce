"""Decision critical-path observatory: tick-phase waterfall, overlap
headroom, and cold-start accounting.

The port's own copy of `ai_crypto_trader_tpu/obs/tickpath.py`.  Four
instruments, one module:

  * **Phase waterfall** (`observe_phase` / the seams in
    `ops.tick_engine` and `shell.monitor`): a tick decomposes into
    ``parse`` (kline fetch + ingest diffing) → ``scatter_build``
    (scatter-list assembly + upload staging) → ``dispatch`` (the tick
    program's enqueue) → ``device_compute`` (the program on the card,
    between two CUDA events read after the step's one host read) →
    ``host_read`` → ``publish`` (bus fan-out) → ``analyzer`` →
    ``executor``; ``frame_wait`` is the stream seam's, which the port has
    not yet.  Sliding p50/p99 windows per phase export as
    ``tickpath_phase_seconds{phase=,q=}``; the largest p99 is the named
    **bottleneck** (``tickpath_bottleneck{phase=}``).
  * **Overlap headroom** (`observe_overlap`, `observe_reclaimed`): the
    host's wait for the tick's read-back, and in the pipelined tick the
    host work that ran while the device computed.
  * **Cold-start ledger** (`coldstart`): samples the process-wide
    KernelBuildMonitor (`utils.tracing`, the nvcc builds of
    `ops._cuda.build`) around a program's FIRST dispatch.
  * **Event-age SLO** (`observe_event_age`): venue event time E →
    decision publish, exported as
    ``latency_p99_seconds{slo=event_to_decision}``.  Negative ages clamp
    to 0 and count on ``tickpath_clock_skew_total``.

The disabled path checks one module global and returns immediately.
"""

from __future__ import annotations

import contextlib
import threading
import time

from ai_crypto_trader_tpu_torch.utils.devprof import SlidingQuantiles, percentile

# The active observatory. None = disabled: the module-level helpers below
# check this one global and bail out immediately.
_ACTIVE: "TickPathScope | None" = None

#: The serialized tick pipeline, in critical-path order.  This tuple is
#: the bounded ``phase`` label set for every tickpath series — exports
#: iterate it so a phase that never observed still publishes flat zeros
#: (a missing series is a dashboard hole, a zero is a fact).
PHASES = (
    "frame_wait",       # venue event time E → host receive (stream seam)
    "parse",            # frame drain / kline fetch + ingest diffing
    "scatter_build",    # scatter-list assembly + upload prep
    "dispatch",         # program enqueue → async return
    "device_compute",   # the program on the card (CUDA events)
    "host_read",        # THE per-poll device→host transfer
    "publish",          # per-symbol feature extraction + bus fan-out
    "analyzer",         # signal analysis stage drain
    "executor",         # trade execution stage drain
)

#: Default event→decision latency budget (ms): the
#: DecisionLatencyBudgetBreach threshold.  One second of feed transit +
#: one budgeted tick (devprof's "tick" SLO target) of processing.
DEFAULT_EVENT_AGE_BUDGET_MS = 2000.0
#: Quantiles report 0 / the breach alert stays quiet below this window
#: fill — one cold compile-heavy tick is 100% of a 1-sample window
#: (the devprof min_samples discipline).
DEFAULT_MIN_SAMPLES = 8


class _NoopCtx:
    """Disabled-observatory stand-in (the tracing _NoopCtx pattern)."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NOOP_CTX = _NoopCtx()


class _ColdStartCtx:
    """One cold-dispatch attribution window: KernelBuildMonitor sampled
    before/after plus the wall clock — allocated only for a program's
    FIRST cold dispatch while the observatory is on."""

    __slots__ = ("tp", "name", "_mon", "_before", "_t0")

    def __init__(self, tp: "TickPathScope", name: str):
        self.tp = tp
        self.name = name

    def __enter__(self):
        from ai_crypto_trader_tpu_torch.utils.tracing import KernelBuildMonitor

        self._mon = KernelBuildMonitor.install()
        self._before = self._mon.sample()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, et, ev, tb):
        if ev is None:
            since = self._mon.since(self._before)
            self.tp.record_cold_start(
                self.name, wall_s=time.perf_counter() - self._t0,
                compile_s=since["compile_s"], compiles=since["compiles"],
                cache_hits=since["cache_hits"])
        return False                      # never swallow — callers recover


class TickPathScope:
    """The observatory instance: phase windows + bottleneck + overlap
    headroom + event-age SLO + cold-start ledger.

    ``metrics`` (a MetricsRegistry) receives every ``tickpath_*`` /
    ``coldstart_*`` series; ``event_age_budget_ms`` is the
    DecisionLatencyBudgetBreach threshold.  Thread-safe: dashboard
    handler threads read status() while the tick loop folds phases.
    """

    def __init__(self, metrics=None, *, window: int = 512,
                 event_age_budget_ms: float = DEFAULT_EVENT_AGE_BUDGET_MS,
                 min_samples: int = DEFAULT_MIN_SAMPLES):
        self.metrics = metrics
        self.window = int(window)
        self.event_age_budget_ms = float(event_age_budget_ms)
        self.min_samples = int(min_samples)
        self.phases: dict[str, SlidingQuantiles] = {}
        self.last: dict[str, float] = {}          # newest sample per phase
        self.overlap = SlidingQuantiles(window=self.window)
        # headroom actually FILLED by pipelining: host work that ran
        # between dispatch-return and the drain's readiness wait
        self.reclaimed = SlidingQuantiles(window=self.window)
        self.event_age = SlidingQuantiles(window=self.window)  # milliseconds
        self.clock_skew_total = 0
        self.cold_programs: dict[str, dict] = {}  # program -> ledger entry
        # injected per-phase delays (seconds) for the bottleneck drill:
        # added to every matching observation so tests can pin the named
        # bottleneck per injected stage without real sleeps
        self.drill_delays: dict[str, float] = {}
        self._lock = threading.Lock()

    # -- phase waterfall -----------------------------------------------------
    def observe_phase(self, name: str, seconds: float) -> None:
        """Fold one phase sample.  Negative durations (a skewed clock on
        the frame_wait seam) clamp to 0 and count as clock skew instead
        of corrupting the window quantiles."""
        seconds = float(seconds)
        if seconds < 0.0:
            self._count_skew()
            seconds = 0.0
        seconds += self.drill_delays.get(name, 0.0)
        with self._lock:
            q = self.phases.get(name)
            if q is None:
                q = self.phases[name] = SlidingQuantiles(window=self.window)
            q.observe(seconds)
            self.last[name] = seconds

    def inject_delay(self, phase: str, seconds: float) -> None:
        """Bottleneck drill: every subsequent ``phase`` observation reads
        ``seconds`` longer.  Test-only — the production path never sets
        one."""
        self.drill_delays[phase] = float(seconds)

    def _snapshots(self) -> dict:
        with self._lock:
            return {name: (q.count, list(q.buf))
                    for name, q in self.phases.items()}

    def bottleneck(self) -> str | None:
        """The phase with the largest window p99 — None until any phase
        has observed.  Bounded vocabulary: only PHASES members compete,
        so a typo'd seam can never mint a label."""
        snaps = self._snapshots()
        best, best_p99 = None, -1.0
        for name in PHASES:
            count, values = snaps.get(name, (0, []))
            if not values:
                continue
            p99 = percentile(values, 99)
            if p99 > best_p99:
                best, best_p99 = name, p99
        return best

    # -- overlap headroom ----------------------------------------------------
    def observe_overlap(self, seconds: float) -> None:
        """One tick's host-idle wait between dispatch-return and
        readback-start: the window item-4 pipelining can fill with host
        work while the device computes."""
        with self._lock:
            self.overlap.observe(max(float(seconds), 0.0))

    def observe_reclaimed(self, seconds: float) -> None:
        """One tick's overlap headroom actually FILLED by pipelining: the
        host work (publish/analyzer/executor/next-tick ingest) that ran
        between a dispatch returning and its drain starting to wait.
        Serial execution observes ~0 here; the pipelined tick path's
        reclaimed p50 is the before/after ledger for ROADMAP item 4."""
        with self._lock:
            self.reclaimed.observe(max(float(seconds), 0.0))

    # -- event-age SLO -------------------------------------------------------
    def observe_event_age(self, age_ms: float) -> float:
        """Fold one venue-E → decision-publish age (ms); returns the
        clamped value the caller stamps onto the flight-recorder record.
        Negative ages (host clock behind the venue) clamp to 0 and count
        on ``tickpath_clock_skew_total``."""
        age_ms = float(age_ms)
        if age_ms < 0.0:
            self._count_skew()
            age_ms = 0.0
        with self._lock:
            self.event_age.observe(age_ms)
        if self.metrics is not None:
            self.metrics.observe("slo_latency_seconds", age_ms / 1000.0,
                                 slo="event_to_decision")
        return age_ms

    def _count_skew(self) -> None:
        with self._lock:
            self.clock_skew_total += 1
        if self.metrics is not None:
            self.metrics.inc("tickpath_clock_skew_total")

    # -- cold-start ledger ---------------------------------------------------
    def coldstart(self, name: str, cold: bool = True):
        """Attribution window for ``name``'s first compile: wraps the
        cold dispatch at the program's dispatch seam.  No-op
        for warm dispatches or already-ledgered programs, so the steady
        path pays one dict lookup."""
        if not cold or name in self.cold_programs:
            return _NOOP_CTX
        return _ColdStartCtx(self, name)

    def record_cold_start(self, name: str, *, wall_s: float,
                          compile_s: float, compiles: int,
                          cache_hits: int = 0) -> None:
        with self._lock:
            if name in self.cold_programs:
                return                     # first cold window wins
            self.cold_programs[name] = {
                "wall_ms": round(wall_s * 1000.0, 3),
                "compile_ms": round(compile_s * 1000.0, 3),
                "compiles": int(compiles),
                # libraries found built during the cold window: a warm
                # restart loads the kernels nvcc built before (cache_hits
                # ≥ 1, compile_ms collapses) instead of rebuilding them
                "cache_hits": int(cache_hits),
                "t": time.time(),
            }
        if self.metrics is not None:
            self.metrics.set_gauge("coldstart_wall_seconds", wall_s,
                                   program=name)
            self.metrics.set_gauge("coldstart_compile_seconds", compile_s,
                                   program=name)

    # -- views ---------------------------------------------------------------
    def export(self) -> None:
        """Publish the per-phase p50/p99, bottleneck indicator, overlap
        headroom, event-age SLO, and cold-start totals (one call per
        tick, from the launcher's health-gauge pass)."""
        m = self.metrics
        if m is None:
            return
        snaps = self._snapshots()
        bn = self.bottleneck()
        for name in PHASES:
            count, values = snaps.get(name, (0, []))
            m.set_gauge("tickpath_phase_seconds", percentile(values, 50),
                        phase=name, q="p50")
            m.set_gauge("tickpath_phase_seconds", percentile(values, 99),
                        phase=name, q="p99")
            m.set_gauge("tickpath_bottleneck",
                        1.0 if name == bn else 0.0, phase=name)
        with self._lock:
            overlap = list(self.overlap.buf)
            reclaimed = list(self.reclaimed.buf)
            ages = list(self.event_age.buf)
            total_wall = sum(e["wall_ms"] for e in
                             self.cold_programs.values())
        m.set_gauge("tickpath_overlap_headroom_seconds",
                    percentile(overlap, 50))
        m.set_gauge("tickpath_overlap_reclaimed_seconds",
                    percentile(reclaimed, 50))
        m.set_gauge("latency_p50_seconds", percentile(ages, 50) / 1000.0,
                    slo="event_to_decision")
        m.set_gauge("latency_p99_seconds", percentile(ages, 99) / 1000.0,
                    slo="event_to_decision")
        m.set_gauge("coldstart_total_seconds", total_wall / 1000.0)

    def alert_state(self) -> dict:
        """Inputs for the in-process rule engine (utils/alerts.py):
        DecisionLatencyBudgetBreach pages when the event→decision p99
        exceeds the budget, and its payload names the bottleneck phase —
        values AND thresholds, the fleetscope convention."""
        with self._lock:
            ages = list(self.event_age.buf)
        p99 = percentile(ages, 99) if len(ages) >= self.min_samples else 0.0
        return {
            "event_age_p99_ms": p99,
            "event_age_budget_ms": self.event_age_budget_ms,
            "event_age_samples": len(ages),
            "tickpath_bottleneck_phase": self.bottleneck() or "",
            "tickpath_clock_skew_total": self.clock_skew_total,
        }

    def status(self) -> dict:
        """JSON-able snapshot: the /state.json ``tickpath`` block and the
        ``cli latency`` waterfall table, in critical-path order."""
        snaps = self._snapshots()
        with self._lock:
            last = dict(self.last)
            overlap = list(self.overlap.buf)
            reclaimed = list(self.reclaimed.buf)
            ages = list(self.event_age.buf)
            skew = self.clock_skew_total
        phases = {}
        for name in PHASES:
            count, values = snaps.get(name, (0, []))
            phases[name] = {
                "count": count,
                "p50_ms": round(percentile(values, 50) * 1000.0, 3),
                "p99_ms": round(percentile(values, 99) * 1000.0, 3),
                "last_ms": round(last.get(name, 0.0) * 1000.0, 3),
            }
        return {
            "phases": phases,
            "bottleneck": self.bottleneck(),
            "overlap_headroom_ms": {
                "p50": round(percentile(overlap, 50) * 1000.0, 3),
                "p99": round(percentile(overlap, 99) * 1000.0, 3),
            },
            "overlap_reclaimed_ms": {
                "p50": round(percentile(reclaimed, 50) * 1000.0, 3),
                "p99": round(percentile(reclaimed, 99) * 1000.0, 3),
            },
            "event_age_ms": {
                "p50": round(percentile(ages, 50), 3),
                "p99": round(percentile(ages, 99), 3),
                "count": len(ages),
                "budget_ms": self.event_age_budget_ms,
            },
            "clock_skew_total": skew,
        }

    def coldstart_status(self) -> dict:
        """The /state.json ``coldstart`` block: per-program first-compile
        ledger plus totals — the 'unmeasured downtime' ROADMAP item 4
        names, measured."""
        with self._lock:
            programs = {n: dict(e) for n, e in self.cold_programs.items()}
        return {
            "programs": programs,
            "total_wall_ms": round(sum(e["wall_ms"]
                                       for e in programs.values()), 3),
            "total_compile_ms": round(sum(e["compile_ms"]
                                          for e in programs.values()), 3),
        }


# -- module-level hot-path API (single-check disabled path) ------------------

def configure(tp: TickPathScope) -> TickPathScope:
    """Install ``tp`` as the process-wide active observatory."""
    global _ACTIVE
    _ACTIVE = tp
    return tp


def disable() -> None:
    global _ACTIVE
    _ACTIVE = None


def active() -> TickPathScope | None:
    return _ACTIVE


@contextlib.contextmanager
def use(tp: TickPathScope):
    """Scoped activation (tests, bench): restores the previous instance."""
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = tp
    try:
        yield tp
    finally:
        _ACTIVE = prev


def observe_phase(name: str, seconds: float) -> None:
    tp = _ACTIVE
    if tp is not None:
        tp.observe_phase(name, seconds)


def observe_overlap(seconds: float) -> None:
    tp = _ACTIVE
    if tp is not None:
        tp.observe_overlap(seconds)


def observe_reclaimed(seconds: float) -> None:
    tp = _ACTIVE
    if tp is not None:
        tp.observe_reclaimed(seconds)


def observe_event_age(age_ms: float) -> float | None:
    """Fold + clamp one event age; None when the observatory is off (the
    caller then leaves the flight-recorder field unset)."""
    tp = _ACTIVE
    if tp is None:
        return None
    return tp.observe_event_age(age_ms)


def coldstart(name: str, cold: bool = True):
    """First-compile attribution window around a named hot dispatch; the
    pre-allocated no-op when the observatory is off or the dispatch is
    warm."""
    tp = _ACTIVE
    if tp is None:
        return _NOOP_CTX
    return tp.coldstart(name, cold=cold)
