"""Mesh runtime observatory: recompile/transfer sentinels and
padding/collective accounting for population programs.

Port of `ai_crypto_trader_tpu/utils/meshprof.py`.  Layout cards, the
memory-imbalance fold, the counters, alert inputs and status are the JAX
module's host code, with the same arithmetic; the two sentinels watch the
card:

  * **RecompileSentinel** (`watch`): a "compile" in the port is a kernel
    library that `ops._cuda.build` compiles with nvcc, counted by the
    process-wide `utils.tracing.KernelBuildMonitor` (the choice
    `obs.tickpath` made).  Every carded hot dispatch runs under a watch
    window that samples the monitor before and after it; builds in a
    window after the program's warm-up window are steady-state
    recompiles (``mesh_steady_recompiles_total{program=}`` and the
    SteadyStateRecompile alert).  Windows a caller marks ``cold`` (a new
    engine's first dispatch, a never-seen shape) never page.
  * **TransferSentinel** (inside `watch`, plus `allow_transfers`): while a
    window is armed, torch's sync debug mode is ``"error"``, so a
    synchronizing CUDA call on the watched path (``.item()``, a blocking
    copy, ``torch.cuda.synchronize``) raises, aborts the dispatch and is
    counted (``mesh_guarded_transfers_total{program=}``).  The sanctioned
    per-dispatch read (the ``host_read`` seams) runs inside
    `allow_transfers`, which turns the mode off for its span.  The guard
    disarms for a program after its first counted violation, as the JAX
    one does.  Unlike the JAX CPU tripwire it arms on the card; it arms
    only in a process that initialised CUDA (on the CPU there is nothing
    to guard, and torch built without CUDA cannot set the mode).

    The mode is process-wide, not per thread.  So every thread passes one
    gate: the windows of one thread at a time are armed; a sanctioned
    read on another thread waits for them to close (a dispatch) and holds
    arming off while it reads; and device work that runs beside the
    loop's thread (offloaded model work, the profiler's start and stop)
    runs in `sync_gate`, which waits for an armed window the same way.  A
    window arms only when no other device work is in flight: one opened
    while a `sync_gate` scope or another thread's read is open, its own
    included, runs unarmed and is counted (``unarmed_windows``).  So an
    offloaded epoch never arms, and nothing waits for it.
  * **Layout cards** (`record_population_layout`): every
    `Partitioner.population_eval(fn, name=...)` program records its
    pad/mask layout at its dispatch: population, pad rows, per-device
    member count, pad fraction and the all-gather bytes of the outputs.
    On one card the pad is 0 and there is no collective.
  * **Memory imbalance** (`export`): the per-device allocator samples of
    `utils.devprof.MemoryWatermark` fold into ``mesh_memory_imbalance`` =
    max/mean bytes across the devices holding any; on one card it is 1.0.

Like tracing/devprof, the observatory is OFF by default: `watch()` and
every other hot-path helper check one module global and return a
pre-allocated no-op.  Enable with ``TradingSystem(...,
enable_meshprof=True)``, ``cli trade --meshprof``, or
``meshprof.use(MeshProf())`` in tests.
"""

from __future__ import annotations

import contextlib
import math
import re as _re
import threading
from dataclasses import dataclass

import torch

# The active observatory. None = disabled (the default).
_ACTIVE: "MeshProf | None" = None

# Programs whose steady-state rebuild pages (the carded hot programs):
# matching is on the name's first dot-segment so per-arch names like
# "train_epoch.lstm" inherit the family's hotness.
DEFAULT_HOT_PROGRAMS = frozenset({
    "tick_engine", "ga_scan", "backtest_sweep", "population_sweep",
    "train_epoch", "sim_sweep", "dqn_train_iterations", "lob_sweep",
    "tenant_engine", "pbt_generation",
})

# pad fraction above which MeshPaddingWasteHigh fires (a quarter of the
# mesh's lanes burning FLOPs on repeated pad members)
DEFAULT_PAD_WASTE_THRESHOLD = 0.25
# max/mean per-device allocated-bytes ratio above which
# DeviceMemoryImbalance fires (one device holding 2x its fair share)
DEFAULT_IMBALANCE_THRESHOLD = 2.0

# the JAX transfer guard's error shape, and torch's sync debug mode's
_TRANSFER_ERR_RE = _re.compile(
    r"disallow\w*\s.*transfer|transfer.*disallow"
    r"|called a synchronizing CUDA operation",
    _re.IGNORECASE | _re.DOTALL)


def is_transfer_violation(exc: BaseException) -> bool:
    """True iff ``exc`` is a guarded-transfer violation: the error torch's
    sync debug mode raises on a synchronizing CUDA call in an armed
    window (or the JAX transfer guard's, which the rules share)."""
    return exc is not None and _TRANSFER_ERR_RE.search(str(exc)) is not None


class _NoopCtx:
    """Disabled-observatory stand-in (the tracing _NoopCtx pattern)."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NOOP_CTX = _NoopCtx()

# -- the sync gate -----------------------------------------------------------
# torch's sync debug mode is process-wide: every change of it, and every
# sanctioned read or device work on another thread, goes through this
# gate, so one thread's armed window is never disarmed (or left armed) by
# another thread, and no other thread synchronizes while it is armed.
_COND = threading.Condition(threading.Lock())
_OWNER = [None]       # the thread whose windows are armed
_ARMED = [0]          # armed windows open (all on _OWNER)
_ALLOWED = [0]        # sanctioned scopes open inside them
_BUSY = [0]           # sync_gate scopes and other threads' reads open


def _set_mode() -> None:
    torch.cuda.set_sync_debug_mode(
        "error" if _ARMED[0] > 0 and _ALLOWED[0] == 0 else "default")


def _can_arm() -> bool:
    return torch.cuda.is_available() and torch.cuda.is_initialized()


def _enter_busy(me) -> None:
    """Wait for another thread's armed windows to close, then hold arming
    off (caller holds _COND)."""
    while _OWNER[0] is not None and _OWNER[0] != me:
        _COND.wait()
    _BUSY[0] += 1


def _exit_busy() -> None:
    with _COND:
        _BUSY[0] -= 1
        _COND.notify_all()


@contextlib.contextmanager
def sync_gate():
    """Device work beside the loop's thread that may synchronize outside a
    ``host_read`` seam (offloaded model work, the profiler's start and
    stop): it waits for another thread's armed window to close, and no
    window arms while it runs."""
    with _COND:
        _enter_busy(threading.get_ident())
    try:
        yield
    finally:
        _exit_busy()


@dataclass
class LayoutCard:
    """One population program's pad/mask layout (one-shot per shape — the
    newest shape wins)."""

    program: str
    population: int = 0
    pad: int = 0
    devices: int = 1
    collective_bytes: int = 0       # all-gather traffic per dispatch
    device_names: tuple = ()
    ranks: int = 0                  # a process mesh's ranks (0: one controller)
    local_shards: int = 0           # its shards a rank
    backend: str = ""               # and its transport's backend

    @property
    def padded(self) -> int:
        return self.population + self.pad

    @property
    def pad_fraction(self) -> float:
        return self.pad / self.padded if self.padded else 0.0

    @property
    def members_per_device(self) -> float:
        return self.padded / self.devices if self.devices else 0.0

    def to_dict(self) -> dict:
        out = {"program": self.program, "population": self.population,
               "pad": self.pad, "padded": self.padded,
               "devices": self.devices,
               "pad_fraction": round(self.pad_fraction, 6),
               "members_per_device": self.members_per_device,
               "collective_bytes": self.collective_bytes}
        if self.ranks:
            out.update(ranks=self.ranks, local_shards=self.local_shards, backend=self.backend)
        return out


class RecompileSentinel:
    """Per-program build attribution over watch windows.

    The process-wide KernelBuildMonitor counter is global — the sentinel
    attributes its deltas to named programs by sampling it around each
    watched dispatch.  A window's builds count as STEADY-STATE recompiles
    when the program has completed at least ``warmup_windows`` prior
    windows and the caller did not mark the window cold."""

    def __init__(self, metrics=None, warmup_windows: int = 1,
                 hot_programs=DEFAULT_HOT_PROGRAMS):
        self.metrics = metrics
        self.warmup_windows = warmup_windows
        self.hot_programs = frozenset(hot_programs)
        self.windows: dict[str, int] = {}     # completed watch windows
        self.compiles: dict[str, int] = {}    # total attributed builds
        self.steady: dict[str, int] = {}      # builds after warmup
        self.alerted: list[str] = []          # hot programs that rebuilt
        self._lock = threading.Lock()

    def _is_hot(self, name: str) -> bool:
        return name.split(".", 1)[0] in self.hot_programs

    def record_window(self, name: str, compiles: int, *,
                      cold: bool = False, aborted: bool = False) -> None:
        with self._lock:
            warm = self.windows.get(name, 0) >= self.warmup_windows
            if not aborted:
                self.windows[name] = self.windows.get(name, 0) + 1
            if compiles <= 0:
                self._export(name)
                return
            self.compiles[name] = self.compiles.get(name, 0) + compiles
            if warm and not cold and not aborted:
                self.steady[name] = self.steady.get(name, 0) + compiles
                if self._is_hot(name) and name not in self.alerted:
                    self.alerted.append(name)
                if self.metrics is not None:
                    self.metrics.inc("mesh_steady_recompiles_total",
                                     compiles, program=name)
            if self.metrics is not None:
                self.metrics.inc("mesh_program_compiles_total", compiles,
                                 program=name)
            self._export(name)

    def _export(self, name: str) -> None:
        if self.metrics is not None:
            self.metrics.set_gauge("mesh_program_watch_windows",
                                   self.windows.get(name, 0), program=name)

    def steady_total(self) -> int:
        with self._lock:
            return sum(self.steady.values())

    def status(self) -> dict:
        with self._lock:
            return {"windows": dict(self.windows),
                    "compiles": dict(self.compiles),
                    "steady_recompiles": dict(self.steady),
                    "alerted": list(self.alerted)}


class TransferSentinel:
    """Counted guarded-transfer violations per program, and the windows
    that ran unarmed (the gate was held by another thread)."""

    def __init__(self, metrics=None):
        self.metrics = metrics
        self.violations: dict[str, int] = {}
        self.last_error: dict[str, str] = {}
        self.armed_windows = 0
        self.unarmed_windows = 0
        self._lock = threading.Lock()

    def record(self, name: str, exc: BaseException) -> None:
        with self._lock:
            self.violations[name] = self.violations.get(name, 0) + 1
            self.last_error[name] = f"{type(exc).__name__}: {exc}"[:300]
        if self.metrics is not None:
            self.metrics.inc("mesh_guarded_transfers_total", program=name)

    def total(self) -> int:
        with self._lock:
            return sum(self.violations.values())

    def status(self) -> dict:
        with self._lock:
            return {"violations": dict(self.violations),
                    "last_error": dict(self.last_error),
                    "armed_windows": self.armed_windows,
                    "unarmed_windows": self.unarmed_windows}


class _WatchCtx:
    """One build-attribution window + sync guard around one hot dispatch.
    Allocated per watched dispatch only while the observatory is ON."""

    __slots__ = ("mp", "name", "cold", "_mon", "_before", "_armed")

    def __init__(self, mp: "MeshProf", name: str, cold: bool):
        self.mp = mp
        self.name = name
        self.cold = cold
        self._armed = False

    def __enter__(self):
        from ai_crypto_trader_tpu_torch.utils.tracing import KernelBuildMonitor

        self._mon = KernelBuildMonitor.install()
        self._before = self._mon.sample()
        # the guard AUTO-DISARMS per program after its first counted
        # violation: "error" aborts the offending dispatch (that one
        # failure is the counted+alerted signal), but a DETERMINISTIC
        # stray sync must not abort every subsequent tick
        mp = self.mp
        if (mp.guard_transfers and self.name not in mp.transfers.violations
                and _can_arm()):
            me = threading.get_ident()
            with _COND:
                if _OWNER[0] == me or (_OWNER[0] is None and _BUSY[0] == 0):
                    _OWNER[0] = me
                    _ARMED[0] += 1
                    _set_mode()
                    self._armed = True
            with mp.transfers._lock:
                if self._armed:
                    mp.transfers.armed_windows += 1
                else:
                    mp.transfers.unarmed_windows += 1
        return self

    def __exit__(self, et, ev, tb):
        if self._armed:
            with _COND:
                _ARMED[0] -= 1
                if _ARMED[0] == 0:
                    _OWNER[0] = None
                _set_mode()
                _COND.notify_all()
        if ev is not None and is_transfer_violation(ev):
            self.mp.transfers.record(self.name, ev)
        since = self._mon.since(self._before)
        self.mp.recompiles.record_window(self.name, since["compiles"],
                                         cold=self.cold,
                                         aborted=ev is not None)
        return False                      # never swallow — callers recover


@contextlib.contextmanager
def _allowed():
    """The sanctioned device→host scope: inside this thread's armed window
    the sync mode is off for its span; on another thread it waits for the
    armed windows to close and holds arming off while it reads."""
    me = threading.get_ident()
    with _COND:
        own = _OWNER[0] == me
        if own:
            _ALLOWED[0] += 1
            _set_mode()
        else:
            _enter_busy(me)
    try:
        yield None
    finally:
        if own:
            with _COND:
                _ALLOWED[0] -= 1
                _set_mode()
        else:
            _exit_busy()


class MeshProf:
    """The observatory instance: sentinels + layout cards + imbalance.

    ``metrics`` (a MetricsRegistry) receives every ``mesh_*`` series;
    ``guard_transfers=False`` leaves the sync mode alone (watch windows
    then do build attribution only)."""

    def __init__(self, metrics=None, *, warmup_windows: int = 1,
                 guard_transfers: bool = True,
                 hot_programs=DEFAULT_HOT_PROGRAMS,
                 pad_waste_threshold: float = DEFAULT_PAD_WASTE_THRESHOLD,
                 imbalance_threshold: float = DEFAULT_IMBALANCE_THRESHOLD):
        self.metrics = metrics
        self.guard_transfers = guard_transfers
        self.pad_waste_threshold = pad_waste_threshold
        self.imbalance_threshold = imbalance_threshold
        self.recompiles = RecompileSentinel(metrics=metrics,
                                            warmup_windows=warmup_windows,
                                            hot_programs=hot_programs)
        self.transfers = TransferSentinel(metrics=metrics)
        self.layouts: dict[str, LayoutCard] = {}
        self.trial_assignments: dict[str, int] = {}   # device -> trials
        self.last_imbalance: float = 0.0
        self.last_device_count: int = 1
        # lazy own watermark: used only when the launcher runs without
        # devprof (devprof's sampler feeds us its result otherwise)
        self._watermark = None
        self._lock = threading.Lock()

    # -- watch windows --------------------------------------------------------
    def watch(self, name: str, cold: bool = False) -> _WatchCtx:
        return _WatchCtx(self, name, cold)

    # -- layout cards ---------------------------------------------------------
    def record_layout(self, program: str, *, population: int, pad: int,
                      devices: int, out_tree=None,
                      device_names=(), ranks: int = 0, local_shards: int = 0,
                      backend: str = "") -> LayoutCard:
        """Record one population program's pad/mask layout.  Pure host and
        cheap; only the shapes and dtypes of ``out_tree``'s tensors are
        read: every output leaf carrying the padded population axis
        contributes its all-gather bytes (each of the ``devices`` cards
        receives the other ``devices-1`` shards).  A process mesh names
        its ``ranks``, its ``local_shards`` a rank and its ``backend``."""
        padded = population + pad
        collective = 0
        if out_tree is not None and devices > 1:
            from torch.utils._pytree import tree_leaves

            for leaf in tree_leaves(out_tree):
                shape = tuple(getattr(leaf, "shape", ()))
                dtype = getattr(leaf, "dtype", None)
                if not shape or shape[0] != padded or dtype is None:
                    continue
                itemsize = (dtype.itemsize if hasattr(dtype, "itemsize")
                            else torch.empty((), dtype=dtype).element_size())
                collective += math.prod(shape) * itemsize * (devices - 1)
        card = LayoutCard(program=program, population=int(population),
                          pad=int(pad), devices=int(devices),
                          collective_bytes=int(collective),
                          device_names=tuple(str(d) for d in device_names),
                          ranks=int(ranks), local_shards=int(local_shards),
                          backend=str(backend))
        with self._lock:
            self.layouts[program] = card
        m = self.metrics
        if m is not None:
            m.set_gauge("mesh_population", card.population, program=program)
            m.set_gauge("mesh_pad_fraction", card.pad_fraction,
                        program=program)
            m.set_gauge("mesh_collective_bytes", card.collective_bytes,
                        program=program)
            m.set_gauge("mesh_compute_bytes", self._compute_bytes(program),
                        program=program)
            for dev in (card.device_names
                        or [f"device:{i}" for i in range(card.devices)]):
                m.set_gauge("mesh_device_members", card.members_per_device,
                            program=program, device=dev)
        return card

    @staticmethod
    def _compute_bytes(program: str) -> float:
        """The compute side of the byte split: the matching devprof cost
        card's ``bytes_accessed`` (0.0 until/unless one exists — the two
        observatories are independently enableable)."""
        from ai_crypto_trader_tpu_torch.utils import devprof

        dp = devprof.active()
        if dp is None:
            return 0.0
        card = dp.cards.get(program)
        return float(card.bytes_accessed or 0.0) if card is not None else 0.0

    # -- trial farming --------------------------------------------------------
    def record_trial(self, device) -> None:
        """Count one host-farmed trial's device assignment (the HPO
        `trial_devices` round-robin)."""
        dev = str(device)
        with self._lock:
            self.trial_assignments[dev] = self.trial_assignments.get(dev, 0) + 1
        if self.metrics is not None:
            self.metrics.inc("mesh_trial_assignments_total", device=dev)

    # -- memory imbalance -----------------------------------------------------
    def observe_memory(self, per_device: dict | None = None) -> float:
        """Fold a per-device memory sample (devprof.sample_memory output:
        {device: {"bytes": ...}}) into the skew gauge.  Samples its own
        watermark when the caller has none (launcher without devprof)."""
        if per_device is None:
            from ai_crypto_trader_tpu_torch.utils import devprof

            dp = devprof.active()
            if dp is not None and dp.watermark.last:
                # devprof already sampled this tick — fold its newest
                # sample instead of sampling again
                per_device = dp.watermark.last
            else:
                if self._watermark is None:
                    self._watermark = devprof.MemoryWatermark()
                per_device = self._watermark.sample(metrics=self.metrics)
        # skew over PARTICIPATING devices only (those holding any bytes):
        # single-device programs on a multi-card host park every buffer
        # on device 0 by design — idle capacity, not an imbalance
        sizes = [v.get("bytes", 0) for v in per_device.values()
                 if v.get("bytes", 0) > 0]
        self.last_device_count = max(len(sizes), 1)
        mean = sum(sizes) / len(sizes) if sizes else 0.0
        self.last_imbalance = (max(sizes) / mean
                               if sizes and mean > 0 else 0.0)
        if self.metrics is not None:
            self.metrics.set_gauge("mesh_memory_imbalance",
                                   self.last_imbalance)
            self.metrics.set_gauge("mesh_devices", self.last_device_count)
        return self.last_imbalance

    # -- views ----------------------------------------------------------------
    def export(self, memory: dict | None = None) -> None:
        """Per-tick export (launcher): memory-imbalance fold + refresh of
        the byte-split gauges (the devprof card may have landed after the
        layout did)."""
        self.observe_memory(memory)
        m = self.metrics
        if m is None:
            return
        with self._lock:
            programs = list(self.layouts)
        for program in programs:
            m.set_gauge("mesh_compute_bytes", self._compute_bytes(program),
                        program=program)

    def pad_fraction_max(self) -> float:
        with self._lock:
            return max((c.pad_fraction for c in self.layouts.values()),
                       default=0.0)

    def alert_state(self) -> dict:
        """Inputs for the in-process rule engine (utils/alerts.py):
        SteadyStateRecompile / UnintendedHostTransfer /
        MeshPaddingWasteHigh / DeviceMemoryImbalance."""
        with self._lock:
            transfer_programs = [n for n, c in
                                 self.transfers.violations.items() if c]
        return {
            "steady_recompile_programs": list(self.recompiles.alerted),
            "guarded_transfer_programs": transfer_programs,
            "mesh_pad_fraction_max": self.pad_fraction_max(),
            "mesh_pad_waste_threshold": self.pad_waste_threshold,
            "mesh_memory_imbalance": self.last_imbalance,
            "mesh_imbalance_threshold": self.imbalance_threshold,
            "mesh_devices": self.last_device_count,
        }

    def status(self) -> dict:
        """JSON-able snapshot (dashboard /state.json `mesh` block,
        `cli mesh`/`cli status`)."""
        with self._lock:
            layouts = {n: c.to_dict() for n, c in self.layouts.items()}
            trials = dict(self.trial_assignments)
        return {"layouts": layouts,
                "recompiles": self.recompiles.status(),
                "transfers": self.transfers.status(),
                "trial_assignments": trials,
                "memory_imbalance": self.last_imbalance,
                "devices": self.last_device_count}


# -- module-level hot-path API (single-check disabled path) ------------------

def configure(mp: MeshProf) -> MeshProf:
    """Install ``mp`` as the process-wide active observatory."""
    global _ACTIVE
    _ACTIVE = mp
    return mp


def disable() -> None:
    global _ACTIVE
    _ACTIVE = None


def active() -> MeshProf | None:
    return _ACTIVE


@contextlib.contextmanager
def use(mp: MeshProf):
    """Scoped activation (tests): restores the previous instance."""
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = mp
    try:
        yield mp
    finally:
        _ACTIVE = prev


def watch(name: str, cold: bool = False):
    """Build-attribution window + sync guard around one hot dispatch; the
    pre-allocated no-op when the observatory is off."""
    mp = _ACTIVE
    if mp is None:
        return _NOOP_CTX
    return mp.watch(name, cold=cold)


def allow_transfers():
    """Sanctioned device→host scope for the ``host_read`` seams: inside an
    armed window the one explicit per-dispatch sync runs with the sync
    mode off.  No-op when the observatory (or its guarding) is off."""
    mp = _ACTIVE
    if mp is None or not mp.guard_transfers:
        return _NOOP_CTX
    return _allowed()


def record_population_layout(name: str, *, population: int, pad: int,
                             devices: int, out_tree=None,
                             device_names=(), ranks: int = 0, local_shards: int = 0,
                             backend: str = "") -> LayoutCard | None:
    mp = _ACTIVE
    if mp is None:
        return None
    return mp.record_layout(name, population=population, pad=pad,
                            devices=devices, out_tree=out_tree,
                            device_names=device_names, ranks=ranks,
                            local_shards=local_shards, backend=backend)


def record_trial(device) -> None:
    mp = _ACTIVE
    if mp is not None:
        mp.record_trial(device)
