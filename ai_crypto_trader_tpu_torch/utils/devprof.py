"""Device-runtime performance observatory: cost cards, donation checks,
memory watermarks, latency SLOs.

Port of `ai_crypto_trader_tpu/utils/devprof.py`.  The SLO windows, burn
rates, gauges and status are the JAX module's host code, copied: on the
same stream of observations they give the same numbers.  The device-side
instruments are the card's own counterparts, not imitations:

  * **Cost cards** (`carding`): the JAX module lowers a program abstractly
    and reads XLA's cost and memory analyses.  Nothing here is compiled
    ahead of a dispatch, so a program is carded at its FIRST REAL
    DISPATCH, which runs under the card:

      - ``argument_bytes`` / ``output_bytes``: the ``nbytes`` of the
        dispatch's input and output tensors (each storage once);
      - ``alias_bytes``: the bytes of the inputs the program updates in
        place (the tick engine's ring);
      - ``temp_bytes``: on a CUDA device, the caching allocator's peak
        above its level at the start of the dispatch, read from
        ``torch.cuda.memory_stats`` after every operation of the dispatch
        (and from the allocator's own peak when the dispatch set a new
        one).  No peak is ever reset: another reader may own it;
      - ``flops``: ``torch.utils.flop_counter.FlopCounterMode`` over the
        torch operations, plus the operations of each hand-written kernel
        launch, reckoned from its launch shapes (`kernel_cost`) as the
        bound column of PERF.md's kernel table reckons them;
      - ``bytes_accessed``: every non-view torch operation's tensor inputs
        and outputs, plus each kernel launch's bytes (`kernel_cost`).

    A field with no honest counterpart is None and the card's ``notes``
    say why: ``generated_code_bytes`` always (torch operations run
    precompiled kernels; the nvcc libraries are the AOT cache's), and
    ``temp_bytes`` on the CPU (its allocator keeps no statistics).
    Nothing is ever copied from a JAX card.  Cards are published as
    ``program_*{program=...}`` gauges and a ``compile.cost`` span event.
  * **Donation verifier** (`donated` / `verify_donation`): XLA may fall
    back to a silent copy of a donated buffer.  The port's counterpart:
    a buffer the program updates in place must still be the same storage
    after the dispatch (``data_ptr``), and on the carded dispatch an
    operation of the program must have written into that storage (a
    mutating argument of its schema), so no silent copy doubled it; and
    an input the program replaces (a state it returns anew) must have
    been released once the caller dropped it, so nothing holds the old
    copy alive beside the new one.
  * **Memory watermarks** (`DevProf.sample_memory`): for each CUDA device
    this process has initialised, ``torch.cuda.memory_allocated`` (bytes),
    the allocator's live allocation count, the monotone high watermark of
    the sampled bytes (never above ``torch.cuda.max_memory_allocated``)
    and the allocator's own peak.  On a host where CUDA was never
    initialised (the CPU) the sample is empty — the CPU allocator keeps
    no statistics — and so is the status's ``memory`` block.
  * **Latency SLOs** (`observe_latency` / `DevProf.export`): sliding-
    window p50/p99 over ``tick``, ``train_step`` and ``host_read``,
    exported as ``latency_p50_seconds{slo=...}`` /
    ``latency_p99_seconds{slo=...}``, the ``slo_latency_seconds``
    histogram and the ``slo_burn_rate`` gauge that drives the burn-rate
    alert rules of `utils.alerts`.

The observatory is OFF by default: every hot-path helper checks one module
global and returns immediately when no `DevProf` is configured.  Enable
with ``TradingSystem(..., enable_devprof=True)``, ``cli trade --devprof``,
or ``devprof.use(DevProf(metrics=...))`` in tests.
"""

from __future__ import annotations

import contextlib
import threading
import weakref
from collections import deque
from dataclasses import dataclass, field

import torch

# The active observatory. None = disabled (the default): the module-level
# helpers below check this one global and bail out immediately.
_ACTIVE: "DevProf | None" = None

# SLO targets (seconds) for the burn-rate gauge: the latency each window
# is budgeted against.  `error_budget` is the allowed fraction of
# observations over target; burn rate = frac_over(target) / budget, so
# burn 1.0 = exactly on budget, 14.4 = the classic fast-burn page
# threshold (a 30 d budget gone in ~2 d).
DEFAULT_SLO_TARGETS = {
    "tick": 1.0,          # full live tick (monitor→analyzer→executor)
    "train_step": 0.5,    # compiled-epoch / DQN-scan amortized step
    "host_read": 0.25,    # the one device→host sync per dispatch
}
DEFAULT_ERROR_BUDGET = 0.01

NOTE_NO_CODE = ("generated_code_bytes: torch operations run precompiled "
                "kernels; the nvcc libraries are the AOT cache's "
                "(utils.aotcache)")
NOTE_CPU_TEMP = ("temp_bytes: the CPU allocator keeps no statistics")


def percentile(values, q: float) -> float:
    """Nearest-rank percentile over an unsorted sequence (0 when empty).
    No numpy: this runs on hot-path export with tiny windows."""
    if not values:
        return 0.0
    s = sorted(values)
    idx = max(0, min(len(s) - 1, round(q / 100.0 * (len(s) - 1))))
    return s[idx]


class SlidingQuantiles:
    """Bounded-window quantile estimator: observations land in a deque of
    ``window`` samples; quantiles are exact over that window (long-run
    decay for free — old samples fall off the back)."""

    def __init__(self, window: int = 1024):
        self.buf: deque = deque(maxlen=window)
        self.count = 0                       # total ever observed

    def observe(self, value: float) -> None:
        self.buf.append(float(value))
        self.count += 1

    def quantile(self, q: float) -> float:
        return percentile(self.buf, q)

    def frac_over(self, threshold: float) -> float:
        """Fraction of the current window exceeding ``threshold``."""
        if not self.buf:
            return 0.0
        return sum(1 for v in self.buf if v > threshold) / len(self.buf)

    def summary(self) -> dict:
        return {"count": self.count, "window": len(self.buf),
                "p50": self.quantile(50), "p99": self.quantile(99)}


@dataclass
class CostCard:
    """One program's cost/memory attribution, taken at its first real
    dispatch (one-shot).  None = no honest counterpart (see ``notes``)."""

    program: str
    flops: float | None = 0.0
    bytes_accessed: float | None = 0.0
    argument_bytes: int | None = 0
    output_bytes: int | None = 0
    temp_bytes: int | None = 0
    alias_bytes: int | None = 0
    generated_code_bytes: int | None = None
    donation_ok: bool | None = None          # verify_donation result
    error: str | None = None                 # analysis failure, if any
    kernels: dict = field(default_factory=dict)   # {name: launches}
    notes: list = field(default_factory=list)

    def to_dict(self) -> dict:
        return {"program": self.program, "flops": self.flops,
                "bytes_accessed": self.bytes_accessed,
                "argument_bytes": self.argument_bytes,
                "output_bytes": self.output_bytes,
                "temp_bytes": self.temp_bytes,
                "alias_bytes": self.alias_bytes,
                "generated_code_bytes": self.generated_code_bytes,
                "donation_ok": self.donation_ok, "error": self.error,
                "kernels": dict(self.kernels), "notes": list(self.notes)}


def _tensors(tree) -> list:
    """The tensor leaves of a nested tuple/list/dict/NamedTuple."""
    from torch.utils._pytree import tree_leaves

    return [x for x in tree_leaves(tree) if isinstance(x, torch.Tensor)]


def _unique_nbytes(tensors) -> int:
    """Bytes of ``tensors``, each storage counted once (views of one
    buffer are one buffer)."""
    seen, total = set(), 0
    for t in tensors:
        try:
            st = t.untyped_storage()
            key = (t.device, st.data_ptr())
            if key in seen:
                continue
            seen.add(key)
            total += int(st.nbytes())
        except (RuntimeError, NotImplementedError):   # no storage (meta)
            total += int(t.nbytes)
    return total


def _storage_ptr(t) -> int | None:
    try:
        return t.untyped_storage().data_ptr()
    except (RuntimeError, NotImplementedError):      # no storage (meta)
        return None


def _written(func, args, kwargs) -> list:
    """The tensors an operation writes into: its schema's mutating
    arguments (``Tensor(a!)``: in-place and ``out=`` operands)."""
    out = []
    for i, arg in enumerate(func._schema.arguments):
        if arg.alias_info is None or not arg.alias_info.is_write:
            continue
        value = (args[i] if i < len(args) and not arg.kwarg_only
                 else (kwargs or {}).get(arg.name))
        out.extend(_tensors(value))
    return out


class _CardMode(torch.utils._python_dispatch.TorchDispatchMode):
    """Watches every torch operation of a carded dispatch: the bytes of its
    tensor inputs and outputs, the in-place buffers it writes into, and on
    a CUDA device the allocator's level after it.  Bookkeeping failures
    are noted, never raised."""

    def __init__(self, ctx: "_Carding"):
        super().__init__()
        self.ctx = ctx

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        ctx = self.ctx
        try:
            if not func.is_view:
                ctx.torch_bytes += sum(
                    int(t.nbytes) for t in _tensors((args, kwargs, out)))
            if ctx.inplace_ptrs and func._schema.is_mutable:
                ctx.written |= ctx.inplace_ptrs.intersection(
                    _storage_ptr(t) for t in _written(func, args, kwargs))
            if ctx.device is not None:
                ctx.max_level = max(ctx.max_level,
                                    torch.cuda.memory_allocated(ctx.device))
        except Exception as exc:                     # noqa: BLE001
            ctx.bookkeeping_error = f"{type(exc).__name__}: {exc}"
        return out


class _NoopCard:
    """Disabled / already-carded stand-in: ``result`` drops the output."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def result(self, out):
        return out


_NOOP_CARD = _NoopCard()
_OPEN = threading.local()          # the cards open on this thread


def _open_cards() -> list:
    stack = getattr(_OPEN, "cards", None)
    if stack is None:
        stack = _OPEN.cards = []
    return stack


class _Carding:
    """One program's first real dispatch under its cost card."""

    def __init__(self, dp: "DevProf", card: CostCard, args, inplace, device):
        self.dp, self.card = dp, card
        self.args, self.inplace = args, inplace
        self.want_device = device
        self.out = None
        self.torch_bytes = 0
        self.kernel_flops = 0.0
        self.kernel_bytes = 0.0
        self.max_level = 0
        self.inplace_ptrs: set = set()
        self.written: set = set()
        self.bookkeeping_error = None
        self.device = None
        self._flop_mode = None
        self._mode = None

    def result(self, out):
        """Register the dispatch's outputs (their bytes are the card's
        ``output_bytes``); returns ``out``."""
        self.out = out
        return out

    def __enter__(self):
        card = self.card
        try:
            tensors = _tensors(self.args)
            card.argument_bytes = _unique_nbytes(tensors)
            inplace = _tensors(self.inplace)
            card.alias_bytes = _unique_nbytes(inplace)
            self.inplace_ptrs = {_storage_ptr(t) for t in inplace} - {None}
            dev = (torch.device(self.want_device) if self.want_device is not None
                   else next((t.device for t in tensors), None))
            if dev is not None and dev.type == "cuda":
                self.device = dev
                stats = torch.cuda.memory_stats(dev)
                self.level0 = int(stats.get("allocated_bytes.all.current", 0))
                self.peak0 = int(stats.get("allocated_bytes.all.peak", 0))
                self.max_level = self.level0
            from torch.utils.flop_counter import FlopCounterMode

            self._flop_mode = FlopCounterMode(display=False)
            self._flop_mode.__enter__()
            self._mode = _CardMode(self)
            self._mode.__enter__()
        except Exception as exc:                     # noqa: BLE001
            card.error = f"{type(exc).__name__}: {exc}"
        _open_cards().append(self)
        return self

    def __exit__(self, et, ev, tb):
        card = self.card
        stack = _open_cards()
        if self in stack:
            stack.remove(self)
        try:
            if self._mode is not None:
                self._mode.__exit__(et, ev, tb)
            if self._flop_mode is not None:
                self._flop_mode.__exit__(et, ev, tb)
        except Exception as exc:                     # noqa: BLE001
            card.error = card.error or f"{type(exc).__name__}: {exc}"
        if ev is not None:
            card.error = f"dispatch failed: {type(ev).__name__}: {ev}"[:300]
        elif card.error is None:
            try:
                self._fill()
            except Exception as exc:                 # noqa: BLE001
                card.error = f"{type(exc).__name__}: {exc}"
        if self.bookkeeping_error and card.error is None:
            card.error = self.bookkeeping_error
        if self._mode is not None:
            # what the program wrote of its in-place buffers: the donation
            # check of this dispatch requires each of them
            self.dp._written[card.program] = set(self.written)
        self.dp._publish_card(card)
        return False

    def _fill(self) -> None:
        card = self.card
        card.output_bytes = _unique_nbytes(_tensors(self.out))
        card.flops = (float(self._flop_mode.get_total_flops())
                      + self.kernel_flops)
        card.bytes_accessed = float(self.torch_bytes + self.kernel_bytes)
        if NOTE_NO_CODE not in card.notes:
            card.notes.append(NOTE_NO_CODE)
        if self.device is None:
            card.temp_bytes = None
            card.notes.append(NOTE_CPU_TEMP)
            return
        stats = torch.cuda.memory_stats(self.device)
        peak1 = int(stats.get("allocated_bytes.all.peak", 0))
        top = self.max_level
        if peak1 > self.peak0:       # the dispatch set a new process peak
            top = max(top, peak1)
        card.temp_bytes = max(int(top - self.level0), 0)


class MemoryWatermark:
    """Per-CUDA-device allocator accounting with monotone high watermarks
    (the number capacity planning needs: not what is allocated NOW, but
    the most that was ever allocated at a sample).  Samples only devices
    of a process that initialised CUDA; on the CPU the sample is {}."""

    def __init__(self):
        self.peak_bytes: dict[str, int] = {}
        self.peak_count: dict[str, int] = {}
        # newest sample, kept so downstream consumers (the meshprof
        # imbalance fold) can read per-device state without sampling again
        self.last: dict = {}

    @staticmethod
    def _devices() -> list:
        if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
            return []
        return list(range(torch.cuda.device_count()))

    def sample(self, metrics=None) -> dict:
        out = {}
        for i in self._devices():
            dev = f"cuda:{i}"
            stats = torch.cuda.memory_stats(i)
            nbytes = int(torch.cuda.memory_allocated(i))
            count = int(stats.get("allocation.all.current", 0))
            self.peak_bytes[dev] = max(self.peak_bytes.get(dev, 0), nbytes)
            self.peak_count[dev] = max(self.peak_count.get(dev, 0), count)
            out[dev] = {"count": count, "bytes": nbytes,
                        "peak_bytes": self.peak_bytes[dev],
                        "peak_count": self.peak_count[dev],
                        "allocator_peak_bytes":
                            int(torch.cuda.max_memory_allocated(i))}
            if metrics is not None:
                metrics.set_gauge("live_buffer_count", count, device=dev)
                metrics.set_gauge("live_buffer_bytes", nbytes, device=dev)
                metrics.set_gauge("live_buffer_bytes_peak",
                                  self.peak_bytes[dev], device=dev)
        self.last = out
        return out


class DevProf:
    """The observatory instance: cards + SLO windows + watermark.

    ``metrics`` (a MetricsRegistry) receives every gauge/histogram.  (The
    JAX constructor's ``memory_analysis`` has no counterpart: a card here
    costs no second compile.)  Thread-safe: dashboard handler threads read
    cards while offloaded model work observes latencies.
    """

    def __init__(self, metrics=None, slo_targets: dict | None = None,
                 error_budget: float = DEFAULT_ERROR_BUDGET,
                 window: int = 1024, min_samples: int = 32):
        self.metrics = metrics
        self.slo_targets = dict(DEFAULT_SLO_TARGETS if slo_targets is None
                                else slo_targets)
        self.error_budget = error_budget
        self.window = window
        # burn rates report 0 below this window fill: a single build-
        # heavy cold tick is 100% of a 1-sample window and would page
        # instantly — burn alerts need minimum traffic, like real SRE
        # multiwindow burn alerts do
        self.min_samples = min_samples
        self.cards: dict[str, CostCard] = {}
        self.slos: dict[str, SlidingQuantiles] = {}
        self.watermark = MemoryWatermark()
        self.donation_failures: list[str] = []
        # program → storages its carded dispatch wrote of its in-place buffers
        self._written: dict[str, set] = {}
        self._lock = threading.Lock()

    # -- cost cards ----------------------------------------------------------
    def carding(self, name: str, args=(), inplace=(), note: str | None = None,
                device=None):
        """The context a program's dispatch runs in to be carded: the first
        call for ``name`` returns the card's context (use ``.result(out)``
        on the dispatch's outputs), every later one the no-op.  ``args``
        are the dispatch's inputs, ``inplace`` those it updates in place;
        ``note`` lands on the card's notes (why a field is None);
        ``device`` is where the dispatch runs (default: the device of the
        first input tensor).
        Analysis failures land on ``card.error`` — a cost card never kills
        a hot path."""
        with self._lock:
            if name in self.cards:
                return _NOOP_CARD
            card = self.cards[name] = CostCard(program=name)
            if note:
                card.notes.append(note)
        return _Carding(self, card, args, inplace, device)

    def _publish_card(self, card: CostCard) -> None:
        m = self.metrics
        if m is not None:
            for gauge, value in (
                    ("program_flops", card.flops),
                    ("program_bytes_accessed", card.bytes_accessed),
                    ("program_argument_bytes", card.argument_bytes),
                    ("program_output_bytes", card.output_bytes),
                    ("program_temp_bytes", card.temp_bytes),
                    ("program_generated_code_bytes",
                     card.generated_code_bytes)):
                if value is not None:
                    m.set_gauge(gauge, value, program=card.program)
        # compile.cost span event: on the current span when one is open
        # (the dispatch's own span), else a standalone marker span
        from ai_crypto_trader_tpu_torch.utils import tracing

        sp = tracing.current()
        if sp is not None:
            sp.add_event("compile.cost", **card.to_dict())
        else:
            tracer = tracing.active()
            if tracer is not None:
                with tracer.span("compile.cost",
                                 attributes=card.to_dict()):
                    pass

    # -- donation verifier ---------------------------------------------------
    def verify_donation(self, name: str, donated, after=None) -> bool:
        """True iff the dispatch kept its donation promise.  ``donated`` is
        what `donated` captured BEFORE the dispatch; ``after`` the tensors
        the caller holds AFTER it, in the same order, for the buffers
        updated in place (default: the captured tensors themselves).  A
        buffer updated in place must still be the same storage and, when
        the dispatch was carded, have been written by it; a released
        input must be gone.  A broken promise is recorded on the
        card, the ``program_donation_ok`` gauge and ``donation_failures``
        (the DonatedBufferNotFreed alert input)."""
        with self._lock:
            written = self._written.get(name)
        ok = donated.check(after, written) if donated is not None else False
        with self._lock:
            card = self.cards.get(name)
            if card is None:
                card = self.cards[name] = CostCard(program=name)
            card.donation_ok = ok
            if not ok and name not in self.donation_failures:
                self.donation_failures.append(name)
        if self.metrics is not None:
            self.metrics.set_gauge("program_donation_ok",
                                   1.0 if ok else 0.0, program=name)
        return ok

    # -- latency SLOs --------------------------------------------------------
    def observe_latency(self, name: str, seconds: float) -> None:
        with self._lock:
            q = self.slos.get(name)
            if q is None:
                q = self.slos[name] = SlidingQuantiles(window=self.window)
            q.observe(seconds)
        if self.metrics is not None:
            self.metrics.observe("slo_latency_seconds", seconds, slo=name)

    def _slo_snapshots(self) -> dict:
        """{name: (total_count, [window values])} copied under the lock —
        observe_latency appends from worker threads (offloaded model
        work), so readers must never iterate the live deques."""
        with self._lock:
            return {name: (q.count, list(q.buf))
                    for name, q in self.slos.items()}

    def _burn(self, values: list, target: float) -> float:
        if len(values) < self.min_samples:
            return 0.0
        frac = sum(1 for v in values if v > target) / len(values)
        return frac / self.error_budget

    def burn_rates(self) -> dict:
        """{slo: burn rate} for every window with a configured target
        (0.0 until the window holds ``min_samples`` observations)."""
        out = {}
        for name, (_, values) in self._slo_snapshots().items():
            target = self.slo_targets.get(name)
            if target:
                out[name] = self._burn(values, target)
        return out

    def export(self) -> None:
        """Publish the p50/p99 + burn-rate gauges (one call per tick)."""
        m = self.metrics
        if m is None:
            return
        for name, (_, values) in self._slo_snapshots().items():
            m.set_gauge("latency_p50_seconds", percentile(values, 50),
                        slo=name)
            m.set_gauge("latency_p99_seconds", percentile(values, 99),
                        slo=name)
            target = self.slo_targets.get(name)
            if target:
                m.set_gauge("slo_burn_rate", self._burn(values, target),
                            slo=name)

    # -- memory watermarks ---------------------------------------------------
    def sample_memory(self) -> dict:
        return self.watermark.sample(metrics=self.metrics)

    # -- views ---------------------------------------------------------------
    def status(self) -> dict:
        """JSON-able snapshot (dashboard /state.json, cli profile)."""
        with self._lock:
            cards = {n: c.to_dict() for n, c in self.cards.items()}
        slos = {name: {"count": count, "window": len(values),
                       "p50": percentile(values, 50),
                       "p99": percentile(values, 99)}
                for name, (count, values) in self._slo_snapshots().items()}
        return {"cost_cards": cards, "slos": slos,
                "burn_rates": self.burn_rates(),
                "donation_failures": list(self.donation_failures),
                "memory": {d: {"peak_bytes": b}
                           for d, b in self.watermark.peak_bytes.items()}}


class Donation:
    """What a dispatch promised of its inputs, captured before it:
    ``inplace`` tensors keep their storage (``data_ptr``), ``released``
    tensors are gone once the caller dropped them (weak references)."""

    def __init__(self, inplace=(), released=()):
        self.inplace = [(t, t.untyped_storage().data_ptr())
                        for t in _tensors(inplace)]
        self.released = [weakref.ref(t) for t in _tensors(released)]

    def check(self, after=None, written=None) -> bool:
        """``after``: the tensors the caller holds after the dispatch (its
        buffers and new state).  Each in-place buffer's storage must be
        among them and, given ``written`` (the storages the carded dispatch
        wrote into), among those too: a program that updated a copy left
        the buffer unwritten.  Each released input must be gone or be one
        of them (a leaf the program passed through unchanged is reused,
        not copied)."""
        if not self.inplace and not self.released:
            return False
        now = (_tensors(after) if after is not None
               else [t for t, _ in self.inplace])
        ptrs = {t.untyped_storage().data_ptr() for t in now}
        same = all(ptr in ptrs and (written is None or ptr in written)
                   for _, ptr in self.inplace)
        return same and all(r() is None or r().untyped_storage().data_ptr() in ptrs
                            for r in self.released)


# -- module-level hot-path API (single-check disabled path) ------------------

def configure(dp: DevProf) -> DevProf:
    """Install ``dp`` as the process-wide active observatory."""
    global _ACTIVE
    _ACTIVE = dp
    return dp


def disable() -> None:
    global _ACTIVE
    _ACTIVE = None


def active() -> DevProf | None:
    return _ACTIVE


@contextlib.contextmanager
def use(dp: DevProf):
    """Scoped activation (tests): restores the previous instance on exit."""
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = dp
    try:
        yield dp
    finally:
        _ACTIVE = prev


def carding(name: str, args=(), inplace=(), note: str | None = None, device=None):
    """The card context of ``name``'s first real dispatch (see
    `DevProf.carding`); the no-op when the observatory is off or the
    program is carded already."""
    dp = _ACTIVE
    if dp is None:
        return _NOOP_CARD
    return dp.carding(name, args, inplace, note, device)


#: the note of a program that neither updates a buffer in place nor takes
#: one over from its caller: there is no donation to verify
NOTE_NO_DONATION = ("donation_ok: the program updates no buffer in place "
                    "and takes none over from its caller")


def has_card(name: str) -> bool:
    """Cheap pre-dispatch check: is this program already carded?  False
    also when the observatory is disabled — call sites use this to skip
    the donation capture entirely."""
    dp = _ACTIVE
    return dp is not None and name in dp.cards


def donated(inplace=(), released=()) -> Donation | None:
    """Capture a dispatch's donation promise BEFORE it (None when off)."""
    if _ACTIVE is None:
        return None
    return Donation(inplace=inplace, released=released)


def verify_donation(name: str, donated, after=None) -> bool | None:
    dp = _ACTIVE
    if dp is None or donated is None:
        return None
    return dp.verify_donation(name, donated, after=after)


def cards_open() -> bool:
    """Is a card open on this thread?  The kernel wrappers' check before
    they reckon a launch's cost for `kernel_cost` (False at once when the
    observatory is off)."""
    return _ACTIVE is not None and bool(getattr(_OPEN, "cards", None))


def kernel_cost(name: str, flops: float, nbytes: float) -> None:
    """Add one hand-written kernel launch (its operations and bytes,
    reckoned from its launch shapes) to every card open on this thread.
    Called by the kernel wrappers where they count a launch; nothing when
    no card is open."""
    stack = getattr(_OPEN, "cards", None)
    if not stack:
        return
    for ctx in stack:
        ctx.kernel_flops += float(flops)
        ctx.kernel_bytes += float(nbytes)
        ctx.card.kernels[name] = ctx.card.kernels.get(name, 0) + 1


def observe_latency(name: str, seconds: float) -> None:
    dp = _ACTIVE
    if dp is not None:
        dp.observe_latency(name, seconds)
