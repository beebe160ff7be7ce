"""End-to-end tracing: spans, bus context propagation, JSONL export.

The reference's tracing story is an unchecked Jaeger TODO (SURVEY §5.1):
Prometheus histograms per service, but no way to follow ONE market tick
through monitor → analyzer → executor.  Because the in-process `EventBus`
replaced Redis, full causal tracing is cheap here: a publish stamps the
envelope with the current span's (trace_id, span_id) and every subscriber
opens its handling span as a child of that context — no service changes
its call signature, the context rides the message.

Three correlated signals, one id:
  * spans     — this module (ring buffer + JSONL export + /traces endpoint)
  * metrics   — span durations feed `span_duration_seconds{stage=...}`
                in the MetricsRegistry; the port's kernel builds feed
                `kernel_build_seconds` (see KernelBuildMonitor)
  * logs      — StructuredLogger lines attach `trace_id` (bus slow-consumer
                warnings, shell/bus.py)

Tracing is OFF by default.  The module-level `span()` / `inject()` helpers
check one module global and return pre-allocated no-ops when no tracer is
configured, so the disabled hot path allocates nothing: no span, no CUDA
event, no profiler range.  All clocks are injectable (`now_fn`) like
everything else in the framework.

The port's own copy of `ai_crypto_trader_tpu/utils/tracing.py`: spans,
the tracer and the module-level helpers are the JAX package's.  Where the
JAX package samples XLA compiles (`JitCompileMonitor`), the port samples
its kernel builds (`KernelBuildMonitor`: nvcc runs of `ops._cuda.build`).
Two additions of the port:

  * ``Tracer(profiler_ranges=True)`` enters
    ``torch.profiler.record_function(<span name>)`` for the extent of each
    span that starts while a `torch.profiler` records, so its trace holds
    those spans as ``user_annotation`` ranges, nested as the spans nest, on
    the profiler's clock beside the kernels and the CUDA runtime's calls;
  * a span given a CUDA ``device`` (and `traced_dispatch` on the card)
    records two timing events around its work.  Nothing waits on them: the
    span's ``device_ms`` is filled once its end event has completed — seen
    when a later span ends, typically right after the program's own host
    read — or by `Tracer.resolve()`, one synchronize for every span still
    pending.  A span is written to the JSONL once its device time is in.
    Where the JAX package blocks on a result (`block_until_ready`),
    `traced_dispatch` on the card therefore returns as the program does,
    without waiting, and its ``execute_s`` is the events' device time.
"""

from __future__ import annotations

import contextlib
import contextvars
import json
import os
import random
import threading
import time
from collections import deque
from dataclasses import dataclass, field

_current_span: contextvars.ContextVar = contextvars.ContextVar(
    "ai_crypto_trader_tpu_torch_current_span", default=None)

# The active tracer. None = tracing disabled (the default): the hot-path
# helpers below check this one global and bail out with zero allocations.
_ACTIVE: "Tracer | None" = None


def _new_id() -> str:
    """16 random hex digits from the process's generator, which `random`
    reseeds in a forked child: no syscall a span (uuid4 reads the OS's
    randomness, a syscall that costs tens of µs on some hosts)."""
    return f"{random.getrandbits(64):016x}"


@dataclass
class Span:
    """One timed operation. trace_id groups a causal chain; parent_id links
    the chain into a tree (publish → handle → publish → handle …)."""

    name: str
    trace_id: str
    span_id: str
    parent_id: str | None = None
    service: str | None = None
    start: float = 0.0
    end: float | None = None
    attributes: dict = field(default_factory=dict)
    events: list = field(default_factory=list)
    status: str = "ok"
    # (start event, end event, fill) while the span's device time is unread
    device_events: tuple | None = field(default=None, repr=False, compare=False)

    def set_attribute(self, key: str, value) -> None:
        self.attributes[key] = value

    def on_device(self, start, end, fill=None) -> None:
        """Two CUDA timing events around the span's work on the card, the
        second recorded (or to be recorded) before the span ends: its
        ``device_ms`` — and whatever ``fill(span, seconds)`` sets — is
        filled once they have completed, without a wait."""
        self.device_events = (start, end, fill)

    def _fill_device(self) -> None:
        start, end, fill = self.device_events
        self.device_events = None
        ms = start.elapsed_time(end)
        self.attributes["device_ms"] = ms
        if fill is not None:
            fill(self, ms / 1e3)

    def add_event(self, name: str, ts: float | None = None, **attrs) -> None:
        self.events.append({"name": name, "ts": ts, **attrs})

    @property
    def duration(self) -> float | None:
        return None if self.end is None else self.end - self.start

    def context(self) -> dict:
        """The carrier dict that propagates through bus envelopes."""
        return {"trace_id": self.trace_id, "span_id": self.span_id}

    def to_dict(self) -> dict:
        return {"name": self.name, "trace_id": self.trace_id,
                "span_id": self.span_id, "parent_id": self.parent_id,
                "service": self.service, "start": self.start, "end": self.end,
                "attributes": self.attributes, "events": self.events,
                "status": self.status}

    @classmethod
    def from_dict(cls, d: dict) -> "Span":
        return cls(**{k: d.get(k) for k in (
            "name", "trace_id", "span_id", "parent_id", "service", "start",
            "end", "status")} | {"attributes": d.get("attributes") or {},
                                 "events": d.get("events") or []})


class _NoopSpan:
    """Disabled-tracing stand-in: absorbs attribute/event writes."""

    __slots__ = ()
    trace_id = span_id = parent_id = None

    def set_attribute(self, key, value):
        pass

    def add_event(self, name, ts=None, **attrs):
        pass

    def on_device(self, start, end, fill=None):
        pass

    def context(self):
        return None


class _NoopCtx:
    __slots__ = ()

    def __enter__(self):
        return _NOOP_SPAN

    def __exit__(self, *exc):
        return False


_NOOP_SPAN = _NoopSpan()
_NOOP_CTX = _NoopCtx()


class Tracer:
    """Span factory + finished-span ring + JSONL exporter.

    ``ring_size`` bounds memory for the dashboard's /traces endpoint;
    ``jsonl_path`` appends every finished span as one JSON line (the
    artifact the acceptance criteria replay); ``metrics`` (a
    MetricsRegistry) receives `span_duration_seconds{stage=<span name>}`;
    ``profiler_ranges`` puts each span in `torch.profiler` traces as a
    ``user_annotation`` range of its name (module docstring).
    """

    def __init__(self, service: str = "trader", now_fn=time.time,
                 ring_size: int = 512, jsonl_path: str | None = None,
                 metrics=None, id_fn=_new_id, profiler_ranges: bool = False):
        self.service = service
        self.now_fn = now_fn
        self.jsonl_path = jsonl_path
        self.metrics = metrics
        self.profiler_ranges = bool(profiler_ranges)
        self._id_fn = id_fn
        self.finished: deque[Span] = deque(maxlen=ring_size)
        self._pending: list[Span] = []    # ended, device time not read yet
        self._lock = threading.Lock()     # offloaded model work ends spans
        self._fh = None                   # from worker threads

    # -- span lifecycle ------------------------------------------------------
    def start_span(self, name: str, service: str | None = None,
                   attributes: dict | None = None, parent=None) -> Span:
        """``parent`` may be a Span, a carrier dict ({"trace_id","span_id"},
        e.g. a bus envelope's "trace" field), or None → the contextvar's
        current span (a fresh root trace when there is none)."""
        if parent is None:
            parent = _current_span.get()
        if isinstance(parent, dict):
            trace_id = parent.get("trace_id") or self._id_fn()
            parent_id = parent.get("span_id")
        elif isinstance(parent, Span):
            trace_id, parent_id = parent.trace_id, parent.span_id
        else:
            trace_id, parent_id = self._id_fn(), None
        return Span(name=name, trace_id=trace_id, span_id=self._id_fn(),
                    parent_id=parent_id, service=service or self.service,
                    start=self.now_fn(),
                    attributes=dict(attributes) if attributes else {})

    def end_span(self, span: Span) -> None:
        span.end = self.now_fn()
        with self._lock:
            self.finished.append(span)
            # device times that completed meanwhile: filled, no wait
            ready = [sp for sp in self._pending if sp.device_events[1].query()]
            for sp in ready:
                self._pending.remove(sp)
                sp._fill_device()
                self._write(sp)
            if span.device_events is not None:
                self._pending.append(span)
            else:
                self._write(span)
        if self.metrics is not None:
            self.metrics.observe("span_duration_seconds",
                                 span.end - span.start, stage=span.name)

    def _write(self, span: Span) -> None:
        """One JSONL line for ``span`` (under the lock)."""
        if self.jsonl_path:
            if self._fh is None:
                os.makedirs(os.path.dirname(self.jsonl_path) or ".",
                            exist_ok=True)
                self._fh = open(self.jsonl_path, "a", encoding="utf-8")
            self._fh.write(json.dumps(span.to_dict(), default=str) + "\n")
            self._fh.flush()

    def resolve(self) -> int:
        """Fill the device time of every span still pending: one
        synchronize for all of them.  Returns how many were filled."""
        with self._lock:
            pending, self._pending = self._pending, []
        if pending:
            _synchronize()
        with self._lock:
            for sp in pending:
                sp._fill_device()
                self._write(sp)
        return len(pending)

    @contextlib.contextmanager
    def span(self, name: str, service: str | None = None,
             attributes: dict | None = None, parent=None, device=None):
        """A span around the block.  ``device``: where the block's work
        runs; on a CUDA device two timing events around it give the span's
        ``device_ms`` (`Span.on_device`)."""
        sp = self.start_span(name, service=service, attributes=attributes,
                             parent=parent)
        token = _current_span.set(sp)
        rng = None
        if self.profiler_ranges:
            import torch

            # a range costs ~10 µs: entered only while a profiler records
            if torch.autograd._profiler_enabled():
                rng = torch.profiler.record_function(name)
                rng.__enter__()
        events = _event_pair(device)
        try:
            yield sp
        except BaseException as exc:
            sp.status = "error"
            sp.attributes.setdefault("error", repr(exc))
            raise
        finally:
            if events is not None:
                events[1].record(events[2])
                sp.on_device(events[0], events[1])
            if rng is not None:
                rng.__exit__(None, None, None)
            _current_span.reset(token)
            self.end_span(sp)

    # -- context propagation -------------------------------------------------
    def current(self) -> Span | None:
        return _current_span.get()

    def inject(self) -> dict | None:
        """Carrier for the current span (what bus envelopes ship)."""
        sp = _current_span.get()
        return sp.context() if sp is not None else None

    # -- views ---------------------------------------------------------------
    def traces(self, limit: int = 20) -> list[dict]:
        """Finished spans grouped by trace_id, most recent trace first —
        the dashboard card / ``/traces`` endpoint payload."""
        with self._lock:
            spans = list(self.finished)
        by_trace: dict[str, list[Span]] = {}
        order: list[str] = []
        for sp in spans:
            if sp.trace_id not in by_trace:
                by_trace[sp.trace_id] = []
                order.append(sp.trace_id)
            by_trace[sp.trace_id].append(sp)
        out = []
        for tid in reversed(order[-limit:] if limit else order):
            group = by_trace[tid]
            roots = [s for s in group if s.parent_id is None]
            start = min(s.start for s in group)
            end = max(s.end for s in group if s.end is not None)
            out.append({
                "trace_id": tid,
                "root": (roots[0].name if roots else group[0].name),
                "start": start,
                "duration_s": end - start,
                "n_spans": len(group),
                "spans": [s.to_dict() for s in group],
            })
        return out

    def export(self, path: str) -> str:
        """Dump the ring to a JSONL file (one span per line), device times
        resolved."""
        self.resolve()
        with self._lock:
            spans = list(self.finished)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w", encoding="utf-8") as f:
            for sp in spans:
                f.write(json.dumps(sp.to_dict(), default=str) + "\n")
        return path

    def close(self) -> None:
        self.resolve()
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None


def read_jsonl(path: str) -> list[Span]:
    """Round-trip a span JSONL export back into Span objects."""
    out = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(Span.from_dict(json.loads(line)))
    return out


# -- module-level hot-path API (zero-allocation when disabled) ---------------

def configure(tracer: Tracer) -> Tracer:
    """Install `tracer` as the process-wide active tracer."""
    global _ACTIVE
    _ACTIVE = tracer
    return tracer


def disable() -> None:
    global _ACTIVE
    _ACTIVE = None


def active() -> Tracer | None:
    return _ACTIVE


@contextlib.contextmanager
def use(tracer: Tracer):
    """Scoped activation (tests): restores the previous tracer on exit."""
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = tracer
    try:
        yield tracer
    finally:
        _ACTIVE = prev


def span(name: str, **kw):
    """Open a span on the active tracer; a shared no-op when tracing is
    off — the single-check, no-allocation disabled path every
    instrumentation site rides."""
    t = _ACTIVE
    if t is None:
        return _NOOP_CTX
    return t.span(name, **kw)


def span_if(cond: bool, name: str, **kw):
    """`span` where ``cond`` holds, else the shared no-op."""
    t = _ACTIVE
    if t is None or not cond:
        return _NOOP_CTX
    return t.span(name, **kw)


def consumer_span(envelope: dict, name: str, **kw):
    """Span for handling one bus envelope: parents to the trace context the
    publisher stamped on it (falls back to the current span, then to a new
    root).  Keeps subscriber call signatures untouched — the context rides
    the message."""
    t = _ACTIVE
    if t is None:
        return _NOOP_CTX
    parent = envelope.get("trace") if isinstance(envelope, dict) else None
    return t.span(name, parent=parent, **kw)


def inject() -> dict | None:
    t = _ACTIVE
    if t is None:
        return None
    return t.inject()


def current() -> Span | None:
    t = _ACTIVE
    if t is None:
        return None
    return t.current()


# -- kernel-build-vs-execute attribution ------------------------------------

class KernelBuildMonitor:
    """Accumulates the port's kernel builds: nvcc wall time, libraries
    built and libraries found built, from `ops._cuda.build`'s listener.

    Sampling the cumulative counters around a dispatch attributes its wall
    time between building kernels and executing:

        before = monitor.sample()
        ... dispatch + stream synchronize ...
        breakdown = monitor.since(before)   # {"compile_s": ..., ...}

    ``compile_s`` is nvcc seconds, ``compiles`` libraries built,
    ``cache_hits`` libraries found built (``cache_misses`` equals
    ``compiles``); ``trace_s`` is 0 (nothing is traced).  Every build also
    feeds the ``kernel_build_seconds`` histogram when a MetricsRegistry is
    attached.  The listener is process-global, so this is a singleton:
    ``KernelBuildMonitor.install()`` returns the shared instance.
    """

    _instance: "KernelBuildMonitor | None" = None

    def __init__(self, metrics=None):
        self.metrics = metrics
        self.compile_seconds = 0.0
        self.compile_count = 0
        self.cache_hits = 0

    @classmethod
    def install(cls, metrics=None) -> "KernelBuildMonitor":
        if cls._instance is None:
            from ai_crypto_trader_tpu_torch.ops import _cuda

            inst = cls(metrics=metrics)
            _cuda.BUILD_LISTENERS.append(inst._on_build)
            cls._instance = inst
        elif metrics is not None:
            cls._instance.metrics = metrics
        return cls._instance

    def _on_build(self, name: str, seconds: float, cached: bool) -> None:
        if cached:
            self.cache_hits += 1
            return
        self.compile_seconds += seconds
        self.compile_count += 1
        if self.metrics is not None:
            self.metrics.observe("kernel_build_seconds", seconds)

    def sample(self) -> dict:
        return {"compile_s": self.compile_seconds,
                "compiles": self.compile_count,
                "trace_s": 0.0,
                "cache_hits": self.cache_hits,
                "cache_misses": self.compile_count}

    def since(self, before: dict) -> dict:
        now = self.sample()
        return {k: (round(now[k] - before[k], 6)
                    if isinstance(now[k], float) else now[k] - before[k])
                for k in now}


def _synchronize() -> None:
    """Wait for every CUDA stream (nothing when CUDA was never used in this
    process): `Tracer.resolve`'s one wait."""
    import torch

    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


def _event_pair(device):
    """(start, end, stream) for timing work on ``device``, the start
    recorded on its current stream; None off a CUDA device."""
    if device is None:
        return None
    import torch

    device = torch.device(device)
    if device.type != "cuda" or not torch.cuda.is_available():
        return None
    stream = torch.cuda.current_stream(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record(stream)
    return start, end, stream


def _execute_on_device(span_obj, seconds: float) -> None:
    span_obj.set_attribute("execute_s", round(seconds, 6))


def traced_dispatch(name: str, call, *, service: str | None = None,
                    attrs_fn=None, device=None):
    """Run one dispatch under a span carrying the kernel-build-vs-execute
    breakdown: nvcc seconds are sampled from the process-wide
    KernelBuildMonitor around the call.  On a CUDA ``device`` two timing
    events around the call give ``device_ms`` and ``execute_s`` once they
    have completed (`Tracer.resolve`); nothing waits for the card.  Off the
    card ``execute_s`` is the call's wall time less its builds.  A plain
    ``call()`` when tracing is off.  The shared body behind the model
    service's and backtest engine's traced entry points."""
    if _ACTIVE is None:
        return call()
    monitor = KernelBuildMonitor.install()
    before = monitor.sample()
    t0 = time.perf_counter()
    with span(name, service=service,
              attributes=attrs_fn() if attrs_fn is not None else None) as sp:
        events = _event_pair(device)
        out = call()
        attribute_dispatch(sp, monitor, before, time.perf_counter() - t0)
        if events is not None:
            events[1].record(events[2])
            sp.on_device(events[0], events[1], fill=_execute_on_device)
    return out


def attribute_dispatch(span_obj, monitor: KernelBuildMonitor | None,
                       before: dict | None, total_s: float) -> None:
    """Record a build-vs-execute breakdown on ``span_obj``: the nvcc
    seconds that elapsed during the dispatch (from the monitor's
    cumulative counters) vs. everything else (device execute + host)."""
    span_obj.set_attribute("total_s", round(total_s, 6))
    if monitor is None or before is None:
        return
    d = monitor.since(before)
    span_obj.set_attribute("compile_s", d["compile_s"])
    span_obj.set_attribute("compiles", d["compiles"])
    span_obj.set_attribute("execute_s", round(max(
        total_s - d["compile_s"] - d["trace_s"], 0.0), 6))
    span_obj.set_attribute("cache_hits", d["cache_hits"])
    span_obj.set_attribute("cache_misses", d["cache_misses"])
