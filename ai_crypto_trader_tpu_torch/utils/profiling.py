"""Profiling: device traces + per-step timers.

Port of `ai_crypto_trader_tpu/utils/profiling.py`:

  * `trace(dir)` — a ``torch.profiler.profile`` with the CPU and CUDA
    activities (CUPTI on the card) of every thread around the block (so a
    capture started on a dashboard handler thread sees the ticks of the
    loop's thread), written on exit as a
    Chrome trace, ``<dir>/trace.json``, that Perfetto or
    ``chrome://tracing`` loads (the artifact behind the dashboard's
    ``/profile?seconds=N`` and ``cli profile``).  ``cuda=None`` records
    the CUDA activity whenever CUDA is available; `cuda_events` lists what
    a written trace saw on the card (the dashboard reports the count, and
    ``cli profile``, whose ticks run on the card, refuses a trace without
    any: a profile that cannot see the card is never passed off as one).
    `prepare` initialises the CUDA tracing on the thread torch registered
    it on, so a capture started on another thread sees the card.  The
    profiler's start
    and stop run behind `meshprof.sync_gate` (its stop synchronizes the
    card: an armed watch window on another thread is never tripped by it);
  * `StepTimer` — wall-clock step timing that waits for the device work
    the block registered (a CUDA event recorded after it, or nothing on
    the CPU), feeding a MetricsRegistry histogram and the devprof SLO
    window named after it;
  * `annotate` — ``torch.profiler.record_function``: a labelled host
    region in the trace.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import deque

import torch

from ai_crypto_trader_tpu_torch.utils import devprof, meshprof

TRACE_FILE = "trace.json"

annotate = torch.profiler.record_function


#: the trace categories of work on the card
CUDA_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def cuda_events(trace_path: str, categories=CUDA_CATEGORIES) -> list:
    """The names of the device events (kernels, copies, sets) a written
    trace holds, in order of first appearance."""
    with open(trace_path) as f:
        events = json.load(f).get("traceEvents", [])
    names = []
    for ev in events:
        if ev.get("cat") in categories and ev.get("name") not in names:
            names.append(ev.get("name"))
    return names


_PREPARED = []      # the CUDA tracing was prepared in this process


def prepare(cuda: bool | None = None) -> None:
    """Initialise the profiler's CUDA tracing (CUPTI) on the calling thread,
    once per process.  The profiler initialises its CUDA tracing on the
    thread that first prepares a trace, and only when that is the thread
    torch registered it on (the one that imported torch): a capture first
    started on a dashboard handler thread would record no CUDA activity.
    Call it from the main thread before captures run elsewhere (a
    `DashboardServer` does, when it starts)."""
    from torch.profiler import ProfilerActivity, profile

    if cuda is None:
        cuda = torch.cuda.is_available()
    if _PREPARED or not cuda:
        return
    with meshprof.sync_gate():
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            pass
    _PREPARED.append(True)


@contextlib.contextmanager
def trace(log_dir: str, cuda: bool | None = None):
    """Profile the block; write ``<log_dir>/trace.json`` on exit."""
    from torch.profiler import ProfilerActivity, profile

    if cuda is None:
        cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    # every thread's operators: a capture started on a dashboard handler
    # thread must see the ticks the loop runs on its own thread (a torch
    # without the option records this thread's operators and, through
    # CUPTI, every thread's work on the card)
    try:
        config = {"experimental_config": torch._C._profiler._ExperimentalConfig(
            profile_all_threads=True)}
    except TypeError:
        config = {}
    prof = profile(activities=activities, **config)
    with meshprof.sync_gate():
        prof.__enter__()
    try:
        yield prof
    finally:
        with meshprof.sync_gate():
            prof.__exit__(None, None, None)
        prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


class _StepHandle:
    """Receives the in-block result so the timer can wait on it at exit:
        with timer.step() as s:
            s.block(train_step(...))
    """

    def __init__(self):
        self.value = None

    def block(self, value):
        self.value = value
        return value


def _wait(value) -> None:
    """Wait for the device work behind ``value``'s CUDA tensors: one event
    recorded on the current stream of each device they live on."""
    from torch.utils._pytree import tree_leaves

    devices = {x.device for x in tree_leaves(value)
               if isinstance(x, torch.Tensor) and x.is_cuda}
    for dev in devices:
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(dev))
        ev.synchronize()


class StepTimer:
    """Times a step's wall clock (waiting for the device work the block
    registers via `s.block(...)`) and reports into a MetricsRegistry
    histogram.

    ``history`` is BOUNDED (deque of ``window`` samples); ``count`` keeps
    the total ever observed; ``summary()`` gives count/p50/p99 over the
    current window — the shape the devprof SLO estimator consumes.  With
    the observatory active each step also lands in the SLO window named
    by ``name``."""

    def __init__(self, metrics=None, name: str = "step_seconds",
                 window: int = 4096):
        self.metrics = metrics
        self.name = name
        self.history: deque[float] = deque(maxlen=window)
        self.count = 0

    @contextlib.contextmanager
    def step(self):
        handle = _StepHandle()
        t0 = time.perf_counter()
        yield handle
        if handle.value is not None:
            _wait(handle.value)
        dt = time.perf_counter() - t0
        self.history.append(dt)
        self.count += 1
        if self.metrics is not None:
            self.metrics.observe(self.name, dt)
        devprof.observe_latency(self.name, dt)

    @property
    def mean(self) -> float:
        return sum(self.history) / len(self.history) if self.history else 0.0

    def summary(self) -> dict:
        """count (total ever) + window p50/p99 — the SLO estimator's view."""
        return {"count": self.count, "window": len(self.history),
                "p50": devprof.percentile(self.history, 50),
                "p99": devprof.percentile(self.history, 99)}
