"""Failure detection & recovery: heartbeats, device liveness, resume.

The reference's failure story is per-container TCP health ports +
docker-compose restarts + per-service Redis reconnect loops (SURVEY §5.3).
The in-process equivalents:

  * `HeartbeatRegistry` — services beat on every loop; the checker flags
    stale services (the ServiceDown alert input);
  * `device_liveness` — a tiny computation round-trips through every
    visible CUDA card; a card that can't complete it is reported dead;
  * `resume_or_init` — the elastic-recovery primitive: reload the single
    checkpoint (params, opt state, PRNG, cursors — utils/checkpoint.py) or
    build fresh state, so a restarted host rejoins from the last step
    instead of cold-starting (the reference re-reads scattered Redis keys
    and .h5 files);
  * for multi-host pods, recovery = restart process → `initialize_distributed`
    (parallel/mesh.py) → `resume_or_init` — documented here as the runbook.

The port's own copy of `ai_crypto_trader_tpu/utils/health.py`: the
registry and the lag probe are host code, copied; `device_liveness` runs
its round trip in PyTorch on ``device`` (None: every CUDA card, raising
without one; ``"cpu"``: the CPU), and `resume_or_init` loads through the
port's `utils.checkpoint`.
"""

from __future__ import annotations

import asyncio
import time
from dataclasses import dataclass, field
from typing import Callable

import torch

from ai_crypto_trader_tpu_torch.device import resolve_device


@dataclass
class HeartbeatRegistry:
    """``stale_after_s`` is the default staleness threshold; services with
    a different cadence (a 24 h-retrain model service vs. a 5 s monitor)
    get per-service overrides via ``stale_after`` ({service: seconds}).
    With a StructuredLogger attached (``log``), every healthy↔stale
    transition emits one structured line naming the service."""

    stale_after_s: float = 30.0
    stale_after: dict = field(default_factory=dict)   # per-service override
    now_fn: Callable[[], float] = time.time
    log: object = None                                # StructuredLogger | None
    beats: dict = field(default_factory=dict)
    # Registered-but-possibly-never-beaten services: a service that crashes
    # BEFORE its first beat would otherwise never appear in service_health,
    # so ServiceDown could never fire for it. Launcher/stack expect() every
    # service at build time; an expected service with no beat reports
    # unhealthy once its grace window (registered_at + threshold) passes.
    expected: dict = field(default_factory=dict)      # name -> registered_at
    _was_stale: set = field(default_factory=set)

    def beat(self, service: str) -> None:
        self.beats[service] = self.now_fn()

    def expect(self, service: str) -> None:
        self.expected.setdefault(service, self.now_fn())

    def _threshold(self, service: str) -> float:
        return self.stale_after.get(service, self.stale_after_s)

    def stale(self) -> list[str]:
        now = self.now_fn()
        out = [s for s, t in self.beats.items()
               if now - t > self._threshold(s)]
        # never-beaten expected services: stale once the same threshold has
        # elapsed since registration (the grace window covers slow starts)
        out += [s for s, t0 in self.expected.items()
                if s not in self.beats and now - t0 > self._threshold(s)]
        if self.log is not None:
            cur = set(out)
            for s in sorted(cur - self._was_stale):
                ref = self.beats.get(s, self.expected.get(s, now))
                self.log.warning("service went stale", service_name=s,
                                 age_s=now - ref,
                                 threshold_s=self._threshold(s),
                                 never_beat=s not in self.beats)
            for s in sorted(self._was_stale - cur):
                if s in self.beats:
                    self.log.info("service recovered", service_name=s)
            self._was_stale = cur
        return out

    def health(self) -> dict:
        """The `service_health` map the alert rules consume — covers every
        service that has beaten OR is expected to."""
        stale = set(self.stale())
        names = list(dict.fromkeys([*self.beats, *self.expected]))
        return {s: s not in stale for s in names}

    def staleness(self) -> dict:
        """Continuous per-service staleness in seconds (registered
        services only: beaten ∪ expected) — the
        `heartbeat_staleness_seconds{service=...}` gauge, so Grafana can
        graph a service's drift toward its threshold instead of only
        seeing the edge-triggered ServiceDown alert.  Never-beaten
        expected services age from their registration time."""
        now = self.now_fn()
        names = list(dict.fromkeys([*self.beats, *self.expected]))
        return {s: max(now - self.beats.get(s, self.expected.get(s, now)),
                       0.0)
                for s in names}


class EventLoopLagProbe:
    """Asyncio scheduling-delay probe: how long a ready callback waits
    before the loop runs it.

    Every stage of the tick pipeline shares ONE event loop — a blocking
    host call anywhere (a synchronous device sync, an un-offloaded model
    step, a disk fsync on the hot path) delays every other coroutine, and
    no per-stage timer shows it as anyone else's problem.  `sample()`
    schedules a zero-delay callback stamped with `perf_counter` and
    returns the most recently COMPLETED measurement: the callback runs
    when control next returns to the loop, so the measured delay includes
    any blocking work between the sample and the next suspension point.
    Exported as the `event_loop_lag_seconds` gauge (sampled once per
    launcher tick by the saturation monitor)."""

    def __init__(self, clock: Callable[[], float] = time.perf_counter):
        self._clock = clock
        self._pending = False
        self.last_lag_s = 0.0
        self.max_lag_s = 0.0
        self.samples = 0

    def _complete(self, t0: float) -> None:
        self.last_lag_s = max(self._clock() - t0, 0.0)
        self.max_lag_s = max(self.max_lag_s, self.last_lag_s)
        self.samples += 1
        self._pending = False

    def reset(self) -> None:
        """Fresh measurement window (the load ramp's per-step re-window;
        an in-flight sample completes into the new window)."""
        self.last_lag_s = 0.0
        self.max_lag_s = 0.0
        self.samples = 0

    def sample(self) -> float:
        """Schedule one measurement on the running loop (no-op while one
        is in flight, or with no loop running — e.g. sync tests); returns
        the latest completed lag in seconds."""
        if not self._pending:
            try:
                loop = asyncio.get_running_loop()
            except RuntimeError:
                return self.last_lag_s
            self._pending = True
            loop.call_soon(self._complete, self._clock())
        return self.last_lag_s


def device_liveness(device=None) -> dict:
    """Round-trip a tiny computation through every device: ``device=None``
    probes each CUDA card (``RuntimeError`` without one), ``"cpu"`` or one
    card probes that device alone.  A device whose ``+ 1`` fails, or comes
    back wrong, reports False."""
    dev = resolve_device(device)
    if device is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    else:
        devices = [dev]
    out = {}
    for d in devices:
        try:
            x = torch.ones(8, device=d)
            y = x + 1.0
            if d.type == "cuda":
                torch.cuda.synchronize(d)
            out[str(d)] = bool((y == 2.0).all().item())
        except Exception:
            out[str(d)] = False
    return out


def resume_or_init(path: str, init_fn: Callable[[], tuple], device=None):
    """Load (state, metadata) from the checkpoint at `path` onto ``device``
    (None: the CUDA card), or build fresh via init_fn() when
    absent/corrupt. Returns (state, metadata, resumed)."""
    import os

    from ai_crypto_trader_tpu_torch.utils.checkpoint import load_checkpoint

    if os.path.isdir(path):
        try:
            tree, meta = load_checkpoint(path, device=device)
            return tree, meta, True
        except Exception:
            pass
    state = init_fn()
    return state, {}, False
