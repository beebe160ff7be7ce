"""In-process async event bus — the control plane that replaces Redis.

The reference's entire inter-service fabric is Redis pub/sub + key-value
state over TCP (`services/utils/redis_pool.py`; SURVEY §1 L1, §5.8): every
numeric result crosses a network bus.  In the TPU-native design, numbers
move over ICI inside XLA collectives; what remains is *control*: signal
fan-out, hot-swapped strategy params, dashboard feeds.  This bus serves that
role in-process (one asyncio loop per host) with the same surface the
reference's services use — publish/subscribe channels + a key-value store —
so every reference channel (`market_updates`, `trading_signals`,
`pattern_signals`, `strategy_update`, …, `dashboard.py:91-99`) has a direct
equivalent.  A multi-host deployment can swap in any transport behind the
same interface without touching services.

Observability: when tracing is active (utils/tracing.py), every publish
stamps the envelope with the current trace context so subscribers can
parent their handling spans to the publish — causal tracing across service
boundaries with unchanged service signatures.  With a MetricsRegistry
attached the bus reports `bus_fanout_latency_seconds{channel=...}` and
`bus_queue_depth{channel=...}`; a StructuredLogger turns queue overflow
(slow subscriber dropping oldest) into a warning carrying the trace_id, so
logs ↔ traces ↔ metrics correlate on one id.

The port's own copy of `ai_crypto_trader_tpu/shell/bus.py`: the same calls
deliver the same envelopes.
"""

from __future__ import annotations

import asyncio
import fnmatch
import time
from collections import defaultdict
from typing import Any, AsyncIterator

from ai_crypto_trader_tpu_torch.utils import tracing
from ai_crypto_trader_tpu_torch.utils.metrics import channel_family


#: Channels where silently losing a message is NOT acceptable telemetry
#: behavior: a dropped alert hides an incident, a dropped trading signal
#: silently skips a trade.  Default policy "grow": their queues are
#: unbounded (backlog is surfaced as a warning past the soft limit instead
#: of discarded).  The other policy is "alert_on_drop": bounded, but every
#: overflow publishes a MessageLoss alert naming the channel.  The
#: trading-signals entry is a PATTERN: per-tenant decision lanes publish
#: on `trading_signals.<lane>` (shell/analyzer.py `lane`), and a lane's
#: signals are exactly as loss-critical as the shared channel's.
CRITICAL_CHANNELS = {"alerts": "grow", "trading_signals*": "grow"}


class EventBus:
    """Channels + KV store. Subscribers get bounded asyncio queues; slow
    consumers drop oldest (the reference's fire-and-forget pub/sub has no
    delivery guarantee either — parity, but explicit).  Critical channels
    carry a per-channel overflow policy instead (see CRITICAL_CHANNELS /
    the ``overflow`` ctor arg): "grow" or "alert_on_drop"."""

    def __init__(self, max_queue: int = 1024, now_fn=time.time,
                 metrics=None, log=None, overflow: dict | None = None,
                 warn_interval_s: float = 30.0):
        self._subs: dict[str, list[asyncio.Queue]] = defaultdict(list)
        # subscription patterns containing fnmatch wildcards — the ONLY
        # ones a publish must scan.  Exact-name subscriptions resolve by
        # dict lookup, so N tenant lanes subscribed to their own
        # `trading_signals.<lane>` cost a publish O(1), not O(N) fnmatch
        # calls per message (the vmapped-tenant scale contract).
        self._wild: set[str] = set()
        self._kv: dict[str, Any] = {}
        self._max_queue = max_queue
        self._now = now_fn
        self.metrics = metrics            # MetricsRegistry | None
        self.log = log                    # StructuredLogger | None
        self.overflow = {**CRITICAL_CHANNELS, **(overflow or {})}
        self.published_counts: dict[str, int] = defaultdict(int)
        self.dropped_counts: dict[str, int] = defaultdict(int)
        # Log rate limiting (edge-trigger + periodic summary): a channel
        # saturated at thousands of publishes/second must not turn the
        # structured log into its own denial of service.  The FIRST drop
        # of an episode logs immediately; further drops within
        # `warn_interval_s` are counted and folded into the next summary
        # line (`suppressed_warnings`).  The drop COUNTERS (and metrics)
        # stay exact — only the log lines are limited.  Wall clock on
        # purpose: `now_fn` may be a frozen/virtual test clock, which
        # would either suppress forever or spam per publish.
        self.warn_interval_s = warn_interval_s
        self._drop_warn: dict[str, tuple[float, int]] = {}
        self._grow_warn: dict[str, tuple[float, int]] = {}
        # per-channel max observed fanout queue depth (the saturation
        # monitor's bus_queue_high_watermark input)
        self.depth_watermarks: dict[str, int] = defaultdict(int)
        # rolled-up metric families' held depth (see publish/
        # sync_family_depth_gauges): {family: (max depth, established at)}
        self._fam_depth_hold: dict[str, tuple[float, float]] = {}

    @property
    def max_queue(self) -> int:
        """Bounded-channel queue capacity (the soft limit for "grow"
        channels) — the denominator of bus_queue_utilization."""
        return self._max_queue

    def _policy(self, channel: str) -> str:
        pol = self.overflow.get(channel)
        if pol is None:
            for pattern, p in self.overflow.items():
                if fnmatch.fnmatch(channel, pattern):
                    return p
            return "drop_oldest"
        return pol

    # --- pub/sub -----------------------------------------------------------
    def subscribe(self, channel: str) -> asyncio.Queue:
        # "grow" channels get an unbounded queue: a slow subscriber backlog
        # on alerts/trading_signals must never silently discard
        maxsize = 0 if self._policy(channel) == "grow" else self._max_queue
        q: asyncio.Queue = asyncio.Queue(maxsize)
        self._subs[channel].append(q)
        if any(c in channel for c in "*?["):
            self._wild.add(channel)
        return q

    def unsubscribe(self, channel: str, q: asyncio.Queue) -> None:
        if q in self._subs.get(channel, []):
            self._subs[channel].remove(q)
            if not self._subs[channel]:
                del self._subs[channel]
                self._wild.discard(channel)

    async def publish(self, channel: str, message: Any) -> int:
        self.published_counts[channel] += 1
        delivered = 0
        dropped = 0
        envelope = {"channel": channel, "ts": self._now(), "data": message}
        # Trace propagation: stamp the originating span's context onto the
        # envelope (one module-global check when tracing is off).
        ctx = tracing.inject()
        if ctx is not None:
            envelope["trace"] = ctx
        fanout_t0 = time.perf_counter() if self.metrics is not None else 0.0
        depth = 0
        # exact-match fast path + wildcard patterns only: fanout cost is
        # O(subscribers of THIS channel + wildcard patterns), independent
        # of how many tenant lanes subscribed to their own channels
        targets = list(self._subs.get(channel, ()))
        for pattern in self._wild:
            if pattern != channel and fnmatch.fnmatch(channel, pattern):
                targets.extend(self._subs.get(pattern, ()))
        for q in targets:
            if q.full():
                try:
                    q.get_nowait()          # drop oldest
                    dropped += 1
                except asyncio.QueueEmpty:
                    pass
            q.put_nowait(envelope)
            delivered += 1
            if q.qsize() > depth:
                depth = q.qsize()
        # capture fanout latency BEFORE the drop-logging below: the flushed
        # log write would otherwise inflate exactly the incidents this
        # metric exists to diagnose
        fanout_s = (time.perf_counter() - fanout_t0
                    if self.metrics is not None else 0.0)
        if depth > self.depth_watermarks[channel]:
            self.depth_watermarks[channel] = depth
        if dropped:
            self.dropped_counts[channel] += dropped
            if self.log is not None:
                # slow-subscriber detection: a full queue means a consumer
                # is not keeping up with the publish rate; the trace_id ties
                # this line to the span and metric views of the same moment.
                # Edge-trigger + periodic summary: the first drop of an
                # episode warns immediately, then at most one summary line
                # per warn_interval_s carrying the suppressed count.
                mono = time.monotonic()
                last, suppressed = self._drop_warn.get(channel, (None, 0))
                if last is None or mono - last >= self.warn_interval_s:
                    self.log.warning(
                        "slow subscriber: dropped oldest message(s)",
                        channel=channel, dropped=dropped,
                        suppressed_warnings=suppressed,
                        total_dropped=self.dropped_counts[channel],
                        queue_depth=depth,
                        trace_id=ctx.get("trace_id") if ctx else None)
                    self._drop_warn[channel] = (mono, 0)
                else:
                    self._drop_warn[channel] = (last, suppressed + 1)
            if (self._policy(channel) == "alert_on_drop"
                    and channel != "alerts"):
                # loss on a critical bounded channel is an INCIDENT, not
                # telemetry: surface it on the alerts channel (itself
                # "grow", so this publish cannot recurse into a drop)
                await self.publish("alerts", {
                    "name": "MessageLoss", "severity": "warning",
                    "channel": channel, "dropped": dropped,
                    "at": self._now()})
        else:
            pending = self._drop_warn.get(channel)
            if (pending is not None and pending[1]
                    and self.log is not None
                    and time.monotonic() - pending[0]
                    >= self.warn_interval_s):
                # a drop episode ENDED without its summary landing (the
                # interval never elapsed while drops kept coming): flush
                # the suppressed count on the next healthy publish, so
                # the log — not just the counters — records the loss
                self.log.warning(
                    "slow subscriber: drop episode ended",
                    channel=channel, suppressed_warnings=pending[1],
                    total_dropped=self.dropped_counts[channel])
                self._drop_warn[channel] = (time.monotonic(), 0)
            if (self._policy(channel) == "grow"
                    and depth > self._max_queue and self.log is not None):
                # unbounded critical channel growing past the soft limit:
                # warn on the episode edge and on doublings, then at most
                # one periodic summary per warn_interval_s while it lasts
                mono = time.monotonic()
                last, warned_depth = self._grow_warn.get(channel, (None, 0))
                if (last is None or depth >= 2 * warned_depth
                        or mono - last >= self.warn_interval_s):
                    self._grow_warn[channel] = (mono, depth)
                    self.log.warning("critical channel backlog growing",
                                     channel=channel, queue_depth=depth,
                                     soft_limit=self._max_queue)
        if self.metrics is not None:
            # per-lane channels (`trading_signals.<lane>`) roll up to one
            # `trading_signals.*` series per family: a 1020-lane fleet
            # would otherwise eat the registry's 512-series cap and clip
            # UNRELATED channels (utils/metrics.channel_family)
            fam = channel_family(channel)
            if fam != channel:
                # last-write-wins across lanes would let an idle lane's
                # depth-0 publish overwrite a backlogged lane's 900
                # between scrapes, hiding backpressure from the
                # bus_queue_depth alert — hold the family MAX here.
                # sync_family_depth_gauges() (the saturation monitor's
                # per-tick close-out) re-anchors it to the true current
                # max; the TTL bounds the hold when NO saturation
                # monitor runs (enable_saturation=False), so a drained
                # transient backlog cannot latch the gauge forever
                mono = time.monotonic()
                held, t_held = self._fam_depth_hold.get(fam, (0, mono))
                if mono - t_held > self.warn_interval_s:
                    held, t_held = 0, mono     # hold expired: re-anchor
                if depth >= held:
                    # the timestamp tracks when the max was ESTABLISHED
                    # (an idle lane's publish must not refresh a stale
                    # hold it didn't set)
                    held, t_held = depth, mono
                self._fam_depth_hold[fam] = (held, t_held)
                depth = held
            self.metrics.observe("bus_fanout_latency_seconds", fanout_s,
                                 channel=fam)
            self.metrics.set_gauge("bus_queue_depth", depth, channel=fam)
            if dropped:
                self.metrics.inc("bus_dropped_messages_total", dropped,
                                 channel=fam)
        return delivered

    def sync_family_depth_gauges(self) -> None:
        """Re-anchor each rolled-up family's held `bus_queue_depth` gauge
        on the TRUE current max over its member channels (the per-publish
        path only max-holds — cheap but monotone until corrected).  One
        O(channels) pass, called once per tick by
        `SaturationMonitor.observe_bus`."""
        if self.metrics is None or not self._fam_depth_hold:
            return
        true_max: dict[str, int] = {}
        for channel, depth in self.queue_depths().items():
            fam = channel_family(channel)
            if fam in self._fam_depth_hold:
                true_max[fam] = max(true_max.get(fam, 0), int(depth))
        mono = time.monotonic()
        for fam in self._fam_depth_hold:
            depth = true_max.get(fam, 0)
            self._fam_depth_hold[fam] = (depth, mono)
            self.metrics.set_gauge("bus_queue_depth", depth, channel=fam)

    def queue_depths(self) -> dict[str, int]:
        """Max pending depth per subscription pattern (telemetry view)."""
        return {pattern: max((q.qsize() for q in queues), default=0)
                for pattern, queues in self._subs.items()}

    async def listen(self, channel: str) -> AsyncIterator[dict]:
        q = self.subscribe(channel)
        try:
            while True:
                yield await q.get()
        finally:
            self.unsubscribe(channel, q)

    # --- key-value state (Redis get/set/hget parity) -----------------------
    def set(self, key: str, value: Any) -> None:
        self._kv[key] = value

    def get(self, key: str, default: Any = None) -> Any:
        return self._kv.get(key, default)

    def keys(self, pattern: str = "*") -> list[str]:
        return [k for k in self._kv if fnmatch.fnmatch(k, pattern)]

    def delete(self, key: str) -> None:
        self._kv.pop(key, None)
