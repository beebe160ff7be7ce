"""Observability: metrics registry with Prometheus text exposition.

Capability parity with `services/utils/metrics.py` (PrometheusMetrics —
counters/gauges/histograms like `trades_executed_total`,
`portfolio_value_usd`, `ai_model_confidence`, `request_latency_seconds`,
plus /metrics + /health endpoints :189-221) without the prometheus_client
dependency: exposition is generated directly; an asyncio TCP server serves
it.  `measure_time` mirrors the reference's latency decorator (:222-281).

The port's own copy of `ai_crypto_trader_tpu/utils/metrics.py`: the same
calls give the same exposition text, byte for byte.
"""

from __future__ import annotations

import asyncio
import time
from collections import defaultdict
from contextlib import contextmanager
from dataclasses import dataclass, field


# Sub-millisecond decades matter for in-process latencies (bus fanout is
# ~1-50 µs: with a 1 ms floor every observation lands in the first bucket
# and histogram_quantile has zero resolution on regressions).
_BUCKETS = (0.00001, 0.0001, 0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0,
            float("inf"))


def escape_label_value(value) -> str:
    """Prometheus text-format label escaping: backslash, double-quote and
    newline must be escaped or a real scrape mangles the series (the
    parser sees a truncated value and a garbage sample line)."""
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def channel_family(channel: str) -> str:
    """Metric-label rollup for per-lane bus channels: the dotted lane
    convention (`trading_signals.<lane>`) makes channel COUNT scale with
    the tenant fleet, and per-channel gauges labeled with raw lane names
    would eat a family's 512-series cap at ~500 lanes — silently
    clipping UNRELATED channels' series behind `_admit`.  Every dotted
    channel rolls up to its `<head>.*` family (one series for the whole
    fleet); undotted channels pass through unchanged.  Queue telemetry
    keeps its per-lane fidelity in `EventBus.queue_depths()` — only the
    metric LABEL is bounded."""
    head, dot, _ = channel.partition(".")
    return f"{head}.*" if dot else channel


@dataclass
class MetricsRegistry:
    namespace: str = "crypto_trader_tpu"
    counters: dict = field(default_factory=lambda: defaultdict(float))
    gauges: dict = field(default_factory=dict)
    histograms: dict = field(default_factory=lambda: defaultdict(
        lambda: {"buckets": defaultdict(int), "sum": 0.0, "count": 0}))
    now_fn: any = time.time
    # Bounded label cardinality: per-(arch, symbol, interval) scorecard
    # gauges and per-(kind, source) attribution series scale with live
    # data, and an unguarded registry would grow without bound (the
    # classic Prometheus cardinality explosion — OOM at the scraper, not
    # here).  Once a metric family holds `max_series_per_metric` distinct
    # label sets, NEW series are dropped and counted on
    # `metric_cardinality_dropped_total{metric=...}` instead of silently
    # accepted; existing series keep updating.
    max_series_per_metric: int = 512
    _series_count: dict = field(default_factory=lambda: defaultdict(int))

    def _key(self, name: str, labels: dict | None):
        lbl = ",".join(f'{k}="{escape_label_value(v)}"'
                       for k, v in sorted((labels or {}).items()))
        return f"{self.namespace}_{name}{{{lbl}}}" if lbl else f"{self.namespace}_{name}"

    def _admit(self, name: str, key: str, store) -> bool:
        """True iff `key` may land in `store` (exists, or family has
        headroom).  The drop counter bypasses the guard: its own
        cardinality is bounded by the number of metric FAMILIES."""
        if key in store:
            return True
        if self._series_count[name] >= self.max_series_per_metric:
            if name != "metric_cardinality_dropped_total":
                self.inc("metric_cardinality_dropped_total", metric=name)
            return False
        self._series_count[name] += 1
        return True

    def inc(self, name: str, value: float = 1.0, **labels):
        key = self._key(name, labels)
        if self._admit(name, key, self.counters):
            self.counters[key] += value

    def set_gauge(self, name: str, value: float, **labels):
        key = self._key(name, labels)
        if self._admit(name, key, self.gauges):
            self.gauges[key] = value

    def observe(self, name: str, value: float, **labels):
        key = self._key(name, labels)
        if not self._admit(name, key, self.histograms):
            return
        h = self.histograms[key]
        h["sum"] += value
        h["count"] += 1
        # Prometheus histogram semantics: buckets are CUMULATIVE — every
        # `le` bucket counts all observations ≤ its bound, so the +Inf
        # bucket always equals `count`. Stored cumulatively so exposition
        # is a plain read (histogram_quantile consumes this directly).
        for b in _BUCKETS:
            if value <= b:
                h["buckets"][b] += 1

    @contextmanager
    def measure_time(self, name: str, **labels):
        """`metrics.py:222-281` decorator equivalent."""
        t0 = self.now_fn()
        try:
            yield
        finally:
            self.observe(name, self.now_fn() - t0, **labels)

    def exposition(self) -> str:
        lines = []
        typed = set()

        def type_line(base: str, mtype: str):
            # one # TYPE per metric family, ahead of its first sample —
            # real Prometheus scrapers use it to pick the sample parser
            if base not in typed:
                typed.add(base)
                lines.append(f"# TYPE {base} {mtype}")

        for k, v in sorted(self.counters.items()):
            type_line(k.partition("{")[0], "counter")
            lines.append(f"{k} {v}")
        for k, v in sorted(self.gauges.items()):
            type_line(k.partition("{")[0], "gauge")
            lines.append(f"{k} {v}")
        for k, h in sorted(self.histograms.items()):
            base, _, lbl = k.partition("{")
            lbl = ("{" + lbl) if lbl else ""
            type_line(base, "histogram")
            for b in _BUCKETS:
                le = "+Inf" if b == float("inf") else str(b)
                l2 = (lbl[:-1] + f',le="{le}"}}') if lbl else f'{{le="{le}"}}'
                lines.append(f"{base}_bucket{l2} {h['buckets'].get(b, 0)}")
            lines.append(f"{base}_sum{lbl} {h['sum']}")
            lines.append(f"{base}_count{lbl} {h['count']}")
        return "\n".join(lines) + "\n"

    async def serve(self, host: str = "127.0.0.1", port: int = 9090):
        """Minimal HTTP /metrics + /health server (the reference gives every
        service a TCP health port, e.g. monte_carlo_service.py:825-845)."""

        async def handler(reader, writer):
            try:
                req = await reader.readline()
                path = req.split()[1].decode() if len(req.split()) > 1 else "/"
                while (await reader.readline()).strip():
                    pass
                if path == "/health":
                    status = "200 OK"
                    body = '{"status": "healthy"}'
                    ctype = "application/json"
                elif path == "/metrics":
                    status = "200 OK"
                    body = self.exposition()
                    ctype = "text/plain"
                else:
                    # unknown paths 404 — serving the full exposition for
                    # every path made probes and typos look like scrapes
                    status = "404 Not Found"
                    body = "not found"
                    ctype = "text/plain"
                payload = body.encode()     # Content-Length counts BYTES:
                #                             a non-ASCII label value would
                #                             otherwise truncate the scrape
                head = (f"HTTP/1.1 {status}\r\nContent-Type: {ctype}\r\n"
                        f"Content-Length: {len(payload)}\r\n\r\n")
                writer.write(head.encode() + payload)
                await writer.drain()
            finally:
                writer.close()

        return await asyncio.start_server(handler, host, port)
