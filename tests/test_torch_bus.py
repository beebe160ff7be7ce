"""The port's event bus against the JAX package's, on the CPU.

    shell.EventBus: exact + wildcard fan-out, drop-oldest, the per-channel
    overflow policies ("grow", "alert_on_drop"), depth watermarks, the
    trace context on envelopes, the key/value store, the bus metrics

Host code is held exactly: the same calls on both buses deliver the same
envelopes.  Envelopes carry no ids of their own; their ``ts`` comes from
an injected clock, and the trace ids from an injected ``id_fn`` — so the
whole envelope is compared, and so are the slow-subscriber log lines.
The one thing left out is the fan-out latency histogram (``perf_counter``
times), as the test that reads the metrics says.
"""

import asyncio
import itertools

import pytest

pytest.importorskip("jax")

from ai_crypto_trader_tpu.shell import bus as jbus  # noqa: E402
from ai_crypto_trader_tpu.utils import metrics as jmetrics  # noqa: E402
from ai_crypto_trader_tpu.utils import tracing as jtracing  # noqa: E402
from ai_crypto_trader_tpu_torch.shell import bus as tbus  # noqa: E402
from ai_crypto_trader_tpu_torch.utils import metrics as tmetrics  # noqa: E402
from ai_crypto_trader_tpu_torch.utils import tracing as ttracing  # noqa: E402

PKGS = {"jax": (jbus, jmetrics, jtracing), "port": (tbus, tmetrics, ttracing)}


class Clock:
    def __init__(self):
        self.t = 1_000.0

    def __call__(self):
        self.t += 0.5
        return self.t


class RecordingLog:
    def __init__(self):
        self.lines = []

    def warning(self, msg, **kw):
        self.lines.append((msg, kw))


def drain(q):
    out = []
    while not q.empty():
        out.append(q.get_nowait())
    return out


async def _script(bus_mod, **bus_kw):
    """One fixed sequence of subscriptions and publishes; returns every
    queue's delivered envelopes and the bus's counters."""
    bus = bus_mod.EventBus(max_queue=3, now_fn=Clock(), **bus_kw)
    subs = {name: bus.subscribe(ch) for name, ch in (
        ("market", "market_updates"), ("all", "*"), ("signals", "trading_signals*"),
        ("lane7", "trading_signals.7"), ("alerts", "alerts"), ("quiet", "pattern_?ignals"))}
    for i in range(5):                               # market: drops 2 oldest
        await bus.publish("market_updates", {"symbol": "BTCUSDC", "i": i, "px": 40_000.5 + i})
    for i in range(6):                               # grow: no drop
        await bus.publish("trading_signals", {"i": i})
    await bus.publish("trading_signals.7", {"lane": "7"})
    await bus.publish("pattern_signals", {"p": 1})
    bus.unsubscribe("market_updates", subs["market"])
    await bus.publish("market_updates", {"after": True})
    bus.set("market_data_BTCUSDC", {"px": 1.0})
    bus.set("market_data_ETHUSDC", {"px": 2.0})
    bus.set("other", 3)
    bus.delete("other")
    return bus, {name: drain(q) for name, q in subs.items()}


@pytest.mark.parametrize("overflow", [None, {"market_updates": "alert_on_drop"}])
def test_same_calls_deliver_the_same_envelopes(overflow):
    got = {}
    for name, (bus_mod, _, _) in PKGS.items():
        log = RecordingLog()
        kw = {"log": log} if overflow is None else {"log": log, "overflow": overflow}
        bus, queues = asyncio.run(_script(bus_mod, **kw))
        got[name] = {"queues": queues,
                     "published": dict(bus.published_counts),
                     "dropped": dict(bus.dropped_counts),
                     "watermarks": dict(bus.depth_watermarks),
                     "depths": bus.queue_depths(),
                     "keys": sorted(bus.keys("market_data_*")),
                     "get": bus.get("market_data_ETHUSDC"), "gone": bus.get("other", "none"),
                     "log": log.lines, "max_queue": bus.max_queue}
    assert got["port"] == got["jax"]
    port = got["port"]
    # the script exercised what it should: drops on the bounded channel,
    # none on the grow channels, a wildcard and an exact lane subscriber
    assert port["dropped"]["market_updates"] > 0
    assert len(port["queues"]["signals"]) == 7 and len(port["queues"]["lane7"]) == 1
    assert len(port["queues"]["quiet"]) == 1
    if overflow is not None:                        # MessageLoss alerts
        assert port["queues"]["alerts"] and \
            port["queues"]["alerts"][0]["data"]["name"] == "MessageLoss"
    else:
        assert port["log"] and port["log"][0][0].startswith("slow subscriber")


def test_envelopes_carry_the_publishing_span_and_metrics_match():
    """Trace context rides the envelope; with a MetricsRegistry attached the
    counters and gauges of the two buses' exposition agree.  The fan-out
    latency histogram (perf_counter times) is left out of the comparison."""
    got = {}
    for name, (bus_mod, metrics_mod, tracing_mod) in PKGS.items():
        ids = (f"{i:016x}" for i in itertools.count(1))
        tracer = tracing_mod.Tracer(service="t", now_fn=Clock(), id_fn=lambda: next(ids))
        reg = metrics_mod.MetricsRegistry(now_fn=Clock())

        async def go():
            bus = bus_mod.EventBus(max_queue=2, now_fn=Clock(), metrics=reg)
            q = bus.subscribe("trading_signals.*")
            q2 = bus.subscribe("market_updates")
            with tracing_mod.use(tracer):
                with tracing_mod.span("monitor.poll"):
                    await bus.publish("market_updates", {"x": 1})
                    await bus.publish("trading_signals.3", {"x": 2})
                for i in range(4):
                    await bus.publish("market_updates", {"i": i})
            signals = drain(q)
            with tracing_mod.consumer_span(signals[0], "executor.handle", service="ex") as sp:
                ctx = sp.context()
            bus.sync_family_depth_gauges()
            return signals + drain(q2), ctx

        with tracing_mod.use(tracer):
            envs, ctx = asyncio.run(go())
        text = [line for line in reg.exposition().splitlines()
                if "bus_fanout_latency_seconds" not in line]
        got[name] = {"envs": envs, "ctx": ctx, "metrics": text,
                     "spans": [s.to_dict() for s in tracer.finished]}
    assert got["port"] == got["jax"]
    assert got["port"]["envs"][0]["trace"]["trace_id"] == "0000000000000001"
    assert any("bus_queue_depth" in line and 'channel="trading_signals.*"' in line
               for line in got["port"]["metrics"])


def test_listen_yields_published_envelopes():
    async def go(bus_mod):
        bus = bus_mod.EventBus(now_fn=lambda: 5.0)
        seen = []

        async def consumer():
            async for env in bus.listen("alerts"):
                seen.append(env)
                if len(seen) == 2:
                    break

        task = asyncio.ensure_future(consumer())
        await asyncio.sleep(0)
        await bus.publish("alerts", {"a": 1})
        await bus.publish("alerts", {"a": 2})
        await task
        return seen, bus.queue_depths()

    assert asyncio.run(go(tbus)) == asyncio.run(go(jbus))
