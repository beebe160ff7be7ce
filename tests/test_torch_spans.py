"""The port's spans at the layer boundaries of a tick and a sweep request,
on the CPU.

    a stream-served fused tick (`StreamSupervisor.offer`/`step` →
    `TenantEngine.feats_from_tick`/`decide`) and a sweep request
    (`sample_params` → `sweep` → `compute_metrics`): the span tree under
    one root, one trace id, the attributes and counters · the kernel
    path's ``replay.stage`` / ``replay.launch`` (routed to stub launches) ·
    off: the shared no-op, no profiler range, no CUDA event ·
    ``profiler_ranges=True``: every span a ``user_annotation`` range of a
    `torch.profiler` trace, nested as the spans nest · `traced_dispatch`
    never waits on the card; `Tracer.resolve` fills the device times ·
    the per-symbol ``monitor.fetch`` span on a venue (REST) poll only.

Timing events are fakes (`_FakeEvents`): the CPU has no CUDA events.
"""

import asyncio
import contextlib
import itertools
import json

import numpy as np
import pytest
import torch

from ai_crypto_trader_tpu_torch.backtest import compute_metrics, prepare_inputs, sample_params
from ai_crypto_trader_tpu_torch.backtest import engine as tengine
from ai_crypto_trader_tpu_torch.data import generate_ohlcv
from ai_crypto_trader_tpu_torch.data.ingest import OHLCV
from ai_crypto_trader_tpu_torch.obs import fleetscope, tickpath
from ai_crypto_trader_tpu_torch.ops import compute_indicators
from ai_crypto_trader_tpu_torch.ops import replay as treplay
from ai_crypto_trader_tpu_torch.ops.tenant_engine import TenantEngine
from ai_crypto_trader_tpu_torch.shell.bus import EventBus
from ai_crypto_trader_tpu_torch.shell.exchange import FakeExchange
from ai_crypto_trader_tpu_torch.shell.monitor import MarketMonitor
from ai_crypto_trader_tpu_torch.shell.stream import MarketStream, StreamSupervisor
from ai_crypto_trader_tpu_torch.testing.chaos import kline_frames_for
from ai_crypto_trader_tpu_torch.utils import devprof, meshprof
from ai_crypto_trader_tpu_torch.utils import tracing

SYMBOLS, INTERVALS, LIMIT, TENANTS = ("AAAUSDC", "BBBUSDC", "CCCUSDC"), ("1m", "5m"), 64, 4


@pytest.fixture(autouse=True)
def _no_scopes():
    """No observatory and no tracer active (another test on the worker may
    have left one); each is put back afterwards."""
    with tickpath.use(None), devprof.use(None), meshprof.use(None), \
            fleetscope.use(None), tracing.use(None):
        yield


class Clock:
    def __init__(self, t=1_000_000.0):
        self.t = t

    def __call__(self):
        return self.t


class Ticker:
    def __init__(self, t=100.0, step=0.001):
        self.t, self.step = t, step

    def __call__(self):
        self.t += self.step
        return self.t


def _ids():
    it = (f"{i:016x}" for i in itertools.count(1))
    return lambda: next(it)


def _tracer(**kw):
    return tracing.Tracer(service="test", now_fn=Ticker(), ring_size=4096, id_fn=_ids(), **kw)


class _Rig:
    """A stream-served fused monitor over a venue tape, and a tenant
    engine deciding every symbol, on the CPU.  ``warm`` ticks until every
    lane is warm and every window is served from the candle books."""

    def __init__(self):
        n = 5 * LIMIT + 160
        series = {}
        for i, s in enumerate(SYMBOLS):
            d = generate_ohlcv(n=n, seed=20 + i)
            series[s] = OHLCV(timestamp=np.arange(n, dtype=np.int64) * 60_000,
                              open=d["open"], high=d["high"], low=d["low"], close=d["close"],
                              volume=d["volume"] * 1000, symbol=s)
        self.clock = Clock()
        self.ex = FakeExchange(series, quote_balance=10_000)
        self.ex.advance(steps=5 * LIMIT + 20)
        self.bus = EventBus(now_fn=self.clock)
        self.mon = MarketMonitor(self.bus, self.ex, symbols=list(SYMBOLS), intervals=INTERVALS,
                                 kline_limit=LIMIT, now_fn=self.clock, device="cpu")
        self.stream = MarketStream(self.mon, now_fn=self.clock)
        self.sup = StreamSupervisor(self.stream, bus=self.bus, now_fn=self.clock)
        self.tenants = TenantEngine(list(SYMBOLS), TENANTS, device="cpu")
        self.frames = 0

    async def tick(self):
        self.ex.advance(steps=1)
        self.clock.t += 60.0
        frames = kline_frames_for(self.ex, list(SYMBOLS), INTERVALS,
                                  event_ms=int(self.clock.t * 1000))
        self.frames = len(frames)
        for f in frames:
            self.sup.offer(f)
        published = await self.sup.step()
        eng = self.mon._engine
        feats = self.tenants.feats_from_tick(eng.last_out, eng.last_valid)
        self.tenants.decide(feats)
        return published

    def warm(self):
        for _ in range(12):
            asyncio.run(self.tick())
            if self.mon._engine.last_valid[:len(SYMBOLS), :len(INTERVALS)].all() \
                    and self.stream.backfills == self._backfills:
                return self
            self._backfills = self.stream.backfills
        raise AssertionError("the rig did not reach the stream-served steady state")

    _backfills = -1


@pytest.fixture(scope="module")
def rig():
    with tickpath.use(None), devprof.use(None), meshprof.use(None), \
            fleetscope.use(None), tracing.use(None):
        return _Rig().warm()


def _tree(spans):
    """{span_id: span}, and the children of each span id in start order."""
    by_id = {s.span_id: s for s in spans}
    kids = {}
    for s in sorted(spans, key=lambda s: s.start):
        kids.setdefault(s.parent_id, []).append(s)
    return by_id, kids


def _names(kids, span):
    return [c.name for c in kids.get(span.span_id, [])]


def _one(spans, name):
    (s,) = [s for s in spans if s.name == name]
    return s


def test_a_stream_served_tick_is_one_tree_under_its_root(rig):
    tracer = _tracer()
    with tracing.use(tracer):
        with tracing.span("tick") as root:
            published = asyncio.run(rig.tick())
    spans = list(tracer.finished)
    assert {s.trace_id for s in spans} == {root.trace_id}
    by_id, kids = _tree(spans)
    assert root.parent_id is None and _names(kids, root) == \
        ["stream.step", "tenant.feats", "tenant.decide"]
    step = _one(spans, "stream.step")
    assert _names(kids, step) == ["stream.parse", "stream.drain"]
    assert _names(kids, _one(spans, "stream.drain")) == \
        ["monitor.ingest", "monitor.tick_engine", "monitor.publish"]
    # stream-served windows: no per-symbol fetch span
    assert _names(kids, _one(spans, "monitor.ingest")) == []
    assert _names(kids, _one(spans, "monitor.tick_engine")) == \
        ["tick.stage", "tick.dispatch", "tick.read"]
    assert _names(kids, _one(spans, "monitor.publish")) == ["monitor.poll"] * len(SYMBOLS)
    assert _names(kids, _one(spans, "tenant.decide")) == \
        ["tenant.upload", "tenant.dispatch", "tenant.read"]
    for s in spans:                               # children nest inside parents
        if s.parent_id is not None:
            p = by_id[s.parent_id]
            assert p.start <= s.start <= s.end <= p.end, s.name

    a = {s.name: s.attributes for s in spans if s.name != "monitor.poll"}
    assert a["stream.step"] == {"frames": rig.frames, "published": published}
    assert a["stream.parse"]["frames"] == rig.frames and a["stream.parse"]["malformed"] == 0
    assert a["stream.parse"]["rows"] == rig.frames     # every frame applied to the ring
    assert published == len(SYMBOLS) and a["monitor.publish"] == {"updates": len(SYMBOLS)}
    assert a["monitor.ingest"] == {"symbols": len(SYMBOLS), "frames": len(INTERVALS),
                                   "rows": 0, "windows": 0, "rest_fetches": 0}
    assert a["tick.stage"]["rows"] >= len(SYMBOLS) and a["tick.stage"]["bytes"] > 0
    assert a["tick.dispatch"] == {"k2_launches": 0}      # the CPU's plain EWMA
    assert a["tick.read"]["wait_s"] >= 0.0
    assert a["monitor.tick_engine"]["dispatches"] == 1
    assert a["tenant.feats"] == {"symbols": len(SYMBOLS)}
    assert a["tenant.decide"]["lanes"] == TENANTS * len(SYMBOLS)
    assert a["tenant.decide"]["full_seed"] is False
    assert a["tenant.decide"]["upload_bytes"] > 0


def test_a_venue_poll_keeps_one_fetch_span_a_symbol(rig):
    """The REST poll (the monitor's own `_fetch`): a ``monitor.fetch`` span
    a symbol, covering its frames, inside ``monitor.ingest``."""
    tracer = _tracer()
    with tracing.use(tracer):
        n = asyncio.run(rig.mon.poll(force=True))
    spans = list(tracer.finished)
    _, kids = _tree(spans)
    ingest = _one(spans, "monitor.ingest")
    fetches = [s for s in kids[ingest.span_id]]
    assert [s.name for s in fetches] == ["monitor.fetch"] * len(SYMBOLS)
    assert [s.attributes for s in fetches] == [{"symbol": s, "frames": len(INTERVALS)}
                                               for s in SYMBOLS]
    assert ingest.attributes["rest_fetches"] == len(SYMBOLS) * len(INTERVALS)
    assert n == len(SYMBOLS)


def _sweep_setup(n=300, B=6):
    d = {k: v for k, v in generate_ohlcv(n=n, seed=3).items() if k != "regime"}
    inputs = prepare_inputs(compute_indicators(d, device="cpu"), device="cpu")
    return inputs, B


def _request(inputs, B, seed=0):
    gen = torch.Generator().manual_seed(seed)
    params = sample_params(gen, B, device="cpu")
    stats = tengine.sweep(inputs, params, device="cpu")
    return compute_metrics(stats, device="cpu")


def test_a_sweep_request_is_one_tree_under_its_root():
    inputs, B = _sweep_setup()
    tracer = _tracer()
    with tracing.use(tracer):
        with tracing.span("request") as root:
            metrics = _request(inputs, B)
    spans = list(tracer.finished)
    assert {s.trace_id for s in spans} == {root.trace_id}
    _, kids = _tree(spans)
    assert _names(kids, root) == ["strategy.sample", "backtest.sweep", "backtest.metrics"]
    sweep = _one(spans, "backtest.sweep")
    assert _names(kids, sweep) == []              # the CPU runs the plain loop
    assert sweep.attributes["population"] == B and sweep.attributes["candles"] == 300
    assert sweep.attributes["execute_s"] >= 0.0 and "device_ms" not in sweep.attributes
    plain = _request(inputs, B)
    for k, v in metrics.items():
        assert torch.equal(v, plain[k]), k


class _FakeEvents:
    """Timing events of a card that never existed: each pair reads
    ``ms``; ``done`` says whether the card has passed them (query)."""

    def __init__(self, ms=2.5, done=True):
        self.ms, self.done, self.made, self.waits = ms, done, 0, 0

    def pair(self, device):
        if device is None:
            return None
        self.made += 1
        fake = self

        class Event:
            def record(self, stream=None):
                pass

            def query(self):
                return fake.done

            def elapsed_time(self, other):
                assert fake.done, "read before the card passed the event"
                return fake.ms

        return Event(), Event(), None

    def synchronize(self):
        self.waits += 1
        self.done = True


def _route_kernel(monkeypatch):
    """`sweep` through `sweep_kernel` on the CPU: the launching branch's
    seams to stub launches that run the plain loop."""
    def gate(lib, s, T, warmup, thr, min_strength, dev):
        return torch.zeros(-(-T // 32), dtype=torch.int32)

    def walk(lib, s, mask, stop_loss, take_profit, T, warmup, initial_balance,
             return_curve, dev):
        inputs = tengine.BacktestInputs(*(s[k] for k in tengine.BacktestInputs._fields))
        st = treplay.sweep_plain(inputs, tengine.StrategyParams(
            *[stop_loss] * len(tengine.StrategyParams._fields))._replace(
                stop_loss=stop_loss, take_profit=take_profit), initial_balance=initial_balance,
            warmup=warmup)
        out_f = torch.stack([getattr(st, k).to(torch.float32) for k in treplay._F_ROWS])
        out_i = torch.stack([getattr(st, k).to(torch.int32) for k in treplay._I_ROWS])
        return out_f, out_i, None

    monkeypatch.setattr(tengine, "launches_kernel", lambda dev: True)
    monkeypatch.setattr(tengine, "_sweep_on", lambda i, p, dev, rq, kw: treplay.sweep_kernel(
        i, p, device=dev, **kw))
    monkeypatch.setattr(treplay._cuda, "library", lambda *a, **k: None)
    monkeypatch.setattr(treplay, "launch_gate", gate)
    monkeypatch.setattr(treplay, "launch_walk", walk)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())


def test_the_kernel_path_stages_and_launches_under_the_sweep(monkeypatch):
    inputs, B = _sweep_setup()
    events = _FakeEvents(ms=4.0, done=False)
    _route_kernel(monkeypatch)
    monkeypatch.setattr(tracing, "_event_pair", events.pair)
    monkeypatch.setattr(tracing, "_synchronize", events.synchronize)
    tracer = _tracer()
    before = treplay.sweep_kernel.launches
    with tracing.use(tracer):
        with tracing.span("request"):
            _request(inputs, B)
    assert treplay.sweep_kernel.launches == before + 1
    spans = list(tracer.finished)
    _, kids = _tree(spans)
    sweep = _one(spans, "backtest.sweep")
    assert _names(kids, sweep) == ["replay.stage", "replay.launch"]
    launch = _one(spans, "replay.launch")
    assert launch.attributes == {"k1_launches": 1}    # device time still pending
    assert events.waits == 0
    assert tracer.resolve() == 2 and events.waits == 1
    assert launch.attributes == {"k1_launches": 1, "device_ms": 4.0}
    assert sweep.attributes["device_ms"] == 4.0 and sweep.attributes["execute_s"] == 0.004


def test_traced_dispatch_never_waits_and_resolve_fills_device_times(monkeypatch, tmp_path):
    events = _FakeEvents(ms=7.5, done=False)
    monkeypatch.setattr(tracing, "_event_pair", events.pair)
    monkeypatch.setattr(tracing, "_synchronize", events.synchronize)
    path = str(tmp_path / "spans.jsonl")
    tracer = tracing.Tracer(now_fn=Ticker(), id_fn=_ids(), jsonl_path=path)
    with tracing.use(tracer):
        out = tracing.traced_dispatch("model.predict", lambda: 3, service="nn",
                                      device="cuda")
        with tracing.span("after"):               # the card has not passed the events
            pass
    assert out == 3 and events.waits == 0
    sp = _one(tracer.finished, "model.predict")
    assert "device_ms" not in sp.attributes and sp.device_events is not None
    assert [s.name for s in tracing.read_jsonl(path)] == ["after"]   # written once resolved
    assert tracer.resolve() == 1 and events.waits == 1
    assert sp.attributes["device_ms"] == 7.5 and sp.attributes["execute_s"] == 0.0075
    assert tracer.resolve() == 0 and events.waits == 1
    tracer.close()
    assert [s.name for s in tracing.read_jsonl(path)] == ["after", "model.predict"]
    # events the card has passed are filled when a later span ends: no wait
    events.done = True
    with tracing.use(tracer):
        with tracing.span("dispatch", device="cuda") as d:
            pass
        with tracing.span("read"):
            pass
    assert d.attributes == {"device_ms": 7.5} and events.waits == 1
    # off the card: wall time less builds, no events
    with tracing.use(tracer):
        tracing.traced_dispatch("cpu.call", lambda: None, device="cpu")
    assert events.made == 3
    assert "device_ms" not in _one(tracer.finished, "cpu.call").attributes


def test_off_is_the_shared_noop_with_no_range_and_no_event(monkeypatch, rig):
    made = {"ranges": 0, "events": 0, "pairs": 0}

    class Range:
        def __init__(self, name):
            made["ranges"] += 1

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    real_pair = tracing._event_pair

    def pair(device):
        made["pairs"] += 1
        return real_pair(device)

    class Event:
        def __init__(self, *a, **k):
            made["events"] += 1

    monkeypatch.setattr(torch.profiler, "record_function", Range)
    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(tracing, "_event_pair", pair)
    assert tracing.active() is None
    assert tracing.span("a") is tracing.span("b") is tracing.span_if(True, "c")
    with tracing.span("a", device="cuda") as sp:
        sp.set_attribute("k", 1)
        sp.on_device(None, None)
    asyncio.run(rig.tick())
    inputs, B = _sweep_setup(n=200, B=3)
    _request(inputs, B)
    assert tracing.traced_dispatch("x", lambda: 5, device="cuda") == 5
    assert made == {"ranges": 0, "events": 0, "pairs": 0}
    # on, with profiler ranges: none while no profiler records, one a span
    # while one does
    tracer = _tracer(profiler_ranges=True)
    with tracing.use(tracer):
        _request(inputs, B)
    assert made["ranges"] == 0 and len(tracer.finished) == 3
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with tracing.use(tracer):
            _request(inputs, B)
    assert made["ranges"] == 3 and len(tracer.finished) == 6 and made["events"] == 0


def test_profiler_ranges_put_every_span_in_the_profiler_trace(rig, tmp_path):
    tracer = _tracer(profiler_ranges=True)
    inputs, B = _sweep_setup(n=200, B=3)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tracing.use(tracer):
            with tracing.span("tick"):
                asyncio.run(rig.tick())
            with tracing.span("request"):
                _request(inputs, B)
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        ranges = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    spans = list(tracer.finished)
    assert sorted(e["name"] for e in ranges) == sorted(s.name for s in spans)
    # nested as the spans nest: each range lies inside its parent's
    by_id = {s.span_id: s for s in spans}
    order = {}
    for e in sorted(ranges, key=lambda e: float(e["ts"])):
        order.setdefault(e["name"], []).append((float(e["ts"]), float(e["ts"]) + float(e["dur"])))
    seen = {}
    for s in sorted(spans, key=lambda s: s.start):
        seen[s.name] = seen.get(s.name, -1) + 1
        s.range = order[s.name][seen[s.name]]
    for s in spans:
        if s.parent_id is not None:
            (a, b), (pa, pb) = s.range, by_id[s.parent_id].range
            assert pa <= a and b <= pb, (s.name, by_id[s.parent_id].name)


@pytest.mark.parametrize("pipelined", [False, True])
def test_the_tick_engine_step_has_stage_dispatch_and_read(pipelined):
    """Serial: each step's three spans in order.  Pipelined: a step stages
    and dispatches tick T and reads tick T − 1 (none on the first step);
    `flush` reads the last."""
    from ai_crypto_trader_tpu_torch.ops.tick_engine import TickEngine

    d = generate_ohlcv(n=120, seed=4)
    kl = [[i * 60_000, *(float(d[k][i]) for k in ("open", "high", "low", "close", "volume"))]
          for i in range(120)]
    eng = TickEngine(["AAAUSDC"], ("1m",), window=32, pipelined=pipelined, device="cpu")
    tracer = _tracer()
    with tracing.use(tracer):
        for t in range(40, 43):
            eng.ingest("AAAUSDC", "1m", kl[:t])
            with tracing.span("step"):
                eng.step()
        with tracing.span("flush"):
            eng.flush()
    _, kids = _tree(list(tracer.finished))
    roots = kids[None]
    got = [[c.name for c in kids.get(r.span_id, [])] for r in roots]
    step = ["tick.stage", "tick.dispatch"]
    want = ([step + ["tick.read"]] * 3 + [[]] if not pipelined
            else [step] + [step + ["tick.read"]] * 2 + [["tick.read"]])
    assert got == want
    first = [s for s in tracer.finished if s.name == "tick.stage"][0]
    assert first.attributes["rows"] == 0 and first.attributes["bytes"] > 0   # the seed
