"""The port's tracing, tick-path observatory and metrics against the JAX
package's, on the CPU.

    utils.tracing (spans, context propagation, JSONL, traced_dispatch and
    the kernel-build monitor) · obs.tickpath (phase waterfall, bottleneck,
    overlap, event age, cold-start ledger) · utils.metrics (exposition) ·
    utils.devprof (SlidingQuantiles, percentile) · the seams that feed them:
    the tick engine's phases, the backtest engine's and the prediction
    service's traced entries

Host code, held exactly: the same calls give the same spans (ids from an
injected ``id_fn``, times from an injected clock), the same observatory
status and the same exposition text, byte for byte.  Excluded, where said:
``perf_counter`` durations (``total_s``, ``execute_s``) and the JAX
monitor's XLA compile counters, which have no counterpart in the port.
"""

import itertools
import json

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from ai_crypto_trader_tpu.obs import tickpath as jtickpath  # noqa: E402
from ai_crypto_trader_tpu.utils import devprof as jdevprof  # noqa: E402
from ai_crypto_trader_tpu.utils import metrics as jmetrics  # noqa: E402
from ai_crypto_trader_tpu.utils import tracing as jtracing  # noqa: E402
from ai_crypto_trader_tpu_torch.obs import tickpath as ttickpath  # noqa: E402
from ai_crypto_trader_tpu_torch.ops import _cuda  # noqa: E402
from ai_crypto_trader_tpu_torch.utils import devprof as tdevprof  # noqa: E402
from ai_crypto_trader_tpu_torch.utils import metrics as tmetrics  # noqa: E402
from ai_crypto_trader_tpu_torch.utils import tracing as ttracing  # noqa: E402

PKGS = {"jax": (jtracing, jmetrics, jtickpath), "port": (ttracing, tmetrics, ttickpath)}


class Clock:
    def __init__(self, t=100.0, step=0.25):
        self.t, self.step = t, step

    def __call__(self):
        self.t += self.step
        return self.t


def _ids():
    it = (f"{i:016x}" for i in itertools.count(1))
    return lambda: next(it)


def _span_script(tracing_mod, metrics_mod, path):
    reg = metrics_mod.MetricsRegistry(now_fn=Clock())
    tracer = tracing_mod.Tracer(service="svc", now_fn=Clock(), ring_size=8,
                                jsonl_path=path, metrics=reg, id_fn=_ids())
    assert tracing_mod.span("off") is tracing_mod.span("off too")  # shared no-op
    assert tracing_mod.inject() is None and tracing_mod.current() is None
    with tracing_mod.use(tracer):
        with tracing_mod.span("root", attributes={"a": 1}) as root:
            root.add_event("e", ts=1.0, k="v")
            carrier = tracing_mod.inject()
            with tracing_mod.span("child", service="other"):
                assert tracing_mod.current().name == "child"
        with tracing_mod.consumer_span({"trace": carrier}, "consumer"):
            pass
        with tracing_mod.consumer_span({}, "fresh"):
            pass
        with pytest.raises(KeyError):
            with tracing_mod.span("fails"):
                raise KeyError("x")
        for i in range(8):                          # the ring keeps 8
            with tracing_mod.span(f"s{i}"):
                pass
    tracer.close()
    spans = [s.to_dict() for s in tracer.finished]
    return (spans, tracer.traces(limit=3), [s.to_dict() for s in tracing_mod.read_jsonl(path)],
            reg.exposition())


def test_spans_traces_and_jsonl_match_jax(tmp_path):
    got = {pkg: _span_script(t, m, str(tmp_path / f"{pkg}.jsonl"))
           for pkg, (t, m, _) in PKGS.items()}
    assert got["port"] == got["jax"]
    spans = got["port"][0]
    assert any(s["status"] == "error" for s in got["port"][2])
    assert len(spans) == 8 and len(got["port"][2]) == 13
    sp = ttracing.Span.from_dict(got["port"][2][0])
    assert sp.to_dict() == got["port"][2][0] and sp.duration == sp.end - sp.start


def _metrics_script(metrics_mod):
    t = [0.0]
    reg = metrics_mod.MetricsRegistry(namespace="ns", now_fn=lambda: t[0],
                                      max_series_per_metric=3)
    for i in range(5):
        reg.inc("trades_executed_total", symbol=f"S{i}")
        reg.set_gauge("portfolio_value_usd", 1000.0 + i, desc='q"uo\\te\n')
        reg.observe("request_latency_seconds", 10.0 ** -(i + 1), stage="a")
    reg.inc("trades_executed_total", 2.5, symbol="S0")
    with reg.measure_time("tick_seconds", kind="x"):
        t[0] += 0.003
    return reg.exposition(), metrics_mod.channel_family("trading_signals.42"), \
        metrics_mod.channel_family("alerts"), metrics_mod.escape_label_value('a"b\\c\nd')


def test_metrics_exposition_is_byte_equal():
    assert _metrics_script(tmetrics) == _metrics_script(jmetrics)
    text = _metrics_script(tmetrics)[0]
    assert "metric_cardinality_dropped_total" in text and "# TYPE" in text


def _tickpath_script(tickpath_mod, metrics_mod):
    reg = metrics_mod.MetricsRegistry(now_fn=Clock())
    tp = tickpath_mod.TickPathScope(metrics=reg, window=16, min_samples=4)
    rng = np.random.default_rng(0)
    with tickpath_mod.use(tp):
        assert tickpath_mod.active() is tp
        for i in range(24):
            for phase in tickpath_mod.PHASES[1:]:
                tickpath_mod.observe_phase(phase, float(rng.uniform(0, 1e-3)))
            tickpath_mod.observe_overlap(float(rng.uniform(-1e-4, 1e-3)))
            tickpath_mod.observe_reclaimed(float(rng.uniform(0, 1e-3)))
            tickpath_mod.observe_event_age(float(rng.uniform(-5, 50)))
        tp.observe_phase("frame_wait", -1.0)
        tp.inject_delay("publish", 0.5)
        tickpath_mod.observe_phase("publish", 0.0)
        tp.record_cold_start("tick_engine", wall_s=1.5, compile_s=1.25, compiles=2,
                             cache_hits=1)
        tp.record_cold_start("tick_engine", wall_s=9.0, compile_s=9.0, compiles=9)
        tp.export()
    status = tp.status()
    cold = tp.coldstart_status()
    for e in cold["programs"].values():
        e.pop("t")                                 # wall clock of the record
    return (status, tp.alert_state(), tp.bottleneck(), cold, reg.exposition(),
            tickpath_mod.observe_event_age(1.0), tickpath_mod.coldstart("x") is not None)


@pytest.fixture
def no_tickpath_scope():
    """Both packages' scripts start from the same global state: no active
    `TickPathScope` in either module.  A trading system of either package
    configures one process-wide and only its `shutdown()` releases it, so a
    test elsewhere in the process may leave one set; the scopes found are
    put back afterwards."""
    saved = {mod: mod.active() for mod in (jtickpath, ttickpath)}
    for mod in saved:
        mod.disable()
    yield
    for mod, scope in saved.items():
        if scope is None:
            mod.disable()
        else:
            mod.configure(scope)


def test_tickpath_scope_matches_jax(no_tickpath_scope):
    got = {pkg: _tickpath_script(tp_mod, m) for pkg, (_, m, tp_mod) in PKGS.items()}
    assert got["port"] == got["jax"]
    assert got["port"][2] == "publish"             # the drill names the bottleneck
    assert tdevprof.percentile([3.0, 1.0, 2.0], 50) == jdevprof.percentile([3.0, 1.0, 2.0], 50)
    q, jq = tdevprof.SlidingQuantiles(window=4), jdevprof.SlidingQuantiles(window=4)
    for v in (5.0, 1.0, 4.0, 2.0, 3.0):
        q.observe(v)
        jq.observe(v)
    assert (q.summary(), q.frac_over(2.5)) == (jq.summary(), jq.frac_over(2.5))


def test_kernel_build_monitor_counts_builds_and_hits(monkeypatch):
    reg = tmetrics.MetricsRegistry(now_fn=Clock())
    mon = ttracing.KernelBuildMonitor.install(metrics=reg)
    assert ttracing.KernelBuildMonitor.install() is mon
    assert mon._on_build in _cuda.BUILD_LISTENERS
    before = mon.sample()
    for listener in _cuda.BUILD_LISTENERS:         # what ops._cuda.build reports
        listener("fused_ewma", 2.5, False)
        listener("replay_sweep", 0.0, True)
    d = mon.since(before)
    assert d == {"compile_s": 2.5, "compiles": 1, "trace_s": 0.0, "cache_hits": 1,
                 "cache_misses": 1}
    assert "crypto_trader_tpu_kernel_build_seconds_count 1" in reg.exposition()
    # the cold-start window samples the same monitor
    tp = ttickpath.TickPathScope()
    with tp.coldstart("prog"):
        for listener in _cuda.BUILD_LISTENERS:
            listener("fused_ewma", 1.0, False)
    entry = tp.coldstart_status()["programs"]["prog"]
    assert entry["compile_ms"] == 1000.0 and entry["compiles"] == 1


def test_traced_dispatch_is_the_plain_call_when_off_and_a_span_when_on():
    calls = []
    assert ttracing.traced_dispatch("x", lambda: calls.append(1) or 7) == 7
    tracer = ttracing.Tracer(now_fn=Clock(), id_fn=_ids())
    with ttracing.use(tracer):
        out = ttracing.traced_dispatch("model.predict", lambda: {"y": torch.ones(3)},
                                       service="nn", attrs_fn=lambda: {"symbol": "BTCUSDC"})
    assert torch.equal(out["y"], torch.ones(3))
    (sp,) = tracer.finished
    assert sp.name == "model.predict" and sp.service == "nn"
    # total_s and execute_s are perf_counter durations: checked for presence
    assert {"symbol", "total_s", "compile_s", "compiles", "execute_s", "cache_hits",
            "cache_misses"} <= set(sp.attributes)
    assert sp.attributes["compiles"] == 0


def test_backtest_entries_open_spans_only_when_tracing(monkeypatch):
    from ai_crypto_trader_tpu_torch.backtest import (default_params, prepare_inputs,
                                                     run_backtest, sweep)
    from ai_crypto_trader_tpu_torch.backtest.strategy import StrategyParams
    from ai_crypto_trader_tpu_torch.data import generate_ohlcv
    from ai_crypto_trader_tpu_torch.ops import compute_indicators

    d = {k: v for k, v in generate_ohlcv(n=300, seed=1).items() if k != "regime"}
    inputs = prepare_inputs(compute_indicators(d, device="cpu"), device="cpu")
    params = default_params(device="cpu")
    pop = StrategyParams(*(torch.stack([p, p]) for p in params))
    plain = run_backtest(inputs, params, device="cpu")
    tracer = ttracing.Tracer(now_fn=Clock(), id_fn=_ids())
    with ttracing.use(tracer):
        traced = run_backtest(inputs, params, device="cpu")
        swept = sweep(inputs, pop, device="cpu")
    assert [s.name for s in tracer.finished] == ["backtest.run", "backtest.sweep"]
    assert tracer.finished[0].attributes["candles"] == 300
    assert tracer.finished[1].attributes["population"] == 2
    for a, b in zip(plain, traced):
        assert torch.equal(a, b)
    assert swept.total_trades.shape == (2,)


def test_tick_engine_feeds_tickpath_phases():
    """The port's TickEngine reports the JAX step's phases while tickpath
    is on.  The CPU has no timing events: device_compute is 0 in the serial
    step there, and the drain's residual wait in the pipelined one."""
    from ai_crypto_trader_tpu_torch.data import generate_ohlcv
    from ai_crypto_trader_tpu_torch.ops.tick_engine import TickEngine

    d = generate_ohlcv(n=200, seed=2)
    kl = [[i * 60_000, *(float(d[k][i]) for k in ("open", "high", "low", "close", "volume"))]
          for i in range(200)]
    for pipelined in (False, True):
        tp = ttickpath.TickPathScope()
        eng = TickEngine(["BTCUSDC"], ("1m",), window=64, pipelined=pipelined, device="cpu")
        with ttickpath.use(tp):
            for t in range(70, 74):
                eng.ingest("BTCUSDC", "1m", kl[:t])
                eng.step()
            eng.flush()
        st = tp.status()
        n = 4
        counts = {p: st["phases"][p]["count"] for p in
                  ("scatter_build", "dispatch", "device_compute", "host_read")}
        assert counts == {"scatter_build": n, "dispatch": n, "device_compute": n,
                          "host_read": n}, (pipelined, counts)
        if not pipelined:                          # no events, no wait: 0
            assert st["phases"]["device_compute"]["p99_ms"] == 0.0
        assert "tick_engine" in tp.coldstart_status()["programs"]
        keys = {"scatter_build_s", "dispatch_s", "device_compute_s", "overlap_headroom_s"}
        assert keys <= set(eng.last_stats)
        if pipelined:
            assert tp.reclaimed.count == n
    # off: the JAX serial step's keys only
    eng = TickEngine(["BTCUSDC"], ("1m",), window=64, device="cpu")
    eng.ingest("BTCUSDC", "1m", kl[:70])
    eng.step()
    assert "device_compute_s" not in eng.last_stats
    json.dumps(eng.last_stats)
