"""The port's trading system (`shell.launcher.TradingSystem`) against the
JAX package's, on the CPU.

Both systems run the same ticks on twin paper exchanges behind the
resilient adapter, on one virtual clock each, with `bench_recovery`'s
trading parameters (bench.py:974-975) so that trades open and close: three
symbols, a 256-candle window at 1m/3m/5m/15m, 30 ticks.  Held exactly:
each tick's return, `status()`, the trades, the journal, the structured
log and `portfolio_value_history`.  Held within the tick engine's bounds
(tests/test_torch_tick.py): the flight recorder's feature slices, the
metrics' feature PSI and the dashboard's numbers.  `risk_metrics` and the
correlation matrix within rtol 1e-5.  Wall-clock readings (durations, duty
cycles, loop lag) are not compared: the systems get a loop-lag probe on a
frozen clock and a tick budget no tick reaches, so the alerts that read
them fire in neither.  `build_info` is the one intended difference.
"""

import asyncio
import itertools
import json
import math
import re

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from ai_crypto_trader_tpu import config as jconfig  # noqa: E402
from ai_crypto_trader_tpu.data import ingest as jingest  # noqa: E402
from ai_crypto_trader_tpu.data.synthetic import generate_ohlcv  # noqa: E402
from ai_crypto_trader_tpu.obs import tickpath as jtickpath  # noqa: E402
from ai_crypto_trader_tpu.shell import exchange as jex  # noqa: E402
from ai_crypto_trader_tpu.shell import launcher as jlauncher  # noqa: E402
from ai_crypto_trader_tpu.shell import llm as jllm  # noqa: E402
from ai_crypto_trader_tpu.shell import scanner as jscanner  # noqa: E402
from ai_crypto_trader_tpu.utils import health as jhealth  # noqa: E402
from ai_crypto_trader_tpu.utils import tracing as jtracing  # noqa: E402
from ai_crypto_trader_tpu_torch import config as tconfig  # noqa: E402
from ai_crypto_trader_tpu_torch.data import ingest as tingest  # noqa: E402
from ai_crypto_trader_tpu_torch.obs import tickpath as ttickpath  # noqa: E402
from ai_crypto_trader_tpu_torch.shell import exchange as tex  # noqa: E402
from ai_crypto_trader_tpu_torch.shell import launcher as tlauncher  # noqa: E402
from ai_crypto_trader_tpu_torch.shell import llm as tllm  # noqa: E402
from ai_crypto_trader_tpu_torch.shell import scanner as tscanner  # noqa: E402
from ai_crypto_trader_tpu_torch.utils import health as thealth  # noqa: E402
from ai_crypto_trader_tpu_torch.utils import tracing as ttracing  # noqa: E402

SYMBOLS = ["AAAUSDC", "BBBUSDC", "CCCUSDC"]
HIST, TICKS = 3_850, 30              # every frame of the 256-candle window full
PKGS = {
    "jax": dict(config=jconfig, ingest=jingest, ex=jex, launcher=jlauncher, llm=jllm,
                health=jhealth, scanner=jscanner, tracing=jtracing, tickpath=jtickpath,
                kw={}),
    "port": dict(config=tconfig, ingest=tingest, ex=tex, launcher=tlauncher, llm=tllm,
                 health=thealth, scanner=tscanner, tracing=ttracing, tickpath=ttickpath,
                 kw={"device": "cpu"}),
}
# exposition families that read the wall clock (perf_counter)
WALL_FAMILIES = ("tick_duration_seconds", "stage_duty_cycle", "stage_busy_seconds_total",
                 "host_readback_share", "event_loop_lag_seconds", "tickpath_",
                 "span_duration_seconds", "bus_fanout", "kernel_build", "jit_compile",
                 "coldstart_")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def systems():
    """Every system a test builds is shut down afterwards, so no tracer or
    tick-path scope of either package outlives the test."""
    built = []
    yield built
    for s in built:
        s.shutdown()


def _ids():
    it = (f"d{i:05d}" for i in itertools.count(1))
    return lambda: next(it)


def build(pkg, tmp_path=None, systems=None, *, tag="", hist=HIST, ticks=TICKS, **kw):
    """A TradingSystem of ``pkg`` on its own paper exchange and virtual
    clock, with deterministic ids, model version, loop-lag clock and a
    tick budget no tick reaches."""
    p = PKGS[pkg]
    clock = [1_000.0]
    series = {}
    for k, s in enumerate(SYMBOLS):
        d = generate_ohlcv(n=hist + ticks + 10, seed=7 + k)
        series[s] = p["ingest"].OHLCV(
            timestamp=np.arange(len(d["close"]), dtype=np.int64) * 60_000,
            open=d["open"], high=d["high"], low=d["low"], close=d["close"],
            volume=d["volume"] * 1000, symbol=s)
    ex = p["ex"].make_exchange("fake", resilient=True, series=series, resilient_opts={
        "now_fn": lambda: clock[0], "sleep": lambda s: clock.__setitem__(0, clock[0] + s)})
    ex.advance(steps=hist)
    cfg = p["config"].FrameworkConfig(trading=p["config"].TradingParams(
        ai_confidence_threshold=0.0, min_signal_strength=0.0, min_trade_amount=1.0))
    if tmp_path is not None:
        base = tmp_path / f"{pkg}{tag}"
        kw = {"dashboard_path": f"{base}.html", "flightrec_path": f"{base}.decisions.jsonl",
              "journal_path": f"{base}.journal", "log_path": f"{base}.log", **kw}
    system = p["launcher"].TradingSystem(ex, list(SYMBOLS), config=cfg,
                                         now_fn=lambda: clock[0], tick_budget_s=1e9,
                                         **p["kw"], **kw)
    if systems is not None:
        systems.append(system)
    system.loop_lag = p["health"].EventLoopLagProbe(clock=lambda: 0.0)
    system.analyzer.trader = p["llm"].LLMTrader(model_version="v")
    system.flightrec._id_fn = _ids()
    return system, ex, clock


async def drive(system, ex, clock, ticks, hook=None):
    out = []
    for t in range(ticks):
        ex.advance()
        clock[0] += 60.0
        if hook is not None:
            hook(t)
        out.append(await system.tick())
    return out


def snapshot(system):
    ex = system.exchange
    return {"status": system.status(), "cached": system.status_cached(),
            "active": system.executor.snapshot_state()["active"],
            "closed": system.executor.closed_trades, "fills": ex.fills,
            "open_orders": ex.list_open_orders(),
            "pnl_attribution": system.bus.get("pnl_attribution"),
            "portfolio_value_history": system.bus.get("portfolio_value_history"),
            "var_history": system.bus.get("var_history"),
            "risk_metrics": system.bus.get("risk_metrics"),
            "correlation_matrix": system.bus.get("correlation_matrix"),
            "alerts_active": dict(system.alerts.active),
            "alerts_history": list(system.alerts.history),
            "heartbeats": system.heartbeats.health(),
            "breakers": {k: b.state() for k, b in system.stage_breakers.items()},
            "flightrec_status": {k: v for k, v in system.flightrec.status().items()
                                 if k != "journal"},         # the file's path
            "records": system.flightrec.query(limit=0),
            "exposition": system.metrics.exposition(),
            "channels": dict(system.bus.published_counts)}


def run_pair(tmp_path, systems, ticks=TICKS, hook_for=None, **kw):
    out = {}
    for pkg in ("jax", "port"):
        system, ex, clock = build(pkg, tmp_path, systems, ticks=ticks, **kw)
        hook = hook_for(pkg, system) if hook_for else None
        returns = asyncio.run(drive(system, ex, clock, ticks, hook))
        out[pkg] = {"returns": returns, **snapshot(system), "system": system}
        system.shutdown()
    return out["port"], out["jax"]


# --- tolerances -------------------------------------------------------------

_NUM = re.compile(r"-?\d[\d,]*(?:\.\d+)?(?:e[-+]?\d+)?")


def same_text(got, ref, rtol=1e-5):
    """Equal but for numbers, each within rtol or one unit of its last
    printed digit (a float32 ulp may round a printed digit the other way)."""
    g_parts, r_parts = _NUM.split(got), _NUM.split(ref)
    assert g_parts == r_parts
    for g, r in zip(_NUM.findall(got), _NUM.findall(ref)):
        if g == r:
            continue
        gv, rv = float(g.replace(",", "")), float(r.replace(",", ""))
        last = 10.0 ** -(len(r.split(".")[1]) if "." in r else 0)
        assert abs(gv - rv) <= rtol * abs(rv) + last, (g, r)


def feature_tol(key, feats):
    """(rtol, atol) of a decision record's feature against the JAX one: the
    bounds tests/test_torch_tick.py derives for the tick engine's fields."""
    close = abs(feats.get("current_price", 0.0))
    if key.startswith("macd"):
        return 2e-5, 1e-3 + 2e-6 * close
    if key == "signal_strength":
        return 1e-5, 1e-4 + (20 * (1e-3 + 2e-6 * close) if abs(feats.get("macd", 0)) < 1 else 0)
    if key in ("confluence", "top_family_score"):
        return 1e-5, 2e-3
    if key == "trend_strength":
        return 1e-5, 5e-5
    return 1e-5, 1e-6


def same_records(got, ref):
    """Flight-recorder records: equal but for the tick engine's floats in
    the feature slice (within `feature_tol`) and the numbers of the
    explanation's narrative (`same_text`)."""
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert set(g) == set(r)
        for k in r:
            if k == "features":
                assert set(g[k]) == set(r[k])
                for f, rv in r[k].items():
                    if isinstance(rv, float):
                        rtol, atol = feature_tol(f, r[k])
                        assert abs(g[k][f] - rv) <= atol + rtol * abs(rv), (f, g[k][f], rv)
                    else:
                        assert g[k][f] == rv, f
            elif k in ("explanation", "verdict") and r[k]:
                same_text(json.dumps(g[k], sort_keys=True), json.dumps(r[k], sort_keys=True))
            else:
                assert g[k] == r[k], k


def series_values(text):
    out = {}
    for line in text.splitlines():
        if line.startswith("#") or not line:
            continue
        name, value = line.rsplit(" ", 1)
        if any(f in name for f in WALL_FAMILIES):
            continue
        out[name] = float(value)
    return out


def same_exposition(got, ref):
    g, r = series_values(got), series_values(ref)
    assert set(g) == set(r), sorted(set(g) ^ set(r))[:10]
    for k, rv in r.items():
        if "feature_psi" in k or "portfolio_var_pct" in k:
            assert abs(g[k] - rv) <= 1e-6 + 1e-5 * abs(rv), k
        else:
            assert g[k] == rv or (math.isnan(g[k]) and math.isnan(rv)), (k, g[k], rv)


def close_dict(got, ref, rtol=1e-5, atol=0.0):
    assert set(got) == set(ref)
    for k, rv in ref.items():
        if isinstance(rv, float):
            assert abs(got[k] - rv) <= atol + rtol * abs(rv), (k, got[k], rv)
        else:
            assert got[k] == rv, k


# --- the main run -----------------------------------------------------------

@pytest.fixture(scope="module")
def main_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("launcher")
    built = []
    try:
        got, ref = run_pair(tmp, built)
    finally:
        for s in built:
            s.shutdown()
    return got, ref, tmp


def test_tick_returns_and_status_equal_jax(main_run):
    got, ref, _ = main_run
    assert got["returns"] == ref["returns"]
    assert got["status"] == ref["status"] and got["cached"] == ref["cached"]
    assert sum(r["executed"] for r in got["returns"]) > 0


def test_trades_equal_jax_and_a_trade_closes(main_run):
    got, ref, _ = main_run
    for k in ("active", "closed", "fills", "open_orders"):
        assert got[k] == ref[k], k
    assert got["closed"], "the window closes no trade: the closure path is untested"
    assert all(c["source"]["decision_id"] for c in got["closed"])


@pytest.mark.parametrize("key", ["pnl_attribution", "portfolio_value_history", "var_history",
                                 "alerts_active", "alerts_history", "heartbeats", "breakers",
                                 "flightrec_status", "channels"])
def test_bus_and_rim_state_equal_jax(main_run, key):
    got, ref, _ = main_run
    if key == "var_history":
        assert [h["t"] for h in got[key]] == [h["t"] for h in ref[key]]
        for g, r in zip(got[key], ref[key]):
            assert abs(g["var_95"] - r["var_95"]) <= 1e-5 * abs(r["var_95"])
    else:
        assert got[key] == ref[key]
    assert got[key]


def test_risk_metrics_and_correlation_within_rtol(main_run):
    got, ref, _ = main_run
    close_dict(got["risk_metrics"], ref["risk_metrics"])
    assert got["risk_metrics"]["n_assets"] == 3
    assert got["correlation_matrix"]["symbols"] == ref["correlation_matrix"]["symbols"]
    np.testing.assert_allclose(got["correlation_matrix"]["matrix"],
                               ref["correlation_matrix"]["matrix"], rtol=1e-5, atol=1e-6)


def test_metrics_exposition_equal_jax(main_run):
    got, ref, _ = main_run
    same_exposition(got["exposition"], ref["exposition"])
    assert "crypto_trader_tpu_portfolio_value_usd" in got["exposition"]


def test_flight_records_equal_jax(main_run):
    got, ref, _ = main_run
    same_records(got["records"], ref["records"])
    assert {r["status"] for r in got["records"]} >= {"vetoed", "closed"}


@pytest.mark.parametrize("suffix", [".journal", ".log"])
def test_journal_and_log_files_byte_equal(main_run, suffix):
    _, _, tmp = main_run
    with open(tmp / f"port{suffix}", "rb") as a, open(tmp / f"jax{suffix}", "rb") as b:
        port, jax = a.read(), b.read()
    assert port == jax and port


def test_flightrec_file_and_dashboard_equal_jax(main_run):
    from ai_crypto_trader_tpu.obs.flightrec import load_decisions as jload
    from ai_crypto_trader_tpu_torch.obs.flightrec import load_decisions as tload

    _, _, tmp = main_run
    got, gstats = tload(str(tmp / "port.decisions.jsonl"))
    ref, rstats = jload(str(tmp / "jax.decisions.jsonl"))
    assert gstats == rstats
    same_records(got, ref)
    # each package loads the other's file as its own
    cross, _ = jload(str(tmp / "port.decisions.jsonl"))
    assert cross == got
    with open(tmp / "port.html") as a, open(tmp / "jax.html") as b:
        same_text(a.read(), b.read())


def test_build_info_names_the_torch_runtime(main_run):
    got, ref, _ = main_run
    info = got["system"].build_info
    assert info["torch_version"] == torch.__version__
    assert info["backend"] == "cpu" and info["device_kind"] == "cpu"
    assert set(ref["system"].build_info) == {"process_start", "jax_version", "backend",
                                             "device_kind"}


# --- outage, stage quarantine, recovery -------------------------------------

def test_exchange_outage_ticks_equal_jax(tmp_path, systems):
    """Ticks 8-9: every kline fetch of the inner exchange fails, the
    resilient adapter gives up (ExchangeUnavailable) and its breaker opens;
    the system skips those ticks' stages and recovers after."""
    def hook_for(pkg, system):
        inner = system.exchange.inner
        real = type(inner).get_klines

        def hook(t):
            if t == 8:
                def down(*a, **kw):
                    raise ConnectionError("venue down")
                inner.get_klines = down
            elif t == 10:
                inner.get_klines = real.__get__(inner)
        return hook

    got, ref = run_pair(tmp_path, systems, ticks=16, hook_for=hook_for)
    assert got["returns"] == ref["returns"]
    assert [r.get("skipped") is not None for r in got["returns"]].count(True) >= 1
    for k in ("status", "closed", "fills", "alerts_history", "breakers", "channels"):
        assert got[k] == ref[k], k
    with open(tmp_path / "port.log") as a, open(tmp_path / "jax.log") as b:
        log = a.read()
        assert log == b.read()
    assert "exchange unavailable; tick skipped" in log
    same_exposition(got["exposition"], ref["exposition"])
    assert 'circuit_state{breaker="exchange"}' in got["exposition"]


def test_failing_stage_is_quarantined_as_jax(tmp_path, systems):
    """The analyzer raises on ticks 5-11: backoff, then quarantine after 3
    consecutive failures (ServiceCrashLoop), then recovery."""
    def hook_for(pkg, system):
        real = system.analyzer.run_once

        def hook(t):
            if t == 5:
                async def broken():
                    raise RuntimeError("analyzer bug")
                system.analyzer.run_once = broken
            elif t == 12:
                system.analyzer.run_once = real
        return hook

    got, ref = run_pair(tmp_path, systems, ticks=24, hook_for=hook_for)
    assert got["returns"] == ref["returns"]
    for k in ("status", "closed", "alerts_history", "breakers", "heartbeats", "channels",
              "flightrec_status"):
        assert got[k] == ref[k], k
    assert got["breakers"]["analyzer"]["total_failures"] >= 3
    with open(tmp_path / "port.log") as a, open(tmp_path / "jax.log") as b:
        log = a.read()
        assert log == b.read()
    assert "stage failure isolated" in log and "stage recovered from crash loop" in log
    same_exposition(got["exposition"], ref["exposition"])


@pytest.mark.parametrize("cut", [12, 21])
def test_recover_after_a_cut_equals_jax_and_the_unbroken_run(tmp_path, systems, cut):
    """A system dies after tick ``cut`` without shutdown (its journal's
    buffered tail lost); a new one on the same journal and exchange runs
    `recover()` and the remaining ticks.  Its books equal JAX's doing the
    same, and the unbroken run's."""
    out = {}
    for pkg in ("jax", "port"):
        a, ex, clock = build(pkg, tmp_path, systems, tag="cut")
        asyncio.run(drive(a, ex, clock, cut))
        a.journal.simulate_crash()
        p = PKGS[pkg]
        if p["tickpath"].active() is a.tickpath:
            p["tickpath"].disable()
        b = p["launcher"].TradingSystem(
            ex, list(SYMBOLS), config=a.config, now_fn=lambda: clock[0], tick_budget_s=1e9,
            journal_path=str(tmp_path / f"{pkg}cut.journal"), **p["kw"])
        systems.append(b)
        b.loop_lag = p["health"].EventLoopLagProbe(clock=lambda: 0.0)
        b.analyzer.trader = p["llm"].LLMTrader(model_version="v")
        b.flightrec._id_fn = _ids()
        report = asyncio.run(b.recover())
        rest = asyncio.run(drive(b, ex, clock, TICKS - cut))
        out[pkg] = {"report": {k: v for k, v in report.items() if k != "journal"},
                    "rest": rest, **snapshot(b)}
    got, ref = out["port"], out["jax"]
    assert got["report"] == ref["report"]
    assert got["rest"] == ref["rest"]
    for k in ("status", "active", "closed", "fills", "open_orders"):
        assert got[k] == ref[k], k
    whole, _ = _unbroken_port(tmp_path, systems)
    for k in ("fills", "open_orders"):
        assert got[k] == whole[k], k
    # the new system's flight recorder numbers its decisions afresh
    assert _no_decision_ids(got["active"]) == _no_decision_ids(whole["active"])
    assert _no_decision_ids(got["closed"]) == _no_decision_ids(whole["closed"])
    assert got["closed"] and got["report"]["replayed_records"] > 0


def _no_decision_ids(trades):
    items = trades.items() if isinstance(trades, dict) else enumerate(trades)
    return {k: {**t, "source": {**(t.get("source") or {}), "decision_id": None}}
            for k, t in items}


def _unbroken_port(tmp_path, systems):
    system, ex, clock = build("port", tmp_path, systems, tag="whole")
    asyncio.run(drive(system, ex, clock, TICKS))
    return snapshot(system), system


# --- construction modes and the process-wide hooks --------------------------

def test_with_discovery_builds_on_the_scanned_universe(systems):
    chosen = {}
    for pkg in ("jax", "port"):
        p = PKGS[pkg]
        system, ex, _ = build(pkg, None, systems)
        scanner = p["scanner"].MarketScanner(ex.inner, lookback=64, top_k=2, min_quote_volume=0.0,
                                             min_volatility=0.0, **p["kw"])
        found = p["launcher"].TradingSystem.with_discovery(
            ex, scanner=scanner, now_fn=lambda: 0.0, **p["kw"])
        systems.append(found)
        chosen[pkg] = (found.symbols, found.scanner is scanner)
    assert chosen["port"] == chosen["jax"] and len(chosen["port"][0]) == 2


def test_shutdown_releases_the_tracer_and_tickpath(tmp_path, systems):
    system, ex, clock = build("port", tmp_path, systems, tag="traced",
                              trace_jsonl=str(tmp_path / "spans.jsonl"))
    assert ttracing.active() is system.tracer and ttickpath.active() is system.tickpath
    asyncio.run(drive(system, ex, clock, 2))
    later, _, _ = build("port", None, systems)
    assert ttickpath.active() is later.tickpath
    system.shutdown()
    assert ttracing.active() is None                # its own tracer went
    assert ttickpath.active() is later.tickpath     # a later system's stays
    later.shutdown()
    assert ttickpath.active() is None
    spans = ttracing.read_jsonl(str(tmp_path / "spans.jsonl"))
    assert "tick" in {s.name for s in spans}


def test_device_none_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ex = tex.FakeExchange({})
    with pytest.raises(RuntimeError):
        tlauncher.TradingSystem(ex, ["BTCUSDC"])
    with pytest.raises(RuntimeError):
        tlauncher.TradingSystem(ex, ["BTCUSDC"], device="cuda")


@pytest.mark.parametrize("option", [{"enable_devprof": True}, {"enable_meshprof": True},
                                    {"aot_cache_dir": "cache"}])
def test_options_not_ported_raise(option):
    ex = tex.FakeExchange({})
    with pytest.raises(NotImplementedError, match="ROADMAP item 16"):
        tlauncher.TradingSystem(ex, ["BTCUSDC"], device="cpu", **option)
    assert ttickpath.active() is None


def test_attach_stream_raises_and_other_attachments_work(systems):
    """`attach_stream` registers a stream supervisor as the market-data
    stage (it raised before shell/stream was ported); an object that is
    not a supervisor still raises."""
    from ai_crypto_trader_tpu_torch.shell.stream import MarketStream, StreamSupervisor

    system, _, _ = build("port", None, systems)
    with pytest.raises(AttributeError):
        system.attach_stream(object())
    sup = StreamSupervisor(MarketStream(system.monitor, now_fn=system.now_fn),
                           now_fn=system.now_fn)
    system.attach_stream(sup)
    assert system.stream is sup and sup.bus is system.bus and sup.metrics is system.metrics
    assert "stream" in system.stage_breakers and "stream" in system.heartbeats.expected
    assert system._alert_state()["stream_degraded"] is True

    class Trainer:
        name = "trainer"
        metrics = None

        async def run_once(self):
            return 1

    system.attach_trainer(Trainer())
    assert "trainer" in system.stage_breakers and system.extra_services[-1].metrics is \
        system.metrics
    assert system.fleet_checkpoint() is None
