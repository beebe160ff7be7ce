"""The trading system's observability rim in the port against the JAX
package's, on the CPU.

    config (`load_config`, `FrameworkConfig`) · utils.structlog ·
    utils.supervision (`StageBreaker`) · utils.health (`HeartbeatRegistry`,
    `EventLoopLagProbe`, `device_liveness`, `resume_or_init`) ·
    utils.alerts (`default_rules`, `AlertManager`) · utils.saturation (with
    the tick engine's `last_stats`) · obs.attribution · shell.dashboard

Host code, held exactly: the same calls on the same injected clocks give
the same objects, log lines, exposition text and HTML, byte for byte.
"""

import asyncio
import dataclasses
import itertools
import json
import os

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from ai_crypto_trader_tpu import config as jconfig  # noqa: E402
from ai_crypto_trader_tpu.obs import attribution as jattr  # noqa: E402
from ai_crypto_trader_tpu.ops.tick_engine import TickEngine as JTickEngine  # noqa: E402
from ai_crypto_trader_tpu.shell import bus as jbus  # noqa: E402
from ai_crypto_trader_tpu.shell import dashboard as jdash  # noqa: E402
from ai_crypto_trader_tpu.utils import alerts as jalerts  # noqa: E402
from ai_crypto_trader_tpu.utils import health as jhealth  # noqa: E402
from ai_crypto_trader_tpu.utils import metrics as jmetrics  # noqa: E402
from ai_crypto_trader_tpu.utils import saturation as jsat  # noqa: E402
from ai_crypto_trader_tpu.utils import structlog as jlog  # noqa: E402
from ai_crypto_trader_tpu.utils import supervision as jsup  # noqa: E402
from ai_crypto_trader_tpu.utils import tracing as jtracing  # noqa: E402
from ai_crypto_trader_tpu_torch import config as tconfig  # noqa: E402
from ai_crypto_trader_tpu_torch.data import generate_ohlcv  # noqa: E402
from ai_crypto_trader_tpu_torch.obs import attribution as tattr  # noqa: E402
from ai_crypto_trader_tpu_torch.ops.tick_engine import TickEngine as TTickEngine  # noqa: E402
from ai_crypto_trader_tpu_torch.shell import bus as tbus  # noqa: E402
from ai_crypto_trader_tpu_torch.shell import dashboard as tdash  # noqa: E402
from ai_crypto_trader_tpu_torch.utils import alerts as talerts  # noqa: E402
from ai_crypto_trader_tpu_torch.utils import health as thealth  # noqa: E402
from ai_crypto_trader_tpu_torch.utils import metrics as tmetrics  # noqa: E402
from ai_crypto_trader_tpu_torch.utils import saturation as tsat  # noqa: E402
from ai_crypto_trader_tpu_torch.utils import structlog as tlog  # noqa: E402
from ai_crypto_trader_tpu_torch.utils import supervision as tsup  # noqa: E402
from ai_crypto_trader_tpu_torch.utils import tracing as ttracing  # noqa: E402
from ai_crypto_trader_tpu_torch.utils.checkpoint import save_checkpoint  # noqa: E402

PKGS = {
    "jax": dict(config=jconfig, log=jlog, sup=jsup, health=jhealth, alerts=jalerts,
                sat=jsat, attr=jattr, dash=jdash, bus=jbus, metrics=jmetrics,
                tracing=jtracing),
    "port": dict(config=tconfig, log=tlog, sup=tsup, health=thealth, alerts=talerts,
                 sat=tsat, attr=tattr, dash=tdash, bus=tbus, metrics=tmetrics,
                 tracing=ttracing),
}


class Clock:
    def __init__(self, t=1_000.0, step=0.5):
        self.t, self.step = t, step

    def __call__(self):
        self.t += self.step
        return self.t


def _ids():
    it = (f"{i:016x}" for i in itertools.count(1))
    return lambda: next(it)


def both(fn):
    out = {pkg: fn(**mods) for pkg, mods in PKGS.items()}
    return out["port"], out["jax"]


# --- config -----------------------------------------------------------------

_CONFIG_FILE = {
    "trading": {"stop_loss_pct": 1.5, "max_positions": 3, "candle_interval": "5m"},
    "risk": {"max_drawdown_limit": 0.2, "trailing_stop": {"trail_percent": 1},
             "social": {"sentiment_weights": {"twitter_sentiment": 0.5}}},
    "monte_carlo": {"scenarios": {"base": [1.0, 1.0]}},
    "rl": {"hidden_sizes": [32, 32]},
    "regime": {"n_regimes": 3},
    "mesh": {"data_parallel": 2},
    "backtest": {"annualization": 365},
    "llm": {"model": "rule"},
    "seed": 7,
    "not_a_section": {"ignored": True},
}

_OVERRIDES = [
    {},
    {"trading.stop_loss_pct": 3.0},
    {"risk.trailing_stop.strategy": "atr_based", "nn.epochs": 4},
    {"risk.social.sentiment_weights.twitter_sentiment": 0.4},
    {"monte_carlo.scenarios.base": (2.0, 0.5), "evolution.ga.generations": 3},
]


@pytest.mark.parametrize("overrides", _OVERRIDES)
def test_load_config_matches_jax(tmp_path, overrides):
    path = tmp_path / "config.json"
    path.write_text(json.dumps(_CONFIG_FILE))

    def load(config, **_):
        return dataclasses.asdict(config.load_config(str(path), overrides=overrides))

    got, ref = both(load)
    assert got == ref
    assert got["trading"]["stop_loss_pct"] == overrides.get("trading.stop_loss_pct", 1.5)
    assert {f.name for f in dataclasses.fields(tconfig.FrameworkConfig)} == \
        {f.name for f in dataclasses.fields(jconfig.FrameworkConfig)}
    assert dataclasses.asdict(tconfig.FrameworkConfig()) == \
        dataclasses.asdict(jconfig.FrameworkConfig())


@pytest.mark.parametrize("bad", [
    ({"trading": {"max_positions": 2.5}}, None),
    ({"trading": {"stop_loss_pct": "2"}}, None),
    ({"risk": {"adaptive_stop_loss_enabled": 1}}, None),
    ({}, {"risk.social.sentiment_weights.unknown": 1.0}),
    ({}, {"trading.no_such_field": 1.0}),
])
def test_load_config_raises_as_jax(tmp_path, bad):
    data, overrides = bad
    path = tmp_path / "config.json"
    path.write_text(json.dumps(data))
    errors = {}
    for pkg, mods in PKGS.items():
        with pytest.raises((TypeError, KeyError)) as exc:
            mods["config"].load_config(str(path), overrides=overrides)
        errors[pkg] = (type(exc.value), str(exc.value))
    assert errors["port"] == errors["jax"]


# --- structured log ---------------------------------------------------------

def _log_script(log, tracing, path, **_):
    logger = log.StructuredLogger("svc", path=str(path), now_fn=Clock(), max_bytes=700,
                                  backup_count=2)
    child = logger.child("bus")
    logger.info("started", symbols=["A", "B"], n=3)
    logger.debug("hidden")                      # below min_level
    child.warning("slow subscriber", channel="market_updates", lag_s=0.25)
    tracer = tracing.Tracer(service="svc", now_fn=Clock(), id_fn=_ids())
    with tracing.use(tracer):
        with tracing.span("tick"):
            logger.error("inside a span", value=float("nan"), obj=object.__new__(Clock))
            child.child("exec").info("grandchild", t=(1, 2))
    logger.info("explicit trace", trace_id="given")
    for i in range(4):
        logger.info("rotate", i=i, pad="x" * 40)
    logger._fh.close()
    out = []
    for suffix in ("", ".1", ".2"):
        if os.path.exists(f"{path}{suffix}"):
            with open(f"{path}{suffix}") as f:
                out.append(f.read())
    assert len(out) >= 2                       # the file rotated
    return out


def test_structured_log_lines_are_byte_equal(tmp_path):
    got = _log_script(path=tmp_path / "port.log", **PKGS["port"])
    ref = _log_script(path=tmp_path / "jax.log", **PKGS["jax"])
    # the object's repr carries its address; everything else is the same
    def strip(text):
        return [{k: v for k, v in json.loads(line).items() if k != "obj"}
                for line in text.splitlines()]
    assert [strip(t) for t in got] == [strip(t) for t in ref]
    assert [t.replace(" ", "") for t in got[0:1]] == [t.replace(" ", "") for t in ref[0:1]]
    lines = [json.loads(line) for t in got for line in t.splitlines()]
    assert any(r.get("trace_id") == "0000000000000001" for r in lines)


def test_structured_log_stderr_lines(capsys):
    for pkg in ("port", "jax"):
        logger = PKGS[pkg]["log"].StructuredLogger("svc", now_fn=Clock())
        logger.warning("to stderr", k=1)
        logger.child("c").info("child", v=[1.5])
    err = capsys.readouterr().err.splitlines()
    assert err[:2] == err[2:] and len(err) == 4


# --- supervision ------------------------------------------------------------

@pytest.mark.parametrize("max_failures,outcomes", [
    (3, "FFFFSFF"),
    (1, "FSFFS"),
    (2, "FSFFFFSS"),
])
def test_stage_breaker_transitions_match_jax(max_failures, outcomes):
    def script(sup, **_):
        br = sup.StageBreaker("monitor", max_failures=max_failures, base_backoff_s=2.0,
                              max_backoff_s=5.0, quarantine_s=30.0)
        now, trace = 0.0, []
        for o in outcomes:
            while not br.should_run(now):
                now += 1.0
            edge = (br.record_failure(now, error=f"e{now}") if o == "F"
                    else br.record_success(now))
            trace.append((now, edge, br.state(), br.quarantined_at, br._retry_at))
        return trace

    got, ref = both(script)
    assert got == ref


# --- health -----------------------------------------------------------------

def test_heartbeats_health_and_staleness_match_jax(tmp_path):
    def script(health, log, **_):
        clock = [0.0]
        logger = log.StructuredLogger("health", path=str(tmp_path / f"{id(health)}.log"),
                                      now_fn=lambda: clock[0])
        reg = health.HeartbeatRegistry(stale_after_s=10.0, stale_after={"slow": 100.0},
                                       now_fn=lambda: clock[0], log=logger)
        for name in ("monitor", "analyzer", "slow"):
            reg.expect(name)
        trace = []
        for t, beats in ((1, ["monitor"]), (5, ["monitor", "slow"]), (12, []),
                         (18, ["analyzer"]), (40, ["monitor"]), (130, [])):
            clock[0] = float(t)
            for b in beats:
                reg.beat(b)
            trace.append((reg.health(), reg.staleness(), sorted(reg.stale())))
        logger._fh.close()
        with open(logger.path) as f:
            return trace, f.read()

    got, ref = both(script)
    assert got == ref
    assert "service went stale" in got[1] and "service recovered" in got[1]


def test_event_loop_lag_probe_matches_jax():
    def script(health, **_):
        t = [0.0]
        probe = health.EventLoopLagProbe(clock=lambda: t[0])
        assert probe.sample() == 0.0                # no loop running: a no-op

        async def drive():
            out = []
            for dt in (0.5, 0.0, 1.25, 0.1):
                out.append(probe.sample())
                probe.sample()                      # in flight: no second one
                t[0] += dt
                await asyncio.sleep(0)
            probe.reset()
            out.append(probe.sample())
            t[0] += 0.2
            await asyncio.sleep(0)
            return out

        out = asyncio.run(drive())
        return out, probe.last_lag_s, probe.max_lag_s, probe.samples

    got, ref = both(script)
    assert got == ref and abs(got[2] - 0.2) < 1e-12


def test_device_liveness_on_the_cpu_and_without_a_card(monkeypatch):
    assert thealth.device_liveness("cpu") == {"cpu": True}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        thealth.device_liveness()


def test_resume_or_init_loads_the_port_checkpoint(tmp_path):
    path = str(tmp_path / "ckpt")
    state, meta, resumed = thealth.resume_or_init(path, lambda: {"w": torch.zeros(2)},
                                                  device="cpu")
    assert not resumed and meta == {} and torch.equal(state["w"], torch.zeros(2))
    save_checkpoint(path, {"w": torch.arange(3.0)}, {"step": 4})
    state, meta, resumed = thealth.resume_or_init(path, lambda: None, device="cpu")
    assert resumed and meta == {"step": 4} and torch.equal(state["w"], torch.arange(3.0))


# --- alerts -----------------------------------------------------------------

_ALERT_STATES = [
    {},
    {"service_health": {"monitor": False, "analyzer": True}, "market_data_age_s": 400.0},
    {"open_positions": 5, "max_positions": 5, "ai_confidence": 0.2,
     "social_sentiment": 0.97, "error_rate": 0.2},
    {"crash_looped_services": ["executor"], "saturated_stages": ["monitor"],
     "bus_backpressure_channels": ["alerts"], "event_loop_lag_s": 0.5},
    {"slo_burn_rates": {"tick": 20.0}, "donation_failures": ["x"],
     "event_age_p99_ms": 3000.0, "feature_psi_max": 0.4, "portfolio_var_pct": 12.0},
    {"drawdown_pct": 30.0, "model_hit_rate_min": 0.2, "model_brier_max": 0.6,
     "stream_degraded": True, "depth_journal_exhausted": True},
    {"service_health": {"monitor": True}, "market_data_age_s": 1.0, "ai_confidence": 0.9},
    {},
]


def test_alert_rules_and_manager_match_jax():
    def script(alerts, **_):
        rules = alerts.default_rules()
        mgr = alerts.AlertManager(now_fn=Clock())
        trace = [[(r.name, r.severity, r.description) for r in rules]]
        for state in _ALERT_STATES:
            fired = mgr.evaluate(state)
            trace.append((fired, sorted(mgr.active)))
        trace.append(mgr.history)
        return trace

    got, ref = both(script)
    assert got == ref
    assert len(got[0]) >= 15 and any(fired for fired, _ in got[1:-1])


@pytest.mark.parametrize("i", range(len(_ALERT_STATES)))
def test_each_rule_fires_on_the_same_state(i):
    state = _ALERT_STATES[i]

    def hits(alerts, **_):
        out = []
        for rule in alerts.default_rules():
            try:
                out.append((rule.name, bool(rule.predicate(state))))
            except Exception as exc:               # noqa: BLE001 — the manager skips these
                out.append((rule.name, type(exc).__name__))
        return out

    got, ref = both(hits)
    assert got == ref


# --- saturation and the tick engine's stats ---------------------------------

def _klines(n, seed=2):
    d = generate_ohlcv(n=n, seed=seed)
    return [[i * 60_000, *(float(d[k][i]) for k in ("open", "high", "low", "close", "volume"))]
            for i in range(n)]


@pytest.mark.parametrize("pipelined", [False, True])
def test_tick_engine_last_stats_keys_match_jax(pipelined):
    """`utils.saturation` reads `host_read_s`, `scatter_capacity` and
    `upload_rows` from the engine's `last_stats`: every key the JAX engine
    carries, the port's carries too, step by step (the pipeline's fill step
    included)."""
    kl = _klines(120)
    engines = {"jax": JTickEngine(["BTCUSDC"], ("1m",), window=64, pipelined=pipelined),
               "port": TTickEngine(["BTCUSDC"], ("1m",), window=64, pipelined=pipelined,
                                   device="cpu")}
    keys = {"jax": [], "port": []}
    for t in range(70, 75):
        for pkg, eng in engines.items():
            eng.ingest("BTCUSDC", "1m", kl[:t])
            eng.step()
            keys[pkg].append(sorted(eng.last_stats))
            assert isinstance(eng.last_stats["host_read_s"], float)
    assert keys["port"] == keys["jax"]
    needed = {"host_read_s", "scatter_capacity", "upload_rows"}
    assert all(needed <= set(k) for k in keys["port"])
    for pkg, eng in engines.items():
        sat = PKGS[pkg]["sat"].SaturationMonitor()
        sat.close_tick(0.5, engine_stats=eng.last_stats)
        assert 0.0 < sat.scatter_occupancy() <= 1.0
        assert sat.host_read_share() > 0.0 or eng.last_stats["host_read_s"] == 0.0


def test_saturation_monitor_exposition_matches_jax():
    stats_seq = [
        {"dispatches": 1, "upload_rows": 3, "upload_bytes": 60, "full_seed": False,
         "lanes": 4, "valid_lanes": 4, "scatter_capacity": 32, "host_read_s": 0.125,
         "step_s": 0.25},
        None,
        {"dispatches": 1, "upload_rows": 40, "upload_bytes": 800, "full_seed": True,
         "lanes": 4, "valid_lanes": 2, "scatter_capacity": 32, "host_read_s": 0.5,
         "step_s": 0.75},
    ]

    def script(sat, metrics, bus, **_):
        reg = metrics.MetricsRegistry(now_fn=Clock())
        b = bus.EventBus(now_fn=Clock(), max_queue=4)
        queues = [b.subscribe("market_updates"), b.subscribe("trading_signals.7"),
                  b.subscribe("trading_signals.9")]
        mon = sat.SaturationMonitor(metrics=reg, tick_budget_s=0.5, window=8, min_samples=2)
        mon.set_tenant_lanes(6, "objects")
        trace = []
        for i in range(9):
            asyncio.run(b.publish("market_updates", {"i": i}))
            if i % 2:
                asyncio.run(b.publish("trading_signals.7", {"i": i}))
                asyncio.run(b.publish("trading_signals.9", {"i": i}))
            if i % 3 == 2:
                queues[0].get_nowait()
            mon.observe_stage("monitor", 0.125 * (i % 4))
            mon.observe_stage("analyzer", 0.4)
            stats = stats_seq[i % 3]
            duty = mon.close_tick(0.5 + 0.125 * i, bus=b,
                                  engine_stats=dict(stats) if stats else None,
                                  lag_s=0.0625 * i)
            trace.append((duty, mon.alert_state(), mon.status()))
        mon.discard_tick()
        mon.reset_windows()
        trace.append(mon.status())
        return trace, reg.exposition()

    got, ref = both(script)
    assert got == ref
    assert "stage_duty_cycle" in got[1] and "scatter_list_occupancy" in got[1]
    assert got[0][-2][1]["saturated_stages"] == ["analyzer"]


# --- PnL attribution --------------------------------------------------------

def test_pnl_attribution_summary_matches_jax():
    rng = np.random.default_rng(5)
    closed = [{"symbol": f"S{i % 3}USDC", "pnl": float(rng.normal(0, 10)),
               "reason": ("Stop Loss", "Take Profit", "Trailing Stop")[i % 3],
               "source": ({"family": ("trend", "momentum", None)[i % 3],
                           "structure_version": (None, "v2")[i % 2],
                           "model_version": ("m1", None)[i % 2]} if i % 5 else None)}
              for i in range(23)]

    def script(attr, metrics, **_):
        reg = metrics.MetricsRegistry(now_fn=Clock())
        a = attr.PnLAttribution(metrics=reg)
        cursor = a.fold_new(closed[:7], 0)
        cursor = a.fold_new(closed, cursor)
        a.export()
        return cursor, a.folded, a.summary(), a.summary("family"), reg.exposition()

    got, ref = both(script)
    assert got == ref and got[0] == 23 and set(got[2]) == {"family", "structure", "model",
                                                           "reason"}


# --- dashboard --------------------------------------------------------------

def _dashboard_state(rng):
    syms = ["AAAUSDC", "BBBUSDC", "CCCUSDC"]
    closes = (40_000 + np.cumsum(rng.normal(0, 30, 120))).tolist()
    klines = [[i * 60_000, c - 5, c + 20, c - 25, c, 100.0 + i] for i, c in enumerate(closes)]
    state = {
        "strategy_params": {"rsi_oversold": 30, "rsi_overbought": 70},
        "strategy_structure": {"rules": {"rsi": 0.5, "macd": 0.25}, "buy_threshold": 0.3,
                               "sell_threshold": 0.2, "stop_loss": 2.0, "take_profit": 4.0,
                               "version": "v3"},
        "market_data_AAAUSDC": {"structure_blend": 0.42, "structure_version": "v3",
                                "structure_signal": "BUY", "current_price": closes[-1]},
        "active_trades": {"AAAUSDC": {"entry_price": 40_123.5, "quantity": 0.1}},
        "portfolio_value_history": [{"t": float(i), "value": 10_000 + 5 * i} for i in range(40)],
        "market_regime": {"regime": "trending_up", "confidence": 0.8},
        "risk_metrics": {"var_95_pct": 0.27434241492301226, "var_99_pct": 0.4,
                         "cvar_95_pct": 0.35, "n_assets": 3},
        "var_history": [{"t": float(i), "var_95": 0.2 + 0.01 * i} for i in range(20)],
        "correlation_matrix": {"symbols": syms,
                               "matrix": np.corrcoef(rng.normal(size=(3, 50))).tolist()},
        "explanations": [{"symbol": "AAAUSDC", "decision": "BUY", "confidence": 0.8,
                          "supporting_factors": ["rsi"], "narrative": "oversold"}],
        "social_history_AAAUSDC": [[float(i), 0.5 + 0.01 * i] for i in range(10)],
        "social_metrics_AAAUSDC": {"overall_sentiment": 0.62, "volume": 100},
        "news_analysis_AAAUSDC": {"sentiment": 0.3, "articles": 4},
        "news_recent_AAAUSDC": [{"title": "A <b>headline</b>", "sentiment": 0.2}],
        "pattern_signals_AAAUSDC": {"pattern": "double_bottom", "confidence": 0.7},
        "pattern_analysis_report": {"patterns": {"double_bottom": 3}},
        "pnl_attribution": {"family": {"trend": {"pnl": 12.5, "trades": 3, "win_rate": 0.67}},
                            "reason": {"Stop Loss": {"pnl": -4.0, "trades": 2,
                                                     "win_rate": 0.0}}},
        "model_scorecard": {"lstm:1m": {"directional_accuracy": 0.6, "hit_rate": 0.55,
                                        "brier": 0.21, "n": 20}},
    }
    kwargs = dict(
        price_series=closes, equity_curve=[10_000 + i for i in range(50)],
        metrics={"sharpe": 1.25, "trades": 7, "name": "x"},
        mc_stats={"var": 0.05, "cvar": 0.07},
        signals=[{"symbol": "AAAUSDC", "timestamp": 12.0, "decision": "BUY",
                  "confidence": 0.8}],
        alerts=[{"name": "StaleMarketData", "severity": "warning", "description": "old",
                 "at": 5.0}],
        regime={"regime": "ranging"}, refresh_s=5.0, klines=klines,
        trades=[{"entry_time": klines[10][0], "exit_time": klines[40][0],
                 "entry_price": closes[10], "exit_price": closes[40], "pnl": 3.5}],
        allocation={"AAA": 0.5, "BBB": 0.3, "USDC": 0.2},
        model_versions=[{"version": "v1", "sharpe": 1.1}, {"version": "v2", "sharpe": 1.4}],
        symbol="AAAUSDC", symbol_links=syms,
        traces=[{"trace_id": "t1", "root": "tick", "duration_ms": 12.5,
                 "spans": [{"name": "tick", "service": "launcher", "duration_ms": 12.5,
                            "depth": 0}]}],
        decisions=[{"symbol": "AAAUSDC", "t": 60.0, "status": "vetoed",
                    "gate": "confidence_floor", "gate_detail": None,
                    "verdict": {"decision": "BUY", "confidence": 0.3},
                    "explanation": {"narrative": "weak"}}],
        now_fn=lambda: 1_700_000_000.0)
    return state, kwargs


@pytest.mark.parametrize("variant", ["full", "bus_only", "empty"])
def test_render_dashboard_html_is_byte_equal(tmp_path, variant):
    state, kwargs = _dashboard_state(np.random.default_rng(1))
    if variant == "bus_only":
        kwargs = {"symbol": "AAAUSDC", "now_fn": kwargs["now_fn"]}
    elif variant == "empty":
        state, kwargs = {}, {"now_fn": kwargs["now_fn"]}

    def render(dash, bus, **_):
        b = bus.EventBus(now_fn=Clock())
        for k, v in state.items():
            b.set(k, v)
        html = dash.render_dashboard(b, **kwargs)
        path = dash.write_dashboard(str(tmp_path / f"{id(dash)}.html"), bus=b, **kwargs)
        with open(path) as f:
            written = f.read()
        state_path = dash.dump_state_json(b, str(tmp_path / f"{id(dash)}.json"))
        with open(state_path) as f:
            dumped = f.read()
        return html, written, dumped

    got, ref = both(render)
    assert got == ref
    assert got[0] == got[1] and "<html" in got[0].lower()


def test_chart_overlays_match_jax():
    closes = (100 + np.cumsum(np.random.default_rng(3).normal(0, 1, 300))).tolist()
    got, ref = tdash.chart_overlays(closes), jdash.chart_overlays(closes)
    assert got.keys() == ref.keys()
    for k in got:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(ref[k]), err_msg=k)
