"""The PyTorch/CUDA port as a package: what it imports, where it runs, and
the data it shares with the JAX package.

The port imports torch and numpy only — never jax nor any module of
ai_crypto_trader_tpu (the `_torch` package itself aside) — and runs on the
CUDA card unless called with device="cpu".  These tests run on the CPU.
"""

import asyncio
import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from ai_crypto_trader_tpu_torch import convert, resolve_device
from ai_crypto_trader_tpu_torch.backtest import (
    BacktestInputs, StrategyParams, compute_metrics, default_params,
    portfolio_backtest, prepare_inputs, run_backtest, sample_params,
    shared_capital_backtest, stack_symbol_inputs, sweep,
)
from ai_crypto_trader_tpu_torch.data import from_dict, generate_ohlcv, load_csv
from ai_crypto_trader_tpu_torch.ops import TickEngine, compute_indicators, fused_ewma
from ai_crypto_trader_tpu_torch.ops import _cuda
from ai_crypto_trader_tpu_torch.ops.replay import sweep_kernel
from ai_crypto_trader_tpu_torch.backtest.evolvable import (
    build_indicator_tables, evolvable_fused_backtest, population_backtest,
)
from ai_crypto_trader_tpu_torch.config import GAParams
from ai_crypto_trader_tpu_torch.evolve import backtest_fitness, run_ga
from ai_crypto_trader_tpu_torch.mc import run_simulation, simulate_portfolio_correlated
from ai_crypto_trader_tpu_torch.models import (
    EpochTrainer, build_model, feature_importance, fit_scaler, optimize_hyperparameters,
    train_model)
from ai_crypto_trader_tpu_torch.models.service import PredictionService
from ai_crypto_trader_tpu_torch.models.train import TrainResult, predict_prices_batched
from ai_crypto_trader_tpu_torch.models.train_loop import Adam
from ai_crypto_trader_tpu_torch.patterns import (
    PatternRecognizer, detect_patterns, generate_dataset, train_pattern_model)
from ai_crypto_trader_tpu_torch.ops.tenant_engine import TenantEngine
from ai_crypto_trader_tpu_torch.risk import (
    historical_var, social_risk_adjustment, stress_var_cvar, trailing_stop_init,
    trailing_stop_update)
from ai_crypto_trader_tpu_torch.risk.social import SocialSnapshot
from ai_crypto_trader_tpu_torch.ops import orderbook
from ai_crypto_trader_tpu_torch.parallel import MeshPartitioner, get_partitioner, make_mesh
from ai_crypto_trader_tpu_torch.patterns.service import ChartPatternService
from ai_crypto_trader_tpu_torch.regime import (
    MarketRegimeService, RegimeDetector, gmm_fit, hmm_fit, kmeans_fit, pca_fit, regime_features,
    standardize_fit)
from ai_crypto_trader_tpu_torch.rl import (
    DQNConfig, PBTConfig, PBTTrainerService, hypers_from_config, make_env_params, pbt_env_params)
from ai_crypto_trader_tpu_torch.sim import calibrate as sim_calibrate
from ai_crypto_trader_tpu_torch.sim import engine as sim_engine
from ai_crypto_trader_tpu_torch.sim import exchange as sim_exchange
from ai_crypto_trader_tpu_torch.sim.engine import scenario_env_params
from ai_crypto_trader_tpu_torch.sim.lob import flow_params, lob_candles, lob_sweep, rollout_lob
from ai_crypto_trader_tpu_torch import cli as port_cli
from ai_crypto_trader_tpu_torch.shell import EventBus, FakeExchange, MarketMonitor, TradeExecutor
from ai_crypto_trader_tpu_torch.shell.scanner import MarketScanner, score_pairs
from ai_crypto_trader_tpu_torch.sim.paths import bootstrap_candles, gbm_candles, path_params
from ai_crypto_trader_tpu_torch.models import LongContextTransformer
from ai_crypto_trader_tpu_torch.social import analyzer as social_analyzer
from ai_crypto_trader_tpu_torch.data.ingest import SocialDaily
from ai_crypto_trader_tpu_torch.shell.launcher import TradingSystem
from ai_crypto_trader_tpu_torch.shell.stack import build_full_stack
from ai_crypto_trader_tpu_torch.social import SocialDataProvider, SocialMonitorService
from ai_crypto_trader_tpu_torch.strategy.arbitrage import find_triangle_arbitrage
from ai_crypto_trader_tpu_torch.strategy import StrategyEvolver, compare_strategies, cross_validate
from ai_crypto_trader_tpu_torch.strategy.generator import (
    GeneratorService, StrategyGenerator, default_seed, evaluate_structures, fold_features)
from ai_crypto_trader_tpu_torch.shell.stream import MarketStream, StreamSupervisor
from ai_crypto_trader_tpu_torch.testing.loadgen import (
    LoadConfig, SyntheticTenantTraffic, ramp, run_load)
from ai_crypto_trader_tpu_torch.backtest.queue import BacktestQueue
from ai_crypto_trader_tpu_torch.models.trade_importance import TradeOutcomeAnalyzer
from ai_crypto_trader_tpu_torch.strategy import FeatureImportanceIntegrator

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_PROBE = r"""
import importlib, pkgutil, re, sys
import ai_crypto_trader_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m.startswith("jaxlib")
             or re.match(r"ai_crypto_trader_tpu(?!_torch)(\.|$)", m))
print(len(names), bad)
expected = {"config", "ops.dynamic", "backtest.evolvable", "evolve", "evolve.ga",
            "evolve.selection", "cli", "obs", "obs.drift", "ops.volume_profile",
            "ops.combinations", "ops.tick_engine", "backtest.portfolio", "data.ingest",
            "obs.flightrec", "obs.fleetscope", "utils.journal", "ops.tenant_engine",
            "risk.stops", "risk.social", "risk.var", "sim.scenarios", "mc.engine",
            "models", "models.fused_lstm", "models.zoo", "models.train", "patterns",
            "patterns.model", "models.train_loop", "models.importance", "models.hpo",
            "models.service", "utils.checkpoint", "patterns.synthetic", "rl", "rl.env",
            "rl.dqn", "rl.draws", "rl.population", "sim.paths", "sim.lob", "sim.engine",
            "parallel", "parallel.partitioner", "sim.exchange", "sim.calibrate",
            "utils", "obs.scorecard", "strategy", "strategy.registry", "rl.trainer_service",
            "regime", "regime.cluster", "regime.hmm", "regime.detector", "regime.collector",
            "regime.service", "ops.orderbook", "patterns.service", "utils.shapes",
            "data.fetchers", "shell", "shell.llm", "strategy.generator",
            "strategy.evaluation", "strategy.evolution", "strategy.improver",
            "strategy.selection", "strategy.explain", "parallel.ring_attention",
            "models.long_context", "social", "social.analyzer", "utils.symbols",
            "utils.circuit_breaker", "utils.rate_limiter", "utils.metrics", "utils.tracing",
            "utils.devprof", "obs.tickpath", "shell.bus", "shell.exchange", "shell.monitor",
            "shell.analyzer", "shell.executor", "shell.scanner", "shell.launcher",
            "shell.dashboard", "obs.attribution", "utils.alerts", "utils.health",
            "utils.saturation", "utils.supervision", "utils.structlog", "social.news",
            "social.provider", "social.service", "social.strategy_integrator",
            "strategy.grid", "strategy.dca", "strategy.grid_live", "strategy.arbitrage",
            "shell.stack", "shell.stream", "testing", "testing.chaos", "testing.loadgen",
            "utils.meshprof", "utils.profiling", "utils.aotcache", "utils.cache",
            "shell.dashboard_server", "backtest.queue", "backtest.results",
            "models.trade_importance", "strategy.integration", "utils.api_security",
            "parallel.mesh", "parallel.time_shard"}
missing = sorted(e for e in expected if pkg.__name__ + "." + e not in names)
print(missing)
from ai_crypto_trader_tpu_torch import obs, utils
from ai_crypto_trader_tpu_torch import models, parallel, shell, social, strategy
exports = {"obs": {"DRIFT_FEATURES", "N_BINS", "PSI_ALERT_THRESHOLD", "reference_histogram",
                   "FleetScope", "Scorecard", "FlightRecorder", "PnLAttribution",
                   "load_decisions"},
           "utils": {"save_checkpoint", "load_checkpoint", "CircuitBreaker", "CircuitState",
                     "get_circuit_breaker", "retry_with_backoff", "TokenBucket",
                     "MetricsRegistry"},
           "shell": {"EventBus", "ExchangeInterface", "ExchangeUnavailable", "FakeExchange",
                     "ResilientExchange", "make_exchange", "LLMTrader", "OpenAIBackend",
                     "TechnicalPolicyBackend", "UrllibPostTransport", "MarketMonitor",
                     "SignalAnalyzer", "TradeExecutor"},
           "strategy": {"compare_strategies", "cross_validate", "trade_metrics",
                        "StrategySelector", "StrategyEvolver", "ModelRegistry",
                        "explain_signal", "GeneratorService", "StrategyGenerator",
                        "StrategyStructure", "GridTrader", "DCAService",
                        "GridTraderService", "DCAStrategy", "find_triangle_arbitrage",
                        "FeatureImportanceIntegrator"},
           "social": {"adaptive_source_weights", "detect_anomalies", "fit_anomaly_model",
                      "lead_lag_correlation", "normalize_metrics", "sentiment_accuracy",
                      "NewsAnalyzer", "NewsService", "deterministic_news_provider",
                      "lexicon_sentiment", "SocialMonitorService", "SocialDataProvider",
                      "asof_indices", "resample_ffill", "SOCIAL_STRATEGY_TEMPLATES",
                      "SocialStrategyIntegrator", "analyze_social_impact",
                      "generate_social_strategy"},
           "models": {"LongContextTransformer", "LongContextBlock", "RingSelfAttention",
                      "long_context_loss"},
           "parallel": {"make_mesh", "default_mesh", "data_sharding", "initialize_distributed",
                        "pad_to_multiple", "replicated", "shard_leading_axis",
                        "MeshPartitioner", "Partitioner", "SingleDevicePartitioner",
                        "get_partitioner", "match_partition_rules"}}
modules = {"obs": obs, "utils": utils, "strategy": strategy, "social": social,
           "models": models, "shell": shell, "parallel": parallel}
missing += sorted(f"{m}.{n}" for m, names in exports.items() for n in names
                  if not hasattr(modules[m], n))
print(missing)
from ai_crypto_trader_tpu_torch import cli
cli.main(["rl", "--device", "cpu", "--population", "2", "--generations", "1", "--iters", "1",
          "--envs", "2", "--rollout", "2", "--scenarios", "2", "--steps", "96",
          "--episode-len", "16"])
cli.main(["scan", "--device", "cpu", "--pairs", "4", "--lookback", "32"])
import tempfile
with tempfile.TemporaryDirectory() as tmp:
    cli.main(["generate", "--device", "cpu", "--days", "1", "--folds", "2", "--pool", "2",
              "--rounds", "1", "--registry", tmp + "/registry.json"])
    cli.main(["trade", "--paper", "--device", "cpu", "--ticks", "2", "--flightrec",
              tmp + "/decisions.jsonl", "--journal", tmp + "/trades.journal"])
    cli.main(["why", "BTCUSDC", "--device", "cpu", "--file", tmp + "/decisions.jsonl"])
    from ai_crypto_trader_tpu_torch.data import from_dict, generate_ohlcv
    from ai_crypto_trader_tpu_torch.shell import FakeExchange
    from ai_crypto_trader_tpu_torch.shell.launcher import TradingSystem
    from ai_crypto_trader_tpu_torch.shell.stack import build_full_stack
    d = {k: v for k, v in generate_ohlcv(n=300, seed=1).items() if k != "regime"}
    system = TradingSystem(FakeExchange({"BTCUSDC": from_dict(d, symbol="BTCUSDC")}),
                           ["BTCUSDC"], device="cpu")
    build_full_stack(system, grid_symbol="BTCUSDC", dca_symbol="BTCUSDC",
                     cadences={"patterns": {"checkpoint": None, "train_on_start": False}})
    system.shutdown()
    cli.main(["load", "--device", "cpu", "--mode", "vmapped", "--tenants", "2", "--symbols",
              "2", "--ticks", "2"])
    cli.main(["fleet", "--device", "cpu", "--tenants", "2", "--symbols", "2", "--ticks", "2"])
    cli.main(["trade", "--paper", "--device", "cpu", "--ticks", "2", "--serve", "0",
              "--devprof", "--meshprof", "--aot-cache", tmp + "/cache"])
    cli.main(["profile", "--device", "cpu", "--ticks", "1", "--out", tmp + "/profile"])
    cli.main(["mesh", "--pop", "10"])
    cli.main(["status"])
    cli.main(["mc", "--device", "cpu", "--paths", "16", "--days", "2"])
    import os
    here = os.getcwd()
    os.chdir(tmp)
    try:
        cli.main(["fetch", "--days", "1"])
        cli.main(["backtest", "--device", "cpu", "--days", "1"])
        cli.main(["list"])
        cli.main(["report", "--out", "report.html"])
    finally:
        os.chdir(here)
bad += sorted(m for m in sys.modules
              if m == "jax" or m.startswith("jax.") or m.startswith("jaxlib")
              or re.match(r"ai_crypto_trader_tpu(?!_torch)(\.|$)", m))
print(bad)
sys.exit(1 if bad or missing or len(names) < 130 else 0)
"""


def test_port_imports_neither_jax_nor_the_jax_package():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", _IMPORT_PROBE], cwd=ROOT,
                          env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _small():
    return {k: v for k, v in generate_ohlcv(n=300, seed=3).items() if k != "regime"}


_ENTRY_POINTS = {
    "resolve_device": lambda: resolve_device(),
    "compute_indicators": lambda: compute_indicators(_small()),
    "fused_ewma": lambda: fused_ewma(np.ones((1, 64), np.float32), [0.1]),
    "sample_params": lambda: sample_params(torch.Generator().manual_seed(0), 4),
    "default_params": lambda: default_params(),
    "prepare_inputs": lambda: prepare_inputs(
        compute_indicators(_small(), device="cpu")),
    "sweep": lambda: sweep(
        prepare_inputs(compute_indicators(_small(), device="cpu"), device="cpu"),
        default_params((2,), device="cpu")),
    "sweep_kernel": lambda: sweep_kernel(
        prepare_inputs(compute_indicators(_small(), device="cpu"), device="cpu"),
        default_params((2,), device="cpu")),
    "run_backtest": lambda: run_backtest(
        prepare_inputs(compute_indicators(_small(), device="cpu"), device="cpu")),
    "params_from_numpy": lambda: convert.params_from_numpy(
        {f: np.ones(2, np.float32) for f in StrategyParams._fields}),
    "inputs_from_numpy": lambda: convert.inputs_from_numpy(
        {f: np.ones(4, np.float32) for f in BacktestInputs._fields}),
    "build_indicator_tables": lambda: build_indicator_tables(_small()),
    "population_backtest": lambda: population_backtest(
        _small(), default_params((2,), device="cpu")),
    "evolvable_fused_backtest": lambda: evolvable_fused_backtest(
        _small(), default_params((2,), device="cpu"),
        build_indicator_tables(_small(), device="cpu")),
    "backtest_fitness": lambda: backtest_fitness(_small()),
    "run_ga": lambda: run_ga(torch.Generator().manual_seed(0),
                             backtest_fitness(_small(), device="cpu"),
                             GAParams(population_size=4, generations=1)),
    "tables_from_numpy": lambda: convert.tables_from_numpy(
        {f: np.ones((2, 4), np.float32) for f in
         ("ema_raw", "ema_fill", "rsi_fill", "atr_fill", "atr_median", "bb_mid", "bb_sd",
          "vol_ma_fill")}),
    "genomes_from_numpy": lambda: convert.genomes_from_numpy(np.ones((4, 18), np.float32)),
    "TickEngine": lambda: TickEngine(["BTCUSDC"], ["1m"], window=64),
    "stack_symbol_inputs": lambda: stack_symbol_inputs({"BTCUSDC": _small()}),
    "portfolio_backtest": lambda: portfolio_backtest(
        prepare_inputs(compute_indicators(_small(), device="cpu"), device="cpu")),
    "shared_capital_backtest": lambda: shared_capital_backtest(
        stack_symbol_inputs({"BTCUSDC": _small()}, device="cpu")[0]),
    "TenantEngine": lambda: TenantEngine(["BTCUSDC"], 4),
    "run_simulation": lambda: run_simulation(None, 100.0, np.full(64, 0.001, np.float32)),
    "stress_var_cvar": lambda: stress_var_cvar(None, 100.0, np.full(64, 0.001, np.float32),
                                               num_sims=16),
    "simulate_portfolio_correlated": lambda: simulate_portfolio_correlated(
        None, np.ones(2, np.float32), np.zeros(2, np.float32), np.eye(2, dtype=np.float32),
        np.full(2, 0.5, np.float32), 5, 4),
    "historical_var": lambda: historical_var(np.zeros((2, 16), np.float32)),
    "trailing_stop_update": lambda: trailing_stop_update(
        trailing_stop_init(np.ones(2, np.float32), np.zeros(2, np.float32), device="cpu"),
        np.ones(2, np.float32)),
    "social_risk_adjustment": lambda: social_risk_adjustment(SocialSnapshot(
        np.full((2, 4), 0.5, np.float32), np.zeros(2, np.float32), np.float32(1.0))),
    "build_model": lambda: build_model("gru", units=8),
    "predict_prices_batched": lambda: predict_prices_batched(
        [TrainResult(dict(build_model("lstm", units=8, device="cpu").named_parameters()),
                     "lstm", fit_scaler(np.ones((70, 5), np.float32), device="cpu"),
                     {"units": 8})], [np.ones((70, 5), np.float32)]),
    "detect_patterns": lambda: detect_patterns(
        PatternRecognizer("cnn", {}), np.ones((64, 5), np.float32)),
    "train_model": lambda: train_model(torch.Generator(), np.ones((80, 5), np.float32),
                                       seq_len=8, units=8, epochs=1),
    "EpochTrainer": lambda: EpochTrainer(lambda p, xb, yb, g: 0.0, Adam(1e-3)),
    "optimize_hyperparameters": lambda: optimize_hyperparameters(
        torch.Generator(), np.ones((80, 5), np.float32), n_trials=1),
    "feature_importance": lambda: feature_importance(
        dict(build_model("lstm", units=8, device="cpu").named_parameters()), "lstm",
        np.ones((2, 8, 5), np.float32), model_kwargs={"units": 8}),
    "PredictionService": lambda: PredictionService(None, ["BTCUSDC"]),
    "generate_dataset": lambda: generate_dataset(torch.Generator(), 2),
    "train_pattern_model": lambda: train_pattern_model(torch.Generator(), n_per_class=2,
                                                       epochs=1),
    "make_env_params": lambda: make_env_params(compute_indicators(_small(), device="cpu")),
    "hypers_from_config": lambda: hypers_from_config(DQNConfig()),
    "path_params": lambda: path_params(),
    "gbm_candles": lambda: gbm_candles(torch.Generator(), _schedule()),
    "bootstrap_candles": lambda: bootstrap_candles(torch.Generator(),
                                                   np.zeros(16, np.float32), _schedule()),
    "flow_params": lambda: flow_params(),
    "lob_candles": lambda: lob_candles(torch.Generator(), _schedule()),
    "scenario_env_params": lambda: scenario_env_params(torch.Generator(), num_scenarios=2,
                                                       steps=64),
    "pbt_env_params": lambda: pbt_env_params(torch.Generator(), num_scenarios=2, steps=64),
    "env_params_from_numpy": lambda: convert.env_params_from_numpy(
        make_env_params(compute_indicators(_small(), device="cpu"), device="cpu")),
    "q_params_from_flax": lambda: convert.q_params_from_flax(
        {"params": {"Dense_0": {"kernel": np.ones((2, 3), np.float32),
                                "bias": np.zeros(3, np.float32)}}}),
    "exchange.init_state": lambda: sim_exchange.init_state(),
    "exchange.no_action": lambda: sim_exchange.no_action(2),
    "default_strategy": lambda: sim_engine.default_strategy(),
    "fill_params": lambda: sim_engine.fill_params(),
    "rollout_candles": lambda: sim_engine.rollout_candles(
        {k: np.full((1, 64), 100.0, np.float32) for k in ("open", "high", "low", "close")}),
    "sim_sweep": lambda: sim_engine.sweep(torch.Generator(), num_scenarios=2, steps=64),
    "backtest_under_stress": lambda: sim_engine.backtest_under_stress(
        torch.Generator(), num_scenarios=2, steps=256),
    "rollout_lob": lambda: rollout_lob(torch.Generator(), _schedule()),
    "lob_sweep": lambda: lob_sweep(torch.Generator(), num_scenarios=2, steps=64),
    "fit_flow_params": lambda: sim_calibrate.fit_flow_params(
        [{"symbol": "X", "kind": "snapshot", "bids": [[100.0 - i, 1.0] for i in range(4)],
          "asks": [[101.0 + i, 1.0] for i in range(4)]}] * 3),
    "sim_strategy_from_jax": lambda: convert.sim_strategy_from_jax(
        sim_engine.default_strategy(device="cpu")),
    "fill_params_from_jax": lambda: convert.fill_params_from_jax(
        sim_engine.fill_params(device="cpu")),
    "flow_params_from_jax": lambda: convert.flow_params_from_jax(flow_params(device="cpu")),
    "PBTTrainerService": lambda: PBTTrainerService(DQNConfig(), PBTConfig()),
    "regime_features": lambda: regime_features(_small()),
    "RegimeDetector": lambda: RegimeDetector(),
    "standardize_fit": lambda: standardize_fit(np.ones((8, 2), np.float32)),
    "pca_fit": lambda: pca_fit(np.ones((8, 3), np.float32), 2),
    "kmeans_fit": lambda: kmeans_fit(0, np.ones((8, 2), np.float32), 2),
    "gmm_fit": lambda: gmm_fit(0, np.ones((8, 2), np.float32), 2),
    "hmm_fit": lambda: hmm_fit(0, np.ones((8, 2), np.float32), 2),
    "MarketRegimeService": lambda: MarketRegimeService(None),
    "imbalance": lambda: orderbook.imbalance(_BOOK, _BOOK),
    "price_impact": lambda: orderbook.price_impact(_BOOK, [1.0]),
    "find_walls": lambda: orderbook.find_walls(_BOOK),
    "pressure_metrics": lambda: orderbook.pressure_metrics(_BOOK, _BOOK),
    "gini_concentration": lambda: orderbook.gini_concentration(_BOOK),
    "cluster_orders": lambda: orderbook.cluster_orders(_BOOK),
    "orderbook_signal": lambda: orderbook.orderbook_signal(_BOOK, _BOOK),
    "ChartPatternService": lambda: ChartPatternService(None, PatternRecognizer("cnn", {}), []),
    "fold_features": lambda: fold_features(_small()),
    "evaluate_structures": lambda: evaluate_structures([], [default_seed()]),
    "StrategyGenerator": lambda: StrategyGenerator(),
    "GeneratorService": lambda: GeneratorService(None),
    "StrategyEvolver": lambda: StrategyEvolver(None),
    "cross_validate": lambda: cross_validate(_small(), default_params(device="cpu")),
    "compare_strategies": lambda: compare_strategies(
        _small(), {"a": default_params(device="cpu")}),
    "LongContextTransformer": lambda: LongContextTransformer(4, d_model=8),
    "long_context_from_flax": lambda: convert.long_context_from_flax({}, features=4),
    "normalize_metrics": lambda: social_analyzer.normalize_metrics(np.ones((8, 2))),
    "fit_anomaly_model": lambda: social_analyzer.fit_anomaly_model(np.ones((8, 2))),
    "detect_anomalies": lambda: social_analyzer.detect_anomalies(
        social_analyzer.AnomalyModel(np.zeros(2), np.eye(2), 1.0), np.ones((8, 2))),
    "lead_lag_correlation": lambda: social_analyzer.lead_lag_correlation(
        np.ones(8), np.ones(8), max_lag=2),
    "sentiment_accuracy": lambda: social_analyzer.sentiment_accuracy(np.ones(8), np.ones(8)),
    "adaptive_source_weights": lambda: social_analyzer.adaptive_source_weights(
        {"a": np.ones(8)}, np.ones(8)),
    "kmeans_from_jax": lambda: convert.kmeans_from_jax(SimpleNamespace(
        centroids=np.ones((2, 2), np.float32))),
    "standardizer_from_jax": lambda: convert.standardizer_from_jax(SimpleNamespace(
        mean=np.ones(2, np.float32), std=np.ones(2, np.float32))),
    "MarketMonitor": lambda: MarketMonitor(EventBus(), FakeExchange({})),
    "TradeExecutor": lambda: TradeExecutor(EventBus(), FakeExchange({})),
    "MarketScanner": lambda: MarketScanner(FakeExchange({})),
    "score_pairs": lambda: score_pairs({k: np.ones((2, 8), np.float32)
                                        for k in ("open", "high", "low", "close", "volume")}),
    "cli_scan": lambda: port_cli.main(["scan", "--pairs", "2", "--lookback", "16"]),
    "find_triangle_arbitrage": lambda: find_triangle_arbitrage(_TICKERS, _ASSETS),
    "SocialMonitorService": lambda: SocialMonitorService(EventBus()),
    "SocialDataProvider.social_inputs": lambda: SocialDataProvider(_DAILY).social_inputs(
        np.arange(8, dtype=np.int64) * 60),
    "build_full_stack": lambda: build_full_stack(
        TradingSystem(FakeExchange(_STACK_SERIES), ["BTCUSDC"]), cadences=_QUICK_STACK),
    "MarketStream": lambda: MarketStream(MarketMonitor(EventBus(), FakeExchange({}))),
    "StreamSupervisor": lambda: StreamSupervisor(MarketStream(
        MarketMonitor(EventBus(), FakeExchange({})))),
    "SyntheticTenantTraffic": lambda: SyntheticTenantTraffic(LoadConfig(tenants=1, symbols=1)),
    "run_load": lambda: run_load(LoadConfig(tenants=1, symbols=1, ticks=1)),
    "ramp": lambda: ramp(LoadConfig(tenants=1, symbols=1, ticks=1)),
    "cli_load": lambda: port_cli.main(["load", "--tenants", "1", "--symbols", "1",
                                       "--ticks", "1"]),
    "cli_fleet": lambda: port_cli.main(["fleet", "--tenants", "1", "--symbols", "1",
                                        "--ticks", "1"]),
    "BacktestQueue.process_task_queue": lambda: asyncio.run(
        _queued(BacktestQueue()).process_task_queue()),
    "TradeOutcomeAnalyzer.fit": lambda: TradeOutcomeAnalyzer(n_trees=2).fit(_TRADES),
    "TradeOutcomeAnalyzer.predict_trade_outcome": lambda: TradeOutcomeAnalyzer()
    .predict_trade_outcome({"rsi": 50.0}),
    "FeatureImportanceIntegrator.predict_trade_outcome": lambda: FeatureImportanceIntegrator(
        analyzer=TradeOutcomeAnalyzer()).predict_trade_outcome({"rsi": 50.0}),
}

_TRADES = [{"features": {"rsi": float(r), "macd": float(m)}, "pnl": 1.0 if r > 50 else -1.0}
           for r, m in zip(np.linspace(10, 90, 24), np.cos(np.arange(24)))]


def _queued(queue):
    queue.add_backtest_task(_small())
    return queue


def _fitted_on_the_cpu():
    az = TradeOutcomeAnalyzer(n_trees=4, n_permutation_repeats=2, device="cpu")
    az.fit(_TRADES)
    return az

_TICKERS = {"BTCUSDC": {"bid": 100.0, "ask": 100.0}, "ETHUSDC": {"bid": 10.1, "ask": 10.1},
            "ETHBTC": {"bid": 0.1, "ask": 0.1}}
_ASSETS = ["USDC", "BTC", "ETH"]
_DAILY = SocialDaily(np.arange(3, dtype=np.int64) * 86_400,
                     {"social_sentiment": np.full(3, 0.6, np.float32)})
_STACK_SERIES = {"BTCUSDC": from_dict(_small(), symbol="BTCUSDC")}
_QUICK_STACK = {"patterns": {"checkpoint": None, "train_on_start": False}}

# the new entry points on the CPU: (call, check of the result)
_CPU_RUNS = {
    "DashboardServer": (
        lambda: _served_state_on_the_cpu(),
        lambda out: out[0] == 200 and {"devprof", "mesh", "aot_cache", "build"} <= out[1]),
    "DevProf.carding": (
        lambda: _carded_on_the_cpu(),
        lambda card: card["output_bytes"] == 12 and card["temp_bytes"] is None),
    "MeshProf.watch": (
        lambda: _watched_on_the_cpu(),
        lambda st: st["recompiles"]["windows"] == {"tick_engine": 1}),
    "profiling.trace": (
        lambda: _traced_on_the_cpu(),
        lambda events: events == []),
    "AOTCache.enable": (
        lambda: _cache_on_the_cpu(),
        lambda st: st["enabled"] and st["warm"] is False and st["lock"] == "held"),
    "find_triangle_arbitrage": (
        lambda: find_triangle_arbitrage(_TICKERS, _ASSETS, fee_rate=0.0, device="cpu"),
        lambda out: out and out[0]["cycle"][0] == "USDC"),
    "SocialMonitorService": (
        lambda: SocialMonitorService(EventBus(), device="cpu"),
        lambda svc: svc.device == torch.device("cpu")),
    "SocialDataProvider.social_inputs": (
        lambda: SocialDataProvider(_DAILY).social_inputs(
            86_400 + np.arange(8, dtype=np.int64) * 60, device="cpu"),
        lambda out: out.sentiment.device.type == "cpu"
        and torch.allclose(out.sentiment, torch.full((8,), 60.0))),
    "build_full_stack": (
        lambda: _full_stack_on_the_cpu(),
        lambda services: [s.name for s in services] == [
            "social", "news", "patterns", "regime", "nn", "evolver", "generator"]),
    "MarketStream": (
        lambda: _streamed_drain_on_the_cpu(),
        lambda out: out == (1, torch.device("cpu"))),
    "attach_stream": (
        lambda: _streamed_system_on_the_cpu(),
        lambda out: out == ("StreamSupervisor", 1.0)),
    "run_load": (
        lambda: run_load(LoadConfig(tenants=2, symbols=2, ticks=2, mode="vmapped",
                                    device="cpu")),
        lambda rep: rep["mode"] == "vmapped" and rep["rest_kline_calls_steady"] == 0
        and rep["published"] == 4),
    "ramp": (
        lambda: ramp(LoadConfig(tenants=2, symbols=2, ticks=2, slo_p99_ms=60_000.0,
                                device="cpu")),
        lambda out: [s["tenants"] for s in out["steps"]] == [1, 2]
        and out["max_sustainable"]["tenants"] == 2),
    "BacktestQueue.process_task_queue": (
        lambda: (lambda q: (asyncio.run(q.process_task_queue()), q.get_result("bt_1")))(
            _queued(BacktestQueue(device="cpu"))),
        lambda out: out[0] == 1 and out[1]["metrics"]["initial_balance"] == 10_000.0),
    "TradeOutcomeAnalyzer.fit": (
        lambda: _fitted_on_the_cpu(),
        lambda az: az.model.device == torch.device("cpu")
        and az.kept_features and set(az.importances["permutation"]) == {"macd", "rsi"}),
    "TradeOutcomeAnalyzer.predict_trade_outcome": (
        lambda: _fitted_on_the_cpu().predict_trade_outcome({"rsi": 80.0, "macd": 0.0}),
        lambda out: out["status"] == "success" and out["prediction"] == "win"),
    "FeatureImportanceIntegrator.predict_trade_outcome": (
        lambda: FeatureImportanceIntegrator(analyzer=_fitted_on_the_cpu())
        .predict_trade_outcome({"rsi": 20.0, "macd": 0.0}),
        lambda out: out["status"] == "success" and out["prediction"] == "loss"),
}


def _served_state_on_the_cpu():
    """A CPU system with every observatory on, one tick, and its
    /state.json through a DashboardServer on an ephemeral port."""
    import asyncio
    import json
    import tempfile
    import urllib.request

    from ai_crypto_trader_tpu_torch.shell.dashboard_server import DashboardServer

    with tempfile.TemporaryDirectory() as tmp:
        ex = FakeExchange(_streamed_series())
        ex.advance(steps=2_200)
        system = TradingSystem(ex, ["BTCUSDC"], device="cpu", enable_devprof=True,
                               enable_meshprof=True, aot_cache_dir=tmp)
        server = DashboardServer(system, port=0).start()
        try:
            asyncio.run(system.tick())
            with urllib.request.urlopen(f"http://127.0.0.1:{server.port}/state.json",
                                        timeout=30) as resp:
                return resp.status, set(json.loads(resp.read()))
        finally:
            server.stop()
            system.shutdown()


def _carded_on_the_cpu():
    from ai_crypto_trader_tpu_torch.utils import devprof

    with devprof.use(devprof.DevProf()) as dp:
        x = torch.ones(3)
        with devprof.carding("p", (x,)) as card:
            card.result(x + 1.0)
        return dp.cards["p"].to_dict()


def _watched_on_the_cpu():
    from ai_crypto_trader_tpu_torch.utils import meshprof

    with meshprof.use(meshprof.MeshProf()) as mp:
        with meshprof.watch("tick_engine", cold=True):
            torch.ones(2).sum().item()        # nothing to guard on the CPU
        return mp.status()


def _traced_on_the_cpu():
    import tempfile

    from ai_crypto_trader_tpu_torch.utils import profiling

    with tempfile.TemporaryDirectory() as tmp:
        with profiling.trace(tmp, cuda=False):
            torch.ones(8).cumsum(0)
        return profiling.cuda_events(os.path.join(tmp, profiling.TRACE_FILE))


def _cache_on_the_cpu():
    import tempfile

    from ai_crypto_trader_tpu_torch.utils.aotcache import AOTCache

    with tempfile.TemporaryDirectory() as tmp:
        cache = AOTCache(tmp)
        try:
            cache.enable({"backend": "cpu"})
            return cache.status()
        finally:
            cache.close()


def _streamed_series(n=2_400):
    return {"BTCUSDC": from_dict({k: v for k, v in generate_ohlcv(n=n, seed=3).items()
                                  if k != "regime"}, symbol="BTCUSDC")}


def _streamed_drain_on_the_cpu():
    """One streamed drain over a CPU monitor: the stream's kline frames,
    a REST seed, one publication on the monitor's device."""
    from ai_crypto_trader_tpu_torch.testing.chaos import kline_frames_for

    ex = FakeExchange(_streamed_series())
    ex.advance(steps=2_200)
    mon = MarketMonitor(EventBus(), ex, symbols=["BTCUSDC"], kline_limit=64, device="cpu")
    st = MarketStream(mon)
    for f in kline_frames_for(ex, ["BTCUSDC"], mon.intervals):
        st.ingest_frame(f)
    import asyncio

    return asyncio.run(st.drain()), mon._engine.device


def _streamed_system_on_the_cpu():
    """A CPU trading system on the ``"stream"`` cadence ticks once on the
    stream (frames offered before the tick), then shuts down."""
    import asyncio

    from ai_crypto_trader_tpu_torch.testing.chaos import kline_frames_for

    clock = [1_000.0]
    ex = FakeExchange(_streamed_series())
    ex.advance(steps=2_200)
    system = TradingSystem(ex, ["BTCUSDC"], now_fn=lambda: clock[0], device="cpu")
    try:
        system.monitor.kline_limit = 64
        build_full_stack(system, cadences={**_QUICK_STACK, "stream": {"enabled": True}},
                         nn=False, generator=False, evolver=False)
        for f in kline_frames_for(ex, ["BTCUSDC"], system.monitor.intervals):
            system.stream.offer(f)
        asyncio.run(system.tick())
        return type(system.stream).__name__, system.metrics.gauges[
            "crypto_trader_tpu_stream_mode"]
    finally:
        system.shutdown()


def _full_stack_on_the_cpu():
    """`build_full_stack` on a CPU system, shut down before it returns: a
    system left open keeps its tick-path scope installed for the whole
    process, and a later test's tick engine would record timings."""
    system = TradingSystem(FakeExchange(_STACK_SERIES), ["BTCUSDC"], device="cpu")
    try:
        return build_full_stack(system, cadences=_QUICK_STACK)
    finally:
        system.shutdown()

_BOOK = np.stack([np.arange(8, dtype=np.float32) + 1, np.ones(8, np.float32)], axis=1)


def _schedule():
    from ai_crypto_trader_tpu_torch.sim import mixed_schedules
    return mixed_schedules(None, 2, 64)[0]



@pytest.mark.parametrize("entry", sorted(_ENTRY_POINTS))
def test_default_device_is_cuda_and_raises_without_it(no_cuda, entry):
    with pytest.raises(RuntimeError, match="CUDA"):
        _ENTRY_POINTS[entry]()


@pytest.mark.parametrize("entry", sorted(_CPU_RUNS))
def test_new_entry_points_run_on_the_cpu(entry):
    call, check = _CPU_RUNS[entry]
    assert check(call())


_JAX_PACKAGES = [""] + sorted(
    d for d in os.listdir(os.path.join(ROOT, "ai_crypto_trader_tpu"))
    if os.path.exists(os.path.join(ROOT, "ai_crypto_trader_tpu", d, "__init__.py")))


@pytest.mark.parametrize("package", _JAX_PACKAGES, ids=lambda p: p or "top-level")
def test_package_exports_are_the_jax_package_exports(package):
    """The port's top-level package and each of its subpackages export at
    least the JAX package's public names (the port may add its own);
    `social` and `strategy` exactly the JAX package's.  The top level has
    the JAX package's `__version__`."""
    import importlib
    import inspect

    def public(mod):
        return {n for n in dir(mod) if not n.startswith("_")
                and not inspect.ismodule(getattr(mod, n))}

    suffix = f".{package}" if package else ""
    jax_mod = importlib.import_module(f"ai_crypto_trader_tpu{suffix}")
    port_mod = importlib.import_module(f"ai_crypto_trader_tpu_torch{suffix}")
    ref, got = public(jax_mod), public(port_mod)
    assert sorted(ref - got) == []
    if package in ("social", "strategy"):
        assert got == ref
    if not package:
        assert port_mod.__version__ == jax_mod.__version__


def test_cli_subcommands_are_the_jax_clis():
    """The port's CLI has exactly the JAX CLI's 21 subcommands."""
    import argparse

    from ai_crypto_trader_tpu import cli as jax_cli

    def commands(parser):
        sub = next(a for a in parser._actions if isinstance(a, argparse._SubParsersAction))
        return set(sub.choices)

    ref = commands(jax_cli.build_parser())
    assert commands(port_cli.build_parser()) == ref and len(ref) == 21


def test_no_port_module_names_sklearn():
    """The port fits its own forest: no module of it, and not chip_smoke.py,
    names `sklearn` in its code — no import, lazy or not, and no module
    name handed to an importer (prose in docstrings and comments aside)."""
    import ast

    paths = [os.path.join(ROOT, "chip_smoke.py")] + [
        os.path.join(d, f) for d, _, files in os.walk(os.path.join(ROOT, "ai_crypto_trader_tpu_torch"))
        for f in files if f.endswith(".py")]

    def names_sklearn(path):
        for node in ast.walk(ast.parse(open(path, encoding="utf-8").read())):
            if isinstance(node, ast.Import) and any(
                    a.name.split(".")[0] == "sklearn" for a in node.names):
                return True
            if isinstance(node, ast.ImportFrom) and (node.module or "").split(".")[0] == "sklearn":
                return True
            if isinstance(node, ast.Name) and node.id == "sklearn":
                return True
            if isinstance(node, ast.Constant) and isinstance(node.value, str) and \
                    node.value.split(".")[0] == "sklearn":
                return True
        return False

    named = [p for p in paths if names_sklearn(p)]
    assert len(paths) > 130 and named == []


def test_compute_metrics_default_device_raises(no_cuda):
    inp = prepare_inputs(compute_indicators(_small(), device="cpu"), device="cpu")
    stats = sweep(inp, default_params((2,), device="cpu"), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        compute_metrics(stats)
    assert set(compute_metrics(stats, device="cpu")) >= {"sharpe_ratio", "win_rate"}


def test_cpu_is_used_only_when_asked():
    assert resolve_device("cpu") == torch.device("cpu")
    out = fused_ewma(np.ones((2, 16), np.float32), [0.5], device="cpu")
    assert out.device.type == "cpu" and out.shape == (1, 2, 16)


def test_kernel_build_without_nvcc_raises(monkeypatch, tmp_path):
    """A kernel that cannot be built raises; nothing falls back."""
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_cuda.os.path, "isfile", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc"):
        _cuda.nvcc_path()


def test_library_names_follow_the_source_hash():
    paths = {name: _cuda.library_path(name) for name in _cuda.SOURCES}
    assert set(paths) == {"fused_ewma", "replay_sweep"}
    for name, path in paths.items():
        assert path.parent.name == ".torch_kernels"
        assert path.name.startswith(name + "-") and path.suffix == ".so"
        assert (_cuda.SOURCE_DIR / f"{name}.cu").is_file()
    assert "--fmad=false" in _cuda.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in _cuda.NVCC_FLAGS


@pytest.mark.parametrize("n,seed", [(1000, 0), (2048, 7), (525, [1, 2, 3])])
def test_generate_ohlcv_bit_identical_to_the_jax_package(n, seed):
    from ai_crypto_trader_tpu.data import synthetic as ref

    a, b = generate_ohlcv(n=n, seed=seed), ref.generate_ohlcv(n=n, seed=seed)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_csv_ingest_reads_the_jax_package_cache(tmp_path):
    from ai_crypto_trader_tpu.data import ingest as ref

    d = {k: v for k, v in generate_ohlcv(n=50, seed=1).items() if k != "regime"}
    path = ref.save_csv(ref.from_dict(d, symbol="BTCUSDC"), str(tmp_path))
    got, want = load_csv(path, symbol="BTCUSDC"), ref.load_csv(path, symbol="BTCUSDC")
    for f in ("timestamp", "open", "high", "low", "close", "volume"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
    mine = from_dict(d, symbol="X")
    assert len(mine) == 50 and mine.slice(10, 20).close.shape == (10,)
    np.testing.assert_array_equal(mine.timestamp, ref.from_dict(d).timestamp)


def test_cli_backtest_on_the_cpu(tmp_path, monkeypatch, capsys):
    import json

    from ai_crypto_trader_tpu_torch import cli

    monkeypatch.chdir(tmp_path)
    cli.main(["backtest", "--days", "1", "--sweep", "8", "--device", "cpu"])
    out = capsys.readouterr().out
    summary = json.loads(out[:out.rindex("}") + 1])
    assert summary["total_trades"] >= 0 and summary["candles_per_sec"] > 0
    (saved,) = (tmp_path / "backtesting" / "results").iterdir()
    result = json.loads(saved.read_text())
    assert result["sweep_size"] == 8 and result["device"] == "cpu"
    assert np.isfinite(result["sharpe_ratio"])


def test_gate_vocabulary_is_the_jax_package_vocabulary():
    """Gate ids are positions in GATES and live in journaled records: the
    port's copy must keep the JAX package's order."""
    from ai_crypto_trader_tpu.obs import flightrec as ref
    from ai_crypto_trader_tpu_torch.obs import flightrec

    assert flightrec.GATES == ref.GATES
    assert flightrec.VETO_ORDER == ref.VETO_ORDER


@pytest.mark.parametrize("name", ["TradingParams", "TrailingStopParams",
                                  "SocialRiskParams", "MonteCarloParams", "GAParams",
                                  "EvolutionParams", "LLMParams"])
def test_config_defaults_are_the_jax_package_defaults(name):
    import dataclasses

    from ai_crypto_trader_tpu import config as ref
    from ai_crypto_trader_tpu_torch import config

    mine, theirs = getattr(config, name)(), getattr(ref, name)()
    assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
    assert [f.name for f in dataclasses.fields(mine)] == \
        [f.name for f in dataclasses.fields(theirs)]


def _unroll_case(fn_name):
    inp = prepare_inputs(compute_indicators(_small(), device="cpu"), device="cpu")
    if fn_name == "sweep":
        params = sample_params(torch.Generator().manual_seed(1), 4, device="cpu")
        return lambda **kw: sweep(inp, params, device="cpu", **kw)
    stacked, _ = stack_symbol_inputs({"A": _small(), "B": _small()}, device="cpu")
    return lambda **kw: shared_capital_backtest(stacked, max_positions=1,
                                                min_signal_strength=40.0,
                                                device="cpu", **kw)[0]


@pytest.mark.parametrize("fn_name", ["sweep", "shared_capital_backtest"])
def test_jax_signature_keywords_unroll_and_partitioner(fn_name):
    """`unroll` (a `lax.scan` knob) is accepted and changes no bit; `sweep`
    takes `partitioner=None`, the single-device seam and the port's
    MeshPartitioner alike, and refuses a foreign object."""
    run = _unroll_case(fn_name)
    base, unrolled = run(), run(unroll=8)
    for f in base._fields:
        a, b = getattr(base, f), getattr(unrolled, f)
        assert a.dtype == b.dtype and torch.equal(a.view(-1), b.view(-1)), f
    if fn_name == "sweep":
        for partitioner in (None, get_partitioner()):
            for f, v in run(partitioner=partitioner)._asdict().items():
                assert torch.equal(v, getattr(base, f)), f
        mesh = MeshPartitioner(make_mesh(3, devices=["cpu"] * 3))
        for f, v in run(partitioner=mesh)._asdict().items():
            assert torch.equal(v, getattr(base, f)), f
        with pytest.raises(TypeError, match="not a partitioner"):
            run(partitioner=object())


def _mesh_partitioner():
    """The JAX package's partitioner over a one-device mesh: a foreign
    object to the port."""
    import jax

    from ai_crypto_trader_tpu.parallel.partitioner import MeshPartitioner

    return MeshPartitioner(jax.sharding.Mesh(np.array(jax.devices()[:1]), ("data",)))


_SEAM_CASES = {
    "sweep": lambda p: sweep(
        prepare_inputs(compute_indicators(_small(), device="cpu"), device="cpu"),
        default_params((2,), device="cpu"), partitioner=p, device="cpu").total_trades,
    "optimize_hyperparameters": lambda p: optimize_hyperparameters(
        torch.Generator(), np.linspace(1, 2, 400, dtype=np.float32)[:, None].repeat(5, 1),
        n_trials=1, rung_epochs=(1, 1), seq_len=8, partitioner=p, device="cpu")["best_val_loss"],
    "TenantEngine": lambda p: TenantEngine(["BTCUSDC"], 4, partitioner=p, device="cpu").S,
    "evaluate_structures": lambda p: evaluate_structures(
        [fold_features(_small(), device="cpu")], [default_seed()], partitioner=p,
        device="cpu").tolist(),
    "run_ga": lambda p: run_ga(torch.Generator().manual_seed(0),
                               backtest_fitness(_small(), device="cpu"),
                               GAParams(population_size=4, generations=1),
                               partitioner=p, device="cpu")[1],
}


@pytest.mark.parametrize("entry", sorted(_SEAM_CASES))
def test_partitioner_seam_takes_the_single_device_partitioner(entry):
    """`get_partitioner()`'s single-device seam and the port's
    MeshPartitioner (3 CPU shards) run as None does; the JAX package's
    partitioner, a foreign object, and a foreign mesh for
    `get_partitioner`, raise."""
    run = _SEAM_CASES[entry]
    a, b = run(None), run(get_partitioner())
    c = run(MeshPartitioner(make_mesh(3, devices=["cpu"] * 3)))
    for other in (b, c):
        assert (torch.equal(a, other) if torch.is_tensor(a) else a == other)
    for foreign in (object(), _mesh_partitioner()):
        with pytest.raises(TypeError, match="not a partitioner"):
            run(foreign)
    with pytest.raises(TypeError, match="Mesh"):
        get_partitioner(mesh=object())
