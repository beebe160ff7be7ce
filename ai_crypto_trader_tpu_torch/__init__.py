"""PyTorch/CUDA port of ai_crypto_trader_tpu's population backtest, GA,
live tick and decision path, portfolio backtest, risk layer, Monte-Carlo
engine, price-model zoo and chart-pattern classifier (training and
serving), RL trainer (the DQN, the simulated markets, the PBT fleet),
the live signal path (bus, paper exchange, monitor, analyzer, executor,
scanner), the trading system that wires it into one process with its
observability rim (flight recorder, alerts, health, supervision,
saturation, structured log, PnL attribution, dashboard), and the full
service roster around it (social, news, patterns, regime, nn, evolver,
generator, grid and DCA; the social provider and strategy integrator;
triangle arbitrage), the streamed market path (the kline-frame stream and
its supervisor) and the load harness (synthetic tenant traffic, the
capacity ramp, the chaos harness).

The chains, module for module after the JAX package:

    data.generate_ohlcv → ops.compute_indicators → backtest.prepare_inputs
        → backtest.sweep → backtest.compute_metrics
    data.generate_ohlcv → evolve.backtest_fitness (backtest.evolvable's
        period tables over ops.dynamic) → evolve.run_ga
    kline windows → ops.TickEngine.ingest → TickEngine.step (indicators,
        signals, volume profile, combinations, drift; one host read)
    per-symbol candles → backtest.stack_symbol_inputs
        → backtest.portfolio_backtest (silos or one shared pool)
    TickEngine.last_out → ops.TenantEngine.feats_from_tick
        → TenantEngine.decide (every tenant's gates and sizes, lane
        containment, obs.fleetscope aggregates; one host read)
    returns → mc.run_simulation / risk.stress_var_cvar (GBM or bootstrap
        paths, VaR / CVaR); risk.stops, risk.social, risk.var
    features → models.predict_prices_batched (the zoo's nine architectures,
        N models of one architecture as one vmapped program; one host read)
    features → models.train_model (models.train_loop.EpochTrainer: the
        epoch's batches, the LSTM's hand-written backward and Adam on the
        device, one host read an epoch) → models.predict_prices(_batched);
        models.optimize_hyperparameters, models.feature_importance and
        models.service.PredictionService over them
    ohlcv → patterns.detect_patterns (CNN / LSTM / CNN-LSTM over every
        overlapping window; one host read)
    patterns.generate_dataset → patterns.train_pattern_model
        → patterns.detect_patterns
    sim.paths / sim.lob markets → sim.engine.scenario_env_params
        (rl.pbt_env_params) → rl.train_pbt (the DQN fleet over a member axis,
        rl.population's exchange on the card; one host read a generation);
        indicators → rl.make_env_params → rl.train_dqn
    shell.FakeExchange → shell.ResilientExchange → shell.MarketMonitor.poll
        (the TickEngine; one host read) → shell.EventBus (market_updates)
        → shell.SignalAnalyzer → shell.TradeExecutor (float32 sizing and
        trailing stops on the device; journal and recovery on the host)
    exchange klines → shell.scanner.MarketScanner.scan (score_pairs over
        [P, T] on the device; one host read) — `cli scan`
    shell.launcher.TradingSystem.tick: the monitor → analyzer → executor
        stages under utils.supervision, then obs.flightrec /
        obs.attribution / obs.scorecard, the risk block (risk.var on the
        device; one host read of its four figures, one of the correlation
        matrix), utils.alerts, utils.saturation, shell.dashboard —
        `cli trade --paper`, and `cli why` over the flight recorder's file
    shell.stack.build_full_stack: the nine cadence services on the
        system's device, run after the stages every tick (social.service's
        anomaly model and reports on the device, one read a poll;
        risk.social over its snapshot in the executor) — `cli trade
        --paper --full-stack`
    daily social metrics → social.SocialDataProvider.social_inputs →
        backtest.evolvable (the social vote axis); tickers →
        strategy.find_triangle_arbitrage (the n³ cycle products, one read)
    kline frames → shell.stream.StreamSupervisor → MarketStream (candle
        books, TickEngine.ingest_row) → MarketMonitor.poll with the books
        as its kline source (one step, one read, no REST fetch in steady
        state) — TradingSystem.attach_stream; testing.loadgen.run_load /
        ramp drive it with N tenants (TenantEngine.decide) — `cli load`,
        `cli fleet`

Plain tensor code is PyTorch; the two Pallas kernels of the JAX package on
these paths are CUDA C++ kernels for Hopper (``csrc/``), built with nvcc on
first use and loaded with ctypes (``ops/_cuda.py``).  The models' matmuls,
convolutions and training (autograd, the port's Adam) are PyTorch's, as the
JAX package computes them outside any Pallas kernel.  Entry points run on
the CUDA card unless called with ``device="cpu"``
(``device.resolve_device``).  Arithmetic is float32
throughout: TF32 is switched off here, once, for matmuls and for cuDNN's
convolutions, so the card's outputs can be held to the CPU's.
"""

import torch

from ai_crypto_trader_tpu_torch.device import resolve_device  # noqa: F401

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
