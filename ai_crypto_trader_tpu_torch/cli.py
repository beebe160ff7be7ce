"""Command-line interface of the port: the JAX package's 21 subcommands,
``fetch``, ``backtest``, ``list``, ``analyze``, ``report``, ``train``,
``evolve``, ``rl``, ``generate``, ``mc``, ``scan``, ``trade``, ``why``,
``profile``, ``load``, ``mesh``, ``fleet``, ``latency``, ``status``,
``registry`` and ``dashboard``.

Same flags and output as ``python -m ai_crypto_trader_tpu.cli fetch`` /
``backtest`` / ... / ``dashboard``, plus ``--device {cuda,cpu}`` (default
cuda) where a command computes:

    python -m ai_crypto_trader_tpu_torch.cli fetch --symbol BTCUSDC --days 30
    python -m ai_crypto_trader_tpu_torch.cli backtest --days 365 --sweep 4096
    python -m ai_crypto_trader_tpu_torch.cli list
    python -m ai_crypto_trader_tpu_torch.cli analyze --file <result.json>
    python -m ai_crypto_trader_tpu_torch.cli report --symbol BTCUSDC --out report.html
    python -m ai_crypto_trader_tpu_torch.cli train --days 7 --model lstm --epochs 5
    python -m ai_crypto_trader_tpu_torch.cli evolve --days 30 --population 256 --generations 3
    python -m ai_crypto_trader_tpu_torch.cli rl --population 8 --dynamics lob
    python -m ai_crypto_trader_tpu_torch.cli generate --days 7 --registry registry.json
    python -m ai_crypto_trader_tpu_torch.cli scan --pairs 64 --top 10
    python -m ai_crypto_trader_tpu_torch.cli trade --paper --ticks 100 --flightrec decisions.jsonl
    python -m ai_crypto_trader_tpu_torch.cli trade --paper --full-stack --registry models/registry.json
    python -m ai_crypto_trader_tpu_torch.cli why BTCUSDC --file decisions.jsonl
    python -m ai_crypto_trader_tpu_torch.cli load --vmapped --tenants 256 --symbols 4 --ramp
    python -m ai_crypto_trader_tpu_torch.cli fleet --tenants 8 --symbols 4
    python -m ai_crypto_trader_tpu_torch.cli trade --paper --serve 8050 --devprof --meshprof
    python -m ai_crypto_trader_tpu_torch.cli status --url http://127.0.0.1:8050
    python -m ai_crypto_trader_tpu_torch.cli profile --ticks 10 --out profiles/x

``fetch`` writes ``--days`` of 1-minute candles to the CSV cache
``backtesting/data/market/<symbol>/<symbol>_1m.csv``: the deterministic
synthetic series by default, Binance's paginated klines with ``--source
binance``.  A CSV there is used when present; otherwise the synthetic
series is generated.  ``list``, ``analyze --file`` and ``report`` read the
results that ``backtest`` saves under ``backtesting/results/``: one line a
run, one run's JSON, and the multi-run summary with its HTML report (the
best run's equity and drawdown curves).
``--sweep N`` (N > 1) sweeps N strategies drawn from a ``torch.Generator``
seeded with ``--seed`` through the replay kernel and reports the best by
Sharpe; otherwise one default-parameter backtest runs with its equity curve.
``train`` builds the indicator table, takes its seven feature columns
(close, volume, RSI, MACD, Bollinger position, %K, ATR), trains a model of
the zoo on them with its draws from a ``torch.Generator`` seeded with
``--seed`` and predicts the next close.  ``evolve`` runs the GA with
backtest fitness over the candles, seeded with the default parameters as
individual 0, its draws from a ``torch.Generator`` seeded with ``--seed``,
and prints the history and the best parameters.  ``rl`` PBT-trains a DQN
fleet inside simulated markets (order-flow book or GBM), the markets and
the fleet each drawn from a ``torch.Generator`` seeded with ``--seed``, and
prints the generation table and the final fleet; ``--checkpoint`` journals
the fleet every ``--checkpoint-every`` generations, ``--resume`` continues
from a journal's newest intact checkpoint (draw streams included), and
``--registry`` registers the winner through the scorecard's adoption gate.
``generate`` searches strategy structures (rule compositions) with
cross-validated backtests, registers each improvement in ``--registry``
and prints the held-out comparison of the seed and the best structure.
``scan`` synthesizes a universe of ``--pairs`` pairs with varied
volatility/volume profiles behind the paper exchange, scores every pair in
one pass on ``--device`` and prints the ranked table and its JSON.
``trade --paper`` runs the trading system (`shell.launcher.TradingSystem`)
for ``--ticks`` candles on a synthetic series behind the paper exchange,
on a virtual clock every layer shares, and prints its final status JSON;
``--journal`` makes its books crash-safe (an existing journal is replayed
and reconciled first), ``--flightrec`` keeps the decision provenance that
``why SYMBOL --file PATH`` prints.  ``--full-stack`` registers the
reference's whole roster of cadence services (`shell.stack.build_full_stack`:
social, news, patterns, regime, nn, evolver, generator, grid, dca) on the
system's device, versioned in ``--registry``.  ``load`` drives N
synthetic tenant lanes over an S-symbol universe through the streamed
market path (`testing.loadgen`: recorded kline frames → the stream
supervisor → the monitor's tick engine → the tenant layer) and prints the
latency and saturation report; ``--ramp`` steps the tenants up until the
p99 tick latency breaches ``--slo-ms``.  ``fleet`` renders the fleet
observatory's view of a short local vmapped load burst.  ``trade --serve
PORT`` serves the live dashboard (`shell.dashboard_server`) during the run,
``--devprof`` / ``--meshprof`` switch on the device-runtime and mesh
observatories, ``--aot-cache DIR`` keeps the kernel libraries in a
persistent provenance-keyed cache.  ``profile`` captures a
``torch.profiler`` trace of a short paper burst; ``mesh``, ``latency``,
``status`` and ``fleet`` with ``--url`` read a live server's
``/state.json``.  A card command (``--device cuda``) builds and loads its
kernel libraries in the provenance-keyed directory under
``.torch_kernels/`` (`utils.cache`).
"""

from __future__ import annotations

import argparse
import asyncio
import glob
import json
import os
import time

import numpy as np
import torch

RESULTS_DIR = "backtesting/results"
DATA_DIR = "backtesting/data"


def _load_or_generate(symbol: str, candles: int, seed: int = 0):
    from ai_crypto_trader_tpu_torch.data import generate_ohlcv, load_csv

    path = os.path.join(DATA_DIR, "market", symbol, f"{symbol}_1m.csv")
    if os.path.exists(path):
        return load_csv(path, symbol=symbol).as_dict()
    return {k: v for k, v in generate_ohlcv(n=candles, seed=seed).items()
            if k != "regime"}


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def cmd_fetch(args):
    """`run_backtest.py fetch` parity. --source binance runs the real
    paginated fetch (`data_manager.py:47-114` semantics) over the network;
    the default synthesizes."""
    from ai_crypto_trader_tpu_torch.data import from_dict, generate_ohlcv, save_csv

    n = args.days * 1440
    if args.source == "binance":
        from ai_crypto_trader_tpu_torch.data.fetchers import (
            UrllibTransport,
            fetch_klines_ohlcv,
        )

        end_ms = int(time.time() * 1000)
        series = asyncio.run(fetch_klines_ohlcv(
            UrllibTransport(), args.symbol, "1m",
            end_ms - args.days * 86_400_000, end_ms))
        n = len(series)
    else:
        d = generate_ohlcv(n=n, seed=args.seed)
        series = from_dict({k: v for k, v in d.items() if k != "regime"},
                           symbol=args.symbol, interval="1m")
    path = save_csv(series, DATA_DIR)
    print(f"saved {n} candles -> {path}")


def cmd_backtest(args):
    from ai_crypto_trader_tpu_torch import ops, resolve_device
    from ai_crypto_trader_tpu_torch.backtest import (
        compute_metrics, default_params, prepare_inputs, run_backtest,
        sample_params, sweep,
    )

    dev = resolve_device(args.device)
    d = _load_or_generate(args.symbol, args.days * 1440, args.seed)
    ind = ops.compute_indicators(d, device=dev)
    inp = prepare_inputs(ind, device=dev)

    _sync(dev)
    t0 = time.perf_counter()
    if args.sweep > 1:
        params = sample_params(torch.Generator().manual_seed(args.seed),
                               args.sweep, device=dev)
        stats = sweep(inp, params, device=dev)
        _sync(dev)
        metrics = compute_metrics(stats, device=dev)
        best = int(torch.argmax(metrics["sharpe_ratio"]))
        result = {k: float(v[best]) for k, v in metrics.items()}
        result["sweep_size"] = args.sweep
        result["best_index"] = best
    else:
        stats, curve = run_backtest(inp, default_params(device=dev),
                                    use_param_sl_tp=True, return_curve=True,
                                    device=dev)
        _sync(dev)
        result = {k: float(v) for k, v in compute_metrics(stats, device=dev).items()}
        # downsampled realized-equity curve for `report` plots
        c = curve.cpu().numpy()
        step = max(len(c) // 500, 1)
        result["equity_curve"] = [round(float(v), 2) for v in c[::step]]
    dt = time.perf_counter() - t0
    n_candles = int(np.shape(d["close"])[0]) * max(args.sweep, 1)
    result.update({"symbol": args.symbol, "interval": "1m",
                   "candles_per_sec": n_candles / dt, "wall_s": dt,
                   "strategy": "evolvable_default" if args.sweep <= 1 else "sweep",
                   "device": dev.type})

    os.makedirs(RESULTS_DIR, exist_ok=True)
    fname = os.path.join(
        RESULTS_DIR,
        f"torch_{dev.type}_{args.symbol}_1m_{time.strftime('%Y%m%d_%H%M%S')}.json")
    with open(fname, "w") as f:
        json.dump(result, f, indent=2)
    print(json.dumps({k: v for k, v in result.items()
                      if k in ("final_balance", "total_trades", "win_rate",
                               "sharpe_ratio", "max_drawdown_pct",
                               "candles_per_sec")}, indent=2))
    print(f"saved -> {fname}")


def cmd_list(args):
    files = sorted(glob.glob(os.path.join(RESULTS_DIR, "*.json")))
    if not files:
        print("no results yet — run `backtest` first")
    for f in files:
        with open(f) as fh:
            r = json.load(fh)
        print(f"{os.path.basename(f)}: sharpe={r.get('sharpe_ratio', 0):.2f} "
              f"trades={r.get('total_trades', 0)} "
              f"final=${r.get('final_balance', 0):,.2f}")


def cmd_analyze(args):
    with open(args.file) as f:
        r = json.load(f)
    print(json.dumps(r, indent=2))


def cmd_report(args):
    from ai_crypto_trader_tpu_torch.backtest.results import (
        load_results, render_report_html, summary_report,
    )

    results = load_results(RESULTS_DIR, symbol=args.symbol or None)
    summary = summary_report(results)
    print(json.dumps(summary, indent=2))
    if results:
        # best run's saved equity curve drives the report plots
        best = next((r for r in results
                     if r.get("_file") == summary.get("best_run")), results[0])
        eq = best.get("equity_curve")
        dd = None
        if eq:
            eq_arr = np.asarray(eq, float)
            peak = np.maximum.accumulate(eq_arr)
            dd = (peak - eq_arr) / peak * 100.0
        path = render_report_html(results, args.out,
                                  equity_curve=eq, drawdown_curve=dd)
        print(f"wrote {path}")


TRAIN_COLUMNS = ("close", "volume", "rsi", "macd", "bb_position", "stoch_k", "atr")


def cmd_train(args):
    from ai_crypto_trader_tpu_torch import ops, resolve_device
    from ai_crypto_trader_tpu_torch.models import predict_prices, train_model

    dev = resolve_device(args.device)
    d = _load_or_generate(args.symbol, args.days * 1440, args.seed)
    ind = ops.compute_indicators(d, device=dev)
    feats = torch.stack([ind[k] for k in TRAIN_COLUMNS], dim=1).cpu().numpy()
    r = train_model(torch.Generator(device=dev).manual_seed(args.seed), feats, args.model,
                    seq_len=args.seq_len, epochs=args.epochs, batch_size=args.batch_size,
                    precision=args.precision, verbose=True, device=dev)
    pred = predict_prices(r, feats, seq_len=args.seq_len, device=dev)
    print(json.dumps({"model": args.model, "best_val_loss": r.best_val_loss,
                      "epochs_run": r.epochs_run,
                      "predicted_price": float(np.ravel(pred["predicted_price"])[0]),
                      "confidence": pred["confidence"]}, indent=2))


def _partitioner(dev):
    """The population seam of a card command: on CUDA `get_partitioner()`
    (a mesh of every visible card when there are several); on the CPU the
    single device."""
    from ai_crypto_trader_tpu_torch.parallel import SingleDevicePartitioner, get_partitioner

    return get_partitioner() if dev.type == "cuda" else SingleDevicePartitioner()


def cmd_evolve(args):
    from ai_crypto_trader_tpu_torch import resolve_device
    from ai_crypto_trader_tpu_torch.backtest import default_params
    from ai_crypto_trader_tpu_torch.config import GAParams
    from ai_crypto_trader_tpu_torch.evolve import backtest_fitness, run_ga

    dev = resolve_device(args.device)
    d = _load_or_generate(args.symbol, args.days * 1440, args.seed)
    cfg = GAParams(population_size=args.population, generations=args.generations)
    partitioner = _partitioner(dev)
    best, hist = run_ga(torch.Generator(device=dev).manual_seed(args.seed),
                        backtest_fitness(d, device=dev), cfg,
                        seed_params=default_params(device=dev), partitioner=partitioner,
                        device=dev)
    print(json.dumps({"history": hist,
                      "devices": getattr(partitioner, "device_count", 1), "device": dev.type,
                      "best_params": {k: float(v) for k, v in
                                      best._asdict().items()}}, indent=2))


def cmd_rl(args):
    """Population-based RL inside the simulated markets: the JAX package's
    `cli rl` table, trained on ``--device``; ``--checkpoint`` journals the
    fleet, ``--resume`` continues from the newest intact checkpoint and
    ``--registry`` gates the winner into a model registry."""
    from ai_crypto_trader_tpu_torch import resolve_device
    from ai_crypto_trader_tpu_torch.rl import (
        DQNConfig, PBTConfig, adopt_winner, obs_size, pbt_env_params, train_pbt)

    dev = resolve_device(args.device)
    env, _labels = pbt_env_params(torch.Generator(device=dev).manual_seed(args.seed),
                                  num_scenarios=args.scenarios, steps=args.steps,
                                  episode_len=args.episode_len, dynamics=args.dynamics,
                                  device=dev)
    cfg = DQNConfig(state_size=obs_size(env), num_envs=args.envs, rollout_len=args.rollout,
                    replay_capacity=2048, batch_size=32)
    pcfg = PBTConfig(population=args.population, generations=args.generations,
                     iters_per_generation=args.iters)
    partitioner = _partitioner(dev)

    # --resume: the fleet and its draw streams from the newest intact
    # checkpoint, on the absolute generation counter — the run goes on as
    # one that never died would; drift is refused by restore_checkpoint
    init_pop, start_gen, prior_history = None, 0, []
    if args.resume:
        from ai_crypto_trader_tpu_torch.rl import load_checkpoint, restore_checkpoint

        payload, stats = load_checkpoint(args.resume)
        if payload is None:
            raise SystemExit(
                f"no intact checkpoint in {args.resume} "
                f"(corrupt_records={stats['corrupt_records']}, "
                f"torn_tail={stats['torn_tail']})")
        init_pop = restore_checkpoint(payload, cfg, pcfg, env)
        start_gen = int(payload["generation"])
        prior_history = list(payload.get("history") or [])

    # --checkpoint: the fleet journaled every N generations through the
    # trainer service's codec
    on_generation, journal = None, None
    full_history = list(prior_history)
    if args.checkpoint:
        from ai_crypto_trader_tpu_torch.rl.trainer_service import (
            PBT_CHECKPOINT_KIND, checkpoint_payload)
        from ai_crypto_trader_tpu_torch.utils.journal import SnapshotJournal

        journal = SnapshotJournal(args.checkpoint, kind=PBT_CHECKPOINT_KIND)

        def on_generation(g, pop, row):
            full_history.append(row)
            if (g + 1) % max(args.checkpoint_every, 1) == 0:
                journal.write(checkpoint_payload(
                    pop, generation=g + 1, cfg=cfg, pcfg=pcfg, seed=args.seed,
                    history=full_history))

    res = train_pbt(torch.Generator(device=dev).manual_seed(args.seed), env, cfg, pcfg,
                    partitioner=partitioner, init_pop=init_pop, start_generation=start_gen,
                    on_generation=on_generation)
    if journal is not None:
        journal.close()

    print(f"population={pcfg.population} devices={partitioner.device_count} "
          f"dynamics={args.dynamics} scenarios={args.scenarios}")
    if args.resume:
        print(f"resumed@gen={start_gen} from {args.resume} "
              f"({len(prior_history)} prior generations)")
    # 'src': ckpt rows come from the resumed checkpoint's history, live
    # rows were trained by this process
    print(f"{'gen':>3} {'src':>4} {'best':>9} {'mean':>9} {'exploited':>9} "
          f"{'quar':>4} {'loss':>9}")
    for h in prior_history + res.history:
        src = "ckpt" if h["generation"] < start_gen else "live"
        print(f"{h['generation']:>3} {src:>4} {h['best_fitness']:>9.4f} "
              f"{h['mean_fitness']:>9.4f} {h['n_exploited']:>9} "
              f"{h.get('n_quarantined', 0):>4} {h['loss']:>9.4f}")
    last = res.history[-1]
    hy = last["hypers"]
    print("\nfinal fleet (* = winner; 'from' = PBT lineage, the member "
          "this slot last copied):")
    print(f"{'member':>6} {'fitness':>9} {'from':>5} {'lr':>9} "
          f"{'gamma':>7} {'eps_decay':>10} {'eps_min':>8} {'sync':>5}")
    for i in range(pcfg.population):
        star = "*" if i == res.best_member else " "
        print(f"{i:>5}{star} {last['fitness'][i]:>9.4f} "
              f"{last['lineage'][i]:>5} "
              f"{hy['learning_rate'][i]:>9.2e} {hy['gamma'][i]:>7.4f} "
              f"{hy['epsilon_decay'][i]:>10.5f} "
              f"{hy['epsilon_min'][i]:>8.4f} "
              f"{int(hy['target_sync_every'][i]):>5}")
    if args.registry:
        from ai_crypto_trader_tpu_torch.obs import Scorecard
        from ai_crypto_trader_tpu_torch.strategy import ModelRegistry

        out = adopt_winner(res, ModelRegistry(path=args.registry), Scorecard())
        print(f"\nregistered {out['version']} "
              f"({'ACTIVE' if out['adopted'] else 'SHADOW'}: "
              f"{out['reason']}) fitness={out['fitness']:.4f}")


def cmd_generate(args):
    """Strategy-structure generation (`ai_strategy_evaluator.py:732`):
    search rule compositions with real CV backtests on ``--device``,
    register improvements, report the held-out comparison."""
    import asyncio

    from ai_crypto_trader_tpu_torch import resolve_device
    from ai_crypto_trader_tpu_torch.strategy.generator import StrategyGenerator
    from ai_crypto_trader_tpu_torch.strategy.registry import ModelRegistry

    dev = resolve_device(args.device)
    d = _load_or_generate(args.symbol, args.days * 1440, args.seed)
    reg = ModelRegistry(path=args.registry)
    gen = StrategyGenerator(registry=reg, cv_folds=args.folds,
                            pool_size=args.pool, max_rounds=args.rounds,
                            seed=args.seed, partitioner=_partitioner(dev), device=dev)
    out = asyncio.run(gen.generate(d))

    def finite(x):
        # -inf marks a never-trading structure; json.dumps would print an
        # invalid `-Infinity` for it
        return float(x) if np.isfinite(x) else None

    print(json.dumps({
        "best_structure": out["structure"].to_payload(),
        "cv_sharpe": finite(out["cv_sharpe"]),
        "seed_cv_sharpe": finite(out["seed_cv_sharpe"]),
        "holdout_sharpe_seed": finite(out["holdout_sharpe_seed"]),
        "holdout_sharpe_best": finite(out["holdout_sharpe_best"]),
        "versions": out["versions"], "rounds": out["rounds"],
    }, indent=2))


def cmd_scan(args):
    """Market-wide pair discovery + ranking (CryptoScanner.scan_market,
    `binance_ml_strategy.py:293-468`). Paper mode synthesizes a universe of
    pairs with varied volatility/volume profiles; a live run would inject a
    real client behind the same adapter."""
    from ai_crypto_trader_tpu_torch import resolve_device
    from ai_crypto_trader_tpu_torch.data.ingest import from_dict
    from ai_crypto_trader_tpu_torch.data.synthetic import generate_ohlcv
    from ai_crypto_trader_tpu_torch.shell.exchange import make_exchange
    from ai_crypto_trader_tpu_torch.shell.scanner import MarketScanner

    dev = resolve_device(args.device)
    n_hist = args.lookback + 8
    series = {}
    for i in range(args.pairs):
        sym = f"A{i:03d}USDC"
        d = generate_ohlcv(
            n=n_hist, seed=args.seed + i, s0=100.0 * (1 + i),
            base_vol=0.0004 * (1 + (i % 9)),
            base_volume=40.0 * (1 + (i % 13)))
        series[sym] = from_dict({k: v for k, v in d.items() if k != "regime"},
                                symbol=sym)
    ex = make_exchange("fake", series=series)
    ex.advance(steps=n_hist)
    sc = MarketScanner(ex, lookback=args.lookback, top_k=args.top, device=dev)
    ranked = sc.scan()
    print(f"{'symbol':<12}{'score':>8}{'vol':>9}{'qvol':>14}"
          f"{'strength':>10}{'chg%':>8}")
    for o in ranked:
        print(f"{o['symbol']:<12}{o['score']:>8.3f}{o['volatility']:>9.4f}"
              f"{o['quote_volume']:>14,.0f}{o['strength']:>10.1f}"
              f"{o['change_pct']:>8.2f}")
    print(json.dumps({"discovered": len(series), "ranked": ranked}))


def cmd_mc(args):
    """Monte-Carlo risk simulation on ``--device``: the five scenarios'
    expected move, VaR/CVaR, profit probability and mean drawdown, each
    from a ``torch.Generator`` seeded with ``--seed``."""
    from ai_crypto_trader_tpu_torch import mc as mc_mod
    from ai_crypto_trader_tpu_torch import resolve_device

    dev = resolve_device(args.device)
    d = _load_or_generate(args.symbol, args.days * 1440 + 1000, args.seed)
    close = np.asarray(d["close"])
    rets = np.diff(np.log(close))[-2000:]
    out = {}
    for scenario in ("base", "bull", "bear", "volatile", "crab"):
        sim = mc_mod.run_simulation(torch.Generator(device=dev).manual_seed(args.seed),
                                    float(close[-1]), rets, days=args.days,
                                    num_sims=args.paths, scenario=scenario, device=dev)
        out[scenario] = {
            "expected_pct": float(sim["expected_pct_change"]),
            "var": abs(float(sim["var"])), "cvar": abs(float(sim["cvar"])),
            "prob_profit": float(sim["prob_profit"]),
            "max_dd_mean": float(sim["max_drawdown_mean"]),
        }
    print(json.dumps(out, indent=2))


def cmd_trade(args):
    from ai_crypto_trader_tpu_torch.data.ingest import from_dict
    from ai_crypto_trader_tpu_torch.data.synthetic import generate_ohlcv
    from ai_crypto_trader_tpu_torch.shell.exchange import make_exchange
    from ai_crypto_trader_tpu_torch.shell.launcher import TradingSystem

    if not args.paper:
        print("live trading requires an injected exchange client; "
              "use --paper in this environment")
        return
    d = generate_ohlcv(n=args.ticks + 600, seed=args.seed)
    series = from_dict({k: v for k, v in d.items() if k != "regime"},
                       symbol=args.symbol)
    clock = {"t": 0.0}                   # virtual clock shared by all layers
    # Paper mode rides the same resilient adapter seam as live trading
    # (breaker + rate limit + retries around every exchange call), on the
    # virtual clock so rate limiting never sleeps real wall-clock time.
    ex = make_exchange(
        "fake", resilient=True,
        resilient_opts={"now_fn": lambda: clock["t"],
                        "sleep": lambda s: clock.__setitem__("t", clock["t"] + s)},
        series={args.symbol: series}, quote_balance=10_000.0)
    ex.advance(args.symbol, steps=600)   # warm history so the monitor has a
    #                                      full fixed-shape indicator window
    resume = bool(args.journal) and os.path.exists(args.journal)
    system = TradingSystem(ex, [args.symbol], now_fn=lambda: clock["t"],
                           dashboard_path=args.dashboard,
                           log_path=os.environ.get("LOG_PATH"),
                           enable_tracing=bool(args.trace_jsonl),
                           trace_jsonl=args.trace_jsonl,
                           journal_path=args.journal,
                           enable_devprof=args.devprof,
                           enable_meshprof=args.meshprof,
                           enable_fleetscope=args.fleetscope,
                           flightrec_path=args.flightrec,
                           pipelined=args.pipelined,
                           precision=args.precision,
                           aot_cache_dir=args.aot_cache,
                           device=args.device)
    if args.full_stack:
        from ai_crypto_trader_tpu_torch.shell.stack import build_full_stack
        from ai_crypto_trader_tpu_torch.strategy.registry import ModelRegistry

        registry = ModelRegistry(path=args.registry)
        system.registry = registry
        names = [s.name for s in build_full_stack(
            system, registry=registry, grid_symbol=args.symbol,
            dca_symbol=args.symbol)]
        print(f"full stack: {', '.join(names)}", flush=True)

    server = None
    if args.serve is not None:
        from ai_crypto_trader_tpu_torch.shell.dashboard_server import DashboardServer

        server = DashboardServer(system, port=args.serve).start()
        print(f"dashboard: http://127.0.0.1:{server.port}/", flush=True)
    if system.aot_cache is not None:
        print(json.dumps({"aot_cache": system.aot_cache.status()}), flush=True)

    metrics_port = int(os.environ.get("METRICS_PORT", "0"))

    async def go():
        msrv = None
        if resume:
            # crash/restart recovery: replay the write-ahead journal, then
            # reconcile the books against the exchange before trading
            report = await system.recover()
            print(json.dumps({"recovered": {
                k: v for k, v in report.items() if k != "journal"}},
                default=str), flush=True)
        if metrics_port:
            # Prometheus scrape target
            msrv = await system.metrics.serve("0.0.0.0", metrics_port)
            print(f"metrics: http://127.0.0.1:{metrics_port}/metrics",
                  flush=True)
        try:
            for _ in range(args.ticks):
                ex.advance(args.symbol)
                clock["t"] += 60.0
                await system.tick()
                # tick()'s awaits all complete synchronously (in-process
                # bus), so without an explicit suspension the loop never
                # schedules the metrics server's connection handlers
                await asyncio.sleep(0)
            # pipelined tick path: the last dispatch is still in flight —
            # drain it so its decisions publish before the status dump
            await system.monitor.flush_pipeline()
        finally:
            if msrv is not None:
                msrv.close()
        print(json.dumps(system.status(), indent=2, default=str))

    try:
        asyncio.run(go())
        if server is not None and args.serve_hold_s > 0:
            time.sleep(args.serve_hold_s)
    finally:
        if server is not None:
            server.stop()
        system.shutdown()          # deactivate tracer + close span JSONL


def cmd_why(args):
    """Decision provenance for one symbol (obs/flightrec.py): the last N
    decisions with their rejecting gate or execution chain
    (signal → client_order_id → fill → closure PnL) plus the structured
    explanation narrative.  Reads the checksummed decision JSONL a run
    wrote (`trade --flightrec PATH`), or queries a live dashboard server's
    /decisions endpoint with --url.  `--lane N` filters to one vmapped
    tenant lane's sampled provenance.  Host code; ``--device`` is held
    like every subcommand's (cuda without a card raises)."""
    from ai_crypto_trader_tpu_torch import resolve_device
    from ai_crypto_trader_tpu_torch.obs.flightrec import format_why, load_decisions

    resolve_device(args.device)

    if args.url:
        import urllib.parse
        import urllib.request

        params = {"symbol": args.symbol, "limit": args.last}
        if args.lane is not None:
            params["lane"] = args.lane
        query = urllib.parse.urlencode(params)
        with urllib.request.urlopen(f"{args.url}/decisions?{query}",
                                    timeout=10) as resp:
            records = json.loads(resp.read())
    else:
        if not os.path.exists(args.file):
            print(f"no decision journal at {args.file} — run "
                  f"`trade --paper --flightrec {args.file}` first, "
                  f"or query a live server with --url")
            return
        records, stats = load_decisions(args.file)
        records = [r for r in records if r.get("symbol") == args.symbol]
        if args.lane is not None:
            records = [r for r in records if r.get("lane") == args.lane]
        records = list(reversed(records[-args.last:]))
        if stats.get("corrupt_records") or stats.get("torn_tail"):
            print(f"(journal: {stats['corrupt_records']} corrupt records "
                  f"skipped, torn tail={stats['torn_tail']})")
    if not records:
        where = f"{args.symbol}" + (f" lane {args.lane}"
                                    if args.lane is not None else "")
        print(f"no recorded decisions for {where}")
        return
    for line in format_why(records):
        print(line)


def cmd_profile(args):
    """On-demand device profiler capture (the CLI twin of the dashboard's
    `/profile?seconds=N`): run a short paper-trading burst on ``--device``
    with the devprof observatory on, wrap it in `utils/profiling.trace`,
    and write a Chrome trace (``<out>/trace.json``: Perfetto or
    chrome://tracing) beside the cost cards and SLO summaries the run
    produced."""
    from ai_crypto_trader_tpu_torch.data.ingest import from_dict
    from ai_crypto_trader_tpu_torch.data.synthetic import generate_ohlcv
    from ai_crypto_trader_tpu_torch.shell.exchange import make_exchange
    from ai_crypto_trader_tpu_torch.shell.launcher import TradingSystem
    from ai_crypto_trader_tpu_torch.utils import profiling

    d = generate_ohlcv(n=args.ticks + 600, seed=args.seed)
    series = from_dict({k: v for k, v in d.items() if k != "regime"},
                       symbol=args.symbol)
    clock = {"t": 0.0}
    ex = make_exchange("fake", series={args.symbol: series},
                       quote_balance=10_000.0)
    ex.advance(args.symbol, steps=600)
    system = TradingSystem(ex, [args.symbol], now_fn=lambda: clock["t"],
                           enable_devprof=True, device=args.device)
    out_dir = args.out or time.strftime("profiles/trace_%Y%m%d_%H%M%S")
    os.makedirs(out_dir, exist_ok=True)

    async def go():
        for _ in range(args.ticks):
            ex.advance(args.symbol)
            clock["t"] += 60.0
            await system.tick()

    on_card = system.device.type == "cuda"
    try:
        with profiling.trace(out_dir, cuda=on_card):
            asyncio.run(go())
        trace = os.path.join(out_dir, profiling.TRACE_FILE)
        events = profiling.cuda_events(trace)
        if on_card and not events:
            raise RuntimeError(f"profile {trace}: the ticks ran on the card, "
                               "but the trace recorded no CUDA activity")
        print(json.dumps({"artifact": out_dir, "trace": trace, "ticks": args.ticks,
                          "cuda_events": len(events),
                          "devprof": system.devprof.status()}, indent=2,
                         default=str))
    finally:
        system.shutdown()


def cmd_load(args):
    """Load & capacity harness (testing/loadgen.py): drive N synthetic
    tenant decision lanes over an S-symbol universe through the real
    stream → tick engine → analyzer/executor path on ``--device`` and
    print the measured tick-latency/saturation report.  `--ramp` runs the
    closed-loop controller instead: tenants step up a doubling schedule
    until the p99 tick latency breaches `--slo-ms`, and the report names
    the max sustainable tenants×symbols point plus the stage the
    saturation gauges attribute the breach to."""
    from ai_crypto_trader_tpu_torch.testing.loadgen import (
        LoadConfig, ramp, run_load)

    cfg = LoadConfig(tenants=args.tenants, symbols=args.symbols,
                     ticks=args.ticks, window=args.window,
                     slo_p99_ms=args.slo_ms, seed=args.seed,
                     mode=getattr(args, "mode", "objects"),
                     fleetscope=not args.no_fleetscope,
                     flightrec_path=args.flightrec, device=args.device)
    if args.ramp:
        out = ramp(cfg)
    else:
        out = run_load(cfg)
    print(json.dumps(out, indent=2, default=str))


def _fetch_state(url: str) -> dict:
    """GET a live dashboard server's /state.json."""
    import urllib.request

    with urllib.request.urlopen(f"{url}/state.json", timeout=10) as resp:
        return json.loads(resp.read())


def cmd_mesh(args):
    """Mesh layout inspector: the active Partitioner layout (kind, device
    count, device kinds), a card for every visible device (id, kind,
    platform, the allocator's bytes in use on a CUDA card), and the
    pad/mask arithmetic for a given population — the numbers the
    `mesh_pad_fraction` / `mesh_device_members` gauges publish; on a
    process mesh its ranks, local shards a rank and global shards.  With
    `--url`, reads a LIVE system's `/state.json` mesh block (layout cards,
    sentinel counters) instead."""
    if args.url:
        state = _fetch_state(args.url)
        print(json.dumps(state.get("mesh", {"error": "no mesh block"}),
                         indent=2, default=str))
        return
    from ai_crypto_trader_tpu_torch.parallel import get_partitioner

    part = get_partitioner()
    desc = part.describe()
    print(json.dumps({"partitioner": desc}, indent=2, default=str))
    print(f"\n{'id':>4} {'kind':<16} {'platform':<10} {'memory':<16} role")
    trial_devs = {str(d) for d in part.trial_devices()}
    if torch.cuda.is_available():
        rows = [(i, torch.cuda.get_device_name(i), "gpu",
                 f"{torch.cuda.memory_allocated(i):,}B in use", f"cuda:{i}")
                for i in range(torch.cuda.device_count())]
    else:
        rows = [(0, "cpu", "cpu", "", "cpu")]    # no allocator statistics
    for i, kind, platform, stats, name in rows:
        role = "trial farm" if name in trial_devs else "default"
        print(f"{i:>4} {kind:<16} {platform:<10} {stats:<16} {role}")
    n = part.device_count
    if "ranks" in desc:
        print(f"\nprocess mesh: {desc['ranks']} rank(s) x {desc['local_shards']} local "
              f"shard(s) = {n} shards; this rank ({desc['rank']}) drives "
              f"{', '.join(desc['local_device_names'])} over {desc['backend']}")
    pad = (-args.pop) % n
    padded = args.pop + pad
    print(f"\npopulation {args.pop} on {n} device(s): "
          f"pad {pad} → {padded} lanes "
          f"({padded // n}/device), pad_fraction "
          f"{pad / padded if padded else 0.0:.4f}"
          + (" — MeshPaddingWasteHigh would fire"
             if padded and pad / padded > 0.25 else ""))


def _render_fleet(block: dict, containment: dict | None = None) -> None:
    """Operator rendering of a fleet-observatory status block
    (obs/fleetscope.py): headline, quarantine, gate mix, dispersion,
    rank table.  ``containment`` (local runs with engine access) adds
    the per-lane quarantine table; a remote /state.json block carries
    the bounded counts only (the cardinality discipline)."""
    if not block:
        print("no fleet block — is the fleet observatory enabled and a "
              "vmapped tenant engine deciding?")
        return
    print(f"fleet: {block.get('tenants', 0)} tenants "
          f"({block.get('active_lanes', 0)} active lanes), "
          f"{block.get('decides', 0)} decides, "
          f"{block.get('decisions', 0)} decisions last tick "
          f"({block.get('executable', 0)} executable)")
    sampled = block.get("sampled_lanes", [])
    n_sampled = block.get("sampled_lane_count", len(sampled))
    more = ", …" if n_sampled > len(sampled) else ""
    print(f"starved lanes (windowed min): {block.get('starved_lanes', 0)}; "
          f"balance drift max: {block.get('balance_drift_max', 0.0)}; "
          f"sampled lanes ({n_sampled}): {sampled}{more}")
    n_quar = int(block.get("quarantined_lanes", 0) or 0)
    heals = int(block.get("heals_total", 0) or 0)
    rows = (containment or {}).get("quarantined") or []
    print(f"quarantine: {n_quar} lane(s) quarantined, "
          f"{heals} heal(s) completed"
          + (f", {containment.get('degraded_ticks', 0)} degraded tick(s)"
             if containment else ""))
    if rows:
        print(f"  {'lane':>6} {'gate':<18}{'cooldown left':>14}")
        for r in rows:
            print(f"  {r.get('lane', ''):>6} "
                  f"{r.get('gate', 'lane_quarantined'):<18}"
                  f"{r.get('cooldown', 0):>14}")
    mix = block.get("gate_mix") or {}
    total = sum(mix.values()) or 1
    if mix:
        print("\ngate mix (windowed):")
        for gate, count in sorted(mix.items(), key=lambda kv: -kv[1]):
            bar = "#" * max(int(40 * count / total), 1)
            print(f"  {gate:<22}{count:>9}  {count / total:>7.1%} {bar}")
        if block.get("dominant_gate"):
            print(f"  dominant veto gate: {block['dominant_gate']} "
                  f"({block.get('gate_dominance', 0.0):.1%} of vetoes)")
    pnl, bal = block.get("pnl") or {}, block.get("balance") or {}
    if pnl:
        print("\ndispersion over lanes:")
        qs = sorted(set(pnl) | set(bal))
        print("  " + "".join(f"{q:>14}" for q in [""] + qs))
        print("  " + f"{'pnl':<2}" + "".join(
            f"{pnl.get(q, float('nan')):>14,.2f}" for q in qs)
            + f"   spread {block.get('pnl_spread', 0.0):,.2f}")
        print("  " + f"{'balance':<2}" + "".join(
            f"{bal.get(q, float('nan')):>14,.2f}" for q in qs))
        if block.get("max_drawdown_max") is not None:
            print(f"  worst max-drawdown: "
                  f"{block['max_drawdown_max']:,.2f}")
    best, worst = block.get("best") or [], block.get("worst") or []
    if best:
        print("\nlane rank (rolling PnL):")
        print(f"  {'':>4}{'best lane':>10}{'pnl':>12}   "
              f"{'worst lane':>10}{'pnl':>12}")
        for i in range(max(len(best), len(worst))):
            b = best[i] if i < len(best) else {}
            w = worst[i] if i < len(worst) else {}
            print(f"  #{i:<3}{b.get('lane', ''):>10}"
                  f"{b.get('pnl', float('nan')):>12,.2f}   "
                  f"{w.get('lane', ''):>10}"
                  f"{w.get('pnl', float('nan')):>12,.2f}")


def cmd_fleet(args):
    """Fleet observatory operator view (obs/fleetscope.py): the
    device-aggregated health of a vmapped tenant fleet — lane rank table
    by rolling PnL, the windowed veto-gate mix, PnL/balance dispersion
    quantiles, starvation and balance-drift signals — of a short local
    vmapped load burst (testing/loadgen.py) on ``--device``.  With `--url`,
    reads a LIVE system's /state.json `fleet` block instead."""
    if args.url:
        state = _fetch_state(args.url)
        _render_fleet(state.get("fleet") or {})
        return
    from ai_crypto_trader_tpu_torch.testing.loadgen import LoadConfig, run_load

    cfg = LoadConfig(tenants=args.tenants, symbols=args.symbols,
                     ticks=args.ticks, seed=args.seed, mode="vmapped",
                     min_samples=2, device=args.device)
    rep = run_load(cfg)
    print(f"(local demo fleet: {args.tenants} tenants × {args.symbols} "
          f"symbols, {args.ticks} measured ticks, p99 "
          f"{rep['p99_ms']:.1f} ms)\n")
    _render_fleet(rep.get("fleet") or {}, rep.get("containment"))


def _render_latency(tickpath_block: dict, coldstart_block: dict,
                    build_block: dict | None = None) -> None:
    """Operator rendering of the decision critical-path observatory
    (obs/tickpath.py): the per-phase waterfall table, bottleneck + overlap
    headroom headline, the event→decision SLO line, and the per-program
    cold-start ledger."""
    if not tickpath_block:
        print("no tickpath block — is the decision critical-path "
              "observatory enabled? (it is on by default; "
              "TradingSystem(enable_tickpath=False) turns it off)")
        return
    phases = tickpath_block.get("phases") or {}
    bottleneck = tickpath_block.get("bottleneck")
    print("decision critical path (per-phase waterfall, ms):")
    print(f"  {'phase':<16}{'count':>7}{'p50':>10}{'p99':>10}{'last':>10}")
    for name, row in phases.items():
        if not row.get("count"):
            continue
        mark = "  ◀ bottleneck" if name == bottleneck else ""
        print(f"  {name:<16}{row['count']:>7}{row['p50_ms']:>10.2f}"
              f"{row['p99_ms']:>10.2f}{row['last_ms']:>10.2f}{mark}")
    if not any(row.get("count") for row in phases.values()):
        print("  (no phases observed yet)")
    overlap = tickpath_block.get("overlap_headroom_ms") or {}
    if overlap.get("p50") is not None:
        print(f"\noverlap headroom (dispatch→ready host-idle wait "
              f"pipelining can reclaim): p50 {overlap['p50']:.2f} ms, "
              f"p99 {overlap.get('p99', 0.0):.2f} ms")
    age = tickpath_block.get("event_age_ms") or {}
    if age.get("count"):
        print(f"event→decision age: p50 {age.get('p50', 0.0):.0f} ms, "
              f"p99 {age.get('p99', 0.0):.0f} ms over {age['count']} "
              f"decisions (budget {age.get('budget_ms', 0.0):.0f} ms)")
    skew = tickpath_block.get("clock_skew_total", 0)
    if skew:
        print(f"clock-skew clamps (venue event ahead of host clock): {skew}")
    programs = (coldstart_block or {}).get("programs") or {}
    if programs:
        print("\ncold-start ledger (first-compile cost per program):")
        print(f"  {'program':<24}{'wall_ms':>10}{'compile_ms':>12}"
              f"{'compiles':>10}")
        for name, row in sorted(programs.items(),
                                key=lambda kv: -kv[1]["wall_ms"]):
            print(f"  {name:<24}{row['wall_ms']:>10.1f}"
                  f"{row['compile_ms']:>12.1f}{row['compiles']:>10}")
        print(f"  total: wall {coldstart_block.get('total_wall_ms', 0.0):,.1f}"
              f" ms (compile "
              f"{coldstart_block.get('total_compile_ms', 0.0):,.1f} ms)")
    if build_block:
        # a block names the runtime that produced it: torch and CUDA for
        # the port's systems, jax for the JAX package's
        runtime = (f"torch {build_block.get('torch_version')} (CUDA "
                   f"{build_block.get('cuda_version')})"
                   if "torch_version" in build_block
                   else f"jax {build_block.get('jax_version')}")
        print(f"\nbuild: {runtime} on "
              f"{build_block.get('backend')} "
              f"({build_block.get('device_kind')}), process start "
              f"{build_block.get('process_start')}")


def _run_latency_burst(symbol: str, ticks: int, seed: int,
                       pipelined: bool = False,
                       device=None) -> tuple[dict, dict, dict]:
    """One local paper burst for the latency views: builds a fresh
    TradingSystem (serial or pipelined tick path), drives `ticks` ticks on
    the virtual clock, and returns its (tickpath, coldstart, build)
    status blocks, on ``device``.  The pipelined/serial toggle is the SAME
    TickEngine constructor knob the parity tests flip."""
    from ai_crypto_trader_tpu_torch.data.ingest import from_dict
    from ai_crypto_trader_tpu_torch.data.synthetic import generate_ohlcv
    from ai_crypto_trader_tpu_torch.shell.exchange import make_exchange
    from ai_crypto_trader_tpu_torch.shell.launcher import TradingSystem

    d = generate_ohlcv(n=ticks + 600, seed=seed)
    series = from_dict({k: v for k, v in d.items() if k != "regime"},
                       symbol=symbol)
    # virtual clock aligned to the synthetic candle open-times (i*60_000
    # epoch-ms), so the demo's event→decision ages read as a real feed's
    # would instead of clamping to zero or blowing past the budget
    clock = {"t": 600 * 60.0}
    ex = make_exchange("fake", series={symbol: series},
                       quote_balance=10_000.0)
    ex.advance(symbol, steps=600)
    system = TradingSystem(ex, [symbol], now_fn=lambda: clock["t"],
                           pipelined=pipelined, device=device)

    async def go():
        for _ in range(ticks):
            ex.advance(symbol)
            clock["t"] += 60.0
            await system.tick()
        # drain the last in-flight dispatch so the final decision publishes
        await system.monitor.flush_pipeline()

    try:
        asyncio.run(go())
        return (system.tickpath.status(),
                system.tickpath.coldstart_status(),
                system.build_info)
    finally:
        system.shutdown()


def _render_latency_compare(serial_tp: dict, pipe_tp: dict,
                            ticks: int) -> None:
    """Side-by-side serial vs pipelined waterfalls: per-phase p50 columns
    with deltas, then the overlap story — how much dispatch→ready host
    idle the serial path exposes (headroom) and how much of it the
    pipelined path actually filled with host work (reclaimed)."""
    s_phases = serial_tp.get("phases") or {}
    p_phases = pipe_tp.get("phases") or {}
    names = [n for n in s_phases
             if (s_phases.get(n, {}).get("count")
                 or p_phases.get(n, {}).get("count"))]
    print(f"serial vs pipelined tick path ({ticks} paper ticks each, "
          f"phase p50 ms):")
    print(f"  {'phase':<16}{'serial':>10}{'pipelined':>12}{'delta':>10}")
    s_total = p_total = 0.0
    for name in names:
        s50 = s_phases.get(name, {}).get("p50_ms", 0.0) or 0.0
        p50 = p_phases.get(name, {}).get("p50_ms", 0.0) or 0.0
        s_total += s50
        p_total += p50
        print(f"  {name:<16}{s50:>10.2f}{p50:>12.2f}{p50 - s50:>+10.2f}")
    print(f"  {'(sum of p50s)':<16}{s_total:>10.2f}{p_total:>12.2f}"
          f"{p_total - s_total:>+10.2f}")
    s_head = (serial_tp.get("overlap_headroom_ms") or {}).get("p50")
    p_head = (pipe_tp.get("overlap_headroom_ms") or {}).get("p50")
    reclaimed = (pipe_tp.get("overlap_reclaimed_ms") or {}).get("p50")
    if s_head is not None:
        print(f"\noverlap headroom (host-idle dispatch→ready wait): "
              f"serial p50 {s_head:.2f} ms"
              + (f" → pipelined p50 {p_head:.2f} ms"
                 if p_head is not None else ""))
    if reclaimed is not None:
        print(f"overlap reclaimed by pipelining (device compute hidden "
              f"behind host work): p50 {reclaimed:.2f} ms/tick")
    s_age = serial_tp.get("event_age_ms") or {}
    p_age = pipe_tp.get("event_age_ms") or {}
    if s_age.get("count") and p_age.get("count"):
        print(f"event→decision age p50: serial {s_age.get('p50', 0.0):.0f} "
              f"ms, pipelined {p_age.get('p50', 0.0):.0f} ms (budget "
              f"{s_age.get('budget_ms', 0.0):.0f} ms; pipelined publishes "
              f"tick T at T+1's poll)")


def cmd_latency(args):
    """Decision critical-path operator view (obs/tickpath.py): WHERE each
    tick's time goes (phase waterfall), the overlap headroom pipelining
    could reclaim, the event→decision age SLO reading, and the cold-start
    ledger (first-compile cost per hot program).  With `--url`, reads a
    LIVE system's /state.json tickpath/coldstart blocks; without it,
    drives a short local paper burst on ``--device`` so the view is
    demonstrable on any host.  `--compare` drives the burst TWICE —
    serial then pipelined — and renders the waterfalls side by side."""
    if args.url:
        state = _fetch_state(args.url)
        _render_latency(state.get("tickpath") or {},
                        state.get("coldstart") or {},
                        state.get("build"))
        return
    if args.compare:
        serial_tp, _, _ = _run_latency_burst(args.symbol, args.ticks,
                                             args.seed, pipelined=False,
                                             device=args.device)
        pipe_tp, _, _ = _run_latency_burst(args.symbol, args.ticks,
                                           args.seed, pipelined=True,
                                           device=args.device)
        print(f"(local demo: 2×{args.ticks} paper ticks on {args.symbol}; "
              f"point --url at a running `trade --serve` for live state)\n")
        _render_latency_compare(serial_tp, pipe_tp, args.ticks)
        return
    tp, cold, build = _run_latency_burst(args.symbol, args.ticks, args.seed,
                                         device=args.device)
    print(f"(local demo: {args.ticks} paper ticks on {args.symbol}; "
          f"point --url at a running `trade --serve` for live state)\n")
    _render_latency(tp, cold, build)


def cmd_status(args):
    """Operator status without a REPL: queries a live
    dashboard server's `/state.json` and prints a compact summary — the
    active mesh/partitioner layout, portfolio, alerts, capacity bottleneck
    and (when the observatories are on) devprof/meshprof headlines.
    Without `--url` it reports the LOCAL process view: the partitioner
    layout `get_partitioner()` would serve this host."""
    if not args.url:
        from ai_crypto_trader_tpu_torch.parallel import get_partitioner

        print(json.dumps({"live": False,
                          "partitioner": get_partitioner().describe()},
                         indent=2, default=str))
        print("(no --url given: showing the local partitioner layout; "
              "point --url at a running `trade --serve` for live state)")
        return
    state = _fetch_state(args.url)
    status = state.get("status", {})
    out = {
        "live": True,
        "portfolio_value_usd": status.get("portfolio_value_usd"),
        "open_trades": len(status.get("active_trades", {})),
        "closed_trades": status.get("closed_trades"),
        "total_pnl": status.get("total_pnl"),
        "alerts": status.get("alerts", []),
    }
    if "mesh" in state:
        out["mesh"] = state["mesh"]
    cap = state.get("capacity")
    if cap:
        out["bottleneck_stage"] = cap.get("bottleneck_stage")
    dev = state.get("devprof")
    if dev:
        out["slo_burn_rates"] = dev.get("burn_rates")
        out["donation_failures"] = dev.get("donation_failures")
    # process provenance (shell/launcher.py build_info): which torch /
    # CUDA / backend / device produced every number above — the first
    # question when two operators compare readings from different hosts
    if "build" in state:
        out["build"] = state["build"]
    tp = state.get("tickpath")
    if tp:
        out["tickpath_bottleneck"] = tp.get("bottleneck")
        out["event_age_p99_ms"] = (tp.get("event_age_ms") or {}).get("p99")
    # continuous PBT training service: generation counter, quarantined
    # members, checkpoint/recalibration staleness (rl/trainer_service.py)
    tr = state.get("training")
    if tr:
        out["training"] = {
            "generation": tr.get("generation"),
            "best_fitness": tr.get("best_fitness"),
            "quarantined_members": tr.get("quarantined_members"),
            "checkpoint_age_s": tr.get("checkpoint_age_s"),
            "last_recalibration": tr.get("last_recalibration"),
            "resumed_at": tr.get("resumed_at"),
        }
    print(json.dumps(out, indent=2, default=str))


def cmd_registry(args):
    """Model-registry operations (`run_ai_model_services.py` surface)."""
    from ai_crypto_trader_tpu_torch.strategy.registry import ModelRegistry

    reg = ModelRegistry(path=args.path)
    if args.best:
        print(json.dumps(reg.best(args.kind) or {"status": "no_entries"},
                         indent=2, default=str))
    else:
        rows = [{"version": e["version"], "kind": e["kind"],
                 "status": e["status"],
                 "sharpe": e.get("performance", {}).get("sharpe_ratio")}
                for e in reg.entries.values()]
        print(json.dumps(rows, indent=2))


def cmd_dashboard(args):
    from ai_crypto_trader_tpu_torch.shell.dashboard import write_dashboard

    d = _load_or_generate(args.symbol, 2000, args.seed)
    path = write_dashboard(args.out, price_series=np.asarray(d["close"])[-500:])
    print(f"wrote {path}")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="ai_crypto_trader_tpu_torch",
                                description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="command", required=True)
    sp = sub.add_parser("fetch", help="fetch (or synthesize) candles to CSV")
    sp.add_argument("--source", choices=("synthetic", "binance"),
                    default="synthetic")
    sp.add_argument("--symbol", default="BTCUSDC")
    sp.add_argument("--days", type=int, default=7)
    sp.add_argument("--seed", type=int, default=0)
    sp.set_defaults(fn=cmd_fetch)
    sp = sub.add_parser("backtest", help="run a vectorized backtest")
    sp.add_argument("--symbol", default="BTCUSDC")
    sp.add_argument("--days", type=int, default=7)
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--sweep", type=int, default=1,
                    help="strategy-population width")
    sp.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    sp.set_defaults(fn=cmd_backtest)
    sp = sub.add_parser("list", help="list saved results")
    sp.set_defaults(fn=cmd_list)
    sp = sub.add_parser("analyze", help="pretty-print a result file")
    sp.add_argument("--file", required=True)
    sp.set_defaults(fn=cmd_analyze)
    sp = sub.add_parser("report", help="multi-run summary + HTML report")
    sp.add_argument("--symbol", default="")
    sp.add_argument("--out", default="backtest_report.html")
    sp.set_defaults(fn=cmd_report)
    sp = sub.add_parser("train", help="train a price model")
    sp.add_argument("--symbol", default="BTCUSDC")
    sp.add_argument("--days", type=int, default=7)
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--model", default="lstm")
    sp.add_argument("--epochs", type=int, default=5)
    sp.add_argument("--seq-len", type=int, default=60)
    sp.add_argument("--batch-size", type=int, default=32)
    sp.add_argument("--precision", choices=("f32", "bf16"), default="f32",
                    help="matmul precision of the training epochs")
    sp.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    sp.set_defaults(fn=cmd_train)
    sp = sub.add_parser("evolve", help="GA-evolve strategy parameters")
    sp.add_argument("--symbol", default="BTCUSDC")
    sp.add_argument("--days", type=int, default=7)
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--population", type=int, default=20)
    sp.add_argument("--generations", type=int, default=10)
    sp.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    sp.set_defaults(fn=cmd_evolve)
    sp = sub.add_parser("rl", help="population-based RL: PBT-train a DQN "
                        "fleet inside the LOB simulator (local, no venue)")
    sp.add_argument("--population", type=int, default=8)
    sp.add_argument("--generations", type=int, default=4)
    sp.add_argument("--iters", type=int, default=4,
                    help="train iterations per member per generation")
    sp.add_argument("--envs", type=int, default=16)
    sp.add_argument("--rollout", type=int, default=8)
    sp.add_argument("--scenarios", type=int, default=8)
    sp.add_argument("--steps", type=int, default=1024)
    sp.add_argument("--episode-len", type=int, default=256)
    sp.add_argument("--dynamics", choices=("lob", "gbm"), default="lob")
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--registry", default=None,
                    help="register + scorecard-gate the winner into this "
                         "registry JSON")
    sp.add_argument("--checkpoint", default=None,
                    help="journal full fleet snapshots to this path every "
                         "--checkpoint-every generations")
    sp.add_argument("--checkpoint-every", type=int, default=1)
    sp.add_argument("--resume", default=None,
                    help="resume from the newest intact checkpoint in this "
                         "journal")
    sp.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    sp.set_defaults(fn=cmd_rl)
    sp = sub.add_parser("generate",
                        help="generate strategy structures (real-CV search)")
    sp.add_argument("--folds", type=int, default=3)
    sp.add_argument("--pool", type=int, default=16)
    sp.add_argument("--rounds", type=int, default=6)
    sp.add_argument("--registry", default="registry.json")
    sp.add_argument("--symbol", default="BTCUSDC")
    sp.add_argument("--days", type=int, default=7)
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    sp.set_defaults(fn=cmd_generate)
    sp = sub.add_parser("mc", help="Monte-Carlo risk simulation")
    sp.add_argument("--symbol", default="BTCUSDC")
    sp.add_argument("--days", type=int, default=7)
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--paths", type=int, default=10_000)
    sp.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    sp.set_defaults(fn=cmd_mc)
    sp = sub.add_parser("scan", help="discover + rank tradable pairs")
    sp.add_argument("--pairs", type=int, default=64,
                    help="synthetic universe size (paper mode)")
    sp.add_argument("--lookback", type=int, default=256)
    sp.add_argument("--top", type=int, default=10)
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    sp.set_defaults(fn=cmd_scan)
    sp = sub.add_parser("trade", help="run the live loop (paper mode)")
    sp.add_argument("--symbol", default="BTCUSDC")
    sp.add_argument("--days", type=int, default=7)
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--paper", action="store_true")
    sp.add_argument("--ticks", type=int, default=100)
    sp.add_argument("--dashboard", default=None,
                    help="write a static HTML snapshot per tick to this path")
    sp.add_argument("--serve", type=int, default=None, metavar="PORT",
                    help="serve the LIVE dashboard on this port during the "
                         "run (shell/dashboard_server.py)")
    sp.add_argument("--full-stack", action="store_true",
                    help="register the reference's full service roster "
                         "(social/news/patterns/regime/NN/evolver/"
                         "generator/grid/DCA) on the paper loop")
    sp.add_argument("--registry", default="models/registry.json",
                    help="model-registry file for --full-stack versioning")
    sp.add_argument("--trace-jsonl", default=None, metavar="PATH",
                    help="enable end-to-end tracing and append every "
                         "finished span to this JSONL file "
                         "(utils/tracing.py; /traces on --serve)")
    sp.add_argument("--journal", default=None, metavar="PATH",
                    help="crash-safe state: write-ahead journal every "
                         "order intent/ack/closure to PATH; if the file "
                         "already exists, replay + reconcile it against "
                         "the exchange before trading (utils/journal.py)")
    sp.add_argument("--serve-hold-s", type=float, default=0.0,
                    help="keep serving this many seconds after the ticks")
    sp.add_argument("--devprof", action="store_true",
                    help="device-runtime observatory (utils/devprof.py): "
                         "program cost cards + donation checks, allocator "
                         "watermarks, latency SLO gauges")
    sp.add_argument("--flightrec", default=None, metavar="PATH",
                    help="persist the decision-provenance flight recorder "
                         "(obs/flightrec.py) as checksummed JSONL to PATH "
                         "— queryable offline via `why --file PATH`")
    sp.add_argument("--meshprof", action="store_true",
                    help="mesh runtime observatory (utils/meshprof.py): "
                         "kernel-build/sync sentinels on the hot "
                         "dispatches, layout cards, per-device "
                         "memory-imbalance gauges")
    sp.add_argument("--fleetscope", action="store_true",
                    help="fleet observatory (obs/fleetscope.py): device-"
                         "aggregated lane telemetry for any vmapped "
                         "tenant engine in this process")
    sp.add_argument("--pipelined", action="store_true",
                    help="pipelined tick path (ops/tick_engine.py): "
                         "double-buffered candle ring — publish tick T−1 "
                         "while T computes on the card")
    sp.add_argument("--precision", default=None,
                    metavar="{f32,bf16,tf32}",
                    help="matmul precision for the fused decide programs "
                         "(default full f32)")
    sp.add_argument("--aot-cache", default=None, metavar="DIR",
                    help="persistent kernel-build cache rooted at DIR "
                         "(utils/aotcache.py): restarts load the kernel "
                         "libraries the last run built")
    sp.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    sp.set_defaults(fn=cmd_trade)
    sp = sub.add_parser("why", help="decision provenance for a symbol "
                                    "(flight-recorder query)")
    sp.add_argument("symbol")
    sp.add_argument("--file", default="decisions.jsonl",
                    help="decision JSONL written by trade --flightrec")
    sp.add_argument("--url", default=None,
                    help="query a live dashboard server instead "
                         "(e.g. http://127.0.0.1:8050)")
    sp.add_argument("--last", type=int, default=10)
    sp.add_argument("--lane", type=int, default=None,
                    help="filter to one vmapped tenant lane's sampled "
                         "provenance")
    sp.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    sp.set_defaults(fn=cmd_why)
    sp = sub.add_parser("profile",
                        help="capture a torch.profiler device trace of a "
                             "short paper-trading burst")
    sp.add_argument("--symbol", default="BTCUSDC")
    sp.add_argument("--days", type=int, default=7)
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--ticks", type=int, default=10)
    sp.add_argument("--out", default=None,
                    help="artifact directory (default profiles/trace_<ts>)")
    sp.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    sp.set_defaults(fn=cmd_profile)
    sp = sub.add_parser("load", help="tenants×symbols load harness "
                                     "(saturation report; --ramp finds "
                                     "the max sustainable point)")
    sp.add_argument("--tenants", type=int, default=4,
                    help="tenant decision lanes (the ramp's cap)")
    sp.add_argument("--symbols", type=int, default=4,
                    help="synthetic symbol universe size")
    sp.add_argument("--ticks", type=int, default=12,
                    help="measured ticks per load point")
    sp.add_argument("--window", type=int, default=64,
                    help="candle window (engine/monitor kline_limit)")
    sp.add_argument("--slo-ms", type=float, default=250.0,
                    help="p99 tick-latency SLO the ramp holds")
    sp.add_argument("--ramp", action="store_true",
                    help="closed-loop ramp: step tenants until the p99 "
                         "SLO breaches; report max sustainable point + "
                         "the telemetry-named saturated stage")
    mode = sp.add_mutually_exclusive_group()
    mode.add_argument("--vmapped", dest="mode", action="store_const",
                      const="vmapped",
                      help="tenants as a batch axis: ONE TenantEngine "
                           "decide per tick for all N tenants "
                           "(ops/tenant_engine.py)")
    mode.add_argument("--object-lanes", dest="mode", action="store_const",
                      const="objects",
                      help="per-tenant Python SignalAnalyzer/TradeExecutor "
                           "lanes (the baseline / parity oracle)")
    mode.add_argument("--mode", dest="mode", choices=("objects", "vmapped"),
                      help="the tenant mode by name")
    sp.set_defaults(mode="objects")
    sp.add_argument("--no-fleetscope", action="store_true",
                    help="measure the bare vmapped engine (no fleet "
                         "observatory — the overhead-probe configuration)")
    sp.add_argument("--flightrec", default=None, metavar="PATH",
                    help="persist sampled-lane decision provenance as "
                         "checksummed JSONL (vmapped mode; query with "
                         "`why SYMBOL --lane N --file PATH`)")
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    sp.set_defaults(fn=cmd_load)
    sp = sub.add_parser("mesh", help="partitioner layout + per-device "
                                     "cards (mesh runtime observatory)")
    sp.add_argument("--pop", type=int, default=256,
                    help="population size for the pad/mask arithmetic")
    sp.add_argument("--url", default=None,
                    help="read a live system's /state.json mesh block "
                         "instead (e.g. http://127.0.0.1:8050)")
    sp.set_defaults(fn=cmd_mesh)
    sp = sub.add_parser("fleet", help="fleet observatory operator view: "
                                      "lane rank table, gate mix, "
                                      "dispersion (obs/fleetscope.py)")
    sp.add_argument("--url", default=None,
                    help="read a live system's /state.json fleet block "
                         "instead of running a local demo fleet")
    sp.add_argument("--tenants", type=int, default=8,
                    help="local demo fleet size")
    sp.add_argument("--symbols", type=int, default=4)
    sp.add_argument("--ticks", type=int, default=6)
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    sp.set_defaults(fn=cmd_fleet)
    sp = sub.add_parser("latency", help="decision critical-path view: "
                                        "tick-phase waterfall, overlap "
                                        "headroom, cold-start ledger "
                                        "(obs/tickpath.py)")
    sp.add_argument("--url", default=None,
                    help="read a live system's /state.json tickpath/"
                         "coldstart blocks instead of running a local "
                         "demo burst")
    sp.add_argument("--symbol", default="BTCUSDC")
    sp.add_argument("--ticks", type=int, default=12,
                    help="local demo burst length (no --url)")
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--compare", action="store_true",
                    help="run the local burst twice — serial and "
                         "pipelined tick path — and render the phase "
                         "waterfalls side by side (no --url)")
    sp.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    sp.set_defaults(fn=cmd_latency)
    sp = sub.add_parser("status", help="operator summary from a live "
                                       "dashboard server (/state.json)")
    sp.add_argument("--url", default=None,
                    help="dashboard server base URL "
                         "(e.g. http://127.0.0.1:8050)")
    sp.set_defaults(fn=cmd_status)
    sp = sub.add_parser("registry", help="inspect the model registry")
    sp.add_argument("--path", default="models/registry.json")
    sp.add_argument("--kind", default="strategy_params")
    sp.add_argument("--best", action="store_true")
    sp.set_defaults(fn=cmd_registry)
    sp = sub.add_parser("dashboard", help="render the HTML dashboard")
    sp.add_argument("--symbol", default="BTCUSDC")
    sp.add_argument("--days", type=int, default=7)
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--out", default="dashboard.html")
    sp.set_defaults(fn=cmd_dashboard)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    if (getattr(args, "device", None) == "cuda" and not getattr(args, "url", None)
            and torch.cuda.is_available()):
        # the card commands build and load their kernel libraries in the
        # provenance-keyed cache directory: built once per toolchain and
        # card, not once per invocation
        from ai_crypto_trader_tpu_torch.utils.cache import enable_compilation_cache

        enable_compilation_cache()
    args.fn(args)


if __name__ == "__main__":
    main()
