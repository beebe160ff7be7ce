"""Command-line interface of the port: the ``backtest``, ``train``,
``evolve``, ``rl``, ``generate``, ``scan``, ``trade`` and ``why``
subcommands.

Same flags and output as ``python -m ai_crypto_trader_tpu.cli backtest`` /
``train`` / ``evolve`` / ``rl`` / ``generate`` / ``scan`` / ``trade`` /
``why``, plus ``--device {cuda,cpu}`` (default cuda):

    python -m ai_crypto_trader_tpu_torch.cli backtest --days 365 --sweep 4096
    python -m ai_crypto_trader_tpu_torch.cli train --days 7 --model lstm --epochs 5
    python -m ai_crypto_trader_tpu_torch.cli evolve --days 30 --population 256 --generations 3
    python -m ai_crypto_trader_tpu_torch.cli rl --population 8 --dynamics lob
    python -m ai_crypto_trader_tpu_torch.cli generate --days 7 --registry registry.json
    python -m ai_crypto_trader_tpu_torch.cli scan --pairs 64 --top 10
    python -m ai_crypto_trader_tpu_torch.cli trade --paper --ticks 100 --flightrec decisions.jsonl
    python -m ai_crypto_trader_tpu_torch.cli trade --paper --full-stack --registry models/registry.json
    python -m ai_crypto_trader_tpu_torch.cli why BTCUSDC --file decisions.jsonl

A CSV at ``backtesting/data/market/<symbol>/<symbol>_1m.csv`` is used when
present; otherwise the deterministic synthetic series is generated.
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
system's device, versioned in ``--registry``.  The flags whose modules are
not ported yet (``--serve``, ``--devprof``, ``--meshprof``,
``--aot-cache``) exit with code 2 and say so.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import sys
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


def cmd_evolve(args):
    from ai_crypto_trader_tpu_torch import resolve_device
    from ai_crypto_trader_tpu_torch.backtest import default_params
    from ai_crypto_trader_tpu_torch.config import GAParams
    from ai_crypto_trader_tpu_torch.evolve import backtest_fitness, run_ga

    dev = resolve_device(args.device)
    d = _load_or_generate(args.symbol, args.days * 1440, args.seed)
    cfg = GAParams(population_size=args.population, generations=args.generations)
    best, hist = run_ga(torch.Generator(device=dev).manual_seed(args.seed),
                        backtest_fitness(d, device=dev), cfg,
                        seed_params=default_params(device=dev), device=dev)
    print(json.dumps({"history": hist, "devices": 1, "device": dev.type,
                      "best_params": {k: float(v) for k, v in
                                      best._asdict().items()}}, indent=2))


def cmd_rl(args):
    """Population-based RL inside the simulated markets: the JAX package's
    `cli rl` table, trained on ``--device``; ``--checkpoint`` journals the
    fleet, ``--resume`` continues from the newest intact checkpoint and
    ``--registry`` gates the winner into a model registry."""
    from ai_crypto_trader_tpu_torch import resolve_device
    from ai_crypto_trader_tpu_torch.parallel import get_partitioner
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
    partitioner = get_partitioner()

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
    from ai_crypto_trader_tpu_torch.parallel import get_partitioner
    from ai_crypto_trader_tpu_torch.strategy.generator import StrategyGenerator
    from ai_crypto_trader_tpu_torch.strategy.registry import ModelRegistry

    dev = resolve_device(args.device)
    d = _load_or_generate(args.symbol, args.days * 1440, args.seed)
    reg = ModelRegistry(path=args.registry)
    gen = StrategyGenerator(registry=reg, cv_folds=args.folds,
                            pool_size=args.pool, max_rounds=args.rounds,
                            seed=args.seed, partitioner=get_partitioner(), device=dev)
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


# `trade` flags whose modules the port has not yet (ROADMAP item 16)
_TRADE_NOT_PORTED = (("serve", "--serve"), ("devprof", "--devprof"),
                     ("meshprof", "--meshprof"), ("aot_cache", "--aot-cache"))


def cmd_trade(args):
    from ai_crypto_trader_tpu_torch.data.ingest import from_dict
    from ai_crypto_trader_tpu_torch.data.synthetic import generate_ohlcv
    from ai_crypto_trader_tpu_torch.shell.exchange import make_exchange
    from ai_crypto_trader_tpu_torch.shell.launcher import TradingSystem

    for attr, flag in _TRADE_NOT_PORTED:
        if getattr(args, attr) not in (None, False):
            print(f"trade {flag}: not ported to ai_crypto_trader_tpu_torch yet "
                  "(ROADMAP item 16)", file=sys.stderr)
            raise SystemExit(2)
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
                           enable_fleetscope=args.fleetscope,
                           flightrec_path=args.flightrec,
                           pipelined=args.pipelined,
                           precision=args.precision,
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
    finally:
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


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="ai_crypto_trader_tpu_torch",
                                description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="command", required=True)
    sp = sub.add_parser("backtest", help="run a vectorized backtest")
    sp.add_argument("--symbol", default="BTCUSDC")
    sp.add_argument("--days", type=int, default=7)
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--sweep", type=int, default=1,
                    help="strategy-population width")
    sp.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    sp.set_defaults(fn=cmd_backtest)
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
                    help="serve the live dashboard on this port (not ported "
                         "yet: exits 2)")
    sp.add_argument("--full-stack", action="store_true",
                    help="register the reference's full service roster "
                         "(social/news/patterns/regime/NN/evolver/"
                         "generator/grid/DCA) on the paper loop")
    sp.add_argument("--registry", default="models/registry.json",
                    help="model-registry file for --full-stack versioning")
    sp.add_argument("--trace-jsonl", default=None, metavar="PATH",
                    help="enable end-to-end tracing and append every "
                         "finished span to this JSONL file (utils/tracing.py)")
    sp.add_argument("--journal", default=None, metavar="PATH",
                    help="crash-safe state: write-ahead journal every "
                         "order intent/ack/closure to PATH; if the file "
                         "already exists, replay + reconcile it against "
                         "the exchange before trading (utils/journal.py)")
    sp.add_argument("--serve-hold-s", type=float, default=0.0,
                    help="keep serving this many seconds after the ticks")
    sp.add_argument("--devprof", action="store_true",
                    help="device-runtime observatory (not ported yet: exits 2)")
    sp.add_argument("--flightrec", default=None, metavar="PATH",
                    help="persist the decision-provenance flight recorder "
                         "(obs/flightrec.py) as checksummed JSONL to PATH "
                         "— queryable offline via `why --file PATH`")
    sp.add_argument("--meshprof", action="store_true",
                    help="mesh runtime observatory (not ported yet: exits 2)")
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
                    help="persistent compile cache (not ported yet: exits 2)")
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
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
