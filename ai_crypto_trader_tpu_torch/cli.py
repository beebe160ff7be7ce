"""Command-line interface of the port: the ``backtest`` and ``evolve``
subcommands.

Same flags and JSON output as ``python -m ai_crypto_trader_tpu.cli
backtest`` / ``evolve``, plus ``--device {cuda,cpu}`` (default cuda):

    python -m ai_crypto_trader_tpu_torch.cli backtest --days 365 --sweep 4096
    python -m ai_crypto_trader_tpu_torch.cli evolve --days 30 --population 256 --generations 3

A CSV at ``backtesting/data/market/<symbol>/<symbol>_1m.csv`` is used when
present; otherwise the deterministic synthetic series is generated.
``--sweep N`` (N > 1) sweeps N strategies drawn from a ``torch.Generator``
seeded with ``--seed`` through the replay kernel and reports the best by
Sharpe; otherwise one default-parameter backtest runs with its equity curve.
``evolve`` runs the GA with backtest fitness over the candles, seeded with
the default parameters as individual 0, its draws from a ``torch.Generator``
seeded with ``--seed``, and prints the history and the best parameters.
"""

from __future__ import annotations

import argparse
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
    sp = sub.add_parser("evolve", help="GA-evolve strategy parameters")
    sp.add_argument("--symbol", default="BTCUSDC")
    sp.add_argument("--days", type=int, default=7)
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--population", type=int, default=20)
    sp.add_argument("--generations", type=int, default=10)
    sp.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    sp.set_defaults(fn=cmd_evolve)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
