"""Strategy evaluation: trade-list metrics, time-ordered k-fold CV with
regime labels, and strategy comparison.

Port of `ai_crypto_trader_tpu/strategy/evaluation.py`:

  * `trade_metrics` — the metric suite from a list of closed trades, on the
    host in NumPy (float64), as the JAX package computes it;
  * `cross_validate` — each time-ordered fold backtested through
    `backtest.evolvable.evolvable_backtest` (on the card the replay
    kernel's launch, one a fold) and labelled with its dominant market
    regime (`regime.RegimeDetector`, whose features run the fused-EWMA
    kernel); the folds' metrics come back in one read;
  * `compare_strategies` — the strategies stacked into one StrategyParams
    [S] and backtested as one population (on the card one launch of the
    replay kernel's rows form, where the JAX package vmaps), the metrics in
    one read.

Entry points that compute take ``device=None``, the CUDA card.
"""

from __future__ import annotations

import numpy as np
import torch

from ai_crypto_trader_tpu_torch.backtest.evolvable import evolvable_backtest
from ai_crypto_trader_tpu_torch.backtest.metrics import compute_metrics
from ai_crypto_trader_tpu_torch.backtest.strategy import StrategyParams
from ai_crypto_trader_tpu_torch.device import resolve_device, to_device
from ai_crypto_trader_tpu_torch.regime import REGIME_NAMES, RegimeDetector


def trade_metrics(trades: list[dict], initial_balance: float = 10_000.0,
                  annualization: float = 252.0) -> dict:
    """Metric suite from a list of closed-trade records
    ({'pnl': float, 'symbol': str, ...}) — `strategy_evaluation.py:32-319`."""
    if not trades:
        return {"total_trades": 0, "win_rate": 0.0, "profit_factor": 0.0,
                "sharpe_ratio": 0.0, "sortino_ratio": 0.0, "calmar_ratio": 0.0,
                "max_drawdown": 0.0, "max_drawdown_pct": 0.0,
                "expectancy": 0.0, "max_win_streak": 0, "max_loss_streak": 0,
                "total_pnl": 0.0, "recovery_factor": 0.0, "symbol_pnl": {}}
    pnl = np.asarray([t["pnl"] for t in trades], np.float64)
    wins = pnl > 0
    total_profit = pnl[wins].sum()
    total_loss = -pnl[~wins].sum()

    equity = initial_balance + np.cumsum(pnl)
    peak = np.maximum.accumulate(np.concatenate([[initial_balance], equity]))
    dd = peak[1:] - equity
    dd_pct = dd / peak[1:] * 100.0
    # absolute and percentage maxima tracked independently — an early small-
    # equity dip can be the percent max while a late dip is the dollar max
    max_dd = float(dd.max()) if len(dd) else 0.0
    max_dd_pct = float(dd_pct.max()) if len(dd) else 0.0

    rets = pnl / np.concatenate([[initial_balance], equity[:-1]])
    sharpe = 0.0
    if len(rets) > 1 and rets.std() > 0:
        sharpe = float(rets.mean() / rets.std() * np.sqrt(annualization))
    downside = rets[rets < 0]
    sortino = 0.0
    if len(downside) and downside.std() > 0:
        sortino = float(rets.mean() / np.sqrt((downside**2).mean()) * np.sqrt(annualization))

    # streaks
    mw = ml = cw = cl = 0
    for w in wins:
        cw, cl = (cw + 1, 0) if w else (0, cl + 1)
        mw, ml = max(mw, cw), max(ml, cl)

    win_rate = float(wins.mean() * 100.0)
    avg_win = float(pnl[wins].mean()) if wins.any() else 0.0
    avg_loss = float(-pnl[~wins].mean()) if (~wins).any() else 0.0
    expectancy = win_rate / 100 * avg_win - (1 - win_rate / 100) * avg_loss

    total_pnl = float(pnl.sum())
    total_return = total_pnl / initial_balance
    ann_return = float(rets.mean() * annualization * 100.0)
    calmar = ann_return / max_dd_pct if max_dd_pct > 0 else 0.0

    symbol_pnl: dict[str, float] = {}
    for t in trades:
        symbol_pnl[t.get("symbol", "?")] = symbol_pnl.get(t.get("symbol", "?"), 0.0) + t["pnl"]

    return {
        "total_trades": len(trades),
        "winning_trades": int(wins.sum()),
        "losing_trades": int((~wins).sum()),
        "win_rate": win_rate,
        "profit_factor": float(total_profit / total_loss) if total_loss > 0 else 0.0,
        "total_pnl": total_pnl,
        "total_return_pct": total_return * 100.0,
        "sharpe_ratio": sharpe,
        "sortino_ratio": sortino,
        "calmar_ratio": float(calmar),
        "max_drawdown": max_dd,
        "max_drawdown_pct": max_dd_pct,
        "expectancy": float(expectancy),
        "avg_win": avg_win,
        "avg_loss": avg_loss,
        "max_win_streak": mw,
        "max_loss_streak": ml,
        "recovery_factor": float(total_pnl / max_dd) if max_dd > 0 else 0.0,
        "symbol_pnl": symbol_pnl,
    }


def host_read(t: torch.Tensor) -> np.ndarray:
    """THE device→host read of a `cross_validate` or `compare_strategies`
    call: its metrics packed as float32 (every count is exact there).  A
    module-level seam, so tests count it."""
    return t.cpu().numpy()


def _packed_metrics(stats, dev):
    """(metric names, the metrics stacked [n_metrics, ...] as float32)."""
    m = compute_metrics(stats, device=dev)
    return list(m), torch.stack([v.to(torch.float32) for v in m.values()])


def cross_validate(ohlcv: dict, params: StrategyParams, k: int = 5,
                   regime_method: str = "rules", device=None) -> dict:
    """Time-ordered k-fold CV on ``device`` (default: the CUDA card): each
    fold is backtested with the engine (`evolvable_backtest`) and labeled
    with its dominant market regime
    (`strategy_evaluation_system.py:433-547`).  The folds' metrics come
    back in one read."""
    dev = resolve_device(device)
    arrays = {kk: to_device(v, dev, torch.float32) for kk, v in ohlcv.items() if kk != "regime"}
    T = int(arrays["close"].shape[-1])
    fold_len = T // k
    det = RegimeDetector(method=regime_method, device=dev).fit(arrays)
    labels = det.label_series(arrays)

    names, packed = None, []
    for i in range(k):
        sl = slice(i * fold_len, (i + 1) * fold_len)
        stats = evolvable_backtest({kk: v[sl] for kk, v in arrays.items()}, params, device=dev)
        names, values = _packed_metrics(stats, dev)
        packed.append(values)
    table = host_read(torch.stack(packed))                  # [k, n_metrics]

    folds = []
    for i in range(k):
        regime_counts = np.bincount(labels[i * fold_len:(i + 1) * fold_len], minlength=4)
        folds.append({
            "fold": i,
            "regime": REGIME_NAMES[int(np.argmax(regime_counts))],
            "metrics": {n: float(v) for n, v in zip(names, table[i])},
        })

    sharpes = [f["metrics"]["sharpe_ratio"] for f in folds]
    # per-regime aggregation (`strategy_evaluation_system.py:587`)
    by_regime: dict[str, list] = {}
    for f in folds:
        by_regime.setdefault(f["regime"], []).append(f["metrics"]["sharpe_ratio"])
    return {
        "folds": folds,
        "mean_sharpe": float(np.mean(sharpes)),
        "std_sharpe": float(np.std(sharpes)),
        "regime_sharpe": {r: float(np.mean(v)) for r, v in by_regime.items()},
    }


def compare_strategies(ohlcv: dict, named_params: dict[str, StrategyParams],
                       device=None) -> dict:
    """Side-by-side comparison (`strategy_evaluation.py:1439`) on ``device``
    (default: the CUDA card): the strategies stacked into one population
    [S] and backtested together, the metric table read back once."""
    dev = resolve_device(device)
    names = list(named_params)
    stacked = StrategyParams(*(
        torch.stack([to_device(getattr(p, f), dev, torch.float32).reshape(())
                     for p in named_params.values()])
        for f in StrategyParams._fields))
    stats = evolvable_backtest(ohlcv, stacked, device=dev)
    keys, values = _packed_metrics(stats, dev)
    table_np = host_read(values)                            # [n_metrics, S]
    table = {name: {kk: float(table_np[j, i]) for j, kk in enumerate(keys)}
             for i, name in enumerate(names)}
    ranked = sorted(names, key=lambda n: -table[n]["sharpe_ratio"])
    return {"table": table, "ranked": ranked, "best": ranked[0]}
