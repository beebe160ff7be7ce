"""Performance-metric suite derived from BacktestStats, in PyTorch.

Port of `ai_crypto_trader_tpu/backtest/metrics.py:23-77`: win rate, profit
factor and Sharpe as the reference's strategy_tester defines them (Sharpe
on per-candle equity returns, population std, ×√252, 0 when degenerate;
profit factor 0 when there are no losing trades), and Sortino / Calmar /
expectancy / recovery / streaks from its strategy_evaluation service.  All
from the streaming moments the replay carries, O(1) per backtest.
"""

from __future__ import annotations

import numpy as np
import torch

from ai_crypto_trader_tpu_torch.backtest.engine import BacktestStats, _on
from ai_crypto_trader_tpu_torch.device import resolve_device


def _safe(x, cond):
    """``x`` where ``cond``, else 1 — the denominator guard of the JAX code."""
    return torch.where(cond, x, torch.ones_like(x))


def compute_metrics(s: BacktestStats, annualization: float = 252.0,
                    device=None) -> dict:
    dev = resolve_device(device)
    s = _on(s, dev)
    n = torch.clamp_min(s.n_r, 1).to(torch.float32)
    mean_r = s.sum_r / n
    var_r = torch.clamp_min(s.sum_r2 / n - mean_r * mean_r, 0.0)
    std_r = torch.sqrt(var_r)
    # float32 sqrt, as a Python float: a tensor made from the host here
    # would wait for the card
    sqrt_ann = float(np.sqrt(np.float32(annualization)))

    sharpe = torch.where((s.n_r > 1) & (std_r > 0.0),
                         mean_r / _safe(std_r, std_r > 0) * sqrt_ann, 0.0)

    downside = torch.sqrt(s.sum_neg_r2 / n)
    sortino = torch.where(downside > 0.0,
                          mean_r / _safe(downside, downside > 0) * sqrt_ann, 0.0)

    total_trades = s.total_trades.to(torch.float32)
    win_rate = torch.where(s.total_trades > 0,
                           s.winning_trades / torch.clamp_min(total_trades, 1.0) * 100.0,
                           0.0)
    profit_factor = torch.where(s.total_loss > 0.0,
                                s.total_profit / _safe(s.total_loss, s.total_loss > 0), 0.0)

    total_return_pct = (s.final_balance - s.initial_balance) / s.initial_balance * 100.0
    ann_return_pct = mean_r * annualization * 100.0
    calmar = torch.where(s.max_drawdown_pct > 0.0,
                         ann_return_pct / _safe(s.max_drawdown_pct, s.max_drawdown_pct > 0),
                         0.0)

    avg_win = torch.where(s.winning_trades > 0,
                          s.total_profit / torch.clamp_min(s.winning_trades, 1), 0.0)
    avg_loss = torch.where(s.losing_trades > 0,
                           s.total_loss / torch.clamp_min(s.losing_trades, 1), 0.0)
    wr = win_rate / 100.0
    expectancy = wr * avg_win - (1.0 - wr) * avg_loss

    net_profit = s.final_balance - s.initial_balance
    recovery = torch.where(s.max_drawdown > 0.0,
                           net_profit / _safe(s.max_drawdown, s.max_drawdown > 0), 0.0)

    return {
        "initial_balance": s.initial_balance,
        "final_balance": s.final_balance,
        "total_trades": s.total_trades,
        "winning_trades": s.winning_trades,
        "losing_trades": s.losing_trades,
        "win_rate": win_rate,
        "profit_factor": profit_factor,
        "total_profit": s.total_profit,
        "total_loss": s.total_loss,
        "max_drawdown": s.max_drawdown,
        "max_drawdown_pct": s.max_drawdown_pct,
        "sharpe_ratio": sharpe,
        "sortino_ratio": sortino,
        "calmar_ratio": calmar,
        "total_return_pct": total_return_pct,
        "annualized_return_pct": ann_return_pct,
        "expectancy": expectancy,
        "avg_win": avg_win,
        "avg_loss": avg_loss,
        "recovery_factor": recovery,
        "max_win_streak": s.max_win_streak,
        "max_loss_streak": s.max_loss_streak,
    }
