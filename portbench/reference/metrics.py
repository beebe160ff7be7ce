"""The metric suite of a backtest, written plainly from its definitions.

Win rate, profit factor and Sharpe as the reference system's
strategy_tester defines them (Sharpe on per-candle equity returns,
population std, times sqrt(252), 0 when degenerate; profit factor 0 without
a losing trade), Sortino, Calmar, expectancy, recovery factor and streaks
as its strategy_evaluation service does, all from the replay's counts and
return moments.  float64 for the reference; the control passes `BF16`
arrays.
"""

from __future__ import annotations

import numpy as np

ANNUALIZATION = 252.0


def _div(num, den, ok):
    return np.where(ok, num / np.where(ok, den, 1.0), 0.0)


def metric_suite(s: dict) -> dict:
    """``s``: the replay's stats, arrays over strategies (the integer
    counts as integers)."""
    like = s["sum_r"]
    n = np.maximum(s["n_r"], 1) + np.zeros_like(like)
    mean_r = s["sum_r"] / n
    var_r = np.maximum(s["sum_r2"] / n - mean_r * mean_r, 0.0)
    std_r = np.sqrt(var_r)
    root = np.sqrt(ANNUALIZATION)
    sharpe = np.where((s["n_r"] > 1) & (std_r > 0.0), _div(mean_r, std_r, std_r > 0.0) * root, 0.0)
    downside = np.sqrt(s["sum_neg_r2"] / n)
    sortino = _div(mean_r, downside, downside > 0.0) * root
    trades = s["total_trades"] + np.zeros_like(like)
    wins = s["winning_trades"] + np.zeros_like(like)
    losses = s["losing_trades"] + np.zeros_like(like)
    win_rate = _div(wins, trades, trades > 0) * 100.0
    profit_factor = _div(s["total_profit"], s["total_loss"], s["total_loss"] > 0.0)
    initial = s["initial_balance"]
    net = s["final_balance"] - initial
    annual = mean_r * ANNUALIZATION * 100.0
    avg_win = _div(s["total_profit"], wins, wins > 0)
    avg_loss = _div(s["total_loss"], losses, losses > 0)
    rate = win_rate / 100.0
    return {
        "final_balance": s["final_balance"], "total_trades": trades,
        "winning_trades": wins, "losing_trades": losses,
        "win_rate": win_rate, "profit_factor": profit_factor,
        "total_profit": s["total_profit"], "total_loss": s["total_loss"],
        "max_drawdown": s["max_drawdown"], "max_drawdown_pct": s["max_drawdown_pct"],
        "sharpe_ratio": sharpe, "sortino_ratio": sortino,
        "calmar_ratio": _div(annual, s["max_drawdown_pct"], s["max_drawdown_pct"] > 0.0),
        "total_return_pct": net / initial * 100.0, "annualized_return_pct": annual,
        "expectancy": rate * avg_win - (1.0 - rate) * avg_loss,
        "avg_win": avg_win, "avg_loss": avg_loss,
        "recovery_factor": _div(net, s["max_drawdown"], s["max_drawdown"] > 0.0),
        "max_win_streak": s["max_win_streak"] + np.zeros_like(like),
        "max_loss_streak": s["max_loss_streak"] + np.zeros_like(like),
    }
