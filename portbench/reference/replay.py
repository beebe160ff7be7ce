"""The replay of one strategy over one candle series, written plainly.

The reference system's backtester (strategy_tester.py) in its
stop-loss / take-profit mode: from the warm-up on, a flat strategy opens a
position at a gate candle with the position sizer's size at the close; an
open position closes on the first later candle whose P&L percentage on the
close reaches -stop_loss or +take_profit (the stop checked first), and may
reopen on that same candle.  Balance changes only on a close, a win is a
P&L above 0, and an equity point (a return, the drawdown) is booked on
every candle the strategy starts flat or closes on; a candle spent holding
books nothing.  Whatever is open at the end closes at the last close.

Because nothing changes between events, the walk jumps from one event to
the next: the next gate candle while flat, the first candle beyond a stop
or target while holding.  All arithmetic is in the configuration's float32
(every operation rounded, no fused multiply-add), or in bfloat16 for the
control (``fmt="bf16"``): the rounding decides which candle hits a stop.
"""

from __future__ import annotations

import numpy as np

from portbench.reference.numerics import round_bf16
from portbench.reference.signals import WARMUP

INITIAL_BALANCE = 10_000.0
FIELDS_F = ("final_balance", "total_profit", "total_loss", "max_drawdown",
            "max_drawdown_pct", "sum_r", "sum_r2", "sum_neg_r2")
FIELDS_I = ("total_trades", "winning_trades", "losing_trades", "n_r",
            "max_win_streak", "max_loss_streak")


def _position_size(q, balance, vol, volume):
    """PositionSizer.calculate_position_size's size for ``balance``: the
    volatility ladder, the volume factor, the risk cap and the bounds."""
    f = np.float32
    if vol > f(0.02):
        pct, sl = f(0.25), f(0.02)
    elif vol > f(0.01):
        pct, sl = f(0.20), f(0.015)
    else:
        pct, sl = f(0.15), f(0.01)
    factor = min(q(volume / f(50_000.0)), f(1.0))
    size = q(q(balance * pct) * factor)
    size = min(size, q(q(balance * f(0.15)) / sl))
    size = min(size, q(balance * f(0.20)))
    size = max(size, q(balance * f(0.10)))
    return max(size, f(40.0))


def _first_exit(q, close, start, entry, sl, tp):
    """The first candle t >= start whose P&L % reaches -sl or +tp, or None."""
    T = close.shape[-1]
    lo, hi = -sl, tp
    n = 256
    while start < T:
        seg = close[start:start + n]
        pnl = q(q(q(seg - entry) / entry) * np.float32(100.0))
        hit = np.flatnonzero((pnl <= lo) | (pnl >= hi))
        if hit.size:
            return start + int(hit[0])
        start += seg.shape[-1]
        n = min(n * 4, 1 << 16)
    return None


def walk(close, gate, volatility, volume, stop_loss, take_profit, fmt="f32") -> dict:
    """One strategy's stats.  ``close``, ``volatility``, ``volume``: float32
    [T]; ``gate``: bool [T] (`signals.entry_gate`); ``stop_loss``,
    ``take_profit``: percent."""
    q = round_bf16 if fmt == "bf16" else (lambda v: v)
    f = np.float32
    close = q(np.asarray(close, dtype=f))
    vol = q(np.asarray(volatility, dtype=f))
    volume = q(np.asarray(volume, dtype=f))
    sl, tp = q(f(stop_loss)), q(f(take_profit))
    T = close.shape[-1]
    gates = np.flatnonzero(gate)

    balance = max_eq = q(f(INITIAL_BALANCE))
    max_dd = max_dd_pct = sum_r = sum_r2 = sum_neg = f(0.0)
    profit = loss = f(0.0)
    trades = wins = 0
    n_r = 1
    cur_w = cur_l = best_w = best_l = 0
    entry = qty = None
    t = WARMUP

    def close_at(price):
        nonlocal balance, trades, wins, profit, loss, cur_w, cur_l, best_w, best_l
        pnl = q(q(price - entry) * qty)
        win = pnl > f(0.0)
        balance = q(balance + pnl)
        trades += 1
        if win:
            wins += 1
            profit = q(profit + pnl)
            cur_w, cur_l = cur_w + 1, 0
        else:
            loss = q(loss + q(-pnl))
            cur_w, cur_l = 0, cur_l + 1
        best_w, best_l = max(best_w, cur_w), max(best_l, cur_l)

    def open_at(g):
        nonlocal entry, qty
        entry = close[g]
        qty = q(_position_size(q, balance, vol[g], volume[g]) / entry)

    while t < T:
        if entry is None:
            k = int(np.searchsorted(gates, t))
            if k == len(gates):
                n_r += T - t
                break
            g = int(gates[k])
            n_r += g - t + 1            # flat candles t..g, each books a zero return
            open_at(g)
            t = g + 1
            continue
        x = _first_exit(q, close, t, entry, sl, tp)
        if x is None:
            break
        prev = balance
        close_at(close[x])
        entry = None
        if gate[x]:
            open_at(x)
        max_eq = max(max_eq, balance)
        dd = q(max_eq - balance)
        if dd > max_dd:
            max_dd, max_dd_pct = dd, q(q(dd / max_eq) * f(100.0))
        r = q(q(balance - prev) / prev)
        sum_r = q(sum_r + r)
        r2 = q(r * r)
        sum_r2 = q(sum_r2 + r2)
        if r < f(0.0):
            sum_neg = q(sum_neg + r2)
        n_r += 1
        t = x + 1
    if entry is not None:
        close_at(close[T - 1])
    return {"final_balance": balance, "total_profit": profit, "total_loss": loss,
            "max_drawdown": max_dd, "max_drawdown_pct": max_dd_pct, "sum_r": sum_r,
            "sum_r2": sum_r2, "sum_neg_r2": sum_neg, "total_trades": trades,
            "winning_trades": wins, "losing_trades": trades - wins, "n_r": n_r,
            "max_win_streak": best_w, "max_loss_streak": best_l}
