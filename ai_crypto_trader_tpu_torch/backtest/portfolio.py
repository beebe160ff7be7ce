"""Portfolio-level backtesting: every symbol of a universe under one strategy.

Port of `ai_crypto_trader_tpu/backtest/portfolio.py`.  `stack_symbol_inputs`
stacks per-symbol candles (left-padded to a common length) into one
indicator table and BacktestInputs with a leading symbol axis [S, T];
`portfolio_backtest` runs every symbol in its own capital silo, or with
``shared_capital`` over one pool with a global position cap
(`shared_capital_backtest`).

On the card:
  * `stack_symbol_inputs` makes one `compute_indicators` call over the [S, T]
    stack — two launches of the fused-EWMA kernel, not 2·S.  Indicators are
    computed per row, so each row is what that symbol alone would give;
  * the silos are one `run_backtest` over all [S, T]: in ``use_param_sl_tp``
    mode that is one launch of the replay kernel per symbol (the kernel's
    rows form shares close and volume across rows, and every symbol has
    its own); the sizer-ladder mode runs the engine's plain loop, as
    `run_backtest` does for one symbol;
  * `shared_capital_backtest` is a loop over candles with the S-symbol
    inner loop in Python, as the JAX package's `lax.scan` is (no kernel
    computes it).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ai_crypto_trader_tpu_torch.backtest import signals as sig
from ai_crypto_trader_tpu_torch.backtest.engine import (
    BacktestInputs,
    BacktestStats,
    _on,
    prepare_inputs,
    run_backtest,
)
from ai_crypto_trader_tpu_torch.backtest.metrics import compute_metrics
from ai_crypto_trader_tpu_torch.backtest.strategy import StrategyParams
from ai_crypto_trader_tpu_torch.device import resolve_device
from ai_crypto_trader_tpu_torch.ops.indicators import compute_indicators


def stack_symbol_inputs(per_symbol: dict, device=None) -> tuple[BacktestInputs, list[str]]:
    """{symbol: ohlcv dict} → (BacktestInputs [S, T], sorted symbols).

    Shorter series are LEFT-padded by repeating their first candle (prices
    flat → no trades during padding)."""
    dev = resolve_device(device)
    symbols = sorted(per_symbol)
    T = max(len(np.asarray(d["close"])) for d in per_symbol.values())

    def pad(v):
        v = np.asarray(v, np.float32)
        if len(v) < T:
            v = np.concatenate([np.full(T - len(v), v[0], np.float32), v])
        return v

    stacked = {k: np.stack([pad(per_symbol[s][k]) for s in symbols])
               for k in ("open", "high", "low", "close", "volume")}
    inp = prepare_inputs(compute_indicators(stacked, device=dev), device=dev)
    # prepare_inputs makes the AI gate and the overrides one shared [T] row
    shape = inp.close.shape
    return inp._replace(confidence=inp.confidence.expand(shape).contiguous(),
                        sl_pct=inp.sl_pct.expand(shape).contiguous(),
                        tp_pct=inp.tp_pct.expand(shape).contiguous()), symbols


class SharedCarry(NamedTuple):
    """Carry of the shared-capital replay: ONE balance, an [S]-slot position
    table, portfolio-level stat accumulators, and the per-symbol realized
    P&L and trade counts."""

    balance: torch.Tensor       # scalar f32 — the shared capital pool
    last_booked: torch.Tensor   # balance at the last booked equity point
    n_open: torch.Tensor        # scalar i32 — open slots used (global cap)
    in_pos: torch.Tensor        # [S] bool
    entry: torch.Tensor         # [S]
    qty: torch.Tensor           # [S]
    sl: torch.Tensor            # [S] percent units
    tp: torch.Tensor            # [S]
    max_equity: torch.Tensor
    max_dd: torch.Tensor
    max_dd_pct: torch.Tensor
    trades: torch.Tensor        # i32
    wins: torch.Tensor
    total_profit: torch.Tensor
    total_loss: torch.Tensor
    sum_r: torch.Tensor
    sum_r2: torch.Tensor
    sum_neg_r2: torch.Tensor
    n_r: torch.Tensor
    cur_win_streak: torch.Tensor
    cur_loss_streak: torch.Tensor
    max_win_streak: torch.Tensor
    max_loss_streak: torch.Tensor
    sym_trades: torch.Tensor    # [S] i32
    sym_pnl: torch.Tensor       # [S] realized P&L per symbol


def _set(x, s: int, value):
    """``x`` with element ``s`` replaced (a new tensor; the carry is never
    written in place)."""
    x = x.clone()
    x[s] = value
    return x


def _shared_close(c: SharedCarry, s: int, price, do_close) -> SharedCarry:
    """Book a close of symbol slot ``s`` where ``do_close``: realize P&L
    into the shared balance, free the slot, update streaks."""
    pnl = (price - c.entry[s]) * c.qty[s]
    win = pnl > 0.0
    closed = do_close.to(torch.int32)
    won = (do_close & win).to(torch.int32)
    cw = torch.where(do_close, torch.where(win, c.cur_win_streak + 1, 0), c.cur_win_streak)
    cl = torch.where(do_close, torch.where(win, 0, c.cur_loss_streak + 1), c.cur_loss_streak)
    booked = torch.where(do_close, pnl, 0.0)
    return c._replace(
        balance=c.balance + booked,
        n_open=c.n_open - closed,
        in_pos=_set(c.in_pos, s, c.in_pos[s] & ~do_close),
        trades=c.trades + closed,
        wins=c.wins + won,
        total_profit=c.total_profit + torch.where(do_close & win, pnl, 0.0),
        total_loss=c.total_loss + torch.where(do_close & ~win, -pnl, 0.0),
        cur_win_streak=cw, cur_loss_streak=cl,
        max_win_streak=torch.maximum(c.max_win_streak, cw),
        max_loss_streak=torch.maximum(c.max_loss_streak, cl),
        sym_trades=_set(c.sym_trades, s, c.sym_trades[s] + closed),
        sym_pnl=_set(c.sym_pnl, s, c.sym_pnl[s] + booked),
    )


def _book_equity(c: SharedCarry, book, baseline) -> SharedCarry:
    """Book one equity/return/drawdown point where ``book``: the return
    measured against ``baseline`` (the last booked balance for the
    reference's per-update cadence; the candle-open balance per candle)."""
    equity = c.balance
    max_eq = torch.where(book, torch.maximum(c.max_equity, equity), c.max_equity)
    dd = max_eq - equity
    dd_pct = dd / max_eq * 100.0
    new_max = book & (dd > c.max_dd)
    r = torch.where(book, (equity - baseline) / baseline, 0.0)
    return c._replace(
        last_booked=torch.where(book, equity, c.last_booked),
        max_equity=max_eq,
        max_dd=torch.where(new_max, dd, c.max_dd),
        max_dd_pct=torch.where(new_max, dd_pct, c.max_dd_pct),
        sum_r=c.sum_r + r,
        sum_r2=c.sum_r2 + r * r,
        sum_neg_r2=c.sum_neg_r2 + torch.where(r < 0, r * r, 0.0),
        n_r=c.n_r + book.to(torch.int32),
    )


def _init_carry(initial_balance, S, dev) -> SharedCarry:
    f = lambda v: torch.full((), v, dtype=torch.float32, device=dev)  # noqa: E731
    i = lambda v: torch.full((), v, dtype=torch.int32, device=dev)    # noqa: E731
    zf = lambda: torch.zeros((S,), dtype=torch.float32, device=dev)  # noqa: E731
    return SharedCarry(
        balance=f(initial_balance), last_booked=f(initial_balance), n_open=i(0),
        in_pos=torch.zeros((S,), dtype=torch.bool, device=dev),
        entry=zf(), qty=zf(), sl=zf(), tp=zf(),
        max_equity=f(initial_balance), max_dd=f(0.0), max_dd_pct=f(0.0),
        trades=i(0), wins=i(0), total_profit=f(0.0), total_loss=f(0.0),
        sum_r=f(0.0), sum_r2=f(0.0), sum_neg_r2=f(0.0), n_r=i(1),
        cur_win_streak=i(0), cur_loss_streak=i(0),
        max_win_streak=i(0), max_loss_streak=i(0),
        sym_trades=torch.zeros((S,), dtype=torch.int32, device=dev),
        sym_pnl=zf(),
    )


def shared_capital_backtest(
    inputs: BacktestInputs,
    params: StrategyParams | None = None,
    initial_balance: float = 10_000.0,
    max_positions: int = 5,
    ai_confidence_threshold: float = 0.7,
    min_signal_strength: float = 70.0,
    warmup: int = 10,
    use_param_sl_tp: bool = False,
    unroll: int = 1,
    equity_cadence: str = "per_update",
    device=None,
):
    """Multi-symbol replay over ONE capital pool with a global position cap
    (the reference books every open and close against one balance and
    refuses entries once ``max_positions`` are open).  Returns
    ``(BacktestStats of 0-d tensors, {"trades": [S], "realized_pnl": [S]})``.

    The JAX package's contract: ``inputs`` carries a leading symbol axis
    [S, T]; within a candle, symbols are processed in ascending order, so
    symbol 0's exit frees capital and a slot that symbol 1's entry sees in
    the same candle; exits before entries per symbol, and a closed slot may
    re-enter at the same candle; entries are sized by `position_size` on
    the running shared balance while ``n_open < max_positions``; equity is
    booked ``"per_update"`` (one point per symbol update that reaches the
    reference's booking, against the previously booked balance) or
    ``"per_candle"`` (once per active candle, against the candle-open
    balance); at the end every open slot is liquidated at its last close, in
    symbol order.  ``unroll`` is accepted for the JAX package's signature
    and ignored: it unrolls a `lax.scan`, and a Python loop has nothing to
    unroll."""
    del unroll
    if equity_cadence not in ("per_update", "per_candle"):
        raise ValueError(f"unknown equity_cadence {equity_cadence!r}")
    if use_param_sl_tp and params is None:
        raise ValueError("use_param_sl_tp needs StrategyParams")
    dev = resolve_device(device)
    inputs = _on(inputs, dev)
    params = None if params is None else _on(params, dev)
    S, T = inputs.close.shape
    c = _init_carry(initial_balance, S, dev)
    cols = [x.t().contiguous() for x in inputs]              # [T, S] each

    for t in range(T):
        (close, signal, strength, vol, volume, conf, decision,
         slov, tpov) = (x[t] for x in cols)
        active = t >= warmup
        prev_balance = c.balance
        for s in range(S):
            # --- exit scan on slot s ---
            entry_safe = torch.where(c.entry[s] == 0.0, 1.0, c.entry[s])
            pnl_pct = (close[s] - c.entry[s]) / entry_safe * 100.0
            hit_sl = c.in_pos[s] & (pnl_pct <= -c.sl[s]) & active
            hit_tp = c.in_pos[s] & ~hit_sl & (pnl_pct >= c.tp[s]) & active
            c = _shared_close(c, s, close[s], hit_sl | hit_tp)

            # the reference skips the booking when the symbol still holds
            # after exits or the slot cap binds
            reaches_booking = ~c.in_pos[s] & (c.n_open < max_positions) & active

            # --- entry gate: shared balance + global slot cap ---
            gate = (reaches_booking
                    & (conf[s] >= ai_confidence_threshold)
                    & (strength[s] >= min_signal_strength)
                    & (signal[s] == decision[s])
                    & (decision[s] == sig.BUY))
            plan = sig.position_size(c.balance, vol[s], volume[s])
            if use_param_sl_tp:
                sl_new, tp_new = params.stop_loss, params.take_profit
            else:
                sl_new = plan.stop_loss_pct * 100.0
                tp_new = plan.take_profit_pct * 100.0
            sl_new = torch.where(torch.isnan(slov[s]), sl_new, slov[s])
            tp_new = torch.where(torch.isnan(tpov[s]), tp_new, tpov[s])
            c = c._replace(
                n_open=c.n_open + gate.to(torch.int32),
                in_pos=_set(c.in_pos, s, c.in_pos[s] | gate),
                entry=_set(c.entry, s, torch.where(gate, close[s], c.entry[s])),
                qty=_set(c.qty, s, torch.where(gate, plan.size / close[s], c.qty[s])),
                sl=_set(c.sl, s, torch.where(gate, sl_new, c.sl[s])),
                tp=_set(c.tp, s, torch.where(gate, tp_new, c.tp[s])),
            )
            if equity_cadence == "per_update":
                c = _book_equity(c, reaches_booking, c.last_booked)
        if equity_cadence == "per_candle":
            c = _book_equity(c, torch.full((), active, device=dev), prev_balance)

    # liquidate remaining slots at their last close ("End of Test")
    for s in range(S):
        c = _shared_close(c, s, inputs.close[s, -1], c.in_pos[s])

    stats = BacktestStats(
        initial_balance=torch.full((), initial_balance, dtype=torch.float32, device=dev),
        final_balance=c.balance,
        total_trades=c.trades,
        winning_trades=c.wins,
        losing_trades=c.trades - c.wins,
        total_profit=c.total_profit,
        total_loss=c.total_loss,
        max_drawdown=c.max_dd,
        max_drawdown_pct=c.max_dd_pct,
        sum_r=c.sum_r,
        sum_r2=c.sum_r2,
        sum_neg_r2=c.sum_neg_r2,
        n_r=c.n_r,
        max_win_streak=c.max_win_streak,
        max_loss_streak=c.max_loss_streak,
    )
    return stats, {"trades": c.sym_trades, "realized_pnl": c.sym_pnl}


def portfolio_backtest(inputs: BacktestInputs, params: StrategyParams | None = None,
                       initial_balance_per_symbol: float = 10_000.0,
                       use_param_sl_tp: bool = False,
                       shared_capital: bool = False,
                       max_positions: int = 5,
                       device=None):
    """Run every symbol (leading axis of ``inputs``) under one strategy:
    ``(stats, metrics, portfolio aggregates)``.

    ``shared_capital=False``: symbols run in independent capital silos —
    per-symbol stats [S], plus portfolio aggregates.
    ``shared_capital=True``: symbols compete for ONE pool of
    ``initial_balance_per_symbol × n_symbols`` under ``max_positions``
    global slots (`shared_capital_backtest`); per-symbol stats reduce to
    trade counts and realized P&L, and the drawdown is portfolio-level."""
    dev = resolve_device(device)
    inputs = _on(inputs, dev)
    params = None if params is None else _on(params, dev)
    if shared_capital:
        n_symbols = inputs.close.shape[0]
        stats, per_symbol = shared_capital_backtest(
            inputs, params, initial_balance=initial_balance_per_symbol * n_symbols,
            max_positions=max_positions, use_param_sl_tp=use_param_sl_tp, device=dev)
        m = compute_metrics(stats, device=dev)
        portfolio = {
            "total_initial": stats.initial_balance,
            "total_final": stats.final_balance,
            "total_return_pct": (stats.final_balance - stats.initial_balance)
            / stats.initial_balance * 100.0,
            "total_trades": stats.total_trades,
            "mean_sharpe": m["sharpe_ratio"],
            "max_drawdown_pct": stats.max_drawdown_pct,
            "per_symbol_trades": per_symbol["trades"],
            "per_symbol_realized_pnl": per_symbol["realized_pnl"],
        }
        return stats, m, portfolio
    stats = run_backtest(inputs, params, initial_balance=initial_balance_per_symbol,
                         use_param_sl_tp=use_param_sl_tp, device=dev)
    m = compute_metrics(stats, device=dev)
    n = stats.final_balance.shape[0]
    # a tensor: a division by it stays a true division on either device
    total_initial = torch.full((), initial_balance_per_symbol * n, dtype=torch.float32,
                               device=dev)
    total_final = stats.final_balance.sum()
    portfolio = {
        "total_initial": total_initial,
        "total_final": total_final,
        "total_return_pct": (total_final - total_initial) / total_initial * 100.0,
        "total_trades": stats.total_trades.sum(),
        "mean_sharpe": m["sharpe_ratio"].mean(),
        "worst_symbol_drawdown_pct": stats.max_drawdown_pct.max(),
    }
    return stats, m, portfolio
