"""The backtest engine: a loop over the candle axis with a vectorized carry.

Port of `ai_crypto_trader_tpu/backtest/engine.py`.  The JAX package scans
`replay_step` over candles and vmaps it over strategies; here `replay_step`
is the same transition on tensors whose leading shape is the population
(or nothing, for one strategy), and `run_backtest` is a plain Python loop
over T.  That loop is the plain version of the replay kernel: on a CUDA
device `sweep`, and `run_backtest` in ``use_param_sl_tp`` mode without
``sell_exits`` over one candle series, launch `ops.replay.sweep_kernel`
(the port of the Pallas kernel `ops/pallas_backtest.py:sweep_pallas`)
instead.  The other modes of `run_backtest` run the loop on either device,
as the JAX package has no kernel for them either.

Parity contract (as the JAX engine's, strategy_tester.py:190-300 of the
reference): the first `warmup` candles are skipped; SL/TP are checked on
realized pnl% before any open, and a position closed at candle t may be
re-opened at t; balance changes only on close; win = pnl > 0; Sharpe
moments are streamed per booked candle with an initial zero return.
``reference_quirks=True`` reproduces the reference's fractional-stop unit
bug (stops 100× tighter); it has no effect with ``use_param_sl_tp``.
Counts are int32, as in the JAX package.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ai_crypto_trader_tpu_torch.backtest import signals as sig
from ai_crypto_trader_tpu_torch.backtest.strategy import StrategyParams
from ai_crypto_trader_tpu_torch.device import resolve_device, to_device


class BacktestInputs(NamedTuple):
    """Per-candle tensors consumed by the replay, each [T] or with leading
    strategy axes [..., T] (the GA's per-genome rows).  sl_pct / tp_pct are
    optional per-candle exit levels (percent); NaN means "no override"."""

    close: torch.Tensor
    signal: torch.Tensor        # int32 {-1,0,1}
    strength: torch.Tensor      # f32 [0,100]
    volatility: torch.Tensor    # ATR/close
    volume: torch.Tensor        # avg quote volume
    confidence: torch.Tensor    # AI-gate confidence in [0,1]
    decision: torch.Tensor      # AI-gate decision int32 {-1,0,1}
    sl_pct: torch.Tensor        # per-candle SL override (NaN = none)
    tp_pct: torch.Tensor        # per-candle TP override (NaN = none)


class CarryState(NamedTuple):
    balance: torch.Tensor
    in_pos: torch.Tensor        # bool
    entry: torch.Tensor
    qty: torch.Tensor
    sl: torch.Tensor            # stop-loss threshold, percent units
    tp: torch.Tensor
    max_equity: torch.Tensor
    max_dd: torch.Tensor
    max_dd_pct: torch.Tensor
    trades: torch.Tensor        # i32 closed trades
    wins: torch.Tensor
    total_profit: torch.Tensor
    total_loss: torch.Tensor
    sum_r: torch.Tensor         # streaming return moments for Sharpe/Sortino
    sum_r2: torch.Tensor
    sum_neg_r2: torch.Tensor
    n_r: torch.Tensor
    cur_win_streak: torch.Tensor
    cur_loss_streak: torch.Tensor
    max_win_streak: torch.Tensor
    max_loss_streak: torch.Tensor


class BacktestStats(NamedTuple):
    """Raw replay outputs; compute_metrics() derives the metric suite."""

    initial_balance: torch.Tensor
    final_balance: torch.Tensor
    total_trades: torch.Tensor
    winning_trades: torch.Tensor
    losing_trades: torch.Tensor
    total_profit: torch.Tensor
    total_loss: torch.Tensor
    max_drawdown: torch.Tensor
    max_drawdown_pct: torch.Tensor
    sum_r: torch.Tensor
    sum_r2: torch.Tensor
    sum_neg_r2: torch.Tensor
    n_r: torch.Tensor
    max_win_streak: torch.Tensor
    max_loss_streak: torch.Tensor


def _on(tup, dev):
    """A NamedTuple of arrays as tensors on ``dev`` (dtypes kept)."""
    return type(tup)(*(to_device(v, dev) for v in tup))


def prepare_inputs(ind: dict, confidence=None, decision=None,
                   per_candle_trend: bool = True, device=None) -> BacktestInputs:
    """Indicator table → replay inputs.  The AI gate defaults to
    pass-through (confidence 1, decision = technical signal)."""
    dev = resolve_device(device)
    ind = {k: to_device(v, dev) for k, v in ind.items()}
    feats = sig.compute_signal_features(ind, per_candle_trend=per_candle_trend)
    signal, strength = sig.reference_signal(feats)
    T = feats.close.shape[-1]
    confidence = (torch.ones((T,), dtype=torch.float32, device=dev)
                  if confidence is None else to_device(confidence, dev))
    decision = signal if decision is None else to_device(decision, dev)
    nan = torch.full((T,), math.nan, dtype=torch.float32, device=dev)
    return BacktestInputs(
        close=feats.close, signal=signal, strength=strength,
        volatility=feats.volatility, volume=feats.volume,
        confidence=confidence, decision=decision,
        sl_pct=nan, tp_pct=nan,
    )


def _init_state(initial_balance, shape, dev) -> CarryState:
    f = lambda v: torch.full(shape, v, dtype=torch.float32, device=dev)  # noqa: E731
    i = lambda v: torch.full(shape, v, dtype=torch.int32, device=dev)  # noqa: E731
    return CarryState(
        balance=f(initial_balance), in_pos=torch.zeros(shape, dtype=torch.bool, device=dev),
        entry=f(0.0), qty=f(0.0), sl=f(0.0), tp=f(0.0),
        max_equity=f(initial_balance), max_dd=f(0.0), max_dd_pct=f(0.0),
        trades=i(0), wins=i(0), total_profit=f(0.0), total_loss=f(0.0),
        # n_r starts at 1: the reference's equity curve holds an initial
        # point whose return is 0.
        sum_r=f(0.0), sum_r2=f(0.0), sum_neg_r2=f(0.0), n_r=i(1),
        cur_win_streak=i(0), cur_loss_streak=i(0),
        max_win_streak=i(0), max_loss_streak=i(0),
    )


def _book_close(s: CarryState, price, do_close) -> CarryState:
    """Close the open position where do_close."""
    pnl = (price - s.entry) * s.qty
    win = pnl > 0.0
    cw = torch.where(do_close, torch.where(win, s.cur_win_streak + 1, 0), s.cur_win_streak)
    cl = torch.where(do_close, torch.where(win, 0, s.cur_loss_streak + 1), s.cur_loss_streak)
    return s._replace(
        balance=s.balance + torch.where(do_close, pnl, 0.0),
        in_pos=s.in_pos & ~do_close,
        trades=s.trades + do_close.to(torch.int32),
        wins=s.wins + (do_close & win).to(torch.int32),
        total_profit=s.total_profit + torch.where(do_close & win, pnl, 0.0),
        total_loss=s.total_loss + torch.where(do_close & ~win, -pnl, 0.0),
        cur_win_streak=cw.to(torch.int32), cur_loss_streak=cl.to(torch.int32),
        max_win_streak=torch.maximum(s.max_win_streak, cw).to(torch.int32),
        max_loss_streak=torch.maximum(s.max_loss_streak, cl).to(torch.int32),
    )


def replay_step(params: StrategyParams | None, *, warmup: int,
                ai_confidence_threshold, min_signal_strength,
                reference_quirks: bool, use_param_sl_tp: bool,
                return_curve: bool, sell_exits: bool):
    """THE per-candle replay transition.  Returns ``step(state, x)`` where
    ``x`` is (t, close, signal, strength, volatility, volume, confidence,
    decision, sl_override, tp_override), ``t`` a Python int and the rest
    tensors broadcastable against the state."""

    def step(s: CarryState, x):
        (t, close, signal, strength, vol, volume, conf, decision,
         sl_override, tp_override) = x
        active = t >= warmup
        prev_balance = s.balance

        # --- SL/TP scan on the open position ---
        entry_safe = torch.where(s.entry == 0.0, 1.0, s.entry)
        pnl_pct = (close - s.entry) / entry_safe * 100.0
        open_ = s.in_pos & active
        hit_sl = open_ & (pnl_pct <= -s.sl)
        hit_tp = open_ & ~hit_sl & (pnl_pct >= s.tp)
        closing = hit_sl | hit_tp
        if sell_exits:
            # an explicit SELL closes the open position (off by default)
            closing = closing | (open_ & ~hit_sl & ~hit_tp & (signal == sig.SELL))
        # A surviving position short-circuits the rest of the candle: no
        # entry attempt and no equity point.
        survived = s.in_pos & ~closing
        s = _book_close(s, close, closing)

        # --- entry gate ---
        gate = (
            ~s.in_pos & active
            & (conf >= ai_confidence_threshold)
            & (strength >= min_signal_strength)
            & (signal == decision)
            & (decision == sig.BUY)
        )
        plan = sig.position_size(s.balance, vol, volume)
        if use_param_sl_tp:
            sl_new, tp_new = params.stop_loss, params.take_profit
        else:
            unit = 1.0 if reference_quirks else 100.0
            sl_new = plan.stop_loss_pct * unit
            tp_new = plan.take_profit_pct * unit
        # per-candle overrides (ATR-adaptive stops) win where provided
        sl_new = torch.where(torch.isnan(sl_override), sl_new, sl_override)
        tp_new = torch.where(torch.isnan(tp_override), tp_new, tp_override)
        s = s._replace(
            in_pos=s.in_pos | gate,
            entry=torch.where(gate, close, s.entry),
            qty=torch.where(gate, plan.size / close, s.qty),
            sl=torch.where(gate, sl_new, s.sl),
            tp=torch.where(gate, tp_new, s.tp),
        )

        # --- equity point + drawdown, only on candles the reference
        # reaches (not short-circuited) ---
        book = ~survived & active
        equity = s.balance
        max_eq = torch.where(book, torch.maximum(s.max_equity, equity), s.max_equity)
        dd = max_eq - equity
        dd_pct = dd / max_eq * 100.0
        new_max = book & (dd > s.max_dd)
        r = torch.where(book, (equity - prev_balance) / prev_balance, 0.0)
        s = s._replace(
            max_equity=max_eq,
            max_dd=torch.where(new_max, dd, s.max_dd),
            max_dd_pct=torch.where(new_max, dd_pct, s.max_dd_pct),
            sum_r=s.sum_r + r,
            sum_r2=s.sum_r2 + r * r,
            sum_neg_r2=s.sum_neg_r2 + torch.where(r < 0, r * r, 0.0),
            n_r=s.n_r + book.to(torch.int32),
        )
        return s, (equity if return_curve else None)

    return step


def finalize_stats(final: CarryState, last_close, initial_balance) -> BacktestStats:
    """Close any remaining position at the last price ("End of Test") and
    assemble the raw stats."""
    final = _book_close(final, last_close, final.in_pos)
    return BacktestStats(
        initial_balance=torch.full(final.balance.shape, initial_balance,
                                   dtype=torch.float32, device=final.balance.device),
        final_balance=final.balance,
        total_trades=final.trades,
        winning_trades=final.wins,
        losing_trades=final.trades - final.wins,
        total_profit=final.total_profit,
        total_loss=final.total_loss,
        max_drawdown=final.max_dd,
        max_drawdown_pct=final.max_dd_pct,
        sum_r=final.sum_r,
        sum_r2=final.sum_r2,
        sum_neg_r2=final.sum_neg_r2,
        n_r=final.n_r,
        max_win_streak=final.max_win_streak,
        max_loss_streak=final.max_loss_streak,
    )


def replay(inputs: BacktestInputs, params: StrategyParams | None = None, *,
           initial_balance: float = 10_000.0,
           ai_confidence_threshold: float = 0.7,
           min_signal_strength: float = 70.0, warmup: int = 10,
           reference_quirks: bool = False, use_param_sl_tp: bool = False,
           return_curve: bool = False, sell_exits: bool = False):
    """The plain loop over T on the inputs' device.  The carry takes the
    broadcast of the inputs' leading shape and the params' shape."""
    if use_param_sl_tp and params is None:
        raise ValueError("use_param_sl_tp needs StrategyParams")
    dev = inputs.close.device
    T = inputs.close.shape[-1]
    shape = inputs.close.shape[:-1]
    if params is not None:
        shape = torch.broadcast_shapes(shape, params.stop_loss.shape)
    step = replay_step(
        params, warmup=warmup,
        ai_confidence_threshold=ai_confidence_threshold,
        min_signal_strength=min_signal_strength,
        reference_quirks=reference_quirks, use_param_sl_tp=use_param_sl_tp,
        return_curve=return_curve, sell_exits=sell_exits)
    s = _init_state(initial_balance, shape, dev)
    curve = (torch.empty(tuple(shape) + (T,), dtype=torch.float32, device=dev)
             if return_curve else None)
    for t in range(T):
        s, equity = step(s, (t,) + tuple(x[..., t] for x in inputs))
        if return_curve:
            curve[..., t] = equity
    stats = finalize_stats(s, inputs.close[..., -1], initial_balance)
    return (stats, curve) if return_curve else stats


def run_backtest(inputs: BacktestInputs, params: StrategyParams | None = None, *,
                 initial_balance: float = 10_000.0,
                 ai_confidence_threshold: float = 0.7,
                 min_signal_strength: float = 70.0, warmup: int = 10,
                 reference_quirks: bool = False, use_param_sl_tp: bool = False,
                 return_curve: bool = False, sell_exits: bool = False,
                 device=None):
    """One backtest (or a broadcast batch) on ``device`` (default: the CUDA
    card).  With ``use_param_sl_tp`` the StrategyParams stop_loss /
    take_profit (percent) override the sizer's volatility ladder;
    ``sell_exits`` adds an explicit SELL-signal close.  On CUDA the
    ``use_param_sl_tp`` mode without ``sell_exits`` over one candle series
    (``close`` [T]) runs the replay kernel over the broadcast of the
    params' shape and the leading shape of the other streams, which may
    carry a row per strategy (the GA's per-genome signals and exits;
    ``reference_quirks`` changes nothing there); every other mode, a batch
    of series, and the CPU run the plain loop."""
    dev = resolve_device(device)
    inputs = _on(inputs, dev)
    params = None if params is None else _on(params, dev)
    kw = dict(initial_balance=initial_balance,
              ai_confidence_threshold=ai_confidence_threshold,
              min_signal_strength=min_signal_strength, warmup=warmup)
    if dev.type == "cuda" and use_param_sl_tp and not sell_exits and inputs.close.ndim == 1:
        if params is None:
            raise ValueError("use_param_sl_tp needs StrategyParams")
        # imported here: ops.replay imports this module
        from ai_crypto_trader_tpu_torch.ops.replay import sweep_kernel

        T = inputs.close.shape[-1]
        shape = torch.broadcast_shapes(params.stop_loss.shape, params.take_profit.shape,
                                       *(x.shape[:-1] for x in inputs))
        flat = params._replace(stop_loss=params.stop_loss.expand(shape).reshape(-1),
                               take_profit=params.take_profit.expand(shape).reshape(-1))
        # a stream with a leading shape becomes [B, T] rows; [T] stays shared
        rows = type(inputs)(*(x if x.ndim == 1 else x.expand(shape + (T,)).reshape(-1, T)
                              for x in inputs))
        out = sweep_kernel(rows, flat, return_curve=return_curve, device=dev, **kw)
        stats, curve = out if return_curve else (out, None)
        stats = BacktestStats(*(v.reshape(shape) for v in stats))
        return (stats, curve.reshape(shape + curve.shape[-1:])) if return_curve else stats
    return replay(inputs, params, reference_quirks=reference_quirks,
                  use_param_sl_tp=use_param_sl_tp, return_curve=return_curve,
                  sell_exits=sell_exits, **kw)


def sweep(inputs: BacktestInputs, params: StrategyParams,
          initial_balance: float = 10_000.0,
          ai_confidence_threshold: float = 0.7,
          min_signal_strength: float = 70.0, warmup: int = 10,
          reference_quirks: bool = False, return_curve: bool = False,
          device=None):
    """The population sweep: every strategy of a stacked StrategyParams
    [B] over the same candles, in ``use_param_sl_tp`` mode.

    On CUDA it launches the replay kernel (`ops.replay.sweep_kernel`), on
    the CPU it runs the plain loop; with ``return_curve`` either returns
    ``(stats, curve)``, the curve [B, T].  ``inputs`` must carry NaN
    sl_pct/tp_pct columns for the genomes' stops to matter (as
    `prepare_inputs` builds them)."""
    dev = resolve_device(device)
    inputs = _on(inputs, dev)
    params = _on(params, dev)
    kw = dict(initial_balance=initial_balance,
              ai_confidence_threshold=ai_confidence_threshold,
              min_signal_strength=min_signal_strength, warmup=warmup,
              return_curve=return_curve)
    if dev.type == "cuda":
        # imported here: ops.replay imports this module
        from ai_crypto_trader_tpu_torch.ops.replay import sweep_kernel

        return sweep_kernel(inputs, params, device=dev, **kw)
    return replay(inputs, params, reference_quirks=reference_quirks,
                  use_param_sl_tp=True, **kw)
