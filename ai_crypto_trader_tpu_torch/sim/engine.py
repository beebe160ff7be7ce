"""The strategy-vs-market rollout over a batch of adversarial scenarios.

Port of `ai_crypto_trader_tpu/sim/engine.py`.  `sweep()` is the headline
entry: path generation (`sim.paths`), matching (`sim.exchange`) and the
strategy's decision loop run over thousands of regime-switching /
flash-crash / liquidity-hole markets at once, with ONE host read a call
(the `host_read` seam below, the `ops/tick_engine.py` pattern).  The big
[B, T] outputs — candles, equity curves, fill logs — stay on the device
under ``"device"``.  Where the JAX package scans one jitted program over
the candles, the port loops over T in Python and each step is a fixed set
of tensor ops over the [B] scenarios (about 200 a candle): no host read and
no data-dependent shape inside the loop.

The rolled-out strategy is a deliberately simple, parity-mirrorable
long-only EMA cross with a protective STOP and a take-profit LIMIT: every
decision is a function of the candle close and the exchange state, so a
test can drive the JAX package's `FakeExchange` through the identical
decisions and pin the rollout trade by trade.  Realism lives in the MARKET
(the scenario batch), not in the strategy.

Two more workloads ride the same generators:

  * `backtest_under_stress` — the backtest engine over adversarial candle
    batches ([B] stats), or over a strategy population too ([B, P]): the
    indicators make K2's two launches, and with a population the replay is
    one K1 launch per scenario with the P strategies as its rows;
  * `scenario_env_params` — an `rl.env.EnvParams` whose tables carry a
    leading scenario axis, so every env reset draws a (scenario, offset).

``key``: a ``torch.Generator`` on the device, or a provider with the
generators' draw methods (``gbm(B, T)``, ``flow(B, T, L)``).

Rounding.  On the same candles and knobs the rollout equals the JAX
package's on the CPU bit for bit: the EMA updates ``ema + α·(close − ema)``
are rounded once, as the fused multiply-adds XLA's CPU program forms
(`device.plus_product`), and so is `exchange.equity`.
"""

from __future__ import annotations

import math
import time
from typing import NamedTuple

import numpy as np
import torch

from ai_crypto_trader_tpu_torch.device import (
    div_true, minus_product, plus_product, resolve_device, upload)
from ai_crypto_trader_tpu_torch.ops.tick_engine import read_packed, stage
from ai_crypto_trader_tpu_torch.sim import exchange as sx
from ai_crypto_trader_tpu_torch.sim import paths, scenarios
from ai_crypto_trader_tpu_torch.utils import devprof, meshprof

# slot layout the strategy uses (and the parity oracle mirrors): the stop is
# placed first, so FakeExchange's insertion-ordered matching walks the
# orders in the sequence of the unrolled slot loop
STOP_SLOT, TP_SLOT = 0, 1
N_SLOTS = 2
WARMUP = 32
OHLC = ("open", "high", "low", "close")
TRADE_KEYS = ("liquidity_mult", "spread", "halt", "latency")
# ``x / 100`` as XLA compiles it, a multiply by float32(0.01), and 1 ± that
# product rounded once (its fused multiply-add)
ONE, PCT = 1.0, float(np.float32(0.01))

_NP = {torch.float32: np.float32, torch.int32: np.int32}


def flatten(tree: dict, prefix: str = ""):
    """(dotted name, leaf) of every leaf of a nested dict."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from flatten(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def pack(tree: dict):
    """A nested dict of tensors on one device as one float32 tensor on its
    way to the host (`ops.tick_engine.stage`): float32 leaves, and int32
    counts, which float32 carries exactly below 2^24."""
    leaves = list(flatten(tree))
    packed = torch.cat([v.reshape(-1).to(torch.float32) for _, v in leaves])
    return stage(packed, [(name, tuple(v.shape), _NP[v.dtype]) for name, v in leaves])


def host_read(readback) -> dict:
    """THE per-call device→host read: wait for the one packed copy, unpack
    it into a nested dict of NumPy arrays.  A module-level seam, so tests
    can count reads.  Timed into the ``host_read`` SLO window, the
    sanctioned sync of a watch window."""
    t0 = time.perf_counter()
    with meshprof.allow_transfers():   # THE sanctioned device→host sync
        out = unpack(readback)
    devprof.observe_latency("host_read", time.perf_counter() - t0)
    return out


def unpack(readback) -> dict:
    """Wait for ``readback`` and unpack it into a nested dict of NumPy
    arrays (the body of this module's and `sim.lob`'s read seams)."""
    out = {}
    for name, value in read_packed(readback).items():
        *groups, leaf = name.split(".")
        node = out
        for g in groups:
            node = node.setdefault(g, {})
        node[leaf] = value
    return out


def on_device(tup, dev):
    """A NamedTuple of float32 knobs (tensors or NumPy) on ``dev``."""
    return type(tup)(*(upload(v, dev, torch.float32) for v in tup))


class SimStrategy(NamedTuple):
    """EMA-cross long-only strategy knobs, float32 tensors (0-d, or [B]: a
    per-scenario batch of strategies)."""

    alpha_fast: torch.Tensor     # fast EMA smoothing
    alpha_slow: torch.Tensor
    entry_margin: torch.Tensor   # enter when ema_fast > ema_slow·(1 + margin)
    sl_pct: torch.Tensor         # protective stop distance, percent
    tp_pct: torch.Tensor         # take-profit distance, percent
    trade_frac: torch.Tensor     # fraction of quote committed per entry
    min_notional: torch.Tensor   # quote value under which a book is "flat"


def default_strategy(alpha_fast: float = 2.0 / 13.0, alpha_slow: float = 2.0 / 49.0,
                     entry_margin: float = 0.001, sl_pct: float = 2.0, tp_pct: float = 4.0,
                     trade_frac: float = 0.25, min_notional: float = 1.0,
                     device=None) -> SimStrategy:
    dev = resolve_device(device)
    f = lambda v: torch.full((), v, dtype=torch.float32, device=dev)  # noqa: E731
    return SimStrategy(alpha_fast=f(alpha_fast), alpha_slow=f(alpha_slow),
                       entry_margin=f(entry_margin), sl_pct=f(sl_pct), tp_pct=f(tp_pct),
                       trade_frac=f(trade_frac), min_notional=f(min_notional))


class FillParams(NamedTuple):
    fee_rate: torch.Tensor
    max_fill_base: torch.Tensor   # per-candle per-order cap (inf = none)


def fill_params(fee_rate: float = 0.001, max_fill_base: float | None = 10.0,
                device=None) -> FillParams:
    """``max_fill_base`` defaults FINITE (far above the default strategy's
    sizes): the schedule's liquidity holes scale this cap, and inf × a hole
    stays inf.  None is FakeExchange's uncapped default."""
    dev = resolve_device(device)
    cap = math.inf if max_fill_base is None else max_fill_base
    return FillParams(fee_rate=torch.full((), fee_rate, dtype=torch.float32, device=dev),
                      max_fill_base=torch.full((), cap, dtype=torch.float32, device=dev))


class StratState(NamedTuple):
    """The strategy's carry, every field [B]."""

    ema_fast: torch.Tensor
    ema_slow: torch.Tensor
    entry: torch.Tensor        # intended entry price of the live position
    entries: torch.Tensor      # int32 count of entry orders submitted


def init_strat(batch: int, device) -> StratState:
    z = torch.zeros((batch,), dtype=torch.float32, device=device)
    return StratState(ema_fast=z, ema_slow=z, entry=z,
                      entries=torch.zeros((batch,), dtype=torch.int32, device=device))


def _strategy_step(strat: SimStrategy, st: StratState, exch: sx.ExchState, close, t, halt):
    """The mirrorable decision rule over the [B] venues (``t`` a 0-d int
    tensor).  Returns (state', requests): the requests drive the exchange
    calls of the rollout step — and, in the parity test, the identical
    FakeExchange calls."""
    first = t == 0
    ema_fast = torch.where(first, close,
                           plus_product(st.ema_fast, strat.alpha_fast, close - st.ema_fast))
    ema_slow = torch.where(first, close,
                           plus_product(st.ema_slow, strat.alpha_slow, close - st.ema_slow))
    flat = exch.base * close < strat.min_notional
    any_resting = exch.book.active.any(dim=-1)
    open_venue = halt == 0.0

    # post-exit hygiene: a flat book with resting protective orders means
    # the position closed last candle — cancel the surviving sibling(s)
    cancel_all = flat & any_resting & open_venue

    cross = ema_fast > ema_slow * (1.0 + strat.entry_margin)
    enter = (flat & ~(any_resting & ~cancel_all) & ~exch.pend_active & cross
             & (t >= WARMUP) & open_venue)
    entry_qty = strat.trade_frac * exch.quote / close

    # protective placement: a live position with no resting orders gets a
    # STOP (slot 0) + take-profit LIMIT (slot 1) sized to current holdings
    protect = ~flat & ~any_resting & open_venue
    stop_price = st.entry * minus_product(ONE, strat.sl_pct, PCT)
    tp_price = st.entry * plus_product(ONE, strat.tp_pct, PCT)

    st2 = StratState(ema_fast=ema_fast, ema_slow=ema_slow,
                     entry=torch.where(enter, close, st.entry),
                     entries=st.entries + enter.to(torch.int32))
    req = {"cancel_all": cancel_all, "enter": enter, "entry_qty": entry_qty,
           "protect": protect, "stop_price": stop_price, "tp_price": tp_price}
    return st2, req


def _requests_to_action(exch: sx.ExchState, req: dict) -> sx.Action:
    """The strategy's requests as the exchange's [B, 2] Action: a market BUY
    where it enters, a SELL STOP in slot 0 and a SELL LIMIT in slot 1 for
    the whole holding where it protects, cancels of both where it cleans
    up."""
    B = exch.quote.shape[0]
    zero = torch.zeros_like(req["stop_price"])
    slot_kind = torch.full((B, N_SLOTS), sx.LIMIT, dtype=torch.int32, device=zero.device)
    slot_kind[:, STOP_SLOT] = sx.STOP
    return sx.Action(
        market_qty=torch.where(req["enter"], req["entry_qty"], 0.0),
        market_side=torch.full((B,), sx.BUY, dtype=torch.int32, device=zero.device),
        cancel=req["cancel_all"].unsqueeze(-1).expand(B, N_SLOTS),
        place=req["protect"].unsqueeze(-1).expand(B, N_SLOTS),
        side=torch.full((B, N_SLOTS), sx.SELL, dtype=torch.int32, device=zero.device),
        kind=slot_kind,
        qty=exch.base.unsqueeze(-1).expand(B, N_SLOTS),
        limit_price=torch.stack([zero, req["tp_price"]], dim=-1),
        stop_price=torch.stack([req["stop_price"], zero], dim=-1))


class RolloutSummary(NamedTuple):
    """Per-scenario outcomes, every leaf [B]."""

    final_equity: torch.Tensor
    final_quote: torch.Tensor
    final_base: torch.Tensor
    fees: torch.Tensor
    n_fills: torch.Tensor
    dropped_fills: torch.Tensor
    entries: torch.Tensor
    max_drawdown: torch.Tensor   # fraction of the running equity peak
    min_equity: torch.Tensor


def account(acct, eq):
    """The running (peak, max drawdown, min equity) after equity ``eq``."""
    peak, max_dd, min_eq = acct
    peak = torch.maximum(peak, eq)
    return peak, torch.maximum(max_dd, (peak - eq) / peak), torch.minimum(min_eq, eq)


def agent_step(exch, st, candle: dict, t, sched_t: dict, cap, strat, fee_rate, gate=None):
    """One candle of the agent over the [B] venues: the parked order
    settles at the open, the book matches (``gate`` the LOB's queue
    precondition), the strategy decides, its requests apply.  Returns
    (exchange before the requests, exchange, strategy state)."""
    halt, spread = sched_t["halt"], sched_t["spread"]
    exch = sx.settle_pending(exch, candle, t, fee_rate, spread, halt)
    exch = sx.match_candle(exch, candle, t, cap, halt, fee_rate, gate=gate)
    st, req = _strategy_step(strat, st, exch, candle["close"], t, halt)
    after = sx.apply_action(exch, candle, t, _requests_to_action(exch, req), fee_rate, spread,
                            halt, sched_t["latency"])
    return exch, after, st


def _rollout(candles: dict, sched: dict, strat: SimStrategy, fp: FillParams, quote0,
             log_capacity: int):
    """Every scenario's rollout over its [B, T] candles and trade schedule
    channels: (RolloutSummary, fill logs [B, L, 6], equity curves [B, T])."""
    close = candles["close"]
    B, T = close.shape
    dev = close.device
    exch = sx.init_state(quote0, K=N_SLOTS, L=log_capacity, batch=B, device=dev)
    st = init_strat(B, dev)
    eq0 = sx.equity(exch, close[:, 0])
    acct = (eq0, torch.zeros_like(eq0), eq0)
    cols = {k: candles[k].unbind(1) for k in OHLC}
    chans = {k: sched[k].unbind(1) for k in TRADE_KEYS}
    caps = (fp.max_fill_base * sched["liquidity_mult"]).unbind(1)
    steps = torch.arange(T, dtype=torch.int32, device=dev).unbind(0)
    curve = []
    for t in range(T):
        candle = {k: cols[k][t] for k in OHLC}
        _, exch, st = agent_step(exch, st, candle, steps[t], {k: chans[k][t] for k in TRADE_KEYS},
                                 caps[t], strat, fp.fee_rate)
        eq = sx.equity(exch, candle["close"])
        acct = account(acct, eq)
        curve.append(eq)
    _peak, max_dd, min_eq = acct
    summary = RolloutSummary(
        final_equity=sx.equity(exch, close[:, -1]), final_quote=exch.quote,
        final_base=exch.base, fees=exch.fee_paid, n_fills=exch.n_fills,
        dropped_fills=exch.dropped_fills, entries=st.entries, max_drawdown=max_dd,
        min_equity=min_eq)
    return summary, exch.fills, torch.stack(curve, dim=1)


def rollout_candles(candles: dict, schedule=None, strategy=None, fills_params=None,
                    quote_balance: float = 10_000.0, log_capacity: int = 128,
                    device=None) -> dict:
    """The rollout on pre-built candles (``candles`` values [B, T]; the
    schedule defaults to calm), on ``device``.  The whole result — summary,
    fill logs, equity curves — is read back in one `host_read`: test-scale
    B only; `sweep` is the at-scale entry."""
    dev = resolve_device(device)
    c = {k: upload(candles[k], dev, torch.float32) for k in OHLC}
    B, T = c["close"].shape
    sched = schedule or scenarios.compile_schedules("calm", B, T)
    trade = {k: upload(getattr(sched, k), dev, torch.float32) for k in TRADE_KEYS}
    summary, fills, curve = _rollout(
        c, trade, on_device(strategy or default_strategy(device=dev), dev),
        on_device(fills_params or fill_params(device=dev), dev),
        torch.full((), quote_balance, dtype=torch.float32, device=dev), log_capacity)
    return host_read(pack({"summary": summary._asdict(), "fills": fills,
                           "equity_curve": curve}))


def resolve_schedule(scenario, num_scenarios: int, steps: int, seed: int):
    """(ShockSchedule, labels) of a sweep's ``scenario``: a ready
    ShockSchedule (no labels), "mixed" (round-robin over every preset), a
    list of preset names, or one preset name or ScenarioSpec."""
    if isinstance(scenario, scenarios.ShockSchedule):
        return scenario, None
    if scenario == "mixed" or isinstance(scenario, (list, tuple)):
        names = None if scenario == "mixed" else list(scenario)
        return scenarios.mixed_schedules(names, num_scenarios, steps, seed=seed)
    sched = scenarios.compile_schedules(scenario, num_scenarios, steps, seed=seed)
    name = scenario if isinstance(scenario, str) else scenario.name
    return sched, [name] * sched.num_scenarios


# (B, steps, capacity) shapes already swept: the recompile sentinel's
# cold-run ledger
_SWEEP_SHAPES_SEEN: set = set()


def sweep(key, scenario="mixed", num_scenarios: int = 4096, steps: int = 512,
          strategy: SimStrategy | None = None, fills_params: FillParams | None = None,
          path_parameters: paths.PathParams | None = None, quote_balance: float = 10_000.0,
          seed: int = 0, log_capacity: int = 128, return_fills: bool = False,
          device=None) -> dict:
    """Run ``num_scenarios`` adversarial GBM markets and the strategy over
    them, on ``device``, with one host read.

    ``scenario`` is a preset name, a list of names, "mixed", a
    ScenarioSpec, or a ready ShockSchedule.  Returns the host summary dict
    ([B] arrays; with ``return_fills`` the [B, L, 6] logs too), ``labels``
    (the scenario name of each row), ``stats`` (``dispatches`` — the calls
    that end in a host read, 1 —, ``scenarios``, ``steps``,
    ``upload_bytes``, ``wall_s``) and ``device``: the [B, T] candles, the
    equity curves and (without ``return_fills``) the fill logs, left on the
    device."""
    dev = resolve_device(device)
    sched, labels = resolve_schedule(scenario, num_scenarios, steps, seed)
    strat = on_device(strategy or default_strategy(device=dev), dev)
    fp = on_device(fills_params or fill_params(device=dev), dev)
    pp = on_device(path_parameters or paths.path_params(device=dev), dev)
    upload_bytes = sum(int(np.asarray(getattr(sched, k)).nbytes)
                       for k in scenarios.ShockSchedule._fields)
    # a never-seen (B, steps, capacity) shape is the sentinel's cold window
    shape_key = (int(sched.num_scenarios), int(sched.steps), int(log_capacity))
    cold = shape_key not in _SWEEP_SHAPES_SEEN
    _SWEEP_SHAPES_SEEN.add(shape_key)
    t0 = time.perf_counter()
    # the sim_sweep cost card on the first carded call, and a watch window
    # through the call's one host read
    with meshprof.watch("sim_sweep", cold=cold):
        with devprof.carding("sim_sweep", (strat, fp, pp), note=devprof.NOTE_NO_DONATION,
                             device=dev) as card:
            on_dev = scenarios.ShockSchedule(*(upload(getattr(sched, k), dev, torch.float32)
                                               for k in scenarios.ShockSchedule._fields))
            candles = paths.gbm_candles(key, on_dev, pp, device=dev)
            trade = {k: getattr(on_dev, k) for k in TRADE_KEYS}
            del on_dev   # the two path channels are consumed: no second [B, T] copy lives on
            summary, fills, curve = card.result(_rollout(
                candles, trade, strat, fp,
                torch.full((), quote_balance, dtype=torch.float32, device=dev), log_capacity))
        fetch = {"summary": summary._asdict()}
        if return_fills:
            fetch["fills"] = fills
        host = host_read(pack(fetch))
    wall = time.perf_counter() - t0
    devprof.observe_latency("sim_sweep", wall)
    host["device"] = {"candles": {k: candles[k] for k in OHLC + ("volume",)},
                      "equity_curve": curve, **({} if return_fills else {"fills": fills})}
    host["labels"] = labels
    host["stats"] = {"dispatches": 1, "scenarios": sched.num_scenarios, "steps": sched.steps,
                     "upload_bytes": upload_bytes, "wall_s": wall}
    return host


# --------------------------------------------------------------------------
# workload 2: the backtest engine against adversarial markets
# --------------------------------------------------------------------------

def stress_inputs(candles: dict, device=None):
    """The backtest's inputs over a [B, T] candle batch, as the JAX stress
    program builds them: the indicator table (K2's two launches), the
    reference signal, confidence 1, decision = signal, no SL/TP overrides."""
    from ai_crypto_trader_tpu_torch import ops
    from ai_crypto_trader_tpu_torch.backtest import signals as sig
    from ai_crypto_trader_tpu_torch.backtest.engine import BacktestInputs

    dev = resolve_device(device)
    ind = ops.compute_indicators({k: candles[k] for k in OHLC + ("volume",)}, device=dev)
    feats = sig.compute_signal_features(ind)
    signal, strength = sig.reference_signal(feats)
    close = feats.close
    nan = torch.full_like(close, math.nan)
    return BacktestInputs(close=close, signal=signal, strength=strength,
                          volatility=feats.volatility, volume=feats.volume,
                          confidence=torch.ones_like(close), decision=signal,
                          sl_pct=nan, tp_pct=nan)


def stress_backtest(inputs, params=None, initial_balance: float = 10_000.0,
                    warmup: int = 10, device=None):
    """`run_backtest` over the [B, T] inputs: with ``params=None`` the sizer
    ladder ([B] stats, the plain loop); with one StrategyParams (0-d
    leaves) its SL/TP ([B]); with a stacked population (leaves [P]) every
    strategy on every scenario, [B, P].  On the card the two SL/TP modes
    make one K1 launch per scenario, the P strategies its rows: the
    population goes in as [P, 1] against the [B, T] streams, so the series
    axis is B and each launch's rows are P (`engine._per_series`), never
    B·P launches."""
    from ai_crypto_trader_tpu_torch.backtest.engine import BacktestStats, run_backtest

    kw = dict(initial_balance=initial_balance, warmup=warmup, device=device)
    if params is None:
        return run_backtest(inputs, None, **kw)
    if params[0].ndim == 0:
        return run_backtest(inputs, params, use_param_sl_tp=True, **kw)
    column = type(params)(*(torch.as_tensor(x).reshape(-1, 1) for x in params))
    stats = run_backtest(inputs, column, use_param_sl_tp=True, **kw)
    return BacktestStats(*(v.movedim(0, 1).contiguous() for v in stats))


def backtest_under_stress(key, scenario="mixed", num_scenarios: int = 256, steps: int = 1024,
                          params=None, initial_balance: float = 10_000.0, seed: int = 0,
                          dynamics: str = "gbm", flow=None, device=None):
    """The backtest engine over a batch of adversarial markets, on
    ``device``: [B] stats (or [B, P] with a stacked StrategyParams
    population) and a host summary of robustness quantiles (p05/p50/p95 of
    the final balance, the worst final balance and the worst drawdown),
    read in one `host_read`.  Returns (stats, summary).

    ``dynamics``: ``"gbm"`` (regime GBM paths) or ``"lob"`` (candles from
    the order-flow book, optionally with calibrated ``flow``)."""
    dev = resolve_device(device)
    if isinstance(scenario, scenarios.ShockSchedule):
        sched, labels = scenario, None
    else:
        names = None if scenario == "mixed" else (
            [scenario] if isinstance(scenario, str) else list(scenario))
        sched, labels = scenarios.mixed_schedules(names, num_scenarios, steps, seed=seed)
    candles = _stress_candles(key, sched, dynamics, flow, device=dev)
    stats = stress_backtest(stress_inputs(candles, device=dev), params,
                            initial_balance=initial_balance, device=dev)
    host = host_read(pack({"final": stats.final_balance, "dd": stats.max_drawdown_pct}))
    final = host["final"].astype(np.float64)
    dd = host["dd"].astype(np.float64)
    summary = {"labels": labels,
               "final_balance_p05": float(np.percentile(final, 5)),
               "final_balance_p50": float(np.percentile(final, 50)),
               "final_balance_p95": float(np.percentile(final, 95)),
               "worst_final_balance": float(final.min()),
               "worst_drawdown_pct": float(dd.max())}
    return stats, summary


def _stress_candles(key, sched, dynamics: str, flow, device=None) -> dict:
    """The candle batch for a schedule: GBM paths or the LOB's markets
    (`sim.lob` imported here: it imports this module)."""
    if dynamics == "gbm":
        return paths.gbm_candles(key, sched, device=device)
    if dynamics == "lob":
        from ai_crypto_trader_tpu_torch.sim import lob

        return lob.lob_candles(key, sched, flow=flow, device=device)
    raise ValueError(f"unknown market dynamics {dynamics!r} (expected 'gbm' or 'lob')")


# --------------------------------------------------------------------------
# workload 3: a scenario-diverse RL environment
# --------------------------------------------------------------------------

def scenario_env_params(key, scenario="mixed", num_scenarios: int = 64, steps: int = 1024,
                        episode_len: int = 256, fee_rate: float = 0.0, seed: int = 0,
                        dynamics: str = "gbm", flow=None, device=None):
    """`rl.env.EnvParams` over [num_scenarios, steps] generated markets, on
    ``device``: (EnvParams, labels).  ``dynamics="lob"`` appends two
    book-state columns to the observation table — the relative spread per
    mille and ``tanh(touch depth / steady depth)`` — and makes the
    half-spread the env's per-candle trade cost; size networks with
    `rl.env.obs_size`."""
    from ai_crypto_trader_tpu_torch import ops
    from ai_crypto_trader_tpu_torch.rl.env import make_env_params

    dev = resolve_device(device)
    names = None if scenario == "mixed" else (
        [scenario] if isinstance(scenario, str) else list(scenario))
    sched, labels = scenarios.mixed_schedules(names, num_scenarios, steps, seed=seed)
    candles = _stress_candles(key, sched, dynamics, flow, device=dev)
    ind = ops.compute_indicators(
        {k: candles[k] for k in ("open", "high", "low", "close", "volume")}, device=dev)
    extra = trade_cost = None
    if dynamics == "lob":
        from ai_crypto_trader_tpu_torch.sim import lob

        fl = flow or lob.flow_params(device=dev)
        steady = fl.limit_rate / torch.clamp_min(fl.cancel_rate, 1e-6)
        extra = torch.stack([candles["spread"] * 1e3, torch.tanh(candles["cap"] / steady)],
                            dim=-1)
        trade_cost = div_true(candles["spread"], 2.0)   # half-spread paid per side
    return make_env_params(ind, episode_len=episode_len, fee_rate=fee_rate,
                           extra_features=extra, trade_cost=trade_cost, device=dev), labels
