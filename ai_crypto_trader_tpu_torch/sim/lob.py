"""The limit-order book: order-flow markets, and an agent trading in them.

Port of `ai_crypto_trader_tpu/sim/lob.py`.  The book is [L] price levels
per side on a relative tick grid around the mid, stepped for a [B] batch
of scenarios at once:

  * bid level i sits at ``mid·(1 − tick·(s + i))``, ask level i at
    ``mid·(1 + tick·(s + i))`` (s the half-spread in ticks); when the mid
    moves m ticks the levels shift by m, vacated levels empty;
  * per step and side: lognormal limit arrivals ``limit_rate ·
    exp(−depth_decay·i)``, cancels of a uniform fraction (mean
    ``cancel_rate``), and with probability ``market_rate`` a market order
    of mean size ``market_size`` swept level by level through the
    opposite side;
  * the shock schedule drives the flow: a liquidity hole scales arrivals,
    a spread blowout widens the half-spread, logret/vol move the mid, a
    halt freezes the book.

Each step emits a candle of the mid path (open/close the mid before and
after, high/low extended by the sweeps' deepest traded levels), the
measured relative spread and the touch's depth (``cap``).  `lob_candles`
keeps only that market view (the backtester's and the RL env's markets).

The agent.  `rollout_lob` and `lob_sweep` trade the strategy of
`sim.engine` in these markets: each step the book moves (`flow_step`), the
volume traded at or beyond each resting LIMIT's level eats the queue ahead
of it (`_queue_update`, price-time priority), then the exchange of
`sim.exchange` settles, matches — with the queue as a per-slot gate and
the touch depth as the liquidity cap — and applies the strategy's
requests, and a newly placed LIMIT joins the back of its level's queue
(``queue_frac`` of the standing size ahead of it; 0 = the front, the
FakeExchange semantics).  The agent's fills are not fed back into the book.
`lob_sweep` is the at-scale entry: B scenarios × T steps with one [B]-sized
host read, its [B, T] series left on the device.

Random draws.  `flow_step` takes its draws as arguments and `lob_candles`
takes a ``torch.Generator`` (on the device) or a provider with a ``flow(B,
T, L)`` method returning `FlowDraws`; the JAX package draws them per step
from ``split(fold_in(key, scenario), T)``.

Rounding.  Every ``exp`` and every sum over the levels or the steps is
taken in float64 and rounded once (`exp_f32`, `sum_f32`), so the card and
the CPU give the same bits on the same draws (their float32 ``exp`` and
their reduction orders differ, and a one-ulp difference can tip a
trigger or a grid roll).  Against the JAX package they still differ by
ulps: XLA's float32 ``exp`` and its sequential float32 sums round
otherwise.  The grid roll ``m = round((mid'/mid − 1)/tick)`` rounds a
ratio near 1 to ticks of 1e-4, so an ulp of ``exp`` can flip a roll by one
tick where the ratio sits within a few ulps of a half tick; the mid path
is unaffected, the book of that scenario shifts from there on.  The tests
account for both.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch

from ai_crypto_trader_tpu_torch.device import div_true, resolve_device, upload
from ai_crypto_trader_tpu_torch.parallel.partitioner import resolve_partitioner
from ai_crypto_trader_tpu_torch.sim import engine, scenarios
from ai_crypto_trader_tpu_torch.sim import exchange as sx
from ai_crypto_trader_tpu_torch.utils import devprof, meshprof

DEFAULT_LEVELS = 32
SCHEDULE_KEYS = ("logret_shift", "vol_mult", "liquidity_mult", "spread", "halt")


class FlowParams(NamedTuple):
    """Order-flow knobs, float32 0-d tensors (see the JAX package's
    docstring of each): limit_rate, depth_decay, cancel_rate, market_rate,
    market_size, size_sigma, tick, spread0 (baseline half-spread in ticks),
    queue_frac, mid0, drift, vol."""

    limit_rate: torch.Tensor
    depth_decay: torch.Tensor
    cancel_rate: torch.Tensor
    market_rate: torch.Tensor
    market_size: torch.Tensor
    size_sigma: torch.Tensor
    tick: torch.Tensor
    spread0: torch.Tensor
    queue_frac: torch.Tensor
    mid0: torch.Tensor
    drift: torch.Tensor
    vol: torch.Tensor


def flow_params(limit_rate: float = 2.0, depth_decay: float = 0.12,
                cancel_rate: float = 0.08, market_rate: float = 0.35,
                market_size: float = 4.0, size_sigma: float = 0.8,
                tick: float = 1e-4, spread0: float = 1.0,
                queue_frac: float = 0.0, mid0: float = 40_000.0,
                drift: float = 0.0, vol: float = 0.0015, device=None) -> FlowParams:
    """Defaults give a liquid book: steady depth ``limit_rate/cancel_rate =
    25`` at the touch, decaying over ~8 levels."""
    dev = resolve_device(device)
    f = lambda v: torch.full((), v, dtype=torch.float32, device=dev)  # noqa: E731
    return FlowParams(limit_rate=f(limit_rate), depth_decay=f(depth_decay),
                      cancel_rate=f(cancel_rate), market_rate=f(market_rate),
                      market_size=f(market_size), size_sigma=f(size_sigma), tick=f(tick),
                      spread0=f(spread0), queue_frac=f(queue_frac), mid0=f(mid0),
                      drift=f(drift), vol=f(vol))


class LobState(NamedTuple):
    """A batch of books: mid [B], half-spread in ticks [B], sizes [B, L]
    per side."""

    mid: torch.Tensor
    s_ticks: torch.Tensor
    bid_sz: torch.Tensor
    ask_sz: torch.Tensor


class FlowDraws(NamedTuple):
    """One step's draws for a [B] batch (with a leading [T] axis in
    `lob_candles`' provider)."""

    z_mid: torch.Tensor      # [B] normal: the mid's return
    z_arr: torch.Tensor      # [B, 2, L] normal: arrival size noise (bid, ask)
    u_cancel: torch.Tensor   # [B, 2, L] uniform: cancel fractions
    u_buy: torch.Tensor      # [B] uniform: a market buy where < market_rate
    u_sell: torch.Tensor     # [B]
    z_buy: torch.Tensor      # [B] normal: market buy size noise
    z_sell: torch.Tensor     # [B]


def flow_draws(generator: torch.Generator, B: int, T: int, L: int) -> FlowDraws:
    """[T, B, ...] draws of every step from ``generator``."""
    g, dev = generator, generator.device
    n = lambda *s: torch.randn(s, generator=g, device=dev)  # noqa: E731
    u = lambda *s: torch.rand(s, generator=g, device=dev)  # noqa: E731
    return FlowDraws(n(T, B), n(T, B, 2, L), u(T, B, 2, L), u(T, B), u(T, B), n(T, B), n(T, B))


def exp_f32(x: torch.Tensor) -> torch.Tensor:
    """``exp`` of a float32 tensor, taken in float64 and rounded once: the
    same float32 on every device (PyTorch's float32 ``exp`` differs by an
    ulp between the CPU and CUDA)."""
    return torch.exp(x.double()).float()


def sum_f32(x: torch.Tensor, cumulative: bool = False) -> torch.Tensor:
    """The sum (or running sum) of a float32 tensor over its last axis,
    accumulated in float64 and rounded once: the same float32 on every
    device, whatever order a device's reduction takes."""
    x = x.double()
    return (torch.cumsum(x, dim=-1) if cumulative else x.sum(dim=-1)).float()


def depth_profile(flow: FlowParams, levels: int) -> torch.Tensor:
    """[L] arrival depth profile ``exp(−depth_decay·i)``."""
    i = torch.arange(levels, dtype=torch.float32, device=flow.depth_decay.device)
    return exp_f32(-flow.depth_decay * i)


def init_book(flow: FlowParams, batch: int, levels: int = DEFAULT_LEVELS) -> LobState:
    """``batch`` books at the steady state, where arrivals and cancels
    balance: ``limit_rate·profile / cancel_rate`` per level."""
    steady = flow.limit_rate * depth_profile(flow, levels) / torch.clamp_min(
        flow.cancel_rate, 1e-6)
    rows = steady.expand(batch, levels)
    return LobState(mid=flow.mid0.expand(batch), s_ticks=flow.spread0.expand(batch),
                    bid_sz=rows, ask_sz=rows)


def _shift_zero(arr, m):
    """Sizes [B, L] moved to level ``i + m`` (m [B], either sign), vacated
    levels zero: the grid roll when the mid moves m ticks."""
    L = arr.shape[-1]
    src = torch.arange(L, device=arr.device) - m.unsqueeze(-1)
    valid = (src >= 0) & (src < L)
    return torch.where(valid, torch.gather(arr, -1, torch.clamp(src, 0, L - 1)), 0.0)


def _sweep_side(sizes, m):
    """Consume ``m`` [B] base units from level 0 upward (best price first,
    a full level before the next): (sizes', take [B, L], filled [B],
    deepest touched level [B])."""
    cum = sum_f32(sizes, cumulative=True)
    prev = cum - sizes
    take = torch.minimum(torch.clamp_min(m.unsqueeze(-1) - prev, 0.0), sizes)
    filled = torch.minimum(m, cum[..., -1])
    levels = torch.arange(sizes.shape[-1], device=sizes.device)
    deepest = torch.where(take > 0.0, levels, 0).amax(dim=-1)
    return sizes - take, take, filled, deepest


def _lognorm(z, sigma):
    """Mean-1 lognormal noise ``exp(σz − σ²/2)`` from standard normals."""
    return exp_f32(sigma * z - 0.5 * sigma * sigma)


def flow_step(book: LobState, draws: FlowDraws, sched_t: dict, flow: FlowParams):
    """One step of the batch of books (schedule channels [B] in
    ``sched_t``): (book', candle {open, high, low, close, volume} [B],
    relative spread [B], touch depth [B], traded volume per ask level, per
    bid level [B, L]).  A halted scenario's book is frozen."""
    live = sched_t["halt"] == 0.0

    # 1. the mid path, and the grid roll
    ret = flow.drift + sched_t["logret_shift"] + flow.vol * sched_t["vol_mult"] * draws.z_mid
    mid_new = book.mid * exp_f32(torch.where(live, ret, 0.0))
    m_ticks = torch.round((mid_new / book.mid - 1.0) / flow.tick).long()
    bid_sz = _shift_zero(book.bid_sz, m_ticks)
    ask_sz = _shift_zero(book.ask_sz, -m_ticks)

    # 2. the half-spread: the schedule's, floored at the baseline
    s_ticks = torch.maximum(flow.spread0, sched_t["spread"] / (2.0 * flow.tick))

    # 3. cancels
    frac = torch.clamp(2.0 * flow.cancel_rate * draws.u_cancel, 0.0, 1.0)
    live_l = live.unsqueeze(-1)
    bid_sz = bid_sz * torch.where(live_l, 1.0 - frac[:, 0], 1.0)
    ask_sz = ask_sz * torch.where(live_l, 1.0 - frac[:, 1], 1.0)

    # 4. limit arrivals, scaled by the liquidity channel
    prof = depth_profile(flow, bid_sz.shape[-1])
    noise = _lognorm(draws.z_arr, flow.size_sigma)
    arr_scale = (flow.limit_rate * sched_t["liquidity_mult"]).unsqueeze(-1)
    bid_sz = bid_sz + torch.where(live_l, arr_scale * prof * noise[:, 0], 0.0)
    ask_sz = ask_sz + torch.where(live_l, arr_scale * prof * noise[:, 1], 0.0)

    # 5. market orders swept through the opposite side
    m_buy = torch.where((draws.u_buy < flow.market_rate) & live,
                        flow.market_size * _lognorm(draws.z_buy, flow.size_sigma), 0.0)
    m_sell = torch.where((draws.u_sell < flow.market_rate) & live,
                         flow.market_size * _lognorm(draws.z_sell, flow.size_sigma), 0.0)
    ask_sz, take_ask, filled_buy, deep_buy = _sweep_side(ask_sz, m_buy)
    bid_sz, take_bid, filled_sell, deep_sell = _sweep_side(bid_sz, m_sell)

    book2 = LobState(mid=mid_new, s_ticks=s_ticks, bid_sz=bid_sz, ask_sz=ask_sz)

    # 6. the step's candle, extended by the traded extremes
    ask_extreme = mid_new * (1.0 + flow.tick * (s_ticks + deep_buy))
    bid_extreme = mid_new * (1.0 - flow.tick * (s_ticks + deep_sell))
    open_, close = book.mid, mid_new
    high = torch.maximum(torch.maximum(open_, close),
                         torch.where(filled_buy > 0, ask_extreme, close))
    low = torch.minimum(torch.minimum(open_, close),
                        torch.where(filled_sell > 0, bid_extreme, close))
    volume = filled_buy + filled_sell + 1e-3 * flow.market_size
    candle = {"open": open_, "high": high, "low": low, "close": close, "volume": volume}
    spread_rel = 2.0 * flow.tick * s_ticks
    return book2, candle, spread_rel, bid_sz[:, 0], take_ask, take_bid


def _draws_at(d: FlowDraws, t: int) -> FlowDraws:
    return FlowDraws(*(x[t] for x in d))


def lob_candles(key, schedule, flow: FlowParams | None = None,
                levels: int = DEFAULT_LEVELS, device=None) -> dict:
    """[B, T] candles (open/high/low/close/volume, int32 regime of zeros)
    plus the per-step ``spread`` and ``cap`` book channels, generated by the
    order-flow agents under a ShockSchedule, on ``device``.  One `flow_step`
    of the B books per candle."""
    dev = resolve_device(device)
    flow = flow or flow_params(device=dev)
    sched = {k: upload(getattr(schedule, k), dev, torch.float32) for k in SCHEDULE_KEYS}
    B, T = sched["halt"].shape
    d = key.flow(B, T, levels) if hasattr(key, "flow") else flow_draws(key, B, T, levels)
    d = FlowDraws(*(x.to(dev) for x in d))
    book = init_book(flow, B, levels)
    rows = {k: [] for k in ("open", "high", "low", "close", "volume", "spread", "cap")}
    for t in range(T):
        book, candle, spread, cap, _, _ = flow_step(
            book, _draws_at(d, t), {k: v[:, t] for k, v in sched.items()}, flow)
        for k, v in candle.items():
            rows[k].append(v)
        rows["spread"].append(spread)
        rows["cap"].append(cap)
    out = {k: torch.stack(v, dim=1) for k, v in rows.items()}
    out["regime"] = torch.zeros((B, T), dtype=torch.int32, device=dev)
    return out


# --------------------------------------------------------------------------
# the agent: the strategy trading in the order-flow book
# --------------------------------------------------------------------------

class LobSummary(NamedTuple):
    """Per-scenario outcomes, every leaf [B]: `engine.RolloutSummary`'s
    plus the book's aggregates."""

    final_equity: torch.Tensor
    final_quote: torch.Tensor
    final_base: torch.Tensor
    fees: torch.Tensor
    n_fills: torch.Tensor
    dropped_fills: torch.Tensor
    entries: torch.Tensor
    max_drawdown: torch.Tensor
    min_equity: torch.Tensor
    mean_spread: torch.Tensor      # mean relative bid-ask spread
    mean_top_depth: torch.Tensor   # mean touch size (bid side)
    traded_volume: torch.Tensor    # exogenous market-order volume filled


def _level_of(price, mid, s_ticks, tick, side):
    """Grid level of an absolute price (int32): its offset in ticks from the
    mid, less the half-spread.  ``side`` +1 = the ask grid (above the mid),
    −1 = the bid grid."""
    rel = price / mid
    off = torch.where(side > 0, rel - 1.0, 1.0 - rel) / tick
    return torch.round(off - s_ticks).to(torch.int32)


def _slot_levels(b: sx.Book, book: LobState, flow: FlowParams):
    """[B, K] grid level of each slot's limit price on the side it rests
    on (a SELL on the ask grid), against the book's mid and half-spread."""
    return _level_of(b.limit_price, book.mid.unsqueeze(-1), book.s_ticks.unsqueeze(-1),
                     flow.tick, -b.side)


def _queue_update(exch: sx.ExchState, queue_ahead, book: LobState, flow: FlowParams,
                  take_ask, take_bid):
    """Decrement each resting LIMIT's queue [B, K] by the volume traded at
    or beyond its level this step (price-time priority: flow that swept
    past the level consumed everything standing at it)."""
    b = exch.book
    L = take_ask.shape[-1]
    lvl = _slot_levels(b, book, flow)
    take = torch.where((b.side < 0).unsqueeze(-1), take_ask.unsqueeze(1), take_bid.unsqueeze(1))
    levels = torch.arange(L, device=take.device)
    eaten = sum_f32(torch.where(levels >= lvl.unsqueeze(-1), take, 0.0))
    live = b.active & (b.kind == sx.LIMIT)
    return torch.where(live, torch.clamp_min(queue_ahead - eaten, 0.0), 0.0)


def _queue_seed(exch_before: sx.ExchState, exch_after: sx.ExchState, queue_ahead,
                book: LobState, flow: FlowParams):
    """A newly placed LIMIT joins the back of its level's queue:
    ``queue_frac`` of the standing exogenous size at that level is ahead of
    it (0 = the front of the queue, the parity semantics)."""
    b = exch_after.book
    L = book.ask_sz.shape[-1]
    placed = b.active & ~exch_before.book.active & (b.kind == sx.LIMIT)
    lvl = _slot_levels(b, book, flow)
    sizes = torch.where((b.side < 0).unsqueeze(-1), book.ask_sz.unsqueeze(1),
                        book.bid_sz.unsqueeze(1))
    at = sizes.gather(-1, torch.clamp(lvl, 0, L - 1).long().unsqueeze(-1)).squeeze(-1)
    standing = torch.where((lvl >= 0) & (lvl < L), at, 0.0)
    return torch.where(placed, standing * flow.queue_frac, queue_ahead)


def _rollout(draws: FlowDraws, sched: dict, flow: FlowParams, strat, fee_rate, quote0,
             levels: int, log_capacity: int, return_book: bool):
    """Every scenario's LOB rollout: draws [T, B, ...], schedule channels
    [B, T] → (LobSummary, fill logs [B, L, 6], per-step series: equity,
    spread, cap and the candle [B, T], with ``return_book`` the book sizes
    [B, T, levels] and best bid and ask [B, T])."""
    B, T = sched["halt"].shape
    dev = sched["halt"].device
    book = init_book(flow, B, levels)
    exch = sx.init_state(quote0, K=engine.N_SLOTS, L=log_capacity, batch=B, device=dev)
    st = engine.init_strat(B, dev)
    qa = torch.zeros((B, engine.N_SLOTS), dtype=torch.float32, device=dev)
    eq0 = sx.equity(exch, flow.mid0)
    acct = (eq0, torch.zeros_like(eq0), eq0)
    chans = {k: sched[k].unbind(1) for k in scenarios.ShockSchedule._fields}
    steps = torch.arange(T, dtype=torch.int32, device=dev).unbind(0)
    names = ["equity", "spread", "cap", "open", "high", "low", "close", "volume"]
    if return_book:
        names += ["bid_sz", "ask_sz", "best_bid", "best_ask"]
    ys = {k: [] for k in names}
    for t in range(T):
        sched_t = {k: v[t] for k, v in chans.items()}
        book, candle, spread, cap, take_ask, take_bid = flow_step(
            book, _draws_at(draws, t), sched_t, flow)
        # price-time queue progress BEFORE matching: the flow that traded
        # this step is what consumed the queue ahead of the agent
        qa = _queue_update(exch, qa, book, flow, take_ask, take_bid)
        gate = (exch.book.kind != sx.LIMIT) | (qa <= 0.0)
        agent_t = {"halt": sched_t["halt"], "spread": spread, "latency": sched_t["latency"]}
        before, exch, st = engine.agent_step(exch, st, candle, steps[t], agent_t, cap, strat,
                                             fee_rate, gate=gate)
        qa = _queue_seed(before, exch, qa, book, flow)
        eq = sx.equity(exch, candle["close"])
        acct = engine.account(acct, eq)
        step = {"equity": eq, "spread": spread, "cap": cap, **candle}
        if return_book:
            step.update(bid_sz=book.bid_sz, ask_sz=book.ask_sz,
                        best_bid=book.mid * (1.0 - flow.tick * book.s_ticks),
                        best_ask=book.mid * (1.0 + flow.tick * book.s_ticks))
        for k in names:
            ys[k].append(step[k])
    series = {k: torch.stack(v, dim=1) for k, v in ys.items()}
    _peak, max_dd, min_eq = acct
    summary = LobSummary(
        final_equity=sx.equity(exch, series["close"][:, -1]), final_quote=exch.quote,
        final_base=exch.base, fees=exch.fee_paid, n_fills=exch.n_fills,
        dropped_fills=exch.dropped_fills, entries=st.entries, max_drawdown=max_dd,
        min_equity=min_eq, mean_spread=div_true(sum_f32(series["spread"]), float(T)),
        mean_top_depth=div_true(sum_f32(series["cap"]), float(T)),
        traded_volume=sum_f32(series["volume"]))
    series["candle"] = {k: series.pop(k) for k in ("open", "high", "low", "close", "volume")}
    return summary, exch.fills, series


def _draws_for(key, B: int, T: int, levels: int, dev) -> FlowDraws:
    d = key.flow(B, T, levels) if hasattr(key, "flow") else flow_draws(key, B, T, levels)
    return FlowDraws(*(x.to(dev) for x in d))


def rollout_lob(key, schedule, flow: FlowParams | None = None, strategy=None,
                fee_rate: float = 0.001, quote_balance: float = 10_000.0,
                levels: int = DEFAULT_LEVELS, log_capacity: int = 128,
                return_book: bool = False, seed: int = 0, device=None) -> dict:
    """The LOB rollout over a ShockSchedule (or a preset name, compiled at
    [1, 256] with ``seed``), on ``device``.  The WHOLE result — summary,
    fill logs, per-step series (and the book with ``return_book``) — is
    read back in one `host_read`: test-scale B only; `lob_sweep` is the
    at-scale entry."""
    dev = resolve_device(device)
    if isinstance(schedule, str):
        schedule = scenarios.compile_schedules(schedule, 1, 256, seed=seed)
    sched = {k: upload(getattr(schedule, k), dev, torch.float32)
             for k in scenarios.ShockSchedule._fields}
    B, T = sched["halt"].shape
    summary, fills, series = _rollout(
        _draws_for(key, B, T, levels, dev), sched,
        engine.on_device(flow or flow_params(device=dev), dev),
        engine.on_device(strategy or engine.default_strategy(device=dev), dev),
        torch.full((), fee_rate, dtype=torch.float32, device=dev),
        torch.full((), quote_balance, dtype=torch.float32, device=dev),
        levels, log_capacity, return_book)
    return engine.host_read(engine.pack({"summary": summary._asdict(), "fills": fills,
                                         "series": series}))


def host_read(readback) -> dict:
    """THE per-sweep device→host read of `lob_sweep` (a module-level seam,
    so tests can count reads): `engine.unpack`, timed into the
    ``host_read`` SLO window, the sanctioned sync of a watch window."""
    t0 = time.perf_counter()
    with meshprof.allow_transfers():   # THE sanctioned device→host sync
        out = engine.unpack(readback)
    devprof.observe_latency("host_read", time.perf_counter() - t0)
    return out


# (B, steps, levels, capacity) shapes already swept: the recompile
# sentinel's cold-run ledger
_SWEEP_SHAPES_SEEN: set = set()


def lob_sweep(key, scenario="mixed", num_scenarios: int = 1024, steps: int = 256,
              flow: FlowParams | None = None, strategy=None, fee_rate: float = 0.001,
              quote_balance: float = 10_000.0, seed: int = 0, levels: int = DEFAULT_LEVELS,
              log_capacity: int = 128, partitioner=None, device=None) -> dict:
    """Run ``num_scenarios`` order-flow markets with the agent in them, on
    ``device``, with one [B]-sized host read.

    ``scenario`` is what `sweep` takes (`engine.resolve_schedule`).
    ``partitioner`` (None: the single device) may be a
    `parallel.MeshPartitioner`: the scenarios then split over its mesh
    with their schedules and their draws, which are made for all B
    scenarios before the split (so each shard rolls out exactly the
    single device's rows); flow, strategy and fees ride replicated, and
    summary and series are gathered onto the mesh's first device.  Returns
    the host summary ([B] arrays), ``labels``, ``stats`` (``dispatches``
    1, ``scenarios``, ``steps``, ``levels``, ``events`` = B·T·(4L + 2) —
    two market orders and each level's arrival and cancel on both sides a
    step, the bench row's basis —, ``devices``, ``upload_bytes``,
    ``wall_s``) and ``device``: the [B, T] equity, close, high, low, spread
    and cap series, left on the device."""
    part = resolve_partitioner(partitioner)
    dev = part.home if part.device_count > 1 else resolve_device(device)
    sched, labels = engine.resolve_schedule(scenario, num_scenarios, steps, seed)
    B, T = sched.num_scenarios, sched.steps
    upload_bytes = sum(int(np.asarray(getattr(sched, k)).nbytes)
                       for k in scenarios.ShockSchedule._fields)
    flow = engine.on_device(flow or flow_params(device=dev), dev)
    strat = engine.on_device(strategy or engine.default_strategy(device=dev), dev)
    shape_key = (B, T, int(levels), int(log_capacity), part.device_count)
    cold = shape_key not in _SWEEP_SHAPES_SEEN
    _SWEEP_SHAPES_SEEN.add(shape_key)
    t0 = time.perf_counter()
    # the lob_sweep cost card on the first carded call, and a watch window
    # through the call's one host read
    with meshprof.watch("lob_sweep", cold=cold):
        with devprof.carding("lob_sweep", (flow, strat), note=devprof.NOTE_NO_DONATION,
                             device=dev) as card:
            on_dev = {k: upload(getattr(sched, k), dev, torch.float32)
                      for k in scenarios.ShockSchedule._fields}
            fee = torch.full((), fee_rate, dtype=torch.float32, device=dev)
            quote0 = torch.full((), quote_balance, dtype=torch.float32, device=dev)
            draws = _draws_for(key, B, T, levels, dev)

            def rollout(pop, flow, strat, fee, quote0):
                summary, _fills, series = _rollout(
                    FlowDraws(*(x.movedim(1, 0) for x in pop["draws"])), pop["sched"],
                    flow, strat, fee, quote0, levels, log_capacity, False)
                return summary, series

            # the scenario axis leads every population leaf: draws [B, T, ...]
            pop = {"sched": on_dev, "draws": FlowDraws(*(x.movedim(0, 1) for x in draws))}
            summary, series = card.result(part.population_eval(rollout, name="lob_sweep")(
                pop, flow, strat, fee, quote0))
        host = host_read(engine.pack({"summary": summary._asdict()}))
    wall = time.perf_counter() - t0
    devprof.observe_latency("lob_sweep", wall)
    candle = series["candle"]
    host["device"] = {"equity_curve": series["equity"], "close": candle["close"],
                      "high": candle["high"], "low": candle["low"],
                      "spread": series["spread"], "cap": series["cap"]}
    host["labels"] = labels
    host["stats"] = {"dispatches": 1, "scenarios": B, "steps": T, "levels": int(levels),
                     "events": B * T * (4 * int(levels) + 2), "devices": part.device_count,
                     "upload_bytes": upload_bytes, "wall_s": wall}
    return host
