"""The limit-order book's order flow: candle markets from stochastic agents.

Port of the flow half of `ai_crypto_trader_tpu/sim/lob.py` (`FlowParams`,
`init_book`, `depth_profile`, `flow_step`, `lob_candles`).  The book is
[L] price levels per side on a relative tick grid around the mid, stepped
for a [B] batch of scenarios at once:

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
measured relative spread and the touch's depth (``cap``).

Random draws.  `flow_step` takes its draws as arguments and `lob_candles`
takes a ``torch.Generator`` (on the device) or a provider with a ``flow(B,
T, L)`` method returning `FlowDraws`; the JAX package draws them per step
from ``split(fold_in(key, scenario), T)``.  Rounding: the grid roll
``m = round((mid'/mid − 1)/tick)`` rounds a ratio near 1 to ticks of 1e-4,
so an ulp of ``exp`` (which differs between XLA, PyTorch's CPU and CUDA)
can flip a roll by one tick where the ratio sits within a few ulps of a
half tick; the mid path is unaffected, the book of that scenario shifts
from there on.  `_sweep_side`'s cumulative sum over the levels rounds in
another order than JAX's.  The tests and chip_smoke.py account for both.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ai_crypto_trader_tpu_torch.device import resolve_device, to_device

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


def depth_profile(flow: FlowParams, levels: int) -> torch.Tensor:
    """[L] arrival depth profile ``exp(−depth_decay·i)``."""
    i = torch.arange(levels, dtype=torch.float32, device=flow.depth_decay.device)
    return torch.exp(-flow.depth_decay * i)


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
    cum = torch.cumsum(sizes, dim=-1)
    prev = cum - sizes
    take = torch.minimum(torch.clamp_min(m.unsqueeze(-1) - prev, 0.0), sizes)
    filled = torch.minimum(m, cum[..., -1])
    levels = torch.arange(sizes.shape[-1], device=sizes.device)
    deepest = torch.where(take > 0.0, levels, 0).amax(dim=-1)
    return sizes - take, take, filled, deepest


def _lognorm(z, sigma):
    """Mean-1 lognormal noise ``exp(σz − σ²/2)`` from standard normals."""
    return torch.exp(sigma * z - 0.5 * sigma * sigma)


def flow_step(book: LobState, draws: FlowDraws, sched_t: dict, flow: FlowParams):
    """One step of the batch of books (schedule channels [B] in
    ``sched_t``): (book', candle {open, high, low, close, volume} [B],
    relative spread [B], touch depth [B], traded volume per ask level, per
    bid level [B, L]).  A halted scenario's book is frozen."""
    live = sched_t["halt"] == 0.0

    # 1. the mid path, and the grid roll
    ret = flow.drift + sched_t["logret_shift"] + flow.vol * sched_t["vol_mult"] * draws.z_mid
    mid_new = book.mid * torch.exp(torch.where(live, ret, 0.0))
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
    sched = {k: to_device(getattr(schedule, k), dev, torch.float32) for k in SCHEDULE_KEYS}
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
