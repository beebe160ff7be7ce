"""Candle-granularity exchange: FakeExchange semantics over a batch of venues.

Port of `ai_crypto_trader_tpu/sim/exchange.py`.  `shell/exchange.
FakeExchange` of the JAX package is the behavioural ground truth: market
fills at the candle close, a resting LIMIT fills when the candle's low/high
crosses its price, a STOP when the stop price is pierced (at the stop-limit
price if one is set), every fill pays ``fee = qty·price·fee_rate``, an
under-funded fill is REJECTED and the order stays open, and a per-candle
liquidity cap turns a big resting order into partial fills that carry
their remainder forward.  Here those rules step a [B] batch of independent
venues at once: every state field has a leading [B] axis.

Sim-only extensions, off in parity mode and driven by the per-candle
shock-schedule channels ([B] each): ``spread`` (market BUYs pay
close·(1 + spread/2), SELLs receive close·(1 − spread/2)), ``halt`` (the
venue is unreachable: placements, cancels and matching are suppressed) and
``latency`` (a market order parks and fills at the NEXT candle's open).

State per venue: balances, K resting-order slots (K small and fixed; the
strategy uses slot 0 = protective stop, slot 1 = take profit), one pending
market slot, and a fill log ``[L, 6] = (t, tag, side, qty, price, fee)``
(tag 0 = market fill, tag k + 1 = slot k).  A fill finds the log full when
``n_fills`` has reached L: it still books, and is counted in
``dropped_fills``.

Rounding.  ``quote + base·price`` (`equity`) is rounded once, as the fused
multiply-add the JAX package's CPU program forms (`device.plus_product`);
every other operation rounds as it does there.  The ops are fixed-shape:
no host read, no data-dependent shape.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ai_crypto_trader_tpu_torch.device import plus_product, resolve_device

BUY, SELL = 1, -1
LIMIT, STOP = 0, 1
FILL_FIELDS = ("t", "tag", "side", "qty", "price", "fee")


class Book(NamedTuple):
    """K resting-order slots per venue, every field [B, K]."""

    active: torch.Tensor       # bool
    side: torch.Tensor         # int32: BUY=+1 / SELL=-1
    kind: torch.Tensor         # int32: LIMIT / STOP
    qty: torch.Tensor          # float32 remaining base quantity
    limit_price: torch.Tensor  # float32; for STOP, <= 0 means "fill at stop"
    stop_price: torch.Tensor   # float32 (STOP only)


class ExchState(NamedTuple):
    quote: torch.Tensor        # [B] float32 quote-asset balance
    base: torch.Tensor         # [B] float32 base-asset balance
    fee_paid: torch.Tensor     # [B] float32 cumulative fees
    book: Book
    pend_active: torch.Tensor  # [B] bool: a latency-parked market order
    pend_side: torch.Tensor    # [B] int32
    pend_qty: torch.Tensor     # [B] float32
    fills: torch.Tensor        # [B, L, 6] float32 fill log
    n_fills: torch.Tensor      # [B] int32 logged fills
    dropped_fills: torch.Tensor  # [B] int32 fills lost to a full log


class Action(NamedTuple):
    """One candle's requests per venue; the [B, K] fields align with the
    Book's slots."""

    market_qty: torch.Tensor   # [B] float32; > 0 submits a market order
    market_side: torch.Tensor  # [B] int32
    cancel: torch.Tensor       # [B, K] bool
    place: torch.Tensor        # [B, K] bool (dropped when the slot is busy)
    side: torch.Tensor         # [B, K] int32
    kind: torch.Tensor         # [B, K] int32
    qty: torch.Tensor          # [B, K] float32
    limit_price: torch.Tensor  # [B, K] float32
    stop_price: torch.Tensor   # [B, K] float32


def no_action(K: int, batch: int = 1, device=None) -> Action:
    """``batch`` venues' empty requests over K slots."""
    dev = resolve_device(device)
    z = torch.zeros((batch, K), dtype=torch.float32, device=dev)
    zi = torch.zeros((batch, K), dtype=torch.int32, device=dev)
    no = torch.zeros((batch, K), dtype=torch.bool, device=dev)
    return Action(market_qty=torch.zeros((batch,), dtype=torch.float32, device=dev),
                  market_side=torch.full((batch,), BUY, dtype=torch.int32, device=dev),
                  cancel=no, place=no, side=zi, kind=zi, qty=z, limit_price=z, stop_price=z)


def init_state(quote_balance=10_000.0, K: int = 2, L: int = 128, batch: int = 1,
               device=None) -> ExchState:
    """``batch`` fresh venues holding ``quote_balance`` (a float, or a 0-d
    or [B] tensor) of quote, K empty slots and an empty log of L fills."""
    dev = resolve_device(device)
    f = lambda v: torch.full((batch,), v, dtype=torch.float32, device=dev)  # noqa: E731
    i = lambda v: torch.full((batch,), v, dtype=torch.int32, device=dev)  # noqa: E731
    quote = (quote_balance.to(dev, torch.float32).expand(batch).clone()
             if torch.is_tensor(quote_balance) else f(quote_balance))
    zk = torch.zeros((batch, K), dtype=torch.float32, device=dev)
    zki = torch.zeros((batch, K), dtype=torch.int32, device=dev)
    book = Book(active=torch.zeros((batch, K), dtype=torch.bool, device=dev),
                side=zki, kind=zki, qty=zk, limit_price=zk, stop_price=zk)
    return ExchState(quote=quote, base=f(0.0), fee_paid=f(0.0), book=book,
                     pend_active=torch.zeros((batch,), dtype=torch.bool, device=dev),
                     pend_side=i(BUY), pend_qty=f(0.0),
                     fills=torch.zeros((batch, L, len(FILL_FIELDS)), dtype=torch.float32,
                                       device=dev),
                     n_fills=i(0), dropped_fills=i(0))


def _as_f32(t, like: torch.Tensor) -> torch.Tensor:
    """A step index (Python int or tensor) as a float32 0-d tensor on
    ``like``'s device; a Python int is filled on the device (no copy from
    the host)."""
    if torch.is_tensor(t):
        return t.to(torch.float32)
    return torch.full((), float(t), dtype=torch.float32, device=like.device)


def _fill(s: ExchState, t, tag: int, side, qty, price, fee_rate):
    """Book one attempted fill per venue — FakeExchange._fill: a BUY needs
    quote ≥ cost + fee, a SELL base ≥ qty, or the fill is REJECTED and
    nothing moves.  ``side`` [B] int32, ``qty`` and ``price`` [B].  Returns
    (state, ok [B])."""
    cost = qty * price
    fee = cost * fee_rate
    is_buy = side > 0
    ok = (qty > 0.0) & torch.where(is_buy, s.quote >= cost + fee, s.base >= qty)
    quote = s.quote + torch.where(ok, torch.where(is_buy, -(cost + fee), cost - fee), 0.0)
    base = s.base + torch.where(ok, torch.where(is_buy, qty, -qty), 0.0)
    fee_paid = s.fee_paid + torch.where(ok, fee, 0.0)
    B, L, F = s.fills.shape
    row = torch.stack([_as_f32(t, qty).expand(B), torch.full_like(qty, float(tag)),
                       side.to(torch.float32), qty, price, fee], dim=-1)
    slot = torch.clamp_max(s.n_fills, L - 1).long().view(B, 1, 1).expand(B, 1, F)
    write = ok & (s.n_fills < L)
    current = s.fills.gather(1, slot).squeeze(1)
    fills = s.fills.scatter(1, slot, torch.where(write.unsqueeze(-1), row, current).unsqueeze(1))
    return s._replace(quote=quote, base=base, fee_paid=fee_paid, fills=fills,
                      n_fills=s.n_fills + write.to(torch.int32),
                      dropped_fills=s.dropped_fills + (ok & ~write).to(torch.int32)), ok


def settle_pending(s: ExchState, candle: dict, t, fee_rate, spread, halt) -> ExchState:
    """Fill each latency-parked market order at this candle's OPEN (a stale
    quote); a halted venue keeps it parked.  Filled or rejected, a settled
    order is consumed."""
    want = s.pend_active & (halt == 0.0)
    price = candle["open"] * (1.0 + s.pend_side * spread * 0.5)
    s, _ok = _fill(s, t, 0, s.pend_side, torch.where(want, s.pend_qty, 0.0), price, fee_rate)
    return s._replace(pend_active=s.pend_active & ~want)


def match_candle(s: ExchState, candle: dict, t, liquidity_cap, halt, fee_rate,
                 gate=None) -> ExchState:
    """Match every resting slot against the candle, in slot order —
    FakeExchange._match_orders, unrolled over the K slots so each fill sees
    the balances the previous slot's fill left.

    ``liquidity_cap`` [B] (or 0-d; inf = no cap) is the per-candle,
    per-order base-unit cap: a capped fill leaves the remainder resting.  A
    REJECTED fill leaves the order resting untouched.  ``gate`` ([B, K]
    bool, optional) is an extra per-slot precondition on top of the price
    trigger — the LOB's queue position (`sim.lob`); ``None`` is the
    ungated exchange."""
    K = s.book.active.shape[-1]
    low, high = candle["low"], candle["high"]
    open_venue = halt == 0.0
    qty_cols = list(s.book.qty.unbind(-1))
    active_cols = list(s.book.active.unbind(-1))
    side_cols, kind_cols = s.book.side.unbind(-1), s.book.kind.unbind(-1)
    lp_cols, sp_cols = s.book.limit_price.unbind(-1), s.book.stop_price.unbind(-1)
    for k in range(K):
        side, kind, lp, sp = side_cols[k], kind_cols[k], lp_cols[k], sp_cols[k]
        buy = side > 0
        is_stop = kind == STOP
        limit_trig = (kind == LIMIT) & torch.where(buy, low <= lp, high >= lp)
        stop_trig = is_stop & torch.where(buy, high >= sp, low <= sp)
        price = torch.where(is_stop, torch.where(lp > 0.0, lp, sp), lp)
        trig = active_cols[k] & open_venue & (limit_trig | stop_trig)
        if gate is not None:
            trig = trig & gate[..., k]
        qty_k = qty_cols[k]
        fill_qty = torch.minimum(qty_k, liquidity_cap)
        s, ok = _fill(s, t, k + 1, side, torch.where(trig, fill_qty, 0.0), price, fee_rate)
        filled = trig & ok
        partial = filled & (fill_qty < qty_k)
        qty_cols[k] = torch.where(partial, qty_k - fill_qty, qty_k)
        active_cols[k] = active_cols[k] & ~(filled & ~partial)
    return s._replace(book=s.book._replace(qty=torch.stack(qty_cols, -1),
                                           active=torch.stack(active_cols, -1)))


def apply_action(s: ExchState, candle: dict, t, a: Action, fee_rate, spread, halt,
                 latency) -> ExchState:
    """Apply one candle's requests: cancels, then the market order (filled
    now at close ± spread/2, or parked under latency), then placements into
    free slots.  A halted venue loses every request."""
    open_venue = halt == 0.0
    s = s._replace(book=s.book._replace(
        active=s.book.active & ~(a.cancel & open_venue.unsqueeze(-1))))

    want_mkt = (a.market_qty > 0.0) & open_venue
    park = want_mkt & (latency != 0.0) & ~s.pend_active
    now = want_mkt & (latency == 0.0)
    price = candle["close"] * (1.0 + a.market_side * spread * 0.5)
    s, _ok = _fill(s, t, 0, a.market_side, torch.where(now, a.market_qty, 0.0), price, fee_rate)
    s = s._replace(pend_active=s.pend_active | park,
                   pend_side=torch.where(park, a.market_side, s.pend_side),
                   pend_qty=torch.where(park, a.market_qty, s.pend_qty))

    b = s.book
    can = a.place & ~b.active & open_venue.unsqueeze(-1) & (a.qty > 0.0)
    pick = lambda new, old: torch.where(can, new, old)  # noqa: E731
    return s._replace(book=Book(
        active=b.active | can, side=pick(a.side, b.side), kind=pick(a.kind, b.kind),
        qty=pick(a.qty, b.qty), limit_price=pick(a.limit_price, b.limit_price),
        stop_price=pick(a.stop_price, b.stop_price)))


def equity(s: ExchState, price) -> torch.Tensor:
    """Mark-to-market equity in quote units, [B]."""
    return plus_product(s.quote, s.base, price)
