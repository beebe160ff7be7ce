"""Exchange adapters: the abstract interface, a deterministic fake, and a
network-gated Binance adapter.

Capability parity with `services/utils/exchange_interface.py:10-215`
(abstract ExchangeInterface + BinanceExchange + ExchangeFactory), plus the
fake backend the reference never had (its tests hit live Binance —
SURVEY §4): FakeExchange replays a synthetic (or loaded) OHLCV series with
a virtual clock, fills market/limit/stop orders against candle prices,
tracks balances, and is fully deterministic — the substrate for executor /
monitor / integration tests and paper trading.

The port's own copy of `ai_crypto_trader_tpu/shell/exchange.py`: host
Python and NumPy (float64 fills), so every fill, balance and order state is
the JAX package's bit for bit.  `ResilientExchange` wraps any adapter in
the port's circuit breaker and token bucket on an injected clock.
"""

from __future__ import annotations

import itertools
import random
import time
import zlib
from abc import ABC, abstractmethod
from typing import Any, Callable

import numpy as np

from ai_crypto_trader_tpu_torch.data.ingest import OHLCV
from ai_crypto_trader_tpu_torch.utils import symbols as symbols_util


def _interval_minutes(interval: str) -> int:
    return int(interval[:-1]) * {"m": 1, "h": 60, "d": 1440}[interval[-1]]


def resample_klines(rows: list, factor: int) -> list:
    """Aggregate 1×-interval kline rows into factor×-interval bars (shared
    by FakeExchange's interval support and the monitor's local fallback).

    The trailing chunk may be partial — it is the venue's in-progress bar
    and is served as such (Binance includes the current incomplete candle);
    callers that align chunk starts to absolute time get stable bar
    boundaries across successive calls (round-4 advisor)."""
    out = []
    for i in range(0, len(rows), factor):
        chunk = rows[i: i + factor]
        out.append([chunk[0][0], chunk[0][1],
                    max(r[2] for r in chunk), min(r[3] for r in chunk),
                    chunk[-1][4], sum(r[5] for r in chunk)]
                   + list(chunk[-1][6:]))
    return out


class ExchangeInterface(ABC):
    """`exchange_interface.py:10-60` surface."""

    @abstractmethod
    def get_ticker(self, symbol: str) -> dict: ...

    @abstractmethod
    def get_order_book(self, symbol: str, limit: int = 20) -> dict: ...

    @abstractmethod
    def get_klines(self, symbol: str, interval: str = "1m",
                   limit: int = 100) -> list: ...

    @abstractmethod
    def place_order(self, symbol: str, side: str, order_type: str,
                    quantity: float, price: float | None = None,
                    stop_price: float | None = None,
                    client_order_id: str | None = None) -> dict: ...

    @abstractmethod
    def cancel_order(self, symbol: str, order_id: int) -> dict: ...

    @abstractmethod
    def get_balances(self) -> dict: ...

    def order_is_open(self, symbol: str, order_id: int) -> bool:
        """Whether a previously-placed order is still resting (False once
        filled or canceled). Default pessimistically True for adapters that
        don't track state."""
        return True

    def executed_qty(self, symbol: str, order_id: int,
                     assumed_total: float, is_open: bool) -> float:
        """Cumulative filled base quantity for one order.

        The default degrades to all-or-nothing from open/closed state — an
        adapter with real fill accounting MUST override: the default books
        a venue-cancelled/expired/rejected order as fully filled (round-4
        advisor), which fabricates inventory. `is_open` is the caller's
        single per-tick status read, passed in so the default costs no
        extra REST round-trip."""
        return 0.0 if is_open else assumed_total

    def order_state(self, symbol: str, order_id: int,
                    assumed_total: float) -> dict:
        """One combined per-tick status read: {"is_open", "executed_qty"}.
        Reconcilers call THIS (one venue round-trip per order per tick on
        adapters that override it); the default composes the two simpler
        queries for adapters where reads are local."""
        is_open = self.order_is_open(symbol, order_id)
        return {"is_open": is_open,
                "executed_qty": self.executed_qty(symbol, order_id,
                                                  assumed_total, is_open)}

    def list_symbols(self, quote: str | None = None) -> list[str]:
        """All tradable symbols, optionally filtered to one quote asset —
        the discovery surface `CryptoScanner.scan_market` builds from
        exchange info (`binance_ml_strategy.py:293-340`). Default empty for
        adapters without discovery."""
        return []

    def find_order_by_client_id(self, symbol: str,
                                client_order_id: str) -> dict | None:
        """Look an order up by the caller-chosen client id.

        This is how an AMBIGUOUS mutation failure ("place_order raised —
        but did the request reach the venue?") is resolved after a crash:
        the reconciler re-derives the deterministic client id from the
        journaled intent and asks the venue whether it knows the order.
        Default None = adapter cannot answer (callers must then treat the
        intent as unresolved and stand down, never re-enter blindly)."""
        return None

    def list_open_orders(self, symbol: str | None = None) -> list[dict]:
        """All resting orders (optionally one symbol) — the reconciler's
        orphan sweep. Default empty for adapters without order state."""
        return []


def load_depth_records(source) -> list[dict]:
    """Depth records from a capture: a JSONL journal path (the
    `utils/journal` record format `shell/stream.DepthCapture` writes — crc
    verified, torn tail tolerated), a list of already-parsed record dicts,
    or a `DepthCapture` instance (its ring).  Only SNAPSHOT records with
    both book sides are kept: ``@depth`` diff records are per-level
    CHANGES (zero-size removals included), not books — serving one as a
    book would feed the analytics garbage.  Subscribe the ``@depth20``
    snapshot channel for replayable/calibratable captures
    (`binance_kline_url(depth_symbols=…)` does both)."""
    if source is None:
        return []
    if hasattr(source, "records"):                  # a DepthCapture
        records = source.records()
    elif isinstance(source, str):
        from ai_crypto_trader_tpu_torch.utils.journal import replay

        records = [r["data"] for r in replay(source)[0]
                   if r.get("kind") == "depth"]
    else:
        records = list(source)
    return [r for r in records
            if r.get("bids") and r.get("asks")
            and r.get("kind", "snapshot") == "snapshot"]


class FakeExchange(ExchangeInterface):
    """Deterministic candle-replay exchange with a virtual clock.

    `advance()` moves to the next candle; open limit/stop orders are
    evaluated against each new candle's high/low, like a real matching
    engine at candle granularity.

    ``depth_capture`` (a capture journal path, record list, or
    DepthCapture) switches `get_order_book` from crc32-synthesized books
    to REPLAYED captured depth — executor/analyzer tests run against
    real book shapes (level spacing, size distributions, holes) instead
    of the synthetic geometric ladder."""

    def __init__(self, series: dict[str, OHLCV], quote_balance: float = 10_000.0,
                 fee_rate: float = 0.001, max_fill_base: float | None = None,
                 depth_capture=None):
        self.series = series
        self.cursor = {s: 0 for s in series}
        self.balances: dict[str, float] = {"USDC": quote_balance}
        self.fee_rate = fee_rate
        # Per-candle liquidity cap (base units): a resting limit order fills
        # at most this much per candle, the remainder stays OPEN — the
        # partial-fill reality grid/DCA reconciliation must survive.
        self.max_fill_base = max_fill_base
        self.depth_records = load_depth_records(depth_capture)
        # bucketed once: get_order_book runs per symbol per tick and must
        # not rescan the whole capture on every call
        self._depth_by_symbol: dict[str, list] = {}
        for r in self.depth_records:
            self._depth_by_symbol.setdefault(r.get("symbol", ""),
                                             []).append(r)
        self.open_orders: dict[int, dict] = {}
        self.fills: list[dict] = []
        self._fills_by_oid: dict[int, list] = {}
        self._order_ids = itertools.count(1)

    # --- clock -------------------------------------------------------------
    def advance(self, symbol: str | None = None, steps: int = 1) -> None:
        for sym in ([symbol] if symbol else list(self.series)):
            self.cursor[sym] = min(self.cursor[sym] + steps,
                                   len(self.series[sym]) - 1)
            self._match_orders(sym)

    def _candle(self, symbol: str, offset: int = 0):
        i = max(self.cursor[symbol] - offset, 0)
        s = self.series[symbol]
        return {k: float(getattr(s, k)[i]) for k in
                ("open", "high", "low", "close", "volume")} | {
                    "timestamp": int(s.timestamp[i])}

    # --- market data -------------------------------------------------------
    def get_ticker(self, symbol: str) -> dict:
        c = self._candle(symbol)
        return {"symbol": symbol, "price": c["close"], "volume": c["volume"],
                "timestamp": c["timestamp"]}

    def get_order_book(self, symbol: str, limit: int = 20) -> dict:
        """Synthetic book around the candle close: geometric level spacing,
        sizes decaying with depth — enough structure for the order-book
        analytics (imbalance/walls/impact) to chew on.

        With a ``depth_capture`` attached, captured depth is REPLAYED
        instead: the record is picked deterministically by the virtual
        clock (cursor-indexed), so every consumer sees real book shapes
        and repeated calls at the same cursor stay bit-identical.  Only
        THIS symbol's records (or symbol-less ones — hand-built record
        lists) replay; a symbol absent from the capture falls back to
        the synthetic book rather than silently serving another
        symbol's price scale as ``captured``."""
        c = self._candle(symbol)
        mine = (self._depth_by_symbol.get(symbol)
                or self._depth_by_symbol.get(""))
        if mine:
            rec = mine[self.cursor[symbol] % len(mine)]
            return {"symbol": symbol,
                    "bids": [list(lv) for lv in rec["bids"][:limit]],
                    "asks": [list(lv) for lv in rec["asks"][:limit]],
                    "timestamp": c["timestamp"],
                    "captured": True, "capture_event_ms": rec.get("E", 0)}
        mid = c["close"]
        spread = max(mid * 1e-4, 1e-8)
        levels = np.arange(1, limit + 1)
        # deterministic per (symbol, candle): the symbol is mixed into the
        # seed (stable crc32, not salted hash()) so two symbols at the same
        # cursor don't serve identically-shaped books
        rng = np.random.default_rng(
            (zlib.crc32(symbol.encode()), self.cursor[symbol]))
        sizes = c["volume"] / limit * np.exp(-levels / limit) * (1 + 0.3 * rng.random(limit))
        bids = [[mid - spread * i, float(s)] for i, s in zip(levels, sizes)]
        asks = [[mid + spread * i, float(s)] for i, s in zip(levels, sizes)]
        return {"symbol": symbol, "bids": bids, "asks": asks,
                "timestamp": c["timestamp"]}

    def list_symbols(self, quote: str | None = None) -> list[str]:
        syms = sorted(self.series)
        if quote:
            syms = [s for s in syms if s.endswith(quote)]
        return syms

    def get_klines(self, symbol: str, interval: str = "1m",
                   limit: int = 100) -> list:
        """Candles at the requested interval — a real venue serves native
        3m/5m/15m bars capped at ~1000/request, so consumers fetch each
        frame separately instead of one giant 1m window; the fake honors
        the same contract by resampling its 1m series."""
        factor = _interval_minutes(interval)
        s = self.series[symbol]
        end = self.cursor[symbol] + 1
        start = max(end - limit * factor, 0)
        # align chunk starts to absolute time so 3m/5m/15m bar boundaries
        # are stable across ticks, like a real venue's fixed-boundary bars
        # (round-4 advisor: sliding anchors made HTF histories jitter)
        start -= start % factor
        rows = []
        for i in range(start, end):
            rows.append([int(s.timestamp[i]), float(s.open[i]), float(s.high[i]),
                         float(s.low[i]), float(s.close[i]), float(s.volume[i]),
                         0, 0.0, 0, 0.0, 0.0, 0])
        if factor > 1:
            rows = resample_klines(rows, factor)
        return rows[-limit:]

    # --- trading -----------------------------------------------------------
    def _base_asset(self, symbol: str) -> str:
        return symbols_util.base_asset(symbol)

    def _quote_asset(self, symbol: str) -> str:
        return symbols_util.quote_asset(symbol)

    def _fill(self, order: dict, price: float) -> dict:
        symbol, side, qty = order["symbol"], order["side"], order["quantity"]
        base, quote = self._base_asset(symbol), self._quote_asset(symbol)
        cost = qty * price
        fee = cost * self.fee_rate
        if side == "BUY":
            if self.balances.get(quote, 0.0) < cost + fee:
                return {**order, "status": "REJECTED", "reason": "insufficient_balance"}
            self.balances[quote] = self.balances.get(quote, 0.0) - cost - fee
            self.balances[base] = self.balances.get(base, 0.0) + qty
        else:
            if self.balances.get(base, 0.0) < qty:
                return {**order, "status": "REJECTED", "reason": "insufficient_balance"}
            self.balances[base] -= qty
            self.balances[quote] = self.balances.get(quote, 0.0) + cost - fee
        filled = {**order, "status": "FILLED", "price": price, "fee": fee}
        self.fills.append(filled)
        self._fills_by_oid.setdefault(order.get("order_id"), []).append(filled)
        return filled

    def place_order(self, symbol: str, side: str, order_type: str,
                    quantity: float, price: float | None = None,
                    stop_price: float | None = None,
                    client_order_id: str | None = None) -> dict:
        if not (np.isfinite(quantity) and quantity > 0.0):
            # a real venue rejects NaN/zero/negative quantities at the
            # filter layer — booking one here would poison the balances
            return {"symbol": symbol, "side": side.upper(),
                    "type": order_type.upper(), "status": "REJECTED",
                    "reason": "invalid_quantity"}
        if client_order_id is not None:
            # venue-side idempotency (Binance rejects duplicate
            # newClientOrderId): a retried/replayed placement returns the
            # original order instead of double-entering
            existing = self.find_order_by_client_id(symbol, client_order_id)
            if existing is not None:
                return {**existing, "duplicate": True}
        oid = next(self._order_ids)
        order = {"order_id": oid, "symbol": symbol, "side": side.upper(),
                 "type": order_type.upper(), "quantity": float(quantity),
                 "limit_price": price, "stop_price": stop_price,
                 "client_order_id": client_order_id}
        if order["type"] == "MARKET":
            return self._fill(order, self._candle(symbol)["close"])
        order["status"] = "OPEN"
        self.open_orders[oid] = order
        return dict(order)

    def _match_orders(self, symbol: str) -> None:
        c = self._candle(symbol)
        for oid, o in list(self.open_orders.items()):
            if o["symbol"] != symbol:
                continue
            t, side = o["type"], o["side"]
            fill_price = None
            if t == "LIMIT":
                if side == "BUY" and c["low"] <= o["limit_price"]:
                    fill_price = o["limit_price"]
                elif side == "SELL" and c["high"] >= o["limit_price"]:
                    fill_price = o["limit_price"]
            elif t in ("STOP_LOSS", "STOP_LOSS_LIMIT"):
                if side == "SELL" and c["low"] <= o["stop_price"]:
                    fill_price = o["limit_price"] or o["stop_price"]
                elif side == "BUY" and c["high"] >= o["stop_price"]:
                    fill_price = o["limit_price"] or o["stop_price"]
            if fill_price is not None:
                qty = o["quantity"]
                # `is not None`, not truthiness: a cap of exactly 0.0 means
                # NO liquidity this candle (the sim's schedule can drive the
                # cap to zero), not "uncapped"
                fill_qty = (min(qty, self.max_fill_base)
                            if self.max_fill_base is not None else qty)
                if fill_qty <= 0.0:
                    continue               # zero-liquidity candle: rests on
                result = self._fill({**o, "quantity": fill_qty}, fill_price)
                if result["status"] == "FILLED":
                    if fill_qty < qty:
                        o["quantity"] = qty - fill_qty   # partial: stays open
                    else:
                        del self.open_orders[oid]

    def cancel_order(self, symbol: str, order_id: int) -> dict:
        o = self.open_orders.pop(order_id, None)
        if o is None:
            return {"order_id": order_id, "status": "NOT_FOUND"}
        return {**o, "status": "CANCELED"}

    def order_is_open(self, symbol: str, order_id: int) -> bool:
        return order_id in self.open_orders

    def find_order_by_client_id(self, symbol, client_order_id):
        for o in self.open_orders.values():
            if (o.get("client_order_id") == client_order_id
                    and o["symbol"] == symbol):
                return dict(o)
        for f in reversed(self.fills):
            if (f.get("client_order_id") == client_order_id
                    and f["symbol"] == symbol):
                return dict(f)
        return None

    def list_open_orders(self, symbol: str | None = None) -> list[dict]:
        return [dict(o) for o in self.open_orders.values()
                if symbol is None or o["symbol"] == symbol]

    def last_fill(self, order_id: int) -> dict | None:
        for f in reversed(self.fills):
            if f.get("order_id") == order_id:
                return f
        return None

    def fills_for(self, order_id: int) -> list[dict]:
        """All (possibly partial) fills booked against one order — the
        executed-quantity ledger reconciliation reads (indexed: long paper
        runs reconcile every tracked order every tick)."""
        return list(self._fills_by_oid.get(order_id, ()))

    def executed_qty(self, symbol: str, order_id: int,
                     assumed_total: float, is_open: bool) -> float:
        return float(sum(f["quantity"] for f in self.fills_for(order_id)
                         if f.get("status") == "FILLED"))

    def get_balances(self) -> dict:
        return dict(self.balances)


class BinanceExchange(ExchangeInterface):
    """Live Binance adapter (`exchange_interface.py:61-180` surface).

    Network access is absent in this environment, so construction is gated:
    it raises with a clear message unless a client object is injected."""

    def __init__(self, client: Any = None):
        if client is None:
            raise RuntimeError(
                "BinanceExchange requires an injected client (e.g. "
                "binance.Client). This environment has no network; use "
                "FakeExchange for tests/paper trading.")
        self.client = client

    def get_ticker(self, symbol):
        t = self.client.get_symbol_ticker(symbol=symbol)
        return {"symbol": symbol, "price": float(t["price"])}

    def get_order_book(self, symbol, limit=20):
        return self.client.get_order_book(symbol=symbol, limit=limit)

    def get_klines(self, symbol, interval="1m", limit=100):
        return self.client.get_klines(symbol=symbol, interval=interval, limit=limit)

    def place_order(self, symbol, side, order_type, quantity, price=None,
                    stop_price=None, client_order_id=None):
        kw = dict(symbol=symbol, side=side, type=order_type, quantity=quantity)
        if price is not None:
            kw["price"] = price
        if stop_price is not None:
            kw["stopPrice"] = stop_price
        if client_order_id is not None:
            # venue-enforced idempotency key: a deterministic id makes an
            # ambiguous failure ("raised — did it reach Binance?")
            # resolvable via get_order(origClientOrderId=...) instead of a
            # silent double-order hazard
            kw["newClientOrderId"] = client_order_id
        return self.client.create_order(**kw)

    def cancel_order(self, symbol, order_id):
        return self.client.cancel_order(symbol=symbol, orderId=order_id)

    def find_order_by_client_id(self, symbol, client_order_id):
        try:
            o = self.client.get_order(symbol=symbol,
                                      origClientOrderId=client_order_id)
        except Exception as exc:                       # noqa: BLE001
            # ONLY "unknown order" means the venue never saw this id.
            # Anything else (timeout, rate limit, 5xx) must PROPAGATE —
            # ResilientExchange wraps it and the reconciler keeps the
            # intent parked; returning None here would make a network
            # blip indistinguishable from not-placed and unblock the
            # exact double-entry the client id exists to prevent.
            msg = str(exc).lower()
            if (getattr(exc, "code", None) == -2013     # binance NO_SUCH_ORDER
                    or "does not exist" in msg or "unknown order" in msg):
                return None
            raise
        executed = float(o.get("executedQty", 0.0) or 0.0)
        price = float(o.get("price", 0.0) or 0.0)
        if price <= 0.0 and executed > 0.0:
            # MARKET orders report price=0; the real average fill price
            # is cumulative quote volume over executed base
            price = float(o.get("cummulativeQuoteQty", 0.0) or 0.0) / executed
        return {"order_id": o.get("orderId"), "symbol": symbol,
                "status": o.get("status"), "side": o.get("side"),
                "quantity": float(o.get("origQty", 0.0)),
                "executed_qty": executed,
                "price": price,
                "client_order_id": client_order_id}

    def list_open_orders(self, symbol=None):
        kw = {"symbol": symbol} if symbol else {}
        return [{"order_id": o.get("orderId"), "symbol": o.get("symbol"),
                 "status": o.get("status"), "side": o.get("side"),
                 "type": o.get("type"),
                 "quantity": float(o.get("origQty", 0.0)),
                 "client_order_id": o.get("clientOrderId")}
                for o in self.client.get_open_orders(**kw)]

    def order_is_open(self, symbol, order_id):
        o = self.client.get_order(symbol=symbol, orderId=order_id)
        return o.get("status") in ("NEW", "PARTIALLY_FILLED")

    def executed_qty(self, symbol, order_id, assumed_total, is_open):
        """Binance's get_order returns executedQty for EVERY status —
        including CANCELED/EXPIRED/REJECTED and partial fills — so live
        reconciliation never books phantom inventory (round-4 advisor)."""
        o = self.client.get_order(symbol=symbol, orderId=order_id)
        return float(o.get("executedQty", 0.0))

    def order_state(self, symbol, order_id, assumed_total):
        """ONE get_order answers both questions — reconcilers polling
        order_is_open + executed_qty separately would double the REST
        volume through the rate limiter."""
        o = self.client.get_order(symbol=symbol, orderId=order_id)
        return {"is_open": o.get("status") in ("NEW", "PARTIALLY_FILLED"),
                "executed_qty": float(o.get("executedQty", 0.0))}

    def get_balances(self):
        acct = self.client.get_account()
        return {b["asset"]: float(b["free"]) for b in acct["balances"]}

    def list_symbols(self, quote=None):
        info = self.client.get_exchange_info()
        syms = [s["symbol"] for s in info.get("symbols", [])
                if s.get("status", "TRADING") == "TRADING"]
        if quote:
            syms = [s for s in syms if s.endswith(quote)]
        return sorted(syms)


class ExchangeUnavailable(RuntimeError):
    """Raised by ResilientExchange when the circuit is open or an operation
    has exhausted its retries — the caller's cycle should skip/abort."""


class _BlockingBudgetExceeded(RuntimeError):
    """Internal: a sleep would exceed ResilientExchange.max_block_s."""


class ResilientExchange(ExchangeInterface):
    """Resilience decorator around any ExchangeInterface.

    Wires the protections the reference puts around its Binance calls
    (`services/market_monitor_service.py:96-115`: breaker 3 failures/30 s;
    `services/utils/rate_limiter.py`; `circuit_breaker.py:227` backoff) at
    the adapter seam, so every consumer (monitor, executor, risk, CLI) gets
    them without wiring its own:

    - every call first passes the circuit breaker (an open circuit rejects
      at the door without burning tokens or wall-clock), then every
      PHYSICAL attempt — including each retry — acquires from a token
      bucket, sleeping out any deficit (Binance weight limits hold even
      during an error storm);
    - reads are retried with exponential backoff + jitter; a read counts
      as ONE breaker failure only once its retries are exhausted;
    - mutations (place_order / cancel_order) are NEVER retried — order
      placement is not idempotent; one attempt, and any raising attempt
      counts toward the breaker (the reference's breaker likewise wraps
      every Binance call, business errors included:
      `market_monitor_service.py:96-115`);
    - an open circuit or a final failure raises ExchangeUnavailable
      (executor cycles fail loudly instead of silently trading on None);
    - total BLOCKING time per public call is bounded by ``max_block_s``:
      backoff and token-bucket deficits sleep on the caller's thread —
      on the one shared event loop a retry storm would otherwise freeze
      every service, alert evaluation and heartbeat for up to
      ``max_delay_s``.  When the budget is exhausted the call fails as
      ExchangeUnavailable (a breaker failure) instead of sleeping on;
    - loop callers that cannot afford ANY blocking await ``acall(...)``,
      which runs the same protected call on a worker thread — the
      async-aware seam (sleeps happen off-loop, heartbeats keep beating).

    Deterministic: clock, sleep and jitter rng are injectable.
    """

    def __init__(self, inner: ExchangeInterface,
                 failure_threshold: int = 3, reset_timeout_s: float = 30.0,
                 rate_per_s: float = 20.0, burst: float = 40.0,
                 max_read_retries: int = 2, base_delay_s: float = 0.25,
                 max_delay_s: float = 30.0,
                 max_block_s: float | None = 30.0,
                 now_fn: Callable[[], float] = time.time,
                 sleep: Callable[[float], None] = time.sleep,
                 rng: random.Random | None = None):
        from ai_crypto_trader_tpu_torch.utils.circuit_breaker import CircuitBreaker
        from ai_crypto_trader_tpu_torch.utils.rate_limiter import TokenBucket

        self.inner = inner
        self.breaker = CircuitBreaker("exchange",
                                      failure_threshold=failure_threshold,
                                      reset_timeout_s=reset_timeout_s,
                                      now_fn=now_fn)
        self.bucket = TokenBucket(rate_per_s=rate_per_s, capacity=burst,
                                  now_fn=now_fn)
        self.max_read_retries = max_read_retries
        self.base_delay_s = base_delay_s
        self.max_delay_s = max_delay_s
        self.max_block_s = max_block_s
        self._sleep = sleep
        self._rng = rng or random.Random(0)

    def __getattr__(self, name):
        # Delegate the inner adapter's extra surface (FakeExchange.advance /
        # fills / last_fill, client handles, …) so wrapping is transparent.
        if name == "inner":                 # pre-__init__ lookup guard
            raise AttributeError(name)
        return getattr(self.inner, name)

    def _gate(self):
        # Breaker first: an open circuit must not burn tokens or wall-clock.
        if not self.breaker.allow():
            raise ExchangeUnavailable(
                f"exchange circuit {self.breaker.state.value}")

    def _budget(self) -> list:
        """Per-public-call blocking allowance, consumed by every sleep."""
        return [float("inf") if self.max_block_s is None else self.max_block_s]

    def _budgeted_sleep(self, seconds: float, budget: list) -> None:
        if seconds > budget[0]:
            raise _BlockingBudgetExceeded(
                f"sleep of {seconds:.2f}s would exceed the per-call "
                f"blocking budget ({self.max_block_s}s)")
        budget[0] -= seconds
        self._sleep(seconds)

    def _acquire_token(self, budget: list):
        while not self.bucket.try_acquire():
            self._budgeted_sleep(max(self.bucket.wait_time(), 1e-3), budget)

    def _read(self, fn: Callable, *args, **kw):
        from ai_crypto_trader_tpu_torch.utils.circuit_breaker import backoff_delays

        self._gate()
        self.breaker.stats["calls"] += 1
        delays = backoff_delays(self.max_read_retries, self.base_delay_s,
                                self.max_delay_s, rng=self._rng)
        budget = self._budget()
        last_exc: Exception | None = None
        for _attempt in range(self.max_read_retries + 1):
            try:
                self._acquire_token(budget)   # every physical attempt pays
                out = fn(*args, **kw)
            except _BlockingBudgetExceeded as exc:
                last_exc = exc
                break                         # no budget left to retry with
            except Exception as exc:                       # noqa: BLE001
                last_exc = exc
                delay = next(delays, None)
                if delay is not None:
                    try:
                        self._budgeted_sleep(delay, budget)
                    except _BlockingBudgetExceeded:
                        break
                continue
            self.breaker.record_success()
            return out
        self.breaker.record_failure()
        raise ExchangeUnavailable(f"read failed after "
                                  f"{self.max_read_retries + 1} attempts: "
                                  f"{last_exc}") from last_exc

    def _write(self, fn: Callable, *args, **kw):
        self._gate()
        try:
            self._acquire_token(self._budget())
        except _BlockingBudgetExceeded as exc:
            self.breaker.record_failure()
            raise ExchangeUnavailable(
                f"order operation blocked on rate limit: {exc}") from exc
        self.breaker.stats["calls"] += 1
        try:
            out = fn(*args, **kw)
        except Exception as exc:                           # noqa: BLE001
            self.breaker.record_failure()
            raise ExchangeUnavailable(f"order operation failed: {exc}") from exc
        self.breaker.record_success()
        return out

    async def acall(self, method: str, *args, **kw):
        """Async-aware seam for event-loop callers: run one protected
        call (``await ex.acall("get_klines", sym, "1m", 100)``) on a
        worker thread, so backoff/rate-limit sleeps never block the shared
        loop.  The inner adapter must be thread-compatible for the call
        (true of BinanceExchange's HTTP client; FakeExchange callers
        should keep using the sync surface on the loop)."""
        import asyncio

        return await asyncio.to_thread(getattr(self, method), *args, **kw)

    # --- reads: retried ----------------------------------------------------
    def get_ticker(self, symbol):
        return self._read(self.inner.get_ticker, symbol)

    def get_order_book(self, symbol, limit=20):
        return self._read(self.inner.get_order_book, symbol, limit)

    def get_klines(self, symbol, interval="1m", limit=100):
        return self._read(self.inner.get_klines, symbol, interval, limit)

    def get_balances(self):
        return self._read(self.inner.get_balances)

    def order_is_open(self, symbol, order_id):
        return self._read(self.inner.order_is_open, symbol, order_id)

    def executed_qty(self, symbol, order_id, assumed_total, is_open):
        return self._read(self.inner.executed_qty, symbol, order_id,
                          assumed_total, is_open)

    def order_state(self, symbol, order_id, assumed_total):
        return self._read(self.inner.order_state, symbol, order_id,
                          assumed_total)

    def find_order_by_client_id(self, symbol, client_order_id):
        return self._read(self.inner.find_order_by_client_id, symbol,
                          client_order_id)

    def list_open_orders(self, symbol=None):
        return self._read(self.inner.list_open_orders, symbol)

    # --- mutations: single attempt -----------------------------------------
    def place_order(self, symbol, side, order_type, quantity, price=None,
                    stop_price=None, client_order_id=None):
        kw = ({"client_order_id": client_order_id}
              if client_order_id is not None else {})
        return self._write(self.inner.place_order, symbol, side, order_type,
                           quantity, price, stop_price, **kw)

    def cancel_order(self, symbol, order_id):
        return self._write(self.inner.cancel_order, symbol, order_id)


def make_exchange(kind: str = "fake", resilient: bool | None = None,
                  resilient_opts: dict | None = None,
                  **kw) -> ExchangeInterface:
    """ExchangeFactory parity (`exchange_interface.py:181-215`).

    Live adapters are wrapped in ResilientExchange by default (the
    reference wires breakers around its Binance calls; here the factory
    guarantees it). Pass resilient=False to get the bare adapter.
    `resilient_opts` go to the ResilientExchange ctor — simulations on a
    virtual clock must pass their own now_fn/sleep so the token bucket
    doesn't throttle in real wall-clock time."""
    opts = resilient_opts or {}
    if kind == "fake":
        ex: ExchangeInterface = FakeExchange(**kw)
        return ResilientExchange(ex, **opts) if resilient else ex
    if kind == "binance":
        ex = BinanceExchange(**kw)
        return ex if resilient is False else ResilientExchange(ex, **opts)
    raise ValueError(f"unknown exchange kind {kind!r}")
