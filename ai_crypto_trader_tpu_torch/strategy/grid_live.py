"""Live grid + DCA order lifecycle through ExchangeInterface.

Capability parity with the reference's live processing
(`services/grid_trading_strategy.py:517-678` `_process_grid_live`: check
order statuses, on a BUY fill place the paired SELL one level up, on a
SELL fill place the paired BUY one level down + book profit, publish
trade notifications and state; `services/dca_strategy.py:548-700` purchase
execution + rebalancing) — re-designed as launcher cadence services
(objects with `.name` / `async run_once()`, `shell/launcher.py:43-46`)
over the abstract ExchangeInterface, so FakeExchange drives them in tests
and paper mode and BinanceExchange in connected deployments.

Beyond the reference's lifecycle:
  * partial fills are reconciled incrementally — the filled portion gets
    its paired order immediately, the remainder keeps resting (the
    reference only ever handles status == FILLED, :543-560);
  * the ladder re-anchors when price escapes the configured band: cancel
    everything, recompute boundaries from recent range, re-place, and
    carry unsold inventory as SELL orders at the nearest new level above
    price (the reference's grid is static once initialized).

The port's own copy of `ai_crypto_trader_tpu/strategy/grid_live.py`, host
code over the port's `shell.exchange` (the same orders, fills, books and
bus payloads).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ai_crypto_trader_tpu_torch.strategy.grid import (
    GridTrader, auto_boundaries, REGIME_GRID_COUNTS)


@dataclass
class GridTraderService:
    """The resting-ladder state machine: place → reconcile fills → pair →
    re-anchor, one `run_once()` per launcher tick."""

    exchange: object
    symbol: str = "BTCUSDC"
    n_grids: int = 10
    spacing: str = "arithmetic"
    order_size: float = 100.0          # quote units per level
    lookback: int = 500
    reanchor_margin_pct: float = 1.0   # price beyond band edge by this → rebuild
    regime: str = "ranging"
    bus: object | None = None
    name: str = "grid"
    levels: np.ndarray | None = None
    # tracked orders: order_id → {side, level_i, qty, filled, price}
    orders: dict = field(default_factory=dict)
    total_profit: float = 0.0
    total_trades: int = 0
    profitable_trades: int = 0
    carry_sales: int = 0           # re-anchor inventory sold (no basis)
    _started: bool = False

    # --- ladder construction ------------------------------------------------
    def _recent_closes(self) -> np.ndarray:
        rows = self.exchange.get_klines(self.symbol, limit=self.lookback)
        return np.asarray([r[4] for r in rows], np.float64)

    def start(self) -> int:
        """Build boundaries from recent range and place the initial BUY
        ladder below price (`_initialize_grid` + first placement pass)."""
        closes = self._recent_closes()
        lo, hi = auto_boundaries(closes, lookback=self.lookback)
        n = REGIME_GRID_COUNTS.get(self.regime, self.n_grids)
        trader = GridTrader(lower=lo, upper=hi, n_grids=n,
                            spacing=self.spacing, order_size=self.order_size)
        self.levels = trader.levels
        price = self.exchange.get_ticker(self.symbol)["price"]
        placed = 0
        for i, level in enumerate(self.levels[:-1]):
            if level < price:
                placed += self._place("BUY", i, self.order_size / float(level))
        self._started = True
        return placed

    def _place(self, side: str, level_i: int, qty: float,
               basis: float | None = "level") -> int:
        """Place one ladder order; returns 1 only on acceptance (a REJECTED
        or raising placement must NOT be tracked — the caller retries).

        `basis` is the cost base profit is booked against when a SELL
        fills: the grid level below by default; None for carried re-anchor
        inventory whose true cost came from the OLD ladder (booking the new
        ladder's level spread there would fabricate profit)."""
        level = float(self.levels[level_i + (1 if side == "SELL" else 0)])
        if basis == "level":
            basis = float(self.levels[level_i]) if side == "SELL" else None
        try:
            o = self.exchange.place_order(self.symbol, side, "LIMIT",
                                          quantity=qty, price=level)
        except Exception:              # noqa: BLE001 — ExchangeUnavailable etc.
            return 0
        if o.get("status") in ("OPEN", "FILLED"):
            self.orders[o["order_id"]] = {
                "side": side, "level_i": level_i, "qty": float(qty),
                "filled": 0.0, "paired": 0.0, "price": level, "basis": basis}
            return 1
        return 0

    # --- reconcile ----------------------------------------------------------
    async def run_once(self) -> dict:
        if not self._started:
            self.start()
        price = self.exchange.get_ticker(self.symbol)["price"]
        if self._escaped(price):
            await self._reanchor(price)
            return {"reanchored": True, "orders": len(self.orders)}

        fills = {"buy": 0, "sell": 0}
        for oid, rec in list(self.orders.items()):
            st = self.exchange.order_state(self.symbol, oid, rec["qty"])
            is_open, done = st["is_open"], st["executed_qty"]
            newly = done - rec["filled"]
            if newly > 1e-12:
                rec["filled"] = done
                if rec["side"] == "SELL":
                    # profit is a fact of the fill — book it NOW, against
                    # the recorded cost basis (`:633-646`); pairing below
                    # is a separate, retryable step
                    if rec["basis"] is not None:
                        profit = (rec["price"] - rec["basis"]) * newly
                        self.total_profit += profit
                        self.total_trades += 1
                        if profit > 0:
                            self.profitable_trades += 1
                        await self._notify(rec, newly, profit)
                    else:
                        self.carry_sales += 1
                        await self._notify(rec, newly, None)
                    fills["sell"] += 1
                else:
                    fills["buy"] += 1
            # pair everything filled-but-unpaired — NOT just this tick's
            # slice: a REJECTED/raising placement on an earlier tick left
            # `paired` behind and must be retried, or the position leaks
            unpaired = rec["filled"] - rec["paired"]
            if unpaired > 1e-12:
                if rec["side"] == "BUY":
                    # paired SELL one level up (`:566-597`)
                    if rec["level_i"] + 1 < len(self.levels):
                        if self._place("SELL", rec["level_i"], unpaired):
                            rec["paired"] = rec["filled"]
                    else:
                        rec["paired"] = rec["filled"]     # top level: hold
                else:
                    # re-arm the BUY below (`:600-630`); carried inventory
                    # (basis None) has no ladder slot to re-arm
                    if rec["basis"] is None or \
                            self._place("BUY", rec["level_i"], unpaired):
                        rec["paired"] = rec["filled"]
            if rec["filled"] >= rec["qty"] - 1e-12 and \
                    rec["paired"] >= rec["filled"] - 1e-12 and not is_open:
                del self.orders[oid]
        self._publish_state()
        return {"reanchored": False, **fills, "orders": len(self.orders)}

    def _escaped(self, price: float) -> bool:
        if self.levels is None:
            return False
        m = self.reanchor_margin_pct / 100.0
        return (price > float(self.levels[-1]) * (1 + m)
                or price < float(self.levels[0]) * (1 - m))

    async def _reanchor(self, price: float):
        """Cancel the whole ladder, rebuild the band around current range,
        and carry unsold inventory as SELLs at the nearest level above."""
        # Both sides reconcile against the EXCHANGE ledger, not the local
        # cache: a gap through several levels between ticks means fills the
        # service hasn't seen yet (their profit must still be booked, and
        # already-sold quantity must not be re-listed as inventory).
        inventory = 0.0
        for oid, rec in list(self.orders.items()):
            st = self.exchange.order_state(self.symbol, oid, rec["qty"])
            is_open, done = st["is_open"], st["executed_qty"]
            newly = done - rec["filled"]
            if rec["side"] == "BUY":
                # bought but never paired with a SELL → carry it
                inventory += max(done - rec["paired"], 0.0)
            else:
                if newly > 1e-12 and rec["basis"] is not None:
                    profit = (rec["price"] - rec["basis"]) * newly
                    self.total_profit += profit
                    self.total_trades += 1
                    if profit > 0:
                        self.profitable_trades += 1
                    await self._notify(rec, newly, profit)
                inventory += rec["qty"] - done       # still unsold
            if is_open:
                self.exchange.cancel_order(self.symbol, oid)
        self.orders.clear()
        self.start()
        if inventory > 1e-12:
            above = int(np.searchsorted(self.levels, price, side="right"))
            if 1 <= above < len(self.levels):
                # carried inventory: cost came from the OLD ladder → no
                # basis, so its eventual sale doesn't fabricate profit
                self._place("SELL", above - 1, inventory, basis=None)
        if self.bus is not None:
            await self.bus.publish("grid_trade_notifications", {
                "symbol": self.symbol, "event": "reanchor",
                "price": price, "inventory": inventory})

    async def _notify(self, rec: dict, qty: float, profit: float):
        if self.bus is not None:
            # `grid_trade_notifications` channel (:655-668)
            await self.bus.publish("grid_trade_notifications", {
                "symbol": self.symbol, "side": rec["side"],
                "price": rec["price"], "quantity": qty, "profit": profit})

    def _publish_state(self):
        if self.bus is not None:
            # `grid_orders:{symbol}` / `grid_profit:{symbol}` keys (:670-678)
            self.bus.set(f"grid_orders_{self.symbol}", {
                "orders": [{"order_id": oid, **rec}
                           for oid, rec in self.orders.items()]})
            self.bus.set(f"grid_profit_{self.symbol}", self.stats())

    def stats(self) -> dict:
        return {"total_profit": self.total_profit,
                "total_trades": self.total_trades,
                "profitable_trades": self.profitable_trades,
                "carry_sales": self.carry_sales}


@dataclass
class DCAService:
    """DCA purchases + drift rebalancing as a launcher cadence service
    (`services/dca_strategy.py` run loop, re-designed on the tick)."""

    exchange: object
    dca: object                        # strategy.dca.DCAStrategy
    bus: object | None = None
    now_fn: object = None
    rebalance_targets: dict | None = None     # asset → weight
    rebalance_threshold_pct: float = 5.0
    rebalance_interval_s: float = 86_400.0
    name: str = "dca"
    _last_rebalance_t: float = -1e18

    def _now(self) -> float:
        import time
        return self.now_fn() if self.now_fn is not None else time.time()

    def _regime(self) -> str:
        if self.bus is not None:
            out = self.bus.get(f"market_regime_{self.dca.symbol}") or \
                self.bus.get("market_regime")
            if out:
                return out.get("regime", "ranging")
        return "ranging"

    def _sentiment(self) -> float:
        if self.bus is not None:
            m = self.bus.get(f"social_metrics_{self.dca.symbol}")
            if m:
                return float(m.get("sentiment", 0.5))
        return 0.5

    async def run_once(self) -> dict:
        now = self._now()
        rec = self.dca.maybe_purchase(self.exchange, now,
                                      regime=self._regime(),
                                      sentiment=self._sentiment())
        out = {"purchased": rec is not None, "rebalanced": 0}
        if rec is not None and self.bus is not None:
            await self.bus.publish("dca_purchases",
                                   {"symbol": self.dca.symbol, **rec})
        if (self.rebalance_targets
                and now - self._last_rebalance_t >= self.rebalance_interval_s):
            out["rebalanced"] = self._rebalance()
            self._last_rebalance_t = now
        return out

    def _rebalance(self) -> int:
        """Execute the drift orders through the exchange
        (`_rebalance_portfolio:864` — the reference computes AND places).

        The quote asset comes from the configured DCA symbol — a
        USDT-quoted deployment must price against USDT (round-4 advisor:
        a hardcoded USDC quote raised on every non-USDC venue). A single
        unpriceable asset drops out of this round's rebalance instead of
        killing the whole service tick."""
        from ai_crypto_trader_tpu_torch.utils.symbols import QUOTE_ASSETS, quote_asset

        quote = quote_asset(self.dca.symbol)
        balances = self.exchange.get_balances()
        prices = {}
        for asset in self.rebalance_targets:
            if asset in QUOTE_ASSETS:
                prices[asset] = 1.0
            else:
                try:
                    prices[asset] = self.exchange.get_ticker(
                        f"{asset}{quote}")["price"]
                except Exception:      # noqa: BLE001 — unknown symbol etc.
                    continue
        targets = {a: w for a, w in self.rebalance_targets.items()
                   if a in prices}
        # renormalize after dropping unpriceable assets: raw weights
        # summing <1 against a fully-priced total would read every other
        # asset as overweight and spuriously SELL it each round
        weight_sum = sum(targets.values())
        if not targets or weight_sum <= 0:
            return 0
        targets = {a: w / weight_sum for a, w in targets.items()}
        orders = self.dca.rebalance_orders(
            {a: balances.get(a, 0.0) for a in targets},
            prices, targets, threshold_pct=self.rebalance_threshold_pct,
            quote=quote)
        placed = 0
        for o in orders:
            if o["symbol"].startswith(tuple(QUOTE_ASSETS)):
                continue               # quote legs rebalance implicitly
            r = self.exchange.place_order(o["symbol"], o["side"], "MARKET",
                                          quantity=o["quantity"])
            placed += r.get("status") == "FILLED"
        return placed
