"""Dollar-cost-averaging strategy.

Capability parity with DCAStrategy (`services/dca_strategy.py`):
scheduling modes fixed / regime_based / value_averaging / weighted
(`_calculate_next_purchase_time:347`), dip-buying boosts, purchase
execution (`_execute_dca_purchase:548`), and portfolio rebalancing toward
target weights (`_rebalance_portfolio:864`).  Deterministic via injected
clock; exchange-agnostic via ExchangeInterface.

The port's own copy of `ai_crypto_trader_tpu/strategy/dca.py`, host code.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

REGIME_INTERVAL_MULT = {"bull": 1.5, "bear": 0.5, "ranging": 1.0, "volatile": 0.75}


@dataclass
class DCAStrategy:
    symbol: str = "BTCUSDC"
    base_amount: float = 100.0
    interval_s: float = 86_400.0
    schedule: str = "fixed"        # fixed | regime_based | value_averaging | weighted
    dip_threshold_pct: float = 5.0
    dip_multiplier: float = 2.0
    target_value_growth: float = 100.0    # value averaging: target Δvalue/period
    purchases: list = field(default_factory=list)
    _last_purchase_t: float = field(default=-1e18)

    def next_purchase_time(self, now: float, regime: str = "ranging") -> float:
        """`_calculate_next_purchase_time:347`."""
        interval = self.interval_s
        if self.schedule == "regime_based":
            interval *= REGIME_INTERVAL_MULT.get(regime, 1.0)
        return self._last_purchase_t + interval if self.purchases else now

    def purchase_amount(self, price: float, recent_high: float,
                        holdings_value: float = 0.0,
                        sentiment: float = 0.5) -> float:
        """Amount for the next buy: dip boost, value averaging, or
        sentiment-weighted (`dca_strategy.py:548-700`)."""
        amount = self.base_amount
        if self.schedule == "value_averaging":
            target = self.target_value_growth * (len(self.purchases) + 1)
            amount = max(target - holdings_value, 0.0)
        elif self.schedule == "weighted":
            # contrarian weighting: buy more when sentiment is fearful
            amount = self.base_amount * float(np.clip(1.5 - sentiment, 0.5, 2.0))
        drawdown_pct = (recent_high - price) / recent_high * 100.0 if recent_high > 0 else 0.0
        if drawdown_pct >= self.dip_threshold_pct:
            amount *= self.dip_multiplier
        return amount

    def maybe_purchase(self, exchange, now: float, regime: str = "ranging",
                       sentiment: float = 0.5) -> dict | None:
        """`_execute_dca_purchase:548`."""
        if now < self.next_purchase_time(now, regime):
            return None
        ticker = exchange.get_ticker(self.symbol)
        price = ticker["price"]
        klines = exchange.get_klines(self.symbol, limit=288)
        recent_high = max((row[2] for row in klines), default=price)
        held = sum(p["quantity"] for p in self.purchases) * price
        amount = self.purchase_amount(price, recent_high, held, sentiment)
        if amount <= 0:
            self._last_purchase_t = now
            return None
        order = exchange.place_order(self.symbol, "BUY", "MARKET",
                                     quantity=amount / price)
        if order.get("status") != "FILLED":
            return None
        rec = {"price": order["price"], "quantity": order["quantity"],
               "amount": amount, "t": now}
        self.purchases.append(rec)
        self._last_purchase_t = now
        return rec

    def average_cost(self) -> float:
        q = sum(p["quantity"] for p in self.purchases)
        spent = sum(p["price"] * p["quantity"] for p in self.purchases)
        return spent / q if q > 0 else 0.0

    @staticmethod
    def rebalance_orders(holdings: dict[str, float], prices: dict[str, float],
                         targets: dict[str, float],
                         threshold_pct: float = 5.0,
                         quote: str = "USDC") -> list[dict]:
        """`_rebalance_portfolio:864`: orders moving the portfolio toward
        target weights when drift exceeds the threshold. ``quote`` names
        the venue's quote asset for the generated order symbols."""
        values = {a: holdings.get(a, 0.0) * prices[a] for a in targets}
        total = sum(values.values())
        if total <= 0:
            return []
        orders = []
        for asset, target_w in targets.items():
            current_w = values[asset] / total
            drift = (current_w - target_w) * 100.0
            if abs(drift) >= threshold_pct:
                delta_value = (target_w - current_w) * total
                orders.append({
                    "symbol": f"{asset}{quote}",
                    "side": "BUY" if delta_value > 0 else "SELL",
                    "quantity": abs(delta_value) / prices[asset],
                })
        return orders
