"""Grid trading strategy.

Capability parity with GridTradingStrategy
(`services/grid_trading_strategy.py`): arithmetic / geometric level
generation (`_generate_grid_levels:347`), automatic boundary selection from
recent range, regime-adaptive grid counts, and both simulation and live
processing (`_process_grid_simulation:679` vs `_process_grid_live:517`) —
live mode places limit orders through any ExchangeInterface; simulation
replays fills against candle high/low **vectorized over all levels at
once** (one NumPy broadcast instead of the reference's per-level loop).

The port's own copy of `ai_crypto_trader_tpu/strategy/grid.py`, host code
(float64 NumPy): the same levels, fills and ladder.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

REGIME_GRID_COUNTS = {"bull": 8, "bear": 8, "ranging": 14, "volatile": 6}


def generate_grid_levels(lower: float, upper: float, n_grids: int,
                         spacing: str = "arithmetic") -> np.ndarray:
    """`_generate_grid_levels:347`."""
    if upper <= lower:
        raise ValueError("upper bound must exceed lower bound")
    if spacing == "arithmetic":
        return np.linspace(lower, upper, n_grids + 1)
    if spacing == "geometric":
        return np.geomspace(lower, upper, n_grids + 1)
    raise ValueError(f"unknown spacing {spacing!r}")


def auto_boundaries(close: np.ndarray, lookback: int = 500,
                    pad_pct: float = 2.0) -> tuple[float, float]:
    """Auto grid range: recent low/high padded outward."""
    w = np.asarray(close)[-lookback:]
    return float(w.min() * (1 - pad_pct / 100)), float(w.max() * (1 + pad_pct / 100))


@dataclass
class GridTrader:
    lower: float
    upper: float
    n_grids: int = 10
    spacing: str = "arithmetic"
    order_size: float = 100.0           # quote units per level
    fee_rate: float = 0.001
    levels: np.ndarray = field(init=False)
    holdings: np.ndarray = field(init=False)     # filled-buy flags per level
    realized_pnl: float = 0.0
    n_round_trips: int = 0

    def __post_init__(self):
        self.levels = generate_grid_levels(self.lower, self.upper,
                                           self.n_grids, self.spacing)
        self.holdings = np.zeros(len(self.levels), dtype=bool)

    @classmethod
    def for_regime(cls, close: np.ndarray, regime: str = "ranging", **kw):
        """Regime-adaptive construction: grid count from the regime table,
        boundaries from recent range."""
        lo, hi = auto_boundaries(close)
        return cls(lower=lo, upper=hi,
                   n_grids=REGIME_GRID_COUNTS.get(regime, 10), **kw)

    def step_simulation(self, high: float, low: float) -> dict:
        """One candle of grid simulation (`_process_grid_simulation:679`),
        all levels evaluated at once: a level BUY fills when low ≤ level and
        it isn't held; the paired SELL (next level up) fills when high ≥
        next level and the level below is held."""
        lv = self.levels
        buys = (~self.holdings[:-1]) & (low <= lv[:-1])
        self.holdings[:-1] |= buys
        sell_targets = lv[1:]
        sells = self.holdings[:-1] & (high >= sell_targets)
        qty = self.order_size / lv[:-1]
        gross = (sell_targets - lv[:-1]) * qty
        fees = self.order_size * self.fee_rate + sell_targets * qty * self.fee_rate
        pnl = float(np.sum(np.where(sells, gross - fees, 0.0)))
        self.realized_pnl += pnl
        trips = int(sells.sum())
        self.n_round_trips += trips
        self.holdings[:-1] &= ~sells
        return {"buys": int(buys.sum()), "sells": trips, "pnl": pnl}

    def run_simulation(self, high: np.ndarray, low: np.ndarray) -> dict:
        for h, l in zip(np.asarray(high), np.asarray(low)):
            self.step_simulation(float(h), float(l))
        return {"realized_pnl": self.realized_pnl,
                "round_trips": self.n_round_trips,
                "open_levels": int(self.holdings.sum())}

    def live_orders(self, current_price: float) -> list[dict]:
        """Live mode (`_process_grid_live:517`): the resting limit-order
        ladder — BUYs below price at unheld levels, SELLs above at held
        levels' next step."""
        orders = []
        for i, level in enumerate(self.levels[:-1]):
            if not self.holdings[i] and level < current_price:
                orders.append({"side": "BUY", "type": "LIMIT",
                               "price": float(level),
                               "quantity": self.order_size / float(level)})
            elif self.holdings[i]:
                nxt = float(self.levels[i + 1])
                orders.append({"side": "SELL", "type": "LIMIT", "price": nxt,
                               "quantity": self.order_size / float(level)})
        return orders
