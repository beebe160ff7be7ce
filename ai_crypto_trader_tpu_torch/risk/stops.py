"""Stop-loss machinery: the adaptive stop and the four trailing-stop
strategies.

Port of `ai_crypto_trader_tpu/risk/stops.py`: the reference's
PortfolioRiskService.calculate_adaptive_stop_loss (a volatility-scaled stop
percentage) and TrailingStopManager (percent_based / atr_based /
volatility_based / fixed_amount trailing, an activation threshold, the
highest price seen, a stop that only moves up).

The trailing stop is a pure state machine ``(state, price) → state'`` of
`torch.where` arithmetic, so one call updates a tensor of positions of any
shape, e.g. every (tenant, symbol) position of the tenant engine.  The
JAX functions take their numeric knobs as traced float32 arguments, so a
knob's own arithmetic (``trail_percent / 100``) is float32 there: the port
does it in NumPy float32 on the host and hands the exact value to torch.
Time-based throttling is the executor's concern, not this module's.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ai_crypto_trader_tpu_torch.device import (
    div_const,
    minus_product,
    resolve_device,
    to_device,
)

STRATEGIES = ("percent_based", "atr_based", "volatility_based", "fixed_amount")

_F = np.float32


def _pct_factor(pct) -> float:
    """``1 − pct/100`` in float32, as the JAX program computes it from a
    float32 argument (the division by the constant as a reciprocal
    multiply)."""
    return float(_F(1.0) - _F(pct) * _F(1.0 / 100.0))


def adaptive_stop_loss(entry_price, annual_volatility, base_stop_pct: float = 2.0,
                       min_factor: float = 0.5, max_factor: float = 2.0,
                       device=None):
    """Volatility-adaptive stop: the factor goes linearly from
    ``min_factor`` to ``max_factor`` as the annualized volatility goes
    from 0 to 50 %.  Returns ``(stop_price, stop_pct)``."""
    dev = resolve_device(device)
    entry = to_device(entry_price, dev, torch.float32)
    vol = to_device(annual_volatility, dev, torch.float32)
    vol_pct = torch.clamp(div_const(vol, 0.5), 0.0, 1.0)
    # min + (max − min)·vol_pct and 1 − stop_pct/100: XLA fuses both into
    # multiply-adds on the CPU
    factor = minus_product(torch.full_like(vol_pct, float(_F(min_factor))), vol_pct,
                           -(_F(max_factor) - _F(min_factor)))
    stop_pct = float(_F(base_stop_pct)) * factor
    keep = minus_product(torch.ones_like(stop_pct), stop_pct, _F(1.0 / 100.0))
    return entry * keep, stop_pct


class TrailingStopState(NamedTuple):
    entry: torch.Tensor
    highest: torch.Tensor
    stop: torch.Tensor
    activation_price: torch.Tensor
    activated: torch.Tensor       # bool
    n_adjustments: torch.Tensor   # int32


def trailing_stop_init(entry_price, initial_stop,
                       activation_threshold_pct: float = 1.0,
                       device=None) -> TrailingStopState:
    """Register a trailing stop (the reference's register_trailing_stop).
    ``activated`` and ``n_adjustments`` start as scalars and broadcast to
    the positions' shape on the first update, as in the JAX package."""
    dev = resolve_device(device)
    entry = to_device(entry_price, dev, torch.float32)
    return TrailingStopState(
        entry=entry,
        highest=entry,
        stop=to_device(initial_stop, dev, torch.float32),
        activation_price=entry * (1.0 + activation_threshold_pct / 100.0),
        activated=torch.zeros((), dtype=torch.bool, device=dev),
        n_adjustments=torch.zeros((), dtype=torch.int32, device=dev),
    )


def trailing_stop_update(state: TrailingStopState, price, *,
                         strategy: str = "percent_based",
                         trail_percent: float = 0.8,
                         min_trail_distance_pct: float = 0.5,
                         atr=0.0, atr_multiplier: float = 2.0,
                         volatility=0.0, volatility_multiplier: float = 1.5,
                         fixed_trail_amount: float = 5.0,
                         min_adjustment_pct: float = 0.2,
                         device=None):
    """One price update (the reference's update_price +
    _adjust_trailing_stop).  Returns ``(state', triggered)``, triggered =
    the price fell to or below the active stop.  The stop only ratchets
    up, and only while activated and on a new high."""
    dev = resolve_device(device)
    state = TrailingStopState(*(to_device(x, dev) for x in state))
    price = to_device(price, dev, torch.float32)
    new_high = price > state.highest
    highest = torch.maximum(state.highest, price)
    activated = state.activated | (price >= state.activation_price)

    if strategy == "percent_based":
        cand = highest * _pct_factor(trail_percent)
        min_stop = highest * _pct_factor(min_trail_distance_pct)
        cand = torch.minimum(cand, min_stop)
    elif strategy == "atr_based":
        cand = minus_product(highest, to_device(atr, dev, torch.float32),
                             _F(atr_multiplier))
    elif strategy == "volatility_based":
        cand = minus_product(highest, to_device(volatility, dev, torch.float32),
                             _F(volatility_multiplier))
    elif strategy == "fixed_amount":
        step = float(_F(min_adjustment_pct) * _F(1.0 / 100.0))
        trail = torch.clamp_min(highest * step, float(_F(fixed_trail_amount)))
        cand = highest - trail
    else:
        raise ValueError(f"unknown trailing strategy {strategy!r}")

    adjust = activated & new_high & (cand > state.stop)
    stop = torch.where(adjust, cand, state.stop)
    triggered = activated & (price <= stop)
    return TrailingStopState(
        entry=state.entry, highest=highest, stop=stop,
        activation_price=state.activation_price, activated=activated,
        n_adjustments=state.n_adjustments + adjust.to(torch.int32),
    ), triggered
