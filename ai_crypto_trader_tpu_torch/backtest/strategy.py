"""The evolvable strategy-parameter space, in PyTorch.

Port of `ai_crypto_trader_tpu/backtest/strategy.py`: the 18-dimensional
parameter space of the reference's evolution brain as a NamedTuple of
float32 tensors, so a whole population is one StrategyParams with a leading
population axis.  `sample_params` draws uniforms from an explicit
``torch.Generator``; it does not reproduce `jax.random`'s draws (tests hand
the JAX draws over with `convert.params_from_numpy`).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ai_crypto_trader_tpu_torch.device import resolve_device, upload
from ai_crypto_trader_tpu_torch.utils import tracing


class StrategyParams(NamedTuple):
    rsi_period: torch.Tensor
    rsi_overbought: torch.Tensor
    rsi_oversold: torch.Tensor
    macd_fast: torch.Tensor
    macd_slow: torch.Tensor
    macd_signal: torch.Tensor
    bollinger_period: torch.Tensor
    bollinger_std: torch.Tensor
    atr_period: torch.Tensor
    atr_multiplier: torch.Tensor
    ema_short: torch.Tensor
    ema_long: torch.Tensor
    volume_ma_period: torch.Tensor
    social_sentiment_threshold: torch.Tensor
    social_volume_threshold: torch.Tensor
    social_engagement_threshold: torch.Tensor
    stop_loss: torch.Tensor      # percent (1 = 1%)
    take_profit: torch.Tensor    # percent


# (low, high, integer?) per dimension — strategy_evolution_service.py:98-117.
PARAM_RANGES: dict[str, tuple[float, float, bool]] = {
    "rsi_period": (5, 30, True),
    "rsi_overbought": (65, 85, False),
    "rsi_oversold": (15, 35, False),
    "macd_fast": (8, 20, True),
    "macd_slow": (20, 40, True),
    "macd_signal": (5, 15, True),
    "bollinger_period": (10, 30, True),
    "bollinger_std": (1.5, 3.0, False),
    "atr_period": (7, 25, True),
    "atr_multiplier": (1.0, 4.0, False),
    "ema_short": (5, 20, True),
    "ema_long": (20, 100, True),
    "volume_ma_period": (5, 30, True),
    "social_sentiment_threshold": (50, 80, False),
    "social_volume_threshold": (5_000, 50_000, False),
    "social_engagement_threshold": (1_000, 20_000, False),
    "stop_loss": (1.0, 5.0, False),
    "take_profit": (1.0, 10.0, False),
}

N_PARAMS = len(PARAM_RANGES)
_LOWS = np.asarray([r[0] for r in PARAM_RANGES.values()], np.float32)
_HIGHS = np.asarray([r[1] for r in PARAM_RANGES.values()], np.float32)
_IS_INT = np.asarray([r[2] for r in PARAM_RANGES.values()], bool)


@functools.lru_cache(maxsize=None)
def _ranges(device):
    """(lows, highs, is_int) on ``device``, made once per device and
    uploaded from pinned memory without waiting (a blocking copy from the
    host inside the GA's generation loop would wait for the card)."""
    device = torch.device(device)
    return upload(_LOWS, device), upload(_HIGHS, device), upload(_IS_INT, device)


def default_params(batch: tuple[int, ...] = (), device=None) -> StrategyParams:
    """Range midpoints, integer dimensions rounded."""
    dev = resolve_device(device)
    mid = (_LOWS + _HIGHS) / np.float32(2.0)
    mid = np.where(_IS_INT, np.round(mid), mid).astype(np.float32)
    return StrategyParams(*[torch.full(tuple(batch), float(m), dtype=torch.float32,
                                       device=dev) for m in mid])


def sample_params(generator: torch.Generator, n: int, device=None) -> StrategyParams:
    """Uniform population sample within ranges (GA seeding).  The uniforms
    are drawn on the generator's device and moved to ``device``; a
    ``strategy.sample`` span under tracing."""
    with tracing.span("strategy.sample", service="backtest"):
        dev = resolve_device(device)
        u = torch.rand((n, N_PARAMS), generator=generator,
                       device=generator.device).to(dev)
        lows, highs, is_int = _ranges(dev)
        vals = lows + u * (highs - lows)
        vals = torch.where(is_int, torch.round(vals), vals)
        return StrategyParams(*vals.unbind(-1))


def clamp_params(p: StrategyParams) -> StrategyParams:
    """Clamp to ranges + round integer dims."""
    leaves = []
    for i, leaf in enumerate(p):
        v = torch.clamp(leaf, float(_LOWS[i]), float(_HIGHS[i]))
        leaves.append(torch.round(v) if _IS_INT[i] else v)
    return StrategyParams(*leaves)


def stack_params(p: StrategyParams) -> torch.Tensor:
    """[..., N_PARAMS] matrix view (for GA genome ops)."""
    return torch.stack(list(p), dim=-1)


def unstack_params(m: torch.Tensor) -> StrategyParams:
    return StrategyParams(*m.unbind(-1))
