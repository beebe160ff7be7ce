"""Configuration of the port: trading, trailing-stop, social-risk,
Monte-Carlo and GA parameters.

The port's own copies of `ai_crypto_trader_tpu/config.py:29-140`
(`TradingParams`, `TrailingStopParams`, `SocialRiskParams`,
`MonteCarloParams`, `GAParams`), with the same defaults: the port imports
nothing of the JAX package, not even its jax-free modules.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Mapping


@dataclass(frozen=True)
class TradingParams:
    """The reference's config.json `trading_params`."""

    min_volume_usdc: float = 50_000.0
    min_price_change_pct: float = 0.5
    position_size: float = 0.4          # fraction of capital offered to sizer
    max_positions: int = 5
    stop_loss_pct: float = 2.0
    take_profit_pct: float = 4.0
    min_trade_amount: float = 40.0
    ai_analysis_interval: float = 60.0
    ai_confidence_threshold: float = 0.7
    min_signal_strength: float = 70.0
    candle_interval: str = "1m"
    initial_balance: float = 10_000.0
    warmup_candles: int = 10
    fee_rate: float = 0.0               # the reference models zero fees


@dataclass(frozen=True)
class TrailingStopParams:
    """The reference's `risk_management.trailing_stop_settings` and the four
    strategies of its TrailingStopManager."""

    strategy: str = "percent_based"  # percent_based|atr_based|volatility_based|fixed_amount
    activation_threshold_pct: float = 1.0
    trail_percent: float = 0.8
    step_size: float = 0.2
    min_price_movement_pct: float = 0.5
    atr_multiplier: float = 2.0
    atr_min_periods: int = 14
    volatility_multiplier: float = 1.5
    volatility_lookback: int = 20
    fixed_trail_amount: float = 5.0
    min_trail_distance_pct: float = 0.5


@dataclass(frozen=True)
class SocialRiskParams:
    """The reference's `risk_management.social_risk_adjustment`."""

    enabled: bool = True
    position_size_impact: float = 0.3
    stop_loss_impact: float = 0.2
    take_profit_impact: float = 0.4
    correlation_impact: float = 0.25
    sentiment_half_life_hours: float = 6.0
    min_data_quality: float = 0.5
    bullish_threshold: float = 0.65
    bearish_threshold: float = 0.35
    max_adjustment_percent: float = 0.5
    sentiment_weights: Mapping[str, float] = field(
        default_factory=lambda: {
            "twitter_sentiment": 0.35,
            "reddit_sentiment": 0.30,
            "news_sentiment": 0.25,
            "overall_sentiment": 0.10,
        }
    )


@dataclass(frozen=True)
class MonteCarloParams:
    """The reference's monte_carlo config: 1 000 paths × a 30-day horizon,
    five scenarios scaling drift and volatility."""

    num_simulations: int = 1_000
    horizon_days: int = 30
    confidence_level: float = 0.95
    method: str = "gbm"  # gbm | bootstrap
    # scenario -> (drift multiplier, vol multiplier)
    scenarios: Mapping[str, tuple] = field(
        default_factory=lambda: {
            "base": (1.0, 1.0),
            "bull": (1.5, 0.8),
            "bear": (-1.0, 1.3),
            "volatile": (1.0, 2.0),
            "crab": (0.2, 0.6),
        }
    )


@dataclass(frozen=True)
class GAParams:
    """GA budgets (the reference's strategy_evolution_service.py:78-79,
    config:213)."""

    population_size: int = 20
    generations: int = 10
    elite_size: int = 2
    tournament_size: int = 3
    crossover_rate: float = 0.7
    mutation_rate: float = 0.2
    mutation_scale: float = 0.2  # fraction of range
