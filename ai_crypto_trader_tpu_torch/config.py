"""Configuration of the port: trading, trailing-stop, social-risk,
Monte-Carlo, GA, strategy-evolution and LLM parameters.

The port's own copies of `ai_crypto_trader_tpu/config.py:29-140` and
`:222-318` (`TradingParams`, `TrailingStopParams`, `SocialRiskParams`,
`MonteCarloParams`, `GAParams`, `EvolutionParams`, `LLMParams` with its
prompt templates), with the same defaults: the port imports nothing of the
JAX package, not even its jax-free modules.
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


@dataclass(frozen=True)
class EvolutionParams:
    """Mirrors `evolution` (config.json:207-294): hybrid GA/RL/LLM dispatch,
    monitoring thresholds, and the 18-dim strategy parameter space ranges
    (strategy_evolution_service.py:98-117)."""

    method: str = "hybrid"  # ga | rl | llm | hybrid
    monitor_frequency_s: float = 3600.0
    min_sharpe: float = 1.2
    max_drawdown: float = 0.15
    min_win_rate: float = 0.52
    min_profit_factor: float = 1.2
    ga: GAParams = field(default_factory=GAParams)


@dataclass(frozen=True)
class LLMParams:
    """LLM client settings and prompts-as-config, mirroring the reference's
    `openai` block (config.json:112-121): model/temperature/max_tokens plus
    the five prompt templates AITrader formats (analysis, explainable
    analysis, risk sizing, market-wide, explainable market-wide —
    `services/ai_trader.py:36-342`).  Templates are re-derived with the same
    placeholder fields and the same required JSON reply contract; missing
    context keys degrade to the raw-JSON context block (the reference wraps
    `.format` in try/except and logs, ai_trader.py:81-85)."""

    model: str = "gpt-4o"
    temperature: float = 0.7
    max_tokens: int = 2000
    base_url: str = "https://api.openai.com/v1"
    api_key_env: str = "OPENAI_API_KEY"   # never the key itself in config
    explainable: bool = True              # prefer explainable_* templates
    analysis_prompt: str = (
        "You are an expert cryptocurrency trading analyst. Evaluate {symbol}.\n"
        "Price ${price:.8f}, 24h volume ${volume:.2f}; change 1m "
        "{price_change_1m:.2f}% / 3m {price_change_3m:.2f}% / 5m "
        "{price_change_5m:.2f}% / 15m {price_change_15m:.2f}%.\n"
        "Indicators: RSI {rsi:.2f}, stochastic %K {stoch:.2f}, MACD "
        "{macd:.8f}, Williams %R {williams_r:.2f}, Bollinger position "
        "{bb_position:.4f}.\nTrend: {trend} (strength {trend_strength:.4f}).\n"
        "Combined indicator read: {combined_summary}\n"
        "Social: volume {social_volume}, engagement {social_engagement}, "
        "contributors {social_contributors}, sentiment {social_sentiment}.\n"
        "Recent news: {recent_news}\nMarket context: {market_context}\n"
        "Weigh price momentum, trend, combined signals, social/news impact, "
        "volume, and risk. Reply with ONLY a JSON object with keys: "
        "decision ('BUY'|'SELL'|'HOLD'), confidence (0-1), reasoning, "
        "risk_level ('LOW'|'MEDIUM'|'HIGH'), key_indicators (list).")
    explainable_analysis_prompt: str = (
        "You are an expert cryptocurrency trading analyst. Evaluate {symbol}.\n"
        "Price ${price:.8f}, 24h volume ${volume:.2f}; change 1m "
        "{price_change_1m:.2f}% / 3m {price_change_3m:.2f}% / 5m "
        "{price_change_5m:.2f}% / 15m {price_change_15m:.2f}%.\n"
        "Indicators: RSI {rsi:.2f}, stochastic %K {stoch:.2f}, MACD "
        "{macd:.8f}, Williams %R {williams_r:.2f}, Bollinger position "
        "{bb_position:.4f}.\nTrend: {trend} (strength {trend_strength:.4f}).\n"
        "Combined indicator read: {combined_summary}\n"
        "Social: volume {social_volume}, engagement {social_engagement}, "
        "contributors {social_contributors}, sentiment {social_sentiment}.\n"
        "Recent news: {recent_news}\nMarket context: {market_context}\n"
        "Weigh price momentum, trend, combined signals, social/news impact, "
        "volume, and risk. Reply with ONLY a JSON object with keys: "
        "decision ('BUY'|'SELL'|'HOLD'), confidence (0-1), reasoning, "
        "risk_level ('LOW'|'MEDIUM'|'HIGH'), key_indicators (list), "
        "explanation (object with summary, technical_factors, social_factors,"
        " news_analysis, key_indicators list, risk_assessment), and "
        "factor_weights (object with technical_indicators {{rsi, macd, "
        "bollinger_bands, price_action, other}}, price_action {{momentum, "
        "volatility, volume}}, social_metrics {{sentiment, volume, "
        "engagement}}, news_analysis {{sentiment, relevance, recency}}, "
        "market_context — every weight in 0-1).")
    risk_prompt: str = (
        "Size a {symbol} position. Available capital ${capital:.2f}, "
        "volatility {volatility:.2f}, price ${price:.8f}, trend strength "
        "{trend_strength:.4f}.\nReply with ONLY a JSON object with keys: "
        "position_size (decimal 0-1 of capital), stop_loss_pct, "
        "take_profit_pct, reasoning.")
    market_prompt: str = (
        "Assess overall cryptocurrency market conditions from this data:\n"
        "{market_data}\nReply with ONLY a JSON object with keys: "
        "market_sentiment ('BULLISH'|'BEARISH'|'NEUTRAL'), "
        "top_opportunities (list of symbols), risks (list), reasoning.")
    explainable_market_prompt: str = (
        "Assess overall cryptocurrency market conditions from this data:\n"
        "{market_data}\nReply with ONLY a JSON object with keys: "
        "market_sentiment ('BULLISH'|'BEARISH'|'NEUTRAL'), "
        "top_opportunities (list of symbols), risks (list), reasoning, "
        "explanation (object with summary, market_factors, key_trends list, "
        "risk_factors list, sentiment_indicators list, "
        "recommendation_rationale), and factor_weights (object with "
        "price_action, technical_indicators, volume_analysis, "
        "social_sentiment, market_trends — every weight in 0-1).")
