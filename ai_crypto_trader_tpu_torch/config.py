"""Configuration of the port: one frozen dataclass tree, loaded from JSON
with dotted overrides.

The port's own copy of `ai_crypto_trader_tpu/config.py`: every class with
the same fields and defaults, and `load_config` with the same file shape,
overrides, type checks and errors.  The port imports nothing of the JAX
package, not even its jax-free modules.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Mapping, Sequence

def _freeze(obj):
    if isinstance(obj, dict):
        return {k: _freeze(v) for k, v in obj.items()}
    return obj


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
class RiskParams:
    """Mirrors `risk_management` (config.json:16-111) + PortfolioRiskService."""

    max_portfolio_var: float = 0.05
    confidence_level: float = 0.95
    var_lookback_days: int = 30
    max_portfolio_allocation: float = 0.25
    correlation_threshold: float = 0.7
    min_volatility_factor: float = 0.5
    max_volatility_factor: float = 2.0
    volatility_lookback_days: int = 14
    max_drawdown_limit: float = 0.15
    position_sizing_method: str = "equal_risk"
    adaptive_stop_loss_enabled: bool = True
    trailing_stop: TrailingStopParams = field(default_factory=TrailingStopParams)
    social: SocialRiskParams = field(default_factory=SocialRiskParams)


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
class RLParams:
    """Mirrors DQN budgets (reinforcement_learning.py:33-97)."""

    state_size: int = 10
    action_size: int = 3            # BUY / HOLD / SELL
    hidden_sizes: Sequence[int] = (24, 24)
    gamma: float = 0.95
    epsilon: float = 1.0
    epsilon_min: float = 0.01
    epsilon_decay: float = 0.995
    learning_rate: float = 1e-3
    replay_capacity: int = 10_000
    batch_size: int = 64
    target_sync_every: int = 100
    num_envs: int = 64              # new: vmapped parallel envs


@dataclass(frozen=True)
class NNParams:
    """Mirrors `neural_network` (config.json:403-500)."""

    model_type: str = "lstm"
    sequence_length: int = 60
    lookback_days: int = 60
    epochs: int = 100
    batch_size: int = 32
    units: int = 64
    num_layers: int = 2
    dropout: float = 0.2
    learning_rate: float = 1e-3
    early_stopping_patience: int = 10
    reduce_lr_patience: int = 5
    reduce_lr_factor: float = 0.5
    hpo_trials: int = 20
    prediction_horizons: Sequence[int] = (1, 3, 5)   # multitask heads
    feature_names: Sequence[str] = (
        "close", "volume", "rsi", "macd", "macd_signal", "bb_position",
        "stoch_k", "williams_r", "atr", "ema_12",
    )


@dataclass(frozen=True)
class PatternParams:
    """Mirrors `pattern_recognition` (config.json:501-557)."""

    sequence_length: int = 60
    stride: int = 5
    confidence_threshold: float = 0.5
    signal_strength_threshold: float = 0.3
    model_type: str = "cnn"  # cnn | lstm | cnn_lstm


@dataclass(frozen=True)
class RegimeParams:
    """Mirrors `market_regime` config + MarketRegimeDetector defaults."""

    n_regimes: int = 4
    method: str = "kmeans"  # kmeans | gmm | hmm | rules | hybrid
    lookback: int = 500
    pca_components: int = 5
    kmeans_iters: int = 100
    em_iters: int = 50
    hmm_iters: int = 30


@dataclass(frozen=True)
class MeshParams:
    """Device-mesh / distribution config (new — the reference has no
    multi-device concept; see SURVEY §2.7)."""

    data_axis: str = "data"
    model_axis: str = "model"
    data_parallel: int = -1   # -1 = all devices
    model_parallel: int = 1
    use_distributed_init: bool = False  # torch.distributed for multi-host


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


@dataclass(frozen=True)
class BacktestParams:
    """Backtest engine knobs (backtesting/ in the reference)."""

    initial_balance: float = 10_000.0
    warmup: int = 10
    max_positions: int = 5
    annualization: float = 252.0  # strategy_tester.py:430 uses sqrt(252)
    param_grid_size: int = 1024   # default vmap width for sweeps


@dataclass(frozen=True)
class FrameworkConfig:
    """Root of the config tree."""

    trading: TradingParams = field(default_factory=TradingParams)
    risk: RiskParams = field(default_factory=RiskParams)
    monte_carlo: MonteCarloParams = field(default_factory=MonteCarloParams)
    evolution: EvolutionParams = field(default_factory=EvolutionParams)
    rl: RLParams = field(default_factory=RLParams)
    nn: NNParams = field(default_factory=NNParams)
    patterns: PatternParams = field(default_factory=PatternParams)
    regime: RegimeParams = field(default_factory=RegimeParams)
    mesh: MeshParams = field(default_factory=MeshParams)
    backtest: BacktestParams = field(default_factory=BacktestParams)
    llm: LLMParams = field(default_factory=LLMParams)
    seed: int = 0

    def replace(self, **kw) -> "FrameworkConfig":
        return dataclasses.replace(self, **kw)


def _build(cls, data: Mapping[str, Any]):
    """Recursively build a dataclass from a nested mapping, ignoring unknown
    keys (forward compatibility).  Scalar leaves are type-checked against the
    field default so a mis-typed config.json fails at load time, not as a jit
    trace error deep in the compute path."""
    kwargs = {}
    for key, value in data.items():
        if key not in {f.name for f in dataclasses.fields(cls)}:
            continue
        default = getattr(cls(), key)
        if dataclasses.is_dataclass(type(default)) and isinstance(value, Mapping):
            kwargs[key] = _build(type(default), value)
        else:
            kwargs[key] = _check_leaf(cls.__name__, key, default, _freeze(value))
    return cls(**kwargs)


def _check_leaf(owner: str, key: str, default, value):
    if isinstance(default, bool):
        ok = isinstance(value, bool)
    elif isinstance(default, int):
        ok = isinstance(value, int) and not isinstance(value, bool)
    elif isinstance(default, float):
        ok = isinstance(value, (int, float)) and not isinstance(value, bool)
        value = float(value) if ok else value
    elif isinstance(default, str):
        ok = isinstance(value, str)
    else:
        ok = True  # sequences / mappings: structural, checked by consumers
    if not ok:
        raise TypeError(
            f"config {owner}.{key}: expected {type(default).__name__}, "
            f"got {type(value).__name__} ({value!r})"
        )
    return value


def load_config(path: str | None = None, overrides: Mapping[str, Any] | None = None) -> FrameworkConfig:
    """Load config from a JSON file (same shape as this tree) with optional
    dotted-path overrides, e.g. ``{"trading.stop_loss_pct": 1.5}``."""
    cfg_dict: dict = {}
    if path is not None:
        with open(path) as f:
            cfg_dict = json.load(f)
    cfg = _build(FrameworkConfig, cfg_dict)
    if overrides:
        for dotted, value in overrides.items():
            cfg = _override(cfg, dotted.split("."), value)
    return cfg


def _override(node, parts, value):
    if isinstance(node, Mapping):
        if parts[0] not in node:
            raise KeyError(f"unknown config key {parts[0]!r} in mapping override")
        if len(parts) == 1:
            return {**node, parts[0]: value}
        return {**node, parts[0]: _override(node[parts[0]], parts[1:], value)}
    if len(parts) == 1:
        return dataclasses.replace(node, **{parts[0]: value})
    child = getattr(node, parts[0])
    return dataclasses.replace(node, **{parts[0]: _override(child, parts[1:], value)})
