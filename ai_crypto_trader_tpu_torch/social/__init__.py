"""Social analytics of the port: the analyzer (normalisation, the anomaly
model, lead/lag correlation, sentiment accuracy, source weights), news
analysis and its service, the point-in-time provider for backtests, the
social monitor service and the social strategy integrator — the JAX
package's `social` exports."""

from ai_crypto_trader_tpu_torch.social.analyzer import (  # noqa: F401
    adaptive_source_weights,
    detect_anomalies,
    fit_anomaly_model,
    lead_lag_correlation,
    normalize_metrics,
    sentiment_accuracy,
)
from ai_crypto_trader_tpu_torch.social.news import (  # noqa: F401
    NewsAnalyzer,
    NewsService,
    deterministic_news_provider,
    lexicon_sentiment,
)
from ai_crypto_trader_tpu_torch.social.service import SocialMonitorService  # noqa: F401
from ai_crypto_trader_tpu_torch.social.provider import (  # noqa: F401
    SocialDataProvider,
    asof_indices,
    resample_ffill,
)
from ai_crypto_trader_tpu_torch.social.strategy_integrator import (  # noqa: F401
    SOCIAL_STRATEGY_TEMPLATES,
    SocialStrategyIntegrator,
    analyze_social_impact,
    generate_social_strategy,
)
