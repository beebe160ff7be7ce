"""Social analytics of the port: the analyzer (normalisation, the anomaly
model, lead/lag correlation, sentiment accuracy, source weights).  The JAX
package's `news`, `provider`, `service` and `strategy_integrator` are not
ported yet (ROADMAP item 16)."""

from ai_crypto_trader_tpu_torch.social.analyzer import (  # noqa: F401
    adaptive_source_weights,
    detect_anomalies,
    fit_anomaly_model,
    lead_lag_correlation,
    normalize_metrics,
    sentiment_accuracy,
)
