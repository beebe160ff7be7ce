"""Feature-importance integrator — the consumer side of trade-outcome
importance analysis.

The port's own copy of `ai_crypto_trader_tpu/strategy/integration.py:26-92`
(FeatureImportanceIntegrator, `services/model_integration.py`): loads
importance data produced by the analyzer (`models/trade_importance.py`),
re-weights strategy factor weights from the recommendations (:288,
prioritize ×1.2 / reconsider ×0.8), scores each strategy's *feature
alignment* against the currently-predictive feature groups (the live input
to selection's feature_importance factor,
`strategy_selection_service.py:772-870`), and serves pruned-model
trade-outcome predictions with the reference's response contract
(:220-288) — on the analyzer's device, one read a call.  It plugs into
`shell.analyzer.SignalAnalyzer.outcome_model` as the BUY gate.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ai_crypto_trader_tpu_torch.models.trade_importance import (
    NO_MODEL_PREDICTION,
    TradeOutcomeAnalyzer,
)

PRIORITIZE_BOOST = 1.2      # model_integration.py:310-330
RECONSIDER_DAMP = 0.8


@dataclass
class FeatureImportanceIntegrator:
    analyzer: TradeOutcomeAnalyzer | None = None
    importance_data: dict = field(default_factory=dict)

    def update_from_analyzer(self, analyzer: TradeOutcomeAnalyzer):
        """Adopt a fitted analyzer (the service-push path: the reference
        reads the analyzer's published JSON from Redis)."""
        self.analyzer = analyzer
        self.importance_data = dict(analyzer.importances)

    def update_from_data(self, importance_data: dict):
        """Adopt published importance data without a live model."""
        self.importance_data = dict(importance_data)

    # -- strategy-weight adjustment (model_integration.py:288-350) ----------
    def adjust_strategy_weights(self, weights: dict) -> dict:
        if not self.importance_data:
            return dict(weights)
        rec = self.importance_data.get("recommendations", {})
        out = dict(weights)
        for cat in rec.get("categories_to_prioritize", []):
            if cat in out:
                out[cat] *= PRIORITIZE_BOOST
        for cat in rec.get("categories_to_reconsider", []):
            if cat in out:
                out[cat] *= RECONSIDER_DAMP
        return out

    # -- selection feed ------------------------------------------------------
    def feature_alignment(self, strategy: dict) -> float:
        """How well a strategy's declared feature emphasis lines up with the
        groups that currently predict trade outcomes.

        ``strategy["feature_weights"]`` maps group name → emphasis; the
        score is the importance-weighted share of that emphasis, scaled so
        a strategy concentrated on the single most-important group → 1.0
        and one concentrated on irrelevant groups → 0.0. Neutral 0.5 when
        either side is missing (the reference's default weight,
        `model_integration.py:207`)."""
        groups = self.importance_data.get("groups", {})
        emphasis = strategy.get("feature_weights", {})
        if not groups or not emphasis:
            return 0.5
        total_emph = sum(max(v, 0.0) for v in emphasis.values())
        if total_emph <= 0:
            return 0.5
        top = max(groups.values()) or 1.0
        score = sum((max(v, 0.0) / total_emph) * (groups.get(g, 0.0) / top)
                    for g, v in emphasis.items())
        return float(np.clip(score, 0.0, 1.0))

    def annotate(self, strategies: list[dict]) -> list[dict]:
        """Set each strategy's ``feature_alignment`` for the selector
        (selection.py reads it as the feature_importance factor)."""
        return [{**s, "feature_alignment": self.feature_alignment(s)}
                for s in strategies]

    # -- trade-outcome gate --------------------------------------------------
    def predict_trade_outcome(self, features: dict) -> dict:
        if self.analyzer is None:
            return dict(NO_MODEL_PREDICTION)
        return self.analyzer.predict_trade_outcome(features)
