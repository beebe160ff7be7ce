"""The port's feature-importance integrator (strategy/integration.py)
against the JAX package's, on the CPU.

On the same `importance_data`: `adjust_strategy_weights`,
`feature_alignment`, `annotate` and the no-model prediction equal JAX's.
As `SignalAnalyzer.outcome_model`, the port's integrator decides the
port's BUY gate as JAX's integrator decides JAX's: with one injected
outcome model on both sides the published signals are equal; with each
side's own fitted analyzer (the port's forest, scikit-learn's) the
decisions are equal on updates away from the driver's boundary.
"""

import asyncio

import numpy as np
import pytest

from ai_crypto_trader_tpu.shell.analyzer import SignalAnalyzer as JAnalyzer
from ai_crypto_trader_tpu.shell.bus import EventBus as JBus
from ai_crypto_trader_tpu.strategy import integration as ji
from ai_crypto_trader_tpu_torch.models import trade_importance as tti
from ai_crypto_trader_tpu_torch.shell.analyzer import SignalAnalyzer as TAnalyzer
from ai_crypto_trader_tpu_torch.shell.bus import EventBus as TBus
from ai_crypto_trader_tpu_torch.strategy import integration as ti

IMPORTANCE = {
    "groups": {"momentum": 0.55, "social": 0.3, "volatility": 0.1, "trend": 0.05},
    "recommendations": {"categories_to_prioritize": ["momentum", "missing_cat"],
                        "categories_to_reconsider": ["trend", "volatility"]},
}
STRATEGIES = [
    {"id": "momo", "feature_weights": {"momentum": 1.0}},
    {"id": "mixed", "feature_weights": {"momentum": 0.5, "social": 2.0, "trend": -1.0}},
    {"id": "nothing", "feature_weights": {"trend": 0.0}},
    {"id": "unknown", "feature_weights": {"sentiment_x": 3.0}},
    {"id": "bare"},
]


@pytest.mark.parametrize("data", [IMPORTANCE, {}, {"groups": {"momentum": 0.0}},
                                  {"recommendations": {"categories_to_reconsider": ["a"]}}])
def test_weights_alignment_annotate_match(data):
    j, t = ji.FeatureImportanceIntegrator(), ti.FeatureImportanceIntegrator()
    j.update_from_data(data)
    t.update_from_data(data)
    weights = {"momentum": 0.5, "trend": 0.25, "volatility": 0.4, "a": 1.0}
    assert t.adjust_strategy_weights(weights) == j.adjust_strategy_weights(weights)
    for s in STRATEGIES:
        assert t.feature_alignment(s) == j.feature_alignment(s)
    assert t.annotate(STRATEGIES) == j.annotate(STRATEGIES)
    assert (ti.PRIORITIZE_BOOST, ti.RECONSIDER_DAMP) == (ji.PRIORITIZE_BOOST, ji.RECONSIDER_DAMP)


def test_no_model_prediction_matches():
    assert ti.FeatureImportanceIntegrator().predict_trade_outcome({"rsi": 50}) == \
        ji.FeatureImportanceIntegrator().predict_trade_outcome({"rsi": 50})
    t = ti.FeatureImportanceIntegrator()
    t.update_from_data(IMPORTANCE)                   # data, no live model
    assert t.predict_trade_outcome({}) == tti.NO_MODEL_PREDICTION


class AlwaysBuy:
    async def analyze_trade_opportunity(self, ctx):
        return {"decision": "BUY", "confidence": 0.9, "reasoning": "r"}


class Scripted:
    """An outcome model that answers from the update's rsi."""

    def predict_trade_outcome(self, features):
        p = features.get("rsi", 50.0) / 100.0
        return {"success_probability": p, "win_probability": p,
                "confidence": abs(p - 0.5) * 2, "status": "success",
                "prediction": "win" if p >= 0.5 else "loss"}


UPDATES = [{"symbol": f"S{i}", "current_price": 1.0 + i, "rsi": r,
            "social": {"social_sentiment": s}}
           for i, (r, s) in enumerate([(15.0, 0.2), (85.0, 0.9), (44.0, 0.5), (46.0, 0.1),
                                       (70.0, 0.7), (25.0, 0.4), (90.0, 0.05)])]


def _gate(analyzer_cls, bus_cls, model):
    a = analyzer_cls(bus_cls(), trader=AlwaysBuy(), outcome_model=model,
                     min_success_probability=0.45, now_fn=lambda: 1_000.0)
    return [asyncio.run(a.handle_update(dict(u))) for u in UPDATES]


def test_gate_with_one_outcome_model_matches():
    got, ref = _gate(TAnalyzer, TBus, Scripted()), _gate(JAnalyzer, JBus, Scripted())
    assert got == ref
    assert [s["decision"] for s in got].count("HOLD") == 3


def test_gate_with_each_sides_fitted_integrator():
    pytest.importorskip("sklearn")
    from ai_crypto_trader_tpu.models.trade_importance import TradeOutcomeAnalyzer as JAz

    rng = np.random.default_rng(11)
    trades = []
    for _ in range(240):
        feats = {"rsi": rng.uniform(10, 90), "macd": rng.normal(0, 1),
                 "social_sentiment": rng.uniform(0, 1), "volatility": rng.uniform(0.001, 0.05)}
        trades.append({"features": feats,
                       "pnl": (1.0 if feats["rsi"] > 50 else -1.0) + rng.normal(0, 0.01)})
    sides = []
    for az, integ in ((JAz(n_trees=30, n_permutation_repeats=5), ji.FeatureImportanceIntegrator()),
                      (tti.TradeOutcomeAnalyzer(n_trees=30, n_permutation_repeats=5,
                                                device="cpu"),
                       ti.FeatureImportanceIntegrator())):
        az.fit(trades)
        integ.update_from_analyzer(az)
        sides.append(integ)
    away = [u for u in UPDATES if abs(u["rsi"] - 50.0) > 15.0]
    decided = []
    for cls, bus, integ in ((JAnalyzer, JBus, sides[0]), (TAnalyzer, TBus, sides[1])):
        a = cls(bus(), trader=AlwaysBuy(), outcome_model=integ, min_success_probability=0.45,
                now_fn=lambda: 1_000.0)
        decided.append([asyncio.run(a.handle_update(dict(u)))["decision"] for u in away])
    assert decided[1] == decided[0]
    assert set(decided[1]) == {"BUY", "HOLD"}
    assert sides[1].importance_data["recommendations"] == \
        sides[0].importance_data["recommendations"]
