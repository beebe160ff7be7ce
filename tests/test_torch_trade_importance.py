"""The port's trade-outcome analyzer (models/trade_importance.py) and its
own random forest, on the CPU, against scikit-learn and the JAX package.

  * One tree without bootstrap over every feature is scikit-learn's
    `DecisionTreeClassifier` on untied continuous data (no two splits of
    a node equally good): the same predictions on fresh rows, a tenth of
    their values NaN, exactly, and MDI within 1e-9.
  * `_permutation_importance` — one batched prediction over all F × R
    shuffled copies — equals the JAX package's loop (571 `predict` calls at
    the defaults) run on the port's fitted model through an adapter that
    exposes `.predict`, exactly.
  * `_group_importance`, the recommendations and the prune rule equal
    JAX's on an injected `combined` dict (both forests stubbed).
  * The whole analyzer against JAX's (scikit-learn's forest) on
    `make_trades`-style data with the driver `rsi` and `social_sentiment`:
    the same top feature, prioritize/reconsider lists and kept features,
    held-out predictions agreeing on at least 95 %.
"""

import numpy as np
import pytest
import torch

from ai_crypto_trader_tpu_torch.models import trade_importance as tti

sklearn = pytest.importorskip("sklearn")
from sklearn.tree import DecisionTreeClassifier  # noqa: E402

from ai_crypto_trader_tpu.models import trade_importance as jti  # noqa: E402


def make_trades(rng, n=200, driver="rsi"):
    """tests/test_integration_importance.py's synthetic trade outcomes:
    `driver` decides win or loss."""
    trades = []
    for _ in range(n):
        feats = {
            "rsi": rng.uniform(10, 90),
            "macd": rng.normal(0, 1),
            "social_sentiment": rng.uniform(0, 1),
            "social_volume": rng.uniform(0, 1e4),
            "volatility": rng.uniform(0.001, 0.05),
        }
        pnl = 1.0 if feats[driver] > np.median([10, 90]) else -1.0
        if driver == "social_sentiment":
            pnl = 1.0 if feats[driver] > 0.5 else -1.0
        trades.append({"features": feats, "pnl": pnl + rng.normal(0, 0.01)})
    return trades


def _boxes(rng, n, F):
    """Untied continuous rows whose class is a few axis-aligned boxes, with
    a margin of 0.02 around every box edge.  Where two splits are equally
    good (two rows of two classes that any feature separates), each library
    takes the first feature of its own random feature order; the margin
    keeps every node of the grown tree away from such ties."""
    X = rng.uniform(0, 1, (n, F))
    edges = [(0, 0.3), (min(1, F - 1), 0.6)] + ([(2, 0.8)] if F >= 3 else [])
    X = X[np.all([np.abs(X[:, f] - e) > 0.02 for f, e in edges], axis=0)]
    y = ((X[:, 0] > 0.3) & (X[:, min(1, F - 1)] < 0.6)).astype(int)
    if F >= 3:
        y ^= (X[:, 2] > 0.8).astype(int)
    return X, y


@pytest.mark.parametrize("F,seed", [(1, 0), (3, 1), (6, 2), (6, 3)])
def test_one_tree_is_sklearns_tree(F, seed):
    rng = np.random.default_rng(seed)
    X, y = _boxes(rng, 500, F)
    ref = DecisionTreeClassifier(random_state=0).fit(X, y)
    got = tti.RandomForestClassifier(1, 0, bootstrap=False, max_features=None,
                                     device="cpu").fit(X, y)
    assert len(got.trees[0]["feature"]) == ref.tree_.node_count
    Xt = rng.uniform(0, 1, (4000, F))
    Xt[rng.uniform(size=Xt.shape) < 0.1] = np.nan     # routed as scikit-learn routes NaN
    np.testing.assert_array_equal(got.predict(Xt), ref.predict(Xt))
    np.testing.assert_array_equal(got.predict(X), y)
    np.testing.assert_allclose(got.feature_importances_, ref.feature_importances_,
                               rtol=0, atol=1e-9)
    np.testing.assert_array_equal(got.classes_, ref.classes_)


def test_forest_follows_sklearns_defaults():
    rng = np.random.default_rng(7)
    X = rng.normal(size=(300, 9))
    y = (X[:, 2] - X[:, 5] > 0).astype(int)
    rf = tti.RandomForestClassifier(n_estimators=20, random_state=4, device="cpu").fit(X, y)
    again = tti.RandomForestClassifier(n_estimators=20, random_state=4, device="cpu").fit(X, y)
    proba = rf.predict_proba(X)
    assert proba.shape == (300, 2) and proba.dtype == np.float64
    np.testing.assert_allclose(proba.sum(1), 1.0)
    np.testing.assert_array_equal(rf.predict(X), rf.classes_[proba.argmax(1)])
    np.testing.assert_array_equal(proba, again.predict_proba(X))    # seeded
    assert abs(rf.feature_importances_.sum() - 1.0) < 1e-12
    assert set(np.argsort(rf.feature_importances_)[-2:]) == {2, 5}
    for t in rf.trees:                                  # fully grown: pure leaves
        leaves = t["left"] < 0
        assert np.all(t["value"][leaves].max(1) == 1.0)
    assert rf.to("cpu").predict_proba(X).tolist() == proba.tolist()


def test_cpu_row_blocks_give_the_same_bits(monkeypatch):
    """The CPU walks its rows a block at a time; any block size gives the
    bits of one batch (the card's single walk)."""
    rng = np.random.default_rng(8)
    X = rng.normal(size=(200, 6))
    y = (X[:, 0] > 0.1).astype(int)
    rf = tti.RandomForestClassifier(n_estimators=12, random_state=1, device="cpu").fit(X, y)
    Xt = rng.normal(size=(1000, 6))
    whole = rf.predict_proba(Xt)
    monkeypatch.setattr(tti, "_CPU_BLOCK_ROWS", 7)
    np.testing.assert_array_equal(rf.predict_proba(Xt), whole)
    assert rf.predict_proba(Xt[:0]).shape == (0, 2)


def test_thresholds_hold_float64_comparisons_in_float32():
    t = np.array([0.1, 1 / 3, 2.5, -7.25, np.float32(0.3) / 2 + np.float32(0.31) / 2])
    f = tti._floor_f32(t)
    assert f.dtype == np.float32
    for x in np.float32([0.1, 1 / 3, 2.5, -7.25, 0.3, 0.31, 0.305]):
        for a, b in zip(t, f):
            assert (np.float64(x) <= a) == (x <= b)


class _Adapter:
    """The port's fitted forest behind the `.predict` the JAX loop calls."""

    def __init__(self, rf):
        self.rf = rf
        self.calls = 0

    def predict(self, X):
        self.calls += 1
        return self.rf.predict(X)


@pytest.mark.parametrize("n_trees,repeats,seed", [(15, 5, 0), (10, 3, 9)])
def test_permutation_importance_is_the_reference_loop(rng, n_trees, repeats, seed):
    trades = make_trades(rng, n=160, driver="rsi")
    port = tti.TradeOutcomeAnalyzer(n_trees=n_trees, n_permutation_repeats=repeats,
                                    seed=seed, device="cpu")
    X, y = port._xy(trades)
    rf = tti.RandomForestClassifier(n_trees, seed, device="cpu").fit(X, y)
    got = port._permutation_importance(rf, X, y)
    ref_az = jti.TradeOutcomeAnalyzer(n_trees=n_trees, n_permutation_repeats=repeats,
                                      seed=seed, feature_names=list(port.feature_names))
    adapter = _Adapter(rf)
    ref = ref_az._permutation_importance(adapter, X, y)
    assert adapter.calls == 1 + len(port.feature_names) * repeats
    assert list(got) == list(ref)
    assert got == ref                     # exactly: same draws, same counts
    assert got["rsi"] > 0.1


class _StubForest:
    """A forest whose MDI is injected; it records the columns it saw."""

    builtin: dict = {}

    def __init__(self, n_estimators=100, random_state=0, device=None):
        self.classes_ = np.array([0, 1])

    def fit(self, X, y):
        self.n_columns = X.shape[1]
        names = sorted(self.builtin)
        self.feature_importances_ = np.array([self.builtin[f] for f in names][:X.shape[1]])
        return self


_COMBINED_CASES = {
    "one_dominant": {"rsi": 0.8, "macd": 0.1, "volume": 0.05, "social_volume": 0.05},
    "even": {"rsi": 0.25, "atr": 0.25, "volume": 0.25, "social_sentiment": 0.25},
    "near_prune": {"rsi": 0.4, "macd": 0.1, "sma_20": 0.0999, "bb_width": 0.35,
                   "not_in_a_group": 0.2},
    "many_groups": {f: (i % 5 + 1) / 10.0 for i, f in enumerate(
        sorted({m for ms in tti.FEATURE_GROUPS.values() for m in ms}))},
}


@pytest.mark.parametrize("case", sorted(_COMBINED_CASES))
def test_groups_recommendations_and_pruning_follow_jax(monkeypatch, case):
    """Both analyzers' forests stubbed and their permutation importance
    injected, so `combined` is the same dict on both sides."""
    import sklearn.ensemble

    combined = _COMBINED_CASES[case]
    names = sorted(combined)
    builtin = {f: 2 * v * 0.75 for f, v in combined.items()}    # 0.5·b + 0.5·p = v
    perm = {f: 2 * v * 0.25 for f, v in combined.items()}
    _StubForest.builtin = builtin
    monkeypatch.setattr(sklearn.ensemble, "RandomForestClassifier", _StubForest)
    monkeypatch.setattr(tti, "RandomForestClassifier", _StubForest)
    trades = [{"features": {f: float(i + j) for j, f in enumerate(names)}, "pnl": (-1) ** i}
              for i in range(6)]
    out = []
    for mod, kw in ((jti, {}), (tti, {"device": "cpu"})):
        az = mod.TradeOutcomeAnalyzer(**kw)
        monkeypatch.setattr(az, "_permutation_importance", lambda m, X, y: dict(perm))
        imp = az.fit(trades)
        out.append((imp, az.kept_features, az.pruned_model.n_columns,
                    az._group_importance(combined)))
    (ref, ref_kept, ref_cols, ref_groups), (got, got_kept, got_cols, got_groups) = out
    assert got == ref and got_kept == ref_kept and got_cols == ref_cols
    assert got_groups == ref_groups == ref["groups"]


@pytest.mark.parametrize("driver", ["rsi", "social_sentiment"])
def test_whole_analyzer_follows_jax(driver):
    rng = np.random.default_rng(1234)
    trades = make_trades(rng, n=300, driver=driver)
    held = make_trades(rng, n=200, driver=driver)
    ref = jti.TradeOutcomeAnalyzer(n_trees=30, n_permutation_repeats=5)
    got = tti.TradeOutcomeAnalyzer(n_trees=30, n_permutation_repeats=5, device="cpu")
    ri, gi = ref.fit(trades), got.fit(trades)
    top = max(gi["combined"], key=gi["combined"].get)
    assert top == max(ri["combined"], key=ri["combined"].get) == driver
    assert gi["recommendations"] == ri["recommendations"]
    assert got.kept_features == ref.kept_features
    preds = [(g["prediction"], r["prediction"]) for g, r in (
        (got.predict_trade_outcome(t["features"]), ref.predict_trade_outcome(t["features"]))
        for t in held)]
    agree = np.mean([g == r for g, r in preds])
    assert agree >= 0.95
    truth = np.mean([g == ("win" if t["pnl"] > 0 else "loss")
                     for (g, _), t in zip(preds, held)])
    assert truth >= 0.95


def test_predict_trade_outcome_contract():
    az = tti.TradeOutcomeAnalyzer(device="cpu")
    assert az.predict_trade_outcome({"rsi": 50.0}) == tti.NO_MODEL_PREDICTION
    assert tti.NO_MODEL_PREDICTION == jti.NO_MODEL_PREDICTION
    assert tti.FEATURE_GROUPS == jti.FEATURE_GROUPS
    az = tti.TradeOutcomeAnalyzer(n_trees=10, n_permutation_repeats=2, device="cpu")
    az.fit(make_trades(np.random.default_rng(5), n=120))
    hi, lo = az.predict_trade_outcome({"rsi": 85.0}), az.predict_trade_outcome({"rsi": 15.0})
    assert hi["status"] == "success" and hi["prediction"] == "win" and lo["prediction"] == "loss"
    assert hi["success_probability"] == hi["win_probability"] > 0.5 > lo["success_probability"]
    assert hi["confidence"] == pytest.approx(abs(hi["success_probability"] - 0.5) * 2)
    with pytest.raises(ValueError, match="both winning and losing"):
        tti.TradeOutcomeAnalyzer(device="cpu").fit(
            [{"features": {"rsi": 1.0}, "pnl": 1.0}] * 3)
    assert isinstance(az.pruned_model._tensors["threshold"], torch.Tensor)
