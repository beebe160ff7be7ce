"""Trade-outcome feature importance: a random forest + permutation
importance + a pruned model.

The port's own copy of `ai_crypto_trader_tpu/models/trade_importance.py`
(FeatureImportanceAnalyzer / FeatureImportanceService, `services/
feature_importance_analyzer.py`, `services/feature_importance_service.py`,
`services/model_integration.py`):
  * a random forest (100 trees) trained on trade outcomes (win/loss) from
    per-trade feature snapshots;
  * permutation importance (n_repeats=30);
  * feature groups (price action / momentum / volatility / trend / volume /
    social) with per-group aggregation;
  * pruning features below a relative-importance threshold (25 %) into an
    "optimized model" retrained on the surviving features;
  * `predict_trade_outcome` with the pruned model.
The consumer side lives in `strategy/integration.py`.

The JAX package fits scikit-learn's `RandomForestClassifier`; the port has
its own (`RandomForestClassifier` below), so that nothing here needs
scikit-learn.  It follows the semantics of scikit-learn's defaults: Gini
splits, bootstrap draws as per-sample counts, √F candidate features a node,
no depth limit, `min_samples_split=2`, X in float32 with thresholds at
midpoints, MDI importances, `predict_proba` as the mean of the leaves'
class fractions.  The fit runs on the host in NumPy (an offline, low-rate
component, SURVEY §7.4); the trees then go to the device once, padded to
[n_trees, max_nodes] tensors, and every prediction walks all trees for a
whole batch of rows at once — a loop over the depth of gathers, one read
at the end.  Permutation importance builds all F × R permuted copies of X
and runs them through ONE such prediction (one read), with the
permutations drawn in the reference loop's order, so its result equals the
reference loop's exactly for the same model.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ai_crypto_trader_tpu_torch.device import resolve_device

# The reference integrator's no-model response (`model_integration.py:230`),
# shared with strategy.integration so the two paths cannot drift.
NO_MODEL_PREDICTION = {
    "success_probability": 0.5, "win_probability": 0.5,
    "confidence": 0.0, "status": "no_model", "prediction": "unknown",
}

FEATURE_GROUPS = {
    "price_action": ("price_change_1m", "price_change_5m", "price_change_15m",
                     "bb_position"),
    "momentum": ("rsi", "stoch_k", "williams_r", "macd"),
    "volatility": ("volatility", "atr", "bb_width"),
    "trend": ("trend_strength", "ema_12", "sma_20"),
    "volume": ("avg_volume", "volume"),
    "social": ("social_sentiment", "social_volume", "social_engagement"),
}

# scikit-learn's splitter constants: feature values closer than this are one
# value, and a node whose impurity is within EPSILON of 0 is pure
_FEATURE_THRESHOLD = 1e-7
_EPSILON = float(np.finfo(np.float64).eps)


def _gini(counts: np.ndarray, w: np.ndarray) -> np.ndarray:
    """Gini impurity from class weights ``counts`` [..., C] and their total
    ``w`` [...], in scikit-learn's order of operations."""
    sq = np.zeros_like(w)
    for k in range(counts.shape[-1]):
        sq = sq + counts[..., k] * counts[..., k]
    return 1.0 - sq / (w * w)


def _build_tree(X: np.ndarray, onehot_w: np.ndarray, max_features: int,
                rng: np.random.Generator) -> dict:
    """One fully grown CART classification tree (depth first, left child
    first) over the samples whose weight is not 0.  ``onehot_w`` [n, C]
    holds each sample's weight in its class's column."""
    n_features = X.shape[1]
    feature, threshold, left, right, value, impurity, weighted, depth, size = \
        [], [], [], [], [], [], [], [], []

    def new_node(idx, counts, d):
        w = float(counts.sum())
        feature.append(-1)
        threshold.append(np.inf)
        left.append(-1)
        right.append(-1)
        value.append(counts / w)
        impurity.append(float(_gini(counts, np.float64(w))))
        weighted.append(w)
        depth.append(d)
        size.append(len(idx))
        return len(feature) - 1

    root = np.flatnonzero(onehot_w.sum(1) > 0)
    stack = [(root, new_node(root, onehot_w[root].sum(0), 0))]
    while stack:
        idx, node = stack.pop()
        if len(idx) < 2 or impurity[node] <= _EPSILON:
            continue
        best = _best_split(X, onehot_w, idx, weighted[node], max_features, n_features, rng)
        if best is None:
            continue
        f, thr = best
        go_left = X[idx, f].astype(np.float64) <= thr
        li, ri = idx[go_left], idx[~go_left]
        feature[node], threshold[node] = f, thr
        left[node] = new_node(li, onehot_w[li].sum(0), depth[node] + 1)
        right[node] = new_node(ri, onehot_w[ri].sum(0), depth[node] + 1)
        stack.append((ri, right[node]))
        stack.append((li, left[node]))
    return {"feature": np.asarray(feature, np.int64),
            "threshold": np.asarray(threshold, np.float64),
            "left": np.asarray(left, np.int64), "right": np.asarray(right, np.int64),
            "value": np.asarray(value, np.float64),
            "impurity": np.asarray(impurity, np.float64),
            "weighted_n_node_samples": np.asarray(weighted, np.float64),
            "n_node_samples": np.asarray(size, np.int64),
            "max_depth": int(max(depth))}


def _best_split(X, onehot_w, idx, w_node, max_features, n_features, rng):
    """The best Gini split of a node: features visited in a random order,
    at least ``max_features`` of them and at least one that is not constant
    at the node (scikit-learn's rule); each at every midpoint between two
    distinct sorted values; the first strict maximum of scikit-learn's
    proxy improvement wins.  Returns (feature, threshold) or None."""
    order_f = rng.permutation(n_features)
    visited = 0
    while visited < n_features:
        # the first batch is max_features features; past it, one at a time
        # while every visited feature has been constant
        take = max_features if visited == 0 else 1
        feats = order_f[visited:visited + take]
        visited += len(feats)
        xn = X[idx][:, feats]                                   # [n, k] float32
        order = np.argsort(xn, axis=0, kind="stable")
        xs = np.take_along_axis(xn, order, 0).astype(np.float64)
        counts = np.cumsum(onehot_w[idx][order], axis=0)[:-1]  # [n-1, k, C] left
        wl = counts.sum(-1)
        wr = w_node - wl
        total = onehot_w[idx].sum(0)
        with np.errstate(divide="ignore", invalid="ignore"):
            proxy = -wr * _gini(total - counts, wr) - wl * _gini(counts, wl)
        valid = xs[1:] > xs[:-1] + _FEATURE_THRESHOLD
        proxy = np.where(valid, proxy, -np.inf)               # [n-1, k]
        if (xs[-1] > xs[0] + _FEATURE_THRESHOLD).any():       # a feature not constant here
            flat = proxy.T.reshape(-1)                          # visiting order, then position
            j = int(np.argmax(flat))
            if flat[j] == -np.inf:                              # no two values far enough apart
                return None
            k, p = divmod(j, proxy.shape[0])
            lo, hi = xs[p, k], xs[p + 1, k]
            thr = lo / 2.0 + hi / 2.0
            if thr == hi or not np.isfinite(thr):
                thr = lo
            return int(feats[k]), float(thr)
    return None


# rows a block of the CPU's walk: [100 trees, 8,192 rows] of int64 nodes is
# 6.6 MB, within a core's share of the last-level cache
_CPU_BLOCK_ROWS = 8192


def _floor_f32(t: np.ndarray) -> np.ndarray:
    """The largest float32 ≤ each float64 threshold: for a float32 x,
    ``x <= t`` exactly when ``x <= _floor_f32(t)``."""
    f = t.astype(np.float32)
    over = f.astype(np.float64) > t
    f[over] = np.nextafter(f[over], np.float32(-np.inf))
    return f


class RandomForestClassifier:
    """A random forest of Gini trees with scikit-learn's defaults
    (``n_estimators`` trees, bootstrap, √F features a node, fully grown;
    ``bootstrap=False, max_features=None`` grow scikit-learn's single
    `DecisionTreeClassifier`).
    Draws come from ``numpy.random.default_rng(random_state)``: each tree's
    bootstrap counts, then its nodes' feature orders.  ``fit`` builds the
    trees on the host and puts them on ``device`` once; ``predict_proba`` /
    ``predict`` take host arrays or tensors and return host arrays (one
    read a call); ``proba`` returns the device tensor."""

    def __init__(self, n_estimators: int = 100, random_state: int = 0,
                 bootstrap: bool = True, max_features: str | None = "sqrt",
                 device=None):
        self.n_estimators = n_estimators
        self.random_state = random_state
        self.bootstrap = bootstrap
        self.max_features = max_features
        self.device = resolve_device(device)
        self.trees: list[dict] = []

    # -- fit (host) --------------------------------------------------------
    def fit(self, X, y) -> "RandomForestClassifier":
        X = np.asarray(X, np.float32)
        self.classes_, y_idx = np.unique(np.asarray(y), return_inverse=True)
        n, n_features = X.shape
        self.n_features_in_ = n_features
        max_features = n_features if self.max_features is None \
            else max(1, int(np.sqrt(n_features)))
        onehot = np.eye(len(self.classes_))[y_idx]              # [n, C]
        rng = np.random.default_rng(self.random_state)
        self.trees = []
        for _ in range(self.n_estimators):
            w = (np.bincount(rng.integers(0, n, n), minlength=n).astype(np.float64)
                 if self.bootstrap else np.ones(n))
            self.trees.append(_build_tree(X, onehot * w[:, None], max_features, rng))
        self.feature_importances_ = self._mdi()
        self._pack()
        return self

    def _mdi(self) -> np.ndarray:
        """Each tree's weighted impurity decrease per feature, normalised,
        averaged over the trees that split at all, normalised again."""
        per_tree = []
        for t in self.trees:
            if len(t["feature"]) <= 1:
                continue
            imp = np.zeros(self.n_features_in_)
            wn, im = t["weighted_n_node_samples"], t["impurity"]
            for node in np.flatnonzero(t["left"] >= 0):
                lc, rc = t["left"][node], t["right"][node]
                imp[t["feature"][node]] += (wn[node] * im[node] - wn[lc] * im[lc]
                                            - wn[rc] * im[rc])
            imp /= wn[0]
            s = imp.sum()
            per_tree.append(imp / s if s > 0 else imp)
        if not per_tree:
            return np.zeros(self.n_features_in_)
        mean = np.mean(per_tree, axis=0)
        return mean / mean.sum()

    def _pack(self):
        """The trees as padded [n_trees, max_nodes] tensors on the device.
        A leaf points to itself (left = right = itself, threshold +inf), so
        the walk needs no mask; padding nodes are never reached.  A NaN
        value goes to the child with more samples (to the right on a tie),
        scikit-learn's rule for a tree fitted without missing values."""
        T = len(self.trees)
        m = max(len(t["feature"]) for t in self.trees)
        C = len(self.classes_)
        feat = np.zeros((T, m), np.int64)
        thr = np.full((T, m), np.inf, np.float32)
        lft = np.tile(np.arange(m, dtype=np.int64), (T, 1))
        rgt = lft.copy()
        val = np.zeros((T, m, C), np.float64)
        nan_left = np.zeros((T, m), bool)
        for i, t in enumerate(self.trees):
            k = len(t["feature"])
            split = t["left"] >= 0
            feat[i, :k] = np.where(split, t["feature"], 0)
            thr[i, :k] = np.where(split, _floor_f32(t["threshold"]), np.inf)
            lft[i, :k] = np.where(split, t["left"], np.arange(k))
            rgt[i, :k] = np.where(split, t["right"], np.arange(k))
            val[i, :k] = t["value"]
            sizes = t["n_node_samples"]
            nan_left[i, :k] = split & (sizes[t["left"]] > sizes[t["right"]])
        self.depth = max(t["max_depth"] for t in self.trees)
        self._tensors = {name: torch.from_numpy(a).to(self.device) for name, a in
                         (("feature", feat), ("threshold", thr), ("left", lft),
                          ("right", rgt), ("value", val), ("nan_left", nan_left))}

    def to(self, device) -> "RandomForestClassifier":
        """The same fitted forest on another device."""
        out = RandomForestClassifier.__new__(RandomForestClassifier)
        out.__dict__.update(self.__dict__)
        out.device = resolve_device(device)
        out._tensors = {k: v.to(out.device) for k, v in self._tensors.items()}
        return out

    # -- predict (device) --------------------------------------------------
    def proba(self, X) -> torch.Tensor:
        """Class probabilities [M, C] (float64) of the rows of X [M, F] on
        the forest's device: all trees walk all rows at once, one gather
        step a level.  On the CPU the rows go a block at a time, so that
        the walk's [trees, rows] state stays in cache; a row's walk and
        sum do not depend on its block, so the bits are the same."""
        x = torch.as_tensor(X).to(self.device, torch.float32)
        step = max(x.shape[0], 1) if self.device.type == "cuda" else _CPU_BLOCK_ROWS
        return torch.cat([self._walk(x[i:i + step])
                          for i in range(0, max(x.shape[0], 1), step)])

    def _walk(self, x: torch.Tensor) -> torch.Tensor:
        t = self._tensors
        xt = x.T.contiguous()                                   # [F, M]
        node = torch.zeros((len(self.trees), x.shape[0]), dtype=torch.int64,
                           device=self.device)
        for _ in range(self.depth):
            v = xt.gather(0, t["feature"].gather(1, node))
            go_left = torch.where(torch.isnan(v), t["nan_left"].gather(1, node),
                                  v <= t["threshold"].gather(1, node))
            node = torch.where(go_left, t["left"].gather(1, node), t["right"].gather(1, node))
        C = t["value"].shape[-1]
        leaf = t["value"].gather(1, node.unsqueeze(-1).expand(-1, -1, C))
        return leaf.sum(0) / len(self.trees)

    def predict_proba(self, X) -> np.ndarray:
        return self.proba(X).cpu().numpy()

    def predict(self, X) -> np.ndarray:
        return self.classes_[torch.argmax(self.proba(X), dim=1).cpu().numpy()]


@dataclass
class TradeOutcomeAnalyzer:
    n_trees: int = 100
    n_permutation_repeats: int = 30
    prune_threshold: float = 0.25     # relative to max importance
    seed: int = 0
    feature_names: list = field(default_factory=list)
    model: object = None
    pruned_model: object = None
    kept_features: list = field(default_factory=list)
    importances: dict = field(default_factory=dict)
    device: any = None

    def _xy(self, trades: list[dict]):
        if not self.feature_names:
            numeric = set()
            for t in trades:
                numeric |= {k for k, v in t.get("features", {}).items()
                            if isinstance(v, (int, float))}
            self.feature_names = sorted(numeric)
        X = np.asarray([[float(t.get("features", {}).get(f, 0.0))
                         for f in self.feature_names] for t in trades])
        y = np.asarray([1 if t["pnl"] > 0 else 0 for t in trades])
        return X, y

    def fit(self, trades: list[dict]) -> dict:
        """`run_analysis` / `train_models`: forest fit → builtin + permutation
        importances → group aggregation → pruned model."""
        dev = resolve_device(self.device)
        X, y = self._xy(trades)
        if len(np.unique(y)) < 2:
            raise ValueError("need both winning and losing trades to fit")
        rf = RandomForestClassifier(n_estimators=self.n_trees,
                                    random_state=self.seed, device=dev)
        rf.fit(X, y)
        self.model = rf

        builtin = dict(zip(self.feature_names, rf.feature_importances_))
        perm = self._permutation_importance(rf, X, y)
        combined = {f: 0.5 * builtin[f] + 0.5 * perm[f]
                    for f in self.feature_names}
        top = max(combined.values()) or 1.0
        groups = self._group_importance(combined)
        # recommendations (`feature_importance_analyzer.py` output consumed
        # by `model_integration.py:288`): groups well above/below a uniform
        # share are flagged to prioritize/reconsider
        uniform = 1.0 / max(len(groups), 1)
        self.importances = {
            "builtin": builtin, "permutation": perm, "combined": combined,
            "groups": groups,
            "recommendations": {
                "categories_to_prioritize":
                    [g for g, v in groups.items() if v >= 1.5 * uniform],
                "categories_to_reconsider":
                    [g for g, v in groups.items() if v <= 0.5 * uniform],
            },
        }

        self.kept_features = [f for f in self.feature_names
                              if combined[f] / top >= self.prune_threshold]
        if self.kept_features and len(self.kept_features) < len(self.feature_names):
            keep_idx = [self.feature_names.index(f) for f in self.kept_features]
            pruned = RandomForestClassifier(n_estimators=self.n_trees,
                                            random_state=self.seed, device=dev)
            pruned.fit(X[:, keep_idx], y)
            self.pruned_model = pruned
        else:
            self.kept_features = list(self.feature_names)
            self.pruned_model = rf
        return self.importances

    def _permutation_importance(self, model, X, y) -> dict:
        """Permutation importance — accuracy drop averaged over
        n_permutation_repeats shuffles per feature.  The F × R shuffles are
        drawn in the reference loop's order (feature-major, repeat-minor);
        the unshuffled X and every shuffled copy go through one prediction
        on the model's device, and the correct counts come back in one
        read."""
        rng = np.random.default_rng(self.seed)
        n, F = X.shape
        R = self.n_permutation_repeats
        perms = np.stack([rng.permutation(n) for _ in range(F) for _ in range(R)]) \
            if F * R else np.zeros((0, n), np.int64)
        dev = model.device
        x = torch.from_numpy(np.asarray(X, np.float32)).to(dev)
        cols = torch.arange(F, device=dev).repeat_interleave(R)           # [F*R]
        copies = x.unsqueeze(0).repeat(F * R + 1, 1, 1)                    # [F*R + 1, n, F]
        rows = torch.from_numpy(perms).to(dev)
        copies[1:].scatter_(2, cols.view(-1, 1, 1).expand(-1, n, 1),
                            x[rows, cols.view(-1, 1)].unsqueeze(-1))
        y_idx = torch.from_numpy(np.searchsorted(model.classes_, y)).to(dev)
        pred = torch.argmax(model.proba(copies.view(-1, F)), dim=1).view(F * R + 1, n)
        correct = (pred == y_idx).sum(1).cpu().numpy()                     # the one read
        base = correct[0] / n
        out = {}
        for j, f in enumerate(self.feature_names):
            drops = [base - c / n for c in correct[1 + j * R:1 + (j + 1) * R]]
            out[f] = float(max(np.mean(drops), 0.0))
        return out

    def _group_importance(self, combined: dict) -> dict:
        groups = {}
        for group, members in FEATURE_GROUPS.items():
            vals = [combined[f] for f in members if f in combined]
            if vals:
                groups[group] = float(np.sum(vals))
        total = sum(groups.values()) or 1.0
        return {g: v / total for g, v in groups.items()}

    def predict_trade_outcome(self, features: dict) -> dict:
        """`model_integration.py:220-288`: win probability from the pruned
        model (one read), confidence = distance from coin-flip scaled to
        [0,1], neutral defaults when nothing has been fit yet (the
        reference's no_model path rather than an exception)."""
        resolve_device(self.device)
        if self.pruned_model is None:
            return dict(NO_MODEL_PREDICTION)
        x = np.asarray([[float(features.get(f, 0.0))
                         for f in self.kept_features]])
        p = self.pruned_model.predict_proba(x)[0]
        win_p = float(p[list(self.pruned_model.classes_).index(1)]) \
            if 1 in self.pruned_model.classes_ else 0.0
        return {"success_probability": win_p,
                "win_probability": win_p,
                "confidence": abs(win_p - 0.5) * 2.0,
                "status": "success",
                "prediction": "win" if win_p >= 0.5 else "loss"}
