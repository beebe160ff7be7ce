"""Strategy-STRUCTURE generation: rule compositions searched, scored by
real backtests, registered, and iterated until improvement stalls.

Port of `ai_crypto_trader_tpu/strategy/generator.py`.  A strategy structure
is a declarative rule graph — WHICH of the 15 combination indicators
participate (`ops/combinations.py`), their weights, entry/exit thresholds,
and exit levels — scored by the engine's replay on time-ordered CV folds,
with a held-out tail segment the search never sees.  Two candidate sources
feed one evaluation path: `LLMStructureProposer` (the pluggable LLM
backend of `shell/llm.py`) and the deterministic `mutate`, on the host
from ``np.random.default_rng(seed)`` as in the JAX package, so both
packages propose the same candidates in the same order given equal scores.

Evaluation.  The JAX package vmaps `_eval_batch` over the candidates, one
compiled program a fold, and reads each fold's scores back.  Here every
fold × candidate of an `evaluate_structures` call is a lane of one replay
loop over [F, N] (the folds share one length; folds of other lengths make
one loop each), and the scores come back in one `host_read` a call.  The
replay runs the sizer-ladder mode with ``sell_exits`` and per-candle SL/TP
overrides, which the replay kernel does not cover: it is the engine's
plain loop, on the card one launch per op per candle (ROADMAP item 2).

The blend ``(w · stack) / max(Σ|w|, 1e-9)`` is 15 multiply-adds in the
rule order, elementwise (not a matmul, whose order of summation differs
between devices and libraries), over a denominator summed on the host in
the rule order: the card computes the CPU's bits.  Against the JAX
package's dot product a candle whose blend sits on a threshold may flip.

``partitioner`` (None: the single device) is the candidate-pool seam: a
`parallel.MeshPartitioner` splits the candidates over its mesh (program
``structure_pool``), the fold features ride replicated, and each shard's
[F, N/n] Sharpe ratios and trades are gathered onto the mesh's first
device before the one read.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field, replace
from typing import Any

import numpy as np
import torch

from ai_crypto_trader_tpu_torch.backtest import signals as sig
from ai_crypto_trader_tpu_torch.backtest.engine import BacktestInputs, run_backtest
from ai_crypto_trader_tpu_torch.backtest.metrics import compute_metrics
from ai_crypto_trader_tpu_torch.device import resolve_device, to_device
from ai_crypto_trader_tpu_torch.ops.combinations import combined_indicators
from ai_crypto_trader_tpu_torch.ops.indicators import compute_indicators
from ai_crypto_trader_tpu_torch.parallel.partitioner import resolve_partitioner

# The rule vocabulary — the 15 combination-score families
# (`services/utils/indicator_combinations.py`, re-expressed in
# ops/combinations.py). Directional scores ∈ [-1, 1]; probability-style
# scores are centered before blending.
RULE_NAMES = (
    "trend_confirmation", "momentum_trend_alignment",
    "triple_moving_average", "volatility_adjusted_momentum",
    "volatility_trend_score", "oscillator_consensus", "stoch_rsi",
    "double_rsi", "volume_weighted_price_momentum",
    "volume_price_confirmation", "trend_strength_index",
    "market_regime_indicator", "reversal_probability",
    "breakout_confirmation", "divergence_detector",
)
# [0,1] probability-style scores get centered to [-0.5, 0.5] so a weight on
# them biases toward mean-reversion strength rather than a constant offset.
_CENTERED = {"trend_strength_index", "reversal_probability"}

_BOUNDS = {
    "weight": (-2.0, 2.0),
    "buy_threshold": (0.05, 0.9),
    "sell_threshold": (0.05, 0.9),
    "stop_loss": (0.5, 10.0),
    "take_profit": (0.5, 20.0),
}

# The replay's settings for a candidate (generator.py:207-210 of the JAX
# package): no strength gate, 50 warmup candles, a SELL closes the position.
_WARMUP = 50


@dataclass(frozen=True)
class StrategyStructure:
    """A declarative strategy: active rules + weights + thresholds + exits.

    The structure IS the genome the reference's codegen loop mutates as JS
    source; keeping it declarative makes every candidate compilable,
    versionable (registry payload), and batchable."""

    rules: tuple[tuple[str, float], ...]
    buy_threshold: float = 0.3
    sell_threshold: float = 0.3
    stop_loss: float = 2.0
    take_profit: float = 4.0
    name: str = "generated"

    def to_payload(self) -> dict:
        # the payload is the IDENTITY of the structure (registry dedup
        # compares payloads) — the generated name is provenance, carried in
        # registry metadata instead, so two runs producing the same
        # structure dedup to one version
        return {"rules": {n: round(float(w), 4) for n, w in self.rules},
                "buy_threshold": round(float(self.buy_threshold), 4),
                "sell_threshold": round(float(self.sell_threshold), 4),
                "stop_loss": round(float(self.stop_loss), 4),
                "take_profit": round(float(self.take_profit), 4)}

    @classmethod
    def from_payload(cls, payload: dict, name: str = "generated"
                     ) -> "StrategyStructure | None":
        """Validation mirroring the reference's code-quality gate
        (`ai_strategy_evaluator.py`'s evaluate-before-accept): unknown rules
        are dropped, numerics clamped, an empty rule set is rejected."""
        raw = payload.get("rules", {})
        if isinstance(raw, list):      # tolerate [{"name":…,"weight":…}]
            raw = {r.get("name"): r.get("weight", 1.0)
                   for r in raw if isinstance(r, dict)}
        if not isinstance(raw, dict):
            return None
        rules = []
        for n, w in raw.items():
            if n in RULE_NAMES and isinstance(w, (int, float)) and w == w:
                lo, hi = _BOUNDS["weight"]
                rules.append((n, float(np.clip(w, lo, hi))))
        if not rules:
            return None

        def num(key, default):
            v = payload.get(key, default)
            if not isinstance(v, (int, float)) or v != v:
                v = default
            lo, hi = _BOUNDS[key]
            return float(np.clip(v, lo, hi))

        return cls(rules=tuple(sorted(rules)),
                   buy_threshold=num("buy_threshold", 0.3),
                   sell_threshold=num("sell_threshold", 0.3),
                   stop_loss=num("stop_loss", 2.0),
                   take_profit=num("take_profit", 4.0),
                   name=str(payload.get("name", name))[:64])

    def weight_vector(self) -> np.ndarray:
        w = np.zeros(len(RULE_NAMES), np.float32)
        for n, v in self.rules:
            w[RULE_NAMES.index(n)] = v
        return w

    def blend_signal(self, scores: dict) -> tuple[float, str]:
        """One candle's blend + thresholded signal from the 15 combination
        scores — the scalar twin of `evaluate_structures`' batched scoring
        (centering via _CENTERED, |w|-normalized blend, ≥buy / ≤−sell
        thresholds); the live monitor view and the search MUST agree, so
        both thresholds apply to the same 4-decimal rounding the blend is
        published with."""
        w = self.weight_vector()
        vals = np.nan_to_num(np.asarray(
            [float(scores[n]) - (0.5 if n in _CENTERED else 0.0)
             for n in RULE_NAMES], np.float32))
        blend = round(float(w @ vals / max(np.abs(w).sum(), 1e-9)), 4)
        signal = ("BUY" if blend >= self.buy_threshold else
                  "SELL" if blend <= -self.sell_threshold else "NEUTRAL")
        return blend, signal


def default_seed() -> StrategyStructure:
    """A sane trend+oscillator confluence seed (the reference seeds its
    evaluator with the live strategy's current form)."""
    return StrategyStructure(
        rules=(("oscillator_consensus", 1.0), ("trend_confirmation", 1.0)),
        name="seed")


# --------------------------------------------------------------------------
# Evaluation: every fold × candidate of a call in one replay loop
# --------------------------------------------------------------------------

def fold_features(ohlcv: dict, device=None) -> dict:
    """Indicators + combination scores + engine inputs for one fold, on
    ``device`` (default: the CUDA card): the centred score stack [15, T]
    (NaN → 0), close [T], volatility ATR/close [T] (NaN → 0.01) and
    avg_volume = mean(volume) · mean(close), a 0-d float32 tensor.  The
    indicator table's EMA family is two launches of the fused-EWMA kernel on
    the card, the combination scores' fast RSI a third."""
    dev = resolve_device(device)
    ind = compute_indicators({k: v for k, v in ohlcv.items() if k != "regime"}, device=dev)
    combos = combined_indicators(ind)
    stack = torch.stack([combos[n] - 0.5 if n in _CENTERED else combos[n]
                         for n in RULE_NAMES], dim=-2)
    close = ind["close"]
    return {
        "stack": torch.nan_to_num(stack),
        "close": close,
        "volatility": torch.nan_to_num(ind["atr"] / close, nan=0.01),
        "avg_volume": torch.mean(ind["volume"], dim=-1) * torch.mean(close, dim=-1),
    }


def host_read(t: torch.Tensor) -> np.ndarray:
    """THE device→host read of an `evaluate_structures` call: the packed
    Sharpe ratios and trade counts.  A module-level seam, so tests count
    it."""
    return t.cpu().numpy()


def _candidates(structures, dev):
    """The candidates' weights [N, 15], |w| sums [N] (summed on the host in
    the rule order), thresholds and exits [N] on ``dev``."""
    W = np.stack([s.weight_vector() for s in structures])
    denom = np.zeros(len(structures), np.float32)
    for j in range(W.shape[1]):
        denom = denom + np.abs(W[:, j])
    denom = np.maximum(denom, np.float32(1e-9))
    col = lambda name: np.asarray([getattr(s, name) for s in structures], np.float32)  # noqa: E731
    up = lambda a: to_device(a, dev, torch.float32)  # noqa: E731
    return (up(W), up(denom), up(col("buy_threshold")), up(col("sell_threshold")),
            up(col("stop_loss")), up(col("take_profit")))


def blend_signals(stack, W, denom, buy, sell):
    """Blend, signal and strength of N candidates on F folds: ``stack`` [F,
    15, T], ``W`` [N, 15], ``denom``/``buy``/``sell`` [N] → each [F, N, T].
    The blend is 15 elementwise multiply-adds in the rule order, then a
    true division by |w|'s sum."""
    acc = W[:, 0, None] * stack[:, None, 0, :]
    for j in range(1, W.shape[1]):
        acc = acc + W[:, j, None] * stack[:, None, j, :]
    blend = acc / denom[:, None]
    signal = torch.where(blend >= buy[:, None], sig.BUY,
                         torch.where(blend <= -sell[:, None], sig.SELL,
                                     sig.NEUTRAL)).to(torch.int32)
    strength = torch.clamp(torch.abs(blend) * 100.0, 0.0, 100.0)
    return blend, signal, strength


def _eval_lanes(folds, cand):
    """Sharpe and trade counts [F, N] of the candidates over ``folds`` (one
    length): one replay loop over the [F, N] lanes."""
    W, denom, buy, sell, sl, tp = cand
    stack = torch.stack([f["stack"] for f in folds])               # [F, 15, T]
    close = torch.stack([f["close"] for f in folds])[:, None, :]   # [F, 1, T]
    vol = torch.stack([f["volatility"] for f in folds])[:, None, :]
    F, T = close.shape[0], close.shape[-1]
    avg_volume = torch.stack([f["avg_volume"] for f in folds]).reshape(F, 1, 1)
    _, signal, strength = blend_signals(stack, W, denom, buy, sell)
    inputs = BacktestInputs(
        close=close, signal=signal, strength=strength, volatility=vol,
        volume=avg_volume.expand(F, 1, T),
        confidence=torch.ones((T,), dtype=torch.float32, device=close.device),
        decision=signal,
        sl_pct=sl[:, None].expand(-1, T), tp_pct=tp[:, None].expand(-1, T))
    # sell_exits makes the SELL side of the blend a real exit rule, so
    # sell_threshold is a live search dimension
    stats = run_backtest(inputs, min_signal_strength=0.0, warmup=_WARMUP, sell_exits=True,
                         device=close.device)
    m = compute_metrics(stats, device=close.device)
    return m["sharpe_ratio"], m["total_trades"]


def evaluate_structures(folds: list[dict], structures: list[StrategyStructure],
                        partitioner=None, device=None) -> np.ndarray:
    """Mean across-fold Sharpe per structure (CV evaluation —
    `ai_strategy_evaluator.py:1360` batch evaluation), on ``device``
    (default: the CUDA card).  Every fold × candidate is a lane of one
    replay loop (one loop per distinct fold length), and the scores come
    back in one read.  Structures that never trade score -inf: an empty
    backtest's Sharpe 0.0 must not outrank a trading seed.  ``folds`` are
    `fold_features` dicts (tensors, or arrays NumPy takes).  ``partitioner``:
    None or a `parallel.MeshPartitioner` (module docstring)."""
    part = resolve_partitioner(partitioner)
    dev = part.home if part.device_count > 1 else resolve_device(device)
    # candidates lead the population program's outputs: [N, F] each way
    lanes = part.population_eval(
        lambda c, folds: tuple(x.T for x in _eval_lanes(folds, c)), name="structure_pool")
    folds = [{k: to_device(v, dev, torch.float32) for k, v in f.items()} for f in folds]
    cand = _candidates(structures, dev)
    by_len: dict[int, list[int]] = {}
    for i, f in enumerate(folds):
        by_len.setdefault(int(f["close"].shape[-1]), []).append(i)
    order, parts = [], []
    for idx in by_len.values():
        sharpe, trades = (x.T for x in lanes(cand, [folds[i] for i in idx]))
        order += idx
        parts.append(torch.stack([sharpe, trades.to(torch.float32)]))
    packed = host_read(torch.cat(parts, dim=1))                    # [2, F, N]
    place = np.argsort(order, kind="stable")
    sharpes = packed[0][place]
    trades = packed[1][place].astype(np.int32)
    mean_sharpe = np.mean(sharpes, axis=0)
    total_trades = np.sum(trades, axis=0)
    return np.where(total_trades > 0, mean_sharpe, -np.inf)


# --------------------------------------------------------------------------
# Candidate sources
# --------------------------------------------------------------------------

def mutate(rng: np.random.Generator, base: StrategyStructure,
           round_idx: int = 0) -> StrategyStructure:
    """Structure mutation: add / drop / swap a rule, or jitter numerics —
    the always-available search operator (the reference's 'improvement
    suggestions → apply' step, made deterministic)."""
    rules = dict(base.rules)
    op = rng.choice(["add", "drop", "swap", "jitter"])
    absent = [n for n in RULE_NAMES if n not in rules]
    if op == "add" and absent:
        rules[rng.choice(absent)] = float(rng.uniform(-1.5, 1.5))
    elif op == "drop" and len(rules) > 1:
        rules.pop(rng.choice(list(rules)))
    elif op == "swap" and absent:
        rules.pop(rng.choice(list(rules)))
        rules[rng.choice(absent)] = float(rng.uniform(-1.5, 1.5))
    else:
        for n in list(rules):
            rules[n] = float(np.clip(rules[n] + rng.normal(0, 0.3),
                                     *_BOUNDS["weight"]))
    return replace(
        base, rules=tuple(sorted(rules.items())),
        buy_threshold=float(np.clip(
            base.buy_threshold + rng.normal(0, 0.05),
            *_BOUNDS["buy_threshold"])),
        sell_threshold=float(np.clip(
            base.sell_threshold + rng.normal(0, 0.05),
            *_BOUNDS["sell_threshold"])),
        stop_loss=float(np.clip(base.stop_loss * rng.lognormal(0, 0.15),
                                *_BOUNDS["stop_loss"])),
        take_profit=float(np.clip(base.take_profit * rng.lognormal(0, 0.15),
                                  *_BOUNDS["take_profit"])),
        name=f"mut_r{round_idx}")


@dataclass
class LLMStructureProposer:
    """Asks the pluggable LLM backend for structure proposals
    (`ai_strategy_evaluator.py:732`'s generation prompt, re-targeted at the
    declarative genome instead of raw JS source)."""

    llm: object                       # shell.llm.LLMTrader
    n_proposals: int = 4

    async def propose(self, best: StrategyStructure, cv_record: dict,
                      round_idx: int) -> list[StrategyStructure]:
        prompt = (
            "You design trading strategies as rule compositions. Available "
            f"rules (each scores each candle in [-1,1]): {list(RULE_NAMES)}.\n"
            f"Current best structure: {json.dumps(best.to_payload())}\n"
            f"Its cross-validated record: {json.dumps(cv_record)}\n"
            f"Propose up to {self.n_proposals} IMPROVED structures. Reply "
            "with ONLY a JSON object {\"structures\": [{\"rules\": "
            "{rule_name: weight, ...}, \"buy_threshold\": x, "
            "\"sell_threshold\": x, \"stop_loss\": pct, \"take_profit\": "
            "pct}, ...]}.\nMARKET_DATA:" + json.dumps(
                {"best": best.to_payload(), "cv": cv_record}))
        try:
            raw = await self.llm.complete(prompt)
            items = json.loads(raw).get("structures", [])
        except Exception:              # noqa: BLE001 — degrade to mutation
            return []
        if not isinstance(items, list):   # {"structures": null / {...}}
            return []
        out = []
        for i, item in enumerate(items[:self.n_proposals]):
            s = StrategyStructure.from_payload(
                item if isinstance(item, dict) else {},
                name=f"llm_r{round_idx}_{i}")
            if s is not None:
                out.append(replace(s, name=f"llm_r{round_idx}_{i}"))
        return out


# --------------------------------------------------------------------------
# The generation loop
# --------------------------------------------------------------------------

@dataclass
class StrategyGenerator:
    """generate → evaluate (real CV) → register → iterate-until-stall
    (`systematic_evaluate_and_improve`, ai_strategy_evaluator.py:732), on
    ``device`` (None: the CUDA card).

    The candle axis splits into a search segment (CV folds the search
    optimizes on) and a held-out tail the search never scores — the final
    report compares seed vs best on that tail."""

    registry: object | None = None    # strategy.registry.ModelRegistry
    llm: object | None = None         # shell.llm.LLMTrader
    cv_folds: int = 3
    holdout_frac: float = 0.3
    pool_size: int = 16
    max_rounds: int = 6
    patience: int = 2
    min_improvement: float = 0.02
    seed: int = 0
    partitioner: object | None = None  # None or a partitioner (parallel/)
    history: list = field(default_factory=list)
    device: Any = None

    def __post_init__(self):
        self.device = resolve_device(self.device)

    def _evaluate(self, folds, structures):
        return evaluate_structures(folds, structures, partitioner=self.partitioner,
                                   device=self.device)

    async def generate(self, ohlcv: dict,
                       seed_structure: StrategyStructure | None = None) -> dict:
        rng = np.random.default_rng(self.seed)
        arrays = {k: np.asarray(v) for k, v in ohlcv.items() if k != "regime"}
        T = len(arrays["close"])
        split = int(T * (1.0 - self.holdout_frac))
        search = {k: v[:split] for k, v in arrays.items()}
        holdout = {k: v[split:] for k, v in arrays.items()}

        fold_len = split // self.cv_folds
        folds = [fold_features({k: v[i * fold_len:(i + 1) * fold_len]
                                for k, v in search.items()}, device=self.device)
                 for i in range(self.cv_folds)]
        holdout_fold = [fold_features(holdout, device=self.device)]

        best = seed_structure or default_seed()
        best_score = float(self._evaluate(folds, [best])[0])
        self.history = [{"round": 0, "structure": best.to_payload(),
                         "cv_sharpe": best_score, "source": "seed",
                         "adopted": True}]
        versions = []

        def _register(structure, score, meta):
            # exact-dup-only threshold: an adopted improvement with small
            # numeric deltas must not collapse onto the previous version
            v = self.registry.register("generated_strategy",
                                       structure.to_payload(), meta,
                                       similarity_threshold=1.0)
            # -inf (never trades) must not be persisted as JSON -Infinity
            if np.isfinite(score):
                self.registry.update_performance(v, {"sharpe_ratio": score})
            versions.append(v)

        if self.registry is not None:
            _register(best, best_score, {"source": "seed"})

        proposer = (LLMStructureProposer(self.llm) if self.llm is not None
                    else None)
        stall = 0
        for rnd in range(1, self.max_rounds + 1):
            if stall >= self.patience:
                break
            candidates: list[StrategyStructure] = []
            if proposer is not None:
                cv_record = {"cv_sharpe": round(best_score, 4),
                             "rounds_without_improvement": stall}
                candidates += await proposer.propose(best, cv_record, rnd)
            while len(candidates) < self.pool_size:
                candidates.append(mutate(rng, best, rnd))
            scores = self._evaluate(folds, candidates)
            top = int(np.argmax(scores))
            top_score = float(scores[top])
            adopted = top_score > best_score + self.min_improvement
            self.history.append({
                "round": rnd, "pool": len(candidates),
                "pool_sources": [c.name for c in candidates],
                "best_candidate": candidates[top].to_payload(),
                "cv_sharpe": top_score,
                "source": candidates[top].name,
                "adopted": adopted})
            if adopted:
                best, best_score = candidates[top], top_score
                stall = 0
                if self.registry is not None:
                    _register(best, best_score,
                              {"source": best.name, "round": rnd})
            else:
                stall += 1

        seed_s = seed_structure or default_seed()
        held = self._evaluate(holdout_fold, [seed_s, best])
        return {
            "structure": best,
            "cv_sharpe": best_score,
            "seed_cv_sharpe": self.history[0]["cv_sharpe"],
            "holdout_sharpe_seed": float(held[0]),
            "holdout_sharpe_best": float(held[1]),
            "rounds": len(self.history) - 1,
            "versions": versions,
            "history": self.history,
        }

    def report(self) -> dict:
        """(:910) — generation trajectory summary. Only ADOPTED candidates
        count: a round's top score that failed the min_improvement gate was
        rejected and must not be reported as an achieved improvement."""
        if not self.history:
            return {"status": "no_runs"}
        adopted = [h["cv_sharpe"] for h in self.history if h.get("adopted")]
        seed = self.history[0]["cv_sharpe"]
        best = max(adopted) if adopted else seed
        return {"rounds": len(self.history) - 1,
                "seed_sharpe": seed,
                "best_sharpe": best,
                "improvement": best - seed,
                "sources": sorted({h["source"] for h in self.history})}


# --------------------------------------------------------------------------
# Launcher cadence service: scheduled search + live hot swap
# --------------------------------------------------------------------------

@dataclass
class GeneratorService:
    """Structure search as a continuously scheduled service with hot swap.

    The cadence service periodically re-runs StrategyGenerator over the
    symbol's recent bus klines, seeded from the CURRENTLY adopted
    structure; a candidate is adopted only when it beats that seed on the
    held-out tail.  Adoption hot-swaps two surfaces:

      strategy_structure / strategy_structure_update   the full rule graph
          (+ registry version) for any structure-aware consumer;
      strategy_params / strategy_update                the structure's
          stop_loss / take_profit merged into the live params.

    The bus is injected and used only through ``get``, ``set`` and ``await
    publish`` (the JAX package's ``EventBus`` or anything with those); the
    search runs on ``device`` (None: the CUDA card)."""

    bus: object
    symbol: str = "BTCUSDC"
    interval: str = "1m"               # the monitor's primary frame
    registry: object | None = None
    llm: object | None = None
    interval_s: float = 3600.0
    min_candles: int = 1024
    history_cap: int = 8192
    cv_folds: int = 2
    pool_size: int = 8
    max_rounds: int = 2
    seed: int = 0
    partitioner: object | None = None   # None or a partitioner (parallel/)
    now_fn: Any = None
    name: str = "generator"
    current: StrategyStructure = field(default_factory=default_seed)
    runs: list = field(default_factory=list)
    _last: float = -1e18
    _history: list = field(default_factory=list)
    device: Any = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        if self.now_fn is None:
            import time

            self.now_fn = time.time

    def _accumulate(self) -> int:
        """Fold the bus's bounded kline window into a longer rolling buffer
        of CLOSED bars (the window's last row is the venue's in-progress
        bar, which later, more complete versions of the same bar share its
        timestamp with)."""
        rows = self.bus.get(f"historical_data_{self.symbol}_{self.interval}") or []
        closed = rows[:-1]
        last_ts = self._history[-1][0] if self._history else -np.inf
        self._history.extend(r for r in closed if r[0] > last_ts)
        del self._history[: -self.history_cap]
        return len(self._history)

    async def run_once(self) -> dict:
        n = self._accumulate()            # every tick, even when gated
        now = self.now_fn()
        if now - self._last < self.interval_s:
            return {"ran": False, "reason": "interval_gate"}
        if n < self.min_candles:
            return {"ran": False, "reason": "insufficient_history"}
        self._last = now

        # bucketed window: the candle count the fold tensors take moves
        # through a few lengths, not one per scheduled run
        from ai_crypto_trader_tpu_torch.utils.shapes import bucket_len

        buckets = tuple(sorted({self.min_candles, self.min_candles * 3 // 2,
                                self.min_candles * 2, self.min_candles * 3,
                                self.min_candles * 4, self.min_candles * 6,
                                self.history_cap}))
        window = self._history[-bucket_len(n, buckets):]
        cols = np.asarray([row[1:6] for row in window], np.float64)
        ohlcv = {"open": cols[:, 0], "high": cols[:, 1], "low": cols[:, 2],
                 "close": cols[:, 3], "volume": cols[:, 4]}
        gen = StrategyGenerator(
            registry=self.registry, llm=self.llm, cv_folds=self.cv_folds,
            pool_size=self.pool_size, max_rounds=self.max_rounds,
            partitioner=self.partitioner,
            # fresh search randomness each scheduled run — a fixed seed
            # would re-propose the identical rejected pool forever
            seed=self.seed + len(self.runs), device=self.device)
        out = await gen.generate(ohlcv, seed_structure=self.current)

        adopted = (out["structure"].to_payload() != self.current.to_payload()
                   and out["holdout_sharpe_best"] > out["holdout_sharpe_seed"])
        record = {"at": now, "adopted": adopted,
                  "cv_sharpe": out["cv_sharpe"],
                  "holdout_sharpe_seed": out["holdout_sharpe_seed"],
                  "holdout_sharpe_best": out["holdout_sharpe_best"],
                  "versions": out["versions"]}
        self.runs.append(record)
        if not adopted:
            return {"ran": True, "adopted": False}

        self.current = out["structure"]
        version = out["versions"][-1] if out["versions"] else None
        if self.registry is not None and version is not None:
            self.registry.set_status(version, "active")
        payload = self.current.to_payload()
        self.bus.set("strategy_structure",
                     {**payload, "version": version, "adopted_at": now})
        await self.bus.publish("strategy_structure_update", {
            "structure": payload, "version": version,
            "holdout_sharpe": out["holdout_sharpe_best"], "ts": now})
        # exits into the live params (same hot-swap channel as the evolver,
        # strategy/evolution.py hot_swap)
        live = dict(self.bus.get("strategy_params") or {})
        live["stop_loss"] = payload["stop_loss"]
        live["take_profit"] = payload["take_profit"]
        self.bus.set("strategy_params", live)
        await self.bus.publish("strategy_update", {
            "params": live, "method": "generated_structure",
            "version": version, "ts": now})
        return {"ran": True, "adopted": True, "version": version}
