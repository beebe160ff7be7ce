"""Systematic evaluate→improve loop.

Port of `ai_crypto_trader_tpu/strategy/improver.py` (AIStrategyEvaluator of
the reference, `services/ai_strategy_evaluator.py`): the generate →
evaluate (CV) → suggest improvements → apply → re-evaluate cycle
(`systematic_evaluate_and_improve:732`), batch evaluation (:1360), and
report generation (:910) — composed from the port's parts: cross-validated
backtests (`strategy.evaluation.cross_validate`) for evaluation, the hybrid
evolver (`strategy.evolution.StrategyEvolver`) for improvement, and the
registry for version tracking.  Iterations stop early once the quality
gates pass.  Everything runs on the evolver's device.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ai_crypto_trader_tpu_torch.backtest.strategy import StrategyParams, default_params
from ai_crypto_trader_tpu_torch.strategy.evaluation import cross_validate
from ai_crypto_trader_tpu_torch.strategy.evolution import StrategyEvolver


@dataclass
class SystematicImprover:
    evolver: StrategyEvolver
    cv_folds: int = 3
    max_iterations: int = 3
    target_sharpe: float = 1.0
    history: list = field(default_factory=list)

    def evaluate(self, ohlcv: dict, params: StrategyParams) -> dict:
        """CV evaluation (:1360): mean/std Sharpe + per-regime breakdown."""
        cv = cross_validate(ohlcv, params, k=self.cv_folds, device=self.evolver.device)
        return {
            "mean_sharpe": cv["mean_sharpe"],
            "std_sharpe": cv["std_sharpe"],
            "regime_sharpe": cv["regime_sharpe"],
            "passes": cv["mean_sharpe"] >= self.target_sharpe,
        }

    async def improve(self, ohlcv: dict,
                      params: StrategyParams | None = None,
                      regime: str = "ranging") -> dict:
        """systematic_evaluate_and_improve (:732): iterate evolve→CV until
        the gate passes or the budget is spent; keep the best-by-CV."""
        params = params if params is not None else default_params(
            device=self.evolver.device)
        best_params, best_eval = params, self.evaluate(ohlcv, params)
        self.history = [{"iteration": 0, "eval": best_eval, "method": "seed"}]

        base_seed = self.evolver.seed
        for it in range(1, self.max_iterations + 1):
            if best_eval["passes"]:
                break
            # fresh optimizer randomness each round — with a fixed seed and
            # unchanged current params, a failed iteration would otherwise
            # re-produce the identical candidate and waste the CV budget
            self.evolver.seed = base_seed + it
            out = await self.evolver.evolve(
                ohlcv, current=best_params, regime=regime,
                history_length=len(self.history) * 10)
            if not out.get("evolved"):
                break
            cand = out["params"]
            cand_eval = self.evaluate(ohlcv, cand)
            self.history.append({"iteration": it, "eval": cand_eval,
                                 "method": out["method"],
                                 "version": out.get("version")})
            if cand_eval["mean_sharpe"] > best_eval["mean_sharpe"]:
                best_params, best_eval = cand, cand_eval
        self.evolver.seed = base_seed
        return {"params": best_params, "evaluation": best_eval,
                "iterations": len(self.history) - 1,
                "converged": best_eval["passes"], "history": self.history}

    def report(self) -> dict:
        """(:910) — improvement trajectory summary."""
        if not self.history:
            return {"status": "no_runs"}
        sharpes = [h["eval"]["mean_sharpe"] for h in self.history]
        return {
            "iterations": len(self.history) - 1,
            "initial_sharpe": sharpes[0],
            "final_sharpe": sharpes[-1],
            "best_sharpe": max(sharpes),
            "improvement": max(sharpes) - sharpes[0],
            "methods_used": sorted({h["method"] for h in self.history[1:]}),
        }
