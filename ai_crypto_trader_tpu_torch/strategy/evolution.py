"""The strategy-evolution brain: hybrid GA / RL / LLM dispatch + hot swap.

Port of `ai_crypto_trader_tpu/strategy/evolution.py` (StrategyEvolutionService
of the reference, `services/strategy_evolution_service.py`):

  * performance monitoring vs thresholds — `needs_improvement`
    (:1571-1582) on sharpe / drawdown / win-rate;
  * hybrid method dispatch by regime & history length (:1151-1204):
    volatile → RL, bull with history → GA, ranging → LLM, default GA;
  * GA path (:525-694): the port's `evolve.run_ga` over
    `evolve.backtest_fitness` — on the card the period tables' fused-EWMA
    launches and one replay-kernel launch a generation, one read a run;
  * RL path (:696-791): a DQN (`rl.train_dqn`) trained on the recent
    market window, its greedy action census mapped to parameter nudges
    (:901-975);
  * LLM path (:364-511): prompt-based optimization through the pluggable
    adapter (`shell.llm.LLMTrader`), outputs clamped to ranges, the
    regime table as the fallback;
  * regime-specific parameter adjustments (:145-174, :302-347);
  * `hot_swap` (:349-362): bus KV set + `strategy_update` publish, on an
    injected bus used only through ``set`` and ``await publish``.

Random draws.  Where the JAX package passes ``jax.random.PRNGKey(seed)``,
the GA and the DQN here take a draw provider from ``draws(method, seed)``
(``method`` "ga" or "rl"); by default a ``torch.Generator`` on the
evolver's device seeded with ``seed``.  Tests hand over the JAX package's
draws through the providers of `evolve` and `rl.draws`.
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np
import torch

from ai_crypto_trader_tpu_torch.backtest.strategy import (
    PARAM_RANGES,
    StrategyParams,
    clamp_params,
    default_params,
)
from ai_crypto_trader_tpu_torch.config import EvolutionParams
from ai_crypto_trader_tpu_torch.device import resolve_device
from ai_crypto_trader_tpu_torch.evolve import backtest_fitness, run_ga
from ai_crypto_trader_tpu_torch.parallel import get_partitioner
from ai_crypto_trader_tpu_torch.shell.llm import LLMTrader
from ai_crypto_trader_tpu_torch.strategy.registry import ModelRegistry

# Regime-specific parameter adjustments
# (`strategy_evolution_service.py:145-174`): additive for thresholds,
# multiplicative (suffix _mult) for periods/levels.
REGIME_ADJUSTMENTS = {
    "bull": {"rsi_overbought": +5.0, "rsi_oversold": +5.0,
             "take_profit_mult": 1.5, "ema_long_mult": 0.8,
             "atr_multiplier_mult": 1.2},
    "bear": {"rsi_overbought": -5.0, "rsi_oversold": -5.0,
             "stop_loss_mult": 0.8, "ema_short_mult": 1.2,
             "atr_multiplier_mult": 0.8},
    "ranging": {"bollinger_std_mult": 1.2, "macd_signal_mult": 0.8,
                "rsi_period_mult": 0.8, "take_profit_mult": 0.7,
                "stop_loss_mult": 0.7},
    "volatile": {"atr_period_mult": 0.7, "atr_multiplier_mult": 1.5,
                 "bollinger_std_mult": 1.3, "stop_loss_mult": 0.6,
                 "take_profit_mult": 1.3},
}


def adjust_for_regime(params: StrategyParams, regime: str) -> StrategyParams:
    """`adjust_parameters_for_regime` (:302-347), in float32 on the params'
    device."""
    adj = REGIME_ADJUSTMENTS.get(regime, {})
    d = params._asdict()
    for key, val in adj.items():
        if key.endswith("_mult"):
            name = key[: -len("_mult")]
            d[name] = d[name] * val
        else:
            d[key] = d[key] + val
    return clamp_params(StrategyParams(**d))


def host_read(t: torch.Tensor) -> np.ndarray:
    """The RL path's device→host read (the greedy actions).  A module-level
    seam, so tests count it."""
    return t.cpu().numpy()


@dataclass
class StrategyEvolver:
    bus: object                      # set / await publish
    cfg: EvolutionParams = field(default_factory=EvolutionParams)
    llm: LLMTrader = field(default_factory=LLMTrader)
    registry: ModelRegistry | None = None
    now_fn: Any = time.time
    seed: int = 0
    # Population-eval seam (parallel/partitioner.py). None = resolve
    # get_partitioner() lazily on the first GA run; a MeshPartitioner
    # splits the GA's evaluations over its mesh.
    partitioner: object | None = None
    device: Any = None
    # (method, seed) -> the GA's or the DQN's draw provider; None: a
    # torch.Generator on the evolver's device seeded with ``seed``
    draws: Callable[[str, int], Any] | None = None

    def __post_init__(self):
        self.device = resolve_device(self.device)

    def _draws(self, method: str):
        if self.draws is not None:
            return self.draws(method, self.seed)
        return torch.Generator(self.device).manual_seed(self.seed)

    def needs_improvement(self, metrics: dict) -> bool:
        """`_needs_improvement` (:1571-1582)."""
        return (metrics.get("sharpe_ratio", 0.0) < self.cfg.min_sharpe
                or metrics.get("max_drawdown_pct", 0.0) > self.cfg.max_drawdown * 100
                or metrics.get("win_rate", 0.0) < self.cfg.min_win_rate * 100
                or metrics.get("profit_factor", 0.0) < self.cfg.min_profit_factor)

    def pick_method(self, regime: str, history_length: int) -> str:
        """Hybrid dispatch (:1151-1204)."""
        if self.cfg.method != "hybrid":
            return self.cfg.method
        if regime == "volatile":
            return "rl"
        if regime == "bull" and history_length >= 20:
            return "ga"
        if regime == "ranging":
            return "llm"
        return "ga"

    # --- optimization paths -------------------------------------------------
    def optimize_with_ga(self, ohlcv: dict, current: StrategyParams) -> tuple[StrategyParams, dict]:
        """`optimize_with_genetic_algorithm` (:525-694) with real fitness:
        the port's GA on the card, one read at the end of the run."""
        if self.partitioner is None:
            self.partitioner = get_partitioner()
        best, history = run_ga(self._draws("ga"),
                               backtest_fitness(ohlcv, device=self.device), self.cfg.ga,
                               seed_params=current, partitioner=self.partitioner,
                               device=self.device)
        return best, {"method": "ga", "history": history,
                      "devices": self.partitioner.device_count}

    def optimize_with_rl(self, ohlcv: dict, current: StrategyParams,
                         iterations: int = 20) -> tuple[StrategyParams, dict]:
        """`optimize_with_reinforcement_learning` (:696-791): train a DQN on
        the recent market window, then map its greedy action tendency to
        parameter nudges (:901-975) — more BUYs → looser entries / wider TP,
        more SELLs → tighter stops."""
        from ai_crypto_trader_tpu_torch.ops import compute_indicators
        from ai_crypto_trader_tpu_torch.rl import DQNConfig, make_env_params, train_dqn
        from ai_crypto_trader_tpu_torch.rl.dqn import q_values

        dev = self.device
        ind = compute_indicators({k: v for k, v in ohlcv.items() if k != "regime"}, device=dev)
        T = int(ind["close"].shape[-1])
        env_p = make_env_params(ind, episode_len=min(128, T - 2), device=dev)
        dqn_cfg = DQNConfig(num_envs=16, rollout_len=8, learn_steps_per_iter=2)
        state, _ = train_dqn(self._draws("rl"), env_p, dqn_cfg, iterations=iterations)
        # greedy (ε = 0) action census over the feature table
        obs = torch.cat([env_p.obs_table,
                         torch.zeros((env_p.obs_table.shape[0], 2), device=dev)], dim=1)
        actions = host_read(torch.argmax(q_values(state.params, obs), dim=-1))
        buy_frac = float((actions == 0).mean())
        sell_frac = float((actions == 2).mean())
        d = current._asdict()
        # Q-tendency → nudges (:901-975)
        d["rsi_oversold"] = d["rsi_oversold"] + (buy_frac - 0.33) * 10.0
        d["take_profit"] = d["take_profit"] * (1.0 + (buy_frac - sell_frac) * 0.3)
        d["stop_loss"] = d["stop_loss"] * (1.0 - (sell_frac - 0.33) * 0.3)
        out = clamp_params(StrategyParams(**d))
        return out, {"method": "rl", "buy_frac": buy_frac, "sell_frac": sell_frac}

    async def optimize_with_llm(self, market_summary: dict,
                                current: StrategyParams) -> tuple[StrategyParams, dict]:
        """`optimize_with_gpt` (:364-511): prompt → proposed params → clamp.
        The deterministic backend proposes regime-appropriate adjustments."""
        prompt_ctx = {
            "current_params": {k: float(v) for k, v in current._asdict().items()},
            "param_ranges": {k: r[:2] for k, r in PARAM_RANGES.items()},
            **market_summary,
        }
        try:
            raw = await self.llm.complete(
                "Propose improved strategy parameters as JSON under key "
                "'params'.\nMARKET_DATA:" + json.dumps(prompt_ctx))
            proposed = json.loads(raw).get("params", {})
        except Exception:                # noqa: BLE001 — degrade, never die
            proposed = {}
        d = current._asdict()
        for k, v in proposed.items():
            if k in d and isinstance(v, (int, float)):
                d[k] = torch.full_like(d[k], float(v))
        if not proposed:
            # deterministic fallback: regime table adjustment
            return adjust_for_regime(current, market_summary.get("regime", "ranging")), \
                {"method": "llm", "fallback": "regime_table"}
        return clamp_params(StrategyParams(**d)), {"method": "llm"}

    # --- the evolution entry point ------------------------------------------
    async def evolve(self, ohlcv: dict, current: StrategyParams | None = None,
                     metrics: dict | None = None, regime: str = "ranging",
                     history_length: int = 0) -> dict:
        """`evolve_strategy` (:1092-1271): dispatch → optimize → regime
        adjust → hot swap → register version."""
        current = current if current is not None else default_params(device=self.device)
        if metrics is not None and not self.needs_improvement(metrics):
            return {"evolved": False, "reason": "performance_ok"}

        method = self.pick_method(regime, history_length)
        if method == "ga":
            new_params, detail = self.optimize_with_ga(ohlcv, current)
        elif method == "rl":
            new_params, detail = self.optimize_with_rl(ohlcv, current)
        else:
            summary = {"regime": regime, "history_length": history_length}
            new_params, detail = await self.optimize_with_llm(summary, current)

        new_params = adjust_for_regime(new_params, regime)
        version = None
        if self.registry is not None:
            version = self.registry.register(
                kind="strategy_params",
                payload={k: float(v) for k, v in new_params._asdict().items()},
                metadata={"method": method, "regime": regime})
        await self.hot_swap(new_params, method=method, version=version)
        return {"evolved": True, "method": method, "params": new_params,
                "detail": detail, "version": version}

    async def hot_swap(self, params: StrategyParams, method: str = "",
                       version: str | None = None):
        """`hot_swap_strategy` (:349-362): KV set + strategy_update publish —
        the executor and backtester pick the new params up on next use."""
        payload = {k: float(v) for k, v in params._asdict().items()}
        self.bus.set("strategy_params", payload)
        await self.bus.publish("strategy_update", {
            "params": payload, "method": method, "version": version,
            "ts": self.now_fn()})
