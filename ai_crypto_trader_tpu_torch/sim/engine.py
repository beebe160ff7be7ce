"""Scenario markets for the RL env.

Port of `ai_crypto_trader_tpu/sim/engine.py`'s `_stress_candles` (:461-473)
and `scenario_env_params` (:478-519): a batch of adversarial markets —
regime-switching GBM paths (`sim.paths`) or the order-flow book's candles
(`sim.lob`) under mixed shock schedules (`sim.scenarios`) — turned into an
`rl.env.EnvParams` whose tables carry a leading scenario axis, so every
env reset draws a (scenario, offset) pair.  The rest of the JAX module (the
strategy rollout `sweep`, `rollout_candles`, `backtest_under_stress`) is
not ported yet (ROADMAP Queue 1).

``key``: a ``torch.Generator`` on the device, or a provider with the
generators' draw methods (``gbm(B, T)``, ``flow(B, T, L)``).
"""

from __future__ import annotations

import torch

from ai_crypto_trader_tpu_torch.device import div_true, resolve_device
from ai_crypto_trader_tpu_torch.sim import lob, paths, scenarios


def _stress_candles(key, sched, dynamics: str, flow, device=None) -> dict:
    """The candle batch for a schedule: GBM paths or the LOB's markets."""
    if dynamics == "gbm":
        return paths.gbm_candles(key, sched, device=device)
    if dynamics == "lob":
        return lob.lob_candles(key, sched, flow=flow, device=device)
    raise ValueError(f"unknown market dynamics {dynamics!r} (expected 'gbm' or 'lob')")


def scenario_env_params(key, scenario="mixed", num_scenarios: int = 64, steps: int = 1024,
                        episode_len: int = 256, fee_rate: float = 0.0, seed: int = 0,
                        dynamics: str = "gbm", flow=None, device=None):
    """`rl.env.EnvParams` over [num_scenarios, steps] generated markets, on
    ``device``: (EnvParams, labels).  ``dynamics="lob"`` appends two
    book-state columns to the observation table — the relative spread per
    mille and ``tanh(touch depth / steady depth)`` — and makes the
    half-spread the env's per-candle trade cost; size networks with
    `rl.env.obs_size`."""
    from ai_crypto_trader_tpu_torch import ops
    from ai_crypto_trader_tpu_torch.rl.env import make_env_params

    dev = resolve_device(device)
    names = None if scenario == "mixed" else (
        [scenario] if isinstance(scenario, str) else list(scenario))
    sched, labels = scenarios.mixed_schedules(names, num_scenarios, steps, seed=seed)
    candles = _stress_candles(key, sched, dynamics, flow, device=dev)
    ind = ops.compute_indicators(
        {k: candles[k] for k in ("open", "high", "low", "close", "volume")}, device=dev)
    extra = trade_cost = None
    if dynamics == "lob":
        fl = flow or lob.flow_params(device=dev)
        steady = fl.limit_rate / torch.clamp_min(fl.cancel_rate, 1e-6)
        extra = torch.stack([candles["spread"] * 1e3, torch.tanh(candles["cap"] / steady)],
                            dim=-1)
        trade_cost = div_true(candles["spread"], 2.0)   # half-spread paid per side
    return make_env_params(ind, episode_len=episode_len, fee_rate=fee_rate,
                           extra_features=extra, trade_cost=trade_cost, device=dev), labels
