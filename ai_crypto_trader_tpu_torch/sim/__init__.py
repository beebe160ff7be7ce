"""The market simulator.  Layering (host → device):

  scenarios.py   named stress presets → dense per-candle shock-schedule
                 arrays [B, T] (NumPy only)
  paths.py       scenario path generators: regime-switching GBM and
                 bootstrapped historical candles, schedules injected
  exchange.py    candle-granularity matching over a batch of venues —
                 market/limit/stop fills, fees, liquidity caps, partial
                 fills — with FakeExchange's semantics
  engine.py      the strategy-vs-market rollout (`sweep`,
                 `rollout_candles`), `backtest_under_stress` and
                 `scenario_env_params`
  lob.py         the limit-order book: order-flow agents (FlowParams),
                 its candle markets, queue position, the agent's rollout
                 and `lob_sweep`
  calibrate.py   fits FlowParams from captured depth frames

Only the scenario layer is imported here, as in the JAX package: reach the
others through their submodules (`from ai_crypto_trader_tpu_torch.sim
import lob`)."""

from ai_crypto_trader_tpu_torch.sim.scenarios import (  # noqa: F401
    PRESETS,
    ScenarioSpec,
    Shock,
    ShockSchedule,
    compile_schedules,
    mc_schedule,
    mixed_schedules,
    preset,
    preset_names,
)
