"""Scenario presets and shock schedules (NumPy only).  The traced layers —
`sim.paths` (GBM and bootstrap candles), `sim.lob` (the order-flow book's
markets) and `sim.engine` (`scenario_env_params`) — are reached through
their submodules, as in the JAX package."""

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
