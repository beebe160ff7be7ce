"""Scenario presets and shock schedules (NumPy only)."""

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
